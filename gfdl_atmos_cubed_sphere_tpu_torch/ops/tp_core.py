"""PPM transport operators (Lin & Rood 1996 / Putman & Lin 2007), PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/ops/tp_core.py (FV3
model/tp_core.F90 xppm:324, yppm:715, fv_tp_2d:85, deln_flux:1267), written as
plain tensor code on padded per-tile arrays. Every tile spans a full cube
face, so all four tile edges are always present and the Fortran per-rank
edge branches become fixed index overrides.

Index conventions (0-based, h = halo = 3, n = cells per side):
  padded cells along an axis: local cell c in [-h, n+h) at array index c+h
  walls: w in [0, n] between cells w-1 and w; extended wall arrays hold
  w in [-1, n+1] at index w+1.
xppm works along the last axis, or along axis -2 (the yppm orientation).
"""

import numpy as np
import torch

from ..parallel.halo import copy_corners

# scheme constants (tp_core.F90:35-71)
PPM_FAC = 1.5
R3 = 1.0 / 3.0
NEAR_ZERO = 1.0e-25
R12 = 1.0 / 12.0
S11, S14, S15 = 11.0 / 14.0, 4.0 / 7.0, 3.0 / 14.0
C1, C2, C3 = -2.0 / 14.0, 11.0 / 14.0, 5.0 / 14.0
P1, P2 = 7.0 / 12.0, -1.0 / 12.0


def _where0(cond, a):
    return torch.where(cond, a, torch.zeros((), dtype=a.dtype, device=a.device))


def _nz(a):
    """a with exact zeros replaced by 1 (guards a division whose result is
    discarded where a == 0)."""
    return torch.where(a == 0, torch.ones((), dtype=a.dtype, device=a.device),
                       a)


def _edge_extrap(qm2, qm1, q0, q1, dm2, dm1, d0, d1):
    """Mean of the two one-sided linear extrapolations to a tile-edge wall
    (tp_core.F90:374-376): cells (m2, m1) inside one tile, (0, 1) in the
    other; dxa widths likewise."""
    left = ((2.0 * dm1 + dm2) * qm1 - dm1 * qm2) / (dm2 + dm1)
    right = ((2.0 * d0 + d1) * q0 - d0 * q1) / (d0 + d1)
    return 0.5 * (left + right)


def _pert_ppm_iv1(q, bl, br):
    """Standard PPM constraint, perturbation form (pert_ppm iv=1)."""
    da1 = bl - br
    da2 = da1 * da1
    a6da = 3.0 * (bl + br) * da1
    bl_new = torch.where(a6da > da2, -2.0 * br, bl)
    br_new = torch.where(a6da < -da2, -2.0 * bl, br)
    cross = bl * br < 0.0
    return _where0(cross, bl_new), _where0(cross, br_new)


def _pert_ppm_iv0(q, bl, br):
    """Positive-definite constraint (pert_ppm iv=0)."""
    a4 = -3.0 * (br + bl)
    da1 = br - bl
    fmin = q + 0.25 / _nz(a4) * da1 * da1 + a4 * R12
    need = (torch.abs(da1) < -a4) & (fmin < 0.0) & (q > 0.0)
    both_pos = (br > 0.0) & (bl > 0.0)
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    br_n = torch.where(both_pos, zero, torch.where(da1 > 0.0, -2.0 * bl, br))
    bl_n = torch.where(both_pos, zero, torch.where(da1 > 0.0, bl, -2.0 * br))
    bl = torch.where(need, bl_n, torch.where(q <= 0.0, zero, bl))
    br = torch.where(need, br_n, torch.where(q <= 0.0, zero, br))
    return bl, br


def xppm(q, c, dxa, iord, lim_fac=1.0, axis=-1):
    """1-D PPM flux operator (tp_core.F90 xppm:324) along `axis`.

    q:   [..., n+2h] padded cells (along `axis`)
    c:   [..., n+1]  Courant numbers at walls 0..n (positive = flow +x)
    dxa: [..., n+2h] padded A-grid cell widths (for edge extrapolations)
    Returns the upwind interface value [..., n+1] (mass flux = value times
    wall mass flux), with the cube-edge one-sided stencils. axis=-2 is the
    yppm orientation.
    """
    h = 3
    ax = axis
    n = q.shape[ax] - 2 * h
    mord = abs(iord)

    def S(a, sl):
        return a[..., sl] if ax == -1 else a[..., sl, :]

    def Q(c0, c1):
        return S(q, slice(h + c0, h + c1 + 1))

    def q0(cc):
        return S(q, slice(h + cc, h + cc + 1))

    def dx0(cc):
        return S(dxa, slice(h + cc, h + cc + 1))

    def L(a):
        return S(a, slice(None, -1))

    def R(a):
        return S(a, slice(1, None))

    def setcols(a, iv):
        a = a.clone()
        for i, v in iv:
            if ax == -1:
                a[..., i:i + 1] = v
            else:
                a[..., i:i + 1, :] = v
        return a

    def edge_mask(cols, length):
        m = torch.zeros(length, dtype=torch.bool, device=q.device)
        m[list(cols)] = True
        return m if ax == -1 else m[:, None]

    if mord < 7:
        # ---- linear PPM family -------------------------------------------
        al = (P1 * (Q(-2, n) + Q(-1, n + 1))
              + P2 * (Q(-3, n - 1) + Q(0, n + 2)))      # walls -1..n+1
        xt_w = _edge_extrap(q0(-2), q0(-1), q0(0), q0(1),
                            dx0(-2), dx0(-1), dx0(0), dx0(1))
        xt_e = _edge_extrap(q0(n - 2), q0(n - 1), q0(n), q0(n + 1),
                            dx0(n - 2), dx0(n - 1), dx0(n), dx0(n + 1))
        al = setcols(al, [
            (0, C1 * q0(-3) + C2 * q0(-2) + C3 * q0(-1)),
            (1, xt_w),
            (2, C3 * q0(0) + C2 * q0(1) + C1 * q0(2)),
            (n, C1 * q0(n - 3) + C2 * q0(n - 2) + C3 * q0(n - 1)),
            (n + 1, xt_e),
            (n + 2, C3 * q0(n) + C2 * q0(n + 1) + C1 * q0(n + 2))])
        if iord < 0:
            al = torch.clamp_min(al, 0.0)

        qc = Q(-1, n)                      # cells -1..n
        bl = L(al) - qc
        br = R(al) - qc
        b0 = bl + br

        if mord == 1:
            smt5 = torch.abs(lim_fac * b0) < torch.abs(bl - br)
        elif mord == 2:
            smt5 = torch.ones(b0.shape, dtype=torch.bool, device=q.device)
        elif mord in (3, 4):
            smt5 = torch.abs(b0) < torch.abs(bl - br)
            smt6 = 3.0 * torch.abs(b0) < torch.abs(bl - br)
        else:  # 5, 6
            if iord == 5 or iord == -5:
                smt5 = bl * br < 0.0
            else:
                smt5 = 3.0 * torch.abs(b0) < torch.abs(bl - br)
            if iord == -5:
                da1 = br - bl
                a4 = -3.0 * b0
                cond = (torch.abs(da1) < -a4) & (
                    qc + 0.25 / _nz(a4) * da1 ** 2 + a4 * R12 < 0.0)
                zero = torch.zeros((), dtype=q.dtype, device=q.device)
                brn = torch.where(~smt5, zero,
                                  torch.where(da1 > 0.0, -2.0 * bl, br))
                bln = torch.where(~smt5, zero,
                                  torch.where(da1 > 0.0, bl, -2.0 * br))
                b0n = torch.where(~smt5, zero,
                                  torch.where(da1 > 0.0, -bl, -br))
                bl = torch.where(cond, bln, bl)
                br = torch.where(cond, brn, br)
                b0 = torch.where(cond, b0n, b0)
            # edge smt5 fix (tp_core.F90:536-546): cells -1,0 and n-1,n
            crossed = bl * br < 0.0
            edgem = edge_mask([0, 1, n, n + 1], smt5.shape[ax])
            smt5 = torch.where(edgem, crossed, smt5)

        cpos = c > 0.0
        blL, brL, b0L = L(bl), L(br), L(b0)
        blR, brR, b0R = R(bl), R(br), R(b0)
        qL, qR = L(qc), R(qc)
        fx1 = torch.where(cpos, (1.0 - c) * (brL - c * b0L),
                          (1.0 + c) * (blR + c * b0R))
        low = torch.where(cpos, qL, qR)
        if mord == 2:
            return low + fx1
        if mord == 3:
            add = torch.where(cpos, L(smt5) | R(smt6), L(smt6) | R(smt5))
        elif mord == 4:
            add = (L(smt5) & R(smt5)) | (L(smt6) | R(smt6))
        else:  # 1, 5, 6
            add = L(smt5) | R(smt5)
        return low + _where0(add, fx1)

    # ---- monotone / PD families (iord >= 7) ------------------------------
    q3m = Q(-3, n)
    q3c = Q(-2, n + 1)
    q3p = Q(-1, n + 2)
    xt = 0.25 * (q3p - q3m)
    dmax = torch.maximum(torch.maximum(q3m, q3c), q3p) - q3c
    dmin = q3c - torch.minimum(torch.minimum(q3m, q3c), q3p)
    dm = torch.sign(xt) * torch.minimum(torch.minimum(torch.abs(xt), dmax),
                                        dmin)               # cells -2..n+1

    al = 0.5 * (Q(-2, n) + Q(-1, n + 1)) + R3 * (L(dm) - R(dm))

    qc = Q(-1, n)
    dmc = S(dm, slice(1, -1))  # dm at cells [-1, n]
    zero = torch.zeros((), dtype=q.dtype, device=q.device)

    if iord in (8, 11):
        xt2 = (2.0 if iord == 8 else PPM_FAC) * dmc
        bl = -torch.sign(xt2) * torch.minimum(torch.abs(xt2),
                                              torch.abs(L(al) - qc))
        br = torch.sign(xt2) * torch.minimum(torch.abs(xt2),
                                             torch.abs(R(al) - qc))
    elif iord == 10:
        bl = L(al) - qc
        br = R(al) - qc
        dqf = 2.0 * (Q(-2, n + 2) - Q(-3, n + 1))   # cell c at index c+3

        def dqat(off):
            return S(dqf, slice(2 + off, 2 + off + n + 2))

        flat = (torch.abs(S(dm, slice(None, -2))) + torch.abs(dmc)
                + torch.abs(S(dm, slice(2, None)))) < NEAR_ZERO
        big = torch.abs(3.0 * (bl + br)) > torch.abs(bl - br)
        pmp_2 = dqat(-1)
        lac_2 = pmp_2 - 0.75 * dqat(-2)
        br_c = torch.minimum(
            torch.clamp_min(torch.maximum(pmp_2, lac_2), 0.0),
            torch.maximum(br, torch.clamp_max(torch.minimum(pmp_2, lac_2),
                                              0.0)))
        pmp_1 = -dqat(0)
        lac_1 = pmp_1 + 0.75 * dqat(1)
        bl_c = torch.minimum(
            torch.clamp_min(torch.maximum(pmp_1, lac_1), 0.0),
            torch.maximum(bl, torch.clamp_max(torch.minimum(pmp_1, lac_1),
                                              0.0)))
        bl = torch.where(flat, zero, torch.where(big, bl_c, bl))
        br = torch.where(flat, zero, torch.where(big, br_c, br))
    elif iord in (7, 12):
        bl = L(al) - qc
        br = R(al) - qc
        a4 = -3.0 * (bl + br)
        da1 = br - bl
        ext5 = br * bl > 0.0
        ext6 = torch.abs(da1) < -a4
        fmin = qc + 0.25 / _nz(a4) * da1 ** 2 + a4 * R12
        fix = ext6 & (fmin < 0.0)
        br_n = torch.where(ext5, zero, torch.where(da1 > 0.0, -2.0 * bl, br))
        bl_n = torch.where(ext5, zero, torch.where(da1 > 0.0, bl, -2.0 * br))
        bl = torch.where(fix, bl_n, bl)
        br = torch.where(fix, br_n, br)
    else:   # 9, 13 and others: plain al then pert_ppm PD constraint
        bl = L(al) - qc
        br = R(al) - qc

    if iord in (9, 13):
        bl, br = _pert_ppm_iv0(qc, bl, br)

    # ---- tile-edge overrides (tp_core.F90:634-676) ---------------------
    def dm0(cc):
        return S(dm, slice(cc + 2, cc + 3))

    bl_m1 = S14 * dm0(-2) + S11 * (q0(-2) - q0(-1))
    xt_w = _edge_extrap(q0(-2), q0(-1), q0(0), q0(1),
                        dx0(-2), dx0(-1), dx0(0), dx0(1))
    qmin = torch.minimum(torch.minimum(q0(-2), q0(-1)),
                         torch.minimum(q0(0), q0(1)))
    qmax = torch.maximum(torch.maximum(q0(-2), q0(-1)),
                         torch.maximum(q0(0), q0(1)))
    xt_w = torch.minimum(torch.maximum(xt_w, qmin), qmax)
    br_m1 = xt_w - q0(-1)
    bl_0 = xt_w - q0(0)
    xt2 = S15 * q0(0) + S11 * q0(1) - S14 * dm0(1)
    br_0 = xt2 - q0(0)
    bl_1 = xt2 - q0(1)
    br_1 = S(al, slice(3, 4)) - q0(1)            # al at wall 2
    bl_n2 = S(al, slice(n - 1, n)) - q0(n - 2)   # al at wall n-2
    xt3 = S15 * q0(n - 1) + S11 * q0(n - 2) + S14 * dm0(n - 2)
    br_n2 = xt3 - q0(n - 2)
    bl_n1 = xt3 - q0(n - 1)
    xt_e = _edge_extrap(q0(n - 2), q0(n - 1), q0(n), q0(n + 1),
                        dx0(n - 2), dx0(n - 1), dx0(n), dx0(n + 1))
    qmin = torch.minimum(torch.minimum(q0(n - 2), q0(n - 1)),
                         torch.minimum(q0(n), q0(n + 1)))
    qmax = torch.maximum(torch.maximum(q0(n - 2), q0(n - 1)),
                         torch.maximum(q0(n), q0(n + 1)))
    xt_e = torch.minimum(torch.maximum(xt_e, qmin), qmax)
    br_n1 = xt_e - q0(n - 1)
    bl_n = xt_e - q0(n)
    br_n = S11 * (q0(n + 1) - q0(n)) - S14 * dm0(n + 1)
    bl_c = setcols(bl, [(0, bl_m1), (1, bl_0), (2, bl_1),
                        (n - 1, bl_n2), (n, bl_n1), (n + 1, bl_n)])
    br_c = setcols(br, [(0, br_m1), (1, br_0), (2, br_1),
                        (n - 1, br_n2), (n, br_n1), (n + 1, br_n)])
    # the standard constraint applies only on the 6 edge cells
    blp, brp = _pert_ppm_iv1(qc, bl_c, br_c)
    edgem = edge_mask([0, 1, 2, n - 1, n, n + 1], bl.shape[ax])
    bl = torch.where(edgem, blp, bl)
    br = torch.where(edgem, brp, br)

    b0 = bl + br
    cpos = c > 0.0
    qL, qR = L(qc), R(qc)
    blL, brL, b0L = L(bl), L(br), L(b0)
    blR, brR, b0R = R(bl), R(br), R(b0)
    if iord == 7:
        smt5 = bl * br < 0.0
        fx1 = torch.where(cpos, (1.0 - c) * (brL - c * b0L),
                          (1.0 + c) * (blR + c * b0R))
        add = L(smt5) | R(smt5)
        return torch.where(cpos, qL, qR) + _where0(add, fx1)
    return torch.where(cpos,
                       qL + (1.0 - c) * (brL - c * b0L),
                       qR + (1.0 + c) * (blR + c * b0R))


def yppm(q, c, dya, jord, lim_fac=1.0):
    """1-D PPM flux along the second-to-last axis (tp_core.F90 yppm:715)."""
    return xppm(q, c, dya, jord, lim_fac, axis=-2)


def _pad_last(a, lo, hi):
    return torch.nn.functional.pad(a, (lo, hi))


def _pad_rows(a, lo, hi):
    return torch.nn.functional.pad(a, (0, 0, lo, hi))


def deln_damp_fluxes(q, nord, g, prefac=None):
    """Del-n damping fluxes (tp_core.F90 deln_flux:1267, sw_core
    del6_vt_flux). q: [..., P, P] padded cells (halo-exchanged). Returns
    (fx2, fy2) full-size x-wall / y-wall flux arrays, valid on the compute
    walls for nord <= 2. prefac premultiplies q (the no-mass deln_flux
    path). The sign alternates per pass exactly as the reference."""
    h = 3

    def dgx(d2, s):
        return _pad_last(g.del6_v[..., :, 1:-1] * s
                         * (d2[..., :, 1:] - d2[..., :, :-1]), 1, 1)

    def dgy(d2, s):
        return _pad_rows(g.del6_u[..., 1:-1, :] * s
                         * (d2[..., 1:, :] - d2[..., :-1, :]), 1, 1)

    def cc1(a):
        return copy_corners(a, h, 1)

    def cc2(a):
        return copy_corners(a, h, 2)

    d2 = q if prefac is None else prefac * q
    if nord > 0:
        fx2 = dgx(cc1(d2), -1.0)
        fy2 = dgy(cc2(d2), -1.0)
    else:
        fx2 = dgx(d2, -1.0)
        fy2 = dgy(d2, -1.0)
    for _ in range(nord):
        d2 = (fx2[..., :, :-1] - fx2[..., :, 1:]
              + fy2[..., :-1, :] - fy2[..., 1:, :]) * g.rarea
        fx2 = dgx(cc1(d2), 1.0)
        fy2 = dgy(cc2(d2), 1.0)
    return fx2, fy2


def deln_flux_add(q, fx, fy, nord, damp4, g, mass=None):
    """Add del-n diffusive fluxes to advective fluxes on the compute walls
    (tp_core.F90 deln_flux:1267). fx: [..., n, W]; fy: [..., W, n]."""
    h = 3
    n = q.shape[-1] - 2 * h
    ctr = slice(h, h + n)
    wsl = slice(h, h + n + 1)
    fx2, fy2 = deln_damp_fluxes(q, nord, g,
                                prefac=None if mass is not None else damp4)
    fx2c = fx2[..., ctr, wsl]
    fy2c = fy2[..., wsl, ctr]
    if mass is None:
        return fx + fx2c, fy + fy2c
    mxl = mass[..., ctr, h - 1:h + n]
    mxr = mass[..., ctr, h:h + n + 1]
    myl = mass[..., h - 1:h + n, ctr]
    myr = mass[..., h:h + n + 1, ctr]
    return (fx + 0.5 * damp4 * (mxl + mxr) * fx2c,
            fy + 0.5 * damp4 * (myl + myr) * fy2c)


def fv_tp_2d(q, crx, cry, hord, xfx, yfx, area, ra_x, ra_y, dxa, dya,
             h=3, lim_fac=1.0, mfx=None, mfy=None,
             nord=None, damp_c=None, g=None, mass=None,
             nord2=0, damp_c2=None, sweep=None):
    """2-D flux-form advection operator (tp_core.F90 fv_tp_2d:85).

    Shapes (n = cells/side, P = n+2h, W = n+1):
      q:         [..., P, P]   padded scalar (halo-exchanged)
      crx, xfx:  [..., P, W]   Courant/area-flux at x-walls (or full P+1)
      cry, yfx:  [..., W, P]   same at y-walls
      area:      [..., P, P]   padded cell areas
      ra_x:      [..., P, n]   area + xfx(w) - xfx(w+1) (or full P)
      ra_y:      [..., n, P]
      mfx/mfy:   [..., n, W] / [..., W, n]  optional mass fluxes
    Returns (fx, fy) on the compute walls, [..., n, W] and [..., W, n],
    already multiplied by the mass or area flux. The double sweep runs in
    `sweep`, by default tp_sweep.tp2d_sweep: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor.
    """
    n = q.shape[-1] - 2 * h
    ctr = slice(h, h + n)
    wsl = slice(h, h + n + 1)
    if crx.shape[-1] == n + 1 + 2 * h:      # full-wall arrays from d_sw
        crx = crx[..., :, wsl]
        xfx = xfx[..., :, wsl]
    if cry.shape[-2] == n + 1 + 2 * h:
        cry = cry[..., wsl, :]
        yfx = yfx[..., wsl, :]
    if ra_x.shape[-1] == q.shape[-1]:
        ra_x = ra_x[..., :, ctr]
    if ra_y.shape[-2] == q.shape[-2]:
        ra_y = ra_y[..., ctr, :]

    if sweep is None:
        from .tp_sweep import tp2d_sweep as sweep
    fx, fy = sweep(q, crx, cry, hord, xfx, yfx, area, ra_x, ra_y,
                        dxa, dya, lim_fac=lim_fac, mfx=mfx, mfy=mfy)

    if g is not None and nord is not None:
        # damp_c may be a scalar or a per-level [K] profile; a second
        # (nord2, damp_c2) combo supports levels with another damping order
        for nd, dc in ((nord, damp_c), (nord2, damp_c2)):
            if dc is None:
                continue
            dcn = np.asarray(dc, dtype=np.float64)
            if float(dcn.max()) <= 1.0e-4:
                continue
            dcb = (float(dcn) if dcn.ndim == 0
                   else torch.as_tensor(dcn, dtype=q.dtype,
                                        device=q.device).reshape(-1, 1, 1))
            damp4 = (dcb * g.da_min) ** (nd + 1)   # da_min (tp_core.F90:204)
            fx, fy = deln_flux_add(q, fx, fy, nd, damp4, g, mass=mass)
    return fx, fy
