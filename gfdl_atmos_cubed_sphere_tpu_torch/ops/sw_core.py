"""Lin-Rood shallow-water solvers on Lagrangian surfaces (C-grid + D-grid),
PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/ops/sw_core.py (FV3
model/sw_core.F90 c_sw:79, d_sw:494, d2a2c_vect:3006, divergence_corner:1740,
xtp_u:2154, ytp_v:2524). Ported: the shallow-water forms of c_sw and d_sw
(sw_mode=True, advection_only both ways) and their 3-D nonhydrostatic forms
(pt and w transport, w damping and its heat source, per-level damping
profiles, nord_mask, the second damping combo, the Smagorinsky operand and
the stage="fluxes"/"winds" split). The non-cube grids raise
NotImplementedError.

Index conventions (H = 3 halo; Fortran 1-based index p -> padded index p-1+H):
  cell arrays    [..., NC, NC],  NC = n+2H     (delp, pt, ua, va)
  y-wall arrays  [..., NW, NC],  NW = n+1+2H   (u, vc, vt, cry, yfx)
  x-wall arrays  [..., NC, NW]                 (v, uc, ut, crx, xfx)
  corner arrays  [..., NW, NW]                 (divg_d, ke, vort, ub, vb)

Static index overrides of the JAX code (.at[].set, strip concatenation) are
in-place assignments on tensors this module allocated itself.
"""

from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from .tp_core import fv_tp_2d, deln_damp_fluxes, _pert_ppm_iv1
from .a2b_edge import a2b_ord4
from .fill_corners import (fill_4corners_cell, fill_corners_bgrid,
                           fill_corners_dgrid_vector, fi, cube_edges)
from ..parallel.halo import copy_corners

H = 3
A1, A2 = 0.5625, -0.0625
C1, C2, C3 = -2.0 / 14.0, 11.0 / 14.0, 5.0 / 14.0
S11, S14, S15 = 11.0 / 14.0, 4.0 / 7.0, 3.0 / 14.0
P1, P2 = 7.0 / 12.0, -1.0 / 12.0
R3 = 1.0 / 3.0
NEAR_ZERO = 1.0e-9          # KE limiter threshold (sw_core.F90:39)


def _cl(q):
    """cell i-1 viewed at wall i (pad one column left)."""
    return F.pad(q, (1, 0))


def _cr(q):
    """cell i viewed at wall i (pad one column right)."""
    return F.pad(q, (0, 1))


def _rl(q):
    """cell j-1 viewed at wall j (pad one row on top)."""
    return F.pad(q, (0, 0, 1, 0))


def _rr(q):
    return F.pad(q, (0, 0, 0, 1))


def _where(cond, a, b):
    """torch.where that also takes Python scalars for a or b."""
    like = a if torch.is_tensor(a) else b
    if not torch.is_tensor(a):
        a = torch.as_tensor(a, dtype=like.dtype, device=like.device)
    if not torch.is_tensor(b):
        b = torch.as_tensor(b, dtype=like.dtype, device=like.device)
    return torch.where(cond, a, b)


def _not_cube(g, what):
    if not cube_edges(g):
        raise NotImplementedError(
            f"{what}: the port carries the cubed-sphere grid only")


def edge_interpolate4(ua, dxa):
    """sw_core.F90 edge_interpolate4:3338 on a 4-point window along the last
    axis."""
    t1 = dxa[..., 0] + dxa[..., 1]
    t2 = dxa[..., 2] + dxa[..., 3]
    return 0.5 * (((t1 + dxa[..., 1]) * ua[..., 1] - dxa[..., 1] * ua[..., 0])
                  / t1
                  + ((t2 + dxa[..., 2]) * ua[..., 2] - dxa[..., 2] * ua[..., 3])
                  / t2)


# ===========================================================================
# d2a2c_vect (sw_core.F90:3006): D-grid winds -> A-grid + C-grid winds
# ===========================================================================

def d2a2c_vect(u, v, g):
    """u: [..., NW, NC] D x-wind; v: [..., NC, NW] D y-wind (halo-exchanged).
    Returns (ua, va, uc, vc, ut, vt)."""
    _not_cube(g, "d2a2c_vect")
    npx = g.npx
    n = g.n
    f = fi
    npt = 4
    NC = n + 2 * H
    NW = n + 1 + 2 * H
    batch = u.shape[:-2]

    utmp = 0.5 * (u[..., :-1, :] + u[..., 1:, :])
    vtmp = 0.5 * (v[..., :, :-1] + v[..., :, 1:])
    L = npx - 2 * npt + 1
    j0 = f(npt)
    w0 = f(npt - 1)
    u4 = (A2 * (u[..., w0:w0 + L, :] + u[..., w0 + 3:w0 + 3 + L, :])
          + A1 * (u[..., w0 + 1:w0 + 1 + L, :] + u[..., w0 + 2:w0 + 2 + L, :]))
    utmp[..., j0:j0 + L, j0:j0 + L] = u4[..., :, j0:j0 + L]
    v4 = (A2 * (v[..., :, w0:w0 + L] + v[..., :, w0 + 3:w0 + 3 + L])
          + A1 * (v[..., :, w0 + 1:w0 + 1 + L] + v[..., :, w0 + 2:w0 + 2 + L]))
    vtmp[..., j0:j0 + L, j0:j0 + L] = v4[..., j0:j0 + L, :]

    ua = (utmp - vtmp * g.cosa_s) * g.rsin2
    va = (vtmp - utmp * g.cosa_s) * g.rsin2

    r0, rn = f(0), f(npx)
    je = npx - 1

    # utmp corner fills (sw_core.F90:3165-3185)
    utmp[..., r0, f(-2):r0 + 1] = -vtmp[..., f(1):f(3) + 1, r0].flip(-1)
    utmp[..., r0, f(npx):f(npx + 2) + 1] = vtmp[..., f(1):f(3) + 1, rn]
    utmp[..., rn, f(npx):f(npx + 2) + 1] = \
        -vtmp[..., f(je - 2):f(je) + 1, rn].flip(-1)
    utmp[..., rn, f(-2):r0 + 1] = vtmp[..., f(je - 2):f(je) + 1, r0]

    # uc: 4th-order A->C in x
    uc = u.new_zeros(batch + (NC, NW))
    Lc = npx + 2
    s = f(-2)
    uc[..., :, r0:r0 + Lc] = (
        A2 * (utmp[..., :, s:s + Lc] + utmp[..., :, s + 3:s + 3 + Lc])
        + A1 * (utmp[..., :, s + 1:s + 1 + Lc]
                + utmp[..., :, s + 2:s + 2 + Lc]))

    # ua corner fills (sw_core.F90:3202-3218)
    for (dj, di, sj, si, sg) in ((r0, f(-1), f(2), r0, -1.0),
                                 (r0, f(0), f(1), r0, -1.0),
                                 (r0, f(npx), f(1), rn, 1.0),
                                 (r0, f(npx + 1), f(2), rn, 1.0),
                                 (rn, f(npx), f(npx - 1), rn, -1.0),
                                 (rn, f(npx + 1), f(npx - 2), rn, -1.0),
                                 (rn, f(-1), f(npx - 2), r0, 1.0),
                                 (rn, f(0), f(npx - 1), r0, 1.0)):
        ua[..., dj, di] = sg * va[..., sj, si]

    # west edge (sw_core.F90:3220-3236)
    uc0 = (C1 * utmp[..., :, f(-2)] + C2 * utmp[..., :, f(-1)]
           + C3 * utmp[..., :, f(0)])
    ut1 = edge_interpolate4(ua[..., :, f(-1):f(2) + 1],
                            g.dxa[..., :, f(-1):f(2) + 1])
    uc1 = torch.where(ut1 > 0.0, ut1 * g.sin_sg3[..., :, f(0)],
                      ut1 * g.sin_sg1[..., :, f(1)])
    uc2 = (C1 * utmp[..., :, f(3)] + C2 * utmp[..., :, f(2)]
           + C3 * utmp[..., :, f(1)])
    uc[..., :, f(0)] = uc0
    uc[..., :, f(1)] = uc1
    uc[..., :, f(2)] = uc2
    # east edge (sw_core.F90:3238-3253)
    ucm = (C1 * utmp[..., :, f(npx - 3)] + C2 * utmp[..., :, f(npx - 2)]
           + C3 * utmp[..., :, f(npx - 1)])
    utn = edge_interpolate4(ua[..., :, f(npx - 2):f(npx + 1) + 1],
                            g.dxa[..., :, f(npx - 2):f(npx + 1) + 1])
    ucn = torch.where(utn > 0.0, utn * g.sin_sg3[..., :, f(npx - 1)],
                      utn * g.sin_sg1[..., :, f(npx)])
    ucp = (C3 * utmp[..., :, f(npx)] + C2 * utmp[..., :, f(npx + 1)]
           + C1 * utmp[..., :, f(npx + 2)])
    uc[..., :, f(npx - 1)] = ucm
    uc[..., :, f(npx)] = ucn
    uc[..., :, f(npx + 1)] = ucp

    ut = (uc - v * g.cosa_u) * g.rsin_u
    ut[..., :, f(1)] = ut1
    ut[..., :, f(npx)] = utn

    # vtmp corner fills (sw_core.F90:3258-3278)
    vtmp[..., f(-2):r0 + 1, r0] = -utmp[..., r0, f(1):f(3) + 1].flip(-1)
    vtmp[..., f(npx):f(npx + 2) + 1, r0] = utmp[..., rn, f(1):f(3) + 1]
    vtmp[..., f(-2):r0 + 1, rn] = utmp[..., r0, f(je - 2):f(je) + 1]
    vtmp[..., f(npx):f(npx + 2) + 1, rn] = \
        -utmp[..., rn, f(je - 2):f(je) + 1].flip(-1)
    # va corner fills (sw_core.F90:3280-3296)
    for (dj, di, sj, si, sg) in ((f(-1), r0, r0, f(2), -1.0),
                                 (f(0), r0, r0, f(1), -1.0),
                                 (f(0), rn, r0, f(npx - 1), 1.0),
                                 (f(-1), rn, r0, f(npx - 2), 1.0),
                                 (f(npx), rn, rn, f(npx - 1), -1.0),
                                 (f(npx + 1), rn, rn, f(npx - 2), -1.0),
                                 (f(npx), r0, rn, f(1), 1.0),
                                 (f(npx + 1), r0, rn, f(2), 1.0)):
        va[..., dj, di] = sg * ua[..., sj, si]

    # vc: 4th-order A->C in y (sw_core.F90:3298-3334)
    vc = u.new_zeros(batch + (NW, NC))
    vc[..., r0:r0 + Lc, :] = (
        A2 * (vtmp[..., s:s + Lc, :] + vtmp[..., s + 3:s + 3 + Lc, :])
        + A1 * (vtmp[..., s + 1:s + 1 + Lc, :]
                + vtmp[..., s + 2:s + 2 + Lc, :]))
    vc[..., f(0), :] = (C1 * vtmp[..., f(-2), :] + C2 * vtmp[..., f(-1), :]
                        + C3 * vtmp[..., f(0), :])
    vt1 = edge_interpolate4(va[..., f(-1):f(2) + 1, :].transpose(-1, -2),
                            g.dya[..., f(-1):f(2) + 1, :].transpose(-1, -2))
    vc[..., f(1), :] = torch.where(vt1 > 0.0, vt1 * g.sin_sg4[..., f(0), :],
                                   vt1 * g.sin_sg2[..., f(1), :])
    vc[..., f(2), :] = (C1 * vtmp[..., f(3), :] + C2 * vtmp[..., f(2), :]
                        + C3 * vtmp[..., f(1), :])
    vc[..., f(npx - 1), :] = (
        C1 * vtmp[..., f(npx - 3), :] + C2 * vtmp[..., f(npx - 2), :]
        + C3 * vtmp[..., f(npx - 1), :])
    vtn = edge_interpolate4(
        va[..., f(npx - 2):f(npx + 1) + 1, :].transpose(-1, -2),
        g.dya[..., f(npx - 2):f(npx + 1) + 1, :].transpose(-1, -2))
    vc[..., f(npx), :] = torch.where(
        vtn > 0.0, vtn * g.sin_sg4[..., f(npx - 1), :],
        vtn * g.sin_sg2[..., f(npx), :])
    vc[..., f(npx + 1), :] = (
        C1 * vtmp[..., f(npx + 2), :] + C2 * vtmp[..., f(npx + 1), :]
        + C3 * vtmp[..., f(npx), :])

    vt = (vc - u * g.cosa_v) * g.rsin_v
    vt[..., f(1), :] = vt1
    vt[..., f(npx), :] = vtn
    return ua, va, uc, vc, ut, vt


# ===========================================================================
# divergence_corner (sw_core.F90:1740)
# ===========================================================================

def divergence_corner(u, v, ua, va, g):
    _not_cube(g, "divergence_corner")
    npx = g.npx
    f = fi
    uf = ((u - 0.25 * (_rl(va) + _rr(va)) * (_rl(g.cos_sg4) + _rr(g.cos_sg2)))
          * g.dyc * 0.5 * (_rl(g.sin_sg4) + _rr(g.sin_sg2)))
    for jw in (1, npx):
        uf[..., f(jw), :] = (
            u[..., f(jw), :] * g.dyc[..., f(jw), :] * 0.5
            * (g.sin_sg4[..., f(jw - 1), :] + g.sin_sg2[..., f(jw), :]))
    vf = ((v - 0.25 * (_cl(ua) + _cr(ua)) * (_cl(g.cos_sg3) + _cr(g.cos_sg1)))
          * g.dxc * 0.5 * (_cl(g.sin_sg3) + _cr(g.sin_sg1)))
    for iw in (1, npx):
        vf[..., :, f(iw)] = (
            v[..., :, f(iw)] * g.dxc[..., :, f(iw)] * 0.5
            * (g.sin_sg3[..., :, f(iw - 1)] + g.sin_sg1[..., :, f(iw)]))
    divg = (_rl(vf) - _rr(vf) + _cl(uf) - _cr(uf))
    divg[..., f(1), f(1)] += -vf[..., f(0), f(1)]
    divg[..., f(1), f(npx)] += -vf[..., f(0), f(npx)]
    divg[..., f(npx), f(npx)] += vf[..., f(npx), f(npx)]
    divg[..., f(npx), f(1)] += vf[..., f(npx), f(1)]
    return divg * g.rarea_c


# ===========================================================================
# c_sw (sw_core.F90:79): C-grid half-step
# ===========================================================================

def c_sw(delp, pt, w, u, v, g, dt2, hydrostatic=True, nord=0, sw_mode=False):
    """All inputs padded (halo-exchanged). Returns SimpleNamespace with
    delpc, ptc, wc (cell arrays, valid on rim [0..npx] cells), uc, vc
    (updated on compute walls), ua, va, divg_d, and the dt2-scaled area
    fluxes ut, vt. sw_mode skips the pt transport; hydrostatic skips w.
    The plain version of the c_sw kernel (ops/csw.py)."""
    _not_cube(g, "c_sw")
    npx = g.npx
    f = fi
    ua, va, uc, vc, ut, vt = d2a2c_vect(u, v, g)
    divg_d = divergence_corner(u, v, ua, va, g) if nord > 0 else None

    ut_s = dt2 * ut * g.dy * torch.where(ut > 0.0, _cl(g.sin_sg3),
                                         _cr(g.sin_sg1))
    vt_s = dt2 * vt * g.dx * torch.where(vt > 0.0, _rl(g.sin_sg4),
                                         _rr(g.sin_sg2))

    # ---- transport delp (pt, w) ------------------------------------------
    dx1 = fill_4corners_cell(delp, 1, npx)
    fx1 = ut_s * torch.where(ut_s > 0.0, _cl(dx1), _cr(dx1))
    if not sw_mode:
        px1 = fill_4corners_cell(pt, 1, npx)
        fxp = fx1 * torch.where(ut_s > 0.0, _cl(px1), _cr(px1))
    if not hydrostatic:
        wx1 = fill_4corners_cell(w, 1, npx)
        fxw = fx1 * torch.where(ut_s > 0.0, _cl(wx1), _cr(wx1))
    dy1 = fill_4corners_cell(delp, 2, npx)
    fy1 = vt_s * torch.where(vt_s > 0.0, _rl(dy1), _rr(dy1))
    if not sw_mode:
        py1 = fill_4corners_cell(pt, 2, npx)
        fyp = fy1 * torch.where(vt_s > 0.0, _rl(py1), _rr(py1))
    if not hydrostatic:
        wy1 = fill_4corners_cell(w, 2, npx)
        fyw = fy1 * torch.where(vt_s > 0.0, _rl(wy1), _rr(wy1))

    def div(fx, fy):
        return (fx[..., :, :-1] - fx[..., :, 1:]
                + fy[..., :-1, :] - fy[..., 1:, :]) * g.rarea

    delpc = delp + div(fx1, fy1)
    ptc = pt if sw_mode else (pt * delp + div(fxp, fyp)) / delpc
    wc = None if hydrostatic else (w * delp + div(fxw, fyw)) / delpc

    # ---- KE (sw_core.F90:297-372) ----------------------------------------
    kepos = uc[..., :, :-1].clone()
    keneg = uc[..., :, 1:].clone()
    vtpos = vc[..., :-1, :].clone()
    vtneg = vc[..., 1:, :].clone()
    kepos[..., :, f(1)] = (uc[..., :, f(1)] * g.sin_sg1[..., :, f(1)]
                           + v[..., :, f(1)] * g.cos_sg1[..., :, f(1)])
    kepos[..., :, f(npx)] = (uc[..., :, f(npx)] * g.sin_sg1[..., :, f(npx)]
                             + v[..., :, f(npx)] * g.cos_sg1[..., :, f(npx)])
    keneg[..., :, f(0)] = (uc[..., :, f(1)] * g.sin_sg3[..., :, f(0)]
                           + v[..., :, f(1)] * g.cos_sg3[..., :, f(0)])
    keneg[..., :, f(npx - 1)] = (
        uc[..., :, f(npx)] * g.sin_sg3[..., :, f(npx - 1)]
        + v[..., :, f(npx)] * g.cos_sg3[..., :, f(npx - 1)])
    vtpos[..., f(1), :] = (vc[..., f(1), :] * g.sin_sg2[..., f(1), :]
                           + u[..., f(1), :] * g.cos_sg2[..., f(1), :])
    vtpos[..., f(npx), :] = (vc[..., f(npx), :] * g.sin_sg2[..., f(npx), :]
                             + u[..., f(npx), :] * g.cos_sg2[..., f(npx), :])
    vtneg[..., f(0), :] = (vc[..., f(1), :] * g.sin_sg4[..., f(0), :]
                           + u[..., f(1), :] * g.cos_sg4[..., f(0), :])
    vtneg[..., f(npx - 1), :] = (
        vc[..., f(npx), :] * g.sin_sg4[..., f(npx - 1), :]
        + u[..., f(npx), :] * g.cos_sg4[..., f(npx - 1), :])
    ke = torch.where(ua > 0.0, kepos, keneg)
    vortk = torch.where(va > 0.0, vtpos, vtneg)
    ke = (0.5 * dt2) * (ua * ke + va * vortk)

    # ---- absolute vorticity on corners (sw_core.F90:374-404) -------------
    fxc = uc * g.dxc
    fyc = vc * g.dyc
    circ = _rl(fxc) - _rr(fxc) - _cl(fyc) + _cr(fyc)
    circ[..., f(1), f(1)] += fyc[..., f(1), f(0)]
    circ[..., f(1), f(npx)] += -fyc[..., f(1), f(npx)]
    circ[..., f(npx), f(npx)] += -fyc[..., f(npx), f(npx)]
    circ[..., f(npx), f(1)] += fyc[..., f(npx), f(0)]
    vortB = g.fC + g.rarea_c * circ

    # ---- transport absolute vorticity; update uc/vc ----------------------
    fy1v = dt2 * (v - uc * g.cosa_u) / g.sina_u
    fy1v[..., :, f(1)] = dt2 * v[..., :, f(1)]
    fy1v[..., :, f(npx)] = dt2 * v[..., :, f(npx)]
    fyv = torch.where(fy1v > 0.0, vortB[..., :-1, :], vortB[..., 1:, :])

    fx1u = dt2 * (u - vc * g.cosa_v) / g.sina_v
    fx1u[..., f(1), :] = dt2 * u[..., f(1), :]
    fx1u[..., f(npx), :] = dt2 * u[..., f(npx), :]
    fxu = torch.where(fx1u > 0.0, vortB[..., :, :-1], vortB[..., :, 1:])

    wall_c = slice(f(1), f(npx) + 1)
    cell_c = slice(f(1), f(npx - 1) + 1)
    uc_inc = fy1v * fyv + g.rdxc * (_cl(ke) - _cr(ke))
    vc_inc = -fx1u * fxu + g.rdyc * (_rl(ke) - _rr(ke))
    uc = uc.clone()
    vc = vc.clone()
    uc[..., cell_c, wall_c] += uc_inc[..., cell_c, wall_c]
    vc[..., wall_c, cell_c] += vc_inc[..., wall_c, cell_c]

    return SimpleNamespace(delpc=delpc, ptc=ptc, wc=wc, uc=uc, vc=vc,
                           ua=ua, va=va, divg_d=divg_d, ut=ut_s, vt=vt_s)


# ===========================================================================
# xtp_u / ytp_v (sw_core.F90:2154 / 2524): wind advection to B points
# ===========================================================================

def xtp_u(c, u, dx, rdx, iord, lim_fac=1.0, axis=-1):
    """Flux of the D-grid u wind to cell corners (sw_core.F90 xtp_u:2154).

    axis=-1: c [..., NW, NW] corner Courant distance (valid [1..npx]);
    u, dx, rdx [..., NW, NC] y-wall arrays; PPM stencil along the last axis.
    axis=-2: the ytp_v orientation (sw_core.F90 ytp_v:2524), v/dy/rdy
    [..., NC, NW] x-wall arrays, stencil along rows.
    """
    npx = c.shape[-1] - 2 * H
    f = fi
    ax = axis

    def S(q, sl):
        return q[..., sl] if ax == -1 else q[..., sl, :]

    def col(q, i, w=1):
        return S(q, slice(f(i), f(i) + w))

    def cat(parts):
        return torch.cat(parts, ax)

    def padq(q, lo, hi):
        return F.pad(q, (lo, hi)) if ax == -1 else F.pad(q, (0, 0, lo, hi))

    cl = lambda q: padq(q, 1, 0)
    cr = lambda q: padq(q, 0, 1)

    # corner-row zero mask along the orthogonal (wall) axis: f(1), f(npx)
    NWlen = c.shape[-1]
    zi = torch.arange(NWlen, device=c.device)
    zrow = (zi == f(1)) | (zi == f(npx))
    zrow = zrow[:, None] if ax == -1 else zrow[None, :]
    zeroed = lambda t: _where(zrow, 0.0, t)
    zero2 = torch.zeros_like(S(u, slice(0, 2)))

    u0 = lambda i: col(u, i)
    dx0 = lambda i: col(dx, i)
    La = npx - 4          # al walls [3, npx-2]
    Lb = npx - 5          # interior cells [3, npx-3]

    def edge_extrap_w():
        xl = 0.5 * ((2.0 * dx0(0) + dx0(-1)) * u0(0)
                    - dx0(0) * u0(-1)) / (dx0(0) + dx0(-1))
        xr = 0.5 * ((2.0 * dx0(1) + dx0(2)) * u0(1)
                    - dx0(1) * u0(2)) / (dx0(1) + dx0(2))
        return xl + xr

    def edge_extrap_e():
        xl = 0.5 * ((2.0 * dx0(npx - 1) + dx0(npx - 2)) * u0(npx - 1)
                    - dx0(npx - 1) * u0(npx - 2)) / (dx0(npx - 1)
                                                     + dx0(npx - 2))
        xr = 0.5 * ((2.0 * dx0(npx) + dx0(npx + 1)) * u0(npx)
                    - dx0(npx) * u0(npx + 1)) / (dx0(npx) + dx0(npx + 1))
        return xl + xr

    if iord < 8:
        # ---- linear PPM family (sw_core.F90:2177-2291) --------------------
        al_m = (P1 * (col(u, 2, La) + col(u, 3, La))
                + P2 * (col(u, 1, La) + col(u, 4, La)))
        qq = col(u, 3, Lb)
        blv = S(al_m, slice(0, Lb)) - qq
        brv = S(al_m, slice(1, 1 + Lb)) - qq
        xt = C3 * u0(1) + C2 * u0(2) + C1 * u0(3)
        bl_0 = C1 * u0(-2) + C2 * u0(-1) + C3 * u0(0) - u0(0)
        xt0 = edge_extrap_w()
        br_0 = xt0 - u0(0)
        bl_1 = xt0 - u0(1)
        br_1 = xt - u0(1)
        bl_2 = xt - u0(2)
        br_2 = S(al_m, slice(0, 1)) - u0(2)
        bl_n2 = S(al_m, slice(La - 1, La)) - u0(npx - 2)
        xte = C1 * u0(npx - 3) + C2 * u0(npx - 2) + C3 * u0(npx - 1)
        br_n2 = xte - u0(npx - 2)
        bl_n1 = xte - u0(npx - 1)
        xtn = edge_extrap_e()
        br_n1 = xtn - u0(npx - 1)
        bl_n = xtn - u0(npx)
        br_n = C3 * u0(npx) + C2 * u0(npx + 1) + C1 * u0(npx + 2) - u0(npx)
        bl_0, br_0, bl_1, br_1 = (zeroed(t) for t in (bl_0, br_0, bl_1, br_1))
        bl_n1, br_n1, bl_n, br_n = (zeroed(t)
                                    for t in (bl_n1, br_n1, bl_n, br_n))
        bl = cat([zero2, bl_0, bl_1, bl_2, blv, bl_n2, bl_n1, bl_n, zero2])
        br = cat([zero2, br_0, br_1, br_2, brv, br_n2, br_n1, br_n, zero2])
        b0 = bl + br
        if iord == 5:
            smt5 = bl * br < 0.0
        else:  # 6, 7
            gen = 3.0 * torch.abs(b0) < torch.abs(bl - br)
            edge = bl * br < 0.0
            ei = torch.arange(u.shape[ax], device=u.device)
            emj = ((ei == f(0)) | (ei == f(1)) | (ei == f(npx - 1))
                   | (ei == f(npx)))
            emj = emj[None, :] if ax == -1 else emj[:, None]
            smt5 = torch.where(emj, edge, gen)
        cpos = c > 0.0
        cfl = c * torch.where(cpos, cl(rdx), cr(rdx))
        fx0 = torch.where(cpos, (1.0 - cfl) * (cl(br) - cfl * cl(b0)),
                          (1.0 + cfl) * (cr(bl) + cfl * cr(b0)))
        low = torch.where(cpos, cl(u), cr(u))
        smt5f = smt5.to(u.dtype)          # a 0/1 mask padded like bl, br
        add = (cl(smt5f) + cr(smt5f)) > 0.5
        return low + _where(add, fx0, 0.0)

    # ---- iord >= 8 (sw_core.F90:2293-2523) --------------------------------
    up = S(u, slice(2, None))
    um = S(u, slice(0, -2))
    uc_ = S(u, slice(1, -1))
    xt_i = 0.25 * (up - um)
    dmax = torch.maximum(torch.maximum(um, uc_), up) - uc_
    dmin = uc_ - torch.minimum(torch.minimum(um, uc_), up)
    dm = padq(torch.sign(xt_i) * torch.minimum(
        torch.minimum(torch.abs(xt_i), dmax), dmin), 1, 1)
    dq = padq(S(u, slice(1, None)) - S(u, slice(0, -1)), 0, 1)

    def dmc(i, w=1):
        return col(dm, i, w)

    def dqc(i, w=1):
        return col(dq, i, w)

    al_m = (0.5 * (col(u, 2, La) + col(u, 3, La))
            + R3 * (col(dm, 2, La) - col(dm, 3, La)))
    alL = S(al_m, slice(0, Lb))
    alR = S(al_m, slice(1, 1 + Lb))
    qq = col(u, 3, Lb)
    if iord == 8:
        x2 = 2.0 * col(dm, 3, Lb)
        blv = -torch.sign(x2) * torch.minimum(torch.abs(x2),
                                              torch.abs(alL - qq))
        brv = torch.sign(x2) * torch.minimum(torch.abs(x2),
                                             torch.abs(alR - qq))
    elif iord in (9, 10):
        dq0 = col(dq, 3, Lb)
        dqp = col(dq, 4, Lb)
        dqm = col(dq, 2, Lb)
        dqmm = col(dq, 1, Lb)
        pmp_1 = -2.0 * dq0
        lac_1 = pmp_1 + 1.5 * dqp
        lo1 = torch.clamp_min(torch.maximum(pmp_1, lac_1), 0.0)
        hi1 = torch.clamp_max(torch.minimum(pmp_1, lac_1), 0.0)
        blv = torch.minimum(lo1, torch.maximum(alL - qq, hi1))
        pmp_2 = 2.0 * dqm
        lac_2 = pmp_2 - 1.5 * dqmm
        lo2 = torch.clamp_min(torch.maximum(pmp_2, lac_2), 0.0)
        hi2 = torch.clamp_max(torch.minimum(pmp_2, lac_2), 0.0)
        brv = torch.minimum(lo2, torch.maximum(alR - qq, hi2))
        if iord == 10:
            bl0 = alL - qq
            br0 = alR - qq
            dmm = col(dm, 2, Lb)
            dm0 = col(dm, 3, Lb)
            dmp = col(dm, 4, Lb)
            # elif chain of sw_core.F90:2418-2434
            small0 = torch.abs(dm0) < NEAR_ZERO
            flat = small0 & (torch.abs(dmm) + torch.abs(dmp) < NEAR_ZERO)
            big = (~small0) & (torch.abs(3.0 * (bl0 + br0))
                               > torch.abs(bl0 - br0))
            blc = torch.minimum(lo1, torch.maximum(bl0, hi1))
            brc = torch.minimum(lo2, torch.maximum(br0, hi2))
            blv = _where(flat, 0.0, torch.where(big, blc, bl0))
            brv = _where(flat, 0.0, torch.where(big, brc, br0))
    else:  # 11: unlimited
        blv = alL - qq
        brv = alR - qq

    # west edge (sw_core.F90:2462-2495)
    xt = S15 * u0(1) + S11 * u0(2) - S14 * dmc(2)
    bl_0 = S14 * dmc(-1) - S11 * dqc(-1)
    xt0 = edge_extrap_w()
    br_0 = xt0 - u0(0)
    bl_1 = xt0 - u0(1)
    br_1 = xt - u0(1)
    bl_2 = xt - u0(2)
    br_2 = S(al_m, slice(0, 1)) - u0(2)
    # east edge
    bl_n2 = S(al_m, slice(La - 1, La)) - u0(npx - 2)
    xte = S15 * u0(npx - 1) + S11 * u0(npx - 2) + S14 * dmc(npx - 2)
    br_n2 = xte - u0(npx - 2)
    bl_n1 = xte - u0(npx - 1)
    xtn = edge_extrap_e()
    br_n1 = xtn - u0(npx - 1)
    bl_n = xtn - u0(npx)
    br_n = S11 * dqc(npx) - S14 * dmc(npx + 1)
    bl_0, br_0, bl_1, br_1 = (zeroed(t) for t in (bl_0, br_0, bl_1, br_1))
    bl_n1, br_n1, bl_n, br_n = (zeroed(t) for t in (bl_n1, br_n1, bl_n, br_n))
    bl_2, br_2 = _pert_ppm_iv1(u0(2), bl_2, br_2)
    bl_n2, br_n2 = _pert_ppm_iv1(u0(npx - 2), bl_n2, br_n2)

    bl = cat([zero2, bl_0, bl_1, bl_2, blv, bl_n2, bl_n1, bl_n, zero2])
    br = cat([zero2, br_0, br_1, br_2, brv, br_n2, br_n1, br_n, zero2])
    b0 = bl + br
    cpos = c > 0.0
    cfl = c * torch.where(cpos, cl(rdx), cr(rdx))
    return torch.where(cpos,
                       cl(u) + (1.0 - cfl) * (cl(br) - cfl * cl(b0)),
                       cr(u) + (1.0 + cfl) * (cr(bl) + cfl * cr(b0)))


def ytp_v(c, v, dy, rdy, jord, lim_fac=1.0):
    """Flux of D-grid v to corners; v, dy, rdy: [..., NC, NW] x-wall arrays."""
    return xtp_u(c, v, dy, rdy, jord, lim_fac, axis=-2)


# ===========================================================================
# d_sw (sw_core.F90:494): full D-grid forward step for one layer group
# ===========================================================================

def _on(x):
    """Is this damping coefficient active (scalar or [K] profile)."""
    return x is not None and float(np.max(np.asarray(x))) > 1.0e-5


def _pl(x, like):
    """A damping parameter as d_sw uses it: a scalar stays a float; a [K]
    numpy profile becomes a [K, 1, 1] tensor broadcasting over [.., K, P, P]
    fields, in the dtype and on the device of `like`."""
    a = np.asarray(x)
    if a.ndim == 0:
        return float(a)
    return torch.as_tensor(a, dtype=like.dtype,
                           device=like.device).reshape(-1, 1, 1)


def _as(x, like):
    """x as a tensor of like's dtype and device (a float becomes 0-d)."""
    if torch.is_tensor(x):
        return x
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def ke_section(u, v, uc, vc, ut, vt, cosa, rsina, dx, rdx, dy, rdy,
               dt, hord_mt, lim_fac, npx):
    """d_sw kinetic-energy stage (sw_core.F90:1063-1228): vb/ub advective
    corner winds, their PPM self-advection (ytp_v/xtp_u), and the corner KE
    fixes. The plain version of the ke_section kernel (ops/ke.py)."""
    f = fi
    dt5 = 0.5 * dt
    dt4 = 0.25 * dt
    mid = slice(f(2), f(npx - 1) + 1)

    vb = dt5 * (_cl(vc) + _cr(vc) - (_rl(uc) + _rr(uc)) * cosa) * rsina

    def c1(a, i):
        return a[..., mid, f(i):f(i) + 1]

    vb[..., mid, f(1):f(1) + 1] = dt4 * (
        -c1(vt, -1) + 3.0 * (c1(vt, 0) + c1(vt, 1)) - c1(vt, 2))
    vb[..., mid, f(npx):f(npx) + 1] = dt4 * (
        -c1(vt, npx - 2) + 3.0 * (c1(vt, npx - 1) + c1(vt, npx))
        - c1(vt, npx + 1))
    rowv = dt5 * (_cl(vt) + _cr(vt))
    vb[..., f(1), :] = rowv[..., f(1), :]
    vb[..., f(npx), :] = rowv[..., f(npx), :]

    ke = vb * ytp_v(vb, v, dy, rdy, hord_mt, lim_fac)

    ub = dt5 * (_rl(uc) + _rr(uc) - (_cl(vc) + _cr(vc)) * cosa) * rsina

    def r1(a, j):
        return a[..., f(j):f(j) + 1, mid]

    ub[..., f(1):f(1) + 1, mid] = dt4 * (
        -r1(ut, -1) + 3.0 * (r1(ut, 0) + r1(ut, 1)) - r1(ut, 2))
    ub[..., f(npx):f(npx) + 1, mid] = dt4 * (
        -r1(ut, npx - 2) + 3.0 * (r1(ut, npx - 1) + r1(ut, npx))
        - r1(ut, npx + 1))
    colv = dt5 * (_rl(ut) + _rr(ut))
    ub[..., :, f(1)] = colv[..., :, f(1)]
    ub[..., :, f(npx)] = colv[..., :, f(npx)]

    ke = 0.5 * (ke + ub * xtp_u(ub, u, dx, rdx, hord_mt, lim_fac))

    # corner KE fixes (sw_core.F90:1203-1228)
    dt6 = dt / 6.0

    def p(a, j, i):
        return a[..., f(j), f(i)]

    k11 = dt6 * (
        (p(ut, 1, 1) + p(ut, 0, 1)) * p(u, 1, 1)
        + (p(vt, 1, 1) + p(vt, 1, 0)) * p(v, 1, 1)
        + (p(ut, 1, 1) + p(vt, 1, 1)) * p(u, 1, 0))
    k1n = dt6 * (
        (p(ut, 1, npx) + p(ut, 0, npx)) * p(u, 1, npx - 1)
        + (p(vt, 1, npx) + p(vt, 1, npx - 1)) * p(v, 1, npx)
        + (p(ut, 1, npx) - p(vt, 1, npx - 1)) * p(u, 1, npx))
    knn = dt6 * (
        (p(ut, npx, npx) + p(ut, npx - 1, npx)) * p(u, npx, npx - 1)
        + (p(vt, npx, npx) + p(vt, npx, npx - 1)) * p(v, npx - 1, npx)
        + (p(ut, npx - 1, npx) + p(vt, npx, npx - 1)) * p(u, npx, npx))
    kn1 = dt6 * (
        (p(ut, npx, 1) + p(ut, npx - 1, 1)) * p(u, npx, 1)
        + (p(vt, npx, 1) + p(vt, npx, 0)) * p(v, npx - 1, 1)
        + (p(ut, npx - 1, 1) - p(vt, npx, 1)) * p(u, npx, 0))
    ke[..., f(1), f(1)] = k11
    ke[..., f(1), f(npx)] = k1n
    ke[..., f(npx), f(npx)] = knn
    ke[..., f(npx), f(1)] = kn1
    return ke


def d_sw(delp, pt, w, u, v, uc, vc, ua, va, divg_d, g, *,
         dt, hord_mt, hord_vt, hord_dp, hord_tm, nord, nord_v,
         dddmp, d2_bg, d4_bg, damp_v, d_con=0.0, ke_bg=0.0,
         damp_w=0.0, nord_w=0, hydrostatic=True, sw_mode=False,
         advection_only=False, lim_fac=1.0,
         nord_mask=None, damp_v2=None, nord_v2=0,
         damp_w2=None, nord_w2=0, stage="all", pre=None, inner=None):
    """All inputs padded. Returns SimpleNamespace of interior (compute-domain)
    updated fields + fluxes: u [*, n+1, n], v [*, n, n+1], delp/pt/w
    [*, n, n], fx/crx/xfx..., heat_source, divg_d (corner padded), ke.

    Damping parameters (d2_bg/damp_v/d_con/damp_w) take scalars or per-level
    [K] numpy profiles (the merged sponge groups of dyn_core.F90:675-733).
    nord_mask, a [K] bool profile, selects the levels that use the del-2
    (nord == 0) divergence damping under nord > 0; (damp_v2, nord_v2) and
    (damp_w2, nord_w2) are a second damping combo whose fluxes add.

    stage: "all" | "fluxes" (stop after the delp/pt/w transport, returning
    the fluxes and contravariant winds) | "winds" (skip the transport and
    take its products from `pre`, plus the Smagorinsky operand pre["vortS"]
    when given).

    inner: a namespace (sweep, ke, a2b) of the functions the PPM sweeps, the
    KE stage and the Smagorinsky a2b run through; None takes the kernel
    wrappers (their CUDA kernels on a CUDA tensor). The plain versions of the
    d_sw fluxes and winds kernels pass ops/dsw.py's PLAIN_INNER."""
    _not_cube(g, "d_sw")
    if stage not in ("all", "fluxes", "winds"):
        raise ValueError(f"d_sw: unknown stage {stage!r}")
    npx = g.npx
    n = g.n
    ctr = slice(H, H + n)
    wsl = slice(fi(1), fi(npx) + 1)
    inner = inner or _kernel_wrappers()
    sweep = inner.sweep

    if stage == "winds":
        return _dsw_winds_stage(
            delp, u, v, uc, vc, ua, va, divg_d, g, pre["crx"], pre["cry"],
            pre["xfx"], pre["yfx"], pre["ra_x"], pre["ra_y"], pre["ut"],
            pre["vt"], pre.get("fx"), pre.get("fy"), pre.get("delp_new"),
            pre.get("pt_new"), pre.get("w_new"), pre.get("heat_source"),
            dt=dt, hord_mt=hord_mt, hord_vt=hord_vt, nord=nord,
            nord_v=nord_v, dddmp=dddmp, d2_bg=d2_bg, d4_bg=d4_bg,
            damp_v=damp_v, d_con=d_con, lim_fac=lim_fac,
            nord_mask=nord_mask, damp_v2=damp_v2, nord_v2=nord_v2,
            inner=inner, vortS_pre=pre.get("vortS"))

    # ---- advective C-grid winds -> courant / area fluxes ------------------
    if advection_only:
        xfx = dt * uc / g.sina_u
        crx = xfx * torch.where(xfx > 0.0, _cl(g.rdxa), _cr(g.rdxa))
        xfx = g.dy * xfx * g.sina_u
        yfx = dt * vc / g.sina_v
        cry = yfx * torch.where(yfx > 0.0, _rl(g.rdya), _rr(g.rdya))
        yfx = g.dx * yfx * g.sina_v
        ut = vt = None
    else:
        ut, vt = contravariant_winds(uc, vc, g, dt)
        xfx = dt * ut
        crx = xfx * torch.where(xfx > 0.0, _cl(g.rdxa), _cr(g.rdxa))
        xfx = g.dy * xfx * torch.where(xfx > 0.0, _cl(g.sin_sg3),
                                       _cr(g.sin_sg1))
        yfx = dt * vt
        cry = yfx * torch.where(yfx > 0.0, _rl(g.rdya), _rr(g.rdya))
        yfx = g.dx * yfx * torch.where(yfx > 0.0, _rl(g.sin_sg4),
                                       _rr(g.sin_sg2))

    ra_x = g.area + xfx[..., :, :-1] - xfx[..., :, 1:]
    ra_y = g.area + yfx[..., :-1, :] - yfx[..., 1:, :]

    # ---- transport delp ---------------------------------------------------
    fx, fy = fv_tp_2d(delp, crx, cry, hord_dp, xfx, yfx, g.area, ra_x, ra_y,
                      g.dxa, g.dya, lim_fac=lim_fac,
                      nord=nord_v, damp_c=damp_v, g=g,
                      nord2=nord_v2, damp_c2=damp_v2, sweep=sweep)

    def div_c(fxc, fyc):
        return (fxc[..., :, :-1] - fxc[..., :, 1:]
                + fyc[..., :-1, :] - fyc[..., 1:, :]) * g.rarea[..., ctr, ctr]

    heat_source = None
    w_new = None
    dw = None
    if not hydrostatic:
        if _on(damp_w) or _on(damp_w2):
            dd8 = ke_bg * abs(dt)
            dw = 0.0
            for dwc, nwc in ((damp_w, nord_w), (damp_w2, nord_w2)):
                if not _on(dwc):
                    continue
                damp4 = (_pl(dwc, w) * g.da_min_c) ** (nwc + 1)
                fx2w, fy2w = deln_damp_fluxes(w, nwc, g, prefac=damp4)
                dw = dw + ((fx2w[..., ctr, wsl][..., :, :-1]
                            - fx2w[..., ctr, wsl][..., :, 1:]
                            + fy2w[..., wsl, ctr][..., :-1, :]
                            - fy2w[..., wsl, ctr][..., 1:, :])
                           * g.rarea[..., ctr, ctr])
            heat_source = dd8 - dw * (w[..., ctr, ctr] + 0.5 * dw)
        gx, gy = fv_tp_2d(w, crx, cry, hord_vt, xfx, yfx, g.area, ra_x, ra_y,
                          g.dxa, g.dya, lim_fac=lim_fac, mfx=fx, mfy=fy,
                          sweep=sweep)
        w_new = delp[..., ctr, ctr] * w[..., ctr, ctr] + div_c(gx, gy)

    if not sw_mode:
        gx, gy = fv_tp_2d(pt, crx, cry, hord_tm, xfx, yfx, g.area, ra_x, ra_y,
                          g.dxa, g.dya, lim_fac=lim_fac, mfx=fx, mfy=fy,
                          nord=nord_v, damp_c=damp_v, g=g, mass=delp,
                          nord2=nord_v2, damp_c2=damp_v2, sweep=sweep)

    delp_int = delp[..., ctr, ctr]
    delp_new = delp_int + div_c(fx, fy)
    if not sw_mode:
        pt_new = (pt[..., ctr, ctr] * delp_int + div_c(gx, gy)) / delp_new
    else:
        pt_new = pt[..., ctr, ctr]
    if not hydrostatic:
        w_new = w_new / delp_new
        if dw is not None:
            w_new = w_new + dw

    if advection_only:
        return SimpleNamespace(
            u=None if u is None else u[..., wsl, ctr],
            v=None if v is None else v[..., ctr, wsl],
            delp=delp_new, pt=pt_new, w=w_new,
            fx=fx, fy=fy, crx=crx, cry=cry, xfx=xfx, yfx=yfx,
            ra_x=ra_x, ra_y=ra_y, divg_d=divg_d, heat_source=heat_source)

    if stage == "fluxes":
        return SimpleNamespace(
            delp=delp_new, pt=pt_new, w=w_new, fx=fx, fy=fy,
            crx=crx, cry=cry, xfx=xfx, yfx=yfx, ra_x=ra_x, ra_y=ra_y,
            ut=ut, vt=vt, heat_source=heat_source)

    return _dsw_winds_stage(
        delp, u, v, uc, vc, ua, va, divg_d, g, crx, cry, xfx, yfx,
        ra_x, ra_y, ut, vt, fx, fy, delp_new, pt_new, w_new, heat_source,
        dt=dt, hord_mt=hord_mt, hord_vt=hord_vt, nord=nord, nord_v=nord_v,
        dddmp=dddmp, d2_bg=d2_bg, d4_bg=d4_bg, damp_v=damp_v, d_con=d_con,
        lim_fac=lim_fac, nord_mask=nord_mask, damp_v2=damp_v2,
        nord_v2=nord_v2, inner=inner)


def _kernel_wrappers():
    """The kernel wrappers of the sweep, KE stage and a2b: their CUDA kernels
    on a CUDA tensor, their plain versions on a CPU tensor."""
    from . import tp_sweep
    from .ke import ke_section as ke_k       # ke.py imports this module
    return SimpleNamespace(sweep=tp_sweep.tp2d_sweep, ke=ke_k, a2b=a2b_ord4)


def contravariant_winds(uc, vc, g, dt):
    """d_sw's contravariant C-grid winds ut [.., NC, NW], vt [.., NW, NC]
    with the cube-edge forms and the corner solve (sw_core.F90:695-860)."""
    npx = g.npx
    f = fi
    vsum = (_cl(vc)[..., :-1, :] + _cr(vc)[..., :-1, :]
            + _cl(vc)[..., 1:, :] + _cr(vc)[..., 1:, :])
    ut = (uc - 0.25 * g.cosa_u * vsum) * g.rsin_u
    usum = (_rl(uc)[..., :, :-1] + _rl(uc)[..., :, 1:]
            + _rr(uc)[..., :, :-1] + _rr(uc)[..., :, 1:])
    vt = (vc - 0.25 * g.cosa_v * usum) * g.rsin_v

    # --- west/east edges (sw_core.F90:700-760) ---
    def ut_edge_col(iw):
        cw = uc[..., :, f(iw)]
        return torch.where(cw * dt > 0.0, cw / g.sin_sg3[..., :, f(iw - 1)],
                           cw / g.sin_sg1[..., :, f(iw)])

    ut[..., :, f(1)] = ut_edge_col(1)
    ut[..., :, f(npx)] = ut_edge_col(npx)

    jmid = slice(f(3), f(npx - 2) + 1)
    rA = slice(f(2), f(npx - 3) + 1)
    rB = slice(f(3), f(npx - 2) + 1)

    def vt_edge_cols(c0):
        cc = slice(f(c0), f(c0) + 2)
        c2 = slice(f(c0) + 1, f(c0) + 3)
        return (vc[..., jmid, cc] - 0.25 * g.cosa_v[..., jmid, cc]
                * (ut[..., rA, cc] + ut[..., rA, c2]
                   + ut[..., rB, cc] + ut[..., rB, c2]))

    def vt_edge_row(jw):
        rw = vc[..., f(jw), :]
        return torch.where(rw * dt > 0.0, rw / g.sin_sg4[..., f(jw - 1), :],
                           rw / g.sin_sg2[..., f(jw), :])

    vt[..., jmid, f(0):f(0) + 2] = vt_edge_cols(0)
    vt[..., jmid, f(npx - 1):f(npx - 1) + 2] = vt_edge_cols(npx - 1)
    vt[..., f(1), :] = vt_edge_row(1)
    vt[..., f(npx), :] = vt_edge_row(npx)

    imid = slice(f(3), f(npx - 2) + 1)
    cA = slice(f(2), f(npx - 3) + 1)
    cB = slice(f(3), f(npx - 2) + 1)

    def ut_edge_row(jc):
        r, rp = f(jc), f(jc + 1)
        return (uc[..., r, imid] - 0.25 * g.cosa_u[..., r, imid]
                * (vt[..., r, cA] + vt[..., r, cB]
                   + vt[..., rp, cA] + vt[..., rp, cB]))

    for jc in (0, 1, npx - 1, npx):
        ut[..., f(jc), imid] = ut_edge_row(jc)
    return _dsw_corner_solve(ut, vt, uc, vc, g, npx)


def _dsw_winds_stage(delp, u, v, uc, vc, ua, va, divg_d, g, crx, cry,
                     xfx, yfx, ra_x, ra_y, ut, vt, fx, fy, delp_new,
                     pt_new, w_new, heat_source, *, dt, hord_mt, hord_vt,
                     nord, nord_v, dddmp, d2_bg, d4_bg, damp_v, d_con,
                     lim_fac, nord_mask, damp_v2, nord_v2, inner,
                     vortS_pre=None):
    """d_sw's KE / vorticity / damping / wind-update half (sw_core.F90:
    1063-1529); the KE stage, the vorticity sweep and the Smagorinsky a2b
    run through inner (d_sw's)."""
    npx = g.npx
    n = g.n
    f = fi
    ctr = slice(H, H + n)
    wsl = slice(f(1), f(npx) + 1)
    d2_bg_b = _pl(d2_bg, delp)
    d_con_b = _pl(d_con, delp)

    # ---- kinetic energy (sw_core.F90:1063-1225) ---------------------------
    ke = inner.ke(u, v, uc, vc, ut, vt, g.cosa, g.rsina, g.dx, g.rdx,
                  g.dy, g.rdy, dt, hord_mt, lim_fac, npx)

    # ---- relative vorticity (cell mean) -----------------------------------
    vt_w = u * g.dx
    ut_w = v * g.dy
    wk = g.rarea * (vt_w[..., :-1, :] - vt_w[..., 1:, :]
                    - ut_w[..., :, :-1] + ut_w[..., :, 1:])

    # ---- divergence damping ----------------------------------------------
    # need0: levels on the del-2 branch exist (nord == 0 everywhere, or a
    # sponge nord_mask under nord > 0); needN: the del-2^nord branch
    need0 = nord == 0 or (nord_mask is not None and bool(np.any(nord_mask)))
    needN = nord > 0
    vortB0 = vortBN = None
    if need0:
        ptc_d = (u - 0.5 * (_rl(va) + _rr(va)) * g.cosa_v) * g.dyc * g.sina_v
        for jw in (1, npx):
            r = f(jw)
            ptc_d[..., r, :] = torch.where(
                vc[..., r, :] > 0.0,
                u[..., r, :] * g.dyc[..., r, :] * g.sin_sg4[..., f(jw - 1), :],
                u[..., r, :] * g.dyc[..., r, :] * g.sin_sg2[..., r, :])
        vort_d = (v - 0.5 * (_cl(ua) + _cr(ua)) * g.cosa_u) * g.dxc * g.sina_u
        for iw in (1, npx):
            cI = f(iw)
            vort_d[..., :, cI] = torch.where(
                uc[..., :, cI] > 0.0,
                v[..., :, cI] * g.dxc[..., :, cI]
                * g.sin_sg3[..., :, f(iw - 1)],
                v[..., :, cI] * g.dxc[..., :, cI] * g.sin_sg1[..., :, cI])
        delpc_d = _rl(vort_d) - _rr(vort_d) + _cl(ptc_d) - _cr(ptc_d)
        delpc_d[..., f(1), f(1)] -= vort_d[..., f(0), f(1)]
        delpc_d[..., f(1), f(npx)] -= vort_d[..., f(0), f(npx)]
        delpc_d[..., f(npx), f(1)] += vort_d[..., f(npx), f(1)]
        delpc_d[..., f(npx), f(npx)] += vort_d[..., f(npx), f(npx)]
        delpc_d = delpc_d * g.rarea_c
        damp = g.da_min_c * torch.maximum(
            _as(d2_bg_b, delp),
            torch.clamp_max(dddmp * torch.abs(delpc_d * dt), 0.20))
        vortB0 = damp * delpc_d
    if needN:
        delpc_d = divg_d
        dd = divg_d
        for nn in range(1, nord + 1):
            nt = nord - nn
            if nt != 0:
                dd = fill_corners_bgrid(dd, 1, npx)
            vc_g = (dd[..., :, 1:] - dd[..., :, :-1]) * g.divg_u
            if nt != 0:
                dd = fill_corners_bgrid(dd, 2, npx)
            uc_g = (dd[..., 1:, :] - dd[..., :-1, :]) * g.divg_v
            if nt != 0:
                vc_g, uc_g = fill_corners_dgrid_vector(vc_g, uc_g, npx,
                                                       sign=-1.0)
            dd = _rl(uc_g) - _rr(uc_g) + _cl(vc_g) - _cr(vc_g)
            dd[..., f(1), f(1)] -= uc_g[..., f(0), f(1)]
            dd[..., f(1), f(npx)] -= uc_g[..., f(0), f(npx)]
            dd[..., f(npx), f(1)] += uc_g[..., f(npx), f(1)]
            dd[..., f(npx), f(npx)] += uc_g[..., f(npx), f(npx)]
            dd = dd * g.rarea_c
        if dddmp < 1.0e-5:
            vortS = torch.zeros_like(dd)
        else:
            if vortS_pre is None:
                vortS_pre = inner.a2b(wk, g)
            vortS = abs(dt) * torch.sqrt(delpc_d ** 2 + vortS_pre ** 2)
        dd8 = (g.da_min_c * d4_bg) ** (nord + 1)
        damp2 = g.da_min_c * torch.maximum(
            _as(d2_bg_b, delp), torch.clamp_max(dddmp * vortS, 0.20))
        vortBN = damp2 * delpc_d + dd8 * dd

    if vortB0 is not None and vortBN is not None:
        # blended per-level branch select (merged sponge groups)
        m0 = torch.as_tensor(np.asarray(nord_mask, np.float64),
                             dtype=delp.dtype,
                             device=delp.device).reshape(-1, 1, 1)
        vortB = m0 * vortB0 + (1.0 - m0) * vortBN
        divg_out = dd
    elif vortBN is not None:
        vortB = vortBN
        divg_out = dd
    else:
        vortB = vortB0
        divg_out = divg_d
    ke = ke + vortB

    do_heat = _on(d_con)
    if do_heat:
        ub_h = vortB[..., :, :-1] - vortB[..., :, 1:]
        vb_h = vortB[..., :-1, :] - vortB[..., 1:, :]

    # ---- vorticity transport & wind update -------------------------------
    vort_abs = wk + g.f0
    fxv, fyv = fv_tp_2d(vort_abs, crx, cry, hord_vt, xfx, yfx, g.area,
                        ra_x, ra_y, g.dxa, g.dya, lim_fac=lim_fac,
                        sweep=inner.sweep)

    u_full = vt_w + (ke[..., :, :-1] - ke[..., :, 1:])
    v_full = ut_w + (ke[..., :-1, :] - ke[..., 1:, :])
    u_new = u_full[..., wsl, ctr] + fyv
    v_new = v_full[..., ctr, wsl] - fxv

    # ---- vorticity damping (sw_core.F90:1513-1529) ------------------------
    fx2d = fy2d = None
    for dvc, nvc in ((damp_v, nord_v), (damp_v2, nord_v2)):
        if not _on(dvc):
            continue
        damp4 = (_pl(dvc, wk) * g.da_min_c) ** (nvc + 1)
        a_, b_ = deln_damp_fluxes(wk, nvc, g, prefac=damp4)
        fx2d = a_ if fx2d is None else fx2d + a_
        fy2d = b_ if fy2d is None else fy2d + b_

    if do_heat:
        rdx_c = g.rdx[..., wsl, ctr]
        rdy_c = g.rdy[..., ctr, wsl]
        ub2 = (ub_h[..., wsl, ctr]
               + (fy2d[..., wsl, ctr] if fy2d is not None else 0.0)) * rdx_c
        fy_d = u_new * rdx_c
        gy = fy_d * ub2
        vb2 = (vb_h[..., ctr, wsl]
               - (fx2d[..., ctr, wsl] if fx2d is not None else 0.0)) * rdy_c
        fx_d = v_new * rdy_c
        gx = fx_d * vb2
        u2 = fy_d[..., :-1, :] + fy_d[..., 1:, :]
        du2 = ub2[..., :-1, :] + ub2[..., 1:, :]
        v2 = fx_d[..., :, :-1] + fx_d[..., :, 1:]
        dv2 = vb2[..., :, :-1] + vb2[..., :, 1:]
        rs2 = g.rsin2[..., ctr, ctr]
        cs_ = g.cosa_s[..., ctr, ctr]
        tmp = rs2 * ((ub2[..., :-1, :] ** 2 + ub2[..., 1:, :] ** 2
                      + vb2[..., :, :-1] ** 2 + vb2[..., :, 1:] ** 2)
                     + 2.0 * (gy[..., :-1, :] + gy[..., 1:, :]
                              + gx[..., :, :-1] + gx[..., :, 1:])
                     - cs_ * (u2 * dv2 + v2 * du2 + du2 * dv2))
        hs0 = heat_source if heat_source is not None else 0.0
        heat_source = delp[..., ctr, ctr] * (hs0 - 0.25 * d_con_b * tmp)

    if fx2d is not None:
        u_new = u_new + fy2d[..., wsl, ctr]
        v_new = v_new - fx2d[..., ctr, wsl]

    return SimpleNamespace(
        u=u_new, v=v_new, delp=delp_new, pt=pt_new, w=w_new,
        fx=fx, fy=fy, crx=crx, cry=cry, xfx=xfx, yfx=yfx,
        ra_x=ra_x, ra_y=ra_y, divg_d=divg_out, ke=ke,
        heat_source=heat_source)


def _dsw_corner_solve(ut, vt, uc, vc, g, npx):
    """2x2 corner systems for parallel-to-edge uc/vc (sw_core.F90:763-860),
    applied point by point in the reference order on copies of ut, vt."""
    f = fi
    npy = npx
    ut = ut.clone()
    vt = vt.clone()

    def U(i, j):
        return ut[..., f(j), f(i)]

    def V(i, j):
        return vt[..., f(j), f(i)]

    def setU(i, j, val):
        ut[..., f(j), f(i)] = val

    def setV(i, j, val):
        vt[..., f(j), f(i)] = val

    def UC(i, j):
        return uc[..., f(j), f(i)]

    def VC(i, j):
        return vc[..., f(j), f(i)]

    def CU(i, j):
        return g.cosa_u[..., f(j), f(i)]

    def CV(i, j):
        return g.cosa_v[..., f(j), f(i)]

    # SW corner
    damp = 1.0 / (1.0 - 0.0625 * CU(2, 0) * CV(1, 0))
    setU(2, 0,
         (UC(2, 0) - 0.25 * CU(2, 0) * (V(1, 1) + V(2, 1) + V(2, 0) + VC(1, 0)
          - 0.25 * CV(1, 0) * (U(1, 0) + U(1, -1) + U(2, -1)))) * damp)
    damp = 1.0 / (1.0 - 0.0625 * CU(0, 1) * CV(0, 2))
    setV(0, 2,
         (VC(0, 2) - 0.25 * CV(0, 2) * (U(1, 1) + U(1, 2) + U(0, 2) + UC(0, 1)
          - 0.25 * CU(0, 1) * (V(0, 1) + V(-1, 1) + V(-1, 2)))) * damp)
    damp = 1.0 / (1.0 - 0.0625 * CU(2, 1) * CV(1, 2))
    setU(2, 1,
         (UC(2, 1) - 0.25 * CU(2, 1) * (V(1, 1) + V(2, 1) + V(2, 2) + VC(1, 2)
          - 0.25 * CV(1, 2) * (U(1, 1) + U(1, 2) + U(2, 2)))) * damp)
    setV(1, 2,
         (VC(1, 2) - 0.25 * CV(1, 2) * (U(1, 1) + U(1, 2) + U(2, 2) + UC(2, 1)
          - 0.25 * CU(2, 1) * (V(1, 1) + V(2, 1) + V(2, 2)))) * damp)

    # SE corner
    damp = 1.0 / (1.0 - 0.0625 * CU(npx - 1, 0) * CV(npx - 1, 0))
    setU(npx - 1, 0,
         (UC(npx - 1, 0) - 0.25 * CU(npx - 1, 0) * (
             V(npx - 1, 1) + V(npx - 2, 1) + V(npx - 2, 0) + VC(npx - 1, 0)
             - 0.25 * CV(npx - 1, 0) * (U(npx, 0) + U(npx, -1)
                                        + U(npx - 1, -1)))) * damp)
    damp = 1.0 / (1.0 - 0.0625 * CU(npx + 1, 1) * CV(npx, 2))
    setV(npx, 2,
         (VC(npx, 2) - 0.25 * CV(npx, 2) * (
             U(npx, 1) + U(npx, 2) + U(npx + 1, 2) + UC(npx + 1, 1)
             - 0.25 * CU(npx + 1, 1) * (V(npx, 1) + V(npx + 1, 1)
                                        + V(npx + 1, 2)))) * damp)
    damp = 1.0 / (1.0 - 0.0625 * CU(npx - 1, 1) * CV(npx - 1, 2))
    setU(npx - 1, 1,
         (UC(npx - 1, 1) - 0.25 * CU(npx - 1, 1) * (
             V(npx - 1, 1) + V(npx - 2, 1) + V(npx - 2, 2) + VC(npx - 1, 2)
             - 0.25 * CV(npx - 1, 2) * (U(npx, 1) + U(npx, 2)
                                        + U(npx - 1, 2)))) * damp)
    setV(npx - 1, 2,
         (VC(npx - 1, 2) - 0.25 * CV(npx - 1, 2) * (
             U(npx, 1) + U(npx, 2) + U(npx - 1, 2) + UC(npx - 1, 1)
             - 0.25 * CU(npx - 1, 1) * (V(npx - 1, 1) + V(npx - 2, 1)
                                        + V(npx - 2, 2)))) * damp)

    # NE corner
    damp = 1.0 / (1.0 - 0.0625 * CU(npx - 1, npy) * CV(npx - 1, npy + 1))
    setU(npx - 1, npy,
         (UC(npx - 1, npy) - 0.25 * CU(npx - 1, npy) * (
             V(npx - 1, npy) + V(npx - 2, npy) + V(npx - 2, npy + 1)
             + VC(npx - 1, npy + 1)
             - 0.25 * CV(npx - 1, npy + 1) * (
                 U(npx, npy) + U(npx, npy + 1) + U(npx - 1, npy + 1))))
         * damp)
    damp = 1.0 / (1.0 - 0.0625 * CU(npx + 1, npy - 1) * CV(npx, npy - 1))
    setV(npx, npy - 1,
         (VC(npx, npy - 1) - 0.25 * CV(npx, npy - 1) * (
             U(npx, npy - 1) + U(npx, npy - 2) + U(npx + 1, npy - 2)
             + UC(npx + 1, npy - 1)
             - 0.25 * CU(npx + 1, npy - 1) * (
                 V(npx, npy) + V(npx + 1, npy) + V(npx + 1, npy - 1))))
         * damp)
    damp = 1.0 / (1.0 - 0.0625 * CU(npx - 1, npy - 1) * CV(npx - 1, npy - 1))
    setU(npx - 1, npy - 1,
         (UC(npx - 1, npy - 1) - 0.25 * CU(npx - 1, npy - 1) * (
             V(npx - 1, npy) + V(npx - 2, npy) + V(npx - 2, npy - 1)
             + VC(npx - 1, npy - 1)
             - 0.25 * CV(npx - 1, npy - 1) * (
                 U(npx, npy - 1) + U(npx, npy - 2) + U(npx - 1, npy - 2))))
         * damp)
    setV(npx - 1, npy - 1,
         (VC(npx - 1, npy - 1) - 0.25 * CV(npx - 1, npy - 1) * (
             U(npx, npy - 1) + U(npx, npy - 2) + U(npx - 1, npy - 2)
             + UC(npx - 1, npy - 1)
             - 0.25 * CU(npx - 1, npy - 1) * (
                 V(npx - 1, npy) + V(npx - 2, npy) + V(npx - 2, npy - 1))))
         * damp)

    # NW corner
    damp = 1.0 / (1.0 - 0.0625 * CU(2, npy) * CV(1, npy + 1))
    setU(2, npy,
         (UC(2, npy) - 0.25 * CU(2, npy) * (
             V(1, npy) + V(2, npy) + V(2, npy + 1) + VC(1, npy + 1)
             - 0.25 * CV(1, npy + 1) * (U(1, npy) + U(1, npy + 1)
                                        + U(2, npy + 1)))) * damp)
    damp = 1.0 / (1.0 - 0.0625 * CU(0, npy - 1) * CV(0, npy - 1))
    setV(0, npy - 1,
         (VC(0, npy - 1) - 0.25 * CV(0, npy - 1) * (
             U(1, npy - 1) + U(1, npy - 2) + U(0, npy - 2) + UC(0, npy - 1)
             - 0.25 * CU(0, npy - 1) * (V(0, npy) + V(-1, npy)
                                        + V(-1, npy - 1)))) * damp)
    damp = 1.0 / (1.0 - 0.0625 * CU(2, npy - 1) * CV(1, npy - 1))
    setU(2, npy - 1,
         (UC(2, npy - 1) - 0.25 * CU(2, npy - 1) * (
             V(1, npy) + V(2, npy) + V(2, npy - 1) + VC(1, npy - 1)
             - 0.25 * CV(1, npy - 1) * (U(1, npy - 1) + U(1, npy - 2)
                                        + U(2, npy - 2)))) * damp)
    setV(1, npy - 1,
         (VC(1, npy - 1) - 0.25 * CV(1, npy - 1) * (
             U(1, npy - 1) + U(1, npy - 2) + U(2, npy - 2) + UC(2, npy - 1)
             - 0.25 * CU(2, npy - 1) * (V(1, npy) + V(2, npy)
                                        + V(2, npy - 1)))) * damp)
    return ut, vt


# ===========================================================================
# del2_cubed (dyn_core.F90:2356): Laplacian filter
# ===========================================================================

def del2_cubed(q, cd, g, nmax):
    """q: [..., P, P] padded cells (halo-exchanged). cd = K*da_min."""
    npx = g.npx
    f = fi
    ie = npx - 1
    q = q.clone()
    for _ in range(min(3, nmax)):
        # 3-cell corner averaging
        for (a, b, c) in (((1, 1), (1, 0), (0, 1)),
                          ((1, ie), (1, npx), (0, ie)),
                          ((ie, ie), (ie, npx), (npx, ie)),
                          ((ie, 1), (ie, 0), (npx, 1))):
            qc = (q[..., f(a[0]), f(a[1])] + q[..., f(b[0]), f(b[1])]
                  + q[..., f(c[0]), f(c[1])]) * R3
            for (j, i) in (a, b, c):
                q[..., f(j), f(i)] = qc
        qx = copy_corners(q, H, 1)
        fx = F.pad(g.del6_v[..., :, 1:-1] * (qx[..., :, :-1] - qx[..., :, 1:]),
                   (1, 1))
        qy = copy_corners(q, H, 2)
        fyp = F.pad(g.del6_u[..., 1:-1, :] * (qy[..., :-1, :] - qy[..., 1:, :]),
                    (0, 0, 1, 1))
        q = q + cd * g.rarea * (fx[..., :, :-1] - fx[..., :, 1:]
                                + fyp[..., :-1, :] - fyp[..., 1:, :])
    return q
