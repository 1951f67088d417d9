"""Nonhydrostatic vertical solvers and height advection, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/ops/nh_core.py (FV3
model/nh_utils.F90 update_dz_c:59, update_dz_d:204, Riem_Solver_C:323,
Riem_Solver3, SIM1_solver:1277, SIM_solver:1396, SIM3_solver:984,
SIM3p0_solver:1134, RIM_2D:751, imp_diff_w:688): every Riemann solver the
JAX package dispatches on a_imp, with use_logp and d2bg_zq.

All column solves are batched over (tile, y, x); the sweeps along k are
Python loops over levels. On the card SIM1 and the off-centred SIM run in
the sim1 kernel (ops/sim1.py), dispatched where the JAX package dispatches
its Pallas kernel or the off-centred solver; SIM3 and RIM_2D have no TPU
kernel and run as plain PyTorch, as in the JAX package.

Adiabatic (use_cond=False, moist_kappa=False) path; cp2 == akap.
"""

from functools import lru_cache
from types import SimpleNamespace

import numpy as np
import torch

from .. import constants as con
from .fill_corners import fill_4corners_cell
from .tp_core import fv_tp_2d, deln_damp_fluxes

H = 3
DZ_MIN = 2.0          # nh_utils.F90 dz_min (module parameter, = 2 m)
R3 = 1.0 / 3.0
# column-table elements per chunk of rim_2d_solver's [columns, K+1, K]
# characteristic weights
_RIM_CHUNK_ELEMS = 1 << 26


def sim1_solver(dt, dm2, pm2, pem, w2, dz2, pt2, ws, gama, akap, p_fac,
                alpha=1.0):
    """Semi-implicit Riemann / vertical sound-wave solver. The plain version
    of the sim1 kernel.

    alpha = 1 is the fully implicit SIM1_solver (nh_utils.F90:1277); 0.5 <
    alpha < 1 the off-centred SIM_solver (:1396): the pressure force is
    alpha x new + beta x old with beta = 1 - alpha, which adds the explicit
    shear terms wk, the bottom blend, the pressure recovery and the final
    blend of pe2 toward the implicit pp. The extra terms are gated on
    beta != 0, as in the JAX package, so alpha = 1 computes exactly what
    SIM1 computes.

    Fields [.., K, y, x] (interfaces [.., K+1, y, x]); ws [.., y, x].
    dm2 = delp/grav; pm2 log-mean layer pressure; pem hydrostatic interface
    pressure; pt2 virtual temperature. Returns (pe2 [.., K+1, y, x] nonhydro
    pressure perturbation at interfaces, w2, dz2)."""
    rgas = con.RDGAS
    beta = 1.0 - alpha
    off = beta != 0.0
    ra = 1.0 / alpha
    t2 = beta / alpha
    t1g = 2.0 * (alpha * dt) ** 2 if off else 2.0 * dt * dt
    rdt = 1.0 / dt
    capa1 = akap - 1.0
    gm2 = gama
    K = dm2.shape[-3]
    dm = dm2.unbind(-3)
    pm = pm2.unbind(-3)
    pe_m = pem.unbind(-3)
    w1 = w2.unbind(-3)
    dz = dz2.unbind(-3)
    pt = pt2.unbind(-3)

    # cell-mean nonhydro pressure perturbation from the gas law
    pe = [torch.exp(gm2 * torch.log(-dm[k] / dz[k] * rgas * pt[k])) - pm[k]
          for k in range(K)]
    g_rat = [dm[k] / dm[k + 1] for k in range(K - 1)]
    bb = [2.0 * (1.0 + g_rat[k]) for k in range(K - 1)] + [
        2.0 * torch.ones_like(dm[0])]
    dd = [3.0 * (pe[k] + g_rat[k] * pe[k + 1]) for k in range(K - 1)] + [
        3.0 * pe[K - 1]]

    # ---- tridiagonal for the interface pressure perturbation pp ---------
    bet = bb[0]
    pp = [torch.zeros_like(dd[0]), dd[0] / bet]
    gam = [None] * K
    for k in range(1, K):
        gam[k] = g_rat[k - 1] / bet
        bet = bb[k] - gam[k]
        pp.append((dd[k] - pp[k]) / bet)
    for k in range(K - 1, 0, -1):
        pp[k] = pp[k] - gam[k] * pp[k + 1]

    # ---- implicit w solve -----------------------------------------------
    aa = [None] + [(t1g * 0.5 * (gm2 + gm2) / (dz[k - 1] + dz[k]))
                   * pe_m[k] for k in range(1, K)]
    # the off-centred explicit shear wk(k) = t2 aa(k) (w1(k-1) - w1(k)) at
    # the interior interfaces (SIM_solver:1464-1468)
    wk = ([None] + [t2 * aa[k] * (w1[k - 1] - w1[k]) for k in range(1, K)]
          if off else None)
    bet = dm[0] - aa[1]
    w = [None] * K
    if off:
        w[0] = (dm[0] * w1[0] + dt * pp[1] + wk[1]) / bet
    else:
        w[0] = (dm[0] * w1[0] + dt * pp[1]) / bet
    gw = [None] * K
    for k in range(1, K - 1):
        gw[k] = aa[k] / bet
        bet = dm[k] - (aa[k] + aa[k + 1] + aa[k] * gw[k])
        if off:
            w[k] = (dm[k] * w1[k] + dt * (pp[k + 1] - pp[k])
                    + (wk[k + 1] - wk[k]) - aa[k] * w[k - 1]) / bet
        else:
            w[k] = (dm[k] * w1[k] + dt * (pp[k + 1] - pp[k])
                    - aa[k] * w[k - 1]) / bet
    p1 = t1g * gm2 / dz[K - 1] * pe_m[K]
    gw[K - 1] = aa[K - 1] / bet
    betK = dm[K - 1] - (aa[K - 1] + p1 + aa[K - 1] * gw[K - 1])
    if off:
        # bottom: the SIM1 forcing with the t2 w1 blend, less wk(km)
        # (SIM_solver:1487-1492)
        w[K - 1] = (dm[K - 1] * w1[K - 1] + dt * (pp[K] - pp[K - 1])
                    + (p1 * (t2 * w1[K - 1] - ra * ws) - wk[K - 1])
                    - aa[K - 1] * w[K - 2]) / betK
    else:
        w[K - 1] = (dm[K - 1] * w1[K - 1] + dt * (pp[K] - pp[K - 1])
                    - p1 * ws - aa[K - 1] * w[K - 2]) / betK
    for k in range(K - 2, -1, -1):
        w[k] = w[k] - gw[k + 1] * w[k + 1]

    # ---- new nonhydro pressure + dz -------------------------------------
    pe_new = [torch.zeros_like(dm[0])]
    for k in range(K):
        if off:
            # off-centred pressure recovery (SIM_solver:1511-1516)
            dpe = dm[k] * (w[k] - w1[k]) * rdt
            pe_new.append(pe_new[k]
                          + (dpe - beta * (pp[k + 1] - pp[k])) * ra)
        else:
            pe_new.append(pe_new[k] + dm[k] * (w[k] - w1[k]) * rdt)
    dz_new = [None] * K
    p1 = (pe_new[K - 1] + 2.0 * pe_new[K]) * R3
    dz_new[K - 1] = -dm[K - 1] * rgas * pt[K - 1] * torch.exp(
        capa1 * torch.log(torch.maximum(p_fac * pm[K - 1], p1 + pm[K - 1])))
    for k in range(K - 2, -1, -1):
        p1 = (pe_new[k] + bb[k] * pe_new[k + 1] + g_rat[k] * pe_new[k + 2]) \
            * R3 - g_rat[k] * p1
        dz_new[k] = -dm[k] * rgas * pt[k] * torch.exp(
            capa1 * torch.log(torch.maximum(p_fac * pm[k], p1 + pm[k])))
    if off:
        # blend toward the implicit interface pressure (SIM_solver:1533-1535)
        pe_new = [pe_new[k] + beta * (pp[k] - pe_new[k])
                  for k in range(K + 1)]
    return (torch.stack(pe_new, -3), torch.stack(w, -3),
            torch.stack(dz_new, -3))


def rim_2d_solver(ms, bdt, dm2, pm2, w2, dz2, pt2, ws, gama, akap,
                  c_core=False):
    """Explicit Riemann-invariant solver (nh_utils.F90 RIM_2D:751),
    dispatched for |a_imp| <= 0.5 (nh_core.F90:175-177): `ms` acoustic
    substeps of dt = bdt/ms; per substep the up- and downward
    characteristics are traced through the column and the invariants
    accumulated over the levels each wave crosses within dt (with the
    surface reflection and its 2 ws source).

    The JAX package's formulation, column by column: the characteristic
    walks become clipped-fraction weight tables W[e, j] =
    clip((budget(e) - transit_before(e, j)) / dts(j), 0, 1) from prefix
    sums of the levels' acoustic transit times dts, contracted against dm
    and the invariants; the `1 < ms < 8` semi-implicit pre-pass for
    acoustically thick top levels keeps its per-column ks0 masks and the
    whole-column (ks0 == km) shortcut. The [columns, K+1, K] tables are
    built for chunks of columns, so their size stays bounded at full width;
    each column's arithmetic is unchanged.

    Shapes as sim1_solver; pm2 is the layer-mean pressure. c_core=True
    (the Riem_Solver_C call, nh_utils.F90:454) leaves w untouched. Returns
    (pe2 interface pressure increment [.., K+1, y, x], w2, dz2)."""
    K = dm2.shape[-3]
    lead = dm2.shape[:-3]
    Y, X = dm2.shape[-2:]

    def cols(a):                     # [.., K, y, x] -> [columns, K]
        return torch.movedim(a, -3, -1).reshape(-1, a.shape[-3])

    flat = [cols(a) for a in (dm2, pm2, w2, dz2, pt2)]
    wsf = ws.reshape(-1)
    chunk = max(1, _RIM_CHUNK_ELEMS // ((K + 1) * K))
    outs = [_rim_2d_columns(ms, bdt, *(a[s0:s0 + chunk] for a in flat),
                            wsf[s0:s0 + chunk], gama)
            for s0 in range(0, wsf.shape[0], chunk)]

    def back(i, n):                  # [columns, n] -> [.., n, y, x]
        a = torch.cat([o[i] for o in outs], 0).reshape(*lead, Y, X, n)
        return torch.movedim(a, -1, -3)

    pe2 = back(0, K + 1)
    w_ret = w2 if c_core else back(1, K)
    return pe2, w_ret, back(2, K)


def _rim_2d_columns(ms, bdt, dm, pm, w0, dz0, pt1, ws, gama):
    """rim_2d_solver on columns [n, K] (ws [n]): (pe2 [n, K+1], w [n, K],
    dz [n, K])."""
    rgas = con.RDGAS
    grg = gama * rgas
    rdt = 1.0 / bdt
    ms = int(ms)
    dt = bdt / ms
    pre_active = 1 < ms < 8
    K = dm.shape[-1]
    dev = dm.device
    wm0 = w0 * dm                                   # momentum
    ws2 = 2.0 * ws
    j_lev = torch.arange(K, device=dev)
    e_int = torch.arange(K + 1, device=dev)
    big = torch.full((), K, dtype=torch.long, device=dev)

    def acoustic(dz):
        rden = -rgas * dm / dz
        pf = torch.exp(gama * torch.log(rden * pt1))
        dts = -dz / torch.sqrt(grg * pf / rden)
        return pf, dts

    def safediv(a, b):
        return a / torch.where(b != 0.0, b, 1.0)

    def first_true(mask):
        # the first level where mask holds, K where it never does
        return torch.where(mask.any(-1), torch.argmax(mask.to(torch.uint8),
                                                      -1), big)

    # ---- pre-pass: semi-implicit thick top levels (RIM_2D:797-856) -------
    pf0, dts0 = acoustic(dz0)
    if pre_active:
        ks0 = torch.clamp_min(first_true(bdt > dts0), 1)
    else:
        ks0 = torch.ones(dm.shape[:-1], dtype=torch.long, device=dev)
    ks1 = ks0

    cm = dm / dts0
    wc = wm0 / dts0
    ppp = pf0 - pm
    wbar_mid_pre = safediv(wc[..., :-1] + wc[..., 1:] + ppp[..., 1:]
                           - ppp[..., :-1], cm[..., :-1] + cm[..., 1:])
    wbar_pre = torch.cat(
        [safediv(wc[..., :1] + ppp[..., :1], cm[..., :1]),
         wbar_mid_pre, ws[..., None]], -1)               # [n, K+1]
    pbar_pre = torch.cat(
        [torch.zeros_like(wbar_pre[..., :1]),
         bdt * (cm * wbar_pre[..., 1:] - wc + ppp)], -1)

    ks1e = ks1[..., None]
    zero = torch.zeros((), dtype=dm.dtype, device=dev)
    if pre_active:
        # partial pre-pass state: levels k <= ks0-1 advanced over bdt
        pre_j = j_lev <= ks1e - 2
        dwb = bdt * (wbar_pre[..., 1:] - wbar_pre[..., :-1])
        dz_pre = torch.where(pre_j, dz0 + dwb, dz0)
        dpb = pbar_pre[..., 1:] - pbar_pre[..., :-1]
        w_pre = torch.where(pre_j, (wm0 + dpb) / dm, wm0 / dm)
        pbar_b = torch.where(
            ks1 > 1,
            torch.gather(pbar_pre, -1, ks1[..., None] - 1)[..., 0] / ms,
            zero)
        pe1 = torch.where((e_int >= 1) & (e_int <= ks1e - 1), pbar_pre,
                          zero)
    else:
        dz_pre, w_pre = dz0, wm0 / dm
        pbar_b = torch.zeros(dm.shape[:-1], dtype=dm.dtype, device=dev)
        pe1 = torch.zeros_like(wbar_pre)

    # ---- ms explicit substeps (RIM_2D:858-975) ---------------------------
    dz, wm = dz_pre, wm0
    e_b = e_int[:, None]
    mm = lambda a, b: torch.einsum("...ej,...j->...e", a, b)
    for _ in range(ms):
        pf, dts = acoustic(dz)
        ptmp1 = dts * (pf - pm)
        r_lo = wm + ptmp1
        r_hi = wm - ptmp1

        ktop = first_true((dt > dts) & (j_lev >= ks1e - 1))
        kt1 = torch.maximum(ks1, ktop)
        ktop_e = ktop[..., None]
        kt1_e = kt1[..., None]

        P = torch.cat([torch.zeros_like(dts[..., :1]),
                       torch.cumsum(dts, -1)], -1)        # [n, K+1]
        PK = P[..., -1:]

        # direct treatment of thick levels (RIM_2D:878-886)
        zf = dt / dts
        dmask = (j_lev >= ks1e - 1) & (j_lev <= ktop_e - 1)
        mb_d = torch.where(dmask, zf * dm, zero)
        rb_d = torch.where(dmask, zf * r_lo, zero)
        rt_d = torch.where(dmask, zf * r_hi, zero)
        zcol = torch.zeros_like(mb_d[..., :1])
        m_bot = torch.cat([mb_d, zcol], -1)
        r_bot = torch.cat([rb_d, zcol], -1)
        m_top = torch.cat([zcol, mb_d], -1)
        r_top = torch.cat([zcol, rt_d], -1)

        dts_j = dts[..., None, :]
        P_e = P[..., :, None]

        # upward characteristics into interface e (RIM_2D:896-911)
        wt = torch.clamp((dt - (P_e - P[..., None, 1:])) / dts_j, 0.0, 1.0)
        wt = torch.where((j_lev >= kt1_e[..., None] - 1) & (j_lev <= e_b - 1)
                         & (e_b >= ktop_e[..., None] + 1), wt, zero)
        m_top = m_top + mm(wt, dm)
        r_top = r_top + mm(wt, r_hi)
        del wt

        # downward and surface-reflected characteristics (RIM_2D:913-945)
        w1 = torch.clamp((dt - (P[..., None, :-1] - P_e)) / dts_j, 0.0, 1.0)
        bot_e = (e_b >= ktop_e[..., None]) & (e_b <= K - 1)
        w1 = torch.where((j_lev >= e_b) & bot_e, w1, zero)
        b = dt - (PK - P)                                 # [n, K+1]
        wr = torch.clamp((b[..., :, None]
                          - (PK[..., None, :] - P[..., None, 1:])) / dts_j,
                         0.0, 1.0)
        wr = torch.where((j_lev >= kt1_e[..., None] - 1) & bot_e, wr, zero)
        seg2_m = mm(wr, dm)
        m_bot = m_bot + mm(w1, dm) + seg2_m
        s2max = PK - torch.gather(P, -1, kt1_e - 1)
        refl = torch.where((b > 0.0) & (b <= s2max), seg2_m * ws2[..., None],
                           zero)
        r_bot = r_bot + mm(w1, r_lo) - mm(wr, r_hi) + refl
        del w1, wr

        # interface velocities and pressure impulses (RIM_2D:947-958)
        wbar_mid = safediv(r_bot + r_top, m_top + m_bot)
        if pre_active:
            outside = wbar_pre
        else:
            outside = torch.cat([safediv(r_bot[..., :1], m_bot[..., :1]),
                                 wbar_pre[..., 1:]], -1)
        wbar = torch.where((e_int >= ks1e) & (e_int <= K - 1), wbar_mid,
                           outside)
        if pre_active:
            wbar = torch.where((e_int == 0) & (ks1e == 1),
                               safediv(r_bot[..., :1], m_bot[..., :1]), wbar)
        wbar = torch.cat([wbar[..., :-1], ws[..., None]], -1)
        pbar = torch.where(e_int >= ks1e, m_top * wbar - r_top,
                           torch.where(e_int == ks1e - 1, pbar_b[..., None],
                                       zero))
        pe1 = pe1 + torch.where(e_int >= ks1e, pbar, zero)

        upd = j_lev >= ks1e - 1
        dz = torch.where(upd, dz + dt * (wbar[..., 1:] - wbar[..., :-1]), dz)
        wm = torch.where(upd, wm + pbar[..., 1:] - pbar[..., :-1], wm)

    low = j_lev >= ks1e - 1
    dz_out = torch.where(low, dz, dz_pre)
    w_out = torch.where(low, wm / dm, w_pre)
    pe2 = torch.where(e_int >= 1, pe1 * rdt, zero)

    if pre_active:
        # whole-column-thick shortcut (RIM_2D:826-843)
        full = (ks0 == K)[..., None]
        dwb = bdt * (wbar_pre[..., 1:] - wbar_pre[..., :-1])
        dpb = pbar_pre[..., 1:] - pbar_pre[..., :-1]
        dz_out = torch.where(full, dz0 + dwb, dz_out)
        w_out = torch.where(full, (wm0 + dpb) / dm, w_out)
        pe2 = torch.where(full & (e_int >= 1), pbar_pre * rdt, pe2)
    return pe2, w_out, dz_out


def sim3_solver(dt, dm2, pem, w2, dz2, pt2, ws, gama, akap, p_fac,
                scale_m=0.0, alpha=1.0):
    """SIM3-family semi-implicit solver (nh_utils.F90 SIM3_solver:984,
    SIM3p0_solver:1134). Unlike SIM1 / SIM, which solve for the
    nonhydrostatic pressure perturbation, this family fits the FULL edge
    pressure by a tridiagonal profile of the gas-law cell pressure with a
    hydrostatic half-layer correction at the bottom (the r2g / r6g terms),
    then solves the implicit w system against it.

    alpha = 1 is SIM3p0 (a_imp < -0.999); 0.5 < alpha < 1 is SIM3 with
    off-centring alpha = |a_imp| (-0.999 <= a_imp < -0.5). scale_m adds the
    vertical-motion damping term -scale_m dm(1) to the off-diagonals.

    Shapes as sim1_solver. Returns (pe2 perturbation at interfaces
    [.., K+1, y, x], w2, dz2)."""
    rgas = con.RDGAS
    beta = 1.0 - alpha
    off = beta != 0.0
    ra = 1.0 / alpha
    t2 = beta / alpha
    t1g = gama * 2.0 * (alpha * dt) ** 2
    rdt = 1.0 / dt
    capa1 = akap - 1.0
    r2g = con.GRAV / 2.0
    r6g = con.GRAV / 6.0
    K = dm2.shape[-3]
    dm = dm2.unbind(-3)
    pe_m = pem.unbind(-3)
    w1 = w2.unbind(-3)
    dz = dz2.unbind(-3)
    pt = pt2.unbind(-3)

    # the full gas-law pressure at the cell centres
    pc = [torch.exp(gama * torch.log(-dm[k] / dz[k] * rgas * pt[k]))
          for k in range(K)]
    g_rat = [dm[k] / dm[k + 1] for k in range(K - 1)]
    bb = [2.0 * (1.0 + g_rat[k]) for k in range(K - 1)] + [
        2.0 * torch.ones_like(dm[0])]
    dd = [3.0 * (pc[k] + g_rat[k] * pc[k + 1]) for k in range(K - 1)] + [
        3.0 * pc[K - 1] + r2g * dm[K - 1]]

    # ---- tridiagonal for the FULL interface pressure: pe(1) = pem(1) ----
    bet = bb[0]
    pei = [(dd[0] - pe_m[0]) / bet]          # pe(2) .. pe(K+1)
    gam = [None] * K
    for k in range(1, K):
        gam[k] = g_rat[k - 1] / bet
        bet = bb[k] - gam[k]
        pei.append((dd[k] - pei[k - 1]) / bet)
    for k in range(K - 2, -1, -1):
        pei[k] = pei[k] - gam[k + 1] * pei[k + 1]
    pe_full = [pe_m[0]] + pei
    pp = [pe_full[k] - pe_m[k] for k in range(K + 1)]

    # ---- implicit w solve ----------------------------------------------
    aa0 = [None] + [t1g / (dz[k - 1] + dz[k]) * pe_full[k]
                    for k in range(1, K)]
    wk = ([None] + [t2 * aa0[k] * (w1[k - 1] - w1[k]) for k in range(1, K)]
          if off else None)
    aa = [None] + [aa0[k] - scale_m * dm[0] for k in range(1, K)]
    bet = dm[0] - aa[1]
    w = [None] * K
    w[0] = (dm[0] * w1[0] + dt * pp[1]
            + (wk[1] if off else 0.0)) / bet
    gw = [None] * K
    for k in range(1, K - 1):
        gw[k] = aa[k] / bet
        bet = dm[k] - (aa[k] + aa[k + 1] + aa[k] * gw[k])
        dwk = (wk[k + 1] - wk[k]) if off else 0.0 * dm[k]
        w[k] = (dm[k] * w1[k] + dt * (pp[k + 1] - pp[k]) + dwk
                - aa[k] * w[k - 1]) / bet
    wk1 = t1g / dz[K - 1] * pe_full[K]
    gw[K - 1] = aa[K - 1] / bet
    betK = dm[K - 1] - (aa[K - 1] + wk1 + aa[K - 1] * gw[K - 1])
    bot = (wk1 * (t2 * w1[K - 1] - ra * ws) - wk[K - 1] if off
           else -wk1 * ws)
    w[K - 1] = (dm[K - 1] * w1[K - 1] + dt * (pp[K] - pp[K - 1]) + bot
                - aa[K - 1] * w[K - 2]) / betK
    for k in range(K - 2, -1, -1):
        w[k] = w[k] - gw[k + 1] * w[k + 1]

    # ---- updated perturbation -> clamped full pressure -> dz -------------
    pert = [torch.zeros_like(dm[0])]
    for k in range(K):
        dpe = dm[k] * (w[k] - w1[k]) * rdt
        if off:
            dpe = (dpe - beta * (pp[k + 1] - pp[k])) * ra
        pert.append(pert[k] + dpe)
    pe_new = [pe_m[0]] + [torch.maximum(p_fac * pe_m[k], pert[k] + pe_m[k])
                          for k in range(1, K + 1)]
    dz_new = [None] * K
    p1 = (pe_new[K - 1] + 2.0 * pe_new[K]) * R3 - r6g * dm[K - 1]
    dz_new[K - 1] = -dm[K - 1] * rgas * pt[K - 1] * torch.exp(
        capa1 * torch.log(p1))
    for k in range(K - 2, -1, -1):
        p1 = (pe_new[k] + bb[k] * pe_new[k + 1] + g_rat[k] * pe_new[k + 2]) \
            * R3 - g_rat[k] * p1
        dz_new[k] = -dm[k] * rgas * pt[k] * torch.exp(capa1 * torch.log(p1))
    pe_out = [pe_new[k] - pe_m[k] for k in range(K + 1)]
    if off:
        pe_out = [pe_out[k] + beta * (pp[k] - pe_out[k])
                  for k in range(K + 1)]
    return (torch.stack(pe_out, -3), torch.stack(w, -3),
            torch.stack(dz_new, -3))


def imp_diff_w(cd, delz, ws, w):
    """Implicit vertical diffusion of w (nh_utils.F90 imp_diff_w:688), run
    after the Riemann solver when d2bg_zq > 0 (nh_core.F90:188-190).
    cd: the diffusion coefficient (the reference passes d2bg_zq); delz
    [.., K, y, x] (negative); ws [.., y, x] the surface value. Returns the
    diffused w."""
    K = w.shape[-3]
    dzl = delz.unbind(-3)
    wl = w.unbind(-3)
    dz_i = [0.5 * (dzl[k - 1] + dzl[k]) for k in range(1, K)]  # k = 2..K
    c = [-cd / (dz_i[k] * dzl[k]) for k in range(K - 1)]      # k = 1..K-1
    bet = 1.0 - c[0]
    wt = [wl[0] / bet]
    gam = [None] * K
    for k in range(1, K - 1):
        ak = cd / (dz_i[k - 1] * dzl[k])
        gam[k] = c[k - 1] / bet
        bet = (1.0 + ak - c[k]) + ak * gam[k]
        wt.append((wl[k] + ak * wt[k - 1]) / bet)
    gam[K - 1] = c[K - 2] / bet
    dzK2 = dzl[K - 1] * dzl[K - 1]
    aK = cd / (0.5 * (dzl[K - 2] + dzl[K - 1]) * dzl[K - 1])
    out = [None] * K
    out[K - 1] = ((wl[K - 1] + 2.0 * ws * cd / dzK2 + aK * wt[K - 2])
                  / (1.0 + aK + 2.0 * cd / dzK2 + aK * gam[K - 1]))
    for k in range(K - 2, -1, -1):
        out[k] = wt[k] - gam[k + 1] * out[k + 1]
    return torch.stack(out, -3)


def _interfaces_from_top(delp, ptop):
    """ptop + the cumulative sum of delp down the column: [6, K+1, ...]."""
    return ptop + torch.cat([torch.zeros_like(delp[:, :1]),
                             torch.cumsum(delp, dim=1)], dim=1)


def _heights_from_bottom(dz, bottom):
    """Interface heights from the bottom value up: [6, K+1, ...]."""
    incr = torch.flip(torch.cumsum(torch.flip(dz, [1]), dim=1), [1])
    return torch.cat([bottom[:, None] - incr, bottom[:, None]], dim=1)


def riem_solver_c(dt2, delpc, ptc, w3, gz, phis_p, ws, akap, ptop, p_fac,
                  a_imp=1.0, ms=1):
    """C-stage semi-implicit solver (nh_utils.F90 Riem_Solver_C:323).
    delpc/ptc/w3 [6,K,Y,X] padded; gz interface heights (m). The dispatch
    of nh_utils.F90:450-460: a_imp < -0.01 runs SIM3p0; -0.01 <= a_imp <=
    0.5 the explicit RIM_2D with w frozen (ms substeps); otherwise SIM1 at
    alpha = 1 through the sim1 kernel, never off-centred. Returns (pef
    full pressure at interfaces, gz geopotential interfaces)."""
    from .sim1 import sim1
    gama = 1.0 / (1.0 - akap)
    rgrav = 1.0 / con.GRAV
    pem = _interfaces_from_top(delpc, ptop)
    dz2 = gz[:, 1:] - gz[:, :-1]
    pm2 = delpc / (torch.log(pem[:, 1:]) - torch.log(pem[:, :-1]))
    dm = delpc * rgrav
    if a_imp < -0.01:
        pe2, _, dz2n = sim3_solver(dt2, dm, pem, w3, dz2, ptc, ws, gama,
                                   akap, p_fac)
    elif a_imp <= 0.5:
        pe2, _, dz2n = rim_2d_solver(ms, dt2, dm, pm2, w3, dz2, ptc, ws,
                                     gama, akap, c_core=True)
    else:
        pe2, _, dz2n = sim1(dt2, dm, pm2, pem, w3, dz2, ptc, ws, gama, akap,
                            p_fac)
    pef = pe2 + pem
    pef[:, 0] = ptop
    gz_new = _heights_from_bottom(dz2n, phis_p * rgrav) * con.GRAV
    return pef, gz_new


def riem_solver3(dt, delp, pt, w, zh, zs, ws, akap, ptop, p_fac,
                 use_logp=False, a_imp=1.0, scale_m=0.0, d2bg_zq=0.0, ms=1):
    """D-stage implicit solver (nh_core.F90 Riem_Solver3:47, dispatch
    :169-185): a_imp > 0.999 runs the fully implicit SIM1 and 0.5 < a_imp
    <= 0.999 the off-centred SIM (alpha = a_imp), both through the sim1
    kernel; |a_imp| <= 0.5 the explicit RIM_2D with ms substeps; a_imp <
    -0.999 SIM3p0 and -0.999 <= a_imp < -0.5 SIM3 (alpha = |a_imp|).
    d2bg_zq > 1e-4 adds the implicit w diffusion imp_diff_w after the solve
    (nh_core.F90:188-190). delp/pt/w [6,K,Y,X]; zh interface heights
    [6,K+1,Y,X] (m); zs surface height [6,Y,X]; ws [6,Y,X]. Returns
    SimpleNamespace(w, delz, zh, ppe, pem, peln, pk3) with pk3 = pe**kappa,
    or log p below the top interface under use_logp."""
    from .sim1 import sim1
    gama = 1.0 / (1.0 - akap)
    rgrav = 1.0 / con.GRAV
    pem = _interfaces_from_top(delp, ptop)
    peln2 = torch.log(pem)
    pk3 = torch.exp(akap * peln2)
    pm2 = delp / (peln2[:, 1:] - peln2[:, :-1])
    dm = delp * rgrav
    dz2 = zh[:, 1:] - zh[:, :-1]
    if a_imp < -0.5:
        alpha = 1.0 if a_imp < -0.999 else float(abs(a_imp))
        pe2, w2, dz2n = sim3_solver(dt, dm, pem, w, dz2, pt, ws, gama, akap,
                                    p_fac, scale_m=scale_m, alpha=alpha)
    elif a_imp <= 0.5:
        pe2, w2, dz2n = rim_2d_solver(ms, dt, dm, pm2, w, dz2, pt, ws, gama,
                                      akap)
    else:
        alpha = 1.0 if a_imp > 0.999 else float(a_imp)
        pe2, w2, dz2n = sim1(dt, dm, pm2, pem, w, dz2, pt, ws, gama, akap,
                             p_fac, alpha=alpha)
    if d2bg_zq > 1.0e-4:
        w2 = imp_diff_w(d2bg_zq, dz2n, ws, w2)
    zh_new = _heights_from_bottom(dz2n, zs)
    if use_logp:
        pk3 = torch.cat([pk3[:, :1], peln2[:, 1:]], 1)
    return SimpleNamespace(w=w2, delz=dz2n, zh=zh_new, ppe=pe2,
                           pem=pem, peln=peln2, pk3=pk3)


def _monotone_heights(z):
    """Enforce z(k) >= z(k+1) + dz_min bottom-up (nh_utils.F90)."""
    K1 = z.shape[1]
    rows = list(z.unbind(1))
    carry = rows[K1 - 1] - DZ_MIN
    for k in range(K1 - 1, -1, -1):
        rows[k] = torch.maximum(rows[k], carry + DZ_MIN)
        carry = rows[k]
    return torch.stack(rows, 1)


def update_dz_c(g, ut, vt, gz, zs, dp0, dt2, npx):
    """C-stage height advection (nh_utils.F90 update_dz_c:59).

    ut/vt: c_sw's dt2-scaled area fluxes [6,K,...]; gz interface heights
    [6,K+1,...] (padded, m); zs padded surface height. First-order upwind
    per interface with dp0-weighted interface winds. Returns (gz_new, ws).
    """
    from .sw_core import _cl, _cr, _rl, _rr
    K = ut.shape[1]
    rdt = 1.0 / dt2
    dp0 = np.asarray(dp0, np.float64)
    d0 = torch.as_tensor(dp0, dtype=ut.dtype,
                         device=ut.device).reshape(1, K, 1, 1)
    top_r = float(dp0[0] / (dp0[0] + dp0[1]))
    bot_r = float(dp0[K - 1] / (dp0[K - 2] + dp0[K - 1]))

    def interface_wind(f3d):
        top = f3d[:, :1] + (f3d[:, :1] - f3d[:, 1:2]) * top_r
        bot = f3d[:, -1:] + (f3d[:, -1:] - f3d[:, -2:-1]) * bot_r
        mid = (d0[:, 1:] * f3d[:, :-1] + d0[:, :-1] * f3d[:, 1:]) / (
            d0[:, :-1] + d0[:, 1:])
        return torch.cat([top, mid, bot], dim=1)

    xfx = interface_wind(ut)
    yfx = interface_wind(vt)
    gx = fill_4corners_cell(gz, 1, npx)
    fx = xfx * torch.where(xfx > 0.0, _cl(gx), _cr(gx))
    gy = fill_4corners_cell(gz, 2, npx)
    fy = yfx * torch.where(yfx > 0.0, _rl(gy), _rr(gy))
    num = (gz * g.area + fx[..., :, :-1] - fx[..., :, 1:]
           + fy[..., :-1, :] - fy[..., 1:, :])
    den = (g.area + xfx[..., :, :-1] - xfx[..., :, 1:]
           + yfx[..., :-1, :] - yfx[..., 1:, :])
    gz_new = num / den
    ws = (zs - gz_new[:, -1]) * rdt
    return _monotone_heights(gz_new), ws


@lru_cache(maxsize=8)
def _edge_profile_matrix(dp0_key):
    """Dense [K+1, K] interface-interpolation operator of the non-uniform
    edge_profile tridiagonal (nh_utils.F90:1638-1665): qe = E @ q. It
    depends only on the reference dp0 profile, so it is solved once on the
    host."""
    dp0 = np.asarray(dp0_key, np.float64)
    K = dp0.shape[0]
    A = np.zeros((K + 1, K + 1))
    B = np.zeros((K + 1, K))
    g0 = dp0[1] / dp0[0]
    A[0, 0] = g0 * (g0 + 0.5)
    A[0, 1] = -(1.0 + g0 * (g0 + 1.5))
    B[0, 0] = 2.0 * g0 * (g0 + 1.0)
    B[0, 1] = 1.0
    for k in range(2, K + 1):
        gk = dp0[k - 2] / dp0[k - 1]
        A[k - 1, k - 2] = 1.0
        A[k - 1, k - 1] = 2.0 + 2.0 * gk
        A[k - 1, k] = gk
        B[k - 1, k - 2] = 3.0
        B[k - 1, k - 1] = 3.0 * gk
    gk = dp0[K - 2] / dp0[K - 1]
    A[K, K - 1] = 1.0 + gk * (gk + 1.5)
    A[K, K] = gk * (gk + 0.5)
    B[K, K - 1] = 2.0 * gk * (gk + 1.0)
    B[K, K - 2] = 1.0
    return np.linalg.solve(A, B)


def edge_profile(q, dp0):
    """Interface profile of a layer field along axis 1 through the
    precomputed operator (a plain matrix product, as the JAX package leaves
    it to XLA); q [6, K, ...] -> [6, K+1, ...]."""
    E = _edge_profile_matrix(tuple(np.asarray(dp0).tolist()))
    Ej = torch.as_tensor(E, dtype=q.dtype, device=q.device)
    return torch.einsum("lk,tk...->tl...", Ej, q)


def update_dz_d(g, zh, crx, cry, xfx, yfx, zs, dp0, dt, hord, npx,
                damp, ndif, lim_fac=1.0):
    """D-stage height advection (nh_utils.F90 update_dz_d:204).

    zh [6,K+1,NC,NC] padded heights; crx/xfx [6,K,NC,NW], cry/yfx
    [6,K,NW,NC] layer Courant/area fluxes from d_sw; damp/ndif: del-n
    damping strength/order. The double sweep runs at K+1 levels through
    tp_sweep.tp2d_sweep. Returns (zh_new interior [6,K+1,n,n], ws)."""
    n = g.n
    ctr = slice(H, H + n)
    rdt = 1.0 / dt
    crx_a = edge_profile(crx, dp0)
    xfx_a = edge_profile(xfx, dp0)
    cry_a = edge_profile(cry, dp0)
    yfx_a = edge_profile(yfx, dp0)
    ra_x = g.area + xfx_a[..., :, :-1] - xfx_a[..., :, 1:]
    ra_y = g.area + yfx_a[..., :-1, :] - yfx_a[..., 1:, :]
    fx, fy = fv_tp_2d(zh, crx_a, cry_a, hord, xfx_a, yfx_a, g.area,
                      ra_x, ra_y, g.dxa, g.dya, lim_fac=lim_fac)
    num = (zh[..., ctr, ctr] * g.area[..., ctr, ctr]
           + fx[..., :, :-1] - fx[..., :, 1:]
           + fy[..., :-1, :] - fy[..., 1:, :])
    den = (ra_x[..., ctr, ctr] + ra_y[..., ctr, ctr] - g.area[..., ctr, ctr])
    zh_new = num / den
    if damp > 1.0e-5:
        # the reference passes the RAW damp_vt coefficient to del6_vt_flux
        # here (d2 = damp*q), unlike d_sw's (damp*da_min)**(nord+1)
        fx2, fy2 = deln_damp_fluxes(zh, ndif, g, prefac=damp)
        wsl = slice(H, H + n + 1)
        zh_new = zh_new + (fx2[..., ctr, wsl][..., :, :-1]
                           - fx2[..., ctr, wsl][..., :, 1:]
                           + fy2[..., wsl, ctr][..., :-1, :]
                           - fy2[..., wsl, ctr][..., 1:, :]
                           ) * g.rarea[..., ctr, ctr]
    ws = (zs - zh_new[:, -1]) * rdt
    return _monotone_heights(zh_new), ws
