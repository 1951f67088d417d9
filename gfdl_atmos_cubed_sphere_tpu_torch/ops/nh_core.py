"""Nonhydrostatic vertical solvers and height advection, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/ops/nh_core.py (FV3
model/nh_utils.F90 update_dz_c:59, update_dz_d:204, Riem_Solver_C:323,
Riem_Solver3 and the fully implicit SIM1_solver:1277). Ported: the SIM1
branches (a_imp > 0.999) the operational configuration runs. The other
solvers (SIM3, RIM_2D, the off-centred SIM) raise NotImplementedError;
imp_diff_w and use_logp are not ported (dyn_core_nh refuses them).

All column solves are batched over (tile, y, x); the sweeps along k are
Python loops over levels. On the card the column solve runs in the sim1
kernel (ops/sim1.py), dispatched where the JAX package dispatches its
Pallas kernel.

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


def sim1_solver(dt, dm2, pm2, pem, w2, dz2, pt2, ws, gama, akap, p_fac):
    """Fully implicit (alpha = 1) SIM1 Riemann / vertical sound-wave solver
    (nh_utils.F90 SIM1_solver:1277). The plain version of the sim1 kernel.

    Fields [.., K, y, x] (interfaces [.., K+1, y, x]); ws [.., y, x].
    dm2 = delp/grav; pm2 log-mean layer pressure; pem hydrostatic interface
    pressure; pt2 virtual temperature. Returns (pe2 [.., K+1, y, x] nonhydro
    pressure perturbation at interfaces, w2, dz2)."""
    rgas = con.RDGAS
    t1g = 2.0 * dt * dt
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
    bet = dm[0] - aa[1]
    w = [None] * K
    w[0] = (dm[0] * w1[0] + dt * pp[1]) / bet
    gw = [None] * K
    for k in range(1, K - 1):
        gw[k] = aa[k] / bet
        bet = dm[k] - (aa[k] + aa[k + 1] + aa[k] * gw[k])
        w[k] = (dm[k] * w1[k] + dt * (pp[k + 1] - pp[k])
                - aa[k] * w[k - 1]) / bet
    p1 = t1g * gm2 / dz[K - 1] * pe_m[K]
    gw[K - 1] = aa[K - 1] / bet
    betK = dm[K - 1] - (aa[K - 1] + p1 + aa[K - 1] * gw[K - 1])
    w[K - 1] = (dm[K - 1] * w1[K - 1] + dt * (pp[K] - pp[K - 1])
                - p1 * ws - aa[K - 1] * w[K - 2]) / betK
    for k in range(K - 2, -1, -1):
        w[k] = w[k] - gw[k + 1] * w[k + 1]

    # ---- new nonhydro pressure + dz -------------------------------------
    pe_new = [torch.zeros_like(dm[0])]
    for k in range(K):
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
    return (torch.stack(pe_new, -3), torch.stack(w, -3),
            torch.stack(dz_new, -3))


def _interfaces_from_top(delp, ptop):
    """ptop + the cumulative sum of delp down the column: [6, K+1, ...]."""
    return ptop + torch.cat([torch.zeros_like(delp[:, :1]),
                             torch.cumsum(delp, dim=1)], dim=1)


def _heights_from_bottom(dz, bottom):
    """Interface heights from the bottom value up: [6, K+1, ...]."""
    incr = torch.flip(torch.cumsum(torch.flip(dz, [1]), dim=1), [1])
    return torch.cat([bottom[:, None] - incr, bottom[:, None]], dim=1)


def _check_sim1(a_imp):
    if a_imp <= 0.999:
        raise NotImplementedError(
            "the Riemann solvers carry the fully implicit SIM1 branch only "
            "(a_imp > 0.999)")


def riem_solver_c(dt2, delpc, ptc, w3, gz, phis_p, ws, akap, ptop, p_fac,
                  a_imp=1.0):
    """C-stage semi-implicit solver (nh_utils.F90 Riem_Solver_C:323), SIM1.
    delpc/ptc/w3 [6,K,Y,X] padded; gz interface heights (m). Returns (pef
    full pressure at interfaces, gz geopotential interfaces)."""
    from .sim1 import sim1
    _check_sim1(a_imp)
    gama = 1.0 / (1.0 - akap)
    rgrav = 1.0 / con.GRAV
    pem = _interfaces_from_top(delpc, ptop)
    dz2 = gz[:, 1:] - gz[:, :-1]
    pm2 = delpc / (torch.log(pem[:, 1:]) - torch.log(pem[:, :-1]))
    dm = delpc * rgrav
    pe2, _, dz2n = sim1(dt2, dm, pm2, pem, w3, dz2, ptc, ws, gama, akap,
                        p_fac)
    pef = pe2 + pem
    pef[:, 0] = ptop
    gz_new = _heights_from_bottom(dz2n, phis_p * rgrav) * con.GRAV
    return pef, gz_new


def riem_solver3(dt, delp, pt, w, zh, zs, ws, akap, ptop, p_fac,
                 a_imp=1.0):
    """D-stage implicit solver (nh_core.F90 Riem_Solver3:47), SIM1.
    delp/pt/w [6,K,Y,X]; zh interface heights [6,K+1,Y,X] (m); zs surface
    height [6,Y,X]; ws [6,Y,X]. Returns SimpleNamespace(w, delz, zh, ppe,
    pem, peln, pk3) with pk3 = pe**kappa."""
    from .sim1 import sim1
    _check_sim1(a_imp)
    gama = 1.0 / (1.0 - akap)
    rgrav = 1.0 / con.GRAV
    pem = _interfaces_from_top(delp, ptop)
    peln2 = torch.log(pem)
    pk3 = torch.exp(akap * peln2)
    pm2 = delp / (peln2[:, 1:] - peln2[:, :-1])
    dm = delp * rgrav
    dz2 = zh[:, 1:] - zh[:, :-1]
    pe2, w2, dz2n = sim1(dt, dm, pm2, pem, w, dz2, pt, ws, gama, akap, p_fac)
    zh_new = _heights_from_bottom(dz2n, zs)
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
