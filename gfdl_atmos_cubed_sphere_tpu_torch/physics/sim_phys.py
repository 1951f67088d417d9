"""Idealized moist physics suite (the solo driver's GFDL_sim_phys),
PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/physics/sim_phys.py (FV3
driver/solo/fv_phys.F90 GFDL_sim_phys:724, pbl_diff:1235, trid_dif2:1445,
gray_radiation:1590 - the Frierson/Held/Zurita-Gotor 2006 gray longwave -
and fv_nudge:1480; the bulk surface layer of monin_obukhov_drag.F90
Mon_obkv:61 and the Charnock roughness of ocean_rough.F90:60).

All columns are solved together; the vertical recursions (the two-stream
longwave, the implicit diffusion) are loops over the levels in the JAX
package's scan order, with [6, n, n] as the vector of columns.
"""

from dataclasses import dataclass

import numpy as np
import torch

from .. import constants as con
from ..model.thermodynamics import interface_pressure

H = 3
SBC = 5.6734e-8
VONKARM = 0.4


@dataclass(frozen=True)
class SimPhysConfig:
    solar_constant: float = 1367.0
    sw_abs: float = 0.3          # net cloud reflection + atmos absorption
    t0e: float = 8.0             # equatorial LW optical depth
    t0p: float = 1.5             # polar LW optical depth
    fl: float = 0.1              # Dargan strat/trop split
    diurnal_cycle: bool = False
    albedo: float = 0.0
    mu_min: float = 1.0e-5       # ~ molecular viscosity (pbl_diff)
    abl_s_fac: float = 0.2       # surface-layer fraction of the PBL
    ustar2: float = 1.0e-4
    charnock: float = 0.012      # ocean_rough charnock constant
    z0_min: float = 1.0e-5
    cd_fixed: float = 0.0        # > 0: fixed drag coefficient (do_fixed_cd)


def _two_stream(delt, b, start, levels):
    """r_{next} = (r + dtau*(B - r/2)) / (1 + dtau/2) over `levels` in
    order from `start`; returns the recursion's values, one per level."""
    r, out = start, []
    for k in levels:
        r = (r + delt[:, k] * (b[:, k] - 0.5 * r)) / (1.0 + 0.5 * delt[:, k])
        out.append(r)
    return out


def gray_radiation(temp, ts, delp, delz, lat, lon, ps, ptop,
                   cfg: SimPhysConfig, sec=0.0):
    """Frierson gray radiation (fv_phys.F90 gray_radiation:1590).

    temp [6, K, n, n]; ts, lat, lon, ps [6, n, n]; delz negative. Returns
    (t_dt [K/s], diag dict with olr, lwu, lwd, sw_surf)."""
    K = temp.shape[1]
    tau0 = cfg.t0e + (cfg.t0p - cfg.t0e) * torch.sin(lat) ** 2
    pe = interface_pressure(delp, ptop)
    sig = pe / ps[:, None]
    tau = tau0[:, None] * (sig * cfg.fl + (1.0 - cfg.fl) * sig ** 4)
    delt = tau[:, 1:] - tau[:, :-1]
    b = SBC * temp ** 4

    # downward (top-down, :1664-1668) and upward (bottom-up, :1673-1678)
    z0 = torch.zeros_like(b[:, 0])
    dr = torch.stack([z0] + _two_stream(delt, b, z0, range(K)), dim=1)
    urK = SBC * ts ** 4
    ur = torch.stack(_two_stream(delt, b, urK, range(K - 1, -1, -1))[::-1]
                     + [urK], dim=1)

    lw = ur - dr
    rho = -delp / (con.GRAV * delz)
    t_dt = (lw[:, :-1] - lw[:, 1:]) / (con.CP_AIR * rho * delz)

    # SW absorbed at the surface (no atmospheric SW absorption)
    sw_rad_coef = cfg.solar_constant * (1.0 - cfg.sw_abs)
    if cfg.diurnal_cycle:
        ang = 2.0 * np.pi * sec / 86400.0 + lon
        sw_surf = (sw_rad_coef * torch.cos(lat)
                   * torch.clamp(torch.cos(ang), min=0.0) * (1.0 - cfg.albedo))
    else:
        sw_surf = (sw_rad_coef / np.pi * torch.clamp(torch.cos(lat), min=0.0)
                   * (1.0 - cfg.albedo))
    diag = dict(olr=ur[:, 0], lwu=urK, lwd=dr[:, -1], sw_surf=sw_surf)
    return t_dt, diag


def ocean_roughness(ustar, cfg: SimPhysConfig):
    """Charnock + smooth-flow roughness length (ocean_rough.F90:60)."""
    visc = 1.5e-5
    return torch.clamp(cfg.charnock * ustar ** 2 / con.GRAV
                       + 0.11 * visc / torch.clamp(ustar, min=1.0e-6),
                       min=cfg.z0_min)


def bulk_surface_drag(ua, va, ta, ts, z_bot, q_bot=None,
                      cfg=SimPhysConfig()):
    """Bulk surface exchange coefficient (Mon_obkv:61 with a bulk-Ri
    stability factor in place of the full similarity iteration; the
    do_fixed_cd path is exact). q_bot: unread, as in the JAX package.
    Returns (cd, ch, ustar)."""
    wind = torch.sqrt(ua ** 2 + va ** 2 + cfg.ustar2)
    if cfg.cd_fixed > 0.0:
        cd = torch.full_like(wind, cfg.cd_fixed)
        return cd, cd, torch.sqrt(cd) * wind
    # the neutral log law with Charnock roughness (2 passes converge)
    ustar = 0.03 * wind
    for _ in range(2):
        z0 = ocean_roughness(ustar, cfg)
        cdn = (VONKARM / torch.log(z_bot / z0)) ** 2
        ustar = torch.sqrt(cdn) * wind
    # bulk Richardson stability factor
    ri = con.GRAV * z_bot * (ta - ts) / (0.5 * (ta + ts) * wind ** 2)
    fac = torch.where(ri >= 0.0,
                      1.0 / (1.0 + 10.0 * torch.clamp(ri, 0.0, 10.0)),
                      torch.sqrt(1.0 - 16.0 * torch.clamp(ri, -10.0, 0.0)))
    cd = cdn * fac
    return cd, cd, torch.sqrt(cd) * wind


def _interface_heights(delz):
    """Heights of the K+1 interfaces above the surface (delz negative)."""
    return torch.cat([-torch.flip(torch.cumsum(torch.flip(delz, [1]), 1),
                                  [1]),
                      torch.zeros_like(delz[:, :1])], dim=1)


def pbl_height(ua, va, ta, qv, ts, delz, ps, pm, cfg: SimPhysConfig):
    """Bulk-Richardson PBL top height (pbl_diff:1283-1296): the first level
    (scanning up) where Ri_b > 1. Returns pblh [6, n, n] (m)."""
    gh = _interface_heights(delz)
    zmid = gh[:, 1:] - 0.5 * delz
    zvir = con.RVGAS / con.RDGAS - 1.0
    if qv is None:
        qv = torch.zeros_like(ta)
    tv_s = ts * (1.0 + zvir * qv[:, -1])
    tvm = ta * (1.0 + zvir * qv) * (ps[:, None] / pm) ** con.KAPPA
    rin = (con.GRAV * zmid * (tvm - tv_s[:, None])
           / (0.5 * (tv_s[:, None] + tvm)
              * (ua ** 2 + va ** 2 + cfg.ustar2)))
    # the lowest interface above which Ri first exceeds 1 (bottom-up)
    stable = (rin > 1.0).to(ta.dtype)
    up = torch.flip(stable, [1])
    below = torch.cumsum(up, 1)
    first = torch.flip((below == 1.0) & (up == 1.0), [1])
    return torch.sum(torch.where(first, gh[:, 1:], torch.zeros_like(ta)),
                     dim=1)


def k_profile(gh_mid, pblh, mu, cfg: SimPhysConfig):
    """Dargan K-profile (pbl_diff:1302-1322): linear to abl_s_fac*pblh,
    quadratic decay to pblh, mu_min above and outside."""
    surf_h = cfg.abl_s_fac * pblh[:, None]
    kz = mu[:, None] * gh_mid
    outer = (mu[:, None] * surf_h * gh_mid / surf_h
             * (1.0 - (gh_mid - surf_h)
                / torch.clamp(pblh[:, None] - surf_h, min=1.0)) ** 2)
    mu_min = torch.full_like(gh_mid, cfg.mu_min)
    nu = torch.where(gh_mid <= surf_h, kz,
                     torch.where(gh_mid <= pblh[:, None], outer, mu_min))
    nu = torch.where((gh_mid > 6.0e3) | (pblh[:, None] <= 0.0), mu_min, nu)
    return torch.clamp(nu, min=cfg.mu_min)


def implicit_diffusion(x, nu_int, delz, delp, dt):
    """Implicit vertical diffusion (trid_dif2:1445): solve
    (I - dt*D) x' = x with flux coefficients nu at the interior
    interfaces, by the Thomas algorithm down then up the column.

    x [6, K, n, n]; nu_int [6, K-1, n, n]; delz negative."""
    K = x.shape[1]
    dzm = -delz
    dz_int = 0.5 * (dzm[:, :-1] + dzm[:, 1:])
    rho_int = (delp[:, :-1] + delp[:, 1:]) / (
        con.GRAV * (dzm[:, :-1] + dzm[:, 1:]))
    cc = dt * rho_int * nu_int / dz_int * con.GRAV / delp[:, :-1]
    cd_ = dt * rho_int * nu_int / dz_int * con.GRAV / delp[:, 1:]
    # tridiagonal: a(k) x(k-1) + b(k) x(k) + c(k) x(k+1) = x0(k)
    a = torch.cat([torch.zeros_like(cd_[:, :1]), -cd_], dim=1)
    c = torch.cat([-cc, torch.zeros_like(cc[:, :1])], dim=1)
    b = 1.0 - a - c

    cp_prev = dp_prev = torch.zeros_like(x[:, 0])
    cps, dps = [], []
    for k in range(K):
        m = b[:, k] - a[:, k] * cp_prev
        cp_prev = c[:, k] / m
        dp_prev = (x[:, k] - a[:, k] * dp_prev) / m
        cps.append(cp_prev)
        dps.append(dp_prev)
    out = [None] * K
    nxt = torch.zeros_like(x[:, 0])
    for k in range(K - 1, -1, -1):
        nxt = dps[k] - cps[k] * nxt
        out[k] = nxt
    return torch.stack(out, dim=1)


def sim_phys(ua, va, ta, qv, delp, delz, ts, g, ptop, dt,
             cfg: SimPhysConfig = SimPhysConfig(), sec=0.0):
    """One step of the idealized physics suite (GFDL_sim_phys:724 subset):
    gray radiation, bulk surface drag, PBL diffusion. A-grid winds in and
    out; returns (ua, va, ta, qv, diag)."""
    ctr = slice(H, H + g.n)
    lat = g.aglat[:, 0, ctr, ctr]
    lon = g.aglon[:, 0, ctr, ctr]
    ps = ptop + torch.sum(delp, dim=1)
    pe = ptop + torch.cumsum(delp, dim=1)
    pm = pe - 0.5 * delp

    t_dt, rad = gray_radiation(ta, ts, delp, delz, lat, lon, ps, ptop, cfg,
                               sec)
    ta = ta + dt * t_dt

    dz_bot = -delz[:, -1]
    cd, ch, ustar = bulk_surface_drag(ua[:, -1], va[:, -1], ta[:, -1], ts,
                                      0.5 * dz_bot, cfg=cfg)
    wind = torch.sqrt(ua[:, -1] ** 2 + va[:, -1] ** 2 + cfg.ustar2)
    # implicit surface momentum sink: du/dt = -cd*|V|*u / dz_bot
    drag = 1.0 / (1.0 + dt * cd * wind / dz_bot)
    ua = torch.cat([ua[:, :-1], (ua[:, -1] * drag)[:, None]], dim=1)
    va = torch.cat([va[:, :-1], (va[:, -1] * drag)[:, None]], dim=1)
    # sensible heating of the lowest layer toward ts
    t_bot = ta[:, -1] + dt * ch * wind / dz_bot * (ts - ta[:, -1])
    ta = torch.cat([ta[:, :-1], t_bot[:, None]], dim=1)

    # PBL mixing
    pblh = pbl_height(ua, va, ta, qv, ts, delz, ps, pm, cfg)
    gh_mid = _interface_heights(delz)[:, 1:] - 0.5 * delz
    nu = k_profile(gh_mid, pblh, VONKARM * ustar, cfg)
    nu_int = 0.5 * (nu[:, :-1] + nu[:, 1:])
    ua = implicit_diffusion(ua, nu_int, delz, delp, dt)
    va = implicit_diffusion(va, nu_int, delz, delp, dt)
    theta = ta * (1.0e5 / pm) ** con.KAPPA
    theta = implicit_diffusion(theta, nu_int, delz, delp, dt)
    ta = theta * (pm / 1.0e5) ** con.KAPPA
    if qv is not None:
        qv = implicit_diffusion(qv, nu_int, delz, delp, dt)

    diag = dict(pblh=pblh, ustar=ustar, cd=cd, **rad)
    return ua, va, ta, qv, diag


def fv_nudge(u, v, pt, u0, v0, pt0, dt, tau_winds=600.0, tau_temp=600.0):
    """State nudging toward reference profiles (fv_phys.F90 fv_nudge:1480):
    the implicit relaxation x += (x0 - x)*dt/(tau + dt), tau_winds for the
    winds and tau_temp for the temperature (s)."""
    fw = dt / (tau_winds + dt)
    ft = dt / (tau_temp + dt)
    return u + fw * (u0 - u), v + fw * (v0 - v), pt + ft * (pt0 - pt)
