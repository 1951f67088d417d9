"""Thermodynamics and energetics, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/model/thermodynamics.py (FV3
model/fv_thermodynamics.F90 moist_cv/moist_cp and compute_total_energy:43,
and the total-energy fixer bookkeeping of fv_mapz.F90:644-772) with the
same column formulas, so entry and exit energies are comparable; plus the
angular-momentum diagnostics and fixer of fv_dynamics.F90
(compute_aam:1266, consv_am :747-800).

Single device: the area-weighted global means sum over all six tiles of
one tensor (the cross-device form waits for the multi-GPU port).
"""

import torch

from .. import constants as con
from ..parallel.reductions import g_sum_reproducible
from .fv_update_phys import _cell, _xw, _yw, cubed_to_latlon

ZVIR = con.RVGAS / con.RDGAS - 1.0


def ke_cell(u, v, g):
    """Cell-mean kinetic energy from D winds (the 0.25*rsin2*(...) form of
    fv_mapz.F90, e.g. :688-691). u [6, K, n+1, n], v [6, K, n, n+1]."""
    rsin2 = _cell(g, g.rsin2)
    cosa_s = _cell(g, g.cosa_s)
    u1, u2 = u[..., :-1, :], u[..., 1:, :]
    v1, v2 = v[..., :, :-1], v[..., :, 1:]
    return 0.25 * rsin2 * (u1 ** 2 + u2 ** 2 + v1 ** 2 + v2 ** 2
                           - (u1 + u2) * (v1 + v2) * cosa_s)


def interface_pressure(delp, ptop):
    """Interface pressures [6, K+1, n, n]: ptop above the top layer, then
    ptop plus the running sum of delp down the column."""
    pe = ptop + torch.cumsum(delp, dim=1)
    return torch.cat([torch.full_like(pe[:, :1], ptop), pe], dim=1)


def _surface(phis):
    return phis if phis.ndim == 3 else phis[:, 0]


def total_energy_2d_hydro(u, v, tv, delp, peln, pe, phis, g):
    """Column total energy, hydrostatic form (fv_mapz.F90:665-683):
    te = pe_bot*hs - ptop*gz_top + sum_k delp*(cp*Tv + KE)."""
    hs = _surface(phis)
    gz_top = hs + torch.sum(con.RDGAS * tv * (peln[:, 1:] - peln[:, :-1]),
                            dim=1)
    te = pe[:, -1] * hs - pe[:, 0] * gz_top
    return te + torch.sum(delp * (con.CP_AIR * tv + ke_cell(u, v, g)), dim=1)


def total_energy_2d_nh(u, v, w, tv, qsphum, delp, delz, phis, g):
    """Column total energy, nonhydrostatic form (fv_mapz.F90:686-717):
    te = sum_k delp*(cv*T + 0.5*(phi_k + phi_k+1 + w^2 + 2*KE))."""
    hs = _surface(phis)
    cv_air = con.CP_AIR - con.RDGAS
    incr = torch.flip(torch.cumsum(torch.flip(-con.GRAV * delz, [1]), 1),
                      [1])
    phi_top = torch.cat([hs[:, None] + incr, hs[:, None]], dim=1)
    t_abs = tv if qsphum is None else tv / (1.0 + ZVIR * qsphum)
    return torch.sum(delp * (cv_air * t_abs
                             + 0.5 * (phi_top[:, :-1] + phi_top[:, 1:]
                                      + w ** 2 + 2.0 * ke_cell(u, v, g))),
                     dim=1)


def g_mean(field2d, g, reproduce=False):
    """Area-weighted global mean (fv_grid_utils.F90 g_sum mode 0) of a
    [6, n, n] field; reproduce=True takes the bitwise order-invariant
    fixed-point sum (parallel/reductions.py)."""
    area = _cell(g, g.area)[:, 0]
    if reproduce:
        return g_sum_reproducible(field2d, area)
    return torch.sum(field2d * area) / torch.sum(area)


def _water(q, nwat):
    """(qv, ql, qs) of moist_cv/moist_cp for nwat 3-6, or None."""
    z = lambda k: q.get(k) if q.get(k) is not None else 0.0
    if nwat == 3:
        return z("liq_wat"), z("ice_wat")
    if nwat == 4:
        return z("liq_wat") + z("rainwat"), 0.0
    if nwat == 5:
        return z("liq_wat") + z("rainwat"), z("ice_wat") + z("snowwat")
    if nwat == 6:
        return (z("liq_wat") + z("rainwat"),
                z("ice_wat") + z("snowwat") + z("graupel"))
    return None


def _vapour(q):
    return (torch.clamp(torch.as_tensor(q["sphum"]), min=0.0)
            if "sphum" in q else 0.0)


def moist_cv(q, nwat=6):
    """Moist heat capacity at constant volume and the condensate loading
    q_con (fv_thermodynamics.F90 moist_cv:250, nwat cases 2-6). q: dict of
    tracer tensors. Returns (cvm, q_con)."""
    qv = _vapour(q)
    if nwat == 2:
        q_con = torch.clamp(torch.as_tensor(q.get("liq_wat", 0.0)), min=0.0)
        return (1.0 - qv) * con.CV_AIR + qv * con.CV_VAP, q_con
    w = _water(q, nwat)
    if w is None:
        return con.CV_AIR, 0.0
    ql, qs = w
    q_con = ql + qs
    cvm = ((1.0 - (qv + q_con)) * con.CV_AIR + qv * con.CV_VAP
           + ql * con.C_LIQ + qs * con.C_ICE)
    return cvm, q_con


def moist_cp(q, nwat=6):
    """Moist heat capacity at constant pressure (moist_cp:327). Returns
    (cpm, q_con)."""
    qv = _vapour(q)
    if nwat == 2:
        q_con = torch.clamp(torch.as_tensor(q.get("liq_wat", 0.0)), min=0.0)
        return (1.0 - qv) * con.CP_AIR + qv * con.CP_VAPOR, q_con
    w = _water(q, nwat)
    if w is None:
        return con.CP_AIR, 0.0
    ql, qs = w
    q_con = ql + qs
    cpm = ((1.0 - (qv + q_con)) * con.CP_AIR + qv * con.CP_VAPOR
           + ql * con.C_LIQ + qs * con.C_ICE)
    return cpm, q_con


def compute_aam(u, v, delp, g, ptop):
    """Vertically mass-integrated atmospheric angular momentum and its
    moment factor (fv_dynamics.F90 compute_aam:1266). Returns
    (aam [6, n, n], m_fac, ps)."""
    ua, _ = cubed_to_latlon(u, v, g)
    lat = _cell(g, g.aglat)[:, 0]
    r1 = g.geom.radius * torch.cos(lat)
    r2 = r1 * r1
    dm = delp / con.GRAV
    aam = torch.sum((r2[:, None] * g.geom.omega + r1[:, None] * ua) * dm,
                    dim=1)
    m_fac = torch.sum(dm * r2[:, None], dim=1)
    ps = ptop + torch.sum(delp, dim=1)
    return aam, m_fac, ps


def am_fixer(u, v, delp, aam0, g, ptop, reproduce=False, torque=None):
    """consv_am global angular-momentum fixer (fv_dynamics.F90:747-800):
    the AAM change over the step relative to aam0, plus the mountain-torque
    map torque when given (the dt2*(ps2+ps)*zxg term of
    fv_dynamics.F90:765), becomes the solid-body zonal wind increment
    u00 = -R*<dAAM>/<m_fac>, projected onto the D-grid walls with the
    l2c_u/l2c_v factors. Returns (u, v, u00)."""
    aam1, m_fac, _ = compute_aam(u, v, delp, g, ptop)
    d = aam1 - aam0
    if torque is not None:
        d = d + torque
    # the area normalization of g_sum mode 0 cancels in the ratio
    amdt = g_mean(d, g, reproduce=reproduce)
    u00 = -g.geom.radius * amdt / g_mean(m_fac, g, reproduce=reproduce)
    u00 = u00.to(u.dtype)
    u = u + u00 * _yw(g, g.l2c_u)
    v = v + u00 * _xw(g, g.l2c_v)
    return u, v, u00


def energy_fixer_dtmp(te0, te1, pkz, delp, pk, ptop, consv, g,
                      hydrostatic=True, reproduce=False):
    """Global heating increment dtmp (fv_mapz.F90:740-772): consv times the
    mean energy loss over the mean heat-capacity integral."""
    zsum = torch.sum(pkz * delp, dim=1)
    if hydrostatic:
        zsum = ptop * (pk[:, 0] - pk[:, -1]) + zsum
    return (consv * g_mean(te0 - te1, g, reproduce=reproduce)
            / g_mean(zsum, g, reproduce=reproduce))
