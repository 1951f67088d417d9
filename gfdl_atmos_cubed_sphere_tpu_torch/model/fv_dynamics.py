"""FV3 dynamics drivers: the k_split remap loop over the acoustic core,
nonhydrostatic and hydrostatic, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/model/fv_dynamics.py
(fv_dynamics_nh, remap_nh, fv_dynamics_hydro, remap_hydro; FV3
model/fv_dynamics.F90 and model/fv_mapz.F90 Lagrangian_to_Eulerian:56):
the acoustic loop, the large-timestep tracer transport (tracer_2d), the
vertical remap with the tracers (mapn_tracer), the negative-moisture
adjustment (neg_adj3) and the GFDL microphysics (gfdl_mp_driver), with
the ideal-case Rayleigh sponge (rayleigh_super) or the real-case Rayleigh
friction (rayleigh_friction) when tau > 0 (unless the inline Rayleigh
damping rf_fast takes its place in the acoustic loop), the global
total-energy fixer (consv_te > 0) and the angular-momentum fixer
(consv_am). On the nonhydrostatic path do_fast_phys runs the inline fast
physics (fast_sat_adj) inside the acoustic loop on the tracers, with
mp_cfg as its configuration; without mp_cfg it does nothing, as in the
JAX package.

State carried between calls: u, v (D winds), delp, pt = TEMPERATURE, the
tracer dict q, and on the nonhydrostatic path w (m/s) and delz (m,
negative). Inside the step pt becomes virtual potential temperature and is
converted back on the last remap.
"""

import functools
from types import SimpleNamespace

import numpy as np
import torch

from .. import constants as con
from ..io.restart import to_host
from ..ops import fv_mapz, fv_sg
from ..ops.sw_core import _rl, _cl
from ..ops.fill_corners import fi
from ..physics import gfdl_mp
from . import thermodynamics as thermo
from . import tracer_2d as tracer
from .dyn_core import DynConfig
from .fv_update_phys import cubed_to_latlon

H = 3


def _k_last(a):
    return torch.movedim(a, 1, -1)


def _k_lev(a):
    return torch.movedim(a, -1, 1)


def _mass_convergence(mfx, mfy, g):
    """Per-layer mass convergence (Pa) from the accumulated wall mass
    fluxes (the dyn_core.F90:739/778 omga prep)."""
    rarea = g.rarea[..., 3:-3, 3:-3]
    return (mfx[..., :, :-1] - mfx[..., :, 1:]
            + mfy[..., :-1, :] - mfy[..., 1:, :]) * rarea


def _omega(conv, dt):
    """Vertical pressure velocity omga (Pa/s) at layer lower interfaces:
    the top-down cumulative sum of layer convergence rates."""
    return torch.cumsum(conv, dim=1) / dt


def _remap_tracers_winds(q, u, v, pe_pad, pe1, pe2, akl, bkl, g, cfg):
    """The remap both paths share: the tracers on pe in one mapn_tracer
    call, the winds on the pe of their walls (iv = -1). pe_pad: the padded
    interface pressures before; pe1, pe2 [6, n, n, K+1] the cell
    interfaces before and after; akl, bkl the hybrid coefficients. Returns
    (q or None, u, v) in the level layout."""
    n = g.n
    ctr = slice(H, H + n)
    wsl = slice(fi(1), fi(g.npx) + 1)
    q_new = None
    if q:
        names = list(q.keys())
        qk = fv_mapz.mapn_tracer(
            torch.stack([_k_last(q[k]) for k in names], 0), pe1, pe2,
            kord=cfg.kord_tr, fill=cfg.fill)
        q_new = {k: _k_lev(qk[i]) for i, k in enumerate(names)}

    pe_u0 = _k_last(0.5 * (pe_pad[..., wsl, ctr] + _rl(pe_pad)[..., wsl, ctr]))
    pe_u1 = akl + bkl * pe_u0[..., -1:]
    u_new = fv_mapz.map1_ppm(_k_last(u), pe_u0, pe_u1, iv=-1,
                             kord=abs(cfg.kord_mt))
    pe_v0 = _k_last(0.5 * (pe_pad[..., ctr, wsl] + _cl(pe_pad)[..., ctr, wsl]))
    pe_v1 = akl + bkl * pe_v0[..., -1:]
    v_new = fv_mapz.map1_ppm(_k_last(v), pe_v0, pe_v1, iv=-1,
                             kord=abs(cfg.kord_mt))
    return q_new, _k_lev(u_new), _k_lev(v_new)


def remap_nh(delp, ptv, u, v, w, delz, ws, q, pe_pad, peln_pad, ak, bk, g,
             cfg, akap, last_step, kord_wz=9):
    """Nonhydrostatic vertical remap (fv_mapz.F90 Lagrangian_to_Eulerian,
    hydrostatic=.false., kord_tm<0): theta_v -> T_v through the gas law,
    T_v remapped on log-p, w with the ws bottom value (iv=-2), delz as
    specific volume, the tracers on pe in one mapn_tracer call, the winds
    on pe. ak, bk: [K+1] tensors; q: the tracer dict (may be empty);
    last_step: whether this is the big step's last remap, unread, as in
    the JAX package."""
    ctr = slice(H, H + g.n)
    K = delp.shape[1]
    rrg = -con.RDGAS / con.GRAV
    k1k = akap / (1.0 - akap)

    pe1 = _k_last(pe_pad[..., ctr, ctr])
    peln1 = _k_last(peln_pad[..., ctr, ctr])
    tv = _k_last(ptv * torch.exp(k1k * torch.log(rrg * delp / delz * ptv)))
    ps = pe1[..., -1:]
    akl = ak.reshape((1,) * 3 + (K + 1,))
    bkl = bk.reshape((1,) * 3 + (K + 1,))
    pe2 = akl + bkl * ps
    pn2 = torch.log(pe2)
    pk2 = torch.exp(akap * pn2)
    dp2 = pe2[..., 1:] - pe2[..., :-1]

    tv_new = fv_mapz.map1_ppm(tv, peln1, pn2, iv=1, kord=abs(cfg.kord_tm),
                              qmin=fv_mapz.T_MIN)
    w_new = fv_mapz.map1_ppm(_k_last(w), pe1, pe2, qs=ws, iv=-2,
                             kord=abs(kord_wz))
    sv = _k_last(-delz / delp)
    sv_new = fv_mapz.map1_ppm(sv, pe1, pe2, iv=1, kord=abs(cfg.kord_tm))
    delz_new = _k_lev(-sv_new * dp2)

    q_new, u_new, v_new = _remap_tracers_winds(q, u, v, pe_pad, pe1, pe2,
                                               akl, bkl, g, cfg)

    delp_k = _k_lev(dp2)
    tvk = _k_lev(tv_new)
    pkz_new = torch.exp(akap * torch.log(rrg * delp_k / delz_new * tvk))
    return SimpleNamespace(delp=delp_k, tv=tvk, u=u_new, v=v_new,
                           w=_k_lev(w_new), delz=delz_new, q=q_new,
                           pkz=pkz_new, pk2=_k_lev(pk2), ps=ps[..., 0])


def remap_hydro(delp, ptv, u, v, q, pe_pad, peln_pad, pkz, ak, bk, g, cfg,
                akap, last_step):
    """Hydrostatic vertical remap (fv_mapz.F90 Lagrangian_to_Eulerian,
    hydrostatic, kord_tm<0): theta_v -> T_v with geopk's pkz, T_v remapped
    on log-p, the tracers on pe in one mapn_tracer call, the winds on pe.
    pe_pad, peln_pad [6, K+1, P, P] and pkz [6, K, P, P] from the acoustic
    loop's geopk; ak, bk: [K+1] tensors; q: the tracer dict (may be
    empty); last_step: unread, as in the JAX package."""
    ctr = slice(H, H + g.n)
    K = delp.shape[1]
    pe1 = _k_last(pe_pad[..., ctr, ctr])
    peln1 = _k_last(peln_pad[..., ctr, ctr])
    tv = _k_last(ptv) * _k_last(pkz[..., ctr, ctr])
    ps = pe1[..., -1:]
    akl = ak.reshape((1,) * 3 + (K + 1,))
    bkl = bk.reshape((1,) * 3 + (K + 1,))
    pe2 = akl + bkl * ps
    pn2 = torch.log(pe2)
    pk2 = torch.exp(akap * pn2)

    tv_new = fv_mapz.map1_ppm(tv, peln1, pn2, iv=1, kord=abs(cfg.kord_tm),
                              qmin=fv_mapz.T_MIN)
    q_new, u_new, v_new = _remap_tracers_winds(q, u, v, pe_pad, pe1, pe2,
                                               akl, bkl, g, cfg)
    pkz_new = (pk2[..., 1:] - pk2[..., :-1]) / (
        akap * (pn2[..., 1:] - pn2[..., :-1]))
    return SimpleNamespace(delp=_k_lev(pe2[..., 1:] - pe2[..., :-1]),
                           tv=_k_lev(tv_new), u=u_new, v=v_new, q=q_new,
                           pkz=_k_lev(pkz_new), pk2=_k_lev(pk2),
                           ps=ps[..., 0])


def _ref_pressure(ak, bk):
    """Layer reference pressures at ps = 1e5 Pa (fv_dynamics.F90:369)."""
    akn, bkn = to_host(ak), to_host(bk)
    return ((akn[1:] + akn[:-1]) + (bkn[1:] + bkn[:-1]) * 1.0e5) * 0.5


@functools.lru_cache(maxsize=16)
def _sponge_tensors(pm_bytes, dt, tau, rf_cutoff, ptop, dtype, device):
    pm = np.frombuffer(pm_bytes, np.float64).copy()
    sday = 86400.0
    rf = np.where(
        pm < rf_cutoff,
        dt / (tau * sday)
        * np.sin(0.5 * np.pi * np.log(rf_cutoff / np.maximum(pm, ptop))
                 / np.log(rf_cutoff / ptop)) ** 2,
        0.0)
    return tuple(torch.as_tensor(a, dtype=dtype, device=device).reshape(
        1, -1, 1, 1) for a in (rf, pm))


def _sponge_rates(pm, cfg, ptop, like):
    """rf(k) = dt/tau * sin^2(pi/2 * ln(cutoff/p)/ln(cutoff/ptop)) above
    rf_cutoff, 0 below (Rayleigh_Super:953, Rayleigh_Friction:1126), and
    pm(k), as [1, K, 1, 1] tensors of like's dtype on its device: built
    in float64 once for each profile, config and device, then reused."""
    pm = np.ascontiguousarray(pm, np.float64)
    return _sponge_tensors(pm.tobytes(), cfg.dt, cfg.tau, cfg.rf_cutoff,
                           float(ptop), like.dtype, like.device)


def rayleigh_super(u, v, w, u0, v0, ak, bk, cfg, ptop):
    """Ideal-case Rayleigh sponge (fv_dynamics.F90 Rayleigh_Super:953):
    relax u, v toward the reference winds u0, v0 (and damp w) above
    rf_cutoff with the rf(k) profile. Returns (u, v, w)."""
    rfk, _ = _sponge_rates(_ref_pressure(ak, bk), cfg, ptop, u)
    u = (u + rfk * u0) / (1.0 + rfk)
    v = (v + rfk * v0) / (1.0 + rfk)
    if w is not None:
        w = w / (1.0 + rfk)
    return u, v, w


def rayleigh_friction(u, v, w, pt, delz, pm, cfg, ptop, g,
                      hydrostatic=True, conserve=True):
    """Real-case Rayleigh friction (fv_dynamics.F90 Rayleigh_Friction:1126):
    amplitude-dependent drag above rf_cutoff at the rate
    rf(k)*sqrt(|V|^2/u000), applied to the D winds through staggered
    averages of the A-grid speed field, the lost kinetic energy returned
    as heat when conserve (cp or cv, with the delz rescale on the
    nonhydrostatic path). pm: [K] layer reference pressures; pt is
    TEMPERATURE. Returns (u, v, w, pt, delz)."""
    u000 = 4900.0
    rfk, pmk = _sponge_rates(pm, cfg, ptop, u)
    ua, va = cubed_to_latlon(u, v, g)
    u2f = ua * ua + va * va
    if not hydrostatic and w is not None:
        u2f = u2f + w * w
    if conserve:
        fac = 1.0 - 1.0 / (1.0 + rfk * torch.sqrt(u2f / u000)) ** 2
        if hydrostatic:
            pt = pt + 0.5 * u2f / (con.CP_AIR - con.RDGAS * ptop / pmk) * fac
        else:
            heat = 0.5 * u2f / (con.CP_AIR - con.RDGAS) * fac
            delz = delz / pt * (pt + heat)
            pt = pt + heat
    # the damping coefficient field, halo-padded for the staggered averages
    n = u.shape[-1]
    c = g.halo.pad_cell(rfk * torch.sqrt(u2f / u000))
    cy = c[..., H - 1:H + n + 1, H:H + n]        # cells j-1..n for y-walls
    u = u / (1.0 + 0.5 * (cy[..., :-1, :] + cy[..., 1:, :]))
    cx = c[..., H:H + n, H - 1:H + n + 1]        # cells i-1..n for x-walls
    v = v / (1.0 + 0.5 * (cx[..., :, :-1] + cx[..., :, 1:]))
    if not hydrostatic and w is not None:
        w = w / (1.0 + c[..., H:-H, H:-H])
    return u, v, w, pt, delz


def _moist_physics(pt, delp, delz, q, w, cfg, ptop, mp_cfg, hydrostatic):
    """neg_adj3 with the six GFDL-MP categories, then gfdl_mp_driver when
    mp_cfg is given (fv_dynamics.F90:724, the intermediate_phys hook).
    Returns (pt, q, w, mp_diag)."""
    if not (q and not cfg.adiabatic and "liq_wat" in q):
        return pt, q, w, None
    pt, q = fv_sg.neg_adj3(pt, delp, q, delz=delz, hydrostatic=hydrostatic)
    if mp_cfg is None:
        return pt, q, w, None
    pt, q, mp_diag = gfdl_mp.gfdl_mp_driver(
        pt, delp, delz, q, cfg.dt, ptop, cfg=mp_cfg, hydrostatic=hydrostatic,
        w=w)
    return pt, q, mp_diag.pop("w", w), mp_diag


def _sponge(u, v, w, pt, delz, u0, v0, ak, bk, cfg, ptop, g, hydrostatic):
    """The sponge at the top of a big step (fv_dynamics.F90:369-370): with
    tau > 0 and rf_fast off, Rayleigh_Super toward u0, v0 when given, else
    the real-case Rayleigh friction unless the case is ideal (rf_fast damps
    inside the acoustic loop instead). pt is TEMPERATURE. Returns (u, v,
    w, pt, delz, whether pt changed)."""
    if not (cfg.tau > 0.0 and not cfg.rf_fast):
        return u, v, w, pt, delz, False
    if u0 is not None:
        u, v, w = rayleigh_super(u, v, w, u0, v0, ak, bk, cfg, ptop)
        return u, v, w, pt, delz, False
    if cfg.is_ideal_case:
        return u, v, w, pt, delz, False
    u, v, w, pt, delz = rayleigh_friction(
        u, v, w, pt, delz, _ref_pressure(ak, bk), cfg, ptop, g,
        hydrostatic=hydrostatic)
    return u, v, w, pt, delz, True


def fv_dynamics_nh(delp, pt, u, v, w, delz, q, g, cfg: DynConfig, ak, bk,
                   ptop, dp0, u0=None, v0=None, mp_cfg=None):
    """One big timestep of nonhydrostatic dynamics (fv_dynamics.F90,
    hydrostatic=.false.). pt in/out is TEMPERATURE; w vertical velocity
    (m/s); delz layer thickness (m, negative); q: the tracer dict (may be
    empty or None); with "sphum" in q and cfg.adiabatic False the virtual-
    temperature (zvir) path is on, and with the six GFDL-MP categories
    neg_adj3 runs, then gfdl_mp_driver when mp_cfg is given. ak, bk: [K+1]
    (numpy or tensors); dp0: the reference pressure-thickness profile;
    u0, v0: the sponge's reference winds (tau > 0). cfg.consv_te > 0 turns
    on the total-energy fixer, cfg.consv_am the angular-momentum fixer,
    cfg.do_fast_phys the inline fast physics in the acoustic loop with
    mp_cfg (dyn_core_nh's fast_cfg). Returns SimpleNamespace(delp, pt, u,
    v, w, delz, q, ps, mp_diag, omga)."""
    from .dyn_core import dyn_core_nh
    akap = con.KAPPA
    rrg = -con.RDGAS / con.GRAV
    cv_air = con.CP_AIR - con.RDGAS
    mdt = cfg.dt / cfg.k_split
    zvir = con.ZVIR if q and "sphum" in q and not cfg.adiabatic else 0.0
    aknp, bknp = ak, bk
    ak = torch.as_tensor(ak, dtype=delp.dtype, device=delp.device)
    bk = torch.as_tensor(bk, dtype=delp.dtype, device=delp.device)
    u, v = g.halo.reconcile_dgrid(u, v)
    phis = g.phis_p[..., H:-H, H:-H]

    # entry: layer p**kappa from the gas law, pt -> theta_v
    tv = pt * (1.0 + zvir * q["sphum"]) if zvir else pt
    pkz = torch.exp(akap * torch.log(rrg * delp / delz * tv))
    te0 = None
    if cfg.consv_te > 0.0:
        te0 = thermo.total_energy_2d_nh(u, v, w, tv,
                                        q["sphum"] if zvir else None,
                                        delp, delz, phis, g)
    aam0 = None
    if cfg.consv_am:
        aam0, _, _ = thermo.compute_aam(u, v, delp, g, ptop)
    u, v, w, pt, delz, heated = _sponge(u, v, w, pt, delz, u0, v0, aknp,
                                        bknp, cfg, ptop, g, False)
    if heated:
        tv = pt * (1.0 + zvir * q["sphum"]) if zvir else pt
    ptv = tv / pkz

    conv = torch.zeros_like(delp)
    for n_map in range(cfg.k_split):
        last = n_map == cfg.k_split - 1
        dp1 = delp
        res = dyn_core_nh(delp, ptv, u, v, w, delz, phis, g, cfg, akap,
                          ptop, cfg.n_split, mdt / cfg.n_split, dp0, ak=aknp,
                          bk=bknp, q=q if cfg.do_fast_phys else None,
                          fast_cfg=mp_cfg if cfg.do_fast_phys else None,
                          zvir=zvir)
        if cfg.do_fast_phys and res.q is not None:
            q = res.q
        conv = conv + _mass_convergence(res.mfx, res.mfy, g)
        if q:
            q, _ = tracer.tracer_2d(q, dp1, res.mfx, res.mfy, res.cx,
                                    res.cy, g, hord_tr=cfg.hord_tr,
                                    q_split=cfg.q_split if cfg.use_scan
                                    else max(1, cfg.q_split))
        rm = remap_nh(res.delp, res.pt, res.u, res.v, res.w, res.delz,
                      res.ws, q, res.pe, res.peln, ak, bk, g, cfg, akap,
                      last, kord_wz=cfg.kord_wz)
        delp, u, v, w, delz = rm.delp, rm.u, rm.v, rm.w, rm.delz
        q = rm.q
        if last:
            pt = rm.tv
            if te0 is not None:
                te1 = thermo.total_energy_2d_nh(
                    u, v, w, rm.tv, q["sphum"] if zvir else None, delp,
                    delz, phis, g)
                dtmp = thermo.energy_fixer_dtmp(
                    te0, te1, rm.pkz, delp, rm.pk2, ptop, cfg.consv_te, g,
                    hydrostatic=False, reproduce=cfg.reproduce_sum)
                pt = rm.tv + (dtmp / cv_air) * rm.pkz
            if zvir:
                pt = pt / (1.0 + zvir * q["sphum"])
        else:
            ptv = rm.tv / rm.pkz

    pt, q, w, mp_diag = _moist_physics(pt, delp, delz, q, w, cfg, ptop,
                                       mp_cfg, hydrostatic=False)
    if cfg.consv_am:
        u, v, _ = thermo.am_fixer(u, v, delp, aam0, g, ptop,
                                  reproduce=cfg.reproduce_sum)

    return SimpleNamespace(delp=delp, pt=pt, u=u, v=v, w=w, delz=delz,
                           q=q, ps=rm.ps, mp_diag=mp_diag,
                           omga=_omega(conv, cfg.dt))


def fv_dynamics_hydro(delp, pt, u, v, q, g, cfg: DynConfig, ak, bk, ptop,
                      u0=None, v0=None, mp_cfg=None):
    """One big timestep of hydrostatic dynamics (fv_dynamics.F90,
    hydrostatic=.true.). pt in/out is TEMPERATURE; q: the tracer dict (may
    be empty or None); with "sphum" in q and cfg.adiabatic False the
    virtual-temperature (zvir) path is on, and with the six GFDL-MP
    categories neg_adj3 runs, then gfdl_mp_driver when mp_cfg is given.
    ak, bk: [K+1] (numpy or tensors); u0, v0: the sponge's reference winds
    (tau > 0). cfg.consv_te > 0 turns on the total-energy fixer,
    cfg.consv_am the angular-momentum fixer. Returns
    SimpleNamespace(delp, pt, u, v, q, ps, mp_diag, omga)."""
    from .dyn_core import dyn_core_hydro
    akap = con.KAPPA
    mdt = cfg.dt / cfg.k_split
    zvir = con.ZVIR if q and "sphum" in q and not cfg.adiabatic else 0.0
    aknp, bknp = ak, bk
    ak = torch.as_tensor(ak, dtype=delp.dtype, device=delp.device)
    bk = torch.as_tensor(bk, dtype=delp.dtype, device=delp.device)
    u, v = g.halo.reconcile_dgrid(u, v)
    phis = g.phis_p[..., H:-H, H:-H]

    # entry pressures and pt -> theta_v (fv_dynamics.F90:275-399)
    pe = thermo.interface_pressure(delp, ptop)
    peln = torch.log(pe)
    pk = torch.exp(akap * peln)
    pkz = (pk[:, 1:] - pk[:, :-1]) / (akap * (peln[:, 1:] - peln[:, :-1]))
    tv = pt * (1.0 + zvir * q["sphum"]) if zvir else pt
    te0 = None
    if cfg.consv_te > 0.0:
        te0 = thermo.total_energy_2d_hydro(u, v, tv, delp, peln, pe, phis,
                                           g)
    aam0 = None
    if cfg.consv_am:
        aam0, _, _ = thermo.compute_aam(u, v, delp, g, ptop)
    u, v, _, pt, _, heated = _sponge(u, v, None, pt, None, u0, v0, aknp,
                                     bknp, cfg, ptop, g, True)
    if heated:
        tv = pt * (1.0 + zvir * q["sphum"]) if zvir else pt
    ptv = tv / pkz

    conv = torch.zeros_like(delp)
    for n_map in range(cfg.k_split):
        last = n_map == cfg.k_split - 1
        dp1 = delp
        res = dyn_core_hydro(delp, ptv, u, v, phis, g, cfg, akap, ptop,
                             cfg.n_split, mdt / cfg.n_split, ak=aknp,
                             bk=bknp)
        conv = conv + _mass_convergence(res.mfx, res.mfy, g)
        if q:
            q, _ = tracer.tracer_2d(q, dp1, res.mfx, res.mfy, res.cx,
                                    res.cy, g, hord_tr=cfg.hord_tr,
                                    q_split=cfg.q_split if cfg.use_scan
                                    else max(1, cfg.q_split))
        rm = remap_hydro(res.delp, res.pt, res.u, res.v, q, res.pe,
                         res.peln, res.pkz, ak, bk, g, cfg, akap, last)
        delp, u, v, q = rm.delp, rm.u, rm.v, rm.q
        if last:
            pt = rm.tv
            if te0 is not None:
                peln_i = torch.log(ak.reshape(1, -1, 1, 1)
                                   + bk.reshape(1, -1, 1, 1)
                                   * rm.ps[:, None])
                te1 = thermo.total_energy_2d_hydro(
                    u, v, rm.tv, delp, peln_i, torch.exp(peln_i), phis, g)
                dtmp = thermo.energy_fixer_dtmp(
                    te0, te1, rm.pkz, delp, rm.pk2, ptop, cfg.consv_te, g,
                    hydrostatic=True, reproduce=cfg.reproduce_sum)
                pt = rm.tv + (dtmp / con.CP_AIR) * rm.pkz
            if zvir:
                pt = pt / (1.0 + zvir * q["sphum"])
        else:
            ptv = rm.tv / rm.pkz

    pt, q, _, mp_diag = _moist_physics(pt, delp, None, q, None, cfg, ptop,
                                       mp_cfg, hydrostatic=True)
    if cfg.consv_am:
        u, v, _ = thermo.am_fixer(u, v, delp, aam0, g, ptop,
                                  reproduce=cfg.reproduce_sum)
    return SimpleNamespace(delp=delp, pt=pt, u=u, v=v, q=q, ps=rm.ps,
                           mp_diag=mp_diag, omga=_omega(conv, cfg.dt))
