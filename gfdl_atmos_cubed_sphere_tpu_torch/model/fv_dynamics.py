"""Nonhydrostatic FV3 dynamics driver: the k_split remap loop over the
acoustic core, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/model/fv_dynamics.py
(fv_dynamics_nh, remap_nh; FV3 model/fv_dynamics.F90 and the
nonhydrostatic branch of model/fv_mapz.F90 Lagrangian_to_Eulerian:56) for
the dry adiabatic step: tracers (q), moist physics, the Rayleigh sponges
and the energy / angular-momentum fixers are not ported and raise
NotImplementedError.

State carried between calls: u, v (D winds), delp, pt = TEMPERATURE, w
(m/s), delz (m, negative). Inside the step pt becomes virtual potential
temperature and is converted back on the last remap.
"""

from types import SimpleNamespace

import torch

from .. import constants as con
from ..ops import fv_mapz
from ..ops.sw_core import _rl, _cl
from ..ops.fill_corners import fi
from .dyn_core import DynConfig

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


def remap_nh(delp, ptv, u, v, w, delz, ws, pe_pad, peln_pad, ak, bk, g,
             cfg, akap, kord_wz=9):
    """Nonhydrostatic vertical remap (fv_mapz.F90 Lagrangian_to_Eulerian,
    hydrostatic=.false., kord_tm<0): theta_v -> T_v through the gas law,
    T_v remapped on log-p, w with the ws bottom value (iv=-2), delz as
    specific volume, the winds on pe. ak, bk: [K+1] tensors."""
    f = fi
    npx = g.npx
    n = g.n
    ctr = slice(H, H + n)
    wsl = slice(f(1), f(npx) + 1)
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

    pe_u0 = _k_last(0.5 * (pe_pad[..., wsl, ctr] + _rl(pe_pad)[..., wsl, ctr]))
    pe_u1 = akl + bkl * pe_u0[..., -1:]
    u_new = fv_mapz.map1_ppm(_k_last(u), pe_u0, pe_u1, iv=-1,
                             kord=abs(cfg.kord_mt))
    pe_v0 = _k_last(0.5 * (pe_pad[..., ctr, wsl] + _cl(pe_pad)[..., ctr, wsl]))
    pe_v1 = akl + bkl * pe_v0[..., -1:]
    v_new = fv_mapz.map1_ppm(_k_last(v), pe_v0, pe_v1, iv=-1,
                             kord=abs(cfg.kord_mt))

    delp_k = _k_lev(dp2)
    tvk = _k_lev(tv_new)
    pkz_new = torch.exp(akap * torch.log(rrg * delp_k / delz_new * tvk))
    return SimpleNamespace(delp=delp_k, tv=tvk, u=_k_lev(u_new),
                           v=_k_lev(v_new), w=_k_lev(w_new), delz=delz_new,
                           pkz=pkz_new, pk2=_k_lev(pk2), ps=ps[..., 0])


def _check_dry(q, cfg):
    unsupported = {
        "tracers (a non-empty q)": bool(q),
        "consv_te > 0 (energy fixer)": cfg.consv_te > 0.0,
        "consv_am (angular-momentum fixer)": cfg.consv_am,
        "tau > 0 (Rayleigh sponges)": cfg.tau > 0.0,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError("fv_dynamics_nh: not ported: "
                                  + ", ".join(bad))


def fv_dynamics_nh(delp, pt, u, v, w, delz, q, g, cfg: DynConfig, ak, bk,
                   ptop, dp0):
    """One big timestep of dry nonhydrostatic dynamics (fv_dynamics.F90,
    hydrostatic=.false.). pt in/out is TEMPERATURE; w vertical velocity
    (m/s); delz layer thickness (m, negative); q must be empty. ak, bk:
    [K+1] (numpy or tensors); dp0: the reference pressure-thickness
    profile. Returns SimpleNamespace(delp, pt, u, v, w, delz, q, ps,
    omga)."""
    from .dyn_core import dyn_core_nh
    _check_dry(q, cfg)
    akap = con.KAPPA
    rrg = -con.RDGAS / con.GRAV
    mdt = cfg.dt / cfg.k_split
    ak = torch.as_tensor(ak, dtype=delp.dtype, device=delp.device)
    bk = torch.as_tensor(bk, dtype=delp.dtype, device=delp.device)
    u, v = g.halo.reconcile_dgrid(u, v)

    # entry: layer p**kappa from the gas law, pt -> theta_v
    pkz = torch.exp(akap * torch.log(rrg * delp / delz * pt))
    ptv = pt / pkz

    conv = torch.zeros_like(delp)
    for n_map in range(cfg.k_split):
        last = n_map == cfg.k_split - 1
        res = dyn_core_nh(delp, ptv, u, v, w, delz, g, cfg, akap, ptop,
                          cfg.n_split, mdt / cfg.n_split, dp0)
        conv = conv + _mass_convergence(res.mfx, res.mfy, g)
        rm = remap_nh(res.delp, res.pt, res.u, res.v, res.w, res.delz,
                      res.ws, res.pe, res.peln, ak, bk, g, cfg, akap,
                      kord_wz=cfg.kord_wz)
        delp, u, v, w, delz = rm.delp, rm.u, rm.v, rm.w, rm.delz
        if last:
            pt = rm.tv         # no energy fixer: the dry adiabatic step
        else:
            ptv = rm.tv / rm.pkz

    return SimpleNamespace(delp=delp, pt=pt, u=u, v=v, w=w, delz=delz,
                           q=q, ps=rm.ps, omga=_omega(conv, cfg.dt))
