"""Shallow-water dynamical core (the reference's -DSW_DYNAMICS build),
PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/model/sw_dynamics.py. Runs the
acoustic-loop structure of FV3 model/dyn_core.F90 for the single-layer
shallow-water system: per iteration
  c_sw (C-grid half step) -> SW geopk (gz = phis + delp, akap = 1) ->
  p_grad_c (:1635) -> halo(uc, vc) -> d_sw (D-grid full step) -> SW geopk
  -> one_grad_p (:1909).
In SW mode delp holds the geopotential thickness g*h, pt == 1, akap == 1,
ptop == 0. On a CUDA pack each iteration launches the tp2d_sweep kernel
twice (delp and vorticity transport in d_sw), the ke_section kernel once
and the a2b_ord4 kernel three times (one_grad_p).

State is unpadded [6, npz, ...]; halos are materialised transiently by the
gather exchange (parallel/halo.py) where the reference posts its halo
updates.
"""

from dataclasses import dataclass
from types import SimpleNamespace

import torch

from ..ops import sw_core
from ..ops.sw_core import _cl, _cr, _rl, _rr
from ..ops.a2b_edge import a2b_ord4
from ..ops.fill_corners import fi

H = 3


@dataclass(frozen=True)
class SWConfig:
    """Shallow-water subset of fv_core_nml (fv_arrays.F90:207-906 defaults)."""
    npx: int
    dt: float                  # big (physics) timestep
    n_split: int = 6
    k_split: int = 1
    hord_mt: int = 6
    hord_vt: int = 6
    hord_dp: int = 6
    nord: int = 1              # divergence damping order (1 = del-4)
    dddmp: float = 0.0         # Smagorinsky coefficient
    d2_bg: float = 0.0
    d4_bg: float = 0.16
    do_vort_damp: bool = False
    vtdm4: float = 0.0
    d_con: float = 0.0
    lim_fac: float = 1.0
    advection_only: bool = False   # Williamson case 1


def prepare_phis(g, phis):
    """Attach the halo-padded static surface geopotential to the grid pack."""
    g.phis_p = g.halo.pad_cell(torch.as_tensor(phis, dtype=g.dtype,
                                               device=g.device))
    return g


def _p_grad_c_sw(uc, vc, delpc_p, phis_p, g, dt2):
    """C-grid pressure gradient, SW form (dyn_core.F90 p_grad_c:1635 with
    gz = phis + delpc, pkc = (0, delpc) since akap=1, ptop=0). gz2 (the
    bottom) pairs with pk2(i), gz1 (top) with pk2(i-1) (dyn_core.F90:1684)."""
    npx = g.npx
    f = fi
    gz1 = phis_p + delpc_p
    gz2 = phis_p
    pk2 = delpc_p
    wall_c = slice(f(1), f(npx) + 1)
    cell_c = slice(f(1), f(npx - 1) + 1)
    termx = ((_cl(gz2) - _cr(gz1)) * _cr(pk2) + (_cl(gz1) - _cr(gz2)) * _cl(pk2))
    uc = uc.clone()
    uc[..., cell_c, wall_c] += (dt2 * g.rdxc * termx / (_cl(delpc_p)
                                + _cr(delpc_p)))[..., cell_c, wall_c]
    termy = ((_rl(gz2) - _rr(gz1)) * _rr(pk2) + (_rl(gz1) - _rr(gz2)) * _rl(pk2))
    vc = vc.clone()
    vc[..., wall_c, cell_c] += (dt2 * g.rdyc * termy / (_rl(delpc_p)
                                + _rr(delpc_p)))[..., wall_c, cell_c]
    return uc, vc


def _one_grad_p_sw(u_acc, v_acc, delp_p, phis_p, g, dt):
    """D-grid pressure gradient, SW hydrostatic one_grad_p
    (dyn_core.F90:1909): pk = pe = delp (akap=1, ptop=0) interpolated to
    corners by a2b_ord4, gz likewise; returns the final D winds (d_sw
    carried u in u*dx form)."""
    npx = g.npx
    n = g.n
    f = fi
    ctr = slice(H, H + n)
    wsl = slice(f(1), f(npx) + 1)
    pkB = a2b_ord4(delp_p, g)                    # pe**kappa at corners, top=0
    gzB1 = a2b_ord4(phis_p + delp_p, g)
    gzB2 = a2b_ord4(phis_p, g)
    wk = pkB                                     # pk(k+1) - pk(k)

    cl_ = slice(f(1), f(npx - 1) + 1)            # corner i
    cr_ = slice(f(2), f(npx) + 1)                # corner i+1
    u_new = g.rdx[..., wsl, ctr] * (u_acc + dt / (
        wk[..., wsl, cl_] + wk[..., wsl, cr_]) * (
        (gzB2[..., wsl, cl_] - gzB1[..., wsl, cr_]) * pkB[..., wsl, cr_]
        + (gzB1[..., wsl, cl_] - gzB2[..., wsl, cr_]) * pkB[..., wsl, cl_]))
    v_new = g.rdy[..., ctr, wsl] * (v_acc + dt / (
        wk[..., cl_, wsl] + wk[..., cr_, wsl]) * (
        (gzB2[..., cl_, wsl] - gzB1[..., cr_, wsl]) * pkB[..., cr_, wsl]
        + (gzB1[..., cl_, wsl] - gzB2[..., cr_, wsl]) * pkB[..., cl_, wsl]))
    return u_new, v_new


def sw_acoustic_iteration(state, g, cfg: SWConfig, dt):
    """One n_split iteration of the SW dyn_core."""
    halo = g.halo
    dt2 = 0.5 * dt
    delp_p = halo.pad_cell(state.delp)
    pt_p = torch.ones_like(delp_p)
    phis_p = g.phis_p

    if cfg.advection_only:
        # winds are held fixed on the C grid (test case 1); only transport
        ds = sw_core.d_sw(
            delp_p, pt_p, None, None, None, state.uc, state.vc, None, None,
            None, g, dt=dt, hord_mt=cfg.hord_mt, hord_vt=cfg.hord_vt,
            hord_dp=cfg.hord_dp, hord_tm=cfg.hord_dp, nord=cfg.nord,
            nord_v=min(2, cfg.nord), dddmp=cfg.dddmp, d2_bg=cfg.d2_bg,
            d4_bg=cfg.d4_bg, damp_v=0.0, sw_mode=True, advection_only=True,
            lim_fac=cfg.lim_fac)
        state.delp = ds.delp
        return state

    u_p, v_p = halo.pad_dgrid(state.u, state.v)
    cs = sw_core.c_sw(delp_p, pt_p, None, u_p, v_p, g, dt2,
                      hydrostatic=True, nord=cfg.nord, sw_mode=True)
    uc, vc = _p_grad_c_sw(cs.uc, cs.vc, cs.delpc, phis_p, g, dt2)

    # exchange C-grid winds (i_pack(9), CGRID_NE) and divergence (CORNER)
    npx = g.npx
    f = fi
    ctr = slice(H, H + g.n)
    wsl = slice(f(1), f(npx) + 1)
    uc_p, vc_p = halo.pad_cgrid(uc[..., ctr, wsl], vc[..., wsl, ctr])
    divg_p = None
    if cfg.nord > 0:
        divg_p = halo.pad_corner(cs.divg_d[..., wsl, wsl])

    damp_vt = cfg.vtdm4 if cfg.do_vort_damp else 0.0
    ds = sw_core.d_sw(
        delp_p, pt_p, None, u_p, v_p, uc_p, vc_p, cs.ua, cs.va, divg_p, g,
        dt=dt, hord_mt=cfg.hord_mt, hord_vt=cfg.hord_vt, hord_dp=cfg.hord_dp,
        hord_tm=cfg.hord_dp, nord=cfg.nord, nord_v=min(2, cfg.nord),
        dddmp=cfg.dddmp, d2_bg=cfg.d2_bg, d4_bg=cfg.d4_bg, damp_v=damp_vt,
        d_con=cfg.d_con, sw_mode=True, lim_fac=cfg.lim_fac)

    # D-grid pressure gradient on the updated delp
    delp_new_p = halo.pad_cell(ds.delp)
    u_new, v_new = _one_grad_p_sw(ds.u, ds.v, delp_new_p, phis_p, g, dt)
    state.delp = ds.delp
    state.u = u_new
    state.v = v_new
    return state


def make_sw_step(g, cfg: SWConfig):
    """Big-timestep function (delp, u, v, uc, vc) -> (delp, u, v) on the
    device of the pack `g`; the acoustic iterations run as a Python loop
    (the JAX package's lax.scan)."""
    dt = cfg.dt / (cfg.n_split * cfg.k_split)
    nsteps = cfg.n_split * cfg.k_split

    def step(delp, u, v, uc, vc):
        if cfg.advection_only:
            st = SimpleNamespace(delp=delp, u=None, v=None, uc=uc, vc=vc)
            for _ in range(nsteps):
                st = sw_acoustic_iteration(st, g, cfg, dt)
            return st.delp, u, v
        u, v = g.halo.reconcile_dgrid(u, v)
        st = SimpleNamespace(delp=delp, u=u, v=v, uc=None, vc=None)
        for _ in range(nsteps):
            st = sw_acoustic_iteration(st, g, cfg, dt)
        u, v = g.halo.reconcile_dgrid(st.u, st.v)
        return st.delp, u, v

    return step
