"""The PyTorch port's acoustic-loop options (model/dyn_core.py) against the
JAX package at C12L10 (float64, CPU, inputs from numpy seeds):

- the operators, each to 1e-12 x max|ref|: grad1_p_update (beta > 0) with
  the external-mode potential of external_mode_divg2 (d_ext > 0),
  one_grad_p with that potential, split_p_grad, mix_dp (fill_dp) in both
  forms on a state with layers under their floors, ray_fast_profile and
  ray_fast (rf_fast);
- one whole nonhydrostatic big step with the off-centred bundle (a_imp =
  0.75, beta = 0.45, fill_dp, rf_fast at tau = 5 days under a 600 hPa
  cutoff, use_logp, d2bg_zq = 0.01, kord_mt, kord_wz = 10, kord_tm = -10)
  and one hydrostatic step with beta = 0.45, d_ext = 0.02, fill_dp,
  rf_fast and kord_mt = 11, kord_tm = -11, each field to 1e-10 x its max.

The JAX references are jitted once each; on the CPU the port's kernel
wrappers take their plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu import constants as con
from gfdl_atmos_cubed_sphere_tpu.grid.fv_eta import set_eta
from gfdl_atmos_cubed_sphere_tpu.model import dyn_core as jdc
from gfdl_atmos_cubed_sphere_tpu.model import fv_dynamics as jfv
from gfdl_atmos_cubed_sphere_tpu.model.sw_dynamics import prepare_phis as jphis
from gfdl_atmos_cubed_sphere_tpu_torch.model import dyn_core as tdc
from gfdl_atmos_cubed_sphere_tpu_torch.model import fv_dynamics as tfv
from gfdl_atmos_cubed_sphere_tpu_torch.model.sw_dynamics import prepare_phis

import torch_slice_inputs as si

pytestmark = pytest.mark.fast

H = 3
AKAP = con.KAPPA
NPX, K = si.NPX, si.K
N = NPX - 1
DT = 1800.0
# the inline Rayleigh damping as JAX's tests/test_mix_ray.py runs it: the
# C12L10 coordinate tops at 500 hPa, so the cutoff sits at 600 hPa
RF = dict(rf_fast=True, tau=5.0, rf_cutoff=600.e2)
NH_BUNDLE = dict(hydrostatic=False, adiabatic=True, k_split=1, n_split=2,
                 dddmp=0.2, d_con=1.0, do_vort_damp=True, a_imp=0.75,
                 beta=0.45, fill_dp=True, use_logp=True, d2bg_zq=0.01,
                 kord_mt=10, kord_tr=10, kord_wz=10, kord_tm=-10, **RF)
HYDRO_BUNDLE = dict(hydrostatic=True, adiabatic=True, k_split=1, n_split=2,
                    beta=0.45, d_ext=0.02, fill_dp=True, kord_mt=10,
                    kord_tr=10, kord_tm=-10, **RF)


@pytest.fixture(scope="module")
def case():
    gj, gt, ptop, ak, bk, ic = si.packs()
    jphis(gj, ic["phis"])
    prepare_phis(gt, ic["phis"])
    st, _ = si.seeded_state(ic, seed=5)
    return gj, gt, ptop, ak, bk, st


def test_acoustic_option_operators(case):
    gj, gt, ptop, ak, bk, st = case
    rng = np.random.default_rng(11)
    P, W = N + 2 * H, N + 1 + 2 * H
    delp_p = np.asarray(gj.halo.pad_cell(jnp.asarray(st["delp"])))
    pt_p = np.asarray(gj.halo.pad_cell(jnp.asarray(
        300.0 * (1 + 0.02 * rng.standard_normal(st["delp"].shape)))))
    ops = dict(
        delp_p=delp_p, pt_p=pt_p,
        divg_p=1e-6 * rng.standard_normal((6, K, W, W)),
        u_acc=1e6 * rng.standard_normal((6, K, N + 1, N)),
        v_acc=1e6 * rng.standard_normal((6, K, N, N + 1)),
        du_old=rng.standard_normal((6, K, N + 1, N)),
        dv_old=rng.standard_normal((6, K, N, N + 1)),
        pp=50.0 * rng.standard_normal((6, K + 1, P, P)),
        w=rng.standard_normal((6, K, N, N)))
    # layers under their floors (1 % of the reference thickness), the top
    # and the bottom level among them
    dpmin = 0.01 * (np.diff(ak) + np.diff(bk) * 1.e5)
    thin = rng.uniform(size=st["delp"].shape) < 0.1
    ops["delp_thin"] = np.where(thin, 0.3 * dpmin[None, :, None, None],
                                st["delp"])
    assert thin[:, 0].any() and thin[:, -1].any()
    ptk = ptop ** AKAP
    dt = DT / 2
    # the ray_fast profile of a deep coordinate with pure-pressure levels
    _, ptop79, ak79, bk79 = set_eta(79)
    rfp = jdc.ray_fast_profile(ak79, bk79, dt, 5.0, 30.e2, ptop79)
    assert rfp[3] > 0 and (rfp[0] < 1.0).any()
    u79 = rng.standard_normal((6, 79, N + 1, N))
    v79 = rng.standard_normal((6, 79, N, N + 1))
    w79 = rng.standard_normal((6, 79, N, N))

    def jax_ops(o):
        geo = jdc.geopk(o["delp_p"], o["pt_p"], gj.phis_p, AKAP, ptop)
        pk, gz = geo[2], geo[3]
        divg2 = jdc.external_mode_divg2(o["delp_p"], o["divg_p"], gj, 0.02,
                                        NPX)
        g1 = jdc.grad1_p_update(o["u_acc"], o["v_acc"], pk, gz, gj, dt,
                                NPX, ptk, o["du_old"], o["dv_old"], 0.45,
                                divg2=divg2)
        og = jdc.one_grad_p(o["u_acc"], o["v_acc"], pk, gz, gj, dt, NPX, ptk,
                            divg2=divg2)
        sp = jdc.split_p_grad(o["u_acc"], o["v_acc"], o["pp"], pk, gz,
                              o["delp_p"], gj, dt, NPX, ptk, o["du_old"],
                              o["dv_old"], 0.45)
        mh = jdc.mix_dp(o["delp_thin"], st["pt"], None, dpmin)[:2]
        mn = jdc.mix_dp(o["delp_thin"], st["pt"], o["w"], dpmin,
                        hydrostatic=False)
        rf = jdc.ray_fast(o["u79"], o["v79"], o["w79"], *rfp,
                          hydrostatic=False)
        return dict(pk=pk, gz=gz, divg2=divg2, grad1=g1, one=og, split=sp,
                    mix_hydro=mh, mix_nh=mn, ray=rf)

    want = jax.jit(jax_ops)(dict(ops, u79=u79, v79=v79, w79=w79))
    t = {k: torch.as_tensor(np.array(v)) for k, v in ops.items()}
    pk, gz = (torch.as_tensor(np.array(want[k])) for k in ("pk", "gz"))
    divg2 = tdc.external_mode_divg2(t["delp_p"], t["divg_p"], gt, 0.02, NPX)
    got = dict(
        divg2=divg2,
        grad1=tdc.grad1_p_update(t["u_acc"], t["v_acc"], pk, gz, gt, dt,
                                 NPX, ptk, t["du_old"], t["dv_old"], 0.45,
                                 divg2=divg2),
        one=tdc.one_grad_p(t["u_acc"], t["v_acc"], pk, gz, gt, dt, NPX, ptk,
                           divg2=divg2),
        split=tdc.split_p_grad(t["u_acc"], t["v_acc"], t["pp"], pk, gz,
                               t["delp_p"], gt, dt, NPX, ptk, t["du_old"],
                               t["dv_old"], 0.45),
        mix_hydro=tdc.mix_dp(t["delp_thin"], torch.as_tensor(st["pt"]),
                             None, dpmin)[:2],
        mix_nh=tdc.mix_dp(t["delp_thin"], torch.as_tensor(st["pt"]), t["w"],
                          dpmin, hydrostatic=False),
        ray=tdc.ray_fast(*map(torch.as_tensor, (u79, v79, w79)),
                         *tdc.ray_fast_profile(ak79, bk79, dt, 5.0, 30.e2,
                                               ptop79), hydrostatic=False))
    for a, b in zip(rfp, tdc.ray_fast_profile(ak79, bk79, dt, 5.0, 30.e2,
                                              ptop79)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for nm, outs in got.items():
        ref = want[nm]
        pairs = zip(ref, outs) if isinstance(ref, (tuple, list)) else [
            (ref, outs)]
        for i, (a, b) in enumerate(pairs):
            si.close(b, a, 1e-12, f"{nm} {i}")
    # mix_dp keeps each column's mass
    np.testing.assert_allclose(got["mix_nh"][0].numpy().sum(1),
                               ops["delp_thin"].sum(1), rtol=1e-13)


def _fields(hydro):
    return ("delp", "pt", "u", "v") + (() if hydro else ("w", "delz"))


@pytest.mark.parametrize("hydro", [False, True])
def test_fv_dynamics_option_bundle(case, hydro):
    """One big step of each path with its bundle of options against the
    jitted JAX step."""
    gj, gt, ptop, ak, bk, st = case
    names = _fields(hydro)
    over = HYDRO_BUNDLE if hydro else NH_BUNDLE
    cfg = dict(npx=NPX, npz=K, dt=DT, **over)
    dp0 = np.diff(ak) + np.diff(bk) * 1.0e5
    aj, bj = jnp.asarray(ak), jnp.asarray(bk)

    def jstep(*a):
        if hydro:
            r = jfv.fv_dynamics_hydro(*a, None, gj, jdc.DynConfig(**cfg), aj,
                                      bj, ptop)
        else:
            r = jfv.fv_dynamics_nh(*a, None, gj, jdc.DynConfig(**cfg), aj,
                                   bj, ptop, dp0)
        return tuple(getattr(r, k) for k in names)

    want = jax.jit(jstep)(*(jnp.asarray(st[k]) for k in names))
    t = si.t64_dict({k: st[k] for k in names})
    step = tfv.fv_dynamics_hydro if hydro else tfv.fv_dynamics_nh
    args = ((*(t[k] for k in names), {}, gt, tdc.DynConfig(**cfg), ak, bk,
             ptop) + (() if hydro else (dp0,)))
    got = step(*args)
    for nm, a in zip(names, want):
        assert np.isfinite(np.asarray(a)).all(), nm
        si.close(getattr(got, nm), a, 1e-10, nm)
