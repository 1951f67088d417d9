"""The PyTorch port's dry nonhydrostatic big step (model/fv_dynamics.py
fv_dynamics_nh, q = {}, k_split = 1, n_split = 2, with its vertical remap)
against the jitted JAX fv_dynamics_nh on the perturbed dry Jablonowski-
Williamson state at C12L10 (float64, CPU, <= 1e-10 x field max on delp,
pt, u, v, w and delz). The k_split = 2 remap loop runs in
test_torch_fv_dynamics_moist.py; one remap keeps this file's JAX compile
short. The same step with the inline fast physics (do_fast_phys with
MPConfig(): the mp_fast chain in each acoustic iteration, then neg_adj3 and
the GFDL MP) on the moist wave with a supersaturated boundary layer, alone
and with the inline Rayleigh damping (rf_fast, tau 5): every field and
tracer at 1e-10 of its maximum. One jitted JAX function runs the dry step
and both fast-physics steps (one compile for the file).

The boundary layer holds 0.03 kg/kg of sphum times seeded noise of +-2 %
(JAX's tests/test_gfdl_mp.py sets 0.03 at every point): a field constant
across the cube puts tracer_2d's PPM limiters on exact ties, where 1-ulp
changes of the input move JAX's own step by 1.7e-4 of sphum and 2.7e-6 of
pt, and the noise by 2e-15 (python devtools/pbl_conditioning.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu.grid.fv_eta import set_eta
from gfdl_atmos_cubed_sphere_tpu.init.baroclinic import jw_baroclinic
from gfdl_atmos_cubed_sphere_tpu.model.dyn_core import DynConfig as JCfg
from gfdl_atmos_cubed_sphere_tpu.model.fv_dynamics import fv_dynamics_nh as jfv
from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops as jax_pack
from gfdl_atmos_cubed_sphere_tpu.model.sw_dynamics import prepare_phis as jphis
from gfdl_atmos_cubed_sphere_tpu.physics.gfdl_mp import MPConfig as JMP
from gfdl_atmos_cubed_sphere_tpu_torch.model.dyn_core import DynConfig
from gfdl_atmos_cubed_sphere_tpu_torch.model.fv_dynamics import fv_dynamics_nh
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import (
    build_grid_ops, state_from_arrays)
from gfdl_atmos_cubed_sphere_tpu_torch.model.sw_dynamics import prepare_phis
from gfdl_atmos_cubed_sphere_tpu_torch.physics.gfdl_mp import MPConfig
from torch_slice_inputs import close

pytestmark = pytest.mark.fast

NPX, K = 13, 10
CFG = dict(npx=NPX, npz=K, dt=1800.0, hydrostatic=False, adiabatic=True,
           k_split=1, n_split=2, dddmp=0.2, d_con=1.0, do_vort_damp=True)
NAMES = ("delp", "pt", "u", "v", "w", "delz")


#: the fast-physics steps: the file's step, moist at dt = 600 s (JAX's
#: test), alone and with rf_fast (its cutoff under set_eta(10)'s 500 hPa
#: top, so that it acts)
FAST = [dict(do_fast_phys=True, rf_fast=True, tau=5.0, rf_cutoff=8.0e4),
        dict(do_fast_phys=True)]


def _fast_cfg(over):
    return dict(CFG, dt=600.0, adiabatic=False, **over)


@pytest.fixture(scope="module")
def steps():
    """Both packs, the dry state, the moist state with the seeded
    supersaturated boundary layer, and the JAX package's big steps from
    them in one jitted call (one compile for the file): the dry step and
    the two fast-physics steps (FAST)."""
    gj = jax_pack(NPX, dtype=jnp.float64)
    gt = build_grid_ops(NPX, dtype=torch.float64, device="cpu")
    _, ptop, ak, bk = set_eta(K)
    dry = jw_baroclinic(gj.geom, K, ak, bk, ptop, perturb=True, moist=False)
    ic = jw_baroclinic(gj.geom, K, ak, bk, ptop, perturb=True, moist=True)
    assert np.array_equal(dry["phis"], ic["phis"])
    jphis(gj, ic["phis"])
    prepare_phis(gt, ic["phis"])
    dp0 = np.diff(ak) + np.diff(bk) * 1.0e5
    sphum = np.array(ic["sphum"])
    rng = np.random.default_rng(0)
    sphum[:, -3:] = 0.03 * rng.uniform(0.98, 1.02, sphum[:, -3:].shape)
    q = {"sphum": sphum, "liq_wat": np.zeros_like(sphum)}

    def jsteps(dry_st, st, q):
        r = jfv(*dry_st, {}, gj, JCfg(**CFG), jnp.asarray(ak),
                jnp.asarray(bk), ptop, dp0)
        out = {"dry": tuple(getattr(r, k) for k in NAMES), "fast": []}
        for over in FAST:
            r = jfv(*st, q, gj, JCfg(**_fast_cfg(over)), ak, bk, ptop, dp0,
                    mp_cfg=JMP())
            out["fast"].append((tuple(getattr(r, k) for k in NAMES), r.q))
        return out

    want = jax.jit(jsteps)(tuple(jnp.asarray(dry[k]) for k in NAMES),
                           tuple(jnp.asarray(ic[k]) for k in NAMES),
                           {k: jnp.asarray(v) for k, v in q.items()})
    return dict(dry=dry, ic=ic, q=q, gt=gt, ptop=ptop, ak=ak, bk=bk,
                dp0=dp0, want=want)


def test_fv_dynamics_nh_dry(steps):
    f = steps
    want, ptop = f["want"]["dry"], f["ptop"]
    ts = state_from_arrays(dict(f["dry"], ak=f["ak"], bk=f["bk"]),
                           dtype=torch.float64, device="cpu")
    got = fv_dynamics_nh(*(ts[k] for k in NAMES), {}, f["gt"],
                         DynConfig(**CFG), ts["ak"], ts["bk"], ptop,
                         f["dp0"])
    for nm, a in zip(NAMES, want):
        a = np.asarray(a)
        b = getattr(got, nm).numpy()
        assert np.isfinite(a).all(), nm
        assert np.abs(b - a).max() <= 1e-10 * np.abs(a).max(), nm
    # the surface pressure telescopes from the final delp (the physics
    # leaves delp as the remap made it): against the JAX result's delp to
    # the whole step's tolerance, against the port's own to rounding
    ps = got.ps.numpy()
    ps_jax = ptop + np.asarray(want[0]).sum(axis=1)
    assert ps.shape == ps_jax.shape == (6, NPX - 1, NPX - 1)
    assert np.abs(ps - ps_jax).max() <= 1e-10 * np.abs(ps_jax).max()
    ps_own = ptop + got.delp.numpy().sum(axis=1)
    assert np.abs(ps - ps_own).max() <= 1e-12 * np.abs(ps_own).max()


@pytest.mark.parametrize("over", FAST)
def test_fv_dynamics_nh_refuses_what_is_not_ported(steps, over):
    """The inline fast physics the port once refused (the test keeps the
    name it had then): one C12L10 big step with do_fast_phys and
    MPConfig() against the JAX step, every field and tracer at 1e-10."""
    f = steps
    want_st, want_q = f["want"]["fast"][FAST.index(over)]
    ts = state_from_arrays(dict(f["ic"], ak=f["ak"], bk=f["bk"]),
                           dtype=torch.float64, device="cpu")
    q = {k: torch.as_tensor(v) for k, v in f["q"].items()}
    got = fv_dynamics_nh(*(ts[k] for k in NAMES), q, f["gt"],
                         DynConfig(**_fast_cfg(over)), ts["ak"], ts["bk"],
                         f["ptop"], f["dp0"], mp_cfg=MPConfig())
    for nm, a in zip(NAMES, want_st):
        assert np.isfinite(np.asarray(a)).all(), nm
        close(getattr(got, nm), a, 1e-10, nm)
    assert sorted(got.q) == sorted(want_q)
    for nm in want_q:
        close(got.q[nm], want_q[nm], 1e-10, nm)
    # the fast physics condensed the supersaturated boundary layer
    assert float(got.q["liq_wat"].max()) > 1e-4
