"""The PyTorch port's dry nonhydrostatic big step (model/fv_dynamics.py
fv_dynamics_nh, q = {}, k_split = 1, n_split = 2, with its vertical remap)
against the jitted JAX fv_dynamics_nh on the perturbed dry Jablonowski-
Williamson state at C12L10 (float64, CPU, <= 1e-10 x field max on delp,
pt, u, v, w and delz). The k_split = 2 remap loop runs in
test_torch_fv_dynamics_moist.py; one remap keeps this file's JAX compile
short. fv_dynamics_nh still refuses what is not ported."""

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
from gfdl_atmos_cubed_sphere_tpu_torch.model.dyn_core import DynConfig
from gfdl_atmos_cubed_sphere_tpu_torch.model.fv_dynamics import fv_dynamics_nh
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import (
    build_grid_ops, state_from_arrays)
from gfdl_atmos_cubed_sphere_tpu_torch.model.sw_dynamics import prepare_phis

pytestmark = pytest.mark.fast

NPX, K = 13, 10
CFG = dict(npx=NPX, npz=K, dt=1800.0, hydrostatic=False, adiabatic=True,
           k_split=1, n_split=2, dddmp=0.2, d_con=1.0, do_vort_damp=True)
NAMES = ("delp", "pt", "u", "v", "w", "delz")


def test_fv_dynamics_nh_dry():
    gj = jax_pack(NPX, dtype=jnp.float64)
    gt = build_grid_ops(NPX, dtype=torch.float64, device="cpu")
    _, ptop, ak, bk = set_eta(K)
    ic = jw_baroclinic(gj.geom, K, ak, bk, ptop, perturb=True, moist=False)
    jphis(gj, ic["phis"])
    prepare_phis(gt, ic["phis"])
    dp0 = np.diff(ak) + np.diff(bk) * 1.0e5

    def jstep(*a):
        r = jfv(*a, {}, gj, JCfg(**CFG), jnp.asarray(ak), jnp.asarray(bk),
                ptop, dp0)
        return tuple(getattr(r, k) for k in NAMES)

    want = jax.jit(jstep)(*(jnp.asarray(ic[k]) for k in NAMES))
    ts = state_from_arrays(dict(ic, ak=ak, bk=bk), dtype=torch.float64,
                           device="cpu")
    got = fv_dynamics_nh(*(ts[k] for k in NAMES), {}, gt, DynConfig(**CFG),
                         ts["ak"], ts["bk"], ptop, dp0)
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


@pytest.mark.parametrize("over", [dict(consv_te=1.0),
                                  dict(do_fast_phys=True)])
def test_fv_dynamics_nh_refuses_what_is_not_ported(over):
    gt = build_grid_ops(NPX, dtype=torch.float64, device="cpu")
    z = torch.zeros((6, K, NPX - 1, NPX - 1), dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        fv_dynamics_nh(z, z, None, None, z, z, {"sphum": z}, gt,
                       DynConfig(**dict(CFG, **over)), np.zeros(K + 1),
                       np.zeros(K + 1), 1.0, np.ones(K))
