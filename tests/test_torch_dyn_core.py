"""The PyTorch port's nonhydrostatic acoustic loop (model/dyn_core.py
dyn_core_nh, n_split = 2) against the jitted JAX dyn_core_nh on a perturbed
dry Jablonowski-Williamson state at C12L10 (float64, CPU, <= 1e-10 x field
max on delp, pt, u, v, w and delz; the accumulated mass fluxes too).

On the CPU the JAX package takes its XLA formulation and the port the plain
versions of its kernels; the kernel launch counters stay 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu import constants as con
from gfdl_atmos_cubed_sphere_tpu.grid.fv_eta import set_eta
from gfdl_atmos_cubed_sphere_tpu.init.baroclinic import jw_baroclinic
from gfdl_atmos_cubed_sphere_tpu.model import dyn_core as jdc
from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops as jax_pack
from gfdl_atmos_cubed_sphere_tpu.model.sw_dynamics import prepare_phis as jphis
from gfdl_atmos_cubed_sphere_tpu_torch.model import dyn_core as tdc
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import (
    build_grid_ops, state_from_arrays)
from gfdl_atmos_cubed_sphere_tpu_torch.model.sw_dynamics import prepare_phis
from gfdl_atmos_cubed_sphere_tpu_torch.ops import (a2b, csw, dsw, ke, sim1,
                                                   tp_sweep)

pytestmark = pytest.mark.fast

NPX, K = 13, 10
DT = 1800.0
N_SPLIT = 2
CFG = dict(npx=NPX, npz=K, dt=DT, hydrostatic=False, adiabatic=True,
           k_split=1, n_split=N_SPLIT, dddmp=0.2, d_con=1.0,
           do_vort_damp=True)
OUT = ("delp", "pt", "u", "v", "w", "delz", "mfx", "mfy")


def test_dyn_core_nh():
    gj = jax_pack(NPX, dtype=jnp.float64)
    gt = build_grid_ops(NPX, dtype=torch.float64, device="cpu")
    _, ptop, ak, bk = set_eta(K)
    ic = jw_baroclinic(gj.geom, K, ak, bk, ptop, perturb=True, moist=False)
    jphis(gj, ic["phis"])
    prepare_phis(gt, ic["phis"])
    rng = np.random.default_rng(51)
    rrg = -con.RDGAS / con.GRAV
    pkz = np.exp(con.KAPPA * np.log(rrg * ic["delp"] / ic["delz"] * ic["pt"]))
    st = dict(ic, pt=ic["pt"] / pkz,
              w=0.02 * rng.standard_normal(ic["delp"].shape))
    dp0 = np.diff(ak) + np.diff(bk) * 1.0e5
    dt_ac = DT / N_SPLIT
    names = ("delp", "pt", "u", "v", "w", "delz")

    def jstep(*a):
        r = jdc.dyn_core_nh(*a, None, gj, jdc.DynConfig(**CFG), con.KAPPA,
                            ptop, N_SPLIT, dt_ac, dp0)
        return tuple(getattr(r, k) for k in OUT)

    want = jax.jit(jstep)(*(jnp.asarray(st[k]) for k in names))
    ts = state_from_arrays(st, dtype=torch.float64, device="cpu")
    for mod in (a2b, csw, dsw, ke, sim1, tp_sweep):
        mod.reset_launches()
    got = tdc.dyn_core_nh(*(ts[k] for k in names), gt,
                          tdc.DynConfig(**CFG), con.KAPPA, ptop, N_SPLIT,
                          dt_ac, dp0)
    assert (a2b.launches, csw.launches, dsw.launches["fluxes"],
            dsw.launches["winds"], ke.launches, sim1.launches,
            tp_sweep.launches) == (0,) * 7
    for nm, a in zip(OUT, want):
        a = np.asarray(a)
        b = getattr(got, nm).numpy()
        assert np.isfinite(a).all(), nm
        assert np.abs(b - a).max() <= 1e-10 * np.abs(a).max(), nm
