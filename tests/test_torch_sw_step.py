"""The PyTorch port's shallow-water step (model/sw_dynamics.py) against the
jitted JAX make_sw_step: 4 steps at C12 in float64 on the CPU.

Williamson case 2 is perturbed by seeded noise. Unperturbed, its symmetric
fields put PPM limiter comparisons on exact ties, where the jitted JAX step
itself departs from the eager one (operation fusion changes the last bits);
the noise keeps every branch decision away from a tie."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu.init import sw_cases as jcases
from gfdl_atmos_cubed_sphere_tpu.model import sw_dynamics as jsw
from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops as jax_pack
from gfdl_atmos_cubed_sphere_tpu_torch.model import sw_dynamics as tsw
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import (
    build_grid_ops, state_from_arrays)
from gfdl_atmos_cubed_sphere_tpu_torch.ops import a2b, ke, tp_sweep

pytestmark = pytest.mark.fast

NPX = 13
NSTEPS = 4


@pytest.fixture(scope="module")
def packs():
    return (jax_pack(NPX, dtype=jnp.float64),
            build_grid_ops(NPX, dtype=torch.float64, device="cpu"))


def _run(gj, gt, ic, cfg_kw, keys):
    jsw.prepare_phis(gj, ic["phis"])
    tsw.prepare_phis(gt, ic["phis"])
    fj = jax.jit(jsw.make_sw_step(gj, jsw.SWConfig(npx=NPX, **cfg_kw)))
    ft = tsw.make_sw_step(gt, tsw.SWConfig(npx=NPX, **cfg_kw))
    sj = [None if ic.get(k) is None else jnp.asarray(ic[k]) for k in keys]
    st = state_from_arrays(ic, dtype=torch.float64, device="cpu")
    st = [st.get(k) for k in keys]
    for mod in (a2b, ke, tp_sweep):
        mod.reset_launches()
    for _ in range(NSTEPS):
        sj[:3] = fj(*sj)
        st[:3] = ft(*st)
    assert (a2b.launches, ke.launches, tp_sweep.launches) == (0, 0, 0)
    return sj, st


def _rel(want, got):
    want = np.asarray(want)
    assert np.isfinite(want).all()
    return np.abs(got.numpy() - want).max() / np.abs(want).max()


def test_case2_four_steps(packs):
    gj, gt = packs
    ic = jcases.case2(gj.geom)
    rng = np.random.default_rng(21)
    ic["delp"] = ic["delp"] * (1.0 + 1e-3 * rng.standard_normal(
        ic["delp"].shape))
    ic["u"] = ic["u"] + 0.5 * rng.standard_normal(ic["u"].shape)
    ic["v"] = ic["v"] + 0.5 * rng.standard_normal(ic["v"].shape)
    sj, st = _run(gj, gt, ic, dict(dt=3600.0, n_split=2),
                  ("delp", "u", "v", "uc", "vc"))
    for nm, a, b in zip(("delp", "u", "v"), sj, st):
        assert _rel(a, b) <= 1e-10, nm


def test_case1_advection_only(packs):
    gj, gt = packs
    ic = jcases.case1(gj.geom)
    ic["phis"] = np.zeros_like(ic["delp"])
    sj, st = _run(gj, gt, ic, dict(dt=3600.0, n_split=2, advection_only=True),
                  ("delp", "u", "v", "uc", "vc"))
    assert _rel(sj[0], st[0]) <= 1e-10
    assert st[1] is None and st[2] is None
