"""The PyTorch port's large-timestep tracer transport (model/tracer_2d.py)
against the jitted JAX tracer_2d at C12L6 with three seeded tracers and
seeded Courant numbers and mass fluxes, at the CFL-adaptive subcycle count
(q_split = 0) and a static one (q_split = 2) (float64, CPU, <= 1e-12 x
max per tracer and for the final pressure thickness); and the rank-5
halo pad and corner copy the batched tracers go through.

On the CPU the port's rank-5 sweep takes its plain version; the kernel
launch counter stays 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu.model import tracer_2d as jtr
from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops as jax_pack
from gfdl_atmos_cubed_sphere_tpu.parallel import halo as jhalo
from gfdl_atmos_cubed_sphere_tpu_torch.model import tracer_2d as ttr
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import build_grid_ops
from gfdl_atmos_cubed_sphere_tpu_torch.ops import tp_sweep
from gfdl_atmos_cubed_sphere_tpu_torch.parallel import halo as thalo

pytestmark = pytest.mark.fast

NPX, K, T = 13, 6, 3
N = NPX - 1
H = 3
NC, NW = N + 2 * H, N + 1 + 2 * H
TOL = 1e-12
NAMES = ("sphum", "liq_wat", "o3mr")


@pytest.fixture(scope="module")
def case():
    gj = jax_pack(NPX, dtype=jnp.float64)
    gt = build_grid_ops(NPX, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(23)
    area = float(np.asarray(gj.area)[0, 0, H, H])
    c = dict(
        q={nm: rng.uniform(0.1, 1.0, (6, K, N, N)) * 10.0 ** -i
           for i, nm in enumerate(NAMES)},
        dp1=rng.uniform(800.0, 2000.0, (6, K, N, N)),
        # Courant numbers up to 1.4 on the compute walls: nsplt = 2
        cx=rng.uniform(-1.4, 1.4, (6, K, NC, NW)),
        cy=rng.uniform(-1.4, 1.4, (6, K, NW, NC)),
        # mass fluxes whose convergence moves dp by some 10 Pa
        mfx=10.0 * area * rng.standard_normal((6, K, N, N + 1)),
        mfy=10.0 * area * rng.standard_normal((6, K, N + 1, N)))
    return gj, gt, c


@pytest.mark.parametrize("q_split", [0, 2])
def test_tracer_2d(case, q_split):
    gj, gt, c = case

    def jrun(q, dp1, mfx, mfy, cx, cy):
        return jtr.tracer_2d(q, dp1, mfx, mfy, cx, cy, gj, 8,
                             q_split=q_split)

    args = (c["dp1"], c["mfx"], c["mfy"], c["cx"], c["cy"])
    want_q, want_dp = jax.jit(jrun)(
        {k: jnp.asarray(v) for k, v in c["q"].items()},
        *(jnp.asarray(a) for a in args))
    tp_sweep.reset_launches()
    ttr.reset_nsplt()
    got_q, got_dp = ttr.tracer_2d(
        {k: torch.as_tensor(v) for k, v in c["q"].items()},
        *(torch.as_tensor(a) for a in args), gt, 8, q_split=q_split)
    assert tp_sweep.launches == 0
    assert ttr.nsplt_calls == [2]
    for nm in NAMES:
        w = np.asarray(want_q[nm])
        assert np.isfinite(w).all(), nm
        err = np.abs(got_q[nm].numpy() - w).max() / np.abs(w).max()
        assert err <= TOL, (nm, err)
    w = np.asarray(want_dp)
    assert np.abs(got_dp.numpy() - w).max() <= TOL * np.abs(w).max()


def test_rank5_pad_cell_and_copy_corners(case):
    gj, gt, _ = case
    q = np.random.default_rng(29).standard_normal((6, T, K, N, N))
    want = gj.halo.pad_cell(jnp.asarray(q))
    got = gt.halo.pad_cell(torch.as_tensor(q))
    assert got.shape == (6, T, K, NC, NC)
    assert np.array_equal(got.numpy(), np.asarray(want), equal_nan=True)
    for direction in (1, 2):
        w = jhalo.copy_corners(want, H, direction)
        g = thalo.copy_corners(got, H, direction)
        assert np.array_equal(g.numpy(), np.asarray(w), equal_nan=True)
