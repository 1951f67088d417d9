"""The PyTorch port's negative-tracer fillers (ops/fv_fill.py) against the
JAX package's ops/fv_fill.py: fill_gfs's two sweeps on seeded columns with
negatives, fill2d on a C12 cube with its one ring of halo from the port's
cell exchange, and the re-exported fillz (float64, CPU, <= 1e-12 x max per
output)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops as jpack
from gfdl_atmos_cubed_sphere_tpu.ops import fv_fill as jfill
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import build_grid_ops
from gfdl_atmos_cubed_sphere_tpu_torch.ops import fv_fill as tfill
from gfdl_atmos_cubed_sphere_tpu_torch.ops import fv_mapz

pytestmark = pytest.mark.fast

TOL = 1e-12
NPX = 13


def _close(what, want, got):
    want = np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got.numpy() - want).max()
    assert err <= TOL * np.abs(want).max(), (what, err)


@pytest.mark.parametrize("name", ["fill_gfs", "fillz"])
def test_column_fillers(name):
    """Columns [6, 4, 4, km] with about a fifth of the points negative:
    equal to JAX's, the column mass kept, and no negative left but in the
    layer that takes the last debt (fill_gfs's bottom k = 0, fillz's
    k = km - 1)."""
    rng = np.random.default_rng(3)
    q = rng.uniform(-0.2, 1.0, (6, 4, 4, 12))
    dp = rng.uniform(0.5, 2.0, q.shape)
    want = getattr(jfill, name)(jnp.asarray(q), jnp.asarray(dp))
    got = getattr(tfill, name)(torch.as_tensor(q), torch.as_tensor(dp))
    _close(name, want, got)
    inner = got[..., 1:] if name == "fill_gfs" else got[..., :-1]
    assert (inner >= -1e-14).all()
    np.testing.assert_allclose((got.numpy() * dp).sum(-1), (q * dp).sum(-1),
                               rtol=1e-12)
    assert tfill.fillz is fv_mapz.fillz


def test_fill2d():
    """A C12 tracer [6, 2, 12, 12] with isolated negatives, some on tile
    edges, so that the halo ring takes part; the mass is kept."""
    gj = jpack(NPX, dtype=jnp.float64)
    gt = build_grid_ops(NPX, dtype=torch.float64, device="cpu")
    n = NPX - 1
    rng = np.random.default_rng(1)
    q = rng.uniform(0.1, 1.0, (6, 2, n, n))
    q[:, :, n // 2, n // 2] = -0.5
    q[:, :, 0, 3] = -0.3
    q[:, :, 5, n - 1] = -0.4
    delp = rng.uniform(0.9, 1.1, q.shape)
    want = jfill.fill2d(jnp.asarray(q), jnp.asarray(delp), gj)
    got = tfill.fill2d(torch.as_tensor(q), torch.as_tensor(delp), gt)
    _close("fill2d", want, got)
    area = np.asarray(gt.geom.interior("area"))[:, None]
    np.testing.assert_allclose((got.numpy() * delp * area).sum(),
                               (q * delp * area).sum(), rtol=1e-12)
    assert got[:, :, n // 2, n // 2].min() > -0.5
