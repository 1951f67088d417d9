"""The PyTorch port's cube halo exchange and corner fills against the JAX
package (float64, CPU, random fields from a numpy seed)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops as jax_pack
from gfdl_atmos_cubed_sphere_tpu.ops import fill_corners as jfc
from gfdl_atmos_cubed_sphere_tpu.parallel import halo as jhalo
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import build_grid_ops
from gfdl_atmos_cubed_sphere_tpu_torch.ops import fill_corners as tfc
from gfdl_atmos_cubed_sphere_tpu_torch.parallel import halo as thalo

pytestmark = pytest.mark.fast

NPX = 13
N = NPX - 1
H = 3
K = 3


@pytest.fixture(scope="module")
def halos():
    gj = jax_pack(NPX, dtype=jnp.float64)
    gt = build_grid_ops(NPX, dtype=torch.float64, device="cpu")
    return gj.halo, gt.halo


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


def _same(want, got):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    assert np.array_equal(got, want, equal_nan=True)


def test_pad_cell(halos):
    hj, ht = halos
    q = _rand(6, K, N, N)
    _same(hj.pad_cell(jnp.asarray(q)), ht.pad_cell(torch.as_tensor(q)))


def test_pad_corner(halos):
    hj, ht = halos
    q = _rand(6, K, N + 1, N + 1, seed=1)
    _same(hj.pad_corner(jnp.asarray(q)), ht.pad_corner(torch.as_tensor(q)))


@pytest.mark.parametrize("grid", ["D", "C"])
def test_pad_vector(halos, grid):
    hj, ht = halos
    yw = _rand(6, K, N + 1, N, seed=2)        # u (D) / vc (C)
    xw = _rand(6, K, N, N + 1, seed=3)        # v (D) / uc (C)
    if grid == "D":
        want = hj.pad_dgrid(jnp.asarray(yw), jnp.asarray(xw))
        got = ht.pad_dgrid(torch.as_tensor(yw), torch.as_tensor(xw))
    else:
        want = hj.pad_cgrid(jnp.asarray(xw), jnp.asarray(yw))
        got = ht.pad_cgrid(torch.as_tensor(xw), torch.as_tensor(yw))
    for w, g in zip(want, got):
        _same(w, g)


def test_reconcile_dgrid(halos):
    hj, ht = halos
    u = _rand(6, K, N + 1, N, seed=4)
    v = _rand(6, K, N, N + 1, seed=5)
    want = hj.reconcile_dgrid(jnp.asarray(u), jnp.asarray(v))
    got = ht.reconcile_dgrid(torch.as_tensor(u), torch.as_tensor(v))
    for w, g in zip(want, got):
        _same(w, g)


@pytest.mark.parametrize("direction", [1, 2])
def test_copy_corners(direction):
    q = _rand(6, K, N + 2 * H, N + 2 * H, seed=6)
    _same(jhalo.copy_corners(jnp.asarray(q), H, direction),
          thalo.copy_corners(torch.as_tensor(q), H, direction))


@pytest.mark.parametrize("direction", [1, 2])
def test_fill_4corners_cell(direction):
    q = _rand(6, K, N + 2 * H, N + 2 * H, seed=7)
    _same(jfc.fill_4corners_cell(jnp.asarray(q), direction, NPX),
          tfc.fill_4corners_cell(torch.as_tensor(q), direction, NPX))


@pytest.mark.parametrize("direction", [1, 2])
def test_fill_corners_bgrid(direction):
    q = _rand(6, K, N + 1 + 2 * H, N + 1 + 2 * H, seed=8)
    _same(jfc.fill_corners_bgrid(jnp.asarray(q), direction, NPX),
          tfc.fill_corners_bgrid(torch.as_tensor(q), direction, NPX))


def test_fill_corners_dgrid_vector():
    u = _rand(6, K, N + 1 + 2 * H, N + 2 * H, seed=9)
    v = _rand(6, K, N + 2 * H, N + 1 + 2 * H, seed=10)
    want = jfc.fill_corners_dgrid_vector(jnp.asarray(u), jnp.asarray(v), NPX)
    got = tfc.fill_corners_dgrid_vector(torch.as_tensor(u),
                                        torch.as_tensor(v), NPX)
    for w, g in zip(want, got):
        _same(w, g)
