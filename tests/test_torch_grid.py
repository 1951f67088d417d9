"""The PyTorch port's grid pack against the JAX package's (float64, CPU).

build_grid_ops of the port must reproduce every metric array of the JAX
pack bitwise, and grid_from_arrays / state_from_arrays must carry the JAX
arrays over unchanged."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu.init import sw_cases as jcases
from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops as jax_pack
from gfdl_atmos_cubed_sphere_tpu_torch.model import grid_ops as tgo

pytestmark = pytest.mark.fast

NPX = 13
NAMES = tgo.METRIC_NAMES + tgo.SCALAR_NAMES + ("a2b_corner_w",)


@pytest.fixture(scope="module")
def packs():
    gj = jax_pack(NPX, dtype=jnp.float64)
    gt = tgo.build_grid_ops(NPX, dtype=torch.float64, device="cpu")
    return gj, gt


@pytest.mark.parametrize("name", NAMES)
def test_metric_bitwise(packs, name):
    gj, gt = packs
    want = np.asarray(getattr(gj, name))
    got = getattr(gt, name).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got, want, equal_nan=True)


def test_grid_from_arrays_round_trip(packs):
    gj, gt = packs
    arrays = {nm: np.asarray(getattr(gj, nm)) for nm in NAMES}
    arrays["global_area"] = gj.global_area
    gc = tgo.grid_from_arrays(arrays, NPX, dtype=torch.float64, device="cpu")
    for nm in NAMES + ("edge_w_full", "edge_e_full", "edge_s_full",
                       "edge_n_full"):
        assert torch.equal(torch.nan_to_num(getattr(gc, nm)),
                           torch.nan_to_num(getattr(gt, nm))), nm
    assert gc.global_area == gt.global_area
    assert (gc.npx, gc.n) == (NPX, NPX - 1)
    assert torch.equal(gc.halo._cell_flat, gt.halo._cell_flat)


def test_state_from_arrays(packs):
    gj, _ = packs
    ic = jcases.case2(gj.geom)
    st = tgo.state_from_arrays(ic, dtype=torch.float64, device="cpu")
    assert sorted(st) == ["delp", "phis", "u", "v"]
    for k, t in st.items():
        assert t.dtype == torch.float64 and t.device.type == "cpu"
        assert np.array_equal(t.numpy(), ic[k])


def test_edge_full_factors(packs):
    """The full-width a2b edge factors sit at corner index c_f + 2 for
    c_f in [2, npx-1], zero elsewhere (ops/pallas_a2b.py:67-92)."""
    _, gt = packs
    n = NPX - 1
    for nm, full, shape in (("edge_w", gt.edge_w_full, (6, 1, n + 7, 1)),
                            ("edge_s", gt.edge_s_full, (6, 1, 1, n + 7))):
        assert tuple(full.shape) == shape
        flat = full.reshape(6, -1)
        e = getattr(gt, nm).reshape(6, -1)
        assert torch.equal(flat[:, 4:n + 3], e[:, 1:n])
        assert not flat[:, :4].any() and not flat[:, n + 3:].any()
