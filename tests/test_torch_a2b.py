"""The PyTorch port's a2b interpolation (ops/a2b_edge.py, ops/a2b.py)
against the JAX package: its XLA a2b_ord4 and its Pallas kernel
a2b_ord4_pallas run in interpret mode, as tests/test_pallas_a2b.py runs it
(float64, CPU)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops as jax_pack
from gfdl_atmos_cubed_sphere_tpu.ops import a2b_edge as ja2b
from gfdl_atmos_cubed_sphere_tpu.ops.pallas_a2b import a2b_ord4_pallas
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import build_grid_ops
from gfdl_atmos_cubed_sphere_tpu_torch.ops import a2b, a2b_edge as ta2b

pytestmark = pytest.mark.fast

NPX = 13
N = NPX - 1
H = 3
WSL = slice(H, H + N + 1)          # compute corners
TOL = 1e-12


@pytest.fixture(scope="module")
def case():
    gj = jax_pack(NPX, dtype=jnp.float64)
    gt = build_grid_ops(NPX, dtype=torch.float64, device="cpu")
    q = np.random.default_rng(12).standard_normal((6, 4, N, N))
    qp = np.array(gj.halo.pad_cell(jnp.asarray(q)))
    return gj, gt, qp


def _close(want, got, tol=TOL):
    want = np.asarray(want)[..., WSL, WSL]
    got = got.numpy()[..., WSL, WSL]
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def test_a2b_ord4_matches_xla(case):
    gj, gt, qp = case
    a2b.reset_launches()
    got = ta2b.a2b_ord4(torch.as_tensor(qp), gt)
    _close(ja2b.a2b_ord4(jnp.asarray(qp), gj), got)
    assert a2b.launches == 0          # the CPU path takes the plain version
    # the halo rim is zero, as the JAX output
    assert not got[..., :H, :].any() and not got[..., -H:, :].any()


def test_a2b_ord4_matches_pallas_interpret(case):
    gj, gt, qp = case
    want = jax.jit(lambda: a2b_ord4_pallas(jnp.asarray(qp), gj,
                                           interpret=True))()
    _close(want, a2b.a2b_ord4_ref(torch.as_tensor(qp), gt))


def test_a2b_edge_rows(case):
    gj, gt, qp = case
    gg = jax_edge_pack(gj)
    want = ja2b.a2b_edge_rows(jnp.asarray(qp), gg)
    got = ta2b.a2b_edge_rows(torch.as_tensor(qp), gt)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=0)


def test_a2b_ord2(case):
    gj, gt, qp = case
    _close(ja2b.a2b_ord2(jnp.asarray(qp), gj),
           ta2b.a2b_ord2(torch.as_tensor(qp), gt))


def jax_edge_pack(gj):
    """The full-width edge factors as ops/pallas_a2b.py:67-92 builds them
    for a2b_edge_rows."""
    from types import SimpleNamespace
    n = N

    def full(nm):
        return jnp.pad(getattr(gj, nm)[..., 1:n], ((0, 0), (0, 0), (4, 4)))

    return SimpleNamespace(
        dxa=gj.dxa, dya=gj.dya, a2b_corner_w=gj.a2b_corner_w,
        edge_w_full=full("edge_w")[:, :, :, None],
        edge_e_full=full("edge_e")[:, :, :, None],
        edge_s_full=full("edge_s")[:, :, None, :],
        edge_n_full=full("edge_n")[:, :, None, :])


@pytest.mark.parametrize("fn", ["a2b_ord4", "a2b_ord2"])
def test_a2b_without_cube_edges(case, fn):
    """The doubly periodic plane (grid_type 4): plain interior stencils."""
    from types import SimpleNamespace
    _, _, qp = case
    g = SimpleNamespace(grid_type=4)
    want = np.asarray(getattr(ja2b, fn)(jnp.asarray(qp), g))
    got = getattr(ta2b, fn)(torch.as_tensor(qp), g).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_a2b_ord4_ref_at_batched_levels(case):
    """nh_p_grad's batched call shape, 3 (K + 1) + K levels (K = 10), f64."""
    gj, gt, _ = case
    q = np.random.default_rng(13).standard_normal((6, 3 * 11 + 10, N, N))
    qp = np.array(gj.halo.pad_cell(jnp.asarray(q)))
    _close(ja2b.a2b_ord4(jnp.asarray(qp), gj),
           a2b.a2b_ord4_ref(torch.as_tensor(qp), gt))


def _kernel_constants():
    src = (Path(a2b.__file__).parents[1] / "csrc" / "a2b_ord4.cu").read_text()
    m = re.search(r"constexpr int TX = (\d+), TY = (\d+), NT = \d+, "
                  r"KL = (\d+);", src)
    return tuple(int(x) for x in m.groups())


def test_a2b_launch_plan_matches_the_kernel():
    assert _kernel_constants() == (a2b.TX, a2b.TY, a2b.KL)


@pytest.mark.parametrize("n", [12, 24, 48, 192, 768])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_a2b_launch_plan(n, itemsize):
    """The plan the wrapper passes is one the kernel takes at every call
    shape, C12 to C768 and up to 319 levels (the plan does not depend on
    the levels): boxes at least 4 corners wide (so the points next to a
    tile edge lie in the first and last box of an axis) and at most TY x
    TX, and a block's shared memory within the card's 232,448 bytes."""
    ntx, nty, smem = a2b.launch_plan(n, itemsize)
    assert smem <= 232448
    for nt, box in ((ntx, a2b.TX), (nty, a2b.TY)):
        widths = np.diff([t * (n + 1) // nt for t in range(nt + 1)])
        assert widths.min() >= 4 and widths.max() <= box
