"""The PyTorch port's utils/coarse_graining.py and io/restart.py
save_coarse_state against the JAX package's (CPU, float64, C12L10, the
seeded moist JW state of torch_slice_inputs): every block operator, the
length-weighted D-grid winds and coarse_grain_restart in both strategies
<= 1e-12 x each output's maximum, block_mode's ties to the lowest class as
jnp.argmax, and a port save_coarse_state file read back by the JAX
package's load_state with arrays equal to the port's and to the JAX
package's own coarse state.

One test function runs every check of this file: with one item the file
queues at the end of a parallel run (xdist --dist loadfile sorts files
by their item count), beside the run's longest files.
"""

import numpy as np
import pytest
import torch

import torch_slice_inputs as si
from gfdl_atmos_cubed_sphere_tpu.io import restart as jrst
from gfdl_atmos_cubed_sphere_tpu.utils import coarse_graining as jcg
from gfdl_atmos_cubed_sphere_tpu_torch.io import restart as prst
from gfdl_atmos_cubed_sphere_tpu_torch.utils import coarse_graining as pcg

pytestmark = pytest.mark.fast


@pytest.fixture(scope="module")
def case():
    gj, gt, ptop, ak, bk, ic = si.packs()
    st, q = si.seeded_state(ic)
    return gj, gt, ak, bk, st, q


def _block_operators_match_jax():
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    f = rng.normal(size=(6, 3, 8, 8))
    area = rng.uniform(0.5, 1.5, (6, 1, 8, 8))
    delp = rng.uniform(5e2, 2e3, (6, 3, 8, 8))
    mask = rng.uniform(size=(6, 3, 8, 8)) < 0.3
    mask[0, 0, :2, :2] = False            # a block with no cell in it
    J, T = jnp.asarray, torch.as_tensor
    for factor in (2, 4):
        pairs = [
            (pcg.block_area_weighted_mean(T(f), T(area), factor),
             jcg.block_area_weighted_mean(J(f), J(area), factor)),
            (pcg.block_mean(T(f), factor), jcg.block_mean(J(f), factor)),
            (pcg.block_sum(T(f), factor), jcg.block_sum(J(f), factor)),
            (pcg.block_min(T(f), factor), jcg.block_min(J(f), factor)),
            (pcg.block_max(T(f), factor), jcg.block_max(J(f), factor)),
            (pcg.block_masked_area_mean(T(f), T(area), T(mask), factor, 7.0),
             jcg.block_masked_area_mean(J(f), J(area), J(mask), factor,
                                        7.0)),
            (pcg.block_mass_weighted_mean(T(f), T(delp), T(area), factor),
             jcg.block_mass_weighted_mean(J(f), J(delp), J(area), factor))]
        for i, (got, want) in enumerate(pairs):
            si.close(got, want, 1e-12, f"operator {i} factor {factor}")
        cls = rng.integers(0, 4, (6, 8, 8))
        got = pcg.block_mode(T(cls), factor, 4)
        assert np.array_equal(got.numpy(), np.asarray(
            jcg.block_mode(J(cls), factor, 4)))
    # a tie in every block goes to the lowest class, as jnp.argmax does
    tie = np.tile(np.array([[2, 1], [1, 2]]), (6, 4, 4))
    got = pcg.block_mode(torch.as_tensor(tie), 2, 3)
    assert got.unique().tolist() == [1]
    assert np.array_equal(got.numpy(),
                          np.asarray(jcg.block_mode(jnp.asarray(tie), 2, 3)))
    st = {"pt": f, "delp": delp, "v": rng.normal(size=(6, 3, 8, 9)),
          "w": f * 0.1, "none": None}
    got = pcg.coarse_grain_state(si.t64_dict(
        {k: v for k, v in st.items() if v is not None}), T(area), 2)
    want = jcg.coarse_grain_state(si.jnp_dict(
        {k: v for k, v in st.items() if v is not None}), J(area), 2)
    assert list(got) == list(want)
    for k in want:
        si.close(got[k], want[k], 1e-12, f"coarse_grain_state {k}")


def _coarse_grain_restart_matches_jax(case, strategy):
    gj, gt, ak, bk, st, q = case
    sp, qp = pcg.coarse_grain_restart(si.t64_dict(st), si.t64_dict(q), gt,
                                      2, strategy=strategy)
    sj, qj = jcg.coarse_grain_restart(si.jnp_dict(st), si.jnp_dict(q), gj,
                                      2, strategy=strategy)
    assert list(sp) == list(sj) and list(qp) == list(qj)
    assert sp["u"].shape == (6, 10, 7, 6) and sp["v"].shape == (6, 10, 6, 7)
    for k in sj:
        si.close(sp[k], sj[k], 1e-12, f"{strategy} {k}")
    for k in qj:
        si.close(qp[k], qj[k], 1e-12, f"{strategy} q {k}")
    with pytest.raises(ValueError):
        pcg.coarse_grain_restart(si.t64_dict(st), None, gt, 2,
                                 strategy="nearest")


def _save_coarse_state_reads_back_in_jax(case, tmp_path):
    gj, gt, ak, bk, st, q = case
    path = str(tmp_path / "coarse.npz")
    cs, cq = prst.save_coarse_state(path, si.t64_dict(st), si.t64_dict(q),
                                    gt, 2, ak=ak, bk=bk, step=4,
                                    time_seconds=3600.0)
    state, tracers, manifest = jrst.load_state(path)
    assert manifest["step"] == 4 and manifest["time_seconds"] == 3600.0
    assert set(state) == set(cs) | {"ak", "bk"} and set(tracers) == set(cq)
    for k, v in cs.items():
        assert np.array_equal(state[k], v.numpy()), k
    for k, v in cq.items():
        assert np.array_equal(tracers[k], v.numpy()), k
    jpath = str(tmp_path / "coarse_jax.npz")
    jrst.save_coarse_state(jpath, si.jnp_dict(st), si.jnp_dict(q), gj, 2,
                           ak=ak, bk=bk)
    jstate, jtracers, _ = jrst.load_state(jpath)
    for k in jstate:
        si.close(state[k], jstate[k], 1e-12, f"file {k}")
    for k in jtracers:
        si.close(tracers[k], jtracers[k], 1e-12, f"file q {k}")
    # reset_eta of the state on its own set_eta(10) coordinate keeps the
    # coordinate and each column's mass
    st2, q2, ak2, bk2, _ = prst.reset_eta(
        si.t64_dict({k: st[k] for k in ("delp", "pt", "u", "v")}),
        si.t64_dict(q), ak, bk, gt)
    assert np.array_equal(ak2, ak) and np.array_equal(bk2, bk)
    np.testing.assert_allclose(st2["delp"].numpy().sum(1),
                               st["delp"].sum(1), rtol=1e-12)
    assert set(q2) == set(q)


def test_coarse_graining_matches_jax(case, tmp_path):
    """Every check of the module docstring."""
    _block_operators_match_jax()
    for strategy in ("model_level_area_weighted",
                     "model_level_mass_weighted"):
        _coarse_grain_restart_matches_jax(case, strategy)
    _save_coarse_state_reads_back_in_jax(case, tmp_path)
