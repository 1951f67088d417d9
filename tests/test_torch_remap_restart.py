"""The PyTorch port's restart remap (io/restart.py remap_restart and
reset_eta; fv_io.F90 rst_remap:860) against the JAX package's (float64,
CPU, C12L10, the seeded moist JW state of torch_slice_inputs): the
nonhydrostatic state with its six tracers remapped from set_eta(10) (top
500 hPa) onto set_eta(24), whose top lies far above (map1_ppm_ext's
extrapolation past the source column, as JAX's
tests/test_remap_restart.py:36-50), each output <= 1e-12 x its maximum;
the port's checkpoint of the result read back by the JAX package's
load_state equal to it; and reset_eta of the hydrostatic fields from a
perturbed coordinate back to set_eta(10), as JAX's
test_reset_eta_roundtrip."""

import jax
import numpy as np
import pytest

import torch_slice_inputs as si
from gfdl_atmos_cubed_sphere_tpu.grid.fv_eta import set_eta
from gfdl_atmos_cubed_sphere_tpu.io import restart as jrst
from gfdl_atmos_cubed_sphere_tpu_torch.io import restart as prst

pytestmark = pytest.mark.fast

FIELDS = ("delp", "pt", "u", "v", "w", "delz")
HYDRO = ("delp", "pt", "u", "v")


def test_remap_restart_and_reset_eta_match_jax(tmp_path):
    gj, gt, ptop, ak, bk, ic = si.packs()
    st, q = si.seeded_state(ic, seed=9)
    st = {k: st[k] for k in FIELDS}
    _, _, ak24, bk24 = set_eta(24)
    assert ak24[0] < ak[0]

    def jax_remaps(st, q):
        a = jrst.remap_restart(st, q, ak, bk, ak24, bk24, gj,
                               hydrostatic=False)
        b = jrst.reset_eta({k: st[k] for k in HYDRO}, q, ak * 1.02, bk,
                           gj)[:2]
        return a, b

    (want, want_q), (want_r, want_rq) = jax.jit(jax_remaps)(
        si.jnp_dict(st), si.jnp_dict(q))
    got, got_q = prst.remap_restart(si.t64_dict(st), si.t64_dict(q), ak, bk,
                                    ak24, bk24, gt, hydrostatic=False)
    assert set(got) == set(want) and set(got_q) == set(want_q)
    for k in want:
        si.close(got[k], want[k], 1e-12, k)
    for k in want_q:
        si.close(got_q[k], want_q[k], 1e-12, f"q {k}")
    assert got["delp"].shape[1] == 24

    path = str(tmp_path / "remapped.npz")
    prst.save_state(path, got, ak=ak24, bk=bk24, tracers=got_q)
    state, tracers, _ = jrst.load_state(path)
    assert np.array_equal(state["ak"], ak24)
    for k, v in got.items():
        assert np.array_equal(state[k], v.numpy()), k
    for k, v in got_q.items():
        assert np.array_equal(tracers[k], v.numpy()), k

    st2, q2, ak2, bk2, ptop2 = prst.reset_eta(
        si.t64_dict({k: st[k] for k in HYDRO}), si.t64_dict(q), ak * 1.02,
        bk, gt)
    assert np.array_equal(ak2, ak) and np.array_equal(bk2, bk)
    assert ptop2 == ptop
    for k in want_r:
        si.close(st2[k], want_r[k], 1e-12, f"reset_eta {k}")
    for k in want_rq:
        si.close(q2[k], want_rq[k], 1e-12, f"reset_eta q {k}")
