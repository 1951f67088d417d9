"""The PyTorch port's negative-moisture adjustment (ops/fv_sg.py neg_adj3,
with its phase fixes, fillq and the water-vapour column borrow) against
the jitted JAX neg_adj3 on seeded [6, 10, 4, 4] states in which every
species has negative points, hydrostatic and nonhydrostatic (float64, CPU,
<= 1e-12 x max per output)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu.ops import fv_sg as jsg
from gfdl_atmos_cubed_sphere_tpu_torch.ops import fv_sg as tsg

pytestmark = pytest.mark.fast

SHAPE = (6, 10, 4, 4)
TOL = 1e-12
NAMES = ("sphum", "liq_wat", "rainwat", "ice_wat", "snowwat", "graupel",
         "cld_amt")


def _state(seed):
    rng = np.random.default_rng(seed)
    scale = {"sphum": 1e-2, "liq_wat": 1e-3, "rainwat": 5e-4,
             "ice_wat": 5e-4, "snowwat": 5e-4, "graupel": 2e-4,
             "cld_amt": 1.0}
    # about a third of the points of each species negative
    q = {nm: s * rng.uniform(-0.5, 1.0, SHAPE) for nm, s in scale.items()}
    pt = rng.uniform(200.0, 300.0, SHAPE)
    delp = rng.uniform(500.0, 3000.0, SHAPE)
    delz = -rng.uniform(100.0, 1000.0, SHAPE)
    return pt, delp, delz, q


@pytest.mark.parametrize("hydrostatic", [True, False])
def test_neg_adj3(hydrostatic):
    pt, delp, delz, q = _state(3 + hydrostatic)
    want_pt, want_q = jax.jit(lambda a, b, c, d: jsg.neg_adj3(
        a, b, d, delz=c, hydrostatic=hydrostatic))(pt, delp, delz, q)
    t = torch.as_tensor
    got_pt, got_q = tsg.neg_adj3(t(pt), t(delp),
                                 {k: t(v) for k, v in q.items()},
                                 hydrostatic=hydrostatic)
    pairs = [("pt", want_pt, got_pt)] + [(nm, want_q[nm], got_q[nm])
                                          for nm in NAMES]
    for nm, w, g in pairs:
        w = np.asarray(w)
        assert np.isfinite(w).all(), nm
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= TOL, (nm, err)
    # the adjustment removed most negatives
    assert (np.asarray(want_q["graupel"]) < 0).sum() < (q["graupel"] < 0).sum()
