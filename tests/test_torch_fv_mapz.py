"""The PyTorch port's vertical remap (ops/fv_mapz.py) against the JAX
package: map1_ppm at the kord/iv pairs the nonhydrostatic remap uses
(kord 8 with iv = 1 and iv = -1, kord 9 with iv = -2 and a bottom value),
on seeded columns (float64, CPU, <= 1e-12 x max|ref|)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu.ops import fv_mapz as jmz
from gfdl_atmos_cubed_sphere_tpu_torch.ops import fv_mapz as tmz

pytestmark = pytest.mark.fast

KM = 12
TOL = 1e-12


def _columns(seed):
    """q [4, 5, KM], source edges pe1 and target edges pe2 [4, 5, KM+1]
    with matching ends, and a bottom value qs [4, 5]."""
    rng = np.random.default_rng(seed)
    shape = (4, 5)
    dp1 = rng.uniform(500.0, 1.5e4, shape + (KM,))
    pe1 = np.concatenate([np.full(shape + (1,), 100.0),
                          100.0 + np.cumsum(dp1, -1)], -1)
    dp2 = dp1 * rng.uniform(0.7, 1.3, dp1.shape)
    dp2 *= (pe1[..., -1:] - pe1[..., :1]) / dp2.sum(-1, keepdims=True)
    pe2 = np.concatenate([pe1[..., :1], pe1[..., :1] + np.cumsum(dp2, -1)],
                         -1)
    pe2[..., -1] = pe1[..., -1]
    lev = np.linspace(0.0, 3.0, KM)
    q = (np.sin(lev + rng.uniform(0, 6, shape + (1,)))
         + 0.3 * rng.standard_normal(shape + (KM,)))
    qs = rng.standard_normal(shape)
    return q, pe1, pe2, qs


@pytest.mark.parametrize("kord,iv", [(8, 1), (8, -1), (9, -2)])
def test_map1_ppm(kord, iv):
    q, pe1, pe2, qs = _columns(7 + kord - iv)
    qs = qs if iv == -2 else None
    qmin = 184.0 if iv == 1 else None
    want = jax.jit(lambda a, b, c, d: jmz.map1_ppm(
        a, b, c, qs=d, iv=iv, kord=kord, qmin=qmin))(
            q, pe1, pe2, None if qs is None else jnp.asarray(qs))
    t = lambda a: None if a is None else torch.as_tensor(a)
    got = tmz.map1_ppm(t(q), t(pe1), t(pe2), qs=t(qs), iv=iv, kord=kord,
                       qmin=qmin).numpy()
    want = np.asarray(want)
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    # conservation: the column integral is kept
    np.testing.assert_allclose((got * np.diff(pe2)).sum(-1),
                               (q * np.diff(pe1)).sum(-1), rtol=1e-12)
