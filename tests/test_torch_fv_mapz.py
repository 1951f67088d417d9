"""The PyTorch port's vertical remap (ops/fv_mapz.py) against the JAX
package: map1_ppm at the kord/iv pairs the nonhydrostatic remap uses
(kord 8 with iv = 1 and iv = -1, kord 9 with iv = -2 and a bottom value),
the tracers' positive-definite cs_profile (kord 8, iv = 0), cs_profile at
every kord (<= 8, 9-15, 17, the qmin forms of 9-11) and iv (0, +-1, 2, -2,
-3) the JAX package takes, mapn_tracer with and without fillz,
map1_ppm_ext onto a higher-top column and map_scalar_logp, on seeded
columns (float64, CPU, <= 1e-12 x max|ref|)."""

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
KORDS = (4, 8, 9, 10, 11, 12, 13, 14, 15, 17)
IVS = (0, 1, -1, 2, -2, -3)


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


def test_cs_profile_iv0():
    q, pe1, _, _ = _columns(31)
    q = np.abs(q) - 0.2               # some negative layer means
    dp = np.diff(pe1)
    want = jax.jit(lambda a, b: jmz.cs_profile(a, b, iv=0, kord=8))(q, dp)
    got = tmz.cs_profile(torch.as_tensor(q), torch.as_tensor(dp), iv=0,
                         kord=8)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert np.isfinite(w).all()
        assert np.abs(g.numpy() - w).max() <= TOL * np.abs(w).max()


@pytest.fixture(scope="module")
def profile_columns():
    """Seeded columns with some negative layer means, their thicknesses,
    a bottom value, and the JAX package's interface values of them: its
    _tridiag_interfaces for iv = -2 and for the other iv, which depend on
    the columns and not on kord. The port's own interface values agree with
    them to 1e-12."""
    q, pe1, _, qs = _columns(53)
    q = q - 0.2
    dp = np.diff(pe1)
    tri = {}
    for w2 in (False, True):
        iv = -2 if w2 else 1
        tri[w2] = np.asarray(jax.jit(
            lambda a, b, c: jmz._tridiag_interfaces(a, b, c, iv))(q, dp, qs))
        got = tmz._tridiag_interfaces(torch.as_tensor(q), torch.as_tensor(dp),
                                      torch.as_tensor(qs), iv).numpy()
        assert np.abs(got - tri[w2]).max() <= TOL * np.abs(tri[w2]).max()
    return q, dp, qs, tri


@pytest.mark.parametrize("kord,qmin", [(k, None) for k in KORDS]
                         + [(k, 0.1) for k in (9, 10, 11)])
def test_cs_profile_every_kord(profile_columns, monkeypatch, kord, qmin):
    """Every iv at this kord (and qmin), JAX's cs_profile run eagerly. Both
    packages take their cubic-spline interface values from the fixture
    (JAX's own _tridiag_interfaces on these columns, which the port's
    matches to 1e-12): kord 11 and 12 test |2 a1 - (al + ar)| > |al - ar|,
    which ties exactly wherever the limits clamp an interface to the
    layer's mean, so interface values 1 ulp apart would decide those ties
    apart."""
    q, dp, qs, tri = profile_columns

    def interfaces(a1, delp, qs_, iv):
        assert np.array_equal(np.asarray(a1), q)
        return tri[iv == -2]

    monkeypatch.setattr(jmz, "_tridiag_interfaces",
                        lambda *a: jnp.asarray(interfaces(*a)))
    monkeypatch.setattr(tmz, "_tridiag_interfaces",
                        lambda *a: torch.as_tensor(interfaces(*a)))
    for iv in IVS:
        want = jmz.cs_profile(jnp.asarray(q), jnp.asarray(dp),
                              qs=jnp.asarray(qs), iv=iv, kord=kord,
                              qmin=qmin)
        got = tmz.cs_profile(torch.as_tensor(q), torch.as_tensor(dp),
                             qs=torch.as_tensor(qs), iv=iv, kord=kord,
                             qmin=qmin)
        for nm, w, g in zip(("al", "ar", "a6"), want, got):
            w = np.asarray(w)
            assert np.isfinite(w).all(), (iv, nm)
            assert np.abs(g.numpy() - w).max() <= TOL * np.abs(w).max(), (
                iv, nm)


def test_map1_ppm_ext_higher_top():
    """L10 columns (set_eta(10), top 500 hPa) remapped onto set_eta(24),
    whose top lies far above: the uncovered width takes the top layer's
    value; and map_scalar_logp (kord 10 on log p with T_MIN)."""
    from gfdl_atmos_cubed_sphere_tpu.grid.fv_eta import set_eta
    rng = np.random.default_rng(61)
    _, _, ak1, bk1 = set_eta(10)
    _, _, ak2, bk2 = set_eta(24)
    assert ak2[0] < ak1[0]
    ps = rng.uniform(9.0e4, 1.02e5, (3, 4, 1))
    pe1 = ak1 + bk1 * ps
    pe2 = ak2 + bk2 * ps
    q = 250.0 + 30.0 * rng.standard_normal((3, 4, 10))
    ln1, ln2 = np.log(pe1), np.log(ak1 + bk1 * ps * 0.97)
    ln2[..., -1] = ln1[..., -1]
    t = torch.as_tensor
    want = jax.jit(lambda *a: [jmz.map1_ppm_ext(*a[:3], iv=iv, kord=4)
                               for iv in (1, 0, -1)]
                   + [jmz.map_scalar_logp(a[0], *a[3:], kord=-10)])(
        q, pe1, pe2, ln1, ln2)
    got = [tmz.map1_ppm_ext(t(q), t(pe1), t(pe2), iv=iv, kord=4)
           for iv in (1, 0, -1)] + [
        tmz.map_scalar_logp(t(q), t(ln1), t(ln2), kord=-10)]
    for what, w, g in zip(("iv 1", "iv 0", "iv -1", "logp"), want, got):
        w, g = np.asarray(w), g.numpy()
        assert np.isfinite(w).all(), what
        assert np.abs(g - w).max() <= TOL * np.abs(w).max(), what
    # the layers wholly above the source top take its value
    above = pe2[..., 1:] <= pe1[..., :1]
    assert above.any()
    np.testing.assert_allclose(
        got[0].numpy()[above],
        np.broadcast_to(q[..., :1], above.shape)[above], rtol=1e-12)


@pytest.mark.parametrize("fill", [False, True])
def test_mapn_tracer(fill):
    """Three tracers on shared edges, one of them with negative layers
    (which fill=True removes)."""
    qs, pe1, pe2 = [], None, None
    for i in range(3):
        q, pe1, pe2, _ = _columns(41)
        qs.append(np.abs(q) * 10.0 ** -i)
    qs[2] = qs[2] - 0.05
    qstack = np.stack(qs)
    want = jax.jit(lambda a, b, c: jmz.mapn_tracer(a, b, c, kord=8,
                                                   fill=fill))(
        qstack, pe1, pe2)
    got = tmz.mapn_tracer(*(torch.as_tensor(a) for a in (qstack, pe1, pe2)),
                          kord=8, fill=fill).numpy()
    want = np.asarray(want)
    assert np.isfinite(want).all()
    # fillz leaves a negative only in the bottom layer, where the column's
    # remaining debt goes
    assert (want[2][..., :-1] < 0).any() != fill
    for w, g in zip(want, got):
        assert np.abs(g - w).max() <= TOL * np.abs(w).max()
    # conservation: each tracer's column integral is kept
    np.testing.assert_allclose((got * np.diff(pe2)).sum(-1),
                               (qstack * np.diff(pe1)).sum(-1), rtol=1e-12,
                               atol=1e-12 * np.abs(qstack).max())
