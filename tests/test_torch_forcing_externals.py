"""The PyTorch port's external forcings (physics/forcing_externals.py)
against the JAX package's functions of the same names on the same seeded
inputs (float64, CPU, C12L10; the SST, aerosol, w-forcing and age-of-air
cases of tests/test_forcing_outputs.py): ExternalSST.to_cube with and
without the anomaly, AeroClimatology.at_time and to_model (the port's
gather against JAX's one-hot contraction; with float32 layers too, whose
float64 result is held to 1e-5 for the last bit of float32 log),
do_w_forcing of both types and its time gate, and age_of_air. Each output
<= 1e-12 x its maximum, in JAX's dtype."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu.grid.fv_eta import set_eta
from gfdl_atmos_cubed_sphere_tpu.init.baroclinic import jw_baroclinic
from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops as jax_pack
from gfdl_atmos_cubed_sphere_tpu.physics import forcing_externals as jfe
from gfdl_atmos_cubed_sphere_tpu_torch.physics import forcing_externals as fe

pytestmark = pytest.mark.fast

NPX, K = 13, 10
N = NPX - 1


def close(got, want, what, tol=1e-12):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert np.isfinite(want).all(), what
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * (top if top > 0 else 1.0), what


@pytest.fixture(scope="module")
def case():
    gj = jax_pack(NPX, dtype=jnp.float64)
    _, ptop, ak, bk = set_eta(K)
    ic = jw_baroclinic(gj.geom, K, ak, bk, ptop, perturb=True, moist=True)
    return gj, ptop, ic


def test_external_sst(case):
    gj, _, _ = case
    rng = np.random.default_rng(16)
    lats = np.linspace(-np.pi / 2, np.pi / 2, 31)
    lons = np.linspace(0, 2 * np.pi, 60, endpoint=False)
    sst = 300.0 - 30.0 * np.sin(lats[:, None]) ** 2 + rng.uniform(
        -1, 1, (31, 60))
    anom = rng.uniform(-2, 2, (31, 60))
    js = jfe.ExternalSST(lons, lats, sst, sst_anom=anom)
    ts = fe.ExternalSST(lons, lats, sst, sst_anom=anom)
    for anomaly in (False, True):
        close(ts.to_cube(gj.geom, anomaly=anomaly, device="cpu"),
              js.to_cube(gj.geom, anomaly=anomaly), f"SST {anomaly}")
    expect = 300.0 - 30.0 * np.sin(gj.geom.interior("aglat")) ** 2
    np.testing.assert_allclose(ts.to_cube(gj.geom, device="cpu").numpy(),
                               expect, atol=1.2)


def test_aero_climatology(case):
    gj, ptop, ic = case
    rng = np.random.default_rng(17)
    kc = 8
    p_edge_c = np.linspace(1000.0, 101000.0, kc + 1)
    pc = 0.5 * (p_edge_c[1:] + p_edge_c[:-1])
    prof = 1.0e-6 * np.log(pc / 100.0)
    f = prof[None, :, None, None] * (1 + 0.1 * rng.uniform(-1, 1, (12, kc,
                                                                    19, 36)))
    fields = {"so4": f, "dust": 1e-7 * rng.uniform(size=(12, kc, 19, 36))}
    args = (np.linspace(0, 2 * np.pi, 36, endpoint=False),
            np.linspace(-np.pi / 2, np.pi / 2, 19), p_edge_c, fields)
    ja, ta = jfe.AeroClimatology(*args), fe.AeroClimatology(*args)
    for month in (3.4, 11.7):
        want, got = ja.at_time(month), ta.at_time(month)
        for k in want:
            close(got[k], want[k], f"at_time {k}")
    delp = ic["delp"] * (1 + 0.05 * rng.uniform(-1, 1, ic["delp"].shape))
    # float32 layers: the float64 result of JAX's promotion; XLA's and
    # PyTorch's float32 log differ in the last bit, which the log-p weight
    # carries to ~1e-6 of the field
    for dt, tol in ((jnp.float64, 1e-12), (jnp.float32, 1e-5)):
        want = ja.to_model(gj.geom, jnp.asarray(delp, dt), ptop, 3.4)
        got = ta.to_model(gj.geom, torch.as_tensor(
            delp, dtype=torch.float64 if dt == jnp.float64
            else torch.float32), ptop, 3.4)
        assert sorted(got) == sorted(want)
        for k in want:
            close(got[k], want[k], f"to_model {k} {dt.__name__}", tol)


def test_w_forcing_and_age_of_air(case):
    gj, ptop, ic = case
    rng = np.random.default_rng(18)
    T, n, kz = 1, 16, 12
    delz = -500.0 * (1 + 0.1 * rng.uniform(-1, 1, (T, kz, n, n)))
    phis = 50.0 * rng.uniform(size=(T, n, n))
    w = 0.1 * rng.standard_normal((T, kz, n, n))
    cfgs = (dict(w_forcing_type=1, a=0.02, i0=8, j0=8, L=4.0e3, R=4.0e3,
                 H=1.5e3, D=1.5e3, dx_const=1.0e3),
            dict(w_forcing_type=101, divg=1.0e-5, tau=100.0),
            dict(w_forcing_type=1, start=0.0, end=100.0))
    for cfg, dt, time in zip(cfgs, (10.0, 1.0e3, 10.0), (0.0, 0.0, 200.0)):
        close(fe.do_w_forcing(torch.as_tensor(w), torch.as_tensor(delz),
                              torch.as_tensor(phis), fe.WForcingConfig(**cfg),
                              dt, time),
              jfe.do_w_forcing(jnp.asarray(w), jnp.asarray(delz),
                               jnp.asarray(phis), jfe.WForcingConfig(**cfg),
                               dt, time), f"do_w_forcing {cfg}")
    with pytest.raises(ValueError):
        fe.do_w_forcing(torch.as_tensor(w), torch.as_tensor(delz),
                        torch.as_tensor(phis),
                        fe.WForcingConfig(w_forcing_type=2), 1.0, 0.0)
    delp = ic["delp"]
    pe_top = ptop + np.cumsum(delp, axis=1) - delp
    q = 7.0 + rng.uniform(size=delp.shape)
    for time in (0.0, 86400.0):
        close(fe.age_of_air(torch.as_tensor(q), torch.as_tensor(pe_top),
                            time),
              jfe.age_of_air(jnp.asarray(q), jnp.asarray(pe_top), time),
              f"age_of_air {time}")
