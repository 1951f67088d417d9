"""The PyTorch port's data-assimilation increments and IAU
(io/da_increment.py) against the JAX package's functions of the same names
on the same seeded lat-lon increments (float64, CPU, C12; the cases of
tests/test_da_iau.py): the regrid to cube and D-grid increments, the
file reader, the one-shot application and the IAU window's weights and
forcing, each output <= 1e-12 x its maximum (the host weights exactly)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu.io import da_increment as jda
from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops as jax_pack
from gfdl_atmos_cubed_sphere_tpu_torch.io import da_increment as da
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import build_grid_ops

from torch_nwp_inputs import latlon_increments

pytestmark = pytest.mark.fast

NPX, K = 13, 4
N = NPX - 1


def close(got, want, what, tol=1e-12):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * (top if top > 0 else 1.0), what


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    gj = jax_pack(NPX, dtype=jnp.float64)
    gt = build_grid_ops(NPX, dtype=torch.float64, device="cpu")
    raw = latlon_increments(K)
    # the same increments as a GSI-style NetCDF file
    from scipy.io import netcdf_file
    path = str(tmp_path_factory.mktemp("da") / "fv3_increment.nc")
    with netcdf_file(path, "w") as f:
        f.createDimension("lev", K)
        f.createDimension("lat", len(raw["lat"]))
        f.createDimension("lon", len(raw["lon"]))
        f.createVariable("lon", "d", ("lon",))[:] = raw["lon"]
        f.createVariable("lat", "d", ("lat",))[:] = raw["lat"]
        for k, v in raw.items():
            if k not in ("lon", "lat"):
                f.createVariable(k, "d", ("lev", "lat", "lon"))[:] = v
    return gj, gt, raw, path


@pytest.mark.parametrize("how", ["dgrid", "agrid", "file"])
def test_cube_increments_and_read_da_inc(case, how):
    gj, gt, raw, path = case
    if how == "dgrid":
        want = jda.cube_increments(raw, gj.geom, g=gj)
        got = da.cube_increments(raw, gt.geom, g=gt)
    elif how == "agrid":
        want = jda.cube_increments(raw, gj.geom)
        got = da.cube_increments(raw, gt.geom, device="cpu")
    else:
        # JAX's read_da_inc(path) cannot take the file it reads: scipy
        # returns NetCDF3's big-endian arrays, which jnp.asarray refuses;
        # the port's reader returns them in the native byte order. The
        # reference is JAX's read_da_inc of the same values as a dict.
        from gfdl_atmos_cubed_sphere_tpu.io.external_ic import (
            read_latlon_netcdf)
        from gfdl_atmos_cubed_sphere_tpu_torch.io.external_ic import (
            read_latlon_netcdf as tread)
        jraw, traw = read_latlon_netcdf(path), tread(path)
        assert sorted(jraw) == sorted(traw)
        assert all(np.array_equal(jraw[k], traw[k]) for k in jraw)
        want = jda.read_da_inc({k: np.asarray(v, np.float64)
                                for k, v in jraw.items()}, gj.geom, g=gj)
        got = da.read_da_inc(path, gt.geom, g=gt)
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], f"{how} {k}")
    assert got["pt"].shape == (6, K, N, N)
    # a constant increment regrids to the same constant
    const = dict(raw, T_inc=np.full_like(raw["T_inc"], 1.5))
    np.testing.assert_allclose(
        da.cube_increments(const, gt.geom, device="cpu")["pt"].numpy(), 1.5,
        rtol=1e-12)


def test_apply_da_inc_and_iau(case):
    gj, gt, raw, _ = case
    want_inc = jda.cube_increments(raw, gj.geom, g=gj)
    inc = da.cube_increments(raw, gt.geom, g=gt)
    rng = np.random.default_rng(4)
    state = {"pt": 300.0 + rng.standard_normal((6, K, N, N)),
             "delp": 1.0e4 + rng.standard_normal((6, K, N, N)),
             "w": None}
    jstate = {k: None if v is None else jnp.asarray(v)
              for k, v in state.items()}
    tstate = {k: None if v is None else torch.as_tensor(v)
              for k, v in state.items()}
    want = jda.apply_da_inc(jstate, want_inc, scale=0.25)
    got = da.apply_da_inc(tstate, inc, scale=0.25)
    assert sorted(got) == sorted(want) and got["w"] is None
    for k in ("pt", "delp"):
        close(got[k], want[k], f"apply_da_inc {k}")
    dt = 90.0
    for filtered in (False, True):
        cfg = dict(window_s=3600.0, filtered=filtered)
        jiau = jda.IAU(want_inc, jda.IAUConfig(**cfg), t_start=30.0)
        tiau = da.IAU(inc, da.IAUConfig(**cfg), t_start=30.0)
        tot = 0.0
        for i in range(45):
            t = i * dt
            assert tiau.weight(t) == float(jiau.weight(t)), (filtered, t)
            assert isinstance(tiau.weight(t), float)
            f = tiau.forcing(t, dt)
            jf = jiau.forcing(t, dt)
            assert sorted(f) == sorted(jf)
            if f:
                close(f["pt"], jf["pt"], "forcing")
                tot = tot + f["pt"]
        # the forcing over the window adds up to the increment
        close(tot, inc["pt"].numpy(), "window sum", tol=2e-2)
        assert tiau.forcing(7200.0, dt) == {} and tiau.weight(-1.0) == 0.0
        got = tiau.apply(tstate, 600.0, dt)
        want = jiau.apply(jstate, 600.0, dt)
        for k in ("pt", "delp"):
            close(got[k], want[k], f"IAU.apply {k}")
        assert tiau.apply(tstate, 1e5, dt) is tstate
