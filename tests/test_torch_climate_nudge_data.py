"""The PyTorch port's climate-nudging file pipeline (io/climate_nudge_data.py)
against the JAX package's functions of the same names (float64, CPU,
C12L10; the case of tests/test_external_nudge.py
test_climate_nudge_file_pipeline, with seeded noise and terrain): the
CAM-style file reader, remap_ps, _remap_3d, get_factor, the driver's
time-interpolated targets, its two-level cache, and its tendencies, which
the port returns as tensors on the state's device. Each output <= 1e-12 x
its maximum."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu import constants as con
from gfdl_atmos_cubed_sphere_tpu.grid.fv_eta import set_eta
from gfdl_atmos_cubed_sphere_tpu.io import climate_nudge_data as jcn
from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops as jax_pack
from gfdl_atmos_cubed_sphere_tpu_torch.io import climate_nudge_data as cn
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import build_grid_ops

pytestmark = pytest.mark.fast

NPX, NPZ = 13, 10
N = NPX - 1


def close(got, want, what, tol=1e-12):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(want).all(), what
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * (top if top > 0 else 1.0), what


def write_climatology(path, seed=12):
    """A CAM-style climatology: P0/hyai/hybi/PHIS/PS/T/Q/U/V on a lat-lon
    grid, three times a day apart (+2 K a day)."""
    from scipy.io import netcdf_file
    rng = np.random.default_rng(seed)
    nlon, nlat, nlev, ntime = 24, 13, 12, 3
    lon = np.linspace(0.0, 360.0 - 360.0 / nlon, nlon)
    lat = np.linspace(-88.0, 88.0, nlat)
    shp = (ntime, nlev, nlat, nlon)
    t3 = (260.0 + 30.0 * np.cos(np.deg2rad(lat))[None, None, :, None]
          + 2.0 * np.arange(ntime)[:, None, None, None]
          + rng.uniform(-1, 1, shp))
    with netcdf_file(path, "w") as f:
        for nm, size in (("lon", nlon), ("lat", nlat), ("lev", nlev),
                         ("levp", nlev + 1), ("time", ntime), ("scalar", 1)):
            f.createDimension(nm, size)

        def var(nm, dims, data):
            f.createVariable(nm, "d", dims)[:] = data

        var("lon", ("lon",), lon)
        var("lat", ("lat",), lat)
        var("time", ("time",), np.array([0.0, 86400.0, 172800.0]))
        var("hyai", ("levp",), np.linspace(0.003, 0.0, nlev + 1))
        var("hybi", ("levp",), np.linspace(0.0, 1.0, nlev + 1) ** 1.4)
        var("P0", ("scalar",), np.array([1.0e5]))
        var("PHIS", ("lat", "lon"), 300.0 * rng.uniform(size=(nlat, nlon)))
        var("PS", ("time", "lat", "lon"),
            1.0e5 + 300.0 * rng.standard_normal((ntime, nlat, nlon)))
        var("T", ("time", "lev", "lat", "lon"), t3)
        var("Q", ("time", "lev", "lat", "lon"),
            4.0e-3 * (1 + 0.1 * rng.uniform(-1, 1, shp)))
        var("U", ("time", "lev", "lat", "lon"), rng.uniform(-10, 10, shp))
        var("V", ("time", "lev", "lat", "lon"), rng.uniform(-10, 10, shp))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clim") / "clim_nudge_01.nc")
    write_climatology(path)
    gj = jax_pack(NPX, dtype=jnp.float64)
    gt = build_grid_ops(NPX, dtype=torch.float64, device="cpu")
    _, ptop, ak, bk = set_eta(NPZ)
    phis_mod = 500.0 * np.random.default_rng(13).uniform(size=(6, 1, N, N))
    return path, gj, gt, ak, bk, phis_mod


def test_file_and_column_operators(case):
    path = case[0]
    want = jcn.read_climate_nudge_file(path)
    got = cn.read_climate_nudge_file(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    rng = np.random.default_rng(14)
    km = 8
    ph = np.tile(np.linspace(2.0e4, 1.0e5, km + 1), (5, 1))
    ph = ph + np.concatenate([np.zeros((5, 1)),
                              rng.uniform(-50, 50, (5, km))], 1)
    tp = 280.0 + rng.uniform(-5, 5, (5, km))
    phis = np.array([0.0, 1000.0, 2000.0, -500.0, 30.0]) * con.GRAV
    args = (np.zeros(5), ph, np.log(ph), tp, phis)
    close(cn.remap_ps(*args), jcn.remap_ps(*args), "remap_ps")
    pe_dst = np.tile(np.linspace(1.0e4, 1.01e5, 11), (5, 1))
    for log_p in (False, True):
        a = (tp, ph, pe_dst)
        close(cn._remap_3d(*a, log_p=log_p), jcn._remap_3d(*a, log_p=log_p),
              f"_remap_3d {log_p}")
    for kw in (dict(), dict(skip_bot_t=3, skip_top_q=0, skip_bot_v=4)):
        assert np.array_equal(cn.get_factor(NPZ, **kw),
                              jcn.get_factor(NPZ, **kw))


def test_climate_nudge_driver(case):
    path, gj, gt, ak, bk, phis_mod = case
    cfg = dict(t_tau=21600.0, q_tau=21600.0, u_tau=21600.0, v_tau=43200.0,
               skip_bot_t=3)
    jd = jcn.ClimateNudgeDriver(path, gj.geom, ak, bk, phis_mod,
                                cfg=jcn.ClimateNudgeConfig(**cfg))
    td = cn.ClimateNudgeDriver(path, gt.geom, ak, bk,
                               torch.as_tensor(phis_mod),
                               cfg=cn.ClimateNudgeConfig(**cfg))
    for t in (0.0, 43200.0, 100000.0, 2.0e5):
        want, got = jd.target_at(t), td.target_at(t)
        assert sorted(got) == sorted(want)
        for k in want:
            close(got[k], want[k], f"target_at {t} {k}")
        assert len(td._cache) <= 2
    rng = np.random.default_rng(15)
    tgt = jd.target_at(50000.0)
    st = {k: tgt[k] + rng.uniform(-1, 1, tgt[k].shape) * s
          for k, s in (("t", 5.0), ("q", 1e-4), ("u", 3.0), ("v", 3.0))}
    want = jd.tendencies(50000.0, st["t"], st["q"], state_u=st["u"],
                         state_v=st["v"])
    got = td.tendencies(50000.0, *(torch.as_tensor(st[k])
                                   for k in ("t", "q")),
                        state_u=torch.as_tensor(st["u"]),
                        state_v=torch.as_tensor(st["v"]))
    assert sorted(got) == sorted(want) == ["q_dt", "t_dt", "u_dt", "v_dt"]
    for k in want:
        assert torch.is_tensor(got[k])
        close(got[k], want[k], f"tendencies {k}")
    assert float(got["t_dt"][:, -1].abs().max()) == 0.0   # skipped bottom
