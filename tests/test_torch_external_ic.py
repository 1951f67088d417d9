"""The PyTorch port's external initial conditions (io/external_ic.py)
against the JAX package's functions of the same names, on the same seeded
numpy inputs (float64, CPU, C12; the cases of tests/test_external_nudge.py
and tests/test_nggps_files.py): the bilinear weights and interpolation, the
column remap, the lat-lon analysis state and its D winds, the NCEP, ECMWF,
NGGPS, HRRR and FV flavours and their dispatcher, the NetCDF readers, the
terrain ps adjustment, the face-wind rotation and the chgres cold start
from its tile files. Each output <= 1e-12 x its maximum (the bilinear
indices exactly). The JAX references run eagerly but for their remaps
(tests/torch_nwp_inputs.py jitted_jax_remaps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu import constants as con
from gfdl_atmos_cubed_sphere_tpu.grid.fv_eta import set_eta
from gfdl_atmos_cubed_sphere_tpu.io import external_ic as jeic
from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops as jax_pack
from gfdl_atmos_cubed_sphere_tpu_torch.io import external_ic as eic
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import build_grid_ops

from torch_nwp_inputs import (jitted_jax_remaps, latlon_analysis,
                              write_nggps_files)

pytestmark = pytest.mark.fast

NPX, NPZ, KS = 13, 5, 8
N = NPX - 1
TOL = 1e-12


def close(got, want, what, tol=TOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(want).all(), what
    top = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * (top if top > 0 else 1.0), (what, err, top)


def close_dicts(got, want, what):
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for k in want:
        close(got[k], want[k], f"{what} {k}")


@pytest.fixture(scope="module", autouse=True)
def jax_remaps_jitted():
    mp = jitted_jax_remaps()
    yield
    mp.undo()


@pytest.fixture(scope="module")
def packs():
    gj = jax_pack(NPX, dtype=jnp.float64)
    gt = build_grid_ops(NPX, dtype=torch.float64, device="cpu")
    _, ptop, ak, bk = set_eta(NPZ)
    return gj, gt, ak, bk, ptop


def test_latlon_bilinear_weights_and_interp(packs):
    gj, gt, *_ = packs
    ana = latlon_analysis(ks=KS)
    args = (ana["lon"], ana["lat"], gj.geom.interior("aglon"),
            gj.geom.interior("aglat"))
    want = jeic.latlon_bilinear_weights(*args)
    got = eic.latlon_bilinear_weights(*args)
    for k in ("i0", "i1", "j0", "j1"):
        assert np.array_equal(got[k], want[k]), k
    for k in ("wx", "wy"):
        close(got[k], want[k], k)
    close(eic.interp_to_cube(torch.as_tensor(ana["t"]), got),
          jeic.interp_to_cube(jnp.asarray(ana["t"]), want), "interp t")
    # the bilinear form reproduces a function linear in latitude
    lon = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    lat = np.linspace(-1.5, 1.5, 31)
    f = lat[:, None] * 2.0 + 0.0 * lon[None, :] + 3.0
    w = eic.latlon_bilinear_weights(lon, lat, np.array([1.0, 2.0]),
                                    np.array([0.3, -0.7]))
    out = eic.interp_to_cube(torch.as_tensor(f), w).numpy()
    np.testing.assert_allclose(out, 2.0 * np.array([0.3, -0.7]) + 3.0,
                               rtol=1e-12)


def test_state_from_latlon_analysis(packs):
    gj, gt, ak, bk, ptop = packs
    ana = latlon_analysis(ks=KS)
    want = jeic.state_from_latlon_analysis(ana, gj.geom, ak, bk, ptop)
    got = eic.state_from_latlon_analysis(ana, gt.geom, ak, bk, ptop,
                                         device="cpu")
    close_dicts(got, want, "state_from_latlon_analysis")
    ps_rec = ptop + got["delp"].sum(dim=1)
    close(ps_rec, got["ps"][:, 0], "ps from delp", tol=1e-10)
    ju, jv = jeic.d_winds_from_latlon(want["ua"], want["va"], gj)
    tu, tv = eic.d_winds_from_latlon(got["ua"], got["va"], gt)
    close(tu, ju, "d_winds u")
    close(tv, jv, "d_winds v")
    # remap_column_field on the analysis's own column
    pe1 = ana["ak_src"] + ana["bk_src"] * 1.0e5
    pe2 = ak + bk * 1.0e5
    f = np.moveaxis(ana["t"][:, :4, :5], 0, -1)
    close(eic.remap_column_field(torch.as_tensor(f), torch.as_tensor(pe1),
                                 torch.as_tensor(pe2)),
          jeic.remap_column_field(jnp.asarray(f), jnp.asarray(pe1),
                                  jnp.asarray(pe2)), "remap_column_field")


@pytest.mark.parametrize("flavour", ["ncep", "ncep_dry_t", "ecmwf", "fv"])
def test_latlon_flavours(packs, flavour):
    gj, gt, ak, bk, ptop = packs
    ana = latlon_analysis(ks=KS)
    if flavour.startswith("ncep"):
        raw = {"PS": ana["ps"], "PHIS": ana["phis"], "T": ana["t"],
               "Q": ana["sphum"], "U": ana["u"], "V": ana["v"],
               "hyai": ana["ak_src"], "hybi": ana["bk_src"],
               "lon": ana["lon"], "lat": ana["lat"]}
        kw = dict(t_is_virtual=flavour == "ncep")
        want = jeic.get_ncep_ic(raw, gj.geom, ak, bk, ptop, g=gj, **kw)
        got = eic.get_ncep_ic(raw, gt.geom, ak, bk, ptop, g=gt, **kw)
    elif flavour == "ecmwf":
        raw = {"sp": ana["ps"], "z": ana["phis"], "t": ana["t"],
               "q": ana["sphum"], "u": ana["u"], "v": ana["v"],
               "clwc": 1e-5 * ana["sphum"] / 1e-3,
               "ciwc": 2e-6 * np.ones_like(ana["t"]),
               "ak_src": ana["ak_src"], "bk_src": ana["bk_src"],
               "longitude": ana["lon"], "latitude": ana["lat"]}
        want = jeic.get_external_ic("ecmwf", raw, gj.geom, ak, bk, ptop,
                                    g=gj)
        got = eic.get_external_ic("ecmwf", raw, gt.geom, ak, bk, ptop, g=gt)
        assert "liq_wat" in got and "ice_wat" in got
    else:
        # the surface pressure integrated from delp; a tracer dict
        dyn = {k: ana[k] for k in ("lon", "lat", "ak_src", "bk_src", "t",
                                   "u", "v")}
        dyn["gz"] = ana["phis"]
        pe = (ana["ak_src"][:, None, None]
              + ana["bk_src"][:, None, None] * ana["ps"][None])
        dyn["delp"] = np.diff(pe, axis=0)
        tra = {"o3mr": 1e-7 * ana["sphum"] / 1e-3}
        want = jeic.get_fv_ic(dyn, gj.geom, ak, bk, ptop, g=gj, tra=tra)
        got = eic.get_fv_ic(dyn, gt.geom, ak, bk, ptop, g=gt, tra=tra)
    close_dicts(got, want, flavour)


@pytest.fixture(scope="module")
def cube_native(packs):
    """Cube-native source data at KS levels (the isothermal column of
    tests/test_external_nudge.py with seeded noise) and the HRRR extras."""
    gj, gt, ak, bk, ptop = packs
    rng = np.random.default_rng(5)
    aks = np.linspace(100.0, 0.0, KS + 1)
    bks = np.linspace(0.0, 1.0, KS + 1) ** 1.2
    ps = 1.0e5 + 100.0 * rng.standard_normal((6, N, N))
    pe = aks[None, :, None, None] + bks[None, :, None, None] * ps[:, None]
    zh = con.RDGAS * 260.0 / con.GRAV * np.log(pe[:, -1:] / pe)
    return dict(ps=ps, t=260.0 + rng.uniform(-1, 1, (6, KS, N, N)), zh=zh,
                sphum=1e-3 * (1 + 0.02 * rng.uniform(-1, 1, (6, KS, N, N))),
                w=0.3 + 0.01 * rng.standard_normal((6, KS, N, N)),
                ud=7.0 + rng.uniform(-1, 1, (6, KS, N + 1, N)),
                vd=-4.0 + rng.uniform(-1, 1, (6, KS, N, N + 1)),
                ak_src=aks, bk_src=bks)


@pytest.mark.parametrize("source", ["nggps", "hrrr"])
def test_cube_native_flavours(packs, cube_native, source):
    _, _, ak, bk, ptop = packs
    data = cube_native if source == "hrrr" else {
        k: v for k, v in cube_native.items() if k not in ("w", "ud", "vd")}
    want = jeic.get_external_ic(source, data, ak, bk, ptop)
    got = eic.get_external_ic(source, data, ak, bk, ptop, device="cpu")
    close_dicts(got, want, source)
    assert (got["delz"] < 0).all()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("nggps")
    aks, bks, ps, zh = write_nggps_files(d, N, KS, seed=3, hill=800.0)
    return d, aks, bks, ps, zh


def test_read_nggps_tiles_and_terrain_ps(packs, files):
    gj, gt, ak, bk, ptop = packs
    d, aks, bks, ps, zh = files
    want = jeic.read_nggps_tiles(str(d))
    got = eic.read_nggps_tiles(str(d))
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    np.testing.assert_allclose(got["ak_src"], aks)
    assert got["zh"].shape == (6, KS + 1, N, N)
    # a 500 m model mountain under the source column; the rest unmoved
    phis = np.zeros((6, N, N))
    phis[0, 5, 5] = con.GRAV * 500.0
    args = (phis, got["zh"], got["ps"], aks, bks)
    close(eic.adjust_ps_to_terrain(*args), jeic.adjust_ps_to_terrain(*args),
          "adjust_ps_to_terrain")
    adj = eic.adjust_ps_to_terrain(*args)
    assert adj[0, 5, 5] < ps[0, 5, 5]
    np.testing.assert_allclose(adj[phis == 0.0], ps[phis == 0.0],
                               rtol=1e-6)
    # a lat-lon analysis file read back by both readers
    from scipy.io import netcdf_file
    ana = latlon_analysis(ks=2, ny=5, nx=8)
    path = str(d / "analysis.nc")
    with netcdf_file(path, "w") as f:
        for nm, size in (("lev", 2), ("lat", 5), ("lon", 8)):
            f.createDimension(nm, size)
        f.createVariable("lon", "d", ("lon",))[:] = ana["lon"]
        f.createVariable("lat", "d", ("lat",))[:] = ana["lat"]
        f.createVariable("T", "d", ("lev", "lat", "lon"))[:] = ana["t"]
    want = jeic.read_latlon_netcdf(path, names={"T": "t"})
    got = eic.read_latlon_netcdf(path, names={"T": "t"})
    assert sorted(got) == sorted(want) == ["lat", "lon", "t"]
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    tiles = eic.read_nggps_tiles(str(d))
    wind = [tiles[k] for k in ("u_s", "v_s", "u_w", "v_w")]
    for a, b, nm in zip(eic.dgrid_winds_from_faces(*wind, gt.geom),
                        jeic.dgrid_winds_from_faces(*wind, gj.geom),
                        ("ud", "vd")):
        close(a, b, f"dgrid_winds_from_faces {nm}")


def test_get_nggps_ic_files(packs, files):
    gj, gt, ak, bk, ptop = packs
    d = str(files[0])
    want = jeic.get_nggps_ic_files(d, gj.geom, ak, bk, ptop)
    got = eic.get_nggps_ic_files(d, gt.geom, ak, bk, ptop, device="cpu")
    close_dicts(got, want, "get_nggps_ic_files")
    assert got["u"].shape == (6, NPZ, N + 1, N)
    assert (got["delz"] < 0).all()
