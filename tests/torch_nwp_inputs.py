"""Seeded inputs of the NWP-initialisation tests (tests/test_torch_*.py of
io/external_ic.py, io/da_increment.py, physics/nudging.py): a chgres
cold-start file set written with scipy's NetCDF3 writer, as
tests/test_nggps_files.py writes it, and lat-lon analyses and increments.
Every field carries seeded noise: constant fields put the PPM limiters of
the remaps and of tracer_2d on ties, where the last bit decides."""

import numpy as np

from gfdl_atmos_cubed_sphere_tpu import constants as con

T0 = 280.0
P00 = 1.0e5


def source_levels(ks):
    """The source's hybrid coordinate [ks+1] of tests/test_nggps_files.py."""
    return np.linspace(100.0, 0.0, ks + 1), np.linspace(0.0, 1.0,
                                                        ks + 1) ** 1.3


def write_nggps_files(tmpdir, n, ks, seed=0, hill=0.0):
    """A chgres cold-start file set in tmpdir: gfs_ctrl.nc, gfs_data.tile{n}
    .nc (ps, zh from a near-isothermal column over flat source terrain,
    sphum, liq_wat, o3mr, the face winds, w) and, with hill > 0 (m), an
    oro_data.tile{n}.nc set whose orog_filt carries a Gaussian hill on
    tile 1. Returns (aks, bks, ps, zh)."""
    from scipy.io import netcdf_file
    rng = np.random.default_rng(seed)
    aks, bks = source_levels(ks)
    with netcdf_file(str(tmpdir / "gfs_ctrl.nc"), "w") as f:
        f.createDimension("levsp", ks + 1)
        f.createDimension("nvcoord", 2)
        v = f.createVariable("vcoord", "d", ("nvcoord", "levsp"))
        v[0, :] = aks
        v[1, :] = bks

    ps = P00 + 200.0 * rng.standard_normal((6, n, n))
    pe = aks.reshape(1, -1, 1, 1) + bks.reshape(1, -1, 1, 1) * ps[:, None]
    t = T0 + rng.uniform(-1.0, 1.0, (6, ks, n, n))
    # the heights integrated hydrostatically from the flat surface up
    dz = con.RDGAS * t / con.GRAV * np.log(pe[:, 1:] / np.maximum(pe[:, :-1],
                                                                 1.0))
    zh = np.concatenate([np.cumsum(dz[:, ::-1], axis=1)[:, ::-1],
                         np.zeros((6, 1, n, n))], axis=1)

    def noisy(base, shape, rel):
        return base * (1.0 + rel * rng.uniform(-1.0, 1.0, shape))

    for tile in range(6):
        with netcdf_file(str(tmpdir / f"gfs_data.tile{tile + 1}.nc"),
                         "w") as f:
            for nm, size in (("lev", ks), ("levp", ks + 1), ("lat", n),
                             ("lon", n), ("latp", n + 1), ("lonp", n + 1)):
                f.createDimension(nm, size)

            def put(nm, dims, data):
                f.createVariable(nm, "d", dims)[:] = data

            put("ps", ("lat", "lon"), ps[tile])
            put("zh", ("levp", "lat", "lon"), zh[tile])
            put("sphum", ("lev", "lat", "lon"),
                noisy(1.0e-3, (ks, n, n), 0.02))
            put("liq_wat", ("lev", "lat", "lon"),
                noisy(1.0e-6, (ks, n, n), 0.02))
            put("o3mr", ("lev", "lat", "lon"), noisy(1.0e-7, (ks, n, n),
                                                      0.02))
            put("u_s", ("lev", "latp", "lon"), noisy(10.0, (ks, n + 1, n),
                                                      0.05))
            put("v_s", ("lev", "latp", "lon"),
                rng.uniform(-0.5, 0.5, (ks, n + 1, n)))
            put("u_w", ("lev", "lat", "lonp"), noisy(10.0, (ks, n, n + 1),
                                                      0.05))
            put("v_w", ("lev", "lat", "lonp"),
                rng.uniform(-0.5, 0.5, (ks, n, n + 1)))
            put("w", ("lev", "lat", "lon"),
                0.01 * rng.standard_normal((ks, n, n)))
    if hill > 0.0:
        jj, ii = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        orog = np.zeros((6, n, n))
        orog[0] = hill * np.exp(-((jj - n / 2) ** 2 + (ii - n / 2) ** 2)
                                / (0.1 * n * n))
        for tile in range(6):
            with netcdf_file(str(tmpdir / f"oro_data.tile{tile + 1}.nc"),
                             "w") as f:
                f.createDimension("lat", n)
                f.createDimension("lon", n)
                f.createVariable("orog_filt", "d",
                                 ("lat", "lon"))[:] = orog[tile]
    return aks, bks, ps, zh


def latlon_analysis(ks=14, ny=73, nx=144, seed=1):
    """A lat-lon analysis in the `ana` layout of io/external_ic.py (the
    profile of tests/test_external_nudge.py, with seeded noise)."""
    rng = np.random.default_rng(seed)
    lon = np.linspace(0, 2 * np.pi, nx, endpoint=False)
    lat = np.linspace(-np.pi / 2 + 1e-4, np.pi / 2 - 1e-4, ny)
    LON, LAT = np.meshgrid(lon, lat)
    ak_src = np.linspace(100.0, 0.0, ks + 1)
    bk_src = np.linspace(0.0, 1.0, ks + 1) ** 1.5
    prof = np.linspace(0.2, 1.0, ks)[:, None, None]
    t = (250.0 + 40.0 * np.cos(LAT)[None] * prof
         + rng.uniform(-0.5, 0.5, (ks, ny, nx)))
    u = 20.0 * np.cos(LAT)[None] * (1.0 + 0.05 * rng.uniform(-1, 1, (ks, ny,
                                                                    nx)))
    v = rng.uniform(-1.0, 1.0, (ks, ny, nx))
    ps = 1.0e5 - 500.0 * np.sin(LAT) ** 2 + 50.0 * rng.standard_normal(
        (ny, nx))
    return dict(lon=lon, lat=lat, ps=ps, phis=100.0 * np.cos(LAT) ** 2,
                t=t, u=u, v=v,
                sphum=1e-3 * (1.0 + 0.02 * rng.uniform(-1, 1, t.shape)),
                ak_src=ak_src, bk_src=bk_src)


def latlon_increments(km, nlat=19, nlon=36, seed=2):
    """A GSI-style lat-lon increment dict (degrees; fields [km, nlat,
    nlon]) of T, delp, sphum, o3mr and the winds."""
    rng = np.random.default_rng(seed)
    lat = np.linspace(-90.0, 90.0, nlat)
    lon = np.arange(nlon) * (360.0 / nlon)
    shp = (km, nlat, nlon)
    return {"lon": lon, "lat": lat,
            "T_inc": rng.uniform(-1.0, 1.0, shp),
            "delp_inc": rng.uniform(-5.0, 5.0, shp),
            "sphum_inc": rng.uniform(-1e-5, 1e-5, shp),
            "o3mr_inc": rng.uniform(-1e-9, 1e-9, shp),
            "u_inc": rng.uniform(-1.0, 1.0, shp),
            "v_inc": rng.uniform(-1.0, 1.0, shp)}


def jitted_jax_remaps():
    """A context in which the JAX package's fv_mapz.map1_ppm runs jitted
    (one compile per shape and setting): its eager form compiles each
    primitive of the per-level profile on first use, ~15 s for the first
    cold start of a process against ~2.5 s jitted, on a CPU. Callers of
    map1_ppm (map1_ppm_ext, the remaps of io/external_ic.py and
    physics/nudging.py) look it up at call time, so they take the jitted
    form."""
    import jax
    import pytest
    from gfdl_atmos_cubed_sphere_tpu.ops import fv_mapz
    mp = pytest.MonkeyPatch()
    mp.setattr(fv_mapz, "map1_ppm",
               jax.jit(fv_mapz.map1_ppm,
                       static_argnames=("iv", "kord", "qmin")))
    return mp
