"""The PyTorch port's terrain filters and generator (utils/terrain.py)
against the JAX package's functions of the same names on the same seeded
inputs (float64, CPU, C12; the terrain cases of
tests/test_terrain_derived.py): del2_terrain with and without the
zero-ocean limiter, del4_terrain, fv3_zs_filter, surfdrv's DEM binning
with and without the filter and the zero-ocean option, lonlat_unit and
synthetic_terrain. Each output <= 1e-12 x its maximum; the limiter keeps
every water cell at zero and the land mass."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops as jax_pack
from gfdl_atmos_cubed_sphere_tpu.utils import terrain as jter
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import build_grid_ops
from gfdl_atmos_cubed_sphere_tpu_torch.utils import terrain as ter

pytestmark = pytest.mark.fast

NPX = 13
N = NPX - 1


def close(got, want, what, tol=1e-12):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(want).all(), what
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * (top if top > 0 else 1.0), what


@pytest.fixture(scope="module")
def packs():
    return (jax_pack(NPX, dtype=jnp.float64),
            build_grid_ops(NPX, dtype=torch.float64, device="cpu"))


def test_filters(packs):
    gj, gt = packs
    phis = jter.synthetic_terrain(gj.geom, h0=3000.0, r0=0.25)
    close(ter.synthetic_terrain(gt.geom, h0=3000.0, r0=0.25), phis,
          "synthetic_terrain")
    close(ter.synthetic_terrain(gt.geom, kind="bell"),
          jter.synthetic_terrain(gj.geom, kind="bell"), "cosine bell")
    J, T = jnp.asarray(phis), torch.as_tensor(phis)
    close(ter.fv3_zs_filter(T, gt, n_del2_weak=8, n_del2_strong=2,
                            n_del4=2),
          jter.fv3_zs_filter(J, gj, n_del2_weak=8, n_del2_strong=2,
                             n_del4=2), "fv3_zs_filter")
    close(ter.del4_terrain(T[:, 0], gt, nmax=2),
          jter.del4_terrain(J[:, 0], gj, nmax=2), "del4_terrain")
    # zero_ocean: an island with sharp edges on tile 1
    zs = np.zeros((6, N, N))
    oro = np.zeros((6, N, N))
    zs[0, 4:8, 4:8] = 1000.0
    oro[0, 3:9, 3:9] = 1.0
    cd = 0.15 * float(np.asarray(gj.da_min))
    for mask in (None, oro):
        got = ter.del2_terrain(torch.as_tensor(zs), gt, cd, nmax=4, oro=mask)
        close(got, jter.del2_terrain(jnp.asarray(zs), gj, cd, nmax=4,
                                     oro=mask), f"del2_terrain {mask is None}")
    area = gj.geom.interior("area")
    assert np.abs(got.numpy()[oro == 0.0]).max() == 0.0
    np.testing.assert_allclose(float((got.numpy() * area).sum()),
                               float((zs * area).sum()), rtol=1e-12)
    close(ter.fv3_zs_filter(torch.as_tensor(zs)[:, None], gt, oro=oro),
          jter.fv3_zs_filter(jnp.asarray(zs)[:, None], gj, oro=oro),
          "fv3_zs_filter zero_ocean")


def test_surfdrv(packs):
    gj, gt = packs
    lat = np.deg2rad(np.linspace(-90.0, 90.0, 91))
    lon = np.deg2rad(np.arange(180) * 2.0)
    LON, LAT = np.meshgrid(lon, lat)
    rng = np.random.default_rng(19)
    dem = (1000.0 * (1.0 + np.sin(LAT) * np.cos(2 * LON))
           + 50.0 * rng.standard_normal(LON.shape))
    land = (dem > 1000.0).astype(float)
    for kw in (dict(land_mask=land, filter_terrain=False),
               dict(filter_terrain=True, n_del2_weak=4, n_del4=1),
               dict(land_mask=land, zero_ocean=True)):
        want = jter.surfdrv(gj.geom, lon, lat, dem, g=gj, **kw)
        got = ter.surfdrv(gt.geom, lon, lat, dem, g=gt, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            close(got[k], want[k], f"surfdrv {k} {sorted(kw)}")
    got = ter.surfdrv(gt.geom, lon, lat, dem, device="cpu")
    close(got["phis"], jter.surfdrv(gj.geom, lon, lat, dem)["phis"],
          "surfdrv without a pack")
    for a, b in zip(ter.lonlat_unit(LON, LAT), jter.lonlat_unit(LON, LAT)):
        close(a, b, "lonlat_unit")
