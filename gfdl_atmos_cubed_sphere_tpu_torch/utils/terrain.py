"""Terrain generation and filtering, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/utils/terrain.py (FV3
tools/fv_surf_map.F90 del2_cubed_sphere:812 and del4_cubed_sphere:915, the
cell-centred diffusion of the surface height on the cube with sin_sg-
weighted wall fluxes, and the FV3_zs_filter:464 combination that surfdrv
uses), with an analytic terrain for idealised cases. The filters run on the
grid pack's device through its halo exchange; surfdrv's binning of a DEM
and the analytic terrain are host numpy.
"""

import numpy as np
import torch

from .. import constants as con
from ..model.grid_ops import device_of

H = 3


def del2_terrain(phis, g, cd, nmax=1, oro=None):
    """nmax passes of del-2 diffusion of a cell field (del2_cubed_sphere:812).

    phis [6, n, n] or [6, 1, n, n]; cd: the diffusion coefficient (m^2;
    FV3 uses ~0.12-0.25 * da_min). With `oro` (land fraction [6, n, n],
    0 water, 1 land), the zero_ocean limiter masks each wall flux with
    max(0, min(oro_left, oro_right)), so the smoothing moves no terrain
    into or out of water cells (fv_surf_map.F90
    del2_cubed_sphere:880-893)."""
    squeeze = phis.ndim == 3
    q = phis[:, None] if squeeze else phis          # [6, 1, n, n]
    n = g.n
    ctr = slice(H, H + n)
    wsl = slice(H, H + n + 1)                       # walls 0..n (padded idx)
    cl = slice(H - 1, H + n)                        # the cell left of a wall
    cr = slice(H, H + n + 1)                        # the cell right of a wall
    mx = my = None
    if oro is not None:
        op = g.halo.pad_cell(torch.as_tensor(oro, dtype=q.dtype,
                                             device=q.device)[:, None])
        mx = torch.clamp_min(torch.minimum(op[..., ctr, cl],
                                           op[..., ctr, cr]), 0.0)
        my = torch.clamp_min(torch.minimum(op[..., cl, ctr],
                                           op[..., cr, ctr]), 0.0)
    for _ in range(nmax):
        qp = g.halo.pad_cell(q)
        sgx = 0.5 * (g.sin_sg3[..., ctr, cl] + g.sin_sg1[..., ctr, cr])
        fx = (g.dy[..., ctr, wsl] * sgx * g.rdxc[..., ctr, wsl]
              * (qp[..., ctr, cl] - qp[..., ctr, cr]))
        sgy = 0.5 * (g.sin_sg4[..., cl, ctr] + g.sin_sg2[..., cr, ctr])
        fy = (g.dx[..., wsl, ctr] * sgy * g.rdyc[..., wsl, ctr]
              * (qp[..., cl, ctr] - qp[..., cr, ctr]))
        if mx is not None:
            fx = fx * mx
            fy = fy * my
        q = q + cd * g.rarea[..., ctr, ctr] * (
            fx[..., :, :-1] - fx[..., :, 1:]
            + fy[..., :-1, :] - fy[..., 1:, :])
    return q[:, 0] if squeeze else q


def del4_terrain(phis, g, nmax=1, oro=None):
    """A del-4 (biharmonic) filter pass (del4_cubed_sphere:915): the del-2
    of the del-2 increment, applied anti-diffusively; the zero_ocean mask
    as in del2_terrain."""
    cd = 0.16 * float(g.da_min)
    q = phis
    for _ in range(nmax):
        d2 = del2_terrain(q, g, cd, 1, oro=oro) - q
        q = q - (del2_terrain(d2, g, cd, 1, oro=oro) - d2)
    return q


def fv3_zs_filter(phis, g, n_del2_weak=12, n_del2_strong=0, n_del4=2,
                  oro=None):
    """The operational terrain-filter combination (FV3_zs_filter:464):
    strong del-2 passes, del-4 passes, then weak del-2 passes; `oro`
    engages the zero_ocean flux limiter throughout."""
    cd_weak = 0.12 * float(g.da_min)
    cd_strong = 0.20 * float(g.da_min)
    q = phis
    if n_del2_strong:
        q = del2_terrain(q, g, cd_strong, n_del2_strong, oro=oro)
    if n_del4:
        q = del4_terrain(q, g, n_del4, oro=oro)
    if n_del2_weak:
        q = del2_terrain(q, g, cd_weak, n_del2_weak, oro=oro)
    return q


def surfdrv(geom, dem_lon, dem_lat, dem_z, g=None, land_mask=None,
            filter_terrain=True, zero_ocean=False, device=None, **filter_kw):
    """The terrain driver (fv_surf_map.F90 surfdrv:92): bin a
    high-resolution source DEM onto the cube (host numpy), compute the
    subgrid-orography statistics the physics needs, and smooth with the
    operational zs filter when asked.

    dem_lon [NX], dem_lat [NY] (radians), dem_z [NY, NX] (m above sea
    level), land_mask optional [NY, NX] in [0,1]. Each source point goes to
    its nearest cube cell centre (the first-order equivalent of
    fv_surf_map.F90's binning into the enclosing cell, with no gnomonic
    inverse).

    Returns dict:
      phis  [6, 1, n, n]  filtered surface geopotential (m^2/s^2), float64
                          on g's device (or `device`, else the card)
      zs    [6, n, n]     unfiltered mean terrain height (m)
      sgh   [6, n, n]     subgrid standard deviation of the source heights
                          (m), the gravity-wave-drag field
      oro   [6, n, n]     land fraction (needs land_mask; else 1 where
                          zs > 0)
    """
    from scipy.spatial import cKDTree

    lon_c = geom.interior("aglon")                   # [6, n, n]
    lat_c = geom.interior("aglat")
    nt, n, _ = lon_c.shape
    centers = np.stack(lonlat_unit(lon_c.ravel(), lat_c.ravel()), axis=-1)
    tree = cKDTree(centers)

    glon, glat = np.meshgrid(np.asarray(dem_lon), np.asarray(dem_lat))
    pts = np.stack(lonlat_unit(glon.ravel(), glat.ravel()), axis=-1)
    _, idx = tree.query(pts, k=1)

    z = np.asarray(dem_z, dtype=np.float64).ravel()
    # the source-latitude area weights (lat-lon cells shrink as cos(lat))
    wt = np.cos(glat).ravel()
    wt = np.maximum(wt, 1e-6)
    ncell = nt * n * n
    wsum = np.bincount(idx, weights=wt, minlength=ncell)
    zsum = np.bincount(idx, weights=wt * z, minlength=ncell)
    z2sum = np.bincount(idx, weights=wt * z * z, minlength=ncell)
    hit = wsum > 0
    zs = np.zeros(ncell)
    zs[hit] = zsum[hit] / wsum[hit]
    var = np.zeros(ncell)
    var[hit] = np.maximum(z2sum[hit] / wsum[hit] - zs[hit] ** 2, 0.0)
    sgh = np.sqrt(var)
    if land_mask is not None:
        lsum = np.bincount(idx, weights=wt * np.asarray(land_mask).ravel(),
                           minlength=ncell)
        oro = np.where(hit, lsum / np.maximum(wsum, 1e-30), 0.0)
    else:
        oro = (zs > 0.0).astype(np.float64)
    if zero_ocean:
        zs = zs * (oro > 0.5)                       # zs_filter zero_ocean nml

    zs = zs.reshape(nt, n, n)
    sgh = sgh.reshape(nt, n, n)
    oro = oro.reshape(nt, n, n)
    if device is None and g is not None:
        device = g.device
    phis = torch.as_tensor(zs * con.GRAV,
                           device=device_of(device=device))[:, None]
    if filter_terrain and g is not None:
        phis = fv3_zs_filter(phis, g,
                             oro=(oro if zero_ocean else None),
                             **filter_kw)
    return {"phis": phis, "zs": zs, "sgh": sgh, "oro": oro}


def lonlat_unit(lon, lat):
    """Unit-sphere xyz from lon/lat arrays."""
    cl = np.cos(lat)
    return cl * np.cos(lon), cl * np.sin(lon), np.sin(lat)


def synthetic_terrain(geom, h0=2000.0, lat0=0.7, lon0=1.0, r0=0.4,
                      kind="gaussian"):
    """Idealised terrain (a surfdrv stand-in for tests, host numpy): a
    Gaussian hill or cosine bell in great-circle distance from (lon0,
    lat0). Returns phis [6, 1, n, n] (geopotential)."""
    lon = geom.interior("aglon")
    lat = geom.interior("aglat")
    cosd = (np.sin(lat0) * np.sin(lat)
            + np.cos(lat0) * np.cos(lat) * np.cos(lon - lon0))
    r = np.arccos(np.clip(cosd, -1.0, 1.0))
    if kind == "gaussian":
        zs = h0 * np.exp(-(r / r0) ** 2)
    else:
        zs = h0 * np.cos(np.pi * np.minimum(r / r0, 1.0) / 2.0) ** 2
    return (zs * con.GRAV)[:, None]
