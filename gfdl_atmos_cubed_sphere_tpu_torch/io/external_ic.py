"""External initial conditions, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/io/external_ic.py (FV3
tools/external_ic.F90 get_external_ic:94, get_ncep_ic:1206,
get_nggps_ic:290, get_hrrr_ic:816, get_fv_ic:2426): ingest gridded lat-lon
analyses (NetCDF through scipy, or plain arrays), interpolate them to the
cube, remap them vertically onto the model's hybrid ak/bk levels with the
monotone PPM operators, and build the prognostic state (delp from ps, D
winds from lat-lon winds through the update_dwinds_phys scatter); and the
chgres cold start from its tile files (gfs_ctrl.nc, gfs_data.tile{n}.nc,
oro_data.tile{n}.nc).

The file reads, the bilinear weights, the terrain ps adjustment and the
face-wind rotation are host numpy, as in the JAX package; the remaps run on
the device the caller names (the CUDA card unless the caller asks for the
CPU) or that of the input tensors. The bilinear weights stay float64, so a
float32 field interpolates to float64, as in the JAX package with x64 on.
"""

import os

import numpy as np
import torch

from .. import constants as con
from ..model.grid_ops import device_of
from ..ops import fv_mapz


# ---- horizontal interpolation --------------------------------------------

def latlon_bilinear_weights(src_lon, src_lat, dst_lon, dst_lat):
    """Bilinear interpolation weights (host, numpy): src_lon [NX] (radians,
    ascending, periodic), src_lat [NY] (ascending); dst of any shape.
    Returns a dict of the indices i0, i1, j0, j1 and weights wx, wy."""
    src_lon = np.asarray(src_lon)
    src_lat = np.asarray(src_lat)
    lon = np.mod(np.asarray(dst_lon), 2.0 * np.pi)
    lat = np.asarray(dst_lat)
    nx = src_lon.shape[0]

    i0 = np.searchsorted(src_lon, lon, side="right") - 1
    i0 = np.mod(i0, nx)
    i1 = np.mod(i0 + 1, nx)
    dlon = np.mod(src_lon[i1] - src_lon[i0], 2.0 * np.pi)
    wx = np.mod(lon - src_lon[i0], 2.0 * np.pi) / np.where(dlon == 0, 1, dlon)

    j0 = np.clip(np.searchsorted(src_lat, lat, side="right") - 1, 0,
                 src_lat.shape[0] - 2)
    j1 = j0 + 1
    wy = np.clip((lat - src_lat[j0]) / (src_lat[j1] - src_lat[j0]), 0.0, 1.0)
    return dict(i0=i0, i1=i1, j0=j0, j1=j1, wx=wx, wy=wy)


def _weights_on(w, device):
    """The weight set's indices as long tensors and weights as tensors of
    their own dtype on `device`, built once per weight set and device and
    kept in the dict."""
    cache = w.setdefault("_tensors", {})
    if device not in cache:
        cache[device] = tuple(
            torch.as_tensor(np.asarray(w[k]), device=device)
            for k in ("j0", "i0", "j1", "i1", "wx", "wy"))
    return cache[device]


def interp_to_cube(field, w):
    """field [..., NY, NX] -> [..., dst shape] with precomputed weights, on
    the field's device (a numpy field becomes a host tensor)."""
    f = torch.as_tensor(field)
    j0, i0, j1, i1, wx, wy = _weights_on(w, f.device)
    f00 = f[..., j0, i0]
    f01 = f[..., j0, i1]
    f10 = f[..., j1, i0]
    f11 = f[..., j1, i1]
    return ((1 - wy) * ((1 - wx) * f00 + wx * f01)
            + wy * ((1 - wx) * f10 + wx * f11))


# ---- vertical remap -------------------------------------------------------

def remap_column_field(field, pe_src, pe_dst, iv=1, kord=8):
    """Remap a [..., Ksrc] layer field between interface-pressure sets with
    the monotone PPM operators (external_ic.F90 remap_xyz pattern)."""
    return fv_mapz.map1_ppm(field, pe_src, pe_dst, iv=iv, kord=kord)


def _on(a, device):
    """A tensor on `device` (numpy keeps its dtype)."""
    return torch.as_tensor(a, device=device)


def _edges(ak, bk, ps):
    """Interface pressures ak + bk * ps [..., K+1] for ps [...]."""
    shape = (1,) * ps.ndim + (-1,)
    return (_on(ak, ps.device).reshape(shape)
            + _on(bk, ps.device).reshape(shape) * ps[..., None])


def state_from_latlon_analysis(ana, geom, ak, bk, ptop, kord=8,
                               device=None):
    """Build the model state from a lat-lon analysis dict:
      ana = {lon [NX] (rad), lat [NY] (rad), ps [NY,NX] (Pa),
             phis [NY,NX], t [Ks,NY,NX], sphum (optional),
             u [Ks,NY,NX], v [Ks,NY,NX],
             ak_src [Ks+1], bk_src [Ks+1]}  (source hybrid coordinate)
    Returns dict(delp, pt, ps, phis, ua, va, sphum?) on the cube, on
    `device` (see grid_ops.device_of: that of the analysis's tensors, or
    the card)."""
    dev = device_of(ana["ps"], device=device)
    w = latlon_bilinear_weights(ana["lon"], ana["lat"],
                                geom.interior("aglon"),
                                geom.interior("aglat"))
    ps = interp_to_cube(_on(ana["ps"], dev), w)               # [6, n, n]
    phis = interp_to_cube(_on(ana["phis"], dev), w)
    pe1 = _edges(ana["ak_src"], ana["bk_src"], ps)           # [6,n,n,Ks+1]
    pe2 = _edges(ak, bk, ps)
    delp = torch.movedim(pe2[..., 1:] - pe2[..., :-1], -1, 1)

    def remap(name, iv):
        f = interp_to_cube(_on(ana[name], dev), w)           # [Ks, 6, n, n]
        out = remap_column_field(torch.movedim(f, 0, -1), pe1, pe2, iv=iv,
                                 kord=kord)
        return torch.movedim(out, -1, 1)                     # [6, K, n, n]

    out = dict(delp=delp, pt=remap("t", 1), phis=phis[:, None],
               ps=ps[:, None])
    if "sphum" in ana:
        out["sphum"] = remap("sphum", 0)
    # the lat-lon winds at the A-grid centres; d_winds_from_latlon takes
    # them to the D grid
    out["ua"] = remap("u", -1)
    out["va"] = remap("v", -1)
    return out


def d_winds_from_latlon(ua, va, g):
    """A-grid lat-lon winds -> D-grid covariant winds, through the
    update_dwinds_phys projection with zero initial winds."""
    from ..model.fv_update_phys import update_dwinds_phys
    n = g.n
    K = ua.shape[1]
    u0 = torch.zeros((6, K, n + 1, n), dtype=ua.dtype, device=ua.device)
    v0 = torch.zeros((6, K, n, n + 1), dtype=ua.dtype, device=ua.device)
    return update_dwinds_phys(u0, v0, ua, va, g, dt=1.0)


def read_latlon_netcdf(path, names=None):
    """Read a lat-lon analysis NetCDF3 file into the `ana` dict layout
    (host numpy, in the native byte order: NetCDF3 stores big-endian
    values, which a tensor cannot hold)."""
    from scipy.io import netcdf_file
    names = names or {}
    out = {}
    with netcdf_file(path, "r", mmap=False) as f:
        for key, var in f.variables.items():
            a = np.array(var[:])
            out[names.get(key, key)] = a.astype(a.dtype.newbyteorder("="))
    return out


# ---- named source flavours (external_ic.F90 get_external_ic:94) -----------

#: NCEP/GFS spectral analysis variable names -> `ana` layout
NCEP_NAMES = {"PS": "ps", "PHIS": "phis", "T": "t", "Q": "sphum",
              "U": "u", "V": "v", "hyai": "ak_src", "hybi": "bk_src",
              "lon": "lon", "lat": "lat"}

#: ECMWF (ERA/IFS L137) variable names -> `ana` layout
ECMWF_NAMES = {"sp": "ps", "z": "phis", "t": "t", "q": "sphum",
               "u": "u", "v": "v", "clwc": "liq_wat", "ciwc": "ice_wat",
               "crwc": "rainwat", "cswc": "snowwat",
               "longitude": "lon", "latitude": "lat"}


def _rename(raw, names):
    return {names.get(k, k): v for k, v in raw.items()}


def _finish_latlon_ic(ana, geom, g, ak, bk, ptop, kord, tracers=(),
                      device=None):
    """The lat-lon flavours' common end: the analysis state, the named
    tracers remapped mass-weighted (iv = 0), the D winds when g is given.
    The device: `device`, else g's, else device_of's."""
    if device is None and g is not None:
        device = g.device
    st = state_from_latlon_analysis(ana, geom, ak, bk, ptop, kord=kord,
                                    device=device)
    dev = st["delp"].device
    names = [nm for nm in tracers if nm in ana]
    if names:
        w = latlon_bilinear_weights(ana["lon"], ana["lat"],
                                    geom.interior("aglon"),
                                    geom.interior("aglat"))
        ps = interp_to_cube(_on(ana["ps"], dev), w)
        pe1 = _edges(ana["ak_src"], ana["bk_src"], ps)
        pe2 = _edges(ak, bk, ps)
        for name in names:
            f = torch.movedim(interp_to_cube(_on(ana[name], dev), w), 0, -1)
            st[name] = torch.movedim(
                remap_column_field(f, pe1, pe2, iv=0, kord=kord), -1, 1)
    if g is not None:
        st["u"], st["v"] = d_winds_from_latlon(st["ua"], st["va"], g)
    return st


def get_ncep_ic(raw, geom, ak, bk, ptop, g=None, kord=8, t_is_virtual=True,
                device=None):
    """NCEP/GFS lat-lon analysis -> model state (external_ic.F90
    get_ncep_ic:1206). The NCEP temperature is virtual; it becomes the dry
    temperature after the humidity is interpolated."""
    st = _finish_latlon_ic(_rename(raw, NCEP_NAMES), geom, g, ak, bk, ptop,
                           kord, device=device)
    if t_is_virtual and "sphum" in st:
        zvir = con.RVGAS / con.RDGAS - 1.0
        st["pt"] = st["pt"] / (1.0 + zvir * st["sphum"])
    return st


def get_ecmwf_ic(raw, geom, ak, bk, ptop, g=None, kord=8, device=None):
    """ECMWF (ERA5/IFS) L137 hybrid-level analysis -> model state
    (external_ic.F90 get_ecmwf_ic:1663), with the four condensate species
    when present."""
    return _finish_latlon_ic(_rename(raw, ECMWF_NAMES), geom, g, ak, bk,
                             ptop, kord,
                             tracers=("liq_wat", "ice_wat", "rainwat",
                                      "snowwat"), device=device)


def _source_edges(data, ak, bk, dev):
    """The source's and the model's interface pressures [6, y, x, K+1] from
    the cube-native data's ps, ak_src, bk_src."""
    ps = _on(data["ps"], dev)
    return _edges(data["ak_src"], data["bk_src"], ps), _edges(ak, bk, ps)


def get_nggps_ic(data, ak, bk, ptop, kord=8, device=None):
    """Cube-native NGGPS/chgres input -> model state (external_ic.F90
    get_nggps_ic:290). `data` holds fields already on the cube: ps
    [6,n,n], zh [6,K_s+1,n,n] interface heights, t, sphum (+ tracers)
    [6,K_s,n,n] on the source's levels with ak_src/bk_src. Remaps them to
    (ak, bk) and derives delz from the remapped heights. On `device`, or
    that of data's ps when it is a tensor, or the card."""
    dev = device_of(data["ps"], device=device)
    pe1, pe2 = _source_edges(data, ak, bk, dev)
    delp = torch.movedim(pe2[..., 1:] - pe2[..., :-1], -1, 1)
    out = dict(delp=delp, ps=_on(data["ps"], dev)[:, None])

    def remap(name, iv):
        f = torch.movedim(_on(data[name], dev), 1, -1)
        return torch.movedim(
            fv_mapz.map1_ppm_ext(f, pe1, pe2, iv=iv, kord=kord), -1, 1)

    out["pt"] = remap("t", 1)
    for name in ("sphum", "liq_wat", "ice_wat", "rainwat", "snowwat",
                 "graupel"):
        if name in data:
            out[name] = remap(name, 0)
    if "zh" in data:
        # the specific-volume route for delz (get_nggps_ic's height remap)
        zh = _on(data["zh"], dev)
        dz1 = torch.movedim(zh[:, 1:] - zh[:, :-1], 1, -1)   # negative up
        spv = -dz1 / (pe1[..., 1:] - pe1[..., :-1])
        spv2 = fv_mapz.map1_ppm_ext(spv, pe1, pe2, iv=1, kord=kord)
        out["delz"] = -torch.movedim(spv2, -1, 1) * delp
    return out


def _wall_edges(pe, axis):
    """Interface pressures averaged onto the walls along `axis` (1: the
    y-walls of u, 2: the x-walls of v), the end walls taking the end
    cells' (external_ic.F90's u_s/v_w handling)."""
    lo = pe.narrow(axis, 0, 1)
    hi = pe.narrow(axis, pe.shape[axis] - 1, 1)
    return 0.5 * (torch.cat([lo, pe], axis) + torch.cat([pe, hi], axis))


def _hrrr_winds(data, ak, bk, kord, dev):
    """get_hrrr_ic's w and staggered-wind remaps: {w?, u?, v?}."""
    pe1, pe2 = _source_edges(data, ak, bk, dev)
    out = {}

    def remap(name, p1, p2):
        f = torch.movedim(_on(data[name], dev), 1, -1)
        return torch.movedim(
            fv_mapz.map1_ppm_ext(f, p1, p2, iv=-1, kord=kord), -1, 1)

    if "w" in data:
        out["w"] = remap("w", pe1, pe2)
    if "ud" in data:
        out["u"] = remap("ud", _wall_edges(pe1, 1), _wall_edges(pe2, 1))
        out["v"] = remap("vd", _wall_edges(pe1, 2), _wall_edges(pe2, 2))
    return out


def get_hrrr_ic(data, ak, bk, ptop, kord=8, device=None):
    """Preprocessed HRRR regional input -> model state (external_ic.F90
    get_hrrr_ic:816): as get_nggps_ic, with the D-grid staggered winds
    (ud/vd) and the nonhydrostatic w remapped as well.

    data: ps [6,y,x]; t, sphum (+tracers), w [6,K_s,y,x];
    zh [6,K_s+1,y,x]; ud [6,K_s,y+1,x]; vd [6,K_s,y,x+1];
    ak_src/bk_src [K_s+1]."""
    dev = device_of(data["ps"], device=device)
    out = get_nggps_ic(data, ak, bk, ptop, kord=kord, device=dev)
    out.update(_hrrr_winds(data, ak, bk, kord, dev))
    return out


def get_fv_ic(dyn, geom, ak, bk, ptop, g=None, tra=None, kord=8,
              device=None):
    """Initialise from a lat-lon FV-core run's restart (external_ic.F90
    get_fv_ic:2426): dyn supplies the source hybrid coordinate
    (ak_src/bk_src), the surface pressure (ps, or delp to integrate it),
    the surface geopotential, T and the winds; tra is an optional dict of
    lat-lon tracers remapped mass-weighted like sphum.

    dyn keys: lon, lat, ak_src, bk_src, phis (or gz), t, u, v and one of
    ps | delp[Ksrc,NY,NX]."""
    ana = dict(dyn)
    if "gz" in ana and "phis" not in ana:
        ana["phis"] = ana.pop("gz")
    if "ps" not in ana:
        dp = ana.pop("delp")
        ana["ps"] = float(ana["ak_src"][0]) + (
            dp.sum(dim=0) if torch.is_tensor(dp) else np.sum(dp, axis=0))
    if tra:
        ana.update(tra)
    return _finish_latlon_ic(ana, geom, g, ak, bk, ptop, kord,
                             tracers=tuple(tra or ()), device=device)


def get_external_ic(source, *args, **kw):
    """Dispatcher matching external_ic.F90 get_external_ic:94."""
    return {"ncep": get_ncep_ic, "ecmwf": get_ecmwf_ic,
            "nggps": get_nggps_ic, "hrrr": get_hrrr_ic,
            "fv": get_fv_ic}[source](*args, **kw)


# ---- the NGGPS/chgres tile-file layout --------------------------------------

def read_nggps_tiles(dirpath, prefix="gfs", tracers=("sphum", "liq_wat",
                                                     "o3mr")):
    """Read the chgres cold-start file set (external_ic.F90
    get_nggps_ic:290): {prefix}_ctrl.nc (vcoord -> ak/bk),
    {prefix}_data.tile{1..6}.nc (zh edge heights, ps, the face winds
    u_w/v_w/u_s/v_s as zonal/meridional components, w, tracers) and, when
    present, oro_data.tile{n}.nc (orog_filt -> phis). Returns the
    cube-assembled host `data` dict for get_nggps_ic_files. NetCDF3 layout
    (scipy's reader)."""
    from scipy.io import netcdf_file

    with netcdf_file(os.path.join(dirpath, f"{prefix}_ctrl.nc"), "r",
                     mmap=False) as f:
        vcoord = np.array(f.variables["vcoord"][:])
    # vcoord rows: [ak..., bk...] (levsp x 2 in chgres layout)
    if vcoord.ndim == 2:
        ak_src, bk_src = vcoord[0], vcoord[1]
    else:
        half = vcoord.size // 2
        ak_src, bk_src = vcoord[:half], vcoord[half:]

    fields = {}
    for t in range(6):
        path = os.path.join(dirpath, f"{prefix}_data.tile{t + 1}.nc")
        with netcdf_file(path, "r", mmap=False) as f:
            for name, var in f.variables.items():
                fields.setdefault(name, []).append(np.array(var[:]))
    data = {k: np.stack(v) for k, v in fields.items()
            if k not in ("lon", "lat", "lonc", "latc")}
    data["ak_src"] = np.asarray(ak_src, np.float64)
    data["bk_src"] = np.asarray(bk_src, np.float64)

    if os.path.exists(os.path.join(dirpath, "oro_data.tile1.nc")):
        phis = []
        for t in range(6):
            with netcdf_file(os.path.join(dirpath,
                                          f"oro_data.tile{t + 1}.nc"),
                             "r", mmap=False) as f:
                phis.append(np.array(f.variables["orog_filt"][:]))
        data["phis"] = np.stack(phis) * con.GRAV
    return data


def adjust_ps_to_terrain(phis, zh, ps_src, ak_src, bk_src, k2=None):
    """Surface pressure on the model terrain from the source column
    (remap_scalar:2818-2845, host numpy): log-p interpolated in the source
    geopotential profile, mirror-extended below ground. phis [6,n,n]; zh
    [6,K+1,n,n] source edge heights (top->bottom); ps_src [6,n,n]."""
    km = zh.shape[1] - 1
    k2 = max(10, km // 2) if k2 is None else k2
    pe0 = (np.asarray(ak_src).reshape(1, -1, 1, 1)
           + np.asarray(bk_src).reshape(1, -1, 1, 1) * ps_src[:, None])
    pn = np.log(pe0)                               # [6, K+1, n, n]
    gz = zh * con.GRAV
    # the mirror image below the surface (remap_scalar:2833-2837, 1-based
    # k = km+2..km+k2, l = 2(km+1)-k; 0-based: ext[m] takes the source
    # index 2km - m for m = km+1 .. km+k2-2)
    m = np.arange(km + 1, km + k2 - 1)
    ext_gz = 2.0 * gz[:, -1:] - gz[:, 2 * km - m]
    ext_pn = 2.0 * pn[:, -1:] - pn[:, 2 * km - m]
    gz_e = np.concatenate([gz, ext_gz], axis=1)    # decreasing downward
    pn_e = np.concatenate([pn, ext_pn], axis=1)
    # the bracketing interval gz[k] >= phis >= gz[k+1]
    ph = phis[:, None]
    above = (gz_e >= ph).astype(np.float64)        # 1 while above terrain
    kidx = np.clip(above.sum(axis=1, keepdims=True).astype(int) - 1, 0,
                   gz_e.shape[1] - 2)
    g0 = np.take_along_axis(gz_e, kidx, axis=1)[:, 0]
    g1 = np.take_along_axis(gz_e, kidx + 1, axis=1)[:, 0]
    p0 = np.take_along_axis(pn_e, kidx, axis=1)[:, 0]
    p1 = np.take_along_axis(pn_e, kidx + 1, axis=1)[:, 0]
    pst = p0 + (p1 - p0) * (g0 - phis) / np.maximum(g0 - g1, 1e-12)
    return np.exp(pst)


def dgrid_winds_from_faces(u_s, v_s, u_w, v_w, geom):
    """Face-wind components -> D-grid winds (get_nggps_ic:542-565, host
    numpy): ud = u_s e1.ex + v_s e1.ey on the south (y) walls, vd = u_w
    e2.ex + v_w e2.ey on the west (x) walls, with e1/e2 the wall-tangent
    unit vectors and ex/ey the local zonal/meridional basis. Only the
    compute domain of the geometry is read."""
    from ..grid.gnomonic import normalize, xyz_to_lonlat
    h = geom.ng
    n = geom.n
    cw = geom.arrays["grid_xyz"][:, h:h + n + 1, h:h + n + 1]
    es1 = geom.arrays["es"][:, h:h + n + 1, h:h + n, 0]    # u-wall tangents
    ew2 = geom.arrays["ew"][:, h:h + n, h:h + n + 1, 1]    # v-wall tangents

    def basis(mid_xyz):
        lon, lat = xyz_to_lonlat(mid_xyz)
        ex = np.stack([-np.sin(lon), np.cos(lon), np.zeros_like(lon)], -1)
        ey = np.stack([-np.sin(lat) * np.cos(lon),
                       -np.sin(lat) * np.sin(lon), np.cos(lat)], -1)
        return ex, ey

    ex, ey = basis(normalize(cw[:, :, :-1] + cw[:, :, 1:]))
    ud = (u_s * np.sum(es1 * ex, -1)[:, None]
          + v_s * np.sum(es1 * ey, -1)[:, None])
    ex, ey = basis(normalize(cw[:, :-1, :] + cw[:, 1:, :]))
    vd = (u_w * np.sum(ew2 * ex, -1)[:, None]
          + v_w * np.sum(ew2 * ey, -1)[:, None])
    return ud, vd


def get_nggps_ic_files(dirpath, geom, ak, bk, ptop, kord=8, prefix="gfs",
                       device=None):
    """The NGGPS cold start from the chgres tile-file set: read the files,
    adjust ps onto the model terrain, remap the scalars (get_nggps_ic),
    rotate the face winds to the D grid and remap them on wall-averaged
    pressures (get_hrrr_ic's wind path, without its second pass over the
    scalars). The reads and the host steps are numpy; the remaps run on
    `device` (the card unless the caller asks for the CPU). Returns the
    state dict (delp, pt, u, v, w, delz, ps, phis, tracers...)."""
    dev = device_of(device=device)
    data = read_nggps_tiles(dirpath, prefix=prefix)
    zh = np.asarray(data["zh"], np.float64)
    ps_src = np.asarray(data["ps"], np.float64)
    if ps_src.ndim == 4:
        ps_src = ps_src[:, 0]
    phis = np.asarray(data.get("phis", zh[:, -1] * con.GRAV), np.float64)
    if phis.ndim == 4:
        phis = phis[:, 0]
    data["ps"] = adjust_ps_to_terrain(phis, zh, ps_src, data["ak_src"],
                                      data["bk_src"])
    if "t" not in data:
        # T from the hydrostatic thickness of the source layers
        pe0 = (data["ak_src"].reshape(1, -1, 1, 1)
               + data["bk_src"].reshape(1, -1, 1, 1) * ps_src[:, None])
        pn0 = np.log(pe0)
        dz = zh[:, :-1] - zh[:, 1:]
        data["t"] = (con.GRAV * dz
                     / (con.RDGAS * (pn0[:, 1:] - pn0[:, :-1])))
    out = get_nggps_ic(data, ak, bk, ptop, kord=kord, device=dev)
    if "u_s" in data:
        data["ud"], data["vd"] = dgrid_winds_from_faces(
            data["u_s"], data["v_s"], data["u_w"], data["v_w"], geom)
        out.update(_hrrr_winds(data, ak, bk, kord, dev))
    out["phis"] = _on(phis, dev)[:, None]
    return out
