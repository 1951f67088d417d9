"""Diagnostics registry and state audits, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/io/diagnostics.py (the patterns
of FV3 tools/fv_diagnostics.F90): prt_maxmin/prt_mxm global min/max audits
(:105), range_check bounds (used at fv_dynamics.F90:817-827) and their
no-sync forms for a step's audit flags, the fv_debug NaN hunt
(fv_dynamics.F90:592-604), a diag_manager-style field registry
(register_diag_field/send_data, diag_table selection, time averaging,
NetCDF3 history files through scipy), the fv_diag sweep of derived fields,
column soundings, coarse-grained mirrors and the energy/water
conservation audit.

The registry keeps host records, as the JAX package's does: send copies a
tensor to the host (numpy), once per record. fv_diag computes on the
state's device; the grid's host geometry it reads (cell latitudes) moves
to that device once a call.
"""

import math
import re

import numpy as np
import torch

from .. import constants as con
from .restart import to_host

# FV3's 31 GFS standard pressure levels for the plev/levs suites
# (fv_diagnostics.F90:361), in hPa, top -> bottom.
STD_PLEVS = [1, 2, 3, 5, 7, 10, 20, 30, 50, 70, 100, 150, 200, 250, 300,
             350, 400, 450, 500, 550, 600, 650, 700, 750, 800, 850, 900,
             925, 950, 975, 1000]

# name -> (long_name, units) metadata mirroring register_diag_field calls
# in fv_diagnostics.F90 (subset; unlisted names register with blanks).
FIELD_CATALOG = {
    "ucomp": ("zonal wind", "m/sec"),
    "vcomp": ("meridional wind", "m/sec"),
    "temp": ("temperature", "K"),
    "delp": ("pressure thickness", "pa"),
    "delz": ("height thickness", "m"),
    "w": ("vertical wind", "m/sec"),
    "ps": ("surface pressure", "pa"),
    "slp": ("sea-level pressure", "mb"),
    "tm": ("mean 300-500 mb temp", "K"),
    "vort": ("vorticity", "1/s"),
    "pv": ("potential vorticity", "1/s"),
    "pv350K": ("350-K potential vorticity; needs x350 scaling",
               "(K m**2) / (kg s)"),
    "pv550K": ("550-K potential vorticity; needs x550 scaling",
               "(K m**2) / (kg s)"),
    "theta": ("potential temperature", "K"),
    "theta_e": ("equivalent potential temperature", "K"),
    "omega": ("omega", "Pa/s"),
    "divg": ("instantaneous divergence", "1/s"),
    "hght": ("height", "m"),
    "rh": ("relative humidity", "%"),
    "zsurf": ("surface height", "m"),
    "te": ("Total Energy", "J/m/s^2"),
    "ke": ("Total KE", "m^2/s^2"),
    "ws": ("wind speed", "m/s"),
    "reflectivity": ("Stoelinga simulated reflectivity", "dBz"),
    "max_reflectivity":
        ("Stoelinga simulated maximum (composite) reflectivity", "dBz"),
    "base_reflectivity":
        ("Stoelinga simulated base (1 km AGL) reflectivity", "dBz"),
    "4km_reflectivity": ("Stoelinga simulated base reflectivity", "dBz"),
    "echo_top": ("Echo top ( <= 18.5 dBz )", "m"),
    "m10C_reflectivity": ("Reflectivity at -10C level", "m"),
    "40dBz_height": ("Height of 40 dBz reflectivity", "m"),
    "cape": ("Convective available potential energy (surface-based)",
             "J/kg"),
    "cin": ("Convective inhibition (surface-based)", "J/kg"),
    "BRN": ("Bulk Richardson Number", "nondim"),
    "shear06": ("0--6 km shear", "m/s"),
    "srh01": ("0-1 km Storm Relative Helicity", "m/s**2"),
    "srh03": ("0-3 km Storm Relative Helicity", "m/s**2"),
    "srh25": ("2-5 km Storm Relative Helicity", "m/s**2"),
    "ustm": ("u Component of Storm Motion", "m/s"),
    "vstm": ("v Component of Storm Motion", "m/s"),
    "uh03": ("0-3 km Updraft Helicity", "m/s**2"),
    "uh25": ("2-5 km Updraft Helicity", "m/s**2"),
    "intqv": ("Vertically Integrated Water Vapor", "kg/m**2"),
    "intql": ("Vertically Integrated Cloud Water", "kg/m**2"),
    "intqi": ("Vertically Integrated Cloud Ice", "kg/m**2"),
    "intqr": ("Vertically Integrated Rain", "kg/m**2"),
    "intqs": ("Vertically Integrated Snow", "kg/m**2"),
    "intqg": ("Vertically Integrated Graupel", "kg/m**2"),
    "tq": ("Total water path", "kg/m**2"),
    "lw": ("Liquid water path", "kg/m**2"),
    "iw": ("Ice water path", "kg/m**2"),
    "tb": ("lowest layer temperature", "K"),
    "ctt": ("cloud_top temperature", "K"),
    "ctp": ("cloud_top pressure", "hPa"),
    "ctz": ("cloud_top height", "m"),
    "cat15": ("de-pression < 1000", "mb"),
    "cat25": ("de-pression < 980", "mb"),
    "cat35": ("de-pression < 964", "mb"),
    "cat45": ("de-pression < 944", "mb"),
    "f15": ("Cat15 frequency", "none"),
    "f25": ("Cat25 frequency", "none"),
    "f35": ("Cat35 frequency", "none"),
    "f45": ("Cat45 frequency", "none"),
    "uq": ("zonal moisture flux", "Kg/Kg*m/sec"),
    "vq": ("meridional moisture flux", "Kg/Kg*m/sec"),
    "ut": ("zonal heat flux", "K*m/sec"),
    "vt": ("meridional heat flux", "K*m/sec"),
    "uu": ("zonal flux of zonal wind", "(m/sec)^2"),
    "uv": ("zonal flux of meridional wind", "(m/sec)^2"),
    "vv": ("meridional flux of meridional wind", "(m/sec)^2"),
    "uw": ("vertical zonal momentum flux", "N/m**2"),
    "vw": ("vertical meridional momentum flux", "N/m**2"),
    "wq": ("vertical moisture flux", "Kg/Kg*m/sec"),
    "wt": ("vertical heat flux", "K*m/sec"),
    "ww": ("vertical flux of vertical wind", "(m/sec)^2"),
    "u_plev": ("zonal wind", "m/sec"),
    "v_plev": ("meridional wind", "m/sec"),
    "t_plev": ("temperature", "K"),
    "h_plev": ("height", "m"),
    "q_plev": ("specific humidity", "kg/kg"),
    "omg_plev": ("omega", "Pa/s"),
    "w_plev": ("vertical wind", "m/sec"),
    "vort_plev": ("vorticity", "1/s"),
    "rh_plev": ("relative humidity", "%"),
    "aam": ("angular momentum", "kg*m^2/s"),
    "pmask": ("masking pressure at lowest level", "mb"),
    "pmaskv2": ("masking pressure at lowest level", "mb"),
    "qn": ("cloud condensate", "kg/m/s^2"),
    "qp": ("precip condensate", "kg/m/s^2"),
    "pfhy": ("hydrostatic pressure", "pa"),
    "pfnh": ("non-hydrostatic pressure", "pa"),
    "ppnh": ("non-hydrostatic pressure perturbation", "pa"),
    "s200": ("200-mb wind_speed", "m/s"),
    "sl12": ("12th L wind_speed", "m/s"),
    "sl13": ("13th L wind_speed", "m/s"),
    "qn200": ("200mb condensate", "kg/m/s^2"),
    "qn500": ("500mb condensate", "kg/m/s^2"),
    "qn850": ("850mb condensate", "kg/m/s^2"),
    "rain5km": ("5-km AGL liquid water", "kg/kg"),
    "w5km": ("5-km AGL w-wind", "m/s"),
    "w2500m": ("2.5-km AGL w-wind", "m/s"),
    "w1km": ("1-km AGL w-wind", "m/s"),
    "wmaxup": ("column-maximum updraft (below 100 mb)", "m/s"),
    "wmaxdn": ("column-maximum downdraft (below 100 mb)", "m/s"),
    "x850": ("850-mb vertical comp. of helicity", "m/s**2"),
    "u100m": ("100-m AGL u-wind", "m/s"),
    "v100m": ("100-m AGL v-wind", "m/s"),
    "wind100m": ("100-m AGL windspeed", "m/s"),
    "us": ("surface u-wind", "m/sec"),
    "vs": ("surface v-wind", "m/sec"),
}


# ---- state audits ---------------------------------------------------------

def prt_maxmin(name, field, fac=1.0, out=print):
    """Global min/max printer (fv_diagnostics prt_maxmin), each scaled by
    fac. field: a tensor or an array. Returns (min, max)."""
    f = torch.as_tensor(field)
    lo = float(torch.min(f)) * fac
    hi = float(torch.max(f)) * fac
    out(f" {name:<10s} max = {hi:24.17g}  min = {lo:24.17g}")
    return lo, hi


RANGE_LIMITS = {
    # fv_dynamics.F90:817-827 defaults
    "ua": (-280.0, 280.0), "va": (-280.0, 280.0),
    "u": (-280.0, 280.0), "v": (-280.0, 280.0),
    "pt": (130.0, 350.0), "w": (-80.0, 100.0),
}


def range_check(name, field, lo=None, hi=None):
    """Bounds audit (fv_diagnostics range_check) against [lo, hi], or
    RANGE_LIMITS[name] when either is None (none for other names).
    Returns (ok, min, max); raising is the caller's choice."""
    if lo is None or hi is None:
        lo, hi = RANGE_LIMITS.get(name, (-np.inf, np.inf))
    f = torch.as_tensor(field)
    fmin = float(torch.min(f))
    fmax = float(torch.max(f))
    ok = (fmin >= lo and fmax <= hi and np.isfinite(fmin)
          and np.isfinite(fmax))
    return ok, fmin, fmax


def range_check_jit(name, field, lo=None, hi=None):
    """range_check with no host sync: 0-d tensors (ok, min, max) on the
    field's device, so a step can carry its audit flags without waiting
    for the device (FV3 runs range_check every step,
    fv_dynamics.F90:817-827)."""
    if lo is None or hi is None:
        lo, hi = RANGE_LIMITS.get(name, (-np.inf, np.inf))
    f = torch.as_tensor(field)
    fmin = torch.min(f)
    fmax = torch.max(f)
    ok = ((fmin >= lo) & (fmax <= hi) & torch.isfinite(fmin)
          & torch.isfinite(fmax))
    return ok, fmin, fmax


def audit_state(fields):
    """range_check_jit of each named field of a dict -> {name: (ok, min,
    max)} of device scalars; audit_ok folds it into one flag."""
    return {k: range_check_jit(k, v) for k, v in fields.items()
            if v is not None}


def audit_ok(audit):
    """One boolean device scalar: every field of an audit_state result
    within its bounds."""
    flags = [v[0] for v in audit.values()]
    out = flags[0]
    for f in flags[1:]:
        out = out & f
    return out


def coarse_diag(dm, fields, factor, strategy="area", area=None, prefix="crs_"):
    """Coarse-grained diagnostics mirror (coarse_grained_diagnostics.F90:78):
    send block-coarsened copies of `fields` (tensors or arrays) to the
    DiagManager under prefix+name, registering each on first use; "area"
    weights by `area` when given, anything else takes the block mean."""
    from ..utils import coarse_graining as cg
    for name, f in fields.items():
        if f is None:
            continue
        cname = prefix + name
        if cname not in dm._fields:
            dm.register(cname, long_name=f"coarse {name}", units="")
        fa = torch.as_tensor(f)
        if strategy == "area" and area is not None:
            c = cg.block_area_weighted_mean(
                fa, torch.as_tensor(area, dtype=fa.dtype, device=fa.device),
                factor)
        else:
            c = cg.block_mean(fa, factor)
        dm.send(cname, c)


def nan_check(tree):
    """Names of the fields of a dict that hold a NaN."""
    return [k for k, v in tree.items()
            if v is not None and bool(torch.isnan(torch.as_tensor(v)).any())]


# ---- diag registry --------------------------------------------------------

def parse_diag_table(text):
    """Parse an FMS `diag_table` (the runtime field-selection file FV3
    reads through diag_manager_mod; format documented in FMS
    diag_table.html): a title line, a base-date line, then file lines
      "file_name", output_freq, "freq_units", file_format, "time_units",
      "time_long_name"
    and field lines
      "module_name", "field_name", "output_name", "file_name",
      "time_sampling", "reduction_method", "regional_section", packing

    Returns dict(title, base_date, files={name: dict(freq, freq_units)},
    fields=[dict(module, field, output_name, file, reduction)], and
    selected = {field_name, ...} — the set fv_diag uses to restrict which
    diagnostics are computed/registered)."""
    title = None
    base_date = None
    files = {}
    fields = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if not line.startswith('"'):
            toks = line.split()
            if (base_date is None and len(toks) >= 6
                    and all(t.lstrip("-").isdigit() for t in toks[:6])):
                base_date = tuple(int(t) for t in toks[:6])
            elif title is None:
                title = line
            continue
        parts = [p.strip().strip('"')
                 for p in re.findall(r'"[^"]*"|[^,]+', line)]
        parts = [p for p in parts if p]
        if len(parts) < 4:
            continue
        if parts[1].lstrip("-").isdigit():        # file line
            files[parts[0]] = dict(freq=int(parts[1]),
                                   freq_units=parts[2].strip())
        else:                                     # field line
            fields.append(dict(
                module=parts[0], field=parts[1], output_name=parts[2],
                file=parts[3],
                reduction=parts[5] if len(parts) > 5 else ".false."))
    return dict(title=title, base_date=base_date, files=files,
                fields=fields,
                selected={f["field"] for f in fields})


def _host_copy(a):
    """A numpy copy of a tensor (from any device) or of an array-like."""
    if torch.is_tensor(a):
        return a.detach().to("cpu", copy=True).numpy()
    return np.array(a)


class DiagManager:
    """register_diag_field/send_data analog: named fields accumulated per
    send, kept as host records and written to a NetCDF3 history file.

    Time-interval averaging (diag_manager_mod's time_avg output): register
    with avg_interval=N to average every N sends into one record. Static
    (time-invariant) fields register with static=True and store once.

    `selection` (a set of field names, e.g. parse_diag_table(...)
    ["selected"]) restricts the manager to the listed fields: register()
    of any other name is a no-op returning None and send() to it returns
    False without touching the data (diag_table's runtime selection:
    register_diag_field returns id -1 for unlisted fields and every send
    is guarded on id > 0)."""

    def __init__(self, selection=None):
        self._fields = {}
        self._store = {}
        self._acc = {}
        self.selection = set(selection) if selection is not None else None

    def register(self, name, long_name="", units="", avg_interval=0,
                 static=False):
        if self.selection is not None and name not in self.selection:
            return None
        self._fields[name] = dict(long_name=long_name, units=units,
                                  avg=int(avg_interval), static=static)
        self._store[name] = []
        if avg_interval:
            self._acc[name] = [None, 0.0]   # running sum, weight
        return name

    def send(self, name, data, weight=1.0):
        """Record data (a tensor on any device, or an array) for a
        registered field: a host copy, or a float64 running sum when the
        field averages. False for a field not registered."""
        if name not in self._store:
            return False
        meta = self._fields[name]
        if meta.get("static"):
            if not self._store[name]:
                self._store[name].append(_host_copy(data))
            return True
        if meta.get("avg"):
            s, w = self._acc[name]
            d = _host_copy(data).astype(np.float64) * weight
            self._acc[name] = [d if s is None else s + d, w + weight]
            if self._acc[name][1] >= meta["avg"] - 1e-12:
                s, w = self._acc[name]
                self._store[name].append((s / w))
                self._acc[name] = [None, 0.0]
            return True
        self._store[name].append(_host_copy(data))
        return True

    def flush_avg(self, name=None):
        """Emit any partial averaging interval as a record (end of run)."""
        names = [name] if name else list(self._acc)
        for nm in names:
            s, w = self._acc.get(nm, (None, 0.0))
            if s is not None and w > 0:
                self._store[nm].append(s / w)
                self._acc[nm] = [None, 0.0]

    def series(self, name):
        return np.stack(self._store[name]) if self._store[name] else None

    def write_netcdf(self, path):
        """History file through scipy's NetCDF3 writer (the diag_manager
        send_data sink): one float32 variable per field with a record
        axis. The classic format's offsets are 32-bit: each variable must
        begin within the file's first 2 GiB."""
        from scipy.io import netcdf_file
        with netcdf_file(path, "w") as f:
            first = True
            for name, rows in self._store.items():
                if not rows:
                    continue
                arr = np.stack(rows)
                if first:
                    f.createDimension("time", arr.shape[0])
                    first = False
                dims = ["time"]
                for i, s in enumerate(arr.shape[1:]):
                    dn = f"{name}_d{i}"
                    f.createDimension(dn, s)
                    dims.append(dn)
                var = f.createVariable(name, "f", tuple(dims))
                var[:] = arr.astype(np.float32)
                var.long_name = self._fields[name]["long_name"]
                var.units = self._fields[name]["units"]


# ---- derived diagnostics --------------------------------------------------

def zonal_mean(field, lat, bins=64):
    """Area-unweighted zonal-mean profile on latitude bins (host numpy);
    field [6, ..., n, n], lat [6, n, n] (radians), tensors or arrays.
    Returns (lat_centers, mean[..., bins])."""
    f = to_host(field)
    la = to_host(lat)
    edges = np.linspace(-np.pi / 2, np.pi / 2, bins + 1)
    idx = np.clip(np.digitize(la, edges) - 1, 0, bins - 1)
    lead = f.shape[1:-2]
    fm = f.reshape((6,) + lead + (-1,))
    ix = idx.reshape(6, -1)
    out = np.zeros(lead + (bins,))
    cnt = np.zeros(bins)
    for t in range(6):
        np.add.at(out, (..., ix[t]), fm[t])
        np.add.at(cnt, ix[t], 1.0)
    return 0.5 * (edges[:-1] + edges[1:]), out / np.maximum(cnt, 1.0)


def surface_pressure(delp, ptop):
    return ptop + torch.sum(delp, dim=1)


class ColumnDiag:
    """Column ("sounding") diagnostics at named lat-lon locations
    (tools/fv_diag_column.F90 fv_diag_column_init and its location reader
    :60-200, the sounding printout): each location snaps to the nearest
    cube cell centre at init; sample() extracts whole columns (only they
    leave the device), printout() formats them."""

    def __init__(self, geom, points):
        """points: list of (name, lon_deg, lat_deg)."""
        lon = np.asarray(geom.interior("aglon"))
        lat = np.asarray(geom.interior("aglat"))
        self.points = []
        for name, plon, plat in points:
            lo = np.deg2rad(plon % 360.0)
            la = np.deg2rad(plat)
            # nearest cell centre by chord distance
            d = (np.cos(lat) * np.cos(la) * np.cos(lon - lo)
                 + np.sin(lat) * np.sin(la))
            t, j, i = np.unravel_index(np.argmax(d), lon.shape)
            self.points.append(dict(
                name=name, tile=int(t), j=int(j), i=int(i),
                lon=float(np.rad2deg(lon[t, j, i])),
                lat=float(np.rad2deg(lat[t, j, i]))))

    def sample(self, fields):
        """fields: dict name -> [T, K, n, n] (or [T, n, n]) tensors or
        arrays. Returns {point_name: {field: column ndarray}}."""
        out = {}
        for p in self.points:
            cols = {}
            for fname, arr in fields.items():
                if arr is None:
                    continue
                col = (arr[p["tile"], :, p["j"], p["i"]] if arr.ndim == 4
                       else arr[p["tile"], p["j"], p["i"]])
                cols[fname] = to_host(col)
            out[p["name"]] = cols
        return out

    def printout(self, fields, out=print):
        """Formatted sounding block per point (the do_diag_debug
        printout)."""
        samples = self.sample(fields)
        for p in self.points:
            cols = samples[p["name"]]
            out(f"=== column '{p['name']}' at ({p['lat']:.2f}N, "
                f"{p['lon']:.2f}E) tile {p['tile']} ===")
            names = [k for k, v in cols.items() if np.ndim(v) == 1]
            scalars = {k: v for k, v in cols.items() if np.ndim(v) == 0}
            for k, v in scalars.items():
                out(f"  {k} = {float(v):.6g}")
            # group profile fields by column length (K, K+1, 1, ...)
            lengths = sorted({len(cols[nm]) for nm in names})
            for L in lengths:
                grp = [nm for nm in names if len(cols[nm]) == L]
                out("  k   " + "  ".join(f"{k:>12s}" for k in grp))
                for kk in range(L):
                    out(f"  {kk:3d} " + "  ".join(
                        f"{float(cols[nm][kk]):12.5g}" for nm in grp))
        return samples


def fv_diag(dm, state, q, g, ak, bk, ptop, plevs=(850.0e2, 500.0e2, 200.0e2),
            hydrostatic=True, prefix="", plev_suite=True):
    """Standard diagnostic sweep (fv_diagnostics.F90 fv_diag:1590): the
    registered-field set from the prognostic state, each sent to the
    DiagManager `dm` (registered on first use).

    state: dict of tensors with delp, pt (temperature), u, v [, w, delz,
    omga, phis]; q: tracer dict or None. Sends the 3-D fields (winds,
    temperature, vorticity, PV, tracers, the thermodynamic set, fluxes),
    the 2-D ones (ps, slp, the pressure-level singles, reflectivity,
    updraft helicity, CAPE/CIN, the hurricane categories, ...) and the
    standard-pressure-level suites, and returns the dict of computed
    tensors, on the state's device."""
    from ..model.fv_update_phys import cubed_to_latlon
    from ..model.thermodynamics import compute_aam
    from .derived import (apply_weights, box_max, bulk_richardson,
                          bunkers_motion, cape_cin, divergence, echo_top,
                          equivalent_potential_temperature, interp_to_height,
                          interp_to_theta, layer_heights, layer_pressures,
                          potential_temperature, potential_vorticity,
                          pressure_weights, radar_reflectivity,
                          relative_humidity, relative_vorticity,
                          sea_level_pressure, storm_relative_helicity,
                          updraft_helicity, wind_shear)

    delp, pt, u, v = (state[k] for k in ("delp", "pt", "u", "v"))
    sph = (q or {}).get("sphum")
    out = {}
    # the interpolation weights of one pressure level, built once a call
    single = {}

    def at_p(f, p):
        if p not in single:
            single[p] = pressure_weights(delp, ptop, [p])
        return apply_weights(f, single[p])[:, 0]

    ua, va = cubed_to_latlon(u, v, g)
    out["ucomp"], out["vcomp"] = ua, va
    out["temp"] = pt
    out["delp"] = delp
    ps = ptop + torch.sum(delp, dim=1)
    out["ps"] = ps
    vort = relative_vorticity(u, v, g)
    out["vort"] = vort
    out["pv"] = potential_vorticity(u, v, pt, delp, g, ptop=ptop)
    phis2 = (state["phis"][:, 0] if state.get("phis") is not None
             else torch.zeros_like(ps))
    out["zsurf"] = phis2 / con.GRAV
    out["slp"] = sea_level_pressure(ps, phis2, pt[:, -1])
    if "omga" in state and state["omga"] is not None:
        out["omga"] = state["omga"]
    if q:
        for name, field in q.items():
            out[name] = field

    # ---- thermodynamic 3-D set (id_theta/theta_e/rh/divg/hght/ke/te) -----
    pe, peln, p_lay = layer_pressures(delp, ptop)
    out["theta"] = potential_temperature(pt, p_lay)
    out["divg"] = divergence(ua, va, g)
    out["ws"] = torch.sqrt(ua ** 2 + va ** 2)
    out["ke"] = 0.5 * (ua ** 2 + va ** 2)
    if sph is not None:
        out["theta_e"] = equivalent_potential_temperature(pt, p_lay, sph)
        out["rh"] = relative_humidity(pt, p_lay, sph)
    w = state.get("w")
    delz = state.get("delz")
    if not hydrostatic and delz is not None:
        zm, zbot = layer_heights(delz=delz)
        dz = -delz
        out["delz"] = delz
    else:
        zm, zbot = layer_heights(pt=pt, peln=peln, sphum=sph)
        dz = None
    out["hght"] = zm + (phis2 / con.GRAV)[:, None]
    cv_air = con.CP_AIR - con.RDGAS
    out["te"] = (cv_air * pt + 0.5 * (ua ** 2 + va ** 2)
                 + con.GRAV * out["hght"])
    if w is not None:
        out["w"] = w

    # ---- pressure-level set (u/v/t/vort/rh/theta_e/omg/q _plev) ----------
    for p in plevs:
        tag = f"{int(p / 100)}"
        fields = [("u", ua), ("v", va), ("t", pt), ("vort", vort)]
        if sph is not None:
            fields += [("rh", out["rh"]), ("thetae", out["theta_e"]),
                       ("q", sph)]
        if "omga" in out:
            fields.append(("omg", out["omga"]))
        for nm, f in fields:
            out[f"{nm}{tag}"] = at_p(f, p)
    if "u200" in out:
        out["s200"] = torch.sqrt(torch.nan_to_num(out["u200"]) ** 2
                                 + torch.nan_to_num(out["v200"]) ** 2)
    # mass-weighted 300-500 hPa mean temperature (id_tm, the
    # steering-layer metric of fv_diagnostics.F90:1483)
    msk = ((p_lay >= 3.0e4) & (p_lay <= 5.0e4)).to(pt.dtype)
    out["tm"] = (torch.sum(pt * delp * msk, dim=1)
                 / torch.clamp_min(torch.sum(delp * msk, dim=1), 1.0))

    # ---- condensate integrals and cloud top (intq*/lw/iw/ct*) ------------
    if q:
        qn = torch.zeros_like(pt)
        for name, short in (("sphum", "intqv"), ("liq_wat", "intql"),
                            ("rainwat", "intqr"), ("ice_wat", "intqi"),
                            ("snowwat", "intqs"), ("graupel", "intqg")):
            if name in q:
                out[short] = torch.sum(delp * q[name], dim=1) / con.GRAV
                if name != "sphum":
                    qn = qn + q[name]
        if "intql" in out and "intqr" in out:
            out["lw"] = out["intql"] + out["intqr"]
        if "intqi" in out and "intqs" in out and "intqg" in out:
            out["iw"] = out["intqi"] + out["intqs"] + out["intqg"]
        out["qn"] = qn
        cloudy = qn > 1.0e-6
        out["ctz"] = torch.amax(torch.where(cloudy, out["hght"],
                                            torch.full_like(pt, -1.0)), dim=1)
        big = torch.full_like(pt, 1.0e30)
        ctt = torch.amin(torch.where(cloudy, pt, big), dim=1)
        ctp = torch.amin(torch.where(cloudy, p_lay, big), dim=1)
        nan = torch.full_like(ctt, float("nan"))
        out["ctt"] = torch.where(ctt >= big[:, 0], nan, ctt)
        out["ctp"] = torch.where(ctp >= big[:, 0], nan, ctp)

    if q and "rainwat" in q:
        dbz, comp = radar_reflectivity(delp, pt, q,
                                       delz=state.get("delz"),
                                       peln=None if not hydrostatic
                                       else peln)
        out["reflectivity"] = dbz
        out["max_reflectivity"] = comp
        out["base_reflectivity"] = dbz[:, -1]
        out["4km_reflectivity"] = interp_to_height(dbz, zm, (4.0e3,))[:, 0]
        out["echo_top"] = echo_top(dbz, zm)

    # ---- severe-weather 2-D set (wz-interpolated winds, SRH, shear) ------
    out["us"], out["vs"] = ua[:, -1], va[:, -1]
    out["vorts"] = vort[:, -1]
    uvh = interp_to_height(ua, zm, (100.0,))[:, 0]
    vvh = interp_to_height(va, zm, (100.0,))[:, 0]
    out["u100m"], out["v100m"] = uvh, vvh
    out["wind100m"] = torch.sqrt(uvh ** 2 + vvh ** 2)
    dzw = dz if dz is not None else (zm - zbot) * 2.0
    out["shear06"] = wind_shear(ua, va, zm, dzw)
    ustm, vstm = bunkers_motion(ua, va, zm, dzw)
    out["ustm"], out["vstm"] = ustm, vstm
    out["srh01"] = storm_relative_helicity(ua, va, zm, dzw, ustm, vstm,
                                           0.0, 1.0e3)
    out["srh03"] = storm_relative_helicity(ua, va, zm, dzw, ustm, vstm,
                                           0.0, 3.0e3)
    if w is not None:
        for zt, nm in ((1.0e3, "w1km"), (2.5e3, "w2500m"), (5.0e3, "w5km")):
            out[nm] = interp_to_height(w, zm, (zt,))[:, 0]
        out["wmaxup"] = torch.amax(torch.clamp_min(w, 0.0), dim=1)
        out["wmaxdn"] = torch.amin(torch.clamp_max(w, 0.0), dim=1)
        out["uh03"] = updraft_helicity(vort, w, zm, dzw, 0.0, 3.0e3)
        if delz is not None:
            out["uh25"] = updraft_helicity(vort, w, zm, -delz)
    if sph is not None:
        cape, cin = cape_cin(pt, delp, sph, ptop)
        out["cape"] = cape
        out["cin"] = cin
        # total water path (kg/m^2)
        out["tq"] = torch.sum(delp * sph, dim=1) / con.GRAV
        out["BRN"] = bulk_richardson(cape, ua, va, zm, dzw)

    # ---- standard-pressure-level suites (id_u_plev and id_u_levs family,
    # fv_diagnostics.F90:985-1030, 574-600; the 31 GFS standard levels) --
    if plev_suite:
        suite_w = pressure_weights(delp, ptop,
                                   [p * 100.0 for p in STD_PLEVS])
        suites = {"u": ua, "v": va, "t": pt, "theta": out["theta"],
                  "vort": vort, "dp": delp,
                  "h": out["hght"]}
        if sph is not None:
            suites["q"] = sph
            suites["rh"] = out["rh"]
            suites["theta_e"] = out["theta_e"]
        if "omga" in out:
            suites["omg"] = out["omga"]
        elif w is not None and dz is not None:
            # omega ~ -rho g w = -(delp/dz) w where the core did not carry
            # omga (a pressure-velocity estimate, Pa/s)
            suites["omg"] = -delp / torch.clamp_min(dz, 1.0e-3) * w
        if w is not None:
            suites["w"] = w
        for qk, short in (("liq_wat", "ql"), ("ice_wat", "qi"),
                          ("rainwat", "qr"), ("snowwat", "qs"),
                          ("graupel", "qg"), ("cld_amt", "cf")):
            if q and qk in q:
                suites[short] = q[qk]
        named_levels = (100, 200, 250, 300, 500, 700, 850, 925)
        for nm, f in suites.items():
            fp = apply_weights(f, suite_w)
            out[f"{nm}_plev"] = fp
            # per-level named 2-D fields (id_*_levs: u850, z500, ...)
            for p in named_levels:
                k = STD_PLEVS.index(p)
                key = f"z{p}" if nm == "h" else f"{nm}{p}"
                out[key] = fp[:, k]
        # CMIP relative humidity singles (id_rh*_cmip)
        if sph is not None:
            for p in (10, 50, 100, 250, 300, 500, 700, 850, 925, 1000):
                k = STD_PLEVS.index(p) if p in STD_PLEVS else None
                if k is not None:
                    out[f"rh{p}_cmip"] = out["rh_plev"][:, k]

    # ---- 3-D flux products and vertical integrals (id_uq..id_iww,
    # fv_diagnostics.F90:1166-1256) --------------------------------------
    flux_pairs = [("uu", ua * ua), ("uv", ua * va), ("vv", va * va),
                  ("ut", ua * pt), ("vt", va * pt)]
    if sph is not None:
        flux_pairs += [("uq", ua * sph), ("vq", va * sph)]
    if w is not None:
        flux_pairs += [("uw", ua * w), ("vw", va * w), ("ww", w * w),
                       ("wt", w * pt)]
        if sph is not None:
            flux_pairs.append(("wq", w * sph))
    for nm, f in flux_pairs:
        out[nm] = f
        out[f"{nm}_vi"] = torch.sum(f * delp, dim=1)

    # ---- isentropic PV (id_pv350K/id_pv550K; "needs x350/x550 scaling")
    pv_theta = interp_to_theta(out["pv"], out["theta"], (350.0, 550.0))
    out["pv350K"] = pv_theta[:, 0]
    out["pv550K"] = pv_theta[:, 1]

    # ---- 2-D and 3-D singles of FV3's registry --------------------------
    out["tb"] = pt[:, -1]                       # lowest layer temperature
    out["pmask"] = p_lay[:, -1] / 100.0         # bottom-layer pressure, mb
    out["pmaskv2"] = pe[:, -1] / 100.0
    out["omega"] = out.get("omga", torch.zeros_like(pt))
    out["delp_total"] = delp
    out["x850"] = out.get("vort850", vort[:, -1])
    K = pt.shape[1]
    if K > 13:
        out["sl12"] = out["ws"][:, 11]          # 12th-level wind speed
        out["sl13"] = out["ws"][:, 12]
    if q:
        out["qp"] = (q.get("rainwat", 0.0) + q.get("snowwat", 0.0)
                     + q.get("graupel", 0.0)) * torch.ones_like(pt)
        for p in (200, 500, 850):
            if plev_suite:
                out[f"qn{p}"] = at_p(out["qn"], p * 100.0)
        if "liq_wat" in q:
            out["rain5km"] = interp_to_height(
                q.get("rainwat", q["liq_wat"]), zm, (5.0e3,))[:, 0]
    out["srh25"] = storm_relative_helicity(ua, va, zm, dzw, ustm, vstm,
                                           2.0e3, 5.0e3)
    if "reflectivity" in out:
        # reflectivity on the -10 C level, height of the 40 dBz surface
        first_warm = torch.cumsum((pt > 263.15).to(pt.dtype), dim=1) == 1.0
        out["m10C_reflectivity"] = torch.sum(
            torch.where(first_warm, out["reflectivity"],
                        torch.zeros_like(pt)), dim=1)
        dbz40 = torch.where(out["reflectivity"] >= 40.0, zm,
                            torch.full_like(zm, -1.0))
        out["40dBz_height"] = torch.amax(dbz40, dim=1)

    # ---- hydrostatic and NH pressures (id_pfhy/id_pfnh/id_ppnh) ---------
    if not hydrostatic and delz is not None:
        rrg = con.RDGAS / con.GRAV
        tvx = pt if sph is None else pt * (1.0 + con.ZVIR * sph)
        out["pfnh"] = -rrg * delp / delz * tvx
        out["pfhy"] = p_lay
        out["ppnh"] = out["pfnh"] - p_lay
    else:
        out["pfhy"] = p_lay

    # ---- angular momentum (id_aam) ---------------------------------------
    out["aam"] = compute_aam(u, v, delp, g, ptop)[0]

    # ---- hurricane categories (id_c15..id_f45, fv_diagnostics.F90:
    # 1627-1630, 1977-2030, 2423-2530): cat15 is SLP < 1000 mb inside a
    # storm mask (7x7 surface wind max > 16 m/s, |lat| < 45, terrain under
    # 500 m, cyclonic bottom and 850 mb vorticity, warm core: tm >= 254 K,
    # bottom T >= 281 K); cat25/35/45 also need a wind max > 20 m/s and
    # SLP < 980/964/944 ----------------------------------------------------
    lat = torch.as_tensor(g.geom.interior("aglat"), dtype=pt.dtype,
                          device=pt.device)
    north = lat > 0.0
    ws_max = box_max(out["ws"][:, -1], 7)
    cyc = torch.where(north, vort[:, -1] > 2.2e-5, vort[:, -1] < -2.2e-5)
    if "vort850" in out:
        v850 = torch.nan_to_num(out["vort850"])
        cyc = cyc & torch.where(north, v850 > 2.2e-5, v850 < -2.2e-5)
    storm = ((torch.abs(lat) < math.radians(45.0))
             & (phis2 / con.GRAV < 500.0) & (ws_max > 16.0) & cyc
             & (out["tm"] >= 254.0) & (pt[:, -1] >= 281.0))
    slp_mb = out["slp"] / 100.0
    cat_crt = storm & (ws_max > 20.0)
    for tag, crit, thresh in (("15", storm, 1000.0),
                              ("25", cat_crt, 980.0),
                              ("35", cat_crt, 964.0),
                              ("45", cat_crt, 944.0)):
        hit = crit & (slp_mb < thresh)
        out[f"cat{tag}"] = torch.where(hit, thresh - slp_mb,
                                       torch.zeros_like(slp_mb))
        out[f"f{tag}"] = hit.to(pt.dtype)

    out["zsurf_t"] = out["zsurf"]

    for name, arr in out.items():
        full = prefix + name
        if full not in dm._fields:
            dm.register(full, *FIELD_CATALOG.get(name, ("", "")))
        dm.send(full, arr)
    return out


def consv_checker(before, after, g, ptop, te_err=1.0e-5, tw_err=1.0e-6,
                  hydrostatic=True, out=print, strict=False):
    """Energy and water conservation audit (FV3's consv_checker, the
    te_err/tw_err namelist of fv_control.F90:1145; checks printed from
    fv_dynamics).

    before, after: state dicts of tensors with delp, pt (temperature), u,
    v [, w, delz, phis] and an optional tracer dict under "q". Returns
    (te_rel_err, tw_rel_err); reports through `out` beyond the thresholds
    and raises AssertionError there when strict."""
    from ..model.thermodynamics import (g_mean, interface_pressure,
                                        total_energy_2d_hydro,
                                        total_energy_2d_nh)

    def te(st):
        delp, pt = st["delp"], st["pt"]
        q = st.get("q") or {}
        sph = q.get("sphum")
        tv = pt * (1.0 + con.ZVIR * sph) if sph is not None else pt
        phis = st.get("phis")
        if phis is None:
            phis = torch.zeros_like(delp[:, 0])
        elif phis.ndim == 4:
            phis = phis[:, 0]
        if hydrostatic or st.get("w") is None:
            pe = interface_pressure(delp, ptop)
            te2 = total_energy_2d_hydro(st["u"], st["v"], tv, delp,
                                        torch.log(pe), pe, phis, g)
        else:
            te2 = total_energy_2d_nh(st["u"], st["v"], st["w"], tv,
                                     sph if sph is not None
                                     else torch.zeros_like(delp),
                                     delp, st["delz"], phis, g)
        return g_mean(te2, g)

    def tw(st):
        q = st.get("q") or {}
        wat = sum((q[k] for k in ("sphum", "liq_wat", "ice_wat", "rainwat",
                                  "snowwat", "graupel") if k in q),
                  torch.zeros_like(st["delp"]))
        return g_mean(torch.sum(st["delp"] * wat, dim=1), g)

    te0, te1 = float(te(before)), float(te(after))
    te_rel = abs(te1 - te0) / max(abs(te0), 1e-30)
    tw0, tw1 = float(tw(before)), float(tw(after))
    tw_rel = abs(tw1 - tw0) / max(abs(tw0), 1e-30) if tw0 != 0.0 else 0.0
    if te_rel > te_err:
        msg = f"consv_checker: TE error {te_rel:.3e} > te_err {te_err:.1e}"
        if strict:
            raise AssertionError(msg)
        out(msg)
    if tw_rel > tw_err:
        msg = f"consv_checker: TW error {tw_rel:.3e} > tw_err {tw_err:.1e}"
        if strict:
            raise AssertionError(msg)
        out(msg)
    return te_rel, tw_rel
