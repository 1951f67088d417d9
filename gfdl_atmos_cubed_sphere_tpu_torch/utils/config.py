"""Configuration system, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/utils/config.py (the role of FV3
model/fv_control.F90 fv_control_init:99 and its namelists :865-1156):
runtime options arrive as Fortran namelists in `input.nml`, and the same
names map onto the port's typed config dataclasses (DynConfig mirrors
fv_core_nml field for field where implemented, MPConfig mirrors
gfdl_mp_nml), so the JAX package's namelists, and FV3's, load unchanged.
The routing notes, the unknown-option dicts and the errors are the JAX
package's.

    from gfdl_atmos_cubed_sphere_tpu_torch.utils.config import load_input_nml
    dyn, mp, unknown = load_input_nml("input.nml", dt=450.0)
"""

import math
import re
from dataclasses import fields

from ..model.dyn_core import DynConfig
from ..physics.gfdl_mp import MPConfig

# fv_core_nml names consumed by OTHER subsystems than DynConfig (mapping
# noted); accepted silently and surfaced in the `routed` dict.
_ALIASES = {
    "npz_type": "grid.fv_eta.set_eta",
    "fv_eta_file": "grid.fv_eta",
    "layout": "parallel.shard_halo.hybrid_mesh(ly, lx)",
    "io_layout": "io (single-stream writer)",
    "ntiles": "always 6 (cubed sphere)",
    "npy": "npy == npx on the cube",
    "grid_type": "0 gnomonic / 4 planar (driver/nested.py)",
    "rf_fast": "DynConfig.rf_fast (capitalized RF_fast in F90)",
    "do_schmidt": "grid_kwargs_from_namelist",
    "do_cube_transform": "grid_kwargs_from_namelist",
    "stretch_fac": "grid_kwargs_from_namelist",
    "target_lat": "grid_kwargs_from_namelist",
    "target_lon": "grid_kwargs_from_namelist",
    "shift_fac": "grid.gnomonic (0-longitude shift)",
    "external_ic": "io.external_ic",
    "ncep_ic": "io.external_ic.get_ncep_ic",
    "nggps_ic": "io.external_ic.get_nggps_ic",
    "hrrrv3_ic": "io.external_ic.get_hrrr_ic",
    "ecmwf_ic": "io.external_ic.get_ecmwf_ic",
    "fv_diag_ic": "io.external_ic",
    "read_increment": "io.da_increment",
    "res_latlon_dynamics": "io.external_ic (prior-FV lat-lon IC)",
    "res_latlon_tracers": "io.external_ic",
    "use_gfso3": "io.external_ic (GFS ozone)",
    "fv_land": "utils.terrain (sgh/oro fractional land)",
    "deglon_start": "driver/nested.py planar domain",
    "deglon_stop": "driver/nested.py planar domain",
    "deglat_start": "driver/nested.py planar domain",
    "deglat_stop": "driver/nested.py planar domain",
    "domain_deg": "driver/nested.py planar domain",
    "halo_update_type": "parallel/halo.py strip-gather (single strategy)",
    "gfs_phil": "driver/shield.py (phil diagnostics)",
    "do_uni_zfull": "driver/shield.py",
    "adj_mass_vmr": "io.external_ic tracer mass adjustment",
    "update_blend": "model/boundary.py nest blending",
    "pass_full_omega_to_physics_in_non_hydrostatic_mode":
        "driver/shield.py statein",
}

# Recognized fv_core_nml options whose BEHAVIOR is not implemented: with
# strict=True these raise instead of being silently stored/dropped.
_UNSUPPORTED = {
    "hybrid_z": "hybrid-z vertical coordinate (fv_arrays.F90 hybrid_z)",
    "make_hybrid_z": "hybrid-z vertical coordinate",
    "non_ortho": "non-orthogonal grid corrections are always on",
    "smag2d": "2-D Smagorinsky damping variant",
    "nudge_ic": None,   # accepted on DynConfig (stored) — kept out of strict
}

# Recognized options consumed by startup helpers rather than DynConfig
# (io/restart.py make_nh_state / add_thermal_noise).
_ALIASES["make_nh"] = "io.restart.make_nh_state (w=0 + hydrostatic delz)"
_ALIASES["add_noise"] = "io.restart.add_thermal_noise"
_ALIASES["reset_eta"] = "io.restart.reset_eta (rebuild ak/bk + remap)"


def parse_namelist(text):
    """Parse Fortran namelist text -> {group: {name: value}}.

    Handles the subset FV3 namelists use: scalars, logicals (.T./.false.),
    strings, comma-separated arrays, '!' comments."""
    groups = {}
    cur = None
    for raw in text.splitlines():
        line = raw.split("!", 1)[0].strip()
        if not line:
            continue
        m = re.match(r"&(\w+)", line)
        if m:
            cur = {}
            groups[m.group(1).lower()] = cur
            line = line[m.end():].strip()
        if line.startswith("/"):
            cur = None
            continue
        if cur is None or not line:
            continue
        for part in re.finditer(r"(\w+)\s*=\s*([^=]+?)(?=(?:,?\s*\w+\s*=)|$)",
                                line):
            name, val = part.group(1).lower(), part.group(2).strip().rstrip(",")
            cur[name] = _convert(val)
    return groups


def _convert(val):
    v = val.strip()
    if re.fullmatch(r"\.?t(rue)?\.?", v, re.I):
        return True
    if re.fullmatch(r"\.?f(alse)?\.?", v, re.I):
        return False
    if v.startswith(("'", '"')):
        return v.strip("'\"")
    if "," in v:
        return [_convert(x) for x in v.split(",") if x.strip()]
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v.replace("d", "e").replace("D", "E"))
    except ValueError:
        return v


def dyn_config_from_namelist(nml, strict=False, **required):
    """Build a DynConfig from a parsed (or dict) fv_core_nml group.

    `required`: npx/npz/dt if not present in the namelist. Options consumed
    by other subsystems (_ALIASES) are accepted and reported in the
    returned dict under their routing note; options whose behavior is
    absent (_UNSUPPORTED) raise under strict=True: an explicit error
    instead of silent acceptance. Anything else unknown is collected and
    returned."""
    group = nml.get("fv_core_nml", nml) if isinstance(nml, dict) else {}
    known = {f.name for f in fields(DynConfig)}
    kwargs = dict(required)
    unknown = {}
    for name, value in group.items():
        if name in _UNSUPPORTED and _UNSUPPORTED[name] is not None:
            if strict:
                raise ValueError(
                    f"fv_core_nml option '{name}' is recognized but its "
                    f"behavior is not implemented: {_UNSUPPORTED[name]}")
            unknown[name] = value
        elif name in known:
            kwargs.setdefault(name, value)
        elif name in _ALIASES:
            unknown.setdefault("_routed", {})[name] = _ALIASES[name]
        else:
            if strict:
                raise ValueError(f"unknown fv_core_nml option '{name}'")
            unknown[name] = value
    if "npx" not in kwargs and "npx" in group:
        kwargs["npx"] = group["npx"]
    return DynConfig(**kwargs), unknown


def mp_config_from_namelist(nml):
    group = nml.get("gfdl_mp_nml", nml) if isinstance(nml, dict) else {}
    known = {f.name for f in fields(MPConfig)}
    kwargs = {k: v for k, v in group.items() if k in known}
    unknown = {k: v for k, v in group.items() if k not in known}
    return MPConfig(**kwargs), unknown


def load_input_nml(path, strict=True, **required):
    """Read an input.nml file -> (DynConfig, MPConfig, unknown-options).

    The driver-layer entry: with strict=True (the default) any fv_core_nml
    option whose behavior is not implemented (_UNSUPPORTED, e.g.
    hybrid_z/smag2d) raises an explicit error rather than being silently
    dropped. Every gfdl_mp_nml setting of MPConfig parses and runs
    (gfdl_mp_driver and the inline fast physics take them all); the
    options MPConfig does not know come back under "gfdl_mp_nml"."""
    with open(path) as f:
        nml = parse_namelist(f.read())
    dyn, unk1 = dyn_config_from_namelist(nml, strict=strict, **required)
    mpc, unk2 = mp_config_from_namelist(nml)
    return dyn, mpc, {"fv_core_nml": unk1, "gfdl_mp_nml": unk2}


def grid_kwargs_from_namelist(nml):
    """fv_core_nml grid-refinement options -> model.grid_ops.build_grid_ops
    keyword arguments (do_schmidt/do_cube_transform + stretch_fac,
    target_lon/lat in degrees, fv_control.F90:930-959, converted to radians
    as fv_grid_tools does)."""
    core = nml.get("fv_core_nml", {})
    kw = {}
    if core.get("do_schmidt") or core.get("do_cube_transform"):
        kw["stretch_fac"] = float(core.get("stretch_fac", 1.0))
        kw["target_lon"] = math.radians(float(core.get("target_lon", 0.0)))
        kw["target_lat"] = math.radians(float(core.get("target_lat", 0.0)))
        kw["do_cube_transform"] = bool(core.get("do_cube_transform", False))
    return kw
