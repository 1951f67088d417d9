"""Standard output bundles, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/io/output_bundles.py (the roles
of FV3 tools/fv_nggps_diag.F90, the NCEP/UFS `gfs_dyn` field bundle :133,
and GFDL_tools/fv_cmip_diag.F90): assemble the named output sets from the
model state, with pressure-level interpolation for the CMIP set, and send
them to a DiagManager.
"""

import torch

from . import derived
from .diagnostics import DiagManager

# CMIP standard pressure levels (plev19, fv_cmip_diag usage)
PLEV19 = [100000.0, 92500.0, 85000.0, 70000.0, 60000.0, 50000.0, 40000.0,
          30000.0, 25000.0, 20000.0, 15000.0, 10000.0, 7000.0, 5000.0,
          3000.0, 2000.0, 1000.0, 500.0, 100.0]


def nggps_bundle(state, q, g, ptop):
    """The gfs_dyn output set (fv_nggps_diag.F90:133): winds, T, layer
    pressures, tracers and the surface pressure on model levels."""
    from ..model.fv_update_phys import cubed_to_latlon
    from ..model.thermodynamics import interface_pressure
    delp = state["delp"]
    pe = interface_pressure(delp, ptop)
    peln = torch.log(pe)
    out = {
        "ucomp": None, "vcomp": None,
        "temp": state["pt"],
        "delp": delp,
        "pfull": delp / (peln[:, 1:] - peln[:, :-1]),
        "ps": pe[:, -1],
    }
    ua, va = cubed_to_latlon(state["u"], state["v"], g)
    out["ucomp"], out["vcomp"] = ua, va
    if state.get("w") is not None:
        out["w"] = state["w"]
    if state.get("delz") is not None:
        out["delz"] = state["delz"]
    for name, qv in (q or {}).items():
        out[name] = qv
    return out


def cmip_bundle(state, q, g, ptop, plevs=None):
    """CMIP pressure-level set (fv_cmip_diag.F90): ua/va/ta/hus on
    standard levels, and psl."""
    plevs = plevs if plevs is not None else [85000.0, 50000.0, 25000.0]
    from ..model.fv_update_phys import cubed_to_latlon
    delp = state["delp"]
    pt = state["pt"]
    ua, va = cubed_to_latlon(state["u"], state["v"], g)
    levels = derived.pressure_weights(delp, ptop, plevs)
    out = {}
    for name, f in (("ua", ua), ("va", va), ("ta", pt)):
        out[name] = derived.apply_weights(f, levels)
    if q and "sphum" in q:
        out["hus"] = derived.apply_weights(q["sphum"], levels)
    ps = ptop + torch.sum(delp, dim=1)
    out["psl"] = derived.sea_level_pressure(ps, state.get("phis", ps * 0.0),
                                            pt[:, -1])
    out["plevs"] = torch.as_tensor(plevs, dtype=pt.dtype, device=pt.device)
    return out


def register_and_send(dm: DiagManager, bundle, prefix=""):
    for name, arr in bundle.items():
        if arr is None:
            continue
        key = prefix + name
        if key not in dm._fields:
            dm.register(key)
        dm.send(key, arr)
    return dm
