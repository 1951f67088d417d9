"""CMIP-standard pressure-level diagnostics, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/io/cmip_diag.py (FV3
GFDL_tools/fv_cmip_diag.F90 fv_cmip_diag_init / fv_cmip_diag:58): the
CMIP-named output set interpolated to the CMIP standard pressure tables
(ta/ua/va/hus/zg/wap on plev19 or plev8), the single-level CMOR fields
(ta500, zg500, ua200, ...) and the near-surface and column fields, built
on io/derived.py's pressure interpolation (its weights built once a call)
and the DiagManager registry.
"""

import torch

from .. import constants as con

#: CMIP6 Amon standard 19 pressure levels (Pa)
PLEV19 = (100000., 92500., 85000., 70000., 60000., 50000., 40000., 30000.,
          25000., 20000., 15000., 10000., 7000., 5000., 3000., 2000.,
          1000., 500., 100.)
#: CMIP6 day-table 8 levels (Pa)
PLEV8 = (100000., 85000., 70000., 50000., 25000., 10000., 5000., 1000.)

#: the single-level CMOR names FV3 registers (fv_cmip_diag.F90 register
#: loop): field -> (source, pressure in Pa)
SINGLES = {
    "ta500": ("ta", 50000.0), "ta700": ("ta", 70000.0),
    "zg500": ("zg", 50000.0), "zg100": ("zg", 10000.0),
    "zg10": ("zg", 1000.0),
    "ua200": ("ua", 20000.0), "va200": ("va", 20000.0),
    "ua850": ("ua", 85000.0), "va850": ("va", 85000.0),
    "hus850": ("hus", 85000.0), "wap500": ("wap", 50000.0),
}


def fv_cmip_diag(dm, state, q, g, ak, bk, ptop, plevs=PLEV19,
                 hydrostatic=True, prefix="cmip/"):
    """Compute and send the CMIP set; returns the dict of tensors.

    state: dict of tensors with delp, pt (temperature), u, v [, w, delz,
    omga, phis]; q: tracer dict (sphum for hus and the virtual effect on
    zg)."""
    from ..model.fv_update_phys import cubed_to_latlon
    from ..model.thermodynamics import interface_pressure
    from .derived import apply_weights, layer_heights, pressure_weights

    delp, pt, u, v = (state[k] for k in ("delp", "pt", "u", "v"))
    sph = (q or {}).get("sphum")

    ua, va = cubed_to_latlon(u, v, g)
    ps = ptop + torch.sum(delp, dim=1)
    peln = torch.log(interface_pressure(delp, ptop))
    phis = state.get("phis")
    phis2d = phis[:, 0] if phis is not None and phis.ndim == 4 \
        else (phis if phis is not None else torch.zeros_like(ps))
    if not hydrostatic and state.get("delz") is not None:
        zmid_ag, _ = layer_heights(delz=state["delz"])
        zmid = zmid_ag + (phis2d / con.GRAV)[:, None]   # above sea level
    else:
        # hydrostatic heights from the hypsometric relation
        tv = pt * (1.0 + con.ZVIR * sph) if sph is not None else pt
        dlogp = peln[:, 1:] - peln[:, :-1]
        dz_half = con.RDGAS * tv * dlogp / con.GRAV
        ztop_rel = torch.flip(torch.cumsum(torch.flip(dz_half, [1]), 1),
                              [1])
        zedge_rel = torch.cat([ztop_rel, torch.zeros_like(ztop_rel[:, :1])],
                              dim=1)
        zsfc = phis2d / con.GRAV
        zmid = zsfc[:, None] + 0.5 * (zedge_rel[:, 1:] + zedge_rel[:, :-1])

    fields3d = {"ta": pt, "ua": ua, "va": va, "zg": zmid}
    if sph is not None:
        fields3d["hus"] = sph
    if state.get("omga") is not None:
        fields3d["wap"] = state["omga"]

    out = {}
    levels = pressure_weights(delp, ptop, plevs)
    for name, f in fields3d.items():
        out[name] = apply_weights(f, levels)
    single = {}
    for cmor, (src, p) in SINGLES.items():
        if src in fields3d:
            if p not in single:
                single[p] = pressure_weights(delp, ptop, [p])
            out[cmor] = apply_weights(fields3d[src], single[p])[:, 0]

    # CMOR surface and column fields from the dycore state
    out["ps"] = ps
    out["tas"] = pt[:, -1]                       # lowest-layer proxy
    out["uas"], out["vas"] = ua[:, -1], va[:, -1]
    if sph is not None:
        out["huss"] = sph[:, -1]
        out["prw"] = torch.sum(delp * sph, dim=1) / con.GRAV
    if q:
        lwp = sum(q[k] for k in ("liq_wat", "rainwat") if k in q)
        iwp = sum(q[k] for k in ("ice_wat", "snowwat", "graupel") if k in q)
        if not isinstance(lwp, int):
            out["clwvi"] = torch.sum(delp * lwp, dim=1) / con.GRAV
        if not isinstance(iwp, int):
            out["clivi"] = torch.sum(delp * iwp, dim=1) / con.GRAV

    for name, arr in out.items():
        full = prefix + name
        if full not in dm._fields:
            dm.register(full)
        dm.send(full, arr)
    return out
