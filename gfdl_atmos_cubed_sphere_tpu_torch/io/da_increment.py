"""Data-assimilation increments and the incremental analysis update (IAU),
PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/io/da_increment.py (FV3
tools/fv_treat_da_inc.F90 read_da_inc:82, which adds a GSI lat-lon analysis
increment to the state at a restart, and tools/fv_iau_mod.F90
IAU_initialize:121 / getiauforcing, which spreads the increment over a time
window as a forcing each step).

The increment file follows the GSI convention (fv_treat_da_inc.F90:150-260):
lat-lon fields on the model's km levels named u_inc, v_inc, T_inc,
delp_inc, delz_inc, sphum_inc, liq_wat_inc, o3mr_inc, icmr_inc (any
subset). They go to the cube with io/external_ic.py's bilinear weights, on
the grid pack's device (or the one the caller names); the wind increments
are A-grid lat-lon vectors scattered to the D grid by the
update_dwinds_phys projection (fv_treat_da_inc.F90:300-420). The IAU
weights are host floats.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..model.grid_ops import device_of
from .external_ic import (d_winds_from_latlon, interp_to_cube,
                          latlon_bilinear_weights, read_latlon_netcdf)

#: increment-file field -> model state field (cell scalars)
SCALAR_INC = {
    "T_inc": "pt",          # sensible temperature increment
    "delp_inc": "delp",
    "delz_inc": "delz",
    "sphum_inc": "sphum",
    "liq_wat_inc": "liq_wat",
    "o3mr_inc": "o3mr",
    "icmr_inc": "ice_wat",
}


def cube_increments(raw, geom, g=None, device=None):
    """Map a lat-lon increment dict onto the cube.

    raw: dict with 'lon' [nx], 'lat' [ny] (degrees) and fields [km, ny, nx]
    (numpy or tensors). Returns dict: model-field name -> [6, km, n, n]
    cube-cell increments, with 'u'/'v' the D-grid wind increments when
    u_inc/v_inc are present and g is given (else 'ua'/'va', the A-grid
    ones). On `device`, else g's, else device_of's."""
    if device is None and g is not None:
        device = g.device
    dev = device_of(*(raw[k] for k in raw if k not in ("lon", "lat")),
                    device=device)
    w = latlon_bilinear_weights(np.deg2rad(np.asarray(raw["lon"])),
                                np.deg2rad(np.asarray(raw["lat"])),
                                geom.interior("aglon"),
                                geom.interior("aglat"))

    def to_cube(f):
        # interp_to_cube takes [km, NY, NX] to [km, 6, n, n]; the model
        # layout is [6, km, n, n]
        return torch.movedim(interp_to_cube(torch.as_tensor(f, device=dev),
                                            w), 0, 1)

    out = {}
    for src, dst in SCALAR_INC.items():
        if src in raw:
            out[dst] = to_cube(raw[src])
    if "u_inc" in raw and "v_inc" in raw:
        ua = to_cube(raw["u_inc"])
        va = to_cube(raw["v_inc"])
        if g is None:
            out["ua"], out["va"] = ua, va
        else:
            out["u"], out["v"] = d_winds_from_latlon(ua, va, g)
    return out


def read_da_inc(path_or_raw, geom, g=None, device=None):
    """fv_treat_da_inc.F90 read_da_inc:82: load an increment file (or an
    already-read dict) and regrid it to cube increments."""
    raw = path_or_raw
    if isinstance(path_or_raw, str):
        raw = read_latlon_netcdf(path_or_raw)
    return cube_increments(raw, geom, g=g, device=device)


def apply_da_inc(state, inc, scale=1.0):
    """The one-shot restart application (read_da_inc's in-place adds,
    fv_treat_da_inc.F90:300-507): state and inc are dicts keyed by model
    field names; missing keys pass through."""
    out = dict(state)
    for k, dq in inc.items():
        if k in out and out[k] is not None:
            out[k] = out[k] + scale * dq
    return out


# ---------------------------------------------------------------------------
# IAU: the incremental analysis update (fv_iau_mod.F90)
# ---------------------------------------------------------------------------

@dataclass
class IAUConfig:
    """fv_iau_mod.F90 namelist analogues: iau_delthrs (the window, in
    seconds here) and iau_filter_increments (filtered weights)."""
    window_s: float = 21600.0
    filtered: bool = False


class IAU:
    """Spread `inc` over the IAU window: forcing(t, dt) returns the
    increments to add to the state this step (getiauforcing: a constant
    1/window weight, or raised-cosine filtered weights when
    cfg.filtered)."""

    def __init__(self, inc, cfg: IAUConfig, t_start=0.0):
        self.inc = inc
        self.cfg = cfg
        self.t0 = t_start

    def weight(self, t):
        """Per-second weight at model time t (0 outside the window; it
        integrates to ~1 over the window), a host float."""
        x = (t - self.t0) / self.cfg.window_s
        if x < 0.0 or x >= 1.0:
            return 0.0
        if not self.cfg.filtered:
            return 1.0 / self.cfg.window_s
        # raised-cosine (Hann) filtered IAU: smooth ramp in and out
        return float((1.0 - np.cos(2.0 * np.pi * x)) / self.cfg.window_s)

    def forcing(self, t, dt):
        """Dict of the step's increments (weight * dt * inc); an empty dict
        outside the window."""
        wt = self.weight(t) * dt
        if wt == 0.0:
            return {}
        return {k: wt * v for k, v in self.inc.items()}

    def apply(self, state, t, dt):
        wt = self.weight(t)
        return apply_da_inc(state, self.inc, scale=wt * dt) if wt else state
