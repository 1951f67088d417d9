"""State audits, PyTorch port.

Counterpart of the audit part of gfdl_atmos_cubed_sphere_tpu/io/
diagnostics.py (FV3 tools/fv_diagnostics.F90 prt_maxmin/prt_mxm global
min/max audits and range_check fatal bounds, used at fv_dynamics.F90:
817-827; the fv_debug NaN hunt of fv_dynamics.F90:592-604). The field
registry and the derived diagnostics are not ported yet.
"""

import numpy as np
import torch


def prt_maxmin(name, field, out=print):
    """Global min/max printer (fv_diagnostics prt_maxmin). field: a tensor
    or an array. Returns (min, max)."""
    f = torch.as_tensor(field)
    lo = float(torch.min(f))
    hi = float(torch.max(f))
    out(f" {name:<10s} max = {hi:24.17g}  min = {lo:24.17g}")
    return lo, hi


RANGE_LIMITS = {
    # fv_dynamics.F90:817-827 defaults
    "ua": (-280.0, 280.0), "va": (-280.0, 280.0),
    "u": (-280.0, 280.0), "v": (-280.0, 280.0),
    "pt": (130.0, 350.0), "w": (-80.0, 100.0),
}


def range_check(name, field):
    """Bounds audit (fv_diagnostics range_check) against RANGE_LIMITS[name]
    (none for other names). Returns (ok, min, max); raising is the
    caller's choice."""
    lo, hi = RANGE_LIMITS.get(name, (-np.inf, np.inf))
    f = torch.as_tensor(field)
    fmin = float(torch.min(f))
    fmax = float(torch.max(f))
    ok = (fmin >= lo and fmax <= hi and np.isfinite(fmin)
          and np.isfinite(fmax))
    return ok, fmin, fmax


def nan_check(fields):
    """Names of the fields of a dict that hold a NaN."""
    return [k for k, v in fields.items()
            if v is not None and bool(torch.isnan(torch.as_tensor(v)).any())]
