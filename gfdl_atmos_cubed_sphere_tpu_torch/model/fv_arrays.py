"""Master state container, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/model/fv_arrays.py (FV3
model/fv_arrays.F90 fv_atmos_type, :1242-1413): one dataclass holding the
prognostic fields, the tracers and the auxiliary pressure diagnostics as
tensors, with the same field names and the [6, K, y, x] / staggered
layouts as the rest of the port (fv_arrays.F90:1274-1335). The grid and
the flags live outside it (model/grid_ops.py and utils/config.py).
"""

from dataclasses import dataclass, field, fields, replace

import torch

PROGNOSTIC = ("u", "v", "w", "delp", "pt", "delz")
AUXILIARY = ("ps", "pe", "peln", "pk", "pkz", "omga", "ua", "va",
             "phis", "q_con")


@dataclass
class AtmosState:
    """Prognostic and auxiliary model state (fv_atmos_type analog).

    Cell fields [6, K, n, n]; u y-wall [6, K, n+1, n]; v x-wall
    [6, K, n, n+1]; edge pressures [6, K+1, n, n]; surface [6, n, n].
    The nonhydrostatic fields (w, delz) are None in hydrostatic runs, as
    are the auxiliaries the caller does not keep.
    """
    # prognostic (fv_arrays.F90:1274-1287)
    delp: torch.Tensor
    pt: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor | None = None
    delz: torch.Tensor | None = None
    #: tracers by name (utils/tracer_registry.py)
    q: dict = field(default_factory=dict)
    # auxiliary pressures and diagnostics (fv_arrays.F90:1300-1335)
    ps: torch.Tensor | None = None
    pe: torch.Tensor | None = None
    peln: torch.Tensor | None = None
    pk: torch.Tensor | None = None
    pkz: torch.Tensor | None = None
    omga: torch.Tensor | None = None
    ua: torch.Tensor | None = None
    va: torch.Tensor | None = None
    phis: torch.Tensor | None = None
    q_con: torch.Tensor | None = None

    # -- conversions -------------------------------------------------------

    @classmethod
    def from_dict(cls, d):
        names = {f.name for f in fields(cls)}
        q = dict(d.get("q") or {})
        return cls(**{k: v for k, v in d.items() if k in names and k != "q"},
                   q=q)

    def to_dict(self, include_none=False):
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if v is not None or include_none:
                out[f.name] = v
        return out

    def replace(self, **kw):
        return replace(self, **kw)

    @property
    def hydrostatic(self):
        return self.w is None

    def checksum(self):
        """Per-field fingerprints (mpp_chksum analog, fv_mp_mod.F90:34):
        the sum of the raw bit patterns mod 2**64, as Python ints."""
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if f.name == "q":
                for nm, a in v.items():
                    out[f"q/{nm}"] = _chksum(a)
            elif v is not None:
                out[f.name] = _chksum(v)
        return out


def _chksum(a):
    """Sum of the bit patterns of `a` as unsigned integers, mod 2**64: a
    float64 viewed as int64, a float32 viewed as int32 and taken unsigned
    (& 0xFFFFFFFF) in int64, other dtypes cast to int64. The int64 sum
    wraps, which is the sum mod 2**64 in two's complement; the Python int
    is taken mod 2**64 to read it unsigned."""
    x = torch.as_tensor(a).contiguous()
    if x.dtype == torch.float64:
        bits = x.view(torch.int64)
    elif x.dtype == torch.float32:
        bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    else:
        bits = x.to(torch.int64)
    return int(bits.sum()) % 2 ** 64
