"""Named-tracer registry, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/utils/tracer_registry.py (the
FMS tracer_manager/field_manager equivalent). FV3 looks tracers up by name
(get_tracer_index, fv_dynamics.F90:254-267: sphum, liq_wat, ice_wat,
rainwat, snowwat, graupel, cld_amt, ...) and reads per-tracer metadata
from the field table (profile fills, units, advection overrides). The
port carries tracers as a dict name -> [6, K, n, n] tensor, so the
registry holds the metadata, the order and the initial fields, built on
an explicit device in an explicit dtype.
"""

from dataclasses import dataclass

import numpy as np
import torch

#: the GFDL moisture set in FV3's q-slot order (fv_arrays.F90 tracer
#: ordering; the nwat = 6 microphysics species, then cld_amt)
WATER_SPECIES = ("sphum", "liq_wat", "ice_wat", "rainwat", "snowwat",
                 "graupel")
CANONICAL_ORDER = WATER_SPECIES + ("cld_amt", "o3mr", "theta_d", "w_diff",
                                   "pbl_age")


@dataclass
class TracerSpec:
    """A field-table entry."""
    name: str
    longname: str = ""
    units: str = "kg/kg"
    profile_type: str = "fixed"     # set_tracer_profile: fixed | profile
    surface_value: float = 0.0
    top_value: float = 0.0
    is_water: bool = False
    adjust_mass: bool = True        # takes part in the moist-mass adjust
    hord: int | None = None         # per-tracer advection override
    kord: int | None = None


class TracerRegistry:
    """Ordered tracer metadata table (tracer_manager_mod analog)."""

    def __init__(self):
        self._specs: dict[str, TracerSpec] = {}

    def register(self, name, **kw):
        kw.setdefault("is_water", name in WATER_SPECIES)
        self._specs[name] = TracerSpec(name=name, **kw)
        return self._specs[name]

    def __contains__(self, name):
        return name in self._specs

    def __getitem__(self, name):
        return self._specs[name]

    @property
    def names(self):
        """The canonical species first (q-slot order), then the others in
        registration order."""
        canon = [n for n in CANONICAL_ORDER if n in self._specs]
        rest = [n for n in self._specs if n not in CANONICAL_ORDER]
        return tuple(canon + rest)

    def get_number_tracers(self):
        return len(self._specs)

    def get_tracer_index(self, name):
        """1-based index in canonical order (the Fortran contract); 0 when
        not found (get_tracer_index's NO_TRACER: callers check > 0)."""
        names = self.names
        return names.index(name) + 1 if name in names else 0

    @property
    def nwat(self):
        return sum(1 for s in self._specs.values() if s.is_water)

    def water_names(self):
        return tuple(n for n in self.names if self._specs[n].is_water)

    def set_tracer_profile(self, name, shape, dtype=torch.float32,
                           device="cuda"):
        """Initial field of one tracer (set_tracer_profile) on `device`:
        'fixed' fills with surface_value; 'profile' ramps log-linearly
        from top_value at the top to surface_value at the bottom."""
        s = self._specs[name]
        K = shape[1]
        if s.profile_type == "profile" and s.top_value > 0.0 \
                and s.surface_value > 0.0:
            prof = np.exp(np.linspace(np.log(s.top_value),
                                      np.log(s.surface_value), K))
            col = torch.as_tensor(prof, dtype=dtype, device=device)
            return col[None, :, None, None].expand(shape)
        return torch.full(shape, s.surface_value, dtype=dtype, device=device)

    def init_tracers(self, shape, dtype=torch.float32, device="cuda",
                     **overrides):
        """Dict of initial tracer fields; overrides supply analytic
        initial fields (e.g. sphum from the test case)."""
        q = {}
        for n in self.names:
            q[n] = overrides.get(n)
            if q[n] is None:
                q[n] = self.set_tracer_profile(n, shape, dtype=dtype,
                                               device=device)
        return q


def default_registry(nwat=6, with_cld_amt=True, extras=()):
    """The SHiELD-style default table (field_table analog)."""
    r = TracerRegistry()
    r.register("sphum", longname="specific humidity",
               profile_type="profile", surface_value=3e-6, top_value=1e-7)
    if nwat >= 2:
        r.register("liq_wat", longname="cloud water mixing ratio")
    if nwat >= 4:
        r.register("ice_wat", longname="cloud ice mixing ratio")
        r.register("rainwat", longname="rain mixing ratio")
    if nwat >= 6:
        r.register("snowwat", longname="snow mixing ratio")
        r.register("graupel", longname="graupel mixing ratio")
    if with_cld_amt:
        r.register("cld_amt", longname="cloud amount", units="1",
                   adjust_mass=False, kord=9)   # fv_dynamics.F90:571
    for n in extras:
        r.register(n)
    return r
