"""GFDL/AM4-style driver facade, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/driver/gfdl.py (FV3
driver/GFDL/atmosphere.F90) over the same core as the SHiELD facade: the
AM4 coupler calls `atmosphere` (the combined step) and pulls the physics
and radiation input bundles through atmos_physics_driver_inputs:1473 and
atmos_radiation_driver_inputs:1532 (the Physics_input_block and
Radiation_input_block shapes). Everything else (init, domain queries,
restart) is the SHiELD facade's; tensors live on the Atmosphere's device.
"""

import torch

from .. import constants as con
from .shield import ShieldAtmosphere


class GFDLAtmosphere(ShieldAtmosphere):
    """AM4-coupler-facing facade (driver/GFDL/atmosphere.F90)."""

    def atmos_physics_driver_inputs(self):
        """Physics_input_block (atmosphere.F90:1473): layer and interface
        pressures and the interfaces' logs, temperature, tracers, A-grid
        winds, omega, and the heights of layers and interfaces above
        ground (from the hydrostatic thickness)."""
        sin = self.atmos_phys_driver_statein()
        pe, p_lay = sin["prsi"], sin["prsl"]
        peln = torch.log(pe)
        t = sin["tgrs"]
        sph = sin["qgrs"].get("sphum")
        tv = t * (1.0 + con.ZVIR * sph) if sph is not None else t
        dz = con.RDGAS * tv * (peln[:, 1:] - peln[:, :-1]) / con.GRAV
        z_half = torch.cat(
            [torch.flip(torch.cumsum(torch.flip(dz, [1]), 1), [1]),
             torch.zeros_like(dz[:, :1])], dim=1)
        z_full = 0.5 * (z_half[:, 1:] + z_half[:, :-1])
        return dict(sin, p_half=pe, p_full=p_lay, ln_p_half=peln,
                    t=t, z_half=z_half, z_full=z_full,
                    omega=self.state.get("omga"))

    def atmos_radiation_driver_inputs(self):
        """Radiation_input_block (atmosphere.F90:1532): the physics bundle
        restricted to what radiation reads (p, t, q, heights)."""
        b = self.atmos_physics_driver_inputs()
        return {k: b[k] for k in ("p_half", "p_full", "t", "qgrs",
                                  "z_half", "z_full", "phis")}
