"""SHiELD-style split driver API, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/driver/shield.py (FV3
driver/SHiELD/atmosphere.F90: atmosphere_init:205, atmosphere_dynamics:489,
atmosphere_state_update:1065, atmosphere_end, and the physics-interface
queries atmos_phys_driver_statein:1628, get_bottom_wind/mass,
atmosphere_grid_*). The host physics sees A-grid lat-lon winds and layer
pressures; its tendencies come back on the A grid and fv_update_phys
scatters them onto the D grid.

The state and everything derived from it are tensors on the Atmosphere's
device (the CUDA card unless the caller passes device="cpu"); the grid
and coordinate queries (atmosphere_grid_ctr, atmosphere_grid_bdry,
atmosphere_etalvls, atmosphere_pref) return numpy arrays of the host
geometry, as the JAX package's do.
"""

import numpy as np
import torch

from .. import constants as con
from .solo import Atmosphere as _SoloAtmosphere


class ShieldAtmosphere(_SoloAtmosphere):
    """Split-phase facade. Usage:
        atm = ShieldAtmosphere(npx, npz, dt)    # device="cpu" off the card
        atm.atmosphere_dynamics()               # dynamics only
        sin = atm.atmos_phys_driver_statein()
        ... host physics computes u_dt, v_dt, t_dt, q_dt ...
        atm.atmosphere_state_update(u_dt, v_dt, t_dt, q_dt)
        dm, out = atm.atmosphere_nggps_diag()
    """

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("physics", "none")
        super().__init__(*args, **kwargs)

    # -- dynamics phase ----------------------------------------------------

    def atmosphere_dynamics(self, nsteps=1):
        """Run the dynamics only (atmosphere_dynamics:489)."""
        return self.atmosphere(nsteps)

    # -- physics interface -------------------------------------------------

    def atmos_phys_driver_statein(self):
        """The physics state-in bundle (statein:1628): interface and layer
        pressures, A-grid winds, temperature, tracers, surface
        geopotential."""
        from ..io.derived import layer_pressures
        from ..model.fv_update_phys import cubed_to_latlon
        pe, _, p_lay = layer_pressures(self.state["delp"], self.ptop)
        ua, va = cubed_to_latlon(self.state["u"], self.state["v"], self.g)
        return dict(
            prsi=pe, prsl=p_lay, tgrs=self.state["pt"],
            ugrs=ua, vgrs=va,
            qgrs=dict(self.tracers or {}),
            phis=self.state["phis"],
        )

    def atmosphere_state_update(self, u_dt=None, v_dt=None, t_dt=None,
                                q_dt=None):
        """Apply host-physics tendencies per second on the A grid
        (atmosphere_state_update:1065)."""
        from ..model.fv_update_phys import fv_update_phys
        z = torch.zeros_like(self.state["pt"])
        pt, u, v, q = fv_update_phys(
            self.cfg.dt, self.state["pt"], self.state["delp"],
            self.state["u"], self.state["v"], self.tracers,
            u_dt if u_dt is not None else z,
            v_dt if v_dt is not None else z,
            t_dt if t_dt is not None else z,
            q_dt, self.g)
        self.state.update(pt=pt, u=u, v=v)
        self.tracers = q or self.tracers
        return self.state

    # -- query routines ----------------------------------------------------

    def get_bottom_wind(self):
        """Lowest-layer A-grid winds (get_bottom_wind)."""
        from ..model.fv_update_phys import cubed_to_latlon
        ua, va = cubed_to_latlon(self.state["u"], self.state["v"], self.g)
        return ua[:, -1], va[:, -1]

    def get_bottom_mass(self):
        """Lowest-layer temperature and the surface pressure
        (get_bottom_mass)."""
        ps = self.ptop + torch.sum(self.state["delp"], dim=1)
        return self.state["pt"][:, -1], ps

    def atmosphere_resolution(self):
        return self.cfg.npx - 1, self.cfg.npz

    def atmosphere_grid_ctr(self):
        """Cell-centre lon, lat (atmosphere_grid_ctr), host numpy."""
        return (self.g.geom.interior("aglon"),
                self.g.geom.interior("aglat"))

    def atmosphere_pref(self):
        """Reference pressure profile from ak, bk at 1013.25 hPa."""
        return self.ak + self.bk * con.PSTD_MKS

    def atmosphere_control_data(self):
        """(i-extent, j-extent, levels, p_hydro, hydro, tile count)
        (atmosphere_control_data:724)."""
        n = self.cfg.npx - 1
        return dict(i1=0, i2=n, j1=0, j2=n, kt=self.cfg.npz,
                    p_hydro=self.cfg.hydrostatic,
                    hydro=self.cfg.hydrostatic, ntiles=6)

    def atmosphere_grid_bdry(self):
        """Corner-point lon, lat (atmosphere_grid_bdry:139), host numpy."""
        from ..grid.gnomonic import xyz_to_lonlat
        H = self.g.geom.ng
        n = self.g.geom.n
        crn = self.g.geom.arrays["grid_xyz"][:, H:H + n + 1, H:H + n + 1]
        return xyz_to_lonlat(crn)

    def atmosphere_etalvls(self, flip=False):
        """ak, bk, optionally surface first (atmosphere_etalvls:809)."""
        ak = np.asarray(self.ak)
        bk = np.asarray(self.bk)
        return (ak[::-1], bk[::-1]) if flip else (ak, bk)

    def atmosphere_hgt(self, position="lay", relative=True, flip=False):
        """Layer ("lay") or interface heights, above ground (relative) or
        above sea level (atmosphere_hgt:826)."""
        from ..io.derived import layer_heights, layer_pressures
        _, peln, _ = layer_pressures(self.state["delp"], self.ptop)
        sph = (self.tracers or {}).get("sphum")
        zm, zb = layer_heights(delz=self.state.get("delz"),
                               pt=self.state["pt"], peln=peln, sphum=sph)
        if position == "lay":
            hgt = zm
        else:
            dz = 2.0 * (zm - zb)
            hgt = torch.cat([zb + dz, zb[:, -1:]], dim=1)
        if not relative:
            hgt = hgt + (self.state["phis"][:, 0] / con.GRAV)[:, None]
        return torch.flip(hgt, [1]) if flip else hgt

    def atmosphere_scalar_field_halo(self, data, halo=3):
        """Cube halo exchange of a physics-side scalar [6, ..., n, n]
        (atmosphere_scalar_field_halo:902). The exchange runs at the full
        ng-cell width; a narrower request is sliced down so the returned
        shape always matches the requested halo."""
        ng = self.g.geom.ng
        if halo > ng:
            raise ValueError(f"halo={halo} exceeds exchange width ng={ng}")
        padded = self.g.halo.pad_cell(data)
        if halo == ng:
            return padded
        cut = ng - halo
        return padded[..., cut:-cut, cut:-cut]

    def atmosphere_diss_est(self):
        """Dissipation estimate for SKEB (atmosphere_diss_est:975): the
        accumulated dissipative-heating proxy, zero unless the state
        carries one."""
        de = self.state.get("diss_est")
        return de if de is not None else torch.zeros_like(self.state["pt"])

    def atmosphere_nggps_diag(self, dm=None):
        """The registered-field diagnostic sweep (atmosphere_nggps_diag:1000)
        into a DiagManager (a new one unless given). Returns (dm, the dict
        of computed tensors)."""
        from ..io.diagnostics import DiagManager, fv_diag
        dm = dm or DiagManager()
        out = fv_diag(dm, dict(self.state), self.tracers, self.g, self.ak,
                      self.bk, self.ptop, hydrostatic=self.cfg.hydrostatic)
        return dm, out

    def atmos_phys_qdt_diag(self, q_before, q_after, dt):
        """Physics moisture-tendency diagnostics (atmos_phys_qdt_diag:1816):
        per-tracer dq/dt."""
        return {k: (q_after[k] - q_before[k]) / dt
                for k in q_before if k in q_after}

    def atmosphere_coarse_graining_parameters(self):
        """(factor, write flags) (atmosphere_coarse_graining_parameters
        :1913)."""
        return dict(
            factor=getattr(self.cfg, "coarsening_factor", 2),
            write_coarse_restart_files=getattr(
                self.cfg, "write_coarse_restart_files", False),
            write_only_coarse_intermediate_restarts=getattr(
                self.cfg, "write_only_coarse_intermediate_restarts",
                False))

    def atmosphere_coarsening_strategy(self):
        return getattr(self.cfg, "coarsening_strategy", "area")

    def atmosphere_domain(self):
        """Mesh and layout descriptor (atmosphere_domain:767)."""
        return dict(ntiles=6, npx=self.cfg.npx, layout=(1, 1),
                    regional=getattr(self.cfg, "regional", False),
                    bounded_domain=bool(getattr(self.g, "bounded", False)))
