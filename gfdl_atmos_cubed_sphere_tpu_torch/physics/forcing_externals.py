"""External forcing inputs and the age-of-air tracer, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/physics/forcing_externals.py:
- FV3 tools/external_sst.F90 (:20-30): the NCEP/AMIP SST and anomaly
  store sampled onto the cube;
- tools/external_aero.F90 (load_aero:55, read_aero:172): the monthly
  aerosol climatology on pressure levels, interpolated in time and
  remapped to the model layers for the microphysics;
- tools/w_forcing.F90 (do_w_forcing:56): the idealised vertical-velocity
  forcing of grid_type 4 (bubble forcing type 1, the PBL specified-
  divergence nudging type 101);
- driver/solo/hswf.F90 (age_of_air:209): the idealised age-of-air clock.

The interpolation weights are host numpy; the level pick of the aerosol
remap is a gather (torch.searchsorted / torch.gather) where the JAX package
contracts one-hot masks, with the same values.
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from ..model.grid_ops import device_of


# ---- external SST ---------------------------------------------------------

@dataclass
class ExternalSST:
    """The sst_ncep/sst_anom store (external_sst.F90:25-27): lat-lon SST
    fields and the cached bilinear weights onto the cube A grid."""
    lons: np.ndarray            # [nlon] radians
    lats: np.ndarray            # [nlat] radians
    sst_ncep: np.ndarray        # [nlat, nlon] K
    sst_anom: np.ndarray = None
    forecast_mode: bool = False
    _wt: object = field(default=None, repr=False)

    def to_cube(self, geom, anomaly=False, device=None):
        """The SST (+ anomaly) at the cube cell centres [6, n, n] on
        `device` (the card unless the caller asks for the CPU). The field is
        cast to float32 first, whatever its type, as in the JAX package;
        the float64 weights then promote the result to float64."""
        from ..io.external_ic import interp_to_cube, latlon_bilinear_weights
        if self._wt is None:
            self._wt = latlon_bilinear_weights(
                self.lons, self.lats,
                geom.interior("aglon"), geom.interior("aglat"))
        f = self.sst_ncep if not anomaly else self.sst_ncep + self.sst_anom
        return interp_to_cube(torch.as_tensor(f, dtype=torch.float32,
                                              device=device_of(device=device)),
                              self._wt)


# ---- aerosol climatology --------------------------------------------------

@dataclass
class AeroClimatology:
    """The monthly aerosol climatology (external_aero.F90 load_aero:55):
    fields[name] of shape [12, kc, nlat, nlon] on the climatology's
    pressure layers, with interface pressures p_edge_c [kc+1] (Pa,
    ascending)."""
    lons: np.ndarray
    lats: np.ndarray
    p_edge_c: np.ndarray
    fields: dict
    _wt: object = field(default=None, repr=False)

    def at_time(self, month_frac):
        """Linear time interpolation between the bracketing months
        (read_aero:172 time_interp role); month_frac in [0, 12)."""
        m0 = int(np.floor(month_frac)) % 12
        m1 = (m0 + 1) % 12
        w = float(month_frac - np.floor(month_frac))
        return {k: (1.0 - w) * v[m0] + w * v[m1]
                for k, v in self.fields.items()}

    def to_model(self, geom, delp, ptop, month_frac):
        """Bilinear horizontal and log-p vertical interpolation of the
        climatology onto the model layers (read_aero:172 remap role), on
        delp's device. Returns a dict of [6, K, n, n]: float64 for float32
        cube fields against float64 log-pressures, as in the JAX
        package."""
        from ..io.external_ic import interp_to_cube, latlon_bilinear_weights
        if self._wt is None:
            self._wt = latlon_bilinear_weights(
                self.lons, self.lats,
                geom.interior("aglon"), geom.interior("aglat"))
        snap = self.at_time(month_frac)
        dev = delp.device

        pe = ptop + torch.cumsum(delp, dim=1)
        pe = torch.cat([torch.full_like(pe[:, :1], ptop), pe], dim=1)
        p_lay = 0.5 * (pe[:, 1:] + pe[:, :-1])            # [6,K,n,n]
        pc = 0.5 * (self.p_edge_c[1:] + self.p_edge_c[:-1])
        kc = len(pc)
        lp = torch.log(p_lay)
        lpc = torch.as_tensor(np.log(pc), device=dev)
        # piecewise linear in log-p, clamped at the ends: k0 = (the number
        # of climatology levels below lp, counted in float64) - 1, in
        # [0, kc - 2]; the levels' log-p then in lp's dtype, as in the JAX
        # package
        k0 = torch.clamp(torch.searchsorted(lpc, lp.double().contiguous())
                         - 1, 0, kc - 2)
        lpc = lpc.to(lp.dtype)
        l0, l1 = lpc[k0], lpc[k0 + 1]
        w = torch.clamp((lp - l0) / (l1 - l0), 0.0, 1.0)

        out = {}
        for name, fc in snap.items():
            fc32 = torch.as_tensor(fc, dtype=torch.float32, device=dev)
            cube = torch.stack([interp_to_cube(fc32[k], self._wt)
                                for k in range(kc)], dim=1)    # [6,kc,n,n]
            f0 = torch.gather(cube, 1, k0)
            f1 = torch.gather(cube, 1, k0 + 1)
            out[name] = (1.0 - w) * f0 + w * f1
        return out


# ---- idealised w forcing --------------------------------------------------

@dataclass
class WForcingConfig:
    """w_forcing_nml analogue (w_forcing.F90 module header)."""
    w_forcing_type: int = 1
    a: float = 0.02             # forcing amplitude (m/s^2), type 1
    i0: int = 0                 # bubble centre (cell index), type 1
    j0: int = 0
    L: float = 10.0e3           # x half-extent (m)
    R: float = 10.0e3           # y radius (m)
    H: float = 1.5e3            # height of the centre (m)
    D: float = 1.5e3            # height radius (m)
    divg: float = 5.0e-6        # large-scale divergence (1/s), type 101
    tau: float = 900.0          # nudging time scale (s), type 101
    start: float = 0.0
    end: float = -1.0           # < 0: always on
    dx_const: float = 1.0e3


def do_w_forcing(w, delz, phis, cfg: WForcingConfig, dt, time):
    """The idealised w forcing (w_forcing.F90 do_w_forcing:56), grid_type 4
    only. w/delz: [T, K, n, n]; phis: [T, n, n] (unpadded compute arrays).

    type 1: add an ellipsoidal acceleration bubble centred at (j0, i0, H).
    type 101: nudge w toward the specified-divergence profile w = -D*z
    with implicit relaxation, skipping the top two sponge levels."""
    if cfg.end > 0 and (time < cfg.start or time > cfg.end):
        return w
    T, K, n, _ = w.shape
    zsfc = phis[:, None] / 9.80665
    # the height at the TOP of each layer (delz < 0): reverse cumsum of |delz|
    zint = zsfc + torch.flip(torch.cumsum(torch.flip(-delz, dims=(1,)),
                                          dim=1), dims=(1,))
    zmid = zint + 0.5 * delz            # mid = top + delz/2

    if cfg.w_forcing_type == 1:
        ii = torch.arange(n, dtype=w.dtype, device=w.device)
        xL = torch.abs(ii - cfg.i0) * cfg.dx_const
        rad_y = ((ii - cfg.j0) * cfg.dx_const) ** 2 / (cfg.R * cfg.R)
        rad = rad_y[None, None, :, None] + ((zmid - cfg.H) / cfg.D) ** 2
        radm1 = torch.clamp_min(1.0 - torch.sqrt(rad), 0.0)
        mask = (xL[None, None, None, :] <= cfg.L).to(w.dtype)
        return w + cfg.a * radm1 * radm1 * dt * mask
    if cfg.w_forcing_type == 101:
        dttau = dt / cfg.tau
        forc = 1.0 / (1.0 + dttau)
        wls = -cfg.divg * (zmid - zsfc)          # w_ls = -D * z_AGL
        wnew = (w + dttau * wls) * forc
        k = torch.arange(K, device=w.device)[None, :, None, None]
        return torch.where(k >= 2, wnew, w)
    raise ValueError(f"w_forcing_type {cfg.w_forcing_type} not implemented")


# ---- age of air -----------------------------------------------------------

def age_of_air(q_age, pe_layers, time, p_source=75000.0, ascale=5.0e-6 / 60.0):
    """The idealised age-of-air clock (hswf.F90 age_of_air:209): below the
    source level the tracer is pinned to ascale*time; elsewhere it is
    advected freely. q_age / pe_layers (the top-interface p of each layer):
    [T,K,n,n]."""
    if time < 1.0e-6:
        return torch.zeros_like(q_age)
    return torch.where(pe_layers >= p_source,
                       torch.full_like(q_age, ascale * time), q_age)
