"""The climate-nudging file pipeline, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/io/climate_nudge_data.py (FV3
GFDL_tools/read_climate_nudge_data.F90 and the data path of
fv_climate_nudge.F90): CAM-style climatology NetCDF files with the axes
(lon, lat, lev) in degrees and the fields P0, hyai, hybi, PHI(S), PS, T, Q,
U, V (read_climate_nudge_data.F90:62-66; ak = hyai * P0, read_grid:283-327).
For each forcing time the two bracketing time levels are interpolated to
the model's A grid (remap_coef/remap_xy -> io.external_ic's bilinear
weights), the surface pressure is adjusted to the terrain (remap_ps,
fv_climate_nudge.F90:966), the fields are remapped to the model ak/bk
(remap_3d, linear in p, log-p for T), and linear time weights blend them,
with the State(1)/State(2) cache so that each file time level is processed
once (fv_climate_nudge.F90:372-390).

The file pipeline is host numpy, as in the JAX package, and so is
target_at. tendencies returns tensors on the state's device: each cached
time level goes to that device once, not once per call.
"""

from dataclasses import dataclass

import numpy as np
import torch

from .. import constants as con
from .external_ic import interp_to_cube, latlon_bilinear_weights
from .restart import to_host

# the accepted aliases of each required slot (the reference matches trimmed
# names)
_ALIASES = {
    "P0": ("P0",), "ak": ("hyai",), "bk": ("hybi",),
    "phis": ("PHI", "PHIS", "phis"), "ps": ("PS", "psrf", "ps"),
    "t": ("T", "temp"), "q": ("Q", "qhum", "sphum"),
    "u": ("U", "uwnd"), "v": ("V", "vwnd"),
    "lon": ("lon",), "lat": ("lat",), "time": ("time",),
}


def read_climate_nudge_file(path):
    """Open one climatology file -> dict with lon/lat (radians), ak/bk
    (ak scaled by P0), the time values, and the field arrays [time, lev,
    lat, lon] (2-D fields [time, lat, lon])."""
    from scipy.io import netcdf_file
    out = {}
    with netcdf_file(path, "r", mmap=False) as f:

        def get(slot, required=True):
            for nm in _ALIASES[slot]:
                if nm in f.variables:
                    return np.array(f.variables[nm][:], np.float64)
            if required:
                raise KeyError(f"climate nudge file {path}: no variable for "
                               f"'{slot}' (tried {_ALIASES[slot]})")
            return None

        out["lon"] = np.deg2rad(get("lon"))
        out["lat"] = np.deg2rad(get("lat"))
        p0 = get("P0", required=False)
        p0 = float(np.asarray(p0).reshape(-1)[0]) if p0 is not None else 1.0e5
        ak = get("ak", required=False)
        bk = get("bk")
        out["ak"] = (ak * p0) if ak is not None else np.zeros_like(bk)
        out["bk"] = bk
        out["time"] = get("time")
        for slot in ("phis", "ps", "t", "q", "u", "v"):
            arr = get(slot, required=slot in ("ps", "t", "q"))
            if arr is not None:
                out[slot] = arr
    return out


def remap_ps(gz_dat, ph_dat, pn_dat, tp_dat, phis):
    """Terrain-adjusted surface pressure (fv_climate_nudge.F90
    remap_ps:966): integrate the data heights hydrostatically; where the
    model terrain is above the data surface, interpolate pk in gz; below,
    extrapolate with the lowest layer's potential temperature. Shapes:
    gz_dat/phis [...], ph_dat/pn_dat [..., km+1], tp_dat [..., km].
    Returns ps [...]."""
    kappa = con.KAPPA
    km = tp_dat.shape[-1]
    pk0 = ph_dat ** kappa
    dgz = con.RDGAS * tp_dat * (pn_dat[..., 1:] - pn_dat[..., :-1])
    gz = np.concatenate(
        [gz_dat[..., None] + np.cumsum(dgz[..., ::-1], -1)[..., ::-1],
         gz_dat[..., None]], axis=-1)          # [..., km+1]

    above = phis > gz_dat
    # the k with gz[k] > phis >= gz[k+1]
    pst_interp = np.full_like(gz_dat, np.nan)
    for k in range(km - 1, -1, -1):
        hit = (phis < gz[..., k]) & (phis >= gz[..., k + 1]) \
            & np.isnan(pst_interp)
        pk_k = pk0[..., k] + (pk0[..., k + 1] - pk0[..., k]) \
            * (gz[..., k] - phis) / np.maximum(
                gz[..., k] - gz[..., k + 1], 1.0e-12)
        pst_interp = np.where(hit, pk_k, pst_interp)
    pst_interp = np.nan_to_num(pst_interp, nan=0.0)
    # the below-ground extrapolation with the lowest layer's theta
    pt0 = tp_dat[..., -1] / (pk0[..., -1] - pk0[..., -2]) * (
        kappa * (pn_dat[..., -1] - pn_dat[..., -2]))
    pst_extrap = pk0[..., -1] + (gz_dat - phis) / (con.CP_AIR * pt0)
    pst = np.where(above & (pst_interp > 0.0), pst_interp, pst_extrap)
    return pst ** (1.0 / kappa)


def _remap_3d(field, pe_src, pe_dst, log_p=False):
    """Linear-in-pressure vertical interpolation at the layer means
    (fv_climate_nudge remap_3d): field [..., km] on the source interfaces
    pe_src [..., km+1] -> [..., kn] on pe_dst [..., kn+1], clamped at the
    ends."""
    pm_s = 0.5 * (pe_src[..., 1:] + pe_src[..., :-1])
    pm_d = 0.5 * (pe_dst[..., 1:] + pe_dst[..., :-1])
    if log_p:
        pm_s = np.log(np.maximum(pm_s, 1.0e-10))
        pm_d = np.log(np.maximum(pm_d, 1.0e-10))
    km = field.shape[-1]
    idx = np.clip(
        np.sum(pm_s[..., None, :] < pm_d[..., :, None], axis=-1) - 1,
        0, km - 2)                                  # [..., kn]
    x0 = np.take_along_axis(pm_s, idx, -1)
    x1 = np.take_along_axis(pm_s, idx + 1, -1)
    f0 = np.take_along_axis(field, idx, -1)
    f1 = np.take_along_axis(field, idx + 1, -1)
    w = np.clip((pm_d - x0) / np.where(x1 == x0, 1.0, x1 - x0), 0.0, 1.0)
    return f0 + w * (f1 - f0)


def get_factor(npz, pfull=None, skip_top_v=2, skip_bot_v=0,
               skip_top_t=0, skip_bot_t=21, skip_bot_q=0, skip_top_q=8):
    """The vertical relaxation factors (fv_climate_nudge.F90
    get_factor:570): zero in the skipped top levels with a 0.25/0.5 ramp
    below, and a linear ramp from zero at the skipped bottom. Returns
    factor [npz, 3] for (momentum, temperature, humidity)."""
    factor = np.ones((npz, 3))
    for col, (top, bot) in enumerate(((skip_top_v, skip_bot_v),
                                      (skip_top_t, skip_bot_t),
                                      (skip_top_q, skip_bot_q))):
        if top > 0:
            factor[:top, col] = 0.0
            if top + 1 <= npz - 1:
                factor[top, col] = 0.25
            if top + 2 <= npz - 1:
                factor[top + 1, col] = 0.5
        if bot > 0:
            factor[npz - 1, col] = 0.0
            for k in range(npz - 2, max(npz - bot - 1, -1), -1):
                factor[k, col] = factor[k + 1, col] + 1.0 / bot
            factor[:, col] = np.minimum(factor[:, col], 1.0)
    return factor


@dataclass
class ClimateNudgeConfig:
    """fv_climate_nudge_nml subset (fv_climate_nudge.F90:82-96)."""
    freq: float = 21600.0
    u_tau: float = -1.0
    v_tau: float = -1.0
    t_tau: float = -1.0
    q_tau: float = -1.0
    ps_tau: float = -1.0
    skip_top_v: int = 2
    skip_bot_v: int = 0
    skip_top_t: int = 0
    skip_bot_t: int = 21
    skip_top_q: int = 8
    skip_bot_q: int = 0


class ClimateNudgeDriver:
    """File-driven climate nudging: holds the climatology, the model-grid
    interpolation weights and the two-level State cache, and gives the
    nudging tendencies for a model state at time t."""

    def __init__(self, paths, geom, ak_mod, bk_mod, phis_mod,
                 cfg: ClimateNudgeConfig = ClimateNudgeConfig()):
        if isinstance(paths, str):
            paths = [paths]
        self.data = [read_climate_nudge_file(p) for p in paths]
        d0 = self.data[0]
        self.lon_obs, self.lat_obs = d0["lon"], d0["lat"]
        self.ak_obs, self.bk_obs = d0["ak"], d0["bk"]
        self.cfg = cfg
        self.geom = geom
        self.ak_mod = to_host(ak_mod)
        self.bk_mod = to_host(bk_mod)
        # time flattened across the files
        self.times = np.concatenate([d["time"] for d in self.data])
        self._file_of = []
        for fi, d in enumerate(self.data):
            self._file_of += [(fi, ti) for ti in range(len(d["time"]))]
        # the model A-grid target points and weights (remap_coef analogue)
        self.lon_mod = np.asarray(geom.interior("aglon"))
        self.lat_mod = np.asarray(geom.interior("aglat"))
        self.w = latlon_bilinear_weights(self.lon_obs, self.lat_obs,
                                         self.lon_mod, self.lat_mod)
        self.phis_mod = to_host(phis_mod)
        if self.phis_mod.ndim == 4:
            self.phis_mod = self.phis_mod[:, 0]
        self._cache = {}                      # itime -> model-grid state
        self._on_device = {}                  # (itime, device) -> tensors

    # -- one file time level on the model grid (host) ----------------------
    def _level_state(self, itime):
        if itime in self._cache:
            return self._cache[itime]
        fi, ti = self._file_of[itime]
        d = self.data[fi]

        def hz(a):
            return interp_to_cube(a, self.w).numpy()

        ps_o = hz(d["ps"][ti])
        phis_d = d.get("phis")
        if phis_d is None:
            phis_o = np.zeros_like(ps_o)
        elif phis_d.ndim == 3:                # [time, lat, lon]
            phis_o = hz(phis_d[ti])
        else:                                 # static [lat, lon]
            phis_o = hz(phis_d)

        def column(name):
            return np.stack([hz(d[name][ti, k])
                             for k in range(d[name].shape[1])], axis=-1)

        t_o, q_o = column("t"), column("q")
        have_winds = "u" in d and "v" in d
        if have_winds:
            u_o, v_o = column("u"), column("v")
        # the virtual temperature for the ps remap (fv_climate_nudge:432)
        tv_o = t_o * (1.0 + con.ZVIR * q_o)
        ph_o = (self.ak_obs + self.bk_obs * ps_o[..., None])
        pn_o = np.log(np.maximum(ph_o, np.maximum(ph_o[..., 1:2] * 0.1,
                                                  1.0e-10)))
        ps = remap_ps(phis_o, ph_o, pn_o, tv_o, self.phis_mod)
        ph_m = self.ak_mod + self.bk_mod * ps[..., None]
        st = dict(ps=ps)
        st["t"] = _remap_3d(tv_o, ph_o, ph_m, log_p=True)
        st["q"] = _remap_3d(q_o, ph_o, ph_m)
        st["t"] = st["t"] / (1.0 + con.ZVIR * st["q"])
        if have_winds:
            st["u"] = _remap_3d(u_o, ph_o, ph_m)
            st["v"] = _remap_3d(v_o, ph_o, ph_m)
        # the levels on axis 1: [T, K, n, n]
        for k in ("t", "q", "u", "v"):
            if k in st:
                st[k] = np.moveaxis(st[k], -1, 1)
        self._cache[itime] = st
        if len(self._cache) > 2:              # the two-level State cache
            old = min(k for k in self._cache if k != itime)
            self._cache.pop(old)
            for key in [key for key in self._on_device if key[0] == old]:
                self._on_device.pop(key)
        return st

    def _bracket(self, t):
        """[(itime, weight)] of the one or two time levels at time t."""
        ts = self.times
        if t <= ts[0]:
            return [(0, 1.0)]
        if t >= ts[-1]:
            return [(len(ts) - 1, 1.0)]
        i1 = int(np.searchsorted(ts, t, side="right"))
        i0 = i1 - 1
        w1 = (t - ts[i0]) / (ts[i1] - ts[i0])
        return [(i0, 1.0 - w1), (i1, w1)]

    def target_at(self, t):
        """The time-interpolated target state at model time t (in the units
        of the file's time axis), host numpy."""
        br = self._bracket(t)
        if len(br) == 1:
            return self._level_state(br[0][0])
        (i0, w0), (i1, w1) = br
        s0 = self._level_state(i0)
        s1 = self._level_state(i1)
        return {k: w0 * s0[k] + w1 * s1[k] for k in s0}

    def _device_level(self, itime, device):
        """A time level's fields as float64 tensors on `device`, moved there
        once per level."""
        key = (itime, device)
        if key not in self._on_device:
            st = self._level_state(itime)
            self._on_device[key] = {
                k: torch.as_tensor(v, dtype=torch.float64, device=device)
                for k, v in st.items()}
        return self._on_device[key]

    def _target_on(self, t, device):
        br = self._bracket(t)
        levels = [(self._device_level(i, device), w) for i, w in br]
        if len(levels) == 1:
            return levels[0][0]
        (s0, w0), (s1, w1) = levels
        return {k: w0 * s0[k] + w1 * s1[k] for k in s0}

    def tendencies(self, t, state_t, state_q, state_u=None, state_v=None,
                   dt=None):
        """The nudging tendencies toward the file's target (the relax step
        of fv_climate_nudge.F90:470-540): factor(k) * (obs - model) / tau.
        The state tensors [T, K, n, n] (A-grid winds). Returns a dict with
        each *_dt whose tau > 0, on the state's device (float64 targets, so
        a float32 state gives float64 tendencies, as in the JAX package)."""
        cfg = self.cfg
        dev = torch.as_tensor(state_t).device
        tgt = self._target_on(t, dev)
        npz = state_t.shape[1]
        fac = torch.as_tensor(
            get_factor(npz, skip_top_v=cfg.skip_top_v,
                       skip_bot_v=cfg.skip_bot_v,
                       skip_top_t=cfg.skip_top_t, skip_bot_t=cfg.skip_bot_t,
                       skip_top_q=cfg.skip_top_q,
                       skip_bot_q=cfg.skip_bot_q), device=dev)
        out = {}
        shp = (1, npz, 1, 1)

        def relax(col, name, x, tau):
            return (fac[:, col].reshape(shp)
                    * (tgt[name] - torch.as_tensor(x, device=dev)) / tau)

        if cfg.t_tau > 0.0:
            out["t_dt"] = relax(1, "t", state_t, cfg.t_tau)
        if cfg.q_tau > 0.0:
            out["q_dt"] = relax(2, "q", state_q, cfg.q_tau)
        if cfg.u_tau > 0.0 and state_u is not None and "u" in tgt:
            out["u_dt"] = relax(0, "u", state_u, cfg.u_tau)
        if cfg.v_tau > 0.0 and state_v is not None and "v" in tgt:
            out["v_dt"] = relax(0, "v", state_v, cfg.v_tau)
        return out
