"""Analysis nudging, the analysis increment and IAU, climate nudging, TC
vortex breeding and surface-pressure nudging, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/physics/nudging.py (FV3
tools/fv_nudge.F90 fv_nwp_nudge:66, the Newtonian relaxation of the winds,
T and ps toward gridded analyses with per-field time scales and a
pressure-dependent weight, breed_slp_inline, ps_nudging:833 and the bias
corrections; tools/fv_treat_da_inc.F90 read_da_inc:82 and
tools/fv_iau_mod.F90 IAU_initialize:121; GFDL_tools/fv_climate_nudge.F90
and fv_ada_nudge.F90). Tensors on the device of the state they are given;
nothing is read back to the host in a step.
"""

import bisect
import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import constants as con
from ..model.grid_ops import device_of
from ..ops import fv_mapz


@dataclass(frozen=True)
class NudgeConfig:
    """fv_nwp_nudge_nml subset (fv_nudge.F90:229)."""
    tau_winds: float = 21600.0     # relaxation time scales (s)
    tau_t: float = 86400.0
    tau_q: float = 86400.0
    tau_ps: float = 21600.0
    p_wvp: float = 100.0e2         # no nudging above this pressure
    p_full: float = 300.0e2        # full strength below this one


def _vertical_weight(pm, cfg: NudgeConfig):
    """The ramp 0 -> 1 between p_wvp and p_full (fv_nudge's kbot/strat
    masks)."""
    return torch.clamp((pm - cfg.p_wvp) / (cfg.p_full - cfg.p_wvp), 0.0, 1.0)


def _wall_weight(w, axis):
    """A cell weight [6, K, n, n] spread onto the walls along `axis` (2:
    the y-walls of u, 3: the x-walls of v), the end walls taking the end
    cells'."""
    n = w.shape[axis]
    return torch.cat([w.narrow(axis, 0, 1),
                      0.5 * (w.narrow(axis, 0, n - 1) + w.narrow(axis, 1,
                                                                 n - 1)),
                      w.narrow(axis, n - 1, 1)], axis)


def nwp_nudge(dt, state, target, pm, cfg: NudgeConfig = NudgeConfig()):
    """Implicit Newtonian relaxation toward the analysis.

    state/target: dicts with any of u, v, pt, sphum (same shapes); pm:
    layer pressures [6,K,n,n] for the vertical weight. Returns the updated
    state dict."""
    out = dict(state)
    w = _vertical_weight(pm, cfg)
    for name, tau in (("u", cfg.tau_winds), ("v", cfg.tau_winds),
                      ("pt", cfg.tau_t), ("sphum", cfg.tau_q)):
        if name in state and name in target:
            r = dt / tau
            wf = (_wall_weight(w, 2) if name == "u" else
                  _wall_weight(w, 3) if name == "v" else w)
            out[name] = (state[name] + r * wf * target[name]) / (1.0 + r * wf)
    return out


def apply_da_increment(state, increments, frac=1.0):
    """One-shot analysis increment (read_da_inc): state += frac * inc."""
    out = dict(state)
    for k, inc in increments.items():
        if k in out and out[k] is not None:
            out[k] = out[k] + frac * inc
    return out


class IAU:
    """Incremental analysis update (fv_iau_mod.F90): spread an increment
    evenly over `window` seconds of `dt`-steps."""

    def __init__(self, increments, window, dt):
        self.increments = increments
        self.nsteps = max(1, int(round(window / dt)))
        self.frac = 1.0 / self.nsteps
        self.applied = 0

    def step(self, state):
        if self.applied >= self.nsteps:
            return state
        self.applied += 1
        return apply_da_increment(state, self.increments, self.frac)


# ---------------------------------------------------------------------------
# Climate nudging (GFDL_tools/fv_climate_nudge.F90) and analysis-data
# nudging (GFDL_tools/fv_ada_nudge.F90).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ClimateNudgeConfig:
    """fv_climate_nudge_nml subset (fv_climate_nudge.F90:97). A tau < 0
    turns the nudging of that field off (the do_* flags,
    fv_climate_nudge.F90:146)."""
    u_tau: float = -1.0
    v_tau: float = -1.0
    t_tau: float = -1.0
    q_tau: float = -1.0
    ps_tau: float = -1.0
    skip_top_q: int = 2            # no q nudging in the top layers
    skip_bot_q: int = 0
    use_pdep_nudge: bool = False   # strength ~ pfull/p_relax aloft
    p_relax: float = 30.0e2        # fv_nudge.F90 P_relax default
    p_norelax: float = 0.0


def _pdep_profile(pm, cfg: ClimateNudgeConfig):
    """The pressure-dependent nudging profile (fv_nudge.F90:351-359): full
    strength below p_relax, ~ p/p_relax above, floored at 0.01, and zero
    above p_norelax."""
    prof = torch.where(pm < cfg.p_relax,
                       torch.clamp_min(pm / cfg.p_relax, 0.01), 1.0)
    return torch.where(pm < cfg.p_norelax, 0.0, prof)


def time_interp_climatology(clim, frac):
    """Linear interpolation between two bracketing climatology snapshots:
    clim: dict name -> (field_t0, field_t1); frac in [0, 1]. Returns dict
    name -> field."""
    return {k: (1.0 - frac) * v0 + frac * v1 for k, (v0, v1) in clim.items()}


def climate_nudge(dt, state, clim, pm, cfg: ClimateNudgeConfig,
                  ak=None, bk=None, ptop=None):
    """Newtonian relaxation toward a climatology (fv_climate_nudge.F90:264).

    state: dict with u, v, pt (temperature), sphum, delp; clim: the targets
    on the model grid and levels; pm: layer pressures [6,K,n,n]. The ps
    nudging moves delp by the hybrid-coordinate increment d(delp) =
    d(bk)*d(ps). Returns (state, tendencies)."""
    out = dict(state)
    tend = {}
    prof = (_pdep_profile(pm, cfg) if cfg.use_pdep_nudge
            else torch.ones_like(pm))
    K = pm.shape[1]

    def relax(x, tgt, tau, w):
        r = (dt / tau) * w
        xn = (x + r * tgt) / (1.0 + r)
        return xn, (xn - x) / dt

    for name, tau in (("u", cfg.u_tau), ("v", cfg.v_tau), ("pt", cfg.t_tau),
                      ("sphum", cfg.q_tau)):
        if tau <= 0.0 or name not in state or name not in clim:
            continue
        w = prof
        if name == "u":
            w = _wall_weight(w, 2)
        elif name == "v":
            w = _wall_weight(w, 3)
        elif name == "sphum" and (cfg.skip_top_q or cfg.skip_bot_q):
            kmask = torch.ones(K, dtype=pm.dtype, device=pm.device)
            if cfg.skip_top_q:
                kmask[:cfg.skip_top_q] = 0.0
            if cfg.skip_bot_q:
                kmask[K - cfg.skip_bot_q:] = 0.0
            w = w * kmask[None, :, None, None]
        out[name], tend[name] = relax(state[name], clim[name], tau, w)

    if cfg.ps_tau > 0.0 and "ps" in clim and ak is not None:
        delp = state["delp"]
        ps = torch.as_tensor(ak, device=delp.device)[0] + torch.sum(delp,
                                                                    dim=1)
        r = dt / cfg.ps_tau
        ps_new = (ps + r * clim["ps"]) / (1.0 + r)
        dbk = torch.as_tensor(bk, dtype=delp.dtype, device=delp.device)
        dbk = (dbk[1:] - dbk[:-1])[None, :, None, None]
        out["delp"] = delp + dbk * (ps_new - ps)[:, None]
        tend["ps"] = (ps_new - ps) / dt
    return out, tend


def ada_nudge(dt, state, analysis, pm, cfg: ClimateNudgeConfig):
    """Analysis-data nudging (fv_ada_nudge.F90:85): climate_nudge's
    relaxation toward 6-hourly analyses (fv_ada_nudge_nml mirrors the
    taus)."""
    return climate_nudge(dt, state, analysis, pm, cfg)


# ---------------------------------------------------------------------------
# Inline TC vortex breeding (tools/fv_nudge.F90 breed_slp_inline:~2000).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BreedConfig:
    """fv_nwp_nudge_nml vortex-breeding subset (fv_nudge.F90:184-200)."""
    tau_vt_slp: float = 1200.0
    tau_vt_rad: float = 4.0
    r_lo: float = 2.0
    r_hi: float = 5.0
    del_r: float = 250.0e3
    r_min: float = 200.0e3
    r_inc: float = 25.0e3
    slp_env: float = 101010.0
    tm_max: float = 315.0          # no deepening when the surface layer is hot
    dps_min: float = 500.0         # the largest deepening a step (Pa)
    k_breed_p: float = 100.0e2     # layers above this pressure untouched
    phis_max: float = 250.0 * 9.80665  # no breeding over high terrain


def _cell_geometry(g, dtype, device):
    """area, aglon, aglat [6, n, n] from the grid's geometry in `dtype` on
    `device`, built once per grid, dtype and device."""
    cache = g.__dict__.setdefault("_nudging_cells", {})
    key = (dtype, device)
    if key not in cache:
        cache[key] = tuple(
            torch.as_tensor(np.array(g.geom.interior(nm)), dtype=dtype,
                            device=device)
            for nm in ("area", "aglon", "aglat"))
    return cache[key]


def breed_slp_inline(dt, delp, pt_bot, phis, storms, g, ak, cfg=BreedConfig()):
    """Inline sea-level-pressure vortex breeding (fv_nudge.F90
    breed_slp_inline). For each observed storm (lon, lat, slp_obs in
    rad/rad/Pa), relax the local surface pressure toward a Gaussian target
    profile p(r) = p_env - (p_env - slp_obs)*exp(-c (r/r_vor)^2) by scaling
    the layer thicknesses below k_breed_p; the removed mass is restored
    globally, so the total air mass is conserved.

    delp [6,K,n,n]; pt_bot [6,n,n] lowest-layer temperature; phis [6,n,n];
    storms: [S, 3] of (lon, lat, slp_obs). Returns the new delp. The storms
    are summed in their order, as the JAX package's scan does; an invalid
    storm (slp_obs >= slp_env, or outside 45 degrees) adds nothing, with no
    host read."""
    storms = torch.as_tensor(storms, dtype=delp.dtype, device=delp.device)
    akv = torch.as_tensor(ak, dtype=delp.dtype, device=delp.device)
    area, lon, lat = _cell_geometry(g, delp.dtype, delp.device)
    ps = akv[0] + torch.sum(delp, dim=1)
    # the layers above k_breed_p stay untouched (a k0 mask per level)
    pedge_ref = akv[0] + torch.cumsum(torch.mean(delp, dim=(0, 2, 3)), 0)
    kmask = (pedge_ref > cfg.k_breed_p).to(delp.dtype)           # [K]
    # the standard SLP reduction from the lowest-layer temperature
    tstar = pt_bot * (1.0 + 3.25e-3 * phis / (con.GRAV * 2.0))
    slp = ps * torch.exp(phis / (con.RDGAS * tstar))

    dps_tot = torch.zeros_like(ps)
    for s in range(storms.shape[0]):
        slon, slat, slp_o = storms[s, 0], storms[s, 1], storms[s, 2]
        valid = ((slp_o < cfg.slp_env) & (slp_o > 87500.0)
                 & (torch.abs(slat) < math.radians(45.0)))
        # the great-circle distance to the storm centre
        cosd = (torch.sin(slat) * torch.sin(lat)
                + torch.cos(slat) * torch.cos(lat) * torch.cos(lon - slon))
        dist = g.geom.radius * torch.arccos(torch.clamp(cosd, -1.0, 1.0))
        r_vor = cfg.r_min + (cfg.slp_env - slp_o) / 25.0e2 * cfg.r_inc
        # the environmental SLP: area-weighted ring mean [r_vor, r_vor+del_r]
        ring = ((dist > r_vor) & (dist < r_vor + cfg.del_r)
                & (phis < cfg.phis_max)).to(delp.dtype)
        p_env = (torch.sum(ring * slp * area)
                 / torch.clamp_min(torch.sum(ring * area), 1e-30))
        f1 = dist / r_vor
        p_hi = p_env - (p_env - slp_o) * torch.exp(-cfg.r_hi * f1 ** 2)
        p_lo = p_env - (p_env - slp_o) * torch.exp(-cfg.r_lo * f1 ** 2)
        tau_vt = torch.clamp_min(cfg.tau_vt_slp
                                 * (1.0 + (960.0e2 - slp_o) / 100.0e2),
                                 abs(dt))
        relx0 = torch.clamp_max(abs(dt) / tau_vt, 1.0)
        inside = (dist < r_vor) & (phis < cfg.phis_max)
        # under-development: deepen toward p_hi, capped; temperature guard
        deepen = (relx0 * torch.exp(-cfg.tau_vt_rad * f1 ** 2) * (ps - p_hi)
                  * torch.clamp((cfg.tm_max - pt_bot) / 10.0, 0.0, 1.0))
        deepen = torch.clamp_max(deepen, cfg.dps_min)
        # over-development: fill toward p_lo
        fill = torch.clamp_min(relx0, 0.5) * (slp - p_lo)
        dps = torch.where(ps > p_hi, torch.clamp_min(deepen, 0.0),
                          torch.where(slp < p_lo, torch.clamp_max(fill, 0.0),
                                      0.0))
        dps_tot = dps_tot + torch.where(inside & valid, dps, 0.0)
    # scale the breeding layers' thicknesses: f = 1 - dps/(ps - pbreed)
    pbreed = akv[0] + torch.cumsum(delp * (1.0 - kmask)[None, :, None, None],
                                   dim=1)[:, -1]
    fac = 1.0 - dps_tot / torch.clamp_min(ps - pbreed, 1.0)
    delp_new = delp * (kmask[None, :, None, None] * (fac[:, None] - 1.0)
                       + 1.0)
    # conserve the global air mass: restore the sunk mass uniformly
    mass_sink = torch.sum(dps_tot * area)
    total = torch.sum(torch.sum(delp_new, dim=1) * area)
    return delp_new * (1.0 + mass_sink / total)


# ---------------------------------------------------------------------------
# Surface-pressure nudging with the sigma-distributed mass adjustment and the
# global bias corrections (fv_nudge.F90 ps_nudging:833,
# ps_bias_correction:993, temp_bias_correction:1060)
# ---------------------------------------------------------------------------

def _same_signed_debias(x, bias, area_x, area_sum, dims):
    """Remove `bias` from the cells of x signed as bias, rescaled by their
    area fraction and clipped at zero (the same-signed-cell form)."""
    same = torch.where(bias > 0.0, x > 0.0, x < 0.0)
    psum = torch.sum(torch.where(same, area_x, 0.0), dim=dims, keepdim=True)
    adj = bias * area_sum / torch.clamp_min(psum, 1e-30)
    return torch.where(same,
                       torch.where(bias > 0.0, torch.clamp_min(x - adj, 0.0),
                                   torch.clamp_max(x - adj, 0.0)),
                       x)


def ps_bias_correction(ps_dt, area, esl=0.01):
    """Remove the global-mean bias of a ps increment without reversing any
    local sign (ps_bias_correction:993): the area-weighted mean bias is
    taken from the same-signed cells only, rescaled by their area fraction,
    and clipped at zero. On the device, with no host read."""
    w = area / torch.sum(area)
    bias = torch.sum(w * ps_dt)
    debiased = _same_signed_debias(ps_dt, bias, area, torch.sum(area),
                                   dims=None)
    return torch.where(torch.abs(bias) < esl, ps_dt, debiased)


def temp_bias_correction(t_dt, area):
    """Per-level removal of the area-mean temperature-increment bias
    (temp_bias_correction:1060, the same-signed-cell form)."""
    w = (area / torch.sum(area))[:, None]
    bias = torch.sum(w * t_dt, dim=(0, 2, 3), keepdim=True)
    return _same_signed_debias(t_dt, bias, area[:, None], torch.sum(area),
                               dims=(0, 2, 3))


def ps_nudging(dt, ak, bk, ps_target, delp, area=None, mask=1.0,
               phis=None, gz0=None, tau=21600.0, cap=10.0e2,
               terrain_decay=500.0, do_bias=True):
    """Nudge the surface pressure toward the (terrain-adjusted) analysis by
    adding mass in the sigma part of the coordinate (ps_nudging:833):
    delp_k += (bk_{k+1}-bk_k) * dps. ps_target should already sit on the
    model terrain (io.external_ic.adjust_ps_to_terrain); where the
    analysis's surface geopotential gz0 is given, the increment decays
    with the terrain mismatch |gz0-phis| over `terrain_decay` metres.
    Returns (delp_new, the applied dps)."""
    ps = float(ak[0]) + torch.sum(delp, dim=1)
    ps_dt = ps_target - ps
    ps_dt = torch.sign(ps_dt) * torch.clamp_max(torch.abs(ps_dt), cap)
    ps_dt = ps_dt * mask
    if phis is not None and gz0 is not None:
        fac = torch.clamp_min(1.0 - torch.abs(gz0 - phis)
                              / (con.GRAV * terrain_decay), 0.0)
        ps_dt = ps_dt * fac
    if do_bias and area is not None:
        ps_dt = ps_bias_correction(ps_dt, area)
    frac = min(1.0, dt / tau)
    dps = frac * ps_dt
    dbk = torch.as_tensor(np.diff(np.asarray(bk)), dtype=delp.dtype,
                          device=delp.device).reshape(1, -1, 1, 1)
    return delp + dbk * dps[:, None], dps


class ObsSchedule:
    """The two-time-level analysis stream (get_obs:1179): consecutive
    analyses with their valid times, served as the linear time
    interpolation the nudging consumes."""

    def __init__(self, times, analyses):
        if not len(times) == len(analyses) >= 2:
            raise ValueError("ObsSchedule needs two analyses or more, one "
                             "per time")
        self.times = list(times)
        self.analyses = list(analyses)

    def target_at(self, t):
        i = bisect.bisect_right(self.times, t) - 1
        i = max(0, min(i, len(self.times) - 2))
        t0, t1 = self.times[i], self.times[i + 1]
        a = (t - t0) / max(t1 - t0, 1e-12)
        a = min(max(a, 0.0), 1.0)
        return {k: ((1.0 - a) * torch.as_tensor(self.analyses[i][k])
                    + a * torch.as_tensor(self.analyses[i + 1][k]))
                for k in self.analyses[i]}


def remap_analysis_to_model(ana, ak_src, bk_src, ps, ak, bk,
                            fields=("t", "sphum"), winds=("ua", "va"),
                            kord=8, device=None):
    """Vertical remap of an analysis on its own hybrid levels onto the
    model's (remap_tq:2026 / remap_uv:2106): the scalars mass-weighted
    (T with iv = 1), the A-grid analysis winds with iv = -1. ana fields
    [6, Ks, n, n]; ps [6, n, n]. On `device`, else that of ps or of the
    analysis's tensors, else the card."""
    dev = device_of(ps, *ana.values(), device=device)
    ps_ = torch.as_tensor(ps, device=dev)
    shape = (1,) * ps_.ndim + (-1,)

    def edges(a, b):
        return (torch.as_tensor(a, device=dev).reshape(shape)
                + torch.as_tensor(b, device=dev).reshape(shape)
                * ps_[..., None])

    pe1, pe2 = edges(ak_src, bk_src), edges(ak, bk)

    def remap(name, iv):
        f = torch.movedim(torch.as_tensor(ana[name], device=dev), 1, -1)
        return torch.movedim(
            fv_mapz.map1_ppm_ext(f, pe1, pe2, iv=iv, kord=kord), -1, 1)

    out = {}
    for name in fields:
        if name in ana:
            out[name] = remap(name, 1 if name == "t" else 0)
    for name in winds:
        if name in ana:
            out[name] = remap(name, -1)
    return out
