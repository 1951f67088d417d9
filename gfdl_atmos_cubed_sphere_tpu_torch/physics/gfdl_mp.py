"""GFDL cloud microphysics, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/physics/gfdl_mp.py: the
six-category (vapour, cloud water, rain, cloud ice, snow, graupel) GFDL
scheme of FV3 model/gfdl_mp.F90 on the path of gfdl_mp_driver:607 ->
mp_full:1892 (sedimentation -> warm rain -> ice cloud -> saturation
adjustment, or subgrid_z_proc under use_subgrid_proc), and the inline
fast physics fast_sat_adj (the mp_fast process chain, or the condensed
sat_adjust), written as batched elementwise and column ops over
[6, K, y, x]. No TPU kernel runs here.

Scalars the JAX package folds in Python doubles before they meet an array
(1 - exp(-dts / tau), aone, fac_rc, the coefficient pack of mp_coeffs) are
folded the same way here. The JAX package's lax.scans down the column
(implicit_fall, sedi_w, sedi_uv) are Python loops over K in the same
direction with the same carried state; its lax.while_loop in
explicit_fall is a Python loop to the largest per-column substep count,
read from the device once per call.
"""

import math
from dataclasses import dataclass

import torch

from .. import constants as con

# ---- gfdl_mp.F90 module constants (:130-200) ------------------------------
RGRAV = 1.0 / con.GRAV
C_ICE = 2.106e3        # IFS values used by gfdl_mp (NOT constants_mod's)
C_LIQ = 4.218e3
CP_VAP = 4.0 * con.RVGAS
CV_AIR = con.CP_AIR - con.RDGAS
CV_VAP = 3.0 * con.RVGAS
DC_VAP = CP_VAP - C_LIQ
DC_ICE = C_LIQ - C_ICE
D2_ICE = CP_VAP - C_ICE
TICE = 273.16
HLV = 2.5e6
HLF = 3.3358e5
LV0 = HLV - DC_VAP * TICE
LI0 = HLF - DC_ICE * TICE
LI2 = LV0 + LI0
E00 = 611.21
EPS = con.RDGAS / con.RVGAS
RHO0 = 1.2             # reference air density for denfac
QCMIN = 1.0e-12        # min condensate
QFMIN = 1.0e-8         # min falling condensate

RHOW, RHOI, RHOR, RHOS, RHOG = 1.0e3, 9.17e2, 1.0e3, 1.0e2, 4.0e2

NAMES = ("sphum", "liq_wat", "rainwat", "ice_wat", "snowwat", "graupel")


@dataclass(frozen=True)
class MPConfig:
    """gfdl_mp_nml (defaults from gfdl_mp.F90:320-460): the JAX
    package's MPConfig, field for field, with the same defaults and
    order, so any of its namelists parses. tau_g2r, tau_gmlt, rh_inc and
    rh_inr have no reader in the JAX package either and are only
    stored."""
    ntimes: int = 1
    tau_v2l: float = 150.0     # condensation timescale (s)
    tau_l2v: float = 300.0     # evaporation
    tau_i2s: float = 1000.0    # ice -> snow autoconversion
    tau_g2r: float = 600.0
    tau_smlt: float = 900.0    # snow melt
    tau_gmlt: float = 600.0
    tau_revp: float = 150.0    # rain evaporation
    ql0_max: float = 2.0e-3    # max cloud water before autoconversion
    qi0_crt: float = 1.0e-4    # ice -> snow threshold (kg/m^3)
    qs0_crt: float = 1.0e-3    # snow -> graupel threshold (kg/m^3)
    c_paut: float = 0.5        # autoconversion efficiency
    c_pracw: float = 0.8       # rain accretion efficiency
    c_psaci: float = 0.05      # snow-ice accretion efficiency
    c_pgacw: float = 1.0
    c_psacw: float = 1.0       # snow-cloud water accretion (gfdl_mp.F90)
    c_pgaci: float = 0.05      # graupel-ice accretion efficiency
    c_pgacr: float = 1.0       # graupel-rain accretion (freezing)
    c_praci: float = 1.0       # cloud ice to rain accretion efficiency
    c_pracs: float = 1.0       # snow to rain accretion efficiency
    c_psacr: float = 1.0       # rain to snow accretion efficiency
    c_pgacs: float = 0.01      # snow to graupel accretion efficiency
    fi2s_fac: float = 1.0      # max sink fraction: cloud ice -> snow
    fs2g_fac: float = 1.0      # max sink fraction: snow -> graupel
    qs_mlt: float = 1.0e-6     # max cloud water from melted snow (kg/kg)
    rh_inc: float = 0.25
    rh_inr: float = 0.25       # rain evap rh threshold increment
    t_min: float = 178.0
    t_sub: float = 184.0
    vr_fac: float = 1.0
    vi_fac: float = 1.0
    vs_fac: float = 1.0
    vg_fac: float = 1.0
    vr_max: float = 12.0
    vi_max: float = 1.0
    vs_max: float = 2.0
    vg_max: float = 12.0
    do_sedi_heat: bool = True
    do_warm_rain_mp: bool = False
    # sedimentation variants + momentum transport (gfdl_mp.F90:276-305)
    sedflag: int = 1           # 1: implicit_fall (:5250); 2: explicit_fall
                               # (:5311, sub-stepped upstream)
    do_sedi_w: bool = True     # transport w by falling condensate (:5653)
    do_sedi_uv: bool = False   # transport horizontal momentum (:5622)
    # CCN / aerosol coupling (prog_ccn = Yi Ming's method, mpdrv:1377;
    # fixed land/ocean blend otherwise, :1388)
    prog_ccn: bool = False
    ccn_l: float = 270.0       # CCN over land (1/cm^3)
    ccn_o: float = 90.0        # CCN over ocean (1/cm^3)
    rthresh: float = 10.0e-6   # critical drop radius for autoconversion (m)
    use_ccn_praut: bool = True  # reference praut:3086 (ccn-aware) vs the
                                # simple ql0_max threshold scheme
    consv_checker: bool = False  # mpdrv:1365 mtetw energy/water audits
    # PSD parameters (gfdl_mp_nml:339-377 defaults)
    n0w_sig: float = 1.1
    n0i_sig: float = 1.3
    n0r_sig: float = 8.0
    n0s_sig: float = 3.0
    n0g_sig: float = 4.0
    n0w_exp: float = 41.0
    n0i_exp: float = 18.0
    n0r_exp: float = 6.0
    n0s_exp: float = 6.0
    n0g_exp: float = 6.0
    muw: float = 6.0
    mui: float = 3.35
    mur: float = 1.0
    mus: float = 1.0
    mug: float = 1.0
    alinw: float = 3.0e7
    alini: float = 7.0e2
    alinr: float = 842.0
    alins: float = 4.8
    aling: float = 1.0
    blinw: float = 2.0
    blini: float = 1.0
    blinr: float = 0.8
    blins: float = 0.25
    bling: float = 0.5
    rhow: float = 1.0e3
    rhoi: float = 9.17e2
    rhor: float = 1.0e3
    rhos: float = 1.0e2
    rhog: float = 4.0e2
    # ---- fast-physics (mp_fast) process options, gfdl_mp.F90 namelist
    # defaults at the cited lines --------------------------------------
    use_mp_fast: bool = True   # fast_sat_adj dispatches to the mp_fast
                               # process chain (:1995) vs the condensed
                               # sat_adjust
    use_subgrid_proc: bool = False  # mp_full's saturation stage runs the
                               # per-process subgrid_z_proc (:3989)
                               # instead of the condensed sat_adjust
    rh_adj: float = 0.0        # pinst instant-evap RH threshold
    fast_fr_mlt: bool = True   # freezing/melting in fast MP (:332)
    fast_dep_sub: bool = True  # deposition/sublimation in fast MP (:333)
    delay_cond_evap: bool = False  # cond/evap only on last step (:328)
    nconds: int = 1            # condensation subcycles (:191)
    do_evap_timescale: bool = True   # (:306)
    do_cond_timescale: bool = False  # (:307)
    rh_fac_evap: float = 10.0  # (:436)
    rh_fac_cond: float = 10.0  # (:437)
    use_rhc_cevap: bool = False  # (:289)
    rhc_cevap: float = 0.85    # (:461)
    do_wbf: bool = False       # Wegener-Bergeron-Findeisen (:315)
    tau_imlt: float = 1200.0   # cloud ice melting timescale (:394)
    tau_wbf: float = 300.0     # WBF timescale (:397)
    tau_r2g: float = 900.0     # rain freezing to graupel (:388)
    tau_l2r: float = 900.0     # cloud water -> rain autoconv (:390)
    ql_mlt: float = 2.0e-3     # max cloud water from melted ice (:411)
    qi0_max: float = 1.0e-4    # max cloud ice before autoconv (:415)
    qi_lim: float = 1.0        # ice generation limiter (:409)
    is_fac: float = 0.2        # ice sublimation temperature factor (:432)
    ss_fac: float = 0.2        # snow sublimation factor (:433)
    gs_fac: float = 0.2        # graupel sublimation factor (:434)
    inflag: int = 1            # ice nucleation scheme (:209)
    igflag: int = 3            # ice generation scheme (:216)
    tice_mlt: float = 273.16   # ice melting temperature (:380)

    @property
    def t_wfr(self):
        return self.t_min if self.do_warm_rain_mp else TICE - 40.0

    @property
    def coeffs(self):
        """Lin-scheme PSD coefficient pack (physics/mp_coeffs.py), cached
        per config."""
        c = _COEFF_CACHE.get(self)
        if c is None:
            from .mp_coeffs import build_coeffs
            c = build_coeffs(self)
            _COEFF_CACHE[self] = c
        return c


_COEFF_CACHE = {}


def _tv_coeffs(alin, blin, mu, n0_sig, n0_exp, rho_x, extra=1.0):
    """setup_mp:823-844 terminal-velocity PSD coefficients (host scalars).
    vt = (tva/tvb) * (6*den*q) ** (blin/(mu+3))."""
    g = math.gamma
    tva = (math.exp(-blin / (mu + 3) * math.log(n0_sig)) * alin
           * g(mu + blin + 3)
           * math.exp(-blin * n0_exp / (mu + 3) * math.log(10.0))) * extra
    tvb = (math.exp(blin / (mu + 3) * math.log(math.pi * rho_x * g(mu + 3)))
           * g(mu + 3))
    return tva / tvb, blin / (mu + 3)


# defaults (gfdl_mp.F90:339-377); graupel gets the gcon drag factor
_GCON = math.sqrt(4.0 * con.GRAV * RHOG / (3.0 * 0.5 * RHO0))
_TV = {
    "qr": _tv_coeffs(842.0, 0.8, 1.0, 8.0, 6.0, RHOR),
    "qi": _tv_coeffs(7.0e2, 1.0, 3.35, 1.3, 18.0, RHOI),
    "qs": _tv_coeffs(4.8, 0.25, 1.0, 3.0, 6.0, RHOS),
    "qg": _tv_coeffs(1.0, 0.5, 1.0, 4.0, 6.0, RHOG, extra=_GCON),
}

def _zero(a):
    return torch.zeros((), dtype=a.dtype, device=a.device)


def es_water(t):
    """Saturation vapor pressure over water (qs_table_core:7160-7172)."""
    fac = ((t - TICE) / (t * TICE) * LV0
           + DC_VAP * torch.log(t / TICE)) / con.RVGAS
    return E00 * torch.exp(fac)


def es_ice(t):
    """Over ice (qs_table_core:7131-7138), blended to water above -10C."""
    fac = ((t - TICE) / (t * TICE) * LI2
           + D2_ICE * torch.log(t / TICE)) / con.RVGAS
    ei = E00 * torch.exp(fac)
    w = torch.clamp((TICE - t) / 10.0, 0.0, 1.0)
    return w * ei + (1.0 - w) * es_water(t)


def wqs(t, p):
    """Saturation mixing ratio over water at pressure p + d(qs)/dT."""
    es = es_water(t)
    qs = EPS * es / torch.clamp_min(p - (1.0 - EPS) * es, 1.0e-8)
    dqdt = qs * (DC_VAP + LV0 / t) / (con.RVGAS * t)
    return qs, dqdt


def iqs(t, p):
    """Saturation mixing ratio over ice (blended) + derivative."""
    es = es_ice(t)
    qs = EPS * es / torch.clamp_min(p - (1.0 - EPS) * es, 1.0e-8)
    dqdt = qs * (D2_ICE + LI2 / t) / (con.RVGAS * t)
    return qs, dqdt


def wqs_den(t, den):
    """Saturation mixing ratio over water from density (gfdl_mp.F90 wqs:
    qsat = es / (rvgas * t * den)) + d(qs)/dT."""
    es = es_water(t)
    qs = es / (con.RVGAS * t * torch.clamp_min(den, 1e-10))
    dqdt = qs * (DC_VAP + LV0 / t) / (con.RVGAS * t)
    return qs, dqdt


def iqs_den(t, den):
    """Saturation over ice from density (gfdl_mp.F90 iqs)."""
    es = es_ice(t)
    qs = es / (con.RVGAS * t * torch.clamp_min(den, 1e-10))
    dqdt = qs * (D2_ICE + LI2 / t) / (con.RVGAS * t)
    return qs, dqdt


# ---------------------------------------------------------------------------
# Lin et al. (1983) accretion / ventilation kernels (gfdl_mp.F90:5490-5616)
# ---------------------------------------------------------------------------

def _log6(qden):
    return torch.log(torch.clamp_min(6.0 * qden, 1e-20))


def acr2d(qden, c, denfac, blin, mu):
    """Accretion of a suspended species by a falling species (acr2d:5490)."""
    return denfac * c * torch.exp((2 + mu + blin) / (mu + 3) * _log6(qden))


def acr3d(v1, v2, q1, q2, c, acco_k, acc1, acc2, den):
    """Accretion between two falling species (acr3d:5510, vdiffflag=1).
    q1 is collected by q2; acco_k = acco[:, k] (3 moments)."""
    lt1 = _log6(q1 * den) / (acc1 + 3)
    lt2 = _log6(q2 * den) / (acc2 + 3)
    vdiff = torch.abs(v1 - v2)
    tmp = 0.0
    for i in (1, 2, 3):
        tmp = tmp + acco_k[i - 1] * torch.exp((6 + acc1 - i) * lt1
                                              + (acc2 + i - 1) * lt2)
    return c * vdiff / den * tmp


def vent_coeff(qden, c1, c2, denfac, blin, mu):
    """Ventilation coefficient (vent_coeff:5552)."""
    lq = _log6(qden)
    return c1 + c2 * torch.exp((3 + 2 * mu + blin) / (mu + 3) / 2 * lq) \
        * torch.sqrt(denfac) / torch.exp((1 + mu) / (mu + 3) * lq)


def pmlt(tc, dq, qden, pxacw, pxacr, c4, den, denfac, blin, mu,
         lcpk, icpk, cvm):
    """Melt rate of snow/graupel incl. accreted-water enhancement
    (pmlt:5597)."""
    lq = _log6(qden)
    return ((c4[0] / (icpk * cvm) * tc / den - c4[1] * lcpk / icpk * dq)
            * torch.exp((1 + mu) / (mu + 3) * lq)
            * vent_coeff(qden, c4[2], c4[3], denfac, blin, mu)
            + C_LIQ / (icpk * cvm) * tc * (pxacw + pxacr))


def psub(t2, dq, qden, qsat, c5, den, denfac, blin, mu, cpk, cvm):
    """Sublimation/evaporation rate with ventilation (psub:5569)."""
    lq = _log6(qden)
    return (c5[0] * t2 * dq * torch.exp((1 + mu) / (mu + 3) * lq)
            * vent_coeff(qden, c5[1], c5[2], denfac, blin, mu)
            / (c5[3] * t2 + c5[4] * (cpk * cvm) ** 2 * qsat * den))


def _acco_k(co, k):
    """acco(:, k) column (1-based k, matching the reference pair table)."""
    return [co.acco[0][k - 1], co.acco[1][k - 1], co.acco[2][k - 1]]


def _mhc(qv, ql, qr, qi, qs, qg):
    """Moist heat capacity (gfdl_mp.F90 mhc)."""
    q_liq = ql + qr
    q_sol = qi + qs + qg
    return ((1.0 - (qv + q_liq + q_sol)) * CV_AIR + qv * CV_VAP
            + q_liq * C_LIQ + q_sol * C_ICE)


def _cal_mhc_lhc(t, qv, ql, qr, qi, qs, qg, t_wfr):
    """cvm, the conserved moist energy te8 = cvm*T + lv00*qv - li00*q_sol,
    and the latent-heat factors (cal_mhc_lhc / update_qt); tcp3 blends
    lcpk and icpk across the band from TICE down to t_wfr."""
    cvm = _mhc(qv, ql, qr, qi, qs, qg)
    te8 = cvm * t + LV0 * qv - LI0 * (qi + qs + qg)
    lcpk = (LV0 + DC_VAP * t) / cvm
    icpk = (LI0 + DC_ICE * t) / cvm
    tcpk = (LI2 + (DC_VAP + DC_ICE) * t) / cvm
    tcp3 = lcpk + icpk * torch.clamp_max(
        torch.clamp_min(TICE - t, 0.0) / (TICE - t_wfr), 1.0)
    return cvm, te8, lcpk, icpk, tcpk, tcp3


def _update_qt(st, dqv, dql, dqr, dqi, dqs, dqg):
    """Apply increments and recover T from the conserved te8 (update_qt:
    6951). st is a dict with keys t, qv, ql, qr, qi, qs, qg, te8 (and
    t_wfr in the fast-physics processes); cvm/lcpk/icpk/tcpk are
    refreshed, and tcp3 where st holds t_wfr."""
    st["qv"] = st["qv"] + dqv
    st["ql"] = st["ql"] + dql
    st["qr"] = st["qr"] + dqr
    st["qi"] = st["qi"] + dqi
    st["qs"] = st["qs"] + dqs
    st["qg"] = st["qg"] + dqg
    cvm = _mhc(st["qv"], st["ql"], st["qr"], st["qi"], st["qs"], st["qg"])
    t = (st["te8"] - LV0 * st["qv"]
         + LI0 * (st["qi"] + st["qs"] + st["qg"])) / cvm
    st["t"] = t
    st["cvm"] = cvm
    st["lcpk"] = (LV0 + DC_VAP * t) / cvm
    st["icpk"] = (LI0 + DC_ICE * t) / cvm
    st["tcpk"] = (LI2 + (DC_VAP + DC_ICE) * t) / cvm
    if "t_wfr" in st:       # refresh tcp3 too (update_qt:6987)
        st["tcp3"] = st["lcpk"] + st["icpk"] * torch.clamp_max(
            torch.clamp_min(TICE - t, 0.0) / (TICE - st["t_wfr"]), 1.0)
    return st


def _heat_capacities(qv, ql, qr, qi, qs, qg, t):
    """Moist heat capacity + latent-heat factors (setup_mhc_lhc:1120)."""
    q_liq = ql + qr
    q_sol = qi + qs + qg
    cvm = ((1.0 - (qv + q_liq + q_sol)) * CV_AIR + qv * CV_VAP
           + q_liq * C_LIQ + q_sol * C_ICE)
    lcpk = (LV0 + DC_VAP * t) / cvm
    icpk = (LI0 + DC_ICE * t) / cvm
    return cvm, lcpk, icpk


def terminal_velocity(name, q, den, denfac, cfg: MPConfig):
    """Lin et al. (1983) PSD mass-weighted fall speed (term_rsg:2385)."""
    a, b = cfg.coeffs.tv[name]
    fac = {"qr": cfg.vr_fac, "qi": cfg.vi_fac, "qs": cfg.vs_fac,
           "qg": cfg.vg_fac, "qw": 1.0}[name]
    vmax = {"qr": cfg.vr_max, "qi": cfg.vi_max, "qs": cfg.vs_max,
            "qg": cfg.vg_max, "qw": 0.5}[name]
    qden = torch.clamp_min(6.0 * q * den, 1.0e-20)
    vt = fac * a * torch.exp(b * torch.log(qden)) * denfac
    return torch.where(q < QFMIN, 0.0, torch.clamp(vt, 0.0, vmax))


def implicit_fall(q, vt, dz, dp, dts):
    """Time-implicit upstream sedimentation (implicit_fall:5250).

    q [.., K, y, x] mixing ratio; vt fall speed (m/s, positive down);
    dz layer thickness (m, positive); dp (Pa). Returns (q_new,
    precip_mass [.., y, x] in dp units, m1 flux [.., K, y, x])."""
    qk = q * dp
    dd = dts * vt
    qm = [qk[:, 0] / (dz[:, 0] + dd[:, 0])]
    for k in range(1, q.shape[1]):
        # influx from above uses the upper layer's dts*vt
        qm.append((qk[:, k] + qm[-1] * dd[:, k - 1]) / (dz[:, k] + dd[:, k]))
    qm = torch.stack(qm, 1) * dz
    m1 = torch.cumsum(qk - qm, dim=1)
    return qm / dp, m1[:, -1], m1


def explicit_fall(q, vt, dz, dp, dts):
    """Sub-stepped explicit upstream sedimentation (explicit_fall:5311,
    sedflag=2). The CFL-limited substep count is per column, as the
    reference computes it: nstep(i,j) = 1 + max_k(dts*vt/dz), so the result
    is column-local (one count for the whole batch would change every
    column whose own CFL maximum is smaller). The loop runs to the largest
    count, read from the device once per call (the only host read of the
    microphysics); columns that finished earlier are masked to no-ops, so
    the extra trips do not change their values."""
    q0 = q * dp
    dd_full = dts * vt
    nstep_col = (1 + torch.amax(dd_full / dz, dim=1,
                                keepdim=True)).to(torch.int32)
    dd = dd_full / nstep_col.to(q.dtype)
    frac = dd / dz
    qm = q0
    for n in range(int(nstep_col.max())):
        active = (n < nstep_col).to(q.dtype)
        flux = qm * frac * active
        qm = qm - flux + _shift_down(flux, torch.zeros_like(flux[:, :1]))
    m1 = torch.cumsum(q0 - qm, dim=1)
    return qm / dp, m1[:, -1], m1


def sedi_uv(m1, dp, u, v):
    """Horizontal-momentum transport by falling condensate (sedi_uv:5622):
    u(k) = (dp(k) u(k) + m1(k-1) u(k-1)) / (dp(k) + m1(k-1)), sequential
    in k (it uses the already updated u(k-1))."""
    uo, vo = [u[:, 0]], [v[:, 0]]
    for k in range(1, u.shape[1]):
        dd, m_up = dp[:, k], m1[:, k - 1]
        uo.append((dd * u[:, k] + m_up * uo[-1]) / (dd + m_up))
        vo.append((dd * v[:, k] + m_up * vo[-1]) / (dd + m_up))
    return torch.stack(uo, 1), torch.stack(vo, 1)


def sedi_w(m1, w, vt, dm):
    """Vertical-momentum transport by falling condensate (sedi_w:5653):
    the falling mass m1(k-1) arrives carrying w(k-1) - vt(k-1); the top
    layer absorbs its own outgoing flux momentum."""
    out = [w[:, 0] + m1[:, 0] * vt[:, 0] / dm[:, 0]]
    for k in range(1, w.shape[1]):
        dd, m_up = dm[:, k], m1[:, k - 1]
        out.append((dd * w[:, k] + m_up * (out[-1] - vt[:, k - 1])
                    + m1[:, k] * vt[:, k]) / (dd + m_up))
    return torch.stack(out, 1)


def compute_ccn(den, cfg: MPConfig, hs=None, qnl=None):
    """Cloud-condensation-nuclei mixing number (mpdrv:1377-1393).

    prog_ccn: Boucher & Lohmann (1995) from the prognostic aerosol number
    tracer qnl (Yi Ming's method); else a land/ocean blend weighted by the
    surface geopotential |hs| (the land proxy; land = 0 without hs).
    Returns ccn in #/m^3 over den."""
    if hs is None:
        land = 0.0
    else:
        land = torch.clamp_max(torch.abs(hs) / (10.0 * con.GRAV), 1.0)
        if land.ndim == den.ndim - 1 and land.ndim == 3:
            land = land[:, None]            # [6, 1, y, x] over K
    if cfg.prog_ccn and qnl is not None:
        qn = torch.clamp_min(qnl * den * 1.0e9, 1.0e-20)
        nl = (land * 10.0 ** 2.24 * torch.exp(0.257 * torch.log(qn))
              + (1.0 - land) * 10.0 ** 2.06 * torch.exp(0.48 * torch.log(qn)))
        return torch.clamp_min(nl, 10.0) * 1.0e6 / den
    ccn0 = (cfg.ccn_l * land + cfg.ccn_o * (1.0 - land)) * 1.0e6
    return ccn0 / torch.clamp_min(den, 1.0e-10)


def mte_column(t, qv, ql, qr, qi, qs, qg, dp, u=None, v=None, w=None):
    """Column moist total energy and total water (mte:6768 / mtetw:6809),
    both per unit area: te [J/m^2], tw [kg/m^2]. KE terms included when
    the winds are given."""
    q_liq = ql + qr
    q_sol = qi + qs + qg
    cvm = ((1.0 - (qv + q_liq + q_sol)) * CV_AIR + qv * CV_VAP
           + q_liq * C_LIQ + q_sol * C_ICE)
    te = cvm * t + LV0 * qv - LI0 * q_sol
    if u is not None:
        te = te + 0.5 * (u * u + v * v)
    if w is not None:
        te = te + 0.5 * w * w
    te_col = torch.sum(RGRAV * te * dp, dim=1)
    tw_col = torch.sum(RGRAV * (qv + q_liq + q_sol) * dp, dim=1)
    return te_col, tw_col


def _shift_down(a, top):
    """a[:, k-1] at level k, `top` at level 0."""
    return torch.cat([top, a[:, :-1]], dim=1)


def _sedi_heat(t, m1, dp, dz, cw_spec, qv, ql, qr, qi, qs, qg):
    """Temperature adjustment for vertical heat transport by falling
    condensate (sedi_heat:5685, the leading term)."""
    cvm, _, _ = _heat_capacities(qv, ql, qr, qi, qs, qg, t)
    t_in = _shift_down(t, t[:, :1])
    dq = _shift_down(m1, torch.zeros_like(m1[:, :1]))
    dt = cw_spec * dq * (t_in - t) / (cvm * dp + cw_spec * dq)
    return t + dt


def sedimentation(t, qv, ql, qr, qi, qs, qg, dp, dz, den, denfac, dts,
                  cfg: MPConfig, u=None, v=None, w=None):
    """Fall of rain/ice/snow/graupel (sedimentation:2156 /
    terminal_fall:2530). Per species: terminal velocity, fall (implicit or
    explicit per cfg.sedflag), then the reference's terminal_fall tail:
    momentum transport (sedi_uv:5622 / sedi_w:5653) and sedimentation
    heating. Returns (t, qr, qi, qs, qg, precip, u, v, w)."""
    precip = {}
    fall = implicit_fall if cfg.sedflag != 2 else explicit_fall
    if cfg.do_sedi_w and w is not None:
        # moist air mass from the pre-sedimentation state, once for all
        # species (terminal_fall computes dm before any fall updates q)
        dm = dp * (1.0 + qv + ql + qr + qi + qs + qg)
    for name, qx in (("qi", qi), ("qs", qs), ("qg", qg), ("qr", qr)):
        vt = terminal_velocity(name, qx, den, denfac, cfg)
        qx_new, p, m1 = fall(qx, vt, dz, dp, dts)
        if name == "qr":
            qr = qx_new
        elif name == "qi":
            qi = qx_new
        elif name == "qs":
            qs = qx_new
        else:
            qg = qx_new
        if cfg.do_sedi_uv and u is not None:
            u, v = sedi_uv(m1, dp, u, v)
        if cfg.do_sedi_w and w is not None:
            w = sedi_w(m1, w, vt, dm)
        if cfg.do_sedi_heat:
            cw = C_LIQ if name == "qr" else C_ICE
            t = _sedi_heat(t, m1, dp, dz, cw, qv, ql, qr, qi, qs, qg)
        precip[name] = p * RGRAV            # kg/m^2
    return t, qr, qi, qs, qg, precip, u, v, w


def warm_rain(t, qv, ql, qr, qi, qs, qg, p_lay, den, denfac, dts,
              cfg: MPConfig, ccn=None):
    """praut + pracw + prevp (warm_rain:2792 children)."""
    co = cfg.coeffs
    z = _zero(t)
    if cfg.use_ccn_praut and ccn is not None:
        # CCN-aware autoconversion (praut:3072-3106, irain_f=1)
        fac_rc = (4.0 / 3.0) * math.pi * cfg.rhow * cfg.rthresh ** 3
        aone = 2.0 / 9.0 * (3.0 / 4.0) ** (4.0 / 3.0) / math.pi ** (1.0 / 3.0)
        visd = 1.717e-5                      # dyn. viscosity of air (:148)
        cpaut = cfg.c_paut * aone * con.GRAV / visd
        qc = fac_rc * ccn
        dq = ql - qc
        c_praut = cpaut * torch.exp(
            (-1.0 / 3.0) * torch.log(torch.clamp_min(ccn * cfg.rhow, 1e-20)))
        rate = dts * c_praut * den * torch.exp(
            (7.0 / 3.0) * torch.log(torch.clamp_min(ql, QCMIN)))
        sink = torch.where((t > cfg.t_wfr) & (ql > QCMIN) & (dq > 0.0),
                           torch.minimum(ql, torch.minimum(dq, rate)), z)
    else:
        # simple threshold autoconversion
        sink = cfg.c_paut * torch.clamp_min(ql - cfg.ql0_max, 0.0) \
            * (1.0 - math.exp(-dts / 300.0))
    ql = ql - sink
    qr = qr + sink

    # accretion of cloud water by rain (pracw:2950, exact acr2d form)
    fac = dts * acr2d(qr * den, co.cracw, denfac, co.blin["qr"], co.mu["qr"])
    acc = fac / (1.0 + fac) * ql
    acc = torch.where((qr > QCMIN) & (ql > QCMIN) & (t > cfg.t_wfr), acc, z)
    ql = ql - acc
    qr = qr + acc

    # rain evaporation with ventilation (prevp:2840 / psub:5569)
    cvm, lcpk, _ = _heat_capacities(qv, ql, qr, qi, qs, qg, t)
    qsat, dqdt = wqs_den(t, den)
    dq = qsat - qv
    fac_revp = 1.0 - math.exp(-dts / cfg.tau_revp) if cfg.tau_revp > 1e-6 \
        else 1.0
    t2 = t * t
    rate = psub(t2, dq, qr * den, qsat, co.crevp, den, denfac,
                co.blin["qr"], co.mu["qr"], lcpk, cvm)
    can_evap = (t > cfg.t_wfr) & (qr > QCMIN) & (dq > 0.0)
    evap = torch.where(can_evap,
                       torch.minimum(qr, torch.minimum(
                           dts * fac_revp * rate,
                           dq / (1.0 + lcpk * dqdt))), z)
    qr = qr - evap
    qv = qv + evap
    t = t - evap * lcpk
    return t, qv, ql, qr


def ice_cloud(t, qv, ql, qr, qi, qs, qg, p_lay, den, denfac, dts,
              cfg: MPConfig):
    """Ice-phase processes in the reference order (ice_cloud:3116): pimlt,
    pifr, psmlt, pgmlt, psaci, psaut, pgaci, psacr + pgfr, pgacs, pgaut,
    pgacw + pgacr, psdep/pssub, each through the conserved moist-energy
    update (update_qt:6951)."""
    co = cfg.coeffs
    t_wfr = cfg.t_wfr
    z = _zero(t)

    st = dict(t=t, qv=qv, ql=ql, qr=qr, qi=qi, qs=qs, qg=qg)
    cvm, te8, lcpk, icpk, tcpk, _ = _cal_mhc_lhc(
        t, qv, ql, qr, qi, qs, qg, t_wfr)
    st.update(cvm=cvm, te8=te8, lcpk=lcpk, icpk=icpk, tcpk=tcpk)

    def tvel(name, q):
        return terminal_velocity(name, q, den, denfac, cfg)

    zero = z       # a species the process does not change

    # ---- pimlt: cloud ice melting -> cloud water (up to ql_mlt) + rain ---
    melt = torch.where((st["qi"] > QCMIN) & (st["t"] > TICE),
                       torch.minimum(st["qi"], (st["t"] - TICE) / st["icpk"]),
                       z)
    to_l = torch.minimum(melt, torch.clamp_min(cfg.ql0_max - st["ql"], 0.0))
    st = _update_qt(st, zero, to_l, melt - to_l, -melt, zero, zero)

    # ---- pifr: homogeneous freezing of cloud water below t_wfr -----------
    frez = torch.where((st["ql"] > QCMIN) & (st["t"] < t_wfr),
                       torch.minimum(st["ql"], (t_wfr - st["t"]) / st["icpk"]),
                       z)
    st = _update_qt(st, zero, -frez, zero, frez, zero, zero)

    # ---- psmlt: snow melt with accreted water (psmlt:3362) ---------------
    vtr = tvel("qr", st["qr"])
    vts = tvel("qs", st["qs"])
    vtg = tvel("qg", st["qg"])
    tc = st["t"] - TICE
    warm_s = (tc >= 0.0) & (st["qs"] > QCMIN)
    qden_s = st["qs"] * den
    fac = acr2d(qden_s, co.csacw, denfac, co.blin["qs"], co.mu["qs"])
    psacw = torch.where(st["ql"] > QCMIN,
                        fac / (1.0 + dts * fac) * st["ql"], z)
    psacr = torch.where(st["qr"] > QCMIN,
                        torch.minimum(acr3d(vts, vtr, st["qr"], st["qs"],
                                            co.csacr, _acco_k(co, 2),
                                            co.acc[2], co.acc[3], den),
                                      st["qr"] / dts), z)
    pracs = torch.where(st["qr"] > QCMIN,
                        acr3d(vtr, vts, st["qs"], st["qr"], co.cracs,
                              _acco_k(co, 1), co.acc[0], co.acc[1], den), z)
    qsi, _ = iqs_den(st["t"], den)
    dq = qsi - st["qv"]
    rate = torch.clamp_min(pmlt(tc, dq, qden_s, psacw, psacr, co.csmlt,
                                den, denfac, co.blin["qs"], co.mu["qs"],
                                st["lcpk"], st["icpk"], st["cvm"]), 0.0)
    sink = torch.minimum(st["qs"],
                         torch.minimum((rate + pracs) * dts,
                                       torch.clamp_min(tc, 0.0) / st["icpk"]))
    sink = torch.where(warm_s, sink, z)
    tmp = torch.minimum(sink, torch.clamp_min(cfg.qs_mlt - st["ql"], 0.0))
    st = _update_qt(st, zero, tmp, sink - tmp, zero, -sink, zero)

    # ---- pgmlt: graupel melt (pgmlt:3447) --------------------------------
    tc = st["t"] - TICE
    warm_g = (tc >= 0.0) & (st["qg"] > QCMIN)
    qden_g = st["qg"] * den
    fac = acr2d(qden_g, co.cgacw, denfac, co.blin["qg"], co.mu["qg"])
    pgacw = torch.where(st["ql"] > QCMIN,
                        fac / (1.0 + dts * fac) * st["ql"], z)
    pgacr = torch.where(st["qr"] > QCMIN,
                        torch.minimum(acr3d(vtg, vtr, st["qr"], st["qg"],
                                            co.cgacr, _acco_k(co, 3),
                                            co.acc[4], co.acc[5], den),
                                      st["qr"] / dts), z)
    qsi, _ = iqs_den(st["t"], den)
    dq = qsi - st["qv"]
    rate = torch.clamp_min(pmlt(tc, dq, qden_g, pgacw, pgacr, co.cgmlt,
                                den, denfac, co.blin["qg"], co.mu["qg"],
                                st["lcpk"], st["icpk"], st["cvm"]), 0.0)
    sink = torch.minimum(st["qg"],
                         torch.minimum(rate * dts,
                                       torch.clamp_min(tc, 0.0) / st["icpk"]))
    sink = torch.where(warm_g, sink, z)
    st = _update_qt(st, zero, zero, sink, zero, zero, -sink)

    # ---- psaci: snow accretion of cloud ice (psaci:3536) -----------------
    tc = st["t"] - TICE
    cold_i = (tc < 0.0) & (st["qi"] > QCMIN)
    fac = dts * acr2d(st["qs"] * den, co.csaci, denfac,
                      co.blin["qs"], co.mu["qs"])
    sink = torch.where(cold_i & (st["qs"] > QCMIN),
                       fac / (1.0 + fac) * st["qi"], z)
    sink = torch.minimum(cfg.fi2s_fac * st["qi"], sink)
    st = _update_qt(st, zero, zero, zero, -sink, sink, zero)

    # ---- psaut: ice -> snow autoconversion (psaut:3599) ------------------
    tc = st["t"] - TICE
    qi0 = cfg.qi0_crt / torch.clamp_min(den, 1e-10)
    fac_i2s = 1.0 - math.exp(-dts / cfg.tau_i2s)
    tmp = fac_i2s * torch.exp(0.025 * tc)
    sink = torch.where(tc < 0.0,
                       tmp * torch.clamp_min(st["qi"] - qi0, 0.0), z)
    sink = torch.minimum(cfg.fi2s_fac * st["qi"], sink)
    st = _update_qt(st, zero, zero, zero, -sink, sink, zero)

    # ---- pgaci: graupel accretion of cloud ice (pgaci:3665) --------------
    tc = st["t"] - TICE
    fac = dts * acr2d(st["qg"] * den, co.cgaci, denfac,
                      co.blin["qg"], co.mu["qg"])
    sink = torch.where((tc < 0.0) & (st["qi"] > QCMIN) & (st["qg"] > QCMIN),
                       fac / (1.0 + fac) * st["qi"], z)
    st = _update_qt(st, zero, zero, zero, -sink, zero, sink)

    # ---- psacr + pgfr: snow accretes rain; Bigg rain freezing ------------
    tc = st["t"] - TICE
    active = (tc < 0.0) & (st["qr"] > QCMIN)
    vtr = tvel("qr", st["qr"])
    vts = tvel("qs", st["qs"])
    psacr = torch.where(st["qs"] > QCMIN,
                        dts * acr3d(vts, vtr, st["qr"], st["qs"], co.csacr,
                                    _acco_k(co, 2), co.acc[2], co.acc[3],
                                    den), z)
    pgfr = (dts * co.cgfr[0] / torch.clamp_min(den, 1e-10)
            * (torch.exp(-co.cgfr[1] * tc) - 1.0)
            * torch.exp((6 + co.mu["qr"]) / (co.mu["qr"] + 3)
                        * _log6(st["qr"] * den)))
    tot = psacr + pgfr
    factor = torch.where(active,
                         torch.minimum(torch.minimum(tot, st["qr"]),
                                       torch.clamp_min(-tc, 0.0) / st["icpk"])
                         / torch.clamp_min(tot, QCMIN), z)
    psacr = factor * psacr
    pgfr = factor * pgfr
    sink = torch.minimum(st["qr"], psacr + pgfr)
    st = _update_qt(st, zero, zero, -sink, zero, psacr, pgfr)

    # ---- pgacs: graupel accretion of snow (pgacs:3803) -------------------
    vts = tvel("qs", st["qs"])
    vtg = tvel("qg", st["qg"])
    sink = torch.where((st["t"] < TICE) & (st["qs"] > QCMIN)
                       & (st["qg"] > QCMIN),
                       dts * acr3d(vtg, vts, st["qs"], st["qg"], co.cgacs,
                                   _acco_k(co, 4), co.acc[6], co.acc[7],
                                   den), z)
    sink = torch.minimum(cfg.fs2g_fac * st["qs"], sink)
    st = _update_qt(st, zero, zero, zero, zero, -sink, sink)

    # ---- pgaut: snow -> graupel autoconversion (pgaut:3854) --------------
    tc = st["t"] - TICE
    qs0 = cfg.qs0_crt / torch.clamp_min(den, 1e-10)
    fac_s2g = 1.0 - math.exp(-dts / cfg.tau_i2s)
    sink = torch.where(tc < 0.0,
                       fac_s2g * torch.exp(0.09 * tc)
                       * torch.clamp_min(st["qs"] - qs0, 0.0), z)
    sink = torch.minimum(cfg.fs2g_fac * st["qs"], sink)
    st = _update_qt(st, zero, zero, zero, zero, -sink, sink)

    # ---- pgacw + pgacr: graupel accretes cloud water & rain (freezing) ---
    tc = st["t"] - TICE
    active = (tc < 0.0) & (st["qg"] > QCMIN)
    qden_g = st["qg"] * den
    fac = dts * acr2d(qden_g, co.cgacw, denfac, co.blin["qg"], co.mu["qg"])
    pgacw = torch.where(st["ql"] > QCMIN, fac / (1.0 + fac) * st["ql"], z)
    vtr = tvel("qr", st["qr"])
    vtg = tvel("qg", st["qg"])
    pgacr = torch.where(st["qr"] > QCMIN,
                        torch.minimum(dts * acr3d(vtg, vtr, st["qr"],
                                                  st["qg"], co.cgacr,
                                                  _acco_k(co, 3), co.acc[4],
                                                  co.acc[5], den),
                                      st["qr"]), z)
    tot = pgacr + pgacw
    factor = torch.where(active,
                         torch.minimum(tot, torch.clamp_min(-tc, 0.0)
                                       / st["icpk"])
                         / torch.clamp_min(tot, QCMIN), z)
    pgacw = factor * pgacw
    pgacr = factor * pgacr
    st = _update_qt(st, zero, -pgacw, -pgacr, zero, zero, pgacw + pgacr)

    # ---- psdep / pssub: snow deposition/sublimation with ventilation -----
    cold = st["t"] < TICE
    qsi, disdt = iqs_den(st["t"], den)
    dqi = st["qv"] - qsi
    t2 = st["t"] * st["t"]
    rate = psub(t2, -dqi, st["qs"] * den, qsi, co.cssub, den, denfac,
                co.blin["qs"], co.mu["qs"], st["tcpk"], st["cvm"])
    # rate > 0 for subsaturation (sublimation); < 0 for deposition
    sub = torch.where(cold & (dqi < 0.0) & (st["qs"] > QCMIN),
                      torch.minimum(st["qs"], dts * rate), z)
    dep = torch.where(cold & (dqi > 0.0) & (st["qs"] > QCMIN),
                      torch.minimum(-dts * rate,
                                    dqi / (1.0 + st["tcpk"] * disdt)), z)
    sink = dep - sub
    st = _update_qt(st, -sink, zero, zero, zero, sink, zero)

    return (st["t"], st["qv"], st["ql"], st["qr"], st["qi"], st["qs"],
            st["qg"])


def sat_adjust(t, qv, ql, qr, qi, qs, qg, p_lay, dts, cfg: MPConfig):
    """Condensation/evaporation + deposition/sublimation (pcond_pevap:4198,
    pidep_pisub:4457) with the complete-freezing floor."""
    z = _zero(t)
    cvm, lcpk, icpk = _heat_capacities(qv, ql, qr, qi, qs, qg, t)

    # vapor <-> liquid
    qsw, dwsdt = wqs(t, p_lay)
    dq = qv - qsw
    cond = torch.where(dq > 0.0,
                       torch.minimum(dq / (1.0 + lcpk * dwsdt), dq)
                       * (1.0 - math.exp(-dts / cfg.tau_v2l)), z)
    evap = torch.where(dq < 0.0,
                       torch.minimum(ql, -dq / (1.0 + lcpk * dwsdt))
                       * (1.0 - math.exp(-dts / cfg.tau_l2v)), z)
    sink = cond - evap
    qv = qv - sink
    ql = ql + sink
    t = t + sink * lcpk

    # vapor <-> ice below freezing
    qsi, disdt = iqs(t, p_lay)
    dqi = qv - qsi
    cold = t < TICE
    dep = torch.where(cold & (dqi > 0.0) & (t > cfg.t_sub),
                      dqi / (1.0 + (lcpk + icpk) * disdt), z)
    sub = torch.where(cold & (dqi < 0.0),
                      torch.minimum(qi, -dqi / (1.0 + (lcpk + icpk) * disdt))
                      * (1.0 - math.exp(-dts / cfg.tau_l2v)), z)
    sinki = dep - sub
    qv = qv - sinki
    qi = qi + sinki
    t = t + sinki * (lcpk + icpk)

    # complete freezing of cloud water below t_wfr - 8K (mp_fast:2049)
    t48 = cfg.t_wfr - 8.0
    frez = torch.where((ql > QCMIN) & (t < t48),
                       torch.minimum(ql, (t48 - t) / icpk), z)
    ql = ql - frez
    qi = qi + frez
    t = t + frez * icpk
    return t, qv, ql, qr, qi, qs, qg


def cloud_fraction(qv, ql, qi, qs, p_lay, t, rh_inc=0.25):
    """GFDL area cloud fraction (cloud_fraction:4699, RH-based closure with
    a condensate trigger)."""
    qsw, _ = wqs(t, p_lay)
    qsi, _ = iqs(t, p_lay)
    qsat = torch.where(t < TICE, qsi, qsw)
    rh = qv / torch.clamp_min(qsat, 1.0e-12)
    qcond = ql + qi + qs
    base = torch.clamp((rh - (1.0 - rh_inc)) / rh_inc, 0.0, 1.0)
    return torch.where(qcond > 1.0e-8,
                       torch.maximum(base, 0.05 + 0.95 * base), 0.0)


def mp_full(t, qv, ql, qr, qi, qs, qg, delp, dz, den, denfac, dts, p_lay,
            cfg: MPConfig, ccn=None, ua=None, va=None, w=None):
    """Full microphysics loop (mp_full, gfdl_mp.F90:1892): per subcycle
    sedimentation -> warm rain -> ice cloud -> the temperature-sensitive
    saturation processes (subgrid_z_proc under cfg.use_subgrid_proc, else
    the condensed sat_adjust), ntimes times. Returns (t, qv..qg, ua, va,
    w, rain, ice, snow, graupel)."""
    rain = snow = icep = graup = 0.0
    for _ in range(cfg.ntimes):
        t, qr, qi, qs, qg, pcp, ua_n, va_n, w = sedimentation(
            t, qv, ql, qr, qi, qs, qg, delp, dz, den, denfac, dts, cfg,
            u=ua, v=va, w=w)
        if ua_n is not None:
            ua, va = ua_n, va_n
        rain = rain + pcp["qr"]
        icep = icep + pcp["qi"]
        snow = snow + pcp["qs"]
        graup = graup + pcp["qg"]
        t, qv, ql, qr = warm_rain(t, qv, ql, qr, qi, qs, qg, p_lay, den,
                                  denfac, dts, cfg, ccn=ccn)
        t, qv, ql, qr, qi, qs, qg = ice_cloud(
            t, qv, ql, qr, qi, qs, qg, p_lay, den, denfac, dts, cfg)
        if cfg.use_subgrid_proc:
            t, qv, ql, qr, qi, qs, qg = subgrid_z_proc(
                t, qv, ql, qr, qi, qs, qg, delp, den, denfac, dts, cfg,
                rh_adj=cfg.rh_adj, ccn=ccn)
        else:
            t, qv, ql, qr, qi, qs, qg = sat_adjust(
                t, qv, ql, qr, qi, qs, qg, p_lay, dts, cfg)
    return (t, qv, ql, qr, qi, qs, qg, ua, va, w,
            rain, icep, snow, graup)


def _layer_pressure(delp, ptop):
    """Layer-mean pressure delp / dlog(pe) from the interface pressures."""
    pe = ptop + torch.cumsum(delp, dim=1)
    pe = torch.cat([torch.full_like(pe[:, :1], ptop), pe], dim=1)
    peln = torch.log(pe)
    return delp / (peln[:, 1:] - peln[:, :-1]), peln


def _layer_thickness(t, qv, delz, peln, hydrostatic):
    """Layer thickness dz > 0: from the hydrostatic relation, or -delz."""
    if hydrostatic or delz is None:
        tv = t * (1.0 + con.ZVIR * qv)
        return con.RDGAS * tv / con.GRAV * (peln[:, 1:] - peln[:, :-1])
    return -delz


def gfdl_mp_driver(pt, delp, delz, q, dt, ptop, cfg: MPConfig = MPConfig(),
                   hydrostatic=False, w=None, ua=None, va=None, hs=None):
    """One physics step of microphysics (gfdl_mp_driver:607 / mpdrv:1167).

    pt: TEMPERATURE [6,K,y,x]; q: dict with the 6 categories (+ optional
    cld_amt, and optionally 'liq_aero', the prognostic aerosol number
    tracer prog_ccn reads). delz < 0 (heights) for the nonhydrostatic
    gas-law density; hydrostatic mode derives density from the hydrostatic
    relation. w/ua/va: winds for sedimentation momentum transport
    (do_sedi_w/do_sedi_uv; returned in diag['w'/'ua'/'va'] only when
    passed). hs: surface geopotential (the land proxy for CCN). Returns
    (pt, q, diag with precip accumulations rain/ice/snow/graupel [kg/m^2];
    cfg.consv_checker adds the mtetw audits te_beg/te_end/tw_beg/tw_end/
    te_err/tw_err, mpdrv:1365/:1570)."""
    z = torch.zeros_like(pt)
    qv, ql, qr, qi, qs, qg = (q.get(k, z) for k in NAMES)
    t = pt
    if hydrostatic:
        w = None

    p_lay, peln = _layer_pressure(delp, ptop)
    dz = _layer_thickness(t, qv, delz, peln, hydrostatic)
    den = delp / (con.GRAV * dz)
    denfac = torch.sqrt(RHO0 / torch.clamp_min(den, 1e-10))
    ccn = compute_ccn(den, cfg, hs=hs, qnl=q.get("liq_aero"))

    if cfg.consv_checker:
        te_beg, tw_beg = mte_column(t, qv, ql, qr, qi, qs, qg, delp,
                                    u=ua, v=va, w=w)
    w_in = w
    ua_in, va_in = ua, va

    dts = dt / cfg.ntimes
    (t, qv, ql, qr, qi, qs, qg, ua, va, w,
     rain, icep, snow, graup) = mp_full(
        t, qv, ql, qr, qi, qs, qg, delp, dz, den, denfac, dts, p_lay,
        cfg, ccn=ccn, ua=ua, va=va, w=w)

    # kinetic energy lost by sedimentation momentum transport goes to heat
    # (mpdrv:1550-1566: the sedi_uv term 0.5*(ua^2+va^2 - u^2-v^2)/c8 and
    # the sedi_w term 0.5*(wa^2 - w^2)/c8)
    ke_heat = None
    if w is not None and w_in is not None and cfg.do_sedi_w:
        ke_heat = 0.5 * (w_in * w_in - w * w)
    if cfg.do_sedi_uv and ua is not None and ua_in is not None:
        duv = 0.5 * (ua_in * ua_in + va_in * va_in - ua * ua - va * va)
        ke_heat = duv if ke_heat is None else ke_heat + duv
    if ke_heat is not None:
        cvm, _, _ = _heat_capacities(qv, ql, qr, qi, qs, qg, t)
        t = t + ke_heat / cvm

    out = dict(q)
    for k, v in zip(NAMES, (qv, ql, qr, qi, qs, qg)):
        out[k] = v
    if "cld_amt" in q:
        out["cld_amt"] = cloud_fraction(qv, ql, qi, qs, p_lay, t)
    diag = dict(rain=rain, ice=icep, snow=snow, graupel=graup)
    if w is not None and w_in is not None:
        diag["w"] = w
    if cfg.do_sedi_uv and ua is not None:
        diag["ua"], diag["va"] = ua, va
    if cfg.consv_checker:
        te_end, tw_end = mte_column(t, qv, ql, qr, qi, qs, qg, delp,
                                    u=ua, v=va, w=w)
        surf_w = rain + icep + snow + graup       # kg/m^2 left the column
        diag.update(
            te_beg=te_beg, te_end=te_end, tw_beg=tw_beg, tw_end=tw_end,
            tw_err=(tw_end + surf_w - tw_beg) / torch.clamp_min(tw_beg,
                                                                1e-30),
            te_err=(te_end - te_beg) / torch.clamp_min(torch.abs(te_beg),
                                                       1e-30))
    return t, out, diag


def fast_sat_adj(pt, delp, delz, q, dt, ptop, cfg: MPConfig = MPConfig(),
                 hydrostatic=False, last_step=True):
    """Inline fast physics (the dyn_core 'fast physics' hook,
    fast_phys.F90:58): with cfg.use_mp_fast (default), the mp_fast process
    chain (gfdl_mp.F90:1995); otherwise the condensed melt/freeze +
    vapor<->liquid<->ice sat_adjust. pt: TEMPERATURE. Returns (t, q) with
    only the categories present in q replaced."""
    z = torch.zeros_like(pt)
    qv, ql, qr, qi, qs, qg = (q.get(k, z) for k in NAMES)
    p_lay, peln = _layer_pressure(delp, ptop)
    if cfg.use_mp_fast:
        dz = _layer_thickness(pt, qv, delz, peln, hydrostatic)
        den = delp / (con.GRAV * dz)
        denfac = torch.sqrt(RHO0 / torch.clamp_min(den, 1e-10))
        t, qv, ql, qr, qi, qs, qg = mp_fast(
            pt, qv, ql, qr, qi, qs, qg, dt, delp, den, denfac, cfg,
            last_step=last_step)
    else:
        t, qv, ql, qr, qi, qs, qg = sat_adjust(pt, qv, ql, qr, qi, qs, qg,
                                               p_lay, dt, cfg)
    out = dict(q)
    for k, v in zip(NAMES, (qv, ql, qr, qi, qs, qg)):
        if k in q:
            out[k] = v
    return t, out


# ---------------------------------------------------------------------------
# Fast-physics process set: the mp_fast chain (gfdl_mp.F90 mp_fast:1995)
# run inside the acoustic loop from the fast_phys hook, and the
# per-process subgrid_z_proc of mp_full. Each process works on a state dict
# st = {t, qv, ql, qr, qi, qs, qg, te8, cvm, lcpk, icpk, tcpk, tcp3, t_wfr}
# with masked sinks and the conserved-energy update_qt bookkeeping
# (_update_qt).
# ---------------------------------------------------------------------------

DT_FR = 8.0       # t_wfr - dt_fr = min temp liquid water exists (:181)
TCOND = 2.40e-2   # thermal conductivity of air at 0 C (:151)
VDIFU = 2.25e-5   # vapor diffusivity at 0 C (:150)


def _st_init(t, qv, ql, qr, qi, qs, qg, t_wfr):
    cvm, te8, lcpk, icpk, tcpk, tcp3 = _cal_mhc_lhc(
        t, qv, ql, qr, qi, qs, qg, t_wfr)
    return dict(t=t, qv=qv, ql=ql, qr=qr, qi=qi, qs=qs, qg=qg, te8=te8,
                cvm=cvm, lcpk=lcpk, icpk=icpk, tcpk=tcpk, tcp3=tcp3,
                t_wfr=t_wfr)


def pimlt(st, dts, cfg: MPConfig):
    """Cloud ice melting -> cloud water + rain (pimlt:3244)."""
    z = _zero(st["t"])
    fac = 1.0 - math.exp(-dts / cfg.tau_imlt)
    tc = st["t"] - cfg.tice_mlt
    act = (tc > 0.0) & (st["qi"] > QCMIN)
    sink = torch.minimum(st["qi"], fac * tc / st["icpk"])
    sink = torch.where(act, sink, z)
    tmp = torch.minimum(sink, torch.clamp_min(cfg.ql_mlt - st["ql"], 0.0))
    return _update_qt(st, 0.0, tmp, sink - tmp, -sink, 0.0, 0.0)


def pcomp(st, cfg: MPConfig):
    """Complete freezing of cloud water below t_wfr (pcomp:4273)."""
    tc = st["t_wfr"] - st["t"]
    act = (tc > 0.0) & (st["ql"] > QCMIN)
    sink = torch.minimum(torch.minimum(st["ql"], st["ql"] * tc / DT_FR),
                         tc / st["icpk"])
    sink = torch.where(act, sink, _zero(sink))
    return _update_qt(st, 0.0, -sink, 0.0, sink, 0.0, 0.0)


def pcond_pevap(st, dts, den, cfg: MPConfig):
    """Cloud water condensation / evaporation (pcond_pevap:4198)."""
    fac_l2v = 1.0 - math.exp(-dts / cfg.tau_l2v)
    fac_v2l = 1.0 - math.exp(-dts / cfg.tau_v2l)
    qsw, dqdt = wqs_den(st["t"], den)
    qpz = st["qv"] + st["ql"] + st["qi"]
    rh_tem = qpz / qsw
    dq = qsw - st["qv"]
    denom = 1.0 + st["tcp3"] * dqdt
    # evaporation branch (dq > 0): ql -> qv
    if cfg.do_evap_timescale:
        factor_e = torch.clamp_max(fac_l2v * (cfg.rh_fac_evap * dq / qsw),
                                   1.0)
    else:
        factor_e = 1.0
    sink_e = torch.minimum(st["ql"], factor_e * dq / denom)
    if cfg.use_rhc_cevap:
        sink_e = torch.where(rh_tem >= cfg.rhc_cevap, _zero(sink_e), sink_e)
    # condensation branch (dq <= 0): qv -> ql
    if cfg.do_cond_timescale:
        factor_c = torch.clamp_max(
            fac_v2l * (cfg.rh_fac_cond * (-dq) / qsw), 1.0)
    else:
        factor_c = 1.0
    sink_c = -torch.minimum(st["qv"], factor_c * (-dq) / denom)
    sink = torch.where(dq > 0.0, sink_e, sink_c)
    return _update_qt(st, sink, -sink, 0.0, 0.0, 0.0, 0.0)


def pifr(st, den, cfg: MPConfig):
    """Homogeneous cloud water freezing -> ice + snow (pifr:3303)."""
    tc = st["t_wfr"] - st["t"]
    act = (tc > 0.0) & (st["ql"] > QCMIN)
    sink = torch.minimum(torch.minimum(st["ql"], st["ql"] * tc / DT_FR),
                         tc / st["icpk"])
    sink = torch.where(act, sink, _zero(sink))
    qim = cfg.qi0_crt / den
    tmp = torch.minimum(sink, torch.clamp_min(qim - st["qi"], 0.0))
    return _update_qt(st, 0.0, -sink, 0.0, tmp, sink - tmp, 0.0)


def pwbf(st, dts, den, cfg: MPConfig):
    """Wegener-Bergeron-Findeisen process (pwbf:4329)."""
    if not cfg.do_wbf:
        return st
    fac = 1.0 - math.exp(-dts / cfg.tau_wbf)
    tc = TICE - st["t"]
    qsw, _ = wqs_den(st["t"], den)
    qsi, _ = iqs_den(st["t"], den)
    act = ((tc > 0.0) & (st["ql"] > QCMIN) & (st["qi"] > QCMIN)
           & (st["qv"] > qsi) & (st["qv"] < qsw))
    sink = torch.minimum(fac * st["ql"], tc / st["icpk"])
    sink = torch.where(act, sink, _zero(sink))
    qim = cfg.qi0_crt / den
    tmp = torch.minimum(sink, torch.clamp_min(qim - st["qi"], 0.0))
    return _update_qt(st, 0.0, -sink, 0.0, tmp, sink - tmp, 0.0)


def pbigg(st, dts, den, ccn, cfg: MPConfig):
    """Bigg (1953) heterogeneous freezing of cloud water (pbigg:4395)."""
    tc = TICE - st["t"]
    act = (tc > 0.0) & (st["ql"] > QCMIN)
    ccn_ = torch.clamp_min(ccn, 1.0e-8)
    sink = (100.0 / (cfg.rhow * ccn_) * dts
            * (torch.exp(0.66 * torch.clamp_max(tc, 80.0)) - 1.0)
            * st["ql"] ** 2)
    sink = torch.minimum(torch.minimum(st["ql"], sink), tc / st["icpk"])
    sink = torch.where(act, sink, _zero(sink))
    return _update_qt(st, 0.0, -sink, 0.0, sink, 0.0, 0.0)


def pgfr_simp(st, dts, cfg: MPConfig):
    """Rain freezing -> graupel, simple version (pgfr_simp:5814)."""
    fac = 1.0 - math.exp(-dts / cfg.tau_r2g)
    tc = st["t"] - TICE
    act = (tc < 0.0) & (st["qr"] > QCMIN)
    sink = (-tc * 0.025) ** 2 * st["qr"]
    sink = torch.minimum(torch.minimum(st["qr"], sink),
                         -fac * tc / st["icpk"])
    sink = torch.where(act, sink, _zero(sink))
    return _update_qt(st, 0.0, 0.0, -sink, 0.0, 0.0, sink)


def psmlt_simp(st, dts, cfg: MPConfig):
    """Snow melting -> cloud water + rain, simple version
    (psmlt_simp:5872)."""
    fac = 1.0 - math.exp(-dts / cfg.tau_smlt)
    tc = st["t"] - TICE
    act = (tc >= 0.0) & (st["qs"] > QCMIN)
    sink = (tc * 0.1) ** 2 * st["qs"]
    sink = torch.minimum(torch.minimum(st["qs"], sink),
                         fac * tc / st["icpk"])
    sink = torch.where(act, sink, _zero(sink))
    tmp = torch.minimum(sink, torch.clamp_min(cfg.qs_mlt - st["ql"], 0.0))
    return _update_qt(st, 0.0, tmp, sink - tmp, 0.0, -sink, 0.0)


def praut_simp(st, dts, cfg: MPConfig):
    """Cloud water -> rain autoconversion, simple version
    (praut_simp:5931): a liquid-phase transfer, no T change since ql and
    qr share C_LIQ."""
    fac = 1.0 - math.exp(-dts / cfg.tau_l2r)
    tc = st["t"] - st["t_wfr"]
    act = (tc > 0.0) & (st["ql"] > cfg.ql0_max)
    sink = torch.where(act, fac * (st["ql"] - cfg.ql0_max), _zero(tc))
    return _update_qt(st, 0.0, -sink, sink, 0.0, 0.0, 0.0)


def _ice_nuclei(st, den, qsi, cfg: MPConfig):
    """Ice-nuclei number per inflag (pidep_pisub:4502-4512)."""
    qi_den = torch.clamp_min(st["qi"] * den, 1.0e-20)
    if cfg.inflag == 1:
        return 5.38e7 * torch.exp(0.75 * torch.log(qi_den))
    if cfg.inflag == 2:
        return torch.exp(-2.80 + 0.262 * (TICE - st["t"])) * 1000.0
    if cfg.inflag == 3:
        return torch.exp(-0.639 + 12.96 * (st["qv"] / qsi - 1.0)) * 1000.0
    if cfg.inflag == 4:
        return 5.0e-3 * torch.exp(0.304 * (TICE - st["t"])) * 1000.0
    return 1.0e-5 * torch.exp(0.5 * (TICE - st["t"])) * 1000.0


def pidep_pisub(st, dts, den, cin, cfg: MPConfig):
    """Cloud ice deposition / sublimation (pidep_pisub:4457)."""
    z = _zero(st["t"])
    cold = st["t"] < TICE
    qsi, dqdt = iqs_den(st["t"], den)
    dq = st["qv"] - qsi
    tmp = dq / (1.0 + st["tcpk"] * dqdt)
    cin_ = _ice_nuclei(st, den, qsi, cfg) if cin is None else cin
    has_ice = st["qi"] > QCMIN
    pidep = (dts * dq * 4.0 * 11.9
             * torch.exp(0.5 * torch.log(
                 torch.clamp_min(st["qi"] * den * cin_, 1.0e-30)))
             / (qsi * den * (st["tcpk"] * st["cvm"]) ** 2
                / (TCOND * con.RVGAS * st["t"] ** 2) + 1.0 / VDIFU))
    pidep = torch.where(has_ice, pidep, z)
    # deposition branch (dq > 0): limited by generation + heating
    tc = TICE - st["t"]
    qi_gen = 4.92e-11 * torch.exp(1.33 * torch.log(
        1.0e3 * torch.exp(0.1 * torch.clamp_min(tc, 0.0))))
    if cfg.igflag == 1:
        qi_crt = qi_gen / den
    elif cfg.igflag == 2:
        qi_crt = qi_gen * torch.clamp_max(0.1 * tc, cfg.qi_lim) / den
    elif cfg.igflag == 3:
        qi_crt = 1.82e-6 * torch.clamp_max(0.1 * tc, cfg.qi_lim) / den
    else:
        qi_crt = (torch.clamp_min(qi_gen, 1.82e-6)
                  * torch.clamp_max(0.1 * tc, cfg.qi_lim) / den)
    sink_dep = torch.minimum(torch.minimum(
        tmp, torch.maximum(qi_crt - st["qi"], pidep)), tc / st["tcpk"])
    # sublimation branch (dq <= 0)
    pisub = pidep * torch.clamp_max(
        torch.clamp_min(st["t"] - cfg.t_sub, 0.0) * cfg.is_fac, 1.0)
    sink_sub = torch.maximum(torch.maximum(pisub, tmp), -st["qi"])
    sink = torch.where(dq > 0.0, sink_dep, sink_sub)
    sink = torch.where(cold, sink, z)
    return _update_qt(st, -sink, 0.0, 0.0, sink, 0.0, 0.0)


def _dep_sub_species(st, dts, den, denfac, cfg, species, c5, blin, mu,
                     fac):
    """Shared psdep_pssub (:4555) / pgdep_pgsub (:4624) body."""
    z = _zero(st["t"])
    qx = st[species]
    act = qx > QCMIN
    qsi, dqdt = iqs_den(st["t"], den)
    qden = qx * den
    t2 = st["t"] * st["t"]
    dq = qsi - st["qv"]
    pxsub = dts * psub(t2, dq, qden, qsi, c5, den, denfac, blin, mu,
                       st["tcpk"], st["cvm"])
    dq2 = dq / (1.0 + st["tcpk"] * dqdt)
    # sublimation (pxsub > 0): qx -> qv, temperature-gated
    sink_sub = torch.minimum(
        pxsub * torch.clamp_max(
            torch.clamp_min(st["t"] - cfg.t_sub, 0.0) * fac, 1.0), qx)
    # deposition (pxsub <= 0) only below freezing
    sink_dep = torch.where(
        st["t"] <= TICE,
        torch.maximum(torch.maximum(pxsub, dq2),
                      (st["t"] - TICE) / st["tcpk"]), z)
    sink = torch.where(pxsub > 0.0, sink_sub, sink_dep)
    sink = torch.where(act, sink, z)
    dqs = -sink if species == "qs" else 0.0
    dqg = -sink if species == "qg" else 0.0
    return _update_qt(st, sink, 0.0, 0.0, 0.0, dqs, dqg)


def psdep_pssub(st, dts, den, denfac, cfg: MPConfig):
    """Snow deposition / sublimation (psdep_pssub:4555)."""
    return _dep_sub_species(st, dts, den, denfac, cfg, "qs",
                            cfg.coeffs.cssub, cfg.blins, cfg.mus,
                            cfg.ss_fac)


def pgdep_pgsub(st, dts, den, denfac, cfg: MPConfig):
    """Graupel deposition / sublimation (pgdep_pgsub:4624)."""
    return _dep_sub_species(st, dts, den, denfac, cfg, "qg",
                            cfg.coeffs.cgsub, cfg.bling, cfg.mug,
                            cfg.gs_fac)


def psaut_simp(st, dts, den, cfg: MPConfig):
    """Cloud ice -> snow autoconversion, simple version
    (psaut_simp:5983): an ice-phase transfer, no T change."""
    fac = 1.0 - math.exp(-dts / cfg.tau_i2s)
    tc = st["t"] - TICE
    qim = cfg.qi0_max / den
    act = (tc < 0.0) & (st["qi"] > qim)
    sink = torch.where(act, fac * (st["qi"] - qim), _zero(tc))
    return _update_qt(st, 0.0, 0.0, 0.0, -sink, sink, 0.0)


def mp_fast(t, qv, ql, qr, qi, qs, qg, dtm, dp, den, denfac,
            cfg: MPConfig, ccn=None, cin=None, last_step=True):
    """Fast microphysics loop (mp_fast, gfdl_mp.F90:1995): the simplified
    phase-change process chain run each acoustic/remap step: melting,
    complete freezing, condensation/evaporation, homogeneous + WBF +
    Bigg freezing, rain freezing, snow melting, warm/ice
    autoconversions, and the three deposition/sublimation processes.
    Returns (t, qv, ql, qr, qi, qs, qg)."""
    if ccn is None:
        ccn = torch.full_like(t, 1.0e8 / 1.2)   # ~100/cm^3 / den fallback
    st = _st_init(t, qv, ql, qr, qi, qs, qg, cfg.t_wfr)
    fr_mlt = (not cfg.do_warm_rain_mp) and cfg.fast_fr_mlt
    if fr_mlt:
        st = pimlt(st, dtm, cfg)
        st = pcomp(st, cfg)
    if (not cfg.delay_cond_evap) or last_step:
        for _ in range(cfg.nconds):
            st = pcond_pevap(st, dtm, den, cfg)
    if fr_mlt:
        st = pifr(st, den, cfg)
        st = pwbf(st, dtm, den, cfg)
        st = pbigg(st, dtm, den, ccn, cfg)
        st = pgfr_simp(st, dtm, cfg)
        st = psmlt_simp(st, dtm, cfg)
    st = praut_simp(st, dtm, cfg)
    if (not cfg.do_warm_rain_mp) and cfg.fast_dep_sub:
        st = pidep_pisub(st, dtm, den, cin, cfg)
        st = psaut_simp(st, dtm, den, cfg)
        st = psdep_pssub(st, dtm, den, denfac, cfg)
        st = pgdep_pgsub(st, dtm, den, denfac, cfg)
    return (st["t"], st["qv"], st["ql"], st["qr"], st["qi"], st["qs"],
            st["qg"])


def pinst(st, den, rh_adj, cfg: MPConfig):
    """Instant processes (pinst:4113): deposit all vapor to ice below
    t_min; instantly evaporate/sublimate all clouds when the clear-sky
    RH (from the te8-implied temperature with all condensate removed)
    is below rh_adj."""
    z = _zero(st["t"])
    # super-cold instant deposition
    sink = torch.where(st["t"] < cfg.t_min,
                       torch.clamp_min(st["qv"] - QCMIN, 0.0), z)
    st = _update_qt(st, -sink, 0.0, 0.0, sink, 0.0, 0.0)
    # instant evaporation below rh_adj
    qpz = st["qv"] + st["ql"] + st["qi"]
    tin = (st["te8"] - LV0 * qpz + LI0 * (st["qs"] + st["qg"])) / _mhc(
        qpz, st["qr"], 0.0, 0.0, st["qs"], st["qg"])
    qsi, _ = iqs_den(tin, den)
    act = (tin > cfg.t_sub + 6.0) & (qpz / qsi < rh_adj)
    sink_l = torch.where(act, st["ql"], z)
    sink_i = torch.where(act, st["qi"], z)
    return _update_qt(st, sink_l + sink_i, -sink_l, 0.0, -sink_i, 0.0,
                      0.0)


def subgrid_z_proc(t, qv, ql, qr, qi, qs, qg, dp, den, denfac, dts,
                   cfg: MPConfig, rh_adj=0.0, ccn=None, cin=None,
                   last_step=True):
    """Temperature-sensitive high-vertical-resolution saturation
    processes (subgrid_z_proc:3989), the per-process full-path counterpart
    of the condensed sat_adjust: cal_mhc_lhc -> pinst -> pcond_pevap
    (x nconds) -> pcomp -> pwbf -> pbigg -> pidep_pisub -> psdep_pssub ->
    pgdep_pgsub, each on the conserved-te8 update_qt bookkeeping. mp_full
    runs it under cfg.use_subgrid_proc."""
    if ccn is None:
        ccn = torch.full_like(t, 1.0e8 / 1.2)
    st = _st_init(t, qv, ql, qr, qi, qs, qg, cfg.t_wfr)
    st = pinst(st, den, rh_adj, cfg)
    if (not cfg.delay_cond_evap) or last_step:
        for _ in range(cfg.nconds):
            st = pcond_pevap(st, dts, den, cfg)
    if not cfg.do_warm_rain_mp:
        st = pcomp(st, cfg)
        st = pwbf(st, dts, den, cfg)
        st = pbigg(st, dts, den, ccn, cfg)
        st = pidep_pisub(st, dts, den, cin, cfg)
        st = psdep_pssub(st, dts, den, denfac, cfg)
        st = pgdep_pgsub(st, dts, den, denfac, cfg)
    return (st["t"], st["qv"], st["ql"], st["qr"], st["qi"], st["qs"],
            st["qg"])
