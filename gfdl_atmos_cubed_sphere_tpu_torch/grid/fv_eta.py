"""Hybrid sigma-pressure vertical coordinate (ak/bk) setup.

Numpy copy of the JAX package's grid/fv_eta.py: FV3 tools/fv_eta.F90
set_eta (SHiELD variant, :285) for the level counts exercised by the idealized tests and operational configs:
table-based L26/L32/L47/L63/L64gfs/L127 (tables in eta_tables.py, from
fv_eta.h) and the var_hi auto-generation (fv_eta.F90:1166) + sm1_edge
smoother (:2313) for other counts (e.g. L79/L91 hi-top).
"""

import numpy as np

from .eta_tables import TABLES
from .. import constants as con


def _var_hi(km, ptop, pint, s_rate):
    """fv_eta.F90 var_hi:1166 — stretched-dz hybrid generation (UKMO blend)."""
    p00 = 1.0e5
    peln1 = np.log(ptop)
    pelnN = np.log(p00)
    t0 = 270.0
    ztop = con.RDGAS / con.GRAV * t0 * (pelnN - peln1)
    k_inc = 15
    s0 = 0.10
    s_fac = np.zeros(km)
    s_inc = (1.0 - s0) / k_inc
    s_fac[km - 1] = s0
    for k in range(km - 2, km - k_inc - 2, -1):
        s_fac[k] = s_fac[k + 1] + s_inc
    s_fac[km - k_inc - 2] = 0.5 * (s_fac[km - k_inc - 1] + s_rate)
    for k in range(km - k_inc - 3, 7, -1):
        s_fac[k] = s_rate * s_fac[k + 1]
    s_fac[7] = 0.5 * (1.1 + s_rate) * s_fac[8]
    s_fac[6] = 1.1 * s_fac[7]
    s_fac[5] = 1.15 * s_fac[6]
    s_fac[4] = 1.2 * s_fac[5]
    s_fac[3] = 1.3 * s_fac[4]
    s_fac[2] = 1.4 * s_fac[3]
    s_fac[1] = 1.45 * s_fac[2]
    s_fac[0] = 1.5 * s_fac[1]

    return _hybrid_from_sfac(km, s_fac, ztop, peln1, pint, t0)


def _var_hi2(km, ptop, pint, s_rate):
    """fv_eta.F90 var_hi2:1342 — the km > 79 stretched-dz generator (used
    for L91/L127-class hi-top sets): shallower surface-layer ramp (10
    levels), then geometric stretching, 7 fixed top factors."""
    p00 = 1.0e5
    peln1 = np.log(ptop)
    t0 = 270.0
    ztop = con.RDGAS / con.GRAV * t0 * (np.log(p00) - peln1)
    s_fac = np.zeros(km)
    ramp = [0.15, 0.20, 0.30, 0.40, 0.50, 0.60, 0.70, 0.80, 0.90, 0.95]
    for n, v in enumerate(ramp):
        s_fac[km - 1 - n] = v
    s_fac[km - 11] = 0.5 * (s_fac[km - 10] + s_rate)
    for k in range(km - 12, 6, -1):
        s_fac[k] = s_rate * s_fac[k + 1]
    s_fac[6] = 0.5 * (1.1 + s_rate) * s_fac[8]
    s_fac[5] = 1.05 * s_fac[6]
    s_fac[4] = 1.1 * s_fac[5]
    s_fac[3] = 1.15 * s_fac[4]
    s_fac[2] = 1.2 * s_fac[3]
    s_fac[1] = 1.3 * s_fac[2]
    s_fac[0] = 1.4 * s_fac[1]
    return _hybrid_from_sfac(km, s_fac, ztop, peln1, pint, t0)


def _hybrid_from_sfac(km, s_fac, ztop, peln1, pint, t0):
    """Shared tail of var_hi/var_hi2: heights from stretch factors,
    sm1_edge smoothing, z->p, ks location, UKMO hybrid blend."""
    p00 = 1.0e5
    dz0 = ztop / s_fac.sum()
    dz = s_fac * dz0
    ze = np.zeros(km + 1)
    for k in range(km - 1, -1, -1):
        ze[k] = ze[k + 1] + dz[k]
    dz = dz * (ztop / ze[0])
    for k in range(km - 1, -1, -1):
        ze[k] = ze[k + 1] + dz[k]

    # sm1_edge smoother (fv_eta.F90:2313), ntimes=1
    df = 0.25
    dzs = ze[1:] - ze[:-1]          # note: Fortran dz(k)=ze(k+1)-ze(k) (<0)
    k1, k2 = 1, km - 2              # 0-based: Fortran k1=2, k2=km-1
    flux = np.zeros(km + 1)
    for k in range(k1 + 1, k2 + 1):
        flux[k] = df * (dzs[k] - dzs[k - 1])
    for k in range(k1, k2 + 1):
        dzs[k] = dzs[k] - flux[k] + flux[k + 1]
    for k in range(km - 1, -1, -1):
        ze[k] = ze[k + 1] - dzs[k]

    dz = ze[:-1] - ze[1:]
    dlnp = con.GRAV * dz / (con.RDGAS * t0)
    peln = np.zeros(km + 1)
    peln[0] = peln1
    for k in range(1, km):
        peln[k] = peln[k - 1] + dlnp[k - 1]
    pe1 = np.exp(peln)
    pe1[km] = p00
    # locate ks
    ks = 0
    for k in range(1, km):
        if pint < pe1[k]:
            ks = k - 1
            break
    pint = pe1[ks + 1]

    # UKMO hybrid blend (fv_eta.F90:1297-1326, NO_UKMO_HB undefined)
    eta = pe1 / pe1[km]
    ep = eta[ks + 1]
    es = eta[km - 1]
    alpha = (ep ** 2 - 2.0 * ep * es) / (es - ep) ** 2
    beta = 2.0 * ep * es ** 2 / (es - ep) ** 2
    gama = -(ep * es) ** 2 / (es - ep) ** 2
    ak = np.zeros(km + 1)
    bk = np.zeros(km + 1)
    ak[:ks + 2] = eta[:ks + 2] * 1.0e5
    for k in range(ks + 2, km):
        ak[k] = (alpha * eta[k] + beta + gama / eta[k]) * 1.0e5
    ak[km] = 0.0
    for k in range(ks + 2, km):
        bk[k] = (pe1[k] - ak[k]) / pe1[km]
    bk[km] = 1.0
    return ak, bk, ks


def set_eta(km, npz_type=""):
    """Returns (ks, ptop, ak[km+1], bk[km+1]) float64."""
    table_ks = {26: 7, 32: 7, 47: 10, 63: 9, 127: 31}
    key = f"a{km}"
    if key in TABLES and npz_type in ("", "default"):
        ak = np.asarray(TABLES[f"a{km}"], np.float64)
        bk = np.asarray(TABLES[f"b{km}"], np.float64)
        # ks = number of pure-pressure layers = last interface with bk == 0
        ks = int(np.max(np.nonzero(bk == 0.0)[0]))
        return ks, float(ak[0]), ak, bk
    if km in (5, 10):
        ptop = 500.0e2
        bk = np.arange(km + 1) / km
        ak = ptop * (1.0 - bk)
        return 0, ptop, ak, bk
    # auto generation (low/mid/hi-top selections, fv_eta.F90:445-520)
    if km in (31, 32, 39, 41, 47, 51):
        ptop, pint, fac = 100.0, 100.0e2, 1.035
    elif km == 55:
        ptop, pint, fac = 10.0, 100.0e2, 1.035
    elif km in (63, 71, 79, 91, 127):
        ptop, pint, fac = 1.0, 100.0e2, 1.03
        if km == 63:
            fac = 1.035           # fv_eta.F90:218 (c360/c384 set)
    elif km == 30:
        ptop, pint, fac = 2.26e2, 250.0e2, 1.03
    elif km == 60:
        ptop, pint, fac = 3.0e2, 300.0e2, 1.03
    else:
        ptop, pint, fac = 1.0, 100.0e2, 1.03
    # km > 79 uses the var_hi2 generator (fv_eta.F90:243-246)
    gen = _var_hi2 if km > 79 else _var_hi
    ak, bk, ks = gen(km, ptop, pint, fac)
    return ks, float(ak[0]), ak, bk


def get_eta_level(km, p_s, ak, bk):
    """Mid-layer pressures (fv_eta.F90 get_eta_level:1923)."""
    pe = ak + bk * p_s
    return 0.5 * (pe[:-1] + pe[1:])
