"""Held-Suarez (1994) idealized forcing, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/physics/held_suarez.py (FV3
driver/solo/hswf.F90 Held_Suarez_Tend:45): Newtonian relaxation of the
temperature toward the HS radiative-equilibrium profile and Rayleigh
boundary-layer friction, in the implicit form (T + r*Teq)/(1 + r); the
optional stratosphere/mesosphere extension (a lapse-rate Teq above 100 hPa,
hswf.F90:152-170) is built up the column level by level.

The wind friction is applied to the D-grid winds with the cell-pair
averaged damping factor.
"""

import numpy as np
import torch

from .. import constants as con
from ..model.thermodynamics import interface_pressure

H = 3
SDAY = 86400.0
T0 = 200.0
TY = 60.0
TZ = 10.0
SIGB = 0.7
H0 = 7.0    # scale height (km) for the strat extension


def hs_forcing(pt, delp, u, v, g, ptop, pdt, strat=False, radius=None):
    """One physics step of HS forcing. pt: TEMPERATURE [6, K, n, n]; u, v
    the D winds; radius: the planet's (m; the Earth's when None), which
    scales the damping times. Returns (pt, u, v)."""
    akap = 2.0 / 7.0
    p0 = 1.0e5
    ap0k = 1.0 / p0 ** akap
    algpk = np.log(ap0k)
    rad_ratio = (radius or con.RADIUS) / 6371.0e3
    kf_day = SDAY * rad_ratio
    rkv = pdt / kf_day
    rka = pdt / (40.0 * kf_day)
    rks = pdt / (4.0 * kf_day)
    rsgb = 1.0 / (1.0 - SIGB)

    lat = g.aglat[..., H:H + g.n, H:H + g.n]           # [6, 1, n, n]
    pe = interface_pressure(delp, ptop)
    peln = torch.log(pe)
    dlog = peln[:, 1:] - peln[:, :-1]
    pl = delp / dlog
    pkz = (torch.exp(akap * peln[:, 1:]) - torch.exp(akap * peln[:, :-1])) / (
        akap * dlog)
    ps = pe[:, -1:]

    sinl2 = torch.sin(lat) ** 2
    cosl2 = torch.cos(lat) ** 2
    cosl4 = cosl2 ** 2

    # troposphere HS equilibrium temperature (hswf.F90:180-184)
    tey = ap0k * (315.0 - TY * sinl2)
    tez = TZ * (ap0k / akap) * cosl2
    teq = torch.clamp((tey - tez * (torch.log(pkz) + algpk)) * pkz, min=T0)

    sigl = pl / ps
    f1 = torch.clamp((sigl - SIGB) * rsgb, min=0.0)
    rkt = rka + (rks - rka) * f1 * cosl4
    pt_new = (pt + rkt * teq) / (1.0 + rkt)

    if strat:
        # stratosphere (1-100 hPa): Teq follows a +2.25 K/km lapse built
        # upward from the lowest level, level by level (hswf.F90:152-170)
        t_ms = 10.0 * rad_ratio
        t_st = 40.0 * rad_ratio
        tau = (t_st - t_ms) / np.log(100.0)
        rms = pdt / (t_ms * SDAY)
        cosl = torch.cos(lat)[:, 0]
        K = pl.shape[1]
        teq_s = [None] * K
        teq_s[K - 1] = teq[:, K - 1]
        t_below, pl_below = teq[:, K - 1], pl[:, K - 1]
        for k in range(K - 2, -1, -1):
            plk = pl[:, k]
            dz = H0 * torch.log(pl_below / plk)
            strat_t = t_below + 2.25 * cosl * dz
            meso_t = t_below - 2.25 * cosl * dz
            t = torch.where(plk <= 1.0e2, meso_t,
                            torch.where(plk <= 100.0e2, strat_t, teq[:, k]))
            teq_s[k] = t
            t_below, pl_below = t, plk
        teq_s = torch.stack(teq_s, dim=1)
        relx = t_ms + tau * torch.log(torch.clamp(0.01 * pl, min=1e-30))
        relx = pdt / (relx * SDAY)
        rk_strat = torch.where(pl <= 1.0e2, torch.full_like(pl, rms),
                               torch.where(pl <= 100.0e2, relx, rkt))
        pt_new = torch.where(pl <= 100.0e2,
                             (pt + rk_strat * teq_s) / (1.0 + rk_strat),
                             pt_new)

    # bottom Rayleigh friction (hswf.F90:188-196), a damping factor a cell
    fac = torch.clamp((sigl - SIGB) * rsgb, min=0.0) * rkv
    damp = 1.0 / (1.0 + fac)
    # spread to the D-wind walls by cell-pair averages
    du = 0.5 * (damp[..., :-1, :] + damp[..., 1:, :])
    damp_u = torch.cat([damp[..., :1, :], du, damp[..., -1:, :]], dim=-2)
    dv = 0.5 * (damp[..., :, :-1] + damp[..., :, 1:])
    damp_v = torch.cat([damp[..., :, :1], dv, damp[..., :, -1:]], dim=-1)
    return pt_new, u * damp_u, v * damp_v
