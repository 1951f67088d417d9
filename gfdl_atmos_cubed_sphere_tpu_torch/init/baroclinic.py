"""Jablonowski & Williamson baroclinic-wave initialization (cases 12/13).

Numpy copy of the JAX package's init/baroclinic.py: host-side f64
transcription of FV3 tools/test_cases.F90:1575-1900:
ps = 1e5, delp from ak/bk; D winds by 3-point Simpson average of the zonal
jet projected on the edge unit vectors ee1/ee2 (endpoints) and es/ew
(midpoints), with the case-13 Gaussian perturbation; temperature and surface
geopotential from the JW mean-T formula with 9-point cell averaging.
"""

import numpy as np

from .. import constants as con
from ..grid.gnomonic import xyz_to_lonlat, normalize, great_circle_angle

H = 3
ETA_0 = 0.252
ETA_S = 1.0
ETA_T = 0.2
T_0 = 288.0
DELTA_T = 480000.0
LAPSE = 0.005
UBAR = 35.0


def _t_pert_coef(lat):
    A = (-2.0 * np.sin(lat) ** 6 * (np.cos(lat) ** 2 + 1.0 / 3.0) + 10.0 / 63.0)
    B = (1.6 * np.cos(lat) ** 3 * (np.sin(lat) ** 2 + 2.0 / 3.0) - np.pi / 4.0)
    return A, B


def _jet_parts(lat, lon=None, pert=False, radius=None, r0=None):
    """The level-independent parts of the jet: sin^2(2 lat) and the
    case-13 Gaussian bump (0 without pert)."""
    bump = 0.0
    if pert:
        pc = np.stack([np.cos(2.0 * np.pi / 9.0) * np.cos(np.pi / 9.0),
                       np.cos(2.0 * np.pi / 9.0) * np.sin(np.pi / 9.0),
                       np.sin(2.0 * np.pi / 9.0)])
        p = np.stack([np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
                      np.sin(lat)], axis=-1)
        r = great_circle_angle(p, pc) * radius
        arg = -(r / r0) ** 2
        bump = np.where(arg > -40.0, np.exp(np.maximum(arg, -40.0)), 0.0)
    return np.sin(2.0 * lat) ** 2, bump


def _u_jet(lat, eta_v, lon=None, pert=False, radius=None, r0=None):
    base, bump = _jet_parts(lat, lon, pert, radius, r0)
    u = UBAR * np.cos(eta_v) ** 1.5 * base
    return u + bump if pert else u


def jw_baroclinic(geom, npz, ak, bk, ptop, perturb=True, moist=False):
    """Returns dict of interior fields [6, npz, ...]: delp, pt (temperature),
    u, v, phis [6,1,n,n], ps, optional sphum."""
    n = geom.n
    R = geom.radius
    omg = geom.omega
    r0 = R / 10.0
    ak = np.asarray(ak)
    bk = np.asarray(bk)

    eta = 0.5 * ((ak[:-1] + ak[1:]) / 1.0e5 + bk[:-1] + bk[1:])     # [npz]
    eta_v = (eta - ETA_0) * np.pi * 0.5

    gxyz = geom.arrays["grid_xyz"]         # padded corners [6, NW, NW, 3]
    ai = geom.interior

    def proj(pts, evec, etav):
        """Project the jet at xyz points `pts` onto unit vectors evec; returns
        [npz, ...]."""
        lon, lat = xyz_to_lonlat(pts)
        elon = np.stack([-np.sin(lon), np.cos(lon), np.zeros_like(lon)], -1)
        dot = np.sum(evec * elon, -1)
        base, bump = _jet_parts(lat, lon=lon, pert=perturb, radius=R, r0=r0)
        out = []
        for ev in etav:
            u = UBAR * np.cos(ev) ** 1.5 * base
            if perturb:
                u = u + bump
            out.append(u * dot)
        return np.stack(out)

    # --- D winds, interior ------------------------------------------------
    h = H
    # u at y-walls: corner endpoints (j,i),(j,i+1), wall-mid with es(...,1)
    cw = gxyz[:, h:h + n + 1, h:h + n + 1]          # interior corners [n+1, n+1]
    ee1 = geom.arrays["ee1"][:, h:h + n + 1, h:h + n + 1]
    ee2 = geom.arrays["ee2"][:, h:h + n + 1, h:h + n + 1]
    es1 = geom.arrays["es"][:, h:h + n + 1, h:h + n, 0]   # y-wall dir-1 vector
    ew2 = geom.arrays["ew"][:, h:h + n, h:h + n + 1, 1]   # x-wall dir-2 vector

    uu1 = proj(cw[:, :, :-1], ee1[:, :, :-1], eta_v)       # corner (j,i)
    uu3 = proj(cw[:, :, 1:], ee1[:, :, 1:], eta_v)         # corner (j,i+1)
    midu = normalize(cw[:, :, :-1] + cw[:, :, 1:])
    uu2 = proj(midu, es1, eta_v)
    u = 0.25 * (uu1 + 2.0 * uu2 + uu3)                     # [npz, 6, n+1, n]
    u = np.moveaxis(u, 0, 1)

    vv1 = proj(cw[:, 1:, :], ee2[:, 1:, :], eta_v)         # corner (j+1,i)
    vv3 = proj(cw[:, :-1, :], ee2[:, :-1, :], eta_v)
    midv = normalize(cw[:, :-1, :] + cw[:, 1:, :])
    vv2 = proj(midv, ew2, eta_v)
    v = 0.25 * (vv1 + 2.0 * vv2 + vv3)
    v = np.moveaxis(v, 0, 1)

    # --- delp -------------------------------------------------------------
    ps0 = 1.0e5
    delp1 = (ak[1:] - ak[:-1]) + ps0 * (bk[1:] - bk[:-1])
    delp = np.broadcast_to(delp1[None, :, None, None],
                           (6, npz, n, n)).copy()

    # --- temperature: T_mean(eta) + 9-point averaged perturbation ---------
    def t_pert_at(coef, ev, et):
        A, B = coef
        return (0.75 * (et * np.pi * UBAR / con.RDGAS) * np.sin(ev)
                * np.sqrt(np.cos(ev))
                * (A * 2.0 * UBAR * np.cos(ev) ** 1.5 + B * R * omg))

    aglat = ai("aglat")                    # [6, n, n]
    _, clat = xyz_to_lonlat(cw)
    _, mxlat = xyz_to_lonlat(normalize(cw[:, :-1, :] + cw[:, 1:, :]))   # x-wall mids [n, n+1]
    _, mylat = xyz_to_lonlat(normalize(cw[:, :, :-1] + cw[:, :, 1:]))   # y-wall mids [n+1, n]

    pt = np.empty((6, npz, n, n))
    # the latitude coefficients of the 9 points, the same at every level
    coefs = [_t_pert_coef(x) for x in (
        aglat, mylat[:, :-1, :], mylat[:, 1:, :], mxlat[:, :, :-1],
        mxlat[:, :, 1:], clat[:, :-1, :-1], clat[:, :-1, 1:],
        clat[:, 1:, 1:], clat[:, 1:, :-1])]
    for kk in range(npz):
        ev, et = eta_v[kk], eta[kk]
        t_mean = T_0 * et ** (con.RDGAS * LAPSE / con.GRAV)
        if ETA_T > et:
            t_mean = t_mean + DELTA_T * (ETA_T - et) ** 5
        # the centre, S, N, W and E edge mids, then the corners
        p1, p2, p4, p5, p3, p6, p7, p8, p9 = (t_pert_at(c, ev, et)
                                              for c in coefs)
        pt[:, kk] = (t_mean + 0.25 * p1 + 0.125 * (p2 + p3 + p4 + p5)
                     + 0.0625 * (p6 + p7 + p8 + p9))

    # --- surface geopotential (test_cases.F90:1795-1860) -------------------
    evs = (ETA_S - ETA_0) * np.pi * 0.5

    def phi_at(lat):
        A, B = _t_pert_coef(lat)
        return (UBAR * np.cos(evs) ** 1.5
                * (A * UBAR * np.cos(evs) ** 1.5 + B * R * omg))

    phis = (0.25 * phi_at(aglat)
            + 0.125 * (phi_at(mylat[:, :-1, :]) + phi_at(mxlat[:, :, 1:])
                       + phi_at(mylat[:, 1:, :]) + phi_at(mxlat[:, :, :-1]))
            + 0.0625 * (phi_at(clat[:, :-1, :-1]) + phi_at(clat[:, :-1, 1:])
                        + phi_at(clat[:, 1:, 1:]) + phi_at(clat[:, 1:, :-1])))

    out = dict(delp=delp, pt=pt, u=u, v=v, phis=phis[:, None],
               ps=np.full((6, 1, n, n), ps0))
    # nonhydrostatic state: w = 0, delz from hydrostatic balance
    # (fv_restart-style init: delz = -R*Tv/g * dlnp)
    pe = ptop + np.concatenate(
        [np.zeros_like(delp[:, :1]), np.cumsum(delp, axis=1)], axis=1)
    dlnp = np.log(pe[:, 1:]) - np.log(pe[:, :-1])
    out["delz"] = -con.RDGAS * pt / con.GRAV * dlnp
    out["w"] = np.zeros_like(delp)
    if moist:
        # test_cases.F90:1627-1642 moisture profile (layer-mean p via delp/dlnp)
        pek = ak + bk * ps0
        pmid = (pek[1:] - pek[:-1]) / np.log(pek[1:] / pek[:-1])
        ptmp = (pmid[None, :, None, None] - 100000.0) / 34000.0
        lat4 = (aglat[:, None] / (2.0 * np.pi / 9.0)) ** 4
        out["sphum"] = np.broadcast_to(
            0.021 * np.exp(-lat4) * np.exp(-ptmp ** 2), (6, npz, n, n)).copy()
    return out
