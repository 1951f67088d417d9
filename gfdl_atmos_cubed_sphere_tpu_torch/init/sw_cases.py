"""Williamson shallow-water test-case initializations (cases 1, 2, 5, 6).

Host-side f64 transcriptions of FV3 tools/test_cases.F90
(init_case SW select at :784; case 1 cosine bell :923, case 2 balanced zonal
flow :943, case 5 mountain flow :1120, case 6 Rossby-Haurwitz :1160) and
init_winds (:211; defOnGrid 1 = C-grid streamfunction winds, 5 = D-grid
edge-projected analytic winds).

In SW mode delp carries the geopotential g*h (the reference stores it in the
delp slot), pt == 1. Returned fields are compute-domain arrays [6, 1, ...]
except case 1's uc/vc which are returned PADDED (they are analytic constants
consumed directly by d_sw's advection branch).
"""

import numpy as np

from .. import constants as con
from ..grid.gnomonic import xyz_to_lonlat, normalize, great_circle_angle

H = 3
DAY = 86400.0


def _unit_vect_latlon(lon, lat):
    sl, cl = np.sin(lon), np.cos(lon)
    st, ct = np.sin(lat), np.cos(lat)
    elon = np.stack([-sl, cl, np.zeros_like(sl)], axis=-1)
    elat = np.stack([-st * cl, -st * sl, ct], axis=-1)
    return elon, elat


def _unit_vect2(p1, p2):
    """Unit vector at the p1-p2 midpoint pointing p1 -> p2 (great circle)."""
    pm = normalize(p1 + p2)
    p3 = np.cross(p2, p1)
    return normalize(np.cross(pm, p3))


def _project_dgrid(fn, geom):
    """Project an analytic lat-lon wind field onto D-grid walls
    (test_cases.F90:464-495, defOnGrid==5). fn(lon, lat) -> (u_ll, v_ll).
    Returns padded (u [6,NW,NC], v [6,NC,NW]) float64."""
    gxyz = geom.arrays["grid_xyz"]

    def comp(p1, p2):
        mid = normalize(p1 + p2)
        e = _unit_vect2(p1, p2)
        lon, lat = xyz_to_lonlat(mid)
        ex, ey = _unit_vect_latlon(lon, lat)
        ul, vl = fn(lon, lat)
        return ul * np.sum(e * ex, -1) + vl * np.sum(e * ey, -1)

    u = comp(gxyz[:, :, :-1], gxyz[:, :, 1:])        # y-walls
    v = comp(gxyz[:, :-1, :], gxyz[:, 1:, :])        # x-walls
    return np.nan_to_num(u), np.nan_to_num(v)


def _interior(a, geom, kind):
    n, h = geom.n, H
    if kind == "cell":
        return a[:, h:h + n, h:h + n]
    if kind == "u":
        return a[:, h:h + n + 1, h:h + n]
    if kind == "v":
        return a[:, h:h + n, h:h + n + 1]
    raise ValueError(kind)


def _k1(a):
    return np.asarray(a)[:, None]


def solid_body(ubar, alpha=0.0):
    def fn(lon, lat):
        u = ubar * (np.cos(lat) * np.cos(alpha)
                    + np.sin(lat) * np.cos(lon) * np.sin(alpha))
        v = -ubar * np.sin(lon) * np.sin(alpha)
        return u, v
    return fn


def case1(geom, alpha=0.0):
    """Cosine-bell advection (test_cases.F90:923-942). Returns dict with
    delp [6,1,n,n], padded uc/vc, phi0 (the initial bell, for error norms)."""
    R = geom.radius
    ubar = 2.0 * np.pi * R / (12.0 * DAY)
    gh0 = 1.0
    r0 = R / 3.0
    lam = geom.arrays["aglon"]
    th = geom.arrays["aglat"]
    # great-circle distance from (pi/2, 0)
    p1 = np.stack([np.cos(0.0) * np.cos(np.pi / 2.0),
                   np.cos(0.0) * np.sin(np.pi / 2.0), np.sin(0.0)])
    pa = np.stack([np.cos(th) * np.cos(lam), np.cos(th) * np.sin(lam),
                   np.sin(th)], axis=-1)
    r = great_circle_angle(pa, p1) * R
    delp = np.where(r < r0, gh0 * 0.5 * (1.0 + np.cos(np.pi * r / r0)), 0.0)
    delp = np.nan_to_num(delp)

    # C-grid streamfunction winds (init_winds defOnGrid==1, :385-403)
    lon = geom.arrays["lon"]
    lat = geom.arrays["lat"]
    psi_b = -ubar * R * (np.sin(lat) * np.cos(alpha)
                         - np.cos(lon) * np.cos(lat) * np.sin(alpha))
    with np.errstate(all="ignore"):
        vc = (psi_b[:, :, 1:] - psi_b[:, :, :-1]) / geom.arrays["dx"]
        uc = -(psi_b[:, 1:, :] - psi_b[:, :-1, :]) / geom.arrays["dy"]
    uc = np.nan_to_num(uc)
    vc = np.nan_to_num(vc)
    return dict(delp=_k1(_interior(delp, geom, "cell")),
                uc=_k1(uc), vc=_k1(vc),
                phi0=_k1(_interior(delp, geom, "cell")))


def case2(geom, alpha=0.0):
    """Geostrophically balanced zonal flow (test_cases.F90:943-992)."""
    R, omega = geom.radius, geom.omega
    ubar = 2.0 * np.pi * R / (12.0 * DAY)
    gh0 = 2.94e4
    lam = geom.arrays["aglon"]
    th = geom.arrays["aglat"]
    delp = gh0 - (R * omega * ubar + 0.5 * ubar ** 2) * (
        -np.cos(lam) * np.cos(th) * np.sin(alpha)
        + np.sin(th) * np.cos(alpha)) ** 2
    u, v = _project_dgrid(solid_body(ubar, alpha), geom)
    phis = np.zeros_like(delp)
    return dict(delp=_k1(_interior(np.nan_to_num(delp), geom, "cell")),
                u=_k1(_interior(u, geom, "u")),
                v=_k1(_interior(v, geom, "v")),
                phis=_k1(_interior(phis, geom, "cell")))


def case5(geom):
    """Zonal flow over an isolated mountain (test_cases.F90:1120-1158)."""
    R, omega = geom.radius, geom.omega
    ubar = 20.0
    gh0 = 5960.0 * con.GRAV
    r0 = np.pi / 9.0
    lam = geom.arrays["aglon"]
    th = geom.arrays["aglat"]
    r = np.sqrt(np.minimum(r0 ** 2, (lam - 0.5 * np.pi) ** 2
                           + (th - np.pi / 6.0) ** 2))
    phis = 2000.0 * con.GRAV * (1.0 - r / r0)
    delp = gh0 - (R * omega * ubar + 0.5 * ubar ** 2) * np.sin(th) ** 2 - phis
    u, v = _project_dgrid(solid_body(ubar), geom)
    return dict(delp=_k1(_interior(np.nan_to_num(delp), geom, "cell")),
                u=_k1(_interior(u, geom, "u")),
                v=_k1(_interior(v, geom, "v")),
                phis=_k1(_interior(np.nan_to_num(phis), geom, "cell")))


def case6(geom):
    """Rossby-Haurwitz wavenumber-4 (test_cases.F90:1160-1212)."""
    R_, omega = geom.radius, geom.omega
    gh0 = 8.0e3 * con.GRAV
    Rw = 4.0
    omg = 7.848e-6
    rk = 7.848e-6
    lam = geom.arrays["aglon"]
    th = geom.arrays["aglat"]
    c = np.cos(th)
    A = (0.5 * omg * (2.0 * omega + omg) * c ** 2
         + 0.25 * rk * rk * c ** (2.0 * Rw) * (
             (Rw + 1.0) * c ** 2 + (2.0 * Rw * Rw - Rw - 2.0)
             - 2.0 * Rw * Rw * c ** (-2.0)))
    B = (2.0 * (omega + omg) * rk / ((Rw + 1.0) * (Rw + 2.0)) * c ** Rw
         * ((Rw * Rw + 2.0 * Rw + 2.0) - ((Rw + 1.0) * c) ** 2))
    Cc = 0.25 * rk * rk * c ** (2.0 * Rw) * ((Rw + 1.0) * c ** 2 - (Rw + 2.0))
    delp = gh0 + R_ ** 2 * (A + B * np.cos(Rw * lam) + Cc * np.cos(2.0 * Rw * lam))

    def fn(lon, lat):
        cl = np.cos(lat)
        u = (R_ * omg * cl + R_ * rk * cl ** (Rw - 1.0)
             * (Rw * np.sin(lat) ** 2 - cl ** 2) * np.cos(Rw * lon))
        v = -R_ * rk * Rw * np.sin(lat) * np.sin(Rw * lon) * cl ** (Rw - 1.0)
        return u, v

    u, v = _project_dgrid(fn, geom)
    phis = np.zeros_like(delp)
    return dict(delp=_k1(_interior(np.nan_to_num(delp), geom, "cell")),
                u=_k1(_interior(u, geom, "u")),
                v=_k1(_interior(v, geom, "v")),
                phis=_k1(_interior(phis, geom, "cell")))


def _u_jet(lat):
    """Galewsky et al. (2004) barotropically unstable jet
    (test_cases.F90 u_jet:4073)."""
    umax = 80.0
    ph0 = np.pi / 7.0
    ph1 = np.pi / 2.0 - ph0
    en = np.exp(-4.0 / (ph1 - ph0) ** 2)
    lat = np.asarray(lat)
    inside = (lat > ph0) & (lat < ph1)
    safe = np.where(inside, (lat - ph0) * (lat - ph1), -1.0)
    return np.where(inside, (umax / en) * np.exp(1.0 / safe), 0.0)


def _gh_jet_table(jm):
    """Balanced geopotential by meridional integration of the gradient-wind
    relation (test_cases.F90 gh_jet:4025)."""
    h0 = 10.157946867e3
    dp = np.pi / (jm - 1)
    lats = -np.pi / 2.0 + np.arange(jm) * dp
    gh = np.empty(jm)
    gh[0] = con.GRAV * h0
    mid = -np.pi / 2.0 + (np.arange(1, jm) - 0.5) * dp
    uu = _u_jet(mid)
    ft = 2.0 * con.OMEGA * np.sin(mid)
    incr = -uu * (con.RADIUS * ft + np.tan(mid) * uu) * dp
    gh[1:] = gh[0] + np.cumsum(incr)
    return lats, gh


def case7(geom):
    """Barotropically unstable jet with height perturbation
    (test_cases.F90 case(7):1213): gh from the balanced jet integral
    (9-point cell average), Gaussian bump at (pi/2, pi/4), D winds from
    u_jet; tracer = initial shallow-water PV."""
    n = geom.n
    lats, ght = _gh_jet_table(4 * (n + 1))

    def gh_at(lat):
        return np.interp(np.asarray(lat), lats, ght)

    gxyz = geom.arrays["grid_xyz"]
    lat_c = geom.interior("aglat")
    lon_c = geom.interior("aglon")
    h, m = H, n + 1

    def corner_lat(dj, di):
        return xyz_to_lonlat(gxyz[:, h + dj:h + dj + n, h + di:h + di + n])[1]

    def midlat(p1, p2):
        return xyz_to_lonlat(normalize(p1 + p2))[1]

    c = gxyz[:, h:h + m, h:h + m]
    lat_s = midlat(c[:, :-1, :-1], c[:, :-1, 1:])       # south wall mid
    lat_n = midlat(c[:, 1:, :-1], c[:, 1:, 1:])
    lat_w = midlat(c[:, :-1, :-1], c[:, 1:, :-1])
    lat_e = midlat(c[:, :-1, 1:], c[:, 1:, 1:])
    gh = (0.25 * gh_at(lat_c)
          + 0.125 * (gh_at(lat_s) + gh_at(lat_n)
                     + gh_at(lat_w) + gh_at(lat_e))
          + 0.0625 * (gh_at(corner_lat(0, 0)) + gh_at(corner_lat(0, 1))
                      + gh_at(corner_lat(1, 0)) + gh_at(corner_lat(1, 1))))

    # Gaussian perturbation at (lon, lat) = (pi/2, pi/4)
    r0 = con.RADIUS / 12.0
    cosd = (np.sin(np.pi / 4) * np.sin(lat_c)
            + np.cos(np.pi / 4) * np.cos(lat_c) * np.cos(lon_c - np.pi / 2))
    r = np.arccos(np.clip(cosd, -1, 1)) * con.RADIUS
    gh = gh + np.where(r < 3.0 * r0,
                       1000.0 * con.GRAV * np.exp(-(r / r0) ** 2), 0.0)

    u, v = _project_dgrid(lambda lon, lat: (_u_jet(lat), 0.0 * lon), geom)
    return dict(delp=_k1(gh), u=_k1(_interior(u, geom, "u")),
                v=_k1(_interior(v, geom, "v")),
                phis=_k1(np.zeros_like(gh)))


def case0(geom):
    """Deformational vortex flow (test_cases.F90 case(0):889-916): an
    azimuthal vortex centered on the (lon0=0, lat0=pi/2) pole advects a
    tanh filament in the height field. Constants p0_c0=3, rgamma=5
    (test_cases.F90:142-145). Returns delp + D winds + padded uc/vc (the
    winds are steady; usable as a pure-advection test like case 1)."""
    lat0, lon0 = np.pi / 2.0, 0.0
    p0_c0, rgamma = 3.0, 5.0
    R = geom.radius
    lam = geom.arrays["aglon"]
    th = geom.arrays["aglat"]

    def vort_w(lat):
        p = p0_c0 * np.cos(lat)
        vtx = (3.0 * np.sqrt(2.0) / 2.0) / np.cosh(p) ** 2 * np.tanh(p)
        return np.where(p != 0.0, vtx / np.where(p == 0, 1.0, p), 0.0)

    p = p0_c0 * np.cos(th)
    w_p = vort_w(th)
    delp = 1.0 - np.tanh(p / rgamma * np.sin(lam))

    def fn(lon, lat):
        wp = vort_w(lat)
        u = wp * (np.sin(lat0) * np.cos(lat)
                  + np.cos(lat0) * np.cos(lon - lon0) * np.sin(lat))
        v = wp * np.cos(lat0) * np.sin(lon - lon0)
        return u * R / DAY, v * R / DAY

    u, v = _project_dgrid(fn, geom)

    # C-grid winds from the streamfunction (init_winds defOnGrid==1): the
    # lat0=pi/2 vortex is purely zonal with angular rate w_p(lat)/86400, so
    # psi(lat) = -(R^2/86400) * int w_p(t) cos t dt, tabulated numerically.
    tt = np.linspace(-np.pi / 2.0, np.pi / 2.0, 4001)
    integrand = vort_w(tt) * np.cos(tt)
    psi_t = np.concatenate([[0.0], np.cumsum(
        0.5 * (integrand[1:] + integrand[:-1]) * np.diff(tt))])
    psi_t = -(R ** 2 / DAY) * psi_t
    psi_b = np.interp(geom.arrays["lat"], tt, psi_t)
    with np.errstate(all="ignore"):
        vc = (psi_b[:, :, 1:] - psi_b[:, :, :-1]) / geom.arrays["dx"]
        uc = -(psi_b[:, 1:, :] - psi_b[:, :-1, :]) / geom.arrays["dy"]
    uc = np.nan_to_num(uc)
    vc = np.nan_to_num(vc)
    return dict(delp=_k1(_interior(np.nan_to_num(delp), geom, "cell")),
                u=_k1(_interior(np.nan_to_num(u), geom, "u")),
                v=_k1(_interior(np.nan_to_num(v), geom, "v")),
                uc=_k1(np.nan_to_num(uc)), vc=_k1(np.nan_to_num(vc)),
                phi0=_k1(_interior(np.nan_to_num(delp), geom, "cell")))


def case3(geom, no_wind=False):
    """Non-rotating potential flow past a cosine bell (test_cases.F90
    case(3):993-1067): gh bell at (1.5*pi, 0) + g*2000 offset, u = 40*cos(lat),
    and Coriolis CANCELLED by an anti-rotation (anti_rot = -ubar/radius).
    Build the grid ops with omega = -40/geom.radius to reproduce the
    reference's modified fC/f0 (or omega=0 with no_wind)."""
    ubar = 0.0 if no_wind else 40.0
    gh0 = 1.0e3 * con.GRAV
    R = geom.radius
    lam = geom.arrays["aglon"]
    th = geom.arrays["aglat"]
    p1 = np.stack([np.cos(0.0) * np.cos(1.5 * np.pi),
                   np.cos(0.0) * np.sin(1.5 * np.pi), np.sin(0.0)])
    pa = np.stack([np.cos(th) * np.cos(lam), np.cos(th) * np.sin(lam),
                   np.sin(th)], axis=-1)
    r = great_circle_angle(pa, p1) * R
    r0 = R / 3.0
    delp = np.where(r < r0, gh0 * 0.5 * (1.0 + np.cos(np.pi * r / r0)), 0.0)
    delp = delp + con.GRAV * 2.0e3
    u, v = _project_dgrid(solid_body(ubar), geom)
    return dict(delp=_k1(_interior(np.nan_to_num(delp), geom, "cell")),
                u=_k1(_interior(np.nan_to_num(u), geom, "u")),
                v=_k1(_interior(np.nan_to_num(v), geom, "v")),
                phis=_k1(np.zeros((geom.topology.ntiles, geom.n, geom.n))),
                omega_override=(-ubar / R))


def _rankine_dgrid(geom, ubar, r0, center):
    """D-grid winds of one Rankine vortex at center=(lon, lat)
    (test_cases.F90 rankine_vortex:3934): solid-body inside r0, 1/r outside,
    azimuthal winds computed in the vortex-centered frame."""
    lon1, lat1 = center
    R = geom.radius

    def fn(lon, lat):
        lonp = lon - lon1
        cosp = (np.sin(lat) * np.sin(lat1)
                + np.cos(lat) * np.cos(lat1) * np.cos(lonp))
        r = R * np.arccos(np.clip(cosp, -1.0, 1.0))
        vr = np.where(r < r0, ubar * r / r0,
                      ubar * r0 / np.maximum(r, 1.0))
        x1 = np.cos(lat) * np.sin(lonp)
        y1 = np.sin(lat) * np.cos(lat1) - np.cos(lat) * np.sin(lat1) * np.cos(lonp)
        d2 = np.maximum(1.0e-25, np.sqrt(x1 ** 2 + y1 ** 2))
        return -vr * y1 / d2, vr * x1 / d2

    return _project_dgrid(fn, geom)


def case4(geom):
    """Merging tropical-cyclone pair (test_cases.F90 case(4):1068-1119):
    two Rankine vortices 10N at 1.5*pi -/+ 1.8*r0/a, plus the anti-podal
    mirror pair with reversed sign; flat gh0 = g*1000 height."""
    ubar, r0 = 50.0, 250.0e3
    R = geom.radius
    ddeg = 1.80 * r0 / R
    gh0 = con.GRAV * 1.0e3
    n = geom.n
    delp = np.full((geom.topology.ntiles, n, n), gh0)

    centers = [(np.pi * 1.5 - ddeg, np.pi / 18.0, ubar),
               (np.pi * 1.5 + ddeg, np.pi / 18.0, ubar)]
    # anti-podal points with reversed rotation
    for lon, lat, ub in list(centers):
        centers.append((lon - np.pi, -lat, -ub))

    u = v = None
    for lon, lat, ub in centers:
        du, dv = _rankine_dgrid(geom, ub, r0, (lon % (2 * np.pi), lat))
        u = du if u is None else u + du
        v = dv if v is None else v + dv
    return dict(delp=_k1(delp),
                u=_k1(_interior(u, geom, "u")),
                v=_k1(_interior(v, geom, "v")),
                phis=_k1(np.zeros_like(delp)))


def case8(geom, nsolitons=2, umax=50.0, size=750.0e3):
    """Soliton twin-vortex (test_cases.F90 case(8):1306-1385): Gaussian
    westerly wind burst at (pi/2, 0) [minus an easterly burst at the
    antipode for nsolitons > 1], flat gh0 = g*5000, NON-ROTATING planet
    (build grid ops with omega=0)."""
    gh0 = 5.0e3 * con.GRAV
    R = geom.radius
    n = geom.n
    delp = np.full((geom.topology.ntiles, n, n), gh0)

    def burst(center_lon, sign):
        p0 = np.stack([np.cos(0.0) * np.cos(center_lon),
                       np.cos(0.0) * np.sin(center_lon), np.sin(0.0)])

        def fn(lon, lat):
            pa = np.stack([np.cos(lat) * np.cos(lon),
                           np.cos(lat) * np.sin(lon), np.sin(lat)], axis=-1)
            r = great_circle_angle(pa, p0) * R
            return sign * umax * np.exp(-(r / size) ** 2), 0.0 * lon

        return _project_dgrid(fn, geom)

    u, v = burst(np.pi * 0.5, 1.0)
    if nsolitons > 1:
        du, dv = burst(np.pi * 1.5, -1.0)
        u, v = u + du, v + dv
    return dict(delp=_k1(delp),
                u=_k1(_interior(u, geom, "u")),
                v=_k1(_interior(v, geom, "v")),
                phis=_k1(np.zeros_like(delp)),
                omega_override=0.0)


def case9(geom):
    """Stratospheric polar vortex (test_cases.F90 case(9):1386-1462): a
    piecewise-linear zonal wind profile (in degrees latitude) balanced by
    meridional integration of the gradient-wind relation on a jm=5761
    latitude table; forced later by case9_forcing (the surface-height
    anomaly cycle)."""
    jm = 5761
    jm1 = jm - 1
    dp = np.pi / jm1
    ll_j = -0.5 * np.pi + np.arange(jm) * dp
    ph5 = -0.5 * np.pi + (np.arange(2, jm + 1) - 1.5) * dp   # sine(2..jm)
    sine = np.sin(ph5)                                        # [jm-1]
    cosp = np.empty(jm)
    cosp[0] = 0.0
    cosp[jm - 1] = 0.0
    cosp[1:jm1] = (sine[1:] - sine[:-1]) / dp
    cose = np.empty(jm)
    cose[1:] = 0.5 * (cosp[:-1] + cosp[1:])
    cose[0] = cose[1]

    deg = -90.0 + (np.arange(2, jm + 1) - 1.5) * (180.0 / jm1)

    def u_profile(degl):
        return np.where(degl <= 0.0, -10.0 * (degl + 90.0) / 90.0,
                        np.where(degl <= 60.0, -10.0 + degl,
                                 50.0 - (50.0 / 30.0) * (degl - 60.0)))

    ll_u = u_profile(deg)                                     # rows 2..jm
    ll_phi = np.empty(jm)
    ll_phi[0] = 6000.0 * con.GRAV
    incr = -dp * sine[:jm1 - 1] * (
        geom.radius * 2.0 * geom.omega + ll_u[:jm1 - 1] / cose[1:jm1]
    ) * ll_u[:jm1 - 1]
    ll_phi[1:jm1] = ll_phi[0] + np.cumsum(incr)
    ll_phi[jm - 1] = ll_phi[jm - 2]

    lat_c = geom.interior("aglat")
    # bin lookup: delp = mean of the bracketing table rows
    jj = np.clip(((lat_c + 0.5 * np.pi) / dp).astype(int), 0, jm - 2)
    delp = 0.5 * (ll_phi[jj] + ll_phi[jj + 1])

    u, v = _project_dgrid(
        lambda lon, lat: (u_profile(np.rad2deg(lat)), 0.0 * lon), geom)
    return dict(delp=_k1(delp),
                u=_k1(_interior(u, geom, "u")),
                v=_k1(_interior(v, geom, "v")),
                phis=_k1(np.zeros_like(delp)))
