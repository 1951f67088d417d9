"""Derived diagnostic fields, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/io/derived.py (the fv_diag
quantities of FV3 tools/fv_diagnostics.F90): relative, absolute and
potential vorticity, sea-level pressure, interpolation to pressure
levels, heights and isentropes (the cs3_interpolator role), wind speed,
surface-based CAPE/CIN by a pseudoadiabatic parcel ascent, reflectivity
and the severe-weather set.

The interpolations find each target's bracketing layers by counting the
layers on one side of it (the JAX package's index, which does not assume
a monotone column) and read the two layers with torch.gather, where the
JAX package sums a one-hot over K: the same values with K times less
memory. The weights of a set of targets depend on the column alone, so
fv_diag builds them once (pressure_weights) and applies them to every
field (apply_weights). CAPE's parcel ascent is a loop over the K - 1
levels above the lowest, bottom up, as the JAX package's scan.
"""

import torch
import torch.nn.functional as F

from .. import constants as con
from ..model.thermodynamics import interface_pressure
from ..physics import gfdl_mp as mp

H = 3


def relative_vorticity(u, v, g):
    """Cell-mean relative vorticity from D winds (the d_sw `wk` circulation
    form, sw_core.F90:1358-1372). u [6,K,n+1,n], v [6,K,n,n+1]."""
    n = u.shape[-1]
    ctr = slice(H, H + n)
    wslr = slice(H, H + n + 1)
    vt = u * g.dx[..., wslr, ctr]
    ut = v * g.dy[..., ctr, wslr]
    rarea = g.rarea[..., ctr, ctr]
    return rarea * (vt[..., :-1, :] - vt[..., 1:, :]
                    - ut[..., :, :-1] + ut[..., :, 1:])


def absolute_vorticity(u, v, g):
    n = u.shape[-1]
    f0 = g.f0[..., H:H + n, H:H + n]
    return relative_vorticity(u, v, g) + f0


def potential_vorticity(u, v, pt, delp, g, ptop=100.0):
    """Ertel PV on model layers: -g (f + zeta) dtheta/dp (fv_diagnostics
    pv_entropy form, vertical term). pt: temperature."""
    pe = interface_pressure(delp, ptop)
    pk = pe ** con.KAPPA
    theta = pt * (1.0e5 ** con.KAPPA) / (0.5 * (pk[:, 1:] + pk[:, :-1]))
    dtheta = torch.cat([theta[:, 1:2] - theta[:, 0:1],
                        0.5 * (theta[:, 2:] - theta[:, :-2]),
                        theta[:, -1:] - theta[:, -2:-1]], dim=1)
    va = absolute_vorticity(u, v, g)
    return -con.GRAV * va * dtheta / delp


def sea_level_pressure(ps, phis, t_bot):
    """Standard SLP reduction (fv_diagnostics get_pressure_given_height
    style): T extrapolated below ground with the 6.5 K/km lapse rate."""
    hs = phis if phis.ndim == 3 else phis[:, 0]
    gamma = 6.5e-3
    z = hs / con.GRAV
    t0 = t_bot + gamma * z                  # extrapolated sea-level T
    return ps * torch.exp(z * con.GRAV / (con.RDGAS * 0.5 * (t_bot + t0)))


# ---- interpolation -----------------------------------------------------

def _bracket(x, xtv, K):
    """The lower index of the layer pair around target xtv in each column:
    the count of layers with x < xtv, less one, kept in [0, K-2]."""
    cnt = torch.sum((x < xtv).to(x.dtype), dim=1)
    return torch.clamp(cnt - 1.0, 0.0, float(K - 2))


def _weights(x, xts, inside):
    """Gather indices, weights and the inside mask of the targets xts (0-d
    tensors) on the column coordinate x [6, K, n, n]: (idx [6, L, n, n]
    int64, w [6, L, n, n], inside [6, L, n, n] or None)."""
    K = x.shape[1]
    idx, ws, ins = [], [], []
    for xtv in xts:
        l = _bracket(x, xtv, K).to(torch.int64)[:, None]
        x0 = torch.gather(x, 1, l)[:, 0]
        x1 = torch.gather(x, 1, l + 1)[:, 0]
        w = torch.clamp((xtv - x0) / torch.where(x1 == x0,
                                                 torch.ones_like(x0),
                                                 x1 - x0), 0.0, 1.0)
        idx.append(l[:, 0])
        ws.append(w)
        if inside is not None:
            ins.append(inside(x, xtv))
    return (torch.stack(idx, dim=1), torch.stack(ws, dim=1),
            torch.stack(ins, dim=1) if inside is not None else None)


def apply_weights(field, weights):
    """Interpolate field [6, K, n, n] with the weights of pressure_weights
    (or _weights): [6, L, n, n], NaN outside the column."""
    idx, w, inside = weights
    f0 = torch.gather(field, 1, idx)
    f1 = torch.gather(field, 1, idx + 1)
    val = f0 + w * (f1 - f0)
    if inside is None:
        return val
    return torch.where(inside, val, torch.full_like(val, float("nan")))


def _in_pressure_column(x, xtv):
    return (xtv >= x[:, 0]) & (xtv <= x[:, -1])


def pressure_weights(delp, ptop, plevs, log_p=True):
    """The interpolation weights of the target pressures plevs (Pa) on the
    layer-mean pressures of delp, linear in ln p (log_p) or in p; for
    apply_weights."""
    pe = interface_pressure(delp, ptop)
    pm = delp / (torch.log(pe[:, 1:]) - torch.log(pe[:, :-1]))
    x = torch.log(pm) if log_p else pm
    pl = torch.as_tensor(plevs, dtype=delp.dtype, device=delp.device)
    xt = torch.log(pl) if log_p else pl
    return _weights(x, list(xt.reshape(-1)), _in_pressure_column)


def interp_to_pressure_levels(field, delp, ptop, plevs, log_p=True):
    """Interpolate a layer field to target pressure levels (the
    cs3_interpolator role, linear in ln p). field, delp [6, K, n, n];
    plevs: 1-D target pressures (Pa). Returns [6, L, n, n] with NaN where
    the level is below the surface or above the top."""
    return apply_weights(field, pressure_weights(delp, ptop, plevs, log_p))


def wind_speed(ua, va):
    return torch.sqrt(ua ** 2 + va ** 2)


def cape_cin(pt, delp, qv, ptop):
    """Surface-based CAPE/CIN (fv_diagnostics getcape role, simplified):
    a pseudoadiabatic parcel lifted from the lowest layer, its buoyancy
    integrated upward with latent heating at saturation."""
    pe = interface_pressure(delp, ptop)
    peln = torch.log(pe)
    pm = delp / (peln[:, 1:] - peln[:, :-1])
    tv_env = pt * (1.0 + con.ZVIR * qv)
    K = pt.shape[1]
    tp, qp, pprev = pt[:, -1], qv[:, -1], pm[:, -1]
    lat = con.HLV / con.CP_AIR
    contrib = []
    for k in range(K - 2, -1, -1):
        p = pm[:, k]
        # dry adiabatic cooling, then condense back to saturation
        tp = tp * (p / pprev) ** con.KAPPA
        qs, dq = mp.wqs(tp, p)
        excess = torch.clamp_min(qp - qs, 0.0)
        cond = excess / (1.0 + lat * dq)
        tp = tp + lat * cond
        qp = qp - cond
        tvp = tp * (1.0 + con.ZVIR * qp)
        buoy = con.GRAV * (tvp - tv_env[:, k]) / tv_env[:, k]
        dz = con.RDGAS * tv_env[:, k] / con.GRAV * (peln[:, k + 1]
                                                    - peln[:, k])
        contrib.append(buoy * dz)
        pprev = p
    contrib = torch.stack(contrib, dim=0)
    pos = torch.clamp_min(contrib, 0.0).sum(dim=0)
    neg = torch.clamp_max(contrib, 0.0).sum(dim=0)
    return pos, -neg


def layer_heights(delz=None, pt=None, peln=None, sphum=None, phis=None):
    """Height above ground of the layer midpoints and of each layer's
    bottom interface (fv_diagnostics' wz construction). Nonhydrostatic:
    from -delz; hydrostatic: dz = (Rd/g) Tv dlnp. Inputs [.., K, n, n];
    returns (z_mid, z_bot) each [.., K, n, n], upward from the surface."""
    if delz is not None:
        dz = -delz
    else:
        tv = pt if sphum is None else pt * (1.0 + con.ZVIR * sphum)
        dz = con.RDGAS / con.GRAV * tv * (peln[:, 1:] - peln[:, :-1])
    zbot = torch.flip(torch.cumsum(torch.flip(dz, [1]), dim=1), [1]) - dz
    return zbot + 0.5 * dz, zbot


def updraft_helicity(vort, w, z_mid, dz, z_bot=2.0e3, z_top=5.0e3):
    """Updraft helicity over [z_bot, z_top], UH = int vort*w dz
    (fv_diagnostics.F90 updraft_helicity, public :111), partial layers
    weighted by their overlap. Returns [.., n, n] in (m/s)^2."""
    lo = z_mid - 0.5 * dz
    hi = z_mid + 0.5 * dz
    overlap = torch.clamp_min(torch.clamp_max(hi, z_top)
                              - torch.clamp_min(lo, z_bot), 0.0)
    return torch.sum(vort * w * overlap, dim=1)


def radar_reflectivity(delp, pt, q, delz=None, peln=None):
    """Stoelinga (2005) simulated reflectivity with the constant-N0
    Marshall-Palmer intercepts of the GFDL MP (gfdl_mp.F90 rad_ref:6466;
    'reflectivity' at fv_diagnostics.F90:1165):
    Z_e = 3.63e9 (rho q_r)^1.75 + 9.80e8 (rho q_s)^1.75
          + 4.33e10 (rho q_g)^1.75   [mm^6/m^3],
    the dry-ice correction folded into the snow and graupel prefactors.
    q: dict of tracers; returns (dbz [.., K, n, n], composite max
    [.., n, n]), floored at -20 dBZ."""
    sph = q.get("sphum")
    if delz is not None:
        den = -delp / (con.GRAV * delz)
    else:
        tv = pt if sph is None else pt * (1.0 + con.ZVIR * sph)
        den = delp / ((peln[:, 1:] - peln[:, :-1]) * con.RDGAS * tv)
    qmin = 1.0e-12
    z_e = torch.zeros_like(delp)
    for name, fac in (("rainwat", 3.630803e9), ("snowwat", 9.80308e8),
                      ("graupel", 4.330624e10)):
        if name in q:
            z_e = z_e + fac * torch.clamp_min(den * q[name], qmin) ** 1.75
    dbz = 10.0 * torch.log10(torch.clamp_min(z_e, 0.01))
    dbz = torch.clamp_min(dbz, -20.0)
    return dbz, torch.amax(dbz, dim=1)


def echo_top(dbz, z_mid, threshold=18.5):
    """Highest altitude with dbz >= threshold (fv_diagnostics id_dbztop,
    fv_diagnostics.F90:1265); -1 where never reached."""
    z = torch.where(dbz >= threshold, z_mid, torch.full_like(z_mid, -1.0))
    return torch.amax(z, dim=1)


def layer_pressures(delp, ptop):
    """(pe [.., K+1, n, n], peln, p_lay) from delp: the shared pressure
    scaffolding of fv_diagnostics."""
    pe = interface_pressure(delp, ptop)
    peln = torch.log(pe)
    p_lay = delp / (peln[:, 1:] - peln[:, :-1])
    return pe, peln, p_lay


def potential_temperature(pt, p_lay):
    """theta (fv_diagnostics id_theta): T (p00/p)^kappa."""
    return pt * torch.exp(con.KAPPA * torch.log(1.0e5 / p_lay))


def equivalent_potential_temperature(pt, p_lay, qv):
    """theta_e (fv_diagnostics id_theta_e, Bolton-style simplified):
    theta * exp(L qv / (cp T))."""
    th = potential_temperature(pt, p_lay)
    return th * torch.exp(con.HLV * qv / (con.CP_AIR * pt))


def relative_humidity(pt, p_lay, qv):
    """RH in percent over water above freezing, over ice below (the rh
    diagnostic, fv_diagnostics.F90 id_rh)."""
    qsw, _ = mp.wqs(pt, p_lay)
    qsi, _ = mp.iqs(pt, p_lay)
    qsat = torch.where(pt < mp.TICE, qsi, qsw)
    return 100.0 * qv / torch.clamp_min(qsat, 1.0e-12)


def divergence(ua, va, g):
    """A-grid horizontal divergence (id_divg): centred flux differences of
    the lat-lon winds over the cell metrics, one-sided at the tile edges.
    ua, va [6, K, n, n]."""
    n = ua.shape[-1]
    ctr = slice(H, H + n)
    dxc = g.dx[..., H:H + n + 1, ctr]       # y-walls
    dyc = g.dy[..., ctr, H:H + n + 1]       # x-walls
    rarea = g.rarea[..., ctr, ctr]
    ux = torch.cat([ua[..., :, :1], 0.5 * (ua[..., :, 1:] + ua[..., :, :-1]),
                    ua[..., :, -1:]], dim=-1)
    vy = torch.cat([va[..., :1, :], 0.5 * (va[..., 1:, :] + va[..., :-1, :]),
                    va[..., -1:, :]], dim=-2)
    fx = ux * dyc
    fy = vy * dxc
    return rarea * (fx[..., :, 1:] - fx[..., :, :-1]
                    + fy[..., 1:, :] - fy[..., :-1, :])


def interp_to_height(field, z_mid, targets):
    """Interpolate a layer field to fixed heights above ground (the wz
    interpolation behind w1km/w2500m/w5km/u100m, fv_diagnostics.F90
    :1050-1110); z_mid rises as the k index falls. targets: heights (m
    above ground). Returns [6, L, n, n]."""
    K = field.shape[1]
    outs = []
    for zt in targets:
        cnt = torch.sum((z_mid <= zt).to(field.dtype), dim=1)
        l_hi = torch.clamp(K - 1.0 - cnt, 0.0, float(K - 2)).to(
            torch.int64)[:, None]
        z_hi = torch.gather(z_mid, 1, l_hi)[:, 0]
        z_lo = torch.gather(z_mid, 1, l_hi + 1)[:, 0]
        f_hi = torch.gather(field, 1, l_hi)[:, 0]
        f_lo = torch.gather(field, 1, l_hi + 1)[:, 0]
        w = torch.clamp((zt - z_lo) / torch.where(z_hi == z_lo,
                                                  torch.ones_like(z_hi),
                                                  z_hi - z_lo), 0.0, 1.0)
        outs.append(f_lo + w * (f_hi - f_lo))
    return torch.stack(outs, dim=1)


def _overlap(z_mid, dz, zlo, zhi):
    return torch.clamp_min(torch.clamp_max(z_mid + 0.5 * dz, zhi)
                           - torch.clamp_min(z_mid - 0.5 * dz, zlo), 0.0)


def bunkers_motion(ua, va, z_mid, dz):
    """Bunkers et al. (2000) right-mover storm motion (ustm/vstm,
    fv_diagnostics.F90 bunkers_vector): the 0-6 km mean wind plus 7.5 m/s
    along the unit vector normal to the 0-6 km shear."""
    w6 = _overlap(z_mid, dz, 0.0, 6.0e3)
    wsum = torch.clamp_min(torch.sum(w6, dim=1), 1.0)
    um = torch.sum(ua * w6, dim=1) / wsum
    vm = torch.sum(va * w6, dim=1) / wsum
    # shear = mean(5.5-6 km) - mean(0-0.5 km)
    wlo = _overlap(z_mid, dz, 0.0, 0.5e3)
    whi = _overlap(z_mid, dz, 5.5e3, 6.0e3)
    slo = torch.clamp_min(torch.sum(wlo, dim=1), 1.0)
    shi = torch.clamp_min(torch.sum(whi, dim=1), 1.0)
    du = torch.sum(ua * whi, dim=1) / shi - torch.sum(ua * wlo, dim=1) / slo
    dv = torch.sum(va * whi, dim=1) / shi - torch.sum(va * wlo, dim=1) / slo
    mag = torch.clamp_min(torch.sqrt(du ** 2 + dv ** 2), 1.0e-3)
    return um + 7.5 * dv / mag, vm - 7.5 * du / mag


def storm_relative_helicity(ua, va, z_mid, dz, ustm, vstm,
                            z_bot=0.0, z_top=3.0e3):
    """SRH over [z_bot, z_top] (srh01/srh03/srh25, fv_diagnostics
    helicity_relative): int (V - C) . (k x dV/dz) dz, layer by layer in
    the discrete cross-product form."""
    du = ua[:, :-1] - ua[:, 1:]
    dv = va[:, :-1] - va[:, 1:]
    um = 0.5 * (ua[:, :-1] + ua[:, 1:]) - ustm[:, None]
    vm = 0.5 * (va[:, :-1] + va[:, 1:]) - vstm[:, None]
    zc = 0.5 * (z_mid[:, :-1] + z_mid[:, 1:])
    inside = ((zc >= z_bot) & (zc <= z_top)).to(ua.dtype)
    return torch.sum(inside * (um * dv - vm * du), dim=1)


def wind_shear(ua, va, z_mid, dz, z_top=6.0e3):
    """Bulk shear magnitude from 10 m to z_top (shear06)."""
    lo_u = interp_to_height(ua, z_mid, (10.0,))[:, 0]
    lo_v = interp_to_height(va, z_mid, (10.0,))[:, 0]
    hi_u = interp_to_height(ua, z_mid, (z_top,))[:, 0]
    hi_v = interp_to_height(va, z_mid, (z_top,))[:, 0]
    return torch.sqrt((hi_u - lo_u) ** 2 + (hi_v - lo_v) ** 2)


def _in_theta_column(x, xtv):
    return (xtv >= torch.amin(x, dim=1)) & (xtv <= torch.amax(x, dim=1))


def interp_to_theta(field, theta, targets):
    """Interpolate a layer field onto isentropes (the pv350K/pv550K
    support, fv_diagnostics.F90's interpolate_z family on theta). theta
    mostly falls with the k index (k = 0 is the model top), so the column
    coordinate is x = -theta, rising like pressure. Returns [6, L, n, n],
    NaN where the isentrope is outside the column."""
    x = -theta
    xts = [torch.tensor(-float(t), dtype=field.dtype, device=field.device)
           for t in targets]
    return apply_weights(field, _weights(x, xts, _in_theta_column))


def box_max(field2d, size=7):
    """Windowed maximum over a size x size box of each tile (the wind_max
    7x7 search of fv_diagnostics.F90:1977 behind the hurricane
    categories), the box clipped at the tile's edges (padding -inf).
    field2d [6, n, n]; same-shape output."""
    return F.max_pool2d(field2d, size, stride=1, padding=size // 2)


def bulk_richardson(cape, ua, va, z_mid, dz):
    """Bulk Richardson Number (fv_diagnostics id_brn): CAPE over half the
    squared 0-6 km shear (the 0-500 m mean removed)."""
    def layer_mean(f, zlo, zhi):
        wgt = torch.clamp_min(torch.clamp_max(z_mid, zhi)
                              - torch.clamp_min(z_mid - dz, zlo), 0.0)
        return torch.sum(f * wgt, dim=1) / torch.clamp_min(
            torch.sum(wgt, dim=1), 1.0)

    u6 = layer_mean(ua, 0.0, 6.0e3) - layer_mean(ua, 0.0, 500.0)
    v6 = layer_mean(va, 0.0, 6.0e3) - layer_mean(va, 0.0, 500.0)
    denom = 0.5 * (u6 ** 2 + v6 ** 2)
    return cape / torch.clamp_min(denom, 10.0)
