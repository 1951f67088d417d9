"""Negative-water adjustment, its column fillers and the 2-delta-z
convective adjustment, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/ops/fv_sg.py (FV3
model/fv_sg.F90 neg_adj3:968, fillq:1337, the water-vapour column borrow
:1240-1286, fv_sg_SHiELD:76 and fv_sg_AM5:507). The JAX package's
lax.scans over levels become Python loops over K, walking the same
direction and carrying the same state; its Python k-loops of the
convective adjustment stay Python loops, over per-level [6, y, x] tensors
in place of its whole-field `.at[k]` updates (the same arithmetic on each
level). The level axis is axis 1 ([6, K, y, x]). No TPU kernel runs here.
"""

import torch

from .. import constants as con

CV_AIR = con.CP_AIR - con.RDGAS
ZVIR = con.RVGAS / con.RDGAS - 1.0
NAMES = ("sphum", "liq_wat", "rainwat", "ice_wat", "snowwat", "graupel")


def _zero(a):
    return torch.zeros((), dtype=a.dtype, device=a.device)


def _phase_fix(pt, qv, ql, qr, qi, qs, qg, lcpk, icpk):
    """Pointwise phase fixes (fv_sg.F90:1055-1150)."""
    z = _zero(pt)
    # ---- ice phase -------------------------------------------------------
    qsum = qi + qs
    pos = qsum > 0.0
    qi_n = torch.where(pos, torch.where(qi < 0.0, z,
                                        torch.where(qs < 0.0, qsum, qi)), z)
    qs_n = torch.where(pos, torch.where(qi < 0.0, qsum,
                                        torch.where(qs < 0.0, z, qs)), z)
    qg_n = torch.where(pos, qg, qg + qsum)
    qi, qs, qg = qi_n, qs_n, qg_n

    # graupel < 0: borrow from qs then qi
    dq = torch.minimum(qs, -qg)
    take = qg < 0.0
    qs = torch.where(take, qs - dq, qs)
    qg = torch.where(take, qg + dq, qg)
    dq = torch.minimum(qi, -qg)
    take = qg < 0.0
    qi = torch.where(take, qi - dq, qi)
    qg = torch.where(take, qg + dq, qg)
    # from rain (phase change, heating)
    take = (qg < 0.0) & (qr > 0.0)
    dq = torch.where(take, torch.minimum(qr, -qg), z)
    qg = qg + dq
    qr = qr - dq
    pt = pt + dq * icpk
    # from cloud water
    take = (qg < 0.0) & (ql > 0.0)
    dq = torch.where(take, torch.minimum(ql, -qg), z)
    qg = qg + dq
    ql = ql - dq
    pt = pt + dq * icpk
    # last resort: vapor
    take = (qg < 0.0) & (qv > 0.0)
    dq = torch.where(take, torch.minimum(0.999 * qv, -qg), z)
    qg = qg + dq
    qv = qv - dq
    pt = pt + dq * (icpk + lcpk)

    # ---- liquid phase ----------------------------------------------------
    qsum = ql + qr
    pos = qsum > 0.0
    ql_n = torch.where(pos, torch.where(qr < 0.0, qsum,
                                        torch.where(ql < 0.0, z, ql)), z)
    qr_n = torch.where(pos, torch.where(qr < 0.0, z,
                                        torch.where(ql < 0.0, qsum, qr)), qsum)
    ql, qr = ql_n, qr_n
    neg = qr < 0.0
    # fill negative rain from graupel (cooling)
    dq = torch.where(neg, torch.minimum(torch.clamp_min(qg, 0.0), -qr), z)
    qr = qr + dq
    qg = qg - dq
    pt = pt - dq * icpk
    # from ice+snow (cooling)
    neg = qr < 0.0
    dq = torch.where(neg, torch.minimum(qi + qs, -qr), z)
    qr = qr + dq
    dq1 = torch.minimum(dq, qs)
    qs = qs - dq1
    qi = qi + dq1 - dq
    pt = pt - dq * icpk
    # from vapor (heating)
    neg = (qr < 0.0) & (qv > 0.0)
    dq = torch.where(neg, torch.minimum(0.999 * qv, -qr), z)
    qv = qv - dq
    qr = qr + dq
    pt = pt + dq * lcpk
    return pt, qv, ql, qr, qi, qs, qg


def fillq(q, dp):
    """Aggressive column filler (fv_sg.F90 fillq:1337): fill negatives
    bottom-up from the column's positive reservoir, then remove the borrowed
    mass from positive layers bottom-up. q, dp: [6, K, y, x]."""
    z = _zero(q)
    K = q.shape[1]
    s1 = torch.sum(torch.clamp_min(q, 0.0) * dp, dim=1)
    active = s1 >= 1.0e-12
    s2 = torch.zeros_like(s1)
    q_f = [None] * K
    for k in range(K - 1, -1, -1):
        qq, dd = q[:, k], dp[:, k]
        need = (qq < 0.0) & (s1 > 0.0) & active
        dq = torch.where(need, torch.minimum(s1, -qq * dd), z)
        s1, s2 = s1 - dq, s2 + dq
        q_f[k] = qq + dq / dd
    out = [None] * K
    for k in range(K - 1, -1, -1):
        qq, dd = q_f[k], dp[:, k]
        can = (qq > 0.0) & (s2 > 0.0) & active
        dq = torch.where(can, torch.minimum(s2, qq * dd), z)
        s2 = s2 - dq
        out[k] = qq - dq / dd
    return torch.stack(out, 1)


def _fix_vapor_column(qv, dp):
    """Water-vapour column borrow (fv_sg.F90:1240-1286): push negatives down
    (borrowing from the layer above when possible), then fill a negative
    bottom layer from above."""
    z = _zero(qv)
    K = qv.shape[1]
    q_prev, push, dp_prev = qv[:, 0], torch.zeros_like(qv[:, 0]), dp[:, 0]
    upper = []
    for k in range(1, K):
        qq, dd = qv[:, k], dp[:, k]
        q_eff = qq + push / dd
        can = (q_eff < 0.0) & (q_prev > 0.0)
        dq = torch.where(can, torch.minimum(-q_eff * dd, q_prev * dp_prev), z)
        upper.append(q_prev - dq / dp_prev)
        q_eff = q_eff + dq / dd
        still = q_eff < 0.0
        push = torch.where(still, q_eff * dd, z)
        q_prev, dp_prev = torch.where(still, z, q_eff), dd
    # q_prev is the bottom layer before its fix (it absorbed any pushed
    # mass); a negative bottom borrows from the layers above, bottom-up
    qbot = q_prev + 0.0
    deficit0 = torch.clamp_min(-qbot * dp[:, -1], 0.0)
    deficit = deficit0
    for k in range(K - 2, -1, -1):
        qq, dd = upper[k], dp[:, k]
        can = (deficit > 0.0) & (qq > 0.0)
        dq = torch.where(can, torch.minimum(deficit, qq * dd), z)
        deficit = deficit - dq
        upper[k] = qq - dq / dd
    qbot = qbot + (deficit0 - deficit) / dp[:, -1]
    return torch.stack(upper + [qbot], 1)


def neg_adj3(pt, delp, q, peln=None, delz=None, hydrostatic=True):
    """Negative-moisture adjustment (fv_sg.F90 neg_adj3:968).

    pt: TEMPERATURE [6, K, y, x]; q: dict with the 6-category names (sphum,
    liq_wat, rainwat, ice_wat, snowwat, graupel; optional cld_amt). peln
    and delz are taken, as the reference's argument list has them, and
    not read. Returns (pt, q) adjusted; missing categories are treated as
    zero and returned unchanged."""
    z = torch.zeros_like(pt)
    qv, ql, qr, qi, qs, qg = (q.get(k, z) for k in NAMES)

    if hydrostatic:
        lcpk = con.HLV / con.CP_AIR
        icpk = con.HLF / con.CP_AIR
    else:
        q_liq = torch.clamp_min(ql + qr, 0.0)
        q_sol = torch.clamp_min(qi + qs, 0.0)
        cpm = ((1.0 - (qv + q_liq + q_sol)) * CV_AIR + qv * con.CP_VAPOR
               + q_liq * con.C_LIQ + q_sol * con.C_ICE)
        lcpk = con.HLV / cpm
        icpk = con.HLF / cpm

    pt, qv, ql, qr, qi, qs, qg = _phase_fix(pt, qv, ql, qr, qi, qs, qg,
                                            lcpk, icpk)
    qg = fillq(qg, delp)
    qr = fillq(qr, delp)
    qv = _fix_vapor_column(qv, delp)

    out = dict(q)
    for k, v in zip(NAMES, (qv, ql, qr, qi, qs, qg)):
        if k in q:
            out[k] = v
    if "cld_amt" in q:
        out["cld_amt"] = torch.clamp_min(q["cld_amt"], 0.0)
    return pt, out


# ===========================================================================
# fv_sg_SHiELD (fv_sg.F90:76): 2-delta-z dry/moist convective adjustment
# ===========================================================================

RI_MAX = 1.0
RI_MIN = 0.25
USTAR2 = 1.0e-4
T2_MAX = 315.0
T2_MIN = 165.0


def _levels(a):
    """[6, K, y, x] -> a list of K [6, y, x] levels."""
    return list(torch.unbind(a, 1))


class _Columns:
    """The adjusted fields of the convective adjustment as lists of
    levels: the tracers q0, t0, u0, v0, w0, with the moist heat capacities
    and the condensate of a level formed as the JAX package forms them on
    the whole field."""

    def __init__(self, ta, q, ua, va, w):
        # the levels are replaced, never written in place, so one zero
        # level serves every level of a missing tracer
        self.z = [torch.zeros_like(ta[:, 0])] * ta.shape[1]
        self.q0 = {k: _levels(v) for k, v in q.items()}
        self.t0 = _levels(ta)
        self.u0, self.v0 = _levels(ua), _levels(va)
        self.w0 = _levels(w) if w is not None else list(self.z)

    def get(self, name):
        return self.q0.get(name, self.z)

    def qcon(self, k):
        return (self.get("liq_wat")[k] + self.get("ice_wat")[k]
                + self.get("snowwat")[k] + self.get("rainwat")[k]
                + self.get("graupel")[k])

    def cp_cv(self, k):
        return _cp_cv(lambda name: self.get(name)[k])

    def ri(self, gz, pkz, km1, k):
        """The virtual temperatures of layers km1, k and the Richardson
        number of the pair."""
        qv = self.get("sphum")
        t0, u0, v0 = self.t0, self.u0, self.v0
        tv1 = t0[km1] * (1.0 + ZVIR * qv[km1] - self.qcon(km1))
        tv2 = t0[k] * (1.0 + ZVIR * qv[k] - self.qcon(k))
        pt1 = tv1 / pkz[:, km1]
        pt2 = tv2 / pkz[:, k]
        ri = ((gz[km1] - gz[k]) * (pt1 - pt2)
              / (0.5 * (pt1 + pt2)
                 * ((u0[km1] - u0[k]) ** 2 + (v0[km1] - v0[k]) ** 2
                    + USTAR2)))
        return tv1, tv2, ri

    def swap_all(self, mc, dp1, dp2, km1, k, with_w):
        """Mix every tracer and the winds (and w) of the pair by mc."""
        for a in list(self.q0.values()) + [self.u0, self.v0] + (
                [self.w0] if with_w else []):
            _swap(a, mc, dp1, dp2, km1, k)

    def relax(self, ta, q, ua, va, w, fra, dt):
        """The fra relaxation toward the adjusted state
        (fv_sg.F90:458-505): (ta, q, ua, va, w, u_dt, v_dt)."""
        rdt = 1.0 / dt
        t0 = torch.stack(self.t0, 1)
        ua_new = ua + (torch.stack(self.u0, 1) - ua) * fra
        va_new = va + (torch.stack(self.v0, 1) - va) * fra
        q_new = {k: q[k] + (torch.stack(self.q0[k], 1) - q[k]) * fra
                 for k in q}
        w_new = None if w is None else w + (torch.stack(self.w0, 1)
                                            - w) * fra
        return (ta + (t0 - ta) * fra, q_new, ua_new, va_new, w_new,
                rdt * (ua_new - ua), rdt * (va_new - va))


def _cp_cv(get):
    """The moist cp and cv of the tracers get(name) gives."""
    qvv = get("sphum")
    q_liq = get("liq_wat") + get("rainwat")
    q_sol = get("ice_wat") + get("snowwat") + get("graupel")
    cpm = ((1.0 - (qvv + q_liq + q_sol)) * con.CP_AIR
           + qvv * con.CP_VAPOR + q_liq * con.C_LIQ + q_sol * con.C_ICE)
    cvm = ((1.0 - (qvv + q_liq + q_sol)) * CV_AIR
           + qvv * con.CV_VAP + q_liq * con.C_LIQ + q_sol * con.C_ICE)
    return cpm, cvm


def _swap(a, mc, dp1, dp2, km1, k):
    """Exchange mc of a between levels km1 and k of a list of levels."""
    h0 = mc * (a[k] - a[km1])
    a[km1] = a[km1] + h0 / dp1
    a[k] = a[k] - h0 / dp2


def _gzh(dgz):
    """The height of each layer's lower interface above the surface, as
    geopotential: the sum of dgz over the layers below."""
    return torch.cat(
        [torch.flip(torch.cumsum(torch.flip(dgz, [1]), 1), [1])[:, 1:],
         torch.zeros_like(dgz[:, :1])], dim=1)


def _column_energies(ta, q, ua, va, w, delp, pe, peln, delz, hydrostatic):
    """gz, hd and (nonhydrostatic) te of the initial state, [6, K, y, x]
    (fv_sg.F90:200-260), and the layer-mean pressure pm."""
    z = torch.zeros_like(ta)
    pm = delp / (peln[:, 1:] - peln[:, :-1])
    tvm = ta * (1.0 + ZVIR * q.get("sphum", z))
    if hydrostatic:
        tvr = con.RDGAS * tvm
        gz = _gzh(tvr * (peln[:, 1:] - peln[:, :-1])) \
            + tvr * (1.0 - pe[:, :-1] / pm)
        return gz, con.CP_AIR * tvm + gz + 0.5 * (ua ** 2 + va ** 2), None, pm
    w0 = w if w is not None else z
    cpm, cvm = _cp_cv(lambda name: q.get(name, z))
    gz = _gzh(-con.GRAV * delz) - 0.5 * con.GRAV * delz
    ke = 0.5 * (ua ** 2 + va ** 2 + w0 ** 2)
    return gz, cpm * ta + gz + ke, cvm * ta + gz + ke, pm


def _mix_weight(ratio, ri, ri_ref, dp1, dp2):
    z = torch.zeros_like(ri)
    return torch.where(
        ri < ri_ref,
        ratio * dp1 * dp2 / (dp1 + dp2)
        * (1.0 - torch.clamp_min(ri / ri_ref, 0.0)) ** 2, z)


def fv_sg_adjust(dt, fv_sg_adj, delp, pe, peln, pkz, ta, q, ua, va,
                 hydrostatic=True, w=None, delz=None, m=3):
    """Dry/moist 2-dz instability adjustment (fv_sg_SHiELD, fv_sg.F90:76).

    Column-batched: all fields [6, K, y, x]; pe/peln interfaces
    [6, K+1, y, x]. ta: temperature; q: tracer dict (sphum + condensates
    optional); ua/va: A-grid winds. Returns (ta, q, ua, va, w, u_dt, v_dt).
    The sequential bottom-up interface sweep is a Python k-loop, m passes
    of it (ratio 0.25, 0.5, 0.999 at m = 3)."""
    K = ta.shape[1]
    fra = dt / float(fv_sg_adj)
    cols = _Columns(ta, q, ua, va, w)
    gz, hd, te, pm = _column_energies(ta, q, ua, va, w, delp, pe, peln,
                                      delz, hydrostatic)
    gz, hd = _levels(gz), _levels(hd)
    te = _levels(te) if te is not None else None
    dpl = _levels(delp)
    for n in range(m):
        ratio = (0.25, 0.5, 0.999)[n] if m == 3 else (n + 1.0) / m
        for k in range(K - 1, 0, -1):
            km1 = k - 1
            tv1, tv2, ri = cols.ri(gz, pkz, km1, k)
            ri = torch.where((tv1 > T2_MAX) & (tv1 > tv2),
                             torch.zeros_like(ri), ri)
            ri = torch.where(tv2 < T2_MIN, torch.clamp_max(ri, 0.1), ri)
            ri_ref = torch.clamp_max(
                RI_MIN + (RI_MAX - RI_MIN)
                * torch.clamp_min(400.0e2 - pm[:, k], 0.0) / 200.0e2,
                RI_MAX)
            ri_ref = ri_ref * {1: 4.0, 2: 2.0, 3: 1.5}.get(k, 1.0)
            mc = _mix_weight(ratio, ri, ri_ref, dpl[km1], dpl[k])
            cols.swap_all(mc, dpl[km1], dpl[k], km1, k,
                          with_w=not hydrostatic)
            u0, v0 = cols.u0, cols.v0
            if hydrostatic:
                _swap(hd, mc, dpl[km1], dpl[k], km1, k)
                # T of the two touched layers from hd = cp*Tv + gz + ke
                # with the initial gz (the JAX package's simplification
                # of the reference's running gzh, fv_sg.F90:392-404)
                qv = cols.get("sphum")
                for sl in (k, km1):
                    cols.t0[sl] = ((hd[sl] - gz[sl]
                                    - 0.5 * (u0[sl] ** 2 + v0[sl] ** 2))
                                   / (con.CP_AIR * (1.0 + ZVIR * qv[sl])))
            else:
                _swap(te, mc, dpl[km1], dpl[k], km1, k)
                w0 = cols.w0
                for sl in (km1, k):
                    _, cvm = cols.cp_cv(sl)
                    kin = gz[sl] + 0.5 * (u0[sl] ** 2 + v0[sl] ** 2
                                          + w0[sl] ** 2)
                    cols.t0[sl] = (te[sl] - kin) / cvm
    return cols.relax(ta, q, ua, va, w, fra, dt)


def fv_sg_adjust_am5(dt, tau, delp, pe, peln, pkz, ta, q, ua, va,
                     hydrostatic=True, w=None, delz=None, m=3, k_bot=None):
    """AM5 dry-convective 2-dz adjustment (fv_sg_AM5, fv_sg.F90:507).

    Differences from the SHiELD variant (fv_sg_adjust / fv_sg.F90:76):
      * ri_ref ramp anchored at 500 hPa over a 250 hPa range
        (fv_sg.F90:742) with no near-top ri_ref boosts and no
        t2_max/t2_min guards on the Richardson number;
      * hydrostatic temperature retrieval is the exact running-gzh
        inversion tv = (hd - gzh - ke)/(rk - pe/pm); gzh += tv*dlnp;
        T = tv/(Rd + (Rv-Rd) qv)  (fv_sg.F90:800-812);
      * the nonhydrostatic total-energy exchange transports the
        static-energy difference (h0 = mc*(hd(k)-hd(k-1)) applied to te,
        fv_sg.F90:786-789) and refreshes hd after each retrieval;
      * optional k_bot limits mixing to the levels above it (returns
        unchanged when k_bot < 3, fv_sg.F90:557-562).

    Same calling convention as fv_sg_adjust; `tau` is the relaxation
    timescale (the reference's integer `tau`). The sat_adj tail is
    compiled out in the reference (sat_adj=.false., fv_sg.F90:545) and
    omitted here."""
    K = ta.shape[1]
    kbot = K if k_bot is None else int(k_bot)
    if kbot < 3:
        return ta, q, ua, va, w, torch.zeros_like(ua), torch.zeros_like(va)
    fra = dt / float(tau)
    rz = con.RVGAS - con.RDGAS
    rk = con.CP_AIR / con.RDGAS + 1.0
    cols = _Columns(ta, q, ua, va, w)
    gz, hd, te, pm = _column_energies(ta, q, ua, va, w, delp, pe, peln,
                                      delz, hydrostatic)
    gz, hd = _levels(gz), _levels(hd)
    te = _levels(te) if te is not None else None
    dpl = _levels(delp)
    for n in range(m):
        ratio = (0.25, 0.5, 0.999)[n] if m == 3 else (n + 1.0) / m
        gzh = torch.zeros_like(ta[:, 0])
        for k in range(kbot - 1, 0, -1):
            km1 = k - 1
            _, _, ri = cols.ri(gz, pkz, km1, k)
            # AM5 ramp: 500 hPa anchor / 250 hPa range, no boosts
            ri_ref = torch.clamp_max(
                RI_MIN + (RI_MAX - RI_MIN)
                * torch.clamp_min(500.0e2 - pm[:, k], 0.0) / 250.0e2,
                RI_MAX)
            mc = _mix_weight(ratio, ri, ri_ref, dpl[km1], dpl[k])
            cols.swap_all(mc, dpl[km1], dpl[k], km1, k, with_w=False)
            u0, v0 = cols.u0, cols.v0
            if hydrostatic:
                _swap(hd, mc, dpl[km1], dpl[k], km1, k)
                qv0 = cols.get("sphum")
                # exact inversion, lower layer first (fv_sg.F90:800-812):
                # tv = Rd*Tvm from hd; gzh accumulates upward
                tv_k = ((hd[k] - gzh - 0.5 * (u0[k] ** 2 + v0[k] ** 2))
                        / (rk - pe[:, k] / pm[:, k]))
                gzh = gzh + tv_k * (peln[:, k + 1] - peln[:, k])
                cols.t0[k] = tv_k / (con.RDGAS + rz * qv0[k])
                cols.t0[km1] = (
                    (hd[km1] - gzh - 0.5 * (u0[km1] ** 2 + v0[km1] ** 2))
                    / ((rk - pe[:, km1] / pm[:, km1])
                       * (con.RDGAS + rz * qv0[km1])))
            else:
                # transport the static-energy difference into te
                # (fv_sg.F90:786-789), then w; retrieve T at constant
                # volume and refresh hd
                h0 = mc * (hd[k] - hd[km1])
                te[km1] = te[km1] + h0 / dpl[km1]
                te[k] = te[k] - h0 / dpl[k]
                _swap(cols.w0, mc, dpl[km1], dpl[k], km1, k)
                w0 = cols.w0
                for sl in (km1, k):
                    cpm, cvm = cols.cp_cv(sl)
                    kin = gz[sl] + 0.5 * (u0[sl] ** 2 + v0[sl] ** 2
                                          + w0[sl] ** 2)
                    t_new = (te[sl] - kin) / cvm
                    cols.t0[sl] = t_new
                    hd[sl] = cpm * t_new + kin
    return cols.relax(ta, q, ua, va, w, fra, dt)
