"""Negative-water adjustment and its column fillers, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/ops/fv_sg.py (FV3
model/fv_sg.F90 neg_adj3:968, fillq:1337 and the water-vapour column borrow
:1240-1286). The JAX package's lax.scans over levels become Python loops
over K, walking the same direction and carrying the same state. The level
axis is axis 1 ([6, K, y, x]). No TPU kernel runs here.
"""

import torch

from .. import constants as con

CV_AIR = con.CP_AIR - con.RDGAS
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


def neg_adj3(pt, delp, q, hydrostatic=True):
    """Negative-moisture adjustment (fv_sg.F90 neg_adj3:968).

    pt: TEMPERATURE [6, K, y, x]; q: dict with the 6-category names (sphum,
    liq_wat, rainwat, ice_wat, snowwat, graupel; optional cld_amt).
    Returns (pt, q) adjusted; missing categories are treated as zero and
    returned unchanged."""
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
