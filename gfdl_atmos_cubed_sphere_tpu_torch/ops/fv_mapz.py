"""Vertical remapping operators (Lagrangian -> Eulerian coordinates),
PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/ops/fv_mapz.py (FV3
model/fv_operators.F90 cs_profile:919, cs_limiters:1303, map1_ppm:137,
mapn_tracer:234; model/fv_fill.F90 fillz:34) for every kord the JAX
package takes (<= 8, 9-15, 17, with the qmin forms of 9, 10 and 11) and
every iv (0, 1, -1, 2, -2, -3), with map1_ppm_ext, the remap onto a column
that reaches past the source's ends, and map_scalar_logp. The level axis
is LAST. No TPU kernel runs here; the tridiagonal sweeps are Python loops
over levels.

The reconstruction produces per-layer PPM coefficients (al, ar, a6) with
f(s) = al + s*[(ar-al) + a6*(1-s)], s in [0,1]; the remap integrates the
piecewise-parabolic profile between new-coordinate edges with a cumulative
antiderivative (exactly conservative by telescoping).
"""

import torch

R3 = 1.0 / 3.0
R12 = 1.0 / 12.0
T_MIN = 184.0       # fv_mapz.F90 t_min
# points per chunk of remap_ppm's [points, kn+1, km] antiderivative table
_REMAP_CHUNK_ELEMS = 1 << 26


def _tridiag_interfaces(a1, delp, qs, iv):
    """Cubic-spline interface values q[..., km+1] (cs_profile:967-1016).
    a1, delp: [..., km]; qs: [...] bottom BC (iv == -2)."""
    km = a1.shape[-1]
    A = [a1[..., k] for k in range(km)]
    D = [delp[..., k] for k in range(km)]
    if iv == -2:
        # vertical-velocity variant with prescribed bottom value qs
        q = [1.5 * A[0]]
        gam = [torch.full_like(A[0], 0.5)]          # gam(2)
        grats = [D[k - 1] / D[k] for k in range(1, km)]
        for k in range(1, km - 1):
            grat = grats[k - 1]
            bet = 2.0 + grat + grat - gam[-1]
            q.append((3.0 * (A[k - 1] + A[k]) - q[-1]) / bet)
            gam.append(grat / bet)
        gratK = grats[-1]
        qK = (3.0 * (A[-2] + A[-1]) - gratK * qs - q[-1]) / (
            2.0 + gratK + gratK - gam[-1])
        out = [None] * (km + 1)
        out[km - 1] = qK
        out[km] = qs
        nxt = qK
        for k in range(km - 2, -1, -1):
            nxt = q[k] - gam[k] * nxt
            out[k] = nxt
        return torch.stack(out, -1)

    grat = D[1] / D[0]
    bet0 = grat * (grat + 0.5)
    q = [((grat + grat) * (grat + 1.0) * A[0] + A[1]) / bet0]
    gam = [(1.0 + grat * (grat + 1.5)) / bet0]
    for k in range(1, km):
        d4 = D[k - 1] / D[k]
        bet = 2.0 + d4 + d4 - gam[-1]
        q.append((3.0 * (A[k - 1] + d4 * A[k]) - q[-1]) / bet)
        gam.append(d4 / bet)
    d4 = D[km - 2] / D[km - 1]
    a_bot = 1.0 + d4 * (d4 + 1.5)
    q_bot = (2.0 * d4 * (d4 + 1.0) * A[-1] + A[-2]
             - a_bot * q[-1]) / (d4 * (d4 + 0.5) - a_bot * gam[-1])
    out = [None] * (km + 1)
    out[km] = q_bot
    nxt = q_bot
    for k in range(km - 1, -1, -1):
        nxt = q[k] - gam[k] * nxt
        out[k] = nxt
    return torch.stack(out, -1)


def _cs_limiter(a1, al, ar, a6, extm, iv):
    """cs_limiters (fv_operators.F90:1303) for iv = 0, 1 and 2."""
    zero = torch.zeros((), dtype=a1.dtype, device=a1.device)
    if iv == 0:
        # positive-definite: flatten or one-side a profile whose minimum
        # dips below zero; a non-positive mean gives a constant layer
        da1 = ar - al
        cond = (torch.abs(da1) < -a6) & (
            a1 + 0.25 * da1 * da1 / torch.where(a6 == 0, 1.0, a6)
            + a6 * R12 < 0.0)
        both = (a1 < ar) & (a1 < al)
        up = ar > al
        al_n = torch.where(both, a1, torch.where(up, al, ar - 3.0 * (ar - a1)))
        ar_n = torch.where(both, a1, torch.where(up, al - 3.0 * (al - a1), ar))
        a6_n = torch.where(both, zero, torch.where(up, 3.0 * (al - a1),
                                                   3.0 * (ar - a1)))
        neg = a1 <= 0.0
        return (torch.where(neg, a1, torch.where(cond, al_n, al)),
                torch.where(neg, a1, torch.where(cond, ar_n, ar)),
                torch.where(neg, zero, torch.where(cond, a6_n, a6)))
    if iv == 1:
        ext = (a1 - al) * (a1 - ar) >= 0.0
    else:
        ext = extm
    da1 = ar - al
    da2 = da1 * da1
    a6da = a6 * da1
    ar_lo = al - 3.0 * (al - a1)
    al_hi = ar - 3.0 * (ar - a1)
    a6_lo = 3.0 * (al - a1)
    a6_hi = 3.0 * (ar - a1)
    al2 = torch.where(a6da < -da2, al, torch.where(a6da > da2, al_hi, al))
    ar2 = torch.where(a6da < -da2, ar_lo, ar)
    a62 = torch.where(a6da < -da2, a6_lo,
                      torch.where(a6da > da2, a6_hi, a6))
    return (torch.where(ext, a1, al2), torch.where(ext, a1, ar2),
            torch.where(ext, zero, a62))


def cs_profile(a1, delp, qs=None, iv=1, kord=8, qmin=None):
    """PPM/cubic-spline reconstruction (cs_profile / scalar_profile) for
    kord <= 8, 9-15 and 17 with iv in (0, 1, -1, 2, -2, -3); qmin given
    selects scalar_profile's qmin-aware forms of kord 9, 10 and 11. a1:
    [..., km]; delp: [..., km], or without a1's leading axes (the tracers
    of mapn_tracer share their edges); qs: bottom BC [...] (iv = -2).
    Returns (al, ar, a6): [..., km]."""
    km = a1.shape[-1]
    akord = abs(kord)
    if not (akord <= 15 or akord == 17) or iv not in (0, 1, -1, 2, -2, -3):
        raise NotImplementedError(
            f"cs_profile: kord {kord} with iv {iv} is not a JAX form")
    if qs is None:
        qs = torch.zeros(a1.shape[:-1], dtype=a1.dtype, device=a1.device)
    q = _tridiag_interfaces(a1, delp, qs, iv)
    zero = torch.zeros((), dtype=a1.dtype, device=a1.device)

    if akord == 17:
        al = q[..., :-1]
        ar = q[..., 1:]
        return al, ar, 3.0 * (2.0 * a1 - (al + ar))

    # ---- large-scale constraints on interface values ---------------------
    dq = a1[..., 1:] - a1[..., :-1]
    hi = torch.maximum(a1[..., :-1], a1[..., 1:])
    lo = torch.minimum(a1[..., :-1], a1[..., 1:])
    qi = q[..., 1:-1]
    clamped = torch.minimum(torch.maximum(qi, lo), hi)
    qmid = qi[..., 1:-1]
    lo_m = lo[..., 1:-1]
    hi_m = hi[..., 1:-1]
    if akord >= 14:
        qmid_n = torch.minimum(torch.maximum(qmid, lo_m), hi_m)
    else:
        gkm1 = dq[..., :-2]
        gkp1 = dq[..., 2:]
        loc_max = gkm1 > 0.0
        q_max = torch.maximum(qmid, lo_m)
        q_min = torch.minimum(qmid, hi_m)
        if iv == 0:
            q_min = torch.clamp_min(q_min, 0.0)
        qmid_n = torch.where(gkm1 * gkp1 > 0.0,
                             torch.minimum(torch.maximum(qmid, lo_m), hi_m),
                             torch.where(loc_max, q_max, q_min))
    qi = torch.cat([clamped[..., :1], qmid_n, clamped[..., -1:]], -1)
    q = torch.cat([q[..., :1], qi, q[..., -1:]], -1)

    al = q[..., :-1]
    ar = q[..., 1:]

    # extremum flags
    ext_edge = (al - a1) * (ar - a1) > 0.0
    ext_int = dq[..., :-1] * dq[..., 1:] < 0.0
    extm = torch.cat([ext_edge[..., :1], ext_int, ext_edge[..., -1:]], -1)
    x0 = 2.0 * a1 - (al + ar)
    x1 = torch.abs(al - ar)
    ext5 = torch.abs(x0) > x1
    ext6 = torch.abs(3.0 * x0) > x1

    # ---- top boundary subgrid constraints --------------------------------
    if iv == 0:
        al = torch.cat([torch.clamp_min(al[..., :1], 0.0), al[..., 1:]], -1)
    elif iv == -1:
        al = torch.cat([torch.where(al[..., :1] * a1[..., :1] <= 0.0, zero,
                                    al[..., :1]), al[..., 1:]], -1)
    elif iv == 2:
        al = torch.cat([a1[..., :1], al[..., 1:]], -1)
        ar = torch.cat([a1[..., :1], ar[..., 1:]], -1)

    # Huynh constraints; gam(k) = a1(k) - a1(k-1) (1-based)
    dqe = torch.nn.functional.pad(dq, (2, 2))

    def G(off):
        return dqe[..., 1 + off:1 + off + km]

    pmp_1 = a1 - 2.0 * G(1)
    lac_1 = pmp_1 + 1.5 * G(2)
    al_h = torch.minimum(
        torch.maximum(al, torch.minimum(torch.minimum(a1, pmp_1), lac_1)),
        torch.maximum(torch.maximum(a1, pmp_1), lac_1))
    pmp_2 = a1 + 2.0 * G(0)
    lac_2 = pmp_2 - 1.5 * G(-1)
    ar_h = torch.minimum(
        torch.maximum(ar, torch.minimum(torch.minimum(a1, pmp_2), lac_2)),
        torch.maximum(torch.maximum(a1, pmp_2), lac_2))

    def neighbours(flag):
        # flag of the layer above or below (False past the ends)
        m = torch.nn.functional.pad(flag, (1, 1), value=False)
        return m[..., 0:km] | m[..., 2:km + 2]

    if akord <= 8:
        al_i, ar_i = al_h, ar_h
        a6_i = 3.0 * (2.0 * a1 - (al_i + ar_i))
    elif akord == 9:
        noisy = extm & neighbours(extm)
        if qmin is not None:
            noisy = noisy | (extm & (a1 < qmin))
        a6_0 = 3.0 * (2.0 * a1 - (al + ar))
        nonmono = torch.abs(a6_0) > torch.abs(al - ar)
        al_i = torch.where(noisy, a1, torch.where(nonmono, al_h, al))
        ar_i = torch.where(noisy, a1, torch.where(nonmono, ar_h, ar))
        a6_i = torch.where(noisy, zero, 3.0 * (2.0 * a1 - (al_i + ar_i)))
    elif akord == 10:
        if qmin is not None:
            flat = extm & ((a1 < qmin) | neighbours(extm))
        else:
            flat = extm & neighbours(extm)
        a6_0 = 6.0 * a1 - 3.0 * (al + ar)
        nonmono = (~extm) & (torch.abs(a6_0) > torch.abs(al - ar))
        al_i = torch.where(flat, a1, torch.where(nonmono, al_h, al))
        ar_i = torch.where(flat, a1, torch.where(nonmono, ar_h, ar))
        a6_i = torch.where(flat, zero, 6.0 * a1 - 3.0 * (al_i + ar_i))
    elif akord == 11:
        if qmin is not None:
            noisy = ext5 & (neighbours(ext5) | (a1 < qmin))
        else:
            noisy = ext5 & neighbours(ext5)
        al_i = torch.where(noisy, a1, al)
        ar_i = torch.where(noisy, a1, ar)
        a6_i = torch.where(noisy, zero, 3.0 * (2.0 * a1 - (al_i + ar_i)))
    elif akord == 12:
        n5 = neighbours(ext5)
        flat = ext5 & n5
        huynh = (ext5 & ~n5 & neighbours(ext6)) | (~ext5 & ext6 & n5)
        al_i = torch.where(flat, a1, torch.where(huynh, al_h, al))
        ar_i = torch.where(flat, a1, torch.where(huynh, ar_h, ar))
        a6_i = 3.0 * (2.0 * a1 - (al_i + ar_i))
    elif akord == 13:
        al_i, ar_i = al, ar
        a6_i = 3.0 * (2.0 * a1 - (al + ar))
    else:                                                   # 14, 15
        a6_0 = 3.0 * (2.0 * a1 - (al + ar))
        al_i, ar_i, a6_i = _cs_limiter(a1, al, ar, a6_0, extm,
                                       2 if akord == 14 else 1)
    if iv == 0 and akord <= 13:
        al_i, ar_i, a6_i = _cs_limiter(a1, al_i, ar_i, a6_i, extm, 0)

    # ---- layers 0, 1, km-2, km-1 use the monotone limiters ---------------
    a6_b = 3.0 * (2.0 * a1 - (al + ar))
    al0, ar0, a60 = _cs_limiter(a1, al, ar, a6_b, extm, 1)
    al1, ar1, a61 = _cs_limiter(a1, al, ar, a6_b, extm, 2)
    if iv == 0:
        ar_bot = torch.clamp_min(ar, 0.0)
    elif iv == -1:
        ar_bot = torch.where(ar * a1 <= 0.0, zero, ar)
    else:
        ar_bot = ar
    a6_bot = 3.0 * (2.0 * a1 - (al + ar_bot))
    alm0, arm0, a6m0 = _cs_limiter(a1, al, ar_bot, a6_bot, extm, 1)

    pos = torch.arange(km, device=a1.device)

    def pick(v0, v1, vm1, vm0, vi):
        return torch.where(pos == 0, v0, torch.where(
            pos == 1, v1, torch.where(pos == km - 2, vm1, torch.where(
                pos == km - 1, vm0, vi))))

    return (pick(al0, al1, al1, alm0, al_i), pick(ar0, ar1, ar1, arm0, ar_i),
            pick(a60, a61, a61, a6m0, a6_i))


def remap_ppm(a1, pe1, pe2, al, ar, a6):
    """Conservative remap of the (al, ar, a6) reconstruction from edges
    pe1 to edges pe2 ([..., km+1], [..., kn+1], matching end edges).
    Q(p) = sum_k dp1_k * I_k(clip((p - pe1_k)/dp1_k, 0, 1)) with the layer
    antiderivative I; the [points, kn+1, km] table is built in chunks of
    points so its size stays bounded at full width."""
    lead = a1.shape[:-1]
    km = a1.shape[-1]
    kn1 = pe2.shape[-1]
    # edges may broadcast over the field's leading axes (tracers stacked)
    pe1 = pe1.expand(*lead, pe1.shape[-1])
    pe2 = pe2.expand(*lead, kn1)
    flat = [t.reshape(-1, t.shape[-1]) for t in (pe1, pe2, al, ar, a6)]
    npts = flat[0].shape[0]
    chunk = max(1, _REMAP_CHUNK_ELEMS // (kn1 * km))
    outs = []
    for s0 in range(0, npts, chunk):
        p1, p2, l_, r_, s6 = (t[s0:s0 + chunk] for t in flat)
        dp1 = p1[:, 1:] - p1[:, :-1]
        s = torch.clamp((p2[:, :, None] - p1[:, None, :-1])
                        / dp1[:, None, :], 0.0, 1.0)
        Is = (l_[:, None, :] * s
              + 0.5 * (r_ - l_)[:, None, :] * s * s
              + s6[:, None, :] * (0.5 * s * s - R3 * s ** 3))
        Q = torch.sum(dp1[:, None, :] * Is, dim=-1)
        outs.append((Q[:, 1:] - Q[:, :-1]) / (p2[:, 1:] - p2[:, :-1]))
    return torch.cat(outs, 0).reshape(*lead, kn1 - 1)


def map1_ppm(q, pe1, pe2, qs=None, iv=1, kord=8, qmin=None):
    """Full remap of a field [..., km] from edges pe1 to pe2."""
    al, ar, a6 = cs_profile(q, pe1[..., 1:] - pe1[..., :-1], qs=qs, iv=iv,
                            kord=abs(kord), qmin=qmin)
    return remap_ppm(q, pe1, pe2, al, ar, a6)


def map1_ppm_ext(q, pe1, pe2, qs=None, iv=1, kord=8, qmin=None):
    """map1_ppm with constant extrapolation where the target column reaches
    past the source's ends (mappm's above-ptop / below-surface handling,
    fv_operators.F90:1782), e.g. a restart remapped onto a higher-top
    coordinate: remap_ppm clips the target edges into the source range, so
    the uncovered width of each target layer is filled with the end source
    layer's value."""
    q2 = map1_ppm(q, pe1, pe2, qs=qs, iv=iv, kord=kord, qmin=qmin)
    w = pe2[..., 1:] - pe2[..., :-1]
    top = pe1[..., :1]
    bot = pe1[..., -1:]
    miss_top = (torch.clamp_min(top - pe2[..., :-1], 0.0)
                - torch.clamp_min(top - pe2[..., 1:], 0.0))
    miss_bot = (torch.clamp_min(pe2[..., 1:] - bot, 0.0)
                - torch.clamp_min(pe2[..., :-1] - bot, 0.0))
    return (q2 * w + q[..., :1] * miss_top + q[..., -1:] * miss_bot) / w


def map_scalar_logp(q, peln1, peln2, iv=1, kord=8, qmin=T_MIN):
    """map_scalar on log-p edges (the temperature remap, kord_tm < 0)."""
    return map1_ppm(q, peln1, peln2, iv=iv, kord=abs(kord), qmin=qmin)


def mapn_tracer(qstack, pe1, pe2, kord=8, fill=False, qmin=None):
    """All tracers remapped at once (fv_operators.F90 mapn_tracer:234).
    qstack: [nq, ..., km]; pe1 / pe2: [..., km+1] / [..., kn+1] edges shared
    by the tracers. The positive-definite (iv = 0) reconstructions run over
    the stacked axis; the overlap integration contracts three weight tables
    W1, W2, W3 [points, kn+1, km], shared by the tracers, against the
    (al, ar - al, a6) coefficients, as the JAX formulation does. The tables
    are built in chunks of points so their size stays bounded at full
    width; the arithmetic of each column is unchanged."""
    dp1 = pe1[..., 1:] - pe1[..., :-1]
    al, ar, a6 = cs_profile(qstack, dp1, iv=0, kord=abs(kord), qmin=qmin)
    nq, km, kn1 = qstack.shape[0], qstack.shape[-1], pe2.shape[-1]
    lead = pe1.shape[:-1]
    coef = [c.reshape(nq, -1, km) for c in (al, ar - al, a6)]
    p1, p2, d1 = (t.reshape(-1, t.shape[-1]) for t in (pe1, pe2, dp1))
    chunk = max(1, _REMAP_CHUNK_ELEMS // (kn1 * km))
    outs = []
    for s0 in range(0, p1.shape[0], chunk):
        e1, e2, dp = (t[s0:s0 + chunk] for t in (p1, p2, d1))
        s = torch.clamp((e2[:, :, None] - e1[:, None, :-1]) / dp[:, None, :],
                        0.0, 1.0)
        s2 = s * s
        w1 = dp[:, None, :] * s
        w2 = dp[:, None, :] * 0.5 * s2
        w3 = dp[:, None, :] * (0.5 * s2 - R3 * s2 * s)
        # Q[q, p, n] = sum_k W[p, n, k] * coeff[q, p, k]
        Q = sum(torch.einsum("pnk,qpk->qpn", w, c[:, s0:s0 + chunk])
                for w, c in zip((w1, w2, w3), coef))
        outs.append((Q[..., 1:] - Q[..., :-1]) / (e2[:, 1:] - e2[:, :-1]))
    q2 = torch.cat(outs, 1).reshape(nq, *lead, kn1 - 1)
    if fill:
        q2 = fillz(q2, (pe2[..., 1:] - pe2[..., :-1]).expand(q2.shape))
    return q2


def fillz(q, dp):
    """Vertical negative-tracer filler (fv_fill.F90 fillz:34) as the JAX
    package writes it: top-down borrowing, exactly conservative; a debt left
    at the bottom goes into the bottom layer. q, dp: [..., km]."""
    qd = q * dp
    debt = torch.zeros_like(qd[..., 0])
    out = []
    for k in range(q.shape[-1]):
        avail = qd[..., k] + debt
        out.append(torch.clamp_min(avail, 0.0))
        debt = torch.clamp_max(avail, 0.0)
    out[-1] = out[-1] + debt
    return torch.stack(out, -1) / dp
