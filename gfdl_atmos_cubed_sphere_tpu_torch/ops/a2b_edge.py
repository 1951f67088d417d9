"""A-grid (cell mean) -> B-grid (corner) interpolation, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/ops/a2b_edge.py (FV3
model/a2b_edge.F90 a2b_ord4:47, a2b_ord2:329, extrap_corner:449). The
cube-corner 3-way extrapolation weights x1/(x2-x1) are metric constants
precomputed on the host (model/grid_ops.py).

Layout: qin [..., P, P] (cells, halo H=3), output [..., NW, NW] corner-point
array valid on Fortran corners [1..npx] (halo rim zero). `a2b_ord4` runs the
CUDA kernel of ops/a2b.py for a CUDA tensor and its plain version for a CPU
tensor.
"""

import torch

H = 3
B1, B2 = 7.0 / 12.0, -1.0 / 12.0      # PPM volume-mean
A1, A2 = 0.5625, -0.0625              # 4-pt Lagrange
C1, C2 = 2.0 / 3.0, -1.0 / 6.0        # compact cubic
R3 = 1.0 / 3.0


def fi(i):
    return i - 1 + H


def corner_legs(npx):
    """Cell-pair legs (j1,i1,j2,i2), Fortran 1-based, of the 3-way cube-corner
    extrapolation (a2b_edge.F90:105-133), shared with the host-side weight
    precompute so the leg order always matches."""
    npy = npx
    return {
        "sw": ((1, 1, 2, 2), (1, 0, 2, -1), (0, 1, -1, 2)),
        "se": ((1, npx - 1, 2, npx - 2), (1, npx, 2, npx + 1),
               (0, npx - 1, -1, npx - 2)),
        "ne": ((npy - 1, npx - 1, npy - 2, npx - 2),
               (npy - 1, npx, npy - 2, npx + 1),
               (npy, npx - 1, npy + 1, npx - 2)),
        "nw": ((npy - 1, 1, npy - 2, 2), (npy - 1, 0, npy - 2, -1),
               (npy, 1, npy + 1, 2)),
    }


def corner_values(qin, g):
    """The four cube-corner values [..., 1, 4] (sw, se, ne, nw) of the 3-way
    extrapolation (a2b_edge.F90:105-133)."""
    f = fi
    npx = qin.shape[-1] - 2 * H + 1
    cw = g.a2b_corner_w                      # [6, 1, 4, 3]
    legs = corner_legs(npx)
    out = []
    for ci, name in enumerate(("sw", "se", "ne", "nw")):
        acc = 0.0
        for li, (j1, i1, j2, i2) in enumerate(legs[name]):
            q1 = qin[..., f(j1):f(j1) + 1, f(i1):f(i1) + 1]
            q2 = qin[..., f(j2):f(j2) + 1, f(i2):f(i2) + 1]
            w = cw[..., ci:ci + 1, li:li + 1]
            acc = acc + q1 + w * (q1 - q2)
        out.append(R3 * acc)
    return torch.cat(out, -1)


def a2b_edge_rows(qin, g):
    """The a2b_ord4 output edge rows/columns and cube-corner values
    (a2b_edge.F90:105-133 corners, :142-158 edge factors). Returns
    (srow, nrow [.., 1, NW], wcol, ecol [.., NW, 1], cvals [.., 1, 4] in
    sw/se/ne/nw order). The plain version's part; the a2b_ord4 kernel
    computes them itself."""
    f = fi
    n = qin.shape[-1] - 2 * H
    npx = npy = n + 1
    NW = n + 1 + 2 * H
    dxa, dya = g.dxa, g.dya
    cvals = corner_values(qin, g)

    q1s = ((qin[..., f(0):f(0) + 1, :] * dya[..., f(1):f(1) + 1, :]
            + qin[..., f(1):f(1) + 1, :] * dya[..., f(0):f(0) + 1, :])
           / (dya[..., f(0):f(0) + 1, :] + dya[..., f(1):f(1) + 1, :]))
    q1n = ((qin[..., f(npy - 1):f(npy - 1) + 1, :]
            * dya[..., f(npy):f(npy) + 1, :]
            + qin[..., f(npy):f(npy) + 1, :]
            * dya[..., f(npy - 1):f(npy - 1) + 1, :])
           / (dya[..., f(npy - 1):f(npy - 1) + 1, :]
              + dya[..., f(npy):f(npy) + 1, :]))
    q2w = ((qin[..., :, f(0):f(0) + 1] * dxa[..., :, f(1):f(1) + 1]
            + qin[..., :, f(1):f(1) + 1] * dxa[..., :, f(0):f(0) + 1])
           / (dxa[..., :, f(0):f(0) + 1] + dxa[..., :, f(1):f(1) + 1]))
    q2e = ((qin[..., :, f(npx - 1):f(npx - 1) + 1]
            * dxa[..., :, f(npx):f(npx) + 1]
            + qin[..., :, f(npx):f(npx) + 1]
            * dxa[..., :, f(npx - 1):f(npx - 1) + 1])
           / (dxa[..., :, f(npx - 1):f(npx - 1) + 1]
              + dxa[..., :, f(npx):f(npx) + 1]))
    pad = torch.nn.functional.pad
    cl_ = lambda a: pad(a, (1, 0))[..., :NW]
    cr_ = lambda a: pad(a, (0, 1))
    rl_ = lambda a: pad(a, (0, 0, 1, 0))[..., :NW, :]
    rr_ = lambda a: pad(a, (0, 0, 0, 1))
    srow = g.edge_s_full * cl_(q1s) + (1.0 - g.edge_s_full) * cr_(q1s)
    nrow = g.edge_n_full * cl_(q1n) + (1.0 - g.edge_n_full) * cr_(q1n)
    wcol = g.edge_w_full * rl_(q2w) + (1.0 - g.edge_w_full) * rr_(q2w)
    ecol = g.edge_e_full * rl_(q2e) + (1.0 - g.edge_e_full) * rr_(q2e)
    return srow, nrow, wcol, ecol, cvals


def _no_cube_edges(g):
    """The orthogonal plane (grid_type >= 3) or a bounded gnomonic patch:
    regular interior stencils everywhere (a2b_edge.F90 bounded_domain
    ranges :52-56), the halos carry valid data."""
    return getattr(g, "grid_type", 0) >= 3 or getattr(g, "bounded", False)


def _a2b_ord4_dp(qin):
    """a2b_ord4 without cube edges: the interior 4th-order cell->corner
    formulas everywhere, zero rim."""
    pad = torch.nn.functional.pad
    qx = pad(B2 * (qin[..., :, :-3] + qin[..., :, 3:])
             + B1 * (qin[..., :, 1:-2] + qin[..., :, 2:-1]), (2, 2))
    qxx = pad(A2 * (qx[..., :-3, :] + qx[..., 3:, :])
              + A1 * (qx[..., 1:-2, :] + qx[..., 2:-1, :]), (0, 0, 2, 2))
    qy = pad(B2 * (qin[..., :-3, :] + qin[..., 3:, :])
             + B1 * (qin[..., 1:-2, :] + qin[..., 2:-1, :]), (0, 0, 2, 2))
    qyy = pad(A2 * (qy[..., :, :-3] + qy[..., :, 3:])
              + A1 * (qy[..., :, 1:-2] + qy[..., :, 2:-1]), (2, 2))
    return 0.5 * (qxx + qyy)


def a2b_ord4(qin, g):
    """qin: [..., P, P] padded cells -> [..., NW, NW] corner values. On the
    cubed sphere: the CUDA kernel for a CUDA tensor, the plain version for a
    CPU tensor. Without cube edges: the plain interior form."""
    if _no_cube_edges(g):
        return _a2b_ord4_dp(qin)
    from .a2b import a2b_ord4 as _a2b_ord4
    return _a2b_ord4(qin, g)


def a2b_ord2(qin, g):
    """a2b_edge.F90 a2b_ord2: 2nd-order cell->corner with edge factors."""
    if _no_cube_edges(g):
        # plain 4-cell average on every corner, edge-replicated rim
        q4 = 0.25 * (qin[..., :-1, :-1] + qin[..., 1:, :-1]
                     + qin[..., :-1, 1:] + qin[..., 1:, 1:])
        shp = q4.shape
        q4 = torch.nn.functional.pad(q4.reshape(-1, 1, *shp[-2:]),
                                     (1, 1, 1, 1), mode="replicate")
        return q4.reshape(*shp[:-2], shp[-2] + 2, shp[-1] + 2)
    f = fi
    n = qin.shape[-1] - 2 * H
    npx = npy = n + 1
    NW = n + 1 + 2 * H
    qout = qin.new_zeros(qin.shape[:-2] + (NW, NW))
    c = slice(f(2), f(npx - 1) + 1)
    j0 = f(1)
    L = npx - 2
    qout[..., c, c] = 0.25 * (
        qin[..., j0:j0 + L, j0:j0 + L] + qin[..., j0 + 1:j0 + 1 + L, j0:j0 + L]
        + qin[..., j0:j0 + L, j0 + 1:j0 + 1 + L]
        + qin[..., j0 + 1:j0 + 1 + L, j0 + 1:j0 + 1 + L])
    qout[..., f(1), f(1)] = R3 * (
        qin[..., f(1), f(1)] + qin[..., f(0), f(1)] + qin[..., f(1), f(0)])
    qout[..., f(1), f(npx)] = R3 * (
        qin[..., f(1), f(npx - 1)] + qin[..., f(0), f(npx - 1)]
        + qin[..., f(1), f(npx)])
    qout[..., f(npy), f(npx)] = R3 * (
        qin[..., f(npy - 1), f(npx - 1)] + qin[..., f(npy - 1), f(npx)]
        + qin[..., f(npy), f(npx - 1)])
    qout[..., f(npy), f(1)] = R3 * (
        qin[..., f(npy - 1), f(1)] + qin[..., f(npy - 1), f(0)]
        + qin[..., f(npy), f(1)])
    rj = slice(f(1), f(npy - 1) + 1)
    q2w = 0.5 * (qin[..., rj, f(0)] + qin[..., rj, f(1)])
    ew = g.edge_w[..., 1:npy - 1]
    qout[..., f(2):f(npy - 1) + 1, f(1)] = ew * q2w[..., :-1] \
        + (1.0 - ew) * q2w[..., 1:]
    q2e = 0.5 * (qin[..., rj, f(npx - 1)] + qin[..., rj, f(npx)])
    ee = g.edge_e[..., 1:npy - 1]
    qout[..., f(2):f(npy - 1) + 1, f(npx)] = ee * q2e[..., :-1] \
        + (1.0 - ee) * q2e[..., 1:]
    ri = slice(f(1), f(npx - 1) + 1)
    q1s = 0.5 * (qin[..., f(0), ri] + qin[..., f(1), ri])
    es = g.edge_s[..., 1:npx - 1]
    qout[..., f(1), f(2):f(npx - 1) + 1] = es * q1s[..., :-1] \
        + (1.0 - es) * q1s[..., 1:]
    q1n = 0.5 * (qin[..., f(npy - 1), ri] + qin[..., f(npy), ri])
    en = g.edge_n[..., 1:npx - 1]
    qout[..., f(npy), f(2):f(npx - 1) + 1] = en * q1n[..., :-1] \
        + (1.0 - en) * q1n[..., 1:]
    return qout
