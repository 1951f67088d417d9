"""Cube-corner halo fill conventions for directional sweeps (PyTorch port).

Counterpart of gfdl_atmos_cubed_sphere_tpu/ops/fill_corners.py, transcribed
from FV3 tools/fv_mp_mod.F90:944-1456 (fill_corners_2d BGRID variant,
fill_corners_dgrid) and model/sw_core.F90:3360-3556 (fill_4corners). Cube
corners have only 3 neighbour faces, so the corner halo blocks of a padded
array have no physical source; these routines fill them from in-tile and
edge-halo values so 1-D sweeps can pass straight through. Arrays are
[..., y, x], padded with halo H=3; Fortran index p maps to padded p-1+H.

Each function returns a new tensor; the point assignments run in the
reference order on a private copy.
"""

H = 3
NG = 3


def fi(i):
    """Fortran 1-based index -> 0-based padded array index."""
    return i - 1 + H


def cube_edges(g):
    """True when the grid has real cube-face edges (one-sided stencils and
    corner fills apply). The port carries the cubed sphere only."""
    return (getattr(g, "grid_type", 0) < 3
            and not getattr(g, "bounded", False))


def fill_4corners_cell(q, direction, npx):
    """sw_core.F90 fill_4corners: fill 2 cells at each corner for a sweep.
    q: [..., P, P] padded cell array; direction: 1 = x, 2 = y."""
    f = fi
    npy = npx
    q = q.clone()
    if direction == 1:
        pairs = (((0, -1), (2, 0)), ((0, 0), (1, 0)),
                 ((0, npx + 1), (2, npx)), ((0, npx), (1, npx)),
                 ((npy, 0), (npy - 1, 0)), ((npy, -1), (npy - 2, 0)),
                 ((npy, npx), (npy - 1, npx)),
                 ((npy, npx + 1), (npy - 2, npx)))
    else:
        pairs = (((0, 0), (0, 1)), ((-1, 0), (0, 2)),
                 ((0, npx), (0, npx - 1)), ((-1, npx), (0, npx - 2)),
                 ((npy, 0), (npy, 1)), ((npy + 1, 0), (npy, 2)),
                 ((npy, npx), (npy, npx - 1)),
                 ((npy + 1, npx), (npy, npx - 2)))
    for (dj, di), (sj, si) in pairs:
        q[..., f(dj), f(di)] = q[..., f(sj), f(si)]
    return q


def fill_corners_bgrid(q, direction, npx):
    """q: [..., NW, NW] padded corner-point array; fills ng x ng corner
    blocks (fv_mp_mod.F90:944-982 BGRID)."""
    f = fi
    npy = npx
    q = q.clone()
    for j in range(1, NG + 1):
        if direction == 1:
            q[..., f(1 - j), f(1 - NG):f(0) + 1] = \
                q[..., f(2):f(NG + 1) + 1, f(1 - j)].flip(-1)
            q[..., f(npy + j), f(1 - NG):f(0) + 1] = \
                q[..., f(npy - NG):f(npy - 1) + 1, f(1 - j)].clone()
            q[..., f(1 - j), f(npx + 1):f(npx + NG) + 1] = \
                q[..., f(2):f(NG + 1) + 1, f(npx + j)].clone()
            q[..., f(npy + j), f(npx + 1):f(npx + NG) + 1] = \
                q[..., f(npy - NG):f(npy - 1) + 1, f(npx + j)].flip(-1)
        else:
            q[..., f(1 - NG):f(0) + 1, f(1 - j)] = \
                q[..., f(1 - j), f(2):f(NG + 1) + 1].flip(-1)
            q[..., f(npy + 1):f(npy + NG) + 1, f(1 - j)] = \
                q[..., f(npy + j), f(2):f(NG + 1) + 1].clone()
            q[..., f(1 - NG):f(0) + 1, f(npx + j)] = \
                q[..., f(1 - j), f(npx - NG):f(npx - 1) + 1].flip(-1)
            q[..., f(npy + 1):f(npy + NG) + 1, f(npx + j)] = \
                q[..., f(npy + j), f(npx - NG):f(npx - 1) + 1].clone()
    return q


def fill_corners_dgrid_vector(u, v, npx, sign=-1.0):
    """D-grid staggered vector corner fill (fv_mp_mod.F90:1249-1281).
    u: y-wall [..., NW, P]; v: x-wall [..., P, NW]; sign=-1 for winds."""
    f = fi
    npy = npx
    u = u.clone()
    v = v.clone()
    for j in range(1, NG + 1):
        u[..., f(1 - j), f(1 - NG):f(0) + 1] = \
            sign * v[..., f(1):f(NG) + 1, f(1 - j)].flip(-1)
        u[..., f(npy + j), f(1 - NG):f(0) + 1] = \
            v[..., f(npy - NG):f(npy - 1) + 1, f(1 - j)]
        u[..., f(1 - j), f(npx):f(npx - 1 + NG) + 1] = \
            v[..., f(1):f(NG) + 1, f(npx + j)]
        u[..., f(npy + j), f(npx):f(npx - 1 + NG) + 1] = \
            sign * v[..., f(npy - NG):f(npy - 1) + 1, f(npx + j)].flip(-1)
    for j in range(1, NG + 1):
        v[..., f(1 - j), f(1 - NG):f(0) + 1] = \
            sign * u[..., f(1 - NG):f(0) + 1, f(j)]
        v[..., f(npy - 1 + j), f(1 - NG):f(0) + 1] = \
            u[..., f(npy + 1):f(npy + NG) + 1, f(j)].flip(-1)
        v[..., f(1 - j), f(npx + 1):f(npx + NG) + 1] = \
            u[..., f(1 - NG):f(0) + 1, f(npx - j)].flip(-1)
        v[..., f(npy - 1 + j), f(npx + 1):f(npx + NG) + 1] = \
            sign * u[..., f(npy + 1):f(npy + NG) + 1, f(npx - j)]
    return u, v
