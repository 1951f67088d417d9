"""The tile plan of the port's tile-fused kernels (csrc/fv_tile.cuh Tile):
the d_sw stage kernels, the tp sweep and c_sw.

A block owns a box of at most TY x TX compute cells of one cube tile; box
t of nt along an axis of n cells holds cells [t n // nt, (t + 1) n // nt),
so every box is at least min(n, TX / 2) wide and only the box holding a
cube corner reaches into the corner's halo block. Each point of a padded
output frame is written by exactly one box: the first and last boxes of
an axis take the halo rows and columns beyond them.
"""

H = 3


def plan(box, n):
    """(TX, TY, boxes along x, boxes along y) for the box (TX, TY) and n
    cells per side."""
    tx, ty = box
    return tx, ty, -(-n // tx), -(-n // ty)


def box_starts(n, nt):
    """The first compute cell of each of nt boxes along an axis, and n."""
    return [t * n // nt for t in range(nt + 1)]


def owned_ranges(n, nt, kind):
    """[lo, hi) of the points each of nt boxes along an axis writes, in
    the indices of the output frame: kind "cells" (the padded n + 6),
    "walls" (the padded n + 7), "compute_cells" (n) or "compute_walls"
    (n + 1). The first and last boxes take the halo beyond them."""
    st = box_starts(n, nt)
    out = []
    for t in range(nt):
        lo, hi = st[t], st[t + 1]
        last = t == nt - 1
        if kind == "compute_cells":
            out.append((lo, hi))
        elif kind == "compute_walls":
            out.append((lo, hi + 1 if last else hi))
        else:
            top = n + (6 if kind == "cells" else 7)
            out.append((0 if t == 0 else lo + H, top if last else hi + H))
    return out


def window_bytes(box, planes, itemsize, flag_planes=0):
    """Dynamic shared memory of a block that holds `planes` window planes
    of (TY + 7) x (TX + 7) elements and `flag_planes` byte planes."""
    tx, ty = box
    win = (ty + 7) * (tx + 7)
    return planes * win * itemsize + flag_planes * win
