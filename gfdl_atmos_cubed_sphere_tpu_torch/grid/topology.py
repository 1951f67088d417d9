"""Cubed-sphere inter-tile topology, derived numerically from grid geometry.

The reference hardcodes the 6-tile / 12-contact mosaic tables
(FV3 tools/fv_mp_mod.F90:386-413) and orientation-specific corner
fills (fv_mp_mod.F90:944-1456). Here the contacts and index transforms are
*derived* from the generated grid by matching edge corner coordinates, which
makes the halo machinery provably consistent with the geometry.

Each contact is stored as an affine map on corner-point indices:
    (jc', ic') = M @ (jc, ic) + b
with M a signed permutation matrix. All cell / D-grid / C-grid halo index
maps and wind-component rotations are derived mechanically from (tile', M, b).

Index conventions (0-based, per tile, n = cells per side):
  corner points: (jc, ic) in [0, n]^2
  cells:         (j, i) in [0, n)^2
  D-grid u[j, i]: x-wind on y-walls, j in [0, n] corner-rows, i in [0, n) cells
  D-grid v[j, i]: y-wind on x-walls, j in [0, n) cells, i in [0, n] corner-cols
  C-grid uc[j, i]: x-wind on x-walls, j in [0, n) cells, i in [0, n] corner-cols
  C-grid vc[j, i]: y-wind on y-walls, j in [0, n] corner-rows, i in [0, n) cells
"""

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

EDGES = ("W", "E", "S", "N")


@dataclass(frozen=True)
class EdgeContact:
    """Affine corner-index map into the neighbor tile across one edge."""
    tile: int                 # neighbor tile index (0-based)
    M: tuple                  # 2x2 signed permutation, rows/cols = (j, i)
    b: tuple                  # offset (bj, bi)

    def apply(self, jc, ic):
        M, b = self.M, self.b
        return (M[0][0] * jc + M[0][1] * ic + b[0],
                M[1][0] * jc + M[1][1] * ic + b[1])


def _edge_points(corners, t, e):
    """Corner-point sequence along edge e of tile t, in canonical param order
    (W/E: increasing jc; S/N: increasing ic)."""
    if e == "W":
        return corners[t, :, 0]
    if e == "E":
        return corners[t, :, -1]
    if e == "S":
        return corners[t, 0, :]
    return corners[t, -1, :]


def match_edges(corners, tol=1e-9):
    """Find the 12 inter-tile contacts by matching edge endpoint coordinates.

    Returns {(tile, edge): (ntile, nedge, reversed)}.
    """
    ntiles, npx = corners.shape[0], corners.shape[1]
    out = {}
    for t in range(ntiles):
        for e in EDGES:
            pts = _edge_points(corners, t, e)
            found = None
            for t2 in range(ntiles):
                if t2 == t:
                    continue
                for e2 in EDGES:
                    pts2 = _edge_points(corners, t2, e2)
                    if (np.linalg.norm(pts2[0] - pts[0]) < tol
                            and np.linalg.norm(pts2[-1] - pts[-1]) < tol):
                        found = (t2, e2, False)
                    elif (np.linalg.norm(pts2[-1] - pts[0]) < tol
                            and np.linalg.norm(pts2[0] - pts[-1]) < tol):
                        found = (t2, e2, True)
                    if found and np.max(np.linalg.norm(
                            (pts2[::-1] if found[2] else pts2) - pts, axis=-1)) > tol:
                        raise ValueError(
                            f"edge {t},{e} endpoints match {t2},{e2} but interior "
                            "points do not — grids are not edge-aligned")
                    if found:
                        break
                if found:
                    break
            if found is None:
                raise ValueError(f"no matching edge found for tile {t} edge {e}")
            out[(t, e)] = found
    return out


def _contact_from_match(n, edge, nedge, reverse):
    """Affine corner map for halo points beyond `edge`, into the neighbor.

    A corner point beyond edge at depth d (d >= 0: d=0 is ON the edge) and
    canonical edge-param s maps to the neighbor point at depth d inside from
    its edge `nedge` at param s' (= s, or n - s if reversed).
    Local coords of a beyond-W point: (jc=s, ic=-d); beyond-E: (s, n+d);
    beyond-S: (-d, s); beyond-N: (n+d, s).
    Neighbor coords at depth d from its edge: W: (s', d); E: (s', n-d);
    S: (d, s'); N: (n-d, s').
    """
    # Express (d, s) as affine functions of local (jc, ic):
    if edge == "W":
        d_row, d_off = (0, -1), 0          # d = -ic
        s_row, s_off = (1, 0), 0           # s = jc
    elif edge == "E":
        d_row, d_off = (0, 1), -n          # d = ic - n
        s_row, s_off = (1, 0), 0
    elif edge == "S":
        d_row, d_off = (-1, 0), 0          # d = -jc
        s_row, s_off = (0, 1), 0           # s = ic
    else:  # N
        d_row, d_off = (1, 0), -n          # d = jc - n
        s_row, s_off = (0, 1), 0
    if reverse:
        s_row, s_off = (-s_row[0], -s_row[1]), n - s_off
    # Neighbor coords as affine functions of (d, s):
    def lin(coef_d, coef_s, off):
        return ((coef_d * d_row[0] + coef_s * s_row[0],
                 coef_d * d_row[1] + coef_s * s_row[1]),
                coef_d * d_off + coef_s * s_off + off)
    if nedge == "W":
        (jr, joff), (ir, ioff) = lin(0, 1, 0), lin(1, 0, 0)      # (s', d)
    elif nedge == "E":
        (jr, joff), (ir, ioff) = lin(0, 1, 0), lin(-1, 0, n)     # (s', n-d)
    elif nedge == "S":
        (jr, joff), (ir, ioff) = lin(1, 0, 0), lin(0, 1, 0)      # (d, s')
    else:  # N
        (jr, joff), (ir, ioff) = lin(-1, 0, n), lin(0, 1, 0)     # (n-d, s')
    return (jr, ir), (joff, ioff)


class CubeTopology:
    """Topology of an edge-aligned multi-tile grid (the 6-tile cube)."""

    def __init__(self, corners, tol=1e-9):
        self.ntiles = corners.shape[0]
        self.n = corners.shape[1] - 1
        matches = match_edges(corners, tol)
        self.contacts = {}
        for (t, e), (t2, e2, rev) in matches.items():
            M, b = _contact_from_match(self.n, e, e2, rev)
            self.contacts[(t, e)] = EdgeContact(t2, M, b)
        self._validate(corners, tol)

    def _validate(self, corners, tol):
        n = self.n
        for (t, e), c in self.contacts.items():
            # check a beyond-edge point of depth 0 (on the edge) maps to the
            # same physical coordinate on the neighbor
            for s in (0, 1, n // 2, n):
                if e == "W":
                    jc, ic = s, 0
                elif e == "E":
                    jc, ic = s, n
                elif e == "S":
                    jc, ic = 0, s
                else:
                    jc, ic = n, s
                jc2, ic2 = c.apply(jc, ic)
                assert 0 <= jc2 <= n and 0 <= ic2 <= n, (t, e, s, jc2, ic2)
                d = np.linalg.norm(corners[t, jc, ic] - corners[c.tile, jc2, ic2])
                assert d < 10 * tol, (t, e, s, d)

    # ------------------------------------------------------------------
    # Halo gather specs. Each returns numpy int32 index arrays addressing the
    # *unpadded* source arrays, plus (for vectors) component/sign arrays.
    # ------------------------------------------------------------------

    def cell_halo_spec(self, h):
        """Gather spec for cell-centered scalars.

        Returns (tidx, jidx, iidx, valid) of shape [ntiles, n+2h, n+2h]:
        padded[t, jp, ip] = q[tidx, jidx, iidx]; `valid` False on the h x h
        corner blocks (left as clamped self-indices there).
        """
        n, P = self.n, self.n + 2 * h
        tidx = np.empty((self.ntiles, P, P), np.int32)
        jidx = np.empty_like(tidx)
        iidx = np.empty_like(tidx)
        valid = np.ones((self.ntiles, P, P), bool)
        jp, ip = np.meshgrid(np.arange(P), np.arange(P), indexing="ij")
        j0, i0 = jp - h, ip - h      # local cell coords, may be out of range
        for t in range(self.ntiles):
            tt = np.full((P, P), t, np.int32)
            jj = np.clip(j0, 0, n - 1).astype(np.int32)
            ii = np.clip(i0, 0, n - 1).astype(np.int32)
            in_j = (j0 >= 0) & (j0 < n)
            in_i = (i0 >= 0) & (i0 < n)
            for e, sel in (("W", in_j & (i0 < 0)), ("E", in_j & (i0 >= n)),
                           ("S", in_i & (j0 < 0)), ("N", in_i & (j0 >= n))):
                c = self.contacts[(t, e)]
                j2, i2 = self._map_cells(c, j0[sel], i0[sel])
                tt[sel], jj[sel], ii[sel] = c.tile, j2, i2
            corner = ~(in_j | in_i)
            valid[t] = ~corner
            tidx[t], jidx[t], iidx[t] = tt, jj, ii
        return tidx, jidx, iidx, valid

    def _map_cells(self, c, j, i):
        """Map out-of-range local cell coords through a contact.

        A cell (j, i) spans corners (j, i) and (j+1, i+1); the neighbor cell
        index is the componentwise min of the two mapped corners.
        """
        a = np.stack(c.apply(j, i))
        b = np.stack(c.apply(j + 1, i + 1))
        cell = np.minimum(a, b)
        n = self.n
        assert cell.min() >= 0 and cell.max() <= n - 1, "halo deeper than tile"
        return cell[0].astype(np.int32), cell[1].astype(np.int32)

    def corner_halo_spec(self, h):
        """Gather spec for corner-point (B-grid) scalars, shape
        [ntiles, n+1+2h, n+1+2h]. On-edge points map to self."""
        n, P = self.n, self.n + 1 + 2 * h
        tidx = np.empty((self.ntiles, P, P), np.int32)
        jidx = np.empty_like(tidx)
        iidx = np.empty_like(tidx)
        valid = np.ones((self.ntiles, P, P), bool)
        jp, ip = np.meshgrid(np.arange(P), np.arange(P), indexing="ij")
        j0, i0 = jp - h, ip - h
        for t in range(self.ntiles):
            tt = np.full((P, P), t, np.int32)
            jj = np.clip(j0, 0, n).astype(np.int32)
            ii = np.clip(i0, 0, n).astype(np.int32)
            in_j = (j0 >= 0) & (j0 <= n)
            in_i = (i0 >= 0) & (i0 <= n)
            for e, sel in (("W", in_j & (i0 < 0)), ("E", in_j & (i0 > n)),
                           ("S", in_i & (j0 < 0)), ("N", in_i & (j0 > n))):
                c = self.contacts[(t, e)]
                j2, i2 = c.apply(j0[sel], i0[sel])
                assert j2.min() >= 0 and j2.max() <= n
                tt[sel], jj[sel], ii[sel] = c.tile, j2, i2
            corner = ~(in_j | in_i)
            valid[t] = ~corner
            tidx[t], jidx[t], iidx[t] = tt, jj, ii
        return tidx, jidx, iidx, valid

    def _map_wall(self, c, p0, p1, dcomp):
        """Map a wall (edge between corner points p0 -> p1, a unit step)
        through contact c. Returns (is_ywall', j', i', sign): is_ywall' True
        if the image is a y-wall (hosts neighbor u/vc), False if x-wall
        (v/uc). `dcomp` is the unit index step of the wind COMPONENT
        direction ((0,1) for x-winds u/uc, (1,0) for y-winds v/vc); the sign
        is +1 if the mapped component direction is along the neighbor's
        +axis. For D-grid winds dcomp equals the segment direction; for
        C-grid winds it is normal to it."""
        a0 = np.stack(c.apply(p0[0], p0[1]))
        a1 = np.stack(c.apply(p1[0], p1[1]))
        dj, di = a1[0] - a0[0], a1[1] - a0[1]
        # exactly one of dj, di is +-1 (elementwise)
        is_yw = np.abs(di) == 1          # segment along neighbor x => y-wall
        jw = np.where(is_yw, a0[0], np.minimum(a0[0], a1[0]))
        iw = np.where(is_yw, np.minimum(a0[1], a1[1]), a0[1])
        ac = np.stack(c.apply(p0[0] + dcomp[0], p0[1] + dcomp[1]))
        cj, ci = ac[0] - a0[0], ac[1] - a0[1]
        sign = np.where(np.abs(ci) == 1, ci, cj)
        return is_yw, jw.astype(np.int32), iw.astype(np.int32), sign.astype(np.int32)

    def vector_halo_spec(self, h, grid="D"):
        """Gather spec for staggered vector halos.

        D grid: u on y-walls [n+1, n], v on x-walls [n, n+1].
        C grid: uc on x-walls [n, n+1], vc on y-walls [n+1, n].
        Padded shapes: y-wall comp [n+1+2h, n+2h], x-wall comp [n+2h, n+1+2h].

        Returns dict with, for each output component ('u','v'), arrays
        (comp, tidx, jidx, iidx, sign, valid): comp 0 selects the neighbor's
        y-wall field, 1 the x-wall field. For grid="D" the y-wall field is u;
        for grid="C" it is vc.
        """
        n = self.n
        specs = {}
        for name in ("u", "v"):
            ywall_out = (name == "u") if grid == "D" else (name == "v")
            # u/uc are x-winds, v/vc are y-winds (component index step):
            dcomp = (0, 1) if name == "u" else (1, 0)
            if ywall_out:
                PJ, PI = n + 1 + 2 * h, n + 2 * h
                j0 = np.arange(PJ)[:, None] - h + np.zeros((1, PI), int)
                i0 = np.arange(PI)[None, :] - h + np.zeros((PJ, 1), int)
                on_j = (j0 >= 0) & (j0 <= n)      # corner-row index range
                on_i = (i0 >= 0) & (i0 < n)       # cell-col index range
                # wall from corner (j, i) to (j, i+1): direction +x
                P0 = (j0, i0)
                P1 = (j0, i0 + 1)
                jcl, icl = np.clip(j0, 0, n), np.clip(i0, 0, n - 1)
            else:
                PJ, PI = n + 2 * h, n + 1 + 2 * h
                j0 = np.arange(PJ)[:, None] - h + np.zeros((1, PI), int)
                i0 = np.arange(PI)[None, :] - h + np.zeros((PJ, 1), int)
                on_j = (j0 >= 0) & (j0 < n)
                on_i = (i0 >= 0) & (i0 <= n)
                # wall from corner (j, i) to (j+1, i): direction +y
                P0 = (j0, i0)
                P1 = (j0 + 1, i0)
                jcl, icl = np.clip(j0, 0, n - 1), np.clip(i0, 0, n)
            comp = np.zeros((self.ntiles, PJ, PI), np.int32)
            comp[:] = 0 if ywall_out else 1
            tidx = np.empty((self.ntiles, PJ, PI), np.int32)
            jidx = np.empty_like(tidx)
            iidx = np.empty_like(tidx)
            sign = np.ones_like(tidx)
            valid = np.ones((self.ntiles, PJ, PI), bool)
            for t in range(self.ntiles):
                tt = np.full((PJ, PI), t, np.int32)
                jj = jcl.astype(np.int32).copy()
                ii = icl.astype(np.int32).copy()
                cc = comp[t].copy()
                ss = np.ones((PJ, PI), np.int32)
                # halo strips (excluding corner blocks)
                for e, sel in (("W", on_j & (i0 < 0)), ("E", on_j & (i0 > (n - 1 if ywall_out else n))),
                               ("S", on_i & (j0 < 0)), ("N", on_i & (j0 > (n if ywall_out else n - 1)))):
                    if not sel.any():
                        continue
                    c = self.contacts[(t, e)]
                    p0 = (P0[0][sel], P0[1][sel])
                    p1 = (P1[0][sel], P1[1][sel])
                    is_yw, jw, iw, sg = self._map_wall(c, p0, p1, dcomp)
                    tt[sel] = c.tile
                    jj[sel], ii[sel] = jw, iw
                    cc[sel] = np.where(is_yw, 0, 1)
                    ss[sel] = sg
                corner = ~(on_j | on_i)
                valid[t] = ~corner
                tidx[t], jidx[t], iidx[t], comp[t], sign[t] = tt, jj, ii, cc, ss
            specs[name] = dict(comp=comp, tidx=tidx, jidx=jidx, iidx=iidx,
                               sign=sign, valid=valid)
        return specs


    def dgrid_edge_owner_spec(self):
        """Owner-copy spec for the duplicated D-wind walls on tile N/E edges.

        Every cube contact pairs an {E,N} edge with a {W,S} edge (the W/S side
        owns the shared wall, the FMS mpp_get_boundary convention that
        dyn_core.F90:1152-1170 uses to 'prevent accumulation of rounding
        errors at overlapped domain edges'). Returns dict with, for each
        tile's N-edge u row and E-edge v col, (comp [6,n], tidx, jidx, iidx,
        sign): comp 0 = neighbor u, 1 = neighbor v.
        """
        n = self.n
        out = {}
        seg = np.arange(n)
        # N edge u row: wall from corner (n, i) to (n, i+1), x-component
        c = {t: self.contacts[(t, "N")] for t in range(self.ntiles)}
        comp = np.empty((self.ntiles, n), np.int32)
        tidx = np.empty_like(comp)
        jidx = np.empty_like(comp)
        iidx = np.empty_like(comp)
        sign = np.empty_like(comp)
        for t in range(self.ntiles):
            is_yw, jw, iw, sg = self._map_wall(
                c[t], (np.full(n, n), seg), (np.full(n, n), seg + 1), (0, 1))
            comp[t] = np.where(is_yw, 0, 1)
            tidx[t] = c[t].tile
            jidx[t], iidx[t], sign[t] = jw, iw, sg
        out["u_n"] = (comp, tidx, jidx, iidx, sign)
        # E edge v col: wall from corner (j, n) to (j+1, n), y-component
        c = {t: self.contacts[(t, "E")] for t in range(self.ntiles)}
        comp = np.empty((self.ntiles, n), np.int32)
        tidx = np.empty_like(comp)
        jidx = np.empty_like(comp)
        iidx = np.empty_like(comp)
        sign = np.empty_like(comp)
        for t in range(self.ntiles):
            is_yw, jw, iw, sg = self._map_wall(
                c[t], (seg, np.full(n, n)), (seg + 1, np.full(n, n)), (1, 0))
            comp[t] = np.where(is_yw, 0, 1)
            tidx[t] = c[t].tile
            jidx[t], iidx[t], sign[t] = jw, iw, sg
        out["v_e"] = (comp, tidx, jidx, iidx, sign)
        return out


@lru_cache(maxsize=8)
def cube_topology(npx, shift_fac=18.0):
    """Build (and cache) the topology for an npx-corner gnomonic cube."""
    from .gnomonic import gnomonic_cube_corners
    return CubeTopology(gnomonic_cube_corners(npx, shift_fac))
