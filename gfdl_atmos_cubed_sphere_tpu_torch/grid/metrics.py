"""Grid metric terms for the cubed sphere (host-side numpy, float64).

Re-derives the full ``fv_grid_type`` metric inventory
(FV3 model/fv_arrays.F90:75-205) following the reference
computations in FV3 tools/fv_grid_tools.F90:444-2256 (init_grid,
grid_area) and FV3 model/fv_grid_utils.F90:84-700
(grid_utils_init, edge_factors, efactor_a2c_v, init_cubed_to_latlon).

Strategy difference vs the reference: instead of MPI halo exchanges of metric
arrays, every tile's metrics are computed directly on a halo-EXTENDED corner
array (neighbor tile corners gathered through the numerically derived
topology), which yields identical values because the formulas only consume
corner coordinates. Tile-edge special formulas (one-sided vectors, doubled
dxc/dyc, half/triangle area_c) are applied with masks at the true tile edges.

Array layout (0-based, n = cells per side, halo ``hg``):
  cell arrays    [6, n+2hg,   n+2hg]     e.g. area, dxa, sin_sg[..., 9]
  corner arrays  [6, n+1+2hg, n+1+2hg]   e.g. area_c, cosa, sina
  y-wall arrays  [6, n+1+2hg, n+2hg]     e.g. dx, dyc, sina_v, divg_u (u pos)
  x-wall arrays  [6, n+2hg,   n+1+2hg]   e.g. dy, dxc, sina_u, divg_v (v pos)
Cube-corner halo blocks hold garbage (reference poisons them too,
fv_grid_utils.F90:568-575); kernels must not consume them.
"""

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Optional

import numpy as np

from .. import constants as con
from .gnomonic import (gnomonic_cube_corners, xyz_to_lonlat, lonlat_to_xyz,
                       normalize, great_circle_angle)
from .topology import CubeTopology

BIG = 1.0e8      # reference big_number poison (fv_grid_utils.F90:51)
TINY = 1.0e-30


def _mid(p, q):
    """Great-circle midpoint of unit vectors (mid_pt3_cart)."""
    return normalize(p + q)


def _cross(a, b):
    return np.cross(a, b)


def _dot(a, b):
    return np.sum(a * b, axis=-1)


def _cos_angle(p1, p2, p3):
    """cos of spherical angle at p1 between p2 and p3
    (fv_grid_utils.F90 cos_angle)."""
    p = _cross(p1, p2)
    q = _cross(p1, p3)
    ddd = np.sqrt(np.sum(p * p, axis=-1) * np.sum(q * q, axis=-1))
    out = np.where(ddd > 0.0, _dot(p, q) / np.where(ddd > 0, ddd, 1.0), 1.0)
    return out


def _sph_angle(p1, p2, p3):
    """Spherical angle at p1 between p2 and p3 (radians)."""
    return np.arccos(np.clip(_cos_angle(p1, p2, p3), -1.0, 1.0))


def _quad_area(sw, se, ne, nw):
    """Spherical excess of the quad (unit sphere). get_area with
    (p1,p2,p3,p4) = (sw,se,ne,nw) per fv_grid_utils.F90:2682-2723."""
    a1 = _sph_angle(sw, se, nw)
    a2 = _sph_angle(se, ne, sw)
    a3 = _sph_angle(ne, nw, se)
    a4 = _sph_angle(nw, ne, sw)
    return a1 + a2 + a3 + a4 - 2.0 * np.pi


def _tri_area(p1, p2, p3):
    """Spherical triangle excess (get_area_tri)."""
    return (_sph_angle(p1, p2, p3) + _sph_angle(p2, p3, p1)
            + _sph_angle(p3, p1, p2) - np.pi)


def _unit_vect_latlon(lon, lat):
    """Local east/north unit vectors at (lon, lat)."""
    sl, cl = np.sin(lon), np.cos(lon)
    st, ct = np.sin(lat), np.cos(lat)
    elon = np.stack([-sl, cl, np.zeros_like(sl)], axis=-1)
    elat = np.stack([-st * cl, -st * sl, ct], axis=-1)
    return elon, elat


@dataclass
class GridGeometry:
    """All precomputed metric terms, numpy float64, global-cube layout."""
    npx: int
    n: int
    ng: int
    radius: float
    omega: float
    topology: CubeTopology
    arrays: dict = field(default_factory=dict)
    da_min: float = 0.0
    da_max: float = 0.0
    da_min_c: float = 0.0
    da_max_c: float = 0.0
    global_area: float = 0.0

    def __getattr__(self, name):
        try:
            return self.arrays[name]
        except KeyError:
            raise AttributeError(name)

    def interior(self, name):
        """Compute-domain view of a stored (halo-padded) array."""
        a = self.arrays[name]
        h, n = self.ng, self.n
        nj = a.shape[1] - 2 * h
        ni = a.shape[2] - 2 * h
        return a[:, h:h + nj, h:h + ni]


def build_grid_geometry(npx, ng=3, radius=con.RADIUS, omega=con.OMEGA,
                        shift_fac=18.0, coriolis_alpha=0.0,
                        stretch_fac=None, target_lon=0.0, target_lat=0.0,
                        do_cube_transform=False):
    """Compute the full metric inventory for a gnomonic cube of npx corners.

    stretch_fac/target_lon/target_lat enable Schmidt grid refinement
    (fv_core_nml do_schmidt + stretch_fac/target_lon/target_lat,
    fv_grid_utils.F90 direct_transform:802); do_cube_transform selects the
    revised cube_transform (:863). Angles in radians."""
    n = npx - 1
    hg = ng                    # stored halo
    hx = ng + 1                # computation halo (cells)
    hc = hx + 1                # corner gather halo
    corners = gnomonic_cube_corners(npx, shift_fac)     # [6, npx, npx, 3]
    if stretch_fac is not None and abs(stretch_fac - 1.0) > 0.0:
        from .gnomonic import schmidt_transform
        corners = schmidt_transform(corners, stretch_fac, target_lon,
                                    target_lat, revised=do_cube_transform)
    topo = CubeTopology(corners)

    # ---- extended corner coordinates via topology gather -------------
    tix, jix, iix, valid = topo.corner_halo_spec(hc)
    g = corners[tix, jix, iix]                          # [6, Nc, Nc, 3]
    g[~valid] = np.nan                                   # poison corner blocks
    Nc = n + 1 + 2 * hc

    # helper views: position (0,0) of a view = local corner/cell (-hx, -hx)
    ncc = n + 2 * hx            # cells in computation domain
    ncp = ncc + 1               # corners in computation domain

    def cg(dj, di, nj=ncp, ni=ncp):
        o = hc - hx
        return g[:, o + dj:o + dj + nj, o + di:o + di + ni]

    err = np.seterr(all="ignore")  # NaN poison propagates by design

    # ---- cell centers (agrid), cell_center2 = normalized corner mean ---
    c00 = cg(0, 0, ncc, ncc)
    c01 = cg(0, 1, ncc, ncc)
    c10 = cg(1, 0, ncc, ncc)
    c11 = cg(1, 1, ncc, ncc)
    agrid = normalize(c00 + c01 + c10 + c11)
    aglon, aglat = xyz_to_lonlat(agrid)

    R = radius

    # ---- edge lengths ------------------------------------------------
    dx = great_circle_angle(cg(0, 0, ncp, ncc), cg(0, 1, ncp, ncc)) * R   # y-wall
    dy = great_circle_angle(cg(0, 0, ncc, ncp), cg(1, 0, ncc, ncp)) * R   # x-wall

    # dxa/dya: distances between cell-wall midpoints (fv_grid_tools.F90:816-828)
    mid_w = _mid(c00, c10)      # west wall midpoint of each cell
    mid_e = _mid(c01, c11)
    mid_s = _mid(c00, c01)
    mid_n = _mid(c10, c11)
    dxa = great_circle_angle(mid_w, mid_e) * R
    dya = great_circle_angle(mid_s, mid_n) * R

    # ---- dxc / dyc (C-grid center-to-center), edge-doubled -------------
    # dxc on x-walls: dist(agrid(j,i-1), agrid(j,i)); local wall index i in
    # [-hg, n+hg], needs agrid cells one beyond => computed at hx then cropped.
    dxc = np.full((6, ncc, ncp - 2), np.nan)
    dxc[:, :, :] = great_circle_angle(agrid[:, :, :-1], agrid[:, :, 1:]) * R
    # pad one wall on each side by edge-clamp later at crop; compute full:
    dxc_full = np.full((6, ncc, ncp), np.nan)
    dxc_full[:, :, 1:-1] = dxc
    dxc_full[:, :, 0] = dxc_full[:, :, 1]
    dxc_full[:, :, -1] = dxc_full[:, :, -2]
    # tile edge walls (local i=0 and i=n): 2*dist(wall midpoint, agrid)
    iW = hx                    # view col index of local wall i=0
    iE = hx + n
    wmidW = _mid(cg(0, 0, ncc, ncp), cg(1, 0, ncc, ncp))[:, :, iW]
    wmidE = _mid(cg(0, 0, ncc, ncp), cg(1, 0, ncc, ncp))[:, :, iE]
    dxc_full[:, :, iW] = 2.0 * great_circle_angle(wmidW, agrid[:, :, iW]) * R
    dxc_full[:, :, iE] = 2.0 * great_circle_angle(agrid[:, :, iE - 1], wmidE) * R
    dxc = dxc_full

    dyc = np.full((6, ncp, ncc), np.nan)
    dyc[:, 1:-1, :] = great_circle_angle(agrid[:, :-1, :], agrid[:, 1:, :]) * R
    dyc[:, 0, :] = dyc[:, 1, :]
    dyc[:, -1, :] = dyc[:, -2, :]
    jS = hx
    jN = hx + n
    smidS = _mid(cg(0, 0, ncp, ncc), cg(0, 1, ncp, ncc))[:, jS, :]
    smidN = _mid(cg(0, 0, ncp, ncc), cg(0, 1, ncp, ncc))[:, jN, :]
    dyc[:, jS, :] = 2.0 * great_circle_angle(smidS, agrid[:, jS, :]) * R
    dyc[:, jN, :] = 2.0 * great_circle_angle(agrid[:, jN - 1, :], smidN) * R

    # ---- areas ---------------------------------------------------------
    area = _quad_area(c00, c01, c11, c10) * R * R
    # area_c: dual cell around each corner = quad of 4 agrid points
    area_c = np.full((6, ncp, ncp), np.nan)
    area_c[:, 1:-1, 1:-1] = _quad_area(
        agrid[:, :-1, :-1], agrid[:, :-1, 1:], agrid[:, 1:, 1:], agrid[:, 1:, :-1]
    ) * R * R
    # tile-edge rows/cols: 2 * half-quad (fv_grid_tools.F90:884-934)
    ymid = _mid(cg(0, 0, ncp, ncp - 1), cg(0, 1, ncp, ncp - 1))   # mids of y-dir wall? (corner row j, between corner cols)
    xmid = _mid(cg(0, 0, ncp - 1, ncp), cg(1, 0, ncp - 1, ncp))   # mids along x-walls (corner col i)
    # west edge (local i=0 => view col iW), corner rows j in [1, n-1]:
    jj = np.arange(1, ncp - 1)
    # p1 = mid(grid(i,j-1), grid(i,j)); p4 = mid(grid(i,j),grid(i,j+1))
    p1 = xmid[:, jj - 1, iW]
    p4 = xmid[:, jj, iW]
    p2 = agrid[:, jj - 1, iW]
    p3 = agrid[:, jj, iW]
    area_c[:, 1:-1, iW] = 2.0 * _quad_area(p1, p2, p3, p4) * R * R
    p1 = agrid[:, jj - 1, iE - 1]
    p2 = xmid[:, jj - 1, iE]
    p3 = xmid[:, jj, iE]
    p4 = agrid[:, jj, iE - 1]
    area_c[:, 1:-1, iE] = 2.0 * _quad_area(p1, p2, p3, p4) * R * R
    ii = np.arange(1, ncp - 1)
    p1 = ymid[:, jS, ii - 1]
    p2 = ymid[:, jS, ii]
    p3 = agrid[:, jS, ii]
    p4 = agrid[:, jS, ii - 1]
    area_c[:, jS, 1:-1] = 2.0 * _quad_area(p1, p2, p3, p4) * R * R
    p1 = agrid[:, jN - 1, ii - 1]
    p2 = agrid[:, jN - 1, ii]
    p3 = ymid[:, jN, ii]
    p4 = ymid[:, jN, ii - 1]
    area_c[:, jN, 1:-1] = 2.0 * _quad_area(p1, p2, p3, p4) * R * R
    # cube corners: triangle of the 3 surrounding cell centers
    # SW corner point (0,0): agrid(-1,0), agrid(0,0), agrid(0,-1)
    ix0, ix1 = hx, hx - 1        # cell view indices for local cells 0 and -1
    ie1, ie0 = hx + n - 1, hx + n    # cells n-1 and n (beyond-edge)
    area_c[:, jS, iW] = _tri_area(agrid[:, ix1, ix0], agrid[:, ix0, ix0],
                                  agrid[:, ix0, ix1]) * R * R
    area_c[:, jS, iE] = _tri_area(agrid[:, ix0, ie0], agrid[:, ix0, ie1],
                                  agrid[:, ix1, ie1]) * R * R
    area_c[:, jN, iE] = _tri_area(agrid[:, ie1, ie0], agrid[:, ie1, ie1],
                                  agrid[:, ie0, ie1]) * R * R
    area_c[:, jN, iW] = _tri_area(agrid[:, ie0, ix0], agrid[:, ie1, ix0],
                                  agrid[:, ie1, ix1]) * R * R

    # ---- supergrid angles (fv_grid_utils.F90:327-366) -------------------
    cos_sg = np.full((6, ncc, ncc, 9), np.nan)
    cos_sg[..., 5] = _cos_angle(c00, c01, c10)           # sg6: SW corner
    cos_sg[..., 6] = -_cos_angle(c01, c00, c11)          # sg7: SE
    cos_sg[..., 7] = _cos_angle(c11, c01, c10)           # sg8: NE
    cos_sg[..., 8] = -_cos_angle(c10, c00, c11)          # sg9: NW
    cos_sg[..., 0] = _cos_angle(mid_w, agrid, c10)       # sg1: W edge mid
    cos_sg[..., 1] = _cos_angle(mid_s, c01, agrid)       # sg2: S edge mid
    cos_sg[..., 2] = _cos_angle(mid_e, agrid, c01)       # sg3: E edge mid
    cos_sg[..., 3] = _cos_angle(mid_n, c10, agrid)       # sg4: N edge mid

    # ---- cell-center unit vectors ec1/ec2 (get_center_vect) -------------
    pc = agrid
    p3v = _cross(mid_e, mid_w)
    ec1 = normalize(_cross(pc, p3v))
    p3v = _cross(mid_n, mid_s)
    ec2 = normalize(_cross(pc, p3v))
    cos_sg[..., 4] = _dot(ec1, ec2)                      # sg5: center
    sin_sg = np.minimum(1.0, np.sqrt(np.maximum(0.0, 1.0 - cos_sg ** 2)))

    # corner-region transport patches (fv_grid_utils.F90:577-632):
    # fill specific sin/cos_sg components inside the corner halo blocks from
    # transposed in-tile values. Local coords: cells 0..n-1; halo cells <0, >=n.
    def V(j, i):          # view indices from local cell coords
        return hx + j, hx + i
    for d in range(0, min(3, hx)):      # reference patches depth 0..2
        # sw_corner: sin_sg(0,-d,3) = sin_sg(-d,1,2) etc. (1-based f code:
        # do i=0,-2,-1: sin_sg(0,i,3)=sin_sg(i,1,2); sin_sg(i,0,4)=sin_sg(1,i,1))
        # 0-based: sin_sg[j=-1-d, i=-1][comp3->idx2] = sin_sg[j=0, i=-1-d... ]
        # Translate exactly from 1-based: (i,j) f -> (i-1, j-1) 0-based.
        fi = -d             # f index i in {0,-1,-2}
        # SW: sg3 at (0, fi) <- sg2 at (fi, 1); sg4 at (fi, 0) <- sg1 at (1, fi)
        j1, i1 = V(fi - 1, -1)
        j2, i2 = V(0, fi - 1)
        cos_sg[:, j1, i1, 2] = cos_sg[:, j2, i2, 1]
        sin_sg[:, j1, i1, 2] = sin_sg[:, j2, i2, 1]
        j1, i1 = V(-1, fi - 1)
        j2, i2 = V(fi - 1, 0)
        cos_sg[:, j1, i1, 3] = cos_sg[:, j2, i2, 0]
        sin_sg[:, j1, i1, 3] = sin_sg[:, j2, i2, 0]
        # NW: sg3 at (npy+d, 0 f) ... f: sin_sg(0,i,3)=sin_sg(npy-i,npy-1,4), i=npy..npy+2
        fiN = npx + d       # f index npy..npy+2 (npy==npx)
        j1, i1 = V(fiN - 1, -1)
        j2, i2 = V(npx - 2, npx - fiN - 1)
        cos_sg[:, j1, i1, 2] = cos_sg[:, j2, i2, 3]
        sin_sg[:, j1, i1, 2] = sin_sg[:, j2, i2, 3]
        # f: sin_sg(i,npy,2)=sin_sg(1,npy-i,1), i=0,-1,-2
        j1, i1 = V(npx - 1, fi - 1)
        j2, i2 = V(npx - fi - 1, 0)
        cos_sg[:, j1, i1, 1] = cos_sg[:, j2, i2, 0]
        sin_sg[:, j1, i1, 1] = sin_sg[:, j2, i2, 0]
        # SE: f: sin_sg(npx,j,1)=sin_sg(npx-j,1,2), j=0,-1,-2
        j1, i1 = V(fi - 1, npx - 1)
        j2, i2 = V(0, npx - fi - 1)
        cos_sg[:, j1, i1, 0] = cos_sg[:, j2, i2, 1]
        sin_sg[:, j1, i1, 0] = sin_sg[:, j2, i2, 1]
        # f: sin_sg(i,0,4)=sin_sg(npx-1,npx-i,3), i=npx..npx+2
        j1, i1 = V(-1, fiN - 1)
        j2, i2 = V(npx - fiN - 1, npx - 2)
        cos_sg[:, j1, i1, 3] = cos_sg[:, j2, i2, 2]
        sin_sg[:, j1, i1, 3] = sin_sg[:, j2, i2, 2]
        # NE: f: sin_sg(npx,npy+i,1)=sin_sg(npx+i,npy-1,4), i=0..2
        j1, i1 = V(npx + d - 1, npx - 1)
        j2, i2 = V(npx - 2, npx + d - 1)
        cos_sg[:, j1, i1, 0] = cos_sg[:, j2, i2, 3]
        sin_sg[:, j1, i1, 0] = sin_sg[:, j2, i2, 3]
        # f: sin_sg(npx+i,npy,2)=sin_sg(npx-1,npy+i,3)
        j1, i1 = V(npx - 1, npx + d - 1)
        j2, i2 = V(npx + d - 1, npx - 2)
        cos_sg[:, j1, i1, 1] = cos_sg[:, j2, i2, 2]
        sin_sg[:, j1, i1, 1] = sin_sg[:, j2, i2, 2]

    # ---- B-point (corner) angles (fv_grid_utils.F90:491-495) ------------
    cosa = np.full((6, ncp, ncp), np.nan)
    sina = np.full((6, ncp, ncp), np.nan)
    cosa[:, 1:-1, 1:-1] = 0.5 * (cos_sg[:, :-1, :-1, 7] + cos_sg[:, 1:, 1:, 5])
    sina[:, 1:-1, 1:-1] = 0.5 * (sin_sg[:, :-1, :-1, 7] + sin_sg[:, 1:, 1:, 5])
    rsina = 1.0 / np.maximum(TINY, sina ** 2)
    # poison tile-edge B points (reference rsina=big_number there)
    rsina[:, jS, :] = BIG
    rsina[:, jN, :] = BIG
    rsina[:, :, iW] = BIG
    rsina[:, :, iE] = BIG

    # ---- wall angles ----------------------------------------------------
    # x-wall (C-grid u position): cosa_u(i,j)=0.5*(cos_sg(i-1,j,3)+cos_sg(i,j,1))
    cosa_u = np.full((6, ncc, ncp), np.nan)
    sina_u = np.full((6, ncc, ncp), np.nan)
    cosa_u[:, :, 1:-1] = 0.5 * (cos_sg[:, :, :-1, 2] + cos_sg[:, :, 1:, 0])
    sina_u[:, :, 1:-1] = 0.5 * (sin_sg[:, :, :-1, 2] + sin_sg[:, :, 1:, 0])
    rsin_u = 1.0 / np.maximum(TINY, sina_u ** 2)
    # tile W/E edge: rsin_u = 1/sina_u (not squared), fv_grid_utils.F90:545-551
    for icol in (iW, iE):
        s = sina_u[:, :, icol]
        rsin_u[:, :, icol] = 1.0 / np.sign(s) / np.maximum(TINY, np.abs(s))
    # y-wall (C-grid v position): cosa_v(i,j)=0.5*(cos_sg(i,j-1,4)+cos_sg(i,j,2))
    cosa_v = np.full((6, ncp, ncc), np.nan)
    sina_v = np.full((6, ncp, ncc), np.nan)
    cosa_v[:, 1:-1, :] = 0.5 * (cos_sg[:, :-1, :, 3] + cos_sg[:, 1:, :, 1])
    sina_v[:, 1:-1, :] = 0.5 * (sin_sg[:, :-1, :, 3] + sin_sg[:, 1:, :, 1])
    rsin_v = 1.0 / np.maximum(TINY, sina_v ** 2)
    for jrow in (jS, jN):
        s = sina_v[:, jrow, :]
        rsin_v[:, jrow, :] = 1.0 / np.sign(s) / np.maximum(TINY, np.abs(s))

    cosa_s = cos_sg[..., 4].copy()
    rsin2 = 1.0 / np.maximum(TINY, sin_sg[..., 4] ** 2)

    # ---- edge one-sided wall unit vectors ew/es (fv_grid_utils:265-320) --
    # ew on x-walls [ncc, ncp, 2, 3]; es on y-walls [ncp, ncc, 2, 3]
    wallx_mid = _mid(cg(0, 0, ncc, ncp), cg(1, 0, ncc, ncp))
    ew = np.full((6, ncc, ncp, 2, 3), np.nan)
    p2i = np.full((6, ncc, ncp, 3), np.nan)
    p2i[:, :, 1:-1] = _cross(agrid[:, :, :-1], agrid[:, :, 1:])
    p2i[:, :, iW] = _cross(wallx_mid[:, :, iW], agrid[:, :, iW])
    p2i[:, :, iE] = _cross(agrid[:, :, iE - 1], wallx_mid[:, :, iE])
    ew[..., 0, :] = normalize(_cross(p2i, wallx_mid))
    p1i = _cross(cg(0, 0, ncc, ncp), cg(1, 0, ncc, ncp))
    ew[..., 1, :] = normalize(_cross(p1i, wallx_mid))

    wally_mid = _mid(cg(0, 0, ncp, ncc), cg(0, 1, ncp, ncc))
    es = np.full((6, ncp, ncc, 2, 3), np.nan)
    p2i = np.full((6, ncp, ncc, 3), np.nan)
    p2i[:, 1:-1, :] = _cross(agrid[:, :-1, :], agrid[:, 1:, :])
    p2i[:, jS, :] = _cross(wally_mid[:, jS, :], agrid[:, jS, :])
    p2i[:, jN, :] = _cross(agrid[:, jN - 1, :], wally_mid[:, jN, :])
    es[..., 1, :] = normalize(_cross(p2i, wally_mid))
    p1i = _cross(cg(0, 0, ncp, ncc), cg(0, 1, ncp, ncc))
    es[..., 0, :] = normalize(_cross(p1i, wally_mid))

    # ---- B-point unit vectors ee1/ee2 (fv_grid_utils.F90:467-489) -------
    gcp = cg(0, 0, ncp, ncp)
    ee1 = np.full((6, ncp, ncp, 3), np.nan)
    ee2 = np.full((6, ncp, ncp, 3), np.nan)
    pp = np.empty_like(ee1)
    pp[:, :, 1:-1] = _cross(cg(0, -1, ncp, ncp - 2), cg(0, 1, ncp, ncp - 2))
    pp[:, :, iW] = _cross(gcp[:, :, iW], gcp[:, :, iW + 1])
    pp[:, :, iE] = _cross(gcp[:, :, iE - 1], gcp[:, :, iE])
    ee1[:] = normalize(_cross(pp, gcp))
    pp[:, 1:-1, :] = _cross(cg(-1, 0, ncp - 2, ncp), cg(1, 0, ncp - 2, ncp))
    pp[:, jS, :] = _cross(gcp[:, jS, :], gcp[:, jS + 1, :])
    pp[:, jN, :] = _cross(gcp[:, jN - 1, :], gcp[:, jN, :])
    ee2[:] = normalize(_cross(pp, gcp))

    # ---- en1/en2 (wall normal vectors, for omega) ------------------------
    en1 = normalize(_cross(cg(0, 0, ncp, ncc), cg(0, 1, ncp, ncc)))  # y-wall
    en2 = normalize(_cross(cg(1, 0, ncc, ncp), cg(0, 0, ncc, ncp)))  # x-wall

    # ---- divergence/del6 damping weights (fv_grid_utils.F90:636-661) -----
    divg_u = sina_v * dyc / dx        # y-wall
    del6_u = sina_v * dx / dyc
    divg_v = sina_u * dxc / dy        # x-wall
    del6_v = sina_u * dy / dxc
    # tile-edge overrides with sin_sg means
    ssum = 0.5 * (sin_sg[:, :, 1:, 0] + sin_sg[:, :, :-1, 2])   # x-wall interior est
    # j==1 / j==npy rows of divg_u use 0.5*(sin_sg(i,j,2)+sin_sg(i,j-1,4))
    for jrow, jc0, jc1 in ((jS, hx, hx - 1), (jN, hx + n, hx + n - 1)):
        s = 0.5 * (sin_sg[:, min(jc0, ncc - 1), :, 1] + sin_sg[:, jc1, :, 3])
        divg_u[:, jrow, :] = s * dyc[:, jrow, :] / dx[:, jrow, :]
        del6_u[:, jrow, :] = s * dx[:, jrow, :] / dyc[:, jrow, :]
    for icol, ic0, ic1 in ((iW, hx, hx - 1), (iE, hx + n, hx + n - 1)):
        s = 0.5 * (sin_sg[:, :, min(ic0, ncc - 1), 0] + sin_sg[:, :, ic1, 2])
        divg_v[:, :, icol] = s * dxc[:, :, icol] / dy[:, :, icol]
        del6_v[:, :, icol] = s * dy[:, :, icol] / dxc[:, :, icol]

    # ---- latlon <-> cube wind transforms (init_cubed_to_latlon) ----------
    vlon, vlat = _unit_vect_latlon(aglon, aglat)
    z11 = _dot(ec1, vlon)
    z12 = _dot(ec1, vlat)
    z21 = _dot(ec2, vlon)
    z22 = _dot(ec2, vlat)
    sin5 = np.maximum(TINY, sin_sg[..., 4])
    a11 = 0.5 * z22 / sin5
    a12 = -0.5 * z12 / sin5
    a21 = -0.5 * z21 / sin5
    a22 = 0.5 * z11 / sin5

    # ---- l2c factors (fv_grid_utils.F90:404-423) --------------------------
    # get_unit_vect2(p1,p2): unit vector at the midpoint pointing p1 -> p2
    def unit_vect2(p1, p2):
        pcm = _mid(p1, p2)
        p3 = _cross(p2, p1)
        return normalize(_cross(pcm, p3))
    exw, _ = _unit_vect_latlon(*xyz_to_lonlat(wallx_mid))
    latm = xyz_to_lonlat(wallx_mid)[1]
    l2c_v = np.cos(latm) * _dot(unit_vect2(cg(0, 0, ncc, ncp), cg(1, 0, ncc, ncp)), exw)
    exs, _ = _unit_vect_latlon(*xyz_to_lonlat(wally_mid))
    lats = xyz_to_lonlat(wally_mid)[1]
    l2c_u = np.cos(lats) * _dot(unit_vect2(cg(0, 0, ncp, ncc), cg(0, 1, ncp, ncc)), exs)

    # ---- A->B scalar edge factors (edge_factors) ---------------------------
    # stored per tile as 1-D arrays over corner index 0..n (valid 1..n-1)
    edge_w = np.full((6, n + 1), np.nan)
    edge_e = np.full((6, n + 1), np.nan)
    edge_s = np.full((6, n + 1), np.nan)
    edge_n = np.full((6, n + 1), np.nan)
    jcr = np.arange(1, n)
    pyw = _mid(agrid[:, :, hx - 1], agrid[:, :, hx])       # [6, ncc, 3] over cell rows
    d1 = great_circle_angle(pyw[:, hx + jcr - 1], gcp[:, hx + jcr, iW])
    d2 = great_circle_angle(pyw[:, hx + jcr], gcp[:, hx + jcr, iW])
    edge_w[:, 1:n] = d2 / (d1 + d2)
    pye = _mid(agrid[:, :, iE - 1], agrid[:, :, iE])
    d1 = great_circle_angle(pye[:, hx + jcr - 1], gcp[:, hx + jcr, iE])
    d2 = great_circle_angle(pye[:, hx + jcr], gcp[:, hx + jcr, iE])
    edge_e[:, 1:n] = d2 / (d1 + d2)
    pxs = _mid(agrid[:, hx - 1, :], agrid[:, hx, :])
    d1 = great_circle_angle(pxs[:, hx + jcr - 1], gcp[:, jS, hx + jcr])
    d2 = great_circle_angle(pxs[:, hx + jcr], gcp[:, jS, hx + jcr])
    edge_s[:, 1:n] = d2 / (d1 + d2)
    pxn = _mid(agrid[:, jN - 1, :], agrid[:, jN, :])
    d1 = great_circle_angle(pxn[:, hx + jcr - 1], gcp[:, jN, hx + jcr])
    d2 = great_circle_angle(pxn[:, hx + jcr], gcp[:, jN, hx + jcr])
    edge_n[:, 1:n] = d2 / (d1 + d2)

    # ---- A->C vector edge factors (efactor_a2c_v) --------------------------
    # per tile 1-D over cell index 0..n-1
    def evect(py_line, p2_line):
        # py_line: [6, ncells_ext, 3] midpoints across edge per cell (view at hx
        # offset); p2_line: wall mids on the edge per cell
        out = np.full((6, n), np.nan)
        jm2 = (npx - 1) // 2        # f im2; f j<=jm2 <=> 0-based j0 <= jm2-1
        for j0 in range(n):
            pv = py_line[:, hx + j0]
            pw = p2_line[:, hx + j0]
            if j0 + 1 <= jm2 - 0:   # f j = j0+1 <= jm2
                d1 = great_circle_angle(pv, pw)
                d2 = great_circle_angle(py_line[:, hx + j0 + 1], pw)
            else:
                d2 = great_circle_angle(py_line[:, hx + j0 - 1], pw)
                d1 = great_circle_angle(pv, pw)
            out[:, j0] = d1 / (d1 + d2)
        return out
    edge_vect_w = evect(pyw, wallx_mid[:, :, iW])
    edge_vect_e = evect(pye, wallx_mid[:, :, iE])
    edge_vect_s = evect(pxs, wally_mid[:, jS, :])
    edge_vect_n = evect(pxn, wally_mid[:, jN, :])

    # ---- Coriolis (default tilt alpha; test cases may override) -----------
    glon, glat = xyz_to_lonlat(gcp)
    fC = 2.0 * omega * (-np.cos(glon) * np.cos(glat) * np.sin(coriolis_alpha)
                        + np.sin(glat) * np.cos(coriolis_alpha))
    f0 = 2.0 * omega * (-np.cos(aglon) * np.cos(aglat) * np.sin(coriolis_alpha)
                        + np.sin(aglat) * np.cos(coriolis_alpha))

    np.seterr(**err)

    # ---- crop to stored halo hg and sanitize NaN poison --------------------
    d = hx - hg

    def crop(a, jn, inn):
        out = a[:, d:d + jn, d:d + inn] if d else a[:, :jn, :inn]
        return out

    NC, NP = n + 2 * hg, n + 1 + 2 * hg

    def cellc(a):
        return crop(a, NC, NC)

    def cornc(a):
        return crop(a, NP, NP)

    def ywallc(a):
        return crop(a, NP, NC)

    def xwallc(a):
        return crop(a, NC, NP)

    arrays = dict(
        grid_xyz=cornc(gcp), agrid_xyz=cellc(agrid),
        lon=cornc(glon), lat=cornc(glat),
        aglon=cellc(aglon), aglat=cellc(aglat),
        dx=ywallc(dx), dy=xwallc(dy), dxa=cellc(dxa), dya=cellc(dya),
        dxc=xwallc(dxc), dyc=ywallc(dyc),
        area=cellc(area), area_c=cornc(area_c),
        cos_sg=cellc(cos_sg), sin_sg=cellc(sin_sg),
        cosa=cornc(cosa), sina=cornc(sina), rsina=cornc(rsina),
        cosa_u=xwallc(cosa_u), sina_u=xwallc(sina_u), rsin_u=xwallc(rsin_u),
        cosa_v=ywallc(cosa_v), sina_v=ywallc(sina_v), rsin_v=ywallc(rsin_v),
        cosa_s=cellc(cosa_s), rsin2=cellc(rsin2),
        ec1=cellc(ec1), ec2=cellc(ec2),
        ew=xwallc(ew), es=ywallc(es),
        ee1=cornc(ee1), ee2=cornc(ee2),
        en1=ywallc(en1), en2=xwallc(en2),
        divg_u=ywallc(divg_u), divg_v=xwallc(divg_v),
        del6_u=ywallc(del6_u), del6_v=xwallc(del6_v),
        z11=cellc(z11), z12=cellc(z12), z21=cellc(z21), z22=cellc(z22),
        a11=cellc(a11), a12=cellc(a12), a21=cellc(a21), a22=cellc(a22),
        vlon=cellc(vlon), vlat=cellc(vlat),
        l2c_u=ywallc(l2c_u), l2c_v=xwallc(l2c_v),
        edge_w=edge_w, edge_e=edge_e, edge_s=edge_s, edge_n=edge_n,
        edge_vect_w=edge_vect_w, edge_vect_e=edge_vect_e,
        edge_vect_s=edge_vect_s, edge_vect_n=edge_vect_n,
        fC=cornc(fC), f0=cellc(f0),
    )
    _fill_metric_corners(arrays, n, hg)
    # reciprocals
    for nm, rec in (("dx", "rdx"), ("dy", "rdy"), ("dxa", "rdxa"),
                    ("dya", "rdya"), ("dxc", "rdxc"), ("dyc", "rdyc"),
                    ("area", "rarea"), ("area_c", "rarea_c")):
        arrays[rec] = 1.0 / arrays[nm]
    # sanitize NaN poison to BIG (so f32 casts stay finite); keep masks implicit
    for k, v in arrays.items():
        arrays[k] = np.nan_to_num(v, nan=BIG, posinf=BIG, neginf=-BIG)

    geom = GridGeometry(npx=npx, n=n, ng=hg, radius=radius, omega=omega,
                        topology=topo, arrays=arrays)
    ai = geom.interior("area")
    geom.da_min, geom.da_max = float(ai.min()), float(ai.max())
    aci = geom.interior("area_c")
    geom.da_min_c, geom.da_max_c = float(aci.min()), float(aci.max())
    geom.global_area = float(ai.sum())
    return geom


def _fill_metric_corners(arrays, n, hg):
    """Corner-region fills of the metric arrays, matching the reference
    (fv_grid_tools.F90:782 fill_corners(dx,dy,DGRID), :827 (dxa,dya,AGRID),
    :942 (dxc,dyc,CGRID), :981 area_c BGRID; fv_mp_mod.F90:1249-1456
    formulas, mySign=+1 for the length metrics). Without these the stencil
    sweeps through tile corners consume big_number poison exactly where the
    reference consumes filled values."""
    npx = npy = n + 1
    ng = hg

    def f(i):
        return i - 1 + hg

    dxa, dya = arrays["dxa"], arrays["dya"]
    dx, dy = arrays["dx"], arrays["dy"]
    dxc, dyc = arrays["dxc"], arrays["dyc"]
    for j in range(1, ng + 1):
        for i in range(1, ng + 1):
            # ---- AGRID (dxa = x, dya = y) -------------------------------
            dxa[:, f(1 - j), f(1 - i)] = dya[:, f(i), f(1 - j)]
            dxa[:, f(npy - 1 + j), f(1 - i)] = dya[:, f(npy - i), f(1 - j)]
            dxa[:, f(1 - j), f(npx - 1 + i)] = dya[:, f(i), f(npx - 1 + j)]
            dxa[:, f(npy - 1 + j), f(npx - 1 + i)] = dya[:, f(npy - i), f(npx - 1 + j)]
    for j in range(1, ng + 1):
        for i in range(1, ng + 1):
            dya[:, f(1 - i), f(1 - j)] = dxa[:, f(1 - j), f(i)]
            dya[:, f(npy - 1 + i), f(1 - j)] = dxa[:, f(npy - 1 + j), f(i)]
            dya[:, f(1 - i), f(npx - 1 + j)] = dxa[:, f(1 - j), f(npx - i)]
            dya[:, f(npy - 1 + i), f(npx - 1 + j)] = dxa[:, f(npy - 1 + j), f(npx - i)]
    for j in range(1, ng + 1):
        for i in range(1, ng + 1):
            # ---- DGRID (dx = x on y-walls, dy = y on x-walls) -----------
            dx[:, f(1 - j), f(1 - i)] = dy[:, f(i), f(1 - j)]
            dx[:, f(npy + j), f(1 - i)] = dy[:, f(npy - i), f(1 - j)]
            dx[:, f(1 - j), f(npx - 1 + i)] = dy[:, f(i), f(npx + j)]
            dx[:, f(npy + j), f(npx - 1 + i)] = dy[:, f(npy - i), f(npx + j)]
    for j in range(1, ng + 1):
        for i in range(1, ng + 1):
            dy[:, f(1 - j), f(1 - i)] = dx[:, f(1 - i), f(j)]
            dy[:, f(npy - 1 + j), f(1 - i)] = dx[:, f(npy + i), f(j)]
            dy[:, f(1 - j), f(npx + i)] = dx[:, f(1 - i), f(npx - j)]
            dy[:, f(npy - 1 + j), f(npx + i)] = dx[:, f(npy + i), f(npx - j)]
    for j in range(1, ng + 1):
        for i in range(1, ng + 1):
            # ---- CGRID (dxc = x on x-walls, dyc = y on y-walls) ---------
            dxc[:, f(1 - j), f(1 - i)] = dyc[:, f(1 - i), f(j)]
            dxc[:, f(npy - 1 + j), f(1 - i)] = dyc[:, f(npy + i), f(j)]
            dxc[:, f(1 - j), f(npx + i)] = dyc[:, f(1 - i), f(npx - j)]
            dxc[:, f(npy - 1 + j), f(npx + i)] = dyc[:, f(npy + i), f(npx - j)]
    for j in range(1, ng + 1):
        for i in range(1, ng + 1):
            dyc[:, f(1 - j), f(1 - i)] = dxc[:, f(i), f(1 - j)]
            dyc[:, f(npy + j), f(1 - i)] = dxc[:, f(npy - i), f(1 - j)]
            dyc[:, f(1 - j), f(npx - 1 + i)] = dxc[:, f(i), f(npx + j)]
            dyc[:, f(npy + j), f(npx - 1 + i)] = dxc[:, f(npy - i), f(npx + j)]
    # ---- area_c: BGRID XDir fill (fv_mp_mod.F90:952-961) ----------------
    ac = arrays["area_c"]
    for j in range(1, ng + 1):
        for i in range(1, ng + 1):
            ac[:, f(1 - j), f(1 - i)] = ac[:, f(i + 1), f(1 - j)]
            ac[:, f(npy + j), f(1 - i)] = ac[:, f(npy - i), f(1 - j)]
            ac[:, f(1 - j), f(npx + i)] = ac[:, f(i + 1), f(npx + j)]
            ac[:, f(npy + j), f(npx + i)] = ac[:, f(npy - i), f(npx + j)]


@lru_cache(maxsize=4)
def cached_grid(npx, ng=3, shift_fac=18.0):
    return build_grid_geometry(npx, ng=ng, shift_fac=shift_fac)
