"""Gnomonic cubed-sphere grid generation (host-side, numpy float64).

Re-implements the behavior of the reference grid generator:
  * equal-distance-edge gnomonic tile ("gnomonic_ed",
    FV3 model/fv_grid_utils.F90:1256-1351): edge points equally
    spaced in great-circle angle, interior points from gnomonic (cube-face)
    line intersections on the plane x = -1/sqrt(3).
  * 6-tile cube via rotations of tile 1
    (FV3 tools/fv_grid_tools.F90:2625-2756 ``mirror_grid``).
  * Schmidt stretching (``direct_transform``,
    FV3 model/fv_grid_utils.F90:802) — phase 2.

All arrays are float64; the solver consumes float32 casts of derived metric
terms (reference computes grid in R_GRID=f64 likewise, fv_arrays.F90:39).

Index convention: ``corners[tile, j, i, :]`` = unit xyz of grid corner
(i fastest along tile-local x). Tile-local layout matches the reference:
tile 1 occupies the cube face with outward normal (-1, 0, 0) before the
global longitude shift.
"""

import numpy as np

RSQ3 = 1.0 / np.sqrt(3.0)
ALPHA = np.arcsin(RSQ3)


def lonlat_to_xyz(lon, lat):
    """Unit sphere xyz from longitude/latitude (radians)."""
    lon = np.asarray(lon, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    clat = np.cos(lat)
    return np.stack([clat * np.cos(lon), clat * np.sin(lon), np.sin(lat)], axis=-1)


def xyz_to_lonlat(p):
    """Longitude in [0, 2pi), latitude in [-pi/2, pi/2]."""
    p = np.asarray(p, dtype=np.float64)
    lon = np.arctan2(p[..., 1], p[..., 0])
    lon = np.where(lon < 0.0, lon + 2.0 * np.pi, lon)
    lat = np.arcsin(np.clip(p[..., 2] / np.linalg.norm(p, axis=-1), -1.0, 1.0))
    return lon, lat


def normalize(p):
    return p / np.linalg.norm(p, axis=-1, keepdims=True)


def slerp(p0, p1, t):
    """Spherical linear interpolation between unit vectors (t broadcastable)."""
    p0 = np.asarray(p0, dtype=np.float64)
    p1 = np.asarray(p1, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)[..., None]
    ang = np.arccos(np.clip(np.sum(p0 * p1, axis=-1), -1.0, 1.0))[..., None]
    s = np.sin(ang)
    return (np.sin((1.0 - t) * ang) * p0 + np.sin(t * ang) * p1) / s


def great_circle_angle(p1, p2):
    """Great-circle central angle between unit vectors (robust small-angle)."""
    d = np.linalg.norm(np.asarray(p1) - np.asarray(p2), axis=-1)
    return 2.0 * np.arcsin(np.clip(0.5 * d, -1.0, 1.0))


def rot_matrix(axis, angle):
    """Right-handed point rotation matrix about axis 0=x,1=y,2=z (radians)."""
    c, s = np.cos(angle), np.sin(angle)
    if axis == 0:
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)
    if axis == 1:
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)


def _tile1_corners(npx):
    """Corner xyz for tile 1 (face normal (-1,0,0)), shape [npx, npx, 3].

    Equal-angle spacing along the edges, gnomonic interior — the
    ``gnomonic_ed`` construction (fv_grid_utils.F90:1256): edge points are
    projected onto the cube face plane x=-1/sqrt(3); interior point (i,j)
    takes y from the south-edge projection at i and z from the west-edge
    projection at j.
    """
    im = npx - 1
    # Tile-1 corners of the cube face x = -rsq3 (unit sphere inscribed cube):
    # (lon, lat) = (3pi/4, -alpha) .. (5pi/4, alpha).
    # i runs west->east (lon 3pi/4 -> 5pi/4, i.e. y: +rsq3 -> -rsq3),
    # j runs south->north (z: -rsq3 -> +rsq3).
    t = np.linspace(0.0, 1.0, npx)
    # West edge: lon = 3pi/4 fixed, lat from -alpha to alpha (equal angle).
    lat_w = -ALPHA + 2.0 * ALPHA * t
    west = lonlat_to_xyz(0.75 * np.pi, lat_w)          # [npx, 3], param j
    # South edge by the diagonal mirror symmetry: equal-angle from corner
    # (3pi/4,-alpha) to (5pi/4,-alpha) — a cube edge, also a great circle.
    c_sw = lonlat_to_xyz(0.75 * np.pi, -ALPHA)
    c_se = lonlat_to_xyz(1.25 * np.pi, -ALPHA)
    south = slerp(c_sw, c_se, t)                       # [npx, 3], param i
    # Project edges to the cube face plane x = -rsq3 (gnomonic projection).
    yw = west[:, 1] * (-RSQ3 / west[:, 0])             # not used except symmetry
    zw = west[:, 2] * (-RSQ3 / west[:, 0])             # z coordinate per j
    ys = south[:, 1] * (-RSQ3 / south[:, 0])           # y coordinate per i
    # Enforce exact symmetry (reference symm_ed): z antisymmetric in j,
    # y antisymmetric in i.
    zw = 0.5 * (zw - zw[::-1])
    ys = 0.5 * (ys - ys[::-1])
    pp = np.empty((npx, npx, 3), dtype=np.float64)
    pp[..., 0] = -RSQ3
    pp[..., 1] = ys[None, :]    # [j, i]: y varies with i
    pp[..., 2] = zw[:, None]    # z varies with j
    return normalize(pp)


# Point-rotation matrices taking tile 1 to tiles 2..6. Derived from the
# reference mirror_grid rot_3d sequences (fv_grid_tools.F90:2666-2746) with
# rot_3d(axis, ang) == point rotation by -ang (axes rotation by +ang).
# Resulting face normals: t1(-1,0,0) t2(0,-1,0) t3(0,0,1) t4(1,0,0)
# t5(0,1,0) t6(0,0,-1); tiles 3/6 are the polar tiles.
def _tile_rotations():
    Rz = lambda a: rot_matrix(2, np.deg2rad(a))
    Rx = lambda a: rot_matrix(0, np.deg2rad(a))
    Ry = lambda a: rot_matrix(1, np.deg2rad(a))
    return [
        np.eye(3),
        Rz(90.0),
        Rx(-90.0) @ Rz(90.0),
        Rx(-90.0) @ Rz(180.0),
        Ry(-90.0) @ Rz(-90.0),
        Ry(-90.0),
    ]


def gnomonic_cube_corners(npx, shift_fac=18.0):
    """Corner xyz for all 6 tiles, shape [6, npx, npx, 3].

    shift_fac: global longitude shift lon -= pi/shift_fac applied like the
    reference (fv_grid_tools.F90:660-661; default 18 => -10 degrees) so the
    cube corners avoid the poles/dateline exactly like FV3. Pass 0 to skip.
    """
    t1 = _tile1_corners(npx)
    rots = _tile_rotations()
    tiles = np.stack([t1 @ R.T for R in rots], axis=0)
    if shift_fac and abs(shift_fac) > 1e-4:
        Rshift = rot_matrix(2, -np.pi / shift_fac)
        tiles = tiles @ Rshift.T
    return tiles


def schmidt_transform(xyz, stretch_fac, target_lon, target_lat,
                      revised=False):
    """Schmidt stretching of grid-point coordinates
    (fv_grid_utils.F90 direct_transform:802 / cube_transform:863).

    The conformal Schmidt map concentrates resolution by factor
    `stretch_fac` toward the south pole, then a rigid rotation carries the
    pole to (target_lon, target_lat) — the refined face ends centered on
    the target. `revised=True` is the cube_transform variant (Schmidt at
    the north pole: longitudes pre-rotated by pi).

    xyz: [..., 3] unit vectors (any grid stage); returns transformed xyz.
    """
    c = float(stretch_fac)
    lon, lat = xyz_to_lonlat(np.asarray(xyz, np.float64))
    c2p1 = 1.0 + c * c
    c2m1 = 1.0 - c * c
    sin_p = np.sin(target_lat)
    cos_p = np.cos(target_lat)

    if abs(c2m1) > 1e-7:
        sin_lat = np.sin(lat)
        lat_t = np.arcsin(np.clip((c2m1 + c2p1 * sin_lat)
                                  / (c2p1 + c2m1 * sin_lat), -1.0, 1.0))
    else:
        lat_t = lat
    sin_lat = np.sin(lat_t)
    cos_lat = np.cos(lat_t)
    if revised:
        lon = lon + np.pi
    sin_o = -(sin_p * sin_lat + cos_p * cos_lat * np.cos(lon))
    near_pole = (1.0 - np.abs(sin_o)) < 1e-7
    lat_out = np.where(near_pole, np.sign(sin_o) * 0.5 * np.pi,
                       np.arcsin(np.clip(sin_o, -1.0, 1.0)))
    lon_out = target_lon + np.arctan2(
        -cos_lat * np.sin(lon),
        -sin_lat * cos_p + cos_lat * sin_p * np.cos(lon))
    lon_out = np.where(near_pole, 0.0, np.mod(lon_out, 2.0 * np.pi))
    return lonlat_to_xyz(lon_out, lat_out)
