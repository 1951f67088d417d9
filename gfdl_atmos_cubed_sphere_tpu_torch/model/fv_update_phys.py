"""Physics coupling: A-grid tendencies -> model state, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/model/fv_update_phys.py (FV3
model/fv_update_phys.F90 fv_update_phys:67, and the wind transforms of
model/fv_grid_utils.F90: c2l_ord2:2470, D-grid -> A-grid lat-lon winds,
and update_dwinds_phys:3291, A-grid lat-lon wind tendencies -> D-grid
covariant winds through 3-D cartesian vectors and the edge unit vectors).

The metrics come from the grid pack (model/grid_ops.py): the padded
[6, 1, ...] planes, sliced to the compute domain, and the physics geometry
build_grid_ops adds (vlon, vlat, es1, ew2).
"""

import numpy as np
import torch

from ..ops.fill_corners import cube_edges

H = 3


def _yw(g, a):
    """Compute-domain y-wall view [6, 1, n+1, n] of a padded plane."""
    return a[..., H:H + g.n + 1, H:H + g.n]


def _xw(g, a):
    """Compute-domain x-wall view [6, 1, n, n+1] of a padded plane."""
    return a[..., H:H + g.n, H:H + g.n + 1]


def _cell(g, a):
    """Compute-domain cell view [6, 1, n, n] of a padded plane."""
    return a[..., H:H + g.n, H:H + g.n]


def cubed_to_latlon(u, v, g):
    """D winds -> A-grid (lat-lon) ua, va (c2l_ord2:2470, grid_type < 4):
    the vorticity-conserving covariant average, then the a11..a22
    rotation. u [6, K, n+1, n], v [6, K, n, n+1]."""
    dx = _yw(g, g.dx)
    dy = _xw(g, g.dy)
    wu = u * dx
    wv = v * dy
    u1 = 2.0 * (wu[..., :-1, :] + wu[..., 1:, :]) / (dx[..., :-1, :]
                                                     + dx[..., 1:, :])
    v1 = 2.0 * (wv[..., :, :-1] + wv[..., :, 1:]) / (dy[..., :, :-1]
                                                     + dy[..., :, 1:])
    ua = _cell(g, g.a11) * u1 + _cell(g, g.a12) * v1
    va = _cell(g, g.a21) * u1 + _cell(g, g.a22) * v1
    return ua, va


def update_dwinds_phys(u, v, u_dt, v_dt, g, dt):
    """Scatter A-grid lat-lon wind tendencies onto the D grid
    (update_dwinds_phys:3291). u_dt, v_dt: [6, K, n, n]; returns the
    updated (u, v)."""
    n = g.n
    dt5 = 0.5 * dt
    im2 = (g.npx - 1) // 2

    # 3-D cartesian tendency vector at the cells, with one halo row
    ud_p = g.halo.pad_cell(u_dt)
    vd_p = g.halo.pad_cell(v_dt)
    v3 = ud_p[..., None] * g.vlon + vd_p[..., None] * g.vlat
    rim = slice(H - 1, H + n + 1)
    ue = v3[..., H - 1:H + n, rim, :] + v3[..., H:H + n + 1, rim, :]
    ve = v3[..., rim, H - 1:H + n, :] + v3[..., rim, H:H + n + 1, :]

    # tile-edge 1-D tangential interpolation (update_dwinds_phys:3379-3458)
    shift_up = torch.as_tensor(np.arange(n) > im2 - 1,
                               device=u.device)[:, None]

    def blend(vec_line, nb_lo, nb_hi, ev):
        nb = torch.where(shift_up, nb_lo, nb_hi)
        w = ev[:, 0, None, :, None]
        return w * nb + (1.0 - w) * vec_line

    ve = ve.clone()
    ue = ue.clone()
    for icol, ev in ((0, g.edge_vect_w), (n, g.edge_vect_e)):
        ve[..., 1:-1, icol, :] = blend(ve[..., 1:-1, icol, :],
                                       ve[..., :-2, icol, :],
                                       ve[..., 2:, icol, :], ev)
    for jrow, ev in ((0, g.edge_vect_s), (n, g.edge_vect_n)):
        ue[..., jrow, 1:-1, :] = blend(ue[..., jrow, 1:-1, :],
                                       ue[..., jrow, :-2, :],
                                       ue[..., jrow, 2:, :], ev)

    # project on the covariant edge unit vectors and update
    du = dt5 * torch.sum(ue[..., :, 1:-1, :] * g.es1, dim=-1)
    dv = dt5 * torch.sum(ve[..., 1:-1, :, :] * g.ew2, dim=-1)
    return u + du, v + dv


def del2_phys(qdt, delp, g, cd):
    """Del-2 filter of a mass-weighted physics tendency with a damping mask
    peaked at the cube panel edges and corners (fv_update_phys.F90
    del2_phys:770, fv_core_nml del2_cofac). qdt, delp: [6, K, n, n]; cd:
    the del2_cofac coefficient. Returns the filtered tendency."""
    n = g.n
    npx = g.npx
    damp = 0.25 * cd * float(g.da_min)
    ii = np.arange(npx, dtype=np.float64)
    f1 = (1.0 - np.sin(ii / (npx - 1) * np.pi)) ** 2
    mask_c = damp * (f1[:, None] + f1[None, :])

    def t(a):
        return torch.as_tensor(a, dtype=qdt.dtype, device=qdt.device)

    mask_x = t(mask_c[:-1, :] + mask_c[1:, :])          # [n, n+1]
    mask_y = t(mask_c[:, :-1] + mask_c[:, 1:])          # [n+1, n]
    dy, sina_u, rdxc = (_xw(g, a) for a in (g.dy, g.sina_u, g.rdxc))
    dx, sina_v, rdyc = (_yw(g, a) for a in (g.dx, g.sina_v, g.rdyc))
    rarea = _cell(g, g.rarea)

    qp = g.halo.pad_cell(qdt * delp)                     # mass-weighted
    dqx = qp[..., H:H + n, H - 1:H + n] - qp[..., H:H + n, H:H + n + 1]
    dqy = qp[..., H - 1:H + n, H:H + n] - qp[..., H:H + n + 1, H:H + n]
    fx = mask_x * dy * sina_u * dqx * rdxc
    fy = mask_y * dx * sina_v * dqy * rdyc

    if cube_edges(g):
        # one-sided sin_sg factors at the cube panel edges
        # (del2_phys:843-862)
        sg1, sg2, sg3, sg4 = g.sin_sg1, g.sin_sg2, g.sin_sg3, g.sin_sg4
        c = slice(H, H + n)
        west = 0.5 * (sg1[:, :, c, H] + sg3[:, :, c, H - 1])
        east = 0.5 * (sg1[:, :, c, H + n] + sg3[:, :, c, H + n - 1])
        south = 0.5 * (sg2[:, :, H, c] + sg4[:, :, H - 1, c])
        north = 0.5 * (sg2[:, :, H + n, c] + sg4[:, :, H + n - 1, c])
        fx = fx.clone()
        fy = fy.clone()
        fx[..., 0] = (mask_x[:, 0] * dy[..., 0] * dqx[..., 0]
                      * rdxc[..., 0] * west)
        fx[..., -1] = (mask_x[:, -1] * dy[..., -1] * dqx[..., -1]
                       * rdxc[..., -1] * east)
        fy[..., 0, :] = (mask_y[0] * dx[..., 0, :] * dqy[..., 0, :]
                         * rdyc[..., 0, :] * south)
        fy[..., -1, :] = (mask_y[-1] * dx[..., -1, :] * dqy[..., -1, :]
                          * rdyc[..., -1, :] * north)

    return qdt + rarea * (fx[..., :, :-1] - fx[..., :, 1:]
                          + fy[..., :-1, :] - fy[..., 1:, :]) / delp


def fv_update_phys(dt, pt, delp, u, v, q, u_dt, v_dt, t_dt, q_dt, g,
                   del2_cofac=0.0):
    """Apply physics tendencies (fv_update_phys.F90:67, simplified moist
    handling): T and the tracers directly, the winds through
    update_dwinds_phys. Tendencies are per second on the A grid;
    del2_cofac > 0 filters the wind and temperature tendencies first
    (fv_update_phys.F90:323-333). Returns (pt, u, v, q)."""
    if del2_cofac > 0.0:
        u_dt = del2_phys(u_dt, delp, g, del2_cofac)
        v_dt = del2_phys(v_dt, delp, g, del2_cofac)
        t_dt = del2_phys(t_dt, delp, g, del2_cofac)
    pt = pt + dt * t_dt
    q_new = dict(q or {})
    for k, dq in (q_dt or {}).items():
        q_new[k] = q_new.get(k, 0.0) + dt * dq
    u, v = update_dwinds_phys(u, v, u_dt, v_dt, g, dt)
    return pt, u, v, q_new
