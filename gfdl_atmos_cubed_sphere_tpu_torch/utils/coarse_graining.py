"""Coarse graining, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/utils/coarse_graining.py: the
block-reduction strategies of FV3 tools/coarse_graining.F90 (:32-42:
model_level_area_weighted and area_weighted means, mode, masked-area,
min) as block reshapes of tensors. Fields are [6, ..., n, n] with n
divisible by the coarsening factor. The coarse restart reads the grid's
host geometry (numpy float64) and moves it to the state's device and
dtype once a call.
"""

import torch


def _blocks(field, factor):
    *lead, ny, nx = field.shape
    assert ny % factor == 0 and nx % factor == 0, (ny, nx, factor)
    return field.reshape(*lead, ny // factor, factor, nx // factor, factor)


def block_area_weighted_mean(field, area, factor):
    """coarse_graining.F90 weighted_block_average: sum(q*area)/sum(area)."""
    fb = _blocks(field * area, factor)
    ab = _blocks(torch.broadcast_to(area, field.shape), factor)
    return fb.sum(dim=(-3, -1)) / ab.sum(dim=(-3, -1))


def block_mean(field, factor):
    return _blocks(field, factor).mean(dim=(-3, -1))


def block_sum(field, factor):
    return _blocks(field, factor).sum(dim=(-3, -1))


def block_min(field, factor):
    """Block minimum (the terrain coarsening strategy)."""
    return _blocks(field, factor).amin(dim=(-3, -1))


def block_max(field, factor):
    return _blocks(field, factor).amax(dim=(-3, -1))


def block_masked_area_mean(field, area, mask, factor, fill=0.0):
    """masked_area_average (coarse_graining.F90 statistics-based
    strategy): the mean over the cells where mask is true; `fill` where no
    cell of a block qualifies."""
    m = torch.broadcast_to(torch.as_tensor(mask, device=field.device),
                           field.shape)
    zero = torch.zeros((), dtype=field.dtype, device=field.device)
    fa = _blocks(torch.where(m, field * area, zero), factor).sum(dim=(-3, -1))
    aa = _blocks(torch.where(m, torch.broadcast_to(area, field.shape), zero),
                 factor).sum(dim=(-3, -1))
    return torch.where(aa > 0.0, fa / torch.clamp_min(aa, 1e-300),
                       torch.full_like(fa, fill))


def block_mode(field, factor, num_classes):
    """Blocks -> the most frequent integer class (the mode strategy for
    categorical fields such as land type); field holds classes in
    [0, num_classes). A tie goes to the lowest class, as argmax takes the
    first maximum."""
    fb = _blocks(field, factor)
    counts = torch.stack(
        [(fb == c).sum(dim=(-3, -1)) for c in range(num_classes)], dim=-1)
    return torch.argmax(counts, dim=-1)


def coarse_grain_state(state, area, factor, weighted=("delp", "pt", "w")):
    """Coarsen a dict of cell-centred fields (the
    coarse_grained_restart_files pattern): area-weighted for the listed
    fields, the plain mean otherwise; staggered fields are skipped."""
    out = {}
    for k, v in state.items():
        if v is None:
            continue
        if v.shape[-1] % factor != 0:
            continue          # staggered fields need their own treatment
        if k in weighted:
            out[k] = block_area_weighted_mean(v, area, factor)
        else:
            out[k] = block_mean(v, factor)
    return out


def block_mass_weighted_mean(field, delp, area, factor):
    """coarse_graining.F90 mass_weighted_block_average: weights delp*area
    (the model_level_mass_weighted restart strategy)."""
    w = delp * area
    fb = _blocks(field * w, factor).sum(dim=(-3, -1))
    wb = _blocks(torch.broadcast_to(w, field.shape), factor).sum(dim=(-3, -1))
    return fb / wb


def length_weighted_coarse_grain_u(u, dx, factor):
    """D-grid u (y-walls [..., ny+1, nx]) -> coarse y-walls: every
    factor-th wall row, dx-weighted along the wall
    (coarse_graining.F90 weighted_block_edge_average_x pattern)."""
    *lead, nyp, nx = u.shape
    assert (nyp - 1) % factor == 0 and nx % factor == 0
    us = u[..., ::factor, :] * dx[..., ::factor, :]
    ws = torch.broadcast_to(dx, u.shape)[..., ::factor, :]
    usb = us.reshape(*lead, (nyp - 1) // factor + 1, nx // factor, factor)
    wsb = ws.reshape(*lead, (nyp - 1) // factor + 1, nx // factor, factor)
    return usb.sum(-1) / wsb.sum(-1)


def length_weighted_coarse_grain_v(v, dy, factor):
    """D-grid v (x-walls [..., ny, nx+1]) -> coarse x-walls (dy weights)."""
    *lead, ny, nxp = v.shape
    assert ny % factor == 0 and (nxp - 1) % factor == 0
    vs = v[..., :, ::factor] * dy[..., :, ::factor]
    ws = torch.broadcast_to(dy, v.shape)[..., :, ::factor]
    vsb = vs.reshape(*lead, ny // factor, factor, (nxp - 1) // factor + 1)
    wsb = ws.reshape(*lead, ny // factor, factor, (nxp - 1) // factor + 1)
    return vsb.sum(-2) / wsb.sum(-2)


def coarse_grain_restart(state, q, g, factor,
                         strategy="model_level_area_weighted"):
    """Coarsen a full prognostic state for a coarse-grained restart
    (coarse_grained_restart_files.F90:481-511): delp always area-weighted
    (mass conserving), the other cell fields area- or mass-weighted by the
    strategy, the D winds length-weighted along the retained wall rows.
    state, q: dicts of tensors. Returns (coarse_state, coarse_q)."""
    if strategy not in ("model_level_area_weighted",
                        "model_level_mass_weighted"):
        raise ValueError(strategy)
    delp = state["delp"]

    def metric(name):
        return torch.as_tensor(g.geom.interior(name), dtype=delp.dtype,
                               device=delp.device)[:, None]

    area, dx, dy = metric("area"), metric("dx"), metric("dy")
    mass = strategy == "model_level_mass_weighted"

    def cell(fld):
        if mass:
            return block_mass_weighted_mean(fld, delp, area, factor)
        return block_area_weighted_mean(fld, area, factor)

    out = {}
    for k, v in state.items():
        if v is None:
            continue
        if k == "delp":
            out[k] = block_area_weighted_mean(v, area, factor)
        elif k == "u":
            out[k] = length_weighted_coarse_grain_u(v, dx, factor)
        elif k == "v":
            out[k] = length_weighted_coarse_grain_v(v, dy, factor)
        elif k == "phis":
            out[k] = block_area_weighted_mean(
                v, area if v.ndim == area.ndim else area[:, 0], factor)
        elif v.ndim >= 3 and v.shape[-1] == area.shape[-1]:
            out[k] = cell(v)
        else:
            out[k] = v
    qc = {k: cell(v) for k, v in (q or {}).items()}
    return out, qc
