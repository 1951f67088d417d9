"""Negative-tracer fillers (FV3 model/fv_fill.F90), PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/ops/fv_fill.py, the same three
fillers:

* ``fillz``: vertical borrowing, top-down (fv_fill.F90:34); it lives in
  :mod:`.fv_mapz` (the remap calls it) and is re-exported here.
* ``fill_gfs``: vertical two-sweep borrowing on GFS-ordered columns
  (fv_fill.F90 fill_gfs:141): an upward pass pulls each negative into the
  layer above, then a downward pass pulls residual negatives into the layer
  below. Exactly mass-conserving; layer 0 may keep a residual negative (so
  does the reference).
* ``fill2d``: one-pass diffusive horizontal filling (fv_fill.F90
  fill2D:183): fluxes act only across faces where the tracer mass
  (q * delp * area) changes sign, with the fixed diffusive coefficient 0.25.

The JAX package's lax.scans of fill_gfs are Python loops over the levels in
the same direction; fill2d takes its one ring of halo from the port's cell
exchange (parallel/halo.py pad_cell). No TPU kernel runs here.
"""

import torch

from .fv_mapz import fillz  # noqa: F401  (re-export, fv_fill.F90:34)

_DIF = 0.25  # fv_fill.F90 fill2D diffusive coefficient


def _sweep(q_lead, dp_lead, q_last, dp_last):
    """Borrow each layer's negative mass into the next layer; the final
    layer absorbs the residual and is not zeroed. q_lead, dp_lead: lists
    of levels in sweep order."""
    debt = torch.zeros_like(q_last)
    out = []
    for qk, dpk in zip(q_lead, dp_lead):
        qk = qk + debt / dpk            # mass borrowed from the previous layer
        neg = torch.clamp_max(qk, 0.0)
        debt = neg * dpk                # pass the deficit on
        out.append(qk - neg)            # the layer -> max(q, 0)
    return out, q_last + debt / dp_last


def fill_gfs(q, dp):
    """Two-sweep vertical filler (fv_fill.F90 fill_gfs:141).

    q, dp: [..., km] with k = 0 the bottom layer (GFS ordering; the
    reference computes dp = pe2(k) - pe2(k+1) on its upside-down pressure
    edges, here dp is passed in positive). Returns the filled q."""
    qf = list(torch.unbind(q, -1))
    dpf = list(torch.unbind(dp, -1))
    # upward: k = 0 .. km-2 borrow from above; the top layer absorbs
    up, top = _sweep(qf[:-1], dpf[:-1], qf[-1], dpf[-1])
    qf = up + [top]
    # downward: k = km-1 .. 1 borrow from below; the bottom layer absorbs
    dn, bot = _sweep(qf[:0:-1], dpf[:0:-1], qf[0], dpf[0])
    return torch.stack([bot] + dn[::-1], -1)


def fill2d(q, delp, g):
    """Diffusive horizontal filler (fv_fill.F90 fill2D:183).

    q, delp: [6, ..., n, n]. One ring of halo is exchanged for the tracer
    mass qt = q*delp*area; a face flux fx = qt_left - qt_right is applied
    only where the two masses have opposite sign, scaled by 0.25."""
    h = g.halo.h
    n = g.n
    ctr = slice(h, h + n)
    area = torch.as_tensor(g.geom.interior("area"), dtype=q.dtype,
                           device=q.device)
    area = area.reshape(area.shape[:1] + (1,) * (q.ndim - 3)
                        + area.shape[1:])
    qt = q * delp * area
    p = g.halo.pad_cell(qt)
    z = torch.zeros((), dtype=q.dtype, device=q.device)
    lx = p[..., ctr, h - 1:h + n]
    rx = p[..., ctr, h:h + n + 1]
    fx = torch.where(lx * rx < 0.0, lx - rx, z)
    ly = p[..., h - 1:h + n, ctr]
    ry = p[..., h:h + n + 1, ctr]
    fy = torch.where(ly * ry < 0.0, ly - ry, z)
    div = (fx[..., :-1] - fx[..., 1:]) + (fy[..., :-1, :] - fy[..., 1:, :])
    return q + _DIF * div / (delp * area)
