"""Large-timestep tracer transport with CFL-adaptive subcycling, PyTorch
port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/model/tracer_2d.py (FV3
model/fv_tracer2d.F90 tracer_2d): the acoustic loop accumulates the mass
fluxes mfx/mfy and Courant numbers cx/cy; the tracers are then advected
over the big timestep in nsplt subcycles, each applying fv_tp_2d to the
1/nsplt-scaled fluxes and updating the pressure thickness consistently.
All tracers go through one batched call [6, T, K, P, P]: on the card the
rank-5 form of the tp sweep kernel (ops/tp_sweep.py), whose wind and
metric operands [6, 1, K or 1, ...] are shared by the T tracers.

With q_split == 0 the subcycle count is nsplt = min(floor(1 + cmax),
max_split), cmax the largest |Courant number| on the compute walls,
computed on the device in the working type and read back to the host once
per call (the loop count is a host integer).
"""

import torch

from ..ops.sw_core import _cl, _cr, _rl, _rr
from ..ops.tp_core import fv_tp_2d

H = 3

#: the subcycle count of each call since the last reset, in call order
nsplt_calls = []


def reset_nsplt():
    nsplt_calls.clear()


def _tracer_fluxes(cx, cy, g):
    """Area fluxes xfx/yfx recovered from accumulated Courant numbers
    (fv_tracer2d.F90:117-140 upwind dxa/sin_sg pick)."""
    xfx = cx * g.dy * torch.where(cx > 0.0, _cl(g.dxa * g.sin_sg3),
                                  _cr(g.dxa * g.sin_sg1))
    yfx = cy * g.dx * torch.where(cy > 0.0, _rl(g.dya * g.sin_sg4),
                                  _rr(g.dya * g.sin_sg2))
    return xfx, yfx


def tracer_2d(q, dp1, mfx, mfy, cx, cy, g, hord_tr, q_split=0,
              max_split=10, lim_fac=1.0):
    """Advect the tracer dict `q` ([6, K, n, n] each) over one big timestep.

    dp1: delp before the acoustic loop; mfx/mfy: accumulated mass fluxes
    on the compute walls [6, K, n, n+1] / [6, K, n+1, n]; cx/cy: accumulated
    Courant numbers on the padded walls (d_sw shapes). q_split > 0 forces a
    static subcycle count; q_split == 0 takes the CFL-adaptive one, at
    most max_split. lim_fac: the PPM limiter factor of fv_tp_2d (the tp
    sweep kernel's every-hord form takes it). Returns (new q dict, dp_final [6, K, n, n])."""
    n = g.n
    ctr = slice(H, H + n)
    names = list(q.keys())
    qs = torch.stack([q[k] for k in names], dim=1)        # [6, T, K, n, n]

    xfx, yfx = _tracer_fluxes(cx, cy, g)
    rarea = g.rarea[..., ctr, ctr]

    def e(a):
        # a tracer axis so that [6, 1, ...] metrics and [6, K, ...] fluxes
        # stay aligned with the stacked tracers [6, T, K, ...]
        return a[:, None]

    def substep(frac, dp_in, qs_in):
        cxi, cyi = frac * cx, frac * cy
        xfxi, yfxi = frac * xfx, frac * yfx
        mfxi, mfyi = frac * mfx, frac * mfy
        ra_x = g.area + xfxi[..., :, :-1] - xfxi[..., :, 1:]
        ra_y = g.area + yfxi[..., :-1, :] - yfxi[..., 1:, :]
        dp2 = dp_in + (mfxi[..., :, :-1] - mfxi[..., :, 1:]
                       + mfyi[..., :-1, :] - mfyi[..., 1:, :]) * rarea
        qp = g.halo.pad_cell(qs_in)
        fx, fy = fv_tp_2d(qp, e(cxi), e(cyi), hord_tr, e(xfxi), e(yfxi),
                          e(g.area), e(ra_x), e(ra_y), e(g.dxa), e(g.dya),
                          lim_fac=lim_fac, mfx=e(mfxi), mfy=e(mfyi))
        qs_out = (qs_in * dp_in[:, None]
                  + (fx[..., :, :-1] - fx[..., :, 1:]
                     + fy[..., :-1, :] - fy[..., 1:, :]) * e(rarea)
                  ) / dp2[:, None]
        return dp2, qs_out

    if q_split > 0:
        nsplt = q_split
    else:
        # fv_tracer2d.F90:164-166; the max runs over the compute walls only,
        # since the padded corner blocks hold NaN from the metric precompute
        wsl = slice(H, H + n + 1)
        cmax = torch.maximum(torch.abs(cx[..., ctr, wsl]).max(),
                             torch.abs(cy[..., wsl, ctr]).max())
        nsplt = int(torch.clamp_max(torch.floor(1.0 + cmax),
                                    float(max_split)))
    nsplt_calls.append(nsplt)
    frac = 1.0 / nsplt
    dp = dp1
    for _ in range(nsplt):
        dp, qs = substep(frac, dp, qs)
    return {k: qs[:, i] for i, k in enumerate(names)}, dp
