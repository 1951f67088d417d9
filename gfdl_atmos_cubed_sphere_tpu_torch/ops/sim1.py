"""SIM1 implicit column solver: CUDA kernel wrapper and plain version.

Replaces the TPU kernel sim1_pallas
(gfdl_atmos_cubed_sphere_tpu/ops/pallas_nh.py:158, body _sim1_kernel :41).
The kernel, csrc/sim1.cu, gives one thread to each column of [6, K, P, P]
(235 k columns at C192): adjacent threads take adjacent x, so every level's
load and store coalesces. The Thomas-sweep scratch (pp, gam, aa, bb, dd,
grat) lives in a workspace [6, K+1, P, P] x 6 the wrapper allocates. Bound
by device-memory bytes: 6 input fields, pem (K+1 levels) and ws in, pe2
(K+1), w2 and dz2 out, ~0.67 GB of f32 at C192L79 (~0.2 ms at 3.35 TB/s).

`sim1` launches the kernel for a CUDA tensor and takes the plain version,
nh_core.sim1_solver, only for a CPU tensor.
"""

import ctypes

import torch

from . import _build
from .. import constants as con
from .nh_core import sim1_solver

#: kernel launches since the last reset (plain-version calls do not count)
launches = 0


def reset_launches():
    global launches
    launches = 0


def sim1(dt, dm2, pm2, pem, w2, dz2, pt2, ws, gama, akap, p_fac):
    """Fields [6, K, Y, X]; pem [6, K+1, Y, X]; ws [6, Y, X]. Returns
    (pe2 [6, K+1, Y, X], w2, dz2)."""
    if not dm2.is_cuda:
        return sim1_solver(dt, dm2, pm2, pem, w2, dz2, pt2, ws, gama, akap,
                           p_fac)
    return _launch(dt, dm2, pm2, pem, w2, dz2, pt2, ws, gama, akap, p_fac)


def _launch(dt, dm2, pm2, pem, w2, dz2, pt2, ws, gama, akap, p_fac):
    global launches
    if dm2.ndim != 4:
        raise ValueError(f"sim1 kernel takes [T, K, Y, X], got "
                         f"{tuple(dm2.shape)}")
    T, K, Y, X = dm2.shape
    if K < 3:
        raise ValueError("sim1 kernel needs at least 3 levels")
    ops = [dm2, pm2, pem, w2, dz2, pt2, ws]
    shapes = [(T, K, Y, X)] * 2 + [(T, K + 1, Y, X)] + [(T, K, Y, X)] * 3 \
        + [(T, Y, X)]
    for b, (a, shp) in enumerate(zip(ops, shapes)):
        if not a.is_cuda or a.device != dm2.device or a.dtype != dm2.dtype:
            raise ValueError(f"sim1 operand {b}: device/dtype differ from dm2")
        if tuple(a.shape) != shp:
            raise ValueError(f"sim1 operand {b}: shape {tuple(a.shape)}, "
                             f"want {shp}")
    ops = [a.contiguous() for a in ops]
    pe2 = torch.empty((T, K + 1, Y, X), dtype=dm2.dtype, device=dm2.device)
    wo = torch.empty_like(ops[0])
    dzo = torch.empty_like(ops[0])
    work = torch.empty((6, T, K + 1, Y, X), dtype=dm2.dtype,
                       device=dm2.device)
    fn = _build.library("sim1").sim1
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 \
        + [ctypes.c_double] * 5 + [ctypes.c_int, ctypes.c_void_p]
    rc = fn(*(a.data_ptr() for a in ops), pe2.data_ptr(), wo.data_ptr(),
            dzo.data_ptr(), work.data_ptr(), T, K, Y, X, float(dt),
            con.RDGAS, float(gama), float(akap), float(p_fac),
            _build.dtype_code(dm2), _build.stream_ptr(dm2))
    _build.check(rc, "sim1")
    launches += 1
    return pe2, wo, dzo
