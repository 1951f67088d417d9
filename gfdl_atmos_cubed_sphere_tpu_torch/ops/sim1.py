"""SIM1 implicit column solver: CUDA kernel wrapper and plain version.

Replaces the TPU kernel sim1_pallas
(gfdl_atmos_cubed_sphere_tpu/ops/pallas_nh.py:158, body _sim1_kernel :41).
The kernel, csrc/sim1.cu, gives one thread to each column of [6, K, P, P]
(235 k columns at C192): adjacent threads take adjacent x, so every level's
load and store coalesces. It walks each column in four streaming passes
and keeps the sweeps' carried values (gam and pp, 2 (K + 1) per column) in
shared memory, so the wrapper allocates only the three outputs. Bound by
device-memory bytes: 6 input fields, pem (K+1 levels) and ws in, pe2
(K+1), w2 and dz2 out, ~0.67 GB of f32 at C192L79 (~0.2 ms at 3.35 TB/s);
the passes move ~16 level-planes per level against those 10.

`sim1` launches the kernel for a CUDA tensor and takes the plain version,
nh_core.sim1_solver, only for a CPU tensor.
"""

import ctypes

import torch

from . import _build
from .. import constants as con
from .nh_core import sim1_solver

#: levels each pass streams ahead and fields per ring slot (csrc/sim1.cu D,
#: NF); a block's shared-memory budget, and the card's limit per block
RING_LEVELS, RING_FIELDS = 8, 4
SMEM_BUDGET, SMEM_MAX = 64 * 1024, 232448

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


def launch_plan(ncol, K, itemsize):
    """(threads per block, blocks, shared-memory bytes of a block) of the
    kernel for ncol columns of K levels: one thread per column, block b
    owning columns [b * threads, (b + 1) * threads). A column keeps 2 (K +
    1) values (gam and pp) and a ring of RING_LEVELS x RING_FIELDS in
    shared memory; the block is the largest of 256, 128, 64 or 32 threads
    within SMEM_BUDGET bytes, so several blocks share an SM."""
    per_col = (2 * (K + 1) + RING_LEVELS * RING_FIELDS) * itemsize
    nt = 256
    while nt > 32 and nt * per_col > SMEM_BUDGET:
        nt //= 2
    if nt * per_col > SMEM_MAX:
        raise ValueError(f"sim1 kernel: {K} levels need {nt * per_col} B of "
                         f"shared memory per block, over {SMEM_MAX}")
    return nt, -(-ncol // nt), nt * per_col


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
    outs = [pe2, torch.empty_like(ops[0]), torch.empty_like(ops[0])]
    nt, _, smem = launch_plan(T * Y * X, K, dm2.element_size())
    fn = _build.library("sim1").sim1
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p)] * 2 + [
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.c_void_p]
    rc = fn((ctypes.c_void_p * 7)(*(a.data_ptr() for a in ops)),
            (ctypes.c_void_p * 3)(*(a.data_ptr() for a in outs)),
            (ctypes.c_int * 6)(T, K, Y, X, nt, smem),
            (ctypes.c_double * 5)(float(dt), con.RDGAS, float(gama),
                                  float(akap), float(p_fac)),
            _build.dtype_code(dm2), _build.stream_ptr(dm2))
    _build.check(rc, "sim1")
    launches += 1
    return tuple(outs)
