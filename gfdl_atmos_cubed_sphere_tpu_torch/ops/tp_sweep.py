"""The fv_tp_2d double PPM sweep: CUDA kernel wrapper and plain version.

Replaces the TPU kernel tp2d_sweep_pallas
(gfdl_atmos_cubed_sphere_tpu/ops/pallas_tp.py:177). The kernel,
csrc/tp2d_sweep.cu, runs both directional sweeps of one (tile, level) face
tile in one launch with its intermediates in shared memory. It is bound by
device-memory bytes: it reads 12 planes (q, its two corner-filled copies,
four wind planes, five metric planes) and writes 2, 14 f32 planes of
[6, 1, 774, 774] at C768 (~0.2 GB, ~60 us at 3.35 TB/s); the function's own
arguments and outputs (12 planes) bound it at ~51 us.

`tp2d_sweep` launches the kernel for a CUDA tensor and takes the plain
version, `tp2d_sweep_ref`, only for a CPU tensor. The rank-4 form
[6, K, P, P] is ported; the batched-tracer rank-5 form waits for tracer_2d.
"""

import ctypes

import torch

from . import _build
from .tp_core import xppm, yppm
from ..parallel.halo import copy_corners

H = 3
KERNEL_HORDS = (5, 6, 8, 10)

#: kernel launches since the last reset (plain-version calls do not count)
launches = 0


def reset_launches():
    global launches
    launches = 0


def tp2d_sweep_ref(q, crx, cry, hord, xfx, yfx, area, ra_x, ra_y, dxa, dya,
                   lim_fac=1.0, mfx=None, mfy=None):
    """Plain PyTorch double sweep (tp_core.F90 fv_tp_2d:85 without the
    del-n damping). Operands already sliced to the compute walls:
    crx/xfx [..., P, W], cry/yfx [..., W, P], ra_x [..., P, n],
    ra_y [..., n, P]. Returns (fx [..., n, W], fy [..., W, n])."""
    h = H
    n = q.shape[-1] - 2 * h
    ord_in = 8 if hord == 10 else hord
    ord_ou = hord
    ctr = slice(h, h + n)
    # y-inner sweep
    qy = copy_corners(q, h, 2)
    fy2 = yppm(qy, cry, dya, ord_in, lim_fac)
    fyy = yfx * fy2
    q_i = (q[..., ctr, :] * area[..., ctr, :]
           + fyy[..., :-1, :] - fyy[..., 1:, :]) / ra_y
    fx_ou = xppm(q_i, crx[..., ctr, :], dxa[..., ctr, :], ord_ou, lim_fac)
    # x-inner sweep
    qx = copy_corners(q, h, 1)
    fx2 = xppm(qx, crx, dxa, ord_in, lim_fac)
    fx1 = xfx * fx2
    q_j = (q[..., :, ctr] * area[..., :, ctr]
           + fx1[..., :, :-1] - fx1[..., :, 1:]) / ra_x
    fy_ou = yppm(q_j, cry[..., :, ctr], dya[..., :, ctr], ord_ou, lim_fac)
    if mfx is not None:
        fx = 0.5 * (fx_ou + fx2[..., ctr, :]) * mfx
        fy = 0.5 * (fy_ou + fy2[..., :, ctr]) * mfy
    else:
        fx = 0.5 * (fx_ou + fx2[..., ctr, :]) * xfx[..., ctr, :]
        fy = 0.5 * (fy_ou + fy2[..., :, ctr]) * yfx[..., :, ctr]
    return fx, fy


def tp2d_sweep(q, crx, cry, hord, xfx, yfx, area, ra_x, ra_y, dxa, dya,
               lim_fac=1.0, mfx=None, mfy=None):
    """Double sweep with cube-edge stencils: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor. q: [6, K, P, P]; the other
    operands [6, K or 1, ...] as tp2d_sweep_ref takes them."""
    if not q.is_cuda:
        return tp2d_sweep_ref(q, crx, cry, hord, xfx, yfx, area, ra_x, ra_y,
                              dxa, dya, lim_fac=lim_fac, mfx=mfx, mfy=mfy)
    return _launch(q, crx, cry, hord, xfx, yfx, area, ra_x, ra_y, dxa, dya,
                   mfx, mfy)


def _launch(q, crx, cry, hord, xfx, yfx, area, ra_x, ra_y, dxa, dya,
            mfx, mfy):
    global launches
    if hord not in KERNEL_HORDS:
        raise ValueError(f"tp2d_sweep kernel supports hord {KERNEL_HORDS}, "
                         f"not {hord}")
    if q.ndim != 4 or q.shape[0] != 6:
        raise ValueError(f"tp2d_sweep kernel takes q [6, K, P, P], got "
                         f"{tuple(q.shape)}")
    if (mfx is None) != (mfy is None):
        raise ValueError("mfx and mfy come together")
    K, P = q.shape[1], q.shape[-1]
    n = P - 2 * H
    W = n + 1
    if n < 6:
        raise ValueError("tp2d_sweep kernel needs at least 6 cells per side")
    qx = copy_corners(q, H, 1)
    qy = copy_corners(q, H, 2)
    ops = [q, qx, qy, crx, cry, xfx, yfx, area, ra_x, ra_y, dxa, dya,
           mfx, mfy]
    shapes = [(P, P), (P, P), (P, P), (P, W), (W, P), (P, W), (W, P),
              (P, P), (P, n), (n, P), (P, P), (P, P), (n, W), (W, n)]
    ptrs, kvar = [], 0
    for b, (a, shp) in enumerate(zip(ops, shapes)):
        if a is None:
            ptrs.append(None)
            continue
        if not a.is_cuda or a.device != q.device or a.dtype != q.dtype:
            raise ValueError(f"tp2d_sweep operand {b}: device/dtype differ "
                             f"from q")
        if (a.ndim != 4 or a.shape[0] != 6 or a.shape[1] not in (1, K)
                or tuple(a.shape[2:]) != shp):
            raise ValueError(f"tp2d_sweep operand {b}: shape "
                             f"{tuple(a.shape)}, want [6, 1|{K}, {shp}]")
        if not a.is_contiguous():
            a = a.contiguous()
            ops[b] = a
        if a.shape[1] == K and K > 1:
            kvar |= 1 << b
        ptrs.append(a.data_ptr())
    fx = torch.empty((6, K, n, W), dtype=q.dtype, device=q.device)
    fy = torch.empty((6, K, W, n), dtype=q.dtype, device=q.device)
    lib = _build.library("tp2d_sweep")
    fn = lib.tp2d_sweep
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                   ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    arr = (ctypes.c_void_p * 14)(*ptrs)
    rc = fn(arr, fx.data_ptr(), fy.data_ptr(), n, K, kvar,
            8 if hord == 10 else hord, hord, int(mfx is not None),
            _build.dtype_code(q), _build.stream_ptr(q))
    _build.check(rc, "tp2d_sweep")
    launches += 1
    return fx, fy
