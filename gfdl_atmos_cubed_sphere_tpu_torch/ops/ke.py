"""The d_sw kinetic-energy stage: CUDA kernel wrapper and plain version.

Replaces the TPU kernel ke_section_pallas
(gfdl_atmos_cubed_sphere_tpu/ops/pallas_sw.py:34). The kernel,
csrc/ke_section.cu, computes one corner point per thread: the vb/ub corner
winds with their tile-edge forms, their ytp_v/xtp_u PPM self-advection and
the cube-corner KE fixes. Bound by device-memory bytes: 12 planes in and one
out, ~0.19 GB of f32 at C768 (~56 us at 3.35 TB/s).

`ke_section` launches the kernel for a CUDA tensor and takes the plain
version, `ke_section_ref` (sw_core.ke_section), only for a CPU tensor.
"""

import ctypes

import torch

from . import _build
from .sw_core import H, ke_section as ke_section_ref

KERNEL_HORDS = (5, 6, 8, 9, 10)

#: kernel launches since the last reset (plain-version calls do not count)
launches = 0


def reset_launches():
    global launches
    launches = 0


def ke_section(u, v, uc, vc, ut, vt, cosa, rsina, dx, rdx, dy, rdy,
               dt, hord_mt, lim_fac, npx):
    """u/vc/vt: [6, K, NW, NC]; v/uc/ut: [6, K, NC, NW]; metrics
    [6, 1, ., .]. Returns ke [6, K, NW, NW]."""
    if not u.is_cuda:
        return ke_section_ref(u, v, uc, vc, ut, vt, cosa, rsina, dx, rdx,
                              dy, rdy, dt, hord_mt, lim_fac, npx)
    return _launch(u, v, uc, vc, ut, vt, cosa, rsina, dx, rdx, dy, rdy, dt,
                   hord_mt, npx)


def _launch(u, v, uc, vc, ut, vt, cosa, rsina, dx, rdx, dy, rdy, dt,
            hord_mt, npx):
    global launches
    if hord_mt not in KERNEL_HORDS:
        raise ValueError(f"ke_section kernel supports hord_mt {KERNEL_HORDS}, "
                         f"not {hord_mt}")
    if u.ndim != 4 or u.shape[0] != 6:
        raise ValueError(f"ke_section kernel takes u [6, K, NW, NC], got "
                         f"{tuple(u.shape)}")
    K = u.shape[1]
    n = npx - 1
    NC, NW = n + 2 * H, n + 1 + 2 * H
    if n < 6:
        raise ValueError("ke_section kernel needs at least 6 cells per side")
    yw, xw, cn = (NW, NC), (NC, NW), (NW, NW)
    ops = [u, v, uc, vc, ut, vt, cosa, rsina, dx, rdx, dy, rdy]
    shapes = [yw, xw, xw, yw, xw, yw, cn, cn, yw, yw, xw, xw]
    for b, (a, shp) in enumerate(zip(ops, shapes)):
        kk = K if b < 6 else 1
        if not a.is_cuda or a.device != u.device or a.dtype != u.dtype:
            raise ValueError(f"ke_section operand {b}: device/dtype differ "
                             f"from u")
        if tuple(a.shape) != (6, kk) + shp:
            raise ValueError(f"ke_section operand {b}: shape "
                             f"{tuple(a.shape)}, want {(6, kk) + shp}")
    ops = [a.contiguous() for a in ops]
    ke = torch.empty((6, K, NW, NW), dtype=u.dtype, device=u.device)
    fn = _build.library("ke_section").ke_section
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                   ctypes.c_int, ctypes.c_void_p]
    arr = (ctypes.c_void_p * 12)(*(a.data_ptr() for a in ops))
    rc = fn(arr, ke.data_ptr(), n, K, int(hord_mt), float(dt),
            _build.dtype_code(u), _build.stream_ptr(u))
    _build.check(rc, "ke_section")
    launches += 1
    return ke
