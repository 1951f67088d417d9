"""The d_sw kinetic-energy stage: CUDA kernel wrapper and plain version.

Replaces the TPU kernel ke_section_pallas
(gfdl_atmos_cubed_sphere_tpu/ops/pallas_sw.py:34). The kernel,
csrc/ke_section.cu, is one launch per call: a warp owns a strip of SPAN
corner columns and ROWS corner rows of one (tile, level) of the padded
W x W frame and walks it down a row at a time, each lane forming one u
cell's and one v cell's PPM edge values a step (the neighbour's u cell by
shuffles, the v cell above carried from the step before), then its
corner's vb, ub, ytp_v/xtp_u self-advection and cube-corner fixes; no
shared memory, no barrier. Blocks of WARPS warps, held by their launch
bounds to 8 an SM in f32 (64 registers a thread) and 4 in f64;
chip_smoke.py prints the registers and blocks per SM of the build. Every
operand whose rows are contiguous is read where it lies through its tile
and level strides (a field sliced along its levels, a metric broadcast
over them); one laid out otherwise is copied. The wrapper allocates ke and
nothing else. Bound by device-memory bytes: 12 planes in and one out,
~0.19 GB of f32 at C768 (~56 us at 3.35 TB/s).

`ke_section` launches the kernel for a CUDA tensor and takes the plain
version, `ke_section_ref` (sw_core.ke_section), only for a CPU tensor.
"""

import ctypes
from types import SimpleNamespace

import torch

from . import _build
from .sw_core import H, ke_section as ke_section_ref

#: the hords sw_core.xtp_u takes with the kernels' (tp_sweep.KERNEL_HORDS):
#: its linear family below 8 (iord 5 apart), 8, 9, 10 and the unlimited
#: branch above
KERNEL_HORDS = tuple(range(-6, 0)) + tuple(range(1, 14))
#: corner columns of a warp strip and warps a block (csrc/ke_section.cu
#: SPAN, WARPS), and corner rows of a warp strip
SPAN, WARPS, ROWS = 31, 4, 2
#: the operands in the kernel's order
OPERANDS = ("u", "v", "uc", "vc", "ut", "vt", "cosa", "rsina", "dx", "rdx",
            "dy", "rdy")

#: kernel launches since the last reset (plain-version calls do not count)
launches = 0


def reset_launches():
    global launches
    launches = 0


def ke_section(u, v, uc, vc, ut, vt, cosa, rsina, dx, rdx, dy, rdy,
               dt, hord_mt, lim_fac, npx):
    """u/vc/vt: [6, K, NW, NC]; v/uc/ut: [6, K, NC, NW]; metrics
    [6, 1, ., .]. Returns ke [6, K, NW, NW]."""
    global launches
    if not u.is_cuda:
        return ke_section_ref(u, v, uc, vc, ut, vt, cosa, rsina, dx, rdx,
                              dy, rdy, dt, hord_mt, lim_fac, npx)
    plan = launch_plan(u, v, uc, vc, ut, vt, cosa, rsina, dx, rdx, dy, rdy,
                       hord_mt, npx)
    rc = _entry()(
        (ctypes.c_void_p * 12)(*(a.data_ptr() for a in plan.ops)),
        (ctypes.c_longlong * 24)(*plan.strides), plan.ke.data_ptr(),
        (ctypes.c_int * 6)(*plan.iv), float(dt), _build.dtype_code(u),
        _build.stream_ptr(u))
    _build.check(rc, "ke_section")
    launches += 1
    return plan.ke


def frames(n):
    """The last two dimensions of each operand of OPERANDS."""
    NC, NW = n + 2 * H, n + 1 + 2 * H
    yw, xw, cn = (NW, NC), (NC, NW), (NW, NW)
    return (yw, xw, xw, yw, xw, yw, cn, cn, yw, yw, xw, xw)


def grid(n, rows):
    """(blocks along x, blocks along y) of the launch for n cells per
    side: strips of SPAN corner columns across the W x W frame, WARPS
    strips of `rows` corner rows a block."""
    NW = n + 7
    return -(-NW // SPAN), -(-NW // (rows * WARPS))


def owned_corners(n, rows):
    """(j0, j1, i0, i1) of the corners [j0, j1) x [i0, i1) each warp strip
    of the launch writes (the kernel clips them to the frame)."""
    gx, gy = grid(n, rows)
    return [(w * rows, (w + 1) * rows, x * SPAN, (x + 1) * SPAN)
            for w in range(gy * WARPS) for x in range(gx)]


def launch_plan(u, v, uc, vc, ut, vt, cosa, rsina, dx, rdx, dy, rdy,
                hord_mt, npx):
    """The kernel's arguments, on any device: `ops`, the operands in
    OPERANDS order as the caller holds them (an operand whose rows are not
    contiguous copied); `strides`, the tile and level strides of each
    operand in elements (0 along a level axis of length 1); `iv`, the int parameters (n, K, hord, corner rows of a warp
    strip, blocks along x and y); and ke, the only tensor allocated.
    Raises ValueError for what the kernel does not take."""
    if hord_mt not in KERNEL_HORDS:
        raise ValueError(f"ke_section kernel supports hord_mt {KERNEL_HORDS}, "
                         f"not {hord_mt}")
    if u.ndim != 4 or u.shape[0] != 6:
        raise ValueError(f"ke_section kernel takes u [6, K, NW, NC], got "
                         f"{tuple(u.shape)}")
    if u.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"ke_section kernel takes float32 or float64, not "
                         f"{u.dtype}")
    K, n = u.shape[1], npx - 1
    if n < 6:
        raise ValueError("ke_section kernel needs at least 6 cells per side")
    ops = [u, v, uc, vc, ut, vt, cosa, rsina, dx, rdx, dy, rdy]
    strides = []
    dev, dtype = u.get_device(), u.dtype
    for b, (a, shp) in enumerate(zip(ops, frames(n))):
        want = (6, K if b < 6 else 1) + shp
        if a.get_device() != dev or a.dtype != dtype:
            raise ValueError(f"ke_section operand {OPERANDS[b]}: device or "
                             f"dtype differ from u")
        if a.shape != want:
            raise ValueError(f"ke_section operand {OPERANDS[b]}: shape "
                             f"{tuple(a.shape)}, want {want}")
        st = a.stride()
        if st[3] != 1 or st[2] != shp[1]:
            a = ops[b] = a.contiguous()
            st = a.stride()
        strides += (st[0], 0 if want[1] == 1 else st[1])
    iv = (n, K, int(hord_mt), ROWS) + grid(n, ROWS)
    NW = n + 1 + 2 * H
    ke = torch.empty((6, K, NW, NW), dtype=u.dtype, device=u.device)
    return SimpleNamespace(ops=ops, strides=strides, iv=iv, ke=ke)


def _entry():
    fn = _build.library("ke_section").ke_section
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
                       ctypes.POINTER(ctypes.c_int), ctypes.c_double,
                       ctypes.c_int, ctypes.c_void_p]
    return fn
