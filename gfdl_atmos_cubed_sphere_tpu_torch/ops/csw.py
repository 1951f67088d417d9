"""The C-grid half step c_sw: CUDA kernel wrapper and plain version.

Replaces the TPU kernel c_sw_pallas
(gfdl_atmos_cubed_sphere_tpu/ops/pallas_csw.py:58). The kernel,
csrc/c_sw.cu, is one tile-fused launch per call: a block owns a box of one
tile and one level (the d_sw stages' plan, ops/tiles.py), loads the window
of the five fields into shared memory, reads the metric planes through the
read-only cache and runs the half step's stages there (d2a2c_vect and its
cube-corner fills, the C-grid winds, the corner divergence, the scaled
area fluxes, the cell transports with KE and the corner vorticity, the
wind update); each output point is written once. The wrapper allocates the
outputs and nothing else, and reads every field where it lies. Bound by
device-memory bytes: 5 fields in and 10 planes out (the 27 metric planes
are shared by the levels), ~1.1 GB of f32 at C192L79 (~0.34 ms at 3.35
TB/s). The hydrostatic form (w = None) transports no w and writes no wc.

`c_sw` launches the kernel for a CUDA tensor and takes the plain version,
sw_core.c_sw (sw_mode=False; hydrostatic when w is None), only for a CPU
tensor.
"""

import ctypes
from types import SimpleNamespace

import torch

from . import _build, sw_core, tiles

H = 3
#: metric planes the kernel reads, in its Metrics order
METRICS = (
    "cosa_s", "rsin2", "dxa", "dya",
    "sin_sg1", "sin_sg2", "sin_sg3", "sin_sg4",
    "cos_sg1", "cos_sg2", "cos_sg3", "cos_sg4",
    "cosa_u", "rsin_u", "cosa_v", "rsin_v", "sina_u", "sina_v",
    "dx", "dy", "dxc", "dyc", "rdxc", "rdyc",
    "rarea", "rarea_c", "fC")
#: the box (TX, TY) of compute cells a block owns, by element size
#: (csrc/c_sw.cu Box)
BOX = {4: (32, 16), 8: (16, 12)}
#: window planes of a block (csrc/c_sw.cu Plane): the 5 fields, 8 stage
#: planes and a second u and v (the next level's); and the guard rows
#: before and after them
SMEM_PLANES = 15
GUARD_ROWS = 5
#: levels a block walks (each level's field loads overlap the level before)
RUN = 4

#: kernel launches since the last reset (plain-version calls do not count)
launches = 0


def reset_launches():
    global launches
    launches = 0


def c_sw_ref(delp, pt, w, u, v, g, dt2, nord):
    """The plain version: sw_core.c_sw, nonhydrostatic, or hydrostatic
    when w is None."""
    return sw_core.c_sw(delp, pt, w, u, v, g, dt2, hydrostatic=w is None,
                        nord=nord, sw_mode=False)


def c_sw(delp, pt, w, u, v, g, dt2, nord=0):
    """All inputs padded [6, K, ...]; w None for the hydrostatic form.
    Returns the SimpleNamespace of sw_core.c_sw (delpc, ptc, wc, uc, vc, ua,
    va, divg_d, ut, vt; wc None when w is)."""
    if not delp.is_cuda:
        return c_sw_ref(delp, pt, w, u, v, g, dt2, nord)
    return _launch(delp, pt, w, u, v, g, dt2, nord)


def smem_bytes(itemsize):
    """Dynamic shared memory of one block (csrc/c_sw.cu smem_bytes)."""
    tx = BOX[itemsize][0]
    return (tiles.window_bytes(BOX[itemsize], SMEM_PLANES, itemsize)
            + 2 * GUARD_ROWS * (tx + 7) * itemsize)


def launch_plan(delp, pt, w, u, v, g, dt2, nord):
    """The kernel's arguments, on any device: `fields` (delp, pt, w, u, v
    as the caller holds them; w None for the hydrostatic form) with
    `strides`, four per field in elements (tile, level, row, column);
    `metrics`, the grid's planes in METRICS order; `outs`, the outputs in
    the kernel's order; `iv`, the int parameters (n, K, boxes along x and
    y, levels per block, box TX, TY, shared-memory bytes); and `out`, the
    namespace c_sw returns. The outputs are the only tensors allocated.
    Raises ValueError for what the kernel does not take."""
    if delp.ndim != 4 or delp.shape[0] != 6:
        raise ValueError(f"c_sw kernel takes delp [6, K, P, P], got "
                         f"{tuple(delp.shape)}")
    if delp.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"c_sw kernel takes float32 or float64, not "
                         f"{delp.dtype}")
    K, P = delp.shape[1], delp.shape[-1]
    n = P - 2 * H
    W = n + 1 + 2 * H
    if n < 8:
        raise ValueError("c_sw kernel needs at least 8 cells per side")
    fields = [delp, pt, w, u, v]
    shapes = [(P, P), (P, P), (P, P), (W, P), (P, W)]
    dev, dtype = delp.get_device(), delp.dtype
    strides = []
    for b, (a, shp) in enumerate(zip(fields, shapes)):
        if a is None and b == 2:             # the hydrostatic form
            strides += (0, 0, 0, 0)
            continue
        if (a.get_device() != dev or a.dtype != dtype
                or tuple(a.shape) != (6, K) + shp):
            raise ValueError(f"c_sw operand {b}: device, dtype or shape "
                             f"{tuple(a.shape)} differ from {(6, K) + shp}")
        strides += a.stride()
    mets = [getattr(g, nm) for nm in METRICS]
    for nm, m in zip(METRICS, mets):
        if (m.get_device() != dev or m.dtype != dtype or m.ndim != 4
                or m.shape[:2] != (6, 1) or not m.is_contiguous()):
            raise ValueError(f"c_sw metric {nm}: want a contiguous [6, 1, "
                             f"., .] tensor of dtype {dtype} on the device "
                             f"of delp")

    def new(*s):
        return torch.empty((6, K) + s, dtype=delp.dtype, device=delp.device)

    out = SimpleNamespace(delpc=new(P, P), ptc=new(P, P),
                          wc=None if w is None else new(P, P),
                          uc=new(P, W), vc=new(W, P), ua=new(P, P),
                          va=new(P, P), ut=new(P, W), vt=new(W, P),
                          divg_d=new(W, W) if nord > 0 else None)
    outs = [out.delpc, out.ptc, out.wc, out.uc, out.vc, out.ua, out.va,
            out.ut, out.vt, out.divg_d]
    tx, ty, ntx, nty = tiles.plan(BOX[delp.element_size()], n)
    iv = (n, K, ntx, nty, RUN, tx, ty, smem_bytes(delp.element_size()))
    return SimpleNamespace(fields=fields, strides=strides, metrics=mets,
                           outs=outs, iv=iv, out=out)


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(
        *(None if t is None else t.data_ptr() for t in ts))


def _entry():
    fn = _build.library("c_sw").c_sw
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_longlong),
                       ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_int), ctypes.c_double,
                       ctypes.c_int, ctypes.c_void_p]
    return fn


def _launch(delp, pt, w, u, v, g, dt2, nord):
    global launches
    plan = launch_plan(delp, pt, w, u, v, g, dt2, nord)
    if not delp.is_cuda:
        raise ValueError("c_sw kernel takes CUDA tensors")
    rc = _entry()(_ptrs(plan.fields),
            (ctypes.c_longlong * len(plan.strides))(*plan.strides),
            _ptrs(plan.metrics), _ptrs(plan.outs),
            (ctypes.c_int * len(plan.iv))(*plan.iv), float(dt2),
            _build.dtype_code(delp), _build.stream_ptr(delp))
    _build.check(rc, "c_sw")
    launches += 1
    return plan.out
