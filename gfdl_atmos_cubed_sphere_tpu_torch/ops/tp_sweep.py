"""The fv_tp_2d double PPM sweep: CUDA kernel wrapper and plain version.

Replaces the TPU kernel tp2d_sweep_pallas
(gfdl_atmos_cubed_sphere_tpu/ops/pallas_tp.py:177) in both its forms: q
[6, K, P, P], and the batched-tracer q [6, T, K, P, P] of tracer_2d, whose
wind and metric operands [6, 1, K or 1, ...] are shared by the T tracers
(pallas_tp.py:217-245). The kernel, csrc/tp2d_sweep.cu, is one tile-fused
launch per call: a block owns a box of one tile and one level (the d_sw
stages' plan, ops/tiles.py), keeps the box's window of the wind and metric
operands in shared memory and streams the T tracers' q through it, with
copy_corners and both directional sweeps inside. Every operand is read
where it lies through its own strides (the sliced wall operands of
tp_core.fv_tp_2d included), so the wrapper allocates fx and fy and
nothing else. The rank-4 call is bound by device-memory bytes (C192L79,
update_dz_d's K + 1 levels: ~0.66 GB, ~0.2 ms at 3.35 TB/s); the rank-5
call reads its shared winds and metrics once for the T tracers.

`tp2d_sweep` launches the kernel for a CUDA tensor and takes the plain
version, `tp2d_sweep_ref`, only for a CPU tensor.

`fv_tp_2d_kernel` is the counterpart of the older single-call TPU kernel
fv_tp_2d_pallas (pallas_tp.py:80): tp_core.fv_tp_2d on a rank-4 q with the
sweep on this kernel and the del-n damping fluxes (deln_flux_add) outside
it, as on the TPU (pallas_tp.py:168-170). Nothing on a main path calls it;
`fv_tp_2d_ref` is its plain version.
"""

import ctypes
from types import SimpleNamespace

import torch

from . import _build, tiles, tp_core
from .tp_core import xppm, yppm
from ..parallel.halo import copy_corners

H = 3
#: every hord tp_core.xppm has a branch for: the linear family 1-6 with its
#: negatives, the monotone and positive-definite family 7-13 (hord 5, 6, 8
#: and 10 at lim_fac 1 take the kernel's smaller form, csrc/fv_ppm.cuh
#: usual_hord)
KERNEL_HORDS = tuple(range(-6, 0)) + tuple(range(1, 14))
#: the box (TX, TY) of compute cells a block owns, by element size
#: (csrc/tp2d_sweep.cu Box): a window row or column (TX + 6, TY + 6 cells)
#: fits the 32 lanes of a warp
BOX = {4: (24, 24), 8: (24, 24)}
#: window planes of a block (csrc/tp2d_sweep.cu Slot): q, the winds and
#: metrics, q_i, q_j and the inner fluxes
SMEM_PLANES = 14
#: levels a block walks for a single tracer (the box's metric planes load
#: once for the run, and each level's loads overlap the level before); with
#: T tracers a block takes one level and the tracers' q overlap instead
RUN = 4
#: the operands in the kernel's order, and the last two dimensions of each
#: for n cells per side (P = n + 6, W = n + 1)
OPERANDS = ("q", "crx", "cry", "xfx", "yfx", "area", "ra_x", "ra_y", "dxa",
            "dya", "mfx", "mfy")

#: kernel launches since the last reset (plain-version calls do not count),
#: of those the launches on a rank-5 (batched-tracer) q and those made for
#: fv_tp_2d_kernel
launches = 0
launches_rank5 = 0
launches_fv_tp_2d = 0


def reset_launches():
    global launches, launches_rank5, launches_fv_tp_2d
    launches = 0
    launches_rank5 = 0
    launches_fv_tp_2d = 0


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
    tensor, the plain version for a CPU tensor. q: [6, K, P, P] with the
    other operands [6, K or 1, ...], or q: [6, T, K, P, P] with the other
    operands [6, T or 1, K or 1, ...]; the walls as tp2d_sweep_ref takes
    them."""
    if not q.is_cuda:
        return tp2d_sweep_ref(q, crx, cry, hord, xfx, yfx, area, ra_x, ra_y,
                              dxa, dya, lim_fac=lim_fac, mfx=mfx, mfy=mfy)
    return _launch(q, crx, cry, hord, xfx, yfx, area, ra_x, ra_y, dxa, dya,
                   mfx, mfy, lim_fac)


def frames(n):
    """The last two dimensions of each operand of OPERANDS."""
    P, W = n + 2 * H, n + 1
    return ((P, P), (P, W), (W, P), (P, W), (W, P), (P, P), (P, n), (n, P),
            (P, P), (P, P), (n, W), (W, n))


def smem_bytes(itemsize):
    """Dynamic shared memory of one block (csrc/tp2d_sweep.cu
    smem_bytes)."""
    return tiles.window_bytes(BOX[itemsize], SMEM_PLANES, itemsize)


def launch_plan(q, crx, cry, hord, xfx, yfx, area, ra_x, ra_y, dxa, dya,
                mfx=None, mfy=None):
    """The kernel's arguments, on any device: `ops`, the operands in
    OPERANDS order as the caller holds them (mfx, mfy may be None);
    `strides`, five per operand in elements (tile, tracer, level, row,
    column; 0 along an axis of length 1 or, at rank 4, the tracer axis);
    `iv`, the int parameters (n, T, K, boxes along x and y, ord_in, ord_ou,
    levels per block, box TX, TY, shared-memory bytes); and the outputs fx,
    fy, the only tensors allocated. Raises ValueError for what the kernel
    does not take."""
    if hord not in KERNEL_HORDS:
        raise ValueError(f"tp2d_sweep kernel supports hord {KERNEL_HORDS}, "
                         f"not {hord}")
    if q.ndim not in (4, 5) or q.shape[0] != 6:
        raise ValueError(f"tp2d_sweep kernel takes q [6, K, P, P] or "
                         f"[6, T, K, P, P], got {tuple(q.shape)}")
    if (mfx is None) != (mfy is None):
        raise ValueError("mfx and mfy come together")
    if q.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"tp2d_sweep kernel takes float32 or float64, not "
                         f"{q.dtype}")
    rank5 = q.ndim == 5
    T, K, P = (q.shape[1], q.shape[2], q.shape[-1]) if rank5 else \
        (1, q.shape[1], q.shape[-1])
    n = P - 2 * H
    if n < 6:
        raise ValueError("tp2d_sweep kernel needs at least 6 cells per side")
    ops = (q, crx, cry, xfx, yfx, area, ra_x, ra_y, dxa, dya, mfx, mfy)
    dev, dtype, nd = q.get_device(), q.dtype, q.ndim
    strides = []
    for b, (a, shp) in enumerate(zip(ops, frames(n))):
        if a is None:
            strides += (0, 0, 0, 0, 0)
            continue
        sh, st = a.shape, a.stride()
        if a.dtype != dtype or a.get_device() != dev or len(sh) != nd:
            raise ValueError(f"tp2d_sweep operand {OPERANDS[b]}: device, "
                             f"dtype or rank differ from q")
        if not rank5:
            sh, st = (sh[0], 1) + tuple(sh[1:]), (st[0], 0) + st[1:]
        if (sh[0] != 6 or sh[1] not in (1, T) or sh[2] not in (1, K)
                or tuple(sh[3:]) != shp):
            raise ValueError(f"tp2d_sweep operand {OPERANDS[b]}: shape "
                             f"{tuple(sh)}, want [6, 1|{T}, 1|{K}, {shp}]")
        strides += (st[0], 0 if sh[1] == 1 else st[1],
                    0 if sh[2] == 1 else st[2], st[3], st[4])
    tx, ty, ntx, nty = tiles.plan(BOX[q.element_size()], n)
    iv = (n, T, K, ntx, nty, 8 if hord == 10 else hord, hord,
          RUN if T == 1 else 1, tx, ty, smem_bytes(q.element_size()))
    lead = (6, T, K) if rank5 else (6, K)
    fx = torch.empty(lead + (n, n + 1), dtype=dtype, device=q.device)
    fy = torch.empty(lead + (n + 1, n), dtype=dtype, device=q.device)
    return SimpleNamespace(ops=ops, strides=strides, iv=iv, fx=fx, fy=fy)


def _entry():
    fn = _build.library("tp2d_sweep").tp2d_sweep
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                       ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
    return fn


def _launch(q, crx, cry, hord, xfx, yfx, area, ra_x, ra_y, dxa, dya,
            mfx, mfy, lim_fac=1.0, for_fv_tp_2d=False):
    global launches, launches_rank5, launches_fv_tp_2d
    plan = launch_plan(q, crx, cry, hord, xfx, yfx, area, ra_x, ra_y, dxa,
                       dya, mfx, mfy)
    if not q.is_cuda:
        raise ValueError("tp2d_sweep kernel takes CUDA tensors")
    rc = _entry()(
        (ctypes.c_void_p * 12)(
            *(None if a is None else a.data_ptr() for a in plan.ops)),
        (ctypes.c_longlong * 60)(*plan.strides), plan.fx.data_ptr(),
        plan.fy.data_ptr(), (ctypes.c_int * 11)(*plan.iv), float(lim_fac),
        _build.dtype_code(q), _build.stream_ptr(q))
    _build.check(rc, "tp2d_sweep")
    launches += 1
    launches_rank5 += int(q.ndim == 5)
    launches_fv_tp_2d += int(for_fv_tp_2d)
    return plan.fx, plan.fy


def fv_tp_2d_ref(q, crx, cry, hord, xfx, yfx, area, ra_x, ra_y, dxa, dya,
                 lim_fac=1.0, mfx=None, mfy=None, nord=None, damp_c=None,
                 g=None, mass=None):
    """Plain version of fv_tp_2d_kernel: tp_core.fv_tp_2d with the plain
    sweep."""
    return tp_core.fv_tp_2d(q, crx, cry, hord, xfx, yfx, area, ra_x, ra_y,
                            dxa, dya, lim_fac=lim_fac, mfx=mfx, mfy=mfy,
                            nord=nord, damp_c=damp_c, g=g, mass=mass,
                            sweep=tp2d_sweep_ref)


def fv_tp_2d_kernel(q, crx, cry, hord, xfx, yfx, area, ra_x, ra_y, dxa, dya,
                    lim_fac=1.0, mfx=None, mfy=None, nord=None, damp_c=None,
                    g=None, mass=None):
    """fv_tp_2d on q [6, K, P, P] (tp_core.fv_tp_2d's operands and
    damping arguments; damp_c a scalar or a [K] profile): the sweep kernel
    plus deln_flux_add for a CUDA tensor, fv_tp_2d_ref for a CPU tensor."""
    if not q.is_cuda:
        return fv_tp_2d_ref(q, crx, cry, hord, xfx, yfx, area, ra_x, ra_y,
                            dxa, dya, lim_fac=lim_fac, mfx=mfx, mfy=mfy,
                            nord=nord, damp_c=damp_c, g=g, mass=mass)
    if q.ndim != 4:
        raise ValueError(f"fv_tp_2d kernel takes q [6, K, P, P], got "
                         f"{tuple(q.shape)}")
    return tp_core.fv_tp_2d(q, crx, cry, hord, xfx, yfx, area, ra_x, ra_y,
                            dxa, dya, lim_fac=lim_fac, mfx=mfx, mfy=mfy,
                            nord=nord, damp_c=damp_c, g=g, mass=mass,
                            sweep=_fv_tp_2d_sweep)


def _fv_tp_2d_sweep(q, crx, cry, hord, xfx, yfx, area, ra_x, ra_y, dxa, dya,
                    lim_fac=1.0, mfx=None, mfy=None):
    """fv_tp_2d_kernel's sweep: the kernel launch, counted as its own."""
    return _launch(q, crx, cry, hord, xfx, yfx, area, ra_x, ra_y, dxa, dya,
                   mfx, mfy, lim_fac, for_fv_tp_2d=True)
