"""The fv_tp_2d double PPM sweep: CUDA kernel wrapper and plain version.

Replaces the TPU kernel tp2d_sweep_pallas
(gfdl_atmos_cubed_sphere_tpu/ops/pallas_tp.py:177) in both its forms: q
[6, K, P, P], and the batched-tracer q [6, T, K, P, P] of tracer_2d, whose
wind and metric operands [6, 1, K or 1, ...] are shared by the T tracers
(pallas_tp.py:217-245). The kernel, csrc/tp2d_sweep.cu, runs both
directional sweeps of one (tile, tracer, level) face tile in one launch with
its intermediates in shared memory. It is bound by device-memory bytes: it
reads 12 planes (q, its two corner-filled copies, four wind planes, five
metric planes) and writes 2, 14 f32 planes of [6, 1, 774, 774] at C768
(~0.2 GB, ~60 us at 3.35 TB/s); the function's own arguments and outputs
(12 planes) bound it at ~51 us. At C192L79 with T = 6 tracers the rank-5
call moves ~2.8 GB (~0.8 ms).

`tp2d_sweep` launches the kernel for a CUDA tensor and takes the plain
version, `tp2d_sweep_ref`, only for a CPU tensor.

`fv_tp_2d_kernel` is the counterpart of the older single-call TPU kernel
fv_tp_2d_pallas (pallas_tp.py:80): tp_core.fv_tp_2d on a rank-4 q with the
sweep on this kernel and the del-n damping fluxes (deln_flux_add) outside
it, as on the TPU (pallas_tp.py:168-170). Nothing on a main path calls it;
`fv_tp_2d_ref` is its plain version.
"""

import ctypes

import torch

from . import _build, tp_core
from .tp_core import xppm, yppm
from ..parallel.halo import copy_corners

H = 3
KERNEL_HORDS = (5, 6, 8, 10)

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
                   mfx, mfy)


def _launch(q, crx, cry, hord, xfx, yfx, area, ra_x, ra_y, dxa, dya,
            mfx, mfy, for_fv_tp_2d=False):
    global launches, launches_rank5, launches_fv_tp_2d
    if hord not in KERNEL_HORDS:
        raise ValueError(f"tp2d_sweep kernel supports hord {KERNEL_HORDS}, "
                         f"not {hord}")
    if q.ndim not in (4, 5) or q.shape[0] != 6:
        raise ValueError(f"tp2d_sweep kernel takes q [6, K, P, P] or "
                         f"[6, T, K, P, P], got {tuple(q.shape)}")
    if (mfx is None) != (mfy is None):
        raise ValueError("mfx and mfy come together")
    rank5 = q.ndim == 5
    # the rank-4 form is the rank-5 one with a single tracer
    lift = (lambda a: a) if rank5 else (lambda a: a.unsqueeze(1))
    T, K, P = (q.shape[1], q.shape[2], q.shape[-1]) if rank5 else \
        (1, q.shape[1], q.shape[-1])
    n = P - 2 * H
    W = n + 1
    if n < 6:
        raise ValueError("tp2d_sweep kernel needs at least 6 cells per side")
    if 6 * T * K > 65535:
        raise ValueError(f"tp2d_sweep kernel: 6 x {T} tracers x {K} levels "
                         f"exceeds the grid's z extent")
    qx = copy_corners(q, H, 1)
    qy = copy_corners(q, H, 2)
    ops = [q, qx, qy, crx, cry, xfx, yfx, area, ra_x, ra_y, dxa, dya,
           mfx, mfy]
    shapes = [(P, P), (P, P), (P, P), (P, W), (W, P), (P, W), (W, P),
              (P, P), (P, n), (n, P), (P, P), (P, P), (n, W), (W, n)]
    ptrs, tvar, kvar = [], 0, 0
    for b, (a, shp) in enumerate(zip(ops, shapes)):
        if a is None:
            ptrs.append(None)
            continue
        if not a.is_cuda or a.device != q.device or a.dtype != q.dtype:
            raise ValueError(f"tp2d_sweep operand {b}: device/dtype differ "
                             f"from q")
        if a.ndim != q.ndim:
            raise ValueError(f"tp2d_sweep operand {b}: rank {a.ndim}, q has "
                             f"rank {q.ndim}")
        a = lift(a)
        if (a.shape[0] != 6 or a.shape[1] not in (1, T)
                or a.shape[2] not in (1, K) or tuple(a.shape[3:]) != shp):
            raise ValueError(f"tp2d_sweep operand {b}: shape "
                             f"{tuple(a.shape)}, want [6, 1|{T}, 1|{K}, "
                             f"{shp}]")
        a = a.contiguous()
        ops[b] = a
        if a.shape[1] == T and T > 1:
            tvar |= 1 << b
        if a.shape[2] == K and K > 1:
            kvar |= 1 << b
        ptrs.append(a.data_ptr())
    lead = (6, T, K) if rank5 else (6, K)
    fx = torch.empty(lead + (n, W), dtype=q.dtype, device=q.device)
    fy = torch.empty(lead + (W, n), dtype=q.dtype, device=q.device)
    lib = _build.library("tp2d_sweep")
    fn = lib.tp2d_sweep
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                   ctypes.c_void_p] + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    arr = (ctypes.c_void_p * 14)(*ptrs)
    rc = fn(arr, fx.data_ptr(), fy.data_ptr(), n, T, K, tvar, kvar,
            8 if hord == 10 else hord, hord, int(mfx is not None),
            _build.dtype_code(q), _build.stream_ptr(q))
    _build.check(rc, "tp2d_sweep")
    launches += 1
    launches_rank5 += int(rank5)
    launches_fv_tp_2d += int(for_fv_tp_2d)
    return fx, fy


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
    if lim_fac != 1.0:
        raise ValueError("fv_tp_2d kernel takes lim_fac = 1")
    return tp_core.fv_tp_2d(q, crx, cry, hord, xfx, yfx, area, ra_x, ra_y,
                            dxa, dya, mfx=mfx, mfy=mfy, nord=nord,
                            damp_c=damp_c, g=g, mass=mass,
                            sweep=_fv_tp_2d_sweep)


def _fv_tp_2d_sweep(q, crx, cry, hord, xfx, yfx, area, ra_x, ra_y, dxa, dya,
                    lim_fac=1.0, mfx=None, mfy=None):
    """fv_tp_2d_kernel's sweep: the kernel launch, counted as its own."""
    return _launch(q, crx, cry, hord, xfx, yfx, area, ra_x, ra_y, dxa, dya,
                   mfx, mfy, for_fv_tp_2d=True)
