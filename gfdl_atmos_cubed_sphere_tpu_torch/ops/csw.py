"""The C-grid half step c_sw: CUDA kernel wrapper and plain version.

Replaces the TPU kernel c_sw_pallas
(gfdl_atmos_cubed_sphere_tpu/ops/pallas_csw.py:58). The kernel,
csrc/c_sw.cu, runs the half step in seven stages of one thread per output
point (d2a2c_vect, its cube-corner fills, the C-grid winds, the corner
divergence, the scaled area fluxes, the cell transports with KE and the
corner vorticity, the wind update), its intermediates in a workspace this
wrapper allocates. Bound by device-memory bytes: 5 fields and 27 metric
planes in, 10 planes out, ~1.1 GB of f32 at C192L79 (~0.34 ms at
3.35 TB/s).

`c_sw` launches the kernel for a CUDA tensor and takes the plain version,
sw_core.c_sw (nonhydrostatic, sw_mode=False), only for a CPU tensor.
"""

import ctypes
from types import SimpleNamespace

import torch

from . import _build, sw_core

H = 3
#: metric planes the kernel reads, in its Metrics order
METRICS = (
    "cosa_s", "rsin2", "dxa", "dya",
    "sin_sg1", "sin_sg2", "sin_sg3", "sin_sg4",
    "cos_sg1", "cos_sg2", "cos_sg3", "cos_sg4",
    "cosa_u", "rsin_u", "cosa_v", "rsin_v", "sina_u", "sina_v",
    "dx", "dy", "dxc", "dyc", "rdxc", "rdyc",
    "rarea", "rarea_c", "fC")

#: kernel launches since the last reset (plain-version calls do not count)
launches = 0


def reset_launches():
    global launches
    launches = 0


def c_sw_ref(delp, pt, w, u, v, g, dt2, nord):
    """The plain version: sw_core.c_sw's nonhydrostatic form."""
    return sw_core.c_sw(delp, pt, w, u, v, g, dt2, hydrostatic=False,
                        nord=nord, sw_mode=False)


def c_sw(delp, pt, w, u, v, g, dt2, nord=0):
    """All inputs padded [6, K, ...]. Returns the SimpleNamespace of
    sw_core.c_sw (delpc, ptc, wc, uc, vc, ua, va, divg_d, ut, vt)."""
    if not delp.is_cuda:
        return c_sw_ref(delp, pt, w, u, v, g, dt2, nord)
    return _launch(delp, pt, w, u, v, g, dt2, nord)


def _launch(delp, pt, w, u, v, g, dt2, nord):
    global launches
    if delp.ndim != 4 or delp.shape[0] != 6:
        raise ValueError(f"c_sw kernel takes delp [6, K, P, P], got "
                         f"{tuple(delp.shape)}")
    K, P = delp.shape[1], delp.shape[-1]
    n = P - 2 * H
    W = n + 1 + 2 * H
    if n < 8:
        raise ValueError("c_sw kernel needs at least 8 cells per side")
    fields = [delp, pt, w, u, v]
    shapes = [(P, P), (P, P), (P, P), (W, P), (P, W)]
    for b, (a, shp) in enumerate(zip(fields, shapes)):
        if (not a.is_cuda or a.device != delp.device or a.dtype != delp.dtype
                or tuple(a.shape) != (6, K) + shp):
            raise ValueError(f"c_sw operand {b}: device, dtype or shape "
                             f"{tuple(a.shape)} differ from {(6, K) + shp}")
    fields = [a.contiguous() for a in fields]
    mets = []
    for nm in METRICS:
        m = getattr(g, nm)
        if (not m.is_cuda or m.dtype != delp.dtype or m.ndim != 4
                or m.shape[:2] != (6, 1)):
            raise ValueError(f"c_sw metric {nm}: want a CUDA [6, 1, ., .] "
                             f"tensor of dtype {delp.dtype}")
        mets.append(m.contiguous())

    def new(*s):
        return torch.empty((6, K) + s, dtype=delp.dtype, device=delp.device)

    out = SimpleNamespace(delpc=new(P, P), ptc=new(P, P), wc=new(P, P),
                          uc=new(P, W), vc=new(W, P), ua=new(P, P),
                          va=new(P, P), ut=new(P, W), vt=new(W, P),
                          divg_d=new(W, W) if nord > 0 else None)
    work = [new(P, P), new(P, P), new(P, P), new(W, W)]
    outs = [out.delpc, out.ptc, out.wc, out.uc, out.vc, out.ua, out.va,
            out.ut, out.vt, out.divg_d]
    fn = _build.library("c_sw").c_sw
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p)] * 4 \
        + [ctypes.c_int] * 3 + [ctypes.c_double, ctypes.c_int,
                                ctypes.c_void_p]

    def arr(ts):
        return (ctypes.c_void_p * len(ts))(
            *(None if t is None else t.data_ptr() for t in ts))

    rc = fn(arr(fields), arr(mets), arr(outs), arr(work), n, K, int(nord),
            float(dt2), _build.dtype_code(delp), _build.stream_ptr(delp))
    _build.check(rc, "c_sw")
    launches += 1
    return out
