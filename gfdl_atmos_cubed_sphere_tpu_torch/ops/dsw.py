"""The D-grid step d_sw in two stages: CUDA kernel wrappers and plain
versions.

Replaces the TPU kernel d_sw_pallas
(gfdl_atmos_cubed_sphere_tpu/ops/pallas_dsw.py:155), which makes two
pallas_calls through _run_stage (:98): the fluxes stage and the winds
stage. Each stage is one launch of one tile-fused kernel,
csrc/d_sw_fluxes.cu and csrc/d_sw_winds.cu: a block owns a box of compute
cells of one cube tile and a run of levels, holds its window (the box and
a 3-cell halo) of the inputs in shared memory and runs every stage there;
only the outputs go to device memory. The wrappers allocate the outputs
and nothing else, and compute the grid (`tile_plan`) and the shared memory
of a block (`smem_bytes`), which the kernels check against their own. The
PPM sweeps inside (three in the fluxes stage: delp, w, pt; one in the
winds stage: the absolute vorticity) and the KE stage run the tp sweep's
and the ke_section kernel's arithmetic (csrc/fv_ppm.cuh). The Smagorinsky
operand a2b_ord4(vorticity) is computed between the stages through the
a2b kernel wrapper, as on the TPU. Per-level damping profiles go to the
kernels as device [K] arrays. The hydrostatic form (w = None) runs the
fluxes stage without the w transport, damping and heat; the winds stage
does not read w.
Bound by device-memory bytes: ~1.4 GB (fluxes) and ~1.5 GB (winds) of f32
at C192L79, ~0.42 and ~0.47 ms at 3.35 TB/s.

`d_sw` launches both kernels for a CUDA tensor and takes the plain
versions, sw_core.d_sw(stage="fluxes") and sw_core.d_sw(stage="winds"),
only for a CPU tensor.
"""

import ctypes
from types import SimpleNamespace

import numpy as np
import torch

from . import _build, sw_core, tiles
from .a2b import a2b_ord4_ref
from .a2b_edge import a2b_ord4
from .ke import KERNEL_HORDS as KE_HORDS
from .tiles import box_starts, owned_ranges  # noqa: F401 (the plan)
from .tp_sweep import KERNEL_HORDS as TP_HORDS, tp2d_sweep_ref

H = 3
#: the del-n orders each kernel takes, as sw_core.d_sw: the divergence
#: damping's nord 0-3 and the del-n fluxes' nord_v, nord_w, nord_v2,
#: nord_w2 0-2 (tp_core.deln_damp_fluxes is valid on the compute walls up
#: to nord 2 with a 3-cell halo)
KERNEL_NORDS = (0, 1, 2, 3)
KERNEL_DELN_NORDS = (0, 1, 2)
#: metric planes of each stage, in the order the kernels take them (the
#: TPU kernel's _METRICS_FLUX / _METRICS_WIND)
FLUX_METRICS = (
    "cosa_u", "cosa_v", "rsin_u", "rsin_v",
    "sin_sg1", "sin_sg2", "sin_sg3", "sin_sg4",
    "dx", "dy", "rdxa", "rdya", "dxa", "dya",
    "area", "rarea", "del6_u", "del6_v")
WIND_METRICS = (
    "cosa_u", "cosa_v", "sina_u", "sina_v",
    "sin_sg1", "sin_sg2", "sin_sg3", "sin_sg4",
    "dx", "dy", "rdx", "rdy", "dxa", "dya", "dxc", "dyc",
    "area", "rarea", "rarea_c", "cosa", "rsina",
    "del6_u", "del6_v", "divg_u", "divg_v",
    "f0", "rsin2", "cosa_s")

#: the box (TX, TY) of compute cells a block of each stage kernel owns, by
#: element size (csrc/d_sw_fluxes.cu, d_sw_winds.cu Box)
BOX = {"fluxes": {4: (32, 16), 8: (16, 12)},
       "winds": {4: (32, 12), 8: (16, 8)}}
#: shared memory of each stage kernel: its window planes (the kernels'
#: Plane enums) and a second set of its field planes (the next level's,
#: loading), and its byte planes of PPM smoothness flags
SMEM_PLANES = {"fluxes": 47, "winds": 52}
SMEM_FIELDS = {"fluxes": 5, "winds": 15}
SMEM_FLAG_PLANES = 2

#: kernel launches since the last reset (plain-version calls do not count)
launches = {"fluxes": 0, "winds": 0}


def reset_launches():
    launches["fluxes"] = 0
    launches["winds"] = 0

#: d_sw keyword arguments each stage takes (the rest belong to the other)
FLUX_KW = ("dt", "hord_dp", "hord_tm", "hord_vt", "nord_v", "damp_v",
           "damp_v2", "nord_v2", "damp_w", "nord_w", "damp_w2", "nord_w2",
           "ke_bg", "lim_fac")
WIND_KW = ("dt", "hord_mt", "hord_vt", "nord", "nord_v", "dddmp", "d2_bg",
           "d4_bg", "damp_v", "d_con", "nord_mask", "damp_v2", "nord_v2",
           "lim_fac")
#: fluxes-stage products the winds stage reads (the stage seam)
SEAM = ("crx", "cry", "xfx", "yfx", "ra_x", "ra_y", "ut", "vt")
#: the plain versions of the sweep, KE and a2b kernels, which the plain
#: versions of the two stages run inside on any device
PLAIN_INNER = SimpleNamespace(sweep=tp2d_sweep_ref, ke=sw_core.ke_section,
                              a2b=a2b_ord4_ref)


def d_sw_fluxes_ref(delp, pt, w, uc, vc, g, **kw):
    """Plain version of the fluxes kernel: sw_core.d_sw(stage="fluxes"),
    hydrostatic when w is None."""
    return sw_core.d_sw(delp, pt, w, None, None, uc, vc, None, None, None,
                        g, hord_mt=None, nord=None, dddmp=0.0, d2_bg=0.0,
                        d4_bg=0.0, hydrostatic=w is None, sw_mode=False,
                        stage="fluxes", inner=PLAIN_INNER, **kw)


def d_sw_winds_ref(delp, u, v, uc, vc, ua, va, divg_d, vortS, heat_w,
                   seam, g, **kw):
    """Plain version of the winds kernel: sw_core.d_sw(stage="winds") on
    the fluxes stage's seam products, the Smagorinsky operand vortS and the
    w-damping heat heat_w (None when w damping is off)."""
    pre = dict(seam, vortS=vortS, heat_source=heat_w)
    ds = sw_core.d_sw(delp, None, None, u, v, uc, vc, ua, va, divg_d, g,
                      hord_dp=None, hord_tm=None, hydrostatic=False,
                      sw_mode=False, stage="winds", pre=pre,
                      inner=PLAIN_INNER, **kw)
    return SimpleNamespace(u=ds.u, v=ds.v, heat_source=ds.heat_source)


def d_sw_fluxes(delp, pt, w, uc, vc, g, **kw):
    """The fluxes stage: contravariant winds, the edge/corner solve, the
    Courant/area fluxes and the delp/pt/w transport with their damping
    (w None: the hydrostatic form, no w transport or damping)."""
    if not delp.is_cuda:
        return d_sw_fluxes_ref(delp, pt, w, uc, vc, g, **kw)
    return _launch_fluxes(delp, pt, w, uc, vc, g, **kw)


def d_sw_winds(delp, u, v, uc, vc, ua, va, divg_d, vortS, heat_w, seam, g,
               **kw):
    """The winds stage: KE, vorticity, divergence and vorticity damping,
    vorticity transport, the wind update and the dissipative heating."""
    if not delp.is_cuda:
        return d_sw_winds_ref(delp, u, v, uc, vc, ua, va, divg_d, vortS,
                              heat_w, seam, g, **kw)
    return _launch_winds(delp, u, v, uc, vc, ua, va, divg_d, vortS, heat_w,
                         seam, g, **kw)


def smagorinsky_operand(u, v, g):
    """a2b_ord4 of the cell-mean relative vorticity, the Smagorinsky
    operand of the winds stage, computed outside it through the a2b kernel
    as on the TPU (pallas_dsw.py:286-298)."""
    vt_w = u * g.dx
    ut_w = v * g.dy
    wk = g.rarea * (vt_w[..., :-1, :] - vt_w[..., 1:, :]
                    - ut_w[..., :, :-1] + ut_w[..., :, 1:])
    return a2b_ord4(wk, g)


def d_sw(delp, pt, w, u, v, uc, vc, ua, va, divg_d, g, **kw):
    """d_sw as the two stages, nonhydrostatic, or hydrostatic when w is
    None. All field inputs [6, K, ., .] padded; keyword arguments as
    sw_core.d_sw takes them. Returns the
    interior u, v, delp, pt, w, the fluxes fx, fy and the full-frame crx,
    cry, xfx, yfx, ra_x, ra_y, and the heat source."""
    fl = d_sw_fluxes(delp, pt, w, uc, vc, g,
                     **{k: kw[k] for k in FLUX_KW if k in kw})
    vortS = None
    if kw.get("nord", 0) > 0 and kw.get("dddmp", 0.0) >= 1.0e-5:
        vortS = smagorinsky_operand(u, v, g)
    wd = d_sw_winds(delp, u, v, uc, vc, ua, va, divg_d, vortS,
                    fl.heat_source, {k: getattr(fl, k) for k in SEAM}, g,
                    **{k: kw[k] for k in WIND_KW if k in kw})
    return SimpleNamespace(
        u=wd.u, v=wd.v, delp=fl.delp, pt=fl.pt, w=fl.w, fx=fl.fx, fy=fl.fy,
        crx=fl.crx, cry=fl.cry, xfx=fl.xfx, yfx=fl.yfx, ra_x=fl.ra_x,
        ra_y=fl.ra_y, heat_source=wd.heat_source)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _max(x):
    return None if x is None else float(np.max(np.asarray(x)))


def _level_profile(x, like, K):
    """A scalar or [K] damping parameter as a device [K] array in like's
    dtype (the value sw_core.d_sw broadcasts over each level)."""
    a = np.asarray(0.0 if x is None else x, np.float64)
    t = torch.as_tensor(a, dtype=like.dtype, device=like.device)
    return t.expand(K).contiguous() if t.ndim == 0 else t.contiguous()


def _damp4(x, scale, nord, like, K):
    """(x * scale) ** (nord + 1) per level, as sw_core.d_sw forms it."""
    return ((_level_profile(x, like, K) * scale) ** (nord + 1)).contiguous()


def _check_fields(name, ops, dtype, device):
    for b, (a, shp) in enumerate(ops):
        if a is None:
            continue
        if (not a.is_cuda or a.device != device or a.dtype != dtype
                or tuple(a.shape) != shp):
            raise ValueError(f"{name} operand {b}: device, dtype or shape "
                             f"{tuple(a.shape)} differ from {shp}")


def _metric_list(g, names, like):
    out = []
    for nm in names:
        m = getattr(g, nm)
        if (not m.is_cuda or m.dtype != like.dtype or m.ndim != 4
                or m.shape[:2] != (6, 1)):
            raise ValueError(f"d_sw metric {nm}: want a CUDA [6, 1, ., .] "
                             f"tensor of dtype {like.dtype}")
        out.append(m.contiguous())
    return out


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(
        *(None if t is None else t.data_ptr() for t in ts))


def _entry(name):
    fn = getattr(_build.library(name), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p)] * 4 + [
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.c_void_p]
    return fn


def tile_plan(stage, n, itemsize):
    """(TX, TY, boxes along x, boxes along y) of a stage kernel's grid for
    n cells per side (ops/tiles.py plan)."""
    return tiles.plan(BOX[stage][itemsize], n)


def smem_bytes(stage, itemsize):
    """Dynamic shared memory of one block of a stage kernel: its window
    planes and a second set of field planes, (TY + 7) x (TX + 7) elements
    each, and its byte planes of flags."""
    return tiles.window_bytes(BOX[stage][itemsize],
                              SMEM_PLANES[stage] + SMEM_FIELDS[stage],
                              itemsize, SMEM_FLAG_PLANES)


def _fluxes_operands(delp, pt, w, uc, vc, g, *, dt, hord_dp, hord_tm,
                     hord_vt, nord_v, damp_v, damp_v2=None, nord_v2=0,
                     damp_w=0.0, nord_w=0, damp_w2=None, nord_w2=0,
                     ke_bg=0.0, lim_fac=1.0, every=False):
    """The fluxes kernel's arguments: (fields, metric planes, outputs,
    per-level profiles, int and double parameters, the output namespace).
    every: launch the kernel's every-argument form whatever the arguments
    (the same values; by default the form they need). Raises ValueError
    for what the kernel does not take."""
    if delp.ndim != 4 or delp.shape[0] != 6:
        raise ValueError(f"d_sw fluxes kernel takes delp [6, K, P, P], got "
                         f"{tuple(delp.shape)}")
    for h in (hord_dp, hord_tm, hord_vt):
        if h not in TP_HORDS:
            raise ValueError(f"d_sw fluxes kernel supports hord {TP_HORDS}, "
                             f"not {h}")
    for nm, nd in (("nord_v", nord_v), ("nord_w", nord_w),
                   ("nord_v2", nord_v2), ("nord_w2", nord_w2)):
        if nd not in KERNEL_DELN_NORDS:
            raise ValueError(f"d_sw fluxes kernel takes {nm} in "
                             f"{KERNEL_DELN_NORDS}, not {nd}")
    K, P = delp.shape[1], delp.shape[-1]
    n = P - 2 * H
    W = n + 1 + 2 * H
    m = n + 1
    if n < 8:
        raise ValueError("d_sw kernels need at least 8 cells per side")
    fields = [None if a is None else a.contiguous()
              for a in (delp, pt, w, uc, vc)]
    mets = [getattr(g, nm).contiguous() for nm in FLUX_METRICS]
    on_v = damp_v is not None and _max(damp_v) > 1.0e-4
    on_v2 = damp_v2 is not None and _max(damp_v2) > 1.0e-4
    on_w = w is not None and sw_core._on(damp_w)
    on_w2 = w is not None and sw_core._on(damp_w2)
    prof = [_damp4(damp_v, g.da_min, nord_v, delp, K) if on_v else None,
            _damp4(damp_v2, g.da_min, nord_v2, delp, K) if on_v2 else None,
            _damp4(damp_w, g.da_min_c, nord_w, delp, K) if on_w else None,
            _damp4(damp_w2, g.da_min_c, nord_w2, delp, K) if on_w2 else None]

    def new(*s):
        return torch.empty((6, K) + s, dtype=delp.dtype, device=delp.device)

    out = SimpleNamespace(
        delp=new(n, n), pt=new(n, n), w=None if w is None else new(n, n),
        fx=new(n, m),
        fy=new(m, n), crx=new(P, W), cry=new(W, P), xfx=new(P, W),
        yfx=new(W, P), ra_x=new(P, P), ra_y=new(P, P), ut=new(P, W),
        vt=new(W, P), heat_source=new(n, n) if (on_w or on_w2) else None)
    outs = [out.delp, out.pt, out.w, out.fx, out.fy, out.crx, out.cry,
            out.xfx, out.yfx, out.ra_x, out.ra_y, out.ut, out.vt,
            out.heat_source]
    tx, ty, ntx, nty = tile_plan("fluxes", n, delp.element_size())
    iv = (n, K, hord_dp, hord_vt, hord_tm, nord_v, nord_w, nord_v2, nord_w2,
          on_v, on_v2, on_w, on_w2, int(every), ntx, nty, tx, ty,
          smem_bytes("fluxes", delp.element_size()))
    dv = (float(dt), float(ke_bg * abs(dt)), float(lim_fac))
    return fields, mets, outs, prof, iv, dv, out


def _launch_fluxes(delp, pt, w, uc, vc, g, **kw):
    fields, mets, outs, prof, iv, dv, out = _fluxes_operands(
        delp, pt, w, uc, vc, g, **kw)
    K, P = delp.shape[1], delp.shape[-1]
    _check_fields("d_sw fluxes", [
        (delp, (6, K, P, P)), (pt, (6, K, P, P)), (w, (6, K, P, P)),
        (uc, (6, K, P, P + 1)), (vc, (6, K, P + 1, P))], delp.dtype,
        delp.device)
    _metric_list(g, FLUX_METRICS, delp)
    rc = _entry("d_sw_fluxes")(
        _ptrs(fields), _ptrs(mets), _ptrs(outs), _ptrs(prof),
        (ctypes.c_int * len(iv))(*iv), (ctypes.c_double * len(dv))(*dv),
        _build.dtype_code(delp), _build.stream_ptr(delp))
    _build.check(rc, "d_sw_fluxes")
    launches["fluxes"] += 1
    return out


def _winds_operands(delp, u, v, uc, vc, ua, va, divg_d, vortS, heat_w,
                    seam, g, *, dt, hord_mt, hord_vt, nord, nord_v, dddmp,
                    d2_bg, d4_bg, damp_v, d_con=0.0, nord_mask=None,
                    damp_v2=None, nord_v2=0, lim_fac=1.0, every=False):
    """The winds kernel's arguments: (inputs, metric planes, outputs,
    per-level profiles, int and double parameters, the output namespace).
    every: as _fluxes_operands'. Raises ValueError for what the kernel does
    not take."""
    if delp.ndim != 4 or delp.shape[0] != 6:
        raise ValueError(f"d_sw winds kernel takes delp [6, K, P, P], got "
                         f"{tuple(delp.shape)}")
    if hord_mt not in KE_HORDS or hord_vt not in TP_HORDS:
        raise ValueError(f"d_sw winds kernel supports hord_mt {KE_HORDS} and "
                         f"hord_vt {TP_HORDS}, not {hord_mt}, {hord_vt}")
    if nord not in KERNEL_NORDS:
        raise ValueError(f"d_sw winds kernel takes nord in {KERNEL_NORDS}, "
                         f"not {nord}")
    for nm, nd in (("nord_v", nord_v), ("nord_v2", nord_v2)):
        if nd not in KERNEL_DELN_NORDS:
            raise ValueError(f"d_sw winds kernel takes {nm} in "
                             f"{KERNEL_DELN_NORDS}, not {nd}")
    K, P = delp.shape[1], delp.shape[-1]
    n = P - 2 * H
    m = n + 1
    if n < 8:
        raise ValueError("d_sw kernels need at least 8 cells per side")
    need0 = nord == 0 or (nord_mask is not None and bool(np.any(nord_mask)))
    needN = nord > 0
    smag = needN and dddmp >= 1.0e-5
    if smag and vortS is None:
        vortS = smagorinsky_operand(u, v, g)
    ins = [delp, u, v, uc, vc, ua, va, divg_d if needN else None,
           vortS if smag else None, heat_w] + [seam[k] for k in SEAM]
    ins = [None if a is None else a.contiguous() for a in ins]
    mets = [getattr(g, nm).contiguous() for nm in WIND_METRICS]
    on_v = sw_core._on(damp_v)
    on_v2 = sw_core._on(damp_v2)
    do_heat = sw_core._on(d_con)
    mask = (np.asarray(nord_mask, np.float64) if need0 and needN
            else None)
    prof = [_level_profile(d2_bg, delp, K), _level_profile(d_con, delp, K),
            _level_profile(mask, delp, K) if mask is not None else None,
            _damp4(damp_v, g.da_min_c, nord_v, delp, K) if on_v else None,
            _damp4(damp_v2, g.da_min_c, nord_v2, delp, K) if on_v2 else None]
    dd8 = float((g.da_min_c * d4_bg) ** (nord + 1))

    def new(*s):
        return torch.empty((6, K) + s, dtype=delp.dtype, device=delp.device)

    out = SimpleNamespace(u=new(m, n), v=new(n, m),
                          heat_source=new(n, n) if do_heat else None)
    tx, ty, ntx, nty = tile_plan("winds", n, delp.element_size())
    iv = (n, K, hord_mt, hord_vt, nord, nord_v, nord_v2, need0, needN, smag,
          do_heat, on_v, on_v2, int(every), ntx, nty, tx, ty,
          smem_bytes("winds", delp.element_size()))
    dv = (float(dt), float(dddmp), float(g.da_min_c), dd8, float(lim_fac))
    return (ins, mets, [out.u, out.v, out.heat_source], prof, iv, dv, out)


def _launch_winds(delp, u, v, uc, vc, ua, va, divg_d, vortS, heat_w, seam,
                  g, **kw):
    ins, mets, outs, prof, iv, dv, out = _winds_operands(
        delp, u, v, uc, vc, ua, va, divg_d, vortS, heat_w, seam, g, **kw)
    K, P = delp.shape[1], delp.shape[-1]
    n = P - 2 * H
    W = P + 1
    shapes = [(P, P), (W, P), (P, W), (P, W), (W, P), (P, P), (P, P),
              (W, W), (W, W), (n, n), (P, W), (W, P), (P, W), (W, P),
              (P, P), (P, P), (P, W), (W, P)]
    _check_fields("d_sw winds", [(a, (6, K) + s) for a, s in
                                 zip(ins, shapes)], delp.dtype, delp.device)
    _metric_list(g, WIND_METRICS, delp)
    rc = _entry("d_sw_winds")(
        _ptrs(ins), _ptrs(mets), _ptrs(outs), _ptrs(prof),
        (ctypes.c_int * len(iv))(*iv), (ctypes.c_double * len(dv))(*dv),
        _build.dtype_code(delp), _build.stream_ptr(delp))
    _build.check(rc, "d_sw_winds")
    launches["winds"] += 1
    return out
