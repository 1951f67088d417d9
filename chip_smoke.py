"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from gfdl_atmos_cubed_sphere_tpu_torch/csrc/
(nvcc, one process per source, all started together, into
build/torch_kernels/), then runs its phases and exits non-zero on the first
failure. Two main paths run on the card: the shallow-water step (sw_c768)
and the dry nonhydrostatic big step fv_dynamics_nh at C192L79 (c192_nh
made dry: q = {}, no moist physics).

1. build: the seconds nvcc took for the seven sources;
2. each kernel against its plain PyTorch version on the card, on the inputs
   the main paths hand it (the first call of each wrapper at each call
   shape, captured, with the calls at that shape counted: on the NH path
   a2b runs at nh_p_grad's batched 3(K+1)+K levels and at the Smagorinsky
   operand's K levels, 12 calls each per big step): the
   tp sweep, ke_section and a2b kernels on one sw_c768 float32 step and
   one C48 float64 SW step, and the c_sw, d_sw fluxes, d_sw
   winds, sim1, tp sweep and a2b kernels on one C192L79 float32 big step
   and one C24L10 float64 big step (dt = 900 s, k_split = 1,
   n_split = 2). Tolerance per output: max |diff| <= 1e-4 x max |ref| in
   float32 (the count of points over 1e-6 relative is printed: a limiter
   branch may flip under float32 rounding) and <= 1e-12 in float64; the
   non-finite points (NaN in the cube-corner halo) must coincide. Each
   with its time (CUDA events, median of 20 after warm-up; the kernel
   alone from the profiler), the plain version's time and its bound. The
   tp sweep and ke_section kernels are also checked at every other hord
   they take (tp_sweep.KERNEL_HORDS, ke.KERNEL_HORDS) on the SW inputs;
3. the SW step (case 2, C48, float64, n_split=2, 4 steps) and the NH big
   step (C24L10, float64, dt = 900 s, k_split = 1, n_split = 2, 2 steps)
   on the card with the kernels against the same port on the CPU with the
   plain versions, each field against its own maximum: <= 1e-10 on the SW
   delp, u, v and the NH delp, pt, u, v, delz, and <= 5e-9 on the NH w.
   w is the ill-conditioned field: it carries the nonhydrostatic pressure
   perturbation, a difference of ~1e5 Pa quantities, so last-bit
   differences between the card's and the CPU's exp/log move it by some
   1e-10 of its maximum (devtools/nh_w_conditioning.py measures how far
   on the CPU). As a control, the same two big steps run on the card in
   float32; every field of the control must read over its limit, so the
   limits sit between a sound reading and a fault of float32 size;
4. the full-width sw_c768 step (npx=769, n_split=1, case 2, float32):
   1 warm-up step, 5 timed steps behind a scalar readback barrier, 2 steps
   under the profiler. It asserts no NaN, a relative change of
   sum(delp * area) (in float64) <= 1e-5, and launch counts of exactly 2
   (tp2d_sweep), 1 (ke_section) and 3 (a2b_ord4) per step. bench.py's
   sw_c768 uses dt=225 s; with n_split=1 that is a Courant number of 4.63
   at C768 and the solver (JAX and port alike) overflows by the third or
   fourth step (devtools/sw_stability.py), so the smoke runs dt = 225/8 s
   with the same work per step;
5. the dry c192_nh big step at full width (C192L79, float32, dt = 450 s,
   k_split = 2, n_split = 6, dddmp = 0.2, d_con = 1, the Jablonowski-
   Williamson baroclinic wave): 1 warm-up step, 5 timed steps behind a
   scalar readback barrier, 1 step under the profiler (s/step,
   pts*lev/s, device busy share, device ms by kernel). It asserts finite
   fields, a relative change of sum(delp * area) (float64) <= 1e-5, and
   launch counts per big step of c_sw 12, d_sw fluxes 12, d_sw winds 12,
   sim1 24, tp2d_sweep 12 (update_dz_d; the d_sw stages run 3 + 1 more
   sweeps inside their own entry points) and a2b_ord4 24 (nh_p_grad and
   the Smagorinsky operand).

Before the last line it prints the card's name and power limit and one JSON
line with each kernel's launches, error and times; for a kernel its path
calls at several shapes, ms, plain_ms, bound_ms and kernel_ms are means
per launch weighted by the calls at each shape, and "shapes" lists each
shape's own numbers. The last line is
{"ok": true, "device": {...}}. It needs one CUDA card; without one it exits
with code 2 and prints no result.
"""

import json
import statistics
import subprocess
import sys
import time

H = 3
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"float32": 67e12}    # H100 SXM, outside the tensor cores
# floating-point operations per output point, estimated from each kernel's
# source (the PPM limiter work dominates); far below the byte bound
OPS_PER_POINT = {"tp2d_sweep": 200, "ke_section": 150, "a2b_ord4": 80,
                 "c_sw": 250, "d_sw_fluxes": 900, "d_sw_winds": 600,
                 "sim1": 80}
REPLACES = {
    "tp2d_sweep": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_tp.py:177",
    "ke_section": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_sw.py:34",
    "a2b_ord4": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_a2b.py:45",
    "c_sw": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_csw.py:58",
    "d_sw_fluxes": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_dsw.py:155",
    "d_sw_winds": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_dsw.py:155",
    "sim1": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_nh.py:158",
}
SW_KERNELS = ("tp2d_sweep", "ke_section", "a2b_ord4")
NH_KERNELS = ("c_sw", "d_sw_fluxes", "d_sw_winds", "sim1", "tp2d_sweep",
              "a2b_ord4")
SW_PER_STEP = {"tp2d_sweep": 2, "ke_section": 1, "a2b_ord4": 3}
NH_PER_STEP = {"c_sw": 12, "d_sw_fluxes": 12, "d_sw_winds": 12, "sim1": 24,
               "tp2d_sweep": 12, "a2b_ord4": 24, "ke_section": 0}
# position of the hord argument in the calls of the wrappers that take one
HORD_ARG = {"tp2d_sweep": 3, "ke_section": 13}
C768_DT = 225.0 / 8        # see phase 4 in the module docstring
# NH card vs CPU, x each field's own maximum: 1e-10, and w's own limit (see
# phase 3 in the module docstring)
NH_CARD_TOL = {"w": 5e-9}
NH_CFG = dict(hydrostatic=False, adiabatic=True, dddmp=0.2, d_con=1.0,
              do_vort_damp=True)


def log(msg):
    print(msg, flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"FAILED: {msg}")


def kernel_modules():
    """name: (module, wrapper attribute, plain version, launch count)."""
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import (a2b, csw, dsw, ke,
                                                       sim1, tp_sweep)
    return {
        "tp2d_sweep": (tp_sweep, "tp2d_sweep", tp_sweep.tp2d_sweep_ref,
                       lambda: tp_sweep.launches),
        "ke_section": (ke, "ke_section", ke.ke_section_ref,
                       lambda: ke.launches),
        "a2b_ord4": (a2b, "a2b_ord4", a2b.a2b_ord4_ref,
                     lambda: a2b.launches),
        "c_sw": (csw, "c_sw", csw.c_sw_ref, lambda: csw.launches),
        "d_sw_fluxes": (dsw, "d_sw_fluxes", dsw.d_sw_fluxes_ref,
                        lambda: dsw.launches["fluxes"]),
        "d_sw_winds": (dsw, "d_sw_winds", dsw.d_sw_winds_ref,
                       lambda: dsw.launches["winds"]),
        "sim1": (sim1, "sim1", sim1.sim1_solver, lambda: sim1.launches),
    }


def call_shape(args):
    """The shape of a wrapper call: that of its first tensor argument (the
    field the kernel works on; its level count tells nh_p_grad's batched
    a2b call from the Smagorinsky operand's)."""
    import torch
    return next(tuple(x.shape) for x in args if torch.is_tensor(x))


class Capture:
    """Records (cloned) the arguments of the first call of each kernel
    wrapper at each distinct call shape while a main path runs, and the
    number of calls at that shape, so the kernels can be held against their
    plain versions on exactly those inputs.
    args[name][shape] = (args, kwargs); calls[name][shape] = count."""

    def __init__(self):
        self.args = {}
        self.calls = {}
        self._saved = []

    def __enter__(self):
        import torch

        def clone(x):
            if torch.is_tensor(x):
                return x.clone()
            if isinstance(x, dict):
                return {k: clone(v) for k, v in x.items()}
            return x

        for name, (mod, attr, _, _) in kernel_modules().items():
            orig = getattr(mod, attr)

            def rec(*a, _orig=orig, _name=name, **kw):
                shp = call_shape(a)
                seen = self.args.setdefault(_name, {})
                if shp not in seen:
                    seen[shp] = ([clone(x) for x in a],
                                 {k: clone(x) for k, x in kw.items()})
                calls = self.calls.setdefault(_name, {})
                calls[shp] = calls.get(shp, 0) + 1
                return _orig(*a, **kw)

            self._saved.append((mod, attr, orig))
            setattr(mod, attr, rec)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self._saved:
            setattr(mod, attr, orig)
        return False


def reset_counts():
    for mod, _, _, _ in kernel_modules().values():
        mod.reset_launches()


def counts():
    return {name: cnt() for name, (_, _, _, cnt) in kernel_modules().items()}


def time_ms(fn, reps=20, warm=3):
    """Median milliseconds of fn() on the card (CUDA events per call)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms_by_kernel(fn, reps=5):
    """Device milliseconds per call of fn(), by CUDA kernel name, from
    torch.profiler; plus the device busy share of the window. Returns
    ({}, None) when the profiler records no device time here."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    by = {}
    for e in prof.key_averages():
        us = e.self_device_time_total     # self time: no double counting
        if us > 0:
            by[e.key] = us / reps / 1e3
    busy = sum(by.values()) * reps * 1e3 / wall_us if by else None
    return by, busy


def device_ms_by_op(fn):
    """Device milliseconds of one call of fn() by PyTorch op (aten::...),
    each op charged with the kernels it launched itself."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3
            for e in prof.key_averages()
            if e.key.startswith("aten::") and e.self_device_time_total > 0}


def layer_ms(nh, state):
    """Wall milliseconds of one NH big step by layer: the acoustic loops
    (dyn_core_nh), the vertical remaps (remap_nh) and the rest, each call
    synchronised before and after."""
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.model import dyn_core, fv_dynamics
    acc = {"dyn_core_nh": 0.0, "remap_nh": 0.0}
    saved = [(dyn_core, "dyn_core_nh"), (fv_dynamics, "remap_nh")]
    origs = [getattr(m, a) for m, a in saved]

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            acc[name] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    for (m, a), o in zip(saved, origs):
        setattr(m, a, timed(a, o))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nh.step(state)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        for (m, a), o in zip(saved, origs):
            setattr(m, a, o)
    acc["rest"] = total - acc["dyn_core_nh"] - acc["remap_nh"]
    acc["total"] = total
    return acc


def own_kernels_ms(by):
    """Device ms of the port's own kernels in a profile of one wrapper call:
    every kernel but PyTorch's (at::) and the copies and fills."""
    hits = [v for k, v in by.items()
            if "at::" not in k and "Memcpy" not in k and "Memset" not in k]
    return sum(hits) if hits else None


def flatten_outputs(out):
    from types import SimpleNamespace
    if isinstance(out, SimpleNamespace):
        return [(k, v) for k, v in sorted(vars(out).items())
                if v is not None]
    if isinstance(out, tuple):
        return [(str(i), v) for i, v in enumerate(out)]
    return [("0", out)]


def sw_view(name, out, n):
    """The part of an SW-path kernel output the SW step consumes: compute walls
    for the fluxes, compute corners for ke and a2b."""
    if name == "tp2d_sweep":
        return out
    wsl = slice(H, H + n + 1)
    return out[..., wsl, wsl]


def nbytes(t):
    return t.numel() * t.element_size()


def metric_operands(name, args):
    """The metric planes a kernel reads from the grid pack argument."""
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import csw, dsw
    g = None
    for a in args:
        if hasattr(a, "halo"):
            g = a
    if g is None:
        return []
    names = {"a2b_ord4": ("dxa", "dya", "a2b_corner_w", "edge_w_full",
                          "edge_e_full", "edge_s_full", "edge_n_full"),
             "c_sw": csw.METRICS, "d_sw_fluxes": dsw.FLUX_METRICS,
             "d_sw_winds": dsw.WIND_METRICS}.get(name, ())
    return [getattr(g, nm) for nm in names]


def kernel_bound_ms(name, args, kw, outs, points, dtype_name):
    """Least time for the work: the larger of the bytes the function must
    move (each tensor argument and metric plane read once, each output
    written once) over the memory rate and the estimated operations over
    the f32 peak."""
    import torch
    seen, byts = set(), 0
    flat = list(args) + list(kw.values()) + metric_operands(name, args)
    for a in flat:
        items = a.values() if isinstance(a, dict) else [a]
        for x in items:
            if torch.is_tensor(x) and id(x) not in seen:
                seen.add(id(x))
                byts += nbytes(x)
    byts += sum(nbytes(o) for o in outs)
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_POINT[name] * points / PEAK_FLOPS.get(
        dtype_name, PEAK_FLOPS["float32"]) * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations"


def compare(label, name, args, kw, n, tol, sw=False):
    """One launch of a kernel wrapper against its plain version on the same
    inputs; fails on a missing launch, a disagreeing non-finite pattern or
    an error over tol x max|ref| in any output. Returns (max |diff|, the
    wrapper's outputs)."""
    import torch
    mod, attr, plain, cnt = kernel_modules()[name]
    before = cnt()
    got = flatten_outputs(getattr(mod, attr)(*args, **kw))
    torch.cuda.synchronize()
    require(cnt() == before + 1,
            f"{label}: {name} wrapper did not launch its kernel")
    ref = dict(flatten_outputs(plain(*args, **kw)))
    err, worst, nflip = 0.0, 0.0, 0
    for key, o in got:
        r = ref[key]
        if sw:
            o, r = sw_view(name, o, n), sw_view(name, r, n)
        o, r = o.double(), r.double()
        fin = torch.isfinite(r)
        require(bool(torch.equal(fin, torch.isfinite(o))),
                f"{label}: {name} output {key}: non-finite points differ "
                f"from the plain version")
        require(bool(fin.any()), f"{label}: {name} output {key} not finite")
        if sw:
            require(bool(fin.all()), f"{label}: {name} output not finite")
        d = torch.where(fin, (o - r).abs(), torch.zeros_like(r))
        m = float(torch.where(fin, r.abs(), torch.zeros_like(r)).max())
        e = float(d.max())
        err = max(err, e)
        rel = e / m if m > 0 else e
        worst = max(worst, rel)
        nflip += int((d > 1e-6 * m).sum())
    log(f"  {label} {name}: max|diff| {err:.3e}, worst output "
        f"{worst:.3e} x max|ref| (tol {tol:g}); points over 1e-6 rel: "
        f"{nflip}")
    require(worst <= tol, f"{label}: {name} disagrees with its plain "
                          f"version ({worst:.3e} > {tol:g})")
    return err, [o for _, o in got]


def points_of(name, args, n):
    """Output points of one call: 6 x levels x (n+1)^2."""
    q = args[1] if name == "sim1" else args[0]
    return q.shape[0] * q.shape[1] * (n + 1) ** 2


def check_kernels(cap, names, n, tol, label, measure, sw=False):
    """Kernel against plain version on the captured inputs, at every call
    shape the main path gave it. Returns {name: [record per shape]}, each
    with the shape, the calls at that shape in the captured run, the error
    and (if measure) the times."""
    recs = {}
    for name in names:
        mod, attr, plain, _ = kernel_modules()[name]
        require(name in cap.args, f"{label}: main path never reached {name}")
        recs[name] = []
        for shp, (args, kw) in cap.args[name].items():
            calls = cap.calls[name][shp]
            err, got = compare(f"{label} {list(shp)} x{calls}", name, args,
                               kw, n, tol, sw=sw)
            rec = {"shape": list(shp), "calls": calls, "max_abs_err": err}
            if measure:
                wrapper = getattr(mod, attr)
                ms = time_ms(lambda: wrapper(*args, **kw))
                plain_ms = time_ms(lambda: plain(*args, **kw), reps=5, warm=1)
                bound, by = kernel_bound_ms(name, args, kw, got,
                                            points_of(name, args, n),
                                            str(got[0].dtype).split(".")[-1])
                kms = own_kernels_ms(device_ms_by_kernel(
                    lambda: wrapper(*args, **kw))[0])
                rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                           bound_by=by, kernel_ms=kms)
                log(f"    {name} {list(shp)}: wrapper {ms:.4f} ms (kernel "
                    f"alone {kms} ms), plain {plain_ms:.4f} ms, bound "
                    f"{bound:.4f} ms ({by}); {calls} calls per step")
            recs[name].append(rec)
    return recs


def per_launch(shapes):
    """One kernel's numbers over the main path's calls: ms, plain_ms,
    bound_ms and kernel_ms as means per launch, weighted by the calls at
    each shape (so times x launches is the path's total), the largest
    error, the bound_by of the shape with the largest summed bound, and the
    device ms per step of the kernel alone (kernel ms x calls, summed)."""
    calls = sum(s["calls"] for s in shapes)
    out = {"max_abs_err": max(s["max_abs_err"] for s in shapes)}
    for key in ("ms", "plain_ms", "bound_ms", "kernel_ms"):
        vals = [s.get(key) for s in shapes]
        out[key] = (None if None in vals else
                    sum(v * s["calls"] for v, s in zip(vals, shapes)) / calls)
    out["bound_by"] = max(shapes, key=lambda s: s["bound_ms"] * s["calls"])[
        "bound_by"]
    out["kernel_ms_per_step"] = (None if out["kernel_ms"] is None
                                 else out["kernel_ms"] * calls)
    return out


def check_other_hords(cap, n, tol, label):
    """The hords a kernel takes besides the SW path's (SWConfig's default
    6), each against the plain version on the captured inputs with only the
    hord changed."""
    for name, pos in HORD_ARG.items():
        mod = kernel_modules()[name][0]
        for args, kw in cap.args[name].values():
            require(len(args) > pos, f"{name}: hord not passed by position")
            for hord in mod.KERNEL_HORDS:
                if hord != args[pos]:
                    compare(f"{label} hord {hord}", name,
                            args[:pos] + [hord] + args[pos + 1:], kw, n, tol,
                            sw=True)


def sw_setup(npx, dtype, device, geom=None):
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.grid.metrics import (
        build_grid_geometry)
    from gfdl_atmos_cubed_sphere_tpu_torch.init import sw_cases
    from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import (
        build_grid_ops)
    from gfdl_atmos_cubed_sphere_tpu_torch.model.sw_dynamics import (
        prepare_phis)
    t0 = time.perf_counter()
    if geom is None:
        geom = build_grid_geometry(npx, ng=H)
    t_metrics = time.perf_counter() - t0
    g = build_grid_ops(npx, dtype=dtype, device=device, geom=geom)
    ic = sw_cases.case2(geom)
    prepare_phis(g, ic["phis"])
    state = [torch.as_tensor(ic[k], dtype=dtype, device=g.device)
             for k in ("delp", "u", "v")]
    return g, geom, state, t_metrics


class NHCase:
    """The dry nonhydrostatic big step fv_dynamics_nh on one grid:
    Jablonowski-Williamson baroclinic wave (perturbed, dry) on set_eta(K),
    dp0 = diff(ak) + diff(bk) * 1e5 (bench.py:83), q = {}."""

    NAMES = ("delp", "pt", "u", "v", "w", "delz")

    def __init__(self, npx, npz, dt, k_split, n_split, dtype, device,
                 geom=None, ic=None):
        from gfdl_atmos_cubed_sphere_tpu_torch.grid.fv_eta import set_eta
        from gfdl_atmos_cubed_sphere_tpu_torch.grid.metrics import (
            build_grid_geometry)
        from gfdl_atmos_cubed_sphere_tpu_torch.init.baroclinic import (
            jw_baroclinic)
        from gfdl_atmos_cubed_sphere_tpu_torch.model.dyn_core import (
            DynConfig)
        from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import (
            build_grid_ops, state_from_arrays)
        from gfdl_atmos_cubed_sphere_tpu_torch.model.sw_dynamics import (
            prepare_phis)
        import numpy as np
        t0 = time.perf_counter()
        self.geom = geom or build_grid_geometry(npx, ng=H)
        _, self.ptop, self.ak, self.bk = set_eta(npz)
        self.ic = ic or jw_baroclinic(self.geom, npz, self.ak, self.bk,
                                      self.ptop, perturb=True, moist=False)
        self.t_setup = time.perf_counter() - t0
        self.g = build_grid_ops(npx, dtype=dtype, device=device,
                                geom=self.geom)
        prepare_phis(self.g, self.ic["phis"])
        self.dp0 = np.diff(self.ak) + np.diff(self.bk) * 1.0e5
        self.cfg = DynConfig(npx=npx, npz=npz, dt=dt, k_split=k_split,
                             n_split=n_split, **NH_CFG)
        st = state_from_arrays(self.ic, dtype=dtype, device=device)
        self.state = [st[k] for k in self.NAMES]

    def step(self, state):
        from gfdl_atmos_cubed_sphere_tpu_torch.model.fv_dynamics import (
            fv_dynamics_nh)
        r = fv_dynamics_nh(*state, {}, self.g, self.cfg, self.ak, self.bk,
                           self.ptop, self.dp0)
        return [getattr(r, k) for k in self.NAMES]


def mass(g, delp):
    import torch
    ctr = slice(H, H + g.n)
    return float(torch.sum(delp.double() * g.area[..., ctr, ctr].double()))


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "unknown"


def timed_steps(step, state, nsteps):
    """nsteps of step() behind a scalar readback barrier: (s/step, state)."""
    import torch
    t0 = time.perf_counter()
    for _ in range(nsteps):
        state = list(step(state))
    float(torch.sum(state[0]))                           # readback barrier
    return (time.perf_counter() - t0) / nsteps, state


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from gfdl_atmos_cubed_sphere_tpu_torch.model.sw_dynamics import (
            SWConfig, make_sw_step)
        from gfdl_atmos_cubed_sphere_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port package is not importable ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build(force=True)
    log(f"phase 1 build: nvcc {time.perf_counter() - t0:.1f} s for "
        f"{len(secs)} kernels (" + ", ".join(f"{k} {v:.1f} s" for k, v in
                                             secs.items()) + ")")

    # ---- main-path inputs ---------------------------------------------------
    npx = 769
    g, geom, state, t_metrics = sw_setup(npx, torch.float32, "cuda")
    log(f"sw_c768 grid: host metric precompute {t_metrics:.1f} s")
    cfg = SWConfig(npx=npx, dt=C768_DT, n_split=1)
    sw_step = make_sw_step(g, cfg)

    def step(st):
        return sw_step(*st, None, None)

    mass0 = mass(g, state[0])
    with Capture() as cap768:
        state = list(step(state))
        float(torch.sum(state[0]))
    g48, geom48, st48, _ = sw_setup(49, torch.float64, "cuda")
    with Capture() as cap48:
        make_sw_step(g48, SWConfig(npx=49, dt=1800.0, n_split=2))(
            *st48, None, None)

    nh = NHCase(193, 79, 450.0, 2, 6, torch.float32, "cuda")
    log(f"c192_nh grid + baroclinic state: host precompute "
        f"{nh.t_setup:.1f} s")
    nh_mass0 = mass(nh.g, nh.state[0])
    with Capture() as cap192:
        nh_state = nh.step(nh.state)
        float(torch.sum(nh_state[0]))
    nh24 = NHCase(25, 10, 900.0, 1, 2, torch.float64, "cuda")
    with Capture() as cap24:
        nh24.step(nh24.state)
    torch.cuda.synchronize()

    # ---- 2. kernels against their plain versions ----------------------------
    log("phase 2 kernels vs plain versions")
    shapes_sw = check_kernels(cap768, SW_KERNELS, npx - 1, 1e-4,
                              "sw_c768 f32", measure=True, sw=True)
    check_kernels(cap48, SW_KERNELS, 48, 1e-12, "C48 f64", measure=False,
                  sw=True)
    check_other_hords(cap768, npx - 1, 1e-4, "sw_c768 f32")
    check_other_hords(cap48, 48, 1e-12, "C48 f64")
    del cap768, cap48
    shapes_nh = check_kernels(cap192, NH_KERNELS, 192, 1e-4, "c192_nh f32",
                              measure=True)
    check_kernels(cap24, NH_KERNELS, 24, 1e-12, "C24L10 f64", measure=False)
    for name, per in NH_PER_STEP.items():
        got = sum(cap192.calls.get(name, {}).values())
        require(got == per, f"c192_nh: {name} called {got} times in the "
                            f"captured big step, expected {per}")
    del cap192, cap24
    recs_sw = {k: per_launch(v) for k, v in shapes_sw.items()}
    recs_nh = {k: per_launch(v) for k, v in shapes_nh.items()}

    # ---- 3. card with kernels vs CPU with plain versions --------------------
    cfg48 = SWConfig(npx=49, dt=1800.0, n_split=2)
    gcpu, _, stcpu, _ = sw_setup(49, torch.float64, "cpu", geom=geom48)
    scard, sc = list(st48), list(stcpu)
    fcard, fcpu = make_sw_step(g48, cfg48), make_sw_step(gcpu, cfg48)
    worst = 0.0
    for _ in range(4):
        scard = list(fcard(*scard, None, None))
        sc = list(fcpu(*sc, None, None))
    for nm, a, b in zip(("delp", "u", "v"), scard, sc):
        r = float((a.cpu() - b).abs().max() / b.abs().max())
        worst = max(worst, r)
        log(f"  C48 f64 4 steps {nm}: card vs CPU {r:.3e} x field max")
    log(f"phase 3 SW step card vs CPU: worst {worst:.3e} (tol 1e-10)")
    require(worst <= 1e-10, "SW step on the card disagrees with the CPU")
    del g48, gcpu

    nh24c = NHCase(25, 10, 900.0, 1, 2, torch.float64, "cpu",
                   geom=nh24.geom, ic=nh24.ic)
    nh24f = NHCase(25, 10, 900.0, 1, 2, torch.float32, "cuda",
                   geom=nh24.geom, ic=nh24.ic)
    scard, sc, sf = list(nh24.state), list(nh24c.state), list(nh24f.state)
    for _ in range(2):
        scard = nh24.step(scard)
        sc = nh24c.step(sc)
        sf = nh24f.step(sf)
    for nm, b in zip(NHCase.NAMES, sc):
        require(bool(torch.isfinite(b).all()), f"NH CPU step: NaN in {nm}")
    bad = []
    for nm, a, f, b in zip(NHCase.NAMES, scard, sf, sc):
        top = float(b.abs().max())
        r = float((a.cpu() - b).abs().max()) / top
        ctl = float((f.cpu().double() - b).abs().max()) / top
        tol = NH_CARD_TOL.get(nm, 1e-10)
        log(f"  C24L10 f64 2 big steps {nm}: card vs CPU {r:.3e} x its max "
            f"(tol {tol:g}); control, the card in float32: {ctl:.3e}")
        if r > tol:
            bad.append(nm)
        require(ctl > tol, f"the control reads {nm} within its limit "
                           f"{tol:g}: the check could not tell a fault")
    log(f"phase 3 NH big step card vs CPU: over the limit {bad or 'none'}")
    require(not bad, f"NH step on the card disagrees with the CPU in {bad}")
    del nh24, nh24c, nh24f

    # ---- 4. full width sw_c768 ----------------------------------------------
    state = list(step(state))                            # warm-up
    float(torch.sum(state[0]))
    nsteps = 5
    reset_counts()
    sec, state = timed_steps(step, state, nsteps)
    sw_launches = counts()
    for nm, t in zip(("delp", "u", "v"), state):
        require(bool(torch.isfinite(t).all()), f"sw_c768: NaN or inf in {nm}")
    dm = abs(mass(g, state[0]) - mass0) / abs(mass0)
    pts = 6 * (npx - 1) ** 2 / sec
    log(f"phase 4 sw_c768 f32: {sec:.4f} s/step, {pts:.4e} pts/s on {card}; "
        f"mass change {dm:.3e}; launches {sw_launches}")
    require(dm <= 1e-5, f"sw_c768 mass drifted by {dm:.3e}")
    for name in SW_KERNELS:
        want = SW_PER_STEP[name] * nsteps * cfg.n_split
        require(sw_launches[name] == want,
                f"{name} launched {sw_launches[name]} times on the SW path "
                f"in {nsteps} steps, expected {want}")
    by, busy = device_ms_by_kernel(lambda: step(state), reps=2)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:6]
    log(f"  profile of 2 steps: device busy {busy} of the wall time; device "
        f"ms/step {sum(by.values()):.3f}; top: " + "; ".join(
            f"{k[:60]} {v:.3f}" for k, v in top))
    del g, state, sw_step

    # ---- 5. full width c192_nh (dry) ----------------------------------------
    nh_state = nh.step(nh_state)                          # warm-up
    float(torch.sum(nh_state[0]))
    nsteps = 5
    reset_counts()
    sec, nh_state = timed_steps(nh.step, nh_state, nsteps)
    nh_launches = counts()
    for nm, t in zip(NHCase.NAMES, nh_state):
        require(bool(torch.isfinite(t).all()), f"c192_nh: NaN or inf in {nm}")
    dm = abs(mass(nh.g, nh_state[0]) - nh_mass0) / abs(nh_mass0)
    ptslev = 6 * 192 ** 2 * 79 / sec
    log(f"phase 5 c192_nh dry f32: {sec:.4f} s/step, {ptslev:.4e} pts*lev/s "
        f"on {card}; mass change {dm:.3e} over {nsteps + 2} big steps; "
        f"launches {nh_launches}")
    require(dm <= 1e-5, f"c192_nh mass drifted by {dm:.3e}")
    for name, per in NH_PER_STEP.items():
        require(nh_launches[name] == per * nsteps,
                f"{name} launched {nh_launches[name]} times on the NH path in "
                f"{nsteps} big steps, expected {per * nsteps}")
    by, busy = device_ms_by_kernel(lambda: nh.step(nh_state), reps=1)
    own = own_kernels_ms(by)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:8]
    log(f"  profile of 1 big step: device busy {busy} of the wall time; "
        f"device ms/step {sum(by.values()):.3f}, of which the port's "
        f"kernels {own}; top: " + "; ".join(f"{k[:60]} {v:.3f}"
                                          for k, v in top))
    log("  device ms per big step by kernel (kernel alone x calls, summed "
        "over call shapes): " + ", ".join(
            f"{nm} {recs_nh[nm]['kernel_ms_per_step']:.3f}" + "".join(
                f" ({s['shape'][1]} levels: {s['kernel_ms']:.3f} x "
                f"{s['calls']})" for s in shapes_nh[nm]
                if len(shapes_nh[nm]) > 1)
            for nm in NH_KERNELS
            if recs_nh[nm]["kernel_ms_per_step"] is not None))
    ops = device_ms_by_op(lambda: nh.step(nh_state))
    log("  device ms per big step by PyTorch op (top 10): " + "; ".join(
        f"{k} {v:.3f}" for k, v in sorted(ops.items(),
                                          key=lambda kv: -kv[1])[:10]))
    log("  wall ms per big step by layer (synchronised): " + ", ".join(
        f"{k} {v:.1f}" for k, v in layer_ms(nh, nh_state).items()))

    kernels = []
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "kernel_ms")
    for name in REPLACES:
        on_nh = name in NH_KERNELS
        rec = recs_nh[name] if on_nh else recs_sw[name]
        launches = nh_launches[name] if on_nh else sw_launches[name]
        entry = {
            "name": name, "route": "cuda",
            "source": f"gfdl_atmos_cubed_sphere_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None,
            "kernel_ms": rec["kernel_ms"],
            "path": "c192_nh" if on_nh else "sw_c768",
            "shapes": (shapes_nh if on_nh else shapes_sw)[name]}
        if on_nh and name in recs_sw:
            sw = recs_sw[name]
            entry["sw_c768"] = {"launches": sw_launches[name],
                                **{k: sw[k] for k in keys},
                                "shapes": shapes_sw[name]}
        kernels.append(entry)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
