"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from gfdl_atmos_cubed_sphere_tpu_torch/csrc/
(nvcc, one process per source, all started together, into
build/torch_kernels/), then runs four phases and exits non-zero on the first
failure:

1. build: the seconds nvcc took;
2. each kernel against its plain PyTorch version on the card, on the inputs
   the main path hands it: at sw_c768 in float32 (max |diff| <= 1e-4 x
   max |ref|; the count of points over 1e-6 relative is printed, since a PPM
   limiter branch may flip under f32 rounding) and at C48 in float64
   (<= 1e-12 x max |ref|: the kernels are built with --fmad=false, so only
   operation order may differ); each with its time (CUDA events, median of
   20 after warm-up), the plain version's time and its bound. The tp sweep
   and ke_section kernels are checked the same way at every other hord
   they take (tp_sweep.KERNEL_HORDS, ke.KERNEL_HORDS) on the same inputs;
3. the SW step (case 2, C48, float64, n_split=2, 4 steps) on the card with
   the kernels against the same port on the CPU with the plain versions
   (<= 1e-10 x field max on delp, u, v);
4. the full-width sw_c768 step (npx=769, n_split=1, case 2, float32)
   through build_grid_ops and make_sw_step: 1 warm-up step, then 10 timed
   steps behind a scalar readback barrier, then 2 steps under the profiler
   (device busy share, device time by kernel). It asserts no NaN, a
   relative change of sum(delp * area) (in float64) <= 1e-5, and launch
   counts of exactly 2 (tp2d_sweep), 1 (ke_section) and 3 (a2b_ord4) per
   step. bench.py's sw_c768 uses dt=225 s; with n_split=1 that is one
   acoustic iteration of 225 s, a Courant number of 4.63 at C768, and the
   solver (JAX and port alike) overflows by the third or fourth step
   (devtools/sw_stability.py). The smoke keeps one acoustic iteration per
   step, the same work per step, at dt = 225/8 s, where the run stays
   finite.

Before the last line it prints the card's name and power limit and one JSON
line with each kernel's launches, error and times; the last line is
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
OPS_PER_POINT = {"tp2d_sweep": 200, "ke_section": 150, "a2b_ord4": 80}
REPLACES = {
    "tp2d_sweep": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_tp.py:177",
    "ke_section": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_sw.py:34",
    "a2b_ord4": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_a2b.py:45",
}
PER_STEP = {"tp2d_sweep": 2, "ke_section": 1, "a2b_ord4": 3}
# position of the hord argument in the calls of the wrappers that take one
HORD_ARG = {"tp2d_sweep": 3, "ke_section": 13}
KERNEL_SYMBOL = {"tp2d_sweep": "tp2d_sweep_kernel",
                 "ke_section": "ke_section_kernel",
                 "a2b_ord4": "a2b_ord4_kernel"}
C768_DT = 225.0 / 8        # see phase 4 in the module docstring


def log(msg):
    print(msg, flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"FAILED: {msg}")


def kernel_modules():
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import a2b, ke, tp_sweep
    # name: (module, wrapper, plain version)
    return {"tp2d_sweep": (tp_sweep, "tp2d_sweep", tp_sweep.tp2d_sweep_ref),
            "ke_section": (ke, "ke_section", ke.ke_section_ref),
            "a2b_ord4": (a2b, "a2b_ord4", a2b.a2b_ord4_ref)}


class Capture:
    """Records (cloned) the arguments of the first call of each kernel
    wrapper while the main path runs, so the kernels can be held against
    their plain versions on exactly those inputs."""

    def __init__(self):
        self.args = {}
        self._saved = []

    def __enter__(self):
        import torch

        def clone(x):
            return x.clone() if torch.is_tensor(x) else x

        for name, (mod, attr, _) in kernel_modules().items():
            orig = getattr(mod, attr)

            def rec(*a, _orig=orig, _name=name, **kw):
                if _name not in self.args:
                    self.args[_name] = ([clone(x) for x in a],
                                        {k: clone(x) for k, x in kw.items()})
                return _orig(*a, **kw)

            self._saved.append((mod, attr, orig))
            setattr(mod, attr, rec)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self._saved:
            setattr(mod, attr, orig)
        return False


def reset_counts():
    for mod, _, _ in kernel_modules().values():
        mod.reset_launches()


def counts():
    return {name: mod.launches for name, (mod, _, _) in
            kernel_modules().items()}


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


def kernel_only_ms(name, by):
    hits = [v for k, v in by.items() if KERNEL_SYMBOL[name] in k]
    return sum(hits) if hits else None


def compute_view(name, out, n):
    """The part of a kernel output the main path consumes: compute walls
    for the fluxes, compute corners for ke and a2b."""
    if name == "tp2d_sweep":
        return out
    wsl = slice(H, H + n + 1)
    return out[..., wsl, wsl]


def flatten_outputs(out):
    return list(out) if isinstance(out, tuple) else [out]


def nbytes(t):
    return t.numel() * t.element_size()


def kernel_bound_ms(name, args, outs, n, dtype_name):
    """Least time for the work: the larger of the bytes the function must
    move (each tensor argument read once, each output written once) over
    the memory rate and the estimated operations over the f32 peak."""
    import torch
    if name == "a2b_ord4":                  # (qin, g): the metrics it reads
        qin, g = args
        args = [qin, g.dxa, g.dya, g.a2b_corner_w, g.edge_w_full,
                g.edge_e_full, g.edge_s_full, g.edge_n_full]
    seen, byts = set(), 0
    for a in args:
        if torch.is_tensor(a) and id(a) not in seen:
            seen.add(id(a))
            byts += nbytes(a)
    byts += sum(nbytes(o) for o in outs)
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    points = outs[0].shape[0] * outs[0].shape[1] * (n + 1) ** 2
    t_ops = OPS_PER_POINT[name] * points / PEAK_FLOPS.get(
        dtype_name, PEAK_FLOPS["float32"]) * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations"


def compare(label, name, args, kw, n, tol):
    """One launch of a kernel wrapper against its plain version on the same
    inputs; fails on a missing launch, a non-finite output or an error over
    tol x max|ref|. Returns (max |diff|, the wrapper's outputs)."""
    import torch
    mod, attr, plain = kernel_modules()[name]
    before = mod.launches
    got = flatten_outputs(getattr(mod, attr)(*args, **kw))
    torch.cuda.synchronize()
    require(mod.launches == before + 1,
            f"{label}: {name} wrapper did not launch its kernel")
    ref = flatten_outputs(plain(*args, **kw))
    err, nflip, scale = 0.0, 0, 0.0
    for o, r in zip(got, ref):
        o = compute_view(name, o, n).double()
        r = compute_view(name, r, n).double()
        require(bool(torch.isfinite(r).all()) and
                bool(torch.isfinite(o).all()),
                f"{label}: {name} output not finite")
        m = float(r.abs().max())
        d = (o - r).abs()
        err = max(err, float(d.max()))
        scale = max(scale, m)
        nflip += int((d > 1e-6 * m).sum())
    rel = err / scale if scale > 0 else err
    log(f"  {label} {name}: max|diff| {err:.3e} = {rel:.3e} x max|ref| "
        f"(tol {tol:g}); points over 1e-6 rel: {nflip}")
    require(rel <= tol, f"{label}: {name} disagrees with its plain "
                        f"version ({rel:.3e} > {tol:g})")
    return err, got


def check_kernels(captured, n, tol, label, measure):
    """Kernel against plain version on the captured inputs. Returns
    {name: record} with error and (if measure) times."""
    recs = {}
    for name, (mod, attr, plain) in kernel_modules().items():
        require(name in captured, f"{label}: main path never reached {name}")
        args, kw = captured[name]
        err, got = compare(label, name, args, kw, n, tol)
        rec = {"max_abs_err": err}
        if measure:
            wrapper = getattr(mod, attr)
            ms = time_ms(lambda: wrapper(*args, **kw))
            plain_ms = time_ms(lambda: plain(*args, **kw), reps=10)
            bound, by = kernel_bound_ms(name, args, got, n,
                                        str(got[0].dtype).split(".")[-1])
            kms = kernel_only_ms(name, device_ms_by_kernel(
                lambda: wrapper(*args, **kw))[0])
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                       kernel_ms=kms)
            log(f"    {name}: wrapper {ms:.4f} ms (kernel alone {kms} ms), "
                f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by})")
        recs[name] = rec
    return recs


def check_other_hords(captured, n, tol, label):
    """The hords a kernel takes besides the main path's (SWConfig's default
    6), each against the plain version on the captured inputs with only the
    hord changed."""
    for name, pos in HORD_ARG.items():
        mod = kernel_modules()[name][0]
        args, kw = captured[name]
        require(len(args) > pos, f"{name}: hord not passed by position")
        for hord in mod.KERNEL_HORDS:
            if hord != args[pos]:
                compare(f"{label} hord {hord}", name,
                        args[:pos] + [hord] + args[pos + 1:], kw, n, tol)


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


def mass(g, delp):
    import torch
    ctr = slice(H, H + g.n)
    return float(torch.sum(delp.double() * g.area[..., ctr, ctr].double()))


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "unknown"


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
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build(force=True)
    log(f"phase 1 build: nvcc {time.perf_counter() - t0:.1f} s for "
        f"{len(secs)} kernels (" + ", ".join(f"{k} {v:.1f} s" for k, v in
                                             secs.items()) + ")")

    # ---- main-path inputs: one sw_c768 f32 step and one C48 f64 step ---------
    npx = 769
    g, geom, state, t_metrics = sw_setup(npx, torch.float32, "cuda")
    log(f"sw_c768 grid: host metric precompute {t_metrics:.1f} s")
    cfg = SWConfig(npx=npx, dt=C768_DT, n_split=1)
    step = make_sw_step(g, cfg)
    mass0 = mass(g, state[0])
    with Capture() as cap768:
        state = list(step(*state, None, None))
        float(torch.sum(state[0]))
    g48, geom48, st48, _ = sw_setup(49, torch.float64, "cuda")
    with Capture() as cap48:
        make_sw_step(g48, SWConfig(npx=49, dt=1800.0, n_split=2))(
            *st48, None, None)
    torch.cuda.synchronize()

    # ---- 2. kernels against their plain versions -------------------------------
    log("phase 2 kernels vs plain versions")
    recs = check_kernels(cap768.args, npx - 1, 1e-4, "sw_c768 f32",
                         measure=True)
    check_kernels(cap48.args, 48, 1e-12, "C48 f64", measure=False)
    check_other_hords(cap768.args, npx - 1, 1e-4, "sw_c768 f32")
    check_other_hords(cap48.args, 48, 1e-12, "C48 f64")
    del cap768, cap48

    # ---- 3. SW step, card with kernels vs CPU with plain versions ---------------
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

    # ---- 4. full width sw_c768 ---------------------------------------------------
    state = list(step(*state, None, None))               # warm-up
    float(torch.sum(state[0]))
    nsteps = 10
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(nsteps):
        state = list(step(*state, None, None))
    float(torch.sum(state[0]))                           # readback barrier
    sec = (time.perf_counter() - t0) / nsteps
    launches = counts()
    for nm, t in zip(("delp", "u", "v"), state):
        require(bool(torch.isfinite(t).all()), f"sw_c768: NaN or inf in {nm}")
    dm = abs(mass(g, state[0]) - mass0) / abs(mass0)
    pts = 6 * (npx - 1) ** 2 / sec
    log(f"phase 4 sw_c768 f32: {sec:.4f} s/step, {pts:.4e} pts/s on {card}; "
        f"mass change {dm:.3e}; launches {launches}")
    require(dm <= 1e-5, f"sw_c768 mass drifted by {dm:.3e}")
    for name, per in PER_STEP.items():
        require(launches[name] == per * nsteps * cfg.n_split,
                f"{name} launched {launches[name]} times in {nsteps} steps, "
                f"expected {per * nsteps}")

    by, busy = device_ms_by_kernel(
        lambda: step(*state, None, None), reps=2)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:6]
    log(f"  profile of 2 steps: device busy {busy} of the wall time; device "
        f"ms/step {sum(by.values()):.3f}; top: " + "; ".join(
            f"{k[:60]} {v:.3f}" for k, v in top))
    log("  device ms/step in the port's kernels: " + ", ".join(
        f"{nm} {kernel_only_ms(nm, by)}" for nm in PER_STEP))

    kernels = []
    for name, rec in recs.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"gfdl_atmos_cubed_sphere_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None,
            "kernel_ms": rec["kernel_ms"]})
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
