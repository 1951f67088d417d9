"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from gfdl_atmos_cubed_sphere_tpu_torch/csrc/
(nvcc, one process per source, all started together, into
build/torch_kernels/), then runs its phases and exits non-zero on the first
failure. Four main paths run on the card: the shallow-water step
(sw_c768), the dry nonhydrostatic big step fv_dynamics_nh at C192L79
(c192_nh made dry: q = {}, no moist physics), the moist c192_nh headline
step (bench.py's six GFDL-MP tracers, MPConfig(): tracer_2d on the rank-5
tp sweep kernel, the tracer remap, neg_adj3 and the GFDL microphysics) and
the moist hydrostatic c192_hydro step fv_dynamics_hydro (bench.py:34-35:
the hydrostatic forms of c_sw and d_sw, the column kernels pgradc_fused,
pkgz and geopk, one_grad_p's batched a2b, the same tracers and physics).
Phase 8 drives the solo driver (driver/solo.py: its Atmosphere and its
CLI), as users start the system, through the same kernels.

1. build: the seconds nvcc took for the eight sources;
2. each kernel against its plain PyTorch version on the card, on the inputs
   the main paths hand it (the first call of each wrapper at each call
   shape, captured, with the calls at that shape counted: on the NH path
   a2b runs at nh_p_grad's batched 3(K+1)+K levels and at the Smagorinsky
   operand's K levels, 12 calls each per big step): the
   tp sweep, ke_section and a2b kernels on one sw_c768 float32 step and
   one C48 float64 SW step, and the c_sw, d_sw fluxes, d_sw
   winds, sim1, tp sweep and a2b kernels on one C192L79 float32 big step
   and one C24L10 float64 big step (dt = 900 s, k_split = 1,
   n_split = 2), dry and moist: the moist steps add the rank-5 tp sweep
   (tracer_2d's [6, 6, K, P, P] tracers with shared [6, 1, K, ...] winds),
   timed at C192L79, and every other NH kernel is checked again on the
   moist inputs; the c_sw (hydrostatic form), d_sw fluxes (hydrostatic
   form), d_sw winds, pgradc_fused, pkgz, geopk, tp sweep (rank 5) and a2b
   (one_grad_p's [6, 2(K+1), P, P]) kernels on one C192L79 float32 and one
   C24L10 float64 c192_hydro step, all timed at C192L79, and
   fv_tp_2d_kernel, which no path calls, on that step's d_sw pt-transport
   operands. Tolerance per output: max |diff| <= 1e-4 x max |ref| in
   float32 (the count of points over 1e-6 relative is printed: a limiter
   branch may flip under float32 rounding) and <= 1e-12 in float64, but
   max |diff| 0 for pgradc_fused and pkgz (EXACT), which keep the plain
   version's operation order; the non-finite points (NaN in the
   cube-corner halo) must coincide. Those two are also held bit for bit
   at COLUMN_DEPTHS, c192_hydro's C192 inputs with their levels repeated
   to K = 79 in float64 and K = 32 and 125 in both dtypes, one device
   kernel a call: the launch plans of ops/pg_col.py that the main paths
   do not take, and every count of levels pgradc_fused's last batch can
   hold (K % 4 of 3, 2, 0 and 1 at K = 79, 10, 32 and 125). Each
   with its time (CUDA events, median of 20 after warm-up; the kernel
   alone from the profiler, with the device kernels per call and the
   ratio to the bound; for the two d_sw stages each kernel's launches and
   ms per call; a profiler reading that lost a launch's record is taken
   again, and the smoke fails after five incomplete ones), the plain
   version's time and its bound. For a2b_ord4, sim1,
   tp2d_sweep, c_sw, pgradc_fused and pkgz, at every call shape, f32 and
   f64, it prints every device kernel one wrapper call issues, PyTorch's
   ops, copies and fills included ("device_kernels_per_call" in the
   kernels line's shapes), and fails unless each issues exactly 1 in all
   but sim1, which must issue exactly 1 of its own (its copies of
   non-contiguous operands would be listed). It prints the resources of
   the tp sweep, c_sw, d_sw stage and column kernels (these at K = 79 and
   125) as built (registers and spill bytes per thread, static and dynamic
   shared memory per block, resident blocks per SM; "resources" in the
   kernels line). The
   tp sweep and ke_section kernels are also checked at every other hord
   they take (tp_sweep.KERNEL_HORDS, ke.KERNEL_HORDS) on the SW inputs;
3. the SW step (case 2, C48, float64, n_split=2, 4 steps) and the NH big
   step (C24L10, float64, dt = 900 s, k_split = 1, n_split = 2, 2 steps)
   on the card with the kernels against the same port on the CPU with the
   plain versions, dry and moist (the six tracers and the GFDL MP), and
   the moist hydrostatic big step likewise, each field against its own
   maximum: <= 1e-10 on the SW delp, u, v, the NH delp, pt, u, v, delz,
   the hydrostatic delp, pt, u, v and the six tracers but for the
   hydrostatic ice_wat, <= 5e-9 on the NH w and <= 1e-8 on the hydrostatic
   ice_wat. Those two are the ill-conditioned fields. w carries the
   nonhydrostatic pressure perturbation, a difference of ~1e5 Pa
   quantities, so last-bit differences between the card's and the CPU's
   exp/log move it by some 1e-10 of its maximum. The moist steps make
   only ~5e-9 kg/kg of ice in two steps, the remainder of the
   microphysics' larger exchanges, and the same last-bit differences move
   it by 3e-11 to 3.1e-9 of that maximum on the hydrostatic step (4e-11 to
   9e-10 on the NH step, where the card reads under 1e-10;
   devtools/nh_w_conditioning.py [--moist] [--hydro] measures how far on
   the CPU). As a control, the same two big steps run on the card in
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
   launch counts per big step of c_sw 12, d_sw fluxes 12, d_sw winds 12
   (one tile-fused kernel each, their PPM sweeps inside), sim1 24,
   tp2d_sweep 12 (update_dz_d) and a2b_ord4 24 (nh_p_grad and the
   Smagorinsky operand);
6. the moist c192_nh headline step at full width (as phase 5 with
   adiabatic = False, the moist baroclinic wave, sphum from it and the
   five condensates at 1e-6, MPConfig()): 1 warm-up step, 5 timed steps
   behind a scalar readback barrier, 1 step under the profiler (s/step,
   pts*lev/s, device busy share, device ms by kernel and by op, wall ms
   by layer, peak device memory, each tracer_2d call's subcycle count
   nsplt). It asserts finite fields and tracers, the mass change, phase
   5's launch counts and rank-5 tp2d_sweep launches = the sum of nsplt;
7. the moist c192_hydro step at full width (C192L79, float32, dt = 450 s,
   k_split = 1, n_split = 6, DynConfig's defaults otherwise, the moist
   state of phase 6) as phase 6: launch counts per big step of c_sw 6,
   d_sw fluxes 6, d_sw winds 6, pgradc_fused 6, pkgz 6, geopk 1,
   a2b_ord4 6, sim1 0, and rank-5 tp2d_sweep launches = the sum of nsplt;
8. the solo driver (driver/solo.py), without tracers, with Held-Suarez
   forcing: (a) at C24L10 in float64, hydrostatic and nonhydrostatic with
   the Rayleigh sponge (tau = 10 days, its cutoff under the 500 hPa top of
   set_eta(10)), the energy fixer (consv_te = 1) and the angular-momentum
   fixer, 2 big steps and then adiabatic_init (dt < 0 in its backward
   passes) on the card against the CPU with phase 3's limits and a float32
   control; and 8 hydrostatic steps without physics on the card, where the
   relative change of the global total energy with consv_te = 1 must be
   under 1e-6 and under 0.2 x the change without it; (b) at C192L79 in
   float32, hydrostatic with c192_hydro's dt = 450 s, k_split = 1,
   n_split = 6, with the fixers and sponge (tau = 10, consv_te = 1,
   consv_am) and without, then nonhydrostatic with them and c192_nh's
   splits and damping: 1 warm-up step, 5 timed atmosphere() steps behind a
   scalar readback (s/step, pts*lev/s, mass and total-energy change, peak
   memory, launches per step, which must be phase 7's (hydrostatic, no
   tracer sweep) and phase 5's (nonhydrostatic)), 1 step under the
   profiler (busy share), 1 synchronised step by layer (the acoustic
   loop, the remap, the sponge, the energy integrals and fixers,
   hs_forcing), hs_forcing and audit timed on the state, the Timers
   table, and the cost of the fixers and sponge as on minus off;
   finite fields, and a mass change <= 1e-5 with them off; (c) the restart:
   2 steps of the hydrostatic run with both fixers (no sponge: its
   reference winds are the state at each start), write_restart as .fvio
   and .npz (seconds), 1 more step; each file read into a new Atmosphere
   and stepped once equals the continuous run bit for bit in every field;
   (d) the CLI, main() with the README's quick-start options at C48L32 for
   3 steps with an audit every 2 and a restart written, then a second
   main() from that restart. Files go to build/torch_smoke/ and are
   removed.

Before the last line it prints the card's name and power limit and one JSON
line with each kernel's launches (those of its path's timed phase: 6 for
the NH kernels, 7 for the column kernels and fv_tp_2d, which no path
calls), error and times, and the kernel's numbers on the other paths it
runs on; for a kernel its path calls at several shapes, ms, plain_ms,
bound_ms and kernel_ms are means per launch weighted by the calls at each
shape, and "shapes" lists each shape's own numbers ("depths": the column
kernels' checks at COLUMN_DEPTHS); "solo_hydro" and
"solo_nh" give its launches per big step on phase 8b's two forms (with the
fixers on). The last line is
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
                 "sim1": 80, "pgradc_fused": 60, "pkgz": 30, "geopk": 40,
                 "fv_tp_2d": 260}
REPLACES = {
    "tp2d_sweep": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_tp.py:177",
    "ke_section": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_sw.py:34",
    "a2b_ord4": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_a2b.py:45",
    "c_sw": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_csw.py:58",
    "d_sw_fluxes": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_dsw.py:155",
    "d_sw_winds": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_dsw.py:155",
    "sim1": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_nh.py:158",
    "pgradc_fused": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_col.py:234",
    "pkgz": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_col.py:301",
    "geopk": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_col.py:80",
    "fv_tp_2d": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_tp.py:80",
}
#: the CUDA source of each kernel where it is not csrc/<name>.cu
SOURCE = {"pgradc_fused": "col_pressure", "pkgz": "col_pressure",
          "geopk": "col_pressure", "fv_tp_2d": "tp2d_sweep"}
SW_KERNELS = ("tp2d_sweep", "ke_section", "a2b_ord4")
NH_KERNELS = ("c_sw", "d_sw_fluxes", "d_sw_winds", "sim1", "tp2d_sweep",
              "a2b_ord4")
HYDRO_KERNELS = ("c_sw", "d_sw_fluxes", "d_sw_winds", "pgradc_fused", "pkgz",
                 "geopk", "tp2d_sweep", "a2b_ord4")
SW_PER_STEP = {"tp2d_sweep": 2, "ke_section": 1, "a2b_ord4": 3}
# launches per big step at rank 4 (tracer_2d's rank-5 sweeps come on top:
# one per subcycle); fv_tp_2d_kernel is on no path
NH_PER_STEP = {"c_sw": 12, "d_sw_fluxes": 12, "d_sw_winds": 12, "sim1": 24,
               "tp2d_sweep": 12, "a2b_ord4": 24, "ke_section": 0,
               "pgradc_fused": 0, "pkgz": 0, "geopk": 0, "fv_tp_2d": 0}
HYDRO_PER_STEP = {"c_sw": 6, "d_sw_fluxes": 6, "d_sw_winds": 6, "sim1": 0,
                  "tp2d_sweep": 0, "a2b_ord4": 6, "ke_section": 0,
                  "pgradc_fused": 6, "pkgz": 6, "geopk": 1, "fv_tp_2d": 0}
# the grid planes a2b_ord4 and its plain version read
A2B_METRICS = ("dxa", "dya", "edge_s_full", "edge_n_full", "edge_w_full",
               "edge_e_full", "a2b_corner_w")
# the kernels whose every device kernel per wrapper call phase 2 counts
ALL_KERNELS_COUNTED = ("a2b_ord4", "sim1", "tp2d_sweep", "c_sw",
                       "pgradc_fused", "pkgz")
# the kernels phase 2 holds to their plain versions bit for bit
EXACT = ("pgradc_fused", "pkgz")
# the column depths phase 2 checks the column kernels at beside the main
# paths' (c192_hydro's 79 in float32, C24L10's 10 in float64): 79 in
# float64 (pgradc_fused 4 rows, pkgz 64 threads), the README's C48L32 CLI
# depth (the plans of K = 79 but pkgz's 128 threads in float64) and 125
# (pgradc_fused 4 / 2 rows, pkgz 64 / 32 threads in float32 / float64;
# the plans of 127), with 79 and 10 every remainder of pgradc_fused's
# batches of 4 levels
COLUMN_DEPTHS = ((79, ("float64",)), (32, ("float32", "float64")),
                 (125, ("float32", "float64")))


def col_plan_args(kernel, K):
    """The leading arguments of a column kernel's *_attrs export at depth
    K: (K, its plan's window rows or threads a block) for an element
    size."""
    def lead(itemsize):
        from gfdl_atmos_cubed_sphere_tpu_torch.ops import pg_col
        plan = pg_col.launch_plan(kernel, K, 198, 198, itemsize)
        return (K, plan.rows if kernel == "pgradc_fused" else plan.threads)
    return lead


# the kernels whose resources phase 2 reads from the built library (the
# redesigned tp sweep, c_sw and column kernels, and the d_sw stages that
# share their headers): {name: [(label, exported function, leading
# arguments, or a function of the element size that gives them)]}
RESOURCES = {
    "tp2d_sweep": [("", "tp2d_sweep_attrs", ())],
    "c_sw": [("", "c_sw_attrs", ())],
    "d_sw_fluxes": [("", "d_sw_fluxes_attrs", ())],
    "d_sw_winds": [("", "d_sw_winds_attrs", ())],
    "pgradc_fused": [(f"K{K}", "pgradc_fused_attrs",
                      col_plan_args("pgradc_fused", K)) for K in (79, 125)],
    "pkgz": [(f"K{K}", "pkgz_attrs", col_plan_args("pkgz", K))
             for K in (79, 125)],
}
# position of the hord argument in the calls of the wrappers that take one
HORD_ARG = {"tp2d_sweep": 3, "ke_section": 13}
C768_DT = 225.0 / 8        # see phase 4 in the module docstring
# card vs CPU, x each field's own maximum: 1e-10, and the own limits of the
# ill-conditioned fields, the NH w and the hydrostatic ice_wat (see phase 3
# in the module docstring)
CARD_TOL = {"NH": {"w": 5e-9}, "hydro": {"ice_wat": 1e-8}}
NH_CFG = dict(hydrostatic=False, adiabatic=True, dddmp=0.2, d_con=1.0,
              do_vort_damp=True)
# bench.py:34-35: c192_hydro takes DynConfig's defaults otherwise
HYDRO_CFG = dict(hydrostatic=True, adiabatic=True)
TRACERS = ("sphum", "liq_wat", "rainwat", "ice_wat", "snowwat", "graupel")
# phase 8, the solo driver: the fixers and the sponge; the splits of
# c192_hydro (bench.py:34-35) and c192_nh (bench.py:31-33); at C24L10 the
# sponge's cutoff sits under ptop = 500 hPa of set_eta(10) so that it acts
SOLO_FIX = dict(tau=10.0, consv_te=1.0, consv_am=True)
SOLO_HYDRO = dict(k_split=1, n_split=6)
SOLO_NH = dict(k_split=2, n_split=6, dddmp=0.2, d_con=1.0, do_vort_damp=True)
SOLO_C24 = dict(k_split=1, n_split=2, rf_cutoff=8.0e4)
SOLO_DIR = "build/torch_smoke"


def log(msg):
    print(msg, flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"FAILED: {msg}")


def kernel_modules():
    """name: (module, wrapper attribute, plain version, launch count)."""
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import (a2b, csw, dsw, ke,
                                                       pg_col, sim1, tp_sweep)
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
        "pgradc_fused": (pg_col, "pgradc_fused", pg_col.pgradc_fused_ref,
                         lambda: pg_col.launches["pgradc_fused"]),
        "pkgz": (pg_col, "pkgz", pg_col.pkgz_ref,
                 lambda: pg_col.launches["pkgz"]),
        "geopk": (pg_col, "geopk", pg_col.geopk_ref,
                  lambda: pg_col.launches["geopk"]),
        "fv_tp_2d": (tp_sweep, "fv_tp_2d_kernel", tp_sweep.fv_tp_2d_ref,
                     lambda: tp_sweep.launches_fv_tp_2d),
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


def timed_layers(run, targets, apart=()):
    """Wall milliseconds of one run() by layer: each call of a function of
    targets ([(module, attribute)]) synchronised before and after and
    summed under its name, and the rest. A call made inside another timed
    call counts to the outer one, except for the names in apart, which are
    listed on their own as well and not subtracted again from the rest."""
    import torch
    acc = {a: 0.0 for _, a in targets}
    origs = [getattr(m, a) for m, a in targets]
    depth = [0]

    def timed(name, fn):
        def call(*a, **kw):
            if depth[0] and name not in apart:
                return fn(*a, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            depth[0] += name not in apart
            try:
                out = fn(*a, **kw)
                torch.cuda.synchronize()
            finally:
                depth[0] -= name not in apart
            acc[name] += (time.perf_counter() - t0) * 1e3
            return out
        return call

    for (m, a), o in zip(targets, origs):
        setattr(m, a, timed(a, o))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        for (m, a), o in zip(targets, origs):
            setattr(m, a, o)
    acc["rest"] = total - sum(v for k, v in acc.items() if k not in apart)
    acc["total"] = total
    return acc


def layer_ms(nh, state):
    """Wall milliseconds of one big step by layer: the acoustic loops
    (dyn_core_nh or dyn_core_hydro), the vertical remaps (remap_nh or
    remap_hydro) and the rest, and on the moist path the tracer transport
    (tracer_2d), neg_adj3 and the GFDL microphysics (gfdl_mp_driver), each
    call synchronised before and after. mapn_tracer, the tracers' share of
    the remap, is listed too and is not subtracted again from the rest."""
    from gfdl_atmos_cubed_sphere_tpu_torch.model import (dyn_core,
                                                         fv_dynamics,
                                                         tracer_2d)
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import fv_mapz, fv_sg
    from gfdl_atmos_cubed_sphere_tpu_torch.physics import gfdl_mp
    form = "hydro" if nh.hydro else "nh"
    saved = [(dyn_core, f"dyn_core_{form}"), (fv_dynamics, f"remap_{form}")]
    if nh.moist:
        saved += [(tracer_2d, "tracer_2d"), (fv_sg, "neg_adj3"),
                  (gfdl_mp, "gfdl_mp_driver"), (fv_mapz, "mapn_tracer")]
    return timed_layers(lambda: nh.step(state), saved,
                        apart=("mapn_tracer",))


def solo_layer_ms(atm):
    """Wall milliseconds of one solo atmosphere() step by layer: the
    acoustic loop, the remap, the sponge, the energy integrals and the
    fixers (am_fixer with its own compute_aam), Held-Suarez, and the rest
    (the driver, the entry pressures, the halo of the winds)."""
    from gfdl_atmos_cubed_sphere_tpu_torch.model import (dyn_core,
                                                         fv_dynamics)
    from gfdl_atmos_cubed_sphere_tpu_torch.model import thermodynamics as th
    from gfdl_atmos_cubed_sphere_tpu_torch.physics import held_suarez
    form = "hydro" if atm.cfg.hydrostatic else "nh"
    return timed_layers(lambda: atm.atmosphere(1), [
        (dyn_core, f"dyn_core_{form}"), (fv_dynamics, f"remap_{form}"),
        (fv_dynamics, "rayleigh_super"), (th, f"total_energy_2d_{form}"),
        (th, "compute_aam"), (th, "am_fixer"), (th, "energy_fixer_dtmp"),
        (held_suarez, "hs_forcing")])


def is_own_kernel(key):
    """A device kernel of the port's own (not PyTorch's at::, not a copy or
    a fill)."""
    return "at::" not in key and "Memcpy" not in key and "Memset" not in key


def own_kernels_ms(by):
    """Device ms of the port's own kernels in a profile of one wrapper call:
    every kernel but PyTorch's (at::) and the copies and fills."""
    hits = [v for k, v in by.items() if is_own_kernel(k)]
    return sum(hits) if hits else None


def own_kernel_launches(fn, reps=5, own=True):
    """The port's own device kernels (every device kernel, PyTorch's ops,
    copies and fills included, when own is False) of one call of fn(),
    from torch.profiler: {kernel name: (device ms per call, launches per
    call)}. Fails unless a reading is complete."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.self_device_time_total > 0
               and (not own or is_own_kernel(e.key))]
        # the profiler can lose a launch's record (seen on the H100: 1 of
        # 5 sim1 launches recorded); each call launches the same kernels,
        # and every wrapper at least one of its own, so an empty reading or
        # a count that is no multiple of reps is read again
        whole = evs and all(e.count % reps == 0 for e in evs)
        if whole:
            break
        log(f"      (profiler lost kernel records: "
            f"{[(e.key[:40], e.count) for e in evs]} in {reps} calls; "
            f"read again)")
    require(whole, f"the profiler lost kernel records in 5 readings of "
                   f"{reps} calls: {[(e.key[:40], e.count) for e in evs]}")
    return {e.key: (e.self_device_time_total / reps / 1e3, e.count / reps)
            for e in evs}


def count_device_kernels(label, name, fn):
    """Every device kernel one wrapper call issues, printed: a2b_ord4,
    tp2d_sweep and c_sw must issue exactly one in all (no PyTorch op, copy
    or fill), sim1 exactly one of the port's own (its PyTorch copies of
    non-contiguous operands are printed). Returns the count of all."""
    every = own_kernel_launches(fn, reps=2, own=False)
    total = sum(c for _, c in every.values())
    mine = sum(c for k, (_, c) in every.items() if is_own_kernel(k))
    log(f"    {label} {name}: {total:g} device kernels per call in all, "
        f"{mine:g} of the port's own")
    for k, (v, c) in sorted(every.items(), key=lambda kv: -kv[1][0]):
        log(f"      {v:.4f} ms, {c:g} per call: {k[:110]}")
    if name != "sim1":
        require(total == 1, f"{label}: {name} issued {total:g} device "
                            f"kernels per call, not 1")
    else:
        require(mine == 1, f"{label}: sim1 issued {mine:g} kernels of its "
                           f"own per call, not 1")
    return total


def kernel_resources():
    """Registers per thread, local (spill) bytes per thread, static and
    dynamic shared memory per block and resident blocks per SM of the
    RESOURCES kernels, float32 and float64, read from the built libraries
    (cudaFuncGetAttributes, cudaOccupancyMaxActiveBlocksPerMultiprocessor)
    and printed. Returns {name: [record per form]}."""
    import ctypes
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import _build
    keys = ("registers", "spill_bytes", "static_smem", "dynamic_smem",
            "blocks_per_sm", "threads")
    recs = {}
    for name, forms in RESOURCES.items():
        lib = _build.library(SOURCE.get(name, name))
        for label, fn, lead in forms:
            for dtype, dname in ((0, "float32"), (1, "float64")):
                out = (ctypes.c_int * 6)()
                f = getattr(lib, fn)
                f.restype = ctypes.c_int
                args = lead(4 << dtype) if callable(lead) else lead
                rc = f(*args, dtype, out)
                require(rc == 0, f"{fn}: cudaError {rc}")
                rec = dict(zip(keys, list(out)), form=label, dtype=dname)
                recs.setdefault(name, []).append(rec)
                log(f"  resources {name} {label} {dname}: {out[0]} "
                    f"registers, {out[1]} spill bytes, {out[2]} + {out[3]} "
                    f"bytes of shared memory, {out[4]} blocks of {out[5]} "
                    f"threads an SM")
    return recs


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
    names = {"a2b_ord4": A2B_METRICS,
             "c_sw": csw.METRICS, "d_sw_fluxes": dsw.FLUX_METRICS,
             "d_sw_winds": dsw.WIND_METRICS,
             "pgradc_fused": ("rdxc", "rdyc")}.get(name, ())
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
    """Output points of one call: 6 x (tracers x) levels x (n+1)^2."""
    q = args[1] if name == "sim1" else args[0]
    lead = 1
    for d in q.shape[:-2]:
        lead *= d
    return lead * (n + 1) ** 2


def check_call(label, name, args, kw, calls, n, tol, measure, sw=False):
    """One kernel call against its plain version (and, if measure, its
    times and bound): the record of that call shape with the calls the path
    makes at it per step. The EXACT kernels are held to max |diff| 0."""
    mod, attr, plain, _ = kernel_modules()[name]
    shp = list(call_shape(args))
    if name in EXACT:
        tol = 0.0
    err, got = compare(f"{label} {shp} x{calls}", name, args, kw, n, tol,
                       sw=sw)
    rec = {"shape": shp, "calls": calls, "max_abs_err": err}
    wrapper = getattr(mod, attr)
    if name in ALL_KERNELS_COUNTED:
        rec["device_kernels_per_call"] = count_device_kernels(
            f"{label} {shp}", name, lambda: wrapper(*args, **kw))
    if measure:
        ms = time_ms(lambda: wrapper(*args, **kw))
        plain_ms = time_ms(lambda: plain(*args, **kw), reps=5, warm=1)
        bound, by = kernel_bound_ms(name, args, kw, got,
                                    points_of(name, args, n),
                                    str(got[0].dtype).split(".")[-1])
        own = own_kernel_launches(lambda: wrapper(*args, **kw))
        kms = sum(v[0] for v in own.values())
        nk = sum(v[1] for v in own.values())
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                   kernel_ms=kms, kernels_per_call=nk)
        log(f"    {name} {shp}: wrapper {ms:.4f} ms (kernel alone {kms} "
            f"ms, {kms / bound:.2f}x its bound, {nk:g} device kernels per "
            f"call), plain "
            f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}); {calls} calls "
            f"per step")
        if name in ("d_sw_fluxes", "d_sw_winds"):
            for k, (v, c) in sorted(own.items(), key=lambda kv: -kv[1][0]):
                log(f"      {v:.4f} ms, {c:g} launches per call: {k[:110]}")
    return rec


def check_kernels(cap, names, n, tol, label, measure, sw=False):
    """Kernel against plain version on the captured inputs, at every call
    shape the main path gave it. Returns {name: [record per shape]}, each
    with the shape, the calls at that shape in the captured run, the error
    and (if measure is True, or measure(name, shape) is) the times."""
    recs = {}
    for name in names:
        require(name in cap.args, f"{label}: main path never reached {name}")
        recs[name] = [
            check_call(label, name, args, kw, cap.calls[name][shp], n, tol,
                       measure is True or (callable(measure)
                                           and measure(name, shp)), sw=sw)
            for shp, (args, kw) in cap.args[name].items()]
    return recs


def check_column_depths(cap):
    """pgradc_fused and pkgz against their plain versions bit for bit at
    COLUMN_DEPTHS, on c192_hydro's captured C192 calls with their levels
    repeated (or cut) to K and cast to each dtype, with the plan each call
    takes and the device kernels it issues (1). Returns the records."""
    import torch
    from types import SimpleNamespace
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import pg_col
    recs = []
    for K, dnames in COLUMN_DEPTHS:
        for dname in dnames:
            dt = getattr(torch, dname)
            for name in EXACT:
                args, kw = next(iter(cap.args[name].values()))
                K0 = args[0].shape[1]
                lev = torch.arange(K, device=args[0].device) % K0

                def depth(x):
                    x = x[:, lev] if x.shape[1] == K0 else x
                    return x.to(dt).contiguous()

                P = args[0].shape[-1]
                plan = pg_col.launch_plan(name, K, P, P, dt.itemsize)
                if name == "pkgz":
                    new = [depth(x) for x in args[:3]] + list(args[3:])
                    shape = f"{plan.threads} threads"
                else:
                    g = args[5]
                    new = ([depth(x) for x in args[:5]]
                           + [SimpleNamespace(rdxc=g.rdxc.to(dt),
                                              rdyc=g.rdyc.to(dt))]
                           + list(args[6:]))
                    shape = f"{plan.rows} window rows"
                label = f"C192L{K} {dname}"
                err, _ = compare(f"{label} ({shape})", name, new, kw, 192,
                                 0.0)
                nk = count_device_kernels(label, name,
                                          lambda: getattr(pg_col, name)(
                                              *new, **kw))
                recs.append({"kernel": name, "K": K, "dtype": dname,
                             "plan": shape, "max_abs_err": err,
                             "device_kernels_per_call": nk})
                del new
    return recs


def per_launch(shapes):
    """One kernel's numbers over the main path's calls: ms, plain_ms,
    bound_ms and kernel_ms as means per launch, weighted by the calls at
    each shape (so times x launches is the path's total), the largest
    error, the bound_by of the shape with the largest summed bound, and the
    device ms per step of the kernel alone (kernel ms x calls, summed)."""
    calls = sum(s["calls"] for s in shapes)
    # a kernel no path calls (fv_tp_2d) weighs its shapes alike
    wts = [s["calls"] for s in shapes] if calls else [1] * len(shapes)
    out = {"max_abs_err": max(s["max_abs_err"] for s in shapes)}
    for key in ("ms", "plain_ms", "bound_ms", "kernel_ms"):
        vals = [s.get(key) for s in shapes]
        out[key] = (None if None in vals else
                    sum(v * w for v, w in zip(vals, wts)) / sum(wts))
    out["bound_by"] = max(zip(shapes, wts),
                          key=lambda sw: sw[0]["bound_ms"] * sw[1])[0][
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


class BigStep:
    """The big step on one grid: fv_dynamics_nh, or fv_dynamics_hydro when
    hydro. Jablonowski-Williamson baroclinic wave (perturbed) on
    set_eta(K), dp0 = diff(ak) + diff(bk) * 1e5 (bench.py:83). Dry: q = {}.
    Moist (bench.py:64-80, 88): the moist wave, adiabatic = False, sphum
    from it and the other five GFDL-MP tracers at 1e-6, MPConfig(). The
    state is the list of fields (delp, pt, u, v, and w, delz on the
    nonhydrostatic path), then the tracers of TRACERS when moist."""

    def __init__(self, npx, npz, dt, k_split, n_split, dtype, device,
                 geom=None, ic=None, moist=False, hydro=False):
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
        from gfdl_atmos_cubed_sphere_tpu_torch.physics.gfdl_mp import (
            MPConfig)
        import numpy as np
        t0 = time.perf_counter()
        self.moist = moist
        self.hydro = hydro
        self.fields = ("delp", "pt", "u", "v") + (() if hydro
                                                  else ("w", "delz"))
        self.geom = geom or build_grid_geometry(npx, ng=H)
        _, self.ptop, self.ak, self.bk = set_eta(npz)
        self.ic = ic or jw_baroclinic(self.geom, npz, self.ak, self.bk,
                                      self.ptop, perturb=True, moist=moist)
        if moist and "q" not in self.ic:
            q = {nm: np.full(self.ic["sphum"].shape, 1e-6)
                 for nm in TRACERS}
            q["sphum"] = self.ic["sphum"]
            self.ic = dict(self.ic, q=q)
        self.names = self.fields + (TRACERS if moist else ())
        self.mp_cfg = MPConfig() if moist else None
        self.t_setup = time.perf_counter() - t0
        self.g = build_grid_ops(npx, dtype=dtype, device=device,
                                geom=self.geom)
        prepare_phis(self.g, self.ic["phis"])
        self.dp0 = np.diff(self.ak) + np.diff(self.bk) * 1.0e5
        self.cfg = DynConfig(npx=npx, npz=npz, dt=dt, k_split=k_split,
                             n_split=n_split,
                             **dict(HYDRO_CFG if hydro else NH_CFG,
                                    adiabatic=not moist))
        st = state_from_arrays(self.ic, dtype=dtype, device=device)
        self.state = [st[k] for k in self.fields] + [
            st["q"][k] for k in self.names[len(self.fields):]]

    def step(self, state):
        from gfdl_atmos_cubed_sphere_tpu_torch.model.fv_dynamics import (
            fv_dynamics_hydro, fv_dynamics_nh)
        nf = len(self.fields)
        q = dict(zip(self.names[nf:], state[nf:]))
        if self.hydro:
            r = fv_dynamics_hydro(*state[:nf], q, self.g, self.cfg, self.ak,
                                  self.bk, self.ptop, mp_cfg=self.mp_cfg)
        else:
            r = fv_dynamics_nh(*state[:nf], q, self.g, self.cfg, self.ak,
                               self.bk, self.ptop, self.dp0,
                               mp_cfg=self.mp_cfg)
        return ([getattr(r, k) for k in self.fields]
                + [r.q[k] for k in self.names[nf:]])

    @property
    def label(self):
        return (("hydro " if self.hydro else "NH ")
                + ("moist" if self.moist else "dry"))


def card_vs_cpu(card_case):
    """Two C24L10 float64 big steps of `card_case` on the card against the
    same steps of the port on the CPU, each field (and tracer) against its
    own maximum; the same steps on the card in float32 are the control and
    must read over every limit."""
    import torch
    kw = dict(geom=card_case.geom, ic=card_case.ic, moist=card_case.moist,
              hydro=card_case.hydro)
    cpu = BigStep(25, 10, 900.0, 1, 2, torch.float64, "cpu", **kw)
    f32 = BigStep(25, 10, 900.0, 1, 2, torch.float32, "cuda", **kw)
    label = card_case.label
    scard, sc, sf = list(card_case.state), list(cpu.state), list(f32.state)
    for _ in range(2):
        scard = card_case.step(scard)
        sc = cpu.step(sc)
        sf = f32.step(sf)
    for nm, b in zip(card_case.names, sc):
        require(bool(torch.isfinite(b).all()),
                f"{label} CPU step: NaN in {nm}")
    bad = []
    for nm, a, f, b in zip(card_case.names, scard, sf, sc):
        top = float(b.abs().max())
        r = float((a.cpu() - b).abs().max()) / top
        ctl = float((f.cpu().double() - b).abs().max()) / top
        tol = CARD_TOL[label.split()[0]].get(nm, 1e-10)
        log(f"  C24L10 f64 {label} 2 big steps {nm}: card vs CPU {r:.3e} x "
            f"its max (tol {tol:g}); control, the card in float32: "
            f"{ctl:.3e}")
        if r > tol:
            bad.append(nm)
        require(ctl > tol, f"the control reads {nm} within its limit "
                           f"{tol:g}: the check could not tell a fault")
    log(f"phase 3 {label} big step card vs CPU: over the limit "
        f"{bad or 'none'}")
    require(not bad, f"{label} step on the card disagrees with the CPU "
                     f"in {bad}")


def step_phase(label, case, state, mass0, card, shapes, per_step, kernels):
    """The full-width C192L79 big step of `case`: 1 warm-up step (the
    captured step came before it), 5 timed steps behind a scalar readback
    barrier with the launch counts and tracer_2d's subcycle counts set to 0
    just before them and read just after, 1 step under the profiler, 1 by
    PyTorch op and 1 by layer. Fails on a non-finite field, a mass change
    over 1e-5 or a launch count other than per_step's (the rank-5 tp
    sweep: one launch per tracer_2d subcycle on top). shapes: the path's
    kernel records by call shape (device ms by kernel). Returns the launch
    counts."""
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.model import tracer_2d
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import tp_sweep
    state = case.step(state)                              # warm-up
    float(torch.sum(state[0]))
    nsteps = 5
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    tracer_2d.reset_nsplt()
    sec, state = timed_steps(case.step, state, nsteps)
    launches = counts()
    rank5 = tp_sweep.launches_rank5
    nsplt = list(tracer_2d.nsplt_calls)
    peak = torch.cuda.max_memory_allocated()
    for nm, t in zip(case.names, state):
        require(bool(torch.isfinite(t).all()),
                f"{label}: NaN or inf in {nm}")
    dm = abs(mass(case.g, state[0]) - mass0) / abs(mass0)
    ptslev = 6 * 192 ** 2 * 79 / sec
    log(f"phase {label}: {sec:.4f} s/step, {ptslev:.4e} pts*lev/s on {card}; "
        f"mass change {dm:.3e} over {nsteps + 2} big steps; launches "
        f"{launches}, of which rank-5 tp2d_sweep {rank5}; tracer_2d nsplt "
        f"per call {nsplt}; peak device memory {peak / 2 ** 30:.2f} GiB "
        f"({base / 2 ** 30:.2f} GiB allocated before the steps)")
    require(dm <= 1e-5, f"{label}: mass drifted by {dm:.3e}")
    require(len(nsplt) == (nsteps * case.cfg.k_split if case.moist else 0),
            f"{label}: tracer_2d ran {len(nsplt)} times in {nsteps} steps")
    require(rank5 == sum(nsplt), f"{label}: {rank5} rank-5 tp2d_sweep "
                                 f"launches, tracer_2d subcycled {nsplt}")
    for name, per in per_step.items():
        want = per * nsteps + (rank5 if name == "tp2d_sweep" else 0)
        require(launches[name] == want,
                f"{label}: {name} launched {launches[name]} times in "
                f"{nsteps} big steps, expected {want}")
    by, busy = device_ms_by_kernel(lambda: case.step(state), reps=1)
    own = own_kernels_ms(by)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:8]
    log(f"  profile of 1 big step: device busy {busy} of the wall time; "
        f"device ms/step {sum(by.values()):.3f}, of which the port's "
        f"kernels {own}; top: " + "; ".join(f"{k[:60]} {v:.3f}"
                                          for k, v in top))
    per_kernel = []
    for nm in kernels:
        shp = [sh for sh in shapes[nm] if case.moist or len(sh["shape"]) != 5]
        rec = per_launch(shp)
        if rec["kernel_ms_per_step"] is None:
            continue
        per_kernel.append(f"{nm} {rec['kernel_ms_per_step']:.3f}" + "".join(
            f" ({sh['shape']}: {sh['kernel_ms']:.3f} x {sh['calls']})"
            for sh in shp if len(shp) > 1))
    log("  device ms per big step by kernel (kernel alone x calls, summed "
        "over call shapes): " + ", ".join(per_kernel))
    ops = device_ms_by_op(lambda: case.step(state))
    log("  device ms per big step by PyTorch op (top 10): " + "; ".join(
        f"{k} {v:.3f}" for k, v in sorted(ops.items(),
                                          key=lambda kv: -kv[1])[:10]))
    log("  wall ms per big step by layer (synchronised): " + ", ".join(
        f"{k} {v:.1f}" for k, v in layer_ms(case, state).items()))
    return launches


def fv_tp_2d_operands(cap):
    """fv_tp_2d_kernel's arguments for d_sw's pt transport on the captured
    step: the first fluxes-stage call's pt, delp and keywords, and the
    Courant numbers, area and mass fluxes that stage computes from them
    (its kernel, launched here outside any counted run)."""
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import dsw
    (delp, pt, w, uc, vc, g), kw = next(iter(cap.args["d_sw_fluxes"]
                                             .values()))
    fl = dsw.d_sw_fluxes(delp, pt, w, uc, vc, g, **kw)
    args = [pt, fl.crx, fl.cry, kw["hord_tm"], fl.xfx, fl.yfx, g.area,
            fl.ra_x, fl.ra_y, g.dxa, g.dya]
    return args, dict(mfx=fl.fx, mfy=fl.fy, nord=kw["nord_v"],
                      damp_c=kw["damp_v"], g=g, mass=delp)


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


def captured_calls(label, cap, per_step, nsplt):
    """The calls of each wrapper in a captured big step: per_step's at rank
    4 and one rank-5 tp sweep per tracer_2d subcycle."""
    for name, per in per_step.items():
        calls = cap.calls.get(name, {})
        got = sum(c for shp, c in calls.items() if len(shp) != 5)
        require(got == per, f"{label}: {name} called {got} times at rank 4 "
                            f"in the captured big step, expected {per}")
    got = sum(c for shp, c in cap.calls.get("tp2d_sweep", {}).items()
              if len(shp) == 5)
    require(got == sum(nsplt), f"{label}: rank-5 tp2d_sweep called {got} "
                               f"times, tracer_2d subcycled {nsplt}")


def solo_fields(atm):
    """The prognostic fields of a solo Atmosphere's form."""
    return ("delp", "pt", "u", "v") + (() if atm.cfg.hydrostatic
                                       else ("w", "delz"))


def solo_energy(atm):
    """The area-weighted global mean of the column total energy (J/m^2) of
    a solo Atmosphere's state, its fields taken to float64: the
    hydrostatic or the nonhydrostatic form of model/thermodynamics.py."""
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.model import thermodynamics as th
    s = {k: v.double() for k, v in atm.state.items()}
    g, ptop = atm.g, atm.ptop
    phis = g.phis_p[..., H:-H, H:-H].double()
    if atm.cfg.hydrostatic:
        pe = th.interface_pressure(s["delp"], ptop)
        te = th.total_energy_2d_hydro(s["u"], s["v"], s["pt"], s["delp"],
                                      torch.log(pe), pe, phis, g)
    else:
        te = th.total_energy_2d_nh(s["u"], s["v"], s["w"], s["pt"], None,
                                   s["delp"], s["delz"], phis, g)
    return float(th.g_mean(te, g))


def solo_card_vs_cpu(geom):
    """Phase 8a: the solo driver at C24L10 in float64 on the card against
    the CPU, hydrostatic and nonhydrostatic, with Held-Suarez, the sponge
    and both fixers: 2 big steps, then adiabatic_init (its backward passes
    run every kernel with dt < 0), each field against its own maximum
    with phase 3's limits and a float32 control on the card. Then the
    energy fixer on the card: 8 hydrostatic steps without physics, the
    relative change of the global total energy with consv_te = 1 under
    1e-6 and under 0.2 x the change without it (the JAX package's
    tests/test_thermo_moist.py criterion)."""
    from gfdl_atmos_cubed_sphere_tpu_torch.driver.solo import Atmosphere
    for hydro in (True, False):
        kw = dict(physics="hs", hydrostatic=hydro, geom=geom,
                  cfg_overrides=dict(SOLO_C24, **SOLO_FIX))
        card = Atmosphere(25, 10, 900.0, dtype="f64", device="cuda", **kw)
        cpu = Atmosphere(25, 10, 900.0, dtype="f64", device="cpu", **kw)
        f32 = Atmosphere(25, 10, 900.0, dtype="f32", device="cuda", **kw)
        label = "solo hydro" if hydro else "solo NH"
        tols = CARD_TOL["hydro" if hydro else "NH"]
        for stage in ("2 big steps", "adiabatic_init"):
            for atm in (card, cpu, f32):
                if stage == "2 big steps":
                    atm.atmosphere(2)
                else:
                    atm.adiabatic_init()
            bad = []
            for nm in solo_fields(card):
                b = cpu.state[nm]
                require(bool(b.isfinite().all()), f"{label} CPU: NaN in {nm}")
                top = float(b.abs().max())
                r = float((card.state[nm].cpu() - b).abs().max()) / top
                ctl = float((f32.state[nm].cpu().double() - b).abs().max()
                            ) / top
                tol = tols.get(nm, 1e-10)
                log(f"  8a C24L10 f64 {label} {stage} {nm}: card vs CPU "
                    f"{r:.3e} x its max (tol {tol:g}); control, the card "
                    f"in float32: {ctl:.3e}")
                if r > tol:
                    bad.append(nm)
                require(ctl > tol, f"8a {label}: the control reads {nm} "
                                   f"within its limit {tol:g}")
            require(not bad, f"8a {label} {stage}: the card disagrees with "
                             f"the CPU in {bad}")
    change = {}
    for consv in (1.0, 0.0):
        atm = Atmosphere(25, 10, 900.0, physics="none", dtype="f64",
                         device="cuda", geom=geom,
                         cfg_overrides=dict(SOLO_C24, consv_te=consv))
        e0 = solo_energy(atm)
        atm.atmosphere(8)
        change[consv] = abs(solo_energy(atm) - e0) / abs(e0)
    log(f"phase 8a energy fixer, C24L10 f64 on the card, 8 hydrostatic "
        f"steps: relative total-energy change {change[1.0]:.3e} with "
        f"consv_te = 1, {change[0.0]:.3e} without "
        f"({change[1.0] / change[0.0]:.3f} x)")
    require(change[1.0] < 1e-6 and change[1.0] < 0.2 * change[0.0],
            f"8a: the energy fixer leaves a change of {change[1.0]:.3e} "
            f"(without it {change[0.0]:.3e})")


def solo_run(label, atm, per_step, card, gate_mass):
    """Phase 8b: 1 warm-up step, then 5 timed atmosphere() steps behind a
    scalar readback with the launch counts set to 0 just before them and
    read just after, one step under the profiler, and the costs of
    hs_forcing and audit on the state. Fails on a non-finite field, a
    launch count other than per_step's x 5, and (when gate_mass) a mass
    change over 1e-5. Returns a record of the numbers."""
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.physics.held_suarez import (
        hs_forcing)
    nsteps = 5
    atm.atmosphere(1)                                     # warm-up
    float(torch.sum(atm.state["delp"]))
    mass0 = mass(atm.g, atm.state["delp"])
    e0 = solo_energy(atm)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    atm.atmosphere(nsteps)
    float(torch.sum(atm.state["delp"]))                   # readback barrier
    sec = (time.perf_counter() - t0) / nsteps
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    for nm in solo_fields(atm):
        require(bool(torch.isfinite(atm.state[nm]).all()),
                f"{label}: NaN or inf in {nm}")
    dm = abs(mass(atm.g, atm.state["delp"]) - mass0) / abs(mass0)
    de = (solo_energy(atm) - e0) / abs(e0)
    npts = 6 * atm.g.n ** 2 * atm.cfg.npz
    log(f"phase {label}: {sec:.4f} s/step, {npts / sec:.4e} pts*lev/s on "
        f"{card}; mass change {dm:.3e} and relative total-energy change "
        f"{de:.3e} over {nsteps} steps; peak device memory "
        f"{peak / 2 ** 30:.2f} GiB; launches per step " + ", ".join(
            f"{k} {v / nsteps:g}" for k, v in launches.items() if v))
    for name, per in per_step.items():
        require(launches[name] == per * nsteps,
                f"{label}: {name} launched {launches[name]} times in "
                f"{nsteps} steps, expected {per * nsteps}")
    if gate_mass:
        require(dm <= 1e-5, f"{label}: mass drifted by {dm:.3e}")
    by, busy = device_ms_by_kernel(lambda: atm.atmosphere(1), reps=1)
    s = atm.state
    hs_ms = time_ms(lambda: hs_forcing(s["pt"], s["delp"], s["u"], s["v"],
                                       atm.g, atm.ptop, atm.cfg.dt))
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        atm.audit(out=lambda line: None)
        walls.append((time.perf_counter() - t0) * 1e3)
    audit_ms = statistics.median(walls)
    log(f"  {label}: device busy {busy} of the wall time, device ms per "
        f"step {sum(by.values()):.3f}; hs_forcing {hs_ms:.3f} ms, audit "
        f"{audit_ms:.3f} ms per call")
    log("  wall ms of one step by layer (synchronised): " + ", ".join(
        f"{k} {v:.1f}" for k, v in solo_layer_ms(atm).items()))
    lines = []
    atm.timers.report(out=lines.append)
    log("  Timers: " + " | ".join(" ".join(x.split()) for x in lines))
    return dict(s_per_step=sec, launches={k: v // nsteps
                                          for k, v in launches.items()},
                hs_ms=hs_ms, audit_ms=audit_ms, busy=busy, peak=peak,
                energy_change=de, mass_change=dm)


def solo_full_width(geom, card):
    """Phases 8b and 8c: the solo driver at C192L79 in float32 with
    Held-Suarez forcing: hydrostatic with the fixers and the sponge on and
    off, then nonhydrostatic with them on (each run starts from the same
    initial state, written once and read back); then the restart check.
    Returns the launches per step of the hydrostatic and nonhydrostatic
    runs with the fixers on."""
    import os
    import shutil
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.driver.solo import Atmosphere
    os.makedirs(SOLO_DIR, exist_ok=True)
    try:
        t0 = time.perf_counter()
        kw = dict(physics="hs", geom=geom, device="cuda")
        on = Atmosphere(193, 79, 450.0, cfg_overrides=dict(SOLO_HYDRO,
                                                           **SOLO_FIX), **kw)
        s0 = os.path.join(SOLO_DIR, "solo_c192_init.npz")
        on.write_restart(s0)
        log(f"phase 8b: solo Atmosphere at C192L79 f32, host set-up "
            f"{time.perf_counter() - t0:.1f} s (grid shared with phase 5)")
        hy_on = solo_run("8b solo_hydro fixers+sponge on", on,
                         HYDRO_PER_STEP, card, gate_mass=False)
        del on
        off = Atmosphere(193, 79, 450.0, cfg_overrides=dict(SOLO_HYDRO),
                         restart=s0, **kw)
        hy_off = solo_run("8b solo_hydro fixers+sponge off", off,
                          HYDRO_PER_STEP, card, gate_mass=True)
        del off
        nh = Atmosphere(193, 79, 450.0, hydrostatic=False,
                        cfg_overrides=dict(SOLO_NH, **SOLO_FIX), restart=s0,
                        **kw)
        nh_on = solo_run("8b solo_nh fixers+sponge on", nh, NH_PER_STEP,
                         card, gate_mass=False)
        del nh
        log(f"phase 8b solo_hydro: fixers and sponge cost "
            f"{(hy_on['s_per_step'] - hy_off['s_per_step']) * 1e3:.1f} ms "
            f"per step (on minus off: {hy_on['s_per_step']:.4f} - "
            f"{hy_off['s_per_step']:.4f} s/step); relative total-energy "
            f"change over 5 steps {hy_on['energy_change']:.3e} on, "
            f"{hy_off['energy_change']:.3e} off (float32, not gated) on "
            f"{card}")
        solo_restart(s0, geom, card)
    finally:
        shutil.rmtree(SOLO_DIR, ignore_errors=True)
    return hy_on["launches"], nh_on["launches"]


def solo_restart(s0, geom, card):
    """Phase 8c: the hydrostatic solo run with Held-Suarez and both fixers
    (no sponge: its reference winds are the state at each (re)start) at
    C192L79 f32 from the initial state s0: 2 steps, write_restart as
    .fvio and as .npz (the seconds to return, the file complete on
    return, and of them the device-to-host copy), 1 more step; each file
    read into a new Atmosphere and stepped once must equal the continuous
    run bit for bit in every field."""
    import os
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.driver.solo import Atmosphere
    kw = dict(physics="hs", geom=geom, device="cuda",
              cfg_overrides=dict(SOLO_HYDRO, consv_te=1.0, consv_am=True))
    atm = Atmosphere(193, 79, 450.0, restart=s0, **kw)
    atm.atmosphere(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    [v.cpu() for v in atm.state.values()]
    d2h = time.perf_counter() - t0
    paths = []
    for ext in ("fvio", "npz"):
        path = os.path.join(SOLO_DIR, f"solo_c192_step2.{ext}")
        t0 = time.perf_counter()
        atm.write_restart(path)
        sec = time.perf_counter() - t0
        log(f"phase 8c write_restart .{ext}: returned after {sec:.3f} s "
            f"with the file complete ({os.path.getsize(path) / 2 ** 20:.1f}"
            f" MiB; the state's device-to-host copy alone {d2h:.3f} s) on "
            f"{card}")
        paths.append(path)
    atm.atmosphere(1)
    for path in paths:
        t0 = time.perf_counter()
        back = Atmosphere(193, 79, 450.0, restart=path, **kw)
        t_load = time.perf_counter() - t0
        require(back.step_count == 2, f"8c: {path} resumed at step "
                                      f"{back.step_count}, not 2")
        back.atmosphere(1)
        diff = [k for k in atm.state
                if not torch.equal(atm.state[k], back.state[k])]
        log(f"phase 8c {os.path.basename(path)}: read into a new "
            f"Atmosphere in {t_load:.2f} s; one step from it against the "
            f"continuous run: fields that differ {diff or 'none'}")
        require(not diff, f"8c: the run resumed from {path} differs from "
                          f"the continuous run, first in {diff[:1]}")


def solo_cli(card):
    """Phase 8d: the CLI as users start it (the README's quick start at
    C48L32, 3 steps, an audit every 2 and a restart written), then a second
    run from that restart; both on the card."""
    import os
    import shutil
    from gfdl_atmos_cubed_sphere_tpu_torch.driver.solo import main as solo
    from gfdl_atmos_cubed_sphere_tpu_torch.io.restart import load_state
    os.makedirs(SOLO_DIR, exist_ok=True)
    try:
        path = os.path.join(SOLO_DIR, "cli.fvio")
        argv = ["--npx", "49", "--npz", "32", "--dt", "1200", "--physics",
                "hs", "--days", "0.05", "--audit-every", "2"]
        t0 = time.perf_counter()
        solo(argv + ["--restart-out", path])
        t1 = time.perf_counter()
        solo(argv + ["--restart-in", path])
        step = load_state(path)[2]["step"]
        log(f"phase 8d CLI: main() ran 3 steps and wrote {path} (step "
            f"{step}) in {t1 - t0:.1f} s, and a second main() resumed from "
            f"it in {time.perf_counter() - t1:.1f} s on {card}")
        require(step == 3, f"8d: the CLI's restart holds step {step}")
    finally:
        shutil.rmtree(SOLO_DIR, ignore_errors=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from gfdl_atmos_cubed_sphere_tpu_torch.model import tracer_2d
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

    nh = BigStep(193, 79, 450.0, 2, 6, torch.float32, "cuda")
    log(f"c192_nh grid + baroclinic state: host precompute "
        f"{nh.t_setup:.1f} s")
    nh_mass0 = mass(nh.g, nh.state[0])
    with Capture() as cap192:
        nh_state = nh.step(nh.state)
        float(torch.sum(nh_state[0]))
    nh24 = BigStep(25, 10, 900.0, 1, 2, torch.float64, "cuda")
    with Capture() as cap24:
        nh24.step(nh24.state)
    nhm = BigStep(193, 79, 450.0, 2, 6, torch.float32, "cuda", geom=nh.geom,
                  moist=True)
    log(f"c192_nh moist baroclinic state: host set-up {nhm.t_setup:.1f} s")
    nhm_mass0 = mass(nhm.g, nhm.state[0])
    tracer_2d.reset_nsplt()
    with Capture() as cap192m:
        nhm_state = nhm.step(nhm.state)
        float(torch.sum(nhm_state[0]))
    nsplt192 = list(tracer_2d.nsplt_calls)
    nh24m = BigStep(25, 10, 900.0, 1, 2, torch.float64, "cuda",
                    geom=nh24.geom, moist=True)
    with Capture() as cap24m:
        nh24m.step(nh24m.state)
    # c192_hydro (bench.py:34-35): the moist state and geometry of phase 6
    hy = BigStep(193, 79, 450.0, 1, 6, torch.float32, "cuda", geom=nh.geom,
                 ic=nhm.ic, moist=True, hydro=True)
    hy_mass0 = mass(hy.g, hy.state[0])
    tracer_2d.reset_nsplt()
    with Capture() as cap192h:
        hy_state = hy.step(hy.state)
        float(torch.sum(hy_state[0]))
    nsplt192h = list(tracer_2d.nsplt_calls)
    hy24 = BigStep(25, 10, 900.0, 1, 2, torch.float64, "cuda",
                   geom=nh24.geom, ic=nh24m.ic, moist=True, hydro=True)
    with Capture() as cap24h:
        hy24.step(hy24.state)
    torch.cuda.synchronize()

    # ---- 2. kernels against their plain versions ----------------------------
    log("phase 2 kernels vs plain versions")
    resources = kernel_resources()
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
    captured_calls("c192_nh", cap192, NH_PER_STEP, [])
    del cap192, cap24
    moist = check_kernels(
        cap192m, NH_KERNELS, 192, 1e-4, "c192_nh moist f32",
        measure=lambda name, shp: name == "tp2d_sweep" and len(shp) == 5)
    check_kernels(cap24m, NH_KERNELS, 24, 1e-12, "C24L10 moist f64",
                  measure=False)
    shapes_nh["tp2d_sweep"] += [r for r in moist["tp2d_sweep"]
                                if len(r["shape"]) == 5]
    captured_calls("c192_nh moist", cap192m, NH_PER_STEP, nsplt192)
    del cap192m, cap24m
    shapes_hy = check_kernels(cap192h, HYDRO_KERNELS, 192, 1e-4,
                              "c192_hydro f32", measure=True)
    check_kernels(cap24h, HYDRO_KERNELS, 24, 1e-12, "C24L10 hydro f64",
                  measure=False)
    col_depths = check_column_depths(cap192h)
    # fv_tp_2d_kernel, which no path calls, on the hydro step's d_sw pt
    # transport operands
    shapes_hy["fv_tp_2d"] = [check_call(
        "c192_hydro f32", "fv_tp_2d", *fv_tp_2d_operands(cap192h), 0, 192,
        1e-4, measure=True)]
    check_call("C24L10 hydro f64", "fv_tp_2d", *fv_tp_2d_operands(cap24h), 0,
               24, 1e-12, measure=False)
    captured_calls("c192_hydro moist", cap192h, HYDRO_PER_STEP, nsplt192h)
    del cap192h, cap24h
    recs_sw = {k: per_launch(v) for k, v in shapes_sw.items()}
    recs_nh = {k: per_launch(v) for k, v in shapes_nh.items()}
    recs_hy = {k: per_launch(v) for k, v in shapes_hy.items()}

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

    for case in (nh24, nh24m, hy24):
        card_vs_cpu(case)
    geom24 = nh24.geom
    del nh24, nh24m, hy24

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
    nh_launches = step_phase("5 c192_nh dry f32", nh, nh_state, nh_mass0,
                             card, shapes_nh, NH_PER_STEP, NH_KERNELS)
    geom192 = nh.geom
    del nh, nh_state

    # ---- 6. full width c192_nh moist (the headline step) --------------------
    m_launches = step_phase("6 c192_nh moist f32", nhm, nhm_state, nhm_mass0,
                            card, shapes_nh, NH_PER_STEP, NH_KERNELS)
    del nhm, nhm_state

    # ---- 7. full width c192_hydro moist --------------------------------------
    h_launches = step_phase("7 c192_hydro moist f32", hy, hy_state, hy_mass0,
                            card, shapes_hy, HYDRO_PER_STEP, HYDRO_KERNELS)
    del hy, hy_state

    # ---- 8. the solo driver ------------------------------------------------
    solo_card_vs_cpu(geom24)
    solo_hy_launches, solo_nh_launches = solo_full_width(geom192, card)
    solo_cli(card)

    kernels = []
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "kernel_ms")
    paths = (("c192_nh moist", NH_KERNELS, recs_nh, shapes_nh, m_launches),
             ("c192_hydro moist", HYDRO_KERNELS + ("fv_tp_2d",), recs_hy,
              shapes_hy, h_launches),
             ("sw_c768", SW_KERNELS, recs_sw, shapes_sw, sw_launches))
    for name in REPLACES:
        path, _, recs, shapes, launches = next(
            p for p in paths if name in p[1])
        rec = recs[name]
        entry = {
            "name": name, "route": "cuda",
            "source": "gfdl_atmos_cubed_sphere_tpu_torch/csrc/"
                      f"{SOURCE.get(name, name)}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None,
            "kernel_ms": rec["kernel_ms"], "path": path,
            "shapes": shapes[name]}
        if name in resources:
            entry["resources"] = resources[name]
        if name in EXACT:
            entry["depths"] = [r for r in col_depths if r["kernel"] == name]
        if path == "c192_nh moist":
            entry["c192_nh_dry"] = {"launches": nh_launches[name]}
        # launches per big step of the solo driver at C192L79 (phase 8b)
        entry["solo_hydro"] = {"launches": solo_hy_launches[name]}
        entry["solo_nh"] = {"launches": solo_nh_launches[name]}
        for other, _, orecs, oshapes, olaunches in paths:
            if other != path and name in orecs:
                entry[other.split()[0]] = {
                    "launches": olaunches[name],
                    **{k: orecs[name][k] for k in keys},
                    "shapes": oshapes[name]}
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
