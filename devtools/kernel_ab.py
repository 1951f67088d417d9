"""The port's kernels of two checkouts, timed on the same inputs in one run.

    python3 devtools/kernel_ab.py PARENT KERNEL [KERNEL ...]

PARENT is another checkout of the repo, say the parent commit unpacked
with `git archive` into a directory that .gitignore lists (chip_tree/);
KERNEL is a name of chip_smoke.REPLACES that a main path runs (a2b_ord4,
sim1, c_sw, ...). This checkout's main paths run once each on the card at
full width, as chip_smoke.py drives them (the sw_c768 step, the moist
c192_nh big step, the moist c192_hydro big step; only those a named kernel
runs on), with every wrapper's arguments captured at each call shape
(chip_smoke.Capture). PARENT's port is loaded beside this one under
another package name, and each builds its own kernels from its own
sources.

Then, in the order PARENT, this, this, PARENT:
- for each captured float32 call of a named kernel: the wrapper's ms (CUDA
  events, median of 20), the kernel alone (profiler: the port's own device
  kernels), the device kernels per call with PyTorch's ops, copies and
  fills, and max |diff| against this checkout's plain version (the
  non-finite points must coincide);
- for each path: s/step after 1 warm-up, from the same captured state,
  with the named kernels' wrappers of that checkout swapped into this
  one's step; as many steps as take MIN_SECONDS (at least 3) by one
  untimed step of this checkout, the same count for each reading; and the
  peak device memory of the reading's steps beside what was resident
  before them. When a named kernel runs on the hydrostatic path, the solo
  driver's hydrostatic step (chip_smoke.py phase 8b's solo_hydro: C192L79
  float32, Held-Suarez, the fixers and the sponge on) is read too, its
  state going on from reading to reading.

A wrapper of PARENT returns what it returned there, and the callers of
this checkout take the path they take for it (one_grad_p concatenates
PARENT's separate pk and gz again).

Prints a line for each reading, the card's name and power limit, and, as
the last line, one JSON object with the readings. Needs one CUDA card.
"""

import importlib
import importlib.util
import json
import math
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

PKG = "gfdl_atmos_cubed_sphere_tpu_torch"
ORDER = ("parent", "this", "this", "parent")
MIN_SECONDS = 1.0


def load_parent(tree, alias="parent_port"):
    """PARENT's port, imported as package `alias` (its modules import one
    another relatively, so they resolve inside it)."""
    pkg = Path(tree).resolve() / PKG
    cs.require((pkg / "__init__.py").is_file(), f"no {PKG} in {tree}")
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return alias


def wrappers(pkg, names):
    """{name: (module, wrapper attribute, wrapper)} of the port `pkg`."""
    out = {}
    for name in names:
        mod, attr, _, _ = cs.kernel_modules()[name]
        m = importlib.import_module(pkg + mod.__name__[len(PKG):])
        out[name] = (m, attr, getattr(m, attr))
    return out


def paths_for(names):
    """{label: (step, state, n, sw)} of the full-width main paths that run
    a named kernel."""
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.model.sw_dynamics import (
        SWConfig, make_sw_step)
    paths = {}
    if any(nm in cs.SW_KERNELS for nm in names):
        g, _, state, _ = cs.sw_setup(769, torch.float32, "cuda")
        sw = make_sw_step(g, SWConfig(npx=769, dt=cs.C768_DT, n_split=1))
        paths["sw_c768"] = (lambda st: list(sw(*st, None, None)), state,
                            768, True)
    nh = any(nm in cs.NH_KERNELS for nm in names)
    hydro = any(nm in cs.HYDRO_KERNELS for nm in names)
    if nh or hydro:
        nhm = cs.BigStep(193, 79, 450.0, 2, 6, torch.float32, "cuda",
                         moist=True)
        if nh:
            paths["c192_nh moist"] = (nhm.step, nhm.state, 192, False)
        if hydro:
            hy = cs.BigStep(193, 79, 450.0, 1, 6, torch.float32, "cuda",
                            geom=nhm.geom, ic=nhm.ic, moist=True, hydro=True)
            paths["c192_hydro moist"] = (hy.step, hy.state, 192, False)
            paths["solo_hydro"] = solo_path(nhm.geom) + (192, False)
    return paths


def solo_path(geom):
    """(step, state) of the solo driver's hydrostatic form as phase 8b of
    chip_smoke.py runs it with the fixers and the sponge on."""
    from gfdl_atmos_cubed_sphere_tpu_torch.driver.solo import Atmosphere
    atm = Atmosphere(193, 79, 450.0, physics="hs", geom=geom, device="cuda",
                     cfg_overrides=dict(cs.SOLO_HYDRO, **cs.SOLO_FIX))

    def step(_):
        atm.atmosphere(1)
        return [atm.state[k] for k in ("delp", "pt", "u", "v")]

    return step, step(None)


def max_diff(label, name, out, ref, n, sw):
    """max |diff| of a wrapper's outputs from the plain version's over the
    finite points; fails where the non-finite points differ."""
    import torch
    err = 0.0
    for key, o in cs.flatten_outputs(out):
        r = ref[key]
        if sw:
            o, r = cs.sw_view(name, o, n), cs.sw_view(name, r, n)
        o, r = o.double(), r.double()
        fin = torch.isfinite(r)
        cs.require(bool(torch.equal(fin, torch.isfinite(o))),
                   f"{label}: {name} output {key}: non-finite points differ")
        err = max(err, float((o - r)[fin].abs().max()))
    return err


def kernel_readings(label, name, args, kw, n, sw, wr):
    """ORDER's readings of one captured call."""
    import torch
    plain = cs.kernel_modules()[name][2]
    ref = dict(cs.flatten_outputs(plain(*args, **kw)))
    recs = []
    for tree in ORDER:
        wrapper = wr[tree][name][2]

        def fn():
            return wrapper(*args, **kw)

        err = max_diff(label, name, fn(), ref, n, sw)
        torch.cuda.synchronize()
        ms = cs.time_ms(fn)
        own = cs.own_kernel_launches(fn)
        every = cs.own_kernel_launches(fn, reps=2, own=False)
        rec = {"tree": tree, "path": label, "kernel": name,
               "shape": list(cs.call_shape(args)), "ms": ms,
               "kernel_ms": sum(v for v, _ in own.values()),
               "device_kernels_per_call": sum(c for _, c in every.values()),
               "max_abs_err": err}
        cs.log(f"{tree:6s} {label} {name} {rec['shape']}: wrapper {ms:.4f} "
               f"ms, kernel alone {rec['kernel_ms']:.4f} ms, "
               f"{rec['device_kernels_per_call']:g} device kernels per "
               f"call, max|diff| vs plain {err:.3e}")
        recs.append(rec)
    return recs


def step_readings(label, step, state, names, wr):
    """ORDER's s/step of one path with each checkout's wrappers of the
    named kernels swapped in."""
    import torch
    t0 = time.perf_counter()
    float(torch.sum(step(state)[0]))
    nsteps = max(3, math.ceil(MIN_SECONDS / (time.perf_counter() - t0)))
    recs = []
    for tree in ORDER:
        swapped = [(m, attr, getattr(m, attr))
                   for m, attr, _ in wr["this"].values()]
        try:
            for nm in names:
                m, attr, _ = wr["this"][nm]
                setattr(m, attr, wr[tree][nm][2])
            st = step(state)                                 # warm-up
            float(torch.sum(st[0]))
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            sec, st = cs.timed_steps(step, st, nsteps)
            peak = torch.cuda.max_memory_allocated()
        finally:
            for m, attr, orig in swapped:
                setattr(m, attr, orig)
        for t in st:
            cs.require(bool(torch.isfinite(t).all()),
                       f"{tree} {label}: non-finite state")
        cs.log(f"{tree:6s} {label}: {sec:.4f} s/step ({nsteps} steps), "
               f"peak device memory {peak / 2 ** 30:.3f} GiB "
               f"({resident / 2 ** 30:.3f} GiB resident before)")
        recs.append({"tree": tree, "path": label, "s_per_step": sec,
                     "steps": nsteps, "peak_bytes": peak,
                     "resident_bytes": resident})
    return recs


def main():
    import torch
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 2
    parent, names = sys.argv[1], sys.argv[2:]
    on_path = cs.SW_KERNELS + cs.NH_KERNELS + cs.HYDRO_KERNELS
    for nm in names:
        cs.require(nm in on_path, f"{nm}: not a kernel a main path runs "
                                  f"({sorted(set(on_path))})")
    torch.backends.cuda.matmul.allow_tf32 = False
    pkg = load_parent(parent)
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import _build
    srcs = sorted({cs.SOURCE.get(nm, nm) for nm in names})
    pbuild = importlib.import_module(pkg + ".ops._build")
    with ThreadPoolExecutor(2) as ex:
        for f in [ex.submit(b.build, srcs, force=True)
                  for b in (_build, pbuild)]:
            f.result()
    wr = {"this": wrappers(PKG, names), "parent": wrappers(pkg, names)}
    paths = paths_for(names)
    caps = {}
    for label, (step, state, _, _) in paths.items():
        if label == "solo_hydro":           # its calls are c192_hydro's
            continue
        with cs.Capture() as caps[label]:
            state = step(state)
            float(torch.sum(state[0]))
        paths[label] = (step, state) + paths[label][2:]
    kernels = []
    for label, cap in caps.items():
        _, _, n, sw = paths[label]
        for nm in names:
            for args, kw in cap.args.get(nm, {}).values():
                kernels += kernel_readings(label, nm, args, kw, n, sw, wr)
    del caps, cap
    steps = []
    for label, (step, state, _, _) in paths.items():
        steps += step_readings(label, step, state, names, wr)
    card = cs.card_line()
    cs.log(card)
    print(json.dumps({"card": card, "parent": str(Path(parent).resolve()),
                      "kernels": kernels, "steps": steps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
