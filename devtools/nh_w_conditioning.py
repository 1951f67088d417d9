"""How far last-bit differences in exp/log move the big step's fields.

    python devtools/nh_w_conditioning.py [--moist] [--hydro]
    python devtools/nh_w_conditioning.py --facade

Runs the port's fv_dynamics_nh (or, with --hydro, fv_dynamics_hydro) on the
CPU in float64 at chip_smoke's phase 3 setting (C24L10, dt = 900 s,
k_split = 1, n_split = 2, two big steps from the perturbed
Jablonowski-Williamson state; --moist: the moist state with the six GFDL-MP
tracers and MPConfig()), once as it is and then with the results of
torch.exp and torch.log (and their Tensor methods) moved by one unit in
the last place, up or down at random, on a share of their elements.
Prints each field's and tracer's max |difference| over its own maximum.
The card's and the CPU's math libraries may round exp and log differently
in the last bit, so this is the spread a sound card-vs-CPU comparison can
show; chip_smoke.py's limits sit above it.

With --facade it runs chip_smoke's phase 9a instead: the facade sequence
(one nonhydrostatic atmosphere_dynamics step of a GFDLAtmosphere at C24L10
f64 from the moist state of facade_c24_state, the physics state-in, a
state update, fv_diag, fv_cmip_diag and the GFDL input blocks), and prints
the outputs whose spread passes 1e-10 of their maximum, with chip_smoke's
limit for each.
"""

import argparse
import sys
import time
from pathlib import Path

import torch
from torch.overrides import TorchFunctionMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

NUDGED = (torch.exp, torch.log, torch.Tensor.exp, torch.Tensor.log)


class NudgeExpLog(TorchFunctionMode):
    """Moves the results of exp and log by one ulp on a random share of
    their elements (seeded)."""

    def __init__(self, share, seed):
        super().__init__()
        self.share = share
        self.gen = torch.Generator().manual_seed(seed)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func not in NUDGED or not out.is_floating_point():
            return out
        hit = torch.rand(out.shape, generator=self.gen,
                         dtype=out.dtype) < self.share
        up = torch.rand(out.shape, generator=self.gen, dtype=out.dtype) < 0.5
        to = torch.where(up, torch.full_like(out, float("inf")),
                         torch.full_like(out, -float("inf")))
        return torch.where(hit, torch.nextafter(out, to), out)


def run(case, steps=2):
    st = list(case.state)
    for _ in range(steps):
        st = case.step(st)
    return st


def facade(cs):
    """The spread of phase 9a's outputs under the exp/log nudges."""
    import os
    from gfdl_atmos_cubed_sphere_tpu_torch.driver.gfdl import GFDLAtmosphere
    from gfdl_atmos_cubed_sphere_tpu_torch.grid.metrics import (
        build_grid_geometry)
    geom = build_grid_geometry(25, ng=3)
    os.makedirs(cs.SOLO_DIR, exist_ok=True)
    path = os.path.join(cs.SOLO_DIR, "facade_conditioning.npz")
    ic, ak, bk = cs.facade_c24_state(geom)
    cs.moist_checkpoint(path, ic, ak, bk, "float64")

    def run_facade():
        return cs.facade_sequence(GFDLAtmosphere(
            25, 10, 900.0, dtype="f64", hydrostatic=False,
            cfg_overrides=cs.FACADE_C24, restart=path, geom=geom,
            device="cpu"))

    t0 = time.perf_counter()
    base = run_facade()
    print(f"C24L10 f64 facade sequence on the CPU: "
          f"{time.perf_counter() - t0:.1f} s, {len(base)} outputs")
    worst = {}
    for share in (0.01, 1.0):
        for seed in (1, 2, 3, 4):
            with NudgeExpLog(share, seed):
                got = run_facade()
            over = {}
            for nm, b in base.items():
                ok = ~torch.isnan(b)
                top = float(b[ok].abs().max()) if bool(ok.any()) else 0.0
                if top == 0.0:
                    continue
                r = float((got[nm][ok] - b[ok]).abs().max()) / top
                worst[nm] = max(worst.get(nm, 0.0), r)
                if r > 1e-10:
                    over[nm] = r
            print(f"exp/log 1 ulp on {share:g} of elements, seed {seed}: "
                  f"{len(over)} outputs over 1e-10: " + ", ".join(
                      f"{nm} {r:.2e}" for nm, r in sorted(
                          over.items(), key=lambda kv: -kv[1])), flush=True)
    os.remove(path)
    over = sorted((nm for nm, r in worst.items() if r > 1e-10),
                  key=lambda nm: -worst[nm])
    print("largest spread of each output over 1e-10 (chip_smoke's limit): "
          + ", ".join(f"{nm} {worst[nm]:.2e} ({cs.facade_limit(nm):g})"
                      for nm in over))
    print("largest spread of the outputs held to 1e-10: " + ", ".join(
        f"{nm} {worst[nm]:.2e}" for nm in sorted(
            (n for n in worst if cs.facade_limit(n) <= 1e-10),
            key=lambda n: -worst[n])[:5]))


def main():
    import chip_smoke as cs
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--moist", action="store_true")
    ap.add_argument("--hydro", action="store_true")
    ap.add_argument("--facade", action="store_true")
    opt = ap.parse_args()
    torch.set_num_threads(4)
    if opt.facade:
        facade(cs)
        return
    case = cs.BigStep(25, 10, 900.0, 1, 2, torch.float64, "cpu",
                      moist=opt.moist, hydro=opt.hydro)
    t0 = time.perf_counter()
    base = run(case)
    print(f"C24L10 f64 {case.label}, 2 big steps on the CPU: "
          f"{time.perf_counter() - t0:.1f} s; max|.| "
          + ", ".join(f"{nm} {float(b.abs().max()):.4e}"
                      for nm, b in zip(case.names, base)))
    for share in (0.01, 1.0):
        for seed in (1, 2, 3, 4):
            with NudgeExpLog(share, seed):
                got = run(case)
            print(f"exp/log 1 ulp on {share:g} of elements, seed {seed}: "
                  + ", ".join(
                      f"{nm} {float((a - b).abs().max() / b.abs().max()):.3e}"
                      for nm, a, b in zip(case.names, got, base)),
                  flush=True)


if __name__ == "__main__":
    main()
