"""Where the moist hydrostatic step with the energy fixer and the GFDL
microphysics departs from the JAX package, and how far the JAX package
departs from itself there.

    python devtools/fixer_conditioning.py [--seeds 0 1 2]

Runs one moist hydrostatic big step at C12L10 in float64 on the CPU
(bench.py's c192_hydro tracers and MPConfig(), dt = 1800 s, k_split = 1,
n_split = 2, the energy fixer consv_te = 1, the angular-momentum fixer and
the real-case Rayleigh friction: tests/test_torch_solo.py's
FixerStepPair) from the perturbed moist Jablonowski-Williamson state with
seeded noise on pt (0.01 K) and seeded condensate levels. For each seed
it prints each field's max |difference| over its own maximum:

- the port's step against the JAX package's (eager);
- the microphysics' inputs (pt and the tracers), port against JAX;
- the port's microphysics against the JAX package's on the same inputs
  (the port's);
- the JAX package's microphysics on the port's inputs against it on its
  own: the JAX package's own spread under the port's input differences;
- the JAX step against itself with the fixer's heating increment dtmp
  scaled by the port's relative dtmp difference.

If the port's microphysics equals the JAX package's on the same inputs,
the step's deviation in the condensates is the JAX microphysics' own
response to the inputs' last bits; the test's limit sits over it.
"""

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    opt = ap.parse_args()

    import conftest  # noqa: F401  (JAX on the CPU, float64)
    import jax
    import torch
    from test_torch_solo import FixerStepPair

    from gfdl_atmos_cubed_sphere_tpu.model import fv_dynamics as jfvd
    from gfdl_atmos_cubed_sphere_tpu_torch.model import fv_dynamics as fvd

    def line(errs):
        return ", ".join(f"{k} {e:.2e}" for k, e in errs.items())

    torch.set_num_threads(4)
    jorig, torig = jfvd.thermo.energy_fixer_dtmp, fvd.thermo.energy_fixer_dtmp
    seen = {}

    def recorder(orig, key, scale=1.0):
        def wrapped(*a, **k):
            d = orig(*a, **k) * scale
            seen[key] = float(d)
            return d
        return wrapped

    try:
        for seed in opt.seeds:
            t0 = time.perf_counter()
            jfvd.thermo.energy_fixer_dtmp = recorder(jorig, "jax")
            fvd.thermo.energy_fixer_dtmp = recorder(torig, "port")
            with jax.disable_jit():
                pair = FixerStepPair(seed=seed, mp=True)
                w = pair.mp_witness()
                rel = seen["port"] / seen["jax"] - 1.0
                want = pair.jax()
                jfvd.thermo.energy_fixer_dtmp = recorder(jorig, "jax",
                                                         1.0 + rel)
                scaled = pair.errors(pair.jax(), want)
            print(f"seed {seed}: dtmp JAX {seen['jax']:.17e}, relative "
                  f"port - JAX {rel:.3e}")
            print("  step, port vs JAX:           " + line(w["step"]))
            print("  MP inputs, port vs JAX:      " + line(w["inputs"]))
            print("  MP on the same inputs:       " + line(w["same_inputs"]))
            print("  JAX MP, port's inputs vs own: " + line(w["jax_spread"]))
            print(f"  JAX step, dtmp x (1{rel:+.3e}): " + line(scaled))
            print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    finally:
        jfvd.thermo.energy_fixer_dtmp = jorig
        fvd.thermo.energy_fixer_dtmp = torig


if __name__ == "__main__":
    main()
