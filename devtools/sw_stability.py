"""How long the shallow-water core stays finite at a given time step.

Steps Williamson case 2 in float32 from its initial state with one acoustic
iteration per step (n_split=1, as bench.py's sw_c768) for 12 steps and
prints, per step, the largest |delp|, |u| and |v| and whether any value is
non-finite; the last line is one JSON object with the first non-finite step
(null when the run stayed finite) and the Courant number
dt * (sqrt(max delp) + max |u, v|) / min(dx, dy) of the initial state (delp
is g*h in the SW core, so sqrt(delp) is the gravity wave speed).

    python devtools/sw_stability.py --package jax --npx 97 --dt 1800
    python devtools/sw_stability.py --package torch --device cuda \\
        --npx 769 --dt 225

--package jax runs the JAX package (gfdl_atmos_cubed_sphere_tpu) on the CPU;
--package torch runs the PyTorch port (gfdl_atmos_cubed_sphere_tpu_torch) on
--device. Only the chosen package is imported.
"""

import argparse
import json
import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

H = 3
STEPS = 12


def jax_run(npx, dt):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from gfdl_atmos_cubed_sphere_tpu.init import sw_cases
    from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops
    from gfdl_atmos_cubed_sphere_tpu.model.sw_dynamics import (
        SWConfig, make_sw_step, prepare_phis)
    dtype = jnp.float32
    g = build_grid_ops(npx, dtype=dtype)
    ic = sw_cases.case2(g.geom)
    prepare_phis(g, ic["phis"])
    step = jax.jit(make_sw_step(g, SWConfig(npx=npx, dt=dt, n_split=1)))
    state = [jnp.asarray(ic[k], dtype) for k in ("delp", "u", "v")]
    yield ic, g.geom.arrays
    for _ in range(STEPS):
        state = step(*state, None, None)
        yield [np.asarray(s) for s in state]


def torch_run(npx, dt, device):
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.init import sw_cases
    from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import (
        build_grid_ops)
    from gfdl_atmos_cubed_sphere_tpu_torch.model.sw_dynamics import (
        SWConfig, make_sw_step, prepare_phis)
    dtype = torch.float32
    g = build_grid_ops(npx, dtype=dtype, device=device)
    ic = sw_cases.case2(g.geom)
    prepare_phis(g, ic["phis"])
    step = make_sw_step(g, SWConfig(npx=npx, dt=dt, n_split=1))
    state = [torch.as_tensor(ic[k], dtype=dtype, device=g.device)
             for k in ("delp", "u", "v")]
    yield ic, g.geom.arrays
    for _ in range(STEPS):
        state = step(*state, None, None)
        yield [s.cpu().numpy() for s in state]


def courant(ic, arrays, npx, dt):
    n = npx - 1
    ctr, wsl = slice(H, H + n), slice(H, H + n + 1)
    dmin = min(float(np.min(arrays["dx"][:, wsl, ctr])),
               float(np.min(arrays["dy"][:, ctr, wsl])))
    speed = (math.sqrt(float(np.max(ic["delp"])))
             + max(float(np.max(np.abs(ic["u"]))),
                   float(np.max(np.abs(ic["v"])))))
    return dt * speed / dmin


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device (--package torch)")
    ap.add_argument("--npx", type=int, required=True)
    ap.add_argument("--dt", type=float, required=True)
    a = ap.parse_args()
    if a.package == "jax":
        run = jax_run(a.npx, a.dt)
    else:
        run = torch_run(a.npx, a.dt, a.device)
    ic, arrays = next(run)
    cfl = courant(ic, arrays, a.npx, a.dt)
    first_bad = None
    for i, state in enumerate(run, 1):
        finite = [bool(np.isfinite(s).all()) for s in state]
        big = [float(np.nanmax(np.abs(s))) if np.isfinite(s).any()
               else float("nan") for s in state]
        print(f"step {i}: max |delp|, |u|, |v| = {big}; finite {finite}",
              flush=True)
        if first_bad is None and not all(finite):
            first_bad = i
            break
    print(json.dumps({"package": a.package, "npx": a.npx, "dt": a.dt,
                      "steps": STEPS, "courant": cfl,
                      "first_nonfinite_step": first_bad}))


if __name__ == "__main__":
    main()
