"""How far 1-ulp input changes move the JAX package's moist NH big step
when the boundary layer holds a sphum constant across the cube.

    python devtools/pbl_conditioning.py

Runs the JAX package's jitted fv_dynamics_nh on the CPU in float64 at
tests/test_torch_fv_dynamics.py's fast-physics setting (C12L10, dt = 600 s,
k_split = 1, n_split = 2, the moist Jablonowski-Williamson state with sphum
and liq_wat, adiabatic off; the JAX package's own tests/test_gfdl_mp.py
step) from two boundary layers: sphum = 0.03 at every point of the lowest
three levels, as JAX's test sets it, and 0.03 times seeded noise of +-2 %,
as the port's test does. For each it runs the step again from the same
state with sphum moved by one unit in the last place, up or down at
random, on every point, and prints pt's and sphum's max |difference| over
their maxima. A field constant across the cube puts tracer_2d's PPM
limiters on exact ties, where the last bit decides each branch: that
spread is what a comparison of two sound implementations can show there
(~40 s, one JAX compile).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

NPX, K = 13, 10
NAMES = ("delp", "pt", "u", "v", "w", "delz")


def main():
    from gfdl_atmos_cubed_sphere_tpu.grid.fv_eta import set_eta
    from gfdl_atmos_cubed_sphere_tpu.init.baroclinic import jw_baroclinic
    from gfdl_atmos_cubed_sphere_tpu.model.dyn_core import DynConfig
    from gfdl_atmos_cubed_sphere_tpu.model.fv_dynamics import fv_dynamics_nh
    from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops
    from gfdl_atmos_cubed_sphere_tpu.model.sw_dynamics import prepare_phis
    g = build_grid_ops(NPX, dtype=jnp.float64)
    _, ptop, ak, bk = set_eta(K)
    ic = jw_baroclinic(g.geom, K, ak, bk, ptop, perturb=True, moist=True)
    prepare_phis(g, ic["phis"])
    dp0 = np.diff(ak) + np.diff(bk) * 1.0e5
    cfg = DynConfig(npx=NPX, npz=K, dt=600.0, hydrostatic=False,
                    adiabatic=False, k_split=1, n_split=2)

    def step(st, sphum):
        q = {"sphum": sphum, "liq_wat": jnp.zeros_like(sphum)}
        r = fv_dynamics_nh(*st, q, g, cfg, ak, bk, ptop, dp0)
        return r.pt, r.q["sphum"]

    f = jax.jit(step)
    st = tuple(jnp.asarray(ic[k]) for k in NAMES)
    rng = np.random.default_rng(0)
    for label, noise in (("sphum 0.03 everywhere", None),
                         ("sphum 0.03 x (1 +- 2 % seeded)", 0.02)):
        sphum = np.array(ic["sphum"])
        sphum[:, -3:] = 0.03 if noise is None else 0.03 * rng.uniform(
            1.0 - noise, 1.0 + noise, sphum[:, -3:].shape)
        base = f(st, jnp.asarray(sphum))
        for seed in (1, 2, 3):
            sign = np.random.default_rng(seed).choice([-1.0, 1.0],
                                                      sphum.shape)
            moved = np.nextafter(sphum, sphum + sign)
            got = f(st, jnp.asarray(moved))
            print(f"{label}, 1 ulp on every point, seed {seed}: " + ", ".join(
                f"{nm} {float(jnp.abs(a - b).max() / jnp.abs(b).max()):.2e}"
                for nm, a, b in zip(("pt", "sphum"), got, base)),
                flush=True)


if __name__ == "__main__":
    main()
