"""The sim1 kernel of two checkouts on the same columns, in one run.

    python3 devtools/sim1_ab.py PARENT

PARENT is another checkout of the repo (the parent commit unpacked with
`git archive` into a directory that .gitignore lists, such as chip_tree/).
Builds both checkouts' sim1 kernels from their own sources and runs them
on seeded balanced columns with noise at C192L79 in float32 and C24L10 in
float64 ([6, K, n + 6, n + 6], dt = 37.5 s): the alpha = 1 outputs of
both must be equal bit for bit; this checkout's off-centred form (alpha =
0.75) is held to its plain version (1e-4 x max|ref| in float32, 1e-12 in
float64). Then the kernel alone at C192L79 float32 (profiler, median of 5
readings of 5 calls) in the order PARENT, this, this, PARENT at alpha = 1,
and this checkout's alpha = 0.75. Prints a line for each reading, the
card's name and power limit, and a JSON line of the readings. Needs one
CUDA card.
"""

import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "devtools"))
import chip_smoke as cs  # noqa: E402
from kernel_ab import load_parent  # noqa: E402


def columns(n, K, dtype, seed):
    """sim1's arguments on seeded columns: set_eta(K) with a surface
    pressure and temperature varying by a few percent, a seeded w and ws."""
    from gfdl_atmos_cubed_sphere_tpu_torch import constants as con
    from gfdl_atmos_cubed_sphere_tpu_torch.grid.fv_eta import set_eta
    rng = np.random.default_rng(seed)
    _, _, ak, bk = set_eta(K)
    P = n + 6
    ps = 1.0e5 * (1 + 0.01 * rng.standard_normal((6, 1, P, P)))
    pe = ak[None, :, None, None] + bk[None, :, None, None] * ps
    delp = np.diff(pe, axis=1)
    dlog = np.diff(np.log(pe), axis=1)
    t = 250.0 + 20.0 * rng.standard_normal(delp.shape)
    dz = -con.RDGAS / con.GRAV * t * dlog
    akap = con.KAPPA
    pkz = np.exp(akap * np.log(-con.RDGAS / con.GRAV * delp / dz * t))
    dev = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    return (37.5, dev(delp / con.GRAV), dev(delp / dlog), dev(pe),
            dev(0.1 * rng.standard_normal(delp.shape)), dev(dz),
            dev(t / pkz), dev(0.01 * rng.standard_normal((6, P, P))),
            1.0 / (1.0 - akap), akap, 0.05)


def kernel_ms(fn):
    return statistics.median(
        sum(v[0] for v in cs.own_kernel_launches(fn).values())
        for _ in range(5))


def main():
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import importlib
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import sim1
    par = importlib.import_module(load_parent(sys.argv[1]) + ".ops.sim1")
    out = {"card": cs.card_line()}
    for n, K, dtype, tol in ((192, 79, torch.float32, 1e-4),
                             (24, 10, torch.float64, 1e-12)):
        args = columns(n, K, dtype, seed=K)
        label = f"C{n}L{K} {str(dtype).split('.')[-1]}"
        a, b = par.sim1(*args), sim1.sim1(*args)
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        cs.log(f"{label} alpha 1: parent and this checkout bit for bit "
               f"equal: {same}")
        cs.require(same, f"{label}: alpha 1 outputs differ from the parent's")
        got = sim1.sim1(*args, alpha=0.75)
        ref = sim1.sim1_solver(*args, alpha=0.75)
        worst = max(float((g - r).abs().max() / r.abs().max())
                    for g, r in zip(got, ref))
        cs.log(f"{label} alpha 0.75 against the plain version: {worst:.3e} "
               f"x max|ref| (tol {tol:g})")
        cs.require(worst <= tol, f"{label}: alpha 0.75 disagrees")
        out[label] = {"alpha_1_equal": same, "alpha_0_75_err": worst}
        if n == 192:
            for who in ("parent", "this", "this", "parent"):
                fn = par.sim1 if who == "parent" else sim1.sim1
                ms = kernel_ms(lambda: fn(*args))
                cs.log(f"  {label} kernel alone, alpha 1, {who}: {ms:.4f} ms")
                out.setdefault("alpha_1_ms", []).append([who, ms])
            ms = kernel_ms(lambda: sim1.sim1(*args, alpha=0.75))
            cs.log(f"  {label} kernel alone, alpha 0.75, this: {ms:.4f} ms")
            out["alpha_0_75_ms"] = ms
    cs.log(out["card"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
