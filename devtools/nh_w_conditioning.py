"""How far last-bit differences in exp/log move the nonhydrostatic fields.

    python devtools/nh_w_conditioning.py

Runs the port's dry fv_dynamics_nh on the CPU in float64 at chip_smoke's
phase 3 setting (C24L10, dt = 900 s, k_split = 1, n_split = 2, two big
steps from the perturbed Jablonowski-Williamson state), once as it is and
then with the results of torch.exp and torch.log (and their Tensor methods)
moved by one unit in the last place, up or down at random, on a share of
their elements. Prints each field's max |difference| over its own maximum.
The card's and the CPU's math libraries may round exp and log differently
in the last bit, so this is the spread a sound card-vs-CPU comparison can
show; chip_smoke.py's limits sit above it.
"""

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


def run(nh, steps=2):
    st = list(nh.state)
    for _ in range(steps):
        st = nh.step(st)
    return st


def main():
    import chip_smoke as cs
    torch.set_num_threads(4)
    nh = cs.NHCase(25, 10, 900.0, 1, 2, torch.float64, "cpu")
    t0 = time.perf_counter()
    base = run(nh)
    print(f"C24L10 f64, 2 big steps on the CPU: {time.perf_counter() - t0:.1f}"
          f" s; max|w| {float(base[4].abs().max()):.4e}")
    for share in (0.01, 1.0):
        for seed in (1, 2):
            with NudgeExpLog(share, seed):
                got = run(nh)
            print(f"exp/log 1 ulp on {share:g} of elements, seed {seed}: "
                  + ", ".join(
                      f"{nm} {float((a - b).abs().max() / b.abs().max()):.3e}"
                      for nm, a, b in zip(cs.NHCase.NAMES, got, base)),
                  flush=True)


if __name__ == "__main__":
    main()
