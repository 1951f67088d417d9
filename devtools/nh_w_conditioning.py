"""How far last-bit differences in exp/log move the big step's fields.

    python devtools/nh_w_conditioning.py [--moist] [--hydro]
    python devtools/nh_w_conditioning.py --facade
    python devtools/nh_w_conditioning.py --solvers
    python devtools/nh_w_conditioning.py --bundle NAME [--bundle NAME ...]
    python devtools/nh_w_conditioning.py --fastphys [--steps N] [--gap K]

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

With --bundle it runs one dry big step of chip_smoke's phase 10a bundle
NAME (chip_smoke.BUNDLES: the acoustic-loop options and Riemann solvers at
C24L10, k_split = 1, n_split = 2, at the bundle's dt) in place of two
plain steps.

With --fastphys it runs chip_smoke's phase 12c steps: one moist big step
(or --steps N) with the inline fast physics (do_fast_phys) from
fast_phys_c24_ic's state, with MPConfig() (the mp_fast chain) and with the
SHiELD gfdl_mp_nml (sat_adjust), the condensates seeded as the smoke seeds
them (none within FAST_SEED_GAP K of TICE and t_wfr; --gap K for
another margin, 0 for everywhere).

With --solvers it runs the Riemann solvers of ops/nh_core.py on the column
inputs of tests/test_torch_nh_core.py (the perturbed dry wave at C12L10,
float64, seeded w, delz and ws), each case of that file's solver tests,
and prints each output's spread over its maximum: the limit a comparison
with the JAX package (whose XLA exp and log round otherwise in the last
bit on some 20 % of the elements) can be held to.
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


def solver_columns():
    """The column inputs of tests/test_torch_nh_core.py's fixture, built
    with the port's copies of the grid, eta and initial-condition code:
    (dm, pm2, pem, w, dz, ptv, ws, delp, zh, ptop) as float64 tensors."""
    import numpy as np
    from gfdl_atmos_cubed_sphere_tpu_torch import constants as con
    from gfdl_atmos_cubed_sphere_tpu_torch.grid.fv_eta import set_eta
    from gfdl_atmos_cubed_sphere_tpu_torch.grid.metrics import (
        build_grid_geometry)
    from gfdl_atmos_cubed_sphere_tpu_torch.init.baroclinic import (
        jw_baroclinic)
    K = 10
    _, ptop, ak, bk = set_eta(K)
    ic = jw_baroclinic(build_grid_geometry(13, ng=3), K, ak, bk, ptop,
                       perturb=True, moist=False)
    rng = np.random.default_rng(31)
    akap = con.KAPPA
    rrg = -con.RDGAS / con.GRAV
    pkz = np.exp(akap * np.log(rrg * ic["delp"] / ic["delz"] * ic["pt"]))
    delp, ptv = ic["delp"], ic["pt"] / pkz
    w = 0.05 * rng.standard_normal(delp.shape)
    delz = ic["delz"] * (1.0 + 1e-3 * rng.standard_normal(delp.shape))
    zs = ic["phis"][:, 0] / con.GRAV
    incr = np.cumsum(delz[:, ::-1], axis=1)[:, ::-1]
    zh = np.concatenate([zs[:, None] - incr, zs[:, None]], axis=1)
    ws = 0.01 * rng.standard_normal(zs.shape)
    pem = ptop + np.concatenate([np.zeros_like(delp[:, :1]),
                                 np.cumsum(delp, axis=1)], axis=1)
    pm2 = delp / (np.log(pem[:, 1:]) - np.log(pem[:, :-1]))
    t = lambda a: torch.as_tensor(np.array(a), dtype=torch.float64)
    return tuple(map(t, (delp / con.GRAV, pm2, pem, w, delz, ptv, ws, delp,
                         zh))) + (ptop,)


def solvers():
    """The spread of the solver tests' outputs under the exp/log nudges."""
    from types import SimpleNamespace
    from gfdl_atmos_cubed_sphere_tpu_torch import constants as con
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import nh_core as nh
    dm, pm2, pem, w, dz, pt, ws, delp, zh, ptop = solver_columns()
    akap = con.KAPPA
    gama = 1.0 / (1.0 - akap)
    DT, p_fac = 1800.0, 0.05
    zs = zh[:, -1]
    cases = {
        "sim1_solver alpha 0.75": lambda: nh.sim1_solver(
            DT, dm, pm2, pem, w, dz, pt, ws, gama, akap, p_fac, alpha=0.75),
        "sim3_solver alpha 1": lambda: nh.sim3_solver(
            DT, dm, pem, w, dz, pt, ws, gama, akap, p_fac),
        "sim3_solver alpha 0.75 scale_m 0.2": lambda: nh.sim3_solver(
            DT, dm, pem, w, dz, pt, ws, gama, akap, p_fac, scale_m=0.2,
            alpha=0.75),
        "imp_diff_w": lambda: (nh.imp_diff_w(0.01 * DT, dz, ws, w),)}
    for c_core, ms, bdt in ((True, 3, 6.0), (False, 1, 2.0),
                            (False, 4, 9.0)):
        cases[f"rim_2d_solver c_core {c_core} ms {ms} dt {bdt:g}"] = (
            lambda c_core=c_core, ms=ms, bdt=bdt: nh.rim_2d_solver(
                ms, bdt, dm, pm2, w, dz, pt, ws, gama, akap, c_core=c_core))
    for a_imp in (0.75, 0.4, -0.75, -1.0):
        cases[f"riem_solver_c a_imp {a_imp:g}"] = (
            lambda a_imp=a_imp: nh.riem_solver_c(
                5.0, delp, pt, w, zh, zs * con.GRAV, ws, akap, ptop, p_fac,
                a_imp=a_imp, ms=4))
        cases[f"riem_solver3 a_imp {a_imp:g}"] = (
            lambda a_imp=a_imp: SimpleNamespace(**{
                k: v for k, v in vars(nh.riem_solver3(
                    10.0, delp, pt, w, zh, zs, ws, akap, ptop, p_fac,
                    use_logp=True, a_imp=a_imp, scale_m=0.1, d2bg_zq=0.01,
                    ms=4)).items()}))
    for label, fn in cases.items():
        def outs(fn=fn):
            r = fn()
            return (sorted(vars(r).items()) if isinstance(r, SimpleNamespace)
                    else list(enumerate(r)))
        base = outs()
        worst = {}
        for share in (0.01, 0.2, 1.0):
            for seed in (1, 2, 3, 4):
                with NudgeExpLog(share, seed):
                    got = outs()
                for (nm, b), (_, a) in zip(base, got):
                    top = float(b.abs().max())
                    r = float((a - b).abs().max()) / (top or 1.0)
                    worst[nm] = max(worst.get(nm, 0.0), r)
        print(f"{label}: largest spread over 12 nudged runs, x each "
              f"output's max: " + ", ".join(
                  f"{nm} {r:.2e}" for nm, r in worst.items()), flush=True)


def main():
    import chip_smoke as cs
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--moist", action="store_true")
    ap.add_argument("--hydro", action="store_true")
    ap.add_argument("--facade", action="store_true")
    ap.add_argument("--solvers", action="store_true")
    ap.add_argument("--fastphys", action="store_true")
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--gap", type=float, default=None)
    ap.add_argument("--bundle", action="append", default=[],
                    choices=sorted(cs.BUNDLES))
    opt = ap.parse_args()
    torch.set_num_threads(4)
    if opt.facade:
        facade(cs)
        return
    if opt.solvers:
        solvers()
        return
    if opt.fastphys:
        from gfdl_atmos_cubed_sphere_tpu_torch.grid.metrics import (
            build_grid_geometry)
        geom = build_grid_geometry(25, ng=3)
        gap = cs.FAST_SEED_GAP if opt.gap is None else opt.gap
        ic = cs.fast_phys_c24_ic(geom, gap=gap)
        for mp, name in ((None, "fast_phys"),
                         (cs.shield_mp_config(), "fast_phys shield_mp")):
            print(f"condensates seeded where T is over {gap:g} K from TICE "
                  f"and t_wfr:")
            spread(cs.BigStep(25, 10, 900.0, 1, 2, torch.float64, "cpu",
                              geom=geom, ic=ic, moist=True,
                              over=cs.FAST_PHYS, bundle=name, mp=mp),
                   steps=opt.steps)
        return
    if opt.bundle:
        for name in opt.bundle:
            hydro, dt, over = cs.BUNDLES[name]
            spread(cs.BigStep(25, 10, dt, 1, 2, torch.float64, "cpu",
                              hydro=hydro, over=over, bundle=name), steps=1)
        return
    spread(cs.BigStep(25, 10, 900.0, 1, 2, torch.float64, "cpu",
                      moist=opt.moist, hydro=opt.hydro))


def spread(case, steps=2):
    """Each field's and tracer's max |difference| over its own maximum
    between `steps` big steps of case as it is and with the exp/log
    nudges."""
    t0 = time.perf_counter()
    base = run(case, steps)
    print(f"C24L10 f64 {case.label}, {steps} big steps on the CPU: "
          f"{time.perf_counter() - t0:.1f} s; max|.| "
          + ", ".join(f"{nm} {float(b.abs().max()):.4e}"
                      for nm, b in zip(case.names, base)))
    for share in (0.01, 1.0):
        for seed in (1, 2, 3, 4):
            with NudgeExpLog(share, seed):
                got = run(case, steps)
            print(f"exp/log 1 ulp on {share:g} of elements, seed {seed}: "
                  + ", ".join(
                      f"{nm} {float((a - b).abs().max() / b.abs().max()):.3e}"
                      for nm, a, b in zip(case.names, got, base)),
                  flush=True)


if __name__ == "__main__":
    main()
