"""The PyTorch port's solo driver (driver/solo.py) against the JAX
package's (float64, CPU, C12L10, the JAX lifecycle test's
Atmosphere(13, 10, 600.0, ...)), hydrostatic: Held-Suarez forcing, the
Rayleigh sponge toward the initial winds (tau > 0; the cutoff sits below
ptop = 500 hPa of set_eta(10) so that the sponge acts), the energy fixer
and the angular-momentum fixer, 3 big steps and then adiabatic_init (its
backward passes run the big step and every kernel wrapper with dt < 0),
every field <= 1e-10 x its maximum after each; the same nonhydrostatic;
and one moist fv_dynamics_hydro big step with the fixers and the real-case
Rayleigh friction, without and with the GFDL microphysics. Restart files
and the CLI: test_torch_solo_restart.py.

The JAX package runs eagerly and the port on one thread, so each test
takes one core; the three share one process, in which the JAX package
compiles each eager operation once for all of them. At three items the
file queues behind the tier-1 run's longest file, tests/test_shard_halo.py,
and runs beside it."""

from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu.driver.solo import Atmosphere as JAtm
from gfdl_atmos_cubed_sphere_tpu.grid.fv_eta import set_eta
from gfdl_atmos_cubed_sphere_tpu.init.baroclinic import jw_baroclinic
from gfdl_atmos_cubed_sphere_tpu.model import fv_dynamics as jfvd
from gfdl_atmos_cubed_sphere_tpu.model.dyn_core import DynConfig as JCfg
from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops as jax_pack
from gfdl_atmos_cubed_sphere_tpu.model.sw_dynamics import prepare_phis as jphis
from gfdl_atmos_cubed_sphere_tpu.physics import gfdl_mp as jgmp
from gfdl_atmos_cubed_sphere_tpu.physics.gfdl_mp import MPConfig as JMP
from gfdl_atmos_cubed_sphere_tpu_torch.driver.solo import Atmosphere
from gfdl_atmos_cubed_sphere_tpu_torch.model import fv_dynamics as fvd
from gfdl_atmos_cubed_sphere_tpu_torch.model.dyn_core import DynConfig
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import (
    build_grid_ops, state_from_arrays)
from gfdl_atmos_cubed_sphere_tpu_torch.model.sw_dynamics import prepare_phis
from gfdl_atmos_cubed_sphere_tpu_torch.physics import gfdl_mp as tgmp
from gfdl_atmos_cubed_sphere_tpu_torch.physics.gfdl_mp import MPConfig

pytestmark = pytest.mark.fast

NPX, K, DT = 13, 10, 600.0
FIXERS = dict(tau=10.0, rf_cutoff=8.0e4, consv_te=1.0, consv_am=True)
FIELDS = ("delp", "pt", "u", "v", "w", "delz", "phis")


def compare(port, jax_atm, what, tol=1e-10):
    for k in FIELDS:
        a = np.asarray(jax_atm.state[k])
        b = port.state[k].numpy()
        assert np.isfinite(a).all(), (what, k)
        err = np.abs(b - a).max()
        assert err <= tol * np.abs(a).max(), (what, k, err)


@contextmanager
def one_core():
    """Run the port's CPU ops on one thread inside the block: these tests
    run beside the tier-1 run's longest file, and one core each leaves it
    its own."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def run_against_jax(hydrostatic):
    """3 big steps and then adiabatic_init of the port's Atmosphere and
    the JAX package's, with Held-Suarez, the sponge and both fixers. The
    JAX package runs eagerly: compiling its three steps would take three
    cores for as long as the eager run takes one."""
    kw = dict(physics="hs", hydrostatic=hydrostatic, dtype="f64",
              cfg_overrides=dict(FIXERS))
    with one_core(), jax.disable_jit():
        ja = JAtm(NPX, K, DT, **kw)
        ta = Atmosphere(NPX, K, DT, device="cpu", **kw)
        compare(ta, ja, "initial state", tol=0.0)
        ja.atmosphere(3)
        ta.atmosphere(3)
        assert ta.step_count == 3 and ta.time_seconds == 3 * DT
        compare(ta, ja, "3 steps")
        ja.adiabatic_init()
        ta.adiabatic_init()
        compare(ta, ja, "adiabatic_init")
        assert ta.audit(out=lambda s: None)


def test_solo_hydrostatic_matches_jax():
    run_against_jax(hydrostatic=True)


def test_solo_nonhydrostatic_matches_jax():
    run_against_jax(hydrostatic=False)


# -- one moist hydrostatic big step with the fixers ------------------------

NAMES = ("delp", "pt", "u", "v")
TRACERS = ("sphum", "liq_wat", "rainwat", "ice_wat", "snowwat", "graupel")
STEP_CFG = dict(npx=NPX, npz=K, dt=1800.0, hydrostatic=True,
                adiabatic=False, k_split=1, n_split=2, consv_te=1.0,
                consv_am=True, tau=2.0, rf_cutoff=8.0e4, is_ideal_case=False)
# the precipitating condensates after the microphysics: rain evaporation,
# snow and graupel growth carry the step's last-bit differences in pt into
# them. Over seeds 0-2 the microphysics' inputs differ by 3.5e-14 to
# 4.6e-14 of pt's maximum; the port's microphysics equals the JAX
# package's on the same inputs to <= 8.7e-12; and the JAX package's own
# microphysics, given the port's inputs in place of its own, moves
# rainwat, snowwat and graupel by 4.7e-10 to 1.6e-9 of their maxima, as
# far as the port's step reads (devtools/fixer_conditioning.py). The limit
# sits 6x over the largest of these readings.
MP_LIMIT = 1e-8
MP_AMPLIFIED = ("rainwat", "snowwat", "graupel")


class FixerStepPair:
    """The step's inputs in both packages: the perturbed moist
    Jablonowski-Williamson state (seeded: 0.01 K noise on pt, condensates
    uniform in [0.5, 1.5] x 1e-6; unseeded: bench.py's uniform 1e-6), with
    MPConfig() when mp."""

    def __init__(self, seed=None, mp=False):
        self.mp = mp
        self.gj = jax_pack(NPX, dtype=jnp.float64)
        self.gt = build_grid_ops(NPX, dtype=torch.float64, device="cpu")
        _, self.ptop, ak, bk = set_eta(K)
        ic = jw_baroclinic(self.gj.geom, K, ak, bk, self.ptop, perturb=True,
                           moist=True)
        jphis(self.gj, ic["phis"])
        prepare_phis(self.gt, ic["phis"])
        shape = ic["sphum"].shape
        if seed is None:
            q = {nm: np.full(shape, 1e-6) for nm in TRACERS}
        else:
            rng = np.random.default_rng(seed)
            ic = dict(ic, pt=ic["pt"] + rng.normal(0.0, 0.01, ic["pt"].shape))
            q = {nm: 1e-6 * rng.uniform(0.5, 1.5, shape) for nm in TRACERS}
        q["sphum"] = ic["sphum"]
        self.ic, self.q, self.ak, self.bk = ic, q, ak, bk

    def jax(self):
        """The JAX step's fields and tracers (numpy)."""
        r = jfvd.fv_dynamics_hydro(
            *(jnp.asarray(self.ic[k]) for k in NAMES),
            {k: jnp.asarray(v) for k, v in self.q.items()}, self.gj,
            JCfg(**STEP_CFG), jnp.asarray(self.ak), jnp.asarray(self.bk),
            self.ptop, mp_cfg=JMP() if self.mp else None)
        return {**{k: np.asarray(getattr(r, k)) for k in NAMES},
                **{k: np.asarray(r.q[k]) for k in TRACERS}}

    def port(self):
        """The port's step's fields and tracers (numpy)."""
        ts = state_from_arrays(dict(self.ic, ak=self.ak, bk=self.bk,
                                    q=self.q),
                               dtype=torch.float64, device="cpu")
        r = fvd.fv_dynamics_hydro(
            *(ts[k] for k in NAMES), ts["q"], self.gt, DynConfig(**STEP_CFG),
            ts["ak"], ts["bk"], self.ptop,
            mp_cfg=MPConfig() if self.mp else None)
        return {**{k: getattr(r, k).numpy() for k in NAMES},
                **{k: r.q[k].numpy() for k in TRACERS}}

    def mp_witness(self):
        """The step in both packages with the microphysics' inputs and
        outputs recorded, and the JAX package's microphysics run again on
        the port's inputs. Returns the errors (see errors()) of: the port
        against JAX ("step"); the port's microphysics against the JAX
        package's on the same (the port's) inputs ("same_inputs"); the
        JAX package's microphysics on the port's inputs against it on its
        own ("jax_spread"); and the inputs, pt and the tracers, port
        against JAX ("inputs")."""
        seen = {}

        def recorder(mod, key):
            orig = mod.gfdl_mp_driver

            def wrapped(pt, delp, delz, q, *a, **k):
                out = orig(pt, delp, delz, q, *a, **k)
                seen[key] = (pt, delp, dict(q), out)
                return out
            return orig, wrapped

        jorig, jwrap = recorder(jgmp, "jax")
        torig, twrap = recorder(tgmp, "port")
        jgmp.gfdl_mp_driver, tgmp.gfdl_mp_driver = jwrap, twrap
        try:
            step = self.errors(self.port(), self.jax())
        finally:
            jgmp.gfdl_mp_driver, tgmp.gfdl_mp_driver = jorig, torig

        def fields(pt, q):
            return {"pt": np.asarray(pt),
                    **{k: np.asarray(q[k]) for k in TRACERS}}

        tpt, tdelp, tq, (tpt2, tq2, _) = seen["port"]
        jpt, _, jq, (jpt2, jq2, _) = seen["jax"]
        tnp = fields(tpt.numpy(), {k: v.numpy() for k, v in tq.items()})
        again = jorig(jnp.asarray(tpt.numpy()), jnp.asarray(tdelp.numpy()),
                      None, {k: jnp.asarray(v.numpy()) for k, v in tq.items()},
                      STEP_CFG["dt"], self.ptop, cfg=JMP(), hydrostatic=True)
        port_out = fields(tpt2.numpy(), {k: v.numpy() for k, v in tq2.items()})
        return dict(
            step=step,
            same_inputs=self.errors(port_out, fields(again[0], again[1])),
            jax_spread=self.errors(fields(again[0], again[1]),
                                   fields(jpt2, jq2)),
            inputs=self.errors(tnp, fields(jpt, jq)))

    @staticmethod
    def errors(got, want):
        """Each field's max |got - want| over max |want|."""
        out = {}
        for k, a in want.items():
            assert got[k].shape == a.shape and np.isfinite(a).all(), k
            out[k] = np.abs(got[k] - a).max() / np.abs(a).max()
        return out

    def report(self, got, want):
        return ", ".join(f"{k} {e:.2e}"
                         for k, e in self.errors(got, want).items())


def test_fv_dynamics_hydro_moist_with_fixers():
    """One moist c192_hydro big step with consv_te = 1, consv_am and the
    real-case Rayleigh friction (tau > 0 with no reference winds and
    is_ideal_case False) against the JAX step. Without the GFDL
    microphysics (the six tracers through tracer_2d, the remap and
    neg_adj3) every field and tracer <= 1e-10. With it, the combination
    the moist c192_hydro configuration runs, on a seeded state: the port's
    microphysics equals the JAX package's on the same inputs to 1e-10 in
    every output, and the step's fields and tracers are within 1e-10 of
    the JAX step's, but the precipitating condensates, within MP_LIMIT."""
    with one_core(), jax.disable_jit():
        pair = FixerStepPair()
        errs = pair.errors(pair.port(), pair.jax())
        w = FixerStepPair(seed=1, mp=True).mp_witness()
    for k, e in errs.items():
        assert e <= 1e-10, ("no MP", k, e)
    for k, e in w["same_inputs"].items():
        assert e <= 1e-10, ("MP on the same inputs", k, e)
    for k, e in w["step"].items():
        assert e <= (MP_LIMIT if k in MP_AMPLIFIED else 1e-10), ("MP", k, e)
