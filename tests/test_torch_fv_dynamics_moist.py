"""The PyTorch port's moist nonhydrostatic big step (model/fv_dynamics.py
fv_dynamics_nh with adiabatic = False, bench.py's six GFDL-MP tracers and
MPConfig(): tracer_2d after each acoustic loop, the tracer remap, neg_adj3
and gfdl_mp_driver) against the jitted JAX fv_dynamics_nh on the perturbed
moist Jablonowski-Williamson state at C12L10, k_split = 2, n_split = 2
(float64, CPU, <= 1e-10 x max per field and per tracer).

On the CPU the port's kernels take their plain versions; the kernel launch
counters stay 0, and tracer_2d records one adaptive subcycle count per
acoustic loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu.grid.fv_eta import set_eta
from gfdl_atmos_cubed_sphere_tpu.init.baroclinic import jw_baroclinic
from gfdl_atmos_cubed_sphere_tpu.model.dyn_core import DynConfig as JCfg
from gfdl_atmos_cubed_sphere_tpu.model.fv_dynamics import fv_dynamics_nh as jfv
from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops as jax_pack
from gfdl_atmos_cubed_sphere_tpu.model.sw_dynamics import prepare_phis as jphis
from gfdl_atmos_cubed_sphere_tpu.physics.gfdl_mp import MPConfig as JMP
from gfdl_atmos_cubed_sphere_tpu_torch.model import tracer_2d
from gfdl_atmos_cubed_sphere_tpu_torch.model.dyn_core import DynConfig
from gfdl_atmos_cubed_sphere_tpu_torch.model.fv_dynamics import fv_dynamics_nh
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import (
    build_grid_ops, state_from_arrays)
from gfdl_atmos_cubed_sphere_tpu_torch.model.sw_dynamics import prepare_phis
from gfdl_atmos_cubed_sphere_tpu_torch.ops import (a2b, csw, dsw, ke, sim1,
                                                   tp_sweep)
from gfdl_atmos_cubed_sphere_tpu_torch.physics.gfdl_mp import MPConfig

pytestmark = pytest.mark.fast

NPX, K = 13, 10
CFG = dict(npx=NPX, npz=K, dt=1800.0, hydrostatic=False, adiabatic=False,
           k_split=2, n_split=2, dddmp=0.2, d_con=1.0, do_vort_damp=True)
NAMES = ("delp", "pt", "u", "v", "w", "delz")
TRACERS = ("sphum", "liq_wat", "rainwat", "ice_wat", "snowwat", "graupel")


def test_fv_dynamics_nh_moist():
    gj = jax_pack(NPX, dtype=jnp.float64)
    gt = build_grid_ops(NPX, dtype=torch.float64, device="cpu")
    _, ptop, ak, bk = set_eta(K)
    ic = jw_baroclinic(gj.geom, K, ak, bk, ptop, perturb=True, moist=True)
    jphis(gj, ic["phis"])
    prepare_phis(gt, ic["phis"])
    dp0 = np.diff(ak) + np.diff(bk) * 1.0e5
    # bench.py:71-73: sphum from the moist state, the condensates at 1e-6
    q = {nm: np.full(ic["sphum"].shape, 1e-6) for nm in TRACERS}
    q["sphum"] = ic["sphum"]

    def jstep(*a):
        r = jfv(*a, gj, JCfg(**CFG), jnp.asarray(ak), jnp.asarray(bk), ptop,
                dp0, mp_cfg=JMP())
        return tuple(getattr(r, k) for k in NAMES), r.q

    want, want_q = jax.jit(jstep)(*(jnp.asarray(ic[k]) for k in NAMES),
                                  {k: jnp.asarray(v) for k, v in q.items()})
    ts = state_from_arrays(dict(ic, ak=ak, bk=bk, q=q), dtype=torch.float64,
                           device="cpu")
    for mod in (a2b, csw, dsw, ke, sim1, tp_sweep):
        mod.reset_launches()
    tracer_2d.reset_nsplt()
    got = fv_dynamics_nh(*(ts[k] for k in NAMES), ts["q"], gt,
                         DynConfig(**CFG), ts["ak"], ts["bk"], ptop, dp0,
                         mp_cfg=MPConfig())
    assert (a2b.launches, csw.launches, dsw.launches["fluxes"],
            dsw.launches["winds"], ke.launches, sim1.launches,
            tp_sweep.launches) == (0,) * 7
    assert len(tracer_2d.nsplt_calls) == CFG["k_split"]
    assert sorted(got.mp_diag) == ["graupel", "ice", "rain", "snow"]
    pairs = ([(nm, a, getattr(got, nm)) for nm, a in zip(NAMES, want)]
             + [(nm, want_q[nm], got.q[nm]) for nm in TRACERS])
    for nm, a, b in pairs:
        a = np.asarray(a)
        assert np.isfinite(a).all(), nm
        err = np.abs(b.numpy() - a).max() / np.abs(a).max()
        assert err <= 1e-10, (nm, err)
