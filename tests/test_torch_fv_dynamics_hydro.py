"""The PyTorch port's hydrostatic big step (model/fv_dynamics.py
fv_dynamics_hydro) against the jitted JAX fv_dynamics_hydro: bench.py's
moist c192_hydro configuration (hydrostatic, k_split = 1; adiabatic =
False, the six GFDL-MP tracers, MPConfig()) on the perturbed moist
Jablonowski-Williamson state at C12L10, n_split = 2 (float64, CPU, <= 1e-10
x max per field and per tracer); and the kernel arguments the port still
refuses.

On the CPU the port's kernels take their plain versions; the kernel launch
counters stay 0, and tracer_2d records one adaptive subcycle count."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu.grid.fv_eta import set_eta
from gfdl_atmos_cubed_sphere_tpu.init.baroclinic import jw_baroclinic
from gfdl_atmos_cubed_sphere_tpu.model.dyn_core import DynConfig as JCfg
from gfdl_atmos_cubed_sphere_tpu.model.fv_dynamics import (
    fv_dynamics_hydro as jfv)
from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops as jax_pack
from gfdl_atmos_cubed_sphere_tpu.model.sw_dynamics import prepare_phis as jphis
from gfdl_atmos_cubed_sphere_tpu.physics.gfdl_mp import MPConfig as JMP
from gfdl_atmos_cubed_sphere_tpu_torch.model import dyn_core, tracer_2d
from gfdl_atmos_cubed_sphere_tpu_torch.model.dyn_core import DynConfig
from gfdl_atmos_cubed_sphere_tpu_torch.model.fv_dynamics import (
    fv_dynamics_hydro)
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import (
    build_grid_ops, state_from_arrays)
from gfdl_atmos_cubed_sphere_tpu_torch.model.sw_dynamics import prepare_phis
from gfdl_atmos_cubed_sphere_tpu_torch.ops import (a2b, csw, dsw, pg_col,
                                                   sim1, tp_sweep)
from gfdl_atmos_cubed_sphere_tpu_torch.physics.gfdl_mp import MPConfig

pytestmark = pytest.mark.fast

NPX, K = 13, 10
CFG = dict(npx=NPX, npz=K, dt=1800.0, hydrostatic=True, adiabatic=False,
           k_split=1, n_split=2)
NAMES = ("delp", "pt", "u", "v")
TRACERS = ("sphum", "liq_wat", "rainwat", "ice_wat", "snowwat", "graupel")


def test_fv_dynamics_hydro_moist():
    gj = jax_pack(NPX, dtype=jnp.float64)
    gt = build_grid_ops(NPX, dtype=torch.float64, device="cpu")
    _, ptop, ak, bk = set_eta(K)
    ic = jw_baroclinic(gj.geom, K, ak, bk, ptop, perturb=True, moist=True)
    jphis(gj, ic["phis"])
    prepare_phis(gt, ic["phis"])
    # bench.py:71-73: sphum from the moist state, the condensates at 1e-6
    q = {nm: np.full(ic["sphum"].shape, 1e-6) for nm in TRACERS}
    q["sphum"] = ic["sphum"]

    def jstep(*a):
        r = jfv(*a, gj, JCfg(**CFG), jnp.asarray(ak), jnp.asarray(bk), ptop,
                mp_cfg=JMP())
        return tuple(getattr(r, k) for k in NAMES), r.q

    want, want_q = jax.jit(jstep)(*(jnp.asarray(ic[k]) for k in NAMES),
                                  {k: jnp.asarray(v) for k, v in q.items()})
    ts = state_from_arrays(dict(ic, ak=ak, bk=bk, q=q), dtype=torch.float64,
                           device="cpu")
    for mod in (a2b, csw, dsw, pg_col, sim1, tp_sweep):
        mod.reset_launches()
    tracer_2d.reset_nsplt()
    got = fv_dynamics_hydro(*(ts[k] for k in NAMES), ts["q"], gt,
                            DynConfig(**CFG), ts["ak"], ts["bk"], ptop,
                            mp_cfg=MPConfig())
    assert (a2b.launches, csw.launches, dsw.launches["fluxes"],
            dsw.launches["winds"], sim1.launches, tp_sweep.launches,
            *pg_col.launches.values()) == (0,) * 9
    assert len(tracer_2d.nsplt_calls) == CFG["k_split"]
    assert sorted(got.mp_diag) == ["graupel", "ice", "rain", "snow"]
    pairs = ([(nm, a, getattr(got, nm)) for nm, a in zip(NAMES, want)]
             + [(nm, want_q[nm], got.q[nm]) for nm in TRACERS])
    for nm, a, b in pairs:
        a = np.asarray(a)
        assert np.isfinite(a).all(), nm
        err = np.abs(b.numpy() - a).max() / np.abs(a).max()
        assert err <= 1e-10, (nm, err)


def test_hydro_refuses_what_is_not_ported():
    """The hydrostatic path runs the JAX package's acoustic-loop options
    (beta, d_ext, fill_dp, rf_fast: tests/test_torch_acoustic_options.py);
    what JAX's d_sw has no branch for raises before any work: the d_sw
    kernels' damping orders beyond JAX's (nord = 4, nord_v = 3, nord_v2 =
    3), ValueError from the packing of their operands on the hydrostatic
    form's fields, ahead of any device work."""
    P = NPX - 1 + 6
    delp = torch.zeros((6, 10, P, P), dtype=torch.float64)
    winds = dict(dt=900.0, hord_mt=10, hord_vt=10, nord=1, nord_v=1,
                 dddmp=0.2, d2_bg=0.0, d4_bg=0.16, damp_v=0.02)
    for over in (dict(nord=4), dict(nord_v=3), dict(nord_v2=3)):
        with pytest.raises(ValueError, match="nord"):
            dsw._winds_operands(delp, None, None, None, None, None, None,
                                None, None, None, None, None,
                                **dict(winds, **over))
    fluxes = dict(dt=900.0, hord_dp=10, hord_tm=10, hord_vt=10, nord_v=1,
                  damp_v=0.02)
    for over in (dict(nord_v=3), dict(nord_v2=3)):
        with pytest.raises(ValueError, match="nord"):
            dsw._fluxes_operands(delp, delp, None, None, None, None,
                                 **dict(fluxes, **over))
