"""The NWP forecast path of the port against the JAX package, as a user
runs it (float64, CPU, C12): a chgres cold start from its tile files
(source L20 onto set_eta(15) over an orography file's hill, as
tests/test_nggps_files.py's cold start), one IAU application of a lat-lon
increment (io/da_increment.py), one moist nonhydrostatic big step
(fv_dynamics_nh, k_split 1, n_split 2, the six GFDL-MP tracers with
neg_adj3; the JAX step jitted), then one nudging step (nwp_nudge toward
ObsSchedule's analyses on the model levels, ps_nudging with the bias
correction, breed_slp_inline with two storms). Each field and tracer <=
1e-10 x its maximum, w 5e-9 (the NH w conditioning, ROADMAP "Not
faults"), after the cold start and at the end."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu.grid.fv_eta import set_eta
from gfdl_atmos_cubed_sphere_tpu.io import da_increment as jda
from gfdl_atmos_cubed_sphere_tpu.io import external_ic as jeic
from gfdl_atmos_cubed_sphere_tpu.model.dyn_core import DynConfig as JCfg
from gfdl_atmos_cubed_sphere_tpu.model.fv_dynamics import fv_dynamics_nh as jfv
from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops as jax_pack
from gfdl_atmos_cubed_sphere_tpu.model.sw_dynamics import prepare_phis as jphis
from gfdl_atmos_cubed_sphere_tpu.physics import nudging as jng
from gfdl_atmos_cubed_sphere_tpu_torch.io import da_increment as da
from gfdl_atmos_cubed_sphere_tpu_torch.io import external_ic as eic
from gfdl_atmos_cubed_sphere_tpu_torch.model.dyn_core import DynConfig
from gfdl_atmos_cubed_sphere_tpu_torch.model.fv_dynamics import fv_dynamics_nh
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import build_grid_ops
from gfdl_atmos_cubed_sphere_tpu_torch.model.sw_dynamics import prepare_phis
from gfdl_atmos_cubed_sphere_tpu_torch.physics import nudging as ng

from torch_nwp_inputs import (jitted_jax_remaps, latlon_increments,
                              write_nggps_files)

pytestmark = pytest.mark.fast

NPX, NPZ, KS = 13, 15, 20
N = NPX - 1
DT = 600.0
# the damping options off: they add a third to the JAX step's compile
# (~27 s against ~20 s) and nothing to the path under test
CFG = dict(npx=NPX, npz=NPZ, dt=DT, hydrostatic=False, adiabatic=False,
           k_split=1, n_split=2)
FIELDS = ("delp", "pt", "u", "v", "w", "delz")
TRACERS = ("sphum", "liq_wat", "rainwat", "ice_wat", "snowwat", "graupel")
TOL = {"w": 5e-9}
STORMS = np.array([[2.2, 0.35, 97000.0], [4.0, -0.3, 99000.0]])
BREED = dict(r_min=1500.0e3, r_inc=100.0e3, del_r=1500.0e3, phis_max=3000.0)


def close(got, want, what, tol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(want).all(), what
    top = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * (top if top > 0 else 1.0), (what, err / top)


def nudge(pkg, state, sched, t, g, ak, bk, ptop, area):
    """The nudging step after a big step: nwp_nudge of u, v, pt, sphum
    toward the analyses at t, ps_nudging toward their ps, the breeding."""
    xp = jnp if pkg is jng else torch
    cum = xp.cumsum(state["delp"], 1)
    pe = xp.concatenate([xp.zeros_like(cum[:, :1]), cum], 1) + ptop
    pm = 0.5 * (pe[:, 1:] + pe[:, :-1])
    tgt = sched.target_at(t)
    cfg = pkg.NudgeConfig(tau_winds=3600.0, tau_t=3600.0, tau_q=7200.0,
                          p_wvp=100.0e2, p_full=300.0e2)
    out = pkg.nwp_nudge(DT, {k: state[k] for k in ("u", "v", "pt", "sphum")},
                        tgt, pm, cfg)
    delp, _ = pkg.ps_nudging(DT, ak, bk, tgt["ps"], state["delp"], area=area,
                             tau=3600.0)
    delp = pkg.breed_slp_inline(DT, delp, out["pt"][:, -1],
                                g.phis_p[:, 0, 3:-3, 3:-3], STORMS, g, ak,
                                pkg.BreedConfig(**BREED))
    return dict(state, **out, delp=delp)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("nwp")
    write_nggps_files(d, N, KS, seed=6, hill=500.0)
    gj = jax_pack(NPX, dtype=jnp.float64)
    gt = build_grid_ops(NPX, dtype=torch.float64, device="cpu")
    _, ptop, ak, bk = set_eta(NPZ)
    mp = jitted_jax_remaps()
    try:
        jcold = jeic.get_nggps_ic_files(str(d), gj.geom, ak, bk, ptop)
    finally:
        mp.undo()
    tcold = eic.get_nggps_ic_files(str(d), gt.geom, ak, bk, ptop,
                                   device="cpu")
    return gj, gt, ak, bk, ptop, jcold, tcold


def test_cold_start_iau_step_nudge(paths):
    gj, gt, ak, bk, ptop, jcold, tcold = paths
    assert sorted(tcold) == sorted(jcold)
    for k in jcold:
        close(tcold[k], jcold[k], f"cold start {k}", 1e-10)
    jphis(gj, jcold["phis"])
    prepare_phis(gt, tcold["phis"])
    rng = np.random.default_rng(24)
    q0 = {nm: 1e-6 * (1 + 0.02 * rng.uniform(-1, 1, jcold["delp"].shape))
          for nm in TRACERS if nm not in jcold}
    jst = {k: jnp.asarray(jcold[k]) for k in FIELDS + ("sphum", "liq_wat")}
    tst = {k: tcold[k] for k in FIELDS + ("sphum", "liq_wat")}
    jst.update({k: jnp.asarray(v) for k, v in q0.items()})
    tst.update({k: torch.as_tensor(v) for k, v in q0.items()})

    # the IAU's first application of a 3 h window
    raw = latlon_increments(NPZ)
    jiau = jda.IAU(jda.cube_increments(raw, gj.geom, g=gj),
                   jda.IAUConfig(window_s=10800.0))
    tiau = da.IAU(da.cube_increments(raw, gt.geom, g=gt),
                  da.IAUConfig(window_s=10800.0))
    jst, tst = jiau.apply(jst, 0.0, DT), tiau.apply(tst, 0.0, DT)

    # the moist big step
    dp0 = np.diff(ak) + np.diff(bk) * 1.0e5

    def jstep(fields, q):
        r = jfv(*fields, q, gj, JCfg(**CFG), jnp.asarray(ak), jnp.asarray(bk),
                ptop, dp0)
        return tuple(getattr(r, k) for k in FIELDS), r.q

    wf, wq = jax.jit(jstep)(tuple(jst[k] for k in FIELDS),
                            {k: jst[k] for k in TRACERS})
    got = fv_dynamics_nh(*(tst[k] for k in FIELDS),
                         {k: tst[k] for k in TRACERS}, gt, DynConfig(**CFG),
                         ak, bk, ptop, dp0)
    jst = dict(zip(FIELDS, wf), **wq)
    tst = dict({k: getattr(got, k) for k in FIELDS}, **got.q)

    # the nudging toward two analyses 6 h apart (the cold start, and a
    # warmer, moister one with stronger winds)
    ana = [{"pt": jcold["pt"], "sphum": jcold["sphum"], "u": jcold["u"],
            "v": jcold["v"], "ps": ptop + np.asarray(jcold["delp"]).sum(1)}]
    ana.append({"pt": ana[0]["pt"] + 1.5, "sphum": ana[0]["sphum"] * 1.05,
                "u": ana[0]["u"] * 1.1, "v": ana[0]["v"] * 1.1,
                "ps": ana[0]["ps"] + 150.0})
    area = gj.geom.interior("area")
    jsch = jng.ObsSchedule([0.0, 21600.0], [{k: jnp.asarray(v)
                                             for k, v in a.items()}
                                            for a in ana])
    tsch = ng.ObsSchedule([0.0, 21600.0], [{k: torch.as_tensor(
        np.asarray(v)) for k, v in a.items()} for a in ana])
    jst = nudge(jng, jst, jsch, DT, gj, ak, bk, ptop, jnp.asarray(area))
    tst = nudge(ng, tst, tsch, DT, gt, ak, bk, ptop, torch.as_tensor(area))
    for k in FIELDS + TRACERS:
        close(tst[k], jst[k], f"after the nudging {k}", TOL.get(k, 1e-10))
