"""The PyTorch port's nudging family (physics/nudging.py) against the JAX
package's functions of the same names on the same seeded inputs (float64,
CPU, C12; the cases of tests/test_external_nudge.py): nwp_nudge, the
one-shot increment and the step IAU, climate_nudge with its ps path and
pressure profile, ada_nudge, time_interp_climatology, the TC vortex
breeding (two valid storms and one out of range, the global mass kept),
ps_nudging with its cap, terrain decay and bias correction,
temp_bias_correction, ObsSchedule and remap_analysis_to_model. Each output
<= 1e-12 x its maximum."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu.grid.fv_eta import set_eta
from gfdl_atmos_cubed_sphere_tpu.init.baroclinic import jw_baroclinic
from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops as jax_pack
from gfdl_atmos_cubed_sphere_tpu.physics import nudging as jng
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import build_grid_ops
from gfdl_atmos_cubed_sphere_tpu_torch.physics import nudging as ng

from torch_nwp_inputs import jitted_jax_remaps

pytestmark = pytest.mark.fast

NPX, K = 13, 10
N = NPX - 1


def close(got, want, what, tol=1e-12):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(want).all(), what
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * (top if top > 0 else 1.0), what


def close_dicts(got, want, what):
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for k in want:
        close(got[k], want[k], f"{what} {k}")


def both(d):
    """The dict as JAX arrays and as CPU tensors."""
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.as_tensor(v) for k, v in d.items()})


@pytest.fixture(scope="module")
def case():
    gj = jax_pack(NPX, dtype=jnp.float64)
    gt = build_grid_ops(NPX, dtype=torch.float64, device="cpu")
    _, ptop, ak, bk = set_eta(K)
    ic = jw_baroclinic(gj.geom, K, ak, bk, ptop, perturb=True, moist=True)
    rng = np.random.default_rng(8)
    pe = ptop + np.concatenate([np.zeros((6, 1, N, N)),
                                np.cumsum(ic["delp"], axis=1)], axis=1)
    pm = 0.5 * (pe[:, 1:] + pe[:, :-1])
    st = {k: ic[k] for k in ("u", "v", "pt", "delp")}
    st["sphum"] = ic["sphum"]
    tgt = {k: v + rng.uniform(-1.0, 1.0, v.shape) * (1e-4 if k == "sphum"
                                                     else 2.0)
           for k, v in st.items() if k != "delp"}
    return gj, gt, ak, bk, ptop, ic, st, tgt, pm


def test_nwp_nudge_and_increments(case):
    *_, st, tgt, pm = case
    (js, ts), (jt, tt) = both(st), both(tgt)
    cfg = dict(tau_t=3600.0, tau_winds=3600.0, tau_q=7200.0,
               p_wvp=550.0e2, p_full=700.0e2)
    want = jng.nwp_nudge(1800.0, js, jt, jnp.asarray(pm),
                         jng.NudgeConfig(**cfg))
    got = ng.nwp_nudge(1800.0, ts, tt, torch.as_tensor(pm),
                       ng.NudgeConfig(**cfg))
    close_dicts(got, want, "nwp_nudge")
    inc = {"pt": np.full(st["pt"].shape, 6.0), "sphum": 1e-5 * tgt["sphum"]}
    ji, ti = both(inc)
    close_dicts(ng.apply_da_increment(ts, ti, 0.3),
                jng.apply_da_increment(js, ji, 0.3), "apply_da_increment")
    jiau, tiau = jng.IAU(ji, 3600.0, 600.0), ng.IAU(ti, 3600.0, 600.0)
    for _ in range(8):                 # more steps than the window
        js, ts = jiau.step(js), tiau.step(ts)
        assert tiau.applied == jiau.applied
    close_dicts(ts, js, "IAU.step")


@pytest.mark.parametrize("pdep", [False, True])
def test_climate_and_ada_nudge(case, pdep):
    *_, ak, bk, ptop, ic, st, tgt, pm = case
    (js, ts), (jt, tt) = both(st), both(tgt)
    ps = ak[0] + st["delp"].sum(axis=1) + 300.0
    cfg = dict(u_tau=3600.0, v_tau=7200.0, t_tau=3600.0, q_tau=3600.0,
               ps_tau=3600.0, skip_top_q=2, skip_bot_q=1,
               use_pdep_nudge=pdep, p_relax=800.0e2, p_norelax=560.0e2)
    jt["ps"], tt["ps"] = jnp.asarray(ps), torch.as_tensor(ps)
    want = jng.climate_nudge(900.0, js, jt, jnp.asarray(pm),
                             jng.ClimateNudgeConfig(**cfg), ak=ak, bk=bk,
                             ptop=ptop)
    got = ng.climate_nudge(900.0, ts, tt, torch.as_tensor(pm),
                           ng.ClimateNudgeConfig(**cfg), ak=ak, bk=bk,
                           ptop=ptop)
    for i, what in enumerate(("state", "tendencies")):
        close_dicts(got[i], want[i], f"climate_nudge {what}")
    want = jng.ada_nudge(900.0, js, jt, jnp.asarray(pm),
                         jng.ClimateNudgeConfig(**cfg))
    got = ng.ada_nudge(900.0, ts, tt, torch.as_tensor(pm),
                       ng.ClimateNudgeConfig(**cfg))
    for i, what in enumerate(("state", "tendencies")):
        close_dicts(got[i], want[i], f"ada_nudge {what}")
    clim = {k: (st[k], tgt[k]) for k in tgt}
    close_dicts(ng.time_interp_climatology(
        {k: tuple(map(torch.as_tensor, v)) for k, v in clim.items()}, 0.3),
        jng.time_interp_climatology(
        {k: tuple(map(jnp.asarray, v)) for k, v in clim.items()}, 0.3),
        "time_interp_climatology")


def test_breed_slp_inline(case):
    gj, gt, ak, bk, ptop, ic, st, tgt, pm = case
    rng = np.random.default_rng(9)
    delp = ic["delp"] * (1.0 + 0.01 * rng.uniform(-1, 1, ic["delp"].shape))
    pt_bot = ic["pt"][:, -1]
    phis = ic["phis"][:, 0] + 100.0 * rng.uniform(size=(6, N, N))
    # two storms, and one outside 45 degrees that must add nothing
    storms = np.array([[2.2, 0.35, 97000.0], [4.0, -0.3, 99000.0],
                       [1.0, 1.2, 96000.0]])
    # vortex and ring radii of a few C12 cells (~800 km each)
    radii = dict(r_min=1500.0e3, r_inc=100.0e3, del_r=1500.0e3,
                 phis_max=3000.0)
    want = jng.breed_slp_inline(450.0, jnp.asarray(delp),
                                jnp.asarray(pt_bot), jnp.asarray(phis),
                                storms, gj, ak, jng.BreedConfig(**radii))
    got = ng.breed_slp_inline(450.0, torch.as_tensor(delp),
                              torch.as_tensor(pt_bot), torch.as_tensor(phis),
                              storms, gt, ak, ng.BreedConfig(**radii))
    close(got, want, "breed_slp_inline")
    assert np.abs(got.numpy() - delp).max() > 1.0       # it did breed
    area = gj.geom.interior("area")
    m0 = (delp.sum(axis=1) * area).sum()
    m1 = (got.numpy().sum(axis=1) * area).sum()
    assert abs(m1 - m0) <= 1e-12 * m0
    # the invalid storm alone leaves delp as it was
    only = ng.breed_slp_inline(450.0, torch.as_tensor(delp),
                               torch.as_tensor(pt_bot),
                               torch.as_tensor(phis), storms[2:], gt, ak,
                               ng.BreedConfig(**radii))
    close(only, delp, "out-of-range storm")


def test_ps_nudging_and_bias_corrections(case):
    gj, gt, ak, bk, ptop, ic, st, tgt, pm = case
    rng = np.random.default_rng(10)
    delp = ic["delp"]
    ps0 = ak[0] + delp.sum(axis=1)
    target = ps0 + rng.uniform(-500.0, 800.0, ps0.shape)
    target[0, 0, 0] += 5000.0                          # capped at 10 hPa
    area = gj.geom.interior("area")
    phis = ic["phis"][:, 0]
    gz0 = phis + 9.80665 * rng.uniform(0.0, 800.0, phis.shape)
    for kw in (dict(tau=600.0, do_bias=False),
               dict(tau=3600.0, do_bias=True, mask=0.5),
               dict(tau=1800.0, do_bias=True, phis=phis, gz0=gz0)):
        J = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
             for k, v in kw.items()}
        T = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
             for k, v in kw.items()}
        want = jng.ps_nudging(600.0, ak, bk, jnp.asarray(target),
                              jnp.asarray(delp), area=jnp.asarray(area), **J)
        got = ng.ps_nudging(600.0, ak, bk, torch.as_tensor(target),
                            torch.as_tensor(delp),
                            area=torch.as_tensor(area), **T)
        close(got[0], want[0], f"ps_nudging delp {kw}")
        close(got[1], want[1], f"ps_nudging dps {kw}")
    for bias in (2.0, -2.0, 0.001):
        inc = rng.normal(bias, 1.0, (6, N, N))
        close(ng.ps_bias_correction(torch.as_tensor(inc),
                                    torch.as_tensor(area)),
              jng.ps_bias_correction(jnp.asarray(inc), jnp.asarray(area)),
              f"ps_bias_correction {bias}")
    t_dt = rng.normal(0.5, 1.0, (6, K, N, N))
    t_dt[:, 3] -= 1.0
    close(ng.temp_bias_correction(torch.as_tensor(t_dt),
                                  torch.as_tensor(area)),
          jng.temp_bias_correction(jnp.asarray(t_dt), jnp.asarray(area)),
          "temp_bias_correction")


def test_obs_schedule_and_remap_analysis(case):
    gj, gt, ak, bk, ptop, ic, st, tgt, pm = case
    rng = np.random.default_rng(11)
    ks = 12
    aks = np.linspace(50.0, 0.0, ks + 1)
    bks = np.linspace(0.0, 1.0, ks + 1)
    ana = [{"t": 250.0 + rng.uniform(-5, 5, (6, ks, N, N)),
            "sphum": 1e-3 * (1 + 0.1 * rng.uniform(-1, 1, (6, ks, N, N))),
            "ua": rng.uniform(-10, 10, (6, ks, N, N)),
            "va": rng.uniform(-10, 10, (6, ks, N, N))} for _ in range(2)]
    jsch = jng.ObsSchedule([0.0, 3600.0], [both(a)[0] for a in ana])
    tsch = ng.ObsSchedule([0.0, 3600.0], [both(a)[1] for a in ana])
    for t in (-10.0, 1800.0, 5000.0):
        close_dicts(tsch.target_at(t), jsch.target_at(t),
                    f"ObsSchedule {t}")
    ps = 1.0e5 + 300.0 * rng.standard_normal((6, N, N))
    mid = tsch.target_at(1800.0)
    mp = jitted_jax_remaps()
    try:
        want = jng.remap_analysis_to_model(jsch.target_at(1800.0), aks, bks,
                                           ps, ak, bk)
    finally:
        mp.undo()
    got = ng.remap_analysis_to_model(mid, aks, bks, torch.as_tensor(ps), ak,
                                     bk)
    close_dicts(got, want, "remap_analysis_to_model")
    assert got["t"].shape == (6, K, N, N)
    with pytest.raises(ValueError):
        ng.ObsSchedule([0.0], [ana[0]])
