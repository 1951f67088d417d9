"""The PyTorch port's reductions, physics coupling, thermodynamics, Rayleigh
sponges and fixers against the JAX package (float64, CPU, C12L10, inputs
from numpy seeds):

- parallel/reductions.py: reproduce_sum, g_sum_reproducible, checksum and
  checksum_host equal to the JAX functions bit for bit, and reproduce_sum
  bit-identical under permutations of its input;
- model/fv_update_phys.py, model/thermodynamics.py and the two sponges of
  model/fv_dynamics.py (hydrostatic and nonhydrostatic forms), each output
  <= 1e-12 x its maximum;
- the big step with the fixers and the friction: test_torch_solo.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu.grid.fv_eta import set_eta
from gfdl_atmos_cubed_sphere_tpu.init.baroclinic import jw_baroclinic
from gfdl_atmos_cubed_sphere_tpu.model import fv_dynamics as jfvd
from gfdl_atmos_cubed_sphere_tpu.model import fv_update_phys as jfup
from gfdl_atmos_cubed_sphere_tpu.model import thermodynamics as jthermo
from gfdl_atmos_cubed_sphere_tpu.model.dyn_core import DynConfig as JCfg
from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops as jax_pack
from gfdl_atmos_cubed_sphere_tpu.model.sw_dynamics import prepare_phis as jphis
from gfdl_atmos_cubed_sphere_tpu.parallel import reductions as jred
from gfdl_atmos_cubed_sphere_tpu_torch.model import fv_dynamics as fvd
from gfdl_atmos_cubed_sphere_tpu_torch.model import fv_update_phys as fup
from gfdl_atmos_cubed_sphere_tpu_torch.model import thermodynamics as thermo
from gfdl_atmos_cubed_sphere_tpu_torch.model.dyn_core import DynConfig
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import build_grid_ops
from gfdl_atmos_cubed_sphere_tpu_torch.model.sw_dynamics import prepare_phis
from gfdl_atmos_cubed_sphere_tpu_torch.parallel import reductions as red

pytestmark = pytest.mark.fast

NPX, K = 13, 10
N = NPX - 1
TRACERS = ("sphum", "liq_wat", "rainwat", "ice_wat", "snowwat", "graupel")


def t64(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def close(got, want, tol, what):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(want).all(), what
    top = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * (top if top > 0 else 1.0), (what, err, top)


def test_reductions_equal_jax_and_order_invariant():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, 50_000) * 10.0 ** rng.integers(-6, 6, 50_000)
    s = red.reproduce_sum(torch.as_tensor(x))
    assert s.dtype == torch.float64
    assert float(s) == float(jred.reproduce_sum(jnp.asarray(x)))
    for seed in range(3):
        perm = np.random.default_rng(seed).permutation(x.size)
        assert float(red.reproduce_sum(torch.as_tensor(x[perm]))) == float(s)
    # float32 input is summed in float64, as the JAX function does
    x32 = x.astype(np.float32)
    assert (float(red.reproduce_sum(torch.as_tensor(x32)))
            == float(jred.reproduce_sum(jnp.asarray(x32))))
    assert float(red.reproduce_sum(torch.zeros(7))) == 0.0

    f = rng.normal(300, 10, (6, 12, 12))
    a = rng.uniform(0.5, 2.0, (6, 12, 12))
    for mean in (True, False):
        assert (float(red.g_sum_reproducible(torch.as_tensor(f),
                                             torch.as_tensor(a), mean=mean))
                == float(jred.g_sum_reproducible(jnp.asarray(f),
                                                 jnp.asarray(a), mean=mean)))
    for arr in (f, f.astype(np.float32), rng.integers(-9, 9, (5, 4))):
        want = int(jred.checksum(jnp.asarray(arr)))
        assert int(red.checksum(torch.as_tensor(arr))) == want
        assert red.checksum_host(arr) == jred.checksum_host(arr) == want


@pytest.fixture(scope="module")
def packs():
    gj = jax_pack(NPX, dtype=jnp.float64)
    gt = build_grid_ops(NPX, dtype=torch.float64, device="cpu")
    _, ptop, ak, bk = set_eta(K)
    ic = jw_baroclinic(gj.geom, K, ak, bk, ptop, perturb=True, moist=True)
    jphis(gj, ic["phis"])
    prepare_phis(gt, ic["phis"])
    return gj, gt, ptop, ak, bk, ic


def test_update_phys_thermodynamics_and_sponges(packs):
    gj, gt, ptop, ak, bk, ic = packs
    rng = np.random.default_rng(1)
    cell = (6, K, N, N)
    delp, pt, u, v = (np.asarray(ic[k]) for k in ("delp", "pt", "u", "v"))
    w = rng.normal(0.0, 0.5, cell)
    delz = np.asarray(ic["delz"])
    q = {nm: rng.uniform(0.0, 1e-4, cell) for nm in TRACERS}
    q["sphum"] = np.asarray(ic["sphum"])
    u_dt, v_dt, t_dt = (rng.normal(0.0, 1e-3, cell) for _ in range(3))
    q_dt = {"sphum": rng.normal(0.0, 1e-8, cell)}
    J = lambda a: jnp.asarray(a)
    Jq = lambda d: {k: J(a) for k, a in d.items()}
    Tq = lambda d: {k: t64(a) for k, a in d.items()}

    # physics coupling
    pairs = [("cubed_to_latlon", jfup.cubed_to_latlon(J(u), J(v), gj),
              fup.cubed_to_latlon(t64(u), t64(v), gt)),
             ("update_dwinds_phys",
              jfup.update_dwinds_phys(J(u), J(v), J(u_dt), J(v_dt), gj, 900.),
              fup.update_dwinds_phys(t64(u), t64(v), t64(u_dt), t64(v_dt),
                                     gt, 900.)),
             ("del2_phys", (jfup.del2_phys(J(t_dt), J(delp), gj, 0.2),),
              (fup.del2_phys(t64(t_dt), t64(delp), gt, 0.2),))]
    for cofac in (0.0, 0.15):
        want = jfup.fv_update_phys(900., J(pt), J(delp), J(u), J(v), Jq(q),
                                   J(u_dt), J(v_dt), J(t_dt), Jq(q_dt), gj,
                                   del2_cofac=cofac)
        got = fup.fv_update_phys(900., t64(pt), t64(delp), t64(u), t64(v),
                                 Tq(q), t64(u_dt), t64(v_dt), t64(t_dt),
                                 Tq(q_dt), gt, del2_cofac=cofac)
        pairs.append((f"fv_update_phys {cofac}", want[:3], got[:3]))
        for nm in TRACERS:
            close(got[3][nm], want[3][nm], 1e-12, f"fv_update_phys q {nm}")

    # thermodynamics
    pe = ptop + np.cumsum(delp, 1)
    pe = np.concatenate([np.full_like(pe[:, :1], ptop), pe], 1)
    peln = np.log(pe)
    pk = np.exp(0.2857 * peln)
    pkz = rng.uniform(2.0, 3.0, cell)
    phis = np.asarray(ic["phis"])
    te_h = (jthermo.total_energy_2d_hydro(J(u), J(v), J(pt), J(delp),
                                          J(peln), J(pe), J(phis), gj),
            thermo.total_energy_2d_hydro(t64(u), t64(v), t64(pt), t64(delp),
                                         t64(peln), t64(pe), t64(phis), gt))
    pairs += [("ke_cell", (jthermo.ke_cell(J(u), J(v), gj),),
               (thermo.ke_cell(t64(u), t64(v), gt),)),
              ("total_energy_2d_hydro", te_h[:1], te_h[1:])]
    for qs in (None, q["sphum"]):
        pairs.append((
            "total_energy_2d_nh",
            (jthermo.total_energy_2d_nh(J(u), J(v), J(w), J(pt),
                                        None if qs is None else J(qs),
                                        J(delp), J(delz), J(phis), gj),),
            (thermo.total_energy_2d_nh(t64(u), t64(v), t64(w), t64(pt),
                                       None if qs is None else t64(qs),
                                       t64(delp), t64(delz), t64(phis),
                                       gt),)))
    for nwat in (0, 2, 3, 4, 5, 6):
        for fn, jfn in ((thermo.moist_cv, jthermo.moist_cv),
                        (thermo.moist_cp, jthermo.moist_cp)):
            pairs.append((f"{fn.__name__} nwat {nwat}",
                          tuple(np.broadcast_to(np.asarray(x), cell)
                                for x in jfn(Jq(q), nwat)),
                          tuple(torch.broadcast_to(torch.as_tensor(x,
                                dtype=torch.float64), cell)
                                for x in fn(Tq(q), nwat))))
    pairs.append(("compute_aam",
                  jthermo.compute_aam(J(u), J(v), J(delp), gj, ptop),
                  thermo.compute_aam(t64(u), t64(v), t64(delp), gt, ptop)))
    aam0 = np.asarray(jthermo.compute_aam(J(u), J(v), J(delp), gj, ptop)[0])
    u2, v2 = u * 1.001 + 0.01, v * 0.999
    te1 = np.asarray(te_h[0]) * (1.0 - 1e-6)
    for rep in (False, True):
        assert float(thermo.g_mean(t64(te1), gt, reproduce=rep)) == (
            pytest.approx(float(jthermo.g_mean(J(te1), gj, reproduce=rep)),
                          rel=1e-13))
        pairs.append((f"am_fixer {rep}",
                      jthermo.am_fixer(J(u2), J(v2), J(delp), J(aam0), gj,
                                       ptop, reproduce=rep),
                      thermo.am_fixer(t64(u2), t64(v2), t64(delp),
                                      t64(aam0), gt, ptop, reproduce=rep)))
        for hyd in (True, False):
            pairs.append((
                f"energy_fixer_dtmp {rep} {hyd}",
                (jthermo.energy_fixer_dtmp(J(te_h[0]), J(te1), J(pkz),
                                           J(delp), J(pk), ptop, 1.0, gj,
                                           hydrostatic=hyd, reproduce=rep),),
                (thermo.energy_fixer_dtmp(te_h[1], t64(te1), t64(pkz),
                                          t64(delp), t64(pk), ptop, 1.0, gt,
                                          hydrostatic=hyd, reproduce=rep),)))

    # the sponges, with the cutoff below ptop = 500 hPa of set_eta(10) so
    # that the upper levels are damped
    cfg = dict(npx=NPX, npz=K, dt=900.0, tau=2.0, rf_cutoff=8.0e4)
    ucur, vcur = u + rng.normal(0, 2.0, u.shape), v + rng.normal(0, 2.0,
                                                                 v.shape)
    pairs.append(("rayleigh_super",
                  jfvd.rayleigh_super(J(ucur), J(vcur), J(w), J(u), J(v),
                                      J(ak), J(bk), JCfg(**cfg), ptop),
                  fvd.rayleigh_super(t64(ucur), t64(vcur), t64(w), t64(u),
                                     t64(v), ak, bk, DynConfig(**cfg),
                                     ptop)))
    pm = ((ak[1:] + ak[:-1]) + (bk[1:] + bk[:-1]) * 1.0e5) * 0.5
    for hyd in (True, False):
        want = jfvd.rayleigh_friction(J(ucur), J(vcur), J(w), J(pt),
                                      J(delz), pm, JCfg(**cfg), ptop, gj,
                                      hydrostatic=hyd)
        got = fvd.rayleigh_friction(t64(ucur), t64(vcur), t64(w), t64(pt),
                                    t64(delz), pm, DynConfig(**cfg), ptop,
                                    gt, hydrostatic=hyd)
        pairs.append((f"rayleigh_friction {hyd}", want, got))
        assert not np.allclose(np.asarray(want[0]), ucur, rtol=1e-6)

    for what, want, got in pairs:
        assert len(want) == len(got), what
        for i, (a, b) in enumerate(zip(want, got)):
            close(b, a, 1e-12, f"{what} [{i}]")
