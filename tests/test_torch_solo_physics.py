"""The PyTorch port's solo-driver physics against the JAX package (float64,
CPU, C12, inputs from numpy seeds, each output <= 1e-12 x its maximum):

- physics/held_suarez.py hs_forcing, with the stratosphere extension off
  and on (on the 32 levels of set_eta(32), whose top is at 1 hPa);
- physics/sim_phys.py: gray_radiation (with and without the diurnal
  cycle), ocean_roughness, bulk_surface_drag (Charnock and fixed cd),
  pbl_height, k_profile, implicit_diffusion, sim_phys (with and without
  vapour) and fv_nudge; and two steps of the solo driver with
  physics="sim" and no_dycore (the physics-only mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gfdl_atmos_cubed_sphere_tpu.constants as jcon
from gfdl_atmos_cubed_sphere_tpu.driver.solo import Atmosphere as JAtm
from gfdl_atmos_cubed_sphere_tpu.grid.fv_eta import set_eta
from gfdl_atmos_cubed_sphere_tpu.init.baroclinic import jw_baroclinic
from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops as jax_pack
from gfdl_atmos_cubed_sphere_tpu.physics import held_suarez as jhs
from gfdl_atmos_cubed_sphere_tpu.physics import sim_phys as jsp
from gfdl_atmos_cubed_sphere_tpu_torch.driver.solo import Atmosphere
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import build_grid_ops
from gfdl_atmos_cubed_sphere_tpu_torch.physics import held_suarez as hs
from gfdl_atmos_cubed_sphere_tpu_torch.physics import sim_phys as sp

pytestmark = pytest.mark.fast

NPX = 13
N = NPX - 1


def t64(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def close(got, want, tol, what):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(want).all(), what
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * (top if top > 0 else 1.0), (
        what, np.abs(got - want).max(), top)


def _setup(K, moist=False):
    gj = jax_pack(NPX, dtype=jnp.float64)
    gt = build_grid_ops(NPX, dtype=torch.float64, device="cpu")
    _, ptop, ak, bk = set_eta(K)
    ic = jw_baroclinic(gj.geom, K, ak, bk, ptop, moist=moist)
    return gj, gt, ptop, ic


def test_hs_forcing():
    gj, gt, ptop, ic = _setup(32)
    rng = np.random.default_rng(3)
    pt = np.asarray(ic["pt"]) + rng.normal(0.0, 1.0, ic["pt"].shape)
    delp, u, v = (np.asarray(ic[k]) for k in ("delp", "u", "v"))
    outs = {}
    for strat in (False, True):
        want = jhs.hs_forcing(jnp.asarray(pt), jnp.asarray(delp),
                              jnp.asarray(u), jnp.asarray(v), gj, ptop,
                              1800.0, strat=strat)
        got = hs.hs_forcing(t64(pt), t64(delp), t64(u), t64(v), gt, ptop,
                            1800.0, strat=strat)
        for i, (a, b) in enumerate(zip(want, got)):
            close(b, a, 1e-12, f"hs_forcing strat={strat} [{i}]")
        outs[strat] = np.asarray(want[0])
    # the stratosphere branch is taken
    assert np.abs(outs[True] - outs[False]).max() > 1e-3


def test_sim_phys_and_nudge():
    K = 16
    gj, gt, ptop, ic = _setup(K, moist=True)
    pt, delp = np.asarray(ic["pt"]), np.asarray(ic["delp"])
    delz = -jcon.RDGAS * pt / jcon.GRAV * np.log(
        1.0 + delp / (ptop + np.cumsum(delp, 1) - delp))
    rng = np.random.default_rng(4)
    cell = pt.shape
    ua = rng.normal(5.0, 8.0, cell)
    va = rng.normal(0.0, 8.0, cell)
    qv = np.asarray(ic["sphum"])
    ts = pt[:, -1] + 1.0
    lat = gj.geom.interior("aglat")
    lon = gj.geom.interior("aglon")
    ps = ptop + delp.sum(1)
    pm = ptop + np.cumsum(delp, 1) - 0.5 * delp
    J, T = jnp.asarray, t64
    pairs = []
    for dc in (False, True):
        jc, tc = jsp.SimPhysConfig(diurnal_cycle=dc), sp.SimPhysConfig(
            diurnal_cycle=dc)
        wt, wd = jsp.gray_radiation(J(pt), J(ts), J(delp), J(delz), J(lat),
                                    J(lon), J(ps), ptop, jc, sec=3600.0)
        gt_, gd = sp.gray_radiation(T(pt), T(ts), T(delp), T(delz), T(lat),
                                    T(lon), T(ps), ptop, tc, sec=3600.0)
        pairs.append((f"gray_radiation {dc}", [wt] + [wd[k] for k in wd],
                      [gt_] + [gd[k] for k in wd]))
    ustar = np.abs(rng.normal(0.3, 0.1, ts.shape))
    pairs.append(("ocean_roughness",
                  [jsp.ocean_roughness(J(ustar), jsp.SimPhysConfig())],
                  [sp.ocean_roughness(T(ustar), sp.SimPhysConfig())]))
    z_bot = -0.5 * delz[:, -1]
    for cdf in (0.0, 1.2e-3):
        pairs.append((f"bulk_surface_drag {cdf}",
                      jsp.bulk_surface_drag(
                          J(ua[:, -1]), J(va[:, -1]), J(pt[:, -1] - 2.0),
                          J(ts), J(z_bot), cfg=jsp.SimPhysConfig(
                              cd_fixed=cdf)),
                      sp.bulk_surface_drag(
                          T(ua[:, -1]), T(va[:, -1]), T(pt[:, -1] - 2.0),
                          T(ts), T(z_bot), cfg=sp.SimPhysConfig(
                              cd_fixed=cdf))))
    for q in (None, qv):
        pairs.append((f"pbl_height {q is None}",
                      [jsp.pbl_height(J(ua), J(va), J(pt), None if q is None
                                      else J(q), J(ts), J(delz), J(ps),
                                      J(pm), jsp.SimPhysConfig())],
                      [sp.pbl_height(T(ua), T(va), T(pt), None if q is None
                                     else T(q), T(ts), T(delz), T(ps),
                                     T(pm), sp.SimPhysConfig())]))
    gh_mid = rng.uniform(10.0, 8000.0, cell)
    pblh = rng.uniform(-10.0, 3000.0, ts.shape)
    mu = rng.uniform(0.01, 0.3, ts.shape)
    pairs.append(("k_profile",
                  [jsp.k_profile(J(gh_mid), J(pblh), J(mu),
                                 jsp.SimPhysConfig())],
                  [sp.k_profile(T(gh_mid), T(pblh), T(mu),
                                sp.SimPhysConfig())]))
    nu_int = rng.uniform(0.0, 50.0, (6, K - 1, N, N))
    pairs.append(("implicit_diffusion",
                  [jsp.implicit_diffusion(J(ua), J(nu_int), J(delz),
                                          J(delp), 1800.0)],
                  [sp.implicit_diffusion(T(ua), T(nu_int), T(delz), T(delp),
                                         1800.0)]))
    for q in (None, qv):
        want = jsp.sim_phys(J(ua), J(va), J(pt), None if q is None else J(q),
                            J(delp), J(delz), J(ts), gj, ptop, 1800.0)
        got = sp.sim_phys(T(ua), T(va), T(pt), None if q is None else T(q),
                          T(delp), T(delz), T(ts), gt, ptop, 1800.0)
        keys = sorted(want[4])
        pairs.append((f"sim_phys {q is None}",
                      [x for x in want[:4] if x is not None]
                      + [want[4][k] for k in keys],
                      [x for x in got[:4] if x is not None]
                      + [got[4][k] for k in keys]))
    pairs.append(("fv_nudge",
                  jsp.fv_nudge(J(ua), J(va), J(pt), J(va), J(ua), J(pt + 1.0),
                               900.0),
                  sp.fv_nudge(T(ua), T(va), T(pt), T(va), T(ua), T(pt + 1.0),
                              900.0)))
    for what, want, got in pairs:
        assert len(want) == len(got), what
        for i, (a, b) in enumerate(zip(want, got)):
            close(b, a, 1e-12, f"{what} [{i}]")

    # the solo driver's simple-physics step, physics only (no_dycore):
    # the A-grid winds, sim_phys and the D-grid scatter of its tendencies
    kw = dict(physics="sim", dtype="f64", cfg_overrides=dict(no_dycore=True))
    ja = JAtm(NPX, 10, 600.0, **kw)
    ta = Atmosphere(NPX, 10, 600.0, device="cpu", **kw)
    pt0 = ta.state["pt"].clone()
    ja.atmosphere(2)
    ta.atmosphere(2)
    for k in ("delp", "pt", "u", "v", "w", "delz"):
        close(ta.state[k], ja.state[k], 1e-12, f"solo sim physics {k}")
    assert float((ta.state["pt"] - pt0).abs().max()) > 1e-3
