"""The PyTorch port's nonhydrostatic column solvers and height advection
(ops/nh_core.py, ops/sim1.py) against the JAX package: sim1_solver (alpha
1 and the off-centred 0.75), sim3_solver (SIM3p0 and SIM3 at 0.75 with
scale_m), rim_2d_solver (c_core both ways, with and without the thick-top
pre-pass), imp_diff_w, riem_solver_c and riem_solver3 (SIM1, and at a_imp
0.75, 0.4, -0.75 and -1 with use_logp and d2bg_zq), update_dz_c and
update_dz_d on a perturbed dry Jablonowski-Williamson state at C12L10
(float64, CPU, <= 1e-12 x max|ref|).

On the CPU the JAX package takes its XLA formulation and the port the plain
versions of its kernels; the kernel launch counters stay 0."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu import constants as con
from gfdl_atmos_cubed_sphere_tpu.grid.fv_eta import set_eta
from gfdl_atmos_cubed_sphere_tpu.init.baroclinic import jw_baroclinic
from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops as jax_pack
from gfdl_atmos_cubed_sphere_tpu.ops import nh_core as jnh
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import build_grid_ops
from gfdl_atmos_cubed_sphere_tpu_torch.ops import nh_core as tnh
from gfdl_atmos_cubed_sphere_tpu_torch.ops import sim1, tp_sweep

pytestmark = pytest.mark.fast

NPX, K = 13, 10
N = NPX - 1
H = 3
TOL = 1e-12
# w and the pressure perturbation of RIM_2D and of the dispatchers at a
# 10 s step carry the difference of two ~1e5 Pa pressures (the gas-law
# pressure less the layer mean): 1-ulp changes of exp and log, which XLA
# and PyTorch round apart on some 20 % of the elements, move them by up to
# 1.5e-11 of their maxima, every other output by under 1e-12 (`python
# devtools/nh_w_conditioning.py --solvers`)
COND_TOL = 1e-10
DT = 1800.0
AKAP = con.KAPPA
GAMA = 1.0 / (1.0 - AKAP)
P_FAC = 0.05


@pytest.fixture(scope="module")
def case():
    gj = jax_pack(NPX, dtype=jnp.float64)
    gt = build_grid_ops(NPX, dtype=torch.float64, device="cpu")
    _, ptop, ak, bk = set_eta(K)
    ic = jw_baroclinic(gj.geom, K, ak, bk, ptop, perturb=True, moist=False)
    rng = np.random.default_rng(31)
    rrg = -con.RDGAS / con.GRAV
    pkz = np.exp(AKAP * np.log(rrg * ic["delp"] / ic["delz"] * ic["pt"]))
    c = dict(delp=ic["delp"], ptv=ic["pt"] / pkz,
             w=0.05 * rng.standard_normal(ic["delp"].shape),
             delz=ic["delz"] * (1.0 + 1e-3 * rng.standard_normal(
                 ic["delz"].shape)))
    zs = ic["phis"][:, 0] / con.GRAV
    incr = np.cumsum(c["delz"][:, ::-1], axis=1)[:, ::-1]
    c["zh"] = np.concatenate([zs[:, None] - incr, zs[:, None]], axis=1)
    c["ws"] = 0.01 * rng.standard_normal(zs.shape)
    pad = lambda a: np.array(gj.halo.pad_cell(jnp.asarray(a)))
    c["zh_p"] = pad(c["zh"])
    c["zs_p"] = pad(zs)
    area = float(np.mean(np.asarray(gj.area)[:, 0, H:-H, H:-H]))
    P, W = N + 2 * H, N + 1 + 2 * H
    c["ut"] = 0.02 * area * rng.standard_normal((6, K, P, W))
    c["vt"] = 0.02 * area * rng.standard_normal((6, K, W, P))
    c["crx"] = 0.2 * rng.standard_normal((6, K, P, W))
    c["cry"] = 0.2 * rng.standard_normal((6, K, W, P))
    c["dp0"] = np.diff(ak) + np.diff(bk) * 1.0e5
    c["ptop"] = ptop
    return gj, gt, c


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(want, got, what, tol=TOL):
    want = np.asarray(want)
    got = got.numpy()
    fin = np.isfinite(want)
    assert fin.any(), what
    assert np.array_equal(fin, np.isfinite(got)), what
    err = np.abs(np.where(fin, got - want, 0.0)).max()
    assert err <= tol * np.abs(np.where(fin, want, 0.0)).max(), (what, err)


def _reset():
    sim1.reset_launches()
    tp_sweep.reset_launches()


def _launched():
    return (sim1.launches, tp_sweep.launches)


def _columns(c):
    """sim1 inputs from the state: dm, pm, pem, w, dz, pt, ws."""
    delp = c["delp"]
    pem = c["ptop"] + np.concatenate(
        [np.zeros_like(delp[:, :1]), np.cumsum(delp, axis=1)], axis=1)
    pm2 = delp / (np.log(pem[:, 1:]) - np.log(pem[:, :-1]))
    return (delp / con.GRAV, pm2, pem, c["w"], c["delz"], c["ptv"], c["ws"])


def test_sim1_solver(case):
    _, _, c = case
    cols = _columns(c)
    want = jax.jit(lambda *a: jnh.sim1_solver(DT, *a, GAMA, AKAP, P_FAC))(
        *map(jnp.asarray, cols))
    _reset()
    got = sim1.sim1(DT, *map(_t, cols), GAMA, AKAP, P_FAC)
    assert _launched() == (0, 0)
    for nm, a, b in zip(("pe2", "w2", "dz2"), want, got):
        _close(a, b, nm)


def test_sim1_solver_offcentred(case):
    """The off-centred SIM (alpha = 0.75) through the wrapper's plain
    version, and alpha = 1 passed explicitly equals the default bit for
    bit."""
    _, _, c = case
    cols = _columns(c)
    want = jax.jit(lambda *a: jnh.sim1_solver(DT, *a, GAMA, AKAP, P_FAC,
                                              alpha=0.75))(
        *map(jnp.asarray, cols))
    _reset()
    got = sim1.sim1(DT, *map(_t, cols), GAMA, AKAP, P_FAC, alpha=0.75)
    one = tnh.sim1_solver(DT, *map(_t, cols), GAMA, AKAP, P_FAC, alpha=1.0)
    ref = tnh.sim1_solver(DT, *map(_t, cols), GAMA, AKAP, P_FAC)
    assert _launched() == (0, 0)
    for nm, a, b in zip(("pe2", "w2", "dz2"), want, got):
        _close(a, b, nm)
    assert all(torch.equal(a, b) for a, b in zip(one, ref))


def test_rim_2d_solver(case):
    """RIM_2D at one substep (no thick-top pre-pass; the dispatch test
    below runs 4 with it, c_core both ways): a 2 s step puts some levels'
    acoustic transit times under it and some over it."""
    _, _, c = case
    dm, pm2, _, w, dz, pt, ws = _columns(c)
    args = (dm, pm2, w, dz, pt, ws)
    want = jax.jit(lambda *a: jnh.rim_2d_solver(1, 2.0, *a, GAMA, AKAP))(
        *map(jnp.asarray, args))
    got = tnh.rim_2d_solver(1, 2.0, *map(_t, args), GAMA, AKAP)
    for nm, a, b in zip(("pe2", "w2", "dz2"), want, got):
        _close(a, b, nm, COND_TOL if nm != "dz2" else TOL)


def test_imp_diff_w(case):
    _, _, c = case
    args = (c["delz"], c["ws"], c["w"])
    want = jax.jit(lambda *a: jnh.imp_diff_w(0.01 * DT, *a))(
        *map(jnp.asarray, args))
    _close(want, tnh.imp_diff_w(0.01 * DT, *map(_t, args)), "w")


def test_riem_solver_c(case):
    _, _, c = case
    ptop = c["ptop"]
    args = (c["delp"], c["ptv"], c["w"], c["zh"], c["zh"][:, -1] * con.GRAV,
            c["ws"])
    want = jax.jit(lambda *a: jnh.riem_solver_c(
        0.5 * DT, *a, AKAP, ptop, P_FAC))(*map(jnp.asarray, args))
    _reset()
    got = tnh.riem_solver_c(0.5 * DT, *map(_t, args), AKAP, ptop, P_FAC)
    assert _launched() == (0, 0)
    for nm, a, b in zip(("pef", "gz"), want, got):
        _close(a, b, nm)


def test_riem_solver3(case):
    _, _, c = case
    ptop = c["ptop"]
    zs = c["zh"][:, -1]
    args = (c["delp"], c["ptv"], c["w"], c["zh"], zs, c["ws"])
    names = ("w", "delz", "zh", "ppe", "pem", "peln", "pk3")
    want = jax.jit(lambda *a: tuple(
        getattr(jnh.riem_solver3(DT, *a, AKAP, ptop, P_FAC), nm)
        for nm in names))(*map(jnp.asarray, args))
    _reset()
    got = tnh.riem_solver3(DT, *map(_t, args), AKAP, ptop, P_FAC)
    assert _launched() == (0, 0)
    for nm, a in zip(names, want):
        _close(a, getattr(got, nm), nm)


# the a_imp of each solver the dispatchers pick (riem_solver_c: SIM1, RIM_2D
# with w frozen, SIM3p0, SIM3p0; riem_solver3: the off-centred SIM, RIM_2D,
# SIM3 at 0.75, SIM3p0), at a 10 s step with 4 RIM_2D substeps (the
# thick-top pre-pass on), SIM3's scale_m and the w diffusion d2bg_zq
A_IMPS = (0.75, 0.4, -0.75, -1.0)
SOLVER_DT, SOLVER_MS = 10.0, 4


@pytest.mark.parametrize("a_imp", A_IMPS)
def test_riem_solvers_dispatch(case, a_imp):
    """riem_solver_c (SIM1 at alpha = 1, RIM_2D with w frozen, SIM3p0) and
    riem_solver3 (the off-centred SIM, RIM_2D, SIM3, SIM3p0) at each a_imp,
    riem_solver3 with use_logp and d2bg_zq."""
    _, _, c = case
    ptop = c["ptop"]
    zs = c["zh"][:, -1]
    args = (c["delp"], c["ptv"], c["w"], c["zh"], zs, c["ws"])
    names = ("w", "delz", "zh", "ppe", "pem", "peln", "pk3")
    kw = dict(use_logp=True, a_imp=a_imp, scale_m=0.1, d2bg_zq=0.01,
              ms=SOLVER_MS)

    def jax_solvers(delp, pt, w, zh, zs, ws):
        cs = jnh.riem_solver_c(0.5 * SOLVER_DT, delp, pt, w, zh,
                               zs * con.GRAV, ws, AKAP, ptop, P_FAC,
                               a_imp=a_imp, ms=SOLVER_MS)
        r3 = jnh.riem_solver3(SOLVER_DT, delp, pt, w, zh, zs, ws, AKAP, ptop,
                              P_FAC, **kw)
        return cs, tuple(getattr(r3, nm) for nm in names)

    want_c, want = jax.jit(jax_solvers)(*map(jnp.asarray, args))
    delp, pt, w, zh, zs_t, ws = map(_t, args)
    _reset()
    got = tnh.riem_solver_c(0.5 * SOLVER_DT, delp, pt, w, zh,
                            zs_t * con.GRAV, ws, AKAP, ptop, P_FAC,
                            a_imp=a_imp, ms=SOLVER_MS)
    for nm, a, b in zip(("pef", "gz"), want_c, got):
        _close(a, b, f"C {nm}")
    got = tnh.riem_solver3(SOLVER_DT, delp, pt, w, zh, zs_t, ws, AKAP, ptop,
                           P_FAC, **kw)
    assert _launched() == (0, 0)
    for nm, a in zip(names, want):
        _close(a, getattr(got, nm), nm,
               COND_TOL if nm in ("w", "ppe") else TOL)


def test_update_dz_c(case):
    gj, gt, c = case
    args = (c["ut"], c["vt"], c["zh_p"], c["zs_p"])
    want = jax.jit(lambda *a: jnh.update_dz_c(
        gj, *a, c["dp0"], 0.5 * DT, NPX))(*map(jnp.asarray, args))
    got = tnh.update_dz_c(gt, *map(_t, args), c["dp0"], 0.5 * DT, NPX)
    for nm, a, b in zip(("gz", "ws"), want, got):
        _close(a, b, nm)


def test_update_dz_d(case):
    gj, gt, c = case
    args = (c["zh_p"], c["crx"], c["cry"], c["ut"], c["vt"],
            c["zs_p"][:, H:-H, H:-H])
    want = jax.jit(lambda *a: jnh.update_dz_d(
        gj, a[0], a[1], a[2], a[3], a[4], a[5], c["dp0"], DT, 10, NPX,
        0.02, 1))(*map(jnp.asarray, args))
    _reset()
    got = tnh.update_dz_d(gt, *map(_t, args), c["dp0"], DT, 10, NPX, 0.02, 1)
    assert _launched() == (0, 0)
    for nm, a, b in zip(("zh", "ws"), want, got):
        _close(a, b, nm)


def _kernel_source():
    return (Path(sim1.__file__).parents[1] / "csrc" / "sim1.cu").read_text()


def _kernel_ring():
    src = _kernel_source()
    d = re.search(r"constexpr int D = (\d+);", src)
    nf = re.search(r"constexpr int NF = (\d+);", src)
    return int(d.group(1)), int(nf.group(1))


def test_sim1_launch_plan_matches_the_kernel():
    """The ring, and the (K + 1)-value arrays a column keeps in each form
    (csrc/sim1.cu n_arrays: off-centred ? 3 : 2), as the plan counts
    them."""
    assert _kernel_ring() == (sim1.RING_LEVELS, sim1.RING_FIELDS)
    offc, full = map(int, re.search(r"return offc \? (\d) : (\d);",
                                    _kernel_source()).groups())
    ring = sim1.RING_LEVELS * sim1.RING_FIELDS
    for form, arrays in ((True, offc), (False, full)):
        nt, _, smem = sim1.launch_plan(1000, 10, 4, form)
        assert smem == nt * 4 * (arrays * 11 + ring)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_sim1_launch_plan(itemsize):
    """Every column is owned by exactly one thread of one block, and a
    block's shared memory (gam and pp, 2 (K + 1) values per column, and
    the ring) fits the card (232,448 bytes), C12 to C768, up to 319
    levels; the off-centred form (a third array, w) up to 291 levels, and
    the plan refuses more."""
    for n in (12, 24, 192, 768):
        ncol = 6 * (n + 2 * H) ** 2
        for K in (3, 10, 79, 160, 291, 319):
            for offc, arrays in ((False, 2), (True, 3)):
                if offc and K > 291 and itemsize == 8:
                    with pytest.raises(ValueError, match="shared memory"):
                        sim1.launch_plan(ncol, K, itemsize, offc)
                    continue
                nt, blocks, smem = sim1.launch_plan(ncol, K, itemsize, offc)
                assert nt in (32, 64, 128, 256)
                assert (blocks - 1) * nt < ncol <= blocks * nt
                per_col = (arrays * (K + 1)
                           + sim1.RING_LEVELS * sim1.RING_FIELDS)
                assert smem == nt * per_col * itemsize <= 232448
