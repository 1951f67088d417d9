"""The PyTorch port's nonhydrostatic column solvers and height advection
(ops/nh_core.py, ops/sim1.py) against the JAX package: sim1_solver,
riem_solver_c, riem_solver3, update_dz_c and update_dz_d on a perturbed dry
Jablonowski-Williamson state at C12L10 (float64, CPU, <= 1e-12 x max|ref|).

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


def _close(want, got, what):
    want = np.asarray(want)
    got = got.numpy()
    fin = np.isfinite(want)
    assert fin.any(), what
    assert np.array_equal(fin, np.isfinite(got)), what
    err = np.abs(np.where(fin, got - want, 0.0)).max()
    assert err <= TOL * np.abs(np.where(fin, want, 0.0)).max(), (what, err)


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


def _kernel_ring():
    src = (Path(sim1.__file__).parents[1] / "csrc" / "sim1.cu").read_text()
    d = re.search(r"constexpr int D = (\d+);", src)
    nf = re.search(r"constexpr int NF = (\d+);", src)
    return int(d.group(1)), int(nf.group(1))


def test_sim1_launch_plan_matches_the_kernel():
    assert _kernel_ring() == (sim1.RING_LEVELS, sim1.RING_FIELDS)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_sim1_launch_plan(itemsize):
    """Every column is owned by exactly one thread of one block, and a
    block's shared memory (gam and pp, 2 (K + 1) values per column, and
    the ring) fits the card (232,448 bytes), C12 to C768, up to 319
    levels."""
    for n in (12, 24, 192, 768):
        ncol = 6 * (n + 2 * H) ** 2
        for K in (3, 10, 79, 160, 319):
            nt, blocks, smem = sim1.launch_plan(ncol, K, itemsize)
            assert nt in (32, 64, 128, 256)
            assert (blocks - 1) * nt < ncol <= blocks * nt
            per_col = 2 * (K + 1) + sim1.RING_LEVELS * sim1.RING_FIELDS
            assert smem == nt * per_col * itemsize <= 232448
