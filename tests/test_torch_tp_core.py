"""The PyTorch port's PPM transport (ops/tp_core.py, ops/tp_sweep.py)
against the JAX package (float64, CPU, inputs from a numpy seed).

On the CPU the JAX fv_tp_2d takes its XLA double sweep and the port its
plain version, tp2d_sweep_ref; the port's kernel launch counter stays 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops as jax_pack
from gfdl_atmos_cubed_sphere_tpu.ops import tp_core as jtp
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import build_grid_ops
from gfdl_atmos_cubed_sphere_tpu_torch.ops import tp_core as ttp
from gfdl_atmos_cubed_sphere_tpu_torch.ops import tp_sweep

pytestmark = pytest.mark.fast

NPX = 13
N = NPX - 1
H = 3
P = N + 2 * H
W = N + 1
K = 2
TOL = 1e-12


@pytest.fixture(scope="module")
def case():
    gj = jax_pack(NPX, dtype=jnp.float64)
    gt = build_grid_ops(NPX, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(11)
    q = 1.0 + 0.5 * rng.standard_normal((6, K, N, N))
    c = dict(
        q=np.array(gj.halo.pad_cell(jnp.asarray(q))),
        crx=rng.uniform(-0.6, 0.6, (6, K, P, W)),
        cry=rng.uniform(-0.6, 0.6, (6, K, W, P)),
        mfx=rng.standard_normal((6, K, N, W)),
        mfy=rng.standard_normal((6, K, W, N)))
    area = np.asarray(gj.area)
    c["xfx"] = c["crx"] * 2.0e9
    c["yfx"] = c["cry"] * 2.0e9
    c["ra_x"] = (area[..., :, H:H + N] + c["xfx"][..., :, :-1]
                 - c["xfx"][..., :, 1:])
    c["ra_y"] = (area[..., H:H + N, :] + c["yfx"][..., :-1, :]
                 - c["yfx"][..., 1:, :])
    return gj, gt, c


def _close(want, got, tol=TOL):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


@pytest.mark.parametrize("iord", [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12,
                                  13, -5])
@pytest.mark.parametrize("axis", [-1, -2])
def test_xppm_families(case, iord, axis):
    gj, gt, c = case
    if axis == -1:
        cr, dxa = c["crx"], "dxa"
    else:
        cr, dxa = c["cry"], "dya"
    want = jtp.xppm(jnp.asarray(c["q"]), jnp.asarray(cr), getattr(gj, dxa),
                    iord, 1.0, True, axis)
    got = ttp.xppm(torch.as_tensor(c["q"]), torch.as_tensor(cr),
                   getattr(gt, dxa), iord, 1.0, axis=axis)
    _close(want, got)


@pytest.mark.parametrize("iord", [5, 6, 8, 10])
def test_yppm(case, iord):
    gj, gt, c = case
    want = jtp.yppm(jnp.asarray(c["q"]), jnp.asarray(c["cry"]), gj.dya, iord)
    got = ttp.yppm(torch.as_tensor(c["q"]), torch.as_tensor(c["cry"]),
                   gt.dya, iord)
    _close(want, got)


def _tp(mod, gp, c, hord, conv, **kw):
    a = {k: conv(v) for k, v in c.items()}
    return mod.fv_tp_2d(a["q"], a["crx"], a["cry"], hord, a["xfx"], a["yfx"],
                        gp.area, a["ra_x"], a["ra_y"], gp.dxa, gp.dya, **kw)


@pytest.mark.parametrize("hord", [5, 6, 8, 10])
@pytest.mark.parametrize("mass_flux", [False, True])
def test_fv_tp_2d(case, hord, mass_flux):
    gj, gt, c = case
    tp_sweep.reset_launches()
    kj, kt = {}, {}
    if mass_flux:
        kj = dict(mfx=jnp.asarray(c["mfx"]), mfy=jnp.asarray(c["mfy"]))
        kt = dict(mfx=torch.as_tensor(c["mfx"]), mfy=torch.as_tensor(c["mfy"]))
    want = _tp(jtp, gj, c, hord, jnp.asarray, **kj)
    got = _tp(ttp, gt, c, hord, torch.as_tensor, **kt)
    for w, g in zip(want, got):
        _close(w, g)
    assert tp_sweep.launches == 0


@pytest.mark.parametrize("nord,mass", [(0, False), (1, False), (2, True)])
def test_fv_tp_2d_deln_damping(case, nord, mass):
    """fv_tp_2d with the del-n damping fluxes (deln_flux_add)."""
    gj, gt, c = case
    kj = dict(nord=nord, damp_c=0.12, g=gj,
              mass=gj.halo.pad_cell(jnp.asarray(c["q"][..., H:-H, H:-H]))
              if mass else None)
    kt = dict(nord=nord, damp_c=0.12, g=gt,
              mass=torch.as_tensor(np.asarray(kj["mass"])) if mass else None)
    want = _tp(jtp, gj, c, 6, jnp.asarray, **kj)
    got = _tp(ttp, gt, c, 6, torch.as_tensor, **kt)
    for w, g in zip(want, got):
        _close(w, g)


def test_tp2d_sweep_ref_matches_fv_tp_2d(case):
    """The plain version of the kernel is fv_tp_2d's double sweep on the
    compute-wall operands."""
    _, gt, c = case
    a = {k: torch.as_tensor(v) for k, v in c.items()}
    want = ttp.fv_tp_2d(a["q"], a["crx"], a["cry"], 8, a["xfx"], a["yfx"],
                        gt.area, a["ra_x"], a["ra_y"], gt.dxa, gt.dya)
    got = tp_sweep.tp2d_sweep_ref(a["q"], a["crx"], a["cry"], 8, a["xfx"],
                                  a["yfx"], gt.area, a["ra_x"], a["ra_y"],
                                  gt.dxa, gt.dya)
    for w, g in zip(want, got):
        assert torch.equal(w, g)

