"""Shared inputs of the tests that hold the port's diagnostics, facades and
leaf modules against the JAX package (float64, CPU, C12L10): both grid
packs on the same metrics, and a perturbed moist Jablonowski-Williamson
state with seeded noise and six seeded GFDL-MP tracers, as numpy."""

import numpy as np
import torch

NPX, K = 13, 10


def packs():
    """(JAX pack, port pack on the CPU, ptop, ak, bk, the moist JW initial
    state) at C12L10."""
    import jax.numpy as jnp
    from gfdl_atmos_cubed_sphere_tpu.grid.fv_eta import set_eta
    from gfdl_atmos_cubed_sphere_tpu.init.baroclinic import jw_baroclinic
    from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops \
        as jax_pack
    from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import (
        build_grid_ops)
    gj = jax_pack(NPX, dtype=jnp.float64)
    gt = build_grid_ops(NPX, dtype=torch.float64, device="cpu")
    _, ptop, ak, bk = set_eta(K)
    ic = jw_baroclinic(gj.geom, K, ak, bk, ptop, perturb=True, moist=True)
    return gj, gt, ptop, np.asarray(ak), np.asarray(bk), ic


def seeded_state(ic, seed=0):
    """The JW state with seeded noise on pt, u, v, a seeded w, and six
    seeded tracers (sphum from the wave plus noise, the condensates up to
    a few 1e-4 kg/kg, rain and snow up to 3e-3 so that reflectivity
    passes its thresholds somewhere): (state, q) dicts of numpy."""
    rng = np.random.default_rng(seed)
    st = {k: np.array(ic[k], dtype=np.float64)
          for k in ("delp", "pt", "u", "v", "w", "delz", "phis")}
    cell = st["pt"].shape
    st["pt"] += rng.normal(0.0, 0.5, cell)
    st["u"] += rng.normal(0.0, 1.0, st["u"].shape)
    st["v"] += rng.normal(0.0, 1.0, st["v"].shape)
    st["w"] = rng.normal(0.0, 0.5, cell)
    q = {"sphum": np.asarray(ic["sphum"]) * rng.uniform(0.9, 1.1, cell)}
    for nm, top in (("liq_wat", 3e-4), ("rainwat", 3e-3), ("ice_wat", 2e-4),
                    ("snowwat", 3e-3), ("graupel", 1e-3)):
        q[nm] = rng.uniform(0.0, top, cell)
    return st, q


def jnp_dict(d):
    import jax.numpy as jnp
    return None if d is None else {k: jnp.asarray(v) for k, v in d.items()}


def t64_dict(d):
    return None if d is None else {
        k: torch.as_tensor(np.array(v), dtype=torch.float64)
        for k, v in d.items()}


def close(got, want, tol, what):
    """got (a tensor or array) against want: the same shape, NaN at the
    same points, and max |got - want| <= tol x max |want| over the rest
    (tol absolute where want is all zero); an integer or boolean result
    must be equal."""
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "biu" or got.dtype.kind in "biu":
        assert np.array_equal(got, want), what
        return
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), (what, "NaN positions")
    if nan.all():
        return
    top = np.abs(want[~nan]).max()
    err = np.abs(got[~nan] - want[~nan]).max()
    assert err <= tol * (top if top > 0 else 1.0), (what, err, top)
