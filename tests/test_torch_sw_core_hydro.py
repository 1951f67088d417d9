"""The hydrostatic forms of the port's C-grid and D-grid steps (ops/csw.py,
ops/dsw.py with w = None) against the JAX package's c_sw / d_sw with
hydrostatic=True, as dyn_core_hydro calls them (c192_hydro's DynConfig
defaults: nord = 1, dddmp = 0, d_con = 0, the sponge profiles without the
w damping), and fv_tp_2d_kernel (ops/tp_sweep.py, the counterpart of
fv_tp_2d_pallas) on that step's pt operands with nord = 1 and damp_c > 0
against the JAX tp_core.fv_tp_2d. Perturbed dry Jablonowski-Williamson
state at C12L10 (float64, CPU, <= 1e-12 x max|ref| per output).

On the CPU the port's wrappers take their plain versions; the kernel launch
counters stay 0."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu import constants as con
from gfdl_atmos_cubed_sphere_tpu.grid.fv_eta import set_eta
from gfdl_atmos_cubed_sphere_tpu.init.baroclinic import jw_baroclinic
from gfdl_atmos_cubed_sphere_tpu.model.dyn_core import (
    DynConfig, _sponge_level_params)
from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops as jax_pack
from gfdl_atmos_cubed_sphere_tpu.ops import sw_core as jsc
from gfdl_atmos_cubed_sphere_tpu.ops import tp_core as jtp
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import build_grid_ops
from gfdl_atmos_cubed_sphere_tpu_torch.ops import a2b, csw, dsw, ke, tp_sweep

pytestmark = pytest.mark.fast

NPX, K = 13, 10
N = NPX - 1
H = 3
TOL = 1e-12
DT = 900.0
DSW_IN = ("delp", "pt", "u", "v", "uc", "vc", "ua", "va", "divg")
DSW_KEYS = ("nord", "nord_v", "d2_bg", "d_con", "nord_mask", "damp_v",
            "damp_v2", "nord_v2")


def _np(a):
    return np.array(a)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _dsw_kw():
    """d_sw's keywords as dyn_core_hydro passes them (dyn_core.py:592)."""
    cfg = DynConfig(npx=NPX, npz=K, dt=DT, hydrostatic=True)
    pl = _sponge_level_params(cfg)
    return dict(dt=DT, hord_mt=10, hord_vt=10, hord_dp=10, hord_tm=10,
                dddmp=cfg.dddmp, d4_bg=cfg.d4_bg, lim_fac=1.0,
                **{k: pl[k] for k in DSW_KEYS})


@pytest.fixture(scope="module")
def case():
    gj = jax_pack(NPX, dtype=jnp.float64)
    gt = build_grid_ops(NPX, dtype=torch.float64, device="cpu")
    _, ptop, ak, bk = set_eta(K)
    ic = jw_baroclinic(gj.geom, K, ak, bk, ptop, perturb=True, moist=False)
    rng = np.random.default_rng(43)
    pe = ptop + np.concatenate([np.zeros_like(ic["delp"][:, :1]),
                                np.cumsum(ic["delp"], axis=1)], axis=1)
    pk = np.exp(con.KAPPA * np.log(pe))
    pkz = (pk[:, 1:] - pk[:, :-1]) / (con.KAPPA * np.diff(np.log(pe), axis=1))
    delp = ic["delp"] * (1.0 + 1e-3 * rng.standard_normal(ic["delp"].shape))
    ptv = ic["pt"] / pkz * (1.0 + 1e-3 * rng.standard_normal(ic["pt"].shape))
    u = ic["u"] + 0.5 * rng.standard_normal(ic["u"].shape)
    v = ic["v"] + 0.5 * rng.standard_normal(ic["v"].shape)
    dp, pp = (gj.halo.pad_cell(jnp.asarray(a)) for a in (delp, ptv))
    up, vp = gj.halo.pad_dgrid(jnp.asarray(u), jnp.asarray(v))
    c = dict(delp=_np(dp), pt=_np(pp), u=_np(up), v=_np(vp))
    cs = SimpleNamespace(**jax.jit(lambda *a: vars(jsc.c_sw(
        a[0], a[1], None, a[2], a[3], gj, 0.5 * DT, hydrostatic=True,
        nord=1, sw_mode=False)))(dp, pp, up, vp))
    ctr, wsl = slice(H, H + N), slice(H, H + N + 1)
    ucp, vcp = gj.halo.pad_cgrid(cs.uc[..., ctr, wsl], cs.vc[..., wsl, ctr])
    c.update(uc=_np(ucp), vc=_np(vcp), ua=_np(cs.ua), va=_np(cs.va),
             divg=_np(gj.halo.pad_corner(cs.divg_d[..., wsl, wsl])))
    kw = _dsw_kw()
    ds = SimpleNamespace(**jax.jit(lambda *a: vars(jsc.d_sw(
        a[0], a[1], None, *a[2:], gj, sw_mode=False, hydrostatic=True,
        **kw)))(*(jnp.asarray(c[k]) for k in DSW_IN)))
    return gj, gt, c, cs, ds


def _close(want, got, what):
    want = np.asarray(want)
    got = got.numpy()
    fin = np.isfinite(want)
    assert fin.any(), what
    assert np.array_equal(fin, np.isfinite(got)), what
    err = np.abs(np.where(fin, got - want, 0.0)).max()
    assert err <= TOL * np.abs(np.where(fin, want, 0.0)).max(), (what, err)


def _launched():
    return (a2b.launches, csw.launches, dsw.launches["fluxes"],
            dsw.launches["winds"], ke.launches, tp_sweep.launches,
            tp_sweep.launches_fv_tp_2d)


def _reset():
    for mod in (a2b, csw, dsw, ke, tp_sweep):
        mod.reset_launches()


def test_c_sw_hydro(case):
    _, gt, c, cs, _ = case
    _reset()
    got = csw.c_sw(_t(c["delp"]), _t(c["pt"]), None, _t(c["u"]),
                   _t(c["v"]), gt, 0.5 * DT, nord=1)
    assert _launched() == (0,) * 7
    assert got.wc is None
    for nm in ("delpc", "ptc", "uc", "vc", "ua", "va", "divg_d", "ut", "vt"):
        _close(getattr(cs, nm), getattr(got, nm), nm)


def test_d_sw_hydro(case):
    """Both stages (dsw.d_sw) with w = None: no w and no heat source."""
    _, gt, c, _, ds = case
    targs = [_t(c[k]) for k in DSW_IN]
    _reset()
    got = dsw.d_sw(targs[0], targs[1], None, *targs[2:], gt, **_dsw_kw())
    assert _launched() == (0,) * 7
    assert got.w is None and got.heat_source is None
    for nm in ("u", "v", "delp", "pt", "fx", "fy", "crx", "cry", "xfx",
               "yfx", "ra_x", "ra_y"):
        _close(getattr(ds, nm), getattr(got, nm), nm)


def test_fv_tp_2d_kernel(case):
    """fv_tp_2d_kernel's plain path on d_sw's pt transport (mass fluxes,
    del-n damping in mass form, nord = 1, damp_c = 0.12) against the JAX
    tp_core.fv_tp_2d."""
    gj, gt, c, _, ds = case
    ops = ("crx", "cry", "xfx", "yfx", "ra_x", "ra_y", "fx", "fy")
    j = {k: jnp.asarray(getattr(ds, k)) for k in ops}
    want = jax.jit(lambda q, m, jj: jtp.fv_tp_2d(
        q, jj["crx"], jj["cry"], 10, jj["xfx"], jj["yfx"], gj.area,
        jj["ra_x"], jj["ra_y"], gj.dxa, gj.dya, mfx=jj["fx"], mfy=jj["fy"],
        nord=1, damp_c=0.12, g=gj, mass=m))(
            jnp.asarray(c["pt"]), jnp.asarray(c["delp"]), j)
    t = {k: _t(getattr(ds, k)) for k in ops}
    _reset()
    got = tp_sweep.fv_tp_2d_kernel(
        _t(c["pt"]), t["crx"], t["cry"], 10, t["xfx"], t["yfx"], gt.area,
        t["ra_x"], t["ra_y"], gt.dxa, gt.dya, mfx=t["fx"], mfy=t["fy"],
        nord=1, damp_c=0.12, g=gt, mass=_t(c["delp"]))
    assert _launched() == (0,) * 7
    for nm, a, b in zip(("fx", "fy"), want, got):
        _close(a, b, nm)
