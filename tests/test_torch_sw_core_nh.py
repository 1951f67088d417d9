"""The PyTorch port's nonhydrostatic C-grid and D-grid steps (ops/csw.py,
ops/dsw.py, ops/sw_core.py) against the JAX package: c_sw with pt and w,
and d_sw as its fluxes stage, its winds stage and both together, with the
per-level sponge profiles of dyn_core's _sponge_level_params (d2_bg, d_con,
nord_mask, the second damping combos, w damping) and the Smagorinsky term
(dddmp = 0.2), on a perturbed dry Jablonowski-Williamson state at C12L10
(float64, CPU, <= 1e-12 x max|ref| per output).

On the CPU the JAX package takes its XLA formulation and the port the plain
versions of its kernels; the kernel launch counters stay 0."""

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
from gfdl_atmos_cubed_sphere_tpu_torch.model import dyn_core as tdc
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import build_grid_ops
from gfdl_atmos_cubed_sphere_tpu_torch.ops import a2b, csw, dsw, ke, tp_sweep

pytestmark = pytest.mark.fast

NPX, K = 13, 10
N = NPX - 1
H = 3
TOL = 1e-12
DT = 1800.0
DSW_IN = ("delp", "pt", "w", "u", "v", "uc", "vc", "ua", "va", "divg")
CFG = dict(npx=NPX, npz=K, dt=DT, hydrostatic=False, dddmp=0.2, d_con=1.0,
           do_vort_damp=True)


def _np(a):
    return np.array(a)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _dsw_kw():
    cfg = DynConfig(**CFG)
    return dict(dt=DT, hord_mt=10, hord_vt=10, hord_dp=10, hord_tm=10,
                dddmp=cfg.dddmp, d4_bg=cfg.d4_bg, ke_bg=0.0, lim_fac=1.0,
                **_sponge_level_params(cfg))


@pytest.fixture(scope="module")
def case():
    gj = jax_pack(NPX, dtype=jnp.float64)
    gt = build_grid_ops(NPX, dtype=torch.float64, device="cpu")
    _, ptop, ak, bk = set_eta(K)
    ic = jw_baroclinic(gj.geom, K, ak, bk, ptop, perturb=True, moist=False)
    rng = np.random.default_rng(41)
    rrg = -con.RDGAS / con.GRAV
    pkz = np.exp(con.KAPPA * np.log(rrg * ic["delp"] / ic["delz"] * ic["pt"]))
    delp = ic["delp"] * (1.0 + 1e-3 * rng.standard_normal(ic["delp"].shape))
    ptv = ic["pt"] / pkz * (1.0 + 1e-3 * rng.standard_normal(ic["pt"].shape))
    w = 0.05 * rng.standard_normal(ic["delp"].shape)
    u = ic["u"] + 0.5 * rng.standard_normal(ic["u"].shape)
    v = ic["v"] + 0.5 * rng.standard_normal(ic["v"].shape)
    dp, pp, wp = (gj.halo.pad_cell(jnp.asarray(a)) for a in (delp, ptv, w))
    up, vp = gj.halo.pad_dgrid(jnp.asarray(u), jnp.asarray(v))
    c = dict(delp=_np(dp), pt=_np(pp), w=_np(wp), u=_np(up), v=_np(vp))
    cs = SimpleNamespace(**jax.jit(lambda *a: vars(jsc.c_sw(
        *a, gj, 0.5 * DT, hydrostatic=False, nord=1, sw_mode=False)))(
            dp, pp, wp, up, vp))
    ctr, wsl = slice(H, H + N), slice(H, H + N + 1)
    ucp, vcp = gj.halo.pad_cgrid(cs.uc[..., ctr, wsl], cs.vc[..., wsl, ctr])
    c.update(uc=_np(ucp), vc=_np(vcp), ua=_np(cs.ua), va=_np(cs.va),
             divg=_np(gj.halo.pad_corner(cs.divg_d[..., wsl, wsl])))
    # the JAX d_sw references: its fluxes stage and the whole step (whose
    # wind half is the winds stage on the fluxes stage's products)
    kw = _dsw_kw()
    ref = {}
    for stage in ("fluxes", "all"):
        ref[stage] = SimpleNamespace(**jax.jit(lambda *a: vars(jsc.d_sw(
            *a, gj, sw_mode=False, hydrostatic=False, stage=stage,
            **kw)))(*(jnp.asarray(c[k]) for k in DSW_IN)))
    return gj, gt, c, cs, ref


def _close(want, got, what):
    want = np.asarray(want)
    got = got.numpy()
    fin = np.isfinite(want)
    assert fin.any(), what
    assert np.array_equal(fin, np.isfinite(got)), what
    err = np.abs(np.where(fin, got - want, 0.0)).max()
    assert err <= TOL * np.abs(np.where(fin, want, 0.0)).max(), (what, err)


def _reset():
    for mod in (a2b, csw, dsw, ke, tp_sweep):
        mod.reset_launches()


def _launched():
    return (a2b.launches, csw.launches, dsw.launches["fluxes"],
            dsw.launches["winds"], ke.launches, tp_sweep.launches)


def test_c_sw_nh(case):
    _, gt, c, cs, _ = case
    _reset()
    got = csw.c_sw(*(_t(c[k]) for k in ("delp", "pt", "w", "u", "v")), gt,
                   0.5 * DT, nord=1)
    assert _launched() == (0,) * 6
    for nm in ("delpc", "ptc", "wc", "uc", "vc", "ua", "va", "divg_d", "ut",
               "vt"):
        _close(getattr(cs, nm), getattr(got, nm), nm)


FLUX_OUT = ("delp", "pt", "w", "fx", "fy", "crx", "cry", "xfx", "yfx",
            "ra_x", "ra_y", "ut", "vt", "heat_source")


@pytest.mark.parametrize("stage", ["fluxes", "winds", "all"])
def test_d_sw_nh(case, stage):
    _, gt, c, _, ref = case
    kw = _dsw_kw()
    targs = [_t(c[k]) for k in DSW_IN]
    jfl, jall = ref["fluxes"], ref["all"]
    _reset()
    if stage == "fluxes":
        got = dsw.d_sw_fluxes(*targs[:3], *targs[5:7], gt,
                              **{k: kw[k] for k in dsw.FLUX_KW})
        checks = [(nm, getattr(jfl, nm), getattr(got, nm))
                  for nm in FLUX_OUT]
    elif stage == "winds":
        seam = {k: _t(getattr(jfl, k)) for k in dsw.SEAM}
        got = dsw.d_sw_winds(targs[0], *targs[3:], None,
                             _t(jfl.heat_source), seam, gt,
                             **{k: kw[k] for k in dsw.WIND_KW})
        checks = [(nm, getattr(jall, nm), getattr(got, nm))
                  for nm in ("u", "v", "heat_source")]
    else:
        got = dsw.d_sw(*targs, gt, **kw)
        checks = [(nm, getattr(jall, nm), getattr(got, nm))
                  for nm in ("u", "v") + FLUX_OUT[:-3] + ("heat_source",)]
    assert _launched() == (0,) * 6
    for nm, a, b in checks:
        _close(a, b, nm)


def test_sponge_level_params():
    cfg = DynConfig(**CFG)
    want = _sponge_level_params(cfg)
    got = tdc._sponge_level_params(tdc.DynConfig(**CFG))
    assert want.keys() == got.keys()
    for k, a in want.items():
        b = got[k]
        if a is None or np.ndim(a) == 0:
            assert a == b, k
        else:
            assert np.array_equal(a, b), k
