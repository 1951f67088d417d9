"""The PyTorch port's nonhydrostatic C-grid and D-grid steps (ops/csw.py,
ops/dsw.py, ops/sw_core.py) against the JAX package: c_sw with pt and w,
and d_sw as its fluxes stage, its winds stage and both together, with the
per-level sponge profiles of dyn_core's _sponge_level_params (d2_bg, d_con,
nord_mask, the second damping combos, w damping) and the Smagorinsky term
(dddmp = 0.2), on a perturbed dry Jablonowski-Williamson state at C12L10
(float64, CPU, <= 1e-12 x max|ref| per output); d_sw again at the kernel
arguments beyond the usual ones (DSW_ARGS: the SHiELD namelist's nord 2
and hord -5/5 with its sponge combos at nord 1, nord 3 with hords
7/9/13 and hord 1 at lim_fac 0.5); and one dry nonhydrostatic big step of
the SHiELD namelist (tests/test_torch_config.py SHIELD_NML) cut to C12L10,
n_split 2, against the jitted JAX fv_dynamics_nh (<= 1e-10 x field max).

On the CPU the JAX package takes its XLA formulation and the port the plain
versions of its kernels; the kernel launch counters stay 0."""

import dataclasses
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
from gfdl_atmos_cubed_sphere_tpu.model.fv_dynamics import fv_dynamics_nh as jfv
from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops as jax_pack
from gfdl_atmos_cubed_sphere_tpu.model.sw_dynamics import prepare_phis as jphis
from gfdl_atmos_cubed_sphere_tpu.ops import sw_core as jsc
from gfdl_atmos_cubed_sphere_tpu.utils import config as jcfg
from gfdl_atmos_cubed_sphere_tpu_torch.model import dyn_core as tdc
from gfdl_atmos_cubed_sphere_tpu_torch.model.fv_dynamics import fv_dynamics_nh
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import (
    build_grid_ops, state_from_arrays)
from gfdl_atmos_cubed_sphere_tpu_torch.model.sw_dynamics import prepare_phis
from gfdl_atmos_cubed_sphere_tpu_torch.ops import a2b, csw, dsw, ke, tp_sweep
from gfdl_atmos_cubed_sphere_tpu_torch.utils import config as tcfg
from test_torch_config import SHIELD_NML

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


def _dsw_kw(cfg_over=None, **over):
    """d_sw's arguments as dyn_core passes them for CFG with cfg_over (the
    per-level sponge profiles of _sponge_level_params), with over on top."""
    cfg = DynConfig(**dict(CFG, **(cfg_over or {})))
    kw = dict(dt=DT, hord_mt=10, hord_vt=10, hord_dp=10, hord_tm=10,
              dddmp=cfg.dddmp, d4_bg=cfg.d4_bg, ke_bg=0.0, lim_fac=1.0,
              **_sponge_level_params(cfg))
    kw.update(over)
    return kw


# the SHiELD namelist's damping (tests/test_torch_config.py SHIELD_NML)
SHIELD_DAMP = dict(nord=2, d4_bg=0.12, vtdm4=0.02, d2_bg_k1=0.20,
                   d2_bg_k2=0.15)
#: d_sw at the kernel arguments beyond hord 5/6/8/10 and nord 0/1:
#: (DynConfig settings, d_sw arguments on top of _dsw_kw). "shield": the
#: namelist's nord 2 (nord_v = nord_w = 2) and hords, its sponge levels'
#: second combos at nord 1; "nord3": nord 3 with hords of the monotone and
#: positive-definite family, and hord_dp 1 at lim_fac 0.5
DSW_ARGS = {
    "shield": (SHIELD_DAMP, dict(hord_mt=5, hord_vt=5, hord_tm=5,
                                 hord_dp=-5, nord_v2=1, nord_w2=1)),
    "nord3": (dict(SHIELD_DAMP, nord=3), dict(hord_mt=9, hord_vt=13,
                                              hord_tm=7, hord_dp=1,
                                              lim_fac=0.5)),
}


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


@pytest.mark.parametrize("name", sorted(DSW_ARGS))
def test_d_sw_nh_kernel_arguments(case, name):
    """d_sw as the two stages' plain versions (nord_v and nord_w follow
    nord up to 2) against the jitted JAX d_sw at the same arguments."""
    gj, gt, c, _, _ = case
    cfg_over, over = DSW_ARGS[name]
    kw = _dsw_kw(cfg_over, **over)
    want = SimpleNamespace(**jax.jit(lambda *a: vars(jsc.d_sw(
        *a, gj, sw_mode=False, hydrostatic=False, stage="all", **kw)))(
            *(jnp.asarray(c[k]) for k in DSW_IN)))
    _reset()
    got = dsw.d_sw(*(_t(c[k]) for k in DSW_IN), gt, **kw)
    assert _launched() == (0,) * 6
    for nm in ("u", "v") + FLUX_OUT[:-3] + ("heat_source",):
        _close(getattr(want, nm), getattr(got, nm), nm)


def test_fv_dynamics_nh_shield_namelist():
    """One dry nonhydrostatic big step of the SHiELD namelist's dynamics
    (nord 2, hord_dp -5, hord 5, sponge levels, tau 5 d) parsed by each
    package's utils/config, cut to C12L10 with n_split 2 and dt 1800 s,
    from a perturbed dry Jablonowski-Williamson state: the port's plain
    versions against the jitted JAX step, every field <= 1e-10 x its
    maximum."""
    cut = dict(npx=NPX, npz=K, n_split=2, adiabatic=True)
    tc = dataclasses.replace(tcfg.dyn_config_from_namelist(
        tcfg.parse_namelist(SHIELD_NML), dt=DT)[0], **cut)
    jc = dataclasses.replace(jcfg.dyn_config_from_namelist(
        jcfg.parse_namelist(SHIELD_NML), dt=DT)[0], **cut)
    assert (tc.nord, tc.hord_dp, tc.hord_vt, tc.k_split) == (2, -5, 5, 1)
    gj = jax_pack(NPX, dtype=jnp.float64)
    gt = build_grid_ops(NPX, dtype=torch.float64, device="cpu")
    _, ptop, ak, bk = set_eta(K)
    ic = jw_baroclinic(gj.geom, K, ak, bk, ptop, perturb=True, moist=False)
    rng = np.random.default_rng(7)
    for nm in ("u", "v"):
        ic[nm] = ic[nm] + 0.5 * rng.standard_normal(ic[nm].shape)
    jphis(gj, ic["phis"])
    prepare_phis(gt, ic["phis"])
    dp0 = np.diff(ak) + np.diff(bk) * 1.0e5
    names = ("delp", "pt", "u", "v", "w", "delz")

    def jstep(*a):
        r = jfv(*a, {}, gj, jc, ak, bk, ptop, dp0, u0=a[2], v0=a[3])
        return tuple(getattr(r, k) for k in names)

    want = jax.jit(jstep)(*(jnp.asarray(ic[k]) for k in names))
    ts = state_from_arrays(dict(ic, ak=ak, bk=bk), dtype=torch.float64,
                           device="cpu")
    _reset()
    got = fv_dynamics_nh(*(ts[k] for k in names), {}, gt, tc, ts["ak"],
                         ts["bk"], ptop, dp0, u0=ts["u"], v0=ts["v"])
    assert _launched() == (0,) * 6
    for nm, a in zip(names, want):
        a = np.asarray(a)
        b = getattr(got, nm).numpy()
        assert np.isfinite(a).all(), nm
        assert np.abs(b - a).max() <= 1e-10 * np.abs(a).max(), nm


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


@pytest.mark.parametrize("stage", ["fluxes", "winds"])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n", [12, 24, 192, 768])
def test_d_sw_stage_boxes_cover_each_frame_once(n, itemsize, stage):
    """The stage kernels' grid: boxes of at most TX x TY cells, at least
    min(n, TX / 2) wide, never under 3 (so only the box holding a cube
    corner reaches into its halo), whose owned points cover every output
    frame (the padded cell and wall frames of the seam, the compute cells
    and walls) exactly once."""
    tx, ty, ntx, nty = dsw.tile_plan(stage, n, itemsize)
    assert (tx, ty) == dsw.BOX[stage][itemsize]
    for nt, most in ((ntx, tx), (nty, ty)):
        st = dsw.box_starts(n, nt)
        sizes = np.diff(st)
        assert st[0] == 0 and st[-1] == n
        assert sizes.max() <= most and sizes.min() >= min(n, most // 2) >= 3
        for kind, frame in (("cells", n + 6), ("walls", n + 7),
                            ("compute_cells", n), ("compute_walls", n + 1)):
            hits = np.zeros(frame, int)
            for lo, hi in dsw.owned_ranges(n, nt, kind):
                hits[lo:hi] += 1
            assert (hits == 1).all(), (kind, hits)


def test_d_sw_stage_shared_memory_fits_a_block():
    """Each stage kernel's window planes fit the 232448 bytes of shared
    memory a Hopper block can take, in both precisions, and C768L127 stays
    inside the grid's x extent."""
    for stage in ("fluxes", "winds"):
        for itemsize in (4, 8):
            tx, ty = dsw.BOX[stage][itemsize]
            win = (ty + 7) * (tx + 7)
            b = dsw.smem_bytes(stage, itemsize)
            planes = dsw.SMEM_PLANES[stage] + dsw.SMEM_FIELDS[stage]
            assert b == (planes * itemsize + dsw.SMEM_FLAG_PLANES) * win
            assert 48 * 1024 < b <= 232448, (stage, itemsize, b)
    _, _, ntx, nty = dsw.tile_plan("fluxes", 768, 4)
    assert 6 * 127 * ntx * nty < 2 ** 31


def test_d_sw_stage_operands_are_outputs_only():
    """The stage kernels' argument packing: the outputs and per-level
    profiles only (no workspace), the box and shared-memory bytes in the
    int parameters, lim_fac in the double ones, null w / heat for the
    hydrostatic form, and ValueError for what the kernels do not take:
    what sw_core.d_sw has no branch for (hord 0, beyond 13 or below -6;
    nord beyond 3; nord_v, nord_w, nord_v2, nord_w2 beyond 2)."""
    gt = build_grid_ops(NPX, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(5)
    P, W, Kt = N + 2 * H, N + 2 * H + 1, 2

    def f(*s):
        return torch.as_tensor(rng.standard_normal((6, Kt) + s))

    kw = {k: v for k, v in _dsw_kw().items() if k in dsw.FLUX_KW}
    kw.update(damp_v=0.02, damp_v2=None, damp_w=0.02, damp_w2=None)
    for w in (f(P, P), None):
        fields, mets, outs, prof, iv, dv, out = dsw._fluxes_operands(
            f(P, P), f(P, P), w, f(P, W), f(W, P), gt, **kw)
        assert len(fields) == 5 and len(mets) == len(dsw.FLUX_METRICS)
        assert len(outs) == 14 and len(prof) == 4 and len(dv) == 3
        assert (outs[2] is None) == (w is None) == (outs[13] is None)
        assert list(iv[-5:]) == [*dsw.tile_plan("fluxes", N, 8)[2:],
                                 *dsw.BOX["fluxes"][8],
                                 dsw.smem_bytes("fluxes", 8)]
        assert tuple(out.fx.shape) == (6, Kt, N, N + 1)
        assert tuple(out.ut.shape) == (6, Kt, P, W)
    wkw = {k: v for k, v in _dsw_kw().items() if k in dsw.WIND_KW}
    seam = {"crx": f(P, W), "cry": f(W, P), "xfx": f(P, W),
            "yfx": f(W, P), "ra_x": f(P, P), "ra_y": f(P, P),
            "ut": f(P, W), "vt": f(W, P)}
    wkw.update(d2_bg=0.0, d_con=1.0, nord_mask=None, damp_v=0.02,
               damp_v2=None)
    ins, mets, outs, prof, iv, dv, out = dsw._winds_operands(
        f(P, P), f(W, P), f(P, W), f(P, W), f(W, P), f(P, P), f(P, P),
        f(W, W), f(W, W), f(N, N), seam, gt, **wkw)
    assert len(ins) == 18 and len(mets) == len(dsw.WIND_METRICS)
    assert len(outs) == 3 and len(prof) == 5 and len(dv) == 5
    assert list(iv[-5:]) == [*dsw.tile_plan("winds", N, 8)[2:],
                             *dsw.BOX["winds"][8], dsw.smem_bytes("winds", 8)]
    assert tuple(out.u.shape) == (6, Kt, N + 1, N)
    assert tuple(out.heat_source.shape) == (6, Kt, N, N)
    for bad in (dict(hord_dp=14), dict(hord_tm=0), dict(hord_vt=-7),
                dict(nord_v=3), dict(nord_w=3), dict(nord_v2=3),
                dict(nord_w2=-1)):
        with pytest.raises(ValueError):
            dsw._fluxes_operands(f(P, P), f(P, P), None, f(P, W), f(W, P),
                                 gt, **dict(kw, **bad))
    for bad in (dict(nord=4), dict(nord_v=3), dict(nord_v2=3),
                dict(hord_mt=14), dict(hord_vt=0)):
        with pytest.raises(ValueError):
            dsw._winds_operands(
                f(P, P), f(W, P), f(P, W), f(P, W), f(W, P), f(P, P),
                f(P, P), f(W, W), f(W, W), f(N, N), seam, gt,
                **dict(wkw, **bad))
    with pytest.raises(ValueError, match="8 cells"):
        dsw._fluxes_operands(*(torch.zeros(6, 1, 13, 13),) * 3,
                             torch.zeros(6, 1, 13, 14),
                             torch.zeros(6, 1, 14, 13), gt, **kw)
    assert dsw.launches == {"fluxes": 0, "winds": 0}
