"""The PyTorch port's shallow-water solvers (ops/sw_core.py, ops/ke.py)
against the JAX package: c_sw, ke_section and SW-mode d_sw, advection_only
included (float64, CPU, Williamson case 2 with seeded noise).

On the CPU the JAX d_sw takes its XLA ke_section and the port the plain
version of its kernel; the kernel launch counters stay 0."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu.init import sw_cases as jcases
from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops as jax_pack
from gfdl_atmos_cubed_sphere_tpu.ops import sw_core as jsc
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import build_grid_ops
from gfdl_atmos_cubed_sphere_tpu_torch.ops import a2b, ke, tp_sweep
from gfdl_atmos_cubed_sphere_tpu_torch.ops import sw_core as tsc

pytestmark = pytest.mark.fast

NPX = 13
N = NPX - 1
H = 3
TOL = 1e-12
DT = 1800.0


def _np(a):
    return np.array(a)


@pytest.fixture(scope="module")
def case():
    gj = jax_pack(NPX, dtype=jnp.float64)
    gt = build_grid_ops(NPX, dtype=torch.float64, device="cpu")
    ic = jcases.case2(gj.geom)
    rng = np.random.default_rng(13)
    delp = ic["delp"] * (1.0 + 1e-3 * rng.standard_normal(ic["delp"].shape))
    u = ic["u"] + 0.5 * rng.standard_normal(ic["u"].shape)
    v = ic["v"] + 0.5 * rng.standard_normal(ic["v"].shape)
    up, vp = gj.halo.pad_dgrid(jnp.asarray(u), jnp.asarray(v))
    c = dict(delp=_np(gj.halo.pad_cell(jnp.asarray(delp))), u=_np(up),
             v=_np(vp))
    c["pt"] = np.ones_like(c["delp"])
    # C-grid state for d_sw from the JAX c_sw (nord=1 gives divg_d)
    cs = jsc.c_sw(*(jnp.asarray(c[k]) for k in ("delp", "pt")), None,
                  jnp.asarray(c["u"]), jnp.asarray(c["v"]), gj, 0.5 * DT,
                  nord=1, sw_mode=True)
    ctr, wsl = slice(H, H + N), slice(H, H + N + 1)
    ucp, vcp = gj.halo.pad_cgrid(cs.uc[..., ctr, wsl], cs.vc[..., wsl, ctr])
    c.update(uc=_np(ucp), vc=_np(vcp), ua=_np(cs.ua), va=_np(cs.va),
             divg=_np(gj.halo.pad_corner(cs.divg_d[..., wsl, wsl])))
    # contravariant winds ut, vt from the JAX d_sw flux stage
    pre = jsc.d_sw(*_args(c, ("delp", "pt"), jnp.asarray), None,
                   *_args(c, ("u", "v", "uc", "vc", "ua", "va", "divg"),
                          jnp.asarray), gj, **_kw(), stage="fluxes")
    c.update(ut=_np(pre.ut), vt=_np(pre.vt))
    return gj, gt, c


def _close(name, want, got, tol=TOL):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, name
    if want.shape[-1] > N + 1:               # padded: compare the interior
        want, got = want[..., H:-H, H:-H], got[..., H:-H, H:-H]
    assert np.isfinite(want).all(), name
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err <= tol, (name, err)


def _args(c, keys, conv):
    return [None if k is None else conv(c[k]) for k in keys]


@pytest.mark.parametrize("nord", [0, 1])
def test_c_sw(case, nord):
    gj, gt, c = case
    keys = ("delp", "pt", None, "u", "v")
    want = jsc.c_sw(*_args(c, keys, jnp.asarray), gj, 0.5 * DT, nord=nord,
                    sw_mode=True)
    got = tsc.c_sw(*_args(c, keys, torch.as_tensor), gt, 0.5 * DT, nord=nord,
                   sw_mode=True)
    for nm in ("delpc", "ptc", "uc", "vc", "ua", "va", "ut", "vt") + (
            ("divg_d",) if nord else ()):
        _close(nm, getattr(want, nm), getattr(got, nm))
    if not nord:
        assert got.divg_d is None


def _ke_args(gp, c, conv):
    return ([conv(c[k]) for k in ("u", "v", "uc", "vc", "ut", "vt")]
            + [gp.cosa, gp.rsina, gp.dx, gp.rdx, gp.dy, gp.rdy])


@pytest.mark.parametrize("hord_mt", [5, 6, 8, 9, 10] + [
    h for h in ke.KERNEL_HORDS if h not in (5, 6, 8, 9, 10)])
def test_ke_section(case, hord_mt):
    gj, gt, c = case
    want = jsc.ke_section(*_ke_args(gj, c, jnp.asarray), DT, hord_mt, 1.0,
                          NPX, True)
    ke.reset_launches()
    got = ke.ke_section(*_ke_args(gt, c, torch.as_tensor), DT, hord_mt, 1.0,
                        NPX)
    wsl = slice(H, H + N + 1)
    _close("ke", np.asarray(want)[..., wsl, wsl], got[..., wsl, wsl])
    assert ke.launches == 0


def _kw(**over):
    kw = dict(dt=DT, hord_mt=6, hord_vt=6, hord_dp=6, hord_tm=6, nord=1,
              nord_v=1, dddmp=0.0, d2_bg=0.0, d4_bg=0.16, damp_v=0.0,
              sw_mode=True)
    kw.update(over)
    return kw


DSW_CASES = {
    "default": _kw(),
    "nord0_smag": _kw(nord=0, nord_v=0, dddmp=0.2, d2_bg=0.005),
    "nord2_smag_vort_heat": _kw(nord=2, nord_v=2, dddmp=0.2, damp_v=0.12,
                                d_con=1.0),
    "hord5": _kw(hord_mt=5, hord_vt=5, hord_dp=5),
    "hord8_10": _kw(hord_mt=8, hord_vt=10, hord_dp=8),
    "advection_only": _kw(advection_only=True),
}


@pytest.mark.parametrize("name", sorted(DSW_CASES))
def test_d_sw(case, name):
    gj, gt, c = case
    kw = DSW_CASES[name]
    keys = ("u", "v", "uc", "vc", "ua", "va", "divg")
    if kw.get("advection_only"):
        keys = (None, None, "uc", "vc", None, None, None)
    want = jsc.d_sw(*_args(c, ("delp", "pt"), jnp.asarray), None,
                    *_args(c, keys, jnp.asarray), gj, **kw)
    for mod in (a2b, ke, tp_sweep):
        mod.reset_launches()
    got = tsc.d_sw(*_args(c, ("delp", "pt"), torch.as_tensor), None,
                   *_args(c, keys, torch.as_tensor), gt, **kw)
    names = ("delp", "pt", "fx", "fy", "crx", "cry", "xfx", "yfx", "ra_x",
             "ra_y")
    if not kw.get("advection_only"):
        names += ("u", "v", "ke", "divg_d")
    if kw.get("d_con"):
        names += ("heat_source",)
    for nm in names:
        _close(nm, getattr(want, nm), getattr(got, nm))
    assert (a2b.launches, ke.launches, tp_sweep.launches) == (0, 0, 0)


def test_del2_cubed(case):
    gj, gt, c = case
    want = jsc.del2_cubed(jnp.asarray(c["delp"]), 0.2 * float(gj.da_min), gj,
                          3)
    got = tsc.del2_cubed(torch.as_tensor(c["delp"]),
                         0.2 * float(gt.da_min), gt, 3)
    _close("del2", want, got)


def _off_cube(g):
    """A copy of the pack that claims a non-cube (doubly periodic) grid."""
    return SimpleNamespace(**dict(vars(g), grid_type=4))


def _w(c):
    """A seeded vertical-velocity field shaped like the padded delp."""
    return 0.1 * np.random.default_rng(17).standard_normal(c["delp"].shape)


@pytest.mark.parametrize("over", [dict(hydrostatic=False),
                                  dict(sw_mode=False),
                                  dict(nord_mask=np.zeros(1, bool)),
                                  dict(damp_w=0.1)])
def test_d_sw_nh_arguments_raise(case, over):
    """The 3-D/NH arguments the shallow-water slice refused are ported now:
    each agrees with the JAX package; on a non-cube grid d_sw still
    raises NotImplementedError."""
    gj, gt, c = case
    c = dict(c, w=_w(c))
    keys = ("delp", "pt", "w", "u", "v", "uc", "vc", "ua", "va", "divg")
    want = jsc.d_sw(*_args(c, keys, jnp.asarray), gj, **_kw(**over))
    got = tsc.d_sw(*_args(c, keys, torch.as_tensor), gt, **_kw(**over))
    for nm in ("u", "v", "delp", "pt", "w", "fx", "fy"):
        if getattr(want, nm) is None:
            assert getattr(got, nm) is None, nm
        else:
            _close(nm, getattr(want, nm), getattr(got, nm))
    with pytest.raises(NotImplementedError):
        tsc.d_sw(*_args(c, keys, torch.as_tensor), _off_cube(gt),
                 **_kw(**over))


def test_c_sw_nh_raises(case):
    """c_sw's nonhydrostatic form (w transport) agrees with the JAX
    package; on a non-cube grid it raises NotImplementedError."""
    gj, gt, c = case
    c = dict(c, w=_w(c))
    keys = ("delp", "pt", "w", "u", "v")
    want = jsc.c_sw(*_args(c, keys, jnp.asarray), gj, 0.5 * DT,
                    hydrostatic=False, sw_mode=True)
    got = tsc.c_sw(*_args(c, keys, torch.as_tensor), gt, 0.5 * DT,
                   hydrostatic=False, sw_mode=True)
    for nm in ("delpc", "ptc", "wc", "uc", "vc", "ua", "va", "ut", "vt"):
        _close(nm, getattr(want, nm), getattr(got, nm))
    with pytest.raises(NotImplementedError):
        tsc.c_sw(*_args(c, keys, torch.as_tensor), _off_cube(gt), 0.5 * DT,
                 hydrostatic=False, sw_mode=True)
