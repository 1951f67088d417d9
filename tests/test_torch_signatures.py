"""The port functions whose signatures were narrower than, or shifted from,
the JAX function of the same name, each called the way JAX's callers call
it (float64, CPU, C12):

- the parameters of each, in order with JAX's defaults (the port may add
  trailing ones: device);
- remap_nh and remap_hydro take JAX's positional last_step (a positional
  call once set kord_wz to the bool), against the jitted JAX functions;
  dyn_core_nh and dyn_core_hydro take the positional phis
  (tests/test_torch_dyn_core.py and test_torch_hydro_core.py call both
  packages with it);
- the behaviour JAX offers: Atmosphere.adiabatic_init(na_init, wt),
  am_fixer(torque), rayleigh_friction(conserve), tracer_2d(max_split,
  lim_fac), hs_forcing(radius), fv_nudge(tau_winds, tau_temp),
  load_state(verify_checksums), read_fvio(verify), Timers(sync), and the
  names nan_check(tree), bulk_surface_drag(q_bot),
  edge_interpolate4(axis) and model.dyn_core.geopk;
each output <= 1e-12 x its maximum (the whole remaps 1e-10)."""

import inspect
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu import constants as con
from gfdl_atmos_cubed_sphere_tpu.grid.fv_eta import set_eta
from gfdl_atmos_cubed_sphere_tpu.init.baroclinic import jw_baroclinic
from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops as jax_pack
from gfdl_atmos_cubed_sphere_tpu.model.sw_dynamics import prepare_phis as jphis
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import build_grid_ops
from gfdl_atmos_cubed_sphere_tpu_torch.model.sw_dynamics import prepare_phis

pytestmark = pytest.mark.fast

NPX, K = 13, 5
N = NPX - 1
H = 3

#: (module, attribute) of each repaired function, the same in both packages
REPAIRED = [
    ("model.dyn_core", "dyn_core_nh"), ("model.dyn_core", "dyn_core_hydro"),
    ("model.dyn_core", "geopk"),
    ("model.fv_dynamics", "remap_nh"), ("model.fv_dynamics", "remap_hydro"),
    ("model.fv_dynamics", "rayleigh_friction"),
    ("model.thermodynamics", "am_fixer"), ("model.tracer_2d", "tracer_2d"),
    ("physics.held_suarez", "hs_forcing"), ("physics.sim_phys", "fv_nudge"),
    ("physics.sim_phys", "bulk_surface_drag"),
    ("io.restart", "load_state"), ("io.native_io", "read_fvio"),
    ("io.diagnostics", "nan_check"), ("ops.sw_core", "edge_interpolate4"),
    ("utils.timing", "Timers"), ("driver.solo", "Atmosphere.adiabatic_init"),
]


def resolve(pkg, mod, attr):
    import importlib
    obj = importlib.import_module(f"{pkg}.{mod}")
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


@pytest.mark.parametrize("mod,attr", REPAIRED,
                         ids=[a for _, a in REPAIRED])
def test_parameters_match_jax(mod, attr):
    want = list(inspect.signature(resolve(
        "gfdl_atmos_cubed_sphere_tpu", mod, attr)).parameters.values())
    got = list(inspect.signature(resolve(
        "gfdl_atmos_cubed_sphere_tpu_torch", mod, attr)).parameters.values())
    for w, g in zip(want, got):
        assert (g.name, g.kind) == (w.name, w.kind), (attr, g, w)
        if w.default is not inspect.Parameter.empty and not isinstance(
                w.default, (jnp.ndarray, np.ndarray)):
            # each package's own config class of the same name
            assert (type(g.default).__name__
                    == type(w.default).__name__), (attr, g, w)
            if isinstance(w.default, (int, float, bool, str, type(None))):
                assert g.default == w.default, (attr, g, w)
    extra = [p.name for p in got[len(want):]]
    assert len(got) >= len(want) and set(extra) <= {"device"}, (attr, extra)


def close(got, want, what, tol=1e-12):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(want).all(), what
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * (top if top > 0 else 1.0), what


@pytest.fixture(scope="module")
def case():
    gj = jax_pack(NPX, dtype=jnp.float64)
    gt = build_grid_ops(NPX, dtype=torch.float64, device="cpu")
    _, ptop, ak, bk = set_eta(K)
    ic = jw_baroclinic(gj.geom, K, ak, bk, ptop, perturb=True, moist=True)
    jphis(gj, ic["phis"])
    prepare_phis(gt, ic["phis"])
    return gj, gt, ak, bk, ptop, ic


def test_remaps_take_last_step_positionally(case):
    from gfdl_atmos_cubed_sphere_tpu.model import fv_dynamics as jfvd
    from gfdl_atmos_cubed_sphere_tpu.model.dyn_core import DynConfig as JCfg
    from gfdl_atmos_cubed_sphere_tpu_torch.model import fv_dynamics as fvd
    from gfdl_atmos_cubed_sphere_tpu_torch.model.dyn_core import DynConfig
    gj, gt, ak, bk, ptop, ic = case
    rng = np.random.default_rng(20)
    akap = con.KAPPA
    delp = ic["delp"] * (1 + 0.02 * rng.uniform(-1, 1, ic["delp"].shape))
    pe = ptop + np.concatenate([np.zeros((6, 1, N, N)),
                                np.cumsum(delp, axis=1)], axis=1)

    def pad(x, fill):
        p = np.asarray(gj.halo.pad_cell(jnp.asarray(x)))
        return np.where(np.isfinite(p), p, fill)

    pe_pad = pad(pe, 1.0e5)
    a = dict(delp=delp, ptv=ic["pt"] / 3.0, u=ic["u"], v=ic["v"],
             w=0.05 * rng.standard_normal(delp.shape), delz=ic["delz"],
             ws=0.01 * rng.standard_normal((6, N, N)),
             q={"sphum": ic["sphum"]}, pe_pad=pe_pad,
             peln_pad=np.log(pe_pad),
             pkz=pad(np.exp(akap * np.log(pe[:, 1:])), 27.0))
    cfg = dict(npx=NPX, npz=K, dt=600.0, kord_tm=-9, kord_wz=5)

    def jrun(x, last):
        nh = jfvd.remap_nh(x["delp"], x["ptv"], x["u"], x["v"], x["w"],
                           x["delz"], x["ws"], x["q"], x["pe_pad"],
                           x["peln_pad"], jnp.asarray(ak), jnp.asarray(bk),
                           gj, JCfg(**cfg), akap, last)
        hy = jfvd.remap_hydro(x["delp"], x["ptv"], x["u"], x["v"], x["q"],
                              x["pe_pad"], x["peln_pad"], x["pkz"],
                              jnp.asarray(ak), jnp.asarray(bk), gj,
                              JCfg(**cfg), akap, last)
        return vars(nh), vars(hy)

    J = jax.tree_util.tree_map(jnp.asarray, a)
    T = jax.tree_util.tree_map(torch.as_tensor, a)
    jitted = jax.jit(jrun)        # last_step unread: one compile
    for last in (True, False):
        want = jitted(J, last)
        got = (fvd.remap_nh(T["delp"], T["ptv"], T["u"], T["v"], T["w"],
                            T["delz"], T["ws"], T["q"], T["pe_pad"],
                            T["peln_pad"], torch.as_tensor(ak),
                            torch.as_tensor(bk), gt, DynConfig(**cfg), akap,
                            last),
               fvd.remap_hydro(T["delp"], T["ptv"], T["u"], T["v"], T["q"],
                               T["pe_pad"], T["peln_pad"], T["pkz"],
                               torch.as_tensor(ak), torch.as_tensor(bk), gt,
                               DynConfig(**cfg), akap, last))
        for form, w, g in zip(("remap_nh", "remap_hydro"), want, got):
            for nm in ("delp", "tv", "u", "v", "pkz", "pk2") + (
                    ("w", "delz") if form == "remap_nh" else ()):
                close(getattr(g, nm), w[nm], f"{form} {nm}", 1e-10)
            close(g.q["sphum"], w["q"]["sphum"], f"{form} sphum", 1e-10)


def test_adiabatic_init_cycles(case, monkeypatch):
    """na_init cycles at the nudge weight wt, on a stand-in step that
    depends on the sign of dt (the steps themselves:
    tests/test_torch_solo.py)."""
    from gfdl_atmos_cubed_sphere_tpu.driver.solo import Atmosphere as JAtm
    from gfdl_atmos_cubed_sphere_tpu_torch.driver.solo import Atmosphere
    ja = JAtm(NPX, K, 600.0, dtype="f64")
    ta = Atmosphere(NPX, K, 600.0, dtype="f64", device="cpu")

    def stand_in(atm):
        def build(cfg=None, physics=None):
            sgn = 1.0 if (cfg or atm.cfg).dt > 0 else -1.0

            def step(s, u0, v0):
                return {k: v * (1.0 + 0.01 * sgn) + 0.5 * sgn
                        for k, v in s.items()}
            return step
        return build

    for atm in (ja, ta):
        monkeypatch.setattr(atm, "_build_step", stand_in(atm))
    pt0 = ta.state["pt"].numpy().copy()
    ja.adiabatic_init(na_init=2, wt=2.0)
    ta.adiabatic_init(na_init=2, wt=2.0)
    for k in ("delp", "pt", "u", "v"):
        close(ta.state[k], ja.state[k], f"adiabatic_init {k}")
    assert np.abs(ta.state["pt"].numpy() - pt0).max() > 1e-3


def test_fixers_friction_and_forcings(case):
    from gfdl_atmos_cubed_sphere_tpu.model import fv_dynamics as jfvd
    from gfdl_atmos_cubed_sphere_tpu.model import thermodynamics as jth
    from gfdl_atmos_cubed_sphere_tpu.model.dyn_core import DynConfig as JCfg
    from gfdl_atmos_cubed_sphere_tpu.physics import held_suarez as jhs
    from gfdl_atmos_cubed_sphere_tpu.physics import sim_phys as jsp
    from gfdl_atmos_cubed_sphere_tpu_torch.model import fv_dynamics as fvd
    from gfdl_atmos_cubed_sphere_tpu_torch.model import thermodynamics as th
    from gfdl_atmos_cubed_sphere_tpu_torch.model.dyn_core import DynConfig
    from gfdl_atmos_cubed_sphere_tpu_torch.physics import held_suarez as hs
    from gfdl_atmos_cubed_sphere_tpu_torch.physics import sim_phys as sp
    gj, gt, ak, bk, ptop, ic = case
    rng = np.random.default_rng(21)
    J, T = jnp.asarray, torch.as_tensor
    u, v, delp, pt = ic["u"], ic["v"], ic["delp"], ic["pt"]
    aam0 = np.asarray(jth.compute_aam(J(u), J(v), J(delp), gj, ptop)[0])
    torque = 1.0e3 * rng.standard_normal(aam0.shape)
    u2 = u * 1.001 + 0.01
    want = jth.am_fixer(J(u2), J(v), J(delp), J(aam0), gj, ptop, False,
                        J(torque))
    got = th.am_fixer(T(u2), T(v), T(delp), T(aam0), gt, ptop, False,
                      T(torque))
    for i, (a, b) in enumerate(zip(got, want)):
        close(a, b, f"am_fixer torque [{i}]")
    cfg = dict(npx=NPX, npz=K, dt=900.0, tau=2.0, rf_cutoff=8.0e4)
    pm = ((ak[1:] + ak[:-1]) + (bk[1:] + bk[:-1]) * 1.0e5) * 0.5
    w = 0.1 * rng.standard_normal(delp.shape)
    for hyd in (True, False):
        want = jfvd.rayleigh_friction(J(u), J(v), J(w), J(pt), J(ic["delz"]),
                                      pm, JCfg(**cfg), ptop, gj, hyd, False)
        got = fvd.rayleigh_friction(T(u), T(v), T(w), T(pt), T(ic["delz"]),
                                    pm, DynConfig(**cfg), ptop, gt, hyd,
                                    False)
        for i, (a, b) in enumerate(zip(got, want)):
            close(a, b, f"rayleigh_friction conserve=False {hyd} [{i}]")
        assert np.array_equal(got[3].numpy(), pt)          # no heating
    want = jhs.hs_forcing(J(pt), J(delp), J(u), J(v), gj, ptop, 1800.0,
                          False, 3.0e6)
    got = hs.hs_forcing(T(pt), T(delp), T(u), T(v), gt, ptop, 1800.0, False,
                        3.0e6)
    for i, (a, b) in enumerate(zip(got, want)):
        close(a, b, f"hs_forcing radius [{i}]")
    x = [rng.standard_normal((6, K, N, N)) for _ in range(6)]
    for a, b in zip(sp.fv_nudge(*map(T, x), 600.0, 300.0, 1200.0),
                    jsp.fv_nudge(*map(J, x), 600.0, 300.0, 1200.0)):
        close(a, b, "fv_nudge tau_winds, tau_temp")
    bot = [10.0 * rng.standard_normal((6, N, N)) for _ in range(2)] + [
        280.0 + rng.standard_normal((6, N, N)) for _ in range(2)] + [
        np.full((6, N, N), 30.0), np.full((6, N, N), 1e-3)]
    for a, b in zip(sp.bulk_surface_drag(*map(T, bot)),
                    jsp.bulk_surface_drag(*map(J, bot))):
        close(a, b, "bulk_surface_drag q_bot")


def test_tracer_2d_max_split_and_lim_fac(case):
    from gfdl_atmos_cubed_sphere_tpu.model import tracer_2d as jtr
    from gfdl_atmos_cubed_sphere_tpu_torch.model import tracer_2d as ttr
    gj, gt, *_ = case
    rng = np.random.default_rng(22)
    nc, nw = N + 2 * H, N + 1 + 2 * H
    area = float(np.asarray(gj.area)[0, 0, H, H])
    q = {nm: rng.uniform(0.1, 1.0, (6, K, N, N)) for nm in ("a", "b")}
    args = (rng.uniform(800.0, 2000.0, (6, K, N, N)),
            10.0 * area * rng.standard_normal((6, K, N, N + 1)),
            10.0 * area * rng.standard_normal((6, K, N + 1, N)),
            rng.uniform(-1.4, 1.4, (6, K, nc, nw)),
            rng.uniform(-1.4, 1.4, (6, K, nw, nc)))
    # hord 1: the lim_fac branch of the PPM limiter; max_split 1 caps the
    # adaptive count (2 at these Courant numbers)
    want = jax.jit(lambda q, *a: jtr.tracer_2d(q, *a, gj, 1, 0, 1, 0.5))(
        {k: jnp.asarray(v) for k, v in q.items()},
        *(jnp.asarray(a) for a in args))
    ttr.reset_nsplt()
    got = ttr.tracer_2d({k: torch.as_tensor(v) for k, v in q.items()},
                        *(torch.as_tensor(a) for a in args), gt, 1, 0, 1,
                        0.5)
    assert ttr.nsplt_calls == [1]
    for nm in q:
        close(got[0][nm], want[0][nm], f"tracer_2d {nm}")
    close(got[1], want[1], "tracer_2d dp")


def test_restart_reads_verify_and_names(case, tmp_path):
    from gfdl_atmos_cubed_sphere_tpu.io import diagnostics as jdiag
    from gfdl_atmos_cubed_sphere_tpu.io import native_io as jnio
    from gfdl_atmos_cubed_sphere_tpu.io import restart as jrst
    from gfdl_atmos_cubed_sphere_tpu.model import dyn_core as jdc
    from gfdl_atmos_cubed_sphere_tpu.ops import sw_core as jsw
    from gfdl_atmos_cubed_sphere_tpu_torch.io import diagnostics as diag
    from gfdl_atmos_cubed_sphere_tpu_torch.io import native_io as nio
    from gfdl_atmos_cubed_sphere_tpu_torch.io import restart as rst
    from gfdl_atmos_cubed_sphere_tpu_torch.model import dyn_core as tdc
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import sw_core as tsw
    from gfdl_atmos_cubed_sphere_tpu_torch.utils.timing import Timers
    gj, gt, ak, bk, ptop, ic = case
    # a damaged .npz checkpoint reads with verify_checksums=False
    path = str(tmp_path / "rst.npz")
    rst.save_state(path, {"pt": ic["pt"], "delp": ic["delp"]})
    z = dict(np.load(path))
    z["pt"] = z["pt"] + 1.0
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **z)
    with pytest.raises(ValueError, match="checksum"):
        rst.load_state(bad)
    want, got = jrst.load_state(bad, False), rst.load_state(bad, False)
    for k in want[0]:
        assert np.array_equal(got[0][k], want[0][k]), k
    # a .fvio record with a damaged CRC reads with verify=False
    arr = np.arange(12.0).reshape(3, 4)
    payload = arr.tobytes()
    rec = (struct.pack("<I", 1) + b"a" + struct.pack("<BB", 1, 2)
           + struct.pack("<2Q", 3, 4) + struct.pack("<Q", len(payload))
           + payload + struct.pack("<I", zlib.crc32(payload) ^ 1))
    fv = tmp_path / "bad.fvio"
    fv.write_bytes(b"FVIO\x01\x00\x00\x00" + rec + struct.pack("<I", 0))
    with pytest.raises(ValueError, match="CRC"):
        nio.read_fvio(str(fv))
    assert np.array_equal(nio.read_fvio(str(fv), False)["a"],
                          jnio.read_fvio(str(fv), False)["a"])
    # the names JAX's callers use
    tree = {"a": np.array([1.0, np.nan]), "b": np.ones(2), "c": None}
    assert diag.nan_check(tree=tree) == jdiag.nan_check(tree=tree) == ["a"]
    x = np.random.default_rng(23).uniform(1.0, 2.0, (4, 5, 6))
    for axis in (-1, 0):
        close(tsw.edge_interpolate4(torch.as_tensor(x)[:4] if axis == 0
                                    else torch.as_tensor(x)[..., :4],
                                    torch.as_tensor(x)[:4] if axis == 0
                                    else torch.as_tensor(x)[..., :4],
                                    axis=axis),
              jsw.edge_interpolate4(jnp.asarray(x)[:4] if axis == 0
                                    else jnp.asarray(x)[..., :4],
                                    jnp.asarray(x)[:4] if axis == 0
                                    else jnp.asarray(x)[..., :4], axis=axis),
              f"edge_interpolate4 axis {axis}")
    t = Timers(sync=False, device="cpu")
    with t("A"):
        pass
    assert t.asdict()["A"]["calls"] == 1
    pt_p = gj.halo.pad_cell(jnp.asarray(ic["pt"] / 3.0))
    dp_p = gj.halo.pad_cell(jnp.asarray(ic["delp"]))
    want = jdc.geopk(dp_p, pt_p, gj.phis_p, con.KAPPA, ptop)
    got = tdc.geopk(torch.as_tensor(np.array(dp_p)),
                    torch.as_tensor(np.array(pt_p)), gt.phis_p,
                    con.KAPPA, ptop)
    ctr = slice(H, H + N)
    for i, (a, b) in enumerate(zip(got, want)):
        close(a[..., ctr, ctr], np.asarray(b)[..., ctr, ctr], f"geopk [{i}]")
