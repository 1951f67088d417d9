"""The PyTorch port's GFDL microphysics (physics/gfdl_mp.py) against the
JAX package: the MPConfig defaults the port reads and the mp_coeffs pack
(equal), and the jitted sedimentation, warm_rain, ice_cloud, sat_adjust and
gfdl_mp_driver on seeded [6, 10, 4, 4] columns spanning 178-295 K (float64,
CPU, <= 1e-12 x max per output)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu.physics import gfdl_mp as jmp
from gfdl_atmos_cubed_sphere_tpu.physics import mp_coeffs as jmc
from gfdl_atmos_cubed_sphere_tpu_torch.physics import gfdl_mp as tmp
from gfdl_atmos_cubed_sphere_tpu_torch.physics import mp_coeffs as tmc

pytestmark = pytest.mark.fast

K = 10
SHAPE = (6, K, 4, 4)
TOL = 1e-12
DTS = 450.0
SPECIES = ("qv", "ql", "qr", "qi", "qs", "qg")
NAMES = ("sphum", "liq_wat", "rainwat", "ice_wat", "snowwat", "graupel")


def _columns():
    """A cold-to-warm column (178-295 K, +-1.5 K noise) near saturation,
    with every condensate present, its layer pressures, heights and
    density. The levels keep a few K from the melting point TICE and from
    t_wfr: ice melt and cloud-water freezing that are limited by heat drive
    T onto the threshold itself, and the next comparison with it is then
    decided by the last bit (the jitted JAX step and the eager one differ
    there too)."""
    rng = np.random.default_rng(17)
    t = (np.linspace(178.0, 295.0, K)[None, :, None, None]
         + rng.uniform(-1.5, 1.5, SHAPE))
    delp = rng.uniform(5.0e3, 1.2e4, SHAPE)
    pe = 100.0 + np.concatenate([np.zeros(SHAPE[:1] + (1,) + SHAPE[2:]),
                                 np.cumsum(delp, 1)], 1)
    p_lay = delp / np.diff(np.log(pe), axis=1)
    qsat = np.asarray(jmp.wqs(jnp.asarray(t), jnp.asarray(p_lay))[0])
    c = dict(t=t, delp=delp, p_lay=p_lay,
             qv=qsat * rng.uniform(0.6, 1.2, SHAPE),
             ql=rng.uniform(0.0, 2e-3, SHAPE), qr=rng.uniform(0.0, 1e-3, SHAPE),
             qi=rng.uniform(0.0, 5e-4, SHAPE), qs=rng.uniform(0.0, 1e-3, SHAPE),
             qg=rng.uniform(0.0, 5e-4, SHAPE),
             dz=rng.uniform(300.0, 1500.0, SHAPE),
             w=rng.uniform(-2.0, 2.0, SHAPE))
    c["den"] = delp / (9.80665 * c["dz"])
    c["denfac"] = np.sqrt(1.2 / c["den"])
    return c


@pytest.fixture(scope="module")
def cols():
    return _columns()


def _close(name, want, got):
    w = np.asarray(want)
    g = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert g.shape == w.shape, name
    assert np.isfinite(w).all(), name
    err = np.abs(g - w).max()
    assert err <= TOL * np.abs(w).max(), (name, err, np.abs(w).max())


def _t(a):
    return torch.as_tensor(a)


def test_mp_config_and_coeffs_equal():
    want = dataclasses.asdict(jmp.MPConfig())
    got = dataclasses.asdict(tmp.MPConfig())
    assert got == {k: want[k] for k in got}
    want = vars(jmc.build_coeffs(jmp.MPConfig()))
    got = vars(tmc.build_coeffs(tmp.MPConfig()))
    assert got == want
    assert tmp.MPConfig().t_wfr == jmp.MPConfig().t_wfr


def test_sedimentation(cols):
    keys = ("t",) + SPECIES + ("delp", "dz", "den", "denfac", "w")

    def jrun(t, qv, ql, qr, qi, qs, qg, dp, dz, den, denfac, w):
        out = jmp.sedimentation(t, qv, ql, qr, qi, qs, qg, dp, dz, den,
                                denfac, DTS, jmp.MPConfig(), w=w)
        return out[:6] + (out[8],)

    want = jax.jit(jrun)(*(cols[k] for k in keys))
    got = tmp.sedimentation(*(_t(cols[k]) for k in keys[:-1]), DTS,
                            tmp.MPConfig(), w=_t(cols["w"]))
    for nm, w, g in zip(("t", "qr", "qi", "qs", "qg"), want[:5], got[:5]):
        _close(nm, w, g)
    for sp in ("qr", "qi", "qs", "qg"):
        _close("precip " + sp, want[5][sp], got[5][sp])
    _close("w", want[6], got[6])


def test_warm_rain(cols):
    keys = ("t",) + SPECIES + ("p_lay", "den", "denfac")

    def jrun(*a):
        ccn = jmp.compute_ccn(a[8], jmp.MPConfig())
        return jmp.warm_rain(*a, DTS, jmp.MPConfig(), ccn=ccn)

    want = jax.jit(jrun)(*(cols[k] for k in keys))
    a = [_t(cols[k]) for k in keys]
    got = tmp.warm_rain(*a, DTS, tmp.MPConfig(),
                        ccn=tmp.compute_ccn(a[8], tmp.MPConfig()))
    for nm, w, g in zip(("t", "qv", "ql", "qr"), want, got):
        _close(nm, w, g)


def test_ice_cloud(cols):
    keys = ("t",) + SPECIES + ("p_lay", "den", "denfac")
    want = jax.jit(lambda *a: jmp.ice_cloud(*a, DTS, jmp.MPConfig()))(
        *(cols[k] for k in keys))
    got = tmp.ice_cloud(*(_t(cols[k]) for k in keys), DTS, tmp.MPConfig())
    for nm, w, g in zip(("t",) + SPECIES, want, got):
        _close(nm, w, g)


def test_sat_adjust(cols):
    keys = ("t",) + SPECIES + ("p_lay",)
    want = jax.jit(lambda *a: jmp.sat_adjust(*a, DTS, jmp.MPConfig()))(
        *(cols[k] for k in keys))
    got = tmp.sat_adjust(*(_t(cols[k]) for k in keys), DTS, tmp.MPConfig())
    for nm, w, g in zip(("t",) + SPECIES, want, got):
        _close(nm, w, g)


@pytest.mark.parametrize("hydrostatic", [True, False])
def test_gfdl_mp_driver(cols, hydrostatic):
    q = {nm: cols[sp] for nm, sp in zip(NAMES, SPECIES)}
    q["cld_amt"] = np.zeros(SHAPE)
    delz = -cols["dz"]

    def jrun(pt, delp, delz, q, w):
        return jmp.gfdl_mp_driver(pt, delp, delz, q, 2 * DTS, 100.0,
                                  hydrostatic=hydrostatic, w=w)

    want_t, want_q, want_d = jax.jit(jrun)(cols["t"], cols["delp"], delz, q,
                                           cols["w"])
    got_t, got_q, got_d = tmp.gfdl_mp_driver(
        _t(cols["t"]), _t(cols["delp"]), _t(delz),
        {k: _t(v) for k, v in q.items()}, 2 * DTS, 100.0,
        hydrostatic=hydrostatic, w=_t(cols["w"]))
    _close("pt", want_t, got_t)
    for nm in want_q:
        _close(nm, want_q[nm], got_q[nm])
    assert sorted(got_d) == sorted(want_d)
    for nm in want_d:
        _close(nm, want_d[nm], got_d[nm])


def test_unported_options_raise(cols):
    t = _t(cols["t"])
    q = {nm: _t(cols[sp]) for nm, sp in zip(NAMES, SPECIES)}
    for over in (dict(consv_checker=True), dict(use_subgrid_proc=True),
                 dict(sedflag=2), dict(prog_ccn=True)):
        with pytest.raises(NotImplementedError):
            tmp.gfdl_mp_driver(t, _t(cols["delp"]), -_t(cols["dz"]), q,
                               DTS, 100.0, cfg=tmp.MPConfig(**over))
