"""The PyTorch port's negative-moisture adjustment (ops/fv_sg.py neg_adj3,
with its phase fixes, fillq and the water-vapour column borrow) against
the jitted JAX neg_adj3 on seeded [6, 10, 4, 4] states in which every
species has negative points, hydrostatic and nonhydrostatic, called as
JAX's fv_dynamics_nh calls it (delz, peln); and the 2-dz convective
adjustments fv_sg_adjust and fv_sg_adjust_am5 (float64, CPU, <= 1e-12 x
max per output)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu.ops import fv_sg as jsg
from gfdl_atmos_cubed_sphere_tpu_torch.ops import fv_sg as tsg

pytestmark = pytest.mark.fast

SHAPE = (6, 10, 4, 4)
TOL = 1e-12
NAMES = ("sphum", "liq_wat", "rainwat", "ice_wat", "snowwat", "graupel",
         "cld_amt")


def _state(seed):
    rng = np.random.default_rng(seed)
    scale = {"sphum": 1e-2, "liq_wat": 1e-3, "rainwat": 5e-4,
             "ice_wat": 5e-4, "snowwat": 5e-4, "graupel": 2e-4,
             "cld_amt": 1.0}
    # about a third of the points of each species negative
    q = {nm: s * rng.uniform(-0.5, 1.0, SHAPE) for nm, s in scale.items()}
    pt = rng.uniform(200.0, 300.0, SHAPE)
    delp = rng.uniform(500.0, 3000.0, SHAPE)
    delz = -rng.uniform(100.0, 1000.0, SHAPE)
    return pt, delp, delz, q


@pytest.mark.parametrize("hydrostatic", [True, False])
def test_neg_adj3(hydrostatic):
    """Called as JAX's fv_dynamics_nh calls it (delz, and peln), which
    neither package reads."""
    pt, delp, delz, q = _state(3 + hydrostatic)
    peln = np.log(np.cumsum(delp, 1) + 100.0)
    want_pt, want_q = jax.jit(lambda a, b, c, d, e: jsg.neg_adj3(
        a, b, d, delz=c, peln=e, hydrostatic=hydrostatic))(pt, delp, delz,
                                                           q, peln)
    t = torch.as_tensor
    got_pt, got_q = tsg.neg_adj3(t(pt), t(delp),
                                 {k: t(v) for k, v in q.items()},
                                 delz=t(delz), peln=t(peln),
                                 hydrostatic=hydrostatic)
    bare_pt, _ = tsg.neg_adj3(t(pt), t(delp), {k: t(v) for k, v in q.items()},
                              hydrostatic=hydrostatic)
    assert torch.equal(got_pt, bare_pt)
    pairs = [("pt", want_pt, got_pt)] + [(nm, want_q[nm], got_q[nm])
                                          for nm in NAMES]
    for nm, w, g in pairs:
        w = np.asarray(w)
        assert np.isfinite(w).all(), nm
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= TOL, (nm, err)
    # the adjustment removed most negatives
    assert (np.asarray(want_q["graupel"]) < 0).sum() < (q["graupel"] < 0).sum()


def _sg_state(seed, hydrostatic):
    """A column state for the 2-dz adjustment: the interface pressures
    from a 100 Pa top, the gas-law or hydrostatic pkz, temperatures with
    unstable pairs, A-grid winds and the six tracers (no negatives)."""
    rng = np.random.default_rng(seed)
    pt, delp, delz, q = _state(seed)
    q = {k: np.abs(v) for k, v in q.items() if k != "cld_amt"}
    delp = delp * 10.0                    # 5-30 hPa layers, to ~1000 hPa
    pe = 100.0 + np.concatenate([np.zeros((6, 1, 4, 4)),
                                 np.cumsum(delp, 1)], 1)
    peln = np.log(pe)
    pk = pe ** jsg.con.KAPPA
    pkz = (pk[:, 1:] - pk[:, :-1]) / (jsg.con.KAPPA
                                        * (peln[:, 1:] - peln[:, :-1]))
    ua = rng.uniform(-20.0, 20.0, SHAPE)
    va = rng.uniform(-20.0, 20.0, SHAPE)
    w = None if hydrostatic else rng.uniform(-1.0, 1.0, SHAPE)
    return dict(delp=delp, pe=pe, peln=peln, pkz=pkz, ta=pt, q=q, ua=ua,
                va=va, w=w, delz=None if hydrostatic else delz)


ADJUST_OUT = ("ta", "q", "ua", "va", "w", "u_dt", "v_dt")


@pytest.mark.parametrize("variant", ["shield", "am5", "am5 k_bot 7"])
@pytest.mark.parametrize("hydrostatic", [True, False])
def test_fv_sg_adjust(variant, hydrostatic):
    """fv_sg_adjust (fv_sg_SHiELD at fv_sg_adj = 600 s) and
    fv_sg_adjust_am5 (tau = 600 s, with and without k_bot) on a 450 s
    step, against the JAX functions run eagerly (jitting their K x m
    Python loops of whole-field updates took 5-10 s a case)."""
    st = _sg_state(11 + hydrostatic, hydrostatic)
    kw = dict(hydrostatic=hydrostatic)
    if variant == "am5 k_bot 7":
        kw["k_bot"] = 7
    name = "fv_sg_adjust" if variant == "shield" else "fv_sg_adjust_am5"

    def run(m, s):
        return getattr(m, name)(450.0, 600, s["delp"], s["pe"], s["peln"],
                                s["pkz"], s["ta"], s["q"], s["ua"],
                                s["va"], w=s["w"], delz=s["delz"], **kw)

    want = run(jsg, jax.tree_util.tree_map(jnp.asarray, st))
    t = torch.as_tensor
    got = run(tsg, {k: (None if v is None else
                        {n: t(a) for n, a in v.items()}
                        if isinstance(v, dict) else t(v))
                    for k, v in st.items()})
    moved = 0.0
    for nm, w, g in zip(ADJUST_OUT, want, got):
        if w is None:
            assert g is None, nm
            continue
        pairs = ([(f"q {k}", w[k], g[k]) for k in w] if nm == "q"
                 else [(nm, w, g)])
        for what, a, b in pairs:
            a = np.asarray(a)
            assert np.isfinite(a).all(), what
            err = np.abs(b.numpy() - a).max() / np.abs(a).max()
            assert err <= TOL, (what, err)
        if nm == "ta":
            moved = np.abs(np.asarray(w) - st["ta"]).max()
    assert moved > 1e-3          # the adjustment mixed some pairs
