"""The PyTorch port's GFDL microphysics (physics/gfdl_mp.py) against the
JAX package: the MPConfig defaults the port reads and the mp_coeffs pack
(equal), and the jitted sedimentation, warm_rain, ice_cloud, sat_adjust and
gfdl_mp_driver on seeded [6, 10, 4, 4] columns spanning 178-295 K (float64,
CPU, <= 1e-12 x max per output); likewise every process of the fast chain
(pimlt ... pinst, the JAX references eager), mp_fast,
subgrid_z_proc, fast_sat_adj with and without use_mp_fast,
explicit_fall, sedi_uv, compute_ccn with prog_ccn and hs, mte_column, and
gfdl_mp_driver with every option the port once refused (OPTIONS)."""

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
    assert got[6] is None and got[7] is None      # no ua, va given
    for nm, w, g in zip(("t", "qr", "qi", "qs", "qg"), want[:5], got[:5]):
        _close(nm, w, g)
    for sp in ("qr", "qi", "qs", "qg"):
        _close("precip " + sp, want[5][sp], got[5][sp])
    _close("w", want[6], got[8])


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




# ---- the fast chain and the options the port once refused ------------------

DTF = 60.0          # an acoustic step of the inline fast physics
RH_ADJ = 0.9
#: gfdl_mp_driver's options beyond the defaults: the per-process
#: saturation stage with instant evaporation below 90 % RH, explicit
#: sedimentation, prognostic CCN, the energy and water audits and
#: sedimentation of the horizontal winds
OPTIONS = dict(use_subgrid_proc=True, rh_adj=RH_ADJ, sedflag=2,
               prog_ccn=True, consv_checker=True, do_sedi_uv=True)
#: the process variants beyond MPConfig(): {label: (process, settings)}
PROCESSES = {
    "pimlt": ("pimlt", {}), "pcomp": ("pcomp", {}),
    "pcond_pevap": ("pcond_pevap", {}),
    "pcond_pevap timescales": ("pcond_pevap", dict(
        do_evap_timescale=False, do_cond_timescale=True,
        use_rhc_cevap=True)),
    "pifr": ("pifr", {}), "pwbf": ("pwbf", dict(do_wbf=True)),
    "pbigg": ("pbigg", {}), "pgfr_simp": ("pgfr_simp", {}),
    "psmlt_simp": ("psmlt_simp", {}), "praut_simp": ("praut_simp", {}),
    "pidep_pisub": ("pidep_pisub", {}),
    **{f"pidep_pisub inflag {i} igflag {j}": (
        "pidep_pisub", dict(inflag=i, igflag=j))
       for i, j in ((2, 1), (3, 2), (4, 4), (5, 3))},
    "psdep_pssub": ("psdep_pssub", {}), "pgdep_pgsub": ("pgdep_pgsub", {}),
    "psaut_simp": ("psaut_simp", {}), "pinst": ("pinst", {}),
}
#: the chains and column operators, each with its settings
CHAINS = {
    "mp_fast": {}, "mp_fast wbf nconds 2": dict(do_wbf=True, nconds=2),
    "subgrid_z_proc": {}, "fast_sat_adj": {},
    "fast_sat_adj sat_adjust": dict(use_mp_fast=False),
    "explicit_fall": {}, "sedi_uv": {}, "compute_ccn prog_ccn hs":
    dict(prog_ccn=True), "compute_ccn hs": {}, "mte_column": {},
}


def _run_process(m, name, c, cfg):
    """One fast-chain process of module m (the JAX package's or the
    port's) on the columns c: (t, qv, ql, qr, qi, qs, qg)."""
    st = m._st_init(*(c[k] for k in ("t",) + SPECIES), cfg.t_wfr)
    den = c["den"]
    extra = {
        "pimlt": (DTF,), "pcomp": (), "pcond_pevap": (DTF, den),
        "pifr": (den,), "pwbf": (DTF, den),
        "pbigg": (DTF, den, m.compute_ccn(den, cfg)),
        "pgfr_simp": (DTF,), "psmlt_simp": (DTF,), "praut_simp": (DTF,),
        "pidep_pisub": (DTF, den, None),
        "psdep_pssub": (DTF, den, c["denfac"]),
        "pgdep_pgsub": (DTF, den, c["denfac"]),
        "psaut_simp": (DTF, den), "pinst": (den, RH_ADJ)}[name]
    st = getattr(m, name)(st, *extra, cfg)
    return tuple(st[k] for k in ("t",) + SPECIES)


def _run_chain(m, label, c, cfg):
    """One chain or column operator of module m on the columns c: a tuple
    of outputs (None for an output the operator leaves out)."""
    args = [c[k] for k in ("t",) + SPECIES]
    den, denfac = c["den"], c["denfac"]
    if label.startswith("mp_fast"):
        return m.mp_fast(*args, DTF, c["delp"], den, denfac, cfg,
                         ccn=m.compute_ccn(den, cfg))
    if label == "subgrid_z_proc":
        return m.subgrid_z_proc(*args, c["delp"], den, denfac, DTS, cfg,
                                rh_adj=RH_ADJ, ccn=m.compute_ccn(den, cfg))
    if label.startswith("fast_sat_adj"):
        # graupel left out: only the categories given come back
        q = {nm: c[sp] for nm, sp in zip(NAMES[:-1], SPECIES[:-1])}
        t, q = m.fast_sat_adj(c["t"], c["delp"], -c["dz"], q, DTF, 100.0,
                              cfg=cfg)
        assert "graupel" not in q
        return (t,) + tuple(q[nm] for nm in NAMES[:-1])
    vt = m.terminal_velocity("qr", c["qr"], den, denfac, cfg)
    if label == "explicit_fall":
        return m.explicit_fall(c["qr"], vt, c["dz"], c["delp"], DTS)
    if label == "sedi_uv":
        _, _, m1 = m.implicit_fall(c["qs"], vt, c["dz"], c["delp"], DTS)
        return m.sedi_uv(m1, c["delp"], c["ua"], c["va"])
    if label.startswith("compute_ccn"):
        return (m.compute_ccn(den, cfg, hs=c["hs"], qnl=c["qnl"]),)
    return m.mte_column(*args, c["delp"], u=c["ua"], v=c["va"], w=c["w"])


@pytest.fixture(scope="module")
def fast_cols(cols):
    """The columns with seeded A-grid winds, surface geopotential (land
    fractions 0-1 and clipped) and aerosol number."""
    rng = np.random.default_rng(29)
    return dict(cols, ua=rng.uniform(-30.0, 30.0, SHAPE),
                va=rng.uniform(-30.0, 30.0, SHAPE),
                hs=rng.uniform(0.0, 200.0, (6, 4, 4)),
                qnl=rng.uniform(1e-11, 1e-8, SHAPE))


@pytest.fixture(scope="module")
def fast_want(fast_cols):
    """Every process and chain of the JAX package, run eagerly (their op
    compiles are shared; one jitted call of them all took longer)."""
    def run(c):
        out = {}
        for label, (name, over) in PROCESSES.items():
            out[label] = _run_process(jmp, name, c,
                                      jmp.MPConfig(**over))
        for label, over in CHAINS.items():
            out[label] = _run_chain(jmp, label, c, jmp.MPConfig(**over))
        return out
    return run(jax.tree_util.tree_map(jnp.asarray, fast_cols))


@pytest.mark.parametrize("label", list(PROCESSES))
def test_fast_process(fast_cols, fast_want, label):
    name, over = PROCESSES[label]
    got = _run_process(tmp, name, {k: _t(v) for k, v in fast_cols.items()},
                       tmp.MPConfig(**over))
    for nm, w, g in zip(("t",) + SPECIES, fast_want[label], got):
        _close(f"{label} {nm}", w, g)


@pytest.mark.parametrize("label", list(CHAINS))
def test_fast_chain(fast_cols, fast_want, label):
    got = _run_chain(tmp, label, {k: _t(v) for k, v in fast_cols.items()},
                     tmp.MPConfig(**CHAINS[label]))
    assert len(got) == len(fast_want[label])
    for i, (w, g) in enumerate(zip(fast_want[label], got)):
        _close(f"{label} output {i}", w, g)


#: the audits' relative errors, (end - begin) / begin of column sums
AUDIT_ERRORS = ("te_err", "tw_err")


def _driver_case(c):
    """gfdl_mp_driver's arguments on the columns: the tracers with
    cld_amt and liq_aero, delz, w, ua, va and hs."""
    q = {nm: c[sp] for nm, sp in zip(NAMES, SPECIES)}
    q["cld_amt"] = c["t"] * 0.0
    q["liq_aero"] = c["qnl"]
    return (c["t"], c["delp"], -c["dz"], q), dict(
        w=c["w"], ua=c["ua"], va=c["va"], hs=c["hs"])


def test_unported_options_raise(fast_cols):
    """gfdl_mp_driver with every option the port once refused (OPTIONS;
    the test keeps the name it had then, when it asserted the refusal):
    the per-process saturation stage, explicit sedimentation, prognostic
    CCN, the audits and the sedimentation of ua, va, whose lost kinetic
    energy heats t, against the JAX package."""
    def jrun(c):
        a, kw = _driver_case(c)
        return jmp.gfdl_mp_driver(*a, 2 * DTS, 100.0,
                                  cfg=jmp.MPConfig(**OPTIONS), **kw)

    want_t, want_q, want_d = jrun(jax.tree_util.tree_map(jnp.asarray,
                                                          fast_cols))
    a, kw = _driver_case({k: _t(v) for k, v in fast_cols.items()})
    got_t, got_q, got_d = tmp.gfdl_mp_driver(*a, 2 * DTS, 100.0,
                                             cfg=tmp.MPConfig(**OPTIONS),
                                             **kw)
    _close("pt", want_t, got_t)
    assert sorted(got_q) == sorted(want_q)
    for nm in want_q:
        _close(nm, want_q[nm], got_q[nm])
    assert sorted(got_d) == sorted(want_d)
    assert {"ua", "va", "te_err", "tw_err", "w"} <= set(got_d)
    for nm in want_d:
        if nm in AUDIT_ERRORS:
            # (end - begin) / begin of column sums that agree to ~1e-16:
            # rounding noise, held against the scale of its terms (1)
            err = np.abs(got_d[nm].numpy() - np.asarray(want_d[nm])).max()
            assert err <= TOL, (nm, err)
        else:
            _close(nm, want_d[nm], got_d[nm])
    # sedimentation moved the winds
    assert float((got_d["ua"] - kw["ua"]).abs().max()) > 0.0
