"""The PyTorch port's io/diagnostics.py, io/cmip_diag.py and
io/output_bundles.py against the JAX package's (float64, CPU, C12L10, the
seeded moist JW state of torch_slice_inputs):

- fv_diag, nonhydrostatic and hydrostatic: the same fields in the same
  order, registered with the same metadata, each <= 1e-10 x its maximum
  with NaN at the same points (the port computes "aam" directly, the JAX
  package inside a try);
- DiagManager: time averaging, static fields, diag_table selection, and a
  history file with the same variables, read back with scipy;
- parse_diag_table, ColumnDiag, zonal_mean, coarse_diag, consv_checker,
  fv_cmip_diag and the output bundles;
- the audits: prt_maxmin and range_check with the JAX signatures (fac;
  lo, hi), range_check_jit, audit_state, audit_ok, nan_check.

The JAX package's hydrostatic fv_diag reads `gfdl_mp.ZVIR`, which its
gfdl_mp does not define, when it has sphum (io/derived.py layer_heights
and radar_reflectivity); the fixture supplies constants.ZVIR to the
reference for the comparison.

One test function runs every check of this file: with one item the file
queues at the end of a parallel run (xdist --dist loadfile sorts files
by their item count), beside the run's longest files.
"""

import numpy as np
import pytest
import torch

import torch_slice_inputs as si
from gfdl_atmos_cubed_sphere_tpu.io import cmip_diag as jcmip
from gfdl_atmos_cubed_sphere_tpu.io import diagnostics as jd
from gfdl_atmos_cubed_sphere_tpu.io import output_bundles as jbun
from gfdl_atmos_cubed_sphere_tpu_torch.io import cmip_diag as pcmip
from gfdl_atmos_cubed_sphere_tpu_torch.io import diagnostics as pd
from gfdl_atmos_cubed_sphere_tpu_torch.io import output_bundles as pbun

pytestmark = pytest.mark.fast

DIAG_TABLE = """
C12 test run
2020 1 1 0 0 0
# the history files
"atmos_4xdaily", 6, "hours", 1, "days", "time"
"atmos_daily", 24, "hours", 1, "days", "time"
"dynamics", "ps", "ps", "atmos_4xdaily", "all", .false., "none", 2
"dynamics", "slp", "slp", "atmos_4xdaily", "all", .false., "none", 2
"dynamics", "temp", "temp", "atmos_daily", "all", .true., "none", 2
"dynamics", "cape", "cape", "atmos_daily", "all", .false., "none", 2
"""


@pytest.fixture(scope="module")
def case():
    from gfdl_atmos_cubed_sphere_tpu import constants as jcon
    from gfdl_atmos_cubed_sphere_tpu.physics import gfdl_mp as jmp
    gj, gt, ptop, ak, bk, ic = si.packs()
    st, q = si.seeded_state(ic)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmp, "ZVIR", jcon.ZVIR, raising=False)
        yield gj, gt, ptop, ak, bk, st, q


def _same_outputs(got, want, tol, what):
    assert list(got) == list(want), what
    for k in want:
        assert torch.is_tensor(got[k]), (what, k)
        si.close(got[k], want[k], tol, f"{what} {k}")


def _fv_diag_matches_jax(case, form):
    gj, gt, ptop, ak, bk, st, q = case
    hydro = form == "hydrostatic"
    sj = si.jnp_dict(st)
    stp = si.t64_dict(st)
    if hydro:
        for d in (sj, stp):
            d.pop("w"), d.pop("delz")
    dj, dp = jd.DiagManager(), pd.DiagManager()
    want = jd.fv_diag(dj, sj, si.jnp_dict(q), gj, ak, bk, ptop,
                      hydrostatic=hydro)
    got = pd.fv_diag(dp, stp, si.t64_dict(q), gt, ak, bk, ptop,
                     hydrostatic=hydro)
    _same_outputs(got, want, 1e-10, f"fv_diag {form}")
    assert dp._fields == dj._fields
    assert "aam" in got and "aam" in want
    if not hydro:
        assert len(dp._fields) >= 150
    for name in dj._store:
        si.close(dp.series(name), dj.series(name), 1e-10, name)


def _diag_manager_matches_jax(tmp_path):
    from scipy.io import netcdf_file
    rng = np.random.default_rng(3)
    recs = [rng.normal(0.0, 1.0, (6, 4, 4)) for _ in range(4)]
    managers = []
    for mod, conv in ((jd, np.asarray), (pd, torch.as_tensor)):
        dm = mod.DiagManager()
        dm.register("t_avg", "averaged", "K", avg_interval=3)
        dm.register("t_inst", "instant", "K")
        dm.register("oro", "orography", "m", static=True)
        for r in recs:
            for name in ("t_avg", "t_inst", "oro"):
                assert dm.send(name, conv(r))
        assert not dm.send("nope", conv(recs[0]))
        dm.flush_avg()
        managers.append(dm)
    dj, dp = managers
    for name in ("t_avg", "t_inst", "oro"):
        si.close(dp.series(name), dj.series(name), 0.0, name)
    assert dp.series("t_avg").shape[0] == 2 and dp.series("oro").shape[0] == 1

    # diag_table selection: unlisted fields neither register nor send
    sel = pd.parse_diag_table(DIAG_TABLE)["selected"]
    assert sel == jd.parse_diag_table(DIAG_TABLE)["selected"]
    dsel = pd.DiagManager(selection=sel)
    assert dsel.register("ps") == "ps" and dsel.register("u850") is None
    assert dsel.send("ps", torch.ones(6, 4, 4))
    assert not dsel.send("u850", torch.ones(6, 4, 4))

    # a history file: every field with the same number of records
    files = []
    for mod, conv in ((jd, np.asarray), (pd, torch.as_tensor)):
        dm = mod.DiagManager()
        dm.register("t_avg", "averaged", "K", avg_interval=2)
        dm.register("ps", "surface pressure", "Pa")
        for i, r in enumerate(recs):
            dm.send("t_avg", conv(r))
            if i % 2:
                dm.send("ps", conv(r[:, 0]))
        path = str(tmp_path / f"{mod.__name__.split('.')[0]}.nc")
        dm.write_netcdf(path)
        files.append(path)
    with netcdf_file(files[0], "r", mmap=False) as fj, \
            netcdf_file(files[1], "r", mmap=False) as fp:
        assert list(fp.variables) == list(fj.variables)
        assert fp.dimensions == fj.dimensions
        for name, vj in fj.variables.items():
            vp = fp.variables[name]
            assert vp.dimensions == vj.dimensions
            assert np.array_equal(vp[:], vj[:])
            assert (vp.long_name, vp.units) == (vj.long_name, vj.units)


def _column_zonal_and_coarse_diagnostics(case):
    gj, gt, ptop, ak, bk, st, q = case
    pts = [("boulder", -105.27, 40.01), ("equator", 10.0, 0.5),
           ("pole", 0.0, 89.0)]
    cj, cp = jd.ColumnDiag(gj.geom, pts), pd.ColumnDiag(gt.geom, pts)
    assert cp.points == cj.points
    fields = {"pt": st["pt"], "ps": st["delp"].sum(1)}
    lj, lp = [], []
    sj = cj.printout(si.jnp_dict(fields), out=lj.append)
    sp = cp.printout(si.t64_dict(fields), out=lp.append)
    assert lp == lj
    for nm in sj:
        for f in fields:
            si.close(sp[nm][f], sj[nm][f], 0.0, f"column {nm} {f}")

    lat = gt.geom.interior("aglat")
    cj_, mj = jd.zonal_mean(st["pt"], lat, bins=16)
    cp_, mp_ = pd.zonal_mean(torch.as_tensor(st["pt"]), torch.as_tensor(lat),
                             bins=16)
    si.close(cp_, cj_, 0.0, "zonal_mean centres")
    si.close(mp_, mj, 1e-12, "zonal_mean")

    area = gt.geom.interior("area")
    for strategy, ar in (("area", area), ("area", area[:, None]),
                         ("mean", None)):
        dj, dp = jd.DiagManager(), pd.DiagManager()
        flds = ({"ps": st["delp"].sum(1), "tb": st["pt"][:, -1]}
                if ar is not None and ar.ndim == 3
                else {"pt": st["pt"], "w": st["w"]})
        jd.coarse_diag(dj, flds, 2, strategy=strategy, area=ar)
        pd.coarse_diag(dp, si.t64_dict(flds), 2, strategy=strategy,
                       area=None if ar is None else torch.as_tensor(ar))
        assert dp._fields == dj._fields
        for name in dj._store:
            si.close(dp.series(name), dj.series(name), 1e-12,
                     f"coarse_diag {strategy} {name}")


def _consv_checker_matches_jax(case, hydro):
    gj, gt, ptop, ak, bk, st, q = case
    rng = np.random.default_rng(4)
    after = {k: v.copy() for k, v in st.items()}
    after["pt"] = st["pt"] + rng.normal(0.5, 0.5, st["pt"].shape)
    q2 = {k: v * rng.uniform(0.97, 1.0, v.shape) for k, v in q.items()}
    res = []
    for mod, conv, g in ((jd, si.jnp_dict, gj), (pd, si.t64_dict, gt)):
        lines = []
        b = dict(conv(st), q=conv(q))
        a = dict(conv(after), q=conv(q2))
        res.append((mod.consv_checker(b, a, g, ptop, hydrostatic=hydro,
                                      out=lines.append), len(lines)))
        with pytest.raises(AssertionError, match="consv_checker"):
            mod.consv_checker(b, a, g, ptop, hydrostatic=hydro, strict=True)
    (jte, jtw), jn = res[0]
    (pte, ptw), pn = res[1]
    assert pn == jn == 2
    assert abs(pte - jte) <= 1e-10 * jte and abs(ptw - jtw) <= 1e-10 * jtw


def _fv_cmip_diag_and_bundles_match_jax(case, hydro):
    gj, gt, ptop, ak, bk, st, q = case
    sj, stp = si.jnp_dict(st), si.t64_dict(st)
    if hydro:
        for d in (sj, stp):
            d.pop("w"), d.pop("delz")
    dj, dp = jd.DiagManager(), pd.DiagManager()
    want = jcmip.fv_cmip_diag(dj, sj, si.jnp_dict(q), gj, ak, bk, ptop,
                              hydrostatic=hydro)
    got = pcmip.fv_cmip_diag(dp, stp, si.t64_dict(q), gt, ak, bk, ptop,
                             hydrostatic=hydro)
    _same_outputs(got, want, 1e-10, "fv_cmip_diag")
    assert dp._fields == dj._fields
    assert pcmip.PLEV19 == jcmip.PLEV19 and pcmip.SINGLES == jcmip.SINGLES

    nj = jbun.nggps_bundle(sj, si.jnp_dict(q), gj, ptop)
    np_ = pbun.nggps_bundle(stp, si.t64_dict(q), gt, ptop)
    _same_outputs(np_, nj, 1e-12, "nggps_bundle")
    cj = jbun.cmip_bundle(sj, si.jnp_dict(q), gj, ptop)
    cp = pbun.cmip_bundle(stp, si.t64_dict(q), gt, ptop)
    _same_outputs(cp, cj, 1e-12, "cmip_bundle")
    mj = jbun.register_and_send(jd.DiagManager(), nj, prefix="gfs_dyn/")
    mp = pbun.register_and_send(pd.DiagManager(), np_, prefix="gfs_dyn/")
    assert mp._fields == mj._fields


def _audits_take_the_jax_signatures():
    rng = np.random.default_rng(5)
    f = rng.normal(250.0, 30.0, (6, 3, 4, 4))
    lj, lp = [], []
    # fac is the third positional argument, out the fourth
    assert (pd.prt_maxmin("T", torch.as_tensor(f), 0.01, lp.append)
            == jd.prt_maxmin("T", f, 0.01, lj.append))
    assert lp == lj
    for lo, hi in ((None, None), (100.0, 400.0), (200.0, 300.0)):
        assert (pd.range_check("pt", torch.as_tensor(f), lo, hi)
                == jd.range_check("pt", f, lo, hi))
        ok, fmin, fmax = pd.range_check_jit("pt", torch.as_tensor(f), lo, hi)
        jok, jmin, jmax = jd.range_check_jit("pt", f, lo, hi)
        assert (bool(ok), float(fmin), float(fmax)) == (
            bool(jok), float(jmin), float(jmax))
    good = {"pt": torch.full((4, 4), 250.0), "delp": torch.full((4, 4), 5e2),
            "w": None}
    aud = pd.audit_state(good)
    assert set(aud) == {"pt", "delp"} and aud["pt"][0].ndim == 0
    assert bool(pd.audit_ok(aud))
    assert not bool(pd.audit_ok(pd.audit_state(
        dict(good, pt=torch.full((4, 4), 5.0)))))
    bad = {"a": torch.tensor([1.0, float("nan")]), "b": torch.zeros(2),
           "c": None}
    assert pd.nan_check(bad) == jd.nan_check(
        {k: None if v is None else v.numpy() for k, v in bad.items()})


def test_diagnostics_match_jax(case, tmp_path):
    """Every check of the module docstring."""
    for form in ("nonhydrostatic", "hydrostatic"):
        _fv_diag_matches_jax(case, form)
        _fv_cmip_diag_and_bundles_match_jax(case, form == "hydrostatic")
    _diag_manager_matches_jax(tmp_path)
    assert pd.parse_diag_table(DIAG_TABLE) == jd.parse_diag_table(DIAG_TABLE)
    _column_zonal_and_coarse_diagnostics(case)
    _audits_take_the_jax_signatures()
    for hydro in (True, False):
        _consv_checker_matches_jax(case, hydro)
