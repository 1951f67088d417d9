"""The PyTorch port's leaf modules against the JAX package's (CPU,
float64 unless stated): utils/tracer_registry.py, utils/time_manager.py,
model/fv_arrays.py (AtmosState and its checksums: the same integers as
JAX's in float32 and float64), model/init_hydro.py (p_var, hydro_eq,
<= 1e-12 x each output's maximum) and init/tracers.py (checker_tracer,
equal).

One test function runs every check of this file: with one item the file
queues at the end of a parallel run (xdist --dist loadfile sorts files
by their item count), beside the run's longest files.
"""

import numpy as np
import pytest
import torch

import torch_slice_inputs as si
from gfdl_atmos_cubed_sphere_tpu.init import tracers as jtracers
from gfdl_atmos_cubed_sphere_tpu.model import fv_arrays as jfa
from gfdl_atmos_cubed_sphere_tpu.model import init_hydro as jih
from gfdl_atmos_cubed_sphere_tpu.utils import time_manager as jtm
from gfdl_atmos_cubed_sphere_tpu.utils import tracer_registry as jtr
from gfdl_atmos_cubed_sphere_tpu_torch.init import tracers as ptracers
from gfdl_atmos_cubed_sphere_tpu_torch.model import fv_arrays as pfa
from gfdl_atmos_cubed_sphere_tpu_torch.model import init_hydro as pih
from gfdl_atmos_cubed_sphere_tpu_torch.utils import time_manager as ptm
from gfdl_atmos_cubed_sphere_tpu_torch.utils import tracer_registry as ptr

pytestmark = pytest.mark.fast


def _tracer_registry_matches_jax():
    import jax.numpy as jnp
    for kw in (dict(nwat=6), dict(nwat=2, extras=("o3mr", "age")),
               dict(nwat=4, with_cld_amt=False)):
        rj, rp = jtr.default_registry(**kw), ptr.default_registry(**kw)
        assert rp.names == rj.names and rp.nwat == rj.nwat
        assert rp.water_names() == rj.water_names()
        assert rp.get_number_tracers() == rj.get_number_tracers()
        for n in rj.names + ("nope",):
            assert rp.get_tracer_index(n) == rj.get_tracer_index(n)
            assert (n in rp) == (n in rj)
        for n in rj.names:
            assert vars(rp[n]) == vars(rj[n])
        shape = (6, 10, 4, 4)
        sph = np.full(shape, 1e-3)
        qj = rj.init_tracers(shape, dtype=jnp.float64,
                             sphum=jnp.asarray(sph))
        qp = rp.init_tracers(shape, dtype=torch.float64, device="cpu",
                             sphum=torch.as_tensor(sph))
        assert list(qp) == list(qj)
        for n in qj:
            assert qp[n].dtype == torch.float64
            si.close(qp[n], qj[n], 1e-12, n)
        for n in rj.names:
            si.close(rp.set_tracer_profile(n, shape, dtype=torch.float64,
                                           device="cpu"),
                     rj.set_tracer_profile(n, shape, dtype=jnp.float64),
                     1e-12, f"profile {n}")


def _time_manager_matches_jax():
    for s, d in ((86399, 1), (2, 0), (450, 3), (-5, 2)):
        assert ptm.get_time(ptm.set_time(s, d)) == jtm.get_time(
            jtm.set_time(s, d))
    dt_p, dt_j = ptm.set_time(seconds=450), jtm.set_time(seconds=450)
    assert (192 * dt_p).total_seconds() == (192 * dt_j).total_seconds()
    assert ((dt_p * 3 - ptm.set_time(100)).total_seconds()
            == (dt_j * 3 - jtm.set_time(100)).total_seconds())
    for cal in (ptm.JULIAN, ptm.NOLEAP, ptm.THIRTY_DAY):
        for date in ((2000, 2, 28, 12, 30, 15), (2001, 12, 31, 23, 59, 59),
                     (1900, 3, 1, 0, 0, 0)):
            if cal == ptm.THIRTY_DAY and date[2] > 30:
                continue
            tp = ptm.set_date(*date, calendar=cal)
            tj = jtm.set_date(*date, calendar=cal)
            assert (tp.days, tp.seconds) == (tj.days, tj.seconds)
            assert ptm.get_date(tp, calendar=cal) == jtm.get_date(
                tj, calendar=cal) == date
        for y in (1900, 2000, 2001, 2004):
            assert ptm.days_in_year(y, cal) == jtm.days_in_year(y, cal)
            assert [ptm.days_in_month(y, m, cal) for m in range(1, 13)] == [
                jtm.days_in_month(y, m, cal) for m in range(1, 13)]
    ap, aj = ptm.Alarm(ptm.set_time(3600)), jtm.Alarm(jtm.set_time(3600))
    for s in (3599, 3600, 7199, 7200, 11000):
        assert ap.is_ringing(ptm.set_time(s)) == aj.is_ringing(
            jtm.set_time(s))
        ap.reset(ptm.set_time(s))
        aj.reset(jtm.set_time(s))


def _atmos_state_checksums_equal_jax(dtype):
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    cell = (6, 3, 5, 5)
    arrays = dict(delp=rng.uniform(5e2, 2e3, cell),
                  pt=rng.normal(250.0, 30.0, cell),
                  u=rng.normal(0.0, 20.0, (6, 3, 6, 5)),
                  v=rng.normal(0.0, 20.0, (6, 3, 5, 6)),
                  w=rng.normal(0.0, 1.0, cell),
                  ps=rng.normal(1e5, 1e3, (6, 5, 5)))
    arrays = {k: a.astype(dtype) for k, a in arrays.items()}
    q = {"sphum": rng.uniform(0.0, 1e-2, cell).astype(dtype),
         "o3mr": -rng.uniform(0.0, 1e-6, cell).astype(dtype)}
    sj = jfa.AtmosState.from_dict(dict(
        {k: jnp.asarray(a) for k, a in arrays.items()},
        q={k: jnp.asarray(a) for k, a in q.items()}, bogus=1))
    sp = pfa.AtmosState.from_dict(dict(
        {k: torch.as_tensor(a) for k, a in arrays.items()},
        q={k: torch.as_tensor(a) for k, a in q.items()}, bogus=1))
    cj, cp = sj.checksum(), sp.checksum()
    assert cp == cj and all(isinstance(v, int) for v in cp.values())
    assert list(cp) == list(cj)
    assert sp.to_dict().keys() == sj.to_dict().keys()
    assert (sp.to_dict(include_none=True).keys()
            == sj.to_dict(include_none=True).keys())
    assert not sp.hydrostatic and sp.replace(w=None).hydrostatic
    assert pfa.PROGNOSTIC == jfa.PROGNOSTIC
    assert pfa.AUXILIARY == jfa.AUXILIARY
    ints = rng.integers(-9, 9, (4, 4)).astype(np.int32)
    assert pfa._chksum(torch.as_tensor(ints)) == jfa._chksum(
        jnp.asarray(ints))


def _init_hydro_and_checker_tracer_match_jax():
    import jax.numpy as jnp
    gj, gt, ptop, ak, bk, ic = si.packs()
    st, q = si.seeded_state(ic)
    J, T = si.jnp_dict, si.t64_dict
    area = gt.geom.interior("area")
    for kw in (dict(), dict(hydrostatic=False), dict(make_nh=True),
               dict(adjust_dry_mass=True), dict(hydrostatic=False,
                                                delz=True)):
        jkw, pkw = dict(kw), dict(kw)
        if kw.get("adjust_dry_mass"):
            jkw["area"], pkw["area"] = jnp.asarray(area), torch.as_tensor(
                area)
        if kw.get("delz"):
            jkw["delz"] = jnp.asarray(st["delz"])
            pkw["delz"] = torch.as_tensor(st["delz"])
        want = jih.p_var(jnp.asarray(st["delp"]), jnp.asarray(st["pt"]),
                         ptop, q=J(q), **jkw)
        got = pih.p_var(torch.as_tensor(st["delp"]),
                        torch.as_tensor(st["pt"]), ptop, q=T(q), **pkw)
        assert list(got) == list(want), kw
        for k in want:
            si.close(got[k], want[k], 1e-12, f"p_var {kw} {k}")
    phis = np.asarray(ic["phis"])
    want = jih.hydro_eq(10, 1.0e5, jnp.asarray(phis), ak, bk, ptop)
    got = pih.hydro_eq(10, 1.0e5, torch.as_tensor(phis), ak, bk, ptop)
    for k, a, b in zip(("delp", "pt", "ps"), got, want):
        si.close(a, b, 1e-12, f"hydro_eq {k}")
    for nx, ny in ((9.0, 9.0), (3.0, 5.0)):
        assert np.array_equal(
            ptracers.checker_tracer(gt.geom, 10, nx, ny),
            jtracers.checker_tracer(gj.geom, 10, nx, ny))


def test_leaf_modules_match_jax():
    """Every check of the module docstring."""
    _tracer_registry_matches_jax()
    _time_manager_matches_jax()
    for dtype in ("float32", "float64"):
        _atmos_state_checksums_equal_jax(dtype)
    _init_hydro_and_checker_tracer_match_jax()
