"""The PyTorch port's SHiELD and GFDL facades (driver/shield.py,
driver/gfdl.py) against the JAX package's (CPU, float64, C12L10): both
objects hold the same seeded moist JW state (torch_slice_inputs) and
every query routine is compared without stepping the JAX one (<= 1e-10
x each output's maximum, NaN at the same points; host-geometry queries
equal). The port's atmosphere_dynamics(1) is bit-equal to the solo
driver's atmosphere(1), and its atmosphere_nggps_diag is the port's
fv_diag of the state (fv_diag itself is held against JAX's in
test_torch_diagnostics.py). The facades default to the card.

One test function runs every check of this file: with one item the file
queues at the end of a parallel run (xdist --dist loadfile sorts files
by their item count), beside the run's longest files.
"""

import numpy as np
import pytest
import torch

import torch_slice_inputs as si
from gfdl_atmos_cubed_sphere_tpu.driver.gfdl import GFDLAtmosphere as JGFDL
from gfdl_atmos_cubed_sphere_tpu_torch.driver.gfdl import GFDLAtmosphere
from gfdl_atmos_cubed_sphere_tpu_torch.driver.shield import ShieldAtmosphere
from gfdl_atmos_cubed_sphere_tpu_torch.driver.solo import Atmosphere

pytestmark = pytest.mark.fast

TOL = 1e-10
NH = dict(k_split=1, n_split=2)


@pytest.fixture(scope="module")
def pair():
    import jax.numpy as jnp
    gj, gt, ptop, ak, bk, ic = si.packs()
    st, q = si.seeded_state(ic)
    jatm = JGFDL(si.NPX, si.K, 600.0, dtype="f64", hydrostatic=False,
                 cfg_overrides=NH)
    patm = GFDLAtmosphere(si.NPX, si.K, 600.0, dtype="f64",
                          hydrostatic=False, cfg_overrides=NH, device="cpu",
                          geom=gt.geom)
    jatm.state = {k: jnp.asarray(v) for k, v in st.items()}
    jatm.tracers = si.jnp_dict(q)
    patm.state = si.t64_dict(st)
    patm.tracers = si.t64_dict(q)
    return jatm, patm, st, q


def _same(got, want, what, tol=TOL):
    if isinstance(want, dict):
        assert list(got) == list(want), what
        for k in want:
            _same(got[k], want[k], f"{what} {k}", tol)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{what}[{i}]", tol)
    elif want is None or isinstance(want, (bool, int, float, str)):
        assert got == want, (what, got, want)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), what
        assert np.array_equal(got, want, equal_nan=True), what
    else:
        assert torch.is_tensor(got) and got.device.type == "cpu", what
        si.close(got, want, tol, what)


def _query_routines_match_jax(pair):
    jatm, patm, st, q = pair
    pt = st["pt"]
    calls = [
        ("atmos_phys_driver_statein", ()),
        ("get_bottom_wind", ()), ("get_bottom_mass", ()),
        ("atmosphere_resolution", ()), ("atmosphere_grid_ctr", ()),
        ("atmosphere_pref", ()), ("atmosphere_control_data", ()),
        ("atmosphere_grid_bdry", ()), ("atmosphere_etalvls", ()),
        ("atmosphere_etalvls", (True,)), ("atmosphere_diss_est", ()),
        ("atmosphere_coarse_graining_parameters", ()),
        ("atmosphere_coarsening_strategy", ()), ("atmosphere_domain", ()),
        ("atmos_physics_driver_inputs", ()),
        ("atmos_radiation_driver_inputs", ()),
    ]
    for pos in ("lay", "int"):
        for rel in (True, False):
            for flip in (False, True):
                calls.append(("atmosphere_hgt", (pos, rel, flip)))
    for name, args in calls:
        _same(getattr(patm, name)(*args), getattr(jatm, name)(*args),
              f"{name}{args}")
    for halo in (3, 2):
        _same(patm.atmosphere_scalar_field_halo(torch.as_tensor(pt), halo),
              jatm.atmosphere_scalar_field_halo(pt, halo), f"halo {halo}")
    with pytest.raises(ValueError, match="halo"):
        patm.atmosphere_scalar_field_halo(torch.as_tensor(pt), 4)
    qb = {"sphum": q["sphum"], "liq_wat": q["liq_wat"]}
    qa = {"sphum": q["sphum"] * 1.01, "liq_wat": q["liq_wat"] * 0.5}
    _same(patm.atmos_phys_qdt_diag(si.t64_dict(qb), si.t64_dict(qa), 600.0),
          jatm.atmos_phys_qdt_diag(si.jnp_dict(qb), si.jnp_dict(qa), 600.0),
          "atmos_phys_qdt_diag")


def _state_update_and_nggps_diag(pair):
    from gfdl_atmos_cubed_sphere_tpu_torch.io.diagnostics import (
        DiagManager, fv_diag)
    jatm, patm, st, q = pair
    rng = np.random.default_rng(9)
    cell = st["pt"].shape
    u_dt, v_dt = rng.normal(0.0, 1e-4, cell), rng.normal(0.0, 1e-4, cell)
    t_dt = np.full(cell, 1.0 / 86400.0) + rng.normal(0.0, 1e-6, cell)
    q_dt = {"sphum": rng.normal(0.0, 1e-9, cell)}
    import jax.numpy as jnp
    jatm.atmosphere_state_update(jnp.asarray(u_dt), jnp.asarray(v_dt),
                                 jnp.asarray(t_dt), si.jnp_dict(q_dt))
    patm.atmosphere_state_update(*(torch.as_tensor(a)
                                   for a in (u_dt, v_dt, t_dt)),
                                 si.t64_dict(q_dt))
    for k in ("pt", "u", "v", "delp", "w", "delz"):
        _same(patm.state[k], jatm.state[k], f"state {k}")
    _same(patm.tracers, jatm.tracers, "tracers")
    _same(patm.atmos_physics_driver_inputs(),
          jatm.atmos_physics_driver_inputs(), "inputs after the update")
    dm, out = patm.atmosphere_nggps_diag()
    ref = fv_diag(DiagManager(), dict(patm.state), patm.tracers, patm.g,
                  patm.ak, patm.bk, patm.ptop, hydrostatic=False)
    assert list(out) == list(ref) and len(dm._fields) >= 150
    for k in ref:
        assert torch.equal(out[k].nan_to_num(), ref[k].nan_to_num()), k
    dm2 = DiagManager(selection={"ps", "cape"})
    assert patm.atmosphere_nggps_diag(dm2)[0] is dm2
    assert set(dm2._fields) == {"ps", "cape"}


def _dynamics_equals_solo_step_and_defaults_to_the_card():
    kw = dict(dtype="f64", hydrostatic=False, cfg_overrides=NH,
              device="cpu")
    solo = Atmosphere(si.NPX, si.K, 600.0, **kw)
    facade = ShieldAtmosphere(si.NPX, si.K, 600.0, geom=solo.g.geom, **kw)
    solo.atmosphere(1)
    facade.atmosphere_dynamics(1)
    assert facade.physics == "none" and facade.step_count == 1
    for k, v in solo.state.items():
        assert torch.equal(facade.state[k], v), k
    if not torch.cuda.is_available():
        for cls in (ShieldAtmosphere, GFDLAtmosphere):
            with pytest.raises(RuntimeError, match="CUDA"):
                cls(si.NPX, si.K, 600.0, geom=solo.g.geom)


def test_facades_match_jax(pair):
    """Every check of the module docstring; the queries first, on the
    state before the update."""
    _query_routines_match_jax(pair)
    _state_update_and_nggps_diag(pair)
    _dynamics_equals_solo_step_and_defaults_to_the_card()
