"""The PyTorch port's namelist configuration (utils/config.py), its
MPConfig and its grid arguments against the JAX package's (CPU, float64):

- the JAX package's own test namelists (tests/test_config_coarse.py NML
  and SHIELD_NML, copied): every DynConfig and MPConfig field, the
  unknown and routed option dicts, and the ValueErrors equal JAX's;
  load_input_nml from a file and grid_kwargs_from_namelist likewise;
- MPConfig has JAX's fields in JAX's order with JAX's defaults, and the
  SHiELD namelist's gfdl_mp_nml (do_sedi_uv, use_mp_fast off, do_wbf,
  tau_l2r 600, fast_fr_mlt off) runs gfdl_mp_driver and fast_sat_adj as
  JAX's do, to 1e-12 of each output's maximum;
- build_grid_ops takes JAX's grid arguments: a stretched C12 grid (and
  one with the cube transform) equals JAX's metric for metric to 1e-12 of
  each one's maximum, and the solo driver steps on it.

One test function runs every check of this file: with one item the file
queues at the end of a parallel run (xdist --dist loadfile sorts files
by their item count), beside the run's longest files.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu.model.dyn_core import DynConfig as JDyn
from gfdl_atmos_cubed_sphere_tpu.physics.gfdl_mp import MPConfig as JMP
from gfdl_atmos_cubed_sphere_tpu.utils import config as jcfg
from gfdl_atmos_cubed_sphere_tpu_torch.model.dyn_core import DynConfig
from gfdl_atmos_cubed_sphere_tpu_torch.physics import gfdl_mp
from gfdl_atmos_cubed_sphere_tpu_torch.physics.gfdl_mp import MPConfig
from gfdl_atmos_cubed_sphere_tpu_torch.utils import config as cfg

pytestmark = pytest.mark.fast

NML = """
&fv_core_nml
    npx = 97
    npz = 32        ! levels
    hord_mt = 6
    hord_tm = 6
    kord_tm = -9
    n_split = 6
    k_split = 2
    do_vort_damp = .T.
    vtdm4 = 0.06
    consv_te = 1.
    d2_bg_k1 = 0.2
    tau = 10.
/
&gfdl_mp_nml
    tau_l2v = 225.
    ql0_max = 1.0e-3
    do_sedi_heat = .false.
/
"""

SHIELD_NML = """
&fv_core_nml
       layout   = 8,8
       io_layout = 1,1
       npx      = 769
       npy      = 769
       ntiles   = 6
       npz      = 91
       npz_type = ''
       grid_type = 0
       make_nh = .F.
       fv_debug = .F.
       range_warn = .T.
       reset_eta = .F.
       n_sponge = 9
       nudge_qv = .T.
       tau = 5.
       rf_cutoff = 7.5e2
       d2_bg_k1 = 0.20
       d2_bg_k2 = 0.15
       kord_tm = -9
       kord_mt = 9
       kord_wz = 9
       kord_tr = 9
       hydrostatic = .F.
       phys_hydrostatic = .F.
       use_hydro_pressure = .F.
       beta = 0.
       a_imp = 1.
       p_fac = 0.1
       k_split = 1
       n_split = 8
       nwat = 6
       na_init = 1
       d_ext = 0.0
       dnats = 1
       fv_sg_adj = 600
       d2_bg = 0.
       nord = 2
       dddmp = 0.2
       d4_bg = 0.12
       vtdm4 = 0.02
       delt_max = 0.002
       ke_bg = 0.
       do_vort_damp = .T.
       external_ic = .T.
       external_eta = .T.
       gfs_phil = .F.
       nggps_ic = .T.
       mountain = .F.
       ncep_ic = .F.
       d_con = 1.
       hord_mt = 5
       hord_vt = 5
       hord_tm = 5
       hord_dp = -5
       hord_tr = 8
       adjust_dry_mass = .F.
       consv_te = 1.
       consv_am = .F.
       fill = .T.
       dwind_2d = .F.
       print_freq = 6
       warm_start = .F.
       no_dycore = .F.
       z_tracer = .T.
       agrid_vel_rst = .T.
       read_increment = .F.
       res_latlon_dynamics = "fv3_increment.nc"
/
&gfdl_mp_nml
       do_sedi_uv = .T.
       use_mp_fast = .F.
       do_wbf = .T.
       tau_l2r = 600.
       fast_fr_mlt = .F.
       rh_inc = 0.30
/
"""


def _same_dataclass(got, want):
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _mpconfig_has_jax_fields_in_order():
    jf = dataclasses.fields(JMP)
    pf = dataclasses.fields(MPConfig)
    assert [f.name for f in pf] == [f.name for f in jf]
    assert len(pf) == 105
    _same_dataclass(MPConfig(), JMP())
    assert [f.name for f in dataclasses.fields(DynConfig)] == [
        f.name for f in dataclasses.fields(JDyn)]


def _namelists_load_as_in_jax(text, tmp_path):
    nml = cfg.parse_namelist(text)
    assert nml == jcfg.parse_namelist(text)
    dyn, unknown = cfg.dyn_config_from_namelist(nml, dt=150.0)
    jdyn, junknown = jcfg.dyn_config_from_namelist(nml, dt=150.0)
    _same_dataclass(dyn, jdyn)
    assert unknown == junknown
    mpc, unk2 = cfg.mp_config_from_namelist(nml)
    jmpc, junk2 = jcfg.mp_config_from_namelist(nml)
    _same_dataclass(mpc, jmpc)
    assert unk2 == junk2 == {}
    path = tmp_path / "input.nml"
    path.write_text(text)
    strict = text is NML
    if not strict:
        # phys_hydrostatic and use_hydro_pressure are unknown to both
        for mod in (cfg, jcfg):
            with pytest.raises(ValueError, match="phys_hydrostatic"):
                mod.load_input_nml(str(path), dt=150.0)
    got = cfg.load_input_nml(str(path), strict=strict, dt=150.0)
    want = jcfg.load_input_nml(str(path), strict=strict, dt=150.0)
    _same_dataclass(got[0], want[0])
    _same_dataclass(got[1], want[1])
    assert got[2] == want[2]
    if text is SHIELD_NML:
        assert set(unknown["_routed"]) >= {"layout", "nggps_ic",
                                           "external_ic", "grid_type"}


def _config_errors_as_in_jax():
    cases = [(dict(fv_core_nml=dict(hybrid_z=True, npx=13, npz=10)),
              dict(strict=True), "hybrid_z"),
             (dict(fv_core_nml=dict(nwat=4, npx=13, npz=10)), {}, "nwat"),
             (dict(fv_core_nml=dict(bogus=1, npx=13, npz=10)),
              dict(strict=True), "bogus")]
    for nml, kw, match in cases:
        for mod in (cfg, jcfg):
            with pytest.raises(ValueError, match=match):
                mod.dyn_config_from_namelist(nml, dt=30.0, **kw)
    _, unk = cfg.dyn_config_from_namelist(
        dict(fv_core_nml=dict(hybrid_z=True, bogus=2, npx=13, npz=10)),
        dt=30.0)
    assert unk == {"hybrid_z": True, "bogus": 2}


def _shield_gfdl_mp_nml_runs_as_in_jax():
    """The SHiELD namelist's gfdl_mp_nml through both packages' config:
    gfdl_mp_driver (nonhydrostatic, with w, ua, va: sedi_uv heats t) and
    fast_sat_adj (use_mp_fast off: sat_adjust) on seeded moist columns,
    levels 8 K or more from TICE and t_wfr (see test_torch_gfdl_mp.py)."""
    import jax
    from gfdl_atmos_cubed_sphere_tpu.physics import gfdl_mp as jmp
    nml = cfg.parse_namelist(SHIELD_NML)
    mpc, _ = cfg.mp_config_from_namelist(nml)
    jmpc, _ = jcfg.mp_config_from_namelist(nml)
    assert mpc.do_sedi_uv and not mpc.use_mp_fast and mpc.do_wbf
    assert mpc.tau_l2r == 600.0 and not mpc.fast_fr_mlt
    shape = (6, 4, 3, 3)
    rng = np.random.default_rng(23)
    t = (np.array([215.0, 250.0, 265.0, 285.0])[None, :, None, None]
         + rng.uniform(-1.5, 1.5, shape))
    delp = rng.uniform(1.0e4, 2.0e4, shape)
    pe = 1.0e3 + np.concatenate([np.zeros((6, 1, 3, 3)),
                                 np.cumsum(delp, 1)], 1)
    p_lay = delp / np.diff(np.log(pe), axis=1)
    qsat = gfdl_mp.wqs(torch.as_tensor(t), torch.as_tensor(p_lay))[0]
    q = {"sphum": qsat.numpy() * rng.uniform(0.7, 1.2, shape)}
    for nm, top in (("liq_wat", 1e-3), ("rainwat", 1e-3), ("ice_wat", 3e-4),
                    ("snowwat", 1e-3), ("graupel", 5e-4)):
        q[nm] = rng.uniform(0.0, top, shape)
    kw = dict(w=rng.uniform(-1.0, 1.0, shape),
              ua=rng.uniform(-20.0, 20.0, shape),
              va=rng.uniform(-20.0, 20.0, shape))
    delz = -rng.uniform(800.0, 1600.0, shape)

    def jrun(t, delp, delz, q, kw):
        return (jmp.gfdl_mp_driver(t, delp, delz, q, 450.0, 1.0e3,
                                   cfg=jmpc, hydrostatic=False, **kw),
                jmp.fast_sat_adj(t, delp, delz, q, 60.0, 1.0e3, cfg=jmpc))

    want = jax.tree_util.tree_leaves(jrun(*jax.tree_util.tree_map(
        jax.numpy.asarray, (t, delp, delz, q, kw))))
    tt = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}
    got = jax.tree_util.tree_leaves(
        (gfdl_mp.gfdl_mp_driver(torch.as_tensor(t), torch.as_tensor(delp),
                                torch.as_tensor(delz), tt(q), 450.0, 1.0e3,
                                cfg=mpc, hydrostatic=False, **tt(kw)),
         gfdl_mp.fast_sat_adj(torch.as_tensor(t), torch.as_tensor(delp),
                              torch.as_tensor(delz), tt(q), 60.0, 1.0e3,
                              cfg=mpc)))
    assert len(got) == len(want) == 1 + 6 + 4 + 3 + 1 + 6
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        top = max(np.abs(w).max(), 1e-300)
        assert np.abs(g.numpy() - w).max() <= 1e-12 * top, i


def _stretched_grid_matches_jax_and_steps():
    import jax.numpy as jnp
    from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops \
        as jax_pack
    from gfdl_atmos_cubed_sphere_tpu_torch.driver.solo import Atmosphere
    from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import (
        METRIC_NAMES, build_grid_ops)
    text = """&fv_core_nml
    do_schmidt = .T.
    stretch_fac = 1.5
    target_lat = 30.
    target_lon = 90.
/"""
    nml = cfg.parse_namelist(text)
    kw = cfg.grid_kwargs_from_namelist(nml)
    assert kw == jcfg.grid_kwargs_from_namelist(nml)
    for transform in (False, True):
        kw = dict(kw, do_cube_transform=transform)
        gj = jax_pack(13, dtype=jnp.float64, **kw)
        gt = build_grid_ops(13, dtype=torch.float64, device="cpu", **kw)
        for name in METRIC_NAMES:
            want = np.asarray(getattr(gj, name))
            got = getattr(gt, name).numpy()
            ok = np.isfinite(want)
            assert np.array_equal(ok, np.isfinite(got)), name
            top = np.abs(want[ok]).max()
            assert np.abs(got[ok] - want[ok]).max() <= 1e-12 * max(top,
                                                                    1e-300), \
                name
        assert np.allclose(gt.geom.interior("aglat"),
                           gj.geom.interior("aglat"), rtol=0, atol=1e-14)
    atm = Atmosphere(13, 10, 600.0, dtype="f64", device="cpu", geom=gt.geom,
                     cfg_overrides=dict(n_split=2))
    atm.atmosphere(1)
    assert all(bool(torch.isfinite(atm.state[k]).all())
               for k in ("delp", "pt", "u", "v"))


def test_config_matches_jax(tmp_path):
    """The namelists, MPConfig's fields and the SHiELD gfdl_mp_nml's
    microphysics, and the grid arguments, as the module docstring lists
    them."""
    _mpconfig_has_jax_fields_in_order()
    for text in (NML, SHIELD_NML):
        _namelists_load_as_in_jax(text, tmp_path)
    _config_errors_as_in_jax()
    _shield_gfdl_mp_nml_runs_as_in_jax()
    _stretched_grid_matches_jax_and_steps()
