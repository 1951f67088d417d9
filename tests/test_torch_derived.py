"""The PyTorch port's io/derived.py against the JAX package's, function by
function (float64, CPU, C12L10, the seeded moist JW state of
torch_slice_inputs): every output <= 1e-12 x its maximum, NaN at the same
points.

The JAX package's derived.py reads `gfdl_mp.ZVIR`, which its gfdl_mp does
not define, on the hydrostatic branches of layer_heights and
radar_reflectivity when given sphum; the module fixture supplies the
constant (constants.ZVIR) for the reference so those branches compare
too. The port reads constants.ZVIR.
"""

import numpy as np
import pytest
import torch

import torch_slice_inputs as si
from gfdl_atmos_cubed_sphere_tpu.io import derived as jder
from gfdl_atmos_cubed_sphere_tpu_torch.io import derived as pder

pytestmark = pytest.mark.fast


@pytest.fixture(scope="module")
def inputs():
    import jax.numpy as jnp
    from gfdl_atmos_cubed_sphere_tpu import constants as jcon
    from gfdl_atmos_cubed_sphere_tpu.physics import gfdl_mp as jmp
    from gfdl_atmos_cubed_sphere_tpu_torch.model.fv_update_phys import (
        cubed_to_latlon)
    gj, gt, ptop, ak, bk, ic = si.packs()
    st, q = si.seeded_state(ic)
    inp = dict(st, q=q, sph=q["sphum"])
    ua, va = cubed_to_latlon(torch.as_tensor(st["u"]),
                             torch.as_tensor(st["v"]), gt)
    inp["ua"], inp["va"] = ua.numpy(), va.numpy()
    pe, peln, p_lay = (t.numpy() for t in pder.layer_pressures(
        torch.as_tensor(st["delp"]), ptop))
    inp.update(pe=pe, peln=peln, p_lay=p_lay)
    zm, zbot = (t.numpy() for t in pder.layer_heights(
        delz=torch.as_tensor(st["delz"])))
    inp.update(zm=zm, zbot=zbot, dz=-st["delz"])
    inp["vort"] = pder.relative_vorticity(torch.as_tensor(st["u"]),
                                          torch.as_tensor(st["v"]),
                                          gt).numpy()
    inp["dbz"] = pder.radar_reflectivity(
        torch.as_tensor(st["delp"]), torch.as_tensor(st["pt"]),
        si.t64_dict(q), delz=torch.as_tensor(st["delz"]))[0].numpy()
    inp["theta"] = (pder.potential_temperature(
        torch.as_tensor(st["pt"]), torch.as_tensor(p_lay))).numpy()
    inp["cape"] = pder.cape_cin(torch.as_tensor(st["pt"]),
                                torch.as_tensor(st["delp"]),
                                torch.as_tensor(q["sphum"]), ptop)[0].numpy()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmp, "ZVIR", jcon.ZVIR, raising=False)
        yield (dict(pack=gj, a=jnp.asarray, ptop=ptop),
               dict(pack=gt, a=lambda x: torch.as_tensor(np.array(x)),
                    ptop=ptop), inp)


def _q(B, I):
    return {k: B["a"](v) for k, v in I["q"].items()}


PLEVS = [p * 100.0 for p in (200, 500, 550, 700, 850, 925, 1000)]

# name -> (module, backend, inputs) -> output or tuple of outputs
CASES = {
    "relative_vorticity": lambda d, B, I: d.relative_vorticity(
        B["a"](I["u"]), B["a"](I["v"]), B["pack"]),
    "absolute_vorticity": lambda d, B, I: d.absolute_vorticity(
        B["a"](I["u"]), B["a"](I["v"]), B["pack"]),
    "potential_vorticity": lambda d, B, I: d.potential_vorticity(
        B["a"](I["u"]), B["a"](I["v"]), B["a"](I["pt"]), B["a"](I["delp"]),
        B["pack"], ptop=B["ptop"]),
    "sea_level_pressure": lambda d, B, I: d.sea_level_pressure(
        B["a"](I["pe"][:, -1]), B["a"](I["phis"]), B["a"](I["pt"][:, -1])),
    "interp_to_pressure_levels": lambda d, B, I: tuple(
        d.interp_to_pressure_levels(B["a"](I[f]), B["a"](I["delp"]),
                                    B["ptop"], PLEVS, log_p=lp)
        for f in ("pt", "ua") for lp in (True, False)),
    "wind_speed": lambda d, B, I: d.wind_speed(B["a"](I["ua"]),
                                               B["a"](I["va"])),
    "cape_cin": lambda d, B, I: d.cape_cin(
        B["a"](I["pt"]), B["a"](I["delp"]), B["a"](I["sph"]), B["ptop"]),
    "layer_heights": lambda d, B, I: (
        d.layer_heights(delz=B["a"](I["delz"]))
        + d.layer_heights(pt=B["a"](I["pt"]), peln=B["a"](I["peln"]),
                          sphum=B["a"](I["sph"]))
        + d.layer_heights(pt=B["a"](I["pt"]), peln=B["a"](I["peln"]))),
    "updraft_helicity": lambda d, B, I: (
        d.updraft_helicity(B["a"](I["vort"]), B["a"](I["w"]),
                           B["a"](I["zm"]), B["a"](I["dz"])),
        d.updraft_helicity(B["a"](I["vort"]), B["a"](I["w"]),
                           B["a"](I["zm"]), B["a"](I["dz"]), 0.0, 3.0e3)),
    "radar_reflectivity": lambda d, B, I: (
        d.radar_reflectivity(B["a"](I["delp"]), B["a"](I["pt"]), _q(B, I),
                             delz=B["a"](I["delz"]))
        + d.radar_reflectivity(B["a"](I["delp"]), B["a"](I["pt"]),
                               _q(B, I), peln=B["a"](I["peln"]))),
    "echo_top": lambda d, B, I: d.echo_top(B["a"](I["dbz"]),
                                           B["a"](I["zm"])),
    "layer_pressures": lambda d, B, I: d.layer_pressures(
        B["a"](I["delp"]), B["ptop"]),
    "potential_temperature": lambda d, B, I: d.potential_temperature(
        B["a"](I["pt"]), B["a"](I["p_lay"])),
    "equivalent_potential_temperature": lambda d, B, I:
        d.equivalent_potential_temperature(
            B["a"](I["pt"]), B["a"](I["p_lay"]), B["a"](I["sph"])),
    "relative_humidity": lambda d, B, I: d.relative_humidity(
        B["a"](I["pt"]), B["a"](I["p_lay"]), B["a"](I["sph"])),
    "divergence": lambda d, B, I: d.divergence(
        B["a"](I["ua"]), B["a"](I["va"]), B["pack"]),
    "interp_to_height": lambda d, B, I: tuple(
        d.interp_to_height(B["a"](I[f]), B["a"](I["zm"]),
                           (10.0, 100.0, 1.0e3, 2.5e3, 5.0e3))
        for f in ("ua", "w")),
    "bunkers_motion": lambda d, B, I: d.bunkers_motion(
        B["a"](I["ua"]), B["a"](I["va"]), B["a"](I["zm"]), B["a"](I["dz"])),
    "storm_relative_helicity": lambda d, B, I: tuple(
        d.storm_relative_helicity(
            B["a"](I["ua"]), B["a"](I["va"]), B["a"](I["zm"]),
            B["a"](I["dz"]), B["a"](I["ua"][:, -1]), B["a"](I["va"][:, -1]),
            lo, hi) for lo, hi in ((0.0, 1.0e3), (0.0, 3.0e3), (2.0e3, 5.0e3))),
    "wind_shear": lambda d, B, I: d.wind_shear(
        B["a"](I["ua"]), B["a"](I["va"]), B["a"](I["zm"]), B["a"](I["dz"])),
    "interp_to_theta": lambda d, B, I: d.interp_to_theta(
        B["a"](I["pt"]), B["a"](I["theta"]), (300.0, 310.0, 320.0, 350.0)),
    "box_max": lambda d, B, I: d.box_max(
        B["a"](np.hypot(I["ua"][:, -1], I["va"][:, -1])), 7),
    "bulk_richardson": lambda d, B, I: d.bulk_richardson(
        B["a"](I["cape"]), B["a"](I["ua"]), B["a"](I["va"]),
        B["a"](I["zm"]), B["a"](I["dz"])),
}


def test_every_function_is_covered():
    public = {n for n in dir(jder) if callable(getattr(jder, n))
              and not n.startswith("_")
              and getattr(getattr(jder, n), "__module__", "") == jder.__name__}
    assert public == set(CASES), sorted(public ^ set(CASES))
    assert all(callable(getattr(pder, n)) for n in CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_derived_function(inputs, name):
    jb, tb, inp = inputs
    want = CASES[name](jder, jb, inp)
    got = CASES[name](pder, tb, inp)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.is_tensor(a), (name, i)
        si.close(a, b, 1e-12, f"{name}[{i}]")
    if name in ("interp_to_pressure_levels", "interp_to_theta"):
        # the targets reach both inside and outside the column
        nan = np.isnan(np.asarray(want[0]))
        assert nan.any() and not nan.all(), name
