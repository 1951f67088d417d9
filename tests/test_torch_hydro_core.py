"""The PyTorch port's hydrostatic acoustic-loop pieces (ops/pg_col.py,
model/dyn_core.py) against the JAX package (float64, CPU, inputs from a
numpy seed):

- the plain geopk, pkgz and pgradc_fused against the JAX geopk + p_grad_c
  and against the JAX Pallas kernels pkgz_pallas / pgradc_fused_pallas in
  interpret mode, as tests/test_pallas_pg.py runs them (C16L16; 1e-12 x
  max|ref|, gz within 1e-7 + 1e-12 |ref|: the three cumulative sums add in
  different orders);
- one_grad_p on geopk's pk, gz (1e-12), and on pkgz's pk, gz, the halves
  of one tensor (bit for bit against the concatenating path, 1e-12 against
  JAX);
- one dyn_core_hydro loop (n_split = 2) at C12L10 (1e-10 x each field's
  maximum).

On the CPU the port's wrappers take their plain versions; the kernel launch
counters stay 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu import constants as con
from gfdl_atmos_cubed_sphere_tpu.grid.fv_eta import set_eta
from gfdl_atmos_cubed_sphere_tpu.init.baroclinic import jw_baroclinic
from gfdl_atmos_cubed_sphere_tpu.model import dyn_core as jdc
from gfdl_atmos_cubed_sphere_tpu.model.grid_ops import build_grid_ops as jax_pack
from gfdl_atmos_cubed_sphere_tpu.model.sw_dynamics import prepare_phis as jphis
from gfdl_atmos_cubed_sphere_tpu.ops import pallas_col
from gfdl_atmos_cubed_sphere_tpu_torch.model import dyn_core as tdc
from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import (
    build_grid_ops, state_from_arrays)
from gfdl_atmos_cubed_sphere_tpu_torch.model.sw_dynamics import prepare_phis
from gfdl_atmos_cubed_sphere_tpu_torch.ops import (a2b, csw, dsw, pg_col,
                                                   tp_sweep)

pytestmark = pytest.mark.fast

H = 3
AKAP = con.KAPPA
DT2 = 30.0


def _reset():
    for mod in (a2b, csw, dsw, pg_col, tp_sweep):
        mod.reset_launches()


def _launched():
    return (a2b.launches, csw.launches, dsw.launches["fluxes"],
            dsw.launches["winds"], tp_sweep.launches,
            *pg_col.launches.values())


def _close(want, got, tol=1e-12, atol=0.0, what=""):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, what
    fin = np.isfinite(want)
    assert fin.any(), what
    assert np.array_equal(fin, np.isfinite(got)), what
    d = np.abs(np.where(fin, got - want, 0.0))
    ref = np.abs(np.where(fin, want, 0.0))
    assert (d <= tol * ref.max() + atol).all(), (what, d.max())


@pytest.fixture(scope="module")
def case():
    """C16L16 as tests/test_pallas_pg.py: the perturbed baroclinic delp and
    a noisy theta_v, padded; random C-grid winds."""
    npx, npz = 17, 16
    gj = jax_pack(npx, dtype=jnp.float64)
    gt = build_grid_ops(npx, dtype=torch.float64, device="cpu")
    _, ptop, ak, bk = set_eta(npz)
    ic = jw_baroclinic(gj.geom, npz, ak, bk, ptop, perturb=True)
    jphis(gj, ic["phis"])
    prepare_phis(gt, ic["phis"])
    rng = np.random.default_rng(3)
    delp = ic["delp"] * (1 + 0.01 * rng.standard_normal(ic["delp"].shape))
    ptv = 300.0 * (1 + 0.02 * rng.standard_normal(delp.shape))
    delp_p = gj.halo.pad_cell(jnp.asarray(delp))
    pt_p = gj.halo.pad_cell(jnp.asarray(ptv))
    P = delp_p.shape[-1]
    uc = jnp.asarray(rng.standard_normal((6, npz, P, P + 1)))
    vc = jnp.asarray(rng.standard_normal((6, npz, P + 1, P)))

    def refs(delp_p, pt_p, uc, vc):
        geo = jdc.geopk(delp_p, pt_p, gj.phis_p, AKAP, ptop)
        pgc = jdc.p_grad_c(uc, vc, delp_p, geo[2], geo[3], gj, DT2, npx)
        return geo, pgc

    geo, pgc = jax.jit(refs)(delp_p, pt_p, uc, vc)
    pkgz_k = jax.jit(lambda a, b: pallas_col.pkgz_pallas(
        a, b, gj.phis_p, AKAP, ptop, interpret=True))(delp_p, pt_p)
    pgc_k = jax.jit(lambda a, b, c, d: pallas_col.pgradc_fused_pallas(
        a, b, gj.phis_p, c, d, gj, DT2, AKAP, ptop, npx,
        interpret=True))(delp_p, pt_p, uc, vc)
    t = {k: torch.as_tensor(np.array(a)) for k, a in
         dict(delp_p=delp_p, pt_p=pt_p, uc=uc, vc=vc).items()}
    return dict(gj=gj, gt=gt, npx=npx, ptop=ptop, t=t, geo=geo, pgc=pgc,
                pkgz_k=pkgz_k, pgc_k=pgc_k)


def test_column_pressures(case):
    """geopk, pkgz and pgradc_fused (their plain versions on the CPU)
    against the JAX geopk / p_grad_c and the interpret-mode Pallas kernels
    they replace."""
    c, t = case, case["t"]
    gt, ptop = c["gt"], c["ptop"]
    _reset()
    geo = pg_col.geopk(t["delp_p"], t["pt_p"], gt.phis_p, AKAP, ptop)
    pk, gz = pg_col.pkgz(t["delp_p"], t["pt_p"], gt.phis_p, AKAP, ptop)
    uc, vc = pg_col.pgradc_fused(t["delp_p"], t["pt_p"], gt.phis_p, t["uc"],
                                 t["vc"], gt, DT2, AKAP, ptop, c["npx"])
    assert _launched() == (0,) * 8
    for nm, want, got in zip(("pe", "peln", "pk", "gz", "pkz"), c["geo"],
                             geo):
        _close(want, got, atol=1e-7 if nm == "gz" else 0.0, what=nm)
    for nm, want, got in (("pk", c["pkgz_k"][0], pk),
                          ("gz", c["pkgz_k"][1], gz)):
        _close(want, got, atol=1e-7 if nm == "gz" else 0.0,
               what=f"pkgz_pallas {nm}")
    for src in ("pgc", "pgc_k"):
        for nm, want, got in zip(("uc", "vc"), c[src], (uc, vc)):
            _close(want, got, what=f"{src} {nm}")


def test_one_grad_p(case):
    """The hydrostatic D-grid pressure gradient on geopk's pk, gz: the
    batched a2b_ord4 of [6, 2(K+1), P, P] and the cross differences. Then
    pkgz's output: pk and gz, bit for bit geopk's, are the halves of one
    tensor, which one_grad_p takes whole (no concatenation); it equals the
    concatenating path bit for bit and the JAX one_grad_p to 1e-12."""
    c, t = case, case["t"]
    gj, gt, npx = c["gj"], c["gt"], c["npx"]
    n = npx - 1
    K = t["delp_p"].shape[1]
    rng = np.random.default_rng(7)
    u_acc = rng.standard_normal((6, K, n + 1, n)) * 1e6
    v_acc = rng.standard_normal((6, K, n, n + 1)) * 1e6
    ptk = c["ptop"] ** AKAP
    pk, gz = c["geo"][2], c["geo"][3]
    jogp = jax.jit(lambda a, b, p, z: jdc.one_grad_p(
        a, b, p, z, gj, 450.0, npx, ptk))
    want = jogp(u_acc, v_acc, pk, gz)
    ua, va = torch.as_tensor(u_acc), torch.as_tensor(v_acc)
    _reset()
    got = tdc.one_grad_p(ua, va, torch.as_tensor(np.array(pk)),
                         torch.as_tensor(np.array(gz)), gt, 450.0, npx, ptk)
    assert _launched() == (0,) * 8
    for nm, a, b in zip(("u", "v"), want, got):
        _close(a, b, what=nm)

    cells = (t["delp_p"], t["pt_p"], gt.phis_p, AKAP, c["ptop"])
    P = t["delp_p"].shape[-1]
    pk_s, gz_s = pg_col.pkgz(*cells)
    pk_r, gz_r = pg_col.geopk_ref(*cells)[2:4]
    assert torch.equal(pk_s, pk_r) and torch.equal(gz_s, gz_r)
    both = pg_col.pkgz_joined(pk_s, gz_s)
    assert tuple(both.shape) == (6, 2 * (K + 1), P, P)
    assert both.data_ptr() == pk_s.data_ptr()
    assert pg_col.pkgz_joined(pk_r, gz_r) is None
    shared = tdc.one_grad_p(ua, va, pk_s, gz_s, gt, 450.0, npx, ptk)
    cat = tdc.one_grad_p(ua, va, pk_r, gz_r, gt, 450.0, npx, ptk)
    assert _launched() == (0,) * 8
    want = jogp(u_acc, v_acc, pk_r.numpy(), gz_r.numpy())
    for nm, a, b, w in zip(("u", "v"), shared, cat, want):
        assert torch.equal(a, b), nm
        _close(w, a, what=f"shared buffer {nm}")


def test_dyn_core_hydro():
    """One hydrostatic acoustic loop (n_split = 2, c192_hydro's DynConfig
    defaults) on the perturbed dry Jablonowski-Williamson state at C12L10
    against the jitted JAX dyn_core_hydro."""
    npx, K, dt, n_split = 13, 10, 1800.0, 2
    cfg = dict(npx=npx, npz=K, dt=dt, hydrostatic=True, k_split=1,
               n_split=n_split)
    gj = jax_pack(npx, dtype=jnp.float64)
    gt = build_grid_ops(npx, dtype=torch.float64, device="cpu")
    _, ptop, ak, bk = set_eta(K)
    ic = jw_baroclinic(gj.geom, K, ak, bk, ptop, perturb=True, moist=False)
    jphis(gj, ic["phis"])
    prepare_phis(gt, ic["phis"])
    pe = ptop + np.concatenate([np.zeros_like(ic["delp"][:, :1]),
                                np.cumsum(ic["delp"], axis=1)], axis=1)
    pk = np.exp(AKAP * np.log(pe))
    pkz = (pk[:, 1:] - pk[:, :-1]) / (AKAP * np.diff(np.log(pe), axis=1))
    st = dict(ic, pt=ic["pt"] / pkz)
    names = ("delp", "pt", "u", "v")
    out = ("delp", "pt", "u", "v", "mfx", "mfy", "cx", "cy", "pe", "peln",
           "pk", "gz", "pkz")

    def jstep(*a):
        r = jdc.dyn_core_hydro(*a, None, gj, jdc.DynConfig(**cfg), AKAP,
                               ptop, n_split, dt / n_split)
        return tuple(getattr(r, k) for k in out)

    want = jax.jit(jstep)(*(jnp.asarray(st[k]) for k in names))
    ts = state_from_arrays(st, dtype=torch.float64, device="cpu")
    _reset()
    got = tdc.dyn_core_hydro(*(ts[k] for k in names), None, gt,
                             tdc.DynConfig(**cfg), AKAP, ptop, n_split,
                             dt / n_split)
    assert _launched() == (0,) * 8
    ctr = slice(H, H + npx - 1)
    for nm, a in zip(out, want):
        a = np.asarray(a)
        b = getattr(got, nm).numpy()
        if nm in ("cx", "cy", "pe", "peln", "pk", "gz", "pkz"):
            a, b = a[..., ctr, ctr], b[..., ctr, ctr]     # compute domain
        assert np.isfinite(a).all(), nm
        assert np.abs(b - a).max() <= 1e-10 * np.abs(a).max(), nm
