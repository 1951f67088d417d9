"""Hydrostatic column pressures: CUDA kernel wrappers and plain versions.

Replaces the TPU kernels of gfdl_atmos_cubed_sphere_tpu/ops/pallas_col.py:
geopk_pallas (:80, the full geopk), pkgz_pallas (:301, the D-stage geopk
that writes only pk and gz) and pgradc_fused_pallas (:234, geopk on the
C grid fused with p_grad_c's uc, vc update). One source, csrc/col_pressure.cu,
holds the three entry points: one thread per (tile, j, i) column, the pe
prefix sum top-down and the gz suffix sum bottom-up in the plain version's
order; pgradc_fused adds a second launch of one thread per wall point over
a pk/gz workspace this wrapper allocates. Bound by device-memory bytes at
C192L79 f32: geopk ~525 MB (~0.157 ms at 3.35 TB/s), pkgz ~300 MB
(~0.090 ms), pgradc_fused ~449 MB (~0.134 ms; its pk/gz workspace adds
~150 MB written and read back).

`geopk`, `pkgz` and `pgradc_fused` launch their kernels for a CUDA tensor
and take the plain versions (`geopk_ref`, `pkgz_ref`, `pgradc_fused_ref`)
only for a CPU tensor.
"""

import ctypes

import torch

from . import _build
from .. import constants as con
from .fill_corners import fi
from .sw_core import _cl, _cr, _rl, _rr

H = 3

#: kernel launches since the last reset (plain-version calls do not count)
launches = {"pgradc_fused": 0, "pkgz": 0, "geopk": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def geopk_ref(delp_p, pt_p, phis_p, akap, ptop):
    """Hydrostatic pressures and geopotential (dyn_core.F90 geopk:2202).
    delp_p, pt_p [6, K, Y, X] (pt virtual potential temperature); phis_p
    [6, 1, Y, X]. Returns pe, peln, pk, gz [6, K+1, Y, X], pkz [6, K, Y, X].
    """
    pe = ptop + torch.cumsum(delp_p, dim=1)
    pe = torch.cat([torch.full_like(pe[:, :1], ptop), pe], dim=1)
    peln = torch.log(pe)
    pk = torch.exp(akap * peln)
    # bottom-up: gz(k) = gz(k+1) + cp_air * pt(k) * (pk(k+1) - pk(k))
    incr = con.CP_AIR * pt_p * (pk[:, 1:] - pk[:, :-1])
    gz_above = torch.flip(torch.cumsum(torch.flip(incr, [1]), dim=1), [1])
    gz = torch.cat([gz_above, torch.zeros_like(gz_above[:, :1])], dim=1)
    gz = gz + phis_p
    pkz = (pk[:, 1:] - pk[:, :-1]) / (akap * (peln[:, 1:] - peln[:, :-1]))
    return pe, peln, pk, gz, pkz


def pkgz_ref(delp_p, pt_p, phis_p, akap, ptop):
    """The D-stage geopk: (pk, gz) of geopk_ref."""
    return geopk_ref(delp_p, pt_p, phis_p, akap, ptop)[2:4]


def p_grad_c(uc, vc, delpc_p, pkc, gz, g, dt2, npx, hydrostatic=True):
    """C-grid pressure-gradient wind update (dyn_core.F90 p_grad_c:1635).
    hydrostatic: wk = pk(k+1) - pk(k) with pkc = pe**kappa;
    nonhydrostatic: wk = delpc with pkc = full pressure. Returns new
    tensors (uc, vc)."""
    f = fi
    wall_c = slice(f(1), f(npx) + 1)
    cell_c = slice(f(1), f(npx - 1) + 1)
    wk = (pkc[:, 1:] - pkc[:, :-1]) if hydrostatic else delpc_p
    gz1 = gz[:, :-1]
    gz2 = gz[:, 1:]
    pk1 = pkc[:, :-1]
    pk2 = pkc[:, 1:]
    termx = ((_cl(gz2) - _cr(gz1)) * (_cr(pk2) - _cl(pk1))
             + (_cl(gz1) - _cr(gz2)) * (_cl(pk2) - _cr(pk1)))
    uc = uc.clone()
    uc[..., cell_c, wall_c] += (dt2 * g.rdxc * termx
                                / (_cl(wk) + _cr(wk)))[..., cell_c, wall_c]
    termy = ((_rl(gz2) - _rr(gz1)) * (_rr(pk2) - _rl(pk1))
             + (_rl(gz1) - _rr(gz2)) * (_rl(pk2) - _rr(pk1)))
    vc = vc.clone()
    vc[..., wall_c, cell_c] += (dt2 * g.rdyc * termy
                                / (_rl(wk) + _rr(wk)))[..., wall_c, cell_c]
    return uc, vc


def pgradc_fused_ref(delpc, ptc, phis_p, uc, vc, g, dt2, akap, ptop, npx):
    """The hydrostatic geopk on the C grid followed by p_grad_c: returns the
    updated (uc, vc)."""
    _, _, pkc, gzc, _ = geopk_ref(delpc, ptc, phis_p, akap, ptop)
    return p_grad_c(uc, vc, delpc, pkc, gzc, g, dt2, npx)


def geopk(delp_p, pt_p, phis_p, akap, ptop):
    """geopk_ref's contract: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if not delp_p.is_cuda:
        return geopk_ref(delp_p, pt_p, phis_p, akap, ptop)
    ins, (K, Y, X) = _cells("geopk", delp_p, pt_p, phis_p)
    pe, peln, pk, gz = (_new(delp_p, K + 1, Y, X) for _ in range(4))
    pkz = _new(delp_p, K, Y, X)
    fn = _entry("geopk", 8)
    rc = fn(*(a.data_ptr() for a in ins + [pe, peln, pk, gz, pkz]), K, Y, X,
            _consts(akap, ptop), _build.dtype_code(delp_p),
            _build.stream_ptr(delp_p))
    _build.check(rc, "geopk")
    launches["geopk"] += 1
    return pe, peln, pk, gz, pkz


def pkgz(delp_p, pt_p, phis_p, akap, ptop):
    """pkgz_ref's contract: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if not delp_p.is_cuda:
        return pkgz_ref(delp_p, pt_p, phis_p, akap, ptop)
    ins, (K, Y, X) = _cells("pkgz", delp_p, pt_p, phis_p)
    pk, gz = _new(delp_p, K + 1, Y, X), _new(delp_p, K + 1, Y, X)
    fn = _entry("pkgz", 5)
    rc = fn(*(a.data_ptr() for a in ins + [pk, gz]), K, Y, X,
            _consts(akap, ptop), _build.dtype_code(delp_p),
            _build.stream_ptr(delp_p))
    _build.check(rc, "pkgz")
    launches["pkgz"] += 1
    return pk, gz


def pgradc_fused(delpc, ptc, phis_p, uc, vc, g, dt2, akap, ptop, npx):
    """pgradc_fused_ref's contract: delpc, ptc [6, K, P, P] padded cells,
    uc [6, K, P, W], vc [6, K, W, P]. The CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if not delpc.is_cuda:
        return pgradc_fused_ref(delpc, ptc, phis_p, uc, vc, g, dt2, akap,
                                ptop, npx)
    cells, (K, P, _) = _cells("pgradc_fused", delpc, ptc, phis_p)
    n = P - 2 * H
    W = n + 1 + 2 * H
    if npx != n + 1:
        raise ValueError(f"pgradc_fused kernel: npx {npx} for {n} cells")
    for nm, a, shp in (("uc", uc, (6, K, P, W)), ("vc", vc, (6, K, W, P)),
                       ("rdxc", g.rdxc, (6, 1, P, W)),
                       ("rdyc", g.rdyc, (6, 1, W, P))):
        _check(nm, a, delpc, shp)
    uc_out, vc_out = _new(delpc, K, P, W), _new(delpc, K, W, P)
    pk, gz = _new(delpc, K + 1, P, P), _new(delpc, K + 1, P, P)
    fn = _build.library("col_pressure").pgradc_fused
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_void_p] * 4 \
        + [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_double),
                                ctypes.c_int, ctypes.c_void_p]
    ins = cells + [a.contiguous() for a in (uc, vc, g.rdxc, g.rdyc)]
    arr = (ctypes.c_void_p * 7)(*(a.data_ptr() for a in ins))
    rc = fn(arr, *(a.data_ptr() for a in (uc_out, vc_out, pk, gz)), n, K,
            _consts(akap, ptop, dt2), _build.dtype_code(delpc),
            _build.stream_ptr(delpc))
    _build.check(rc, "pgradc_fused")
    launches["pgradc_fused"] += 1
    return uc_out, vc_out


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _check(name, a, like, shape):
    if (not a.is_cuda or a.device != like.device or a.dtype != like.dtype
            or tuple(a.shape) != tuple(shape)):
        raise ValueError(f"{name}: device, dtype or shape {tuple(a.shape)} "
                         f"differ from {tuple(shape)} on {like.device}")


def _cells(name, delp, pt, phis):
    """delp, pt [6, K, Y, X] and phis [6, 1, Y, X] or [6, Y, X] on one card
    in one dtype: returns them contiguous (phis as [6, Y, X]) with
    (K, Y, X)."""
    if delp.ndim != 4 or delp.shape[0] != 6:
        raise ValueError(f"{name} kernel takes delp [6, K, Y, X], got "
                         f"{tuple(delp.shape)}")
    _, K, Y, X = delp.shape
    _check(f"{name} pt", pt, delp, (6, K, Y, X))
    if tuple(phis.shape) not in ((6, 1, Y, X), (6, Y, X)):
        raise ValueError(f"{name} phis: shape {tuple(phis.shape)}, want "
                         f"[6, 1, {Y}, {X}]")
    _check(f"{name} phis", phis.reshape(6, Y, X), delp, (6, Y, X))
    ins = [a.contiguous() for a in (delp, pt, phis.reshape(6, Y, X))]
    return ins, (K, Y, X)


def _new(like, K, Y, X):
    return torch.empty((6, K, Y, X), dtype=like.dtype, device=like.device)


def _consts(akap, ptop, *more):
    vals = (float(akap), float(ptop), con.CP_AIR) + tuple(map(float, more))
    return (ctypes.c_double * len(vals))(*vals)


def _entry(name, nptr):
    fn = getattr(_build.library("col_pressure"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * nptr + [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_void_p]
    return fn
