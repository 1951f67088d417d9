"""Hydrostatic column pressures: CUDA kernel wrappers and plain versions.

Replaces the TPU kernels of gfdl_atmos_cubed_sphere_tpu/ops/pallas_col.py:
geopk_pallas (:80, the full geopk), pkgz_pallas (:301, the D-stage geopk
that writes only pk and gz) and pgradc_fused_pallas (:234, geopk on the
C grid fused with p_grad_c's uc, vc update). One source, csrc/col_pressure.cu,
holds the three entry points, each one launch per call; every column walk
keeps the plain version's order (the pe prefix sum top-down, the gz suffix
sum bottom-up), so the kernels equal the plain versions bit for bit.
geopk: one thread per (tile, j, i) column. pkgz: one thread per column,
the gz increments kept in shared memory; pk and gz are the two halves of
one [6, 2(K+1), Y, X] tensor, which one_grad_p's a2b takes whole.
pgradc_fused: a block walks the columns of a 32 x rows window of cells,
keeps pk in shared memory and writes each wall point's uc and vc once; the
wrapper allocates only uc_out and vc_out. `launch_plan` gives both their
block shapes from K and the element size. Bound by device-memory bytes at
C192L79 f32: geopk ~525 MB (~0.157 ms at 3.35 TB/s), pkgz ~300 MB
(~0.090 ms), pgradc_fused ~449 MB (~0.134 ms).

`geopk`, `pkgz` and `pgradc_fused` launch their kernels for a CUDA tensor
and take the plain versions (`geopk_ref`, `pkgz_ref`, `pgradc_fused_ref`)
only for a CPU tensor.
"""

import ctypes
import functools
from types import SimpleNamespace

import torch

from . import _build
from .. import constants as con
from .fill_corners import fi
from .sw_core import _cl, _cr, _rl, _rr

H = 3
#: csrc/col_pressure.cu's constants: levels a pass loads ahead of its walk;
#: pgradc_fused's levels per barrier, window columns (a warp), most window
#: rows, gz planes and fields its bottom-up pass streams; pkgz's most
#: threads a block
RING, BATCH, WIN_X, MAX_ROWS, GZ_SLOTS, UP_FIELDS = 8, 4, 32, 8, 9, 3
PKGZ_THREADS = 128
#: the block shapes the plans try, largest first, and the shared memory a
#: block may take: pgradc_fused leaves room for two blocks an SM (233472
#: bytes an SM, 1 KiB of it reserved per block), pkgz for four; SMEM_MAX:
#: the most one block can take.
PGC_ROWS = (8, 4, 2)
PKGZ_BLOCKS = (128, 64, 32)
PGC_BUDGET, PKGZ_BUDGET, SMEM_MAX = 115712, 49152, 232448

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
    """The D-stage geopk: (pk, gz) of geopk_ref, as the first and last K+1
    levels of one [6, 2(K+1), Y, X] tensor (pkgz_joined finds it)."""
    both = torch.cat(geopk_ref(delp_p, pt_p, phis_p, akap, ptop)[2:4], dim=1)
    Kp1 = delp_p.shape[1] + 1
    return both[:, :Kp1], both[:, Kp1:]


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
    rc = _lib().geopk(*(a.data_ptr() for a in ins + [pe, peln, pk, gz, pkz]),
                      K, Y, X, _consts(akap, ptop), _build.dtype_code(delp_p),
                      _build.stream_ptr(delp_p))
    _build.check(rc, "geopk")
    launches["geopk"] += 1
    return pe, peln, pk, gz, pkz


def pkgz(delp_p, pt_p, phis_p, akap, ptop):
    """pkgz_ref's contract: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if not delp_p.is_cuda:
        return pkgz_ref(delp_p, pt_p, phis_p, akap, ptop)
    a = pkgz_args(delp_p, pt_p, phis_p)
    rc = _lib().pkgz(*(t.data_ptr() for t in a.ins + [a.out]), *a.iv,
                     float(akap), float(ptop), con.CP_AIR,
                     _build.dtype_code(delp_p), _build.stream_ptr(delp_p))
    _build.check(rc, "pkgz")
    launches["pkgz"] += 1
    return a.outs


def pgradc_fused(delpc, ptc, phis_p, uc, vc, g, dt2, akap, ptop, npx):
    """pgradc_fused_ref's contract: delpc, ptc [6, K, P, P] padded cells,
    uc [6, K, P, W], vc [6, K, W, P]. The CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if not delpc.is_cuda:
        return pgradc_fused_ref(delpc, ptc, phis_p, uc, vc, g, dt2, akap,
                                ptop, npx)
    a = pgradc_args(delpc, ptc, phis_p, uc, vc, g, npx)
    rc = _lib().pgradc_fused(
        *(t.data_ptr() for t in a.ins + list(a.outs)), *a.iv, float(akap),
        float(ptop), con.CP_AIR, float(dt2), _build.dtype_code(delpc),
        _build.stream_ptr(delpc))
    _build.check(rc, "pgradc_fused")
    launches["pgradc_fused"] += 1
    return a.outs


# ---------------------------------------------------------------------------
# launch plans and kernel arguments
# ---------------------------------------------------------------------------

def pgradc_smem(K, rows, itemsize):
    """Shared memory of a pgradc_fused block (csrc/col_pressure.cu
    pgradc_smem): pk at K+1 interfaces, GZ_SLOTS gz planes and a ring of
    RING levels of UP_FIELDS fields for each of its WIN_X x rows columns."""
    return (K + 1 + GZ_SLOTS + UP_FIELDS * RING) * WIN_X * rows * itemsize


def pkgz_smem(K, threads, itemsize):
    """Shared memory of a pkgz block (csrc/col_pressure.cu pkgz_smem): the
    K gz increments and a ring of RING levels of delp and pt for each of
    its columns."""
    return (K + 2 * RING) * threads * itemsize


@functools.lru_cache(maxsize=64)
def launch_plan(kernel, K, Y, X, itemsize):
    """The launch of kernel "pgradc_fused" or "pkgz" for [6, K, Y, X]
    cells: `threads` per block, `grid` (blocks along x, y, z; the kernels
    are launched with it), `smem` bytes of shared memory a block, and
    `rows` (pgradc_fused's window rows, a block owning 31 x (rows - 1)
    wall points of the W x W frame, W = X + 1; None for pkgz, one thread
    per column). The block is the largest the
    kernel's budget holds (PGC_BUDGET, PKGZ_BUDGET), else the smallest if
    it fits SMEM_MAX; ValueError when none does. Cached: the plan is
    looked up on every wrapper call."""
    if K < 1:
        raise ValueError(f"{kernel} kernel: {K} levels")
    if kernel == "pgradc_fused":
        shapes, budget = PGC_ROWS, PGC_BUDGET

        def smem(rows):
            return pgradc_smem(K, rows, itemsize)
    elif kernel == "pkgz":
        shapes, budget = PKGZ_BLOCKS, PKGZ_BUDGET

        def smem(threads):
            return pkgz_smem(K, threads, itemsize)
    else:
        raise ValueError(f"no launch plan for {kernel}")
    shape = next((b for b in shapes if smem(b) <= budget), shapes[-1])
    if smem(shape) > SMEM_MAX:
        raise ValueError(f"{kernel} kernel: {K} levels of {itemsize}-byte "
                         f"values need {smem(shape)} B of shared memory a "
                         f"block, over {SMEM_MAX}")
    if kernel == "pkgz":
        return SimpleNamespace(threads=shape, grid=(-(-6 * Y * X // shape),
                                                    1, 1),
                               smem=smem(shape), rows=None)
    W = X + 1
    return SimpleNamespace(threads=WIN_X * shape,
                           grid=(-(-W // (WIN_X - 1)), -(-W // (shape - 1)),
                                 6),
                           smem=smem(shape), rows=shape)


def owned_points(plan):
    """pgradc_fused's wall points of each block of a plan: (j0, j1, i0, i1)
    of the points [j0, j1) x [i0, i1) of the W x W frame, for the blocks
    of the plan's grid (clipped to the frame by the kernel's checks)."""
    tx, ty = WIN_X - 1, plan.rows - 1
    return [(by * ty, (by + 1) * ty, bx * tx, (bx + 1) * tx)
            for by in range(plan.grid[1]) for bx in range(plan.grid[0])]


def pkgz_joined(pk, gz):
    """The contiguous [6, 2(K+1), Y, X] tensor whose first and last K+1
    levels pk and gz are (as pkgz returns them), or None."""
    T, Kp1, Y, X = pk.shape
    st = (2 * Kp1 * Y * X, Y * X, X, 1)
    if (gz.shape != pk.shape or pk.stride() != st or gz.stride() != st
            or gz.dtype != pk.dtype or gz.device != pk.device
            or gz.untyped_storage().data_ptr()
            != pk.untyped_storage().data_ptr()
            or gz.storage_offset() != pk.storage_offset() + Kp1 * Y * X):
        return None
    return pk.as_strided((T, 2 * Kp1, Y, X), st)


def pkgz_args(delp_p, pt_p, phis_p):
    """The kernel's arguments, on any device: `ins` (delp, pt, phis
    [6, Y, X], contiguous), `out` ([6, 2(K+1), Y, X], the only tensor
    allocated), `outs` (pk, gz: its first and last K+1 levels) and `iv`
    (K, Y, X, threads per block, blocks). ValueError for what the kernel
    does not take."""
    ins, (K, Y, X) = _cells("pkgz", delp_p, pt_p, phis_p)
    plan = launch_plan("pkgz", K, Y, X, delp_p.element_size())
    out = _new(delp_p, 2 * (K + 1), Y, X)
    return SimpleNamespace(ins=ins, out=out,
                           outs=(out[:, :K + 1], out[:, K + 1:]),
                           iv=(K, Y, X, plan.threads, plan.grid[0]),
                           plan=plan)


def pgradc_args(delpc, ptc, phis_p, uc, vc, g, npx):
    """The kernel's arguments, on any device: `ins` (delpc, ptc, phis
    [6, P, P], uc, vc, rdxc, rdyc, each contiguous), `outs` (uc_out,
    vc_out, the only tensors allocated) and `iv` (n, K, window rows,
    blocks along x and y). ValueError for what the kernel does not take."""
    cells, (K, P, _) = _cells("pgradc_fused", delpc, ptc, phis_p)
    n = P - 2 * H
    W = n + 1 + 2 * H
    if n < 1 or delpc.shape[-1] != P or npx != n + 1:
        raise ValueError(f"pgradc_fused kernel: npx {npx} for cells "
                         f"{tuple(delpc.shape[-2:])}")
    if K * P * W >= 2 ** 31:
        raise ValueError(f"pgradc_fused kernel: a tile of {K} x {P} x {W} "
                         f"points needs 64-bit level offsets")
    for nm, a, shp in (("uc", uc, (6, K, P, W)), ("vc", vc, (6, K, W, P)),
                       ("rdxc", g.rdxc, (6, 1, P, W)),
                       ("rdyc", g.rdyc, (6, 1, W, P))):
        _check(nm, a, delpc, shp)
    plan = launch_plan("pgradc_fused", K, P, P, delpc.element_size())
    ins = cells + [a.contiguous() for a in (uc, vc, g.rdxc, g.rdyc)]
    return SimpleNamespace(ins=ins, outs=(_new(delpc, K, P, W),
                                          _new(delpc, K, W, P)),
                           iv=(n, K, plan.rows) + plan.grid[:2], plan=plan)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

_bound = []


def _lib():
    """The col_pressure library with its entry points' argument types set
    (once, when it is first loaded)."""
    if not _bound:
        lib = _build.library("col_pressure")
        vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        dp = ctypes.POINTER(d)
        for fn, args in (
                (lib.geopk, [vp] * 8 + [i] * 3 + [dp, i, vp]),
                (lib.pkgz, [vp] * 4 + [i] * 5 + [d] * 3 + [i, vp]),
                (lib.pgradc_fused, [vp] * 9 + [i] * 5 + [d] * 4 + [i, vp])):
            fn.restype = ctypes.c_int
            fn.argtypes = args
        _bound.append(lib)
    return _bound[0]


def _check(name, a, like, shape):
    if (a.device != like.device or a.dtype != like.dtype
            or tuple(a.shape) != tuple(shape)):
        raise ValueError(f"{name}: device, dtype or shape {tuple(a.shape)} "
                         f"differ from {tuple(shape)} on {like.device}")


def _cells(name, delp, pt, phis):
    """delp, pt [6, K, Y, X] and phis [6, 1, Y, X] or [6, Y, X] on one
    device in one dtype: returns them contiguous (phis as [6, Y, X]) with
    (K, Y, X)."""
    if delp.ndim != 4 or delp.shape[0] != 6:
        raise ValueError(f"{name} kernel takes delp [6, K, Y, X], got "
                         f"{tuple(delp.shape)}")
    if delp.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name} kernel takes float32 or float64, not "
                         f"{delp.dtype}")
    _, K, Y, X = delp.shape
    _check(f"{name} pt", pt, delp, (6, K, Y, X))
    if tuple(phis.shape) not in ((6, 1, Y, X), (6, Y, X)):
        raise ValueError(f"{name} phis: shape {tuple(phis.shape)}, want "
                         f"[6, 1, {Y}, {X}]")
    phis = phis.reshape(6, Y, X)
    _check(f"{name} phis", phis, delp, (6, Y, X))
    return [delp.contiguous(), pt.contiguous(), phis.contiguous()], (K, Y, X)


def _new(like, K, Y, X):
    return torch.empty((6, K, Y, X), dtype=like.dtype, device=like.device)


def _consts(akap, ptop):
    """geopk's constants: akap, ptop, cp_air."""
    return (ctypes.c_double * 3)(float(akap), float(ptop), con.CP_AIR)
