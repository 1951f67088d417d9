"""a2b_ord4: CUDA kernel wrapper and plain version.

Replaces the TPU kernel a2b_ord4_pallas
(gfdl_atmos_cubed_sphere_tpu/ops/pallas_a2b.py:45, body _a2b_ord4_sel at
ops/a2b_edge.py:300). The kernel, csrc/a2b_ord4.cu, is one launch per call
and the wrapper issues nothing else: a block owns a box of output corners
of one cube tile (`launch_plan`) and a run of levels; its warps walk the
box's rows with each lane's stencil window in registers, and on the
tile-edge boxes its threads compute the points next to the edges, the
output edge rows and columns and the four cube-corner values too, which
the TPU kernel took precomputed from `a2b_edge_rows`. Bound by
device-memory bytes: the input plane and the output plane per level,
~0.06 GB of f32 at C768 (~17 us at 3.35 TB/s).

`a2b_ord4` launches the kernel for a CUDA tensor and takes the plain
version, `a2b_ord4_ref`, only for a CPU tensor.
"""

import ctypes

import torch

from . import _build
from .a2b_edge import A1, A2, B1, B2, C1, C2, H, a2b_edge_rows, fi

#: the kernel's box of output corners (rows x columns) and run of levels
#: (csrc/a2b_ord4.cu TX, TY, KL)
TX, TY, KL = 32, 32, 16

#: kernel launches since the last reset (plain-version calls do not count)
launches = 0


def reset_launches():
    global launches
    launches = 0


def a2b_ord4_ref(qin, g):
    """Plain PyTorch a2b_ord4 (a2b_edge.F90 a2b_ord4:47) on [..., P, P]
    padded cells -> [..., NW, NW] corner values, halo rim zero."""
    f = fi
    n = qin.shape[-1] - 2 * H
    npx = npy = n + 1
    NW = n + 1 + 2 * H
    dxa, dya = g.dxa, g.dya

    # ---- qx: 4th-order interp at x-walls, all cell rows -------------------
    def cx(i):
        return qin[..., :, f(i):f(i) + 1]

    def dx_(i):
        return dxa[..., :, f(i):f(i) + 1]

    s = f(1)
    Lx = npx - 4
    qx_i = (B2 * (qin[..., :, s:s + Lx] + qin[..., :, s + 3:s + 3 + Lx])
            + B1 * (qin[..., :, s + 1:s + 1 + Lx]
                    + qin[..., :, s + 2:s + 2 + Lx]))
    g_in = dx_(2) / dx_(1)
    g_ou = dx_(-1) / dx_(0)
    qx1 = 0.5 * (((2.0 + g_in) * cx(1) - cx(2)) / (1.0 + g_in)
                 + ((2.0 + g_ou) * cx(0) - cx(-1)) / (1.0 + g_ou))
    qx2 = ((3.0 * (g_in * cx(1) + cx(2))
            - (g_in * qx1 + qx_i[..., :, :1])) / (2.0 + 2.0 * g_in))
    g_in = dx_(npx - 2) / dx_(npx - 1)
    g_ou = dx_(npx + 1) / dx_(npx)
    qxn = 0.5 * (((2.0 + g_in) * cx(npx - 1) - cx(npx - 2)) / (1.0 + g_in)
                 + ((2.0 + g_ou) * cx(npx) - cx(npx + 1)) / (1.0 + g_ou))
    qxm = ((3.0 * (cx(npx - 2) + g_in * cx(npx - 1))
            - (g_in * qxn + qx_i[..., :, -1:])) / (2.0 + 2.0 * g_in))
    zx = torch.zeros_like(qin[..., :, :H])
    qx = torch.cat([zx, qx1, qx2, qx_i, qxm, qxn, zx], -1)

    # ---- qy: 4th-order interp at y-walls, all cell cols --------------------
    def cy(jf):
        return qin[..., f(jf):f(jf) + 1, :]

    def dy_(jf):
        return dya[..., f(jf):f(jf) + 1, :]

    qy_i = (B2 * (qin[..., s:s + Lx, :] + qin[..., s + 3:s + 3 + Lx, :])
            + B1 * (qin[..., s + 1:s + 1 + Lx, :]
                    + qin[..., s + 2:s + 2 + Lx, :]))
    g_in = dy_(2) / dy_(1)
    g_ou = dy_(-1) / dy_(0)
    qy1 = 0.5 * (((2.0 + g_in) * cy(1) - cy(2)) / (1.0 + g_in)
                 + ((2.0 + g_ou) * cy(0) - cy(-1)) / (1.0 + g_ou))
    qy2 = ((3.0 * (g_in * cy(1) + cy(2))
            - (g_in * qy1 + qy_i[..., :1, :])) / (2.0 + 2.0 * g_in))
    g_in = dy_(npy - 2) / dy_(npy - 1)
    g_ou = dy_(npy + 1) / dy_(npy)
    qyn = 0.5 * (((2.0 + g_in) * cy(npy - 1) - cy(npy - 2)) / (1.0 + g_in)
                 + ((2.0 + g_ou) * cy(npy) - cy(npy + 1)) / (1.0 + g_ou))
    qym = ((3.0 * (cy(npy - 2) + g_in * cy(npy - 1))
            - (g_in * qyn + qy_i[..., -1:, :])) / (2.0 + 2.0 * g_in))
    zy = torch.zeros_like(qin[..., :H, :])
    qy = torch.cat([zy, qy1, qy2, qy_i, qym, qyn, zy], -2)

    # ---- edge rows/columns of the output and cube-corner values -----------
    srow, nrow, wcol, ecol, cv = a2b_edge_rows(qin, g)
    cs = slice(f(2), f(npx - 1) + 1)
    srow, nrow = srow[..., cs], nrow[..., cs]
    wcol, ecol = wcol[..., cs, :], ecol[..., cs, :]

    # ---- qxx: y-interp of qx to corners ------------------------------------
    r0 = f(1)
    Ly = npy - 4
    qxx_i = (A2 * (qx[..., r0:r0 + Ly, cs]
                   + qx[..., r0 + 3:r0 + 3 + Ly, cs])
             + A1 * (qx[..., r0 + 1:r0 + 1 + Ly, cs]
                     + qx[..., r0 + 2:r0 + 2 + Ly, cs]))
    qxx_s = (C1 * (qx[..., f(1):f(1) + 1, cs] + qx[..., f(2):f(2) + 1, cs])
             + C2 * (srow + qxx_i[..., :1, :]))
    qxx_n = (C1 * (qx[..., f(npy - 2):f(npy - 2) + 1, cs]
                   + qx[..., f(npy - 1):f(npy - 1) + 1, cs])
             + C2 * (nrow + qxx_i[..., -1:, :]))
    qxx = torch.cat([qxx_s, qxx_i, qxx_n], -2)

    # ---- qyy: x-interp of qy to corners ------------------------------------
    qyy_i = (A2 * (qy[..., cs, r0:r0 + Ly]
                   + qy[..., cs, r0 + 3:r0 + 3 + Ly])
             + A1 * (qy[..., cs, r0 + 1:r0 + 1 + Ly]
                     + qy[..., cs, r0 + 2:r0 + 2 + Ly]))
    qyy_w = (C1 * (qy[..., cs, f(1):f(1) + 1] + qy[..., cs, f(2):f(2) + 1])
             + C2 * (wcol + qyy_i[..., :, :1]))
    qyy_e = (C1 * (qy[..., cs, f(npx - 2):f(npx - 2) + 1]
                   + qy[..., cs, f(npx - 1):f(npx - 1) + 1])
             + C2 * (ecol + qyy_i[..., :, -1:]))
    qyy = torch.cat([qyy_w, qyy_i, qyy_e], -1)

    inter = 0.5 * (qxx + qyy)
    out = qin.new_zeros(qin.shape[:-2] + (NW, NW))
    out[..., f(2):f(npy - 1) + 1, f(2):f(npx - 1) + 1] = inter
    out[..., f(2):f(npy - 1) + 1, f(1):f(1) + 1] = wcol
    out[..., f(2):f(npy - 1) + 1, f(npx):f(npx) + 1] = ecol
    out[..., f(1):f(1) + 1, f(2):f(npx - 1) + 1] = srow
    out[..., f(npy):f(npy) + 1, f(2):f(npx - 1) + 1] = nrow
    for ci, (jj, ii) in enumerate(((f(1), f(1)), (f(1), f(npx)),
                                   (f(npy), f(npx)), (f(npy), f(1)))):
        out[..., jj:jj + 1, ii:ii + 1] = cv[..., :, ci:ci + 1]
    return out


def a2b_ord4(qin, g):
    """The CUDA kernel for a CUDA tensor [6, K, P, P]; the plain version for
    a CPU tensor."""
    if not qin.is_cuda:
        return a2b_ord4_ref(qin, g)
    return _launch(qin, g)


def launch_plan(n, itemsize):
    """(boxes along x, boxes along y, shared-memory bytes of a block) of
    the kernel for n cells per side: a block owns a box of at most TY x TX
    of the n + 1 compute corners of one tile (box t of nt along an axis
    holds corners [t (n + 1) // nt, (t + 1) (n + 1) // nt), the kernel's
    fv::tile_start) and a run of at most KL levels; a tile-edge box keeps
    its edge values for each level of the run in shared memory (qy on two
    walls at TX + 3 columns, qx on two walls at TY + 3 rows, two edge rows,
    two edge columns, four cube-corner values). The kernel refuses a plan
    whose boxes are under 4 or over TX / TY corners wide."""
    ntx, nty = -(-(n + 1) // TX), -(-(n + 1) // TY)
    return ntx, nty, KL * (4 * (TX + TY) + 16) * itemsize


def _launch(qin, g):
    global launches
    if not qin.is_cuda or qin.ndim != 4 or qin.shape[0] != 6:
        raise ValueError(f"a2b_ord4 kernel takes a CUDA tensor [6, K, P, P], "
                         f"got {tuple(qin.shape)} on {qin.device}")
    K, P = qin.shape[1], qin.shape[-1]
    n = P - 2 * H
    NW = n + 1 + 2 * H
    if n < 6:
        raise ValueError("a2b_ord4 kernel needs at least 6 cells per side")
    ops = [qin.contiguous(), g.dxa, g.dya, g.edge_s_full, g.edge_n_full,
           g.edge_w_full, g.edge_e_full, g.a2b_corner_w]
    shapes = [(6, K, P, P), (6, 1, P, P), (6, 1, P, P), (6, 1, 1, NW),
              (6, 1, 1, NW), (6, 1, NW, 1), (6, 1, NW, 1), (6, 1, 4, 3)]
    for b, (a, shp) in enumerate(zip(ops, shapes)):
        if (not a.is_cuda or a.device != qin.device or a.dtype != qin.dtype
                or not a.is_contiguous()):
            raise ValueError(f"a2b_ord4 operand {b}: device, dtype or "
                             f"layout differ from qin")
        if tuple(a.shape) != shp:
            raise ValueError(f"a2b_ord4 operand {b}: shape {tuple(a.shape)}, "
                             f"want {shp}")
    out = torch.empty((6, K, NW, NW), dtype=qin.dtype, device=qin.device)
    ntx, nty, smem = launch_plan(n, qin.element_size())
    fn = _build.library("a2b_ord4").a2b_ord4
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                   ctypes.c_void_p]
    ptrs = (ctypes.c_void_p * len(ops))(*(a.data_ptr() for a in ops))
    iv = (ctypes.c_int * 7)(n, K, ntx, nty, TX, TY, smem)
    rc = fn(ptrs, out.data_ptr(), iv, _build.dtype_code(qin),
            _build.stream_ptr(qin))
    _build.check(rc, "a2b_ord4")
    launches += 1
    return out
