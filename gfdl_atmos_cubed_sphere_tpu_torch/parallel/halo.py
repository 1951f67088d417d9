"""Halo exchange for the whole-cube-on-one-device layout (PyTorch port).

Counterpart of gfdl_atmos_cubed_sphere_tpu/parallel/halo.py. All 6 tiles live
in one tensor ``[6, ..., ny, nx]``; a halo is materialised transiently as a
padded copy through one gather whose flat index map is derived in numpy from
the numeric cube topology (grid/topology.py) and kept on the device as a long
tensor. There are no persistent ghost cells in the state.

`copy_corners` reproduces FV3 model/tp_core.F90:245-320: before a directional
advection sweep, the tile-corner halo blocks are filled from the tile's own
halo strips (transposed) so that 1-D stencils can sweep straight through.
"""

from functools import lru_cache

import numpy as np
import torch

from ..grid.topology import CubeTopology


class HaloExchanger:
    """Precomputed halo gather maps for one (n, h) configuration."""

    def __init__(self, topo: CubeTopology, h: int, device="cuda"):
        self.topo = topo
        self.n = topo.n
        self.h = h
        self.device = torch.device(device)
        n = self.n
        dev = self.device
        t, j, i, _ = topo.cell_halo_spec(h)
        self._cell_flat = torch.as_tensor(
            (t * (n * n) + j * n + i).astype(np.int64), device=dev).reshape(-1)
        self._cell_shape = t.shape
        t, j, i, _ = topo.corner_halo_spec(h)
        m = n + 1
        self._corner_flat = torch.as_tensor(
            (t * (m * m) + j * m + i).astype(np.int64), device=dev).reshape(-1)
        self._corner_shape = t.shape
        self._dgrid = self._vector_spec(h, "D")
        self._cgrid = self._vector_spec(h, "C")
        self._own_spec = None

    def _vector_spec(self, h, grid):
        n = self.n
        ly = (n + 1) * n          # one staggered component per tile
        out = {}
        for name, s in self.topo.vector_halo_spec(h, grid).items():
            flat = (np.where(s["comp"] == 0,
                             s["jidx"] * n + s["iidx"],
                             ly + s["jidx"] * (n + 1) + s["iidx"])
                    + s["tidx"] * (2 * ly)).astype(np.int64)
            out[name] = (torch.as_tensor(flat, device=self.device).reshape(-1),
                         torch.as_tensor(s["sign"].astype(np.float64),
                                         device=self.device), flat.shape)
        return out

    @staticmethod
    def _gather(src, flat_idx, shape):
        """src [6, *batch, L] -> [6, *batch, *shape[1:]] via one gather over
        the (tile, point) axis."""
        batch = src.shape[1:-1]
        B = int(np.prod(batch)) if batch else 1
        qf = src.reshape(6, B, -1).transpose(0, 1).reshape(B, -1)
        out = qf.index_select(1, flat_idx).reshape(B, 6, *shape[1:])
        return out.transpose(0, 1).reshape(6, *batch, *shape[1:]).contiguous()

    # -- scalar pads ---------------------------------------------------

    def pad_cell(self, q):
        """[6, ..., n, n] -> [6, ..., n+2h, n+2h] (corner blocks garbage)."""
        return self._gather(q.reshape(*q.shape[:-2], -1), self._cell_flat,
                            self._cell_shape)

    def pad_cells(self, fields):
        """The grouped cell exchange: fields [6, K_i, n, n] padded by one
        gather over their level-concatenation. Returns a tuple."""
        ks = [q.shape[1] for q in fields]
        both = self.pad_cell(torch.cat(list(fields), dim=1))
        return tuple(t.contiguous() for t in torch.split(both, ks, dim=1))

    def pad_corner(self, q):
        """[6, ..., n+1, n+1] corner points -> [6, ..., NW, NW]."""
        return self._gather(q.reshape(*q.shape[:-2], -1), self._corner_flat,
                            self._corner_shape)

    # -- vector pads -----------------------------------------------------

    def _pad_vector(self, a, b, spec):
        """a: the y-wall field [6, ..., n+1, n], b: the x-wall field
        [6, ..., n, n+1]; returns the padded ('u', 'v') outputs of `spec`
        with cross-edge component rotation and sign flips."""
        src = torch.cat([a.reshape(*a.shape[:-2], -1),
                         b.reshape(*b.shape[:-2], -1)], -1)
        outs = []
        for name in ("u", "v"):
            idx, sign, shape = spec[name]
            o = self._gather(src, idx, shape)
            sg = sign.to(o.dtype).reshape(6, *([1] * (o.ndim - 3)), *shape[1:])
            outs.append(o * sg)
        return tuple(outs)

    def pad_dgrid(self, u, v):
        """D-grid winds: u [6,...,n+1,n], v [6,...,n,n+1] ->
        padded [6,...,n+1+2h,n+2h], [6,...,n+2h,n+1+2h]."""
        return self._pad_vector(u, v, self._dgrid)

    def pad_cgrid(self, uc, vc):
        """C-grid winds: uc x-wall [6,...,n,n+1], vc y-wall [6,...,n+1,n].
        The topology's C spec takes vc as its y-wall source component."""
        return self._pad_vector(vc, uc, self._cgrid)

    def reconcile_dgrid(self, u, v):
        """Overwrite the duplicated D-wind walls on each tile's N/E edges with
        the owning (W/S side) tile's values (FV3 dyn_core.F90:1152-1170).
        u: [6, K, n+1, n]; v: [6, K, n, n+1]."""
        n = self.n
        if self._own_spec is None:
            spec = {}
            for k, (comp, tid, jj, ii, sg) in \
                    self.topo.dgrid_edge_owner_spec().items():
                as_u = comp == 0
                # clamp the index of the unselected component into range
                ju = np.clip(jj, 0, n)
                iu = np.clip(ii, 0, n - 1)
                jv = np.clip(jj, 0, n - 1)
                iv = np.clip(ii, 0, n)
                spec[k] = tuple(torch.as_tensor(a, device=self.device)
                                for a in (as_u, tid.astype(np.int64),
                                          ju.astype(np.int64),
                                          iu.astype(np.int64),
                                          jv.astype(np.int64),
                                          iv.astype(np.int64)))
                spec[k] += (torch.as_tensor(sg.astype(np.float64),
                                            device=self.device),)
            self._own_spec = spec

        def pick(as_u, tid, ju, iu, jv, iv, sg):
            uu = u[tid, :, ju, iu]                      # [6, n, K]
            vv = v[tid, :, jv, iv]
            w = torch.where(as_u[..., None], uu, vv)
            return (w * sg.to(w.dtype)[..., None]).movedim(1, -1)  # [6,K,n]

        un = pick(*self._own_spec["u_n"])
        ve = pick(*self._own_spec["v_e"])
        u = u.clone()
        v = v.clone()
        u[:, :, n, :] = un
        v[:, :, :, n] = ve
        return u, v


@lru_cache(maxsize=32)
def _corner_fill_idx(n, h, direction):
    """Corner-block source index maps, transcribed 1:1 from the Fortran
    formulas in tp_core.F90:258-318. Returns a list of
    (jslice, islice, src_j [h,h], src_i [h,h]) in padded coordinates."""
    npx = npy = n + 1
    out = []

    def block(i_f, j_f, src):
        jj, ii = np.meshgrid(j_f, i_f, indexing="ij")
        si, sj = src(ii, jj)
        jsl = slice(j_f[0] - 1 + h, j_f[-1] + h)
        isl = slice(i_f[0] - 1 + h, i_f[-1] + h)
        return (jsl, isl, (sj - 1 + h).astype(np.int32),
                (si - 1 + h).astype(np.int32))

    lo = np.arange(1 - h, 1)
    hi_i = np.arange(npx, npx + h)
    hi_j = np.arange(npy, npy + h)
    if direction == 1:   # XDir (tp_core.F90:258-287)
        out.append(block(lo, lo, lambda i, j: (j, 1 - i)))
        out.append(block(hi_i, lo, lambda i, j: (npy - j, i - npx + 1)))
        out.append(block(hi_i, hi_j, lambda i, j: (j, 2 * npx - 1 - i)))
        out.append(block(lo, hi_j, lambda i, j: (npy - j, i - 1 + npx)))
    else:                # YDir (tp_core.F90:289-318)
        out.append(block(lo, lo, lambda i, j: (1 - j, i)))
        out.append(block(hi_i, lo, lambda i, j: (npy + j - 1, npx - i)))
        out.append(block(hi_i, hi_j, lambda i, j: (i, 2 * npy - 1 - j)))
        out.append(block(lo, hi_j, lambda i, j: (j + 1 - npx, npy - i)))
    return out


@lru_cache(maxsize=32)
def _corner_block_plan(n, h, direction):
    """Each corner-block source map is a dihedral transform of a contiguous
    h x h block: return (dest slices, source slices, (transpose, flip rows,
    flip cols)) so copy_corners needs no gathers."""
    plans = []
    for jsl, isl, sj, si in _corner_fill_idx(n, h, direction):
        j0, i0 = int(sj.min()), int(si.min())
        want = sj * 1000 + si
        blk0 = (np.arange(j0, j0 + h)[:, None] * 1000
                + np.arange(i0, i0 + h)[None, :])
        found = None
        for trans in (False, True):
            for fj in (False, True):
                for fi_ in (False, True):
                    t = blk0.T if trans else blk0
                    if fj:
                        t = t[::-1, :]
                    if fi_:
                        t = t[:, ::-1]
                    if found is None and np.array_equal(t, want):
                        found = (trans, fj, fi_)
        assert found is not None, "corner map is not a dihedral transform"
        plans.append((jsl, isl, slice(j0, j0 + h), slice(i0, i0 + h), found))
    return plans


def copy_corners(q, h, direction):
    """Fill the 4 corner halo blocks of a padded cell array for a directional
    sweep (tp_core.F90:245-320). q: [..., P, P] padded with halo h;
    direction: 1 = x-sweep, 2 = y-sweep. Returns a new tensor."""
    n = q.shape[-1] - 2 * h
    blocks = []
    for jsl, isl, jsrc, isrc, (trans, fj, fi_) in _corner_block_plan(
            n, h, direction):
        blk = q[..., jsrc, isrc]
        if trans:
            blk = blk.transpose(-1, -2)
        if fj:
            blk = blk.flip(-2)
        if fi_:
            blk = blk.flip(-1)
        blocks.append((jsl, isl, blk))
    out = q.clone()
    for jsl, isl, blk in blocks:
        out[..., jsl, isl] = blk
    return out
