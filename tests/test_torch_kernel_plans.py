"""The launch plans of the port's tp sweep, c_sw, column-pressure and
ke_section kernels (ops/tiles.py, ops/tp_sweep.py, ops/csw.py,
ops/pg_col.py and ops/ke.py launch_plan), on the CPU: the boxes and tiles
cover every output frame exactly once, a block's shared memory fits the
card, the Python constants are the kernels' own (csrc/tp2d_sweep.cu,
csrc/c_sw.cu, csrc/col_pressure.cu, csrc/ke_section.cu), the tp sweep and
ke_section read each operand where it lies, c_sw, pgradc_fused, pkgz and
geopk allocate only their outputs (pkgz one tensor that holds pk and gz),
and each raises ValueError for what its kernel does not take. The
kernels themselves run only on the card (chip_smoke.py phase 2 holds them
against their plain versions)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import build_grid_ops
from gfdl_atmos_cubed_sphere_tpu_torch.ops import (csw, dsw, ke, pg_col,
                                                   tiles, tp_sweep)

pytestmark = pytest.mark.fast

NPX = 13
N = NPX - 1
H = 3
P = N + 2 * H
SMEM_LIMIT = 232448
CSRC = Path(tp_sweep.__file__).parents[1] / "csrc"


@pytest.fixture(scope="module")
def grid():
    return build_grid_ops(NPX, dtype=torch.float64, device="cpu")


def _source(name):
    return (CSRC / f"{name}.cu").read_text()


def _boxes(src):
    """{element type: (TX, TY)} of a kernel source's Box specialisations."""
    return {t: (int(x), int(y)) for t, x, y in re.findall(
        r"struct Box<(float|double)> \{ static constexpr int TX = (\d+), "
        r"TY = (\d+); \};", src)}


def _count_enum(src, name, last):
    """The members of enum `name` before `last`."""
    body = re.search(r"enum %s \{([^}]*)\}" % name, src).group(1)
    members = [m.strip() for m in body.split(",") if m.strip()]
    return members.index(last)


def test_plan_constants_are_the_kernels():
    tp, cs = _source("tp2d_sweep"), _source("c_sw")
    assert _boxes(tp) == {"float": tp_sweep.BOX[4], "double": tp_sweep.BOX[8]}
    assert _boxes(cs) == {"float": csw.BOX[4], "double": csw.BOX[8]}
    assert _count_enum(tp, "Slot", "N_PLANES") == tp_sweep.SMEM_PLANES
    guard = int(re.search(r"constexpr int GUARD_ROWS = (\d+);", cs).group(1))
    assert _count_enum(cs, "Plane", "N_PLANES") == csw.SMEM_PLANES
    assert guard == csw.GUARD_ROWS


def _covers_once(n, nt, kind, frame):
    hits = np.zeros(frame, int)
    for lo, hi in tiles.owned_ranges(n, nt, kind):
        hits[lo:hi] += 1
    return bool((hits == 1).all())


@pytest.mark.parametrize("kernel", ["tp2d_sweep", "c_sw"])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n", [12, 24, 192, 768])
def test_boxes_cover_each_output_frame_once(n, itemsize, kernel):
    """Boxes of at most TX x TY cells, at least min(n, TX / 2) wide and
    never under 3 (only the box holding a cube corner reaches into its
    halo); their owned points cover each output frame exactly once: the
    tp sweep's fx [n, n + 1] and fy [n + 1, n], c_sw's padded cell, wall
    and corner frames. A tp sweep window row or column fits a warp."""
    box = (tp_sweep.BOX if kernel == "tp2d_sweep" else csw.BOX)[itemsize]
    tx, ty, ntx, nty = tiles.plan(box, n)
    assert (tx, ty) == box
    for nt, most in ((ntx, tx), (nty, ty)):
        st = tiles.box_starts(n, nt)
        sizes = np.diff(st)
        assert st[0] == 0 and st[-1] == n
        assert sizes.max() <= most and sizes.min() >= min(n, most // 2) >= 3
        if kernel == "tp2d_sweep":
            assert sizes.max() + 6 <= 32
            kinds = (("compute_cells", n), ("compute_walls", n + 1))
        else:
            kinds = (("cells", n + 6), ("walls", n + 7))
        for kind, frame in kinds:
            assert _covers_once(n, nt, kind, frame), (kind, nt)


def test_shared_memory_fits_a_block():
    """Every form of each kernel fits the 232448 bytes a Hopper block can
    take; each kernel fits four blocks an SM in float32 (its launch
    bounds)."""
    for itemsize in (4, 8):
        b = tp_sweep.smem_bytes(itemsize)
        tx, ty = tp_sweep.BOX[itemsize]
        assert b == tp_sweep.SMEM_PLANES * (ty + 7) * (tx + 7) * itemsize
        assert b <= SMEM_LIMIT
        assert csw.smem_bytes(itemsize) <= SMEM_LIMIT
    assert 4 * (tp_sweep.smem_bytes(4) + 1024) <= 233472
    assert 4 * (csw.smem_bytes(4) + 1024) <= 233472


def _tp_operands(T, K, rank5, rng):
    """The operands as tracer_2d (rank 5) or update_dz_d (rank 4) hand
    them over: walls sliced from full-wall arrays, ra_x / ra_y from full
    cell arrays, metrics [6, 1, ...] broadcast over the levels."""
    W = N + 1
    lead = (6, T, K) if rank5 else (6, K)
    wl = (6, 1, K) if rank5 else (6, K)
    ml = (6, 1, 1) if rank5 else (6, 1)

    def r(*s):
        return torch.as_tensor(rng.standard_normal(s))

    wsl, ctr = slice(H, H + W), slice(H, H + N)
    return dict(
        q=r(*lead, P, P), crx=r(*wl, P, P + 1)[..., :, wsl],
        cry=r(*wl, P + 1, P)[..., wsl, :], xfx=r(*wl, P, P + 1)[..., :, wsl],
        yfx=r(*wl, P + 1, P)[..., wsl, :], area=r(*ml, P, P),
        ra_x=r(*wl, P, P)[..., :, ctr], ra_y=r(*wl, P, P)[..., ctr, :],
        dxa=r(*ml, P, P), dya=r(*ml, P, P),
        mfx=r(*wl, N, W) if rank5 else None,
        mfy=r(*wl, W, N) if rank5 else None)


@pytest.mark.parametrize("rank5", [False, True])
def test_tp_sweep_reads_operands_where_they_lie(rank5):
    """The packing passes each operand's own storage (the caller's sliced
    wall and ra tensors included: no copy_corners, no contiguous copy) with
    its own strides, 0 along a broadcast axis, and allocates only fx and
    fy."""
    rng = np.random.default_rng(21)
    T, K = (6, 3) if rank5 else (1, 4)
    ops = _tp_operands(T, K, rank5, rng)
    plan = tp_sweep.launch_plan(hord=8 if rank5 else 10, **ops)
    assert plan.iv[:3] == (N, T, K)
    assert plan.iv[5:8] == ((8, 8, 1) if rank5 else (8, 10, tp_sweep.RUN))
    for b, name in enumerate(tp_sweep.OPERANDS):
        given, packed = ops[name], plan.ops[b]
        st = plan.strides[5 * b:5 * b + 5]
        if given is None:
            assert packed is None and st == [0] * 5
            continue
        assert packed is given and packed.data_ptr() == given.data_ptr()
        lead = given.shape if rank5 else (6, 1) + tuple(given.shape[1:])
        own = given.stride() if rank5 else \
            (given.stride(0), 0) + given.stride()[1:]
        assert st == [0 if lead[d] == 1 else own[d] for d in range(5)]
    assert not ops["crx"].is_contiguous()
    lead = (6, T, K) if rank5 else (6, K)
    assert tuple(plan.fx.shape) == lead + (N, N + 1)
    assert tuple(plan.fy.shape) == lead + (N + 1, N)
    assert tp_sweep.launches == 0


def test_tp_sweep_raises_on_what_it_does_not_take():
    rng = np.random.default_rng(22)
    ops = _tp_operands(1, 2, False, rng)
    for bad in (dict(hord=14), dict(hord=0), dict(hord=-7),
                dict(hord=10, mfx=ops["ra_y"][..., :N, :N + 1])):
        with pytest.raises(ValueError):
            tp_sweep.launch_plan(**dict(ops, **bad))
    with pytest.raises(ValueError, match="rank"):
        tp_sweep.launch_plan(**dict(ops, hord=10,
                                    area=ops["area"].unsqueeze(0)))
    with pytest.raises(ValueError, match="shape"):
        tp_sweep.launch_plan(**dict(ops, hord=10, dxa=ops["dxa"][..., 1:]))
    with pytest.raises(ValueError, match="dtype"):
        tp_sweep.launch_plan(**dict(ops, hord=10, dya=ops["dya"].float()))
    small = _tp_operands(1, 1, False, rng)
    with pytest.raises(ValueError, match="6 cells"):
        tp_sweep.launch_plan(small["q"][..., 4:-4, 4:-4], *(
            small[k][..., 4:-4, 4:-4] for k in ("crx", "cry")), 10, *(
            small[k][..., 4:-4, 4:-4] for k in ("xfx", "yfx", "area",
                                                 "ra_x", "ra_y", "dxa",
                                                 "dya")))


@pytest.mark.parametrize("hydro", [False, True])
@pytest.mark.parametrize("nord", [0, 1])
def test_c_sw_allocates_only_its_outputs(grid, hydro, nord):
    """The packing passes the fields and the grid's metric planes as they
    lie (a field sliced from a larger array keeps its strides), allocates
    the ten outputs and nothing else (no workspace; wc None in the
    hydrostatic form, divg_d None at nord 0)."""
    rng = np.random.default_rng(23)
    K, W = 3, P + 1

    def f(*s):
        return torch.as_tensor(rng.standard_normal((6, K + 2) + s))[:, 1:-1]

    fields = dict(delp=f(P, P), pt=f(P, P), w=None if hydro else f(P, P),
                  u=f(W, P), v=f(P, W))
    plan = csw.launch_plan(**fields, g=grid, dt2=450.0, nord=nord)
    for b, name in enumerate(("delp", "pt", "w", "u", "v")):
        a = fields[name]
        assert plan.fields[b] is a
        assert plan.strides[4 * b:4 * b + 4] == (
            [0] * 4 if a is None else list(a.stride()))
    assert not fields["delp"].is_contiguous()
    assert [m.data_ptr() for m in plan.metrics] == [
        getattr(grid, nm).data_ptr() for nm in csw.METRICS]
    assert len(plan.outs) == 10
    assert (plan.outs[2] is None) == hydro and plan.out.wc is plan.outs[2]
    assert (plan.outs[9] is None) == (nord == 0)
    frames = [(P, P), (P, P), (P, P), (P, W), (W, P), (P, P), (P, P),
              (P, W), (W, P), (W, W)]
    for o, fr in zip(plan.outs, frames):
        assert o is None or tuple(o.shape) == (6, K) + fr
    assert plan.iv == (N, K, *tiles.plan(csw.BOX[8], N)[2:], csw.RUN,
                       *csw.BOX[8], csw.smem_bytes(8))
    assert set(vars(plan.out)) == {"delpc", "ptc", "wc", "uc", "vc", "ua",
                                   "va", "ut", "vt", "divg_d"}
    assert csw.launches == 0


def test_c_sw_raises_on_what_it_does_not_take(grid):
    K, W = 2, P + 1

    def z(*s):
        return torch.zeros((6, K) + s, dtype=torch.float64)

    ok = dict(delp=z(P, P), pt=z(P, P), w=z(P, P), u=z(W, P), v=z(P, W),
              g=grid, dt2=450.0, nord=0)
    for bad in (dict(u=z(P, W)), dict(pt=z(P, P).float()),
                dict(delp=z(P, P)[0])):
        with pytest.raises(ValueError):
            csw.launch_plan(**dict(ok, **bad))
    with pytest.raises(ValueError, match="8 cells"):
        csw.launch_plan(**dict(ok, delp=z(13, 13)))
    from types import SimpleNamespace
    g2 = SimpleNamespace(**{nm: getattr(grid, nm) for nm in csw.METRICS})
    g2.dxc = grid.dxc.transpose(-1, -2).contiguous().transpose(-1, -2)
    with pytest.raises(ValueError, match="dxc"):
        csw.launch_plan(**dict(ok, g=g2))


COL_DEPTHS = (10, 16, 32, 79, 127)


def test_col_pressure_constants_are_the_kernels():
    src = _source("col_pressure")
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (\w+) = (\d+);", src)}
    names = ("RING", "BATCH", "WIN_X", "MAX_ROWS", "GZ_SLOTS", "UP_FIELDS",
             "PKGZ_THREADS")
    assert {k: consts[k] for k in names} == {
        k: getattr(pg_col, k) for k in names}
    assert pg_col.PGC_ROWS[0] == pg_col.MAX_ROWS
    assert pg_col.PKGZ_BLOCKS[0] == pg_col.PKGZ_THREADS
    # the shared-memory formulas: the same terms in the same order
    assert "(K + 1 + GZ_SLOTS + UP_FIELDS * RING) * WIN_X * rows" in src
    assert "(size_t)(K + 2 * RING) * threads * sizeof(T)" in src


def test_card_checks_take_every_last_batch():
    """The column depths chip_smoke.py checks on the card, with the main
    paths' 79 and 10, leave every count of levels (0 to BATCH - 1) to
    pgradc_fused's last batch, each an instantiation of its own."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    depths = {K for K, _ in cs.COLUMN_DEPTHS} | {79, 10}
    assert {K % pg_col.BATCH for K in depths} == set(range(pg_col.BATCH))
    assert "case 1:" in _source("col_pressure")


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("K", COL_DEPTHS)
def test_col_pressure_blocks_fit(K, itemsize):
    """Every depth the hydrostatic paths run (the tests' 10 and 16, the
    CLI's 32, 79, and up to 127) has a plan in both dtypes whose block fits
    the 232448 bytes a Hopper block can take, and pgradc_fused's leaves
    room for two blocks an SM."""
    pg = pg_col.launch_plan("pgradc_fused", K, P, P, itemsize)
    pk = pg_col.launch_plan("pkgz", K, P, P, itemsize)
    assert pg.smem == pg_col.pgradc_smem(K, pg.rows, itemsize) <= SMEM_LIMIT
    assert 2 * (pg.smem + 1024) <= 233472
    assert pg.threads == pg_col.WIN_X * pg.rows and pg.rows >= 2
    assert pk.smem == pg_col.pkgz_smem(K, pk.threads, itemsize) <= SMEM_LIMIT
    assert pk.threads % 32 == 0 and pk.grid[0] * pk.threads >= 6 * P * P
    # a deeper column never takes a larger block
    if K > COL_DEPTHS[0]:
        prev = COL_DEPTHS[COL_DEPTHS.index(K) - 1]
        assert pg.rows <= pg_col.launch_plan("pgradc_fused", prev, P, P,
                                             itemsize).rows


@pytest.mark.parametrize("K,itemsize", [(79, 4), (79, 8), (127, 8)])
@pytest.mark.parametrize("n", [12, 48, 192])
def test_pgradc_tiles_cover_each_frame_once(n, K, itemsize):
    """pgradc_fused's blocks, on the grid the kernel is launched with, own
    31 x (rows - 1) wall points each; clipped to the frames, they cover
    uc's [P, W] and vc's [W, P] points exactly once, and a block's window
    of WIN_X x rows cells holds the cells its points read (i-1 and i, j-1
    and j)."""
    Pn, Wn = n + 6, n + 7
    plan = pg_col.launch_plan("pgradc_fused", K, Pn, Pn, itemsize)
    hits = np.zeros((Wn, Wn), int)
    for j0, j1, i0, i1 in pg_col.owned_points(plan):
        assert j1 - j0 == plan.rows - 1 and i1 - i0 == pg_col.WIN_X - 1
        hits[j0:min(j1, Wn), i0:min(i1, Wn)] += 1
        # window cells [j0 - 1, j1) x [i0 - 1, i1): WIN_X x rows
        assert (j1 - j0 + 1, i1 - i0 + 1) == (plan.rows, pg_col.WIN_X)
    assert (hits[:Pn, :] == 1).all()          # uc [P, W]
    assert (hits[:, :Pn] == 1).all()          # vc [W, P]
    assert (hits == 1).all()


def _col_cells(K, dtype=torch.float64):
    rng = np.random.default_rng(31)

    def f(*s):
        return torch.as_tensor(rng.standard_normal(s), dtype=dtype)

    return f(6, K, P, P), f(6, K, P, P), f(6, 1, P, P), f


def test_pgradc_fused_allocates_only_its_outputs(grid, monkeypatch):
    """pgradc_fused's arguments: the caller's tensors where they lie (no
    copy of a contiguous operand, phis as a view), uc_out and vc_out the
    only tensors allocated (no pk/gz workspace), the plan's grid passed to
    the launch; pkgz allocates one [6, 2(K+1), P, P] tensor, whose halves
    are pk and gz and which pkgz_joined finds."""
    K, W = 4, P + 1
    delp, pt, phis, f = _col_cells(K)
    uc, vc = f(6, K, P, W), f(6, K, W, P)
    made = []
    empty = torch.empty

    def counting(*a, **kw):
        made.append(a)
        return empty(*a, **kw)

    monkeypatch.setattr(torch, "empty", counting)
    a = pg_col.pgradc_args(delp, pt, phis, uc, vc, grid, NPX)
    assert len(made) == 2 and len(a.outs) == 2
    assert [tuple(o.shape) for o in a.outs] == [(6, K, P, W), (6, K, W, P)]
    assert [x.data_ptr() for x in a.ins] == [
        x.data_ptr() for x in (delp, pt, phis, uc, vc, grid.rdxc, grid.rdyc)]
    assert a.iv == (N, K, a.plan.rows) + a.plan.grid[:2]
    assert a.plan.grid[2] == 6
    made.clear()
    b = pg_col.pkgz_args(delp, pt, phis)
    assert len(made) == 1
    assert tuple(b.out.shape) == (6, 2 * (K + 1), P, P)
    assert b.outs[0].data_ptr() == b.out.data_ptr()
    assert b.outs[1].data_ptr() == b.out[:, K + 1].data_ptr()
    assert pg_col.pkgz_joined(*b.outs).data_ptr() == b.out.data_ptr()
    assert b.iv == (K, P, P, b.plan.threads, b.plan.grid[0])
    assert pg_col.launches == {"pgradc_fused": 0, "pkgz": 0, "geopk": 0}


def test_col_pressure_raises_on_what_it_does_not_take(grid):
    K, W = 3, P + 1
    delp, pt, phis, f = _col_cells(K)
    uc, vc = f(6, K, P, W), f(6, K, W, P)
    for kernel in ("pgradc_fused", "pkgz"):
        for bad_k in (0, 2000):
            with pytest.raises(ValueError):
                pg_col.launch_plan(kernel, bad_k, P, P, 8)
    deep, deep_pt, _, _ = _col_cells(2000, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        pg_col.pkgz_args(deep, deep_pt, phis.float())
    with pytest.raises(ValueError, match="shared memory"):
        pg_col.pgradc_args(deep, deep_pt, phis.float(), *(
            torch.zeros((6, 2000) + s) for s in ((P, W), (W, P))),
            type(grid)(**{**vars(grid), "rdxc": grid.rdxc.float(),
                          "rdyc": grid.rdyc.float()}), NPX)
    bad = [dict(uc=f(6, K, W, P)), dict(vc=vc.float()), dict(npx=NPX + 1),
           dict(delpc=delp[0]), dict(ptc=pt[:, 1:]),
           dict(phis_p=phis[..., 1:]),
           dict(delpc=f(6, K, P, W), ptc=f(6, K, P, W),
                phis_p=f(6, 1, P, W))]
    ok = dict(delpc=delp, ptc=pt, phis_p=phis, uc=uc, vc=vc, g=grid,
              npx=NPX)
    for b in bad:
        with pytest.raises(ValueError):
            pg_col.pgradc_args(**dict(ok, **b))
    for b in (dict(pt_p=pt.float()), dict(pt_p=pt[:, 1:]),
              dict(phis_p=phis[..., 1:]), dict(delp_p=delp[0])):
        with pytest.raises(ValueError):
            pg_col.pkgz_args(**dict(dict(delp_p=delp, pt_p=pt, phis_p=phis),
                                    **b))
    with pytest.raises(ValueError):
        pg_col.pkgz_args(delp.int(), pt.int(), phis.int())


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("K", [10, 79, 125])
def test_geopk_takes_the_pkgz_column_kernel(K, itemsize):
    """geopk launches pkgz's column kernel (the FULL form of k_geopk; PR
    4's k_columns is gone) on pkgz's plan: the same threads, grid and
    shared memory, which fit the 232448 bytes a Hopper block can take, four
    blocks an SM at c192_hydro's K = 79 in float32."""
    src = _source("col_pressure")
    assert "k_columns" not in src and "ColArgs" not in src
    assert "run_geopk<float, true>" in src and "run_geopk<float, false>" in src
    gp = pg_col.launch_plan("geopk", K, P, P, itemsize)
    pk = pg_col.launch_plan("pkgz", K, P, P, itemsize)
    assert vars(gp) == vars(pk)
    assert gp.smem == pg_col.pkgz_smem(K, gp.threads, itemsize) <= SMEM_LIMIT
    assert gp.threads in pg_col.PKGZ_BLOCKS and gp.rows is None
    assert gp.grid[0] * gp.threads >= 6 * P * P
    if (K, itemsize) == (79, 4):
        assert gp.threads == 128 and 4 * (gp.smem + 1024) <= 233472


def test_geopk_allocates_only_its_outputs(monkeypatch):
    """geopk's arguments: the caller's tensors where they lie (no copy of a
    contiguous operand, phis as a view), pe, peln, pk, gz and pkz the only
    tensors allocated (no workspace, no joined buffer), the plan's threads
    and grid passed to the launch."""
    K = 5
    delp, pt, phis, _ = _col_cells(K)
    made = []
    empty = torch.empty

    def counting(*a, **kw):
        made.append(a)
        return empty(*a, **kw)

    monkeypatch.setattr(torch, "empty", counting)
    a = pg_col.geopk_args(delp, pt, phis)
    assert len(made) == 5 and len(a.outs) == 5
    assert [tuple(o.shape) for o in a.outs] == [(6, K + 1, P, P)] * 4 + [
        (6, K, P, P)]
    assert len({o.data_ptr() for o in a.outs}) == 5
    assert [x.data_ptr() for x in a.ins] == [
        x.data_ptr() for x in (delp, pt, phis)]
    assert a.iv == (K, P, P, a.plan.threads, a.plan.grid[0])
    assert a.plan.grid[1:] == (1, 1)
    for b in (dict(pt_p=pt.float()), dict(phis_p=phis[..., 1:]),
              dict(delp_p=delp[0])):
        with pytest.raises(ValueError):
            pg_col.geopk_args(**dict(dict(delp_p=delp, pt_p=pt,
                                          phis_p=phis), **b))
    assert pg_col.launches["geopk"] == 0


@pytest.mark.parametrize("rows", [1, 8, ke.ROWS, 40])
@pytest.mark.parametrize("n", [12, 768])
def test_ke_strips_cover_the_corner_frame_once(n, rows):
    """ke_section's warp strips of SPAN corner columns and `rows` corner
    rows, on the grid the kernel is launched with (WARPS strips of rows a
    block), clipped to the frame, cover the W x W corner frame exactly
    once; the kernel's constants are the wrapper's."""
    Wn = n + 7
    gx, gy = ke.grid(n, rows)
    strips = ke.owned_corners(n, rows)
    assert len(strips) == gx * gy * ke.WARPS
    hits = np.zeros((Wn, Wn), int)
    for j0, j1, i0, i1 in strips:
        assert (j1 - j0, i1 - i0) == (rows, ke.SPAN)
        hits[j0:min(j1, Wn), i0:min(i1, Wn)] += 1
    assert (hits == 1).all()
    # no block is launched whose strips all lie past the frame
    assert (gx - 1) * ke.SPAN < Wn and (gy - 1) * ke.WARPS * rows < Wn
    src = _source("ke_section")
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert {k: int(consts[k]) for k in ("WARPS", "SPAN", "ROWS")} == {
        "WARPS": ke.WARPS, "SPAN": ke.SPAN, "ROWS": ke.ROWS}
    assert ke.SPAN < 32


def _ke_operands(K, dtype=torch.float64, seed=41):
    rng = np.random.default_rng(seed)
    NC, NW = N + 6, N + 7

    def f(k, *s):
        return torch.as_tensor(rng.standard_normal((6, k) + s), dtype=dtype)

    yw, xw = (NW, NC), (NC, NW)
    return dict(u=f(K, *yw), v=f(K, *xw), uc=f(K, *xw), vc=f(K, *yw),
                ut=f(K, *xw), vt=f(K, *yw), cosa=f(1, NW, NW),
                rsina=f(1, NW, NW), dx=f(1, *yw), rdx=f(1, *yw),
                dy=f(1, *xw), rdy=f(1, *xw))


def test_ke_section_reads_operands_where_they_lie():
    """The packing passes each operand's own storage (a field sliced along
    its levels included: no contiguous copy) with its tile and level
    strides, 0 along a metric's level axis, and allocates only ke; only an
    operand whose rows are not contiguous (here a transposed dy and a uc
    cut from wider rows) is copied."""
    K = 3
    ops = _ke_operands(K)
    NC, NW = N + 6, N + 7
    rng = np.random.default_rng(42)
    ops["v"] = torch.as_tensor(rng.standard_normal((6, K + 2, NC, NW)))[
        :, 1:-1]
    ops["uc"] = torch.as_tensor(rng.standard_normal((6, K, NC, NW + 4)))[
        ..., 2:-2]
    ops["dy"] = torch.as_tensor(rng.standard_normal((6, 1, NW, NC))
                                ).transpose(-1, -2)
    assert not any(ops[k].is_contiguous() for k in ("v", "uc", "dy"))
    plan = ke.launch_plan(**ops, hord_mt=6, npx=NPX)
    for b, name in enumerate(ke.OPERANDS):
        given, packed = ops[name], plan.ops[b]
        if name in ("dy", "uc"):
            assert packed.is_contiguous() and torch.equal(packed, given)
        else:
            assert packed is given
        want = [packed.stride(0), K * 0 if packed.shape[1] == 1
                else packed.stride(1)]
        assert plan.strides[2 * b:2 * b + 2] == want
    assert plan.strides[2:4] == [(K + 2) * NC * NW, NC * NW]
    assert plan.strides[12:16] == [NW * NW, 0, NW * NW, 0]
    assert tuple(plan.ke.shape) == (6, K, NW, NW)
    assert plan.iv == (N, K, 6, ke.ROWS) + ke.grid(N, ke.ROWS)
    assert ke.launches == 0


def test_ke_section_raises_on_what_it_does_not_take():
    ops = _ke_operands(2)
    for hord in (0, 14, -7):
        with pytest.raises(ValueError, match="hord"):
            ke.launch_plan(**ops, hord_mt=hord, npx=NPX)
    with pytest.raises(ValueError, match="shape"):
        ke.launch_plan(**dict(ops, ut=ops["ut"][..., 1:]), hord_mt=6,
                       npx=NPX)
    with pytest.raises(ValueError, match="shape"):
        ke.launch_plan(**ops, hord_mt=6, npx=NPX + 1)
    with pytest.raises(ValueError, match="dtype"):
        ke.launch_plan(**dict(ops, vc=ops["vc"].float()), hord_mt=6,
                       npx=NPX)
    with pytest.raises(ValueError, match="float32 or float64"):
        ke.launch_plan(**{k: v.int() for k, v in ops.items()}, hord_mt=6,
                       npx=NPX)
    with pytest.raises(ValueError, match="u \\[6, K"):
        ke.launch_plan(**dict(ops, u=ops["u"][0]), hord_mt=6, npx=NPX)
    with pytest.raises(ValueError, match="6 cells"):
        ke.launch_plan(**{k: v[..., :10, :10] for k, v in ops.items()},
                       hord_mt=6, npx=6)


def _args_read(src, arr):
    """{field: index} of the kernel's make_args reads a.field = arr[index]."""
    return {f: int(i) for f, i in
            re.findall(r"a\.(\w+) = %s\[(\d+)\];" % arr, src)}


@pytest.mark.parametrize("K", [79, 91])
def test_d_sw_plans_carry_every_kernel_argument(grid, K):
    """The d_sw stage kernels' launch plans at the SHiELD namelist's
    arguments (hord_dp -5, hord 5, nord 2 with nord_v = nord_w = 2) and
    beyond (nord 3, nord_v2 = 2, nord_w2 = 1, lim_fac 0.5), at the L79 and
    L91 depths: each int and double parameter sits where the kernel's
    make_args reads it (csrc/d_sw_fluxes.cu, csrc/d_sw_winds.cu), the
    per-level profiles are (damp x da_min)^(nord + 1) of each combo, dd8
    is (da_min_c d4_bg)^(nord + 1), the box and shared-memory bytes are
    the kernels' own and fit a block. The tp sweep's and ke_section's
    plans carry every hord of KERNEL_HORDS (tp: ord_in 8 for hord 10)."""
    rng = np.random.default_rng(31)
    W = P + 1

    def f(*s):
        return torch.as_tensor(rng.standard_normal((6, K) + s))

    dv_, dw_, dv2, dw2 = (np.linspace(a, 2 * a, K)
                          for a in (0.02, 0.03, 0.04, 0.05))
    fkw = dict(dt=225.0, hord_dp=-5, hord_tm=5, hord_vt=5, nord_v=2,
               damp_v=dv_, damp_v2=dv2, nord_v2=2, damp_w=dw_, nord_w=2,
               damp_w2=dw2, nord_w2=1, ke_bg=0.0, lim_fac=0.5)
    fields, mets, outs, prof, iv, dv, out = dsw._fluxes_operands(
        f(P, P), f(P, P), f(P, P), f(P, W), f(W, P), grid, **fkw)
    tx, ty, ntx, nty = dsw.tile_plan("fluxes", N, 8)
    want = dict(n=N, K=K, hord_dp=-5, hord_vt=5, hord_tm=5, nord_v=2,
                nord_w=2, nord_v2=2, nord_w2=1, on_v=1, on_v2=1, on_w=1,
                on_w2=1, ntx=ntx, nty=nty)
    src = _source("d_sw_fluxes")
    reads = _args_read(src, "iv")
    assert set(reads) == set(want) and len(iv) == len(want) + 4
    assert all(iv[i] == want[k] for k, i in reads.items())
    assert iv[13] == 0
    assert list(iv[-3:]) == [tx, ty, dsw.smem_bytes("fluxes", 8)]
    assert "iv[%d] != Box<T>::TX" % (len(iv) - 3) in src
    dreads = _args_read(src, "dv")
    assert dreads == {"dt": 0, "dd8": 1, "lim": 2} and dv[2] == 0.5
    for p_, d, m, nd in zip(prof, (dv_, dv2, dw_, dw2),
                            (grid.da_min, grid.da_min, grid.da_min_c,
                             grid.da_min_c), (2, 2, 2, 1)):
        assert torch.allclose(p_, (torch.as_tensor(d) * m) ** (nd + 1),
                              rtol=1e-14, atol=0)
    seam = {"crx": f(P, W), "cry": f(W, P), "xfx": f(P, W), "yfx": f(W, P),
            "ra_x": f(P, P), "ra_y": f(P, P), "ut": f(P, W), "vt": f(W, P)}
    wkw = dict(dt=225.0, hord_mt=-6, hord_vt=13, nord=3, nord_v=2,
               dddmp=0.2, d2_bg=np.zeros(K), d4_bg=0.12, damp_v=dv_,
               d_con=np.ones(K), nord_mask=None, damp_v2=dv2, nord_v2=2,
               lim_fac=0.5)
    ins, mets, outs, prof, iv, dv, out = dsw._winds_operands(
        f(P, P), f(W, P), f(P, W), f(P, W), f(W, P), f(P, P), f(P, P),
        f(W, W), f(W, W), f(N, N), seam, grid, **wkw)
    tx, ty, ntx, nty = dsw.tile_plan("winds", N, 8)
    want = dict(n=N, K=K, hord_mt=-6, hord_vt=13, nord=3, nord_v=2,
                nord_v2=2, need0=0, needN=1, smag=1, do_heat=1, on_v=1,
                on_v2=1, ntx=ntx, nty=nty)
    src = _source("d_sw_winds")
    reads = _args_read(src, "iv")
    assert set(reads) == set(want) and len(iv) == len(want) + 4
    assert all(iv[i] == want[k] for k, i in reads.items())
    assert iv[13] == 0
    assert list(iv[-3:]) == [tx, ty, dsw.smem_bytes("winds", 8)]
    assert "iv[%d] != Box<T>::TX" % (len(iv) - 3) in src
    dreads = _args_read(src, "dv")
    assert dreads == {"dt": 0, "dddmp": 1, "da_min_c": 2, "dd8": 3,
                      "lim": 4}
    assert dv[3] == float((grid.da_min_c * 0.12) ** 4) and dv[4] == 0.5
    assert torch.allclose(prof[4], (torch.as_tensor(dv2) * grid.da_min_c)
                          ** 3, rtol=1e-14, atol=0)
    for stage in ("fluxes", "winds"):
        for itemsize in (4, 8):
            assert dsw.smem_bytes(stage, itemsize) <= SMEM_LIMIT
    ops = _tp_operands(1, K, False, rng)
    kops = _ke_operands(K)
    for hord in tp_sweep.KERNEL_HORDS:
        plan = tp_sweep.launch_plan(**dict(ops, hord=hord))
        assert plan.iv[5:7] == (8 if hord == 10 else hord, hord)
        assert ke.launch_plan(**kops, hord_mt=hord, npx=NPX).iv[2] == hord
    assert ke.KERNEL_HORDS == tp_sweep.KERNEL_HORDS
    assert dsw.KERNEL_NORDS == (0, 1, 2, 3)
    assert dsw.launches == {"fluxes": 0, "winds": 0}


def test_d_sw_forms_reach_the_kernels(grid):
    """The d_sw stage kernels' two forms (the usual arguments' and every
    argument's): the operands' `every` lands in iv[13], where the kernels'
    run reads it (0 unless asked: the form the arguments need), and each
    kernel's resources export, as the tp sweep's, takes the form."""
    rng = np.random.default_rng(37)
    W, K = P + 1, 2

    def f(*s):
        return torch.as_tensor(rng.standard_normal((6, K) + s))

    fkw = dict(dt=225.0, hord_dp=10, hord_tm=10, hord_vt=10, nord_v=1,
               damp_v=0.02, damp_w=0.02, nord_w=1)
    args = (f(P, P), f(P, P), f(P, P), f(P, W), f(W, P), grid)
    for name in ("d_sw_fluxes", "d_sw_winds"):
        src = _source(name)
        assert "const bool gen = iv[13] != 0 ||" in src
        assert 13 not in _args_read(src, "iv").values()
        assert (f'extern "C" int {name}_attrs(int gen, int dtype, int* out)'
                in src)
    for every in (False, True):
        kw = fkw if not every else dict(fkw, every=True)
        assert dsw._fluxes_operands(*args, **kw)[4][13] == int(every)
    seam = {k: f(P, P) for k in dsw.SEAM}
    iv = dsw._winds_operands(f(P, P), f(W, P), f(P, W), f(P, W), f(W, P),
                             f(P, P), f(P, P), f(W, W), f(W, W), f(N, N),
                             seam, grid, dt=225.0, hord_mt=10, hord_vt=10,
                             nord=1, nord_v=1, dddmp=0.2, d2_bg=0.0,
                             d4_bg=0.12, damp_v=0.02, every=True)[4]
    assert iv[13] == 1
    assert ('extern "C" int tp2d_sweep_attrs(int gen, int dtype, int* out)'
            in _source("tp2d_sweep"))
