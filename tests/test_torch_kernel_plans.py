"""The launch plans of the port's tp sweep and c_sw kernels (ops/tiles.py,
ops/tp_sweep.py launch_plan, ops/csw.py launch_plan), on the CPU: the boxes
cover every output frame exactly once, a block's shared memory fits the
card, the Python constants are the kernels' own (csrc/tp2d_sweep.cu,
csrc/c_sw.cu), the tp sweep reads each operand where it lies, c_sw
allocates only its outputs, and both raise ValueError for what the kernels
do not take. The kernels themselves run only on the card (chip_smoke.py
phase 2 holds them against their plain versions)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import build_grid_ops
from gfdl_atmos_cubed_sphere_tpu_torch.ops import csw, tiles, tp_sweep

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
    for bad in (dict(hord=7), dict(hord=10, mfx=ops["ra_y"][..., :N, :N + 1])):
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
