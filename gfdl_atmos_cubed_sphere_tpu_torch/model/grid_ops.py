"""Device-side grid operator pack (PyTorch port).

Counterpart of gfdl_atmos_cubed_sphere_tpu/model/grid_ops.py. Bridges the
host-side f64 metric precompute (grid/metrics.py) to the tensor code: casts
every metric array to the working dtype on the chosen device, splits the
9-component supergrid trig factors into separate arrays, inserts a broadcast
axis for the level dimension, and precomputes the a2b_ord4 cube-corner
extrapolation weights (a2b_edge.F90:449-461 extrap_corner distances).

Field layout everywhere: [6, npz, y, x]; metrics [6, 1, y, x].
"""

from types import SimpleNamespace

import numpy as np
import torch

from ..grid.gnomonic import great_circle_angle
from ..grid.metrics import GridGeometry, build_grid_geometry
from ..grid.topology import cube_topology
from ..ops.a2b_edge import corner_legs
from ..parallel.halo import HaloExchanger

H = 3

#: metric arrays carried as [6, 1, y, x] tensors (the JAX pack's inventory)
METRIC_NAMES = (
    "dx", "dy", "dxa", "dya", "dxc", "dyc",
    "rdx", "rdy", "rdxa", "rdya", "rdxc", "rdyc",
    "area", "rarea", "area_c", "rarea_c",
    "cosa", "sina", "rsina", "cosa_u", "sina_u", "rsin_u",
    "cosa_v", "sina_v", "rsin_v", "cosa_s", "rsin2",
    "divg_u", "divg_v", "del6_u", "del6_v",
    "a11", "a12", "a21", "a22", "z11", "z12", "z21", "z22",
    "l2c_u", "l2c_v", "fC", "f0") + tuple(
        f"{p}_sg{c}" for c in range(1, 10) for p in ("sin", "cos")) + (
    "edge_w", "edge_e", "edge_s", "edge_n",
    "edge_vect_w", "edge_vect_e", "edge_vect_s", "edge_vect_n")

#: 0-d scalars of the pack, kept as 0-d tensors in the working dtype
SCALAR_NAMES = ("da_min", "da_max", "da_min_c", "da_max_c")


def resolve_device(device):
    """torch.device for `device`; a CUDA device must exist (no CPU
    fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is present; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def device_of(*xs, device=None):
    """The device an entry point runs on: `device` when given, else that of
    the first tensor among xs, else the CUDA card (resolve_device: no CPU
    fallback). Host (numpy) inputs then go to that device."""
    if device is None:
        device = next((x.device for x in xs if torch.is_tensor(x)), "cuda")
    return resolve_device(device)


def corner_weights(agrid_xyz, grid_xyz, npx):
    """a2b_ord4 cube-corner extrapolation weights x1/(x2-x1) [6, 4, 3]
    (a2b_edge.F90 extrap_corner:449) from halo-padded cell centres
    [6, NC, NC, 3] and corners [6, NW, NW, 3]."""
    f = lambda i: i - 1 + H
    targets = {"sw": (1, 1), "se": (1, npx), "ne": (npx, npx), "nw": (npx, 1)}
    legs = corner_legs(npx)
    w = np.zeros((6, 4, 3))
    for ci, name in enumerate(("sw", "se", "ne", "nw")):
        tj, ti = targets[name]
        p0 = grid_xyz[:, f(tj), f(ti)]
        for li, (j1, i1, j2, i2) in enumerate(legs[name]):
            x1 = great_circle_angle(agrid_xyz[:, f(j1), f(i1)], p0)
            x2 = great_circle_angle(agrid_xyz[:, f(j2), f(i2)], p0)
            w[:, ci, li] = x1 / (x2 - x1)
    return w


def _pack(arrays, npx, dtype, device, topology):
    """Assemble the pack from arrays already in the JAX pack's layout
    ([6, 1, ...] metrics, 0-d scalars, a2b_corner_w [6, 1, 4, 3])."""
    n = npx - 1
    dev = resolve_device(device)
    g = SimpleNamespace()
    g.npx = npx
    g.n = n
    g.dtype = dtype
    g.device = dev
    g.halo = HaloExchanger(topology, H, device=dev)

    def t(a):
        return torch.as_tensor(np.array(a, order="C"), dtype=dtype,
                               device=dev)

    for name in METRIC_NAMES + SCALAR_NAMES + ("a2b_corner_w",):
        setattr(g, name, t(arrays[name]))
    g.global_area = float(arrays["global_area"])

    # full-width corner-aligned a2b edge factors (the TPU path builds them
    # at ops/pallas_a2b.py:67-92): value at padded corner index c_f + 2 is
    # edge_x[c_f - 1] for c_f in [2, npx-1], zero elsewhere
    def full(nm):
        return torch.nn.functional.pad(getattr(g, nm)[..., 1:n], (4, 4))

    g.edge_w_full = full("edge_w")[..., :, None]       # [6, 1, NW, 1]
    g.edge_e_full = full("edge_e")[..., :, None]
    g.edge_s_full = full("edge_s")[..., None, :]       # [6, 1, 1, NW]
    g.edge_n_full = full("edge_n")[..., None, :]
    return g


def build_grid_ops(npx, dtype=torch.float32, device="cuda",
                   geom: GridGeometry = None, coriolis_alpha=0.0,
                   radius=None, omega=None, stretch_fac=None, target_lon=0.0,
                   target_lat=0.0, do_cube_transform=False):
    """Build the metric namespace `g` + halo exchanger for a cube of npx
    corners on `device` (the CUDA card unless the caller asks for the CPU;
    raises RuntimeError when CUDA is asked for and absent). radius, omega:
    the planet's (the Earth's when None); stretch_fac et al.: Schmidt
    refinement (see grid.metrics.build_grid_geometry, angles in radians),
    as utils.config.grid_kwargs_from_namelist gives them."""
    resolve_device(device)
    kw = {}
    if radius is not None:
        kw["radius"] = radius
    if omega is not None:
        kw["omega"] = omega
    if stretch_fac is not None:
        kw.update(stretch_fac=stretch_fac, target_lon=target_lon,
                  target_lat=target_lat, do_cube_transform=do_cube_transform)
    if geom is None:
        geom = build_grid_geometry(npx, ng=H, coriolis_alpha=coriolis_alpha,
                                   **kw)
    a = geom.arrays
    arrays = {}
    for name in METRIC_NAMES:
        if "_sg" in name:
            p, c = name.split("_sg")
            arrays[name] = a[f"{p}_sg"][..., int(c) - 1][:, None]
        else:
            arrays[name] = np.asarray(a[name])[:, None]
    for name in SCALAR_NAMES + ("global_area",):
        arrays[name] = np.asarray(getattr(geom, name))
    arrays["a2b_corner_w"] = corner_weights(a["agrid_xyz"], a["grid_xyz"],
                                            npx)[:, None]
    g = _pack(arrays, npx, dtype, device, geom.topology)
    g.geom = geom
    _physics_metrics(g, geom)
    return g


def _physics_metrics(g, geom):
    """The geometry the physics coupling reads beside the dynamics' pack
    (model/fv_update_phys.py, model/thermodynamics.py, physics/): cell
    latitude and longitude [6, 1, NC, NC], the cell lat-lon unit vectors
    vlon, vlat [6, 1, NC, NC, 3], and the compute-domain edge unit vectors
    es (direction 1 on the y-walls, [6, 1, n+1, n, 3]) and ew (direction 2
    on the x-walls, [6, 1, n, n+1, 3]); built once, in the working
    dtype."""
    a, h, n = geom.arrays, geom.ng, g.n

    def t(arr):
        return torch.as_tensor(np.array(arr, order="C")[:, None],
                               dtype=g.dtype, device=g.device)

    for name in ("aglat", "aglon", "vlon", "vlat"):
        setattr(g, name, t(a[name]))
    g.es1 = t(a["es"][:, h:h + n + 1, h:h + n, 0, :])
    g.ew2 = t(a["ew"][:, h:h + n, h:h + n + 1, 1, :])


def grid_from_arrays(arrays, npx, dtype=torch.float32, device="cuda"):
    """The port's pack from the JAX pack's arrays as numpy
    (``np.asarray(getattr(g_jax, name))`` for every name of METRIC_NAMES,
    SCALAR_NAMES, a2b_corner_w and global_area), so both packages can run
    on identical metrics."""
    g = _pack(arrays, npx, dtype, device, cube_topology(npx))
    g.geom = None
    return g


#: state arrays state_from_arrays carries across (whichever are present)
STATE_NAMES = ("delp", "pt", "u", "v", "w", "delz", "phis", "uc", "vc",
               "ak", "bk")


def state_from_arrays(arrays, dtype=torch.float32, device="cuda"):
    """The carry-across function: tensors on `device` for the numpy state
    arrays of `arrays` (the shallow-water delp, u, v, phis, uc, vc and the
    nonhydrostatic delp, pt, u, v, w, delz, phis with the ak, bk
    coefficients, and the tracer dict under "q": whichever are present), so
    both packages can run on identical state."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a, order="C"), dtype=dtype,
                               device=dev)

    out = {k: t(arrays[k]) for k in STATE_NAMES if k in arrays}
    if "q" in arrays:
        out["q"] = {k: t(a) for k, a in arrays["q"].items()}
    return out

