"""Checkpoint and restart, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/io/restart.py (the roles of FV3
tools/fv_restart.F90 and tools/fv_io.F90): state save and resume, and
import/export of the fv_core.res NetCDF layout (fv_io.F90:272-332).

Native checkpoints are .npz archives, or .fvio containers written by the
C++ writer thread (io/native_io.py), of the state dict with a sha256
manifest (the mpp_chksum stand-in). Tensors go to the host with their
dtype unchanged, so a checkpoint written here and one written by the JAX
package are the same file for the same state: either package resumes
from either's checkpoints, with the same manifest checksums.
"""

import hashlib
import json
import os

import numpy as np
import torch

from .. import constants as con


def to_host(a):
    """A numpy array of a tensor (moved to the host, dtype unchanged) or an
    array-like."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _checksum(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def save_state(path, state, ak=None, bk=None, tracers=None, step=0,
               time_seconds=0.0):
    """Write a native checkpoint of a state dict of tensors or arrays (and
    the tracers dict): `.fvio` through the C++ writer, anything else as
    `.npz`; the file appears under `path` by an atomic rename once it is
    complete."""
    path = str(path)
    payload = {}
    manifest = {"step": step, "time_seconds": time_seconds, "checksums": {}}
    for k, v in state.items():
        if v is None:
            continue
        payload[k] = to_host(v)
        manifest["checksums"][k] = _checksum(payload[k])
    for name, qv in (tracers or {}).items():
        key = f"tracer__{name}"
        payload[key] = to_host(qv)
        manifest["checksums"][key] = _checksum(payload[key])
    if ak is not None:
        payload["ak"] = to_host(ak)
        payload["bk"] = to_host(bk)
    payload["__manifest__"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8)
    if path.endswith(".fvio"):
        from .native_io import AsyncWriter
        tmp = path + ".tmp"
        with AsyncWriter(tmp) as w:
            for k, v in payload.items():
                w.write(k, v)
        os.replace(tmp, path)
        return
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def _split(arrays, manifest, path, verify):
    state, tracers = {}, {}
    for k, arr in arrays:
        if verify and k in manifest["checksums"]:
            if _checksum(arr) != manifest["checksums"][k]:
                raise ValueError(f"checksum mismatch for {k} in {path}")
        if k.startswith("tracer__"):
            tracers[k[len("tracer__"):]] = arr
        else:
            state[k] = arr
    return state, tracers, manifest


def load_state(path, verify_checksums=True):
    """Read a native checkpoint -> (state dict, tracers dict, manifest) of
    numpy arrays, each array checked against its manifest checksum when
    verify_checksums."""
    if str(path).endswith(".fvio"):
        from .native_io import read_fvio
        z = read_fvio(path)
        manifest = json.loads(bytes(z.pop("__manifest__")).decode())
        return _split(z.items(), manifest, path, verify_checksums)
    with np.load(path) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
        return _split(((k, z[k]) for k in z.files if k != "__manifest__"),
                      manifest, path, verify_checksums)


# ---- fv_core.res NetCDF interop -------------------------------------------

def export_fv_core_res(path, state, ak, bk, tracers=None):
    """Write an fv_core.res-style NetCDF3 file (the six tiles stacked on a
    'tile' dimension; FV3 writes one file per tile)."""
    from scipy.io import netcdf_file
    u = to_host(state["u"])
    T, K, ny, nx = u.shape[0], u.shape[1], u.shape[2], to_host(
        state["v"]).shape[3]
    with netcdf_file(path, "w") as f:
        f.createDimension("tile", T)
        f.createDimension("zaxis_1", K)
        f.createDimension("zedge", K + 1)
        f.createDimension("yaxis_1", ny)          # n+1 (u rows)
        f.createDimension("yaxis_2", ny - 1)      # n
        f.createDimension("xaxis_1", nx)          # n+1 (v cols)
        f.createDimension("xaxis_2", nx - 1)      # n

        def put(name, arr, dims):
            var = f.createVariable(name, "d", dims)
            var[:] = to_host(arr).astype(np.float64)

        cell = ("tile", "zaxis_1", "yaxis_2", "xaxis_2")
        put("ak", ak, ("zedge",))
        put("bk", bk, ("zedge",))
        put("u", state["u"], ("tile", "zaxis_1", "yaxis_1", "xaxis_2"))
        put("v", state["v"], ("tile", "zaxis_1", "yaxis_2", "xaxis_1"))
        put("T", state["pt"], cell)
        put("delp", state["delp"], cell)
        if state.get("w") is not None:
            put("W", state["w"], cell)
        if state.get("delz") is not None:
            put("DZ", state["delz"], cell)
        if state.get("phis") is not None:
            ph = to_host(state["phis"])
            put("phis", ph[:, 0] if ph.ndim == 4 else ph,
                ("tile", "yaxis_2", "xaxis_2"))
        for name, qv in (tracers or {}).items():
            put(name, qv, cell)


def import_fv_core_res(path):
    """Read an export back -> (state dict, ak, bk, tracers) of numpy
    arrays."""
    from scipy.io import netcdf_file
    rename = {"T": "pt", "W": "w", "DZ": "delz"}
    known = {"u", "v", "delp", "phis", "ak", "bk"}
    state, tracers = {}, {}
    with netcdf_file(path, "r", mmap=False) as f:
        for name, var in f.variables.items():
            arr = np.array(var[:])
            if name in rename:
                state[rename[name]] = arr
            elif name in known:
                state[name] = arr
            else:
                tracers[name] = arr
    return state, state.pop("ak", None), state.pop("bk", None), tracers


def make_nh_state(pt, delp, ptop, sphum=None):
    """make_nh startup conversion (fv_restart.F90:707-724): w = 0 and delz
    from the hydrostatic relation delz = (Rd/g) Tv (ln pe_k - ln pe_k+1)
    (negative). pt: TEMPERATURE [6, K, n, n]. Returns (w, delz)."""
    from ..model.thermodynamics import interface_pressure
    peln = torch.log(interface_pressure(delp, ptop))
    tv = pt if sphum is None else pt * (1.0 + con.ZVIR * sphum)
    delz = (con.RDGAS / con.GRAV) * tv * (peln[:, :-1] - peln[:, 1:])
    return torch.zeros_like(pt), delz


def add_thermal_noise(pt, amplitude, seed=0):
    """add_noise startup option (fv_restart.F90:617-638): add uniform
    [0, amplitude) noise from a seeded generator on pt's device and return
    (pt_new, rms_added), the rms the reference logs,
    sqrt(mean(pert * amplitude^2))."""
    gen = torch.Generator(device=pt.device).manual_seed(seed)
    pert = torch.rand(pt.shape, generator=gen, dtype=pt.dtype,
                      device=pt.device)
    rms = torch.sqrt(torch.mean(pert * amplitude ** 2))
    return pt + pert * amplitude, float(rms)


def remap_restart(state, tracers, ak_r, bk_r, ak, bk, g, kord=4,
                  hydrostatic=True):
    """Vertical remap of a restart state from the file's (ak_r, bk_r)
    coordinate (npz_rst levels) onto the run's (ak, bk) coordinate
    (fv_io.F90 remap_restart:624 / rst_remap:860, the npz_rst namelist
    flag, fv_restart.F90:277).

    state: dict with the interior tensors delp, pt, u, v [, w, delz]
    [6, K_r, ...] on one device; tracers: dict of [6, K_r, n, n] (or None);
    the coordinates as host arrays or tensors. pt is TEMPERATURE. Returns
    (state, tracers) on the run coordinate, on the state's device, by the
    reference recipe: ps from the restart column mass; the tracers on p
    (iv = 0), the winds on wall-averaged p (iv = -1), the virtual
    temperature on log p (iv = 1, geopotential-conserving), delz as
    specific volume (iv = 1), all with the monotone kord 4 and
    map1_ppm_ext's extrapolation past the source column."""
    from ..ops import fv_mapz
    from ..ops.sw_core import _rl, _cl
    from ..ops.fill_corners import fi

    delp_r = state["delp"]
    dt, dev = delp_r.dtype, delp_r.device
    n = delp_r.shape[-1]
    H = 3
    ctr = slice(H, H + n)
    wsl = slice(fi(1), fi(n + 1) + 1)

    def kl(a):                       # k-minor for the remap operators
        return torch.movedim(torch.as_tensor(a, dtype=dt, device=dev), 1, -1)

    def kf(a):
        return torch.movedim(a, -1, 1)

    def e1(v):
        return torch.as_tensor(to_host(v), dtype=dt,
                               device=dev).reshape(1, 1, 1, -1)

    ps = e1(ak_r)[..., 0] + torch.sum(delp_r, dim=1)
    pe1 = e1(ak_r) + e1(bk_r) * ps[..., None]     # [6, y, x, K_r+1]
    pe2 = e1(ak) + e1(bk) * ps[..., None]
    delp_new = kf(pe2[..., 1:] - pe2[..., :-1])

    q_r = tracers or {}
    tv = state["pt"]
    if "sphum" in q_r:
        tv = tv * (1.0 + con.ZVIR * q_r["sphum"])

    new_q = None
    if q_r:
        names = list(q_r.keys())
        qk = fv_mapz.map1_ppm_ext(
            torch.stack([kl(q_r[k]) for k in names], 1), pe1[:, None],
            pe2[:, None], iv=0, kord=kord)
        new_q = {nm: kf(qk[:, i]) for i, nm in enumerate(names)}

    out = {"delp": delp_new}
    if not hydrostatic and state.get("w") is not None:
        out["w"] = kf(fv_mapz.map1_ppm_ext(kl(state["w"]), pe1, pe2, iv=-1,
                                           kord=kord))
        if state.get("delz") is not None:
            # remap -delz/delp ("specific volume"), then scale back
            spv = -kl(state["delz"]) / kl(delp_r)
            spv2 = fv_mapz.map1_ppm_ext(spv, pe1, pe2, iv=1, kord=kord)
            out["delz"] = -kf(spv2) * delp_new

    # geopotential-conserving virtual-temperature remap on log p
    pt_new = kf(fv_mapz.map1_ppm_ext(kl(tv), torch.log(pe1),
                                     torch.log(pe2), iv=1, kord=kord))
    if "sphum" in q_r:
        pt_new = pt_new / (1.0 + con.ZVIR * new_q["sphum"])
    out["pt"] = pt_new

    # the winds on edge pressures from wall-averaged ps (rst_remap:984-999,
    # :1117)
    ps_pad = g.halo.pad_cell(ps[:, None])
    ps_u = 0.5 * (ps_pad[..., wsl, ctr] + _rl(ps_pad)[..., wsl, ctr])[:, 0]
    out["u"] = kf(fv_mapz.map1_ppm_ext(
        kl(state["u"]), e1(ak_r) + e1(bk_r) * ps_u[..., None],
        e1(ak) + e1(bk) * ps_u[..., None], iv=-1, kord=kord))
    ps_v = 0.5 * (ps_pad[..., ctr, wsl] + _cl(ps_pad)[..., ctr, wsl])[:, 0]
    out["v"] = kf(fv_mapz.map1_ppm_ext(
        kl(state["v"]), e1(ak_r) + e1(bk_r) * ps_v[..., None],
        e1(ak) + e1(bk) * ps_v[..., None], iv=-1, kord=kord))

    for k2 in ("phis", "ps"):
        if k2 in state:
            out[k2] = state[k2]
    return out, new_q


def reset_eta(state, tracers, ak_old, bk_old, g, npz=None, npz_type=None,
              kord=4, hydrostatic=True):
    """reset_eta startup option (fv_arrays.F90 reset_eta): rebuild (ak, bk)
    from set_eta for the requested (or the current) npz and remap the
    restart state onto them through remap_restart. Returns (state,
    tracers, ak, bk, ptop), ak and bk as float64 host arrays."""
    from ..grid.fv_eta import set_eta
    K = state["delp"].shape[1] if npz is None else int(npz)
    kw = {} if npz_type is None else dict(npz_type=npz_type)
    _, ptop, ak, bk = set_eta(K, **kw)
    st2, tr2 = remap_restart(state, tracers, ak_old, bk_old, ak, bk, g,
                             kord=kord, hydrostatic=hydrostatic)
    return st2, tr2, ak, bk, ptop


def save_coarse_state(path, state, q, g, factor, ak=None, bk=None,
                      strategy="model_level_area_weighted", **kw):
    """Write a coarse-grained restart beside the native one
    (coarse_grained_restart_files.F90:48): coarsen the prognostic state
    (dicts of tensors) by `factor` with the chosen strategy, then save it
    through the checkpoint writer (save_state's keywords). Returns the
    coarse (state, tracers)."""
    from ..utils.coarse_graining import coarse_grain_restart
    cs, cq = coarse_grain_restart(state, q, g, factor, strategy=strategy)
    save_state(path, cs, ak=ak, bk=bk, tracers=cq, **kw)
    return cs, cq
