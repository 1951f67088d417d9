"""Hydrostatic initialization utilities, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/model/init_hydro.py (FV3
tools/init_hydro.F90): p_var:45 derives the auxiliary pressures from delp,
with the optional global dry-mass adjustment and the nonhydrostatic delz
construction; hydro_eq is the isothermal hydrostatic state over terrain.
The column sums run in the tensors' dtype, float64 in the tests.
"""

import torch

from .. import constants as con
from .thermodynamics import interface_pressure


def p_var(delp, pt, ptop, q=None, delz=None, hydrostatic=True,
          adjust_dry_mass=False, dry_mass=98290.0, area=None,
          make_nh=False):
    """(ps, pe, peln, pk, pkz) from (ptop, delp), with the optional global
    dry-mass adjustment and delz rebuild (init_hydro.F90 p_var:45).

    delp, pt [6, K, n, n] (pt the temperature); q: tracer dict (for the
    dry-mass and virtual-temperature corrections); area [6, n, n]. Returns
    a dict of the derived fields and the possibly adjusted delp (and delz
    and w when nonhydrostatic or make_nh)."""
    akap = con.KAPPA
    if adjust_dry_mass and area is not None:
        # global dry-mass fixer (p_var:116-150, drymadj): a uniform
        # correction added to the lowest layer's thickness
        qv = q.get("sphum") if q else None
        psd_col = ptop + torch.sum(
            delp * (1.0 - qv) if qv is not None else delp, dim=1)
        psd_mean = torch.sum(psd_col * area) / torch.sum(area)
        dpd = dry_mass - psd_mean
        delp = delp.clone()
        delp[:, -1] += dpd

    pe = interface_pressure(delp, ptop)
    peln = torch.log(pe)
    pk = torch.exp(akap * peln)
    pkz = (pk[:, 1:] - pk[:, :-1]) / (akap * (peln[:, 1:] - peln[:, :-1]))
    ps = pe[:, -1]
    out = dict(delp=delp, pe=pe, peln=peln, pk=pk, pkz=pkz, ps=ps)

    if not hydrostatic or make_nh:
        if delz is None or make_nh:
            # hydrostatic delz from the gas law (p_var:171-183)
            tv = (pt * (1.0 + con.ZVIR * q["sphum"])
                  if (q and "sphum" in q) else pt)
            delz = -con.RDGAS * tv / con.GRAV * (peln[:, 1:] - peln[:, :-1])
        out["delz"] = delz
        out["w"] = torch.zeros_like(delp)
    return out


def hydro_eq(npz, ps0, phis, ak, bk, ptop, t0=300.0):
    """Isothermal hydrostatic state over terrain (init_hydro.F90
    hydro_eq): ps from the hypsometric relation, uniform T. phis
    [6, n, n] or [6, 1, n, n] (a tensor; ak, bk go to its device and
    dtype). Returns (delp, pt, ps)."""
    hs = phis if phis.ndim == 3 else phis[:, 0]
    ps = ps0 * torch.exp(-hs / (con.RDGAS * t0))
    akl = torch.as_tensor(ak, dtype=hs.dtype,
                          device=hs.device).reshape(1, -1, 1, 1)
    bkl = torch.as_tensor(bk, dtype=hs.dtype,
                          device=hs.device).reshape(1, -1, 1, 1)
    pe = akl + bkl * ps[:, None]
    delp = pe[:, 1:] - pe[:, :-1]
    pt = torch.full_like(delp, t0)
    return delp, pt, ps
