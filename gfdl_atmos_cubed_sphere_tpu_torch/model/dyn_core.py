"""The acoustic-loop cores, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/model/dyn_core.py (FV3
model/dyn_core.F90 dyn_core:94, geopk:2202, p_grad_c:1635, nh_p_grad:1697,
one_grad_p:1909). Per acoustic iteration, nonhydrostatic:
  c_sw -> update_dz_c -> Riem_Solver_C -> p_grad_c -> d_sw ->
  update_dz_d -> Riem_Solver3 -> nh_p_grad;
hydrostatic:
  c_sw -> geopk(C) + p_grad_c (pgradc_fused) -> d_sw -> geopk(D) (pkgz)
  -> one_grad_p.
c_sw, d_sw, the SIM1 / SIM column solve and the hydrostatic column
pressures run through their kernel wrappers (ops/csw.py, ops/dsw.py,
ops/sim1.py, ops/pg_col.py): the hand-written CUDA kernels for CUDA
tensors, the plain versions for CPU tensors. The acoustic-loop options run
as plain PyTorch, as in the JAX package: the off-centred pressure
gradients split_p_grad / grad1_p_update (beta > 0, dyn_core.F90:1795,
:2033), the external-mode damping external_mode_divg2 (d_ext > 0,
hydrostatic), mix_dp (fill_dp, :2119) and the inline Rayleigh damping
ray_fast (rf_fast, :2485), with every Riemann solver of ops/nh_core.py.
The nonhydrostatic loop runs the inline fast physics (do_fast_phys,
dyn_core.F90:1101-1109 / fast_phys.F90:58) at the end of each iteration
when given a tracer dict and an MPConfig: the microphysics' fast_sat_adj,
plain PyTorch.

Fields are [6, npz, y, x]; level-interface fields [6, npz+1, y, x].
"""

import math
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from .. import constants as con
from ..io.restart import to_host
from ..ops import pg_col
from ..ops.a2b_edge import a2b_ord2, a2b_ord4
from ..ops.fill_corners import fi
# geopk is importable from here, as in the JAX package; the loops call it
# through pg_col, where a caller may wrap it
from ..ops.pg_col import geopk, p_grad_c  # noqa: F401

H = 3


@dataclass(frozen=True)
class DynConfig:
    """Hydrostatic-core subset of fv_core_nml (fv_arrays.F90 defaults)."""
    npx: int
    npz: int
    dt: float
    n_split: int = 5
    k_split: int = 1
    hord_mt: int = 10
    hord_vt: int = 10
    hord_tm: int = 10
    hord_dp: int = 10
    hord_tr: int = 8
    q_split: int = 0
    kord_mt: int = 8
    kord_tm: int = -8
    kord_tr: int = 8
    nord: int = 1
    dddmp: float = 0.0
    d2_bg: float = 0.0
    d4_bg: float = 0.16
    # sponge-layer del-2 strengths; the raw fv_arrays defaults (4./2.) are
    # "must specify" sentinels clamped by fv_control.F90:1032 to these values
    d2_bg_k1: float = 0.20
    d2_bg_k2: float = 0.015
    do_vort_damp: bool = True
    vtdm4: float = 0.02
    d_con: float = 0.0
    ke_bg: float = 0.0
    lim_fac: float = 1.0
    n_sponge: int = 1
    tau: float = 0.0
    rf_cutoff: float = 3000.0
    p_fac: float = 0.05
    a_imp: float = 1.0
    # pressure-gradient time off-centering (fv_arrays.F90 beta; beta > 0
    # selects grad1_p_update / split_p_grad)
    beta: float = 0.0
    # external (barotropic) mode damping coefficient (fv_arrays.F90:452)
    d_ext: float = 0.0
    # Riemann substeps for the explicit RIM_2D path (|a_imp| <= 0.5);
    # 0 = auto: 1 + |dt_acoustic| (fv_control.F90:1037-1038 sets
    # m_split = 1 + dt_atmos/(k_split*n_split*|p_split|), i.e. ~1 s each)
    m_split: int = 0
    scale_m: float = 0.0
    d2bg_zq: float = 0.0
    # NH pressure gradient on log-p instead of p**kappa interfaces
    # (fv_arrays.F90 use_logp; dyn_core.F90 pk3 <- peln branch)
    use_logp: bool = False
    hydrostatic: bool = True
    adiabatic: bool = True
    # inline saturation adjustment each acoustic iteration
    # (fv_arrays.F90:364 do_fast_phys; dyn_core.F90:1101)
    do_fast_phys: bool = False
    consv_te: float = 0.0
    # global angular-momentum fixer (fv_arrays.F90 consv_am;
    # fv_dynamics.F90:747-800 -> thermodynamics.am_fixer)
    consv_am: bool = False
    fill: bool = False
    fill_dp: bool = False     # mix_dp delp-floor fixer (dyn_core.F90:820)
    rf_fast: bool = False     # inline Rayleigh friction (dyn_core.F90:1058)
    # bitwise layout-invariant global sums in the energy fixer
    # (fv_control.F90:942 reproduce_sum -> parallel/reductions.py)
    reproduce_sum: bool = False
    is_ideal_case: bool = True
    # [stored] the JAX package's scan/unrolled switch of the acoustic loop;
    # the port runs a Python loop either way
    use_scan: bool = True

    # ---- fv_core_nml breadth (fv_arrays.F90:207-906). Every option below
    # is parsed from real SHiELD/GFDL namelists by utils/config.py; ones
    # marked [stored] are accepted + validated but only consumed by the
    # subsystem named in the comment. ---------------------------------------
    nwat: int = 6             # number of water species (0/2/3/6 supported
                              # by neg_adj3/MP; others rejected in __post_init__)
    ncnst: int = 0            # total tracers (0 = from the q dict)
    pnats: int = 0            # [stored] non-advected tracers at the end
    dnats: int = 0            # [stored] dycore-skipped tracers
    dnrts: int = 0            # [stored] non-remapped tracers
    nord_tr: int = 0          # tracer damping order (tracer_2d)
    trdm2: float = 0.0        # tracer del-2 coefficient (tracer_2d)
    kord_wz: int = 9          # w/delz remap order (remap_nh)
    remap_t: bool = True      # remap T (vs theta) — fv_mapz mode
    remap_te: bool = False    # [stored] remap total energy variant
    z_tracer: bool = True     # layer-split tracer advection (tracer_2d IS
                              # the z_tracer=true design; False rejected)
    inline_q: bool = False    # advect q inside the acoustic loop ([stored];
                              # tracer_2d after the loop is the default path)
    range_warn: bool = False  # jit-internal range audits (io.diagnostics)
    fv_debug: bool = False    # [stored] extra prints in drivers
    print_freq: int = 0       # [stored] driver print interval (hours)
    write_3d_diags: bool = True   # [stored] diag manager concern
    nf_omega: int = 1         # del-2 smoothing passes on omega diagnostic
    use_old_omega: bool = True    # [stored] omega from pe vs dp/dt
    convert_ke: bool = False  # [stored] d_con applies to KE directly
    prevent_diss_cooling: bool = False  # [stored] clip diss heating sign
    delt_max: float = 1.0     # max dissipative heating rate (K/s, d_sw)
    do_diss_est: bool = False     # [stored] skeb dissipation estimate diag
    fv_sg_adj: int = -1       # 2dz subgrid mixing timescale (s) — consumed
                              # by ops/fv_sg.fv_sg_adjust via the drivers
    fv_sg_adj_weak: int = -1  # [stored] weak-mixing variant above sg_cutoff
    sg_cutoff: float = -1.0   # fv_sg pressure cutoff (Pa)
    n_zs_filter: int = 0      # terrain filter passes (utils/terrain)
    nord_zs_filter: int = 0   # terrain filter order (utils/terrain)
    full_zs_filter: bool = False  # [stored] filter at init vs restart
    na_init: int = 0          # adiabatic init loops (driver adiabatic_init)
    no_dycore: bool = False   # physics-only mode (driver skips dynamics)
    nudge: bool = False       # grid nudging master switch (physics/nudging)
    nudge_ic: bool = False    # [stored] nudge to a single IC
    nudge_qv: bool = False    # [stored] nudge specific humidity
    nudge_dz: bool = False    # [stored] nudge delz in nest BCs
    breed_vortex_inline: bool = False  # TC breeding (physics/nudging)
    tau_h2o: float = 0.0      # [stored] stratospheric h2o source timescale
    fast_tau_w_sec: float = 0.0   # implicit w sponge at the top (rf_fast)
    dry_mass: float = 98290.0     # target dry mass (io.restart adjustment)
    adjust_dry_mass: bool = False  # (io.restart)
    mountain: bool = False    # [stored] restart has terrain
    p_ref: float = 1.0e5      # reference pressure for pkz/sponge profiles
    check_negative: bool = False  # [stored] MP negative-tracer warnings
    do_held_suarez: bool = False  # Held-Suarez forcing (physics/held_suarez)
    do_f3d: bool = False      # [stored] 3-D Coriolis (shallow-atmosphere
                              # approximation is the only mode)
    fill_wz: bool = False     # [stored] fill w in remap
    fill_gfs: bool = False    # [stored] GFS-style filling in external IC
    filter_phys: bool = False  # [stored]
    dwind_2d: bool = False    # [stored] 2-D A->D wind update variant
    agrid_vel_rst: bool = False   # write A-grid winds to restarts (io)
    restart_from_agrid_winds: bool = False  # (io.restart)
    ignore_rst_cksum: bool = False  # [stored] (io.restart)
    warm_start: bool = False  # [stored] driver concern
    external_eta: bool = False    # ak/bk from file vs set_eta (grid.fv_eta)
    npz_rst: int = 0          # restart vertical remap target (io.restart)
    # nesting / regional group (fv_nest_nml analogs; model/boundary.py,
    # driver/nested.py, driver/regional_cube.py)
    nested: bool = False
    twowaynest: bool = False
    nestbctype: int = 1       # [stored] BC interpolation type
    nestupdate: int = 0       # [stored] two-way update strategy
    nsponge: int = 0          # [stored] nest sponge rows
    s_weight: float = 1.0e-6  # [stored] nest sponge weight
    regional: bool = False
    bc_update_interval: int = 3   # regional BC file cadence (hours)
    nrows_blend: int = 0      # Davies blend rows (fv_regional_bc)
    regional_bcs_from_gsi: bool = False  # [stored]
    write_restart_with_bcs: bool = False  # [stored]
    # planar doubly-periodic grid group (grid_type=4; driver/nested.py)
    dx_const: float = 1000.0
    dy_const: float = 1000.0
    deglat: float = 15.0
    umax: float = 350.0       # [stored] planar max wind for dt estimate
    # coarse-graining output group (utils/coarse_graining)
    write_coarse_restart_files: bool = False
    write_coarse_diagnostics: bool = False
    write_only_coarse_intermediate_restarts: bool = False  # [stored]
    write_coarse_agrid_vel_rst: bool = False  # [stored]
    write_coarse_dgrid_vel_rst: bool = False  # [stored]

    def __post_init__(self):
        if self.nwat not in (0, 2, 3, 6):
            raise ValueError(f"nwat={self.nwat}: only 0/2/3/6 supported "
                             "(fv_sg.neg_adj3 / gfdl_mp categories)")
        if not self.z_tracer:
            raise ValueError("z_tracer=.false. (non-layer-split tracer "
                             "advection) is not supported: tracer_2d is "
                             "the z_tracer design")
        if self.m_split < 0:
            raise ValueError("m_split must be >= 0")


def _sponge_groups(cfg):
    """Per-level damping parameters (dyn_core.F90:675-733 sponge logic).

    Returns a list of (k_slice, overrides) groups: level 0 (and 1 if
    d2_bg_k2 > 0.01) get del-2 divergence damping; the rest use cfg values.
    """
    groups = []
    base = dict(nord=cfg.nord, d2_divg=min(0.20, cfg.d2_bg),
                nord_v=min(2, cfg.nord),
                damp_v=cfg.vtdm4 if cfg.do_vort_damp else 0.0,
                d_con=cfg.d_con)
    if cfg.npz == 1 or cfg.n_sponge < 0:
        groups.append((slice(0, cfg.npz), dict(base, d2_divg=cfg.d2_bg)))
        return groups
    top = dict(base, sponge=True)
    top.update(nord=0, d2_divg=(max(cfg.d2_bg, cfg.d2_bg_k1) if cfg.is_ideal_case
                                else max(0.01, cfg.d2_bg, cfg.d2_bg_k1)),
               d_con=0.0)
    if cfg.do_vort_damp:
        top.update(nord_v=0, damp_v=0.5 * top["d2_divg"])
    groups.append((slice(0, 1), top))
    k0 = 1
    if cfg.d2_bg_k2 > 0.01:
        lvl2 = dict(base, sponge=True)
        lvl2.update(nord=0, d2_divg=max(cfg.d2_bg, cfg.d2_bg_k2), d_con=0.0)
        if cfg.do_vort_damp:
            lvl2.update(nord_v=0, damp_v=0.5 * lvl2["d2_divg"])
        groups.append((slice(1, 2), lvl2))
        k0 = 2
        if cfg.d2_bg_k2 > 0.05:
            lvl3 = dict(base, sponge=True)
            lvl3.update(nord=0, d2_divg=max(cfg.d2_bg, 0.2 * cfg.d2_bg_k2),
                        d_con=0.0)
            groups.append((slice(2, 3), lvl3))
            k0 = 3
    groups.append((slice(k0, cfg.npz), base))
    return groups


def _sponge_level_params(cfg):
    """Flatten _sponge_groups into per-level damping profiles so the whole
    column runs through ONE d_sw call (instead of one call per group —
    4500+ ops/iteration saved; see PERFORMANCE.md). Returns kwargs for
    d_sw's merged-sponge path."""
    groups = _sponge_groups(cfg)
    K = cfg.npz
    d2 = np.zeros(K)
    dcon = np.zeros(K)
    nord_mask = np.zeros(K, bool)
    dv_base = np.zeros(K)       # (damp_v, nord_v=min(2,nord)) combo
    dv_sponge = np.zeros(K)     # (damp_v, nord_v=0) sponge combo
    dw_base = np.zeros(K)
    dw_sponge = np.zeros(K)
    nv_base = min(2, cfg.nord)
    for ksl, p in groups:
        d2[ksl] = p["d2_divg"]
        dcon[ksl] = p["d_con"]
        if p["nord"] == 0 and cfg.nord > 0:
            nord_mask[ksl] = True
        # vorticity/delp damping: the (nord_v=0, 0.5*d2) sponge combo
        if p["nord_v"] == 0 and nv_base > 0:
            dv_sponge[ksl] = p["damp_v"]
        else:
            dv_base[ksl] = p["damp_v"]
        # nonhydro w damping: ALL sponge levels use damp_w = d2_divg with
        # nord_w = 0, unconditionally (dyn_core.F90:709/720/730-731)
        if p.get("sponge") and nv_base > 0:
            dw_sponge[ksl] = p["d2_divg"]
        elif p.get("sponge"):
            dw_base[ksl] = p["d2_divg"]
        else:
            dw_base[ksl] = p["damp_v"]
    return dict(
        nord=cfg.nord, nord_v=nv_base, d2_bg=d2, d_con=dcon,
        nord_mask=nord_mask if nord_mask.any() else None,
        damp_v=dv_base, damp_v2=dv_sponge if dv_sponge.any() else None,
        nord_v2=0,
        damp_w=dw_base, damp_w2=dw_sponge if dw_sponge.any() else None,
        nord_w=nv_base, nord_w2=0)


def _nh_grad_terms(pp, pk3, gz, delp_p, g, dt, npx, ptk):
    """B-grid setup of the nonhydrostatic dual pressure gradient: one
    batched a2b_ord4 of (pp, pk3, gz, delp) [6, 3(K+1)+K, P, P], pp's top
    interface set to 0 and pk3's to ptk, and the dt-scaled increments of
    the hydrostatic (du1, dv1) and the perturbation part (du2, dv2)."""
    f = fi
    wsl = slice(f(1), f(npx) + 1)
    Kp1 = pp.shape[1]
    allB = a2b_ord4(torch.cat([pp, pk3, gz, delp_p], dim=1), g)
    ppB = allB[:, :Kp1].clone()
    pkB = allB[:, Kp1:2 * Kp1].clone()
    gzB = allB[:, 2 * Kp1:3 * Kp1]
    dpB = allB[:, 3 * Kp1:]
    ppB[:, 0] = 0.0
    pkB[:, 0] = ptk

    wk = pkB[:, 1:] - pkB[:, :-1]
    cl_ = slice(f(1), f(npx - 1) + 1)
    cr_ = slice(f(2), f(npx) + 1)
    gz1, gz2 = gzB[:, :-1], gzB[:, 1:]
    pk1, pk2 = pkB[:, :-1], pkB[:, 1:]
    pp1, pp2 = ppB[:, :-1], ppB[:, 1:]

    def grad(a, b, den, x1, x2):
        # a, b: the two index windows (along x for u, along y for v)
        return dt / (den[a] + den[b]) * (
            (gz2[a] - gz1[b]) * (x2[b] - x1[a])
            + (gz1[a] - gz2[b]) * (x2[a] - x1[b]))

    ua_, ub_ = (Ellipsis, wsl, cl_), (Ellipsis, wsl, cr_)
    va_, vb_ = (Ellipsis, cl_, wsl), (Ellipsis, cr_, wsl)
    return (grad(ua_, ub_, wk, pk1, pk2), grad(ua_, ub_, dpB, pp1, pp2),
            grad(va_, vb_, wk, pk1, pk2), grad(va_, vb_, dpB, pp1, pp2))


def nh_p_grad(u_acc, v_acc, pp, pk3, gz, delp_p, g, dt, npx, ptk):
    """Nonhydrostatic dual pressure gradient (dyn_core.F90 nh_p_grad:1696).

    pp: nonhydro pressure perturbation at interfaces [6,K+1,Y,X] padded;
    pk3: hydrostatic pe**kappa interfaces (log p under use_logp); gz:
    geopotential interfaces; delp_p: padded layer thickness. u_acc/v_acc
    are the d_sw outputs in circulation form. One batched a2b_ord4 call
    corner-interpolates all four operands. Returns the final interior D
    winds."""
    ctr = slice(H, H + g.n)
    wsl = slice(fi(1), fi(npx) + 1)
    du1, du2, dv1, dv2 = _nh_grad_terms(pp, pk3, gz, delp_p, g, dt, npx, ptk)
    u_new = (u_acc + du1 + du2) * g.rdx[..., wsl, ctr]
    v_new = (v_acc + dv1 + dv2) * g.rdy[..., ctr, wsl]
    return u_new, v_new


def split_p_grad(u_acc, v_acc, pp, pk3, gz, delp_p, g, dt, npx, ptk,
                 du_old, dv_old, beta):
    """Off-centred nonhydrostatic dual pressure gradient (dyn_core.F90
    split_p_grad:1795, beta > 0): the hydrostatic part is time-split, beta
    of the previous iteration's increment and 1 - beta of this one; the
    perturbation part applies whole. Returns (u, v, du, dv) with the new
    hydrostatic increments for the next acoustic iteration (beta = 0 on the
    first, dyn_core.F90:398-406)."""
    ctr = slice(H, H + g.n)
    wsl = slice(fi(1), fi(npx) + 1)
    du1, du2, dv1, dv2 = _nh_grad_terms(pp, pk3, gz, delp_p, g, dt, npx, ptk)
    alpha = 1.0 - beta
    u_new = (u_acc + beta * du_old + alpha * du1 + du2) * g.rdx[..., wsl, ctr]
    v_new = (v_acc + beta * dv_old + alpha * dv1 + dv2) * g.rdy[..., ctr, wsl]
    return u_new, v_new, du1, dv1


def _pg_terms(pk, gz, g, npx, ptk):
    """B-grid setup of the hydrostatic D-grid pressure gradient
    (one_grad_p:1909): one batched a2b_ord4 of (pk, gz) [6, 2(K+1), P, P]
    (the tensor pk and gz are the halves of, as pkgz returns them, else
    their concatenation),
    pk's top interface set to ptk, and the cross-difference increments
    du [6, K, n+1, n], dv [6, K, n, n+1]."""
    f = fi
    wsl = slice(f(1), f(npx) + 1)
    Kp1 = pk.shape[1]
    both = pg_col.pkgz_joined(pk, gz)
    if both is None:
        both = torch.cat([pk, gz], dim=1)
    bothB = a2b_ord4(both, g)
    pkB = bothB[:, :Kp1].clone()
    gzB = bothB[:, Kp1:]
    pkB[:, 0] = ptk
    wk = pkB[:, 1:] - pkB[:, :-1]
    cl_ = slice(f(1), f(npx - 1) + 1)
    cr_ = slice(f(2), f(npx) + 1)
    gz1, gz2 = gzB[:, :-1], gzB[:, 1:]
    pk1, pk2 = pkB[:, :-1], pkB[:, 1:]

    def grad(a, b):
        # a, b: the two index windows (along x for u, along y for v)
        return ((gz2[a] - gz1[b]) * (pk2[b] - pk1[a])
                + (gz1[a] - gz2[b]) * (pk2[a] - pk1[b])) / (wk[a] + wk[b])

    du = grad((Ellipsis, wsl, cl_), (Ellipsis, wsl, cr_))
    dv = grad((Ellipsis, cl_, wsl), (Ellipsis, cr_, wsl))
    return du, dv


def _divg2_terms(divg2):
    """The external-mode increments of one_grad_p (wk1 / wk2): the
    column-mean potential's differences along the walls, the same on every
    level. divg2 [6, n+1, n+1] interior corners, or None."""
    if divg2 is None:
        return 0.0, 0.0
    return ((divg2[..., :, :-1] - divg2[..., :, 1:])[:, None],
            (divg2[..., :-1, :] - divg2[..., 1:, :])[:, None])


def one_grad_p(u_acc, v_acc, pk, gz, g, dt, npx, ptk, divg2=None):
    """Hydrostatic D-grid pressure gradient (dyn_core.F90 one_grad_p:1909).
    pk, gz [6, K+1, Y, X] padded cell interfaces; u_acc, v_acc: the d_sw
    winds in circulation form; divg2: the external-mode damping potential
    at the interior corners [6, n+1, n+1] (d_ext > 0), or None. Returns the
    final interior D winds."""
    ctr = slice(H, H + g.n)
    wsl = slice(fi(1), fi(npx) + 1)
    du, dv = _pg_terms(pk, gz, g, npx, ptk)
    if divg2 is None:
        u_new = g.rdx[..., wsl, ctr] * (u_acc + dt * du)
        v_new = g.rdy[..., ctr, wsl] * (v_acc + dt * dv)
    else:
        d2u, d2v = _divg2_terms(divg2)
        u_new = g.rdx[..., wsl, ctr] * (u_acc + d2u + dt * du)
        v_new = g.rdy[..., ctr, wsl] * (v_acc + d2v + dt * dv)
    return u_new, v_new


def grad1_p_update(u_acc, v_acc, pk, gz, g, dt, npx, ptk, du_old, dv_old,
                   beta, divg2=None):
    """Off-centred hydrostatic pressure gradient (dyn_core.F90
    grad1_p_update:2033, beta > 0): the wind gets beta of the previous
    acoustic iteration's increment and 1 - beta of this one's; the
    increments carry across iterations (beta = 0 on the first,
    dyn_core.F90:398-406). Returns (u, v, du, dv)."""
    ctr = slice(H, H + g.n)
    wsl = slice(fi(1), fi(npx) + 1)
    du, dv = _pg_terms(pk, gz, g, npx, ptk)
    du = dt * du
    dv = dt * dv
    d2u, d2v = _divg2_terms(divg2)
    alpha = 1.0 - beta
    u_new = g.rdx[..., wsl, ctr] * (u_acc + beta * du_old + d2u + alpha * du)
    v_new = g.rdy[..., ctr, wsl] * (v_acc + beta * dv_old + d2v + alpha * dv)
    return u_new, v_new, du, dv


def external_mode_divg2(delp_p, divg_p, g, d_ext, npx):
    """External (barotropic) mode damping potential (dyn_core.F90:828-846):
    divg2 = d_ext da_min_c x the column mass-weighted mean of the B-grid
    divergence. delp_p padded cells [6,K,Y,X]; divg_p padded corner
    divergence [6,K,NW,NW]. Returns [6, n+1, n+1] at the interior
    corners."""
    wsl = slice(fi(1), fi(npx) + 1)
    delp_b = a2b_ord2(delp_p, g)[..., wsl, wsl]
    dv = divg_p[..., wsl, wsl]
    wsum = torch.sum(delp_b, dim=1)
    return (d_ext * g.da_min_c) * torch.sum(delp_b * dv, dim=1) / wsum


def mix_dp(delp, pt, w, dpmin, hydrostatic=True):
    """delp floor fixer (dyn_core.F90 mix_dp:2119): a layer thinner than 1 %
    of its reference thickness borrows mass from the layer below (the
    bottom layer from the one above), mixing pt (and w) by mass, so the
    column stays conservative. Sequential in k, top down as the JAX
    package's scan: level k's deficit thins level k+1 before k+1 is tested.
    delp, pt, w [T, K, y, x]; dpmin [K] the static floors. Returns (delp,
    pt, w)."""
    K = delp.shape[1]
    dpm = np.asarray(dpmin, np.float64)
    nh = w is not None and not hydrostatic
    w_ = w if nh else torch.zeros_like(delp)
    floors = torch.as_tensor(dpm, dtype=delp.dtype, device=delp.device)
    d_out, p_out, w_out = [], [], []
    d_cur, p_cur, w_cur = delp[:, 0], pt[:, 0], w_[:, 0]
    for k in range(K - 1):
        d_nxt, p_nxt, w_nxt = delp[:, k + 1], pt[:, k + 1], w_[:, k + 1]
        floor = floors[k]
        bad = ~(d_cur >= floor)                 # catches NaN too
        dp = floor - d_cur
        p_out.append(torch.where(bad, (p_cur * d_cur + p_nxt * dp) / floor,
                                 p_cur))
        w_out.append(torch.where(bad, (w_cur * d_cur + w_nxt * dp) / floor,
                                 w_cur))
        d_out.append(torch.where(bad, floor, d_cur))
        d_cur = torch.where(bad, d_nxt - dp, d_nxt)
        p_cur, w_cur = p_nxt, w_nxt
    # the bottom level borrows from the (fixed) level above
    floor = floors[K - 1]
    bad = ~(d_cur >= floor)
    dp = floor - d_cur
    p_out.append(torch.where(bad, (p_cur * d_cur + p_out[-1] * dp) / floor,
                             p_cur))
    w_out.append(torch.where(bad, (w_cur * d_cur + w_out[-1] * dp) / floor,
                             w_cur))
    d_out[-1] = torch.where(bad, d_out[-1] - dp, d_out[-1])
    d_out.append(torch.where(bad, floor, d_cur))
    return (torch.stack(d_out, 1), torch.stack(p_out, 1),
            torch.stack(w_out, 1) if nh else w)


def ray_fast_profile(ak, bk, dt, tau, rf_cutoff, ptop, p_ref=1.e5):
    """Static per-level profile of the inline Rayleigh damping
    (dyn_core.F90 Ray_fast:2485 setup block), on the host. Returns (rf[K],
    dp_ref[K], dm, k_rf); rf == 1 below the cutoff."""
    ak = np.asarray(ak, np.float64)
    bk = np.asarray(bk, np.float64)
    K = ak.size - 1
    ph = np.maximum(ak + bk * p_ref, 1e-8)
    pfull = (ph[1:] - ph[:-1]) / np.log(ph[1:] / ph[:-1])
    dp_ref = np.diff(ak) + np.diff(bk) * 1.e5
    rf = np.ones(K)
    tau0 = tau * 86400.0
    for k in range(K):
        if pfull[k] < rf_cutoff:
            rff = dt / tau0 * np.sin(
                0.5 * np.pi * np.log(rf_cutoff / pfull[k])
                / np.log(rf_cutoff / ptop)) ** 2
            rf[k] = 1.0 / (1.0 + rff)
        else:
            break
    ks = max(int(np.sum(bk == 0.0)) - 1, 0)   # pure-pressure levels
    dm = 0.0
    k_rf = 0
    for k in range(ks):
        if pfull[k] < rf_cutoff + min(100.0, 10.0 * ptop):
            dm += dp_ref[k]
            k_rf = k + 1
        else:
            break
    return rf, dp_ref, dm, k_rf


def ray_fast(u, v, w, rf, dp_ref, dm, k_rf, hydrostatic=True):
    """Momentum-conserving inline Rayleigh damping (dyn_core.F90
    Ray_fast:2551-2599): damp u, v (and w) above rf_cutoff and deposit the
    removed mass-weighted momentum evenly into the top k_rf pressure
    levels; the column sums run in the fields' dtype. Returns (u, v, w)."""
    K = u.shape[1]
    sh = (1, K, 1, 1)
    rfb = torch.as_tensor(rf, dtype=u.dtype, device=u.device).reshape(sh)
    dpb = torch.as_tensor(dp_ref, dtype=u.dtype, device=u.device).reshape(sh)
    kmask = torch.as_tensor(np.arange(K) < k_rf, dtype=u.dtype,
                            device=u.device).reshape(sh)
    loss = (1.0 - rfb) * dpb
    if dm > 0.0 and k_rf > 0:
        dmu = torch.sum(loss * u, dim=1, keepdim=True) / dm
        dmv = torch.sum(loss * v, dim=1, keepdim=True) / dm
    else:
        dmu = dmv = 0.0
    u = u * rfb + kmask * dmu
    v = v * rfb + kmask * dmv
    if w is not None and not hydrostatic:
        w = w * rfb
    return u, v, w


def _column_options(cfg, ak, bk, dt, ptop):
    """The static inputs of the column options both loops take: mix_dp's
    floors (fill_dp) and the ray_fast profile (rf_fast with tau > 0), each
    None when off or when ak, bk are not given, as in the JAX package."""
    dpmin = rfp = None
    if ak is None:
        return dpmin, rfp
    ak, bk = to_host(ak).astype(np.float64), to_host(bk).astype(np.float64)
    if cfg.fill_dp:
        dpmin = 0.01 * (np.diff(ak) + np.diff(bk) * 1.e5)
    if cfg.rf_fast and cfg.tau > 0.0:
        rfp = ray_fast_profile(ak, bk, abs(dt), cfg.tau, cfg.rf_cutoff, ptop)
    return dpmin, rfp


def dyn_core_nh(delp, pt, u, v, w, delz, phis, g, cfg: DynConfig, akap,
                ptop, n_split, dt_acoustic, dp0, ak=None, bk=None, q=None,
                fast_cfg=None, zvir=0.0):
    """Nonhydrostatic acoustic loop (dyn_core.F90, hydrostatic=.false.):
    per iteration c_sw -> update_dz_c -> Riem_Solver_C -> p_grad_c ->
    d_sw [-> mix_dp] -> update_dz_d -> Riem_Solver3 -> nh_p_grad
    (split_p_grad when beta > 0) [-> ray_fast] [-> fast_sat_adj], as a
    Python loop over n_split. ak, bk [K+1] (host arrays or tensors) feed
    fill_dp's floors and rf_fast's profile; without them both are off, as
    in the JAX package. With an MPConfig fast_cfg and a non-empty tracer
    dict q, each iteration ends in the inline fast physics (the do_fast_phys
    hook, dyn_core.F90:1101-1109 / fast_phys.F90:58) on the carried
    tracers; zvir is the virtual-temperature factor of theta_v (0 when the
    big step runs without sphum).

    delp, pt (theta_v), w, delz: [6, K, n, n] interior; u, v D winds;
    phis: unread, as in the JAX package (the surface geopotential is
    g.phis_p, which prepare_phis sets). The loop carries PADDED (delp, pt,
    w, zh): the grouped cell exchange
    issued after d_sw serves both that iteration's Riemann solver and the
    next iteration's c_sw, and the w / zh halos come back halo-valid from
    the columnar Riemann solve (the JAX package's carried-pad schedule).
    Returns the updated fields, the accumulated mass fluxes and Courant
    numbers, the final pressures (pe/peln/pk on the padded frame) and q
    (the tracers after the fast physics, or q as given)."""
    from ..ops import nh_core
    from ..ops.csw import c_sw
    from ..ops.dsw import d_sw
    if fast_cfg is not None and q:
        from ..physics.gfdl_mp import fast_sat_adj
    else:
        fast_cfg = None
    halo = g.halo
    f = fi
    npx = g.npx
    n = g.n
    ctr = slice(H, H + n)
    wsl = slice(f(1), f(npx) + 1)
    dt = dt_acoustic
    dt2 = 0.5 * dt
    # the top interface of the pk3 field the gradient differentiates:
    # log(ptop) under use_logp, else ptop**kappa (dyn_core.F90 peln1/ptk)
    ptk = math.log(ptop) if cfg.use_logp else ptop ** akap
    phis_p = g.phis_p
    phis2 = phis_p[:, 0] if phis_p.ndim == 4 else phis_p
    zs_p = phis2 / con.GRAV
    pl = _sponge_level_params(cfg)
    dp0 = np.asarray(dp0, np.float64)
    damp_zh = cfg.vtdm4 if cfg.do_vort_damp else 0.0
    dpmin, rfp = _column_options(cfg, ak, bk, dt, ptop)
    # RIM_2D's substeps (fv_control.F90:1037-1038)
    ms = cfg.m_split if cfg.m_split > 0 else 1 + int(abs(dt))

    # initial height interfaces from delz
    incr = torch.flip(torch.cumsum(torch.flip(delz, [1]), dim=1), [1])
    zs_i = zs_p[..., ctr, ctr]
    zh = torch.cat([zs_i[:, None] - incr, zs_i[:, None]], dim=1)

    T, K = delp.shape[:2]
    NC, NW = n + 2 * H, n + 1 + 2 * H

    def zeros(*s):
        return delp.new_zeros((T, K) + s)

    mfx, mfy = zeros(n, n + 1), zeros(n + 1, n)
    cx, cy = zeros(NC, NW), zeros(NW, NC)
    delp_p, pt_p, w_p = halo.pad_cells((delp, pt, w))
    zh_p = halo.pad_cell(zh)
    ws = delp.new_zeros((T, n, n))
    dsw_kw = dict(
        dt=dt, hord_mt=cfg.hord_mt, hord_vt=cfg.hord_vt,
        hord_dp=cfg.hord_dp, hord_tm=cfg.hord_tm,
        dddmp=cfg.dddmp, d4_bg=cfg.d4_bg, ke_bg=cfg.ke_bg,
        lim_fac=cfg.lim_fac, **pl)
    dup = dvp = None
    rrg = -con.RDGAS / con.GRAV
    akx = akap / (1.0 - akap)
    qd = dict(q) if fast_cfg is not None else None

    for it in range(n_split):
        u, v = halo.reconcile_dgrid(u, v)
        u_p, v_p = halo.pad_dgrid(u, v)
        cs = c_sw(delp_p, pt_p, w_p, u_p, v_p, g, dt2, nord=cfg.nord)
        gz_c, ws3 = nh_core.update_dz_c(g, cs.ut, cs.vt, zh_p, zs_p, dp0,
                                        dt2, npx)
        pkc, gzc = nh_core.riem_solver_c(dt2, cs.delpc, cs.ptc, cs.wc, gz_c,
                                         phis2, ws3, akap, ptop, cfg.p_fac,
                                         a_imp=cfg.a_imp, ms=ms)
        uc, vc = p_grad_c(cs.uc, cs.vc, cs.delpc, pkc, gzc, g, dt2, npx,
                          hydrostatic=False)
        uc_p, vc_p = halo.pad_cgrid(uc[..., ctr, wsl], vc[..., wsl, ctr])
        divg_p = None
        if cfg.nord > 0:
            divg_p = halo.pad_corner(cs.divg_d[..., wsl, wsl])

        ds = d_sw(delp_p, pt_p, w_p, u_p, v_p, uc_p, vc_p, cs.ua, cs.va,
                  divg_p, g, **dsw_kw)
        delp, pt, w = ds.delp, ds.pt, ds.w
        if dpmin is not None:
            delp, pt, w = mix_dp(delp, pt, w, dpmin, hydrostatic=False)
        mfx, mfy = mfx + ds.fx, mfy + ds.fy
        cx, cy = cx + ds.crx, cy + ds.cry
        delp_p, pt_p, w_p = halo.pad_cells((delp, pt, w))

        # D-stage height advection on the pre-update zh
        zh_int, _ = nh_core.update_dz_d(g, zh_p, ds.crx, ds.cry, ds.xfx,
                                        ds.yfx, zs_i, dp0, dt, cfg.hord_tm,
                                        npx, damp_zh, min(2, cfg.nord),
                                        lim_fac=cfg.lim_fac)
        zh_p2 = halo.pad_cell(zh_int)
        ws_full = (zs_p - zh_p2[:, -1]) * (1.0 / dt)
        rs = nh_core.riem_solver3(dt, delp_p, pt_p, w_p, zh_p2, zs_p,
                                  ws_full, akap, ptop, cfg.p_fac,
                                  use_logp=cfg.use_logp, a_imp=cfg.a_imp,
                                  scale_m=cfg.scale_m, d2bg_zq=cfg.d2bg_zq,
                                  ms=ms)
        w_p = rs.w
        zh_p = rs.zh
        gz_geo = rs.zh * con.GRAV
        if cfg.beta > 0.0:
            if dup is None:
                dup, dvp = torch.zeros_like(u), torch.zeros_like(v)
            # beta = 0 on the first iteration (dyn_core.F90:398-406)
            u, v, dup, dvp = split_p_grad(
                ds.u, ds.v, rs.ppe, rs.pk3, gz_geo, delp_p, g, dt, npx, ptk,
                dup, dvp, 0.0 if it == 0 else cfg.beta)
        else:
            u, v = nh_p_grad(ds.u, ds.v, rs.ppe, rs.pk3, gz_geo, delp_p, g,
                             dt, npx, ptk)
        if rfp is not None:
            # the w damping is columnar: on the PADDED w, so the carried
            # halos stay valid
            u, v, w_p = ray_fast(u, v, w_p, *rfp, hydrostatic=False)
        if fast_cfg is not None:
            # inline saturation adjustment on theta_v: pkz from the gas
            # law, T and q adjusted, theta_v restored. Only the interior
            # of the padded pt changes: its halo stays one phase stale, as
            # in the reference, whose pt pack starts at dyn_core.F90:823
            # before fast_phys runs at :1105
            zh_i = zh_p[..., ctr, ctr]
            delz_in = zh_i[:, 1:] - zh_i[:, :-1]
            pkz = torch.exp(akx * torch.log(rrg * delp / delz_in * pt))
            tvir = pt * pkz
            t_abs = tvir / (1.0 + zvir * qd["sphum"]) if zvir else tvir
            t_new, qd = fast_sat_adj(t_abs, delp, delz_in, qd, dt, ptop,
                                     cfg=fast_cfg, hydrostatic=False)
            tv_new = t_new * (1.0 + zvir * qd["sphum"]) if zvir else t_new
            pt = tv_new / pkz
            pt_p[..., ctr, ctr] = pt
        ws = ws_full[..., ctr, ctr]

    u, v = halo.reconcile_dgrid(u, v)
    delp = delp_p[..., ctr, ctr]
    zh = zh_p[..., ctr, ctr]
    pe = ptop + torch.cat([torch.zeros_like(delp_p[:, :1]),
                           torch.cumsum(delp_p, dim=1)], dim=1)
    peln = torch.log(pe)
    return SimpleNamespace(delp=delp, pt=pt_p[..., ctr, ctr], u=u, v=v,
                           w=w_p[..., ctr, ctr], delz=zh[:, 1:] - zh[:, :-1],
                           zh=zh, ws=ws, mfx=mfx, mfy=mfy, cx=cx, cy=cy,
                           pe=pe, peln=peln, pk=torch.exp(akap * peln),
                           q=dict(q, **qd) if fast_cfg is not None else q)


def dyn_core_hydro(delp, pt, u, v, phis, g, cfg: DynConfig, akap, ptop,
                   n_split, dt_acoustic, ak=None, bk=None):
    """Hydrostatic acoustic loop (dyn_core.F90, hydrostatic=.true.): per
    iteration c_sw -> geopk(C) + p_grad_c (pgradc_fused) -> d_sw
    [-> mix_dp] -> geopk(D) (pkgz) -> one_grad_p (grad1_p_update when beta
    > 0; with the external-mode term when d_ext > 0) [-> ray_fast], as a
    Python loop over n_split. ak, bk [K+1] feed fill_dp's floors and
    rf_fast's profile; without them both are off, as in the JAX package.

    delp, pt (theta_v): [6, K, n, n] interior; u, v D winds; phis:
    unread, as in the JAX package (g.phis_p is read). The loop carries
    PADDED (delp, pt): the one grouped cell exchange after d_sw
    serves that iteration's pkgz and the next iteration's c_sw (the JAX
    package's carried-pad schedule). Returns the updated fields, the
    accumulated mass fluxes and Courant numbers, and geopk's pe, peln, pk,
    gz, pkz of the final state on the padded frame."""
    from ..ops.csw import c_sw
    from ..ops.dsw import d_sw
    halo = g.halo
    npx = g.npx
    n = g.n
    ctr = slice(H, H + n)
    wsl = slice(fi(1), fi(npx) + 1)
    dt = dt_acoustic
    dt2 = 0.5 * dt
    ptk = ptop ** akap
    phis_p = g.phis_p
    pl = _sponge_level_params(cfg)
    dpmin, rfp = _column_options(cfg, ak, bk, dt, ptop)
    dsw_kw = dict(
        dt=dt, hord_mt=cfg.hord_mt, hord_vt=cfg.hord_vt,
        hord_dp=cfg.hord_dp, hord_tm=cfg.hord_tm, dddmp=cfg.dddmp,
        d4_bg=cfg.d4_bg, lim_fac=cfg.lim_fac,
        **{k: pl[k] for k in ("nord", "nord_v", "d2_bg", "d_con",
                              "nord_mask", "damp_v", "damp_v2", "nord_v2")})

    T, K = delp.shape[:2]
    NC, NW = n + 2 * H, n + 1 + 2 * H

    def zeros(*s):
        return delp.new_zeros((T, K) + s)

    mfx, mfy = zeros(n, n + 1), zeros(n + 1, n)
    cx, cy = zeros(NC, NW), zeros(NW, NC)
    delp_p, pt_p = halo.pad_cells((delp, pt))
    dup = dvp = None
    for it in range(n_split):
        u, v = halo.reconcile_dgrid(u, v)
        u_p, v_p = halo.pad_dgrid(u, v)
        cs = c_sw(delp_p, pt_p, None, u_p, v_p, g, dt2, nord=cfg.nord)
        uc, vc = pg_col.pgradc_fused(cs.delpc, cs.ptc, phis_p, cs.uc, cs.vc,
                                     g, dt2, akap, ptop, npx)
        uc_p, vc_p = halo.pad_cgrid(uc[..., ctr, wsl], vc[..., wsl, ctr])
        divg_p = None
        if cfg.nord > 0:
            divg_p = halo.pad_corner(cs.divg_d[..., wsl, wsl])

        ds = d_sw(delp_p, pt_p, None, u_p, v_p, uc_p, vc_p, cs.ua, cs.va,
                  divg_p, g, **dsw_kw)
        divg2 = None
        if cfg.d_ext > 0.0 and divg_p is not None:
            divg2 = external_mode_divg2(delp_p, divg_p, g, cfg.d_ext, npx)
        delp, pt = ds.delp, ds.pt
        if dpmin is not None:
            delp, pt, _ = mix_dp(delp, pt, None, dpmin, hydrostatic=True)
        mfx, mfy = mfx + ds.fx, mfy + ds.fy
        cx, cy = cx + ds.crx, cy + ds.cry
        delp_p, pt_p = halo.pad_cells((delp, pt))
        pk, gz = pg_col.pkgz(delp_p, pt_p, phis_p, akap, ptop)
        if cfg.beta > 0.0:
            if dup is None:
                dup, dvp = torch.zeros_like(u), torch.zeros_like(v)
            # beta = 0 on the first iteration (dyn_core.F90:398-406)
            u, v, dup, dvp = grad1_p_update(
                ds.u, ds.v, pk, gz, g, dt, npx, ptk, dup, dvp,
                0.0 if it == 0 else cfg.beta, divg2=divg2)
        else:
            u, v = one_grad_p(ds.u, ds.v, pk, gz, g, dt, npx, ptk,
                              divg2=divg2)
        if rfp is not None:
            u, v, _ = ray_fast(u, v, None, *rfp)

    u, v = halo.reconcile_dgrid(u, v)
    pe, peln, pk, gz, pkz = pg_col.geopk(delp_p, pt_p, phis_p, akap, ptop)
    return SimpleNamespace(delp=delp_p[..., ctr, ctr], pt=pt_p[..., ctr, ctr],
                           u=u, v=v, mfx=mfx, mfy=mfy, cx=cx, cy=cy, pe=pe,
                           peln=peln, pk=pk, gz=gz, pkz=pkz)
