"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from gfdl_atmos_cubed_sphere_tpu_torch/csrc/
(nvcc, one process per source, all started together, into
build/torch_kernels/), then runs its phases and exits non-zero on the first
failure. Four main paths run on the card: the shallow-water step
(sw_c768), the dry nonhydrostatic big step fv_dynamics_nh at C192L79
(c192_nh made dry: q = {}, no moist physics), the moist c192_nh headline
step (bench.py's six GFDL-MP tracers, MPConfig(): tracer_2d on the rank-5
tp sweep kernel, the tracer remap, neg_adj3 and the GFDL microphysics) and
the moist hydrostatic c192_hydro step fv_dynamics_hydro (bench.py:34-35:
the hydrostatic forms of c_sw and d_sw, the column kernels pgradc_fused,
pkgz and geopk, one_grad_p's batched a2b, the same tracers and physics).
Phase 8 drives the solo driver (driver/solo.py: its Atmosphere and its
CLI), as users start the system, and phase 9 the SHiELD and GFDL facades
over it, through the same kernels; phase 12 the headline step with the
inline fast physics (do_fast_phys).

1. build: the seconds nvcc took for the eight sources;
2. each kernel against its plain PyTorch version on the card, on the inputs
   the main paths hand it (the first call of each wrapper at each call
   shape, captured, with the calls at that shape counted: on the NH path
   a2b runs at nh_p_grad's batched 3(K+1)+K levels and at the Smagorinsky
   operand's K levels, 12 calls each per big step): the
   tp sweep, ke_section and a2b kernels on one sw_c768 float32 step and
   one C48 float64 SW step, and the c_sw, d_sw fluxes, d_sw
   winds, sim1, tp sweep and a2b kernels on one C192L79 float32 big step
   and one C24L10 float64 big step (dt = 900 s, k_split = 1,
   n_split = 2), dry and moist: the moist steps add the rank-5 tp sweep
   (tracer_2d's [6, 6, K, P, P] tracers with shared [6, 1, K, ...] winds),
   timed at C192L79, and every other NH kernel is checked again on the
   moist inputs; the c_sw (hydrostatic form), d_sw fluxes (hydrostatic
   form), d_sw winds, pgradc_fused, pkgz, geopk, tp sweep (rank 5) and a2b
   (one_grad_p's [6, 2(K+1), P, P]) kernels on one C192L79 float32 and one
   C24L10 float64 c192_hydro step, all timed at C192L79, and
   fv_tp_2d_kernel, which no path calls, on that step's d_sw pt-transport
   operands. Tolerance per output: max |diff| <= 1e-4 x max |ref| in
   float32 (the count of points over 1e-6 relative is printed: a limiter
   branch may flip under float32 rounding) and <= 1e-12 in float64, but
   max |diff| 0 for pgradc_fused, pkgz, geopk and ke_section (EXACT),
   which keep the plain version's operation order; the non-finite points
   (NaN in the cube-corner halo) must coincide. The three column kernels
   are also held bit for bit at COLUMN_DEPTHS, c192_hydro's C192 inputs
   with their levels repeated to K = 79 in float64 and K = 32 and 125 in
   both dtypes, one device kernel a call: the launch plans of
   ops/pg_col.py that the main paths do not take, and every count of
   levels a last batch of 4 can hold (K % 4 of 3, 2, 0 and 1 at K = 79,
   10, 32 and 125); ke_section likewise on the SW inputs stacked to
   KE_LEVELS levels. Each
   with its time (CUDA events, median of 20 after warm-up; the kernel
   alone from the profiler, with the device kernels per call and the
   ratio to the bound; for the two d_sw stages each kernel's launches and
   ms per call; a profiler reading that lost a launch's record is taken
   again, and the smoke fails after five incomplete ones), the plain
   version's time and its bound. For a2b_ord4, sim1, tp2d_sweep, c_sw,
   pgradc_fused, pkgz, geopk and ke_section, at every call shape, f32 and
   f64, it prints every device kernel one wrapper call issues, PyTorch's
   ops, copies and fills included ("device_kernels_per_call" in the
   kernels line's shapes), and fails unless each issues exactly 1 in all
   but sim1, which must issue exactly 1 of its own (its copies of
   non-contiguous operands would be listed). It prints the resources of
   the tp sweep, c_sw, d_sw stage, column (at K = 79 and 125) and
   ke_section kernels as built, the tp sweep and d_sw stages in both
   their forms (the usual arguments' and every argument's; registers and
   spill bytes per thread, static and dynamic shared memory per block,
   resident blocks per SM; "resources" in the kernels line). The
   tp sweep and ke_section kernels are also checked at every other hord
   they take (tp_sweep.KERNEL_HORDS, ke.KERNEL_HORDS: -6 to -1 and 1 to
   13) on the SW inputs (phase 11 adds the arguments of the SHiELD path),
   and the sim1 kernel's off-centred form (alpha = 0.75) on the NH path's
   captured calls and their casts, K = 79 and 10 in float32 and float64
   under the same limits, with its kernel alone at alpha 0.75 and 1 in the
   same call;
3. the SW step (case 2, C48, float64, n_split=2, 4 steps) and the NH big
   step (C24L10, float64, dt = 900 s, k_split = 1, n_split = 2, 2 steps)
   on the card with the kernels against the same port on the CPU with the
   plain versions, dry and moist (the six tracers and the GFDL MP), and
   the moist hydrostatic big step likewise, each field against its own
   maximum: <= 1e-10 on the SW delp, u, v, the NH delp, pt, u, v, delz,
   the hydrostatic delp, pt, u, v and the six tracers but for the
   hydrostatic ice_wat, <= 5e-9 on the NH w and <= 1e-8 on the hydrostatic
   ice_wat. Those two are the ill-conditioned fields. w carries the
   nonhydrostatic pressure perturbation, a difference of ~1e5 Pa
   quantities, so last-bit differences between the card's and the CPU's
   exp/log move it by some 1e-10 of its maximum. The moist steps make
   only ~5e-9 kg/kg of ice in two steps, the remainder of the
   microphysics' larger exchanges, and the same last-bit differences move
   it by 3e-11 to 3.1e-9 of that maximum on the hydrostatic step (4e-11 to
   9e-10 on the NH step, where the card reads under 1e-10;
   devtools/nh_w_conditioning.py [--moist] [--hydro] measures how far on
   the CPU). As a control, the same two big steps run on the card in
   float32; every field of the control must read over its limit, so the
   limits sit between a sound reading and a fault of float32 size;
4. the full-width sw_c768 step (npx=769, n_split=1, case 2, float32):
   1 warm-up step, 5 timed steps behind a scalar readback barrier, 2 steps
   under the profiler. It asserts no NaN, a relative change of
   sum(delp * area) (in float64) <= 1e-5, and launch counts of exactly 2
   (tp2d_sweep), 1 (ke_section) and 3 (a2b_ord4) per step. bench.py's
   sw_c768 uses dt=225 s; with n_split=1 that is a Courant number of 4.63
   at C768 and the solver (JAX and port alike) overflows by the third or
   fourth step (devtools/sw_stability.py), so the smoke runs dt = 225/8 s
   with the same work per step;
5. the dry c192_nh big step at full width (C192L79, float32, dt = 450 s,
   k_split = 2, n_split = 6, dddmp = 0.2, d_con = 1, the Jablonowski-
   Williamson baroclinic wave): 1 warm-up step, 5 timed steps behind a
   scalar readback barrier, 1 step under the profiler (s/step,
   pts*lev/s, device busy share, device ms by kernel). It asserts finite
   fields, a relative change of sum(delp * area) (float64) <= 1e-5, and
   launch counts per big step of c_sw 12, d_sw fluxes 12, d_sw winds 12
   (one tile-fused kernel each, their PPM sweeps inside), sim1 24,
   tp2d_sweep 12 (update_dz_d) and a2b_ord4 24 (nh_p_grad and the
   Smagorinsky operand);
6. the moist c192_nh headline step at full width (as phase 5 with
   adiabatic = False, the moist baroclinic wave, sphum from it and the
   five condensates at 1e-6, MPConfig()): 1 warm-up step, 5 timed steps
   behind a scalar readback barrier, 1 step under the profiler (s/step,
   pts*lev/s, device busy share, device ms by kernel and by op, wall ms
   by layer, peak device memory, each tracer_2d call's subcycle count
   nsplt). It asserts finite fields and tracers, the mass change, phase
   5's launch counts and rank-5 tp2d_sweep launches = the sum of nsplt;
7. the moist c192_hydro step at full width (C192L79, float32, dt = 450 s,
   k_split = 1, n_split = 6, DynConfig's defaults otherwise, the moist
   state of phase 6) as phase 6: launch counts per big step of c_sw 6,
   d_sw fluxes 6, d_sw winds 6, pgradc_fused 6, pkgz 6, geopk 1,
   a2b_ord4 6, sim1 0, and rank-5 tp2d_sweep launches = the sum of nsplt;
8. the solo driver (driver/solo.py), without tracers, with Held-Suarez
   forcing: (a) at C24L10 in float64, hydrostatic and nonhydrostatic with
   the Rayleigh sponge (tau = 10 days, its cutoff under the 500 hPa top of
   set_eta(10)), the energy fixer (consv_te = 1) and the angular-momentum
   fixer, 2 big steps and then adiabatic_init (dt < 0 in its backward
   passes) on the card against the CPU with phase 3's limits and a float32
   control; and 8 hydrostatic steps without physics on the card, where the
   relative change of the global total energy with consv_te = 1 must be
   under 1e-6 and under 0.2 x the change without it; (b) at C192L79 in
   float32, hydrostatic with c192_hydro's dt = 450 s, k_split = 1,
   n_split = 6, with the fixers and sponge (tau = 10, consv_te = 1,
   consv_am) and without, then nonhydrostatic with them and c192_nh's
   splits and damping: 1 warm-up step, 5 timed atmosphere() steps behind a
   scalar readback (s/step, pts*lev/s, mass and total-energy change, peak
   memory, launches per step, which must be phase 7's (hydrostatic, no
   tracer sweep) and phase 5's (nonhydrostatic)), 1 step under the
   profiler (busy share), 1 synchronised step by layer (the acoustic
   loop, the remap, the sponge, the energy integrals and fixers,
   hs_forcing), hs_forcing and audit timed on the state, the Timers
   table, and the cost of the fixers and sponge as on minus off;
   finite fields, and a mass change <= 1e-5 with them off; (c) the restart:
   2 steps of the hydrostatic run with both fixers (no sponge: its
   reference winds are the state at each start), write_restart as .fvio
   and .npz (seconds), 1 more step; each file read into a new Atmosphere
   and stepped once equals the continuous run bit for bit in every field;
   (d) the CLI, main() with the README's quick-start options at C48L32 for
   3 steps with an audit every 2 and a restart written, then a second
   main() from that restart. Files go to build/torch_smoke/ and are
   removed;
9. the SHiELD and GFDL facades (driver/shield.py, driver/gfdl.py): (a) at
   C24L10 in float64, nonhydrostatic, resumed from a checkpoint of the
   moist wave with seeded condensates, the sequence atmosphere_dynamics(1),
   atmos_phys_driver_statein, atmosphere_state_update with seeded
   tendencies, atmosphere_nggps_diag (fv_diag), fv_cmip_diag and the GFDL
   physics and radiation input blocks on the card against the CPU: every
   output against its own maximum with phase 3's limits (w and the outputs
   formed from it under the NH w limit), NaN at the same points, the
   threshold fields (hurricane categories and frequencies, 40 dBz height,
   -10 C reflectivity) picking the same points (THRESHOLD_FIELDS), their
   values within 1e-10; (b) at C192L79 in float32 with c192_nh's splits,
   resumed from a checkpoint of phase 6's moist initial state: 1 warm-up
   and 2 timed atmosphere_dynamics steps (s/step, pts*lev/s, launches per
   step, which must be phase 8b's solo_nh's), then atmos_phys_driver_statein,
   atmosphere_state_update (1 K/day heating, small wind and sphum
   tendencies), atmosphere_nggps_diag split into the device work and the
   host copies of send (at least 150 fields registered; finite fields but
   for the pressure-level and isentropic ones, whose NaN must sit where the
   level is outside the column), fv_cmip_diag and
   atmos_physics_driver_inputs, each timed synchronised, write_netcdf of a
   diag_table selection (seconds, bytes) and the peak device memory;
10. the acoustic-loop options and Riemann solvers (BUNDLES, as the JAX
   package's tests run them): (a) one dry C24L10 float64 big step of each
   bundle on the card against the CPU with phase 3's limits and float32
   control (the NH off-centred SIM with beta, fill_dp, rf_fast, use_logp,
   d2bg_zq and kord 10; SIM3; SIM3p0; RIM_2D with m_split = 2 at dt = 60 s;
   the hydrostatic beta, d_ext, fill_dp and rf_fast with kord 10 and with
   kord 11, whose winds are held to BUNDLE_TOL), and remap_restart of that
   state onto set_eta(24)'s higher top, card against CPU at 1e-10; (b) at
   C192L79 float32 the moist c192_nh step with the off-centred bundle and
   the moist c192_hydro step with the hydrostatic one (kord 11), each as
   phases 6 and 7, beside their headlines of this run, with sim1's
   launches by form (12 at alpha 1 and 12 at alpha 0.75 a big step) and
   every other kernel's launches those of phases 6 and 7; riem_solver3
   alone for SIM3, SIM3p0 and RIM_2D (1 + |dt_acoustic| substeps), plain
   PyTorch on the card (ms and device kernels a call); and reset_eta of
   the moist initial state from L79 to L91 in float64 (seconds, the
   column mass kept);
11. the SHiELD namelist's dynamics (SHIELD_FV_CORE_NML through the port's
   utils/config: nord 2, d4_bg 0.12, vtdm4 0.02, hord_mt = hord_vt =
   hord_tm = 5, hord_dp -5, hord_tr 8, k_split 1, n_split 8, kord 9,
   kord_tm -9, tau 5, rf_cutoff 750, d2_bg_k1/k2 0.20/0.15, consv_te 1),
   which runs the d_sw kernels' every-argument forms and the tp sweep's
   usual one: (c) one
   C24L10 float64 big step at SHIELD_C24's cuts, dry and moist, and of
   its SHIELD_NORD3 variant (dry), card against CPU with phase 3's
   limits and float32 control (nord 3 overflows float32 at C24: the
   variant's control is the float64 step from the state rounded to
   float32), the moist step's and the variant's
   captured calls first held to the plain versions as phase 2 does
   (every NH kernel, and on
   the namelist's step the arguments beyond the path's: the tp sweep at
   every hord at rank 4 and 5 and lim_fac 0.5 at hord +-1, the d_sw
   fluxes at DSW_FLUX_CHECKS, the d_sw winds at DSW_WIND_CHECKS, c_sw at
   nord 3); (a) fv_dynamics_nh of the namelist cut to C192 (SHIELD_CUTS:
   npx 193, dt 450 s; npz 91 as written) on the moist baroclinic state at
   set_eta(91) with phase 6's tracers and MPConfig(), float32: one
   captured step held to the plain versions as in (c) at 1e-4 (every NH
   kernel timed at the namelist's arguments, the d_sw kernels also at
   ARG_COSTS: the kernel form, the hords and nord 2 apart), then 1
   warm-up, 5 timed
   steps and the profiled ones as phase 6 (s/step, pts*lev/s, busy share,
   peak memory, launches per big step c_sw, d_sw fluxes, d_sw winds and
   the rank-4 tp sweep 8, sim1 and a2b 16, the rank-5 sweep one per
   tracer_2d subcycle, the layer split); (b) the SHiELD facade,
   ShieldAtmosphere(193, 91, 450, hydrostatic=False) with the same
   DynConfig fields: 1 warm-up and 2 timed
   atmosphere_dynamics steps (s/step, pts*lev/s, launches per step as
   (a)'s without the tracer sweep, peak memory), resumed from a
   checkpoint of (a)'s initial state. (a) and (b) run after phase 7 in a
   process of their own (this script with PHASE_11_ARG) on the kernels
   this one built;
12. the inline fast physics and the rest of the GFDL MP (plain PyTorch, no
   kernel of their own): (c) at C24L10 in float64, card against CPU with
   phase 3's limits (FAST_TOL: 5e-9 on the precipitating tracers) and a
   float32 control, (i) one moist NH big step with do_fast_phys and
   MPConfig() (the mp_fast chain in each acoustic iteration) from
   fast_phys_c24_ic's state (sphum scaled by seeded 0.95-1.1, seeded
   condensates away from TICE and t_wfr), (ii) the same with the SHiELD
   namelist's gfdl_mp_nml (SHIELD_GFDL_MP_NML through utils/config:
   sat_adjust as the fast physics, WBF, tau_l2r 600, sedi_uv), (iii)
   gfdl_mp_driver alone on (ii)'s state with MP_OPTIONS (subgrid_z_proc
   with rh_adj 0.9, explicit_fall, prog_ccn with a seeded liq_aero, the
   consv_checker audits, sedi_uv with seeded ua, va, and hs), (iv)
   fv_sg_adjust at fv_sg_adj = 600 s and fv_sg_adjust_am5, (v) fill_gfs
   and fill2d on seeded tracers with negatives, each output against its
   own maximum (1e-10; the audits' relative errors against 1); (a) after
   phase 6, the moist c192_nh step with do_fast_phys and MPConfig() at
   C192L79 float32 as phase 6 (s/step, pts*lev/s, busy share, peak
   memory, the layer split with fast_sat_adj on its own line; launches
   per big step equal to phase 6's), and the hook's cost as its s/step
   less phase 6's of the same run; (b) in phase 11's process on 11a's
   initial state at C192L91 float32: gfdl_mp_driver with the SHiELD
   gfdl_mp_nml, with MPConfig() and with MP_OPTIONS, and fv_sg_adjust,
   ms a call and device kernels a call;
13. the NWP initialisation and forcing (io/external_ic.py,
   io/da_increment.py, physics/nudging.py, io/climate_nudge_data.py,
   physics/forcing_externals.py, utils/terrain.py; plain PyTorch, no
   kernel of their own): (a) at the end, a chgres cold-start file set at
   C192 (write_nwp_files: gfs_ctrl.nc with the 127-layer GFS coordinate,
   gfs_data.tile{1..6}.nc in float32 from phase 6's moist JW state at
   set_eta(127) with zh integrated hydrostatically, oro_data.tile{1..6}.nc
   whose orog_filt is surfdrv's terrain of a 0.25 degree DEM, the JW
   surface height plus a 2 km hill, filtered by fv3_zs_filter), then
   get_nggps_ic_files onto set_eta(79) on the card in float64 (the host
   seconds to write and to read the files, the cold start's seconds); (b)
   the moist c192_nh big step of phase 6 from (a)'s state in float32 with
   da_increment.IAU applying a 0.5 degree lat-lon increment (T, delp,
   sphum, o3mr, winds, through read_da_inc) after each step over 6 h;
   (c) the same with the nudging after each step: nwp_nudge toward
   ObsSchedule's two analyses 6 h apart on the model levels
   (remap_analysis_to_model), ps_nudging with the bias correction,
   breed_slp_inline with two storms. (b) and (c): 1 warm-up and 5 timed
   big steps (s/step, pts*lev/s, busy share, peak memory, the wall ms of
   the IAU and of each nudging call), finite fields, sum(delp*area)
   within 1e-5 across each fv_dynamics_nh call, launches per big step
   equal to phase 6's. (d) after 12c, card against CPU at C24L10 in
   float64 with phase 3's limits and a float32 control: the cold start
   from a C24 file set built as (a)'s, one IAU step and one nudged step,
   ClimateNudgeDriver.tendencies, do_w_forcing of both types, age_of_air,
   AeroClimatology.to_model, ExternalSST.to_cube, fv3_zs_filter with the
   zero-ocean limiter, breed_slp_inline and the global mass after it.
   `python3 devtools/nwp_phase.py` runs phase 13 alone.

Before the last line it prints the card's name and power limit and one JSON
line with each kernel's launches (those of its path's timed phase: 6 for
the NH kernels, 7 for the column kernels and fv_tp_2d, which no path
calls), error and times, and the kernel's numbers on the other paths it
runs on; for a kernel its path calls at several shapes, ms, plain_ms,
bound_ms and kernel_ms are means per launch weighted by the calls at each
shape, and "shapes" lists each shape's own numbers ("depths": the column
kernels' checks at COLUMN_DEPTHS); "solo_hydro" and
"solo_nh" give its launches per big step on phase 8b's two forms (with the
fixers on), "shield" per atmosphere_dynamics step of phase 9b,
"c192_nh_offc" and "c192_hydro_opts" in phase 10b's 5 big steps (sim1's
split by form, and its "offcentred" records of phase 2),
"shield_c192l91" in phase 11a's 5 big steps with its numbers at the
namelist's arguments, "shield_facade" per phase 11b step,
"c192_nh_fastphys" in phase 12a's 5 big steps, "nwp_iau" and
"nwp_nudged" in phase 13b's and 13c's 5 big steps, and
"checked_at" the hords, nords and lim_fac each of the tp sweep,
ke_section, d_sw and c_sw kernels was held to its plain version at. The
last line is
{"ok": true, "device": {...}}. It needs one CUDA card; without one it exits
with code 2 and prints no result.
"""

import json
import statistics
import subprocess
import sys
import time

H = 3
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"float32": 67e12}    # H100 SXM, outside the tensor cores
# floating-point operations per output point, estimated from each kernel's
# source (the PPM limiter work dominates); far below the byte bound
OPS_PER_POINT = {"tp2d_sweep": 200, "ke_section": 150, "a2b_ord4": 80,
                 "c_sw": 250, "d_sw_fluxes": 900, "d_sw_winds": 600,
                 "sim1": 80, "pgradc_fused": 60, "pkgz": 30, "geopk": 40,
                 "fv_tp_2d": 260}
REPLACES = {
    "tp2d_sweep": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_tp.py:177",
    "ke_section": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_sw.py:34",
    "a2b_ord4": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_a2b.py:45",
    "c_sw": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_csw.py:58",
    "d_sw_fluxes": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_dsw.py:155",
    "d_sw_winds": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_dsw.py:155",
    "sim1": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_nh.py:158",
    "pgradc_fused": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_col.py:234",
    "pkgz": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_col.py:301",
    "geopk": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_col.py:80",
    "fv_tp_2d": "gfdl_atmos_cubed_sphere_tpu/ops/pallas_tp.py:80",
}
#: the CUDA source of each kernel where it is not csrc/<name>.cu
SOURCE = {"pgradc_fused": "col_pressure", "pkgz": "col_pressure",
          "geopk": "col_pressure", "fv_tp_2d": "tp2d_sweep"}
SW_KERNELS = ("tp2d_sweep", "ke_section", "a2b_ord4")
NH_KERNELS = ("c_sw", "d_sw_fluxes", "d_sw_winds", "sim1", "tp2d_sweep",
              "a2b_ord4")
HYDRO_KERNELS = ("c_sw", "d_sw_fluxes", "d_sw_winds", "pgradc_fused", "pkgz",
                 "geopk", "tp2d_sweep", "a2b_ord4")
SW_PER_STEP = {"tp2d_sweep": 2, "ke_section": 1, "a2b_ord4": 3}
# launches per big step at rank 4 (tracer_2d's rank-5 sweeps come on top:
# one per subcycle); fv_tp_2d_kernel is on no path
NH_PER_STEP = {"c_sw": 12, "d_sw_fluxes": 12, "d_sw_winds": 12, "sim1": 24,
               "tp2d_sweep": 12, "a2b_ord4": 24, "ke_section": 0,
               "pgradc_fused": 0, "pkgz": 0, "geopk": 0, "fv_tp_2d": 0}
HYDRO_PER_STEP = {"c_sw": 6, "d_sw_fluxes": 6, "d_sw_winds": 6, "sim1": 0,
                  "tp2d_sweep": 0, "a2b_ord4": 6, "ke_section": 0,
                  "pgradc_fused": 6, "pkgz": 6, "geopk": 1, "fv_tp_2d": 0}
# the grid planes a2b_ord4 and its plain version read
A2B_METRICS = ("dxa", "dya", "edge_s_full", "edge_n_full", "edge_w_full",
               "edge_e_full", "a2b_corner_w")
# the kernels whose every device kernel per wrapper call phase 2 counts
ALL_KERNELS_COUNTED = ("a2b_ord4", "sim1", "tp2d_sweep", "c_sw",
                       "pgradc_fused", "pkgz", "geopk", "ke_section")
# the kernels phase 2 holds to their plain versions bit for bit
EXACT = ("pgradc_fused", "pkgz", "geopk", "ke_section")
# the column kernels phase 2 checks at COLUMN_DEPTHS
COLUMN_KERNELS = ("pgradc_fused", "pkgz", "geopk")
# the levels phase 2 checks ke_section at beside the SW path's one
KE_LEVELS = 3
# the column depths phase 2 checks the column kernels at beside the main
# paths' (c192_hydro's 79 in float32, C24L10's 10 in float64): 79 in
# float64 (pgradc_fused 4 rows, geopk and pkgz 64 threads), the README's
# C48L32 CLI depth (the plans of K = 79 but 128 threads in float64) and
# 125 (pgradc_fused 4 / 2 rows, geopk and pkgz 64 / 32 threads in float32 /
# float64; the plans of 127), with 79 and 10 every remainder of the
# batches of 4 levels
COLUMN_DEPTHS = ((79, ("float64",)), (32, ("float32", "float64")),
                 (125, ("float32", "float64")))


def col_plan_args(kernel, K):
    """The leading arguments of a column kernel's *_attrs export at depth
    K: (K, its plan's window rows or threads a block) for an element
    size."""
    def lead(itemsize):
        from gfdl_atmos_cubed_sphere_tpu_torch.ops import pg_col
        plan = pg_col.launch_plan(kernel, K, 198, 198, itemsize)
        return (K, plan.rows if kernel == "pgradc_fused" else plan.threads)
    return lead


# the kernels whose resources phase 2 reads from the built library (every
# kernel redesigned for the card but a2b and sim1): {name: [(label,
# exported function, leading arguments, or a function of the element size
# that gives them)]}
RESOURCES = {
    "tp2d_sweep": [("", "tp2d_sweep_attrs", (0,)),
                   ("every hord", "tp2d_sweep_attrs", (1,))],
    "c_sw": [("", "c_sw_attrs", ())],
    "d_sw_fluxes": [("", "d_sw_fluxes_attrs", (0,)),
                    ("every argument", "d_sw_fluxes_attrs", (1,))],
    "d_sw_winds": [("", "d_sw_winds_attrs", (0,)),
                   ("every argument", "d_sw_winds_attrs", (1,))],
    "pgradc_fused": [(f"K{K}", "pgradc_fused_attrs",
                      col_plan_args("pgradc_fused", K)) for K in (79, 125)],
    "pkgz": [(f"K{K}", "pkgz_attrs", col_plan_args("pkgz", K))
             for K in (79, 125)],
    "geopk": [(f"K{K}", "geopk_attrs", col_plan_args("geopk", K))
              for K in (79, 125)],
    "ke_section": [("", "ke_section_attrs", ())],
}
# position of the hord argument in the calls of the wrappers that take one
HORD_ARG = {"tp2d_sweep": 3, "ke_section": 13}
C768_DT = 225.0 / 8        # see phase 4 in the module docstring
# card vs CPU, x each field's own maximum: 1e-10, and the own limits of the
# ill-conditioned fields, the NH w and the hydrostatic ice_wat (see phase 3
# in the module docstring)
CARD_TOL = {"NH": {"w": 5e-9}, "hydro": {"ice_wat": 1e-8}}
NH_CFG = dict(hydrostatic=False, adiabatic=True, dddmp=0.2, d_con=1.0,
              do_vort_damp=True)
# bench.py:34-35: c192_hydro takes DynConfig's defaults otherwise
HYDRO_CFG = dict(hydrostatic=True, adiabatic=True)
TRACERS = ("sphum", "liq_wat", "rainwat", "ice_wat", "snowwat", "graupel")
# phase 8, the solo driver: the fixers and the sponge; the splits of
# c192_hydro (bench.py:34-35) and c192_nh (bench.py:31-33); at C24L10 the
# sponge's cutoff sits under ptop = 500 hPa of set_eta(10) so that it acts
SOLO_FIX = dict(tau=10.0, consv_te=1.0, consv_am=True)
SOLO_HYDRO = dict(k_split=1, n_split=6)
SOLO_NH = dict(k_split=2, n_split=6, dddmp=0.2, d_con=1.0, do_vort_damp=True)
SOLO_C24 = dict(k_split=1, n_split=2, rf_cutoff=8.0e4)
SOLO_DIR = "build/torch_smoke"
# phase 10, the acoustic-loop options and Riemann solvers, as the JAX
# package's tests run them (tests/test_thermo_diag2.py:76,
# tests/test_nh_core.py:170-273, tests/test_hydro_core.py:124-125,
# tests/test_mix_ray.py:107-128): the inline Rayleigh damping under a cutoff
# below the 500 hPa top of set_eta(10); the NH off-centred bundle (c192_nh
# at full width) and the hydrostatic one (c192_hydro) with kord 10 and 11
RF_FAST = dict(rf_fast=True, tau=5.0, rf_cutoff=600.e2)
NH_OFFC = dict(a_imp=0.75, beta=0.45, fill_dp=True, use_logp=True,
               d2bg_zq=0.01, kord_mt=10, kord_tr=10, kord_wz=10,
               kord_tm=-10, **RF_FAST)
HYDRO_OPTS = dict(beta=0.45, d_ext=0.02, fill_dp=True, kord_mt=11,
                  kord_tr=11, kord_tm=-11, **RF_FAST)
HYDRO_OPTS_K10 = dict(HYDRO_OPTS, kord_mt=10, kord_tr=10, kord_tm=-10)
#: phase 10a's bundles, dry: name -> (hydrostatic, dt, settings). RIM_2D
#: runs at dt = 60 s (a 30 s acoustic step, as JAX's
#: tests/test_nh_core.py:273 runs it): at phase 3's 900 s its explicit
#: substeps blow up in both packages unless m_split nears the default
#: 1 + |dt_acoustic|
BUNDLES = {
    "off-centred": (False, 900.0, NH_OFFC),
    "SIM3": (False, 900.0, dict(a_imp=-0.75, d2bg_zq=0.01)),
    "SIM3p0": (False, 900.0, dict(a_imp=-1.0, d2bg_zq=0.01)),
    "RIM_2D": (False, 60.0, dict(a_imp=0.4, m_split=2)),
    "options kord 10": (True, 900.0, HYDRO_OPTS_K10),
    "options kord 11": (True, 900.0, HYDRO_OPTS),
}
#: card vs CPU limits of the bundles beside phase 3's: kord 11's extremum
#: test |2 a1 - (al + ar)| > |al - ar| ties exactly where the limits clamp
#: an interface to the layer's mean, so 1-ulp changes of exp and log move
#: the remapped winds by up to 1.3e-7 of their maxima (`python
#: devtools/nh_w_conditioning.py --bundle "options kord 11"`); the float32
#: control reads them at ~7e-6
BUNDLE_TOL = {"options kord 11": {"u": 1e-6, "v": 1e-6}}
#: the solvers phase 10b times alone on the moist c192_nh state: a_imp of
#: riem_solver3 (RIM_2D at its default m_split, 1 + |dt_acoustic| substeps)
SOLVER_A_IMP = {"SIM3": -0.75, "SIM3p0": -1.0, "RIM_2D": 0.4}
# phase 9, the SHiELD and GFDL facades: C24L10 f64 card vs CPU with the
# splits of phase 3's NH check, c192_nh's at full width (SOLO_NH)
FACADE_C24 = dict(k_split=1, n_split=2)
# the facade outputs that are NH w or formed from it (products, heights
# and pressure levels of w; the plev omega estimate -delp/dz w)
W_FIELDS = ("w", "w1km", "w2500m", "w5km", "wmaxup", "wmaxdn", "uh03",
            "uh25", "uw", "vw", "ww", "wt", "wq", "uw_vi", "vw_vi", "ww_vi",
            "wt_vi", "wq_vi", "w_plev", "omg_plev")
# the fields of the facade sequence that a threshold on other fields picks
# (a storm category and its frequency, the height of 40 dBz, the
# reflectivity of the first level warmer than -10 C), with the value each
# holds where nothing is picked: card vs CPU, the picked points must be
# the same (the frequencies equal, the unpicked points at the same places)
# and the picked values within 1e-10 of the maximum, which a level picked
# otherwise would pass by orders of magnitude
THRESHOLD_FIELDS = {"cat15": 0.0, "cat25": 0.0, "cat35": 0.0, "cat45": 0.0,
                    "f15": 0.0, "f25": 0.0, "f35": 0.0, "f45": 0.0,
                    "40dBz_height": -1.0, "m10C_reflectivity": 0.0}
# a history file as users select one: the 2-D set of the nggps-style
# 6-hourly file and the model-level winds, temperature, humidity and delp
# (the whole C192L79 sweep, ~3.8 GB of records, exceeds the 2 GiB that
# NetCDF3 classic offsets address)
SHIELD_TABLE = """C192L79 shield_nh history
2020 1 1 0 0 0
"atmos_4xdaily", 6, "hours", 1, "days", "time"
"atmos_3d", 6, "hours", 1, "days", "time"
""" + "".join(
    f'"dynamics", "{f}", "{f}", "atmos_4xdaily", "all", .false., "none", 2\n'
    for f in ("ps", "slp", "tm", "cape", "cin", "BRN", "intqv", "intql",
              "intqi", "intqr", "intqs", "intqg", "lw", "iw", "tq", "ctt",
              "ctp", "ctz", "max_reflectivity", "base_reflectivity",
              "echo_top", "u850", "v850", "t850", "z500", "rh850", "q850",
              "w500", "vort850", "u200", "v200", "s200", "us", "vs",
              "u100m", "v100m", "shear06", "srh01", "srh03", "srh25", "ustm",
              "vstm", "uh25", "uh03", "wmaxup", "wmaxdn", "pv350K", "tb",
              "pmask", "zsurf", "cat15", "f15")) + "".join(
    f'"dynamics", "{f}", "{f}", "atmos_3d", "all", .false., "none", 2\n'
    for f in ("ucomp", "vcomp", "temp", "sphum", "delp", "w"))

# phase 11, the SHiELD namelist's dynamics: the fv_core_nml group of a
# public SHiELD C768L91 namelist (the one tests/test_torch_config.py holds
# as SHIELD_NML), read through the port's utils/config; phase 11's moist
# steps run phase 6's MPConfig(), phase 12 the namelist's gfdl_mp_nml
# (SHIELD_GFDL_MP_NML)
SHIELD_FV_CORE_NML = """
&fv_core_nml
       layout   = 8,8
       io_layout = 1,1
       npx      = 769
       npy      = 769
       ntiles   = 6
       npz      = 91
       npz_type = ''
       grid_type = 0
       make_nh = .F.
       fv_debug = .F.
       range_warn = .T.
       reset_eta = .F.
       n_sponge = 9
       nudge_qv = .T.
       tau = 5.
       rf_cutoff = 7.5e2
       d2_bg_k1 = 0.20
       d2_bg_k2 = 0.15
       kord_tm = -9
       kord_mt = 9
       kord_wz = 9
       kord_tr = 9
       hydrostatic = .F.
       phys_hydrostatic = .F.
       use_hydro_pressure = .F.
       beta = 0.
       a_imp = 1.
       p_fac = 0.1
       k_split = 1
       n_split = 8
       nwat = 6
       na_init = 1
       d_ext = 0.0
       dnats = 1
       fv_sg_adj = 600
       d2_bg = 0.
       nord = 2
       dddmp = 0.2
       d4_bg = 0.12
       vtdm4 = 0.02
       delt_max = 0.002
       ke_bg = 0.
       do_vort_damp = .T.
       external_ic = .T.
       external_eta = .T.
       gfs_phil = .F.
       nggps_ic = .T.
       mountain = .F.
       ncep_ic = .F.
       d_con = 1.
       hord_mt = 5
       hord_vt = 5
       hord_tm = 5
       hord_dp = -5
       hord_tr = 8
       adjust_dry_mass = .F.
       consv_te = 1.
       consv_am = .F.
       fill = .T.
       dwind_2d = .F.
       print_freq = 6
       warm_start = .F.
       no_dycore = .F.
       z_tracer = .T.
       agrid_vel_rst = .T.
       read_increment = .F.
       res_latlon_dynamics = "fv3_increment.nc"
/
"""
#: phase 12, the inline fast physics and the rest of the GFDL MP: the
#: gfdl_mp_nml group of the same public SHiELD namelist (as
#: tests/test_torch_config.py holds it in SHIELD_NML), read through the
#: port's utils/config: the condensed sat_adjust as the fast physics
#: (use_mp_fast off), WBF, tau_l2r 600 and sedi_uv
SHIELD_GFDL_MP_NML = """
&gfdl_mp_nml
       do_sedi_uv = .T.
       use_mp_fast = .F.
       do_wbf = .T.
       tau_l2r = 600.
       fast_fr_mlt = .F.
       rh_inc = 0.30
/
"""
#: the big step's inline fast physics (phase 12)
FAST_PHYS = dict(do_fast_phys=True)
#: phase 12c seeds condensates only where the temperature is this many K
#: from TICE and t_wfr: the GFDL MP's heat-limited melt and freeze put T
#: on those thresholds, and the next comparison with them (psaut, psaci,
#: pgaci at TICE; praut_simp at t_wfr) is then decided by the last bit,
#: a jump of a share of the ice (ROADMAP "Not faults": 1-ulp exp/log
#: changes moved ice_wat 2.8e-5 and w 2.4e-6 of their maxima in two
#: steps with condensates seeded everywhere, `python
#: devtools/nh_w_conditioning.py --fastphys`)
FAST_SEED_GAP = 3.0
#: phase 12c's limits, card vs CPU, x each field's own maximum: phase 3's
#: NH limits, and 5e-9 on the precipitating tracers, which 1-ulp changes
#: of exp and log move by up to 4.8e-10 (rainwat), 3.2e-10 (snowwat) and
#: 8.9e-11 (graupel) of their maxima in one step from fast_phys_c24_ic's
#: state, every other field under 1.5e-11 (`python
#: devtools/nh_w_conditioning.py --fastphys`, CPU): a flip of a q > QCMIN
#: test moves a species by ~QCMIN
FAST_TOL = dict(CARD_TOL["NH"], rainwat=5e-9, snowwat=5e-9, graupel=5e-9)
#: gfdl_mp_driver's options beyond the defaults (phase 12c iii, 12b): the
#: per-process saturation stage with instant evaporation under 90 % RH,
#: explicit sedimentation, prognostic CCN, the energy and water audits and
#: sedimentation of the A-grid winds
MP_OPTIONS = dict(use_subgrid_proc=True, rh_adj=0.9, sedflag=2,
                  prog_ccn=True, consv_checker=True, do_sedi_uv=True)
#: the relaxation time of the 2-dz convective adjustment (the namelist's
#: fv_sg_adj, and tau of the AM5 form)
FV_SG_ADJ = 600
#: the audits' relative errors, (end - begin) / begin of column sums, held
#: against the scale of their terms (1) rather than their own maximum
AUDIT_ERRORS = ("te_err", "tw_err")

#: the cuts of the namelist at full width: C192 (npx 193, against 769:
#: C768L91 would need ~490 GiB, scaling phase 6's C192L79 peak) and
#: bench.py's C192 step (dt 450 s, against the namelist's C768 150 s)
SHIELD_CUTS = dict(npx=193, dt=450.0)
#: phase 11c, card vs CPU at C24L10: the namelist (cut to npx 25, npz 10,
#: phase 3's dt 900 s) and a variant at the far end of the kernels'
#: arguments
SHIELD_C24 = dict(npx=25, npz=10, dt=900.0)
SHIELD_NORD3 = dict(nord=3, hord_mt=6, hord_vt=6, hord_tm=7, hord_dp=-6,
                    hord_tr=13)
#: phase 2 on the SHiELD path's captured calls: the kernel arguments
#: beyond the path's own. The tp sweep at every hord it takes (and lim_fac
#: at hord +-1, the only place xppm reads it); the d_sw fluxes at nord_v
#: (nord_w alike) 0-2 with hord_dp = hord_tm = hord_vt of -5, 5, 7, 13,
#: the second combos (nord_v2 = nord_w2 of 1 and 2, on at every level)
#: and the linear family's hords 3, 4, -1, 1 at lim_fac 0.5; the d_sw
#: winds at nord 0-3, nord_v 0-2 and hord_mt = hord_vt of 5 and 7,
#: nord_v2 1 and 2 (on at every level) and hord_mt = hord_vt of 3, 4, -1,
#: 1 at lim_fac 0.5; c_sw at nord 3 (and the path's 2)
ARG_LIM_FAC = 0.5
DSW_FLUX_CHECKS = (
    tuple(dict(nord_v=nv, nord_w=nv, hord_dp=h, hord_tm=h, hord_vt=h)
          for nv in (0, 1, 2) for h in (-5, 5, 7, 13))
    + tuple(dict(nord_v2=n2, nord_w2=n2, damp_v2=0.03, damp_w2=0.04)
            for n2 in (1, 2))
    + tuple(dict(hord_dp=h, hord_tm=h, hord_vt=h, lim_fac=ARG_LIM_FAC)
            for h in (3, 4, -1, 1)))
DSW_WIND_CHECKS = (
    tuple(dict(nord=nd, nord_v=nv, hord_mt=h, hord_vt=h)
          for nd in (0, 1, 2, 3) for nv in (0, 1, 2) for h in (5, 7))
    + tuple(dict(nord_v2=n2, damp_v2=0.03) for n2 in (1, 2))
    + tuple(dict(hord_mt=h, hord_vt=h, lim_fac=ARG_LIM_FAC)
            for h in (3, 4, -1, 1)))
#: phase 11a's split of the d_sw kernels' time at the namelist's arguments,
#: on its captured calls: {label: (fluxes overrides, winds overrides,
#: whether to launch the every-argument form)}: both forms at hord 10,
#: nord 1, where both compute the same values, then the namelist's hords
#: at nord 1 and its own arguments, each in the form they need
HORD10_NORD1 = (dict(hord_dp=10, hord_tm=10, hord_vt=10, nord_v=1, nord_w=1),
                dict(hord_mt=10, hord_vt=10, nord=1, nord_v=1))
ARG_COSTS = {
    "usual form, hord 10, nord 1": HORD10_NORD1 + (False,),
    "every-argument form, hord 10, nord 1": HORD10_NORD1 + (True,),
    "the namelist's hords, nord 1": (dict(nord_v=1, nord_w=1),
                                     dict(nord=1, nord_v=1), False),
    "the namelist's arguments": ({}, {}, False),
}


def log(msg):
    print(msg, flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"FAILED: {msg}")


def kernel_modules():
    """name: (module, wrapper attribute, plain version, launch count)."""
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import (a2b, csw, dsw, ke,
                                                       pg_col, sim1, tp_sweep)
    return {
        "tp2d_sweep": (tp_sweep, "tp2d_sweep", tp_sweep.tp2d_sweep_ref,
                       lambda: tp_sweep.launches),
        "ke_section": (ke, "ke_section", ke.ke_section_ref,
                       lambda: ke.launches),
        "a2b_ord4": (a2b, "a2b_ord4", a2b.a2b_ord4_ref,
                     lambda: a2b.launches),
        "c_sw": (csw, "c_sw", csw.c_sw_ref, lambda: csw.launches),
        "d_sw_fluxes": (dsw, "d_sw_fluxes", dsw.d_sw_fluxes_ref,
                        lambda: dsw.launches["fluxes"]),
        "d_sw_winds": (dsw, "d_sw_winds", dsw.d_sw_winds_ref,
                       lambda: dsw.launches["winds"]),
        "sim1": (sim1, "sim1", sim1.sim1_solver, lambda: sim1.launches),
        "pgradc_fused": (pg_col, "pgradc_fused", pg_col.pgradc_fused_ref,
                         lambda: pg_col.launches["pgradc_fused"]),
        "pkgz": (pg_col, "pkgz", pg_col.pkgz_ref,
                 lambda: pg_col.launches["pkgz"]),
        "geopk": (pg_col, "geopk", pg_col.geopk_ref,
                  lambda: pg_col.launches["geopk"]),
        "fv_tp_2d": (tp_sweep, "fv_tp_2d_kernel", tp_sweep.fv_tp_2d_ref,
                     lambda: tp_sweep.launches_fv_tp_2d),
    }


def call_shape(args):
    """The shape of a wrapper call: that of its first tensor argument (the
    field the kernel works on; its level count tells nh_p_grad's batched
    a2b call from the Smagorinsky operand's)."""
    import torch
    return next(tuple(x.shape) for x in args if torch.is_tensor(x))


class Capture:
    """Records (cloned) the arguments of the first call of each kernel
    wrapper at each distinct call shape while a main path runs, and the
    number of calls at that shape, so the kernels can be held against their
    plain versions on exactly those inputs.
    args[name][shape] = (args, kwargs); calls[name][shape] = count."""

    def __init__(self):
        self.args = {}
        self.calls = {}
        self._saved = []

    def __enter__(self):
        import torch

        def clone(x):
            if torch.is_tensor(x):
                return x.clone()
            if isinstance(x, dict):
                return {k: clone(v) for k, v in x.items()}
            return x

        for name, (mod, attr, _, _) in kernel_modules().items():
            orig = getattr(mod, attr)

            def rec(*a, _orig=orig, _name=name, **kw):
                shp = call_shape(a)
                seen = self.args.setdefault(_name, {})
                if shp not in seen:
                    seen[shp] = ([clone(x) for x in a],
                                 {k: clone(x) for k, x in kw.items()})
                calls = self.calls.setdefault(_name, {})
                calls[shp] = calls.get(shp, 0) + 1
                return _orig(*a, **kw)

            self._saved.append((mod, attr, orig))
            setattr(mod, attr, rec)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self._saved:
            setattr(mod, attr, orig)
        return False


def reset_counts():
    for mod, _, _, _ in kernel_modules().values():
        mod.reset_launches()


def counts():
    return {name: cnt() for name, (_, _, _, cnt) in kernel_modules().items()}


def time_ms(fn, reps=20, warm=3):
    """Median milliseconds of fn() on the card (CUDA events per call)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms_by_kernel(fn, reps=5):
    """Device milliseconds per call of fn(), by CUDA kernel name, from
    torch.profiler; plus the device busy share of the window. Returns
    ({}, None) when the profiler records no device time here."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    by = {}
    for e in prof.key_averages():
        us = e.self_device_time_total     # self time: no double counting
        if us > 0:
            by[e.key] = us / reps / 1e3
    busy = sum(by.values()) * reps * 1e3 / wall_us if by else None
    return by, busy


def device_ms_by_op(fn):
    """Device milliseconds of one call of fn() by PyTorch op (aten::...),
    each op charged with the kernels it launched itself."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3
            for e in prof.key_averages()
            if e.key.startswith("aten::") and e.self_device_time_total > 0}


def timed_layers(run, targets, apart=()):
    """Wall milliseconds of one run() by layer: each call of a function of
    targets ([(module, attribute)]) synchronised before and after and
    summed under its name, and the rest. A call made inside another timed
    call counts to the outer one, except for the names in apart, which are
    listed on their own as well and not subtracted again from the rest."""
    import torch
    acc = {a: 0.0 for _, a in targets}
    origs = [getattr(m, a) for m, a in targets]
    depth = [0]

    def timed(name, fn):
        def call(*a, **kw):
            if depth[0] and name not in apart:
                return fn(*a, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            depth[0] += name not in apart
            try:
                out = fn(*a, **kw)
                torch.cuda.synchronize()
            finally:
                depth[0] -= name not in apart
            acc[name] += (time.perf_counter() - t0) * 1e3
            return out
        return call

    for (m, a), o in zip(targets, origs):
        setattr(m, a, timed(a, o))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        for (m, a), o in zip(targets, origs):
            setattr(m, a, o)
    acc["rest"] = total - sum(v for k, v in acc.items() if k not in apart)
    acc["total"] = total
    return acc


def layer_ms(nh, state):
    """Wall milliseconds of one big step by layer: the acoustic loops
    (dyn_core_nh or dyn_core_hydro), the vertical remaps (remap_nh or
    remap_hydro) and the rest, and on the moist path the tracer transport
    (tracer_2d), neg_adj3 and the GFDL microphysics (gfdl_mp_driver), each
    call synchronised before and after. mapn_tracer, the tracers' share of
    the remap, is listed too and is not subtracted again from the rest, as
    is the inline fast physics (fast_sat_adj) inside the acoustic loop
    when the step runs it (do_fast_phys)."""
    from gfdl_atmos_cubed_sphere_tpu_torch.model import (dyn_core,
                                                         fv_dynamics,
                                                         tracer_2d)
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import fv_mapz, fv_sg
    from gfdl_atmos_cubed_sphere_tpu_torch.physics import gfdl_mp
    form = "hydro" if nh.hydro else "nh"
    saved = [(dyn_core, f"dyn_core_{form}"), (fv_dynamics, f"remap_{form}")]
    if nh.moist:
        saved += [(tracer_2d, "tracer_2d"), (fv_sg, "neg_adj3"),
                  (gfdl_mp, "gfdl_mp_driver"), (fv_mapz, "mapn_tracer")]
        if nh.cfg.do_fast_phys:
            saved.append((gfdl_mp, "fast_sat_adj"))
    return timed_layers(lambda: nh.step(state), saved,
                        apart=("mapn_tracer", "fast_sat_adj"))


def solo_layer_ms(atm):
    """Wall milliseconds of one solo atmosphere() step by layer: the
    acoustic loop, the remap, the sponge, the energy integrals and the
    fixers (am_fixer with its own compute_aam), Held-Suarez, and the rest
    (the driver, the entry pressures, the halo of the winds)."""
    from gfdl_atmos_cubed_sphere_tpu_torch.model import (dyn_core,
                                                         fv_dynamics)
    from gfdl_atmos_cubed_sphere_tpu_torch.model import thermodynamics as th
    from gfdl_atmos_cubed_sphere_tpu_torch.physics import held_suarez
    form = "hydro" if atm.cfg.hydrostatic else "nh"
    return timed_layers(lambda: atm.atmosphere(1), [
        (dyn_core, f"dyn_core_{form}"), (fv_dynamics, f"remap_{form}"),
        (fv_dynamics, "rayleigh_super"), (th, f"total_energy_2d_{form}"),
        (th, "compute_aam"), (th, "am_fixer"), (th, "energy_fixer_dtmp"),
        (held_suarez, "hs_forcing")])


def is_own_kernel(key):
    """A device kernel of the port's own (not PyTorch's at::, not a copy or
    a fill)."""
    return "at::" not in key and "Memcpy" not in key and "Memset" not in key


def own_kernels_ms(by):
    """Device ms of the port's own kernels in a profile of one wrapper call:
    every kernel but PyTorch's (at::) and the copies and fills."""
    hits = [v for k, v in by.items() if is_own_kernel(k)]
    return sum(hits) if hits else None


def own_kernel_launches(fn, reps=5, own=True):
    """The port's own device kernels (every device kernel, PyTorch's ops,
    copies and fills included, when own is False) of one call of fn(),
    from torch.profiler: {kernel name: (device ms per call, launches per
    call)}. Fails unless a reading is complete."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.self_device_time_total > 0
               and (not own or is_own_kernel(e.key))]
        # the profiler can lose a launch's record (seen on the H100: 1 of
        # 5 sim1 launches recorded, and whole readings empty late in a run
        # whose allocator held most of the card); each call launches the
        # same kernels, and every wrapper at least one of its own, so an
        # empty reading or a count that is no multiple of reps is read
        # again, with the allocator's cached blocks released first
        whole = evs and all(e.count % reps == 0 for e in evs)
        if whole:
            break
        log(f"      (profiler lost kernel records: "
            f"{[(e.key[:40], e.count) for e in evs]} in {reps} calls; "
            f"read again)")
        torch.cuda.empty_cache()
    require(whole, f"the profiler lost kernel records in 5 readings of "
                   f"{reps} calls: {[(e.key[:40], e.count) for e in evs]}")
    return {e.key: (e.self_device_time_total / reps / 1e3, e.count / reps)
            for e in evs}


def count_device_kernels(label, name, fn):
    """Every device kernel one wrapper call issues, printed: a2b_ord4,
    tp2d_sweep and c_sw must issue exactly one in all (no PyTorch op, copy
    or fill), sim1 exactly one of the port's own (its PyTorch copies of
    non-contiguous operands are printed). Returns the count of all."""
    every = own_kernel_launches(fn, reps=2, own=False)
    total = sum(c for _, c in every.values())
    mine = sum(c for k, (_, c) in every.items() if is_own_kernel(k))
    log(f"    {label} {name}: {total:g} device kernels per call in all, "
        f"{mine:g} of the port's own")
    for k, (v, c) in sorted(every.items(), key=lambda kv: -kv[1][0]):
        log(f"      {v:.4f} ms, {c:g} per call: {k[:110]}")
    if name != "sim1":
        require(total == 1, f"{label}: {name} issued {total:g} device "
                            f"kernels per call, not 1")
    else:
        require(mine == 1, f"{label}: sim1 issued {mine:g} kernels of its "
                           f"own per call, not 1")
    return total


def kernel_resources():
    """Registers per thread, local (spill) bytes per thread, static and
    dynamic shared memory per block and resident blocks per SM of the
    RESOURCES kernels, float32 and float64, read from the built libraries
    (cudaFuncGetAttributes, cudaOccupancyMaxActiveBlocksPerMultiprocessor)
    and printed. Returns {name: [record per form]}."""
    import ctypes
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import _build
    keys = ("registers", "spill_bytes", "static_smem", "dynamic_smem",
            "blocks_per_sm", "threads")
    recs = {}
    for name, forms in RESOURCES.items():
        lib = _build.library(SOURCE.get(name, name))
        for label, fn, lead in forms:
            for dtype, dname in ((0, "float32"), (1, "float64")):
                out = (ctypes.c_int * 6)()
                f = getattr(lib, fn)
                f.restype = ctypes.c_int
                args = lead(4 << dtype) if callable(lead) else lead
                rc = f(*args, dtype, out)
                require(rc == 0, f"{fn}: cudaError {rc}")
                rec = dict(zip(keys, list(out)), form=label, dtype=dname)
                recs.setdefault(name, []).append(rec)
                log(f"  resources {name} {label} {dname}: {out[0]} "
                    f"registers, {out[1]} spill bytes, {out[2]} + {out[3]} "
                    f"bytes of shared memory, {out[4]} blocks of {out[5]} "
                    f"threads an SM")
    return recs


def flatten_outputs(out):
    from types import SimpleNamespace
    if isinstance(out, SimpleNamespace):
        return [(k, v) for k, v in sorted(vars(out).items())
                if v is not None]
    if isinstance(out, tuple):
        return [(str(i), v) for i, v in enumerate(out)]
    return [("0", out)]


def sw_view(name, out, n):
    """The part of an SW-path kernel output the SW step consumes: compute walls
    for the fluxes, compute corners for ke and a2b."""
    if name == "tp2d_sweep":
        return out
    wsl = slice(H, H + n + 1)
    return out[..., wsl, wsl]


def nbytes(t):
    return t.numel() * t.element_size()


def metric_operands(name, args):
    """The metric planes a kernel reads from the grid pack argument."""
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import csw, dsw
    g = None
    for a in args:
        if hasattr(a, "halo"):
            g = a
    if g is None:
        return []
    names = {"a2b_ord4": A2B_METRICS,
             "c_sw": csw.METRICS, "d_sw_fluxes": dsw.FLUX_METRICS,
             "d_sw_winds": dsw.WIND_METRICS,
             "pgradc_fused": ("rdxc", "rdyc")}.get(name, ())
    return [getattr(g, nm) for nm in names]


def kernel_bound_ms(name, args, kw, outs, points, dtype_name):
    """Least time for the work: the larger of the bytes the function must
    move (each tensor argument and metric plane read once, each output
    written once) over the memory rate and the estimated operations over
    the f32 peak."""
    import torch
    seen, byts = set(), 0
    flat = list(args) + list(kw.values()) + metric_operands(name, args)
    for a in flat:
        items = a.values() if isinstance(a, dict) else [a]
        for x in items:
            if torch.is_tensor(x) and id(x) not in seen:
                seen.add(id(x))
                byts += nbytes(x)
    byts += sum(nbytes(o) for o in outs)
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_POINT[name] * points / PEAK_FLOPS.get(
        dtype_name, PEAK_FLOPS["float32"]) * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations"


def compare(label, name, args, kw, n, tol, sw=False):
    """One launch of a kernel wrapper against its plain version on the same
    inputs; fails on a missing launch, a disagreeing non-finite pattern or
    an error over tol x max|ref| in any output. Returns (max |diff|, the
    wrapper's outputs)."""
    import torch
    mod, attr, plain, cnt = kernel_modules()[name]
    before = cnt()
    got = flatten_outputs(getattr(mod, attr)(*args, **kw))
    torch.cuda.synchronize()
    require(cnt() == before + 1,
            f"{label}: {name} wrapper did not launch its kernel")
    ref = dict(flatten_outputs(plain(*args, **kw)))
    err, worst, nflip = 0.0, 0.0, 0
    for key, o in got:
        r = ref[key]
        if sw:
            o, r = sw_view(name, o, n), sw_view(name, r, n)
        o, r = o.double(), r.double()
        fin = torch.isfinite(r)
        require(bool(torch.equal(fin, torch.isfinite(o))),
                f"{label}: {name} output {key}: non-finite points differ "
                f"from the plain version")
        require(bool(fin.any()), f"{label}: {name} output {key} not finite")
        if sw:
            require(bool(fin.all()), f"{label}: {name} output not finite")
        d = torch.where(fin, (o - r).abs(), torch.zeros_like(r))
        m = float(torch.where(fin, r.abs(), torch.zeros_like(r)).max())
        e = float(d.max())
        err = max(err, e)
        rel = e / m if m > 0 else e
        worst = max(worst, rel)
        nflip += int((d > 1e-6 * m).sum())
    log(f"  {label} {name}: max|diff| {err:.3e}, worst output "
        f"{worst:.3e} x max|ref| (tol {tol:g}); points over 1e-6 rel: "
        f"{nflip}")
    require(worst <= tol, f"{label}: {name} disagrees with its plain "
                          f"version ({worst:.3e} > {tol:g})")
    return err, [o for _, o in got]


def points_of(name, args, n):
    """Output points of one call: 6 x (tracers x) levels x (n+1)^2."""
    q = args[1] if name == "sim1" else args[0]
    lead = 1
    for d in q.shape[:-2]:
        lead *= d
    return lead * (n + 1) ** 2


def check_call(label, name, args, kw, calls, n, tol, measure, sw=False,
               count=True):
    """One kernel call against its plain version (and, if measure, its
    times and bound): the record of that call shape with the calls the path
    makes at it per step. The EXACT kernels are held to max |diff| 0.
    count: read the device kernels of a call (ALL_KERNELS_COUNTED)."""
    mod, attr, plain, _ = kernel_modules()[name]
    shp = list(call_shape(args))
    if name in EXACT:
        tol = 0.0
    err, got = compare(f"{label} {shp} x{calls}", name, args, kw, n, tol,
                       sw=sw)
    rec = {"shape": shp, "calls": calls, "max_abs_err": err}
    wrapper = getattr(mod, attr)
    if count and name in ALL_KERNELS_COUNTED:
        rec["device_kernels_per_call"] = count_device_kernels(
            f"{label} {shp}", name, lambda: wrapper(*args, **kw))
    if measure:
        ms = time_ms(lambda: wrapper(*args, **kw))
        plain_ms = time_ms(lambda: plain(*args, **kw), reps=5, warm=1)
        bound, by = kernel_bound_ms(name, args, kw, got,
                                    points_of(name, args, n),
                                    str(got[0].dtype).split(".")[-1])
        own = own_kernel_launches(lambda: wrapper(*args, **kw))
        kms = sum(v[0] for v in own.values())
        nk = sum(v[1] for v in own.values())
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                   kernel_ms=kms, kernels_per_call=nk)
        log(f"    {name} {shp}: wrapper {ms:.4f} ms (kernel alone {kms} "
            f"ms, {kms / bound:.2f}x its bound, {nk:g} device kernels per "
            f"call), plain "
            f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}); {calls} calls "
            f"per step")
        if name in ("d_sw_fluxes", "d_sw_winds"):
            for k, (v, c) in sorted(own.items(), key=lambda kv: -kv[1][0]):
                log(f"      {v:.4f} ms, {c:g} launches per call: {k[:110]}")
    return rec


def check_kernels(cap, names, n, tol, label, measure, sw=False,
                  count=True):
    """Kernel against plain version on the captured inputs, at every call
    shape the main path gave it. Returns {name: [record per shape]}, each
    with the shape, the calls at that shape in the captured run, the error
    and (if measure is True, or measure(name, shape) is) the times."""
    recs = {}
    for name in names:
        require(name in cap.args, f"{label}: main path never reached {name}")
        recs[name] = [
            check_call(label, name, args, kw, cap.calls[name][shp], n, tol,
                       measure is True or (callable(measure)
                                           and measure(name, shp)), sw=sw,
                       count=count)
            for shp, (args, kw) in cap.args[name].items()]
    return recs


def check_column_depths(cap):
    """The COLUMN_KERNELS against their plain versions bit for bit at
    COLUMN_DEPTHS, on c192_hydro's captured C192 calls with their levels
    repeated (or cut) to K and cast to each dtype, with the plan each call
    takes and the device kernels it issues (1). Returns the records."""
    import torch
    from types import SimpleNamespace
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import pg_col
    recs = []
    for K, dnames in COLUMN_DEPTHS:
        for dname in dnames:
            dt = getattr(torch, dname)
            for name in COLUMN_KERNELS:
                args, kw = next(iter(cap.args[name].values()))
                K0 = args[0].shape[1]
                lev = torch.arange(K, device=args[0].device) % K0

                def depth(x):
                    x = x[:, lev] if x.shape[1] == K0 else x
                    return x.to(dt).contiguous()

                P = args[0].shape[-1]
                plan = pg_col.launch_plan(name, K, P, P, dt.itemsize)
                if name != "pgradc_fused":     # pkgz, geopk
                    new = [depth(x) for x in args[:3]] + list(args[3:])
                    shape = f"{plan.threads} threads"
                else:
                    g = args[5]
                    new = ([depth(x) for x in args[:5]]
                           + [SimpleNamespace(rdxc=g.rdxc.to(dt),
                                              rdyc=g.rdyc.to(dt))]
                           + list(args[6:]))
                    shape = f"{plan.rows} window rows"
                label = f"C192L{K} {dname}"
                err, _ = compare(f"{label} ({shape})", name, new, kw, 192,
                                 0.0)
                nk = count_device_kernels(label, name,
                                          lambda: getattr(pg_col, name)(
                                              *new, **kw))
                recs.append({"kernel": name, "K": K, "dtype": dname,
                             "plan": shape, "max_abs_err": err,
                             "device_kernels_per_call": nk})
                del new
    return recs


def check_sim1_offcentred(cap_f32, cap_f64):
    """The sim1 kernel's off-centred form (alpha = 0.75) against its plain
    version on the captured calls of the NH paths (C192L79 float32, C24L10
    float64) and on each cast to the other dtype: K = 79 and 10, f32 and
    f64, under phase 2's limits, with the device kernels a call issues (1
    of the port's own). At C192L79 float32 the kernel alone at alpha 0.75
    and at alpha 1 in the same call, the wrapper's and the plain version's
    ms and the bound (the same bytes as at alpha 1). Returns the
    records."""
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import sim1
    recs = []
    for cap, n in ((cap_f32, 192), (cap_f64, 24)):
        (args, kw), = cap.args["sim1"].values()
        for dt in (torch.float32, torch.float64):
            new = [x.to(dt) if torch.is_tensor(x) else x for x in args]
            tol = 1e-4 if dt == torch.float32 else 1e-12
            dname = str(dt).split(".")[-1]
            K = new[1].shape[1]
            label = f"sim1 alpha 0.75 K = {K} {dname}"
            before = sim1.launches_offc
            err, got = compare(label, "sim1", new, dict(alpha=0.75), n, tol)
            require(sim1.launches_offc == before + 1,
                    f"{label}: the off-centred form did not launch")
            rec = {"K": K, "dtype": dname, "alpha": 0.75,
                   "max_abs_err": err,
                   "device_kernels_per_call": count_device_kernels(
                       label, "sim1",
                       lambda: sim1.sim1(*new, alpha=0.75))}
            if n == 192 and dt == torch.float32:
                plan = {a: sim1.launch_plan(
                    new[1].numel() // K, K, new[1].element_size(),
                    a != 1.0) for a in (0.75, 1.0)}
                own = {a: own_kernel_launches(
                    lambda a=a: sim1.sim1(*new, alpha=a)) for a in
                    (0.75, 1.0)}
                kms = {a: sum(v[0] for v in own[a].values())
                       for a in own}
                bound, by = kernel_bound_ms("sim1", new, {}, got,
                                            points_of("sim1", new, n),
                                            dname)
                rec.update(
                    ms=time_ms(lambda: sim1.sim1(*new, alpha=0.75)),
                    plain_ms=time_ms(lambda: sim1.sim1_solver(
                        *new, alpha=0.75), reps=5, warm=1),
                    kernel_ms=kms[0.75], kernel_ms_alpha_1=kms[1.0],
                    bound_ms=bound, bound_by=by,
                    plan={str(a): list(p) for a, p in plan.items()})
                log(f"    sim1 C192L79 f32 kernel alone: alpha 0.75 "
                    f"{kms[0.75]:.4f} ms (plan {plan[0.75]}), alpha 1 "
                    f"{kms[1.0]:.4f} ms (plan {plan[1.0]}); bound "
                    f"{bound:.4f} ms ({by}); wrapper {rec['ms']:.4f} ms, "
                    f"plain {rec['plain_ms']:.4f} ms at alpha 0.75")
            recs.append(rec)
    return recs


def per_launch(shapes):
    """One kernel's numbers over the main path's calls: ms, plain_ms,
    bound_ms and kernel_ms as means per launch, weighted by the calls at
    each shape (so times x launches is the path's total), the largest
    error, the bound_by of the shape with the largest summed bound, and the
    device ms per step of the kernel alone (kernel ms x calls, summed)."""
    calls = sum(s["calls"] for s in shapes)
    # a kernel no path calls (fv_tp_2d) weighs its shapes alike
    wts = [s["calls"] for s in shapes] if calls else [1] * len(shapes)
    out = {"max_abs_err": max(s["max_abs_err"] for s in shapes)}
    for key in ("ms", "plain_ms", "bound_ms", "kernel_ms"):
        vals = [s.get(key) for s in shapes]
        out[key] = (None if None in vals else
                    sum(v * w for v, w in zip(vals, wts)) / sum(wts))
    out["bound_by"] = max(zip(shapes, wts),
                          key=lambda sw: sw[0]["bound_ms"] * sw[1])[0][
        "bound_by"]
    out["kernel_ms_per_step"] = (None if out["kernel_ms"] is None
                                 else out["kernel_ms"] * calls)
    return out


def check_ke_levels(cap, n, label):
    """ke_section against its plain version bit for bit on the SW path's
    captured call with its six fields stacked to KE_LEVELS levels (each
    level scaled apart), with the device kernels it issues (1)."""
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import ke
    for args, kw in cap.args["ke_section"].values():
        new = [torch.cat([x * (1 + 0.25 * k) for k in range(KE_LEVELS)],
                         dim=1) for x in args[:6]] + list(args[6:])
        lab = f"{label} K = {KE_LEVELS}"
        compare(lab, "ke_section", new, kw, n, 0.0, sw=True)
        count_device_kernels(lab, "ke_section",
                             lambda: ke.ke_section(*new, **kw))


def check_other_hords(cap, n, tol, label):
    """The hords a kernel takes besides the SW path's (SWConfig's default
    6), each against the plain version on the captured inputs with only the
    hord changed."""
    for name, pos in HORD_ARG.items():
        mod = kernel_modules()[name][0]
        for args, kw in cap.args[name].values():
            require(len(args) > pos, f"{name}: hord not passed by position")
            for hord in mod.KERNEL_HORDS:
                if hord != args[pos]:
                    compare(f"{label} hord {hord}", name,
                            args[:pos] + [hord] + args[pos + 1:], kw, n,
                            0.0 if name in EXACT else tol, sw=True)


def sw_setup(npx, dtype, device, geom=None):
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.grid.metrics import (
        build_grid_geometry)
    from gfdl_atmos_cubed_sphere_tpu_torch.init import sw_cases
    from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import (
        build_grid_ops)
    from gfdl_atmos_cubed_sphere_tpu_torch.model.sw_dynamics import (
        prepare_phis)
    t0 = time.perf_counter()
    if geom is None:
        geom = build_grid_geometry(npx, ng=H)
    t_metrics = time.perf_counter() - t0
    g = build_grid_ops(npx, dtype=dtype, device=device, geom=geom)
    ic = sw_cases.case2(geom)
    prepare_phis(g, ic["phis"])
    state = [torch.as_tensor(ic[k], dtype=dtype, device=g.device)
             for k in ("delp", "u", "v")]
    return g, geom, state, t_metrics


class BigStep:
    """The big step on one grid: fv_dynamics_nh, or fv_dynamics_hydro when
    hydro. Jablonowski-Williamson baroclinic wave (perturbed) on
    set_eta(K), dp0 = diff(ak) + diff(bk) * 1e5 (bench.py:83). Dry: q = {}.
    Moist (bench.py:64-80, 88): the moist wave, adiabatic = False, sphum
    from it and the other five GFDL-MP tracers at 1e-6, MPConfig(). The
    state is the list of fields (delp, pt, u, v, and w, delz on the
    nonhydrostatic path), then the tracers of TRACERS when moist. over:
    DynConfig settings on top of the path's (a bundle of phase 10, named
    bundle); mp: the MPConfig of a moist step (MPConfig() when None)."""

    def __init__(self, npx, npz, dt, k_split, n_split, dtype, device,
                 geom=None, ic=None, moist=False, hydro=False, over=None,
                 bundle=None, mp=None):
        from gfdl_atmos_cubed_sphere_tpu_torch.grid.fv_eta import set_eta
        from gfdl_atmos_cubed_sphere_tpu_torch.grid.metrics import (
            build_grid_geometry)
        from gfdl_atmos_cubed_sphere_tpu_torch.init.baroclinic import (
            jw_baroclinic)
        from gfdl_atmos_cubed_sphere_tpu_torch.model.dyn_core import (
            DynConfig)
        from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import (
            build_grid_ops, state_from_arrays)
        from gfdl_atmos_cubed_sphere_tpu_torch.model.sw_dynamics import (
            prepare_phis)
        from gfdl_atmos_cubed_sphere_tpu_torch.physics.gfdl_mp import (
            MPConfig)
        import numpy as np
        t0 = time.perf_counter()
        self.moist = moist
        self.hydro = hydro
        self.over = over
        self.bundle = bundle
        self.fields = ("delp", "pt", "u", "v") + (() if hydro
                                                  else ("w", "delz"))
        self.geom = geom or build_grid_geometry(npx, ng=H)
        _, self.ptop, self.ak, self.bk = set_eta(npz)
        self.ic = ic or jw_baroclinic(self.geom, npz, self.ak, self.bk,
                                      self.ptop, perturb=True, moist=moist)
        if moist and "q" not in self.ic:
            q = {nm: np.full(self.ic["sphum"].shape, 1e-6)
                 for nm in TRACERS}
            q["sphum"] = self.ic["sphum"]
            self.ic = dict(self.ic, q=q)
        self.names = self.fields + (TRACERS if moist else ())
        self.mp_cfg = (mp or MPConfig()) if moist else None
        self.t_setup = time.perf_counter() - t0
        self.g = build_grid_ops(npx, dtype=dtype, device=device,
                                geom=self.geom)
        prepare_phis(self.g, self.ic["phis"])
        self.dp0 = np.diff(self.ak) + np.diff(self.bk) * 1.0e5
        self.cfg = DynConfig(npx=npx, npz=npz, dt=dt, k_split=k_split,
                             n_split=n_split,
                             **dict(HYDRO_CFG if hydro else NH_CFG,
                                    adiabatic=not moist, **(over or {})))
        st = state_from_arrays(self.ic, dtype=dtype, device=device)
        self.state = [st[k] for k in self.fields] + [
            st["q"][k] for k in self.names[len(self.fields):]]
        self._like = ((npx, npz, dt, k_split, n_split),
                      dict(geom=self.geom, ic=self.ic, moist=moist,
                           hydro=hydro, over=over, bundle=bundle, mp=mp))

    def like(self, dtype, device):
        """The same case in another dtype or on another device."""
        args, kw = self._like
        return type(self)(*args, dtype, device, **kw)

    def step(self, state):
        from gfdl_atmos_cubed_sphere_tpu_torch.model.fv_dynamics import (
            fv_dynamics_hydro, fv_dynamics_nh)
        nf = len(self.fields)
        q = dict(zip(self.names[nf:], state[nf:]))
        if self.hydro:
            r = fv_dynamics_hydro(*state[:nf], q, self.g, self.cfg, self.ak,
                                  self.bk, self.ptop, mp_cfg=self.mp_cfg)
        else:
            r = fv_dynamics_nh(*state[:nf], q, self.g, self.cfg, self.ak,
                               self.bk, self.ptop, self.dp0,
                               mp_cfg=self.mp_cfg)
        return ([getattr(r, k) for k in self.fields]
                + [r.q[k] for k in self.names[nf:]])

    @property
    def label(self):
        return (("hydro " if self.hydro else "NH ")
                + ("moist" if self.moist else "dry")
                + (f" {self.bundle}" if self.bundle else ""))


def card_vs_cpu(card_case, steps=2, phase="3", tols=None,
                control="float32"):
    """C24L10 float64 big steps of `card_case` on the card against the
    same steps of the port on the CPU, each field (and tracer) against its
    own maximum (CARD_TOL's limits, or tols'); both must be finite. The
    control must read over every limit: the same steps on the card in
    float32, or (control "rounded") in float64 from the initial state
    rounded to float32, for a configuration whose float32 run overflows.
    A field that is zero on the CPU must be zero on the card. Returns the
    CPU's final state."""
    import torch
    cpu = card_case.like(torch.float64, "cpu")
    if control == "float32":
        f32 = card_case.like(torch.float32, "cuda")
        sf, step_ctl = list(f32.state), f32.step
        what = "the card in float32"
    else:
        sf = [t.float().double() for t in card_case.state]
        step_ctl = card_case.step
        what = "the card from the state rounded to float32"
    label = card_case.label
    tols = tols if tols is not None else CARD_TOL[label.split()[0]]
    scard, sc = list(card_case.state), list(cpu.state)
    for _ in range(steps):
        scard = card_case.step(scard)
        sc = cpu.step(sc)
        sf = step_ctl(sf)
    for nm, a, b in zip(card_case.names, scard, sc):
        require(bool(torch.isfinite(b).all()),
                f"{label} CPU step: NaN or inf in {nm}")
        require(bool(torch.isfinite(a).all()),
                f"{label} card step: NaN or inf in {nm}")
    bad = []
    for nm, a, f, b in zip(card_case.names, scard, sf, sc):
        top = float(b.abs().max())
        if top == 0.0:
            require(float(a.abs().max()) == 0.0,
                    f"{label}: {nm} is zero on the CPU, not on the card")
            log(f"  C24L10 f64 {label} {steps} big steps {nm}: zero on the "
                f"card and the CPU")
            continue
        r = float((a.cpu() - b).abs().max()) / top
        ctl = float((f.cpu().double() - b).abs().max()) / top
        tol = tols.get(nm, 1e-10)
        log(f"  C24L10 f64 {label} {steps} big steps {nm}: card vs CPU "
            f"{r:.3e} x its max (tol {tol:g}); control, {what}: "
            f"{ctl:.3e}")
        if not r <= tol:
            bad.append(nm)
        require(ctl > tol, f"the control reads {nm} within its limit "
                           f"{tol:g} (or NaN): the check could not tell a "
                           f"fault")
    log(f"phase {phase} {label} big step card vs CPU: over the limit "
        f"{bad or 'none'}")
    require(not bad, f"{label} step on the card disagrees with the CPU "
                     f"in {bad}")
    return sc


def step_phase(label, case, state, mass0, card, shapes, per_step, kernels):
    """The full-width C192 big step of `case`: 1 warm-up step (the
    captured step came before it), 5 timed steps behind a scalar readback
    barrier with the launch counts and tracer_2d's subcycle counts set to 0
    just before them and read just after, 1 step under the profiler, 1 by
    PyTorch op and 1 by layer. Fails on a non-finite field, a mass change
    over 1e-5 or a launch count other than per_step's (the rank-5 tp
    sweep: one launch per tracer_2d subcycle on top). shapes: the path's
    kernel records by call shape (device ms by kernel). Returns the launch
    counts, with the sim1 launches of its off-centred form under
    "sim1_offcentred" and the s/step under "s_per_step"."""
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.model import tracer_2d
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import sim1, tp_sweep
    state = case.step(state)                              # warm-up
    float(torch.sum(state[0]))
    nsteps = 5
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    tracer_2d.reset_nsplt()
    sec, state = timed_steps(case.step, state, nsteps)
    launches = counts()
    launches["sim1_offcentred"] = sim1.launches_offc
    rank5 = tp_sweep.launches_rank5
    nsplt = list(tracer_2d.nsplt_calls)
    peak = torch.cuda.max_memory_allocated()
    for nm, t in zip(case.names, state):
        require(bool(torch.isfinite(t).all()),
                f"{label}: NaN or inf in {nm}")
    dm = abs(mass(case.g, state[0]) - mass0) / abs(mass0)
    ptslev = 6 * (case.cfg.npx - 1) ** 2 * case.cfg.npz / sec
    log(f"phase {label}: {sec:.4f} s/step, {ptslev:.4e} pts*lev/s on {card}; "
        f"mass change {dm:.3e} over {nsteps + 2} big steps; launches "
        f"{launches}, of which rank-5 tp2d_sweep {rank5}; tracer_2d nsplt "
        f"per call {nsplt}; peak device memory {peak / 2 ** 30:.2f} GiB "
        f"({base / 2 ** 30:.2f} GiB allocated before the steps)")
    require(dm <= 1e-5, f"{label}: mass drifted by {dm:.3e}")
    require(len(nsplt) == (nsteps * case.cfg.k_split if case.moist else 0),
            f"{label}: tracer_2d ran {len(nsplt)} times in {nsteps} steps")
    require(rank5 == sum(nsplt), f"{label}: {rank5} rank-5 tp2d_sweep "
                                 f"launches, tracer_2d subcycled {nsplt}")
    for name, per in per_step.items():
        want = per * nsteps + (rank5 if name == "tp2d_sweep" else 0)
        require(launches[name] == want,
                f"{label}: {name} launched {launches[name]} times in "
                f"{nsteps} big steps, expected {want}")
    by, busy = device_ms_by_kernel(lambda: case.step(state), reps=1)
    own = own_kernels_ms(by)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:8]
    log(f"  profile of 1 big step: device busy {busy} of the wall time; "
        f"device ms/step {sum(by.values()):.3f}, of which the port's "
        f"kernels {own}; top: " + "; ".join(f"{k[:60]} {v:.3f}"
                                          for k, v in top))
    per_kernel = []
    for nm in kernels:
        shp = [sh for sh in shapes[nm] if case.moist or len(sh["shape"]) != 5]
        rec = per_launch(shp)
        if rec["kernel_ms_per_step"] is None:
            continue
        per_kernel.append(f"{nm} {rec['kernel_ms_per_step']:.3f}" + "".join(
            f" ({sh['shape']}: {sh['kernel_ms']:.3f} x {sh['calls']})"
            for sh in shp if len(shp) > 1))
    log("  device ms per big step by kernel (kernel alone x calls, summed "
        "over call shapes): " + ", ".join(per_kernel))
    ops = device_ms_by_op(lambda: case.step(state))
    log("  device ms per big step by PyTorch op (top 10): " + "; ".join(
        f"{k} {v:.3f}" for k, v in sorted(ops.items(),
                                          key=lambda kv: -kv[1])[:10]))
    log("  wall ms per big step by layer (synchronised): " + ", ".join(
        f"{k} {v:.1f}" for k, v in layer_ms(case, state).items()))
    launches["s_per_step"] = sec
    return launches


def fv_tp_2d_operands(cap):
    """fv_tp_2d_kernel's arguments for d_sw's pt transport on the captured
    step: the first fluxes-stage call's pt, delp and keywords, and the
    Courant numbers, area and mass fluxes that stage computes from them
    (its kernel, launched here outside any counted run)."""
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import dsw
    (delp, pt, w, uc, vc, g), kw = next(iter(cap.args["d_sw_fluxes"]
                                             .values()))
    fl = dsw.d_sw_fluxes(delp, pt, w, uc, vc, g, **kw)
    args = [pt, fl.crx, fl.cry, kw["hord_tm"], fl.xfx, fl.yfx, g.area,
            fl.ra_x, fl.ra_y, g.dxa, g.dya]
    return args, dict(mfx=fl.fx, mfy=fl.fy, nord=kw["nord_v"],
                      damp_c=kw["damp_v"], g=g, mass=delp)


def mass(g, delp):
    import torch
    ctr = slice(H, H + g.n)
    return float(torch.sum(delp.double() * g.area[..., ctr, ctr].double()))


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "unknown"


def timed_steps(step, state, nsteps):
    """nsteps of step() behind a scalar readback barrier: (s/step, state)."""
    import torch
    t0 = time.perf_counter()
    for _ in range(nsteps):
        state = list(step(state))
    float(torch.sum(state[0]))                           # readback barrier
    return (time.perf_counter() - t0) / nsteps, state


def captured_calls(label, cap, per_step, nsplt):
    """The calls of each wrapper in a captured big step: per_step's at rank
    4 and one rank-5 tp sweep per tracer_2d subcycle."""
    for name, per in per_step.items():
        calls = cap.calls.get(name, {})
        got = sum(c for shp, c in calls.items() if len(shp) != 5)
        require(got == per, f"{label}: {name} called {got} times at rank 4 "
                            f"in the captured big step, expected {per}")
    got = sum(c for shp, c in cap.calls.get("tp2d_sweep", {}).items()
              if len(shp) == 5)
    require(got == sum(nsplt), f"{label}: rank-5 tp2d_sweep called {got} "
                               f"times, tracer_2d subcycled {nsplt}")


def solo_fields(atm):
    """The prognostic fields of a solo Atmosphere's form."""
    return ("delp", "pt", "u", "v") + (() if atm.cfg.hydrostatic
                                       else ("w", "delz"))


def solo_energy(atm):
    """The area-weighted global mean of the column total energy (J/m^2) of
    a solo Atmosphere's state, its fields taken to float64: the
    hydrostatic or the nonhydrostatic form of model/thermodynamics.py."""
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.model import thermodynamics as th
    s = {k: v.double() for k, v in atm.state.items()}
    g, ptop = atm.g, atm.ptop
    phis = g.phis_p[..., H:-H, H:-H].double()
    if atm.cfg.hydrostatic:
        pe = th.interface_pressure(s["delp"], ptop)
        te = th.total_energy_2d_hydro(s["u"], s["v"], s["pt"], s["delp"],
                                      torch.log(pe), pe, phis, g)
    else:
        te = th.total_energy_2d_nh(s["u"], s["v"], s["w"], s["pt"], None,
                                   s["delp"], s["delz"], phis, g)
    return float(th.g_mean(te, g))


def solo_card_vs_cpu(geom):
    """Phase 8a: the solo driver at C24L10 in float64 on the card against
    the CPU, hydrostatic and nonhydrostatic, with Held-Suarez, the sponge
    and both fixers: 2 big steps, then adiabatic_init (its backward passes
    run every kernel with dt < 0), each field against its own maximum
    with phase 3's limits and a float32 control on the card. Then the
    energy fixer on the card: 8 hydrostatic steps without physics, the
    relative change of the global total energy with consv_te = 1 under
    1e-6 and under 0.2 x the change without it (the JAX package's
    tests/test_thermo_moist.py criterion)."""
    from gfdl_atmos_cubed_sphere_tpu_torch.driver.solo import Atmosphere
    for hydro in (True, False):
        kw = dict(physics="hs", hydrostatic=hydro, geom=geom,
                  cfg_overrides=dict(SOLO_C24, **SOLO_FIX))
        card = Atmosphere(25, 10, 900.0, dtype="f64", device="cuda", **kw)
        cpu = Atmosphere(25, 10, 900.0, dtype="f64", device="cpu", **kw)
        f32 = Atmosphere(25, 10, 900.0, dtype="f32", device="cuda", **kw)
        label = "solo hydro" if hydro else "solo NH"
        tols = CARD_TOL["hydro" if hydro else "NH"]
        for stage in ("2 big steps", "adiabatic_init"):
            for atm in (card, cpu, f32):
                if stage == "2 big steps":
                    atm.atmosphere(2)
                else:
                    atm.adiabatic_init()
            bad = []
            for nm in solo_fields(card):
                b = cpu.state[nm]
                require(bool(b.isfinite().all()), f"{label} CPU: NaN in {nm}")
                top = float(b.abs().max())
                r = float((card.state[nm].cpu() - b).abs().max()) / top
                ctl = float((f32.state[nm].cpu().double() - b).abs().max()
                            ) / top
                tol = tols.get(nm, 1e-10)
                log(f"  8a C24L10 f64 {label} {stage} {nm}: card vs CPU "
                    f"{r:.3e} x its max (tol {tol:g}); control, the card "
                    f"in float32: {ctl:.3e}")
                if r > tol:
                    bad.append(nm)
                require(ctl > tol, f"8a {label}: the control reads {nm} "
                                   f"within its limit {tol:g}")
            require(not bad, f"8a {label} {stage}: the card disagrees with "
                             f"the CPU in {bad}")
    change = {}
    for consv in (1.0, 0.0):
        atm = Atmosphere(25, 10, 900.0, physics="none", dtype="f64",
                         device="cuda", geom=geom,
                         cfg_overrides=dict(SOLO_C24, consv_te=consv))
        e0 = solo_energy(atm)
        atm.atmosphere(8)
        change[consv] = abs(solo_energy(atm) - e0) / abs(e0)
    log(f"phase 8a energy fixer, C24L10 f64 on the card, 8 hydrostatic "
        f"steps: relative total-energy change {change[1.0]:.3e} with "
        f"consv_te = 1, {change[0.0]:.3e} without "
        f"({change[1.0] / change[0.0]:.3f} x)")
    require(change[1.0] < 1e-6 and change[1.0] < 0.2 * change[0.0],
            f"8a: the energy fixer leaves a change of {change[1.0]:.3e} "
            f"(without it {change[0.0]:.3e})")


def solo_run(label, atm, per_step, card, gate_mass):
    """Phase 8b: 1 warm-up step, then 5 timed atmosphere() steps behind a
    scalar readback with the launch counts set to 0 just before them and
    read just after, one step under the profiler, and the costs of
    hs_forcing and audit on the state. Fails on a non-finite field, a
    launch count other than per_step's x 5, and (when gate_mass) a mass
    change over 1e-5. Returns a record of the numbers."""
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.physics.held_suarez import (
        hs_forcing)
    nsteps = 5
    atm.atmosphere(1)                                     # warm-up
    float(torch.sum(atm.state["delp"]))
    mass0 = mass(atm.g, atm.state["delp"])
    e0 = solo_energy(atm)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    atm.atmosphere(nsteps)
    float(torch.sum(atm.state["delp"]))                   # readback barrier
    sec = (time.perf_counter() - t0) / nsteps
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    for nm in solo_fields(atm):
        require(bool(torch.isfinite(atm.state[nm]).all()),
                f"{label}: NaN or inf in {nm}")
    dm = abs(mass(atm.g, atm.state["delp"]) - mass0) / abs(mass0)
    de = (solo_energy(atm) - e0) / abs(e0)
    npts = 6 * atm.g.n ** 2 * atm.cfg.npz
    log(f"phase {label}: {sec:.4f} s/step, {npts / sec:.4e} pts*lev/s on "
        f"{card}; mass change {dm:.3e} and relative total-energy change "
        f"{de:.3e} over {nsteps} steps; peak device memory "
        f"{peak / 2 ** 30:.2f} GiB; launches per step " + ", ".join(
            f"{k} {v / nsteps:g}" for k, v in launches.items() if v))
    for name, per in per_step.items():
        require(launches[name] == per * nsteps,
                f"{label}: {name} launched {launches[name]} times in "
                f"{nsteps} steps, expected {per * nsteps}")
    if gate_mass:
        require(dm <= 1e-5, f"{label}: mass drifted by {dm:.3e}")
    by, busy = device_ms_by_kernel(lambda: atm.atmosphere(1), reps=1)
    s = atm.state
    hs_ms = time_ms(lambda: hs_forcing(s["pt"], s["delp"], s["u"], s["v"],
                                       atm.g, atm.ptop, atm.cfg.dt))
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        atm.audit(out=lambda line: None)
        walls.append((time.perf_counter() - t0) * 1e3)
    audit_ms = statistics.median(walls)
    log(f"  {label}: device busy {busy} of the wall time, device ms per "
        f"step {sum(by.values()):.3f}; hs_forcing {hs_ms:.3f} ms, audit "
        f"{audit_ms:.3f} ms per call")
    log("  wall ms of one step by layer (synchronised): " + ", ".join(
        f"{k} {v:.1f}" for k, v in solo_layer_ms(atm).items()))
    lines = []
    atm.timers.report(out=lines.append)
    log("  Timers: " + " | ".join(" ".join(x.split()) for x in lines))
    return dict(s_per_step=sec, launches={k: v // nsteps
                                          for k, v in launches.items()},
                hs_ms=hs_ms, audit_ms=audit_ms, busy=busy, peak=peak,
                energy_change=de, mass_change=dm)


def solo_full_width(geom, card):
    """Phases 8b and 8c: the solo driver at C192L79 in float32 with
    Held-Suarez forcing: hydrostatic with the fixers and the sponge on and
    off, then nonhydrostatic with them on (each run starts from the same
    initial state, written once and read back); then the restart check.
    Returns the launches per step of the hydrostatic and nonhydrostatic
    runs with the fixers on."""
    import os
    import shutil
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.driver.solo import Atmosphere
    os.makedirs(SOLO_DIR, exist_ok=True)
    try:
        t0 = time.perf_counter()
        kw = dict(physics="hs", geom=geom, device="cuda")
        on = Atmosphere(193, 79, 450.0, cfg_overrides=dict(SOLO_HYDRO,
                                                           **SOLO_FIX), **kw)
        s0 = os.path.join(SOLO_DIR, "solo_c192_init.npz")
        on.write_restart(s0)
        log(f"phase 8b: solo Atmosphere at C192L79 f32, host set-up "
            f"{time.perf_counter() - t0:.1f} s (grid shared with phase 5)")
        hy_on = solo_run("8b solo_hydro fixers+sponge on", on,
                         HYDRO_PER_STEP, card, gate_mass=False)
        del on
        off = Atmosphere(193, 79, 450.0, cfg_overrides=dict(SOLO_HYDRO),
                         restart=s0, **kw)
        hy_off = solo_run("8b solo_hydro fixers+sponge off", off,
                          HYDRO_PER_STEP, card, gate_mass=True)
        del off
        nh = Atmosphere(193, 79, 450.0, hydrostatic=False,
                        cfg_overrides=dict(SOLO_NH, **SOLO_FIX), restart=s0,
                        **kw)
        nh_on = solo_run("8b solo_nh fixers+sponge on", nh, NH_PER_STEP,
                         card, gate_mass=False)
        del nh
        log(f"phase 8b solo_hydro: fixers and sponge cost "
            f"{(hy_on['s_per_step'] - hy_off['s_per_step']) * 1e3:.1f} ms "
            f"per step (on minus off: {hy_on['s_per_step']:.4f} - "
            f"{hy_off['s_per_step']:.4f} s/step); relative total-energy "
            f"change over 5 steps {hy_on['energy_change']:.3e} on, "
            f"{hy_off['energy_change']:.3e} off (float32, not gated) on "
            f"{card}")
        solo_restart(s0, geom, card)
    finally:
        shutil.rmtree(SOLO_DIR, ignore_errors=True)
    return hy_on["launches"], nh_on["launches"]


def solo_restart(s0, geom, card):
    """Phase 8c: the hydrostatic solo run with Held-Suarez and both fixers
    (no sponge: its reference winds are the state at each (re)start) at
    C192L79 f32 from the initial state s0: 2 steps, write_restart as
    .fvio and as .npz (the seconds to return, the file complete on
    return, and of them the device-to-host copy), 1 more step; each file
    read into a new Atmosphere and stepped once must equal the continuous
    run bit for bit in every field."""
    import os
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.driver.solo import Atmosphere
    kw = dict(physics="hs", geom=geom, device="cuda",
              cfg_overrides=dict(SOLO_HYDRO, consv_te=1.0, consv_am=True))
    atm = Atmosphere(193, 79, 450.0, restart=s0, **kw)
    atm.atmosphere(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    [v.cpu() for v in atm.state.values()]
    d2h = time.perf_counter() - t0
    paths = []
    for ext in ("fvio", "npz"):
        path = os.path.join(SOLO_DIR, f"solo_c192_step2.{ext}")
        t0 = time.perf_counter()
        atm.write_restart(path)
        sec = time.perf_counter() - t0
        log(f"phase 8c write_restart .{ext}: returned after {sec:.3f} s "
            f"with the file complete ({os.path.getsize(path) / 2 ** 20:.1f}"
            f" MiB; the state's device-to-host copy alone {d2h:.3f} s) on "
            f"{card}")
        paths.append(path)
    atm.atmosphere(1)
    for path in paths:
        t0 = time.perf_counter()
        back = Atmosphere(193, 79, 450.0, restart=path, **kw)
        t_load = time.perf_counter() - t0
        require(back.step_count == 2, f"8c: {path} resumed at step "
                                      f"{back.step_count}, not 2")
        back.atmosphere(1)
        diff = [k for k in atm.state
                if not torch.equal(atm.state[k], back.state[k])]
        log(f"phase 8c {os.path.basename(path)}: read into a new "
            f"Atmosphere in {t_load:.2f} s; one step from it against the "
            f"continuous run: fields that differ {diff or 'none'}")
        require(not diff, f"8c: the run resumed from {path} differs from "
                          f"the continuous run, first in {diff[:1]}")


def solo_cli(card):
    """Phase 8d: the CLI as users start it (the README's quick start at
    C48L32, 3 steps, an audit every 2 and a restart written), then a second
    run from that restart; both on the card."""
    import os
    import shutil
    from gfdl_atmos_cubed_sphere_tpu_torch.driver.solo import main as solo
    from gfdl_atmos_cubed_sphere_tpu_torch.io.restart import load_state
    os.makedirs(SOLO_DIR, exist_ok=True)
    try:
        path = os.path.join(SOLO_DIR, "cli.fvio")
        argv = ["--npx", "49", "--npz", "32", "--dt", "1200", "--physics",
                "hs", "--days", "0.05", "--audit-every", "2"]
        t0 = time.perf_counter()
        solo(argv + ["--restart-out", path])
        t1 = time.perf_counter()
        solo(argv + ["--restart-in", path])
        step = load_state(path)[2]["step"]
        log(f"phase 8d CLI: main() ran 3 steps and wrote {path} (step "
            f"{step}) in {t1 - t0:.1f} s, and a second main() resumed from "
            f"it in {time.perf_counter() - t1:.1f} s on {card}")
        require(step == 3, f"8d: the CLI's restart holds step {step}")
    finally:
        shutil.rmtree(SOLO_DIR, ignore_errors=True)


# ---- phase 9: the SHiELD and GFDL facades ---------------------------------

def moist_checkpoint(path, ic, ak, bk, dtype):
    """Write the moist state ic (the prognostic fields and the six tracers
    of ic["q"]) as a checkpoint in dtype, the file a facade resumes from;
    returns its bytes."""
    import os
    import numpy as np
    from gfdl_atmos_cubed_sphere_tpu_torch.io.restart import save_state
    st = {k: np.asarray(ic[k], dtype) for k in ("delp", "pt", "u", "v",
                                                "w", "delz", "phis")}
    q = {nm: np.asarray(ic["q"][nm], dtype) for nm in TRACERS}
    save_state(path, st, ak=ak, bk=bk, tracers=q)
    return os.path.getsize(path)


def facade_c24_state(geom):
    """Phase 9a's moist state at C24L10: the perturbed moist
    Jablonowski-Williamson wave, sphum from it, and the five condensates
    seeded (rain and snow up to 3e-3 kg/kg, so that the reflectivity
    passes its thresholds somewhere). Returns (ic, ak, bk)."""
    import numpy as np
    from gfdl_atmos_cubed_sphere_tpu_torch.grid.fv_eta import set_eta
    from gfdl_atmos_cubed_sphere_tpu_torch.init.baroclinic import (
        jw_baroclinic)
    _, ptop, ak, bk = set_eta(10)
    ic = jw_baroclinic(geom, 10, ak, bk, ptop, perturb=True, moist=True)
    rng = np.random.default_rng(9)
    cell = ic["sphum"].shape
    q = {"sphum": ic["sphum"]}
    for nm, top in (("liq_wat", 3e-4), ("rainwat", 3e-3), ("ice_wat", 2e-4),
                    ("snowwat", 3e-3), ("graupel", 1e-3)):
        q[nm] = rng.uniform(0.0, top, cell)
    return dict(ic, q=q), ak, bk


def _flat(prefix, d, out):
    for k, v in d.items():
        if isinstance(v, dict):
            _flat(f"{prefix}{k}/", v, out)
        elif v is not None:
            out[prefix + k] = v


def facade_sequence(atm):
    """The facade sequence of phase 9a on a GFDLAtmosphere: one dynamics
    step, the physics state-in bundle, a state update with seeded wind,
    temperature (1 K/day and noise) and sphum tendencies, the fv_diag
    sweep, the CMIP set and the GFDL physics and radiation input blocks.
    Returns every output by name ("statein/", "state/", "diag/", "cmip/",
    "inputs/", "radiation/"), tensors on the Atmosphere's device."""
    import numpy as np
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.io.cmip_diag import fv_cmip_diag
    from gfdl_atmos_cubed_sphere_tpu_torch.io.diagnostics import DiagManager
    out = {}
    atm.atmosphere_dynamics(1)
    _flat("statein/", atm.atmos_phys_driver_statein(), out)
    rng = np.random.default_rng(12)
    cell = tuple(atm.state["pt"].shape)

    def tend(a):
        return torch.as_tensor(a, dtype=atm.dtype, device=atm.device)

    atm.atmosphere_state_update(
        tend(rng.normal(0.0, 1e-4, cell)), tend(rng.normal(0.0, 1e-4, cell)),
        tend(1.0 / 86400.0 + rng.normal(0.0, 1e-6, cell)),
        {"sphum": tend(rng.normal(0.0, 1e-9, cell))})
    _flat("state/", atm.state, out)
    _flat("state/q/", atm.tracers, out)
    _flat("diag/", atm.atmosphere_nggps_diag()[1], out)
    _flat("cmip/", fv_cmip_diag(DiagManager(), dict(atm.state), atm.tracers,
                                atm.g, atm.ak, atm.bk, atm.ptop,
                                hydrostatic=atm.cfg.hydrostatic), out)
    _flat("inputs/", atm.atmos_physics_driver_inputs(), out)
    _flat("radiation/", atm.atmos_radiation_driver_inputs(), out)
    return out


def facade_limit(name):
    """Phase 9a's limit, x the field's own maximum, of a facade output:
    phase 3's 1e-10, and the NH w limit for w and the outputs formed from
    it (devtools/nh_w_conditioning.py --facade measures their spread)."""
    leaf = name.rsplit("/", 1)[-1]
    if leaf in W_FIELDS or leaf.rstrip("0123456789") in ("w", "omg"):
        return CARD_TOL["NH"]["w"]
    return 1e-10


def facade_card_vs_cpu(geom):
    """Phase 9a: the facade sequence (facade_sequence) on a GFDLAtmosphere
    at C24L10 in float64, nonhydrostatic, resumed from a checkpoint of
    facade_c24_state, on the card against the CPU: every output against
    its own maximum (facade_limit), NaN at the same points, the threshold
    fields equal."""
    import os
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.driver.gfdl import GFDLAtmosphere
    os.makedirs(SOLO_DIR, exist_ok=True)
    path = os.path.join(SOLO_DIR, "facade_c24.npz")
    ic, ak, bk = facade_c24_state(geom)
    moist_checkpoint(path, ic, ak, bk, "float64")
    kw = dict(dtype="f64", hydrostatic=False, cfg_overrides=FACADE_C24,
              restart=path, geom=geom)
    got = facade_sequence(GFDLAtmosphere(25, 10, 900.0, device="cuda", **kw))
    want = facade_sequence(GFDLAtmosphere(25, 10, 900.0, device="cpu", **kw))
    os.remove(path)
    require(list(got) == list(want), "9a: the card and the CPU give other "
                                     "outputs")
    bad, worst, nans, picks = [], {}, 0, {}
    for name, b in want.items():
        a = got[name].cpu()
        nb = torch.isnan(b)
        nans += int(nb.sum())
        if not torch.equal(torch.isnan(a), nb):
            bad.append(f"{name} (NaN positions)")
            continue
        leaf = name.rsplit("/", 1)[-1]
        if leaf in THRESHOLD_FIELDS:
            picked = b != THRESHOLD_FIELDS[leaf]
            if not (torch.equal(a != THRESHOLD_FIELDS[leaf], picked) and (
                    not leaf.startswith("f") or torch.equal(a, b))):
                bad.append(f"{name} (other points picked)")
                continue
            picks[leaf] = int(picked.sum())
        if nb.all():
            continue
        top = float(b[~nb].abs().max())
        r = float((a[~nb] - b[~nb]).abs().max()) / (top if top > 0 else 1.0)
        worst[name] = r
        if r > facade_limit(name):
            bad.append(f"{name} ({r:.3e})")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:6]
    over = [k for k, r in worst.items() if r > 1e-10]
    log(f"phase 9a facades C24L10 f64 card vs CPU: {len(want)} outputs "
        f"({nans} NaN points, at the same places); the threshold fields "
        f"pick the same points (" + ", ".join(
            f"{k} {v}" for k, v in picks.items()) + "), their values within "
        + ", ".join(f"{k} {worst.get('diag/' + k, 0.0):.1e}"
                    for k in ("40dBz_height", "m10C_reflectivity"))
        + "; worst " + ", ".join(f"{k} {r:.3e}" for k, r in top)
        + f"; over 1e-10 (under the NH w limit "
        f"{CARD_TOL['NH']['w']:g}): {over or 'none'}")
    require(not bad, f"9a: the card disagrees with the CPU in {bad}")


def plev_outside(delp, ptop, plevs):
    """Where each target pressure lies outside the column's layer-mean
    pressures ([6, L, n, n] bool): the NaN of a pressure-level field."""
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.io.derived import layer_pressures
    _, _, pm = layer_pressures(delp, ptop)
    pl = torch.as_tensor(plevs, dtype=delp.dtype, device=delp.device)
    lo, hi = torch.log(pm[:, :1]), torch.log(pm[:, -1:])
    x = torch.log(pl)[None, :, None, None]
    return (x < lo) | (x > hi)


def facade_full_width(geom, ic, ak, bk, card, solo_nh):
    """Phase 9b: the SHiELD facade at C192L79 in float32 with c192_nh's
    splits, resumed from a checkpoint of phase 6's moist initial state:
    1 warm-up and 2 timed atmosphere_dynamics steps (launches per step
    against solo_nh's), then the physics interface, the diagnostics and
    the history file, each timed synchronised. Returns the launches per
    step."""
    import os
    import re
    import shutil
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.driver.gfdl import GFDLAtmosphere
    from gfdl_atmos_cubed_sphere_tpu_torch.io.cmip_diag import fv_cmip_diag
    from gfdl_atmos_cubed_sphere_tpu_torch.io.diagnostics import (
        STD_PLEVS, DiagManager, parse_diag_table)
    os.makedirs(SOLO_DIR, exist_ok=True)
    try:
        path = os.path.join(SOLO_DIR, "moist_c192.npz")
        t0 = time.perf_counter()
        nbytes_ckpt = moist_checkpoint(path, ic, ak, bk, "float32")
        t1 = time.perf_counter()
        atm = GFDLAtmosphere(193, 79, 450.0, hydrostatic=False,
                             cfg_overrides=dict(SOLO_NH), restart=path,
                             geom=geom, device="cuda")
        log(f"phase 9b: moist checkpoint written in {t1 - t0:.2f} s "
            f"({nbytes_ckpt / 2 ** 20:.1f} MiB) and resumed into a "
            f"GFDLAtmosphere (a ShieldAtmosphere) in "
            f"{time.perf_counter() - t1:.2f} s; tracers "
            f"{sorted(atm.tracers)}")
        torch.cuda.reset_peak_memory_stats()
        atm.atmosphere_dynamics(1)                       # warm-up
        torch.cuda.synchronize()
        nsteps = 2
        reset_counts()
        t0 = time.perf_counter()
        atm.atmosphere_dynamics(nsteps)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / nsteps
        launches = counts()
        per_step = {k: v // nsteps for k, v in launches.items()}
        npts = 6 * 192 ** 2 * 79
        for name, v in launches.items():
            require(v == solo_nh[name] * nsteps,
                    f"9b: {name} launched {v} times in {nsteps} facade "
                    f"steps, the solo driver {solo_nh[name]} a step")

        def wall_ms(fn, reps=3):
            walls = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                r = fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t) * 1e3)
            return statistics.median(walls), r

        statein_ms, _ = wall_ms(atm.atmos_phys_driver_statein)
        cell = atm.state["pt"].shape
        gen = torch.Generator(device="cuda").manual_seed(5)
        u_dt = 1e-4 * torch.randn(cell, generator=gen, device="cuda")
        v_dt = 1e-4 * torch.randn(cell, generator=gen, device="cuda")
        t_dt = torch.full(cell, 1.0 / 86400.0, device="cuda")
        q_dt = {"sphum": 1e-9 * torch.randn(cell, generator=gen,
                                            device="cuda")}
        update_ms, _ = wall_ms(lambda: atm.atmosphere_state_update(
            u_dt, v_dt, t_dt, q_dt))
        # the sweep's device work alone (a manager that selects nothing),
        # then with every field registered and copied to the host
        device_ms, _ = wall_ms(lambda: atm.atmosphere_nggps_diag(
            DiagManager(selection=set())))
        diag_ms, (dm, out) = wall_ms(atm.atmosphere_nggps_diag, reps=1)
        held = sum(r.nbytes for rows in dm._store.values() for r in rows)
        nfields = len(dm._fields)
        require(nfields >= 150, f"9b: fv_diag registered {nfields} fields")
        may_nan = re.compile(r"(.*_plev|.*_cmip|pv350K|pv550K|x850|"
                             r"(u|v|t|vort|rh|thetae|q|omg|theta|dp|"
                             r"theta_e|w|ql|qi|qr|qs|qg|cf|qn|z)\d+)$")
        bad = [k for k, v in out.items() if not may_nan.match(k)
               and not bool(torch.isfinite(v).all())]
        require(not bad, f"9b: non-finite diagnostics {bad}")
        outside = plev_outside(atm.state["delp"], atm.ptop,
                               [p * 100.0 for p in STD_PLEVS])
        bad = [k for k, v in out.items() if k.endswith("_plev")
               and not torch.equal(torch.isnan(v), outside)]
        require(not bad, f"9b: NaN of {bad} not where the level is outside "
                         f"the column")
        nan_share = float(outside.double().mean())
        cmip_ms, _ = wall_ms(lambda: fv_cmip_diag(
            DiagManager(), dict(atm.state), atm.tracers, atm.g, atm.ak,
            atm.bk, atm.ptop, hydrostatic=False))
        inputs_ms, _ = wall_ms(atm.atmos_physics_driver_inputs)
        del dm, out
        sel = DiagManager(selection=parse_diag_table(SHIELD_TABLE)[
            "selected"])
        atm.atmosphere_nggps_diag(sel)
        nc = os.path.join(SOLO_DIR, "shield_c192.nc")
        t0 = time.perf_counter()
        sel.write_netcdf(nc)
        nc_sec = time.perf_counter() - t0
        nc_bytes = os.path.getsize(nc)
        peak = torch.cuda.max_memory_allocated()
        log(f"phase 9b shield_nh C192L79 f32 on {card}: atmosphere_dynamics "
            f"{sec:.4f} s/step, {npts / sec:.4e} pts*lev/s; launches per "
            f"step as solo_nh's: " + ", ".join(
                f"{k} {v}" for k, v in per_step.items() if v))
        log(f"  atmos_phys_driver_statein {statein_ms:.3f} ms; "
            f"atmosphere_state_update {update_ms:.3f} ms; "
            f"atmosphere_nggps_diag {diag_ms:.1f} ms = device work "
            f"{device_ms:.1f} + host copies of send {diag_ms - device_ms:.1f}"
            f" ({nfields} fields, {held / 2 ** 30:.2f} GiB of host "
            f"records); fv_cmip_diag {cmip_ms:.1f} ms; "
            f"atmos_physics_driver_inputs {inputs_ms:.3f} ms; "
            f"write_netcdf of {len(sel._fields)} selected fields "
            f"{nc_sec:.2f} s, {nc_bytes / 2 ** 20:.1f} MiB; peak device "
            f"memory {peak / 2 ** 30:.2f} GiB; pressure levels outside the "
            f"column {nan_share:.3f} of the plev points (NaN)")
        return per_step
    finally:
        shutil.rmtree(SOLO_DIR, ignore_errors=True)


# ---- phase 10: the acoustic-loop options and Riemann solvers --------------

def options_card_vs_cpu(geom):
    """Phase 10a: one dry C24L10 float64 big step of each of BUNDLES on
    the card against the CPU (phase 3's limits and its float32 control,
    BUNDLE_TOL beside them), then remap_restart of the off-centred
    bundle's state with a w and a sphum tracer onto set_eta(24)'s higher
    top (as JAX's tests/test_remap_restart.py:36-50), nonhydrostatic, card
    against CPU at 1e-10 of each output's maximum."""
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.grid.fv_eta import set_eta
    from gfdl_atmos_cubed_sphere_tpu_torch.io.restart import remap_restart
    ic = None
    for name, (hydro, dt, over) in BUNDLES.items():
        t0 = time.perf_counter()
        case = BigStep(25, 10, dt, 1, 2, torch.float64, "cuda", geom=geom,
                       ic=ic, hydro=hydro, over=over, bundle=name)
        ic = case.ic
        card_vs_cpu(case, steps=1, phase="10a",
                    tols=dict(CARD_TOL["hydro" if hydro else "NH"],
                              **BUNDLE_TOL.get(name, {})))
        log(f"  ({name}: {time.perf_counter() - t0:.1f} s, dt {dt:g} s, "
            f"{over})")
        if name == "off-centred":
            nh_case = case
    _, _, ak24, bk24 = set_eta(24)
    require(ak24[0] < nh_case.ak[0], "set_eta(24) must top above L10")
    outs = {}
    for dev in ("cuda", "cpu"):
        cpu = BigStep(25, 10, 900.0, 1, 2, torch.float64, "cpu", geom=geom,
                      ic=ic, over=NH_OFFC) if dev == "cpu" else nh_case
        st = dict(zip(cpu.fields, cpu.state))
        # the wave's w is 0: a w and a tracer from the state's own fields
        st["w"] = 0.01 * (st["pt"] - st["pt"].mean())
        q = {"sphum": 0.005 * st["delp"] / st["delp"].max()}
        out, q2 = remap_restart(st, q, cpu.ak, cpu.bk, ak24, bk24, cpu.g,
                                hydrostatic=False)
        outs[dev] = dict(out, sphum=q2["sphum"])
    worst = 0.0
    for nm, b in outs["cpu"].items():
        a = outs["cuda"][nm].cpu()
        require(bool(torch.equal(torch.isnan(a), torch.isnan(b))),
                f"phase 10a remap_restart {nm}: NaN positions differ")
        require(bool(torch.isfinite(b).all()),
                f"phase 10a remap_restart {nm}: not finite")
        require(tuple(b.shape[:2]) == (6, 24), f"remap_restart {nm} shape")
        r = float((a - b).abs().max() / b.abs().max())
        worst = max(worst, r)
        log(f"  remap_restart L10 -> set_eta(24) {nm}: card vs CPU {r:.3e}"
            f" x its max")
    log(f"phase 10a remap_restart C24L10 -> L24 f64 card vs CPU: worst "
        f"{worst:.3e} (tol 1e-10)")
    require(worst <= 1e-10, "remap_restart on the card disagrees with the "
                            "CPU")


class RiemCall:
    """Records the arguments of the first nh_core.riem_solver3 call made
    while it is entered (cloned)."""

    def __enter__(self):
        from gfdl_atmos_cubed_sphere_tpu_torch.ops import nh_core
        self.args = None
        self._orig = nh_core.riem_solver3

        def rec(*a, **kw):
            if self.args is None:
                self.args = ([x.clone() if hasattr(x, "clone") else x
                              for x in a], dict(kw))
            return self._orig(*a, **kw)

        nh_core.riem_solver3 = rec
        return self

    def __exit__(self, *exc):
        from gfdl_atmos_cubed_sphere_tpu_torch.ops import nh_core
        nh_core.riem_solver3 = self._orig
        return False


def solver_costs(case, state):
    """Phase 10b: riem_solver3 alone at SOLVER_A_IMP on the D-stage inputs
    of the first acoustic iteration of one step of case (the moist
    c192_nh state), RIM_2D at its default substeps: ms a call (CUDA events,
    median of 3, RIM_2D's one call) and the device kernels a call (plain
    PyTorch on the card)."""
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import nh_core
    with RiemCall() as rc:
        case.step(state)
    args, kw = rc.args
    ms_rim = 1 + int(abs(args[0]))
    for name, a_imp in SOLVER_A_IMP.items():
        kw2 = dict(kw, a_imp=a_imp, use_logp=False, d2bg_zq=0.0,
                   ms=ms_rim)

        def call():
            return nh_core.riem_solver3(*args, **kw2)

        # RIM_2D takes seconds a call: its one timed call is the one
        # checked
        ms = time_ms(call, reps=1 if name == "RIM_2D" else 3,
                     warm=0 if name == "RIM_2D" else 1)
        for k, v in vars(call()).items():
            require(bool(torch.isfinite(v[..., H:-H, H:-H]).all()),
                    f"phase 10b riem_solver3 {name}: {k} not finite in "
                    f"the compute domain")
        every = own_kernel_launches(call, reps=1, own=False)
        nk = sum(c for _, c in every.values())
        dev_ms = sum(v for v, _ in every.values())
        log(f"phase 10b riem_solver3 {name} (a_imp {a_imp:g}"
            + (f", {ms_rim} substeps" if name == "RIM_2D" else "")
            + f") at C192L79 f32: {ms:.2f} ms a call, {nk:g} device "
              f"kernels a call, {dev_ms:.2f} ms of device time")


def options_full_width(geom, ic, ak, bk, card, shapes_nh, shapes_hy,
                       m_launches, h_launches):
    """Phase 10b at C192L79 float32 on phase 5's geometry: the moist
    c192_nh step with NH_OFFC and the moist c192_hydro step with
    HYDRO_OPTS, each as phases 6 and 7 (step_phase: s/step, busy, peak
    memory, layers), beside their headlines from this run; the sim1
    launches split by form (12 of each a big step); every other kernel's
    launches those of phases 6 and 7; riem_solver3 alone for SIM3, SIM3p0
    and RIM_2D; reset_eta of the moist initial state from L79 to L91 in
    float64 (seconds, the column mass kept to 1e-12). Returns the launches
    of both paths."""
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.grid.fv_eta import set_eta
    from gfdl_atmos_cubed_sphere_tpu_torch.io.restart import reset_eta
    nho = BigStep(193, 79, 450.0, 2, 6, torch.float32, "cuda", geom=geom,
                  ic=ic, moist=True, over=NH_OFFC, bundle="off-centred")
    la = step_phase("10b c192_nh_offc moist f32", nho, nho.state,
                    mass(nho.g, nho.state[0]), card, shapes_nh, NH_PER_STEP,
                    NH_KERNELS)
    log(f"phase 10b c192_nh_offc: {la['s_per_step']:.4f} s/step, "
        f"{6 * 192 ** 2 * 79 / la['s_per_step']:.4e} pts*lev/s; phase 6's "
        f"headline in this run {m_launches['s_per_step']:.4f} s/step; sim1 "
        f"per big step {la['sim1'] / 5:g}, of which alpha 0.75 "
        f"{la['sim1_offcentred'] / 5:g}")
    require(la["sim1_offcentred"] == 12 * 5,
            f"c192_nh_offc: {la['sim1_offcentred']} off-centred sim1 "
            f"launches in 5 big steps, expected 60")
    for name in REPLACES:
        require(la[name] == m_launches[name],
                f"c192_nh_offc: {name} launched {la[name]} times, phase 6 "
                f"{m_launches[name]}")
    solver_costs(nho, nho.state)
    del nho
    hyo = BigStep(193, 79, 450.0, 1, 6, torch.float32, "cuda", geom=geom,
                  ic=ic, moist=True, hydro=True, over=HYDRO_OPTS,
                  bundle="options")
    lh = step_phase("10b c192_hydro_opts moist f32", hyo, hyo.state,
                    mass(hyo.g, hyo.state[0]), card, shapes_hy,
                    HYDRO_PER_STEP, HYDRO_KERNELS)
    log(f"phase 10b c192_hydro_opts: {lh['s_per_step']:.4f} s/step; phase "
        f"7's in this run {h_launches['s_per_step']:.4f} s/step")
    for name in REPLACES:
        require(lh[name] == h_launches[name],
                f"c192_hydro_opts: {name} launched {lh[name]} times, phase "
                f"7 {h_launches[name]}")
    g = hyo.g
    del hyo
    # reset_eta of the moist initial state, float64 on the card
    st = {k: torch.as_tensor(ic[k], dtype=torch.float64, device="cuda")
          for k in ("delp", "pt", "u", "v", "w", "delz")}
    q = {k: torch.as_tensor(v, dtype=torch.float64, device="cuda")
         for k, v in ic["q"].items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st2, q2, ak2, bk2, _ = reset_eta(st, q, ak, bk, g, npz=91,
                                     hydrostatic=False)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    ps_r = ak[0] + st["delp"].sum(1)
    err = float(((st2["delp"].sum(1) - (ps_r - ak2[0])).abs()
                 / (ps_r - ak2[0])).max())
    require(tuple(st2["delp"].shape) == (6, 91, 192, 192),
            "reset_eta: not 91 levels")
    for k, v in list(st2.items()) + list(q2.items()):
        require(bool(torch.isfinite(v).all()), f"reset_eta: {k} not finite")
    require(bool((st2["delz"] < 0).all()), "reset_eta: delz not negative")
    require(err <= 1e-12, f"reset_eta: column mass off by {err:.3e}")
    _, _, ak91, _ = set_eta(91)
    require(ak2[0] == ak91[0], "reset_eta: not set_eta(91)'s coordinate")
    log(f"phase 10b reset_eta moist C192L79 -> L91 f64 on the card: "
        f"{sec:.2f} s; column mass against ps - ptop {err:.3e} (tol "
        f"1e-12)")
    return la, lh

# ---- phase 11: the SHiELD namelist's dynamics -----------------------------

def shield_config(**over):
    """The DynConfig of SHIELD_FV_CORE_NML through the port's
    utils/config, with over (the cuts) on top."""
    import dataclasses
    from gfdl_atmos_cubed_sphere_tpu_torch.utils import config
    dt = over.pop("dt")
    cfg, _ = config.dyn_config_from_namelist(
        config.parse_namelist(SHIELD_FV_CORE_NML), dt=dt)
    return dataclasses.replace(cfg, **over)


def shield_case(cfg, dtype, geom, moist, label, ic=None):
    """BigStep of the SHiELD config: its splits and every other setting
    of the namelist (BigStep sets adiabatic by moist)."""
    import dataclasses
    over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in ("npx", "npz", "dt", "k_split", "n_split",
                              "adiabatic")}
    return BigStep(cfg.npx, cfg.npz, cfg.dt, cfg.k_split, cfg.n_split,
                   dtype, "cuda", geom=geom, ic=ic, moist=moist, over=over,
                   bundle=label)


def shield_per_step(cfg):
    """Launches per big step of the NH kernels at cfg's splits (NH_PER_STEP
    is c192_nh's 12 acoustic steps)."""
    nsub = cfg.k_split * cfg.n_split
    return {k: v // 12 * nsub for k, v in NH_PER_STEP.items()}


def check_kernel_arguments(cap, n, tol, label):
    """Phase 2 at the arguments beyond the path's on the SHiELD path's
    captured calls (each against its plain version on the same inputs,
    under phase 2's limits): the tp sweep at every hord at each captured
    shape (rank 4 and 5) and lim_fac at hord +-1, the d_sw stages at
    DSW_FLUX_CHECKS and DSW_WIND_CHECKS, c_sw at nord 3. Returns what each
    kernel was checked at."""
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import tp_sweep
    hords = list(tp_sweep.KERNEL_HORDS)
    worst = {}

    def run(name, args, kw, what):
        err, _ = compare(f"{label} {what}", name, args, kw, n, tol)
        worst[name] = max(worst.get(name, 0.0), err)

    for shp, (args, kw) in cap.args["tp2d_sweep"].items():
        for hord in hords:
            run("tp2d_sweep", args[:3] + [hord] + args[4:], kw,
                f"{list(shp)} hord {hord}")
        for hord in (1, -1):
            run("tp2d_sweep", args[:3] + [hord] + args[4:],
                dict(kw, lim_fac=ARG_LIM_FAC),
                f"{list(shp)} hord {hord} lim_fac {ARG_LIM_FAC}")
    (args, kw), = cap.args["d_sw_fluxes"].values()
    for over in DSW_FLUX_CHECKS:
        run("d_sw_fluxes", args, dict(kw, **over), str(over))
    (args, kw), = cap.args["d_sw_winds"].values()
    for over in DSW_WIND_CHECKS:
        run("d_sw_winds", args, dict(kw, **over), str(over))
    (args, kw), = cap.args["c_sw"].values()
    run("c_sw", args, dict(kw, nord=3), "nord 3")
    nords_csw = [kw["nord"], 3]
    ranks = sorted({len(shp) - 1 for shp in cap.args["tp2d_sweep"]})
    return {
        "tp2d_sweep": dict(hords=hords, ranks=ranks,
                           lim_fac={str(ARG_LIM_FAC): [1, -1]}),
        "d_sw_fluxes": checked_values(DSW_FLUX_CHECKS),
        "d_sw_winds": checked_values(DSW_WIND_CHECKS),
        "c_sw": dict(nord=nords_csw), "max_abs_err": worst}


def checked_values(checks):
    """{argument: the values a list of phase-2 overrides checked it at}
    (the damping coefficients left out)."""
    out = {}
    for over in checks:
        for k, v in over.items():
            if not k.startswith("damp"):
                out.setdefault(k, set()).add(v)
    return {k: sorted(v) for k, v in out.items()}


def argument_costs(cap):
    """The d_sw kernels alone (profiler) on the SHiELD path's captured calls
    at ARG_COSTS: what the every-argument form costs on the same values,
    and what the namelist's hords and nord 2 add. Returns {kernel: {label:
    ms}}."""
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import dsw
    out = {}
    for i, name in enumerate(("d_sw_fluxes", "d_sw_winds")):
        (args, kw), = cap.args[name].values()
        fn = dsw._launch_fluxes if i == 0 else dsw._launch_winds
        out[name] = {}
        for label, overs in ARG_COSTS.items():
            k = dict(kw, **overs[i], every=overs[2])
            own = own_kernel_launches(lambda: fn(*args, **k))
            out[name][label] = sum(v[0] for v in own.values())
        log(f"    {name} kernel alone on the captured C192L91 call: " +
            "; ".join(f"{lab} {ms:.4f} ms" for lab, ms in out[name].items()))
    return out


def shield_card_vs_cpu(geom):
    """Phase 11c: one C24L10 float64 big step of the SHiELD namelist
    (SHIELD_C24 cuts), dry and moist, and of its SHIELD_NORD3 variant, on
    the card against the CPU with phase 3's limits and its float32
    control; phase 2's checks first on the captured calls of the moist
    namelist step and of the variant (every kernel of the path against its
    plain version, and check_kernel_arguments on the namelist's). The
    variant's dd8 = (da_min_c d4_bg)^4 overflows float32 at C24, so its
    float32 run is NaN: its control is the float64 step on the card from
    the state rounded to float32. It runs dry, as phase 3's NH dry step;
    its hord_tr 13 is held by the tp sweep's every hord at rank 5 on the
    moist captured calls. Returns what the kernels were checked at."""
    import torch
    ics, checked = {}, {}
    for label, over, moist in (("shield", {}, False),
                               ("shield", {}, True),
                               ("shield nord3", SHIELD_NORD3, False)):
        t0 = time.perf_counter()
        cfg = shield_config(**dict(SHIELD_C24, **over))
        case = shield_case(cfg, torch.float64, geom, moist, label,
                           ic=ics.get(moist))
        ics[moist] = case.ic
        if moist or over:
            with Capture() as cap:
                case.step(case.state)
            tag = f"C24L10 {label} {'moist' if moist else 'dry'} f64"
            # (phase 2 counted the device kernels of calls of these shapes)
            check_kernels(cap, NH_KERNELS, 24, 1e-12, tag, measure=False,
                          count=False)
            if not over:
                checked = check_kernel_arguments(cap, 24, 1e-12, tag)
            del cap
        card_vs_cpu(case, steps=1, phase="11c",
                    control="rounded" if over else "float32")
        log(f"  ({label} {'moist' if moist else 'dry'}: "
            f"{time.perf_counter() - t0:.1f} s; nord {cfg.nord}, hord_mt "
            f"{cfg.hord_mt}, hord_vt {cfg.hord_vt}, hord_tm {cfg.hord_tm}, "
            f"hord_dp {cfg.hord_dp}, hord_tr {cfg.hord_tr}, k_split "
            f"{cfg.k_split}, n_split {cfg.n_split})")
    return checked


def shield_full_width(geom, card):
    """Phase 11 at full width, float32: 11a fv_dynamics_nh of the SHiELD
    namelist cut to C192 (SHIELD_CUTS; npz 91 and every other setting as
    written) on the moist baroclinic state at set_eta(91) with phase 6's
    tracers and MPConfig(): one captured step, phase 2 on its calls (every
    NH kernel timed at the namelist's arguments: hord 5 / -5, nord 2 with
    nord_v = nord_w = 2, hord_tr 8; check_kernel_arguments), then timed as
    phase 6 (step_phase). 11b the SHiELD facade: ShieldAtmosphere(193, 91,
    450, hydrostatic=False) with the same DynConfig fields, resumed from a
    checkpoint of 11a's initial state (its tracers pass through the solo
    step untouched): 1 warm-up and 2 timed atmosphere_dynamics steps,
    launches per step as 11a's less the tracer sweep. Returns (the kernel
    records by call shape, the launches of 11a's 5 steps, the launches per
    facade step, what the kernels were checked at)."""
    import dataclasses
    import gc
    import os
    import shutil
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.driver.shield import (
        ShieldAtmosphere)
    from gfdl_atmos_cubed_sphere_tpu_torch.model import tracer_2d
    gc.collect()
    torch.cuda.empty_cache()
    cfg = shield_config(**SHIELD_CUTS)
    require((cfg.npz, cfg.nord, cfg.hord_dp, cfg.hord_tr) == (91, 2, -5, 8),
            f"the SHiELD namelist read as {cfg}")
    case = shield_case(cfg, torch.float32, geom, True, "shield_c192l91")
    log(f"phase 11a shield_c192l91: C192L91 moist baroclinic state, host "
        f"set-up {case.t_setup:.1f} s; DynConfig from the namelist: nord "
        f"{cfg.nord}, hord_mt/vt/tm/dp/tr {cfg.hord_mt}/{cfg.hord_vt}/"
        f"{cfg.hord_tm}/{cfg.hord_dp}/{cfg.hord_tr}, k_split {cfg.k_split},"
        f" n_split {cfg.n_split}, d4_bg {cfg.d4_bg}, vtdm4 {cfg.vtdm4}, "
        f"tau {cfg.tau}, rf_cutoff {cfg.rf_cutoff}, consv_te {cfg.consv_te}")
    mass0 = mass(case.g, case.state[0])
    tracer_2d.reset_nsplt()
    with Capture() as cap:
        state = case.step(case.state)
        float(torch.sum(state[0]))
    nsplt = list(tracer_2d.nsplt_calls)
    shapes = check_kernels(cap, NH_KERNELS, 192, 1e-4,
                           "shield_c192l91 f32", measure=True)
    checked = check_kernel_arguments(cap, 192, 1e-4, "shield_c192l91 f32")
    checked["argument_costs"] = argument_costs(cap)
    per_step = shield_per_step(cfg)
    captured_calls("shield_c192l91", cap, per_step, nsplt)
    del cap
    launches = step_phase("11a shield_c192l91 moist f32", case, state,
                          mass0, card, shapes, per_step, NH_KERNELS)
    t0 = time.perf_counter()
    del state
    fast_phys_calls_c192l91(case, card)
    log(f"phase 12b: {time.perf_counter() - t0:.1f} s")
    ic, ak, bk = case.ic, case.ak, case.bk
    del case
    torch.cuda.empty_cache()
    over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in ("npx", "npz", "dt")}
    os.makedirs(SOLO_DIR, exist_ok=True)
    try:
        path = os.path.join(SOLO_DIR, "shield_c192l91.npz")
        t0 = time.perf_counter()
        moist_checkpoint(path, ic, ak, bk, "float32")
        del ic
        atm = ShieldAtmosphere(193, cfg.npz, cfg.dt, hydrostatic=False,
                               cfg_overrides=over, restart=path, geom=geom,
                               device="cuda")
        t_init = time.perf_counter() - t0
    finally:
        shutil.rmtree(SOLO_DIR, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    atm.atmosphere_dynamics(1)                           # warm-up
    torch.cuda.synchronize()
    nsteps = 2
    reset_counts()
    t0 = time.perf_counter()
    atm.atmosphere_dynamics(nsteps)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / nsteps
    fac = {k: v // nsteps for k, v in counts().items()}
    peak = torch.cuda.max_memory_allocated()
    for k, v in atm.state.items():
        require(bool(torch.isfinite(v).all()), f"11b: {k} not finite")
    for name, per in per_step.items():
        require(fac[name] == per, f"11b: {name} launched {fac[name]} times "
                                  f"a facade step, expected {per}")
    npts = 6 * 192 ** 2 * cfg.npz
    log(f"phase 11b ShieldAtmosphere C192L91 f32 on {card}: checkpoint of "
        f"11a's initial state written and resumed in {t_init:.1f} s; "
        f"atmosphere_dynamics {sec:.4f} s/step, "
        f"{npts / sec:.4e} pts*lev/s; launches per step " + ", ".join(
            f"{k} {v}" for k, v in fac.items() if v)
        + f"; peak device memory {peak / 2 ** 30:.2f} GiB")
    del atm
    torch.cuda.empty_cache()
    return shapes, launches, fac, checked


def shield_mp_config():
    """The MPConfig of SHIELD_GFDL_MP_NML through the port's utils/config."""
    from gfdl_atmos_cubed_sphere_tpu_torch.utils import config
    mpc, unknown = config.mp_config_from_namelist(
        config.parse_namelist(SHIELD_GFDL_MP_NML))
    require(not unknown and mpc.do_sedi_uv and not mpc.use_mp_fast
            and mpc.do_wbf and mpc.tau_l2r == 600.0 and not mpc.fast_fr_mlt,
            f"the SHiELD gfdl_mp_nml read as {mpc} ({unknown})")
    return mpc


#: the names of the results of run_mp_options and run_fv_sg
MP_OUT = ("pt", "q", "diag")
SG_OUT = ("ta", "q", "ua", "va", "w", "u_dt", "v_dt")


def named_outputs(out, names):
    """{name: tensor} of fn's result, a tuple whose items are named by
    names (dicts flattened to name/key, None left out)."""
    flat = {}
    _flat("", dict(zip(names, out)), flat)
    return flat


def hold_card_vs_cpu(label, fn, inputs, names, tol=1e-10):
    """fn on the CPU in float64, on the card in float64 and, as the control,
    on the card in float32, from the same inputs (a dict of CPU float64
    tensors and other arguments; fn takes the device as well). Each output
    (names: those of fn's result tuple) against the CPU's, over its own
    maximum (AUDIT_ERRORS over 1): the card under tol, the control over it;
    an output that is zero on the CPU must be zero on the card."""
    import torch

    def moved(dtype, device):
        return {k: v.to(device=device, dtype=dtype) if torch.is_tensor(v)
                and v.is_floating_point() else v
                for k, v in inputs.items()}

    outs = [named_outputs(fn(**moved(dt, dev), device=dev), names)
            for dt, dev in ((torch.float64, "cpu"), (torch.float64, "cuda"),
                            (torch.float32, "cuda"))]
    cpu, card, ctl = outs
    require(sorted(card) == sorted(cpu) == sorted(ctl),
            f"{label}: the outputs differ in name: {sorted(card)}, "
            f"{sorted(cpu)}")
    worst, bad = {}, []
    for nm, b in cpu.items():
        a, f = card[nm].cpu().double(), ctl[nm].cpu().double()
        require(bool(torch.isfinite(b).all() and torch.isfinite(a).all()),
                f"{label}: NaN or inf in {nm}")
        top = 1.0 if nm.split("/")[-1] in AUDIT_ERRORS else float(
            b.abs().max())
        if top == 0.0:
            require(float(a.abs().max()) == 0.0,
                    f"{label}: {nm} is zero on the CPU, not on the card")
            continue
        r = float((a - b).abs().max()) / top
        c = float((f - b).abs().max()) / top
        worst[nm] = (r, c)
        if not r <= tol:
            bad.append(nm)
        require(c > tol, f"{label}: the float32 control reads {nm} within "
                         f"{tol:g}: the check could not tell a fault")
    log(f"  {label}: card vs CPU, x each output's max (tol {tol:g}; the "
        f"float32 control in brackets): " + ", ".join(
            f"{nm} {r:.2e} ({c:.1e})" for nm, (r, c) in worst.items()))
    require(not bad, f"{label}: the card disagrees with the CPU in {bad}")


def _pressures(delp, ptop):
    """pe and peln [6, K+1, y, x] from delp and ptop."""
    import torch
    pe = ptop + torch.cat([torch.zeros_like(delp[:, :1]),
                           torch.cumsum(delp, 1)], 1)
    return pe, torch.log(pe)


def mp_options_inputs(st, names, ptop, phis, seed=7):
    """gfdl_mp_driver's arguments on a moist big step's state (CPU float64):
    the tracers with a seeded aerosol number liq_aero, w, seeded A-grid
    winds and the surface geopotential hs."""
    import numpy as np
    import torch
    d = dict(zip(names, st))
    rng = np.random.default_rng(seed)
    shape = tuple(d["pt"].shape)
    like = dict(dtype=d["pt"].dtype, device=d["pt"].device)
    q = {k: d[k] for k in TRACERS}
    q["liq_aero"] = torch.as_tensor(rng.uniform(1e-11, 1e-8, shape), **like)
    return dict(pt=d["pt"], delp=d["delp"], delz=d["delz"], q=q, w=d["w"],
                ua=torch.as_tensor(rng.uniform(-30.0, 30.0, shape), **like),
                va=torch.as_tensor(rng.uniform(-30.0, 30.0, shape), **like),
                hs=torch.as_tensor(np.asarray(phis), **like), ptop=ptop)


def run_mp_options(pt, delp, delz, q, w, ua, va, hs, ptop, dt=900.0,
                   cfg=None, device=None):
    """gfdl_mp_driver with MP_OPTIONS (or cfg), nonhydrostatic."""
    from gfdl_atmos_cubed_sphere_tpu_torch.physics.gfdl_mp import (
        MPConfig, gfdl_mp_driver)
    q = {k: v.to(pt.device, pt.dtype) for k, v in q.items()}
    return gfdl_mp_driver(pt, delp, delz, q, dt, ptop,
                          cfg=cfg or MPConfig(**MP_OPTIONS),
                          hydrostatic=False, w=w, ua=ua, va=va,
                          hs=hs.to(pt.device, pt.dtype))


def fv_sg_inputs(st, names, ptop, seed=11):
    """fv_sg_adjust's arguments on a moist big step's state (CPU float64):
    pe, peln, the gas-law pkz of theta_v, seeded A-grid winds."""
    import numpy as np
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch import constants as con
    d = dict(zip(names, st))
    pe, peln = _pressures(d["delp"], ptop)
    tv = d["pt"] * (1.0 + con.ZVIR * d["sphum"])
    pkz = torch.exp(con.KAPPA * torch.log(-con.RDGAS / con.GRAV * d["delp"]
                                          / d["delz"] * tv))
    rng = np.random.default_rng(seed)
    shape = tuple(d["pt"].shape)
    like = dict(dtype=d["pt"].dtype, device=d["pt"].device)
    return dict(delp=d["delp"], pe=pe, peln=peln, pkz=pkz, ta=d["pt"],
                q={k: d[k] for k in TRACERS}, w=d["w"], delz=d["delz"],
                ua=torch.as_tensor(rng.uniform(-30.0, 30.0, shape), **like),
                va=torch.as_tensor(rng.uniform(-30.0, 30.0, shape), **like))


def run_fv_sg(delp, pe, peln, pkz, ta, q, ua, va, w, delz, am5=False,
              dt=900.0, device=None):
    """fv_sg_adjust at FV_SG_ADJ (am5: fv_sg_adjust_am5 at tau FV_SG_ADJ),
    nonhydrostatic."""
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import fv_sg
    fn = fv_sg.fv_sg_adjust_am5 if am5 else fv_sg.fv_sg_adjust
    q = {k: v.to(ta.device, ta.dtype) for k, v in q.items()}
    return fn(dt, FV_SG_ADJ, delp, pe, peln, pkz, ta, q, ua, va,
              hydrostatic=False, w=w, delz=delz)


def fast_phys_c24_ic(geom, seed=3, gap=FAST_SEED_GAP):
    """Phase 12c's initial state at C24L10: the moist wave with sphum
    scaled by seeded 0.95-1.1 (supersaturated in places) and seeded
    condensates (up to 1e-4 - 3e-4 kg/kg) wherever the temperature is more
    than gap K from TICE and t_wfr (none within it)."""
    import numpy as np
    from gfdl_atmos_cubed_sphere_tpu_torch.grid.fv_eta import set_eta
    from gfdl_atmos_cubed_sphere_tpu_torch.init.baroclinic import (
        jw_baroclinic)
    from gfdl_atmos_cubed_sphere_tpu_torch.physics.gfdl_mp import (
        TICE, MPConfig)
    _, ptop, ak, bk = set_eta(10)
    ic = jw_baroclinic(geom, 10, ak, bk, ptop, perturb=True, moist=True)
    rng = np.random.default_rng(seed)
    shape = ic["sphum"].shape
    t = np.asarray(ic["pt"])
    away = ((np.abs(t - TICE) > gap)
            & (np.abs(t - MPConfig().t_wfr) > gap))
    q = {"sphum": ic["sphum"] * rng.uniform(0.95, 1.1, shape)}
    for nm, top in (("liq_wat", 3e-4), ("rainwat", 3e-4), ("ice_wat", 2e-4),
                    ("snowwat", 3e-4), ("graupel", 1e-4)):
        q[nm] = np.where(away, rng.uniform(0.0, top, shape), 0.0)
    return dict(ic, q=q)


def fast_phys_card_vs_cpu(geom):
    """Phase 12c: at C24L10 float64, card against CPU with phase 3's limits
    (FAST_TOL: the precipitating tracers 5e-9) and its float32 control: (i)
    one moist NH big step with do_fast_phys and MPConfig() (the mp_fast
    chain) from fast_phys_c24_ic's state;
    (ii) the same with the SHiELD
    gfdl_mp_nml (sat_adjust as the fast physics); (iii) gfdl_mp_driver alone
    with MP_OPTIONS on (ii)'s CPU state, with seeded liq_aero, ua, va and
    the surface geopotential as hs; (iv) fv_sg_adjust and
    fv_sg_adjust_am5 at FV_SG_ADJ on that state; (v) fill_gfs and fill2d
    on seeded tracers with negatives."""
    import numpy as np
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import (
        build_grid_ops)
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import fv_fill
    t0 = time.perf_counter()
    case = BigStep(25, 10, 900.0, 1, 2, torch.float64, "cuda", geom=geom,
                   ic=fast_phys_c24_ic(geom), moist=True, over=FAST_PHYS,
                   bundle="fast_phys")
    card_vs_cpu(case, steps=1, phase="12c (i)", tols=FAST_TOL)
    case = BigStep(25, 10, 900.0, 1, 2, torch.float64, "cuda", geom=geom,
                   ic=case.ic, moist=True, over=FAST_PHYS,
                   bundle="fast_phys shield_mp", mp=shield_mp_config())
    sc = card_vs_cpu(case, steps=1, phase="12c (ii)", tols=FAST_TOL)
    log(f"  (12c i, ii: {time.perf_counter() - t0:.1f} s)")
    phis = case.ic["phis"]
    hold_card_vs_cpu("12c (iii) gfdl_mp_driver with MP_OPTIONS",
                     run_mp_options, mp_options_inputs(sc, case.names,
                                                       case.ptop, phis),
                     MP_OUT)
    sg = fv_sg_inputs(sc, case.names, case.ptop)
    hold_card_vs_cpu(f"12c (iv) fv_sg_adjust fv_sg_adj {FV_SG_ADJ}",
                     run_fv_sg, sg, SG_OUT)
    hold_card_vs_cpu(f"12c (iv) fv_sg_adjust_am5 tau {FV_SG_ADJ}",
                     run_fv_sg, dict(sg, am5=True), SG_OUT)
    rng = np.random.default_rng(5)
    q = torch.as_tensor(rng.uniform(-0.2, 1.0, (6, 24, 24, 10)))
    dp = torch.movedim(sc[0], 1, -1).contiguous()
    hold_card_vs_cpu("12c (v) fill_gfs", lambda q, dp, device: (
        fv_fill.fill_gfs(q, dp),), dict(q=q, dp=dp), ("q",))
    packs = {dev: build_grid_ops(25, dtype=torch.float64, device=dev,
                                 geom=geom) for dev in ("cpu", "cuda")}
    q2 = rng.uniform(1e-5, 1e-3, (6, 10, 24, 24))
    q2[rng.uniform(size=q2.shape) < 0.1] *= -1.0
    hold_card_vs_cpu("12c (v) fill2d", lambda q, delp, device: (
        fv_fill.fill2d(q, delp, packs[device]),),
        dict(q=torch.as_tensor(q2), delp=sc[0]), ("q",))
    log(f"phase 12c: {time.perf_counter() - t0:.1f} s")


def fast_phys_full_width(geom, ic, card, shapes, launches6):
    """Phase 12a: the moist c192_nh step of phase 6 with do_fast_phys and
    MPConfig() at C192L79 float32, timed as phase 6 (step_phase, its
    launch counts those of phase 6 a big step), the hook's cost as this
    step's s/step less phase 6's of this run. Returns the launches of its 5
    big steps."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    case = BigStep(193, 79, 450.0, 2, 6, torch.float32, "cuda", geom=geom,
                   ic=ic, moist=True, over=FAST_PHYS, bundle="fast_phys")
    mass0 = mass(case.g, case.state[0])
    state = case.step(case.state)     # in place of phase 6's captured step
    launches = step_phase("12a c192_nh_fastphys moist f32", case, state,
                          mass0, card, shapes, NH_PER_STEP, NH_KERNELS)
    for name in NH_PER_STEP:
        require(launches[name] == launches6[name],
                f"12a: {name} launched {launches[name]} times in 5 big "
                f"steps, phase 6 {launches6[name]}")
    on, off = launches["s_per_step"], launches6["s_per_step"]
    log(f"phase 12a: the inline fast physics costs {on - off:.4f} s/step "
        f"({on:.4f} with it, {off:.4f} in phase 6 of this run) on {card}")
    del case, state
    torch.cuda.empty_cache()
    return launches


def fast_phys_calls_c192l91(case, card):
    """Phase 12b, at C192L91 float32 on 11a's initial state: gfdl_mp_driver
    with the SHiELD gfdl_mp_nml and with MPConfig(), with MP_OPTIONS, and
    fv_sg_adjust at FV_SG_ADJ: ms a call (CUDA events, median of 5) and the
    device kernels a call (the profiler, one call)."""
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.physics.gfdl_mp import MPConfig
    d = dict(zip(case.names, case.state))
    mp_in = mp_options_inputs(case.state, case.names, case.ptop,
                              case.ic["phis"])
    sg = fv_sg_inputs(case.state, case.names, case.ptop)
    calls = {
        "gfdl_mp_driver shield gfdl_mp_nml": (lambda: run_mp_options(
            **mp_in, dt=case.cfg.dt, cfg=shield_mp_config()), MP_OUT),
        "gfdl_mp_driver MPConfig()": (lambda: run_mp_options(
            **mp_in, dt=case.cfg.dt, cfg=MPConfig()), MP_OUT),
        "gfdl_mp_driver MP_OPTIONS": (lambda: run_mp_options(
            **mp_in, dt=case.cfg.dt), MP_OUT),
        f"fv_sg_adjust fv_sg_adj {FV_SG_ADJ}": (lambda: run_fv_sg(
            **sg, dt=case.cfg.dt), SG_OUT),
    }
    require(d["pt"].dtype == torch.float32, "12b runs in float32")
    out = {}
    for label, (fn, names) in calls.items():
        res = named_outputs(fn(), names)
        require(all(bool(torch.isfinite(v).all()) for v in res.values()),
                f"12b {label}: NaN or inf")
        ms = time_ms(fn, reps=5, warm=1)
        every = own_kernel_launches(fn, reps=1, own=False)
        n = sum(c for _, c in every.values())
        out[label] = dict(ms=ms, device_kernels=n)
        log(f"phase 12b {label} C192L91 f32 on {card}: {ms:.2f} ms a call, "
            f"{n:g} device kernels a call")
    return out


# ---- phase 13: the NWP cold start, IAU, nudging and terrain ---------------

#: the chgres files' source coordinate: the repo's 127-layer GFS table
NWP_SOURCE_LEVELS = 127
#: the orography files' DEM (degrees) and its Gaussian hill (m, degrees)
NWP_DEM_DEG = 0.25
NWP_HILL = dict(h0=2000.0, lon=100.0, lat=35.0, radius=7.0)
#: the lat-lon increment's spacing (degrees) and the IAU window (s)
NWP_INC_DEG = 0.5
NWP_IAU_WINDOW = 21600.0
#: the two analyses of the nudging, 6 h apart: the second warmer, moister
#: and windier than the first, which is the files' state
NWP_ANALYSIS_DT = 21600.0
NWP_ANALYSIS_SHIFT = dict(t=1.5, sphum=1.05, ua=1.1, ps=150.0)
#: the observed storms of the vortex breeding: lon, lat (degrees), slp (Pa)
NWP_STORMS = ((140.0, 20.0, 97000.0), (300.0, 25.0, 99000.0))
#: the breeding's radii at C24 (cells of ~400 km; the defaults fit C192)
NWP_BREED_C24 = dict(r_min=1500.0e3, r_inc=100.0e3, del_r=1500.0e3,
                     phis_max=3000.0)
#: phase 13d's limits beside 1e-10: the NH w of phase 3
NWP_TOL = dict(CARD_TOL["NH"])
NWP_DIR = "build/torch_smoke/nwp"


def nwp_dem(geom):
    """The DEM of the orography files: the Jablonowski-Williamson surface
    height (test_cases.F90's phi_s, a function of latitude) plus a 2 km
    Gaussian hill, on a NWP_DEM_DEG lat-lon grid. Returns (lon, lat in
    radians, z [nlat, nlon] in m)."""
    import numpy as np
    from gfdl_atmos_cubed_sphere_tpu_torch import constants as con
    from gfdl_atmos_cubed_sphere_tpu_torch.init import baroclinic as bc
    lat = np.deg2rad(np.linspace(-90.0, 90.0, int(180 / NWP_DEM_DEG) + 1))
    lon = np.deg2rad(np.arange(int(360 / NWP_DEM_DEG)) * NWP_DEM_DEG)
    a, b = bc._t_pert_coef(lat)
    c = np.cos((bc.ETA_S - bc.ETA_0) * np.pi * 0.5) ** 1.5
    zs = bc.UBAR * c * (a * bc.UBAR * c + b * geom.radius * geom.omega)
    lon2, lat2 = np.meshgrid(lon, lat)
    h = NWP_HILL
    lat0, lon0 = np.deg2rad(h["lat"]), np.deg2rad(h["lon"])
    cosd = (np.sin(lat0) * np.sin(lat2)
            + np.cos(lat0) * np.cos(lat2) * np.cos(lon2 - lon0))
    r = np.arccos(np.clip(cosd, -1.0, 1.0)) / np.deg2rad(h["radius"])
    return lon, lat, zs[:, None] / con.GRAV + h["h0"] * np.exp(-r ** 2)


def nwp_source(geom):
    """The moist baroclinic state of phase 6 on the NWP_SOURCE_LEVELS
    levels (jw_baroclinic at set_eta(127)), as host numpy: ak, bk, ps, the
    interface heights zh integrated hydrostatically with T from the JW
    surface height, T, sphum, o3mr (a profile in log-p), the JW jet at the
    south and west face midpoints (u_s, u_w; v_s = v_w = 0) and at the
    cell centres (ua, for the analyses), and a seeded w of ~1 cm/s."""
    import numpy as np
    from gfdl_atmos_cubed_sphere_tpu_torch import constants as con
    from gfdl_atmos_cubed_sphere_tpu_torch.grid.fv_eta import set_eta
    from gfdl_atmos_cubed_sphere_tpu_torch.grid.gnomonic import (
        normalize, xyz_to_lonlat)
    from gfdl_atmos_cubed_sphere_tpu_torch.init import baroclinic as bc
    ks = NWP_SOURCE_LEVELS
    _, ptop, ak, bk = set_eta(ks)
    ic = bc.jw_baroclinic(geom, ks, ak, bk, ptop, perturb=True, moist=True)
    ps = ic["ps"][:, 0]
    pe = ak[None, :, None, None] + bk[None, :, None, None] * ps[:, None]
    dz = con.RDGAS / con.GRAV * ic["pt"] * np.log(pe[:, 1:] / pe[:, :-1])
    zs = ic["phis"][:, 0] / con.GRAV
    zh = np.concatenate([zs[:, None] + np.cumsum(dz[:, ::-1], 1)[:, ::-1],
                         zs[:, None]], axis=1)
    eta = 0.5 * ((ak[:-1] + ak[1:]) / 1.0e5 + bk[:-1] + bk[1:])
    eta_v = ((eta - bc.ETA_0) * np.pi * 0.5)[:, None, None, None]
    h, n = geom.ng, geom.n
    cw = geom.arrays["grid_xyz"][:, h:h + n + 1, h:h + n + 1]

    def jet(xyz):
        lon, lat = xyz_to_lonlat(xyz)
        u = bc._u_jet(lat, eta_v, lon=lon, pert=True, radius=geom.radius,
                      r0=geom.radius / 10.0)
        return np.moveaxis(u, 0, 1)                 # [6, ks, ...]

    pm = 0.5 * (pe[:, 1:] + pe[:, :-1])
    return dict(
        ak=ak, bk=bk, ps=ps, zh=zh, t=ic["pt"], sphum=ic["sphum"],
        o3mr=1.0e-5 * np.exp(-0.5 * np.log(pm / 1500.0) ** 2),
        u_s=jet(normalize(cw[:, :, :-1] + cw[:, :, 1:])),
        u_w=jet(normalize(cw[:, :-1, :] + cw[:, 1:, :])),
        ua=jet(geom.arrays["agrid_xyz"][:, h:h + n, h:h + n]),
        w=0.01 * np.random.default_rng(13).standard_normal(ic["pt"].shape))


def write_nwp_files(dirpath, geom, g, src):
    """The chgres cold-start file set in dirpath, as tests/test_nggps_files
    .py writes one (scipy's NetCDF3 writer): gfs_ctrl.nc with src's
    coordinate, gfs_data.tile{1..6}.nc in float32 (ps, zh, sphum, liq_wat
    at 1e-6, o3mr, the face winds u_s, v_s, u_w, v_w, w) and
    oro_data.tile{1..6}.nc whose orog_filt is surfdrv's terrain of
    nwp_dem's DEM, filtered by fv3_zs_filter on g. Returns the seconds of
    surfdrv and of the writes."""
    import os
    import numpy as np
    from scipy.io import netcdf_file
    from gfdl_atmos_cubed_sphere_tpu_torch import constants as con
    from gfdl_atmos_cubed_sphere_tpu_torch.utils.terrain import surfdrv
    os.makedirs(dirpath, exist_ok=True)
    t0 = time.perf_counter()
    orog = (surfdrv(geom, *nwp_dem(geom), g=g)["phis"][:, 0]
            / con.GRAV).cpu().numpy()
    t_surf = time.perf_counter() - t0
    ks, n = src["t"].shape[1], geom.n
    t0 = time.perf_counter()
    with netcdf_file(os.path.join(dirpath, "gfs_ctrl.nc"), "w") as f:
        f.createDimension("levsp", ks + 1)
        f.createDimension("nvcoord", 2)
        f.createVariable("vcoord", "d", ("nvcoord", "levsp"))[:] = np.stack(
            [src["ak"], src["bk"]])
    zeros_s = np.zeros((ks, n + 1, n), np.float32)
    zeros_w = np.zeros((ks, n, n + 1), np.float32)
    for t in range(6):
        with netcdf_file(os.path.join(dirpath, f"gfs_data.tile{t + 1}.nc"),
                         "w") as f:
            for nm, size in (("lev", ks), ("levp", ks + 1), ("lat", n),
                             ("lon", n), ("latp", n + 1), ("lonp", n + 1)):
                f.createDimension(nm, size)
            for nm, dims, a in (
                    ("ps", ("lat", "lon"), src["ps"][t]),
                    ("zh", ("levp", "lat", "lon"), src["zh"][t]),
                    ("sphum", ("lev", "lat", "lon"), src["sphum"][t]),
                    ("liq_wat", ("lev", "lat", "lon"),
                     np.full((ks, n, n), 1.0e-6)),
                    ("o3mr", ("lev", "lat", "lon"), src["o3mr"][t]),
                    ("u_s", ("lev", "latp", "lon"), src["u_s"][t]),
                    ("v_s", ("lev", "latp", "lon"), zeros_s),
                    ("u_w", ("lev", "lat", "lonp"), src["u_w"][t]),
                    ("v_w", ("lev", "lat", "lonp"), zeros_w),
                    ("w", ("lev", "lat", "lon"), src["w"][t])):
                f.createVariable(nm, "f", dims)[:] = a.astype(np.float32)
        with netcdf_file(os.path.join(dirpath, f"oro_data.tile{t + 1}.nc"),
                         "w") as f:
            f.createDimension("lat", n)
            f.createDimension("lon", n)
            f.createVariable("orog_filt", "f", ("lat", "lon"))[:] = orog[t]
    return t_surf, time.perf_counter() - t0


def nwp_increments(km, seed=14):
    """The GSI-style lat-lon increment at NWP_INC_DEG on km levels: smooth
    T, delp, sphum, o3mr and wind increments with seeded phases."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lat = np.linspace(-90.0, 90.0, int(180 / NWP_INC_DEG) + 1)
    lon = np.arange(int(360 / NWP_INC_DEG)) * NWP_INC_DEG
    lon2, lat2 = np.meshgrid(np.deg2rad(lon), np.deg2rad(lat))
    lev = np.linspace(0.0, 1.0, km)[:, None, None]

    def wave(amp):
        a, b, c = rng.uniform(0.0, 2.0 * np.pi, 3)
        return amp * (np.cos(lat2) * np.sin(3 * lon2 + a)
                      * np.cos(2 * lat2 + b))[None] * np.sin(
                          np.pi * lev + c)

    return {"lon": lon, "lat": lat, "T_inc": wave(0.5),
            "delp_inc": wave(5.0) * lev, "sphum_inc": wave(1.0e-5),
            "o3mr_inc": wave(1.0e-8), "u_inc": wave(1.0),
            "v_inc": wave(1.0)}


def nwp_analyses(src):
    """The two analyses of the nudging on the source levels ([6, ks, n, n]
    host numpy: t, sphum, the A-grid ua, va): the files' state and the
    same NWP_ANALYSIS_SHIFT-ed."""
    import numpy as np
    a0 = dict(t=src["t"], sphum=src["sphum"], ua=src["ua"],
              va=np.zeros_like(src["ua"]))
    s = NWP_ANALYSIS_SHIFT
    a1 = dict(t=a0["t"] + s["t"], sphum=a0["sphum"] * s["sphum"],
              ua=a0["ua"] * s["ua"], va=a0["va"])
    return a0, a1


def nwp_mass(g, delp):
    """sum(delp * area) in float64 on the device, no host read."""
    import torch
    ctr = slice(H, H + g.n)
    return torch.sum(delp.double() * g.area[..., ctr, ctr].double())


class NWPStep(BigStep):
    """The moist NH big step of phase 6 from a cold-start state, then the
    IAU (nwp "iau": da_increment.IAU over NWP_IAU_WINDOW of the lat-lon
    increments nwp_data["inc"], through read_da_inc to cube and D-grid
    increments) or the nudging (nwp "nudged": nwp_nudge toward
    ObsSchedule's analyses of nwp_data["analyses"] on the source levels
    nwp_data["ak"], nwp_data["bk"], put on the model levels by
    remap_analysis_to_model, their D winds by d_winds_from_latlon;
    ps_nudging toward their ps (the cold start's, + the shift) with the
    bias correction; breed_slp_inline with NWP_STORMS, nwp_data["breed"]
    its BreedConfig settings). The model time advances by dt a step.
    masses: the (before, after) sum(delp*area) of each fv_dynamics_nh
    call (device scalars); with `layers` a dict, each IAU or nudging call
    adds its synchronised wall ms under its name."""

    def __init__(self, *args, nwp=None, nwp_data=None, **kw):
        super().__init__(*args, **kw)
        self._like[1].update(nwp=nwp, nwp_data=nwp_data)
        self.nwp, self.data = nwp, nwp_data
        self.time = 0.0
        self.masses = []
        self.layers = None
        self._iau = self._obs = None

    def _timed(self, name, fn, *a, **kw):
        import torch
        if self.layers is None:
            return fn(*a, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        self.layers[name] = self.layers.get(name, 0.0) + 1e3 * (
            time.perf_counter() - t0)
        return out

    def _setup(self):
        """The increments or the analyses on this case's device and dtype,
        once."""
        import torch
        from gfdl_atmos_cubed_sphere_tpu_torch.io import da_increment as da
        from gfdl_atmos_cubed_sphere_tpu_torch.io.external_ic import (
            d_winds_from_latlon)
        from gfdl_atmos_cubed_sphere_tpu_torch.physics import nudging as ng
        dtype = self.state[0].dtype
        if self.nwp == "iau":
            inc = da.read_da_inc(self.data["inc"], self.geom, g=self.g)
            self._iau = da.IAU({k: v.to(dtype) for k, v in inc.items()},
                               da.IAUConfig(window_s=NWP_IAU_WINDOW))
            return
        ps = self.ptop + torch.sum(self.state[0].double(), dim=1)
        targets = []
        for i, ana in enumerate(self.data["analyses"]):
            m = ng.remap_analysis_to_model(
                ana, self.data["ak"], self.data["bk"], ps, self.ak, self.bk,
                device=self.g.device)
            u, v = d_winds_from_latlon(m["ua"], m["va"], self.g)
            targets.append({k: x.to(dtype) for k, x in dict(
                pt=m["t"], sphum=m["sphum"], u=u, v=v,
                ps=ps + i * NWP_ANALYSIS_SHIFT["ps"]).items()})
        self._obs = ng.ObsSchedule([0.0, NWP_ANALYSIS_DT], targets)

    def step(self, state):
        import math
        import torch
        from gfdl_atmos_cubed_sphere_tpu_torch.physics import nudging as ng
        if self._iau is None and self._obs is None:
            self._setup()
        m0 = nwp_mass(self.g, state[0])
        state = super().step(state)
        self.masses.append((m0, nwp_mass(self.g, state[0])))
        d = dict(zip(self.names, state))
        dt = self.cfg.dt
        if self.nwp == "iau":
            d = self._timed("IAU.apply", self._iau.apply, d, self.time, dt)
        else:
            tgt = self._timed("ObsSchedule.target_at", self._obs.target_at,
                              self.time)
            cum = torch.cumsum(d["delp"], 1)
            pe = torch.cat([torch.zeros_like(cum[:, :1]), cum], 1) + self.ptop
            pm = 0.5 * (pe[:, 1:] + pe[:, :-1])
            d.update(self._timed("nwp_nudge", ng.nwp_nudge, dt,
                                 {k: d[k] for k in ("u", "v", "pt", "sphum")},
                                 tgt, pm))
            area = self.g.area[:, 0, H:-H, H:-H]
            d["delp"], _ = self._timed("ps_nudging", ng.ps_nudging, dt,
                                       self.ak, self.bk, tgt["ps"],
                                       d["delp"], area=area)
            storms = torch.tensor([[math.radians(lo), math.radians(la), p]
                                   for lo, la, p in NWP_STORMS],
                                  dtype=d["delp"].dtype)
            d["delp"] = self._timed(
                "breed_slp_inline", ng.breed_slp_inline, dt, d["delp"],
                d["pt"][:, -1], self.g.phis_p[:, 0, H:-H, H:-H], storms,
                self.g, self.ak,
                ng.BreedConfig(**self.data.get("breed", {})))
        self.time += dt
        return [d[k] for k in self.names]


def nwp_cold_start(dirpath, geom, npz, device):
    """get_nggps_ic_files from the file set onto set_eta(npz) on device in
    float64, synchronised: (state dict, wall seconds)."""
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.grid.fv_eta import set_eta
    from gfdl_atmos_cubed_sphere_tpu_torch.io.external_ic import (
        get_nggps_ic_files)
    _, ptop, ak, bk = set_eta(npz)
    t0 = time.perf_counter()
    cold = get_nggps_ic_files(dirpath, geom, ak, bk, ptop, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return cold, time.perf_counter() - t0


def nwp_ic(cold):
    """The big step's initial state (host numpy) from a cold start: the
    fields, phis, and the six tracers (sphum, liq_wat from the files, the
    other four at 1e-6, as phase 6)."""
    import numpy as np
    ic = {k: cold[k].cpu().numpy() for k in ("delp", "pt", "u", "v", "w",
                                              "delz", "phis")}
    q = {nm: np.full(ic["delp"].shape, 1e-6) for nm in TRACERS}
    q.update({nm: cold[nm].cpu().numpy() for nm in ("sphum", "liq_wat")})
    ic["q"] = q
    return ic


def nwp_phase(label, case, state, card, launches6):
    """13b or 13c: 1 warm-up big step and 5 timed ones behind a readback
    barrier with the launch counts set to 0 just before and read just
    after, then 1 under the profiler and 1 with the IAU or nudging calls
    timed on their own. Fails on a non-finite field, a relative change of
    sum(delp*area) over 1e-5 across an fv_dynamics_nh call, or launches
    other than phase 6's. Returns the launches with "s_per_step" and the
    layer ms."""
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.model import tracer_2d
    state = case.step(state)                              # warm-up
    float(torch.sum(state[0]))
    nsteps = 5
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    case.masses.clear()
    reset_counts()
    tracer_2d.reset_nsplt()
    sec, state = timed_steps(case.step, state, nsteps)
    launches = counts()
    nsplt = list(tracer_2d.nsplt_calls)
    peak = torch.cuda.max_memory_allocated()
    for nm, t in zip(case.names, state):
        require(bool(torch.isfinite(t).all()), f"{label}: NaN or inf in {nm}")
    dm = max(abs(float(b) - float(a)) / float(a) for a, b in case.masses)
    for name in NH_PER_STEP:
        require(launches[name] == launches6[name],
                f"{label}: {name} launched {launches[name]} times in "
                f"{nsteps} big steps, phase 6 {launches6[name]}")
    by, busy = device_ms_by_kernel(lambda: case.step(state), reps=1)
    case.layers = {}
    state = case.step(state)
    layers, case.layers = case.layers, None
    ptslev = 6 * (case.cfg.npx - 1) ** 2 * case.cfg.npz / sec
    log(f"phase {label}: {sec:.4f} s/step, {ptslev:.4e} pts*lev/s on {card}; "
        f"largest mass change across an fv_dynamics_nh call {dm:.3e}; "
        f"launches {launches}; tracer_2d nsplt {nsplt}; peak device memory "
        f"{peak / 2 ** 30:.2f} GiB ({base / 2 ** 30:.2f} GiB before the "
        f"steps); device busy {busy} of the wall time, device ms/step "
        f"{sum(by.values()):.3f}; wall ms of one step's calls "
        f"(synchronised): " + ", ".join(f"{k} {v:.2f}"
                                        for k, v in layers.items()))
    require(dm <= 1e-5, f"{label}: the mass changed by {dm:.3e} across an "
                        f"fv_dynamics_nh call")
    launches["s_per_step"] = sec
    launches["layers_ms"] = layers
    return launches, state


def nwp_full_width(geom, card, launches6):
    """Phase 13a-c at C192 on phase 5's geometry: 13a the chgres file set
    (write_nwp_files from the L127 JW state) and the cold start onto
    set_eta(79) on the card in float64 (host seconds to write and to read
    the files, card seconds of the cold start), cast to float32 with phis
    through prepare_phis; 13b the moist c192_nh big step of phase 6 with
    the IAU after each step; 13c the same from 13a's state with the
    nudging after each step. Returns the launches of 13b's and 13c's 5
    big steps."""
    import gc
    import shutil
    import numpy as np
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.grid.fv_eta import set_eta
    from gfdl_atmos_cubed_sphere_tpu_torch.io.external_ic import (
        read_nggps_tiles)
    from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import (
        build_grid_ops)
    gc.collect()
    torch.cuda.empty_cache()
    try:
        t0 = time.perf_counter()
        src = nwp_source(geom)
        t_src = time.perf_counter() - t0
        g = build_grid_ops(193, dtype=torch.float32, device="cuda",
                           geom=geom)
        t_surf, t_write = write_nwp_files(NWP_DIR, geom, g, src)
        t0 = time.perf_counter()
        read_nggps_tiles(NWP_DIR)
        t_read = time.perf_counter() - t0
        cold, t_cold = nwp_cold_start(NWP_DIR, geom, 79, "cuda")
        for k, v in cold.items():
            require(bool(torch.isfinite(v).all()),
                    f"13a cold start: NaN or inf in {k}")
        _, ptop, ak, bk = set_eta(79)
        ps = float((ptop + cold["delp"].sum(1)).mean())
        log(f"phase 13a C192 chgres file set: the L127 JW state on the host "
            f"{t_src:.1f} s, surfdrv over the {NWP_DEM_DEG} degree DEM "
            f"{t_surf:.1f} s, writing the 13 files {t_write:.1f} s; "
            f"read_nggps_tiles {t_read:.1f} s (host); the cold start onto "
            f"L79 (get_nggps_ic_files in float64 on the card, the read "
            f"included) {t_cold:.2f} s wall, {t_cold - t_read:.2f} s "
            f"beside the read; mean ps {ps:.1f} Pa on {card}")
        ic = nwp_ic(cold)
        del cold, g
        shutil.rmtree(NWP_DIR, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
        out = {}
        state = None
        for mode, data in (
                ("iau", dict(inc=nwp_increments(79))),
                ("nudged", dict(analyses=nwp_analyses(src), ak=src["ak"],
                                bk=src["bk"]))):
            case = NWPStep(193, 79, 450.0, 2, 6, torch.float32, "cuda",
                           geom=geom, ic=ic, moist=True, nwp=mode,
                           nwp_data=data)
            t0 = time.perf_counter()
            case._setup()
            torch.cuda.synchronize()
            t_setup = time.perf_counter() - t0
            label = "13b nwp_iau" if mode == "iau" else "13c nwp_nudged"
            what = ("read_da_inc: the increments to the cube and the D grid"
                    if mode == "iau" else "remap_analysis_to_model: the two "
                    "analyses onto L79, their winds onto the D grid")
            log(f"phase {label}: {what}, {t_setup:.2f} s on the card")
            out[mode], state = nwp_phase(f"{label} C192L79 f32", case,
                                         case.state, card, launches6)
            del case, state
            gc.collect()
            torch.cuda.empty_cache()
        return out["iau"], out["nudged"]
    finally:
        shutil.rmtree(NWP_DIR, ignore_errors=True)


def write_climatology(path, seed=15):
    """A CAM-style climatology file (P0, hyai, hybi, PHIS, PS, T, Q, U, V
    on a 24 x 13 lat-lon grid, three times a day apart), as
    tests/test_external_nudge.py writes one, with seeded noise."""
    import numpy as np
    from scipy.io import netcdf_file
    rng = np.random.default_rng(seed)
    nlon, nlat, nlev, ntime = 24, 13, 12, 3
    lat = np.linspace(-88.0, 88.0, nlat)
    shp = (ntime, nlev, nlat, nlon)
    with netcdf_file(path, "w") as f:
        for nm, size in (("lon", nlon), ("lat", nlat), ("lev", nlev),
                         ("levp", nlev + 1), ("time", ntime), ("scalar", 1)):
            f.createDimension(nm, size)
        for nm, dims, a in (
                ("lon", ("lon",), np.linspace(0.0, 345.0, nlon)),
                ("lat", ("lat",), lat),
                ("time", ("time",), np.array([0.0, 86400.0, 172800.0])),
                ("hyai", ("levp",), np.linspace(0.003, 0.0, nlev + 1)),
                ("hybi", ("levp",), np.linspace(0.0, 1.0, nlev + 1) ** 1.4),
                ("P0", ("scalar",), np.array([1.0e5])),
                ("PHIS", ("lat", "lon"), 300.0 * rng.uniform(size=(nlat,
                                                                   nlon))),
                ("PS", ("time", "lat", "lon"),
                 1.0e5 + 300.0 * rng.standard_normal((ntime, nlat, nlon))),
                ("T", ("time", "lev", "lat", "lon"),
                 260.0 + 30.0 * np.cos(np.deg2rad(lat))[None, None, :, None]
                 + rng.uniform(-1.0, 1.0, shp)),
                ("Q", ("time", "lev", "lat", "lon"),
                 4.0e-3 * (1.0 + 0.1 * rng.uniform(-1.0, 1.0, shp))),
                ("U", ("time", "lev", "lat", "lon"),
                 rng.uniform(-10.0, 10.0, shp)),
                ("V", ("time", "lev", "lat", "lon"),
                 rng.uniform(-10.0, 10.0, shp))):
            f.createVariable(nm, "d", dims)[:] = a


def cold_start_control(dirpath, geom, npz):
    """The cold start's float32 control: get_nggps_ic_files' host steps,
    then get_hrrr_ic (the same remaps) on the card with every array in
    float32, and phis (float32 as read)."""
    import numpy as np
    from gfdl_atmos_cubed_sphere_tpu_torch import constants as con
    from gfdl_atmos_cubed_sphere_tpu_torch.grid.fv_eta import set_eta
    from gfdl_atmos_cubed_sphere_tpu_torch.io import external_ic as eic
    _, ptop, ak, bk = set_eta(npz)
    data = eic.read_nggps_tiles(dirpath)
    zh = np.asarray(data["zh"], np.float64)
    ps_src = np.asarray(data["ps"], np.float64)
    phis = np.asarray(data["phis"], np.float64)
    data["ps"] = eic.adjust_ps_to_terrain(phis, zh, ps_src, data["ak_src"],
                                          data["bk_src"])
    pn0 = np.log(data["ak_src"].reshape(1, -1, 1, 1)
                 + data["bk_src"].reshape(1, -1, 1, 1) * ps_src[:, None])
    data["t"] = (con.GRAV * (zh[:, :-1] - zh[:, 1:])
                 / (con.RDGAS * (pn0[:, 1:] - pn0[:, :-1])))
    data["ud"], data["vd"] = eic.dgrid_winds_from_faces(
        data["u_s"], data["v_s"], data["u_w"], data["v_w"], geom)
    f32 = {k: np.asarray(v, np.float32) for k, v in data.items()}
    out = eic.get_hrrr_ic(f32, ak.astype(np.float32), bk.astype(np.float32),
                          ptop, device="cuda")
    out["phis"] = eic._on(data["phis"], "cuda")[:, None]
    return out


def nwp_card_vs_cpu(geom):
    """Phase 13d at C24L10 in float64, card against CPU, each output
    against its own maximum (1e-10, NH w 5e-9), a float32 control over
    each limit: the cold start from a C24 file set built as 13a's; one
    IAU step and one nudged step of the moist big step (phase 3's C24L10
    step, k_split 1, n_split 2, dt 900 s) from it; ClimateNudgeDriver
    .tendencies from a climate-nudge file; do_w_forcing of both types,
    age_of_air, AeroClimatology.to_model, ExternalSST.to_cube (float32
    weights in the control: the field is float32 whatever its type);
    fv3_zs_filter with the zero-ocean limiter; breed_slp_inline and the
    global mass after it."""
    import math
    import shutil
    import numpy as np
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.grid.fv_eta import set_eta
    from gfdl_atmos_cubed_sphere_tpu_torch.io import climate_nudge_data as cn
    from gfdl_atmos_cubed_sphere_tpu_torch.io.external_ic import (
        latlon_bilinear_weights)
    from gfdl_atmos_cubed_sphere_tpu_torch.model.grid_ops import (
        build_grid_ops)
    from gfdl_atmos_cubed_sphere_tpu_torch.physics import (
        forcing_externals as fe)
    from gfdl_atmos_cubed_sphere_tpu_torch.physics import nudging as ng
    from gfdl_atmos_cubed_sphere_tpu_torch.utils import terrain
    t_start = time.perf_counter()
    packs = {dev: build_grid_ops(25, dtype=torch.float64, device=dev,
                                 geom=geom) for dev in ("cpu", "cuda")}
    dirpath = NWP_DIR + "_c24"
    try:
        src = nwp_source(geom)
        write_nwp_files(dirpath, geom, packs["cpu"], src)
        card, _ = nwp_cold_start(dirpath, geom, 10, "cuda")
        cpu, _ = nwp_cold_start(dirpath, geom, 10, "cpu")
        ctl = cold_start_control(dirpath, geom, 10)
        require(sorted(card) == sorted(cpu) == sorted(ctl),
                f"13d cold start: outputs {sorted(card)}, {sorted(cpu)}, "
                f"{sorted(ctl)}")
        worst, bad = {}, []
        for nm, b in cpu.items():
            a, f = card[nm].cpu(), ctl[nm].cpu().double()
            require(bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
                    f"13d cold start: NaN or inf in {nm}")
            top = float(b.abs().max())
            r = float((a - b).abs().max()) / top
            c = float((f - b).abs().max()) / top
            worst[nm] = (r, c)
            if nm == "phis":
                # the file's float32 orog_filt times g, in float32 on both
                # sides: read, not computed, so no control can differ
                require(r == 0.0, f"13d cold start: phis differs by {r:.3e}")
                continue
            tol = NWP_TOL.get(nm, 1e-10)
            if not r <= tol:
                bad.append(nm)
            require(c > tol, f"13d cold start: the float32 control reads "
                             f"{nm} within {tol:g}")
        log("  13d cold start C24 L127 -> L10 f64: card vs CPU, x each "
            "field's max (the float32 control in brackets): " + ", ".join(
                f"{nm} {r:.2e} ({c:.1e})" for nm, (r, c) in worst.items()))
        require(not bad, f"13d cold start: the card disagrees with the CPU "
                         f"in {bad}")
        ic = nwp_ic(cpu)
        for mode, data in (
                ("iau", dict(inc=nwp_increments(10))),
                ("nudged", dict(analyses=nwp_analyses(src), ak=src["ak"],
                                bk=src["bk"], breed=NWP_BREED_C24))):
            case = NWPStep(25, 10, 900.0, 1, 2, torch.float64, "cuda",
                           geom=geom, ic=ic, moist=True, nwp=mode,
                           nwp_data=data, bundle=f"nwp_{mode}")
            card_vs_cpu(case, steps=1, phase=f"13d {mode}", tols=NWP_TOL)
    finally:
        shutil.rmtree(dirpath, ignore_errors=True)

    # the climate-nudge file pipeline
    _, ptop, ak, bk = set_eta(10)
    os_path = NWP_DIR + "_clim.nc"
    import os
    os.makedirs(os.path.dirname(os_path), exist_ok=True)
    write_climatology(os_path)
    drv = cn.ClimateNudgeDriver(
        os_path, geom, ak, bk, ic["phis"],
        cfg=cn.ClimateNudgeConfig(t_tau=21600.0, q_tau=21600.0,
                                  u_tau=21600.0, v_tau=43200.0, skip_bot_t=3))
    os.remove(os_path)
    rng = np.random.default_rng(16)
    tgt = drv.target_at(50000.0)
    st = {k: torch.as_tensor(tgt[k] + rng.uniform(-1, 1, tgt[k].shape) * s)
          for k, s in (("t", 5.0), ("q", 1e-4), ("u", 3.0), ("v", 3.0))}
    hold_card_vs_cpu("13d ClimateNudgeDriver.tendencies", lambda t, q, u, v,
                     device: (drv.tendencies(50000.0, t, q, state_u=u,
                                             state_v=v),),
                     st, ("tend",))

    # the external forcings
    w = 0.1 * rng.standard_normal((1, 12, 16, 16))
    delz = -500.0 * (1.0 + 0.1 * rng.uniform(-1, 1, w.shape))
    phis = 50.0 * rng.uniform(size=(1, 16, 16))

    def w_forcing(w, delz, phis, device):
        return tuple(fe.do_w_forcing(w, delz, phis, fe.WForcingConfig(**c),
                                     dt, 0.0)
                     for c, dt in ((dict(w_forcing_type=1, i0=8, j0=8,
                                         L=4.0e3, R=4.0e3), 10.0),
                                   (dict(w_forcing_type=101, divg=1.0e-5,
                                         tau=100.0), 1.0e3)))

    hold_card_vs_cpu("13d do_w_forcing types 1 and 101", w_forcing,
                     dict(w=torch.as_tensor(w), delz=torch.as_tensor(delz),
                          phis=torch.as_tensor(phis)), ("type1", "type101"))
    delp = torch.as_tensor(ic["delp"])
    pe_top = ptop + torch.cumsum(delp, 1) - delp
    hold_card_vs_cpu("13d age_of_air", lambda q, pe, device: (
        fe.age_of_air(q, pe, 86400.0),),
        dict(q=torch.as_tensor(7.0 + rng.uniform(size=ic["delp"].shape)),
             pe=pe_top), ("q_age",))
    kc = 8
    p_edge_c = np.linspace(1000.0, 101000.0, kc + 1)
    aero = fe.AeroClimatology(
        np.linspace(0, 2 * np.pi, 36, endpoint=False),
        np.linspace(-np.pi / 2, np.pi / 2, 19), p_edge_c,
        {"so4": 1e-6 * rng.uniform(size=(12, kc, 19, 36)),
         "dust": 1e-7 * rng.uniform(size=(12, kc, 19, 36))})
    hold_card_vs_cpu("13d AeroClimatology.to_model", lambda delp, device: (
        aero.to_model(geom, delp, ptop, 3.4),), dict(delp=delp), ("aero",))
    lats = np.linspace(-np.pi / 2, np.pi / 2, 31)
    lons = np.linspace(0, 2 * np.pi, 60, endpoint=False)

    def sst_to_cube(sst, device):
        obj = fe.ExternalSST(lons, lats, sst.cpu().numpy())
        if sst.dtype == torch.float32:
            # the control: the weights in float32 as well
            w = latlon_bilinear_weights(lons, lats, geom.interior("aglon"),
                                        geom.interior("aglat"))
            obj._wt = dict(w, wx=w["wx"].astype(np.float32),
                           wy=w["wy"].astype(np.float32))
        return (obj.to_cube(geom, device=device),)

    hold_card_vs_cpu("13d ExternalSST.to_cube", sst_to_cube, dict(
        sst=torch.as_tensor(300.0 - 30.0 * np.sin(lats)[:, None] ** 2
                            + rng.uniform(-1, 1, (31, 60)))), ("sst",))
    oro = (ic["phis"][:, 0] > 0.0).astype(np.float64)
    # the float32 control filters on a float32 pack
    packs["f32"] = build_grid_ops(25, dtype=torch.float32, device="cuda",
                                  geom=geom)
    hold_card_vs_cpu("13d fv3_zs_filter with the zero-ocean limiter",
                     lambda phis, oro, device: (terrain.fv3_zs_filter(
                         phis, packs["f32" if phis.dtype == torch.float32
                                     else device], oro=oro),),
                     dict(phis=torch.as_tensor(ic["phis"] * oro[:, None]),
                          oro=torch.as_tensor(oro)), ("phis",))
    storms = torch.tensor([[math.radians(lo), math.radians(la), p]
                           for lo, la, p in NWP_STORMS], dtype=torch.float64)
    area = torch.as_tensor(geom.interior("area"))

    def breed(delp, pt_bot, phis, device):
        d = ng.breed_slp_inline(900.0, delp, pt_bot, phis, storms,
                                packs[device], ak,
                                ng.BreedConfig(**NWP_BREED_C24))
        return d, torch.sum(d.sum(1) * area.to(d))[None]

    hold_card_vs_cpu("13d breed_slp_inline", breed, dict(
        delp=delp, pt_bot=torch.as_tensor(ic["pt"][:, -1]),
        phis=torch.as_tensor(ic["phis"][:, 0])), ("delp", "mass"))
    log(f"phase 13d: {time.perf_counter() - t_start:.1f} s")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from gfdl_atmos_cubed_sphere_tpu_torch.model import tracer_2d
        from gfdl_atmos_cubed_sphere_tpu_torch.model.sw_dynamics import (
            SWConfig, make_sw_step)
        from gfdl_atmos_cubed_sphere_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port package is not importable ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build(force=True)
    log(f"phase 1 build: nvcc {time.perf_counter() - t0:.1f} s for "
        f"{len(secs)} kernels (" + ", ".join(f"{k} {v:.1f} s" for k, v in
                                             secs.items()) + ")")

    # ---- main-path inputs ---------------------------------------------------
    npx = 769
    g, geom, state, t_metrics = sw_setup(npx, torch.float32, "cuda")
    log(f"sw_c768 grid: host metric precompute {t_metrics:.1f} s")
    cfg = SWConfig(npx=npx, dt=C768_DT, n_split=1)
    sw_step = make_sw_step(g, cfg)

    def step(st):
        return sw_step(*st, None, None)

    mass0 = mass(g, state[0])
    with Capture() as cap768:
        state = list(step(state))
        float(torch.sum(state[0]))
    g48, geom48, st48, _ = sw_setup(49, torch.float64, "cuda")
    with Capture() as cap48:
        make_sw_step(g48, SWConfig(npx=49, dt=1800.0, n_split=2))(
            *st48, None, None)

    nh = BigStep(193, 79, 450.0, 2, 6, torch.float32, "cuda")
    log(f"c192_nh grid + baroclinic state: host precompute "
        f"{nh.t_setup:.1f} s")
    nh_mass0 = mass(nh.g, nh.state[0])
    with Capture() as cap192:
        nh_state = nh.step(nh.state)
        float(torch.sum(nh_state[0]))
    nh24 = BigStep(25, 10, 900.0, 1, 2, torch.float64, "cuda")
    with Capture() as cap24:
        nh24.step(nh24.state)
    nhm = BigStep(193, 79, 450.0, 2, 6, torch.float32, "cuda", geom=nh.geom,
                  moist=True)
    log(f"c192_nh moist baroclinic state: host set-up {nhm.t_setup:.1f} s")
    # phase 9's facade resumes from a checkpoint of this initial state
    moist_ic = (nhm.ic, nhm.ak, nhm.bk)
    nhm_mass0 = mass(nhm.g, nhm.state[0])
    tracer_2d.reset_nsplt()
    with Capture() as cap192m:
        nhm_state = nhm.step(nhm.state)
        float(torch.sum(nhm_state[0]))
    nsplt192 = list(tracer_2d.nsplt_calls)
    nh24m = BigStep(25, 10, 900.0, 1, 2, torch.float64, "cuda",
                    geom=nh24.geom, moist=True)
    with Capture() as cap24m:
        nh24m.step(nh24m.state)
    # c192_hydro (bench.py:34-35): the moist state and geometry of phase 6
    hy = BigStep(193, 79, 450.0, 1, 6, torch.float32, "cuda", geom=nh.geom,
                 ic=nhm.ic, moist=True, hydro=True)
    hy_mass0 = mass(hy.g, hy.state[0])
    tracer_2d.reset_nsplt()
    with Capture() as cap192h:
        hy_state = hy.step(hy.state)
        float(torch.sum(hy_state[0]))
    nsplt192h = list(tracer_2d.nsplt_calls)
    hy24 = BigStep(25, 10, 900.0, 1, 2, torch.float64, "cuda",
                   geom=nh24.geom, ic=nh24m.ic, moist=True, hydro=True)
    with Capture() as cap24h:
        hy24.step(hy24.state)
    torch.cuda.synchronize()

    # ---- 2. kernels against their plain versions ----------------------------
    log("phase 2 kernels vs plain versions")
    resources = kernel_resources()
    shapes_sw = check_kernels(cap768, SW_KERNELS, npx - 1, 1e-4,
                              "sw_c768 f32", measure=True, sw=True)
    check_kernels(cap48, SW_KERNELS, 48, 1e-12, "C48 f64", measure=False,
                  sw=True)
    check_other_hords(cap768, npx - 1, 1e-4, "sw_c768 f32")
    check_other_hords(cap48, 48, 1e-12, "C48 f64")
    check_ke_levels(cap768, npx - 1, "sw_c768 f32")
    check_ke_levels(cap48, 48, "C48 f64")
    del cap768, cap48
    shapes_nh = check_kernels(cap192, NH_KERNELS, 192, 1e-4, "c192_nh f32",
                              measure=True)
    check_kernels(cap24, NH_KERNELS, 24, 1e-12, "C24L10 f64", measure=False)
    sim1_offc = check_sim1_offcentred(cap192, cap24)
    captured_calls("c192_nh", cap192, NH_PER_STEP, [])
    del cap192, cap24
    moist = check_kernels(
        cap192m, NH_KERNELS, 192, 1e-4, "c192_nh moist f32",
        measure=lambda name, shp: name == "tp2d_sweep" and len(shp) == 5)
    check_kernels(cap24m, NH_KERNELS, 24, 1e-12, "C24L10 moist f64",
                  measure=False)
    shapes_nh["tp2d_sweep"] += [r for r in moist["tp2d_sweep"]
                                if len(r["shape"]) == 5]
    captured_calls("c192_nh moist", cap192m, NH_PER_STEP, nsplt192)
    del cap192m, cap24m
    shapes_hy = check_kernels(cap192h, HYDRO_KERNELS, 192, 1e-4,
                              "c192_hydro f32", measure=True)
    check_kernels(cap24h, HYDRO_KERNELS, 24, 1e-12, "C24L10 hydro f64",
                  measure=False)
    col_depths = check_column_depths(cap192h)
    # fv_tp_2d_kernel, which no path calls, on the hydro step's d_sw pt
    # transport operands
    shapes_hy["fv_tp_2d"] = [check_call(
        "c192_hydro f32", "fv_tp_2d", *fv_tp_2d_operands(cap192h), 0, 192,
        1e-4, measure=True)]
    check_call("C24L10 hydro f64", "fv_tp_2d", *fv_tp_2d_operands(cap24h), 0,
               24, 1e-12, measure=False)
    captured_calls("c192_hydro moist", cap192h, HYDRO_PER_STEP, nsplt192h)
    del cap192h, cap24h
    recs_sw = {k: per_launch(v) for k, v in shapes_sw.items()}
    recs_nh = {k: per_launch(v) for k, v in shapes_nh.items()}
    recs_hy = {k: per_launch(v) for k, v in shapes_hy.items()}

    # ---- 3. card with kernels vs CPU with plain versions --------------------
    cfg48 = SWConfig(npx=49, dt=1800.0, n_split=2)
    gcpu, _, stcpu, _ = sw_setup(49, torch.float64, "cpu", geom=geom48)
    scard, sc = list(st48), list(stcpu)
    fcard, fcpu = make_sw_step(g48, cfg48), make_sw_step(gcpu, cfg48)
    worst = 0.0
    for _ in range(4):
        scard = list(fcard(*scard, None, None))
        sc = list(fcpu(*sc, None, None))
    for nm, a, b in zip(("delp", "u", "v"), scard, sc):
        r = float((a.cpu() - b).abs().max() / b.abs().max())
        worst = max(worst, r)
        log(f"  C48 f64 4 steps {nm}: card vs CPU {r:.3e} x field max")
    log(f"phase 3 SW step card vs CPU: worst {worst:.3e} (tol 1e-10)")
    require(worst <= 1e-10, "SW step on the card disagrees with the CPU")
    del g48, gcpu

    for case in (nh24, nh24m, hy24):
        card_vs_cpu(case)
    geom24 = nh24.geom
    del nh24, nh24m, hy24

    # ---- 10a. the options and solvers, card vs CPU -------------------------
    t0 = time.perf_counter()
    options_card_vs_cpu(geom24)
    log(f"phase 10a: {time.perf_counter() - t0:.1f} s")

    # ---- 11c. the SHiELD namelist at C24L10, card vs CPU --------------------
    t0 = time.perf_counter()
    checked_c24 = shield_card_vs_cpu(geom24)
    log(f"phase 11c: {time.perf_counter() - t0:.1f} s")

    # ---- 12c. the inline fast physics and the MP options, card vs CPU ------
    fast_phys_card_vs_cpu(geom24)

    # ---- 13d. the NWP initialisation and forcing, card vs CPU --------------
    nwp_card_vs_cpu(geom24)

    # ---- 4. full width sw_c768 ----------------------------------------------
    state = list(step(state))                            # warm-up
    float(torch.sum(state[0]))
    nsteps = 5
    reset_counts()
    sec, state = timed_steps(step, state, nsteps)
    sw_launches = counts()
    for nm, t in zip(("delp", "u", "v"), state):
        require(bool(torch.isfinite(t).all()), f"sw_c768: NaN or inf in {nm}")
    dm = abs(mass(g, state[0]) - mass0) / abs(mass0)
    pts = 6 * (npx - 1) ** 2 / sec
    log(f"phase 4 sw_c768 f32: {sec:.4f} s/step, {pts:.4e} pts/s on {card}; "
        f"mass change {dm:.3e}; launches {sw_launches}")
    require(dm <= 1e-5, f"sw_c768 mass drifted by {dm:.3e}")
    for name in SW_KERNELS:
        want = SW_PER_STEP[name] * nsteps * cfg.n_split
        require(sw_launches[name] == want,
                f"{name} launched {sw_launches[name]} times on the SW path "
                f"in {nsteps} steps, expected {want}")
    by, busy = device_ms_by_kernel(lambda: step(state), reps=2)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:6]
    log(f"  profile of 2 steps: device busy {busy} of the wall time; device "
        f"ms/step {sum(by.values()):.3f}; top: " + "; ".join(
            f"{k[:60]} {v:.3f}" for k, v in top))
    del g, state, sw_step

    # ---- 5. full width c192_nh (dry) ----------------------------------------
    nh_launches = step_phase("5 c192_nh dry f32", nh, nh_state, nh_mass0,
                             card, shapes_nh, NH_PER_STEP, NH_KERNELS)
    geom192 = nh.geom
    del nh, nh_state

    # ---- 6. full width c192_nh moist (the headline step) --------------------
    m_launches = step_phase("6 c192_nh moist f32", nhm, nhm_state, nhm_mass0,
                            card, shapes_nh, NH_PER_STEP, NH_KERNELS)
    del nhm, nhm_state

    # ---- 12a. the headline step with the inline fast physics ---------------
    t0 = time.perf_counter()
    fp_launches = fast_phys_full_width(geom192, moist_ic[0], card, shapes_nh,
                                       m_launches)
    log(f"phase 12a: {time.perf_counter() - t0:.1f} s")

    # ---- 7. full width c192_hydro moist --------------------------------------
    h_launches = step_phase("7 c192_hydro moist f32", hy, hy_state, hy_mass0,
                            card, shapes_hy, HYDRO_PER_STEP, HYDRO_KERNELS)
    del hy, hy_state

    # ---- 11a, 11b. the SHiELD namelist's dynamics at C192L91 ---------------
    t0 = time.perf_counter()
    shapes_sh, sh_launches, fac_launches, checked = shield_subprocess()
    recs_sh = {k: per_launch(v) for k, v in shapes_sh.items()}
    log(f"phase 11a, 11b: {time.perf_counter() - t0:.1f} s")

    # ---- 8. the solo driver ------------------------------------------------
    solo_card_vs_cpu(geom24)
    solo_hy_launches, solo_nh_launches = solo_full_width(geom192, card)
    solo_cli(card)

    # ---- 9. the SHiELD and GFDL facades --------------------------------------
    facade_card_vs_cpu(geom24)
    shield_launches = facade_full_width(geom192, *moist_ic, card,
                                        solo_nh_launches)

    # ---- 10b. the options and solvers at full width -------------------------
    t0 = time.perf_counter()
    offc_launches, opts_launches = options_full_width(
        geom192, *moist_ic, card, shapes_nh, shapes_hy, m_launches,
        h_launches)
    log(f"phase 10b: {time.perf_counter() - t0:.1f} s")
    del moist_ic

    # ---- 13a-c. the cold start, the IAU and the nudged forecast at C192 ----
    t0 = time.perf_counter()
    iau_launches, nudged_launches = nwp_full_width(geom192, card, m_launches)
    log(f"phase 13a-c: {time.perf_counter() - t0:.1f} s")


    kernels = []
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "kernel_ms")
    paths = (("c192_nh moist", NH_KERNELS, recs_nh, shapes_nh, m_launches),
             ("c192_hydro moist", HYDRO_KERNELS + ("fv_tp_2d",), recs_hy,
              shapes_hy, h_launches),
             ("sw_c768", SW_KERNELS, recs_sw, shapes_sw, sw_launches))
    for name in REPLACES:
        path, _, recs, shapes, launches = next(
            p for p in paths if name in p[1])
        rec = recs[name]
        entry = {
            "name": name, "route": "cuda",
            "source": "gfdl_atmos_cubed_sphere_tpu_torch/csrc/"
                      f"{SOURCE.get(name, name)}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None,
            "kernel_ms": rec["kernel_ms"], "path": path,
            "shapes": shapes[name]}
        if name in resources:
            entry["resources"] = resources[name]
        if name in COLUMN_KERNELS:
            entry["depths"] = [r for r in col_depths if r["kernel"] == name]
        if path == "c192_nh moist":
            entry["c192_nh_dry"] = {"launches": nh_launches[name]}
        # launches in phase 12a's 5 big steps with the inline fast physics
        entry["c192_nh_fastphys"] = {"launches": fp_launches[name]}
        # launches per big step of the solo driver at C192L79 (phase 8b)
        entry["solo_hydro"] = {"launches": solo_hy_launches[name]}
        entry["solo_nh"] = {"launches": solo_nh_launches[name]}
        # launches per atmosphere_dynamics step of the SHiELD facade at
        # C192L79 (phase 9b)
        entry["shield"] = {"launches": shield_launches[name]}
        # launches in phase 10b's 5 big steps with the option bundles
        entry["c192_nh_offc"] = {"launches": offc_launches[name]}
        entry["c192_hydro_opts"] = {"launches": opts_launches[name]}
        # phase 11a's 5 big steps at the SHiELD namelist's arguments (with
        # the kernel alone per call shape), 11b's per facade step
        entry["shield_c192l91"] = {"launches": sh_launches[name]}
        if name in recs_sh:
            entry["shield_c192l91"].update(
                {k: recs_sh[name][k] for k in keys},
                shapes=shapes_sh[name])
        entry["shield_facade"] = {"launches": fac_launches[name]}
        # launches in phase 13b's and 13c's 5 big steps (the IAU, the
        # nudging after each)
        entry["nwp_iau"] = {"launches": iau_launches[name]}
        entry["nwp_nudged"] = {"launches": nudged_launches[name]}
        if name in checked["argument_costs"]:
            entry["shield_c192l91"]["argument_costs"] = checked[
                "argument_costs"][name]
        if name in checked:
            entry["checked_at"] = dict(
                checked[name], c24_max_abs_err=checked_c24[
                    "max_abs_err"].get(name),
                c192_max_abs_err=checked["max_abs_err"].get(name))
        if name == "ke_section":
            from gfdl_atmos_cubed_sphere_tpu_torch.ops import ke
            entry["checked_at"] = dict(hords=list(ke.KERNEL_HORDS),
                                       on="the SW inputs, C768 f32 and "
                                          "C48 f64")
        if name == "sim1":
            entry["c192_nh_offc"].update(
                launches_alpha_1=offc_launches["sim1"]
                - offc_launches["sim1_offcentred"],
                launches_alpha_0_75=offc_launches["sim1_offcentred"])
            entry["offcentred"] = sim1_offc
        for other, _, orecs, oshapes, olaunches in paths:
            if other != path and name in orecs:
                entry[other.split()[0]] = {
                    "launches": olaunches[name],
                    **{k: orecs[name][k] for k in keys},
                    "shapes": oshapes[name]}
        kernels.append(entry)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def shield_subprocess():
    """Phases 11a and 11b in a process of their own (this script with
    PHASE_11_ARG), which builds its own C192 geometry: in this process,
    after phases 2-7, the profiler returned empty readings of the kernels
    alone at C192L91 in three runs of three, where a process that
    profiles first in 11a reads them whole. Its lines pass through; its
    last line holds shield_full_width's results."""
    import gc
    import os
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             PHASE_11_ARG], stdout=subprocess.PIPE,
                            text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    last = None
    for line in proc.stdout:
        if last is not None:
            log(last)
        last = line.rstrip("\n")
    rc = proc.wait()
    require(rc == 0 and last is not None,
            f"phases 11a and 11b failed (exit code {rc})")
    out = json.loads(last)
    return (out["shapes"], out["launches"], out["facade_launches"],
            out["checked"])


def phase_11_main():
    """The process of shield_subprocess: phases 11a and 11b on the kernels
    the parent built, their results as the last line."""
    import torch
    from gfdl_atmos_cubed_sphere_tpu_torch.grid.metrics import (
        build_grid_geometry)
    require(torch.cuda.is_available(), "phase 11: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    geom = build_grid_geometry(193, ng=H)
    log(f"phase 11a: C192 grid geometry, host {time.perf_counter() - t0:.1f}"
        f" s")
    shapes, launches, fac, checked = shield_full_width(geom, card_line())
    print(json.dumps({"shapes": shapes, "launches": launches,
                      "facade_launches": fac, "checked": checked}),
          flush=True)
    return 0


#: the argument that runs phase_11_main
PHASE_11_ARG = "--phase-11"

if __name__ == "__main__":
    if sys.argv[1:] == [PHASE_11_ARG]:
        sys.exit(phase_11_main())
    sys.exit(main())
