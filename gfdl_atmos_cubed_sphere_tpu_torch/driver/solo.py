"""Solo driver: the atmosphere_init / atmosphere / atmosphere_end facade,
PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/driver/solo.py (FV3
driver/solo/atmosphere.F90: the public API :64-65, atmosphere_init:97,
atmosphere:395, and the Held-Suarez option of driver/solo/fv_phys.F90:186):
grid build, idealized initial state (the Jablonowski-Williamson baroclinic
wave) or a restart, the big step with optional Held-Suarez or simple
physics, state audits, checkpoint write and resume, and a CLI. The step
runs eagerly on the chosen device: the CUDA card unless the caller asks
for the CPU.

Usage:
  python -m gfdl_atmos_cubed_sphere_tpu_torch.driver.solo --npx 49 \\
      --npz 32 --dt 1200 --physics hs --audit-every 72 --restart-out hs.fvio
  (add --device cpu on a machine without a card)
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import constants as con


class Atmosphere:
    """Lifecycle object (the fv_atmos_type and the solo atmosphere_* API).

    physics: "none", "hs" (Held-Suarez) or "sim" (gray radiation and PBL);
    dtype: "f32" or "f64"; cfg_overrides: DynConfig fields; restart: a
    checkpoint path to resume from; device: where the state lives and the
    step runs; geom: a prebuilt GridGeometry for npx (several runs on one
    grid share it)."""

    def __init__(self, npx, npz, dt, case="jw", physics="none",
                 hydrostatic=True, dtype="f32", cfg_overrides=None,
                 restart=None, device="cuda", geom=None):
        from ..grid.fv_eta import set_eta
        from ..init.baroclinic import jw_baroclinic
        from ..io import restart as rst
        from ..model.dyn_core import DynConfig
        from ..model.grid_ops import build_grid_ops, resolve_device
        from ..model.sw_dynamics import prepare_phis
        from ..utils.timing import Timers

        self.device = resolve_device(device)
        self.dtype = torch.float32 if dtype == "f32" else torch.float64
        self.timers = Timers(device=self.device)
        with self.timers("INIT"):
            self.g = build_grid_ops(npx, dtype=self.dtype,
                                    device=self.device, geom=geom)
            _, ptop, ak, bk = set_eta(npz)
            self.ptop = ptop
            self.ak = np.asarray(ak)
            self.bk = np.asarray(bk)
            self.dp0 = np.diff(self.ak) + np.diff(self.bk) * 1.0e5
            over = dict(cfg_overrides or {})
            over.setdefault("hydrostatic", hydrostatic)
            self.cfg = DynConfig(npx=npx, npz=npz, dt=dt, **over)
            self.physics = physics
            self.case = case
            self.time_seconds = 0.0
            self.step_count = 0

            if restart:
                state, tracers, manifest = rst.load_state(restart)
                # the file's ak, bk are the coordinate, not state
                self.state = {k: self._tensor(v) for k, v in state.items()
                              if k not in ("ak", "bk")}
                self.tracers = {k: self._tensor(v)
                                for k, v in tracers.items()} or None
                self.time_seconds = manifest.get("time_seconds", 0.0)
                self.step_count = manifest.get("step", 0)
                prepare_phis(self.g, self.state["phis"])
            else:
                ic = jw_baroclinic(self.g.geom, npz, ak, bk, ptop,
                                   perturb=(case == "jw"))
                prepare_phis(self.g, ic["phis"])
                self.state = {k: self._tensor(ic[k])
                              for k in ("delp", "pt", "u", "v", "w", "delz",
                                        "phis")}
                self.tracers = None
            # the sponge's reference winds: the state at (re)start
            self.u0 = self.state["u"]
            self.v0 = self.state["v"]
            self._step = self._build_step()

    def _tensor(self, a):
        return torch.as_tensor(np.array(a), dtype=self.dtype,
                               device=self.device)

    def _build_step(self, cfg=None, physics=None):
        """The big step state -> state (with the sponge's u0, v0) for cfg
        and physics (the object's own by default)."""
        from ..model.fv_dynamics import fv_dynamics_hydro, fv_dynamics_nh
        from ..physics import held_suarez

        cfg = cfg if cfg is not None else self.cfg
        physics = physics if physics is not None else self.physics
        g, ptop, ak, bk, dp0 = self.g, self.ptop, self.ak, self.bk, self.dp0

        def step(state, u0, v0):
            if cfg.no_dycore:
                # physics-only mode (fv_arrays.F90 no_dycore): the state
                # passes through to the physics unchanged
                new = dict(state)
            elif cfg.hydrostatic:
                r = fv_dynamics_hydro(state["delp"], state["pt"], state["u"],
                                      state["v"], None, g, cfg, ak, bk,
                                      ptop, u0=u0, v0=v0)
                new = dict(state, delp=r.delp, pt=r.pt, u=r.u, v=r.v)
            else:
                r = fv_dynamics_nh(state["delp"], state["pt"], state["u"],
                                   state["v"], state["w"], state["delz"],
                                   None, g, cfg, ak, bk, ptop, dp0,
                                   u0=u0, v0=v0)
                new = dict(state, delp=r.delp, pt=r.pt, u=r.u, v=r.v,
                           w=r.w, delz=r.delz)
            if physics == "hs":
                pt2, u2, v2 = held_suarez.hs_forcing(
                    new["pt"], new["delp"], new["u"], new["v"], g, ptop,
                    cfg.dt)
                new.update(pt=pt2, u=u2, v=v2)
            elif physics == "sim":
                new.update(_sim_physics(new, g, ptop, cfg.dt))
            # the state is held contiguous between steps: a step's sums
            # then run in the same order whether its input came from the
            # step before or from a checkpoint
            return {k: v.contiguous() for k, v in new.items()}

        return step

    def adiabatic_init(self, na_init=1, wt=1.5):
        """Forward-backward adiabatic initialization
        (driver/solo/atmosphere.F90 adiabatic_init:194): na_init cycles of
        {forward, backward, nudge to the initial state, backward, forward,
        nudge} with the physics off, the nudge weighting the initial state
        wt to 1; the backward passes run the dynamics with dt -> -dt,
        damping the fast modes while the balanced flow round-trips."""
        cfgb = dataclasses.replace(self.cfg, dt=-self.cfg.dt)
        fwd = self._build_step(physics="none")
        bwd = self._build_step(cfg=cfgb, physics="none")
        xt = 1.0 / (1.0 + wt)
        keep = [k for k in ("u", "v", "pt", "delp") if k in self.state]
        s0 = {k: self.state[k] for k in keep}

        def nudge(s):
            return dict(s, **{k: xt * (s[k] + wt * s0[k]) for k in keep})

        s = self.state
        for _ in range(na_init):
            s = nudge(bwd(fwd(s, None, None), None, None))
            s = nudge(fwd(bwd(s, None, None), None, None))
        self.state = s
        return s

    # -- the public API (atmosphere_init is __init__) ----------------------

    def atmosphere(self, nsteps=1):
        """Advance nsteps big timesteps (solo atmosphere:395)."""
        for _ in range(nsteps):
            with self.timers("FV_DYNAMICS"):
                self.state = self._step(self.state, self.u0, self.v0)
            self.time_seconds += self.cfg.dt
            self.step_count += 1
        return self.state

    def audit(self, out=print):
        """NaN check and the global min/max of PS, T and U; False on a
        NaN."""
        from ..io.diagnostics import nan_check, prt_maxmin
        bad = nan_check(self.state)
        if bad:
            out(f"NaN detected in: {bad}")
        ps = self.ptop + self.state["delp"].sum(dim=1)
        out(f"step {self.step_count}  t={self.time_seconds / 86400.0:.3f} d")
        prt_maxmin("PS(hPa)", ps * 0.01, out=out)
        prt_maxmin("T", self.state["pt"], out=out)
        prt_maxmin("U", self.state["u"], out=out)
        return not bad

    def write_restart(self, path):
        from ..io import restart as rst
        with self.timers("RESTART_WRITE"):
            rst.save_state(path, self.state, ak=self.ak, bk=self.bk,
                           tracers=self.tracers, step=self.step_count,
                           time_seconds=self.time_seconds)

    def atmosphere_end(self, out=print):
        self.timers.report(out)


def _sim_physics(new, g, ptop, dt):
    """The idealized gray-radiation and PBL suite (GFDL_sim_phys) on the
    state after the dynamics: A-grid wind tendencies scattered back onto
    the D grid. Returns the updated pt, u, v."""
    from ..model.fv_update_phys import cubed_to_latlon, fv_update_phys
    from ..model.thermodynamics import interface_pressure
    from ..physics.sim_phys import sim_phys
    ua, va = cubed_to_latlon(new["u"], new["v"], g)
    delz = new.get("delz")
    if delz is None:
        pe0 = interface_pressure(new["delp"], ptop)
        delz = (-con.RDGAS * new["pt"] / con.GRAV
                * torch.log(pe0[:, 1:] / pe0[:, :-1]))
    ts = new["pt"][:, -1] + 1.0     # fixed warm-ocean skin
    ua2, va2, ta2, _, _ = sim_phys(ua, va, new["pt"], None, new["delp"],
                                   delz, ts, g, ptop, dt)
    _, u2, v2, _ = fv_update_phys(dt, new["pt"], new["delp"], new["u"],
                                  new["v"], None, (ua2 - ua) / dt,
                                  (va2 - va) / dt, torch.zeros_like(ta2),
                                  None, g)
    return dict(pt=ta2, u=u2, v=v2)


def main(argv=None):
    p = argparse.ArgumentParser(description="FV3 solo driver (PyTorch)")
    p.add_argument("--npx", type=int, default=49)
    p.add_argument("--npz", type=int, default=32)
    p.add_argument("--dt", type=float, default=1200.0)
    p.add_argument("--days", type=float, default=1.0)
    p.add_argument("--case", default="jw", choices=["jw", "jw_unperturbed"])
    p.add_argument("--physics", default="none", choices=["none", "hs"])
    p.add_argument("--nonhydrostatic", action="store_true")
    p.add_argument("--f64", action="store_true")
    p.add_argument("--restart-in", default=None)
    p.add_argument("--restart-out", default=None)
    p.add_argument("--audit-every", type=int, default=0)
    p.add_argument("--tau", type=float, default=0.0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    args = p.parse_args(argv)

    over = {}
    if args.tau > 0:
        over["tau"] = args.tau
    atm = Atmosphere(args.npx, args.npz, args.dt, case=args.case,
                     physics=args.physics,
                     hydrostatic=not args.nonhydrostatic,
                     dtype="f64" if args.f64 else "f32",
                     cfg_overrides=over, restart=args.restart_in,
                     device=args.device)
    nsteps = int(args.days * 86400.0 / args.dt)
    form = "nonhydro" if args.nonhydrostatic else "hydro"
    print(f"running {nsteps} steps of {args.dt}s at "
          f"C{args.npx - 1}L{args.npz} ({form}, physics={args.physics}) on "
          f"{atm.device}")
    t0 = time.perf_counter()
    chunk = max(1, args.audit_every or nsteps)
    done = 0
    while done < nsteps:
        todo = min(chunk, nsteps - done)
        atm.atmosphere(todo)
        done += todo
        if not atm.audit():
            raise SystemExit("state audit failed (NaN)")
    wall = time.perf_counter() - t0
    gpts = 6 * (args.npx - 1) ** 2 * args.npz
    print(f"wall {wall:.2f}s  {nsteps * gpts / wall:.3e} "
          f"gridpoint-levels/s")
    if args.restart_out:
        atm.write_restart(args.restart_out)
        print("restart written:", args.restart_out)
    atm.atmosphere_end()


if __name__ == "__main__":
    main()
