"""Named-scope wall-clock timers, PyTorch port.

Counterpart of gfdl_atmos_cubed_sphere_tpu/utils/timing.py (FV3
tools/fv_timing.F90 timing_on:100, timing_off:168, timing_prt:241):
nestable context-manager timers, and a torch.profiler scope for device
traces. A timer on a CUDA device synchronises that device when its scope
ends, so the scope owns the work it queued.
"""

import os
import time
from collections import defaultdict
from contextlib import contextmanager

import torch


class Timers:
    """Accumulating named timers. Use `with timers("DYN_CORE"): ...`;
    `report()` prints an fv_timing-style table. sync: whether each scope
    waits for the queued work of device (a CPU device has none to wait
    for) before it stops its clock."""

    def __init__(self, sync=True, device=None):
        self._tot = defaultdict(float)
        self._count = defaultdict(int)
        self._device = (None if device is None or not sync
                        else torch.device(device))
        self._stack = []

    @contextmanager
    def __call__(self, name):
        self._stack.append(name)
        full = "/".join(self._stack)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._device is not None and self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
            self._tot[full] += time.perf_counter() - t0
            self._count[full] += 1
            self._stack.pop()

    def report(self, out=print):
        out(f"{'timer':<40s} {'calls':>7s} {'total_s':>10s} {'mean_ms':>10s}")
        for name in sorted(self._tot):
            tot = self._tot[name]
            cnt = self._count[name]
            out(f"{name:<40s} {cnt:7d} {tot:10.3f} {1e3 * tot / cnt:10.3f}")

    def asdict(self):
        return {k: dict(total_s=self._tot[k], calls=self._count[k])
                for k in self._tot}


@contextmanager
def device_trace(logdir):
    """torch.profiler scope (CPU, and CUDA where a card is present) whose
    Chrome trace is written to logdir/trace.json when the scope ends.
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
