"""How often torch.profiler loses kernel records as a process opens more
profiling sessions.

    python3 devtools/profiler_sessions.py [SESSIONS]

Opens SESSIONS (default 3000) profiler sessions in turn, each around 5
elementwise kernels on a 4 MiB tensor, and counts the sessions whose
readings hold fewer than 5 kernel records. Prints the first five such
sessions, a progress line every 500 sessions and a summary. chip_smoke.py
opens over a thousand sessions before its phase 11a, which therefore
runs in a process of its own. Needs one CUDA card.
"""

import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile


def main(sessions=3000):
    x = torch.randn(1 << 20, device="cuda")
    empty, first = 0, None
    t0 = time.perf_counter()
    for i in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                x * 2.0
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.self_device_time_total > 0]
        n = sum(e.count for e in evs)
        if n != 5:
            empty += 1
            if first is None:
                first = i
            if empty <= 5:
                print(f"session {i}: {n} kernel records of 5", flush=True)
        if i % 500 == 0:
            print(f"session {i}: {time.perf_counter() - t0:.1f} s, "
                  f"{empty} incomplete so far", flush=True)
    print(f"sessions {sessions}, incomplete {empty}, first at {first}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*(int(a) for a in sys.argv[1:2])))
