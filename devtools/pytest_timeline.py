"""When each test file of a parallel pytest run started and ended.

A pytest plugin and its report. As a plugin it appends one line per test
to the file named by TEST_TIMELINE: the xdist worker, the wall-clock start
and end, the process CPU seconds the test took and the test's node id.

    TEST_TIMELINE=timeline.txt PYTHONPATH=devtools python -m pytest tests/ \\
        -p xdist -n 6 --dist loadfile -p pytest_timeline
    python devtools/pytest_timeline.py timeline.txt

The report prints each file in the order it started, with its worker, its
start and end in seconds from the run's first test, its summed test time,
its CPU seconds and its test count. It shows when a long file such as
tests/test_shard_halo.py began and what ran beside it.
"""

import collections
import os
import sys
import time

import pytest


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    path = os.environ.get("TEST_TIMELINE")
    t0, c0 = time.time(), time.process_time()
    yield
    if path:
        with open(path, "a") as f:
            f.write(f"{os.environ.get('PYTEST_XDIST_WORKER', '-')} {t0:.2f} "
                    f"{time.time():.2f} {time.process_time() - c0:.2f} "
                    f"{item.nodeid}\n")


def report(path):
    rows = [line.split(None, 4) for line in open(path)]
    start = min(float(r[1]) for r in rows)
    files = {}
    for worker, t0, t1, cpu, nodeid in rows:
        f = files.setdefault(nodeid.split("::")[0], collections.Counter(
            s=float("inf"), w=worker))
        f["s"] = min(f["s"], float(t0) - start)
        f["e"] = max(f["e"], float(t1) - start)
        f["dur"] += float(t1) - float(t0)
        f["cpu"] += float(cpu)
        f["n"] += 1
    print("worker  start    end    test s   cpu s  tests  file")
    for name, f in sorted(files.items(), key=lambda kv: kv[1]["s"]):
        print(f"{f['w']:6s} {f['s']:6.1f} {f['e']:6.1f} {f['dur']:8.1f} "
              f"{f['cpu']:7.1f} {f['n']:5d}  {name}")


if __name__ == "__main__":
    report(sys.argv[1])
