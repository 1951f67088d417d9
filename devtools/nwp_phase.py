"""Phase 13 of chip_smoke.py alone on the card: the NWP initialisation and
forcing path (13d, card against CPU at C24L10 in float64; 13a-c, the
chgres cold start, the IAU forecast and the nudged forecast at C192L79 in
float32), after building the kernels, without the other phases.

    python3 devtools/nwp_phase.py

13b and 13c hold their launches per big step to phase 6's, which this
script does not run: it takes NH_PER_STEP's for 5 big steps with one
rank-5 tp sweep per tracer_2d call (nsplt 1, as phase 6 of the smoke
reads at C192L79). Exits non-zero on any failure; needs one CUDA card.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def main():
    import torch
    if not torch.cuda.is_available():
        print("nwp_phase: no CUDA device is available", file=sys.stderr)
        return 2
    from gfdl_atmos_cubed_sphere_tpu_torch.grid.metrics import (
        build_grid_geometry)
    from gfdl_atmos_cubed_sphere_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    card = cs.card_line()
    cs.log(f"card: {card}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}")
    secs = _build.build(force=True)
    cs.log(f"build: {len(secs)} kernels in "
           f"{time.perf_counter() - t_start:.1f} s")
    cs.nwp_card_vs_cpu(build_grid_geometry(25, ng=cs.H))
    t0 = time.perf_counter()
    geom = build_grid_geometry(193, ng=cs.H)
    cs.log(f"C192 geometry: host {time.perf_counter() - t0:.1f} s")
    # two tracer_2d calls a big step (k_split 2), one subcycle each
    launches6 = {k: v * 5 for k, v in cs.NH_PER_STEP.items()}
    launches6["tp2d_sweep"] += 2 * 5
    t0 = time.perf_counter()
    iau, nudged = cs.nwp_full_width(geom, card, launches6)
    cs.log(f"phase 13a-c: {time.perf_counter() - t0:.1f} s; 13b "
           f"{iau['s_per_step']:.4f} s/step, 13c {nudged['s_per_step']:.4f}")
    cs.log(f"total {time.perf_counter() - t_start:.1f} s")
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
