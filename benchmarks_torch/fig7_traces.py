"""fig7 at paper size on the card, with all five traces.

    python3 benchmarks_torch/fig7_traces.py [--traces NAME ...]

``chip_smoke.py`` phase 14 runs two of ``benchmarks/fig7_ml_traces.py``'s
five traces (gemma-7b one-shot and the compiled psum step), the one-shot
without its substrate lane: the lanes of a batch step in lockstep until
the slowest drains (that lane at 11 008 cycles), and the three synthetic
ring traces (gemma-7b, mixtral-8x22b, llama3-405b) drain their substrate
lanes only at 63 488-78 848 cycles.  This script runs the same
phase with every trace (or those named): 15 points x 96 000-cycle budget
with early drain, held against ``tests/torch_fixtures/fig7_reference.json``
(integers exact, floats rel 1e-6), every trace complete, the cycle-vs-
analytic link energy within 2x, and the two planted faults rejected.  It
prints the phase's JSON line with wall time, points/s, lane-cycles/s and
the slowest lane's ``drain_cycle``, beside the card's name and power
limit.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fig7_traces: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from benchmarks_torch import figures
    from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan

    names = [n for n, _, _ in figures.FIG7_RECIPES]
    ap = argparse.ArgumentParser()
    ap.add_argument("--traces", nargs="+", choices=names, default=names)
    args = ap.parse_args()
    kmods = {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
             "ssd_scan": ssd_scan}
    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    chip_smoke.phase_fig7(torch.device("cuda"), kmods, smi,
                          names=tuple(args.traces), skip=())
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
