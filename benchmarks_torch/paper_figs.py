"""The paper's fig2-fig6 and the ablations at paper size on the card.

    python3 benchmarks_torch/paper_figs.py [--figs fig2,fig3,fig4,fig5,fig6,ablations]

Runs the grids of ``benchmarks/fig2_uniform.py``, ``fig3_latency.py``,
``fig4_cc_traffic.py``, ``fig5_mc_traffic.py``, ``fig6_apps.py`` and
``ablations.py`` with the port (``benchmarks_torch/figures.py``), each
figure's ``run_sweep_batched`` calls and WI-density points as the script
makes them, at the paper's 10 000 cycles with 1 000 of warm-up
(``chip_smoke.py`` phase 21 runs the same at 500 with 100).  Every
point is held
against ``tests/torch_fixtures/paper_figs_reference.json`` (written by the
JAX package; every ``Metrics`` field, integers exact, floats rel 1e-6,
NaN = NaN), every ``*.check`` row to the reference's truth value and every
derived gain or reduction to rel 1e-6.  Prints each script's CSV rows
(the paper-reported rows beside them, not held) and a JSON line per
figure: wall s, points/s, lane-cycles/s, batches and host set-up s
(builders + ``pack``), with the card's name and power limit.  The whole
paper set takes ~20-30 min; split it across ``--figs`` calls.  Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("paper_figs: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--figs", default="fig2,fig3,fig4,fig5,fig6,ablations")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from benchmarks_torch import figures
    from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan

    figs = args.figs.split(",")
    unknown = set(figs) - set(figures.PAPER_FIGS)
    if unknown:
        ap.error(f"unknown figures {sorted(unknown)}")
    kmods = {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
             "ssd_scan": ssd_scan}
    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    chip_smoke.phase_paper_figs(torch.device("cuda"), kmods, smi, "paper",
                                figs=figs, faults=False,
                                emit=lambda row: print(row, flush=True))
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
