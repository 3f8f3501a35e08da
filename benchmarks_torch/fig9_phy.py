"""fig9 at paper size on the card: the lossy and living wireless PHY.

    python3 benchmarks_torch/fig9_phy.py

Runs ``benchmarks/fig9_lossy_channel.py``'s whole figure with the port
(``chip_smoke.py``'s fig9 phase): the quality grid (link budgets 13-26 dB
x adaptive/fixed:0/fixed:-1 x the three fabrics, 4C4M at load 0.5, 6 000
cycles with 1 000 of warm-up), the drift sweep (0/2/4/6 dB x online,
static and the fixed rates at 19 dB) and the one-shot all-reduce over the
lossy channel at 22 dB.  Every point is held against
``tests/torch_fixtures/fig9_reference.json`` (integers exact, floats rel
1e-6) and fig9's hard checks must hold; four planted faults must be
rejected.  Prints the figure's ``fig9``, ``fig9.drift``,
``fig9.mc_trace`` and ``fig9.check`` rows as the reference script does,
then the phase's JSON line (wall seconds per part, points/s,
lane-cycles/s) beside the card's name and power limit.  Needs a CUDA
device.
"""
from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fig9_phy: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan

    kmods = {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
             "ssd_scan": ssd_scan}
    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    chip_smoke.phase_fig9(torch.device("cuda"), kmods, smi,
                          emit=lambda row: print(row, flush=True))
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
