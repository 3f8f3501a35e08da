"""Write ``hymba1p5b_2l_reference.json``: the JAX package's hymba-1.5b at
full width (d 1600, 25/5 attention heads of 64 with a 2048-token window,
64 SSM heads of P 50, N 16) and 2 layers, op by op on the CPU
(``model_reference.write``).

The weights are ``carry.numpy_params(cfg, seed=0, ones_jitter=0.5)``: the
norm weights the reference initialises to ones are drawn apart, so that a
run that norms the SSM heads with ``ln1`` instead of ``ln_ssm`` shows.
The loss batch is B 1, S 2560: 20 SSD chunks of 128, and past the
2048-token window, so the window masks keys; the top-5 logits are taken on
both sides of chunk edges and past 2048.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_fixtures/make_hymba_reference.py

Takes about two minutes and ~4 GB of host memory.
"""
import pathlib

from model_reference import write

OUT = pathlib.Path(__file__).parent / "hymba1p5b_2l_reference.json"
POSITIONS = [0, 1, 127, 128, 1023, 1024, 2047, 2048, 2049, 2559]

if __name__ == "__main__":
    write(OUT, "hymba-1.5b", layers=2, seed=0, B=1, S=2560,
          positions=POSITIONS, ones_jitter=0.5)
