"""Write ``mixtral8x22b_2l_reference.json``: the JAX package's
mixtral-8x22b at full width (d 6144, 48/8 heads, 8 experts of d_ff 16384,
top-2, capacity factor 1.25) and 2 layers, op by op on the CPU
(``model_reference.write``), with every layer's top-2 experts per token
and the (token, expert) assignments it dropped for capacity.

The weights are ``carry.numpy_params(cfg, seed=0)``: the expert stacks
(2 x 8 x 6144 x 16384 values each) are drawn in blocks on threads and cast
to bf16 leaf by leaf.  The loss batch is B 1, S 512 (capacity 161 slots
per expert).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_fixtures/make_mixtral_reference.py

Takes about ten minutes and ~25 GB of host memory.
"""
import pathlib

from model_reference import write

OUT = pathlib.Path(__file__).parent / "mixtral8x22b_2l_reference.json"
POSITIONS = [0, 1, 63, 64, 127, 128, 300, 511]

if __name__ == "__main__":
    write(OUT, "mixtral-8x22b", layers=2, seed=0, B=1, S=512,
          positions=POSITIONS)
