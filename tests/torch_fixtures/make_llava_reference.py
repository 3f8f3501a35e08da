"""Write ``llava_2l_reference.json``: the JAX package's
llava-next-mistral-7b at full width (d 4096, 32/8 heads of 128, d_ff
14 336, rope theta 1e6, untied vocabulary of 32 000, 576 patches) and 2
layers, op by op on the CPU (``model_reference.write``), with the weights
of ``carry.numpy_params(cfg, seed=0)``.

The loss batch is B 1 x (576 patch embeddings + 2 048 tokens) = 2 624
rows (not a multiple of 128); the patches are N(0, 1) from a seed the
fixture stores (the vision tower is a stub, as in the reference), put
before the tokens through ``patch_proj``, and the loss and the top-5
logits are over the text positions only, the first ones after the
patches included.  The greedy engine runs the text decoder alone, as the
reference's ``decode_step`` does (it ignores the patches).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_fixtures/make_llava_reference.py

Takes a few minutes and ~8 GB of host memory.
"""
import pathlib

from model_reference import write

OUT = pathlib.Path(__file__).parent / "llava_2l_reference.json"
POSITIONS = [0, 1, 2, 63, 64, 1023, 1024, 2047]

if __name__ == "__main__":
    write(OUT, "llava-next-mistral-7b", layers=2, seed=0, B=1, S=2048,
          positions=POSITIONS)
