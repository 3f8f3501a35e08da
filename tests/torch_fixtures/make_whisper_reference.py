"""Write ``whisper_tiny_reference.json``: the JAX package's whisper-tiny at
full size (4 encoder and 4 decoder layers, d 384, 6 heads of 64, d_ff
1536, layernorm, gelu, tied vocabulary of 51 865), op by op on the CPU
(``model_reference.write``), with the weights of ``carry.numpy_params(cfg,
seed=0)``.

The loss batch is B 2 x 448 decoder tokens over 1 500 frame embeddings
(the conv frontend is a stub, as in the reference; the frames are N(0, 1)
from a seed the fixture stores).  The top-5 logits are taken across the
decoder's 448 positions; the greedy engine runs the decoder alone, as the
reference's ``decode_step`` does (it skips the cross-attention).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_fixtures/make_whisper_reference.py

Takes about a minute and ~2 GB of host memory.
"""
import pathlib

from model_reference import write

OUT = pathlib.Path(__file__).parent / "whisper_tiny_reference.json"
POSITIONS = [0, 1, 63, 64, 127, 128, 300, 447]

if __name__ == "__main__":
    write(OUT, "whisper-tiny", layers=4, seed=0, B=2, S=448,
          positions=POSITIONS)
