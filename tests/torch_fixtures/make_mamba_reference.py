"""Write ``mamba2_2l_reference.json``: the JAX package's mamba2-1.3b at full
width and 2 layers, with the weights of ``repro_torch.carry.
numpy_params(cfg, seed=0)`` (shared by both packages: the f32 leaves
``a_log``, ``dt_bias``, ``d_skip`` as f32, the rest as bf16), on the CPU.
``chip_smoke.py`` holds the port's run on the card against it.

The reference runs op by op (``jax.disable_jit()``), which keeps every
bf16 rounding the program writes; compiled, XLA:CPU keeps some bf16
intermediates in f32, and the SSM state carries that difference from one
decode tick to the next.

It records:
- ``loss``: ``Model.loss`` on one fixed batch (B 1, S 512, 4 chunks of
  128; tokens and labels are stored);
- ``forward``: the top-5 logit ids and values of that forward (the SSD
  block's output through both layers, the final norm and the tied
  unembedding) at positions on either side of the 128-token chunk edges;
- ``greedy``: a greedy ``Engine`` run with 2 slots and 2 requests of 8
  prompt tokens and 8 new tokens (``max_seq`` 32): each request's tokens,
  and for every engine tick its input tokens, its ``cache_len`` and the
  top-5 logit ids and values of each slot (logits of ``Model.decode`` on
  the tick's inputs), so that the port can be teacher-forced with the
  reference's inputs.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_fixtures/make_mamba_reference.py

Takes a few minutes and ~3 GB of host memory.
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import get_config
from repro.models import transformer as jtf
from repro.models.layers import norm
from repro.models.model import Model
from repro.serve.engine import Engine, Request
from repro_torch import carry
from repro_torch.configs.base import get_config as port_config
from repro_torch.models import transformer as tf

OUT = pathlib.Path(__file__).parent / "mamba2_2l_reference.json"
ARCH, LAYERS, SEED = "mamba2-1.3b", 2, 0
BATCH_SEED, B, S = 1, 1, 512
PROMPTS_SEED, SLOTS, PROMPT_LEN, MAX_NEW, MAX_SEQ = 2, 2, 8, 8, 32
TOPK = 5
POSITIONS = [0, 1, 127, 128, 255, 256, 383, 511]


def main() -> None:
    cfg = get_config(ARCH).scaled(n_layers=LAYERS)
    npp = carry.numpy_params(port_config(ARCH).scaled(n_layers=LAYERS), SEED)
    params = tf.unflatten(
        (name, jnp.asarray(a, jnp.float32 if tf.is_f32_leaf(name)
                           else jnp.bfloat16))
        for name, a in tf.leaves(npp))
    del npp
    model = Model(cfg, impl="naive")

    rng = np.random.default_rng(BATCH_SEED)
    tokens = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens[:, :-1]),
             "labels": jnp.asarray(tokens[:, 1:])}

    def hidden(params, toks):                 # lm_loss up to its logits
        x = params["embed"][toks].astype(jnp.bfloat16)
        x = jtf.backbone(cfg, params, x, positions=jnp.arange(S),
                         causal=True, impl="naive")
        return norm(x, params["ln_f"], cfg.norm)

    with jax.disable_jit():
        loss = float(model.loss(params, batch))
        print(f"loss {loss!r}", flush=True)
        h = hidden(params, batch["tokens"])[0, jnp.asarray(POSITIONS)]
        logits = jnp.einsum("sd,vd->sv", h, params["embed"]) \
            .astype(jnp.float32)
        fvals, fids = jax.lax.top_k(logits, TOPK)

        prompts = np.random.default_rng(PROMPTS_SEED).integers(
            0, cfg.vocab, (SLOTS, PROMPT_LEN)).tolist()
        eng = Engine(model, params, slots=SLOTS, max_seq=MAX_SEQ)
        step = eng._step
        ticks = []

        def logged(params, cache, toks, cache_len, key):
            logits, _ = model.decode(params, cache, toks, cache_len)
            vals, ids = jax.lax.top_k(logits, TOPK)
            ticks.append({"tokens": np.asarray(toks)[:, 0].tolist(),
                          "cache_len": int(cache_len),
                          "top_ids": np.asarray(ids).tolist(),
                          "top_vals": np.asarray(vals).tolist()})
            return step(params, cache, toks, cache_len, key)

        eng._step = logged
        reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run(max_ticks=100)
    assert all(r.done for r in reqs)

    rec = {"arch": ARCH, "n_layers": LAYERS, "weights_seed": SEED,
           "op_by_op": True, "jax": jax.__version__,
           "loss_batch": {"tokens": tokens[:, :-1].tolist(),
                          "labels": tokens[:, 1:].tolist()},
           "loss": loss,
           "forward": {"positions": POSITIONS,
                       "top_ids": np.asarray(fids).tolist(),
                       "top_vals": np.asarray(fvals).tolist()},
           "greedy": {"slots": SLOTS, "max_seq": MAX_SEQ,
                      "max_new": MAX_NEW, "prompts": prompts,
                      "outputs": [r.out for r in reqs], "ticks": ticks}}
    OUT.write_text(json.dumps(rec) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
