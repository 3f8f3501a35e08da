"""The JAX package's run of one model at full width and a few layers, for
the port's card phases: the body of ``make_hymba_reference.py``,
``make_mixtral_reference.py``, ``make_whisper_reference.py`` and
``make_llava_reference.py``.

The weights are ``repro_torch.carry.numpy_params(cfg, seed)`` (shared by
both packages: the f32 leaves as f32, the rest as bf16), drawn and cast
leaf by leaf.  The reference runs op by op (``jax.disable_jit()``), which
keeps every bf16 rounding the program writes; compiled, XLA:CPU keeps some
bf16 intermediates in f32.

A fixture records:
- ``loss``: ``Model.loss`` on one fixed batch (tokens and labels stored;
  the encoder-decoder's frame embeddings and the VLM's patch embeddings,
  ``extras``, are N(0, 1) in f32 from ``np.random.default_rng(seed)``,
  stored as the seed and the shape: ``stub_inputs`` draws them);
- ``forward``: the top-5 logit ids and values of that forward at
  ``positions``;
- ``routing`` (MoE models): for each layer of the loss's forward, the
  router's probabilities (f32) and every token's top-k experts and the
  (token, expert) assignments dropped for capacity, read from the
  reference's own run (``torch_compare.jax_moe_probe``): the dispatch is
  an integer function of the probabilities, which the port can be held
  to exactly on the reference's own probabilities;
- ``greedy``: a greedy ``Engine`` run with 2 slots and 2 requests of 8
  prompt tokens and 8 new tokens (``max_seq`` 32): each request's tokens,
  and for every engine tick its input tokens, its ``cache_len`` and the
  top-5 logit ids and values of each slot (logits of ``Model.decode`` on
  the tick's inputs), so that the port can be teacher-forced with the
  reference's inputs.
"""
import json
import pathlib
import sys
import time

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

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from torch_compare import jax_moe_probe  # noqa: E402

BATCH_SEED = 1
PROMPTS_SEED, SLOTS, PROMPT_LEN, MAX_NEW, MAX_SEQ = 2, 2, 8, 8, 32
TOPK = 5
EXTRAS_SEED = 4


def stub_inputs(cfg, B: int, seed: int = EXTRAS_SEED) -> dict:
    """The frontend stubs' inputs of a batch of ``B``: ``{name: (shape,
    array)}``, frames for the encoder-decoder, patches for the VLM."""
    shape = {"encdec": ("frames", cfg.audio_frames_default),
             "vlm": ("patches", cfg.vlm_patches_default)}.get(cfg.family)
    if shape is None:
        return {}
    name, n = shape
    s = (B, n, cfg.d_model)
    return {name: (list(s), np.random.default_rng(seed).standard_normal(
        s, dtype=np.float32))}


def jax_hidden(cfg, params, batch, impl):
    """The reference's ``lm_loss`` up to its logits: the final-normed
    hidden states of the text positions."""
    x = params["embed"][batch["tokens"]].astype(jnp.bfloat16)
    if cfg.family == "vlm":
        px = jnp.einsum("bpd,de->bpe", batch["patches"].astype(jnp.bfloat16),
                        params["patch_proj"])
        x = jnp.concatenate([px, x], axis=1)
    enc_out = None
    if cfg.family == "encdec":
        enc_out = jtf.encoder(cfg, params,
                              batch["frames"].astype(jnp.bfloat16), impl=impl)
    x = jtf.backbone(cfg, params, x, positions=jnp.arange(x.shape[1]),
                     causal=True, impl=impl, enc_out=enc_out)
    x = norm(x, params["ln_f"], cfg.norm)
    if cfg.family == "vlm":
        x = x[:, -batch["tokens"].shape[1]:]
    return x


def write(out: pathlib.Path, arch: str, layers: int, seed: int, B: int,
          S: int, positions: list, ones_jitter: float = 0.0) -> None:
    t0 = time.perf_counter()
    cfg = get_config(arch).scaled(n_layers=layers)
    params = carry.numpy_params(
        port_config(arch).scaled(n_layers=layers), seed,
        ones_jitter=ones_jitter,
        leaf_fn=lambda name, a: jnp.asarray(
            a, jnp.float32 if tf.is_f32_leaf(name) else jnp.bfloat16))
    print(f"weights {time.perf_counter() - t0:.1f} s", flush=True)
    model = Model(cfg, impl="naive")

    rng = np.random.default_rng(BATCH_SEED)
    tokens = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens[:, :-1]),
             "labels": jnp.asarray(tokens[:, 1:])}
    extras = stub_inputs(cfg, B)
    batch.update({k: jnp.asarray(a) for k, (_, a) in extras.items()})
    unembed = params.get("unembed", params["embed"])

    with jax.disable_jit():
        with jax_moe_probe() as calls:
            loss = float(model.loss(params, batch))
        print(f"loss {loss!r} ({time.perf_counter() - t0:.1f} s)", flush=True)
        h = jax_hidden(cfg, params, batch, "naive")[0, jnp.asarray(positions)]
        logits = jnp.einsum("sd,vd->sv", h, unembed).astype(jnp.float32)
        fvals, fids = jax.lax.top_k(logits[:, :cfg.vocab], TOPK)
        print(f"forward ({time.perf_counter() - t0:.1f} s)", flush=True)

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

    rec = {"arch": arch, "n_layers": layers, "weights_seed": seed,
           "ones_jitter": ones_jitter, "op_by_op": True,
           "jax": jax.__version__,
           "loss_batch": {"tokens": tokens[:, :-1].tolist(),
                          "labels": tokens[:, 1:].tolist()},
           "loss": loss,
           **({"extras": {"seed": EXTRAS_SEED,
                          **{k: s for k, (s, _) in extras.items()}}}
              if extras else {}),
           "forward": {"positions": positions,
                       "top_ids": np.asarray(fids).tolist(),
                       "top_vals": np.asarray(fvals).tolist()},
           "greedy": {"slots": SLOTS, "max_seq": MAX_SEQ,
                      "max_new": MAX_NEW, "prompts": prompts,
                      "outputs": [r.out for r in reqs], "ticks": ticks}}
    if cfg.family == "moe":
        assert len(calls) == layers
        rec["routing"] = [{"cap": c["cap"],
                           "probs": c["probs"].tolist(),
                           "experts": c["experts"].tolist(),
                           "dropped": [list(p) for p in c["dropped"]]}
                          for c in calls]
        print("dropped per layer",
              [len(c["dropped"]) for c in calls], flush=True)
    out.write_text(json.dumps(rec) + "\n")
    print(f"wrote {out} ({time.perf_counter() - t0:.1f} s)")
