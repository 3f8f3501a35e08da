"""Model assembly in plain torch: the decoder-only LMs (dense, MoE, SSM,
hybrid), the encoder-decoder (whisper) and the VLM (LLaVA-style stub
frontend).

Port of ``repro/models/transformer.py``.  The parameters keep the
reference's tree (a nested dict with the layers stacked on a leading
axis), and a Python loop over the layers takes the place of ``lax.scan``.
The ``encdec`` family runs a bidirectional encoder over frame embeddings
(the conv frontend is a stub, as in the reference) and a decoder whose
layers add a cross-attention sublayer; the ``vlm`` family puts projected
patch embeddings before the tokens and scores only the text positions.
``remat`` (none|dots|full|block) is ``torch.utils.checkpoint`` around the
layers, as the reference's ``jax.checkpoint`` is.  The sharding arguments
(``act_spec``, ``sp_specs``, ``moe_specs``, ``fsdp_gather_specs``) pin
activations, attention's q/k/v, the MoE dispatch and each layer's
gathered parameters where the reference does, through
``layers.constrain``: identity on plain tensors, a redistribute on
DTensors.
"""
from __future__ import annotations

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (chunked_xent, constrain, dot,
                                       glu_mlp, mlp_shapes, norm,
                                       norm_shapes)
from repro_torch.sharding import specs as specs_mod

REMAT = ("none", "dots", "full", "block")


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

def _stacked(tree: dict, n: int) -> dict:
    return {k: _stacked(v, n) if isinstance(v, dict) else (n,) + v
            for k, v in tree.items()}


def layer_shapes(cfg: ModelConfig, cross: bool = False) -> dict:
    """One layer's parameter shapes (the reference's ``layer_spec``);
    ``cross`` adds the decoder's cross-attention (``ln_x``, ``xattn``)."""
    d = cfg.d_model
    layer = {"ln1": norm_shapes(d, cfg.norm)}
    if cfg.has_attention:
        layer["attn"] = attn_mod.attn_shapes(d, cfg.n_heads, cfg.n_kv_heads,
                                             cfg.hd)
    if cfg.has_ssm:
        layer["ssm"] = ssm_mod.ssm_shapes(cfg)
        layer["ln_ssm"] = norm_shapes(d, cfg.norm)      # unused by pure SSM
    if cross:
        layer["ln_x"] = norm_shapes(d, cfg.norm)
        layer["xattn"] = attn_mod.attn_shapes(d, cfg.n_heads,
                                              cfg.n_kv_heads, cfg.hd)
    if cfg.family == "moe":
        layer["ffn"] = moe_mod.moe_shapes(cfg)
    elif cfg.family != "ssm":                           # mamba2: no FFN
        layer["ffn"] = mlp_shapes(d, cfg.d_ff, cfg.mlp_gated)
    if "ffn" in layer:
        layer["ln2"] = norm_shapes(d, cfg.norm)
    return layer


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The encoder's config: the decoder's widths as a dense stack with
    full attention (the reference's ``cfg.scaled(family="dense",
    sliding_window=0)``)."""
    return cfg.scaled(family="dense", sliding_window=0)


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree as shapes (the reference's ``param_specs``)."""
    d = cfg.d_model
    shapes = {"embed": (cfg.vocab_padded, d),
              "ln_f": norm_shapes(d, cfg.norm),
              "layers": _stacked(layer_shapes(
                  cfg, cross=cfg.family == "encdec"), cfg.n_layers)}
    if not cfg.tie_embeddings:
        shapes["unembed"] = (cfg.vocab_padded, d)
    if cfg.family == "encdec":
        # the conv frontend is a stub: inputs arrive as frame embeddings
        shapes["enc_layers"] = _stacked(layer_shapes(encoder_config(cfg)),
                                        cfg.enc_layers)
        shapes["enc_ln_f"] = norm_shapes(d, cfg.norm)
    if cfg.family == "vlm":
        shapes["patch_proj"] = (d, d)
    return shapes


def param_specs(cfg: ModelConfig, dtype=torch.bfloat16) -> dict:
    """The parameter tree as meta tensors (the reference's
    ``ShapeDtypeStruct``s): ``dtype``, the SSM's f32 leaves f32."""
    return unflatten(
        (name, torch.empty(shape, device="meta", dtype=torch.float32
                           if is_f32_leaf(name) else dtype))
        for name, shape in leaves(param_shapes(cfg)))


def leaves(tree: dict, path: str = ""):
    """``(keystr, leaf)`` pairs in JAX's flattening order (sorted keys);
    ``keystr`` is ``jax.tree_util.keystr``'s form, e.g. ``['ln_f']['w']``."""
    for k in sorted(tree):
        p = f"{path}[{k!r}]"
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], p)
        else:
            yield p, tree[k]


def unflatten(pairs) -> dict:
    """Inverse of ``leaves``: ``(keystr, leaf)`` pairs -> nested dict."""
    out: dict = {}
    for path, leaf in pairs:
        keys = [k.strip("'\"") for k in path[1:-1].split("][")]
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return out


def is_f32_leaf(name: str) -> bool:
    """Whether the reference declares the leaf f32 whatever the model's
    dtype (``ssm.F32_LEAVES``)."""
    return any(f"[{k!r}]" in name for k in ssm_mod.F32_LEAVES)


def init_rule(name: str, shape: tuple):
    """The reference's ``init_params`` rule for one leaf: ``("fill", v)``,
    ``("normal", std)`` or ``("log_uniform", (lo, hi))`` (``a_log``: the
    log of U(lo, hi), in f32)."""
    if "a_log" in name:
        return "log_uniform", (1.0, 16.0)
    if "dt_bias" in name:
        return "fill", 0.0
    if "d_skip" in name or "'w'" in name or "norm_w" in name \
            or name.endswith("'b']"):
        return "fill", (0.0 if name.endswith("'b']") else 1.0)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return "normal", fan_in ** -0.5


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device=None) -> dict:
    """Random init with the reference's distributions: norm weights 1,
    biases 0, every matrix N(0, 1) * fan_in^-0.5 drawn in f32 and cast;
    the SSM's ``a_log`` = log U(1, 16), ``dt_bias`` 0 and ``d_skip`` 1,
    kept f32.  ``generator`` must live on ``device``; the numbers differ
    from JAX's (see ``carry.numpy_params`` for weights both packages can
    share)."""
    dev = _device.resolve(device)
    out = []
    for name, shape in leaves(param_shapes(cfg)):
        kind, val = init_rule(name, shape)
        dt = torch.float32 if is_f32_leaf(name) else dtype
        if kind == "fill":
            t = torch.full(shape, val, dtype=dt, device=dev)
        elif kind == "log_uniform":
            lo, hi = val
            t = torch.log(lo + (hi - lo) * torch.rand(
                shape, generator=generator, dtype=torch.float32, device=dev))
        else:
            t = (torch.randn(shape, generator=generator, dtype=torch.float32,
                             device=dev) * val).to(dt)
        out.append((name, t))
    return unflatten(out)


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i`` of the stacked layer tree (views, no copy)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in params.items()}


def embed(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``emb[tokens]`` with ``jnp``'s index rule: a negative id wraps once,
    then every id is clamped into range."""
    n = emb.shape[0]
    t = tokens.long()
    t = torch.where(t < 0, t + n, t).clamp(0, n - 1)
    from torch.distributed.tensor import DTensor
    if isinstance(emb, DTensor):
        return embed_on_shards(emb, t)
    return emb[t]


def embed_on_shards(emb, t):
    """``emb[t]`` of a DTensor table, each rank on its own shard, as
    GSPMD partitions the gather: per mesh dim, the ids split (the table
    gathered), else the vocabulary split (each rank looks up the ids in
    its rows, zeros elsewhere: a pending sum), else the width split.
    DTensor's own rule for the lookup's backward fails on some torch
    versions."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = emb.device_mesh
    t = specs_mod.with_placements(t, lambda i, p: p if p.is_shard()
                                  else Replicate())
    ep, yp, gp = [], [], []
    for a, b in zip(t.placements, emb.placements):
        if a.is_shard():
            r = (Replicate(), a, Partial())
        elif b.is_shard(0):
            r = (b, Partial(), b)
        elif b.is_shard(1):
            r = (b, Shard(t.ndim), b)
        else:
            r = (Replicate(),) * 3
        for acc, v in zip((ep, yp, gp), r):
            acc.append(v)
    local = emb.redistribute(mesh, ep)
    v0 = specs_mod.shard_offset(local, 0)
    el = local.to_local(grad_placements=gp)
    idx = t.to_local() - v0
    mine = (idx >= 0) & (idx < el.shape[0])
    out = torch.where(mine[..., None], el[idx.clamp(0, el.shape[0] - 1)],
                      torch.zeros((), dtype=el.dtype, device=el.device))
    return specs_mod.as_placed(out, mesh, yp, (*t.shape, emb.shape[1]))


# --------------------------------------------------------------------------
# forward passes
# --------------------------------------------------------------------------

def mix_heads(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The hybrid layer's parallel heads: the mean of the attention and
    SSM outputs (reference ``_layer_body``)."""
    return 0.5 * (a + s)


def mixer(cfg: ModelConfig, x, lp, *, positions, causal, impl,
          sp_specs=None):
    """The layer's sequence mixer on the residual stream x: attention on
    ``norm(x, ln1)``, the SSM on it (pure SSM), or both in parallel (hybrid:
    the SSM heads on ``norm(x, ln_ssm)``), averaged by ``mix_heads``."""
    h = norm(x, lp["ln1"], cfg.norm)
    if not cfg.has_attention:                         # pure SSM
        s, _ = ssm_mod.ssm_forward(h, lp["ssm"], cfg, impl=impl)
        return s
    a, _ = attn_mod.attention(h, lp["attn"], cfg, positions=positions,
                              causal=causal, impl=impl, sp_specs=sp_specs)
    if cfg.has_ssm:                                   # hybrid
        s, _ = ssm_mod.ssm_forward(norm(x, lp["ln_ssm"], cfg.norm),
                                   lp["ssm"], cfg, impl=impl)
        a = mix_heads(a, s)
    return a


def ffn(cfg: ModelConfig, x, lp, moe_specs=None) -> torch.Tensor:
    """The layer's feed-forward on ``norm(x, ln2)``: the expert FFN (moe,
    with ``moe_specs``' dispatch groups) or the (gated) MLP."""
    h = norm(x, lp["ln2"], cfg.norm)
    if cfg.family == "moe":
        return moe_mod.moe_ff(h, lp["ffn"], cfg, specs=moe_specs)
    return glu_mlp(h, lp["ffn"], cfg.act)


def cross(cfg: ModelConfig, x, lp, enc_out, *, positions,
          sp_specs=None) -> torch.Tensor:
    """The decoder's cross-attention sublayer on ``norm(x, ln_x)``: k and v
    from the encoder's output, no rope, not causal.  It takes no ``impl``,
    so it runs the blockwise path whatever the model's ``impl``, as the
    reference's does."""
    h = norm(x, lp["ln_x"], cfg.norm)
    a, _ = attn_mod.attention(h, lp["xattn"], cfg, positions=positions,
                              causal=False, x_kv=enc_out, use_rope=False,
                              sp_specs=sp_specs)
    return a


def _layer_body(cfg: ModelConfig, x, lp, *, positions, causal, impl,
                enc_out=None, sp_specs=None, moe_specs=None):
    x = x + mixer(cfg, x, lp, positions=positions, causal=causal, impl=impl,
                  sp_specs=sp_specs)
    if enc_out is not None:
        x = x + cross(cfg, x, lp, enc_out, positions=positions,
                      sp_specs=sp_specs)
    if "ffn" in lp:
        x = x + ffn(cfg, x, lp, moe_specs)
    return x


def unstack(layers: dict, n: int) -> list:
    """The stacked layer tree as ``n`` per-layer trees of views.  One
    ``unbind`` per leaf, so that a backward stacks the layers' gradients
    once rather than adding a full-size gradient per layer."""
    parts = {k: unstack(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in layers.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


# the products ``remat="dots"`` keeps: matrix products without batch
# dimensions (the reference's ``dots_with_no_batch_dims_saveable``); an
# ``x @ w`` of a [B, S, d] activation is one ``mm``, the attention's and
# the experts' batched products are ``bmm`` and are recomputed
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return _ckpt.create_selective_checkpoint_contexts(_dots_policy)


def _checkpointed(fn, mode: str = "full"):
    """``fn`` recomputed in the backward (the reference's
    ``jax.checkpoint``): everything but its inputs (``"full"``), or all but
    the matrix products (``"dots"``)."""
    kw = {"context_fn": _dots_context} if mode == "dots" else {}
    return lambda *args: _ckpt.checkpoint(fn, *args, use_reentrant=False,
                                          **kw)


def _run_layers(cfg: ModelConfig, layers: list, x, remat: str, *,
                act_spec=None, fsdp_gather_specs=None, **kw):
    """x through each of ``layers`` (per-layer trees) with ``_layer_body``,
    rematerialised as ``remat`` says: per layer (``full``, ``dots``), or
    the reference's sqrt(L) nesting (``block``: blocks of k layers, the
    outer level saving only each block's input, the inner each layer's).
    Each layer's parameters are pinned to ``fsdp_gather_specs`` inside the
    body (one layer gathered at a time) and its output to ``act_spec``."""
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r}: want one of {REMAT}")

    def body(x, lp):
        if fsdp_gather_specs is not None:
            lp = specs_mod.tree_map(constrain, lp, fsdp_gather_specs)
        return constrain(_layer_body(cfg, x, lp, **kw), act_spec)

    if remat == "none" or not torch.is_grad_enabled():
        for lp in layers:
            x = body(x, lp)
        return x
    if remat == "block":
        L = len(layers)
        k = max(1, int(L ** 0.5))
        while L % k:
            k -= 1
        inner = _checkpointed(body)

        def block(x, *lps):
            for lp in lps:
                x = inner(x, lp)
            return x

        outer = _checkpointed(block)
        for b in range(L // k):
            x = outer(x, *layers[b * k:(b + 1) * k])
        return x
    body = _checkpointed(body, remat)
    for lp in layers:
        x = body(x, lp)
    return x


def backbone(cfg: ModelConfig, params, x, *, positions, causal=True,
             impl="blockwise", enc_out=None, remat: str = "none",
             act_spec=None, sp_specs=None, moe_specs=None,
             fsdp_gather_specs=None):
    """Run the stacked layers over x: [B, S, d] (the decoder's, with
    cross-attention to ``enc_out`` for the encoder-decoder)."""
    return _run_layers(cfg, unstack(params["layers"], cfg.n_layers), x,
                       remat, positions=positions, causal=causal, impl=impl,
                       enc_out=enc_out, act_spec=act_spec, sp_specs=sp_specs,
                       moe_specs=moe_specs,
                       fsdp_gather_specs=fsdp_gather_specs)


def encoder(cfg: ModelConfig, params, frames, *, impl="blockwise",
            remat="none", sp_specs=None) -> torch.Tensor:
    """Whisper-style encoder over precomputed frame embeddings [B, F, d]
    (stub frontend): bidirectional self-attention, which ropes q and k as
    the reference's does (its ``attention`` defaults to ``use_rope=True``),
    then ``enc_ln_f``.  Any ``remat`` but ``"none"`` checkpoints each layer
    whole, as the reference's does."""
    enc_cfg = encoder_config(cfg)
    x = frames.to(torch.bfloat16)
    positions = torch.arange(x.shape[1], device=x.device)
    x = _run_layers(enc_cfg, unstack(params["enc_layers"], cfg.enc_layers),
                    x, "none" if remat == "none" else "full",
                    positions=positions, causal=False, impl=impl,
                    sp_specs=sp_specs)
    return norm(x, params["enc_ln_f"], cfg.norm)


def _logits(cfg: ModelConfig, h: torch.Tensor, e: torch.Tensor
            ) -> torch.Tensor:
    logits = dot(h, e.T)                          # einsum bsd,vd->bsv
    if cfg.vocab_padded != cfg.vocab:             # mask padded vocab rows
        pad = torch.arange(cfg.vocab_padded, device=h.device) < cfg.vocab
        logits = torch.where(pad, logits, -1e30)
    return logits


def vlm_prefix(px: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The VLM's sequence: the projected patches, then the tokens."""
    return torch.cat([px, x], dim=1)


def text_rows(h: torch.Tensor, n_text: int) -> torch.Tensor:
    """The VLM's text positions of the final hidden states: the last
    ``n_text``, which alone the loss scores."""
    return h[:, h.shape[1] - n_text:]


def lm_embed(cfg: ModelConfig, params, tokens, patches=None,
             act_spec=None) -> torch.Tensor:
    """The decoder's input [B, S, d] in bf16: the token embeddings, after
    the projected patch embeddings [B, P, d] for the VLM; pinned to
    ``act_spec``."""
    x = constrain(embed(params["embed"], tokens).to(torch.bfloat16),
                  act_spec)
    if cfg.family == "vlm":
        px = dot(patches.to(torch.bfloat16), params["patch_proj"])
        x = constrain(vlm_prefix(px, x), act_spec)
    return x


def lm_hidden(cfg: ModelConfig, params, tokens, *, impl="blockwise",
              remat="none", frames=None, patches=None, act_spec=None,
              sp_specs=None, moe_specs=None,
              fsdp_gather_specs=None) -> torch.Tensor:
    """The final-normed hidden states [B, S, d] whose logits ``lm_loss``
    scores (for the VLM only the text positions).  ``frames`` [B, F, d]
    (encdec) and ``patches`` [B, P, d] (vlm) are the frontends' stub
    embeddings; the sharding arguments are ``backbone``'s."""
    if cfg.family == "encdec" and frames is None:
        raise KeyError("frames: the encoder-decoder needs frame embeddings")
    if cfg.family == "vlm" and patches is None:
        raise KeyError("patches: the VLM needs patch embeddings")
    x = lm_embed(cfg, params, tokens, patches, act_spec)
    positions = torch.arange(x.shape[1], device=x.device)
    enc_out = None
    if cfg.family == "encdec":
        enc_out = encoder(cfg, params, frames, impl=impl, remat=remat,
                          sp_specs=sp_specs)
    x = backbone(cfg, params, x, positions=positions, causal=True, impl=impl,
                 enc_out=enc_out, remat=remat, act_spec=act_spec,
                 sp_specs=sp_specs, moe_specs=moe_specs,
                 fsdp_gather_specs=fsdp_gather_specs)
    x = norm(x, params["ln_f"], cfg.norm)
    if cfg.family == "vlm":                 # loss only over text positions
        x = text_rows(x, tokens.shape[1])
    return x


def lm_logits(cfg: ModelConfig, params, h: torch.Tensor) -> torch.Tensor:
    """Logits of hidden states h [..., d] (bf16, as in ``lm_loss``)."""
    return _logits(cfg, h, params.get("unembed", params["embed"]))


def lm_loss(cfg: ModelConfig, params, batch, *, impl="blockwise",
            remat="none", xent_chunk=512, **shard) -> torch.Tensor:
    """Causal LM loss.  batch: tokens/labels [B, S] (+ ``frames`` for the
    encoder-decoder, ``patches`` for the VLM); ``shard``: the sharding
    arguments of ``lm_hidden``."""
    x = lm_hidden(cfg, params, batch["tokens"], impl=impl, remat=remat,
                  frames=batch.get("frames"), patches=batch.get("patches"),
                  **shard)
    labels = batch["labels"]
    sp = shard.get("sp_specs")
    if sp is not None:        # scored on the rows q's sequence is split in
        x = constrain(x, specs_mod.P(*sp[0][:3]))
        labels = constrain(labels, specs_mod.P(*sp[0][:2]))
    unemb = params.get("unembed", params["embed"])
    return chunked_xent(lambda h, e: _logits(cfg, h, e), x, unemb,
                        labels, chunk=xent_chunk)


# --------------------------------------------------------------------------
# decode (serve_step)
# --------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, seq_len: int,
                      dtype=torch.bfloat16, device=None) -> dict:
    """Per-layer stacked decode state, zeros: KV caches [L, batch, S, Hkv,
    hd] in ``dtype`` (a sliding-window arch keeps only ``window`` slots, a
    ring buffer) for attention, the SSM state [L, batch, H, P, N] in f32
    for the SSM."""
    dev = _device.resolve(device)
    out = {}
    if cfg.has_attention:
        S = min(seq_len, cfg.sliding_window) if cfg.sliding_window \
            else seq_len
        kv = (cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.hd)
        out.update({k: torch.zeros(kv, dtype=dtype, device=dev)
                    for k in ("k", "v")})
    if cfg.has_ssm:
        s = ssm_mod.ssm_state_shapes(cfg, batch)["ssm"]
        out["ssm"] = torch.zeros((cfg.n_layers,) + s, dtype=torch.float32,
                                 device=dev)
    return out


def decode_state_specs(cfg: ModelConfig, batch: int, seq_len: int,
                       dtype=torch.bfloat16) -> dict:
    """``init_decode_state``'s tree as meta tensors."""
    return init_decode_state(cfg, batch, seq_len, dtype, device="meta")


def decode_step(cfg: ModelConfig, params, cache: dict, tokens,
                cache_len: int, act_spec=None):
    """One decode step: tokens [B, 1] at position ``cache_len``.

    Sliding-window archs index the cache modulo the window (ring buffer);
    the SSM state is O(1).  Returns (logits [B, V] f32, cache); the cache
    is updated in place (see ``attention.attention``; each layer's SSM
    state is overwritten with its new value); the embedded tokens are
    pinned to ``act_spec``.  As in the reference, the
    encoder-decoder's step skips the cross-attention (the encoder is not
    run) and the VLM's ignores the patches.
    """
    emb = params["embed"]
    x = constrain(embed(emb, tokens).to(torch.bfloat16), act_spec)
    window = cfg.sliding_window
    if isinstance(cache_len, torch.Tensor):
        # a 0-d tensor (the dry run's traced int32 position): no host read
        positions = cache_len.reshape(1).to(torch.int32)
        slot = cache_len % window if window else cache_len
        valid_len = (cache_len + 1).clamp(max=window) if window \
            else cache_len + 1
    else:
        cache_len = int(cache_len)
        positions = torch.full((1,), cache_len, dtype=torch.int32,
                               device=x.device)
        if window:
            slot = cache_len % window              # ring-buffer slot
            valid_len = min(cache_len + 1, window)
        else:
            slot = cache_len
            valid_len = cache_len + 1

    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        h = norm(x, lp["ln1"], cfg.norm)
        if cfg.has_attention:
            a, _ = attn_mod.attention(
                h, lp["attn"], cfg, positions=positions,
                kv_cache={"k": cache["k"][i], "v": cache["v"][i]},
                cache_slot=slot, valid_len=valid_len)
            if cfg.has_ssm:                           # hybrid
                s, new_s = ssm_mod.ssm_forward(
                    norm(x, lp["ln_ssm"], cfg.norm), lp["ssm"], cfg,
                    state={"ssm": cache["ssm"][i]})
                cache["ssm"][i] = new_s["ssm"]
                a = mix_heads(a, s)
            x = x + a
        else:
            s, new_s = ssm_mod.ssm_forward(h, lp["ssm"], cfg,
                                           state={"ssm": cache["ssm"][i]})
            cache["ssm"][i] = new_s["ssm"]
            x = x + s
        if "ffn" in lp:
            x = x + ffn(cfg, x, lp)
    x = norm(x, params["ln_f"], cfg.norm)
    unemb = params.get("unembed", emb)
    logits = dot(x, unemb.T)[:, 0, :cfg.vocab]
    return logits.float(), cache

