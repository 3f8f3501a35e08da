"""Model assembly for the decoder-only LMs, in plain torch.

Port of ``repro/models/transformer.py`` for the decoder-only families:
``dense``, ``moe`` (a top-k expert FFN, ``models/moe.py``), ``ssm`` (pure
Mamba2) and ``hybrid`` (attention and SSM heads in parallel, averaged).
The parameters keep the reference's tree (a nested dict with the layers
stacked on a leading axis), and a Python loop over the layers takes the
place of ``lax.scan``.  The ``encdec`` and ``vlm`` families raise
``NotImplementedError`` naming their ROADMAP item.  No
rematerialisation: the forward needs none, and training is a later slice.
"""
from __future__ import annotations

import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (chunked_xent, glu_mlp, mlp_shapes,
                                       norm, norm_shapes)

PORTED = ("dense", "moe", "ssm", "hybrid")
_NOT_PORTED = {
    "encdec": "ROADMAP A9: the encoder-decoder family",
    "vlm": "ROADMAP A9: the VLM family",
}


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"({_NOT_PORTED.get(cfg.family, 'ROADMAP A9')})")


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

def _stacked(tree: dict, n: int) -> dict:
    return {k: _stacked(v, n) if isinstance(v, dict) else (n,) + v
            for k, v in tree.items()}


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree as shapes (the reference's ``param_specs``)."""
    require_ported(cfg)
    d = cfg.d_model
    layer = {"ln1": norm_shapes(d, cfg.norm)}
    if cfg.has_attention:
        layer["attn"] = attn_mod.attn_shapes(d, cfg.n_heads, cfg.n_kv_heads,
                                             cfg.hd)
    if cfg.has_ssm:
        layer["ssm"] = ssm_mod.ssm_shapes(cfg)
        layer["ln_ssm"] = norm_shapes(d, cfg.norm)      # unused by pure SSM
    if cfg.family == "moe":
        layer["ffn"] = moe_mod.moe_shapes(cfg)
    elif cfg.family != "ssm":                           # mamba2: no FFN
        layer["ffn"] = mlp_shapes(d, cfg.d_ff, cfg.mlp_gated)
    if "ffn" in layer:
        layer["ln2"] = norm_shapes(d, cfg.norm)
    shapes = {"embed": (cfg.vocab_padded, d),
              "ln_f": norm_shapes(d, cfg.norm),
              "layers": _stacked(layer, cfg.n_layers)}
    if not cfg.tie_embeddings:
        shapes["unembed"] = (cfg.vocab_padded, d)
    return shapes


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
    return emb[torch.where(t < 0, t + n, t).clamp(0, n - 1)]


# --------------------------------------------------------------------------
# forward passes
# --------------------------------------------------------------------------

def mix_heads(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The hybrid layer's parallel heads: the mean of the attention and
    SSM outputs (reference ``_layer_body``)."""
    return 0.5 * (a + s)


def mixer(cfg: ModelConfig, x, lp, *, positions, causal, impl):
    """The layer's sequence mixer on the residual stream x: attention on
    ``norm(x, ln1)``, the SSM on it (pure SSM), or both in parallel (hybrid:
    the SSM heads on ``norm(x, ln_ssm)``), averaged by ``mix_heads``."""
    h = norm(x, lp["ln1"], cfg.norm)
    if not cfg.has_attention:                         # pure SSM
        s, _ = ssm_mod.ssm_forward(h, lp["ssm"], cfg, impl=impl)
        return s
    a, _ = attn_mod.attention(h, lp["attn"], cfg, positions=positions,
                              causal=causal, impl=impl)
    if cfg.has_ssm:                                   # hybrid
        s, _ = ssm_mod.ssm_forward(norm(x, lp["ln_ssm"], cfg.norm),
                                   lp["ssm"], cfg, impl=impl)
        a = mix_heads(a, s)
    return a


def ffn(cfg: ModelConfig, x, lp) -> torch.Tensor:
    """The layer's feed-forward on ``norm(x, ln2)``: the expert FFN (moe)
    or the (gated) MLP."""
    h = norm(x, lp["ln2"], cfg.norm)
    if cfg.family == "moe":
        return moe_mod.moe_ff(h, lp["ffn"], cfg)
    return glu_mlp(h, lp["ffn"], cfg.act)


def _layer_body(cfg: ModelConfig, x, lp, *, positions, causal, impl):
    x = x + mixer(cfg, x, lp, positions=positions, causal=causal, impl=impl)
    if "ffn" in lp:
        x = x + ffn(cfg, x, lp)
    return x


def backbone(cfg: ModelConfig, params, x, *, positions, causal=True,
             impl="blockwise"):
    """Run the stacked layers over x: [B, S, d]."""
    for i in range(cfg.n_layers):
        x = _layer_body(cfg, x, layer_params(params["layers"], i),
                        positions=positions, causal=causal, impl=impl)
    return x


def _logits(cfg: ModelConfig, h: torch.Tensor, e: torch.Tensor
            ) -> torch.Tensor:
    logits = h @ e.T                              # einsum bsd,vd->bsv
    if cfg.vocab_padded != cfg.vocab:             # mask padded vocab rows
        pad = torch.arange(cfg.vocab_padded, device=h.device) < cfg.vocab
        logits = torch.where(pad, logits, -1e30)
    return logits


def lm_hidden(cfg: ModelConfig, params, tokens, *,
              impl="blockwise") -> torch.Tensor:
    """The final-normed hidden states [B, S, d] whose logits ``lm_loss``
    scores."""
    require_ported(cfg)
    x = embed(params["embed"], tokens).to(torch.bfloat16)
    positions = torch.arange(x.shape[1], device=x.device)
    x = backbone(cfg, params, x, positions=positions, causal=True, impl=impl)
    return norm(x, params["ln_f"], cfg.norm)


def lm_logits(cfg: ModelConfig, params, h: torch.Tensor) -> torch.Tensor:
    """Logits of hidden states h [..., d] (bf16, as in ``lm_loss``)."""
    return _logits(cfg, h, params.get("unembed", params["embed"]))


def lm_loss(cfg: ModelConfig, params, batch, *, impl="blockwise",
            xent_chunk=512) -> torch.Tensor:
    """Causal LM loss.  batch: tokens/labels [B, S]."""
    x = lm_hidden(cfg, params, batch["tokens"], impl=impl)
    unemb = params.get("unembed", params["embed"])
    return chunked_xent(lambda h, e: _logits(cfg, h, e), x, unemb,
                        batch["labels"], chunk=xent_chunk)


# --------------------------------------------------------------------------
# decode (serve_step)
# --------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, seq_len: int,
                      dtype=torch.bfloat16, device=None) -> dict:
    """Per-layer stacked decode state, zeros: KV caches [L, batch, S, Hkv,
    hd] in ``dtype`` (a sliding-window arch keeps only ``window`` slots, a
    ring buffer) for attention, the SSM state [L, batch, H, P, N] in f32
    for the SSM."""
    require_ported(cfg)
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


def decode_step(cfg: ModelConfig, params, cache: dict, tokens,
                cache_len: int):
    """One decode step: tokens [B, 1] at position ``cache_len``.

    Sliding-window archs index the cache modulo the window (ring buffer);
    the SSM state is O(1).  Returns (logits [B, V] f32, cache); the cache
    is updated in place (see ``attention.attention``; each layer's SSM
    state is overwritten with its new value).
    """
    require_ported(cfg)
    emb = params["embed"]
    x = embed(emb, tokens).to(torch.bfloat16)               # [B, 1, d]
    cache_len = int(cache_len)
    positions = torch.full((1,), cache_len, dtype=torch.int32,
                           device=x.device)
    window = cfg.sliding_window
    if window:
        slot = cache_len % window                  # ring-buffer slot
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
    logits = (x @ unemb.T)[:, 0, :cfg.vocab]
    return logits.float(), cache

