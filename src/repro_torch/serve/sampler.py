"""Token samplers: greedy / temperature / top-k / top-p (counterpart of
``repro/serve/sampler.py``).

Greedy takes the first maximum, as ``jnp.argmax`` does.  Temperature
sampling draws from an explicit ``torch.Generator``; it cannot reproduce
``jax.random.categorical``'s bits, only its distribution.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0      # 0 => greedy
    top_k: int = 0
    top_p: float = 1.0


def sample(logits: torch.Tensor, generator: torch.Generator | None,
           cfg: SamplerConfig) -> torch.Tensor:
    """logits: [B, V] -> token ids [B] (int32)."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / cfg.temperature
    if cfg.top_k:
        kth = torch.topk(logits, cfg.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -math.inf, logits)
    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        idx = (cum < cfg.top_p).sum(-1, keepdim=True)
        V = logits.shape[-1]
        # take_along_axis fills an out-of-range index with NaN, and no
        # logit is below NaN: then nothing is cut
        cutoff = torch.gather(sorted_logits, -1, idx.clamp(max=V - 1))
        cutoff = torch.where(idx < V, cutoff, math.nan)
        logits = torch.where(logits < cutoff, -math.inf, logits)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0] \
        .to(torch.int32)
