"""Unified model API used by train and serve (counterpart of
``repro/models/model.py``).

``Model(cfg)`` wraps the functional pieces in transformer.py and provides:
  - param_shapes() / param_specs() / init(generator)
                                      parameters (shapes / meta tensors /
                                      concrete)
  - loss(params, batch)               LM loss (full-sequence forward)
  - init_decode_state() / decode(params, cache, tokens, cache_len)
  - input_specs(shape) / make_inputs(shape, generator)
                                      inputs of one step of ``shape.kind``,
                                      the modality-frontend stubs included
The reference's sharding fields (``act_spec``, ``sp_specs``,
``moe_specs``, ``fsdp_gather_specs``) are passed down to the layers, which
pin activations and parameters to them with ``layers.constrain``
(identity on plain tensors, a redistribute on DTensors).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import transformer as tf


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    # attention inner and the SSM's intra-chunk block: naive|blockwise
    # (plain torch) or pallas (the kernels of ``repro_torch.kernels``;
    # forward only, as the reference's Pallas kernels are)
    impl: str = "blockwise"
    remat: str = "none"           # none|dots|full|block
    xent_chunk: int = 512
    param_dtype: Any = torch.bfloat16
    act_spec: Any = None          # PartitionSpec for [B,S,d] activations
    sp_specs: Any = None          # (q_spec, kv_spec) seq-parallel attention
    moe_specs: Any = None         # (buf_spec, tok_spec, groups) dispatch
    fsdp_gather_specs: Any = None  # per-layer gathered param specs

    def param_shapes(self) -> dict:
        return tf.param_shapes(self.cfg)

    def param_specs(self) -> dict:
        return tf.param_specs(self.cfg, self.param_dtype)

    def init(self, generator: torch.Generator, device=None) -> dict:
        return tf.init_params(self.cfg, generator, self.param_dtype, device)

    def loss(self, params, batch) -> torch.Tensor:
        return tf.lm_loss(self.cfg, params, batch, impl=self.impl,
                          remat=self.remat, xent_chunk=self.xent_chunk,
                          act_spec=self.act_spec, sp_specs=self.sp_specs,
                          moe_specs=self.moe_specs,
                          fsdp_gather_specs=self.fsdp_gather_specs)

    def init_decode_state(self, batch: int, seq_len: int, device=None):
        return tf.init_decode_state(self.cfg, batch, seq_len,
                                    self.param_dtype, device)

    def decode_state_specs(self, batch: int, seq_len: int) -> dict:
        return tf.decode_state_specs(self.cfg, batch, seq_len,
                                     self.param_dtype)

    def decode(self, params, cache, tokens, cache_len):
        return tf.decode_step(self.cfg, params, cache, tokens, cache_len,
                              act_spec=self.act_spec)

    # ---- input stand-ins ------------------------------------------------

    def input_specs(self, shape: ShapeSpec) -> dict:
        """Inputs of one step of ``shape.kind`` as ``{name: (shape,
        dtype)}`` (the reference's ``ShapeDtypeStruct``s).

        train/prefill: full-sequence tokens (+labels for train).
        decode: one new token per sequence (+ cache handled separately).
        Modality stubs: whisper gets precomputed audio-frame embeddings
        and at most 448 decoder tokens, llava precomputed patch
        embeddings.
        """
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        i32 = torch.int32
        if shape.kind not in ("train", "prefill"):
            return {"tokens": ((B, 1), i32), "cache_len": ((), i32)}
        if cfg.family == "encdec":
            S = min(S, 448)          # whisper's decoder context
        spec = {"tokens": ((B, S), i32)}
        if shape.kind == "train":
            spec["labels"] = ((B, S), i32)
        if cfg.family == "encdec":
            spec["frames"] = ((B, cfg.audio_frames_default, cfg.d_model),
                              torch.float32)
        if cfg.family == "vlm":
            spec["patches"] = ((B, cfg.vlm_patches_default, cfg.d_model),
                               torch.float32)
        return spec

    def make_inputs(self, shape: ShapeSpec,
                    generator: torch.Generator) -> dict:
        """Random inputs matching ``input_specs``, drawn in its order from
        ``generator`` on the generator's device: ids uniform in
        ``[0, vocab)``, embeddings N(0, 1), ``cache_len`` 0."""
        dev = generator.device
        out = {}
        for name, (s, dtype) in self.input_specs(shape).items():
            if dtype == torch.int32 and s:
                out[name] = torch.randint(0, self.cfg.vocab, s,
                                          generator=generator, device=dev,
                                          dtype=dtype)
            elif dtype == torch.int32:
                out[name] = torch.zeros((), dtype=dtype, device=dev)
            else:
                out[name] = torch.randn(s, generator=generator, device=dev,
                                        dtype=dtype)
        return out


def build_model(name_or_cfg, **kw) -> Model:
    if isinstance(name_or_cfg, ModelConfig):
        return Model(name_or_cfg, **kw)
    from repro_torch.configs.base import get_config
    return Model(get_config(name_or_cfg), **kw)
