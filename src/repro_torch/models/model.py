"""Unified model API used by serve (counterpart of ``repro/models/model.py``).

``Model(cfg)`` wraps the functional pieces in transformer.py and provides:
  - param_shapes() / init(generator)  parameters (shapes / concrete)
  - loss(params, batch)               LM loss (full-sequence forward)
  - init_decode_state() / decode(params, cache, tokens, cache_len)
The reference's sharding and rematerialisation fields (``remat``,
``act_spec``, ``sp_specs``, ``moe_specs``, ``fsdp_gather_specs``) are not
ported: the port runs the forward on one device (ROADMAP A10 for the
mesh, the training slice for remat).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    # attention inner and the SSM's intra-chunk block: naive|blockwise
    # (plain torch) or pallas (the kernels of ``repro_torch.kernels``)
    impl: str = "blockwise"
    xent_chunk: int = 512
    param_dtype: Any = torch.bfloat16

    def param_shapes(self) -> dict:
        return tf.param_shapes(self.cfg)

    def init(self, generator: torch.Generator, device=None) -> dict:
        return tf.init_params(self.cfg, generator, self.param_dtype, device)

    def loss(self, params, batch) -> torch.Tensor:
        return tf.lm_loss(self.cfg, params, batch, impl=self.impl,
                          xent_chunk=self.xent_chunk)

    def init_decode_state(self, batch: int, seq_len: int, device=None):
        return tf.init_decode_state(self.cfg, batch, seq_len,
                                    self.param_dtype, device)

    def decode(self, params, cache, tokens, cache_len):
        return tf.decode_step(self.cfg, params, cache, tokens, cache_len)


def build_model(name_or_cfg, **kw) -> Model:
    if isinstance(name_or_cfg, ModelConfig):
        return Model(name_or_cfg, **kw)
    from repro_torch.configs.base import get_config
    return Model(get_config(name_or_cfg), **kw)
