"""Synthetic DNN-layer trace generator.

For model configs too big to compile on CPU (405B-class dense, 8x22B MoE),
generate the per-layer collective schedule analytically from the
``ModelConfig`` instead of from compiled HLO, with the standard 2D layout
on an ``XCYM`` system:

  tensor parallelism   within a chip (the fast domain): two activation
                       all-reduces per layer per direction (Megatron-style
                       attention + MLP), payload ``tokens * d_model * dtype``
                       per device;
  data parallelism     across chips (the slow domain): one gradient
                       all-reduce per layer over same-TP-rank devices,
                       payload ``layer_params * dtype / tp`` per device.

The emitted collective stream per layer is

    fwd: AR(act) x2  ->  bwd: AR(act) x2  ->  grad: AR(params/tp)

which reproduces the byte totals of the analytic wire-byte model
(``interconnect.hlo_traffic``) for a TP+DP step to first order — the point
is not FLOP fidelity but a *traffic* program with the right shape, sizes
and dependency structure.  ``n_layers_cap`` truncates deep stacks (layers
are homogeneous; a prefix is representative and keeps trace size bounded).

A copy of ``repro.workloads.synthetic`` (the JAX package's module, which imports no JAX).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.interconnect.hlo_traffic import CollectiveCall
from repro_torch.workloads.hlo import trace_from_collectives
from repro_torch.workloads.mapping import DeviceMap
from repro_torch.workloads.trace import Trace


def layer_collectives(cfg: ModelConfig, dm: DeviceMap, tokens: int,
                      dtype_bytes: int = 2,
                      n_layers_cap: int | None = 4) -> list[CollectiveCall]:
    """Per-layer collective stream for a TP-in-chip / DP-across-chip step."""
    n = dm.n_devices
    tp = max(1, n // max(1, dm.topo.n_chips))       # devices per chip
    dp = max(1, n // tp)
    layers = min(cfg.n_layers, n_layers_cap or cfg.n_layers)
    act_bytes = float(tokens) * cfg.d_model * dtype_bytes
    layer_params = cfg.n_active_params() / max(cfg.n_layers, 1)
    grad_bytes = layer_params * dtype_bytes / tp
    calls: list[CollectiveCall] = []
    for _ in range(layers):
        if tp > 1:
            calls += [CollectiveCall("all-reduce", act_bytes, tp)] * 2  # fwd
            calls += [CollectiveCall("all-reduce", act_bytes, tp)] * 2  # bwd
        if dp > 1:
            # DP groups are strided (one member per chip): the gradient
            # sync is the cross-fabric traffic the paper's comparison
            # hinges on
            calls.append(CollectiveCall("all-reduce", grad_bytes, dp,
                                        stride=tp))
    return calls


def synthetic_dnn_trace(cfg: ModelConfig, dm: DeviceMap, tokens: int = 4096,
                        dtype_bytes: int = 2, schedule: str = "auto",
                        bytes_scale: float = 1.0,
                        n_layers_cap: int | None = 4,
                        residency: bool = False) -> Trace:
    calls = layer_collectives(cfg, dm, tokens, dtype_bytes, n_layers_cap)
    tr = trace_from_collectives(
        calls, dm, name=f"syn:{cfg.name}", schedule=schedule,
        bytes_scale=bytes_scale, residency=residency)
    tr.meta.update(source="synthetic", model=cfg.name, tokens=tokens,
                   n_layers=min(cfg.n_layers, n_layers_cap or cfg.n_layers))
    return tr
