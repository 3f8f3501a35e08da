"""Trace-driven ML workload subsystem (README "Workloads"); a copy of
``repro.workloads`` (numpy and text only).

Bridges the repo's two halves: the analytic ML collective accounting
(``interconnect/hlo_traffic.py``, ``interconnect/fabric.py``) and the
cycle-accurate multichip simulator (``core/simulator.py``).  A *trace* is a
phase-structured program of point-to-point and multicast messages between
logical nodes (devices / memory stacks); phases are dependency barriers.
Traces come from two producers and feed one consumer:

  producers   ``workloads.hlo`` — compiled-HLO collective sequences expanded
              into ring / one-shot / hierarchical message schedules;
              ``workloads.synthetic`` — analytic DNN-layer traces for model
              configs too big to compile on CPU.
  consumer    ``core.traffic.from_trace`` — fabric-aware emission into a
              ``TrafficTable`` (multicasts ride the shared wireless medium
              once; on wireline they expand into replicated unicasts), run
              through ``core.sweep.run_sweep_batched``.
"""
from repro_torch.workloads.trace import Trace, TraceMessage, TracePhase, MEM_NODE
from repro_torch.workloads.mapping import DeviceMap

__all__ = ["Trace", "TraceMessage", "TracePhase", "MEM_NODE", "DeviceMap"]
