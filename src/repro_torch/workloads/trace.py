"""Phase-structured trace IR for ML workload traffic.

A trace is an ordered list of *phases*; each phase is a set of messages that
may fly concurrently, and a phase may only start once every message of the
previous phase has been fully delivered (a dependency barrier — this is what
makes collective schedules like rings, which are chains of dependent
neighbor exchanges, cycle-accurate rather than open-loop).

Nodes are *logical*: device ids ``0..n_devices-1`` for compute devices and
``MEM_NODE(j)`` (negative ids) for in-package memory stacks.  The IR is
deliberately topology-free — ``workloads.mapping.DeviceMap`` binds nodes to
switches of a concrete ``XCYM`` system at emission time
(``core.traffic.from_trace``), which is also where multicast messages are
lowered fabric-aware: one shared-channel transmission on wireless,
replicated unicasts on wireline.

Byte counts are *physical payload bytes*; emission converts them to packets
(``ceil(bytes * scale / pkt_bytes)``, min one packet) so huge training-step
traces can be simulated at a representative scale.

A copy of ``repro.workloads.trace`` (the JAX package's module, which imports no JAX).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence


def MEM_NODE(stack: int) -> int:
    """Logical node id of in-package memory stack ``stack`` (>= 0)."""
    return -(stack + 1)


def is_mem_node(node: int) -> bool:
    return node < 0


def mem_stack(node: int) -> int:
    """Inverse of :func:`MEM_NODE`."""
    return -node - 1


@dataclasses.dataclass(frozen=True)
class TraceMessage:
    """One message: ``src`` sends ``bytes_`` to every node in ``dsts``.

    ``len(dsts) > 1`` is a *multicast*: on a broadcast-capable fabric the
    payload crosses the shared medium once; on wireline it is replicated
    into ``len(dsts)`` unicasts at emission.

    ``op`` extends the IR with closed-loop memory operations:

    - ``"msg"``: plain one-way data (the default, all collectives);
    - ``"read"``: ``src`` (a device) reads ``bytes_`` from the single
      ``MEM_NODE`` destination — emission lowers it to a short request
      plus a service-gated full-size reply (a round trip, both counted
      in the phase's barrier);
    - ``"write"``: ``src`` writes ``bytes_`` to the stack; the stack
      acks with a short packet after bank service.
    """

    src: int
    dsts: tuple[int, ...]
    bytes_: float
    op: str = "msg"

    def __post_init__(self):
        if not self.dsts:
            raise ValueError("message needs at least one destination")
        if self.src in self.dsts:
            raise ValueError(f"self-message: {self.src} -> {self.dsts}")
        if self.op not in ("msg", "read", "write"):
            raise ValueError(f"unknown op {self.op!r}")
        if self.op != "msg":
            if len(self.dsts) != 1 or not is_mem_node(self.dsts[0]):
                raise ValueError(
                    f"{self.op} needs exactly one MEM_NODE destination")
            if is_mem_node(self.src):
                raise ValueError(f"{self.op} source must be a device")

    @property
    def is_multicast(self) -> bool:
        return len(self.dsts) > 1

    @property
    def is_mem_op(self) -> bool:
        return self.op != "msg"


@dataclasses.dataclass(frozen=True)
class TracePhase:
    """Messages that may fly concurrently; barrier w.r.t. the next phase.

    ``label`` groups phases belonging to one logical operation (e.g. one
    collective): per-collective metrics aggregate phase timings by label.
    """

    messages: tuple[TraceMessage, ...]
    label: str = ""

    @property
    def bytes_total(self) -> float:
        return sum(m.bytes_ * len(m.dsts) for m in self.messages)


@dataclasses.dataclass
class Trace:
    """A named, phase-ordered workload trace."""

    name: str
    n_devices: int
    phases: list[TracePhase]
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def n_phases(self) -> int:
        return len(self.phases)

    def bytes_total(self) -> float:
        """Delivered payload bytes (multicasts count once per destination)."""
        return sum(p.bytes_total for p in self.phases)

    def wire_bytes_broadcast(self) -> float:
        """Payload bytes crossing a broadcast medium (multicasts count once)."""
        return sum(m.bytes_ for p in self.phases for m in p.messages)

    def labels(self) -> list[str]:
        return [p.label for p in self.phases]

    def scaled(self, factor: float) -> "Trace":
        """Same trace with every message's bytes scaled by ``factor``
        (emission floors each message at one packet)."""
        phases = [TracePhase(tuple(
            TraceMessage(m.src, m.dsts, m.bytes_ * factor, m.op)
            for m in p.messages), label=p.label) for p in self.phases]
        return Trace(self.name, self.n_devices, phases,
                     {**self.meta, "bytes_scale":
                      self.meta.get("bytes_scale", 1.0) * factor})

    def describe(self) -> str:
        n_msg = sum(len(p.messages) for p in self.phases)
        n_mc = sum(m.is_multicast for p in self.phases for m in p.messages)
        return (f"{self.name}: {self.n_phases} phases, {n_msg} messages "
                f"({n_mc} multicast), {self.bytes_total():.3e} B delivered")


def phase(messages: Iterable[TraceMessage], label: str = "") -> TracePhase:
    return TracePhase(tuple(messages), label=label)


def p2p(src: int, dst: int, bytes_: float) -> TraceMessage:
    return TraceMessage(src, (dst,), bytes_)


def mcast(src: int, dsts: Sequence[int], bytes_: float) -> TraceMessage:
    return TraceMessage(src, tuple(dsts), bytes_)


def mem_read(device: int, stack_node: int, bytes_: float) -> TraceMessage:
    """Closed-loop read: ``device`` fetches ``bytes_`` from ``stack_node``
    (a ``MEM_NODE``); the reply is generated by the stack's bank model."""
    return TraceMessage(device, (stack_node,), bytes_, op="read")


def mem_write(device: int, stack_node: int, bytes_: float) -> TraceMessage:
    """Closed-loop write: data to the stack, short ack after service."""
    return TraceMessage(device, (stack_node,), bytes_, op="write")
