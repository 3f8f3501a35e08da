"""Logical-node -> switch binding for trace emission.

``DeviceMap`` places a trace's logical devices onto the core switches of a
concrete ``XCYM`` system and resolves memory-stack nodes to the stacks'
logic-die switches:

- devices are block-assigned to chips (device ``d`` lives on chip
  ``d * n_chips // n_devices``) so collective groups have a well-defined
  intra-chip ("fast") / cross-chip ("slow") split — the structure the
  hierarchical schedules of ``interconnect.scheduler`` exploit;
- within a chip, devices spread round-robin over that chip's core switches
  (several logical devices may share one core when the trace has more
  devices than the system has cores — the home core then serializes their
  injections, modeling a shared NIC);
- parameter/activation *residency*: each device is bound to a memory stack
  (round-robin by chip, matching the paper's side-mounted stack placement)
  so residency traffic (stack <-> device) has a stable endpoint.

A copy of ``repro.workloads.mapping`` (the JAX package's module, which imports no JAX).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.topology import Topology
from repro_torch.workloads.trace import is_mem_node, mem_stack


@dataclasses.dataclass
class DeviceMap:
    topo: Topology
    n_devices: int

    def __post_init__(self) -> None:
        topo = self.topo
        if self.n_devices < 1:
            raise ValueError("need at least one device")
        core_sw = np.nonzero(topo.is_core)[0].astype(np.int32)
        mem_sw = np.nonzero(topo.is_mem)[0].astype(np.int32)
        n = self.n_devices
        # block-assign devices to chips, round-robin over the chip's cores
        self.dev_chip = (np.arange(n) * topo.n_chips // n).astype(np.int32)
        self.dev_switch = np.zeros(n, np.int32)
        for c in range(topo.n_chips):
            devs = np.nonzero(self.dev_chip == c)[0]
            cores = core_sw[topo.chip_of[core_sw] == c]
            for j, d in enumerate(devs):
                self.dev_switch[d] = cores[j % len(cores)]
        # residency: stack for device d, round-robin (stacks are shared)
        if topo.n_mem:
            self.dev_mem = mem_sw[np.arange(n) % len(mem_sw)].astype(np.int32)
        else:
            self.dev_mem = np.full(n, -1, np.int32)
        self.mem_switch = mem_sw
        self.serving_wi = topo.serving_wi()

    def node_switch(self, node: int) -> int:
        """Switch id of a logical node (device or MEM_NODE)."""
        if is_mem_node(node):
            j = mem_stack(node)
            if j >= len(self.mem_switch):
                raise ValueError(f"memory node {j} but only "
                                 f"{len(self.mem_switch)} stacks")
            return int(self.mem_switch[j])
        return int(self.dev_switch[node])

    def node_chip(self, node: int) -> int:
        return int(self.topo.chip_of[self.node_switch(node)])

    def same_chip(self, a: int, b: int) -> bool:
        return self.node_chip(a) == self.node_chip(b)

    def wi_of_node(self, node: int) -> int:
        """WI serving the node's switch (-1 on wireline fabrics)."""
        return int(self.serving_wi[self.node_switch(node)])

    def devices_on_chip(self, chip: int) -> np.ndarray:
        return np.nonzero(self.dev_chip == chip)[0]
