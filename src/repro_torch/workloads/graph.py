"""Port step -> trace compiler (the torch-graph counterpart of
``workloads/hlo.py``).

``trace_from_step`` runs a step once under
``interconnect/graph_traffic.py``'s ``StepAnalysis``, takes its
collective sequence in dispatch order (``step_collectives``) and lowers it
as ``trace_from_hlo`` lowers a compiled step's: group sizes clipped to the
mapped system, then ``trace_from_collectives``.  No HLO text and no JAX
is involved: the step is the port's own, run on fake tensors of a fake
process group, so nothing is allocated and no collective moves data.

``psum_step`` is fig7's "compiled" psum step (``benchmarks/
fig7_ml_traces.py::_compiled_trace``) in the port: per rank of a 4-rank
axis, x [4, 64] f32 (a [16, 64] batch split on its rows) and w [64, 64]
replicated, ``y = tanh(x @ w)``, then ``pmean(y)`` and ``psum(y @ w.T)``.
XLA's all-reduce combiner compiles the two sums into one tuple all-reduce
of 2 x f32[4, 64] (``tests/torch_fixtures/fig7_psum.hlo.txt``); an eager
step would run two.  The step runs one ``all_reduce_coalesced``, torch's
own form of what the combiner did, so that its sequence is the compiled
step's rather than the extractor guessing which calls to merge.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.interconnect.hlo_traffic import CollectiveCall
from repro_torch.workloads.hlo import trace_from_collectives
from repro_torch.workloads.mapping import DeviceMap
from repro_torch.workloads.trace import Trace

PSUM_RANKS = 4                      # the psum step's axis
PSUM_WIDTH = 64                     # x's columns, w's rows and columns
PSUM_ROWS = 4                       # x's rows on each rank


def trace_from_step(step, args, dm: DeviceMap, name: str) -> Trace:
    """``step(*args)`` run once, its collectives lowered to a trace on
    ``dm``, group sizes clipped to the mapped system as
    ``trace_from_hlo`` clips them."""
    from repro_torch.interconnect.graph_traffic import step_collectives
    calls = [CollectiveCall(c.op, c.payload_bytes,
                            min(c.group_size, dm.n_devices), c.repeat,
                            stride=c.stride)
             for c in step_collectives(step, *args)]
    return trace_from_collectives(calls, dm, name)


def psum_step(x: torch.Tensor, w: torch.Tensor, group) -> tuple:
    """fig7's psum step on one rank of ``group`` (module docstring):
    ``(pmean(y), psum(y @ w.T))`` with ``y = tanh(x @ w)``, both sums one
    combined all-reduce."""
    import torch.distributed._functional_collectives as funcol
    y = torch.tanh(x @ w)
    s_y, s_yw = (funcol.wait_tensor(t) for t in funcol.all_reduce_coalesced(
        [y, y @ w.T], "sum", group))
    return s_y / group.size(), s_yw


@contextlib.contextmanager
def psum_inputs(device=None):
    """``(x, w, group)`` of the psum step for rank 0 of a fake process
    group of ``PSUM_RANKS``, fake tensors under ``FakeTensorMode``
    (nothing is allocated on ``device``: the card by default, raising
    without one; ``"cpu"`` here).  The process must not be in a process
    group yet; the fake one is left on exit."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import device as _device
    from repro_torch.launch import mesh as M
    dev = _device.resolve(device)
    if dist.is_initialized():
        raise RuntimeError("the psum step runs its own fake process "
                           "group: this process is already in one")
    M.init_fake(PSUM_RANKS)
    try:
        with FakeTensorMode():
            yield (torch.empty((PSUM_ROWS, PSUM_WIDTH), dtype=torch.float32,
                               device=dev),
                   torch.empty((PSUM_WIDTH, PSUM_WIDTH), dtype=torch.float32,
                               device=dev), dist.group.WORLD)
    finally:
        M.shutdown()


def psum_trace(dm: DeviceMap, device=None) -> Trace:
    """fig7's "compiled" trace, ``compiled:psum-step``, from the port's
    own step (``trace_from_hlo`` of the reference's HLO text otherwise)."""
    with psum_inputs(device) as args:
        return trace_from_step(psum_step, args, dm,
                               name="compiled:psum-step")
