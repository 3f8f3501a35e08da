"""The collective sequence of a port step (``interconnect/graph_traffic.py``
``StepAnalysis.calls`` / ``step_collectives``) and the traces built from
it (``workloads/graph.py``), against the HLO route.

- fig7's psum step in the port (``graph.psum_step``: one combined
  all-reduce of 2 x f32[4, 64] over a 4-rank axis) has the sequence
  ``hlo_traffic.collective_sequence`` reads from the reference's
  compiled step (``tests/torch_fixtures/fig7_psum.hlo.txt``), and its
  trace (``graph.psum_trace``) equals ``trace_from_hlo`` of that text
  phase by phase and message by message, on the wireless 4C4M map of
  fig7 (16 devices).  Two planted faults must change the trace: the two
  sums left uncombined, and the step's group a 2-rank one of stride 2.
- A row-parallel product of DTensors (``layers.dot``, x split on its
  contraction) on a fake (2, 2) ("data", "model") mesh, its pending sum
  reduced: one all-reduce of the local output's bytes over the 2 ranks of
  the axis split, stride 1 on "model" and 2 on "data".
- An ``all_to_all_single`` that sends to one peer and receives from one
  is a ``collective-permute`` of its buffer; with even splits it is an
  all-to-all.
- Each counted collective is one call, in dispatch order, with the wire
  bytes ``coll_by_op`` sums.
"""
import pathlib

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.distributed._functional_collectives as funcol  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.core.constants import Fabric  # noqa: E402
from repro_torch.core.topology import build_xcym  # noqa: E402
from repro_torch.interconnect import graph_traffic as gt  # noqa: E402
from repro_torch.interconnect.hlo_traffic import (  # noqa: E402
    CollectiveCall, collective_sequence)
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.workloads import graph  # noqa: E402
from repro_torch.workloads.hlo import trace_from_hlo  # noqa: E402
from repro_torch.workloads.mapping import DeviceMap  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
HLO = (ROOT / "tests" / "torch_fixtures" / "fig7_psum.hlo.txt").read_text()
N_DEV = 16                           # fig7: 16 devices on 4C4M


@pytest.fixture
def dm():
    return DeviceMap(build_xcym(4, 4, Fabric.WIRELESS), N_DEV)


@pytest.fixture
def fake4():
    M.init_fake(4)
    try:
        yield
    finally:
        M.shutdown()


def _same(a, b) -> bool:
    return (a.name, a.n_devices, a.phases, a.meta) == \
        (b.name, b.n_devices, b.phases, b.meta)


def _psum_args(group) -> tuple:
    return (torch.empty((graph.PSUM_ROWS, graph.PSUM_WIDTH)),
            torch.empty((graph.PSUM_WIDTH, graph.PSUM_WIDTH)), group)


def _uncombined(x, w, group):
    y = torch.tanh(x @ w)
    return (funcol.wait_tensor(funcol.all_reduce(y, "sum", group)),
            funcol.wait_tensor(funcol.all_reduce(y @ w.T, "sum", group)))


def test_psum_sequence_equals_the_hlo_sequence():
    with graph.psum_inputs("cpu") as args:
        got = gt.step_collectives(graph.psum_step, *args)
    assert got == collective_sequence(HLO, N_DEV)
    assert got == [CollectiveCall("all-reduce", 2 * 4 * 64 * 4.0, 4, 1, 1)]
    assert not dist.is_initialized()            # its fake group is gone


def test_psum_trace_equals_trace_from_hlo(dm):
    want = trace_from_hlo(HLO, dm, name="compiled:psum-step")
    got = graph.psum_trace(dm, "cpu")
    assert _same(got, want)
    assert got.describe() == want.describe()
    assert got.bytes_total() == want.bytes_total()


def test_uncombined_sums_are_rejected(dm, fake4):
    with FakeTensorMode():
        args = _psum_args(dist.group.WORLD)
        calls = gt.step_collectives(_uncombined, *args)
        tr = graph.trace_from_step(_uncombined, args, dm,
                                   "compiled:psum-step")
    assert [c.op for c in calls] == ["all-reduce", "all-reduce"]
    assert not _same(tr, trace_from_hlo(HLO, dm, name="compiled:psum-step"))


def test_a_wrong_group_is_rejected(dm, fake4):
    pair = dist.new_group([0, 2])
    with FakeTensorMode():
        args = _psum_args(pair)
        calls = gt.step_collectives(graph.psum_step, *args)
        tr = graph.trace_from_step(graph.psum_step, args, dm,
                                   "compiled:psum-step")
    assert calls == [CollectiveCall("all-reduce", 2048.0, 2, 1, stride=2)]
    assert not _same(tr, trace_from_hlo(HLO, dm, name="compiled:psum-step"))


def test_psum_step_refuses_a_process_group_it_did_not_make(fake4):
    with pytest.raises(RuntimeError, match="already in one"):
        with graph.psum_inputs("cpu"):
            pass


@pytest.mark.parametrize("axis,stride", [("model", 1), ("data", 2)])
def test_row_parallel_product_is_one_all_reduce(axis, stride):
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.models.layers import dot, reduced
    from repro_torch.sharding import specs as sh
    M.init_fake(4)
    try:
        mesh = M.make_mesh((2, 2), ("data", "model"), device="cpu")
        ax = mesh.mesh_dim_names.index(axis)
        with FakeTensorMode():
            xp = [Replicate(), Replicate()]
            wp = [Replicate(), Replicate()]
            xp[ax], wp[ax] = Shard(1), Shard(0)
            x = sh.as_placed(torch.empty(8, 8), mesh, xp, (8, 16))
            w = sh.as_placed(torch.empty(8, 4), mesh, wp, (16, 4))
            mode = gt.StepAnalysis()
            with mode:
                reduced(dot(x, w))
    finally:
        M.shutdown()
    assert mode.calls == [CollectiveCall("all-reduce", 8 * 4 * 4.0, 2, 1,
                                         stride=stride)]
    assert mode.wires == [2 * 8 * 4 * 4 * (2 - 1) / 2]
    assert mode.coll_by_op == {"all-reduce": sum(mode.wires)}


@pytest.mark.parametrize("splits,op", [
    (([0, 4, 0, 0], [4, 0, 0, 0]), "collective-permute"),
    (([0, 0, 0, 0], [0, 0, 4, 0]), "collective-permute"),
    (([1, 1, 1, 1], [1, 1, 1, 1]), "all-to-all")])
def test_permute_is_recognised_by_its_splits(fake4, splits, op):
    recv, send = splits
    with FakeTensorMode():
        x = torch.empty((sum(send), 3, 5))
        mode = gt.StepAnalysis()
        with mode:
            funcol.wait_tensor(funcol.all_to_all_single(
                x, recv, send, dist.group.WORLD))
    (call,) = mode.calls
    buf = max(sum(send), sum(recv)) * 3 * 5 * 4
    assert (call.op, call.group_size, call.stride) == (op, 4, 1)
    assert call.payload_bytes == (buf if op == "collective-permute"
                                  else sum(send) * 15 * 4)
    assert mode.wires == [buf if op == "collective-permute"
                          else sum(send) * 15 * 4 * 3 / 4]
