"""One step's FLOPs, bytes, collective traffic and peak memory per
device, counted over the ops it dispatches (counterpart of
``repro/interconnect/hlo_traffic.py::analyze_hlo`` for the dry run).

The reference reads these numbers from the compiled HLO text, with while
bodies multiplied by their trip counts.  The port has no compiled program:
``StepAnalysis`` is a ``TorchDispatchMode`` that sees every op rank 0 runs
— the forward, the backward and the remat recompute, as they run — on its
local tensors.  On DTensors the mode steps aside (it returns
``NotImplemented``), so that DTensor lowers each op to the local op and
the functional collectives of its redistributions, which the mode then
sees; the ops DTensor runs on global-shape fakes to derive an output's
metadata are not counted.  Under ``FakeTensorMode`` nothing is allocated
and no collective moves data; on real tensors the counts are the same.

  * ``flops_per_dev``: dot FLOPs only, 2 * prod(out) * contraction, over
    ``mm``/``addmm``/``bmm``/``baddbmm`` (and ``mv``/``dot``), which
    ``einsum``, ``matmul`` and ``linear`` lower to;
  * ``bytes_per_dev``: bytes written by compute ops, an HBM-traffic proxy:
    views, copies, casts, fills and factories are excluded, as the
    reference's ``_BYTES_DENY`` excludes them;
  * ``coll_bytes_per_dev`` / ``coll_by_op``: each functional collective's
    wire bytes per device by the reference's rule (``_match_collective``)
    with ``g`` its group's size: all-reduce 2 * in * (g-1)/g, all-gather
    max(out, in) * (g-1)/g, reduce-scatter and all-to-all in * (g-1)/g,
    otherwise in.  A ``collective-permute`` (``lax.ppermute``) has no
    functional op of its own: it is an ``all_to_all_single`` whose split
    sizes send to at most one peer and receive from at most one
    (``torch.distributed._functional_collectives.permute_tensor``'s form,
    and ``train/pipeline.py``'s hand-off), and counts as its buffer, the
    larger of the bytes it sends and receives (a rank at an end of the
    pipe sends or receives nothing, where XLA's SPMD program gives every
    device the same operand), as the reference counts its operand;
  * ``peak_live_bytes``: the peak of the bytes of live storages the step
    made (the arguments' own storages excluded), freed as their last
    reference dies; ``peak_mem_per_dev`` adds the arguments' bytes;
  * ``read_arg_bytes``: the bytes of the arguments some op other than a
    view reads (an argument no op reads is dropped from a compiled
    program, as ``jit`` prunes unused arguments).

``calls`` is the step's collective sequence (the counterpart of
``hlo_traffic.collective_sequence``): one ``CollectiveCall`` per counted
collective, in dispatch order, by the reference's rules: the payload is
the gathered output of an all-gather and the operand bytes of any other
op, ``group_size`` the group's size, ``stride`` the gap between the
group's first two global ranks (1 for contiguous ranks), ``repeat`` 1 (an
eager step runs every iteration that XLA keeps in a ``while``; no run of
calls is folded).  ``step_collectives`` runs a step and returns it, and
``workloads/graph.py`` lowers it to a trace.
"""
from __future__ import annotations

import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.interconnect.hlo_traffic import CollectiveCall

aten = torch.ops.aten

# dot ops: (op, kind) — kind names how to read the contraction
_DOTS = {aten.mm.default: "mm", aten.addmm.default: "addmm",
         aten.bmm.default: "bmm", aten.baddbmm.default: "baddbmm",
         aten.mv.default: "mv", aten.dot.default: "dot"}

# ops whose outputs are not counted as written bytes: casts, copies,
# layout changes, fills and factories (the reference's ``_BYTES_DENY``:
# parameter, constant, broadcast, copy, convert, transpose, reshape, iota)
_BYTES_DENY = {
    "_to_copy", "copy", "copy_", "clone", "contiguous", "_copy_from",
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "zeros", "zeros_like", "new_zeros", "ones",
    "ones_like", "new_ones", "full", "full_like", "new_full", "fill",
    "fill_", "zero_", "scalar_tensor", "arange", "lift_fresh",
    "lift_fresh_copy", "detach", "alias", "expand", "t", "transpose",
    "permute", "view", "_unsafe_view", "reshape", "unsqueeze", "squeeze",
    "_local_scalar_dense", "wait_tensor", "set_", "resize_",
}

# DTensor's derivation of an op's global output metadata: it runs the op
# on fake tensors of the global shapes (torch 2.11 and 2.13; a torch
# without it fails the cell rather than count those runs)
_META_PROPAGATION = "_propagate_tensor_meta_non_cached"

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
    "broadcast_": "broadcast",
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def dot_flops(func, args, out) -> float:
    """2 * prod(out) * contraction of one dot op, else 0."""
    kind = _DOTS.get(func)
    if kind is None:
        return 0.0
    if kind in ("mm", "bmm", "mv", "dot"):
        k = args[0].shape[-1]
    else:                                   # addmm / baddbmm: (bias, a, b)
        k = args[1].shape[-1]
    return 2.0 * out.numel() * k


def _group_ranks(name) -> list:
    """The global ranks of the group called ``name``."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    return dist.get_process_group_ranks(_resolve_process_group(name))


def _is_permute(args) -> bool:
    """Whether an ``all_to_all_single``'s split sizes send to at most one
    peer and receive from at most one."""
    out_splits, in_splits = args[1], args[2]
    return (sum(1 for n in in_splits if n) <= 1
            and sum(1 for n in out_splits if n) <= 1)


def collective_call(func, args, out):
    """``(CollectiveCall, wire bytes per device)`` of a functional
    collective, else None; the reference's ``_match_collective`` and
    ``collective_sequence`` rules (module docstring)."""
    if func.namespace != "_c10d_functional":
        return None
    name = func._opname
    kind = _COLLECTIVES.get(name)
    if kind is None:
        return None
    ranks = _group_ranks(args[-1])
    g = len(ranks)
    if g <= 1:
        return None
    if kind == "all-to-all" and _is_permute(args):
        kind = "collective-permute"
    in_b = sum(nbytes(t) for t in _tensors(args[0]))
    out_b = sum(nbytes(t) for t in _tensors(out))
    frac = (g - 1) / g
    if kind == "collective-permute":
        in_b = max(in_b, out_b)
    if kind == "all-reduce":
        b = 2 * in_b * frac
    elif kind == "all-gather":
        b = max(out_b, in_b) * frac
    elif kind in ("reduce-scatter", "all-to-all"):
        b = in_b * frac
    else:
        b = in_b
    stride = ranks[1] - ranks[0] if ranks[1] > ranks[0] else 1
    payload = out_b if kind == "all-gather" else in_b
    return CollectiveCall(kind, float(payload), g, 1, stride=stride), b


@dataclasses.dataclass
class StepStats:
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    coll_by_op: dict
    n_collectives: int
    peak_live_bytes: int
    arg_bytes: int
    read_arg_bytes: int        # of the arguments some compute op reads

    @property
    def peak_mem_per_dev(self) -> int:
        return self.arg_bytes + self.peak_live_bytes


class StepAnalysis(TorchDispatchMode):
    """Count what rank 0's ops do while the mode is active (see the
    module docstring).  ``args``: the step's argument tensors (DTensors or
    plain), whose local storages are the arguments' bytes and are not
    counted as live."""

    def __init__(self, args=()):
        super().__init__()
        from torch.distributed.tensor import DTensor
        self._dtensor = DTensor
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = 0.0
        self.coll_by_op: dict = {}
        self.n_coll = 0
        self.calls: list = []               # CollectiveCall, in order
        self.wires: list = []               # each call's wire bytes
        self.live = 0
        self.peak = 0
        self._meta = 0
        self._seen: dict = {}
        self.arg_bytes = 0
        self._args: dict = {}               # storage id -> [bytes, read]
        for t in args:
            local = t._local_tensor if isinstance(t, DTensor) else t
            s = local.untyped_storage()
            if id(s) not in self._seen:
                self._seen[id(s)] = weakref.ref(s)
                self.arg_bytes += s.nbytes()
            self._args.setdefault(id(s), [0, False])[0] += nbytes(local)

    def _track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = id(s)
        ref = self._seen.get(key)
        if ref is not None and ref() is s:
            return
        n = s.nbytes()
        self._seen[key] = weakref.ref(s)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(s, self._free, key, n)

    def _free(self, key, n) -> None:
        self.live -= n
        self._seen.pop(key, None)

    def __enter__(self):
        # DTensor derives an op's output metadata by running it on fake
        # tensors of the global shapes: those runs are not rank 0's work
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        self._unpatched = getattr(SP, _META_PROPAGATION)
        setattr(SP, _META_PROPAGATION, self._aside(self._unpatched))
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        setattr(SP, _META_PROPAGATION, self._unpatched)
        return super().__exit__(*exc)

    def _aside(self, fn):
        def wrapped(*args, **kwargs):
            self._meta += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self._meta -= 1
        return wrapped

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        if self._meta:
            return func(*args, **(kwargs or {}))
        out = func(*args, **(kwargs or {}))
        self.flops += dot_flops(func, args, out)
        coll = collective_call(func, args, out)
        if coll is not None:
            call, b = coll
            self.coll += b
            self.coll_by_op[call.op] = self.coll_by_op.get(call.op, 0.0) + b
            self.n_coll += 1
            self.calls.append(call)
            self.wires.append(b)
        outs = list(_tensors(out))
        mutates = func._schema.is_mutable
        view = any(a.alias_info is not None and not a.alias_info.is_write
                   for a in func._schema.arguments)
        if outs and not view:               # an argument read by compute
            for t in _tensors(list(args) + list((kwargs or {}).values())):
                rec = self._args.get(id(t.untyped_storage()))
                if rec is not None:
                    rec[1] = True
        if func._opname not in _BYTES_DENY and not mutates and not view:
            self.bytes += sum(nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        return out

    def stats(self) -> StepStats:
        return StepStats(self.flops, self.bytes, self.coll,
                         dict(self.coll_by_op), self.n_coll, self.peak,
                         self.arg_bytes,
                         sum(b for b, read in self._args.values() if read))


def analyze(fn, *args, arg_tensors=()):
    """``(fn(*args), StepStats)``: ``fn`` run once under a
    ``StepAnalysis`` of ``arg_tensors``."""
    mode = StepAnalysis(arg_tensors)
    with mode:
        out = fn(*args)
    return out, mode.stats()


def step_collectives(fn, *args) -> list:
    """The collective sequence of ``fn(*args)`` run once under a
    ``StepAnalysis``: a list of ``CollectiveCall`` in dispatch order (the
    counterpart of ``hlo_traffic.collective_sequence``)."""
    mode = StepAnalysis()
    with mode:
        fn(*args)
    return list(mode.calls)


def flat_tensors(tree) -> list:
    """The tensors of nested dicts / tuples / NamedTuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in flat_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in flat_tensors(v)]
    return []


def local_bytes(t: torch.Tensor) -> int:
    """Bytes of a tensor's shard on this rank (the whole plain tensor)."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        return math.prod(t._local_tensor.shape) * t.element_size()
    return nbytes(t)
