"""HLO analysis: trip-count-aware FLOPs, bytes and collective traffic.

``compiled.cost_analysis()`` on the CPU backend counts a ``while`` body
(i.e. every ``lax.scan`` — our layer stacks!) exactly once, so we analyze
the optimized HLO text ourselves:

  * build the computation call graph (while bodies, fusions, calls),
  * recover loop trip counts from the loop condition's integer literal
    (the standard XLA lowering of lax.scan),
  * per computation, count dot FLOPs (2 * prod(out) * contraction),
    instruction output bytes (an HBM-traffic proxy) and collective wire
    bytes per device (ring-algorithm costs),
  * aggregate over the call graph with multipliers.

Wire-byte model per device for group size g:
    all-reduce         2 * bytes * (g-1)/g
    all-gather         out_bytes * (g-1)/g
    reduce-scatter     in_bytes * (g-1)/g
    all-to-all         bytes * (g-1)/g
    collective-permute bytes

A copy of ``repro.interconnect.hlo_traffic`` (the JAX package's module, which imports no JAX).
"""
from __future__ import annotations

import dataclasses
import re
from collections import defaultdict

_DT_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([\d,]*)\]")
_INSTR_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w\.\-]+)\s*=\s*(.*)$")
_CALLED_RE = re.compile(
    r"(?:body|condition|to_apply|calls)=\{?%?([\w\.\-]+)")
_COLL_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")


def _first_shape(text: str):
    """First dtype[dims] in text -> (bytes, dims) or None."""
    m = _SHAPE_RE.search(text)
    if not m or m.group(1) not in _DT_BYTES:
        return None
    dims = [int(d) for d in m.group(2).split(",") if d]
    n = 1
    for d in dims:
        n *= d
    return n * _DT_BYTES[m.group(1)], dims


def _all_shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        if dt not in _DT_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DT_BYTES[dt]
    return total


def _group_size(line: str, default: int) -> int:
    m = re.search(r"replica_groups=\{\{([\d,]+)\}", line)
    if m:
        return len(m.group(1).split(","))
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]", line)
    if m:                       # iota format [ngroups, group_size]
        return int(m.group(2))
    return default


def _group_stride(line: str) -> int:
    """Rank stride of explicit replica groups (1 for contiguous/iota)."""
    m = re.search(r"replica_groups=\{\{([\d,]+)\}", line)
    if m:
        ids = [int(x) for x in m.group(1).split(",") if x]
        if len(ids) >= 2 and ids[1] > ids[0]:
            return ids[1] - ids[0]
    return 1


def _match_collective(rhs: str, out_b: int, n_devices: int):
    """(op, in_bytes, wire_bytes, group) if rhs is a collective, else None.

    ``wire_bytes`` is the per-device ring-algorithm cost of the module
    docstring; ``in_bytes`` the raw operand payload (what a schedule
    expander distributes — see ``workloads.schedules``).
    """
    for op in _COLL_OPS:
        if re.search(rf"\b{op}(-start)?\(", rhs) and "-done" not in rhs:
            g = _group_size(rhs, n_devices)
            if g <= 1:
                return None
            in_b = _all_shape_bytes(rhs.split("(", 1)[1])
            frac = (g - 1) / g
            if op == "all-reduce":
                b = 2 * in_b * frac
            elif op == "all-gather":
                b = max(out_b, in_b) * frac
            elif op == "reduce-scatter":
                b = in_b * frac
            elif op == "all-to-all":
                b = in_b * frac
            else:
                b = in_b
            return op, in_b, b, g
    return None


@dataclasses.dataclass(frozen=True)
class CollectiveCall:
    """One collective in compiled execution order (trip-count expanded).

    ``stride`` describes the group's device layout: 1 = contiguous ranks
    (tensor-parallel groups, intra-chip under block device mapping);
    ``stride = s`` groups ranks ``{r, r+s, r+2s, ...}`` (data-parallel
    groups spanning chips — the cross-fabric traffic class).
    """

    op: str
    payload_bytes: float    # per-device payload the schedule distributes
    group_size: int
    repeat: int = 1         # surrounding while-loop trip multiplier
    stride: int = 1         # rank stride of the group members


def collective_sequence(hlo: str, n_devices: int) -> list[CollectiveCall]:
    """Collectives of the entry computation in program order.

    Walks the call graph depth-first in instruction order (while bodies
    multiply ``repeat`` by the recovered trip count) — the execution-ordered
    counterpart of :func:`analyze_hlo`'s aggregate byte totals, consumed by
    ``workloads.hlo.trace_from_hlo`` to build dependency-ordered traffic
    phases.  Payload for all-gather is the gathered output; for the other
    ops the operand bytes.
    """
    comps = _parse_computations(hlo)
    trip: dict[str, int] = {}
    for name, lines in comps.items():
        for line in lines:
            if not re.search(r"while\(", line):
                continue
            bm = re.search(r"body=\{?%?([\w\.\-]+)", line)
            cm = re.search(r"condition=\{?%?([\w\.\-]+)", line)
            if bm:
                t = _trip_count(comps.get(cm.group(1), [])) if cm else 1
                trip[bm.group(1)] = max(trip.get(bm.group(1), 1), t)

    out: list[CollectiveCall] = []

    def walk(name: str, mult: int, stack: tuple) -> None:
        if name not in comps or name in stack:
            return
        for line in comps[name]:
            m = _INSTR_RE.match(line)
            if not m:
                continue
            rhs = m.group(2)
            fs = _first_shape(rhs)
            out_b = fs[0] if fs else 0
            mc = _match_collective(rhs, out_b, n_devices)
            if mc is not None:
                op, in_b, _wire, g = mc
                payload = out_b if op == "all-gather" else in_b
                out.append(CollectiveCall(op, float(payload), g, mult,
                                          stride=_group_stride(rhs)))
                continue
            for c in _CALLED_RE.findall(line):
                # classify body BEFORE condition: both substrings appear on
                # a while line and the body name trails the condition's
                if "body=" in line and c in line.split("body=")[1]:
                    walk(c, mult * trip.get(c, 1), stack + (name,))
                    continue
                if "condition=" in line and c in line.split("condition=")[1]:
                    continue                    # trip counting only
                walk(c, mult, stack + (name,))

    walk(_entry_name(hlo, comps), 1, ())
    return out


@dataclasses.dataclass
class CompStats:
    flops: float = 0.0
    out_bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_op: dict = dataclasses.field(default_factory=dict)
    calls: list = dataclasses.field(default_factory=list)  # (callee, kind)


@dataclasses.dataclass
class HloStats:
    flops_per_dev: float
    hbm_bytes_per_dev: float
    coll_bytes_per_dev: float
    coll_by_op: dict
    n_collectives: int


def _parse_computations(hlo: str) -> dict[str, list[str]]:
    """Split the module into computations.

    The HLO pretty-printer puts computation headers at column 0 (ending in
    '{'), indents instructions, and closes with '}' at column 0.  Header
    signatures may contain nested parens (tuple types), so we key off the
    indentation rather than trying to parse the signature."""
    comps: dict[str, list[str]] = {}
    cur = None
    for line in hlo.splitlines():
        if line and not line[0].isspace():
            if line.rstrip().endswith("{"):
                m = re.match(r"^(?:ENTRY\s+)?%?([\w\.\-]+)", line)
                if m:
                    cur = m.group(1)
                    comps[cur] = []
                continue
            if line.startswith("}"):
                cur = None
                continue
        if cur is not None:
            comps[cur].append(line)
    return comps


def _entry_name(hlo: str, comps) -> str:
    m = re.search(r"^ENTRY\s+%?([\w\.\-]+)", hlo, re.M)
    if m and m.group(1) in comps:
        return m.group(1)
    # fall back: computation named like main
    for name in comps:
        if "main" in name:
            return name
    return next(iter(comps))


_BYTES_DENY = re.compile(
    r"\b(parameter|constant|tuple|get-tuple-element|bitcast|while|"
    r"conditional|call|iota|after-all|copy-start|copy-done|broadcast|"
    r"copy|convert|transpose|reshape|partition-id|replica-id)\(")


def _analyze_comp(lines: list[str], n_devices: int) -> CompStats:
    st = CompStats()
    shapes: dict[str, list[int]] = {}
    for line in lines:
        m = _INSTR_RE.match(line)
        if not m:
            continue
        name, rhs = m.group(1), m.group(2)
        fs = _first_shape(rhs)
        if fs is None:
            continue
        out_b, out_dims = fs
        shapes[name] = out_dims
        # HBM-traffic proxy: bytes written by compute kernels.  Control-flow
        # wrappers and layout artifacts (copy/convert/transpose fuse away on
        # TPU) are excluded.
        if not _BYTES_DENY.search(rhs):
            st.out_bytes += _all_shape_bytes(rhs.split("(", 1)[0]) or out_b

        # called computations
        for c in _CALLED_RE.findall(line):
            kind = "body" if "body=" in line and c in line.split("body=")[1] \
                else ("cond" if "condition=" in line
                      and c in line.split("condition=")[1] else "call")
            st.calls.append((c, kind, line))

        # dot flops.  Newer HLO pretty-printers put operand types inline
        # (``dot(f32[64,64]{1,0} %lhs, ...)``); read the lhs shape from
        # there, falling back to the operand-name lookup of older dumps.
        dm = re.search(
            r"\bdot\((?:([a-z0-9]+)\[([\d,]*)\]\S*\s+)?%?([\w\.\-]+)", rhs)
        if dm:
            cm = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", rhs)
            if dm.group(1) in _DT_BYTES and dm.group(2) is not None:
                lhs_dims = [int(d) for d in dm.group(2).split(",") if d]
            else:
                lhs_dims = shapes.get(dm.group(3))
            k = 1
            if cm and lhs_dims is not None:
                for idx in cm.group(1).split(","):
                    if idx:
                        k *= lhs_dims[int(idx)]
            out_n = 1
            for d in out_dims:
                out_n *= d
            st.flops += 2.0 * out_n * k
        # convolutions (stub frontends only) — approximate via output*k
        cm = re.search(r"\bconvolution\(", rhs)
        if cm:
            out_n = 1
            for d in out_dims:
                out_n *= d
            st.flops += 2.0 * out_n  # negligible in our models

        # collectives
        mc = _match_collective(rhs, out_b, n_devices)
        if mc is not None:
            op, _in_b, b, _g = mc
            st.coll_bytes += b
            st.coll_by_op[op] = st.coll_by_op.get(op, 0.0) + b
    return st


def _trip_count(cond_lines: list[str]) -> int:
    best = 1
    for line in cond_lines:
        for m in re.finditer(r"constant\((\d+)\)", line):
            best = max(best, int(m.group(1)))
    return best


def analyze_hlo(hlo: str, n_devices: int) -> HloStats:
    comps = _parse_computations(hlo)
    stats = {name: _analyze_comp(lines, n_devices)
             for name, lines in comps.items()}

    # while bodies: map body -> trip count (from the paired condition)
    trip: dict[str, int] = {}
    for name, lines in comps.items():
        for line in lines:
            m = re.search(r"while\(", line)
            if not m:
                continue
            bm = re.search(r"body=\{?%?([\w\.\-]+)", line)
            cm = re.search(r"condition=\{?%?([\w\.\-]+)", line)
            if bm:
                t = _trip_count(comps.get(cm.group(1), [])) if cm else 1
                trip[bm.group(1)] = max(trip.get(bm.group(1), 1), t)

    import functools

    @functools.lru_cache(maxsize=None)
    def total(name: str) -> tuple:
        st = stats.get(name)
        if st is None:
            return (0.0, 0.0, 0.0, ())
        f, b, c = st.flops, st.out_bytes, st.coll_bytes
        by = dict(st.coll_by_op)
        for callee, kind, _line in st.calls:
            if callee == name or callee not in stats:
                continue
            cf, cb, cc, cby = total(callee)
            mult = trip.get(callee, 1) if kind == "body" else 1
            f += mult * cf
            b += mult * cb
            c += mult * cc
            for k, v in dict(cby).items():
                by[k] = by.get(k, 0.0) + mult * v
        return (f, b, c, tuple(sorted(by.items())))

    entry = _entry_name(hlo, comps)
    f, b, c, by = total(entry)
    n_coll = sum(len(s.coll_by_op) for s in stats.values())
    return HloStats(flops_per_dev=f, hbm_bytes_per_dev=b,
                    coll_bytes_per_dev=c, coll_by_op=dict(by),
                    n_collectives=n_coll)


# Backwards-compatible wrapper used by dryrun
@dataclasses.dataclass
class CollectiveStats:
    bytes_per_device: float
    by_op: dict
    count: int


def collective_bytes(hlo: str, n_devices: int) -> CollectiveStats:
    st = analyze_hlo(hlo, n_devices)
    return CollectiveStats(bytes_per_device=st.coll_bytes_per_dev,
                           by_op=st.coll_by_op, count=st.n_collectives)
