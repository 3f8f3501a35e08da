"""GPipe-style pipeline parallelism over a mesh axis (default: "model")
(counterpart of ``repro/train/pipeline.py``).

The stacked layer parameters [L, ...] are regrouped stage-major
[S, L/S, ...]; the rank at coordinate ``s`` of the pipeline axis runs
stage ``s``.  The schedule is the classic GPipe ramp: M microbatches over
M + S - 1 ticks; stage 0 injects microbatch ``t`` at tick ``t``, every
other stage takes the activation handed over from the previous stage at
the tick before, and the last stage's outputs of ticks S - 1 .. M + S - 2
are the microbatches' results, replicated over the axis by a masked sum.
Stage boundaries are f32 and each stage runs in bf16, as in the reference.

The reference lets ``jax.grad`` differentiate through its ``shard_map``;
here each boundary of the ``shard_map`` is an autograd function that does
what JAX's transpose does there:

- the hand-off (``lax.ppermute`` to the next stage): forward, send to the
  next stage and receive from the previous one (stage 0 gets zeros);
  backward, the reverse permute — the gradient goes back to the previous
  stage.  It is one functional ``all_to_all_single`` over the pipeline
  group that sends the whole buffer to one peer (``_shift``; gloo runs
  its uneven splits too), which ``interconnect/graph_traffic.py`` counts
  as a ``collective-permute``; one autograd node per tick returns both
  the handed buffer and the tick's output (``_Tick``), so that, as in the
  reference's transposed scan, every tick's backward permutes back (the
  last tick's cotangent is zeros) — 2 (M + S - 1) hand-offs a step;
- the replicated result (``psum`` of the masked output, under a
  replicated ``out_specs``): forward, a sum over the axis; backward, the
  gradient unchanged (JAX divides the replicated cotangent by the axis
  size and ``psum``s it back: the same value);
- the replicated microbatches (a replicated ``in_specs``): forward,
  unchanged; backward, the cotangents summed over the axis (only stage 0's
  is not zero);
- the stage's slice of the stacked layers (sharded ``in_specs``): forward,
  this stage's [L/S, ...]; backward, every stage's slice gathered, so that
  each rank holds the whole gradient of ``params["layers"]``, as the
  reference's global gradient is.

Every rank runs the same ticks and the same collectives in the same order
(a stage's idle ticks compute on zeros, as the reference's do), so the
hand-offs match up in both directions.  Plain tensors (gloo ranks, every
rank passing the whole parameters and batch) and DTensors run the same
ramp (``ramp``).

On DTensors (the dry run's placed parameters and batch) the pipeline is
the reference's ``shard_map``: manual on the pipeline axis, automatic on
the others.  Each boundary takes the rank's block on the pipeline axis
(``to_local`` of that mesh dim only) and places it again as a DTensor on
the sub-mesh of the other dims (``_off_axis``), the gradient coming back
placed as the input is: the stage's slice of the layers is the rank's
block of the stacked dim (the reference's ``P(axis)``, its size-1 stage
dim squeezed), and the replicated microbatches' cotangents are summed
over the axis (``_ReplicatedIn``).  So FSDP and the data split behave
inside a stage as GSPMD's automatic axes do.  The microbatches are
``train/loop.py::microbatch``'s rows, and a stage runs them split on
their width (``_boundary``), as the reference's compiled stage does.  The
hand-off and the masked sum run on the stage's local blocks, as
functional collectives.

Trade vs tensor parallelism on the same axis: per-layer all-reduces
(2 * B*S*d bytes each) become one B*S*d hand-off per *stage boundary* —
~2L/S fewer bytes — at the price of the (S-1)/(M+S-1) bubble.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models import transformer as tf
from repro_torch.models.layers import chunked_xent, norm, reduced
from repro_torch.sharding import specs as sh
from repro_torch.train.loop import microbatch

DECODER_ONLY = ("dense", "moe", "ssm", "hybrid")


def _regroup(layers, n_stages: int):
    """[L, ...] -> [S, L/S, ...] (stage-major)."""
    def r(a):
        L = a.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} "
                             "stages")
        return a.reshape((n_stages, L // n_stages) + tuple(a.shape[1:]))
    return {k: _regroup(v, n_stages) if isinstance(v, dict) else r(v)
            for k, v in layers.items()}


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``, a functional all-reduce (which the step
    analysis counts)."""
    return funcol.wait_tensor(funcol.all_reduce(x.contiguous(), "sum",
                                                group))


class _ReplicatedSum(torch.autograd.Function):
    """The sum over the axis of a result every rank then uses alike."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReplicatedIn(torch.autograd.Function):
    """An input every stage receives alike: its gradient is summed."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _StageSlice(torch.autograd.Function):
    """This stage's slice of a stage-major [S, ...] tensor; the gradient
    of the whole tensor is every stage's, gathered."""

    @staticmethod
    def forward(ctx, a, stage, group, order):
        ctx.group, ctx.order = group, order
        return a[stage]

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        parts = [torch.empty_like(g) for _ in ctx.order]
        dist.all_gather(parts, g, group=ctx.group)
        return torch.stack([parts[i] for i in ctx.order]), None, None, None


def _shift(x: torch.Tensor, group, stage: int, n: int, step: int
           ) -> torch.Tensor:
    """Send ``x`` to stage ``stage + step`` and receive a tensor like it
    from ``stage - step`` (zeros where there is none), as one functional
    ``all_to_all_single`` over the pipeline group."""
    rows = x.shape[0]
    send, recv = [0] * n, [0] * n
    if 0 <= stage + step < n:
        send[stage + step] = rows
    else:                               # the end of the pipe sends nothing
        x = x[:0]
    if 0 <= stage - step < n:
        recv[stage - step] = rows
    out = funcol.wait_tensor(funcol.all_to_all_single(
        x.contiguous(), recv, send, group))
    return out if any(recv) else torch.zeros((rows, *x.shape[1:]),
                                             dtype=x.dtype, device=x.device)


class _Tick(torch.autograd.Function):
    """A tick's output and its ``lax.ppermute`` to the next stage, as one
    node: its backward runs whenever either is used, and permutes the
    handed buffer's cotangent back (zeros after the last tick), as the
    reference's transposed scan does at every tick."""

    @staticmethod
    def forward(ctx, y, group, stage, n):
        ctx.group, ctx.stage, ctx.n = group, stage, n
        return _shift(y, group, stage, n, 1), y.view_as(y)

    @staticmethod
    def backward(ctx, g_handed, g_y):
        back = _shift(g_handed, ctx.group, ctx.stage, ctx.n, -1)
        return back + g_y, None, None, None


def _off_axis(t, ax: int, sub, group=None):
    """A DTensor on the whole mesh as a DTensor on ``sub``, the mesh
    without dim ``ax``: the rank's block on ``ax``, the other placements
    kept, the gradient coming back placed as ``t`` is.  ``group``: ``t``
    is replicated over ``ax`` and every stage receives it alike, so its
    cotangents are summed over the axis (``_ReplicatedIn``)."""
    pl = list(t.placements)
    shape = list(t.shape)
    if pl[ax].is_shard():
        shape[pl[ax].dim] //= t.device_mesh.size(ax)
    local = t.to_local(grad_placements=pl)
    if group is not None:
        local = _ReplicatedIn.apply(local, group)
    return sh.as_placed(local, sub, pl[:ax] + pl[ax + 1:], shape)


def _boundary(t):
    """A stage's boundary buffer [Bm, Sq, d] as the reference's compiled
    pipeline lays it out: split on the width over every mesh dim of the
    stage (its hand-off is f32[Bm, Sq, d / 16] a device on the 16 x 16
    pod), which GSPMD takes from the FSDP-split weights.  The layers then
    contract over the split width and run the sequence mixers on whole
    microbatches, as the reference's stage does."""
    from torch.distributed.tensor import Shard
    return sh.with_placements(t, lambda i, p: Shard(2))


def _pipe_ranks(mesh, axis: str) -> list:
    """The global ranks along ``axis`` through this rank, by coordinate."""
    names = mesh.mesh_dim_names
    coord = list(mesh.get_coordinate())
    ranks = []
    for s in range(mesh.mesh.shape[names.index(axis)]):
        coord[names.index(axis)] = s
        ranks.append(int(mesh.mesh[tuple(coord)]))
    return ranks


def make_pp_loss(cfg: ModelConfig, mesh, *, n_stages: int, n_micro: int,
                 axis: str = "model", remat: str = "full",
                 xent_chunk: int = 512, impl: str = "blockwise",
                 device=None):
    """Returns loss_fn(params, batch) running the backbone as a pipeline
    over the ranks of ``mesh``'s ``axis`` (``n_stages`` of them; one
    stage each).  Every rank passes the same (replicated) parameters and
    batch and gets the same loss; its gradients are the whole tree's.

    Only the layer stack is pipelined; embedding / final norm / unembedding
    run replicated over the pipe axis (they are shared pre/post stages).
    Supports the decoder-only families (dense/moe/ssm/hybrid).  ``device``
    is the ranks' device (default the card, raising without one; ``"cpu"``
    for gloo ranks) and must be the mesh's."""
    dev = _device.resolve(device)
    if mesh.device_type != dev.type:
        raise ValueError(f"mesh on {mesh.device_type}, device {dev}")
    if cfg.family not in DECODER_ONLY:
        raise ValueError(f"family {cfg.family!r}: the pipeline runs "
                         f"{DECODER_ONLY}")
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers do not split into "
                         f"{n_stages} stages")
    if axis_sizes(mesh)[axis] != n_stages:
        raise ValueError(f"axis {axis!r} has {axis_sizes(mesh)[axis]} "
                         f"ranks for {n_stages} stages")
    S, M = n_stages, n_micro
    group = mesh.get_group(axis)
    ranks = _pipe_ranks(mesh, axis)
    stage = mesh.get_local_rank(axis)
    # all_gather's outputs come in the group's rank order
    order = [dist.get_group_rank(group, r) for r in ranks]

    def body(x, lp, positions):
        return tf._layer_body(cfg, x, lp, positions=positions, causal=True,
                              impl=impl)

    if remat in ("full", "block"):
        body = tf._checkpointed(body)

    def stage_body(x, layers, positions):
        for lp in layers:
            x = body(x, lp, positions)
        return x

    def ramp(inject, layers, positions, enter=lambda t: t,
             leave=lambda t: t):
        """The GPipe ramp: ``inject(m)`` is microbatch ``m``'s boundary
        buffer (f32), ``enter`` / ``leave`` take a buffer into and out of
        the stage's layout; returns the last stage's outputs [M, ...],
        summed over the axis."""
        # a factory, not ``torch.tensor``: under ``FakeTensorMode`` a
        # constant tensor is made for real on the device first
        first = torch.full((), stage == 0, device=dev)
        buf = None
        ys = []
        for t in range(M + S - 1):
            inj = inject(min(t, M - 1))
            if buf is None:
                buf = torch.zeros_like(inj)
            x_in = enter(torch.where(first, inj, buf))
            y = stage_body(x_in.to(torch.bfloat16), layers, positions)
            buf, y = _Tick.apply(leave(y.float()), group, stage, S)
            ys.append(y)
        # microbatch m finishes on the last stage at tick m + S - 1
        out = torch.stack(ys[S - 1:S - 1 + M])
        mask = 1.0 if stage == S - 1 else 0.0
        return _ReplicatedSum.apply(out * mask, group)

    def pipeline(x, layers_tree, positions):
        """The ramp on DTensors: ``x`` [B, Sq, d] f32 on the whole mesh;
        returns the last stage's outputs, summed over the axis."""
        from torch.distributed.tensor import Replicate, Shard
        names = mesh.mesh_dim_names
        ax = names.index(axis)
        rest = tuple(n for n in names if n != axis)
        sub = mesh[rest if len(rest) > 1 else rest[0]]
        B, Sq, d = x.shape
        xs = _off_axis(reduced(x), ax, sub, group)
        x_mb = [microbatch(xs, M, m) for m in range(M)]
        staged = tf.unflatten((k, _off_axis(a, ax, sub))
                              for k, a in tf.leaves(layers_tree))
        layers = tf.unstack(staged, cfg.n_layers // S)
        out = ramp(lambda m: _boundary(x_mb[m]).to_local(), layers,
                   positions,
                   enter=lambda t: sh.as_placed(t, sub, [Shard(2)] * sub.ndim,
                                                (B // M, Sq, d)),
                   leave=lambda t: _boundary(t).to_local())
        pl = [Replicate() if i == ax else Shard(3) for i in range(len(names))]
        out = sh.as_placed(out, mesh, pl, (M, B // M, Sq, d))
        # the microbatches back in row order, split as the batch is
        whole = sh.with_placements(out, lambda i, p: Replicate())
        return sh.with_placements(whole.reshape(B, Sq, d), lambda i, p:
                                  x.placements[i] if x.placements[i]
                                  .is_shard(0) else p)

    def loss_fn(params, batch):
        emb = params["embed"]
        tokens = batch["tokens"]
        B, Sq = tokens.shape
        if B % M:
            raise ValueError(f"batch of {B} does not split into {M} "
                             "microbatches")
        x = tf.embed(emb, tokens).float()
        positions = torch.arange(Sq, device=dev)
        if sh.is_dtensor(x):
            h = pipeline(x, params["layers"], positions).to(torch.bfloat16)
            return epilogue(h, params, batch)
        x_mb = _ReplicatedIn.apply(x.reshape(M, B // M, Sq, -1), group)
        staged = _regroup(params["layers"], S)
        names, leaves = zip(*tf.leaves(staged))
        mine = tf.unflatten(zip(names, (
            _StageSlice.apply(a, stage, group, order) for a in leaves)))
        layers = tf.unstack(mine, cfg.n_layers // S)
        out = ramp(lambda m: x_mb[m], layers, positions)  # [M, Bm, S, d]
        return epilogue(out.reshape(B, Sq, -1).to(torch.bfloat16), params,
                        batch)

    def epilogue(h, params, batch):
        emb = params["embed"]
        h = norm(h, params["ln_f"], cfg.norm)
        unemb = params.get("unembed", emb)
        return chunked_xent(lambda hc, e: tf._logits(cfg, hc, e), h, unemb,
                            batch["labels"], chunk=xent_chunk)

    return loss_fn
