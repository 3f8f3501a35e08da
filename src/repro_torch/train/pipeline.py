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
  stage;
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
point-to-point hand-offs match up in both directions.

Trade vs tensor parallelism on the same axis: per-layer all-reduces
(2 * B*S*d bytes each) become one B*S*d hand-off per *stage boundary* —
~2L/S fewer bytes — at the price of the (S-1)/(M+S-1) bubble.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models import transformer as tf
from repro_torch.models.layers import chunked_xent, norm

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


def _exchange(x: torch.Tensor, send_to, recv_from) -> torch.Tensor:
    """Send ``x`` to global rank ``send_to`` and receive a tensor like it
    from ``recv_from`` (zeros where there is none)."""
    out = torch.zeros_like(x)
    ops = []
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, x, send_to))
    if recv_from is not None:
        ops.append(dist.P2POp(dist.irecv, out, recv_from))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _HandOff(torch.autograd.Function):
    """``lax.ppermute`` to the next stage, with its transpose."""

    @staticmethod
    def forward(ctx, y, prev, nxt):
        ctx.prev, ctx.nxt = prev, nxt
        return _exchange(y.contiguous(), nxt, prev)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g.contiguous(), ctx.prev, ctx.nxt), None, None


class _ReplicatedSum(torch.autograd.Function):
    """The sum over the axis of a result every rank then uses alike."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

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
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


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
    prev = ranks[stage - 1] if stage > 0 else None
    nxt = ranks[stage + 1] if stage < S - 1 else None
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

    def loss_fn(params, batch):
        emb = params["embed"]
        tokens = batch["tokens"]
        B, Sq = tokens.shape
        if B % M:
            raise ValueError(f"batch of {B} does not split into {M} "
                             "microbatches")
        x = tf.embed(emb, tokens).float()
        positions = torch.arange(Sq, device=x.device)
        x_mb = _ReplicatedIn.apply(x.reshape(M, B // M, Sq, -1), group)
        staged = _regroup(params["layers"], S)
        names, leaves = zip(*tf.leaves(staged))
        mine = tf.unflatten(zip(names, (
            _StageSlice.apply(a, stage, group, order) for a in leaves)))
        layers = tf.unstack(mine, cfg.n_layers // S)
        first = torch.tensor(stage == 0, device=x.device)
        buf = torch.zeros_like(x_mb[0])               # f32 boundary
        ys = []
        for t in range(M + S - 1):
            inj = x_mb[min(t, M - 1)]
            x_in = torch.where(first, inj, buf)
            y = stage_body(x_in.to(torch.bfloat16), layers,
                           positions).float()
            buf = _HandOff.apply(y, prev, nxt)
            ys.append(y)
        # microbatch m finishes on the last stage at tick m + S - 1
        out = torch.stack(ys[S - 1:S - 1 + M])
        mask = 1.0 if stage == S - 1 else 0.0
        out = _ReplicatedSum.apply(out * mask, group)  # [M, Bm, S, d] f32
        h = out.reshape(B, Sq, -1).to(torch.bfloat16)
        h = norm(h, params["ln_f"], cfg.norm)
        unemb = params.get("unembed", emb)
        return chunked_xent(lambda hc, e: tf._logits(cfg, hc, e), h, unemb,
                            batch["labels"], chunk=xent_chunk)

    return loss_fn
