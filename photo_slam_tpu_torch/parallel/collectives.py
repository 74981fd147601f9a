"""Collectives over a torch.distributed process group, with their
transposes.

Counterparts of the JAX package's collectives inside shard_map
(photo_slam_tpu/parallel/sharding.py): `all_gather` is
jax.lax.all_gather along dim 0, tiled or stacked, and its backward is the
reduce-scatter sum that JAX's transpose of all_gather (psum_scatter) is;
`all_reduce_flat` is one psum over a whole set of tensors, concatenated
into one buffer so that one collective replaces one per tensor;
`all_reduce_max` is pmax, and the OR of a mask is the MAX of its bytes.

Tensors go to the backend as they are, on the device they lie on: NCCL
moves them card to card, gloo copies CUDA tensors through host memory
itself (torch 2.11's gloo takes CUDA tensors in every collective used
here, of every dtype used here). A collective that fails raises.

Every function takes `profiler` (utils/profiling.Profiler, or None): each
collective is then a span `collective.<name>` (all_gather,
reduce_scatter, all_reduce, broadcast) that starts once the card has
finished the work queued before it and stops once its result is on the
card. With None nothing waits.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist


def map_tensors(fn, tree):
    """fn applied to every tensor of a tree of tuples, lists, NamedTuples
    and dicts; other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tensors(fn, x) for x in tree)
    return tree


def rank_of(group) -> int:
    return dist.get_rank(group)


def size_of(group) -> int:
    return dist.get_world_size(group)


@contextlib.contextmanager
def _span(profiler, name, x, out):
    """With a profiler: the card finishes the work queued before the
    collective, then the span times the collective alone and waits for its
    result."""
    if profiler is None:
        yield
        return
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    with profiler.span(f"collective.{name}", sync=out):
        yield


def _gather_into(x: torch.Tensor, group, profiler) -> torch.Tensor:
    """[n * rows, ...]: every rank's x (same shape on every rank) in rank
    order along dim 0."""
    x = x.contiguous()
    out = torch.empty((size_of(group) * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    with _span(profiler, "all_gather", x, out):
        dist.all_gather_into_tensor(out, x, group=group)
    return out


class _AllGather(torch.autograd.Function):
    """all_gather along dim 0; backward is the reduce-scatter sum of the
    cotangent (JAX: psum_scatter), so each rank receives the sum over all
    ranks of the cotangents of its own rows."""

    @staticmethod
    def forward(ctx, x, group, profiler):
        ctx.group, ctx.profiler, ctx.rows = group, profiler, x.shape[0]
        return _gather_into(x, group, profiler)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty((ctx.rows,) + tuple(g.shape[1:]), dtype=g.dtype,
                          device=g.device)
        with _span(ctx.profiler, "reduce_scatter", g, out):
            dist.reduce_scatter_tensor(out, g, op=dist.ReduceOp.SUM,
                                       group=ctx.group)
        return out, None, None


def all_gather(x: torch.Tensor, group, *, stacked: bool = False,
               profiler=None) -> torch.Tensor:
    """Every rank's x along dim 0, differentiable: tiled [n * rows, ...]
    (jax.lax.all_gather(..., tiled=True)) or stacked [n, rows, ...]. Bool
    tensors travel as bytes."""
    if x.dtype == torch.bool:
        out = _gather_into(x.to(torch.uint8), group, profiler).bool()
    elif x.requires_grad:
        out = _AllGather.apply(x, group, profiler)
    else:
        out = _gather_into(x, group, profiler)
    return out.reshape((size_of(group),) + tuple(x.shape)) if stacked else out


class _GatherReplicated(torch.autograd.Function):
    """all_gather along dim 0 (stacked) for a result that every rank then
    consumes identically, so that every rank holds the same cotangent. The
    transpose of the gather is then the rank's own slice of that
    cotangent; no collective runs in the backward."""

    @staticmethod
    def forward(ctx, x, group, profiler):
        ctx.rank = rank_of(group)
        return _gather_into(x, group, profiler).reshape(
            (size_of(group),) + tuple(x.shape))

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank], None, None


def gather_replicated(x: torch.Tensor, group, *,
                      profiler=None) -> torch.Tensor:
    """[n, ...] stack of every rank's x, differentiable under the contract
    that the loss downstream is the same on every rank (see
    _GatherReplicated). Where the loss differs by rank, use all_gather."""
    return _GatherReplicated.apply(x, group, profiler)


def all_reduce_flat(tensors, group, *, profiler=None) -> list[torch.Tensor]:
    """The sum over the ranks of each tensor (all float32), through ONE
    all_reduce of their concatenation. Returns new tensors of the input
    shapes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    with _span(profiler, "all_reduce", flat, flat):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape))
        i += t.numel()
    return out


def all_reduce_max(x: torch.Tensor, group, *, profiler=None) -> torch.Tensor:
    """The elementwise max over the ranks (a new tensor); for a bool mask
    the OR."""
    out = x.to(torch.uint8) if x.dtype == torch.bool else x.clone()
    with _span(profiler, "all_reduce", out, out):
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out.bool() if x.dtype == torch.bool else out


def all_reduce_sum(x: torch.Tensor, group, *, profiler=None) -> torch.Tensor:
    """The elementwise sum over the ranks (a new tensor)."""
    out = x.clone()
    with _span(profiler, "all_reduce", out, out):
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def broadcast(x: torch.Tensor, group, *, profiler=None) -> torch.Tensor:
    """Group rank 0's x on every rank (a new tensor)."""
    out = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
    out = out.clone()
    with _span(profiler, "broadcast", out, out):
        dist.broadcast(out, src=dist.get_global_rank(group, 0), group=group)
    return out.bool() if x.dtype == torch.bool else out
