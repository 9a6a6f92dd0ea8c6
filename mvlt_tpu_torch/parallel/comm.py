"""The collectives of the port's mesh: what GSPMD and ``shard_map`` insert
for JAX, written out. Only ``all_reduce``, ``all_gather`` and ``broadcast``
are used (gloo takes them on CUDA tensors; it has no ``reduce_scatter``).
Every function takes a process group, and does nothing (returns its input)
when the group is None: a one-device mesh has none.

- :func:`copy_to_group` is Megatron's *f*: identity forward, all-reduce of
  the gradient backward (before a column-parallel product, whose input
  gradient is a partial sum over the group).
- :func:`reduce_from_group` is Megatron's *g*: all-reduce forward, identity
  backward (after a row-parallel product). It is also the global loss's
  sum over the data group: every rank then holds the same loss, and the
  gradient of its own terms is the identity's.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of a contiguous tensor (no autograd)."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    """A sum over ``group`` that every rank's loss depends on through its
    own rows (global BatchNorm moments): all-reduce forward and backward,
    so that each rank's input gradient takes every rank's terms."""
    if group is None:
        return x
    return _SumOverGroup.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *f* over ``group``."""
    if group is None:
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *g* over ``group`` (a sum)."""
    if group is None:
        return x
    return _ReduceFromGroup.apply(x, group)


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors of one shape concatenated along ``dim`` in rank
    order (no autograd)."""
    n = group_size(group)
    if n == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def all_gather_objects(obj, group) -> List:
    """Every rank's picklable ``obj`` in rank order."""
    n = group_size(group)
    if n == 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast_tensors_(tensors: List[torch.Tensor], src: int = 0,
                       group=None) -> None:
    """Broadcast a list of tensors from global rank ``src`` in one flat
    buffer per dtype (in place)."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.broadcast(flat, src=src, group=group)
        off = 0
        with torch.no_grad():
            for t in ts:
                n = t.numel()
                t.copy_(flat[off:off + n].view_as(t))
                off += n


# Elements in one flat bucket of :func:`all_reduce_flat_` (256 MiB of f32).
_BUCKET_ELEMS = 1 << 26


def all_reduce_flat_(tensors: List[torch.Tensor], group) -> None:
    """Sum a list of tensors over ``group`` in place, through flat buckets
    of up to ``_BUCKET_ELEMS`` elements in list order (a bucket in the
    tensors' common dtype): a fixed order, so that every rank of the group
    gets the same bits. A group of one rank has nothing to sum."""
    if group is None or not tensors or group_size(group) == 1:
        return
    run: List[torch.Tensor] = []
    size = 0

    def flush(run):
        flat = torch.cat([t.reshape(-1) for t in run])
        dist.all_reduce(flat, group=group)
        off = 0
        for t in run:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n

    for t in tensors:
        run.append(t)
        size += t.numel()
        if size >= _BUCKET_ELEMS:
            flush(run)
            run, size = [], 0
    if run:
        flush(run)


def barrier(group=None) -> None:
    if dist.is_initialized():
        dist.barrier(group=group)


def global_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0
