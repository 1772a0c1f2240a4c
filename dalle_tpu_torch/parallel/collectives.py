"""Differentiable collectives over a process sub-group (port-only).

In the JAX package GSPMD inserts the collectives of a sharded program, and
``shard_map`` bodies call ``lax.ppermute`` and ``lax.all_to_all``; autodiff
transposes each. The port's processes are the mesh's devices
(``parallel/mesh.py``), so the model calls these collectives itself, each
an ``autograd.Function`` whose backward is the transposed collective:

- :func:`all_gather` (backward: reduce-scatter, or with ``grad="split"``
  this rank's chunk, where every rank's gradient of the whole is the
  same) and :func:`reduce_scatter` (backward: all-gather), along one
  dimension, chunks in group order;
- :func:`all_reduce`, the sum, whose backward is the identity (Megatron's
  ``g``: the gradient of the sum is the same on every rank) or, with
  ``grad="all_reduce"``, the sum of the gradients;
- :func:`reduce_grad`, the identity whose backward sums the gradients
  (Megatron's ``f``: the input of a column-parallel product);
- :func:`split`, this rank's chunk along one dimension (backward:
  all-gather);
- :func:`ppermute`, ``lax.ppermute``: pieces of the leading dimension sent
  by permutations of the group's ranks, one collective for all of them
  (backward: the inverse permutations; a rank that no piece reaches gets
  zeros);
- :func:`all_to_all`, ``lax.all_to_all(tiled=True)``: split one dimension
  into the group's chunks, send chunk ``j`` to rank ``j`` and concatenate
  what arrives along another (backward: the reverse exchange).

The group's backend must be ``gloo``; any other raises. Every collective
stages a CUDA tensor through pinned host memory, as
``parallel/multihost.py`` stages its broadcasts, and carries bf16 and f16
values as f32 (exact for gathers and permutations; sums taken in f32),
which every torch build's gloo takes. A collective
that fails raises in the rank that sees it, and its group's other ranks
fail with it at their next collective or their timeout.

A rematerialised block runs its forward collectives again in backward:
every rank of a group replays the same ones in the same order, because
each rank runs the same program and the collectives of a block form one
chain (``parallel/sequence.py`` keeps even the zigzag re-deal one
collective). Callers that checkpoint turn the checkpoint's early stop off
(``models/transformer.py``), so the replay never depends on which saved
tensor a rank needs first.

:data:`TRAFFIC` counts, per kind of collective, the calls, the bytes this
rank hands to gloo and the seconds each took end to end (staging
included; the device is synchronised by the copies), for the chip smoke's
share of a step spent in collectives; :data:`AXIS_TRAFFIC` counts the
same by the mesh axis whose line carried each one.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import torch

from dalle_tpu_torch.parallel.multihost import (AXIS_TRAFFIC, BACKEND,
                                                TRAFFIC, count,
                                                reset_traffic)

Perm = Sequence[Tuple[int, int]]


def _dist():
    import torch.distributed as dist
    return dist


def group_size(group) -> int:
    return _dist().get_world_size(group)


def group_rank(group) -> int:
    return _dist().get_rank(group)


def check_group(group) -> None:
    """Raise unless ``group`` is a ``gloo`` group."""
    backend = _dist().get_backend(group)
    if backend != BACKEND:
        raise NotImplementedError(
            f"the port's collectives run over {BACKEND!r} groups; backend "
            f"{backend!r} waits for a machine with more than one card")


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous host tensor for gloo: a CUDA tensor through
    pinned memory; bf16/f16 as f32."""
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    if t.device.type == "cuda":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t)
    return t.contiguous().clone()


def _back(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return host.to(device=like.device, dtype=like.dtype)


def _host_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    t0 = time.perf_counter()
    n = group_size(group)
    host = _wire(t)
    parts = [torch.empty_like(host) for _ in range(n)]
    _dist().all_gather(parts, host, group=group)
    out = _back(torch.cat(parts, dim=dim), t)
    count("all_gather", host, t0, group)
    return out


def _host_sum(t: torch.Tensor, group) -> torch.Tensor:
    t0 = time.perf_counter()
    host = _wire(t)
    _dist().all_reduce(host, group=group)
    out = _back(host, t)
    count("all_reduce", host, t0, group)
    return out


def _host_scatter_sum(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    # gloo's reduce-scatter is not on every torch build: the sum of the
    # whole tensor, then this rank's chunk (the same sums)
    n, r = group_size(group), group_rank(group)
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split over {n} ranks")
    return _host_sum(t, group).chunk(n, dim)[r].contiguous()


def _host_ppermute(x: torch.Tensor, perms: Sequence[Perm],
                   group) -> torch.Tensor:
    """Piece ``p`` of ``x``'s leading dimension goes from each rank ``s``
    to ``d`` for ``(s, d)`` in ``perms[p]``; one all-to-all moves them."""
    t0 = time.perf_counter()
    dist = _dist()
    n, me = group_size(group), group_rank(group)
    if x.shape[0] != len(perms):
        raise ValueError(f"{len(perms)} permutations for {x.shape[0]} "
                         "pieces")
    dst = [dict(perm) for perm in perms]
    src = [{d: s for s, d in perm} for perm in perms]
    host = _wire(x)
    piece = host[0].numel()
    send = [[p for p in range(len(perms)) if dst[p].get(me) == j]
            for j in range(n)]
    recv = [[p for p in range(len(perms)) if src[p].get(me) == j]
            for j in range(n)]
    flat = host.reshape(len(perms), -1)
    inp = torch.cat([flat[p] for j in range(n) for p in send[j]]
                    or [flat.new_empty(0)])
    out = host.new_empty(sum(len(r) for r in recv) * piece)
    dist.all_to_all_single(out, inp,
                           output_split_sizes=[len(r) * piece for r in recv],
                           input_split_sizes=[len(s) * piece for s in send],
                           group=group)
    result = torch.zeros_like(flat)
    offset = 0
    for j in range(n):
        for p in recv[j]:
            result[p] = out[offset:offset + piece]
            offset += piece
    back = _back(result.reshape(host.shape), x)
    count("ppermute", inp, t0, group)
    return back


def _host_all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
                     group) -> torch.Tensor:
    n = group_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dimension {split_dim} of {tuple(x.shape)} does "
                         f"not split over {n} ranks")
    t0 = time.perf_counter()
    host = _wire(x)
    chunks = torch.stack(host.chunk(n, split_dim)).contiguous()
    out = torch.empty_like(chunks)
    _dist().all_to_all_single(out, chunks, group=group)
    back = _back(torch.cat(out.unbind(0), dim=concat_dim), x)
    count("all_to_all", chunks, t0, group)
    return back


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, grad_sum):
        ctx.dim, ctx.group, ctx.grad_sum = dim, group, grad_sum
        return _host_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum:
            return _host_scatter_sum(g, ctx.dim, ctx.group), None, None, None
        n, r = group_size(ctx.group), group_rank(ctx.group)
        return g.chunk(n, ctx.dim)[r].contiguous(), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _host_scatter_sum(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _host_gather(g, ctx.dim, ctx.group), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, grad_sum):
        ctx.group, ctx.grad_sum = group, grad_sum
        return _host_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return (_host_sum(g, ctx.group) if ctx.grad_sum else g), None, None


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _host_sum(g, ctx.group), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n, r = group_size(group), group_rank(group)
        return x.chunk(n, dim)[r].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _host_gather(g, ctx.dim, ctx.group), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perms, group):
        ctx.perms, ctx.group = perms, group
        return _host_ppermute(x, perms, group)

    @staticmethod
    def backward(ctx, g):
        inverse = [tuple((d, s) for s, d in perm) for perm in ctx.perms]
        return _host_ppermute(g, inverse, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _host_all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_host_all_to_all(g, concat_dim, split_dim, ctx.group),
                None, None, None)


def all_gather(x: torch.Tensor, dim: int, group,
               grad: str = "reduce_scatter") -> torch.Tensor:
    """The group's chunks of ``x`` concatenated along ``dim`` in rank
    order; backward: ``grad="reduce_scatter"`` sums the gradient over the
    group and keeps this rank's chunk, ``grad="split"`` keeps this rank's
    chunk of its own gradient (every rank computes the same function of
    the whole, so a sum would count it once a rank)."""
    check_group(group)
    if grad not in ("reduce_scatter", "split"):
        raise ValueError(f"unknown all_gather grad {grad!r}")
    return _AllGather.apply(x, dim, group, grad == "reduce_scatter")


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of ``x`` over the
    group."""
    check_group(group)
    return _ReduceScatter.apply(x, dim, group)


def all_reduce(x: torch.Tensor, group, grad: str = "identity"
               ) -> torch.Tensor:
    """The sum of ``x`` over the group; backward: ``grad="identity"``
    passes the gradient through, ``grad="all_reduce"`` sums it."""
    check_group(group)
    if grad not in ("identity", "all_reduce"):
        raise ValueError(f"unknown all_reduce grad {grad!r}")
    return _AllReduce.apply(x, group, grad == "all_reduce")


def reduce_grad(x: torch.Tensor, group) -> torch.Tensor:
    """``x``; backward: the sum of the gradient over the group."""
    check_group(group)
    return _ReduceGrad.apply(x, group)


def split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim`` (``x`` the same on every
    rank)."""
    check_group(group)
    return _Split.apply(x, dim, group)


def ppermute(x: torch.Tensor, perms: Sequence[Perm], group) -> torch.Tensor:
    """``lax.ppermute`` of each piece ``x[p]`` by ``perms[p]`` (a list of
    ``(source, destination)`` group ranks), as one collective."""
    check_group(group)
    return _PPermute.apply(x, tuple(tuple(map(tuple, p)) for p in perms),
                           group)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
               group) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=split_dim, concat_axis=concat_dim,
    tiled=True)`` over the group."""
    check_group(group)
    return _AllToAll.apply(x, split_dim, concat_dim, group)


@torch.no_grad()
def gather_whole(x: torch.Tensor, dims: Sequence[Tuple[int, object]]
                 ) -> torch.Tensor:
    """``x`` gathered along each ``(dim, group)`` in turn, outside
    autograd (``group`` None: that dimension is whole already)."""
    for dim, group in dims:
        if group is not None:
            check_group(group)
            x = _host_gather(x, dim, group)
    return x


@torch.no_grad()
def sum_over(x: torch.Tensor, groups: Sequence[Optional[object]]
             ) -> torch.Tensor:
    """``x`` summed over each group in turn, outside autograd (None
    groups skipped); the result has ``x``'s dtype."""
    for group in groups:
        if group is not None:
            check_group(group)
            x = _host_sum(x, group)
    return x


def max_over(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the group, outside
    autograd."""
    check_group(group)
    t0 = time.perf_counter()
    host = _wire(x.detach())
    _dist().all_reduce(host, op=_dist().ReduceOp.MAX, group=group)
    out = _back(host, x)
    count("all_reduce", host, t0, group)
    return out


def chunk_of(x: torch.Tensor, dim: int, n: int, index: int
             ) -> torch.Tensor:
    """A copy of chunk ``index`` of ``n`` of ``x`` along ``dim`` (its own
    storage, so the whole ``x`` may be freed)."""
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split over {n}")
    return x.chunk(n, dim)[index].clone(memory_format=torch.contiguous_format)


__all__: List[str] = [
    "all_gather", "reduce_scatter", "all_reduce", "reduce_grad", "split",
    "ppermute", "all_to_all", "gather_whole", "sum_over", "max_over",
    "chunk_of", "check_group", "TRAFFIC", "AXIS_TRAFFIC", "reset_traffic"]
