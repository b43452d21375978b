"""The collectives of the parallel paths (tensor and sequence parallelism,
the pipeline), in one module so that every one is counted: each function
adds one to its ``.calls`` where it runs its collective, as a kernel
wrapper counts its launches.

Two ranks may share one card (``chip_smoke.py`` phase 21 runs two
processes on one H100). NCCL refuses two ranks on one device, so such a
group runs gloo, which takes CUDA tensors for ``all_reduce``,
``all_gather`` and ``broadcast`` (checked on an H100, torch 2.11: it
stages them through the host itself). Nothing here moves a tensor to the
CPU, and a collective that fails raises.

gloo has no ``send``/``recv`` for CUDA tensors, so the ring shift (the
JAX package's ``lax.ppermute`` over ``[(i, (i + 1) % P)]``) is an
``all_gather`` from which each rank keeps its source's tensor: every rank
receives the other P - 1 tensors where a shift needs one, and holds all P
for the call. At P = 2 that is the shift's own traffic.

A collective cannot sit inside a CUDA graph on gloo, so a sharded model's
decode steps run eagerly (``runtime/graphs.py``, ``sharded``).

Training under a mesh differentiates through three of them, megatron's
f/g pairs, each a ``torch.autograd.Function`` where autograd records the
call (else the plain collective): ``all_gather``'s backward keeps this
rank's slice of the gradient (every rank downstream computes the same
loss, so the gradients it gets are equal and need no sum); the
``all_reduce`` of partial sums has the identity as its backward; and
``enter`` (the copy into the tensor-parallel region, the identity
forward) sums its gradient over the group in its backward. A collective
run in a backward counts in ``.calls`` as a forward one does.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _recorded(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    all_reduce.calls += 1
    dist.all_reduce(t, group=group)
    return t


def _gather(t: torch.Tensor, group, world: int) -> torch.Tensor:
    all_gather.calls += 1
    t = t.contiguous()
    outs = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(outs, t, group=group)
    return torch.cat(outs, dim=-1)


class _AllReduce(torch.autograd.Function):
    """The sum of partial products; its backward the identity."""

    @staticmethod
    def forward(ctx, t, group):
        return _sum(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    """The gather along the last axis; its backward this rank's slice."""

    @staticmethod
    def forward(ctx, t, group, world):
        ctx.index, ctx.width = dist.get_rank(group=group), t.shape[-1]
        return _gather(t, group, world)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.width
        return g[..., lo:lo + ctx.width], None, None


class _Enter(torch.autograd.Function):
    """The identity; its backward the gradient summed over the group."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _sum(g.contiguous().clone(), ctx.group), None


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over the group: in place (returns it), or, where autograd
    records the call, into a new tensor whose gradient passes back as it
    is."""
    if _recorded(t):
        return _AllReduce.apply(t, group)
    return _sum(t, group)


def all_gather(t: torch.Tensor, group, world: int) -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) concatenated along the last axis in
    rank order; where autograd records the call, ``t``'s gradient is this
    rank's slice of the output's."""
    if _recorded(t):
        return _AllGather.apply(t, group, world)
    return _gather(t, group, world)


def enter(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` itself, of which this rank uses its part alone (a replicated
    activation before the rank's rows, a whole leaf of which it takes a
    slice): where autograd records the call, the gradient is summed over
    the group in the backward, so that every rank holds the whole one.
    No collective in the forward."""
    if _recorded(t):
        return _Enter.apply(t, group)
    return t


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of global rank ``src`` to every rank of the group, in
    place; returns it."""
    broadcast.calls += 1
    dist.broadcast(t, src=src, group=group)
    return t


def ring_shift(t: torch.Tensor, group, world: int, index: int,
               step: int = 1) -> torch.Tensor:
    """The ``t`` of the rank ``step`` places before this one in the group
    (``index`` is this rank's place): rank i's ``t`` goes to rank
    (i + step) % world, so step 1 is ``lax.ppermute`` over
    ``[(i, (i + 1) % P)]`` and step -1 its inverse. One ``all_gather``
    (module docstring); a new tensor."""
    ring_shift.calls += 1
    t = t.contiguous()
    outs = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(outs, t, group=group)
    return outs[(index - step) % world]


def gather_objects(obj) -> list:
    """Every rank's picklable ``obj`` of the default group, in rank order
    (a mesh's set-up: ``parallel/multihost.py`` gathers the ranks'
    hosts)."""
    gather_objects.calls += 1
    outs = [None] * dist.get_world_size()
    dist.all_gather_object(outs, obj)
    return outs


_ALL = (all_reduce, all_gather, broadcast, ring_shift, gather_objects)
for _f in _ALL:
    _f.calls = 0


def counts() -> dict:
    """Collectives run so far in this process, by name."""
    return {f.__name__: f.calls for f in _ALL}


def reset_counts() -> None:
    for f in _ALL:
        f.calls = 0
