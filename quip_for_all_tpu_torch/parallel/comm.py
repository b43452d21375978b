"""The collectives of tensor parallelism, in one module so that every one
is counted: each function adds one to its ``.calls`` where it runs its
collective, as a kernel wrapper counts its launches.

Two ranks may share one card (``chip_smoke.py`` phase 21 runs two
processes on one H100). NCCL refuses two ranks on one device, so such a
group runs gloo, which takes CUDA tensors for ``all_reduce``,
``all_gather`` and ``broadcast`` (checked on an H100, torch 2.11: it
stages them through the host itself). Nothing here moves a tensor to the
CPU, and a collective that fails raises.

A collective cannot sit inside a CUDA graph on gloo, so a sharded model's
decode steps run eagerly (``runtime/graphs.py``, ``sharded``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over the group, in place; returns it."""
    all_reduce.calls += 1
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, world: int) -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) concatenated along the last axis in
    rank order."""
    all_gather.calls += 1
    t = t.contiguous()
    outs = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(outs, t, group=group)
    return torch.cat(outs, dim=-1)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of global rank ``src`` to every rank of the group, in
    place; returns it."""
    broadcast.calls += 1
    dist.broadcast(t, src=src, group=group)
    return t


all_reduce.calls = 0
all_gather.calls = 0
broadcast.calls = 0


def counts() -> dict:
    """Collectives run so far in this process, by name."""
    return {f.__name__: f.calls for f in (all_reduce, all_gather, broadcast)}


def reset_counts() -> None:
    for f in (all_reduce, all_gather, broadcast):
        f.calls = 0
