"""Pipeline parallelism: a GPipe schedule of microbatches over a "pp" axis of
ranks — counterpart of ``quip_for_all_tpu/parallel/pipeline.py``.

Rank s is stage s and runs the model's blocks [s * L / P, (s + 1) * L / P)
(``stage_blocks``, the counterpart of the JAX package's layer-stacked
``shard_stacked_params``; torch needs no stacked tree). The batch splits
into M microbatches that flow through the P stages in P + M - 1 steps:
at step t stage 0 takes microbatch t, stage s works on microbatch t - s,
the last stage finishes microbatch t - (P - 1), and every stage's output
moves to the next stage (``comm.ring_shift``). The JAX package computes
every stage at every step and masks the steps without a microbatch; a
rank here skips them, which gives the same function. The last stage's
outputs are broadcast, so every rank returns the same activations.

Gradients (the pipelined finetune of ``quantize/quantizer.py``): the
schedule is one ``torch.autograd.Function``. Its backward runs the steps
in reverse order, each stage's backward from the gradient its next stage
sends back (the inverse shift of the forward's shift). One Function and
not one per shift: autograd orders its backward nodes by each rank's own
graph, which differs from stage to stage (stage 0 takes no shifted
input), so collectives in separate nodes could pair up wrongly across
ranks; the explicit reverse schedule runs the same collectives in the
same order on every rank. Every rank computes the loss from the
replicated outputs, so their gradient is the same on every rank and the
broadcast's backward is that gradient on the last stage and nothing
elsewhere: no collective, and the last stage's gradient counted once (a
replication by all-reduce whose backward all-reduces again would count it
P times).
"""
from __future__ import annotations

import itertools
from typing import List, Optional

import torch

from ..models.config import ModelConfig
from . import comm
from .sharding import AxisMesh, axis_mesh

__all__ = ["make_pp_mesh", "stage_blocks", "pipeline_forward",
           "pipeline_logits"]


def make_pp_mesh(pp: int) -> AxisMesh:
    """The ("pp",) mesh of ``pp`` ranks over the initialised process group
    (``parallel/sharding.py`` ``axis_mesh``)."""
    return axis_mesh("pp", pp)


def stage_range(n_layers: int, mesh: AxisMesh) -> range:
    """The layer indices of this rank's stage."""
    if n_layers % mesh.size:
        raise ValueError(f"pp={mesh.size} must divide the {n_layers} layers")
    per = n_layers // mesh.size
    return range(mesh.index * per, (mesh.index + 1) * per)


def stage_blocks(model, mesh: AxisMesh) -> List:
    """This rank's L / pp consecutive blocks of ``model``."""
    from ..models.registry import model_layers
    layers = model_layers(model)
    return [layers[i] for i in stage_range(len(layers), mesh)]


def _leaves(blocks) -> List[torch.Tensor]:
    """The tensors of ``blocks`` that require grad (the finetune's
    trainables, installed as buffers; parameters too), each once."""
    seen, out = set(), []
    for blk in blocks:
        for t in itertools.chain(blk.parameters(), blk.buffers()):
            if t.requires_grad and id(t) not in seen:
                seen.add(id(t))
                out.append(t)
    return out


class _Schedule:
    """One pipelined call: the stage function and the schedule's sizes."""

    def __init__(self, stage, mesh: AxisMesh, n_micro: int):
        self.stage, self.mesh, self.M = stage, mesh, n_micro
        self.P, self.s = mesh.size, mesh.index
        self.steps = self.M + self.P - 1

    def shift(self, t: torch.Tensor, step: int) -> torch.Tensor:
        return comm.ring_shift(t, self.mesh.group, self.P, self.s, step)

    def micro(self, t: int) -> Optional[int]:
        """The microbatch this stage works on at step t (None: idle)."""
        j = t - self.s
        return j if 0 <= j < self.M else None

    def run(self, xs: torch.Tensor, grad: bool):
        """Forward over (M, mb, S, D) inputs -> (outputs, saved): outputs
        (M, mb, S, D) on every rank; with ``grad``, saved[t] is the step's
        (input leaf, output) on this stage's graph."""
        last = self.P - 1
        state = None
        outputs = torch.zeros_like(xs)
        saved = {}
        for t in range(self.steps):
            j = self.micro(t)
            h_out = torch.zeros_like(xs[0])
            if j is not None:
                h_in = xs[j] if self.s == 0 else state
                if grad:
                    h_in = h_in.detach().requires_grad_(True)
                    with torch.enable_grad():
                        h_out = self.stage(h_in)
                    saved[t] = (h_in, h_out)
                    h_out = h_out.detach()
                else:
                    h_out = self.stage(h_in)
                if self.s == last:
                    outputs[j] = h_out
            if t < self.steps - 1:
                state = self.shift(h_out, 1)
        comm.broadcast(outputs, self.mesh.ranks[last], self.mesh.group)
        return outputs, saved


class _Pipeline(torch.autograd.Function):
    """The schedule with its reverse-order backward (module docstring).
    Inputs: the ``_Schedule``, xs and the stage's leaves."""

    @staticmethod
    def forward(ctx, sched: _Schedule, xs, *leaves):
        outputs, saved = sched.run(xs, grad=True)
        ctx.sched, ctx.saved, ctx.leaves = sched, saved, leaves
        return outputs

    @staticmethod
    def backward(ctx, g):
        sched, saved, leaves = ctx.sched, ctx.saved, ctx.leaves
        last = sched.P - 1
        dxs = torch.zeros_like(g) if ctx.needs_input_grad[1] else None
        dleaves = [None] * len(leaves)
        back = None        # d(input) this stage sends to the one before
        for t in reversed(range(sched.steps)):
            # d(output) of step t: the last stage's from the loss (the
            # broadcast's backward); another's from the next stage's
            # d(input) of step t + 1, shifted back
            recv = None if t == sched.steps - 1 else sched.shift(back, -1)
            back = torch.zeros_like(g[0])
            j = sched.micro(t)
            if j is None:
                continue
            h_in, h_out = saved.pop(t)
            go = g[j] if sched.s == last else recv
            got = torch.autograd.grad(h_out, (h_in,) + tuple(leaves), go,
                                      allow_unused=True)
            back = got[0]
            if dxs is not None and sched.s == 0:
                dxs[j] = back
            for i, d in enumerate(got[1:]):
                if d is not None:
                    dleaves[i] = d if dleaves[i] is None else dleaves[i] + d
        if dxs is not None:
            # the inputs are the same on every rank: each gets stage 0's
            comm.broadcast(dxs, sched.mesh.ranks[0], sched.mesh.group)
        return (None, dxs, *dleaves)


def pipeline_forward(cfg: ModelConfig, blocks: List, x: torch.Tensor, cos,
                     sin, mesh: AxisMesh, n_microbatches: int,
                     attn_mask: Optional[torch.Tensor] = None,
                     linear_kw: Optional[dict] = None) -> torch.Tensor:
    """Run (B, S, D) activations through the model's blocks, pipelined:
    ``blocks`` are this rank's stage (``stage_blocks``), x and the
    rotary tables (those of one microbatch) the same on every rank. B must
    divide into ``n_microbatches``. Returns the (B, S, D) outputs, the
    same on every rank, equal up to sum order to applying every block in
    turn; differentiable in x and in the leaves of ``blocks`` that
    require grad."""
    from ..models.registry import get_arch
    block_apply = get_arch(cfg).block_apply
    M = n_microbatches
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} must divide into {M} microbatches")
    linear_kw = linear_kw or {}

    def stage(h):
        for blk in blocks:
            h, _ = block_apply(cfg, blk, h, cos, sin, attn_mask=attn_mask,
                               linear_kw=linear_kw)
        return h

    sched = _Schedule(stage, mesh, M)
    xs = x.reshape(M, B // M, *x.shape[1:])
    leaves = _leaves(blocks) if torch.is_grad_enabled() else []
    if leaves or (torch.is_grad_enabled() and x.requires_grad):
        out = _Pipeline.apply(sched, xs, *leaves)
    else:
        out = sched.run(xs, grad=False)[0]
    return out.reshape(x.shape)


def pipeline_logits(cfg: ModelConfig, model, input_ids: torch.Tensor,
                    mesh: AxisMesh, n_microbatches: int,
                    linear_kw: Optional[dict] = None,
                    dtype=torch.float32) -> torch.Tensor:
    """The whole forward with the blocks pipelined: embedding -> the
    stages -> final norm and head, (B, S) ids -> (B, S, V) logits, the
    same on every rank. The embedding, final norm and head run on every
    rank, as in the JAX package."""
    from ..models import registry as R
    from ..models.llama import causal_mask
    B, S = input_ids.shape
    dev = input_ids.device
    positions = torch.arange(S, device=dev)[None, :].repeat(B, 1)
    x = R.embed(cfg, model, input_ids, positions, dtype)
    cos, sin = R.rope_tables(cfg, positions[:B // n_microbatches])
    x = pipeline_forward(cfg, stage_blocks(model, mesh), x, cos, sin, mesh,
                         n_microbatches, attn_mask=causal_mask(S, S, dev),
                         linear_kw=linear_kw)
    h = R.final_hidden(cfg, model, x)
    return R.head_logits(cfg, model, h, linear_kw)
