"""Sequence parallelism: ring-attention forward over an "sp" axis of ranks —
counterpart of ``quip_for_all_tpu/parallel/sequence.py``.

Each rank holds one contiguous chunk of the sequence (rank i the tokens
[i * Sl, (i + 1) * Sl)). Everything pointwise over the sequence (norms,
the quantized linears, the MLP) runs on the local chunk unchanged; the
attention runs as a causal ring: the K/V chunks travel round the ranks
(``comm.ring_shift``) while an online softmax (running row max,
denominator and accumulator, all f32) gathers the exact attention over
the whole sequence in P steps. A rank's activations are O(S / P).

The blocks are the families' own (``block_apply`` with ``attend``), so a
chunk's linears route as any forward of Sl rows does: at Llama-2-7B
widths a 2048-token window over 2 ranks gives 1024 rows a rank, under
``FUSED_MAX_M``, and every linear runs the fused kernel where one rank
would take the dense route. Families: the llama family (fused
``qkv_proj``, unfused q/k/v, Baichuan's ``W_pack``) and GPT-NeoX, as in
the JAX package; no KV cache (prefill and evaluation).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..models.config import ModelConfig
from . import comm
from .sharding import AxisMesh, axis_mesh

__all__ = ["make_sp_mesh", "ring_attention", "sequence_parallel_logits"]

_NEG = -1e30
SP_ARCHS = ("llama", "baichuan", "gpt_neox")


def make_sp_mesh(sp: int) -> AxisMesh:
    """The ("sp",) mesh of ``sp`` ranks over the initialised process group
    (``parallel/sharding.py`` ``axis_mesh``)."""
    return axis_mesh("sp", sp)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: AxisMesh) -> torch.Tensor:
    """Exact causal attention over the sequence split on ``mesh``.

    q: (B, Sl, H, hd), k/v: (B, Sl, KV, hd), this rank's chunks (rank i
    holds positions [i * Sl, (i + 1) * Sl)). Returns the chunk's context
    (B, Sl, H * hd) in q's dtype. At step t a rank holds the K/V chunk of
    rank (i - t) mod P; a chunk wholly after the rank's queries would
    leave m, l and acc as they are (its weights are exp(-1e30 - m) = 0,
    its correction 1), so the rank skips it, and nobody takes the last
    rotation: P - 1 shifts, each of K and V together."""
    B, Sl, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    P, idx = mesh.size, mesh.index
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    # head-grouped layout for GQA: (B, KV, G, Sl, hd)
    qf = (q.reshape(B, Sl, KV, G, hd).permute(0, 2, 3, 1, 4)
          .to(torch.float32) * scale)
    a = torch.arange(Sl, device=q.device)
    gq = idx * Sl + a                                    # global q pos
    acc = torch.zeros((B, KV, G, Sl, hd), dtype=torch.float32,
                      device=q.device)
    m = torch.full((B, KV, G, Sl), _NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, Sl), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for t in range(P):
        src = (idx - t) % P
        if src <= idx:
            kf = kv[0].permute(0, 2, 1, 3).to(torch.float32)  # (B,KV,Sl,hd)
            vf = kv[1].permute(0, 2, 1, 3).to(torch.float32)
            s = torch.einsum("bkgqh,bkth->bkgqt", qf, kf)
            gk = src * Sl + a
            mask = gq[:, None] >= gk[None, :]
            s = torch.where(mask, s, torch.full_like(s, _NEG))
            m_new = torch.maximum(m, s.amax(dim=-1))
            w = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + w.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,bkth->bkgqh", w, vf)
            m = m_new
        if t < P - 1:
            kv = comm.ring_shift(kv, mesh.group, P, idx)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sl, H * hd).to(q.dtype)


def local_chunk(ids: torch.Tensor, mesh: AxisMesh):
    """This rank's chunk of (B, S) ids and its global positions (B, Sl)."""
    B, S = ids.shape
    if S % mesh.size:
        raise ValueError(f"sequence length {S} must divide by sp="
                         f"{mesh.size}")
    Sl = S // mesh.size
    lo = mesh.index * Sl
    pos = torch.arange(lo, lo + Sl, device=ids.device)[None].repeat(B, 1)
    return ids[:, lo:lo + Sl], pos


def sequence_parallel_logits(cfg: ModelConfig, model, input_ids: torch.Tensor,
                             mesh: AxisMesh,
                             linear_kw: Optional[dict] = None,
                             dtype=torch.float32) -> torch.Tensor:
    """The forward with the sequence split over ``mesh``: (B, S) ids, the
    same on every rank, S a multiple of sp -> this rank's logits (B, S /
    sp, V), those of its chunk. The model is whole on every rank; the
    rotary tables are taken at the chunk's global positions."""
    from ..models import registry as R
    if cfg.arch not in SP_ARCHS:
        raise ValueError(f"sequence parallelism runs {SP_ARCHS}, not "
                         f"{cfg.arch!r}")
    ids, pos = local_chunk(input_ids, mesh)
    linear_kw = linear_kw or {}
    block_apply = R.get_arch(cfg).block_apply
    attend = functools.partial(ring_attention, mesh=mesh)
    x = R.embed(cfg, model, ids, pos, dtype)
    cos, sin = R.rope_tables(cfg, pos)
    for blk in R.model_layers(model):
        x, _ = block_apply(cfg, blk, x, cos, sin, linear_kw=linear_kw,
                           attend=attend)
    h = R.final_hidden(cfg, model, x)
    return R.head_logits(cfg, model, h, linear_kw)
