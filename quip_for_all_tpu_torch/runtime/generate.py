"""Static-cache autoregressive generation — counterpart of
``quip_for_all_tpu/runtime/generate.py`` (``generate``, ``sample_token``,
``init_kv_caches``, ``attn_bucket``).

The JAX package runs the token loop as ``lax.scan`` segments inside one
jit. Here the decode loop is a plain Python loop: tokens stay on the
device and nothing reads them back per token (no ``.item()``), so the host
only enqueues work. Positions are host integers, known statically, which
also picks each step's static attention window. CUDA graphs for the loop
come in a later PR.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..models import llama as M
from ..models.config import ModelConfig
from ..utils.device import resolve_device


def init_kv_caches(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device="cuda"
                   ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Static bf16 (or ``dtype``) KV caches, one (k, v) pair per layer."""
    dev = resolve_device(device)
    KV, hd = cfg.num_key_value_heads, cfg.head_dim
    return [tuple(torch.zeros((batch, max_len, KV, hd), dtype=dtype,
                              device=dev) for _ in range(2))
            for _ in range(cfg.num_hidden_layers)]


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 temperature: float, top_k: int) -> torch.Tensor:
    """logits (B, V) f32 -> (B,) int64. Greedy when temperature == 0;
    otherwise temperature/top-k sampling by Gumbel-max with ``generator``
    (the JAX package's jax.random draws cannot be reproduced here)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    if generator is None:
        raise ValueError("sampling needs an explicit torch.Generator")
    logits = logits / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    g = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(logits + g, dim=-1)


def attn_bucket(need: int, cache_len: int) -> int:
    """Smallest decode-attention bucket (256 · 2^k, capped at cache_len)
    covering ``need`` cache slots."""
    w = 256
    while w < min(need, cache_len):
        w *= 2
    return min(w, cache_len)


@torch.no_grad()
def generate(cfg: ModelConfig, params: M.LlamaModel,
             prompt_ids: torch.Tensor, max_new_tokens: int,
             generator: Optional[torch.Generator] = None,
             temperature: float = 0.0, top_k: int = 0,
             cache_len: int = 2048, dtype=torch.bfloat16,
             device="cuda", linear_kw: Optional[dict] = None,
             return_logits: bool = False):
    """prompt_ids (B, S) -> (B, S + max_new_tokens) generated ids.

    ``params`` is the model (built on ``device``). ``return_logits`` also
    returns the f32 last-position logits of the prefill and of every
    decode step, [(B, V)] * max_new_tokens (kept for tests and checks)."""
    dev = resolve_device(device)
    emb = params.embed_tokens.weight
    if emb.device.type != dev.type:
        raise ValueError(f"model lives on {emb.device}, generate asked for "
                         f"{dev}")
    prompt_ids = prompt_ids.to(dev)
    B, S = prompt_ids.shape
    if S + max_new_tokens > cache_len:
        raise ValueError(f"prompt ({S}) + max_new_tokens ({max_new_tokens}) "
                         f"exceeds cache_len ({cache_len})")
    caches = init_kv_caches(cfg, B, cache_len, dtype, dev)
    kw = dict(kv_caches=caches, dtype=dtype, linear_kw=linear_kw)

    positions = torch.arange(S, device=dev)[None, :].repeat(B, 1)
    logits, caches = M.model_apply(
        cfg, params, prompt_ids, positions=positions, cache_position=0,
        attn_window=attn_bucket(S, cache_len), **kw)
    last = logits[:, -1, :].to(torch.float32)
    all_logits = [last]
    tok = sample_token(last, generator, temperature, top_k)
    toks = [tok]
    # the bucket of the window each step reads: constant within a segment
    # between the attention-bucket boundaries, as in the JAX decode scans
    for p in range(S, S + max_new_tokens - 1):
        logits, caches = M.model_apply(
            cfg, params, tok[:, None], positions=torch.full(
                (B, 1), p, device=dev, dtype=torch.int64),
            cache_position=p, attn_window=attn_bucket(p + 1, cache_len),
            **kw)
        last = logits[:, -1, :].to(torch.float32)
        all_logits.append(last)
        tok = sample_token(last, generator, temperature, top_k)
        toks.append(tok)
    out = torch.cat([prompt_ids, torch.stack(toks, dim=1).to(
        prompt_ids.dtype)], dim=1)
    return (out, all_logits) if return_logits else out
