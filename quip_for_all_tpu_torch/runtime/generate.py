"""Static-cache autoregressive generation — counterpart of
``quip_for_all_tpu/runtime/generate.py`` (``generate``,
``generate_stream``, ``decode_step_fn``, ``perplexity``, ``sample_token``,
``init_kv_caches``, ``attn_bucket``).

The JAX package runs the token loop as ``lax.scan`` segments inside one
jit, split at the attention-bucket boundaries. Here the prefill is one
eager call and the decode loop is one step body (``_Decoder._step``) that
reads the token and the position from static device buffers, writes the
sampled token (and, if asked, the f32 logits) into static output buffers
at a device index, and advances position and index on the device. On a
card each attention bucket's step is captured once as a CUDA graph and
replayed ``span`` times per segment, the segments being the JAX ones
(``runtime/graphs.py``); on the CPU the same body runs eagerly. Nothing
is read back to the host until the end.

Sampling (temperature > 0) is Gumbel-max with the caller's
``torch.Generator``: the noise of up to ``NOISE_ROWS`` steps is drawn
eagerly into a static buffer before their replays, so the graphs draw
nothing themselves (the JAX package's jax.random draws cannot be
reproduced here). Greedy decoding draws nothing.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..models import llama as M
from ..models.common import QuantKVCache, attn_bucket
from ..models.config import ModelConfig
from ..utils.device import resolve_device
from .graphs import HostFetch, StepRunner

# decode steps whose sampling noise is drawn in one eager call
NOISE_ROWS = 64


def init_kv_caches(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device="cuda",
                   quantized: bool = False) -> List[tuple]:
    """Static KV caches, one (k, v) pair per layer: ``dtype`` tensors, or
    with ``quantized`` int8 codes and per-position f32 scales
    (``models/common.py`` ``QuantKVCache``)."""
    dev = resolve_device(device)
    KV, hd = cfg.num_key_value_heads, cfg.head_dim
    shape = (batch, max_len, KV, hd)

    def slab():
        if quantized:
            return QuantKVCache(
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(shape[:3] + (1,), dtype=torch.float32,
                            device=dev))
        return torch.zeros(shape, dtype=dtype, device=dev)
    return [(slab(), slab()) for _ in range(cfg.num_hidden_layers)]


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """-log(-log(u)) for u uniform in [0, 1) from ``generator``, f32."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(1e-20)))


def pick_token(logits: torch.Tensor, temperature: float, top_k: int,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B, V) f32 -> (B,) int64: argmax when temperature == 0,
    else argmax of the tempered (top-k filtered) logits plus ``noise``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    return torch.argmax(logits + noise, dim=-1)


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 temperature: float, top_k: int) -> torch.Tensor:
    """logits (B, V) f32 -> (B,) int64. Greedy when temperature == 0;
    otherwise temperature/top-k sampling by Gumbel-max with ``generator``."""
    if temperature == 0.0:
        return pick_token(logits, 0.0, 0)
    if generator is None:
        raise ValueError("sampling needs an explicit torch.Generator")
    return pick_token(logits, temperature, top_k,
                      gumbel_noise(logits.shape, generator, logits.device))


def _segments(p: int, left: int, cache_len: int, chunk: Optional[int] = None):
    """(steps, window) of the decode runs from position p: never across an
    attention-bucket boundary (the JAX scan segments), at most ``chunk``
    steps each when given (the JAX stream chunks)."""
    while left > 0:
        w = attn_bucket(p + 1, cache_len)
        n = min(left, w - p) if w < cache_len else left
        if chunk is not None:
            n = min(n, chunk)
        yield n, attn_bucket(p + n, cache_len)
        p, left = p + n, left - n


class _Decoder:
    """One generate call's decode state: the caches, the step's static
    buffers and its ``StepRunner`` (a graph per attention bucket)."""

    def __init__(self, cfg: ModelConfig, params: M.LlamaModel, B: int,
                 max_new_tokens: int, generator, temperature: float,
                 top_k: int, cache_len: int, dtype, dev: torch.device,
                 linear_kw: Optional[dict], kv_quantized: bool,
                 return_logits: bool, graphs=None):
        if temperature != 0.0 and generator is None:
            raise ValueError("sampling needs an explicit torch.Generator")
        self.cfg, self.params, self.B, self.dev = cfg, params, B, dev
        self.kw = dict(dtype=dtype, linear_kw=linear_kw)
        self.generator, self.temperature, self.top_k = (generator,
                                                        temperature, top_k)
        self.caches = init_kv_caches(cfg, B, cache_len, dtype, dev,
                                     quantized=kv_quantized)
        i64 = dict(dtype=torch.int64, device=dev)
        self.tok = torch.zeros((B,), **i64)
        self.pos = torch.zeros((), **i64)
        self.idx = torch.zeros((), **i64)        # next row of ``out``
        self.out = torch.zeros((max_new_tokens, B), **i64)
        self.logits = (torch.zeros((max_new_tokens, B, cfg.vocab_size),
                                   dtype=torch.float32, device=dev)
                       if return_logits else None)
        state = [self.tok, self.pos, self.idx]
        self.noise = self.nidx = None
        self.noise_left = 0
        if temperature != 0.0:
            self.noise = torch.zeros(
                (min(NOISE_ROWS, max_new_tokens), B, cfg.vocab_size),
                dtype=torch.float32, device=dev)
            self.nidx = torch.zeros((), **i64)
            state.append(self.nidx)
        self.runner = StepRunner(dev, state, graphs=graphs)

    def prefill(self, prompt_ids: torch.Tensor,
                cache_len: int) -> torch.Tensor:
        B, S = prompt_ids.shape
        positions = torch.arange(S, device=self.dev)[None, :].repeat(B, 1)
        logits, _ = M.model_apply(
            self.cfg, self.params, prompt_ids, positions=positions,
            kv_caches=self.caches, cache_position=0,
            attn_window=attn_bucket(S, cache_len), **self.kw)
        last = logits[:, -1, :].to(torch.float32)
        tok = sample_token(last, self.generator, self.temperature,
                           self.top_k)
        if self.logits is not None:
            self.logits[0] = last
        self.out[0] = tok
        self.tok.copy_(tok)
        self.pos.fill_(S)
        self.idx.fill_(1)
        return tok

    def _step(self, window: int) -> None:
        B = self.B
        logits, _ = M.model_apply(
            self.cfg, self.params, self.tok[:, None],
            positions=self.pos.view(1, 1).expand(B, 1),
            kv_caches=self.caches, cache_position=self.pos,
            attn_window=window, **self.kw)
        last = logits[:, -1, :].to(torch.float32)
        at = self.idx.view(1)
        if self.logits is not None:
            self.logits.index_copy_(0, at, last[None])
        noise = None
        if self.noise is not None:
            noise = self.noise.index_select(0, self.nidx.view(1))[0]
            self.nidx.add_(1)
        nxt = pick_token(last, self.temperature, self.top_k, noise)
        self.out.index_copy_(0, at, nxt[None])
        self.tok.copy_(nxt)
        self.pos.add_(1)
        self.idx.add_(1)

    def run(self, n: int, window: int) -> None:
        """n decode steps that read the cache prefix ``window``."""
        while n > 0:
            k = n
            if self.noise is not None:
                if self.noise_left == 0:       # eager draw, in order
                    self.noise.copy_(gumbel_noise(
                        self.noise.shape, self.generator, self.dev))
                    self.nidx.zero_()
                    self.noise_left = self.noise.shape[0]
                k = min(k, self.noise_left)
                self.noise_left -= k
            self.runner.run(window, lambda: self._step(window), k)
            n -= k


def _start(cfg, params, prompt_ids, max_new_tokens, cache_len, device):
    dev = resolve_device(device)
    emb = params.embed_tokens.weight
    if emb.device.type != dev.type:
        raise ValueError(f"model lives on {emb.device}, generate asked for "
                         f"{dev}")
    prompt_ids = torch.as_tensor(prompt_ids).to(dev)
    B, S = prompt_ids.shape
    if S + max_new_tokens > cache_len:
        raise ValueError(f"prompt ({S}) + max_new_tokens ({max_new_tokens}) "
                         f"exceeds cache_len ({cache_len})")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    return dev, prompt_ids


@torch.no_grad()
def _generate(cfg, params, prompt_ids, max_new_tokens, *, generator=None,
              temperature=0.0, top_k=0, cache_len=2048, dtype=torch.bfloat16,
              device="cuda", linear_kw=None, return_logits=False,
              kv_quantized=False, graphs=None):
    """``generate``'s body; also returns its ``StepRunner`` (what was
    captured, warmed up, replayed). ``graphs=False`` runs a card's decode
    steps eagerly: the loop the graphs are checked against."""
    dev, prompt_ids = _start(cfg, params, prompt_ids, max_new_tokens,
                             cache_len, device)
    B, S = prompt_ids.shape
    dec = _Decoder(cfg, params, B, max_new_tokens, generator, temperature,
                   top_k, cache_len, dtype, dev, linear_kw, kv_quantized,
                   return_logits, graphs)
    dec.prefill(prompt_ids, cache_len)
    for n, window in _segments(S, max_new_tokens - 1, cache_len):
        dec.run(n, window)
    out = torch.cat([prompt_ids, dec.out.T.to(prompt_ids.dtype)], dim=1)
    if return_logits:
        return out, list(dec.logits.unbind(0)), dec.runner
    return out, None, dec.runner


@torch.no_grad()
def generate(cfg: ModelConfig, params: M.LlamaModel,
             prompt_ids: torch.Tensor, max_new_tokens: int,
             generator: Optional[torch.Generator] = None,
             temperature: float = 0.0, top_k: int = 0,
             cache_len: int = 2048, dtype=torch.bfloat16,
             device="cuda", linear_kw: Optional[dict] = None,
             return_logits: bool = False, kv_quantized: bool = False):
    """prompt_ids (B, S) -> (B, S + max_new_tokens) generated ids.

    ``params`` is the model (built on ``device``); ``kv_quantized`` keeps
    the KV cache in int8 (``QuantKVCache``). ``return_logits`` also returns
    the f32 last-position logits of the prefill and of every decode step,
    [(B, V)] * max_new_tokens (kept for tests and checks). On a card the
    decode steps replay one CUDA graph per attention bucket."""
    out, logits, _ = _generate(
        cfg, params, prompt_ids, max_new_tokens, generator=generator,
        temperature=temperature, top_k=top_k, cache_len=cache_len,
        dtype=dtype, device=device, linear_kw=linear_kw,
        return_logits=return_logits, kv_quantized=kv_quantized)
    return (out, logits) if return_logits else out


@torch.no_grad()
def generate_stream(cfg: ModelConfig, params: M.LlamaModel,
                    prompt_ids: torch.Tensor, max_new_tokens: int, *,
                    chunk: int = 8,
                    generator: Optional[torch.Generator] = None,
                    temperature: float = 0.0, top_k: int = 0,
                    cache_len: int = 2048, dtype=torch.bfloat16,
                    device="cuda", linear_kw: Optional[dict] = None,
                    kv_quantized: bool = False):
    """Streaming decode: yields int32 numpy arrays of shape (B, <= chunk)
    as tokens are produced, in the JAX package's chunk sizes: the prefill's
    token first, then chunks that never cross an attention-bucket
    boundary. Each chunk replays its bucket's step graph n times and is
    fetched by one non-blocking copy into pinned host memory."""
    dev, prompt_ids = _start(cfg, params, prompt_ids, max_new_tokens,
                             cache_len, device)
    B, S = prompt_ids.shape
    dec = _Decoder(cfg, params, B, max_new_tokens, generator, temperature,
                   top_k, cache_len, dtype, dev, linear_kw, kv_quantized,
                   False)
    first = dec.prefill(prompt_ids, cache_len)
    yield HostFetch(first[:, None]).numpy().astype(np.int32)
    i = 1
    for n, window in _segments(S, max_new_tokens - 1, cache_len, chunk):
        dec.run(n, window)
        yield HostFetch(dec.out[i:i + n]).numpy().T.astype(np.int32)
        i += n


def decode_step_fn(cfg: ModelConfig, cache_len: int = 2048,
                   dtype=torch.bfloat16, linear_kw: Optional[dict] = None):
    """A single-token decode step (for timing the hot path alone):
    (params, caches, tok (B,), pos host int) -> (logits (B, V), caches).
    The attention bucket is picked on the host from ``pos``
    (``models/llama.py`` ``runtime_window``), as the JAX step's runtime
    switch picks it. ``linear_kw`` forwards to the quantized linears."""
    del cache_len      # the caches carry their length

    @torch.no_grad()
    def step(params, caches, tok, pos: int):
        if not isinstance(pos, int):
            raise TypeError("decode_step_fn's pos is a host int")
        B = tok.shape[0]
        positions = torch.full((B, 1), pos, dtype=torch.int64,
                               device=tok.device)
        logits, caches = M.model_apply(
            cfg, params, tok[:, None], positions=positions,
            kv_caches=caches, cache_position=pos, dtype=dtype,
            linear_kw=linear_kw)
        return logits[:, -1, :], caches
    return step


@torch.no_grad()
def perplexity(cfg: ModelConfig, params: M.LlamaModel,
               token_windows: np.ndarray, batch_size: int = 1,
               dtype=torch.float32, sp_mesh=None, device="cuda",
               linear_kw: Optional[dict] = None) -> float:
    """Perplexity over (N, S) token windows: exp of the mean over batches
    of each batch's mean next-token negative log-likelihood, as the JAX
    package computes it (a short last batch is dropped). Above
    ``FUSED_MAX_M`` rows a linear takes the dense route (``decode_weights``
    and one ``torch.matmul``), as the JAX package does."""
    if sp_mesh is not None:
        raise NotImplementedError(
            "sequence-parallel perplexity (sp_mesh=) is not ported yet "
            "(ROADMAP.md queue 1 item 8)")
    dev = resolve_device(device)
    if params.embed_tokens.weight.device.type != dev.type:
        raise ValueError(f"model lives on {params.embed_tokens.weight.device}"
                         f", perplexity asked for {dev}")
    windows = np.asarray(token_windows)
    losses = []
    for i in range(0, windows.shape[0], batch_size):
        b = windows[i:i + batch_size]
        if b.shape[0] < batch_size:
            break
        batch = torch.as_tensor(b, dtype=torch.int64, device=dev)
        logits, _ = M.model_apply(cfg, params, batch, dtype=dtype,
                                  linear_kw=linear_kw)
        logp = torch.log_softmax(logits[:, :-1, :].to(torch.float32), dim=-1)
        ll = torch.gather(logp, -1, batch[:, 1:, None])[..., 0]
        losses.append(float(-ll.mean()))
    return float(np.exp(np.mean(losses)))
