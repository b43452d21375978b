"""Continuous-batching serving engine — counterpart of
``quip_for_all_tpu/runtime/serving.py`` (``ServingEngine``).

A fixed batch of ``max_batch`` decode slots advances together, and
admission runs CHUNKED PREFILL: every free slot with a pending request
prefills together, prompts streamed in ``prefill_chunk``-token chunks
that write straight into the per-slot KV caches (per-row cache positions,
``models/common.py``). Slots mid-decode during an admission park their
ignored pad chunk in a ``prefill_chunk``-slot scratch tail of the cache
(position ``cache_len``, never attended: the mask allows only ``j <=
position`` and positions stay below ``cache_len``), so admission never
perturbs in-flight streams and the clamp of a write's start never reaches
valid history.

Decode runs in chunks of n steps (n a power of two up to
``decode_chunk``); every prefill chunk and decode step is a step body on
static device buffers (``runtime/graphs.py``): on a card one CUDA graph
per (kind, attention bucket), replayed, on the CPU the same bodies
eagerly. Between admissions the last tokens, positions and the active
mask stay on the device (the step advances them), so a chunk is enqueued
with no host-to-device copy; each chunk's tokens are copied into pinned
host memory when ``fetch_batch`` chunks are ready (concatenated on the
device, one copy and one event) and processed ``pipeline_depth`` chunks
later.

    engine = ServingEngine(cfg, model, max_batch=8, cache_len=2048)
    rid = engine.add_request(prompt_ids, max_new_tokens=64)
    results = engine.run()          # {rid: np.ndarray tokens}

Sampling (temperature > 0) uses two generators seeded from ``seed``: the
first token of a request is drawn on the host from its prefill logits (as
the JAX engine draws it), the decode steps' Gumbel noise on the device,
one eager draw per chunk before its replays.

Sharded serving (``mesh=``, ``parallel/sharding.py``; tensor parallel,
and for Mixtral expert parallel too): every rank of the replica builds
the engine on the same requests; the model is sharded (``shard_params``)
unless it is already this rank's, the KV caches hold the rank's kv heads,
every sampled token (the first on the host, each decode step's on the
device) is broadcast from the replica's first rank, so the ranks never
diverge, and the step bodies run eagerly, since gloo's collectives cannot
sit inside a CUDA graph.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.registry import get_arch, model_device, rank_config
from ..utils.device import resolve_device
from .generate import (attn_bucket, gumbel_noise, init_kv_caches,
                       pick_token, sample_token, sync_tokens)
from .graphs import HostFetch, StepRunner, graphs_for


def _upload(dst: torch.Tensor, a: np.ndarray) -> None:
    """Host array -> static device buffer, without waiting for the device
    on a card (a pinned staging copy, non-blocking, in stream order)."""
    src = torch.from_numpy(a)
    if dst.device.type == "cuda":
        dst.copy_(src.pin_memory(), non_blocking=True)
    else:
        dst.copy_(src)


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    inflight: int = 0     # tokens enqueued on device, not yet fetched


@dataclasses.dataclass
class _Chunk:
    """One decode chunk in flight: its (n, B) tokens on the device, the
    active mask it ran with, and its host fetch once started."""
    toks: torch.Tensor
    n: int
    act: np.ndarray
    fetch: Optional[HostFetch] = None
    off: int = 0          # its first row in the fetch


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params,
                 max_batch: int = 8, cache_len: int = 2048,
                 dtype=torch.bfloat16, temperature: float = 0.0,
                 top_k: int = 0, prefill_chunk: int = 128,
                 decode_chunk: int = 8,
                 seed: int = 0, mesh=None,
                 on_token=None, kv_quantized: bool = False,
                 pipeline_depth: int = 2, fetch_batch: int = 4,
                 device="cuda", linear_kw: Optional[dict] = None):
        """``on_token(rid, token, done)`` — optional streaming callback,
        invoked in emission order for every generated token (including the
        first, sampled at admission) with ``done=True`` on a request's
        final token. ``linear_kw`` forwards to the quantized linears.
        ``params`` is the model of any family (``models/registry.py``);
        with ``mesh`` (a ``parallel.sharding.Mesh``) the whole model, or
        this rank's of that mesh."""
        if mesh is not None:
            from ..parallel.sharding import Mesh, shard_params
            if not isinstance(mesh, Mesh):
                raise TypeError("mesh= takes a parallel.sharding.Mesh "
                                "(make_mesh), not "
                                f"{type(mesh).__name__}")
            have = getattr(params, "tp_mesh", None)
            if have is None:
                params = shard_params(cfg, params, mesh)
            elif have is not mesh:
                raise ValueError("the model is sharded over another mesh")
        dev = resolve_device(device)
        if model_device(params).type != dev.type:
            raise ValueError(f"model lives on {model_device(params)}, the "
                             f"engine asked for {dev}")
        self.cfg, self.params, self.dev = cfg, params, dev
        self.model_apply = get_arch(cfg).model_apply
        self.on_token = on_token
        self.B, self.S = max_batch, cache_len
        self.kw = dict(dtype=dtype, linear_kw=linear_kw)
        self.temperature, self.top_k = temperature, top_k
        self.C = min(int(prefill_chunk), cache_len)
        self.decode_chunk = max(1, int(decode_chunk))
        B, C, V = max_batch, self.C, cfg.vocab_size
        # + C scratch slots at the tail: idle rows park their pad chunks at
        # position S during admissions
        self.caches = init_kv_caches(rank_config(cfg, params), B,
                                     cache_len + C, dtype, dev,
                                     quantized=kv_quantized)
        self.pos = np.zeros(B, dtype=np.int64)           # next write pos
        self.last_tok = np.zeros(B, dtype=np.int64)
        self.active = np.zeros(B, dtype=bool)
        self.pipeline_depth = max(0, int(pipeline_depth))
        self.fetch_batch = max(1, int(fetch_batch))
        # `pos` advances at ENQUEUE time (it parameterizes the device
        # step); `proc_pos` advances as fetched tokens are processed and
        # drives the finish conditions
        self.proc_pos = np.zeros(B, dtype=np.int64)
        self.slot_req: List[Optional[_Request]] = [None] * B
        self.pending: List[_Request] = []
        self.done: Dict[int, np.ndarray] = {}
        self._next_rid = 0
        self._inflight: List[_Chunk] = []
        self._unfetched: List[_Chunk] = []
        # the static device buffers of the step bodies. Decode: the last
        # tokens, positions and active mask (device mirrors of last_tok /
        # pos / active, valid while `_mirrored`), the step index within a
        # chunk and the chunk's token rows. Prefill: one chunk's tokens,
        # per-row start positions, in-chunk index of each row's last
        # prompt token, and the logits there.
        i64 = dict(dtype=torch.int64, device=dev)
        self._tok = torch.zeros((B,), **i64)
        self._pos = torch.zeros((B,), **i64)
        self._act = torch.zeros((B,), dtype=torch.bool, device=dev)
        self._j = torch.zeros((), **i64)
        self._toks = torch.zeros((self.decode_chunk, B), **i64)
        self._ptoks = torch.zeros((B, C), **i64)
        self._ppos = torch.zeros((B,), **i64)
        self._take = torch.zeros((B,), **i64)
        self._plast = torch.zeros((B, V), dtype=torch.float32, device=dev)
        self._noise = (torch.zeros((self.decode_chunk, B, V),
                                   dtype=torch.float32, device=dev)
                       if temperature != 0.0 else None)
        self._mirrored = False
        self._act_snap: Optional[np.ndarray] = None
        self._gen_host = torch.Generator().manual_seed(seed)
        self._gen_dev = torch.Generator(dev).manual_seed(seed + 1)
        self.runner = StepRunner(dev, [self._tok, self._pos, self._j],
                                 graphs=graphs_for(params))
        # forward passes run: prefill chunks and decode steps (warm-ups
        # before captures are in runner.warmups)
        self.prefill_chunks = self.decode_steps = 0

    # ------------------------------------------------------------ public

    def add_request(self, prompt_ids, max_new_tokens: int = 64) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.pending.append(_Request(rid, np.asarray(prompt_ids,
                                                     dtype=np.int64),
                                     max_new_tokens))
        return rid

    @torch.no_grad()
    def run(self, max_steps: int = 100000) -> Dict[int, np.ndarray]:
        steps = 0
        while (self.pending or self.active.any()
               or self._inflight) and steps < max_steps:
            self.step()
            steps += 1
        return dict(self.done)

    # ------------------------------------------------------------ bodies

    def _prefill_body(self, window: int) -> None:
        """One chunk of batched prefill, written in place at each row's
        start position; rows not prefilling park at S. ``window``: every
        PREFILLING row's query positions are < window (parked rows'
        outputs are discarded)."""
        B, C = self.B, self.C
        positions = self._ppos[:, None] + torch.arange(C, device=self.dev)
        logits, _ = self.model_apply(
            self.cfg, self.params, self._ptoks, positions=positions,
            kv_caches=self.caches, cache_position=self._ppos,
            attn_window=window, **self.kw)
        idx = self._take[:, None, None].expand(B, 1, logits.shape[-1])
        self._plast.copy_(torch.gather(logits, 1, idx)[:, 0, :])

    def _decode_body(self, window: int) -> None:
        """One decode step of every slot; inactive slots keep their token
        and position (their surplus writes land in their own rows)."""
        logits, _ = self.model_apply(
            self.cfg, self.params, self._tok[:, None],
            positions=self._pos[:, None], kv_caches=self.caches,
            cache_position=self._pos, attn_window=window, **self.kw)
        noise = (None if self._noise is None else
                 self._noise.index_select(0, self._j.view(1))[0])
        nxt = sync_tokens(self.params,
                          pick_token(logits[:, -1, :].to(torch.float32),
                                     self.temperature, self.top_k, noise))
        nxt = torch.where(self._act, nxt, self._tok)
        self._toks.index_copy_(0, self._j.view(1), nxt[None])
        self._tok.copy_(nxt)
        self._pos.add_(self._act.to(torch.int64))
        self._j.add_(1)

    # ------------------------------------------------------------ internals

    def _admit(self):
        admits: List[_Request] = []
        for slot in range(self.B):
            if self.active[slot] or not self.pending:
                continue
            req = self.pending.pop(0)
            n = req.prompt.shape[0]
            if n > self.S - 1:
                raise ValueError(f"prompt length {n} exceeds cache {self.S}")
            req.slot = slot
            admits.append(req)
        if not admits:
            return
        # all admitted prompts stream through the one fixed-shape chunk
        # step together; rows without a segment this chunk (mid-decode
        # slots, shorter prompts already consumed) park at scratch pos S
        C = self.C
        n_chunks = max((r.prompt.shape[0] + C - 1) // C for r in admits)
        fetches = []
        for c in range(n_chunks):
            start = c * C
            toks = np.zeros((self.B, C), dtype=np.int64)
            posv = np.full(self.B, self.S, dtype=np.int64)
            take = np.zeros(self.B, dtype=np.int64)
            finals = []
            for req in admits:
                seg = req.prompt[start:start + C]
                if seg.shape[0] == 0:
                    continue
                toks[req.slot, :seg.shape[0]] = seg
                posv[req.slot] = start
                if start + seg.shape[0] == req.prompt.shape[0]:
                    take[req.slot] = seg.shape[0] - 1
                    finals.append(req.slot)
            w = attn_bucket(
                min(self.S, max(start + C for r in admits
                                if r.prompt.shape[0] > start)), self.S)
            _upload(self._ptoks, toks)
            _upload(self._ppos, posv)
            _upload(self._take, take)
            self.runner.run(("prefill", w), lambda: self._prefill_body(w), 1)
            self.prefill_chunks += 1
            if finals:
                fetches.append((finals, HostFetch(self._plast)))
        last_logits: Dict[int, np.ndarray] = {}
        for finals, fetch in fetches:
            last = fetch.numpy()
            for slot in finals:
                last_logits[slot] = last[slot]
        firsts = torch.stack([sample_token(
            torch.from_numpy(last_logits[req.slot][None, :]),
            self._gen_host, self.temperature, self.top_k)[0]
            for req in admits])
        if getattr(self.params, "tp_mesh", None) is not None:
            firsts = sync_tokens(self.params, firsts.to(self.dev)).cpu()
        for req, first in zip(admits, firsts.tolist()):
            slot = req.slot
            self.slot_req[slot] = req
            self.active[slot] = True
            self.pos[slot] = req.prompt.shape[0]
            self.proc_pos[slot] = req.prompt.shape[0]
            # host state is authoritative again: drop the device mirrors
            self._mirrored = False
            self._act_snap = None
            self.last_tok[slot] = first
            req.generated.append(first)
            done = (req.max_new_tokens <= 1
                    or self.pos[slot] >= self.S - 1)
            if self.on_token is not None:
                self.on_token(req.rid, first, done)
            if done:
                self._finish(req)

    def _finish(self, req: _Request) -> None:
        self.done[req.rid] = np.concatenate(
            [req.prompt, np.asarray(req.generated, dtype=np.int64)])
        self.active[req.slot] = False
        self.slot_req[req.slot] = None

    def _start_fetch(self) -> None:
        """One host fetch of every chunk not yet fetched, concatenated on
        the device."""
        chunks, self._unfetched = self._unfetched, []
        if not chunks:
            return
        toks = (chunks[0].toks if len(chunks) == 1
                else torch.cat([c.toks for c in chunks], dim=0))
        fetch = HostFetch(toks)
        off = 0
        for c in chunks:
            c.fetch, c.off = fetch, off
            off += c.n

    def _drain_batch(self, k: int):
        """Process the ``k`` oldest in-flight token chunks (one wait)."""
        k = min(k, len(self._inflight))
        entries = self._inflight[:k]
        del self._inflight[:k]
        if any(c.fetch is None for c in entries):
            self._start_fetch()
        emitted = []
        for c in entries:
            toks = c.fetch.numpy()[c.off:c.off + c.n]
            emitted += self._process_tokens(toks, c.n, c.act)
        return emitted

    def _process_tokens(self, toks, n, act):
        """Apply one fetched (n, B) token chunk to scheduler state."""
        emitted = []
        for t in range(n):
            nxt = toks[t]
            for slot in range(self.B):
                if not act[slot]:
                    continue
                req = self.slot_req[slot]
                if req is None or not self.active[slot]:
                    continue      # finished in an earlier chunk/step
                req.inflight -= 1
                if len(req.generated) >= req.max_new_tokens:
                    continue      # surplus speculative tokens: discard
                req.generated.append(int(nxt[slot]))
                emitted.append((req.rid, int(nxt[slot])))
                self.proc_pos[slot] += 1
                self.last_tok[slot] = nxt[slot]
                finished = (len(req.generated) >= req.max_new_tokens
                            or self.proc_pos[slot] >= self.S - 1)
                if self.on_token is not None:
                    self.on_token(req.rid, int(nxt[slot]), finished)
                if finished:
                    self._finish(req)
        return emitted

    def _drain_all(self):
        if not self._inflight:
            return []
        return self._drain_batch(len(self._inflight))

    @torch.no_grad()
    def step(self):
        emitted = []
        if self.pending and self._inflight:
            # admission rewrites slot state: fully sync first
            emitted += self._drain_all()
        self._admit()
        if not self.active.any():
            return emitted + self._drain_all()
        # largest remaining token budget among active slots, net of
        # already-enqueued (in-flight) steps — when every request's
        # remaining tokens are already on the device, just drain
        remaining = max(
            req.max_new_tokens - len(req.generated) - req.inflight
            for req in self.slot_req if req is not None)
        if remaining <= 0:
            return emitted + (self._drain_batch(self.fetch_batch)
                              if self._inflight else [])
        max_pos = int(self.pos[self.active].max())
        # clamp the chunk to `remaining`, rounded up to a power of two,
        # so tail chunks take few distinct lengths; waste stays < 2x the
        # needed tail
        needed = max(1, min(self.decode_chunk, remaining))
        n = 1
        while n < needed:
            n *= 2
        n = max(1, min(n, self.decode_chunk, self.S - 1 - max_pos))
        w = attn_bucket(max_pos + n, self.S)
        if self._mirrored:
            act = self._act_snap
        else:
            act = self.active.copy()
            _upload(self._tok, self.last_tok)
            _upload(self._pos, self.pos)
            _upload(self._act, act)
        self._j.zero_()
        if self._noise is not None:
            self._noise[:n] = gumbel_noise((n,) + self._noise.shape[1:],
                                           self._gen_dev, self.dev)
        self.runner.run(("decode", w), lambda: self._decode_body(w), n)
        self.decode_steps += n
        self._mirrored, self._act_snap = True, act
        chunk = _Chunk(self._toks[:n].clone(), n, act)
        for slot in range(self.B):
            if act[slot]:
                req = self.slot_req[slot]
                if req is not None:      # finished slot still in the
                    req.inflight += n    # stale device snapshot: its
                self.pos[slot] += n      # surplus tokens drain discarded
        self._inflight.append(chunk)
        self._unfetched.append(chunk)
        if len(self._unfetched) >= self.fetch_batch:
            self._start_fetch()
        while (len(self._inflight)
               >= self.pipeline_depth + self.fetch_batch):
            emitted += self._drain_batch(self.fetch_batch)
        return emitted
