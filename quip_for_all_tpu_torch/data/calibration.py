"""Token sources for calibration and LoRA fine-tuning — the ``synthetic``
and ``file:`` parts of ``quip_for_all_tpu/data/calibration.py``, in numpy
only, with the same seeded draws (bit-identical windows). The HF-dataset
sources (wikitext2, c4, ptb, redpajama) need a download and are not
ported.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np


def synthetic_tokens(nsamples: int, seqlen: int, vocab_size: int,
                     seed: int = 0, process_seed: int = 12345) -> np.ndarray:
    """Deterministic, mildly structured token stream (order-1 Markov over a
    blockwise transition graph). The process is fixed by ``process_seed``;
    ``seed`` drives only the sampling, so different seeds are samples of
    the same distribution (train/validation splits are meaningful)."""
    rng_proc = np.random.default_rng(process_seed)
    rng = np.random.default_rng(seed)
    n_states = min(64, vocab_size)
    trans = rng_proc.dirichlet(np.ones(n_states) * 0.2, size=n_states)
    toks = np.empty((nsamples, seqlen), dtype=np.int32)
    state = rng.integers(0, n_states, size=nsamples)
    for t in range(seqlen):
        u = np.array([rng.choice(n_states, p=trans[s]) for s in state])
        state = u
        toks[:, t] = (u * (vocab_size // n_states)
                      + rng.integers(0, max(1, vocab_size // n_states),
                                     size=nsamples))
    return toks % vocab_size


def _sample_windows(joined_ids: np.ndarray, nsamples: int, seqlen: int,
                    seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = joined_ids.shape[0]
    if n < seqlen:
        raise ValueError(f"corpus too short: {n} tokens < seqlen {seqlen}")
    # start range inclusive of n - seqlen
    starts = rng.integers(0, n - seqlen + 1, size=nsamples)
    return np.stack([joined_ids[s:s + seqlen] for s in starts]).astype(
        np.int32)


def _tokenize(tokenizer: Any, text: str) -> np.ndarray:
    return np.asarray(tokenizer(text).input_ids, dtype=np.int64)


def _file_corpus_tokens(spec: str, tokenizer: Any, nsamples: int,
                        seqlen: int, seed: int) -> np.ndarray:
    """Windows from a local corpus file: ``file:/path/corpus.txt`` joins the
    whole text into one stream; ``file:/path/docs.jsonl`` (optionally
    ``#field``, default "text") takes one window from each randomly drawn
    document long enough."""
    field = "text"
    if "#" in spec:
        spec, field = spec.rsplit("#", 1)
    if not os.path.exists(spec):
        raise FileNotFoundError(f"calibration corpus not found: {spec}")
    if spec.endswith((".jsonl", ".ndjson")):
        with open(spec, "r", encoding="utf-8") as f:
            docs = [json.loads(line)[field] for line in f if line.strip()]
        rng = np.random.default_rng(seed)
        out: list = []
        attempts = 0
        while len(out) < nsamples:
            i = int(rng.integers(0, len(docs)))
            ids = _tokenize(tokenizer, docs[i])
            attempts += 1
            if ids.shape[0] >= seqlen:
                s = int(rng.integers(0, ids.shape[0] - seqlen + 1))
                out.append(ids[s:s + seqlen])
            elif attempts > 50 * nsamples:
                raise ValueError("not enough long documents in corpus")
        return np.stack(out).astype(np.int32)
    with open(spec, "r", encoding="utf-8") as f:
        ids = _tokenize(tokenizer, f.read())
    return _sample_windows(ids, nsamples, seqlen, seed)


def get_calibration_tokens(dataset: str, tokenizer: Any, nsamples: int,
                           seqlen: int, seed: int = 0,
                           split: str = "train",
                           vocab_size: Optional[int] = None) -> np.ndarray:
    """(nsamples, seqlen) int32 token windows from ``synthetic`` (needs
    ``vocab_size``) or a ``file:`` corpus (needs a tokenizer); ``split``
    only names the HF datasets' splits, which are not ported."""
    if dataset in ("", "synthetic"):
        if vocab_size is None:
            raise ValueError("synthetic data needs vocab_size")
        return synthetic_tokens(nsamples, seqlen, vocab_size, seed)
    if dataset.startswith("file:"):
        return _file_corpus_tokens(dataset[5:], tokenizer, nsamples,
                                   seqlen, seed)
    raise NotImplementedError(
        f"dataset {dataset!r} ({split}): the HF-dataset sources are not "
        "ported, and none is queued, since each needs a download; use "
        "'synthetic' or 'file:<path>'")
