"""The port's continuous-batching ``ServingEngine`` (``runtime/serving.py``)
held to the JAX package's ``quip_for_all_tpu/runtime/serving.py`` on a
JAX random E8P12 llama (GQA, quantized head) carried across with
``from_jax_params``, greedy in float32 on the CPU (the port's step bodies
run eagerly there: what a card replays as graphs).

Both engines get the same requests with the same settings; every
request's ids must be identical, or fork at bf16 ties only
(``assert_ids_agree``), and the ``on_token`` streams must be the same:
(request id, done flag) in emission order, each request's tokens its
ids. The scenarios cover
more requests than slots, prompts longer than ``prefill_chunk``,
admissions while other slots decode, a 1-token request, the pipelining
knobs and the int8 KV cache.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quip_for_all_tpu.models import llama as JM
from quip_for_all_tpu.models.config import ModelConfig as JConfig
from quip_for_all_tpu.runtime.serving import ServingEngine as JEngine
from quip_for_all_tpu.utils.random_quantized import random_quantized_model

from quip_for_all_tpu_torch.models import llama as TM
from quip_for_all_tpu_torch.models.config import ModelConfig
from quip_for_all_tpu_torch.runtime.serving import ServingEngine
from quip_for_all_tpu_torch.utils.convert import from_jax_params

pytestmark = pytest.mark.fast


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops: one thread a test worker, so that a parallel
    test run does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DIMS = dict(vocab_size=256, hidden_size=128, intermediate_size=384,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)


@pytest.fixture(scope="module")
def models():
    jcfg = JConfig(**DIMS)
    params = random_quantized_model(jcfg, "E8P12", seed=0,
                                    dtype=jnp.float32, quantize_head=True)
    tcfg = ModelConfig(**DIMS)
    port = TM.fuse_for_inference(tcfg, from_jax_params(params, "cpu"))
    return jcfg, JM.fuse_for_inference(jcfg, params), tcfg, port


def bf16_step(x):
    """One bf16 step (8 significant bits) at magnitude |x|."""
    return 2.0 ** (np.floor(np.log2(max(abs(float(x)), 1e-30))) - 7)


def assert_ids_agree(jcfg, jparams, n_prompt, got, want):
    """``got`` (port) and ``want`` (JAX), 1-D prompt + generated ids:
    identical, or forked at bf16 ties only. Both packages round every
    quantized linear's output to bf16, so two logits can tie there and
    f32 sum order decides which one rounds up. Where the ids differ, the
    JAX model reads the port's ids in one forward (teacher forcing), and
    at every generated position from the first difference on, the port's
    token must be within one bf16 step of the JAX maximum."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    diff = np.nonzero(got != want)[0]
    if diff.size == 0:
        return
    f = int(diff[0])
    assert f >= n_prompt, "the prompts differ"
    logits, _ = JM.model_apply(jcfg, jparams, jnp.asarray(got[None, :-1]),
                               dtype=jnp.float32)
    for i, row in enumerate(np.asarray(logits)[0, f - 1:], start=f):
        top, mine = row.max(), row[got[i]]
        assert top - mine <= bf16_step(max(abs(top), abs(mine))), (
            f"at {i} the port's token {got[i]} is {top - mine:.3g} below "
            f"the JAX maximum {top:.6g} (JAX's own ids gave {want[i]})")


def _requests(lens, news, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, n), m) for n, m in zip(lens, news)]


def serve_both(models, requests, **kw):
    """Each engine's {rid: ids} and its on_token stream."""
    jcfg, jp, tcfg, port = models
    kw = dict(dict(max_batch=2, cache_len=64, prefill_chunk=8,
                   decode_chunk=4), **kw)
    outs = []
    for make in (lambda cb: JEngine(jcfg, jp, dtype=jnp.float32,
                                    on_token=cb, **kw),
                 lambda cb: ServingEngine(tcfg, port, dtype=torch.float32,
                                          on_token=cb, device="cpu", **kw)):
        events = []
        eng = make(lambda rid, tok, done: events.append(
            (rid, int(tok), bool(done))))
        rids = [eng.add_request(p, m) for p, m in requests]
        res = eng.run(max_steps=500)
        assert sorted(res) == rids
        outs.append(({r: np.asarray(res[r]).astype(np.int64) for r in rids},
                     events, eng))
    (jr, je, _), (tr, te, teng) = outs
    assert [(r, d) for r, _, d in te] == [(r, d) for r, _, d in je]
    for (p, m), r in zip(requests, sorted(tr)):
        assert tr[r].shape[0] == p.shape[0] + m
        assert_ids_agree(jcfg, jp, p.shape[0], tr[r], jr[r])
        for ids, events in ((tr[r], te), (jr[r], je)):
            assert [t for q, t, _ in events if q == r] == list(
                ids[p.shape[0]:])
        assert [e for e in te if e[0] == r][-1][2]        # done on its last
    return tr, te, teng


def test_more_requests_than_slots_with_long_prompts(models):
    """5 requests on 2 slots; prompts of 17 and 30 tokens take 3 and 4
    prefill chunks of 8; later requests are admitted while the other
    slot decodes."""
    reqs = _requests([5, 17, 30, 9, 3], [6, 9, 4, 7, 5])
    _, events, eng = serve_both(models, reqs)
    assert eng.prefill_chunks > 5 and eng.decode_steps > 0
    # an admission during decode: a request's first token comes after
    # another request's later tokens
    firsts = {}
    for i, (rid, _, _) in enumerate(events):
        firsts.setdefault(rid, i)
    assert firsts[2] > min(i for i, e in enumerate(events) if e[0] == 0) + 1


def test_one_token_request(models):
    """max_new_tokens 1: the token sampled at admission is the last."""
    reqs = _requests([6, 4, 11], [1, 5, 1], seed=1)
    out, events, _ = serve_both(models, reqs)
    assert [e for e in events if e[0] == 0] == [(0, int(out[0][-1]), True)]


@pytest.mark.parametrize("pipeline_depth", [0, 2])
@pytest.mark.parametrize("fetch_batch", [1, 4])
def test_pipelining_knobs(models, pipeline_depth, fetch_batch):
    reqs = _requests([7, 12, 3], [9, 5, 11], seed=2)
    serve_both(models, reqs, pipeline_depth=pipeline_depth,
               fetch_batch=fetch_batch, decode_chunk=2)


def test_int8_kv_cache(models):
    reqs = _requests([9, 15, 4], [6, 6, 8], seed=3)
    serve_both(models, reqs, kv_quantized=True)


def test_decode_chunk_one_and_three_slots(models):
    reqs = _requests([3, 20, 8, 5], [4, 3, 6, 2], seed=4)
    serve_both(models, reqs, max_batch=3, decode_chunk=1, prefill_chunk=16)


def test_prompt_too_long_and_mesh_raise(models):
    _, _, tcfg, port = models
    eng = ServingEngine(tcfg, port, max_batch=2, cache_len=32,
                        dtype=torch.float32, device="cpu")
    eng.add_request(np.arange(40) % 256, 4)
    with pytest.raises(ValueError, match="exceeds cache"):
        eng.run()
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        ServingEngine(tcfg, port, mesh=object(), device="cpu")


def test_sampled_serving_is_seeded(models):
    """temperature > 0: the same seed serves the same ids; the host draws
    each first token, the device each chunk's noise."""
    _, _, tcfg, port = models
    reqs = _requests([5, 9, 12], [7, 6, 5], seed=5)

    def run(seed):
        eng = ServingEngine(tcfg, port, max_batch=2, cache_len=64,
                            prefill_chunk=8, dtype=torch.float32,
                            temperature=0.9, top_k=30, seed=seed,
                            device="cpu")
        rids = [eng.add_request(p, m) for p, m in reqs]
        res = eng.run()
        return [res[r] for r in rids]
    a, b, c = run(0), run(0), run(1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


def test_attention_buckets_in_prefill_and_decode(models):
    """cache_len 512: prompts of 250 and 300 tokens prefill in chunks of
    64 through the 256 and 512 buckets, and decode crosses 256."""
    reqs = _requests([250, 40, 300], [12, 8, 6], seed=6)
    _, _, eng = serve_both(models, reqs, cache_len=512, prefill_chunk=64)
    assert {k[1] for k in eng.runner.runs_by_key} == {256, 512}
