"""The port's decode loop and its siblings (``runtime/generate.py``:
``generate`` with and without the int8 KV cache, across an attention
bucket boundary, ``generate_stream``, ``decode_step_fn``, ``perplexity``)
held to the JAX package's ``quip_for_all_tpu/runtime/generate.py`` on a
JAX random E8P12 llama (GQA, quantized head) carried across with
``from_jax_params``, in float32.

Greedy ids must be identical. Logits are held within 2e-2 * max|logit|
per step, the rule of ``tests/test_torch_slice.py`` (both packages round
every quantized linear's output to bf16, and f32 sum order can move a
value to the neighbouring bf16 one). The JAX side's per-step logits come
from one forward over the generated ids: causal without a cache, or
through an int8 cache written by that forward (a position's codes do not
depend on how the prompt was chunked). On the CPU the port's step body
runs eagerly: what a card captures in its graphs.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quip_for_all_tpu.models import llama as JM
from quip_for_all_tpu.models.config import ModelConfig as JConfig
from quip_for_all_tpu.runtime import generate as JG
from quip_for_all_tpu.utils.random_quantized import random_quantized_model

from quip_for_all_tpu_torch.models.config import ModelConfig
from quip_for_all_tpu_torch.models import llama as TM
from quip_for_all_tpu_torch.runtime import generate as G
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
            num_key_value_heads=2, max_position_embeddings=2048)


@pytest.fixture(scope="module")
def models():
    jcfg = JConfig(**DIMS)
    params = random_quantized_model(jcfg, "E8P12", seed=0,
                                    dtype=jnp.float32, quantize_head=True)
    tcfg = ModelConfig(**DIMS)
    port = TM.fuse_for_inference(tcfg, from_jax_params(params, "cpu"))
    return jcfg, JM.fuse_for_inference(jcfg, params), tcfg, port


def _jax_step_logits(jcfg, jp, ids, S, quantized, cache_len):
    """(new, B, V): the last-position logits of the prefill and of every
    decode step, from one JAX forward over ids[:, :-1]."""
    kw = {}
    if quantized:
        kw = dict(kv_caches=JG.init_kv_caches(jcfg, ids.shape[0], cache_len,
                                              jnp.float32, quantized=True),
                  cache_position=0)
    jl, _ = JM.model_apply(jcfg, jp, jnp.asarray(ids[:, :-1]),
                           dtype=jnp.float32, **kw)
    return np.asarray(jl)[:, S - 1:].transpose(1, 0, 2)


def _close(tl, jl):
    assert tl.shape == jl.shape and np.all(np.isfinite(tl))
    err = np.abs(tl - jl).max(axis=-1)
    assert np.all(err <= 2e-2 * np.abs(jl).max(axis=-1)), err


@pytest.mark.parametrize("kv_quantized", [False, True])
@pytest.mark.parametrize("B,S,new,cache_len", [(1, 12, 8, 64),
                                               (2, 20, 6, 64)])
def test_generate_matches_jax(models, B, S, new, cache_len, kv_quantized):
    """B = 1 and 2, both cache kinds."""
    jcfg, jp, tcfg, port = models
    prompt = np.random.default_rng(S + B).integers(0, 256, (B, S))
    want = np.asarray(JG.generate(jcfg, jp, jnp.asarray(prompt), new,
                                  cache_len=cache_len, dtype_str="float32",
                                  kv_quantized=kv_quantized))
    got, logits, runner = G._generate(
        tcfg, port, torch.from_numpy(prompt), new, cache_len=cache_len,
        dtype=torch.float32, device="cpu", return_logits=True,
        kv_quantized=kv_quantized)
    assert np.array_equal(got.numpy(), want)
    assert runner.captures == 0 and runner.eager_steps == new - 1
    _close(torch.stack(logits).numpy(),
           _jax_step_logits(jcfg, jp, want, S, kv_quantized, cache_len))


@pytest.mark.parametrize("kv_quantized", [False, True])
def test_sampling_is_seeded(models, kv_quantized):
    """The same generator seed gives the same sampled ids (the noise of
    a block of steps is drawn at once); another seed other ids."""
    _, _, tcfg, port = models
    prompt = torch.arange(12)[None].repeat(2, 1)

    def run(seed):
        return G.generate(tcfg, port, prompt, 70, generator=torch.Generator(
            ).manual_seed(seed), temperature=0.8, top_k=20, cache_len=128,
            dtype=torch.float32, device="cpu", kv_quantized=kv_quantized)
    a = run(1)
    assert torch.equal(a, run(1)) and a.shape == (2, 82)
    assert not torch.equal(a, run(2))
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        G.generate(tcfg, port, prompt, 4, temperature=0.8, device="cpu")


def test_segments_are_the_jax_scan_segments():
    """(steps, window) per decode run: never across a bucket boundary."""
    assert list(G._segments(32, 127, 2048)) == [(127, 256)]
    assert list(G._segments(250, 11, 1024)) == [(6, 256), (5, 512)]
    assert list(G._segments(250, 19, 512, 8)) == [(6, 256), (8, 512),
                                                  (5, 512)]
    assert list(G._segments(1000, 40, 1024)) == [(40, 1024)]
