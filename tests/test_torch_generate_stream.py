"""The port's ``generate_stream`` and ``generate`` across an attention
bucket boundary (``runtime/generate.py``) held to the JAX package's
``quip_for_all_tpu/runtime/generate.py`` on the model and with the rules
of ``tests/test_torch_generate.py`` (greedy ids identical, logits within
2e-2 * max|logit|), in float32 on the CPU.
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

from test_torch_generate import _jax_step_logits

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


def _close(tl, jl):
    assert tl.shape == jl.shape and np.all(np.isfinite(tl))
    err = np.abs(tl - jl).max(axis=-1)
    assert np.all(err <= 2e-2 * np.abs(jl).max(axis=-1)), err


@pytest.mark.parametrize("S,new,chunk,cache_len", [(12, 20, 8, 64),
                                                   (250, 20, 8, 512),
                                                   (250, 9, 4, 512)])
def test_generate_stream_matches_jax(models, S, new, chunk, cache_len):
    """The same chunk sizes (the prefill's token, then chunks that never
    cross a bucket boundary) and the same ids as the JAX stream."""
    jcfg, jp, tcfg, port = models
    prompt = np.random.default_rng(S).integers(0, 256, (1, S))
    want = list(JG.generate_stream(jcfg, jp, jnp.asarray(prompt), new,
                                   chunk=chunk, cache_len=cache_len,
                                   dtype_str="float32"))
    got = list(G.generate_stream(tcfg, port, torch.from_numpy(prompt), new,
                                 chunk=chunk, cache_len=cache_len,
                                 dtype=torch.float32, device="cpu"))
    assert [c.shape for c in got] == [c.shape for c in want]
    assert all(c.dtype == np.int32 for c in got)
    assert np.array_equal(np.concatenate(got, 1), np.concatenate(want, 1))
    full = G.generate(tcfg, port, torch.from_numpy(prompt), new,
                      cache_len=cache_len, dtype=torch.float32, device="cpu")
    assert np.array_equal(np.concatenate(got, 1), full[:, S:].numpy())


@pytest.mark.parametrize("kv_quantized", [False, True])
def test_generate_across_a_bucket_boundary_matches_jax(models, kv_quantized):
    """cache_len 1024, a 250-token prompt and 12 new tokens: the decode
    crosses the 256 bucket (two step graphs on a card), in both cache
    kinds; ids identical, logits as ``test_torch_generate.py`` holds
    them."""
    jcfg, jp, tcfg, port = models
    prompt = np.random.default_rng(251).integers(0, 256, (1, 250))
    want = np.asarray(JG.generate(jcfg, jp, jnp.asarray(prompt), 12,
                                  cache_len=1024, dtype_str="float32",
                                  kv_quantized=kv_quantized))
    got, logits, runner = G._generate(
        tcfg, port, torch.from_numpy(prompt), 12, cache_len=1024,
        dtype=torch.float32, device="cpu", return_logits=True,
        kv_quantized=kv_quantized)
    assert np.array_equal(got.numpy(), want)
    assert runner.runs_by_key == {256: 6, 512: 5}
    _close(torch.stack(logits).numpy(),
           _jax_step_logits(jcfg, jp, want, 250, kv_quantized, 1024))
