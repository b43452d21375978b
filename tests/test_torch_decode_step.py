"""The port's ``decode_step_fn`` and ``perplexity``
(``runtime/generate.py``) held to the JAX package's
``quip_for_all_tpu/runtime/generate.py`` on the model and with the rules
of ``tests/test_torch_generate.py`` (greedy ids identical, logits within
2e-2 * max|logit|), in float32 on the CPU.
"""
import numpy as np
import pytest
import torch

import jax
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


def _close(tl, jl):
    assert tl.shape == jl.shape and np.all(np.isfinite(tl))
    err = np.abs(tl - jl).max(axis=-1)
    assert np.all(err <= 2e-2 * np.abs(jl).max(axis=-1)), err


@pytest.mark.parametrize("pos", [20, 300])
def test_decode_step_fn_matches_jax(models, pos):
    """A cache of 1024 slots filled to ``pos`` by a prefill, then one
    step at host int ``pos``: the JAX step's runtime bucket switch
    against the port's host pick (bucket 256, then 512)."""
    jcfg, jp, tcfg, port = models
    ids = np.random.default_rng(pos).integers(0, 256, (2, pos + 1))
    jc = JG.init_kv_caches(jcfg, 2, 1024, jnp.float32)
    tc = G.init_kv_caches(tcfg, 2, 1024, torch.float32, "cpu")
    _, jc = JM.model_apply(jcfg, jp, jnp.asarray(ids[:, :pos]),
                           kv_caches=jc, cache_position=0, dtype=jnp.float32)
    TM.model_apply(tcfg, port, torch.from_numpy(ids[:, :pos]), kv_caches=tc,
                   cache_position=0, dtype=torch.float32)
    jstep = JG.decode_step_fn(jcfg, 1024, jnp.float32)
    tstep = G.decode_step_fn(tcfg, 1024, torch.float32)
    jl, _ = jax.jit(jstep)(jp, jc, jnp.asarray(ids[:, pos]),
                           jnp.asarray(pos))
    tl, tc2 = tstep(port, tc, torch.from_numpy(ids[:, pos]), pos)
    assert tc2[0][0] is tc[0][0]              # written in place
    _close(tl.numpy()[None], np.asarray(jl)[None])
    with pytest.raises(TypeError):
        tstep(port, tc, torch.from_numpy(ids[:, pos]), torch.tensor(pos))


@pytest.mark.parametrize("batch_size,n", [(1, 3), (2, 5)])
def test_perplexity_matches_jax(models, batch_size, n):
    """Within 1e-2 relative (measured: ~1e-5 at these sizes; the two
    packages' f32 sums run in another order, and the quantized linears
    round to bf16 in both). A short last batch is dropped by both."""
    jcfg, jp, tcfg, port = models
    windows = np.random.default_rng(n).integers(0, 256, (n, 24))
    want = JG.perplexity(jcfg, jp, windows, batch_size=batch_size)
    got = G.perplexity(tcfg, port, windows, batch_size=batch_size,
                       device="cpu")
    assert np.isfinite(got) and abs(got - want) <= 1e-2 * want
    if n % batch_size:                        # the dropped batch counts not
        kept = G.perplexity(tcfg, port, windows[:n - n % batch_size],
                            batch_size=batch_size, device="cpu")
        assert got == kept


def test_perplexity_refuses_sp_mesh(models):
    _, _, tcfg, port = models
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        G.perplexity(tcfg, port, np.zeros((1, 8), np.int64), sp_mesh=object(),
                     device="cpu")
