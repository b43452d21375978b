"""The whole slice end to end: a JAX random E8P12 llama (quantized head)
carried across with ``from_jax_params``, fused by each package, and run
through each package's ``generate`` in float32.

Greedy ids must be identical. Logits are compared per step within
2e-2 * max|logit|: both packages round every quantized linear's output to
bf16 (the default compute dtype), and f32 sum order can move a value to
the neighbouring bf16 one. The JAX side's per-step logits come from one
causal forward over the generated ids (the decode steps' logits are the
last-position logits of each prefix).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quip_for_all_tpu.models import llama as JM
from quip_for_all_tpu.models.config import ModelConfig as JConfig
from quip_for_all_tpu.runtime.generate import generate as jgenerate
from quip_for_all_tpu.utils.random_quantized import random_quantized_model

from quip_for_all_tpu_torch.models import llama as TM
from quip_for_all_tpu_torch.models.config import ModelConfig
from quip_for_all_tpu_torch.ops import fused_matmul
from quip_for_all_tpu_torch.runtime.generate import generate
from quip_for_all_tpu_torch.utils.convert import from_jax_params

pytestmark = pytest.mark.fast

# the smallest llama shape the Pallas kernel accepts everywhere (q_out a
# multiple of 128 for every fused group, K=3 hadK factors at 384)
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


def test_port_model_is_fused_like_jax(models):
    jcfg, jparams, tcfg, port = models
    for jb, tb in zip(jparams["layers"], port.layers):
        assert sorted(jb["self_attn"]) == sorted(tb["self_attn"].keys())
        assert sorted(jb["mlp"]) == sorted(tb["mlp"].keys())
    assert type(port.lm_head).__name__ == "QuantLinear"


@pytest.mark.parametrize("S", [12, 40])
def test_generate_matches_jax(models, S):
    jcfg, jparams, tcfg, port = models
    new = 8
    prompt = np.random.default_rng(S).integers(0, 256, (1, S))
    want = np.asarray(jgenerate(jcfg, jparams, jnp.asarray(prompt), new,
                                cache_len=64, dtype_str="float32"))
    got, logits = generate(tcfg, port, torch.from_numpy(prompt), new,
                           cache_len=64, dtype=torch.float32, device="cpu",
                           return_logits=True)
    assert np.array_equal(got.numpy(), want)

    jl, _ = JM.model_apply(jcfg, jparams, jnp.asarray(want[:, :-1]),
                           dtype=jnp.float32)
    jl = np.asarray(jl)[0, S - 1:]                 # (new, V)
    tl = torch.stack(logits, dim=1)[0].numpy()
    assert tl.shape == jl.shape == (new, 256)
    assert np.all(np.isfinite(tl))
    err = np.abs(tl - jl).max(axis=-1)
    assert np.all(err <= 2e-2 * np.abs(jl).max(axis=-1)), err


def test_plain_route_equals_default_route_on_cpu(models):
    """On CPU tensors the wrapper already runs the plain twin, so forcing
    the plain route changes nothing and launches nothing."""
    _, _, tcfg, port = models
    prompt = torch.arange(12)[None]
    before = fused_matmul.fused_decode_matmul.launches
    a = generate(tcfg, port, prompt, 4, cache_len=64, dtype=torch.float32,
                 device="cpu")
    b = generate(tcfg, port, prompt, 4, cache_len=64, dtype=torch.float32,
                 device="cpu", linear_kw={"matmul_impl": "plain"})
    assert torch.equal(a, b)
    assert fused_matmul.fused_decode_matmul.launches == before


def test_sampling_is_seeded(models):
    _, _, tcfg, port = models
    prompt = torch.arange(12)[None]

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return generate(tcfg, port, prompt, 6, generator=g, temperature=0.8,
                        top_k=20, cache_len=64, dtype=torch.float32,
                        device="cpu")
    assert torch.equal(run(1), run(1))
    assert run(1).shape == (1, 18)
