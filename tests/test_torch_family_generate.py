"""``generate`` and ``perplexity`` of the eight other families in the port
(``runtime/generate.py``, which reaches each family's ``model_apply``
through ``models/registry.py``), held to the JAX package's on the same
random quantized weights (``tests/torch_family_cases.py``) in float32
activations and the default bf16 compute of the quantized linears: 8
greedy ids after a 6-token prompt must be identical or fork at bf16 ties
only (``torch_family_cases.assert_ids_agree``, the rule of
``tests/test_torch_serving.py``), and perplexity over
two 16-token windows within 1e-2 relative, the rule of
``tests/test_torch_decode_step.py`` (measured: up to 5.0e-4, GPT-NeoX
with the sequential residual; both packages round each quantized linear's
output to bf16 and sum f32 in other orders). On the CPU the port's decode
steps run eagerly: the step body a card captures as a CUDA graph."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quip_for_all_tpu.runtime import generate as JG

from quip_for_all_tpu_torch.runtime import generate as G

from torch_family_cases import FAMILIES, assert_ids_agree, case

pytestmark = pytest.mark.fast


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops: one thread a test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(FAMILIES))
def fam(request):
    return case(request.param)


def test_greedy_generate_matches_jax(fam):
    jcfg, jp, tcfg, port = fam
    prompt = np.random.default_rng(5).integers(0, 256, (1, 6))
    want = np.asarray(JG.generate(jcfg, jp, jnp.asarray(prompt), 8,
                                  cache_len=32, dtype_str="float32"))
    got, _, runner = G._generate(tcfg, port, torch.from_numpy(prompt), 8,
                                 cache_len=32, dtype=torch.float32,
                                 device="cpu")
    assert got.shape == want.shape == (1, 14)
    assert_ids_agree(jcfg, jp, 6, got.numpy()[0], want[0])
    assert runner.captures == 0 and runner.eager_steps == 7


def test_perplexity_matches_jax(fam):
    jcfg, jp, tcfg, port = fam
    windows = np.random.default_rng(6).integers(0, 256, (2, 16))
    want = JG.perplexity(jcfg, jp, windows)
    got = G.perplexity(tcfg, port, windows, device="cpu")
    assert np.isfinite(got) and abs(got - want) <= 1e-2 * want
