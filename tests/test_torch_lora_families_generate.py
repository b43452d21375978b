"""Greedy ``generate`` with LoRA adapters on the other families against
the JAX package's (``tests/torch_lora_cases.py``): ids in the default
bf16 compute equal or forked at bf16 ties only
(``torch_family_cases.assert_ids_agree``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quip_for_all_tpu.runtime import generate as JG

from quip_for_all_tpu_torch.models import registry as TR
from quip_for_all_tpu_torch.runtime import generate as G

from torch_family_cases import assert_ids_agree
from torch_lora_cases import TARGETS, adapted, ids, jax_case

pytestmark = pytest.mark.fast

NAMES = list(TARGETS)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops: one thread a test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", NAMES)
def test_generate_with_adapters_matches_jax(name):
    """Greedy decoding through the base linears plus the rank-r products
    after ``fuse_for_inference`` (which leaves every adapted linear
    unfused), in f32 activations with the default bf16 compute; the port's
    decode steps run eagerly on the CPU (the body a card graphs)."""
    jcfg, _, tcfg = jax_case(name)
    jp, model = adapted(name)
    model = TR.fuse_for_inference(tcfg, model)
    prompt = ids(9, n=1, S=12)
    want = np.asarray(JG.generate(jcfg, jp, jnp.asarray(prompt), 6,
                                  cache_len=32, dtype_str="float32"))
    got, _, runner = G._generate(tcfg, model, torch.from_numpy(prompt), 6,
                                 cache_len=32, dtype=torch.float32,
                                 device="cpu")
    assert got.shape == want.shape == (1, 18)
    assert_ids_agree(jcfg, jp, 12, got.numpy()[0], want[0])
    assert runner.captures == 0 and runner.eager_steps == 5
