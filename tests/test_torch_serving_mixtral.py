"""The port's ``ServingEngine`` on a tiny Mixtral (4 experts, top-2, GQA,
experts stacked by ``fuse_for_inference``) held to the JAX package's
engine on a JAX random E8P12 model carried across with
``from_jax_params``, greedy in float32 on the CPU: every request's ids and
the ``on_token`` stream identical. Decode steps of 2 slots take the
sparse expert route (fewer than 32 tokens); a prefill chunk takes it at
2 x 8 rows and the dense masked expert loop at 2 x 16 (32 rows), in both
packages. Each request also equals the port's ``generate`` of its prompt
alone. Ids may fork at bf16 ties only
(``test_torch_serving.assert_ids_agree``).
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
from quip_for_all_tpu_torch.runtime.generate import generate
from quip_for_all_tpu_torch.runtime.serving import ServingEngine
from quip_for_all_tpu_torch.utils.convert import from_jax_params

from test_torch_serving import assert_ids_agree

pytestmark = pytest.mark.fast


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops: one thread a test worker, so that a parallel
    test run does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DIMS = dict(arch="mixtral", vocab_size=256, hidden_size=128,
            intermediate_size=384, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128, num_local_experts=4,
            num_experts_per_tok=2)


@pytest.fixture(scope="module")
def models():
    jcfg = JConfig(**DIMS)
    params = random_quantized_model(jcfg, "E8P12", seed=0,
                                    dtype=jnp.float32, quantize_head=True)
    tcfg = ModelConfig(**DIMS)
    port = TM.fuse_for_inference(tcfg, from_jax_params(params, "cpu"))
    assert "experts_stacked" in port.layers[0]["block_sparse_moe"]
    return jcfg, JM.fuse_for_inference(jcfg, params), tcfg, port


@pytest.mark.parametrize("prefill_chunk", [8, 16])
def test_mixtral_serving_matches_jax(models, prefill_chunk):
    jcfg, jp, tcfg, port = models
    rng = np.random.default_rng(prefill_chunk)
    reqs = [(rng.integers(0, 256, n), m) for n, m in
            ((9, 6), (14, 4), (21, 5))]
    kw = dict(max_batch=2, cache_len=64, prefill_chunk=prefill_chunk,
              decode_chunk=4)
    results = []
    for make in (lambda cb: JEngine(jcfg, jp, dtype=jnp.float32,
                                    on_token=cb, **kw),
                 lambda cb: ServingEngine(tcfg, port, dtype=torch.float32,
                                          on_token=cb, device="cpu", **kw)):
        events = []
        eng = make(lambda rid, tok, done: events.append(
            (rid, int(tok), bool(done))))
        rids = [eng.add_request(p, m) for p, m in reqs]
        res = eng.run(max_steps=200)
        results.append(([np.asarray(res[r]).astype(np.int64) for r in rids],
                        events))
    (jo, je), (to, te) = results
    assert [(r, d) for r, _, d in te] == [(r, d) for r, _, d in je]
    for r, ((p, m), got, want) in enumerate(zip(reqs, to, jo)):
        assert_ids_agree(jcfg, jp, p.shape[0], got, want)
        for ids, events in ((got, te), (want, je)):
            assert [t for q, t, _ in events if q == r] == list(
                ids[p.shape[0]:])
        alone = generate(tcfg, port, torch.from_numpy(p)[None], m,
                         cache_len=64, dtype=torch.float32, device="cpu")
        assert_ids_agree(jcfg, jp, p.shape[0], alone[0].numpy(), got)
