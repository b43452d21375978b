"""Tensor-sharded serving and generation on gloo ranks on the CPU:
``ServingEngine(mesh=)`` and ``generate`` on a rank's model
(``parallel/sharding.py``) give the unsharded engine's and ``generate``'s
greedy tokens, as ``tests/test_serving.py``'s
``test_serving_tensor_sharded_matches_unsharded`` asserts for the JAX
engine. Two ranks on the (1, 2) mesh, spawned once for the file; models
from ``tests/torch_tp_models.py`` (a tp_shards tree and one without).
f32 activations and f32 compute in the linears, where the two runs differ
by sum order only (1e-6 of max|logit| at these widths), so greedy tokens
agree unless two logits tie that closely.
"""
import numpy as np
import pytest
import torch

from quip_for_all_tpu_torch.runtime.generate import generate
from quip_for_all_tpu_torch.runtime.serving import ServingEngine

import torch_tp_cases as C
import torch_tp_models as TM
from torch_family_cases import MODEL_TOL, T32, assert_close

pytestmark = pytest.mark.fast


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small tensor ops: one torch thread a test worker, set before
    the module's fixtures build their models, so that a parallel test run
    does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

KW = dict(max_batch=2, cache_len=64, dtype=torch.float32, prefill_chunk=8,
          decode_chunk=4, linear_kw=T32)


@pytest.fixture(scope="module")
def ranks():
    r = C.Ranks(2)
    yield r
    r.close()


def _requests(cfg, seed=4):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, n).tolist(), k)
            for n, k in ((5, 6), (12, 4), (3, 7))]


@pytest.mark.parametrize("family,tp,fuse", [("llama", 2, True),
                                            ("llama", 0, False),
                                            ("gpt_neox", 2, False)])
def test_sharded_engine_matches_unsharded(ranks, family, tp, fuse):
    _, _, tcfg, model = TM.build(family, tp, fuse=fuse)
    reqs = _requests(tcfg)
    eng = ServingEngine(tcfg, model, device="cpu", **KW)
    for prompt, n in reqs:
        eng.add_request(np.asarray(prompt), n)
    want = eng.run()
    outs = ranks.run("serve", tcfg, C.save_model(ranks, "model", model),
                     reqs, KW)
    for got, counts, kv in outs:
        assert set(got) == set(want)
        for rid in want:
            assert np.array_equal(got[rid], want[rid]), rid
        # every step's token came from rank 0; the cache holds the
        # rank's kv heads
        assert counts["broadcast"] > 0
        assert kv == tcfg.num_key_value_heads // 2


def test_sharded_generate_matches_unsharded(ranks):
    _, _, tcfg, model = TM.build("llama", 2, fuse=True)
    ids = np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 7))
    kw = dict(cache_len=32, dtype=torch.float32, linear_kw=T32)
    want, wlog = generate(tcfg, model, torch.as_tensor(ids), 6,
                          device="cpu", return_logits=True, **kw)
    outs = ranks.run("generate", tcfg, C.save_model(ranks, "model", model),
                     ids, 6, kw)
    for got, glog in outs:
        assert np.array_equal(got, want.numpy())
        assert_close(glog, torch.stack(wlog).numpy(), rel=MODEL_TOL)
