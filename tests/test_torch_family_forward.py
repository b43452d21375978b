"""The eight model families beside llama and Mixtral (GPT-2, GPT-NeoX with
both residuals, OPT, Falcon multi-query and with the new decoder, Phi,
GPT-J, QWen, Baichuan) in the port, held to the JAX package's families on
the same random quantized weights (``tests/torch_family_cases.py``): the
full forward's logits, six cached decode steps after a four-token
prefill, the fused-or-dense route of every quantized linear, and the
registry's helpers. Tolerance, in f32 compute: 1e-4 of max|logit| plus
one f32 ulp through the model, 1e-5 plus one ulp for the final norm and
the head alone (``tests/torch_family_cases.py`` says why)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import quip_for_all_tpu.ops.dequant_pallas as JDP
import quip_for_all_tpu.ops.quant_matmul as JQM
from quip_for_all_tpu.models import registry as JR
from quip_for_all_tpu.runtime.generate import init_kv_caches as jcaches

import quip_for_all_tpu_torch.nn.qlinear as TQL
import quip_for_all_tpu_torch.ops.quant_matmul as TQM
from quip_for_all_tpu_torch.models import registry as TR
from quip_for_all_tpu_torch.runtime.generate import init_kv_caches

from torch_family_cases import (F32, FAMILIES, MODEL_TOL, T32, assert_close,
                                case)

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


def _ids(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, S))


def test_full_forward_matches_jax(fam):
    jcfg, jp, tcfg, port = fam
    ids = _ids(2, 12)
    want, _ = JR.get_arch(jcfg).model_apply(jcfg, jp, jnp.asarray(ids),
                                            linear_kw=F32)
    got, _ = TR.get_arch(tcfg).model_apply(tcfg, port, torch.from_numpy(ids),
                                           linear_kw=T32)
    assert_close(got.numpy(), np.asarray(want), MODEL_TOL)


def test_cached_decode_matches_jax(fam):
    """A four-token prefill into the cache, then six one-token steps, each
    step's logits held to JAX's."""
    jcfg, jp, tcfg, port = fam
    JA, TA = JR.get_arch(jcfg), TR.get_arch(tcfg)
    ids = _ids(1, 10, 1)
    jc = jcaches(jcfg, 1, 16, dtype=jnp.float32)
    tc = init_kv_caches(tcfg, 1, 16, torch.float32, "cpu")
    for lo, hi in [(0, 4)] + [(t, t + 1) for t in range(4, 10)]:
        pos = np.arange(lo, hi)[None]
        want, jc = JA.model_apply(jcfg, jp, jnp.asarray(ids[:, lo:hi]),
                                  positions=jnp.asarray(pos), kv_caches=jc,
                                  cache_position=lo, linear_kw=F32)
        got, tc = TA.model_apply(tcfg, port, torch.from_numpy(ids[:, lo:hi]),
                                 positions=torch.from_numpy(pos),
                                 kv_caches=tc, cache_position=lo,
                                 linear_kw=T32)
        assert_close(got.numpy(), np.asarray(want), MODEL_TOL)


def _record(monkeypatch, module, name, route, log):
    """Log (q_out, route) at each call of ``module.name``, whose first
    argument that has a q_out is the quantized tensor."""
    orig = getattr(module, name)

    def wrapped(*a, **kw):
        qt = next(v for v in a if hasattr(v, "q_out"))
        log.append((int(qt.q_out), route))
        return orig(*a, **kw)
    monkeypatch.setattr(module, name, wrapped)


def test_route_per_linear_is_jax_route(fam, monkeypatch):
    """Every quantized linear takes the fused kernel route in the port
    exactly where the JAX package takes its fused Pallas route (q_out %
    128 == 0), and the dense decode + matmul elsewhere, in the same call
    order; both routes occur."""
    jcfg, jp, tcfg, port = fam
    jlog, tlog = [], []
    _record(monkeypatch, JDP, "fused_quant_matmul_pre", "fused", jlog)
    _record(monkeypatch, JDP, "fused_quant_matmul", "fused", jlog)
    _record(monkeypatch, JQM, "decode_weights", "dense", jlog)
    _record(monkeypatch, TQL, "fused_quant_matmul_pre", "fused", tlog)
    _record(monkeypatch, TQM, "fused_quant_matmul", "fused", tlog)
    _record(monkeypatch, TQM, "decode_weights", "dense", tlog)
    ids = _ids(1, 5, 2)
    JR.get_arch(jcfg).model_apply(jcfg, jp, jnp.asarray(ids))
    TR.get_arch(tcfg).model_apply(tcfg, port, torch.from_numpy(ids))
    assert tlog == jlog
    assert {r for _, r in tlog} == {"fused", "dense"}
    assert all((q % 128 == 0) == (r == "fused") for q, r in tlog)


def test_registry_helpers_match_jax(fam):
    """embed (learned positions included), rope_tables, final_hidden,
    untied_head_key and head_logits on the same inputs."""
    jcfg, jp, tcfg, port = fam
    ids, pos = _ids(2, 6, 3), np.arange(6)[None].repeat(2, 0) + 3
    je = JR.embed(jcfg, jp, jnp.asarray(ids), jnp.asarray(pos), jnp.float32)
    te = TR.embed(tcfg, port, torch.from_numpy(ids), torch.from_numpy(pos),
                  torch.float32)
    assert np.array_equal(te.numpy(), np.asarray(je))
    jcos, jsin = JR.rope_tables(jcfg, jnp.asarray(pos))
    tcos, tsin = TR.rope_tables(tcfg, torch.from_numpy(pos))
    assert (jcos is None) == (tcos is None)
    if tcos is not None:
        np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin),
                                   rtol=0, atol=1e-6)
    x = np.random.default_rng(4).standard_normal((2, 6, 64)).astype(
        np.float32)
    jh = JR.final_hidden(jcfg, jp, jnp.asarray(x))
    th = TR.final_hidden(tcfg, port, torch.from_numpy(x))
    assert_close(th.numpy(), np.asarray(jh))
    assert TR.untied_head_key(tcfg, port) == JR.untied_head_key(jcfg, jp)
    assert_close(TR.head_logits(tcfg, port, th, T32).numpy(),
                 np.asarray(JR.head_logits(jcfg, jp, jh, F32)))


def test_plain_route_takes_the_dense_route_where_the_rule_says(fam):
    """``matmul_impl="plain"`` (what chip_smoke.py holds the kernels to)
    takes the kernel's plain twin where the shape rule allows the kernel
    and the dense decode + matmul elsewhere: on the CPU, where the default
    route runs the twin too, the same logits bit for bit."""
    _, _, tcfg, port = fam
    ids = torch.from_numpy(_ids(1, 5, 5))
    A = TR.get_arch(tcfg)
    plain, _ = A.model_apply(tcfg, port, ids,
                             linear_kw={"matmul_impl": "plain"})
    auto, _ = A.model_apply(tcfg, port, ids)
    assert torch.equal(plain, auto)
