"""The int8 KV cache and per-row cache writes (``models/common.py``) held
to the JAX package's ``quip_for_all_tpu/models/common.py`` on the same
numpy-seeded inputs, and cached attention over either cache kind and any
position kind held to JAX ``model_apply``.

int8 codes must be equal exactly and scales within one f32 ulp (the same
f32 ops: |x| max, /127, floor at 1e-8, round half to even, clip); writes
equal exactly (a tensor start clamps into [0, T - S] as
``dynamic_update_slice`` does). Logits of the cached decode are held
within 2e-2 * max|logit|, the rule of ``tests/test_torch_slice.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quip_for_all_tpu.models import common as JC
from quip_for_all_tpu.models import llama as JM
from quip_for_all_tpu.models.config import ModelConfig as JConfig
from quip_for_all_tpu.runtime.generate import init_kv_caches as j_caches
from quip_for_all_tpu.utils.random_quantized import random_quantized_model

from quip_for_all_tpu_torch.models import common as TC
from quip_for_all_tpu_torch.models import llama as TM
from quip_for_all_tpu_torch.models.config import ModelConfig
from quip_for_all_tpu_torch.runtime.generate import init_kv_caches
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


def _x(seed, shape=(2, 5, 2, 16), scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _ulp_close(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.all(np.abs(a - b) <= np.spacing(np.maximum(np.abs(a),
                                                          np.abs(b))))


@pytest.mark.parametrize("seed,shape", [(0, (2, 5, 2, 16)),
                                        (1, (1, 1, 4, 128)),
                                        (2, (3, 7, 1, 64)),
                                        (3, (2, 2, 8, 8))])
def test_kv_quantize_matches_jax(seed, shape):
    x = _x(seed, shape)
    x[0, 0, 0, :] = 0.0                            # the 1e-8 scale floor
    if shape[-1] >= 2:                             # a tie at .5: half to even
        x[-1, -1, -1, :2] = [127.0, 2.5]
    qj, sj = JC.kv_quantize(jnp.asarray(x))
    qt, st = TC.kv_quantize(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert _ulp_close(st.numpy(), sj)
    if shape[-1] >= 2:
        assert qt[-1, -1, -1, 1] == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_materialize_matches_jax(dtype):
    x = _x(4)
    qj, sj = JC.kv_quantize(jnp.asarray(x))
    want = np.asarray(JC.kv_materialize(JC.QuantKVCache(qj, sj),
                                        jnp.dtype(dtype)).astype(jnp.float32))
    q, s = TC.kv_quantize(torch.from_numpy(x))
    got = TC.kv_materialize(TC.QuantKVCache(q, s), getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert np.array_equal(got.float().numpy(), want)


def _caches(quantized, seed, B=2, T=12, KV=2, hd=16):
    """The same random cache contents in both packages."""
    c = _x(seed, (B, T, KV, hd))
    if not quantized:
        return jnp.asarray(c), torch.from_numpy(c.copy())
    q, s = JC.kv_quantize(jnp.asarray(c))
    return (JC.QuantKVCache(q, s),
            TC.QuantKVCache(torch.from_numpy(np.asarray(q).copy()),
                            torch.from_numpy(np.asarray(s).copy())))


def _np(kv):
    if isinstance(kv, (JC.QuantKVCache, TC.QuantKVCache)):
        return np.asarray(kv.data), np.asarray(kv.scale)
    return (np.asarray(kv),)


# (kind, write length S, start): host int, 0-d tensor, per-row (B,)
# tensor, and starts past the end that a tensor clamps
POSITIONS = [("int", 3, 4), ("0d", 3, 4), ("0d", 1, 11), ("rows", 3, [0, 7]),
             ("rows", 1, [11, 2]), ("0d_past_end", 3, 11),
             ("rows_past_end", 4, [10, 30]), ("rows_negative", 2, [-3, 5])]


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("kind,S,start", POSITIONS)
def test_write_kv_matches_jax(kind, S, start, quantized):
    cj, ct = _caches(quantized, 5)
    x = _x(6, (2, S, 2, 16))
    cpt = start if kind == "int" else torch.tensor(start)
    want = JC.write_kv(cj, jnp.asarray(x), jnp.asarray(start))
    got = TC.write_kv(ct, torch.from_numpy(x), cpt)
    assert got is ct                                # written in place
    for g, w in zip(_np(got), _np(want)):
        assert np.array_equal(g, w)


def test_write_kv_matches_jax_write_slab_vmap():
    """The per-row write is JAX's ``_write_slab`` vmap, row by row."""
    c = _x(7, (3, 10, 1, 8))
    x = _x(8, (3, 2, 1, 8))
    cp = np.array([0, 9, 4])
    want = JC._write_slab(jnp.asarray(c), jnp.asarray(x), jnp.asarray(cp))
    got = TC.write_kv(torch.from_numpy(c.copy()), torch.from_numpy(x),
                      torch.from_numpy(cp))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_write_kv_host_int_past_end_raises():
    _, ct = _caches(False, 0)
    with pytest.raises(ValueError, match="past cache length"):
        TC.write_kv(ct, torch.zeros((2, 3, 2, 16)), 10)
    with pytest.raises(TypeError):
        TC.write_kv(ct, torch.zeros((2, 1, 2, 16)), 1.0)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("start", [0, 5, 9, "t3", "t-2", "t40"])
def test_kv_window_and_dyn_slice_match_jax(quantized, start):
    cj, ct = _caches(quantized, 9)
    if isinstance(start, str):
        sj, st = jnp.asarray(int(start[1:])), torch.tensor(int(start[1:]))
    else:
        sj, st = start, start
    for g, w in zip(_np(TC.kv_dyn_slice(ct, st, 3)),
                    _np(JC.kv_dyn_slice(cj, sj, 3))):
        assert np.array_equal(g, w)
    for W in (4, 12, 20):
        for g, w in zip(_np(TC.kv_window(ct, W)), _np(JC.kv_window(cj, W))):
            assert np.array_equal(g, w)
    assert TC.kv_len(ct) == JC.kv_len(cj) == 12


def test_update_kv_cache_matches_jax():
    cj, ct = _caches(True, 10)
    cj2, ct2 = _caches(True, 11)
    k, v = _x(12, (2, 1, 2, 16)), _x(13, (2, 1, 2, 16))
    kj, vj, _ = JC.update_kv_cache((cj, cj2), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray([3, 8]))
    kt, vt, new = TC.update_kv_cache((ct, ct2), torch.from_numpy(k),
                                     torch.from_numpy(v), torch.tensor([3, 8]))
    assert new == (kt, vt)
    for got, want in ((kt, kj), (vt, vj)):
        for g, w in zip(_np(got), _np(want)):
            assert np.array_equal(g, w)
    assert TC.update_kv_cache(None, 1, 2, 0) == (1, 2, None)


@pytest.fixture(scope="module")
def models():
    jcfg = JConfig(**DIMS)
    params = random_quantized_model(jcfg, "E8P12", seed=0,
                                    dtype=jnp.float32, quantize_head=True)
    tcfg = ModelConfig(**DIMS)
    port = TM.fuse_for_inference(tcfg, from_jax_params(params, "cpu"))
    return jcfg, JM.fuse_for_inference(jcfg, params), tcfg, port


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("window", [None, 32])
def test_cached_decode_matches_jax(models, quantized, window):
    """GQA (4 heads over 2 kv heads): a per-row prefill (rows start at 0
    and 3), then a decode step at per-row positions 12 and 15, in both
    cache kinds, with and without a static window."""
    jcfg, jp, tcfg, port = models
    B, S, T = 2, 12, 64
    ids = np.random.default_rng(3).integers(0, 256, (B, S + 1))
    start = np.array([0, 3])
    pos = start[:, None] + np.arange(S)[None]
    jc = j_caches(jcfg, B, T, jnp.float32, quantized=quantized)
    tc = init_kv_caches(tcfg, B, T, torch.float32, "cpu",
                        quantized=quantized)
    kw = {} if window is None else {"attn_window": window}
    _, jc = JM.model_apply(jcfg, jp, jnp.asarray(ids[:, :S]),
                           positions=jnp.asarray(pos), kv_caches=jc,
                           cache_position=jnp.asarray(start),
                           dtype=jnp.float32, **kw)
    TM.model_apply(tcfg, port, torch.from_numpy(ids[:, :S]),
                   positions=torch.from_numpy(pos), kv_caches=tc,
                   cache_position=torch.from_numpy(start),
                   dtype=torch.float32, **kw)
    step = start + S
    jl, _ = JM.model_apply(jcfg, jp, jnp.asarray(ids[:, S:]),
                           positions=jnp.asarray(step[:, None]),
                           kv_caches=jc, cache_position=jnp.asarray(step),
                           dtype=jnp.float32, **kw)
    tl, _ = TM.model_apply(tcfg, port, torch.from_numpy(ids[:, S:]),
                           positions=torch.from_numpy(step[:, None]),
                           kv_caches=tc, cache_position=torch.from_numpy(step),
                           dtype=torch.float32, **kw)
    jl, tl = np.asarray(jl)[:, -1], tl[:, -1].numpy()
    assert np.all(np.isfinite(tl))
    err = np.abs(tl - jl).max(axis=-1)
    assert np.all(err <= 2e-2 * np.abs(jl).max(axis=-1)), err


def test_host_int_position_picks_the_runtime_bucket():
    """JAX's runtime ``lax.switch`` ladder (256, 512, ... capped at T), for
    S == 1 and T >= 512, picked on the host; tensor positions read it all."""
    assert TM.runtime_window(0, 1, 2048) == 256
    assert TM.runtime_window(255, 1, 2048) == 256
    assert TM.runtime_window(256, 1, 2048) == 512
    assert TM.runtime_window(1500, 1, 1536) == 1536
    assert TM.runtime_window(300, 1, 256) is None
    assert TM.runtime_window(10, 4, 2048) is None
    assert TM.runtime_window(torch.tensor(10), 1, 2048) is None
