"""Expert parallelism (ROADMAP queue 1 item 8c) held to the JAX package:
``nn/qmoe.py`` ``moe_dense_stacked_apply`` against JAX's, the
``set_moe_dense_stacked`` switch on a whole model against JAX's decode
step under QFA_MOE_DENSE_STACKED=1, and a Mixtral sharded over an expert
axis (``parallel/sharding.py`` ``make_mesh(ep=)``, ``shard_params``,
``parallel/layers.py`` ``ExpertParallelMoE``) on four gloo ranks on the
CPU, spawned once for the file: ep 2 x tp 1 (two replicas) and ep 2 x
tp 2.

The tiny Mixtral is ``tests/test_qmoe.py``'s (E = 4, top-2) with random
E8P12 codes from the JAX package's ``random_quantized_model``, carried
across by ``from_jax_params``. Everything runs in f32 compute, where the
two packages and the sharded runs differ by sum order only: an MoE
layer within 1e-5 of max|out| plus one ulp, logits within
``MODEL_TOL`` (1e-4 of max|logit|) plus one ulp, and greedy and served
ids equal to the unsharded port model's. The JAX package's sharded
reference is its GSPMD run on its 8 virtual CPU devices, as
``tests/test_qmoe.py`` ``test_expert_parallel_mesh`` runs it.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

from quip_for_all_tpu.models import llama as JM
from quip_for_all_tpu.models.config import ModelConfig as JConfig
from quip_for_all_tpu.nn import qmoe as jqmoe
from quip_for_all_tpu.parallel import sharding as jsh
from quip_for_all_tpu.runtime import generate as jgen
from quip_for_all_tpu.utils.random_quantized import random_quantized_model

import quip_for_all_tpu_torch as qt
from quip_for_all_tpu_torch.models import llama as TM
from quip_for_all_tpu_torch.models.config import ModelConfig
from quip_for_all_tpu_torch.nn import qlinear as tql
from quip_for_all_tpu_torch.nn import qmoe as tqmoe
from quip_for_all_tpu_torch.runtime.generate import (decode_step_fn,
                                                     generate,
                                                     init_kv_caches)
from quip_for_all_tpu_torch.runtime.serving import ServingEngine
from quip_for_all_tpu_torch.utils.convert import from_jax_params

import torch_tp_cases as C
from torch_family_cases import MODEL_TOL, T32, assert_close

pytestmark = pytest.mark.fast

# tests/test_qmoe.py's tiny Mixtral
MIX = dict(arch="mixtral", vocab_size=256, hidden_size=64,
           intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=128,
           num_local_experts=4, num_experts_per_tok=2)
LAYER_TOL = 1e-5
# (dp, ep, tp) on the four ranks
MESHES = [(2, 2, 1), (1, 2, 2)]
MESH_IDS = ["ep2-tp1", "ep2-tp2"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small tensor ops: one torch thread a test worker, set before
    the module's fixtures build their models, so that a parallel test run
    does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(E=4):
    kw = dict(MIX, num_local_experts=E)
    jcfg, tcfg = JConfig(**kw), ModelConfig(**kw)
    jp = random_quantized_model(jcfg, "E8P12", seed=0, dtype=jnp.float32,
                                quantize_head=True)
    port = from_jax_params(jp, "cpu")
    return jcfg, jp, tcfg, port


@pytest.fixture(scope="module")
def mix():
    jcfg, jp, tcfg, port = _build()
    return (jcfg, jp, JM.fuse_for_inference(jcfg, jp), tcfg, port,
            TM.fuse_for_inference(tcfg, port))


def _jax_logits(jcfg, jp, ids):
    """JAX's unsharded f32 logits of ``ids`` (f32 compute), one jitted
    forward: its interpret-mode kernels compile once, where the eager
    forward compiles them op by op."""
    fwd = jax.jit(lambda p, i: JM.model_apply(
        jcfg, p, i, dtype=jnp.float32,
        linear_kw={"compute_dtype": jnp.float32})[0])
    return np.asarray(fwd(jp, jnp.asarray(ids)))


@pytest.fixture(scope="module")
def mix_logits(mix):
    """JAX's logits of ``_ids`` on the fixture's model."""
    jcfg, jp, _, tcfg, _, _ = mix
    return _jax_logits(jcfg, jp, _ids(tcfg))


@pytest.fixture(scope="module")
def ranks():
    r = C.Ranks(4)
    yield r
    r.close()


def _x(cfg, B, S, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.hidden_size)).astype(np.float32)


def _ids(cfg, B=2, S=10, seed=5):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _jax_dense(jcfg, jmoe, x):
    """JAX's unsharded dense-stacked layer on x, jitted (its interpret-mode
    kernels run ~5x faster compiled than op by op)."""
    @jax.jit
    def f(moe, x):
        return jqmoe.moe_dense_stacked_apply(
            jcfg, moe, x, JM.linear_apply(moe["gate"], x),
            compute_dtype=jnp.float32)
    return np.asarray(f(jmoe, jnp.asarray(x)))


@pytest.mark.parametrize("layer,B,S", [(0, 1, 1), (1, 2, 5), (0, 3, 12)])
def test_dense_stacked_apply_matches_jax(mix, layer, B, S):
    jcfg, _, jfused, tcfg, _, tfused = mix
    jmoe = jfused["layers"][layer]["block_sparse_moe"]
    tmoe = tfused.layers[layer]["block_sparse_moe"]
    x = _x(tcfg, B, S, seed=layer + S)
    want = _jax_dense(jcfg, jmoe, x)
    xt = torch.from_numpy(x)
    logits = TM.linear_apply(tmoe["gate"], xt)
    for impl in ("auto", "plain"):
        got = tqmoe.moe_dense_stacked_apply(
            tcfg, tmoe, xt, logits, compute_dtype=torch.float32,
            matmul_impl=impl)
        assert_close(got.numpy(), want, rel=LAYER_TOL)


def test_set_moe_dense_stacked_matches_jax_decode_step(mix, monkeypatch):
    """Three decode steps of the whole model with the switch on, against
    JAX's ``decode_step_fn`` traced under QFA_MOE_DENSE_STACKED=1; the
    switch moves the layer-switch epoch and turns off again."""
    jcfg, _, jfused, tcfg, _, tfused = mix
    tok = np.array([3, 5])
    monkeypatch.setenv("QFA_MOE_DENSE_STACKED", "1")
    jstep = jax.jit(jgen.decode_step_fn(jcfg, cache_len=16,
                                        dtype=jnp.float32,
                                        linear_kw={"compute_dtype":
                                                   jnp.float32}))
    jcaches = jgen.init_kv_caches(jcfg, 2, 16, dtype=jnp.float32)
    epoch = tql.switch_epoch()
    assert qt.set_moe_dense_stacked(tfused, True) is tfused
    assert tql.switch_epoch() > epoch
    try:
        step = decode_step_fn(tcfg, dtype=torch.float32, linear_kw=T32)
        caches = init_kv_caches(tcfg, 2, 16, torch.float32, "cpu")
        for pos in range(3):
            want, jcaches = jstep(jfused, jcaches, jnp.asarray(tok),
                                  jnp.asarray(pos, jnp.int32))
            got, caches = step(tfused, caches, torch.as_tensor(tok), pos)
            assert_close(got.numpy(), np.asarray(want), rel=MODEL_TOL)
            tok = np.asarray(want).argmax(-1)
    finally:
        qt.set_moe_dense_stacked(tfused, False)
    assert not any(m.dense_stacked for m in tfused.modules()
                   if isinstance(m, tqmoe.StackedQuantLinear))


def _jax_ep_layer(jcfg, jmoe, x, ep, tp):
    """JAX's GSPMD run of the dense-stacked layer with the stacked experts
    sharded over ("ep", "tp") on ep * tp of its virtual devices."""
    mesh = jsh.make_mesh(ep * tp, dp=1, tp=tp, ep=ep)
    st = jmoe["experts_stacked"]
    sharded = {name: jax.tree_util.tree_map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), st[name],
        jsh.stacked_spec(st[name], "col" if name == "w13" else "row", tp,
                         "ep", ep)) for name in ("w13", "w2")}
    moe = {"gate": jmoe["gate"], "experts_stacked": sharded}
    logits = JM.linear_apply(jmoe["gate"], jnp.asarray(x))

    @jax.jit
    def f(mp, x, lg):
        return jqmoe.moe_dense_stacked_apply(jcfg, mp, x, lg,
                                             compute_dtype=jnp.float32)
    with mesh:
        return np.asarray(f(moe, jnp.asarray(x), logits))


@pytest.mark.parametrize("dp,ep,tp", MESHES, ids=MESH_IDS)
def test_rank_moe_layer_matches_jax_gspmd(mix, ranks, dp, ep, tp):
    """A rank's MoE block (its E/ep experts, one all_reduce over ep)
    against JAX's GSPMD run and against the port's unsharded layer; the
    ranks' experts are theirs by ep index."""
    jcfg, _, jfused, tcfg, _, tfused = mix
    x = _x(tcfg, 1, 4)
    jmoe = jfused["layers"][0]["block_sparse_moe"]
    want = _jax_ep_layer(jcfg, jmoe, x, ep, tp)
    tmoe = tfused.layers[0]["block_sparse_moe"]
    xt = torch.from_numpy(x)
    whole = tqmoe.moe_dense_stacked_apply(
        tcfg, tmoe, xt, TM.linear_apply(tmoe["gate"], xt),
        compute_dtype=torch.float32).numpy()
    outs = ranks.run("torch_ep_cases:moe_layer", tcfg,
                     C.save_model(ranks, "mix", tfused), 0, x, dp, ep, tp)
    E = tcfg.num_local_experts
    for r, (got, counts, (offset, held), kind, _) in enumerate(outs):
        assert kind == "ExpertParallelMoE" and held == E // ep
        assert offset == ((r // tp) % ep) * held
        assert counts["all_reduce"] == 1 and counts["all_gather"] == 0
        assert_close(got, want, rel=LAYER_TOL)
        assert_close(got, whole, rel=LAYER_TOL)
        assert np.array_equal(got, outs[0][0])


@pytest.mark.parametrize("dp,ep,tp", MESHES, ids=MESH_IDS)
def test_ep_forward_matches_jax(mix, mix_logits, ranks, dp, ep, tp):
    """f32 logits of a prefill and three cached decode steps on every
    rank against JAX's unsharded forward; every rank routes each token to
    the same experts; the collectives a forward as predicted: one ep sum a
    block, and at tp 2 (whole transforms: the gather route) q/k/v's and
    o's gathers, o's sum and the head's gather."""
    *_, tcfg, _, tfused = mix
    ids, want = _ids(tcfg), mix_logits
    cached = 3
    outs = ranks.run("torch_ep_cases:forward_topk", tcfg,
                     C.save_model(ranks, "mix", tfused), ids, dp, ep, tp,
                     cached, T32)
    L, fwd = tcfg.num_hidden_layers, 1 + cached
    for logits, counts, _, topk in outs:
        assert_close(logits, want, rel=MODEL_TOL)
        assert np.array_equal(logits, outs[0][0])
        assert len(topk) == L * fwd
        for a, b in zip(topk, outs[0][3]):
            assert np.array_equal(a, b)
        if tp == 1:
            assert counts["all_reduce"] == L * fwd
            assert counts["all_gather"] == 0
        else:
            assert counts["all_reduce"] == 2 * L * fwd
            assert counts["all_gather"] == (2 * L + 1) * fwd


@pytest.mark.parametrize("dp,ep,tp", MESHES, ids=MESH_IDS)
def test_ep_generate_and_serving_match_unsharded(mix, ranks, dp, ep, tp):
    """Greedy ``generate`` and ``ServingEngine(mesh=)`` in f32 on every
    rank give the unsharded port model's ids; the sampled tokens are
    broadcast over the replica (ep x tp ranks)."""
    *_, tcfg, _, tfused = mix
    path = C.save_model(ranks, "mix", tfused)
    ids = _ids(tcfg, 2, 7, seed=2)
    kw = dict(cache_len=32, dtype=torch.float32, linear_kw=T32)
    want, wlog = generate(tcfg, tfused, torch.as_tensor(ids), 6,
                          device="cpu", return_logits=True, **kw)
    for got, glog in ranks.run("generate", tcfg, path, ids, 6, kw, dp, tp,
                               ep):
        assert np.array_equal(got, want.numpy())
        assert_close(glog, torch.stack(wlog).numpy(), rel=MODEL_TOL)
    skw = dict(max_batch=2, cache_len=64, dtype=torch.float32,
               prefill_chunk=8, decode_chunk=4, linear_kw=T32)
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(0, tcfg.vocab_size, n).tolist(), k)
            for n, k in ((5, 6), (12, 4), (3, 7))]
    eng = ServingEngine(tcfg, tfused, device="cpu", **skw)
    for prompt, n in reqs:
        eng.add_request(np.asarray(prompt), n)
    served = eng.run()
    for got, counts, kv in ranks.run("serve", tcfg, path, reqs, skw, dp, tp,
                                     ep):
        assert set(got) == set(served)
        for rid in served:
            assert np.array_equal(got[rid], served[rid]), rid
        assert counts["broadcast"] > 0
        assert kv == tcfg.num_key_value_heads // tp


def test_experts_that_ep_does_not_divide_stay_whole(ranks):
    """E = 3 at ep = 2: every rank keeps all three experts (the JAX
    package's ``stacked_spec`` leaves E unsharded), runs the unsharded
    routes and sums nothing over ep, giving the unsharded model's
    logits."""
    jcfg, jp, tcfg, port = _build(E=3)
    fused = TM.fuse_for_inference(tcfg, port)
    ids = _ids(tcfg)
    want = _jax_logits(jcfg, jp, ids)
    path = C.save_model(ranks, "mix3", fused)
    x = _x(tcfg, 1, 4)
    for _, counts, (offset, held), kind, _ in ranks.run(
            "torch_ep_cases:moe_layer", tcfg, path, 0, x, 2, 2, 1):
        assert (kind, offset, held) == ("ModuleDict", 0, 3)
        assert counts["all_reduce"] == 0
    with torch.no_grad():
        one, _ = qt.get_arch(tcfg).model_apply(
            tcfg, fused, torch.as_tensor(ids), dtype=torch.float32,
            linear_kw=T32)
    for logits, counts, *_ in ranks.run("torch_ep_cases:forward_topk", tcfg,
                                        path, ids, 2, 2, 1, 0, T32):
        assert counts["all_reduce"] == 0
        assert np.array_equal(logits, one.numpy())
        assert_close(logits, want, rel=MODEL_TOL)


def test_unstacked_experts_shard_by_role(mix, mix_logits, ranks):
    """Experts that do not stack (the unfused model) shard one by one by
    the role tables at ep 2 x tp 2: w1 and w3 column-parallel (each rank
    half of the rows), w2 row-parallel (half of the inputs); the logits
    hold to JAX's."""
    *_, tcfg, port, _ = mix
    path = C.save_model(ranks, "mix_unfused", port)
    D, I = tcfg.hidden_size, tcfg.intermediate_size
    for got in ranks.run("torch_ep_cases:expert_linears", tcfg, path, 1, 2,
                         2):
        assert got == {"w1": ("ColParallel", I // 2, D),
                       "w3": ("ColParallel", I // 2, D),
                       "w2": ("RowParallel", D, I // 2)}
    outs = ranks.run("torch_ep_cases:forward_topk", tcfg, path,
                     _ids(tcfg), 1, 2, 2, 2, T32)
    for logits, *_ in outs:
        assert_close(logits, mix_logits, rel=MODEL_TOL)
        assert np.array_equal(logits, outs[0][0])


@pytest.mark.parametrize("dp,ep,tp", [(1, 2, 2), (2, 2, 1), (4, 1, 1),
                                      (2, 1, 2)])
def test_make_mesh_lays_out_dp_ep_tp(ranks, dp, ep, tp):
    """Global rank g at (g // (ep tp), (g // tp) % ep, g % tp), as JAX's
    ``reshape(dp, ep, tp)``; the ep group shares dp and tp index, the
    replica its dp index; at ep = 1 the replica group is the tp group."""
    outs = ranks.run("torch_ep_cases:mesh_layout", dp, ep, tp)
    grid = np.arange(4).reshape(dp, ep, tp)
    for g, m in enumerate(outs):
        d, e, t = g // (ep * tp), (g // tp) % ep, g % tp
        assert m["coords"] == (d, e, t)
        assert m["tp_ranks"] == tuple(grid[d, e])
        assert m["replica_ranks"] == tuple(grid[d].ravel())
        if ep > 1:
            assert m["ep_ranks"] == tuple(grid[d, :, t])
            assert m["axis_names"] == ("dp", "ep", "tp")
            assert m["shape"] == {"dp": dp, "ep": ep, "tp": tp}
        else:
            assert m["tp_is_replica"] and m["axis_names"] == ("dp", "tp")
            assert m["shape"] == {"dp": dp, "tp": tp}
