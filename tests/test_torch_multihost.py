"""The port's multihost entry (``parallel/multihost.py``: ``initialize``,
``make_hybrid_mesh``, ``mesh_topology``) held to the JAX package's, as
``tests/test_multihost.py`` checks it: a no-op ``initialize`` in one
process and a join from torchrun's environment variables in spawned
ones (the file's four gloo ranks, spawned once, join so); the hybrid
mesh's axes and shapes with and without an expert axis; hosts on the
outer "dp" axis (torchrun's GROUP_RANK set out of order on the four
ranks); the topology strings equal
to JAX's for the same shapes; and the sharded f32 decode step on a hybrid
dp 2 x tp 2 mesh, the batch split over dp, against JAX's run on its own
hybrid mesh of four virtual CPU devices and the port's unsharded step.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from quip_for_all_tpu.models.config import ModelConfig as JConfig
from quip_for_all_tpu.parallel import multihost as jmh
from quip_for_all_tpu.parallel.sharding import kv_cache_specs, shard_params
from quip_for_all_tpu.runtime.generate import decode_step_fn, init_kv_caches
from quip_for_all_tpu.utils.random_quantized import random_quantized_model

from quip_for_all_tpu_torch.models.config import ModelConfig
from quip_for_all_tpu_torch.parallel import multihost
from quip_for_all_tpu_torch.runtime.generate import (
    decode_step_fn as tdecode_step_fn, init_kv_caches as tinit_kv_caches)
from quip_for_all_tpu_torch.utils.convert import from_jax_params

import torch_tp_cases as C
from torch_family_cases import MODEL_TOL, T32, assert_close

pytestmark = pytest.mark.fast

# tests/test_multihost.py's model
DIMS = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
            num_hidden_layers=2, num_attention_heads=8,
            num_key_value_heads=4, max_position_embeddings=128)
ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "GROUP_RANK")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small tensor ops: one torch thread a test worker, set before
    the module's fixtures build their models, so that a parallel test run
    does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks():
    r = C.Ranks(4, join="env")
    yield r
    r.close()


def test_initialize_single_process_noop(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() == 0 == jmh.initialize()
    assert not torch.distributed.is_initialized()


def test_initialize_incomplete_config_raises(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    with pytest.raises(ValueError, match="num_processes"):
        multihost.initialize()
    assert not torch.distributed.is_initialized()


def test_initialize_joins_from_env(ranks):
    """Four spawned processes with torchrun's variables join one gloo
    group: initialize returns each rank, an all_reduce sums all four, and
    the hybrid mesh's defaults are one host's (dcn_dp 1, tp the world)."""
    assert ranks.run("torch_ep_cases:joined") == [
        (r, r, 10.0, 1, 4) for r in range(4)]


@pytest.mark.parametrize("dcn_dp,ici_tp,ici_ep", [(2, 2, 1), (1, 2, 2),
                                                  (2, 1, 2), (None, None, 1)])
def test_hybrid_mesh_axes_shapes_and_topology(ranks, dcn_dp, ici_tp, ici_ep):
    """Axes and shapes with and without ep, and the topology string equal
    to JAX's ``mesh_topology`` of its hybrid mesh of the same shape (one
    host: dcn_dp defaults to 1)."""
    outs = ranks.run("torch_ep_cases:hybrid", dcn_dp, ici_tp, ici_ep)
    want_dp = dcn_dp or 1
    want_tp = ici_tp or 4 // (want_dp * ici_ep)
    jmesh = jmh.make_hybrid_mesh(want_dp, want_tp, ici_ep,
                                 devices=jax.devices()[:4])
    for g, m in enumerate(outs):
        assert m["axis_names"] == tuple(jmesh.axis_names)
        assert m["shape"] == dict(jmesh.shape)
        assert m["topology"] == jmh.mesh_topology(jmesh)
        # one host: ranks in global order, row-major
        assert m["coords"] == (g // (ici_ep * want_tp),
                               (g // want_tp) % ici_ep, g % want_tp)
    if ici_ep == 2 and want_dp == 1:
        assert outs[0]["topology"] == "dcn[dp=1] x ici[ep=2 x tp=2]"


@pytest.mark.parametrize("hosts,rows", [
    ((1, 1, 0, 0), ((2, 3), (0, 1))),      # hosts numbered out of order
    ((0, 1, 0, 1), ((0, 2), (1, 3))),      # ranks interleaved over hosts
])
def test_hybrid_mesh_puts_hosts_on_outer_axis(ranks, hosts, rows):
    """With GROUP_RANK set per rank, every dp row holds one host's ranks
    (sorted by (host, global rank), as JAX's fallback sorts devices by
    (process_index, id)); dcn_dp defaults to the number of hosts."""
    outs = ranks.run("torch_ep_cases:hybrid", None, None, 1, list(hosts))
    for g, m in enumerate(outs):
        assert m["shape"] == {"dp": 2, "tp": 2}
        d = next(i for i, row in enumerate(rows) if g in row)
        assert m["coords"] == (d, 0, rows[d].index(g))
        assert m["tp_ranks"] == rows[d] == m["replica_ranks"]
        assert m["topology"] == "dcn[dp=2] x ici[tp=2]"
    ep = ranks.run("torch_ep_cases:hybrid", 1, 2, 2, list(hosts))
    for g, m in enumerate(ep):
        # one dp row of both hosts: ep rows are hosts, tp within a host
        assert m["coords"][0] == 0
        assert m["tp_ranks"] == rows[m["coords"][1]]
        assert m["replica_ranks"] == rows[0] + rows[1]


def test_sharded_decode_on_hybrid_mesh(ranks):
    """tests/test_multihost.py's decode step: the rank's model on the
    hybrid dp 2 x tp 2 mesh, tokens [3, 5] split over dp, position 5,
    f32: each dp row's logits against JAX's on its hybrid mesh (kv caches
    sharded on tp, the batch on dp) and against the port's unsharded
    step."""
    jcfg, tcfg = JConfig(**DIMS), ModelConfig(**DIMS)
    jp = random_quantized_model(jcfg, codebook="E8P12", seed=0,
                                dtype=jnp.float32)
    tok = np.array([3, 5], np.int32)
    f32 = {"compute_dtype": jnp.float32}
    port = from_jax_params(jp, "cpu")
    one, _ = tdecode_step_fn(tcfg, dtype=torch.float32, linear_kw=T32)(
        port, tinit_kv_caches(tcfg, 2, 64, torch.float32, "cpu"),
        torch.as_tensor(tok), 5)
    mesh = jmh.make_hybrid_mesh(dcn_dp=2, ici_tp=2,
                                devices=jax.devices()[:4])
    sp = shard_params(jcfg, jp, mesh)
    ksh = NamedSharding(mesh, kv_cache_specs(mesh, jcfg.num_key_value_heads))
    caches = [tuple(jax.device_put(c, ksh) for c in kv)
              for kv in init_kv_caches(jcfg, 2, 64, dtype=jnp.float32)]
    with mesh:
        hyb, _ = jax.jit(decode_step_fn(jcfg, cache_len=64,
                                        dtype=jnp.float32, linear_kw=f32))(
            sp, caches, jax.device_put(jnp.asarray(tok),
                                       NamedSharding(mesh, P("dp"))),
            jnp.asarray(5, jnp.int32))
    one, hyb = one.numpy(), np.asarray(hyb)
    outs = ranks.run("torch_ep_cases:hybrid_decode", tcfg,
                     C.save_model(ranks, "llama", port), tok, 5, 2, 2)
    assert sorted(d for _, d in outs) == [0, 0, 1, 1]
    for logits, d in outs:
        assert logits.shape == (1, tcfg.vocab_size)
        assert_close(logits[0], one[d], rel=MODEL_TOL)
        assert_close(logits[0], hyb[d], rel=MODEL_TOL)
