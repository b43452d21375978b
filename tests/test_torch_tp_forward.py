"""Tensor parallelism's sharded forward (``parallel/sharding.py``
``shard_params``, ``parallel/layers.py``) on gloo ranks on the CPU, held
to the JAX package: two ranks on the (1, 2) mesh (spawned once for the
file, every case run in that one group) and one case of four ranks on
(2, 2).

Each case builds a tiny model on the JAX side (``tests/torch_tp_models.py``:
random codes, a block-diagonal transform of 2 shards on the sharded side
where the case says ``tp2``, else the whole transforms of a checkpoint
quantized without ``tp_shards``, which the ranks gather around), carries
it to the port, shards it on every rank and runs the causal forward and,
for some, a prefill and cached steps. f32 logits (f32 compute in the
linears) must hold to JAX's unsharded ``model_apply`` within 1e-4 of
max|logit| plus one ulp (``torch_family_cases.MODEL_TOL``), and every rank
must give the same logits. One case is also held to JAX's own sharded run
on its 8-device CPU mesh, as ``tests/test_tp_shards.py`` runs it.
"""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from quip_for_all_tpu.models import registry as JR
from quip_for_all_tpu.parallel.sharding import make_mesh as jax_mesh
from quip_for_all_tpu.parallel.sharding import shard_params as jax_shard

import torch_tp_cases as C
import torch_tp_models as TM
from torch_family_cases import F32, MODEL_TOL, T32, assert_close

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


@pytest.fixture(scope="module")
def ranks():
    r = C.Ranks(2)
    yield r
    r.close()


def _ids(cfg, B=2, S=10, seed=5):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _run(ranks, tcfg, model, ids, cached=0, dp=1, tp=2):
    path = C.save_model(ranks, "model", model)
    outs = ranks.run("forward", tcfg, path, ids, dp, tp, torch.float32,
                     cached, T32)
    for o in outs[1:]:
        assert np.array_equal(o[0], outs[0][0]), "the ranks disagree"
    return outs


# (family, block-diagonal tp, port layout, codebook, fuse, cached steps):
# llama unfused and fused, with tp_shards and without; GPT-NeoX (fused
# per-head interleaved query_key_value, parallel residual) and its
# sequential variant; Falcon multi-query (1 kv head: attention gathered)
# and the new decoder (2 kv groups, sharded); Baichuan's W_pack and
# QWen's c_attn ([q|k|v] contiguous: the rank reads its slice of each);
# GPT-2 and OPT; the bfp layout (row pairs) and the paired layout (its
# row-parallel linears replicate, as the JAX package's rule says)
CASES = [
    ("llama", 2, None, "E8P12", False, 3),
    ("llama", 0, None, "E8P12", False, 3),
    ("llama", 2, None, "E8P12", True, 3),
    ("llama", 0, None, "E8P12", True, 0),
    ("gpt_neox", 2, None, "E8P12", False, 3),
    ("gpt_neox_seq", 0, None, "E8P12", False, 0),
    ("falcon", 2, None, "E8P12", False, 3),
    ("falcon_new", 2, None, "E8P12", False, 0),
    ("baichuan", 2, None, "E8P12", True, 0),
    ("qwen", 0, None, "E8P12", True, 3),
    ("gpt2", 2, None, "E8P12", False, 0),
    ("opt", 0, None, "E8P12", False, 0),
    ("llama", 2, "bfp", "E8P12", True, 0),
    ("llama", 2, "paired", "E8P12RVQ4B", True, 3),
]


@pytest.mark.parametrize("family,tp,layout,codebook,fuse,cached", CASES,
                         ids=[f"{c[0]}-tp{c[1]}-{c[2] or 'nibble'}"
                              f"{'-fused' if c[4] else ''}"
                              f"{'-cached' if c[5] else ''}" for c in CASES])
def test_sharded_forward_matches_jax(ranks, family, tp, layout, codebook,
                                     fuse, cached):
    jcfg, jp, tcfg, model = TM.build(family, tp, layout, codebook, fuse)
    ids = _ids(tcfg)
    want = TM.jax_logits(jcfg, jp, ids)
    outs = _run(ranks, tcfg, model, ids, cached)
    assert_close(outs[0][0], want, rel=MODEL_TOL)
    # each rank holds a part of the planes (not half: at these widths a
    # row shard's columns pad back to 128 groups, and a replicated head,
    # GPT-NeoX's embed_out, is whole on each)
    whole = sum(b.numel() * b.element_size()
                for n, b in model.named_buffers() if "planes_" in n)
    assert outs[0][2] < whole


def test_block_diagonal_shards_need_no_gather(ranks):
    """With tp_shards transforms, a llama rank gathers only the head's
    logits: one all_gather and two all_reduce per block a forward."""
    jcfg, jp, tcfg, model = TM.build("llama", 2, fuse=True)
    outs = _run(ranks, tcfg, model, _ids(tcfg))
    counts = outs[0][1]
    assert counts["all_reduce"] == 2 * tcfg.num_hidden_layers
    assert counts["all_gather"] == 1


def test_shards_1_checkpoint_gathers_around_whole_transforms(ranks):
    """Without tp_shards, each column-parallel output is gathered before
    its whole right transform (q, k, v, gate, up and the head), and each
    row-parallel input before its whole left transform (o, down)."""
    jcfg, jp, tcfg, model = TM.build("llama", 0)
    outs = _run(ranks, tcfg, model, _ids(tcfg))
    assert outs[0][1]["all_gather"] == 7 * tcfg.num_hidden_layers + 1
    assert outs[0][1]["all_reduce"] == 2 * tcfg.num_hidden_layers


def test_matches_jax_own_sharded_run(ranks):
    """JAX's GSPMD run of the same tp_shards tree on its (1, 2) mesh of the
    8-device CPU backend, as tests/test_tp_shards.py runs it."""
    jcfg, jp, tcfg, model = TM.build("llama", 2)
    ids = _ids(tcfg)
    mesh = jax_mesh(2, dp=1)
    sp = jax_shard(jcfg, jp, mesh)
    ids_sh = jax.device_put(ids, NamedSharding(mesh, P(None, None)))
    with mesh:
        want, _ = jax.jit(lambda p, i: JR.get_arch(jcfg).model_apply(
            jcfg, p, i, dtype=np.float32, linear_kw=F32))(sp, ids_sh)
    outs = _run(ranks, tcfg, model, ids)
    assert_close(outs[0][0], np.asarray(want), rel=MODEL_TOL)


def test_four_ranks_on_a_2x2_mesh():
    """dp 2 x tp 2: each data-parallel replica's tp pair computes the
    whole model's logits."""
    jcfg, jp, tcfg, model = TM.build("llama", 2, fuse=True)
    ids = _ids(tcfg)
    want = TM.jax_logits(jcfg, jp, ids)
    four = C.Ranks(4)
    try:
        outs = _run(four, tcfg, model, ids, cached=2, dp=2, tp=2)
    finally:
        four.close()
    assert_close(outs[0][0], want, rel=MODEL_TOL)
