"""Training under a ("dp", "tp") mesh (ROADMAP queue 1 item 8d, first
part) held to the JAX package on four gloo ranks on the CPU, spawned once
for the file (``tests/torch_tp_cases.py`` ``Ranks``; rank cases in
``tests/torch_train_cases.py``): the end-to-end finetune step
(``quantize/finetune.py`` ``make_train_step(mesh=)``, the training
forward of the cut linears of ``parallel/layers.py``) at dp 2 x tp 2 and
dp 1 x tp 2 against ``jax.value_and_grad`` of the loss of JAX's
``make_train_step`` on the unsharded model and one step of its two-LR
optax Adam; the differentiable collectives of ``parallel/comm.py``.

Models are the tiny trees of ``tests/torch_tp_models.py``: llama with
block-diagonal transforms of 2 shards (every cut linear's transform is
the rank's own: it decodes its rows or columns of W) and with whole
transforms (the gather and whole-input routes), GPT-NeoX (its per-head
query_key_value, LayerNorms with biases, quantized biases), and a llama
whose MLP stays dense (a dense column- and row-parallel weight).
Tolerance (f32): 1e-4 of max|.| plus one ulp for the loss, every
gradient gathered into JAX's flat names, and the updated leaves where
|grad| exceeds that (Adam's first step is +-lr sign(g), so a near-zero
gradient's sign, and its update, may flip).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quip_for_all_tpu.models import registry as JR
from quip_for_all_tpu.quantize import finetune as JFT

import torch_tp_cases as C
import torch_tp_models as TM
from torch_train_cases import hold_step
from torch_family_cases import assert_close

pytestmark = pytest.mark.fast

TOL = 1e-4
LRS = (5e-4, 5e-5)          # SU/SV, the rest (the JAX dry run's)
B, S = 4, 8


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
    r = C.Ranks(4)
    yield r
    r.close()


def _dense_mlp(jp, seed=11):
    """The JAX tree with every MLP linear dense (random f32 weights)."""
    rng = np.random.default_rng(seed)
    for blk in jp["layers"]:
        for name, p in blk["mlp"].items():
            blk["mlp"][name] = {"weight": jnp.asarray(
                0.1 * rng.standard_normal((p.out_features, p.in_features)),
                jnp.float32)}
    return jp


MODELS = {"llama_tp2": ("llama", 2), "llama_whole": ("llama", 0),
          "gpt_neox_tp2": ("gpt_neox", 2), "llama_dense_mlp": ("llama", 0)}
_BUILT, _JAX, _RUNS = {}, {}, {}


def _model(key):
    if key not in _BUILT:
        family, tp = MODELS[key]
        jcfg, jp, tcfg, model = TM.build(family, tp)
        if key == "llama_dense_mlp":
            jp = _dense_mlp(jp)
            from quip_for_all_tpu_torch.utils.convert import from_jax_params
            model = from_jax_params(jp, "cpu", tcfg)
        rng = np.random.default_rng(3)
        ids = rng.integers(0, tcfg.vocab_size, (B, S))
        _BUILT[key] = (jcfg, jp, tcfg, model, ids, np.roll(ids, -1, axis=1))
    return _BUILT[key]


def _jax_step(key):
    """JAX's loss, gradients and updated leaves on the unsharded model:
    ``make_train_step``'s loss under ``jax.value_and_grad`` (jitted),
    then one update of ``make_susv_optimizer``."""
    if key not in _JAX:
        jcfg, jp, _, _, ids, tgt = _model(key)
        flat = JFT.collect_trainable(jp)
        apply = JR.get_arch(jcfg).model_apply

        def loss_fn(flat, ids, targets):
            params = JFT.apply_trainable(jp, flat)
            logits, _ = apply(jcfg, params, ids, linear_kw={"training": True})
            logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
            oh = jax.nn.one_hot(targets, logits.shape[-1], dtype=jnp.float32)
            return -(oh * logp).sum(-1).mean()
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            flat, jnp.asarray(ids), jnp.asarray(tgt))
        opt = JFT.make_susv_optimizer(*LRS)
        upd, _ = opt.update(grads, opt.init(flat), flat)
        new = {k: np.asarray(flat[k] + upd[k]) for k in flat}
        _JAX[key] = (float(loss), {k: np.asarray(g) for k, g in
                                   grads.items()}, new)
    return _JAX[key]


def _run(ranks, key, dp):
    if (key, dp) not in _RUNS:
        _, _, tcfg, model, ids, tgt = _model(key)
        path = C.save_model(ranks, key, model)
        _RUNS[key, dp] = ranks.run("torch_train_cases:finetune_step", tcfg,
                                   path, ids, tgt, dp, 2, LRS)
    return _RUNS[key, dp]


# (model, dp): the four ranks as dp 2 x tp 2, or dp 1 x tp 2 on each half
CASES = [("llama_tp2", 2), ("llama_tp2", 1), ("llama_whole", 2),
         ("llama_whole", 1), ("gpt_neox_tp2", 2), ("llama_dense_mlp", 1)]


@pytest.mark.parametrize("key,dp", CASES,
                         ids=[f"{k}-dp{dp}xtp2" for k, dp in CASES])
def test_finetune_step_matches_jax(ranks, key, dp):
    hold_step(_run(ranks, key, dp), _jax_step(key), TOL)


# one leaf of each kind of tensor parallelism's gradient rule: (model,
# leaf, the rank's shape): held whole but used on the rank's part alone
# (summed over tp once: a column-parallel SU, a row-parallel SU on the
# whole-input route), used whole on every rank (not summed: a norm, SV
# after the row sum), and cut over tp (a dense row-parallel weight, a
# column shard's SV)
LEAVES = [("llama_tp2", "layers.0.self_attn.q_proj.SU", (64,)),
          ("llama_whole", "layers.1.mlp.down_proj.SU", (128,)),
          ("llama_tp2", "layers.0.post_attention_layernorm.weight", (64,)),
          ("llama_tp2", "layers.1.self_attn.o_proj.SV", (64,)),
          ("llama_dense_mlp", "layers.0.mlp.down_proj.weight", (64, 64)),
          ("llama_tp2", "layers.0.mlp.up_proj.SV", (64,))]


@pytest.mark.parametrize("key,leaf,shape", LEAVES,
                         ids=[f"{k}-{leaf}" for k, leaf, _ in LEAVES])
def test_each_leaf_kind_takes_the_whole_models_gradient(ranks, key, leaf,
                                                        shape):
    dp = 1 if key == "llama_dense_mlp" else 2
    outs = _run(ranks, key, dp)
    want = _jax_step(key)[1][leaf]
    for _, grads, _, shapes, _ in outs:
        assert shapes[leaf] == shape
        assert np.abs(want).max() > 0
        assert_close(grads[leaf], want, rel=TOL)


def test_leaves_map_one_to_one_onto_jax_names(ranks):
    """A rank holds one tensor for each leaf of JAX's
    ``collect_trainable`` (the gather route's whole right side and the
    rank's unused row slices of SV are not collected twice)."""
    for key, dp in (("llama_whole", 2), ("gpt_neox_tp2", 2)):
        want = set(_jax_step(key)[1])
        for _, _, _, shapes, _ in _run(ranks, key, dp):
            assert set(shapes) == want


def test_step_collectives(ranks):
    """dp 2 x tp 2 with the tp_shards transforms: a forward sums twice a
    block and gathers the head's logits once; the backward sums each of
    the five column-parallel linears' input gradients a block, and the
    head's; the dp group averages the loss and every leaf's gradient."""
    _, _, tcfg, _, _, _ = _model("llama_tp2")
    outs = _run(ranks, "llama_tp2", 2)
    L = tcfg.num_hidden_layers
    leaves = len(outs[0][3])
    for *_, counts in outs:
        assert counts["all_gather"] == 1
        assert counts["all_reduce"] == 2 * L + 5 * L + 1 + 1 + leaves


def test_collectives_differentiate_as_one_rank(ranks):
    for outs, counts in ranks.run("torch_train_cases:comm_grads", 5):
        for name, (got, want) in outs.items():
            np.testing.assert_array_equal(got, want, err_msg=name)
        # the backwards: enter's sum; all_gather's and all_reduce's none
        assert counts["all_reduce"] == 2 and counts["all_gather"] == 1
