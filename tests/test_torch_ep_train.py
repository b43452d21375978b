"""Training over the expert axis (ROADMAP queue 1 item 8d) held to the
JAX package on four gloo ranks on the CPU, spawned once for the file
(``tests/torch_tp_cases.py`` ``Ranks``; rank cases in
``tests/torch_train_cases.py`` and ``tests/torch_ep_cases.py``): a
Mixtral whose stacked experts are cut over "ep" (``parallel/sharding.py``
``shard_params``, ``parallel/layers.py`` ``ExpertParallelMoE``) takes the
end-to-end finetune step (``quantize/finetune.py`` ``make_train_step(
mesh=)``) at ep 2 x tp 2 and dp 2 x ep 2, and a LoRA step at ep 2 x tp 2,
against the JAX package's steps on the unsharded model: the loss and
gradients of ``jax.value_and_grad`` (``make_train_step``'s loss; the
LoRA loss of ``quantize/lora_train.py``) and one update of its optimizer
(the two-LR Adam; ``train_lora``'s AdamW).

JAX's ``make_train_step`` does not depend on the mesh: under GSPMD its
training forward, and any forward of 32 tokens or more, takes the
per-expert dense loop over the unstacked experts
(``quip_for_all_tpu/models/llama.py:215-242``). A rank's forward that
autograd differentiates takes that loop over its own experts, its
partial summed over "ep"; a forward without gradients keeps the
dense-stacked route (one MoE kernel launch a stacked linear).

The model is ``tests/test_torch_lora_mixtral.py``'s tiny Mixtral (E = 4,
top-2, random E8P12 codes from the JAX package's
``random_quantized_model``, wscale x0.03, experts stacked, attention
unfused), carried across by ``from_jax_params``: its widths are
multiples of 128, so the experts and the head take the fused route (the
kernels' twins on the CPU, K3's in the backward). Everything runs in f32.
The wscale is x0.03, not x0.1: at x0.1 JAX's own f32 step puts a
router-weight gradient 1.2e-4 of its max off an f64 forward of the same
model, at the edge of the tolerance; at x0.03 every leaf of JAX's step is
within 1.6e-5 of the f64 one.
Tolerance: 1e-4 of max|.| plus one ulp for the loss, every gradient
gathered into JAX's flat names, and the updated leaves where |grad|
exceeds that (``torch_train_cases.hold_step``); an MoE block's output
and gradients within 1e-5 of their max.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from quip_for_all_tpu.models import llama as JM
from quip_for_all_tpu.models.config import ModelConfig as JConfig
from quip_for_all_tpu.nn import lora as jlora
from quip_for_all_tpu.nn import qmoe as jqmoe
from quip_for_all_tpu.nn.qlinear import QuantLinearParams
from quip_for_all_tpu.quantize import finetune as JFT
from quip_for_all_tpu.utils.random_quantized import random_quantized_model

from quip_for_all_tpu_torch.models import llama as TM
from quip_for_all_tpu_torch.models.config import ModelConfig
from quip_for_all_tpu_torch.nn import qmoe as tqmoe
from quip_for_all_tpu_torch.utils.convert import from_jax_params

import torch_tp_cases as C
from torch_family_cases import assert_close
from torch_lora_cases import jax_f32_loss
from torch_train_cases import hold_step

pytestmark = pytest.mark.fast

DIMS = dict(arch="mixtral", vocab_size=256, hidden_size=128,
            intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=4,
            max_position_embeddings=128, num_local_experts=4,
            num_experts_per_tok=2)
JCFG, TCFG = JConfig(**DIMS), ModelConfig(**DIMS)
TOL = 1e-4
WSCALE = 0.03              # module docstring
LAYER_TOL = 1e-5
LRS = (5e-4, 5e-5)          # SU/SV, the rest (the JAX dry run's)
LORA = dict(rank=4, alpha=16.0, seed=1, lr=1e-3,
            targets=("q_proj", "k_proj", "v_proj", "o_proj"))
B, S = 4, 8
# (dp, ep, tp) on the four ranks
MESHES = [(1, 2, 2), (2, 2, 1)]
MESH_IDS = ["ep2-tp2", "dp2-ep2"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small tensor ops: one torch thread a test worker, set before
    the module's fixtures build their models."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks():
    r = C.Ranks(4)
    yield r
    r.close()


def _rescale(node, f):
    if isinstance(node, QuantLinearParams):
        return dataclasses.replace(node, wscale_float=node.wscale_float * f)
    if isinstance(node, dict):
        return {k: _rescale(v, f) for k, v in node.items()}
    if isinstance(node, list):
        return [_rescale(v, f) for v in node]
    return node


@pytest.fixture(scope="module")
def mix(ranks):
    """(the JAX tree with its experts stacked, the port's model of it
    stacked by the port, that model's file for the ranks)."""
    jp = _rescale(random_quantized_model(
        JCFG, "E8P12", seed=0, dtype=jnp.float32, quantize_head=True), WSCALE)
    port = from_jax_params(jp, "cpu", TCFG)
    for blk in port.layers:
        moe = blk["block_sparse_moe"]
        blk["block_sparse_moe"] = nn.ModuleDict({
            "gate": moe["gate"],
            "experts_stacked": nn.ModuleDict(tqmoe.stack_experts(moe))})
    jp = dict(jp, layers=[dict(b, block_sparse_moe={
        "gate": b["block_sparse_moe"]["gate"],
        "experts_stacked": jqmoe.stack_experts(b["block_sparse_moe"])})
        for b in jp["layers"]])
    return jp, port, C.save_model(ranks, "mix", port)


@pytest.fixture(scope="module")
def ft_batch():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, TCFG.vocab_size, (B, S))
    return ids, np.roll(ids, -1, axis=1)


@pytest.fixture(scope="module")
def jax_ft(mix, ft_batch):
    """JAX's loss, gradients and updated leaves on the unsharded model:
    ``make_train_step``'s loss under ``jax.value_and_grad`` (jitted),
    then one update of ``make_susv_optimizer``."""
    jp = mix[0]
    ids, tgt = ft_batch
    flat = JFT.collect_trainable(jp)

    def loss_fn(flat, ids, targets):
        params = JFT.apply_trainable(jp, flat)
        logits, _ = JM.model_apply(JCFG, params, ids,
                                   linear_kw={"training": True})
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        oh = jax.nn.one_hot(targets, logits.shape[-1], dtype=jnp.float32)
        return -(oh * logp).sum(-1).mean()
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        flat, jnp.asarray(ids), jnp.asarray(tgt))
    opt = JFT.make_susv_optimizer(*LRS)
    upd, _ = opt.update(grads, opt.init(flat), flat)
    new = {k: np.asarray(flat[k] + upd[k]) for k in flat}
    return float(loss), {k: np.asarray(g) for k, g in grads.items()}, new


_RUNS = {}


def _ft_run(ranks, mix, ft_batch, dp, ep, tp):
    if (dp, ep, tp) not in _RUNS:
        ids, tgt = ft_batch
        _RUNS[dp, ep, tp] = ranks.run(
            "torch_train_cases:finetune_step", TCFG, mix[2], ids, tgt, dp,
            tp, LRS, ep)
    return _RUNS[dp, ep, tp]


@pytest.mark.parametrize("dp,ep,tp", MESHES, ids=MESH_IDS)
def test_finetune_step_matches_jax(ranks, mix, ft_batch, jax_ft, dp, ep,
                                   tp):
    hold_step(_ft_run(ranks, mix, ft_batch, dp, ep, tp), jax_ft, TOL)


@pytest.mark.parametrize("dp,ep,tp", MESHES, ids=MESH_IDS)
def test_replicated_leaves_take_equal_gradients_on_every_rank(
        ranks, mix, ft_batch, jax_ft, dp, ep, tp):
    """Every leaf a rank holds whole (the router's ``gate.weight``, the
    norms, the embedding, the experts' neighbours' SU/SV) has the same
    gradient, bit for bit, on all four ranks, ep ranks of other experts
    included, and after the step the same value; the router's gradient
    is the whole model's (the ep group's shares summed)."""
    outs = _ft_run(ranks, mix, ft_batch, dp, ep, tp)
    want = jax_ft[1]
    whole = [k for k, shape in outs[0][3].items() if shape ==
             want[k].shape]
    gates = [k for k in whole if k.endswith("block_sparse_moe.gate.weight")]
    assert len(gates) == TCFG.num_hidden_layers
    for _, grads, new, shapes, _ in outs[1:]:
        for k in whole:
            assert shapes[k] == outs[0][3][k]
            np.testing.assert_array_equal(grads[k], outs[0][1][k], k)
            np.testing.assert_array_equal(new[k], outs[0][2][k], k)
    for k in gates:
        assert np.abs(want[k]).max() > 0
        assert_close(outs[0][1][k], want[k], rel=TOL)


def _jax_moe_grads(jp, layer, x, g, training):
    """JAX's unsharded MoE block on x, in the training forward or the eval
    one (f32 compute; 32 tokens or more take its dense loop through the
    fused kernel and its VJP): its output and the gradients of
    sum(output * g) at x and at the router's weight."""
    jmoe = jp["layers"][layer]["block_sparse_moe"]
    kw = {"compute_dtype": jnp.float32, **({"training": True} if training
                                           else {})}

    def f(x, w):
        moe = dict(jmoe, gate={"weight": w})
        return JM.moe_apply(JCFG, moe, x, kw, None)
    y = f(jnp.asarray(x), jmoe["gate"]["weight"])
    gx, gw = jax.grad(lambda x, w: jnp.sum(f(x, w) * g), (0, 1))(
        jnp.asarray(x), jmoe["gate"]["weight"])
    return np.asarray(y), (np.asarray(gx), np.asarray(gw))


@pytest.mark.parametrize("dp,ep,tp", MESHES, ids=MESH_IDS)
def test_rank_moe_routes_and_gradients(ranks, mix, dp, ep, tp):
    """A rank's MoE block: without gradients the dense-stacked route (one
    MoE launch a stacked linear, one ep sum); with x requiring gradients
    (a LoRA step's forward, 34 tokens) and in the training forward below
    32 tokens (8), the dense loop over the rank's own E/ep experts. Each
    output is the unsharded block's; the loop's gradients at the block's
    input and at the router's weight are the whole block's on every rank
    (JAX's, in the eval forward and in the training one), with the ep
    group's sums: the partial forward, the router logits' and the
    input's gradients."""
    jp, port, path = mix
    D, E = TCFG.hidden_size, TCFG.num_local_experts
    rng = np.random.default_rng(5)
    shapes = {"eval": (2, 17), "eval_grad": (2, 17), "train": (1, 8)}
    xs = {k: rng.standard_normal((*s, D)).astype(np.float32)
          for k, s in shapes.items()}
    g = {k: rng.standard_normal((*s, D)).astype(np.float32)
         for k, s in shapes.items()}
    want_train = _jax_moe_grads(jp, 1, xs["train"], g["train"], True)
    want_eval = _jax_moe_grads(jp, 1, xs["eval_grad"], g["eval_grad"],
                               False)
    with torch.no_grad():
        want_nograd = TM.moe_apply(TCFG, port.layers[1]["block_sparse_moe"],
                                   torch.as_tensor(xs["eval"]),
                                   {"compute_dtype": torch.float32}).numpy()
    outs = ranks.run("torch_ep_cases:moe_routes", TCFG, path, 1, xs, g, dp,
                     ep, tp)
    for res in outs:
        route, y, grads, counts = res["eval"]
        assert route == [("dense_stacked", 0)] and grads is None
        assert counts["all_reduce"] == 1
        assert_close(y, want_nograd, rel=LAYER_TOL)
        for name, want in (("eval_grad", want_eval), ("train", want_train)):
            route, y, grads, counts = res[name]
            assert route == [("loop", E // ep)], (name, route)
            # forward: the partial's sum; backward: the logits' and x's
            assert counts["all_reduce"] == 3, (name, counts)
            assert_close(y, want[0], rel=LAYER_TOL)
            for got, w in zip(grads, want[1]):
                assert_close(got, w, rel=LAYER_TOL)
            for other in outs:
                for a, b in zip(grads, other[name][2]):
                    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dp,ep,tp", MESHES, ids=MESH_IDS)
def test_step_collectives(ranks, mix, ft_batch, dp, ep, tp):
    """The collectives of a finetune step on each rank. The expert axis:
    the partial's sum forward, the router logits' and the block input's
    gradients summed backward (3 a block). At tp 2 (whole transforms: the
    gather route) a block gathers q's, k's, v's outputs and o's input and
    sums o's partials forward, and sums the gradients at q's, k's, v's
    inputs and outputs and at o's input backward (7), the head gathers
    its logits and sums its input's gradient; at dp 2 the dp group
    averages the loss and every leaf's gradient. Nothing else: the step
    adds no collective for the expert axis."""
    outs = _ft_run(ranks, mix, ft_batch, dp, ep, tp)
    L = TCFG.num_hidden_layers
    leaves = len(outs[0][3])
    want = ({"all_reduce": 3 * L + (7 * L + 1 + L if tp == 2 else 0)
             + (1 + leaves if dp == 2 else 0),
             "all_gather": 4 * L + 1 if tp == 2 else 0})
    for *_, counts in outs:
        assert {k: counts[k] for k in want} == want
        assert counts["broadcast"] == counts["ring_shift"] == 0


@pytest.fixture(scope="module")
def jax_lora(mix):
    """The JAX side of the LoRA step: adapters on q/k/v/o of the stacked
    model with B off zero, the loss and its gradients in f32 compute
    (``jax.value_and_grad``, jitted) and one update of ``train_lora``'s
    optimizer (``optax.adamw``, no decay) from them, as ``train_lora``
    takes it for one epoch of one batch."""
    jp = jlora.add_lora(mix[0], rank=LORA["rank"], alpha=LORA["alpha"],
                        targets=LORA["targets"], seed=LORA["seed"])
    jf = jlora.collect_lora_trainable(jp["layers"], "layers")
    rng = np.random.default_rng(7)
    newB = {k: (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
            for k, v in jf.items() if k.endswith("lora_B")}
    jf = {**jf, **{k: jnp.asarray(v) for k, v in newB.items()}}
    # 2 x 17 ids: a 32-token forward, where JAX's MoE takes the dense loop
    toks = np.random.default_rng(4).integers(
        0, TCFG.vocab_size, (2, 17)).astype(np.int32)

    def loss_fn(flat, ids):
        p2 = dict(jp, layers=jlora.apply_lora_trainable(jp["layers"], flat,
                                                        "layers"))
        return jax_f32_loss(JCFG, p2, ids)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jf, jnp.asarray(toks))
    opt = optax.adamw(LORA["lr"], weight_decay=0.0)
    upd, _ = opt.update(grads, opt.init(jf), jf)
    new = optax.apply_updates(jf, upd)
    return dict(toks=toks, newB=newB, loss=float(loss),
                grads={k: np.asarray(g) for k, g in grads.items()},
                new={k: np.asarray(v) for k, v in new.items()})


@pytest.mark.parametrize("order", ["after", "before"])
def test_lora_step_matches_jax(ranks, mix, jax_lora, order):
    """A LoRA step at ep 2 x tp 2, adapters added after ``shard_params``
    (wrapping the rank's parallel layers) or before it (kept whole inside
    them): every rank's loss, adapter gradients (A and B whole) and
    adapters after one ``train_lora`` step against JAX's, with the
    tolerance of the finetune step; the ranks' adapters equal. Its
    forward takes the dense loop over each rank's experts (x requires
    gradients from layer 0's adapters on), through the kernels' twins and
    K3's in the backward."""
    j = jax_lora
    outs = ranks.run("torch_train_cases:lora_step", TCFG, mix[2], j["toks"],
                     order, 1, 2, LORA, j["newB"], 2)
    for loss, grads, new, kinds, counts in outs:
        assert loss == outs[0][0]
        assert abs(loss - j["loss"]) <= TOL * abs(j["loss"]) + np.spacing(
            np.float32(abs(j["loss"])))
        assert sorted(grads) == sorted(j["grads"])
        assert len(grads) == 2 * 4 * TCFG.num_hidden_layers
        for k, g in j["grads"].items():
            assert grads[k].shape == new[k].shape == g.shape, k
            assert np.abs(g).max() > 0, k
            try:
                assert_close(grads[k], g, rel=TOL)
            except AssertionError as e:
                raise AssertionError(f"gradient of {k}: {e}") from None
            tol = TOL * np.abs(g).max() + np.spacing(np.abs(g).astype(
                np.float32))
            big = np.abs(g) > tol
            w = j["new"][k]
            err = np.abs(new[k] - w)[big]
            limit = (TOL * np.abs(w).max() + np.spacing(
                np.abs(w).astype(np.float32)))[big]
            assert np.all(err <= limit), (k, err.max())
        for k in new:
            np.testing.assert_array_equal(new[k], outs[0][2][k])
        want = ({"LoraLinear(ColParallel)", "LoraLinear(RowParallel)"}
                if order == "after" else
                {"ColParallel(LoraLinear)", "RowParallel(LoraLinear)"})
        assert set(kinds.values()) == want
