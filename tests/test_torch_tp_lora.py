"""LoRA on a tensor-parallel model (ROADMAP queue 1 item 8d, first part)
held to the JAX package on four gloo ranks on the CPU (the (dp 2, tp 2)
mesh; ``tests/torch_tp_cases.py`` ``Ranks``, rank cases in
``tests/torch_train_cases.py``), in both orders the JAX package takes:
``add_lora`` then ``shard_params`` (each adapted linear whole on every
rank, as JAX's role table replicates "*.lora_base") and ``shard_params``
then ``add_lora`` (the base cut, A and B whole: ``parallel/layers.py``
``lora``). ``train_lora`` keeps JAX's batches, the whole batch on every
rank.

Against JAX's ``train_lora`` for one step (one epoch of one batch) on
the unsharded model, both packages in f32 compute (their
``causal_lm_loss`` patched to name it, as ``tests/torch_lora_cases.py``
does): the loss and every A and B gradient within 1e-4 of max|.| plus
one ulp, the adapters after the step where |grad| exceeds that (Adam's
first step is +-lr sign(g)). B starts off zero (seeded, the same in both
packages) so that A takes gradients. The head's rank-local product (128
rows of 256) runs the fused route, its backward through K3's twin.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quip_for_all_tpu.nn import lora as jlora
from quip_for_all_tpu.quantize import lora_train as jtrain

import torch_tp_cases as C
import torch_tp_models as TM
from torch_family_cases import assert_close
from torch_lora_cases import TARGETS, jax_f32_loss

pytestmark = pytest.mark.fast

TOL = 1e-4
LORA = dict(rank=4, alpha=16.0, seed=1, lr=1e-3)
B, S = 2, 9


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks():
    r = C.Ranks(4)
    yield r
    r.close()


# (family, block-diagonal tp, targets)
MODELS = {"llama_tp2": ("llama", 2, jlora.DEFAULT_TARGETS),
          "llama_whole": ("llama", 0, jlora.DEFAULT_TARGETS),
          "gpt_neox_tp2": ("gpt_neox", 2, TARGETS["gpt_neox"])}
_JAX, _RUNS = {}, {}


def _jax(key, monkeypatch):
    """The JAX side: the adapters with B off zero, the loss and its
    gradients in f32 compute, and ``train_lora`` for one step."""
    if key not in _JAX:
        family, tp, targets = MODELS[key]
        jcfg, jp, tcfg, model = TM.build(family, tp)
        kw = dict(LORA, targets=targets)
        jp = jlora.add_lora(jp, rank=kw["rank"], alpha=kw["alpha"],
                            targets=targets, seed=kw["seed"])
        jf = jlora.collect_lora_trainable(jp["layers"], "layers")
        rng = np.random.default_rng(7)
        newB = {k: (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
                for k, v in jf.items() if k.endswith("lora_B")}
        jf = {**jf, **{k: jnp.asarray(v) for k, v in newB.items()}}
        jp["layers"] = jlora.apply_lora_trainable(jp["layers"], jf, "layers")
        toks = np.random.default_rng(4).integers(
            0, tcfg.vocab_size, (B, S)).astype(np.int32)

        def loss_fn(flat, ids):
            p2 = dict(jp)
            p2["layers"] = jlora.apply_lora_trainable(jp["layers"], flat,
                                                      "layers")
            return jax_f32_loss(jcfg, p2, ids)
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            jf, jnp.asarray(toks))
        monkeypatch.setattr(jtrain, "causal_lm_loss", jax_f32_loss)
        out = jtrain.train_lora(jcfg, jp, toks, rank=kw["rank"],
                                alpha=kw["alpha"], targets=targets,
                                lr=kw["lr"], epochs=1, batch_size=B,
                                seed=kw["seed"])
        new = jlora.collect_lora_trainable(out["layers"], "layers")
        _JAX[key] = dict(
            tcfg=tcfg, model=model, toks=toks, kw=kw, newB=newB,
            loss=float(loss), grads={k: np.asarray(g)
                                     for k, g in grads.items()},
            new={k: np.asarray(v) for k, v in new.items()},
            shapes={k: tuple(v.shape) for k, v in jf.items()})
    return _JAX[key]


def _run(ranks, key, order, monkeypatch):
    j = _jax(key, monkeypatch)
    if (key, order) not in _RUNS:
        path = C.save_model(ranks, key, j["model"])
        _RUNS[key, order] = ranks.run(
            "torch_train_cases:lora_step", j["tcfg"], path, j["toks"], order,
            2, 2, j["kw"], j["newB"])
    return j, _RUNS[key, order]


CASES = [("llama_tp2", "after"), ("llama_tp2", "before"),
         ("llama_whole", "after"), ("gpt_neox_tp2", "after")]


@pytest.mark.parametrize("key,order", CASES,
                         ids=[f"{k}-{o}" for k, o in CASES])
def test_lora_step_matches_jax(ranks, key, order, monkeypatch):
    j, outs = _run(ranks, key, order, monkeypatch)
    for loss, grads, new, kinds, _ in outs:
        assert loss == outs[0][0]
        assert abs(loss - j["loss"]) <= TOL * abs(j["loss"]) + np.spacing(
            np.float32(abs(j["loss"])))
        assert sorted(grads) == sorted(j["grads"])
        for k, g in j["grads"].items():
            # A and B whole on every rank
            assert grads[k].shape == new[k].shape == j["shapes"][k], k
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
        for r in outs[1:]:
            for k in new:
                np.testing.assert_array_equal(r[2][k], new[k])


def test_shard_params_keeps_a_lora_linear_whole(ranks, monkeypatch):
    """``add_lora`` then ``shard_params`` no longer raises: every adapted
    linear is a ``LoraLinear`` kept whole inside a parallel layer; the
    other order wraps the rank's parallel layer (its base cut)."""
    _, before = _run(ranks, "llama_tp2", "before", monkeypatch)
    _, after = _run(ranks, "llama_tp2", "after", monkeypatch)
    for out in before:
        kinds = set(out[3].values())
        assert kinds == {"ColParallel(LoraLinear)",
                         "RowParallel(LoraLinear)"}, kinds
    for out in after:
        kinds = set(out[3].values())
        assert kinds == {"LoraLinear(ColParallel)",
                         "LoraLinear(RowParallel)"}, kinds
