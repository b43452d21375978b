"""The port's runtime sanitizer (``quip_for_all_tpu_torch/utils/sanitize.py``)
and its CLI (``tools/sanitize.py``), on the CPU: each of
``tests/test_sanitize.py``'s checks both ways (a clean program passes, an
injected fault is flagged); one regression test for each fault that
``ADVICE.md`` records against the JAX copies (the llama import, the
aliased determinism baseline, the f32 cast in ``check_finite``, the
vacuous variant parity, the leaves the CLI passed by), the first as one
test a family; and parity with the JAX sanitizer on a tiny llama carried
across with ``from_jax_params``: both report ok and the first step's f32
logits agree within 1e-4 of max|logit| (``torch_family_cases.MODEL_TOL``).
The difference kept on purpose: JAX's ``check_finite`` flags a finite f64
above f32's range, the port's does not.
"""
import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from quip_for_all_tpu.models import llama as JM
from quip_for_all_tpu.models.config import tiny_config as jtiny
from quip_for_all_tpu.runtime.generate import init_kv_caches as jcaches
from quip_for_all_tpu.utils import sanitize as JS
from quip_for_all_tpu.utils.random_quantized import (
    random_quantized_model as jrandom)

import quip_for_all_tpu_torch as qt
from quip_for_all_tpu_torch.models.config import ModelConfig, tiny_config
from quip_for_all_tpu_torch.nn.qlinear import _PlaneHolder
from quip_for_all_tpu_torch.tools import sanitize as T
from quip_for_all_tpu_torch.utils import sanitize as S
from quip_for_all_tpu_torch.utils.convert import from_jax_params
from quip_for_all_tpu_torch.utils.random_quantized import random_qtensor

from torch_family_cases import BASE, FAMILIES, MODEL_TOL, assert_close

pytestmark = pytest.mark.fast

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small tensor ops: one thread a test worker, so that a parallel
    test run does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(cfg):
    return qt.fuse_for_inference(cfg, qt.random_quantized_model(
        cfg, seed=0, dtype=torch.float32, quantize_head=True, device="cpu"))


def _qt(codebook, q_out, q_in, seed=3):
    g = torch.Generator().manual_seed(seed)
    return random_qtensor(codebook, None, q_out, q_in, g, CPU)


def _x(m, q_in, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (m, q_in)), dtype=torch.bfloat16)


# ---------------------------------------- tests/test_sanitize.py's checks

def test_determinism_passes_on_a_pure_fn():
    def f(x):
        return torch.cumsum(x * 2.0, 0), x.sum()

    rep = S.check_determinism(f, (torch.arange(16, dtype=torch.float32),))
    assert rep.ok, rep.summary()


def test_determinism_flags_an_impure_fn():
    state = {"n": 0}

    def f(x):
        state["n"] += 1
        return x + state["n"]

    rep = S.check_determinism(f, (torch.ones(4),))
    assert not rep.ok
    assert rep.findings[0].check == "determinism"
    with pytest.raises(AssertionError):
        S.check_determinism(f, (torch.ones(4),), strict=True)


def test_purity_passes_on_a_functional_fn():
    rep = S.check_purity(lambda x: x * 2, (torch.ones((4, 4)),))
    assert rep.ok, rep.summary()


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_purity_flags_inplace_mutation(kind):
    def f(a):
        a *= 2      # in place on the caller's buffer
        return a.sum()

    a = np.ones(8) if kind == "numpy" else torch.ones(8)
    rep = S.check_purity(f, (a,))
    assert not rep.ok
    assert "mutated" in rep.findings[0].detail


def test_finite_flags_nan_and_inf():
    tree = {"a": torch.ones(3), "b": torch.tensor([1.0, float("nan")]),
            "c": np.asarray([np.inf, 0.0]), "ints": np.arange(3),
            "h": torch.tensor([float("inf")], dtype=torch.bfloat16)[:0]}
    rep = S.check_finite(tree)
    assert len(rep.findings) == 2, rep.summary()
    assert S.check_finite({"x": torch.zeros(2)}).ok


@pytest.mark.parametrize("cb", ["E8P12", "E8P12RVQ4B"])
def test_variant_parity_clean(cb):
    """K1's twin and the split-K twin (``ksplit=2``, q_in 2048: 2 chunks
    of 128 groups) agree, and the base run the dense decode."""
    rep = S.check_variant_parity(_qt(cb, 128, 2048), _x(4, 2048))
    assert rep.ok, rep.summary()
    assert rep.checks_run == ["variant_parity"] and not rep.skipped
    assert [r["reached"] for r in rep.runs] == [
        "fused_decode_matmul_ref (plain twin)",
        "ksplit_decode_matmul_ref (plain twin)"]
    assert rep.runs[0]["against"] == "decode_weights (dense decode)"


def test_variant_parity_flags_a_wrong_variant(monkeypatch):
    """A split-K route that returns other values is flagged."""
    from quip_for_all_tpu_torch.ops import fused_matmul as fm
    real = fm.fused_quant_matmul

    def wrong(x, qt, ksplit=0, **kw):
        out = real(x, qt, ksplit=ksplit, **kw)
        return out + 1e3 if ksplit else out
    monkeypatch.setattr(fm, "fused_quant_matmul", wrong)
    rep = S.check_variant_parity(_qt("E8P12", 128, 2048), _x(4, 2048))
    assert not rep.ok and "ksplit=2" in rep.findings[0].leaf


def test_variant_parity_leaves_the_switches():
    """The counterpart of JAX's env test: the sweep calls the route with
    its own arguments and leaves every leaf's split-K switch as it was."""
    cfg = tiny_config()
    model = qt.set_ksplit(_model(cfg), 3)
    T.sweep(model)
    assert {m.ksplit for m in model.modules() if hasattr(m, "ksplit")} == {3}


def test_sanitize_decode_step_tiny_model():
    cfg = tiny_config()
    rep = S.sanitize_decode_step(cfg, _model(cfg), repeats=2)
    assert rep.ok, rep.summary()
    assert set(rep.checks_run) == {"determinism", "purity", "finite"}


def test_sanitize_decode_step_in_bf16_takes_bf16_caches(monkeypatch):
    """The step in bf16, as the decode loop runs the main path's model:
    its KV caches are made in bf16 too."""
    from quip_for_all_tpu_torch.runtime import generate as G
    made = []

    def caches(*a, **kw):
        made.append(kw["dtype"])
        return G_init(*a, **kw)
    G_init = G.init_kv_caches
    monkeypatch.setattr(G, "init_kv_caches", caches)
    cfg = tiny_config()
    rep = S.sanitize_decode_step(cfg, _model(cfg), repeats=2,
                                 dtype=torch.bfloat16)
    assert rep.ok, rep.summary()
    assert made == [torch.bfloat16]


# ------------------------------------------------ ADVICE.md's five faults

FAMILY_CFGS = {"llama": {}, "mixtral": dict(arch="mixtral",
                                            num_local_experts=4,
                                            num_experts_per_tok=2),
               **{k: FAMILIES[k] for k in ("baichuan", "gpt2", "gpt_neox",
                                           "opt", "falcon", "phi", "gptj",
                                           "qwen")}}


@pytest.mark.parametrize("family", sorted(FAMILY_CFGS))
def test_decode_step_runs_every_family(family):
    """Fault 1 (the llama import): every family's tiny model, through
    ``get_arch``."""
    cfg = ModelConfig(**dict(BASE, **FAMILY_CFGS[family]))
    rep = S.sanitize_decode_step(cfg, _model(cfg), repeats=2)
    assert rep.ok, rep.summary()
    assert set(rep.checks_run) == {"determinism", "purity", "finite"}


def test_determinism_flags_a_buffer_reusing_fn():
    """Fault 2 (the aliased baseline): a program that writes each run's
    other result into the same buffer is flagged; JAX's check passes it."""
    def reuse(buf):
        n = {"i": 0}

        def f():
            n["i"] += 1
            buf[:] = n["i"]
            return buf
        return f
    rep = S.check_determinism(reuse(torch.zeros(4)), ())
    assert not rep.ok and len(rep.findings) == 2, rep.summary()
    assert JS.check_determinism(reuse(np.zeros(4)), ()).ok


def test_runner_step_is_compared_run_against_run():
    """The decode loop's step writes its logits into one static buffer
    (a ``StepRunner`` body: a CUDA graph on a card); a model that drifts
    between runs is flagged through that buffer."""
    from quip_for_all_tpu_torch.models.llama import model_apply
    from quip_for_all_tpu_torch.runtime.generate import init_kv_caches
    from quip_for_all_tpu_torch.runtime.graphs import StepRunner
    cfg = tiny_config()
    model = _model(cfg)
    caches = init_kv_caches(cfg, 1, 8, dtype=torch.float32, device="cpu")
    out = torch.zeros((1, cfg.vocab_size))
    runner = StepRunner(CPU, [])

    def body():
        model.embed_tokens.weight[1].add_(1e-3)      # the drift
        logits, _ = model_apply(cfg, model, torch.tensor([[1]]),
                                kv_caches=caches, cache_position=0)
        out.copy_(logits[:, -1])

    def stepped():
        runner.run("step", body, 1)
        return out
    rep = S.check_determinism(stepped, (), state=caches, name="runner step")
    assert not rep.ok and rep.findings[0].leaf == "runner step"


def test_finite_tests_f64_as_it_is():
    """Fault 3 (the f32 cast): finite f64 values above f32's max pass, in
    torch and numpy."""
    big = 1e300
    rep = S.check_finite({"t": torch.tensor([big, -big], dtype=torch.float64),
                          "n": np.asarray([big])})
    assert rep.ok, rep.summary()
    assert not S.check_finite(torch.tensor([np.inf],
                                           dtype=torch.float64)).ok


def test_jax_flags_a_large_f64_the_port_does_not():
    """The difference kept on purpose: JAX's ``check_finite`` casts to f32
    and flags a finite 1e300."""
    a = np.asarray([1e300])
    assert not JS.check_finite({"a": a}).ok
    assert S.check_finite({"a": a}).ok


@pytest.mark.parametrize("kind", ["torch", "numpy"])
def test_finite_flags_nan_in_the_imaginary_part(kind):
    """Fault 3 (the dropped imaginary part): a NaN there is flagged, an
    Inf in the real part too, a finite complex leaf passes."""
    vals = [complex(1.0, float("nan")), complex(2.0, 0.0)]
    bad = (torch.tensor(vals, dtype=torch.complex64) if kind == "torch"
           else np.asarray(vals, dtype=np.complex64))
    rep = S.check_finite({"z": bad})
    assert not rep.ok and rep.findings[0].detail.startswith("1/2")
    good = (torch.tensor([complex(1, 2)]) if kind == "torch"
            else np.asarray([1 + 2j]))
    assert S.check_finite({"z": good}).ok


def test_variant_that_reaches_the_base_function_is_skipped():
    """Fault 4 (the vacuous parity): at q_in 256 (one lane of 128 groups)
    ksplit=2 reaches K1's twin again; it is recorded as skipped with the
    reason and the function, not as a pass."""
    rep = S.check_variant_parity(_qt("E8P12", 128, 256), _x(8, 256),
                                 leaf="w")
    assert rep.ok
    assert [r["status"] for r in rep.runs] == ["pass", "skipped"]
    assert rep.runs[1]["reached"] == rep.runs[0]["reached"]
    assert len(rep.skipped) == 1 and "w m=8 ksplit=2" == rep.skipped[0].leaf
    assert "base run's function" in rep.skipped[0].detail


def test_sweep_probes_fused_and_stacked_leaves():
    """Fault 5 (the skipped leaves): the CLI's sweep takes a
    ``FusedQuantLinear`` and a ``StackedQuantLinear`` (through the MoE
    route against each expert's dense decode) as well as a
    ``QuantLinear``."""
    cfg = tiny_config(arch="mixtral", num_local_experts=4,
                      num_experts_per_tok=2)
    rep = T.sweep(_model(cfg))
    assert rep.ok, rep.summary()
    leaves = {r["leaf"]: r for r in rep.runs if r["variant"] == "base"}
    assert sorted(leaves) == ["layers.0.block_sparse_moe.experts_stacked.w13",
                              "layers.0.self_attn.o_proj",
                              "layers.0.self_attn.qkv_proj"]
    assert leaves["layers.0.block_sparse_moe.experts_stacked.w13"][
        "reached"] == "moe_fused_matmul_ref (plain twin)"


def test_sweep_reports_a_leaf_it_cannot_probe():
    """A module that holds planes in a class the sweep does not know is a
    finding, not passed by."""
    class Odd(_PlaneHolder):
        def __init__(self, q):
            super().__init__()
            self.q_out, self.q_in = q.q_out, q.q_in
            self._set_qweight(q)
    model = nn.ModuleDict({"odd": Odd(_qt("E8P12", 128, 256))})
    rep = T.sweep(model)
    assert not rep.ok and rep.findings[0].leaf == "odd"
    assert "Odd" in rep.findings[0].detail


def test_stacked_parity_flags_a_wrong_expert(monkeypatch):
    """The stacked check holds each row to its own expert's decode: rows
    sent to other experts are flagged."""
    cfg = tiny_config(arch="mixtral", num_local_experts=4,
                      num_experts_per_tok=2)
    sq = _model(cfg).layers[0]["block_sparse_moe"]["experts_stacked"]["w13"]
    eids = (torch.arange(16) % 4).to(torch.int32)
    x = _x(16, sq.q_in)
    assert S.check_stacked_parity(sq, x, eids).ok
    from quip_for_all_tpu_torch.ops import moe_matmul as mm
    real = mm.moe_fused_matmul

    def shifted(x_perm, e, *a):
        return real(x_perm, (e + 1) % 4, *a)
    shifted.launches = 0
    monkeypatch.setattr(mm, "moe_fused_matmul", shifted)
    assert not S.check_stacked_parity(sq, x, eids).ok


def test_cli_exits_zero_and_prints_the_summary(capsys):
    assert T.main(["--device", "cpu", "--repeats", "2"]) == 0
    out = capsys.readouterr()
    assert out.out.splitlines()[0] == (
        "sanitizer OK (determinism, purity, finite, variant_parity)")
    assert "FusedQuantLinear" in out.err and "QuantLinear" in out.err


def test_cli_layers_cuts_the_random_model(capsys):
    assert T.main(["--device", "cpu", "--repeats", "2", "--layers",
                   "1"]) == 0
    err = capsys.readouterr().err
    assert "arch=llama d=" in err and "layers=1 " in err, err
    assert "step dtype=float32" in err


# ----------------------------------------------------- parity with JAX

def test_sanitizer_matches_jax_on_a_crossed_over_llama():
    """One tiny llama, JAX's random quantized tree carried across: both
    sanitizers report ok, and the first decode step's f32 logits agree."""
    jcfg = jtiny()
    params = jrandom(jcfg, codebook="E8P12", seed=0)
    cfg = tiny_config()
    model = from_jax_params(params, "cpu")
    jrep = JS.sanitize_decode_step(jcfg, params, repeats=2)
    rep = S.sanitize_decode_step(cfg, model, repeats=2)
    assert jrep.ok and rep.ok, (jrep.summary(), rep.summary())
    caches = jcaches(jcfg, 1, 32, dtype=jnp.float32)
    want, _ = jax.jit(lambda p, c: JM.model_apply(
        jcfg, p, jnp.asarray([[1]]), positions=jnp.asarray([[0]]),
        kv_caches=c, cache_position=0))(params, caches)
    from quip_for_all_tpu_torch.runtime.generate import init_kv_caches
    got, _ = qt.get_arch(cfg).model_apply(
        cfg, model, torch.tensor([[1]]), positions=torch.tensor([[0]]),
        kv_caches=init_kv_caches(cfg, 1, 32, dtype=torch.float32,
                                 device="cpu"), cache_position=0)
    assert_close(got.numpy(), np.asarray(want), rel=MODEL_TOL)
