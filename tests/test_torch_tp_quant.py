"""``QuipQuantizer(tp_shards=2)`` and tensor-parallel checkpoints, held to
the JAX package on the CPU with no processes (``tests/torch_quant_cases.py``):
the port's quantizer draws JAX's block-diagonal transforms in JAX's order
(shared group ``lspec`` with the row shards where the group's first layer
is row-parallel, a column-parallel ``rspec`` where tp divides q_out, a
row-parallel ``lspec`` where none is shared and tp divides q_in), so its
codes equal JAX's or differ only from a near-tie on (the rule of
``tests/torch_quant_cases.py``); a
checkpoint saved by either package loads in the other by the role rule,
with the random and the table (``use_rand=False``) factors, and gives its
logits within 1e-4 of max|logit| plus one ulp; tp_shards=2 keeps
perplexity within 1.2x of tp_shards=1, as ``tests/test_tp_shards.py``
asserts for JAX. Sizes are the smallest that keep each check (the
table case and the head cases at one layer): every quantizer run here
costs the tier-1 suite most under parallel load.

A quantized head at tp_shards > 1 is a fault of the JAX package (ROADMAP.md
queue 3): its quantizer transforms the head whole, and its loader gives the
head ``shards_right = tp`` by role alone, so the reloaded head is another
linear (an even vocabulary: other logits) or none (an odd one: the right
transform's reshape raises). The port's loader gives each linear the
shards its quantizer drew, so its reload is the quantized model; JAX's
wrong reload stays pinned below as a difference kept on purpose.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quip_for_all_tpu.data.calibration import synthetic_tokens
from quip_for_all_tpu.models import llama as JM
from quip_for_all_tpu.models.config import tiny_config as jtiny
from quip_for_all_tpu.quantize.quantizer import QuipQuantizer as JQ
from quip_for_all_tpu.utils import checkpoint as jckpt

from quip_for_all_tpu_torch.codebooks import get_codebook
from quip_for_all_tpu_torch.models import llama as TM
from quip_for_all_tpu_torch.models.config import tiny_config
from quip_for_all_tpu_torch.nn.qlinear import QuantLinear
from quip_for_all_tpu_torch.ops.qtensor import to_raw_idxs
from quip_for_all_tpu_torch.quantize.quantizer import QuipQuantizer as TQ
from quip_for_all_tpu_torch.runtime.generate import perplexity as tppl
from quip_for_all_tpu_torch.utils import checkpoint as tckpt
from quip_for_all_tpu_torch.utils.convert import from_jax_params

from torch_family_cases import MODEL_TOL, assert_close
from torch_quant_cases import check_linear, run_both

pytestmark = pytest.mark.fast

T32 = {"compute_dtype": torch.float32}
F32 = {"compute_dtype": jnp.float32}
# use_rand=False needs widths with a table factor: 96 = 3 * 32 (table 12,
# at 2 shards 48 = 3 * 16), 160 = 5 * 32 (table 20; 80 = 5 * 16)
TABLE = dict(hidden_size=96, intermediate_size=160, num_attention_heads=4,
             num_key_value_heads=2, num_hidden_layers=1)
CASES = {"rand": ({}, {"quip_tune_iters": 1}),
         "table": (TABLE, {"use_rand": False, "quip_tune_iters": 0})}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread a test worker, set before the module's quantizer
    fixture runs (a parallel test run otherwise oversubscribes the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(cfg, seed=7):
    return synthetic_tokens(2, 12, cfg.vocab_size, seed=seed)


def _jlogits(cfg, params, ids):
    """JAX's f32 logits, as one jitted forward (the eager forward compiles
    the interpret-mode kernels op by op, several times longer)."""
    import jax
    fwd = jax.jit(lambda p, i: JM.model_apply(cfg, p, i, dtype=jnp.float32,
                                              linear_kw=F32)[0])
    return np.asarray(fwd(params, jnp.asarray(ids)))


def _tlogits(cfg, model, ids):
    return TM.model_apply(cfg, model, torch.as_tensor(ids).long(),
                          linear_kw=T32)[0].numpy()


@pytest.fixture(scope="module", params=sorted(CASES))
def quantized(request, tmp_path_factory):
    """Both quantizers on the same tiny llama and calibration tokens at
    tp_shards=2; each package's checkpoint of its own result."""
    ckw, qkw = CASES[request.param]
    cfg, tcfg = jtiny(**ckw), tiny_config(**ckw)
    calib = synthetic_tokens(16, 32, cfg.vocab_size, seed=1)
    kw = dict(codebook="E8P12", nsamples=8, batch_size=4, seed=3,
              tp_shards=2, **qkw)
    mp = pytest.MonkeyPatch()
    try:
        out = run_both(mp, cfg, tcfg, JM.init_llama_params(cfg, seed=0),
                       TM.init_llama_params(tcfg, seed=0, device="cpu"),
                       calib, **kw)
    finally:
        mp.undo()
    jp, tm, jcalls, tcalls, jq, tq = out
    d = tmp_path_factory.mktemp(request.param)
    jckpt.save_quantized(cfg, jp, jq.to_dict(), str(d / "jax"))
    tckpt.save_quantized(tcfg, tm, tq.to_dict(), str(d / "port"))
    return cfg, tcfg, out, d


def test_codes_and_shards_match_jax(quantized):
    cfg, tcfg, (jp, tm, jcalls, tcalls, _, _), _ = quantized
    ref = from_jax_params(jp, "cpu", tcfg)
    jl = [(n, m) for n, m in ref.named_modules() if isinstance(m,
                                                               QuantLinear)]
    tl = [(n, m) for n, m in tm.named_modules() if isinstance(m,
                                                              QuantLinear)]
    assert [n for n, _ in jl] == [n for n, _ in tl]
    cb = get_codebook("E8P12")
    for (name, a), (_, b), jc, tc in zip(jl, tl, jcalls, tcalls):
        assert (a.shards_left, a.shards_right) == (b.shards_left,
                                                   b.shards_right), name
        assert (a.K_left, a.K_right) == (b.K_left, b.K_right), name
        same = np.array_equal(to_raw_idxs(a.qweight), to_raw_idxs(b.qweight))
        assert same == (check_linear(name, jc, tc, cb) is None), name
    blk = tm.layers[0]
    # the role rule: q/k/v/gate/up shard their right side, o/down their left
    assert blk["self_attn"]["q_proj"].shards_right == 2
    assert blk["self_attn"]["o_proj"].shards_left == 2
    assert blk["mlp"]["down_proj"].shards_left == 2
    assert blk["mlp"]["gate_proj"].shards_left == 1


def test_checkpoints_cross_over(quantized):
    """Each package loads the other's tp_shards checkpoint with the same
    shards and gives the saving package's logits."""
    cfg, tcfg, (jp, tm, *_), d = quantized
    ids = _ids(cfg)
    jc, jl, jq = jckpt.load_quantized(str(d / "port"))
    tc, tl, tq = tckpt.load_quantized(str(d / "jax"), device="cpu")
    assert jq["tp_shards"] == tq["tp_shards"] == 2
    assert_close(_tlogits(tc, tl, ids), _jlogits(cfg, jp, ids),
                 rel=MODEL_TOL)
    assert_close(_jlogits(jc, jl, ids), _tlogits(tcfg, tm, ids),
                 rel=MODEL_TOL)
    for name, m in tl.named_modules():
        if isinstance(m, QuantLinear):
            j = tm.get_submodule(name)
            assert (m.shards_left, m.shards_right) == (j.shards_left,
                                                       j.shards_right)


def test_tp_quantize_quality_parity():
    """tp_shards=2 quantization stays ppl-comparable to tp_shards=1: the
    port's run of tests/test_tp_shards.py's check (its model, 2 layers,
    its calibration and eval tokens)."""
    tcfg = tiny_config(num_hidden_layers=2)
    calib = synthetic_tokens(16, 32, tcfg.vocab_size, seed=1)
    evals = synthetic_tokens(8, 32, tcfg.vocab_size, seed=2)
    ppls = {}
    for tp in (1, 2):
        kw = dict(codebook="E8P12", nsamples=16, batch_size=4,
                  quip_tune_iters=0, ft_epochs=0, tp_shards=tp)
        tm = TQ(**kw).quantize_model(
            tcfg, TM.init_llama_params(tcfg, seed=0, device="cpu"), calib)
        ppls[tp] = tppl(tcfg, tm, evals, batch_size=4, device="cpu")
    assert np.isfinite(ppls[2])
    assert ppls[2] < ppls[1] * 1.2, ppls


@pytest.fixture(scope="module", params=[256, 255])
def head_case(request, tmp_path_factory):
    """A one-layer tiny llama at an even and an odd vocabulary, quantized
    by both packages at tp_shards=2 with its head, JAX's saved: (JAX
    config, JAX quantized params, the port's quantized model, its
    quantization config, the checkpoint's directory)."""
    vocab = request.param
    tmp_path = tmp_path_factory.mktemp(f"head{vocab}")
    cfg = jtiny(num_hidden_layers=1, vocab_size=vocab)
    tcfg = tiny_config(num_hidden_layers=1, vocab_size=vocab)
    calib = synthetic_tokens(4, 24, vocab, seed=1)
    kw = dict(codebook="E8P12", nsamples=4, batch_size=4, quip_tune_iters=0,
              ft_epochs=0, tp_shards=2, quantize_lm_head=True)
    jq, tq = JQ(**kw), TQ(**kw)
    jp = jq.quantize_model(cfg, JM.init_llama_params(cfg, seed=0), calib)
    tm = tq.quantize_model(
        tcfg, TM.init_llama_params(tcfg, seed=0, device="cpu"), calib)
    assert jp["lm_head"].shards_right == tm.lm_head.shards_right == 1
    jckpt.save_quantized(cfg, jp, jq.to_dict(), str(tmp_path / "jax"))
    return cfg, jp, tm, tq.to_dict(), str(tmp_path / "jax")


def test_quantized_head_at_tp_shards_reloads_as_quantized(head_case,
                                                          tmp_path):
    """The port's reload of a JAX-written tp_shards=2 checkpoint with a
    quantized head: the head whole (the shards its quantizer drew), every
    block linear with the role rule's shards, and the JAX quantized
    model's f32 logits within 1e-4 of max|logit| at an even and an odd
    vocabulary; the port's own checkpoint reloads as its quantized model
    too."""
    cfg, jp, tm, tq, d = head_case
    tc, tl, _ = tckpt.load_quantized(d, device="cpu")
    assert tl.lm_head.shards_right == tl.lm_head.shards_left == 1
    for name, m in tl.named_modules():
        if isinstance(m, QuantLinear) and name != "lm_head":
            j = tm.get_submodule(name)
            assert (m.shards_left, m.shards_right) == (j.shards_left,
                                                       j.shards_right), name
    ids = _ids(cfg)
    assert_close(_tlogits(tc, tl, ids), _jlogits(cfg, jp, ids),
                 rel=MODEL_TOL)
    own = tmp_path / "port"
    tckpt.save_quantized(tc, tm, tq, str(own))
    oc, ol, _ = tckpt.load_quantized(str(own), device="cpu")
    assert_close(_tlogits(oc, ol, ids), _tlogits(tc, tm, ids),
                 rel=MODEL_TOL)


def test_quantized_head_at_tp_shards_reloads_as_jax_does(head_case):
    """JAX's fault (module docstring; ROADMAP.md queue 3), a difference
    kept on purpose: JAX's loader gives the head, quantized whole,
    shards_right 2. At vocab 256 its reload's logits are far from the
    quantized model's (more than max|logit| apart; 6.72 against 4.06
    when measured); at vocab 255 the reload raises in the head's right
    transform."""
    cfg, jp, _, _, d = head_case
    jc, jl, _ = jckpt.load_quantized(d)
    assert jl["lm_head"].shards_right == 2
    ids = _ids(cfg)
    vocab = cfg.vocab_size
    if vocab % 2:
        with pytest.raises(TypeError, match="reshape"):
            _jlogits(jc, jl, ids)
        return
    want = _jlogits(jc, jl, ids)
    quantized = _jlogits(cfg, jp, ids)
    assert np.abs(want - quantized).max() > np.abs(quantized).max()
    print(json.dumps({"vocab": vocab, "reload_vs_quantized": float(
        np.abs(want - quantized).max()), "max_logit": float(
        np.abs(quantized).max())}))
