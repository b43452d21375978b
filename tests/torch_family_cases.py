"""The families' test cases, shared by ``tests/test_torch_family_*.py``:
each family at the tiny sizes of ``tests/test_model_families.py``,
``tests/test_gpt2.py`` and ``tests/test_qwen_yi.py`` (GPT-NeoX with both
residuals, Falcon multi-query and with the new decoder), its JAX tree from
the family's ``init_*_params`` with every linear of the quantizer's
sublayer groups replaced by the JAX package's ``random_qlinear`` (a group's
members sharing ``lspec`` and SU, a random bias where the family has one,
uniform random E8P12 codewords through ``from_raw_idxs``),
the untied head quantized where the vocabulary allows, and the norms
perturbed off ones and zeros so that their scale and bias count; then that
tree carried across with ``from_jax_params``.

At these widths every family has linears on both sides of the fused
route's shape rule (q_out % 128): fc1 (128 wide) and the head (256) take
it, the 64-wide outputs and most fused qkv (192, Falcon's 96) do not.

Tolerance of logits held to JAX (f32 activations, f32 compute in the
linears; the two packages sum in other orders): 1e-5 of max|logit| plus
one f32 ulp of each logit for one norm or head (``assert_close``), and
``MODEL_TOL`` = 1e-4 of max|logit| plus one ulp through a whole model,
the rule of ``tests/test_torch_mixtral_slice.py``'s f32 forward. Random
blocks amplify sum-order noise: measured up to 4.7e-5 of max|logit|
(GPT-NeoX with the sequential residual, a cached decode step; every other
family below 4.1e-6), and on the same weights the JAX package's own
cached steps differ from its causal forward by up to 1.7e-5.
"""
import dataclasses

import numpy as np
import torch

import jax.numpy as jnp

from quip_for_all_tpu.codebooks import get_codebook
from quip_for_all_tpu.models import registry as JR
from quip_for_all_tpu.models.config import ModelConfig as JConfig
from quip_for_all_tpu.ops.qtensor import from_raw_idxs
from quip_for_all_tpu.quantize.quantizer import sublayer_groups
from quip_for_all_tpu.transforms.incoherence import get_hadK
from quip_for_all_tpu.utils.random_quantized import random_qlinear

from quip_for_all_tpu_torch.models.config import ModelConfig
from quip_for_all_tpu_torch.models.tree import get_path, set_path
from quip_for_all_tpu_torch.utils.convert import from_jax_params

BASE = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=4, max_position_embeddings=128)

FAMILIES = {
    "gpt2": dict(arch="gpt2", tie_word_embeddings=True),
    "gpt_neox": dict(arch="gpt_neox", rotary_pct=0.25),
    "gpt_neox_seq": dict(arch="gpt_neox", rotary_pct=0.25,
                         use_parallel_residual=False),
    "opt": dict(arch="opt", tie_word_embeddings=True),
    "falcon": dict(arch="falcon", num_key_value_heads=1,
                   tie_word_embeddings=True),
    "falcon_new": dict(arch="falcon", num_key_value_heads=2,
                       parallel_dual_ln=True, tie_word_embeddings=True),
    "phi": dict(arch="phi", rotary_pct=0.4),
    "gptj": dict(arch="gptj", rotary_pct=0.5),
    "qwen": dict(arch="qwen"),
    "baichuan": dict(arch="baichuan"),
}

F32 = {"compute_dtype": jnp.float32}
T32 = {"compute_dtype": torch.float32}


def configs(name, base=BASE):
    kw = dict(base, **FAMILIES[name])
    return JConfig(**kw), ModelConfig(**kw)


def _init(jcfg, seed):
    A = JR.get_arch(jcfg)
    name = {"gpt_neox": "init_gpt_neox_params",
            "baichuan": "init_llama_params"}.get(
                jcfg.arch, f"init_{jcfg.arch}_params")
    return getattr(A, name)(jcfg, seed=seed, dtype=jnp.float32)


def quantized_tree(jcfg, seed=0, codebook="E8P12"):
    """The family's JAX tree with random quantized linears (module
    docstring)."""
    cb = get_codebook(codebook)
    rng = np.random.default_rng(seed)
    params = _init(jcfg, seed)

    def q(lin, lspec=None, SU=None):
        out_f, in_f = lin["weight"].shape
        p = random_qlinear(cb, in_f, out_f, rng, dtype=jnp.float32,
                           lspec=lspec, SU=SU)
        # real codewords, so that a checkpoint can hold them (the JAX
        # random_qlinear's masked random words are not all E8P12 codes)
        p = dataclasses.replace(p, qweight=from_raw_idxs(
            cb, rng.integers(0, 1 << 16, (p.q_out, p.q_in // 8)),
            p.q_out, p.q_in, layout="nibble"))
        if lin.get("bias") is not None:
            p = dataclasses.replace(p, bias=jnp.asarray(
                0.1 * rng.standard_normal(out_f), jnp.float32))
        return p

    def perturb(node):
        if isinstance(node, dict):
            w = node.get("weight")
            if w is not None and getattr(w, "ndim", 0) == 1:
                node["weight"] = w + jnp.asarray(
                    0.1 * rng.standard_normal(w.shape), jnp.float32)
                if node.get("bias") is not None:
                    node["bias"] = jnp.asarray(
                        0.1 * rng.standard_normal(w.shape), jnp.float32)
                return
            for v in node.values():
                perturb(v)
        elif isinstance(node, list):
            for v in node:
                perturb(v)
    perturb(params)
    for blk in params["layers"]:
        for g in sublayer_groups(jcfg):
            n_in = get_path(blk, g["layers"][0])["weight"].shape[1]
            lspec = get_hadK(n_in, use_rand=True, rng=rng)
            SU = np.sign(rng.standard_normal(n_in)).astype(np.float32)
            for path in g["layers"]:
                set_path(blk, path, q(get_path(blk, path), lspec, SU))
    head = "embed_out" if jcfg.arch == "gpt_neox" else "lm_head"
    if head in params and jcfg.vocab_size % 128 == 0:
        params[head] = q(params[head])
    return params


def case(name, seed=0, base=BASE):
    """(JAX config, JAX tree, port config, port model) on the CPU, at the
    widths of ``base``."""
    jcfg, tcfg = configs(name, base)
    jp = quantized_tree(jcfg, seed)
    return jcfg, jp, tcfg, from_jax_params(jp, "cpu", tcfg)


MODEL_TOL = 1e-4


def assert_close(got, want, rel=1e-5):
    """Within ``rel`` of max|want| plus one f32 ulp of each value."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    tol = rel * np.abs(want).max() + np.spacing(np.abs(want).astype(
        np.float32))
    err = np.abs(got - want)
    assert np.all(err <= tol), (err.max(), np.abs(want).max())


def bf16_step(x):
    """One bf16 step (8 significant bits) at magnitude |x|."""
    return 2.0 ** (np.floor(np.log2(max(abs(float(x)), 1e-30))) - 7)


def assert_ids_agree(jcfg, jparams, n_prompt, got, want):
    """``got`` (port) and ``want`` (JAX), 1-D prompt + generated ids in the
    default bf16 compute of the quantized linears: identical, or forked at
    bf16 ties only (the rule of ``tests/test_torch_serving.py``). Both
    packages round every quantized linear's output to bf16, so two logits
    can tie there and f32 sum order decides which one rounds up. Where the
    ids differ, the JAX model reads the port's ids in one forward, and at
    every generated position from the first difference on the port's
    token must be within one bf16 step of the JAX maximum."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    diff = np.nonzero(got != want)[0]
    if diff.size == 0:
        return
    f = int(diff[0])
    assert f >= n_prompt, "the prompts differ"
    logits, _ = JR.get_arch(jcfg).model_apply(
        jcfg, jparams, jnp.asarray(got[None, :-1]), dtype=jnp.float32)
    for i, row in enumerate(np.asarray(logits)[0, f - 1:], start=f):
        top, mine = row.max(), row[got[i]]
        assert top - mine <= bf16_step(max(abs(top), abs(mine))), (
            f"at {i} the port's token {got[i]} is {top - mine:.3g} below "
            f"the JAX maximum {top:.6g} (JAX's own ids gave {want[i]})")
