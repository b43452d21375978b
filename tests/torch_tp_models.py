"""The tensor-parallel tests' models, built on the JAX side and carried to
the port (``tests/test_torch_tp_forward.py``, ``test_torch_tp_serving.py``):
each family's tiny tree of ``tests/torch_family_cases.py`` (random E8P12
codewords, or E8P12RVQ4B codes for the paired layout), optionally with a
block-diagonal transform of ``tp`` shards on the side tensor parallelism
shards (``block_diagonal``: a column-parallel linear's right transform, a
row-parallel one's left, as ``QuipQuantizer(tp_shards=tp)`` draws them
and the loader's role rule reads them), then ``from_jax_params`` and,
where asked, the planes re-laid in another runtime layout.
"""
import dataclasses

import numpy as np

import jax.numpy as jnp

from quip_for_all_tpu.codebooks import get_codebook
from quip_for_all_tpu.models import registry as JR
from quip_for_all_tpu.models.config import ModelConfig as JConfig
from quip_for_all_tpu.nn.qlinear import QuantLinearParams
from quip_for_all_tpu.ops.qtensor import from_raw_idxs
from quip_for_all_tpu.parallel.sharding import role_of
from quip_for_all_tpu.transforms.incoherence import get_hadK

from quip_for_all_tpu_torch.models.config import ModelConfig
from quip_for_all_tpu_torch.nn.qlinear import QuantLinear
from quip_for_all_tpu_torch.ops import qtensor as tq
from quip_for_all_tpu_torch.utils.convert import from_jax_params

import torch_family_cases as FC

LLAMA = dict(arch="llama", num_key_value_heads=2)


def _walk(node, name, fn):
    if isinstance(node, QuantLinearParams):
        return fn(node, name)
    if isinstance(node, dict):
        return {k: _walk(v, f"{name}.{k}" if name else k, fn)
                for k, v in node.items()}
    if isinstance(node, list):
        return [_walk(v, f"{name}.{i}", fn) for i, v in enumerate(node)]
    return node


def block_diagonal(params, tp: int, seed: int = 7):
    """The JAX tree with every column-parallel linear's right transform
    and every row-parallel one's left transform made block-diagonal over
    ``tp`` shards (random sub-factors from ``seed``). The codes are random,
    so the model stays valid."""
    rng = np.random.default_rng(seed)

    def fn(p, name):
        role = role_of(name)
        if role == "col" and p.q_out % tp == 0:
            s = get_hadK(p.q_out, rng=rng, shards=tp)
            return dataclasses.replace(
                p, had_right=None if s.hadK is None else jnp.asarray(s.hadK),
                K_right=s.K, shards_right=tp)
        if role == "row" and p.q_in % tp == 0:
            s = get_hadK(p.q_in, rng=rng, shards=tp)
            return dataclasses.replace(
                p, had_left=None if s.hadK is None else jnp.asarray(s.hadK),
                K_left=s.K, shards_left=tp)
        return p
    return _walk(params, "", fn)


def rvq4b_codes(params, seed: int = 3):
    """Every quantized linear's codes redrawn as uniform E8P12RVQ4B codes
    (both stages random), nibble planes."""
    cb = get_codebook("E8P12RVQ4B")
    rng = np.random.default_rng(seed)

    def fn(p, name):
        idx = rng.integers(0, 1 << 32, (p.q_out, p.q_in // 8),
                           dtype=np.uint64).astype(np.uint32).view(np.int32)
        return dataclasses.replace(p, qweight=from_raw_idxs(
            cb, idx, p.q_out, p.q_in, layout="nibble"))
    return _walk(params, "", fn)


def relayout_port(model, layout: str):
    """Every QuantLinear of the port ``model`` re-laid in ``layout``, in
    place (the same codes)."""
    for mod in model.modules():
        if isinstance(mod, QuantLinear) and mod.plane_keys:
            q = mod.qweight
            if layout in tq.UCODE_LAYOUTS:
                from quip_for_all_tpu_torch.codebooks import get_codebook \
                    as tget
                new = tq.from_raw_idxs(
                    tget(q.codebook_id), tq.to_raw_idxs(q), q.q_out, q.q_in,
                    device="cpu", layout=layout)
            else:
                new = tq.relayout(tq.to_nibble(q), layout)
            for k in mod.plane_keys:
                delattr(mod, f"planes_{k}")
            mod._set_qweight(new)
    return model


def build(family: str, tp: int = 0, layout=None, codebook="E8P12",
          fuse=False, seed=0, base=None):
    """(JAX config, JAX tree, port config, port model): ``family`` a key
    of ``torch_family_cases.FAMILIES`` or "llama"; ``tp`` > 0 makes the
    tree block-diagonal over tp shards; ``layout`` re-lays the port's
    planes; ``fuse`` runs the port's ``fuse_for_inference``."""
    kw = dict(base or FC.BASE,
              **(LLAMA if family == "llama" else FC.FAMILIES[family]))
    jcfg, tcfg = JConfig(**kw), ModelConfig(**kw)
    jp = FC.quantized_tree(jcfg, seed)
    if codebook == "E8P12RVQ4B":
        jp = rvq4b_codes(jp)
    if tp:
        jp = block_diagonal(jp, tp)
    model = from_jax_params(jp, "cpu", tcfg)
    if layout is not None:
        relayout_port(model, layout)
    if fuse:
        from quip_for_all_tpu_torch.models.registry import fuse_for_inference
        model = fuse_for_inference(tcfg, model)
    return jcfg, jp, tcfg, model


def jax_logits(jcfg, jp, ids):
    """JAX's unsharded f32 logits of ``ids`` (f32 compute)."""
    logits, _ = JR.get_arch(jcfg).model_apply(
        jcfg, jp, jnp.asarray(ids), dtype=jnp.float32,
        linear_kw=FC.F32)
    return np.asarray(logits)
