"""Load reference-schema quantized checkpoints of every family the JAX
package loads (llama, with Yi's ln1/ln2 norm names; Mixtral; Baichuan, its
qkv one ``W_pack``; GPT-2, GPT-NeoX, OPT, Falcon, Phi, GPT-J and QWen,
under the tensor names of ``_load_gpt2`` ... ``_load_qwen`` there) in
every codebook (E8P12, E8P12RVQ4B, E8P12RVQ3B, D4 and HI) — counterpart of
``load_quantized`` / ``_build_qlinear`` in
``quip_for_all_tpu/utils/checkpoint.py``. Mixtral's router gate loads
dense (or quantized, when the checkpoint quantized it) and its experts as
per-expert quantized linears; ``fuse_for_inference`` stacks them. The
families other than llama, Mixtral and Baichuan load through their
skeletons (``models/tree.py``): each leaf's name is its path under
``model.`` (the head ``lm_head`` without it), as the JAX saver writes it.
``layout`` picks the runtime layout of every quantized linear
(``ops/qtensor.py`` ``resolve_layout``: "u3" for E8P12, "pb" and "paired"
for E8P12RVQ4B, "bfp", "sw2" and "sw4" for every codebook), where the JAX
package reads QFA_E8P_U3 / QFA_RVQ_PB / QFA_RVQ_PAIRED / QFA_BFP /
QFA_SPLIT_DECODE.

The schema: safetensors with HF state-dict names; each quantized linear
stores Qidxs (packed codes), SU, SV, Wscale (unnormalized), optional bias,
had_left/had_right (only with use_rand) and a scalar ``weight`` shim; the
quantization config sits in config.json or quantization_config.json.
Files are read and written with the port's own safetensors code.
A tensor-parallel checkpoint (``tp_shards`` > 1 in its quantization config)
loads each linear with the shards its quantizer drew
(``quantize/quantizer.py``, in both packages): ``shards_left = tp_shards``
on a block's row-parallel linear whose inputs tp divides,
``shards_right = tp_shards`` on a block's column-parallel one whose
outputs it divides (``parallel/sharding.py`` ``role_of``), every other
linear whole, the head included; the table factor is recomputed for the
shard when ``use_rand`` is false. The JAX loader gives every
column-parallel name ``shards_right = tp_shards`` by its role alone, so
it reloads a quantized head (and any linear whose dimension tp does not
divide) as another linear, or raises (ROADMAP.md queue 3).

``save_quantized`` writes that schema from an unfused port model (the
JAX package's ``save_quantized``: the same tensor names, values and
dtypes, the same HF config.json with the quantization config embedded and
quantization_config.json beside it, the same shards under
``max_shard_size``), so a directory saved by either package loads in both.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..codebooks import get_codebook
from ..models.config import ModelConfig
from ..models.llama import LLAMA_ARCHS, LlamaModel
from ..models.registry import get_arch
from ..models.tree import (FamilyModel, LinearSpec, NormSpec, TableSpec,
                           map_skeleton)
from ..models.llama import DenseLinear, Weight
from ..models.tree import Norm
from ..nn.qlinear import QuantLinear
from ..ops.qtensor import from_checkpoint_idxs, to_checkpoint_idxs
from ..transforms.incoherence import get_hadK
from .device import resolve_device
from .safetensors_io import load_file, save_file

QUIP_CONFIG = "quantization_config.json"


def load_quant_config(save_dir: str) -> dict:
    with open(os.path.join(save_dir, "config.json")) as f:
        hf_cfg = json.load(f)
    if "quantization_config" in hf_cfg:
        return hf_cfg["quantization_config"]
    with open(os.path.join(save_dir, QUIP_CONFIG)) as f:
        return json.load(f)


def open_all_tensors(path: str) -> Dict[str, np.ndarray]:
    """Single ``model.safetensors`` or an HF sharded index."""
    index = os.path.join(path, "model.safetensors.index.json")
    if not os.path.isfile(index):
        return load_file(os.path.join(path, "model.safetensors"))
    with open(index) as f:
        weight_map = json.load(f)["weight_map"]
    by_file: Dict[str, list] = {}
    for name, fn in weight_map.items():
        by_file.setdefault(fn, []).append(name)
    tensors: Dict[str, np.ndarray] = {}
    for fn, names in by_file.items():
        tensors.update(load_file(os.path.join(path, fn), names))
    return tensors


def _t(a, device, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        device=device, dtype=dtype)


def _codebook(qcfg: dict):
    ors = qcfg.get("opt_resid_scale", -1)
    return get_codebook(qcfg["codebook"], ors if ors > 0 else None)


# a block's linear: its name holds the block's index
_IN_BLOCK = re.compile(r"\.\d+\.")


def drawn_shards(name: str, tp: int, in_f: int, out_f: int
                 ) -> Tuple[int, int]:
    """(shards_left, shards_right) of the transforms the quantizer drew for
    linear ``name`` at ``tp_shards = tp``: block-diagonal on the dimension
    tp cuts (a block's row-parallel inputs, column-parallel outputs) where
    tp divides it, whole on every other linear and on the head."""
    from ..parallel.sharding import role_of
    if tp == 1 or not _IN_BLOCK.search(name):
        return 1, 1
    role = role_of(name)
    return (tp if role == "row" and in_f % tp == 0 else 1,
            tp if role == "col" and out_f % tp == 0 else 1)


def _build_qlinear(tensors: Dict[str, np.ndarray], name: str, qcfg: dict,
                   device, layout=None) -> QuantLinear:
    tp = int(qcfg.get("tp_shards", 1))
    cb = _codebook(qcfg)
    packed = tensors[name + ".Qidxs"]
    SU = tensors.get(name + ".SU")
    SV = tensors.get(name + ".SV")
    Wscale = tensors[name + ".Wscale"]
    bias = tensors.get(name + ".bias")
    had_left = tensors.get(name + ".had_left")
    had_right = tensors.get(name + ".had_right")

    q_out = packed.shape[0]
    q_in = int(packed.shape[1] * cb.codesz * cb.packsz)
    in_f = SU.shape[0] if SU is not None else q_in
    out_f = SV.shape[0] if SV is not None else q_out
    shards_left, shards_right = drawn_shards(name, tp, in_f, out_f)
    qt = from_checkpoint_idxs(cb, packed, q_out, q_in, device=device,
                              layout=layout)

    use_rand = qcfg.get("use_rand", True)

    def factor(had, n, shards):
        if had is not None:
            return had.shape[0], had
        if not use_rand:
            spec = get_hadK(n, use_rand=False, shards=shards)
            if spec.K > 1:
                return spec.K, spec.hadK
        return 1, None

    K_left, had_left = factor(had_left, in_f, shards_left)
    K_right, had_right = factor(had_right, out_f, shards_right)
    per_channel = bool(qcfg.get("per_channel", False)) and Wscale.ndim == 1
    wscale_float = float(np.mean(Wscale))
    Wn = (_t(Wscale / np.mean(Wscale), device) if per_channel else None)

    def keep_signs(v):
        if v is None or np.all(v == 1.0):
            return None   # load-time drop of all-ones sign vectors
        return _t(v, device)

    return QuantLinear(
        qt, in_features=in_f, out_features=out_f, q_in=q_in, q_out=q_out,
        K_left=K_left, K_right=K_right, SU=keep_signs(SU),
        SV=keep_signs(SV), bias=None if bias is None else _t(bias, device),
        had_left=None if had_left is None else _t(had_left, device),
        had_right=None if had_right is None else _t(had_right, device),
        Wscale=Wn, per_channel=per_channel, wscale_float=wscale_float,
        shards_left=shards_left, shards_right=shards_right)


def load_quantized(save_dir: str, dtype=torch.float32, device="cuda",
                   layout=None) -> Tuple[ModelConfig, Any, dict]:
    """Local checkpoint directory -> (model config, model, quant config),
    every quantized linear in the runtime ``layout``: a ``LlamaModel`` for
    llama, Mixtral and Baichuan, else the family's ``FamilyModel``."""
    dev = resolve_device(device)
    if not os.path.isdir(save_dir):
        raise FileNotFoundError(f"{save_dir!r} is not a local directory")
    cfg = ModelConfig.from_pretrained_dir(save_dir)
    qcfg = load_quant_config(save_dir)
    _codebook(qcfg)                         # refuses an unknown codebook
    tensors = open_all_tensors(save_dir)
    if any(".ln1.weight" in k for k in tensors):
        tensors = {k.replace(".ln1.", ".input_layernorm.").replace(
            ".ln2.", ".post_attention_layernorm."): v
            for k, v in tensors.items()}
    qnames = {k[: -len(".Qidxs")] for k in tensors if k.endswith(".Qidxs")}

    def dense(name):
        if name in qnames:
            return _build_qlinear(tensors, name, qcfg, dev, layout)
        return {"weight": _t(tensors[name + ".weight"], dev, dtype),
                "bias": (_t(tensors[name + ".bias"], dev, dtype)
                         if name + ".bias" in tensors else None)}

    def w(name):
        return {"weight": _t(tensors[name], dev, dtype)}

    if cfg.arch not in LLAMA_ARCHS:
        return cfg, _load_family(cfg, tensors, dense, dtype, dev), qcfg
    tree: Dict[str, Any] = {
        "embed_tokens": w("model.embed_tokens.weight"),
        "norm": w("model.norm.weight"),
        "layers": [],
    }
    if "lm_head.weight" in tensors or "lm_head.Qidxs" in tensors:
        tree["lm_head"] = dense("lm_head")
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        blk = {
            "input_layernorm": w(f"{p}.input_layernorm.weight"),
            "post_attention_layernorm":
                w(f"{p}.post_attention_layernorm.weight"),
            "self_attn": {x: dense(f"{p}.self_attn.{x}")
                          for x in (("W_pack", "o_proj")
                                    if cfg.arch == "baichuan" else
                                    ("q_proj", "k_proj", "v_proj",
                                     "o_proj"))},
        }
        if cfg.arch == "mixtral":
            moe = f"{p}.block_sparse_moe"
            blk["block_sparse_moe"] = {
                "gate": dense(f"{moe}.gate"),
                "experts": [{x: dense(f"{moe}.experts.{e}.{x}")
                             for x in ("w1", "w2", "w3")}
                            for e in range(cfg.num_local_experts)],
            }
        else:
            blk["mlp"] = {x: dense(f"{p}.mlp.{x}")
                          for x in ("gate_proj", "up_proj", "down_proj")}
        tree["layers"].append(blk)
    return cfg, LlamaModel.from_tree(tree), qcfg


def _load_family(cfg: ModelConfig, tensors: Dict[str, np.ndarray], dense,
                 dtype, dev) -> FamilyModel:
    """A family's tree from its skeleton: linears through ``dense``
    (quantized where the checkpoint has Qidxs), norms with their bias
    where they have one, tables. A head the checkpoint lacks is left out
    (QWen's tied head, as the JAX loader decides by the tensors)."""
    def leaf(path, spec):
        name = ".".join(str(k) for k in path)
        if path[0] != "lm_head":
            name = "model." + name
        if isinstance(spec, LinearSpec):
            if (path[0] == "lm_head" and name + ".weight" not in tensors
                    and name + ".Qidxs" not in tensors):
                return None
            return dense(name)
        if isinstance(spec, NormSpec):
            return {"weight": _t(tensors[name + ".weight"], dev, dtype),
                    "bias": (_t(tensors[name + ".bias"], dev, dtype)
                             if spec.bias else None)}
        assert isinstance(spec, TableSpec)
        return {"weight": _t(tensors[name + ".weight"], dev, dtype)}
    skel = get_arch(cfg).param_skeleton(cfg)
    return FamilyModel.from_tree(cfg, map_skeleton(skel, leaf))


# --------------------------------------------------------------- saving

def _np(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _flatten(model, qcfg: dict, prefix: str = "model."
             ) -> Dict[str, np.ndarray]:
    """{HF tensor name: array} of an unfused model, in the JAX tree's
    order (which decides the shards)."""
    from torch import nn
    out: Dict[str, np.ndarray] = {}

    def emit_linear(name: str, lin):
        if isinstance(lin, QuantLinear):
            out[name + ".Qidxs"] = to_checkpoint_idxs(lin.qweight)
            out[name + ".SU"] = (_np(lin.SU) if lin.SU is not None else
                                 np.ones((lin.in_features,), np.float32))
            out[name + ".SV"] = (_np(lin.SV) if lin.SV is not None else
                                 np.ones((lin.out_features,), np.float32))
            if lin.per_channel:
                out[name + ".Wscale"] = _np(lin.Wscale) * lin.wscale_float
            else:
                out[name + ".Wscale"] = np.asarray(lin.wscale_float,
                                                   np.float32)
            out[name + ".weight"] = np.zeros((), np.float32)  # HF shim
            if lin.bias is not None:
                out[name + ".bias"] = _np(lin.bias)
            if qcfg.get("use_rand", True):
                if lin.had_left is not None:
                    out[name + ".had_left"] = _np(lin.had_left)
                if lin.had_right is not None:
                    out[name + ".had_right"] = _np(lin.had_right)
            return
        out[name + ".weight"] = _np(lin.weight)
        if getattr(lin, "bias", None) is not None:
            out[name + ".bias"] = _np(lin.bias)

    def walk(node, name):
        if isinstance(node, (QuantLinear, DenseLinear, Weight, Norm)):
            emit_linear(name, node)
        elif isinstance(node, nn.ModuleDict):
            for k, v in node.items():
                walk(v, f"{name}.{k}" if name else k)
        elif isinstance(node, nn.ModuleList):
            for i, v in enumerate(node):
                walk(v, f"{name}.{i}")
        elif node is not None:
            raise TypeError(f"{name}: cannot save a {type(node).__name__} "
                            "(save the unfused model)")

    for key, node in model.named_children():
        walk(node, ("" if key == "lm_head" else prefix) + key)
    return out


# HF config.json emitter, per family: hf_key -> ModelConfig attribute name
# or callable(cfg) (the JAX package's tables).
_LLAMA_KEYS = {
    "vocab_size": "vocab_size",
    "hidden_size": "hidden_size",
    "intermediate_size": "intermediate_size",
    "num_hidden_layers": "num_hidden_layers",
    "num_attention_heads": "num_attention_heads",
    "num_key_value_heads": "num_key_value_heads",
    "head_dim": "head_dim",
    "max_position_embeddings": "max_position_embeddings",
    "rms_norm_eps": "rms_norm_eps",
    "rope_theta": "rope_theta",
    "attention_bias": "attention_bias",
    "tie_word_embeddings": "tie_word_embeddings",
    "num_local_experts": "num_local_experts",
    "num_experts_per_tok": "num_experts_per_tok",
}
_HF_CONFIG_KEYS = {
    "gpt2": {
        "vocab_size": "vocab_size", "n_embd": "hidden_size",
        "n_inner": "intermediate_size", "n_layer": "num_hidden_layers",
        "n_head": "num_attention_heads",
        "n_positions": "max_position_embeddings",
        "layer_norm_epsilon": "rms_norm_eps",
    },
    "gpt_neox": {
        "vocab_size": "vocab_size", "hidden_size": "hidden_size",
        "intermediate_size": "intermediate_size",
        "num_hidden_layers": "num_hidden_layers",
        "num_attention_heads": "num_attention_heads",
        "max_position_embeddings": "max_position_embeddings",
        "layer_norm_eps": "rms_norm_eps", "rotary_emb_base": "rope_theta",
        "rotary_pct": "rotary_pct",
        "use_parallel_residual": "use_parallel_residual",
    },
    "gptj": {
        "vocab_size": "vocab_size", "n_embd": "hidden_size",
        "n_inner": "intermediate_size", "n_layer": "num_hidden_layers",
        "n_head": "num_attention_heads",
        "n_positions": "max_position_embeddings",
        "layer_norm_epsilon": "rms_norm_eps",
        "rotary_dim": lambda c: int(c.rotary_pct * c.head_dim),
    },
    "phi": {
        "vocab_size": "vocab_size", "hidden_size": "hidden_size",
        "intermediate_size": "intermediate_size",
        "num_hidden_layers": "num_hidden_layers",
        "num_attention_heads": "num_attention_heads",
        "max_position_embeddings": "max_position_embeddings",
        "layer_norm_eps": "rms_norm_eps", "rope_theta": "rope_theta",
        "partial_rotary_factor": "rotary_pct",
    },
    "falcon": {
        "vocab_size": "vocab_size", "hidden_size": "hidden_size",
        "ffn_hidden_size": "intermediate_size",
        "num_hidden_layers": "num_hidden_layers",
        "num_attention_heads": "num_attention_heads",
        "multi_query": lambda c: c.num_key_value_heads == 1,
        "parallel_attn": "use_parallel_residual",
        "new_decoder_architecture": "parallel_dual_ln",
        "num_kv_heads": "num_key_value_heads",
        "max_position_embeddings": "max_position_embeddings",
        "layer_norm_epsilon": "rms_norm_eps", "rope_theta": "rope_theta",
    },
    "opt": {
        "vocab_size": "vocab_size", "hidden_size": "hidden_size",
        "ffn_dim": "intermediate_size",
        "num_hidden_layers": "num_hidden_layers",
        "num_attention_heads": "num_attention_heads",
        "max_position_embeddings": "max_position_embeddings",
        "do_layer_norm_before": lambda c: True,
    },
    "qwen": {
        "vocab_size": "vocab_size", "hidden_size": "hidden_size",
        # QWen stores intermediate_size before the halving (ModelConfig)
        "intermediate_size": lambda c: 2 * c.intermediate_size,
        "num_hidden_layers": "num_hidden_layers",
        "num_attention_heads": "num_attention_heads",
        "kv_channels": "head_dim",
        "seq_length": "max_position_embeddings",
        "layer_norm_epsilon": "rms_norm_eps",
        "rotary_emb_base": "rope_theta",
        "tie_word_embeddings": "tie_word_embeddings",
    },
}


def _model_type(cfg: ModelConfig) -> str:
    if cfg.arch in _HF_CONFIG_KEYS:
        return cfg.arch
    return cfg.arch if cfg.arch in ("mixtral", "baichuan") else "llama"


def hf_config_dict(cfg: ModelConfig) -> dict:
    """The HF config.json of ``cfg`` (``ModelConfig.from_hf_config`` reads
    it back)."""
    keys = _HF_CONFIG_KEYS.get(cfg.arch, _LLAMA_KEYS)
    out = {"model_type": _model_type(cfg)}
    for hf_key, src in keys.items():
        out[hf_key] = src(cfg) if callable(src) else getattr(cfg, src)
    return out


def _parse_size(size) -> int:
    if isinstance(size, int):
        return size
    s = str(size).strip().upper()
    for suffix, mult in (("GB", 1 << 30), ("MB", 1 << 20), ("KB", 1 << 10),
                         ("B", 1)):
        if s.endswith(suffix):
            return int(float(s[: -len(suffix)]) * mult)
    return int(s)


def _save_sharded(flat: Dict[str, np.ndarray], save_dir: str,
                  max_bytes: int) -> None:
    """One ``model.safetensors`` when everything fits in ``max_bytes``,
    else size-capped ``model-XXXXX-of-YYYYY.safetensors`` shards and
    ``model.safetensors.index.json`` (HF's layout); stale files of the
    other layout are removed."""
    import glob
    total = sum(int(v.nbytes) for v in flat.values())
    index_path = os.path.join(save_dir, "model.safetensors.index.json")

    def drop_stale_shards(keep: set):
        for p in glob.glob(os.path.join(save_dir,
                                        "model-*-of-*.safetensors")):
            if os.path.basename(p) not in keep:
                os.remove(p)

    if total <= max_bytes:
        save_file(flat, os.path.join(save_dir, "model.safetensors"))
        if os.path.exists(index_path):
            os.remove(index_path)
        drop_stale_shards(set())
        return
    shards = [{}]
    cur = 0
    for k, v in flat.items():
        if shards[-1] and cur + int(v.nbytes) > max_bytes:
            shards.append({})
            cur = 0
        shards[-1][k] = v
        cur += int(v.nbytes)
    n = len(shards)
    weight_map = {}
    for i, sh in enumerate(shards, 1):
        fn = f"model-{i:05d}-of-{n:05d}.safetensors"
        save_file(sh, os.path.join(save_dir, fn))
        weight_map.update({k: fn for k in sh})
    single = os.path.join(save_dir, "model.safetensors")
    if os.path.exists(single):
        os.remove(single)
    drop_stale_shards(set(weight_map.values()))
    with open(index_path, "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=2)


def save_quantized(cfg: ModelConfig, model, quant_config: dict,
                   save_dir: str, max_shard_size="10GB") -> None:
    """Write an unfused quantized model (``QuipQuantizer.quantize_model``'s
    result, or ``load_quantized``'s) in the reference schema."""
    os.makedirs(save_dir, exist_ok=True)
    _save_sharded(_flatten(model, quant_config), save_dir,
                  _parse_size(max_shard_size))
    hf_cfg = hf_config_dict(cfg)
    hf_cfg["quantization_config"] = quant_config
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    with open(os.path.join(save_dir, QUIP_CONFIG), "w") as f:
        json.dump(quant_config, f, indent=2)
