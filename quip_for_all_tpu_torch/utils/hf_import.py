"""Import float HuggingFace checkpoints (local directories) of every family
into the port's dense model, and write them — counterpart of
``quip_for_all_tpu/utils/hf_import.py``.

``load_hf_model`` reads config.json and the safetensors files (single or
index-sharded, with the port's own reader) and maps the HF tensor names
onto the JAX tree's keys: llama (with Yi's ln1/ln2 and the wq/wo/
feed_forward aliases), Mixtral and Baichuan become a ``LlamaModel``;
GPT-2 (its Conv1D weights transposed to (out, in)), GPT-NeoX, OPT,
Falcon, Phi, GPT-J and QWen a ``FamilyModel``. Only local directories are
read: there is no hub download. ``save_hf_model`` writes a dense model
back under HF names (the inverse, for every family), so the quantize CLI
can be driven end to end from a directory a test or a script wrote.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.llama import LLAMA_ARCHS, DenseLinear, LlamaModel, Weight
from ..models.tree import FamilyModel, Norm
from .checkpoint import hf_config_dict, open_all_tensors
from .device import resolve_device
from .safetensors_io import save_file

_LLAMA_ALIASES = (
    ("model.tok_embeddings.", "model.embed_tokens."),
    ("tok_embeddings.", "model.embed_tokens."),
    (".attention.wq.", ".self_attn.q_proj."),
    (".attention.wk.", ".self_attn.k_proj."),
    (".attention.wv.", ".self_attn.v_proj."),
    (".attention.wo.", ".self_attn.o_proj."),
    (".attention.q_proj.", ".self_attn.q_proj."),
    (".attention.k_proj.", ".self_attn.k_proj."),
    (".attention.v_proj.", ".self_attn.v_proj."),
    (".attention.o_proj.", ".self_attn.o_proj."),
    (".feed_forward.w1.", ".mlp.gate_proj."),
    (".feed_forward.w3.", ".mlp.up_proj."),
    (".feed_forward.w2.", ".mlp.down_proj."),
    (".attention_norm.", ".input_layernorm."),
    (".ffn_norm.", ".post_attention_layernorm."),
)

# family -> (prefix of the non-head tensors, HF name of the block list,
# top-level keys written without the prefix)
_FAMILY_NAMES = {
    "gpt2": ("transformer.", "h", ()),
    "gpt_neox": ("gpt_neox.", "layers", ("embed_out",)),
    "opt": ("model.decoder.", "layers", ()),
    "falcon": ("transformer.", "h", ()),
    "phi": ("model.", "layers", ("lm_head",)),
    "gptj": ("transformer.", "h", ("lm_head",)),
    "qwen": ("transformer.", "h", ("lm_head",)),
}


def local_model_dir(path: str) -> str:
    """``path`` when it is a local directory; the port reads nothing from
    the network (the JAX package's hub fallback is not ported)."""
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"{path!r} is not a local directory: the port loads local HF "
            "checkpoints only (no hub download)")
    return path


def _llama_fix(k: str) -> str:
    for a, b in _LLAMA_ALIASES:
        k = k.replace(a, b)
    if k in ("output.weight", "model.output.weight"):
        k = "lm_head.weight"
    if k in ("model.norm.weight", "norm.weight"):
        k = "model.norm.weight"
    if not k.startswith(("model.", "lm_head.")):
        k = "model." + k
    return k


def load_hf_model(path: str, dtype=torch.float32, device="cuda"
                  ) -> Tuple[ModelConfig, Any]:
    """Local HF checkpoint -> (config, dense model on ``device``, the card
    unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    path = local_model_dir(path)
    cfg = ModelConfig.from_pretrained_dir(path)
    t = open_all_tensors(path)

    def arr(name):
        return torch.from_numpy(np.ascontiguousarray(
            t[name], np.float32)).to(device=dev, dtype=dtype)

    def lin(name, transpose=False):
        w = arr(name + ".weight")
        return {"weight": w.T.contiguous() if transpose else w,
                "bias": arr(name + ".bias") if name + ".bias" in t else None}

    if cfg.arch in LLAMA_ARCHS:
        if any(".ln1.weight" in k for k in t):
            t = {k.replace(".ln1.", ".input_layernorm.").replace(
                ".ln2.", ".post_attention_layernorm."): v
                for k, v in t.items()}
        if "model.embed_tokens.weight" not in t:
            t = {_llama_fix(k): v for k, v in t.items()}
        return cfg, _llama_tree(cfg, t, arr, lin)
    return cfg, _family_tree(cfg, t, arr, lin)


def _llama_tree(cfg, t, arr, lin) -> LlamaModel:
    tree: Dict[str, Any] = {
        "embed_tokens": {"weight": arr("model.embed_tokens.weight")},
        "norm": {"weight": arr("model.norm.weight")},
        "layers": [],
    }
    if "lm_head.weight" in t:
        tree["lm_head"] = lin("lm_head")
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        attn = (("W_pack", "o_proj") if cfg.arch == "baichuan" else
                ("q_proj", "k_proj", "v_proj", "o_proj"))
        blk: Dict[str, Any] = {
            "input_layernorm": {"weight": arr(f"{p}.input_layernorm.weight")},
            "post_attention_layernorm":
                {"weight": arr(f"{p}.post_attention_layernorm.weight")},
            "self_attn": {x: lin(f"{p}.self_attn.{x}") for x in attn},
        }
        if cfg.arch == "mixtral":
            moe = f"{p}.block_sparse_moe"
            blk["block_sparse_moe"] = {
                "gate": lin(f"{moe}.gate"),
                "experts": [{w: lin(f"{moe}.experts.{e}.{w}")
                             for w in ("w1", "w2", "w3")}
                            for e in range(cfg.num_local_experts)],
            }
        else:
            blk["mlp"] = {x: lin(f"{p}.mlp.{x}")
                          for x in ("gate_proj", "up_proj", "down_proj")}
        tree["layers"].append(blk)
    return LlamaModel.from_tree(tree)


def _family_prefix(cfg, t) -> str:
    """The prefix this checkpoint uses (HF exports differ: with or without
    the base model's name)."""
    pre, _, _ = _FAMILY_NAMES[cfg.arch]
    probe = {"gpt2": "wte.weight", "gpt_neox": "embed_in.weight",
             "opt": "embed_tokens.weight",
             "falcon": "word_embeddings.weight",
             "phi": "embed_tokens.weight", "gptj": "wte.weight",
             "qwen": "wte.weight"}[cfg.arch]
    if pre + probe in t:
        return pre
    if cfg.arch == "opt" and "decoder." + probe in t:
        return "decoder."
    return ""


def _family_tree(cfg, t, arr, lin) -> FamilyModel:
    """A family's tree by its skeleton (``models/tree.py``): each leaf's
    HF name from its path; QWen's head and Falcon's second norm only where
    the checkpoint has them."""
    from ..models.registry import get_arch
    from ..models.tree import LinearSpec, NormSpec, map_skeleton
    _, layers_name, bare = _FAMILY_NAMES[cfg.arch]
    pre = _family_prefix(cfg, t)

    def name_of(path) -> str:
        keys = [str(k) for k in path]
        if keys[0] in bare:
            return ".".join(keys)
        if keys[0] == "layers":
            keys[0] = layers_name
        return pre + ".".join(keys)

    def leaf(path, spec):
        name = name_of(path)
        if name + ".weight" not in t:
            return None
        if isinstance(spec, LinearSpec):
            return lin(name, transpose=cfg.arch == "gpt2")
        if isinstance(spec, NormSpec):
            return {"weight": arr(name + ".weight"),
                    "bias": arr(name + ".bias") if spec.bias else None}
        return {"weight": arr(name + ".weight")}
    tree = map_skeleton(get_arch(cfg).param_skeleton(cfg), leaf)
    return FamilyModel.from_tree(cfg, tree)


def save_hf_model(cfg: ModelConfig, model, path: str) -> None:
    """Write a dense float model as an HF checkpoint directory (config.json
    and model.safetensors), the inverse of ``load_hf_model``: llama-family
    names for ``LlamaModel``s, each family's own (its prefix, GPT-2's
    Conv1D (in, out) weights) for the others."""
    from torch import nn
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config_dict(cfg), f, indent=1)
    if cfg.arch in LLAMA_ARCHS:
        pre, layers_name, bare = "model.", "layers", ("lm_head",)
    else:
        pre, layers_name, bare = _FAMILY_NAMES[cfg.arch]
    out: Dict[str, np.ndarray] = {}

    def np32(x):
        return x.detach().to("cpu", torch.float32).numpy()

    def walk(node, keys):
        if isinstance(node, (DenseLinear, Weight, Norm)):
            if keys[0] in bare:
                name = ".".join(keys)
            else:
                name = pre + ".".join([layers_name] + keys[1:]
                                      if keys[0] == "layers" else keys)
            w = np32(node.weight)
            if cfg.arch == "gpt2" and isinstance(node, DenseLinear):
                w = np.ascontiguousarray(w.T)
            out[name + ".weight"] = w
            if getattr(node, "bias", None) is not None:
                out[name + ".bias"] = np32(node.bias)
        elif isinstance(node, nn.ModuleDict):
            for k, v in node.items():
                walk(v, keys + [k])
        elif isinstance(node, nn.ModuleList):
            for i, v in enumerate(node):
                walk(v, keys + [str(i)])
        elif node is not None:
            raise TypeError(f"{'.'.join(keys)}: save_hf_model writes dense "
                            f"models, not a {type(node).__name__}")
    for key, node in model.named_children():
        walk(node, [key])
    save_file(out, os.path.join(path, "model.safetensors"))
