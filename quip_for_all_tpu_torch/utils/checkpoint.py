"""Load reference-schema quantized checkpoints (llama family and Mixtral,
every codebook: E8P12, E8P12RVQ4B, E8P12RVQ3B, D4 and HI) — counterpart of
``load_quantized`` / ``_build_qlinear`` in
``quip_for_all_tpu/utils/checkpoint.py``. Mixtral's router gate loads
dense (or quantized, when the checkpoint quantized it) and its experts as
per-expert quantized linears; ``fuse_for_inference`` stacks them.
``layout`` picks the runtime layout of every quantized linear
(``ops/qtensor.py`` ``resolve_layout``: "u3" for E8P12, "pb" and "paired"
for E8P12RVQ4B, "bfp", "sw2" and "sw4" for every codebook), where the JAX
package reads QFA_E8P_U3 / QFA_RVQ_PB / QFA_RVQ_PAIRED / QFA_BFP /
QFA_SPLIT_DECODE.

The schema: safetensors with HF state-dict names; each quantized linear
stores Qidxs (packed codes), SU, SV, Wscale (unnormalized), optional bias,
had_left/had_right (only with use_rand) and a scalar ``weight`` shim; the
quantization config sits in config.json or quantization_config.json.
Files are read with the port's own safetensors reader. Other families and
tensor-parallel checkpoints raise NotImplementedError naming their
roadmap slice. Saving waits for the quantization slice.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..codebooks import get_codebook
from ..models.config import ModelConfig
from ..models.llama import LlamaModel
from ..nn.qlinear import QuantLinear
from ..ops.qtensor import from_checkpoint_idxs
from ..transforms.incoherence import get_hadK
from .device import resolve_device
from .safetensors_io import load_file

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


def _build_qlinear(tensors: Dict[str, np.ndarray], name: str, qcfg: dict,
                   device, layout=None) -> QuantLinear:
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
    qt = from_checkpoint_idxs(cb, packed, q_out, q_in, device=device,
                              layout=layout)

    use_rand = qcfg.get("use_rand", True)

    def factor(had, n):
        if had is not None:
            return had.shape[0], had
        if not use_rand:
            spec = get_hadK(n, use_rand=False)
            if spec.K > 1:
                return spec.K, spec.hadK
        return 1, None

    K_left, had_left = factor(had_left, in_f)
    K_right, had_right = factor(had_right, out_f)
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
        Wscale=Wn, per_channel=per_channel, wscale_float=wscale_float)


def load_quantized(save_dir: str, dtype=torch.float32, device="cuda",
                   layout=None) -> Tuple[ModelConfig, LlamaModel, dict]:
    """Local checkpoint directory -> (model config, model, quant config),
    every quantized linear in the runtime ``layout``."""
    dev = resolve_device(device)
    if not os.path.isdir(save_dir):
        raise FileNotFoundError(f"{save_dir!r} is not a local directory")
    cfg = ModelConfig.from_pretrained_dir(save_dir)
    qcfg = load_quant_config(save_dir)
    if cfg.arch not in ("llama", "mixtral"):
        raise NotImplementedError(
            f"arch {cfg.arch!r} is not ported yet (ROADMAP.md queue 1, "
            "slice 5)")
    if int(qcfg.get("tp_shards", 1)) > 1:
        raise NotImplementedError("tensor-parallel checkpoints (ROADMAP.md "
                                  "queue 1, slice 8)")
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
                          for x in ("q_proj", "k_proj", "v_proj", "o_proj")},
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
