"""The quantizer's per-family tables — counterpart of
``quip_for_all_tpu/quantize/quantizer.py``. Only ``sublayer_groups`` is
ported so far: ``utils/random_quantized.py`` and the tests follow it.
``QuipQuantizer`` waits for the quantization slice (ROADMAP.md queue 1
item 6).
"""
from __future__ import annotations

from typing import Any, Dict, List

from ..models.config import ModelConfig


def sublayer_groups(cfg: ModelConfig) -> List[Dict[str, Any]]:
    """Quantization order within a block: qkv -> o -> fc1 -> fc2. Each
    entry maps a capture key to the linear layer paths fed by that
    activation; the linears of one entry share their left transform and
    SU under the quantizer's shared group transforms (which
    ``fuse_for_inference`` relies on)."""
    if cfg.arch == "gpt2":
        return [
            {"capture": "qkv", "layers": ["attn.c_attn"]},
            {"capture": "o", "layers": ["attn.c_proj"]},
            {"capture": "fc1", "layers": ["mlp.c_fc"]},
            {"capture": "fc2", "layers": ["mlp.c_proj"]},
        ]
    if cfg.arch == "gpt_neox":
        return [
            {"capture": "qkv", "layers": ["attention.query_key_value"]},
            {"capture": "o", "layers": ["attention.dense"]},
            {"capture": "fc1", "layers": ["mlp.dense_h_to_4h"]},
            {"capture": "fc2", "layers": ["mlp.dense_4h_to_h"]},
        ]
    if cfg.arch == "falcon":
        return [
            {"capture": "qkv",
             "layers": ["self_attention.query_key_value"]},
            {"capture": "o", "layers": ["self_attention.dense"]},
            {"capture": "fc1", "layers": ["mlp.dense_h_to_4h"]},
            {"capture": "fc2", "layers": ["mlp.dense_4h_to_h"]},
        ]
    if cfg.arch == "phi":
        return [
            {"capture": "qkv", "layers": ["self_attn.q_proj",
                                          "self_attn.k_proj",
                                          "self_attn.v_proj"]},
            {"capture": "o", "layers": ["self_attn.dense"]},
            {"capture": "fc1", "layers": ["mlp.fc1"]},
            {"capture": "fc2", "layers": ["mlp.fc2"]},
        ]
    if cfg.arch == "gptj":
        return [
            {"capture": "qkv", "layers": ["attn.q_proj", "attn.k_proj",
                                          "attn.v_proj"]},
            {"capture": "o", "layers": ["attn.out_proj"]},
            {"capture": "fc1", "layers": ["mlp.fc_in"]},
            {"capture": "fc2", "layers": ["mlp.fc_out"]},
        ]
    if cfg.arch == "opt":
        return [
            {"capture": "qkv", "layers": ["self_attn.q_proj",
                                          "self_attn.k_proj",
                                          "self_attn.v_proj"]},
            {"capture": "o", "layers": ["self_attn.out_proj"]},
            {"capture": "fc1", "layers": ["fc1"]},
            {"capture": "fc2", "layers": ["fc2"]},
        ]
    if cfg.arch == "mixtral":
        groups = [
            {"capture": "qkv", "layers": ["self_attn.q_proj",
                                          "self_attn.k_proj",
                                          "self_attn.v_proj"]},
            {"capture": "o", "layers": ["self_attn.o_proj"]},
        ]
        for e in range(cfg.num_local_experts):
            groups.append({"capture": "moe_input", "routing_expert": e,
                           "layers": [f"block_sparse_moe.experts.{e}.w1",
                                      f"block_sparse_moe.experts.{e}.w3"]})
        for e in range(cfg.num_local_experts):
            groups.append({"capture": f"expert{e}_down",
                           "layers": [f"block_sparse_moe.experts.{e}.w2"]})
        return groups
    if cfg.arch == "qwen":
        # legacy QWen-1: fused c_attn, w1/w2 share the ln_2 activation,
        # c_proj consumes the product
        return [
            {"capture": "qkv", "layers": ["attn.c_attn"]},
            {"capture": "o", "layers": ["attn.c_proj"]},
            {"capture": "fc1", "layers": ["mlp.w1", "mlp.w2"]},
            {"capture": "fc2", "layers": ["mlp.c_proj"]},
        ]
    if cfg.arch == "baichuan":
        return [
            {"capture": "qkv", "layers": ["self_attn.W_pack"]},
            {"capture": "o", "layers": ["self_attn.o_proj"]},
            {"capture": "gateup", "layers": ["mlp.gate_proj",
                                             "mlp.up_proj"]},
            {"capture": "down", "layers": ["mlp.down_proj"]},
        ]
    return [
        {"capture": "qkv", "layers": ["self_attn.q_proj", "self_attn.k_proj",
                                      "self_attn.v_proj"]},
        {"capture": "o", "layers": ["self_attn.o_proj"]},
        {"capture": "gateup", "layers": ["mlp.gate_proj", "mlp.up_proj"]},
        {"capture": "down", "layers": ["mlp.down_proj"]},
    ]
