"""Model configs for the supported decoder families.

A copy of ``quip_for_all_tpu/models/config.py`` (numpy-free, framework-free)
so that the PyTorch port imports nothing of the JAX package. Every family
parsed here runs in the port, each through its module in ``models/``
(``models/registry.py`` ``get_arch``).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str = "llama"               # "llama" | "mixtral"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: Optional[int] = None
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    attention_bias: bool = False      # qwen2-style qkv bias
    tie_word_embeddings: bool = False
    # MoE (mixtral)
    num_local_experts: int = 0
    num_experts_per_tok: int = 2
    # gpt_neox family
    rotary_pct: float = 1.0
    use_parallel_residual: bool = True
    # falcon new_decoder_architecture (40B/180B): parallel residual with
    # separate ln_attn / ln_mlp input norms
    parallel_dual_ln: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(
                self, "head_dim",
                self.hidden_size // self.num_attention_heads)

    @classmethod
    def from_hf_config(cls, cfg: dict) -> "ModelConfig":
        model_type = cfg.get("model_type", "llama")
        if model_type == "gpt2":
            return cls(
                arch="gpt2",
                vocab_size=cfg["vocab_size"],
                hidden_size=cfg["n_embd"],
                intermediate_size=cfg.get("n_inner") or 4 * cfg["n_embd"],
                num_hidden_layers=cfg["n_layer"],
                num_attention_heads=cfg["n_head"],
                num_key_value_heads=cfg["n_head"],
                max_position_embeddings=cfg.get("n_positions", 1024),
                rms_norm_eps=cfg.get("layer_norm_epsilon", 1e-5),
                tie_word_embeddings=True,
            )
        if model_type == "gpt_neox":
            return cls(
                arch="gpt_neox",
                vocab_size=cfg["vocab_size"],
                hidden_size=cfg["hidden_size"],
                intermediate_size=cfg["intermediate_size"],
                num_hidden_layers=cfg["num_hidden_layers"],
                num_attention_heads=cfg["num_attention_heads"],
                num_key_value_heads=cfg["num_attention_heads"],
                max_position_embeddings=cfg.get(
                    "max_position_embeddings", 2048),
                rms_norm_eps=cfg.get("layer_norm_eps", 1e-5),
                rope_theta=cfg.get("rotary_emb_base", 10000.0),
                rotary_pct=cfg.get("rotary_pct", 0.25),
                use_parallel_residual=cfg.get("use_parallel_residual",
                                              True),
                tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            )
        if model_type == "gptj":
            D = cfg["n_embd"]
            hd = D // cfg["n_head"]
            return cls(
                arch="gptj",
                vocab_size=cfg["vocab_size"],
                hidden_size=D,
                intermediate_size=cfg.get("n_inner") or 4 * D,
                num_hidden_layers=cfg["n_layer"],
                num_attention_heads=cfg["n_head"],
                num_key_value_heads=cfg["n_head"],
                max_position_embeddings=cfg.get("n_positions", 2048),
                rms_norm_eps=cfg.get("layer_norm_epsilon", 1e-5),
                rotary_pct=cfg.get("rotary_dim", hd) / hd,
                tie_word_embeddings=False,
            )
        if model_type == "phi":
            return cls(
                arch="phi",
                vocab_size=cfg["vocab_size"],
                hidden_size=cfg["hidden_size"],
                intermediate_size=cfg["intermediate_size"],
                num_hidden_layers=cfg["num_hidden_layers"],
                num_attention_heads=cfg["num_attention_heads"],
                num_key_value_heads=cfg.get(
                    "num_key_value_heads",
                    cfg["num_attention_heads"]) or
                cfg["num_attention_heads"],
                max_position_embeddings=cfg.get(
                    "max_position_embeddings", 2048),
                rms_norm_eps=cfg.get("layer_norm_eps", 1e-5),
                rope_theta=cfg.get("rope_theta", 10000.0),
                rotary_pct=cfg.get("partial_rotary_factor", 0.5),
                tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            )
        if model_type in ("falcon", "RefinedWeb", "RefinedWebModel"):
            D = cfg.get("hidden_size", cfg.get("d_model"))
            H = cfg.get("num_attention_heads", cfg.get("n_head"))
            # falcon-40B/180B "new decoder": GQA (num_kv_heads) + parallel
            # residual off dual input norms (HF FalconDecoderLayer)
            new_arch = cfg.get("new_decoder_architecture", False)
            if new_arch:
                kv = cfg.get("num_kv_heads") or H
            else:
                kv = 1 if cfg.get("multi_query", True) else H
            return cls(
                arch="falcon",
                vocab_size=cfg["vocab_size"],
                hidden_size=D,
                intermediate_size=cfg.get("ffn_hidden_size", 4 * D),
                num_hidden_layers=cfg.get("num_hidden_layers",
                                          cfg.get("n_layer")),
                num_attention_heads=H,
                num_key_value_heads=kv,
                max_position_embeddings=cfg.get(
                    "max_position_embeddings", 2048),
                rms_norm_eps=cfg.get("layer_norm_epsilon", 1e-5),
                rope_theta=cfg.get("rope_theta", 10000.0),
                use_parallel_residual=(cfg.get("parallel_attn", True)
                                       or new_arch),
                parallel_dual_ln=new_arch,
                tie_word_embeddings=True,
            )
        if model_type == "opt":
            if not cfg.get("do_layer_norm_before", True):
                raise ValueError(
                    "post-LayerNorm OPT (opt-350m) is not supported")
            if cfg.get("word_embed_proj_dim",
                       cfg["hidden_size"]) != cfg["hidden_size"]:
                raise ValueError("OPT word_embed_proj_dim != hidden_size "
                                 "is not supported")
            return cls(
                arch="opt",
                vocab_size=cfg["vocab_size"],
                hidden_size=cfg["hidden_size"],
                intermediate_size=cfg["ffn_dim"],
                num_hidden_layers=cfg["num_hidden_layers"],
                num_attention_heads=cfg["num_attention_heads"],
                num_key_value_heads=cfg["num_attention_heads"],
                max_position_embeddings=cfg.get(
                    "max_position_embeddings", 2048),
                rms_norm_eps=1e-5,
                tie_word_embeddings=True,
            )
        if model_type == "qwen":
            # legacy QWen-1 (trust_remote_code): fused biased attn.c_attn,
            # w1*silu(w2)->c_proj MLP with HF intermediate_size stored
            # PRE-halving (QWenMLP projects to intermediate_size // 2)
            return cls(
                arch="qwen",
                vocab_size=cfg["vocab_size"],
                hidden_size=cfg["hidden_size"],
                intermediate_size=cfg["intermediate_size"] // 2,
                num_hidden_layers=cfg["num_hidden_layers"],
                num_attention_heads=cfg["num_attention_heads"],
                num_key_value_heads=cfg["num_attention_heads"],
                head_dim=cfg.get("kv_channels"),
                max_position_embeddings=cfg.get("seq_length", 2048),
                rms_norm_eps=cfg.get("layer_norm_epsilon", 1e-6),
                rope_theta=cfg.get("rotary_emb_base", 10000.0),
                attention_bias=True,
                tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            )
        if model_type in ("baichuan", "baichuan2"):
            # rope variants (7B); the 13B alibi variant is not supported
            return cls(
                arch="baichuan",
                vocab_size=cfg["vocab_size"],
                hidden_size=cfg["hidden_size"],
                intermediate_size=cfg["intermediate_size"],
                num_hidden_layers=cfg["num_hidden_layers"],
                num_attention_heads=cfg["num_attention_heads"],
                num_key_value_heads=cfg.get("num_key_value_heads",
                                            cfg["num_attention_heads"]),
                max_position_embeddings=cfg.get(
                    "max_position_embeddings",
                    cfg.get("model_max_length", 4096)),
                rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
                rope_theta=cfg.get("rope_theta", 10000.0),
                tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            )
        known = {"llama", "llama2", "llama3", "mistral", "mixtral", "yi",
                 "qwen2", "baichuan", "baichuan2"}
        if model_type not in known:
            # pattern-based degradation (the reference's "for-all"
            # genericity, constants.py:19-24 + utils.py:76-120): treat an
            # unknown llama-shaped config as llama, resolving dimension
            # keys across the common HF aliases, and WARN — quality/parity
            # is best-effort (the forward uses llama semantics: RMSNorm,
            # full RoPE, SwiGLU)
            import logging

            def pick(*names, default=None, required=False):
                for n in names:
                    if n in cfg:
                        return cfg[n]
                if required:
                    raise KeyError(
                        f"unknown model_type {model_type!r}: none of "
                        f"{names} in config — add a family branch "
                        "(docs/adding_a_family.md)")
                return default
            D = pick("hidden_size", "n_embd", "d_model", required=True)
            heads = pick("num_attention_heads", "n_head", "n_heads",
                         required=True)
            logging.getLogger(__name__).warning(
                "model_type %r is not in the supported-family registry; "
                "falling back to llama-pattern import (RMSNorm + RoPE + "
                "SwiGLU forward). Verify perplexity before deploying; "
                "see docs/adding_a_family.md for an exact port.",
                model_type)
            return cls(
                arch="llama",
                vocab_size=pick("vocab_size", required=True),
                hidden_size=D,
                intermediate_size=pick(
                    "intermediate_size", "n_inner", "ffn_hidden_size",
                    "ffn_dim", default=4 * D),
                num_hidden_layers=pick("num_hidden_layers", "n_layer",
                                       "num_layers", "n_layers",
                                       required=True),
                num_attention_heads=heads,
                num_key_value_heads=pick("num_key_value_heads",
                                         "num_kv_heads", "n_kv_heads",
                                         default=heads),
                head_dim=cfg.get("head_dim"),
                max_position_embeddings=pick(
                    "max_position_embeddings", "n_positions",
                    "max_sequence_length", default=2048),
                rms_norm_eps=pick("rms_norm_eps", "layer_norm_eps",
                                  "layer_norm_epsilon", default=1e-5),
                rope_theta=cfg.get("rope_theta", 10000.0),
                tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            )
        arch = "mixtral" if model_type == "mixtral" else "llama"
        return cls(
            arch=arch,
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            num_key_value_heads=cfg.get("num_key_value_heads",
                                        cfg["num_attention_heads"]),
            head_dim=cfg.get("head_dim"),
            max_position_embeddings=cfg.get("max_position_embeddings", 2048),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
            rope_theta=cfg.get("rope_theta", 10000.0),
            attention_bias=cfg.get("attention_bias",
                                   model_type == "qwen2"),
            tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            num_local_experts=cfg.get("num_local_experts", 0),
            num_experts_per_tok=cfg.get("num_experts_per_tok", 2),
        )

    @classmethod
    def from_pretrained_dir(cls, path: str) -> "ModelConfig":
        with open(os.path.join(path, "config.json")) as f:
            return cls.from_hf_config(json.load(f))


# small configs for tests/benchmarks
def tiny_config(**kw) -> ModelConfig:
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=128)
    base.update(kw)
    return ModelConfig(**base)


def llama2_7b_config() -> ModelConfig:
    return ModelConfig(hidden_size=4096, intermediate_size=11008,
                       num_hidden_layers=32, num_attention_heads=32,
                       num_key_value_heads=32, vocab_size=32000,
                       max_position_embeddings=4096)


def llama2_70b_config() -> ModelConfig:
    return ModelConfig(hidden_size=8192, intermediate_size=28672,
                       num_hidden_layers=80, num_attention_heads=64,
                       num_key_value_heads=8, vocab_size=32000,
                       max_position_embeddings=4096)


def mixtral_8x7b_config() -> ModelConfig:
    return ModelConfig(arch="mixtral", hidden_size=4096,
                       intermediate_size=14336, num_hidden_layers=32,
                       num_attention_heads=32, num_key_value_heads=8,
                       vocab_size=32000, max_position_embeddings=32768,
                       rope_theta=1e6, num_local_experts=8,
                       num_experts_per_tok=2)
