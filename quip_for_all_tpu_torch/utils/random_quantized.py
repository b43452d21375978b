"""A llama-family or Mixtral E8P12 model with random codes, built on the
device from a seeded ``torch.Generator`` — the port's counterpart of
``random_quantized_model`` / ``_fast_random_llama`` in
``quip_for_all_tpu/utils/random_quantized.py``, for benchmarks and chip
checks without downloadable checkpoints. Shapes and compute paths equal a
really-quantized model's; only the code values are random.

A Mixtral model comes back with each layer's experts already stacked
(``experts_stacked``): a layer's per-expert planes are stacked and dropped
before the next layer is built, so the card never holds both copies of
the experts (about 22.5 GB each at 8x7B).

It does not reproduce the JAX package's bits (the generators differ); tests
carry JAX weights across with ``utils/convert.py`` instead. One deliberate
difference: every word is a real E8P12 codeword (a uniform random 16-bit
code looked up in the code -> word table), so every nibble is <= 11 and the
parity is shared per word. The JAX version masks random bits with 0x6DB6DB
| 0x1000000, which yields nibbles up to 13 and no shared parity.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from ..models.config import ModelConfig
from ..models.llama import DenseLinear, LlamaModel
from ..nn.qlinear import QuantLinear
from ..nn.qmoe import stack_experts
from ..ops.qtensor import QuantizedTensor, e8p_word_table
from ..transforms.incoherence import HadSpec, get_hadK
from .device import resolve_device


def random_e8p_planes(q_out: int, q_in: int, generator: torch.Generator,
                      device) -> torch.Tensor:
    """(q_out, Gp) int32 word plane of uniform random E8P12 codewords,
    pad columns zero."""
    G = q_in // 8
    Gp = -(-G // 128) * 128
    table = torch.as_tensor(e8p_word_table(), device=device)
    codes = torch.randint(0, 1 << 16, (q_out, G), generator=generator,
                          device=device)
    return F.pad(table[codes], (0, Gp - G))


def random_quantized_model(cfg: ModelConfig, codebook: str = "E8P12",
                           seed: int = 0, dtype=torch.bfloat16,
                           quantize_head: bool = False, device="cuda"
                           ) -> LlamaModel:
    """Every block linear quantized (embeddings and the MoE router gate
    stay dense); q/k/v, gate/up and each expert's w1/w3 share their left
    transform and SU, as the quantizer's shared group transforms
    guarantee, so ``fuse_for_inference`` fuses them and the experts
    stack."""
    if codebook != "E8P12":
        raise NotImplementedError(
            f"random {codebook} models wait for ROADMAP.md slice 2")
    if cfg.arch not in ("llama", "mixtral"):
        raise NotImplementedError(f"arch {cfg.arch!r}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    D, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    H, KV, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                 cfg.head_dim)
    head_q = quantize_head and not cfg.tie_word_embeddings and V % 128 == 0

    def signs(n):
        return torch.sign(torch.randn(n, generator=gen, device=dev)).to(dtype)

    def spec(n) -> HadSpec:
        s = get_hadK(n, use_rand=True, generator=gen, device=dev)
        return s if s.hadK is None else HadSpec(s.hadK.to(dtype), s.K,
                                                s.padN)

    def qlin(in_f, out_f, lspec: HadSpec, SU) -> QuantLinear:
        rspec = spec(out_f)
        w0 = random_e8p_planes(rspec.padN, lspec.padN, gen, dev)
        qt = QuantizedTensor({"w0": w0}, "E8P12", rspec.padN, lspec.padN)
        return QuantLinear(
            qt, in_features=in_f, out_features=out_f, q_in=lspec.padN,
            q_out=rspec.padN, K_left=lspec.K, K_right=rspec.K, SU=SU,
            SV=signs(out_f), had_left=lspec.hadK, had_right=rspec.hadK,
            wscale_float=float(1.0 / (in_f ** 0.5)))

    def dense(out_f, in_f):
        return torch.randn((out_f, in_f), generator=gen,
                           device=dev).mul_(0.02).to(dtype)

    def moe():
        experts = []
        for _ in range(cfg.num_local_experts):
            e_spec, e_su = spec(D), signs(D)
            experts.append({"w1": qlin(D, I, e_spec, e_su),
                            "w3": qlin(D, I, e_spec, e_su),
                            "w2": qlin(I, D, spec(I), signs(I))})
        stacked = stack_experts({"experts": experts})
        return {"gate": {"weight": dense(cfg.num_local_experts, D)},
                "experts_stacked": stacked}

    layers: List[Dict] = []
    for _ in range(cfg.num_hidden_layers):
        qkv_spec, qkv_su = spec(D), signs(D)
        if cfg.arch == "mixtral":
            o_spec = spec(H * hd)
        else:   # the llama draw order of the first slice
            mlp_spec, mlp_su = spec(D), signs(D)
            o_spec, down_spec = spec(H * hd), spec(I)
        blk = {
            "input_layernorm": {"weight": torch.ones(D, dtype=dtype,
                                                     device=dev)},
            "post_attention_layernorm": {"weight": torch.ones(
                D, dtype=dtype, device=dev)},
            "self_attn": {
                "q_proj": qlin(D, H * hd, qkv_spec, qkv_su),
                "k_proj": qlin(D, KV * hd, qkv_spec, qkv_su),
                "v_proj": qlin(D, KV * hd, qkv_spec, qkv_su),
                "o_proj": qlin(H * hd, D, o_spec, signs(H * hd)),
            },
        }
        if cfg.arch == "mixtral":
            blk["block_sparse_moe"] = moe()
        else:
            blk["mlp"] = {
                "gate_proj": qlin(D, I, mlp_spec, mlp_su),
                "up_proj": qlin(D, I, mlp_spec, mlp_su),
                "down_proj": qlin(I, D, down_spec, signs(I)),
            }
        layers.append(blk)
    tree = {
        "embed_tokens": {"weight": dense(V, D)},
        "layers": layers,
        "norm": {"weight": torch.ones(D, dtype=dtype, device=dev)},
    }
    if not cfg.tie_word_embeddings:
        if head_q:
            tree["lm_head"] = qlin(D, V, spec(D), signs(D))
        else:
            tree["lm_head"] = DenseLinear(dense(V, D))
    return LlamaModel.from_tree(tree)
