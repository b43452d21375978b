"""A model of any family with random codes, built on the device from a
seeded ``torch.Generator`` — the port's counterpart of
``random_quantized_model`` / ``_fast_random_llama`` in
``quip_for_all_tpu/utils/random_quantized.py`` (which builds llama and
Mixtral only), for benchmarks and chip checks without downloadable
checkpoints. Shapes and compute paths equal a really-quantized model's;
only the code values are random.

Families: llama, Mixtral and Baichuan (``W_pack`` in place of q/k/v); and
GPT-2, GPT-NeoX, OPT, Falcon, Phi, GPT-J and QWen, built from their
skeletons (``models/tree.py``): every linear of the quantizer's sublayer
groups (``quantize/quantizer.py``) quantized, the members of a group
sharing the left transform and SU (as the quantizer's shared group
transforms guarantee), a random bias where the family's JAX
``init_*_params`` has one, LayerNorms of ones and zeros, tables dense. An
untied head (GPT-NeoX's ``embed_out``, Phi's, GPT-J's and QWen's
``lm_head``) is quantized under the JAX rule (``quantize_head`` and the
vocabulary a multiple of 128), else dense.

Every codebook (E8P12, E8P12RVQ4B, E8P12RVQ3B, D4, HI), in the runtime
layout ``layout`` (None or "nibble"; "u3" for E8P12; "pb" and "paired" for
E8P12RVQ4B; "bfp", "sw2" and "sw4" for all: ``ops/qtensor.py``). The
row-pair u3/pb layouts take llama only: the MoE kernel decodes nibble
experts, and Mixtral's paired, bfp and sw experts re-lay to nibble when
they stack.

A Mixtral model comes back with each layer's experts already stacked
(``experts_stacked``): a layer's per-expert planes are stacked and dropped
before the next layer is built, so the card never holds both copies of
the experts (about 22.5 GB each at 8x7B).

It does not reproduce the JAX package's bits (the generators differ); tests
carry JAX weights across with ``utils/convert.py`` instead. One deliberate
difference: every code is a real E8P12 codeword (uniform random 16-bit
codes looked up in the code -> word or code -> (u, parity) table), so every
nibble is <= 11, every u <= 5 and the parity is shared per group, and the
u3/pb/paired planes are packed from those codes on the device. The JAX version
masks random bits with 0x6DB6DB | 0x1000000 in the nibble layout (nibbles
up to 13, no shared parity) and fills u3/pb planes with random bits (u up
to 7) and paired planes with random bits under masks (u0 up to 3).
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from ..codebooks import get_codebook
from ..models.config import ModelConfig
from ..models.llama import LLAMA_ARCHS, DenseLinear, LlamaModel
from ..models.registry import get_arch
from ..models.tree import (FamilyModel, NormSpec, TableSpec, get_path,
                           map_skeleton, set_path)
from ..nn.qlinear import QuantLinear
from ..nn.qmoe import stack_experts
from ..quantize.quantizer import sublayer_groups
from ..ops.qtensor import (ROWPAIR_LAYOUTS, QuantizedTensor, affine_word_table,
                           e8p_uv_table, e8p_word_table,
                           paired_planes_from_uv, pb_planes_from_uv, relayout,
                           resolve_layout, u3_planes_from_up)
from ..transforms.incoherence import HadSpec, get_hadK
from .device import resolve_device


def _random_codes(q_out: int, G: int, generator: torch.Generator, device):
    return torch.randint(0, 1 << 16, (q_out, G), generator=generator,
                         device=device)


def random_e8p_planes(q_out: int, q_in: int, generator: torch.Generator,
                      device) -> torch.Tensor:
    """(q_out, Gp) int32 word plane of uniform random E8P12 codewords,
    pad columns zero."""
    G = q_in // 8
    Gp = -(-G // 128) * 128
    table = torch.as_tensor(e8p_word_table(), device=device)
    codes = _random_codes(q_out, G, generator, device)
    return F.pad(table[codes], (0, Gp - G))


def _random_affine_planes(cb_id: str, q_out: int, q_in: int,
                          generator: torch.Generator, device
                          ) -> Dict[str, torch.Tensor]:
    """The nibble word planes of uniform random D4, HI or E8P12RVQ3B codes
    (each code a table lookup on the device), pad columns zero."""
    G = q_in // 8
    Gp = -(-G // 128) * 128
    if cb_id == "HI":           # every nibble is a code
        w = torch.randint(-2 ** 31, 2 ** 31 - 1, (q_out, G),
                          generator=generator, device=device,
                          dtype=torch.int64).to(torch.int32)
        return {"w0": F.pad(w, (0, Gp - G))}
    if cb_id == "D4":           # two 4-weight codes a word
        t = torch.as_tensor(affine_word_table("D4"), device=device)
        c = torch.randint(0, 256, (q_out, G, 2), generator=generator,
                          device=device)
        w = (t[c[..., 0]].to(torch.int64) | (t[c[..., 1]].to(torch.int64)
                                            << 16))
        return {"w0": F.pad(torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(
            torch.int32), (0, Gp - G))}
    t = torch.as_tensor(affine_word_table("E8P12RVQ3B"), device=device)
    c = torch.randint(0, 256, (q_out, G), generator=generator, device=device)
    return {"w0": random_e8p_planes(q_out, q_in, generator, device),
            "w1": F.pad(t[c], (0, Gp - G))}


def _random_uv(q_out: int, G: int, generator: torch.Generator, device):
    """(u (q_out, G, 8) uint8, parity (q_out, G) uint8) of uniform random
    E8P12 codewords."""
    tu, tp = (torch.as_tensor(t, device=device) for t in e8p_uv_table())
    codes = _random_codes(q_out, G, generator, device)
    return tu[codes], tp[codes]


def random_qtensor(codebook: str, layout: str, q_out: int, q_in: int,
                   generator: torch.Generator, device) -> QuantizedTensor:
    """Planes of uniform random codewords of ``codebook`` in ``layout``
    (``resolve_layout``), packed on ``device``."""
    cb = get_codebook(codebook)
    layout = resolve_layout(cb.id, layout, q_out)
    G = q_in // 8
    ors = float(cb.opt_resid_scale)
    if layout == "u3":
        planes = u3_planes_from_up(*_random_uv(q_out, G, generator, device),
                                   q_out, G)
    elif layout in ("pb", "paired"):
        u0, p0 = _random_uv(q_out, G, generator, device)
        u1, p1 = _random_uv(q_out, G, generator, device)
        pack = pb_planes_from_uv if layout == "pb" else paired_planes_from_uv
        planes = pack(u0, p0, u1, p1, q_out, G)
    elif cb.id in ("D4", "HI", "E8P12RVQ3B"):
        planes = _random_affine_planes(cb.id, q_out, q_in, generator, device)
        return relayout(QuantizedTensor(planes, cb.id, q_out, q_in, ors),
                        layout)
    else:
        # nibble words, re-laid as bfp / sw on the device
        planes = {f"w{s}": random_e8p_planes(q_out, q_in, generator, device)
                  for s in range(1 if cb.id == "E8P12" else 2)}
        return relayout(QuantizedTensor(planes, cb.id, q_out, q_in, ors),
                        layout)
    return QuantizedTensor(planes, cb.id, q_out, q_in, ors, layout)


def random_quantized_model(cfg: ModelConfig, codebook: str = "E8P12",
                           seed: int = 0, dtype=torch.bfloat16,
                           quantize_head: bool = False, device="cuda",
                           layout=None):
    """Every block linear quantized (embeddings and the MoE router gate
    stay dense); q/k/v, gate/up and each expert's w1/w3 share their left
    transform and SU, as the quantizer's shared group transforms
    guarantee, so ``fuse_for_inference`` fuses them and the experts
    stack. A ``LlamaModel`` for llama, Mixtral and Baichuan, else the
    family's ``FamilyModel`` (the module docstring)."""
    get_codebook(codebook)                  # refuses an unknown codebook
    if cfg.arch == "mixtral" and resolve_layout(codebook, layout, 2) in \
            ROWPAIR_LAYOUTS:
        raise NotImplementedError(
            f"Mixtral in the {layout} layout: the MoE kernel takes nibble "
            "experts, and u3/pb experts do not convert when they stack")
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

    def qlin(in_f, out_f, lspec: HadSpec, SU, bias=None) -> QuantLinear:
        rspec = spec(out_f)
        qt = random_qtensor(codebook, layout, rspec.padN, lspec.padN, gen,
                            dev)
        return QuantLinear(
            qt, in_features=in_f, out_features=out_f, q_in=lspec.padN,
            q_out=rspec.padN, K_left=lspec.K, K_right=rspec.K, SU=SU,
            SV=signs(out_f), bias=bias, had_left=lspec.hadK,
            had_right=rspec.hadK, wscale_float=float(1.0 / (in_f ** 0.5)))

    def dense(out_f, in_f):
        return torch.randn((out_f, in_f), generator=gen,
                           device=dev).mul_(0.02).to(dtype)

    if cfg.arch not in LLAMA_ARCHS:
        return _random_family(cfg, qlin, spec, signs, dense, head_q, gen,
                              dtype, dev)

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
            "self_attn": ({
                "W_pack": qlin(D, (H + 2 * KV) * hd, qkv_spec, qkv_su),
            } if cfg.arch == "baichuan" else {
                "q_proj": qlin(D, H * hd, qkv_spec, qkv_su),
                "k_proj": qlin(D, KV * hd, qkv_spec, qkv_su),
                "v_proj": qlin(D, KV * hd, qkv_spec, qkv_su),
            }),
        }
        blk["self_attn"]["o_proj"] = qlin(H * hd, D, o_spec, signs(H * hd))
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


def _random_family(cfg: ModelConfig, qlin, spec, signs, dense, head_q,
                   gen: torch.Generator, dtype, dev) -> FamilyModel:
    """A family of ``models/tree.py`` from its skeleton: per layer, per
    sublayer group in the quantizer's order, one left transform and SU
    drawn, then each member's planes, right transform, SV and bias."""
    def bias(n):
        return torch.randn(n, generator=gen, device=dev).mul_(0.02).to(dtype)

    def leaf(path, s):
        if isinstance(s, TableSpec):
            return {"weight": dense(s.rows, s.cols)}
        if isinstance(s, NormSpec):
            return {"weight": torch.ones(s.n, dtype=dtype, device=dev),
                    "bias": (torch.zeros(s.n, dtype=dtype, device=dev)
                             if s.bias else None)}
        return s                 # a LinearSpec: filled in below
    tree = map_skeleton(get_arch(cfg).param_skeleton(cfg), leaf)
    for blk in tree["layers"]:
        for g in sublayer_groups(cfg):
            in_f = get_path(blk, g["layers"][0]).in_f
            lspec, su = spec(in_f), signs(in_f)
            for path in g["layers"]:
                s = get_path(blk, path)
                set_path(blk, path, qlin(in_f, s.out_f, lspec, su,
                                         bias(s.out_f) if s.bias else None))
    key = "embed_out" if cfg.arch == "gpt_neox" else "lm_head"
    if key in tree:
        s = tree[key]
        b = bias(s.out_f) if s.bias else None
        tree[key] = (qlin(s.in_f, s.out_f, spec(s.in_f), signs(s.in_f), b)
                     if head_q else DenseLinear(dense(s.out_f, s.in_f), b))
    return FamilyModel.from_tree(cfg, tree)
