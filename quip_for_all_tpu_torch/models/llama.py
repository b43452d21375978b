"""Llama-family decoder (llama, Mixtral and Baichuan, whose fused qkv is
``W_pack``) in PyTorch — counterpart of ``quip_for_all_tpu/models/llama.py``.

The model is an ``nn.Module`` whose tree mirrors the JAX param dict:
``embed_tokens``, ``layers[i]`` (an ``nn.ModuleDict`` with
``input_layernorm``, ``self_attn``, ``post_attention_layernorm`` and
``mlp``, or for Mixtral ``block_sparse_moe``: a dense ``gate`` plus
``experts`` or, once stacked, ``experts_stacked``), ``norm`` and
``lm_head``. Linear leaves are ``QuantLinear``, ``FusedQuantLinear`` (after
``fuse_for_inference``), ``StackedQuantLinear``, ``DenseLinear`` or
``LoraLinear`` (``nn/lora.py``: one of the others plus its adapters, which
``fuse_for_inference`` leaves unfused). Forward functions keep the JAX
names and argument order so a reader can follow both side by side; without
caches ``model_apply`` is differentiable (a LoRA step, a finetune).

Activation capture: ``block_apply(..., capture=True)`` also returns the
input of every linear sub-layer group under the JAX package's keys (qkv,
o, gateup, down; Mixtral's moe_input, moe_routing and expert{e}_down),
which the quantizer accumulates into Hessians. ``init_llama_params`` makes
the dense float model from the JAX package's numpy draws.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.lora import LoraLinear, lora_apply
from ..nn.qlinear import (FusedQuantLinear, QuantLinear, fuse_qlinears,
                         same_tensor)
from ..nn.qmoe import (StackedQuantLinear, moe_sparse_apply, stack_experts,
                       unstack_qlinear)
from .common import attn_bucket, kv_len, sdpa_cache_layout, write_kv
from .config import ModelConfig


# the configs this module runs (the others: models/registry.py)
LLAMA_ARCHS = ("llama", "mixtral", "baichuan")


# --------------------------------------------------------------- modules

class Weight(nn.Module):
    """A lone weight (norm scale or embedding table)."""

    def __init__(self, weight: torch.Tensor):
        super().__init__()
        self.register_buffer("weight", weight)


class DenseLinear(nn.Module):
    """Unquantized linear, HF (out, in) weight convention."""

    def __init__(self, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("weight", weight)
        self.register_buffer("bias", bias)


class LlamaModel(nn.Module):
    """The model's weights; ``model_apply(cfg, model, ids, ...)`` runs it."""

    def __init__(self, embed_tokens: torch.Tensor, layers: List[nn.Module],
                 norm: torch.Tensor, lm_head: Optional[nn.Module] = None):
        super().__init__()
        self.embed_tokens = Weight(embed_tokens)
        self.layers = nn.ModuleList(layers)
        self.norm = Weight(norm)
        self.lm_head = lm_head

    @classmethod
    def from_tree(cls, tree: Dict[str, Any]) -> "LlamaModel":
        """Build from a JAX-shaped dict tree whose leaves are tensors or
        already-built linear modules; a {"lora_base", "lora_A", "lora_B",
        "lora_scale"} node becomes a ``LoraLinear``."""
        def lin(node):
            if isinstance(node, nn.Module):
                return node
            if "lora_base" in node:
                return LoraLinear(lin(node["lora_base"]), node["lora_A"],
                                  node["lora_B"], node["lora_scale"])
            return DenseLinear(node["weight"], node.get("bias"))

        def moe(m):
            out = {"gate": lin(m["gate"])}
            if "experts_stacked" in m:
                out["experts_stacked"] = nn.ModuleDict(m["experts_stacked"])
            else:
                out["experts"] = nn.ModuleList([
                    nn.ModuleDict({k: lin(v) for k, v in e.items()})
                    for e in m["experts"]])
            return nn.ModuleDict(out)

        def block(b):
            mods = {
                "input_layernorm": Weight(b["input_layernorm"]["weight"]),
                "post_attention_layernorm":
                    Weight(b["post_attention_layernorm"]["weight"]),
                "self_attn": nn.ModuleDict(
                    {k: lin(v) for k, v in b["self_attn"].items()}),
            }
            if "block_sparse_moe" in b:
                mods["block_sparse_moe"] = moe(b["block_sparse_moe"])
            else:
                mods["mlp"] = nn.ModuleDict(
                    {k: lin(v) for k, v in b["mlp"].items()})
            return nn.ModuleDict(mods)
        head = tree.get("lm_head")
        return cls(tree["embed_tokens"]["weight"],
                   [block(b) for b in tree["layers"]],
                   tree["norm"]["weight"],
                   None if head is None else lin(head))


# --------------------------------------------------------------- primitives

def linear_apply(lin: nn.Module, x: torch.Tensor, **kw) -> torch.Tensor:
    if isinstance(lin, QuantLinear):
        return lin(x, **kw)
    if isinstance(lin, LoraLinear):
        return lora_apply(lin, x, **kw)
    # products of x-dtype values, summed in f32, rounded back to x's dtype
    w = lin.weight.to(x.dtype).to(torch.float32)
    y = torch.matmul(x.to(torch.float32), w.T).to(x.dtype)
    if lin.bias is not None:
        y = y + lin.bias.to(y.dtype)
    return y


def rms_norm(weight: torch.Tensor, x: torch.Tensor, eps: float
             ) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return xf.to(dt) * weight.to(dt)


@lru_cache(maxsize=16)
def _inv_freq(d: int, theta: float, device: torch.device) -> torch.Tensor:
    """Cached per device, so a decode step makes no host-to-device copy
    (and can be captured in a CUDA graph)."""
    inv = 1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float32) / d))
    return torch.as_tensor(inv.astype(np.float32), device=device)


def rope_tables(cfg: ModelConfig, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF llama rotary tables: (…, head_dim) cos/sin, half-split layout."""
    inv = _inv_freq(cfg.head_dim, cfg.rope_theta, positions.device)
    ang = positions[..., None].to(torch.float32) * inv
    emb = torch.cat([ang, ang], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(q, k, cos, sin):
    # q,k: (B, S, H, D); cos/sin: (B, S, D)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    q = q * cos.to(q.dtype) + _rotate_half(q) * sin.to(q.dtype)
    k = k * cos.to(k.dtype) + _rotate_half(k) * sin.to(k.dtype)
    return q, k


# --------------------------------------------------------------- blocks

def runtime_window(cache_position, S: int, T: int) -> Optional[int]:
    """The JAX package's runtime bucket ``lax.switch`` (its attention,
    taken without a static window at S == 1 and T >= 512), picked on the
    host: the smallest of 256, 512, ... (capped at T) that covers the
    write. A tensor position is not read back, so the whole cache is read
    (None): masked slots give exact zeros, so the values are the same."""
    if not (isinstance(cache_position, int) and S == 1 and T >= 512):
        return None
    return attn_bucket(cache_position + 1, T)


def attention(cfg: ModelConfig, attn_p: nn.ModuleDict, x: torch.Tensor,
              cos, sin, kv_cache: Optional[tuple],
              cache_position, attn_mask: torch.Tensor,
              linear_kw: dict, attn_window: Optional[int] = None,
              captures: Optional[dict] = None):
    B, S, D = x.shape
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    if captures is not None:
        captures["qkv"] = x
    if "qkv_proj" in attn_p:   # fused single-launch qkv (inference)
        q, k, v = attn_p["qkv_proj"](x, **linear_kw)
    elif "W_pack" in attn_p:   # baichuan fused qkv (rows [q; k; v])
        qkv = linear_apply(attn_p["W_pack"], x, **linear_kw)
        q, k, v = torch.split(qkv, [H * hd, KV * hd, KV * hd], dim=-1)
    else:
        q = linear_apply(attn_p["q_proj"], x, **linear_kw)
        k = linear_apply(attn_p["k_proj"], x, **linear_kw)
        v = linear_apply(attn_p["v_proj"], x, **linear_kw)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    q, k = apply_rope(q, k, cos, sin)
    if kv_cache is not None:
        # either cache kind (bf16 or QuantKVCache), any position kind
        ck, cv = kv_cache
        k = write_kv(ck, k, cache_position)
        v = write_kv(cv, v, cache_position)
        new_cache = (k, v)
        if attn_window is None:
            attn_window = runtime_window(cache_position, S, kv_len(k))
    else:
        new_cache, attn_window = None, None
    ctx = sdpa_cache_layout(q, k, v, attn_mask, x.dtype, attn_window)
    if captures is not None:
        captures["o"] = ctx
    return linear_apply(attn_p["o_proj"], ctx, **linear_kw), new_cache


def mlp_apply(mlp_p: nn.ModuleDict, x: torch.Tensor, linear_kw: dict,
              captures: Optional[dict] = None) -> torch.Tensor:
    if captures is not None:
        captures["gateup"] = x
    if "gateup_proj" in mlp_p:   # fused single-launch gate/up (inference)
        g, u = mlp_p["gateup_proj"](x, **linear_kw)
    else:
        g = linear_apply(mlp_p["gate_proj"], x, **linear_kw)
        u = linear_apply(mlp_p["up_proj"], x, **linear_kw)
    h = F.silu(g) * u
    if captures is not None:
        captures["down"] = h
    return linear_apply(mlp_p["down_proj"], h, **linear_kw)


def moe_apply(cfg: ModelConfig, moe_p: nn.ModuleDict, x: torch.Tensor,
              linear_kw: dict, captures: Optional[dict] = None
              ) -> torch.Tensor:
    """Mixtral top-k MoE. Two formulations (``nn/qmoe.py``):
      - stacked sparse (decode, B*S < 32 tokens): the expert-indexed
        kernel reads only the selected experts' planes;
      - per-expert dense masked loop (prefill, or experts not stacked):
        every expert on every token, each through the fused kernel.
    A capture (``captures``) takes the unstacked experts' loop."""
    B, S, D = x.shape
    router_logits = linear_apply(moe_p["gate"], x, **linear_kw)  # (B,S,E)
    if "experts_stacked" in moe_p and captures is not None:
        raise ValueError("capture runs on unstacked experts")
    if "experts_stacked" in moe_p:
        st = moe_p["experts_stacked"]
        if B * S < 32:
            return moe_sparse_apply(
                cfg, moe_p, x, router_logits,
                compute_dtype=linear_kw.get("compute_dtype", torch.bfloat16),
                matmul_impl=linear_kw.get("matmul_impl", "auto"))
        experts = []
        for e in range(cfg.num_local_experts):
            w1, w3 = unstack_qlinear(st["w13"], e)
            w2, = unstack_qlinear(st["w2"], e)
            experts.append({"w1": w1, "w3": w3, "w2": w2})
    else:
        experts = moe_p["experts"]
    E, K = cfg.num_local_experts, cfg.num_experts_per_tok
    topv, topi = torch.topk(router_logits.to(torch.float32), K, dim=-1)
    topw = torch.softmax(topv, dim=-1)                          # (B,S,K)
    routing = torch.sum(F.one_hot(topi, E).to(torch.float32)
                        * topw[..., None], dim=2)              # (B,S,E)
    if captures is not None:
        captures["moe_routing"] = routing
        captures["moe_input"] = x
    out = torch.zeros_like(x)
    for e in range(E):
        ep = experts[e]
        w = routing[..., e][..., None].to(x.dtype)
        h = (F.silu(linear_apply(ep["w1"], x, **linear_kw))
             * linear_apply(ep["w3"], x, **linear_kw))
        if captures is not None:
            captures[f"expert{e}_down"] = h * (routing[..., e][..., None]
                                               > 0)
        out = out + w * linear_apply(ep["w2"], h, **linear_kw)
    return out


def block_apply(cfg: ModelConfig, blk: nn.ModuleDict, x: torch.Tensor,
                cos, sin, kv_cache=None, cache_position=None, attn_mask=None,
                linear_kw: Optional[dict] = None,
                attn_window: Optional[int] = None, capture: bool = False):
    """(x, new_cache), or with ``capture`` (x, new_cache, captures)."""
    linear_kw = linear_kw or {}
    captures: Optional[dict] = {} if capture else None
    h = rms_norm(blk["input_layernorm"].weight, x, cfg.rms_norm_eps)
    attn_out, new_cache = attention(cfg, blk["self_attn"], h, cos, sin,
                                    kv_cache, cache_position, attn_mask,
                                    linear_kw, attn_window, captures)
    x = x + attn_out
    h = rms_norm(blk["post_attention_layernorm"].weight, x, cfg.rms_norm_eps)
    if cfg.arch == "mixtral":
        y = moe_apply(cfg, blk["block_sparse_moe"], h, linear_kw, captures)
    else:
        y = mlp_apply(blk["mlp"], h, linear_kw, captures)
    if capture:
        return x + y, new_cache, captures
    return x + y, new_cache


def model_apply(cfg: ModelConfig, model: LlamaModel,
                input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                kv_caches: Optional[list] = None,
                cache_position: Optional[int] = None,
                attn_mask: Optional[torch.Tensor] = None,
                linear_kw: Optional[dict] = None,
                dtype=torch.float32,
                attn_window: Optional[int] = None):
    """Full forward. input_ids (B, S) -> (logits (B, S, V), caches).

    With kv_caches (per layer (k, v), each a (B, S_max, KV, hd) tensor or
    a ``QuantKVCache``) runs incremental decoding, writing at
    cache_position: a host int, a 0-d tensor or a (B,) tensor of per-row
    starts (``models/common.py``); attn_window (static) promises every
    query position is < attn_window. Nothing here reads a tensor back to
    the host, so a decode step can be captured in a CUDA graph."""
    if cfg.arch not in LLAMA_ARCHS:
        raise ValueError(f"arch {cfg.arch!r} runs through its own module "
                         "(models/registry.py get_arch)")
    B, S = input_ids.shape
    dev = input_ids.device
    x = F.embedding(input_ids, model.embed_tokens.weight).to(dtype)
    if positions is None:
        positions = torch.arange(S, device=dev)[None, :].repeat(B, 1)
    cos, sin = rope_tables(cfg, positions)
    if attn_mask is None:
        attn_mask = (causal_mask(S, S, dev) if kv_caches is None
                     else cache_mask(positions, kv_len(kv_caches[0][0])))
    new_caches = [] if kv_caches is not None else None
    for i, blk in enumerate(model.layers):
        cache_i = kv_caches[i] if kv_caches is not None else None
        x, nc = block_apply(cfg, blk, x, cos, sin, cache_i, cache_position,
                            attn_mask, linear_kw, attn_window=attn_window)
        if new_caches is not None:
            new_caches.append(nc)
    x = rms_norm(model.norm.weight, x, cfg.rms_norm_eps)
    if model.lm_head is None:   # tied embeddings
        logits = x @ model.embed_tokens.weight.to(x.dtype).T
    else:
        logits = linear_apply(model.lm_head, x, **(linear_kw or {}))
    return logits, new_caches


def causal_mask(S: int, T: int, device, dtype=torch.float32) -> torch.Tensor:
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    m = torch.where(j <= i + (T - S), 0.0, -1e9).to(dtype)
    return m[None, None, :, :]


def cache_mask(positions: torch.Tensor, T: int, dtype=torch.float32
               ) -> torch.Tensor:
    """Cached decode: the token at position p attends to slots j <= p.
    positions: (B, S) -> (B, 1, S, T)."""
    j = torch.arange(T, device=positions.device)[None, None, :]
    m = torch.where(j <= positions[:, :, None], 0.0, -1e9).to(dtype)
    return m[:, None, :, :]


# --------------------------------------------------------------- fusion

def _sharable(ps) -> bool:
    if not all(isinstance(p, QuantLinear) for p in ps):
        return False
    p0 = ps[0]
    return all(p.q_in == p0.q_in and p.K_left == p0.K_left
               and same_tensor(p.SU, p0.SU)
               and same_tensor(p.had_left, p0.had_left)
               for p in ps[1:])


def fuse_for_inference(cfg: ModelConfig, model: LlamaModel) -> LlamaModel:
    """Fuse qkv and gate/up QuantLinears that share left transforms into
    single-launch FusedQuantLinears, and stack Mixtral's experts (the
    stacked copy replaces the per-expert list in the new model); Baichuan's
    W_pack is one launch already and stays. Returns a new model sharing
    every other submodule with ``model``."""
    if cfg.arch not in LLAMA_ARCHS:
        raise ValueError(f"arch {cfg.arch!r} fuses through its own module "
                         "(models/registry.py get_arch)")
    layers = []
    for src in model.layers:
        attn = dict(src["self_attn"].items())
        trio = [attn.get(k) for k in ("q_proj", "k_proj", "v_proj")]
        if _sharable(trio):
            attn = {"qkv_proj": fuse_qlinears(trio), "o_proj": attn["o_proj"]}
        mods = {"input_layernorm": src["input_layernorm"],
                "post_attention_layernorm": src["post_attention_layernorm"],
                "self_attn": nn.ModuleDict(attn)}
        if cfg.arch == "mixtral":
            moe = src["block_sparse_moe"]
            stacked = stack_experts(moe)
            if stacked is not None:
                moe = nn.ModuleDict({"gate": moe["gate"],
                                     "experts_stacked":
                                         nn.ModuleDict(stacked)})
            mods["block_sparse_moe"] = moe
        else:
            mlp = dict(src["mlp"].items())
            duo = [mlp.get("gate_proj"), mlp.get("up_proj")]
            if _sharable(duo):
                mlp = {"gateup_proj": fuse_qlinears(duo),
                       "down_proj": mlp["down_proj"]}
            mods["mlp"] = nn.ModuleDict(mlp)
        layers.append(nn.ModuleDict(mods))
    return LlamaModel(model.embed_tokens.weight, layers, model.norm.weight,
                      model.lm_head)


def set_ksplit(model: LlamaModel, ksplit: int) -> LlamaModel:
    """Ask every quantized linear of ``model`` (fused, stacked or not) for
    split-K with ``ksplit`` chunks, 0 to turn it off: the port's switch
    for the JAX package's QFA_KSPLIT. It takes effect where the JAX
    package's does (``ops/fused_matmul.py`` ``fused_quant_matmul_pre``):
    nibble planes, padded m <= 32 and more than one chunk by
    ``pick_ksplit``. Returns ``model``, changed in place."""
    for mod in model.modules():
        if isinstance(mod, (QuantLinear, FusedQuantLinear,
                            StackedQuantLinear)):
            mod.ksplit = int(ksplit)
    return model


def set_right_in_kernel(model: LlamaModel, on: bool) -> LlamaModel:
    """Run the right transform's B-side factor in the decode kernels'
    epilogue (on) or after them (off, the default): the port's switch for
    the JAX package's QFA_RIGHT_IN_KERNEL, on every QuantLinear and
    FusedQuantLinear (``nn/qlinear.py``). It takes effect on the fused
    route where ``right_b_factor`` and ``can_fuse_right`` admit the layer's
    right transform; stacked MoE experts take none (the MoE kernels have
    no such epilogue in the JAX package). A CUDA graph captured before the
    change is captured again (``runtime/graphs.py``). Returns ``model``,
    changed in place."""
    for mod in model.modules():
        if isinstance(mod, (QuantLinear, FusedQuantLinear)):
            mod.right_in_kernel = bool(on)
    return model


def set_combine_planes(model: LlamaModel, n: int) -> LlamaModel:
    """The combined residual decode at Pallas blocks of at most ``n`` rows
    (0, the default, turns it off): the port's switch for the JAX
    package's QFA_COMBINE_PLANES, on every QuantLinear and
    FusedQuantLinear. It takes effect where ``combine_applies``
    (``ops/fused_matmul.py``) says: two plane sets (E8P12RVQ4B,
    E8P12RVQ3B) in the nibble or sw layouts, outside split-K. Returns
    ``model``, changed in place."""
    for mod in model.modules():
        if isinstance(mod, (QuantLinear, FusedQuantLinear)):
            mod.combine = int(n)
    return model


# --------------------------------------------------------------- init

def init_llama_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                      device="cuda") -> LlamaModel:
    """The dense float model (HF layout) of the JAX package's
    ``init_llama_params``: the same numpy draws in the same order, so for
    one seed the weights are its own bit for bit, on ``device`` (the card
    unless the caller asks for the CPU)."""
    from ..utils.device import resolve_device
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    D, I = cfg.hidden_size, cfg.intermediate_size
    H, KV, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                 cfg.head_dim)

    def t(a):
        return torch.from_numpy(a).to(device=dev, dtype=dtype)

    def lin(out_f, in_f, bias=False):
        w = (rng.standard_normal((out_f, in_f)) / np.sqrt(in_f)
             ).astype(np.float32)
        return DenseLinear(t(w), t(np.zeros(out_f, np.float32))
                           if bias else None)

    def ones():
        return Weight(t(np.ones(D, np.float32)))

    def block():
        if cfg.arch == "baichuan":
            attn = {"W_pack": lin((H + 2 * KV) * hd, D),
                    "o_proj": lin(D, H * hd)}
        else:
            attn = {"q_proj": lin(H * hd, D, cfg.attention_bias),
                    "k_proj": lin(KV * hd, D, cfg.attention_bias),
                    "v_proj": lin(KV * hd, D, cfg.attention_bias),
                    "o_proj": lin(D, H * hd)}
        mods = {"input_layernorm": ones(), "post_attention_layernorm": ones(),
                "self_attn": nn.ModuleDict(attn)}
        if cfg.arch == "mixtral":
            gate = lin(cfg.num_local_experts, D)
            experts = [nn.ModuleDict({"w1": lin(I, D), "w3": lin(I, D),
                                      "w2": lin(D, I)})
                       for _ in range(cfg.num_local_experts)]
            mods["block_sparse_moe"] = nn.ModuleDict(
                {"gate": gate, "experts": nn.ModuleList(experts)})
        else:
            mods["mlp"] = nn.ModuleDict({"gate_proj": lin(I, D),
                                         "up_proj": lin(I, D),
                                         "down_proj": lin(D, I)})
        return nn.ModuleDict(mods)

    embed = t((rng.standard_normal((cfg.vocab_size, D)) * 0.02
               ).astype(np.float32))
    layers = [block() for _ in range(cfg.num_hidden_layers)]
    head = None if cfg.tie_word_embeddings else lin(cfg.vocab_size, D)
    return LlamaModel(embed, layers, t(np.ones(D, np.float32)), head)
