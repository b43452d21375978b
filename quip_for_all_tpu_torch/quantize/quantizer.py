"""QuipQuantizer: whole-model quantization — counterpart of
``quip_for_all_tpu/quantize/quantizer.py``.

The pipeline is the JAX package's:

  1. embed the calibration batches -> the first block's inputs;
  2. per block, one capture pass (``block_apply(capture=True)``)
     accumulates a Hessian for every linear sub-layer group, Mixtral's
     routed experts each their own, and computes the float block's outputs,
     which become the next block's inputs;
  3. per group in order (``sublayer_groups``: qkv -> o -> fc1 -> fc2), LDLQ
     quantization of each linear against the group's Hessian, with one SU
     and left transform shared by a group's linears
     (``share_group_transforms``, which ``fuse_for_inference`` relies on);
     ``merge_suv`` folds shared sign vectors into the producing norms;
  4. an optional block-wise MSE finetune between groups and an end-to-end
     CE finetune at the end (``quantize/finetune.py``);
  5. optionally the output head (``quantize_lm_head``).

The model is the port's ``nn.Module`` (``LlamaModel`` or ``FamilyModel``),
quantized in place on its own device (or ``device=``); the heavy math runs
there, the numpy ``Generator`` (seeded with ``seed``) and the inter-block
activations (fp16 with ``calib_act_fp16``) stay on the host, as in the JAX
package. ``resume_dir`` keeps each finished block (the port's own files:
``torch.save`` of the block and the generator's state, so a resumed run
equals an uninterrupted one bit for bit). ``tp_shards`` > 1 draws
block-diagonal transforms on the dimension tensor parallelism shards (a
column-parallel linear's output, a row-parallel one's input:
``parallel/sharding.py`` ``role_of``), in the JAX package's order of
draws. ``ft_pp`` > 1 pipelines the end-to-end finetune over that many
ranks (``parallel/pipeline.py``): ``quantize_model`` then runs on every
rank of a group of ``ft_pp``, each quantizes the whole model as one rank
would, and each trains its stage's leaves; every rank ends with the whole
finetuned model.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..codebooks import get_codebook
from ..models.config import ModelConfig
from ..models.llama import DenseLinear, LlamaModel, causal_mask
from ..models.registry import model_layers
from ..models.tree import get_path, set_path
from ..utils.device import resolve_device
from . import hessian
from .ldlq import full_f32
from .quip import QuantConfig, pack_to_qlinear, proxy_loss, quantize_layer
from ..parallel.sharding import role_of
from ..transforms.incoherence import get_hadK

logger = logging.getLogger(__name__)


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


def _set_top(model, key: str, value) -> None:
    if isinstance(model, LlamaModel):
        setattr(model, key, value)
    else:
        model[key] = value


def _signs(rng: np.random.Generator, n: int) -> np.ndarray:
    return np.sign(rng.standard_normal(n) + 1e-5).astype(np.float32)


@dataclasses.dataclass
class QuipQuantizer:
    """Constructor knobs of the JAX package's QuipQuantizer (and of its
    reference), with the same defaults."""
    codebook: str
    nsamples: int = 4096
    model_seqlen: int = 2048
    quip_tune_iters: int = 10
    sigma_reg: float = 0.01
    rescale_WH: bool = False
    use_rand: bool = True
    scale_override: float = -1.0
    opt_resid_scale: float = -1.0
    per_channel: bool = False
    batch_size: int = 4
    modules_to_not_convert: Optional[List[str]] = None
    merge_suv: bool = False
    ft_lr: float = 5e-5
    ft_susv_lr: float = 5e-4
    ft_epochs: int = 0
    ft_train_size: int = 384
    ft_valid_size: int = 128
    ft_batch_size: int = 8
    ft_valid_freq: int = 1
    ft_early_stop: int = 3
    ft_pp: int = 1
    ft_microbatches: int = 0
    tp_shards: int = 1
    share_group_transforms: bool = True
    quantize_lm_head: bool = False
    calib_act_fp16: bool = True
    seed: int = 0

    def __post_init__(self):
        self.cb = get_codebook(
            self.codebook,
            self.opt_resid_scale if self.opt_resid_scale > 0 else None)
        if not (0 < self.sigma_reg < 1):
            raise ValueError("sigma_reg must be in (0, 1)")

    # ------------------------------------------------------------ config IO

    def to_dict(self) -> dict:
        """quantization_config.json, the JAX package's schema."""
        return {
            "quant_method": "QUiP",
            "rescale_WH": self.rescale_WH,
            "use_rand": self.use_rand,
            "codebook": self.cb.id,
            "codesz": self.cb.codesz,
            "idx_dtype": f"torch.{self.cb.idx_dtype.name}",
            "merge_suv": self.merge_suv,
            "per_channel": self.per_channel,
            "opt_resid_scale": self.opt_resid_scale,
            "modules_to_not_convert": self.modules_to_not_convert,
            "tp_shards": self.tp_shards,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "QuipQuantizer":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    # ------------------------------------------------------------ pipeline

    def _quant_cfg(self) -> QuantConfig:
        return QuantConfig(
            rescale_WH=self.rescale_WH, sigma_reg=self.sigma_reg,
            scale_override=self.scale_override, use_rand=self.use_rand,
            per_channel=self.per_channel,
            quip_tune_iters=self.quip_tune_iters)

    def _skip(self, path: str) -> bool:
        return any(pat in path for pat in (self.modules_to_not_convert or []))

    def _merge_spec(self, cfg: ModelConfig) -> Dict[str, Any]:
        """The merge_suv graph of llama, Baichuan, QWen and Mixtral:
        {"signs": {key: size}, "map": {path: (su_key, sv_key)},
        "norm_folds": [(norm, key)], "linear_folds": [(path, key)]}. A
        producer's SV is its consumer's SU, so the pair cancels; block-input
        signs fold into the producing norm's weight and into an
        unquantized consumer (Mixtral's router gate)."""
        D, I = cfg.hidden_size, cfg.intermediate_size
        full_o = cfg.num_key_value_heads == cfg.num_attention_heads
        o_dim = cfg.num_attention_heads * cfg.head_dim
        norm_folds = [("input_layernorm", "qkv_in"),
                      ("post_attention_layernorm", "mlp_in")]
        if cfg.arch in ("llama", "baichuan"):
            signs = {"qkv_in": D, "mlp_in": D, "down_in": I}
            if full_o:
                signs["o_in"] = o_dim
            if cfg.arch == "baichuan":
                mp = {"self_attn.W_pack": ("qkv_in", None)}
            else:
                mp = {
                    "self_attn.q_proj": ("qkv_in", None),
                    "self_attn.k_proj": ("qkv_in", None),
                    "self_attn.v_proj": ("qkv_in",
                                         "o_in" if full_o else None),
                }
            if full_o and cfg.arch == "llama":
                mp["self_attn.o_proj"] = ("o_in", None)
            mp.update({
                "mlp.gate_proj": ("mlp_in", None),
                "mlp.up_proj": ("mlp_in", "down_in"),
                "mlp.down_proj": ("down_in", None),
            })
            return {"signs": signs, "map": mp, "norm_folds": norm_folds,
                    "linear_folds": []}
        if cfg.arch == "qwen":
            # ln_1 -> c_attn; ln_2 -> w1, w2; w1's output sign -> c_proj
            # (the product w1 * silu(w2) carries w1's sign through)
            signs = {"qkv_in": D, "mlp_in": D, "down_in": I}
            mp = {
                "attn.c_attn": ("qkv_in", None),
                "mlp.w1": ("mlp_in", "down_in"),
                "mlp.w2": ("mlp_in", None),
                "mlp.c_proj": ("down_in", None),
            }
            return {"signs": signs, "map": mp,
                    "norm_folds": [("ln_1", "qkv_in"), ("ln_2", "mlp_in")],
                    "linear_folds": []}
        if cfg.arch == "mixtral":
            signs = {"qkv_in": D, "mlp_in": D}
            if full_o:
                signs["o_in"] = o_dim
            mp = {
                "self_attn.q_proj": ("qkv_in", None),
                "self_attn.k_proj": ("qkv_in", None),
                "self_attn.v_proj": ("qkv_in", "o_in" if full_o else None),
            }
            if full_o:
                mp["self_attn.o_proj"] = ("o_in", None)
            for e in range(cfg.num_local_experts):
                signs[f"down_in_e{e}"] = I
                pre = f"block_sparse_moe.experts.{e}"
                mp[f"{pre}.w1"] = ("mlp_in", None)
                mp[f"{pre}.w3"] = ("mlp_in", f"down_in_e{e}")
                mp[f"{pre}.w2"] = (f"down_in_e{e}", None)
            return {"signs": signs, "map": mp, "norm_folds": norm_folds,
                    "linear_folds": [("block_sparse_moe.gate", "mlp_in")]}
        raise ValueError(
            f"merge_suv not supported for arch {cfg.arch!r}; set "
            "merge_suv=False")

    def quantize_model(self, cfg: ModelConfig, model,
                       calib_tokens: np.ndarray, dtype=torch.float32,
                       resume_dir: Optional[str] = None, device=None):
        """Quantize ``model`` in place and return it.

        calib_tokens: (nsamples_total, seqlen) token ids. With ft_epochs >
        0 the trailing batches past ``nsamples`` are the finetune's. The
        work runs on ``device``, by default the model's own (the card
        unless the model was built on the CPU); the model is moved there
        first. Per-linear times and proxy losses land in
        ``self.layer_stats_``, the block finetunes' validation losses in
        ``self.ft_block_stats_`` and the end-to-end one's in
        ``self.e2e_ft_stats_``."""
        from ..models import registry as R
        dev = resolve_device(R.model_device(model) if device is None
                             else device)
        model.to(dev)
        with full_f32(), torch.no_grad():
            return self._quantize_model(cfg, model, calib_tokens, dtype,
                                        resume_dir, dev)

    def _quantize_model(self, cfg, model, calib_tokens, dtype, resume_dir,
                        dev):
        from ..models import registry as R
        if self.ft_epochs > 0 and self.merge_suv:
            raise ValueError("finetune mode is incompatible with merge_suv")
        pp_mesh = (self._pp_mesh(cfg) if self.ft_pp > 1 and self.ft_epochs > 0
                   else None)
        merge_spec = self._merge_spec(cfg) if self.merge_suv else None
        rng = np.random.default_rng(self.seed)
        calib_tokens = np.asarray(calib_tokens)
        B, S = self.batch_size, calib_tokens.shape[1]
        n_batches = calib_tokens.shape[0] // B
        n_hess = min(n_batches, max(1, self.nsamples // B))
        n_ft = n_batches - n_hess if self.ft_epochs > 0 else 0
        batches = [torch.as_tensor(calib_tokens[i * B:(i + 1) * B],
                                   dtype=torch.long, device=dev)
                   for i in range(n_hess + n_ft)]
        ARCH = R.get_arch(cfg)
        positions = torch.arange(S, device=dev)[None, :].repeat(B, 1)
        cos, sin = R.rope_tables(cfg, positions)
        mask = causal_mask(S, S, dev)
        n_valid = (max(1, self.ft_valid_size // B) if n_ft > 0 else 0)
        layers = model_layers(model)
        qcfg = self._quant_cfg()
        self.layer_stats_: List[Dict[str, Any]] = []
        self.ft_block_stats_: List[Dict[str, float]] = []

        act_dt = torch.float16 if self.calib_act_fp16 else None

        def host(a):
            return a.to("cpu", act_dt) if act_dt is not None else a.cpu()

        def on_dev(x):
            # fp16 host storage upcast on the device: compute stays `dtype`
            return x.to(device=dev, dtype=dtype)

        layer_inputs = [host(R.embed(cfg, model, b, positions, dtype))
                        for b in batches]
        groups = sublayer_groups(cfg)
        cap_keys = sorted({g["capture"] for g in groups})

        done_upto = -1
        if resume_dir:
            meta_path = os.path.join(resume_dir, "resume.json")
            if os.path.isfile(meta_path):
                with open(meta_path) as f:
                    done_upto = json.load(f).get("completed", -1)
                logger.info("resuming after block %d", done_upto)

        for i in range(cfg.num_hidden_layers):
            t0 = time.time()
            blk = layers[i]
            if resume_dir and i <= done_upto:
                # replay the float forward only, then swap in the saved
                # block and the generator's state after it
                layer_inputs = [host(ARCH.block_apply(
                    cfg, blk, on_dev(x), cos, sin, attn_mask=mask)[0])
                    for x in layer_inputs]
                saved = torch.load(os.path.join(resume_dir,
                                                f"block_{i}.pt"),
                                   map_location=dev, weights_only=False)
                layers[i] = saved["block"]
                rng.bit_generator.state = saved["rng"]
                continue
            merge = {}
            if merge_spec:
                merge = {k: _signs(rng, n)
                         for k, n in merge_spec["signs"].items()}
            # ---- capture pass: Hessians (first n_hess batches) and float
            # outputs for every batch (targets, next block's inputs)
            hs: Dict[str, hessian.HessianState] = {}
            outputs = []
            for bi, x_in in enumerate(layer_inputs):
                y, _, caps = ARCH.block_apply(cfg, blk, on_dev(x_in), cos,
                                              sin, attn_mask=mask,
                                              capture=True)
                outputs.append(host(y))
                if bi >= n_hess:
                    continue
                for key in cap_keys:
                    if key not in caps:
                        continue
                    act = caps[key]
                    if key == "moe_input":
                        routing = caps["moe_routing"]
                        for e in range(cfg.num_local_experts):
                            k_e = f"moe_input_e{e}"
                            if k_e not in hs:
                                hs[k_e] = hessian.HessianState.zeros(
                                    act.shape[-1], dev)
                            hessian.accumulate(
                                hs[k_e], act * (routing[..., e:e + 1] > 0))
                        continue
                    if key not in hs:
                        hs[key] = hessian.HessianState.zeros(act.shape[-1],
                                                             dev)
                    hessian.accumulate(hs[key], act)
                del caps

            # ---- quantize groups in order (block finetune between)
            merge_map = merge_spec["map"] if merge_spec else {}
            for gi, g in enumerate(groups):
                key = g["capture"]
                if key == "moe_input":
                    key = f"moe_input_e{g['routing_expert']}"
                if key not in hs:
                    continue
                H = hessian.finalize(hs[key])
                shared_SU = shared_lspec = None
                tp = self.tp_shards
                if self.share_group_transforms and len(g["layers"]) > 1:
                    n_in = H.shape[0]
                    shared_SU = _signs(rng, n_in)
                    l_shards = (tp if tp > 1
                                and role_of(g["layers"][0]) == "row"
                                and n_in % tp == 0 else 1)
                    shared_lspec = get_hadK(n_in, self.use_rand, rng=rng,
                                            shards=l_shards)
                for path in g["layers"]:
                    if self._skip(path):
                        continue
                    lin = get_path(blk, path)
                    if not isinstance(lin, DenseLinear):
                        continue
                    t1 = time.time()
                    SU = SV = None
                    su_is_merged = None
                    if merge:
                        su_key, sv_key = merge_map.get(path, (None, None))
                        SU = merge.get(su_key) if su_key else None
                        SV = merge.get(sv_key) if sv_key else None
                    elif shared_SU is not None:
                        SU = shared_SU
                        su_is_merged = False  # applied at runtime, shared
                    W = lin.weight.to(torch.float32)
                    lspec, rspec = shared_lspec, None
                    if tp > 1:
                        # the block-diagonal transform on the dimension TP
                        # shards, drawn before quantize_layer's own draws
                        role = role_of(path)
                        if role == "col" and W.shape[0] % tp == 0:
                            rspec = get_hadK(W.shape[0], self.use_rand,
                                             rng=rng, shards=tp)
                        elif (role == "row" and lspec is None
                              and W.shape[1] % tp == 0):
                            lspec = get_hadK(W.shape[1], self.use_rand,
                                             rng=rng, shards=tp)
                    attrs, W_hat = quantize_layer(
                        W, H, self.cb, qcfg, rng, SU=SU, SV=SV,
                        lspec=lspec, rspec=rspec, su_is_merged=su_is_merged,
                        device=dev)
                    set_path(blk, path, pack_to_qlinear(
                        attrs, self.cb, bias=lin.bias,
                        per_channel=self.per_channel, device=dev))
                    self._stat(f"layers.{i}.{path}", t1, W, W_hat, H)
                    del W_hat

                if self.ft_epochs > 0 and gi < len(groups) - 1:
                    from . import finetune as FT
                    with torch.enable_grad():
                        FT.finetune_block(
                            cfg, blk, layer_inputs[n_hess:],
                            outputs[n_hess:], cos, sin, mask,
                            ft_susv_lr=self.ft_susv_lr, ft_lr=self.ft_lr,
                            epochs=self.ft_epochs,
                            valid_frac=max(1, n_ft // max(n_valid, 1)),
                            early_stop=self.ft_early_stop,
                            stats=self.ft_block_stats_)

            if merge:
                # fold interface signs into the producing norms and into
                # unquantized consumer linears (signs: mul == div)
                for norm_name, s_key in merge_spec["norm_folds"]:
                    nrm = blk[norm_name]
                    nrm.weight = (nrm.weight.to(torch.float32)
                                  * torch.as_tensor(merge[s_key], device=dev)
                                  ).to(dtype)
                for path, s_key in merge_spec["linear_folds"]:
                    lin = get_path(blk, path)
                    sign = torch.as_tensor(merge[s_key], device=dev)
                    lin.weight = (lin.weight.to(torch.float32)
                                  * sign[None, :]).to(dtype)

            logger.info("block %d/%d quantized in %.1fs", i + 1,
                        cfg.num_hidden_layers, time.time() - t0)
            if resume_dir:
                os.makedirs(resume_dir, exist_ok=True)
                torch.save({"block": blk, "rng": rng.bit_generator.state},
                           os.path.join(resume_dir, f"block_{i}.pt"))
                with open(os.path.join(resume_dir, "resume.json"), "w") as f:
                    json.dump({"completed": i}, f)
            layer_inputs = outputs     # next block takes the float outputs

        head_key = R.untied_head_key(cfg, model)
        float_head = None     # the e2e finetune's teacher head
        if self.quantize_lm_head and head_key is not None:
            lin = getattr(model, head_key) if isinstance(
                model, LlamaModel) else model[head_key]
            if isinstance(lin, DenseLinear):
                t1 = time.time()
                float_head = lin
                hst = hessian.HessianState.zeros(cfg.hidden_size, dev)
                for x in layer_inputs[:n_hess]:
                    hessian.accumulate(hst, R.final_hidden(
                        cfg, model, x.to(device=dev, dtype=torch.float32)))
                H = hessian.finalize(hst)
                W = lin.weight.to(torch.float32)
                attrs, W_hat = quantize_layer(W, H, self.cb, qcfg, rng,
                                              device=dev)
                _set_top(model, head_key, pack_to_qlinear(
                    attrs, self.cb, bias=lin.bias,
                    per_channel=self.per_channel, device=dev))
                self._stat(head_key, t1, W, W_hat, H)
                del W_hat
                logger.info("%s quantized", head_key)

        if self.ft_epochs > 0:
            with torch.enable_grad():
                self._finetune_end2end(cfg, model, batches, layer_inputs,
                                       n_hess, n_valid, float_head, pp_mesh)
        return model

    def _stat(self, name, t1, W, W_hat, H):
        self.layer_stats_.append({
            "linear": name, "seconds": time.time() - t1,
            "proxy_loss": proxy_loss(W, W_hat, H)})

    def _pp_mesh(self, cfg):
        """The pipelined finetune's ("pp",) mesh: ``ft_pp`` must divide
        the layers (the JAX package's check) and be the world size."""
        import torch.distributed as dist
        from ..parallel.pipeline import make_pp_mesh
        if cfg.num_hidden_layers % self.ft_pp:
            raise ValueError(
                f"ft_pp={self.ft_pp} must divide num_hidden_layers="
                f"{cfg.num_hidden_layers}")
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != self.ft_pp:
            raise ValueError(
                f"ft_pp={self.ft_pp} runs quantize_model on each of "
                f"{self.ft_pp} ranks of an initialised process group; the "
                f"world size is {world}")
        return make_pp_mesh(self.ft_pp)

    def _finetune_end2end(self, cfg, model, batches, last_outputs, n_hess,
                          n_valid, float_head=None, pp_mesh=None):
        """End-to-end CE finetune of every block's leaves against the
        float model's output distributions. With the head quantized,
        ``float_head`` (its float original) is the teacher's head. With
        ``pp_mesh`` the student runs pipelined and a rank's Adam steps
        only its stage's leaves (Adam is elementwise, so together the
        ranks take the one-rank step); every rank sees the same losses,
        and at the end each stage's leaves go to every rank."""
        from ..models import registry as R
        from ..models.llama import linear_apply
        from . import finetune as FT
        dev = R.model_device(model)

        def head_probs(x):
            with torch.no_grad():
                h = R.final_hidden(cfg, model, x.to(device=dev,
                                                    dtype=torch.float32))
                logits = (linear_apply(float_head, h) if float_head is not None
                          else R.head_logits(cfg, model, h))
                return torch.softmax(logits.to(torch.float32), dim=-1).cpu()

        ft_ids = batches[n_hess:]
        if not ft_ids:
            return model
        targets = [head_probs(o) for o in last_outputs[n_hess:]]
        layers = model_layers(model)
        flat = FT.collect_trainable(layers)
        FT.apply_trainable(layers, flat)
        n_micro = self.ft_microbatches or self.ft_batch_size
        own = flat
        if pp_mesh is not None:
            from ..parallel.pipeline import stage_range
            logger.info("end2end ft pipelined over %d stages, %d "
                        "microbatches", self.ft_pp, n_micro)
            stage = stage_range(len(layers), pp_mesh)
            own = {k: v for k, v in flat.items() if _layer_of(k) in stage}

        def logits_of(ids):
            return FT.student_logits(cfg, model, ids, pp_mesh, n_micro)
        opt = FT.make_susv_optimizer(self.ft_susv_lr, self.ft_lr, own)
        step = FT.make_train_step(opt, logits_of)

        def vloss():
            with torch.no_grad():
                return FT._mean_loss([float(FT.ce_loss(logits_of(a),
                                                       b.to(dev)))
                                      for a, b in zip(va_ids, va_tg)])

        tr_ids, tr_tg = ft_ids[:-n_valid], targets[:-n_valid]
        va_ids, va_tg = ft_ids[-n_valid:], targets[-n_valid:]
        with FT.dense_weights(FT.student_modules(cfg, model, pp_mesh)):
            initial = vloss()
            best, best_flat, worse = initial, FT.freeze(flat), 0
            logger.info("end2end initial loss %.5f", best)
            for ep in range(self.ft_epochs):
                for a, b in zip(tr_ids, tr_tg):
                    step(a, b.to(dev))
                cur = vloss()
                if cur < best:
                    logger.info("end2end epoch %d loss %.5f BETTER", ep, cur)
                    best, best_flat, worse = cur, FT.freeze(flat), 0
                else:
                    worse += 1
                    if worse >= self.ft_early_stop:
                        break
        self.e2e_ft_stats_ = {"initial": initial, "best": best}
        if pp_mesh is not None:
            from ..parallel import comm
            per = len(layers) // pp_mesh.size
            for k, v in best_flat.items():    # each leaf from its stage
                comm.broadcast(v, pp_mesh.ranks[_layer_of(k) // per],
                               pp_mesh.group)
        FT.apply_trainable(layers, best_flat)
        return model


def _layer_of(key: str) -> int:
    """The layer index of a ``collect_trainable`` key of the block list
    (".{i}.<path>")."""
    return int(key.split(".", 2)[1])
