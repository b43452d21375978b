"""LoRA fine-tuning over a frozen quantized model — counterpart of
``quip_for_all_tpu/quantize/lora_train.py``.

Each step is one forward through the quantized base plus the adapters'
rank-r products and one backward: below the fused/dense crossover every
quantized linear runs its layout's forward kernel and K3 backward
(``ops/fused_matmul.py`` ``FusedQuantMatmul``), above it the decoded W and
``torch.matmul`` (so at the default batch 4 x 512, 2044 rows, the dense
route, as in the JAX package). Only ``lora_A`` / ``lora_B`` take gradients,
updated by ``torch.optim.AdamW`` with optax.adamw's defaults (the same
update: decoupled decay, bias-corrected moments).

Every function here takes any family's model (a ``LlamaModel`` for llama,
Mixtral and Baichuan, a ``FamilyModel`` for the others; ``models/
registry.py``), with adapters on the linears whose names end with one of
the ``targets`` (``nn/lora.py``).

Adapters go to and come from standalone safetensors files in the JAX
package's layout and in the standard PEFT layout, with the same file names
and keys, so either package reads the other's files.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.config import ModelConfig
from ..models.registry import get_arch, model_device
from ..nn.lora import (DEFAULT_TARGETS, add_lora, apply_lora_trainable,
                       collect_lora_trainable)
from ..utils.device import resolve_device
from ..utils.safetensors_io import load_file, save_file

logger = logging.getLogger(__name__)

ADAPTER_FILE = "lora_adapters.safetensors"
ADAPTER_CONFIG = "lora_config.json"
PEFT_ADAPTER_FILE = "adapter_model.safetensors"
PEFT_ADAPTER_CONFIG = "adapter_config.json"
# PEFT key layout for a causal LM: LoraModel wraps the HF model as
# `base_model.model`, whose decoder stack lives under `model.layers`; the
# JAX package writes this prefix for every family, and so does the port
_PEFT_PREFIX = "base_model.model.model."


def causal_lm_loss(cfg: ModelConfig, model, ids: torch.Tensor,
                   linear_kw: Optional[dict] = None) -> torch.Tensor:
    """Next-token cross entropy over a (B, S) batch (labels = ids shifted)
    through any family's model (``get_arch(cfg).model_apply``), the logits
    in f32; ``linear_kw`` goes to every linear (e.g. ``compute_dtype`` or
    ``matmul_impl``)."""
    logits, _ = get_arch(cfg).model_apply(cfg, model, ids[:, :-1],
                                          linear_kw=linear_kw or {})
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, ids[:, 1:, None].to(torch.int64))[..., 0]
    return -ll.mean()


def _model_device(model, device) -> torch.device:
    """``device`` resolved (the card unless the caller asks for the CPU),
    and the model must live there."""
    dev = resolve_device(device)
    have = model_device(model)
    if have.type != dev.type:
        raise ValueError(f"model lives on {have}, asked for {dev}")
    return have


def train_lora(cfg: ModelConfig, model, train_tokens: np.ndarray,
               valid_tokens: Optional[np.ndarray] = None,
               rank: int = 8, alpha: float = 16.0,
               targets=DEFAULT_TARGETS, lr: float = 1e-4,
               epochs: int = 3, batch_size: int = 4,
               weight_decay: float = 0.0, early_stop: int = 3,
               seed: int = 0, device="cuda"):
    """Add LoRA adapters to ``model`` (in place) and train them; returns the
    model with the best adapters attached. Batches run in order; with
    ``valid_tokens`` the validation loss after each epoch keeps the best
    epoch and stops early after ``early_stop`` epochs without a gain (the
    JAX package's loop)."""
    dev = _model_device(model, device)
    add_lora(model, rank=rank, alpha=alpha, targets=targets, seed=seed)
    flat = collect_lora_trainable(model.layers, "layers")
    if not flat:
        raise ValueError(f"no linear matched LoRA targets {targets}")
    opt = torch.optim.AdamW(list(flat.values()), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)

    def batches(toks):
        for i in range(toks.shape[0] // batch_size):
            yield torch.as_tensor(
                toks[i * batch_size:(i + 1) * batch_size], device=dev)

    def vloss():
        with torch.no_grad():
            return float(np.mean([
                float(causal_lm_loss(cfg, model, b))
                for b in batches(valid_tokens)]))

    def snapshot():
        return {k: v.detach().clone() for k, v in flat.items()}

    best = vloss() if valid_tokens is not None else np.inf
    best_flat, worse = snapshot(), 0
    if valid_tokens is not None:
        logger.info("lora initial valid loss %.5f", best)
    for ep in range(epochs):
        tl = []
        for b in batches(train_tokens):
            opt.zero_grad(set_to_none=True)
            loss = causal_lm_loss(cfg, model, b)
            loss.backward()
            opt.step()
            tl.append(loss.item())
        if valid_tokens is None:
            best_flat = snapshot()
            logger.info("lora epoch %d train loss %.5f", ep,
                        float(np.mean(tl)))
            continue
        cur = vloss()
        logger.info("lora epoch %d train %.5f valid %.5f", ep,
                    float(np.mean(tl)), cur)
        if cur < best:
            best, best_flat, worse = cur, snapshot(), 0
        else:
            worse += 1
            if worse >= early_stop:
                break
    apply_lora_trainable(model.layers, best_flat, "layers")
    return model


# ------------------------------------------------------------- adapter IO

def _flat_numpy(model) -> Dict[str, np.ndarray]:
    return {k: v.detach().to("cpu", torch.float32).numpy()
            for k, v in collect_lora_trainable(model.layers,
                                               "layers").items()}


def save_lora(model, save_dir: str, rank: int, alpha: float,
              targets=DEFAULT_TARGETS) -> None:
    """Write the adapters (``lora_adapters.safetensors``, f32) and their
    config (``lora_config.json``)."""
    os.makedirs(save_dir, exist_ok=True)
    save_file(_flat_numpy(model), os.path.join(save_dir, ADAPTER_FILE))
    with open(os.path.join(save_dir, ADAPTER_CONFIG), "w") as f:
        json.dump({"rank": rank, "alpha": alpha,
                   "targets": list(targets)}, f, indent=2)


def export_peft(model, save_dir: str, rank: int,
                alpha: float, targets=DEFAULT_TARGETS,
                base_model_name_or_path: str = "") -> None:
    """Write the adapters in the standard PEFT layout
    (``adapter_model.safetensors`` + ``adapter_config.json``): lora_A
    (r, in), lora_B (out, r), scaling alpha / r."""
    tensors = {_PEFT_PREFIX + k + ".weight": v
               for k, v in _flat_numpy(model).items()}
    os.makedirs(save_dir, exist_ok=True)
    save_file(tensors, os.path.join(save_dir, PEFT_ADAPTER_FILE))
    with open(os.path.join(save_dir, PEFT_ADAPTER_CONFIG), "w") as f:
        json.dump({
            "peft_type": "LORA",
            "task_type": "CAUSAL_LM",
            "r": rank,
            "lora_alpha": alpha,
            "lora_dropout": 0.0,
            "target_modules": sorted(set(targets)),
            "base_model_name_or_path": base_model_name_or_path,
            "bias": "none",
            "fan_in_fan_out": False,
            "inference_mode": True,
        }, f, indent=2)


def _attach(model, flat: Dict[str, np.ndarray], rank: int,
            alpha: float, targets, what: str):
    add_lora(model, rank=rank, alpha=alpha, targets=tuple(targets))
    have = collect_lora_trainable(model.layers, "layers")
    missing = set(have) - set(flat)
    if missing:
        raise ValueError(f"{what} missing keys: {sorted(missing)[:4]}")
    apply_lora_trainable(model.layers, flat, "layers")
    return model


def import_peft(model, peft_dir: str, device="cuda"):
    """Attach adapters from a standard PEFT directory (``export_peft``'s,
    or any PEFT LoRA of the same base) to ``model``, in place."""
    _model_device(model, device)
    with open(os.path.join(peft_dir, PEFT_ADAPTER_CONFIG)) as f:
        acfg = json.load(f)
    if acfg.get("peft_type", "LORA").upper() != "LORA":
        raise ValueError(f"not a LoRA adapter: {acfg.get('peft_type')}")
    flat = {}
    for k, v in load_file(os.path.join(peft_dir, PEFT_ADAPTER_FILE)).items():
        for pre in (_PEFT_PREFIX, "base_model.model."):
            if k.startswith(pre):
                k = k[len(pre):]
                break
        if k.endswith(".weight"):
            k = k[: -len(".weight")]
        flat[k] = v
    return _attach(model, flat, acfg["r"], acfg["lora_alpha"],
                   acfg["target_modules"], "PEFT adapter")


def load_lora(model, save_dir: str, device="cuda"):
    """Attach adapters saved by ``save_lora`` (either package's) to
    ``model``, in place."""
    _model_device(model, device)
    with open(os.path.join(save_dir, ADAPTER_CONFIG)) as f:
        acfg = json.load(f)
    return _attach(model, load_file(os.path.join(save_dir, ADAPTER_FILE)),
                   acfg["rank"], acfg["alpha"], acfg["targets"],
                   "adapter file")
