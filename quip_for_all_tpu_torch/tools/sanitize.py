"""Run the runtime sanitizer (``utils/sanitize.py``) against a model —
counterpart of the JAX package's ``tools/sanitize.py``:

    python -m quip_for_all_tpu_torch.tools.sanitize --device cpu   # tiny
    python -m quip_for_all_tpu_torch.tools.sanitize --model llama2_7b
    python -m quip_for_all_tpu_torch.tools.sanitize --load ckpt/
    python -m quip_for_all_tpu_torch.tools.sanitize --model mixtral_8x7b \
        --layers 1

Checks: determinism of the decode step (eager, and as the decode loop
runs it: a CUDA graph on the card), purity of the model, ids and
positions, finite logits, and variant parity on one representative leaf
per (codebook, layout, leaf class): ``QuantLinear``, ``FusedQuantLinear``
(the JAX package's ``QuantLinearSegments``) and ``StackedQuantLinear`` (its
``QuantMoE``, through the MoE kernel against each expert's dense decode).
A leaf that holds planes in any other class is reported as a finding, not
passed by. Random models come from seed 0 with a quantized head and go
through ``fuse_for_inference``, as the main path runs them, and take
their decode step in the dtype they are built in (f32 tiny, bf16 the
others, as the decode loop runs them); ``--model mixtral_8x7b`` and
``--layers N`` give a Mixtral's stacked leaf at full width in one layer
(``chip_smoke.py`` phase 24 (ii) runs that). On the card the run holds
the chip lock (``utils/chiplock.py``). Prints the JAX tool's summary line
last; exit code 0 only if every check passed.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

PROBED = ("QuantLinear", "FusedQuantLinear", "StackedQuantLinear")


def plane_holders(model):
    """(name, module) of every module holding code planes itself (its own
    ``planes_*`` buffers), in the model's order."""
    for name, mod in model.named_modules():
        if any(b.startswith("planes_") for b, _ in
               mod.named_buffers(recurse=False)):
            yield name, mod


def sweep(model, m: int = 8, seed: int = 0, rows: int = 16, report=None):
    """Variant parity on the first leaf of each (codebook, layout, leaf
    class): x (m, q_in) bf16 from ``np.random.default_rng(seed)`` (the JAX
    tool's draw) for a linear; ``rows`` rows dealt over the experts in
    turn for a stacked one. Returns the merged report (into ``report``
    when given)."""
    from ..utils.sanitize import (SanitizerReport, check_stacked_parity,
                                  check_variant_parity)
    rep = SanitizerReport() if report is None else report
    seen = set()
    for name, mod in plane_holders(model):
        kind = type(mod).__name__
        if kind not in PROBED:
            rep.add("variant_parity", name,
                    f"leaf class {kind} holds planes the sweep cannot probe")
            continue
        layout = getattr(mod, "layout", "nibble")
        key = (mod.codebook_id, layout, kind)
        if key in seen:
            continue
        seen.add(key)
        dev = mod.planes_w0.device
        if kind == "StackedQuantLinear":
            x = torch.as_tensor(np.random.default_rng(seed).standard_normal(
                (rows, mod.q_in)), dtype=torch.bfloat16, device=dev)
            eids = (torch.arange(rows, device=dev) % mod.E).to(torch.int32)
            sub = check_stacked_parity(mod, x, eids, leaf=name)
        else:
            qt = mod.qweight
            x = torch.as_tensor(np.random.default_rng(seed).standard_normal(
                (m, qt.q_in)), dtype=torch.bfloat16, device=dev)
            sub = check_variant_parity(qt, x, leaf=name)
        for run in sub.runs:
            print(f"[sanitize] variant parity [{mod.codebook_id} {layout} "
                  f"{kind} {name}] m={run['m']} {run['variant']}: "
                  f"{run['status']}, {run['reached']} against "
                  f"{run['against']}, max |diff| {run['max_abs_diff']:.3e}",
                  file=sys.stderr)
        rep.merge(sub)
    return rep


def build(args):
    """(cfg, model, dtype of its decode step) of the arguments, on
    ``args.device``."""
    import quip_for_all_tpu_torch as qt
    from ..models import config as C
    dtype = torch.float32
    if args.load:
        cfg, model, _ = qt.load_quantized(args.load, device=args.device)
    else:
        cfg = {"tiny": C.tiny_config, "llama2_7b": C.llama2_7b_config,
               "mixtral_8x7b": C.mixtral_8x7b_config}[args.model]()
        if args.layers:
            cfg = dataclasses.replace(cfg, num_hidden_layers=args.layers)
        if args.model != "tiny":
            dtype = torch.bfloat16
        model = qt.random_quantized_model(
            cfg, codebook=args.codebook, seed=0, dtype=dtype,
            quantize_head=True, device=args.device)
    return cfg, qt.fuse_for_inference(cfg, model), dtype


def run(args):
    """The sanitizer's report on the model of ``args`` (``parse_args``):
    the decode step's checks and the sweep; prints its summary."""
    from ..utils.sanitize import sanitize_decode_step
    cfg, model, dtype = build(args)
    print(f"[sanitize] model arch={cfg.arch} d={cfg.hidden_size} "
          f"layers={cfg.num_hidden_layers} device={args.device} "
          f"step dtype={str(dtype).split('.')[-1]}", file=sys.stderr)
    rep = sanitize_decode_step(cfg, model, repeats=args.repeats,
                               dtype=dtype)
    sweep(model, report=rep)
    print(rep.summary())
    return rep


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="tiny",
                    choices=("tiny", "llama2_7b", "mixtral_8x7b"),
                    help="random quantized weights of this shape")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the random model to this many layers")
    ap.add_argument("--codebook", default="E8P12")
    ap.add_argument("--load", default=None,
                    help="a quantized checkpoint directory (overrides "
                         "--model)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from ..utils.chiplock import chip_lock
    from ..utils.device import resolve_device
    args = parse_args(argv)
    resolve_device(args.device)
    with chip_lock(device=args.device):
        return 0 if run(args).ok else 1


if __name__ == "__main__":
    sys.exit(main())
