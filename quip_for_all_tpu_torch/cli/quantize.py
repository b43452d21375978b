"""Quantization CLI — the flags of ``quip_for_all_tpu/cli/quantize.py``
plus ``--device`` (the card unless ``--device cpu``):

    python -m quip_for_all_tpu_torch.cli.quantize --model-path <hf_dir> \
        --save-dir out/ --codebook E8P12 --dataset synthetic --nsamples 4096

``--model-path`` is a local HF directory (``utils/hf_import.py``) or
``random:<preset>`` for the dense model of ``init_llama_params`` (presets
tiny, llama2_7b, llama2_70b, mixtral_8x7b). Datasets: ``synthetic`` or
``file:<path>`` (a tokenizer from ``transformers`` for the latter); the
HF dataset names need a download and raise. ``--tp-shards`` and
``--ft-pp`` above 1 raise NotImplementedError (ROADMAP.md queue 1 item 8).
"""
from __future__ import annotations

import argparse
import sys


def _local_tokenizer(path: str):
    """The directory's own tokenizer through ``transformers`` (local files
    only), or None where there is none."""
    import os
    if not any(os.path.isfile(os.path.join(path, f)) for f in (
            "tokenizer.json", "tokenizer.model", "tokenizer_config.json")):
        return None
    try:
        from transformers import AutoTokenizer
        return AutoTokenizer.from_pretrained(path, local_files_only=True)
    except (ImportError, OSError, ValueError):   # no usable tokenizer
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model-path", required=True,
                    help="HF model dir (config.json + safetensors) or "
                         "'random:<preset>' for a random-init model "
                         "(presets: tiny, llama2_7b, llama2_70b, "
                         "mixtral_8x7b)")
    ap.add_argument("--save-dir", required=True)
    ap.add_argument("--codebook", default="E8P12",
                    choices=["D4", "E8P12", "HI", "E8P12RVQ3B",
                             "E8P12RVQ4B"])
    ap.add_argument("--dataset", default="synthetic")
    ap.add_argument("--split", default="train",
                    choices=["train", "validation"])
    ap.add_argument("--nsamples", type=int, default=4096)
    ap.add_argument("--seqlen", type=int, default=2048)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--quip-tune-iters", type=int, default=10)
    ap.add_argument("--sigma-reg", type=float, default=0.01)
    ap.add_argument("--rescale-WH", action="store_true")
    ap.add_argument("--no-use-rand", action="store_true")
    ap.add_argument("--per-channel", action="store_true")
    ap.add_argument("--merge-suv", action="store_true")
    ap.add_argument("--ft-epochs", type=int, default=0)
    ap.add_argument("--ft-train-size", type=int, default=384)
    ap.add_argument("--ft-valid-size", type=int, default=128)
    ap.add_argument("--modules-to-not-convert", nargs="*", default=None)
    ap.add_argument("--tp-shards", type=int, default=1,
                    help="not ported yet: above 1 it raises")
    ap.add_argument("--ft-pp", type=int, default=1,
                    help="not ported yet: above 1 it raises")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..data.calibration import get_calibration_tokens
    from ..models.config import (llama2_7b_config, llama2_70b_config,
                                 mixtral_8x7b_config, tiny_config)
    from ..models.llama import init_llama_params
    from ..quantize.quantizer import QuipQuantizer
    from ..utils.checkpoint import save_quantized
    from ..utils.device import resolve_device
    from ..utils.hf_import import load_hf_model

    q = QuipQuantizer(
        codebook=args.codebook, nsamples=args.nsamples,
        model_seqlen=args.seqlen, quip_tune_iters=args.quip_tune_iters,
        sigma_reg=args.sigma_reg, rescale_WH=args.rescale_WH,
        use_rand=not args.no_use_rand, per_channel=args.per_channel,
        merge_suv=args.merge_suv, batch_size=args.batch_size,
        ft_epochs=args.ft_epochs, ft_train_size=args.ft_train_size,
        ft_valid_size=args.ft_valid_size,
        modules_to_not_convert=args.modules_to_not_convert,
        tp_shards=args.tp_shards, ft_pp=args.ft_pp, seed=args.seed)
    dev = resolve_device(args.device)

    if args.model_path.startswith("random:"):
        preset = args.model_path.split(":", 1)[1]
        cfg = {"tiny": tiny_config, "llama2_7b": llama2_7b_config,
               "llama2_70b": llama2_70b_config,
               "mixtral_8x7b": mixtral_8x7b_config}[preset]()
        model = init_llama_params(cfg, seed=args.seed, device=dev)
        tokenizer = None
    else:
        cfg, model = load_hf_model(args.model_path, device=dev)
        tokenizer = _local_tokenizer(args.model_path)

    total = args.nsamples + (args.ft_train_size + args.ft_valid_size
                             if args.ft_epochs > 0 else 0)
    calib = get_calibration_tokens(args.dataset, tokenizer, total,
                                   args.seqlen, seed=args.seed,
                                   split=args.split,
                                   vocab_size=cfg.vocab_size)
    model = q.quantize_model(cfg, model, calib)
    save_quantized(cfg, model, q.to_dict(), args.save_dir)
    print(f"saved quantized model to {args.save_dir}", file=sys.stderr)


if __name__ == "__main__":
    main()
