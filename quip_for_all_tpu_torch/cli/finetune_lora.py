"""LoRA fine-tuning CLI — the flags of ``quip_for_all_tpu/cli/finetune_lora.py``
plus ``--device`` (the card unless ``--device cpu``):

    python -m quip_for_all_tpu_torch.cli.finetune_lora --model-path ckpt/ \
        --dataset synthetic --nsamples 256 --rank 8 --epochs 3 \
        --save-dir ckpt/lora/

The trained adapters land in --save-dir as lora_adapters.safetensors +
lora_config.json, and in the PEFT layout (adapter_model.safetensors +
adapter_config.json) unless --no-peft; reload them with
``quantize.lora_train.load_lora`` / ``import_peft`` on the base checkpoint.
Datasets: ``synthetic`` or ``file:<path>`` (a tokenizer from
``transformers`` for the latter); the HF datasets are not ported yet.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--save-dir", required=True)
    ap.add_argument("--dataset", default="synthetic")
    ap.add_argument("--split", default="train",
                    choices=["train", "validation"])
    ap.add_argument("--tokenizer", default=None)
    ap.add_argument("--nsamples", type=int, default=256)
    ap.add_argument("--valid-samples", type=int, default=32)
    ap.add_argument("--seqlen", type=int, default=512)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--alpha", type=float, default=16.0)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--early-stop", type=int, default=3)
    ap.add_argument("--targets", nargs="*", default=None,
                    help="linear name suffixes to adapt (default: llama "
                    "attn+mlp projections)")
    ap.add_argument("--no-peft", action="store_true",
                    help="skip the standard PEFT layout export "
                    "(adapter_model.safetensors + adapter_config.json); by "
                    "default adapters are written in both layouts")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..data.calibration import get_calibration_tokens
    from ..nn.lora import DEFAULT_TARGETS
    from ..quantize.lora_train import export_peft, save_lora, train_lora
    from ..utils.checkpoint import load_quantized

    cfg, model, _ = load_quantized(args.model_path, device=args.device)
    tokenizer = None
    if args.dataset != "synthetic":
        from transformers import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(args.tokenizer
                                                  or args.model_path)
    total = args.nsamples + args.valid_samples
    toks = get_calibration_tokens(args.dataset, tokenizer, total,
                                  args.seqlen, seed=args.seed,
                                  split=args.split,
                                  vocab_size=cfg.vocab_size)
    train_toks, valid_toks = toks[:args.nsamples], toks[args.nsamples:]
    targets = tuple(args.targets) if args.targets else DEFAULT_TARGETS

    model = train_lora(
        cfg, model, train_toks,
        valid_tokens=valid_toks if args.valid_samples > 0 else None,
        rank=args.rank, alpha=args.alpha, targets=targets, lr=args.lr,
        epochs=args.epochs, batch_size=args.batch_size,
        weight_decay=args.weight_decay, early_stop=args.early_stop,
        seed=args.seed, device=args.device)
    save_lora(model, args.save_dir, args.rank, args.alpha, targets)
    if not args.no_peft:
        export_peft(model, args.save_dir, args.rank, args.alpha, targets,
                    base_model_name_or_path=args.model_path)
    print(f"saved LoRA adapters to {args.save_dir}", file=sys.stderr)


if __name__ == "__main__":
    main()
