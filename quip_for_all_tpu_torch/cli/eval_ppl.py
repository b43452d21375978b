"""Perplexity evaluation CLI — the flags of
``quip_for_all_tpu/cli/eval_ppl.py`` plus ``--device`` (the card unless
``--device cpu``):

    python -m quip_for_all_tpu_torch.cli.eval_ppl --model-path ckpt/ \
        --dataset synthetic --nsamples 64 --seqlen 2048

Datasets: ``synthetic`` or ``file:<path>`` (a tokenizer from
``transformers`` for the latter); the HF dataset names need a download
and raise. Prints one JSON line with the JAX CLI's keys.

``--sp N`` above 1 splits each window's sequence over N ranks (ring
attention, ``parallel/sequence.py``). The JAX CLI takes N devices of one
process; here the CLI runs on each of N processes, for example

    torchrun --nproc-per-node 2 -m quip_for_all_tpu_torch.cli.eval_ppl \
        --model-path ckpt/ --dataset synthetic --sp 2

(two ranks may share one card: the group runs gloo). Every rank loads
the model and draws the same windows; rank 0 prints the line.
"""
from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--dataset", default="wikitext2-test")
    ap.add_argument("--nsamples", type=int, default=64)
    ap.add_argument("--seqlen", type=int, default=2048)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--tokenizer", default=None)
    ap.add_argument("--split", default="validation",
                    choices=["train", "validation"])
    ap.add_argument("--sp", type=int, default=0,
                    help="shard the sequence over this many ranks (ring-"
                    "attention sequence parallelism; run the CLI on each, "
                    "e.g. under torchrun)")
    ap.add_argument("--seed", type=int, default=0,
                    help="sampling seed for the eval window draw (use a "
                    "seed distinct from calibration for synthetic data)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.sp > 1:
        from . import rank_group
        with rank_group(args.sp, "--sp", args.device) as rank:
            _run(args, rank)
    else:
        _run(args, 0)


def _run(args, rank: int):
    from ..data.calibration import get_calibration_tokens
    from ..runtime.generate import perplexity
    from ..utils.checkpoint import load_quantized

    cfg, model, qcfg = load_quantized(args.model_path, device=args.device)
    tokenizer = None
    if args.dataset.startswith("file:"):
        os.environ.setdefault("HF_HUB_OFFLINE", "1")   # local files only
        from transformers import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(args.tokenizer
                                                  or args.model_path)
    toks = get_calibration_tokens(args.dataset, tokenizer, args.nsamples,
                                  args.seqlen, seed=args.seed,
                                  split=args.split,
                                  vocab_size=cfg.vocab_size)
    sp_mesh = None
    if args.sp > 1:
        from ..parallel.sequence import make_sp_mesh
        sp_mesh = make_sp_mesh(args.sp)
    ppl = perplexity(cfg, model, toks, batch_size=args.batch_size,
                     sp_mesh=sp_mesh, device=args.device)
    if rank:
        return
    print(json.dumps({"dataset": args.dataset, "seqlen": args.seqlen,
                      "nsamples": args.nsamples,
                      "codebook": qcfg.get("codebook"), "ppl": ppl}))


if __name__ == "__main__":
    main()
