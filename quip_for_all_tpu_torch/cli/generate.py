"""Generation CLI — the flags of ``quip_for_all_tpu/cli/generate.py`` plus
``--device`` (the card unless ``--device cpu``):

    python -m quip_for_all_tpu_torch.cli.generate --model-path ckpt/ \
        --prompt "Hello" --max-new-tokens 128 --temperature 0.8 --top-k 200

The decode loop replays CUDA graphs on the card (``runtime/generate.py``).
Without a tokenizer (``transformers`` and the checkpoint's files) the
prompt's bytes are the ids and the ids are printed. As in the JAX CLI, a
first run is followed by a timed second run (seed + 1) whose ids are
printed; here both runs take ``--kv-quantized`` (the JAX CLI's first run
drops it; the printed run is the same).
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def _dtype(name: str):
    import torch
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--prompt", default="Hello, my name is")
    ap.add_argument("--max-new-tokens", type=int, default=200)
    ap.add_argument("--temperature", type=float, default=0.6)
    ap.add_argument("--top-k", type=int, default=200)
    ap.add_argument("--cache-len", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32", "float16"])
    ap.add_argument("--tokenizer", default=None,
                    help="HF tokenizer path (defaults to model-path)")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they decode (chunks of "
                    "--stream-chunk steps)")
    ap.add_argument("--stream-chunk", type=int, default=8)
    ap.add_argument("--kv-quantized", action="store_true",
                    help="int8 KV cache: half the attention reads and "
                    "cache memory")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..runtime.generate import generate, generate_stream
    from ..utils.checkpoint import load_quantized

    cfg, model, qcfg = load_quantized(args.model_path, device=args.device)
    print(f"loaded {qcfg.get('codebook')} checkpoint "
          f"({cfg.num_hidden_layers} layers) on {args.device}",
          file=sys.stderr)

    tok = None
    try:
        os.environ.setdefault("HF_HUB_OFFLINE", "1")   # local files only
        from transformers import AutoTokenizer
        tok = AutoTokenizer.from_pretrained(args.tokenizer
                                            or args.model_path)
        ids = np.asarray(tok(args.prompt).input_ids, dtype=np.int64)[None]
    except Exception as e:  # no tokenizer: byte ids
        print(f"tokenizer unavailable ({e}); using byte-ish ids",
              file=sys.stderr)
        ids = np.frombuffer(args.prompt.encode()[:64], dtype=np.uint8
                            ).astype(np.int64)[None] % cfg.vocab_size
    prompt = torch.from_numpy(ids)
    kw = dict(temperature=args.temperature, top_k=args.top_k,
              cache_len=args.cache_len, dtype=_dtype(args.dtype),
              device=args.device, kv_quantized=args.kv_quantized)

    def gen(seed):
        return torch.Generator(args.device).manual_seed(seed)

    def sync():
        if torch.device(args.device).type == "cuda":
            torch.cuda.synchronize()

    if args.stream:
        t0 = time.time()
        pieces = [ids]
        for chunk in generate_stream(cfg, model, prompt, args.max_new_tokens,
                                     chunk=args.stream_chunk,
                                     generator=gen(args.seed), **kw):
            pieces.append(chunk)
            if tok is not None:
                print(tok.decode(chunk[0].tolist()), end="", flush=True)
            else:
                print(" ".join(map(str, chunk[0].tolist())), end=" ",
                      flush=True)
        print()
        n_new = np.concatenate(pieces, axis=1).shape[1] - ids.shape[1]
        print(f"[streamed {n_new} tokens in {time.time() - t0:.2f}s incl. "
              "graph captures]", file=sys.stderr)
        return

    t0 = time.time()
    out = generate(cfg, model, prompt, args.max_new_tokens,
                   generator=gen(args.seed), **kw)
    sync()
    n_new = out.shape[1] - ids.shape[1]
    print(f"[{n_new} tokens in {time.time() - t0:.2f}s incl. graph "
          "captures]", file=sys.stderr)

    # timed second run
    t0 = time.time()
    out = generate(cfg, model, prompt, args.max_new_tokens,
                   generator=gen(args.seed + 1), **kw)
    sync()
    dt = time.time() - t0
    print(f"throughput: {n_new / dt:.1f} tokens/s", file=sys.stderr)

    if tok is not None:
        print(tok.decode(out[0].tolist()))
    else:
        print(out[0].tolist())


if __name__ == "__main__":
    main()
