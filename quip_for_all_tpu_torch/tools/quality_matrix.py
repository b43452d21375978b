"""The quantization-quality matrix on trained tiny models, driven through
the port's public CLIs — counterpart of the JAX package's
``tools/quality_matrix.py``, on the card by default:

    python -m quip_for_all_tpu_torch.tools.quality_matrix [--fast] [--mid]
    python -m quip_for_all_tpu_torch.tools.quality_matrix --fast \
        --device cpu --out /tmp/q/QUALITY_TORCH.md

JAX's recipe: train tiny llamas (``init_llama_params``, the JAX package's
numpy draws) on the synthetic Markov stream (4096 windows of 32, seed 11)
with Adam at 2e-3, batch 16, 3 epochs, export them with
``utils/hf_import.py`` ``save_hf_model``, then for every cell run

    python -m quip_for_all_tpu_torch.cli.quantize --model-path <hf_dir> ...
    python -m quip_for_all_tpu_torch.cli.eval_ppl --model-path <ckpt> ...

as subprocesses, each under the chip lock (``utils/chiplock.py``; none on
the CPU). Models: main (d=128; the five codebooks, ``ft``, ``merge_suv``,
``tp2``, and the teacher-forced ppl through an f32 and an int8 KV cache),
stress (d=64; the five codebooks: its 64-wide linears take the dense route
under the widths rule, ``ops/fused_matmul.py`` ``supports``), ``--mid``
(d=512, 4 layers; main's cells), ``--fast`` (E8P12 on main only). Every
cell reports the held-out ppl (seed 2) and the train-window ppl (seed 11);
calibration draws seed 0.

Writes ``--out`` (default ``docs/QUALITY_TORCH.md``) and the JSON beside
it (``.json``), never the JAX package's files; each table names the
device (on the card its ``nvidia-smi`` name and power limit) and the
seconds taken, with the JAX package's CPU numbers (``docs/QUALITY.json``)
beside each cell.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CODEBOOKS = ("E8P12", "D4", "HI", "E8P12RVQ3B", "E8P12RVQ4B")
BITS = {"E8P12": 2, "D4": 2, "HI": 4, "E8P12RVQ3B": 3, "E8P12RVQ4B": 4}

TRAIN_SEED = 11   # training stream; the train-window eval reuses it
EVAL_SEED = 2     # held-out eval draw
CALIB_SEED = 0    # quantizer calibration draw
TRAIN_N, SEQ, BATCH, LR, EPOCHS = 4096, 32, 16, 2e-3, 3
MAIN_D, STRESS_D, MID_D, MID_LAYERS = 128, 64, 512, 4


def log(*a):
    print("#", *a, file=sys.stderr, flush=True)


def trainable(model) -> List[torch.Tensor]:
    """Every float weight of a dense model (the JAX tree's leaves), set to
    require gradients."""
    leaves = [b for b in model.buffers() if b.is_floating_point()]
    for b in leaves:
        b.requires_grad_(True)
    return leaves


def causal_loss(cfg, model, ids: torch.Tensor) -> torch.Tensor:
    """JAX's ``loss_fn``: the mean next-token cross entropy of the f32
    logits."""
    from ..models.llama import model_apply
    logits, _ = model_apply(cfg, model, ids)
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    return -torch.gather(logp, -1, ids[:, 1:, None]).mean()


def fit(cfg, model, data: np.ndarray, epochs: int = EPOCHS,
        batch: int = BATCH, lr: float = LR) -> float:
    """JAX's training loop: ``epochs`` passes over ``data`` in order, in
    batches of ``batch``, Adam (optax.adam's defaults) at ``lr``; returns
    the last batch's loss. The model's weights stay trained and stop
    requiring gradients."""
    from ..models.registry import model_device
    dev = model_device(model)
    leaves = trainable(model)
    opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    loss = None
    try:
        for _ in range(epochs):
            for i in range(0, data.shape[0], batch):
                ids = torch.as_tensor(data[i:i + batch], dtype=torch.int64,
                                      device=dev)
                opt.zero_grad(set_to_none=True)
                loss = causal_loss(cfg, model, ids)
                loss.backward()
                opt.step()
    finally:
        for b in leaves:
            b.requires_grad_(False)
            b.grad = None
    return float(loss.detach())


def train_tiny(workdir: str, hidden: int, layers: int = 2,
               device="cuda"):
    """Train a tiny llama (JAX's recipe) and export it as an HF
    checkpoint; returns (cfg, model, hf_dir)."""
    from ..data.calibration import synthetic_tokens
    from ..models.config import tiny_config
    from ..models.llama import init_llama_params
    from ..utils.hf_import import save_hf_model
    cfg = tiny_config(num_hidden_layers=layers, hidden_size=hidden,
                      intermediate_size=2 * hidden)
    model = init_llama_params(cfg, seed=0, device=device)
    data = synthetic_tokens(TRAIN_N, SEQ, cfg.vocab_size, seed=TRAIN_SEED)
    loss = fit(cfg, model, data, epochs=EPOCHS)
    log(f"d={hidden}: final train loss {loss:.3f}")
    hf_dir = os.path.join(workdir, f"trained_tiny_d{hidden}_l{layers}_hf")
    save_hf_model(cfg, model, hf_dir)
    return cfg, model, hf_dir


def run_cli(mod: str, argv: list, device: str,
            timeout_s: float = 2400.0) -> str:
    """``python -m quip_for_all_tpu_torch.cli.<mod> argv --device`` from
    the repository root, under the chip lock; its stdout."""
    from ..utils.chiplock import chip_lock
    with chip_lock(device=device):
        proc = subprocess.run(
            [sys.executable, "-m", f"quip_for_all_tpu_torch.cli.{mod}"]
            + argv + ["--device", device], capture_output=True, text=True,
            timeout=timeout_s, cwd=ROOT)
    if proc.returncode != 0:
        raise RuntimeError(f"{mod} {argv} failed:\n"
                           + proc.stdout[-2000:] + proc.stderr[-2000:])
    return proc.stdout


def eval_args(seed: int) -> list:
    return ["--dataset", "synthetic", "--nsamples", "16", "--seqlen",
            str(SEQ), "--batch-size", "8", "--seed", str(seed)]


def eval_both(ckpt: str, device: str) -> Tuple[float, float]:
    """(held-out ppl, train-window ppl) through the eval_ppl CLI."""
    out = [run_cli("eval_ppl", ["--model-path", ckpt] + eval_args(s),
                   device) for s in (EVAL_SEED, TRAIN_SEED)]
    return tuple(json.loads(o.strip().splitlines()[-1])["ppl"] for o in out)


def fp_ppl_both(cfg, model, device) -> Tuple[float, float]:
    """The float model's ppl on both draws (in this process: it has no
    quantized checkpoint for eval_ppl to load)."""
    from ..data.calibration import synthetic_tokens
    from ..runtime.generate import perplexity
    return tuple(float(perplexity(
        cfg, model, synthetic_tokens(16, SEQ, cfg.vocab_size, seed=s),
        batch_size=8, device=device)) for s in (EVAL_SEED, TRAIN_SEED))


@torch.no_grad()
def kv_ppl_both(ckpt: str, quantized: bool, device="cuda"
                ) -> Tuple[float, float]:
    """Teacher-forced ppl through the KV cache (f32, or int8 with
    ``quantized``: ``models/common.py`` ``QuantKVCache``), written at
    position 0 by the whole window: the decode path's cache quality,
    which a cache-free forward cannot see. JAX's ``kv_ppl_both``."""
    from ..data.calibration import synthetic_tokens
    from ..models.registry import get_arch
    from ..runtime.generate import init_kv_caches
    from ..utils.checkpoint import load_quantized
    cfg, model, _ = load_quantized(ckpt, device=device)
    model_apply = get_arch(cfg).model_apply
    res = []
    for seed in (EVAL_SEED, TRAIN_SEED):
        toks = synthetic_tokens(16, SEQ, cfg.vocab_size, seed=seed)
        losses = []
        for i in range(0, 16, 8):
            batch = torch.as_tensor(toks[i:i + 8], dtype=torch.int64,
                                    device=device)
            B, S = batch.shape
            caches = init_kv_caches(cfg, B, S, dtype=torch.float32,
                                    device=device, quantized=quantized)
            pos = torch.arange(S, device=device)[None, :].repeat(B, 1)
            logits, _ = model_apply(cfg, model, batch, positions=pos,
                                    kv_caches=caches, cache_position=0,
                                    dtype=torch.float32)
            logp = torch.log_softmax(logits[:, :-1].to(torch.float32), -1)
            losses.append(float(-torch.gather(
                logp, -1, batch[:, 1:, None]).mean()))
        res.append(float(np.exp(np.mean(losses))))
    return tuple(res)


def device_line(device: str) -> str:
    """The card's ``nvidia-smi`` name and power limit, or "CPU"."""
    if torch.device(device).type != "cuda":
        return "CPU"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def jax_numbers() -> dict:
    """The JAX package's matrix (``docs/QUALITY.json``), or {} where the
    checkout has none."""
    path = os.path.join(ROOT, "docs", "QUALITY.json")
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        return json.load(f)


def build_matrix(tag: str, hidden: int, variants: bool, args,
                 layers: int = 2) -> dict:
    """One model's cells: {"fp32": (held, train), "rows": [(codebook,
    variant, held, train, seconds)], "seconds": the model's total}."""
    t_model = time.time()
    dev = args.device
    cfg, model, hf_dir = train_tiny(args.workdir, hidden, layers=layers,
                                    device=dev)
    fp = fp_ppl_both(cfg, model, dev)
    del model
    log(f"d={hidden}: fp32 ppl held-out {fp[0]:.3f} train-win {fp[1]:.3f}")
    base_q = ["--dataset", "synthetic", "--nsamples", "32", "--seqlen",
              str(SEQ), "--batch-size", "8", "--quip-tune-iters", "2",
              "--seed", str(CALIB_SEED)]
    rows = []

    def cell(cb: str, variant: str, extra: list) -> None:
        ckpt = os.path.join(args.workdir, f"{tag}_{cb}_{variant}")
        t0 = time.time()
        run_cli("quantize", ["--model-path", hf_dir, "--save-dir", ckpt,
                             "--codebook", cb] + base_q + extra, dev)
        ph, pt = eval_both(ckpt, dev)
        rows.append((cb, variant, ph, pt, time.time() - t0))
        log(f"{tag} {cb:11s} {variant:9s} held {ph:8.3f} train {pt:8.3f} "
            f"({time.time() - t0:.0f}s)")

    for cb in CODEBOOKS[:1] if args.fast else CODEBOOKS:
        cell(cb, "base", [])
    if variants and not args.fast:
        cell("E8P12", "ft", ["--ft-epochs", "2", "--ft-train-size", "24",
                             "--ft-valid-size", "8"])
        cell("E8P12", "merge_suv", ["--merge-suv"])
        cell("E8P12", "tp2", ["--tp-shards", "2"])
        base_ckpt = os.path.join(args.workdir, f"{tag}_E8P12_base")
        for name, quantized in (("kv_bf16ref", False), ("kv_int8", True)):
            t0 = time.time()
            rows.append(("E8P12", name, *kv_ppl_both(base_ckpt, quantized,
                                                     dev), time.time() - t0))
        log("kv cells done")
    return {"fp32": fp, "rows": rows, "seconds": time.time() - t_model}


def table(m: dict, jax_rows: Optional[list], jax_fp: Optional[list]
          ) -> List[str]:
    fp_h, fp_t = m["fp32"]
    jx = {(c, v): (h, t) for c, v, h, t in (jax_rows or [])}
    jfp = (f" (JAX package, CPU: {jax_fp[0]:.3f} / {jax_fp[1]:.3f})"
           if jax_fp else "")
    out = [f"**fp32 reference ppl: held-out {fp_h:.3f} / train-window "
           f"{fp_t:.3f}**{jfp} (vocab 256; uniform = 256); this model's "
           f"cells took {m['seconds']:.1f} s", "",
           "| codebook | bits | variant | held-out ppl | × fp32 | "
           "train-win ppl | × fp32 | JAX held-out | JAX train-win | s |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for cb, variant, ph, pt, s in m["rows"]:
        jh, jt = jx.get((cb, variant), (None, None))
        jtxt = (f"{jh:.3f} | {jt:.3f}" if jh is not None
                else "not run | not run")
        out.append(f"| {cb} | {BITS[cb]} | {variant} | {ph:.3f} | "
                   f"{ph / fp_h:.3f} | {pt:.3f} | {pt / fp_t:.3f} | {jtxt} "
                   f"| {s:.1f} |")
    return out


def write(args, where: str, seconds: float, results: dict) -> dict:
    """The markdown table at ``args.out`` and the JSON beside it; returns
    the JSON payload."""
    jax = jax_numbers()
    lines = [
        "# QUALITY_TORCH — the quantization-quality matrix of the PyTorch "
        "port (trained tiny models, CLI-level)", "",
        f"Generated by `python -m quip_for_all_tpu_torch.tools."
        f"quality_matrix{' --fast' if args.fast else ''}"
        f"{' --mid' if args.mid else ''}` on **{where}** "
        f"({seconds:.1f} s in all). The recipe is the JAX package's "
        "(`tools/quality_matrix.py`, its table `docs/QUALITY.md`): tiny "
        "llamas trained on the synthetic Markov stream, exported as HF "
        "checkpoints and driven through the port's CLIs:", "",
        "    python -m quip_for_all_tpu_torch.cli.quantize --model-path "
        "<trained_hf> --save-dir <ckpt> --codebook <CB> --dataset "
        "synthetic --nsamples 32 --seqlen 32 --quip-tune-iters 2",
        "    python -m quip_for_all_tpu_torch.cli.eval_ppl --model-path "
        "<ckpt> --dataset synthetic --nsamples 16 --seqlen 32 --seed "
        "<2|11>", "",
        "Calibration draw: seed 0. **held-out**: the seed-2 draw; "
        "**train-window**: the seed-11 training draw. kv_int8 is the "
        "teacher-forced ppl through an int8 KV cache, kv_bf16ref the same "
        "forward through an f32 cache (JAX's name). The JAX columns are "
        "the JAX package's own CPU run of the same recipe "
        "(`docs/QUALITY.json`): its trained weights differ from the "
        "port's by the two frameworks' rounding, so the columns agree in "
        "band, not digit for digit.", ""]
    titles = {"main": f"Main matrix — d={MAIN_D}",
              "stress": f"Stress matrix — d={STRESS_D} (its {STRESS_D}-wide "
                        "linears take the dense route under the widths "
                        "rule; the head and the MLP's wider outputs take "
                        "the kernels)",
              "mid": f"Mid matrix — d={MID_D}, {MID_LAYERS} layers"}
    payload = {"device": where, "seconds": round(seconds, 1)}
    for key, m in results.items():
        lines += [f"## {titles[key]}", ""] + table(
            m, jax.get(key), jax.get(f"{key}_fp32")) + [""]
        payload[key] = [(c, v, round(ph, 3), round(pt, 3))
                        for c, v, ph, pt, _ in m["rows"]]
        payload[f"{key}_fp32"] = [round(x, 3) for x in m["fp32"]]
        payload[f"{key}_seconds"] = round(m["seconds"], 1)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines))
    with open(os.path.splitext(args.out)[0] + ".json", "w") as f:
        json.dump(payload, f, indent=1)
    log(f"wrote {args.out}")
    return payload


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "docs",
                                                  "QUALITY_TORCH.md"))
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "qfa_torch_quality"))
    ap.add_argument("--fast", action="store_true",
                    help="E8P12 on the main model only (a wiring check)")
    ap.add_argument("--mid", action="store_true",
                    help="also the d=512, 4-layer model")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from ..utils.device import resolve_device
    resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)
    t0 = time.time()
    where = device_line(args.device)
    results = {"main": build_matrix("main", MAIN_D, True, args)}
    if not args.fast:
        results["stress"] = build_matrix("stress", STRESS_D, False, args)
    if args.mid:
        results["mid"] = build_matrix("mid", MID_D, True, args,
                                      layers=MID_LAYERS)
    payload = write(args, where, time.time() - t0, results)
    print(json.dumps(payload))
    return payload


if __name__ == "__main__":
    main()
