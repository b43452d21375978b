"""The port's multi-rank dry run: the counterpart of the JAX package's
``__graft_entry__.py`` ``dryrun_multichip`` (its phases 1-5) on n gloo
ranks, spawned here, each joining through ``parallel/multihost.py``
``initialize`` from torchrun's environment variables:

  phase 1 (every n): the tiny f32 llama over a ``make_mesh(dp=2 if n is
    even else 1, tp=n // dp)`` mesh (``shard_params``), one end-to-end
    finetune step (``quantize/finetune.py`` ``make_train_step``: the
    training forward, two-LR Adam at 5e-4 / 5e-5) on 4 x 16 ids, each dp
    rank its half; the loss equal on every rank and within the tolerance
    of one rank's step on the whole model and batch, printed in the JAX
    dry run's line;
  phase 2 (n even, n >= 4): a hybrid dcn_dp=2 x ici_tp=n/2 mesh, one f32
    decode step of a tiny GQA Llama (kv heads n/2, sharded over tp), the
    batch split over dp, against one rank's step on the whole model;
  phase 3 (n >= 4): ``pipeline_logits`` over pp(2) and
    ``sequence_parallel_logits`` over sp(4) agree on each rank's chunk;
  phase 4 (n >= 8): a tiny Mixtral (E = 4, top-2, stacked experts) at ep
    = n/2 x tp = 2, one f32 decode step against the one-rank model's
    sparse route;
  phase 5 (n >= 2): a tp = 2 ``ServingEngine(mesh=)`` on ranks 0 and 1
    serves 2 requests, their ids equal to the one-rank engine's.

Each phase prints one line; a phase that fails makes the run exit 1.

    python -m quip_for_all_tpu_torch.tools.dryrun_multichip [n] \
        [--device cpu|cuda]

On the card every rank runs on cuda:(rank mod the card count).
"""
from __future__ import annotations

import argparse
import os
import sys
import time
import traceback

import numpy as np
import torch

# logits (and the finetune step's loss) within 1e-4 of max|logit| plus
# one f32 ulp (f32 compute)
TOL = 1e-4


def _tiny(arch="llama", heads=4, kv_heads=2, **kw):
    """The JAX dry run's ``_tiny_quant_model`` shape: 2 layers, hidden
    256, intermediate 512, vocab 512."""
    from ..models.config import ModelConfig
    return ModelConfig(arch=arch, vocab_size=512, hidden_size=256,
                       intermediate_size=512, num_hidden_layers=2,
                       num_attention_heads=heads,
                       num_key_value_heads=kv_heads,
                       max_position_embeddings=256, **kw)


def _model(cfg, dev):
    import quip_for_all_tpu_torch as qt
    return qt.fuse_for_inference(cfg, qt.random_quantized_model(
        cfg, codebook="E8P12", seed=0, dtype=torch.float32, device=dev))


F32 = {"compute_dtype": torch.float32}


def _max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| beyond the tolerance's scale, as a
    fraction of max|want| (<= TOL passes, with one ulp of slack), over
    every rank (an all_reduce of the maximum)."""
    import torch.distributed as dist
    got, want = got.float(), want.float()
    ulp = torch.finfo(torch.float32).eps * want.abs()
    err = ((got - want).abs() - ulp).clamp_min(0).max() / want.abs().max()
    t = torch.tensor([float(err)])
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def _decode(cfg, model, tok, pos, dev):
    from ..models.registry import rank_config
    from ..runtime.generate import decode_step_fn, init_kv_caches
    caches = init_kv_caches(rank_config(cfg, model), tok.shape[0], 64,
                            torch.float32, dev)
    step = decode_step_fn(cfg, dtype=torch.float32, linear_kw=F32)
    return step(model, caches, tok, pos)[0]


def _ft_step(cfg, model, ids, tgt, mesh=None):
    """One end-to-end finetune step of ``model`` (whole, or a rank's with
    its ``mesh``): (loss, the rank's trainable leaves after it)."""
    from ..quantize import finetune as FT
    flat = FT.collect_trainable(model)
    FT.apply_trainable(model, flat)
    opt = FT.make_susv_optimizer(5e-4, 5e-5, flat)
    step = FT.make_train_step(
        opt, lambda i: FT.student_logits(cfg, model, i), mesh=mesh)
    return float(step(ids, tgt)), flat


def phase1(n, dev):
    import quip_for_all_tpu_torch as qt
    from ..parallel.sharding import make_mesh, shard_params
    cfg = _tiny()

    def whole():
        # unfused, as the JAX dry run's model
        return qt.random_quantized_model(cfg, codebook="E8P12", seed=0,
                                         dtype=torch.float32, device=dev)
    B, S = 4, 16
    ids = torch.as_tensor(np.arange(B * S).reshape(B, S) % cfg.vocab_size,
                          device=dev)
    tgt = torch.roll(ids, -1, dims=1)
    with torch.enable_grad():
        ref, _ = _ft_step(cfg, whole(), ids, tgt)
        dp = 2 if n % 2 == 0 else 1
        mesh = make_mesh(dp=dp, tp=n // dp)
        model = shard_params(cfg, whole(), mesh)
        loss, flat = _ft_step(cfg, model, ids, tgt, mesh)
    import torch.distributed as dist
    losses = [None] * n
    dist.all_gather_object(losses, loss)
    err = abs(loss - ref) / abs(ref)
    if not (np.isfinite(loss) and len(set(losses)) == 1 and err <= TOL):
        raise AssertionError(f"finetune step: the ranks' losses {losses}, "
                             f"one rank's {ref}")
    return (f"dryrun_multichip({n}): mesh={mesh.shape} loss={loss:.4f} "
            f"trainable_leaves={len(flat)}")


def phase2(n, dev):
    from ..parallel.multihost import make_hybrid_mesh, mesh_topology
    from ..parallel.sharding import shard_params
    cfg = _tiny(heads=8, kv_heads=n // 2)
    whole = _model(cfg, dev)
    mesh = make_hybrid_mesh(dcn_dp=2, ici_tp=n // 2)
    model = shard_params(cfg, whole, mesh)
    tok = torch.tensor([3, 5], device=dev)
    ref = _decode(cfg, whole, tok, 5, dev)
    d = mesh.dp_rank
    got = _decode(cfg, model, tok[d:d + 1], 5, dev)
    err = _max_err(got, ref[d:d + 1])
    if not (torch.isfinite(got).all() and err <= TOL):
        raise AssertionError(f"hybrid decode off one rank's by {err:.3g}")
    return (f"dryrun_multichip hybrid: {mesh_topology(mesh)} decode "
            f"logits {tuple(ref.shape)} ok (the batch over dp, kv heads "
            f"{cfg.num_key_value_heads} over tp; {err:.3g} of max|logit| "
            "from one rank's)")


def phase3(n, dev):
    from ..parallel.pipeline import make_pp_mesh, pipeline_logits
    from ..parallel.sequence import make_sp_mesh, sequence_parallel_logits
    cfg = _tiny()
    model = _model(cfg, dev)
    ids = torch.as_tensor(np.arange(2 * 16).reshape(2, 16) % cfg.vocab_size,
                          device=dev)
    lp = pipeline_logits(cfg, model, ids, make_pp_mesh(2), n_microbatches=2,
                         linear_kw=F32)
    sp = make_sp_mesh(4)
    ls = sequence_parallel_logits(cfg, model, ids, sp, linear_kw=F32)
    w = ids.shape[1] // sp.size
    mine = lp[:, sp.index * w:(sp.index + 1) * w]
    err = _max_err(ls, mine)
    if not (torch.isfinite(lp).all() and err <= TOL):
        raise AssertionError(f"sp(4) logits off pp(2)'s by {err:.3g}")
    return (f"dryrun_multichip pp(2) and sp(4) logits {tuple(lp.shape)} "
            f"agree ok ({err:.3g} of max|logit|)")


def phase4(n, dev):
    from ..parallel.sharding import make_mesh, shard_params
    cfg = _tiny(arch="mixtral", num_local_experts=4, num_experts_per_tok=2)
    whole = _model(cfg, dev)
    tok = torch.tensor([3, 5], device=dev)
    ref = _decode(cfg, whole, tok, 2, dev)          # the sparse route
    mesh = make_mesh(dp=1, tp=2, ep=n // 2)
    model = shard_params(cfg, whole, mesh)
    got = _decode(cfg, model, tok, 2, dev)
    err = _max_err(got, ref)
    if not (torch.isfinite(got).all() and err <= TOL):
        raise AssertionError(f"ep decode off the sparse route by {err:.3g}")
    return (f"dryrun_multichip ep: mixtral ep={n // 2} x tp=2 decode parity "
            f"vs sparse loop ok {tuple(got.shape)} ({err:.3g} of "
            "max|logit|)")


def _pair_mesh():
    """The (dp 1, tp 2) mesh of global ranks 0 and 1 (the JAX dry run's
    ``make_mesh(2, dp=1)`` on the first two devices), or None on the
    other ranks; every rank creates the group."""
    import torch.distributed as dist
    from ..parallel.sharding import Mesh
    g = dist.new_group([0, 1])
    r = dist.get_rank()
    if r > 1:
        return None
    return Mesh(dp=1, tp=2, rank=r, tp_group=g, tp_ranks=(0, 1),
                coords=(0, 0, r), ep_ranks=(r,), replica_group=g,
                replica_ranks=(0, 1))


def phase5(n, dev):
    from ..runtime.serving import ServingEngine
    cfg = _tiny()
    model = _model(cfg, dev)
    mesh = _pair_mesh()
    if mesh is None:
        return None
    kw = dict(max_batch=2, cache_len=64, dtype=torch.float32,
              prefill_chunk=8, decode_chunk=4, linear_kw=F32, device=dev)
    reqs = ([1, 2, 3], 6), ([4, 5, 6, 7], 5)
    res = {}
    for m in (None, mesh):
        eng = ServingEngine(cfg, model, mesh=m, **kw)
        rids = [eng.add_request(np.array(p, np.int32), k) for p, k in reqs]
        out = eng.run()
        res[m is None] = [out[r] for r in rids]
    lens = tuple(len(t) for t in res[False])
    same = [np.array_equal(a, b) for a, b in zip(res[False], res[True])]
    if lens != (9, 9) or not all(same):
        raise AssertionError(f"tp=2 engine: tokens {lens}, equal to one "
                             f"rank's: {same}")
    return (f"dryrun_multichip serving: tp=2 engine served 2 requests ok "
            f"({lens[0]},{lens[1]}) tokens, as one rank's engine")


# (phase, the JAX dry run's condition on n, body)
PHASES = [(1, lambda n: n >= 1, phase1),
          (2, lambda n: n % 2 == 0 and n >= 4, phase2),
          (3, lambda n: n >= 4, phase3),
          (4, lambda n: n >= 8, phase4),
          (5, lambda n: n >= 2, phase5)]


def phases_for(n: int) -> list:
    """The phases whose condition n meets, in order."""
    return [ph for ph, cond, _ in PHASES if cond(n)]


def _rank(rank, n, port, device, results):
    """One rank: torchrun's variables, ``initialize``, every phase whose
    condition n meets; {phase: (ok, line or traceback)} into
    ``results``."""
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(n), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    import torch.distributed as dist
    from ..parallel import multihost
    out = {}
    try:
        dev = torch.device("cpu")
        if device == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        multihost.initialize()
        # a phase that fails on one rank must not leave the others
        # waiting in a collective for gloo's default half hour
        dist.barrier()
        for ph, cond, body in PHASES:
            if not cond(n):
                continue
            try:
                with torch.no_grad():
                    out[ph] = (True, body(n, dev))
            except Exception:
                out[ph] = (False, traceback.format_exc())
                break
            dist.barrier()
    except Exception:
        out[0] = (False, traceback.format_exc())
    finally:
        results.put((rank, out))
        if dist.is_initialized():
            dist.destroy_process_group()


def dryrun_multichip(n: int = 8, device: str = "cuda",
                     timeout: float = 600.0) -> list:
    """Run the dry run on ``n`` spawned ranks, on the card unless
    ``device="cpu"``; returns its lines, one a phase. Raises
    ``AssertionError`` with every failing rank's traceback when a phase
    fails, and ``RuntimeError`` on ``"cuda"`` without a card."""
    import torch.multiprocessing as mp
    from ..parallel.multihost import free_port
    from ..utils.device import resolve_device
    resolve_device(device)          # raises on "cuda" without a card
    port = free_port()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, n, port, device, results),
                         daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    got = {}
    try:
        for _ in range(n):
            left = deadline - time.monotonic()
            rank, out = results.get(timeout=max(left, 1.0))
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    want = phases_for(n)
    bad = [f"rank {r} phase {ph}:\n{line}" for r, out in sorted(got.items())
           for ph, (ok, line) in out.items() if not ok]
    bad += [f"rank {r}: phase {ph} did not run" for r, out in got.items()
            for ph in want if ph not in out and not bad]
    if bad or len(got) != n:
        raise AssertionError("dryrun_multichip failed:\n" + "\n".join(bad))
    lines = []
    for ph in want:
        line = got[0][ph][1]
        lines.append(line if line is not None else f"phase {ph}: idle")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    try:
        lines = dryrun_multichip(args.n, args.device)
    except AssertionError as e:
        print(e, file=sys.stderr)
        return 1
    for line in lines:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
