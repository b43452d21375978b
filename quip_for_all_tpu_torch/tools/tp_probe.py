"""Which gloo collectives take CUDA tensors, and how long each takes,
with two ranks on one card (card only):

    python -m quip_for_all_tpu_torch.tools.tp_probe

NCCL refuses two ranks on one device, so tensor parallelism over one
card runs gloo (``parallel/comm.py``). Prints, for ``all_reduce``,
``all_gather``, ``all_gather_into_tensor``, ``broadcast``, ``send_recv``
(rank 0 to rank 1) and ``isend_irecv`` (``batch_isend_irecv``, a ring
shift) on a (1, 4096) f32 CUDA tensor, "ok", "wrong" or the error (the
point-to-point calls last: a rank that aborts in them is reported);
the host time of an ``all_reduce`` and an ``all_gather`` of (1, n) f32
at decode sizes and at the pipeline's and ring attention's shifts (50
calls after 5 warm-ups, synchronised); and the card's name and power
limit.
"""
from __future__ import annotations

import datetime
import json
import os
import subprocess
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# decode sizes, then the pipeline's shift at 512 x 4096 and ring attention's
# K/V shift at 2 x 1024 x 32 x 128 (f32, Llama-2-7B)
SIZES = (4096, 16000, 32000, 131072, 2097152, 8388608)


def _check(name: str, rank: int, world: int) -> bool:
    """Run collective ``name`` once on a (1, 4096) f32 CUDA tensor holding
    rank + 1; whether the result is right."""
    t = torch.full((1, 4096), float(rank + 1), device="cuda")
    if name == "all_reduce":
        dist.all_reduce(t)
        return float(t[0, 0]) == world * (world + 1) / 2
    if name == "all_gather":
        outs = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(outs, t)
        return float(outs[1][0, 0]) == 2.0
    if name == "all_gather_into_tensor":
        o = torch.empty((world, 4096), device="cuda")
        dist.all_gather_into_tensor(o, t)
        return float(o[1, 0]) == 2.0
    if name == "broadcast":
        dist.broadcast(t, src=0)
        return float(t[0, 0]) == 1.0
    if name == "send_recv":
        if rank == 0:
            dist.send(t, dst=1)
            return True
        dist.recv(t, src=0)
        return float(t[0, 0]) == 1.0
    o = torch.empty_like(t)                  # isend_irecv: a ring shift
    ops = [dist.P2POp(dist.isend, t, (rank + 1) % world),
           dist.P2POp(dist.irecv, o, (rank - 1) % world)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return float(o[0, 0]) == float((rank - 1) % world + 1)


def _probe(res: dict, names, rank: int, world: int) -> None:
    for name in names:
        try:
            res[name] = "ok" if _check(name, rank, world) else "wrong"
        except Exception as e:            # the probe reports what refuses
            res[name] = f"{type(e).__name__}: {str(e)[:200]}"


def _rank(rank, world, path, out):
    # a refused point-to-point call may leave its peer waiting: the group
    # gives up after a minute instead of gloo's half hour
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    torch.cuda.set_device(0)
    res = {}
    _probe(res, ("all_reduce", "all_gather", "all_gather_into_tensor",
                 "broadcast"), rank, world)
    for n in SIZES:
        t = torch.ones((1, n), device="cuda")
        outs = [torch.empty_like(t) for _ in range(world)]
        for name, call in (("all_reduce", lambda: dist.all_reduce(t)),
                           ("all_gather", lambda: dist.all_gather(outs, t))):
            if res[name] != "ok":
                continue
            for _ in range(5):
                call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                call()
            torch.cuda.synchronize()
            res[f"{name}_us_{n}"] = (time.perf_counter() - t0) / 50 * 1e6
    # last, after the results are written: on CUDA tensors gloo's
    # point-to-point calls abort the process (an H100, torch 2.11: writev
    # "Bad address", a gloo::IoException nobody catches)
    for names in ((), ("send_recv", "isend_irecv")):
        _probe(res, names, rank, world)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f, indent=1)
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("tp_probe: no CUDA card")
        return 2
    d = tempfile.mkdtemp()
    out = os.path.join(d, "r.json")
    try:
        mp.spawn(_rank, args=(2, os.path.join(d, "pg"), out), nprocs=2,
                 join=True)
    except mp.ProcessExitedException as e:   # the point-to-point abort
        print(f"a rank ended in the point-to-point calls: {e}")
    with open(out) as f:
        print(f.read())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
