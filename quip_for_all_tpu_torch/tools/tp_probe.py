"""Which gloo collectives take CUDA tensors, and how long each takes,
with two ranks on one card (card only):

    python -m quip_for_all_tpu_torch.tools.tp_probe

NCCL refuses two ranks on one device, so tensor parallelism over one
card runs gloo (``parallel/comm.py``). Prints, for ``all_reduce``,
``all_gather``, ``all_gather_into_tensor`` and ``broadcast`` on a (1,
4096) f32 CUDA tensor, "ok", "wrong" or the error; then the host time of
an ``all_reduce`` and an ``all_gather`` of (1, n) f32 at decode sizes
(50 calls after 5 warm-ups, synchronised), and the card's name and power
limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SIZES = (4096, 16000, 32000, 131072)


def _rank(rank, world, path, out):
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            rank=rank, world_size=world)
    torch.cuda.set_device(0)
    res = {}
    for name in ("all_reduce", "all_gather", "all_gather_into_tensor",
                 "broadcast"):
        t = torch.full((1, 4096), float(rank + 1), device="cuda")
        try:
            if name == "all_reduce":
                dist.all_reduce(t)
                ok = float(t[0, 0]) == world * (world + 1) / 2
            elif name == "all_gather":
                outs = [torch.empty_like(t) for _ in range(world)]
                dist.all_gather(outs, t)
                ok = float(outs[1][0, 0]) == 2.0
            elif name == "all_gather_into_tensor":
                o = torch.empty((world, 4096), device="cuda")
                dist.all_gather_into_tensor(o, t)
                ok = float(o[1, 0]) == 2.0
            else:
                dist.broadcast(t, src=0)
                ok = float(t[0, 0]) == 1.0
            res[name] = "ok" if ok else "wrong"
        except Exception as e:            # the probe reports what refuses
            res[name] = f"{type(e).__name__}: {str(e)[:200]}"
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
    mp.spawn(_rank, args=(2, os.path.join(d, "pg"), out), nprocs=2,
             join=True)
    with open(out) as f:
        print(f.read())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
