"""Shared by ``tests/test_torch_tp_*.py``: a group of gloo ranks on the CPU,
spawned once per test file, that runs every case of the file, and the
cases' rank-side functions.

``Ranks(world)`` starts ``world`` processes (``torch.multiprocessing``,
spawn) that join one gloo process group through a file (or, with
``join="env"``, through ``parallel/multihost.py`` ``initialize`` from
torchrun's environment variables) and wait for tasks; ``Ranks.run(name, *args)`` runs this module's function ``name``
(or, named "module:function", that module's, e.g. ``torch_sp_cases``)
on every rank as ``name(meshes, *args)`` and returns the ranks' results
in rank order, raising with the rank's traceback if any rank failed. A
case's model crosses to the ranks as a ``torch.save`` file. The ranks
import torch and the port only (no JAX), one thread each.
"""
from __future__ import annotations

import os
import tempfile
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp


def get_mesh(meshes: dict, dp: int, tp: int, ep: int = 1):
    """The (dp, tp) mesh, or (dp, ep, tp) with ep > 1, made once per group
    (every rank makes it in the same order, as ``make_mesh`` needs)."""
    from quip_for_all_tpu_torch.parallel.sharding import make_mesh
    key = (dp, tp) if ep == 1 else (dp, ep, tp)
    if key not in meshes:
        meshes[key] = make_mesh(dp=dp, tp=tp, ep=ep)
    return meshes[key]


def _rank_loop(rank, world, init, tasks, results):
    """``init``: the group's file, or ("env", port) to join through
    ``multihost.initialize`` (its return kept as meshes["initialize"])."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    meshes: dict = {}
    if isinstance(init, tuple):
        from quip_for_all_tpu_torch.parallel.multihost import initialize
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(init[1]),
                          WORLD_SIZE=str(world), RANK=str(rank))
        meshes["initialize"] = initialize()
    else:
        dist.init_process_group("gloo", init_method=f"file://{init}",
                                rank=rank, world_size=world)
    while True:
        task = tasks.get()
        if task is None:
            break
        name, args = task
        try:
            results.put((rank, True, _task(name)(meshes, *args)))
        except Exception:
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


def _task(name: str):
    """This module's function ``name``, or "module:function" from another
    module on the tests' path."""
    if ":" not in name:
        return globals()[name]
    import importlib
    module, fn = name.split(":")
    return getattr(importlib.import_module(module), fn)


class Ranks:
    """``world`` gloo ranks waiting for tasks (module docstring)."""

    def __init__(self, world: int, join: str = "file"):
        ctx = mp.get_context("spawn")
        self.world = world
        self.dir = tempfile.mkdtemp(prefix="tp_ranks_")
        init = os.path.join(self.dir, "pg")
        if join == "env":
            from quip_for_all_tpu_torch.parallel.multihost import free_port
            init = ("env", free_port())
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_rank_loop,
                                  args=(r, world, init, self.tasks[r],
                                        self.results), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    def run(self, name: str, *args):
        for q in self.tasks:
            q.put((name, args))
        got = {}
        for _ in range(self.world):
            rank, ok, out = self.results.get(timeout=600)
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        return [got[r] for r in range(self.world)]

    def close(self):
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()


def save_model(ranks: Ranks, name: str, model) -> str:
    path = ranks.path(name + ".pt")
    torch.save(model, path)
    return path


def _load(path):
    return torch.load(path, weights_only=False)


# ------------------------------------------------------------ rank cases

def forward(meshes, cfg, path, ids, dp=1, tp=2, dtype=torch.float32,
            cached_steps=0, linear_kw=None, ep=1):
    """The sharded model's f32 logits of ``ids`` (B, S): a causal forward,
    or with ``cached_steps`` > 0 a prefill of ids[:, :-cached_steps] into
    a cache and that many one-token steps, their logits concatenated.
    Returns (logits numpy, collectives run, the rank's plane bytes)."""
    from quip_for_all_tpu_torch.models.registry import get_arch, rank_config
    from quip_for_all_tpu_torch.parallel import comm
    from quip_for_all_tpu_torch.parallel.sharding import shard_params
    from quip_for_all_tpu_torch.runtime.generate import init_kv_caches
    mesh = get_mesh(meshes, dp, tp, ep)
    model = shard_params(cfg, _load(path), mesh)
    apply = get_arch(cfg).model_apply
    ids = torch.as_tensor(ids)
    comm.reset_counts()
    with torch.no_grad():
        if not cached_steps:
            logits, _ = apply(cfg, model, ids, dtype=dtype,
                              linear_kw=linear_kw)
        else:
            B, S = ids.shape
            caches = init_kv_caches(rank_config(cfg, model), B, S + 8,
                                    dtype, "cpu")
            n0 = S - cached_steps
            pos = torch.arange(n0)[None].repeat(B, 1)
            out, _ = apply(cfg, model, ids[:, :n0], positions=pos,
                           kv_caches=caches, cache_position=0, dtype=dtype,
                           linear_kw=linear_kw)
            outs = [out]
            for t in range(n0, S):
                pos = torch.full((B, 1), t)
                out, _ = apply(cfg, model, ids[:, t:t + 1], positions=pos,
                               kv_caches=caches, cache_position=t,
                               dtype=dtype, linear_kw=linear_kw)
                outs.append(out)
            logits = torch.cat(outs, dim=1)
    planes = sum(b.numel() * b.element_size()
                 for n, b in model.named_buffers() if ".planes_" in
                 f".{n}" or n.startswith("planes_"))
    return logits.to(torch.float32).numpy(), comm.counts(), planes


def serve(meshes, cfg, path, requests, kw, dp=1, tp=2, ep=1):
    """``ServingEngine(mesh=)`` on the whole model of ``path``: each
    request (prompt, max_new_tokens) in order; returns ({rid: ids},
    collectives run, the engine's kv heads a cache)."""
    from quip_for_all_tpu_torch.parallel import comm
    from quip_for_all_tpu_torch.runtime.serving import ServingEngine
    mesh = get_mesh(meshes, dp, tp, ep)
    comm.reset_counts()
    eng = ServingEngine(cfg, _load(path), mesh=mesh, device="cpu", **kw)
    for prompt, n in requests:
        eng.add_request(np.asarray(prompt), n)
    out = eng.run()
    return out, comm.counts(), eng.caches[0][0].shape[2]


def generate(meshes, cfg, path, ids, n, kw, dp=1, tp=2, ep=1):
    """``generate`` on the rank's model of ``path`` (sharded here);
    returns (ids, f32 logits of every step)."""
    from quip_for_all_tpu_torch.parallel.sharding import shard_params
    from quip_for_all_tpu_torch.runtime.generate import generate as gen
    model = shard_params(cfg, _load(path), get_mesh(meshes, dp, tp, ep))
    out, logits = gen(cfg, model, torch.as_tensor(ids), n, device="cpu",
                      return_logits=True, **kw)
    return out.numpy(), torch.stack(logits).numpy()
