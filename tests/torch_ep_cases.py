"""Rank-side cases of ``tests/test_torch_ep.py`` and
``tests/test_torch_multihost.py`` (and the routes of
``tests/test_torch_ep_train.py``), run on the gloo ranks of
``tests/torch_tp_cases.py`` ``Ranks`` as ``Ranks.run("torch_ep_cases:<fn>",
...)``, and the spawned processes of the multihost join test. They import
torch and the port only (no JAX).
"""
from __future__ import annotations

import contextlib
import os

import torch

import torch_tp_cases as C


def mesh_layout(meshes, dp, ep, tp):
    """This rank's place on the (dp, ep, tp) mesh and its groups' ranks."""
    m = C.get_mesh(meshes, dp, tp, ep)
    return dict(coords=m.coords, tp_ranks=m.tp_ranks, ep_ranks=m.ep_ranks,
                replica_ranks=m.replica_ranks, axis_names=m.axis_names,
                shape=m.shape, tp_is_replica=m.replica_group is m.tp_group)


@contextlib.contextmanager
def recorded_topk(cfg):
    """Every MoE call's top-K expert ids (the router's output) in a list,
    by wrapping the routes ``models/llama.py`` ``moe_apply`` takes."""
    from quip_for_all_tpu_torch.models import llama as L
    seen = []
    saved = L.moe_dense_stacked_apply, L.moe_sparse_apply

    def wrap(fn):
        def run(cfg_, moe_p, x, router_logits, **kw):
            seen.append(torch.topk(router_logits.to(torch.float32),
                                   cfg.num_experts_per_tok,
                                   dim=-1).indices.numpy())
            return fn(cfg_, moe_p, x, router_logits, **kw)
        return run
    L.moe_dense_stacked_apply, L.moe_sparse_apply = map(wrap, saved)
    try:
        yield seen
    finally:
        L.moe_dense_stacked_apply, L.moe_sparse_apply = saved


def forward_topk(meshes, cfg, path, ids, dp, ep, tp, cached_steps,
                 linear_kw=None):
    """``torch_tp_cases.forward`` on the (dp, ep, tp) mesh, with every MoE
    call's top-K ids: (logits, collectives, plane bytes, top-K ids)."""
    with recorded_topk(cfg) as seen:
        out = C.forward(meshes, cfg, path, ids, dp, tp, torch.float32,
                        cached_steps, linear_kw, ep)
    return out + (seen,)


def moe_layer(meshes, cfg, path, layer, x, dp, ep, tp):
    """Block ``layer``'s MoE of the rank's model on x (B, S, D) in f32
    compute: (output, collectives, (expert offset, experts held), the
    block's type name)."""
    from quip_for_all_tpu_torch.models.llama import linear_apply, moe_apply
    from quip_for_all_tpu_torch.parallel import comm
    from quip_for_all_tpu_torch.parallel.sharding import shard_params
    model = shard_params(cfg, C._load(path), C.get_mesh(meshes, dp, tp, ep))
    moe = model.layers[layer]["block_sparse_moe"]
    x = torch.as_tensor(x)
    comm.reset_counts()
    with torch.no_grad():
        out = moe_apply(cfg, moe, x, {"compute_dtype": torch.float32})
        logits = linear_apply(moe["gate"], x)
    held = moe["experts_stacked"]["w13"].E
    return (out.numpy(), comm.counts(), (getattr(moe, "offset", 0), held),
            type(moe).__name__, logits.numpy())


def expert_linears(meshes, cfg, path, dp, ep, tp):
    """Layer 0's expert 0 (an unstacked model): its w1's and w2's types
    and the planes each keeps (q_out, q_in)."""
    from quip_for_all_tpu_torch.parallel.sharding import shard_params
    model = shard_params(cfg, C._load(path), C.get_mesh(meshes, dp, tp, ep))
    e0 = model.layers[0]["block_sparse_moe"]["experts"][0]
    return {k: (type(e0[k]).__name__, e0[k].local.q_out, e0[k].local.q_in)
            for k in ("w1", "w3", "w2")}


def hybrid(meshes, dcn_dp, ici_tp, ici_ep, group_ranks=None):
    """``make_hybrid_mesh`` on this group, with torchrun's GROUP_RANK set
    to ``group_ranks[rank]`` where given: the mesh's axes, shape, this
    rank's place and groups, and its topology label."""
    import torch.distributed as dist
    from quip_for_all_tpu_torch.parallel.multihost import (make_hybrid_mesh,
                                                           mesh_topology)
    if group_ranks is not None:
        os.environ["GROUP_RANK"] = str(group_ranks[dist.get_rank()])
    try:
        m = make_hybrid_mesh(dcn_dp, ici_tp, ici_ep)
    finally:
        os.environ.pop("GROUP_RANK", None)
    return dict(axis_names=m.axis_names, shape=m.shape, coords=m.coords,
                tp_ranks=m.tp_ranks, ep_ranks=m.ep_ranks,
                replica_ranks=m.replica_ranks, topology=mesh_topology(m))


def hybrid_decode(meshes, cfg, path, tok, pos, dcn_dp, ici_tp):
    """One f32 decode step of the rank's model on the hybrid (dcn_dp,
    ici_tp) mesh, the batch split over "dp" (this rank's dp index takes
    its rows of ``tok``): (its rows' logits, its dp index)."""
    from quip_for_all_tpu_torch.models.registry import rank_config
    from quip_for_all_tpu_torch.parallel.multihost import make_hybrid_mesh
    from quip_for_all_tpu_torch.parallel.sharding import shard_params
    from quip_for_all_tpu_torch.runtime.generate import (decode_step_fn,
                                                         init_kv_caches)
    key = ("hybrid", dcn_dp, ici_tp)
    if key not in meshes:
        meshes[key] = make_hybrid_mesh(dcn_dp, ici_tp)
    mesh = meshes[key]
    model = shard_params(cfg, C._load(path), mesh)
    n = len(tok) // mesh.dp
    mine = torch.as_tensor(tok[mesh.dp_rank * n:(mesh.dp_rank + 1) * n])
    caches = init_kv_caches(rank_config(cfg, model), n, 64, torch.float32,
                            "cpu")
    step = decode_step_fn(cfg, dtype=torch.float32,
                          linear_kw={"compute_dtype": torch.float32})
    logits, _ = step(model, caches, mine, pos)
    return logits.numpy(), mesh.dp_rank


def joined(meshes):
    """A rank of a ``Ranks(world, join="env")`` group: (its rank,
    ``initialize``'s return, an all_reduce of rank + 1, the hybrid mesh's
    default dcn_dp and tp)."""
    import torch.distributed as dist
    from quip_for_all_tpu_torch.parallel.multihost import make_hybrid_mesh
    t = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(t)
    mesh = make_hybrid_mesh()
    return dist.get_rank(), meshes["initialize"], float(t), mesh.dp, mesh.tp


@contextlib.contextmanager
def recorded_routes():
    """The route of every ``models/llama.py`` ``moe_apply`` call from now
    on, in a list: ("dense_stacked", 0), ("sparse", 0) or ("loop", n),
    n the experts the dense masked loop ran (two unstacked views an
    expert)."""
    from quip_for_all_tpu_torch.models import llama as L
    calls, seen = [], []
    saved = (L.moe_apply, L.moe_dense_stacked_apply, L.moe_sparse_apply,
             L.unstack_qlinear)

    def tag(fn, name):
        def run(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return run

    def moe(*a, **k):
        calls.clear()
        out = saved[0](*a, **k)
        if "dense_stacked" in calls or "sparse" in calls:
            seen.append((calls[0], 0))
        else:
            seen.append(("loop", calls.count("unstack") // 2))
        return out
    L.moe_apply = moe
    L.moe_dense_stacked_apply = tag(saved[1], "dense_stacked")
    L.moe_sparse_apply = tag(saved[2], "sparse")
    L.unstack_qlinear = tag(saved[3], "unstack")
    try:
        yield seen
    finally:
        (L.moe_apply, L.moe_dense_stacked_apply, L.moe_sparse_apply,
         L.unstack_qlinear) = saved


def moe_routes(meshes, cfg, path, layer, xs, g, dp, ep, tp):
    """Block ``layer``'s MoE of the rank's model in f32 compute on each x
    of ``xs`` {name: (B, S, D)}, as each name says: "eval" without
    gradients, "eval_grad" with x requiring them (a LoRA step's forward),
    "train" the training forward (``linear_kw["training"]``) with x
    requiring them. Returns {name: (route, output, the gradients of
    sum(output * g[name]) at x and at the router's weight, or None
    without gradients, the collectives of the forward and backward)}."""
    from quip_for_all_tpu_torch.models import llama as L
    from quip_for_all_tpu_torch.parallel import comm
    from quip_for_all_tpu_torch.parallel.sharding import shard_params
    from quip_for_all_tpu_torch.quantize import finetune as FT
    model = shard_params(cfg, C._load(path), C.get_mesh(meshes, dp, tp, ep))
    moe = model.layers[layer]["block_sparse_moe"]
    out = {}
    for name, x in xs.items():
        flat = FT.collect_trainable(moe, "moe")
        FT.apply_trainable(moe, flat, "moe")
        kw = {"compute_dtype": torch.float32}
        if name == "train":
            kw["training"] = True
        x = torch.as_tensor(x).requires_grad_(name != "eval")
        comm.reset_counts()
        with recorded_routes() as seen, torch.set_grad_enabled(
                name != "eval"):
            y = L.moe_apply(cfg, moe, x, kw)
            grads = None
            if name != "eval":
                (y * torch.as_tensor(g[name])).sum().backward()
                grads = (x.grad.numpy(), flat["moe.gate.weight"].grad.numpy())
        out[name] = (seen, y.detach().numpy(), grads, comm.counts())
    return out
