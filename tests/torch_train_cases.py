"""Rank-side cases of ``tests/test_torch_tp_train.py``,
``tests/test_torch_tp_lora.py`` and ``tests/test_torch_ep_train.py``, run
on the gloo ranks of ``tests/torch_tp_cases.py`` as
``Ranks.run("torch_train_cases:<fn>")`` (four ranks: the (dp 2, tp 2)
mesh, dp 1 x tp 2 on each of its dp halves, or a (dp, ep, tp) mesh). The
ranks import torch and the port only.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from torch_tp_cases import _load, get_mesh

T32 = {"compute_dtype": torch.float32}


def mesh_of(meshes, dp: int, tp: int, ep: int = 1):
    """The (dp, tp) mesh on the four ranks: (2, 2) itself, or (1, 2): a
    tp group of (2, 2) alone (each dp half runs the whole batch); with ep
    > 1 the (dp, ep, tp) mesh of the four ranks."""
    if ep > 1:
        return get_mesh(meshes, dp, tp, ep)
    m = get_mesh(meshes, 2, tp)
    if dp == m.dp:
        return m
    return dataclasses.replace(m, dp=1, coords=(0, 0, m.tp_rank),
                               dp_group=None, dp_ranks=(m.rank,))


def hold_step(outs, want, tol):
    """Every rank's ``finetune_step`` against the reference (loss,
    gradients, updated leaves by the JAX package's names): the loss
    within ``tol`` of its size plus one ulp, every gradient within ``tol``
    of its max|grad| plus one ulp, the updated leaves likewise where
    |grad| exceeds that (Adam's first step is +-lr sign(g), so a
    near-zero gradient's sign, and its update, may flip); the ranks'
    losses equal."""
    wloss, wgrads, wnew = want
    for loss, grads, new, _, _ in outs:
        assert loss == outs[0][0]
        assert abs(loss - wloss) <= tol * abs(wloss) + np.spacing(
            np.float32(abs(wloss)))
        assert sorted(grads) == sorted(wgrads)
        for k, g in wgrads.items():
            assert grads[k] is not None, k
            assert grads[k].shape == g.shape, k
            assert np.all(np.isfinite(grads[k])), k
            err = np.abs(grads[k] - g)
            gtol = tol * np.abs(g).max() + np.spacing(np.abs(g).astype(
                np.float32))
            assert np.all(err <= gtol), (f"gradient of {k}", err.max(),
                                         np.abs(g).max())
            big = np.abs(g) > gtol
            err = np.abs(new[k] - wnew[k])[big]
            limit = (tol * np.abs(wnew[k]).max() + np.spacing(
                np.abs(wnew[k]).astype(np.float32)))[big]
            assert np.all(err <= limit), (k, err.max())


def _numpy(flat):
    return {k: None if v is None else v.numpy() for k, v in flat.items()}


def finetune_step(meshes, cfg, path, ids, tgt, dp, tp, lrs, ep=1):
    """One end-to-end finetune step (``quantize/finetune.py``
    ``make_train_step(mesh=)``, the training forward) of the sharded
    model of ``path`` on the whole batch (each rank its dp part), on the
    (dp, tp) mesh or with ``ep`` the (dp, ep, tp) one. Returns (loss,
    gradients and updated leaves gathered into the JAX package's names,
    the rank's leaves' shapes, the collectives of the step)."""
    from quip_for_all_tpu_torch.parallel import comm
    from quip_for_all_tpu_torch.parallel.sharding import shard_params
    from quip_for_all_tpu_torch.quantize import finetune as FT
    mesh = mesh_of(meshes, dp, tp, ep)
    model = shard_params(cfg, _load(path), mesh)
    flat = FT.collect_trainable(model)
    FT.apply_trainable(model, flat)
    opt = FT.make_susv_optimizer(*lrs, flat)
    step = FT.make_train_step(
        opt, lambda i: FT.student_logits(cfg, model, i), mesh=mesh)
    comm.reset_counts()
    loss = step(torch.as_tensor(ids), torch.as_tensor(tgt))
    counts = comm.counts()
    grads = _numpy(FT.gather_trainable(model, flat, grads=True))
    new = _numpy(FT.gather_trainable(model, flat))
    shapes = {k: tuple(v.shape) for k, v in flat.items()}
    return float(loss), grads, new, shapes, counts


def lora_step(meshes, cfg, path, toks, order, dp, tp, kw, newB, ep=1):
    """LoRA on the sharded model of ``path`` (the (dp, tp) mesh, or with
    ``ep`` the (dp, ep, tp) one): ``add_lora`` then
    ``shard_params`` (``order`` "before") or the other way ("after"),
    B set to ``newB`` (whole, by key) so that A takes gradients, every
    adapter's gradient of ``causal_lm_loss`` on ``toks`` in f32
    compute, then one step of ``train_lora`` (one epoch of the one batch,
    f32 compute) from the same adapters. Returns (loss, {key: grad},
    {key: adapter after the step}, the adapters' parallel layers' kinds,
    the step's collectives)."""
    import quip_for_all_tpu_torch.quantize.lora_train as LT
    from quip_for_all_tpu_torch.nn.lora import (add_lora,
                                                apply_lora_trainable,
                                                collect_lora_trainable)
    from quip_for_all_tpu_torch.parallel import comm
    from quip_for_all_tpu_torch.parallel.sharding import shard_params
    mesh = mesh_of(meshes, dp, tp, ep)
    model = _load(path)
    lkw = dict(rank=kw["rank"], alpha=kw["alpha"], targets=kw["targets"],
               seed=kw["seed"])
    if order == "before":
        add_lora(model, **lkw)
        apply_lora_trainable(model.layers, newB, "layers")
        model = shard_params(cfg, model, mesh)
    else:
        model = shard_params(cfg, model, mesh)
        add_lora(model, **lkw)
        apply_lora_trainable(model.layers, newB, "layers")
    flat = collect_lora_trainable(model.layers, "layers")
    ids = torch.as_tensor(toks)
    comm.reset_counts()
    loss = LT.causal_lm_loss(cfg, model, ids, T32)
    loss.backward()
    counts = comm.counts()
    grads = {k: v.grad.numpy().copy() for k, v in flat.items()}
    for v in flat.values():
        v.grad = None
    # train_lora names no compute dtype: f32, as tests/torch_lora_cases.py
    # patches it
    real = LT.causal_lm_loss
    LT.causal_lm_loss = lambda c, m, x: real(c, m, x, T32)
    try:
        LT.train_lora(cfg, model, toks, lr=kw["lr"], epochs=1,
                      batch_size=toks.shape[0], device="cpu", **lkw)
    finally:
        LT.causal_lm_loss = real
    new = {k: v.detach().numpy().copy()
           for k, v in collect_lora_trainable(model.layers,
                                              "layers").items()}
    kinds = {}
    for key in flat:
        node = model.layers
        for part in key.split(".")[1:-1]:
            node = node[int(part)] if part.isdigit() else node[part]
        kinds[key.rsplit(".", 1)[0]] = type(node).__name__ + (
            f"({type(node.lora_base).__name__})"
            if hasattr(node, "lora_base") else
            f"({type(node.local).__name__})")
    return float(loss), grads, new, kinds, counts


def comm_grads(meshes, seed):
    """The three differentiable collectives of ``parallel/comm.py`` over
    the tp group of the (2, 2) mesh, each in a small function of a
    rank's tensors whose one-rank gradient is known; returns {name:
    (gradient, the one-rank gradient)} and the collectives run in the
    backwards, by name."""
    from quip_for_all_tpu_torch.parallel import comm
    m = get_mesh(meshes, 2, 2)
    g, r, tp = m.tp_group, m.tp_rank, m.tp
    rng = np.random.default_rng(seed)
    w = torch.as_tensor(rng.standard_normal((3, 4 * tp)), dtype=torch.float32)
    xs = torch.as_tensor(rng.standard_normal((tp, 3, 4)),
                         dtype=torch.float32)
    out = {}
    comm.reset_counts()
    # all_gather: loss = sum(w * [x_0 | x_1]); d x_r = w's r-th slice
    x = xs[r].clone().requires_grad_(True)
    (comm.all_gather(x, g, tp) * w).sum().backward()
    out["all_gather"] = (x.grad.numpy(), w[:, 4 * r:4 * r + 4].numpy())
    # all_reduce of partials: loss = sum(w_0 * (p_0 + p_1)); d p_r = w_0
    p = xs[r].clone().requires_grad_(True)
    (comm.all_reduce(p, g) * w[:, :4]).sum().backward()
    out["all_reduce"] = (p.grad.numpy(), w[:, :4].numpy())
    # enter: rank r uses column block r of a whole x; d x = w (whole)
    x = torch.cat(list(xs), dim=-1).requires_grad_(True)
    own = comm.enter(x, g)[:, 4 * r:4 * r + 4]
    (own * w[:, 4 * r:4 * r + 4]).sum().backward()
    out["enter"] = (x.grad.numpy(), w.numpy())
    return out, comm.counts()
