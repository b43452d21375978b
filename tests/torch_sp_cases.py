"""Rank-side cases of ``tests/test_torch_sp.py``,
``tests/test_torch_pipeline.py`` and ``tests/test_torch_ft_pp.py``, run on
the gloo ranks of ``tests/torch_tp_cases.py`` (``Ranks.run(
"torch_sp_cases:<name>", ...)``). Like that module's, they import torch
and the port only; models cross as ``torch.save`` files, results go back
as numpy arrays and plain values.

A case of n ranks runs on a group of n or more: ``axis_mesh`` splits a
world of 4 into two groups of 2 for an sp or pp of 2, and the test reads
the first group's results.
"""
from __future__ import annotations

import contextlib
import io

import torch

from torch_tp_cases import _load


def _mesh(meshes: dict, axis: str, n: int):
    """The ("sp",) or ("pp",) mesh of n ranks, made once per group."""
    from quip_for_all_tpu_torch.parallel.sharding import axis_mesh
    if (axis, n) not in meshes:
        meshes[(axis, n)] = axis_mesh(axis, n)
    return meshes[(axis, n)]


def ring(meshes, sp, q, k, v):
    """``ring_attention`` on this rank's chunk of the whole (B, S, ., hd)
    q, k, v; returns the chunk's context (B, S / sp, H * hd)."""
    from quip_for_all_tpu_torch.parallel.sequence import ring_attention
    mesh = _mesh(meshes, "sp", sp)
    Sl = q.shape[1] // sp
    cut = slice(mesh.index * Sl, (mesh.index + 1) * Sl)
    return ring_attention(*(torch.from_numpy(a[:, cut]) for a in (q, k, v)),
                          mesh).numpy()


def sp_logits(meshes, cfg, path, ids, sp, linear_kw=None):
    """``sequence_parallel_logits``: (this rank's logits, collectives)."""
    from quip_for_all_tpu_torch.parallel import comm
    from quip_for_all_tpu_torch.parallel.sequence import (
        sequence_parallel_logits)
    mesh = _mesh(meshes, "sp", sp)
    comm.reset_counts()
    with torch.no_grad():
        out = sequence_parallel_logits(cfg, _load(path), torch.as_tensor(ids),
                                       mesh, linear_kw=linear_kw)
    return out.numpy(), comm.counts()


def sp_perplexity(meshes, cfg, path, windows, sp, batch_size,
                  linear_kw=None):
    """``perplexity(sp_mesh=)`` in f32."""
    from quip_for_all_tpu_torch.runtime.generate import perplexity
    return perplexity(cfg, _load(path), windows, batch_size=batch_size,
                      sp_mesh=_mesh(meshes, "sp", sp), device="cpu",
                      linear_kw=linear_kw)


def pp_logits(meshes, cfg, path, ids, pp, n_micro, linear_kw=None):
    """``pipeline_logits``: (logits, collectives)."""
    from quip_for_all_tpu_torch.parallel import comm
    from quip_for_all_tpu_torch.parallel.pipeline import pipeline_logits
    mesh = _mesh(meshes, "pp", pp)
    comm.reset_counts()
    with torch.no_grad():
        out = pipeline_logits(cfg, _load(path), torch.as_tensor(ids), mesh,
                              n_micro, linear_kw=linear_kw)
    return out.numpy(), comm.counts()


def ft_step(meshes, cfg, path, ids, targets, pp, n_micro, kernels=False):
    """One end-to-end finetune step's loss and the gradients this rank
    computes (its stage's leaves): the quantizer's student forward
    (``finetune.student_logits``), or with ``kernels`` the eval forward of
    the linears (f32 compute), pipelined over ``pp`` ranks (``pp`` 1: the
    one-rank step). Returns (loss, {key: grad}, collectives)."""
    from quip_for_all_tpu_torch.models.registry import get_arch, model_layers
    from quip_for_all_tpu_torch.parallel import comm
    from quip_for_all_tpu_torch.parallel.pipeline import pipeline_logits
    from quip_for_all_tpu_torch.quantize import finetune as FT
    model = _load(path)
    layers = model_layers(model)
    flat = FT.collect_trainable(layers)
    FT.apply_trainable(layers, flat)
    mesh = _mesh(meshes, "pp", pp) if pp > 1 else None
    ids = torch.as_tensor(ids)
    comm.reset_counts()
    kw = {"compute_dtype": torch.float32}
    with (contextlib.nullcontext() if kernels else
          FT.dense_weights(FT.student_modules(cfg, model, mesh))):
        if not kernels:
            logits = FT.student_logits(cfg, model, ids, mesh, n_micro)
        elif mesh is None:
            logits = get_arch(cfg).model_apply(cfg, model, ids,
                                               linear_kw=kw)[0]
        else:
            logits = pipeline_logits(cfg, model, ids, mesh, n_micro,
                                     linear_kw=kw)
        loss = FT.ce_loss(logits, torch.as_tensor(targets))
        loss.backward()
    grads = {k: v.grad.numpy() for k, v in flat.items() if v.grad is not None}
    return float(loss.detach()), grads, comm.counts()


def quantize(meshes, cfg, path, calib, qkw, save_dir=None):
    """``QuipQuantizer(**qkw).quantize_model`` on this rank, recording
    every ``quantize_layer`` call as ``tests/torch_quant_cases.py`` does;
    rank 0 saves the model to ``save_dir``. Returns (calls, the
    finetune's stats)."""
    import torch.distributed as dist
    import quip_for_all_tpu_torch.quantize.quantizer as TQQ
    from quip_for_all_tpu_torch.utils.checkpoint import save_quantized
    calls = []
    orig = TQQ.quantize_layer

    def spy(W, H, cb, qc, rng, **kw):
        st = rng.bit_generator.state
        a, w = orig(W, H, cb, qc, rng, **kw)
        calls.append((W.cpu().numpy(), H.cpu().numpy(), st, kw, qc, a))
        return a, w
    TQQ.quantize_layer = spy
    try:
        q = TQQ.QuipQuantizer(**qkw)
        model = q.quantize_model(cfg, _load(path), calib)
    finally:
        TQQ.quantize_layer = orig
    if save_dir is not None and dist.get_rank() == 0:
        save_quantized(cfg, model, q.to_dict(), save_dir)
    return calls, q.e2e_ft_stats_


def cli(meshes, module, argv):
    """``quip_for_all_tpu_torch.cli.<module>.main(argv)`` on this rank
    (inside the group, as under torchrun); returns what it printed."""
    import importlib
    main = importlib.import_module(
        f"quip_for_all_tpu_torch.cli.{module}").main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def cli_error(meshes, module, argv):
    """The exception ``cli`` raises, as (type name, message)."""
    try:
        cli(meshes, module, argv)
    except Exception as e:        # the case reports what the CLI raised
        return type(e).__name__, str(e)
    return None


def pp_input_grad(meshes, cfg, path, x, pp, n_micro):
    """The gradient of ``(pipeline_forward(x) * w).sum()`` in the
    activations x (B, S, D) and in the stage's leaves, beside the same
    loss over every block in turn on this rank, a microbatch at a time.
    Returns (max |dx
    pipelined - dx one rank| / max |dx|, the same for the leaves, the
    broadcasts run)."""
    from quip_for_all_tpu_torch.models.llama import causal_mask
    from quip_for_all_tpu_torch.models.registry import (get_arch,
                                                        model_layers,
                                                        rope_tables)
    from quip_for_all_tpu_torch.parallel import comm
    from quip_for_all_tpu_torch.parallel.pipeline import (pipeline_forward,
                                                          stage_blocks)
    from quip_for_all_tpu_torch.quantize import finetune as FT
    model = _load(path)
    layers = model_layers(model)
    flat = FT.collect_trainable(layers)
    FT.apply_trainable(layers, flat)
    mesh = _mesh(meshes, "pp", pp)
    x = torch.as_tensor(x)
    B, S, _ = x.shape
    pos = torch.arange(S)[None].repeat(B // n_micro, 1)
    cos, sin = rope_tables(cfg, pos)
    mask = causal_mask(S, S, "cpu")
    w = torch.linspace(-1, 1, x.numel()).reshape(x.shape)
    kw = {"compute_dtype": torch.float32}

    def grads(run):
        xt = x.clone().requires_grad_(True)
        (run(xt) * w).sum().backward()
        out = {k: v.grad for k, v in flat.items() if v.grad is not None}
        for v in flat.values():
            v.grad = None
        return xt.grad, out

    def one_rank(h):
        outs = []
        for hm in h.split(B // n_micro):
            for blk in layers:
                hm, _ = get_arch(cfg).block_apply(cfg, blk, hm, cos, sin,
                                                  attn_mask=mask,
                                                  linear_kw=kw)
            outs.append(hm)
        return torch.cat(outs)
    dx1, g1 = grads(one_rank)
    comm.reset_counts()
    dx, g = grads(lambda h: pipeline_forward(
        cfg, stage_blocks(model, mesh), h, cos, sin, mesh, n_micro,
        attn_mask=mask, linear_kw=kw))
    errs = [float((g[k] - g1[k]).abs().max() / g1[k].abs().max())
            for k in g]
    return (float((dx - dx1).abs().max() / dx1.abs().max()), max(errs),
            comm.counts()["broadcast"])
