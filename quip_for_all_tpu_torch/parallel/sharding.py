"""Tensor and expert parallelism over ``torch.distributed`` — counterpart
of ``quip_for_all_tpu/parallel/sharding.py``.

The reference documents tensor parallelism as impossible ("Hadamard
transform cannot be done for sharded input"). The JAX package shards any
checkpoint with GSPMD, and checkpoints quantized with ``tp_shards`` carry
block-diagonal transforms whose blocks fall on the shards, so no gather is
needed (``transforms/incoherence.py`` ``HadSpec.shards``). The port has no
GSPMD: ``shard_params`` turns a whole model into one rank's model whose
linears run megatron's collectives explicitly (``parallel/layers.py``),
computing the function the unsharded model computes.

``make_mesh`` lays the ranks of an initialised process group out as
("dp", "tp"), or ("dp", "ep", "tp") with an expert axis; a rank's ``tp``
group runs the linears' collectives, its ``ep`` group sums Mixtral's
experts, which ep cuts (``_shard_moe``). Which linears
shard follows the JAX package's role tables (``role_of``) and its
``_divides`` rule; a rank keeps its heads where the heads split over the
ranks (tp divides both the query and the kv heads) and its slice of the
MLP's hidden width where tp divides it, and replicates attention or the
MLP otherwise (the KV cache shards on kv heads exactly then, the JAX
package's ``kv_cache_specs`` rule). The residual stream, norms, embedding and rotary
tables stay whole on every rank; the head is column-parallel and its
logits are gathered. The rank's model carries its rank-local config
(``tp_cfg``), which ``model_apply`` reads (``models/registry.py``
``rank_config``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..models.config import ModelConfig
from ..nn.qlinear import FusedQuantLinear, QuantLinear, fuse_qlinears
from ..ops.qtensor import (QuantizedTensor, UCODE_LAYOUTS, from_raw_idxs,
                           relayout, to_nibble, to_raw_idxs)

# layer-role tables (the JAX package's, which are the reference's
# constants.py pattern DB reduced to the native families)
_COL_PARALLEL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj",
                 "w1", "w3", "w13", "lm_head",
                 "query_key_value", "dense_h_to_4h",       # gpt_neox
                 "fc1",                                    # opt
                 "W_pack",                                 # baichuan
                 "fc_in",                                  # gptj
                 "c_attn", "mlp.w2",  # qwen/gpt2 fused qkv; qwen up-proj
                 "c_fc")                                   # gpt2
# NOTE: qwen's "mlp.w2" is an UP projection (column-parallel) while
# mixtral's "experts.{e}.w2" is the down projection (row-parallel) — the
# longer suffix above wins because _COL_PARALLEL is checked first.
_ROW_PARALLEL = ("o_proj", "down_proj", "w2",
                 "dense", "dense_4h_to_h",                 # gpt_neox
                 "out_proj", "fc2",                        # opt
                 "fc_out",                                 # gptj
                 "c_proj")                                 # qwen/gpt2
# the port's fused groups (``fuse_for_inference``): their segments' role
_FUSED = {"qkv_proj": "col", "gateup_proj": "col", "w12_proj": "col"}

def role_of(name: str) -> str:
    """Megatron role of a linear layer by name: "col" (output-sharded),
    "row" (input-sharded), or "rep" (replicated)."""
    if any(name.endswith(s) for s in _COL_PARALLEL):
        return "col"
    if any(name.endswith(s) for s in _ROW_PARALLEL):
        return "row"
    return "rep"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ranks laid out as ("dp", "tp"), or ("dp", "ep", "tp") when ep > 1
    (the JAX package's axes): this rank sits at ``coords`` = (dp, ep, tp)
    index. ``tp_group`` (global ranks ``tp_ranks``) runs the linears'
    collectives; ``ep_group`` (``ep_ranks``: the same dp and tp index) sums
    the experts' outputs; ``replica_group`` (``replica_ranks``: every rank
    of one model copy, the same dp index) keeps the sampled tokens equal;
    ``dp_group`` (``dp_ranks``: the same ep and tp index, the ranks that
    hold the same shards) averages a training step's gradients. At ep = 1
    the replica group is the tp group and there is no ep group; at dp = 1
    there is no dp group. A tp group's ranks sit on its axis in ascending
    global order, the order in which its all_gather concatenates."""
    dp: int
    tp: int
    rank: int
    tp_group: object
    tp_ranks: tuple
    ep: int = 1
    coords: tuple = (0, 0, 0)
    ep_group: object = None
    ep_ranks: tuple = ()
    replica_group: object = None
    replica_ranks: tuple = ()
    dp_group: object = None
    dp_ranks: tuple = ()

    @property
    def tp_rank(self) -> int:
        return self.coords[2]

    @property
    def ep_rank(self) -> int:
        return self.coords[1]

    @property
    def dp_rank(self) -> int:
        return self.coords[0]

    @property
    def replica_root(self) -> int:
        """Global rank of the replica's first rank (the sampler's
        source)."""
        return self.replica_ranks[0]

    @property
    def axis_names(self) -> tuple:
        return ("dp", "ep", "tp") if self.ep > 1 else ("dp", "tp")

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as the JAX package's ``Mesh.shape``."""
        sizes = {"dp": self.dp, "ep": self.ep, "tp": self.tp}
        return {a: sizes[a] for a in self.axis_names}


def _groups(members, rank: int, world: int):
    """One process group for each rank tuple of ``members`` (every rank
    creates every group, in the same order); returns this rank's group
    and its ranks."""
    mine = None
    for ranks in members:
        g = (dist.group.WORLD if len(ranks) == world
             else dist.new_group(sorted(ranks)))
        if rank in ranks:
            mine = (g, tuple(ranks))
    return mine


def make_mesh(dp: Optional[int] = None, tp: Optional[int] = None,
              ep: int = 1, order=None) -> Mesh:
    """The ("dp", ["ep",] "tp") mesh over the initialised default process
    group (``torch.distributed.init_process_group``; every rank calls
    this, in the same order). Missing sizes fill the world: tp = world //
    (dp * ep), or dp = world // (ep * tp). ``order`` lists the global
    ranks in mesh order, row-major (default: 0, 1, ...; the hybrid mesh
    of ``parallel/multihost.py`` puts hosts on the outer axis with it), so
    global rank ``order[g]`` sits at (g // (ep tp), (g // tp) % ep, g % tp),
    as the JAX package's ``reshape(dp, ep, tp)`` lays devices out; a tp
    group's ranks are then taken in ascending order."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if ep < 1:
        raise ValueError(f"ep={ep} (want >= 1)")
    if tp is None:
        tp = world // ((dp or 1) * ep)
    if dp is None:
        dp = world // (tp * ep)
    if dp * ep * tp != world:
        raise ValueError(f"dp {dp} x ep {ep} x tp {tp} != world size "
                         f"{world}")
    order = np.arange(world) if order is None else np.asarray(order)
    if sorted(order.tolist()) != list(range(world)):
        raise ValueError(f"order {order.tolist()} is not a permutation of "
                         f"the {world} ranks")
    grid = np.sort(order.reshape(dp, ep, tp), axis=-1)
    coords = tuple(int(c) for c in np.argwhere(grid == rank)[0])
    tp_group, tp_ranks = _groups(
        [tuple(int(r) for r in grid[d, e]) for d in range(dp)
         for e in range(ep)], rank, world)
    if ep == 1:
        ep_group, ep_ranks = None, (rank,)
        rep_group, rep_ranks = tp_group, tp_ranks
    else:
        ep_group, ep_ranks = _groups(
            [tuple(int(r) for r in grid[d, :, t]) for d in range(dp)
             for t in range(tp)], rank, world)
        rep_group, rep_ranks = _groups(
            [tuple(int(r) for r in grid[d].ravel()) for d in range(dp)],
            rank, world)
    dp_group, dp_ranks = None, (rank,)
    if dp > 1:
        dp_group, dp_ranks = _groups(
            [tuple(sorted(int(r) for r in grid[:, e, t])) for e in range(ep)
             for t in range(tp)], rank, world)
    return Mesh(dp, tp, rank, tp_group, tp_ranks, ep, coords, ep_group,
                ep_ranks, rep_group, rep_ranks, dp_group, dp_ranks)


@dataclasses.dataclass(frozen=True)
class AxisMesh:
    """One named axis over a group of ranks — the port's form of the JAX
    package's one-axis meshes ``("sp",)`` and ``("pp",)``. ``group``
    holds the global ranks ``ranks``; this rank sits at ``index`` on the
    axis of ``size``."""
    axis: str
    size: int
    index: int
    group: object
    ranks: tuple


def axis_mesh(axis: str, n: int) -> AxisMesh:
    """The ``axis`` mesh of ``n`` ranks over the initialised default
    process group (every rank calls this, in the same order): consecutive
    global ranks form a group of ``n``, so a world of k * n holds k
    replicas of the axis."""
    if not dist.is_initialized():
        raise RuntimeError(f"the {axis} mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n < 1 or world % n:
        raise ValueError(f"{axis}={n} must divide the world size {world}")
    group, ranks = _groups([tuple(range(lo, lo + n))
                            for lo in range(0, world, n)], rank, world)
    return AxisMesh(axis, n, rank - ranks[0], group, ranks)


def _divides(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def splits(cfg: ModelConfig, tp: int):
    """(attention splits, MLP splits): tp divides the query and the kv
    heads; tp divides the MLP's hidden width."""
    return (_divides(cfg.num_attention_heads, tp)
            and _divides(cfg.num_key_value_heads, tp),
            _divides(cfg.intermediate_size, tp))


def rank_config_of(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The config a rank's blocks run with: its heads and its MLP width
    where they split (``head_dim`` stays)."""
    attn, mlp = splits(cfg, tp)
    kw = {}
    if attn:
        kw.update(num_attention_heads=cfg.num_attention_heads // tp,
                  num_key_value_heads=cfg.num_key_value_heads // tp)
    if mlp:
        kw["intermediate_size"] = cfg.intermediate_size // tp
    return dataclasses.replace(cfg, **kw)


# ------------------------------------------------------------ plane cuts

def _pad128(t: torch.Tensor) -> torch.Tensor:
    pad = (-t.shape[-1]) % 128
    return torch.nn.functional.pad(t, (0, pad)) if pad else t


def _codebook(qt: QuantizedTensor):
    from ..codebooks import get_codebook
    ors = qt.opt_resid_scale
    return get_codebook(qt.codebook_id, ors if ors > 0 else None)


def cut_planes(qt: QuantizedTensor, rows=None, groups=None
               ) -> QuantizedTensor:
    """The planes of rows [r0, r1) and/or input groups [g0, g1) (8 inputs
    a group) of ``qt``, in its layout, columns padded to 128 groups again
    with zero words (so a rank's x pad lanes are zero, as every layout
    wants). The nibble, bfp and sw layouts cut the nibble words
    themselves; the u-code layouts (u3, pb, paired) go through the code
    indices (``to_raw_idxs``)."""
    r0, r1 = rows if rows is not None else (0, qt.q_out)
    g0, g1 = groups if groups is not None else (0, qt.q_in // 8)
    q_out, q_in = r1 - r0, (g1 - g0) * 8
    if qt.layout in UCODE_LAYOUTS:
        raw = to_raw_idxs(qt)
        per = raw.shape[1] // (qt.q_in // 8)        # codes a group
        raw = np.ascontiguousarray(raw[r0:r1, g0 * per:g1 * per])
        return from_raw_idxs(_codebook(qt), raw, q_out, q_in,
                             device=qt.planes["w0"].device,
                             layout=qt.layout)
    n = to_nibble(qt)
    planes = {k: _pad128(v[r0:r1, g0:g1]).contiguous().clone()
              for k, v in n.planes.items()}
    local = QuantizedTensor(planes, qt.codebook_id, q_out, q_in,
                            qt.opt_resid_scale)
    return relayout(local, qt.layout)


def _own(t, lo, hi):
    return None if t is None else t[lo:hi].contiguous().clone()


def _qlinear(p: QuantLinear, qweight, **over) -> QuantLinear:
    """A QuantLinear with ``p``'s fields, ``over`` replacing some (None
    planes: a layer without planes, for a right or left side alone)."""
    f = dict(in_features=p.in_features, out_features=p.out_features,
             q_in=p.q_in, q_out=p.q_out, K_left=p.K_left, K_right=p.K_right,
             SU=p.SU, SV=p.SV, bias=p.bias, had_left=p.had_left,
             had_right=p.had_right, Wscale=p.Wscale,
             per_channel=p.per_channel, wscale_float=p.wscale_float,
             shards_left=p.shards_left, shards_right=p.shards_right)
    f.update(over)
    q = QuantLinear(qweight, **f)
    q._switches.update(p._switches)
    return q


def _col_ok(qt: QuantizedTensor, n: int, tp: int) -> bool:
    """tp splits n rows of this layout (bfp and the row-pair layouts
    keep row pairs whole)."""
    if qt.layout in ("bfp", "u3", "pb"):
        return _divides(n // 2, tp) and n % 2 == 0
    return _divides(n, tp)


def _col_fields(p: QuantLinear, tp: int, r: int):
    """A column shard's output-side fields of ``p`` (rank r's rows), and
    whether its right transform is the rank's own (block-diagonal over a
    multiple of tp blocks)."""
    n = p.q_out // tp
    lo, hi = r * n, (r + 1) * n
    local_right = p.shards_right % tp == 0
    over = dict(q_out=n, out_features=n, SV=_own(p.SV, lo, hi),
                bias=_own(p.bias, lo, hi), Wscale=_own(p.Wscale, lo, hi))
    if local_right:
        over["shards_right"] = p.shards_right // tp
    return over, local_right


def _cut_col_qlinear(p: QuantLinear, tp: int, r: int):
    over, local_right = _col_fields(p, tp, r)
    n = p.q_out // tp
    return _qlinear(p, cut_planes(p.qweight, rows=(r * n, (r + 1) * n)),
                    **over), local_right


def _cut_row_qlinear(p: QuantLinear, tp: int, r: int):
    """A row shard of ``p``: rank r's plane columns with the whole right
    side, and its own left side (SU slice, the diagonal blocks) where the
    left transform is block-diagonal over a multiple of tp blocks; else
    none (the rank's layer transforms the whole input with ``p``'s)."""
    n = p.q_in // tp
    local_left = p.shards_left % tp == 0
    over = dict(q_in=n, in_features=n)
    if local_left:
        over.update(SU=_own(p.SU, r * n, (r + 1) * n),
                    shards_left=p.shards_left // tp)
    else:
        over.update(SU=None, had_left=None, K_left=1, shards_left=1)
    return _qlinear(p, cut_planes(p.qweight, groups=(r * n // 8,
                                                     (r + 1) * n // 8)),
                    **over), local_left


def _cut_fused(f: FusedQuantLinear, tp: int, r: int):
    """A fused group's rank-local copy: each segment's own rows, fused
    again. Returns (local, every segment right-local)."""
    segs, off, local_right = [], 0, True
    for p in f.segments:
        n = p.q_out // tp
        over, right = _col_fields(p, tp, r)
        segs.append(_qlinear(
            p, cut_planes(f.qweight, rows=(off + r * n, off + (r + 1) * n)),
            SU=f.SU, had_left=f.had_left, K_left=f.K_left, q_in=f.q_in,
            in_features=f.in_features, shards_left=f.shards_left, **over))
        local_right = local_right and right
        off += p.q_out
    local = fuse_qlinears(segs)
    local._switches.update(f._switches)
    return local, local_right


def _planeless_fused(f: FusedQuantLinear) -> FusedQuantLinear:
    """The whole group's right side without planes (the gather route)."""
    q = f.qweight
    return FusedQuantLinear(
        QuantizedTensor({}, q.codebook_id, q.q_out, q.q_in,
                        q.opt_resid_scale, q.layout),
        list(f.segments), SU=None, had_left=None, K_left=f.K_left,
        q_in=f.q_in, in_features=f.in_features,
        right_uniform=f.right_uniform, right_hadK_stack=f.right_hadK_stack,
        pre_vec=f.pre_vec, SV_all=f.SV_all, bias_all=f.bias_all,
        shards_left=f.shards_left)


# ------------------------------------------------------------ the model

def _col_view(cfg: ModelConfig, name: str, attn: bool, mlp: bool):
    """What the rank's block reads from a column-parallel output."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "lm_head":
        return "full"
    if _in_mlp(name):
        return "chunk" if mlp else "full"
    if not attn:
        return "full"
    if leaf in ("W_pack", "c_attn"):
        # [q | k | v] laid out contiguously: the rank's slice of each
        hd = cfg.head_dim
        return (cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd,
                cfg.num_key_value_heads * hd)
    # q/k/v, a fused qkv's segments, GPT-NeoX's per-head interleaved
    # query_key_value, Falcon's grouped one (the rank's kv groups)
    return "chunk"


def _in_mlp(name: str) -> bool:
    """An MLP's linear, or a Mixtral expert's (its hidden width splits
    as the MLP's does)."""
    return ".mlp." in f".{name}" or ".experts." in f".{name}"


def _row_in_local(name: str, attn: bool, mlp: bool) -> bool:
    return mlp if _in_mlp(name) else attn


def _shard_linear(cfg: ModelConfig, lin: nn.Module, name: str, mesh: Mesh,
                  attn: bool, mlp: bool) -> nn.Module:
    from ..models.llama import DenseLinear
    from ..nn.lora import LoraLinear
    from ..nn.qmoe import StackedQuantLinear
    from .layers import ColParallel, RowParallel, _dims
    if isinstance(lin, StackedQuantLinear):
        return lin          # experts not cut over "ep": whole on every rank
    tp, r = mesh.tp, mesh.tp_rank
    leaf = name.rsplit(".", 1)[-1]
    role = _FUSED.get(leaf) if isinstance(lin, FusedQuantLinear) \
        else role_of(name)
    dims = _dims(lin)
    if role == "col":
        view = _col_view(cfg, name, attn, mlp)

        def whole():
            return ColParallel(lin, mesh, cut=False, right_local=False,
                               view=view, dims=dims, seg_out=seg_out)
        seg_out = ([p.q_out for p in lin.segments]
                   if isinstance(lin, FusedQuantLinear) else [])
        if isinstance(lin, LoraLinear):
            # the JAX role table calls the base "*.lora_base": replicated,
            # with its adapters; the rank reads its view of the output
            return whole()
        if isinstance(lin, FusedQuantLinear):
            ok = all(p.out_features == p.q_out
                     and _col_ok(lin.qweight, p.q_out, tp)
                     for p in lin.segments)
            if not ok:
                return whole()
            local, right = _cut_fused(lin, tp, r)
            return ColParallel(local, mesh, cut=True, right_local=right,
                               view=view, dims=dims, seg_out=seg_out,
                               full=None if right else _planeless_fused(lin))
        if isinstance(lin, QuantLinear):
            if not (lin.out_features == lin.q_out
                    and _col_ok(lin.qweight, lin.q_out, tp)):
                return whole()
            local, right = _cut_col_qlinear(lin, tp, r)
            return ColParallel(local, mesh, cut=True, right_local=right,
                               view=view, dims=dims,
                               full=None if right else _qlinear(lin, None))
        out_f = lin.weight.shape[0]
        if not _divides(out_f, tp):
            return whole()
        n = out_f // tp
        return ColParallel(
            DenseLinear(_own(lin.weight, r * n, (r + 1) * n),
                        _own(lin.bias, r * n, (r + 1) * n)),
            mesh, cut=True, right_local=True, view=view, dims=dims)
    if role == "row":
        in_local = _row_in_local(name, attn, mlp)
        in_f = dims[0]

        def whole():
            return RowParallel(lin, mesh, cut=False, left_local=False,
                               in_local=in_local, dims=dims)
        if isinstance(lin, FusedQuantLinear):
            raise ValueError(f"{name}: a fused group is column-parallel")
        if isinstance(lin, LoraLinear):
            return whole()                  # replicated, as for a column
        if isinstance(lin, QuantLinear):
            ok = (lin.in_features == lin.q_in and _divides(lin.q_in, tp)
                  and (lin.q_in // tp) % 8 == 0
                  and lin.qweight.layout != "paired")
            if not ok:
                return whole()
            local, left = _cut_row_qlinear(lin, tp, r)
            return RowParallel(local, mesh, cut=True, left_local=left,
                               in_local=in_local, dims=dims,
                               full=None if left else _qlinear(lin, None))
        if not _divides(in_f, tp):
            return whole()
        n = in_f // tp
        w = lin.weight[:, r * n:(r + 1) * n].contiguous().clone()
        return RowParallel(DenseLinear(w, lin.bias), mesh, cut=True,
                           left_local=True, in_local=in_local, dims=dims)
    return lin                                   # replicated


def _linear_like(mod: nn.Module) -> bool:
    from ..models.llama import DenseLinear
    from ..nn.lora import LoraLinear
    from ..nn.qmoe import StackedQuantLinear
    return isinstance(mod, (QuantLinear, FusedQuantLinear, DenseLinear,
                            LoraLinear, StackedQuantLinear))


def _cut_stacked(sq, lo: int, hi: int):
    """Experts [lo, hi) of a ``StackedQuantLinear``, in memory of their
    own (so the whole model can be freed)."""
    from ..nn.qmoe import StackedQuantLinear
    out = StackedQuantLinear(
        {k: _own(v, lo, hi) for k, v in sq.planes.items()},
        SU=_own(sq.SU, lo, hi), had_left=_own(sq.had_left, lo, hi),
        pre_vec=_own(sq.pre_vec, lo, hi),
        had_right=_own(sq.had_right, lo, hi),
        SV_all=_own(sq.SV_all, lo, hi), bias_all=_own(sq.bias_all, lo, hi),
        E=hi - lo, nseg=sq.nseg, in_features=sq.in_features, q_in=sq.q_in,
        seg_out=sq.seg_out, K_left=sq.K_left, K_right=sq.K_right,
        codebook_id=sq.codebook_id, opt_resid_scale=sq.opt_resid_scale)
    out.ksplit = sq.ksplit
    out.dense_stacked = sq.dense_stacked
    return out


def _shard_moe(moe: nn.ModuleDict, mesh: Mesh) -> nn.Module:
    """A Mixtral MoE block with stacked experts on this rank: where ep
    divides the E experts, an ``ExpertParallelMoE`` keeping experts
    [i E/ep, (i+1) E/ep) of ep index i and the replicated router; else
    the block as it is, every expert on every rank (the JAX package's
    ``stacked_spec`` leaves E unsharded then)."""
    from .layers import ExpertParallelMoE
    st = moe["experts_stacked"]
    E = st["w13"].E
    if mesh.ep == 1 or not _divides(E, mesh.ep):
        return moe
    n = E // mesh.ep
    lo = mesh.ep_rank * n
    return ExpertParallelMoE(moe["gate"], _cut_stacked(st["w13"], lo, lo + n),
                             _cut_stacked(st["w2"], lo, lo + n), offset=lo,
                             mesh=mesh)


def shard_params(cfg: ModelConfig, model: nn.Module, mesh: Mesh
                 ) -> nn.Module:
    """This rank's model of a whole ``model`` (any family's, fused or
    not): every linear replaced by its column- or row-parallel layer
    (``parallel/layers.py``) holding the rank's planes, scales and
    vectors; norms, embeddings and replicated linears shared with
    ``model``. Mixtral's stacked experts are cut over "ep"
    (``_shard_moe``; inside an expert the tp ranks keep it whole: the
    function GSPMD computes from the JAX package's cut, which it gathers
    whole for the stack's Hadamard transforms, since stacked experts have
    no block-diagonal ones); experts that do not stack shard one by one
    by the role tables (w1/w3 column-, w2 row-parallel); the router is
    replicated. A LoRA-adapted linear (``nn/lora.py`` ``add_lora``
    before this) stays whole with its adapters on every rank, as the JAX
    role table replicates "*.lora_base", inside a parallel layer that
    gives the rank its view. The result carries ``tp_mesh`` and
    ``tp_cfg``; drop the whole model afterwards to free what the rank
    does not keep."""
    from ..models.llama import LlamaModel
    from ..models.tree import FamilyModel
    if getattr(model, "tp_mesh", None) is not None:
        raise ValueError("the model is sharded already")
    attn, mlp = splits(cfg, mesh.tp)

    def walk(mod, name):
        if isinstance(mod, nn.ModuleDict) and "experts_stacked" in mod:
            cut = _shard_moe(mod, mesh)
            if cut is not mod:
                return cut
        if _linear_like(mod):
            # a tp axis of 1 (an expert axis alone) cuts no linear
            return (mod if mesh.tp == 1
                    else _shard_linear(cfg, mod, name, mesh, attn, mlp))
        if isinstance(mod, nn.ModuleDict) and not isinstance(mod,
                                                             FamilyModel):
            return nn.ModuleDict({k: walk(v, f"{name}.{k}" if name else k)
                                  for k, v in mod.items()})
        if isinstance(mod, nn.ModuleList):
            return nn.ModuleList([walk(v, f"{name}.{i}")
                                  for i, v in enumerate(mod)])
        return mod

    if isinstance(model, LlamaModel):
        out = LlamaModel(model.embed_tokens.weight,
                         list(walk(model.layers, "layers")),
                         model.norm.weight,
                         None if model.lm_head is None
                         else walk(model.lm_head, "lm_head"))
    elif isinstance(model, FamilyModel):
        out = FamilyModel({k: walk(v, k) for k, v in model.items()})
    else:
        raise TypeError(f"shard_params takes a LlamaModel or a FamilyModel, "
                        f"not {type(model).__name__}")
    out.tp_mesh = mesh
    out.tp_cfg = rank_config_of(cfg, mesh.tp)
    return out
