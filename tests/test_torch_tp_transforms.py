"""Block-diagonal (tensor-parallel) incoherence transforms and the
quantized linears that carry them, held to the JAX package on the CPU
with no processes: ``get_hadK(shards=)`` (the same sub-factor from the
same numpy generator, random and table), ``matmul_hadU`` /
``matmul_hadUt`` and ``matmul_hadUt_grouped`` at 2 and 4 shards,
``calc_weight``, ``QuantLinear`` / ``FusedQuantLinear`` forwards with
``shards_left`` / ``shards_right`` carried across by ``qlinear_from_jax``,
and the guards that refuse to fuse or stack across different shards.

Tolerance: f32, 1e-5 of the output's max (the two packages sum in other
orders); factors bitwise.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quip_for_all_tpu.codebooks import get_codebook as jget_codebook
from quip_for_all_tpu.nn import qlinear as JQL
from quip_for_all_tpu.transforms import incoherence as jinc
from quip_for_all_tpu.utils.random_quantized import random_qlinear

from quip_for_all_tpu_torch.models.llama import _sharable
from quip_for_all_tpu_torch.nn import qlinear as TQL
from quip_for_all_tpu_torch.nn.qmoe import stack_qlinears
from quip_for_all_tpu_torch.transforms import incoherence as tinc
from quip_for_all_tpu_torch.utils.convert import qlinear_from_jax

pytestmark = pytest.mark.fast


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small tensor ops: one torch thread a test worker, set before
    the module's fixtures build their models, so that a parallel test run
    does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), err


def _specs(n, s, use_rand, seed=0):
    ja, ta = np.random.default_rng(seed), np.random.default_rng(seed)
    return (jinc.get_hadK(n, use_rand=use_rand, rng=ja, shards=s),
            tinc.get_hadK(n, use_rand=use_rand, rng=ta, shards=s))


# widths: a power of two; 43 * 16 (Llama-2-7B's down_proj factor: random
# K = 43, table K = 172 at 4 shards); 5 * 64
@pytest.mark.parametrize("use_rand", [True, False])
@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("n", [256, 688, 320])
def test_get_hadK_shards_is_jax(n, s, use_rand):
    js, ts = _specs(n, s, use_rand)
    assert (ts.K, ts.padN, ts.shards) == (js.K, js.padN, js.shards)
    if js.hadK is None:
        assert ts.hadK is None
    else:
        assert np.array_equal(np.asarray(js.hadK), ts.hadK)
    # the port's full_U is the block-diagonal U that JAX's matmul_hadU
    # applies (X @ U^T; JAX's own full_U leaves the shards out)
    eye = jnp.eye(n, dtype=jnp.float32)
    assert np.allclose(tinc.full_U(ts),
                       np.asarray(jinc.matmul_hadU(eye, js)).T, atol=1e-6)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("n", [256, 688, 320])
def test_matmul_hadU_shards_is_jax(n, s, transpose):
    js, ts = _specs(n, s, True)
    x = np.random.default_rng(1).standard_normal((5, n)).astype(np.float32)
    want = jinc.matmul_hadU(jnp.asarray(x), js, scale=0.7,
                            transpose=transpose)
    _close(tinc.matmul_hadU(torch.from_numpy(x), ts, scale=0.7,
                            transpose=transpose), want)
    if transpose:
        _close(tinc.matmul_hadUt(torch.from_numpy(x), ts),
               jinc.matmul_hadUt(jnp.asarray(x), js))


@pytest.mark.parametrize("split", [1, 2, 4])
@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("n", [256, 2048, 688 * 8])
def test_grouped_prologue_shards_is_jax(n, s, split):
    js, ts = _specs(n, s, True)
    Gp = -(-(n // 8) // 128) * 128
    x = np.random.default_rng(2).standard_normal((3, n)).astype(np.float32)
    want = jinc.matmul_hadUt_grouped(jnp.asarray(x), js, Gp, scale=0.5,
                                     split=split)
    got = tinc.matmul_hadUt_grouped(torch.from_numpy(x), ts, Gp, scale=0.5,
                                    split=split)
    assert (want is None) == (got is None)
    if want is not None:
        _close(got, want)


def test_block_diag_transform_is_shard_local():
    """The port's version of tests/test_tp_shards.py's check: the sharded
    transform applied globally equals each shard's block on its slice;
    and it is orthogonal."""
    n, s = 256, 4
    spec = tinc.get_hadK(n, use_rand=True, rng=np.random.default_rng(0),
                         shards=s)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, n)).astype(np.float32))
    y = tinc.matmul_hadU(x, spec)
    for i in range(s):
        sl = slice(i * n // s, (i + 1) * n // s)
        assert torch.allclose(y[:, sl], tinc.matmul_hadU(x[:, sl],
                                                         spec.sub()),
                              atol=1e-5)
    assert torch.allclose((y ** 2).sum(-1), (x ** 2).sum(-1), rtol=1e-4)
    assert tinc.right_b_factor(spec) is None


def _jlin(in_f, out_f, sl, sr, seed=0, per_channel=False, lspec=None,
          SU=None):
    """A JAX QuantLinearParams with block-diagonal transforms of sl / sr
    shards on its left / right."""
    rng = np.random.default_rng(seed)
    p = random_qlinear(jget_codebook("E8P12"), in_f, out_f, rng,
                       dtype=jnp.float32, lspec=lspec, SU=SU)
    if lspec is None and sl > 1:
        ls = jinc.get_hadK(in_f, rng=rng, shards=sl)
        p = dataclasses.replace(
            p, had_left=None if ls.hadK is None else jnp.asarray(ls.hadK),
            K_left=ls.K, shards_left=sl)
    if sr > 1:
        rs = jinc.get_hadK(out_f, rng=rng, shards=sr)
        p = dataclasses.replace(
            p, had_right=None if rs.hadK is None else jnp.asarray(rs.hadK),
            K_right=rs.K, shards_right=sr)
    if per_channel:
        p = dataclasses.replace(p, per_channel=True, Wscale=jnp.asarray(
            rng.uniform(0.5, 1.5, p.q_out).astype(np.float32)))
    return p


# (in, out): 384 = 3 * 128 (K 3 left at one shard, at two 192 = 3 * 64);
# 640 out (5 * 128): the fused route (q_out % 128); 96 out: the dense one
@pytest.mark.parametrize("m", [3, 40])
@pytest.mark.parametrize("sl,sr", [(2, 1), (1, 2), (2, 2), (4, 4)])
@pytest.mark.parametrize("shape", [(384, 640), (256, 96)])
def test_quant_linear_with_shards_is_jax(shape, sl, sr, m):
    jp = _jlin(*shape, sl, sr, per_channel=True)
    tp = qlinear_from_jax(jp, "cpu")
    assert (tp.shards_left, tp.shards_right) == (sl, sr)
    x = np.random.default_rng(3).standard_normal((m, shape[0])).astype(
        np.float32)
    want = JQL.apply(jp, jnp.asarray(x), compute_dtype=jnp.float32)
    got = TQL.apply(tp, torch.from_numpy(x), compute_dtype=torch.float32)
    _close(got, want)
    _close(TQL.calc_weight(tp), JQL.calc_weight(jp))


@pytest.mark.parametrize("m", [2, 40])
def test_fused_segments_with_sharded_right_are_jax(m):
    """q/k/v with block-diagonal right transforms fuse (one left side)
    but take the per-segment right side (not uniform), as in JAX."""
    rng = np.random.default_rng(4)
    ls = jinc.get_hadK(256, rng=rng)
    SU = np.sign(rng.standard_normal(256)).astype(np.float32)
    jps = [_jlin(256, o, 1, 2, seed=i, lspec=ls, SU=SU)
           for i, o in enumerate((256, 128, 128))]
    jf = JQL.fuse_qlinears(jps)
    tps = [qlinear_from_jax(p, "cpu") for p in jps]
    for t in tps[1:]:      # the JAX SU / factor arrays are distinct
        t.SU, t.had_left = tps[0].SU, tps[0].had_left
    assert _sharable(tps)
    tf = TQL.fuse_qlinears(tps)
    assert not tf.right_uniform and not jf.right_uniform
    x = np.random.default_rng(5).standard_normal((m, 256)).astype(
        np.float32)
    want = JQL.fused_apply(jf, jnp.asarray(x), compute_dtype=jnp.float32)
    got = TQL.fused_apply(tf, torch.from_numpy(x),
                          compute_dtype=torch.float32)
    for g, w in zip(got, want):
        _close(g, w)


def test_guards_refuse_mixed_left_shards():
    """Fusion needs one left side (shards_left too), and experts stack
    only with whole transforms, as the JAX package's guards say."""
    rng = np.random.default_rng(6)
    ls1 = jinc.get_hadK(256, rng=rng)
    ls2 = jinc.get_hadK(256, rng=rng, shards=2)
    a = qlinear_from_jax(_jlin(256, 128, 1, 1, seed=1, lspec=ls1), "cpu")
    b = qlinear_from_jax(_jlin(256, 128, 1, 1, seed=2, lspec=ls2), "cpu")
    b.shards_left = 2
    b.SU, b.had_left = a.SU, a.had_left
    assert not _sharable([a, b])
    with pytest.raises(ValueError, match="left sides differ"):
        TQL.fuse_qlinears([a, b])
    c = qlinear_from_jax(_jlin(256, 128, 1, 2, seed=3, lspec=ls1), "cpu")
    c.SU, c.had_left = a.SU, a.had_left
    assert stack_qlinears([[a], [a]]) is not None
    assert stack_qlinears([[a], [c]]) is None


@pytest.mark.parametrize("codebook,layout", [
    ("E8P12", "nibble"), ("E8P12", "bfp"), ("E8P12", "sw4"),
    ("E8P12", "u3"), ("E8P12RVQ4B", "pb"), ("E8P12RVQ4B", "paired")])
def test_cut_planes_is_an_exact_inverse(codebook, layout):
    """A rank's planes (``parallel/sharding.py`` ``cut_planes``) in every
    layout: the ranks' rows, and the ranks' input groups without their
    pad, put back together give the whole planes' codes exactly; each
    rank's columns pad back to 128 groups with zero words (Llama-2-7B's
    down_proj at tp 2 in small: 172 groups, 86 a rank, padded to 128)."""
    from quip_for_all_tpu_torch.ops import qtensor as Q
    from quip_for_all_tpu_torch.parallel.sharding import cut_planes
    from quip_for_all_tpu_torch.utils.random_quantized import random_qtensor
    gen = torch.Generator().manual_seed(0)
    qt = random_qtensor(codebook, layout, 256, 1376, gen, "cpu")
    whole = Q.to_nibble(qt).planes
    rows = [cut_planes(qt, rows=(r * 128, (r + 1) * 128)) for r in (0, 1)]
    cols = [cut_planes(qt, groups=(r * 86, (r + 1) * 86)) for r in (0, 1)]
    for part in rows + cols:
        assert part.layout == layout and part.codebook_id == codebook
    for k, v in whole.items():
        got = torch.cat([Q.to_nibble(p).planes[k] for p in rows])
        assert torch.equal(got, v), k
        nib = [Q.to_nibble(p).planes[k] for p in cols]
        assert all(n.shape[1] == 128 and not n[:, 86:].any() for n in nib)
        assert torch.equal(torch.cat([n[:, :86] for n in nib], dim=1),
                           v[:, :172]), k
    assert np.array_equal(np.concatenate([Q.to_raw_idxs(p) for p in cols],
                                         axis=1), Q.to_raw_idxs(qt))
