"""The port's microbenchmarks (quip_for_all_tpu_torch/tools, T1-T5)
against the JAX package's tools/microbench_*.py kernels, run in interpret
mode on the CPU, on the same numpy-seeded inputs at N = 256, K = 1024,
m = 1 and 8 (TN = 128 or 256 rows per Pallas grid step).

The tools are loaded from their files, as they are: T2 takes
``interpret=True``; T3-T5 read ``_INTERPRET``, set here with monkeypatch;
T1 imports ``_e8p_planes``, which the JAX package no longer has (removed
with the affine-nibble format), so its last definition is injected into
``quip_for_all_tpu.ops.dequant_pallas`` for the import and T1's ``pl`` is
replaced by a namespace whose ``pallas_call`` runs in interpret mode. The
tools' ``run_shape``/``record``/``main`` are never called: they append to
tools/R4_RESULTS.jsonl.

On the CPU each wrapper takes its plain twin; on a card the kernels are
held against the same twins in tests/test_torch_microbench_cuda.py.

Tolerances: bf16 outputs within 1 bf16 ulp of the element + 1e-5 of the
max (sums run in another order, the cast may round the other way); f32
outputs within 1e-5 of the max. The stream variants: the JAX tool
broadcasts one f32 sum per TN-row tile (cast to its output dtype), the
port gives one f32 sum per row; the port's rows are summed over each tile
in f64 and held to the tile's value within 1e-5 of it (f32 sums of up to
2^15 terms), plus one bf16 ulp where the tool's output is bf16.
"""
import functools
import importlib.util
import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from quip_for_all_tpu.ops import dequant_pallas

from quip_for_all_tpu_torch.ops import fused_matmul as fm
from quip_for_all_tpu_torch.ops import layout_matmul as lm
from quip_for_all_tpu_torch.ops.qtensor import QuantizedTensor, to_bfp
from quip_for_all_tpu_torch.tools import microbench_bfp as tb
from quip_for_all_tpu_torch.tools import microbench_decode as td
from quip_for_all_tpu_torch.tools import microbench_kernel as tk
from quip_for_all_tpu_torch.tools import microbench_split as ts
from quip_for_all_tpu_torch.tools import microbench_tn as tt

from test_torch_fused_matmul import assert_close, bf16_ulp

pytestmark = pytest.mark.fast

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, K = 256, 1024
G = K // 8


def _e8p_planes(w_i32):
    """quip_for_all_tpu/ops/dequant_pallas.py:_e8p_planes as of commit
    215c096, the last that had it."""
    w = pltpu.bitcast(w_i32, jnp.uint32)
    parity = ((w >> 24) & 1).astype(jnp.int32)
    offm = jnp.float32(-2.25) - 0.5 * parity.astype(jnp.float32)
    return [((w >> (3 * i)) & 7).astype(jnp.int32).astype(jnp.float32)
            + offm for i in range(8)]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jt1(monkeypatch):
    monkeypatch.setattr(dequant_pallas, "_e8p_planes", _e8p_planes,
                        raising=False)
    mod = _load("microbench_kernel")
    monkeypatch.setattr(mod, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec))
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """Load a T3-T5 tool with its Pallas calls in interpret mode."""
    def get(name):
        mod = _load(name)
        monkeypatch.setattr(mod, "_INTERPRET", True)
        return mod
    return get


def _np(t):
    return t.to(torch.float32).numpy()


def _jbf16(t):
    return jnp.asarray(_np(t)).astype(jnp.bfloat16)


def _assert_tiles(rows, tool_out, TN, bf16):
    """Per-row f32 sums (N,) against the tool's per-tile value."""
    tiles = rows.to(torch.float64).reshape(-1, TN).sum(dim=1).numpy()
    want = np.asarray(tool_out.astype(jnp.float32))
    assert np.all(want == want[:1]), "the tool broadcasts over the m rows"
    want = want[0].reshape(-1, TN)
    assert np.all(want == want[:, :1]), "one value per TN-row tile"
    want = want[:, 0].astype(np.float64)
    tol = 1e-5 * np.abs(want)
    if bf16:
        tol = tol + bf16_ulp(np.abs(want).astype(np.float32))
    assert np.all(np.abs(tiles - want) <= tol), np.abs(tiles - want).max()


# --------------------------------------------------------------- T1

@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("variant", list(tk.VARIANTS))
def test_t1_twin_matches_the_tool(jt1, variant, m):
    x, w = tk.make_inputs(N, K, m, "cpu", seed=m)
    TN = 128
    want = jt1.make_call(variant, N, K, TN, m)(_jbf16(x), jnp.asarray(
        w.numpy()))
    before = tk.WRAPPERS[variant].launches
    if variant == "stream":
        got = tk.stream(w)
        assert got.shape == (N,) and got.dtype == torch.float32
        _assert_tiles(got, want, TN, bf16=True)
    else:
        got = tk.WRAPPERS[variant](x, w)
        assert got.shape == (m, N) and got.dtype == torch.bfloat16
        assert_close(_np(got), np.asarray(want.astype(jnp.float32)),
                     "bfloat16")
    assert tk.WRAPPERS[variant].launches == before


def test_t1_nodec_rounds_as_the_tool():
    """nodec's convert: torch's int32 -> bf16 (the twin's) equals JAX's on
    words below 2^25, ties included."""
    w = np.concatenate([np.random.default_rng(0).integers(
        0, 1 << 25, 1 << 16), np.arange((1 << 24) - 64, (1 << 24) + 64),
        (np.arange(64) << 17) + (1 << 16)]).astype(np.int32)
    got = torch.from_numpy(w).to(torch.bfloat16).to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(w).astype(jnp.bfloat16).astype(
        jnp.float32))
    assert np.array_equal(got, want)


# --------------------------------------------------------------- T2

@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("strategy", list(td.STRATEGIES))
def test_t2_twin_matches_the_tool(strategy, m):
    jt2 = _load("microbench_decode")
    x, codes, W, cols, lohi = td.make_inputs(N, K, m, "cpu", seed=m)
    TN = 128
    _, single = jt2.make_run(strategy, N, K, TN, m, iters=1, interpret=True)
    arg = (jnp.asarray(_np(W)).astype(jnp.bfloat16) if strategy == "dense"
           else jnp.asarray(codes.numpy()))
    want = single(jnp.asarray(x.numpy()), arg)
    wrapper = td.WRAPPERS[strategy]
    before = wrapper.launches
    if strategy == "stream":
        got = td.stream(codes)
        assert got.shape == (N,) and got.dtype == torch.float32
        _assert_tiles(got, want, TN, bf16=False)
    else:
        args = {"lane": (x, codes, cols), "lane_b": (x, codes, lohi),
                "dense": (x, W)}[strategy]
        got = wrapper(*args)
        assert got.shape == (m, N) and got.dtype == torch.float32
        assert_close(got.numpy(), np.asarray(want), "float32")
    assert wrapper.launches == before


def test_t2_decode_is_the_codebook():
    """lane's planes, as the matvec sees them, are the E8P12 full grid in
    x's lane order: the twin equals x_perm @ w_perm^T (f32, 1e-5)."""
    x, codes, W, cols, lohi = td.make_inputs(N, K, 8, "cpu", seed=3)
    # W is bf16(w_perm); every grid value is exact in bf16
    want = x @ W.to(torch.float32).T
    for got in (td.lane(x, codes, cols), td.lane_b(x, codes, lohi),
                td.dense(x, W)):
        assert_close(got.numpy(), want.numpy(), "float32")
    assert torch.equal(td.stream(codes),
                       codes.to(torch.int64).sum(dim=1).to(torch.float32))


# --------------------------------------------------------------- T3

@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("P", [1, 2, 4])
def test_t3_is_k1_and_k11(interpret, P, m):
    """The tool's split-P kernel is K1 (P = 1) or K11 (P = 2, 4) on the
    int16 / int8 view of the same words, with x in its ``x_layout``."""
    jt3 = interpret("microbench_split")
    x_nat, words = ts.make_inputs(N, K, m, "cpu", seed=P + m)
    Gp = words.shape[1]
    assert Gp == G                     # K = 1024: no pad groups
    xp = ts.x_layout(x_nat, P, G, Gp).to(torch.bfloat16)
    assert np.array_equal(_np(xp), np.asarray(jnp.asarray(jt3.x_layout(
        x_nat.numpy(), P, G, Gp)).astype(jnp.bfloat16).astype(jnp.float32)))
    plane = {1: words.numpy(), 2: words.numpy().view(np.int16),
             4: words.numpy().view(np.int8)}[P]
    want = jt3.make_call(P, N, Gp, m, 128)(_jbf16(xp), jnp.asarray(plane))
    before = ts.wrapper(P).launches
    got = ts.split_call(P, xp, words)
    assert ts.wrapper(P).launches == before
    assert got.shape == (m, N) and got.dtype == torch.bfloat16
    assert_close(_np(got), np.asarray(want.astype(jnp.float32)), "bfloat16")


# --------------------------------------------------------------- T4

@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("TN", [128, 256])
@pytest.mark.parametrize("variant", ["nib", "dma"])
def test_t4_twin_matches_the_tool(interpret, variant, TN, m):
    jt4 = interpret("microbench_tn")
    x, w = tt.make_inputs(N, K, m, "cpu", seed=TN + m)
    mk = jt4.make_nibble_call if variant == "nib" else jt4.make_dma_call
    want = mk(N, w.shape[1], m, TN)(_jbf16(x), jnp.asarray(w.numpy()))
    wrapper = tt.WRAPPERS[variant]
    before = wrapper.launches
    for rpb in tt.ROWS_PER_BLOCK:
        got = wrapper(x, w, rpb)
        assert got.shape == (m, N) and got.dtype == torch.bfloat16
        assert_close(_np(got), np.asarray(want.astype(jnp.float32)),
                     "bfloat16")
    assert wrapper.launches == before


# --------------------------------------------------------------- T5

def test_t5_bitcast_order_is_the_tools(interpret):
    """The tool's probe in interpret mode and the port's (its twin here)
    report the same order, the one K10 decodes."""
    jt5 = interpret("microbench_bfp")
    assert jt5.discover_bitcast_order() == (True, True)
    assert tb.discover_bitcast_order("cpu") == tb.K10_ORDER == (True, True)
    w = torch.from_numpy(tb.probe_words())
    out = tb.bitcast_probe(w)
    assert out.shape == (16, 128) and out.dtype == torch.bfloat16
    assert torch.equal(out[:, 0].float(), torch.arange(16.0))


@pytest.mark.parametrize("order", [(True, True), (True, False),
                                   (False, True), (False, False)])
def test_t5_pack_bfp_is_the_tools(interpret, order):
    jt5 = interpret("microbench_bfp")
    _, words = tb.make_inputs(N, K, 1, "cpu", seed=2)
    a, b = jt5.pack_bfp(words.numpy(), *order)
    got = tb.pack_bfp(words, *order)
    assert got.dtype == torch.int32 and got.shape == (2, N // 2, G)
    assert np.array_equal(got[0].numpy(), a)
    assert np.array_equal(got[1].numpy(), b)


def test_t5_pack_bfp_is_to_bfp():
    """In the order the probe reports, the tool's packing is the port's
    runtime bfp layout, bit for bit: make_bfp_call's planes are K10's."""
    _, words = tb.make_inputs(N, K, 1, "cpu", seed=5)
    qt = to_bfp(QuantizedTensor({"w0": words}, "E8P12", N, K))
    assert torch.equal(tb.pack_bfp(words, *tb.K10_ORDER), qt.planes["w0"])


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("variant", ["base", "bfp"])
def test_t5_is_k1_and_k10(interpret, variant, m):
    jt5 = interpret("microbench_bfp")
    x, words = tb.make_inputs(N, K, m, "cpu", seed=7 + m)
    Gp = words.shape[1]
    if variant == "base":
        want = jt5.make_base_call(N, Gp, m, 128)(_jbf16(x), jnp.asarray(
            words.numpy()))
        counter, got = fm.fused_decode_matmul, None
    else:
        a, b = jt5.pack_bfp(words.numpy(), True, True)
        want = jt5.make_bfp_call(N, Gp, m, 128)(
            _jbf16(x), jnp.asarray(a), jnp.asarray(b))
        counter = lm.bfp_decode_matmul
    before = counter.launches
    got = (tb.base_call(x, words) if variant == "base"
           else tb.bfp_call(x, tb.pack_bfp(words, True, True)))
    assert counter.launches == before
    assert got.shape == (m, N) and got.dtype == torch.bfloat16
    assert_close(_np(got), np.asarray(want.astype(jnp.float32)), "bfloat16")


# ------------------------------------------------------- the wrappers

def test_wrappers_reject_what_the_kernels_do_not_take():
    x, w = tk.make_inputs(64, 256, 2, "cpu")
    with pytest.raises(ValueError):                 # width != 8G
        tk.prod(x[:, :128].contiguous(), w)
    with pytest.raises(ValueError):                 # dtype of x
        tk.prod(x.float(), w)
    with pytest.raises(ValueError):                 # not contiguous
        tk.nodec(x, w.T.contiguous().T)
    with pytest.raises(ValueError):                 # G not a multiple of 4
        tk.stream(w[:, :30].contiguous())
    with pytest.raises(RuntimeError):               # no kernel here
        tk.stream(w.to("meta"))
    xt, wt = tt.make_inputs(64, 1024, 2, "cpu")
    with pytest.raises(ValueError):                 # rows per block
        tt.nib(xt, wt, 24)
    with pytest.raises(ValueError):
        tt.dma(xt.float(), wt)
    xd, codes, W, cols, lohi = td.make_inputs(64, 1024, 2, "cpu")
    with pytest.raises(ValueError):                 # table of the other kind
        td.lane(xd, codes, lohi)
    with pytest.raises(ValueError):                 # codes must be int16
        td.lane_b(xd, codes.to(torch.int32), lohi)
    with pytest.raises(ValueError):                 # K not a multiple of 64
        td.dense(xd[:, :1000].contiguous(), W[:, :1000].contiguous())
    with pytest.raises(ValueError):
        tb.bitcast_probe(torch.zeros((8, 128), dtype=torch.int16))


@pytest.mark.parametrize("tool", ["microbench_kernel", "microbench_decode",
                                  "microbench_split", "microbench_tn",
                                  "microbench_bfp"])
def test_main_on_the_cpu_checks_the_twins_and_times_nothing(tool, capsys):
    import json
    mod = {"microbench_kernel": tk, "microbench_decode": td,
           "microbench_split": ts, "microbench_tn": tt,
           "microbench_bfp": tb}[tool]
    shape = (["--N", "128", "--K", "512"] if tool in (
        "microbench_kernel", "microbench_decode")
        else ["--shapes", "128x512"])
    assert mod.main(shape + ["--m", "2", "--device", "cpu"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert recs and all(r["ok"] and r["device"] == "cpu" and r["us"] is None
                        and r["launches"] == 0 and r["bound_us"] > 0
                        for r in recs)
