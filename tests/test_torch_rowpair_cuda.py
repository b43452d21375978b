"""The row-pair CUDA kernels (u3 and pb, both on the tensor-core body
csrc/ucode_mma_small.cuh) against their plain twins, on a card.
This file imports neither JAX nor the JAX package (the card's machine has
no JAX), so it runs there without tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rowpair_cuda.py

Without a card every test skips. Tolerance: f32 outputs within
1e-5 * max|ref| (sums differ in order); bf16 outputs within that plus one
bf16 ulp of the element. Planes are random bits, so every 3-bit u (0..7)
occurs.
"""
import pytest
import torch

from quip_for_all_tpu_torch.ops import rowpair_matmul as rm
from quip_for_all_tpu_torch.ops.qtensor import (pb_parity_lanes,
                                                u3_parity_lanes)

pytestmark = [pytest.mark.fast, pytest.mark.cuda]

RS = 1 / 3.45
# Llama-2-7B's fused qkv, o, fused gate/up, down and head
SHAPES_7B = [(12288, 4096), (4096, 4096), (22016, 4096), (4096, 11008),
             (32000, 4096)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    got, want = got.float().cpu(), want.float().cpu()
    tol = 1e-5 * want.abs().max()
    if dtype == torch.bfloat16:
        a = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
        tol = tol + torch.exp2(torch.floor(torch.log2(a)) - 7)
    assert torch.all((got - want).abs() <= tol), (got - want).abs().max()


def _planes(layout, q_out, q_in, device, seed):
    G = q_in // 8
    half = q_out // 2
    if layout == "u3":
        Gp = -(-G // 256) * 256
        shapes = {"w0": (half, Gp), "w1": (half, Gp // 2),
                  "w2": (half, u3_parity_lanes(Gp))}
    else:
        Gp = -(-G // 128) * 128
        shapes = {"w0": (2, half, Gp), "w1": (half, Gp),
                  "w2": (half, pb_parity_lanes(Gp))}
    g = torch.Generator(device=device).manual_seed(seed)
    return {k: torch.randint(-2 ** 31, 2 ** 31 - 1, s, generator=g,
                             device=device, dtype=torch.int64).to(torch.int32)
            for k, s in shapes.items()}, Gp


def _call(layout, x, planes, scale=None, rows=None):
    if layout == "u3":
        return rm.rowpair_u3_matmul(x, planes, scale, rows=rows)
    return rm.rowpair_pb_matmul(x, planes, RS, scale, rows=rows)


def _check(layout, q_out, q_in, m, dtype, device, seed, mp=None,
           with_scale=True):
    planes, Gp = _planes(layout, q_out, q_in, device, seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.randn((mp or m, 8 * Gp), generator=g, device=device).to(dtype)
    scale = torch.rand(q_out, generator=g, device=device) + 0.5
    scale = scale if with_scale else None
    counter = getattr(rm, f"rowpair_{layout}_matmul")
    before = counter.launches
    got = _call(layout, x, planes, scale, rows=m)
    want = rm.rowpair_matmul_ref(x, layout, planes, RS, scale, rows=m)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert got.shape == (m, q_out) and got.dtype == dtype
    assert torch.isfinite(got.float()).all()
    _close(got, want, dtype)


@pytest.mark.parametrize("m,dtype", [(1, torch.bfloat16), (8, torch.bfloat16),
                                     (32, torch.bfloat16),
                                     (1, torch.float32)])
@pytest.mark.parametrize("q_out,q_in", SHAPES_7B)
@pytest.mark.parametrize("layout", ["u3", "pb"])
def test_kernel_matches_plain_twin_at_7b_shapes(cuda, layout, q_out, q_in, m,
                                                dtype):
    _check(layout, q_out, q_in, m, dtype, cuda, seed=q_out + m)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,mp", [(1, 8), (2, 8), (3, 8), (5, 8), (9, 16),
                                  (32, 32), (40, 40), (64, 64)])
@pytest.mark.parametrize("layout", ["u3", "pb"])
def test_kernel_matches_plain_twin_at_a_ragged_q_out(cuda, layout, m, mp,
                                                     dtype):
    """q_out 200 (100 row pairs: no multiple of a block's pairs), every
    accumulator size, pad rows past m, both group-sum roundings."""
    _check(layout, 200, 1376 * 8, m, dtype, cuda, seed=m, mp=mp)


@pytest.mark.parametrize("with_scale", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", list(range(1, 10)) + [16, 17, 24, 31, 32, 33,
                                                     64, 65])
def test_pb_row_tiles(cuda, m, dtype, with_scale):
    """K8's tensor-core body at the edges of 1, 2 and 4 n8 tiles of rows and
    across blocks of 32 rows (33, 64, 65), at a ragged q_out (100 row
    pairs) and down's 1408 groups, x padded to a multiple of 8 rows as the
    dispatch pads it (both group-sum roundings)."""
    _check("pb", 200, 11008, m, dtype, cuda, seed=m, mp=max(8, -(-m // 8) * 8),
           with_scale=with_scale)


@pytest.mark.parametrize("with_scale", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", list(range(1, 10)) + [16, 17, 24, 31, 32, 33,
                                                     64, 65])
def test_u3_row_tiles(cuda, m, dtype, with_scale):
    """K9's tensor-core body (one code set, two m16 tiles a warp) at the
    edges of 1, 2 and 4 n8 tiles of rows and across blocks of 32 rows, at
    a ragged q_out (100 row pairs) and down's 1536 groups (both halves of
    w1, 12 parity fields), x padded to a multiple of 8 rows as the
    dispatch pads it (both group-sum roundings)."""
    _check("u3", 200, 11008, m, dtype, cuda, seed=m, mp=max(8, -(-m // 8) * 8),
           with_scale=with_scale)


@pytest.mark.parametrize("m", [1, 8, 32, 65])
def test_u3_is_deterministic_and_replays_in_a_graph(cuda, m):
    """As the pb test below: the same bits on a second call and a graph
    replay, and only the u3 counter moves."""
    planes, Gp = _planes("u3", 4096, 11008, cuda, seed=6)
    x = torch.randn((max(8, -(-m // 8) * 8), 8 * Gp),
                    generator=torch.Generator(device=cuda).manual_seed(6),
                    device=cuda).to(torch.bfloat16)
    before = (rm.rowpair_u3_matmul.launches, rm.rowpair_pb_matmul.launches)
    first = _call("u3", x, planes, rows=m)
    again = _call("u3", x, planes, rows=m)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _call("u3", x, planes, rows=m)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(again, first) and torch.equal(out, first)
    after = (rm.rowpair_u3_matmul.launches, rm.rowpair_pb_matmul.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (3, 0)
    _close(first, rm.rowpair_matmul_ref(x, "u3", planes, RS, rows=m),
           torch.bfloat16)


@pytest.mark.parametrize("m", [1, 8, 32, 65])
def test_pb_is_deterministic_and_replays_in_a_graph(cuda, m):
    """A second call and a CUDA-graph replay give the first call's bits (a
    block's warps add their partial sums in a fixed order), and only the pb
    counter moves."""
    planes, Gp = _planes("pb", 4096, 11008, cuda, seed=5)
    x = torch.randn((max(8, -(-m // 8) * 8), 8 * Gp), generator=torch.Generator(
        device=cuda).manual_seed(5), device=cuda).to(torch.bfloat16)
    before = (rm.rowpair_pb_matmul.launches, rm.rowpair_u3_matmul.launches,
              rm.paired_decode_matmul.launches)
    first = _call("pb", x, planes, rows=m)
    again = _call("pb", x, planes, rows=m)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _call("pb", x, planes, rows=m)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(again, first) and torch.equal(out, first)
    after = (rm.rowpair_pb_matmul.launches, rm.rowpair_u3_matmul.launches,
             rm.paired_decode_matmul.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (3, 0, 0)
    _close(first, rm.rowpair_matmul_ref(x, "pb", planes, RS, rows=m),
           torch.bfloat16)


@pytest.mark.parametrize("layout", ["u3", "pb"])
def test_a_call_replays_in_a_cuda_graph(cuda, layout):
    """The wrapper reads nothing back to the host: one call captured in a
    CUDA graph replays on new x in place."""
    planes, Gp = _planes(layout, 192, 4096, cuda, seed=7)
    x = torch.randn((1, 8 * Gp), device=cuda).to(torch.bfloat16)
    _call(layout, x, planes)                          # build + warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _call(layout, x, planes)
    for seed in (1, 2):
        x.copy_(torch.randn(x.shape, generator=torch.Generator(
            device=cuda).manual_seed(seed), device=cuda))
        graph.replay()
        torch.cuda.synchronize()
        _close(out, rm.rowpair_matmul_ref(x, layout, planes, RS), x.dtype)


def test_misaligned_planes_raise(cuda):
    planes, Gp = _planes("u3", 128, 4096, cuda, seed=3)
    flat = torch.zeros(planes["w0"].numel() + 1, dtype=torch.int32,
                       device=cuda)
    bad = dict(planes, w0=flat[1:].view(planes["w0"].shape))   # 4-byte off
    with pytest.raises(ValueError, match="aligned"):
        rm.rowpair_u3_matmul(torch.zeros((1, 8 * Gp), device=cuda), bad)


@pytest.mark.parametrize("layout", ["pb", "paired"])
def test_ucode_entries_refuse_a_beta_the_codes_do_not_carry(cuda, layout):
    """K8 and K7 carry beta = 2.25*(1+rs) in their codes: their C entry
    points refuse any other beta (cudaErrorInvalidValue, 1) instead of
    ignoring it, and take the wrapper's own."""
    from quip_for_all_tpu_torch.ops._build import load
    from quip_for_all_tpu_torch.utils.random_quantized import random_qtensor
    g = torch.Generator(device=cuda).manual_seed(9)
    qt = random_qtensor("E8P12RVQ4B", layout, 192, 4096, g, cuda)
    planes, rs = qt.planes, qt.opt_resid_scale
    Gp, PL = planes["w0"].shape[-1], planes["w2"].shape[-1]
    x = torch.randn((8, 8 * Gp), generator=g, device=cuda).to(torch.bfloat16)
    entry = ("qfa_paired_decode_matmul" if layout == "paired"
             else "qfa_rowpair_pb_matmul")
    out = rm._launch(entry + "_ex", x, layout, planes, rs, None, 1)
    torch.cuda.synchronize()
    _close(out, rm.rowpair_matmul_ref(x, layout, planes, rs, rows=1),
           torch.bfloat16)
    fn = getattr(load(rm.PAIRED_KERNEL if layout == "paired" else rm.KERNEL),
                 entry + "_ex")
    beta = 2.25 * (1 + rs)
    for bad in (beta + 0.01 * max(1.0, abs(beta)), beta - 0.01, 2.25 * rs):
        err = fn(x.data_ptr(), planes["w0"].data_ptr(),
                 planes["w1"].data_ptr(), planes["w2"].data_ptr(), None,
                 None, out.data_ptr(), 1, 192, Gp, PL, float(rs), bad, 0, 1,
                 0, torch.cuda.current_stream().cuda_stream)
        assert err == 1, (bad, err)


def test_u3_entry_refuses_a_beta_the_codes_do_not_carry(cuda):
    """K9's codes carry beta = 2.25 (4u - 9): its C entry point refuses any
    other (cudaErrorInvalidValue, 1) and takes the wrapper's."""
    from quip_for_all_tpu_torch.ops._build import load
    planes, Gp = _planes("u3", 192, 4096, cuda, seed=9)
    PL = planes["w2"].shape[-1]
    x = torch.randn((8, 8 * Gp), device=cuda).to(torch.bfloat16)
    out = rm._launch("qfa_rowpair_u3_matmul_ex", x, "u3", planes, -1.0, None,
                     1)
    torch.cuda.synchronize()
    _close(out, rm.rowpair_matmul_ref(x, "u3", planes, rows=1),
           torch.bfloat16)
    fn = load(rm.KERNEL).qfa_rowpair_u3_matmul_ex
    for bad in (2.26, 2.24, 0.0):
        err = fn(x.data_ptr(), planes["w0"].data_ptr(),
                 planes["w1"].data_ptr(), planes["w2"].data_ptr(), None,
                 None, out.data_ptr(), 1, 192, Gp, PL, -1.0, bad, 0, 1, 0,
                 torch.cuda.current_stream().cuda_stream)
        assert err == 1, (bad, err)
