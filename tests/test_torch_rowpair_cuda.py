"""The row-pair CUDA kernels (u3, pb) against their plain twins, on a card.
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


def _check(layout, q_out, q_in, m, dtype, device, seed, mp=None):
    planes, Gp = _planes(layout, q_out, q_in, device, seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.randn((mp or m, 8 * Gp), generator=g, device=device).to(dtype)
    scale = torch.rand(q_out, generator=g, device=device) + 0.5
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
