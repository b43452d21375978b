"""The bfp (K10), sw2/sw4 (K11), split-K (K6) and paired (K7) CUDA kernels
against their plain twins, on a card. This file imports neither JAX nor
the JAX package (the card's machine has no JAX), so it runs there without
tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_layout_cuda.py

Without a card every test skips. Tolerance: f32 outputs within
1e-5 * max|ref| (sums differ in order); bf16 outputs within that plus one
bf16 ulp of the element. Planes are random bits, so every nibble (0..15)
and every 3-bit u (0..7) occurs.
"""
import pytest
import torch

from quip_for_all_tpu_torch.ops import layout_matmul as lm
from quip_for_all_tpu_torch.ops import rowpair_matmul as rm
from quip_for_all_tpu_torch.ops.qtensor import paired_wp

pytestmark = [pytest.mark.fast, pytest.mark.cuda]

RS = 1 / 3.45
AFFINE = {1: ((0.5, -2.75),), 2: ((0.5, -2.75), (0.5 * RS, -2.75 * RS))}
# Llama-2-7B's fused qkv, o, fused gate/up, down and head
SHAPES_7B = [(12288, 4096), (4096, 4096), (22016, 4096), (4096, 11008),
             (32000, 4096)]
KERNELS = ["bfp", "sw2", "sw4", "ksplit", "paired"]


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


def _bits(shape, g, device, dtype=torch.int32):
    w = torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=g,
                      device=device, dtype=torch.int64).to(torch.int32)
    return w if dtype == torch.int32 else w.view(dtype)


def _case(kernel, q_out, q_in, n_sets, device, seed, chunks=2):
    """(planes, Gp, call(x, scale, rows), twin(x, scale, rows), counter)."""
    g = torch.Generator(device=device).manual_seed(seed)
    G = q_in // 8
    aff = AFFINE[n_sets]
    if kernel == "paired":
        Gp = -(-G // 256) * 256
        planes = {"w0": _bits((q_out, Gp), g, device),
                  "w1": _bits((q_out, Gp // 2), g, device),
                  "w2": _bits((q_out, paired_wp(Gp)), g, device)}
        return (Gp,
                lambda x, s, r: rm.paired_decode_matmul(x, planes, RS, s,
                                                        rows=r),
                lambda x, s, r: rm.rowpair_matmul_ref(x, "paired", planes, RS,
                                                      s, rows=r),
                rm.paired_decode_matmul)
    Gp = -(-G // 128) * 128
    if kernel == "bfp":
        planes = [_bits((2, q_out // 2, Gp), g, device)
                  for _ in range(n_sets)]
        fn, twin = lm.bfp_decode_matmul, lm.bfp_decode_matmul_ref
    elif kernel in ("sw2", "sw4"):
        dt = torch.int16 if kernel == "sw2" else torch.int8
        planes = [_bits((q_out, Gp), g, device, dt) for _ in range(n_sets)]
        fn, twin = lm.sw_decode_matmul, lm.sw_decode_matmul_ref
    else:
        planes = [_bits((q_out, Gp), g, device) for _ in range(n_sets)]
        return (Gp,
                lambda x, s, r: lm.ksplit_decode_matmul(x, planes, aff,
                                                        chunks, s, rows=r),
                lambda x, s, r: lm.ksplit_decode_matmul_ref(x[:r], planes,
                                                            aff, chunks, s),
                lm.ksplit_decode_matmul)
    return (Gp, lambda x, s, r: fn(x, planes, aff, s, rows=r),
            lambda x, s, r: twin(x[:r], planes, aff, s), fn)


def _check(kernel, q_out, q_in, m, dtype, device, seed, n_sets=1, mp=None,
           chunks=2):
    Gp, call, twin, counter = _case(kernel, q_out, q_in, n_sets, device,
                                    seed, chunks)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.randn((mp or m, 8 * Gp), generator=g, device=device).to(dtype)
    scale = torch.rand(q_out, generator=g, device=device) + 0.5
    before = counter.launches
    got = call(x, scale, m)
    want = twin(x, scale, m)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert got.shape == (m, q_out) and got.dtype == dtype
    assert torch.isfinite(got.float()).all()
    _close(got, want, dtype)


@pytest.mark.parametrize("m,dtype", [(1, torch.bfloat16), (8, torch.bfloat16),
                                     (32, torch.bfloat16),
                                     (1, torch.float32)])
@pytest.mark.parametrize("q_out,q_in", SHAPES_7B)
@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_matches_plain_twin_at_7b_shapes(cuda, kernel, q_out, q_in, m,
                                                dtype):
    # split-K: 4 chunks of the 512-group rows; down's 1408 groups (11 lane
    # blocks) split only 11 ways
    chunks = 11 if q_in == 11008 else 4
    _check(kernel, q_out, q_in, m, dtype, cuda, seed=q_out + m,
           chunks=chunks)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,mp", [(1, 8), (2, 8), (3, 8), (5, 8), (9, 16),
                                  (32, 32), (40, 40), (64, 64)])
@pytest.mark.parametrize("q_out", [192, 200])
@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_matches_plain_twin_at_ragged_shapes(cuda, kernel, q_out, m,
                                                    mp, dtype):
    """An even q_out that is (200) and is not (192) a multiple of a block's
    rows, every accumulator size, pad rows past m, both group-sum roundings
    (paired), 2 plane sets where the kernel takes them."""
    n_sets = 1 if kernel == "paired" else 1 + m % 2
    _check(kernel, q_out, 1376 * 8 if kernel == "paired" else 4096, m,
           dtype, cuda, seed=m + q_out, n_sets=n_sets, mp=mp)


@pytest.mark.parametrize("chunks", [2, 3, 4, 11])
def test_ksplit_chunk_counts(cuda, chunks):
    """Chunks of 128-group multiples, and 3 chunks of a 384-group row."""
    q_in = 11264 if chunks == 11 else (3072 if chunks == 3 else 4096)
    _check("ksplit", 4096, q_in, 1, torch.bfloat16, cuda, seed=chunks,
           chunks=chunks)


@pytest.mark.parametrize("kernel", KERNELS)
def test_a_call_replays_in_a_cuda_graph(cuda, kernel):
    """The wrapper reads nothing back to the host: one call captured in a
    CUDA graph replays on new x in place (split-K's workspace comes from
    the graph's pool)."""
    Gp, call, twin, _ = _case(kernel, 192, 4096, 1, cuda, seed=7)
    x = torch.randn((1, 8 * Gp), device=cuda).to(torch.bfloat16)
    call(x, None, 1)                                    # build + warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call(x, None, 1)
    for seed in (1, 2):
        x.copy_(torch.randn(x.shape, generator=torch.Generator(
            device=cuda).manual_seed(seed), device=cuda))
        graph.replay()
        torch.cuda.synchronize()
        _close(out, twin(x, None, 1), x.dtype)


def test_misaligned_planes_raise(cuda):
    w = torch.zeros(128 * 512 + 1, dtype=torch.int32, device=cuda)
    bad = w[1:].view(128, 512)                          # 4 bytes off
    x = torch.zeros((1, 8 * 512), device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        lm.ksplit_decode_matmul(x, [bad], AFFINE[1], 2)
    with pytest.raises(ValueError, match="aligned"):
        lm.sw_decode_matmul(x, [bad.view(torch.int16)], AFFINE[1])
