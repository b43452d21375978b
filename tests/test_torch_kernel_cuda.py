"""K1 and K2, the CUDA kernels of ``fused_decode_matmul``, against their
plain twin, on a card: calls of at most 32 rows launch K1
(csrc/fused_decode_matmul.cu), larger ones K2, the tensor-core kernel
(csrc/fused_decode_matmul_tc.cu). This file imports neither JAX nor the
JAX package (the card's machine has no JAX), so it runs there without
tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py

Without a card every test skips. Tolerance: f32 outputs within
1e-5 * max|ref| (products are exact; sums differ in order); bf16 outputs
within that plus one bf16 ulp of the element.
"""
import pytest
import torch

from quip_for_all_tpu_torch.ops import fused_matmul as fm

pytestmark = [pytest.mark.fast, pytest.mark.cuda]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    got, want = got.float().cpu(), want.float().cpu()
    tol = 1e-5 * want.abs().max()
    if dtype == torch.bfloat16:
        a = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
        tol = tol + torch.exp2(torch.floor(torch.log2(a)) - 7)
    assert torch.all((got - want).abs() <= tol), (got - want).abs().max()


def _planes(q_out, Gp, n_sets, device, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(-2 ** 31, 2 ** 31 - 1, (q_out, Gp), generator=g,
                          dtype=torch.int64).to(torch.int32).to(device)
            for _ in range(n_sets)]


def _counts():
    return (fm.fused_decode_matmul.launches,
            fm.fused_decode_matmul_tc.launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_sets", [1, 2])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8, 9, 16, 17, 24, 31, 32, 33,
                               40, 63, 64, 65, 127, 1022])
@pytest.mark.parametrize("q_out,Gp", [(128, 128), (200, 1408), (4096, 512)])
def test_kernel_matches_plain_twin(cuda, q_out, Gp, m, n_sets, dtype):
    """Ragged q_out (200 is no multiple of a block's channels) and m (x
    padded to 8 rows as the main path pads it, the real m computed), K1's
    edges of 1, 2 and 4 n8 tiles of rows (4, 5, 9, 16, 17, 24, 31, 32) and
    K2 above 32 rows, both plane-set counts, both dtypes; the counter of
    the kernel that ran moves by one."""
    planes = _planes(q_out, Gp, n_sets, cuda, seed=m + q_out)
    affine = ((0.5, -2.75), (0.5 / 3.45, -2.75 / 3.45))[:n_sets]
    g = torch.Generator().manual_seed(m)
    mp = max(8, -(-m // 8) * 8)
    x = torch.randn((mp, 8 * Gp), generator=g).to(dtype).to(cuda)
    scale = (torch.rand(q_out, generator=g) + 0.5).to(cuda)
    before = _counts()
    got = fm.fused_decode_matmul(x, planes, affine, scale, rows=m)
    want = fm.fused_decode_matmul_ref(x[:m], planes, affine, scale)
    torch.cuda.synchronize()
    moved = tuple(a - b for a, b in zip(_counts(), before))
    assert moved == ((1, 0) if m <= fm.K1_MAX_ROWS else (0, 1))
    assert got.shape == (m, q_out) and got.dtype == dtype
    _close(got, want, dtype)


def test_k2_is_deterministic_and_replays_in_a_graph(cuda):
    """K2 at a training shape: a second call and a CUDA-graph replay give
    the first call's bits, and only K2's counter moves."""
    planes = _planes(4096, 512, 2, cuda, seed=3)
    affine = ((0.5, -2.75), (0.5 / 3.45, -2.75 / 3.45))
    g = torch.Generator().manual_seed(3)
    x = torch.randn((1024, 8 * 512), generator=g).to(torch.bfloat16).to(cuda)
    before = _counts()
    first = fm.fused_decode_matmul(x, planes, affine, rows=1022)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        again = fm.fused_decode_matmul(x, planes, affine, rows=1022)
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fm.fused_decode_matmul(x, planes, affine, rows=1022)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(again, first) and torch.equal(out, first)
    assert tuple(a - b for a, b in zip(_counts(), before)) == (0, 3)


@pytest.mark.parametrize("m", [1, 8, 32])
def test_k1_is_deterministic_and_replays_in_a_graph(cuda, m):
    """K1 at a decode shape: a second call and a CUDA-graph replay give the
    first call's bits (the partial sums of a block's warps meet in a fixed
    order), and only K1's counter moves."""
    planes = _planes(4096, 1408, 1, cuda, seed=5)
    g = torch.Generator().manual_seed(5)
    x = torch.randn((max(8, m), 8 * 1408), generator=g).to(
        torch.bfloat16).to(cuda)
    affine = ((0.5, -2.75),)
    before = _counts()
    first = fm.fused_decode_matmul(x, planes, affine, rows=m)
    again = fm.fused_decode_matmul(x, planes, affine, rows=m)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fm.fused_decode_matmul(x, planes, affine, rows=m)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(again, first) and torch.equal(out, first)
    assert tuple(a - b for a, b in zip(_counts(), before)) == (3, 0)


def test_rows_skip_the_pad(cuda):
    planes = _planes(256, 128, 1, cuda, seed=0)
    x = torch.zeros((8, 1024), device=cuda)
    x[0] = torch.randn(1024, device=cuda)
    got = fm.fused_decode_matmul(x, planes, ((0.5, -2.75),), rows=1)
    want = fm.fused_decode_matmul_ref(x[:1], planes, ((0.5, -2.75),))
    assert got.shape == (1, 256)
    _close(got, want, torch.float32)


def test_misaligned_planes_raise(cuda):
    w = _planes(128, 132, 1, cuda, seed=1)[0][:, 4:]   # not contiguous
    with pytest.raises(ValueError):
        fm.fused_decode_matmul(torch.zeros((1, 1024), device=cuda), [w],
                               ((0.5, -2.75),))
    flat = torch.zeros(128 * 128 + 1, dtype=torch.int32, device=cuda)
    w = flat[1:].view(128, 128)                       # 4-byte offset
    with pytest.raises(ValueError, match="aligned"):
        fm.fused_decode_matmul(torch.zeros((1, 1024), device=cuda), [w],
                               ((0.5, -2.75),))

