"""The CUDA kernel against its plain twin, on a card. This file imports
neither JAX nor the JAX package (the card's machine has no JAX), so it runs
there without tests/conftest.py:

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_sets", [1, 2])
@pytest.mark.parametrize("m", [1, 2, 3, 8, 40])
@pytest.mark.parametrize("q_out,Gp", [(128, 128), (200, 1408), (4096, 512)])
def test_kernel_matches_plain_twin(cuda, q_out, Gp, m, n_sets, dtype):
    """Ragged q_out (200 is no multiple of a block's rows), every
    accumulator size, both plane-set counts, both dtypes."""
    planes = _planes(q_out, Gp, n_sets, cuda, seed=m + q_out)
    affine = ((0.5, -2.75), (0.5 / 3.45, -2.75 / 3.45))[:n_sets]
    g = torch.Generator().manual_seed(m)
    x = torch.randn((m, 8 * Gp), generator=g).to(dtype).to(cuda)
    scale = (torch.rand(q_out, generator=g) + 0.5).to(cuda)
    before = fm.fused_decode_matmul.launches
    got = fm.fused_decode_matmul(x, planes, affine, scale)
    want = fm.fused_decode_matmul_ref(x, planes, affine, scale)
    torch.cuda.synchronize()
    assert fm.fused_decode_matmul.launches == before + 1
    assert got.shape == (m, q_out) and got.dtype == dtype
    _close(got, want, dtype)


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

