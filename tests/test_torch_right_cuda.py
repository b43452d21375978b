"""The kernels' right epilogue (right_hb) and combined residual decode
(combine) against their plain twins, on a card: K1, K2, K6, K7, K8, K9,
K10 and K11 through ``fused_quant_matmul_pre``'s dispatch. This file
imports neither JAX nor the JAX package, so it runs on the card's machine
without tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_right_cuda.py

Without a card every test skips. Tolerances:
  - a kernel with right_hb against ``right_epilogue`` of the same kernel
    without it (the same sums and the same first rounding, so only the
    H_B product's f32 order differs): 1e-5 * max|ref|, plus one bf16 ulp
    of the element in bf16;
  - a kernel with right_hb against its twin with right_hb: that, plus
    |Hb| times the kernel-vs-twin difference before the epilogue (a first
    rounding that differs by an ulp is carried through the product);
  - the combined decode against its twin: 1e-5 * max|ref| plus one bf16
    ulp of the element.
"""
import pytest
import torch

from quip_for_all_tpu_torch.ops import fused_matmul as fm
from quip_for_all_tpu_torch.ops import layout_matmul as lm
from quip_for_all_tpu_torch.transforms.incoherence import right_hb_tensor
from quip_for_all_tpu_torch.utils.random_quantized import random_qtensor

pytestmark = [pytest.mark.fast, pytest.mark.cuda]

# Llama-2-7B's fused qkv, o, fused gate/up, down and head
SHAPES_7B = [(12288, 4096), (4096, 4096), (22016, 4096), (4096, 11008),
             (32000, 4096)]
# (layout, ksplit): every kernel that takes right_hb
KERNELS = [("nibble", 0), ("sw2", 0), ("sw4", 0), ("bfp", 0), ("nibble", 2),
           ("nibble", 4), ("u3", 0), ("pb", 0), ("paired", 0)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ulp(t, dtype):
    if dtype != torch.bfloat16:
        return torch.zeros_like(t)
    return torch.exp2(torch.floor(torch.log2(t.abs().clamp_min(1e-30))) - 7)


def _close(got, want, dtype, extra=None):
    got, want = got.float().cpu(), want.float().cpu()
    tol = 1e-5 * want.abs().max() + _ulp(
        torch.maximum(got.abs(), want.abs()), dtype)
    if extra is not None:
        tol = tol + extra
    assert torch.all((got - want).abs() <= tol), (got - want).abs().max()


def carried(d, hb):
    """|Hb| times a per-element difference d (m, q_out) per B-block."""
    m, q_out = d.shape
    B = hb.shape[0]
    return (d.float().cpu().reshape(m, q_out // B, B)
            @ hb.abs().float().cpu().T).reshape(m, q_out)


def _qt(codebook, layout, q_out, q_in, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return random_qtensor(codebook, layout, q_out, q_in, g, device)


def _run(qt, m, dtype, device, seed, ksplit=0, M=None, combine=0):
    g = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.randn((m, 8 * qt.group_cols), generator=g, device=device
                    ).to(dtype)
    scale = torch.rand(qt.q_out, generator=g, device=device) + 0.5
    hb = right_hb_tensor(M or qt.q_out, device)
    kw = dict(ksplit=ksplit, combine=combine)
    plain_k = fm._forward(x, qt, scale, False, **kw)
    right_k = fm._forward(x, qt, scale, False, right_hb=hb, **kw)
    plain_t = fm._forward(x, qt, scale, True, **kw)
    right_t = fm._forward(x, qt, scale, True, right_hb=hb, **kw)
    torch.cuda.synchronize()
    assert right_k.shape == (m, qt.q_out) and right_k.dtype == dtype
    assert torch.isfinite(right_k.float()).all()
    _close(right_k, lm.right_epilogue(plain_k, hb), dtype)
    _close(right_k, right_t, dtype,
           carried((plain_k.float() - plain_t.float()).abs(), hb))


@pytest.mark.parametrize("m,dtype", [(1, torch.bfloat16), (8, torch.bfloat16),
                                     (32, torch.bfloat16),
                                     (1, torch.float32)])
@pytest.mark.parametrize("q_out,q_in", SHAPES_7B)
@pytest.mark.parametrize("layout,ksplit", KERNELS)
def test_right_epilogue_at_7b_shapes(cuda, layout, ksplit, q_out, q_in, m,
                                     dtype):
    cb = "E8P12RVQ4B" if layout in ("pb", "paired") else "E8P12"
    qt = _qt(cb, layout, q_out, q_in, cuda, seed=q_out + m)
    # the per-segment M of a fused group: 4096 (qkv), 256 (gate/up: 11008 =
    # 43 * 256), 256 (the head: 32000 = 125 * 256)
    M = {12288: 4096, 22016: 256, 32000: 256}.get(q_out, q_out)
    _run(qt, m, dtype, cuda, seed=m, ksplit=ksplit, M=M)


@pytest.mark.parametrize("M", [8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("m,dtype", [(1, torch.bfloat16), (5, torch.float32),
                                     (12, torch.bfloat16),
                                     (32, torch.bfloat16),
                                     (40, torch.bfloat16),
                                     (64, torch.float32),
                                     (1022, torch.bfloat16)])
@pytest.mark.parametrize("layout,ksplit", KERNELS)
def test_right_epilogue_every_b(cuda, layout, ksplit, m, dtype, M):
    """B = 8 .. 128 (below, at and above a tile's 32 or 64 channels, so the
    cluster of 1, 2 and 4 blocks), at every row count's tile shape, K2
    above 32 rows."""
    if ksplit and m > 32:
        pytest.skip("split-K runs at m <= 32")
    cb = ("E8P12RVQ4B" if layout in ("pb", "paired")
          or (m % 2 and layout != "u3") else "E8P12")
    qt = _qt(cb, layout, 512, 2048, cuda, seed=M + m)
    _run(qt, m, dtype, cuda, seed=M, ksplit=ksplit, M=M)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,n", [(1, 8), (2, 8), (8, 8), (5, 8), (32, 32),
                                 (40, 8), (64, 32), (64, 64)])
@pytest.mark.parametrize("layout", ["nibble", "sw2", "sw4"])
@pytest.mark.parametrize("codebook", ["E8P12RVQ4B", "E8P12RVQ3B"])
def test_combined_decode(cuda, codebook, layout, m, n, dtype):
    """The combined decode in K1, K11 and K2 (at 40 and 64 rows, whose
    Pallas blocks of 8 and 32 rows take it), held to the twin's combined
    branch, with and without the right epilogue."""
    qt = _qt(codebook, layout, 4096, 4096, cuda, seed=m + n)
    assert fm.combine_applies(qt, max(8, -(-m // 8) * 8), n)
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn((m, 8 * qt.group_cols), generator=g, device=cuda
                    ).to(dtype)
    scale = torch.rand(qt.q_out, generator=g, device=cuda) + 0.5
    got = fm._forward(x, qt, scale, False, 0, combine=n)
    want = fm._forward(x, qt, scale, True, 0, combine=n)
    _close(got, want, dtype)
    hb = right_hb_tensor(4096, cuda)
    got_r = fm._forward(x, qt, scale, False, 0, right_hb=hb, combine=n)
    _close(got_r, lm.right_epilogue(got, hb), dtype)


def test_combined_kernel_launches_once(cuda):
    qt = _qt("E8P12RVQ4B", "nibble", 4096, 4096, cuda, seed=3)
    x = torch.randn((1, 8 * qt.group_cols), device=cuda).to(torch.bfloat16)
    before = fm.fused_decode_matmul.launches
    fm._forward(x, qt, None, False, 0, right_hb=right_hb_tensor(4096, cuda),
                combine=8)
    assert fm.fused_decode_matmul.launches == before + 1


def test_right_epilogue_replays_in_a_graph(cuda):
    qt = _qt("E8P12", "nibble", 4096, 4096, cuda, seed=7)
    hb = right_hb_tensor(4096, cuda)
    x = torch.randn((1, 8 * qt.group_cols), device=cuda).to(torch.bfloat16)
    first = fm._forward(x, qt, None, False, 0, right_hb=hb)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fm._forward(x, qt, None, False, 0, right_hb=hb)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, first)


@pytest.mark.parametrize("m", [64, 1022])
def test_backward_with_right_hb(cuda, m):
    """K3's dx and d scale through the right epilogue (g times Hb in f32
    first) against the plain twins' backward."""
    qt = _qt("E8P12", "nibble", 4096, 4096, cuda, seed=m)
    hb = right_hb_tensor(4096, cuda)
    g = torch.Generator(device=cuda).manual_seed(m)
    x0 = torch.randn((m, 8 * qt.group_cols), generator=g, device=cuda)
    s0 = torch.rand(qt.q_out, generator=g, device=cuda) + 0.5
    gout = torch.randn((m, qt.q_out), generator=g, device=cuda)
    grads = []
    for plain in (False, True):
        x = x0.clone().requires_grad_(True)
        s = s0.clone().requires_grad_(True)
        out = fm.fused_quant_matmul_pre(x, qt, s, plain=plain, right_hb=hb)
        out.backward(gout)
        grads.append((x.grad, s.grad))
    torch.cuda.synchronize()
    for got, want in zip(grads[0], grads[1]):
        _close(got, want, torch.float32)
