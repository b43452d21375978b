"""K3, the backward decode+matmul CUDA kernel (csrc/fused_decode_matmul_bwd.cu),
against its plain twin on a card. This file imports neither JAX nor the
JAX package (the card's machine has no JAX), so it runs there without
tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_k3_cuda.py

Without a card every test skips. Tolerance: f32 outputs within 1e-5 *
max|ref| (W decodes bit-equal; the sums over q_out differ in order); bf16
outputs within that plus one bf16 ulp of the element. Planes are random
bits, so every nibble 0..15 occurs, in the pad groups too (never read).
"""
import pytest
import torch

from quip_for_all_tpu_torch.ops import fused_matmul as fm
from quip_for_all_tpu_torch.ops.qtensor import QuantizedTensor

pytestmark = [pytest.mark.fast, pytest.mark.cuda]

RS = 1 / 3.45
AFFINE = {1: ((0.5, -2.75),), 2: ((0.5, -2.75), (0.5 * RS, -2.75 * RS))}


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
    assert torch.isfinite(got).all()


def _planes(q_out, Gn, n_sets, g, device):
    return [torch.randint(-2 ** 31, 2 ** 31 - 1, (q_out, Gn), generator=g,
                          device=device, dtype=torch.int64).to(torch.int32)
            for _ in range(n_sets)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_sets", [1, 2])
@pytest.mark.parametrize("m", [1, 2, 3, 8, 37, 1022])
@pytest.mark.parametrize("q_out,q_in", [(4096, 4096), (4096, 11008),
                                        (200, 384)])
def test_kernel_matches_twin(cuda, q_out, q_in, m, n_sets, dtype):
    """Llama-2-7B's o and down (G 1376 of Gp 1408) and a ragged small
    shape (q_out 200, G 48 of 128)."""
    if q_in == 11008 and m == 1022 and dtype == torch.float32:
        pytest.skip("covered by the bf16 case; keeps the file short")
    g0 = torch.Generator(device=cuda).manual_seed(m * 3 + n_sets)
    G = q_in // 8
    Gn = -(-G // 128) * 128
    planes = _planes(q_out, Gn, n_sets, g0, cuda)
    g = torch.randn((m, q_out), generator=g0, device=cuda).to(dtype)
    scale = torch.rand(q_out, generator=g0, device=cuda) + 0.5
    before = fm.fused_decode_matmul_bwd.launches
    got = fm.fused_decode_matmul_bwd(g, planes, AFFINE[n_sets], scale, G, Gn)
    want = fm.fused_decode_matmul_bwd_ref(g, planes, AFFINE[n_sets], scale,
                                          G, Gn)
    torch.cuda.synchronize()
    assert fm.fused_decode_matmul_bwd.launches == before + 1
    assert got.shape == (m, 8 * Gn) and got.dtype == dtype
    assert torch.all(got.reshape(m, 8, Gn)[:, :, G:] == 0)
    _close(got, want, dtype)


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("q_out,q_in", [(4096, 4096), (11008, 4096)])
def test_bf16_g_with_and_without_a_scale(cuda, q_out, q_in, scaled):
    """bf16 g at a LoRA step's 1022 rows: without a scale vector g is exact
    in bf16 and takes one MMA (the training path); with one, gs = g*scale
    is not a bf16 value and the kernel splits it into three bf16 terms."""
    g0 = torch.Generator(device=cuda).manual_seed(q_out + scaled)
    G = q_in // 8
    planes = _planes(q_out, G, 1, g0, cuda)
    g = torch.randn((1022, q_out), generator=g0,
                    device=cuda).to(torch.bfloat16)
    scale = (torch.rand(q_out, generator=g0, device=cuda) + 0.5
             if scaled else None)
    got = fm.fused_decode_matmul_bwd(g, planes, AFFINE[1], scale, G, G)
    want = fm.fused_decode_matmul_bwd_ref(g, planes, AFFINE[1], scale, G, G)
    _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("split,Gp_out", [(1, 256), (2, 128), (4, 128),
                                          (4, 256)])
def test_kernel_lane_orders_and_wider_gp(cuda, split, Gp_out):
    """dx in the sw2/sw4 lane order, and Gp_out beyond the planes' Gn (the
    u3/paired layouts' 256-group padding)."""
    g0 = torch.Generator(device=cuda).manual_seed(split + Gp_out)
    G, Gn, q_out, m = 96, 128, 384, 19
    planes = _planes(q_out, Gn, 2, g0, cuda)
    g = torch.randn((m, q_out), generator=g0, device=cuda,
                    dtype=torch.bfloat16)
    got = fm.fused_decode_matmul_bwd(g, planes, AFFINE[2], None, G, Gp_out,
                                     split)
    want = fm.fused_decode_matmul_bwd_ref(g, planes, AFFINE[2], None, G,
                                          Gp_out, split)
    _close(got, want, torch.bfloat16)


def test_kernel_is_deterministic_and_replays_in_a_graph(cuda):
    g0 = torch.Generator(device=cuda).manual_seed(7)
    planes = _planes(4096, 512, 1, g0, cuda)
    g = torch.randn((64, 4096), generator=g0, device=cuda)
    first = fm.fused_decode_matmul_bwd(g, planes, AFFINE[1], None, 512, 512)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fm.fused_decode_matmul_bwd(g, planes, AFFINE[1], None, 512, 512)
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fm.fused_decode_matmul_bwd(g, planes, AFFINE[1], None, 512,
                                         512)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, first)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_autograd_runs_the_kernels(cuda, dtype):
    """fused_quant_matmul_pre under autograd on the card at 40 rows: the
    forward kernel (K2, above 32 rows), and K3 for dx (plus K2 again, in
    f32, for d scale_vec), each against the plain route."""
    g0 = torch.Generator(device=cuda).manual_seed(11)
    q_out, q_in, m = 512, 1536, 40
    qt = QuantizedTensor({"w0": _planes(q_out, 256, 1, g0, cuda)[0]},
                         "E8P12", q_out, q_in)
    x = torch.randn((m, 8 * 256), generator=g0, device=cuda)
    x.reshape(m, 8, 256)[:, :, q_in // 8:] = 0
    probe = torch.randn((m, q_out), generator=g0, device=cuda)
    scale = torch.rand(q_out, generator=g0, device=cuda) + 0.5
    grads = {}
    for plain in (False, True):
        xp = x.to(dtype).requires_grad_(True)
        sp = scale.clone().requires_grad_(True)
        counters = (fm.fused_decode_matmul, fm.fused_decode_matmul_tc,
                    fm.fused_decode_matmul_bwd)
        before = [c.launches for c in counters]
        out = fm.fused_quant_matmul_pre(xp, qt, sp, plain=plain)
        (out.float() * probe).sum().backward()
        torch.cuda.synchronize()
        launched = tuple(c.launches - b for c, b in zip(counters, before))
        assert launched == ((0, 0, 0) if plain else (0, 2, 1))
        grads[plain] = (xp.grad, sp.grad)
    _close(grads[False][0], grads[True][0], dtype)
    _close(grads[False][1], grads[True][1], torch.float32)
