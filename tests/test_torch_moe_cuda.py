"""The expert-indexed CUDA kernel (csrc/moe_decode_matmul.cu) against its
plain twin, on a card. This file imports neither JAX nor the JAX package
(the card's machine has no JAX), so it runs there without
tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_moe_cuda.py

Without a card every test skips. Tolerance: f32 outputs within
1e-5 * max|ref| (products are exact; sums differ in order); bf16 outputs
within that plus one bf16 ulp of the element.
"""
import pytest
import torch

from quip_for_all_tpu_torch.ops import moe_matmul as mm

pytestmark = [pytest.mark.fast, pytest.mark.cuda]

AFFINE = ((0.5, -2.75), (0.5 / 3.45, -2.75 / 3.45))


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


def _inputs(E, q_out, Gp, R, n_sets, dtype, device, seed, eids=None):
    g = torch.Generator().manual_seed(seed)
    planes = [torch.randint(-2 ** 31, 2 ** 31 - 1, (E, q_out, Gp),
                            generator=g, dtype=torch.int64)
              .to(torch.int32).to(device) for _ in range(n_sets)]
    if eids is None:
        eids = torch.randint(0, E, (R,), generator=g)
    x = torch.randn((R, 8 * Gp), generator=g).to(dtype).to(device)
    return x, eids.to(torch.int32).to(device), planes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_sets", [1, 2])
@pytest.mark.parametrize("R", [1, 2, 3, 16, 62])
@pytest.mark.parametrize("E,q_out,Gp", [(8, 128, 128), (8, 200, 1792),
                                        (4, 768, 128)])
def test_kernel_matches_plain_twin(cuda, E, q_out, Gp, R, n_sets, dtype):
    """Ragged q_out (200 is no multiple of a block's rows), every
    accumulator size, repeated experts, both plane-set counts and dtypes."""
    x, eids, planes = _inputs(E, q_out, Gp, R, n_sets, dtype, cuda,
                              seed=R + q_out + n_sets)
    aff = AFFINE[:n_sets]
    before = mm.moe_fused_matmul.launches
    got = mm.moe_fused_matmul(x, eids, planes, aff, R)
    want = mm.moe_fused_matmul_ref(x, eids, planes, aff)
    torch.cuda.synchronize()
    assert mm.moe_fused_matmul.launches == before + 1
    assert got.shape == (R, q_out) and got.dtype == dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("bound", [None, 1, 3])
@pytest.mark.parametrize("R", [2, 9, 300, 600])
def test_one_expert_many_rows(cuda, R, bound):
    """Every row on one expert: the block loops over chunks of the
    accumulator's rows (also when ``rows_per_expert`` understates them;
    None is the bound R), and over windows of 256 rows of ids past
    R = 256."""
    eids = torch.full((R,), 5)
    x, eids, planes = _inputs(8, 256, 128, R, 1, torch.float32, cuda,
                              seed=R, eids=eids)
    got = mm.moe_fused_matmul(x, eids, planes, AFFINE[:1],
                              R if bound is None else bound)
    want = mm.moe_fused_matmul_ref(x, eids, planes, AFFINE[:1])
    _close(got, want, torch.float32)


@pytest.mark.parametrize("R", [2, 4, 16])
def test_top2_bound_on_distinct_experts(cuda, R):
    """The main path's call: top-2 ids of R/2 tokens, with the bound R/2."""
    g = torch.Generator().manual_seed(R)
    eids = torch.stack([torch.randperm(8, generator=g)[:2]
                        for _ in range(R // 2)]).reshape(-1)
    x, eids, planes = _inputs(8, 512, 512, R, 1, torch.bfloat16, cuda,
                              seed=R, eids=eids)
    got = mm.moe_fused_matmul(x, eids, planes, AFFINE[:1], R // 2)
    _close(got, mm.moe_fused_matmul_ref(x, eids, planes, AFFINE[:1]),
           torch.bfloat16)


def test_all_64_experts(cuda):
    eids = torch.randperm(64, generator=torch.Generator().manual_seed(0))
    x, eids, planes = _inputs(64, 128, 128, 64, 1, torch.bfloat16, cuda,
                              seed=1, eids=eids)
    got = mm.moe_fused_matmul(x, eids, planes, AFFINE[:1], 1)
    _close(got, mm.moe_fused_matmul_ref(x, eids, planes, AFFINE[:1]),
           torch.bfloat16)


def test_captures_in_a_cuda_graph(cuda):
    """No host read of the ids: the call records into a CUDA graph, and a
    replay follows ids changed on the device."""
    x, eids, planes = _inputs(8, 256, 128, 2, 1, torch.bfloat16, cuda,
                              seed=2, eids=torch.tensor([3, 6]))
    mm.moe_fused_matmul(x, eids, planes, AFFINE[:1], 1)   # build and warm
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = mm.moe_fused_matmul(x, eids, planes, AFFINE[:1], 1)
    eids.copy_(torch.tensor([1, 7], dtype=torch.int32, device=cuda))
    g.replay()
    torch.cuda.synchronize()
    _close(out, mm.moe_fused_matmul_ref(x, eids, planes, AFFINE[:1]),
           torch.bfloat16)


def test_misaligned_planes_raise(cuda):
    flat = torch.zeros(2 * 128 * 128 + 1, dtype=torch.int32, device=cuda)
    w = flat[1:].view(2, 128, 128)                    # 4-byte offset
    with pytest.raises(ValueError, match="aligned"):
        mm.moe_fused_matmul(torch.zeros((1, 1024), device=cuda),
                            torch.zeros(1, dtype=torch.int32, device=cuda),
                            [w], AFFINE[:1], 1)


def test_sparse_route_launches_the_kernel_at_any_q_out(cuda):
    """A Mixtral block whose stacked q_out is no multiple of 128 (w13 192,
    w2 64) runs the kernel on the sparse route, two launches per block,
    and agrees with the plain twin's block. f32 compute: the core differs
    by sum order only, which the right transform spreads, so the block is
    held within 1e-4 * max|plain|."""
    import quip_for_all_tpu_torch as qt
    from quip_for_all_tpu_torch.models import llama as M
    from quip_for_all_tpu_torch.models.config import tiny_config
    cfg = tiny_config(arch="mixtral", intermediate_size=96,
                      num_local_experts=4, num_experts_per_tok=2)
    model = qt.fuse_for_inference(cfg, qt.random_quantized_model(
        cfg, seed=0, dtype=torch.float32, device=cuda))
    moe = model.layers[0]["block_sparse_moe"]
    assert [moe["experts_stacked"][k].q_out_total % 128
            for k in ("w13", "w2")] == [64, 64]
    x = torch.randn((1, 2, cfg.hidden_size),
                    generator=torch.Generator().manual_seed(0)).to(cuda)
    before = mm.moe_fused_matmul.launches
    got = M.moe_apply(cfg, moe, x, {"compute_dtype": torch.float32})
    assert mm.moe_fused_matmul.launches == before + 2
    want = M.moe_apply(cfg, moe, x, {"compute_dtype": torch.float32,
                                     "matmul_impl": "plain"})
    assert mm.moe_fused_matmul.launches == before + 2
    err = (got - want).abs().max()
    assert err <= 1e-4 * want.abs().max(), err


def test_gradient_request_raises_on_the_card(cuda):
    """As on the CPU and as the JAX package's Pallas call: the kernel has
    no backward, so a call that autograd would need a gradient through
    raises before any launch."""
    x, eids, planes = _inputs(8, 128, 128, 2, 1, torch.float32, cuda, seed=0)
    before = mm.moe_fused_matmul.launches
    with pytest.raises(NotImplementedError, match="matmul_impl='plain'"):
        mm.moe_fused_matmul(x.requires_grad_(True), eids, planes,
                            AFFINE[:1], 1)
    assert mm.moe_fused_matmul.launches == before
    with torch.no_grad():
        got = mm.moe_fused_matmul(x, eids, planes, AFFINE[:1], 1)
    assert mm.moe_fused_matmul.launches == before + 1
    _close(got, mm.moe_fused_matmul_ref(x.detach(), eids, planes,
                                        AFFINE[:1]), torch.float32)
