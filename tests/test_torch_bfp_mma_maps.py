"""The index maps of K10's tensor-core body on the CPU, before the card
runs it.

K10 (csrc/bfp_decode_matmul.cu) runs K1's body, csrc/nibble_mma_small.cuh,
with the codes policy BfpCodes: the bfp planes w3 (2, q_out/2, Gp) hold
K1's nibble words re-laid as row pairs (positions 4h..4h+3 of channel 2t
in the low 16 bits of w3[h][t, g], of channel 2t + 1 in the high 16).
Lane (g, t) of a warp loads, for the m16 tile of row pairs p0 .. p0 + 7,
the uint4 of words 4t..4t+3 of a 16-group slab from both half planes of
pair p0 + g; A row g is channel 2g and row g + 8 channel 2g + 1. K-step
ks is position i = ks, and its A registers are K1's P = 1 registers on
the row-pair words: one byte permute of the lane's words 2p and 2p + 1
(0x5410 takes the low halves, channel 2g; 0x7632 the high ones, channel
2g + 1), shifted by 4*(i mod 4), masked, OR 0x43004300, minus 128 in
bf16. x is staged and read as K1's (the same grouped lane order), f32 x
as three bf16 terms; each slab of 128 k starts a fresh accumulator, added
into f32 sums times alpha; the beta row sums come from an all-ones A;
above 32 rows gridDim.y walks blocks of 32 rows.

This file emulates those maps in torch (every A register built from the
words by the kernel's own permutes and masks) and holds the result to the
plain twin ``bfp_decode_matmul_ref`` at Llama-2-7B widths (q_in 4096 and
11008), m = 1, 8, 32 and 40 (two row blocks), bf16 and f32, 1 and 2 plane
sets, with and without the scale, at the kernels' tolerance: 1e-5 of the
max, plus one bf16 ulp for bf16 outputs. A map that swaps the two
channels of a pair must miss it. One case goes on to the JAX package's
bfp Pallas kernel (``dequant_pallas._make_kernel_bfp``, interpret mode)
on the same numpy inputs.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quip_for_all_tpu.codebooks import get_codebook as jget_codebook
from quip_for_all_tpu.ops import dequant_pallas as jdp
from quip_for_all_tpu.ops import qtensor as jqt

from quip_for_all_tpu_torch.codebooks import get_codebook
from quip_for_all_tpu_torch.ops import fused_matmul as fm
from quip_for_all_tpu_torch.ops import layout_matmul as lm
from quip_for_all_tpu_torch.ops import qtensor as tqt

from test_torch_small_m_maps import (AFFINE, M32, SLAB, b_matrix, byte_perm,
                                     close, k_order, pair_values, split3)

pytestmark = pytest.mark.fast

ROWS = 32                      # rows of x a block (gridDim.y walks more)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops: one thread a test worker, so that a parallel
    test run does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bfp_reg(a: torch.Tensor, b: torch.Tensor, sel: int, s: int):
    """The kernel's bfp_reg: (0x4300 | nibble) pairs of the halves ``sel``
    picks of words a and b, shifted by s (uint32 values in int64)."""
    return ((byte_perm(a, b, sel) >> s) & 0x000F000F) | 0x43004300


def a_matrix(w3: torch.Tensor, swap=False) -> torch.Tensor:
    """(q_out, nslab, 8 k-steps, 16) f32 nibbles in the kernel's k order
    from bfp planes (2, pairs, Gp): register rho = 2i + p of the lane's
    words 2p, 2p + 1 in half plane i // 4, channel 2t from 0x5410 and 2t +
    1 from 0x7632 (swapped with ``swap``, a negative control)."""
    _, pairs, Gp = w3.shape
    W = (w3.to(torch.int64) & M32).reshape(2, pairs, Gp // SLAB, 4, 4)
    lo_sel, hi_sel = (0x7632, 0x5410) if swap else (0x5410, 0x7632)
    regs = []                                   # rho-major: (2, pairs, s, t)
    for rho in range(16):
        i, p = rho >> 1, rho & 1
        Wh = W[i >> 2]
        a, b = Wh[..., 2 * p], Wh[..., 2 * p + 1]
        s = 4 * (i & 3)
        regs.append(torch.stack([bfp_reg(a, b, lo_sel, s),
                                 bfp_reg(a, b, hi_sel, s)]))
    # (2 channels of a pair, pairs, nslab, rho, t) -> channels 2t, 2t + 1
    reg = torch.stack(regs, dim=3)
    reg = reg.permute(1, 0, 2, 3, 4).reshape(2 * pairs, Gp // SLAB, 16, 4)
    vals = pair_values(reg)                     # (n, s, rho, t, 2)
    t, half, elem = k_order()
    return torch.stack([vals[:, :, 2 * ks + half, t, elem]
                        for ks in range(8)], dim=2)


def emulate(x_perm, planes, affine, scale, swap=False):
    """The body's arithmetic, a block of up to 32 rows at a time: per slab
    (in order) a fresh f32 accumulator over every term, added times alpha
    into the sums; the row sums as an all-ones A; then beta, the scale and
    the cast."""
    As = [a_matrix(w, swap) for w in planes]
    outs = []
    for r0 in range(0, x_perm.shape[0], ROWS):
        xb = x_perm[r0:r0 + ROWS]
        xf = xb.float()
        terms = split3(xf) if xb.dtype == torch.float32 else (xf,)
        Bs = [b_matrix(tm, 1) for tm in terms]
        m, nslab = xb.shape[0], Bs[0].shape[1]
        tot = torch.zeros((m, As[0].shape[0]))
        rs = torch.zeros((m,))
        for (alpha, _), A in zip(affine, As):
            for s in range(nslab):
                acc = sum(B[:, s].reshape(m, -1)
                          @ A[:, s].reshape(A.shape[0], -1).T for B in Bs)
                tot = tot + alpha * acc
        for s in range(nslab):
            rs = rs + sum(B[:, s].reshape(m, -1).sum(1) for B in Bs)
        out = tot + sum(b for _, b in affine) * rs[:, None]
        if scale is not None:
            out = out * scale
        outs.append(out.to(xb.dtype))
    return torch.cat(outs)


def make(q_in, m, dtype, n_sets, with_scale, seed, q_out=48):
    rng = np.random.default_rng(seed)
    Gp = -(-(q_in // 8) // 128) * 128
    planes = [torch.from_numpy(rng.integers(0, 1 << 32, (2, q_out // 2, Gp),
                                            dtype=np.uint64)
                               .astype(np.uint32).view(np.int32))
              for _ in range(n_sets)]
    x_nat = torch.from_numpy(rng.standard_normal((m, q_in))
                             .astype(np.float32))
    x_perm = fm.grouped_permute(x_nat, Gp, 1).to(dtype).contiguous()
    scale = (torch.from_numpy(rng.random(q_out).astype(np.float32) + 0.5)
             if with_scale else None)
    affine = AFFINE[n_sets]
    want = lm.bfp_decode_matmul_ref(x_perm, planes, affine, scale)
    return x_perm, planes, affine, scale, want


@pytest.mark.parametrize("n_sets,with_scale", [(1, True), (2, False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 8, 32, 40])
@pytest.mark.parametrize("q_in", [4096, 11008])
def test_bfp_maps_match_the_twin(q_in, m, dtype, n_sets, with_scale):
    x_perm, planes, affine, scale, want = make(q_in, m, dtype, n_sets,
                                               with_scale, seed=m + n_sets)
    got = emulate(x_perm, planes, affine, scale)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert close(got, want, dtype)


@pytest.mark.parametrize("n_sets", [1, 2])
def test_a_map_that_swaps_a_pairs_channels_misses(n_sets):
    """Negative control: channel 2t read from the high halves and 2t + 1
    from the low ones."""
    x_perm, planes, affine, scale, want = make(4096, 8, torch.float32,
                                               n_sets, True, seed=n_sets)
    assert close(emulate(x_perm, planes, affine, scale), want,
                 torch.float32)
    assert not close(emulate(x_perm, planes, affine, scale, swap=True),
                     want, torch.float32)


def test_bfp_maps_match_the_jax_pallas_kernel():
    """The same numpy codes and x through the JAX package's bfp Pallas
    kernel (interpret mode on the CPU) and through the emulated maps: two
    row blocks (m = 40), f32, with the scale."""
    q_out, q_in, m = 128, 2048, 40
    rng = np.random.default_rng(7)
    raw = rng.integers(0, 1 << 16, (q_out, q_in // 8)).astype(np.int32)
    j = jqt.from_raw_idxs(jget_codebook("E8P12"), raw, q_out, q_in,
                          layout="bfp")
    t = tqt.from_raw_idxs(get_codebook("E8P12"), raw, q_out, q_in,
                          device="cpu", layout="bfp")
    x = rng.standard_normal((m, q_in)).astype(np.float32)
    x = fm.grouped_permute(torch.from_numpy(x), t.group_cols, 1).numpy()
    scale = rng.uniform(0.5, 1.5, q_out).astype(np.float32)
    want = np.asarray(jdp.fused_quant_matmul_pre(
        jnp.asarray(x), j, scale_vec=jnp.asarray(scale)).astype(jnp.float32))
    got = emulate(torch.from_numpy(x), t.plane_list(), t.decode_affine,
                  torch.from_numpy(scale))
    assert close(got, torch.from_numpy(want.copy()), torch.float32)
