"""The index maps of K1 and K11's tensor-core body on the CPU, before the
card runs it.

K1 (csrc/fused_decode_matmul.cu) and K11 (csrc/sw_decode_matmul.cu) run one
body, csrc/nibble_mma_small.cuh: a warp lane (g, t) loads words 4t..4t+3
of a 16-group slab for its channel rows and decodes them straight into the
A registers of mma.sync.m16n8k16 as bf16 pairs (0x4300 | nibble, minus
128), in a k order chosen per split P so that each A register meets two
adjacent x values of the lane's field run in shared memory (x staged in
x_perm's own order). f32 x is split into three bf16 terms as it is read;
each slab of 128 k starts a fresh accumulator, added into f32 sums times
alpha; the beta row sums come from an all-ones A the same way.

This file emulates those maps in torch (the A and B registers of every
k-step of every slab, built from the words and x_perm by the kernel's own
bit operations) and holds the result to the plain twins
``fused_decode_matmul_ref`` (P = 1) and ``sw_decode_matmul_ref`` (P = 2,
4) at Llama-2-7B widths (q_in 4096 and 11008, Gp 1408), m = 1, 8 and 32,
with the kernels' tolerance: 1e-5 of the max, plus one bf16 ulp for bf16
outputs. A wrong pairing (the two nibbles of each A register swapped)
must miss it.

K6 (csrc/ksplit_decode_matmul.cu) runs the same body with its split-K
switch on: the grid is a multiple of the chunk count C, block b keeps
chunk b mod C and walks the tiles b div C, + gridDim/C, ..., each unit
(tile, chunk) taking the slabs of its chunk's Gc = Gp/C groups and writing
its partial (alphas and the chunk's beta row sums applied); a second
kernel adds the C partials in chunk order, then the scale and the cast.
The emulation of that slab walk and reduce is held to
``ksplit_decode_matmul_ref`` at 2, 3, 4 and 11 chunks; a walk that
forgets the chunk's first group must miss; the grid's units cover every
(tile, chunk) once. Where the split does not pay (at m <= 8, unless the
card's last wave of whole tiles is at most half full), K6 runs the body
over whole tiles: each of the 8 warps sums its slabs (warp w: w, w + 8,
...) in f32 in order, through the chunks, and the warps meet in warp order
at the tile's end; that association is held to the chunk-order twin too.
"""
import numpy as np
import pytest
import torch

from quip_for_all_tpu_torch.ops import fused_matmul as fm
from quip_for_all_tpu_torch.ops import layout_matmul as lm

pytestmark = pytest.mark.fast


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops: on one thread they take seconds, while a
    thread pool per worker of a parallel test run oversubscribes the
    cores by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

AFFINE = {1: ((0.5, -2.75),),
          2: ((0.5, -2.75), (0.5 / 3.45, -2.75 / 3.45))}
SLAB = 16                      # groups a slab (4 lanes x 4 words)
M32 = 0xFFFFFFFF


def byte_perm(x: torch.Tensor, y: torch.Tensor, sel: int) -> torch.Tensor:
    """CUDA's __byte_perm on int64 tensors holding uint32 values."""
    out = torch.zeros_like(x)
    for k in range(4):
        b = (sel >> (4 * k)) & 7
        src = x if b < 4 else y
        out |= ((src >> (8 * (b % 4))) & 0xFF) << (8 * k)
    return out


def a_reg(w: torch.Tensor, P: int, rho: int, wrong=False) -> torch.Tensor:
    """The kernel's A register rho (0..15) of a lane's 4 words w (..., 4)
    int64: (0x4300 | nib_lo) | (0x4300 | nib_hi) << 16 as uint32."""
    if P == 1:                  # words 2p, 2p+1 at nibble i
        i, p = rho >> 1, rho & 1
        h = byte_perm(w[..., 2 * p], w[..., 2 * p + 1],
                      0x5410 if i < 4 else 0x7632)
        t = (h >> (4 * (i & 3))) & 0x000F000F
    elif P == 2:                # word v, nibbles q and q + 4
        q, v = rho >> 2, rho & 3
        t = (w[..., v] >> (4 * q)) & 0x000F000F
    else:                       # word e, nibbles 4h + q and 4h + q + 2
        q, e, h = rho >> 3, (rho >> 1) & 3, rho & 1
        t = byte_perm(w[..., e] >> (4 * q), torch.zeros_like(w[..., e]),
                      0x4342 if h else 0x4140) & 0x000F000F
    if wrong:
        t = ((t >> 16) | (t << 16)) & M32
    return t | 0x43004300


def pair_values(reg: torch.Tensor) -> torch.Tensor:
    """uint32 bf16 pairs (...) -> (..., 2) f32: bits viewed as bf16 (low half
    first), minus 128 in bf16 (exact)."""
    b = reg.to(torch.int32).contiguous().view(torch.bfloat16).reshape(
        *reg.shape, 2)
    return (b - torch.tensor(128.0, dtype=torch.bfloat16)).float()


def k_order():
    """For k-step ks and k (0..15): the lane t, the register rho (2ks or
    2ks + 1) and the element of the pair (0 low, 1 high)."""
    kk = torch.arange(16)
    t = (kk % 8) // 2
    half = kk // 8
    elem = kk % 2
    return t, half, elem


def a_matrix(w: torch.Tensor, P: int, wrong=False) -> torch.Tensor:
    """(q_out, nslab, 8 k-steps, 16) f32 nibbles in the kernel's k order."""
    q_out, Gp = w.shape
    W4 = (w.to(torch.int64) & M32).reshape(q_out, Gp // SLAB, 4, 4)
    vals = torch.stack([pair_values(a_reg(W4, P, rho, wrong))
                        for rho in range(16)], dim=2)    # (n, s, rho, t, 2)
    t, half, elem = k_order()
    out = [vals[:, :, 2 * ks + half, t, elem] for ks in range(8)]
    return torch.stack(out, dim=2)


def b_matrix(x_perm: torch.Tensor, P: int) -> torch.Tensor:
    """(m, nslab, 8, 16) x values in the same k order, read from the
    staged runs: field q of a slab is x_perm's lanes q*P*Gp + P*(16s ..),
    and lane t's run is its values 4P*t .. 4P*t + 4P - 1."""
    m, K = x_perm.shape
    Gp = K // 8
    runs = x_perm.reshape(m, 8 // P, Gp // SLAB, 4, 4 * P)   # (m, q, s, t, .)
    t, half, elem = k_order()
    out = []
    for ks in range(8):
        rho = 2 * ks + half                     # per k
        q = rho // (2 * P)
        pos = 2 * (rho % (2 * P)) + elem
        # the advanced indices (q, t, pos) come first: (16, m, nslab)
        out.append(runs[:, q, :, t, pos].permute(1, 2, 0))
    return torch.stack(out, dim=2)


def split3(v: torch.Tensor):
    hi = v.to(torch.bfloat16)
    r = v - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi.float(), mid.float(), lo.float()


def emulate(x_perm, planes, affine, scale, P, wrong=False):
    """The body's arithmetic: per slab (in order) a fresh f32 accumulator
    over every term, added times alpha into the sums; the row sums as an
    all-ones A; then beta, the scale and the cast."""
    xf = x_perm.float()
    terms = split3(xf) if x_perm.dtype == torch.float32 else (xf,)
    Bs = [b_matrix(tm, P) for tm in terms]
    nslab = Bs[0].shape[1]
    tot = torch.zeros((x_perm.shape[0], planes[0].shape[0]))
    rs = torch.zeros((x_perm.shape[0],))
    for (alpha, _), w in zip(affine, planes):
        A = a_matrix(w, P, wrong)
        for s in range(nslab):
            acc = sum(B[:, s].reshape(B.shape[0], -1)
                      @ A[:, s].reshape(A.shape[0], -1).T for B in Bs)
            tot = tot + alpha * acc
    for s in range(nslab):
        rs = rs + sum(B[:, s].reshape(B.shape[0], -1).sum(1) for B in Bs)
    out = tot + sum(b for _, b in affine) * rs[:, None]
    if scale is not None:
        out = out * scale
    return out.to(x_perm.dtype)


def close(got, want, dtype) -> bool:
    got, want = got.float(), want.float()
    tol = 1e-5 * want.abs().max()
    if dtype == torch.bfloat16:
        a = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
        tol = tol + torch.exp2(torch.floor(torch.log2(a)) - 7)
    return bool(torch.all((got - want).abs() <= tol))


def make(P, q_in, m, dtype, n_sets, seed, q_out=48):
    rng = np.random.default_rng(seed)
    Gp = -(-(q_in // 8) // 128) * 128
    words = [torch.from_numpy(rng.integers(0, 1 << 32, (q_out, Gp),
                                           dtype=np.uint64)
                              .astype(np.uint32).view(np.int32))
             for _ in range(n_sets)]
    x_nat = torch.from_numpy(rng.standard_normal((m, q_in))
                             .astype(np.float32))
    x_perm = fm.grouped_permute(x_nat, Gp, P).to(dtype).contiguous()
    scale = torch.from_numpy(rng.random(q_out).astype(np.float32) + 0.5)
    affine = AFFINE[n_sets]
    if P == 1:
        want = fm.fused_decode_matmul_ref(x_perm, words, affine, scale)
    else:
        dt = torch.int16 if P == 2 else torch.int8
        want = lm.sw_decode_matmul_ref(x_perm, [w.view(dt) for w in words],
                                       affine, scale)
    return x_perm, words, affine, scale, want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 8, 32])
@pytest.mark.parametrize("q_in", [4096, 11008])
@pytest.mark.parametrize("P", [1, 2, 4])
def test_body_maps_match_the_twins(P, q_in, m, dtype):
    x_perm, words, affine, scale, want = make(P, q_in, m, dtype,
                                              1 + (m == 8), seed=P * m)
    got = emulate(x_perm, words, affine, scale, P)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert close(got, want, dtype)


@pytest.mark.parametrize("P", [1, 2, 4])
def test_a_wrong_pairing_misses(P):
    """Negative control: the two nibbles of each A register swapped."""
    x_perm, words, affine, scale, want = make(P, 4096, 8, torch.float32, 1,
                                              seed=P)
    assert close(emulate(x_perm, words, affine, scale, P), want,
                 torch.float32)
    assert not close(emulate(x_perm, words, affine, scale, P, wrong=True),
                     want, torch.float32)


def ksplit_emulate(x_perm, planes, affine, scale, chunks, no_gb=False):
    """K6's arithmetic: the unit of chunk k walks slabs [k*Gc/16,
    (k+1)*Gc/16) (from slab 0 with ``no_gb``, the chunk's first group
    forgotten, as a negative control), each slab a fresh accumulator times
    alpha and the row sums by an all-ones A; its partial adds beta times
    its row sums; the partials are added in chunk order, then the scale
    and the cast."""
    xf = x_perm.float()
    terms = split3(xf) if x_perm.dtype == torch.float32 else (xf,)
    Bs = [b_matrix(tm, 1) for tm in terms]
    As = [a_matrix(w, 1) for w in planes]
    m, nslab = xf.shape[0], Bs[0].shape[1]
    per = nslab // chunks
    beta_total = sum(b for _, b in affine)
    total = None
    for k in range(chunks):
        tot = torch.zeros((m, planes[0].shape[0]))
        rs = torch.zeros((m,))
        first = 0 if no_gb else k * per
        for s in range(first, first + per):
            for (alpha, _), A in zip(affine, As):
                acc = sum(B[:, s].reshape(m, -1)
                          @ A[:, s].reshape(A.shape[0], -1).T for B in Bs)
                tot = tot + alpha * acc
            rs = rs + sum(B[:, s].reshape(m, -1).sum(1) for B in Bs)
        part = tot + beta_total * rs[:, None]
        total = part if total is None else total + part
    if scale is not None:
        total = total * scale
    return total.to(x_perm.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 8, 32])
@pytest.mark.parametrize("chunks,q_in", [(2, 4096), (3, 3072), (4, 4096),
                                         (11, 11264)])
def test_ksplit_walk_and_reduce_match_the_twin(chunks, q_in, m, dtype):
    x_perm, words, affine, scale, _ = make(1, q_in, m, dtype,
                                           1 + (m == 8), seed=chunks + m)
    want = lm.ksplit_decode_matmul_ref(x_perm, words, affine, chunks, scale)
    got = ksplit_emulate(x_perm, words, affine, scale, chunks)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert close(got, want, dtype)


@pytest.mark.parametrize("chunks", [2, 11])
def test_a_ksplit_walk_without_the_chunk_offset_misses(chunks):
    """Negative control: every unit walks the first chunk's slabs."""
    q_in = 11264 if chunks == 11 else 4096
    x_perm, words, affine, scale, _ = make(1, q_in, 8, torch.float32, 1,
                                           seed=chunks)
    want = lm.ksplit_decode_matmul_ref(x_perm, words, affine, chunks, scale)
    assert close(ksplit_emulate(x_perm, words, affine, scale, chunks), want,
                 torch.float32)
    assert not close(ksplit_emulate(x_perm, words, affine, scale, chunks,
                                    no_gb=True), want, torch.float32)


def whole_tile_emulate(x_perm, planes, affine, scale, warps=8):
    """K6 without the split: warp w walks slabs w, w + warps, ... of the
    whole row, each slab a fresh accumulator times alpha added into its
    f32 sums (the row sums likewise); the warps' sums meet in warp order,
    then beta, the scale and the cast."""
    xf = x_perm.float()
    terms = split3(xf) if x_perm.dtype == torch.float32 else (xf,)
    Bs = [b_matrix(tm, 1) for tm in terms]
    As = [a_matrix(w, 1) for w in planes]
    m, nslab = xf.shape[0], Bs[0].shape[1]
    v = torch.zeros((m, planes[0].shape[0]))
    r = torch.zeros((m,))
    for w in range(warps):
        tot = torch.zeros((m, planes[0].shape[0]))
        rs = torch.zeros((m,))
        for s in range(w, nslab, warps):
            for (alpha, _), A in zip(affine, As):
                acc = sum(B[:, s].reshape(m, -1)
                          @ A[:, s].reshape(A.shape[0], -1).T for B in Bs)
                tot = tot + alpha * acc
            rs = rs + sum(B[:, s].reshape(m, -1).sum(1) for B in Bs)
        v, r = v + tot, r + rs
    out = v + sum(b for _, b in affine) * r[:, None]
    if scale is not None:
        out = out * scale
    return out.to(x_perm.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("chunks,q_in", [(2, 4096), (3, 3072), (4, 4096),
                                         (11, 11264)])
def test_whole_tile_sums_match_the_chunk_order_twin(chunks, q_in, m, dtype):
    x_perm, words, affine, scale, _ = make(1, q_in, m, dtype,
                                           1 + (m == 8), seed=3 * chunks + m)
    want = lm.ksplit_decode_matmul_ref(x_perm, words, affine, chunks, scale)
    got = whole_tile_emulate(x_perm, words, affine, scale)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert close(got, want, dtype)


def ksplit_units(ntiles: int, nch: int, resident: int):
    """The (tile, chunk) units each block of K6's grid takes: the launch's
    grid (as many blocks as the card holds, at most one a unit, rounded to
    whole multiples of the chunks) and the kernel's walk."""
    blocks = min(ntiles * nch, resident)
    blocks = nch if blocks < nch else blocks // nch * nch
    units = []
    for b in range(blocks):
        chunk, tb, tstep = b % nch, b // nch, blocks // nch
        ntile = (ntiles - tb + tstep - 1) // tstep
        units += [(tb + k * tstep, chunk) for k in range(ntile)]
    return units


@pytest.mark.parametrize("resident", [5, 132, 264])
@pytest.mark.parametrize("nch", [2, 3, 4, 11])
@pytest.mark.parametrize("ntiles", [1, 7, 64, 192, 344, 1000])
def test_ksplit_grid_takes_every_unit_once(ntiles, nch, resident):
    units = ksplit_units(ntiles, nch, resident)
    assert sorted(units) == [(t, c) for t in range(ntiles)
                             for c in range(nch)]
