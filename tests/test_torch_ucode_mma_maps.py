"""The index maps of K7, K8 and K9's tensor-core body on the CPU, before
the card runs it.

K7 (csrc/paired_decode_matmul.cu) and K8's pb and K9's u3 entries
(csrc/rowpair_decode_matmul.cu) run one body, csrc/ucode_mma_small.cuh, on
the skeleton of csrc/nibble_mma_small.cuh: a warp lane (g, t) loads words
4t..4t+3 of a 16-group slab and decodes them straight into the A registers
of mma.sync.m16n8k16 as bf16 pairs ((0x4300 | 4u) minus the pair of
137 + 2p, or of 137), register rho = 2i + p pairing words 2p and 2p+1 at
position i (K1's k order at P = 1). So A carries beta (4u - 9: no row
sums) and, where the group sums are f32, the parity term too
(4u - 2p - 9). Each slab runs two passes, u0 then u1, each a fresh
accumulator flushed into f32 sums times 1/4 and rs/4. Where the Pallas
block sums gx in bf16 (bf16 x, more than 8 rows) a pass ends with one more
k-step whose A is -2 where the pass's parity bit is set and whose B is
gx, summed left to right over the positions with each add rounded to bf16.
K9's u3 policy (U3Codes) takes one code set, u = lo2 + 4*hi1, from three
row-pair words a lane: A row g is channel 2g (the words' low halves) and
g + 8 channel 2g + 1 (high halves); the lo2 pairs are one byte permute of
w0, the hi1 bits one byte permute of w1 that picks the byte of w1's half
d; its one pass a slab is flushed times 1/4.

This file emulates those maps in torch (the A and B registers of every
k-step of every slab, built from the planes and x_perm by the kernel's own
bit operations) and holds the result to the plain twin
``rowpair_matmul_ref`` at Llama-2-7B widths (q_in 4096 and 11008: pb Gp
1408, paired and u3 Gp 1536), m = 1, 8, 16 and 32 (gx in f32 up to 8
rows, in bf16 above), bf16 and f32 x, with and without a scale, at the
kernels' tolerance: 1e-5 of the max, plus one bf16 ulp for bf16 outputs.
A wrong pairing (the two halves of each u register swapped) must miss it,
and so must bf16 group sums taken in f32 (the parity folded into the
codes at m = 32). The counter walk of the parity field is held to a
division.
"""
import numpy as np
import pytest
import torch

from quip_for_all_tpu_torch.ops import fused_matmul as fm
from quip_for_all_tpu_torch.ops import rowpair_matmul as rm
from quip_for_all_tpu_torch.ops.qtensor import (paired_wp, pb_parity_lanes,
                                                u3_parity_lanes)

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

RS = 1 / 3.45
SLAB = 16                      # groups a slab (4 lanes x 4 words)
M32 = 0xFFFFFFFF
LOW, HIGH = 0x5410, 0x7632     # __byte_perm: low / high halves of 2 words


def byte_perm(x: torch.Tensor, y: torch.Tensor, sel) -> torch.Tensor:
    """CUDA's __byte_perm on int64 tensors holding uint32 values; ``sel``
    an int or an int64 tensor of selectors."""
    out = torch.zeros_like(x)
    for k in range(4):
        b = (sel >> (4 * k)) & 7
        src = torch.where(torch.as_tensor(b < 4), x, y)
        out |= ((src >> (8 * (b % 4))) & 0xFF) << (8 * k)
    return out


def bf16_pair(reg: torch.Tensor) -> torch.Tensor:
    """uint32 bf16 pairs (...) -> (..., 2) f32, low half first."""
    return reg.to(torch.int32).contiguous().view(torch.bfloat16).reshape(
        *reg.shape, 2).float()


def shl(x, k):
    return (x << k) & M32 if k >= 0 else x >> -k


def bit_pair(u, v, b):
    return ((u >> b) & 1) | (((v >> b) & 1) << 16)


def u_reg(L, H, i, st, bias, wrong=False):
    """The kernel's u_reg: the bf16 pair (0x4300 | 4u) - bias of u0 (st 0)
    or u1 (st 1) at position i, as (..., 2) f32."""
    s = 4 * (i & 3)
    if st == 0:
        t = shl(L, 2 - s) & 0x001C001C
    else:
        t = (shl(H, 3 - 2 * i) & 0x00180018) | (shl(L, -(s + 1)) & 0x00040004)
    if wrong:
        t = ((t >> 16) | (t << 16)) & M32
    v = bf16_pair(t | 0x43004300).to(torch.bfloat16)
    return (v - bf16_pair(bias).to(torch.bfloat16)).float()


def u3_reg(L, H, i, bias, wrong=False):
    """The u3 policy's a_frag: the bf16 pair (0x4300 | 4*lo2 | 16*hi1) -
    bias at position i, as (..., 2) f32."""
    t = (shl(L, 2 - 2 * i) & 0x000C000C) | (shl(H, 4 - i) & 0x00100010)
    if wrong:
        t = ((t >> 16) | (t << 16)) & M32
    v = bf16_pair(t | 0x43004300).to(torch.bfloat16)
    return (v - bf16_pair(bias).to(torch.bfloat16)).float()


def channel_words(layout, planes, q_out):
    """Per output channel n and group g (q_out, Gp), as the lane loads them:
    the lo4 words of positions 0-3 and 4-7, the hi2 word, the parity word,
    the byte-permute selectors of lo (per position half / row) and hi, and
    the bit of p0 in the parity word."""
    w = {k: v.to(torch.int64) & M32 for k, v in planes.items()}
    Gp = planes["w0"].shape[-1]
    g = torch.arange(Gp)
    n = torch.arange(q_out)[:, None]
    if layout == "paired":
        Gh, Wp = Gp // 2, w["w2"].shape[-1]
        lo = w["w0"]
        hi = w["w1"][:, g % Gh]
        par = w["w2"][:, g % Wp]
        sel_hi = torch.where(g >= Gh, HIGH, LOW).expand(q_out, Gp)
        return dict(lo_a=lo, lo_b=lo, hi=hi, par=par,
                    sel_lo=lambda i: LOW if i < 4 else HIGH, sel_hi=sel_hi,
                    bit=(2 * (g // Wp)).expand(q_out, Gp))
    PL = w["w2"].shape[-1]
    rp, hr = n // 2, n % 2            # row pair and its half: A row g / g+8
    sel = torch.where(hr == 1, HIGH, LOW).expand(q_out, Gp)
    if layout == "u3":
        # w1's half d of group g; its byte 2*hr + d of each word
        Gh = Gp // 2
        d = g // Gh
        return dict(lo_a=w["w0"][rp[:, 0]], lo_b=w["w0"][rp[:, 0]],
                    hi=w["w1"][rp[:, 0]][:, g % Gh],
                    par=w["w2"][rp[:, 0]][:, g % PL],
                    sel_lo=lambda i: sel,
                    sel_hi=(2 * hr + d) * 0x1111 + 0x4400,
                    bit=16 * hr + g // PL)
    return dict(lo_a=w["w0"][0][rp[:, 0]], lo_b=w["w0"][1][rp[:, 0]],
                hi=w["w1"][rp[:, 0]], par=w["w2"][rp[:, 0]][:, g % PL],
                sel_lo=lambda i: sel, sel_hi=sel,
                bit=16 * hr + 2 * (g // PL))


def slab_view(a: torch.Tensor) -> torch.Tensor:
    """(q_out, Gp) -> (q_out, nslab, 4 lanes t, 4 words)."""
    return a.reshape(a.shape[0], -1, 4, 4)


def k_map():
    """For k (0..15) of a k-step: the lane t, the register pair p (rho =
    2ks + p) and the element of the pair."""
    kk = torch.arange(16)
    return (kk % 8) // 2, kk // 8, kk % 2


def a_matrices(layout, planes, q_out, fold, wrong=False):
    """[pass st] -> (A (q_out, nslab, 8, 16) the values 4u - 9 - 2p (fold)
    or 4u - 9 in the kernel's k order, PA (q_out, nslab, 16) the parity
    k-step's -2p); u3 has one pass."""
    cw = channel_words(layout, planes, q_out)
    t, p, elem = k_map()
    par, bit = slab_view(cw["par"]), slab_view(cw["bit"])
    out = []
    for st in ((0,) if layout == "u3" else (0, 1)):
        pbits = [bit_pair(par[..., 2 * pp], par[..., 2 * pp + 1],
                          bit[..., 2 * pp] + st) for pp in (0, 1)]
        bias = [0x43094309 + (pb << 1) if fold
                else torch.full_like(pb, 0x43094309) for pb in pbits]
        steps = []
        for i in range(8):
            lo = slab_view(cw["lo_a"] if i < 4 else cw["lo_b"])
            sl = cw["sel_lo"](i)
            sl = sl if isinstance(sl, int) else slab_view(sl)
            sh, hi = slab_view(cw["sel_hi"]), slab_view(cw["hi"])
            regs = []
            for pp in (0, 1):                   # words 2p, 2p+1
                L = byte_perm(lo[..., 2 * pp], lo[..., 2 * pp + 1],
                              sl if isinstance(sl, int) else sl[..., 2 * pp])
                H = byte_perm(hi[..., 2 * pp], hi[..., 2 * pp + 1],
                              sh[..., 2 * pp])
                regs.append(u3_reg(L, H, i, bias[pp], wrong)
                            if layout == "u3"
                            else u_reg(L, H, i, st, bias[pp], wrong))
            vals = torch.stack(regs, dim=3)               # (n, s, t, p, 2)
            steps.append(vals[:, :, t, p, elem])          # (n, s, 16)
        pregs = torch.stack([bf16_pair((pb * 0xC000) & M32) for pb in pbits],
                            dim=3)
        out.append((torch.stack(steps, dim=2), pregs[:, :, t, p, elem]))
    return out


def b_matrix(x_perm: torch.Tensor) -> torch.Tensor:
    """(m, nslab, 8, 16) x values in the same k order: k-step ks is
    position i = ks, lane t's run its groups 4t..4t+3 of the slab."""
    m, K = x_perm.shape
    runs = x_perm.reshape(m, 8, K // 8 // SLAB, 4, 4)     # (m, i, s, t, .)
    t, p, elem = k_map()
    return runs[:, :, :, t, 2 * p + elem].permute(0, 2, 1, 3)


def group_sums(x_perm: torch.Tensor) -> torch.Tensor:
    """gx (m, Gp): the positions summed left to right, each add rounded to
    bf16 (the kernel's add_bf16)."""
    m, K = x_perm.shape
    xs = x_perm.float().reshape(m, 8, K // 8)
    gx = xs[:, 0]
    for i in range(1, 8):
        gx = (gx + xs[:, i]).to(torch.bfloat16).float()
    return gx


def split3(v: torch.Tensor):
    hi = v.to(torch.bfloat16)
    r = v - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi.float(), mid.float(), lo.float()


def emulate(x_perm, layout, planes, scale, rows, wrong=False, gxb=None):
    """The body's arithmetic on the first ``rows`` rows of x_perm (whose
    padded row count sets gx's rounding, as the wrapper passes it; ``gxb``
    overrides it): per slab and pass a fresh accumulator over the 8
    k-steps (and the parity k-step on bf16 gx), added times (1/4, rs/4)
    into the sums; then the scale and the cast."""
    gxb = rm.group_sum_in_bf16(x_perm) if gxb is None else gxb
    x = x_perm[:rows]
    q_out = planes["w2"].shape[0] * (1 if layout == "paired" else 2)
    xf = x.float()
    terms = split3(xf) if x.dtype == torch.float32 else (xf,)
    Bs = [b_matrix(tm) for tm in terms]
    t, p, elem = k_map()
    GB = (group_sums(x).reshape(rows, -1, 4, 4)[:, :, t, 2 * p + elem]
          if gxb else None)
    nslab = Bs[0].shape[1]
    tot = torch.zeros((rows, q_out))
    for (A, PA), alpha in zip(a_matrices(layout, planes, q_out, not gxb,
                                         wrong), (0.25, 0.25 * RS)):
        # every slab's accumulator at once: (nslab, rows, q_out)
        acc = sum(torch.bmm(B.reshape(rows, nslab, -1).transpose(0, 1),
                            A.reshape(q_out, nslab, -1).permute(1, 2, 0))
                  for B in Bs)
        if gxb:
            acc = acc + torch.bmm(GB.transpose(0, 1), PA.permute(1, 2, 0))
        for s in range(nslab):                  # flushed slab by slab
            tot = tot + alpha * acc[s]
    out = tot
    if scale is not None:
        out = out * scale
    return out.to(x.dtype)


def close(got, want, dtype) -> bool:
    got, want = got.float(), want.float()
    tol = 1e-5 * want.abs().max()
    if dtype == torch.bfloat16:
        a = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
        tol = tol + torch.exp2(torch.floor(torch.log2(a)) - 7)
    return bool(torch.all((got - want).abs() <= tol))


def make(layout, q_in, m, dtype, with_scale, seed, q_out=48):
    """Random-bit planes (every u 0..7 and parity occurs), x_perm padded to
    the wrapper's multiple of 8 rows, the scale, and the twin's output."""
    rng = np.random.default_rng(seed)
    G = q_in // 8
    if layout == "paired":
        Gp = -(-G // 256) * 256
        shapes = {"w0": (q_out, Gp), "w1": (q_out, Gp // 2),
                  "w2": (q_out, paired_wp(Gp))}
    elif layout == "u3":
        Gp = -(-G // 256) * 256
        shapes = {"w0": (q_out // 2, Gp), "w1": (q_out // 2, Gp // 2),
                  "w2": (q_out // 2, u3_parity_lanes(Gp))}
    else:
        Gp = -(-G // 128) * 128
        shapes = {"w0": (2, q_out // 2, Gp), "w1": (q_out // 2, Gp),
                  "w2": (q_out // 2, pb_parity_lanes(Gp))}
    planes = {k: torch.from_numpy(rng.integers(0, 1 << 32, s, dtype=np.uint64)
                                  .astype(np.uint32).view(np.int32))
              for k, s in shapes.items()}
    mp = max(8, -(-m // 8) * 8)
    x_nat = torch.zeros((mp, q_in))
    x_nat[:m] = torch.from_numpy(rng.standard_normal((m, q_in))
                                 .astype(np.float32))
    x_perm = fm.grouped_permute(x_nat, Gp).to(dtype).contiguous()
    scale = (torch.from_numpy(rng.random(q_out).astype(np.float32) + 0.5)
             if with_scale else None)
    want = rm.rowpair_matmul_ref(x_perm, layout, planes, RS, scale, rows=m)
    return x_perm, planes, scale, want


@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 8, 16, 32])
@pytest.mark.parametrize("q_in", [4096, 11008])
@pytest.mark.parametrize("layout", ["pb", "paired", "u3"])
def test_body_maps_match_the_twin(layout, q_in, m, dtype, with_scale):
    x_perm, planes, scale, want = make(layout, q_in, m, dtype, with_scale,
                                       seed=m + q_in % 7)
    got = emulate(x_perm, layout, planes, scale, m)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert close(got, want, dtype)


@pytest.mark.parametrize("layout", ["pb", "paired", "u3"])
def test_a_wrong_pairing_misses(layout):
    """Negative control: the two halves of each u register swapped."""
    x_perm, planes, scale, want = make(layout, 4096, 8, torch.float32, True,
                                       seed=5)
    assert close(emulate(x_perm, layout, planes, scale, 8), want,
                 torch.float32)
    assert not close(emulate(x_perm, layout, planes, scale, 8, wrong=True),
                     want, torch.float32)


@pytest.mark.parametrize("layout", ["pb", "paired", "u3"])
def test_folding_the_parity_misses_bf16_group_sums(layout):
    """Negative control: at m = 32 in bf16 the Pallas body rounds gx to
    bf16, and the parity folded into the codes (f32 group sums) misses."""
    x_perm, planes, scale, want = make(layout, 11008, 32, torch.bfloat16,
                                       False, seed=7)
    assert close(emulate(x_perm, layout, planes, scale, 32), want,
                 torch.bfloat16)
    assert not close(emulate(x_perm, layout, planes, scale, 32, gxb=False),
                     want, torch.bfloat16)


def walk(c0: int, step: int, PL: int, items: int, per_tile: int):
    """The kernel's Walk: (j, cw) of each item, a new tile every
    ``per_tile`` items starting over at c0."""
    out = []
    for k in range(items):
        if k % per_tile == 0:
            cw, j = c0, 0
            while cw >= PL:
                cw, j = cw - PL, j + 1
        else:
            cw += step
            while cw >= PL:
                cw, j = cw - PL, j + 1
        out.append((j, cw))
    return out


@pytest.mark.parametrize("Gp,PL", [(512, 128), (1408, 256), (1536, 128),
                                   (1536, 512), (512, 512), (256, 4)])
@pytest.mark.parametrize("WK", [4, 8])
def test_parity_walk_matches_division(Gp, PL, WK):
    """The counters that follow a lane's groups c = 16s + 4t (s = wk, wk +
    WK, ... within a tile, past Gp at a stage's end) give j = c div PL and
    the column c mod PL, with no division in the kernel."""
    nslab = Gp // SLAB
    per_tile = -(-nslab // WK)          # items a warp walks a tile
    for wk in range(WK):
        for t in range(4):
            c0 = SLAB * wk + 4 * t
            got = walk(c0, SLAB * WK, PL, 3 * per_tile, per_tile)
            for k, (j, cw) in enumerate(got):
                c = c0 + SLAB * WK * (k % per_tile)
                assert (j, cw) == divmod(c, PL)
