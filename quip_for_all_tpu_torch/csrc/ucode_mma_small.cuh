// u-code decode + matmul on Hopper's tensor cores (sm_90a): the kernel
// body of three C entry points,
//   paired_decode_matmul.cu    K7: E8P12RVQ4B, the paired layout, one row
//                              a word;
//   rowpair_decode_matmul.cu   K8: E8P12RVQ4B, the pb layout, a row pair a
//                              word; K9: E8P12, the u3 layout, a row pair
//                              a word, one code set (U3Codes, at the end).
//
// K7 and K8 compute the same function on two packings. For x_perm (m, 8*Gp)
// in the grouped layout x_perm[r, i*Gp + g] = x[r, 8g + i] and the group
// sums gx[r, g] = sum_{i=0..7} x_perm[r, i*Gp + g]:
//
//   out[r, n] = (d0 - 0.5*P0) + rs*(d1 - 0.5*P1) - 2.25*(1+rs)*rowsum(x)
//   d0/d1 = sum_{g,i} x*u0 / x*u1,  P0/P1 = sum_g gx*p0 / gx*p1
//
// then times scale[n] (when given) and a cast to x's dtype. The codes:
//   paired  w0 (q_out, Gp)  lo4 = (w0 >> 4i) & 0xF,
//           w1 (q_out, Gh)  hi2 = (w1[n, g mod Gh] >> (16h + 2i)) & 3,
//                           h = g div Gh (Gh = Gp/2),
//           w2 (q_out, Wp)  p0/p1 = (w2[n, g mod Wp] >> (2j + 0/1)) & 1,
//                           j = g div Wp;
//   pb      w0 (2, q_out/2, Gp)  lo4 = (w0[i div 4][n/2, g]
//                                       >> (16hr + 4(i mod 4))) & 0xF,
//           w1 (q_out/2, Gp)     hi2 = (w1[n/2, g] >> (16hr + 2i)) & 3,
//           w2 (q_out/2, PL)     p0/p1 = (w2[n/2, g mod PL]
//                                         >> (16hr + 2j + 0/1)) & 1,
//                                j = g div PL, hr = n mod 2 (row pair half);
// and u0 = lo4 & 7, u1 = 2*hi2 + (lo4 >> 3) for both.
//
// Replaces: quip_for_all_tpu/ops/dequant_pallas.py _make_kernel_paired
// (:356, K7), _make_kernel_pb (:566, K8) and _make_kernel_u3 (:486, K9),
// each through both of _fused_call's grids (:868, :888): a block takes up
// to 32 rows of x and gridDim.y walks further tiles of 32, so every m
// takes this body.
//
// What bounds it on the card: device-memory bytes. A Llama-2-7B token's
// 129 calls read ~5.8 GB of paired planes, ~5.37 GB of pb planes or ~2.90
// GB of u3 planes, ~1.73 / ~1.61 / ~0.87 ms at the H100 SXM data-sheet
// 3.35 TB/s (reckoned from shapes), at m = 1 and at m = 32 alike.
//
// Design: nibble_mma_small.cuh's skeleton (x staged by cp.async in
// x_perm's order, one pass over the planes for all m <= 32 rows of a
// block, a fresh MMA accumulator per slab of 16 groups, the WK reduce in
// warp order, blocks that walk tiles) with this file's codes policy:
//   - The sets u0 and u1 come from the same words held in registers. At
//     one n8 tile of rows (m <= 8: decode) a warp takes 16 channels and
//     one pass over a slab multiplies both, an accumulator each: two
//     independent MMA chains, one x load a k-step. Above, a warp takes 32
//     channels and a pass a set, one accumulator at a time, which keeps
//     the registers of K1's body. Each slab's accumulators are flushed
//     into f32 sums times 1/4 and rs/4.
//   - The constants ride the codes: A is 4u - 9 (the -2.25 of beta, times
//     4: no all-ones MMA, no row sums), and where the group sums are f32
//     (m <= 8 rows in a Pallas block, f32 x) 4u - 2p - 9 (the parity term
//     too: no group sums). Each is a small integer, exact in bf16, so
//     every product is exact in f32 and the result differs from the plain
//     twin (ops/rowpair_matmul.py) only by f32 summation order.
//   - Where the Pallas block sums gx in bf16 (bf16 x, more than 8 rows;
//     dequant_pallas.py:386-388, :616-618), -0.5*p is not folded: that
//     would skip gx's rounding. The parity term runs as one more MMA
//     k-step a pass over the slab's 16 groups, A = -2 where the pass's
//     parity bit is set (bf16, exact), B the lane's group sums, which the
//     u0 pass sums from the staged x left to right over the positions,
//     each add rounded to bf16.
//   - A registers: the k order of K1's P = 1 (register rho = 2i + p of a
//     lane pairs its words 2p and 2p+1 at position i, which meet two
//     adjacent x lanes). The lo4 pair is a byte permute of the two words;
//     4u0 is one shift and mask of it, 4u1 puts the hi2 pair (a byte
//     permute of the w1 words) over its bit 3; then (0x4300 | 4u) minus
//     the pair (137 + 2p) or 137 in bf16, the bias pairs computed once a
//     pass. paired: the permute takes the words' low halves for i < 4 and
//     high ones above; a slab of 16 groups lies in one half h of w1. pb: A
//     row g is channel 2g of the m16 tile and row g + 8 is channel 2g + 1,
//     so the permute takes the low (row g) or high (row g + 8) halves of
//     one row-pair word, and one word load feeds both of a lane's rows;
//     the store undoes the map.
//   - The parity field j of a lane's groups (and its column in w2) is
//     walked with counters beside the skeleton's, never divided out.
#pragma once

#include "nibble_mma_small.cuh"

namespace {
namespace sm {

struct UcodePlanes {
  const uint32_t* w0;
  const uint32_t* w1;
  const uint32_t* w2;
  int PL;   // w2's width (pb and u3 PL, paired Wp)
  int Gh;   // paired and u3: w1's width Gp/2; pb: the row pairs q_out/2
};

// A lane's groups c = 16s + 4t walk by 16*WK within a tile: their parity
// field j = c div PL and their column cw = c - j*PL in w2, by counters
struct ParityWalk {
  int c0, step, PL, cw, j;
  __device__ ParityWalk(const UcodePlanes& pl, int WK, int c)
      : c0(c), step(SLAB * WK), PL(pl.PL) {
    start();
  }
  __device__ void start() {
    cw = c0;
    j = 0;
    while (cw >= PL) {
      cw -= PL;
      ++j;
    }
  }
  __device__ void next(bool new_tile) {
    if (new_tile) {
      start();
      return;
    }
    cw += step;
    while (cw >= PL) {
      cw -= PL;
      ++j;
    }
  }
};

__device__ __forceinline__ uint32_t word(const uint4& u, int k) {
  return k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
}

// x << k for k >= 0, else x >> -k (k known at compile time)
__device__ __forceinline__ uint32_t shl(uint32_t x, int k) {
  return k >= 0 ? x << k : x >> -k;
}

// The bf16 pair 4*u0 - bias (pass 0) or 4*u1 - bias (pass 1) at position
// i, from L, the two 16-bit lo4 payloads of a register's words, and H,
// their hi2 ones: (0x4300 | 4u) is 128 + 4u, and bias the bf16 pair of
// 128 + 9 (+ 2p), so the one subtract is exact
__device__ __forceinline__ uint32_t u_reg(uint32_t L, uint32_t H, int i,
                                          int st, uint32_t bias) {
  const int s = 4 * (i & 3);
  const uint32_t t =
      st == 0 ? shl(L, 2 - s) & 0x001C001Cu                 // 4 * (lo4 & 7)
              : (shl(H, 3 - 2 * i) & 0x00180018u) |         // 8 * hi2
                    (shl(L, -(s + 1)) & 0x00040004u);       // 4 * lo4 >> 3
  const uint32_t tb = t | 0x43004300u;
  return tc::bf16x2_bits(
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&tb),
              *reinterpret_cast<const __nv_bfloat162*>(&bias)));
}

template <bool PB, bool GXB_>
struct UcodeCodes {
  static constexpr int NSETS = 2, P = 1;
  // a lane's uint4 for an m16 tile: paired w0, w1, w2 of rows g and g + 8
  // ([0, 1], [2, 3], [4, 5]); pb w0 positions 0-3 and 4-7, w1, w2 of row
  // pair g
  static constexpr int NW = PB ? 4 : 6;
  // beta rides the codes; the parity term too unless gx is bf16
  static constexpr bool ROWSUMS = false, PARITY = GXB_, PAIR_ROWS = PB;
  // at one n8 tile of rows (decode): one m16 tile a warp, and u0 and u1
  // in one pass (two accumulators); above, MT tiles and a pass a set
  __host__ __device__ static constexpr int mtiles(int nt) {
    return nt == 1 ? 1 : MT;
  }
  __host__ __device__ static constexpr bool fused(int nt) { return nt == 1; }
  using Planes = UcodePlanes;
  using Walk = ParityWalk;
  // bits 0-7: p0's bit in a row's payload (2j); bit 8: w1's half (paired)
  __device__ static uint32_t ctx(const Walk& wk, int c, const Planes& pl) {
    return 2u * wk.j | (!PB && c >= pl.Gh ? 0x100u : 0u);
  }
  template <int MTW>
  __device__ static void load(uint4 (&w)[MTW][NW], const Planes& pl, int n0,
                              int g, int c, const Walk& wk, int q_out,
                              int Gp, bool ok) {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    auto ld = [&](const uint32_t* p) {
      return ok ? __ldg(reinterpret_cast<const uint4*>(p)) : z;
    };
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt) {
      if (PB) {
        const size_t rp = min((n0 + mt * 16) / 2 + g, pl.Gh - 1);
        w[mt][0] = ld(pl.w0 + rp * Gp + c);
        w[mt][1] = ld(pl.w0 + ((size_t)pl.Gh + rp) * Gp + c);
        w[mt][2] = ld(pl.w1 + rp * Gp + c);
        w[mt][3] = ld(pl.w2 + rp * pl.PL + wk.cw);
      } else {
        const int ch = c >= pl.Gh ? c - pl.Gh : c;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const size_t n = min(n0 + mt * 16 + g + 8 * h, q_out - 1);
          w[mt][h] = ld(pl.w0 + n * Gp + c);
          w[mt][2 + h] = ld(pl.w1 + n * pl.Gh + ch);
          w[mt][4 + h] = ld(pl.w2 + n * pl.PL + wk.cw);
        }
      }
    }
  }
  // the parity bits (p0 at bit 0, p1 at bit 1 of each half) in a lane's
  // words for A row g (r = 0) or g + 8 (r = 1), words 2p and 2p + 1
  __device__ static uint32_t parity(const uint4 (&w)[NW], uint32_t cx,
                                    int r, int p) {
    const uint4 wp = PB ? w[3] : w[4 + r];
    const int b = (PB ? 16 * r : 0) + (int)(cx & 0xFFu);
    return ((word(wp, 2 * p) >> b) & 3u) |
           ((word(wp, 2 * p + 1) >> b) & 3u) << 16;
  }
  // a pass's bias pairs [r][p], 137 + 2p (bf16 0x4309 or 0x430B) where the
  // parity term is folded, else 137; and (paired) the byte permute that
  // takes w1's half of the slab
  struct Pass {
    uint32_t bias[2][2];
    uint32_t sh;
  };
  __device__ static Pass pass(const uint4 (&w)[NW], int st, uint32_t cx) {
    Pass d;
    d.sh = (cx >> 8) & 1 ? 0x7632u : 0x5410u;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const uint32_t q = PARITY ? 0u : parity(w, cx, r, p);
        d.bias[r][p] = 0x43094309u + (st == 0 ? (q & 0x00010001u) << 1
                                              : q & 0x00020002u);
      }
    return d;
  }
  // the A registers of k-step ks (position i = ks) of pass st: a[r + 2p]
  // is A row g (r = 0) or g + 8 (r = 1), words 2p and 2p + 1
  __device__ static void a_frag(const uint4 (&w)[NW], const Pass& d, int st,
                                int i, uint32_t a[4]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint4 lo = PB ? w[i < 4 ? 0 : 1] : w[r];
      const uint4 hi = PB ? w[2] : w[2 + r];
      const uint32_t sl = (PB ? r : i >= 4) ? 0x7632u : 0x5410u;
      const uint32_t sh = PB ? sl : d.sh;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const uint32_t L = __byte_perm(word(lo, 2 * p), word(lo, 2 * p + 1),
                                       sl);
        const uint32_t H = st == 0 ? 0u
                                   : __byte_perm(word(hi, 2 * p),
                                                 word(hi, 2 * p + 1), sh);
        a[r + 2 * p] = u_reg(L, H, i, st, d.bias[r][p]);
      }
    }
  }
  // the parity k-step of pass st (bf16 group sums): k pairs (4t, 4t+1),
  // (4t+2, 4t+3) of the slab's groups, as the B registers of gx; A is -2
  // (bf16 0xC000) where the bit is set
  __device__ static void p_frag(const uint4 (&w)[NW], int st, uint32_t cx,
                                uint32_t a[4]) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        a[r + 2 * p] = ((parity(w, cx, r, p) >> st) & 0x00010001u) * 0xC000u;
  }
};

// The u3 codes of K9 (E8P12, one code set), a row pair a word as pb:
//   w0 (q_out/2, Gp)  lo2 = (w0[n/2, g] >> (16hr + 2i)) & 3,
//   w1 (q_out/2, Gh)  hi1 = (w1[n/2, g mod Gh] >> (16hr + 8d + i)) & 1,
//                     d = g div Gh (Gh = Gp/2),
//   w2 (q_out/2, PL)  p = (w2[n/2, g mod PL] >> (16hr + j)) & 1,
//                     j = g div PL, hr = n mod 2;
//   out[r, n] = sum_{g,i} x*u - 0.5 * sum_g gx*p - 2.25 * rowsum(x),
//   u = lo2 + 4*hi1 (dequant_pallas.py:486-563).
// The constants ride the codes as in UcodeCodes: A is 4u - 9, or 4u - 2p
// - 9 where gx is f32, both exact in bf16; on bf16 gx the parity k-step
// (A = -2p) takes the bf16 group sums. One set: a pass a slab, and MT m16
// tiles a warp at every row count (two MMA chains, as K1). A lane's 4
// groups share one half of w1 (Gh is a multiple of 4) and one parity
// field (PL is).
template <bool GXB_>
struct U3Codes {
  static constexpr int NSETS = 1, P = 1;
  // a lane's uint4 for an m16 tile (row pair g): w0, w1 at its half's
  // column, w2
  static constexpr int NW = 3;
  static constexpr bool ROWSUMS = false, PARITY = GXB_, PAIR_ROWS = true;
  __host__ __device__ static constexpr int mtiles(int) { return MT; }
  __host__ __device__ static constexpr bool fused(int) { return false; }
  using Planes = UcodePlanes;
  using Walk = ParityWalk;
  // bits 0-7: p's bit j in a row's payload; bit 8: w1's half d
  __device__ static uint32_t ctx(const Walk& wk, int c, const Planes& pl) {
    return (uint32_t)wk.j | (c >= pl.Gh ? 0x100u : 0u);
  }
  template <int MTW>
  __device__ static void load(uint4 (&w)[MTW][NW], const Planes& pl, int n0,
                              int g, int c, const Walk& wk, int q_out,
                              int Gp, bool ok) {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    auto ld = [&](const uint32_t* p) {
      return ok ? __ldg(reinterpret_cast<const uint4*>(p)) : z;
    };
    const int ch = c >= pl.Gh ? c - pl.Gh : c;
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt) {
      const size_t rp = min((n0 + mt * 16) / 2 + g, q_out / 2 - 1);
      w[mt][0] = ld(pl.w0 + rp * Gp + c);
      w[mt][1] = ld(pl.w1 + rp * pl.Gh + ch);
      w[mt][2] = ld(pl.w2 + rp * pl.PL + wk.cw);
    }
  }
  // the parity bits of A row g (r = 0) or g + 8 (r = 1), words 2p and
  // 2p + 1, at bit 0 of each half
  __device__ static uint32_t parity(const uint4 (&w)[NW], uint32_t cx,
                                    int r, int p) {
    const int b = 16 * r + (int)(cx & 0xFFu);
    return ((word(w[2], 2 * p) >> b) & 1u) |
           ((word(w[2], 2 * p + 1) >> b) & 1u) << 16;
  }
  // once a pass, per A row r and word pair p: L the two lo2 payloads (row
  // half r of words 2p and 2p + 1), H the two hi1 bytes of w1's half d
  // (byte 2r + d of each word, by one byte permute), and the bias pair
  // 137 (+ 2p where the parity is folded)
  struct Pass {
    uint32_t L[2][2], H[2][2], bias[2][2];
  };
  __device__ static Pass pass(const uint4 (&w)[NW], int, uint32_t cx) {
    Pass d;
    const uint32_t hsel = (2u + ((cx >> 8) & 1u)) * 0x1111u + 0x4400u;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        d.L[r][p] = __byte_perm(word(w[0], 2 * p), word(w[0], 2 * p + 1),
                                r ? 0x7632u : 0x5410u);
        d.H[r][p] = __byte_perm(word(w[1], 2 * p), word(w[1], 2 * p + 1),
                                hsel - (r ? 0u : 0x2222u));
        const uint32_t q = PARITY ? 0u : parity(w, cx, r, p);
        d.bias[r][p] = 0x43094309u + (q << 1);
      }
    return d;
  }
  // the A registers of k-step i: (0x4300 | 4u) - bias, 4u = 4*lo2 | 16*hi1
  __device__ static void a_frag(const uint4 (&)[NW], const Pass& d, int,
                                int i, uint32_t a[4]) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const uint32_t t = (shl(d.L[r][p], 2 - 2 * i) & 0x000C000Cu) |
                           (shl(d.H[r][p], 4 - i) & 0x00100010u) |
                           0x43004300u;
        a[r + 2 * p] = tc::bf16x2_bits(
            __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&t),
                    *reinterpret_cast<const __nv_bfloat162*>(
                        &d.bias[r][p])));
      }
  }
  // the parity k-step (bf16 group sums): A is -2 (bf16 0xC000) where p is
  // set
  __device__ static void p_frag(const uint4 (&w)[NW], int, uint32_t cx,
                                uint32_t a[4]) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        a[r + 2 * p] = parity(w, cx, r, p) * 0xC000u;
  }
};

// The codes carry beta: the caller's must be the codes' one up to float
// rounding.
inline bool beta_is(float beta, float want) {
  const float tol = 1e-6f * (want > 1.f ? want : want < -1.f ? -want : 1.f);
  return beta - want <= tol && want - beta <= tol;
}

// K9's launch for x's dtype and the group sum's rounding; beta must be
// 2.25 (cudaErrorInvalidValue otherwise). Returns cudaGetLastError() (0
// on success); the C entry point checks the shapes first.
inline int dispatch_u3(const void* x, const void* w0, const void* w1,
                       const void* w2, const void* scale, void* out, int m,
                       int q_out, int Gp, int PL, float beta, int gx_bf16,
                       int x_is_bf16, void* stream) {
  if (!beta_is(beta, 2.25f)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the sums are 4x the result
  const Args a{scale, out, m, q_out, Gp, 0.25f, 0.f, 0.f};
  const UcodePlanes pl{static_cast<const uint32_t*>(w0),
                       static_cast<const uint32_t*>(w1),
                       static_cast<const uint32_t*>(w2), PL, Gp / 2};
  if (!x_is_bf16) return launch_nt<float, U3Codes<false>>(x, pl, a, s);
  if (gx_bf16) return launch_nt<__nv_bfloat16, U3Codes<true>>(x, pl, a, s);
  return launch_nt<__nv_bfloat16, U3Codes<false>>(x, pl, a, s);
}

// The launch for the layout (pb or paired), x's dtype and the group sum's
// rounding. The codes carry beta, so it must be 2.25*(1+rs) up to float
// rounding (cudaErrorInvalidValue otherwise). Returns cudaGetLastError()
// (0 on success); the C entry points check the shapes first.
template <bool PB>
int dispatch_ucode(const void* x, const void* w0, const void* w1,
                   const void* w2, const void* scale, void* out, int m,
                   int q_out, int Gp, int PL, float rs, float beta,
                   int gx_bf16, int x_is_bf16, void* stream) {
  if (!beta_is(beta, 2.25f * (1.f + rs)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the sums are 4x the result
  const Args a{scale, out, m, q_out, Gp, 0.25f, 0.25f * rs, 0.f};
  const UcodePlanes pl{static_cast<const uint32_t*>(w0),
                       static_cast<const uint32_t*>(w1),
                       static_cast<const uint32_t*>(w2), PL,
                       PB ? q_out / 2 : Gp / 2};
  if (!x_is_bf16) return launch_nt<float, UcodeCodes<PB, false>>(x, pl, a, s);
  if (gx_bf16)
    return launch_nt<__nv_bfloat16, UcodeCodes<PB, true>>(x, pl, a, s);
  return launch_nt<__nv_bfloat16, UcodeCodes<PB, false>>(x, pl, a, s);
}

}  // namespace sm
}  // namespace
