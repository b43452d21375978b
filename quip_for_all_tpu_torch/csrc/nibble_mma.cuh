// Tensor-core building blocks of the affine-nibble decode + matmul on
// Hopper (sm_90a), shared by two sources:
//   fused_decode_matmul_tc.cu   K2: the forward above 32 rows,
//                               out = x_perm @ W^T (W decoded, n = q_out);
//   fused_decode_matmul_bwd.cu  K3: the backward, dx = (g*scale) @ W
//                               (k = q_out, n = the dx lanes).
//
// Both are one GEMM shape: a block computes BM rows x BN = 128 columns and
// walks the reduction in slabs of BK = 128. Per slab it stages
//   A  BM x 128 values of the activations (x) or gradients (g), and
//   B  128 rows x 16 int32 words of each nibble plane set,
// with cp.async (16-byte copies, zero fill past every edge) in three stages
// (two where shared memory is short), so the next slabs stream in while
// slab s is decoded and multiplied. The slab
// of words is decoded once per block into bf16 values in shared memory:
// word (r, cc) gives dec[r][16*i + cc] = nibble i for i = 0..7, which is
// the k order of a K2 slab (r = output channel n, k = i*16 + cc matching
// x_perm's lanes i*Gp + c0 + cc) and the n order of a K3 slab (r = o = k,
// n = i*16 + cc: nibble i of group c0 + cc). Warps read dec with ldmatrix
// (K3 with .trans) and multiply with mma.sync.m16n8k16 bf16 -> f32.
//
// Exactness: a nibble (0..15) is exact in bf16; so is x or g when it is a
// bf16 tensor. Any other operand (f32 x or g, or g*scale) is split when
// it is staged into three bf16 terms v = hi + mid + lo, which represent
// the f32 value exactly (hi = bf16(v); mid = bf16(v - hi); lo = v - hi -
// mid has at most 8 significant bits), and each term runs its own MMA
// into the same accumulator; every product is exact in f32. The tensor
// cores' f32 accumulation may round (truncate) differently from an IEEE
// sum, so each slab (128 k) starts a fresh MMA accumulator, which is then
// added into an f32 register sum with ordinary round-to-nearest adds.
// Without that flush, f32 outputs at Llama-2-7B's widths miss their 1e-5
// tolerance by up to 8x on an H100; with it they use at most 0.72 of it
// (tools/ablate_mma.py, variant noflush against base).
// The beta term of W needs the sum of each A row over the whole
// reduction: the block takes it in f32 while it stages A.
//
// Block: 8 warps, 2 over m x 4 over n; a warp owns (BM/2) x 32 outputs,
// MT = BM/32 m16 tiles by 4 n8 tiles, for each plane set. BM is 128 for
// one plane set of bf16 operands (64 f32 sums and 64 MMA accumulators a
// thread) and 64 otherwise (two sets or three terms), which keeps the
// registers under 255 and shared memory under 227 KB.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {
namespace tc {

constexpr int THREADS = 256;       // 8 warps
constexpr int BN = 128;            // output columns a block
constexpr int BK = 128;            // reduction depth of a slab
constexpr int KSTEPS = BK / 16;    // m16n8k16 steps a slab
constexpr int WROWS = 128;         // word rows of a slab (K2: n, K3: k)
constexpr int WSTRIDE = 20;        // smem words a row: 16 + 4 (no conflicts)
constexpr int TSTRIDE = BK + 8;    // smem bf16 a row of a bf16 tile (272 B)
constexpr int CH = BK / 8;         // 8-value chunks of an A row

// Shared-memory layout and tile sizes of one instantiation. T is the A
// operand's storage type; SPLIT says it is staged as three bf16 terms; ND
// is the decoded planes of a slab (NSETS, or 3 for K2's combined decode:
// the three bf16 terms of the pre-added plane, 32 rows a block with f32
// x to stay within shared memory).
template <typename T, int NSETS, bool SPLIT, int ND = NSETS>
struct TileCfg {
  static constexpr int TERMS = SPLIT ? 3 : 1;
  static constexpr int BM = (NSETS == 1 && !SPLIT) ? 128
                            : (ND == 3 && SPLIT) ? 32 : 64;
  static constexpr int MT = BM / 32;                   // m16 tiles a warp
  static constexpr int RAW = sizeof(T) == 2 ? BK + 8 : BK + 4;  // elements
  static constexpr int RQ = BM * CH / THREADS;         // rows a thread sums
  static constexpr int RAW_B = BM * RAW * (int)sizeof(T);
  static constexpr int TERM_B = BM * TSTRIDE * 2;
  static constexpr int WORD_B = WROWS * WSTRIDE * 4;
  static constexpr int DEC_B = WROWS * TSTRIDE * 2;
  // three stages of the raw A slab and the words where they fit, else two
  static constexpr int STAGE_B = RAW_B + NSETS * WORD_B;
  static constexpr int FIXED_B =
      (SPLIT ? 3 * TERM_B : 0) + ND * DEC_B + BM * 4;
  static constexpr int STAGES = 3 * STAGE_B + FIXED_B <= 232448 ? 3 : 2;
  static constexpr int OFF_TERMS = STAGES * RAW_B;
  static constexpr int OFF_WORDS = OFF_TERMS + (SPLIT ? 3 * TERM_B : 0);
  static constexpr int OFF_DEC = OFF_WORDS + STAGES * NSETS * WORD_B;
  static constexpr int OFF_RS = OFF_DEC + ND * DEC_B;
  static constexpr int SMEM = OFF_RS + BM * 4;
  static_assert(SMEM <= 232448, "one block's shared memory on sm_90");
  static_assert(SPLIT || sizeof(T) == 2, "a one-term operand is bf16");
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero fill when !valid (src is
// then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest N committed groups have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a @ b (m16n8k16, bf16 inputs, f32 accumulator)
__device__ __forceinline__ void mma_acc(float d[4], const uint32_t a[4],
                                        const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d = a @ b (the first product of a slab: a fresh accumulator)
__device__ __forceinline__ void mma_first(float d[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

template <typename T> __device__ __forceinline__ T zero_val();
template <> __device__ __forceinline__ float zero_val<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_val<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// v rounded to T's precision, as an f32
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// two adjacent outputs; p is 2-element aligned
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 8 staged values as f32 (bf16 -> f32 is exact)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[2 * e] = __uint_as_float(w[e] << 16);
    v[2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// dst[r][cc] (row stride WSTRIDE) = plane[(row0 + r) * stride + c0 + cc]
// for r < WROWS, cc < 16, where row0 + r < nrows and c0 + cc < ncols, else
// 0. vec: 16-byte cp.async (stride, ncols multiples of 4, plane aligned);
// otherwise word by word, stored before the block's next barrier.
__device__ __forceinline__ void load_words(uint32_t* dst,
                                           const uint32_t* __restrict__ plane,
                                           int row0, int nrows, int stride,
                                           int c0, int ncols, bool vec) {
  for (int t = threadIdx.x; t < WROWS * 4; t += THREADS) {
    const int r = t >> 2, q = t & 3, row = row0 + r, c = c0 + 4 * q;
    uint32_t* d = dst + r * WSTRIDE + 4 * q;
    const uint32_t* src = plane + (size_t)row * stride + c;
    if (vec) {
      const bool ok = row < nrows && c < ncols;
      cp_async16(d, ok ? src : plane, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        d[e] = (row < nrows && c + e < ncols) ? src[e] : 0u;
    }
  }
}

// Two nibbles, one from each 16-bit half of v at shift sh, as a bf16 pair:
// (0x4300 | nib) is the bf16 of 128 + nib, and 128 is taken off exactly.
__device__ __forceinline__ uint32_t nib_pair(uint32_t v, int sh) {
  const uint32_t t = ((v >> sh) & 0x000F000Fu) | 0x43004300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(t), "r"(0x3F803F80u), "r"(0xC300C300u));   // t * 1 - 128
  return d;
}

// The decode of one slab: words [NSETS][WROWS][WSTRIDE] (16 used a row)
// -> dec [NSETS][WROWS][TSTRIDE] with dec[r][16*i + cc] = nibble i of word
// (r, cc). A thread takes 8 words of a row: the low and high halves of two
// neighbouring words pair up (byte_perm), so each bf16x2 holds nibble i of
// words cc and cc+1, and each nibble index i is one 16-byte store.
template <int NSETS>
__device__ __forceinline__ void decode_slab(const uint32_t* words,
                                            __nv_bfloat16* dec) {
  for (int u = threadIdx.x; u < NSETS * WROWS * 2; u += THREADS) {
    const int rs = u >> 1, h = u & 1;   // rs = set * WROWS + r
    const uint4* src = reinterpret_cast<const uint4*>(words + rs * WSTRIDE +
                                                      8 * h);
    const uint4 p = src[0], q = src[1];
    const uint32_t a[8] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      lo[e] = __byte_perm(a[2 * e], a[2 * e + 1], 0x5410);
      hi[e] = __byte_perm(a[2 * e], a[2 * e + 1], 0x7632);
    }
    uint4* row = reinterpret_cast<uint4*>(dec + rs * TSTRIDE + 8 * h);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t* s = i < 4 ? lo : hi;
      const int sh = 4 * (i & 3);
      row[2 * i] = make_uint4(nib_pair(s[0], sh), nib_pair(s[1], sh),
                              nib_pair(s[2], sh), nib_pair(s[3], sh));
    }
  }
}

// The combined decode of one slab (K2's QFA_COMBINE_PLANES): the two
// sets' words -> dec [3][WROWS][TSTRIDE], the three exact bf16 terms of
// v = nib_0 + ratio * nib_1 (f32, a product and a sum each rounded, no
// FMA), in decode_slab's k order.
__device__ __forceinline__ void decode_slab_comb(const uint32_t* words,
                                                 __nv_bfloat16* dec,
                                                 float ratio) {
  for (int u = threadIdx.x; u < WROWS * 8; u += THREADS) {
    const int r = u >> 3, cp = (u & 7) * 2;   // words cp, cp + 1 of row r
    const uint32_t* w0 = words + r * WSTRIDE + cp;
    const uint32_t* w1 = words + (WROWS + r) * WSTRIDE + cp;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        v[e] = __fadd_rn(
            static_cast<float>((w0[e] >> (4 * i)) & 0xFu),
            __fmul_rn(ratio, static_cast<float>((w1[e] >> (4 * i)) & 0xFu)));
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[0], v[1]);
      const float ra = v[0] - __low2float(h), rb = v[1] - __high2float(h);
      const __nv_bfloat162 mi = __floats2bfloat162_rn(ra, rb);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(ra - __low2float(mi),
                                                      rb - __high2float(mi));
      const __nv_bfloat162 t3[3] = {h, mi, lo};
#pragma unroll
      for (int t = 0; t < 3; ++t)
        *reinterpret_cast<__nv_bfloat162*>(
            dec + (t * WROWS + r) * TSTRIDE + 16 * i + cp) = t3[t];
    }
  }
}

// The staging pass over one A slab raw [BM][RAW] (the slab's k = 0..127):
// thread (r, j) adds chunk j (8 values) of each of its rows r = tid/CH +
// q*(THREADS/CH) to part[q]. With SPLIT it first scales the values (K3:
// g * scale[k0 + k], zero past kmax) and writes them as the three bf16
// terms terms[t][r][8j..8j+7].
template <class C, typename T>
__device__ __forceinline__ void stage_a(const T* raw, __nv_bfloat16* terms,
                                        float part[C::RQ],
                                        const float* __restrict__ scale,
                                        int k0, int kmax) {
  const int j = threadIdx.x % CH;
#pragma unroll
  for (int q = 0; q < C::RQ; ++q) {
    const int r = threadIdx.x / CH + q * (THREADS / CH);
    float v[8];
    load8(raw + r * C::RAW + 8 * j, v);
    if (C::TERMS == 3 && scale != nullptr) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = k0 + 8 * j + e;
        v[e] *= k < kmax ? __ldg(scale + k) : 0.f;
      }
    }
    part[q] +=
        ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
    if (C::TERMS == 3) {
      uint32_t t3[3][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
        const float ra = v[2 * e] - __low2float(h);
        const float rb = v[2 * e + 1] - __high2float(h);
        const __nv_bfloat162 mi = __floats2bfloat162_rn(ra, rb);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            ra - __low2float(mi), rb - __high2float(mi));
        t3[0][e] = bf16x2_bits(h);
        t3[1][e] = bf16x2_bits(mi);
        t3[2][e] = bf16x2_bits(lo);
      }
#pragma unroll
      for (int t = 0; t < 3; ++t)
        *reinterpret_cast<uint4*>(terms + (t * C::BM + r) * TSTRIDE + 8 * j) =
            make_uint4(t3[t][0], t3[t][1], t3[t][2], t3[t][3]);
    }
  }
}

// The warp's products over one slab: acc[s][mt][nt] = sum over the slab of
// A (rows wm*MT*16 + mt*16.., every term) times B of set s (columns wn*32 +
// nt*8..), starting from zero. A is [TERMS][BM][TSTRIDE] bf16, k along a
// row. B is dec of the slab: [n][k] rows (K2) or, with BT, [k][n] rows
// (K3, read with ldmatrix .trans). With ONE every set's products go into
// acc[0] (the combined decode's three terms of one plane).
template <class C, int NSETS, bool BT, bool ONE = false>
__device__ __forceinline__ void mma_slab(float acc[][C::MT][4][4],
                                         const __nv_bfloat16* A,
                                         const __nv_bfloat16* B) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const __nv_bfloat16* a0 =
      A + (wm * C::MT * 16 + (lane & 15)) * TSTRIDE + (lane >> 4) * 8;
  // ldmatrix x4 lane address: four 8x8 matrices over two n8 tiles
  const int b_n = wn * 32 + (lane >> 4) * 8;
  const int b_k = ((lane >> 3) & 1) * 8 + (lane & 7);   // BT: k row
  const __nv_bfloat16* b0 =
      BT ? B + b_k * TSTRIDE + b_n
         : B + (b_n + (lane & 7)) * TSTRIDE + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    uint32_t a[C::TERMS][C::MT][4];
#pragma unroll
    for (int t = 0; t < C::TERMS; ++t)
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt)
        ldsm_x4(a[t][mt], a0 + (t * C::BM + mt * 16) * TSTRIDE + ks * 16);
#pragma unroll
    for (int s = 0; s < NSETS; ++s) {
      uint32_t b[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        const __nv_bfloat16* p = b0 + s * WROWS * TSTRIDE;
        if (BT)
          ldsm_x4_t(r, p + ks * 16 * TSTRIDE + np * 16);
        else
          ldsm_x4(r, p + np * 16 * TSTRIDE + ks * 16);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int t = 0; t < C::TERMS; ++t) {
            float* d = acc[ONE ? 0 : s][mt][nt];
            if (ks == 0 && t == 0 && (s == 0 || !ONE))
              mma_first(d, a[t][mt], b[nt]);
            else
              mma_acc(d, a[t][mt], b[nt]);
          }
    }
  }
}

template <class C, int NSETS>
__device__ __forceinline__ void flush(float tot[NSETS][C::MT][4][4],
                                      float acc[NSETS][C::MT][4][4]) {
#pragma unroll
  for (int s = 0; s < NSETS; ++s)
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[s][mt][nt][e] += acc[s][mt][nt][e];
}

// Each row's sum: the CH lanes of a row group add their parts (a fixed
// butterfly, so deterministic); lane j = 0 writes rs[r].
template <class C>
__device__ __forceinline__ void finish_rowsums(float part[C::RQ], float* rs) {
#pragma unroll
  for (int q = 0; q < C::RQ; ++q) {
#pragma unroll
    for (int off = CH / 2; off > 0; off >>= 1)
      part[q] += __shfl_xor_sync(0xffffffffu, part[q], off);
    if (threadIdx.x % CH == 0)
      rs[threadIdx.x / CH + q * (THREADS / CH)] = part[q];
  }
}

}  // namespace tc
}  // namespace
