// Fused row-pair decode + matmul for Hopper (sm_90a): two kernels, one per
// byte-cut runtime layout of ops/qtensor.py.
//
// Replaces: quip_for_all_tpu/ops/dequant_pallas.py
//   - _make_kernel_u3 (K9, :486): E8P12 in the u3 layout, through this
//     file's SIMT kernel (below);
//   - _make_kernel_pb (K8, :566): E8P12RVQ4B in the pb layout, through the
//     tensor-core body ucode_mma_small.cuh (shared with K7), where its
//     bound and design are;
// each through BOTH of _fused_call's grids (1-D at :868, 2-D m-tiled at
// :888). Either kernel takes any m.
//
// Both layouts store an output-row PAIR per int32 word: row 2r in bits
// 0..15, row 2r+1 in bits 16..31 (h = 0 / 1). With x_perm (m, 8*Gp) in the
// grouped layout x_perm[r, i*Gp + g] = x[r, 8g + i] (pad lanes zero) and
// the group sums gx[r, g] = sum_{i=0..7} x_perm[r, i*Gp + g], u3 computes
//
//   u = lo2 + 4*hi1, lo2 = (w0[n/2, g] >> (16h + 2i)) & 3,
//   hi1 = (w1[n/2, g mod Gp/2] >> (16h + 8*(g div Gp/2) + i)) & 1,
//   p   = (w2[n/2, g mod PL] >> (16h + g div PL)) & 1
//   out[r, n] = sum_{g,i} x*u - 0.5 * sum_g gx*p - 2.25 * rowsum(x)
//
// then times scale[n] (when given) and a cast to x's dtype. Every product
// is exact in f32 at bf16 x (u <= 7, parities 0/1), so the result differs
// from the plain twin (ops/rowpair_matmul.py) only by f32 summation order
// -- except gx, whose rounding the Pallas body fixes: f32 for blocks of at
// most 8 rows, and for a larger bf16 block a bf16 sum left to right over
// i (dequant_pallas.py :553-555). GXB selects that bf16 sum; the wrapper
// decides it from the padded row count as _fused_call does.
//
// What bounds it on the card: device-memory bytes. Per row pair a call
// must read Gp*4 + Gp*2 + PL*4 plane bytes, plus x, and write out; the
// arithmetic (one FMA per weight per row of x, ~a dozen integer ops per
// word) is far below the card's rate at decode sizes. On Llama-2-7B at
// bs=1 that is ~2.90 GB of planes per token, ~0.86 ms at the H100 SXM
// data-sheet 3.35 TB/s (computed from shapes, not measured), against 3.32
// GB in the nibble layout.
//
// Design of the u3 kernel (what it does about the bound), the SIMT nibble
// loop (nibble_decode.cuh) with row pairs:
//   - a block of WARPS warps; a warp owns PAIRS row pairs (2, or 1 with the
//     4- and 8-row accumulators, which would otherwise spill), so one
//     32-bit load feeds two output rows;
//   - each lane loads 4 consecutive words (uint4) of each plane per step,
//     covering groups g..g+3 and striding over Gp by 128 groups: w0, w1
//     and w2 at their own lane offsets. The 4 groups share one half of
//     w1 and one parity field, since Gp/2 and PL are multiples of 4.
//     Re-reads of w1 (twice) and of w2 (every Gp/PL steps the same words
//     of a lane) hit L1/L2, so device memory sees each plane byte about
//     once;
//   - x is read through L1/L2 (4 consecutive groups of position i, 8 or 16
//     bytes), its row sums and group sums are kept per lane, and the parity
//     correction -0.5*p*gx is folded into the accumulator once per group;
//   - the accumulator holds MT rows of x, MT in {1, 2, 4, 8} picked from m;
//     gridDim.y walks m-tiles of MT; a warp-shuffle reduction ends each
//     row, then the epilogue.
// q_out must be even and m >= 1; the ragged last tile is masked. Not done
// yet: u3 on the tensor-core body, as pb runs it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ucode_mma_small.cuh"

namespace {

constexpr int WARPS = 4;   // warps per block
constexpr unsigned FULL = 0xffffffffu;

// row pairs per warp: 2 (4 output rows) at decode sizes, 1 with the 4- and
// 8-row accumulators
template <int MT>
__host__ __device__ constexpr int pairs_per_warp() { return MT >= 4 ? 1 : 2; }

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  // bf16 -> f32 is a 16-bit left shift of the bits (exact)
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xFFFF0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xFFFF0000u);
}
__device__ __forceinline__ void load4w(const uint32_t* p, uint32_t w[4]) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
  w[0] = t.x; w[1] = t.y; w[2] = t.z; w[3] = t.w;
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// a + b rounded to bf16: both are bf16 values, so the f32 sum rounded
// once more is the correctly rounded bf16 sum
__device__ __forceinline__ float add_bf16(float a, float b) {
  return __bfloat162float(__float2bfloat16_rn(a + b));
}

template <typename T, bool GXB, int MT>
__global__ void __launch_bounds__(WARPS * 32)
rowpair_decode_matmul_kernel(const T* __restrict__ x,
                             const uint32_t* __restrict__ w0,
                             const uint32_t* __restrict__ w1,
                             const uint32_t* __restrict__ w2,
                             const float* __restrict__ scale,
                             T* __restrict__ out, int m, int q_out, int Gp,
                             int PL, float beta) {
  constexpr int PAIRS = pairs_per_warp<MT>();
  constexpr int ROWS = 2 * PAIRS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int half = q_out >> 1;                       // row pairs
  const int rp0 = (blockIdx.x * WARPS + warp) * PAIRS;
  if (rp0 >= half) return;  // the whole warp leaves together; no block sync
  const int r0 = blockIdx.y * MT;
  const size_t K = 8 * (size_t)Gp;
  const int Gh = Gp >> 1;                            // w1's width

  float acc[ROWS][MT];
  float xs[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    xs[r] = 0.f;
#pragma unroll
    for (int j = 0; j < ROWS; ++j) acc[j][r] = 0.f;
  }

#pragma unroll 2
  for (int g = lane * 4; g < Gp; g += 128) {
    const int jp = g / PL;                           // parity field
    const int gp = g - jp * PL;                      // parity word
    const int dh = g >= Gh;                          // half of w1
    const int gh = g - dh * Gh;
    uint32_t wa[PAIRS][4], wc[PAIRS][4], wp[PAIRS][4];
#pragma unroll
    for (int pr = 0; pr < PAIRS; ++pr) {
      const size_t rp = min(rp0 + pr, half - 1);  // ragged edge: re-read
      load4w(w0 + rp * Gp + g, wa[pr]);
      load4w(w1 + rp * Gh + gh, wc[pr]);
      load4w(w2 + rp * PL + gp, wp[pr]);
    }
    float gx[MT][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float xv[MT][4];
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        if (r0 + r < m) {
          load4(x + (size_t)(r0 + r) * K + (size_t)i * Gp + g, xv[r]);
        } else {
          xv[r][0] = xv[r][1] = xv[r][2] = xv[r][3] = 0.f;
        }
        xs[r] += (xv[r][0] + xv[r][1]) + (xv[r][2] + xv[r][3]);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          gx[r][q] = i == 0 ? xv[r][q]
                   : GXB ? add_bf16(gx[r][q], xv[r][q])
                         : gx[r][q] + xv[r][q];
      }
#pragma unroll
      for (int pr = 0; pr < PAIRS; ++pr)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float u = (float)(
                ((wa[pr][q] >> (16 * h + 2 * i)) & 3u) +
                4u * ((wc[pr][q] >> (16 * h + 8 * dh + i)) & 1u));
#pragma unroll
            for (int r = 0; r < MT; ++r)
              acc[2 * pr + h][r] = fmaf(xv[r][q], u, acc[2 * pr + h][r]);
          }
    }
    // parity: -0.5 * p * gx, once per group
#pragma unroll
    for (int pr = 0; pr < PAIRS; ++pr)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float c =
              ((wp[pr][q] >> (16 * h + jp)) & 1u) ? -0.5f : 0.f;
#pragma unroll
          for (int r = 0; r < MT; ++r)
            acc[2 * pr + h][r] = fmaf(gx[r][q], c, acc[2 * pr + h][r]);
        }
  }

  // warp reduction: afterwards every lane holds the full sums
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      xs[r] += __shfl_xor_sync(FULL, xs[r], off);
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
        acc[j][r] += __shfl_xor_sync(FULL, acc[j][r], off);
    }
  }

  // epilogue: lane (j*MT + r) writes out[r0 + r, 2*rp0 + j]
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      const int n = 2 * rp0 + j, row = r0 + r;
      if (lane == j * MT + r && n < q_out && row < m) {
        float v = acc[j][r] - beta * xs[r];
        if (scale != nullptr) v *= scale[n];
        store(out + (size_t)row * q_out + n, v);
      }
    }
  }
}

template <typename T, bool GXB, int MT>
void launch(const void* x, const void* w0, const void* w1, const void* w2,
            const void* scale, void* out, int m, int q_out, int Gp, int PL,
            float beta, cudaStream_t stream) {
  static_assert(2 * pairs_per_warp<MT>() * MT <= 32,
                "epilogue gives one lane per output");
  const int pairs_per_block = WARPS * pairs_per_warp<MT>();
  dim3 grid((q_out / 2 + pairs_per_block - 1) / pairs_per_block,
            (m + MT - 1) / MT);
  rowpair_decode_matmul_kernel<T, GXB, MT>
      <<<grid, WARPS * 32, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const uint32_t*>(w0),
          static_cast<const uint32_t*>(w1), static_cast<const uint32_t*>(w2),
          static_cast<const float*>(scale), static_cast<T*>(out), m, q_out,
          Gp, PL, beta);
}

template <typename T, bool GXB>
void launch_mt(const void* x, const void* w0, const void* w1, const void* w2,
               const void* scale, void* out, int m, int q_out, int Gp, int PL,
               float beta, cudaStream_t s) {
  if (m == 1)
    launch<T, GXB, 1>(x, w0, w1, w2, scale, out, m, q_out, Gp, PL, beta, s);
  else if (m == 2)
    launch<T, GXB, 2>(x, w0, w1, w2, scale, out, m, q_out, Gp, PL, beta, s);
  else if (m <= 4)
    launch<T, GXB, 4>(x, w0, w1, w2, scale, out, m, q_out, Gp, PL, beta, s);
  else
    launch<T, GXB, 8>(x, w0, w1, w2, scale, out, m, q_out, Gp, PL, beta, s);
}

}  // namespace

// Plain C entry points, loaded with ctypes. x and out share one dtype
// (x_is_bf16 ? bfloat16 : float32); scale may be null; m is the number of
// rows of x to compute (x's row stride is 8*Gp); PL is w2's width; rs is
// pb's residual scale (u3 ignores it); beta is 2.25 (u3) or 2.25*(1+rs)
// (pb, which checks it); gx_bf16 selects the bf16 group sum. Each returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for shapes or a beta the kernel does not take.
extern "C" int qfa_rowpair_u3_matmul(const void* x, const void* w0,
                                     const void* w1, const void* w2,
                                     const void* scale, void* out, int m,
                                     int q_out, int Gp, int PL, float rs,
                                     float beta, int gx_bf16, int x_is_bf16,
                                     void* stream) {
  (void)rs;
  // the kernel's shape rules (ops/rowpair_matmul.py checks them first)
  if (m < 1 || q_out < 2 || q_out % 2 || Gp < 8 || Gp % 8 || PL < 4 ||
      PL % 4 || Gp % PL || Gp / PL > 16 || (gx_bf16 && !x_is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!x_is_bf16)
    launch_mt<float, false>(x, w0, w1, w2, scale, out, m, q_out, Gp, PL,
                            beta, s);
  else if (gx_bf16)
    launch_mt<__nv_bfloat16, true>(x, w0, w1, w2, scale, out, m, q_out, Gp,
                                   PL, beta, s);
  else
    launch_mt<__nv_bfloat16, false>(x, w0, w1, w2, scale, out, m, q_out, Gp,
                                    PL, beta, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qfa_rowpair_pb_matmul(const void* x, const void* w0,
                                     const void* w1, const void* w2,
                                     const void* scale, void* out, int m,
                                     int q_out, int Gp, int PL, float rs,
                                     float beta, int gx_bf16, int x_is_bf16,
                                     void* stream) {
  if (m < 1 || q_out < 2 || q_out % 2 || Gp < 4 || Gp % 4 || PL < 4 ||
      PL % 4 || (Gp + PL - 1) / PL > 8 || (gx_bf16 && !x_is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  return sm::dispatch_ucode<true>(x, w0, w1, w2, scale, out, m, q_out, Gp,
                                  PL, rs, beta, gx_bf16, x_is_bf16, stream);
}
