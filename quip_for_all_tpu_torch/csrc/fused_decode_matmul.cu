// Fused affine-nibble decode + matmul for Hopper (sm_90a).
//
// Replaces: quip_for_all_tpu/ops/dequant_pallas.py:_make_kernel (split=1,
// nibble layout) through BOTH of _fused_call's grids — the 1-D grid
// (pallas_call at :868, decode, TM == m) and the 2-D m-tiled grid (:888,
// prefill below the crossover). One kernel takes any m.
//
// Computes, for x_perm (m, 8*Gp) in the grouped layout
// x_perm[r, i*Gp + g] = x[r, 8g + i] and 1 or 2 plane sets of int32 words
// (q_out, Gp):
//
//   acc_s[r, n] = sum_{g, i} x_perm[r, i*Gp + g] * ((w_s[n, g] >> 4i) & 0xF)
//   out[r, n]   = (sum_s alpha_s * acc_s[r, n] + beta_total * rowsum(x_perm[r]))
//                 * scale[n]              (when a scale vector is given)
//
// cast to x's dtype (bf16 on the model path, f32 in tests). Every product
// is exact in f32 (x is bf16- or f32-valued, nibbles are 0..15), so the
// result differs from the plain twin only by f32 summation order. Nibbles
// are taken from the word as uint32, so the shift of nibble 7 is logical.
//
// What bounds it on the card: device-memory bytes. Each call must read
// n_sets*q_out*Gp*4 plane bytes plus x and write out; at decode sizes the
// arithmetic (2 FMAs per plane byte per row of x) is far below the card's
// rate. At bs=1 on Llama-2-7B the planes per token are:
//
//   layer     q_out x Gp     plane bytes
//   qkv       12288 x 512    25.2 MB
//   o          4096 x 512     8.4 MB
//   gate/up   22016 x 512    45.1 MB
//   down       4096 x 1408   23.1 MB
//   head      32000 x 512    65.5 MB
//
// about 3.32 GB per token with 32 layers, which at the H100 SXM data-sheet
// 3.35 TB/s bounds bs=1 decode at ~0.99 ms/token (computed from shapes,
// not measured).
//
// Design (simple first; what it does about the bound): a bandwidth-bound
// kernel needs many bytes in flight per SM, so registers are kept low
// enough for several blocks per SM and every plane load is 16 bytes:
//   - a block of WARPS warps; each warp owns 4 output rows (2 when MT=8);
//     each lane loads 4 consecutive words (uint4) of each row per step,
//     striding over Gp by 128 words, so a warp's loads are 512 contiguous
//     bytes per row;
//   - the 4 groups' x lanes for position i are 4 consecutive elements
//     (8 or 16 bytes), read through L1/L2 (x does not fit shared memory at
//     every m: 8 rows of down_proj's f32 x are 360 KB);
//   - the accumulator holds MT rows of x, MT in {1, 2, 4, 8} picked from m
//     so decode (m = 1) carries one row; gridDim.y walks m-tiles of MT;
//   - a warp-shuffle reduction ends each row, then the epilogue.
// q_out and m need no divisibility (ragged edges are masked); Gp must be a
// multiple of 4 (plane rows are padded to 128 groups). Not done yet (a
// later PR): cp.async/TMA staging, tensor-core products for m >= 8,
// split-K across SMs for the 4096-row layers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;   // warps per block

// output rows per warp: 4 at decode sizes; 2 with the 8-row accumulator,
// which would otherwise spill
template <int MT>
__host__ __device__ constexpr int rows_per_warp() { return MT >= 8 ? 2 : 4; }

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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int NSETS, int MT>
__global__ void __launch_bounds__(WARPS * 32)
fused_decode_matmul_kernel(const T* __restrict__ x,
                           const uint32_t* __restrict__ w0,
                           const uint32_t* __restrict__ w1,
                           const float* __restrict__ scale,
                           T* __restrict__ out,
                           int m, int q_out, int Gp,
                           float alpha0, float alpha1, float beta_total) {
  constexpr int ROWS = rows_per_warp<MT>();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * WARPS + warp) * ROWS;
  if (n0 >= q_out) return;  // the whole warp leaves together; no block sync
  const int r0 = blockIdx.y * MT;
  const size_t K = 8 * (size_t)Gp;

  float acc[NSETS][ROWS][MT];
  float xs[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    xs[r] = 0.f;
#pragma unroll
    for (int j = 0; j < ROWS; ++j)
#pragma unroll
      for (int s = 0; s < NSETS; ++s) acc[s][j][r] = 0.f;
  }

#pragma unroll 2
  for (int g = lane * 4; g < Gp; g += 128) {
    uint4 wv[NSETS][ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int n = min(n0 + j, q_out - 1);   // ragged edge: re-read a row
      const size_t off = (size_t)n * Gp + g;
      wv[0][j] = __ldg(reinterpret_cast<const uint4*>(w0 + off));
      if (NSETS > 1)
        wv[NSETS - 1][j] = __ldg(reinterpret_cast<const uint4*>(w1 + off));
    }
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
      }
#pragma unroll
      for (int s = 0; s < NSETS; ++s)
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
          const uint32_t wq[4] = {wv[s][j].x, wv[s][j].y, wv[s][j].z,
                                  wv[s][j].w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float nib = (float)((wq[q] >> (4 * i)) & 0xFu);
#pragma unroll
            for (int r = 0; r < MT; ++r)
              acc[s][j][r] = fmaf(xv[r][q], nib, acc[s][j][r]);
          }
        }
    }
  }

  // warp reduction: afterwards every lane holds the full sums
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      xs[r] += __shfl_xor_sync(0xffffffffu, xs[r], off);
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
#pragma unroll
        for (int s = 0; s < NSETS; ++s)
          acc[s][j][r] += __shfl_xor_sync(0xffffffffu, acc[s][j][r], off);
    }
  }

  // epilogue: lane (j*MT + r) writes out[r0 + r, n0 + j]
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      const int n = n0 + j, row = r0 + r;
      if (lane == j * MT + r && n < q_out && row < m) {
        float v = acc[0][j][r] * alpha0;
        if (NSETS > 1) v += acc[NSETS - 1][j][r] * alpha1;
        v += beta_total * xs[r];
        if (scale != nullptr) v *= scale[n];
        store(out + (size_t)row * q_out + n, v);
      }
    }
  }
}

template <typename T, int NSETS, int MT>
void launch(const void* x, const void* w0, const void* w1, const void* scale,
            void* out, int m, int q_out, int Gp, float a0, float a1,
            float beta, cudaStream_t stream) {
  static_assert(rows_per_warp<MT>() * MT <= 32,
                "epilogue gives one lane per output");
  const int rows_per_block = WARPS * rows_per_warp<MT>();
  dim3 grid((q_out + rows_per_block - 1) / rows_per_block, (m + MT - 1) / MT);
  fused_decode_matmul_kernel<T, NSETS, MT><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(w0),
      static_cast<const uint32_t*>(w1), static_cast<const float*>(scale),
      static_cast<T*>(out), m, q_out, Gp, a0, a1, beta);
}

template <typename T, int NSETS>
void launch_mt(const void* x, const void* w0, const void* w1,
               const void* scale, void* out, int m, int q_out, int Gp,
               float a0, float a1, float beta, cudaStream_t s) {
  if (m == 1)
    launch<T, NSETS, 1>(x, w0, w1, scale, out, m, q_out, Gp, a0, a1, beta, s);
  else if (m == 2)
    launch<T, NSETS, 2>(x, w0, w1, scale, out, m, q_out, Gp, a0, a1, beta, s);
  else if (m <= 4)
    launch<T, NSETS, 4>(x, w0, w1, scale, out, m, q_out, Gp, a0, a1, beta, s);
  else
    launch<T, NSETS, 8>(x, w0, w1, scale, out, m, q_out, Gp, a0, a1, beta, s);
}

}  // namespace

// Plain C entry point, loaded with ctypes. x and out share one dtype
// (x_is_bf16 ? bfloat16 : float32); w1 and scale may be null; m is the
// number of rows of x to compute (x's row stride is 8*Gp). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int qfa_fused_decode_matmul(const void* x, const void* w0,
                                       const void* w1, const void* scale,
                                       void* out, int m, int q_out, int Gp,
                                       int n_sets, float alpha0, float alpha1,
                                       float beta_total, int x_is_bf16,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_sets == 1 && x_is_bf16)
    launch_mt<__nv_bfloat16, 1>(x, w0, w1, scale, out, m, q_out, Gp, alpha0,
                                alpha1, beta_total, s);
  else if (n_sets == 1)
    launch_mt<float, 1>(x, w0, w1, scale, out, m, q_out, Gp, alpha0, alpha1,
                        beta_total, s);
  else if (x_is_bf16)
    launch_mt<__nv_bfloat16, 2>(x, w0, w1, scale, out, m, q_out, Gp, alpha0,
                                alpha1, beta_total, s);
  else
    launch_mt<float, 2>(x, w0, w1, scale, out, m, q_out, Gp, alpha0, alpha1,
                        beta_total, s);
  return static_cast<int>(cudaGetLastError());
}
