// T4 microbenchmark kernels for Hopper (sm_90a): the production nibble
// body and a decode-free floor, with the output rows per block as a
// template parameter (quip_for_all_tpu_torch/tools/microbench_tn.py).
//
// Replaces: tools/microbench_tn.py:make_nibble_call (:55, pallas_call at
// :73) and make_dma_call (:91, pallas_call at :102). The TPU tool sweeps
// TN, the output rows of one sequential grid step; on the H100 blocks run
// in parallel, so the analogue is the rows (and with them the warps) of
// one block, at the same total warps: 4 output rows a warp, RPB/4 warps
// a block, RPB in {16, 32, 64, 128} (16 is K1's block).
//
// x_perm (m, 8*Gp) bf16 in the grouped layout x_perm[r, i*Gp + g] =
// x[r, 8g + i]; words (q_out, Gp) int32, nibble i at bits 4i..4i+3:
//   nib  out = alpha * sum_{g,i} x_perm[r, i*Gp + g] * nib_i(w[n, g])
//              + beta * rowsum(x_perm[r])      (K1's function, one set);
//   dma  out = sum_g x_perm[r, g] * (w[n, g] & 0xF)   (one plane's dot).
// in f32, cast to bf16. Products are exact in f32; sums differ from the
// twins only in order.
//
// What bounds it on the card: device-memory bytes, q_out*Gp*4 plane bytes
// per call (25.2 MB at 12288 x 4096: 7.5 us at 3.35 TB/s; 46.1 MB at
// 22528 x 4096: 13.8 us; 23.1 MB at 4096 x 11264: 6.9 us). dma reads the
// same bytes with 1/8 of nib's arithmetic, so nib/dma separates the decode
// from the loads; the rows-per-block sweep separates the per-block cost
// (block scheduling, the warp reduction, the tail of the last wave) from
// both.
//
// Design: as nibble_decode.cuh's K1 body, one plane set: each lane loads
// 4 consecutive words (16 bytes) of each of its warp's 4 rows per step,
// striding by 128 words; x in 8-byte pieces through L1/L2; a warp shuffle
// ends each row. x rows come in tiles of MT in {1, 2, 4, 8} (gridDim.y).
// q_out needs no divisibility (a warp past the edge leaves, a partial
// warp re-reads the last row and masks its writes), so 22016 rows
// (2^9 * 43) run unpadded beside the TPU tool's 22528. At RPB = 128 a
// block has 1024 threads and at most 64 registers a thread: the 8-row
// accumulator may spill there (ptxas reports it).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 4;   // output rows per warp

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xFFFF0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xFFFF0000u);
}

template <int RPB, int MT, bool DMA>
__global__ void __launch_bounds__(RPB / ROWS * 32)
tn_kernel(const __nv_bfloat16* __restrict__ x,
          const uint32_t* __restrict__ w, __nv_bfloat16* __restrict__ out,
          int m, int q_out, int Gp, float alpha, float beta) {
  static_assert(RPB % ROWS == 0 && RPB / ROWS <= 32, "1..32 warps a block");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * RPB + warp * ROWS;
  if (n0 >= q_out) return;   // the whole warp leaves; no block sync follows
  const int r0 = blockIdx.y * MT;
  const size_t K = 8 * (size_t)Gp;
  float acc[ROWS][MT];
  float xs[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    xs[r] = 0.f;
#pragma unroll
    for (int j = 0; j < ROWS; ++j) acc[j][r] = 0.f;
  }

  for (int g = lane * 4; g < Gp; g += 128) {
    uint32_t wq[ROWS][4];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int n = min(n0 + j, q_out - 1);   // ragged edge: re-read a row
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(
          w + (size_t)n * Gp + g));
      wq[j][0] = t.x; wq[j][1] = t.y; wq[j][2] = t.z; wq[j][3] = t.w;
    }
#pragma unroll
    for (int q = 0; q < (DMA ? 1 : 8); ++q) {
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        float xv[4] = {0.f, 0.f, 0.f, 0.f};
        if (r0 + r < m)
          load4(x + (size_t)(r0 + r) * K + (size_t)q * Gp + g, xv);
        if (!DMA) xs[r] += (xv[0] + xv[1]) + (xv[2] + xv[3]);
#pragma unroll
        for (int j = 0; j < ROWS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[j][r] = fmaf(xv[e], (float)((wq[j][e] >> (4 * q)) & 0xFu),
                             acc[j][r]);
      }
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      if (!DMA) xs[r] += __shfl_xor_sync(0xffffffffu, xs[r], off);
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
        acc[j][r] += __shfl_xor_sync(0xffffffffu, acc[j][r], off);
    }
#pragma unroll
  for (int j = 0; j < ROWS; ++j)
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      const int n = n0 + j, row = r0 + r;
      if (lane == j * MT + r && n < q_out && row < m) {
        const float v = DMA ? acc[j][r] : alpha * acc[j][r] + beta * xs[r];
        out[(size_t)row * q_out + n] = __float2bfloat16_rn(v);
      }
    }
}

template <int RPB, bool DMA>
int launch_mt(const __nv_bfloat16* x, const uint32_t* w, __nv_bfloat16* out,
              int m, int q_out, int Gp, float alpha, float beta,
              cudaStream_t s) {
  const int bx = (q_out + RPB - 1) / RPB, threads = RPB / ROWS * 32;
#define QFA_TN_LAUNCH(MT)                                                  \
  tn_kernel<RPB, MT, DMA><<<dim3(bx, (m + MT - 1) / MT), threads, 0, s>>>( \
      x, w, out, m, q_out, Gp, alpha, beta)
  if (m == 1)
    QFA_TN_LAUNCH(1);
  else if (m == 2)
    QFA_TN_LAUNCH(2);
  else if (m <= 4)
    QFA_TN_LAUNCH(4);
  else
    QFA_TN_LAUNCH(8);
#undef QFA_TN_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

template <bool DMA>
int launch_rpb(int rpb, const __nv_bfloat16* x, const uint32_t* w,
               __nv_bfloat16* out, int m, int q_out, int Gp, float alpha,
               float beta, cudaStream_t s) {
  switch (rpb) {
    case 16: return launch_mt<16, DMA>(x, w, out, m, q_out, Gp, alpha, beta, s);
    case 32: return launch_mt<32, DMA>(x, w, out, m, q_out, Gp, alpha, beta, s);
    case 64: return launch_mt<64, DMA>(x, w, out, m, q_out, Gp, alpha, beta, s);
    case 128:
      return launch_mt<128, DMA>(x, w, out, m, q_out, Gp, alpha, beta, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. variant 0 = nib, 1 = dma;
// rows_per_block in {16, 32, 64, 128}; x (m, 8*Gp) bf16, w (q_out, Gp)
// int32, out (m, q_out) bf16; Gp a multiple of 4. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for what the kernel does not take.
extern "C" int qfa_mb_tn(int variant, int rows_per_block, const void* x,
                         const void* w, void* out, int m, int q_out, int Gp,
                         float alpha, float beta, void* stream) {
  if (m < 1 || q_out < 1 || Gp < 4 || Gp % 4 || variant < 0 || variant > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const uint32_t* wp = static_cast<const uint32_t*>(w);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return variant == 0
             ? launch_rpb<false>(rows_per_block, xp, wp, op, m, q_out, Gp,
                                 alpha, beta, s)
             : launch_rpb<true>(rows_per_block, xp, wp, op, m, q_out, Gp,
                                alpha, beta, s);
}
