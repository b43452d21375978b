// Expert-indexed fused affine-nibble decode + matmul for Hopper (sm_90a).
//
// Replaces: quip_for_all_tpu/ops/moe_pallas.py
//   - _make_moe_kernel (K4, :56) through _moe_call's pallas_call at :234,
//     in either grid order (tiles outer / rows inner by default, rows outer
//     under QFA_MOE_TILES_INNER);
//   - _make_moe_kernel_merged (K5, :91) through the pallas_call at :178
//     (QFA_MOE_MERGED, R <= 4), which computes the same function with every
//     row's expert planes in one grid step.
// One kernel computes what all three compute. For x_perm (R, 8*Gp) in the
// grouped layout x_perm[r, i*Gp + g] = x[r, 8g + i], eids (R,) int32 and 1
// or 2 stacked plane sets of int32 words (E, q_out, Gp):
//
//   acc_s[r, n] = sum_{g, i} x_perm[r, i*Gp + g]
//                            * ((w_s[eids[r], n, g] >> 4i) & 0xF)
//   out[r, n]   = sum_s alpha_s * acc_s[r, n] + beta_total * rowsum(x_perm[r])
//
// cast to x's dtype. There is no scale epilogue: the caller applies the
// per-expert pre_vec after the cast, as the JAX package does. Every product
// is exact in f32 (bf16- or f32-valued x times nibbles 0..15), so the
// result differs from the plain twin only by f32 summation order. Nibbles
// are taken from the word as uint32, so the shift of nibble 7 is logical.
// Rows whose expert id lies outside 0..E-1 are the caller's error and are
// left unwritten.
//
// What bounds it on the card: device-memory bytes. A call must read the
// planes of every DISTINCT selected expert once (n_sets*q_out*Gp*4 bytes
// each) plus x, and write out. On Mixtral-8x7B (E8P12 nibble planes) the
// decode shapes are
//
//   call   q_out x Gp     plane bytes per expert
//   w13    28672 x 512    58.7 MB
//   w2      4096 x 1792   29.4 MB
//
// and a bs=1 decode step (top-2, R = 2 rows, 2 distinct experts) must read
// 2 x (58.7 + 29.4) MB per layer, ~5.64 GB per token over 32 layers: ~1.68
// ms per token at the H100 SXM data-sheet 3.35 TB/s (computed from shapes,
// not measured). The arithmetic is 2 FMAs per plane nibble per row, far
// below the card's rate at these row counts.
//
// Design (simple first; what it does about the bound):
//   - grid (q_out tiles, min(E, R)). blockIdx.y = j picks the j-th expert
//     present in eids (ascending), so there is no host sync to learn the
//     routing and no block for an expert nobody selected: at bs=1 decode
//     the grid is exactly the 2 selected experts' tiles, and both experts
//     stream at once (what K5 buys on the TPU). A block whose j is past the
//     number of distinct experts leaves at once;
//   - each block collects the rows routed to its expert (warp ballots, in
//     row order, ROW_WINDOW rows of eids per pass) into shared memory, and
//     streams its plane tile ONCE for up to MT of those rows, so planes are
//     read once per distinct expert, as the JAX default grid gets by
//     skipping the DMA on sorted rows;
//   - the tile loop is fused_decode_matmul.cu's: a warp owns 4 output rows
//     (2 with the 8-row accumulator), each lane loads 16 bytes of each row
//     per step, striding over Gp by 128 words; x is read through L1/L2;
//   - MT in {1, 2, 4, 8} is picked on the host from the most rows one
//     expert can have: R, or less when the caller knows it (top-K routing
//     gives an expert at most one row per token, so bs=1 decode carries a
//     1-row accumulator: 128 registers against 168 for 2 rows, and
//     measurably faster, PERF.md). An expert with more than MT rows, should
//     the bound be wrong, loops over chunks of MT, re-reading its planes.
// Not done yet (a later PR): tensor-core products for batched R, cp.async/
// TMA staging, folding pre_vec into the epilogue under a parity check.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;            // warps per block
constexpr int MAX_EXPERTS = 64;     // experts present kept as a 64-bit mask
constexpr int ROW_WINDOW = 256;     // rows of eids collected per pass
constexpr unsigned FULL = 0xffffffffu;

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

// One warp: output rows n0 .. n0+ROWS-1 of one expert for up to MT rows of
// x (row indices xr[], -1 for an empty slot).
template <typename T, int NSETS, int MT>
__device__ __forceinline__ void warp_rows(const T* __restrict__ x,
                                          const uint32_t* __restrict__ w0,
                                          const uint32_t* __restrict__ w1,
                                          T* __restrict__ out,
                                          const int xr[MT], int n0, int lane,
                                          int q_out, int Gp, float alpha0,
                                          float alpha1, float beta_total) {
  constexpr int ROWS = rows_per_warp<MT>();
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
        if (xr[r] >= 0) {
          load4(x + (size_t)xr[r] * K + (size_t)i * Gp + g, xv[r]);
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
      xs[r] += __shfl_xor_sync(FULL, xs[r], off);
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
#pragma unroll
        for (int s = 0; s < NSETS; ++s)
          acc[s][j][r] += __shfl_xor_sync(FULL, acc[s][j][r], off);
    }
  }

  // epilogue: lane (j*MT + r) writes out[xr[r], n0 + j]
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      const int n = n0 + j;
      if (lane == j * MT + r && n < q_out && xr[r] >= 0) {
        float v = acc[0][j][r] * alpha0;
        if (NSETS > 1) v += acc[NSETS - 1][j][r] * alpha1;
        v += beta_total * xs[r];
        store(out + (size_t)xr[r] * q_out + n, v);
      }
    }
  }
}

template <typename T, int NSETS, int MT>
__global__ void __launch_bounds__(WARPS * 32)
moe_decode_matmul_kernel(const T* __restrict__ x,
                         const int* __restrict__ eids,
                         const uint32_t* __restrict__ w0,
                         const uint32_t* __restrict__ w1,
                         T* __restrict__ out, int R, int E, int q_out,
                         int Gp, float alpha0, float alpha1,
                         float beta_total) {
  constexpr int ROWS = rows_per_warp<MT>();
  __shared__ unsigned long long present;
  __shared__ int rows[ROW_WINDOW];
  __shared__ int nrows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // the set of experts present in eids, as a bit mask
  if (threadIdx.x == 0) present = 0ull;
  __syncthreads();
  unsigned long long mine = 0ull;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int e = eids[r];
    if (e >= 0 && e < E) mine |= 1ull << e;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mine |= __shfl_xor_sync(FULL, mine, off);
  if (lane == 0 && mine != 0ull) atomicOr(&present, mine);
  __syncthreads();

  // this block's expert: the blockIdx.y-th one present, in ascending order
  unsigned long long p = present;
  if (__popcll(p) <= (int)blockIdx.y) return;     // the whole block leaves
  for (unsigned k = 0; k < blockIdx.y; ++k) p &= p - 1;
  const int e = __ffsll((long long)p) - 1;
  const size_t plane_off = (size_t)e * q_out * Gp;
  const uint32_t* we0 = w0 + plane_off;
  const uint32_t* we1 = NSETS > 1 ? w1 + plane_off : w0;

  const int n0 = (blockIdx.x * WARPS + warp) * ROWS;
  for (int base = 0; base < R; base += ROW_WINDOW) {
    // warp 0 lists this window's rows of expert e, in row order
    if (warp == 0) {
      const int end = min(R, base + ROW_WINDOW);
      int count = 0;
      for (int r0 = base; r0 < end; r0 += 32) {
        const int r = r0 + lane;
        const bool hit = r < end && eids[r] == e;
        const unsigned b = __ballot_sync(FULL, hit);
        if (hit) rows[count + __popc(b & ((1u << lane) - 1u))] = r;
        count += __popc(b);
      }
      if (lane == 0) nrows = count;
    }
    __syncthreads();
    const int n = nrows;
    if (n0 < q_out) {
      for (int c = 0; c < n; c += MT) {
        int xr[MT];
#pragma unroll
        for (int r = 0; r < MT; ++r) xr[r] = c + r < n ? rows[c + r] : -1;
        warp_rows<T, NSETS, MT>(x, we0, we1, out, xr, n0, lane, q_out, Gp,
                                alpha0, alpha1, beta_total);
      }
    }
    __syncthreads();      // the next window overwrites rows[]
  }
}

template <typename T, int NSETS, int MT>
void launch(const void* x, const int* eids, const void* w0, const void* w1,
            void* out, int R, int E, int q_out, int Gp, float a0, float a1,
            float beta, cudaStream_t stream) {
  static_assert(rows_per_warp<MT>() * MT <= 32,
                "epilogue gives one lane per output");
  const int rows_per_block = WARPS * rows_per_warp<MT>();
  dim3 grid((q_out + rows_per_block - 1) / rows_per_block, min(E, R));
  moe_decode_matmul_kernel<T, NSETS, MT><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), eids, static_cast<const uint32_t*>(w0),
      static_cast<const uint32_t*>(w1), static_cast<T*>(out), R, E, q_out,
      Gp, a0, a1, beta);
}

template <typename T, int NSETS>
void launch_mt(const void* x, const int* eids, const void* w0, const void* w1,
               void* out, int R, int max_rows, int E, int q_out, int Gp,
               float a0, float a1, float beta, cudaStream_t s) {
  if (max_rows == 1)
    launch<T, NSETS, 1>(x, eids, w0, w1, out, R, E, q_out, Gp, a0, a1, beta,
                        s);
  else if (max_rows == 2)
    launch<T, NSETS, 2>(x, eids, w0, w1, out, R, E, q_out, Gp, a0, a1, beta,
                        s);
  else if (max_rows <= 4)
    launch<T, NSETS, 4>(x, eids, w0, w1, out, R, E, q_out, Gp, a0, a1, beta,
                        s);
  else
    launch<T, NSETS, 8>(x, eids, w0, w1, out, R, E, q_out, Gp, a0, a1, beta,
                        s);
}

}  // namespace

// Plain C entry point, loaded with ctypes. x and out share one dtype
// (x_is_bf16 ? bfloat16 : float32); w1 may be null (n_sets == 1); R >= 1,
// 1 <= max_rows <= R bounds the rows of any one expert (it sizes the
// accumulator; the result does not depend on it), 1 <= E <= 64; x's row
// stride is 8*Gp. Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for arguments the kernel does not
// take.
extern "C" int qfa_moe_decode_matmul(const void* x, const void* eids,
                                     const void* w0, const void* w1,
                                     void* out, int R, int max_rows, int E,
                                     int q_out, int Gp, int n_sets,
                                     float alpha0, float alpha1,
                                     float beta_total, int x_is_bf16,
                                     void* stream) {
  if (R < 1 || max_rows < 1 || max_rows > R || E < 1 || E > MAX_EXPERTS ||
      q_out < 1 || Gp < 4 || Gp % 4 || (n_sets != 1 && n_sets != 2) ||
      (n_sets == 2 && w1 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ids = static_cast<const int*>(eids);
  if (n_sets == 1 && x_is_bf16)
    launch_mt<__nv_bfloat16, 1>(x, ids, w0, w1, out, R, max_rows, E, q_out,
                                Gp, alpha0, alpha1, beta_total, s);
  else if (n_sets == 1)
    launch_mt<float, 1>(x, ids, w0, w1, out, R, max_rows, E, q_out, Gp,
                        alpha0, alpha1, beta_total, s);
  else if (x_is_bf16)
    launch_mt<__nv_bfloat16, 2>(x, ids, w0, w1, out, R, max_rows, E, q_out,
                                Gp, alpha0, alpha1, beta_total, s);
  else
    launch_mt<float, 2>(x, ids, w0, w1, out, R, max_rows, E, q_out, Gp,
                        alpha0, alpha1, beta_total, s);
  return static_cast<int>(cudaGetLastError());
}
