// T2 microbenchmark kernels for Hopper (sm_90a): E8P decode of raw 16-bit
// codes inside a fused matvec, two ways, beside a load floor and a dense
// bf16 matvec (quip_for_all_tpu_torch/tools/microbench_decode.py).
//
// Replaces: tools/microbench_decode.py:make_run (:115), the pallas_call at
// :168 with its four strategies: lane (planes_lane), lane_b
// (planes_lane_b), stream and dense.
//
// x (m, K) f32 in the grouped layout x[r, j*G + g] = x_nat[r, 8g + j];
// codes (N, G) int16, each decoded as _common does (:52-62): c = code &
// 0xFFFF, signs = c & 0xFF, abs = c >> 8, parity = popcount(signs) & 1,
// signs ^= parity, offs = parity ? -0.25 : +0.25; plane i (lanes
// [i*G, (i+1)*G)) takes column ii = SHUF[i] of the abs pattern:
//   v_i = (bit 7-ii of signs ? -1 : 1) * |pattern[abs][ii]| + offs, with
//   lane    |pattern| from a 256 x 8 f32 table (abs_grid_bytes / 4) held
//           in shared memory (8 KB);
//   lane_b  |pattern| the signed byte ii%4 of one of two 256-entry u32
//           tables (lo: columns 0-3, hi: 4-7) in shared memory, times 0.25;
//   stream  out[n] = sum_g (float)(int16)codes[n, g] (signed; no x);
//   dense   out = x @ W^T with W (N, K) bf16 in x's lane order.
// out (m, N) f32 (stream: (N,) f32), sums in f32.
//
// What bounds it on the card: the codes are 2 bytes a group of 8 weights,
// 4.2 MB at 4096 x 4096 (1.25 us at 3.35 TB/s); x is f32, so at m = 8 the
// f32 arithmetic (2*m*N*K = 268 MFLOP, 4.0 us at 67 TFLOP/s outside the
// tensor cores) bounds lane and lane_b before the bytes do. dense reads
// 33.5 MB of bf16 weights (10.0 us).
//
// Design: as the port's K1 body: 4 warps a block, 4 output rows a warp;
// each lane takes 4 consecutive codes (8 bytes) of each row per step,
// striding by 128 codes; x read as float4 through L1/L2. The table is
// copied to shared memory once per block; every weight is one shared
// memory read (lane_b: the two table words one read each per code). A
// warp shuffle ends each row. x rows come in tiles of MT in {1, 2, 4, 8}.
// Ragged N is masked.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int ROWS = 4;
enum { LANE = 0, LANE_B = 1, STREAM = 2, DENSE = 3 };
// _SHUF = (0, 2, 1, 3, 4, 6, 5, 7): positions 1 <-> 2 and 5 <-> 6 swap
__host__ __device__ constexpr int shuf(int i) {
  return (i & 3) == 1 ? i + 1 : (i & 3) == 2 ? i - 1 : i;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int V, int MT>
__global__ void __launch_bounds__(WARPS * 32)
decode_matvec(const float* __restrict__ x, const uint16_t* __restrict__ codes,
              const void* __restrict__ table, float* __restrict__ out, int m,
              int N, int G) {
  __shared__ float tbl_f[V == LANE ? 256 * 8 : 1];
  __shared__ uint32_t tbl_w[V == LANE_B ? 2 * 256 : 1];
  if (V == LANE) {
    const float* t = static_cast<const float*>(table);
    for (int i = threadIdx.x; i < 256 * 8; i += WARPS * 32) tbl_f[i] = t[i];
  } else {
    const uint32_t* t = static_cast<const uint32_t*>(table);
    for (int i = threadIdx.x; i < 2 * 256; i += WARPS * 32) tbl_w[i] = t[i];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * WARPS + warp) * ROWS;
  if (n0 >= N) return;   // after the only block sync
  const int r0 = blockIdx.y * MT;
  const size_t K = 8 * (size_t)G;
  float acc[ROWS][MT];
#pragma unroll
  for (int j = 0; j < ROWS; ++j)
#pragma unroll
    for (int r = 0; r < MT; ++r) acc[j][r] = 0.f;

  for (int g = lane * 4; g < G; g += 128) {
    int ab[ROWS][4];        // abs index
    uint32_t sg[ROWS][4];   // signs after the parity fold
    float of[ROWS][4];      // +-0.25
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int n = min(n0 + j, N - 1);
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(
          codes + (size_t)n * G + g));
      const uint32_t c4[4] = {t.x & 0xFFFFu, t.x >> 16, t.y & 0xFFFFu,
                              t.y >> 16};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t s = c4[e] & 0xFFu;
        const uint32_t par = __popc(s) & 1u;
        sg[j][e] = s ^ par;
        ab[j][e] = (int)(c4[e] >> 8);
        of[j][e] = par ? -0.25f : 0.25f;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ii = shuf(i);
      float pv[ROWS][4];
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v;
          if (V == LANE) {
            v = tbl_f[ab[j][e] * 8 + ii];
          } else {
            const uint32_t word = tbl_w[(ii < 4 ? 0 : 256) + ab[j][e]];
            v = (float)(int8_t)((word >> (8 * (ii & 3))) & 0xFFu) * 0.25f;
          }
          if ((sg[j][e] >> (7 - ii)) & 1u) v = -v;
          pv[j][e] = v + of[j][e];
        }
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r0 + r < m)
          xv = __ldg(reinterpret_cast<const float4*>(
              x + (size_t)(r0 + r) * K + (size_t)i * G + g));
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
          acc[j][r] = fmaf(xv.x, pv[j][0], acc[j][r]);
          acc[j][r] = fmaf(xv.y, pv[j][1], acc[j][r]);
          acc[j][r] = fmaf(xv.z, pv[j][2], acc[j][r]);
          acc[j][r] = fmaf(xv.w, pv[j][3], acc[j][r]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < ROWS; ++j)
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      const float s = warp_sum(acc[j][r]);
      const int n = n0 + j, row = r0 + r;
      if (lane == j * MT + r && n < N && row < m) out[(size_t)row * N + n] = s;
    }
}

// dense: f32 x against bf16 W, 8 weights (16 bytes) a lane per step
template <int MT>
__global__ void __launch_bounds__(WARPS * 32)
dense_matvec(const float* __restrict__ x, const __nv_bfloat16* __restrict__ W,
             float* __restrict__ out, int m, int N, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * WARPS + warp) * ROWS;
  if (n0 >= N) return;
  const int r0 = blockIdx.y * MT;
  float acc[ROWS][MT];
#pragma unroll
  for (int j = 0; j < ROWS; ++j)
#pragma unroll
    for (int r = 0; r < MT; ++r) acc[j][r] = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    float wv[ROWS][8];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int n = min(n0 + j, N - 1);
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(
          W + (size_t)n * K + k));
      const uint32_t q[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        wv[j][2 * e] = __uint_as_float(q[e] << 16);
        wv[j][2 * e + 1] = __uint_as_float(q[e] & 0xFFFF0000u);
      }
    }
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      if (r0 + r >= m) continue;
      const float* xr = x + (size_t)(r0 + r) * K + k;
      const float4 a = __ldg(reinterpret_cast<const float4*>(xr));
      const float4 b = __ldg(reinterpret_cast<const float4*>(xr + 4));
      const float xv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[j][r] = fmaf(xv[e], wv[j][e], acc[j][r]);
    }
  }
#pragma unroll
  for (int j = 0; j < ROWS; ++j)
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      const float s = warp_sum(acc[j][r]);
      const int n = n0 + j, row = r0 + r;
      if (lane == j * MT + r && n < N && row < m) out[(size_t)row * N + n] = s;
    }
}

// stream: every code read and summed as a signed int16, one sum per row
__global__ void __launch_bounds__(WARPS * 32)
code_sums(const uint16_t* __restrict__ codes, float* __restrict__ out, int N,
          int G) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * WARPS + warp) * ROWS;
  if (n0 >= N) return;
  float s[ROWS] = {0.f, 0.f, 0.f, 0.f};
  for (int g = lane * 8; g < G; g += 256) {
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int n = min(n0 + j, N - 1);
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(
          codes + (size_t)n * G + g));
      const uint32_t q[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j] += (float)(int16_t)(q[e] & 0xFFFFu) +
                (float)(int16_t)(q[e] >> 16);
    }
  }
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const float v = warp_sum(s[j]);
    if (lane == j && n0 + j < N) out[n0 + j] = v;
  }
}

template <int MT>
void launch_mt(int variant, const float* x, const void* w, const void* table,
               float* out, int m, int N, int K, cudaStream_t s) {
  const dim3 grid((N + WARPS * ROWS - 1) / (WARPS * ROWS), (m + MT - 1) / MT);
  const uint16_t* c = static_cast<const uint16_t*>(w);
  if (variant == LANE)
    decode_matvec<LANE, MT><<<grid, WARPS * 32, 0, s>>>(x, c, table, out, m,
                                                        N, K / 8);
  else if (variant == LANE_B)
    decode_matvec<LANE_B, MT><<<grid, WARPS * 32, 0, s>>>(x, c, table, out,
                                                          m, N, K / 8);
  else
    dense_matvec<MT><<<grid, WARPS * 32, 0, s>>>(
        x, static_cast<const __nv_bfloat16*>(w), out, m, N, K);
}

}  // namespace

// Plain C entry point, loaded with ctypes. variant: 0 lane, 1 lane_b
// (codes (N, K/8) int16 and the table: (256, 8) f32 or (2, 256) int32), 2
// stream (codes only -> out (N,) f32), 3 dense (w is W (N, K) bf16). x
// (m, K) f32, out (m, N) f32; K a multiple of 64 (G a multiple of 8).
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for what the kernel does not take.
extern "C" int qfa_mb_decode(int variant, const void* x, const void* w,
                             const void* table, void* out, int m, int N,
                             int K, void* stream) {
  if (N < 1 || K < 64 || K % 64 || variant < 0 || variant > DENSE ||
      (variant != STREAM && m < 1) ||
      ((variant == LANE || variant == LANE_B) && table == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (variant == STREAM) {
    code_sums<<<(N + WARPS * ROWS - 1) / (WARPS * ROWS), WARPS * 32, 0, s>>>(
        static_cast<const uint16_t*>(w), o, N, K / 8);
    return static_cast<int>(cudaGetLastError());
  }
  const float* xp = static_cast<const float*>(x);
  if (m == 1)
    launch_mt<1>(variant, xp, w, table, o, m, N, K, s);
  else if (m == 2)
    launch_mt<2>(variant, xp, w, table, o, m, N, K, s);
  else if (m <= 4)
    launch_mt<4>(variant, xp, w, table, o, m, N, K, s);
  else
    launch_mt<8>(variant, xp, w, table, o, m, N, K, s);
  return static_cast<int>(cudaGetLastError());
}
