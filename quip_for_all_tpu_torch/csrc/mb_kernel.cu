// T1 microbenchmark kernels for Hopper (sm_90a): four ablations of a
// decode + matvec (quip_for_all_tpu_torch/tools/microbench_kernel.py).
//
// Replaces: tools/microbench_kernel.py:make_call (:37), the pallas_call at
// :80, all four bodies: kern_prod, kern_nodec, kern_onedot, kern_stream.
//
// x (m, K) bf16 with plane i's G = K/8 lanes at [i*G, (i+1)*G); words
// (N, G) int32 (the JAX tool's words are in [0, 2^25)):
//   prod    plane i = ((w >> 3i) & 7) - 2.25 - 0.5 * ((w >> 24) & 1);
//   nodec   every plane = bf16(w), rounded int -> f32 -> bf16 (nearest
//           even at each step, as torch's int32 -> bf16);
//   onedot  prod's planes, decoded into shared memory as bf16 first;
//   stream  out[n] = sum_g f32(w[n, g]) (no x).
// out (m, N) bf16 = sum_i x_i . plane_i in f32 (stream: (N,) f32). Every
// product is exact in f32 (8-bit x mantissa times a plane value of <= 8
// significant bits), so kernel and twin differ by f32 sum order only.
//
// What bounds it on the card: device-memory bytes. A call reads the
// N*G*4 plane bytes once (8.4 MB at 4096 x 4096: 2.5 us at 3.35 TB/s), x
// and the output are small at decode m; 2 FLOP per weight and row of x is
// far below the card's f32 rate at m <= 8.
//
// Design: the prod/nodec/stream bodies load as the port's K1 does
// (nibble_decode.cuh): 4 warps a block, 4 output rows a warp, each lane 4
// consecutive words (16 bytes) per row per step, a warp's step 512
// contiguous bytes of a row; the decode runs in registers, x is read
// through L1/L2 in 8-byte pieces, a warp shuffle ends each row. onedot
// decodes 4 rows (one per warp) into shared memory with all 128 threads,
// then each warp runs one bf16 x bf16 pass over its row's 8G values, 16
// bytes a lane. x rows come in tiles of MT in {1, 2, 4, 8} (gridDim.y).
// Ragged N is masked. The kernels stay simple: they are ablations, and
// the differences between them are the measurement.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;    // warps per block
constexpr int ROWS = 4;     // output rows per warp (prod, nodec, stream)
constexpr int TILE = WARPS; // onedot: rows decoded per block, one per warp
constexpr int SMEM_STATIC_MAX = 48 * 1024;
constexpr int SMEM_MAX = 232448;  // a block's limit on sm_90

enum { PROD = 0, NODEC = 1, ONEDOT = 2, STREAM = 3 };

__device__ __forceinline__ float bf16_bits(uint32_t h) {
  return __uint_as_float(h << 16);   // bf16 -> f32 is exact
}

// 4 consecutive bf16 (8 bytes) as f32
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = bf16_bits(t.x & 0xFFFFu);
  v[1] = bf16_bits(t.x >> 16);
  v[2] = bf16_bits(t.y & 0xFFFFu);
  v[3] = bf16_bits(t.y >> 16);
}

// 8 consecutive bf16 (16 bytes) as f32
__device__ __forceinline__ void unpack8(uint4 t, float v[8]) {
  const uint32_t q[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = bf16_bits(q[k] & 0xFFFFu);
    v[2 * k + 1] = bf16_bits(q[k] >> 16);
  }
}

__device__ __forceinline__ float prod_plane(uint32_t w, int i) {
  const float off = -2.25f - 0.5f * (float)((w >> 24) & 1u);
  return (float)((w >> (3 * i)) & 7u) + off;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// prod and nodec: decode (or convert) in registers, 8 FMAs per word and row
template <int V, int MT>
__global__ void __launch_bounds__(WARPS * 32)
decode_matvec(const __nv_bfloat16* __restrict__ x,
              const uint32_t* __restrict__ w, __nv_bfloat16* __restrict__ out,
              int m, int N, int G) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * WARPS + warp) * ROWS;
  if (n0 >= N) return;
  const int r0 = blockIdx.y * MT;
  const size_t K = 8 * (size_t)G;
  float acc[ROWS][MT];
#pragma unroll
  for (int j = 0; j < ROWS; ++j)
#pragma unroll
    for (int r = 0; r < MT; ++r) acc[j][r] = 0.f;

  for (int g = lane * 4; g < G; g += 128) {
    uint32_t wq[ROWS][4];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int n = min(n0 + j, N - 1);   // ragged edge: re-read a row
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(
          w + (size_t)n * G + g));
      wq[j][0] = t.x; wq[j][1] = t.y; wq[j][2] = t.z; wq[j][3] = t.w;
    }
    float cv[ROWS][4];   // nodec: the word's one value, for every plane
    if (V == NODEC) {
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cv[j][e] = __bfloat162float(
              __float2bfloat16_rn(__int2float_rn((int)wq[j][e])));
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float pv[ROWS][4];   // plane i of the 4 x 4 words
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pv[j][e] = V == NODEC ? cv[j][e] : prod_plane(wq[j][e], i);
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        float xv[4] = {0.f, 0.f, 0.f, 0.f};
        if (r0 + r < m) load4(x + (size_t)(r0 + r) * K + (size_t)i * G + g, xv);
#pragma unroll
        for (int j = 0; j < ROWS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[j][r] = fmaf(xv[e], pv[j][e], acc[j][r]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < ROWS; ++j)
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      const float s = warp_sum(acc[j][r]);
      const int n = n0 + j, row = r0 + r;
      if (lane == j * MT + r && n < N && row < m)
        out[(size_t)row * N + n] = __float2bfloat16_rn(s);
    }
}

// onedot: decode TILE rows into shared memory as bf16, then one pass
template <int MT>
__global__ void __launch_bounds__(WARPS * 32)
onedot_matvec(const __nv_bfloat16* __restrict__ x,
              const uint32_t* __restrict__ w, __nv_bfloat16* __restrict__ out,
              int m, int N, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);  // [TILE][K]
  const int K = 8 * G;
  const int n0 = blockIdx.x * TILE;
  for (int t = threadIdx.x; t < TILE * G; t += WARPS * 32) {
    const int j = t / G, g = t - j * G;
    const uint32_t wd = __ldg(w + (size_t)min(n0 + j, N - 1) * G + g);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      tile[(size_t)j * K + i * G + g] = __float2bfloat16_rn(prod_plane(wd, i));
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = n0 + warp, r0 = blockIdx.y * MT;
  const __nv_bfloat16* wr = tile + (size_t)warp * K;
  float acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    float wv[8];
    unpack8(*reinterpret_cast<const uint4*>(wr + k), wv);
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      if (r0 + r >= m) continue;
      float xv[8];
      unpack8(__ldg(reinterpret_cast<const uint4*>(
                  x + (size_t)(r0 + r) * K + k)), xv);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r] = fmaf(xv[e], wv[e], acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    const float s = warp_sum(acc[r]);
    if (lane == r && n < N && r0 + r < m)
      out[(size_t)(r0 + r) * N + n] = __float2bfloat16_rn(s);
  }
}

// stream: every word read and summed as f32, one sum per row
__global__ void __launch_bounds__(WARPS * 32)
row_sums(const uint32_t* __restrict__ w, float* __restrict__ out, int N,
         int G) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * WARPS + warp) * ROWS;
  if (n0 >= N) return;
  float s[ROWS] = {0.f, 0.f, 0.f, 0.f};
  for (int g = lane * 4; g < G; g += 128) {
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int n = min(n0 + j, N - 1);
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(
          w + (size_t)n * G + g));
      s[j] += (__int2float_rn((int)t.x) + __int2float_rn((int)t.y)) +
              (__int2float_rn((int)t.z) + __int2float_rn((int)t.w));
    }
  }
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const float v = warp_sum(s[j]);
    if (lane == j && n0 + j < N) out[n0 + j] = v;
  }
}

template <int MT>
int launch_mt(int variant, const __nv_bfloat16* x, const uint32_t* w,
              __nv_bfloat16* out, int m, int N, int G, cudaStream_t s) {
  const dim3 grid((N + WARPS * ROWS - 1) / (WARPS * ROWS), (m + MT - 1) / MT);
  if (variant == PROD) {
    decode_matvec<PROD, MT><<<grid, WARPS * 32, 0, s>>>(x, w, out, m, N, G);
  } else if (variant == NODEC) {
    decode_matvec<NODEC, MT><<<grid, WARPS * 32, 0, s>>>(x, w, out, m, N, G);
  } else {
    const int smem = TILE * 8 * G * 2;
    if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
    if (smem > SMEM_STATIC_MAX) {
      const cudaError_t e = cudaFuncSetAttribute(
          onedot_matvec<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const dim3 g1((N + TILE - 1) / TILE, (m + MT - 1) / MT);
    onedot_matvec<MT><<<g1, WARPS * 32, smem, s>>>(x, w, out, m, N, G);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. variant: 0 prod, 1 nodec, 2
// onedot (x (m, 8G) bf16 -> out (m, N) bf16), 3 stream (x unused -> out
// (N,) f32). G must be a multiple of 4. Returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for what the kernel
// does not take (the Python wrapper checks first).
extern "C" int qfa_mb_kernel(int variant, const void* x, const void* w,
                             void* out, int m, int N, int G, void* stream) {
  if (N < 1 || G < 4 || G % 4 || variant < 0 || variant > STREAM ||
      (variant != STREAM && m < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* wp = static_cast<const uint32_t*>(w);
  if (variant == STREAM) {
    const int blocks = (N + WARPS * ROWS - 1) / (WARPS * ROWS);
    row_sums<<<blocks, WARPS * 32, 0, s>>>(wp, static_cast<float*>(out), N, G);
    return static_cast<int>(cudaGetLastError());
  }
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  if (m == 1) return launch_mt<1>(variant, xp, wp, op, m, N, G, s);
  if (m == 2) return launch_mt<2>(variant, xp, wp, op, m, N, G, s);
  if (m <= 4) return launch_mt<4>(variant, xp, wp, op, m, N, G, s);
  return launch_mt<8>(variant, xp, wp, op, m, N, G, s);
}
