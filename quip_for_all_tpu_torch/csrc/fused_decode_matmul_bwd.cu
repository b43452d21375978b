// Backward decode + matmul of the fused nibble kernel for Hopper (sm_90a): K3.
//
// Replaces: quip_for_all_tpu/ops/dequant_pallas.py:_fused_core_bwd (:970),
// the custom VJP around K1/K2 (_fused_core, :954). There XLA decodes the
// dense weight W (ops/dequant_xla.py decode_weights) and runs dx = gg @ W;
// here the int32 word planes stream straight into the product and no dense
// W exists in device memory.
//
// For g (m, q_out) in the forward output's dtype, an optional f32 scale
// vector and 1 or 2 sets of nibble word planes (q_out, Gn):
//
//   gs[r, o]       = g[r, o] * scale[o]                         (f32)
//   W[o, 8c + i]   = (alpha0*nib0 + alpha1*nib1) + beta_total   (f32, the
//                    order of ops/dequant.py decode_positions: bit-equal)
//   dx[r, lane(c, i)] = sum_o gs[r, o] * W[o, 8c + i]   for c < G
//   dx[r, lane(c, i)] = 0                               for G <= c < Gp_out
//
// cast once to g's dtype, with the lane order of the forward's grouped x:
// i = (8/P)*j + q meets lane(c, i) = q*(P*Gp_out) + P*c + j (P = 1: lane
// i*Gp_out + c). Pad groups c >= G of the planes are never read. Gn (the
// planes' row stride) and Gp_out may differ: the u3 / paired layouts pad
// their own Gp to 256 groups, their nibble re-layout to 128.
//
// What bounds it on the card: operations. Each call does 2*m*q_out*8G
// flops and moves n_sets*q_out*Gn*4 plane bytes + m*q_out g + m*8*Gp_out dx
// bytes; at m = 1022 (a LoRA step of batch 2 x 512 on Llama-2-7B) that is
// ~270 flops per byte for a 4096x4096 layer, so the f32 FMAs of the CUDA
// cores (67 TFLOP/s data sheet) set the pace, not the 3.35 TB/s of memory.
//
// Design (simple first): one thread per group column c, so a warp reads 32
// consecutive words of a plane row (coalesced along c) and decodes each
// word's 8 nibbles once for TM rows of gs. A block is 128 columns x TM rows
// and loops over all q_out; every OC rows of gs (TM x OC floats, scaled on
// the way in) are staged in shared memory and read back as broadcasts. Each
// thread keeps 8*TM f32 accumulators. The grid is ceil(m/TM) x
// ceil(Gp_out/128) with the m-tile fastest, so the blocks in flight share
// one column slab of the planes in L2; at m = 1022, Gp = 512 that is 512
// blocks on 132 SMs. No atomics: every output is written once by one
// thread, so results are deterministic and a call replays in a CUDA graph.
// Nibbles become floats with the 2^23 magic (no int->float convert). Not
// done yet (a later PR): tensor cores (the products are bf16-exact only for
// bf16 g), a larger TM, cp.async staging of the planes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;   // group columns per block
constexpr int OC = 64;         // q_out rows of gs staged per step

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// nibble i of w as an exact float: 2^23 + nib holds nib in its low bits
__device__ __forceinline__ float nib_f(uint32_t w, int i) {
  return __uint_as_float(0x4B000000u | ((w >> (4 * i)) & 0xFu)) -
         8388608.0f;
}

template <typename T, int NSETS, int TM>
__global__ void __launch_bounds__(THREADS)
nibble_decode_matmul_bwd_kernel(const T* __restrict__ g,
                                const float* __restrict__ scale,
                                const uint32_t* __restrict__ w0,
                                const uint32_t* __restrict__ w1,
                                T* __restrict__ dx, int m, int q_out, int Gn,
                                int G, int Gp_out, int P, float alpha0,
                                float alpha1, float beta_total) {
  __shared__ __align__(16) float s_gs[OC][TM];
  const int r0 = blockIdx.x * TM;
  const int c = blockIdx.y * THREADS + threadIdx.x;
  const bool live = c < G;

  float acc[TM][8];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;

  for (int o0 = 0; o0 < q_out; o0 += OC) {
    const int on = min(OC, q_out - o0);
    __syncthreads();   // every thread is done with the previous chunk
    // stage gs: consecutive threads read consecutive o of one g row
    for (int t = threadIdx.x; t < OC * TM; t += THREADS) {
      const int oo = t % OC, r = t / OC;
      float v = 0.f;
      if (oo < on && r0 + r < m) {
        v = to_f32(g[(size_t)(r0 + r) * q_out + o0 + oo]);
        if (scale != nullptr) v *= scale[o0 + oo];
      }
      s_gs[oo][r] = v;
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int oo = 0; oo < on; ++oo) {
        const size_t off = (size_t)(o0 + oo) * Gn + c;
        const uint32_t a = __ldg(w0 + off);
        const uint32_t b = NSETS > 1 ? __ldg(w1 + off) : 0u;
        float gv[TM];
#pragma unroll
        for (int r = 0; r < TM; ++r) gv[r] = s_gs[oo][r];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float v = __fmul_rn(alpha0, nib_f(a, i));
          if (NSETS > 1) v = __fadd_rn(v, __fmul_rn(alpha1, nib_f(b, i)));
          v = __fadd_rn(v, beta_total);
#pragma unroll
          for (int r = 0; r < TM; ++r) acc[r][i] = fmaf(gv[r], v, acc[r][i]);
        }
      }
    }
  }

  if (c >= Gp_out) return;
  const int nq = 8 / P;
  const size_t K = 8 * (size_t)Gp_out;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int row = r0 + r;
    if (row >= m) break;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = i / nq, q = i % nq;
      const size_t lane = (size_t)q * P * Gp_out + (size_t)P * c + j;
      store(dx + row * K + lane, live ? acc[r][i] : 0.f);
    }
  }
}

struct BwdArgs {
  const void* g;
  const void* scale;
  const void* w0;
  const void* w1;
  void* dx;
  int m, q_out, Gn, G, Gp_out, P;
  float alpha0, alpha1, beta_total;
};

template <typename T, int NSETS, int TM>
void launch(const BwdArgs& a, cudaStream_t stream) {
  dim3 grid((a.m + TM - 1) / TM, (a.Gp_out + THREADS - 1) / THREADS);
  nibble_decode_matmul_bwd_kernel<T, NSETS, TM><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a.g), static_cast<const float*>(a.scale),
      static_cast<const uint32_t*>(a.w0), static_cast<const uint32_t*>(a.w1),
      static_cast<T*>(a.dx), a.m, a.q_out, a.Gn, a.G, a.Gp_out, a.P,
      a.alpha0, a.alpha1, a.beta_total);
}

template <typename T, int NSETS>
void launch_tm(const BwdArgs& a, cudaStream_t s) {
  if (a.m == 1)
    launch<T, NSETS, 1>(a, s);
  else if (a.m == 2)
    launch<T, NSETS, 2>(a, s);
  else if (a.m <= 4)
    launch<T, NSETS, 4>(a, s);
  else
    launch<T, NSETS, 8>(a, s);
}

}  // namespace

// Plain C entry point, loaded with ctypes. g and dx share one dtype
// (g_is_bf16 ? bfloat16 : float32); scale and w1 may be null; dx is
// (m, 8*Gp_out), every element written. Returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for shapes the kernel
// does not take (the Python wrapper checks them first).
extern "C" int qfa_fused_decode_matmul_bwd(const void* g, const void* scale,
                                           const void* w0, const void* w1,
                                           void* dx, int m, int q_out, int Gn,
                                           int G, int Gp_out, int P,
                                           int n_sets, float alpha0,
                                           float alpha1, float beta_total,
                                           int g_is_bf16, void* stream) {
  if (m < 1 || q_out < 1 || G < 1 || G > Gn || G > Gp_out ||
      (P != 1 && P != 2 && P != 4) || n_sets < 1 || n_sets > 2 ||
      (n_sets == 2 && w1 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{g, scale, w0, w1, dx, m, q_out, Gn, G, Gp_out, P,
                  alpha0, alpha1, beta_total};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_sets == 1 && g_is_bf16)
    launch_tm<__nv_bfloat16, 1>(a, s);
  else if (n_sets == 1)
    launch_tm<float, 1>(a, s);
  else if (g_is_bf16)
    launch_tm<__nv_bfloat16, 2>(a, s);
  else
    launch_tm<float, 2>(a, s);
  return static_cast<int>(cudaGetLastError());
}
