// T5's bitcast probe for Hopper (sm_90a): how an int32 word's two 16-bit
// halves land when the word is read as a pair of bf16 values
// (quip_for_all_tpu_torch/tools/microbench_bfp.py).
//
// Replaces: tools/microbench_bfp.py:discover_bitcast_order (:61), the
// pallas_call at :78, which asks how pltpu.bitcast spreads a word's halves
// over two bf16 sublanes. On the card the question is what a
// __nv_bfloat162 view of the word holds: each word (S, L) is read as one
// __nv_bfloat162 and its .x and .y are written to rows 2s and 2s + 1 of
// the (2S, L) bf16 output. The caller (discover_bitcast_order) classifies
// the result as the JAX tool does; the bfp layout's kernel
// (bfp_decode_matmul.cu) reads halves the same way.
//
// What bounds it: nothing that matters (a (8, 128) probe); one thread a
// word.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__global__ void bitcast_probe(const __nv_bfloat162* __restrict__ w,
                              __nv_bfloat16* __restrict__ out, int S, int L) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= S * L) return;
  const int s = t / L, l = t - s * L;
  const __nv_bfloat162 h = w[t];
  out[(size_t)(2 * s) * L + l] = h.x;
  out[(size_t)(2 * s + 1) * L + l] = h.y;
}

}  // namespace

// Plain C entry point, loaded with ctypes: w (S, L) int32 -> out (2S, L)
// bf16. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int qfa_mb_bfp_probe(const void* w, void* out, int S, int L,
                                void* stream) {
  if (S < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128, blocks = (S * L + threads - 1) / threads;
  bitcast_probe<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat162*>(w),
      static_cast<__nv_bfloat16*>(out), S, L);
  return static_cast<int>(cudaGetLastError());
}
