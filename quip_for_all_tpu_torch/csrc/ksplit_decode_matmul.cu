// Split-K affine-nibble decode + matmul for Hopper (sm_90a): K6.
//
// Replaces: quip_for_all_tpu/ops/dequant_pallas.py:_make_kernel_ksplit
// (:633, launched at :799 under QFA_KSPLIT, nibble layout, m <= 32).
//
// The group axis splits into C chunks of Gc = Gp/C groups. Chunk k's
// partial is sum_s alpha_s * sum_i x[:, i*Gp + k*Gc : ...] . nib_s +
// beta_total * rowsum(chunk k of x), as the Pallas body's per-chunk
// `part`; the partials are added in f32 in chunk order and the epilogue
// (scale, cast) runs once, as the Pallas scratch accumulates them over
// its inner grid axis. On the TPU the chunks are steps of a sequential
// grid; here they are blocks that run at once (gridDim.z = C), so a
// 4096-row layer at m = 1 spreads over C times the blocks. The partials
// go to an f32 workspace (C, m, q_out) that the wrapper allocates, and a
// second kernel reduces them in chunk order: deterministic, no atomics,
// and a call replays in a CUDA graph. x stays in the grouped layout (the
// Pallas caller's chunk-major re-order of x is a Mosaic layout
// workaround). The partial kernel's body, bound and design:
// nibble_decode.cuh; the reduce reads C*m*q_out*4 bytes more, small at
// decode m.

#include "nibble_decode.cuh"

namespace {

template <typename T>
__global__ void ksplit_reduce_kernel(const float* __restrict__ ws,
                                     const float* __restrict__ scale,
                                     T* __restrict__ out, int m, int q_out,
                                     int chunks) {
  const size_t total = (size_t)m * q_out;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float v = ws[idx];
  for (int k = 1; k < chunks; ++k) v += ws[(size_t)k * total + idx];
  if (scale != nullptr) v *= scale[idx % q_out];
  store(out + idx, v);
}

}  // namespace

// Plain C entry point, loaded with ctypes. As qfa_fused_decode_matmul,
// with ws an f32 workspace of chunks*m*q_out elements and chunks >= 2
// dividing Gp into chunks of a multiple of 4 groups. Two launches on the
// stream; returns cudaGetLastError() after them (0 on success).
extern "C" int qfa_ksplit_decode_matmul(const void* x, const void* w0,
                                        const void* w1, const void* scale,
                                        void* ws, void* out, int m,
                                        int q_out, int Gp, int n_sets,
                                        float alpha0, float alpha1,
                                        float beta_total, int x_is_bf16,
                                        int chunks, void* stream) {
  if (chunks < 2) return static_cast<int>(cudaErrorInvalidValue);
  const NibbleArgs a{x, w0, w1, scale, out, static_cast<float*>(ws), m,
                     q_out, Gp, chunks, alpha0, alpha1, beta_total};
  const int err = dispatch<1, true>(a, n_sets, x_is_bf16, stream);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t total = (size_t)m * q_out;
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  if (x_is_bf16)
    ksplit_reduce_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(ws), static_cast<const float*>(scale),
        static_cast<__nv_bfloat16*>(out), m, q_out, chunks);
  else
    ksplit_reduce_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(ws), static_cast<const float*>(scale),
        static_cast<float*>(out), m, q_out, chunks);
  return static_cast<int>(cudaGetLastError());
}
