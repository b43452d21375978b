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
// grid; here they are blocks that run at once, so a layer spreads over C
// times the units of work. x stays in the grouped layout (the Pallas
// caller's chunk-major re-order of x is a Mosaic layout workaround).
//
// Where the split runs (sm::split_pays: above 8 rows, and at m <= 8 only
// where K1's whole tiles leave a wave tail at most half full), two
// launches: the partials come from K1's body (nibble_mma_small.cuh, tensor
// cores, one pass over the planes for all m <= 32 rows of a block) with its
// split-K switch on, a unit of work being (channel tile, chunk), into an
// f32 workspace (C, m, q_out) that the wrapper allocates; then
// ksplit_reduce adds them in chunk order and runs the epilogue, launched
// as a programmatic dependent of the first kernel, whose blocks let it be
// scheduled as soon as they start. Elsewhere one launch of the same body
// over whole tiles: each warp's f32 sum walks the chunks' slabs in order
// and the warps meet at the tile's end, the same sum in another
// association, held to the twin at the same tolerance. Deterministic, and
// a call replays in a CUDA graph.
// What bounds it: device-memory bytes, as K1 (the workspace adds
// 2*C*m*q_out*4 bytes through L2, small at decode m).

#include "nibble_mma_small.cuh"

namespace {

template <typename T>
__global__ void ksplit_reduce(const float* __restrict__ ws,
                              const float* __restrict__ scale,
                              T* __restrict__ out, int m, int q_out,
                              int chunks) {
  // launched as a programmatic dependent of the partials' kernel: wait
  // until that grid has finished and its stores are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const size_t total = (size_t)m * q_out;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float v = ws[idx];
  for (int k = 1; k < chunks; ++k) v += ws[(size_t)k * total + idx];
  if (scale != nullptr) v *= scale[idx % q_out];
  tc::store1(out + idx, v);
}

// The split or the whole-tile launch for T and the codes C.
template <typename T, class C>
int run(const void* x, const typename C::Planes& p, const sm::Args& a,
        cudaStream_t s) {
  bool split = true;
  int err = sm::split_pays<T, C>(a, &split);
  if (err != 0) return err;
  if (!split) return sm::launch<T, C, 1, 1>(x, p, a, s);
  err = sm::launch_ks<T, C>(x, p, a, s);
  if (err != 0) return err;
  // the reduce may be scheduled while the partials' last blocks run (a
  // programmatic dependent launch), which hides its launch latency
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim =
      dim3(static_cast<unsigned>(((size_t)a.m * a.q_out + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.stream = s;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, ksplit_reduce<T>, static_cast<const float*>(a.ws),
      static_cast<const float*>(a.scale), static_cast<T*>(a.out), a.m,
      a.q_out, a.chunks);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. As qfa_fused_decode_matmul,
// with ws an f32 workspace of chunks*m*q_out elements and chunks >= 2
// dividing Gp into chunks of a multiple of 16 groups (whole slabs). One or
// two launches on the stream; returns cudaGetLastError() after them (0 on
// success), or cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int qfa_ksplit_decode_matmul(const void* x, const void* w0,
                                        const void* w1, const void* scale,
                                        void* ws, void* out, int m,
                                        int q_out, int Gp, int n_sets,
                                        float alpha0, float alpha1,
                                        float beta_total, int x_is_bf16,
                                        int chunks, void* stream) {
  if (m < 1 || q_out < 1 || chunks < 2 || Gp % chunks ||
      (Gp / chunks) % sm::SLAB || n_sets < 1 || n_sets > 2 ||
      (n_sets == 2 && w1 == nullptr) || ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const sm::Args a{scale, out, m, q_out, Gp, alpha0, alpha1, beta_total,
                   chunks, ws};
  const sm::NibbleCodes<1, 1>::Planes p1{static_cast<const uint32_t*>(w0),
                                         static_cast<const uint32_t*>(w1)};
  const sm::NibbleCodes<2, 1>::Planes p2{p1.w0, p1.w1};
  if (n_sets == 1)
    return x_is_bf16 ? run<__nv_bfloat16, sm::NibbleCodes<1, 1>>(x, p1, a, s)
                     : run<float, sm::NibbleCodes<1, 1>>(x, p1, a, s);
  return x_is_bf16 ? run<__nv_bfloat16, sm::NibbleCodes<2, 1>>(x, p2, a, s)
                   : run<float, sm::NibbleCodes<2, 1>>(x, p2, a, s);
}
