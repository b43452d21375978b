// Fused affine-nibble decode + matmul on Hopper's tensor cores (sm_90a): K2.
//
// Replaces: quip_for_all_tpu/ops/dequant_pallas.py:_make_kernel (split=1,
// nibble layout) through _fused_call's 2-D m-tiled grid (pallas_call at
// :888, TM = min(m, 32) at :852): the calls whose rows, padded to 8, exceed
// 32. Below that K1 (fused_decode_matmul.cu) runs, as the 1-D grid does.
//
// Computes K1's function for x_perm (m, 8*Gp) in the grouped lane order
// x_perm[r, i*Gp + c] = x[r, 8c + i] and 1 or 2 sets of int32 nibble word
// planes (q_out, Gp):
//
//   out[r, n] = (sum_s alpha_s * (x_perm @ nib_s^T)[r, n]
//                + beta_total * rowsum(x_perm[r])) * scale[n]
//
// cast to x's dtype (no scale when none is given).
//
// What bounds it on the card: operations. A training forward of Llama-2-7B
// at 1022 rows does 2 * 1022 * 6.6e9 multiply-adds against 3.3 GB of
// planes (~4000 flops a plane byte), so even the bf16 tensor-core peak
// (989 TFLOP/s, ~13.7 ms a forward) is far above the byte bound. The SIMT
// kernel decoded every nibble once for each 8 rows, kept an 8-row f32
// accumulator at the 255-register limit (it spilled) and ran f32 FMAs on
// the CUDA cores (67 TFLOP/s): 1-3% of the bound.
//
// Design (what it does about that; the building blocks are in
// nibble_mma.cuh): a block computes 128 rows of x (64 with two plane sets
// or f32 x) by 128 output channels and walks the groups in slabs of 16
// (128 k values: x_perm[r, i*Gp + c0 .. c0+15] for the 8 nibbles i).
//   - Both operands stream by cp.async in three stages (two with f32 x and
//     two plane sets): the x slab as 8 runs of 16 values a row, the planes
//     as 128 rows x 16 words a set.
//   - Each word is decoded once per block (not once per 8 rows) into bf16
//     nibbles in shared memory, in the slab's k order, so the decode is
//     shared by all 128 (or 64) rows.
//   - Products run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//     accumulate): bf16 x and nibbles are exact; f32 x is split into three
//     bf16 terms on staging. One accumulator per plane set, flushed into
//     f32 sums after every slab.
//   - The row sums (beta) are taken while the x slab is staged; alpha,
//     beta and the scale are applied in the epilogue.
// Ragged m and q_out are masked (zero fill on load, no store). Gp needs to
// be a multiple of 4 (plane rows are padded to 128 groups); when it is not
// a multiple of 16 the x slab is staged value by value. The grid is
// ceil(m/BM) x ceil(q_out/128) with the m tile fastest, so the blocks in
// flight share one column slab of the planes in L2. Not done yet (a later
// PR): wgmma and TMA, a persistent grid, decode overlapped with the MMAs.

#include "nibble_mma.cuh"

namespace {

template <typename T, int NSETS>
__global__ void __launch_bounds__(tc::THREADS, 1)
nibble_mma_fwd_kernel(const T* __restrict__ x,
                      const uint32_t* __restrict__ w0,
                      const uint32_t* __restrict__ w1,
                      const float* __restrict__ scale, T* __restrict__ out,
                      int m, int q_out, int Gp, float alpha0, float alpha1,
                      float beta_total) {
  using namespace tc;
  constexpr bool SPLIT = sizeof(T) == 4;
  using C = TileCfg<T, NSETS, SPLIT>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* raw = reinterpret_cast<T*>(smem);
  __nv_bfloat16* terms = reinterpret_cast<__nv_bfloat16*>(smem + C::OFF_TERMS);
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + C::OFF_WORDS);
  __nv_bfloat16* dec = reinterpret_cast<__nv_bfloat16*>(smem + C::OFF_DEC);
  float* rs = reinterpret_cast<float*>(smem + C::OFF_RS);

  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * BN;
  const size_t K = 8 * (size_t)Gp;
  const int slabs = (Gp + 15) / 16;
  const bool vec = Gp % 16 == 0;

  // stage slab s (groups 16s .. 16s+15) into buffer buf
  auto load = [&](int s, int buf) {
    constexpr int EPC = 16 / (int)sizeof(T);   // values a 16-byte copy
    constexpr int CPR = BK / EPC, CPRUN = 16 / EPC;
    const int c0 = 16 * s;
    T* a = raw + buf * C::BM * C::RAW;
    for (int t = threadIdx.x; t < C::BM * CPR; t += THREADS) {
      const int r = t / CPR, q = t % CPR, i = q / CPRUN;
      const int e0 = (q % CPRUN) * EPC, row = m0 + r, c = c0 + e0;
      T* d = a + r * C::RAW + 16 * i + e0;
      const T* src = x + (size_t)row * K + (size_t)i * Gp + c;
      if (vec) {
        cp_async16(d, row < m ? src : x, row < m);
      } else {
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          d[e] = (row < m && c + e < Gp) ? src[e] : zero_val<T>();
      }
    }
    load_words(words + buf * NSETS * WROWS * WSTRIDE, w0, n0, q_out, Gp, c0,
               Gp, true);
    if (NSETS > 1)
      load_words(words + (buf * NSETS + 1) * WROWS * WSTRIDE, w1, n0, q_out,
                 Gp, c0, Gp, true);
    cp_async_commit();
  };

  float acc[NSETS][C::MT][4][4], tot[NSETS][C::MT][4][4];
  float part[C::RQ];
#pragma unroll
  for (int s = 0; s < NSETS; ++s)
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[s][mt][nt][e] = 0.f;
#pragma unroll
  for (int q = 0; q < C::RQ; ++q) part[q] = 0.f;

  for (int st = 0; st + 1 < C::STAGES; ++st) {   // the first slabs
    if (st < slabs)
      load(st, st);
    else
      cp_async_commit();   // an empty group keeps the group count
  }
  for (int s = 0; s < slabs; ++s) {
    const int buf = s % C::STAGES;
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();   // slab s landed; slab s-1's readers are done
    const int next = s + C::STAGES - 1;   // into slab s-1's buffer
    if (next < slabs)
      load(next, next % C::STAGES);
    else
      cp_async_commit();
    const T* a = raw + buf * C::BM * C::RAW;
    decode_slab<NSETS>(words + buf * NSETS * WROWS * WSTRIDE, dec);
    if (SPLIT) stage_a<C>(a, terms, part, nullptr, 0, 0);
    __syncthreads();   // dec (and the terms) are ready
    if (!SPLIT) stage_a<C>(a, terms, part, nullptr, 0, 0);
    mma_slab<C, NSETS, false>(
        acc, SPLIT ? terms : reinterpret_cast<const __nv_bfloat16*>(a), dec);
    flush<C, NSETS>(tot, acc);
  }
  finish_rowsums<C>(part, rs);
  __syncthreads();

  // epilogue: thread (g = lane/4, t = lane%4) holds rows g, g+8 of each
  // m16 tile and columns 2t, 2t+1 of each n8 tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const bool pairs = (q_out & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wm * C::MT * 16 + mt * 16 + (lane >> 2) + 8 * h;
      const int row = m0 + rl;
      if (row >= m) continue;
      const float bsum = beta_total * rs[rl];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + 2 * (lane & 3);
        if (col >= q_out) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float t = tot[0][mt][nt][2 * h + e] * alpha0;
          if (NSETS > 1) t += tot[NSETS - 1][mt][nt][2 * h + e] * alpha1;
          v[e] = t + bsum;
        }
        if (scale != nullptr) {
          v[0] *= scale[col];
          if (col + 1 < q_out) v[1] *= scale[col + 1];
        }
        T* o = out + (size_t)row * q_out + col;
        if (pairs) {
          store2(o, v[0], v[1]);
        } else {
          store1(o, v[0]);
          if (col + 1 < q_out) store1(o + 1, v[1]);
        }
      }
    }
}

template <typename T, int NSETS>
int launch(const void* x, const void* w0, const void* w1, const void* scale,
           void* out, int m, int q_out, int Gp, float alpha0, float alpha1,
           float beta_total, cudaStream_t stream) {
  using C = tc::TileCfg<T, NSETS, sizeof(T) == 4>;
  static bool smem_set = false;   // once per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        nibble_mma_fwd_kernel<T, NSETS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const dim3 grid((m + C::BM - 1) / C::BM, (q_out + tc::BN - 1) / tc::BN);
  nibble_mma_fwd_kernel<T, NSETS><<<grid, tc::THREADS, C::SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(w0),
      static_cast<const uint32_t*>(w1), static_cast<const float*>(scale),
      static_cast<T*>(out), m, q_out, Gp, alpha0, alpha1, beta_total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes; the arguments of
// qfa_fused_decode_matmul (fused_decode_matmul.cu). x and out share one
// dtype (x_is_bf16 ? bfloat16 : float32); w1 and scale may be null; m is
// the number of rows of x to compute (x's row stride is 8*Gp); x, the
// planes and out are 16-byte aligned. Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for shapes the kernel
// does not take (the Python wrapper checks them first).
extern "C" int qfa_fused_decode_matmul_tc(const void* x, const void* w0,
                                          const void* w1, const void* scale,
                                          void* out, int m, int q_out, int Gp,
                                          int n_sets, float alpha0,
                                          float alpha1, float beta_total,
                                          int x_is_bf16, void* stream) {
  if (m < 1 || q_out < 1 || Gp < 4 || Gp % 4 || n_sets < 1 || n_sets > 2 ||
      (n_sets == 2 && w1 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_sets == 1 && x_is_bf16)
    return launch<__nv_bfloat16, 1>(x, w0, w1, scale, out, m, q_out, Gp,
                                    alpha0, alpha1, beta_total, s);
  if (n_sets == 1)
    return launch<float, 1>(x, w0, w1, scale, out, m, q_out, Gp, alpha0,
                            alpha1, beta_total, s);
  if (x_is_bf16)
    return launch<__nv_bfloat16, 2>(x, w0, w1, scale, out, m, q_out, Gp,
                                    alpha0, alpha1, beta_total, s);
  return launch<float, 2>(x, w0, w1, scale, out, m, q_out, Gp, alpha0,
                          alpha1, beta_total, s);
}
