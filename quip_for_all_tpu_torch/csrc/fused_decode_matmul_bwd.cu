// Backward decode + matmul of the fused nibble kernel on Hopper's tensor
// cores (sm_90a): K3.
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
//   W[o, 8c + i]   = alpha0*nib0 + alpha1*nib1 + beta_total
//   dx[r, lane(c, i)] = sum_o gs[r, o] * W[o, 8c + i]   for c < G
//   dx[r, lane(c, i)] = 0                               for G <= c < Gp_out
//
// cast once to g's dtype, with the lane order of the forward's grouped x:
// i = (8/P)*j + q meets lane(c, i) = q*(P*Gp_out) + P*c + j (P = 1: lane
// i*Gp_out + c). Pad groups c >= G of the planes are never used. Gn (the
// planes' row stride) and Gp_out may differ: the u3 / paired layouts pad
// their own Gp to 256 groups, their nibble re-layout to 128.
//
// The order of operations is not the plain twin's, which decodes W in f32
// first (bit-equal to ops/dequant.py decode_positions) and multiplies:
// here dx = alpha0*(gs @ nib0) + alpha1*(gs @ nib1) + beta_total*rowsum(gs),
// each product over o on the tensor cores and the row sums in f32. The
// results differ by rounding only, within the stated tolerances (1e-5 of
// the max, plus one bf16 ulp for bf16 outputs).
//
// What bounds it on the card: operations. Each call does 2*m*q_out*8G
// flops and moves n_sets*q_out*Gn*4 plane bytes + m*q_out g + m*8*Gp_out dx
// bytes; at m = 1022 (a LoRA step of batch 2 x 512 on Llama-2-7B) that is
// ~270 flops a byte for a 4096x4096 layer, so the tensor cores' 989
// TFLOP/s (bf16) set the pace, not the 3.35 TB/s of memory. The SIMT
// kernel before this one decoded each word once for every 8 rows of g and
// ran f32 FMAs on the CUDA cores (67 TFLOP/s): 1.8% of the bf16 bound.
//
// Design (what it does about that; the building blocks are in
// nibble_mma.cuh, shared with K2): a block computes 128 rows of g (64 with
// two plane sets or a split gs) by 16 group columns (128 dx lanes) and
// walks q_out in slabs of 128 (the slab shape K2 uses, so both kernels
// share one decode and one MMA body).
//   - g's slab and each plane set's 128 x 16 word slab stream by cp.async
//     in three stages (two where a split gs and two plane sets leave no
//     room).
//   - Each word is decoded once per block into bf16 nibbles in shared
//     memory, row o and column 16*i + cc (nibble i of group c0 + cc), read
//     back with ldmatrix .trans as the B operand.
//   - Products run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//     accumulate), one accumulator per plane set, flushed into f32 sums
//     after every slab. bf16 g with no scale (the training path) is exact
//     in bf16 and takes one MMA; f32 g, or g * scale, is split on staging
//     into three bf16 terms (exact) and takes three.
//   - The beta term is each row's sum of gs, taken while gs is staged.
// Every output is written once by one thread, with no atomics, so results
// are deterministic and a call replays in a CUDA graph. The grid is
// ceil(m/BM) x ceil(Gp_out/16) with the m tile fastest, so the blocks in
// flight share one column slab of the planes in L2; blocks of pad groups
// only (c0 >= G) write their zeros and skip the products. Not done yet (a
// later PR): wgmma and TMA, a split of q_out across blocks at small m, the
// decode overlapped with the MMAs.

#include "nibble_mma.cuh"

namespace {

template <typename T, int NSETS, bool SPLIT>
__global__ void __launch_bounds__(tc::THREADS, 1)
nibble_mma_bwd_kernel(const T* __restrict__ g,
                      const float* __restrict__ scale,
                      const uint32_t* __restrict__ w0,
                      const uint32_t* __restrict__ w1, T* __restrict__ dx,
                      int m, int q_out, int Gn, int G, int Gp_out, int P,
                      float alpha0, float alpha1, float beta_total) {
  using namespace tc;
  using C = TileCfg<T, NSETS, SPLIT>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* raw = reinterpret_cast<T*>(smem);
  __nv_bfloat16* terms = reinterpret_cast<__nv_bfloat16*>(smem + C::OFF_TERMS);
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + C::OFF_WORDS);
  __nv_bfloat16* dec = reinterpret_cast<__nv_bfloat16*>(smem + C::OFF_DEC);
  float* rs = reinterpret_cast<float*>(smem + C::OFF_RS);

  const int m0 = blockIdx.x * C::BM, c0 = blockIdx.y * 16;
  const int slabs = c0 < G ? (q_out + BK - 1) / BK : 0;
  constexpr int EPC = 16 / (int)sizeof(T);   // values a 16-byte copy
  // 16-byte copies where rows and pointers allow, else value by value
  const bool vec_g = q_out % EPC == 0 && aligned16(g);
  const bool vec_w =
      Gn % 4 == 0 && aligned16(w0) && (NSETS == 1 || aligned16(w1));

  // stage slab s (o = 128s .. 128s+127) into buffer buf
  auto load = [&](int s, int buf) {
    constexpr int CPR = BK / EPC;
    const int o0 = BK * s;
    T* a = raw + buf * C::BM * C::RAW;
    for (int t = threadIdx.x; t < C::BM * CPR; t += THREADS) {
      const int r = t / CPR, e0 = (t % CPR) * EPC, row = m0 + r,
                o = o0 + e0;
      T* d = a + r * C::RAW + e0;
      const T* src = g + (size_t)row * q_out + o;
      if (vec_g) {
        const bool ok = row < m && o < q_out;
        cp_async16(d, ok ? src : g, ok);
      } else {
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          d[e] = (row < m && o + e < q_out) ? src[e] : zero_val<T>();
      }
    }
    load_words(words + buf * NSETS * WROWS * WSTRIDE, w0, o0, q_out, Gn, c0,
               Gn, vec_w);
    if (NSETS > 1)
      load_words(words + (buf * NSETS + 1) * WROWS * WSTRIDE, w1, o0, q_out,
                 Gn, c0, Gn, vec_w);
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
    if (SPLIT) stage_a<C>(a, terms, part, scale, BK * s, q_out);
    __syncthreads();   // dec (and the terms) are ready
    if (!SPLIT) stage_a<C>(a, terms, part, nullptr, 0, 0);
    mma_slab<C, NSETS, true>(
        acc, SPLIT ? terms : reinterpret_cast<const __nv_bfloat16*>(a), dec);
    flush<C, NSETS>(tot, acc);
  }
  finish_rowsums<C>(part, rs);
  __syncthreads();

  // epilogue: thread (lane/4, lane%4) holds rows lane/4 (+8) of each m16
  // tile and columns 2*(lane%4) (+1) of each n8 tile; column n of the block
  // is nibble i = n/16 of group c0 + n%16
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3, nq = 8 / P;
  const size_t Kd = 8 * (size_t)Gp_out;
  const bool pairs = P == 1 && (Gp_out & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wm * C::MT * 16 + mt * 16 + (lane >> 2) + 8 * h;
      const int row = m0 + rl;
      if (row >= m) continue;
      const float bsum = beta_total * rs[rl];
      T* drow = dx + (size_t)row * Kd;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wn * 32 + nt * 8 + 2 * (lane & 3);
        const int i = n >> 4, c = c0 + (n & 15);
        if (c >= Gp_out) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float t = tot[0][mt][nt][2 * h + e] * alpha0;
          if (NSETS > 1) t += tot[NSETS - 1][mt][nt][2 * h + e] * alpha1;
          v[e] = c + e < G ? t + bsum : 0.f;
        }
        if (pairs) {   // c even, so c + 1 < Gp_out too
          store2(drow + (size_t)i * Gp_out + c, v[0], v[1]);
        } else {
          const int j = i / nq, q = i % nq;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (c + e < Gp_out)
              store1(drow + (size_t)q * P * Gp_out + (size_t)P * (c + e) + j,
                     v[e]);
        }
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

template <typename T, int NSETS, bool SPLIT>
int launch(const BwdArgs& a, cudaStream_t stream) {
  using C = tc::TileCfg<T, NSETS, SPLIT>;
  static bool smem_set = false;   // once per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        nibble_mma_bwd_kernel<T, NSETS, SPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const dim3 grid((a.m + C::BM - 1) / C::BM, (a.Gp_out + 15) / 16);
  nibble_mma_bwd_kernel<T, NSETS, SPLIT>
      <<<grid, tc::THREADS, C::SMEM, stream>>>(
          static_cast<const T*>(a.g), static_cast<const float*>(a.scale),
          static_cast<const uint32_t*>(a.w0),
          static_cast<const uint32_t*>(a.w1), static_cast<T*>(a.dx), a.m,
          a.q_out, a.Gn, a.G, a.Gp_out, a.P, a.alpha0, a.alpha1,
          a.beta_total);
  return static_cast<int>(cudaGetLastError());
}

template <int NSETS>
int dispatch(const BwdArgs& a, int g_is_bf16, cudaStream_t s) {
  if (!g_is_bf16) return launch<float, NSETS, true>(a, s);
  if (a.scale != nullptr) return launch<__nv_bfloat16, NSETS, true>(a, s);
  return launch<__nv_bfloat16, NSETS, false>(a, s);
}

}  // namespace

// Plain C entry point, loaded with ctypes. g and dx share one dtype
// (g_is_bf16 ? bfloat16 : float32); scale and w1 may be null; dx is
// (m, 8*Gp_out), every element written, and 8-byte aligned. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for shapes the kernel does not take (the Python
// wrapper checks them first).
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
  return n_sets == 1 ? dispatch<1>(a, g_is_bf16, s)
                     : dispatch<2>(a, g_is_bf16, s);
}
