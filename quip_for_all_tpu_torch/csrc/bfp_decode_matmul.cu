// Fused bfp-layout decode + matmul for Hopper (sm_90a): K10.
//
// Replaces: quip_for_all_tpu/ops/dequant_pallas.py:_make_kernel_bfp
// (:281, the bfp runtime layout, QFA_BFP there) through both of
// _fused_call's grids (:868, :888). One kernel takes any m.
//
// The bfp planes hold the nibble words of an output-row PAIR:
// w3[half][t, g] (2, q_out/2, Gp) carries nibble positions 4*half..+3 of
// row 2t in its low 16 bits and of row 2t+1 in its high 16 bits. For
// k = 0..3,
//
//   f = ((w >> 4k) & 0x000F000F) | 0x43004300
//
// holds two bf16 values, 128 + nibble (4*half + k) of rows 2t (low) and
// 2t+1 (high), exactly. The f32 value of a bf16 is its bits shifted up by
// 16, so each nibble becomes a float with a shift or a mask and one exact
// subtract of 128 -- no int->float convert instruction, which is what the
// layout is for (the K1 kernel converts every nibble with an I2F). The
// 128 is removed per element: folding it into the rowsum term is not the
// same function (dequant_pallas.py:295-299). The math is then K1's:
//
//   out[r, n] = (sum_s alpha_s * sum_{g,i} x_perm[r, i*Gp + g] * nib_s
//                + beta_total * rowsum(x_perm[r])) * scale[n]
//
// cast to x's dtype, with x_perm in the grouped layout x_perm[r, i*Gp+g] =
// x[r, 8g + i]. Every product is exact in f32; each lane visits its words
// and positions in K1's order, so the sums differ from the plain twin
// only by f32 summation order.
//
// What bounds it on the card: device-memory bytes, exactly K1's (the same
// words in another order; 3.32 GB per Llama-2-7B token, ~0.99 ms at
// 3.35 TB/s, reckoned from shapes). Design: nibble_decode.cuh's, with row
// pairs: a warp owns 2 row pairs (1 with the 8-row accumulator), each
// lane loads 4 consecutive words (uint4) of both position halves of each
// pair per step, so one 32-bit word feeds two output rows.

#include "nibble_decode.cuh"

namespace {

template <int MT>
__host__ __device__ constexpr int bfp_pairs_per_warp() {
  return rows_per_warp<MT>() / 2;
}

template <typename T, int NSETS, int MT>
__global__ void __launch_bounds__(WARPS * 32)
bfp_decode_matmul_kernel(const T* __restrict__ x,
                         const uint32_t* __restrict__ w0,
                         const uint32_t* __restrict__ w1,
                         const float* __restrict__ scale,
                         T* __restrict__ out, int m, int q_out, int Gp,
                         float alpha0, float alpha1, float beta_total) {
  constexpr int PAIRS = bfp_pairs_per_warp<MT>();
  constexpr int ROWS = 2 * PAIRS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int half = q_out >> 1;                       // row pairs
  const int rp0 = (blockIdx.x * WARPS + warp) * PAIRS;
  if (rp0 >= half) return;  // the whole warp leaves together; no block sync
  const int r0 = blockIdx.y * MT;
  const size_t K = 8 * (size_t)Gp;
  const size_t hstride = (size_t)half * Gp;          // positions 4..7

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
    uint4 wv[NSETS][PAIRS][2];
#pragma unroll
    for (int pr = 0; pr < PAIRS; ++pr) {
      const size_t rp = min(rp0 + pr, half - 1);  // ragged edge: re-read
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const size_t off = hf * hstride + rp * Gp + g;
        wv[0][pr][hf] = __ldg(reinterpret_cast<const uint4*>(w0 + off));
        if (NSETS > 1)
          wv[NSETS - 1][pr][hf] =
              __ldg(reinterpret_cast<const uint4*>(w1 + off));
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * hf + k;                    // nibble position
        float xv[MT][4];
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          if (r0 + r < m) {
            load4(x + (size_t)(r0 + r) * K + (size_t)i * Gp + g, xv[r]);
          } else {
            xv[r][0] = xv[r][1] = xv[r][2] = xv[r][3] = 0.f;
          }
          xs[r] += (xv[r][0] + xv[r][1]) + (xv[r][2] + xv[r][3]);
        }
#pragma unroll
        for (int s = 0; s < NSETS; ++s)
#pragma unroll
          for (int pr = 0; pr < PAIRS; ++pr) {
            const uint4 w = wv[s][pr][hf];
            const uint32_t wq[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const uint32_t f = ((wq[e] >> (4 * k)) & 0x000F000Fu) |
                                 0x43004300u;
              const float lo = __uint_as_float(f << 16) - 128.f;
              const float hi = __uint_as_float(f & 0xFFFF0000u) - 128.f;
#pragma unroll
              for (int r = 0; r < MT; ++r) {
                acc[s][2 * pr][r] = fmaf(xv[r][e], lo, acc[s][2 * pr][r]);
                acc[s][2 * pr + 1][r] =
                    fmaf(xv[r][e], hi, acc[s][2 * pr + 1][r]);
              }
            }
          }
      }
    }
  }

  // warp reduction: afterwards every lane holds the full sums
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      xs[r] += __shfl_xor_sync(0xffffffffu, xs[r], off);
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
#pragma unroll
        for (int s = 0; s < NSETS; ++s)
          acc[s][j][r] += __shfl_xor_sync(0xffffffffu, acc[s][j][r], off);
    }
  }

  // epilogue: lane (j*MT + r) writes out[r0 + r, 2*rp0 + j]
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      const int n = 2 * rp0 + j, row = r0 + r;
      if (lane == j * MT + r && n < q_out && row < m) {
        float v = acc[0][j][r] * alpha0;
        if (NSETS > 1) v += acc[NSETS - 1][j][r] * alpha1;
        v += beta_total * xs[r];
        if (scale != nullptr) v *= scale[n];
        store(out + (size_t)row * q_out + n, v);
      }
    }
  }
}

template <typename T, int NSETS, int MT>
void launch_bfp(const NibbleArgs& a, cudaStream_t stream) {
  const int pairs_per_block = WARPS * bfp_pairs_per_warp<MT>();
  dim3 grid((a.q_out / 2 + pairs_per_block - 1) / pairs_per_block,
            (a.m + MT - 1) / MT);
  bfp_decode_matmul_kernel<T, NSETS, MT><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const uint32_t*>(a.w0),
      static_cast<const uint32_t*>(a.w1), static_cast<const float*>(a.scale),
      static_cast<T*>(a.out), a.m, a.q_out, a.Gp, a.alpha0, a.alpha1,
      a.beta_total);
}

template <typename T, int NSETS>
void launch_bfp_mt(const NibbleArgs& a, cudaStream_t s) {
  if (a.m == 1)
    launch_bfp<T, NSETS, 1>(a, s);
  else if (a.m == 2)
    launch_bfp<T, NSETS, 2>(a, s);
  else if (a.m <= 4)
    launch_bfp<T, NSETS, 4>(a, s);
  else
    launch_bfp<T, NSETS, 8>(a, s);
}

}  // namespace

// Plain C entry point, loaded with ctypes. x and out share one dtype
// (x_is_bf16 ? bfloat16 : float32); w0 (and w1, or null) are bfp planes
// (2, q_out/2, Gp); scale may be null; m is the number of rows of x to
// compute (x's row stride is 8*Gp). Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for shapes the kernel
// does not take (q_out odd, Gp not a multiple of 4).
extern "C" int qfa_bfp_decode_matmul(const void* x, const void* w0,
                                     const void* w1, const void* scale,
                                     void* out, int m, int q_out, int Gp,
                                     int n_sets, float alpha0, float alpha1,
                                     float beta_total, int x_is_bf16,
                                     void* stream) {
  if (m < 1 || q_out < 2 || q_out % 2 || Gp < 4 || Gp % 4 || n_sets < 1 ||
      n_sets > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const NibbleArgs a{x, w0, w1, scale, out, m, q_out, Gp, alpha0, alpha1,
                     beta_total};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_sets == 1 && x_is_bf16)
    launch_bfp_mt<__nv_bfloat16, 1>(a, s);
  else if (n_sets == 1)
    launch_bfp_mt<float, 1>(a, s);
  else if (x_is_bf16)
    launch_bfp_mt<__nv_bfloat16, 2>(a, s);
  else
    launch_bfp_mt<float, 2>(a, s);
  return static_cast<int>(cudaGetLastError());
}
