// Fused bfp-layout decode + matmul for Hopper (sm_90a): K10.
//
// Replaces: quip_for_all_tpu/ops/dequant_pallas.py:_make_kernel_bfp
// (:281, the bfp runtime layout, QFA_BFP there) through both of
// _fused_call's grids (:868, :888): a block takes up to 32 rows of x and
// gridDim.y walks further tiles of 32, so every m takes this body.
//
// The bfp planes hold the nibble words of an output-row PAIR:
// w3[half][t, g] (2, q_out/2, Gp) carries nibble positions 4*half..+3 of
// row 2t in its low 16 bits and of row 2t+1 in its high 16 bits. For
// k = 0..3,
//
//   f = ((w >> 4k) & 0x000F000F) | 0x43004300
//
// holds two bf16 values, 128 + nibble (4*half + k) of rows 2t (low) and
// 2t+1 (high), exactly: no int->float convert, which is what the layout
// is for. The 128 is removed per element (folding it into the rowsum term
// is not the same function, dequant_pallas.py:295-299). The math is then
// K1's:
//
//   out[r, n] = (sum_s alpha_s * sum_{g,i} x_perm[r, i*Gp + g] * nib_s
//                + beta_total * rowsum(x_perm[r])) * scale[n]
//
// cast to x's dtype, with x_perm in the grouped layout x_perm[r, i*Gp+g] =
// x[r, 8g + i]. Every product is exact in f32, so the result differs from
// the plain twin (ops/layout_matmul.py) only by f32 summation order.
//
// What bounds it on the card: device-memory bytes, exactly K1's (the same
// words in another order; 3.32 GB per Llama-2-7B token, ~0.99 ms at
// 3.35 TB/s, reckoned from shapes), at m = 1 and at m = 32 alike.
//
// Design: K1's tensor-core body (nibble_mma_small.cuh: x staged by
// cp.async, one pass over the planes for all m <= 32 rows of a block,
// mma.sync m16n8k16 with the decoded words as A) with the codes policy
// BfpCodes. The words are K1's, re-laid, so K1's k order holds: A
// register rho = 2i + p of lane (g, t) pairs the lane's words 2p and
// 2p + 1 (groups 4t + 2p, 4t + 2p + 1 of the slab) at position i. In K1
// they are two words of one channel; here a row-pair word holds position
// i of both channels of its pair, so one byte permute of the two words
// takes the low halves (0x5410: channel 2t) or the high ones (0x7632:
// channel 2t + 1), then K1's shift, mask, OR and bf16 subtract of 128.
// A lane's two uint4 of an m16 tile are the two half planes of its row
// pair (positions 0-3 and 4-7), where K1 loads rows g and g + 8; A row g
// is channel 2g and row g + 8 channel 2g + 1 (PAIR_ROWS, as pb's), and the
// store undoes the map. A bfp A register costs what K1's does.

#include "nibble_mma_small.cuh"

namespace {
namespace sm {

// (0x4300 | nibble) pairs of the halves sel picks of words a and b at
// position s/4 of their half plane, minus 128: the A register
__device__ __forceinline__ uint32_t bfp_reg(uint32_t a, uint32_t b,
                                            uint32_t sel, int s) {
  return unbias(((__byte_perm(a, b, sel) >> s) & 0x000F000Fu) | 0x43004300u);
}

// K1's codes on bfp planes (2, q_out/2, Gp): a lane's words of an m16 tile
// are w[mt][2*st + h], half plane h of row pair n0/2 + 8*mt + g.
template <int NSETS_>
struct BfpCodes : NibbleCodes<NSETS_, 1> {
  using Base = NibbleCodes<NSETS_, 1>;
  static constexpr int NSETS = NSETS_, NW = Base::NW;
  static constexpr bool PAIR_ROWS = true;
  template <int MTW>
  __device__ static void load(uint4 (&w)[MTW][NW],
                              const typename Base::Planes& pl, int n0, int g,
                              int c, const typename Base::Walk&, int q_out,
                              int Gp, bool ok) {
    const int pairs = q_out >> 1;
#pragma unroll
    for (int st = 0; st < NSETS; ++st)
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt) {
        const size_t rp = min(n0 / 2 + mt * 8 + g, pairs - 1);
        const uint32_t* p = st == 0 ? pl.w0 : pl.w1;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          w[mt][2 * st + h] =
              ok ? __ldg(reinterpret_cast<const uint4*>(
                       p + ((size_t)h * pairs + rp) * Gp + c))
                 : make_uint4(0u, 0u, 0u, 0u);
      }
  }
  // k-step ks is position i = ks: half plane ks / 4, field ks mod 4
  __device__ static void a_frag(const uint4 (&w)[NW],
                                const typename Base::Pass&, int st, int ks,
                                uint32_t a[4]) {
    const uint4 u = w[2 * st + (ks >> 2)];
    const int s = 4 * (ks & 3);
    a[0] = bfp_reg(u.x, u.y, 0x5410, s);     // row g: channel 2g
    a[1] = bfp_reg(u.x, u.y, 0x7632, s);     // row g + 8: channel 2g + 1
    a[2] = bfp_reg(u.z, u.w, 0x5410, s);
    a[3] = bfp_reg(u.z, u.w, 0x7632, s);
  }
};

}  // namespace sm
}  // namespace

// Plain C entry point, loaded with ctypes. x and out share one dtype
// (x_is_bf16 ? bfloat16 : float32); w0 (and w1, or null) are bfp planes
// (2, q_out/2, Gp), 16-byte aligned; scale may be null; m is the number of
// rows of x to compute (x's row stride is 8*Gp). Returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for shapes the
// kernel does not take (q_out odd, Gp not a multiple of 4).
extern "C" int qfa_bfp_decode_matmul(const void* x, const void* w0,
                                     const void* w1, const void* scale,
                                     void* out, int m, int q_out, int Gp,
                                     int n_sets, float alpha0, float alpha1,
                                     float beta_total, int x_is_bf16,
                                     void* stream) {
  if (m < 1 || q_out < 2 || q_out % 2 || Gp < 4 || Gp % 4 || n_sets < 1 ||
      n_sets > 2 || (n_sets == 2 && w1 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const sm::Args a{scale, out, m, q_out, Gp, alpha0, alpha1, beta_total};
  using B1 = sm::BfpCodes<1>;
  using B2 = sm::BfpCodes<2>;
  const B1::Planes p1{static_cast<const uint32_t*>(w0),
                      static_cast<const uint32_t*>(w1)};
  const B2::Planes p2{p1.w0, p1.w1};
  if (n_sets == 1)
    return x_is_bf16 ? sm::launch_nt<__nv_bfloat16, B1>(x, p1, a, s)
                     : sm::launch_nt<float, B1>(x, p1, a, s);
  return x_is_bf16 ? sm::launch_nt<__nv_bfloat16, B2>(x, p2, a, s)
                   : sm::launch_nt<float, B2>(x, p2, a, s);
}
