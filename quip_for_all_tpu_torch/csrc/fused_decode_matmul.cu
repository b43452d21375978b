// Fused affine-nibble decode + matmul for Hopper (sm_90a): K1.
//
// Replaces: quip_for_all_tpu/ops/dequant_pallas.py:_make_kernel (split=1,
// nibble layout) through _fused_call's 1-D grid (pallas_call at :868,
// decode, TM == m): the calls of at most 32 rows after the pad to 8. The
// kernel takes any m (in blocks of 32 rows), but ops/fused_matmul.py sends
// the larger calls (the 2-D m-tiled grid at :888) to K2,
// fused_decode_matmul_tc.cu.
//
// x_perm (m, 8*Gp) is in the grouped layout x_perm[r, i*Gp + g] =
// x[r, 8g + i]; the planes are 1 or 2 sets of int32 words (q_out, Gp).
// The kernel body, what bounds it and its design are in
// nibble_mma_small.cuh (tensor cores: one pass over the planes for all
// m <= 32 rows); this entry point instantiates it with split P = 1.

#include "nibble_mma_small.cuh"

// Plain C entry point, loaded with ctypes. x and out share one dtype
// (x_is_bf16 ? bfloat16 : float32); w1 and scale may be null; m is the
// number of rows of x to compute (x's row stride is 8*Gp); the planes are
// 16-byte aligned. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int qfa_fused_decode_matmul(const void* x, const void* w0,
                                       const void* w1, const void* scale,
                                       void* out, int m, int q_out, int Gp,
                                       int n_sets, float alpha0, float alpha1,
                                       float beta_total, int x_is_bf16,
                                       void* stream) {
  return sm::dispatch<1>(x, w0, w1, scale, out, m, q_out, Gp, n_sets, alpha0,
                         alpha1, beta_total, x_is_bf16, stream);
}

// The same with the right epilogue and the combined decode: hb (null, or
// right_hb: B x B f32, H_B times its entry [0][0]) with right_b = B, and
// combine (two plane sets) with ratio = f32(alpha1 / alpha0).
extern "C" int qfa_fused_decode_matmul_ex(
    const void* x, const void* w0, const void* w1, const void* scale,
    const void* hb, void* out, int m, int q_out, int Gp, int n_sets,
    float alpha0, float alpha1, float beta_total, float ratio, int x_is_bf16,
    int right_b, int combine, void* stream) {
  return sm::dispatch<1>(x, w0, w1, scale, out, m, q_out, Gp, n_sets, alpha0,
                         alpha1, beta_total, x_is_bf16, stream, hb, right_b,
                         combine, ratio);
}
