// Fused affine-nibble decode + matmul for Hopper (sm_90a): K1/K2.
//
// Replaces: quip_for_all_tpu/ops/dequant_pallas.py:_make_kernel (split=1,
// nibble layout) through BOTH of _fused_call's grids — the 1-D grid
// (pallas_call at :868, decode, TM == m) and the 2-D m-tiled grid (:888,
// prefill below the crossover). One kernel takes any m.
//
// x_perm (m, 8*Gp) is in the grouped layout x_perm[r, i*Gp + g] =
// x[r, 8g + i]; the planes are 1 or 2 sets of int32 words (q_out, Gp).
// The kernel body, what bounds it and its design are in nibble_decode.cuh
// (this entry point instantiates it with split P = 1 and no split-K).

#include "nibble_decode.cuh"

// Plain C entry point, loaded with ctypes. x and out share one dtype
// (x_is_bf16 ? bfloat16 : float32); w1 and scale may be null; m is the
// number of rows of x to compute (x's row stride is 8*Gp). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int qfa_fused_decode_matmul(const void* x, const void* w0,
                                       const void* w1, const void* scale,
                                       void* out, int m, int q_out, int Gp,
                                       int n_sets, float alpha0, float alpha1,
                                       float beta_total, int x_is_bf16,
                                       void* stream) {
  const NibbleArgs a{x, w0, w1, scale, out, nullptr, m, q_out, Gp, 1,
                     alpha0, alpha1, beta_total};
  return dispatch<1, false>(a, n_sets, x_is_bf16, stream);
}
