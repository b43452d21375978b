// Fused affine-nibble decode + matmul over subword planes for Hopper
// (sm_90a): K11.
//
// Replaces: quip_for_all_tpu/ops/dequant_pallas.py:_make_kernel with
// split = 2 / 4 (the sw2 / sw4 runtime layouts, QFA_SPLIT_DECODE there)
// through both of _fused_call's grids (:868, :888): every m, in blocks of
// 32 rows.
//
// The sw planes are the nibble words' own bytes viewed as int16 / int8
// subwords (q_out, P*Gp), so the kernel reads them as the int32 words
// (q_out, Gp) they are. The math is K1's; only x's lane order differs:
// nibble i of word g lies in subword j = i div (8/P) at field
// q = i mod (8/P) and meets x lane q*(P*Gp) + P*g + j
// (transforms/incoherence.py matmul_hadUt_grouped(split=P)). Body, bound
// and design (K1's tensor-core body, with the A-register pairing of split
// P): nibble_mma_small.cuh.

#include "nibble_mma_small.cuh"

// Plain C entry point, loaded with ctypes. As qfa_fused_decode_matmul,
// with Gp the words per plane row (the subword columns / split) and split
// in {2, 4}.
extern "C" int qfa_sw_decode_matmul(const void* x, const void* w0,
                                    const void* w1, const void* scale,
                                    void* out, int m, int q_out, int Gp,
                                    int n_sets, float alpha0, float alpha1,
                                    float beta_total, int x_is_bf16,
                                    int split, void* stream) {
  if (split == 2)
    return sm::dispatch<2>(x, w0, w1, scale, out, m, q_out, Gp, n_sets,
                           alpha0, alpha1, beta_total, x_is_bf16, stream);
  if (split == 4)
    return sm::dispatch<4>(x, w0, w1, scale, out, m, q_out, Gp, n_sets,
                           alpha0, alpha1, beta_total, x_is_bf16, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
