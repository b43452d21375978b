// Fused paired-layout decode + matmul for Hopper (sm_90a): K7.
//
// Replaces: quip_for_all_tpu/ops/dequant_pallas.py:_make_kernel_paired
// (:356, E8P12RVQ4B in the paired runtime layout, QFA_RVQ_PAIRED there)
// through both of _fused_call's grids (:868, :888). One kernel takes any m.
//
// The paired planes hold one output row per int32 word (Gp a multiple of
// 256, Gh = Gp/2, Wp dividing Gp with Gp/Wp <= 16):
//   w0 (q_out, Gp)  bits 4i:        lo4 = u0 | (u1 & 1) << 3 at position i
//   w1 (q_out, Gh)  bits 16h + 2i:  u1 >> 1 of group h*Gh + lane
//   w2 (q_out, Wp)  bits 2j, 2j+1:  (p0, p1) of group j*Wp + lane
// and each weight is u0 + rs*u1 - 2.25*(1+rs) - 0.5*(p0 + rs*p1)[group]:
// the same function as the pb kernel (K8, rowpair_decode_matmul.cu) on
// another packing. The kernel body, what bounds it and its design are in
// ucode_mma_small.cuh (tensor cores: one pass over the planes for all
// m <= 32 rows of a block), shared with K8.

#include "ucode_mma_small.cuh"

// Plain C entry point, loaded with ctypes. x and out share one dtype
// (x_is_bf16 ? bfloat16 : float32); scale may be null; m is the number of
// rows of x to compute (x's row stride is 8*Gp); Wp is w2's width; beta
// is 2.25*(1+rs); gx_bf16 selects the bf16 group sum; hb (null, or
// right_hb: B x B f32, H_B times its entry [0][0]) with right_b = B runs
// the right epilogue; the planes are 16-byte aligned. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int qfa_paired_decode_matmul_ex(
    const void* x, const void* w0, const void* w1, const void* w2,
    const void* scale, const void* hb, void* out, int m, int q_out, int Gp,
    int Wp, float rs, float beta, int gx_bf16, int x_is_bf16, int right_b,
    void* stream) {
  if (m < 1 || q_out < 1 || Gp < 8 || Gp % 8 || Wp < 4 || Wp % 4 ||
      Gp % Wp || Gp / Wp > 16 || (gx_bf16 && !x_is_bf16) ||
      !sm::right_ok(hb, right_b, q_out))
    return static_cast<int>(cudaErrorInvalidValue);
  return sm::dispatch_ucode<false>(x, w0, w1, w2, scale, out, m, q_out, Gp,
                                   Wp, rs, beta, gx_bf16, x_is_bf16, stream,
                                   hb, right_b);
}

// The same without the right epilogue (the tools' and older sources'
// arguments).
extern "C" int qfa_paired_decode_matmul(const void* x, const void* w0,
                                        const void* w1, const void* w2,
                                        const void* scale, void* out, int m,
                                        int q_out, int Gp, int Wp, float rs,
                                        float beta, int gx_bf16,
                                        int x_is_bf16, void* stream) {
  return qfa_paired_decode_matmul_ex(x, w0, w1, w2, scale, nullptr, out, m,
                                     q_out, Gp, Wp, rs, beta, gx_bf16,
                                     x_is_bf16, 0, stream);
}
