// Fused row-pair decode + matmul for Hopper (sm_90a): two C entry points,
// one per byte-cut runtime layout of ops/qtensor.py, on one tensor-core
// body (ucode_mma_small.cuh, where its bound and design are).
//
// Replaces: quip_for_all_tpu/ops/dequant_pallas.py
//   - _make_kernel_u3 (K9, :486): E8P12 in the u3 layout (U3Codes);
//   - _make_kernel_pb (K8, :566): E8P12RVQ4B in the pb layout
//     (UcodeCodes, shared with K7);
// each through BOTH of _fused_call's grids (1-D at :868, 2-D m-tiled at
// :888): a block takes up to 32 rows of x and gridDim.y walks further
// tiles of 32, so either entry takes any m.
//
// Both layouts store an output-row PAIR per int32 word: row 2r in bits
// 0..15, row 2r+1 in bits 16..31 (h = 0 / 1). With x_perm (m, 8*Gp) in the
// grouped layout x_perm[r, i*Gp + g] = x[r, 8g + i] (pad lanes zero) and
// the group sums gx[r, g] = sum_{i=0..7} x_perm[r, i*Gp + g], u3 computes
//
//   u = lo2 + 4*hi1, lo2 = (w0[n/2, g] >> (16h + 2i)) & 3,
//   hi1 = (w1[n/2, g mod Gp/2] >> (16h + 8*(g div Gp/2) + i)) & 1,
//   p   = (w2[n/2, g mod PL] >> (16h + g div PL)) & 1
//   out[r, n] = sum_{g,i} x*u - 0.5 * sum_g gx*p - 2.25 * rowsum(x)
//
// and pb its two-set function (ucode_mma_small.cuh), then times scale[n]
// (when given) and a cast to x's dtype. Every product is exact in f32 at
// bf16 x, so the result differs from the plain twin (ops/rowpair_matmul.py)
// only by f32 summation order -- except gx, whose rounding the Pallas body
// fixes: f32 for blocks of at most 8 rows, and for a larger bf16 block a
// bf16 sum left to right over i (dequant_pallas.py :553-555); the
// wrapper decides it (gx_bf16) from the padded row count as _fused_call
// does.
//
// What bounds it on the card: device-memory bytes. Per row pair a u3 call
// must read Gp*4 + Gp*2 + PL*4 plane bytes, plus x, and write out: on
// Llama-2-7B at bs=1 ~2.90 GB of planes a token, ~0.86 ms at the H100 SXM
// data-sheet 3.35 TB/s (computed from shapes, not measured), against 3.32
// GB in the nibble layout.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ucode_mma_small.cuh"

// Plain C entry points, loaded with ctypes. x and out share one dtype
// (x_is_bf16 ? bfloat16 : float32); scale may be null; m is the number of
// rows of x to compute (x's row stride is 8*Gp); PL is w2's width; rs is
// pb's residual scale (u3 ignores it); beta is 2.25 (u3) or 2.25*(1+rs)
// (pb), which the codes carry; gx_bf16 selects the bf16 group sum; hb
// (null, or right_hb: B x B f32, H_B times its entry [0][0]) with right_b
// = B runs the right epilogue. Each returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for shapes or a beta
// the kernel does not take.
extern "C" int qfa_rowpair_u3_matmul_ex(
    const void* x, const void* w0, const void* w1, const void* w2,
    const void* scale, const void* hb, void* out, int m, int q_out, int Gp,
    int PL, float rs, float beta, int gx_bf16, int x_is_bf16, int right_b,
    void* stream) {
  (void)rs;
  // the kernel's shape rules (ops/rowpair_matmul.py checks them first): a
  // lane's 4 groups share one half of w1 and one parity field
  if (m < 1 || q_out < 2 || q_out % 2 || Gp < 8 || Gp % 8 || PL < 4 ||
      PL % 4 || Gp % PL || Gp / PL > 16 || (gx_bf16 && !x_is_bf16) ||
      !sm::right_ok(hb, right_b, q_out))
    return static_cast<int>(cudaErrorInvalidValue);
  return sm::dispatch_u3(x, w0, w1, w2, scale, out, m, q_out, Gp, PL, beta,
                         gx_bf16, x_is_bf16, stream, hb, right_b);
}

extern "C" int qfa_rowpair_pb_matmul_ex(
    const void* x, const void* w0, const void* w1, const void* w2,
    const void* scale, const void* hb, void* out, int m, int q_out, int Gp,
    int PL, float rs, float beta, int gx_bf16, int x_is_bf16, int right_b,
    void* stream) {
  if (m < 1 || q_out < 2 || q_out % 2 || Gp < 4 || Gp % 4 || PL < 4 ||
      PL % 4 || (Gp + PL - 1) / PL > 8 || (gx_bf16 && !x_is_bf16) ||
      !sm::right_ok(hb, right_b, q_out))
    return static_cast<int>(cudaErrorInvalidValue);
  return sm::dispatch_ucode<true>(x, w0, w1, w2, scale, out, m, q_out, Gp,
                                  PL, rs, beta, gx_bf16, x_is_bf16, stream, hb,
                                  right_b);
}

// The same two without the right epilogue (the tools' and older sources'
// arguments).
extern "C" int qfa_rowpair_u3_matmul(const void* x, const void* w0,
                                     const void* w1, const void* w2,
                                     const void* scale, void* out, int m,
                                     int q_out, int Gp, int PL, float rs,
                                     float beta, int gx_bf16, int x_is_bf16,
                                     void* stream) {
  return qfa_rowpair_u3_matmul_ex(x, w0, w1, w2, scale, nullptr, out, m,
                                  q_out, Gp, PL, rs, beta, gx_bf16, x_is_bf16,
                                  0, stream);
}

extern "C" int qfa_rowpair_pb_matmul(const void* x, const void* w0,
                                     const void* w1, const void* w2,
                                     const void* scale, void* out, int m,
                                     int q_out, int Gp, int PL, float rs,
                                     float beta, int gx_bf16, int x_is_bf16,
                                     void* stream) {
  return qfa_rowpair_pb_matmul_ex(x, w0, w1, w2, scale, nullptr, out, m,
                                  q_out, Gp, PL, rs, beta, gx_bf16, x_is_bf16,
                                  0, stream);
}
