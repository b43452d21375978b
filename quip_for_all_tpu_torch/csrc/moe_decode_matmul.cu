// Expert-indexed fused affine-nibble decode + matmul for Hopper (sm_90a).
//
// Replaces: quip_for_all_tpu/ops/moe_pallas.py
//   - _make_moe_kernel (K4, :56) through _moe_call's pallas_call at :234,
//     in either grid order (tiles outer / rows inner by default, rows outer
//     under QFA_MOE_TILES_INNER);
//   - _make_moe_kernel_merged (K5, :91) through the pallas_call at :178
//     (QFA_MOE_MERGED, R <= 4), which computes the same function with every
//     row's expert planes in one grid step.
// One kernel computes what all three compute. For x_perm (R, 8*Gp) in the
// grouped layout x_perm[r, i*Gp + g] = x[r, 8g + i], eids (R,) int32 and 1
// or 2 stacked plane sets of int32 words (E, q_out, Gp):
//
//   acc_s[r, n] = sum_{g, i} x_perm[r, i*Gp + g]
//                            * ((w_s[eids[r], n, g] >> 4i) & 0xF)
//   out[r, n]   = sum_s alpha_s * acc_s[r, n] + beta_total * rowsum(x_perm[r])
//
// cast to x's dtype. There is no scale epilogue: the caller applies the
// per-expert pre_vec after the cast, as the JAX package does. Every product
// is exact in f32 (bf16- or f32-valued x times nibbles 0..15), so the
// result differs from the plain twin only by f32 summation order. Rows
// whose expert id lies outside 0..E-1 are the caller's error and are left
// unwritten.
//
// What bounds it on the card: device-memory bytes. A call must read the
// planes of every DISTINCT selected expert once (n_sets*q_out*Gp*4 bytes
// each) plus x, and write out. On Mixtral-8x7B (E8P12 nibble planes) the
// decode shapes are
//
//   call   q_out x Gp     plane bytes per expert
//   w13    28672 x 512    58.7 MB
//   w2      4096 x 1792   29.4 MB
//
// and a bs=1 decode step (top-2, R = 2 rows, 2 distinct experts) must read
// 2 x (58.7 + 29.4) MB per layer, ~5.64 GB per token over 32 layers: ~1.68
// ms per token at the H100 SXM data-sheet 3.35 TB/s (computed from shapes,
// not measured); a sparse prefill of 31 tokens (R = 62) reads all 8
// experts, ~22.6 GB, ~6.7 ms.
//
// Design: K1's tensor-core body (nibble_mma_small.cuh: x staged by
// cp.async, mma.sync m16n8k16 with the decoded words as A and x's rows as
// B, one pass over a tile's planes for all its rows) with the codes policy
// MoeCodes, K1's NibbleCodes plus the skeleton's row map:
//   - every block builds the table of experts present from eids on the
//     device (a count an expert id, then the ids present in ascending
//     order), so the wrapper never reads the routing back and a decode
//     step records into a CUDA graph;
//   - a unit of work is (expert present, chunk of at most 8 of its rows,
//     channel tile); the grid is as many blocks as the card holds at
//     once (at most one a unit; the host sizes it without knowing how many
//     experts are present), and each block takes a run of consecutive
//     units, so it walks consecutive tiles of one expert and stages the
//     expert's x rows once for them (restaged only when the chunk
//     changes);
//   - the chunk's rows are listed in row order by warp ballots into the
//     row map: block row r reads x[rows[r]] and writes out[rows[r], n],
//     and the planes are the unit's expert's slice of the stacks; an
//     expert's planes are thus read once a call for up to 8 of its rows
//     (once a chunk beyond);
//   - one n8 tile of rows (a chunk of 8) at every R: a 31-token prefill
//     (R = 62, about 8 rows an expert) ran 1.97x longer with chunks of 32
//     and 1.38x with 16 on an H100 (x no longer resident in shared memory,
//     restaged every tile), more than the planes re-read for an expert of
//     more than 8 rows cost (nibble_mma_small.cuh's launch_nt);
//   - f32 x is split into three exact bf16 terms, as K1 does.
// Not done yet (a later PR): folding pre_vec into the epilogue under a
// parity check (it rounds once instead of twice: another function).

#include "nibble_mma_small.cuh"

namespace {
namespace sm {

// K1's codes with each unit's planes those of its expert: the stacks'
// base pointers, the ids and the expert count ride the planes.
template <int NSETS_>
struct MoeCodes : NibbleCodes<NSETS_, 1> {
  using Base = NibbleCodes<NSETS_, 1>;
  static constexpr bool GATHER = true;
  struct Planes : Base::Planes {
    const int* eids;
    int E;
  };
  // expert e's planes of the (E, q_out, Gp) stacks
  __device__ static Planes at(const Planes& p, int e, int q_out, int Gp) {
    const size_t off = (size_t)e * q_out * Gp;
    Planes q = p;
    q.w0 = p.w0 + off;
    if (NSETS_ > 1) q.w1 = p.w1 + off;
    return q;
  }
};

template <typename T, int NSETS>
int run(const void* x, const int* eids, const void* w0, const void* w1,
        int E, const Args& a, cudaStream_t s) {
  typename MoeCodes<NSETS>::Planes p{};
  p.w0 = static_cast<const uint32_t*>(w0);
  p.w1 = static_cast<const uint32_t*>(w1);
  p.eids = eids;
  p.E = E;
  return launch_nt<T, MoeCodes<NSETS>>(x, p, a, s);
}

}  // namespace sm
}  // namespace

// Plain C entry point, loaded with ctypes. x and out share one dtype
// (x_is_bf16 ? bfloat16 : float32); w1 may be null (n_sets == 1); R >= 1,
// 1 <= max_rows <= R bounds the rows of any one expert (checked; the
// kernel takes chunks of 8 rows whatever it says), 1 <= E <= 64; x's row
// stride is 8*Gp; x and the planes are 16-byte aligned. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int qfa_moe_decode_matmul(const void* x, const void* eids,
                                     const void* w0, const void* w1,
                                     void* out, int R, int max_rows, int E,
                                     int q_out, int Gp, int n_sets,
                                     float alpha0, float alpha1,
                                     float beta_total, int x_is_bf16,
                                     void* stream) {
  if (R < 1 || max_rows < 1 || max_rows > R || E < 1 ||
      E > sm::MAX_EXPERTS || q_out < 1 || Gp < 4 || Gp % 4 ||
      (n_sets != 1 && n_sets != 2) || (n_sets == 2 && w1 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ids = static_cast<const int*>(eids);
  const sm::Args a{nullptr, out, R, q_out, Gp, alpha0, alpha1, beta_total};
  if (n_sets == 1)
    return x_is_bf16
               ? sm::run<__nv_bfloat16, 1>(x, ids, w0, w1, E, a, s)
               : sm::run<float, 1>(x, ids, w0, w1, E, a, s);
  return x_is_bf16 ? sm::run<__nv_bfloat16, 2>(x, ids, w0, w1, E, a, s)
                   : sm::run<float, 2>(x, ids, w0, w1, E, a, s);
}
