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
// and each weight is u0 + rs*u1 - 2.25*(1+rs) - 0.5*(p0 + rs*p1)[group].
// With x_perm (m, 8*Gp) in the grouped layout x_perm[r, i*Gp + g] =
// x[r, 8g + i] (pad lanes zero) and the group sums
// gx[r, g] = sum_{i=0..7} x_perm[r, i*Gp + g]:
//
//   out[r, n] = (d0 - 0.5*P0) + rs*(d1 - 0.5*P1) - 2.25*(1+rs)*rowsum(x)
//   d0/d1 = sum_{g,i} x*u0 / x*u1,  P0/P1 = sum_g gx*p0 / gx*p1
//
// then times scale[n] (when given) and a cast to x's dtype: the same
// function as the pb kernel (K8, rowpair_decode_matmul.cu) on another
// packing. Every product is exact in f32 at bf16 x (u <= 7, parities 0/1),
// so the result differs from the plain twin (ops/rowpair_matmul.py) only
// by f32 summation order -- except gx, whose rounding the Pallas body
// fixes: f32 for blocks of at most 8 rows, and for a larger bf16 block a
// bf16 sum left to right over i (dequant_pallas.py:386-388, :434-436).
// GXB selects that bf16 sum; the wrapper decides it from the padded row
// count as _fused_call does.
//
// What bounds it on the card: device-memory bytes. Per row a call must
// read Gp*4 + Gh*4 + Wp*4 plane bytes (~7 bits per weight at q_in 4096,
// where the parity plane is 128 lanes for 512 groups) plus x, and write
// out: ~5.8 GB per Llama-2-7B token, ~1.73 ms at the H100 SXM data-sheet
// 3.35 TB/s (reckoned from shapes, not measured), against pb's 5.37 GB and
// the RVQ4B nibble layout's 6.64 GB.
//
// Design (simple first), fused_decode_matmul's loop with the u-code math:
//   - a block of WARPS warps; a warp owns 4 rows (2 with the 4- and 8-row
//     accumulators, which would otherwise spill);
//   - each lane loads 4 consecutive words (uint4) of each plane per step,
//     groups g..g+3, striding over Gp by 128 groups: w0 at g, w1 at
//     g mod Gh (the 4 groups share one half h, since Gh is a multiple of
//     4), w2 at g mod Wp (they share one parity field j). Re-reads of w2
//     (every Gp/Wp steps the same words of a lane) hit L1/L2;
//   - x is read through L1/L2 (4 consecutive groups of position i), its
//     row sums and group sums are kept per lane, and the parity correction
//     is folded into the two accumulators once per group;
//   - the accumulator holds MT rows of x, MT in {1, 2, 4, 8} picked from m;
//     gridDim.y walks m-tiles of MT; a warp-shuffle reduction ends each
//     row, then the epilogue.
// Not done yet (a later PR): cp.async/TMA staging, tensor-core products
// for m >= 8, floats without int->float converts.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;   // warps per block
constexpr unsigned FULL = 0xffffffffu;

// rows per warp: 4 at decode sizes, 2 with the 4- and 8-row accumulators
template <int MT>
__host__ __device__ constexpr int paired_rows_per_warp() {
  return MT >= 4 ? 2 : 4;
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  // bf16 -> f32 is a 16-bit left shift of the bits (exact)
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xFFFF0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xFFFF0000u);
}
__device__ __forceinline__ void load4w(const uint32_t* p, uint32_t w[4]) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
  w[0] = t.x; w[1] = t.y; w[2] = t.z; w[3] = t.w;
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// a + b rounded to bf16: both are bf16 values, so the f32 sum rounded
// once more is the correctly rounded bf16 sum
__device__ __forceinline__ float add_bf16(float a, float b) {
  return __bfloat162float(__float2bfloat16_rn(a + b));
}

template <typename T, bool GXB, int MT>
__global__ void __launch_bounds__(WARPS * 32)
paired_decode_matmul_kernel(const T* __restrict__ x,
                            const uint32_t* __restrict__ w0,
                            const uint32_t* __restrict__ w1,
                            const uint32_t* __restrict__ w2,
                            const float* __restrict__ scale,
                            T* __restrict__ out, int m, int q_out, int Gp,
                            int Wp, float rs, float beta) {
  constexpr int ROWS = paired_rows_per_warp<MT>();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * WARPS + warp) * ROWS;
  if (n0 >= q_out) return;  // the whole warp leaves together; no block sync
  const int r0 = blockIdx.y * MT;
  const size_t K = 8 * (size_t)Gp;
  const int Gh = Gp >> 1;

  float acc[2][ROWS][MT];
  float xs[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    xs[r] = 0.f;
#pragma unroll
    for (int j = 0; j < ROWS; ++j) acc[0][j][r] = acc[1][j][r] = 0.f;
  }

#pragma unroll 2
  for (int g = lane * 4; g < Gp; g += 128) {
    const int h = g >= Gh;                           // half of w1
    const int gh = g - h * Gh;
    const int jp = g / Wp;                           // parity field
    const int gp = g - jp * Wp;
    uint32_t wa[ROWS][4], wc[ROWS][4], wp[ROWS][4];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const size_t n = min(n0 + j, q_out - 1);    // ragged edge: re-read
      load4w(w0 + n * Gp + g, wa[j]);
      load4w(w1 + n * Gh + gh, wc[j]);
      load4w(w2 + n * Wp + gp, wp[j]);
    }
    float gx[MT][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float xv[MT][4];
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        if (r0 + r < m) {
          load4(x + (size_t)(r0 + r) * K + (size_t)i * Gp + g, xv[r]);
        } else {
          xv[r][0] = xv[r][1] = xv[r][2] = xv[r][3] = 0.f;
        }
        xs[r] += (xv[r][0] + xv[r][1]) + (xv[r][2] + xv[r][3]);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          gx[r][q] = i == 0 ? xv[r][q]
                   : GXB ? add_bf16(gx[r][q], xv[r][q])
                         : gx[r][q] + xv[r][q];
      }
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t lo4 = (wa[j][q] >> (4 * i)) & 0xFu;
          const float u0 = (float)(lo4 & 7u);
          const float u1 =
              (float)(2u * ((wc[j][q] >> (16 * h + 2 * i)) & 3u) + (lo4 >> 3));
#pragma unroll
          for (int r = 0; r < MT; ++r) {
            acc[0][j][r] = fmaf(xv[r][q], u0, acc[0][j][r]);
            acc[1][j][r] = fmaf(xv[r][q], u1, acc[1][j][r]);
          }
        }
    }
    // parity: -0.5 * p * gx, once per group
#pragma unroll
    for (int j = 0; j < ROWS; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t bits = wp[j][q] >> (2 * jp);
        const float c0 = (bits & 1u) ? -0.5f : 0.f;
        const float c1 = (bits & 2u) ? -0.5f : 0.f;
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          acc[0][j][r] = fmaf(gx[r][q], c0, acc[0][j][r]);
          acc[1][j][r] = fmaf(gx[r][q], c1, acc[1][j][r]);
        }
      }
  }

  // warp reduction: afterwards every lane holds the full sums
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      xs[r] += __shfl_xor_sync(FULL, xs[r], off);
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        acc[0][j][r] += __shfl_xor_sync(FULL, acc[0][j][r], off);
        acc[1][j][r] += __shfl_xor_sync(FULL, acc[1][j][r], off);
      }
    }
  }

  // epilogue: lane (j*MT + r) writes out[r0 + r, n0 + j]
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      const int n = n0 + j, row = r0 + r;
      if (lane == j * MT + r && n < q_out && row < m) {
        float v = acc[0][j][r] + rs * acc[1][j][r];
        v -= beta * xs[r];
        if (scale != nullptr) v *= scale[n];
        store(out + (size_t)row * q_out + n, v);
      }
    }
  }
}

template <typename T, bool GXB, int MT>
void launch(const void* x, const void* w0, const void* w1, const void* w2,
            const void* scale, void* out, int m, int q_out, int Gp, int Wp,
            float rs, float beta, cudaStream_t stream) {
  static_assert(paired_rows_per_warp<MT>() * MT <= 32,
                "epilogue gives one lane per output");
  const int rows_per_block = WARPS * paired_rows_per_warp<MT>();
  dim3 grid((q_out + rows_per_block - 1) / rows_per_block,
            (m + MT - 1) / MT);
  paired_decode_matmul_kernel<T, GXB, MT><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(w0),
      static_cast<const uint32_t*>(w1), static_cast<const uint32_t*>(w2),
      static_cast<const float*>(scale), static_cast<T*>(out), m, q_out, Gp,
      Wp, rs, beta);
}

template <typename T, bool GXB>
void launch_mt(const void* x, const void* w0, const void* w1, const void* w2,
               const void* scale, void* out, int m, int q_out, int Gp, int Wp,
               float rs, float beta, cudaStream_t s) {
  if (m == 1)
    launch<T, GXB, 1>(x, w0, w1, w2, scale, out, m, q_out, Gp, Wp, rs, beta,
                      s);
  else if (m == 2)
    launch<T, GXB, 2>(x, w0, w1, w2, scale, out, m, q_out, Gp, Wp, rs, beta,
                      s);
  else if (m <= 4)
    launch<T, GXB, 4>(x, w0, w1, w2, scale, out, m, q_out, Gp, Wp, rs, beta,
                      s);
  else
    launch<T, GXB, 8>(x, w0, w1, w2, scale, out, m, q_out, Gp, Wp, rs, beta,
                      s);
}

}  // namespace

// Plain C entry point, loaded with ctypes. x and out share one dtype
// (x_is_bf16 ? bfloat16 : float32); scale may be null; m is the number of
// rows of x to compute (x's row stride is 8*Gp); Wp is w2's width; beta
// is 2.25*(1+rs); gx_bf16 selects the bf16 group sum. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int qfa_paired_decode_matmul(const void* x, const void* w0,
                                        const void* w1, const void* w2,
                                        const void* scale, void* out, int m,
                                        int q_out, int Gp, int Wp, float rs,
                                        float beta, int gx_bf16,
                                        int x_is_bf16, void* stream) {
  if (m < 1 || q_out < 1 || Gp < 8 || Gp % 8 || Wp < 4 || Wp % 4 ||
      Gp % Wp || Gp / Wp > 16 || (gx_bf16 && !x_is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!x_is_bf16)
    launch_mt<float, false>(x, w0, w1, w2, scale, out, m, q_out, Gp, Wp, rs,
                            beta, s);
  else if (gx_bf16)
    launch_mt<__nv_bfloat16, true>(x, w0, w1, w2, scale, out, m, q_out, Gp,
                                   Wp, rs, beta, s);
  else
    launch_mt<__nv_bfloat16, false>(x, w0, w1, w2, scale, out, m, q_out, Gp,
                                    Wp, rs, beta, s);
  return static_cast<int>(cudaGetLastError());
}
