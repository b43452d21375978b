// Affine-nibble decode + matmul at small m (m <= 32 rows a block) on
// Hopper's tensor cores (sm_90a): the kernel body of five sources, each
// with its own C entry point:
//   fused_decode_matmul.cu   K1:  int32 nibble planes (split P = 1);
//   sw_decode_matmul.cu      K11: the same words stored as int16 / int8
//                                 subwords (sw2 / sw4, P = 2 / 4);
//   ksplit_decode_matmul.cu  K6:  K1's function with the groups split
//                                 into chunks (split-K, below);
//   bfp_decode_matmul.cu     K10: K1's words re-laid as row pairs
//                                 (BfpCodes there);
//   moe_decode_matmul.cu     K4/K5: K1's function with each row's planes
//                                 those of its expert (MoeCodes there,
//                                 the row map below).
// The body is a skeleton over a codes policy (NibbleCodes here): the
// policy says which words a lane loads and how they become A registers;
// the skeleton stages x, walks the slabs and tiles, multiplies, flushes
// and stores. ucode_mma_small.cuh runs the same skeleton on the u-codes
// of K7, K8 and K9.
//
// Computes, for x_perm (m, 8*Gp) in the layout's grouped lane order and 1
// or 2 plane sets of words (q_out, Gp):
//
//   out[r, n] = (sum_s alpha_s * sum_{g,i} x_perm[r, lane(g, i)]
//                                          * nib_s[n, g, i]
//                + beta_total * rowsum(x_perm[r])) * scale[n]
//
// (no scale when none is given), cast to x's dtype. With P subwords a word
// and NQ = 8 / P fields a subword, nibble i of word g lies in subword
// j = i div NQ at field q = i mod NQ and meets lane(g, i) = q*(P*Gp) + P*g + j.
//
// What bounds it on the card: device-memory bytes. A call reads
// n_sets*q_out*Gp*4 plane bytes, and x and the output are small next to
// them at m <= 32: a Llama-2-7B token's 129 calls read 3.32 GB of planes,
// ~0.99 ms at the H100 SXM data-sheet 3.35 TB/s, at m = 1 and at m = 32
// alike. The SIMT body this replaces (nibble_decode.cuh) tiled m by 8 at
// most, so a 32-row call streamed and decoded every word 4 times, kept an
// 8-row f32 accumulator at the register limit, and spent an int->float
// convert and an f32 FMA a nibble a row on the CUDA cores.
//
// Design (what it does about that; tools/variants_small_m.py times the
// alternatives):
//   - One pass over the planes a call: a block takes 32 or 64 output
//     channels and all m <= 32 rows of x (gridDim.y walks further tiles of
//     32 rows, for K11 above 32). The rows are 1, 2 or 4 n8 tiles (NT) of
//     one mma.sync.m16n8k16 (bf16 in, f32 accumulate) with the decoded
//     words as A (16 channels x 16 k) and x as B (16 k x 8 rows), so every
//     word is decoded once for all the block's rows.
//   - Decode straight into A-fragment registers: lane (g, t) of a warp
//     loads, for each of its channel rows, the uint4 of words 4t..4t+3 of
//     a 16-group slab, and the k order of the slab's 8 k-steps is chosen
//     so that each A register is two nibbles of its own words that sit in
//     two adjacent x lanes: (word 2p, word 2p+1) at one nibble for P = 1,
//     nibbles (q, q+4) of one word for P = 2, (q+4h, q+4h+2) for P = 4.
//     (0x4300 | nib) is the bf16 of 128 + nib: one shift or byte permute,
//     one lop3 and one bf16x2 subtract of 128 (exact) a register, with no
//     int->float convert. The words of the next slab are loaded while this
//     one is multiplied.
//   - x is staged in shared memory by cp.async, in x_perm's own order: for
//     each field q, the P*SG lanes of a stage of SG groups are one
//     contiguous run, so a lane reads its bf16 B registers for the P
//     k-steps of a field with one 8-32 byte load. The whole row is one
//     stage when the block's rows fit (always at m = 1); else two buffers
//     alternate, the next stage in flight while this one is multiplied.
//     f32 x is split as a lane reads it into three bf16 terms (hi + mid +
//     lo, exact, each its own MMA); every product is exact in f32.
//   - Each slab (128 k) starts a fresh MMA accumulator, added into f32 sums
//     (times alpha_s) after the slab; the row sums of beta come from one
//     more MMA with an all-ones A, flushed the same way. f32 outputs stay
//     inside 1e-5 of the max only with this flush (tools/ablate_mma.py
//     measured it on K2).
//   - A block's 8 warps split WN across channels (32 each) and WK = 8 / WN
//     across the slabs of a stage; the WK partial sums meet in shared
//     memory at the end of a tile, in warp order (deterministic), and the
//     block stores the tile row by row. WN = 2 above 8 rows only on layers
//     wide enough to give every SM two blocks of 64 channels (x's L2 bytes
//     halve); elsewhere the fill of the card matters more.
//   - The grid is as many blocks as the card holds at once (at most one a
//     tile); each walks every gridDim.x-th tile, and a resident x is
//     staged once for all of them.
//   - Counters, not integer divisions, walk the slabs and the copies: a
//     runtime division in the slab loop made m = 1 18% slower on an H100.
//   - Split-K (KS, K6): a unit of work is (channel tile, chunk), and the
//     grid is a multiple of the chunk count, so a block keeps one chunk
//     (its groups [gb, gb + Gc), Gc a multiple of 16: whole slabs), stages
//     only that chunk's x and walks every (gridDim.x / chunks)-th tile.
//     Its f32 partial (alphas and the chunk's beta row sums applied) goes
//     to a (chunks, m, q_out) workspace, which ksplit_decode_matmul.cu's
//     second kernel adds in chunk order. Without KS the chunk is the whole
//     row (Gc = Gp) and the split's terms fold away at compile time.
//     split_pays says where the split runs: where it does not, K6 is this
//     body over whole tiles, each warp's f32 sum walking the chunks' slabs
//     in order.
//   - Row map (a policy with GATHER, K4/K5): a unit of work is (expert
//     present, chunk of at most ROWS of its rows, channel tile), and the
//     expert table (rows an expert, the experts present in ascending
//     order) is built on the device from the ids by every block, so no
//     host read of the routing is needed and a call records into a CUDA
//     graph. Block b takes the units [b*U/G, (b+1)*U/G) of the U in the
//     order (expert, chunk, tile), so it restages x only when the chunk
//     changes; the chunk's rows, listed in row order by warp ballots, are
//     a row map in shared memory: row r of the block reads x[rows[r]] and
//     writes out[rows[r], n], and the planes are those of the unit's
//     expert. launch_nt gives a row map one n8 tile (ROWS = 8).
//     Without GATHER the block's rows are m0 .. m0 + mr - 1 and all of
//     this folds away at compile time.
#pragma once

#include "nibble_mma.cuh"

namespace {
namespace sm {

constexpr int THREADS = 256;        // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int MT = 2;               // m16 channel tiles a warp (K1/K11)
constexpr int WCH = 16 * MT;        // channels a warp
constexpr int SLAB = 16;            // groups a warp step (4 lanes x uint4)
constexpr int MAX_ROWS = 32;        // rows of x a block (4 n8 tiles)
constexpr int STAGE_BUDGET = 96 * 1024;   // smem for x before it must split
constexpr int SMEM_MAX = 232448;    // a block's shared memory on sm_90
constexpr int PF = 1;               // word slabs a lane loads ahead
constexpr uint32_t ONES = 0x3F803F80u;    // bf16 pair (1, 1)
constexpr int MAX_EXPERTS = 64;     // a row map's experts (K4/K5)
constexpr unsigned FULL = 0xffffffffu;

// Whether a codes policy maps its rows through the experts (C::GATHER).
template <class C, class = void>
struct gathers {
  static constexpr bool value = false;
};
template <class C>
struct gathers<C, decltype(void(C::GATHER))> {
  static constexpr bool value = C::GATHER;
};

// A row map's shared memory: the expert table and the unit's rows. The
// entry after the last expert present is a sentinel (expert 0, a chunk
// count no walk reaches), so the walks may step past the block's units.
struct GatherSmem {
  int cnt[MAX_EXPERTS];           // rows of each expert id
  int ex[MAX_EXPERTS + 1];        // the j-th expert present
  int nck[MAX_EXPERTS + 1];       // its chunks of ROWS rows
  int rows[MAX_ROWS];             // the unit's rows of x, in row order
  int units;                      // the units of the call
};

// (j-th expert present, chunk, tile) of a block's units, walked in that
// order by a counter each
struct UnitWalk {
  int j, c, tile;
  __device__ void start(const GatherSmem* gs, int u, int ntiles) {
    j = 0;
    while (u >= gs->nck[j] * ntiles) {
      u -= gs->nck[j] * ntiles;
      ++j;
    }
    c = u / ntiles;
    tile = u - c * ntiles;
  }
  __device__ void next(const GatherSmem* gs, int ntiles) {
    if (++tile < ntiles) return;
    tile = 0;
    if (++c < gs->nck[j]) return;
    c = 0;
    ++j;
  }
};

// Warp layout for NT n8 tiles of rows, WN channel warps and MTS m16 tiles
// a warp: a block's x bytes from L2 are 4*m / BN times its plane bytes in
// bf16, so two channel warps halve them, and halve the tiles that fill
// the card.
template <int NT, int WN_, int MTS_ = MT>
struct Shape {
  static constexpr int WN = WN_;               // warps across channels
  static constexpr int WK = WARPS / WN;        // warps across slabs
  static constexpr int MTS = MTS_;             // m16 tiles a warp
  static constexpr int WCH = 16 * MTS;         // channels a warp
  static constexpr int BN = WN * WCH;          // channels a block
  static constexpr int ROWS = 8 * NT;
  static constexpr int RED_STRIDE = BN + 4;    // f32 a row of the reduce
  static constexpr int RED_B = WK * ROWS * (RED_STRIDE + 1) * 4;
};

// Bytes of one field run of a lane's 4 groups (4*P values); the pad after
// each x row keeps a warp's loads of them free of bank conflicts (all but
// f32 at P = 4, whose lanes' 16-byte loads meet two to a bank).
template <typename T, int P>
__host__ __device__ constexpr int run_bytes() { return 4 * P * (int)sizeof(T); }
template <typename T, int P>
__host__ __device__ constexpr int pad_bytes() {
  return run_bytes<T, P>() <= 16 ? 4 * run_bytes<T, P>() : 16;
}
template <typename T, int P>
__host__ __device__ constexpr int row_bytes(int SG) {
  return 8 * SG * (int)sizeof(T) + pad_bytes<T, P>();
}

// bf16x2 (128 + a, 128 + b) from t = a | b << 16 (a, b in 0..15) -> (a, b)
__device__ __forceinline__ uint32_t unbias(uint32_t t) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&t);
  v = __hsub2(v, __floats2bfloat162_rn(128.f, 128.f));
  return tc::bf16x2_bits(v);
}

// The A register of B register rho (0..15) of a lane's 4 words w: the two
// nibbles that meet the two x values of that register (see the header).
template <int P>
__device__ __forceinline__ uint32_t a_reg(const uint32_t w[4], int rho) {
  uint32_t t;
  if (P == 1) {                 // rho = 2i + p: words 2p, 2p+1 at nibble i
    const int i = rho >> 1, p = rho & 1;
    const uint32_t h = __byte_perm(w[2 * p], w[2 * p + 1],
                                   i < 4 ? 0x5410 : 0x7632);
    t = (h >> (4 * (i & 3))) & 0x000F000Fu;
  } else if (P == 2) {          // rho = 4q + v: word v, nibbles q, q+4
    const int q = rho >> 2, v = rho & 3;
    t = (w[v] >> (4 * q)) & 0x000F000Fu;
  } else {                      // rho = 8q + 2e + h: word e, 4h+q, 4h+q+2
    const int q = rho >> 3, e = (rho >> 1) & 3, h = rho & 1;
    t = __byte_perm(w[e] >> (4 * q), 0, h ? 0x4342 : 0x4140) & 0x000F000Fu;
  }
  return unbias(t | 0x43004300u);
}

// The three bf16 terms of an f32 pair (hi = bf16(v), mid, lo: exact sum)
__device__ __forceinline__ void split3(float a, float b, uint32_t out[3]) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float ra = a - __low2float(h), rb = b - __high2float(h);
  const __nv_bfloat162 mi = __floats2bfloat162_rn(ra, rb);
  const __nv_bfloat162 lo = __floats2bfloat162_rn(ra - __low2float(mi),
                                                  rb - __high2float(mi));
  out[0] = tc::bf16x2_bits(h);
  out[1] = tc::bf16x2_bits(mi);
  out[2] = tc::bf16x2_bits(lo);
}

// a + b rounded to bf16: both are bf16 values, so the f32 sum rounded
// once more is the correctly rounded bf16 sum
__device__ __forceinline__ float add_bf16(float a, float b) {
  return __bfloat162float(__float2bfloat16_rn(a + b));
}

// A lane's x values of one field run (its 4 groups: 4*P values) in
// shared memory. bf16: the whole run, loaded at the field's first k-step
// (8, 16 or 32 bytes) and held for its P k-steps; f32: the 4 values of one
// k-step (16 bytes), split into three bf16 terms as they are used.
template <typename T, int P>
struct XRun {
  static constexpr bool WHOLE = sizeof(T) == 2;
  static constexpr int N = WHOLE ? 2 * P : 4;    // 32-bit words held
  uint32_t v[N];
  __device__ __forceinline__ void load(const T* p) {
    if (N == 2) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      v[0] = u.x; v[1] = u.y;
    } else {
#pragma unroll
      for (int c = 0; c < N / 4; ++c) {
        const uint4 u = reinterpret_cast<const uint4*>(p)[c];
        v[4 * c] = u.x; v[4 * c + 1] = u.y;
        v[4 * c + 2] = u.z; v[4 * c + 3] = u.w;
      }
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int c = 0; c < N; ++c) v[c] = 0u;
  }
  // value e (0..3) of a P = 1 run, as f32 (exact)
  __device__ __forceinline__ float value(int e) const {
    if (!WHOLE) return __uint_as_float(v[e]);
    return __uint_as_float(e & 1 ? v[e >> 1] & 0xFFFF0000u : v[e >> 1] << 16);
  }
  // the TERMS bf16x2 B registers of pair u (values 2u, 2u+1) held
  template <int TERMS>
  __device__ __forceinline__ void b_reg(int u, uint32_t out[TERMS]) const {
    if (TERMS == 1) {
      out[0] = v[u];
    } else {
      uint32_t t3[3];
      split3(__uint_as_float(v[2 * u]), __uint_as_float(v[2 * u + 1]), t3);
#pragma unroll
      for (int k = 0; k < TERMS; ++k) out[k] = t3[k];
    }
  }
};

// The affine-nibble codes of K1 and K11 (the codes policy of the
// skeleton below): NSETS sets of int32 words (q_out, Gp), nibble i of word
// g meeting x lane lane(g, i) of split P. Each set is one pass over a
// slab, its sums times alpha_s. A policy gives the skeleton:
//   NSETS, P     sets (of codes, each times its alpha) and x's split;
//   fused(NT)    whether one pass over a slab takes all the sets (an
//                accumulator each), else a pass a set;
//   mtiles(NT)   m16 channel tiles a warp at NT n8 tiles of rows;
//   NW           uint4 a lane loads for an m16 tile of channels;
//   ROWSUMS      beta * rowsum(x) from an all-ones A (else the codes
//                carry beta themselves);
//   PARITY       a parity k-step after the 8 of a pass (u-codes with
//                bf16 group sums), B the group sums of the lane's groups;
//   PAIR_ROWS    A row g is channel 2g and g + 8 is 2g + 1 (row-pair
//                words), not g and g + 8;
//   Planes, Walk the plane pointers (a kernel argument) and what the slab
//                walk tracks besides the skeleton's counters;
//   load, ctx    a lane's words of the next item, and a word of context
//                about it kept beside them;
//   Pass, pass   what a pass over an m16 tile's words computes once for
//                its 8 k-steps;
//   a_frag       the A registers of k-step ks of pass st; p_frag the
//                parity A registers of pass st.
template <int NSETS_, int P_>
struct NibbleCodes {
  static constexpr int NSETS = NSETS_, P = P_, NW = 2 * NSETS_;
  static constexpr bool ROWSUMS = true, PARITY = false, PAIR_ROWS = false;
  __host__ __device__ static constexpr bool fused(int) { return false; }
  __host__ __device__ static constexpr int mtiles(int) { return MT; }
  struct Planes {
    const uint32_t* w0;
    const uint32_t* w1;
  };
  struct Walk {                       // nothing beyond the counters
    __device__ Walk(const Planes&, int, int) {}
    __device__ void next(bool) {}
  };
  __device__ static uint32_t ctx(const Walk&, int, const Planes&) {
    return 0u;
  }
  // set st's words of rows g and g + 8 of m16 tile mt: w[mt][2*st + h]
  template <int MTW>
  __device__ static void load(uint4 (&w)[MTW][NW], const Planes& pl, int n0,
                              int g, int c, const Walk&, int q_out, int Gp,
                              bool ok) {
#pragma unroll
    for (int st = 0; st < NSETS; ++st)
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = min(n0 + mt * 16 + g + 8 * h, q_out - 1);
          const uint32_t* p = st == 0 ? pl.w0 : pl.w1;
          w[mt][2 * st + h] = ok ? __ldg(reinterpret_cast<const uint4*>(
                                       p + (size_t)n * Gp + c))
                                 : make_uint4(0u, 0u, 0u, 0u);
        }
  }
  struct Pass {};
  __device__ static Pass pass(const uint4 (&)[NW], int, uint32_t) {
    return {};
  }
  __device__ static void a_frag(const uint4 (&w)[NW], const Pass&, int st,
                                int ks, uint32_t a[4]) {
    const uint4 ug = w[2 * st], uh = w[2 * st + 1];
    const uint32_t wg[4] = {ug.x, ug.y, ug.z, ug.w};
    const uint32_t wh[4] = {uh.x, uh.y, uh.z, uh.w};
    a[0] = a_reg<P>(wg, 2 * ks);
    a[1] = a_reg<P>(wh, 2 * ks);
    a[2] = a_reg<P>(wg, 2 * ks + 1);
    a[3] = a_reg<P>(wh, 2 * ks + 1);
  }
};

template <typename T, class C, int NT, int WN, bool KS = false>
__global__ void __launch_bounds__(THREADS)
mma_small_kernel(const T* __restrict__ x, const typename C::Planes planes,
                 const float* __restrict__ scale, T* __restrict__ out, int m,
                 int q_out, int Gp, int SG, float alpha0, float alpha1,
                 float beta_total, int nch, float* __restrict__ ws) {
  using S = Shape<NT, WN, C::mtiles(NT)>;
  constexpr int P = C::P, NSETS = C::NSETS, NW = C::NW;
  constexpr int MTW = S::MTS;                    // m16 tiles a warp
  constexpr int FS = C::fused(NT) ? NSETS : 1;   // sets a pass
  constexpr int NQ = 8 / P;
  constexpr int TERMS = sizeof(T) == 4 ? 3 : 1;
  constexpr bool GATHER = gathers<C>::value;
  extern __shared__ __align__(16) unsigned char smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wn = warp % S::WN, wk = warp / S::WN;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = GATHER ? 0 : blockIdx.y * MAX_ROWS;
  // the block's rows (a row map: the unit's, set with each chunk) and the
  // rows an x buffer holds
  int mr = GATHER ? 0 : min(MAX_ROWS, m - m0);
  const int mcap = GATHER ? min(S::ROWS, m) : mr;
  const size_t K = 8 * (size_t)Gp;
  // split-K: the reduce kernel may be scheduled now (it waits for this
  // grid's end before it reads the workspace)
  if constexpr (KS) asm volatile("griddepcontrol.launch_dependents;");
  // split-K: the block's chunk, its first group gb and its Gk groups;
  // else the whole row
  const int chunk = KS ? blockIdx.x % nch : 0;
  const int Gk = KS ? Gp / nch : Gp;
  const int gb = chunk * Gk;
  const int RSB = row_bytes<T, P>(SG);           // smem bytes an x row
  const int nslab = (Gk + SLAB - 1) / SLAB;
  const int spst = SG / SLAB;                    // slabs a stage
  const int nstage = (nslab + spst - 1) / spst;
  const int per = spst / S::WK;                  // a warp's slabs a stage
  // the block's tiles of BN channels: tb, tb + tstep, ... (split-K: the
  // nch blocks of a tile walker share tb and tstep)
  const int ntiles = (q_out + S::BN - 1) / S::BN;
  const int tb = KS ? blockIdx.x / nch : blockIdx.x;
  const int tstep = KS ? gridDim.x / nch : gridDim.x;
  int ntile = (ntiles - tb + tstep - 1) / tstep;
  // one stage holds the whole row (chunk): x stays in shared memory for
  // every tile of the block (of a row map's chunk)
  const bool resident = nstage == 1;
  const bool vec = Gk % 16 == 0;               // runs of 16-byte copies
  float* red = reinterpret_cast<float*>(
      smem + (size_t)(resident ? 1 : 2) * mcap * RSB);
  float* rs = red + S::WK * S::ROWS * S::RED_STRIDE;
  GatherSmem* gs = reinterpret_cast<GatherSmem*>(
      smem + (size_t)(resident ? 1 : 2) * mcap * RSB + S::RED_B);
  // a row map: the units of the block and the walks of the units computed
  // (uw) and of the words loaded ahead (lw)
  [[maybe_unused]] UnitWalk uw, lw;
  if constexpr (GATHER) {
    const int* eids = planes.eids;
    for (int e = threadIdx.x; e < MAX_EXPERTS; e += THREADS) gs->cnt[e] = 0;
    __syncthreads();
    for (int r = threadIdx.x; r < m; r += THREADS) {
      const int e = __ldg(eids + r);
      if (e >= 0 && e < planes.E) atomicAdd(&gs->cnt[e], 1);
    }
    __syncthreads();
    if (warp == 0) {
      // the experts present in ascending order, their chunks, the units
      int np = 0, chunks = 0;
      for (int h = 0; h < MAX_EXPERTS; h += 32) {
        const int c = gs->cnt[h + lane];
        const unsigned b = __ballot_sync(FULL, c > 0);
        const int nc = (c + S::ROWS - 1) / S::ROWS;
        if (c > 0) {
          const int j = np + __popc(b & ((1u << lane) - 1u));
          gs->ex[j] = h + lane;
          gs->nck[j] = nc;
        }
        np += __popc(b);
        chunks += __reduce_add_sync(FULL, nc);
      }
      if (lane == 0) {
        gs->ex[np] = 0;
        gs->nck[np] = 1 << 30;
        gs->units = chunks * ntiles;
      }
    }
    __syncthreads();
    const long long U = gs->units;
    const int ub = (int)(U * blockIdx.x / gridDim.x);
    ntile = (int)(U * (blockIdx.x + 1) / gridDim.x) - ub;
    if (ntile == 0) return;              // the whole block leaves
    uw.start(gs, ub, ntiles);
    lw = uw;
  }
  // row r of the block's x and output
  auto xrow = [&](int r) { return GATHER ? gs->rows[r] : m0 + r; };

  // x's stage st (groups gb + st*SG ..) into buffer b: row r, field q is
  // the run [q*P*SG, (q+1)*P*SG) of the row
  auto stage = [&](int st, int b) {
    unsigned char* buf = smem + (size_t)b * mcap * RSB;
    const int G0 = st * SG;
    if (vec) {
      constexpr int EPC = 16 / (int)sizeof(T);   // values a copy
      const int cpr = P * min(SG, Gk - G0) / EPC;   // copies a run
      const int total = mr * NQ * cpr;
      // copy c is copy k of run rq = r*NQ + q; c steps by THREADS
      const int drq = THREADS / cpr, dk = THREADS - drq * cpr;
      int rq = threadIdx.x / cpr, k = threadIdx.x - rq * cpr;
      for (int c = threadIdx.x; c < total; c += THREADS) {
        const int r = rq / NQ, q = rq % NQ;
        const T* src = x + (size_t)xrow(r) * K + (size_t)q * P * Gp +
                       (size_t)P * (gb + G0) + k * EPC;
        T* dst = reinterpret_cast<T*>(buf + r * RSB) + q * P * SG + k * EPC;
        tc::cp_async16(dst, src, true);
        rq += drq;
        k += dk;
        if (k >= cpr) {
          k -= cpr;
          ++rq;
        }
      }
    } else {
      const int gs = min(SG, nslab * SLAB - G0);  // whole slabs, zero past Gk
      const int run = P * gs, total = mr * NQ * run;
      for (int c = threadIdx.x; c < total; c += THREADS) {
        const int r = c / (NQ * run), rem = c - r * NQ * run;
        const int q = rem / run, e = rem - q * run;
        T* dst = reinterpret_cast<T*>(buf + r * RSB) + q * P * SG + e;
        *dst = G0 + e / P < Gk
                   ? x[(size_t)xrow(r) * K + (size_t)q * P * Gp +
                       (size_t)P * (gb + G0) + e]
                   : tc::zero_val<T>();
      }
    }
    tc::cp_async_commit();
  };
  // the lane's words (per m16 tile, as the policy lays them out) of the
  // next item to load: tile pk of the block, stage pst, the warp's pl-th
  // slab of the stage (pst*spst + pl*WK + wk); zero past the chunk's
  // groups and past the block's last item. Counters, not divisions, walk
  // the items: within a tile the slab steps by WK, which the policy's Walk
  // follows.
  int pk = 0, pst = 0, pl = 0;
  typename C::Walk walk(planes, S::WK, gb + wk * SLAB + 4 * t);
  // a row map: the planes of the loads' unit (its expert's)
  [[maybe_unused]] typename C::Planes lpl;
  if constexpr (GATHER) lpl = C::at(planes, gs->ex[lw.j], q_out, Gp);
  auto load_next = [&](uint4 (&wv)[MTW][NW], uint32_t& cx) {
    const int s = pst * spst + pl * S::WK + wk;
    const int c = s * SLAB + 4 * t;
    const bool ok = pk < ntile && s < nslab && c < Gk;
    if constexpr (GATHER) {
      const int n0 = lw.tile * S::BN + wn * S::WCH;
      cx = C::ctx(walk, gb + c, lpl);
      C::load(wv, lpl, n0, g, gb + c, walk, q_out, Gp, ok);
    } else {
      const int n0 = (tb + pk * tstep) * S::BN + wn * S::WCH;
      cx = C::ctx(walk, gb + c, planes);
      C::load(wv, planes, n0, g, gb + c, walk, q_out, Gp, ok);
    }
    if (++pl == per) {
      pl = 0;
      if (++pst == nstage) {
        pst = 0;
        ++pk;
        if constexpr (GATHER) {
          lw.next(gs, ntiles);
          if (lw.tile == 0) lpl = C::at(planes, gs->ex[lw.j], q_out, Gp);
        }
      }
    }
    walk.next(pl == 0 && pst == 0);    // a new tile walks from its start
  };
  const bool sums = C::ROWSUMS && wn == 0;   // these warps take the row sums

  // x's stages alternate between two buffers (gst counts them), or stay
  // in one when resident; the words stream PF items ahead in registers
  int gst = 0;
  uint4 wbuf[PF + 1][MTW][NW];
  uint32_t cbuf[PF + 1];
  if (!GATHER) stage(0, 0);
#pragma unroll
  for (int p = 0; p < PF; ++p) load_next(wbuf[p], cbuf[p]);
  for (int k = 0; k < ntile; ++k) {
    const bool last_tile = k + 1 == ntile;
    // a row map: a new chunk lists its rows and stages its x (the last
    // tile's readers of the rows, the reduce and x done first); the next
    // tile's x is staged ahead only within a chunk
    bool regroup = false, next_regroup = false;
    if constexpr (GATHER) {
      regroup = k == 0 || uw.tile == 0;
      next_regroup = uw.tile + 1 == ntiles;
      if (regroup) {
        __syncthreads();
        const int e = gs->ex[uw.j], lo = uw.c * S::ROWS;
        if (warp == 0) {
          int count = 0;
          for (int r0 = 0; r0 < m && count < lo + S::ROWS; r0 += 32) {
            const int r = r0 + lane;
            const bool hit = r < m && __ldg(planes.eids + r) == e;
            const unsigned b = __ballot_sync(FULL, hit);
            const int o = count + __popc(b & ((1u << lane) - 1u));
            if (hit && o >= lo && o < lo + S::ROWS) gs->rows[o - lo] = r;
            count += __popc(b);
          }
        }
        __syncthreads();
        mr = min(S::ROWS, gs->cnt[e] - lo);
        stage(0, gst & 1);
      }
    }
    float tot[MTW][NT][4], rtot[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      rtot[nt][0] = rtot[nt][1] = 0.f;
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[mt][nt][e] = 0.f;
    }
    for (int sg = 0; sg < nstage; ++sg) {
      if (!resident || k == 0 || regroup) {
        // a new stage: it has landed, and the other buffer's readers are
        // done; then the next stage (of this tile or the next) streams in
        tc::cp_async_wait<0>();
        __syncthreads();
        if (sg + 1 < nstage)
          stage(sg + 1, (gst + 1) & 1);
        else if (!resident && !last_tile && !next_regroup)
          stage(0, (gst + 1) & 1);
      }
      const unsigned char* xb = smem + (size_t)(gst & 1) * mcap * RSB;
      for (int l = 0; l < per; ++l) {
        load_next(wbuf[PF], cbuf[PF]);
        const int ls = l * S::WK + wk;             // the slab in the stage
        const int s = sg * spst + ls;
        if (s < nslab) {
          // this lane's x: row nt*8 + g, groups 4t.. of the slab, field q at
          // q*P*SG + P*(ls*16 + 4t)
          const T* xr[NT];
          bool live[NT];
  #pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int r = nt * 8 + g;
            live[nt] = r < mr;
            xr[nt] = reinterpret_cast<const T*>(xb +
                                                (size_t)min(r, mr - 1) * RSB)
                     + P * (ls * SLAB + 4 * t);
          }
          // the group sums gx of the lane's 4 groups (row nt*8 + g), bf16
          [[maybe_unused]] float gx[C::PARITY ? NT : 1][4];
  #pragma unroll
          for (int s0 = 0; s0 < NSETS; s0 += FS) {
            // a pass takes FS sets, each its own accumulator
            float acc[FS][MTW][NT][4], racc[NT][4];
            XRun<T, P> run[NT];
            typename C::Pass pd[FS][MTW];
  #pragma unroll
            for (int f = 0; f < FS; ++f)
  #pragma unroll
              for (int mt = 0; mt < MTW; ++mt)
                pd[f][mt] = C::pass(wbuf[0][mt], s0 + f, cbuf[0]);
  #pragma unroll
            for (int ks = 0; ks < 8; ++ks) {
              // k-step ks is field q = ks / P, values 4u..4u+3 of the run
              // (u = ks % P: B registers rho = 2ks, 2ks + 1)
              const int u = ks % P;
              if (!XRun<T, P>::WHOLE || u == 0) {
  #pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                  if (live[nt])
                    run[nt].load(xr[nt] + (ks / P) * P * SG +
                                 (XRun<T, P>::WHOLE ? 0 : 4 * u));
                  else
                    run[nt].zero();
                }
              }
              if constexpr (C::PARITY) {
                // at P = 1 k-step ks is position i = ks: gx sums the 8
                // positions left to right, each add rounded to bf16 as the
                // Pallas body's bf16 sum
                if (s0 == 0) {
  #pragma unroll
                  for (int nt = 0; nt < NT; ++nt)
  #pragma unroll
                    for (int e = 0; e < 4; ++e) {
                      const float v = run[nt].value(e);
                      gx[nt][e] = ks == 0 ? v : add_bf16(gx[nt][e], v);
                    }
                }
              }
              const int pr = XRun<T, P>::WHOLE ? 2 * u : 0;
              uint32_t b[NT][2][TERMS];
  #pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                run[nt].template b_reg<TERMS>(pr, b[nt][0]);
                run[nt].template b_reg<TERMS>(pr + 1, b[nt][1]);
              }
  #pragma unroll
              for (int f = 0; f < FS; ++f)
  #pragma unroll
                for (int mt = 0; mt < MTW; ++mt) {
                  uint32_t a[4];
                  C::a_frag(wbuf[0][mt], pd[f][mt], s0 + f, ks, a);
  #pragma unroll
                  for (int nt = 0; nt < NT; ++nt)
  #pragma unroll
                    for (int q = 0; q < TERMS; ++q) {
                      const uint32_t bb[2] = {b[nt][0][q], b[nt][1][q]};
                      if (ks == 0 && q == 0)
                        tc::mma_first(acc[f][mt][nt], a, bb);
                      else
                        tc::mma_acc(acc[f][mt][nt], a, bb);
                    }
                }
              if (s0 == 0 && sums) {
                const uint32_t a[4] = {ONES, ONES, ONES, ONES};
  #pragma unroll
                for (int nt = 0; nt < NT; ++nt)
  #pragma unroll
                  for (int q = 0; q < TERMS; ++q) {
                    const uint32_t bb[2] = {b[nt][0][q], b[nt][1][q]};
                    if (ks == 0 && q == 0)
                      tc::mma_first(racc[nt], a, bb);
                    else
                      tc::mma_acc(racc[nt], a, bb);
                  }
              }
            }
            // one more k-step over the slab's 16 groups: A the set's
            // parity term (bf16, exact), B the bf16 group sums
            [[maybe_unused]] uint32_t gb[C::PARITY ? NT : 1][2];
            if constexpr (C::PARITY) {
  #pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                gb[nt][0] = tc::bf16x2_bits(
                    __floats2bfloat162_rn(gx[nt][0], gx[nt][1]));
                gb[nt][1] = tc::bf16x2_bits(
                    __floats2bfloat162_rn(gx[nt][2], gx[nt][3]));
              }
            }
  #pragma unroll
            for (int f = 0; f < FS; ++f) {
              const int st = s0 + f;
              if constexpr (C::PARITY) {
  #pragma unroll
                for (int mt = 0; mt < MTW; ++mt) {
                  uint32_t a[4];
                  C::p_frag(wbuf[0][mt], st, cbuf[0], a);
  #pragma unroll
                  for (int nt = 0; nt < NT; ++nt)
                    tc::mma_acc(acc[f][mt][nt], a, gb[nt]);
                }
              }
              const float alpha = st == 0 ? alpha0 : alpha1;
  #pragma unroll
              for (int mt = 0; mt < MTW; ++mt)
  #pragma unroll
                for (int nt = 0; nt < NT; ++nt)
  #pragma unroll
                  for (int e = 0; e < 4; ++e)
                    tot[mt][nt][e] = fmaf(alpha, acc[f][mt][nt][e],
                                          tot[mt][nt][e]);
            }
            if (s0 == 0 && sums) {
  #pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                rtot[nt][0] += racc[nt][0];
                rtot[nt][1] += racc[nt][1];
              }
            }
          }
        }
  #pragma unroll
        for (int p = 0; p < PF; ++p) {
          cbuf[p] = cbuf[p + 1];
  #pragma unroll
          for (int mt = 0; mt < MTW; ++mt)
  #pragma unroll
            for (int j = 0; j < NW; ++j) wbuf[p][mt][j] = wbuf[p + 1][mt][j];
        }
      }
      if (!resident) ++gst;      // the stage is done
    }

    // the WK partial sums meet in shared memory: red[wk][row][channel],
    // then rs[wk][row] (after the last tile's readers of red are done)
    __syncthreads();
    // C fragment: A row g (+8 for e >= 2), rows 2t, 2t+1 of x of each n8
    // tile; A row g is channel g, or 2g for row-pair words
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ch = wn * S::WCH + mt * 16 +
                         (C::PAIR_ROWS ? 2 * g + (e >> 1) : g + 8 * (e >> 1));
          const int row = nt * 8 + 2 * t + (e & 1);
          red[(wk * S::ROWS + row) * S::RED_STRIDE + ch] = tot[mt][nt][e];
        }
    if (sums && g == 0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        rs[wk * S::ROWS + nt * 8 + 2 * t] = rtot[nt][0];
        rs[wk * S::ROWS + nt * 8 + 2 * t + 1] = rtot[nt][1];
      }
    }
    __syncthreads();
    const int tile = GATHER ? uw.tile : tb + k * tstep, nb = tile * S::BN;
    for (int o = threadIdx.x; o < mr * S::BN; o += THREADS) {
      const int row = o / S::BN, ch = o - row * S::BN, n = nb + ch;
      if (n >= q_out) continue;
      float v = 0.f, r = 0.f;
#pragma unroll
      for (int q = 0; q < S::WK; ++q) {
        v += red[(q * S::ROWS + row) * S::RED_STRIDE + ch];
        if (C::ROWSUMS) r += rs[q * S::ROWS + row];
      }
      if (C::ROWSUMS) v += beta_total * r;
      const size_t off = (size_t)xrow(row) * q_out + n;
      if (KS) {      // the chunk's partial; a second kernel adds them
        ws[(size_t)chunk * m * q_out + off] = v;
        continue;
      }
      if (scale != nullptr) v *= __ldg(scale + n);
      tc::store1(out + off, v);
    }
    if constexpr (GATHER) uw.next(gs, ntiles);
  }
  tc::cp_async_wait<0>();
}

// Groups a stage: the whole (slab-rounded) row when the block's rows of x
// fit STAGE_BUDGET in one buffer, else the most that two buffers of half
// of it hold (at least one slab a warp; launch_nt keeps the total under
// SMEM_MAX).
template <typename T, int P, int NT, int WN>
int stage_groups(int Gp, int mr) {
  const int unit = Shape<NT, WN>::WK * SLAB;
  const int all = (Gp + unit - 1) / unit * unit;
  if ((size_t)mr * row_bytes<T, P>(all) <= (size_t)STAGE_BUDGET) return all;
  const int fit = (STAGE_BUDGET / 2 / mr - pad_bytes<T, P>()) /
                  (8 * (int)sizeof(T)) / unit * unit;
  return fit < unit ? unit : fit;
}

// Shared memory of a launch: x's stage buffers, the reduce and a row
// map's table.
template <typename T, class C, int NT, int WN>
int smem_bytes(int Gp, int mr) {
  const int SG = stage_groups<T, C::P, NT, WN>(Gp, mr);
  const int nstage = (Gp + SG - 1) / SG;
  return (nstage > 1 ? 2 : 1) * mr * row_bytes<T, C::P>(SG) +
         Shape<NT, WN, C::mtiles(NT)>::RED_B +
         (gathers<C>::value ? (int)sizeof(GatherSmem) : 0);
}

// The card's SMs (0 when the query fails), once.
inline int sm_count() {
  static int sms = -1;
  if (sms < 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 0;
  }
  return sms;
}

// What a launch is given besides x, the planes and the output; split-K
// adds its chunks and the f32 workspace (chunks, m, q_out).
struct Args {
  const void* scale;
  void* out;
  int m, q_out, Gp;
  float alpha0, alpha1, beta_total;
  int chunks;
  void* ws;
};

// The blocks of an instantiation the card holds at once at smem bytes of
// shared memory, into *blocks; returns a CUDA error (0 on success). Once
// per instantiation it sets the shared-memory limit; the count is kept for
// the last smem asked.
template <typename T, class C, int NT, int WN, bool KS = false>
int resident(int smem, int* blocks) {
  auto kernel = mma_small_kernel<T, C, NT, WN, KS>;
  static bool smem_set = false;
  static int last_smem = -1, resident_blocks = 0;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (sm_count() < 1) return static_cast<int>(cudaErrorInvalidDevice);
    smem_set = true;
  }
  if (smem != last_smem) {
    int per_sm = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, THREADS, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident_blocks = per_sm * sm_count();
    last_smem = smem;
  }
  *blocks = resident_blocks;
  return 0;
}

// The chunks of ROWS rows that m rows routed among E experts can make at
// most: each expert present has one with fewer than ROWS rows.
__host__ __device__ constexpr int gather_chunks(int m, int E, int ROWS) {
  return (E < m ? E : m) + m / ROWS;
}

template <typename T, class C, int NT, int WN, bool KS = false>
int launch(const void* x, const typename C::Planes& planes, const Args& a,
           cudaStream_t stream) {
  using S = Shape<NT, WN, C::mtiles(NT)>;
  constexpr bool GATHER = gathers<C>::value;
  const int mr = a.m < (GATHER ? S::ROWS : MAX_ROWS)
                     ? a.m : (GATHER ? S::ROWS : MAX_ROWS);
  // a tile's chunks: split-K's of the groups, a row map's of the rows
  int nch = KS ? a.chunks : 1;
  if constexpr (GATHER) nch = gather_chunks(a.m, planes.E, S::ROWS);
  const int Gk = a.Gp / (KS ? nch : 1);      // groups a block stages
  const int SG = stage_groups<T, C::P, NT, WN>(Gk, mr);
  const int smem = smem_bytes<T, C, NT, WN>(Gk, mr);
  int resident_blocks = 0;
  const int err = resident<T, C, NT, WN, KS>(smem, &resident_blocks);
  if (err != 0) return err;
  // as many blocks as the card holds at once (at most one a unit of
  // work: a tile, or a tile's chunk), each walking every gridDim.x-th
  // unit (a row map: a run of consecutive units); split-K rounds the grid
  // to whole multiples of the chunks
  const int ntiles = (a.q_out + S::BN - 1) / S::BN;
  int blocks = ntiles * nch < resident_blocks ? ntiles * nch
                                              : resident_blocks;
  if (KS) blocks = blocks < nch ? nch : blocks / nch * nch;
  const dim3 grid(blocks, GATHER ? 1 : (a.m + MAX_ROWS - 1) / MAX_ROWS);
  mma_small_kernel<T, C, NT, WN, KS><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), planes, static_cast<const float*>(a.scale),
      static_cast<T*>(a.out), a.m, a.q_out, a.Gp, SG, a.alpha0, a.alpha1,
      a.beta_total, nch, static_cast<float*>(a.ws));
  return static_cast<int>(cudaGetLastError());
}

// NT n8 tiles for m rows (a block takes at most 32), and above 8 rows two
// channel warps when even 64-channel tiles give every SM two blocks (the
// x traffic then matters more than the fill), else one. A row map takes
// one n8 tile (chunks of 8 rows) at every m: on an H100 at Mixtral-8x7B's
// 31-token prefill (about 8 rows an expert) 4 and 2 tiles a block took
// 1.97x and 1.38x the time of one (their x no longer resident in shared
// memory, restaged a tile), more than the planes an expert of over 8 rows
// reads again a chunk.
template <typename T, class C>
int launch_nt(const void* x, const typename C::Planes& planes, const Args& a,
              cudaStream_t s) {
  if constexpr (gathers<C>::value) {
    return launch<T, C, 1, 1>(x, planes, a, s);
  } else {
    const int mr = a.m < MAX_ROWS ? a.m : MAX_ROWS;
    const bool wide = (a.q_out + 2 * WCH - 1) / (2 * WCH) >= 2 * sm_count();
    if (a.m <= 8) return launch<T, C, 1, 1>(x, planes, a, s);
    // (and when one channel warp's slab stages of f32 x would not fit)
    if (a.m <= 16 && (wide || smem_bytes<T, C, 2, 1>(a.Gp, mr) > SMEM_MAX))
      return launch<T, C, 2, 2>(x, planes, a, s);
    if (a.m <= 16) return launch<T, C, 2, 1>(x, planes, a, s);
    if (wide || smem_bytes<T, C, 4, 1>(a.Gp, mr) > SMEM_MAX)
      return launch<T, C, 4, 2>(x, planes, a, s);
    return launch<T, C, 4, 1>(x, planes, a, s);
  }
}

template <typename T, class C, int NT>
int launch_ks_wn(int wn, const void* x, const typename C::Planes& planes,
                 const Args& a, cudaStream_t s) {
  if (wn == 1) return launch<T, C, NT, 1, true>(x, planes, a, s);
  if (wn == 2) return launch<T, C, NT, 2, true>(x, planes, a, s);
  return launch<T, C, NT, 4, true>(x, planes, a, s);
}

// Split-K: whether the (tile, chunk) split runs, into *split. Above 8
// rows it always does. At one n8 tile of rows it does only where K1's
// whole tiles (32 channels, one channel warp) leave a last wave at most
// half full on the card: elsewhere a split unit's workspace store and the
// reduce launch cost more than the tail it fills (on an H100 at m = 1 and
// 8 the split beat K1 on the 384 tiles of a 7B model's qkv and lost on o's
// 128, gate/up's 688 and the head's 1000, with 264 resident blocks).
template <typename T, class C>
int split_pays(const Args& a, bool* split) {
  *split = true;
  if (a.m > 8) return 0;
  int rb = 0;
  const int err = resident<T, C, 1, 1>(smem_bytes<T, C, 1, 1>(a.Gp, a.m),
                                       &rb);
  if (err != 0) return err;
  const int ntiles = (a.q_out + WCH - 1) / WCH, tail = ntiles % rb;
  *split = ntiles > rb && tail > 0 && 2 * tail <= rb;
  return 0;
}

// Split-K with the split on: NT n8 tiles for m rows as launch_nt, and the
// fewest channel warps WN (of 1, 2, 4) that give a warp at least 2 of its
// chunk's slabs a unit up to 16 rows, 4 above, where a unit's epilogue
// (its partials through shared memory and out to the workspace) grows
// with the rows. Finer units balance the grid better: on an H100, 64-
// channel units beat 32 and 128 at m = 1 and 8, and 128 beat 64 and 32 at
// m = 32.
template <typename T, class C>
int launch_ks(const void* x, const typename C::Planes& planes, const Args& a,
              cudaStream_t s) {
  const int spc = a.Gp / a.chunks / SLAB;        // slabs a chunk
  const int want = 8 * (a.m <= 16 ? 2 : 4);      // spc * wn / 8 >= per warp
  const int wn = spc >= want ? 1 : 2 * spc >= want ? 2 : 4;
  if (a.m <= 8) return launch_ks_wn<T, C, 1>(wn, x, planes, a, s);
  if (a.m <= 16) return launch_ks_wn<T, C, 2>(wn, x, planes, a, s);
  return launch_ks_wn<T, C, 4>(wn, x, planes, a, s);
}

// The launch for n_sets plane sets and x's dtype; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for shapes
// the kernel does not take (the Python wrappers check them first).
template <int P>
int dispatch(const void* x, const void* w0, const void* w1,
             const void* scale, void* out, int m, int q_out, int Gp,
             int n_sets, float alpha0, float alpha1, float beta_total,
             int x_is_bf16, void* stream) {
  if (m < 1 || q_out < 1 || Gp < 4 || Gp % 4 || n_sets < 1 || n_sets > 2 ||
      (n_sets == 2 && w1 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{scale, out, m, q_out, Gp, alpha0, alpha1, beta_total};
  const typename NibbleCodes<1, P>::Planes p1{
      static_cast<const uint32_t*>(w0), static_cast<const uint32_t*>(w1)};
  const typename NibbleCodes<2, P>::Planes p2{p1.w0, p1.w1};
  if (n_sets == 1 && x_is_bf16)
    return launch_nt<__nv_bfloat16, NibbleCodes<1, P>>(x, p1, a, s);
  if (n_sets == 1) return launch_nt<float, NibbleCodes<1, P>>(x, p1, a, s);
  if (x_is_bf16)
    return launch_nt<__nv_bfloat16, NibbleCodes<2, P>>(x, p2, a, s);
  return launch_nt<float, NibbleCodes<2, P>>(x, p2, a, s);
}

}  // namespace sm
}  // namespace
