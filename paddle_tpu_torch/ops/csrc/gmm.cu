// gmm, the grouped GEMM of the MoE experts, forward and backward, for
// Hopper (sm_90a).
//
// Replaces:
//   paddle_tpu/ops/pallas_gmm.py:gmm  (a jax.custom_vjp of three Pallas
//     calls: the forward _gmm_kernel; the backward's dlhs, the same kernel
//     against swapaxes(rhs, 1, 2); the backward's drhs, _tgmm_kernel)
//
// Contract (the TPU kernels'): lhs [M, K] with rows grouped contiguously,
// rhs [G, K, N], group ends [G] (the cumsum of the group sizes, computed on
// the card by the wrapper); out[m] = lhs[m] @ rhs[g(m)] in lhs's dtype,
// accumulated in f32; rows past the last group's end match no group and
// come out zero. dlhs [M, K] = dout [M, N] times rhs[g(m)] read as [N, K]
// (the same contract, tail rows zero). drhs [G, K, N]: drhs[g] = the sum
// over the rows r of group g of lhs[r]^T dout[r]; an empty group's slab is
// zero; rows past the last group add nothing.
//
// Bound on the H100 (3.35 TB/s HBM, 989 TFLOP/s bf16): at the MoE serving
// step the expert weights are what moves, the [2560, 1536] gate or up slab
// (7.9 MB) of each of ERNIE-4.5-21B-A3B's experts that holds rows, once,
// against 6.2 GFLOP of bf16 products at the unified step's M = 132 x 6 =
// 792 (0.006 ms): bytes-bound; the down product [1536 -> 2560] the same.
// A mixed step (all 132 rows live) reaches all 64 experts: 503 MB, 0.150
// ms. A decode step has 4 live rows; its 128 padding rows share one FFN
// input and route to the same 6 experts, so at most 30 experts hold rows:
// <= 236 MB, 0.070 ms. At generate_cached's prefill (M = 4 x 512 x 6 =
// 12288) the weights are still the larger term (0.18 ms against 0.098 ms
// of products). In training (4096 tokens top-6: M = 24576) each of the
// three products (forward, dlhs, drhs) is 193 GFLOP against ~0.70 GB of
// rows and slabs: operations-bound, 0.195 ms at the bf16 peak.
//
// bf16 design (Hopper: wgmma, TMA, mbarriers; the helpers and the layout
// convention live in sm90.cuh). This replaces a first port whose blocks
// each owned a whole group (grid (G, N / 128)) and walked its 64-row tiles
// one after another, re-reading the group's weight slab for each, with
// mma.sync m16n8k16 fed by ldmatrix and cp.async issued by the computing
// warps: the largest group set the tail, at 11.5% of the bf16 peak.
// - A block is two consumer warpgroups and one producer warp (288
//   threads, one block an SM, up to 224 registers a thread; ptxas gives a
//   384-thread block 168, too few beside BN 256 of f32 accumulators).
//   The producer's lane 0 keeps a ring of 4 shared-memory stages filled by
//   TMA (full / empty mbarriers); each consumer warp releases a stage once
//   the products that read it are complete. Loads run ahead across items,
//   so one item's epilogue overlaps the next one's loads.
// - The grid is persistent: min(SMs, (ceil(M / BM) + G) x N tiles),
//   shapes only. Its blocks stride over work items in order. A work item
//   is (group g, a BM-row tile of g starting at start_g + i BM, a BN-column
//   tile), row tiles group after group, column tiles fastest, so a large
//   group's tiles run in parallel and the blocks in flight share a few
//   groups' slabs in L2. The items are found on the card: each warp walks
//   the group ends 32 groups at a time (a warp scan of the groups' row-tile
//   counts) and only forward, since a block's items increase. Empty groups
//   make no item; nothing is read back to the host.
// - Forward / dlhs (one kernel, the weight's major a template parameter).
//   lhs is a 2-D map [M, K]: a box starts at the tile's first row, which
//   may be any row; rows of the next group are loaded and multiplied but
//   never stored, rows past M are zeros from the map. The weight stack is a
//   3-D map, [G, K, N] (forward) or [G, N, K] (dlhs: rhs read in place as
//   its transpose, no copy), so a box past K or N is zero-filled and never
//   reaches the next expert's rows. Each warpgroup runs wgmma m64n256k16 on
//   its 64 rows, A K-major, B MN-major in the forward (the [K, N] rows) and
//   K-major in dlhs (the [N, K] rows): the instruction's transpose bit.
//   BN 256 measured faster than 128 at every routing but the decode step's
//   gate / up product (gmm_limits.py --variants). A warpgroup with no live
//   row skips its products. The f32 accumulators are cast once to bf16
//   into a swizzled shared-memory buffer, 128 columns at a time; a
//   warpgroup's tile wholly inside its group goes out by TMA stores that
//   overlap the next item's products, one that ends past the group by
//   16-byte stores of rows [row0, end_g) only. Rows past the last group's
//   end are zeroed. A bf16 x bf16 product is exact in f32, so the result
//   equals the plain version up to summation order.
// - tgmm (drhs). A work item is (group, 128 rows of K, 256 columns of N):
//   G x ceil(K / 128) x ceil(N / 256) items, every group's included, since
//   an empty group writes its zero slab (the output is torch.empty). It
//   reduces over the group's rows in 64-row chunks starting at start_g.
//   A is lhs^T: the lhs rows [64 r][64 k] of each warpgroup, read as an
//   MN-major A; B is the dout rows [64 r][256 n], MN-major too. The group's
//   last chunk holds rows of the next group: each warpgroup zeroes those
//   rows of its A box in shared memory, then fences the generic writes
//   against the async proxy before its products (rows past M are zeros
//   from the map). The products multiply those dout rows by zero, so a
//   non-finite dout row of the next group would reach this group's sums
//   as NaN. The slab tile goes out through the shared-memory buffer by TMA
//   stores, clipped past K and N, while the next item's products run.
// f32 runs on the CUDA cores in true f32 (FMA, no TF32), so the card is
// held to the plain f32 version at 2e-5: cp.async rings, a block per
// (group, 128-column tile) walking the group's 64-row tiles (forward,
// dlhs) or per (group, 64 rows of K, 128 columns of N) walking the
// group's rows (tgmm).
//
// Shape gate (the wrapper's): rows of 16 bytes, i.e. K and N multiples of
// 8 in bf16 and of 4 in f32, and 16-byte aligned tensors. The TPU gate
// (K and N multiples of 128) does not apply.

#include <algorithm>

#include "sm90.cuh"

namespace ptt {
namespace gmm {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------------ f32
// Forward / dlhs tiles: BM rows by BN columns, BK deep a ring stage.
template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int NT = 256;  // 16 x 16 threads, 4 x 8 outputs each
  static constexpr int BM = 64, BN = 128, BK = 32, PAD = 4, STAGES = 3;
};

// Shared-memory geometry of a stage: the lhs tile [BM][BK + PAD], then the
// weight chunk, [BK][BN + PAD] as the forward's [K, N] rows lie, or with
// WT (dlhs: the weight read as [N, K]) [BN][BK + PAD], one row per output
// column with the reduction axis contiguous.
template <typename T, bool WT>
struct Geo {
  using C = Cfg<T>;
  static constexpr int VE = 16 / sizeof(T);  // elements of a 16-byte copy
  static constexpr int LDA = C::BK + C::PAD;
  static constexpr int LDW = WT ? C::BK + C::PAD : C::BN + C::PAD;
  static constexpr int A_ELEMS = C::BM * LDA;
  static constexpr int W_ELEMS = WT ? C::BN * LDW : C::BK * LDW;
  static constexpr int STAGE_ELEMS = A_ELEMS + W_ELEMS;
  static constexpr size_t SMEM = (size_t)C::STAGES * STAGE_ELEMS * sizeof(T);
};

// One K chunk [k0, k0 + BK) of the row tile's lhs rows (the first `live`
// rows; `rows` of them real) and of the group's weight columns into a
// stage; what lies past the rows, K or N is zero-filled. W is the group's
// slab: [K, N] row-major, or with WT [N, K] row-major.
template <typename T, bool WT>
__device__ __forceinline__ void load_stage(T* st, const T* lhs, const T* W,
                                           int m0, int rows, int live, int n0,
                                           int k0, int K, int N) {
  using C = Cfg<T>;
  using G = Geo<T, WT>;
  constexpr int AROW = C::BK / G::VE;
  for (int c = threadIdx.x; c < live * AROW; c += C::NT) {
    const int r = c / AROW, kc = (c % AROW) * G::VE;
    const int k = k0 + kc;
    const bool ok = r < rows && k < K;
    cp_async16(st + r * G::LDA + kc,
               ok ? lhs + (size_t)(m0 + r) * K + k : lhs, ok);
  }
  T* sw = st + G::A_ELEMS;
  if constexpr (WT) {
    for (int c = threadIdx.x; c < C::BN * AROW; c += C::NT) {
      const int r = c / AROW, kc = (c % AROW) * G::VE;
      const int k = k0 + kc, n = n0 + r;
      const bool ok = k < K && n < N;
      cp_async16(sw + r * G::LDW + kc, ok ? W + (size_t)n * K + k : W, ok);
    }
  } else {
    constexpr int WROW = C::BN / G::VE;
    for (int c = threadIdx.x; c < C::BK * WROW; c += C::NT) {
      const int r = c / WROW, nc = (c % WROW) * G::VE;
      const int k = k0 + r, n = n0 + nc;
      const bool ok = k < K && n < N;
      cp_async16(sw + r * G::LDW + nc, ok ? W + (size_t)k * N + n : W, ok);
    }
  }
}

// Thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i (i < 4) and
// columns tx + 16 j (j < 8) of the tile.
struct AccF32 {
  float acc[4][8];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  template <bool WT>
  __device__ void step(const float* st) {
    using G = Geo<float, WT>;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    const float* w = st + G::A_ELEMS;
#pragma unroll 4
    for (int kk = 0; kk < Cfg<float>::BK; ++kk) {
      float av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = st[(ty + 16 * i) * G::LDA + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float wv = WT ? w[(tx + 16 * j) * G::LDW + kk]
                            : w[kk * G::LDW + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(av[i], wv, acc[i][j]);
      }
    }
  }

  // tgmm: output rows (K) from the lhs rows' columns, output columns (N)
  // from dout's, one reduction row at a time.
  template <int BR, int LDL, int LDD, int L_ELEMS>
  __device__ void tstep(const float* st) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    const float* d = st + L_ELEMS;
#pragma unroll 4
    for (int r = 0; r < BR; ++r) {
      float av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = st[r * LDL + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float dv = d[r * LDD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(av[i], dv, acc[i][j]);
      }
    }
  }

  __device__ void store(float* out, int m0, int rows, int n0, int N) const {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      if (row >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + tx + 16 * j;
        if (col < N) out[(size_t)(m0 + row) * N + col] = acc[i][j];
      }
    }
  }
};

// The forward (WT false) and dlhs (WT true): out [M, N] from lhs [M, K]
// and the group's slab, [K, N] or, with WT, [N, K].
template <typename T, bool WT>
__global__ void __launch_bounds__(Cfg<T>::NT)
    gmm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
               const int* __restrict__ ends, T* __restrict__ out, int M,
               int K, int N, int G) {
  using C = Cfg<T>;
  using Gm = Geo<T, WT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int g = blockIdx.x;
  const int n0 = blockIdx.y * C::BN;
  const int end = min(max(ends[g], 0), M);
  const int start = g == 0 ? 0 : min(max(ends[g - 1], 0), end);
  if (g == G - 1) {
    // rows past the last group: zero, in this block's columns
    constexpr int PIECES = C::BN / Gm::VE;
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (size_t c = threadIdx.x; c < (size_t)(M - end) * PIECES;
         c += C::NT) {
      const int r = end + (int)(c / PIECES);
      const int n = n0 + (int)(c % PIECES) * Gm::VE;
      if (n < N) *reinterpret_cast<uint4*>(out + (size_t)r * N + n) = z;
    }
  }
  if (end <= start) return;
  const T* W = rhs + (size_t)g * K * N;
  const int nk = (K + C::BK - 1) / C::BK;
  AccF32 acc;
  for (int m0 = start; m0 < end; m0 += C::BM) {
    const int rows = min(C::BM, end - m0);
    const int tiles = (rows + 15) / 16;
    acc.zero();
#pragma unroll
    for (int s = 0; s < C::STAGES - 1; ++s) {
      if (s < nk)
        load_stage<T, WT>(smem + s * Gm::STAGE_ELEMS, lhs, W, m0, rows,
                          tiles * 16, n0, s * C::BK, K, N);
      cp_async_commit();
    }
    for (int kc = 0; kc < nk; ++kc) {
      cp_async_wait<C::STAGES - 2>();
      __syncthreads();
      // the stage consumed in the previous iteration takes chunk
      // kc + STAGES - 1: every thread has passed the barrier, so it is
      // done reading it
      const int nx = kc + C::STAGES - 1;
      if (nx < nk)
        load_stage<T, WT>(smem + (nx % C::STAGES) * Gm::STAGE_ELEMS, lhs, W,
                          m0, rows, tiles * 16, n0, nx * C::BK, K, N);
      cp_async_commit();
      acc.template step<WT>(smem + (kc % C::STAGES) * Gm::STAGE_ELEMS);
    }
    cp_async_wait<0>();
    __syncthreads();  // the next row tile's loads reuse the ring
    acc.store(out, m0, rows, n0, N);
  }
}

// tgmm tiles: BKO rows of K by BN columns of N an output tile, BR rows of
// the reduction (the group's rows) a ring stage.
template <typename T>
struct TCfg;
template <>
struct TCfg<float> {
  static constexpr int NT = 256;
  static constexpr int BKO = 64, BN = 128, BR = 32, PAD = 4, STAGES = 3;
};

template <typename T>
struct TGeo {
  using C = TCfg<T>;
  static constexpr int VE = 16 / sizeof(T);
  static constexpr int LDL = C::BKO + C::PAD;  // lhs rows [BR][LDL]
  static constexpr int LDD = C::BN + C::PAD;   // dout rows [BR][LDD]
  static constexpr int L_ELEMS = C::BR * LDL;
  static constexpr int STAGE_ELEMS = L_ELEMS + C::BR * LDD;
  static constexpr size_t SMEM = (size_t)C::STAGES * STAGE_ELEMS * sizeof(T);
};

// Rows [r0, r0 + BR) of lhs (columns k0 .. k0 + BKO) and of dout (columns
// n0 .. n0 + BN) into a stage; rows at or past the group's end and columns
// past K or N are zero-filled.
template <typename T>
__device__ __forceinline__ void tload_stage(T* st, const T* lhs,
                                            const T* dout, int r0, int end,
                                            int k0, int K, int n0, int N) {
  using C = TCfg<T>;
  using G = TGeo<T>;
  constexpr int LROW = C::BKO / G::VE, DROW = C::BN / G::VE;
  for (int c = threadIdx.x; c < C::BR * LROW; c += C::NT) {
    const int r = c / LROW, kc = (c % LROW) * G::VE;
    const int row = r0 + r, k = k0 + kc;
    const bool ok = row < end && k < K;
    cp_async16(st + r * G::LDL + kc,
               ok ? lhs + (size_t)row * K + k : lhs, ok);
  }
  T* sd = st + G::L_ELEMS;
  for (int c = threadIdx.x; c < C::BR * DROW; c += C::NT) {
    const int r = c / DROW, nc = (c % DROW) * G::VE;
    const int row = r0 + r, n = n0 + nc;
    const bool ok = row < end && n < N;
    cp_async16(sd + r * G::LDD + nc,
               ok ? dout + (size_t)row * N + n : dout, ok);
  }
}

// drhs [G, K, N] from lhs [M, K] and dout [M, N]: the block's (group, K
// tile, N tile) summed over the group's rows.
template <typename T>
__global__ void __launch_bounds__(TCfg<T>::NT)
    tgmm_kernel(const T* __restrict__ lhs, const T* __restrict__ dout,
                const int* __restrict__ ends, T* __restrict__ drhs, int M,
                int K, int N) {
  using C = TCfg<T>;
  using Tg = TGeo<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int g = blockIdx.x;
  const int k0 = blockIdx.y * C::BKO, n0 = blockIdx.z * C::BN;
  const int row_end = min(max(ends[g], 0), M);
  const int row_start = g == 0 ? 0 : min(max(ends[g - 1], 0), row_end);
  AccF32 acc;
  acc.zero();
  // an empty group walks no chunk and writes its zero accumulators
  const int nr = (row_end - row_start + C::BR - 1) / C::BR;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nr)
      tload_stage<T>(smem + s * Tg::STAGE_ELEMS, lhs, dout,
                     row_start + s * C::BR, row_end, k0, K, n0, N);
    cp_async_commit();
  }
  for (int rc = 0; rc < nr; ++rc) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();
    const int nx = rc + C::STAGES - 1;
    if (nx < nr)
      tload_stage<T>(smem + (nx % C::STAGES) * Tg::STAGE_ELEMS, lhs, dout,
                     row_start + nx * C::BR, row_end, k0, K, n0, N);
    cp_async_commit();
    acc.template tstep<C::BR, Tg::LDL, Tg::LDD, Tg::L_ELEMS>(
        smem + (rc % C::STAGES) * Tg::STAGE_ELEMS);
  }
  cp_async_wait<0>();
  acc.store(drhs + (size_t)g * K * N, k0, min(C::BKO, K - k0), n0, N);
}

// ------------------------------------------------------------------ bf16
using namespace sm90;

constexpr int kWG = 128;                      // a warpgroup
constexpr int kConsumers = 2 * kWG;           // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;     // and the producer warp
constexpr int BM = 128;                       // rows an item (fwd / dlhs)
constexpr int BN = 256;                       // columns an item
constexpr int BK = 64;                        // reduction depth a stage
constexpr int TK = 2 * 64;                    // tgmm: rows of K an item
constexpr int NS = 4;                         // ring stages
// a stage: fwd / dlhs lhs [BM rows][64] + weight [BN][64] or [64][BN];
// tgmm lhs [64 rows][TK] + dout [64 rows][BN]: 48 KB either way
constexpr int A_BYTES = BM * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + BN * BK * 2;
static_assert(TK * 64 * 2 == A_BYTES, "tgmm's stage is the forward's");
// a warpgroup's epilogue buffer: 128 columns of its 64 x BN output tile
// in bf16, two boxes of [64 rows][128 B]
constexpr int EPI_BYTES = 64 * 128 * 2;
constexpr size_t SMEM =
    1024 + (size_t)NS * STAGE_BYTES + 2 * EPI_BYTES + 2 * NS * 8;
static_assert(SMEM <= 232448, "one block an SM");

// The shared-memory base rounded up to the swizzle's 1024 bytes (the
// launch asks for 1024 bytes more than the layout needs).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// Group g's row range [x, y), clamped to M as the f32 kernels clamp it.
__device__ __forceinline__ int2 group_rows(const int* ends, int g, int M) {
  const int end = min(max(ends[g], 0), M);
  const int start = g == 0 ? 0 : min(max(ends[g - 1], 0), end);
  return make_int2(start, end);
}

// The row tiles of BM rows, group after group: a warp's walker finds the
// group that holds global row tile t and the tile's index in it. It keeps
// a window of 32 groups (g0, and `base` row tiles before it) and moves
// only forward, since a block's items increase. Warp-collective: every
// lane calls it with the same t. (-1, 0) past the last row tile.
struct Walk {
  int g0 = 0, base = 0;

  __device__ int2 find(const int* ends, int M, int G, int t) {
    const int lane = threadIdx.x & 31;
    for (;;) {
      const int g = g0 + lane;
      int n = 0;
      if (g < G) {
        const int2 r = group_rows(ends, g, M);
        n = (r.y - r.x + BM - 1) / BM;
      }
      int incl = n;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      // the first lane whose running count passes t holds a row tile
      const unsigned hit = __ballot_sync(0xffffffffu, base + incl > t);
      if (hit) {
        const int l = __ffs(hit) - 1;
        return make_int2(g0 + l,
                         t - base - __shfl_sync(0xffffffffu, incl - n, l));
      }
      base += __shfl_sync(0xffffffffu, incl, 31);
      g0 += 32;
      if (g0 >= G) return make_int2(-1, 0);
    }
  }
};

// Columns 128 HF .. 128 HF + 127 of a warpgroup's 64 x BN f32
// accumulators, cast once to bf16, into its epilogue buffer `eb` as two
// boxes of [64 rows][128 B] in the 128-byte swizzle (TMA's layout; the 8
// rows a store instruction covers fall on 8 different chunks, so no bank
// is hit twice). The caller has made sure the buffer's last reader is
// done.
template <int HF>
__device__ __forceinline__ void stage_half(const float (&acc)[BN / 2],
                                           unsigned char* eb) {
  const int t = threadIdx.x % kWG, lane = t & 31;
  const int r = (t >> 5) * 16 + (lane >> 2);
  const int cq = (lane & 3) * 4;
#pragma unroll
  for (int j = 0; j < 16; ++j)  // n8 slices of the half
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h, jj = HF * 16 + j;
      *reinterpret_cast<__nv_bfloat162*>(
          eb + (j >> 3) * 8192 + row * 128 + (((j & 7) ^ (row & 7)) << 4) +
          cq) = __floats2bfloat162_rn(acc[4 * jj + 2 * h],
                                      acc[4 * jj + 2 * h + 1]);
    }
}

// Before a warpgroup writes its epilogue buffer: its earlier TMA stores
// have read it (thread 0 issued them), and its threads are done with it.
__device__ __forceinline__ void epi_acquire(int wg) {
  if (threadIdx.x % kWG == 0) bulk_wait_read();
  named_sync(1 + wg, kWG);
}
// After: the generic writes are seen by the async proxy and every thread.
__device__ __forceinline__ void epi_release(int wg) {
  fence_proxy_async();
  named_sync(1 + wg, kWG);
}

// The forward (WT false: rhs [G, K, N]) and dlhs (WT true: rhs [G, N, K],
// the weight read as its transpose): out [M, N] from lhs [M, K]. Tensor
// maps: tl over lhs, boxes 64 x BM; tw over rhs, boxes 64 (N) x 64 (K) x 1
// or, with WT, 64 (K) x BN (N) x 1; to over out, boxes 64 x 64.
template <bool WT>
__global__ void __launch_bounds__(kThreads, 1)
    gmm_sm90(const __grid_constant__ CUtensorMap tl,
             const __grid_constant__ CUtensorMap tw,
             const __grid_constant__ CUtensorMap to,
             const int* __restrict__ ends, bf16* __restrict__ out, int M,
             int K, int N, int G) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* epi = sm + NS * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + 2 * EPI_BYTES);
  uint64_t* empty = full + NS;
  const int nk = (K + BK - 1) / BK, nt = (N + BN - 1) / BN;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  Walk walk;

  if (threadIdx.x >= kConsumers) {
    // the producer warp: lane 0 loads every stage of every item in turn
    int st = 0, ph = 0;
    for (int item = blockIdx.x;; item += gridDim.x) {
      const int2 f = walk.find(ends, M, G, item / nt);
      if (f.x < 0) break;
      if (lane == 0) {
        const int row0 = group_rows(ends, f.x, M).x + f.y * BM;
        const int n0 = (item % nt) * BN;
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(empty + st, ph ^ 1);
          unsigned char* a = sm + st * STAGE_BYTES;
          unsigned char* b = a + A_BYTES;
          mbar_expect_tx(full + st, STAGE_BYTES);
          tma_load2(a, &tl, full + st, kc * BK, row0);
          if constexpr (WT) {
            tma_load3(b, &tw, full + st, kc * BK, n0, f.x);
          } else {
#pragma unroll
            for (int c = 0; c < BN / 64; ++c)
              tma_load3(b + c * BK * 128, &tw, full + st, n0 + c * 64,
                        kc * BK, f.x);
          }
          if (++st == NS) st = 0, ph ^= 1;
        }
      }
      __syncwarp();
    }
    return;
  }

  // rows past the last group: zero (the output is torch.empty)
  {
    const int last = min(max(ends[G - 1], 0), M);
    const size_t pieces = (size_t)(M - last) * (N / 8);
    for (size_t c = (size_t)blockIdx.x * kConsumers + threadIdx.x;
         c < pieces; c += (size_t)gridDim.x * kConsumers)
      *reinterpret_cast<uint4*>(out + (size_t)last * N + c * 8) =
          make_uint4(0u, 0u, 0u, 0u);
  }

  // warp-uniform, so that every address and descriptor derived from it
  // stays in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWG, 0);
  const int t = threadIdx.x % kWG;
  unsigned char* eb = epi + wg * EPI_BYTES;
  int st = 0, ph = 0;
  float acc[BN / 2];
  for (int item = blockIdx.x;; item += gridDim.x) {
    const int2 f = walk.find(ends, M, G, item / nt);
    if (f.x < 0) break;
    const int2 gr = group_rows(ends, f.x, M);
    const int row0 = gr.x + f.y * BM + wg * 64;  // this warpgroup's rows
    const bool live = row0 < gr.y;
    int prev = -1;
    for (int kc = 0; kc < nk; ++kc) {
      mbar_wait(full + st, ph);
      if (live) {
        const uint32_t a = smem_u32(sm + st * STAGE_BYTES) + wg * 64 * 128;
        const uint32_t b = smem_u32(sm + st * STAGE_BYTES + A_BYTES);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          if constexpr (WT)
            mma_ss<0, 0>(acc, desc_k(a, BM, kk), desc_k(b, BN, kk),
                         kc > 0 || kk > 0);
          else
            mma_ss<0, 1>(acc, desc_k(a, BM, kk), desc_mn(b, BK, kk),
                         kc > 0 || kk > 0);
        }
        wg_commit();
        // the previous stage's products are complete: release it
        wg_wait<1>();
        fence_regs(acc);
      }
      __syncwarp();
      if (prev >= 0 && lane == 0) mbar_arrive(empty + prev);
      prev = st;
      if (++st == NS) st = 0, ph ^= 1;
    }
    if (live) {
      wg_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (prev >= 0 && lane == 0) mbar_arrive(empty + prev);
    if (!live) continue;
    // the epilogue, 128 columns at a time through the buffer: a tile
    // wholly inside its group goes out by TMA stores (clipped past N),
    // one that ends past the group by 16-byte stores of its live rows
    const int n0 = (item % nt) * BN;
    const bool whole = row0 + 64 <= gr.y;
#pragma unroll
    for (int hf = 0; hf < BN / 128; ++hf) {
      const int c0 = n0 + hf * 128;
      if (c0 >= N) break;
      epi_acquire(wg);
      if (hf == 0)
        stage_half<0>(acc, eb);
      else
        stage_half<1>(acc, eb);
      epi_release(wg);
      if (whole) {
        if (t == 0) {
          tma_store2(&to, eb, c0, row0);
          tma_store2(&to, eb + 8192, c0 + 64, row0);
          bulk_commit();
        }
      } else {
        for (int i = t; i < 64 * 16; i += kWG) {
          const int row = i >> 4, cc = i & 15;  // 16-byte chunk of a row
          if (row0 + row < gr.y && c0 + cc * 8 < N)
            *reinterpret_cast<uint4*>(out + (size_t)(row0 + row) * N + c0 +
                                      cc * 8) =
                *reinterpret_cast<const uint4*>(
                    eb + (cc >> 3) * 8192 + row * 128 +
                    (((cc & 7) ^ (row & 7)) << 4));
        }
      }
    }
  }
  if (t == 0) bulk_wait();
}

// drhs [G, K, N] from lhs [M, K] and dout [M, N]: item (g, K tile, N tile)
// summed over group g's rows. Tensor maps: tl over lhs and td over dout,
// boxes 64 x 64 rows; tr over drhs [G, K, N], boxes 64 x 64 x 1.
__global__ void __launch_bounds__(kThreads, 1)
    tgmm_sm90(const __grid_constant__ CUtensorMap tl,
              const __grid_constant__ CUtensorMap td,
              const __grid_constant__ CUtensorMap tr,
              const int* __restrict__ ends, int M, int K, int N, int G) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* epi = sm + NS * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + 2 * EPI_BYTES);
  uint64_t* empty = full + NS;
  const int kt = (K + TK - 1) / TK, nt = (N + BN - 1) / BN;
  const int items = G * kt * nt;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    if (lane != 0) return;
    int st = 0, ph = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int g = item / (kt * nt), rem = item % (kt * nt);
      const int k0 = (rem / nt) * TK, n0 = (rem % nt) * BN;
      const int2 gr = group_rows(ends, g, M);
      for (int r = gr.x; r < gr.y; r += 64) {
        mbar_wait(empty + st, ph ^ 1);
        unsigned char* a = sm + st * STAGE_BYTES;
        unsigned char* b = a + A_BYTES;
        mbar_expect_tx(full + st, STAGE_BYTES);
#pragma unroll
        for (int c = 0; c < TK / 64; ++c)
          tma_load2(a + c * 64 * 128, &tl, full + st, k0 + c * 64, r);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load2(b + c * 64 * 128, &td, full + st, n0 + c * 64, r);
        if (++st == NS) st = 0, ph ^= 1;
      }
    }
    return;
  }

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWG, 0);
  const int t = threadIdx.x % kWG;
  unsigned char* eb = epi + wg * EPI_BYTES;
  int st = 0, ph = 0;
  float acc[BN / 2];
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int g = item / (kt * nt), rem = item % (kt * nt);
    const int k0 = (rem / nt) * TK + wg * 64, n0 = (rem % nt) * BN;
    const int2 gr = group_rows(ends, g, M);
    if (gr.y <= gr.x) {
      // an empty group: its slab is zero
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    }
    int prev = -1;
    for (int r = gr.x; r < gr.y; r += 64) {
      mbar_wait(full + st, ph);
      unsigned char* a = sm + st * STAGE_BYTES + wg * 64 * 128;
      const int live = gr.y - r;
      if (live < 64) {
        // the group's last chunk: rows [live, 64) are the next group's
        // (or zeros past M); zero them in this warpgroup's lhs box
        uint4* z = reinterpret_cast<uint4*>(a + live * 128);
        for (int i = t; i < (64 - live) * 8; i += kWG)
          z[i] = make_uint4(0u, 0u, 0u, 0u);
        fence_proxy_async();
        named_sync(1 + wg, kWG);
      }
      const uint32_t au = smem_u32(a);
      const uint32_t b = smem_u32(sm + st * STAGE_BYTES + A_BYTES);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss<1, 1>(acc, desc_mn(au, 64, kk), desc_mn(b, 64, kk),
                     r > gr.x || kk > 0);
      wg_commit();
      wg_wait<1>();
      fence_regs(acc);
      __syncwarp();
      if (prev >= 0 && lane == 0) mbar_arrive(empty + prev);
      prev = st;
      if (++st == NS) st = 0, ph ^= 1;
    }
    wg_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (prev >= 0 && lane == 0) mbar_arrive(empty + prev);
    // the epilogue, 128 columns at a time through the buffer, out by TMA
    // stores (clipped past K and N) that overlap the next item's products
#pragma unroll
    for (int hf = 0; hf < BN / 128; ++hf) {
      const int c0 = n0 + hf * 128;
      if (c0 >= N) break;
      epi_acquire(wg);
      if (hf == 0)
        stage_half<0>(acc, eb);
      else
        stage_half<1>(acc, eb);
      epi_release(wg);
      if (t == 0) {
        tma_store3(&tr, eb, c0, k0, g);
        tma_store3(&tr, eb + 8192, c0 + 64, k0, g);
        bulk_commit();
      }
    }
  }
  if (t == 0) bulk_wait();
}

// SMs of `device`, read once.
static int sm_count(int device) {
  static int counts[64] = {0};
  int& n = counts[device & 63];
  if (n == 0) cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                     device);
  return n > 0 ? n : 1;
}

using u64 = unsigned long long;

// A bf16 [rows, cols] row-major map, boxes of 64 columns x `box_rows`.
static int encode_2d(CUtensorMap* map, const void* base, int rows, int cols,
                     unsigned box_rows) {
  const u64 dims[2] = {(u64)cols, (u64)rows}, str[1] = {(u64)cols * 2};
  const unsigned box[2] = {64, box_rows};
  return encode_tiled(map, base, 2, dims, str, box);
}
// A bf16 [G, rows, cols] map, boxes of 64 columns x `box_rows` x 1: a box
// never crosses from one [rows, cols] slab into the next.
static int encode_3d(CUtensorMap* map, const void* base, int G, int rows,
                     int cols, unsigned box_rows) {
  const u64 dims[3] = {(u64)cols, (u64)rows, (u64)G};
  const u64 str[2] = {(u64)cols * 2, (u64)rows * cols * 2};
  const unsigned box[3] = {64, box_rows, 1};
  return encode_tiled(map, base, 3, dims, str, box);
}

template <bool WT>
int launch_sm90(const void* lhs, const void* rhs, const int* ends, void* out,
                int M, int K, int N, int G, int device, cudaStream_t st) {
  CUtensorMap tl, tw, to;
  int e = encode_2d(&tl, lhs, M, K, BM);
  if (e == 0)  // dlhs: rhs [G, N, K]; forward: rhs [G, K, N]
    e = WT ? encode_3d(&tw, rhs, G, N, K, BN)
           : encode_3d(&tw, rhs, G, K, N, BK);
  if (e == 0) e = encode_2d(&to, out, M, N, 64);
  if (e != 0) return e;
  cudaError_t ce = cudaFuncSetAttribute(
      gmm_sm90<WT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (ce != cudaSuccess) return (int)ce;
  const long long items =
      ((long long)(M + BM - 1) / BM + G) * ((N + BN - 1) / BN);
  const int grid = (int)std::min<long long>(sm_count(device), items);
  gmm_sm90<WT><<<grid, kThreads, SMEM, st>>>(
      tl, tw, to, ends, static_cast<bf16*>(out), M, K, N, G);
  return (int)cudaGetLastError();
}

int launch_tgmm_sm90(const void* lhs, const void* dout, const int* ends,
                     void* drhs, int M, int K, int N, int G, int device,
                     cudaStream_t st) {
  CUtensorMap tl, td, tr;
  int e = encode_2d(&tl, lhs, M, K, 64);
  if (e == 0) e = encode_2d(&td, dout, M, N, 64);
  if (e == 0) e = encode_3d(&tr, drhs, G, K, N, 64);
  if (e != 0) return e;
  cudaError_t ce = cudaFuncSetAttribute(
      tgmm_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (ce != cudaSuccess) return (int)ce;
  const long long items =
      (long long)G * ((K + TK - 1) / TK) * ((N + BN - 1) / BN);
  const int grid = (int)std::min<long long>(sm_count(device), items);
  tgmm_sm90<<<grid, kThreads, SMEM, st>>>(tl, td, tr, ends, M, K, N, G);
  return (int)cudaGetLastError();
}

template <typename T, bool WT>
int launch(const void* lhs, const void* rhs, const int* ends, void* out,
           int M, int K, int N, int G, cudaStream_t st) {
  using C = Cfg<T>;
  const size_t smem = Geo<T, WT>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      gmm_kernel<T, WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(G, (N + C::BN - 1) / C::BN);
  gmm_kernel<T, WT><<<grid, C::NT, smem, st>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(rhs), ends,
      static_cast<T*>(out), M, K, N, G);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tgmm(const void* lhs, const void* dout, const int* ends,
                void* drhs, int M, int K, int N, int G, cudaStream_t st) {
  using C = TCfg<T>;
  const size_t smem = TGeo<T>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      tgmm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(G, (K + C::BKO - 1) / C::BKO, (N + C::BN - 1) / C::BN);
  tgmm_kernel<T><<<grid, C::NT, smem, st>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(dout), ends,
      static_cast<T*>(drhs), M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace gmm
}  // namespace ptt

extern "C" {

// lhs [M, K], rhs [G, K, N] (rhs_t 0) or [G, N, K] (rhs_t 1: dlhs, the
// weight read transposed), ends [G] int32 -> out [M, N], one dtype
int ptt_gmm(const void* lhs, const void* rhs, const void* ends, void* out,
            int M, int K, int N, int G, int rhs_t, int dtype, int device,
            void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* e = static_cast<const int*>(ends);
  if (M == 0 || N == 0 || G == 0) return (int)cudaSuccess;
  if (dtype == ptt::kBF16) {
    if (K == 0)  // no products: every row is zero
      return (int)cudaMemsetAsync(out, 0, (size_t)M * N * 2, st);
    return rhs_t ? ptt::gmm::launch_sm90<true>(lhs, rhs, e, out, M, K, N, G,
                                               device, st)
                 : ptt::gmm::launch_sm90<false>(lhs, rhs, e, out, M, K, N,
                                                G, device, st);
  }
  if (dtype == ptt::kF32)
    return rhs_t ? ptt::gmm::launch<float, true>(lhs, rhs, e, out, M, K, N,
                                                 G, st)
                 : ptt::gmm::launch<float, false>(lhs, rhs, e, out, M, K, N,
                                                  G, st);
  return (int)cudaErrorInvalidValue;
}

// lhs [M, K], dout [M, N], ends [G] int32 -> drhs [G, K, N], one dtype;
// every item writes its tile, an empty group's as zeros
int ptt_tgmm(const void* lhs, const void* dout, const void* ends,
             void* drhs, int M, int K, int N, int G, int dtype, int device,
             void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* e = static_cast<const int*>(ends);
  if (K == 0 || N == 0 || G == 0) return (int)cudaSuccess;
  if (dtype == ptt::kBF16)
    return ptt::gmm::launch_tgmm_sm90(lhs, dout, e, drhs, M, K, N, G, device,
                                      st);
  if (dtype == ptt::kF32)
    return ptt::gmm::launch_tgmm<float>(lhs, dout, e, drhs, M, K, N, G, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
