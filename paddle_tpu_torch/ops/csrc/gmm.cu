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
// Design, forward. The TPU kernel walked 128-row blocks over an (m, n,
// group) grid with the group axis innermost, carrying one f32 accumulator
// in scratch across that sequential axis. Blocks on Hopper run in no
// order, so here a block owns one group and one 128-column tile: grid (G,
// ceil(N / 128)), fixed by rhs's shape, with no read of the group sizes on
// the host. The block reads its group's row range [ends[g - 1], ends[g])
// (clamped to M) and walks it in tiles of 64 rows; for each it streams the
// K axis through a cp.async ring of 16-byte copies (zero-filled past the
// tile's last row and past K and N) and multiplies: bf16 on the tensor
// cores (mma.sync m16n8k16, f32 accumulators, ldmatrix operands, .trans
// for the [K, N] row-major weights; four warps of 32 columns each, 16-row
// tiles past the group's last row skipped), f32 in true f32 on the CUDA
// cores (FMA, no TF32). A bf16 x bf16 product is exact in f32, so the bf16
// route is the TPU kernel's f32 dot up to summation order. At a mixed step
// a group holds ~12 rows, so one row tile carries it and each weight byte
// crosses into an SM once; a group of more than 64 rows (a decode step's
// six padding groups of ~130 rows, the prefill's ~192, training's ~384)
// walks its row tiles in turn and re-reads its weight slab per tile (from
// L2 while it stays there). The accumulators go to global memory straight
// from registers, cast once. An empty group's blocks return at once,
// except those of the last group: they zero the rows past the last end in
// their column tile, so the tail needs no host-side slice.
//
// Design, dlhs. The same kernel with the weight read as [N, K]: rhs[g] is
// [K, N] row-major, so its transpose is column-major, and no transposed
// copy of the expert stack is made (503 MB a stack at ERNIE's widths). A
// compile-time layout parameter stores each weight chunk in shared memory
// as it lies in global memory (rows of the output's columns, the reduction
// axis contiguous) and reads the B fragments with ldmatrix without .trans.
//
// Design, tgmm (drhs). A block owns (group, 64-row tile of K, 128-column
// tile of N): grid (G, ceil(K / 64), ceil(N / 128)), fixed by rhs's shape.
// It walks its group's row range as the reduction axis, 64 rows a stage
// (32 in f32) through a cp.async ring zero-filled past the group's end;
// lhs is the A operand transposed (ldmatrix .trans on the lhs rows), dout
// the B operand as the forward reads its weights. The f32 accumulators stay
// in registers over the whole range and are cast once; an empty group's
// blocks write their zero accumulators, since the output is torch.empty.
// A block re-reads its group's lhs columns once per N tile and its dout
// columns once per K tile, from L2 while they stay there.
//
// Shape gate (the wrapper's): rows of 16 bytes, i.e. K and N multiples of
// 8 in bf16 and of 4 in f32, and 16-byte aligned tensors. The TPU gate
// (K and N multiples of 128) does not apply.

#include "common.cuh"

namespace ptt {
namespace gmm {

using bf16 = __nv_bfloat16;

// Forward / dlhs tiles: BM rows by BN columns, BK deep a ring stage.
template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int NT = 128;  // four warps, 32 columns each
  static constexpr int BM = 64, BN = 128, BK = 64, PAD = 8, STAGES = 4;
};
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

// bf16: warp w owns columns 32 w .. 32 w + 31 of the tile (four n8 tiles)
// and every 16-row tile that holds rows.
struct AccBf16 {
  static constexpr int MT = Cfg<bf16>::BM / 16;
  float acc[MT][4][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  // One stage of the forward (WT false) or of dlhs (WT true).
  template <bool WT>
  __device__ void step(const bf16* st, int tiles) {
    using G = Geo<bf16, WT>;
    const int lane = threadIdx.x & 31, wn = threadIdx.x >> 5;
    const int lr = lane & 15, lc = (lane >> 4) * 8;
    const bf16* a = st + lr * G::LDA + lc;
    // [K][N] rows: lane i addresses row i % 16 (k) of column block i / 16,
    // read transposed. [N][K] rows (WT): lane i addresses column (row of
    // the stage) i % 8 + 8 (i / 16) at k offset 8 ((i / 8) % 2), read as is.
    const bf16* w =
        WT ? st + G::A_ELEMS +
                 (wn * 32 + (lane & 7) + ((lane >> 4) << 3)) * G::LDW +
                 (((lane >> 3) & 1) << 3)
           : st + G::A_ELEMS + lr * G::LDW + wn * 32 + lc;
#pragma unroll
    for (int kk = 0; kk < Cfg<bf16>::BK; kk += 16) {
      unsigned bfr[2][4];  // b0, b1 of n8 tiles 2 jp and 2 jp + 1
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        if constexpr (WT)
          ldsm_x4(bfr[jp], w + jp * 16 * G::LDW + kk);
        else
          ldsm_x4_trans(bfr[jp], w + kk * G::LDW + jp * 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i >= tiles) break;
        unsigned af[4];
        ldsm_x4(af, a + i * 16 * G::LDA + kk);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          mma_bf16(acc[i][2 * jp], af, bfr[jp][0], bfr[jp][1]);
          mma_bf16(acc[i][2 * jp + 1], af, bfr[jp][2], bfr[jp][3]);
        }
      }
    }
  }

  // One stage of tgmm: the 64 rows of K are the A operand, lhs^T, read
  // transposed from the lhs rows [BR][LDL] (lane i addresses row i % 8 +
  // 8 (i / 16) at column offset 8 ((i / 8) % 2)); dout [BR][LDD] is B, read
  // as the forward reads its weights.
  template <int BR, int LDL, int LDD, int L_ELEMS>
  __device__ void tstep(const bf16* st) {
    const int lane = threadIdx.x & 31, wn = threadIdx.x >> 5;
    const bf16* l = st + ((lane & 7) + ((lane >> 4) << 3)) * LDL +
                    (((lane >> 3) & 1) << 3);
    const bf16* d = st + L_ELEMS + (lane & 15) * LDD + wn * 32 +
                    (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < BR; kk += 16) {
      unsigned bfr[2][4];
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
        ldsm_x4_trans(bfr[jp], d + kk * LDD + jp * 16);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        unsigned af[4];
        ldsm_x4_trans(af, l + kk * LDL + i * 16);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          mma_bf16(acc[i][2 * jp], af, bfr[jp][0], bfr[jp][1]);
          mma_bf16(acc[i][2 * jp + 1], af, bfr[jp][2], bfr[jp][3]);
        }
      }
    }
  }

  __device__ void store(bf16* out, int m0, int rows, int n0, int N) const {
    const int lane = threadIdx.x & 31, wn = threadIdx.x >> 5;
    const int r = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn * 32 + j * 8 + c;
        if (col >= N) continue;  // N % 8 == 0: an n8 tile is in or out
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = i * 16 + r + 8 * h;
          if (row < rows)
            *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(m0 + row) * N +
                                               col) =
                __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
  }
};

// f32: thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i (i < 4) and
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
  __device__ void step(const float* st, int) {
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

template <typename T>
struct AccOf;
template <>
struct AccOf<bf16> {
  using type = AccBf16;
};
template <>
struct AccOf<float> {
  using type = AccF32;
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
  typename AccOf<T>::type acc;
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
      acc.template step<WT>(smem + (kc % C::STAGES) * Gm::STAGE_ELEMS,
                            tiles);
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
struct TCfg<bf16> {
  static constexpr int NT = 128;
  static constexpr int BKO = 64, BN = 128, BR = 64, PAD = 8, STAGES = 4;
};
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
  typename AccOf<T>::type acc;
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
  if (dtype == ptt::kBF16)
    return rhs_t ? ptt::gmm::launch<__nv_bfloat16, true>(lhs, rhs, e, out, M,
                                                         K, N, G, st)
                 : ptt::gmm::launch<__nv_bfloat16, false>(lhs, rhs, e, out,
                                                          M, K, N, G, st);
  if (dtype == ptt::kF32)
    return rhs_t ? ptt::gmm::launch<float, true>(lhs, rhs, e, out, M, K, N,
                                                 G, st)
                 : ptt::gmm::launch<float, false>(lhs, rhs, e, out, M, K, N,
                                                  G, st);
  return (int)cudaErrorInvalidValue;
}

// lhs [M, K], dout [M, N], ends [G] int32 -> drhs [G, K, N], one dtype;
// every block writes its tile, an empty group's as zeros
int ptt_tgmm(const void* lhs, const void* dout, const void* ends,
             void* drhs, int M, int K, int N, int G, int dtype, int device,
             void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* e = static_cast<const int*>(ends);
  if (K == 0 || N == 0 || G == 0) return (int)cudaSuccess;
  if (dtype == ptt::kBF16)
    return ptt::gmm::launch_tgmm<__nv_bfloat16>(lhs, dout, e, drhs, M, K, N,
                                                G, st);
  if (dtype == ptt::kF32)
    return ptt::gmm::launch_tgmm<float>(lhs, dout, e, drhs, M, K, N, G, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
