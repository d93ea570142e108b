// gmm, the grouped GEMM of the MoE experts (forward), for Hopper (sm_90a).
//
// Replaces:
//   paddle_tpu/ops/pallas_gmm.py:gmm  (Pallas _gmm_kernel, the forward;
//     the backward's tgmm and dlhs belong to MoE training and are not here)
//
// Contract (the TPU kernel's): lhs [M, K] with rows grouped contiguously,
// rhs [G, K, N], group ends [G] (the cumsum of the group sizes, computed on
// the card by the wrapper); out[m] = lhs[m] @ rhs[g(m)] in lhs's dtype,
// accumulated in f32; rows past the last group's end match no group and
// come out zero.
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
// of products).
//
// Design. The TPU kernel walked 128-row blocks over an (m, n, group) grid
// with the group axis innermost, carrying one f32 accumulator in scratch
// across that sequential axis. Blocks on Hopper run in no order, so here a
// block owns one group and one 128-column tile: grid (G, ceil(N / 128)),
// fixed by rhs's shape, with no read of the group sizes on the host. The
// block reads its group's row range [ends[g - 1], ends[g]) (clamped to M)
// and walks it in tiles of 64 rows; for each it streams the K axis through
// a cp.async ring of 16-byte copies (zero-filled past the tile's last row
// and past K and N) and multiplies: bf16 on the tensor cores (mma.sync
// m16n8k16, f32 accumulators, ldmatrix operands, .trans for the [K, N]
// row-major weights; four warps of 32 columns each, 16-row tiles past the
// group's last row skipped), f32 in true f32 on the CUDA cores (FMA, no
// TF32). A bf16 x bf16 product is exact in f32, so the bf16 route is the
// TPU kernel's f32 dot up to summation order. At a mixed step a group
// holds ~12 rows, so one row tile carries it and each weight byte crosses
// into an SM once; a group of more than 64 rows (a decode step's six
// padding groups of ~130 rows, the prefill's ~192) walks its row tiles in
// turn and re-reads its weight slab per tile (from L2 while it stays
// there). The accumulators go to
// global memory straight from registers, cast once. An empty group's
// blocks return at once, except those of the last group: they zero the
// rows past the last end in their column tile, so the tail needs no
// host-side slice.
// Shape gate (the wrapper's): rows of 16 bytes, i.e. K and N multiples of
// 8 in bf16 and of 4 in f32, and 16-byte aligned tensors. The TPU gate
// (K and N multiples of 128) does not apply.

#include "common.cuh"

namespace ptt {
namespace gmm {

using bf16 = __nv_bfloat16;

// Tiles: BM rows by BN columns, BK deep a ring stage.
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

template <typename T>
struct Geo {
  using C = Cfg<T>;
  static constexpr int VE = 16 / sizeof(T);  // elements of a 16-byte copy
  static constexpr int LDA = C::BK + C::PAD;
  static constexpr int LDW = C::BN + C::PAD;
  static constexpr int A_ELEMS = C::BM * LDA;
  static constexpr int W_ELEMS = C::BK * LDW;
  static constexpr int STAGE_ELEMS = A_ELEMS + W_ELEMS;
  static constexpr size_t SMEM = (size_t)C::STAGES * STAGE_ELEMS * sizeof(T);
};

// One K chunk [k0, k0 + BK) of the row tile's lhs rows (the first `live`
// rows; `rows` of them real) and of the group's weight columns into a
// stage; what lies past the rows, K or N is zero-filled.
template <typename T>
__device__ __forceinline__ void load_stage(T* st, const T* lhs, const T* W,
                                           int m0, int rows, int live, int n0,
                                           int k0, int K, int N) {
  using C = Cfg<T>;
  using G = Geo<T>;
  constexpr int AROW = C::BK / G::VE, WROW = C::BN / G::VE;
  for (int c = threadIdx.x; c < live * AROW; c += C::NT) {
    const int r = c / AROW, kc = (c % AROW) * G::VE;
    const int k = k0 + kc;
    const bool ok = r < rows && k < K;
    cp_async16(st + r * G::LDA + kc,
               ok ? lhs + (size_t)(m0 + r) * K + k : lhs, ok);
  }
  T* sw = st + G::A_ELEMS;
  for (int c = threadIdx.x; c < C::BK * WROW; c += C::NT) {
    const int r = c / WROW, nc = (c % WROW) * G::VE;
    const int k = k0 + r, n = n0 + nc;
    const bool ok = k < K && n < N;
    cp_async16(sw + r * G::LDW + nc, ok ? W + (size_t)k * N + n : W, ok);
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

  __device__ void step(const bf16* st, int tiles) {
    using G = Geo<bf16>;
    const int lane = threadIdx.x & 31, wn = threadIdx.x >> 5;
    const int lr = lane & 15, lc = (lane >> 4) * 8;
    const bf16* a = st + lr * G::LDA + lc;
    const bf16* w = st + G::A_ELEMS + lr * G::LDW + wn * 32 + lc;
#pragma unroll
    for (int kk = 0; kk < Cfg<bf16>::BK; kk += 16) {
      unsigned bfr[2][4];  // b0, b1 of n8 tiles 2 jp and 2 jp + 1
#pragma unroll
      for (int jp = 0; jp < 2; ++jp)
        ldsm_x4_trans(bfr[jp], w + kk * G::LDW + jp * 16);
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

  __device__ void step(const float* st, int) {
    using G = Geo<float>;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    const float* w = st + G::A_ELEMS;
#pragma unroll 4
    for (int kk = 0; kk < Cfg<float>::BK; ++kk) {
      float av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = st[(ty + 16 * i) * G::LDA + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float wv = w[kk * G::LDW + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(av[i], wv, acc[i][j]);
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

template <typename T>
__global__ void __launch_bounds__(Cfg<T>::NT)
    gmm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
               const int* __restrict__ ends, T* __restrict__ out, int M,
               int K, int N, int G) {
  using C = Cfg<T>;
  using Gm = Geo<T>;
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
        load_stage<T>(smem + s * Gm::STAGE_ELEMS, lhs, W, m0, rows,
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
        load_stage<T>(smem + (nx % C::STAGES) * Gm::STAGE_ELEMS, lhs, W, m0,
                      rows, tiles * 16, n0, nx * C::BK, K, N);
      cp_async_commit();
      acc.step(smem + (kc % C::STAGES) * Gm::STAGE_ELEMS, tiles);
    }
    cp_async_wait<0>();
    __syncthreads();  // the next row tile's loads reuse the ring
    acc.store(out, m0, rows, n0, N);
  }
}

template <typename T>
int launch(const void* lhs, const void* rhs, const int* ends, void* out,
           int M, int K, int N, int G, cudaStream_t st) {
  using C = Cfg<T>;
  const size_t smem = Geo<T>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      gmm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(G, (N + C::BN - 1) / C::BN);
  gmm_kernel<T><<<grid, C::NT, smem, st>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(rhs), ends,
      static_cast<T*>(out), M, K, N, G);
  return (int)cudaGetLastError();
}

}  // namespace gmm
}  // namespace ptt

extern "C" {

// lhs [M, K], rhs [G, K, N], ends [G] int32 -> out [M, N], one dtype
int ptt_gmm(const void* lhs, const void* rhs, const void* ends, void* out,
            int M, int K, int N, int G, int dtype, int device, void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* e = static_cast<const int*>(ends);
  if (M == 0 || N == 0 || G == 0) return (int)cudaSuccess;
  if (dtype == ptt::kBF16)
    return ptt::gmm::launch<__nv_bfloat16>(lhs, rhs, e, out, M, K, N, G, st);
  if (dtype == ptt::kF32)
    return ptt::gmm::launch<float>(lhs, rhs, e, out, M, K, N, G, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
