// fused_qkv_rope_append, fused_oproj_norm and fused_ffn for Hopper (sm_90a).
//
// Replaces (the fp weight site of each):
//   paddle_tpu/ops/pallas_megafront.py:fused_qkv_rope_append
//     (Pallas _qkv_rope_append_kernel): qkv GEMM + bias + rope + paged
//     K/V append;
//   paddle_tpu/ops/pallas_megadecode.py:fused_oproj_norm
//     (Pallas _oproj_norm_kernel, rms norm): o-proj GEMM + bias + residual
//     + rms norm, emitting both the new residual stream and its normed copy;
//   paddle_tpu/ops/pallas_megadecode.py:fused_ffn
//     (Pallas _ffn_kernel, swiglu): gate/up GEMM, silu(g) * u, down GEMM,
//     residual.
// The int8/int4 sites, the MLA layout, layer norm and gelu are not here.
//
// Bound on the H100: at the serving step's shapes (T = 132 token rows,
// Llama-3-8B) all three are bound by their weight bytes at 3.35 TB/s:
// qkv 50.3 MB (0.0150 ms), o-proj 33.6 MB (0.0100 ms), FFN 352 MB
// (0.105 ms); their bf16 tensor-core work (2 * T * K * N per product at
// 989 TFLOP/s) takes less than half of that.
//
// Design. Every TPU kernel kept its whole weight slab resident in VMEM
// and walked the token rows in order, carrying the f32 accumulator in
// scratch. Here one GEMM core serves all three. With few token rows the
// weights are what moves, so a block owns ALL rows of the step (up to
// 160; more rows take more blocks) by a 256-column tile (2 x 128 for the
// two-accumulator gate/up product): each weight byte crosses from L2
// into an SM once, and the activation tile that every column tile
// re-reads stays below ~0.6 of the weight bytes beside it. A block
// streams its K range through a 4-stage cp.async ring of 16-byte copies
// (zero-filled past the ragged row, column and K edges) and multiplies
// on the tensor cores with mma.sync m16n8k16 bf16 and f32 accumulators,
// its operands fed by ldmatrix (.trans for the [in, out] row-major
// weights); warps skip the 16-row tiles past the last row. A bf16 x bf16
// product is exact in f32, so this is the TPU kernels' f32 dot up to
// summation order. The f32 route multiplies in true f32 on the CUDA
// cores (64 x 128 tiles, 4 x 8 outputs a thread), no TF32. Blocks run in
// no order and nothing carries between them, so the GEMMs whose
// epilogue needs whole sums split K over grid.z into f32 partials
// (split_k picks the split that fills the SMs; the wrappers ask for it
// through ptt_mega_split_k to size the partials) and a second kernel
// finishes:
//   qkv:    one thread per rope pair sums the partials, adds the bias,
//           ropes q and k on the f32 sum (as _qkv_rope_append_kernel
//           does, before any rounding), writes q and each token's K/V row
//           straight into the caller's pools at its clamped page and
//           offset; rows of one page land in disjoint slots, only the
//           trash page 0 takes duplicates. Two CUDA kernels per call.
//   o-proj: one block per row sums the partials, adds bias and residual
//           in f32, stores x_new and rms-normalises the f32 sum (not the
//           rounded x_new) in _norm_f32's op order. Two CUDA kernels.
//   FFN:    the [T, I] activation does not fit a block: the gate/up GEMM
//           (two accumulators a block, no split) applies g * sigmoid(g)
//           * u in f32 and writes it to a workspace in the working type.
//           On the bf16 route that rounds the activation to bf16 before
//           the down GEMM, where the TPU kernel fed the f32 activation to
//           its down dot: one bf16 rounding (2^-9 relative) of each
//           activation, which the bf16 output's own rounding (2^-9 of the
//           residual sum) dominates; chip_smoke.py phase 2 reports the
//           error against the plain f32 version. (Feeding it as two bf16
//           planes, hi + lo, kept it exact to ~2^-17 but doubled the down
//           GEMM's activation traffic, which made it the slower half.)
//           The down GEMM splits K; a third kernel adds the partials, the
//           bias and the residual. Three CUDA kernels per call.
// The wrappers allocate every workspace.

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace ptt {
namespace mega {

using bf16 = __nv_bfloat16;

constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use

template <typename T>
struct Tile;
template <>
struct Tile<bf16> {
  static constexpr int BK = 64, PAD = 8;
};
template <>
struct Tile<float> {
  static constexpr int BK = 32, PAD = 4;
};

// A block's tile: BM = 32 * MT rows (MT 16-row tiles a warp) by BN
// columns of each of its NB accumulators. bf16 tiles are 160 rows (the 8B
// serving step's 132 rows in one tile; fewer rows leave the tail's warps
// idle, more take more blocks) by 256 columns (2 x 128 for the
// two-accumulator gate/up product), so the activation tile, which every
// column tile re-reads, is at most ~0.6 of the weight bytes that cross
// into the SM with it. f32 tiles are 64 x 128.
template <typename T, int NB>
struct Cfg {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int MT = kBf16 ? 5 : 2;
  // threads: bf16 16 warps as 2 (rows) x 8 (columns), four a scheduler
  // to hide the ldmatrix -> mma latency; f32 a 16 x 16 grid
  static constexpr int NT = kBf16 ? 512 : 256;
  static constexpr int WARPS_N = NT / 64;
  static constexpr int BM = 32 * MT;
  static constexpr int BN = !kBf16 ? 128 : (NB == 2 ? 128 : 256);
  static constexpr int BK = Tile<T>::BK;
  static constexpr int LDA = BK + Tile<T>::PAD;
  static constexpr int LDW = BN + Tile<T>::PAD;
  static constexpr int LDC = BN + 4;
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int W_ELEMS = BK * LDW;
  static constexpr int STAGE_ELEMS = A_ELEMS + NB * W_ELEMS;
  // cp.async ring depth: 4 stages where they fit, else 3
  static constexpr int STAGES =
      4 * STAGE_ELEMS * sizeof(T) <= SMEM_MAX ? 4 : 3;
  static constexpr size_t PIPE_BYTES =
      (size_t)STAGES * STAGE_ELEMS * sizeof(T);
  static constexpr size_t C_BYTES = (size_t)NB * BM * LDC * sizeof(float);
  static constexpr size_t SMEM = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;
};

enum Epi : int { kEpiSwiglu = 0, kEpiPartial = 1 };

struct Args {
  const void* a;        // A [M, K]
  const void* w[2];     // W [K, N], one accumulator each
  int M, N, K;
  int kc_split;         // BK chunks per grid.z slice of K
  const float* bias;    // [N] or null (kEpiSwiglu)
  float* partial;       // [gridDim.z, M, N] (kEpiPartial)
  void* act;            // [M, N] activation (kEpiSwiglu)
};

// One K chunk [k0, k0 + BK) of the A tile and every W tile into a stage.
template <typename T, typename C, int NB>
__device__ __forceinline__ void load_stage(T* st, const Args& p, int m0,
                                           int n0, int k0, int kend) {
  constexpr int VE = 16 / sizeof(T);
  constexpr int AROW = C::BK / VE, WROW = C::BN / VE;
  const T* A = static_cast<const T*>(p.a);
  for (int c = threadIdx.x; c < C::BM * AROW; c += C::NT) {
    const int r = c / AROW, kc = (c % AROW) * VE;
    const int m = m0 + r, k = k0 + kc;
    const bool ok = m < p.M && k < kend;
    cp_async16(st + r * C::LDA + kc, ok ? A + (size_t)m * p.K + k : A, ok);
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const T* W = static_cast<const T*>(p.w[b]);
    T* dst = st + C::A_ELEMS + b * C::W_ELEMS;
    for (int c = threadIdx.x; c < C::BK * WROW; c += C::NT) {
      const int r = c / WROW, nc = (c % WROW) * VE;
      const int k = k0 + r, n = n0 + nc;
      const bool ok = k < kend && n < p.N;
      cp_async16(dst + r * C::LDW + nc, ok ? W + (size_t)k * p.N + n : W, ok);
    }
  }
}

// bf16 on the tensor cores: warp (wm, wn) owns rows wm * 16 MT + 16 i
// (i < MT) and columns wn * BN / WARPS_N + 8 j (j < WN) of every
// accumulator.
template <typename C, int NB>
struct MmaBf16 {
  static constexpr int MT = C::MT;
  static constexpr int WN = C::BN / (8 * C::WARPS_N);  // n8 tiles a warp
  float acc[NB][MT][WN][4];

  __device__ void zero() {
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < WN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[b][i][j][e] = 0.f;
  }

  // One ring stage, 16 deep at a time: the warp's B fragments first, then
  // its row tiles, the A fragment of tile i + 1 loading while tile i
  // multiplies (ldmatrix and mma issue in program order). live: the
  // block's 16-row tiles that hold rows (a warp-uniform skip).
  __device__ void step(const bf16* st, int wm, int wn, int live) {
    const int lane = threadIdx.x & 31;
    const int lr = lane & 15, lc = (lane >> 4) * 8;
    const int tiles = min(MT, live - wm * MT);
    if (tiles <= 0) return;
    const bf16* arow = st + (wm * 16 * MT + lr) * C::LDA + lc;
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 16) {
      unsigned bfr[NB][WN / 2][4];  // b0, b1 of n8 tiles 2 jp, 2 jp + 1
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int jp = 0; jp < WN / 2; ++jp)
          ldsm_x4_trans(bfr[b][jp], st + C::A_ELEMS + b * C::W_ELEMS +
                                        (kk + lr) * C::LDW +
                                        wn * (C::BN / C::WARPS_N) + jp * 16 +
                                        lc);
      unsigned af[2][4];
      ldsm_x4(af[0], arow + kk);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i >= tiles) break;
        if (i + 1 < tiles)
          ldsm_x4(af[(i + 1) & 1], arow + (i + 1) * 16 * C::LDA + kk);
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int jp = 0; jp < WN / 2; ++jp) {
            mma_bf16(acc[b][i][2 * jp], af[i & 1], bfr[b][jp][0],
                     bfr[b][jp][1]);
            mma_bf16(acc[b][i][2 * jp + 1], af[i & 1], bfr[b][jp][2],
                     bfr[b][jp][3]);
          }
      }
    }
  }

  __device__ void store(float* Cs, int wm, int wn) {
    const int lane = threadIdx.x & 31;
    const int r = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          float* o = Cs + b * C::BM * C::LDC +
                     (wm * 16 * MT + i * 16 + r) * C::LDC +
                     wn * (C::BN / C::WARPS_N) + j * 8 + c;
          o[0] = acc[b][i][j][0];
          o[1] = acc[b][i][j][1];
          o[8 * C::LDC] = acc[b][i][j][2];
          o[8 * C::LDC + 1] = acc[b][i][j][3];
        }
  }
};

// f32 on the CUDA cores: thread (ty, tx) of a 16 x 16 grid owns rows
// ty + 16 i (i < 4) and columns tx + 16 j (j < 8) of every accumulator.
template <typename C, int NB>
struct FmaF32 {
  float acc[NB][4][8];

  __device__ void zero() {
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[b][i][j] = 0.f;
  }

  __device__ void step(const float* st, int, int, int) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
    for (int kk = 0; kk < C::BK; ++kk) {
      float av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = st[(ty + 16 * i) * C::LDA + kk];
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float wv =
              st[C::A_ELEMS + b * C::W_ELEMS + kk * C::LDW + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[b][i][j] = fmaf(av[i], wv, acc[b][i][j]);
        }
    }
  }

  __device__ void store(float* Cs, int, int) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          Cs[b * C::BM * C::LDC + (ty + 16 * i) * C::LDC + tx + 16 * j] =
              acc[b][i][j];
  }
};

// ------------------------------------------------------------ epilogues
// Both epilogues walk the tile's live rows 4 columns a thread (N % 8 == 0,
// so 4 columns are all inside N or all past it).
template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T v[4];
};

template <typename T, typename C>
__device__ void epi_swiglu(const Args& p, const float* Cs, int m0, int n0) {
  const float* Cg = Cs;
  const float* Cu = Cs + C::BM * C::LDC;
  const int rows = min(C::BM, p.M - m0);
  for (int i = threadIdx.x; i < rows * (C::BN / 4); i += C::NT) {
    const int r = i / (C::BN / 4), c = (i % (C::BN / 4)) * 4;
    const int n = n0 + c;
    if (n >= p.N) continue;
    Vec4<T> out;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float g = Cg[r * C::LDC + c + e];
      if (p.bias) g += p.bias[n + e];
      out.v[e] = from_f32<T>(g * (1.f / (1.f + expf(-g))) *
                             Cu[r * C::LDC + c + e]);
    }
    *reinterpret_cast<Vec4<T>*>(static_cast<T*>(p.act) +
                                (size_t)(m0 + r) * p.N + n) = out;
  }
}

template <typename C>
__device__ void epi_partial(const Args& p, const float* Cs, int m0, int n0) {
  float* out = p.partial + (size_t)blockIdx.z * p.M * p.N;
  const int rows = min(C::BM, p.M - m0);
  for (int i = threadIdx.x; i < rows * (C::BN / 4); i += C::NT) {
    const int r = i / (C::BN / 4), c = (i % (C::BN / 4)) * 4;
    const int n = n0 + c;
    if (n < p.N)
      *reinterpret_cast<float4*>(out + (size_t)(m0 + r) * p.N + n) =
          *reinterpret_cast<const float4*>(Cs + r * C::LDC + c);
  }
}

// ------------------------------------------------------------ GEMM core
template <typename T, int NB, int EPI>
__global__ void __launch_bounds__(Cfg<T, NB>::NT)
    gemm_kernel(const Args p) {
  using C = Cfg<T, NB>;
  using Mma = typename std::conditional<C::kBf16, MmaBf16<C, NB>,
                                        FmaF32<C, NB>>::type;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* pipe = reinterpret_cast<T*>(smem_raw);
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;
  const int live = (min(p.M - m0, C::BM) + 15) / 16;
  const int kc_total = (p.K + C::BK - 1) / C::BK;
  const int c0 = blockIdx.z * p.kc_split;
  const int nk = min(p.kc_split, kc_total - c0);
  const int kend = min(p.K, (c0 + nk) * C::BK);
  const int warp = threadIdx.x >> 5;
  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;

  Mma mma;
  mma.zero();
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nk)
      load_stage<T, C, NB>(pipe + s * C::STAGE_ELEMS, p, m0, n0,
                           (c0 + s) * C::BK, kend);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<C::STAGES - 2>();  // chunk kt has landed
    __syncthreads();              // ... for every thread; kt-1 is consumed
    const int nxt = kt + C::STAGES - 1;
    if (nxt < nk)
      load_stage<T, C, NB>(pipe + (nxt % C::STAGES) * C::STAGE_ELEMS, p, m0,
                           n0,
                           (c0 + nxt) * C::BK, kend);
    cp_async_commit();
    mma.step(pipe + (kt % C::STAGES) * C::STAGE_ELEMS, wm, wn, live);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the accumulator tile reuses it
  float* Cs = reinterpret_cast<float*>(smem_raw);
  mma.store(Cs, wm, wn);
  __syncthreads();
  if constexpr (EPI == kEpiSwiglu)
    epi_swiglu<T, C>(p, Cs, m0, n0);
  else
    epi_partial<C>(p, Cs, m0, n0);
}

template <typename T, int NB, int EPI>
static cudaError_t launch_gemm(const Args& p, int splits, cudaStream_t st) {
  using C = Cfg<T, NB>;
  const int kc_total = (p.K + C::BK - 1) / C::BK;
  // every grid.z slice holds at least one chunk, and they cover K
  if (splits < 1 || p.kc_split < 1 || (splits - 1) * p.kc_split >= kc_total ||
      splits * p.kc_split < kc_total || (EPI != kEpiPartial && splits != 1))
    return cudaErrorInvalidValue;
  auto kern = gemm_kernel<T, NB, EPI>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid((p.M + C::BM - 1) / C::BM, (p.N + C::BN - 1) / C::BN, splits);
  kern<<<grid, C::NT, C::SMEM, st>>>(p);
  return cudaGetLastError();
}

// The split of K over grid.z for a one-accumulator [M, K] x [K, N]
// product on `sms` SMs: the slice count that minimises the waves of
// blocks per unit of work plus the partials' cost (each more slice
// writes and reads one more [M, N] f32 partial, taken as 1% of a wave),
// at most 8 slices and at least 4 K chunks a slice. Ties keep fewer.
template <typename T>
static void split_k(int M, int N, int K, int sms, int* per, int* splits) {
  using C = Cfg<T, 1>;
  const long tiles =
      (long)((M + C::BM - 1) / C::BM) * ((N + C::BN - 1) / C::BN);
  const int chunks = (K + C::BK - 1) / C::BK;
  const int top = std::max(1, std::min(8, chunks / 4));
  int best = 1;
  double best_cost = 0.0;
  for (int s = 1; s <= top; ++s) {
    const double cost = (double)((tiles * s + sms - 1) / sms) / s + 0.01 * s;
    if (s == 1 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  *per = (chunks + best - 1) / best;
  *splits = (chunks + *per - 1) / *per;
}

// ------------------------------------------------------ finalize passes
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    float s = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    s = warp_sum(s);
    if (lane == 0) red[32] = s;
  }
  __syncthreads();
  return red[32];
}

// One thread per rope pair (t, head, j): sum the partials, add the bias,
// rope q and k on the f32 sums, write q_out and the K/V rows.
template <typename T>
__global__ void qkv_finalize_kernel(const float* partial, int splits,
                                    const float* bias, const float* cosv,
                                    const float* sinv, const int* page_idx,
                                    const int* page_off, T* q_out, T* kp,
                                    T* vp, int M, int heads, int kv_heads,
                                    int D, int P, int psz) {
  const int d2 = D / 2, nh = heads + 2 * kv_heads, N = nh * D;
  const size_t total = (size_t)M * N, pairs = (size_t)M * nh * d2;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < pairs;
       i += (size_t)gridDim.x * blockDim.x) {
    const int j = (int)(i % d2);
    const size_t th = i / d2;
    const int head = (int)(th % nh), t = (int)(th / nh);
    const int g1 = head * D + j, g2 = g1 + d2;
    const size_t o = (size_t)t * N;
    float x1 = partial[o + g1], x2 = partial[o + g2];
    for (int z = 1; z < splits; ++z) {
      x1 += partial[z * total + o + g1];
      x2 += partial[z * total + o + g2];
    }
    if (bias) {
      x1 += bias[g1];
      x2 += bias[g2];
    }
    T* dst;
    if (head < heads) {
      dst = q_out + ((size_t)t * heads + head) * D;
    } else {
      const int pg = min(max(page_idx[t], 0), P - 1);
      const int off = min(max(page_off[t], 0), psz - 1);
      const int kvh = head - heads;
      T* pool = kvh < kv_heads ? kp : vp;
      const int hh = kvh < kv_heads ? kvh : kvh - kv_heads;
      dst = pool + (((size_t)hh * P + pg) * psz + off) * D;
    }
    if (head < heads + kv_heads) {  // rope on q and k, in f32
      const float cs = cosv[(size_t)t * d2 + j], sn = sinv[(size_t)t * d2 + j];
      const float y1 = x1 * cs - x2 * sn, y2 = x2 * cs + x1 * sn;
      x1 = y1;
      x2 = y2;
    }
    dst[j] = from_f32<T>(x1);
    dst[j + d2] = from_f32<T>(x2);
  }
}

// One block of 1024 threads per row t (a row's splits * N partials are
// read with every thread's loads in flight): x_new = x + (sum of partials
// + bias) in f32; h = rms_norm(that f32 sum) * nw + nb. Split 0's row
// holds the f32 sum between the two passes.
template <typename T>
__global__ void oproj_norm_finalize_kernel(float* partial, int splits,
                                           const float* bias, const T* x,
                                           const float* nw, const float* nb,
                                           T* x_new, T* h, int M, int N,
                                           float eps) {
  __shared__ float red[33];
  const int t = blockIdx.x;
  const size_t total = (size_t)M * N, base = (size_t)t * N;
  float* row = partial + base;
  float ss = 0.f;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float pv = row[n];
#pragma unroll 4
    for (int z = 1; z < splits; ++z) pv += partial[z * total + base + n];
    if (bias) pv += bias[n];
    const float xs = to_f32(x[base + n]) + pv;
    row[n] = xs;
    x_new[base + n] = from_f32<T>(xs);
    ss += xs * xs;
  }
  const float r = rsqrtf(block_sum(ss, red) / (float)N + eps);
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float y = row[n] * r;
    if (nw) y *= nw[n];
    if (nb) y += nb[n];
    h[base + n] = from_f32<T>(y);
  }
}

// out = x + (sum of partials + bias), elementwise.
template <typename T>
__global__ void residual_finalize_kernel(const float* partial, int splits,
                                         const float* bias, const T* x,
                                         T* out, int M, int N) {
  const size_t total = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float d = partial[i];
    for (int z = 1; z < splits; ++z) d += partial[z * total + i];
    if (bias) d += bias[i % N];
    out[i] = from_f32<T>(to_f32(x[i]) + d);
  }
}

static int grid_for(size_t work) {
  return (int)std::min<size_t>((work + 255) / 256, 4096);
}

// ---------------------------------------------------------------- calls
template <typename T>
static int qkv(const Args& p, int splits, const float* cosv,
               const float* sinv, const int* pg, const int* off, T* q_out,
               T* kp, T* vp, int heads, int kv_heads, int D, int P, int psz,
               cudaStream_t st) {
  cudaError_t e = launch_gemm<T, 1, kEpiPartial>(p, splits, st);
  if (e != cudaSuccess) return (int)e;
  qkv_finalize_kernel<T><<<grid_for((size_t)p.M * p.N / 2), 256, 0, st>>>(
      p.partial, splits, p.bias, cosv, sinv, pg, off, q_out, kp, vp, p.M,
      heads, kv_heads, D, P, psz);
  return (int)cudaGetLastError();
}

template <typename T>
static int oproj_norm(const Args& p, int splits, const T* x, const float* nw,
                      const float* nb, T* x_new, T* h, float eps,
                      cudaStream_t st) {
  cudaError_t e = launch_gemm<T, 1, kEpiPartial>(p, splits, st);
  if (e != cudaSuccess) return (int)e;
  oproj_norm_finalize_kernel<T><<<p.M, 1024, 0, st>>>(
      p.partial, splits, p.bias, x, nw, nb, x_new, h, p.M, p.N, eps);
  return (int)cudaGetLastError();
}

template <typename T>
static int ffn(const Args& up, const Args& down, int splits, const T* x,
               T* out, cudaStream_t st) {
  cudaError_t e = launch_gemm<T, 2, kEpiSwiglu>(up, 1, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_gemm<T, 1, kEpiPartial>(down, splits, st);
  if (e != cudaSuccess) return (int)e;
  residual_finalize_kernel<T>
      <<<grid_for((size_t)down.M * down.N), 256, 0, st>>>(
          down.partial, splits, down.bias, x, out, down.M, down.N);
  return (int)cudaGetLastError();
}

template <typename T>
static int chunks(int K) {
  return (K + Tile<T>::BK - 1) / Tile<T>::BK;
}

}  // namespace mega
}  // namespace ptt

using namespace ptt;
using ptt::mega::Args;
using ptt::mega::bf16;

extern "C" {

// out[0], out[1] = (K chunks per slice, slices) that the GEMMs whose
// epilogue needs whole sums take for an [M, K] x [K, N] product of
// `dtype` on `device`; the wrappers size the f32 partials from it
int ptt_mega_split_k(int M, int N, int K, int dtype, int device, int* out) {
  int sms = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  if (M < 0 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    mega::split_k<float>(M, N, K, sms, &out[0], &out[1]);
  else if (dtype == kBF16)
    mega::split_k<bf16>(M, N, K, sms, &out[0], &out[1]);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

// h [T, H]; w [H, N], N = (heads + 2 kv_heads) D; bias [N] f32 or null;
// cos/sin [T, D/2] f32; pools [kv_heads, P, psz, D]; page_idx/page_off [T]
// int32; partial [splits, T, N] f32 workspace -> q_out [T, heads, D]; K/V
// rows written into the pools in place
int ptt_qkv_rope_append(const void* h, const void* w, const void* bias,
                        const void* cosv, const void* sinv, void* k_pages,
                        void* v_pages, const void* page_idx,
                        const void* page_off, void* q_out, void* partial,
                        int T, int H, int heads, int kv_heads, int D, int P,
                        int psz, int kc_split, int splits, int dtype,
                        int device, void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T == 0) return (int)cudaSuccess;
  if (D < 2 || D % 2) return (int)cudaErrorInvalidValue;
  Args p{};
  p.a = h;
  p.w[0] = w;
  p.M = T;
  p.N = (heads + 2 * kv_heads) * D;
  p.K = H;
  p.kc_split = kc_split;
  p.bias = static_cast<const float*>(bias);
  p.partial = static_cast<float*>(partial);
  const float* c = static_cast<const float*>(cosv);
  const float* s = static_cast<const float*>(sinv);
  const int* pg = static_cast<const int*>(page_idx);
  const int* off = static_cast<const int*>(page_off);
  if (dtype == kF32)
    return mega::qkv<float>(p, splits, c, s, pg, off,
                            static_cast<float*>(q_out),
                            static_cast<float*>(k_pages),
                            static_cast<float*>(v_pages), heads, kv_heads, D,
                            P, psz, st);
  if (dtype == kBF16)
    return mega::qkv<bf16>(p, splits, c, s, pg, off, static_cast<bf16*>(q_out),
                           static_cast<bf16*>(k_pages),
                           static_cast<bf16*>(v_pages), heads, kv_heads, D, P,
                           psz, st);
  return (int)cudaErrorInvalidValue;
}

// o [T, Ko]; x [T, H]; w [Ko, H]; bias/nw/nb [H] f32 or null; partial
// [splits, T, H] f32 workspace -> x_new, h [T, H]
int ptt_oproj_norm(const void* o, const void* x, const void* w,
                   const void* bias, const void* nw, const void* nb,
                   void* partial, void* x_new, void* h, int T, int Ko, int H,
                   int kc_split, int splits, float eps, int dtype, int device,
                   void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T == 0) return (int)cudaSuccess;
  Args p{};
  p.a = o;
  p.w[0] = w;
  p.M = T;
  p.N = H;
  p.K = Ko;
  p.kc_split = kc_split;
  p.bias = static_cast<const float*>(bias);
  p.partial = static_cast<float*>(partial);
  const float* g = static_cast<const float*>(nw);
  const float* be = static_cast<const float*>(nb);
  if (dtype == kF32)
    return mega::oproj_norm<float>(p, splits, static_cast<const float*>(x), g,
                                   be, static_cast<float*>(x_new),
                                   static_cast<float*>(h), eps, st);
  if (dtype == kBF16)
    return mega::oproj_norm<bf16>(p, splits, static_cast<const bf16*>(x), g,
                                  be, static_cast<bf16*>(x_new),
                                  static_cast<bf16*>(h), eps, st);
  return (int)cudaErrorInvalidValue;
}

// h, x [T, H]; wg, wu [H, I]; wd [I, H]; b1 [I] / b2 [H] f32 or null;
// act [T, I] workspace in h's dtype; partial [splits, T, H] f32 workspace
// -> out [T, H] = x + ffn(h)
int ptt_ffn(const void* h, const void* x, const void* wg, const void* wu,
            const void* wd, const void* b1, const void* b2, void* act,
            void* partial, void* out, int T, int H, int I,
            int kc_split, int splits, int dtype, int device, void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T == 0) return (int)cudaSuccess;
  Args up{};
  up.a = h;
  up.w[0] = wg;
  up.w[1] = wu;
  up.M = T;
  up.N = I;
  up.K = H;
  up.bias = static_cast<const float*>(b1);
  up.act = act;
  Args down{};
  down.a = act;
  down.w[0] = wd;
  down.M = T;
  down.N = H;
  down.K = I;
  down.kc_split = kc_split;
  down.bias = static_cast<const float*>(b2);
  down.partial = static_cast<float*>(partial);
  if (dtype == kF32) {
    up.kc_split = mega::chunks<float>(H);
    return mega::ffn<float>(up, down, splits, static_cast<const float*>(x),
                            static_cast<float*>(out), st);
  }
  if (dtype == kBF16) {
    up.kc_split = mega::chunks<bf16>(H);
    return mega::ffn<bf16>(up, down, splits, static_cast<const bf16*>(x),
                           static_cast<bf16*>(out), st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
