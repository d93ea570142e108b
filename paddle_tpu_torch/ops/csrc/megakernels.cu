// fused_qkv_rope_append, fused_oproj_norm, fused_ffn and weight_only_linear
// for Hopper (sm_90a), over one GEMM core.
//
// Replaces (fp, int8 and packed-int4 weight sites of each):
//   paddle_tpu/ops/pallas_megafront.py:fused_qkv_rope_append
//     (Pallas _qkv_rope_append_kernel, _qkv_rope_append_int4_kernel): qkv
//     GEMM + bias + rope + paged K/V append;
//   paddle_tpu/ops/pallas_megadecode.py:fused_oproj_norm and fused_ffn,
//     f32 (bf16: megadecode_sm90.cu): o-proj + residual + norm; the FFN;
//   paddle_tpu/ops/quant.py:weight_only_linear, f32 (bf16: wol_sm90.cu)
//     (Pallas _wol_kernel, _wol4_kernel): x @ dequant(W) * scale;
//   paddle_tpu/ops/pallas_megafront.py:fused_qkv_rope_append, MLA layout
//     (Pallas _mla_qkv_rope_append_kernel, fp and int8): [q | kv_a] GEMM,
//     rope on the q tails and k_pe, the latent's RMSNorm, the [latent |
//     k_pe] row into one pool (its finisher below);
//   paddle_tpu/ops/quant.py:int4_dequantize (Pallas _dq4_kernel): packed
//     int4 [K/2, N] + scale -> f32 [K, N], with the GEMM loader's nibble
//     decode (snib), so both read the packing the same way.
//
// Bound on the H100: int4_dequantize moves K/2 * N bytes in and 4 K N out
// (DeepSeek-V2's kv_b [512, 4096]: 1 MB in, 8.4 MB out, 2.8 us at 3.35
// TB/s); the MLA site is bound like the qkv site, by its weight bytes
// (DeepSeek-V2-Lite's [2048, 3648] slab: 14.9 MB bf16, 4.5 us; int8 half).
// At the serving step's shapes (T = 132 token rows,
// Llama-3-8B) the bf16 qkv site is bound by its weight bytes at 3.35 TB/s,
// 50.3 MB (0.0150 ms); its bf16 tensor-core work (2 * T * K * N at 989
// TFLOP/s) takes less than half of that. int8 halves the weight bytes;
// packed int4 quarters them, and at T = 132 the same tensor-core work then
// takes about as long as the bytes.
//
// Design. Every TPU kernel kept its whole weight slab resident in VMEM
// and walked the token rows in order, carrying the f32 accumulator in
// scratch. Here one GEMM core serves all four. With few token rows the
// weights are what moves, so a block owns ALL rows of the step (up to
// 160; more rows take more blocks) by a 256-column tile (2 x 128 for the
// two-accumulator gate/up product): each weight byte crosses from L2
// into an SM once, and the activation tile that every column tile
// re-reads stays below ~0.6 of the weight bytes beside it. A block
// streams its K range through a 4-stage cp.async ring of 16-byte copies
// (zero-filled past the ragged row, column and K edges) and, bf16 (the
// qkv sites), multiplies on the tensor cores with mma.sync m16n8k16 bf16 and f32 accumulators,
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
//   o-proj (f32): one block per row sums the partials, adds bias and
//           residual, stores x_new and normalises the sum (not the
//           rounded x_new) in _norm_f32's op order: rms, or layer norm
//           with its two passes (the mean, then the centred variance
//           mean((x - mu)^2); no one-pass E[x^2] - E[x]^2). Two CUDA
//           kernels.
//   FFN (f32): the [T, I] activation does not fit a block: the gate/up
//           GEMM (two accumulators a block for swiglu, g * sigmoid(g) * u;
//           one for gelu, the tanh form 0.5 g (1 + tanh(sqrt(2/pi) (g +
//           0.044715 g^3))) with tanhf, as jax.nn.gelu(approximate=True);
//           no split) writes the f32 activation to a workspace, as the
//           TPU kernel's f32 scratch holds it. The down GEMM splits K; a
//           third kernel adds the partials, the bias and the residual.
//           Three CUDA kernels per call.
//   weight_only_linear: the same split-K GEMM, then one thread per output
//           sums the partials, applies the scale and stores. Two CUDA
//           kernels per call.
// Quantized weights (int8 [K, N], or packed int4 [K/2, N] with source rows
// 2i, 2i + 1 in the low / high nibble of byte row i; an f32 scale per
// column). The ring streams the int8 bytes (1/2 or 1/4 of the bf16 bytes)
// in 16-byte copies, zero-filled past the edges (byte copies where a row is
// no whole 16-byte piece); each chunk is then converted in shared memory to
// the working type, in source-row order, sign-extending the nibbles, and
// the unchanged ldmatrix / mma.sync (or f32 FMA) path multiplies it: |q| <=
// 127 is exact in bf16. The per-column scale multiplies the f32 sums, never
// the weight (bf16(q * s) would be another function than the TPU kernels'
// f32 q * s): in the qkv pass before the bias and rope, in the o-proj pass
// before the residual and norm, in the gate/up epilogue on g and u before
// the swiglu, and in the FFN's and weight_only_linear's last pass on the
// down / output sums. So the bf16 qkv route equals the TPU kernels' f32
// dot up to summation order, as for fp weights. The int4 down product
// reads the [T, I] activation workspace as it is: the packed rows are in its column
// order already (the TPU kernel split its f32 scratch into even and odd
// columns instead). int4 takes swiglu only, as the TPU kernel does.
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

// The weight's layout: the working type, int8, or packed int4 (the
// wrappers' WFMT codes).
enum WFmt : int { kWFp = 0, kWInt8 = 1, kWInt4 = 2 };

// A block's tile: BM = 32 * MT rows (MT 16-row tiles a warp) by BN
// columns of each of its NB accumulators. bf16 tiles (one accumulator)
// are 160 rows (the 8B serving step's 132 rows in one tile; fewer rows
// leave the tail's warps idle, more take more blocks) by 256 columns, so
// the activation tile, which every column tile re-reads, is at most ~0.6
// of the weight bytes that cross into the SM with it. f32 tiles are 64 x
// 128. A ring stage holds the A chunk and each weight chunk as it
// arrives: [BK][LDW] in the working type, or, quantized, the chunk's int8
// rows (BK of them, or BK / 2 of packed int4), BN bytes each; quantized
// weights also take one converted [BK][LDW] tile per accumulator beside
// the ring.
template <typename T, int NB, int WQ = kWFp>
struct Cfg {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static_assert(NB == 1 || !kBf16, "bf16 takes one accumulator");
  static constexpr int MT = kBf16 ? 5 : 2;
  // threads: bf16 16 warps as 2 (rows) x 8 (columns), four a scheduler
  // to hide the ldmatrix -> mma latency; f32 a 16 x 16 grid
  static constexpr int NT = kBf16 ? 512 : 256;
  static constexpr int WARPS_N = NT / 64;
  static constexpr int BM = 32 * MT;
  static constexpr int BN = kBf16 ? 256 : 128;
  static constexpr int BK = Tile<T>::BK;
  static constexpr int LDA = BK + Tile<T>::PAD;
  static constexpr int LDW = BN + Tile<T>::PAD;
  static constexpr int LDC = BN + 4;
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int W_ELEMS = BK * LDW;
  static constexpr size_t A_BYTES = (size_t)A_ELEMS * sizeof(T);
  static constexpr int W_ROWS = WQ == kWInt4 ? BK / 2 : BK;
  static constexpr size_t RAW_BYTES = (size_t)W_ROWS * BN;
  static constexpr size_t W_BYTES =
      WQ == kWFp ? (size_t)W_ELEMS * sizeof(T) : RAW_BYTES;
  static constexpr size_t STAGE_BYTES = A_BYTES + NB * W_BYTES;
  static constexpr size_t CONV_BYTES =
      WQ == kWFp ? 0 : (size_t)NB * W_ELEMS * sizeof(T);
  // cp.async ring depth: 4 stages where they fit, else 3, else 2
  static constexpr int STAGES =
      4 * STAGE_BYTES + CONV_BYTES <= SMEM_MAX   ? 4
      : 3 * STAGE_BYTES + CONV_BYTES <= SMEM_MAX ? 3
                                                 : 2;
  static constexpr size_t PIPE_BYTES = STAGES * STAGE_BYTES + CONV_BYTES;
  static constexpr size_t C_BYTES = (size_t)NB * BM * LDC * sizeof(float);
  static constexpr size_t SMEM = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;
};

enum Epi : int { kEpiSwiglu = 0, kEpiPartial = 1, kEpiGelu = 2 };

struct Args {
  const void* a;          // A [M, K]
  const void* w[2];       // W [K, N] (int4: [K/2, N]), one accumulator each
  const float* scale[2];  // [N] per-column scales of quantized W, or null
  int M, N, K;
  int kc_split;           // BK chunks per grid.z slice of K
  int w_vec;              // quantized W rows copied in 16-byte pieces
  const float* bias;      // [N] or null (kEpiSwiglu, kEpiGelu)
  float* partial;         // [gridDim.z, M, N] (kEpiPartial)
  float* act;             // activation [M, N] (kEpiSwiglu, kEpiGelu)
};

template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T v[4];
};

// One K chunk [k0, k0 + BK) of the A tile and every W tile into a stage.
template <typename T, typename C, int NB, int WQ>
__device__ __forceinline__ void load_stage(unsigned char* st, const Args& p,
                                           int m0, int n0, int k0,
                                           int kend) {
  constexpr int VE = 16 / sizeof(T);
  constexpr int AROW = C::BK / VE;
  {
    const T* A = static_cast<const T*>(p.a);
    T* sa = reinterpret_cast<T*>(st);
    for (int c = threadIdx.x; c < C::BM * AROW; c += C::NT) {
      const int r = c / AROW, kc = (c % AROW) * VE;
      const int m = m0 + r, k = k0 + kc;
      const bool ok = m < p.M && k < kend;
      cp_async16(sa + r * C::LDA + kc, ok ? A + (size_t)m * p.K + k : A, ok);
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    unsigned char* dst = st + C::A_BYTES + b * C::W_BYTES;
    if constexpr (WQ == kWFp) {
      constexpr int WROW = C::BN / VE;
      const T* W = static_cast<const T*>(p.w[b]);
      T* dw = reinterpret_cast<T*>(dst);
      for (int c = threadIdx.x; c < C::BK * WROW; c += C::NT) {
        const int r = c / WROW, nc = (c % WROW) * VE;
        const int k = k0 + r, n = n0 + nc;
        const bool ok = k < kend && n < p.N;
        cp_async16(dw + r * C::LDW + nc, ok ? W + (size_t)k * p.N + n : W,
                   ok);
      }
    } else {
      // the chunk's int8 rows: source rows k0.. (int8), or packed rows
      // k0 / 2.. (int4; K, k0 and kend are even)
      constexpr int PACK = WQ == kWInt4 ? 2 : 1, WROW = C::BN / 16;
      const signed char* W = static_cast<const signed char*>(p.w[b]);
      const int r0 = k0 / PACK, rend = kend / PACK;
      for (int c = threadIdx.x; c < C::W_ROWS * WROW; c += C::NT) {
        const int r = c / WROW, nc = (c % WROW) * 16;
        const int k = r0 + r, n = n0 + nc;
        unsigned char* d = dst + r * C::BN + nc;
        if (p.w_vec) {
          const bool ok = k < rend && n < p.N;
          cp_async16(d, ok ? W + (size_t)k * p.N + n : W, ok);
        } else {
          // rows that are no whole 16-byte pieces: masked byte loads
#pragma unroll
          for (int e = 0; e < 16; ++e)
            d[e] = k < rend && n + e < p.N
                       ? (unsigned char)W[(size_t)k * p.N + n + e]
                       : 0;
        }
      }
    }
  }
}

// A byte, and a nibble, as the signed value it holds.
__device__ __forceinline__ int sbyte(unsigned v) {
  return (int)((v & 0xFFu) ^ 0x80u) - 0x80;
}
__device__ __forceinline__ int snib(unsigned v) {
  return (int)((v & 0xFu) ^ 0x8u) - 0x8;
}

// A quantized chunk from its ring stage into the tile the multiply reads
// ([BK][LDW] of T, source-row order): int8 values as they are; int4 byte
// (r, n) gives source rows 2r (low nibble) and 2r + 1 (high nibble).
template <typename T, typename C, int NB, int WQ>
__device__ __forceinline__ void convert_stage(const unsigned char* raw,
                                              T* conv) {
  constexpr int WORDS = C::BN / 4;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const unsigned char* src = raw + b * C::W_BYTES;
    T* dst = conv + b * C::W_ELEMS;
    for (int c = threadIdx.x; c < C::W_ROWS * WORDS; c += C::NT) {
      const int r = c / WORDS, n = (c % WORDS) * 4;
      const unsigned v =
          *reinterpret_cast<const unsigned*>(src + r * C::BN + n);
      Vec4<T> lo, hi;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned byte = v >> (8 * e);
        if constexpr (WQ == kWInt8) {
          lo.v[e] = from_f32<T>((float)sbyte(byte));
        } else {
          lo.v[e] = from_f32<T>((float)snib(byte));
          hi.v[e] = from_f32<T>((float)snib(byte >> 4));
        }
      }
      if constexpr (WQ == kWInt8) {
        *reinterpret_cast<Vec4<T>*>(dst + r * C::LDW + n) = lo;
      } else {
        *reinterpret_cast<Vec4<T>*>(dst + 2 * r * C::LDW + n) = lo;
        *reinterpret_cast<Vec4<T>*>(dst + (2 * r + 1) * C::LDW + n) = hi;
      }
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

  // One chunk, 16 deep at a time: the warp's B fragments first, then its
  // row tiles (ldmatrix and mma issue in program order). a: the A tile
  // [BM][LDA]; w: the NB weight tiles [BK][LDW].
  // live: the block's 16-row tiles that hold rows (a warp-uniform skip).
  __device__ void step(const bf16* a, const bf16* w, int wm, int wn,
                       int live) {
    const int lane = threadIdx.x & 31;
    const int lr = lane & 15, lc = (lane >> 4) * 8;
    const int tiles = min(MT, live - wm * MT);
    if (tiles <= 0) return;
    const bf16* arow = a + (wm * 16 * MT + lr) * C::LDA + lc;
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 16) {
      unsigned bfr[NB][WN / 2][4];  // b0, b1 of n8 tiles 2 jp, 2 jp + 1
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int jp = 0; jp < WN / 2; ++jp)
          ldsm_x4_trans(bfr[b][jp], w + b * C::W_ELEMS +
                                        (kk + lr) * C::LDW +
                                        wn * (C::BN / C::WARPS_N) + jp * 16 +
                                        lc);
      // tile i + 1's fragment loads while tile i multiplies
      unsigned af[2][4];
      ldsm_x4(af[0], arow + kk);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i >= tiles) break;
        if (i + 1 < tiles)
          ldsm_x4(af[(i + 1) & 1], arow + (i + 1) * 16 * C::LDA + kk);
        const int cur = i & 1;
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int jp = 0; jp < WN / 2; ++jp) {
            mma_bf16(acc[b][i][2 * jp], af[cur], bfr[b][jp][0],
                     bfr[b][jp][1]);
            mma_bf16(acc[b][i][2 * jp + 1], af[cur], bfr[b][jp][2],
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

  __device__ void step(const float* a, const float* w, int, int, int) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
    for (int kk = 0; kk < C::BK; ++kk) {
      float av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * C::LDA + kk];
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float wv = w[b * C::W_ELEMS + kk * C::LDW + tx + 16 * j];
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
// Every epilogue walks the tile's live rows 4 columns a thread. The
// activation ones take N % 8 == 0 (4 columns are all inside N or all past
// it); the partial one stores N's ragged tail column by column.

// tanh-GELU in jax.nn.gelu(approximate=True)'s op order; tanhf, not
// tanh.approx.f32 (whose ~2^-11 error the plain version would not share)
__device__ __forceinline__ float gelu_tanh(float g) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return g * (0.5f * (1.f + tanhf(k * (g + 0.044715f * (g * g * g)))));
}

// The f32 activation (swiglu: g * sigmoid(g) * u from the two
// accumulators; gelu: gelu(g) from one), scales before the bias.
template <typename C, int EPI>
__device__ void epi_act(const Args& p, const float* Cs, int m0, int n0) {
  const float* Cg = Cs;
  const float* Cu = Cs + C::BM * C::LDC;  // swiglu's second accumulator
  const int rows = min(C::BM, p.M - m0);
  for (int i = threadIdx.x; i < rows * (C::BN / 4); i += C::NT) {
    const int r = i / (C::BN / 4), c = (i % (C::BN / 4)) * 4;
    const int n = n0 + c;
    if (n >= p.N) continue;
    float a[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float g = Cg[r * C::LDC + c + e];
      if (p.scale[0]) g *= p.scale[0][n + e];
      if (p.bias) g += p.bias[n + e];
      if constexpr (EPI == kEpiSwiglu) {
        float u = Cu[r * C::LDC + c + e];
        if (p.scale[1]) u *= p.scale[1][n + e];
        a[e] = g * (1.f / (1.f + expf(-g))) * u;
      } else {
        a[e] = gelu_tanh(g);
      }
    }
    *reinterpret_cast<float4*>(p.act + (size_t)(m0 + r) * p.N + n) =
        make_float4(a[0], a[1], a[2], a[3]);
  }
}

template <typename C>
__device__ void epi_partial(const Args& p, const float* Cs, int m0, int n0) {
  float* out = p.partial + (size_t)blockIdx.z * p.M * p.N;
  const int rows = min(C::BM, p.M - m0);
  for (int i = threadIdx.x; i < rows * (C::BN / 4); i += C::NT) {
    const int r = i / (C::BN / 4), c = (i % (C::BN / 4)) * 4;
    const int n = n0 + c;
    if (n >= p.N) continue;
    float* dst = out + (size_t)(m0 + r) * p.N + n;
    const float* src = Cs + r * C::LDC + c;
    if ((p.N & 3) == 0) {
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    } else {
      for (int e = 0; e < 4 && n + e < p.N; ++e) dst[e] = src[e];
    }
  }
}

// ------------------------------------------------------------ GEMM core
template <typename T, int NB, int EPI, int WQ>
__global__ void __launch_bounds__(Cfg<T, NB, WQ>::NT)
    gemm_kernel(const Args p) {
  using C = Cfg<T, NB, WQ>;
  using Mma = typename std::conditional<C::kBf16, MmaBf16<C, NB>,
                                        FmaF32<C, NB>>::type;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* conv = reinterpret_cast<T*>(smem_raw + C::STAGES * C::STAGE_BYTES);
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
      load_stage<T, C, NB, WQ>(smem_raw + s * C::STAGE_BYTES, p, m0, n0,
                               (c0 + s) * C::BK, kend);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<C::STAGES - 2>();  // chunk kt has landed
    __syncthreads();              // ... for every thread; kt-1 is consumed
    const int nxt = kt + C::STAGES - 1;
    if (nxt < nk)
      load_stage<T, C, NB, WQ>(
          smem_raw + (nxt % C::STAGES) * C::STAGE_BYTES, p, m0, n0,
          (c0 + nxt) * C::BK, kend);
    cp_async_commit();
    const unsigned char* st = smem_raw + (kt % C::STAGES) * C::STAGE_BYTES;
    const T* a = reinterpret_cast<const T*>(st);
    if constexpr (WQ == kWFp) {
      mma.step(a, reinterpret_cast<const T*>(st + C::A_BYTES), wm, wn,
               live);
    } else {
      convert_stage<T, C, NB, WQ>(st + C::A_BYTES, conv);
      __syncthreads();            // the converted chunk, for every warp
      mma.step(a, conv, wm, wn, live);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the accumulator tile reuses it
  float* Cs = reinterpret_cast<float*>(smem_raw);
  mma.store(Cs, wm, wn);
  __syncthreads();
  if constexpr (EPI == kEpiPartial)
    epi_partial<C>(p, Cs, m0, n0);
  else
    epi_act<C, EPI>(p, Cs, m0, n0);
}

template <typename T, int NB, int EPI, int WQ>
static cudaError_t launch_gemm(const Args& p, int splits, cudaStream_t st) {
  using C = Cfg<T, NB, WQ>;
  const int kc_total = (p.K + C::BK - 1) / C::BK;
  // every grid.z slice holds at least one chunk, and they cover K
  if (splits < 1 || p.kc_split < 1 || (splits - 1) * p.kc_split >= kc_total ||
      splits * p.kc_split < kc_total || (EPI != kEpiPartial && splits != 1))
    return cudaErrorInvalidValue;
  auto kern = gemm_kernel<T, NB, EPI, WQ>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid((p.M + C::BM - 1) / C::BM, (p.N + C::BN - 1) / C::BN, splits);
  kern<<<grid, C::NT, C::SMEM, st>>>(p);
  return cudaGetLastError();
}

// launch_gemm for the weight layout `wq` (a WFmt).
template <typename T, int NB, int EPI>
static cudaError_t launch_gemm_w(const Args& p, int splits, int wq,
                                 cudaStream_t st) {
  if (wq == kWFp) return launch_gemm<T, NB, EPI, kWFp>(p, splits, st);
  if (wq == kWInt8) return launch_gemm<T, NB, EPI, kWInt8>(p, splits, st);
  if (wq == kWInt4) return launch_gemm<T, NB, EPI, kWInt4>(p, splits, st);
  return cudaErrorInvalidValue;
}

// The split of K over grid.z for a one-accumulator [M, K] x [K, N] product
// on `sms` SMs: the slice count that minimises the waves of blocks per
// unit of work plus the partials' cost (each more slice writes and reads
// one more [M, N] f32 partial, taken as 1% of a wave), at most 8 slices
// and at least 4 K chunks a slice. Ties keep fewer. The tiles are the
// same for every weight layout.
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
// `scale` (quantized weights, else null) multiplies each column's sum of
// the partials before anything is added to it.
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

// One thread per rope pair (t, head, j): sum the partials, scale, add the
// bias, rope q and k on the f32 sums, write q_out and the K/V rows.
template <typename T>
__global__ void qkv_finalize_kernel(const float* partial, int splits,
                                    const float* scale, const float* bias,
                                    const float* cosv, const float* sinv,
                                    const int* page_idx, const int* page_off,
                                    T* q_out, T* kp, T* vp, int M, int heads,
                                    int kv_heads, int D, int P, int psz) {
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
    if (scale) {
      x1 *= scale[g1];
      x2 *= scale[g2];
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
// read with every thread's loads in flight): x_new = x + (scaled sum of
// partials + bias); h = norm(that sum) * nw + nb, the norm rms (layer 0)
// or layer norm (layer 1: the mean, then the centred variance over a
// second pass). Split 0's row holds the sum between the passes; each
// thread reads back only the entries it wrote.
__global__ void oproj_norm_finalize_kernel(float* partial, int splits,
                                           const float* scale,
                                           const float* bias, const float* x,
                                           const float* nw, const float* nb,
                                           float* x_new, float* h, int M,
                                           int N, float eps, int layer) {
  __shared__ float red[33];
  const int t = blockIdx.x;
  const size_t total = (size_t)M * N, base = (size_t)t * N;
  float* row = partial + base;
  float acc = 0.f;  // layer: the sum; rms: the sum of squares
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float pv = row[n];
#pragma unroll 4
    for (int z = 1; z < splits; ++z) pv += partial[z * total + base + n];
    if (scale) pv *= scale[n];
    if (bias) pv += bias[n];
    const float xs = x[base + n] + pv;
    row[n] = xs;
    x_new[base + n] = xs;
    acc += layer ? xs : xs * xs;
  }
  const float tot = block_sum(acc, red) / (float)N;
  float mu = 0.f, r;
  if (layer) {
    mu = tot;
    float ss = 0.f;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      const float c = row[n] - mu;
      ss += c * c;
    }
    r = rsqrtf(block_sum(ss, red) / (float)N + eps);
  } else {
    r = rsqrtf(tot + eps);
  }
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float y = (row[n] - mu) * r;
    if (nw) y *= nw[n];
    if (nb) y += nb[n];
    h[base + n] = y;
  }
}

// out = x + (scaled sum of partials + bias), elementwise; x null: out is
// the scaled sum alone (weight_only_linear).
template <typename T>
__global__ void residual_finalize_kernel(const float* partial, int splits,
                                         const float* scale,
                                         const float* bias, const T* x,
                                         T* out, int M, int N) {
  const size_t total = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float d = partial[i];
    for (int z = 1; z < splits; ++z) d += partial[z * total + i];
    if (scale) d *= scale[i % N];
    if (bias) d += bias[i % N];
    out[i] = from_f32<T>(x ? to_f32(x[i]) + d : d);
  }
}

// The MLA site's finisher, one block per token row t (the latent's norm
// reduces over r columns that span several GEMM column tiles): the row's
// summed, scaled partials [q heads | latent | k_pe] land in shared memory
// as f32; q's nope dims are stored as they are and its rope tail (dims dn
// .. dn + dr of each head, half-split pairs j, j + dr / 2) and k_pe are
// roped on the f32 sums; the latent is normed in _rms_kernel's op order,
// (lat * rsqrt(mean(lat^2) + eps)) * g, on the f32 sum (never a rounded
// copy); q goes to q_out [T, nh, dn + dr] and [latent | k_pe] to the
// pool [1, P, psz, r + dr] at the clamped page and offset.
template <typename T>
__global__ void mla_finalize_kernel(const float* partial, int splits,
                                    const float* scale, const float* cosv,
                                    const float* sinv, const float* g,
                                    const int* page_idx, const int* page_off,
                                    T* q_out, T* pool, int M, int nh, int dn,
                                    int dr, int r, int P, int psz,
                                    float eps) {
  extern __shared__ float row[];  // [N]
  __shared__ float red[33];
  const int t = blockIdx.x;
  const int dh = dn + dr, nq = nh * dh, N = nq + r + dr, d2 = dr / 2;
  const size_t total = (size_t)M * N, base = (size_t)t * N;
  float ss = 0.f;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float v = partial[base + n];
    for (int z = 1; z < splits; ++z) v += partial[z * total + base + n];
    if (scale) v *= scale[n];
    row[n] = v;
    if (n >= nq && n < nq + r) ss += v * v;
  }
  const float rinv = rsqrtf(block_sum(ss, red) / (float)r + eps);
  const float* c = cosv + (size_t)t * d2;
  const float* sn = sinv + (size_t)t * d2;
  for (int i = threadIdx.x; i < nq; i += blockDim.x) {
    const int h = i / dh, j = i - h * dh;
    const float* x = row + h * dh + dn;  // the head's rope tail
    float y;
    if (j < dn) {
      y = row[i];
    } else if (j - dn < d2) {
      const int k = j - dn;
      y = x[k] * c[k] - x[k + d2] * sn[k];
    } else {
      const int k = j - dn - d2;
      y = x[k + d2] * c[k] + x[k] * sn[k];
    }
    q_out[(size_t)t * nq + i] = from_f32<T>(y);
  }
  const int pg = min(max(page_idx[t], 0), P - 1);
  const int off = min(max(page_off[t], 0), psz - 1);
  T* dst = pool + ((size_t)pg * psz + off) * (r + dr);
  const float* kpe = row + nq + r;
  for (int i = threadIdx.x; i < r + dr; i += blockDim.x) {
    float y;
    if (i < r) {
      y = row[nq + i] * rinv * g[i];
    } else if (i - r < d2) {
      const int k = i - r;
      y = kpe[k] * c[k] - kpe[k + d2] * sn[k];
    } else {
      const int k = i - r - d2;
      y = kpe[k + d2] * c[k] + kpe[k] * sn[k];
    }
    dst[i] = from_f32<T>(y);
  }
}

// One thread per packed byte (i, n) of int4_dequantize: source rows 2i
// (low nibble) and 2i + 1 (high nibble), sign-extended by snib, times the
// f32 scale: an exact int times an f32, rounded once, as
// weight_dequantize's int4 route does, so card and CPU agree bit for bit.
__global__ void int4_dequantize_kernel(const signed char* __restrict__ qw,
                                       const float* __restrict__ scale,
                                       float* __restrict__ out, int K2,
                                       int N) {
  const size_t total = (size_t)K2 * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t k = i / N;
    const int n = (int)(i - k * N);
    const unsigned v = (unsigned char)qw[i];
    const float s = scale[n];
    out[2 * k * N + n] = (float)snib(v) * s;
    out[(2 * k + 1) * N + n] = (float)snib(v >> 4) * s;
  }
}

static int grid_for(size_t work) {
  return (int)std::min<size_t>((work + 255) / 256, 4096);
}

// ---------------------------------------------------------------- calls
template <typename T>
static int qkv(const Args& p, int splits, int wq, const float* cosv,
               const float* sinv, const int* pg, const int* off, T* q_out,
               T* kp, T* vp, int heads, int kv_heads, int D, int P, int psz,
               cudaStream_t st) {
  cudaError_t e = launch_gemm_w<T, 1, kEpiPartial>(p, splits, wq, st);
  if (e != cudaSuccess) return (int)e;
  qkv_finalize_kernel<T><<<grid_for((size_t)p.M * p.N / 2), 256, 0, st>>>(
      p.partial, splits, p.scale[0], p.bias, cosv, sinv, pg, off, q_out, kp,
      vp, p.M, heads, kv_heads, D, P, psz);
  return (int)cudaGetLastError();
}

template <typename T>
static int mla_qkv(const Args& p, int splits, int wq, const float* cosv,
                   const float* sinv, const float* g, const int* pg,
                   const int* off, T* q_out, T* pool, int nh, int dn, int dr,
                   int r, int P, int psz, float eps, cudaStream_t st) {
  cudaError_t e = launch_gemm_w<T, 1, kEpiPartial>(p, splits, wq, st);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)p.N * sizeof(float);
  e = cudaFuncSetAttribute(mla_finalize_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  mla_finalize_kernel<T><<<p.M, 256, smem, st>>>(
      p.partial, splits, p.scale[0], cosv, sinv, g, pg, off, q_out, pool,
      p.M, nh, dn, dr, r, P, psz, eps);
  return (int)cudaGetLastError();
}

static int oproj_norm(const Args& p, int splits, int wq, const float* x,
                      const float* nw, const float* nb, float* x_new,
                      float* h, float eps, int layer, cudaStream_t st) {
  cudaError_t e = launch_gemm_w<float, 1, kEpiPartial>(p, splits, wq, st);
  if (e != cudaSuccess) return (int)e;
  oproj_norm_finalize_kernel<<<p.M, 1024, 0, st>>>(
      p.partial, splits, p.scale[0], p.bias, x, nw, nb, x_new, h, p.M, p.N,
      eps, layer);
  return (int)cudaGetLastError();
}

// gelu 0: swiglu over the two accumulators; 1: gelu over one.
static int ffn(const Args& up, const Args& down, int splits, int wq,
               int gelu, const float* x, float* out, cudaStream_t st) {
  cudaError_t e =
      gelu ? launch_gemm_w<float, 1, kEpiGelu>(up, 1, wq, st)
           : launch_gemm_w<float, 2, kEpiSwiglu>(up, 1, wq, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_gemm_w<float, 1, kEpiPartial>(down, splits, wq, st);
  if (e != cudaSuccess) return (int)e;
  residual_finalize_kernel<float>
      <<<grid_for((size_t)down.M * down.N), 256, 0, st>>>(
          down.partial, splits, down.scale[0], down.bias, x, out, down.M,
          down.N);
  return (int)cudaGetLastError();
}

template <typename T>
static int wol(const Args& p, int splits, int wq, T* out, cudaStream_t st) {
  cudaError_t e = launch_gemm_w<T, 1, kEpiPartial>(p, splits, wq, st);
  if (e != cudaSuccess) return (int)e;
  residual_finalize_kernel<T><<<grid_for((size_t)p.M * p.N), 256, 0, st>>>(
      p.partial, splits, p.scale[0], nullptr, nullptr, out, p.M, p.N);
  return (int)cudaGetLastError();
}

template <typename T>
static int chunks(int K) {
  return (K + Tile<T>::BK - 1) / Tile<T>::BK;
}

// Checks a weight layout, and whether its rows take 16-byte copies: wq a
// WFmt; a quantized layout needs its scales, int4 an even K.
static bool set_weights(Args& p, int wq, int nb, const void* const* w,
                        const void* const* scale) {
  if (wq < kWFp || wq > kWInt4 || (wq == kWInt4 && p.K % 2)) return false;
  p.w_vec = p.N % 16 == 0;
  for (int b = 0; b < nb; ++b) {
    p.w[b] = w[b];
    p.scale[b] = wq == kWFp ? nullptr : static_cast<const float*>(scale[b]);
    if (wq != kWFp && !p.scale[b]) return false;
    if (reinterpret_cast<uintptr_t>(w[b]) % 16) p.w_vec = 0;
  }
  return true;
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

// h [T, H]; w [H, N] (int4 [H/2, N]), N = (heads + 2 kv_heads) D; scale
// [N] f32 (quantized w) or null; bias [N] f32 or null; cos/sin [T, D/2]
// f32; pools [kv_heads, P, psz, D]; page_idx/page_off [T] int32; partial
// [splits, T, N] f32 workspace -> q_out [T, heads, D]; K/V rows written
// into the pools in place
int ptt_qkv_rope_append(const void* h, const void* w, const void* scale,
                        const void* bias, const void* cosv, const void* sinv,
                        void* k_pages, void* v_pages, const void* page_idx,
                        const void* page_off, void* q_out, void* partial,
                        int T, int H, int heads, int kv_heads, int D, int P,
                        int psz, int kc_split, int splits, int wfmt,
                        int dtype, int device, void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T == 0) return (int)cudaSuccess;
  if (D < 2 || D % 2) return (int)cudaErrorInvalidValue;
  Args p{};
  p.a = h;
  p.M = T;
  p.N = (heads + 2 * kv_heads) * D;
  p.K = H;
  if (!mega::set_weights(p, wfmt, 1, &w, &scale))
    return (int)cudaErrorInvalidValue;
  p.kc_split = kc_split;
  p.bias = static_cast<const float*>(bias);
  p.partial = static_cast<float*>(partial);
  const float* c = static_cast<const float*>(cosv);
  const float* s = static_cast<const float*>(sinv);
  const int* pg = static_cast<const int*>(page_idx);
  const int* off = static_cast<const int*>(page_off);
  if (dtype == kF32)
    return mega::qkv<float>(p, splits, wfmt, c, s, pg, off,
                            static_cast<float*>(q_out),
                            static_cast<float*>(k_pages),
                            static_cast<float*>(v_pages), heads, kv_heads, D,
                            P, psz, st);
  if (dtype == kBF16)
    return mega::qkv<bf16>(p, splits, wfmt, c, s, pg, off,
                           static_cast<bf16*>(q_out),
                           static_cast<bf16*>(k_pages),
                           static_cast<bf16*>(v_pages), heads, kv_heads, D, P,
                           psz, st);
  return (int)cudaErrorInvalidValue;
}

// The MLA site: h [T, H]; w [H, N] (fp or int8; N = heads (dn + dr) + r +
// dr, columns [q | kv_a]); scale [N] f32 (int8) or null; cos/sin [T, dr/2]
// f32; g [r] f32 (the latent norm's weight); pool [1, P, psz, r + dr];
// page_idx/page_off [T] int32; partial [splits, T, N] f32 workspace ->
// q_out [T, heads, dn + dr]; the [latent | k_pe] rows into the pool in
// place. No packed int4 site, as in the JAX package.
int ptt_mla_qkv_rope_append(const void* h, const void* w, const void* scale,
                            const void* cosv, const void* sinv,
                            const void* g, void* pool, const void* page_idx,
                            const void* page_off, void* q_out, void* partial,
                            int T, int H, int heads, int dn, int dr, int r,
                            int P, int psz, int kc_split, int splits,
                            float eps, int wfmt, int dtype, int device,
                            void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T == 0) return (int)cudaSuccess;
  if (dr < 2 || dr % 2 || r < 1 || wfmt == mega::kWInt4)
    return (int)cudaErrorInvalidValue;
  Args p{};
  p.a = h;
  p.M = T;
  p.N = heads * (dn + dr) + r + dr;
  p.K = H;
  if (!mega::set_weights(p, wfmt, 1, &w, &scale))
    return (int)cudaErrorInvalidValue;
  p.kc_split = kc_split;
  p.partial = static_cast<float*>(partial);
  const float* c = static_cast<const float*>(cosv);
  const float* s = static_cast<const float*>(sinv);
  const float* gn = static_cast<const float*>(g);
  const int* pg = static_cast<const int*>(page_idx);
  const int* off = static_cast<const int*>(page_off);
  if (dtype == kF32)
    return mega::mla_qkv<float>(p, splits, wfmt, c, s, gn, pg, off,
                                static_cast<float*>(q_out),
                                static_cast<float*>(pool), heads, dn, dr, r,
                                P, psz, eps, st);
  if (dtype == kBF16)
    return mega::mla_qkv<bf16>(p, splits, wfmt, c, s, gn, pg, off,
                               static_cast<bf16*>(q_out),
                               static_cast<bf16*>(pool), heads, dn, dr, r, P,
                               psz, eps, st);
  return (int)cudaErrorInvalidValue;
}

// qw packed int4 [K2, N] (int8 bytes), scale [N] f32 -> out f32 [2 K2, N]
int ptt_int4_dequantize(const void* qw, const void* scale, void* out, int K2,
                        int N, int device, void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K2 == 0 || N == 0) return (int)cudaSuccess;
  mega::int4_dequantize_kernel<<<mega::grid_for((size_t)K2 * N), 256, 0,
                                 st>>>(
      static_cast<const signed char*>(qw), static_cast<const float*>(scale),
      static_cast<float*>(out), K2, N);
  return (int)cudaGetLastError();
}

// The f32 route (bf16: ptt_md_oproj_norm, megadecode_sm90.cu). o [T,
// Ko]; x [T, H]; w [Ko, H] (int4 [Ko/2, H]); scale [H] or null;
// bias/nw/nb [H] or null; partial [splits, T, H] workspace; layer 0: rms
// norm, 1: layer norm -> x_new, h [T, H]; all f32
int ptt_oproj_norm(const void* o, const void* x, const void* w,
                   const void* scale, const void* bias, const void* nw,
                   const void* nb, void* partial, void* x_new, void* h,
                   int T, int Ko, int H, int kc_split, int splits, float eps,
                   int layer, int wfmt, int device, void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T == 0) return (int)cudaSuccess;
  if (layer != 0 && layer != 1) return (int)cudaErrorInvalidValue;
  Args p{};
  p.a = o;
  p.M = T;
  p.N = H;
  p.K = Ko;
  if (!mega::set_weights(p, wfmt, 1, &w, &scale))
    return (int)cudaErrorInvalidValue;
  p.kc_split = kc_split;
  p.bias = static_cast<const float*>(bias);
  p.partial = static_cast<float*>(partial);
  const float* g = static_cast<const float*>(nw);
  const float* be = static_cast<const float*>(nb);
  return mega::oproj_norm(p, splits, wfmt, static_cast<const float*>(x), g,
                          be, static_cast<float*>(x_new),
                          static_cast<float*>(h), eps, layer, st);
}

// The f32 route (bf16: ptt_md_ffn, megadecode_sm90.cu). h, x [T, H]; wg,
// wu [H, I] (int4 [H/2, I]); wd [I, H] (int4 [I/2, H]); sg, su [I] / sd
// [H] (quantized) or null; b1 [I] / b2 [H] or null; gelu 0: swiglu (wg,
// wu), 1: gelu (wg alone; not int4); act [T, I] workspace; partial
// [splits, T, H] workspace -> out [T, H] = x + ffn(h); all f32
int ptt_ffn(const void* h, const void* x, const void* wg, const void* wu,
            const void* wd, const void* sg, const void* su, const void* sd,
            const void* b1, const void* b2, void* act, void* partial,
            void* out, int T, int H, int I, int kc_split, int splits,
            int gelu, int wfmt, int device, void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T == 0) return (int)cudaSuccess;
  if ((gelu != 0 && gelu != 1) || (gelu && wfmt == mega::kWInt4))
    return (int)cudaErrorInvalidValue;
  Args up{};
  up.a = h;
  up.M = T;
  up.N = I;
  up.K = H;
  const void* wgu[2] = {wg, wu};
  const void* sgu[2] = {sg, su};
  up.bias = static_cast<const float*>(b1);
  up.act = static_cast<float*>(act);
  Args down{};
  down.a = act;
  down.M = T;
  down.N = H;
  down.K = I;
  if (!mega::set_weights(up, wfmt, gelu ? 1 : 2, wgu, sgu) ||
      !mega::set_weights(down, wfmt, 1, &wd, &sd))
    return (int)cudaErrorInvalidValue;
  down.kc_split = kc_split;
  down.bias = static_cast<const float*>(b2);
  down.partial = static_cast<float*>(partial);
  up.kc_split = mega::chunks<float>(H);
  return mega::ffn(up, down, splits, wfmt, gelu, static_cast<const float*>(x),
                   static_cast<float*>(out), st);
}

// x [M, K] f32; qw int8 [K, N] (wfmt 1) or packed int4 [K/2, N] (wfmt 2);
// scale [N] f32; partial [splits, M, N] f32 workspace -> out [M, N] f32
int ptt_weight_only_linear(const void* x, const void* qw, const void* scale,
                           void* partial, void* out, int M, int N, int K,
                           int kc_split, int splits, int wfmt, int dtype,
                           int device, void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return (int)cudaSuccess;
  Args p{};
  p.a = x;
  p.M = M;
  p.N = N;
  p.K = K;
  if (wfmt == mega::kWFp || !mega::set_weights(p, wfmt, 1, &qw, &scale))
    return (int)cudaErrorInvalidValue;
  p.kc_split = kc_split;
  p.partial = static_cast<float*>(partial);
  // bf16 runs csrc/wol_sm90.cu (ptt_wol_sm90)
  if (dtype == kF32)
    return mega::wol<float>(p, splits, wfmt, static_cast<float*>(out), st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
