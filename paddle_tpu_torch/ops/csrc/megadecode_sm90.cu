// fused_oproj_norm and fused_ffn's bf16 route for Hopper (sm_90a): the
// transposed product on wgmma, fed by TMA, K slices merged in the launch.
//
// Replaces (bf16 activations, every weight layout; the f32 route stays on
// megakernels.cu's GEMM core, whose true f32 products keep its 2e-5 gate):
//   paddle_tpu/ops/pallas_megadecode.py:fused_oproj_norm (Pallas
//     _oproj_norm_kernel, fp and int8; _oproj_norm_int4_kernel): o-proj
//     GEMM + bias + residual + rms or layer norm, x_new and its normed h;
//   paddle_tpu/ops/pallas_megadecode.py:fused_ffn (Pallas _ffn_kernel, fp
//     and int8, swiglu or tanh-gelu; _ffn_int4_kernel, swiglu): gate/up
//     GEMM, the activation, down GEMM, b2 and the residual.
//
// Contract (the TPU kernels'): every product is an f32 sum of exact bf16 x
// bf16 (or bf16 x integer) products; a quantized weight's f32 scale a
// column multiplies the f32 sums, never the weight; the norm is taken on
// the f32 sum x + o W (+ b), never on the rounded x_new, in _norm_f32's
// op order (rms; or layer norm's two passes, the mean, then the centred
// variance); the FFN's f32 activation reaches the down product to ~2^-17
// relative (fault C2): as bf16 hi = bf16(a) and lo = bf16(a - hi) planes,
// both multiplied by every weight fragment into one f32 sum.
//
// Bound on the H100: at the Llama-3-8B serving step (T 132) the weight
// bytes at 3.35 TB/s: o-proj 33.6 MB (0.0100 ms), FFN 352 MB (0.105 ms;
// gate/up 235 MB 0.070, down 117 MB 0.035). Their bf16 tensor work at 989
// TFLOP/s is 0.0045 ms (o-proj) and 0.032 + 0.032 ms (gate/up; the down
// product's two planes): the down product alone is nearly operation-bound.
// int8 halves the bytes, packed int4 quarters them (FFN 0.047 ms of
// operations against 0.026 of bytes: operation-bound).
//
// Design. The first port ran megakernels.cu's mma.sync core: 160-row x
// 256-column tiles through a cp.async ring with a __syncthreads a chunk
// (2 stages for the two-plane down product), the gate/up product unsplit
// on 112 of 132 SMs at the 8B step, and every K split's f32 partials
// written to memory and read back by a second or third kernel (~17 MB
// each way for the o-proj). Here:
// - The product is computed transposed, out^T = W^T x^T, as in
//   wol_sm90.cu: an accumulator row is a weight column, an accumulator
//   column a token, wgmma m64nNk16 with N the token rows rounded up to NT
//   in {8, 64, 136} (more rows take more token tiles of 136). A CTA is two
//   consumer warpgroups and one producer warp (288 threads; ptxas allows
//   168 registers, and a third or fourth warpgroup would leave 96).
// - Tensor cores. fp weights come by TMA as bf16 boxes of 64 columns x 64
//   k in the 128-byte swizzle and are wgmma's MN-major A operand straight
//   from shared memory (no registers, no conversion). int8 / int4 weights
//   come as wol_sm90.cu's byte boxes and are built in registers as the A
//   operand by wq_sm90.cuh's exact conversions (`build`). The activation
//   is the K-major B operand. The down product issues one wgmma a plane
//   (hi, lo) on the same A into the same accumulator: C2's precision on
//   tensor cores. The producer keeps a ring of 3-8 stages of 64 k full
//   (full / empty mbarriers); consumers release a stage once its products
//   are complete.
// - The activation's L2 traffic. Every column tile re-reads its token
//   rows' activation, as many bytes a 64-k stage (17 KB at NT 136, 34 KB
//   for the down product's two planes) as the CTA's bf16 weight (16 KB for
//   128 columns, 8 KB int8) or more. What held the first layouts back on
//   an H100 was the bytes delivered into the SMs, not L2's reads: a
//   cluster of 2 or 4 CTAs over adjacent column tiles, each x box loaded
//   once and multicast into every CTA's stage, read slower than one CTA
//   alone (gelu FFN 0.235 ms at 4 against 0.150, o-proj 0.0586 against
//   0.0408), so no cluster is launched. The layout cuts the delivered
//   bytes instead: fp's gate/up CTA holds both matrices over 128 columns,
//   two m64 tiles a warpgroup (256 weight columns a stage against one
//   activation box: half the activation bytes a weight byte); and every
//   item starts its K walk at its own chunk (`rot_of`), so that the CTAs
//   of a round do not all ask L2 for the same box at once.
// - Fill the card. A persistent grid walks the items (a column tile, a
//   token tile, a K slice; quantized gate/up at NT 136 also the matrix,
//   whose one m64 tile a warpgroup leaves no room for both), slices
//   adjacent. K is split where the items do not fill the SMs (`plan_of`,
//   wol_sm90.cu's cost model): the 8B step's o-proj and down product take
//   4 slices, its gate/up product none.
// - No f32 partials for a second kernel. Where an item has several
//   arrivals (K slices, or quantized gate and up), each writes its raw
//   sums to a slab ([slice][matrix][M][N] f32, L2-resident), counts itself
//   on its item's counter, and the last to arrive sums every slab in slice
//   order and finishes, in the same launch (the counter back to 0).
// - Launches. fused_ffn: two (gate/up + the activation -> the [2, T, I]
//   bf16 planes; down + b2 + residual), against three; the planes are the
//   one workspace (the down product's K is the activation's columns, which
//   no CTA holds whole). fused_oproj_norm: two (o-proj + scale into an f32
//   [T, H] sum; a block a row adds bias and residual, stores x_new and
//   norms the f32 sum), against two: the norm needs every column of a
//   token, which 16-32 CTAs compute, so it stays a cross-block step, now
//   reading one [T, H] f32 sum instead of every slice's partials.
// - Epilogues go through shared memory: each warpgroup stages its sums as
//   [token][column] rows, a few token blocks at a time (24 rows at NT
//   136), and walks them 4 columns a thread (compact loops, vector stores
//   of consecutive columns; rows past M and columns past N are not
//   written).

#include <algorithm>
#include <type_traits>

#include "wq_sm90.cuh"

namespace ptt {
namespace md {

using bf16 = __nv_bfloat16;
using namespace sm90;
using namespace wq;

constexpr int kWG = 128;                   // a warpgroup
constexpr int kSmemMax = 232448;
constexpr int kAlign = 1024, kBars = 256;  // the ring's alignment; barriers
constexpr int kBarAll = 5;                 // named barrier of all consumers
enum : int { kFp = 0, kInt8 = 1, kInt4 = 2 };  // quant.WFMT's codes
enum : int { kEpiSwiglu = 0, kEpiGelu = 1, kEpiResidual = 2, kEpiSum = 3 };

// The token tile for M rows.
__host__ __device__ constexpr int token_tile(int M) {
  return M <= 8 ? 8 : M <= 64 ? 64 : 136;
}

// A CTA's geometry. DUAL: swiglu's gate and up matrices over the same
// columns, warpgroup 0 on gate, 1 on up.
template <int WQ, int NT, int NA, bool DUAL>
struct Geo {
  // m64 tiles a warpgroup: two below the 136-row tile; at it, two for
  // fp's gate / up pair only (its A comes from shared memory, and the pair
  // keeps 256 columns a CTA without a K split), else one
  static constexpr int TPW = NT <= 64 || (WQ == kFp && DUAL) ? 2 : 1;
  static constexpr int NW = 2;                 // consumer warpgroups
  static constexpr int CONS = NW * kWG;        // consumer threads
  static constexpr int THREADS = CONS + 32;    // and the producer warp
  static constexpr int MW = DUAL ? NW / 2 : NW;  // warpgroups a matrix
  static constexpr int WCOLS = 64 * TPW;       // a warpgroup's columns
  static constexpr int BN = WCOLS * MW;        // weight columns a CTA
  static constexpr int SK = 64;                // k a stage
  static constexpr int STEPS = SK / 16;        // k16 steps a stage
  static constexpr int GS = 2;                 // k16 steps a commit group
  // a weight box: 64 bf16 columns x 64 k (fp), or 128 byte columns x 64
  // rows (int8) / 32 packed rows (int4)
  static constexpr int WR = WQ == kInt4 ? SK / 2 : SK;
  static constexpr int W_BOX = WR * 128;
  static constexpr int BOXES = WQ == kFp ? BN / 64 : BN / 128;  // a matrix's
  static constexpr int W_BYTES = (DUAL ? 2 : 1) * BOXES * W_BOX;
  static constexpr int X_BOX = NT * 128;       // 64 k of NT token rows
  static constexpr int STAGE = NA * X_BOX + W_BYTES;
  static constexpr int NJ = NT / 8;            // n8 token blocks
  static constexpr int LDW = WCOLS + 4;        // a staged row (floats)
  // token blocks a warpgroup stages at once, and the stage's bytes
  static constexpr int JB = NT == 136 ? 3 : NT == 64 ? 4 : 1;
  static constexpr int REGION = 8 * JB * LDW;  // floats a warpgroup
  static constexpr int STG = NW * REGION * 4;
  static_assert(STAGE % 1024 == 0, "swizzled boxes on 1024-byte lines");
  static_assert(STEPS % (2 * GS) == 0, "register sets pair up in a stage");
  static_assert(WQ == kFp || TPW == 2 || MW % 2 == 0,
                "two warpgroups share a 128-column byte box");
};

// What every thread of a launch knows of its work.
struct Plan {
  int M, N, K, R;          // R: the weight's rows (K / 2 packed int4)
  int n_tt, n_ct;          // token tiles, column tiles
  int nk, per, n_ks;       // SK chunks of K, chunks a slice, slices
  int ns;                  // ring stages
  int tma_w, unit;         // the weight through its tensor map, else the
                           // bytes a producer copy moves: 8, 4, 1
  int epi;                 // kEpi*
  int mats;                // 2: swiglu's gate and up
  int paired;              // 1: gate and up are items of their own
};

struct Epi {
  const float* scale[2];   // [N] per matrix (quantized), or null
  const void* bias;        // [N] (b1 for the activation, b2), or null
  int vbf;                 // bias: 1 bf16, 0 f32
  const bf16* x;           // [M, N] residual (kEpiResidual)
  bf16* out;               // [2, M, N] planes (act) or [M, N]
  float* sum;              // [M, N] f32 (kEpiSum)
  float* partial;          // [slices x mats, M, N] f32 raw sums
  int* counters;           // a CTA item's arrivals (zero, left zero)
};

// Element i of an [N] vector of f32 (vbf 0) or bf16 (1), as f32 (exact).
__device__ __forceinline__ float ldv(const void* v, int i, int vbf) {
  return vbf ? __bfloat162float(static_cast<const bf16*>(v)[i])
             : static_cast<const float*>(v)[i];
}

// tanh-GELU in jax.nn.gelu(approximate=True)'s op order (megakernels.cu)
__device__ __forceinline__ float gelu_tanh(float g) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return g * (0.5f * (1.f + tanhf(k * (g + 0.044715f * (g * g * g)))));
}

// The chunk an item's K walk starts at: items of one round start at spread
// chunks, so that the CTAs reading one activation do not all ask L2 for
// the same box at once (the sums' order is fixed by the item alone).
__device__ __forceinline__ int rot_of(int item, int len) {
  return len > 1 ? (int)(((unsigned)item * 37u) % (unsigned)len) : 0;
}

__device__ __forceinline__ void decode(const Plan& p, int item, int& ct,
                                       int& tt, int& ks, int& mt) {
  mt = p.paired ? item % 2 : 0;
  if (p.paired) item /= 2;
  ks = item % p.n_ks;
  const int r = item / p.n_ks;
  tt = r % p.n_tt;
  ct = r / p.n_tt;
}

// The register path's commit group: the A pairs of GS k16 steps from s0
// (`build`), their products against every plane into every tile.
template <int WQ, int NT, int NA, int GS, int TPW>
__device__ __forceinline__ void group(uint32_t (&a)[GS][TPW][4],
                                      float (&acc)[TPW][NT / 2],
                                      const unsigned char* wb, uint32_t xs,
                                      int s0, int c, int o0, int o1,
                                      int accf) {
#pragma unroll
  for (int s = 0; s < GS; ++s)
    build<WQ == kInt4, TPW>(a[s], wb, s0 + s, c, o0, o1);
  wg_fence();
#pragma unroll
  for (int s = 0; s < GS; ++s) {
    const int step = s0 + s;
#pragma unroll
    for (int pl = 0; pl < NA; ++pl) {
      const uint64_t b = desc_k(xs + pl * NT * 128, NT, step);
      const int f = accf | (step > 0) | (pl > 0);
#pragma unroll
      for (int t = 0; t < TPW; ++t) mma_rs<0>(acc[t], a[s][t], b, f);
    }
  }
  wg_commit();
}

template <int GS, int TPW>
__device__ __forceinline__ void fence_a(uint32_t (&a)[GS][TPW][4]) {
#pragma unroll
  for (int s = 0; s < GS; ++s) fence_regs(a[s]);
}
template <int TPW, int R>
__device__ __forceinline__ void fence_acc(float (&acc)[TPW][R]) {
#pragma unroll
  for (int t = 0; t < TPW; ++t) fence_regs(acc[t]);
}

// 4 columns of token `tok` from n of the activation's hi and lo planes,
// from their f32 values (N % 8 == 0: all four inside N, 8-byte stores)
__device__ __forceinline__ void store_planes(bf16* out, size_t plane,
                                             size_t at, const float (&a)[4]) {
  uint32_t hi[2], lo[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const __nv_bfloat162 hv = __floats2bfloat162_rn(a[2 * k], a[2 * k + 1]);
    const float2 hf = __bfloat1622float2(hv);
    const __nv_bfloat162 lv =
        __floats2bfloat162_rn(a[2 * k] - hf.x, a[2 * k + 1] - hf.y);
    hi[k] = *reinterpret_cast<const uint32_t*>(&hv);
    lo[k] = *reinterpret_cast<const uint32_t*>(&lv);
  }
  *reinterpret_cast<uint2*>(out + at) = make_uint2(hi[0], hi[1]);
  *reinterpret_cast<uint2*>(out + plane + at) = make_uint2(lo[0], lo[1]);
}

// 4 columns n.. of token `tok` from their raw f32 sums v (u: swiglu's up
// sums), finished as the launch's epilogue says: scaled, then the f32 sum
// (kEpiSum), x + sum + b (kEpiResidual), or the activation's hi and lo
// planes (kEpiGelu: gelu(sum + b1); kEpiSwiglu: g * sigmoid(g) * u, b1
// on g). N % 8 == 0, so the 4 columns are all inside N.
__device__ __forceinline__ void finish_cols(const Plan& p, const Epi& e,
                                            int tok, int n, float (&v)[4],
                                            const float (&u)[4]) {
  const size_t plane = (size_t)p.M * p.N;
  const size_t at = (size_t)tok * p.N + n;
  const float* s0 = e.scale[0];
  if (s0)
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] *= __ldg(s0 + n + k);
  if (p.epi == kEpiSum) {
    *reinterpret_cast<float4*>(e.sum + at) =
        make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
  if (e.bias)
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] += ldv(e.bias, n + k, e.vbf);
  if (p.epi == kEpiResidual) {
    const uint2 xr = *reinterpret_cast<const uint2*>(e.x + at);
    const float2 x0 =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.x));
    const float2 x1 =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.y));
    const __nv_bfloat162 r0 = __floats2bfloat162_rn(x0.x + v[0], x0.y + v[1]);
    const __nv_bfloat162 r1 = __floats2bfloat162_rn(x1.x + v[2], x1.y + v[3]);
    *reinterpret_cast<uint2*>(e.out + at) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&r0),
                   *reinterpret_cast<const uint32_t*>(&r1));
    return;
  }
  float a[4];
  if (p.epi == kEpiGelu) {
#pragma unroll
    for (int k = 0; k < 4; ++k) a[k] = gelu_tanh(v[k]);
  } else {  // kEpiSwiglu: g * sigmoid(g) * u
    const float* s1 = e.scale[1];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float uk = s1 ? u[k] * __ldg(s1 + n + k) : u[k];
      a[k] = v[k] * (1.f / (1.f + expf(-v[k]))) * uk;
    }
  }
  store_planes(e.out, plane, at, a);
}

// Tensor maps: tx over the activation [NA, M, K] bf16 in boxes of 64 x NT
// x 1; tw[m] over matrix m: bf16 [K, N] in boxes of 64 x 64 (fp), or its
// bytes [R, N] in boxes of 128 x WR (quantized; unused where p.tma_w is
// 0, the producer copies qw[m] then).
template <int WQ, int NT, int NA, bool DUAL>
__global__ void __launch_bounds__(Geo<WQ, NT, NA, DUAL>::THREADS, 1)
    md_gemm(const __grid_constant__ CUtensorMap tx,
            const __grid_constant__ CUtensorMap tw0,
            const __grid_constant__ CUtensorMap tw1,
            const unsigned char* __restrict__ qw0,
            const unsigned char* __restrict__ qw1, const Plan p,
            const Epi e) {
  using G = Geo<WQ, NT, NA, DUAL>;
  constexpr bool FP = WQ == kFp, I4 = WQ == kInt4;
  constexpr int TPW = G::TPW, CONS = G::CONS, MATS = DUAL ? 2 : 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) &
                  (kAlign - 1));
  float* stage = reinterpret_cast<float*>(sm + p.ns * G::STAGE);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(sm + p.ns * G::STAGE + G::STG);
  uint64_t* empty = full + p.ns;
  volatile int* flag = reinterpret_cast<volatile int*>(empty + p.ns);
  const int items = p.n_ct * p.n_tt * p.n_ks * (p.paired ? 2 : 1);
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.ns; ++s) {
      // TMA's arrival, and where the weight takes no tensor map one more
      // from each producer lane
      mbar_init(full + s, p.tma_w ? 1 : 33);
      mbar_init(empty + s, CONS / 32);  // every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONS) {
    // the producer warp: lane 0 issues the TMA loads of every stage; where
    // the weight takes no tensor map, every lane copies its bytes
    int st = 0, ph = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      int ct, tt, ks, mt;
      decode(p, item, ct, tt, ks, mt);
      const int c0 = ks * p.per, c1 = min(c0 + p.per, p.nk);
      const int n0 = ct * G::BN;
      const int len = c1 - c0, rot = rot_of(item, len);
      for (int i = 0; i < len; ++i) {
        const int kc = c0 + (i + rot < len ? i + rot : i + rot - len);
        mbar_wait(empty + st, ph ^ 1);
        unsigned char* x = sm + st * G::STAGE;
        unsigned char* w = x + NA * G::X_BOX;
        if constexpr (!FP) {
          if (!p.tma_w) {
            // pieces of `unit` bytes (a unit never straddles a swizzled
            // 16-byte chunk, and a row of N bytes holds whole units), each
            // lane's completion counted on the stage's barrier
            const int unit = p.unit;
            for (int m2 = 0; m2 < MATS; ++m2) {
              const unsigned char* qw = m2 + mt ? qw1 : qw0;
              unsigned char* wm = w + m2 * G::BOXES * G::W_BOX;
              for (int i2 = lane; i2 < G::BOXES * G::W_BOX / unit;
                   i2 += 32) {
                const int o = i2 * unit;
                const int b = o / G::W_BOX, r = (o % G::W_BOX) >> 7,
                          j = o & 127;
                const int row = kc * G::WR + r, col = n0 + 128 * b + j;
                const bool ok = row < p.R && col < p.N;
                unsigned char* d = wm + b * G::W_BOX + r * 128 +
                                   (((j >> 4) ^ (r & 7)) << 4) + (j & 15);
                const unsigned char* src =
                    ok ? qw + (size_t)row * p.N + col : qw;
                if (unit == 1)
                  *d = ok ? *src : 0;
                else
                  cp_async_ca(d, src, unit, ok);
              }
            }
            if (unit == 1) {
              mbar_arrive(full + st);
            } else {
              asm volatile(
                  "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                      smem_u32(full + st))
                  : "memory");
            }
          }
        }
        if (lane == 0) {
          mbar_expect_tx(full + st, NA * G::X_BOX +
                                        (p.tma_w ? G::W_BYTES : 0));
#pragma unroll
          for (int pl = 0; pl < NA; ++pl)
            tma_load3(x + pl * G::X_BOX, &tx, full + st, kc * G::SK,
                      tt * NT, pl);
          if (p.tma_w) {
#pragma unroll
            for (int m2 = 0; m2 < MATS; ++m2)
#pragma unroll
              for (int b = 0; b < G::BOXES; ++b) {
                unsigned char* d = w + (m2 * G::BOXES + b) * G::W_BOX;
                const CUtensorMap* tw = m2 + mt ? &tw1 : &tw0;
                if constexpr (FP)
                  tma_load2(d, tw, full + st, n0 + 64 * b, kc * G::SK);
                else
                  tma_load2(d, tw, full + st, n0 + 128 * b, kc * G::WR);
              }
          }
        }
        __syncwarp();
        if (++st == p.ns) st = 0, ph ^= 1;
      }
    }
    return;
  }

  // warp-uniform, so that the addresses derived from it stay uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWG, 0);
  const int t = threadIdx.x % kWG, w = t >> 5, g = lane >> 2, c = lane & 3;
  const int mm = DUAL ? wg / G::MW : 0;  // the warpgroup's matrix
  const int lw = wg % G::MW;             // its place among the matrix's
  // the thread's first column in its warpgroup's WCOLS (its sums of tile
  // tl, row half h at colw + coff(tl, h)); the register path's byte
  // offsets in the rows it reads (wol_sm90.cu); the warpgroup's first box
  int colw, o0 = 0, o1 = 0, box;
  if constexpr (FP) {
    colw = 16 * w + g;
    box = mm * G::BOXES + lw * TPW;
  } else {
    int chunk;
    if constexpr (TPW == 2) {
      chunk = I4 ? w + 4 * (g >> 2) : 2 * w + (g >> 2);
      colw = 16 * chunk + 4 * (g & 3);
      box = mm * G::BOXES + lw;
    } else {
      chunk = 4 * (lw & 1) + w;
      colw = 16 * w + 2 * g;
      box = mm * G::BOXES + (lw >> 1);
    }
    const int x0 = I4 ? c : 2 * c, x1 = I4 ? c + 4 : 2 * c + 1;
    const int within = TPW == 2 ? 4 * (g & 3) : 2 * g;
    o0 = ((chunk ^ x0) << 4) + within;
    o1 = ((chunk ^ x1) << 4) + within;
  }
  auto coff = [](int tl, int h) {
    if constexpr (FP)
      return 64 * tl + 8 * h;
    else
      return (TPW == 2 ? 2 * tl : 0) + h;
  };
  constexpr int GS = G::GS, NG = G::STEPS / GS;
  constexpr int HALF = NT / 2;
  float acc[TPW][HALF];
  uint32_t a0[GS][TPW][4], a1[GS][TPW][4];
  int st = 0, ph = 0;

  // a consumed stage back to the producer
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  };

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int ct, tt, ks, mt;
    decode(p, item, ct, tt, ks, mt);
    const int c0 = ks * p.per, c1 = min(c0 + p.per, p.nk);
    int prev = -1;
    const int len = c1 - c0;
    for (int i = 0; i < len; ++i) {
      mbar_wait(full + st, ph);
      const unsigned char* x = sm + st * G::STAGE;
      const unsigned char* wst = x + NA * G::X_BOX;
      const uint32_t xs = smem_u32(x);
      const int accf = i > 0;
      if constexpr (FP) {
        // A: the warpgroup's boxes, MN-major, straight from the stage
        const uint32_t ws = smem_u32(wst) + box * G::W_BOX;
        wg_fence();
#pragma unroll
        for (int step = 0; step < G::STEPS; ++step)
#pragma unroll
          for (int pl = 0; pl < NA; ++pl) {
            const uint64_t b = desc_k(xs + pl * G::X_BOX, NT, step);
            const int f = accf | (step > 0) | (pl > 0);
#pragma unroll
            for (int tl = 0; tl < TPW; ++tl)
              mma_ss<1, 0>(acc[tl], desc_mn(ws + tl * G::W_BOX, G::SK, step),
                           b, f);
          }
        wg_commit();
        wg_wait<1>();  // the previous stage's products are complete
        fence_acc(acc);
        if (prev >= 0) release(prev);
      } else {
        const unsigned char* wb = wst + box * G::W_BOX;
#pragma unroll
        for (int gi = 0; gi < NG; gi += 2) {
          group<WQ, NT, NA, GS, TPW>(a0, acc, wb, xs, gi * GS, c, o0, o1,
                                     accf);
          wg_wait<1>();  // the group on a1 is complete
          fence_acc(acc);
          fence_a(a1);
          if (gi == 0 && prev >= 0) release(prev);
          group<WQ, NT, NA, GS, TPW>(a1, acc, wb, xs, (gi + 1) * GS, c, o0,
                                     o1, accf);
          wg_wait<1>();  // the group on a0 is complete
          fence_acc(acc);
          fence_a(a0);
        }
      }
      prev = st;
      if (++st == p.ns) st = 0, ph ^= 1;
    }
    wg_wait<0>();
    fence_acc(acc);
    if constexpr (!FP) fence_a(a1);
    if (prev >= 0) release(prev);

    // The epilogue. Each warpgroup stages its sums JB token blocks at a
    // time in shared memory as [token][column] over its WCOLS columns
    // (thread (w, g, c)'s sum i lands at a fixed offset from its base),
    // then walks the staged rows 4 columns a thread: compact loops, vector
    // stores of consecutive columns. One arrival (no split, one matrix
    // or both in this CTA): the walk finishes the outputs. Several (K
    // slices, or gate and up as items of their own): the walk writes the
    // raw sums to their slab of the partials ([slice][matrix][M][N] f32);
    // the CTA counts itself on its item's counter, and the last to arrive
    // sums every slab in slice order and finishes, in the same launch.
    const int cw = ct * p.n_tt + tt;  // the item's counter
    const int n0 = ct * G::BN;
    const int arrivals = p.n_ks * (p.paired ? 2 : 1);
    const bool split = arrivals > 1;
    const size_t plane = (size_t)p.M * p.N;
    auto finish4 = [&](int tok, int n, float (&v)[4], const float (&u)[4]) {
      finish_cols(p, e, tok, n, v, u);
    };

    const int mine = DUAL ? mm : mt;  // the matrix this warpgroup summed
    const int bar_id = DUAL && !split ? 1 + lw : 1 + wg;
    const int bar_n = DUAL && !split ? 2 * kWG : kWG;
    const int wc0 = n0 + lw * G::WCOLS;
    float* stg = stage + wg * G::REGION;
    const int base = 2 * c * G::LDW + colw;
    constexpr int Q = G::WCOLS / 4;  // 4-column groups of a staged row
    constexpr int NP = (G::NJ + G::JB - 1) / G::JB;
#pragma unroll
    for (int pass = 0; pass < NP; ++pass) {
      const int j0 = pass * G::JB;
      const int nj = G::NJ - j0 < G::JB ? G::NJ - j0 : G::JB;
      named_sync(bar_id, bar_n);  // the last pass's readers are done
#pragma unroll
      for (int tl = 0; tl < TPW; ++tl)
#pragma unroll
        for (int jj = 0; jj < nj; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int q = 0; q < 2; ++q)
              stg[base + (8 * jj + q) * G::LDW + coff(tl, h)] =
                  acc[tl][4 * (j0 + jj) + 2 * h + q];
      named_sync(bar_id, bar_n);
      const int rows = 8 * nj, tok0 = tt * NT + 8 * j0;
      if (split) {
        // the raw sums to slab (slice, matrix)
        float* slab = e.partial + (size_t)(ks * p.mats + mine) * plane;
        for (int idx = t; idx < rows * Q; idx += kWG) {
          const int r = idx / Q, cc = (idx % Q) * 4;
          const int tok = tok0 + r, n = wc0 + cc;
          if (tok >= p.M || n >= p.N) continue;
          *reinterpret_cast<float4*>(slab + (size_t)tok * p.N + n) =
              *reinterpret_cast<const float4*>(stg + r * G::LDW + cc);
        }
      } else if constexpr (DUAL) {
        // gate's warpgroup and up's walk the pair of regions together
        const float* gs = stage + lw * G::REGION;
        const float* us = stage + (G::MW + lw) * G::REGION;
        for (int idx = mm * kWG + t; idx < rows * Q; idx += 2 * kWG) {
          const int r = idx / Q, cc = (idx % Q) * 4;
          const int tok = tok0 + r, n = wc0 + cc;
          if (tok >= p.M || n >= p.N) continue;
          const float4 g4 =
              *reinterpret_cast<const float4*>(gs + r * G::LDW + cc);
          const float4 u4 =
              *reinterpret_cast<const float4*>(us + r * G::LDW + cc);
          float v[4] = {g4.x, g4.y, g4.z, g4.w};
          const float u[4] = {u4.x, u4.y, u4.z, u4.w};
          finish4(tok, n, v, u);
        }
      } else {
        const float u0[4] = {0.f, 0.f, 0.f, 0.f};
        for (int idx = t; idx < rows * Q; idx += kWG) {
          const int r = idx / Q, cc = (idx % Q) * 4;
          const int tok = tok0 + r, n = wc0 + cc;
          if (tok >= p.M || n >= p.N) continue;
          const float4 s4 =
              *reinterpret_cast<const float4*>(stg + r * G::LDW + cc);
          float v[4] = {s4.x, s4.y, s4.z, s4.w};
          finish4(tok, n, v, u0);
        }
      }
    }
    if (split) {
      named_sync(kBarAll, CONS);
      if (threadIdx.x == 0) {
        __threadfence();  // every consumer's slab stores, before the count
        flag[0] = atomicAdd(e.counters + cw, 1) == arrivals - 1;
        __threadfence();
      }
      named_sync(kBarAll, CONS);
      if (!flag[0]) continue;
      __threadfence();
      // the last arrival: every slab of the CTA's tile, summed in slice
      // order for each matrix, then finished
      // (slabs read KB at a time, all in flight before they are added)
      constexpr int QB = G::BN / 4, KB = 4;
      const int slabs = p.n_ks * p.mats;
      for (int idx = threadIdx.x; idx < NT * QB; idx += CONS) {
        const int r = idx / QB, cc = (idx % QB) * 4;
        const int tok = tt * NT + r, n = n0 + cc;
        if (tok >= p.M || n >= p.N) continue;
        const size_t at = (size_t)tok * p.N + n;
        float v[4] = {0.f, 0.f, 0.f, 0.f}, u[4] = {0.f, 0.f, 0.f, 0.f};
        for (int s0 = 0; s0 < slabs; s0 += KB) {
          float4 b4[KB];
#pragma unroll
          for (int k = 0; k < KB; ++k)
            if (s0 + k < slabs)
              b4[k] = __ldcg(reinterpret_cast<const float4*>(
                  e.partial + (size_t)(s0 + k) * plane + at));
#pragma unroll
          for (int k = 0; k < KB; ++k) {
            if (s0 + k >= slabs) break;
            // slab s = slice * mats + matrix, added in slice order
            if (p.mats == 2 && (s0 + k) % 2)
              u[0] += b4[k].x, u[1] += b4[k].y, u[2] += b4[k].z,
                  u[3] += b4[k].w;
            else
              v[0] += b4[k].x, v[1] += b4[k].y, v[2] += b4[k].z,
                  v[3] += b4[k].w;
          }
        }
        finish4(tok, n, v, u);
      }
      if (threadIdx.x == 0) e.counters[cw] = 0;  // ready for the next launch
    }
  }
}
// A block of kNormThreads per row t, 8 columns a thread and CH such
// chunks, all in registers: x_new = x + (sum + bias) in f32; h =
// norm(that f32 sum) * nw + nb, rms (layer 0) or layer norm (layer 1: the
// mean, then the centred variance over a second pass), in
// megakernels.cu's oproj_norm_finalize_kernel's op order. bias / nw / nb:
// f32 (vbf 0) or bf16 (1). N is a multiple of 8.
constexpr int kNormThreads = 512;

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
  const float r = red[32];
  __syncthreads();  // red is free for the next sum
  return r;
}

template <int CH>
__global__ void __launch_bounds__(kNormThreads)
    norm_kernel(const float* __restrict__ sum, const void* __restrict__ bias,
                const bf16* __restrict__ x, const void* __restrict__ nw,
                const void* __restrict__ nb, int vbf, bf16* __restrict__ x_new,
                bf16* __restrict__ h, int N, float eps, int layer) {
  __shared__ float red[33];
  const size_t base = (size_t)blockIdx.x * N;
  float xs[CH][8];
  float acc = 0.f;  // layer: the sum; rms: the sum of squares
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const int n = (threadIdx.x + k * kNormThreads) * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) xs[k][i] = 0.f;
    if (n >= N) continue;
    const float4 s0 = *reinterpret_cast<const float4*>(sum + base + n);
    const float4 s1 = *reinterpret_cast<const float4*>(sum + base + n + 4);
    const uint4 xv = *reinterpret_cast<const uint4*>(x + base + n);
    const float pv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const bf16* xb = reinterpret_cast<const bf16*>(&xv);
    uint4 ov;
    bf16* ob = reinterpret_cast<bf16*>(&ov);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v = pv[i];
      if (bias) v += ldv(bias, n + i, vbf);
      const float s = __bfloat162float(xb[i]) + v;
      xs[k][i] = s;
      ob[i] = __float2bfloat16(s);
      acc += layer ? s : s * s;
    }
    *reinterpret_cast<uint4*>(x_new + base + n) = ov;
  }
  const float tot = block_sum(acc, red) / (float)N;
  float mu = 0.f, r;
  if (layer) {
    mu = tot;
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int n = (threadIdx.x + k * kNormThreads) * 8;
      if (n >= N) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float cv = xs[k][i] - mu;
        ss += cv * cv;
      }
    }
    r = rsqrtf(block_sum(ss, red) / (float)N + eps);
  } else {
    r = rsqrtf(tot + eps);
  }
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const int n = (threadIdx.x + k * kNormThreads) * 8;
    if (n >= N) continue;
    uint4 ov;
    bf16* ob = reinterpret_cast<bf16*>(&ov);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float y = (xs[k][i] - mu) * r;
      if (nw) y *= ldv(nw, n + i, vbf);
      if (nb) y += ldv(nb, n + i, vbf);
      ob[i] = __float2bfloat16(y);
    }
    *reinterpret_cast<uint4*>(h + base + n) = ov;
  }
}

// ------------------------------------------------------------------ host
// Ring stages that fit beside the epilogue's stage, at most 8.
template <int WQ, int NT, int NA, bool DUAL>
static int stages() {
  using G = Geo<WQ, NT, NA, DUAL>;
  return std::min(8, (kSmemMax - kAlign - kBars - G::STG) / G::STAGE);
}
template <int WQ, int NT, int NA, bool DUAL>
static size_t smem_bytes(int ns) {
  using G = Geo<WQ, NT, NA, DUAL>;
  return (size_t)kAlign + (size_t)ns * G::STAGE + G::STG + kBars;
}

// The K split of an [M, K] x [K, N] product on `sms` SMs: wol_sm90.cu's
// cost model. The slice count (at most 16) that minimises, in units of
// one SK chunk of one item, the rounds of items times their chunks, plus,
// for a split, each item's finish and the last slice's reads of every
// slice's partials, and the partials' bytes at half the rate a chunk
// streams at; a split whose partials pass 16 MiB is never taken; ties keep
// fewer slices.
template <int WQ, int NT, int NA, bool DUAL>
static void plan_of(int M, int N, int K, int paired, int sms, int* per,
                    int* n_ks) {
  using G = Geo<WQ, NT, NA, DUAL>;
  const int n_ct = (N + G::BN - 1) / G::BN, mats = DUAL || paired ? 2 : 1;
  const long tiles = (long)((M + NT - 1) / NT) * n_ct * (paired ? 2 : 1);
  const int nk = (K + G::SK - 1) / G::SK;
  const double chunk_bytes = (double)G::W_BYTES * sms;
  const double finish = NT > 64 ? 10.0 : 4.0, read = NT > 64 ? 0.5 : 0.1;
  double best = 0.0;
  *per = nk;
  *n_ks = 1;
  for (int s = 1; s <= std::min(16, nk); ++s) {
    const int pc = (nk + s - 1) / s, s2 = (nk + pc - 1) / pc;
    const bool split = s2 > 1 || paired;
    const double part = split ? 4.0 * s2 * mats * M * N : 0.0;
    if (s2 > 1 && part > 16.0 * 1024 * 1024) break;
    const long rounds = (tiles * s2 + sms - 1) / sms;
    const double cost = (double)rounds * (pc + (split ? finish : 0.0)) +
                        (split ? read * s2 + 0.5 * part / chunk_bytes : 0.0);
    if (s == 1 || cost < best) {
      best = cost;
      *per = pc;
      *n_ks = s2;
    }
  }
}

// The launch's plan for M's token tile: out[0] the token tile, out[1] the
// K slices, out[2] chunks a slice, out[3] the split counters and out[4]
// the f32 partials it needs (both 0 without a split).
// Quantized gate/up at the 136-row tile holds one m64 tile a warpgroup,
// too few columns for both matrices in one CTA: gate and up are items of
// their own there, merged by the last to arrive.
template <int WQ, int NT, bool DUAL>
constexpr bool paired_v = DUAL && WQ != kFp && NT == 136;

template <int WQ, int NA, bool DUAL>
static void plan_w(int M, int N, int K, int sms, int* out) {
  const int nt = token_tile(M);
  int per = 0, n_ks = 0, bn = 0, paired = 0;
  auto go = [&](auto tag) {
    constexpr int NT = decltype(tag)::value;
    constexpr bool PR = paired_v<WQ, NT, DUAL>;
    constexpr bool D = DUAL && !PR;
    using G = Geo<WQ, NT, NA, D>;
    plan_of<WQ, NT, NA, D>(M, N, K, PR, sms, &per, &n_ks);
    bn = G::BN;
    paired = PR;
  };
  if (nt == 8)
    go(std::integral_constant<int, 8>{});
  else if (nt == 64)
    go(std::integral_constant<int, 64>{});
  else
    go(std::integral_constant<int, 136>{});
  const int n_ct = (N + bn - 1) / bn, mats = DUAL ? 2 : 1;
  const long items = (long)((M + nt - 1) / nt) * n_ct;
  const bool split = n_ks > 1 || paired;
  out[0] = nt;
  out[1] = n_ks;
  out[2] = per;
  out[3] = split ? (int)items : 0;
  out[4] = split ? (int)((long)n_ks * mats * M * N) : 0;
}

struct Call {
  const void* x;     // [NA, M, K] bf16
  const void* w[2];  // the matrix (DUAL: gate, up)
  int M, N, K, wfmt, per, n_ks, epi;
};

template <int WQ, int NT, int NA, bool DUAL, bool PAIRED = false>
static int launch(const Call& k, const Epi& e, int device, cudaStream_t st) {
  using G = Geo<WQ, NT, NA, DUAL>;
  Plan p;
  p.M = k.M, p.N = k.N, p.K = k.K, p.R = WQ == kInt4 ? k.K / 2 : k.K;
  p.n_tt = (k.M + NT - 1) / NT;
  p.n_ct = (k.N + G::BN - 1) / G::BN;
  p.nk = (k.K + G::SK - 1) / G::SK, p.per = k.per, p.n_ks = k.n_ks;
  p.epi = k.epi;
  p.paired = PAIRED;
  p.mats = DUAL || PAIRED ? 2 : 1;
  if (k.per < 1 || (p.nk + k.per - 1) / k.per != k.n_ks ||
      ((k.n_ks > 1 || PAIRED) && !(e.partial && e.counters)))
    return (int)cudaErrorInvalidValue;
  p.ns = stages<WQ, NT, NA, DUAL>();
  int tma_w = 1;
  uintptr_t any = 0;
  for (int m = 0; m < (DUAL || PAIRED ? 2 : 1); ++m) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(k.w[m]);
    any |= a;
    if (WQ == kFp) {
      if (k.N % 8 || a % 16) return (int)cudaErrorInvalidValue;
    } else {
      tma_w &= k.N % 16 == 0 && a % 16 == 0;
    }
  }
  p.tma_w = tma_w;
  p.unit = k.N % 8 == 0 && any % 8 == 0 ? 8 : k.N % 4 == 0 && any % 4 == 0
                                                  ? 4
                                                  : 1;
  CUtensorMap tx, tw[2];
  const u64 xd[3] = {(u64)k.K, (u64)k.M, (u64)NA};
  const unsigned xb[3] = {64, NT, 1};
  int err = cached_map(&tx, device, k.x, 3, xd, xb,
                       CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
  if (err != 0) return err;
  tw[1] = tw[0] = tx;  // unused where the producer copies the bytes
  for (int m = 0; m < (DUAL || PAIRED ? 2 : 1); ++m) {
    if (WQ == kFp) {
      const u64 wd[2] = {(u64)k.N, (u64)k.K};
      const unsigned wb[2] = {64, (unsigned)G::SK};
      err = cached_map(&tw[m], device, k.w[m], 2, wd, wb,
                       CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
    } else if (p.tma_w) {
      const u64 wd[2] = {(u64)k.N, (u64)p.R};
      const unsigned wb[2] = {128, (unsigned)G::WR};
      err = cached_map(&tw[m], device, k.w[m], 2, wd, wb,
                       CU_TENSOR_MAP_DATA_TYPE_UINT8);
    }
    if (err != 0) return err;
  }
  auto kern = md_gemm<WQ, NT, NA, DUAL>;
  const size_t smem = smem_bytes<WQ, NT, NA, DUAL>(p.ns);
  // the shared-memory attribute and the CTAs the SMs hold at once, read
  // once a device
  static int resident[64] = {0};
  int& res = resident[device & 63];
  if (!res) {
    cudaError_t ce = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    int per_sm = 0;
    if (ce == cudaSuccess)
      ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                         G::THREADS, smem);
    if (ce != cudaSuccess) return (int)ce;
    res = std::max(1, per_sm) * sm_count(device);
  }
  const long items = (long)p.n_ct * p.n_tt * p.n_ks * (PAIRED ? 2 : 1);
  const int grid = (int)std::min<long>(res, items);
  kern<<<grid, G::THREADS, smem, st>>>(
      tx, tw[0], tw[1], static_cast<const unsigned char*>(k.w[0]),
      static_cast<const unsigned char*>(DUAL || PAIRED ? k.w[1] : k.w[0]), p,
      e);
  return (int)cudaGetLastError();
}

template <int WQ, int NA, bool DUAL>
static int launch_nt(const Call& k, const Epi& e, int device,
                     cudaStream_t st) {
  switch (token_tile(k.M)) {
    case 8: return launch<WQ, 8, NA, DUAL>(k, e, device, st);
    case 64: return launch<WQ, 64, NA, DUAL>(k, e, device, st);
    default:
      if constexpr (paired_v<WQ, 136, DUAL>)
        return launch<WQ, 136, NA, false, true>(k, e, device, st);
      else
        return launch<WQ, 136, NA, DUAL>(k, e, device, st);
  }
}

template <int NA, bool DUAL>
static int launch_w(const Call& k, const Epi& e, int device,
                    cudaStream_t st) {
  if (k.wfmt == kFp) return launch_nt<kFp, NA, DUAL>(k, e, device, st);
  if (k.wfmt == kInt8) return launch_nt<kInt8, NA, DUAL>(k, e, device, st);
  if (k.wfmt == kInt4) return launch_nt<kInt4, NA, DUAL>(k, e, device, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace md
}  // namespace ptt

using namespace ptt;
using ptt::md::bf16;

extern "C" {

// The launch plan of a bf16 [M, K] x [K, N] product against a wfmt (0 fp,
// 1 int8, 2 int4) weight, `dual` 1 for swiglu's gate and up matrices in
// one CTA, `na` activation planes (2: the down product's hi + lo), on
// `device`: out[0] the token tile, out[1] the K slices, out[2] SK chunks a
// slice, out[3] the split counters and out[4] the f32 partials it needs
// (both 0 without a split). The wrappers allocate from it.
int ptt_md_plan(int M, int N, int K, int wfmt, int dual, int na, int device,
                int* out) {
  if (M < 1 || N < 1 || K < 1 || (na != 1 && na != 2) ||
      (dual != 0 && dual != 1) || (dual && na != 1))
    return (int)cudaErrorInvalidValue;
  const int sms = md::sm_count(device);
  auto go = [&](auto wq) {
    constexpr int WQ = decltype(wq)::value;
    if (dual)
      md::plan_w<WQ, 1, true>(M, N, K, sms, out);
    else if (na == 1)
      md::plan_w<WQ, 1, false>(M, N, K, sms, out);
    else
      md::plan_w<WQ, 2, false>(M, N, K, sms, out);
  };
  if (wfmt == md::kFp)
    go(std::integral_constant<int, md::kFp>{});
  else if (wfmt == md::kInt8)
    go(std::integral_constant<int, md::kInt8>{});
  else if (wfmt == md::kInt4)
    go(std::integral_constant<int, md::kInt4>{});
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

// o [T, Ko] bf16; x [T, H] bf16 (16-byte aligned); w [Ko, H] (bf16, int8,
// or packed int4 [Ko/2, H]); scale [H] f32 (quantized) or null; bias / nw /
// nb [H] or null, f32 (vbf 0) or bf16 (1); sum [T, H] f32 workspace;
// (per, n_ks) from ptt_md_plan with its partials and counters (zero,
// left zero) where n_ks > 1; layer 0: rms, 1: layer norm -> x_new, h [T,
// H] bf16
int ptt_md_oproj_norm(const void* o, const void* x, const void* w,
                      const void* scale, const void* bias, const void* nw,
                      const void* nb, int vbf, void* sum, void* partial,
                      void* counters, void* x_new, void* h, int T, int Ko,
                      int H, int per, int n_ks, float eps, int layer,
                      int wfmt, int device, void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T == 0) return (int)cudaSuccess;
  const int ch = (H + 8 * md::kNormThreads - 1) / (8 * md::kNormThreads);
  if ((layer != 0 && layer != 1) || (wfmt == md::kInt4 && Ko % 2) ||
      (wfmt != md::kFp && !scale) || ch > 8 || H % 8 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  md::Call k{};
  k.x = o;
  k.w[0] = k.w[1] = w;
  k.M = T, k.N = H, k.K = Ko, k.wfmt = wfmt;
  k.per = per, k.n_ks = n_ks, k.epi = md::kEpiSum;
  md::Epi e{};
  e.scale[0] = static_cast<const float*>(scale);
  e.sum = static_cast<float*>(sum);
  e.partial = static_cast<float*>(partial);
  e.counters = static_cast<int*>(counters);
  int err = md::launch_w<1, false>(k, e, device, st);
  if (err != 0) return err;
  auto norm = ch <= 1   ? md::norm_kernel<1>
              : ch <= 2 ? md::norm_kernel<2>
              : ch <= 4 ? md::norm_kernel<4>
                        : md::norm_kernel<8>;
  norm<<<T, md::kNormThreads, 0, st>>>(
      static_cast<const float*>(sum), bias, static_cast<const bf16*>(x), nw,
      nb, vbf, static_cast<bf16*>(x_new), static_cast<bf16*>(h), H, eps,
      layer);
  return (int)cudaGetLastError();
}

// h, x [T, H] bf16 (x 8-byte aligned); wg, wu [H, I] (int8 / int4 [H/2, I]
// packed); wd [I, H] (int4 [I/2, H]); sg, su [I] / sd [H] f32 (quantized)
// or null; b1 [I] / b2 [H] or null, f32 (vbf 0) or bf16 (1); gelu 0:
// swiglu (wg, wu), 1: gelu (wg alone; not int4); act [2, T, I] bf16
// workspace (hi, lo); the gate/up launch's (per_u, ks_u) and the down
// launch's (per_d, ks_d) from ptt_md_plan, their partials (one
// buffer, the larger) and counters -> out [T, H] = x + ffn(h)
int ptt_md_ffn(const void* h, const void* x, const void* wg, const void* wu,
               const void* wd, const void* sg, const void* su,
               const void* sd, const void* b1, const void* b2, int vbf,
               void* act, void* partial, void* counters, void* out, int T,
               int H, int I, int per_u, int ks_u, int per_d, int ks_d,
               int gelu, int wfmt, int device, void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T == 0) return (int)cudaSuccess;
  if ((gelu != 0 && gelu != 1) || (gelu && wfmt == md::kInt4) ||
      (wfmt == md::kInt4 && (H % 2 || I % 2)) || H % 8 || I % 8 ||
      (wfmt != md::kFp && (!sg || !sd || (!gelu && !su))) ||
      reinterpret_cast<uintptr_t>(x) % 8)
    return (int)cudaErrorInvalidValue;
  md::Call up{};
  up.x = h;
  up.w[0] = wg;
  up.w[1] = gelu ? wg : wu;
  up.M = T, up.N = I, up.K = H, up.wfmt = wfmt;
  up.per = per_u, up.n_ks = ks_u;
  up.epi = gelu ? md::kEpiGelu : md::kEpiSwiglu;
  md::Epi eu{};
  eu.scale[0] = static_cast<const float*>(sg);
  eu.scale[1] = static_cast<const float*>(gelu ? sg : su);
  eu.bias = b1;
  eu.vbf = vbf;
  eu.out = static_cast<bf16*>(act);
  eu.partial = static_cast<float*>(partial);
  eu.counters = static_cast<int*>(counters);
  int err = gelu ? md::launch_w<1, false>(up, eu, device, st)
                 : md::launch_w<1, true>(up, eu, device, st);
  if (err != 0) return err;
  md::Call dn{};
  dn.x = act;
  dn.w[0] = dn.w[1] = wd;
  dn.M = T, dn.N = H, dn.K = I, dn.wfmt = wfmt;
  dn.per = per_d, dn.n_ks = ks_d, dn.epi = md::kEpiResidual;
  md::Epi ed{};
  ed.scale[0] = static_cast<const float*>(sd);
  ed.bias = b2;
  ed.vbf = vbf;
  ed.x = static_cast<const bf16*>(x);
  ed.out = static_cast<bf16*>(out);
  ed.partial = static_cast<float*>(partial);
  ed.counters = static_cast<int*>(counters);
  return md::launch_w<2, false>(dn, ed, device, st);
}

}  // extern "C"
