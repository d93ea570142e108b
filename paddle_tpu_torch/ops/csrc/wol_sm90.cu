// weight_only_linear's bf16 route for Hopper (sm_90a): int8 and packed
// int4 weights dequantized in registers as wgmma's A operand.
//
// Replaces (bf16 activations; the f32 route stays on megakernels.cu's
// GEMM core, where true f32 products keep its 2e-5 gate):
//   paddle_tpu/ops/quant.py:weight_only_linear (Pallas _wol_kernel, int8;
//     _wol4_kernel, int4's even / odd split contraction).
//
// Contract (the TPU kernels'): out[M, N] = x[M, K] @ (q * s). q is int8
// [K, N], or packed int4 [K/2, N] with source rows 2i and 2i + 1 in the
// low and high nibble of byte row i, sign-extended; s is an f32 scale a
// column that multiplies the f32 sums, never the weight; the result is
// rounded once to bf16. A bf16 x integer product is exact in f32 (|q| <=
// 128 fits bf16's 8-bit significand), so this is the TPU kernels' f32 dot
// up to summation order.
//
// Bound on the H100: at decode the weight bytes (the int4 LM head, M 5 x
// [4096 -> 128256]: 262.7 MB, 0.079 ms at 3.35 TB/s; int8 525 MB, 0.157
// ms); at the 8B serving step (T 132) int4's products (2 T K N at 989
// TFLOP/s, 0.0157 ms for [4096 -> 14336]) outweigh its bytes.
//
// Design. The first port ran the megakernels' GEMM core: a block sized for
// 160 token rows whose 166 KB f32 staging tile allowed one block an SM, a
// ring stage of 8 KB of int4 weight beside a 23 KB activation tile that is
// zero fill at M 5, every chunk converted in shared memory and a
// __syncthreads before mma.sync, and a second kernel to finish the f32
// partials.
// - The product is computed transposed, out^T = W^T x^T: an accumulator row
//   is a weight column, an accumulator column a token, so wgmma m64nNk16
//   runs with N the token rows rounded up to NT in {8, 16, 32, 64, 136}
//   (n8 at decode's 4-5 rows, n136 at the serving step's 132; more rows
//   take more token tiles of 136). x is wgmma's K-major B operand, through
//   a 2-D TMA map over [M, K] (zeros past M and K).
// - The weight is the register A operand, built by each consumer thread
//   straight from the raw bytes in shared memory; no converted tile is
//   written back. The weight comes through a 2-D TMA map over the bytes
//   [K/2 or K, N] in boxes of 128 columns in the 128-byte swizzle (zeros
//   past N and K); rows of N bytes that are no whole 16-byte piece, or an
//   unaligned weight, are copied by the producer warp into the same layout
//   (cp.async of 8 or 4 bytes, counted on the stage's barrier; bytes where
//   N is odd).
//   Up to NT 64 a warpgroup owns the 128 columns of one box as two m64
//   tiles (TPW 2): thread (warp w, lane 4 g + c) reads one 32-bit word = 4
//   columns of a byte row, and its four accumulator rows (g, g + 8 of tile
//   0 and of tile 1) are those 4 columns. At NT 136 two tiles of f32 sums
//   (136 registers) would leave ptxas too few registers to keep wgmma
//   asynchronous (it serialises them), so a warpgroup owns one m64 tile,
//   64 columns of the box (TPW 1), and a thread reads 16 bits = its rows g
//   and g + 8. The words' 16-byte chunks are chosen so that the 4 byte rows
//   a warp reads at once (rows c or 2c, c = 0..3) fall on distinct banks
//   under the swizzle: TPW 2, chunks w and w + 4 for int4 (rows c: chunk ^
//   c stays within its half), 2w and 2w + 1 for int8 (rows 2c: chunk ^ 2c
//   keeps its parity); TPW 1, one chunk a warp.
// - The bf16 pairs come by exact bit operations (`i4pair`, `i8pair` in
//   wq_sm90.cuh, shared with megadecode_sm90.cu; their
//   plain counterparts are quant.int4_bf16x2_bits / int8_bf16_bits):
//   int4: one byte holds k = 2i, 2i + 1 of a column, exactly the two k of
//   one bf16x2 register: the byte spread to bits 0-7 and 12-19 (* 0x1001),
//   masked to its two nibbles with their sign bits flipped and OR-ed into
//   bf16 128 (one LOP3: 0x4300 | (n ^ 8) = 128 + (n ^ 8)), then 136
//   subtracted (bf16x2); int8: the byte with its sign bit flipped in the
//   mantissa of f32 2^23 (0x4B0000uu), 2^23 + 128 subtracted, and the top
//   halves of two such floats (k and k + 1) taken: an integer of 8
//   significant bits is exact in bf16.
// - A block is two consumer warpgroups and one producer warp (288
//   threads, one block an SM; ptxas then allows 168 registers a thread).
//   The producer's lane 0 keeps a ring of NS stages filled by TMA (full /
//   empty mbarriers), each stage SK of K: the x boxes and the weight boxes,
//   32 KB of weight at decode (6 stages, 192 KB of weight bytes in flight
//   an SM). A consumer builds the A pairs of GS k16 steps, issues their
//   wgmma, commits and waits for the group before (two register sets in
//   turn, fenced so that the compiler keeps them until that wait), and
//   releases a stage once its products are complete.
// - The grid is persistent over work items (a column tile of 128 TPW, a
//   token tile, a K slice), token tiles and slices of one column tile
//   adjacent. K is split only where the column tiles do not fill the card
//   (`plan_of`): each slice writes its raw f32 sums, register by register,
//   to a block of its own (128 contiguous bytes a warp store: partials laid
//   out as [M, N] rows, 16-64 KB apart, read back tens of times slower
//   than their bytes) and counts itself on its (tile, warpgroup) counter;
//   the last to arrive sums every slice's block in slice order, then scales
//   and rounds (one launch; the counter returns to 0 for the next call).
// - Epilogue: each f32 sum times its column's scale, rounded once; a
//   thread's 2 or 4 columns of one token go out as one 4- or 8-byte store
//   (a warp's stores fill whole 32-byte sectors). Rows past M and columns
//   past N are not written.

#include <algorithm>

#include "wq_sm90.cuh"

namespace ptt {
namespace wol {

using bf16 = __nv_bfloat16;
using namespace sm90;
using namespace wq;

constexpr int kWG = 128;                   // a warpgroup
constexpr int kConsumers = 2 * kWG;        // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kSmemMax = 232448;
enum : int { kInt8 = 1, kInt4 = 2 };       // quant.WFMT's codes

// The token tile for M rows: the smallest wgmma width of the set that
// holds them, 136 past that.
__host__ __device__ constexpr int token_tile(int M) {
  return M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 ? 32 : M <= 64 ? 64 : 136;
}

template <int WQ, int NT>
struct Geo {
  static constexpr bool I4 = WQ == kInt4;
  static constexpr int TPW = NT > 64 ? 1 : 2;  // m64 tiles a warpgroup
  static constexpr int CPT = 2 * TPW;          // columns a thread
  static constexpr int BN = 128 * TPW;         // weight columns an item
  static constexpr int ACC = TPW * NT / 2;     // f32 sums a thread
  // x boxes of 64 k a stage: 32 KB of weight a stage where the x boxes
  // leave room for a deep ring
  static constexpr int KB = I4 && NT <= 32 ? 4 : 2;
  static constexpr int SK = 64 * KB;           // k a stage
  static constexpr int WR = I4 ? SK / 2 : SK;  // weight byte rows a box
  static constexpr int X_BYTES = KB * NT * 128;
  static constexpr int W_BOX = WR * 128;
  static constexpr int STAGE = X_BYTES + TPW * W_BOX;
  static constexpr int NS_FIT = (kSmemMax - 1024 - 256) / STAGE;
  static constexpr int NS = NS_FIT > 8 ? 8 : NS_FIT;
  static constexpr int GS = 4;                 // k16 steps a commit group
  static constexpr int STEPS = SK / 16;        // k16 steps a stage
  static constexpr size_t SMEM = 1024 + (size_t)NS * STAGE + 256;
  static_assert(NS >= 2, "a ring of two stages at least");
  static_assert(STEPS % (2 * GS) == 0, "register sets pair up in a stage");
  static_assert(STAGE % 1024 == 0, "swizzled boxes on 1024-byte lines");
};

// What every thread of a launch knows of its work.
struct Plan {
  int M, N, K, R;        // R: the weight's byte rows (K / 2 or K)
  int n_tt, n_ct, nk;    // token tiles, column tiles, SK chunks of K
  int per, n_ks;         // chunks a slice, slices
  int tma_w;             // the weight through its tensor map
  int unit;              // else the bytes a producer copy moves: 8, 4, 1
};

__device__ __forceinline__ void decode(const Plan& p, int item, int& ct,
                                       int& tt, int& ks) {
  ks = item % p.n_ks;
  const int r = item / p.n_ks;
  tt = r % p.n_tt;
  ct = r / p.n_tt;
}

// One commit group: the A pairs of GS k16 steps from `s0`, their products
// into every tile (steps in x boxes past K skipped), committed.
template <int WQ, int NT, int GS, int TPW>
__device__ __forceinline__ void group(uint32_t (&a)[GS][TPW][4],
                                      float (&acc)[TPW][NT / 2],
                                      const unsigned char* wb, uint32_t xs,
                                      int s0, int c, int o0, int o1,
                                      int kb_live, int accf) {
#pragma unroll
  for (int s = 0; s < GS; ++s)
    build<WQ == kInt4, TPW>(a[s], wb, s0 + s, c, o0, o1);
  wg_fence();
#pragma unroll
  for (int s = 0; s < GS; ++s) {
    const int step = s0 + s;
    if ((step >> 2) < kb_live) {
      const uint64_t b = desc_k(xs, NT, step);
      const int f = accf | (step > 0);
#pragma unroll
      for (int t = 0; t < TPW; ++t) mma_rs<0>(acc[t], a[s][t], b, f);
    }
  }
  wg_commit();
}

// Keep registers live, and unchanged, until the wait that completes the
// products reading them (the compiler sees them consumed or defined at
// the asm statements; wgmma reads and writes them asynchronously).
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

// The thread's CPT columns' scales from n (0 past N).
template <int CPT>
__device__ __forceinline__ void load_scales(float (&sc)[CPT],
                                            const float* scale, int n,
                                            int N) {
#pragma unroll
  for (int i = 0; i < CPT; ++i)
    sc[i] = n + i < N ? __ldg(scale + n + i) : 0.f;
}

// Token `tok`'s CPT columns from n, rounded once, to out (one 4- or
// 8-byte store where the row holds them whole).
template <int CPT>
__device__ __forceinline__ void store_out(bf16* out, int N, int tok, int n,
                                          const float (&v)[CPT]) {
  bf16* o = out + (size_t)tok * N + n;
  if (N % CPT == 0 && n + CPT - 1 < N) {
    uint32_t w[CPT / 2];
#pragma unroll
    for (int i = 0; i < CPT / 2; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    if constexpr (CPT == 4)
      *reinterpret_cast<uint2*>(o) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<uint32_t*>(o) = w[0];
  } else {
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      if (n + i < N) o[i] = __float2bfloat16_rn(v[i]);
  }
}

// The f32 values of token `tok`'s CPT columns from n: accumulator element
// e of n8 block j, rows g then g + 8 of each tile.
template <int NT, int TPW>
__device__ __forceinline__ void element(float (&v)[2 * TPW],
                                        const float (&acc)[TPW][NT / 2],
                                        int j, int e) {
#pragma unroll
  for (int t = 0; t < TPW; ++t) {
    v[2 * t] = acc[t][4 * j + e];
    v[2 * t + 1] = acc[t][4 * j + 2 + e];
  }
}

// Tensor maps: tx over x [M, K] bf16, boxes 64 x NT; tw over the weight
// bytes [R, N], boxes 128 x WR (unused where p.tma_w is 0).
template <int WQ, int NT>
__global__ void __launch_bounds__(kThreads, 1)
    wol_sm90(const __grid_constant__ CUtensorMap tx,
             const __grid_constant__ CUtensorMap tw,
             const unsigned char* __restrict__ qw,
             const float* __restrict__ scale, float* __restrict__ partial,
             int* __restrict__ counters, bf16* __restrict__ out,
             const Plan p) {
  using G = Geo<WQ, NT>;
  constexpr bool I4 = WQ == kInt4;
  constexpr int TPW = G::TPW, CPT = G::CPT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + G::NS * G::STAGE);
  uint64_t* empty = full + G::NS;
  volatile int* last = reinterpret_cast<volatile int*>(empty + G::NS);
  const int items = p.n_ct * p.n_tt * p.n_ks;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::NS; ++s) {
      // TMA's arrival, and where the weight takes no tensor map one more
      // from each producer lane
      mbar_init(full + s, p.tma_w ? 1 : 33);
      mbar_init(empty + s, kConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer warp: lane 0 issues the TMA loads of every stage; where
    // the weight takes no tensor map, every lane copies its bytes
    int st = 0, ph = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      int ct, tt, ks;
      decode(p, item, ct, tt, ks);
      const int c0 = ks * p.per, c1 = min(c0 + p.per, p.nk);
      const int n0 = ct * G::BN;
      for (int kc = c0; kc < c1; ++kc) {
        mbar_wait(empty + st, ph ^ 1);
        unsigned char* x = sm + st * G::STAGE;
        unsigned char* w = x + G::X_BYTES;
        const int kb_live = min(G::KB, (p.K - kc * G::SK + 63) / 64);
        if (!p.tma_w) {
          // pieces of `unit` bytes (a unit never straddles a swizzled
          // 16-byte chunk, and a row of N bytes holds whole units), each
          // lane's completion counted on the stage's barrier
          const int unit = p.unit;
          for (int i = lane; i < TPW * G::W_BOX / unit; i += 32) {
            const int o = i * unit;
            const int b = o / G::W_BOX, r = (o % G::W_BOX) >> 7, j = o & 127;
            const int row = kc * G::WR + r, col = n0 + 128 * b + j;
            const bool ok = row < p.R && col < p.N;
            unsigned char* d = w + b * G::W_BOX + r * 128 +
                               (((j >> 4) ^ (r & 7)) << 4) + (j & 15);
            const unsigned char* src = ok ? qw + (size_t)row * p.N + col : qw;
            if (unit == 1)
              *d = ok ? *src : 0;
            else
              cp_async_ca(d, src, unit, ok);
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
        if (lane == 0) {
          mbar_expect_tx(full + st, kb_live * NT * 128 +
                                        (p.tma_w ? TPW * G::W_BOX : 0));
          for (int b = 0; b < kb_live; ++b)
            tma_load2(x + b * NT * 128, &tx, full + st,
                      kc * G::SK + 64 * b, tt * NT);
          if (p.tma_w)
            for (int b = 0; b < TPW; ++b)
              tma_load2(w + b * G::W_BOX, &tw, full + st, n0 + 128 * b,
                        kc * G::WR);
        }
        __syncwarp();
        if (++st == G::NS) st = 0, ph ^= 1;
      }
    }
    return;
  }

  // warp-uniform, so that the addresses derived from it stay uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWG, 0);
  const int t = threadIdx.x % kWG, w = t >> 5, g = lane >> 2, c = lane & 3;
  // the 16-byte chunk of the thread's columns in its box's rows, the rows'
  // swizzle (row % 8) at the two offsets it reads, and its first column
  int chunk, x0, x1, colq;
  if constexpr (TPW == 2) {
    chunk = I4 ? w + 4 * (g >> 2) : 2 * w + (g >> 2);
    colq = wg * 128 + 16 * chunk + 4 * (g & 3);
  } else {
    chunk = 4 * wg + w;
    colq = 16 * chunk + 2 * g;
  }
  x0 = I4 ? c : 2 * c;
  x1 = I4 ? c + 4 : 2 * c + 1;
  const int within = TPW == 2 ? 4 * (g & 3) : 2 * g;
  const int o0 = ((chunk ^ x0) << 4) + within;
  const int o1 = ((chunk ^ x1) << 4) + within;
  const int box = TPW == 2 ? wg : 0;
  constexpr int GS = G::GS, NG = G::STEPS / GS;
  float acc[TPW][NT / 2];
  uint32_t a0[GS][TPW][4], a1[GS][TPW][4];
  int st = 0, ph = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int ct, tt, ks;
    decode(p, item, ct, tt, ks);
    const int c0 = ks * p.per, c1 = min(c0 + p.per, p.nk);
    int prev = -1;
    for (int kc = c0; kc < c1; ++kc) {
      mbar_wait(full + st, ph);
      const unsigned char* x = sm + st * G::STAGE;
      const unsigned char* wb = x + G::X_BYTES + box * G::W_BOX;
      const uint32_t xs = smem_u32(x);
      const int kb_live = min(G::KB, (p.K - kc * G::SK + 63) / 64);
      const int accf = kc > c0;
#pragma unroll
      for (int gi = 0; gi < NG; gi += 2) {
        group<WQ, NT, GS, TPW>(a0, acc, wb, xs, gi * GS, c, o0, o1,
                               kb_live, accf);
        wg_wait<1>();  // the group on a1 is complete
        fence_acc(acc);
        fence_a(a1);
        if (gi == 0) {
          // the previous stage's products are complete: release it
          __syncwarp();
          if (prev >= 0 && lane == 0) mbar_arrive(empty + prev);
          prev = -1;
        }
        group<WQ, NT, GS, TPW>(a1, acc, wb, xs, (gi + 1) * GS, c, o0, o1,
                               kb_live, accf);
        wg_wait<1>();  // the group on a0 is complete
        fence_acc(acc);
        fence_a(a0);
      }
      prev = st;
      if (++st == G::NS) st = 0, ph ^= 1;
    }
    wg_wait<0>();
    fence_acc(acc);
    fence_a(a1);
    __syncwarp();
    if (prev >= 0 && lane == 0) mbar_arrive(empty + prev);

    if (p.n_ks > 1) {
      // split K: this slice's raw f32 sums to its block of the partials,
      // register by register ([slice][tile][warpgroup][register][thread]:
      // a warp's stores and loads are 128 contiguous bytes, whatever N),
      // then the last slice of the (tile, warpgroup) to arrive sums every
      // slice's block in slice order into its registers and finishes
      constexpr int ACC = G::ACC;
      const int ci = ((ct * p.n_tt) + tt) * 2 + wg;
      float* mine = partial + ((size_t)ks * p.n_tt * p.n_ct * 2 + ci) * ACC *
                                  kWG + t;
#pragma unroll
      for (int t2 = 0; t2 < TPW; ++t2)
#pragma unroll
        for (int i = 0; i < NT / 2; ++i)
          mine[(t2 * NT / 2 + i) * kWG] = acc[t2][i];
      __threadfence();
      named_sync(1 + wg, kWG);
      if (t == 0) last[wg] = atomicAdd(counters + ci, 1) == p.n_ks - 1;
      named_sync(1 + wg, kWG);
      if (!last[wg]) continue;
      __threadfence();
#pragma unroll
      for (int t2 = 0; t2 < TPW; ++t2)
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) acc[t2][i] = 0.f;
      for (int k = 0; k < p.n_ks; ++k) {
        const float* src =
            partial + ((size_t)k * p.n_tt * p.n_ct * 2 + ci) * ACC * kWG + t;
#pragma unroll
        for (int t2 = 0; t2 < TPW; ++t2)
#pragma unroll
          for (int i = 0; i < NT / 2; ++i)
            acc[t2][i] += src[(t2 * NT / 2 + i) * kWG];
      }
      if (t == 0) counters[ci] = 0;  // ready for the next launch
    }
    // the epilogue: this thread's CPT columns of the item, its tokens,
    // times the columns' scales, rounded once
    const int n = ct * G::BN + colq;
    const int tok0 = tt * NT + 2 * c;
    float sc[CPT];
    load_scales<CPT>(sc, scale, n, p.N);
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tok = tok0 + 8 * j + e;
        if (tok >= p.M) continue;
        float v[CPT];
        element<NT, TPW>(v, acc, j, e);
#pragma unroll
        for (int i = 0; i < CPT; ++i) v[i] *= sc[i];
        store_out<CPT>(out, p.N, tok, n, v);
      }
  }
}

// The K split of an [M, K] x [K, N] product on `sms` SMs: the slice count
// (at most 16) that minimises, in units of one SK chunk of one item, the
// rounds of items times their chunks, plus, for a split, each item's
// finish (its partials written, a fence, the counter) and the last
// slice's reads of every slice's partials, and the partials' bytes at
// half the rate one chunk streams at (they stay in L2). The finish and the
// reads, as timed on an H100 across slice counts (quant_limits.py
// --splits): about 10 chunks' time and half a chunk a slice at NT 136, 4
// and a tenth below it. A split whose partials pass 16 MiB is never
// taken. Ties keep fewer slices. `slices` > 0 forces that many (as near
// as whole chunks allow) instead.
template <int WQ, int NT>
static void plan_of(int M, int N, int K, int sms, int slices, int* per,
                    int* n_ks) {
  using G = Geo<WQ, NT>;
  const long tiles = (long)((M + NT - 1) / NT) * ((N + G::BN - 1) / G::BN);
  const int nk = (K + G::SK - 1) / G::SK;
  if (slices > 0) {
    const int want = std::min(slices, nk);
    *per = (nk + want - 1) / want;
    *n_ks = (nk + *per - 1) / *per;
    return;
  }
  const double chunk_bytes = (double)G::TPW * G::W_BOX * sms;
  const double finish = NT > 64 ? 10.0 : 4.0, read = NT > 64 ? 0.5 : 0.1;
  double best = 0.0;
  *per = nk;
  *n_ks = 1;
  for (int s = 1; s <= std::min(16, nk); ++s) {
    const int pc = (nk + s - 1) / s, s2 = (nk + pc - 1) / pc;
    const double part = 4.0 * s2 * tiles * 2 * kWG * G::ACC;
    if (s2 > 1 && part > 16.0 * 1024 * 1024) break;
    const long rounds = (tiles * s2 + sms - 1) / sms;
    const double cost =
        (double)rounds * (pc + (s2 > 1 ? finish : 0.0)) +
        (s2 > 1 ? read * s2 + 0.5 * part / chunk_bytes : 0.0);
    if (s == 1 || cost < best) {
      best = cost;
      *per = pc;
      *n_ks = s2;
    }
  }
}

// plan_of for M's token tile; *bn and *acc: the tile's columns an item and
// f32 sums a thread.
template <int WQ, int NT>
static void plan_nt(int M, int N, int K, int sms, int slices, int* per,
                    int* n_ks, int* bn, int* acc) {
  *bn = Geo<WQ, NT>::BN;
  *acc = Geo<WQ, NT>::ACC;
  plan_of<WQ, NT>(M, N, K, sms, slices, per, n_ks);
}
template <int WQ>
static void plan_w(int M, int N, int K, int sms, int slices, int* per,
                   int* n_ks, int* bn, int* acc) {
  switch (token_tile(M)) {
    case 8: return plan_nt<WQ, 8>(M, N, K, sms, slices, per, n_ks, bn, acc);
    case 16:
      return plan_nt<WQ, 16>(M, N, K, sms, slices, per, n_ks, bn, acc);
    case 32:
      return plan_nt<WQ, 32>(M, N, K, sms, slices, per, n_ks, bn, acc);
    case 64:
      return plan_nt<WQ, 64>(M, N, K, sms, slices, per, n_ks, bn, acc);
    default:
      return plan_nt<WQ, 136>(M, N, K, sms, slices, per, n_ks, bn, acc);
  }
}

template <int WQ, int NT>
static int launch(const void* x, const void* qw, const float* scale,
                  float* partial, int* counters, bf16* out, int M, int N,
                  int K, int per, int n_ks, int device, cudaStream_t st) {
  using G = Geo<WQ, NT>;
  Plan p;
  p.M = M, p.N = N, p.K = K, p.R = WQ == kInt4 ? K / 2 : K;
  p.n_tt = (M + NT - 1) / NT, p.n_ct = (N + G::BN - 1) / G::BN;
  p.nk = (K + G::SK - 1) / G::SK, p.per = per, p.n_ks = n_ks;
  if (per < 1 || (p.nk + per - 1) / per != n_ks)
    return (int)cudaErrorInvalidValue;
  const uintptr_t a = reinterpret_cast<uintptr_t>(qw);
  p.tma_w = N % 16 == 0 && a % 16 == 0;
  p.unit = N % 8 == 0 && a % 8 == 0 ? 8 : N % 4 == 0 && a % 4 == 0 ? 4 : 1;
  CUtensorMap tx, tw;
  const u64 xd[2] = {(u64)K, (u64)M};
  const unsigned xb[2] = {64, NT};
  int e = cached_map(&tx, device, x, 2, xd, xb,
                     CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
  if (e != 0) return e;
  if (p.tma_w) {
    const u64 wd[2] = {(u64)N, (u64)p.R};
    const unsigned wb[2] = {128, G::WR};
    e = cached_map(&tw, device, qw, 2, wd, wb, CU_TENSOR_MAP_DATA_TYPE_UINT8);
    if (e != 0) return e;
  } else {
    tw = tx;  // unused
  }
  static int smem_set[64] = {0};  // the attribute, once a device
  if (!smem_set[device & 63]) {
    cudaError_t ce = cudaFuncSetAttribute(
        wol_sm90<WQ, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)G::SMEM);
    if (ce != cudaSuccess) return (int)ce;
    smem_set[device & 63] = 1;
  }
  const long items = (long)p.n_ct * p.n_tt * p.n_ks;
  const int grid = (int)std::min<long>(sm_count(device), items);
  wol_sm90<WQ, NT><<<grid, kThreads, G::SMEM, st>>>(
      tx, tw, static_cast<const unsigned char*>(qw), scale, partial,
      counters, out, p);
  return (int)cudaGetLastError();
}

template <int WQ>
static int launch_w(const void* x, const void* qw, const float* scale,
                    float* partial, int* counters, bf16* out, int M, int N,
                    int K, int per, int n_ks, int device, cudaStream_t st) {
  switch (token_tile(M)) {
    case 8:
      return launch<WQ, 8>(x, qw, scale, partial, counters, out, M, N, K,
                           per, n_ks, device, st);
    case 16:
      return launch<WQ, 16>(x, qw, scale, partial, counters, out, M, N, K,
                            per, n_ks, device, st);
    case 32:
      return launch<WQ, 32>(x, qw, scale, partial, counters, out, M, N, K,
                            per, n_ks, device, st);
    case 64:
      return launch<WQ, 64>(x, qw, scale, partial, counters, out, M, N, K,
                            per, n_ks, device, st);
    default:
      return launch<WQ, 136>(x, qw, scale, partial, counters, out, M, N, K,
                             per, n_ks, device, st);
  }
}

}  // namespace wol
}  // namespace ptt

using namespace ptt;

extern "C" {

// The launch plan of an [M, K] x [K, N] bf16 product against a wfmt (1
// int8, 2 int4) weight on `device`: out[0] the token tile, out[1] the K
// slices, out[2] SK chunks a slice, out[3] the split counters and out[4]
// the f32 partials it needs (both 0 without a split). The wrapper
// allocates them from it. `slices` 0 takes the plan's split; more forces
// that many slices (quant_limits.py --splits times them).
int ptt_wol_plan(int M, int N, int K, int wfmt, int slices, int device,
                 int* out) {
  if (M < 1 || N < 1 || K < 1 || slices < 0 ||
      (wfmt != wol::kInt8 && wfmt != wol::kInt4))
    return (int)cudaErrorInvalidValue;
  const int sms = wol::sm_count(device);
  int per = 0, n_ks = 0, bn = 0, acc = 0;
  if (wfmt == wol::kInt4)
    wol::plan_w<wol::kInt4>(M, N, K, sms, slices, &per, &n_ks, &bn, &acc);
  else
    wol::plan_w<wol::kInt8>(M, N, K, sms, slices, &per, &n_ks, &bn, &acc);
  const int nt = wol::token_tile(M);
  const long tiles = (long)((M + nt - 1) / nt) * ((N + bn - 1) / bn);
  out[0] = nt;
  out[1] = n_ks;
  out[2] = per;
  out[3] = n_ks > 1 ? (int)(tiles * 2) : 0;
  out[4] = n_ks > 1 ? (int)(n_ks * tiles * 2 * wol::kWG * acc) : 0;
  return (int)cudaSuccess;
}

// x [M, K] bf16; qw int8 [K, N] (wfmt 1) or packed int4 [K/2, N] (wfmt 2);
// scale [N] f32; (per, n_ks) from ptt_wol_plan; its f32 partials and
// counters (zero, left zero) where n_ks > 1 -> out [M, N] bf16
int ptt_wol_sm90(const void* x, const void* qw, const void* scale,
                 void* partial, void* counters, void* out, int M, int N,
                 int K, int wfmt, int per, int n_ks, int device,
                 void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return (int)cudaSuccess;
  if (K == 0)  // no products: every output is zero
    return (int)cudaMemsetAsync(out, 0, (size_t)M * N * 2, st);
  if ((wfmt == wol::kInt4 && K % 2) || (n_ks > 1 && !(partial && counters)))
    return (int)cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  float* pa = static_cast<float*>(partial);
  int* cn = static_cast<int*>(counters);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (wfmt == wol::kInt4)
    return wol::launch_w<wol::kInt4>(x, qw, s, pa, cn, o, M, N, K, per, n_ks,
                                     device, st);
  if (wfmt == wol::kInt8)
    return wol::launch_w<wol::kInt8>(x, qw, s, pa, cn, o, M, N, K, per, n_ks,
                                     device, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
