// flash_sdpa (forward, backward) for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas_flash.py:flash_sdpa (Pallas _fwd_kernel,
//           _bwd_dq_kernel, _bwd_dkv_kernel and the custom VJP around them).
//
// Bound on the H100: the products. Causal, the forward does 2 products
// (q k^T and p v) over the visible half, 4 * B * H * Sq * Sk * D / 2 FLOP:
// at the training shape (B 1, S 8192, H 32, D 128) 5.5e11 FLOP, 0.556 ms at
// 989 TFLOP/s (bf16). The gradient needs 5 products (q k^T again, do v^T,
// dq, dk, dv), 1.37e12 FLOP, 1.39 ms, and the fused backward below does
// exactly those 5. The bytes (q, k, v, o, do and the grads once each,
// ~0.5 GB) take ~0.15 ms; the backward's f32 dq sums add ~4 GB of
// reduce-adds in L2 at that shape.
//
// What it computes (pallas_flash.py:77-213): inputs [B, S, H, D], read with
// their batch / sequence / head strides; s = (q . k) * scale in f32; key j
// is hidden from row i when causal and j > i + (Sk - Sq) (bottom-right
// aligned), when seg_q[i] != seg_kv[j], or past the ragged edge. The
// forward is an online softmax; p is rounded to the input type before
// p v, with f32 accumulation; it writes o and an f32 lse [B, H, Sq]. A row
// with no visible key gets o = 0 and lse = +1e30, so the backward's
// exp(s - lse) underflows to 0, not NaN. The backward takes di = sum(do *
// o) in f32 first (a small pre-pass); ds = p (dp - di) scale is rounded to
// the input type before its products.
//
// bf16 design (Hopper: wgmma, TMA, mbarriers; the helpers live in
// flash_sm90.cuh). This replaces a first port that ran every product as
// mma.sync m16n8k16 fed by ldmatrix, a warp per 16 rows, so that each warp
// read the whole K / V tile from shared memory again (about 1/16 byte a
// FLOP: half of the tensor cores' rate at best), with cp.async issued by
// the computing warps and 1 block of 4 warps an SM at head dim 192.
// - A block is two consumer warpgroups of 64 rows (or keys) each. Tiles
//   arrive by TMA (4-D tensor maps over (D, H, S, B) encoded on the host,
//   boxes of 64 columns in the 128-byte swizzle, zeros past the ragged
//   edge) into a ring of shared-memory stages, each completed on an
//   mbarrier; thread 0 fills the ring first, and the last of the 8 warps
//   to release a stage refills it. There is no producer warp: ptxas (CUDA
//   12.9) holds every warp to the register count of the launch bound (168
//   at 384 threads) whatever setmaxnreg raises it to, and a producer
//   warpgroup made the D 192 forward and the D 128 backward spill and
//   serialise their wgmma; 256 threads give each consumer 255 registers.
// - Every product is a wgmma with B (and A for q k^T and ds k) read from
//   shared memory through matrix descriptors; p and ds, rounded to bf16,
//   are the register A operand of the product that follows them.
// - Forward: a block owns (b, h, 128 q rows), causal tiles heaviest first;
//   K / V stream in tiles of 128 keys (D 64: 4 stages, D 128: 2) or 96
//   (D 192: 2 stages, 193 KB). s = q k^T (m64nBKVk16, K-major), an online
//   softmax in registers (scale . log2 e folded into one FMA ahead of ex2;
//   the mask evaluated only on tiles that hold a hidden entry; a tile
//   hidden from all 64 rows of a warpgroup is skipped), o += p v (v
//   MN-major). o / l goes out as bf16 rows, rows past Sq clipped.
// - Backward: one fused kernel does the 5 products. A block owns (b, h,
//   128 keys), K and V loaded once; each warpgroup owns 64 keys, with dK
//   and dV in registers. The ring streams 64-row Q / dO tiles with their
//   lse (log2 domain, +inf past Sq) and di rows, written by the pre-pass
//   and bulk-copied. Per q tile: s^T = k q^T and dp^T = v do^T, p^T =
//   exp2(s^T c - lse), ds^T = p^T (dp^T - di) scale; dv += p^T do, dk +=
//   ds^T q; ds^T goes through shared memory (the 128-byte swizzle by hand)
//   to be the MN-major A operand of dq_tile = ds k, each warpgroup taking
//   half of D; each half is staged in shared memory and added into an f32
//   workspace by one bulk reduce-add (cp.reduce.async.bulk), the
//   workspace tiled [B, H, Sq / 64, 64 D] in accumulator order. Causal
//   key tiles are taken heaviest first (smallest k0). A third kernel turns
//   the workspace into bf16 dq [B, Sq, H, D]. The reduce-adds make dq's
//   summation order vary from run to run. Head dims 64 and 128; 192 is
//   refused (its dK and dV alone would take 192 registers a thread).
// bf16 needs scale > 0 (the row max is taken over the raw products). f32
// takes a scalar path on the CUDA cores (a warp per row, D / 32 dimensions
// a lane, one warp sum per product), so the card can be held to the plain
// f32 version at 2e-5.

#include "flash_sm90.cuh"
#include "flash_tiles.cuh"

namespace ptt {
namespace flash {

// Is key `col` hidden from q row `row`? (seg_row: seg_q of the row)
__device__ __forceinline__ bool hidden(const Flash& p, int b, int row,
                                      int col, int seg_row) {
  if (col >= p.Sk || row >= p.Sq) return true;
  if (p.causal && col > row + (p.Sk - p.Sq)) return true;
  return p.seg_q != nullptr && p.seg_kv[(size_t)b * p.Sk + col] != seg_row;
}

// Does every row of [r0, r0 + nr) see every key of [c0, c0 + nc)? Such
// interior tiles skip the mask (rows past Sq are never stored, and their
// p is 0 in the backward).
__device__ __forceinline__ bool tile_visible(const Flash& p, int r0, int nr,
                                             int c0, int nc) {
  return p.seg_q == nullptr && c0 + nc <= p.Sk && r0 + nr <= p.Sq &&
         (!p.causal || c0 + nc - 1 <= r0 + (p.Sk - p.Sq));
}

__device__ __forceinline__ int seg_of(const Flash& p, int b, int row) {
  return (p.seg_q != nullptr && row < p.Sq) ? p.seg_q[(size_t)b * p.Sq + row]
                                            : 0;
}

// ------------------------------------------------------------------ bf16
using namespace sm90;

constexpr int kWGThreads = 128;               // a warpgroup
constexpr int kSm90Threads = 2 * kWGThreads;  // two consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;

// The shared-memory base rounded up to the swizzle's 1024 bytes (the
// launch asks for 1024 bytes more than the layout needs).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// A stage of the ring is refilled by the last of the block's 8 warps to
// release it: each warp's lane 0 counts its release in `count` (never
// reset: a round adds 8) and learns whether it was the last.
__device__ __forceinline__ bool last_release(unsigned* count) {
  __threadfence_block();
  const bool last = (atomicAdd(count, 1u) & 7u) == 7u;
  if (last) __threadfence_block();
  return last;
}

template <int D>
struct FwdTile {
  static constexpr int BQ = 128;                   // q rows a block
  static constexpr int BKV = D == 192 ? 96 : 128;  // keys a stage
  static constexpr int NS = D == 64 ? 4 : 2;       // stages
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;
  static constexpr int BAR_BYTES = 8 * (1 + 2 * NS) + 4 * NS;
  static constexpr size_t SMEM = 1024 + Q_BYTES + 2 * NS * KV_BYTES +
                                 BAR_BYTES;
};

template <int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
    fwd_sm90(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const Flash p) {
  using G = FwdTile<D>;
  constexpr int BQ = G::BQ, BKV = G::BKV, NS = G::NS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* Qs = sm;                     // [D/64][BQ][128 B]
  unsigned char* Ks = Qs + G::Q_BYTES;        // [NS] x K tile
  unsigned char* Vs = Ks + NS * G::KV_BYTES;  // [NS] x V tile
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + NS * G::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + NS;
  unsigned* released = reinterpret_cast<unsigned*>(v_full + NS);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  // causal skip: keys past the tile's last row + (Sk - Sq) are hidden
  const int kv_end = p.causal ? min(p.Sk, q0 + BQ + p.Sk - p.Sq) : p.Sk;
  const int n_kt = kv_end > 0 ? (kv_end + BKV - 1) / BKV : 0;
  // K and V of tile kt into stage st
  auto load_kv = [&](int kt, int st) {
    unsigned char* kd = Ks + st * G::KV_BYTES;
    unsigned char* vd = Vs + st * G::KV_BYTES;
    mbar_expect_tx(k_full + st, G::KV_BYTES);
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      tma_load4(kd + c * BKV * 128, &tk, k_full + st, c * 64, h, kt * BKV,
                b);
    mbar_expect_tx(v_full + st, G::KV_BYTES);
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      tma_load4(vd + c * BKV * 128, &tv, v_full + st, c * 64, h, kt * BKV,
                b);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      released[s] = 0;
    }
    mbar_fence_init();
    mbar_expect_tx(q_full, G::Q_BYTES);
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      tma_load4(Qs + c * BQ * 128, &tq, q_full, c * 64, h, q0, b);
    for (int kt = 0; kt < min(NS, n_kt); ++kt) load_kv(kt, kt);
  }
  __syncthreads();

  // warp-uniform, so that every address and descriptor derived from it
  // stays in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWGThreads, 0);
  const int t = threadIdx.x % kWGThreads, warp = t >> 5, lane = t & 31;
  const int r0 = q0 + wg * 64;  // this warpgroup's first row
  const int rows[2] = {r0 + warp * 16 + (lane >> 2),
                       r0 + warp * 16 + (lane >> 2) + 8};
  const int segs[2] = {seg_of(p, b, rows[0]), seg_of(p, b, rows[1])};
  const float c = p.scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  const uint32_t qa = smem_u32(Qs) + wg * 64 * 128;
  mbar_wait(q_full, 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % NS, ph = (kt / NS) & 1, k0 = kt * BKV;
    // a tile every key of which is hidden from all 64 rows
    const bool skip = p.causal && k0 > r0 + 63 + (p.Sk - p.Sq);
    const uint32_t kb = smem_u32(Ks + st * G::KV_BYTES);
    const uint32_t vb = smem_u32(Vs + st * G::KV_BYTES);
    float s[BKV / 2];
    uint32_t pa[BKV / 16][4];
    mbar_wait(k_full + st, ph);
    if (!skip) {
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<0, 0>(s, desc_k(qa, BQ, kk), desc_k(kb, BKV, kk), kk > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(s);

      const int cb = k0 + (lane & 3) * 2;
      if (!tile_visible(p, r0, 64, k0, BKV)) {
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (hidden(p, b, rows[e >> 1], cb + j * 8 + (e & 1),
                       segs[e >> 1]))
              s[4 * j + e] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
      float ms[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float mnew = fmaxf(m[hh], quad_max(mx[hh]));
        // rows that see no key yet keep 0: every p and alpha is then 0
        ms[hh] = mnew == -INFINITY ? 0.f : mnew * c;
        alpha[hh] = ex2(m[hh] * c - ms[hh]);
        m[hh] = mnew;
      }
      // p, rounded to bf16 pairs as it is made (s dies pair by pair);
      // pair r of k16 slice kk is row r & 1's
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int x = 8 * kk + 2 * r;
          const float p0 = ex2(fmaf(s[x], c, -ms[r & 1]));
          const float p1 = ex2(fmaf(s[x + 1], c, -ms[r & 1]));
          rs[r & 1] += p0 + p1;
          pa[kk][r] = pack_bf16(p0, p1);
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        l[hh] = l[hh] * alpha[hh] + quad_sum(rs[hh]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
    }
    mbar_wait(v_full + st, ph);
    if (!skip) {
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        mma_rs<1>(o, pa[kk], desc_mn(vb, BKV, kk), 1);
      wg_commit();
      wg_wait<0>();
      fence_regs(o);
      fence_regs(pa);
    }
    __syncwarp();
    if (lane == 0 && last_release(released + st) &&
        kt + NS < n_kt)
      load_kv(kt + NS, st);
  }

  const float lsafe[2] = {l[0] == 0.f ? 1.f : l[0], l[1] == 0.f ? 1.f : l[1]};
  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (rows[hh] >= p.Sq) continue;
    bf16* dst = out + (((size_t)b * p.Sq + rows[hh]) * p.H + h) * D +
                (lane & 3) * 2;
    const float inv = 1.f / lsafe[hh];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
          __floats2bfloat162_rn(o[4 * j + 2 * hh] * inv,
                                o[4 * j + 2 * hh + 1] * inv);
    if ((lane & 3) == 0)
      p.lse[((size_t)b * p.H + h) * p.Sq + rows[hh]] =
          l[hh] == 0.f ? -kNeg : m[hh] * p.scale + logf(lsafe[hh]);
  }
}

template <int D>
struct BwdTile {
  static constexpr int BK = 128;  // keys a block
  static constexpr int BQ = 64;   // q rows a stage
  static constexpr int NS = 2;    // stages
  static constexpr int K_BYTES = BK * D * 2;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int DS_BYTES = BK * BQ * 2;  // ds^T, [BK][BQ] swizzled
  static constexpr int ROW_BYTES = 2 * BQ * 4;  // lse and di of a stage
  // a warpgroup's half of a dq tile in f32, in accumulator order
  static constexpr int DQ_BYTES = BQ * D / 2 * 4;
  static constexpr int BAR_BYTES = 8 * (1 + NS) + 4 * NS;
  static constexpr size_t SMEM = 1024 + 2 * K_BYTES + 2 * NS * Q_BYTES +
                                 2 * DS_BYTES + 2 * DQ_BYTES +
                                 NS * ROW_BYTES + BAR_BYTES;
};

// The backward's pre-pass over [B, Sq rounded up to 64, H] rows, a warp a
// row: di = sum(do * o) in f32 and lse in the log2 domain, into rows
// [B, H, sq_pad] (rows past Sq: lse +inf, so p is 0 there, and di 0).
template <int D>
__global__ void __launch_bounds__(kThreads) bwd_rows(const Flash p,
                                                      float* lse2, float* di,
                                                      int sq_pad) {
  const int r = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= p.B * sq_pad * p.H) return;
  const int h = r % p.H, s = (r / p.H) % sq_pad, b = r / (p.H * sq_pad);
  const size_t at = ((size_t)b * p.H + h) * sq_pad + s;
  const int lane = threadIdx.x & 31;
  if (s >= p.Sq) {
    if (lane == 0) {
      lse2[at] = INFINITY;
      di[at] = 0.f;
    }
    return;
  }
  const size_t row = ((size_t)b * p.Sq + s) * p.H + h;
  const bf16* o = static_cast<const bf16*>(p.out) + row * D;
  const bf16* g = static_cast<const bf16*>(p.dout) + row * D;
  float part = 0.f;
#pragma unroll
  for (int d = 0; d < D / 32; ++d)
    part += to_f32(o[d * 32 + lane]) * to_f32(g[d * 32 + lane]);
  part = warp_sum(part);
  if (lane == 0) {
    di[at] = part;
    lse2[at] = p.lse[((size_t)b * p.H + h) * p.Sq + s] * kLog2e;
  }
}

// dq_acc: dq's f32 sums, B H sq_pad D floats tiled as below, zeroed by the
// caller; lse2 / di: the pre-pass's rows.
template <int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
    bwd_sm90(const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tdo, const Flash p,
             float* __restrict__ dq_acc, const float* lse2, const float* di,
             int sq_pad) {
  using G = BwdTile<D>;
  constexpr int BK = G::BK, BQ = G::BQ, NS = G::NS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* Ks = sm;                      // [D/64][BK][128 B]
  unsigned char* Vs = Ks + G::K_BYTES;
  unsigned char* Qs = Vs + G::K_BYTES;         // [NS] x Q tile
  unsigned char* dOs = Qs + NS * G::Q_BYTES;   // [NS] x dO tile
  unsigned char* dSs = dOs + NS * G::Q_BYTES;  // [2] x ds^T
  unsigned char* dQs = dSs + 2 * G::DS_BYTES;  // [2 warpgroups] x dq half
  float* rows_s = reinterpret_cast<float*>(dQs + 2 * G::DQ_BYTES);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(rows_s + NS * 2 * BQ);
  uint64_t* q_full = kv_full + 1;
  unsigned* released = reinterpret_cast<unsigned*>(q_full + NS);

  const int k0 = blockIdx.x * BK;  // heavy tiles (small k0) first
  const int h = blockIdx.y, b = blockIdx.z;
  // causal skip: rows before k0 - (Sk - Sq) see none of this tile's keys
  const int q_begin = p.causal ? max(0, k0 - (p.Sk - p.Sq)) : 0;
  const int qt0 = q_begin / BQ;
  const int n_it = max(0, (p.Sq + BQ - 1) / BQ - qt0);
  const size_t row_base = ((size_t)b * p.H + h) * sq_pad;
  // Q, dO, lse and di of q tile it into stage st
  auto load_q = [&](int it, int st) {
    const int r0 = (qt0 + it) * BQ;
    float* rs = rows_s + st * 2 * BQ;
    mbar_expect_tx(q_full + st, 2 * G::Q_BYTES + G::ROW_BYTES);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      tma_load4(Qs + st * G::Q_BYTES + c * BQ * 128, &tq, q_full + st, c * 64,
                h, r0, b);
      tma_load4(dOs + st * G::Q_BYTES + c * BQ * 128, &tdo, q_full + st,
                c * 64, h, r0, b);
    }
    bulk_load(rs, lse2 + row_base + r0, BQ * 4, q_full + st);
    bulk_load(rs + BQ, di + row_base + r0, BQ * 4, q_full + st);
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(q_full + s, 1);
      released[s] = 0;
    }
    mbar_fence_init();
    mbar_expect_tx(kv_full, 2 * G::K_BYTES);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      tma_load4(Ks + c * BK * 128, &tk, kv_full, c * 64, h, k0, b);
      tma_load4(Vs + c * BK * 128, &tv, kv_full, c * 64, h, k0, b);
    }
    for (int it = 0; it < min(NS, n_it); ++it) load_q(it, it);
  }
  __syncthreads();

  // warp-uniform, so that every address and descriptor derived from it
  // stays in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWGThreads, 0);
  const int t = threadIdx.x % kWGThreads, warp = t >> 5, lane = t & 31;
  const int kw0 = k0 + wg * 64;                      // this warpgroup's keys
  const int kl = wg * 64 + warp * 16 + (lane >> 2);  // key in the block
  const int keys[2] = {k0 + kl, k0 + kl + 8};
  const float c = p.scale * kLog2e;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  const uint32_t ka = smem_u32(Ks) + wg * 64 * 128;
  const uint32_t va = smem_u32(Vs) + wg * 64 * 128;
  // this warpgroup's half of D as dq's B operand (MN-major)
  const uint32_t kh = smem_u32(Ks) + (D == 64 ? wg * 64 : wg * BK * 128);
  // this warpgroup's dq half in shared memory, and its place in the f32
  // workspace, tiled as [B, H, sq_pad / 64, 2 halves, 64 D / 2] with each
  // half in accumulator order (float4 j of thread t at 128 j + t)
  float4* dq_s = reinterpret_cast<float4*>(dQs + wg * G::DQ_BYTES);
  float* dq_g = dq_acc + row_base * D + wg * (BQ * D / 2);
  mbar_wait(kv_full, 0);

  for (int it = 0; it < n_it; ++it) {
    const int st = it % NS, ph = (it / NS) & 1;
    const int r0 = (qt0 + it) * BQ;
    const uint32_t qb = smem_u32(Qs + st * G::Q_BYTES);
    const uint32_t dob = smem_u32(dOs + st * G::Q_BYTES);
    const float* lse_s = rows_s + st * 2 * BQ;
    const float* di_s = lse_s + BQ;
    unsigned char* ds_buf = dSs + (it & 1) * G::DS_BYTES;
    float s[BQ / 2], dp[BQ / 2];
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    mbar_wait(q_full + st, ph);

    // s^T = k q^T and dp^T = v do^T: [64 keys, 64 rows]
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<0, 0>(s, desc_k(ka, BK, kk), desc_k(qb, BQ, kk), kk > 0);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<0, 0>(dp, desc_k(va, BK, kk), desc_k(dob, BQ, kk), kk > 0);
    wg_commit();
    wg_wait<1>();
    fence_regs(s);

    // p^T = exp2(s^T c - lse): hidden entries (on tiles that hold one)
    // to -inf first; this thread's rows' lse and di as pairs
    const int cb = (lane & 3) * 2;  // this thread's first row in the tile
    float2 lse_r[BQ / 8], di_r[BQ / 8];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      lse_r[j] = *reinterpret_cast<const float2*>(lse_s + cb + j * 8);
      di_r[j] = *reinterpret_cast<const float2*>(di_s + cb + j * 8);
    }
    if (!tile_visible(p, r0, BQ, kw0, 64)) {
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + cb + j * 8 + (e & 1);
          if (hidden(p, b, row, keys[e >> 1], seg_of(p, b, row)))
            s[4 * j + e] = -INFINITY;
        }
    }
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * j + e] = ex2(fmaf(s[4 * j + e], c,
                                -((e & 1) ? lse_r[j].y : lse_r[j].x)));
    wg_wait<0>();
    fence_regs(dp);
    // ds^T = p^T (dp^T - di) scale; p^T and ds^T rounded to bf16 pairs
    // as they are made (s and dp die pair by pair)
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int x = 8 * kk + 2 * r;
        const float2 di2 = di_r[2 * kk + (r >> 1)];
        pa[kk][r] = pack_bf16(s[x], s[x + 1]);
        da[kk][r] = pack_bf16(s[x] * (dp[x] - di2.x) * p.scale,
                                s[x + 1] * (dp[x + 1] - di2.y) * p.scale);
      }
    // dv += p^T do; dk += ds^T q
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      mma_rs<1>(dv, pa[kk], desc_mn(dob, BQ, kk), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      mma_rs<1>(dk, da[kk], desc_mn(qb, BQ, kk), 1);
    wg_commit();

    // ds^T [128 keys][64 rows] into shared memory in the 128-byte
    // swizzle: rows kl, kl + 8; row pairs cb + 8 j (+ 1)
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = kl + (r & 1) * 8, q = 16 * kk + (r >> 1) * 8 + cb;
        *reinterpret_cast<uint32_t*>(ds_buf + key * 128 +
                                     (((q >> 3) ^ (key & 7)) << 4) +
                                     (q & 7) * 2) = da[kk][r];
      }
    fence_proxy_async();
    __syncthreads();

    // dq_tile[:, half] = ds k[:, half]: ds^T read MN-major as A
    float dq[D / 4];
    const uint32_t dsb = smem_u32(ds_buf);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_ss<1, 1>(dq, desc_mn(dsb, BK, kk), desc_mn(kh, BK, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(dq);
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pa);
    fence_regs(da);
    __syncwarp();
    if (lane == 0 && last_release(released + st) &&
        it + NS < n_it)
      load_q(it + NS, st);

    // add the tile's half into the f32 workspace (rows past Sq are
    // padding): staged in shared memory once the previous tile's add has
    // read it, then one bulk add
    if (t == 0) bulk_wait_read();
    named_sync(1 + wg, kWGThreads);
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      dq_s[j * kWGThreads + t] =
          make_float4(dq[4 * j], dq[4 * j + 1], dq[4 * j + 2], dq[4 * j + 3]);
    fence_proxy_async();
    named_sync(1 + wg, kWGThreads);
    if (t == 0) {
      bulk_reduce_add(dq_g + (size_t)r0 * D, dq_s, G::DQ_BYTES);
      bulk_commit();
    }
  }
  if (t == 0) bulk_wait();

  bf16* dkg = static_cast<bf16*>(p.dk);
  bf16* dvg = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (keys[hh] >= p.Sk) continue;
    const size_t at =
        (((size_t)b * p.Sk + keys[hh]) * p.H + h) * D + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dkg + at + j * 8) =
          __floats2bfloat162_rn(dk[4 * j + 2 * hh], dk[4 * j + 2 * hh + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvg + at + j * 8) =
          __floats2bfloat162_rn(dv[4 * j + 2 * hh], dv[4 * j + 2 * hh + 1]);
    }
  }
}

// dq [B, Sq, H, D] (bf16) from the f32 workspace (tiled as bwd_sm90 adds
// into it); eight values, one row's columns 8 g .. 8 g + 7, a thread.
template <int D>
__global__ void __launch_bounds__(256) dq_convert(const Flash p,
                                                   const float* acc,
                                                   int sq_pad) {
  const size_t i = ((size_t)blockIdx.x * 256 + threadIdx.x) * 8;
  if (i >= (size_t)p.B * p.Sq * p.H * D) return;
  const int col = (int)(i % D);
  const size_t r = i / D;
  const int h = (int)(r % p.H), s = (int)((r / p.H) % p.Sq);
  const int b = (int)(r / ((size_t)p.H * p.Sq));
  // the accumulator fragment of (row s % 64, col): warpgroup col / (D / 2),
  // float4 j = col % (D / 2) / 8 of thread 32 warp + 4 (row % 8) + pair,
  // element 2 (row % 16 / 8) of it, pair by pair over the 8 columns
  const int row = s % 64, w = col / (D / 2), j = col % (D / 2) / 8;
  const float* half = acc + ((size_t)b * p.H + h) * sq_pad * D +
                      (size_t)(s - row) * D + w * (64 * D / 2);
  const int t0 = (row / 16) * 32 + (row % 8) * 4;
  uint32_t v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 x = *reinterpret_cast<const float2*>(
        half + (j * 128 + t0 + q) * 4 + 2 * (row % 16 / 8));
    v[q] = pack_bf16(x.x, x.y);
  }
  *reinterpret_cast<uint4*>(static_cast<bf16*>(p.dq) + i) =
      make_uint4(v[0], v[1], v[2], v[3]);
}

// ------------------------------------------------------------------- f32
template <int D>
__global__ void __launch_bounds__(kThreads) fwd_f32(const Flash p) {
  constexpr int DPL = D / 32;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= p.Sq) return;
  const float* kg = static_cast<const float*>(p.k) + b * p.ks[0] + h * p.ks[2];
  const float* vg = static_cast<const float*>(p.v) + b * p.vs[0] + h * p.vs[2];
  float q[DPL], acc[DPL];
  load_row<D>(q, static_cast<const float*>(p.q) + b * p.qs[0] +
                     row * p.qs[1] + h * p.qs[2]);
#pragma unroll
  for (int d = 0; d < DPL; ++d) acc[d] = 0.f;
  const int seg = seg_of(p, b, row);
  const int kv_end = p.causal ? min(p.Sk, row + p.Sk - p.Sq + 1) : p.Sk;
  float m = kNeg, l = 0.f;
  for (int j = 0; j < kv_end; ++j) {
    if (hidden(p, b, row, j, seg)) continue;  // adds nothing: p = 0
    const float s = dot_row<D>(q, kg + j * p.ks[1]) * p.scale;
    const float mnew = fmaxf(m, s);
    const float alpha = expf(m - mnew), pj = expf(s - mnew);
    l = l * alpha + pj;
    const float* vr = vg + j * p.vs[1];
#pragma unroll
    for (int d = 0; d < DPL; ++d)
      acc[d] = acc[d] * alpha + pj * vr[d * 32 + (threadIdx.x & 31)];
    m = mnew;
  }
  const float lsafe = l == 0.f ? 1.f : l;
  store_row<D>(static_cast<float*>(p.out) +
                   (((size_t)b * p.Sq + row) * p.H + h) * D,
               acc, lsafe);
  if ((threadIdx.x & 31) == 0)
    p.lse[((size_t)b * p.H + h) * p.Sq + row] =
        l == 0.f ? -kNeg : m + logf(lsafe);
}

template <int D>
__global__ void __launch_bounds__(kThreads) dq_f32(const Flash p) {
  constexpr int DPL = D / 32;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= p.Sq) return;
  const float* kg = static_cast<const float*>(p.k) + b * p.ks[0] + h * p.ks[2];
  const float* vg = static_cast<const float*>(p.v) + b * p.vs[0] + h * p.vs[2];
  const size_t at = ((size_t)b * p.H + h) * p.Sq + row;
  const size_t orow = (((size_t)b * p.Sq + row) * p.H + h) * D;
  float q[DPL], dout[DPL], dq[DPL];
  load_row<D>(q, static_cast<const float*>(p.q) + b * p.qs[0] +
                     row * p.qs[1] + h * p.qs[2]);
  load_row<D>(dout, static_cast<const float*>(p.dout) + orow);
#pragma unroll
  for (int d = 0; d < DPL; ++d) dq[d] = 0.f;
  const float lse = p.lse[at], di = p.di[at];
  const int seg = seg_of(p, b, row);
  const int kv_end = p.causal ? min(p.Sk, row + p.Sk - p.Sq + 1) : p.Sk;
  for (int j = 0; j < kv_end; ++j) {
    if (hidden(p, b, row, j, seg)) continue;
    const float* kr = kg + j * p.ks[1];
    const float pj = expf(dot_row<D>(q, kr) * p.scale - lse);
    const float dp = dot_row<D>(dout, vg + j * p.vs[1]);
    const float ds = pj * (dp - di) * p.scale;
#pragma unroll
    for (int d = 0; d < DPL; ++d) dq[d] += ds * kr[d * 32 + (threadIdx.x & 31)];
  }
  store_row<D>(static_cast<float*>(p.dq) + orow, dq, 1.f);
}

template <int D>
__global__ void __launch_bounds__(kThreads) dkv_f32(const Flash p) {
  constexpr int DPL = D / 32;
  const int key = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int h = blockIdx.y, b = blockIdx.z;
  if (key >= p.Sk) return;
  const float* qg = static_cast<const float*>(p.q) + b * p.qs[0] + h * p.qs[2];
  const float* dog = static_cast<const float*>(p.dout) +
                     (size_t)b * p.Sq * p.H * D + (size_t)h * D;
  const size_t row_base = ((size_t)b * p.H + h) * p.Sq;
  float k[DPL], v[DPL], dk[DPL], dv[DPL];
  load_row<D>(k, static_cast<const float*>(p.k) + b * p.ks[0] +
                     key * p.ks[1] + h * p.ks[2]);
  load_row<D>(v, static_cast<const float*>(p.v) + b * p.vs[0] +
                     key * p.vs[1] + h * p.vs[2]);
#pragma unroll
  for (int d = 0; d < DPL; ++d) dk[d] = dv[d] = 0.f;
  const int i0 = p.causal ? max(0, key - (p.Sk - p.Sq)) : 0;
  const int lane = threadIdx.x & 31;
  for (int i = i0; i < p.Sq; ++i) {
    if (hidden(p, b, i, key, seg_of(p, b, i))) continue;
    const float* qr = qg + i * p.qs[1];
    const float* dr = dog + (size_t)i * p.H * D;
    const float pj = expf(dot_row<D>(k, qr) * p.scale - p.lse[row_base + i]);
    const float dp = dot_row<D>(v, dr);
    const float ds = pj * (dp - p.di[row_base + i]) * p.scale;
#pragma unroll
    for (int d = 0; d < DPL; ++d) {
      dv[d] += pj * dr[d * 32 + lane];
      dk[d] += ds * qr[d * 32 + lane];
    }
  }
  const size_t orow = (((size_t)b * p.Sk + key) * p.H + h) * D;
  store_row<D>(static_cast<float*>(p.dk) + orow, dk, 1.f);
  store_row<D>(static_cast<float*>(p.dv) + orow, dv, 1.f);
}

// ------------------------------------------------------------- launchers
template <int D>
static int fwd(const Flash& p, int bf16_in, cudaStream_t st) {
  if (!bf16_in) {
    fwd_f32<D><<<dim3((p.Sq + 3) / 4, p.H, p.B), kThreads, 0, st>>>(p);
    return (int)cudaGetLastError();
  }
  using G = FwdTile<D>;
  if (!(p.scale > 0.f)) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int e = encode_bsh(&tq, p.q, p.B, p.Sq, p.H, D, p.qs, G::BQ);
  if (e == 0) e = encode_bsh(&tk, p.k, p.B, p.Sk, p.H, D, p.ks, G::BKV);
  if (e == 0) e = encode_bsh(&tv, p.v, p.B, p.Sk, p.H, D, p.vs, G::BKV);
  if (e == 0) e = (int)with_smem(fwd_sm90<D>, G::SMEM);
  if (e != 0) return e;
  fwd_sm90<D><<<dim3((p.Sq + G::BQ - 1) / G::BQ, p.H, p.B), kSm90Threads,
                G::SMEM, st>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

template <int D>
static int bwd(const Flash& p, int bf16_in, cudaStream_t st) {
  const int rows = p.B * p.Sq * p.H;
  if (!bf16_in) {
    di_pass<float, D><<<(rows + 3) / 4, kThreads, 0, st>>>(p);
    dq_f32<D><<<dim3((p.Sq + 3) / 4, p.H, p.B), kThreads, 0, st>>>(p);
    dkv_f32<D><<<dim3((p.Sk + 3) / 4, p.H, p.B), kThreads, 0, st>>>(p);
    return (int)cudaGetLastError();
  }
  using G = BwdTile<D>;
  if (!(p.scale > 0.f)) return (int)cudaErrorInvalidValue;
  const int sq_pad = (p.Sq + G::BQ - 1) / G::BQ * G::BQ;
  // the workspace: dq's f32 sums (B H sq_pad D floats, tiled by
  // bwd_sm90), then lse (log2) and di rows [B, H, sq_pad] each
  float* acc = p.di;
  float* lse2 = acc + (size_t)p.B * p.H * sq_pad * D;
  float* di = lse2 + (size_t)p.B * p.H * sq_pad;
  const long long dos[3] = {(long long)p.Sq * p.H * D, (long long)p.H * D,
                            D};
  CUtensorMap tk, tv, tq, tdo;
  int e = encode_bsh(&tk, p.k, p.B, p.Sk, p.H, D, p.ks, G::BK);
  if (e == 0) e = encode_bsh(&tv, p.v, p.B, p.Sk, p.H, D, p.vs, G::BK);
  if (e == 0) e = encode_bsh(&tq, p.q, p.B, p.Sq, p.H, D, p.qs, G::BQ);
  if (e == 0) e = encode_bsh(&tdo, p.dout, p.B, p.Sq, p.H, D, dos, G::BQ);
  if (e == 0) e = (int)with_smem(bwd_sm90<D>, G::SMEM);
  if (e != 0) return e;
  const int pad_rows = p.B * sq_pad * p.H;
  bwd_rows<D><<<(pad_rows + 3) / 4, kThreads, 0, st>>>(p, lse2, di, sq_pad);
  bwd_sm90<D><<<dim3((p.Sk + G::BK - 1) / G::BK, p.H, p.B), kSm90Threads,
                G::SMEM, st>>>(tk, tv, tq, tdo, p, acc, lse2, di, sq_pad);
  const size_t n8 = (size_t)rows * D / 8;
  dq_convert<D><<<(unsigned)((n8 + 255) / 256), 256, 0, st>>>(p, acc,
                                                              sq_pad);
  return (int)cudaGetLastError();
}

static Flash make(const void* q, const void* k, const void* v,
                  const void* seg_q, const void* seg_kv, int B, int H, int Sq,
                  int Sk, const long long* strides, int causal, float scale) {
  Flash p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_kv = static_cast<const int*>(seg_kv);
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.causal = causal;
  p.scale = scale;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
  }
  return p;
}

}  // namespace flash
}  // namespace ptt

using namespace ptt;

extern "C" {

// q [B, Sq, H, D], k/v [B, Sk, H, D] (strides: 9 int64, (batch, seq, head)
// of q, k, v in elements; the last dimension is contiguous); seg_q/seg_kv
// int32 [B, Sq]/[B, Sk] or both null -> out [B, Sq, H, D] contiguous,
// lse f32 [B, H, Sq]
int ptt_flash_fwd(const void* q, const void* k, const void* v,
                  const void* seg_q, const void* seg_kv, void* out, void* lse,
                  int B, int H, int Sq, int Sk, int D, const void* strides,
                  int causal, float scale, int dtype, int device,
                  void* stream) {
  PTT_SET_DEVICE(device);
  if (B == 0 || H == 0 || Sq == 0) return (int)cudaSuccess;
  flash::Flash p = flash::make(q, k, v, seg_q, seg_kv, B, H, Sq, Sk,
                               static_cast<const long long*>(strides), causal,
                               scale);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != kF32 && dtype != kBF16) return (int)cudaErrorInvalidValue;
  if (D == 64) return flash::fwd<64>(p, dtype == kBF16, st);
  if (D == 128) return flash::fwd<128>(p, dtype == kBF16, st);
  if (D == 192) return flash::fwd<192>(p, dtype == kBF16, st);
  return (int)cudaErrorInvalidValue;
}

// The backward: out/dout [B, Sq, H, D] contiguous, lse f32 [B, H, Sq] from
// the forward, di an f32 workspace -> dq [B, Sq, H, D], dk/dv [B, Sk, H, D]
// contiguous. The workspace holds di [B, H, Sq] (f32 inputs; kernels di,
// dq, dkv), or, with sq_pad = Sq rounded up to 64, dq's f32 sums
// (B H sq_pad D floats), zeroed by the caller, then lse and di rows
// [B, H, sq_pad] each (bf16 inputs; kernels: the rows' pre-pass, the
// fused backward, dq's conversion).
int ptt_flash_bwd(const void* q, const void* k, const void* v,
                  const void* seg_q, const void* seg_kv, const void* out,
                  const void* dout, const void* lse, void* di, void* dq,
                  void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
                  const void* strides, int causal, float scale, int dtype,
                  int device, void* stream) {
  PTT_SET_DEVICE(device);
  if (B == 0 || H == 0 || Sq == 0 || Sk == 0) return (int)cudaSuccess;
  flash::Flash p = flash::make(q, k, v, seg_q, seg_kv, B, H, Sq, Sk,
                               static_cast<const long long*>(strides), causal,
                               scale);
  p.out = const_cast<void*>(out);
  p.dout = dout;
  p.lse = static_cast<float*>(const_cast<void*>(lse));
  p.di = static_cast<float*>(di);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != kF32 && dtype != kBF16) return (int)cudaErrorInvalidValue;
  if (D == 64) return flash::bwd<64>(p, dtype == kBF16, st);
  if (D == 128) return flash::bwd<128>(p, dtype == kBF16, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
