// flashmask_sdpa (forward, dq, dkv) for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas_flashmask.py:flashmask_sdpa (Pallas
//           _fwd_kernel, _bwd_dq_kernel, _bwd_dkv_kernel and the custom VJP
//           around them).
//
// Bound on the H100: the bytes or the products over the VISIBLE (row, key)
// pairs, whichever the mask leaves larger. The forward does 2 products
// (q k^T, p v) over them, the gradient 5; q, k, v and o are read or written
// once. A packed SFT batch at Llama-3-8B's attention width (B 1, S 8192,
// 32 heads x 128, bf16, causal, ~8 documents of ~1 K tokens) leaves ~4 M
// pairs a head against causal's 33.5 M: the forward's 2 products are
// 6.9e10 FLOP (0.07 ms at 989 TFLOP/s) against 268 MB of q, k, v and o
// (0.08 ms at 3.35 TB/s), so it is bound by bytes; a mask that skips little
// is bound by the products, as flash is.
//
// What it computes (pallas_flashmask.py:112-260): inputs [B, S, H, D], read
// with their batch / sequence / head strides; s = (q . k) * scale in f32.
// Every startend encoding arrives in the band normal form: per (batch, mask
// head, key column) two row bands (s1, e1, s2, e2), int32 [B, Hm, Sk, 4],
// Hm 1 (broadcast over the heads) or H. Key j is hidden from row i when i
// lies in [s1[j], e1[j]) or [s2[j], e2[j]), when causal and j > i (TOP-LEFT
// aligned, as the reference kernel masks, unlike flash's bottom-right), or
// past the ragged edge. Hidden scores are -1e30, never -inf. The forward is
// an online softmax writing o and an f32 lse [B, H, Sq]; a row that sees no
// key gets o = 0 and lse = +1e30, so the backward's exp(s - lse) is 0, not
// NaN. The backward takes di = sum(do * o) (flash's pre-pass), then dq (a
// block per q tile walks the k tiles) and dkv (a block per k tile walks the
// q tiles): ds = p (dp - di) scale, dv += p^T do, dk += ds^T q, dq += ds k,
// no atomics.
//
// Design. The tiles, loads and products are flash's (flash_tiles.cuh: 64-row
// q tiles of 4 warps, 64-key K / V tiles through a cp.async double buffer,
// mma.sync m16n8k16 bf16 -> f32 with p and ds rounded to bf16 before their
// products; the f32 scalar path a warp per row). What FlashMask adds is
// the skip: a pre-pass (`tile_stats`, a warp per 64-key tile) reduces each
// tile's bands to (max s1, min e1, max s2, min e2) and (min s1, max e1,
// min s2, max e2), and every kernel derives a tile's kind from those eight
// numbers before it loads anything: 0 when one band covers every row of
// the q tile for every key of the tile, or causal puts the tile above the
// diagonal (the reference's block map, at Hopper's tiles); 2 when no band
// meets the q rows, the tile is not cut by the diagonal or a ragged edge
// (the mask is not evaluated); else 1 (the exact predicate per entry). A
// block walks only the tiles of kind > 0, prefetching the next live one,
// so a skipped tile costs eight integer compares. The bands of a K tile
// are staged beside it in shared memory (64 x 16 bytes a stage); in dkv
// each thread keeps its two keys' bands in registers. head_dim 64 or 128;
// above 128 (which the TPU kernel takes at multiples of 128) the dq and dkv
// accumulators outgrow the registers (ROADMAP.md queue A, A2b).

#include "flash_tiles.cuh"

namespace ptt {
namespace flashmask {

using flash::BKV;
using flash::BQ;
using flash::BQ2;
using flash::bf16;
using flash::Flash;
using flash::Geo;
using flash::kNeg;
using flash::kThreads;

constexpr int kIntMin = -2147483647 - 1, kIntMax = 2147483647;
enum Kind : int { kSkip = 0, kMasked = 1, kVisible = 2 };

struct Mask {
  Flash f;            // tensors, shapes, causal, scale, strides (no segments)
  const int4* bands;  // [B, Hm, Sk]: (s1, e1, s2, e2) of each key column
  int4* stats;        // [B, Hm, nk, 2]: a BKV-key tile's (max s1, min e1,
                      // max s2, min e2), (min s1, max e1, min s2, max e2)
  int Hm, nk;
};

__device__ __forceinline__ const int4* bands_of(const Mask& p, int b, int h) {
  return p.bands + ((size_t)b * p.Hm + (p.Hm == 1 ? 0 : h)) * p.f.Sk;
}
__device__ __forceinline__ const int4* stats_of(const Mask& p, int b, int h) {
  return p.stats + ((size_t)b * p.Hm + (p.Hm == 1 ? 0 : h)) * p.nk * 2;
}

// The kind of k tile `kt` for q rows [r0, r0 + nr) (rows past Sq do not
// count): kSkip, kMasked or kVisible (see the design note).
__device__ __forceinline__ int tile_kind(const Mask& p, const int4* st, int kt,
                                         int r0, int nr) {
  const int r1 = min(r0 + nr, p.f.Sq), k0 = kt * BKV;
  if (p.f.causal && r1 <= k0) return kSkip;
  const int4 hi = __ldg(st + 2 * kt), lo = __ldg(st + 2 * kt + 1);
  if ((hi.x <= r0 && hi.y >= r1) || (hi.z <= r0 && hi.w >= r1)) return kSkip;
  const bool clear = (lo.y <= r0 || lo.x >= r1) && (lo.w <= r0 || lo.z >= r1);
  const bool inside = k0 + BKV <= p.f.Sk && r0 + nr <= p.f.Sq;
  const bool below = !p.f.causal || k0 + BKV - 1 <= r0;
  return clear && inside && below ? kVisible : kMasked;
}

// Is key `col` (bands `bd`) hidden from q row `row`?
__device__ __forceinline__ bool hidden(const Mask& p, int row, int col,
                                       int4 bd) {
  if (col >= p.f.Sk || row >= p.f.Sq) return true;
  if (p.f.causal && col > row) return true;
  return (row >= bd.x && row < bd.y) || (row >= bd.z && row < bd.w);
}

// The pre-pass: a warp per (b, hm, k tile) reduces its columns' bands.
__global__ void __launch_bounds__(kThreads) tile_stats(const Mask p) {
  const int t = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (t >= p.f.B * p.Hm * p.nk) return;
  const int kt = t % p.nk, lane = threadIdx.x & 31;
  const int4* bands = p.bands + (size_t)(t / p.nk) * p.f.Sk;
  int4 hi = make_int4(kIntMin, kIntMax, kIntMin, kIntMax);
  int4 lo = make_int4(kIntMax, kIntMin, kIntMax, kIntMin);
  const int c1 = min((kt + 1) * BKV, p.f.Sk);
  for (int c = kt * BKV + lane; c < c1; c += 32) {
    const int4 v = bands[c];
    hi = make_int4(max(hi.x, v.x), min(hi.y, v.y), max(hi.z, v.z),
                   min(hi.w, v.w));
    lo = make_int4(min(lo.x, v.x), max(lo.y, v.y), min(lo.z, v.z),
                   max(lo.w, v.w));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    hi.x = max(hi.x, __shfl_xor_sync(0xffffffffu, hi.x, o));
    hi.y = min(hi.y, __shfl_xor_sync(0xffffffffu, hi.y, o));
    hi.z = max(hi.z, __shfl_xor_sync(0xffffffffu, hi.z, o));
    hi.w = min(hi.w, __shfl_xor_sync(0xffffffffu, hi.w, o));
    lo.x = min(lo.x, __shfl_xor_sync(0xffffffffu, lo.x, o));
    lo.y = max(lo.y, __shfl_xor_sync(0xffffffffu, lo.y, o));
    lo.z = min(lo.z, __shfl_xor_sync(0xffffffffu, lo.z, o));
    lo.w = max(lo.w, __shfl_xor_sync(0xffffffffu, lo.w, o));
  }
  if (lane == 0) {
    p.stats[2 * t] = hi;
    p.stats[2 * t + 1] = lo;
  }
}

// ------------------------------------------------------------------ bf16
// The bands of keys [col0, col0 + BKV) into dst [BKV] (past Sk: zeros,
// hidden by the edge test).
__device__ __forceinline__ void load_bands(int4* dst, const int4* src,
                                           int col0, int Sk) {
  for (int c = threadIdx.x; c < BKV; c += kThreads) {
    const bool ok = col0 + c < Sk;
    cp_async16(dst + c, ok ? src + col0 + c : src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) fwd_bf16(const Mask p) {
  using namespace flash;
  constexpr int LD = Geo<D>::LD, DT = Geo<D>::DT, NT = BKV / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);               // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                                // [2][BKV][LD]
  bf16* Vs = Ks + 2 * BKV * LD;                           // [2][BKV][LD]
  int4* Bs = reinterpret_cast<int4*>(Vs + 2 * BKV * LD);  // [2][BKV]
  const Flash& f = p.f;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* qg = static_cast<const bf16*>(f.q) + b * f.qs[0] + h * f.qs[2];
  const bf16* kg = static_cast<const bf16*>(f.k) + b * f.ks[0] + h * f.ks[2];
  const bf16* vg = static_cast<const bf16*>(f.v) + b * f.vs[0] + h * f.vs[2];
  const int4* bands = bands_of(p, b, h);
  const int4* st = stats_of(p, b, h);
  // causal (top-left): keys past the tile's last row are hidden
  const int kv_end = f.causal ? min(f.Sk, q0 + BQ) : f.Sk;
  const int n_kt = (kv_end + BKV - 1) / BKV;
  auto live = [&](int kt) {  // the first tile at or after kt not skipped
    while (kt < n_kt && tile_kind(p, st, kt, q0, BQ) == kSkip) ++kt;
    return kt;
  };
  auto load_kv = [&](int kt, int s) {
    load_tile<D, BKV>(Ks + s * BKV * LD, kg, f.ks[1], kt * BKV, f.Sk);
    load_tile<D, BKV>(Vs + s * BKV * LD, vg, f.vs[1], kt * BKV, f.Sk);
    load_bands(Bs + s * BKV, bands, kt * BKV, f.Sk);
  };

  int kt = live(0);
  load_tile<D, BQ>(Qs, qg, f.qs[1], q0, f.Sq);
  if (kt < n_kt) load_kv(kt, 0);
  cp_async_commit();

  const int rows[2] = {q0 + warp * 16 + (lane >> 2),
                       q0 + warp * 16 + (lane >> 2) + 8};
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int s = 0; kt < n_kt; s ^= 1) {
    const int kn = live(kt + 1);
    if (kn < n_kt) {
      load_kv(kn, s ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float sc[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
    mma_nt<NT, D, LD>(sc, Qs + warp * 16 * LD, Ks + s * BKV * LD);

    const bool masked = tile_kind(p, st, kt, q0, BQ) != kVisible;
    const int4* bt = Bs + s * BKV;
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1, c = nt * 8 + (lane & 3) * 2 + (e & 1);
        float x = sc[nt][e] * f.scale;
        if (masked && hidden(p, rows[hh], kt * BKV + c, bt[c])) x = kNeg;
        sc[nt][e] = x;
        mx[hh] = fmaxf(mx[hh], x);
      }
    float mnew[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mnew[hh] = fmaxf(m[hh], quad_max(mx[hh]));
      alpha[hh] = __expf(m[hh] - mnew[hh]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        // a hidden score is exactly kNeg (no real score is): p = 0, also
        // while every score of the row so far is hidden (mnew == kNeg)
        const float pv =
            sc[nt][e] == kNeg ? 0.f : __expf(sc[nt][e] - mnew[hh]);
        sc[nt][e] = pv;
        rs[hh] += pv;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] = l[hh] * alpha[hh] + quad_sum(rs[hh]);
      m[hh] = mnew[hh];
    }
#pragma unroll
    for (int i = 0; i < DT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha[e >> 1];
    mma_pv<DT, BKV, LD>(acc, sc, Vs + s * BKV * LD);
    __syncthreads();  // this stage is refilled two live tiles on
    kt = kn;
  }
  cp_async_wait<0>();

  const float lsafe[2] = {l[0] == 0.f ? 1.f : l[0], l[1] == 0.f ? 1.f : l[1]};
  store_rows<D>(static_cast<bf16*>(f.out), acc, b, h, f.H, f.Sq,
                q0 + warp * 16, lsafe);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (rows[hh] < f.Sq)
        f.lse[((size_t)b * f.H + h) * f.Sq + rows[hh]] =
            l[hh] == 0.f ? -kNeg : m[hh] + logf(lsafe[hh]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) dq_bf16(const Mask p) {
  using namespace flash;
  constexpr int LD = Geo<D>::LD, DT = Geo<D>::DT, NT = BKV / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);               // [BQ][LD]
  bf16* dOs = Qs + BQ * LD;                               // [BQ][LD]
  bf16* Ks = dOs + BQ * LD;                               // [2][BKV][LD]
  bf16* Vs = Ks + 2 * BKV * LD;                           // [2][BKV][LD]
  int4* Bs = reinterpret_cast<int4*>(Vs + 2 * BKV * LD);  // [2][BKV]
  const Flash& f = p.f;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* qg = static_cast<const bf16*>(f.q) + b * f.qs[0] + h * f.qs[2];
  const bf16* kg = static_cast<const bf16*>(f.k) + b * f.ks[0] + h * f.ks[2];
  const bf16* vg = static_cast<const bf16*>(f.v) + b * f.vs[0] + h * f.vs[2];
  const long long ds_row = (long long)f.H * D;
  const bf16* dog = static_cast<const bf16*>(f.dout) +
                    (long long)b * f.Sq * ds_row + (long long)h * D;
  const int4* bands = bands_of(p, b, h);
  const int4* st = stats_of(p, b, h);
  const int kv_end = f.causal ? min(f.Sk, q0 + BQ) : f.Sk;
  const int n_kt = (kv_end + BKV - 1) / BKV;
  auto live = [&](int kt) {
    while (kt < n_kt && tile_kind(p, st, kt, q0, BQ) == kSkip) ++kt;
    return kt;
  };
  auto load_kv = [&](int kt, int s) {
    load_tile<D, BKV>(Ks + s * BKV * LD, kg, f.ks[1], kt * BKV, f.Sk);
    load_tile<D, BKV>(Vs + s * BKV * LD, vg, f.vs[1], kt * BKV, f.Sk);
    load_bands(Bs + s * BKV, bands, kt * BKV, f.Sk);
  };

  int kt = live(0);
  load_tile<D, BQ>(Qs, qg, f.qs[1], q0, f.Sq);
  load_tile<D, BQ>(dOs, dog, ds_row, q0, f.Sq);
  if (kt < n_kt) load_kv(kt, 0);
  cp_async_commit();

  const int rows[2] = {q0 + warp * 16 + (lane >> 2),
                       q0 + warp * 16 + (lane >> 2) + 8};
  float lse[2], di[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const size_t at = ((size_t)b * f.H + h) * f.Sq + rows[hh];
    lse[hh] = rows[hh] < f.Sq ? f.lse[at] : -kNeg;
    di[hh] = rows[hh] < f.Sq ? f.di[at] : 0.f;
  }
  float dq[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;

  for (int s = 0; kt < n_kt; s ^= 1) {
    const int kn = live(kt + 1);
    if (kn < n_kt) {
      load_kv(kn, s ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = dp[i][e] = 0.f;
    mma_nt<NT, D, LD>(sc, Qs + warp * 16 * LD, Ks + s * BKV * LD);
    mma_nt<NT, D, LD>(dp, dOs + warp * 16 * LD, Vs + s * BKV * LD);

    const bool masked = tile_kind(p, st, kt, q0, BQ) != kVisible;
    const int4* bt = Bs + s * BKV;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1, c = nt * 8 + (lane & 3) * 2 + (e & 1);
        const float pv =
            masked && hidden(p, rows[hh], kt * BKV + c, bt[c])
                ? 0.f
                : __expf(sc[nt][e] * f.scale - lse[hh]);
        sc[nt][e] = pv * (dp[nt][e] - di[hh]) * f.scale;  // ds
      }
    mma_pv<DT, BKV, LD>(dq, sc, Ks + s * BKV * LD);
    __syncthreads();
    kt = kn;
  }
  cp_async_wait<0>();
  const float one[2] = {1.f, 1.f};
  store_rows<D>(static_cast<bf16*>(f.dq), dq, b, h, f.H, f.Sq,
                q0 + warp * 16, one);
}

template <int D>
__global__ void __launch_bounds__(kThreads) dkv_bf16(const Mask p) {
  using namespace flash;
  constexpr int LD = Geo<D>::LD, DT = Geo<D>::DT, NT = BQ2 / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [BKV][LD]
  bf16* Vs = Ks + BKV * LD;                  // [BKV][LD]
  bf16* Qs = Vs + BKV * LD;                  // [2][BQ2][LD]
  bf16* dOs = Qs + 2 * BQ2 * LD;             // [2][BQ2][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ2 * LD);  // [2][BQ2]
  float* di_s = lse_s + 2 * BQ2;                                // [2][BQ2]
  const Flash& f = p.f;
  const int kt = blockIdx.x, k0 = kt * BKV;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* qg = static_cast<const bf16*>(f.q) + b * f.qs[0] + h * f.qs[2];
  const bf16* kg = static_cast<const bf16*>(f.k) + b * f.ks[0] + h * f.ks[2];
  const bf16* vg = static_cast<const bf16*>(f.v) + b * f.vs[0] + h * f.vs[2];
  const long long ds_row = (long long)f.H * D;
  const bf16* dog = static_cast<const bf16*>(f.dout) +
                    (long long)b * f.Sq * ds_row + (long long)h * D;
  const size_t row_base = ((size_t)b * f.H + h) * f.Sq;
  const int4* bands = bands_of(p, b, h);
  const int4* st = stats_of(p, b, h);
  // causal (top-left): rows before k0 see none of this tile's keys
  const int n_qt = (f.Sq + BQ2 - 1) / BQ2;
  auto live = [&](int qt) {
    while (qt < n_qt && tile_kind(p, st, kt, qt * BQ2, BQ2) == kSkip) ++qt;
    return qt;
  };
  auto load_q = [&](int qt, int s) {
    const int r0 = qt * BQ2;
    load_tile<D, BQ2>(Qs + s * BQ2 * LD, qg, f.qs[1], r0, f.Sq);
    load_tile<D, BQ2>(dOs + s * BQ2 * LD, dog, ds_row, r0, f.Sq);
    if (threadIdx.x < BQ2) {
      const int r = r0 + threadIdx.x;
      lse_s[s * BQ2 + threadIdx.x] = r < f.Sq ? f.lse[row_base + r] : -kNeg;
      di_s[s * BQ2 + threadIdx.x] = r < f.Sq ? f.di[row_base + r] : 0.f;
    }
  };
  int qt = live(f.causal ? k0 / BQ2 : 0);
  load_tile<D, BKV>(Ks, kg, f.ks[1], k0, f.Sk);
  load_tile<D, BKV>(Vs, vg, f.vs[1], k0, f.Sk);
  if (qt < n_qt) load_q(qt, 0);
  cp_async_commit();

  const int keys[2] = {k0 + warp * 16 + (lane >> 2),
                       k0 + warp * 16 + (lane >> 2) + 8};
  const int4 kb[2] = {
      keys[0] < f.Sk ? bands[keys[0]] : make_int4(0, 0, 0, 0),
      keys[1] < f.Sk ? bands[keys[1]] : make_int4(0, 0, 0, 0)};
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int s = 0; qt < n_qt; s ^= 1) {
    const int qn = live(qt + 1);
    if (qn < n_qt) {
      load_q(qn, s ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + s * BQ2 * LD;
    const bf16* dOt = dOs + s * BQ2 * LD;

    // s^T = k q^T: this warp's 16 keys by the tile's BQ2 q rows
    float sc[NT][4], dpt[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = dpt[i][e] = 0.f;
    mma_nt<NT, D, LD>(sc, Ks + warp * 16 * LD, Qt);
    const int r0 = qt * BQ2;
    const bool masked = tile_kind(p, st, kt, r0, BQ2) != kVisible;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + (lane & 3) * 2 + (e & 1);  // q row in tile
        const float pv =
            masked && hidden(p, r0 + c, keys[e >> 1], kb[e >> 1])
                ? 0.f
                : __expf(sc[nt][e] * f.scale - lse_s[s * BQ2 + c]);
        sc[nt][e] = pv;
      }
    mma_pv<DT, BQ2, LD>(dv, sc, dOt);                  // dv += p^T do
    mma_nt<NT, D, LD>(dpt, Vs + warp * 16 * LD, dOt);  // dp^T = v do^T
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + (lane & 3) * 2 + (e & 1);
        sc[nt][e] = sc[nt][e] * (dpt[nt][e] - di_s[s * BQ2 + c]) * f.scale;
      }
    mma_pv<DT, BQ2, LD>(dk, sc, Qt);  // dk += ds^T q
    __syncthreads();
    qt = qn;
  }
  cp_async_wait<0>();
  const float one[2] = {1.f, 1.f};
  store_rows<D>(static_cast<bf16*>(f.dk), dk, b, h, f.H, f.Sk,
                k0 + warp * 16, one);
  store_rows<D>(static_cast<bf16*>(f.dv), dv, b, h, f.H, f.Sk,
                k0 + warp * 16, one);
}

template <int D>
constexpr size_t fwd_smem() {
  return (size_t)(BQ + 4 * BKV) * Geo<D>::LD * sizeof(bf16) +
         2 * BKV * sizeof(int4);
}
template <int D>
constexpr size_t dq_smem() {
  return (size_t)(2 * BQ + 4 * BKV) * Geo<D>::LD * sizeof(bf16) +
         2 * BKV * sizeof(int4);
}
template <int D>
constexpr size_t dkv_smem() {
  return (size_t)(2 * BKV + 4 * BQ2) * Geo<D>::LD * sizeof(bf16) +
         4 * BQ2 * sizeof(float);
}

// ------------------------------------------------------------------- f32
// A warp per row (per key in dkv), as flash's f32 path; a k tile (q tile in
// dkv) of kind 0 is passed over whole.
template <int D>
__global__ void __launch_bounds__(kThreads) fwd_f32(const Mask p) {
  using namespace flash;
  constexpr int DPL = D / 32;
  const Flash& f = p.f;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= f.Sq) return;
  const float* kg = static_cast<const float*>(f.k) + b * f.ks[0] + h * f.ks[2];
  const float* vg = static_cast<const float*>(f.v) + b * f.vs[0] + h * f.vs[2];
  const int4* bands = bands_of(p, b, h);
  const int4* st = stats_of(p, b, h);
  float q[DPL], acc[DPL];
  load_row<D>(q, static_cast<const float*>(f.q) + b * f.qs[0] +
                     row * f.qs[1] + h * f.qs[2]);
#pragma unroll
  for (int d = 0; d < DPL; ++d) acc[d] = 0.f;
  const int kv_end = f.causal ? min(f.Sk, row + 1) : f.Sk;
  float m = kNeg, l = 0.f;
  for (int kt = 0; kt * BKV < kv_end; ++kt) {
    if (tile_kind(p, st, kt, row, 1) == kSkip) continue;
    const int j1 = min(kv_end, (kt + 1) * BKV);
    for (int j = kt * BKV; j < j1; ++j) {
      if (hidden(p, row, j, bands[j])) continue;  // adds nothing: p = 0
      const float s = dot_row<D>(q, kg + j * f.ks[1]) * f.scale;
      const float mnew = fmaxf(m, s);
      const float alpha = expf(m - mnew), pj = expf(s - mnew);
      l = l * alpha + pj;
      const float* vr = vg + j * f.vs[1];
#pragma unroll
      for (int d = 0; d < DPL; ++d)
        acc[d] = acc[d] * alpha + pj * vr[d * 32 + (threadIdx.x & 31)];
      m = mnew;
    }
  }
  const float lsafe = l == 0.f ? 1.f : l;
  store_row<D>(static_cast<float*>(f.out) +
                   (((size_t)b * f.Sq + row) * f.H + h) * D,
               acc, lsafe);
  if ((threadIdx.x & 31) == 0)
    f.lse[((size_t)b * f.H + h) * f.Sq + row] =
        l == 0.f ? -kNeg : m + logf(lsafe);
}

template <int D>
__global__ void __launch_bounds__(kThreads) dq_f32(const Mask p) {
  using namespace flash;
  constexpr int DPL = D / 32;
  const Flash& f = p.f;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= f.Sq) return;
  const float* kg = static_cast<const float*>(f.k) + b * f.ks[0] + h * f.ks[2];
  const float* vg = static_cast<const float*>(f.v) + b * f.vs[0] + h * f.vs[2];
  const int4* bands = bands_of(p, b, h);
  const int4* st = stats_of(p, b, h);
  const size_t at = ((size_t)b * f.H + h) * f.Sq + row;
  const size_t orow = (((size_t)b * f.Sq + row) * f.H + h) * D;
  float q[DPL], dout[DPL], dq[DPL];
  load_row<D>(q, static_cast<const float*>(f.q) + b * f.qs[0] +
                     row * f.qs[1] + h * f.qs[2]);
  load_row<D>(dout, static_cast<const float*>(f.dout) + orow);
#pragma unroll
  for (int d = 0; d < DPL; ++d) dq[d] = 0.f;
  const float lse = f.lse[at], di = f.di[at];
  const int kv_end = f.causal ? min(f.Sk, row + 1) : f.Sk;
  for (int kt = 0; kt * BKV < kv_end; ++kt) {
    if (tile_kind(p, st, kt, row, 1) == kSkip) continue;
    const int j1 = min(kv_end, (kt + 1) * BKV);
    for (int j = kt * BKV; j < j1; ++j) {
      if (hidden(p, row, j, bands[j])) continue;
      const float* kr = kg + j * f.ks[1];
      const float pj = expf(dot_row<D>(q, kr) * f.scale - lse);
      const float dp = dot_row<D>(dout, vg + j * f.vs[1]);
      const float ds = pj * (dp - di) * f.scale;
#pragma unroll
      for (int d = 0; d < DPL; ++d)
        dq[d] += ds * kr[d * 32 + (threadIdx.x & 31)];
    }
  }
  store_row<D>(static_cast<float*>(f.dq) + orow, dq, 1.f);
}

template <int D>
__global__ void __launch_bounds__(kThreads) dkv_f32(const Mask p) {
  using namespace flash;
  constexpr int DPL = D / 32;
  const Flash& f = p.f;
  const int key = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int h = blockIdx.y, b = blockIdx.z;
  if (key >= f.Sk) return;
  const float* qg = static_cast<const float*>(f.q) + b * f.qs[0] + h * f.qs[2];
  const float* dog = static_cast<const float*>(f.dout) +
                     (size_t)b * f.Sq * f.H * D + (size_t)h * D;
  const size_t row_base = ((size_t)b * f.H + h) * f.Sq;
  const int4* st = stats_of(p, b, h);
  const int4 bd = bands_of(p, b, h)[key];
  float k[DPL], v[DPL], dk[DPL], dv[DPL];
  load_row<D>(k, static_cast<const float*>(f.k) + b * f.ks[0] +
                     key * f.ks[1] + h * f.ks[2]);
  load_row<D>(v, static_cast<const float*>(f.v) + b * f.vs[0] +
                     key * f.vs[1] + h * f.vs[2]);
#pragma unroll
  for (int d = 0; d < DPL; ++d) dk[d] = dv[d] = 0.f;
  const int i0 = f.causal ? key : 0, kt = key / BKV;
  const int lane = threadIdx.x & 31;
  for (int r0 = i0 / BQ * BQ; r0 < f.Sq; r0 += BQ) {
    if (tile_kind(p, st, kt, r0, BQ) == kSkip) continue;
    const int i1 = min(f.Sq, r0 + BQ);
    for (int i = max(r0, i0); i < i1; ++i) {
      if (hidden(p, i, key, bd)) continue;
      const float* qr = qg + i * f.qs[1];
      const float* dr = dog + (size_t)i * f.H * D;
      const float pj =
          expf(dot_row<D>(k, qr) * f.scale - f.lse[row_base + i]);
      const float dp = dot_row<D>(v, dr);
      const float ds = pj * (dp - f.di[row_base + i]) * f.scale;
#pragma unroll
      for (int d = 0; d < DPL; ++d) {
        dv[d] += pj * dr[d * 32 + lane];
        dk[d] += ds * qr[d * 32 + lane];
      }
    }
  }
  const size_t orow = (((size_t)b * f.Sk + key) * f.H + h) * D;
  store_row<D>(static_cast<float*>(f.dk) + orow, dk, 1.f);
  store_row<D>(static_cast<float*>(f.dv) + orow, dv, 1.f);
}

// ------------------------------------------------------------- launchers
static void stats(const Mask& p, cudaStream_t st) {
  const int tiles = p.f.B * p.Hm * p.nk;
  tile_stats<<<(tiles + 3) / 4, kThreads, 0, st>>>(p);
}

template <int D>
static int fwd(const Mask& p, int bf16_in, cudaStream_t st) {
  stats(p, st);
  const Flash& f = p.f;
  if (bf16_in) {
    const size_t smem = fwd_smem<D>();
    cudaError_t e = flash::with_smem(fwd_bf16<D>, smem);
    if (e != cudaSuccess) return (int)e;
    fwd_bf16<D><<<dim3((f.Sq + BQ - 1) / BQ, f.H, f.B), kThreads, smem, st>>>(
        p);
  } else {
    fwd_f32<D><<<dim3((f.Sq + 3) / 4, f.H, f.B), kThreads, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}

template <int D>
static int bwd(const Mask& p, int bf16_in, cudaStream_t st) {
  stats(p, st);
  const Flash& f = p.f;
  const int rows = f.B * f.Sq * f.H;
  if (bf16_in) {
    flash::di_pass<bf16, D><<<(rows + 3) / 4, kThreads, 0, st>>>(f);
    cudaError_t e = flash::with_smem(dq_bf16<D>, dq_smem<D>());
    if (e == cudaSuccess) e = flash::with_smem(dkv_bf16<D>, dkv_smem<D>());
    if (e != cudaSuccess) return (int)e;
    dq_bf16<D><<<dim3((f.Sq + BQ - 1) / BQ, f.H, f.B), kThreads, dq_smem<D>(),
                 st>>>(p);
    dkv_bf16<D><<<dim3(p.nk, f.H, f.B), kThreads, dkv_smem<D>(), st>>>(p);
  } else {
    flash::di_pass<float, D><<<(rows + 3) / 4, kThreads, 0, st>>>(f);
    dq_f32<D><<<dim3((f.Sq + 3) / 4, f.H, f.B), kThreads, 0, st>>>(p);
    dkv_f32<D><<<dim3((f.Sk + 3) / 4, f.H, f.B), kThreads, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}

static Mask make(const void* q, const void* k, const void* v,
                 const void* bands, void* stats, int B, int H, int Hm, int Sq,
                 int Sk, const long long* strides, int causal, float scale) {
  Mask p{};
  p.f.q = q;
  p.f.k = k;
  p.f.v = v;
  p.f.B = B;
  p.f.H = H;
  p.f.Sq = Sq;
  p.f.Sk = Sk;
  p.f.causal = causal;
  p.f.scale = scale;
  for (int i = 0; i < 3; ++i) {
    p.f.qs[i] = strides[i];
    p.f.ks[i] = strides[3 + i];
    p.f.vs[i] = strides[6 + i];
  }
  p.bands = static_cast<const int4*>(bands);
  p.stats = static_cast<int4*>(stats);
  p.Hm = Hm;
  p.nk = (Sk + BKV - 1) / BKV;
  return p;
}

}  // namespace flashmask
}  // namespace ptt

using namespace ptt;

extern "C" {

// q [B, Sq, H, D], k/v [B, Sk, H, D] (strides: 9 int64, (batch, seq, head)
// of q, k, v in elements; the last dimension is contiguous); bands int32
// [B, Hm, Sk, 4] contiguous; stats an int32 [B, Hm, ceil(Sk / 64), 8]
// workspace -> out [B, Sq, H, D] contiguous, lse f32 [B, H, Sq]. Two CUDA
// kernels: the tile pre-pass, the forward.
int ptt_flashmask_fwd(const void* q, const void* k, const void* v,
                      const void* bands, void* stats, void* out, void* lse,
                      int B, int H, int Hm, int Sq, int Sk, int D,
                      const void* strides, int causal, float scale, int dtype,
                      int device, void* stream) {
  PTT_SET_DEVICE(device);
  if (B == 0 || H == 0 || Sq == 0 || Sk == 0) return (int)cudaSuccess;
  flashmask::Mask p = flashmask::make(
      q, k, v, bands, stats, B, H, Hm, Sq, Sk,
      static_cast<const long long*>(strides), causal, scale);
  p.f.out = out;
  p.f.lse = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != kF32 && dtype != kBF16) return (int)cudaErrorInvalidValue;
  if (D == 64) return flashmask::fwd<64>(p, dtype == kBF16, st);
  if (D == 128) return flashmask::fwd<128>(p, dtype == kBF16, st);
  return (int)cudaErrorInvalidValue;
}

// The backward: out/dout [B, Sq, H, D] contiguous, lse f32 [B, H, Sq] from
// the forward, di an f32 [B, H, Sq] workspace -> dq [B, Sq, H, D], dk/dv
// [B, Sk, H, D] contiguous. Four CUDA kernels: the tile pre-pass, di, dq,
// dkv.
int ptt_flashmask_bwd(const void* q, const void* k, const void* v,
                      const void* bands, void* stats, const void* out,
                      const void* dout, const void* lse, void* di, void* dq,
                      void* dk, void* dv, int B, int H, int Hm, int Sq, int Sk,
                      int D, const void* strides, int causal, float scale,
                      int dtype, int device, void* stream) {
  PTT_SET_DEVICE(device);
  if (B == 0 || H == 0 || Sq == 0 || Sk == 0) return (int)cudaSuccess;
  flashmask::Mask p = flashmask::make(
      q, k, v, bands, stats, B, H, Hm, Sq, Sk,
      static_cast<const long long*>(strides), causal, scale);
  p.f.out = const_cast<void*>(out);
  p.f.dout = dout;
  p.f.lse = static_cast<float*>(const_cast<void*>(lse));
  p.f.di = static_cast<float*>(di);
  p.f.dq = dq;
  p.f.dk = dk;
  p.f.dv = dv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != kF32 && dtype != kBF16) return (int)cudaErrorInvalidValue;
  if (D == 64) return flashmask::bwd<64>(p, dtype == kBF16, st);
  if (D == 128) return flashmask::bwd<128>(p, dtype == kBF16, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
