// flash_sdpa (forward, dq, dkv) for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas_flash.py:flash_sdpa (Pallas _fwd_kernel,
//           _bwd_dq_kernel, _bwd_dkv_kernel and the custom VJP around them).
//
// Bound on the H100: the products. Causal, the forward does 2 products
// (q k^T and p v) over the visible half, 4 * B * H * Sq * Sk * D / 2 FLOP:
// at the training shape (B 1, S 8192, H 32, D 128) 5.5e11 FLOP, 0.556 ms at
// 989 TFLOP/s (bf16). The gradient needs 5 products (q k^T again, do v^T,
// dq, dk, dv), 1.37e12 FLOP, 1.39 ms; the two-kernel split below recomputes
// q k^T and do v^T in both kernels, 7 products in all. The bytes (q, k, v,
// o, do and the grads once each, ~0.5 GB) take ~0.15 ms.
//
// What it computes (pallas_flash.py:77-213): inputs [B, S, H, D], read with
// their batch / sequence / head strides; s = (q . k) * scale in f32; key j
// is hidden from row i when causal and j > i + (Sk - Sq) (bottom-right
// aligned), when seg_q[i] != seg_kv[j], or past the ragged edge. Hidden
// scores are -1e30, never -inf. The forward is an online softmax; p is
// rounded to the input type before p v, with f32 accumulation; it writes o
// and an f32 lse [B, H, Sq]. A row with no visible key gets o = 0 and
// lse = +1e30, so the backward's exp(s - lse) underflows to 0, not NaN.
// The backward first takes di = sum(do * o) in f32 (a small pre-pass), then
// two kernels with no atomics, as on the TPU: dq (a block per q tile, its
// loop over k tiles recomputing p from lse, ds = p (dp - di) scale rounded to
// the input type, dq += ds k) and dkv (a block per k tile, its loop over q
// tiles, dv += p^T do, dk += ds^T q). Three CUDA kernels per backward call.
//
// Design. The TPU kernels walked a sequential grid, carrying the softmax
// state in VMEM scratch across the k blocks. Here blocks run in parallel,
// so each block owns its tile and loops over the other axis itself, and
// the causal block skip is the loop's bound. bf16 (FA2-style): a block of
// 4 warps owns (b, h, a 64-row q tile), 16 rows a warp; K/V tiles of 64
// keys (Q/dO tiles of 32 rows in dkv) stream through a cp.async double
// buffer in shared memory (rows padded by 16 bytes, so ldmatrix is free of
// bank conflicts); every product is mma.sync m16n8k16 bf16 -> f32 fed by
// ldmatrix (.trans for the operand whose reduction runs down its rows), and
// p or ds pass from the accumulator to the next product's A operand in
// registers. Row max and row sum are quad shuffles. Causal q tiles are
// taken heaviest first; only tiles that hold a hidden entry (the causal
// diagonal, the ragged edge, segments) evaluate the mask, and exp is the
// hardware's ex2 (__expf: a few ulp of f32, far below the bf16 rounding of
// p). f32 takes a scalar path on the CUDA cores (a warp
// per row, D / 32 dimensions a lane, one warp sum per product), so the
// card can be held to the plain f32 version at 2e-5. head_dim 64 or 128;
// the forward also 192 (the MLA prefill: DeepSeek-V2's q / k of 128 + 64,
// v zero-padded to it by sdpa_padded_heads): its 64-key K / V tiles and
// the Q tile take (64 + 4 x 64) rows x 400 bytes = 128 KB of dynamic
// shared memory (the opt-in every head dim takes), and a warp's output
// accumulator grows to 96 f32 registers. The backward stays at 64 / 128.
// The tile helpers (loads, mma.sync products, the f32 row helpers, the di
// pre-pass) live in flash_tiles.cuh, shared with flashmask.cu.
// wgmma, TMA and a GQA-native K/V read are the redesign (ROADMAP queue R).

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
// lse is +1e30 in the backward).
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
template <int D>
__global__ void __launch_bounds__(kThreads) fwd_bf16(const Flash p) {
  constexpr int LD = Geo<D>::LD, DT = Geo<D>::DT, NT = BKV / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                   // [2][BKV][LD]
  bf16* Vs = Ks + 2 * BKV * LD;              // [2][BKV][LD]
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.qs[0] + h * p.qs[2];
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.ks[0] + h * p.ks[2];
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.vs[0] + h * p.vs[2];
  // causal skip: keys past the tile's last row + (Sk - Sq) are hidden
  const int kv_end =
      p.causal ? min(p.Sk, q0 + BQ + p.Sk - p.Sq) : p.Sk;
  const int n_kt = kv_end > 0 ? (kv_end + BKV - 1) / BKV : 0;

  load_tile<D, BQ>(Qs, qg, p.qs[1], q0, p.Sq);
  if (n_kt > 0) {
    load_tile<D, BKV>(Ks, kg, p.ks[1], 0, p.Sk);
    load_tile<D, BKV>(Vs, vg, p.vs[1], 0, p.Sk);
  }
  cp_async_commit();

  const int rows[2] = {q0 + warp * 16 + (lane >> 2),
                       q0 + warp * 16 + (lane >> 2) + 8};
  const int segs[2] = {seg_of(p, b, rows[0]), seg_of(p, b, rows[1])};
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kt) {
      load_tile<D, BKV>(Ks + (st ^ 1) * BKV * LD, kg, p.ks[1], (kt + 1) * BKV,
                        p.Sk);
      load_tile<D, BKV>(Vs + (st ^ 1) * BKV * LD, vg, p.vs[1], (kt + 1) * BKV,
                        p.Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
    mma_nt<NT, D, LD>(s, Qs + warp * 16 * LD, Ks + st * BKV * LD);

    const int c0 = kt * BKV + (lane & 3) * 2;
    const bool masked = !tile_visible(p, q0, BQ, kt * BKV, BKV);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        float x = s[nt][e] * p.scale;
        if (masked && hidden(p, b, rows[hh], c0 + nt * 8 + (e & 1), segs[hh]))
          x = kNeg;
        s[nt][e] = x;
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
            s[nt][e] == kNeg ? 0.f : __expf(s[nt][e] - mnew[hh]);
        s[nt][e] = pv;
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
    mma_pv<DT, BKV, LD>(acc, s, Vs + st * BKV * LD);
    __syncthreads();  // this stage is refilled two tiles on
  }
  cp_async_wait<0>();

  const float lsafe[2] = {l[0] == 0.f ? 1.f : l[0], l[1] == 0.f ? 1.f : l[1]};
  store_rows<D>(static_cast<bf16*>(p.out), acc, b, h, p.H, p.Sq,
                q0 + warp * 16, lsafe);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (rows[hh] < p.Sq)
        p.lse[((size_t)b * p.H + h) * p.Sq + rows[hh]] =
            l[hh] == 0.f ? -kNeg : m[hh] + logf(lsafe[hh]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) dq_bf16(const Flash p) {
  constexpr int LD = Geo<D>::LD, DT = Geo<D>::DT, NT = BKV / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [BQ][LD]
  bf16* dOs = Qs + BQ * LD;                  // [BQ][LD]
  bf16* Ks = dOs + BQ * LD;                  // [2][BKV][LD]
  bf16* Vs = Ks + 2 * BKV * LD;              // [2][BKV][LD]
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.qs[0] + h * p.qs[2];
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.ks[0] + h * p.ks[2];
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.vs[0] + h * p.vs[2];
  const long long ds_row = (long long)p.H * D;
  const bf16* dog = static_cast<const bf16*>(p.dout) +
                    (long long)b * p.Sq * ds_row + (long long)h * D;
  const int kv_end =
      p.causal ? min(p.Sk, q0 + BQ + p.Sk - p.Sq) : p.Sk;
  const int n_kt = kv_end > 0 ? (kv_end + BKV - 1) / BKV : 0;

  load_tile<D, BQ>(Qs, qg, p.qs[1], q0, p.Sq);
  load_tile<D, BQ>(dOs, dog, ds_row, q0, p.Sq);
  if (n_kt > 0) {
    load_tile<D, BKV>(Ks, kg, p.ks[1], 0, p.Sk);
    load_tile<D, BKV>(Vs, vg, p.vs[1], 0, p.Sk);
  }
  cp_async_commit();

  const int rows[2] = {q0 + warp * 16 + (lane >> 2),
                       q0 + warp * 16 + (lane >> 2) + 8};
  const int segs[2] = {seg_of(p, b, rows[0]), seg_of(p, b, rows[1])};
  float lse[2], di[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const size_t at = ((size_t)b * p.H + h) * p.Sq + rows[hh];
    lse[hh] = rows[hh] < p.Sq ? p.lse[at] : -kNeg;
    di[hh] = rows[hh] < p.Sq ? p.di[at] : 0.f;
  }
  float dq[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kt) {
      load_tile<D, BKV>(Ks + (st ^ 1) * BKV * LD, kg, p.ks[1], (kt + 1) * BKV,
                        p.Sk);
      load_tile<D, BKV>(Vs + (st ^ 1) * BKV * LD, vg, p.vs[1], (kt + 1) * BKV,
                        p.Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
    mma_nt<NT, D, LD>(s, Qs + warp * 16 * LD, Ks + st * BKV * LD);
    mma_nt<NT, D, LD>(dp, dOs + warp * 16 * LD, Vs + st * BKV * LD);

    const int c0 = kt * BKV + (lane & 3) * 2;
    const bool masked = !tile_visible(p, q0, BQ, kt * BKV, BKV);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const float pv =
            masked && hidden(p, b, rows[hh], c0 + nt * 8 + (e & 1), segs[hh])
                ? 0.f
                : __expf(s[nt][e] * p.scale - lse[hh]);
        s[nt][e] = pv * (dp[nt][e] - di[hh]) * p.scale;  // ds
      }
    mma_pv<DT, BKV, LD>(dq, s, Ks + st * BKV * LD);
    __syncthreads();
  }
  cp_async_wait<0>();
  const float one[2] = {1.f, 1.f};
  store_rows<D>(static_cast<bf16*>(p.dq), dq, b, h, p.H, p.Sq,
                q0 + warp * 16, one);
}

template <int D>
__global__ void __launch_bounds__(kThreads) dkv_bf16(const Flash p) {
  constexpr int LD = Geo<D>::LD, DT = Geo<D>::DT, NT = BQ2 / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [BKV][LD]
  bf16* Vs = Ks + BKV * LD;                  // [BKV][LD]
  bf16* Qs = Vs + BKV * LD;                  // [2][BQ2][LD]
  bf16* dOs = Qs + 2 * BQ2 * LD;             // [2][BQ2][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ2 * LD);  // [2][BQ2]
  float* di_s = lse_s + 2 * BQ2;                                // [2][BQ2]
  const int k0 = blockIdx.x * BKV;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.qs[0] + h * p.qs[2];
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.ks[0] + h * p.ks[2];
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.vs[0] + h * p.vs[2];
  const long long ds_row = (long long)p.H * D;
  const bf16* dog = static_cast<const bf16*>(p.dout) +
                    (long long)b * p.Sq * ds_row + (long long)h * D;
  const size_t row_base = ((size_t)b * p.H + h) * p.Sq;
  // causal skip: rows before k0 - (Sk - Sq) see none of this tile's keys
  const int q_begin = p.causal ? max(0, k0 - (p.Sk - p.Sq)) : 0;
  const int qt0 = q_begin / BQ2;
  const int n_it = max(0, (p.Sq + BQ2 - 1) / BQ2 - qt0);

  auto load_q = [&](int it, int st) {
    const int r0 = (qt0 + it) * BQ2;
    load_tile<D, BQ2>(Qs + st * BQ2 * LD, qg, p.qs[1], r0, p.Sq);
    load_tile<D, BQ2>(dOs + st * BQ2 * LD, dog, ds_row, r0, p.Sq);
    if (threadIdx.x < BQ2) {
      const int r = r0 + threadIdx.x;
      lse_s[st * BQ2 + threadIdx.x] = r < p.Sq ? p.lse[row_base + r] : -kNeg;
      di_s[st * BQ2 + threadIdx.x] = r < p.Sq ? p.di[row_base + r] : 0.f;
    }
  };
  load_tile<D, BKV>(Ks, kg, p.ks[1], k0, p.Sk);
  load_tile<D, BKV>(Vs, vg, p.vs[1], k0, p.Sk);
  if (n_it > 0) load_q(0, 0);
  cp_async_commit();

  const int keys[2] = {k0 + warp * 16 + (lane >> 2),
                       k0 + warp * 16 + (lane >> 2) + 8};
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) {
      load_q(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + st * BQ2 * LD;
    const bf16* dOt = dOs + st * BQ2 * LD;

    // s^T = k q^T: this warp's 16 keys by the tile's BQ2 q rows
    float s[NT][4], dpt[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dpt[i][e] = 0.f;
    mma_nt<NT, D, LD>(s, Ks + warp * 16 * LD, Qt);
    const int r0 = (qt0 + it) * BQ2;
    const bool masked = !tile_visible(p, r0, BQ2, k0, BKV);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + (lane & 3) * 2 + (e & 1);  // q row in tile
        const int row = r0 + c;
        const float pv =
            masked && hidden(p, b, row, keys[e >> 1], seg_of(p, b, row))
                ? 0.f
                : __expf(s[nt][e] * p.scale - lse_s[st * BQ2 + c]);
        s[nt][e] = pv;
      }
    mma_pv<DT, BQ2, LD>(dv, s, dOt);  // dv += p^T do
    mma_nt<NT, D, LD>(dpt, Vs + warp * 16 * LD, dOt);  // dp^T = v do^T
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + (lane & 3) * 2 + (e & 1);
        s[nt][e] = s[nt][e] * (dpt[nt][e] - di_s[st * BQ2 + c]) * p.scale;
      }
    mma_pv<DT, BQ2, LD>(dk, s, Qt);  // dk += ds^T q
    __syncthreads();
  }
  cp_async_wait<0>();
  const float one[2] = {1.f, 1.f};
  store_rows<D>(static_cast<bf16*>(p.dk), dk, b, h, p.H, p.Sk,
                k0 + warp * 16, one);
  store_rows<D>(static_cast<bf16*>(p.dv), dv, b, h, p.H, p.Sk,
                k0 + warp * 16, one);
}

template <int D>
constexpr size_t fwd_smem() {
  return (size_t)(BQ + 4 * BKV) * Geo<D>::LD * sizeof(bf16);
}
template <int D>
constexpr size_t dq_smem() {
  return (size_t)(2 * BQ + 4 * BKV) * Geo<D>::LD * sizeof(bf16);
}
template <int D>
constexpr size_t dkv_smem() {
  return (size_t)(2 * BKV + 4 * BQ2) * Geo<D>::LD * sizeof(bf16) +
         4 * BQ2 * sizeof(float);
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
  if (bf16_in) {
    const size_t smem = fwd_smem<D>();
    cudaError_t e = with_smem(fwd_bf16<D>, smem);
    if (e != cudaSuccess) return (int)e;
    fwd_bf16<D><<<dim3((p.Sq + BQ - 1) / BQ, p.H, p.B), kThreads, smem, st>>>(
        p);
  } else {
    fwd_f32<D><<<dim3((p.Sq + 3) / 4, p.H, p.B), kThreads, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}

template <int D>
static int bwd(const Flash& p, int bf16_in, cudaStream_t st) {
  const int rows = p.B * p.Sq * p.H;
  if (bf16_in) {
    di_pass<bf16, D><<<(rows + 3) / 4, kThreads, 0, st>>>(p);
    cudaError_t e = with_smem(dq_bf16<D>, dq_smem<D>());
    if (e == cudaSuccess) e = with_smem(dkv_bf16<D>, dkv_smem<D>());
    if (e != cudaSuccess) return (int)e;
    dq_bf16<D><<<dim3((p.Sq + BQ - 1) / BQ, p.H, p.B), kThreads,
                 dq_smem<D>(), st>>>(p);
    dkv_bf16<D><<<dim3((p.Sk + BKV - 1) / BKV, p.H, p.B), kThreads,
                  dkv_smem<D>(), st>>>(p);
  } else {
    di_pass<float, D><<<(rows + 3) / 4, kThreads, 0, st>>>(p);
    dq_f32<D><<<dim3((p.Sq + 3) / 4, p.H, p.B), kThreads, 0, st>>>(p);
    dkv_f32<D><<<dim3((p.Sk + 3) / 4, p.H, p.B), kThreads, 0, st>>>(p);
  }
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
// the forward, di an f32 [B, H, Sq] workspace -> dq [B, Sq, H, D], dk/dv
// [B, Sk, H, D] contiguous. Three CUDA kernels: di, dq, dkv.
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
