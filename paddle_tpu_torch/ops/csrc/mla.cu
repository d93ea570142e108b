// mla_decode_attention for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas_mla.py:mla_decode_attention (Pallas
//           _kernel).
//
// What it computes: one absorbed-MLA decode step. Every query head of a
// sequence attends the SAME latent stream (multi-query attention): key
// t is [c_lat[t] | c_pe[t]] (r + dr dims), value t is c_lat[t] (r dims).
//   s[h, t] = (q_eff[h] . c_lat[t] + q_pe[h] . c_pe[t]) * scale, f32;
//   keys t >= lengths[b] are hidden; o[h] = softmax(s[h]) . c_lat, with
//   the probabilities rounded to the cache dtype before the product and
//   f32 sums, as the TPU kernel does (p.astype(cl.dtype), f32 dot);
//   a sequence of length 0 gives zeros.
// lengths stay on the card: each block reads its own.
//
// Bound on the H100: the cache bytes. A step reads each live latent row
// once, (r + dr) * itemsize bytes (1152 in bf16 at DeepSeek-V2's 512 +
// 64), plus q and the output; its work is 4 * nh * (r + dr) flops a row,
// ~57 flops a cache byte at nh 16, far below the ~295 a byte where the
// tensor cores would bound it. At 8 sequences of 8192 tokens: 75.5 MB,
// 0.0225 ms at 3.35 TB/s.
//
// Design. The point of the TPU kernel is that each cache byte is read
// once and feeds both the scores and the output. Blocks run in no order,
// so a block owns (sequence b, a split of the cache rows) and all nh heads,
// writes its split's (m, l, acc) in f32, and a second kernel merges the
// splits of a sequence: M = max m_s, o = sum_s acc_s e^(m_s - M) / sum_s
// l_s e^(m_s - M), skipping splits with l = 0 (no live row: their acc is
// never written). The host never reads lengths: the splits follow the
// cache length T. Cache rows past lengths[b], the split or the cache are
// ZERO-FILLED by cp.async, never read, since a cache holds garbage there
// and 0 * NaN would poison the sums.
//
// bf16 (tensor cores; replaces a CUDA-core kernel, kept for f32, whose 16
// FMA a lane and 5-step warp sum per score, second pass over the tile for
// the output, and 256-row splits (12 blocks at 4 x 544) made it 1.7x SDPA):
// - The heads are the M dimension of mma.sync m16n8k16: one m16 tile a
//   group of 4 warps (DeepSeek-V2-Lite's 16 heads fill one; up to 32 take
//   two groups); head rows past nh are zero in the staged q and never
//   stored.
// - A 16-row tile of [c_lat | c_pe] (one k16 step of the output product)
//   streams through a 4-stage cp.async ring, rows padded by 16 bytes so
//   that ldmatrix's 8 rows fall on 8 bank groups.
// - Scores S[16, 16] = [q_eff | q_pe] [c_lat | c_pe]^T, split over the
//   warps of a group by k16 steps (warp w takes steps w, w + 4, ...: 9 of
//   DeepSeek's 36, its q fragments held in registers for the whole split);
//   B fragments by ldmatrix from the staged rows. The partial tiles meet in
//   shared memory (4 x 1 KB f32) and each warp sums them in warp order, so
//   every warp holds the whole S in the accumulator layout.
// - Online softmax in f32 per head row, masked past the split's live rows
//   (exponentials by ex2.approx, 2^-21 relative, far below p's bf16
//   rounding); P is rounded to bf16 in registers (FA2's reuse of the
//   accumulator layout as the A operand): the TPU kernel's
//   p.astype(cl.dtype), at the same place; l sums the unrounded p.
// - O[16, r] += P c_lat[16 rows, r], each warp r / 4 columns, B by
//   ldmatrix.trans from the same staged rows (the cache is read once).
// - Splits (`mla_split_plan` in ops/mla.py, a function of B, T and the SM
//   count): 16-row multiples such that B x splits reaches the SM count (4 x
//   544: 16 rows, 136 blocks; 8 x 8192: 480 rows, 144 blocks, two a SM).
// f32 (CUDA cores, true f32 products for the 2e-5 gate): 32-row tiles of
// [c_lat | c_pe] stream through a two-stage cp.async ring (16-byte copies)
// and every warp reads the same tile for its two heads' scores and their
// weighted sums. Lanes own dimensions lane + 32 d (conflict-free shared
// loads), a warp sum gives a row's score, lane p keeps row p's score, and
// an f32 online softmax runs per head. r a multiple of 32 up to 512 (RPL
// = r / 32 dims a lane), dr a multiple of 32 up to 64, an even nh up to 32
// (two heads a warp).

#include "common.cuh"

namespace ptt {
namespace mla {

constexpr int TILE = 32;     // cache rows a tile: one score per lane
constexpr int HPW = 2;       // heads a warp
constexpr int MAX_PPL = 2;   // dr / 32 at most

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Stage rows [t, t + TILE) of sequence b's cache into `lat` [TILE][r] and
// `pe` [TILE][dr]; rows >= live are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(T* lat, T* pe, const T* c_lat,
                                          const T* c_pe, int b, int t,
                                          int live, int Tc, int r, int dr,
                                          int nthreads) {
  constexpr int VE = 16 / sizeof(T);
  const int lr = r / VE, pr = dr / VE;
  for (int c = threadIdx.x; c < TILE * (lr + pr); c += nthreads) {
    const int row = c / (lr + pr), k = c % (lr + pr);
    const bool ok = t + row < live;
    const size_t src_row = (size_t)b * Tc + t + row;
    if (k < lr) {
      cp_async16(lat + row * r + k * VE,
                 ok ? c_lat + src_row * r + k * VE : c_lat, ok);
    } else {
      const int kk = k - lr;
      cp_async16(pe + row * dr + kk * VE,
                 ok ? c_pe + src_row * dr + kk * VE : c_pe, ok);
    }
  }
}

template <typename T, int RPL>
__global__ void __launch_bounds__(512)
    split_kernel(const T* __restrict__ q_eff, const T* __restrict__ q_pe,
                 const T* __restrict__ c_lat, const T* __restrict__ c_pe,
                 const int* __restrict__ lengths, float* __restrict__ acc_out,
                 float* __restrict__ ml_out, int nh, int dr, int Tc,
                 int split_rows, float scale) {
  constexpr int r = 32 * RPL;
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, b = blockIdx.y, nsplit = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nthreads = blockDim.x;
  const int len = min(max(lengths[b], 0), Tc);
  const int t0 = s * split_rows;
  const int live = min(t0 + split_rows, len);  // rows [t0, live) are live
  const int ppl = dr / 32;
  const size_t stage = (size_t)TILE * (r + dr);
  T* buf = reinterpret_cast<T*>(smem);

  float qv[HPW][RPL], qp[HPW][MAX_PPL], acc[HPW][RPL], m[HPW], l[HPW];
#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    const int h = warp * HPW + j;
    m[j] = -INFINITY;
    l[j] = 0.f;
#pragma unroll
    for (int d = 0; d < RPL; ++d) {
      qv[j][d] = to_f32(q_eff[((size_t)b * nh + h) * r + d * 32 + lane]);
      acc[j][d] = 0.f;
    }
#pragma unroll
    for (int d = 0; d < MAX_PPL; ++d)
      qp[j][d] = d < ppl ? to_f32(q_pe[((size_t)b * nh + h) * dr + d * 32 +
                                       lane])
                         : 0.f;
  }

  const int n_tiles = live > t0 ? (live - t0 + TILE - 1) / TILE : 0;
  if (n_tiles > 0) {
    load_tile<T>(buf, buf + TILE * r, c_lat, c_pe, b, t0, live, Tc, r, dr,
                 nthreads);
  }
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int t = t0 + it * TILE;
    T* lat = buf + (it & 1) * stage;
    T* pe = lat + TILE * r;
    if (it + 1 < n_tiles) {
      T* nxt = buf + ((it + 1) & 1) * stage;
      load_tile<T>(nxt, nxt + TILE * r, c_lat, c_pe, b, t + TILE, live, Tc,
                   r, dr, nthreads);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // scores: lane p keeps row p's; dead rows (zeroed) score -inf
    float my_s[HPW];
#pragma unroll
    for (int j = 0; j < HPW; ++j) my_s[j] = -INFINITY;
    for (int p = 0; p < TILE; ++p) {
      const T* lr_ = lat + p * r;
      const T* pr_ = pe + p * dr;
      float part[HPW];
#pragma unroll
      for (int j = 0; j < HPW; ++j) part[j] = 0.f;
#pragma unroll
      for (int d = 0; d < RPL; ++d) {
        const float c = to_f32(lr_[d * 32 + lane]);
#pragma unroll
        for (int j = 0; j < HPW; ++j) part[j] += qv[j][d] * c;
      }
#pragma unroll
      for (int d = 0; d < MAX_PPL; ++d) {
        if (d < ppl) {
          const float c = to_f32(pr_[d * 32 + lane]);
#pragma unroll
          for (int j = 0; j < HPW; ++j) part[j] += qp[j][d] * c;
        }
      }
#pragma unroll
      for (int j = 0; j < HPW; ++j) {
        const float sc = warp_sum(part[j]) * scale;
        if (lane == p && t + p < live) my_s[j] = sc;
      }
    }
    // online softmax, then the weighted latent sum from the same tile
    float pj[HPW];
#pragma unroll
    for (int j = 0; j < HPW; ++j) {
      const float m_new = fmaxf(m[j], warp_max(my_s[j]));
      const float alpha = expf(m[j] - m_new);
      pj[j] = my_s[j] == -INFINITY ? 0.f : expf(my_s[j] - m_new);
      l[j] = l[j] * alpha + warp_sum(pj[j]);
#pragma unroll
      for (int d = 0; d < RPL; ++d) acc[j][d] *= alpha;
      m[j] = m_new;
    }
    for (int p = 0; p < TILE; ++p) {
      const T* lr_ = lat + p * r;
      float pp[HPW];
#pragma unroll
      for (int j = 0; j < HPW; ++j)
        pp[j] = round_to<T>(__shfl_sync(0xffffffffu, pj[j], p));
#pragma unroll
      for (int d = 0; d < RPL; ++d) {
        const float c = to_f32(lr_[d * 32 + lane]);
#pragma unroll
        for (int j = 0; j < HPW; ++j) acc[j][d] += pp[j] * c;
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    const int h = warp * HPW + j;
    const size_t at = ((size_t)b * nsplit + s) * nh + h;
#pragma unroll
    for (int d = 0; d < RPL; ++d) acc_out[at * r + d * 32 + lane] = acc[j][d];
    if (lane == 0) {
      ml_out[2 * at] = m[j];
      ml_out[2 * at + 1] = l[j];
    }
  }
}

// One block of MERGE_THREADS per (sequence, head): the splits' f32
// partials merged. A split with l = 0 holds no live row (its acc may be
// unwritten) and is skipped; a sequence of length 0 gives zeros. The
// splits are dealt to groups of r / 4 threads (a float4 of the r sums a
// thread), so that many loads are in flight at once, and the groups' sums
// meet in shared memory in group order.
constexpr int MERGE_THREADS = 512;
template <typename T>
__global__ void __launch_bounds__(MERGE_THREADS)
    merge_kernel(const float* __restrict__ acc_in,
                 const float* __restrict__ ml_in, T* __restrict__ out,
                 int nh, int r, int nsplit) {
  extern __shared__ float wts[];  // [nsplit]: e^(m_s - M), 0 for l = 0
  float* part = wts + ((nsplit + 3) & ~3);  // [groups][r]
  const int b = blockIdx.x, h = blockIdx.y;
  __shared__ float inv_l;
  if (threadIdx.x < 32) {
    float M = -INFINITY;
    for (int s = threadIdx.x; s < nsplit; s += 32) {
      const size_t at = ((size_t)b * nsplit + s) * nh + h;
      if (ml_in[2 * at + 1] > 0.f) M = fmaxf(M, ml_in[2 * at]);
    }
    M = warp_max(M);
    float L = 0.f;
    for (int s = threadIdx.x; s < nsplit; s += 32) {
      const size_t at = ((size_t)b * nsplit + s) * nh + h;
      const float ls = ml_in[2 * at + 1];
      const float e = ls > 0.f ? expf(ml_in[2 * at] - M) : 0.f;
      wts[s] = e;
      L += ls * e;
    }
    L = warp_sum(L);
    if (threadIdx.x == 0) inv_l = 1.f / (L == 0.f ? 1.f : L);
  }
  __syncthreads();
  const int tpg = r / 4, groups = MERGE_THREADS / tpg;
  const int grp = threadIdx.x / tpg, d = 4 * (threadIdx.x % tpg);
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = grp; s < nsplit; s += groups) {
    const float e = wts[s];
    if (e > 0.f) {
      const float4 v = *reinterpret_cast<const float4*>(
          acc_in + (((size_t)b * nsplit + s) * nh + h) * r + d);
      o.x += v.x * e, o.y += v.y * e, o.z += v.z * e, o.w += v.w * e;
    }
  }
  *reinterpret_cast<float4*>(part + grp * r + d) = o;
  __syncthreads();
  for (int k = threadIdx.x; k < r; k += MERGE_THREADS) {
    float v = 0.f;
    for (int g = 0; g < groups; ++g) v += part[g * r + k];
    out[((size_t)b * nh + h) * r + k] = from_f32<T>(v * inv_l);
  }
}

template <typename T>
static int launch_merge(const float* acc, const float* ml, void* out, int B,
                        int nh, int r, int nsplit, cudaStream_t st) {
  const size_t smem =
      (((size_t)nsplit + 3) / 4 * 4 + MERGE_THREADS * 4) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      merge_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  merge_kernel<T><<<dim3(B, nh), MERGE_THREADS, smem, st>>>(
      acc, ml, static_cast<T*>(out), nh, r, nsplit);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- bf16, on tensor cores
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BT = 16;    // cache rows a tile: one k16 step of P c_lat
constexpr int NSTG = 4;   // ring stages

// Two 8 x 8 b16 matrices, transposed (lanes 0-15 give the row addresses).
__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[2],
                                              const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(s));
}

// Barrier `id` over the `n` threads of a group of warps.
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared memory of a block of HT head tiles at latent width R and rope
// width dr: the staged q rows, the ring, the partial score tiles.
__host__ __device__ constexpr size_t smem_bytes(int R, int dr, int HT) {
  return (size_t)(HT * 16 + NSTG * BT) * (2 * (R + dr) + 16) +
         (size_t)HT * 4 * 16 * 16 * sizeof(float);
}

// A block per (split s, sequence b): HT groups of 4 warps, group i the
// heads 16 i .. 16 i + 15. Writes acc [B, nsplit, nh, R] and ml [B, nsplit,
// nh, 2] for its split (a split with no live row writes only (-inf, 0)).
template <int R, int HT>
__global__ void __launch_bounds__(128 * HT)
    split_mma(const bf16* __restrict__ q_eff, const bf16* __restrict__ q_pe,
              const bf16* __restrict__ c_lat, const bf16* __restrict__ c_pe,
              const int* __restrict__ lengths, float* __restrict__ acc_out,
              float* __restrict__ ml_out, int nh, int dr, int Tc,
              int split_rows, float scale) {
  constexpr int QS = (R / 16 + 4 + 3) / 4;  // k16 steps a warp at most
  constexpr int NB = R / 32;                // n8 output tiles a warp
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = R + dr, DS = 2 * D + 16, KS = D / 16, CH = D / 8;
  unsigned char* sq = smem;                           // [HT 16][DS]
  unsigned char* ring = sq + HT * 16 * DS;            // [NSTG][BT][DS]
  float* sx = reinterpret_cast<float*>(ring + NSTG * BT * DS);
  const int s = blockIdx.x, b = blockIdx.y, nsplit = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int grp = tid >> 7, w = (tid >> 5) & 3, g = lane >> 2, c = lane & 3;
  const int len = min(max(lengths[b], 0), Tc);
  const int t0 = s * split_rows, live = min(t0 + split_rows, len);
  const int n_tiles = live > t0 ? (live - t0 + BT - 1) / BT : 0;
  // this thread's two head rows, and whether each is a real head
  const int hr[2] = {grp * 16 + g, grp * 16 + g + 8};
  const bool hv[2] = {hr[0] < nh, hr[1] < nh};
  if (n_tiles == 0) {
    if (w == 0 && c == 0)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (hv[i]) {
          const size_t at = ((size_t)b * nsplit + s) * nh + hr[i];
          ml_out[2 * at] = -INFINITY;
          ml_out[2 * at + 1] = 0.f;
        }
    return;
  }

  // rows [t, t + BT) of the sequence's [c_lat | c_pe] into stage it % NSTG;
  // rows at or past `live` zero-filled, never read. The thread's 16-byte
  // pieces are (row, k) = divmod(tid + i NTH, CH), stepped without a
  // division
  constexpr int NTH = 128 * HT;
  const int r_first = tid / CH, k_first = tid % CH;
  const int r_step = NTH / CH, k_step = NTH % CH;
  auto load = [&](int it) {
    unsigned char* st = ring + (it % NSTG) * BT * DS;
    const int t = t0 + it * BT;
    int row = r_first, k = k_first;
    for (int i = tid; i < BT * CH; i += NTH) {
      const bool ok = t + row < live;
      const size_t src = (size_t)b * Tc + t + row;
      const bf16* p = k < R / 8 ? c_lat + src * R + 8 * k
                                : c_pe + src * dr + 8 * (k - R / 8);
      cp_async16(st + row * DS + 16 * k, ok ? p : c_lat, ok);
      row += r_step;
      k += k_step;
      if (k >= CH) k -= CH, ++row;
    }
  };
  // q rows [q_eff | q_pe] of the block's heads; rows past nh zero (16-byte
  // loads where both q tensors are 16-byte aligned)
  const bool q16 =
      ((reinterpret_cast<uintptr_t>(q_eff) | reinterpret_cast<uintptr_t>(q_pe)) &
       15) == 0;
  for (int i = tid; i < HT * 16 * CH; i += 128 * HT) {
    const int h = i / CH, k = i % CH;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (h < nh) {
      const size_t q = (size_t)b * nh + h;
      const bf16* src =
          k < R / 8 ? q_eff + q * R + 8 * k : q_pe + q * dr + 8 * (k - R / 8);
      if (q16) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        unsigned short e[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = reinterpret_cast<const unsigned short*>(src)[j];
        v = make_uint4(e[0] | (unsigned)e[1] << 16, e[2] | (unsigned)e[3] << 16,
                       e[4] | (unsigned)e[5] << 16, e[6] | (unsigned)e[7] << 16);
      }
    }
    *reinterpret_cast<uint4*>(sq + h * DS + 16 * k) = v;
  }
#pragma unroll
  for (int i = 0; i < NSTG - 1; ++i) {
    if (i < n_tiles) load(i);
    cp_async_commit();
  }
  __syncthreads();
  // this warp's q fragments, k16 steps w, w + 4, ...
  uint32_t qa[QS][4];
#pragma unroll
  for (int j = 0; j < QS; ++j) {
    const int kk = w + 4 * j;
    if (kk < KS)
      ldsm_x4(qa[j], sq + (grp * 16 + (lane & 15)) * DS +
                         2 * (16 * kk + 8 * (lane >> 4)));
  }

  float o[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float* mine = sx + (grp * 4 + w) * 256;
  const float* group_sx = sx + grp * 4 * 256;
  const int col0 = w * (R / 4);  // this warp's output columns
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<NSTG - 2>();
    __syncthreads();  // tile it staged; every thread done with tile it - 1
    if (it + NSTG - 1 < n_tiles) load(it + NSTG - 1);
    cp_async_commit();
    const unsigned char* st = ring + (it % NSTG) * BT * DS;

    // partial scores over this warp's k16 steps, [head][row] in f32
    float sp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < QS; ++j) {
      const int kk = w + 4 * j;
      if (kk < KS) {
        unsigned kb[4];
        ldsm_x4(kb, st + ((lane & 7) + 8 * (lane >> 4)) * DS +
                        2 * (16 * kk + 8 * ((lane >> 3) & 1)));
        mma_bf16(sp[0], qa[j], kb[0], kb[1]);
        mma_bf16(sp[1], qa[j], kb[2], kb[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mine[g * 16 + 8 * n + 2 * c + e] = sp[n][e];
        mine[(g + 8) * 16 + 8 * n + 2 * c + e] = sp[n][2 + e];
      }
    group_sync(1 + grp, 128);
    // the whole tile, summed in warp order, masked and scaled
    const int tt = t0 + it * BT;
    float sv[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 8 * n + 2 * c + (e & 1), head = g + 8 * (e >> 1);
        float v = 0.f;
#pragma unroll
        for (int ww = 0; ww < 4; ++ww)
          v += group_sx[ww * 256 + head * 16 + row];
        sv[n][e] = tt + row < live ? v * scale : -INFINITY;
      }
    // online softmax per head row (i 0: g, i 1: g + 8)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = fmaxf(fmaxf(sv[0][2 * i], sv[0][2 * i + 1]),
                       fmaxf(sv[1][2 * i], sv[1][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const bool none = m_new == -INFINITY;
      const float alpha = none ? 1.f : __expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = sv[n][2 * i + e];
          v = none || v == -INFINITY ? 0.f : __expf(v - m_new);
          ps += v;
        }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        o[n][2 * i] *= alpha;
        o[n][2 * i + 1] *= alpha;
      }
    }
    // P rounded to the cache dtype, as the A operand of P c_lat
    uint32_t pa[4];
    pa[0] = pack_bf16(sv[0][0], sv[0][1]);
    pa[1] = pack_bf16(sv[0][2], sv[0][3]);
    pa[2] = pack_bf16(sv[1][0], sv[1][1]);
    pa[3] = pack_bf16(sv[1][2], sv[1][3]);
    if constexpr (NB == 1) {
      unsigned vb[2];
      ldsm_x2_trans(vb, st + ((lane & 7) + 8 * ((lane >> 3) & 1)) * DS +
                            2 * col0);
      mma_bf16(o[0], pa, vb[0], vb[1]);
    } else {
#pragma unroll
      for (int n = 0; n < NB; n += 2) {
        unsigned vb[4];
        ldsm_x4_trans(vb, st + ((lane & 7) + 8 * ((lane >> 3) & 1)) * DS +
                              2 * (col0 + 8 * n + 8 * (lane >> 4)));
        mma_bf16(o[n], pa, vb[0], vb[1]);
        mma_bf16(o[n + 1], pa, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();

  // this split's (m, l) and unnormalised sums, real heads only
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!hv[i]) continue;
    const size_t at = ((size_t)b * nsplit + s) * nh + hr[i];
    float* a = acc_out + at * R + col0 + 2 * c;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      *reinterpret_cast<float2*>(a + 8 * n) =
          make_float2(o[n][2 * i], o[n][2 * i + 1]);
    if (w == 0 && c == 0) {
      ml_out[2 * at] = m[i];
      ml_out[2 * at + 1] = l[i];
    }
  }
}

template <int R, int HT>
static int launch(const void* qe, const void* qp, const void* cl,
                  const void* cp, const int* lens, float* acc, float* ml,
                  void* out, int B, int nh, int dr, int Tc, int split_rows,
                  int nsplit, float scale, cudaStream_t st) {
  const size_t smem = smem_bytes(R, dr, HT);
  cudaError_t e = cudaFuncSetAttribute(
      split_mma<R, HT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  split_mma<R, HT><<<dim3(nsplit, B), 128 * HT, smem, st>>>(
      static_cast<const bf16*>(qe), static_cast<const bf16*>(qp),
      static_cast<const bf16*>(cl), static_cast<const bf16*>(cp), lens, acc,
      ml, nh, dr, Tc, split_rows, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_merge<bf16>(acc, ml, out, B, nh, R, nsplit, st);
}

template <int R>
static int launch_h(const void* qe, const void* qp, const void* cl,
                    const void* cp, const int* lens, float* acc, float* ml,
                    void* out, int B, int nh, int dr, int Tc, int split_rows,
                    int nsplit, float scale, cudaStream_t st) {
  return nh <= 16 ? launch<R, 1>(qe, qp, cl, cp, lens, acc, ml, out, B, nh,
                                 dr, Tc, split_rows, nsplit, scale, st)
                  : launch<R, 2>(qe, qp, cl, cp, lens, acc, ml, out, B, nh,
                                 dr, Tc, split_rows, nsplit, scale, st);
}

static int dispatch(int r, const void* qe, const void* qp, const void* cl,
                    const void* cp, const int* lens, float* acc, float* ml,
                    void* out, int B, int nh, int dr, int Tc, int split_rows,
                    int nsplit, float scale, cudaStream_t st) {
  switch (r) {
    case 32:
      return launch_h<32>(qe, qp, cl, cp, lens, acc, ml, out, B, nh, dr, Tc,
                          split_rows, nsplit, scale, st);
    case 64:
      return launch_h<64>(qe, qp, cl, cp, lens, acc, ml, out, B, nh, dr, Tc,
                          split_rows, nsplit, scale, st);
    case 128:
      return launch_h<128>(qe, qp, cl, cp, lens, acc, ml, out, B, nh, dr, Tc,
                           split_rows, nsplit, scale, st);
    case 256:
      return launch_h<256>(qe, qp, cl, cp, lens, acc, ml, out, B, nh, dr, Tc,
                           split_rows, nsplit, scale, st);
    case 512:
      return launch_h<512>(qe, qp, cl, cp, lens, acc, ml, out, B, nh, dr, Tc,
                           split_rows, nsplit, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

template <typename T, int RPL>
static int launch(const void* qe, const void* qp, const void* cl,
                  const void* cp, const int* lens, float* acc, float* ml,
                  void* out, int B, int nh, int dr, int Tc, int split_rows,
                  int nsplit, float scale, cudaStream_t st) {
  constexpr int r = 32 * RPL;
  const size_t smem = (size_t)2 * TILE * (r + dr) * sizeof(T);
  auto kern = split_kernel<T, RPL>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(nsplit, B), 32 * (nh / HPW), smem, st>>>(
      static_cast<const T*>(qe), static_cast<const T*>(qp),
      static_cast<const T*>(cl), static_cast<const T*>(cp), lens, acc, ml, nh,
      dr, Tc, split_rows, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_merge<T>(acc, ml, out, B, nh, r, nsplit, st);
}

template <typename T>
static int dispatch(int r, const void* qe, const void* qp, const void* cl,
                    const void* cp, const int* lens, float* acc, float* ml,
                    void* out, int B, int nh, int dr, int Tc, int split_rows,
                    int nsplit, float scale, cudaStream_t st) {
  switch (r) {
    case 32:
      return launch<T, 1>(qe, qp, cl, cp, lens, acc, ml, out, B, nh, dr, Tc,
                          split_rows, nsplit, scale, st);
    case 64:
      return launch<T, 2>(qe, qp, cl, cp, lens, acc, ml, out, B, nh, dr, Tc,
                          split_rows, nsplit, scale, st);
    case 128:
      return launch<T, 4>(qe, qp, cl, cp, lens, acc, ml, out, B, nh, dr, Tc,
                          split_rows, nsplit, scale, st);
    case 256:
      return launch<T, 8>(qe, qp, cl, cp, lens, acc, ml, out, B, nh, dr, Tc,
                          split_rows, nsplit, scale, st);
    case 512:
      return launch<T, 16>(qe, qp, cl, cp, lens, acc, ml, out, B, nh, dr, Tc,
                           split_rows, nsplit, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace mla
}  // namespace ptt

using namespace ptt;

extern "C" {

// q_eff [B, nh, r], q_pe [B, nh, dr], c_lat [B, Tc, r], c_pe [B, Tc, dr]
// (the cache dtype), lengths [B] int32 on the card; acc [B, nsplit, nh, r]
// and ml [B, nsplit, nh, 2] f32 workspaces, nsplit = ceil(Tc / split_rows),
// split_rows a multiple of 16 (bf16) or 32 (f32) -> out [B, nh, r]
int ptt_mla_decode(const void* q_eff, const void* q_pe, const void* c_lat,
                   const void* c_pe, const void* lengths, void* acc, void* ml,
                   void* out, int B, int nh, int r, int dr, int Tc,
                   int split_rows, float scale, int dtype, int device,
                   void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return (int)cudaSuccess;
  const int tile = dtype == kBF16 ? mla::tc::BT : mla::TILE;
  if (nh < mla::HPW || nh % mla::HPW || nh > 32 || dr < 32 || dr % 32 ||
      dr > 32 * mla::MAX_PPL || Tc < 1 || split_rows < tile ||
      split_rows % tile)
    return (int)cudaErrorInvalidValue;
  const int nsplit = (Tc + split_rows - 1) / split_rows;
  const int* lens = static_cast<const int*>(lengths);
  float* a = static_cast<float*>(acc);
  float* m = static_cast<float*>(ml);
  if (dtype == kF32)
    return mla::dispatch<float>(r, q_eff, q_pe, c_lat, c_pe, lens, a, m, out,
                                B, nh, dr, Tc, split_rows, nsplit, scale, st);
  if (dtype == kBF16)
    return mla::tc::dispatch(r, q_eff, q_pe, c_lat, c_pe, lens, a, m, out, B,
                             nh, dr, Tc, split_rows, nsplit, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
