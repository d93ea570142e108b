// paged_decode_attention (v1) and paged_decode_attention_v2 for Hopper
// (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas_paged.py:paged_decode_attention (Pallas
//           _kernel, grid (B, KV, pages_per_seq)) and
//           paddle_tpu/ops/pallas_paged.py:paged_decode_attention_v2
//           (Pallas _v2_kernel, grid (B, KV), pages fetched in groups by
//           double-buffered manual DMA).
//
// What both compute: one decode token per sequence b. Query head h of
// q [B, H, D] attends to the first lengths[b] rows of its KV head
// h / (H / KV) in the paged cache k/v_pages [KV, P, page_size, D]; row j
// lives in page tables[b, j / page_size] at offset j % page_size:
//   o[b, h] = softmax_j(scale * q[b, h] . K_j) . V
// in f32, written in q's dtype. A length past the table's capacity
// nj * page_size reads the table's pages only; table entries are clamped
// to [0, P - 1] (a -1 sentinel past the live rows is never read); a
// length-0 row comes out zero, as in the JAX kernels.
//
// Bound on the H100: bytes. A decode token does 4 * D flops per K/V row
// it reads (2 * D * esize bytes), ~1 flop a byte in bf16 against the
// card's ~295, so the least time is the live K/V rows,
//   sum_b lengths[b] * KV * D * esize * 2,
// plus q, o and the tables, at 3.35 TB/s.
//
// Design: the TPU kernels carried the online softmax across a sequential
// grid axis over pages. Here blocks run in no order, so one block owns one
// (KV head g, sequence b) and loops over that sequence's rows itself: no
// cross-block reduction. Its rep = H / KV query heads share every K/V row
// it reads (GQA-native; the plain version and the JAX reference repeat
// K/V). A row is read in 16-byte pieces by a power-of-two group of lanes
// (TPR lanes, each holding 8 bf16 or 4 f32 values of a piece), so a warp
// reads 512 contiguous bytes a step; a block of 128 threads has 128 / TPR
// row groups working on different rows. A tile of rows goes through three
// phases separated by barriers: scores (a group's dot products, reduced
// over its TPR lanes by shuffles, into shared memory), the online softmax
// per head (one warp a head: tile max, rescale factor, p = exp(s - m)),
// and p . V into per-thread f32 accumulators. Only a tile's live rows
// (positions < length) are scored and summed: a masked position is never
// given a probability, so p = 0 there by construction, and the first
// tile's rescale factor is 0 (m starts at -inf, never a stale value).
// Group partial sums meet in shared memory once, at the end.
//
//   v1 (the per-page variant): tiles are chunks of one page (at most 2 rows
//     a group), each group loads its rows' K and V pieces straight from
//     global memory into registers: one page at a time, no staging.
//   v2: tiles are groups of G pages (G * page_size rows), staged into
//     shared memory with cp.async (16 bytes a thread, every live row of a
//     group in flight at once), double-buffered: the next group's copies
//     are issued before the current one is computed. Only rows below the
//     length are copied. G is clamped to what the 227 KB a block may use
//     holds: 2 slots x 2 tensors x G * page_size * D * esize, plus the
//     scores and the final reduction (v2_smem; the wrapper asks
//     ptt_paged_max_group). A page of K is at most kMaxPageBytes, so one
//     page group always fits, at every head dim and rep. In
//     bf16 with D >= 64 (the serving path) the two products run on the
//     tensor cores instead (paged_v2_mma_kernel below): the scalar loop's
//     chain of loads, FMAs and shuffle levels, with one block an SM and
//     nothing to hide it, cost ~10 us a 128-row group at Llama-3-8B's
//     shapes on an H100 80GB HBM3 at 700 W (PERF.md).
//
// At the 8B decode step's 4 slots x 8 KV heads there are only 32 blocks on
// 132 SMs: each block's own stream of loads bounds it (split-KV is later
// work).

#include <type_traits>

#include "common.cuh"

namespace ptt {
namespace paged {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 8;  // query heads per KV head a block can hold
constexpr int kRowsPerGroupV1 = 2;  // rows a group holds in registers (v1)
constexpr int kSmemLimit = 232448;  // dynamic shared memory of one block
// the largest page of K (or V) the kernels take: double-buffered beside
// its V, the scores and the partial sums it stays under kSmemLimit for
// every D and rep (ops/paged.py MAX_PAGE_BYTES, paged_kernel_eligible)
constexpr int kMaxPageBytes = 32 * 1024;

// Lanes of a row group and the values each holds, for rows of D values of
// type T read in 16-byte pieces.
template <typename T, int D>
struct Layout {
  static constexpr int kVec = 16 / (int)sizeof(T);  // values in a piece
  static constexpr int kPieces = D / kVec;          // pieces in a row
  static constexpr int kTpr = kPieces < 32 ? kPieces : 32;  // lanes a row
  static constexpr int kNv = kPieces / kTpr;        // pieces a lane
  static constexpr int kDpt = kNv * kVec;           // values a lane
  static constexpr int kGroups = kThreads / kTpr;   // rows in flight
  static_assert(kPieces % kTpr == 0 && (kTpr & (kTpr - 1)) == 0,
                "a row splits over a power-of-two group of lanes");
};

struct SoftmaxState {
  float m[kMaxRep];      // running max of each head
  float l[kMaxRep];      // running sum of exp(s - m)
  float alpha[kMaxRep];  // this tile's rescale factor exp(m_old - m_new)
};

__device__ __forceinline__ void piece_to_f32(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

__device__ __forceinline__ void piece_to_f32(const __nv_bfloat16* p,
                                             float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// The values of `row` that lane `lig` of a row group holds: piece
// v * TPR + lig for v < kNv (neighbouring lanes, neighbouring pieces).
template <typename T, int D>
__device__ __forceinline__ void load_row(const T* row, int lig,
                                         float (&f)[Layout<T, D>::kDpt]) {
  using L = Layout<T, D>;
#pragma unroll
  for (int v = 0; v < L::kNv; ++v)
    piece_to_f32(row + (v * L::kTpr + lig) * L::kVec, f + v * L::kVec);
}

template <typename T, int D, int REP>
__device__ __forceinline__ void zero_rows(float (&a)[REP][Layout<T, D>::kDpt]) {
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int d = 0; d < Layout<T, D>::kDpt; ++d) a[r][d] = 0.f;
}

// s[r * ld + j] = scale * q_r . K_j: the group's dot product, reduced over
// its TPR lanes. Every lane of a warp calls it (the shuffles span the
// warp); `live` says whether this group has a row j.
template <typename T, int D, int REP>
__device__ __forceinline__ void score_row(
    const float (&qf)[REP][Layout<T, D>::kDpt],
    const float (&kf)[Layout<T, D>::kDpt], bool live, int j, int rep,
    float scale, float* s, int ld, int lig) {
  using L = Layout<T, D>;
  float part[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    part[r] = 0.f;
#pragma unroll
    for (int d = 0; d < L::kDpt; ++d) part[r] += qf[r][d] * kf[d];
  }
#pragma unroll
  for (int o = L::kTpr / 2; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < REP; ++r)
      if (r < rep) part[r] += __shfl_xor_sync(0xffffffffu, part[r], o);
  if (live && lig == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r)
      if (r < rep) s[r * ld + j] = part[r] * scale;
  }
}

// One warp per head: the tile's max over its nk live scores, the rescale
// factor of the running state, and p = exp(s - m_new) written over s.
__device__ __forceinline__ void tile_softmax(float* s, int ld, int nk,
                                             int rep, SoftmaxState* st,
                                             int warp, int lane) {
  for (int r = warp; r < rep; r += kWarps) {
    float* sr = s + r * ld;
    float mx = -INFINITY;
    for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, sr[j]);
    mx = warp_max(mx);
    const float m_old = st->m[r];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float p = expf(sr[j] - m_new);
      sr[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      // the first tile rescales nothing: m starts at -inf
      const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
      st->alpha[r] = alpha;
      st->l[r] = st->l[r] * alpha + sum;
      st->m[r] = m_new;
    }
  }
}

template <typename T, int D, int REP>
__device__ __forceinline__ void rescale(float (&acc)[REP][Layout<T, D>::kDpt],
                                        const SoftmaxState* st, int rep) {
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (r >= rep) continue;
    const float a = st->alpha[r];
#pragma unroll
    for (int d = 0; d < Layout<T, D>::kDpt; ++d) acc[r][d] *= a;
  }
}

template <typename T, int D, int REP>
__device__ __forceinline__ void accumulate(
    float (&acc)[REP][Layout<T, D>::kDpt],
    const float (&vf)[Layout<T, D>::kDpt], const float* s, int ld, int j,
    int rep) {
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (r >= rep) continue;
    const float p = s[r * ld + j];
#pragma unroll
    for (int d = 0; d < Layout<T, D>::kDpt; ++d) acc[r][d] += p * vf[d];
  }
}

// Sum the groups' accumulators (red: [kGroups][rep][D] f32 in shared
// memory), divide by l (l == 0, a length-0 row, divides by 1: zeros), and
// write the block's rep heads of o.
template <typename T, int D, int REP>
__device__ __forceinline__ void finish(float (&acc)[REP][Layout<T, D>::kDpt],
                                       float* red, const SoftmaxState* st,
                                       int rep, T* out, int grp, int lig) {
  using L = Layout<T, D>;
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (r >= rep) continue;
#pragma unroll
    for (int v = 0; v < L::kNv; ++v)
#pragma unroll
      for (int e = 0; e < L::kVec; ++e)
        red[(grp * rep + r) * D + (v * L::kTpr + lig) * L::kVec + e] =
            acc[r][v * L::kVec + e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rep * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    float sum = 0.f;
    for (int g = 0; g < L::kGroups; ++g) sum += red[(g * rep + r) * D + d];
    const float l = st->l[r];
    out[i] = from_f32<T>(sum / (l == 0.f ? 1.f : l));
  }
}

// --------------------------------------------------------------------- v1
template <typename T, int D, int REP>
__global__ void __launch_bounds__(kThreads)
paged_v1_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                const T* __restrict__ v_pages,
                const int* __restrict__ lengths,
                const int* __restrict__ tables, T* __restrict__ out, int H,
                int KV, int P, int psz, int nj, float scale) {
  using L = Layout<T, D>;
  constexpr int kChunk = L::kGroups * kRowsPerGroupV1;  // rows a tile
  const int g = blockIdx.x, b = blockIdx.y;
  const int rep = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid / L::kTpr, lig = tid % L::kTpr;

  __shared__ SoftmaxState st;
  __shared__ float s[REP * kChunk];
  extern __shared__ float red[];  // [kGroups][rep][D]

  const int len = min(max(lengths[b], 0), nj * psz);
  if (tid < kMaxRep) {
    st.m[tid] = -INFINITY;
    st.l[tid] = 0.f;
    st.alpha[tid] = 0.f;
  }
  const size_t row0 = ((size_t)b * H + (size_t)g * rep) * D;
  float qf[REP][L::kDpt], acc[REP][L::kDpt];
  zero_rows<T, D, REP>(qf);
  zero_rows<T, D, REP>(acc);
#pragma unroll
  for (int r = 0; r < REP; ++r)
    if (r < rep) load_row<T, D>(q + row0 + (size_t)r * D, lig, qf[r]);
  __syncthreads();

  const size_t head = (size_t)g * P;
  for (int t0 = 0; t0 < len;) {  // uniform over the block
    const int page = t0 / psz, off = t0 - page * psz;
    const int nk = min(kChunk, min(psz - off, len - t0));
    const int phys = min(max(tables[(size_t)b * nj + page], 0), P - 1);
    const size_t base = ((head + phys) * psz + off) * D;
    float kf[kRowsPerGroupV1][L::kDpt], vf[kRowsPerGroupV1][L::kDpt];
#pragma unroll
    for (int i = 0; i < kRowsPerGroupV1; ++i) {
      const int j = grp + i * L::kGroups;
      if (j < nk) {
        load_row<T, D>(k_pages + base + (size_t)j * D, lig, kf[i]);
        load_row<T, D>(v_pages + base + (size_t)j * D, lig, vf[i]);
      } else {
#pragma unroll
        for (int d = 0; d < L::kDpt; ++d) kf[i][d] = vf[i][d] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerGroupV1; ++i) {
      const int j = grp + i * L::kGroups;
      score_row<T, D, REP>(qf, kf[i], j < nk, j, rep, scale, s, kChunk, lig);
    }
    __syncthreads();
    tile_softmax(s, kChunk, nk, rep, &st, warp, lane);
    __syncthreads();
    rescale<T, D, REP>(acc, &st, rep);
#pragma unroll
    for (int i = 0; i < kRowsPerGroupV1; ++i) {
      const int j = grp + i * L::kGroups;
      if (j < nk) accumulate<T, D, REP>(acc, vf[i], s, kChunk, j, rep);
    }
    __syncthreads();  // s and the state's alpha are the next tile's
    t0 += nk;
  }
  finish<T, D, REP>(acc, red, &st, rep, out + row0, grp, lig);
}

// --------------------------------------------------------------------- v2
template <typename T, int D, int REP>
__global__ void __launch_bounds__(kThreads)
paged_v2_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                const T* __restrict__ v_pages,
                const int* __restrict__ lengths,
                const int* __restrict__ tables, T* __restrict__ out, int H,
                int KV, int P, int psz, int nj, int G, float scale) {
  using L = Layout<T, D>;
  constexpr int kPieceVals = 16 / (int)sizeof(T);
  constexpr int kRowPieces = D / kPieceVals;
  const int g = blockIdx.x, b = blockIdx.y;
  const int rep = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid / L::kTpr, lig = tid % L::kTpr;
  const int TK = G * psz;  // rows of a group of pages

  extern __shared__ __align__(16) unsigned char smem[];
  T* kbuf = reinterpret_cast<T*>(smem);  // [2][TK][D]
  T* vbuf = kbuf + (size_t)2 * TK * D;   // [2][TK][D]
  float* s = reinterpret_cast<float*>(vbuf + (size_t)2 * TK * D);  // [rep][TK]
  float* red = s + (size_t)rep * TK;  // [kGroups][rep][D]
  __shared__ SoftmaxState st;

  const int len = min(max(lengths[b], 0), nj * psz);
  const int n_groups = (len + TK - 1) / TK;
  if (tid < kMaxRep) {
    st.m[tid] = -INFINITY;
    st.l[tid] = 0.f;
    st.alpha[tid] = 0.f;
  }
  const size_t head = (size_t)g * P;
  const int* tab = tables + (size_t)b * nj;

  // copy the live rows of page group gi into slot `slot`, 16 bytes a
  // thread a step, all of them in flight before anyone waits
  auto issue = [&](int gi, int slot) {
    const int rows = min(TK, len - gi * TK);
    T* kd = kbuf + (size_t)slot * TK * D;
    T* vd = vbuf + (size_t)slot * TK * D;
    for (int c = tid; c < rows * kRowPieces; c += kThreads) {
      const int row = c / kRowPieces, piece = c - row * kRowPieces;
      const int pos = gi * TK + row;
      const int page = pos / psz, off = pos - page * psz;
      const int phys = min(max(tab[page], 0), P - 1);
      const size_t src = ((head + phys) * psz + off) * D + piece * kPieceVals;
      const size_t dst = (size_t)row * D + piece * kPieceVals;
      cp_async16(kd + dst, k_pages + src, true);
      cp_async16(vd + dst, v_pages + src, true);
    }
    cp_async_commit();
  };
  if (n_groups > 0) issue(0, 0);

  const size_t row0 = ((size_t)b * H + (size_t)g * rep) * D;
  float qf[REP][L::kDpt], acc[REP][L::kDpt];
  zero_rows<T, D, REP>(qf);
  zero_rows<T, D, REP>(acc);
#pragma unroll
  for (int r = 0; r < REP; ++r)
    if (r < rep) load_row<T, D>(q + row0 + (size_t)r * D, lig, qf[r]);

  for (int gi = 0; gi < n_groups; ++gi) {  // uniform over the block
    const int slot = gi & 1;
    if (gi + 1 < n_groups) {
      issue(gi + 1, slot ^ 1);  // that slot was consumed in gi - 1
      cp_async_wait<1>();       // group gi has landed (this thread's part)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // ... and every thread's part, and the state
    const T* kt = kbuf + (size_t)slot * TK * D;
    const T* vt = vbuf + (size_t)slot * TK * D;
    const int nk = min(TK, len - gi * TK);
    const int iters = (nk + L::kGroups - 1) / L::kGroups;
    for (int it = 0; it < iters; ++it) {  // uniform: shuffles inside
      const int j = grp + it * L::kGroups;
      float kf[L::kDpt];
      if (j < nk) {
        load_row<T, D>(kt + (size_t)j * D, lig, kf);
      } else {
#pragma unroll
        for (int d = 0; d < L::kDpt; ++d) kf[d] = 0.f;
      }
      score_row<T, D, REP>(qf, kf, j < nk, j, rep, scale, s, TK, lig);
    }
    __syncthreads();
    tile_softmax(s, TK, nk, rep, &st, warp, lane);
    __syncthreads();
    rescale<T, D, REP>(acc, &st, rep);
    for (int j = grp; j < nk; j += L::kGroups) {
      float vf[L::kDpt];
      load_row<T, D>(vt + (size_t)j * D, lig, vf);
      accumulate<T, D, REP>(acc, vf, s, TK, j, rep);
    }
    __syncthreads();  // the slot, s and alpha are rewritten next
  }
  finish<T, D, REP>(acc, red, &st, rep, out + row0, grp, lig);
}

// ---------------------------------------------------------- v2, bf16 mma
// The bf16 path of v2 for D >= 64: the block's rep query heads are rows
// 0..rep-1 of one 16-row A operand (the rest zero), so q . K^T over a
// 16-row slice of the group is D / 16 mma.sync m16n8k16 pairs and p . V
// one mma a k-step and 8 columns; each warp takes every fourth 16-row
// slice for the scores and a quarter of D for the output, which stays in
// its accumulators (no cross-warp sum). Rows are padded to D + 8 values
// in shared memory, so ldmatrix is free of bank conflicts; rows from the
// live count up to the next multiple of 16 are zero-filled, so a k-step's
// spare rows add p = 0 times 0. p is rounded to bf16 before p . V, with
// f32 accumulation (as the flash kernel does).
using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&t);
}

__device__ __forceinline__ int round16(int n) { return (n + 15) & ~15; }

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_v2_mma_kernel(const bf16* __restrict__ q,
                    const bf16* __restrict__ k_pages,
                    const bf16* __restrict__ v_pages,
                    const int* __restrict__ lengths,
                    const int* __restrict__ tables, bf16* __restrict__ out,
                    int H, int KV, int P, int psz, int nj, int G,
                    float scale) {
  constexpr int LD = D + 8;             // padded row, in values
  constexpr int kRowPieces = D / 8;     // 16-byte pieces in a row
  constexpr int DW = D / kWarps;        // output columns a warp
  const int g = blockIdx.x, b = blockIdx.y;
  const int rep = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qr = lane >> 2, qc = (lane & 3) * 2;  // mma fragment row, col
  const int TK = G * psz, TKP = round16(TK);

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* kbuf = reinterpret_cast<bf16*>(smem);      // [2][TKP][LD]
  bf16* vbuf = kbuf + (size_t)2 * TKP * LD;        // [2][TKP][LD]
  float* s = reinterpret_cast<float*>(vbuf + (size_t)2 * TKP * LD);
  __shared__ SoftmaxState st;                      // s: [rep][TKP]

  const int len = min(max(lengths[b], 0), nj * psz);
  const int n_groups = (len + TK - 1) / TK;
  if (tid < kMaxRep) {
    st.m[tid] = -INFINITY;
    st.l[tid] = 0.f;
    st.alpha[tid] = 0.f;
  }
  const size_t head = (size_t)g * P;
  const int* tab = tables + (size_t)b * nj;

  // the live rows of group gi, and zeros up to the next 16, into `slot`
  auto issue = [&](int gi, int slot) {
    const int rows = min(TK, len - gi * TK);
    bf16* kd = kbuf + (size_t)slot * TKP * LD;
    bf16* vd = vbuf + (size_t)slot * TKP * LD;
    for (int c = tid; c < round16(rows) * kRowPieces; c += kThreads) {
      const int row = c / kRowPieces, piece = (c - row * kRowPieces) * 8;
      const bool live = row < rows;
      size_t src = 0;
      if (live) {
        const int pos = gi * TK + row;
        const int page = pos / psz, off = pos - page * psz;
        const int phys = min(max(tab[page], 0), P - 1);
        src = ((head + phys) * psz + off) * D + piece;
      }
      cp_async16(kd + row * LD + piece, k_pages + src, live);
      cp_async16(vd + row * LD + piece, v_pages + src, live);
    }
    cp_async_commit();
  };
  if (n_groups > 0) issue(0, 0);

  // q as A fragments: row qr = head qr (zero past rep), rows 8-15 zero
  const size_t row0 = ((size_t)b * H + (size_t)g * rep) * D;
  unsigned qa[D / 16][2];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = qa[kk][1] = 0u;
    if (qr < rep) {
      const bf16* qrow = q + row0 + (size_t)qr * D + kk * 16 + qc;
      qa[kk][0] = *reinterpret_cast<const unsigned*>(qrow);
      qa[kk][1] = *reinterpret_cast<const unsigned*>(qrow + 8);
    }
  }
  float acc[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int gi = 0; gi < n_groups; ++gi) {  // uniform over the block
    const int slot = gi & 1;
    if (gi + 1 < n_groups) {
      issue(gi + 1, slot ^ 1);  // that slot was consumed in gi - 1
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = kbuf + (size_t)slot * TKP * LD;
    const bf16* vt = vbuf + (size_t)slot * TKP * LD;
    const int nk = min(TK, len - gi * TK), nk16 = round16(nk);

    // scores: warp w takes rows [16 c, 16 c + 16) for c = w, w + 4, ...
    for (int c = warp; c < nk16 / 16; c += kWarps) {
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        unsigned bfr[4];
        ldsm_x4(bfr, kt + (c * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                         kk * 16 + ((lane >> 3) & 1) * 8);
        const unsigned a[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
        mma_bf16(sc[0], a, bfr[0], bfr[1]);
        mma_bf16(sc[1], a, bfr[2], bfr[3]);
      }
      if (qr < rep) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = c * 16 + h * 8 + qc + e;
            if (j < nk) s[qr * TKP + j] = sc[h][e] * scale;
          }
      }
    }
    __syncthreads();
    tile_softmax(s, TKP, nk, rep, &st, warp, lane);
    for (int i = tid; i < rep * (nk16 - nk); i += kThreads) {
      const int r = i / (nk16 - nk);
      s[r * TKP + nk + (i - r * (nk16 - nk))] = 0.f;  // p of spare rows
    }
    __syncthreads();

    // o += p . V over this warp's DW columns
    const float alpha = qr < rep ? st.alpha[qr] : 0.f;
#pragma unroll
    for (int n = 0; n < DW / 8; ++n) {
      acc[n][0] *= alpha;
      acc[n][1] *= alpha;
    }
    for (int kk = 0; kk < nk16 / 16; ++kk) {
      unsigned a[4] = {0u, 0u, 0u, 0u};
      if (qr < rep) {
        const float* pr = s + qr * TKP + kk * 16 + qc;
        a[0] = pack2(pr[0], pr[1]);
        a[2] = pack2(pr[8], pr[9]);
      }
#pragma unroll
      for (int dp = 0; dp < DW / 16; ++dp) {
        unsigned bfr[4];
        ldsm_x4_trans(bfr, vt + (kk * 16 + (lane & 15)) * LD + warp * DW +
                               dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], a, bfr[0], bfr[1]);
        mma_bf16(acc[2 * dp + 1], a, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // the slot, s and alpha are rewritten next
  }
  if (qr < rep) {
    const float l = st.l[qr];
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    bf16* orow = out + row0 + (size_t)qr * D + warp * DW + qc;
#pragma unroll
    for (int n = 0; n < DW / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(acc[n][0] * inv, acc[n][1] * inv);
  }
}

// Whether v2 takes the bf16 mma path.
template <typename T, int D>
constexpr bool uses_mma() {
  return sizeof(T) == 2 && D >= 64;
}

// Bytes of dynamic shared memory v2 takes.
template <typename T, int D>
static size_t v2_smem(int G, int psz, int rep) {
  const size_t tk = (size_t)G * psz;
  if (uses_mma<T, D>()) {
    const size_t tkp = (tk + 15) / 16 * 16;
    return 4 * tkp * (D + 8) * sizeof(T) + 4 * (size_t)rep * tkp;
  }
  return 4 * tk * D * sizeof(T) + 4 * (size_t)rep * tk +
         4 * (size_t)Layout<T, D>::kGroups * rep * D;
}

// The largest group of pages whose v2 buffers fit a block (0: none).
template <typename T, int D>
static int max_group(int psz, int rep) {
  const size_t room = (size_t)kSmemLimit - sizeof(SoftmaxState);
  int G = 0;
  while (v2_smem<T, D>(G + 1, psz, rep) <= room) ++G;
  return G;
}

struct Args {
  const void *q, *kp, *vp;
  const int *lengths, *tables;
  void* out;
  int B, H, KV, P, psz, nj, G;
  float scale;
  cudaStream_t st;
};

template <typename T, int D, int REP>
static int launch_v1(const Args& a) {
  const size_t smem =
      (size_t)Layout<T, D>::kGroups * (a.H / a.KV) * D * sizeof(float);
  paged_v1_kernel<T, D, REP><<<dim3(a.KV, a.B), kThreads, smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kp),
      static_cast<const T*>(a.vp), a.lengths, a.tables, static_cast<T*>(a.out),
      a.H, a.KV, a.P, a.psz, a.nj, a.scale);
  return (int)cudaGetLastError();
}

// v2 takes shared memory past the 48 KB default: opt in, then launch
template <typename T, int D, typename Kernel, typename... KArgs>
static int launch_v2(const Args& a, Kernel kernel, KArgs... kargs) {
  const size_t smem = v2_smem<T, D>(a.G, a.psz, a.H / a.KV);
  if (smem > (size_t)kSmemLimit - sizeof(SoftmaxState))
    return (int)cudaErrorInvalidValue;  // G past max_group
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(a.KV, a.B), kThreads, smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kp),
      static_cast<const T*>(a.vp), a.lengths, a.tables, static_cast<T*>(a.out),
      kargs...);
  return (int)cudaGetLastError();
}

template <typename T, int D, int REP>
static int launch(const Args& a, bool v2) {
  if (!v2) return launch_v1<T, D, REP>(a);
  if constexpr (uses_mma<T, D>()) {  // any rep <= kMaxRep: A's rows
    return launch_v2<T, D>(a, paged_v2_mma_kernel<D>, a.H, a.KV, a.P, a.psz,
                           a.nj, a.G, a.scale);
  } else {
    return launch_v2<T, D>(a, paged_v2_kernel<T, D, REP>, a.H, a.KV, a.P,
                           a.psz, a.nj, a.G, a.scale);
  }
}

template <typename T, int D>
static int dispatch_rep(const Args& a, bool v2) {
  const int rep = a.H / a.KV;
  if (rep <= 4) return launch<T, D, 4>(a, v2);
  return launch<T, D, kMaxRep>(a, v2);
}

// f(std::integral_constant<int, D>) for the head dims the kernels are
// built for; cudaErrorInvalidValue for any other
template <typename F>
static int with_head_dim(int D, F f) {
  switch (D) {
    case 32:
      return f(std::integral_constant<int, 32>());
    case 64:
      return f(std::integral_constant<int, 64>());
    case 128:
      return f(std::integral_constant<int, 128>());
    case 256:
      return f(std::integral_constant<int, 256>());
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
static int dispatch_d(int D, const Args& a, bool v2) {
  return with_head_dim(D, [&](auto d) {
    return dispatch_rep<T, decltype(d)::value>(a, v2);
  });
}

static int run(const Args& a, int D, int dtype, bool v2) {
  const int esize = dtype == kF32 ? 4 : 2;
  if (a.KV <= 0 || a.H % a.KV || a.H / a.KV > kMaxRep || a.psz < 1 ||
      (size_t)a.psz * D * esize > (size_t)kMaxPageBytes || a.nj < 1 ||
      a.P < 1 || (v2 && a.G < 1))
    return (int)cudaErrorInvalidValue;
  if (a.B == 0) return (int)cudaSuccess;
  if (dtype == kF32) return dispatch_d<float>(D, a, v2);
  if (dtype == kBF16) return dispatch_d<__nv_bfloat16>(D, a, v2);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int max_group_d(int D, int psz, int rep, int* out) {
  return with_head_dim(D, [&](auto d) {
    *out = max_group<T, decltype(d)::value>(psz, rep);
    return (int)cudaSuccess;
  });
}

}  // namespace paged
}  // namespace ptt

using namespace ptt;

extern "C" {

// q [B, H, D]; k/v_pages [KV, P, psz, D]; lengths [B] int32; tables
// [B, nj] int32 -> out [B, H, D]. v1: one page at a time from global
// memory.
int ptt_paged_decode_v1(const void* q, const void* k_pages,
                        const void* v_pages, const void* lengths,
                        const void* tables, void* out, int B, int H, int KV,
                        int D, int P, int psz, int nj, float scale, int dtype,
                        int device, void* stream) {
  PTT_SET_DEVICE(device);
  const paged::Args a{q,   k_pages, v_pages, static_cast<const int*>(lengths),
                      static_cast<const int*>(tables), out, B, H, KV, P, psz,
                      nj,  1,       scale,   static_cast<cudaStream_t>(stream)};
  return paged::run(a, D, dtype, false);
}

// The same, v2: groups of G pages staged in shared memory by cp.async,
// double-buffered.
// *out = the largest group of pages v2 can stage for pages of psz rows of
// D values of `dtype` and rep query heads a KV head (0: none); the
// wrapper clamps pages_per_group to it. Host only, launches nothing.
int ptt_paged_max_group(int psz, int D, int rep, int dtype, int* out) {
  if (psz < 1 || rep < 1 || rep > paged::kMaxRep)
    return (int)cudaErrorInvalidValue;
  if (dtype == kF32) return paged::max_group_d<float>(D, psz, rep, out);
  if (dtype == kBF16)
    return paged::max_group_d<__nv_bfloat16>(D, psz, rep, out);
  return (int)cudaErrorInvalidValue;
}

int ptt_paged_decode_v2(const void* q, const void* k_pages,
                        const void* v_pages, const void* lengths,
                        const void* tables, void* out, int B, int H, int KV,
                        int D, int P, int psz, int nj, int G, float scale,
                        int dtype, int device, void* stream) {
  PTT_SET_DEVICE(device);
  const paged::Args a{q,   k_pages, v_pages, static_cast<const int*>(lengths),
                      static_cast<const int*>(tables), out, B, H, KV, P, psz,
                      nj,  G,       scale,   static_cast<cudaStream_t>(stream)};
  return paged::run(a, D, dtype, true);
}

}  // extern "C"
