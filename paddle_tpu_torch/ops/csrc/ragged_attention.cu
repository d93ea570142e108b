// ragged_paged_attention for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas_ragged.py:ragged_paged_attention
//           (Pallas _ragged_kernel).
//
// What it computes: one launch over a flat [T, H, D] query buffer that
// mixes decode rows (one new token per sequence) with a prefill chunk.
// Sequence i owns rows [seq_start[i], seq_start[i] + num_tokens[i]); its
// local token t attends KV positions 0 .. kv_lengths[i] - num_tokens[i] + t
// of its paged cache (GQA: query head h reads KV head h / rep). Rows no
// sequence owns, and sequences with num_tokens == 0, yield zeros. Table
// entries are clamped to [0, P-1] (a -1 sentinel reads page 0, and only
// past kv_lengths, where nothing is staged).
//
// Bound on the H100: the bytes. Each visible key row of each KV head is
// read once, D * itemsize for K and again for V (once for both when the
// two pools are one tensor, as the MLA engine passes them), plus q, the
// output and the row tables, at 3.35 TB/s. The products, 4 H D flops a
// visible (query, key) pair, take less than that at the bf16 tensor
// peak: the 8B step's 128-token chunk is ~0.7 GFLOP, 0.7 us at 989
// TFLOP/s, against ~3.4 us of bytes. The bf16 kernel reads several
// times its bound at the 8B step (PERF.md row 3): most of an item's time
// is the latency of its dependent steps (the row tables, the pages, the
// partials' fence and merge), a few us an item, not bandwidth.
//
// bf16 (tensor cores; replaces a CUDA-core kernel, kept below for f32,
// that gave each (16-row tile, KV head, sequence) one block walking the
// sequence's whole context page by page, a 5-step shuffle sum a key and
// f32 staging; 180x its bound at the 8B step):
// - Split-KV. A work item is (sequence, KV head, 16-row query tile, key
//   split). Query rows are token-major: the rep heads of one token are
//   adjacent rows of the tile (a decode token at rep 4 is 4 live rows of
//   16; DeepSeek-V2's 16 latent heads fill one tile). The split size is a
//   function of the shapes only (`ragged_split_plan` in ops/ragged.py):
//   few decode sequences still put about a block on every SM, and the
//   host never reads the lengths or the tables.
// - A persistent grid (as many blocks as the card holds at once) walks the
//   live items, which each block enumerates on the card from num_tokens
//   and kv_lengths (a prefix over the sequences in shared memory, items
//   ordered sequence, KV head, tile, split), so idle slots, the idle chunk
//   of a decode-only step and splits past a tile's last visible key cost a
//   few loads. A sequence whose tiles alone give half the SMs an item (a
//   prefill chunk) is not split: its splits would only add partials. The
//   blocks also write the zeros of every output row no item writes (the
//   output is not pre-zeroed: one pass less a call).
// - Keys stream through a ring of NSTG stages of BK keys (16-byte
//   cp.async into rows padded by 16 bytes, so that ldmatrix's 8 rows fall
//   on 8 bank groups), NSTG - 1 stages in flight while one is consumed.
//   The split's table entries are read once into shared memory (SPG at
//   most), so no stage waits on the table; rows past the split's last
//   visible key are zero-filled by cp.async's src-size, never read (the
//   pool holds garbage, even NaN, there). When K and V are one tensor a
//   stage holds one copy, read as both.
// - 4 warps a block, as KW key groups of CW warps. Each key group takes
//   16 keys of every stage. Its CW warps split S = Q K^T's k16 steps
//   (the partial tiles meet in shared memory, summed in warp order) and
//   O's columns: D <= 128: CW 1, KW 4 (BK 64); D 256: CW 2, KW 2 (BK 32);
//   D 576: CW 4, KW 1 (BK 16; 16 x 576 f32 of O is 72 registers a lane).
// - mma.sync m16n8k16 (bf16 in, f32 sums), B by ldmatrix (K) and
//   ldmatrix.trans (V) from the same staged rows; online softmax in f32
//   (ex2.approx, scale . log2 e folded); P rounded to bf16 in registers as
//   the A operand of O += P V, where the TPU kernel rounds it
//   (p.astype(v.dtype)); l sums the unrounded p.
// - The key groups of a block merge through shared memory; an item whose
//   tile has one split writes its rows. Otherwise it writes its f32 (acc,
//   m, l), register-major (a warp's stores are 512 contiguous bytes), and
//   counts itself on its tile's counter; the last split to arrive merges
//   (M = max m_s over splits with l_s > 0; o = sum acc_s e^(m_s - M) /
//   sum l_s e^(m_s - M)) and sets the counter back to 0 for the next
//   launch on the stream (the wrapper keeps counters per device and
//   stream).
//
// f32 (CUDA cores, true f32 products for the 2e-5 gate): each block owns
// one (row tile, KV head g, sequence i): a tile of ROWS = 16 query rows of
// that sequence's rep-wide head group (token-major), so sequences and
// heads spread over the SMs and no two blocks write the same output row. A
// block walks only the pages its rows can see (causal page skip); it
// stages each K/V page in shared memory as f32, and each warp scores its
// query rows against the page with one lane per dimension slice (D/32
// dims a lane, interleaved so shared loads are conflict-free), keeps the
// scores of a 32-key chunk one per lane, and updates an f32 online
// softmax per row. At the MLA width (KV 1, D 576, rep 16, one pool as K
// and V) the block stages each page once and reads it as both, taking the
// dynamic shared-memory opt-in above 48 KB, and runs 8 warps of 2 rows.

#include "common.cuh"

namespace ptt {

constexpr int kRows = 16;  // query rows per block: kWarps x kRowsPerWarp

// (warps, rows a warp) of a block for DPL dims a lane
template <int DPL>
struct RowSplit {
  static constexpr int kWarps = DPL > 8 ? 8 : 4;
  static constexpr int kRowsPerWarp = kRows / kWarps;
};

template <typename T, int DPL>
__global__ void __launch_bounds__(RowSplit<DPL>::kWarps * 32)
ragged_attention_kernel(const T* __restrict__ q,
                        const T* __restrict__ k_pages,
                        const T* __restrict__ v_pages,
                        const int* __restrict__ seq_start,
                        const int* __restrict__ num_tokens,
                        const int* __restrict__ kv_lengths,
                        const int* __restrict__ tables, T* __restrict__ out,
                        int H, int KV, int P, int psz, int nj, float scale,
                        int same_pool) {
  constexpr int D = 32 * DPL;
  constexpr int kWarps = RowSplit<DPL>::kWarps;
  constexpr int kRowsPerWarp = RowSplit<DPL>::kRowsPerWarp;
  const int g = blockIdx.y, i = blockIdx.z;
  const int rep = H / KV;
  const int nt = num_tokens[i];
  const int rows = nt * rep;
  const int r0 = blockIdx.x * kRows;
  if (r0 >= rows) return;  // uniform over the block, before any barrier
  const int start = seq_start[i];
  const int kvl = kv_lengths[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  extern __shared__ float smem[];
  float* ks = smem;                           // [psz][D]
  float* vs = same_pool ? smem : smem + psz * D;  // [psz][D]

  float qv[kRowsPerWarp][DPL], acc[kRowsPerWarp][DPL];
  float m[kRowsPerWarp], l[kRowsPerWarp];
  int limit[kRowsPerWarp];
  size_t orow[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = r0 + warp + kWarps * r;  // rows interleave over warps
    m[r] = -INFINITY;
    l[r] = 0.f;
    limit[r] = -1;  // no key visible: an invalid row does no work
    orow[r] = 0;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[r][d] = qv[r][d] = 0.f;
    if (row < rows) {
      const int t = row / rep;
      const int head = g * rep + (row - t * rep);
      limit[r] = kvl - nt + t;
      orow[r] = ((size_t)(start + t) * H + head) * D;
#pragma unroll
      for (int d = 0; d < DPL; ++d) qv[r][d] = to_f32(q[orow[r] + d * 32 + lane]);
    }
  }

  // keys visible to any row of this tile: positions <= the last row's limit
  const int last_t = (min(r0 + kRows, rows) - 1) / rep;
  const int kv_hi = min(kvl, kvl - nt + last_t + 1);
  const int n_pages = kv_hi > 0 ? (kv_hi + psz - 1) / psz : 0;
  const size_t head_base = (size_t)g * P;

  for (int j = 0; j < n_pages; ++j) {
    const int phys = min(max(tables[(size_t)i * nj + min(j, nj - 1)], 0),
                         P - 1);
    const size_t pbase = (head_base + phys) * psz * D;
    __syncthreads();  // the previous page is consumed by every warp
    for (int e = threadIdx.x; e < psz * D; e += blockDim.x) {
      ks[e] = to_f32(k_pages[pbase + e]);
      if (!same_pool) vs[e] = to_f32(v_pages[pbase + e]);
    }
    __syncthreads();
    const int page_pos = j * psz;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      if (limit[r] < page_pos) continue;  // warp-uniform: nothing visible
      for (int p0 = 0; p0 < psz; p0 += 32) {
        const int pc = min(32, psz - p0);
        float my_s = -INFINITY;  // lane p holds key p0 + p's score
        for (int p = 0; p < pc; ++p) {
          const float* kr = ks + (p0 + p) * D;
          float part = 0.f;
#pragma unroll
          for (int d = 0; d < DPL; ++d) part += qv[r][d] * kr[d * 32 + lane];
          const float sc = warp_sum(part) * scale;
          if (lane == p && page_pos + p0 + p <= limit[r]) my_s = sc;
        }
        const float cmax = warp_max(my_s);
        if (cmax == -INFINITY) continue;  // warp-uniform: chunk masked
        const float m_new = fmaxf(m[r], cmax);
        const float alpha = expf(m[r] - m_new);
        const float pj = my_s == -INFINITY ? 0.f : expf(my_s - m_new);
        l[r] = l[r] * alpha + warp_sum(pj);
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[r][d] *= alpha;
        for (int p = 0; p < pc; ++p) {
          const float pp = __shfl_sync(0xffffffffu, pj, p);
          const float* vr = vs + (p0 + p) * D;
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[r][d] += pp * vr[d * 32 + lane];
        }
        m[r] = m_new;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (r0 + warp + kWarps * r >= rows) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
#pragma unroll
    for (int d = 0; d < DPL; ++d)
      out[orow[r] + d * 32 + lane] = from_f32<T>(acc[r][d] * inv);
  }
}

template <typename T, int DPL>
static int launch_ragged(const void* q, const void* kp, const void* vp,
                         const int* ss, const int* nt, const int* kvl,
                         const int* tab, void* out, int T_rows, int H, int KV,
                         int P, int psz, int S, int nj, float scale,
                         cudaStream_t st) {
  constexpr int D = 32 * DPL;
  const int rep = H / KV;
  dim3 grid((T_rows * rep + kRows - 1) / kRows, KV, S);
  const int same = kp == vp;
  const size_t smem = (size_t)(same ? 1 : 2) * psz * D * sizeof(float);
  auto kern = ragged_attention_kernel<T, DPL>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, RowSplit<DPL>::kWarps * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), ss, nt, kvl, tab, static_cast<T*>(out), H,
      KV, P, psz, nj, scale, same);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_d(int D, const void* q, const void* kp, const void* vp,
                      const int* ss, const int* nt, const int* kvl,
                      const int* tab, void* out, int T_rows, int H, int KV,
                      int P, int psz, int S, int nj, float scale,
                      cudaStream_t st) {
  switch (D) {
    case 32:
      return launch_ragged<T, 1>(q, kp, vp, ss, nt, kvl, tab, out, T_rows, H,
                                 KV, P, psz, S, nj, scale, st);
    case 64:
      return launch_ragged<T, 2>(q, kp, vp, ss, nt, kvl, tab, out, T_rows, H,
                                 KV, P, psz, S, nj, scale, st);
    case 128:
      return launch_ragged<T, 4>(q, kp, vp, ss, nt, kvl, tab, out, T_rows, H,
                                 KV, P, psz, S, nj, scale, st);
    case 256:
      return launch_ragged<T, 8>(q, kp, vp, ss, nt, kvl, tab, out, T_rows, H,
                                 KV, P, psz, S, nj, scale, st);
    case 576:  // the MLA latent row, r + dr = 512 + 64
      return launch_ragged<T, 18>(q, kp, vp, ss, nt, kvl, tab, out, T_rows,
                                  H, KV, P, psz, S, nj, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}


// ------------------------------------------------- bf16, on tensor cores
namespace rag {

using bf16 = __nv_bfloat16;

// The tiling of head dim D (see the header): CW warps a key group, KW key
// groups, BK keys a stage, NSTG stages.
template <int D>
struct Cfg {
  static constexpr int CW = D <= 128 ? 1 : (D <= 256 ? 2 : 4);
  static constexpr int KW = 4 / CW;
  static constexpr int BK = 16 * KW;
  static constexpr int NSTG = D == 128 || D == 256 ? 3 : 4;
  static constexpr int DC = D / CW;      // O columns a warp
  static constexpr int NB = DC / 8;      // n8 tiles of O a warp
  static constexpr int QS = D / 16 / CW; // k16 steps of S a warp
  static constexpr int RS = 2 * D + 16;  // bytes a staged row, padded
  static constexpr int CH = D / 8;       // 16-byte pieces a row
  static_assert(NB % 2 == 0 && (D / 16) % CW == 0, "tiling");
};

//: table entries a split may span (the wrapper bounds its keys a split
//: by (SPG - 1) * page_size)
constexpr int SPG = 512;

// Shared memory of a block: the q tile, the ring, the partial score tiles
// (CW > 1), the split's pages; the sequences' item prefix and rows follow
// (`seq_smem`).
template <int D, bool SAME>
__host__ __device__ constexpr size_t fixed_smem() {
  using C = Cfg<D>;
  return (size_t)16 * C::RS +
         (size_t)C::NSTG * C::BK * C::RS * (SAME ? 1 : 2) +
         (C::CW > 1 ? 4 * 256 * sizeof(float) : 0) + SPG * sizeof(int);
}
__host__ __device__ constexpr size_t seq_smem(int S) {
  return (size_t)(5 * S + 1) * sizeof(int);
}

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* ss;
  const int* nt;
  const int* kvl;
  const int* tab;
  bf16* out;
  float* part;  // [max_items][16 * D] f32 sums, register-major
  float* pml;   // [max_items][16][2] (m, l) a row
  int* cnt;     // [max_items] counters, zero between launches
  int T, H, KV, rep, P, psz, S, nj, cap, split, max_items;
  int psz_shift;  // log2(psz), or -1 where psz is no power of two
  int wide;       // a sequence of KV x tiles >= wide items and at most
  int whole;      // `whole` keys is not split (its pages fit SPG)
  float sl2;      // scale * log2(e)
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Barrier `id` over the `n` threads of a key group.
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Sequence i's rows in the buffer and its items' extent.
struct Seq {
  int start, nt, kvl, rows, tiles, spl;
};
__device__ __forceinline__ Seq seq_of(const Args& a, int i) {
  Seq s;
  s.start = a.ss[i];
  s.nt = a.nt[i];
  s.kvl = a.kvl[i];
  const int n = s.start < 0 || s.start >= a.T
                    ? 0
                    : min(max(s.nt, 0), a.T - s.start);
  const int hi = min(s.kvl, a.cap);
  s.rows = n * a.rep;
  const bool live = n > 0 && hi > 0;
  s.tiles = live ? (s.rows + 15) / 16 : 0;
  // a sequence whose tiles alone fill the card (a prefill chunk) is not
  // split: its tiles' splits would only add partials to merge
  s.spl = !live ? 0
          : a.KV * s.tiles >= a.wide && hi <= a.whole
              ? 1
              : (hi + a.split - 1) / a.split;
  return s;
}

template <int D, bool SAME>
__global__ void __launch_bounds__(128) ragged_split_kernel(const Args a) {
  using C = Cfg<D>;
  constexpr int CW = C::CW, KW = C::KW, BK = C::BK, NSTG = C::NSTG;
  constexpr int NB = C::NB, QS = C::QS, RS = C::RS, CH = C::CH, DC = C::DC;
  constexpr int STAGE_K = BK * RS, STAGE = STAGE_K * (SAME ? 1 : 2);
  static_assert((size_t)NSTG * STAGE >=
                    (KW * 32 + (KW - 1) * 16 * D) * sizeof(float),
                "the key groups' merge fits in the ring");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sq = smem;                    // [16][RS]
  unsigned char* ring = sq + 16 * RS;          // [NSTG][K (, V)][BK][RS]
  float* sx = reinterpret_cast<float*>(ring + NSTG * STAGE);  // [4][256]
  int* spg = reinterpret_cast<int*>(smem + fixed_smem<D, SAME>()) - SPG;
  int* base = spg + SPG;       // [S + 1] the sequences' first items
  int* s_start = base + a.S + 1;  // [S] first row
  int* s_n = s_start + a.S;       // [S] rows in the buffer (tokens)
  int* s_lim0 = s_n + a.S;        // [S] kv_lengths - num_tokens
  int* s_spl = s_lim0 + a.S;      // [S] splits
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int kw = w / CW, cw = w % CW;
  const int g = lane >> 2, c = lane & 3;

  // base[i]: the first item of sequence i (warp 0, 32 sequences a pass)
  if (w == 0) {
    int carry = 0;
    for (int c0 = 0; c0 < a.S; c0 += 32) {
      const int i = c0 + lane;
      int v = 0;
      if (i < a.S) {
        const Seq s = seq_of(a, i);
        v = a.KV * s.tiles * s.spl;
        s_start[i] = s.start;
        s_n[i] = s.rows / a.rep;
        s_lim0[i] = s.kvl - s.nt;
        s_spl[i] = s.spl;
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int n = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += n;
      }
      if (i < a.S) base[i + 1] = carry + v;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
    if (lane == 0) base[0] = 0;
  }
  __syncthreads();
  // more items than the wrapper's plan sized for (only row ranges that
  // overlap, which the contract rules out, make more): stop the launch
  // with an error rather than drop items or write past the workspace
  if (base[a.S] > a.max_items) __trap();
  const int total = base[a.S];

  // zeros into the output rows no item writes: (token, head) rows no
  // sequence owns, and rows of tiles that see no key (the wrapper does
  // not pre-zero the output)
  for (int pr = blockIdx.x * 128 + tid; pr < a.T * a.H;
       pr += gridDim.x * 128) {
    const int t = pr / a.H, h = pr - t * a.H;
    bool written = false;
    for (int i = 0; i < a.S; ++i) {
      const int lt = t - s_start[i];
      if (lt < 0 || lt >= s_n[i]) continue;
      const int gk = h / a.rep;
      const int r = lt * a.rep + h - gk * a.rep;
      const int last_t = (min((r & ~15) + 16, s_n[i] * a.rep) - 1) / a.rep;
      written = min(s_lim0[i] + last_t + 1, a.cap) > 0;
      break;
    }
    if (!written) {
      uint4* dst = reinterpret_cast<uint4*>(a.out + (size_t)pr * D);
#pragma unroll
      for (int x = 0; x < D / 8; ++x) dst[x] = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    // the item's sequence: the last i with base[i] <= item
    int lo = 0, hi = a.S - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (base[mid] <= item)
        lo = mid;
      else
        hi = mid - 1;
    }
    const int i = lo;
    const int start = s_start[i], rows = s_n[i] * a.rep, spl = s_spl[i];
    const int tiles = (rows + 15) / 16;
    const int lim0 = s_lim0[i];  // token t sees keys <= lim0 + t
    int r = item - base[i];
    const int s = r % spl;
    r /= spl;
    const int qt = r % tiles, gk = r / tiles;
    const int r0 = qt * 16;
    const int last_t = (min(r0 + 16, rows) - 1) / a.rep;
    const int tile_hi = min(lim0 + last_t + 1, a.cap);
    const int ns = tile_hi <= 0 ? 0 : spl == 1 ? 1
                                               : (tile_hi + a.split - 1) / a.split;
    if (s >= ns) continue;  // no key of this split is visible to the tile
    const int k0 = s * a.split;
    const int k1 = ns == 1 ? tile_hi : min(k0 + a.split, tile_hi);
    const int n_st = (k1 - k0 + BK - 1) / BK;

    // this lane's rows g and g + 8: their outputs and key ends
    bool rv[2];
    int hi_row[2];
    size_t orow[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = r0 + g + 8 * e;
      rv[e] = row < rows;
      hi_row[e] = k0;  // no key
      orow[e] = 0;
      if (rv[e]) {
        const int t = row / a.rep;
        const int head = gk * a.rep + row - t * a.rep;
        hi_row[e] = min(lim0 + t + 1, k1);
        orow[e] = ((size_t)(start + t) * a.H + head) * D;
      }
    }

    __syncthreads();  // the previous item is done with sq, spg, the ring
    // the q tile (rows past the sequence's zero-filled), in group 0
    for (int x = tid; x < 16 * CH; x += 128) {
      const int rr = x / CH, kc = x % CH;
      const int row = r0 + rr;
      const bool ok = row < rows;
      const bf16* src = a.q;
      if (ok) {
        const int t = row / a.rep;
        src = a.q + ((size_t)(start + t) * a.H + gk * a.rep + row -
                     t * a.rep) * D + 8 * kc;
      }
      cp_async16(sq + rr * RS + 16 * kc, src, ok);
    }
    // the split's table entries, clamped to the pool
    const int j0 = k0 / a.psz;
    for (int x = tid; x <= (k1 - 1) / a.psz - j0; x += 128)
      spg[x] = min(max(a.tab[(size_t)i * a.nj + j0 + x], 0), a.P - 1);
    __syncthreads();
    // keys [k0 + st BK, + BK) into stage st % NSTG; keys at or past k1
    // zero-filled
    auto load = [&](int st) {
      unsigned char* dst = ring + (st % NSTG) * STAGE;
      const int p0 = k0 + st * BK;
      static_assert(BK * CH % 128 == 0, "whole pieces a thread");
#pragma unroll
      for (int u = 0; u < BK * CH / 128; ++u) {
        const int x = tid + 128 * u;
        const int rr = x / CH, kc = x % CH;
        const int p = p0 + rr;
        const bool ok = p < k1;
        size_t off = 0;
        if (ok) {
          const int j = a.psz_shift >= 0 ? p >> a.psz_shift : p / a.psz;
          off = (((size_t)gk * a.P + spg[j - j0]) * a.psz + (p - j * a.psz)) *
                    D +
                8 * kc;
        }
        cp_async16(dst + rr * RS + 16 * kc, a.k + off, ok);
        if constexpr (!SAME)
          cp_async16(dst + STAGE_K + rr * RS + 16 * kc, a.v + off, ok);
      }
    };
#pragma unroll
    for (int x = 0; x < NSTG - 1; ++x) {
      if (x < n_st) load(x);
      cp_async_commit();
    }

    uint32_t qa[QS][4];
    float o[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int it = 0; it < n_st; ++it) {
      cp_async_wait<NSTG - 2>();
      __syncthreads();  // stage it landed; every warp done with it - 1
      if (it == 0) {
#pragma unroll
        for (int j = 0; j < QS; ++j)
          ldsm_x4(qa[j], sq + (lane & 15) * RS +
                             2 * (16 * (cw + CW * j) + 8 * (lane >> 4)));
      }
      if (it + NSTG - 1 < n_st) load(it + NSTG - 1);
      cp_async_commit();
      const unsigned char* kst = ring + (it % NSTG) * STAGE + kw * 16 * RS;
      const unsigned char* vst = SAME ? kst : kst + STAGE_K;

      // S over this warp's k16 steps: [16 rows][16 keys of the group]
      float sv[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int j = 0; j < QS; ++j) {
        unsigned kb[4];
        ldsm_x4(kb, kst + ((lane & 7) + 8 * (lane >> 4)) * RS +
                        2 * (16 * (cw + CW * j) + 8 * ((lane >> 3) & 1)));
        mma_bf16(sv[0], qa[j], kb[0], kb[1]);
        mma_bf16(sv[1], qa[j], kb[2], kb[3]);
      }
      if constexpr (CW > 1) {
        // the group's partial tiles, summed in warp order by every warp
        float* mine = sx + w * 256;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            mine[g * 16 + 8 * n + 2 * c + e] = sv[n][e];
            mine[(g + 8) * 16 + 8 * n + 2 * c + e] = sv[n][2 + e];
          }
        group_sync(1 + kw, 32 * CW);
        const float* grp = sx + kw * CW * 256;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int at = (g + 8 * (e >> 1)) * 16 + 8 * n + 2 * c + (e & 1);
            float v = 0.f;
#pragma unroll
            for (int ww = 0; ww < CW; ++ww) v += grp[ww * 256 + at];
            sv[n][e] = v;
          }
      }
      // mask (key < the row's end) and scale into log2 units
      const int kb0 = k0 + it * BK + kw * 16 + 2 * c;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sv[n][e] = kb0 + 8 * n + (e & 1) < hi_row[e >> 1]
                         ? sv[n][e] * a.sl2
                         : -INFINITY;
      // online softmax per row (ii 0: row g, 1: row g + 8)
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        float mx = fmaxf(fmaxf(sv[0][2 * ii], sv[0][2 * ii + 1]),
                         fmaxf(sv[1][2 * ii], sv[1][2 * ii + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[ii], mx);
        const bool none = m_new == -INFINITY;
        const float alpha = none ? 1.f : ex2(m[ii] - m_new);
        float ps = 0.f;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = sv[n][2 * ii + e];
            v = none || v == -INFINITY ? 0.f : ex2(v - m_new);
            ps += v;
          }
        ps += __shfl_xor_sync(0xffffffffu, ps, 1);
        ps += __shfl_xor_sync(0xffffffffu, ps, 2);
        l[ii] = l[ii] * alpha + ps;
        m[ii] = m_new;
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          o[n][2 * ii] *= alpha;
          o[n][2 * ii + 1] *= alpha;
        }
      }
      // P rounded to bf16, the A operand of O += P V (this warp's columns)
      uint32_t pa[4];
      pa[0] = pack_bf16(sv[0][0], sv[0][1]);
      pa[1] = pack_bf16(sv[0][2], sv[0][3]);
      pa[2] = pack_bf16(sv[1][0], sv[1][1]);
      pa[3] = pack_bf16(sv[1][2], sv[1][3]);
#pragma unroll
      for (int n = 0; n < NB; n += 2) {
        unsigned vb[4];
        ldsm_x4_trans(vb, vst + ((lane & 7) + 8 * ((lane >> 3) & 1)) * RS +
                              2 * (cw * DC + 8 * n + 8 * (lane >> 4)));
        mma_bf16(o[n], pa, vb[0], vb[1]);
        mma_bf16(o[n + 1], pa, vb[2], vb[3]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the key groups' merge

    // the block's (M, L, O) of its rows over the split: key groups merged
    float M[2] = {m[0], m[1]}, L[2] = {l[0], l[1]};
    if constexpr (KW > 1) {
      float* mls = reinterpret_cast<float*>(ring);  // [KW][16][2]
      float4* red = reinterpret_cast<float4*>(mls + KW * 32);
      if (cw == 0 && c == 0) {
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          mls[(kw * 16 + g + 8 * ii) * 2] = m[ii];
          mls[(kw * 16 + g + 8 * ii) * 2 + 1] = l[ii];
        }
      }
      __syncthreads();
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int row = g + 8 * ii;
        float mx = -INFINITY;
#pragma unroll
        for (int k = 0; k < KW; ++k)
          if (mls[(k * 16 + row) * 2 + 1] > 0.f)
            mx = fmaxf(mx, mls[(k * 16 + row) * 2]);
        float lx = 0.f;
#pragma unroll
        for (int k = 0; k < KW; ++k) {
          const float lk = mls[(k * 16 + row) * 2 + 1];
          if (lk > 0.f) lx += lk * ex2(mls[(k * 16 + row) * 2] - mx);
        }
        const float es = l[ii] > 0.f ? ex2(m[ii] - mx) : 0.f;
        M[ii] = mx;
        L[ii] = lx;
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          o[n][2 * ii] *= es;
          o[n][2 * ii + 1] *= es;
        }
      }
      if (kw > 0) {
        float4* dst = red + ((kw - 1) * CW + cw) * NB * 32 + lane;
#pragma unroll
        for (int n = 0; n < NB; ++n)
          dst[n * 32] = make_float4(o[n][0], o[n][1], o[n][2], o[n][3]);
      }
      __syncthreads();
      if (kw == 0) {
#pragma unroll
        for (int k = 1; k < KW; ++k) {
          const float4* src = red + ((k - 1) * CW + cw) * NB * 32 + lane;
#pragma unroll
          for (int n = 0; n < NB; ++n) {
            const float4 f = src[n * 32];
            o[n][0] += f.x, o[n][1] += f.y, o[n][2] += f.z, o[n][3] += f.w;
          }
        }
      }
    }

    // rows divided by their sums, rounded once; a row with no visible key
    // (L 0) gets zeros
    auto store = [&](float l0, float l1) {
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        if (!rv[ii]) continue;
        const float lx = ii ? l1 : l0;
        const float inv = lx > 0.f ? 1.f / lx : 0.f;
        bf16* dst = a.out + orow[ii] + cw * DC + 2 * c;
#pragma unroll
        for (int n = 0; n < NB; ++n)
          *reinterpret_cast<uint32_t*>(dst + 8 * n) =
              pack_bf16(o[n][2 * ii] * inv, o[n][2 * ii + 1] * inv);
      }
    };
    if (ns == 1) {
      if (kw == 0) store(L[0], L[1]);
      continue;
    }
    // several splits: this one's partials, then the last to arrive merges
    if (kw == 0) {
      float4* dst = reinterpret_cast<float4*>(a.part + (size_t)item * 16 * D) +
                    cw * NB * 32 + lane;
#pragma unroll
      for (int n = 0; n < NB; ++n)
        __stcg(dst + n * 32, make_float4(o[n][0], o[n][1], o[n][2], o[n][3]));
      if (cw == 0 && c == 0) {
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          a.pml[(size_t)item * 32 + (g + 8 * ii) * 2] = M[ii];
          a.pml[(size_t)item * 32 + (g + 8 * ii) * 2 + 1] = L[ii];
        }
      }
    }
    __threadfence();
    __syncthreads();
    const int first = item - s;
    if (tid == 0) s_last = atomicAdd(a.cnt + first, 1) == ns - 1;
    __syncthreads();
    if (!s_last || kw != 0) continue;
    __threadfence();
    float mx[2] = {-INFINITY, -INFINITY}, lx[2] = {0.f, 0.f};
#pragma unroll 4
    for (int s2 = 0; s2 < ns; ++s2) {
      const float* ml = a.pml + (size_t)(first + s2) * 32;
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const float2 v =
            __ldcg(reinterpret_cast<const float2*>(ml + (g + 8 * ii) * 2));
        mx[ii] = fmaxf(mx[ii], v.y > 0.f ? v.x : -INFINITY);
      }
    }
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    for (int s2 = 0; s2 < ns; ++s2) {
      const float* ml = a.pml + (size_t)(first + s2) * 32;
      float es[2];
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const float2 v =
            __ldcg(reinterpret_cast<const float2*>(ml + (g + 8 * ii) * 2));
        es[ii] = v.y > 0.f ? ex2(v.x - mx[ii]) : 0.f;
        lx[ii] += v.y * es[ii];
      }
      const float4* src =
          reinterpret_cast<const float4*>(a.part +
                                          (size_t)(first + s2) * 16 * D) +
          cw * NB * 32 + lane;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const float4 f = __ldcg(src + n * 32);
        o[n][0] += f.x * es[0], o[n][1] += f.y * es[0];
        o[n][2] += f.z * es[1], o[n][3] += f.w * es[1];
      }
    }
    store(lx[0], lx[1]);
    if (tid == 0) a.cnt[first] = 0;  // zero for the next launch
  }
}

// Blocks a launch: the live items at most, and as many as the card holds
// at once (occupancy by the kernel's registers and shared memory). A
// sequence with items for at least half the SMs of its own is not split.
template <int D, bool SAME>
static int launch(Args a, int device, cudaStream_t st) {
  auto kern = ragged_split_kernel<D, SAME>;
  const size_t smem = fixed_smem<D, SAME>() + seq_smem(a.S);
  constexpr int kDev = 16;
  static int occ[kDev], occ_smem[kDev], sms[kDev];
  if (device < 0 || device >= kDev) return (int)cudaErrorInvalidDevice;
  if (occ_smem[device] != (int)smem) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ[device], kern,
                                                        128, smem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
    if (occ[device] < 1) return (int)cudaErrorInvalidConfiguration;
    occ_smem[device] = (int)smem;
  }
  a.wide = (sms[device] + 1) / 2;
  const int grid = max(1, min(a.max_items, occ[device] * sms[device]));
  kern<<<grid, 128, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <bool SAME>
static int dispatch(int D, const Args& a, int device, cudaStream_t st) {
  switch (D) {
    case 32:
      return launch<32, SAME>(a, device, st);
    case 64:
      return launch<64, SAME>(a, device, st);
    case 128:
      return launch<128, SAME>(a, device, st);
    case 256:
      return launch<256, SAME>(a, device, st);
    case 576:  // the MLA latent row, r + dr = 512 + 64
      return launch<576, SAME>(a, device, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace rag
}  // namespace ptt

using namespace ptt;

extern "C" {

// f32: q [T, H, D]; k/v_pages [KV, P, psz, D]; seq_start/num_tokens/
// kv_lengths [S] int32; tables [S, nj] int32 -> out [T, H, D] (pre-zeroed
// by the caller)
int ptt_ragged_attention(const void* q, const void* k_pages,
                         const void* v_pages, const void* seq_start,
                         const void* num_tokens, const void* kv_lengths,
                         const void* tables, void* out, int T, int H, int KV,
                         int D, int P, int psz, int S, int nj, float scale,
                         int dtype, int device, void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T == 0 || S == 0) return (int)cudaSuccess;
  if (dtype != kF32) return (int)cudaErrorInvalidValue;
  return dispatch_d<float>(D, q, k_pages, v_pages,
                           static_cast<const int*>(seq_start),
                           static_cast<const int*>(num_tokens),
                           static_cast<const int*>(kv_lengths),
                           static_cast<const int*>(tables), out, T, H, KV, P,
                           psz, S, nj, scale, st);
}

// bf16, the same operands, out written whole (not pre-zeroed); keys split
// every `split` positions of the table's capacity nj * psz, a split
// spanning at most rag::SPG table entries; part [max_items, 16 D] and pml
// [max_items, 32] f32 workspaces and cnt [max_items] int32 counters
// (zero, left zero) where split < nj * psz (may be null otherwise). The
// row tables making more than max_items items trap the launch (a CUDA
// error at the next synchronisation).
int ptt_ragged_bf16(const void* q, const void* k_pages, const void* v_pages,
                    const void* seq_start, const void* num_tokens,
                    const void* kv_lengths, const void* tables, void* out,
                    void* part, void* pml, void* cnt, int T, int H, int KV,
                    int D, int P, int psz, int S, int nj, int split,
                    int max_items, float scale, int device, void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cap = nj * psz;
  if (T == 0 || S == 0 || cap == 0 || max_items == 0 || KV < 1 || H % KV ||
      psz < 1 || P < 1 || split < 1 || (split + psz - 1) / psz + 1 > rag::SPG ||
      (split < cap && !(part && pml && cnt)))
    return (int)cudaErrorInvalidValue;
  rag::Args a;
  a.q = static_cast<const rag::bf16*>(q);
  a.k = static_cast<const rag::bf16*>(k_pages);
  a.v = static_cast<const rag::bf16*>(v_pages);
  a.ss = static_cast<const int*>(seq_start);
  a.nt = static_cast<const int*>(num_tokens);
  a.kvl = static_cast<const int*>(kv_lengths);
  a.tab = static_cast<const int*>(tables);
  a.out = static_cast<rag::bf16*>(out);
  a.part = static_cast<float*>(part);
  a.pml = static_cast<float*>(pml);
  a.cnt = static_cast<int*>(cnt);
  a.T = T, a.H = H, a.KV = KV, a.rep = H / KV, a.P = P, a.psz = psz;
  a.S = S, a.nj = nj, a.cap = cap, a.split = split, a.max_items = max_items;
  a.psz_shift = (psz & (psz - 1)) ? -1 : __builtin_ctz(psz);
  a.whole = (rag::SPG - 1) * psz;
  a.sl2 = scale * 1.4426950408889634f;
  return k_pages == v_pages ? rag::dispatch<true>(D, a, device, st)
                            : rag::dispatch<false>(D, a, device, st);
}

}  // extern "C"
