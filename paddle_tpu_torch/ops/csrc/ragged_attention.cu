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
// sequence owns, and sequences with num_tokens == 0, yield zeros (the
// wrapper pre-zeroes the output; such rows are never written).
//
// Bound on the H100:
//   decode rows are memory-bound: the live K/V bytes,
//     sum_i kv_lengths_i * KV * D * 2 * itemsize, at 3.35 TB/s;
//   a prefill chunk of n tokens is bound by its flops,
//     4 * H * D * (query, key) pairs over the causal half,
//   measured here against the CUDA-core f32 rate (67 TFLOP/s), since
//   this first kernel does not use the tensor cores.
//
// Design: the TPU kernel keeps all T*rep query rows of one KV head
// resident and walks the sequences one after another on one core. Here
// each block owns one (row tile, KV head g, sequence i): a tile of
// ROWS = 16 query rows of that sequence's rep-wide head group
// (token-major), so sequences and heads spread over the SMs and no two
// blocks write the same output row (no cross-block reduction). A block
// walks only the pages its rows can see (causal page skip), with table
// entries clamped to [0, P-1]; it stages each K/V page in shared memory
// as f32, and each warp scores its query rows against the page with one
// lane per dimension slice (D/32 dims a lane, interleaved so shared
// loads are conflict-free), keeps the scores of a 32-key chunk one per
// lane, and updates an f32 online softmax per row. Each page is read once
// per block from HBM/L2 and used by all 16 rows of the tile.
//
// The MLA engine (DeepSeek-V2) runs this kernel over ONE latent pool per
// layer: KV = 1 head of D = r + dr = 576 (the [latent | rope key] row),
// rep = 16 query heads, and the same pool as K and V. Two things change
// at that width. (1) Staging: two f32 pages of 16 x 576 are 73.7 KB, over
// the 48 KB a block gets without opting in; when k_pages and v_pages are
// the same tensor the block stages each page ONCE and reads it as both
// (36.9 KB), and any staging above 48 KB takes the dynamic shared-memory
// opt-in (up to the 227 KB a block may use): the wrapper sizes its gate
// from exactly these bytes. (2) Registers: 4 rows a warp would hold
// 2 x 4 x 18 f32 of q and of the accumulator a lane; at D > 256 a block
// is 8 warps of 2 rows each instead (the same 16 rows a block, 72 f32 a
// lane).

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

}  // namespace ptt

using namespace ptt;

extern "C" {

// q [T, H, D]; k/v_pages [KV, P, psz, D]; seq_start/num_tokens/kv_lengths
// [S] int32; tables [S, nj] int32 -> out [T, H, D] (pre-zeroed by the caller)
int ptt_ragged_attention(const void* q, const void* k_pages,
                         const void* v_pages, const void* seq_start,
                         const void* num_tokens, const void* kv_lengths,
                         const void* tables, void* out, int T, int H, int KV,
                         int D, int P, int psz, int S, int nj, float scale,
                         int dtype, int device, void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T == 0 || S == 0) return (int)cudaSuccess;
  const int* ss = static_cast<const int*>(seq_start);
  const int* nt = static_cast<const int*>(num_tokens);
  const int* kvl = static_cast<const int*>(kv_lengths);
  const int* tab = static_cast<const int*>(tables);
  if (dtype == kF32)
    return dispatch_d<float>(D, q, k_pages, v_pages, ss, nt, kvl, tab, out, T,
                             H, KV, P, psz, S, nj, scale, st);
  if (dtype == kBF16)
    return dispatch_d<__nv_bfloat16>(D, q, k_pages, v_pages, ss, nt, kvl, tab,
                                     out, T, H, KV, P, psz, S, nj, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
