// The tile machinery of the port's flash kernels (flash_attention.cu,
// flashmask.cu): the shared parameter block, cp.async tile loads into
// padded shared-memory rows, mma.sync m16n8k16 products fed by ldmatrix,
// the quad reductions of an accumulator row, the f32 scalar path's row
// helpers and the backward's di pre-pass. Each kernel file adds its own
// mask and its own loops over the tiles.
#pragma once

#include "common.cuh"

namespace ptt {
namespace flash {

using bf16 = __nv_bfloat16;

constexpr float kNeg = -1e30f;  // hidden score; lse of a row with no key
constexpr int kThreads = 128;   // 4 warps
constexpr int BQ = 64;          // q rows a block (fwd, dq)
constexpr int BKV = 64;         // keys a tile (fwd, dq) / a block (dkv)
constexpr int BQ2 = 32;         // q rows a tile in dkv

struct Flash {
  const void *q, *k, *v;
  const int *seg_q, *seg_kv;        // [B, Sq], [B, Sk] or null
  void* out;                        // [B, Sq, H, D]
  float* lse;                       // [B, H, Sq]
  const void* dout;                 // [B, Sq, H, D]
  float* di;                        // [B, H, Sq]
  void *dq, *dk, *dv;               // [B, S, H, D]
  int B, H, Sq, Sk, causal;
  float scale;
  long long qs[3], ks[3], vs[3];    // (batch, seq, head) element strides
};

// ------------------------------------------------------------------ bf16
template <int D>
struct Geo {
  static constexpr int LD = D + 8;  // smem row: D + 16 bytes of padding
  static constexpr int DT = D / 8;  // n8 tiles across D
};

// ROWS rows of D from `src` (row stride `stride`), rows >= nrows - row0
// zero-filled, into dst [ROWS][LD].
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0,
                                          int nrows) {
  constexpr int CH = D / 8, LD = Geo<D>::LD;
  for (int c = threadIdx.x; c < ROWS * CH; c += kThreads) {
    const int r = c / CH, cc = (c % CH) * 8;
    const bool ok = row0 + r < nrows;
    cp_async16(dst + r * LD + cc,
               ok ? src + (long long)(row0 + r) * stride + cc : src, ok);
  }
}

// acc[NT][4] += A[16 x KD] . B^T: A's 16 rows at `a`, B's 8 NT rows at `b`,
// both [rows][KD] in shared memory with row stride LD.
template <int NT, int KD, int LD>
__device__ __forceinline__ void mma_nt(float (&acc)[NT][4], const bf16* a,
                                       const bf16* b) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KD; kk += 16) {
    unsigned af[4];
    ldsm_x4(af, a + (lane & 15) * LD + kk + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      unsigned bf[4];
      ldsm_x4(bf, b + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk +
                      ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&t);
}

// acc[DT][4] += P[16 x KP] . B[KP x 8 DT]: P is a warp's f32 accumulator
// c[KP / 8][4] (mma C layout), rounded to bf16 into A fragments; B's KP
// rows at `b`, [KP][LD] in shared memory.
template <int DT, int KP, int LD>
__device__ __forceinline__ void mma_pv(float (&acc)[DT][4],
                                       const float (&c)[KP / 8][4],
                                       const bf16* b) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KP / 16; ++kk) {
    const unsigned a[4] = {pack_bf16(c[2 * kk][0], c[2 * kk][1]),
                           pack_bf16(c[2 * kk][2], c[2 * kk][3]),
                           pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]),
                           pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < DT / 2; ++dp) {
      unsigned bf[4];
      ldsm_x4_trans(bf, b + (kk * 16 + (lane & 15)) * LD + dp * 16 +
                            (lane >> 4) * 8);
      mma_bf16(acc[2 * dp], a, bf[0], bf[1]);
      mma_bf16(acc[2 * dp + 1], a, bf[2], bf[3]);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Store a warp's [16 x D] accumulator rows (row0 + lane / 4 (+ 8)) into a
// contiguous [B, S, H, D] tensor, rows >= S skipped, each value divided by
// div[0] (upper 8 rows) or div[1] (lower 8 rows).
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 8][4],
                                           int b, int h, int H, int S,
                                           int row0, const float (&div)[2]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + (lane >> 2) + 8 * half;
    if (row >= S) continue;
    bf16* o = dst + (((size_t)b * S + row) * H + h) * D + (lane & 3) * 2;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(o + dt * 8) = __floats2bfloat162_rn(
          acc[dt][2 * half] / div[half], acc[dt][2 * half + 1] / div[half]);
  }
}

// ------------------------------------------------------------------- f32
// A warp per row; lane holds dimensions lane + 32 d (d < D / 32).
template <int D>
__device__ __forceinline__ float dot_row(const float (&x)[D / 32],
                                         const float* y) {
  const int lane = threadIdx.x & 31;
  float part = 0.f;
#pragma unroll
  for (int d = 0; d < D / 32; ++d) part += x[d] * y[d * 32 + lane];
  return warp_sum(part);
}

template <int D>
__device__ __forceinline__ void load_row(float (&x)[D / 32], const float* y) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 0; d < D / 32; ++d) x[d] = y[d * 32 + lane];
}

template <int D>
__device__ __forceinline__ void store_row(float* y, const float (&x)[D / 32],
                                          float div) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 0; d < D / 32; ++d) y[d * 32 + lane] = x[d] / div;
}

// di[b, h, s] = sum_d do[b, s, h, d] * o[b, s, h, d] in f32; a warp per row
// (static: each kernel file launches its own copy)
template <typename T, int D>
static __global__ void __launch_bounds__(kThreads) di_pass(const Flash p) {
  const int r = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int rows = p.B * p.Sq * p.H;
  if (r >= rows) return;
  const int h = r % p.H, s = (r / p.H) % p.Sq, b = r / (p.H * p.Sq);
  const T* o = static_cast<const T*>(p.out) + (size_t)r * D;
  const T* g = static_cast<const T*>(p.dout) + (size_t)r * D;
  const int lane = threadIdx.x & 31;
  float part = 0.f;
#pragma unroll
  for (int d = 0; d < D / 32; ++d)
    part += to_f32(o[d * 32 + lane]) * to_f32(g[d * 32 + lane]);
  part = warp_sum(part);
  if (lane == 0) p.di[((size_t)b * p.H + h) * p.Sq + s] = part;
}

// Opt `kernel` in to `smem` bytes of dynamic shared memory (above 48 KB).
template <typename K>
static cudaError_t with_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace flash
}  // namespace ptt
