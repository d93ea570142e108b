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
// once and feeds both the scores and the output. Here a block owns
// (sequence b, a split of SPLIT rows of its cache) and all nh heads:
// 32-row tiles of [c_lat | c_pe] stream through a two-stage cp.async ring
// in shared memory (16-byte copies; rows past lengths[b], the split or
// the cache are ZERO-FILLED, never read, since a cache holds garbage
// there and 0 * NaN would poison the sum), and every warp reads the same
// tile for its two heads' scores and their weighted sums. Lanes own
// dimensions lane + 32 d (conflict-free shared loads), a warp sum gives a
// row's score, lane p keeps row p's score, and an f32 online softmax runs
// per head. Blocks run in no order, so each writes its split's (m, l,
// acc) in f32 and a second kernel merges the splits of a sequence:
// M = max m_s, o = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M). The
// split count follows the cache length T (the host never reads lengths);
// splits past a sequence's length write l = 0 and are skipped. r a
// multiple of 32 up to 512 (RPL = r / 32 dims a lane), dr a multiple of
// 32 up to 64, an even nh up to 32 (two heads a warp).

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

// One block per (sequence, head): the splits' f32 partials merged.
template <typename T>
__global__ void merge_kernel(const float* __restrict__ acc_in,
                             const float* __restrict__ ml_in,
                             T* __restrict__ out, int nh, int r,
                             int nsplit) {
  const int b = blockIdx.x, h = blockIdx.y;
  float M = -INFINITY;
  for (int s = 0; s < nsplit; ++s) {
    const size_t at = ((size_t)b * nsplit + s) * nh + h;
    if (ml_in[2 * at + 1] > 0.f) M = fmaxf(M, ml_in[2 * at]);
  }
  float L = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const size_t at = ((size_t)b * nsplit + s) * nh + h;
    const float ls = ml_in[2 * at + 1];
    if (ls > 0.f) L += ls * expf(ml_in[2 * at] - M);
  }
  const float inv = 1.f / (L == 0.f ? 1.f : L);
  for (int d = threadIdx.x; d < r; d += blockDim.x) {
    float o = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const size_t at = ((size_t)b * nsplit + s) * nh + h;
      if (ml_in[2 * at + 1] > 0.f)
        o += acc_in[at * r + d] * expf(ml_in[2 * at] - M);
    }
    out[((size_t)b * nh + h) * r + d] = from_f32<T>(o * inv);
  }
}

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
  merge_kernel<T><<<dim3(B, nh), 128, 0, st>>>(acc, ml, static_cast<T*>(out),
                                               nh, r, nsplit);
  return (int)cudaGetLastError();
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
// and ml [B, nsplit, nh, 2] f32 workspaces, nsplit = ceil(Tc / split_rows)
// -> out [B, nh, r]
int ptt_mla_decode(const void* q_eff, const void* q_pe, const void* c_lat,
                   const void* c_pe, const void* lengths, void* acc, void* ml,
                   void* out, int B, int nh, int r, int dr, int Tc,
                   int split_rows, float scale, int dtype, int device,
                   void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return (int)cudaSuccess;
  if (nh < mla::HPW || nh % mla::HPW || nh > 32 || dr < 32 || dr % 32 ||
      dr > 32 * mla::MAX_PPL || Tc < 1 || split_rows < mla::TILE ||
      split_rows % mla::TILE)
    return (int)cudaErrorInvalidValue;
  const int nsplit = (Tc + split_rows - 1) / split_rows;
  const int* lens = static_cast<const int*>(lengths);
  float* a = static_cast<float*>(acc);
  float* m = static_cast<float*>(ml);
  if (dtype == kF32)
    return mla::dispatch<float>(r, q_eff, q_pe, c_lat, c_pe, lens, a, m, out,
                                B, nh, dr, Tc, split_rows, nsplit, scale, st);
  if (dtype == kBF16)
    return mla::dispatch<__nv_bfloat16>(r, q_eff, q_pe, c_lat, c_pe, lens, a,
                                        m, out, B, nh, dr, Tc, split_rows,
                                        nsplit, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
