// fused_rms_norm and fused_rope_append for Hopper (sm_90a).
//
// Replaces:
//   paddle_tpu/ops/fused.py:fused_rms_norm     (Pallas _rms_kernel)
//   paddle_tpu/ops/fused.py:fused_rope_append  (Pallas _rope_append_kernel)
//
// Bound on the H100 (3.35 TB/s HBM): both are memory-bound; they do a few
// flops per byte.
//   rms_norm:    2*T*H*itemsize + H*w_itemsize bytes (read x and w, write
//                out). At T=132, H=4096 bf16 that is ~2.2 MB, ~0.65 us.
//   rope_append: read q, k, v, cos, sin, page_idx, page_off; write q_roped
//                and one K and one V row per token into the page pools.
//
// Design:
//   rms_norm: one block per row, 16-byte vector loads and stores when the
//   row is 16-byte aligned, an f32 sum of squares reduced by warp shuffles
//   and one shared-memory pass, rsqrtf(mean + eps), x * r * w in f32 and a
//   store in x's dtype. The row is read twice; the second read hits L1/L2
//   (a 4096-wide bf16 row is 8 KB), so HBM sees it once.
//   rope_append: one block per token. The TPU kernel walked the tokens in
//   order on one core and re-seeded a resident page block on each page
//   change; here every token's block writes its own K/V row straight into
//   the pool, so tokens need no order and no block ever copies a page.
//   Rows of tokens that share a page land in disjoint (page, offset) slots;
//   only the trash page 0 takes duplicate writes, whose content is garbage
//   by contract. Page and offset are clamped into the pool, so a bad index
//   cannot write outside it.

#include "common.cuh"

namespace ptt {

template <typename X, typename W>
__global__ void rms_norm_kernel(const X* __restrict__ x,
                                const W* __restrict__ w,
                                X* __restrict__ out, int H, float eps,
                                int use_vec) {
  constexpr int VEC = 16 / sizeof(X);  // elements per 16-byte access
  const size_t base = (size_t)blockIdx.x * H;
  const X* xr = x + base;
  X* orow = out + base;

  float ss = 0.f;
  if (use_vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = threadIdx.x; i < H / VEC; i += blockDim.x) {
      uint4 u = xv[i];
      const X* e = reinterpret_cast<const X*>(&u);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float f = to_f32(e[k]);
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < H; i += blockDim.x) {
      float f = to_f32(xr[i]);
      ss += f * f;
    }
  }

  __shared__ float red[32];
  __shared__ float rinv;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  ss = warp_sum(ss);
  if (lane == 0) red[wid] = ss;
  __syncthreads();
  if (wid == 0) {
    float v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) rinv = rsqrtf(v / (float)H + eps);
  }
  __syncthreads();
  const float r = rinv;

  if (use_vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* ov = reinterpret_cast<uint4*>(orow);
    for (int i = threadIdx.x; i < H / VEC; i += blockDim.x) {
      uint4 u = xv[i];
      const X* e = reinterpret_cast<const X*>(&u);
      uint4 o;
      X* oe = reinterpret_cast<X*>(&o);
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        oe[k] = from_f32<X>(to_f32(e[k]) * r * to_f32(w[i * VEC + k]));
      ov[i] = o;
    }
  } else {
    for (int i = threadIdx.x; i < H; i += blockDim.x)
      orow[i] = from_f32<X>(to_f32(xr[i]) * r * to_f32(w[i]));
  }
}

template <typename X, typename W>
static void launch_rms(const void* x, const void* w, void* out, int T, int H,
                       float eps, int use_vec, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(X);
  int work = use_vec ? H / VEC : H;
  int threads = ((work + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  rms_norm_kernel<X, W><<<T, threads, 0, stream>>>(
      static_cast<const X*>(x), static_cast<const W*>(w),
      static_cast<X*>(out), H, eps, use_vec);
}

template <typename T>
__global__ void rope_append_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ cosv,
    const float* __restrict__ sinv, T* __restrict__ k_pages,
    T* __restrict__ v_pages, const int* __restrict__ page_idx,
    const int* __restrict__ page_off, T* __restrict__ q_out, int Hq, int KV,
    int D, int P, int psz) {
  const int t = blockIdx.x;
  const int d2 = D / 2;
  const float* c = cosv + (size_t)t * d2;
  const float* s = sinv + (size_t)t * d2;
  const int pg = min(max(page_idx[t], 0), P - 1);
  const int off = min(max(page_off[t], 0), psz - 1);

  // q: rotate-half in f32, store in q's dtype
  for (int i = threadIdx.x; i < Hq * d2; i += blockDim.x) {
    const int h = i / d2, j = i - h * d2;
    const size_t row = ((size_t)t * Hq + h) * D;
    const float x1 = to_f32(q[row + j]), x2 = to_f32(q[row + j + d2]);
    q_out[row + j] = from_f32<T>(x1 * c[j] - x2 * s[j]);
    q_out[row + j + d2] = from_f32<T>(x2 * c[j] + x1 * s[j]);
  }
  // k: rotate-half, scattered to k_pages[h, pg, off, :]
  for (int i = threadIdx.x; i < KV * d2; i += blockDim.x) {
    const int h = i / d2, j = i - h * d2;
    const size_t src = ((size_t)t * KV + h) * D;
    const size_t dst = (((size_t)h * P + pg) * psz + off) * D;
    const float x1 = to_f32(k[src + j]), x2 = to_f32(k[src + j + d2]);
    k_pages[dst + j] = from_f32<T>(x1 * c[j] - x2 * s[j]);
    k_pages[dst + j + d2] = from_f32<T>(x2 * c[j] + x1 * s[j]);
  }
  // v: raw row, scattered to v_pages[h, pg, off, :]
  for (int i = threadIdx.x; i < KV * D; i += blockDim.x) {
    const int h = i / D, j = i - h * D;
    v_pages[(((size_t)h * P + pg) * psz + off) * D + j] =
        v[((size_t)t * KV + h) * D + j];
  }
}

}  // namespace ptt

using namespace ptt;

extern "C" {

const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x [T, H] (x_dtype), w [H] (w_dtype) -> out [T, H] (x_dtype)
int ptt_rms_norm(const void* x, const void* w, void* out, int T, int H,
                 float eps, int x_dtype, int w_dtype, int use_vec, int device,
                 void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T == 0) return (int)cudaSuccess;
  if (x_dtype == kF32 && w_dtype == kF32)
    launch_rms<float, float>(x, w, out, T, H, eps, use_vec, st);
  else if (x_dtype == kF32 && w_dtype == kBF16)
    launch_rms<float, __nv_bfloat16>(x, w, out, T, H, eps, use_vec, st);
  else if (x_dtype == kBF16 && w_dtype == kF32)
    launch_rms<__nv_bfloat16, float>(x, w, out, T, H, eps, use_vec, st);
  else if (x_dtype == kBF16 && w_dtype == kBF16)
    launch_rms<__nv_bfloat16, __nv_bfloat16>(x, w, out, T, H, eps, use_vec,
                                             st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// q [T, Hq, D], k/v [T, KV, D], cos/sin [T, D/2] f32, pages [KV, P, psz, D],
// page_idx/page_off [T] int32 -> q_out [T, Hq, D]; pages updated in place
int ptt_rope_append(const void* q, const void* k, const void* v,
                    const void* cosv, const void* sinv, void* k_pages,
                    void* v_pages, const void* page_idx, const void* page_off,
                    void* q_out, int T, int Hq, int KV, int D, int P, int psz,
                    int dtype, int device, void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T == 0) return (int)cudaSuccess;
  const float* c = static_cast<const float*>(cosv);
  const float* s = static_cast<const float*>(sinv);
  const int* pi = static_cast<const int*>(page_idx);
  const int* po = static_cast<const int*>(page_off);
  if (dtype == kF32) {
    rope_append_kernel<float><<<T, 128, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), c, s, static_cast<float*>(k_pages),
        static_cast<float*>(v_pages), pi, po, static_cast<float*>(q_out), Hq,
        KV, D, P, psz);
  } else if (dtype == kBF16) {
    using B = __nv_bfloat16;
    rope_append_kernel<B><<<T, 128, 0, st>>>(
        static_cast<const B*>(q), static_cast<const B*>(k),
        static_cast<const B*>(v), c, s, static_cast<B*>(k_pages),
        static_cast<B*>(v_pages), pi, po, static_cast<B*>(q_out), Hq, KV, D,
        P, psz);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
