// fused_rms_norm, fused_layer_norm, fused_rope_append, fused_append_rows,
// swiglu, fused_rope, fused_bias_residual_layer_norm and
// fused_moe_dispatch_combine for Hopper (sm_90a).
//
// Replaces:
//   paddle_tpu/ops/fused.py:fused_rms_norm     (Pallas _rms_kernel)
//   paddle_tpu/ops/fused.py:fused_layer_norm   (Pallas _ln_kernel)
//   paddle_tpu/ops/fused.py:fused_rope_append  (Pallas _rope_append_kernel)
//   paddle_tpu/ops/fused.py:fused_append_rows  (Pallas _append_rows_kernel)
//   paddle_tpu/ops/fused.py:swiglu             (Pallas _swiglu_kernel)
//   paddle_tpu/ops/fused.py:fused_rope         (Pallas _rope_pallas_kernel)
//   paddle_tpu/ops/fused.py:fused_bias_residual_layer_norm (Pallas _brln_kernel)
//   paddle_tpu/ops/fused.py:fused_moe_dispatch_combine     (Pallas _moe_dc_kernel)
//
// Bound on the H100 (3.35 TB/s HBM): all are memory-bound; they do a few
// flops per byte.
//   rms_norm:    2*T*H*itemsize + H*w_itemsize bytes (read x and w, write
//                out). At T=132, H=4096 bf16 that is ~2.2 MB, ~0.65 us.
//   layer_norm:  the same plus the bias vector.
//   rope_append: read q, k, v, cos, sin, page_idx, page_off; write q_roped
//                and one K and one V row per token into the page pools.
//   append_rows: read the rows once and write them once into the pools,
//                2 * T * KV * D * itemsize bytes (the MLA step's 132 rows
//                of 576 bf16: 0.30 MB, ~0.09 us).
//   swiglu:      read gate and up, write out: 3*T*I*itemsize (T 4096, I
//                14336 bf16: 352 MB, ~0.105 ms).
//   rope:        read and write q and k, read the S rows of cos / sin
//                (Llama-3-8B's q [1, 4096, 32, 128], k [.., 8, ..] bf16:
//                ~86 MB, ~0.026 ms).
//   brln:        read x and r, write out, read b, w, lb (T 4096, H 4096
//                bf16: ~101 MB, ~0.030 ms).
//   moe_dc:      read keep [T, k, E], oh [T, k, C], gv [T, k]; write the
//                two [T, E, C] outputs (ERNIE-4.5's routing, f32: ~1.06 GB,
//                ~0.32 ms, the writes nearly all of it).
//
// Design:
//   rms_norm: one block per row, 16-byte vector loads and stores when the
//   row is 16-byte aligned, an f32 sum of squares reduced by warp shuffles
//   and one shared-memory pass, rsqrtf(mean + eps), x * r * w in f32 and a
//   store in x's dtype. The row is read twice; the second read hits L1/L2
//   (a 4096-wide bf16 row is 8 KB), so HBM sees it once.
//   layer_norm: the same block per row, in _ln_kernel's op order: an f32
//   mean, then the centred variance mean((x - mu)^2) over a second read
//   of the row (never the one-pass E[x^2] - E[x]^2, which loses rows
//   whose mean is large against their spread, as a GPT residual stream
//   has), then (x - mu) * rsqrt(var + eps) * w + b in f32 and one cast.
//   Three reads of the row; the second and third hit L1/L2.
//   rope_append: one block per token. The TPU kernel walked the tokens in
//   order on one core and re-seeded a resident page block on each page
//   change; here every token's block writes its own K/V row straight into
//   the pool, so tokens need no order and no block ever copies a page.
//   Rows of tokens that share a page land in disjoint (page, offset) slots;
//   only the trash page 0 takes duplicate writes, whose content is garbage
//   by contract. Page and offset are clamped into the pool, so a bad index
//   cannot write outside it.
//   append_rows: the same block per token, with no arithmetic: the
//   block's threads copy its KV rows of D elements into their clamped
//   (page, offset) slot in 16-byte pieces where the rows allow it
//   (D * itemsize a multiple of 16 and both tensors 16-byte aligned:
//   the MLA latent row of 576 bf16 is 72 pieces), element by element
//   else. The pools are updated in place.
//   swiglu: one thread per 16-byte piece of the output (one element when
//   the rows are not 16-byte pieces), g * logistic(g) * u in f32 and one
//   cast. gate and up are read through a row stride each, so the
//   one-argument form reads the two halves of a [.., 2I] row in place.
//   rope: one thread per (row, pair j < D/2), q's rows then k's in ONE
//   launch: [x1 c - x2 s, x2 c + x1 s] in f32, each product rounded
//   before the sum (no FMA contraction, as the plain version's separate
//   ops), one cast. The backward is the same launch with s negated (the
//   rotation by -theta, exact).
//   brln: a block per row, layer_norm's three passes over h = x + b + r
//   (added in that order in f32, recomputed on each pass from reads that
//   hit L1/L2), the centred two-pass variance, then h-hat * w + lb.
//   moe_dc: a block per token. keep[t] [k, E], oh[t] [k, C] and gv[t]
//   [k] go to shared memory as f32 with keep * gv formed once; each
//   thread then owns four columns (e, c..c+3) of both [E, C] slabs (one
//   where C is not a multiple of 4) and sums over the k choices in
//   order, so both outputs are written once, four elements a store:
//   those writes set the time.

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

// The sum of every thread's v over the block (blockDim.x a multiple of 32);
// `red` holds 33 floats. Every thread gets the sum.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    float s = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    s = warp_sum(s);
    if (lane == 0) red[32] = s;
  }
  __syncthreads();
  return red[32];
}

// One block per row: mean, centred variance, then the affine output, each
// pass over the row (16-byte pieces when use_vec).
template <typename X, typename W>
__global__ void layer_norm_kernel(const X* __restrict__ x,
                                  const W* __restrict__ w,
                                  const W* __restrict__ b,
                                  X* __restrict__ out, int H, float eps,
                                  int use_vec) {
  constexpr int VEC = 16 / sizeof(X);
  __shared__ float red[33];
  const size_t base = (size_t)blockIdx.x * H;
  const X* xr = x + base;
  X* orow = out + base;
  const uint4* xv = reinterpret_cast<const uint4*>(xr);
  const int n_vec = use_vec ? H / VEC : 0;

  float s = 0.f;
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    uint4 u = xv[i];
    const X* e = reinterpret_cast<const X*>(&u);
#pragma unroll
    for (int k = 0; k < VEC; ++k) s += to_f32(e[k]);
  }
  for (int i = n_vec * VEC + threadIdx.x; i < H; i += blockDim.x)
    s += to_f32(xr[i]);
  const float mu = block_sum(s, red) / (float)H;

  float ss = 0.f;
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    uint4 u = xv[i];
    const X* e = reinterpret_cast<const X*>(&u);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float c = to_f32(e[k]) - mu;
      ss += c * c;
    }
  }
  for (int i = n_vec * VEC + threadIdx.x; i < H; i += blockDim.x) {
    const float c = to_f32(xr[i]) - mu;
    ss += c * c;
  }
  const float r = rsqrtf(block_sum(ss, red) / (float)H + eps);

  uint4* ov = reinterpret_cast<uint4*>(orow);
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    uint4 u = xv[i];
    const X* e = reinterpret_cast<const X*>(&u);
    uint4 o;
    X* oe = reinterpret_cast<X*>(&o);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int j = i * VEC + k;
      oe[k] = from_f32<X>((to_f32(e[k]) - mu) * r * to_f32(w[j]) +
                          to_f32(b[j]));
    }
    ov[i] = o;
  }
  for (int i = n_vec * VEC + threadIdx.x; i < H; i += blockDim.x)
    orow[i] = from_f32<X>((to_f32(xr[i]) - mu) * r * to_f32(w[i]) +
                          to_f32(b[i]));
}

template <typename X, typename W>
static void launch_ln(const void* x, const void* w, const void* b, void* out,
                      int T, int H, float eps, int use_vec,
                      cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(X);
  int work = use_vec ? H / VEC : H;
  int threads = ((work + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  layer_norm_kernel<X, W><<<T, threads, 0, stream>>>(
      static_cast<const X*>(x), static_cast<const W*>(w),
      static_cast<const W*>(b), static_cast<X*>(out), H, eps, use_vec);
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

template <typename T>
__global__ void append_rows_kernel(T* __restrict__ pages,
                                   const T* __restrict__ rows,
                                   const int* __restrict__ page_idx,
                                   const int* __restrict__ page_off, int KV,
                                   int D, int P, int psz, int vec) {
  const int t = blockIdx.x;
  const int pg = min(max(page_idx[t], 0), P - 1);
  const int off = min(max(page_off[t], 0), psz - 1);
  if (vec) {
    constexpr int VE = 16 / sizeof(T);
    const int per = D / VE;
    for (int i = threadIdx.x; i < KV * per; i += blockDim.x) {
      const int h = i / per, c = (i - h * per) * VE;
      *reinterpret_cast<uint4*>(pages + (((size_t)h * P + pg) * psz + off) *
                                            D + c) =
          *reinterpret_cast<const uint4*>(rows + ((size_t)t * KV + h) * D +
                                          c);
    }
  } else {
    for (int i = threadIdx.x; i < KV * D; i += blockDim.x) {
      const int h = i / D, j = i - h * D;
      pages[(((size_t)h * P + pg) * psz + off) * D + j] =
          rows[((size_t)t * KV + h) * D + j];
    }
  }
}

// ---------------------------------------------------------------------------
// swiglu: out[r, i] = g * logistic(g) * u, rows read through a stride
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ float swiglu_f(float g, float u) {
  return g * (1.f / (1.f + expf(-g))) * u;
}

template <typename T>
__global__ void swiglu_kernel(const T* __restrict__ g,
                              const T* __restrict__ u, T* __restrict__ out,
                              long long rows, int I, long long gs,
                              long long us, int vec) {
  constexpr int VEC = 16 / sizeof(T);
  const int per = vec ? I / VEC : I;
  const long long n = rows * per;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const long long r = idx / per;
    const int c = (int)(idx - r * per);
    if (vec) {
      uint4 gu = *reinterpret_cast<const uint4*>(g + r * gs + c * VEC);
      uint4 uu = *reinterpret_cast<const uint4*>(u + r * us + c * VEC);
      const T* ge = reinterpret_cast<const T*>(&gu);
      const T* ue = reinterpret_cast<const T*>(&uu);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        oe[k] = from_f32<T>(swiglu_f<T>(to_f32(ge[k]), to_f32(ue[k])));
      *reinterpret_cast<uint4*>(out + r * (long long)I + c * VEC) = o;
    } else {
      out[r * (long long)I + c] =
          from_f32<T>(swiglu_f<T>(to_f32(g[r * gs + c]), to_f32(u[r * us + c])));
    }
  }
}

template <typename T>
static void launch_swiglu(const void* g, const void* u, void* out,
                          long long rows, int I, long long gs, long long us,
                          int vec, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const long long n = rows * (long long)(vec ? I / VEC : I);
  long long blocks = (n + 255) / 256;
  if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond 32/SM
  if (blocks < 1) blocks = 1;
  swiglu_kernel<T><<<(int)blocks, 256, 0, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(u), static_cast<T*>(out),
      rows, I, gs, us, vec);
}

// ---------------------------------------------------------------------------
// rope on q [B, S, Hq, D] and k [B, S, Hk, D] in one launch
// ---------------------------------------------------------------------------

template <typename T>
__global__ void rope_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const float* __restrict__ cosv,
                            const float* __restrict__ sinv,
                            T* __restrict__ qo, T* __restrict__ ko,
                            long long rows_q, long long rows_k, int S,
                            int Hq, int Hk, int D, float sign) {
  const int d2 = D / 2;
  const long long n = (rows_q + rows_k) * d2;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    long long row = idx / d2;
    const int j = (int)(idx - row * d2);
    const T* x;
    T* o;
    int H;
    if (row < rows_q) {
      x = q; o = qo; H = Hq;
    } else {
      row -= rows_q; x = k; o = ko; H = Hk;
    }
    const int s = (int)((row / H) % S);
    const float c = cosv[(size_t)s * d2 + j];
    const float sn = sign * sinv[(size_t)s * d2 + j];
    const size_t base = (size_t)row * D;
    const float x1 = to_f32(x[base + j]), x2 = to_f32(x[base + j + d2]);
    // each product rounded before the sum (no FMA contraction), as the
    // plain version's separate ops round: bf16 results then equal it
    o[base + j] = from_f32<T>(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, sn)));
    o[base + j + d2] =
        from_f32<T>(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, sn)));
  }
}

// ---------------------------------------------------------------------------
// bias + residual + layer norm, a block per row
// ---------------------------------------------------------------------------

// (h - mu) * rstd * w + lb, each step rounded (no FMA contraction), in
// _brln_kernel's order
__device__ __forceinline__ float brln_out(float h, float mu, float rs,
                                          float w, float lb) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(h, mu), rs), w), lb);
}

template <typename X, typename W>
__global__ void brln_kernel(const X* __restrict__ x, const X* __restrict__ r,
                            const W* __restrict__ b, const W* __restrict__ w,
                            const W* __restrict__ lb, X* __restrict__ out,
                            int H, float eps, int use_vec) {
  constexpr int VEC = 16 / sizeof(X);
  __shared__ float red[33];
  const size_t base = (size_t)blockIdx.x * H;
  const X* xr = x + base;
  const X* rr = r + base;
  X* orow = out + base;
  const uint4* xv = reinterpret_cast<const uint4*>(xr);
  const uint4* rv = reinterpret_cast<const uint4*>(rr);
  const int n_vec = use_vec ? H / VEC : 0;
  // h = (x + b) + r in f32, _brln_kernel's order
#define PTT_H(xe, re, j) (to_f32(xe) + to_f32(b[j]) + to_f32(re))

  float s = 0.f;
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    uint4 ux = xv[i], ur = rv[i];
    const X* ex = reinterpret_cast<const X*>(&ux);
    const X* er = reinterpret_cast<const X*>(&ur);
#pragma unroll
    for (int kk = 0; kk < VEC; ++kk) s += PTT_H(ex[kk], er[kk], i * VEC + kk);
  }
  for (int i = n_vec * VEC + threadIdx.x; i < H; i += blockDim.x)
    s += PTT_H(xr[i], rr[i], i);
  const float mu = block_sum(s, red) / (float)H;

  float ss = 0.f;
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    uint4 ux = xv[i], ur = rv[i];
    const X* ex = reinterpret_cast<const X*>(&ux);
    const X* er = reinterpret_cast<const X*>(&ur);
#pragma unroll
    for (int kk = 0; kk < VEC; ++kk) {
      const float c = PTT_H(ex[kk], er[kk], i * VEC + kk) - mu;
      ss += c * c;
    }
  }
  for (int i = n_vec * VEC + threadIdx.x; i < H; i += blockDim.x) {
    const float c = PTT_H(xr[i], rr[i], i) - mu;
    ss += c * c;
  }
  const float rs = rsqrtf(block_sum(ss, red) / (float)H + eps);

  uint4* ov = reinterpret_cast<uint4*>(orow);
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    uint4 ux = xv[i], ur = rv[i];
    const X* ex = reinterpret_cast<const X*>(&ux);
    const X* er = reinterpret_cast<const X*>(&ur);
    uint4 o;
    X* oe = reinterpret_cast<X*>(&o);
#pragma unroll
    for (int kk = 0; kk < VEC; ++kk) {
      const int j = i * VEC + kk;
      oe[kk] = from_f32<X>(brln_out(PTT_H(ex[kk], er[kk], j), mu, rs,
                                    to_f32(w[j]), to_f32(lb[j])));
    }
    ov[i] = o;
  }
  for (int i = n_vec * VEC + threadIdx.x; i < H; i += blockDim.x)
    orow[i] = from_f32<X>(brln_out(PTT_H(xr[i], rr[i], i), mu, rs,
                                   to_f32(w[i]), to_f32(lb[i])));
#undef PTT_H
}

template <typename X, typename W>
static void launch_brln(const void* x, const void* r, const void* b,
                        const void* w, const void* lb, void* out, int T,
                        int H, float eps, int use_vec, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(X);
  int work = use_vec ? H / VEC : H;
  int threads = ((work + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  brln_kernel<X, W><<<T, threads, 0, stream>>>(
      static_cast<const X*>(x), static_cast<const X*>(r),
      static_cast<const W*>(b), static_cast<const W*>(w),
      static_cast<const W*>(lb), static_cast<X*>(out), H, eps, use_vec);
}

// ---------------------------------------------------------------------------
// MoE dispatch / combine, a block per token
// ---------------------------------------------------------------------------

// four consecutive outputs in one store (16 bytes of f32, 8 of bf16; the
// address is a multiple of four elements)
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&a);
  u.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename I, typename O>
__global__ void moe_dc_kernel(const I* __restrict__ keep,
                              const I* __restrict__ oh,
                              const I* __restrict__ gv, O* __restrict__ disp,
                              O* __restrict__ comb, int K, int E, int C,
                              int vec) {
  extern __shared__ float sm[];
  float* sk = sm;              // [K, E] keep
  float* skg = sk + K * E;     // [K, E] keep * gv
  float* so = skg + K * E;     // [K, C] one-hots
  const long long t = blockIdx.x;
  for (int i = threadIdx.x; i < K * E; i += blockDim.x) {
    const float kv = to_f32(keep[t * K * E + i]);
    sk[i] = kv;
    skg[i] = kv * to_f32(gv[t * K + i / E]);
  }
  for (int i = threadIdx.x; i < K * C; i += blockDim.x)
    so[i] = to_f32(oh[t * K * C + i]);
  __syncthreads();
  O* dt = disp + t * (long long)E * C;
  O* ct = comb + t * (long long)E * C;
  if (vec) {  // four columns a thread, stored as whole pieces
    const int per = C / 4;
    for (int i = threadIdx.x; i < E * per; i += blockDim.x) {
      const int e = i / per, c0 = (i - e * per) * 4;
      float d[4] = {0.f, 0.f, 0.f, 0.f}, m[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < K; ++j) {
        const float kv = sk[j * E + e], kg = skg[j * E + e];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float o = so[j * C + c0 + q];
          d[q] += kv * o;
          m[q] += kg * o;
        }
      }
      store4(dt + (size_t)e * C + c0, d);
      store4(ct + (size_t)e * C + c0, m);
    }
  } else {
    for (int i = threadIdx.x; i < E * C; i += blockDim.x) {
      const int e = i / C, c = i - e * C;
      float d = 0.f, m = 0.f;
      for (int j = 0; j < K; ++j) {
        const float o = so[j * C + c];
        d += sk[j * E + e] * o;
        m += skg[j * E + e] * o;
      }
      dt[i] = from_f32<O>(d);
      ct[i] = from_f32<O>(m);
    }
  }
}

template <typename I, typename O>
static void launch_moe_dc(const void* keep, const void* oh, const void* gv,
                          void* disp, void* comb, int T, int K, int E, int C,
                          cudaStream_t st) {
  const int vec = C % 4 == 0;
  const size_t smem = sizeof(float) * (size_t)K * (2 * E + C);
  moe_dc_kernel<I, O><<<T, 256, smem, st>>>(
      static_cast<const I*>(keep), static_cast<const I*>(oh),
      static_cast<const I*>(gv), static_cast<O*>(disp), static_cast<O*>(comb),
      K, E, C, vec);
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

// x [T, H] (x_dtype), w and b [H] (w_dtype) -> out [T, H] (x_dtype)
int ptt_layer_norm(const void* x, const void* w, const void* b, void* out,
                   int T, int H, float eps, int x_dtype, int w_dtype,
                   int use_vec, int device, void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T == 0) return (int)cudaSuccess;
  using B = __nv_bfloat16;
  if (x_dtype == kF32 && w_dtype == kF32)
    launch_ln<float, float>(x, w, b, out, T, H, eps, use_vec, st);
  else if (x_dtype == kF32 && w_dtype == kBF16)
    launch_ln<float, B>(x, w, b, out, T, H, eps, use_vec, st);
  else if (x_dtype == kBF16 && w_dtype == kF32)
    launch_ln<B, float>(x, w, b, out, T, H, eps, use_vec, st);
  else if (x_dtype == kBF16 && w_dtype == kBF16)
    launch_ln<B, B>(x, w, b, out, T, H, eps, use_vec, st);
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

// pages [KV, P, psz, D], rows [T, KV, D], page_idx/page_off [T] int32; vec:
// rows of whole 16-byte pieces on 16-byte boundaries -> pages updated in
// place
int ptt_append_rows(void* pages, const void* rows, const void* page_idx,
                    const void* page_off, int T, int KV, int D, int P,
                    int psz, int vec, int dtype, int device, void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T == 0) return (int)cudaSuccess;
  const int* pi = static_cast<const int*>(page_idx);
  const int* po = static_cast<const int*>(page_off);
  if (dtype == kF32)
    append_rows_kernel<float><<<T, 128, 0, st>>>(
        static_cast<float*>(pages), static_cast<const float*>(rows), pi, po,
        KV, D, P, psz, vec);
  else if (dtype == kBF16)
    append_rows_kernel<__nv_bfloat16><<<T, 128, 0, st>>>(
        static_cast<__nv_bfloat16*>(pages),
        static_cast<const __nv_bfloat16*>(rows), pi, po, KV, D, P, psz, vec);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// gate rows [rows, I] at row stride gs, up at us -> out [rows, I]
// contiguous; vec: 16-byte pieces (I, gs, us multiples of 16 / itemsize
// and the three pointers 16-byte aligned)
int ptt_swiglu(const void* g, const void* u, void* out, long long rows,
               int I, long long gs, long long us, int vec, int dtype,
               int device, void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 0 || I == 0) return (int)cudaSuccess;
  if (dtype == kF32)
    launch_swiglu<float>(g, u, out, rows, I, gs, us, vec, st);
  else if (dtype == kBF16)
    launch_swiglu<__nv_bfloat16>(g, u, out, rows, I, gs, us, vec, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// q [B, S, Hq, D], k [B, S, Hk, D] (one dtype), cos/sin [>= S, D/2] f32
// -> qo, ko; sign -1 rotates by -theta (the backward)
int ptt_rope(const void* q, const void* k, const void* cosv,
             const void* sinv, void* qo, void* ko, int BS, int S, int Hq,
             int Hk, int D, float sign, int dtype, int device, void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rq = (long long)BS * Hq, rk = (long long)BS * Hk;
  const long long n = (rq + rk) * (D / 2);
  if (n == 0) return (int)cudaSuccess;
  long long blocks = (n + 255) / 256;
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  const float* c = static_cast<const float*>(cosv);
  const float* s = static_cast<const float*>(sinv);
  if (dtype == kF32)
    rope_kernel<float><<<(int)blocks, 256, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), c, s,
        static_cast<float*>(qo), static_cast<float*>(ko), rq, rk, S, Hq, Hk,
        D, sign);
  else if (dtype == kBF16) {
    using B = __nv_bfloat16;
    rope_kernel<B><<<(int)blocks, 256, 0, st>>>(
        static_cast<const B*>(q), static_cast<const B*>(k), c, s,
        static_cast<B*>(qo), static_cast<B*>(ko), rq, rk, S, Hq, Hk, D,
        sign);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x, r [T, H] (x_dtype), b, w, lb [H] (w_dtype) -> out [T, H] (x_dtype)
int ptt_bias_residual_ln(const void* x, const void* r, const void* b,
                         const void* w, const void* lb, void* out, int T,
                         int H, float eps, int x_dtype, int w_dtype,
                         int use_vec, int device, void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T == 0) return (int)cudaSuccess;
  using B = __nv_bfloat16;
  if (x_dtype == kF32 && w_dtype == kF32)
    launch_brln<float, float>(x, r, b, w, lb, out, T, H, eps, use_vec, st);
  else if (x_dtype == kF32 && w_dtype == kBF16)
    launch_brln<float, B>(x, r, b, w, lb, out, T, H, eps, use_vec, st);
  else if (x_dtype == kBF16 && w_dtype == kF32)
    launch_brln<B, float>(x, r, b, w, lb, out, T, H, eps, use_vec, st);
  else if (x_dtype == kBF16 && w_dtype == kBF16)
    launch_brln<B, B>(x, r, b, w, lb, out, T, H, eps, use_vec, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// keep [T, K, E], oh [T, K, C], gv [T, K] (in_dtype) -> dispatch, combine
// [T, E, C] (out_dtype); K * (2E + C) floats of shared memory a block
int ptt_moe_dispatch_combine(const void* keep, const void* oh,
                             const void* gv, void* disp, void* comb, int T,
                             int K, int E, int C, int in_dtype,
                             int out_dtype, int device, void* stream) {
  PTT_SET_DEVICE(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T == 0 || E == 0 || C == 0) return (int)cudaSuccess;
  using B = __nv_bfloat16;
  if (in_dtype == kF32 && out_dtype == kF32)
    launch_moe_dc<float, float>(keep, oh, gv, disp, comb, T, K, E, C, st);
  else if (in_dtype == kF32 && out_dtype == kBF16)
    launch_moe_dc<float, B>(keep, oh, gv, disp, comb, T, K, E, C, st);
  else if (in_dtype == kBF16 && out_dtype == kBF16)
    launch_moe_dc<B, B>(keep, oh, gv, disp, comb, T, K, E, C, st);
  else if (in_dtype == kBF16 && out_dtype == kF32)
    launch_moe_dc<B, float>(keep, oh, gv, disp, comb, T, K, E, C, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
