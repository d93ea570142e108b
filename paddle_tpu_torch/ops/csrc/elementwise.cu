// generic_elementwise for Hopper (sm_90a): one kernel that runs the
// program of any elementwise region the static-program fusion pass
// (paddle_tpu_torch/jit/fusion_cc.py) matches.
//
// Replaces:
//   paddle_tpu/jit/fusion_cc.py:_generic_kernel (the Pallas loop the JAX
//   pass synthesizes for each generic region, pl.pallas_call at :201)
//
// Bound on the H100 (3.35 TB/s HBM): memory. A region does a handful of
// flops per element and reads each operand once and writes the result
// once: sum(operand bytes) + result bytes. The chain
// exp(tanh(a*b+c)*0.5) - sqrt(abs(b)+1) over three [4096, 14336] f32
// operands moves 4 x 235 MB, ~0.28 ms (bf16 ~0.14 ms); a rope region of
// Llama-3-8B's q over 2048 tokens (two strided [1, 2048, 32, 64] halves
// of q, two [1, 2048, 1, 64] tables, one [1, 2048, 32, 64] result, bf16)
// moves ~25.7 MB, ~0.0077 ms.
//
// Design: the TPU version generates one Pallas loop per region, over a
// [M, 128] view of full-shape operands (StableHLO makes broadcasts and
// slices explicit ops). Here ONE kernel, built once from this file,
// interprets the region's program, so a new region needs no compiler
// run when a Predictor is built:
//   - the program (at most kMaxOps instructions of the 15 opcodes of the
//     pass's instruction set, each input an operand, an earlier
//     instruction's result or an f32 immediate) and every operand's
//     pointer and strides over the result's shape (stride 0 on a
//     broadcast dimension, any stride on a sliced one) are passed by
//     value in one parameter struct;
//   - a grid-stride loop over the result's elements, which are written
//     contiguously; each operand element is read once;
//   - each instruction is computed in f32 and rounded to the region's
//     dtype (f32, bf16, f16) before the next one reads it, with precise
//     math (expf, logf, tanhf, sqrtf, IEEE division, and the _rn
//     intrinsics so that no product is contracted into an FMA): the
//     values of PyTorch's unfused ops, one op at a time.
// The wrapper merges the dimensions that every operand walks alike, so a
// contiguous region is one dimension. Vector loads and a contiguous fast
// path are later work.

#include <cuda_fp16.h>

#include "common.cuh"

namespace ptt {

constexpr int kEwMaxOps = 32;
constexpr int kEwMaxIn = 8;
constexpr int kEwMaxRank = 8;

// the pass's instruction set (fusion_cc._EW_OPS order)
enum EwOp : int {
  kAdd = 0, kSub, kMul, kDiv, kMax, kMin, kExp, kLog, kTanh, kLogistic,
  kRsqrt, kSqrt, kNeg, kAbs, kPow
};
// where an instruction's input comes from
enum EwSrc : int { kReg = 0, kIn = 1, kImm = 2 };
enum EwDType : int { kEwF32 = 0, kEwBF16 = 1, kEwF16 = 2 };

struct EwParams {
  long long shape[kEwMaxRank];
  long long stride[kEwMaxIn][kEwMaxRank];
  const void* in[kEwMaxIn];
  void* out;
  long long n;
  float imm[kEwMaxOps][2];
  int op[kEwMaxOps];
  int kind[kEwMaxOps][2];
  int idx[kEwMaxOps][2];
  int n_ops, n_in, rank;
};

__device__ __forceinline__ float ew_load(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float ew_load(const __nv_bfloat16* p,
                                         long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float ew_load(const __half* p, long long i) {
  return __half2float(p[i]);
}

__device__ __forceinline__ void ew_store(float* p, long long i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void ew_store(__nv_bfloat16* p, long long i,
                                         float x) {
  p[i] = __float2bfloat16(x);  // round to nearest even, as torch does
}
__device__ __forceinline__ void ew_store(__half* p, long long i, float x) {
  p[i] = __float2half(x);
}

// x rounded to T and back: what an unfused op of dtype T hands the next
template <typename T>
__device__ __forceinline__ float ew_round(float x);
template <>
__device__ __forceinline__ float ew_round<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float ew_round<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
template <>
__device__ __forceinline__ float ew_round<__half>(float x) {
  return __half2float(__float2half(x));
}

// torch.pow with a scalar exponent takes these shortcuts (its
// pow_tensor_scalar kernel); a tensor exponent goes to powf
__device__ __forceinline__ float ew_pow(float a, float b, bool imm) {
  if (imm) {
    if (b == 0.5f) return sqrtf(a);
    if (b == 2.f) return __fmul_rn(a, a);
    if (b == 3.f) return __fmul_rn(__fmul_rn(a, a), a);
    if (b == -0.5f) return rsqrtf(a);
    if (b == -1.f) return __fdiv_rn(1.f, a);
    if (b == -2.f) return __fdiv_rn(1.f, __fmul_rn(a, a));
  }
  return powf(a, b);
}

__device__ __forceinline__ float ew_apply(int op, float a, float b,
                                          bool b_imm) {
  switch (op) {
    case kAdd: return __fadd_rn(a, b);
    case kSub: return __fsub_rn(a, b);
    case kMul: return __fmul_rn(a, b);
    case kDiv: return __fdiv_rn(a, b);
    // torch.maximum / minimum propagate NaN (fmaxf would drop it)
    case kMax: return (a != a || b != b) ? __int_as_float(0x7fc00000)
                                         : fmaxf(a, b);
    case kMin: return (a != a || b != b) ? __int_as_float(0x7fc00000)
                                         : fminf(a, b);
    case kExp: return expf(a);
    case kLog: return logf(a);
    case kTanh: return tanhf(a);
    case kLogistic: return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-a)));
    case kRsqrt: return rsqrtf(a);
    case kSqrt: return sqrtf(a);
    case kNeg: return -a;
    case kAbs: return fabsf(a);
    case kPow: return ew_pow(a, b, b_imm);
  }
  return __int_as_float(0x7fc00000);
}

template <typename T>
__global__ void __launch_bounds__(256)
    ew_kernel(const __grid_constant__ EwParams p) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < p.n; i += (long long)gridDim.x * blockDim.x) {
    long long off[kEwMaxIn];
#pragma unroll
    for (int k = 0; k < kEwMaxIn; ++k) off[k] = 0;
    long long rem = i;
    for (int d = p.rank - 1; d >= 0; --d) {
      const long long c = rem % p.shape[d];
      rem /= p.shape[d];
#pragma unroll
      for (int k = 0; k < kEwMaxIn; ++k)
        if (k < p.n_in) off[k] += c * p.stride[k][d];
    }
    float x[kEwMaxIn];
#pragma unroll
    for (int k = 0; k < kEwMaxIn; ++k)
      x[k] = k < p.n_in ? ew_load(static_cast<const T*>(p.in[k]), off[k])
                        : 0.f;
    float reg[kEwMaxOps];
    float r = 0.f;
    for (int j = 0; j < p.n_ops; ++j) {
      float v[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int kd = p.kind[j][s], ix = p.idx[j][s];
        v[s] = kd == kReg ? reg[ix] : kd == kIn ? x[ix] : p.imm[j][s];
      }
      r = ew_round<T>(ew_apply(p.op[j], v[0], v[1], p.kind[j][1] == kImm));
      reg[j] = r;
    }
    ew_store(static_cast<T*>(p.out), i, r);
  }
}

template <typename T>
static void launch_ew(const EwParams& p, cudaStream_t st) {
  long long blocks = (p.n + 255) / 256;
  if (blocks > 132LL * 16) blocks = 132LL * 16;  // grid-stride beyond 16/SM
  if (blocks < 1) blocks = 1;
  ew_kernel<T><<<(int)blocks, 256, 0, st>>>(p);
}

}  // namespace ptt

using namespace ptt;

extern "C" {

// prog [n_ops][5] int32: opcode, kind0, idx0, kind1, idx1; imms [n_ops][2]
// f32; ins [n_in] device pointers; strides [n_in][rank] and shape [rank]
// int64 (elements); out contiguous over shape, of dtype
int ptt_generic_elementwise(int n_ops, const int* prog, const float* imms,
                            int n_in, const long long* ins,
                            const long long* strides, int rank,
                            const long long* shape, void* out, int dtype,
                            int device, void* stream) {
  PTT_SET_DEVICE(device);
  if (n_ops < 1 || n_ops > kEwMaxOps || n_in < 0 || n_in > kEwMaxIn ||
      rank < 0 || rank > kEwMaxRank)
    return (int)cudaErrorInvalidValue;
  EwParams p = {};
  p.n = 1;
  for (int d = 0; d < rank; ++d) {
    p.shape[d] = shape[d];
    p.n *= shape[d];
  }
  for (int k = 0; k < n_in; ++k) {
    p.in[k] = reinterpret_cast<const void*>(ins[k]);
    for (int d = 0; d < rank; ++d) p.stride[k][d] = strides[k * rank + d];
  }
  for (int j = 0; j < n_ops; ++j) {
    p.op[j] = prog[j * 5];
    for (int s = 0; s < 2; ++s) {
      p.kind[j][s] = prog[j * 5 + 1 + 2 * s];
      p.idx[j][s] = prog[j * 5 + 2 + 2 * s];
      p.imm[j][s] = imms[j * 2 + s];
      const int kd = p.kind[j][s], ix = p.idx[j][s];
      if ((kd == kReg && (ix < 0 || ix >= j)) ||
          (kd == kIn && (ix < 0 || ix >= n_in)) ||
          (kd != kReg && kd != kIn && kd != kImm))
        return (int)cudaErrorInvalidValue;
    }
    if (p.op[j] < kAdd || p.op[j] > kPow) return (int)cudaErrorInvalidValue;
  }
  p.out = out;
  p.n_ops = n_ops;
  p.n_in = n_in;
  p.rank = rank;
  if (p.n == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kEwF32)
    launch_ew<float>(p, st);
  else if (dtype == kEwBF16)
    launch_ew<__nv_bfloat16>(p, st);
  else if (dtype == kEwF16)
    launch_ew<__half>(p, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
