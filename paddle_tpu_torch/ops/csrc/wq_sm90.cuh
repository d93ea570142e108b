// What the port's register-A wgmma kernels share (wol_sm90.cu, the bf16
// route of weight_only_linear; megadecode_sm90.cu, the bf16 route of
// fused_oproj_norm and fused_ffn): the exact integer-to-bf16 conversions
// that build a quantized weight as wgmma's A operand in registers, the
// producer's small copies for weight rows a tensor map cannot describe,
// the SM count, and the host's tensor-map cache. One copy of each.
#pragma once

#include <mutex>

#include "sm90.cuh"

namespace ptt {
namespace wq {

using namespace sm90;

// `bytes` (4 or 8) from global `src` to shared `dst`, both aligned to it,
// or zeros where `full` is false (nothing read).
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src,
                                            int bytes, bool full) {
  const unsigned d = smem_u32(dst);
  const int n = full ? bytes : 0;
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
}

// The bf16 pair (low nibble, high nibble) of byte j of `v`: the byte at
// bits 0-7 and 12-19, masked to the two nibbles with their sign bits
// flipped and OR-ed into bf16 128, 128 + (n ^ 8), less 136: n.
__device__ __forceinline__ uint32_t i4pair(uint32_t v, int j) {
  const uint32_t y = __byte_perm(v, 0u, 0x4440u | j) * 0x1001u;
  uint32_t r;
  // (y & 0x000F000F) ^ 0x43084308: the mask, the sign flips and the OR
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;"
      : "=r"(r)
      : "r"(y), "r"(0x000F000Fu), "r"(0x43084308u));
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&r);
  const uint32_t k136 = 0x43084308u;
  h = __hsub2(h, *reinterpret_cast<const __nv_bfloat162*>(&k136));
  return *reinterpret_cast<uint32_t*>(&h);
}

// The bf16 pair (byte j of lo, byte j of hi), both words with their sign
// bits flipped (^ 0x80808080): f32 2^23 + (b ^ 128) - (2^23 + 128) = b,
// whose top half is its bf16.
__device__ __forceinline__ uint32_t i8pair(uint32_t lo, uint32_t hi, int j) {
  const float fl =
      __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7540u | j)) -
      8388736.f;
  const float fh =
      __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7540u | j)) -
      8388736.f;
  return __byte_perm(__float_as_uint(fl), __float_as_uint(fh), 0x7632u);
}

// The thread's columns of byte row `row` of a weight box: a 32-bit word
// (TPW 2: 4 columns) or 16 bits (TPW 1: 2 columns) at byte offset `o`.
template <int TPW>
__device__ __forceinline__ uint32_t word(const unsigned char* row, int o) {
  if constexpr (TPW == 2)
    return *reinterpret_cast<const uint32_t*>(row + o);
  else
    return *reinterpret_cast<const unsigned short*>(row + o);
}

// The A pairs of k16 step `step` of a stage, a[t] for each m64 tile t,
// from the warpgroup's weight box `wb` (128 bytes a row in the 128-byte
// swizzle); o0 / o1 are the thread's byte offsets in the rows it reads
// (wol_sm90.cu's design note): tile t takes bytes 2t (rows g) and 2t + 1
// (rows g + 8) of each word.
template <bool I4, int TPW>
__device__ __forceinline__ void build(uint32_t (&a)[TPW][4],
                                      const unsigned char* wb, int step,
                                      int c, int o0, int o1) {
  if constexpr (I4) {
    const unsigned char* r = wb + (8 * step + c) * 128;
    const uint32_t v0 = word<TPW>(r, o0), v1 = word<TPW>(r + 512, o1);
#pragma unroll
    for (int t = 0; t < TPW; ++t) {
      a[t][0] = i4pair(v0, 2 * t);
      a[t][1] = i4pair(v0, 2 * t + 1);
      a[t][2] = i4pair(v1, 2 * t);
      a[t][3] = i4pair(v1, 2 * t + 1);
    }
  } else {
    const unsigned char* r = wb + (16 * step + 2 * c) * 128;
    const uint32_t p = word<TPW>(r, o0) ^ 0x80808080u;
    const uint32_t q = word<TPW>(r + 128, o1) ^ 0x80808080u;
    const uint32_t u = word<TPW>(r + 1024, o0) ^ 0x80808080u;
    const uint32_t v = word<TPW>(r + 1152, o1) ^ 0x80808080u;
#pragma unroll
    for (int t = 0; t < TPW; ++t) {
      a[t][0] = i8pair(p, q, 2 * t);
      a[t][1] = i8pair(p, q, 2 * t + 1);
      a[t][2] = i8pair(u, v, 2 * t);
      a[t][3] = i8pair(u, v, 2 * t + 1);
    }
  }
}

// SMs of `device`, read once.
static inline int sm_count(int device) {
  static int counts[64] = {0};
  int& n = counts[device & 63];
  if (n == 0)
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
  return n > 0 ? n : 1;
}

using u64 = unsigned long long;

// A tensor map of `rank` (2 or 3) dimensions of `type` elements at `base`
// on `device`, innermost first: extents `dims`, packed rows (the stride of
// dimension 1 is dims[0] elements, of dimension 2 dims[0] dims[1]), boxes
// `box`, from a cache: a map holds no more than the address and the
// shape, so one encoded for the same (device, address, shape, box) is the
// same map, whatever tensor lives there now. Encoding costs a driver
// call, and a serving step launches these kernels hundreds of times on
// the same weights and activation buffers. The cache is 1024 entries in
// buckets of 4 found by a hash of the key (each bucket replaced round
// robin), so a lookup reads 4 entries whatever the cache holds. The map
// is copied out under a lock, so a later eviction or another thread's
// lookup cannot change it.
static inline int cached_map(CUtensorMap* map, int device, const void* base,
                             int rank, const u64* dims, const unsigned* box,
                             CUtensorMapDataType type) {
  struct Entry {
    CUtensorMap map;
    const void* base;
    u64 dims[3];
    unsigned box[3];
    int device, type, rank, used;
  };
  constexpr int kBuckets = 256, kWays = 4;
  static Entry cache[kBuckets][kWays];
  static int next[kBuckets];
  static std::mutex mu;
  u64 d[3] = {1, 1, 1};
  unsigned b[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) d[i] = dims[i], b[i] = box[i];
  u64 h = reinterpret_cast<uintptr_t>(base) * 0x9E3779B97F4A7C15ull;
  for (int i = 0; i < 3; ++i)
    h = (h ^ d[i] ^ ((u64)b[i] << 40)) * 0x100000001B3ull;
  h ^= (u64)(device * 31 + (int)type * 7 + rank);
  const int bucket = (int)((h >> 29) % kBuckets);
  std::lock_guard<std::mutex> lock(mu);
  for (int w = 0; w < kWays; ++w) {
    const Entry& c = cache[bucket][w];
    if (c.used && c.base == base && c.rank == rank && c.device == device &&
        c.type == (int)type && c.dims[0] == d[0] && c.dims[1] == d[1] &&
        c.dims[2] == d[2] && c.box[0] == b[0] && c.box[1] == b[1] &&
        c.box[2] == b[2]) {
      *map = c.map;
      return 0;
    }
  }
  Entry& c = cache[bucket][next[bucket]];
  next[bucket] = (next[bucket] + 1) % kWays;
  const unsigned esize = type == CU_TENSOR_MAP_DATA_TYPE_UINT8 ? 1 : 2;
  const u64 str[2] = {d[0] * esize, d[0] * d[1] * esize};
  c.used = 0;
  const int e = encode_tiled(&c.map, base, rank, d, str, b, type);
  if (e != 0) return e;
  c.base = base, c.rank = rank, c.device = device, c.type = (int)type;
  for (int i = 0; i < 3; ++i) c.dims[i] = d[i], c.box[i] = b[i];
  c.used = 1;
  *map = c.map;
  return 0;
}

}  // namespace wq
}  // namespace ptt
