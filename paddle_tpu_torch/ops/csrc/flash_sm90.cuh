// The flash kernels' (flash_attention.cu) view of the shared Hopper
// machinery in sm90.cuh (mbarriers, TMA, bulk copies, wgmma and its
// descriptors, the tensor-map encoders, the layout convention), plus the
// one helper only the softmax uses.
#pragma once

#include "sm90.cuh"

namespace ptt {
namespace sm90 {

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace sm90
}  // namespace ptt
