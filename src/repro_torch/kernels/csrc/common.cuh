// Helpers shared by the kernels: float32 <-> storage type conversion
// (bf16 rounds to nearest even, as tensor.to(bfloat16) does), warp-wide
// reductions, and the IoU of two xyxy boxes that the NMS, assignment and
// IoU kernels compute.
#pragma once

#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// max and min that give NaN when either operand is NaN, as
// torch.maximum / torch.clamp and jnp.maximum / jnp.clip do; fmaxf and
// fminf return the other operand instead.  One PTX instruction each
// (max.NaN / min.NaN, sm_80 and later).
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float box_area(const float4 v) {
  return (v.z - v.x) * (v.w - v.y);
}

// IoU of xyxy boxes a and b given their areas, in the reference's
// operation order:
//   inter = max(ix1 - ix0, 0) * max(iy1 - iy0, 0)
//   iou   = inter / max(area_a + area_b - inter, 1e-9)
// with IEEE division, NaN carried through every max and min.  Built with
// -fmad=false (kernels/build.py), so nothing is contracted into a fused
// multiply-add and the result equals the plain PyTorch version bit for
// bit (a threshold compare never flips on one ULP).  A zero intersection
// (most pairs) skips the division: the IEEE division takes its slow path
// for a zero dividend, and +-0 over a divisor that is >= 1e-9 or +inf is
// that same +-0; a NaN divisor still divides, to NaN.
__device__ __forceinline__ float box_iou(const float4 a, float area_a,
                                         const float4 b, float area_b) {
  const float ix0 = max_nan(a.x, b.x);
  const float iy0 = max_nan(a.y, b.y);
  const float ix1 = min_nan(a.z, b.z);
  const float iy1 = min_nan(a.w, b.w);
  const float inter = max_nan(ix1 - ix0, 0.0f) * max_nan(iy1 - iy0, 0.0f);
  const float den = max_nan(area_a + area_b - inter, 1e-9f);
  return inter == 0.0f && den == den ? inter : inter / den;
}

}  // namespace
