// What BatchNorm's one-pass cluster kernels share (batch_norm_fwd.cu, the
// training forward; batch_norm_bwd.cu, the training backward): loads and
// stores of fp32, bf16 and fp16 by a dtype code, the rounding of the
// composition's casts, and a division by the spatial size without a
// divide instruction.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bn {

enum Dtype { F32 = 0, BF16 = 1, F16 = 2 };

__device__ __forceinline__ float load(const void* p, int64_t i, int dt) {
  if (dt == BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dt == F16) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void store(void* p, int64_t i, float v, int dt) {
  if (dt == BF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else if (dt == F16)
    static_cast<__half*>(p)[i] = __float2half_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}
// a 16-bit x value (bf16 or f16) to fp32
__device__ __forceinline__ float widen(uint16_t u, int dt) {
  return dt == BF16 ? __uint_as_float((uint32_t)u << 16) : __half2float(__ushort_as_half(u));
}
__device__ __forceinline__ float round_to(float v, int dt) {
  if (dt == BF16) return __bfloat162float(__float2bfloat16_rn(v));
  if (dt == F16) return __half2float(__float2half_rn(v));
  return v;
}

// n / d for 0 <= n < 2^31 by a multiply and a shift (d >= 1)
struct Divider {
  uint32_t m, s;
  __device__ explicit Divider(uint32_t d) {
    s = 0;
    while ((1u << s) < d) ++s;
    m = (uint32_t)((((uint64_t)1 << 32) * (((uint64_t)1 << s) - d)) / d + 1);
  }
  __device__ __forceinline__ int div(int n) const {
    return (int)((__umulhi((uint32_t)n, m) + (uint32_t)n) >> s);
  }
};

}  // namespace bn
