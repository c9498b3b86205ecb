// What the normalisation kernels written in CUDA share (batch_norm_fwd.cu,
// BatchNorm's training forward; batch_norm_bwd.cu, its training backward;
// layer_norm_bwd.cu, the dropout-residual LayerNorm's backward;
// group_norm_bwd.cu, GroupNorm's backward): loads and stores of fp32, bf16
// and fp16 by a dtype code, one value or eight (16 bytes of 16-bit values,
// 32 of fp32) at a time, the rounding of the composition's casts, a
// division by the spatial size without a divide instruction, and the
// column sum that adds per-block partial rows in a fixed order.

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

// fp32 to the 16 bits of a bf16 or fp16 value, rounded to nearest even
__device__ __forceinline__ uint32_t narrow(float v, int dt) {
  return dt == BF16 ? (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v))
                    : (uint32_t)__half_as_ushort(__float2half_rn(v));
}
// eight 16-bit values (a 16-byte word) to fp32
__device__ __forceinline__ void unpack8(uint4 u, int dt, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = widen((uint16_t)(w[i] & 0xffffu), dt);
    v[2 * i + 1] = widen((uint16_t)(w[i] >> 16), dt);
  }
}
// eight values of dtype dt at p (16-byte aligned) to fp32
__device__ __forceinline__ void load8(const void* p, int dt, float (&v)[8]) {
  if (dt == F32) {
    const float4 a = static_cast<const float4*>(p)[0], b = static_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    unpack8(*static_cast<const uint4*>(p), dt, v);
  }
}
// eight fp32 values, each rounded to dtype dt, written at p (16-byte aligned)
__device__ __forceinline__ void store8(void* p, const float (&v)[8], int dt) {
  if (dt == F32) {
    static_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    static_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = narrow(v[2 * i], dt) | (narrow(v[2 * i + 1], dt) << 16);
  *static_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
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

// out[c] = the sum over p of part[p, c] (fp32, [parts, cols]) in a fixed
// order: thread row r of a block (ROWS rows of 32 columns) adds p = r, r +
// ROWS, ... in order, then row 0 adds the rows' sums in order. No atomics:
// the same partials give the same bits. Grid: ceil(cols / 32) blocks of 32
// ROWS threads, launched by launch_col_sum as a programmatic dependent of
// the kernel that writes the partials: it waits for that grid before it
// reads them.
template <int ROWS>
__global__ void __launch_bounds__(32 * ROWS)
ordered_col_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int parts,
                       int cols) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __shared__ float acc[ROWS][33];
  const int cx = threadIdx.x & 31, r = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + cx;
  float s = 0.f;
  if (col < cols)
    for (int p = r; p < parts; p += ROWS) s += part[(int64_t)p * cols + col];
  acc[r][cx] = s;
  __syncthreads();
  if (r == 0 && col < cols) {
    float t = acc[0][cx];
#pragma unroll
    for (int k = 1; k < ROWS; ++k) t += acc[k][cx];
    out[col] = t;
  }
}

// Launches ordered_col_sum_kernel<ROWS> on `stream` after the kernel
// before it, which it may overlap from that kernel's
// griddepcontrol.launch_dependents on (programmatic dependent launch).
template <int ROWS>
inline cudaError_t launch_col_sum(const float* part, float* out, int parts, int cols,
                                  cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((cols + 31) / 32));
  cfg.blockDim = dim3(32 * ROWS);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, ordered_col_sum_kernel<ROWS>, part, out, parts, cols);
}

}  // namespace bn
