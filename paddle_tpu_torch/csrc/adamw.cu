// Multi-tensor AdamW update, in place (Hopper, sm_90a).
//
// Replaces paddle_tpu/kernels/optimizer_pallas.py:_fused_adamw_flat
// (_adamw_kernel) and the concat -> kernel -> split of
// multi_tensor_adamw_pallas around it. Same math, that of
// paddle_tpu/optimizer/__init__.py:_adam_update, in fp32:
//   g' = decoupled ? g : g + wd * p
//   m  = b1 * m + (1 - b1) * g'        v = b2 * v + (1 - b2) * g' * g'
//   p  = (decoupled ? p * (1 - lr * wd) : p) - lr * (m / bc1) / (sqrt(v / bc2) + eps)
// with lr = base rate * the tensor's multiplier (a float32 product, the JAX
// trainer's lr * _lr_mult(name)), p and g in the parameter's dtype
// (float32 or bfloat16) and m, v in float32. Every operation is an explicitly rounded intrinsic, so the
// compiler fuses no multiply-add and the result is the plain version's.
//
// Bound on the H100: bytes. An element costs ~15 flops against 22 bytes
// (bf16 p, g; fp32 m, v; read 12, write 10), far below the ~295 flop/byte
// the card needs before compute is the limit.
//
// Design against that bound: one launch updates every tensor of a dtype
// group where it lies. The JAX arrays are immutable, so the TPU version
// concatenates the group into flat buffers and splits the result, which
// triples the bytes moved; this kernel instead walks a device-side table of
// (tensor, chunk) entries: the four pointers of a chunk of up to 65536
// elements, its length, its tensor's weight decay and rate multiplier, and
// whether its pointers allow 16-byte accesses. The base rate and the bias
// corrections, which change from step to step, are read from a float32
// device array [lr, bc1, bc2] (as the Pallas kernel reads its scalars
// from SMEM), so neither the table nor the launch's arguments change
// across steps, and a launch captured in a CUDA graph replays every step
// with the rate and step count of that replay. The caller builds the table
// once and reuses it while the pointers stay the same (the update is in
// place). Each block
// takes one chunk and moves it with 16-byte loads and stores (8 elements a
// thread for bf16 p and g, two float4 of m and v); a misaligned tensor, or
// the tail of a chunk, takes element accesses.
//
// Plain C interface, loaded with ctypes. The launch goes on the caller's
// stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

struct Chunk {  // 48 bytes, written by the caller as six int64 values
  uint64_t p, g, m, v;
  int32_t n;    // at most 65536
  float wd;
  float mult;   // the tensor's rate multiplier
  int32_t vec;  // 1: every pointer is 16-byte aligned
};
static_assert(sizeof(Chunk) == 48, "six int64 values an entry");

constexpr int THREADS = 256;
constexpr int VEC = 8;

struct Hyper {
  float b1, b2, eps;
  int decoupled;
};

struct Step {  // what the device array gives a block: this step's scalars
  float lr, bc1, bc2;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One element at the rate lr; returns the new parameter value, updates m
// and v in place.
__device__ __forceinline__ float adam(float p, float g, float& m, float& v, float wd,
                                      float lr, const Step& st, const Hyper& h) {
  if (!h.decoupled) g = __fadd_rn(g, __fmul_rn(wd, p));
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(__fsub_rn(1.f, h.b1), g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(__fsub_rn(1.f, h.b2), g), g));
  const float mhat = __fdiv_rn(m, st.bc1);
  const float vhat = __fdiv_rn(v, st.bc2);
  const float upd = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), h.eps));
  if (h.decoupled) p = __fmul_rn(p, __fsub_rn(1.f, __fmul_rn(lr, wd)));
  return __fsub_rn(p, __fmul_rn(lr, upd));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
adamw_kernel(const Chunk* __restrict__ table, const float* __restrict__ scalars,
             Hyper h) {
  const Chunk c = table[blockIdx.x];
  const Step st{scalars[0], scalars[1], scalars[2]};
  T* p = reinterpret_cast<T*>(c.p);
  const T* g = reinterpret_cast<const T*>(c.g);
  float* m = reinterpret_cast<float*>(c.m);
  float* v = reinterpret_cast<float*>(c.v);
  const int64_t n = c.n;
  const float lr = __fmul_rn(st.lr, c.mult);
  int64_t done = 0;
  if (c.vec) {
    const int64_t n_vec = n / VEC * VEC;
    for (int64_t i = (int64_t)threadIdx.x * VEC; i < n_vec; i += (int64_t)THREADS * VEC) {
      alignas(16) T pv[VEC];
      alignas(16) T gv[VEC];
      alignas(16) float mv[VEC];
      alignas(16) float vv[VEC];
      static_assert(sizeof(T) * VEC % 16 == 0, "whole 16-byte accesses");
#pragma unroll
      for (int w = 0; w < (int)(sizeof(T) * VEC / 16); ++w) {
        reinterpret_cast<uint4*>(pv)[w] = reinterpret_cast<const uint4*>(p + i)[w];
        reinterpret_cast<uint4*>(gv)[w] = reinterpret_cast<const uint4*>(g + i)[w];
      }
#pragma unroll
      for (int w = 0; w < VEC / 4; ++w) {
        reinterpret_cast<float4*>(mv)[w] = reinterpret_cast<const float4*>(m + i)[w];
        reinterpret_cast<float4*>(vv)[w] = reinterpret_cast<const float4*>(v + i)[w];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        pv[e] = from_f<T>(adam(to_f(pv[e]), to_f(gv[e]), mv[e], vv[e], c.wd, lr, st, h));
#pragma unroll
      for (int w = 0; w < (int)(sizeof(T) * VEC / 16); ++w)
        reinterpret_cast<uint4*>(p + i)[w] = reinterpret_cast<const uint4*>(pv)[w];
#pragma unroll
      for (int w = 0; w < VEC / 4; ++w) {
        reinterpret_cast<float4*>(m + i)[w] = reinterpret_cast<const float4*>(mv)[w];
        reinterpret_cast<float4*>(v + i)[w] = reinterpret_cast<const float4*>(vv)[w];
      }
    }
    done = n_vec;
  }
  for (int64_t i = done + threadIdx.x; i < n; i += THREADS) {
    float mi = m[i], vi = v[i];
    p[i] = from_f<T>(adam(to_f(p[i]), to_f(g[i]), mi, vi, c.wd, lr, st, h));
    m[i] = mi;
    v[i] = vi;
  }
}

}  // namespace

extern "C" {

// table: device array of n_chunks Chunk entries; scalars: device float32
// [lr, bc1, bc2]; dtype: 0 = float32, 1 = bfloat16 (the parameters' and
// gradients' type). Returns a cudaError_t value.
int ptt_adamw(const void* table, int n_chunks, int dtype, const void* scalars, float b1,
              float b2, float eps, int decoupled, void* stream) {
  if (n_chunks == 0) return 0;
  if (n_chunks < 0) return (int)cudaErrorInvalidValue;
  const Hyper h{b1, b2, eps, decoupled};
  const float* sc = static_cast<const float*>(scalars);
  const Chunk* t = static_cast<const Chunk*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    adamw_kernel<float><<<n_chunks, THREADS, 0, s>>>(t, sc, h);
  else if (dtype == 1)
    adamw_kernel<__nv_bfloat16><<<n_chunks, THREADS, 0, s>>>(t, sc, h);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
