// RNN-T (transducer) loss, forward and backward (Hopper, sm_90a).
//
// No TPU kernel: the JAX package's rnnt_loss (paddle_tpu/nn/functional/
// loss.py:363) is an alpha recursion over the (T, U+1) lattice written as
// a jax.lax.scan over time with a scan over the labels inside it (:405),
// which XLA compiles into nested while loops; its gradient is JAX's
// autodiff of those scans. The arithmetic here is the JAX function's, in
// fp32 (kernels/seq_loss.py holds its plain version beside these kernels):
//   lp = log_softmax(x) over V; blank(t, u) = lp[.., blank]; emit(t, u) =
//   lp[.., label u] (u < the sample's label length l); alpha(0, 0) = 0;
//   alpha(t, u) = lae(alpha(t-1, u) + blank(t-1, u), alpha(t, u-1) +
//   emit(t, u-1)), the first term NEG = -1e30 at t = 0 and the second
//   absent at u = 0; nll = -(alpha(t_last, l) + blank(t_last, l)), with
//   lae(a, b) = max + log1p(exp(-|a - b|)).
// The backward is the recursion's adjoint G: each cell pulls its two
// successors' adjoints, each times exp(input - out) (JAX's rule for lae;
// 1 where a cell is a plain sum), from (t_last, l) back to (0, 0); the
// emissions' share is scaled by 1 + fastemit_lambda (the loss value is not);
// then dx = G_v - softmax_v * sum_v' G_v', G non-zero at blank and at the
// cell's label only.
//
// Four kernels, two a call:
//   forward:  rnnt_rows_kernel (one warp a (b, t, u) row of the joint,
//             inside the sample's t <= t_last, u <= l: the row's
//             log-sum-exp in one pass, 16-byte loads, a running max and sum
//             per lane merged across the warp; the blank and label
//             log-probs gathered; the log-softmax is never written), then
//             rnnt_alpha_kernel (one block a sample: the lattice by
//             anti-diagonals, t_last + l + 1 of them, the cells of one
//             across the threads, the previous one in shared memory, a
//             barrier between; alphas stored for the backward).
//   backward: rnnt_adjoint_kernel (one block a sample, anti-diagonals in
//             reverse, the next one's adjoints in shared memory: the blank
//             and emission log-probs' gradients), then
//             rnnt_grad_rows_kernel (one warp a row: x and the row's
//             log-sum-exp read once, dx written once; zeros outside the
//             sample's lattice).
// No float atomics: every sum runs in a fixed order, so two runs give the
// same bits.
//
// Bound on the H100: bytes for the row passes, latency for the lattice. At
// the Conformer-Transducer joint [16, 200, 61, 1024] fp32 the logits are
// 800 MB: the forward's pass reads the rows inside the lattices once (about
// 0.24 ms at 3.35 TB/s for all of them), the backward's reads them and
// writes dx whole (about 0.48 ms). The recursions are T + U dependent
// steps (about 260), each a barrier and a few reads from L2; one block a
// sample fills 16 of the 132 SMs. Splitting a sample over blocks is not
// done here.
//
// Plain C interface, loaded with ctypes. Launches go on the caller's
// stream; each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int ROW_WARPS = 8;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// P values of a row from p: one 16-byte load (P = 16 / sizeof(T)), or one
// value (P = 1).
template <typename T, int P>
__device__ __forceinline__ void load_pack(const T* p, float* v) {
  if constexpr (P == 1) {
    v[0] = to_f(p[0]);
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < P; ++i) v[i] = to_f(e[i]);
  }
}

template <typename T, int P>
__device__ __forceinline__ void store_pack(T* p, const float* v) {
  if constexpr (P == 1) {
    p[0] = from_f<T>(v[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < P; ++i) e[i] = from_f<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// JAX's logaddexp of finite values: max + log1p(exp(-|a - b|)).
__device__ __forceinline__ float lae(float a, float b) {
  return __fadd_rn(fmaxf(a, b), log1pf(expf(-fabsf(__fsub_rn(a, b)))));
}

// The row a warp works on and the sample's lattice bounds.
struct Cell {
  int64_t r;   // row index, ((b * T) + t) * (U + 1) + u
  int b, t, u, tl, lb;
};

__device__ __forceinline__ bool cell_of(const int* ilen, const int* llen, int B, int T, int U,
                                        Cell& c) {
  c.r = (int64_t)blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (c.r >= (int64_t)B * T * (U + 1)) return false;
  c.u = (int)(c.r % (U + 1));
  const int64_t bt = c.r / (U + 1);
  c.t = (int)(bt % T);
  c.b = (int)(bt / T);
  c.tl = min(max(ilen[c.b] - 1, 0), T - 1);
  c.lb = min(max(llen[c.b], 0), U);
  return true;
}

__device__ __forceinline__ int clamp_class(int c, int V) { return min(max(c, 0), V - 1); }

template <typename T, int P>
__global__ void __launch_bounds__(ROW_WARPS * 32)
rnnt_rows_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                 const int* __restrict__ ilen, const int* __restrict__ llen, int B, int T_,
                 int U, int V, int blank, float* __restrict__ lse, float* __restrict__ blp,
                 float* __restrict__ elp) {
  Cell c;
  if (!cell_of(ilen, llen, B, T_, U, c) || c.t > c.tl || c.u > c.lb) return;
  const int lane = threadIdx.x & 31;
  const T* row = x + c.r * V;
  float m = -3.402823466e38f, s = 0.f;  // -FLT_MAX: a lane with no values adds 0
  const int packs = V / P;
#pragma unroll 4
  for (int p = lane; p < packs; p += 32) {
    float v[P];
    load_pack<T, P>(row + (int64_t)p * P, v);
    float pm = v[0];
#pragma unroll
    for (int i = 1; i < P; ++i) pm = fmaxf(pm, v[i]);
    const float nm = fmaxf(m, pm);
    s = __fmul_rn(s, expf(__fsub_rn(m, nm)));
#pragma unroll
    for (int i = 0; i < P; ++i) s = __fadd_rn(s, expf(__fsub_rn(v[i], nm)));
    m = nm;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, o);
    const float os = __shfl_xor_sync(0xffffffffu, s, o);
    const float nm = fmaxf(m, om);
    s = __fadd_rn(__fmul_rn(s, expf(__fsub_rn(m, nm))), __fmul_rn(os, expf(__fsub_rn(om, nm))));
    m = nm;
  }
  if (lane != 0) return;
  const float ls = logf(s);
  lse[c.r] = __fadd_rn(m, ls);
  blp[c.r] = __fsub_rn(__fsub_rn(to_f(row[blank]), m), ls);
  if (c.u < c.lb) {
    const int eu = U > 0 ? U : 1;
    const int lab = clamp_class(labels[(int64_t)c.b * U + c.u], V);
    elp[((int64_t)c.b * T_ + c.t) * eu + c.u] = __fsub_rn(__fsub_rn(to_f(row[lab]), m), ls);
  }
}

__global__ void rnnt_alpha_kernel(const int* __restrict__ ilen, const int* __restrict__ llen,
                                  int T_, int U, const float* __restrict__ blp,
                                  const float* __restrict__ elp, float* __restrict__ alpha,
                                  float* __restrict__ nll) {
  extern __shared__ float sm[];
  const int U1 = U + 1, eu = U > 0 ? U : 1;
  const int b = blockIdx.x;
  const int tl = min(max(ilen[b] - 1, 0), T_ - 1), lb = min(max(llen[b], 0), U);
  const float* bl = blp + (int64_t)b * T_ * U1;
  const float* el = elp + (int64_t)b * T_ * eu;
  float* al = alpha + (int64_t)b * T_ * U1;
  float* prev = sm;        // the previous anti-diagonal's alphas, by u
  float* cur = sm + U1;
  for (int d = 0; d <= tl + lb; ++d) {
    for (int u = threadIdx.x; u <= lb; u += blockDim.x) {
      const int t = d - u;
      if (t < 0 || t > tl) continue;
      float v;
      if (u == 0) {
        v = t == 0 ? 0.f : __fadd_rn(prev[0], bl[(int64_t)(t - 1) * U1]);
      } else {
        const float a = t > 0 ? __fadd_rn(prev[u], bl[(int64_t)(t - 1) * U1 + u]) : NEG;
        const float e = __fadd_rn(prev[u - 1], el[(int64_t)t * eu + u - 1]);
        v = lae(a, e);
      }
      cur[u] = v;
      al[(int64_t)t * U1 + u] = v;
    }
    __syncthreads();
    float* tmp = prev;
    prev = cur;
    cur = tmp;
  }
  if (threadIdx.x == 0) nll[b] = -__fadd_rn(prev[lb], bl[(int64_t)tl * U1 + lb]);
}

__global__ void rnnt_adjoint_kernel(const int* __restrict__ ilen, const int* __restrict__ llen,
                                    int T_, int U, float emit_scale,
                                    const float* __restrict__ blp, const float* __restrict__ elp,
                                    const float* __restrict__ alpha, const float* __restrict__ g,
                                    float* __restrict__ gblank, float* __restrict__ gemit) {
  extern __shared__ float sm[];
  const int U1 = U + 1, eu = U > 0 ? U : 1;
  const int b = blockIdx.x;
  const int tl = min(max(ilen[b] - 1, 0), T_ - 1), lb = min(max(llen[b], 0), U);
  const int64_t base = (int64_t)b * T_ * U1, ebase = (int64_t)b * T_ * eu;
  const float* bl = blp + base;
  const float* el = elp + ebase;
  const float* al = alpha + base;
  const float gb = g[b];
  float* nxt = sm;          // the next anti-diagonal's adjoints, by u
  float* cur = sm + U1;
  for (int d = tl + lb; d >= 0; --d) {
    for (int u = threadIdx.x; u <= lb; u += blockDim.x) {
      const int t = d - u;
      if (t < 0 || t > tl) continue;
      const float a = al[(int64_t)t * U1 + u];
      const float seed = (t == tl && u == lb) ? -gb : 0.f;
      float from_t = 0.f, from_u = 0.f;
      if (t < tl) {
        const float w = u == 0 ? 1.f
                               : expf(__fsub_rn(__fadd_rn(a, bl[(int64_t)t * U1 + u]),
                                                al[(int64_t)(t + 1) * U1 + u]));
        from_t = __fmul_rn(nxt[u], w);
      }
      if (u < lb) {
        const float w = expf(__fsub_rn(__fadd_rn(a, el[(int64_t)t * eu + u]),
                                       al[(int64_t)t * U1 + u + 1]));
        from_u = __fmul_rn(nxt[u + 1], w);
        gemit[ebase + (int64_t)t * eu + u] = __fmul_rn(from_u, emit_scale);
      }
      cur[u] = __fadd_rn(seed, __fadd_rn(from_t, from_u));
      gblank[base + (int64_t)t * U1 + u] = __fadd_rn(seed, from_t);
    }
    __syncthreads();
    float* tmp = nxt;
    nxt = cur;
    cur = tmp;
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(ROW_WARPS * 32)
rnnt_grad_rows_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                      const int* __restrict__ ilen, const int* __restrict__ llen, int B, int T_,
                      int U, int V, int blank, const float* __restrict__ lse,
                      const float* __restrict__ gblank, const float* __restrict__ gemit,
                      T* __restrict__ dx) {
  Cell c;
  if (!cell_of(ilen, llen, B, T_, U, c)) return;
  const int lane = threadIdx.x & 31;
  const int packs = V / P;
  T* out = dx + c.r * V;
  if (c.t > c.tl || c.u > c.lb) {
    float z[P];
#pragma unroll
    for (int i = 0; i < P; ++i) z[i] = 0.f;
    for (int p = lane; p < packs; p += 32) store_pack<T, P>(out + (int64_t)p * P, z);
    return;
  }
  const int eu = U > 0 ? U : 1;
  const float gb = gblank[c.r];
  float ge = 0.f;
  int lab = -1;
  if (c.u < c.lb) {
    ge = gemit[((int64_t)c.b * T_ + c.t) * eu + c.u];
    lab = clamp_class(labels[(int64_t)c.b * U + c.u], V);
  }
  const float total = __fadd_rn(gb, ge);
  const float l = lse[c.r];
  const T* row = x + c.r * V;
#pragma unroll 4
  for (int p = lane; p < packs; p += 32) {
    float v[P];
    load_pack<T, P>(row + (int64_t)p * P, v);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int col = p * P + i;
      const float gl = __fadd_rn(col == blank ? gb : 0.f, col == lab ? ge : 0.f);
      v[i] = __fsub_rn(gl, __fmul_rn(expf(__fsub_rn(v[i], l)), total));
    }
    store_pack<T, P>(out + (int64_t)p * P, v);
  }
}

int threads_for(int n) { return n >= 1024 ? 1024 : ((n + 31) / 32) * 32; }

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes > 48 * 1024)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
  return 0;
}

// 16-byte packs where every row starts on a 16-byte boundary, else single
// values.
template <typename T>
bool packed(const void* x, const void* dx, int V) {
  constexpr int P = 16 / sizeof(T);
  return V % P == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(dx) % 16 == 0;
}

unsigned row_blocks(int B, int T, int U) {
  return (unsigned)(((int64_t)B * T * (U + 1) + ROW_WARPS - 1) / ROW_WARPS);
}

template <typename T>
int forward(const T* x, const int* labels, const int* ilen, const int* llen, int B, int T_,
            int U, int V, int blank, float* lse, float* blp, float* elp, float* alpha,
            float* nll, cudaStream_t s) {
  constexpr int P = 16 / sizeof(T);
  const unsigned grid = row_blocks(B, T_, U);
  if (packed<T>(x, x, V))
    rnnt_rows_kernel<T, P><<<grid, ROW_WARPS * 32, 0, s>>>(x, labels, ilen, llen, B, T_, U, V,
                                                             blank, lse, blp, elp);
  else
    rnnt_rows_kernel<T, 1><<<grid, ROW_WARPS * 32, 0, s>>>(x, labels, ilen, llen, B, T_, U, V,
                                                             blank, lse, blp, elp);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const size_t smem = 2 * (size_t)(U + 1) * sizeof(float);
  if ((err = set_smem(rnnt_alpha_kernel, smem))) return err;
  rnnt_alpha_kernel<<<B, threads_for(U + 1), smem, s>>>(ilen, llen, T_, U, blp, elp, alpha, nll);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const T* x, const int* labels, const int* ilen, const int* llen, int B, int T_,
             int U, int V, int blank, float emit_scale, const float* lse, const float* blp,
             const float* elp, const float* alpha, const float* g, float* gblank, float* gemit,
             T* dx, cudaStream_t s) {
  constexpr int P = 16 / sizeof(T);
  const size_t smem = 2 * (size_t)(U + 1) * sizeof(float);
  int err = set_smem(rnnt_adjoint_kernel, smem);
  if (err) return err;
  rnnt_adjoint_kernel<<<B, threads_for(U + 1), smem, s>>>(ilen, llen, T_, U, emit_scale, blp,
                                                           elp, alpha, g, gblank, gemit);
  if ((err = (int)cudaGetLastError())) return err;
  const unsigned grid = row_blocks(B, T_, U);
  if (packed<T>(x, dx, V))
    rnnt_grad_rows_kernel<T, P><<<grid, ROW_WARPS * 32, 0, s>>>(
        x, labels, ilen, llen, B, T_, U, V, blank, lse, gblank, gemit, dx);
  else
    rnnt_grad_rows_kernel<T, 1><<<grid, ROW_WARPS * 32, 0, s>>>(
        x, labels, ilen, llen, B, T_, U, V, blank, lse, gblank, gemit, dx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [B, T, U + 1, V] logits (dtype 0 = float32, 1 = bfloat16); labels
// [B, U], ilen [B], llen [B] int32; lse, blp, alpha [B, T, U + 1], elp
// [B, T, max(U, 1)], nll [B] float32, written. Returns a cudaError_t value.
int ptt_rnnt_forward(const void* x, int dtype, const void* labels, const void* ilen,
                     const void* llen, int B, int T, int U, int V, int blank, void* lse,
                     void* blp, void* elp, void* alpha, void* nll, void* stream) {
  if (B <= 0 || T <= 0 || U < 0 || V <= 0 || blank < 0 || blank >= V)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const int* il = static_cast<const int*>(ilen);
  const int* ll = static_cast<const int*>(llen);
  float* f[5] = {static_cast<float*>(lse), static_cast<float*>(blp), static_cast<float*>(elp),
                 static_cast<float*>(alpha), static_cast<float*>(nll)};
  if (dtype == 0)
    return forward(static_cast<const float*>(x), lab, il, ll, B, T, U, V, blank, f[0], f[1], f[2],
                   f[3], f[4], s);
  if (dtype == 1)
    return forward(static_cast<const __nv_bfloat16*>(x), lab, il, ll, B, T, U, V, blank, f[0],
                   f[1], f[2], f[3], f[4], s);
  return (int)cudaErrorInvalidValue;
}

// As the forward's, with emit_scale = 1 + fastemit_lambda, the forward's
// lse, blp, elp and alpha, the upstream gradient g [B] float32, scratch
// gblank [B, T, U + 1] and gemit [B, T, max(U, 1)] float32, and dx in x's
// dtype and shape, written.
int ptt_rnnt_backward(const void* x, int dtype, const void* labels, const void* ilen,
                      const void* llen, int B, int T, int U, int V, int blank, float emit_scale,
                      const void* lse, const void* blp, const void* elp, const void* alpha,
                      const void* g, void* gblank, void* gemit, void* dx, void* stream) {
  if (B <= 0 || T <= 0 || U < 0 || V <= 0 || blank < 0 || blank >= V)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const int* il = static_cast<const int*>(ilen);
  const int* ll = static_cast<const int*>(llen);
  const float* c[5] = {static_cast<const float*>(lse), static_cast<const float*>(blp),
                       static_cast<const float*>(elp), static_cast<const float*>(alpha),
                       static_cast<const float*>(g)};
  float* gb = static_cast<float*>(gblank);
  float* ge = static_cast<float*>(gemit);
  if (dtype == 0)
    return backward(static_cast<const float*>(x), lab, il, ll, B, T, U, V, blank, emit_scale,
                    c[0], c[1], c[2], c[3], c[4], gb, ge, static_cast<float*>(dx), s);
  if (dtype == 1)
    return backward(static_cast<const __nv_bfloat16*>(x), lab, il, ll, B, T, U, V, blank,
                    emit_scale, c[0], c[1], c[2], c[3], c[4], gb, ge,
                    static_cast<__nv_bfloat16*>(dx), s);
  return (int)cudaErrorInvalidValue;
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
