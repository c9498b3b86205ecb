// CTC loss, forward and backward (Hopper, sm_90a).
//
// No TPU kernel: the JAX package's ctc_loss (paddle_tpu/nn/functional/
// loss.py:282) is an alpha recursion in the log semiring written as one
// jax.lax.scan over time, which XLA compiles into a while loop; its
// gradient is JAX's autodiff of that scan. The arithmetic here is the JAX
// function's, in fp32 (kernels/seq_loss.py says what it is and holds its
// plain version beside these kernels):
//   lp = log_softmax(x) over C; ext = blank, l1, blank, l2, ..., blank
//   (S = 2L + 1 states); alpha_0 = lp[0, blank], lp[0, l1] (NEG = -1e30
//   elsewhere); alpha_t(s) = lae(lae(alpha(s), alpha(s-1)), alpha(s-2) if
//   the skip is allowed) + lp[t, ext[s]]; nll = -lae(alpha_{t_last}(2l),
//   alpha_{t_last}(2l - 1)), with lae(a, b) = max + log1p(exp(-|a - b|)).
// The backward is that recursion's adjoint, run from t_last down to 0:
// each lae hands its output's adjoint G to an input x as G * exp(x - out)
// (JAX's rule; so infeasible samples, all at the floor, get JAX's finite
// gradient), then dx = gLP - softmax * sum(gLP), gLP[c] the sum of the
// adjoints of the states whose label is c.
//
// Four kernels, two a call:
//   forward:  ctc_rows_kernel (one warp a (t, b) row up to the sample's
//             t_last: the row's log-sum-exp, and the log-probs of blank
//             and of the sample's labels, [B, T, L + 1]), then
//             ctc_alpha_kernel (one block a sample: its 2l + 1 states
//             across the threads, double-buffered in shared memory, one
//             barrier a time step; every step's alphas stored, [B, T, S],
//             for the backward).
//   backward: ctc_adjoint_kernel (one block a sample: the adjoints, from
//             t_last back, stored [B, T, S]; the sample's label positions
//             sorted by label, for the row pass), then ctc_grad_rows_kernel
//             (one warp a row: dx = -softmax * sum(G) over the row, then
//             at blank and at each distinct label the sum of its states'
//             adjoints, in a fixed order; zeros past t_last).
// No float atomics: every sum runs in a fixed order, so two runs give the
// same bits.
//
// Bound on the H100: the recursion's dependent steps, not bytes. At
// [500, 32, 29] the logits are 1.9 MB (0.6 us at 3.35 TB/s), while each
// sample's 500 time steps run one after the other, each a barrier and a
// shared-memory exchange between neighbouring states; one block a sample
// fills 32 of the 132 SMs. The design keeps the steps short: the states
// and their neighbours in shared memory, the time step's log-probs
// gathered beforehand into a row of L + 1 values (not S), read one step
// ahead. Splitting a sample over blocks is not done here.
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

// JAX's logaddexp of finite values: max + log1p(exp(-|a - b|)).
__device__ __forceinline__ float lae(float a, float b) {
  return __fadd_rn(fmaxf(a, b), log1pf(expf(-fabsf(__fsub_rn(a, b)))));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int t_last_of(const int* ilen, int b, int T) {
  return min(max(ilen[b] - 1, 0), T - 1);
}

__device__ __forceinline__ int len_of(const int* llen, int b, int L) {
  return min(max(llen[b], 0), L);
}

__device__ __forceinline__ int clamp_class(int c, int C) { return min(max(c, 0), C - 1); }

// The (t, b) row's max and log(sum(exp(x - max))), in every lane.
template <typename T>
__device__ __forceinline__ void row_stats(const T* row, int C, int lane, float& m, float& ls) {
  m = -3.402823466e38f;  // -FLT_MAX
  for (int c = lane; c < C; c += 32) m = fmaxf(m, to_f(row[c]));
  m = warp_max(m);
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s = __fadd_rn(s, expf(__fsub_rn(to_f(row[c]), m)));
  ls = logf(warp_sum(s));
}

template <typename T>
__global__ void __launch_bounds__(ROW_WARPS * 32)
ctc_rows_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                const int* __restrict__ ilen, const int* __restrict__ llen, int T_, int B,
                int C, int L, int blank, float* __restrict__ lse, float* __restrict__ lpl) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (r >= (int64_t)T_ * B) return;
  const int t = (int)(r / B), b = (int)(r % B);
  if (t > t_last_of(ilen, b, T_)) return;
  const T* row = x + r * C;
  float m, ls;
  row_stats(row, C, lane, m, ls);
  if (lane == 0) lse[r] = __fadd_rn(m, ls);
  const int lb = len_of(llen, b, L);
  float* out = lpl + ((int64_t)b * T_ + t) * (L + 1);
  for (int k = lane; k <= lb; k += 32) {
    const int c = k == 0 ? blank : clamp_class(labels[(int64_t)b * L + k - 1], C);
    out[k] = __fsub_rn(__fsub_rn(to_f(row[c]), m), ls);
  }
}

// Whether the skip s-2 -> s is allowed (s odd, >= 3, its label not the
// one before).
__device__ __forceinline__ bool skip_ok(const int* lab, int s) {
  return (s & 1) && s >= 3 && lab[(s - 1) >> 1] != lab[(s - 3) >> 1];
}

// lpl index of state s's log-prob: 0 for blank, 1 + l for label l.
__device__ __forceinline__ int lp_index(int s) { return (s & 1) ? (s + 1) >> 1 : 0; }

__global__ void ctc_alpha_kernel(const int* __restrict__ labels, const int* __restrict__ ilen,
                                 const int* __restrict__ llen, int T_, int L,
                                 const float* __restrict__ lpl, float* __restrict__ alpha,
                                 float* __restrict__ nll) {
  extern __shared__ float sm[];
  const int S = 2 * L + 1;
  const int b = blockIdx.x;
  const int lb = len_of(llen, b, L), Sb = 2 * lb + 1, tl = t_last_of(ilen, b, T_);
  float* cur = sm;
  float* nxt = sm + S;
  int* lab = reinterpret_cast<int*>(sm + 2 * S);
  for (int l = threadIdx.x; l < lb; l += blockDim.x) lab[l] = labels[(int64_t)b * L + l];
  const float* lp = lpl + (int64_t)b * T_ * (L + 1);
  float* hist = alpha + (int64_t)b * T_ * S;
  for (int s = threadIdx.x; s < Sb; s += blockDim.x) {
    const float v = s < 2 ? lp[s] : NEG;
    cur[s] = v;
    hist[s] = v;
  }
  __syncthreads();
  // the first state a thread holds: its log-prob is read a step ahead
  const int s0 = threadIdx.x;
  float em_next = (s0 < Sb && tl >= 1) ? lp[(int64_t)(L + 1) + lp_index(s0)] : 0.f;
  for (int t = 1; t <= tl; ++t) {
    const float* e = lp + (int64_t)t * (L + 1);
    for (int s = s0; s < Sb; s += blockDim.x) {
      const float st = cur[s];
      const float p1 = s >= 1 ? cur[s - 1] : NEG;
      const float p2 = skip_ok(lab, s) ? cur[s - 2] : NEG;
      const float em = s == s0 ? em_next : e[lp_index(s)];
      const float v = __fadd_rn(lae(lae(st, p1), p2), em);
      nxt[s] = v;
      hist[(int64_t)t * S + s] = v;
    }
    if (s0 < Sb && t < tl) em_next = e[(L + 1) + lp_index(s0)];
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if (threadIdx.x == 0) {
    const float e1 = cur[2 * lb];
    const float e2 = lb > 0 ? cur[2 * lb - 1] : NEG;
    nll[b] = -lae(e1, e2);
  }
}

// The adjoints G_t(s) of every state, t_last down to 0, into g_out
// [B, T, S] (at t = 0 only the states the log-probs reach: 0, and 1 where
// l > 0), and the sample's label positions sorted by (label, position)
// into order [B, L].
__global__ void ctc_adjoint_kernel(const int* __restrict__ labels, const int* __restrict__ ilen,
                                   const int* __restrict__ llen, int T_, int L, int norm_by_times,
                                   const float* __restrict__ alpha, const float* __restrict__ g,
                                   float* __restrict__ g_out, int* __restrict__ order) {
  extern __shared__ float sm[];
  const int S = 2 * L + 1;
  const int b = blockIdx.x;
  const int lb = len_of(llen, b, L), Sb = 2 * lb + 1, tl = t_last_of(ilen, b, T_);
  float* gc = sm;           // G_t
  float* gn = sm + S;       // G_{t-1}
  float* c_st = sm + 2 * S;
  float* c_p1 = sm + 3 * S;
  float* c_p2 = sm + 4 * S;
  int* lab = reinterpret_cast<int*>(sm + 5 * S);
  for (int l = threadIdx.x; l < lb; l += blockDim.x) lab[l] = labels[(int64_t)b * L + l];
  __syncthreads();
  for (int l = threadIdx.x; l < lb; l += blockDim.x) {
    int rank = 0;
    for (int k = 0; k < lb; ++k) rank += (lab[k] < lab[l]) || (lab[k] == lab[l] && k < l);
    order[(int64_t)b * L + rank] = l;
  }
  const float* hist = alpha + (int64_t)b * T_ * S;
  float* gout = g_out + (int64_t)b * T_ * S;
  float gb = g[b];
  if (norm_by_times) gb = __fmul_rn(gb, __fdiv_rn(1.f, fmaxf((float)ilen[b], 1.f)));
  {
    const float* at = hist + (int64_t)tl * S;
    const float e1 = at[2 * lb];
    const float e2 = lb > 0 ? at[2 * lb - 1] : NEG;
    const float ll = lae(e1, e2);
    for (int s = threadIdx.x; s < Sb; s += blockDim.x) {
      float v = 0.f;
      if (s == 2 * lb) v = __fmul_rn(-gb, expf(__fsub_rn(e1, ll)));
      if (lb > 0 && s == 2 * lb - 1) v = __fmul_rn(-gb, expf(__fsub_rn(e2, ll)));
      gc[s] = v;
    }
  }
  __syncthreads();
  for (int t = tl; t >= 1; --t) {
    const float* prev = hist + (int64_t)(t - 1) * S;
    for (int s = threadIdx.x; s < Sb; s += blockDim.x) {
      const float G = gc[s];
      gout[(int64_t)t * S + s] = G;
      const float st = prev[s];
      const float p1 = s >= 1 ? prev[s - 1] : NEG;
      const bool sk = skip_ok(lab, s);
      const float p2 = sk ? prev[s - 2] : NEG;
      const float u = lae(st, p1);
      const float m = lae(u, p2);
      const float a = __fmul_rn(G, expf(__fsub_rn(u, m)));
      c_st[s] = __fmul_rn(a, expf(__fsub_rn(st, u)));
      c_p1[s] = s >= 1 ? __fmul_rn(a, expf(__fsub_rn(p1, u))) : 0.f;
      c_p2[s] = sk ? __fmul_rn(G, expf(__fsub_rn(p2, m))) : 0.f;
    }
    __syncthreads();
    for (int s = threadIdx.x; s < Sb; s += blockDim.x) {
      float v = c_st[s];
      if (s + 1 < Sb) v = __fadd_rn(v, c_p1[s + 1]);
      if (s + 2 < Sb) v = __fadd_rn(v, c_p2[s + 2]);
      gn[s] = v;
    }
    __syncthreads();
    float* tmp = gc;
    gc = gn;
    gn = tmp;
  }
  for (int s = threadIdx.x; s < Sb; s += blockDim.x)
    gout[s] = (s == 0 || (s == 1 && lb > 0)) ? gc[s] : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(ROW_WARPS * 32)
ctc_grad_rows_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                     const int* __restrict__ ilen, const int* __restrict__ llen, int T_, int B,
                     int C, int L, int blank, const float* __restrict__ lse,
                     const float* __restrict__ g_states, const int* __restrict__ order,
                     T* __restrict__ dx) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (r >= (int64_t)T_ * B) return;
  const int t = (int)(r / B), b = (int)(r % B);
  T* out = dx + r * C;
  if (t > t_last_of(ilen, b, T_)) {
    for (int c = lane; c < C; c += 32) out[c] = from_f<T>(0.f);
    return;
  }
  const int S = 2 * L + 1;
  const int lb = len_of(llen, b, L), Sb = 2 * lb + 1;
  const float* G = g_states + ((int64_t)b * T_ + t) * S;
  float total = 0.f, blank_sum = 0.f;
  for (int s = lane; s < Sb; s += 32) {
    const float v = G[s];
    total = __fadd_rn(total, v);
    if (!(s & 1)) blank_sum = __fadd_rn(blank_sum, v);
  }
  total = warp_sum(total);
  blank_sum = warp_sum(blank_sum);
  const T* row = x + r * C;
  const float l = lse[r];
  for (int c = lane; c < C; c += 32)
    out[c] = from_f<T>(-__fmul_rn(expf(__fsub_rn(to_f(row[c]), l)), total));
  __syncwarp();
  // at blank and each distinct label: its states' adjoints, summed in
  // (label, position) order by the lane that holds the label's first
  // position in that order
  const int* ord = order + (int64_t)b * L;
  const int* lab = labels + (int64_t)b * L;
  bool blank_labelled = false;
  for (int k = lane; k < lb; k += 32) {
    const int c = clamp_class(lab[ord[k]], C);
    blank_labelled |= c == blank;
    if (k > 0 && clamp_class(lab[ord[k - 1]], C) == c) continue;
    float sum = c == blank ? blank_sum : 0.f;
    for (int j = k; j < lb && clamp_class(lab[ord[j]], C) == c; ++j)
      sum = __fadd_rn(sum, G[2 * ord[j] + 1]);
    const float p = expf(__fsub_rn(to_f(row[c]), l));
    out[c] = from_f<T>(__fsub_rn(sum, __fmul_rn(p, total)));
  }
  blank_labelled = __any_sync(0xffffffffu, blank_labelled);
  if (lane == 0 && !blank_labelled) {
    const float p = expf(__fsub_rn(to_f(row[blank]), l));
    out[blank] = from_f<T>(__fsub_rn(blank_sum, __fmul_rn(p, total)));
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

template <typename T>
int forward(const T* x, const int* labels, const int* ilen, const int* llen, int T_, int B,
            int C, int L, int blank, float* lse, float* lpl, float* alpha, float* nll,
            cudaStream_t s) {
  const int64_t rows = (int64_t)T_ * B;
  ctc_rows_kernel<T><<<(unsigned)((rows + ROW_WARPS - 1) / ROW_WARPS), ROW_WARPS * 32, 0, s>>>(
      x, labels, ilen, llen, T_, B, C, L, blank, lse, lpl);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int S = 2 * L + 1;
  const size_t smem = 2 * S * sizeof(float) + (size_t)(L > 0 ? L : 1) * sizeof(int);
  if ((err = set_smem(ctc_alpha_kernel, smem))) return err;
  ctc_alpha_kernel<<<B, threads_for(S), smem, s>>>(labels, ilen, llen, T_, L, lpl, alpha, nll);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const T* x, const int* labels, const int* ilen, const int* llen, int T_, int B,
             int C, int L, int blank, int norm_by_times, const float* lse, const float* alpha,
             const float* g, float* g_states, int* order, T* dx, cudaStream_t s) {
  const int S = 2 * L + 1;
  const size_t smem = 5 * S * sizeof(float) + (size_t)(L > 0 ? L : 1) * sizeof(int);
  int err = set_smem(ctc_adjoint_kernel, smem);
  if (err) return err;
  ctc_adjoint_kernel<<<B, threads_for(S), smem, s>>>(labels, ilen, llen, T_, L, norm_by_times,
                                                      alpha, g, g_states, order);
  if ((err = (int)cudaGetLastError())) return err;
  const int64_t rows = (int64_t)T_ * B;
  ctc_grad_rows_kernel<T><<<(unsigned)((rows + ROW_WARPS - 1) / ROW_WARPS), ROW_WARPS * 32, 0,
                            s>>>(x, labels, ilen, llen, T_, B, C, L, blank, lse, g_states,
                                 order, dx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [T, B, C] logits (dtype 0 = float32, 1 = bfloat16); labels [B, L],
// ilen [B], llen [B] int32; lse [T, B], lpl [B, T, L + 1], alpha
// [B, T, 2L + 1], nll [B] float32, written. Returns a cudaError_t value.
int ptt_ctc_forward(const void* x, int dtype, const void* labels, const void* ilen,
                    const void* llen, int T, int B, int C, int L, int blank, void* lse, void* lpl,
                    void* alpha, void* nll, void* stream) {
  if (T <= 0 || B <= 0 || C <= 0 || L < 0 || blank < 0 || blank >= C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const int* il = static_cast<const int*>(ilen);
  const int* ll = static_cast<const int*>(llen);
  float* f[4] = {static_cast<float*>(lse), static_cast<float*>(lpl), static_cast<float*>(alpha),
                 static_cast<float*>(nll)};
  if (dtype == 0)
    return forward(static_cast<const float*>(x), lab, il, ll, T, B, C, L, blank, f[0], f[1], f[2],
                   f[3], s);
  if (dtype == 1)
    return forward(static_cast<const __nv_bfloat16*>(x), lab, il, ll, T, B, C, L, blank, f[0],
                   f[1], f[2], f[3], s);
  return (int)cudaErrorInvalidValue;
}

// As the forward's, with the forward's lse and alpha, the upstream
// gradient g [B] float32, scratch g_states [B, T, 2L + 1] float32 and
// order [B, max(L, 1)] int32, and dx [T, B, C] in x's dtype, written.
int ptt_ctc_backward(const void* x, int dtype, const void* labels, const void* ilen,
                     const void* llen, int T, int B, int C, int L, int blank, int norm_by_times,
                     const void* lse, const void* alpha, const void* g, void* g_states,
                     void* order, void* dx, void* stream) {
  if (T <= 0 || B <= 0 || C <= 0 || L < 0 || blank < 0 || blank >= C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const int* il = static_cast<const int*>(ilen);
  const int* ll = static_cast<const int*>(llen);
  const float* ls = static_cast<const float*>(lse);
  const float* al = static_cast<const float*>(alpha);
  const float* gg = static_cast<const float*>(g);
  float* gs = static_cast<float*>(g_states);
  int* ord = static_cast<int*>(order);
  if (dtype == 0)
    return backward(static_cast<const float*>(x), lab, il, ll, T, B, C, L, blank, norm_by_times,
                    ls, al, gg, gs, ord, static_cast<float*>(dx), s);
  if (dtype == 1)
    return backward(static_cast<const __nv_bfloat16*>(x), lab, il, ll, T, B, C, L, blank,
                    norm_by_times, ls, al, gg, gs, ord, static_cast<__nv_bfloat16*>(dx), s);
  return (int)cudaErrorInvalidValue;
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
