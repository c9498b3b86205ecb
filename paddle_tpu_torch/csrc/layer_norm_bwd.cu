// The backward of LayerNorm(residual + dropout(x + bias)) over the last
// axis, a warp a row (Hopper, sm_90a).
//
// No TPU kernel: the JAX package's fused_bias_dropout_residual_layer_norm
// (paddle_tpu/incubate/nn/functional/fused_ops.py:636) and F.layer_norm
// (paddle_tpu/nn/functional/norm.py:27) are jnp, whose vjp XLA fuses.
// kernels/fused.py holds the port's forward and its Triton backward
// (_dln_bwd_kernel); this kernel takes the backward wherever
// layer_norm_backward_plan sends it: rows of a multiple of 8 values up to
// 1280 (every LayerNorm of ERNIE, GPT, the UNet and Transformer-base).
//
// What it computes, per row of h [rows, n] (the norm's input, kept by the
// forward) and dy: mean and rstd of h in fp32 (one pass of the values less
// the row's first: no cancellation where the mean is large),
// x-hat = (h - mean) rstd, g = dy w, dh = rstd (g - mean(g) - x-hat
// mean(g x-hat)) rounded to h's dtype (the residual's gradient), dx = dh
// through the dropout's keep mask drawn again (kept: dh scale, rounded;
// without a dropout dx is dh), and fp32 sums over the rows of dy x-hat
// (dweight), dy (the norm's dbias) and dx (the input's dbias).
//
// Bound on the H100: bytes (h and dy read, dh and dx written; about 30
// flops an element, and 15 integer operations with the Philox mask, against
// the ~20 a byte the card can do before compute is the limit). The Triton
// kernel held a row over a program's four warps: four reductions a row
// crossed warps through shared memory, the next row's loads waited for this
// row's stores, and a width was padded to a power of two (768 took 1024
// lanes). Here:
//   * a warp holds a row: lane l takes the row's 8-value chunks l, l + 32,
//     ... (16 bytes each at 16 bits), so the reductions (mean and variance
//     together, then mean(g) and mean(g x-hat) together) are xor shuffles
//     only, and no lane idles but at the end of a row (320 = 40 chunks);
//   * rows in flight: each warp walks its rows (row = its global warp
//     index + k x all warps) through a ring of two row buffers in shared
//     memory, filled by cp.async, so that the next row is on its way while
//     one is reduced (a lane reads back only the chunks it copied itself,
//     and takes the row's first value from lane 0 by a shuffle: no
//     barrier; deeper rings measured slower at every shape);
//   * a persistent grid of one or two blocks of 8 warps an SM; each lane
//     keeps its columns' three sums in registers across its rows, the
//     block adds its warps' in warp order into one partial row ([blocks,
//     3 n] fp32), and ordered_col_sum_kernel (a programmatic dependent
//     launch) adds the blocks' rows in order: 2 launches a call, no
//     atomics, the same bits every run and under graph replay.
// The keep mask is kernels/dropout.py's (csrc/philox_common.cuh): element
// e = row n + col of a mask drawn under (key, site) is word e % 4 of
// Philox4x32-10 at counter (e / 4, site, 0); dropped where its top 24 bits
// are below the threshold.
//
// Plain C interface, loaded with ctypes; the entry points launch on the
// caller's stream and return a cudaError_t value.

#include "batch_norm_common.cuh"
#include "philox_common.cuh"

namespace {

using namespace bn;
using philox::Mask;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int VEC = 8;          // values a chunk
constexpr int MAX_CHUNKS = 5;   // chunks a lane: n up to 32 x 8 x 5 = 1280
constexpr int STAGES = 2;       // rows a warp's ring holds

// -- cp.async -----------------------------------------------------------------------

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A chunk of 8 values from shared memory, piece-major: its 16-byte piece
// b (of CB / 16) at (b nq + q) 16, so that a warp's lanes read consecutive
// 16 bytes (no bank conflicts at fp32 either).
template <int DT>
__device__ __forceinline__ void lds_chunk(const unsigned char* s, int q, int nq, float (&v)[8]) {
  if constexpr (DT == F32) {
    const float4 a = *reinterpret_cast<const float4*>(s + q * 16);
    const float4 b = *reinterpret_cast<const float4*>(s + (nq + q) * 16);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    unpack8(*reinterpret_cast<const uint4*>(s + q * 16), DT, v);
  }
}

// v rounded to DT in place, and written at p (global, 16-byte aligned):
// two values a conversion at 16 bits
template <int DT>
__device__ __forceinline__ void round_store8(float (&v)[8], void* p) {
  if constexpr (DT == F32) {
    static_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    static_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (DT == BF16) {
        const __nv_bfloat162 t = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        w[i] = *reinterpret_cast<const uint32_t*>(&t);
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      } else {
        const __half2 t = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
        w[i] = *reinterpret_cast<const uint32_t*>(&t);
        const float2 f = __half22float2(t);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    }
    *static_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Shared memory (the plan's bytes, kernels/fused.py _ln_smem): the weight
// [n] fp32, then each warp's ring of STAGES buffers of a row of h and a row
// of dy (n values each, h's dtype), chunks piece-major; after the rows, the
// same bytes hold the warps' column sums [WARPS][3][n] fp32.
template <int DT, int NCH>
__global__ void __launch_bounds__(THREADS, NCH <= 3 ? 2 : 1)
ptt_ln_bwd_warp_kernel(const void* __restrict__ h, const void* __restrict__ w,
                       const void* __restrict__ dy, void* __restrict__ dh, void* __restrict__ dx,
                       float* __restrict__ part, const long long* __restrict__ key, int rows,
                       int n, int wdt, float eps, uint32_t site, int thresh,
                       float scale, int drop) {
  constexpr int ES = DT == F32 ? 4 : 2;   // bytes a value
  constexpr int CB = VEC * ES;            // bytes a chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nq = n / VEC;
  const int wbytes = (n * 4 + 15) / 16 * 16;
  const int rb = n * ES;                  // bytes of a row: a multiple of 16
  const unsigned char* ws = smem;
  unsigned char* ring = smem + wbytes + (size_t)warp * STAGES * 2 * rb;
  const int64_t all = (int64_t)gridDim.x * WARPS;
  const int64_t gw = (int64_t)blockIdx.x * WARPS + warp;
  const int cnt = gw < rows ? (int)((rows - 1 - gw) / all + 1) : 0;
  const unsigned char* hb = static_cast<const unsigned char*>(h);
  const unsigned char* db = static_cast<const unsigned char*>(dy);

  // row i of this warp's rows into ring buffer i % STAGES
  auto issue = [&](int i) {
    const int64_t off = (gw + (int64_t)i * all) * rb;
    unsigned char* st = ring + (size_t)(i % STAGES) * 2 * rb;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int q = lane + 32 * k;
      if (q < nq) {
#pragma unroll
        for (int b = 0; b < CB / 16; ++b) {
          cp16(st + (b * nq + q) * 16, hb + off + q * CB + b * 16);
          cp16(st + rb + (b * nq + q) * 16, db + off + q * CB + b * 16);
        }
      }
    }
  };
  // the first row on its way before the weight is read
  if (cnt > 0) issue(0);
  cp_commit();
  float* wsf = reinterpret_cast<float*>(smem);
  for (int i = threadIdx.x; i < n; i += THREADS)
    wsf[(((i & 7) >> 2) * nq + (i >> 3)) * 4 + (i & 3)] = load(w, i, wdt);
  __syncthreads();

  const float nf = (float)n;
  Mask mask{0u, 0u, site, thresh};
  if (drop) {
    mask.k0 = (uint32_t)key[0];
    mask.k1 = (uint32_t)key[1];
  }
  float aw[NCH][VEC], ab[NCH][VEC], ax[NCH][VEC];
#pragma unroll
  for (int k = 0; k < NCH; ++k)
#pragma unroll
    for (int j = 0; j < VEC; ++j) aw[k][j] = ab[k][j] = ax[k][j] = 0.f;

  for (int i = 0; i < cnt; ++i) {
    if (i + 1 < cnt) issue(i + 1);
    cp_commit();
    cp_wait<1>();
    const unsigned char* sh = ring + (size_t)(i % STAGES) * 2 * rb;
    const unsigned char* sd = sh + rb;
    const int64_t row = gw + (int64_t)i * all;

    // mean and variance of h in one pass, shifted by the row's first value
    // (no cancellation where the mean is large against the spread): lane 0
    // copied it (chunk 0's first piece), so lane 0 reads it and sends it on
    float k0 = 0.f;
    if (lane == 0)
      k0 = DT == F32 ? *reinterpret_cast<const float*>(sh)
                     : widen(*reinterpret_cast<const uint16_t*>(sh), DT);
    k0 = __shfl_sync(0xffffffffu, k0, 0);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int q = lane + 32 * k;
      if (q < nq) {
        float v[VEC];
        lds_chunk<DT>(sh, q, nq, v);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float c = v[j] - k0;
          s1 += c;
          s2 += c * c;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float m1 = s1 / nf;
    const float mean = k0 + m1;
    const float rstd = rsqrtf(fmaxf(s2 / nf - m1 * m1, 0.f) + eps);

    // mean(g), mean(g x-hat); the column sums of dy x-hat and dy
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int q = lane + 32 * k;
      if (q < nq) {
        float v[VEC], g[VEC], wv[VEC];
        lds_chunk<DT>(sh, q, nq, v);
        lds_chunk<DT>(sd, q, nq, g);
        lds_chunk<F32>(ws, q, nq, wv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh = (v[j] - mean) * rstd;
          const float gj = g[j] * wv[j];
          sg += gj;
          sgx += gj * xh;
          aw[k][j] += g[j] * xh;
          ab[k][j] += g[j];
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sg += __shfl_xor_sync(0xffffffffu, sg, off);
      sgx += __shfl_xor_sync(0xffffffffu, sgx, off);
    }
    const float mg = sg / nf, mgx = sgx / nf;

    // dh, dx written once; the column sums of dx
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int q = lane + 32 * k;
      if (q < nq) {
        float v[VEC], g[VEC], wv[VEC], d[VEC];
        lds_chunk<DT>(sh, q, nq, v);
        lds_chunk<DT>(sd, q, nq, g);
        lds_chunk<F32>(ws, q, nq, wv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh = (v[j] - mean) * rstd;
          d[j] = rstd * (g[j] * wv[j] - mg - xh * mgx);
        }
        const int64_t e = row * n + (int64_t)q * VEC;   // a multiple of 8
        round_store8<DT>(d, static_cast<unsigned char*>(dh) + e * ES);
        if (drop) {
          const uint4 b0 = mask.block((uint64_t)e >> 2), b1 = mask.block(((uint64_t)e >> 2) + 1);
          const uint32_t wd[VEC] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int j = 0; j < VEC; ++j) d[j] = mask.keeps(wd[j]) ? d[j] * scale : 0.f;
          round_store8<DT>(d, static_cast<unsigned char*>(dx) + e * ES);
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) ax[k][j] += d[j];
      }
    }
  }
  cp_wait<0>();
  // the column sum may start its launch (it waits for this grid to end)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __syncthreads();   // every warp is done with its ring

  // the block's partial row: each warp's sums into its own slice, then
  // every column's eight added in warp order
  float* red = reinterpret_cast<float*>(smem + wbytes);
  float* mine = red + (size_t)warp * 3 * n;
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const int q = lane + 32 * k;
    if (q < nq) {
      float4* pw = reinterpret_cast<float4*>(mine + q * VEC);
      float4* pb = reinterpret_cast<float4*>(mine + n + q * VEC);
      float4* px = reinterpret_cast<float4*>(mine + 2 * n + q * VEC);
      pw[0] = make_float4(aw[k][0], aw[k][1], aw[k][2], aw[k][3]);
      pw[1] = make_float4(aw[k][4], aw[k][5], aw[k][6], aw[k][7]);
      pb[0] = make_float4(ab[k][0], ab[k][1], ab[k][2], ab[k][3]);
      pb[1] = make_float4(ab[k][4], ab[k][5], ab[k][6], ab[k][7]);
      px[0] = make_float4(ax[k][0], ax[k][1], ax[k][2], ax[k][3]);
      px[1] = make_float4(ax[k][4], ax[k][5], ax[k][6], ax[k][7]);
    }
  }
  __syncthreads();
  float* out = part + (int64_t)blockIdx.x * 3 * n;
  for (int i = threadIdx.x; i < 3 * n; i += THREADS) {
    float t = red[i];
#pragma unroll
    for (int wi = 1; wi < WARPS; ++wi) t += red[(size_t)wi * 3 * n + i];
    out[i] = t;
  }
}

// The keep mask of elements e0 .. e0 + count - 1 (1 kept, 0 dropped; e0 %
// 4 == 0) as the LayerNorm kernel draws it: a Philox block a thread, four
// elements. Its own entry point reaches counters past 2^32 Philox blocks
// (2^34 elements), which no LayerNorm call in a test can.
__global__ void ptt_keep_mask_kernel(const long long* __restrict__ key, uint32_t site, int thresh,
                                     long long e0, int count, unsigned char* __restrict__ out) {
  const Mask mask{(uint32_t)key[0], (uint32_t)key[1], site, thresh};
  const int i0 = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (i0 >= count) return;
  const uint4 b = mask.block((uint64_t)(e0 + i0) >> 2);
  const uint32_t wd[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (i0 + j < count) out[i0 + j] = mask.keeps(wd[j]);
}

template <int DT, int NCH>
int launch(const void* h, const void* w, const void* dy, void* dh, void* dx, float* part,
           const long long* key, int rows, int n, int blocks, int wdt, float eps, uint32_t site,
           int thresh, float scale, int drop, int smem, cudaStream_t stream) {
  auto kernel = ptt_ln_bwd_warp_kernel<DT, NCH>;
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  kernel<<<blocks, THREADS, smem, stream>>>(h, w, dy, dh, dx, part, key, rows, n, wdt, eps,
                                            site, thresh, scale, drop);
  return (int)cudaGetLastError();
}

template <int DT>
int launch_dt(int nch, const void* h, const void* w, const void* dy, void* dh, void* dx,
              float* part, const long long* key, int rows, int n, int blocks, int wdt,
              float eps, uint32_t site, int thresh, float scale, int drop, int smem,
              cudaStream_t stream) {
#define PTT_LN_CASE(C)                                                                       \
  case C:                                                                                    \
    return launch<DT, C>(h, w, dy, dh, dx, part, key, rows, n, blocks, wdt, eps, site,       \
                         thresh, scale, drop, smem, stream);
  switch (nch) {
    PTT_LN_CASE(1)
    PTT_LN_CASE(2)
    PTT_LN_CASE(3)
    PTT_LN_CASE(4)
    PTT_LN_CASE(5)
  }
#undef PTT_LN_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// h, dy [rows, n] (dtype dt: 0 float32, 1 bfloat16, 2 float16), w [n]
// (wdt); written: dh, dx [rows, n] (dt; dx only with drop), part [blocks,
// 3 n] fp32 scratch, sums [3 n] fp32 (dweight, the norm's dbias, the input's
// dbias). key: int64 [2] on the card (read only with drop). n % 8 == 0, 8 <=
// n <= 1280, pointers 16-byte aligned, all contiguous. smem: a block's
// shared memory bytes as layer_norm_backward_plan gives them (kernels/
// fused.py _ln_smem, the one place that sizes the layout above).
int ptt_layer_norm_bwd(const void* h, const void* w, const void* dy, void* dh, void* dx,
                       void* part, void* sums, const void* key, int rows, int n, int blocks,
                       int smem, int dt, int wdt, float eps, unsigned site, int thresh,
                       float scale, int drop, void* stream) {
  const int nch = (n / VEC + 31) / 32;
  if (rows <= 0 || n <= 0 || n % VEC || nch > MAX_CHUNKS || blocks <= 0 || smem <= 0 ||
      (dt != F32 && dt != BF16 && dt != F16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  const long long* k = static_cast<const long long*>(key);
  int err;
  if (dt == F32)
    err = launch_dt<F32>(nch, h, w, dy, dh, dx, p, k, rows, n, blocks, wdt, eps, site,
                         thresh, scale, drop, smem, s);
  else if (dt == BF16)
    err = launch_dt<BF16>(nch, h, w, dy, dh, dx, p, k, rows, n, blocks, wdt, eps, site,
                          thresh, scale, drop, smem, s);
  else
    err = launch_dt<F16>(nch, h, w, dy, dh, dx, p, k, rows, n, blocks, wdt, eps, site,
                         thresh, scale, drop, smem, s);
  if (err) return err;
  err = (int)launch_col_sum<32>(p, static_cast<float*>(sums), blocks, 3 * n, s);
  if (err) return err;
  return (int)cudaGetLastError();
}

// The keep mask of elements e0 .. e0 + count - 1 (e0 % 4 == 0) under (key,
// site) at the threshold into out (uint8, 1 kept).
int ptt_dropout_keep_mask(const void* key, unsigned site, int thresh, long long e0, int count,
                          void* out, void* stream) {
  if (count <= 0 || e0 < 0 || e0 % 4) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int blocks = (count + threads * 4 - 1) / (threads * 4);
  ptt_keep_mask_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(key), site, thresh, e0, count,
      static_cast<unsigned char*>(out));
  return (int)cudaGetLastError();
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
