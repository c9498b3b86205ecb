// GroupNorm's forward, with the SiLU after it where the model applies one,
// in one read of x held in shared memory across a thread-block cluster
// (Hopper, sm_90a).
//
// No TPU kernel: the JAX package's F.group_norm (paddle_tpu/nn/functional/
// norm.py:186-223) and the SiLU after it (activation.py:34) are jnp, which
// XLA fuses. kernels/group_norm.py holds the port's Triton forward (two
// kernels: the chunks' statistics, then the normalisation, x read twice);
// this kernel takes the forward wherever group_norm_forward_plan sends it:
// channels first, x in bf16 or fp16, a spatial size a multiple of 8 and a
// group that fits on chip over at most 8 blocks (every GroupNorm of the
// Stable Diffusion UNet, and instance norm's one channel a group).
//
// What it computes, per group (n, g) of x [N, C, S] with Cg = C / G
// channels: the mean and the biased variance of its M = Cg S values in
// fp32, saved as (mean, rstd = 1 / sqrt(var + eps)) into stats [N G, 2] (the
// backward, group_norm_bwd.cu or Triton, reads them); z = (x - mean) rstd
// w_c + b_c in fp32 (the product and the sum one fused multiply-add, as
// the backward recomputes z), rounded to the output's dtype; with the
// SiLU, z / (1 + exp(-z)) in fp32 (the accurate expf and IEEE division:
// NVCC_FLAGS carry no fast-math, which gives PyTorch's own SiLU bits)
// rounded again.
//
// Bound on the H100: bytes (x read, y written: 4 bytes an element at 16
// bits; about 10 operations an element, 30 more with the SiLU's exp and
// division). A group of an NCHW tensor is one contiguous run of Cg S values
// (the UNet's largest, [4, 960, 64, 64] at G 32: 122,880, 240 KB of bf16).
// A cluster of cs blocks (1 to 8) owns a group:
//   1. block rank r takes the group's 16-byte vectors [r vpb, (r + 1) vpb),
//      vpb = ceil(Cg S / 8 / cs), copied once into shared memory by TMA bulk
//      copies of 16 KB, all in flight at once, each completing on its own
//      barrier (one thread issues them: the copies cost the threads no
//      instructions; cp.async, a thread a vector, measured 3-14% slower at
//      the UNet's groups of 40 KB and more, 7% faster at 8 x 8);
//   2. the sum of the block's values (thread t its vectors t, t + 512, ...,
//      each vector's 8 values in order, a chunk as it lands; the warp's xor
//      tree, the warps in order), the block's mean, then the same for the
//      squares about it, (x - mean)^2 each rounded before it is added, from
//      shared memory: no E[x^2] - E[x]^2 cancellation;
//   3. the blocks' (count, mean, M2) read through distributed shared memory
//      and merged by Chan's formula in rank order (one exchange a call):
//      every block holds the same totals; every step rounded apart (no
//      fused multiply-add), so group_stats_cluster_plain repeats them bit
//      for bit;
//   4. rank 0 saves (mean, rstd); y from shared memory, written once with
//      16-byte stores (32 at fp32).
// No atomics: the same inputs give the same bits, and a captured step its
// eager step's. One launch a call, against the Triton route's two.
//
// Plain C interface, loaded with ctypes; ptt_group_norm_fwd launches on the
// caller's stream and returns a cudaError_t value.

#include "batch_norm_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace bn;
using namespace hopper;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 8;     // values a vector: 16 bytes of x
constexpr int HEAD = 12 + WARPS;  // floats before x: the sums and statistics, the warps'

constexpr int CHV = 2 * THREADS;  // vectors a bulk copy: two a thread

// The block's threads' v summed in a fixed order (the warp's xor tree, the
// warps in order by thread 0, into *out); every thread gets the total. wsum
// [WARPS] is scratch.
__device__ __forceinline__ float block_total(float v, float* wsum, float* out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) wsum[warp] = v;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int k = 0; k < WARPS; ++k) s += wsum[k];
    *out = s;
  }
  __syncthreads();
  return *out;
}
constexpr int MAX_CHUNKS = 16;    // bulk copies a block: up to 256 KB

// bytes of global memory at src to shared memory at dst (both 16-byte
// aligned, a multiple of 16 bytes) by the TMA, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Grid: N G clusters of cs blocks, a cluster a group. Shared memory (the
// plan's bytes): the sums and statistics [12], the warps' sums [WARPS],
// the block's vpb vectors of x. ODT: y's dtype; SILU: the SiLU after it.
template <int ODT, bool SILU>
__global__ void __launch_bounds__(THREADS, 2)
ptt_gn_fwd_cluster_kernel(const void* __restrict__ x, const void* __restrict__ w,
                          const void* __restrict__ b, void* __restrict__ y,
                          float* __restrict__ stats, int C, int G, int Cg, int S, int cs,
                          int vpb, float m_count, float eps, int xdt, int wdt, int bdt) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int rank = cs > 1 ? (int)cluster_rank() : 0;
  const int ng = blockIdx.x / cs, nn = ng / G, g = ng - nn * G;
  const int nvec = Cg * (S / VEC);
  const int v0 = min(rank * vpb, nvec), nv = min(v0 + vpb, nvec) - v0;
  float* sums = smem;        // [0..3] this block's (count, mean, M2); [8], [9] its
                             // sums; [10], [11] the group's (mean, rstd)
  float* wsum = smem + 12;
  uint4* xs = reinterpret_cast<uint4*>(smem + HEAD);
  const int64_t base = ((int64_t)nn * C + (int64_t)g * Cg) * S + (int64_t)v0 * VEC;
  const uint4* xg = reinterpret_cast<const uint4*>(static_cast<const uint16_t*>(x) + base);

  // 1. x read once: the block's run in chunks of CHV vectors, each a TMA
  // bulk copy on its own barrier, all in flight; 2. each chunk summed as it
  // lands (a thread its vectors t, t + THREADS, ... in order)
  __shared__ __align__(8) uint64_t bars[MAX_CHUNKS];
  const int nch = (nv + CHV - 1) / CHV;
  if (tid == 0) {
    for (int i = 0; i < nch; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < nch; ++i) {
      const uint32_t bytes = 16u * (uint32_t)min(CHV, nv - i * CHV);
      mbar_expect_tx(&bars[i], bytes);
      bulk_load(xs + i * CHV, xg + i * CHV, bytes, &bars[i]);
    }
  float s1 = 0.f;
  for (int i = 0; i < nch; ++i) {
    mbar_wait(&bars[i], 0);
    for (int v = i * CHV + tid; v < min(nv, (i + 1) * CHV); v += THREADS) {
      float f[VEC];
      unpack8(xs[v], xdt, f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) s1 += f[e];
    }
  }
  // the block's mean, then its values' squares about it, each sum in a
  // fixed order (the warp's xor tree, the warps in order)
  const float nb = (float)(nv * VEC);
  const float bsum = block_total(s1, wsum, sums + 8);
  const float bmean = nv > 0 ? __fdiv_rn(bsum, nb) : 0.f;
  float s2 = 0.f;
  for (int v = tid; v < nv; v += THREADS) {
    float f[VEC];
    unpack8(xs[v], xdt, f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float d = f[e] - bmean;
      s2 = __fadd_rn(s2, __fmul_rn(d, d));
    }
  }
  const float bm2 = block_total(s2, wsum, sums + 9);
  // 3. the blocks' (count, mean, M2) merged in rank order by Chan's
  // formula, each one read from its block's shared memory (distributed
  // shared memory): every block the same totals
  if (tid == 0) *reinterpret_cast<float4*>(sums) = make_float4(nb, bmean, bm2, 0.f);
  if (cs > 1)
    cluster_sync();
  else
    __syncthreads();
  if (tid == 0) {
    float cnt = 0.f, mean = 0.f, m2 = 0.f;
    for (int r = 0; r < cs; ++r) {
      const float4 t = cs > 1 ? ld_cluster_f4(smem_u32(sums), (uint32_t)r)
                              : *reinterpret_cast<const float4*>(sums);
      if (t.x == 0.f) continue;   // a rank past the group's end
      const float tot = __fadd_rn(cnt, t.x);
      const float d = __fsub_rn(t.y, mean);
      const float wt = __fdiv_rn(t.x, tot);
      mean = __fadd_rn(mean, __fmul_rn(d, wt));
      m2 = __fadd_rn(__fadd_rn(m2, t.z), __fmul_rn(__fmul_rn(__fmul_rn(d, d), cnt), wt));
      cnt = tot;
    }
    sums[10] = mean;
    // each step rounded to nearest, as the plain version's fp32 ops
    sums[11] = __frcp_rn(__fsqrt_rn(__fadd_rn(__fdiv_rn(m2, m_count), eps)));
  }
  __syncthreads();
  const float mean = sums[10], rstd = sums[11];
  if (rank == 0 && tid == 0) {
    stats[2 * ng] = mean;
    stats[2 * ng + 1] = rstd;
  }

  // 3. y from shared memory, written once
  const Divider by_vs(S / VEC);
  const int c0 = g * Cg;
  constexpr int OB = ODT == F32 ? 4 : 2;
  unsigned char* yg = static_cast<unsigned char*>(y) + base * OB;
  for (int v = tid; v < nv; v += THREADS) {
    const int c = c0 + by_vs.div(v0 + v);
    const float wc = load(w, c, wdt), bc = load(b, c, bdt);
    float f[VEC];
    unpack8(xs[v], xdt, f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      // x-hat w + b as the backward recomputes it (group_norm_bwd.cu), so
      // that the SiLU's derivative there sees this z
      float z = fmaf((f[e] - mean) * rstd, wc, bc);
      if (SILU) {
        z = round_to(z, ODT);
        z = z / (1.f + expf(-z));
      }
      f[e] = z;
    }
    store8(yg + (int64_t)v * VEC * OB, f, ODT);
  }
  // no block leaves while another of its cluster may still read its sums
  if (cs > 1) cluster_sync();
}

template <int ODT, bool SILU>
int launch(const void* x, const void* w, const void* b, void* y, float* stats, int N, int C,
           int G, int S, int cs, int smem, float eps, int xdt, int wdt, int bdt,
           cudaStream_t stream) {
  auto kernel = ptt_gn_fwd_cluster_kernel<ODT, SILU>;
  int err = (int)allow_block_smem(kernel);
  if (err) return err;
  const int Cg = C / G;
  const int vpb = (Cg * (S / VEC) + cs - 1) / cs;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(N * G * cs));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, x, w, b, y, stats, C, G, Cg, S, cs, vpb,
                                (float)Cg * S, eps, xdt, wdt, bdt);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [N, C, S] (bf16 or f16, xdt), w, b [C] (wdt, bdt); written: y [N, C, S]
// (ydt), stats [N G, 2] fp32 (mean, rstd). Dtypes: 0 float32, 1 bfloat16,
// 2 float16. All contiguous, x and y 16-byte aligned; S % 8 == 0; a group a
// cluster of cs blocks (1..8) of vpb = ceil(C / G S / 8 / cs) vectors each.
// smem: a block's shared memory bytes as group_norm_forward_plan gives them
// (kernels/group_norm.py _fwd_smem, the one place that sizes the layout
// above the kernel: 4 (12 + 16) bytes of sums, then 16 vpb of x).
int ptt_group_norm_fwd(const void* x, const void* w, const void* b, void* y, void* stats, int N,
                       int C, int G, int S, int cs, int smem, float eps, int xdt, int wdt,
                       int bdt, int ydt, int silu, void* stream) {
  if (N <= 0 || C <= 0 || G <= 0 || C % G || S <= 0 || S % VEC || cs <= 0 || cs > 8 ||
      smem <= 0 || (xdt != BF16 && xdt != F16))
    return (int)cudaErrorInvalidValue;
  const int vpb = (C / G * (S / VEC) + cs - 1) / cs;
  if (smem < 4 * HEAD + 16 * vpb || vpb > MAX_CHUNKS * CHV) return (int)cudaErrorInvalidValue;
  float* st = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_GN_FWD(O, SI) \
  launch<O, SI>(x, w, b, y, st, N, C, G, S, cs, smem, eps, xdt, wdt, bdt, s)
  if (ydt == F32) return silu ? PTT_GN_FWD(F32, true) : PTT_GN_FWD(F32, false);
  if (ydt == BF16) return silu ? PTT_GN_FWD(BF16, true) : PTT_GN_FWD(BF16, false);
  if (ydt == F16) return silu ? PTT_GN_FWD(F16, true) : PTT_GN_FWD(F16, false);
#undef PTT_GN_FWD
  return (int)cudaErrorInvalidValue;
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
