// BatchNorm's training backward, with the ReLU's mask and the residual's
// gradient of ResNet's blocks, in one pass over a channel group held in
// shared memory (Hopper, sm_90a).
//
// No TPU kernel: the JAX package's F.batch_norm (paddle_tpu/nn/functional/
// norm.py:95-155) is jnp, which XLA fuses with the add and the ReLU after
// it; kernels/batch_norm.py holds the port's forward and its two-pass
// Triton backward, and this kernel takes the backward's short runs.
//
// What it computes, per channel c of x [N, C, S] (channels first, S > 1):
// g = dy, 0 where the output y <= 0 (with the ReLU), the residual's
// gradient dres = g; g rounded to x's dtype where round_x (as the
// composition's casts round it); then dweight = sum g x-hat, dbias = sum
// g, and dx = w rstd (g - dbias / M - x-hat dweight / M), x-hat = (x -
// mean) rstd, M = N S, from the forward's (mean, rstd).
//
// Bound on the H100: bytes (about 20 flops an element against the ~20 a
// byte the card needs before compute is the limit). The Triton backward
// reads x, dy and y twice (partials, then dx); at 7 x 7 a channel's runs
// are 49 values, 98 bytes of bf16, padded to 64 lanes. Here a cluster of
// `cs` blocks (1 to 8, the portable limit) owns one channel and reads x,
// dy and y once:
//   1. each block takes N / cs of the n; at one n the channel's values are
//      one contiguous run of S values, read with coalesced loads (a thread
//      an element, four elements in flight a thread), and kept in shared
//      memory: x in its dtype and g in fp32 (6 bytes an element at bf16),
//      dres written as it goes; each thread sums g and g x-hat of its
//      elements in the order it reads them;
//   2. the block adds its threads' sums in a fixed order (the warp's xor
//      tree, the warps in order), then the cluster's blocks read each
//      other's sums through distributed shared memory and add them in rank
//      order, so every block holds the same totals; rank 0 writes dweight,
//      dbias;
//   3. dx from shared memory, written once in x's dtype.
// No atomics: the same inputs give the same bits, and a captured step its
// eager step's. kernels/batch_norm.py's batch_norm_backward_plan picks cs,
// the fewest blocks that keep a block within ~113 KB (two blocks an SM):
// one block a channel at 7 x 7, clusters of 2 at 14 x 14 and of 8 at 28 x
// 28 (batch 128); longer channels (56 x 56, 112 x 112) stay on the Triton
// kernels. (Several channels a block at 7 x 7 measured slower than one.)
//
// Plain C interface, loaded with ctypes; ptt_batch_norm_bwd launches on the
// caller's stream and returns a cudaError_t value.

#include "batch_norm_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace bn;
using namespace hopper;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;
constexpr int PAR = 8;   // floats of a channel's parameters in shared memory

// Grid: C clusters of cs blocks, a cluster a channel. Shared memory (the
// plan's bytes): this block's sums [4], the channel's parameters [PAR], the
// warps' sums [WARPS][2], g [E] fp32, x [E] 16-bit, E = ceil(N / cs) S.
__global__ void __launch_bounds__(THREADS, 2)
ptt_bn_bwd_cluster_kernel(const void* __restrict__ x, const void* __restrict__ dy,
                          const void* __restrict__ y, const float* __restrict__ stats,
                          const void* __restrict__ w, void* __restrict__ dx,
                          void* __restrict__ dres, float* __restrict__ sums, int N, int C, int S,
                          int cs, float m_count, int xdt, int dydt, int ydt, int wdt, int rdt,
                          int relu, int round_x) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = cs > 1 ? (int)cluster_rank() : 0;
  const int c = blockIdx.x / cs;
  const int nper = (N + cs - 1) / cs, n0 = rank * nper;
  const int nb = max(0, min(N, n0 + nper) - n0);
  const int E = nb * S;
  float* bsum = smem;                  // 16-byte aligned: read as float4
  float* par = bsum + 4;
  float* wsum = par + PAR;
  float* gs = wsum + WARPS * 2;
  uint16_t* xs = reinterpret_cast<uint16_t*>(gs + (size_t)nper * S);
  const uint16_t* xg = static_cast<const uint16_t*>(x);
  const Divider by_s(S);
  const int64_t cstride = (int64_t)C * S;
  const int64_t base = (int64_t)n0 * cstride + (int64_t)c * S;
  const float mean = stats[c], rstd = stats[C + c];
  const float wr = rstd * load(w, c, wdt);

  // 1. x, dy and y read once; g and x kept, dres written; this thread's
  // sum g x-hat and sum g taken as it reads
  float sa = 0.f, sb = 0.f;
  for (int e0 = tid; e0 < E; e0 += UNROLL * THREADS) {
    int64_t gi[UNROLL];
    float gv[UNROLL], yv[UNROLL];
    uint16_t xv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int e = e0 + u * THREADS;
      if (e < E) {
        const int n = by_s.div(e);
        gi[u] = base + n * cstride + (e - n * S);
        gv[u] = load(dy, gi[u], dydt);
        yv[u] = relu ? load(y, gi[u], ydt) : 1.f;
        xv[u] = xg[gi[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int e = e0 + u * THREADS;
      if (e < E) {
        float g = yv[u] <= 0.f ? 0.f : gv[u];
        if (dres) store(dres, gi[u], g, rdt);
        if (round_x) g = round_to(g, xdt);
        gs[e] = g;
        xs[e] = xv[u];
        sa += g * ((widen(xv[u], xdt) - mean) * rstd);
        sb += g;
      }
    }
  }

  // 2. the sums in a fixed order: the warp's xor tree, the warps in order,
  // then the cluster's blocks through distributed shared memory in rank
  // order, so that every block holds the same totals
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sa += __shfl_xor_sync(0xffffffffu, sa, off);
    sb += __shfl_xor_sync(0xffffffffu, sb, off);
  }
  if (lane == 0) {
    wsum[warp * 2] = sa;
    wsum[warp * 2 + 1] = sb;
  }
  __syncthreads();
  if (tid == 0) {
    sa = sb = 0.f;
    for (int k = 0; k < WARPS; ++k) {
      sa += wsum[k * 2];
      sb += wsum[k * 2 + 1];
    }
    bsum[0] = sa;
    bsum[1] = sb;
  }
  if (cs > 1)
    cluster_sync();
  else
    __syncthreads();
  if (tid == 0) {
    sa = sb = 0.f;
    if (cs > 1) {
      for (int r = 0; r < cs; ++r) {
        const float4 v = ld_cluster_f4(smem_u32(bsum), (uint32_t)r);
        sa += v.x;
        sb += v.y;
      }
    } else {
      sa = bsum[0];
      sb = bsum[1];
    }
    par[0] = sb / m_count;
    par[1] = sa / m_count;
    if (rank == 0) {
      sums[c] = sa;
      sums[C + c] = sb;
    }
  }
  __syncthreads();

  // 3. dx from shared memory, written once
  const float mg = par[0], mgx = par[1];
  for (int e0 = tid; e0 < E; e0 += UNROLL * THREADS) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int e = e0 + u * THREADS;
      if (e < E) {
        const int n = by_s.div(e);
        const float xh = (widen(xs[e], xdt) - mean) * rstd;
        store(dx, base + n * cstride + (e - n * S), wr * (gs[e] - mg - xh * mgx), xdt);
      }
    }
  }
  // no block leaves while another of its cluster may still read its sums
  if (cs > 1) cluster_sync();
}

}  // namespace

extern "C" {

// Shared memory bytes of a block (kernels/batch_norm.py's plan computes the
// same).
int ptt_batch_norm_bwd_smem(int N, int S, int cs) {
  const int64_t e = (int64_t)((N + cs - 1) / cs) * S;
  const int64_t bytes = 4 * e + 4 * (int64_t)(PAR + 2 * WARPS + 4) + 2 * e;
  return (int)((bytes + 15) / 16 * 16);
}

// x [N, C, S] (bf16 or f16), dy and y [N, C, S] (dtypes dydt, ydt; y read
// only with relu), stats [2, C] fp32 (mean, rstd), w [C] (wdt); written: dx
// (x's dtype), dres (rdt; may be null: no residual), sums [2, C] fp32
// (dweight, dbias). Dtypes: 0 float32, 1 bfloat16, 2 float16. All
// contiguous. A channel a cluster of cs blocks (1..8).
int ptt_batch_norm_bwd(const void* x, const void* dy, const void* y, const void* stats,
                       const void* w, void* dx, void* dres, void* sums, int N, int C, int S,
                       int cs, int xdt, int dydt, int ydt, int wdt, int rdt, int relu,
                       int round_x, void* stream) {
  if (N <= 0 || C <= 0 || S <= 1 || cs <= 0 || cs > 8 || (xdt != BF16 && xdt != F16))
    return (int)cudaErrorInvalidValue;
  const int smem = ptt_batch_norm_bwd_smem(N, S, cs);
  int err = (int)allow_block_smem(ptt_bn_bwd_cluster_kernel);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)C * cs);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, ptt_bn_bwd_cluster_kernel, x, dy, relu ? y : dy,
                                static_cast<const float*>(stats), w, dx, dres,
                                static_cast<float*>(sums), N, C, S, cs, (float)N * S, xdt, dydt,
                                ydt, wdt, rdt, relu, round_x);
  if (err) return err;
  return (int)cudaGetLastError();
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
