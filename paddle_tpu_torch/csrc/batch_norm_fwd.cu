// BatchNorm's training forward, with the residual add and the ReLU of
// ResNet's blocks, in one pass over a channel held in shared memory
// (Hopper, sm_90a).
//
// No TPU kernel: the JAX package's F.batch_norm (paddle_tpu/nn/functional/
// norm.py:95-155) is jnp, which XLA fuses with the add and the ReLU after
// it; kernels/batch_norm.py holds the port's forward (two Triton kernels,
// which take the rest) and this kernel takes the training forward's short
// runs.
//
// What it computes, per channel c of x [N, C, S] (channels first, S > 1,
// bf16 or fp16): the mean and the biased variance of the channel's M = N S
// values in fp32, saved as (mean, rstd = 1 / sqrt(var + eps)); the running
// statistics updated in place, momentum * running + (1 - momentum) *
// batch (the JAX convention); then y = (x - mean) rstd w + b in fp32,
// rounded where the separate ops round (the Triton kernel's rules): to x's
// dtype where round_x, then with a residual the sum of the two each
// rounded to y's dtype, then the ReLU on the sum rounded to y's dtype,
// written in y's dtype.
//
// Bound on the H100: bytes (about 10 flops an element against the ~20 a
// byte the card needs before compute is the limit). The two Triton kernels
// read x twice (the statistics, then the normalisation) and pass each
// chunk's (count, mean, M2) through device memory; at 7 x 7 a channel's
// runs are 49 values, padded to 64 lanes. Here a cluster of `cs` blocks
// (1 to 8, the portable limit) owns one channel and reads x once:
//   1. each block takes N / cs of the n; at one n the channel's values are
//      one contiguous run of S values, read with coalesced loads into
//      shared memory in x's dtype (2 bytes an element): a thread moves 8,
//      4 or 2 values an access where S and the pointers allow (16 bytes at
//      28 x 28 and 56 x 56, 8 at 14 x 14), else one (7 x 7: 16 in flight a
//      thread); each thread sums its values in the order it reads them;
//   2. the block adds its threads' sums in a fixed order (the warp's xor
//      tree, the warps in order), then the cluster's blocks read each
//      other's sums through distributed shared memory and add them in rank
//      order: every block holds the same total, so the same mean;
//   3. the same again for M2 = sum (x - mean)^2, from shared memory: exact
//      about the mean, no E[x^2] - E[x]^2 cancellation;
//   4. rank 0 saves (mean, rstd) and updates the running statistics;
//   5. y from shared memory, the residual read once, y written once.
// No atomics: the same inputs give the same bits, and a captured step its
// eager step's. kernels/batch_norm.py's batch_norm_forward_plan picks cs,
// the fewest blocks that keep a block within ~113 KB (two blocks an SM):
// one block a channel at 7 x 7 and 14 x 14, clusters of 2 at 28 x 28 and
// of 8 at 56 x 56 (batch 128); the stem's 112 x 112 stays on the Triton
// kernels.
//
// Plain C interface, loaded with ctypes; ptt_batch_norm_fwd launches on the
// caller's stream and returns a cudaError_t value.

#include "batch_norm_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace bn;
using namespace hopper;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int SUMS = 12;      // floats: two 16-byte slots of the block's sums, mean and M2

// VEC consecutive 16-bit values, or floats, moved as one access (the
// element index a multiple of VEC, the base aligned)
template <int VEC>
struct alignas(2 * VEC) Half16 {
  uint16_t v[VEC];
};
template <int VEC>
struct alignas(4 * VEC > 16 ? 16 : 4 * VEC) Float32 {
  float v[VEC];
};

// The block's threads' sums of v in a fixed order (the warp's xor tree,
// the warps in order) into slot[0], then the cluster's blocks' slots added
// in rank order; every thread of every block gets the same total. wsum
// [WARPS] is scratch; slot is 16-byte aligned.
__device__ __forceinline__ float cluster_total(float v, float* wsum, float* slot, float* out,
                                               int cs) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) wsum[warp] = v;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int k = 0; k < WARPS; ++k) s += wsum[k];
    slot[0] = s;
  }
  if (cs > 1)
    cluster_sync();
  else
    __syncthreads();
  if (tid == 0) {
    float s = slot[0];
    if (cs > 1) {
      s = 0.f;
      for (int r = 0; r < cs; ++r) s += ld_cluster_f4(smem_u32(slot), (uint32_t)r).x;
    }
    *out = s;
  }
  __syncthreads();
  return *out;
}

// Grid: C clusters of cs blocks, a cluster a channel. Shared memory (the
// plan's bytes): the sums [SUMS], the warps' sums [WARPS], x [E] 16-bit, E
// = ceil(N / cs) S. A thread moves VEC elements an access (S % VEC == 0, so
// a vector never crosses a run; x, r and y 16-byte aligned): UX vectors of
// x and UY of r in flight.
template <int VEC>
__global__ void __launch_bounds__(THREADS, 2)
ptt_bn_fwd_cluster_kernel(const void* __restrict__ x, const void* __restrict__ w,
                          const void* __restrict__ b, void* rm, void* rv,
                          const void* __restrict__ r, void* __restrict__ y,
                          float* __restrict__ stats, int N, int C, int S, int cs, float m_count,
                          float eps, float momentum, float keep_new, int xdt, int wdt, int bdt,
                          int rmdt, int rvdt, int rdt, int ydt, int has_res, int relu,
                          int round_x) {
  constexpr int UX = VEC == 1 ? 16 : 4, UY = VEC == 1 ? 8 : 2;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int rank = cs > 1 ? (int)cluster_rank() : 0;
  const int c = blockIdx.x / cs;
  const int nper = (N + cs - 1) / cs, n0 = rank * nper;
  const int nb = max(0, min(N, n0 + nper) - n0);
  const int NV = nb * S / VEC;     // the block's vectors
  float* sums = smem;              // [0]: the sum's slot, [4]: M2's, [8], [9]: totals
  float* wsum = smem + SUMS;
  Half16<VEC>* xs = reinterpret_cast<Half16<VEC>*>(wsum + WARPS);
  const uint16_t* xg = static_cast<const uint16_t*>(x);
  const Divider by_s(S);
  const int64_t cstride = (int64_t)C * S;
  const int64_t base = (int64_t)n0 * cstride + (int64_t)c * S;
  // the global index of the block's vector v's first element
  auto at = [&](int v) -> int64_t {
    const int e = v * VEC, n = by_s.div(e);
    return base + n * cstride + (e - n * S);
  };

  // 1. x read once into shared memory; this thread's sum
  float s1 = 0.f;
  for (int v0 = tid; v0 < NV; v0 += UX * THREADS) {
    Half16<VEC> xv[UX];
#pragma unroll
    for (int u = 0; u < UX; ++u) {
      const int v = v0 + u * THREADS;
      if (v < NV) xv[u] = *reinterpret_cast<const Half16<VEC>*>(xg + at(v));
    }
#pragma unroll
    for (int u = 0; u < UX; ++u) {
      const int v = v0 + u * THREADS;
      if (v < NV) {
        xs[v] = xv[u];
#pragma unroll
        for (int k = 0; k < VEC; ++k) s1 += widen(xv[u].v[k], xdt);
      }
    }
  }
  // 2. the channel's mean
  const float mean = cluster_total(s1, wsum, sums, sums + 8, cs) / m_count;
  // 3. M2 about it, from shared memory
  float s2 = 0.f;
  for (int v = tid; v < NV; v += THREADS) {
    const Half16<VEC> xv = xs[v];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float d = widen(xv.v[k], xdt) - mean;
      s2 += d * d;
    }
  }
  const float var = cluster_total(s2, wsum, sums + 4, sums + 9, cs) / m_count;
  const float rstd = 1.f / sqrtf(var + eps);
  // 4. the statistics
  if (rank == 0 && tid == 0) {
    stats[c] = mean;
    stats[C + c] = rstd;
    store(rm, c, momentum * load(rm, c, rmdt) + keep_new * mean, rmdt);
    store(rv, c, momentum * load(rv, c, rvdt) + keep_new * var, rvdt);
  }
  // 5. y from shared memory, the residual read once, y written once
  const float scale = rstd * load(w, c, wdt), shift = load(b, c, bdt);
  for (int v0 = tid; v0 < NV; v0 += UY * THREADS) {
    float res[UY][VEC];
#pragma unroll
    for (int u = 0; u < UY; ++u) {
      const int v = v0 + u * THREADS;
      if (v < NV && has_res) {
        const int64_t g = at(v);
        if (rdt == F32) {
          const Float32<VEC> f = *reinterpret_cast<const Float32<VEC>*>(
              static_cast<const float*>(r) + g);
#pragma unroll
          for (int k = 0; k < VEC; ++k) res[u][k] = f.v[k];
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) res[u][k] = load(r, g + k, rdt);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UY; ++u) {
      const int v = v0 + u * THREADS;
      if (v >= NV) continue;
      const Half16<VEC> xv = xs[v];
      float z[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float t = (widen(xv.v[k], xdt) - mean) * scale + shift;
        if (round_x) t = round_to(t, xdt);
        if (has_res) t = round_to(t, ydt) + round_to(res[u][k], ydt);
        if (relu) {
          t = round_to(t, ydt);
          t = t < 0.f ? 0.f : t;
        }
        z[k] = t;
      }
      const int64_t g = at(v);
      if (ydt == F32) {
        Float32<VEC> f;
#pragma unroll
        for (int k = 0; k < VEC; ++k) f.v[k] = z[k];
        *reinterpret_cast<Float32<VEC>*>(static_cast<float*>(y) + g) = f;
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) store(y, g + k, z[k], ydt);
      }
    }
  }
  // no block leaves while another of its cluster may still read its sums
  if (cs > 1) cluster_sync();
}

template <int VEC>
int launch(const void* x, const void* w, const void* b, void* rm, void* rv, const void* r,
           void* y, void* stats, int N, int C, int S, int cs, int smem, float eps,
           float momentum, float keep_new, int xdt, int wdt, int bdt, int rmdt, int rvdt, int rdt,
           int ydt, int has_res, int relu, int round_x, cudaStream_t stream) {
  auto kernel = ptt_bn_fwd_cluster_kernel<VEC>;
  int err = (int)allow_block_smem(kernel);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)C * cs);
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
  err = (int)cudaLaunchKernelEx(&cfg, kernel, x, w, b, rm, rv, r, y, static_cast<float*>(stats), N,
                                C, S, cs, (float)N * S, eps, momentum, keep_new, xdt, wdt, bdt,
                                rmdt, rvdt, rdt, ydt, has_res, relu, round_x);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory bytes of a block (kernels/batch_norm.py's plan computes the
// same).
int ptt_batch_norm_fwd_smem(int N, int S, int cs) {
  const int64_t e = (int64_t)((N + cs - 1) / cs) * S;
  const int64_t bytes = 4 * (int64_t)(SUMS + WARPS) + 2 * e;
  return (int)((bytes + 15) / 16 * 16);
}

// x [N, C, S] (bf16 or f16), w, b [C] (wdt, bdt), the running statistics
// rm, rv [C] (rmdt, rvdt; updated in place), r [N, C, S] (rdt; read only with
// has_res); written: y [N, C, S] (ydt), stats [2, C] fp32 (mean, rstd).
// Dtypes: 0 float32, 1 bfloat16, 2 float16. All contiguous. A channel a
// cluster of cs blocks (1..8).
int ptt_batch_norm_fwd(const void* x, const void* w, const void* b, void* rm, void* rv,
                       const void* r, void* y, void* stats, int N, int C, int S, int cs,
                       float eps, float momentum, float keep_new, int xdt, int wdt, int bdt,
                       int rmdt, int rvdt, int rdt, int ydt, int has_res, int relu,
                       int round_x, void* stream) {
  if (N <= 0 || C <= 0 || S <= 1 || cs <= 0 || cs > 8 || (xdt != BF16 && xdt != F16))
    return (int)cudaErrorInvalidValue;
  const int smem = ptt_batch_norm_fwd_smem(N, S, cs);
  if (!has_res) r = x;
  // the widest access that S and the pointers allow
  const bool aligned = ((uintptr_t)x | (uintptr_t)r | (uintptr_t)y) % 16 == 0;
  const int vec = !aligned ? 1 : S % 8 == 0 ? 8 : S % 4 == 0 ? 4 : S % 2 == 0 ? 2 : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_BN_FWD(V)                                                                          \
  launch<V>(x, w, b, rm, rv, r, y, stats, N, C, S, cs, smem, eps, momentum, keep_new, xdt, wdt, \
            bdt, rmdt, rvdt, rdt, ydt, has_res, relu, round_x, s)
  switch (vec) {
    case 8: return PTT_BN_FWD(8);
    case 4: return PTT_BN_FWD(4);
    case 2: return PTT_BN_FWD(2);
    default: return PTT_BN_FWD(1);
  }
#undef PTT_BN_FWD
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
