// GroupNorm's backward, with the SiLU's derivative where the forward fused
// the SiLU, in one pass over a group held in shared memory across a
// thread-block cluster (Hopper, sm_90a).
//
// No TPU kernel: the JAX package's F.group_norm (paddle_tpu/nn/functional/
// norm.py:186-223) and the SiLU after it (activation.py:34) are jnp, whose
// vjp XLA fuses. kernels/group_norm.py holds the port's forward and its
// Triton backward; this kernel takes the backward wherever
// group_norm_backward_plan sends it: channels first, x in bf16 or fp16, a
// spatial size a multiple of 8 and a group that fits on chip over at most 8
// blocks (every GroupNorm of the Stable Diffusion UNet).
//
// What it computes, per group (n, g) of x [N, C, S] with Cg = C / G
// channels, from the forward's (mean, rstd): x-hat = (x - mean) rstd; dz =
// dy, or under the SiLU dy silu'(z) with z = x-hat w + b, z and dz each
// rounded to dy's dtype where the separate ops round (PyTorch's SiLU
// backward in fp32: s = 1 / (1 + exp(-z)), dy s (1 + z (1 - s))); per
// channel c the sums A_c = sum dz x-hat and B_c = sum dz; the group's sa =
// sum_c w_c A_c and sb = sum_c w_c B_c; dx = rstd (dz w_c - sb / M - x-hat
// sa / M), M = Cg S, in x's dtype. The pairs (A_c, B_c) of sample n go to
// row n of a [N, 2 C] table, which ordered_col_sum_kernel adds over the
// samples in order into dweight and dbias.
//
// Bound on the H100: bytes (x and dy read, dx written; about 20 flops an
// element, 32 with the SiLU's exp and division, against the ~20 a byte the
// card can do before compute is the limit). The Triton backward read x and
// dy twice (partials, then dx: five tensor passes against three) and took
// three launches. A group of an NCHW tensor is one contiguous run of Cg S
// values (the UNet's largest, [4, 960, 64, 64] at G 32: 122,880, 480 KB of
// bf16 x and dy). Here a cluster of cs blocks (1 to 8) owns a group, as
// batch_norm_bwd.cu's clusters own a channel:
//   1. block rank r takes the group's channels [r cpb, (r + 1) cpb), cpb =
//      ceil(Cg / cs): a contiguous run of x and dy read once into shared
//      memory by cp.async, all of its 16-byte pieces in flight at once (x
//      in its dtype, dy with room for fp32: 6 bytes an element; four
//      groups of channels, each worked on as it lands, measured slower);
//   2. a channel over 512 / 2^ceil(log2 cpb) threads, which write the
//      SiLU's dz over dy and sum dz x-hat and dz; A_c and B_c: the
//      channel's threads' sums by the xor tree, then its warps in order;
//      the block adds w_c A_c and w_c B_c in channel order, then the
//      cluster's blocks read each other's sums through distributed shared
//      memory and add them in rank order, so every block holds the same
//      totals;
//   3. dx from shared memory, written once with 16-byte stores.
// No atomics: the same inputs give the same bits, and a captured step its
// eager step's. Two launches a call (this kernel, then the column sum as a
// programmatic dependent launch). The plan picks cs, the fewest blocks of
// a power of two whose block stays within ~113 KB (two blocks an SM).
// With the SiLU the kernel issues about 60 instructions an element (the
// exp and the IEEE division of PyTorch's bits): at the UNet's 64 x 64
// shapes that, and not the bytes, holds it near 0.4 of the bytes bound.
//
// Plain C interface, loaded with ctypes; ptt_group_norm_bwd launches on the
// caller's stream and returns a cudaError_t value.

#include "batch_norm_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace bn;
using namespace hopper;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 8;   // values a vector: 16 bytes of x

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// PyTorch's SiLU backward in fp32 (IEEE division, the full-precision exp)
__device__ __forceinline__ float dsilu(float z, float dy) {
  const float s = 1.f / (1.f + expf(-z));
  return dy * s * (1.f + z * (1.f - s));
}

// Grid: N G clusters of cs blocks, a cluster a group. Shared memory (the
// plan's bytes): this block's sums [4], the group's totals [4], the warps'
// sums [WARPS][2], the channels' weight, bias, A and B [cpb] each, dy then
// dz [cpb S] (4 bytes an element reserved), x [cpb S] 16-bit.
__global__ void __launch_bounds__(THREADS, 2)
ptt_gn_bwd_cluster_kernel(const void* __restrict__ x, const void* __restrict__ dy,
                          const float* __restrict__ stats, const void* __restrict__ w,
                          const void* __restrict__ b, void* __restrict__ dx,
                          float* __restrict__ table, int C, int G, int Cg, int S, int cs,
                          int cpb, float m_count, int xdt, int dydt, int wdt, int bdt, int silu) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = cs > 1 ? (int)cluster_rank() : 0;
  const int ng = blockIdx.x / cs, nn = ng / G, g = ng - nn * G;
  const int c_lo = min(rank * cpb, Cg), nc = min(c_lo + cpb, Cg) - c_lo;
  float* bsum = smem;                  // 16-byte aligned: read as float4
  float* tot = smem + 4;
  float* wpart = smem + 8;             // [WARPS][2]
  float* pw = wpart + 2 * WARPS;
  float* pb = pw + cpb;
  float* ca = pb + cpb;
  float* cb = ca + cpb;
  // dy, then dz in dy's dtype, in the first 4 cpb S bytes after the sums
  // (room for fp32 whatever dy's dtype: the plan, and so the order of the
  // sums, does not depend on it); x (16-bit) after them
  unsigned char* gz = reinterpret_cast<unsigned char*>(cb + cpb);   // 16-byte aligned
  uint16_t* xs = reinterpret_cast<uint16_t*>(gz + (size_t)4 * cpb * S);
  const int c0 = g * Cg + c_lo;        // this block's first channel
  const int64_t base = ((int64_t)nn * C + c0) * S;
  const int dyb = dydt == F32 ? 4 : 2;
  // 1. x and dy read once, every 16 bytes of the block's run in flight at
  // once (cp.async), before the parameters are read
  {
    const unsigned char* xg = reinterpret_cast<const unsigned char*>(
        static_cast<const uint16_t*>(x) + base);
    const unsigned char* dg = static_cast<const unsigned char*>(dy) + base * dyb;
    const int xn = nc * S * 2 / 16, dn = nc * S * dyb / 16;
    for (int i = tid; i < xn; i += THREADS)
      cp16(reinterpret_cast<unsigned char*>(xs) + (size_t)i * 16, xg + (int64_t)i * 16);
    for (int i = tid; i < dn; i += THREADS) cp16(gz + (size_t)i * 16, dg + (int64_t)i * 16);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  const float mean = stats[2 * ng], rstd = stats[2 * ng + 1];
  for (int i = tid; i < nc; i += THREADS) {
    pw[i] = load(w, c0 + i, wdt);
    pb[i] = load(b, c0 + i, bdt);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  const int vs = S / VEC;              // vectors a channel
  const int nv = nc * vs;
  const Divider by_vs(vs);

  // a channel's vectors over tpc threads (a power of two): dz = dy, or
  // under the SiLU its derivative's product written over dy; each thread's
  // sums of dz x-hat and dz
  int lg = 0;
  while ((1 << lg) < nc) ++lg;
  const int tpc = THREADS >> min(lg, 9);   // the plan keeps nc <= THREADS
  const int ch = tid / tpc, sub = tid - ch * tpc;
  float sa = 0.f, sb = 0.f;
  if (ch < nc) {
    const float wc = pw[ch], bc = pb[ch];
    for (int j = sub; j < vs; j += tpc) {
      const int64_t v = (int64_t)ch * vs + j;
      float d[VEC], xv[VEC];
      load8(gz + v * VEC * dyb, dydt, d);
      unpack8(*reinterpret_cast<const uint4*>(xs + v * VEC), xdt, xv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xh = (xv[e] - mean) * rstd;
        if (silu) {
          const float z = round_to(xh * wc + bc, dydt);
          d[e] = round_to(dsilu(z, d[e]), dydt);
        }
        sa += d[e] * xh;
        sb += d[e];
      }
      if (silu) store8(gz + v * VEC * dyb, d, dydt);
    }
  }
  // 2. a channel's sums in a fixed order: the xor tree over its threads'
  // lanes (every lane of a warp takes part), then its warps in order
  for (int off = min(tpc, 32) / 2; off > 0; off >>= 1) {
    sa += __shfl_xor_sync(0xffffffffu, sa, off);
    sb += __shfl_xor_sync(0xffffffffu, sb, off);
  }
  if (tpc <= 32) {
    if (sub == 0 && ch < nc) {
      ca[ch] = sa;
      cb[ch] = sb;
    }
    __syncthreads();
  } else {
    if (lane == 0) {
      wpart[2 * warp] = sa;
      wpart[2 * warp + 1] = sb;
    }
    __syncthreads();
    if (tid < nc) {
      const int per = tpc / 32;
      float a = 0.f, c = 0.f;
      for (int k = 0; k < per; ++k) {
        a += wpart[2 * (tid * per + k)];
        c += wpart[2 * (tid * per + k) + 1];
      }
      ca[tid] = a;
      cb[tid] = c;
    }
    __syncthreads();
  }
  // the pairs into row nn of the table; the block's w-weighted sums in
  // channel order
  for (int i = tid; i < nc; i += THREADS) {
    table[(int64_t)nn * 2 * C + c0 + i] = ca[i];
    table[(int64_t)nn * 2 * C + C + c0 + i] = cb[i];
  }
  if (tid == 0) {
    float sa = 0.f, sb = 0.f;
    for (int i = 0; i < nc; ++i) {
      sa += pw[i] * ca[i];
      sb += pw[i] * cb[i];
    }
    bsum[0] = sa;
    bsum[1] = sb;
  }
  // the cluster's blocks in rank order: every block the same totals
  if (cs > 1)
    cluster_sync();
  else
    __syncthreads();
  if (tid == 0) {
    float sa = 0.f, sb = 0.f;
    if (cs > 1) {
      for (int r = 0; r < cs; ++r) {
        const float4 t = ld_cluster_f4(smem_u32(bsum), (uint32_t)r);
        sa += t.x;
        sb += t.y;
      }
    } else {
      sa = bsum[0];
      sb = bsum[1];
    }
    tot[0] = sb / m_count;
    tot[1] = sa / m_count;
  }
  __syncthreads();

  // 3. dx from shared memory, written once
  const float mg = tot[0], mgx = tot[1];
  uint16_t* dxg = static_cast<uint16_t*>(dx) + base;
  for (int v = tid; v < nv; v += THREADS) {
    const float wc = pw[by_vs.div(v)];
    float xv[VEC], d[VEC];
    unpack8(*reinterpret_cast<const uint4*>(xs + (int64_t)v * VEC), xdt, xv);
    load8(gz + (int64_t)v * VEC * dyb, dydt, d);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float xh = (xv[e] - mean) * rstd;
      d[e] = rstd * (d[e] * wc - mg - xh * mgx);
    }
    store8(dxg + (int64_t)v * VEC, d, xdt);
  }
  // the column sum may start its launch (it waits for this grid to end)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // no block leaves while another of its cluster may still read its sums
  if (cs > 1) cluster_sync();
}

}  // namespace

extern "C" {

// x [N, C, S] (bf16 or f16, xdt), dy [N, C, S] (dydt), stats [N G, 2] fp32
// (mean, rstd), w, b [C] (wdt, bdt); written: dx (x's dtype), table [N, 2 C]
// fp32 scratch, sums [2 C] fp32 (dweight, dbias). Dtypes: 0 float32, 1
// bfloat16, 2 float16. All contiguous, 16-byte aligned; S % 8 == 0; a group
// a cluster of cs blocks (1..8) of cpb = ceil(Cg / cs) channels each.
// smem: a block's shared memory bytes as group_norm_backward_plan gives
// them (kernels/group_norm.py _cluster_smem, the one place that sizes the
// layout above the kernel: 8 floats of sums, 2 WARPS of the warps' sums, 4
// cpb of the channels' parameters and sums, 6 bytes an element of cpb S).
int ptt_group_norm_bwd(const void* x, const void* dy, const void* stats, const void* w,
                       const void* b, void* dx, void* table, void* sums, int N, int C, int G,
                       int S, int cs, int smem, int xdt, int dydt, int wdt, int bdt, int silu,
                       void* stream) {
  if (N <= 0 || C <= 0 || G <= 0 || C % G || S <= 0 || S % VEC || cs <= 0 || cs > 8 ||
      smem <= 0 || (xdt != BF16 && xdt != F16))
    return (int)cudaErrorInvalidValue;
  const int Cg = C / G, cpb = (Cg + cs - 1) / cs;
  if (cpb > THREADS) return (int)cudaErrorInvalidValue;
  int err = (int)allow_block_smem(ptt_gn_bwd_cluster_kernel);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(N * G * cs));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, ptt_gn_bwd_cluster_kernel, x, dy,
                                static_cast<const float*>(stats), w, b, dx,
                                static_cast<float*>(table), C, G, Cg, S, cs, cpb,
                                (float)Cg * S, xdt, dydt, wdt, bdt, silu);
  if (err) return err;
  err = (int)launch_col_sum<8>(static_cast<const float*>(table), static_cast<float*>(sums), N,
                               2 * C, s);
  if (err) return err;
  return (int)cudaGetLastError();
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
