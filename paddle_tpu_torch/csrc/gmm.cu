// Grouped matrix products of the dropless MoE layer (Hopper, sm_90a).
//
// Replaces paddle_tpu/kernels/gmm_pallas.py: _gmm_call (_gmm_kernel) and
// _tgmm_call (_tgmm_kernel). Same functions:
//   gmm:  x [t, k], w [e, k, n] (or [e, n, k] with trans_w), rows of x
//         sorted by group, group g owning rows [off[g], off[g+1]);
//         out[r] = x[r] . w[g] for each row r of group g, summed in fp32 and
//         rounded once to x's dtype; rows at or past off[e] are written as 0.
//   tgmm: dw[g] = x_g^T . dy_g over the rows of group g, fp32 out [e, k, n];
//         a group with no rows gets zeros.
// off is the device-resident prefix sum [e + 1] of the group sizes: the
// kernels read it themselves, so the host never learns the group sizes and
// the launch needs no sync. The grids are sized from t, k, n and e alone.
//
// Bound on the H100: operations. At the MoE slice's shapes ([16384, 768] x
// [8, 768, 3072] and back) a product does 7.7e10 flops on ~164 MB (gmm) or
// ~201 MB (tgmm), ~470 flop/byte from device memory, above the card's ~295,
// so the tensor cores are the limit.
//
// bf16, against that bound: TMA and wgmma, the layout of the flash kernels
// (hopper_common.cuh holds the pieces both use).
//   * a block is three warpgroups: two consumers of 64 rows each (wgmma's
//     m64) and a producer, of which one warp issues the loads and the rest
//     exit; setmaxnreg gives the producer 40 registers and each consumer
//     232; a ring of stages of 64-deep slices in shared memory, with full
//     barriers (TMA bytes) and empty ones (one arrival per consumer warp of
//     the cluster); one wgmma batch stays in flight: a stage is freed when
//     the next slice's batch has been issued and the one before has
//     finished;
//   * clusters of two blocks on two output tiles that share B: each block
//     loads its own A and half of B, which TMA multicasts into both, so a
//     stage costs L2 one B for two tiles;
//   * a persistent grid, as many clusters as the card holds at once, walks
//     the work items in turn, so the producer loads the next tile's stages
//     while the consumers store this one; items in row-major order, so the
//     clusters at work share rows of x and one group's weights in L2;
//   * gmm: 128 x 256 output tiles (128 fp32 accumulators a consumer
//     thread), a cluster on two row tiles of one column tile; A = 128 rows
//     of x as one K-major panel; B = w[g] through a 3-d map over [e, k, n]:
//     four MN-major panels of 64 columns read with the transpose bit, or,
//     with trans_w ([e, n, k]), one K-major panel of 256 rows. The cluster
//     runs the k loop once per group crossing its rows; rows of the other
//     groups are loaded and computed but not kept (an output row depends
//     only on its input row). The consumers gather each group's rows, and
//     zeros for rows past off[e], in a bf16 tile in shared memory (swizzled
//     128B: conflict-free writes), which one thread stores by TMA while the
//     next tile's k loop runs: every row is written once, by one block, with
//     no atomics and no read-modify-write. 3 stages beside that tile;
//   * tgmm: 128 x 192 tiles of dw[g] (8 x 6 x 16 = 768 at the slice, 5.8
//     of them an SM: no split of the reduction), a cluster on two k tiles
//     of one n tile of one group, 5 stages of 64 rows of the group: A =
//     x_g^T and B = dy_g, both MN-major panels (x's columns and dy's are
//     contiguous) read with the transpose bit; each group's walk starts at
//     off[g] (a TMA box starts at any row), and in the last slice of a
//     group each consumer zeroes the rows of the next group in its own A
//     panel (whole 128-byte rows, which the swizzle keeps in place) before
//     its wgmma reads it; the fp32 tile is stored from the registers, a
//     quad of threads to a 32-byte sector.
// The choices against their alternatives, each measured in one call:
// paddle_tpu_torch/tools/gmm_variants.py (its VARIANTS undo them).
// float32 keeps FMA kernels (one block of 8 warps per 128 x 128 output
// tile, the reduction staged through a 3-deep cp.async ring).
//
// Plain C interface, loaded with ctypes. Launches go on the caller's
// stream; each function returns cudaGetLastError() so a refused launch is
// reported to the caller.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper_common.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int BM = 128;  // rows of an output tile
constexpr int MAX_GROUPS = 1024;

// -- bf16: TMA and wgmma ------------------------------------------------------------

constexpr int BK = 64;  // reduction depth of a stage: one 128-byte panel
constexpr int GMM_BN = 256;
constexpr int TGMM_BN = 192;
constexpr int CLUSTER = 2;    // blocks of a cluster: they share each stage's B
constexpr int CONSUMERS = 2;  // consumer warpgroups of 64 rows
constexpr int WG_THREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 40 * 128 + 232 * 256 = 168 * 384, the launch's
constexpr int SMEM_MAX = 232448;    // dynamic shared memory a block may have

// The shared memory of a block: STAGES_ stages of A ([BM x BK]) and B
// ([BK x BN]), then OUT_ bytes for the output tile, then the full and
// empty barriers of each stage, then EXTRA bytes (gmm: the group offsets).
template <int BN, int STAGES_, int OUT_, int EXTRA>
struct Ring {
  static constexpr int A = BM * BK * 2;
  static constexpr int B = BK * BN * 2;
  static constexpr int STAGES = STAGES_;
  static constexpr int OUT = STAGES * (A + B);
  static constexpr int BAR = OUT + OUT_;
  static constexpr int OFF = BAR + 2 * STAGES * 8;
  static constexpr int BYTES = OFF + EXTRA + 1024;  // and the alignment to 1024 bytes
  static_assert(BYTES <= SMEM_MAX, "the ring does not fit");
  static __device__ __forceinline__ uint32_t a(uint32_t base, int st) { return base + st * A; }
  static __device__ __forceinline__ uint32_t b(uint32_t base, int st) {
    return base + STAGES * A + st * B;
  }
};
// gmm: 3 stages and the bf16 output tile (4 panels of [BM, 64]), then the
// offsets; tgmm: 5 stages, its fp32 tile stored from the registers.
using GmmRing = Ring<GMM_BN, 3, BM * GMM_BN * 2, (MAX_GROUPS + 1) * 4>;
using TgmmRing = Ring<TGMM_BN, 5, 0, 0>;

// Pair (row r, columns 8 j + 2 t, + 1) of a [BM, 64 c] bf16 tile kept as
// c panels of [BM, 64] swizzled 128B, the layout TMA stores from: a
// warp's lanes (8 rows x 4 pairs) write 8 distinct 16-byte chunks.
__device__ __forceinline__ uint32_t* staged(uint8_t* tile, int r, int j, int t) {
  return reinterpret_cast<uint32_t*>(tile + (j / 8) * BM * 128 + r * 128 +
                                     (((j % 8) ^ (r % 8)) << 4) + 4 * t);
}

// The ring's position: stage and the parity of its current phase.
struct Turn {
  int st = 0, ph = 0;
  template <int STAGES>
  __device__ __forceinline__ void next() {
    if (++st == STAGES) st = 0, ph ^= 1;
  }
};

// A stage is empty once every consumer warp of the cluster has freed it:
// a block's loads of B fill the stage in every block of the cluster.
template <int STAGES>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * CONSUMERS * CLUSTER);
    }
    mbar_fence_init();
  }
}

// After the ring's set-up: the cluster's barriers are ready before any
// block loads into or frees another's stages.
__device__ __forceinline__ void ring_ready() {
  if constexpr (CLUSTER == 1)
    __syncthreads();
  else
    cluster_sync();
}

// This block's share of a stage's B: a box loaded into every block of the
// cluster.
__device__ __forceinline__ void load_shared(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  if constexpr (CLUSTER == 1)
    tma_load(dst, map, bar, c0, c1, c2);
  else
    tma_load_multicast(dst, map, bar, c0, c1, c2, (1 << CLUSTER) - 1);
}

// A consumer warp frees a stage in every block of the cluster.
__device__ __forceinline__ void release(uint64_t* bar) {
  if constexpr (CLUSTER == 1) {
    mbar_arrive(bar);
  } else {
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) mbar_arrive_cluster(bar, r);
  }
}

// The producer's end: it waits until the consumers of the cluster have
// freed every stage, so that no block leaves while another may still load
// into it or free its stages, and a consumer stuck on a stage that never
// fills traps the launch through the guarded wait instead of holding the
// card.
template <int STAGES>
__device__ __forceinline__ void drain(Turn& r, uint64_t* empty) {
  for (int i = 0; i < STAGES; ++i) {
    mbar_wait_guarded(&empty[r.st], r.ph ^ 1);
    r.next<STAGES>();
  }
}

// A consumer's main loop over n_it slices: wait for the slice, issue its
// wgmma batch (mma(stage, it)), then free the stage of the slice before,
// whose batch has finished by then; prep(stage, it) runs on a landed slice
// before its batch. At the end every batch has finished and every stage
// is free.
template <int STAGES, typename Prep, typename Mma>
__device__ __forceinline__ void consume(int n_it, Turn& r, uint64_t* full, uint64_t* empty,
                                        Prep prep, Mma mma) {
  const int lane = threadIdx.x & 31;
  int prev = -1;
  for (int it = 0; it < n_it; ++it) {
    mbar_wait(&full[r.st], r.ph);
    prep(r.st, it);
    wgmma_fence();
    mma(r.st, it);
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0) {
      __syncwarp();
      if (lane == 0) release(&empty[prev]);
    }
    prev = r.st;
    r.next<STAGES>();
  }
  wgmma_wait<0>();
  if (prev >= 0) {
    __syncwarp();
    if (lane == 0) release(&empty[prev]);
  }
}

// gmm. Grid: clusters of CLUSTER blocks, as many as the card holds at
// once, at most one a work item: CLUSTER row tiles (one a block) of one
// column tile, which share B. The block runs the k loop of every group
// that crosses the cluster's rows (the same for each block) and keeps its
// own rows; the consumers gather a tile's rows, group by group, in the
// staged output tile, and one thread stores it by TMA while they go on to
// the next tile.
template <bool TRANS>
__global__ void __launch_bounds__(WG_THREADS, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                 const __grid_constant__ CUtensorMap tout, const int* __restrict__ off, int t,
                 int k, int n, int e) {
  constexpr int BN = GMM_BN;
  using L = GmmRing;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const uint32_t base = smem_u32(sm);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* empty = full + STAGES;
  int* s_off = reinterpret_cast<int*>(sm + L::OFF);
  const int wg = threadIdx.x / 128;
  const int rank = CLUSTER == 1 ? 0 : (int)cluster_rank();
  init_ring<STAGES>(full, empty);
  for (int i = threadIdx.x; i <= e; i += WG_THREADS) s_off[i] = min(max(off[i], 0), t);
  ring_ready();
  const int n_ct = (n + BN - 1) / BN;
  const int n_work = n_ct * (((t + BM - 1) / BM + CLUSTER - 1) / CLUSTER);
  const int n_k = (k + BK - 1) / BK;
  Turn r;

  if (wg == CONSUMERS) {  // the producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != 128 * CONSUMERS) return;
    for (int w = blockIdx.x / CLUSTER; w < n_work; w += gridDim.x / CLUSTER) {
      const int p0 = w / n_ct * CLUSTER * BM;  // the cluster's rows [p0, pend)
      const int pend = min(p0 + CLUSTER * BM, t);
      const int r0 = p0 + rank * BM;
      const int c0 = w % n_ct * BN;
      for (int g = 0; g < e && s_off[g] < pend; ++g) {
        if (max(s_off[g], p0) >= min(s_off[g + 1], pend)) continue;
        for (int kt = 0; kt < n_k; ++kt) {
          mbar_wait_guarded(&empty[r.st], r.ph ^ 1);
          mbar_expect_tx(&full[r.st], L::A + L::B);
          tma_load(L::a(base, r.st), &tx, &full[r.st], kt * BK, r0, 0);
          if constexpr (TRANS) {  // w[g] is [n, k]: BN rows of k, one K-major panel
            constexpr int ROWS = BN / CLUSTER;  // this block's share
            load_shared(L::b(base, r.st) + rank * ROWS * 128, &tw, &full[r.st], kt * BK,
                        c0 + rank * ROWS, g);
          } else {  // w[g] is [k, n]: BK rows of n, BN / 64 MN-major panels
            for (int p = rank; p < BN / 64; p += CLUSTER)  // this block's share
              load_shared(L::b(base, r.st) + p * BK * 128, &tw, &full[r.st], c0 + 64 * p,
                          kt * BK, g);
          }
          r.next<STAGES>();
        }
      }
    }
    drain<STAGES>(r, empty);
  } else {  // a consumer: rows r0 + 64 wg .. + 63 of each tile
    setmaxnreg_inc<CONSUMER_REGS>();
    const int lane = threadIdx.x & 31;
    const int t4 = lane & 3;
    const int row_in = 64 * wg + 16 * ((threadIdx.x / 32) & 3) + (lane >> 2);  // and + 8
    uint8_t* c_s = sm + L::OUT;
    float acc[BN / 2];
    for (int w = blockIdx.x / CLUSTER; w < n_work; w += gridDim.x / CLUSTER) {
      const int p0 = w / n_ct * CLUSTER * BM;
      const int pend = min(p0 + CLUSTER * BM, t);
      const int r0 = p0 + rank * BM;  // this block's rows [r0, rend), maybe none
      const int rend = min(r0 + BM, t);
      const int c0 = w % n_ct * BN;
      bool c_free = false;
      // before the first write to the staged tile: the last tile's store
      // has read it (long since: a k loop ran in between)
      auto claim = [&]() {
        if (c_free) return;
        if (threadIdx.x == 0) tma_store_wait_read<0>();
        named_barrier(1, 128 * CONSUMERS);
        c_free = true;
      };
      for (int g = 0; g < e && s_off[g] < pend; ++g) {
        if (max(s_off[g], p0) >= min(s_off[g + 1], pend)) continue;
        const int lo = max(s_off[g], r0) - r0;  // this block's rows of the group
        const int hi = min(s_off[g + 1], rend) - r0;
        consume<STAGES>(
            n_k, r, full, empty, [](int, int) {},
            [&](int st, int it) {  // the first slice overwrites acc
#pragma unroll
              for (int kk = 0; kk < BK / 16; ++kk) {
                const uint64_t a = kmajor(L::a(base, st), BM, 64 * wg, kk);
                const uint64_t b = TRANS ? kmajor(L::b(base, st), BN, 0, kk)
                                         : mnmajor(L::b(base, st), BK, 16 * kk);
                wgmma_ss<BN, 0, TRANS ? 0 : 1>(acc, a, b, it > 0 || kk > 0);
              }
            });
        fence_regs(acc);
        claim();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row_in + 8 * h;
          if (row < lo || row >= hi) continue;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
            *staged(c_s, row, j, t4) = pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
      // rows at or past the last group's end hold zeros
      const int z0 = max(s_off[e], r0) - r0;
      claim();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row_in + 8 * h;
        if (row < z0 || row >= rend - r0) continue;
        for (int j = 0; j < BN / 8; ++j) *staged(c_s, row, j, t4) = 0u;
      }
      // the tile, rows and columns past the matrix's end left out by TMA
      fence_proxy_async();
      named_barrier(1, 128 * CONSUMERS);
      if (threadIdx.x == 0 && r0 < t) {
#pragma unroll
        for (int p = 0; p < BN / 64; ++p)
          if (c0 + 64 * p < n) tma_store(&tout, base + L::OUT + p * BM * 128, c0 + 64 * p, r0, 0);
        tma_store_commit();
      }
    }
    if (threadIdx.x == 0) tma_store_wait<0>();  // before the block's shared memory goes
  }
}

// tgmm. Grid: clusters of CLUSTER blocks, as many as the card holds at
// once, at most one a work item: CLUSTER k tiles (one a block) of one n
// tile of one group, which share B (the group's rows of dy); work items in
// (group, k tiles, n tile) order.
__global__ void __launch_bounds__(WG_THREADS, 1)
tgmm_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
                  const int* __restrict__ off, float* __restrict__ dw, int t, int k, int n,
                  int e) {
  constexpr int BN = TGMM_BN;
  using L = TgmmRing;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const uint32_t base = smem_u32(sm);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128;
  const int rank = CLUSTER == 1 ? 0 : (int)cluster_rank();
  init_ring<STAGES>(full, empty);
  ring_ready();
  const int n_nt = (n + BN - 1) / BN;
  const int per_group = n_nt * (((k + BM - 1) / BM + CLUSTER - 1) / CLUSTER);
  const int n_work = e * per_group;
  Turn r;

  if (wg == CONSUMERS) {  // the producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != 128 * CONSUMERS) return;
    for (int w = blockIdx.x / CLUSTER; w < n_work; w += gridDim.x / CLUSTER) {
      const int g = w / per_group;
      const int m0 = (w % per_group / n_nt * CLUSTER + rank) * BM;
      const int c0 = w % n_nt * BN;
      const int lo = min(max(__ldg(off + g), 0), t);
      const int hi = max(min(__ldg(off + g + 1), t), lo);
      for (int q0 = lo; q0 < hi; q0 += BK) {
        mbar_wait_guarded(&empty[r.st], r.ph ^ 1);
        mbar_expect_tx(&full[r.st], L::A + L::B);
#pragma unroll
        for (int p = 0; p < BM / 64; ++p)
          tma_load(L::a(base, r.st) + p * BK * 128, &tx, &full[r.st], m0 + 64 * p, q0, 0);
        for (int p = rank; p < BN / 64; p += CLUSTER)  // this block's share of B
          load_shared(L::b(base, r.st) + p * BK * 128, &tdy, &full[r.st], c0 + 64 * p, q0, 0);
        r.next<STAGES>();
      }
    }
    drain<STAGES>(r, empty);
  } else {  // a consumer: rows m0 + 64 wg .. + 63 of each tile (columns of x)
    setmaxnreg_inc<CONSUMER_REGS>();
    const int lane = threadIdx.x & 31;
    const int t4 = lane & 3;
    const int row_in = 64 * wg + 16 * ((threadIdx.x / 32) & 3) + (lane >> 2);  // and + 8
    float acc[BN / 2];
    for (int w = blockIdx.x / CLUSTER; w < n_work; w += gridDim.x / CLUSTER) {
      const int g = w / per_group;
      const int m0 = (w % per_group / n_nt * CLUSTER + rank) * BM;  // maybe past k
      const int c0 = w % n_nt * BN;
      const int lo = min(max(__ldg(off + g), 0), t);
      const int hi = max(min(__ldg(off + g + 1), t), lo);
      zero(acc);  // an empty group stores these zeros
      consume<STAGES>(
          (hi - lo + BK - 1) / BK, r, full, empty,
          [&](int st, int it) {
            // rows at or past hi belong to the next group (or lie past t):
            // zero them in this warpgroup's A panel before its wgmma reads it
            const int valid = hi - lo - it * BK;
            if (valid >= BK) return;
            uint8_t* panel = sm + st * L::A + wg * BK * 128;
            for (int i = valid * 8 + (threadIdx.x & 127); i < BK * 8; i += 128)
              reinterpret_cast<uint4*>(panel)[i] = make_uint4(0u, 0u, 0u, 0u);
            fence_proxy_async();
            named_barrier(1 + wg, 128);
          },
          [&](int st, int) {
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
              wgmma_ss<BN, 1, 1>(acc, mnmajor(L::a(base, st) + wg * BK * 128, BK, 16 * kk),
                                 mnmajor(L::b(base, st), BK, 16 * kk), 1);
          });
      fence_regs(acc);
      float* dst = dw + ((size_t)g * k + m0) * n + c0;
      const int n_rows = min(BM, k - m0);
      const int n_cols = min(BN, n - c0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row_in + 8 * h;
        if (row >= n_rows) continue;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = 8 * j + 2 * t4;
          if (col < n_cols)
            *reinterpret_cast<float2*>(dst + (size_t)row * n + col) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// Launches `kernel` on clusters of CLUSTER blocks: as many clusters as the
// card holds at once, and at most `work` of them.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int work, int smem, cudaStream_t stream,
                            Args... args) {
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER * work);
  cfg.blockDim = dim3(WG_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3(CLUSTER * std::min(work, clusters));
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t launch_gmm_bf16(const void* x, const void* w, const int* off, void* out, int t, int k,
                            int n, int e, bool trans, cudaStream_t stream) {
  CUtensorMap tx{}, tw{}, tout{};
  const bool ok = tensor_map(&tx, x, true, k, t, 1, BK, BM) &&
                  (trans ? tensor_map(&tw, w, true, k, n, e, BK, GMM_BN / CLUSTER)
                         : tensor_map(&tw, w, true, n, k, e, 64, BK)) &&
                  tensor_map(&tout, out, true, n, t, 1, 64, BM);
  if (!ok) return cudaErrorInvalidValue;
  const int work = ((t + BM - 1) / BM + CLUSTER - 1) / CLUSTER * ((n + GMM_BN - 1) / GMM_BN);
  return launch_clusters(trans ? gmm_wgmma_kernel<true> : gmm_wgmma_kernel<false>, work,
                         GmmRing::BYTES, stream, tx, tw, tout, off, t, k, n, e);
}

cudaError_t launch_tgmm_bf16(const void* x, const void* dy, const int* off, void* dw, int t, int k,
                             int n, int e, cudaStream_t stream) {
  CUtensorMap tx{}, tdy{};
  const int rows = std::max(t, 1);  // t = 0: every group is empty, nothing is read
  const bool ok = tensor_map(&tx, x, true, k, rows, 1, 64, BK) &&
                  tensor_map(&tdy, dy, true, n, rows, 1, 64, BK);
  if (!ok) return cudaErrorInvalidValue;
  const int pairs = ((k + BM - 1) / BM + CLUSTER - 1) / CLUSTER;  // of k tiles
  const int work = e * pairs * ((n + TGMM_BN - 1) / TGMM_BN);
  return launch_clusters(tgmm_wgmma_kernel, work, TgmmRing::BYTES, stream, tx, tdy, off,
                         static_cast<float*>(dw), t, k, n, e);
}

// -- float32: FMA ---------------------------------------------------------------------

namespace f32 {

constexpr int BN = 128;  // columns of an output tile
constexpr int WARPS = 8;  // 4 along the rows x 2 along the columns
constexpr int THREADS = 32 * WARPS;
constexpr int WM = 32;  // rows of a warp's piece
constexpr int WN = 64;  // columns of a warp's piece
constexpr int STAGES = 3;  // depth of the shared-memory ring
constexpr int MIN_BLOCKS = 2;  // blocks per SM: caps registers at 128 a thread
constexpr int FK = 16;  // reduction depth of a stage
constexpr int PAD = 4;  // 16 bytes of row padding

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int nb = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(nb));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The reduction over n_it stages through a ring of STAGES shared-memory
// buffers: stage(it, buf) issues the copies of stage it into buffer buf,
// compute(buf) consumes a buffer that has landed. One barrier a stage: it
// makes stage it visible and frees the buffer computed the round before.
template <typename Stage, typename Compute>
__device__ __forceinline__ void pipeline(int n_it, Stage stage, Compute compute) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_it) stage(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = it + STAGES - 1;
    if (nxt < n_it) stage(nxt, nxt % STAGES);
    cp_async_commit();
    compute(it % STAGES);
  }
  __syncthreads();  // the ring is free for the caller's next use
}

// A [ROWS x COLS] tile of a row-major matrix (row stride ld) into shared
// memory (row stride COLS + PAD): element (r, c) comes from src[(row0 + r)
// * ld + col0 + c]. Rows outside [lo, hi) and columns at or past col_end
// are zero-filled. COLS and col0, col_end are multiples of 4.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, size_t ld, int row0,
                                          int lo, int hi, int col0, int col_end) {
  constexpr int PER_ROW = COLS / 4;
  constexpr int LD = COLS + PAD;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i - r * PER_ROW) * 4;
    const int row = row0 + r;
    const bool ok = row >= lo && row < hi && col0 + c < col_end;
    cp_async16(dst + r * LD + c, ok ? src + (size_t)row * ld + col0 + c : src, ok);
  }
}

// Shared-memory stage of the A operand (BM rows of the product) and of B
// (BN columns), each in one of two layouts:
//   A_KM false: A stored [BM][FK] (row m, reduction index contiguous);
//   A_KM true:  A stored [FK][BM] (reduction rows, m contiguous);
//   B_NK false: B stored [FK][BN] (reduction rows, n contiguous);
//   B_NK true:  B stored [BN][FK] (row n, reduction index contiguous).
template <bool A_KM>
__host__ __device__ constexpr int lda() {
  return A_KM ? BM + PAD : FK + PAD;
}
template <bool B_NK>
__host__ __device__ constexpr int ldb() {
  return B_NK ? FK + PAD : BN + PAD;
}
template <bool A_KM>
__host__ __device__ constexpr int a_elems() {
  return A_KM ? FK * (BM + PAD) : BM * (FK + PAD);
}
template <bool B_NK>
__host__ __device__ constexpr int b_elems() {
  return B_NK ? BN * (FK + PAD) : FK * (BN + PAD);
}

// One warp: c[2][8] (its 32 x 64 piece: lane 4g + t holds c[i][j][0..1]
// at row 16i + g, columns 8j + 2t + {0, 1}, and c[i][j][2..3] at row
// 16i + g + 8) += A . B over one stage, in fp32 FMA.
template <bool A_KM, bool B_NK>
__device__ __forceinline__ void warp_fma(float (&c)[2][8][4], const float* As, const float* Bs,
                                         int wm, int wn) {
  constexpr int LDA = lda<A_KM>();
  constexpr int LDB = ldb<B_NK>();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll 4
  for (int kk = 0; kk < FK; ++kk) {
    float a[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm + 16 * i + g + 8 * h;
        a[i][h] = A_KM ? As[kk * LDA + m] : As[m * LDA + kk];
      }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int nn = wn + 8 * j + 2 * t;
      const float b0 = B_NK ? Bs[nn * LDB + kk] : Bs[kk * LDB + nn];
      const float b1 = B_NK ? Bs[(nn + 1) * LDB + kk] : Bs[kk * LDB + nn + 1];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        c[i][j][0] = fmaf(a[i][0], b0, c[i][j][0]);
        c[i][j][1] = fmaf(a[i][0], b1, c[i][j][1]);
        c[i][j][2] = fmaf(a[i][1], b0, c[i][j][2]);
        c[i][j][3] = fmaf(a[i][1], b1, c[i][j][3]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&c)[2][8][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) c[i][j][q] = 0.f;
}

// The elements of a warp's piece whose tile row lies in [lo, hi) (rows
// relative to the tile) and whose column is below n_cols, to a row-major
// [*, ld] matrix whose tile starts at dst.
__device__ __forceinline__ void store_piece(float* dst, size_t ld, const float (&c)[2][8][4],
                                            int wm, int wn, int lo, int hi, int n_cols) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm + 16 * i + g + 8 * h;
      if (r < lo || r >= hi) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int nn = wn + 8 * j + 2 * t;
        if (nn < n_cols)
          *reinterpret_cast<float2*>(dst + (size_t)r * ld + nn) =
              make_float2(c[i][j][2 * h], c[i][j][2 * h + 1]);
      }
    }
}

// Grid (column tiles, row tiles). Shared memory: the offsets, then the
// stages of A (x rows, [BM][FK]) and B (w[g], [FK][BN] or [BN][FK]). The
// block walks the groups that cross its row tile; for each it runs the
// whole k loop with the rows of other groups zero-filled and stores only
// its own rows.
template <bool TRANS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gmm_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const int* __restrict__ off, float* __restrict__ out, int t, int k, int n, int e) {
  constexpr int A_SZ = a_elems<false>();
  constexpr int B_SZ = b_elems<TRANS>();
  __shared__ int s_off[MAX_GROUPS + 1];
  extern __shared__ __align__(16) unsigned char smem_f32[];
  float* a_s = reinterpret_cast<float*>(smem_f32);
  float* b_s = a_s + STAGES * A_SZ;

  const int c0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * BM;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp & 3) * WM;
  const int wn = (warp >> 2) * WN;
  for (int i = threadIdx.x; i <= e; i += THREADS) s_off[i] = min(max(off[i], 0), t);
  __syncthreads();
  const int rend = min(r0 + BM, t);
  const int n_k = (k + FK - 1) / FK;
  float* out_tile = out + (size_t)r0 * n + c0;
  const int n_cols = min(BN, n - c0);
  float c[2][8][4];

  for (int g = 0; g < e; ++g) {
    const int lo = max(s_off[g], r0);
    const int hi = min(s_off[g + 1], rend);
    if (lo >= hi) continue;  // the same for every thread of the block
    const float* wg = w + (size_t)g * k * n;
    auto stage = [&](int it, int buf) {
      const int k0 = it * FK;
      load_tile<BM, FK>(a_s + buf * A_SZ, x, k, r0, lo, hi, k0, k);
      if constexpr (TRANS)  // w[g] is [n, k]: B stored [BN][FK]
        load_tile<BN, FK>(b_s + buf * B_SZ, wg, k, c0, 0, n, k0, k);
      else  // w[g] is [k, n]: B stored [FK][BN]
        load_tile<FK, BN>(b_s + buf * B_SZ, wg, n, k0, 0, k, c0, n);
    };
    zero(c);
    pipeline(n_k, stage, [&](int buf) {
      warp_fma<false, TRANS>(c, a_s + buf * A_SZ, b_s + buf * B_SZ, wm, wn);
    });
    store_piece(out_tile, n, c, wm, wn, lo - r0, hi - r0, n_cols);
  }
  // rows at or past the last group's end hold zeros
  const int z0 = max(s_off[e], r0);
  if (z0 < rend) {
    zero(c);
    store_piece(out_tile, n, c, wm, wn, z0 - r0, rend - r0, n_cols);
  }
}

// Grid (n tiles, k tiles, groups). Shared memory: the stages of A (x rows
// of the group, [FK][BM]: the product's rows are x's columns) and B (dy
// rows, [FK][BN]). The block walks its group's rows, accumulating x_g^T .
// dy_g in registers, and writes its tile once.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
tgmm_fma_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                const int* __restrict__ off, float* __restrict__ dw, int t, int k, int n) {
  constexpr int A_SZ = a_elems<true>();
  constexpr int B_SZ = b_elems<false>();
  extern __shared__ __align__(16) unsigned char smem_f32[];
  float* a_s = reinterpret_cast<float*>(smem_f32);
  float* b_s = a_s + STAGES * A_SZ;

  const int c0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int g = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp & 3) * WM;
  const int wn = (warp >> 2) * WN;
  const int lo = min(max(off[g], 0), t);
  const int hi = max(min(off[g + 1], t), lo);
  const int n_q = (hi - lo + FK - 1) / FK;
  auto stage = [&](int it, int buf) {
    const int q0 = lo + it * FK;
    load_tile<FK, BM>(a_s + buf * A_SZ, x, k, q0, lo, hi, m0, k);
    load_tile<FK, BN>(b_s + buf * B_SZ, dy, n, q0, lo, hi, c0, n);
  };
  float c[2][8][4];
  zero(c);
  pipeline(n_q, stage, [&](int buf) {
    warp_fma<true, false>(c, a_s + buf * A_SZ, b_s + buf * B_SZ, wm, wn);
  });
  // an empty group writes its zeros
  store_piece(dw + (size_t)g * k * n + (size_t)m0 * n + c0, n, c, wm, wn, 0, min(BM, k - m0),
              min(BN, n - c0));
}

cudaError_t launch_gmm(const void* x, const void* w, const int* off, void* out, int t, int k,
                           int n, int e, bool trans, cudaStream_t stream) {
  const size_t smem =
      (size_t)STAGES * (a_elems<false>() + (trans ? b_elems<true>() : b_elems<false>())) * 4;
  auto kernel = trans ? gmm_fma_kernel<true> : gmm_fma_kernel<false>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((n + BN - 1) / BN, (t + BM - 1) / BM), THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), off, static_cast<float*>(out), t,
      k, n, e);
  return cudaGetLastError();
}

cudaError_t launch_tgmm(const void* x, const void* dy, const int* off, void* dw, int t, int k,
                            int n, int e, cudaStream_t stream) {
  const size_t smem = (size_t)STAGES * (a_elems<true>() + b_elems<false>()) * 4;
  cudaError_t err = prepare(tgmm_fma_kernel, smem);
  if (err != cudaSuccess) return err;
  tgmm_fma_kernel<<<dim3((n + BN - 1) / BN, (k + BM - 1) / BM, e), THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), off, static_cast<float*>(dw), t,
      k, n);
  return cudaGetLastError();
}

}  // namespace f32

bool bad_shape(int t, int k, int n, int e) {
  return t < 0 || k <= 0 || n <= 0 || e <= 0 || e > MAX_GROUPS || k % 16 || n % 16 ||
         (t + BM - 1) / BM > 65535;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. off: int32 [e + 1] on the device. The
// bf16 kernels read x, w and dy through TMA: their base addresses must be
// 16-byte aligned (k and n multiples of 16 keep every row so). Each
// returns a cudaError_t value.
int ptt_gmm(const void* x, const void* w, const void* off, void* out, int t, int k, int n, int e,
            int dtype, int trans_w, void* stream) {
  if (bad_shape(t, k, n, e)) return (int)cudaErrorInvalidValue;
  if (t == 0) return 0;
  const int* o = static_cast<const int*>(off);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)f32::launch_gmm(x, w, o, out, t, k, n, e, trans_w != 0, s);
  if (dtype == 1) return (int)launch_gmm_bf16(x, w, o, out, t, k, n, e, trans_w != 0, s);
  return (int)cudaErrorInvalidValue;
}

int ptt_tgmm(const void* x, const void* dy, const void* off, void* dw, int t, int k, int n, int e,
             int dtype, void* stream) {
  if (bad_shape(t, k, n, e) || e > 65535) return (int)cudaErrorInvalidValue;
  const int* o = static_cast<const int*>(off);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)f32::launch_tgmm(x, dy, o, dw, t, k, n, e, s);
  if (dtype == 1) return (int)launch_tgmm_bf16(x, dy, o, dw, t, k, n, e, s);
  return (int)cudaErrorInvalidValue;
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
