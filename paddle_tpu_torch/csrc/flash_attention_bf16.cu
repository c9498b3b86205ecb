// Flash attention for training in bf16 on Hopper (sm_90a), forward and
// backward, dense and with FlashMask column bounds: TMA loads into a ring
// of shared-memory stages, one producer warp, two consumer warpgroups
// running wgmma.
//
// Replaces paddle_tpu/kernels/flash_pallas.py: _flash_forward (_fa_kernel)
// and _flash_backward (_fa_dq_kernel, _fa_dkv_kernel), each with and
// without `bounds`/`window` (flashmask_attention). Same function:
// q [bh, sq, D], k/v [bh, sk, D] bf16, D 64 or 128; s = (q k^T) * scale in
// fp32; causal is bottom-right aligned (query i sees keys <= i + sk - sq);
// the forward writes out (bf16) and lse [bh, sq] (fp32). A masked entry's
// p is 0 whatever the running max, so a row that sees no key (possible
// only with bounds or a window) gets output 0, lse -1e30 and dq 0. The
// backward is the FA2 split: the dq kernel sweeps the kv tiles of a q
// tile, the dk/dv kernel the q tiles of a kv tile; each recomputes
// p = exp(s - lse) and uses delta = rowsum(dO * O) (fp32; the dq kernel
// computes it). No atomics: every run gives the same result. Rounding as in
// the JAX kernels: P is cast to v's dtype before P.V; ds to k's dtype for
// dq; p to dO's dtype for dv and ds to q's dtype for dk. float32 inputs
// take flash_attention.cu's kernels.
//
// FlashMask (sq == sk): canonical bounds [b, hb, sk, 4] int32 (LTS, LTE,
// UTS, UTE) per key column, hb in {1, h}; the test is flash_common.cuh's
// Bands::visible. The pre-pass (flash_attention.cu) summarises the bounds
// over each 128-key tile, this file's key tile; from the summary, the
// window and the tile's rows the producer classes each (q tile, kv tile)
// once (Bands::kind): skip (provably all masked: neither loaded nor
// computed), full (provably all visible: no per-entry test) or partial
// (the test per entry, with the tile's bound columns loaded by TMA beside
// K). The kind and the tile index travel to the consumers in the stage's
// slot, so the consumers never read the summary.
//
// Bound on the H100: operations. At the training shape [8, 16, 2048, 128]
// causal a 128-row q tile does 4 * 128 * 128 * D flops per 128-key tile
// of K and V it reads (64 KB), ~256 flop/byte from device memory and more
// from L2: the tensor cores are the limit.
//
// Design against that bound:
//   * a block of 3 warpgroups: two consumers of 64 rows each (wgmma's
//     m64; rows are queries in the forward and dq, keys in dk/dv) and a
//     producer, of which one warp issues the loads and the rest exit;
//     setmaxnreg gives the producer 40 registers and each consumer 232;
//   * every tile is loaded by TMA as 64-column panels of 128 bytes a row,
//     swizzled 128B, which is the layout wgmma reads: K-major for the
//     first products (S = Q K^T, dP = dO V^T; in dk/dv S^T = K Q^T,
//     dP^T = V dO^T) and, with the transpose bit, MN-major for the second
//     (O += P V; dQ += dS K; dV += P^T dO, dK += dS^T Q). Rows past the
//     end are zero-filled by TMA and masked (or, for keys in dk/dv and
//     rows in dq, never stored);
//   * stages: STAGES ring slots, each with a full barrier (TMA bytes, and
//     in dk/dv the producer lanes' lse and delta) and an empty barrier
//     (one arrival per consumer warp); the forward frees a stage's K as
//     soon as the masking has read it and its V after P V, so the next K
//     loads meanwhile;
//   * the first product is an SS wgmma; the online softmax (forward) or
//     p and ds (backward) run in registers on its accumulator layout, with
//     ex2.approx.ftz and log2(e) folded into the scale; p and ds are
//     rounded to bf16 in registers and are the A operand of the second
//     product, an RS wgmma: no shared-memory round trip;
//   * the forward and dq blocks own 128 query rows and walk 128-key
//     tiles (dq in two halves of 64 keys, which keeps S, dP and dQ in
//     registers); the dk/dv block owns 128 keys (K and V loaded once) and
//     walks 64-row q tiles;
//   * causal: the forward and dq loops stop at the diagonal tile, the
//     dk/dv loop starts there, and only tiles that cross the diagonal or
//     the ragged end take the per-entry test; the blocks with the most
//     work are scheduled first;
//   * each wgmma batch is waited for before what it writes is used; the
//     two consumer warpgroups overlap one another's softmax and products
//     (issuing the next tile's S beside this tile's P V, and explicit
//     turns between the warpgroups, measured no faster on this card);
//   * the dq kernel computes delta = rowsum(dO * O) of its rows (each
//     quad of threads a row) and writes it for the dk/dv kernel, instead
//     of a separate pass over dO and O.
// lse and delta for dk/dv are read by the producer warp's lanes (a bulk
// copy would need 16-byte aligned rows, which an odd sq does not give).
//
// ptxas (CUDA 12.8, sm_90a): every kernel launches with 168 registers a
// thread (384 threads), spills nothing, and runs its consumers at 232
// after setmaxnreg. Dynamic shared memory (with 1 KB of alignment), D = 128
// / 64: forward 169,048 / 87,128 bytes (Q, two stages of K and V, bounds
// columns), dq 201,784 / 103,480 (Q and dO, two stages of K and V), dk/dv
// 133,176 / 67,640 (K and V, two stages of Q, dO, lse and delta): one
// block an SM.
//
// The TMA, mbarrier, wgmma and setmaxnreg helpers and the tensor maps are
// hopper_common.cuh's, shared with gmm.cu. Plain C interface, loaded with ctypes;
// launches go on the caller's stream and each function returns
// cudaGetLastError(), so a refused launch is reported to the caller.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;
using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int BM = 128;                         // query rows of a forward or dq block
constexpr int BN = TILE;                        // key rows of a tile: the summary's tile
constexpr int BQ = 64;                          // query rows of a dk/dv tile
constexpr int CONSUMERS = 2;                    // consumer warpgroups of 64 rows
constexpr int THREADS = 128 * (CONSUMERS + 1);  // and the producer warpgroup
constexpr int STAGES = 2;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 40 * 128 + 232 * 256 = 168 * 384, the launch's
constexpr int PANEL = 64;           // bf16 columns of a 128-byte swizzled panel
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// -- PTX ----------------------------------------------------------------------------

// A shared-memory address the compiler must take as new on every loop
// trip: descriptors derived from it are rebuilt where the wgmma needs them
// (an add each) instead of being kept in registers across the loop: the
// dq kernel's Q and dO descriptors, where it measured faster (variant
// no_opaque of paddle_tpu_torch/tools/flash_variants.py; the other
// kernels showed no difference).
__device__ __forceinline__ uint32_t opaque(uint32_t addr) {
  asm volatile("" : "+r"(addr));
  return addr;
}

// -- registers (the accumulator layout, to_a, quad_max, quad_sum: hopper_common.cuh) --

// A warpgroup's [64 x D] accumulator divided by div[row half], the rows
// below n_rows, to dst [n_rows, D]; row_lo is this thread's first row.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, int row_lo, int n_rows, const float (&c)[D / 2],
                                           const float (&div)[2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + (size_t)row * D + 8 * j + 2 * t) =
          pack_bf16(c[4 * j + 2 * r] / div[r], c[4 * j + 2 * r + 1] / div[r]);
  }
}

// Key tiles a block of query rows starting at q0 sees.
__device__ __forceinline__ int kv_tiles(int q0, int sq, int sk, int causal) {
  int n = (sk + BN - 1) / BN;
  if (causal) n = min(n, (min(q0 + BM, sq) - 1 + sk - sq) / BN + 1);
  return n;
}

// Kind of the tile of query rows [q0, q0 + rows) and keys [c0, c0 + BN).
template <bool MASKED>
__device__ __forceinline__ int tile_kind(const Bands& bands, int q0, int rows, int c0, int sq, int sk,
                                         int causal) {
  if constexpr (MASKED)
    return bands.kind(q0, min(q0 + rows, sq) - 1, c0, min(c0 + BN, sk) - 1,
                      q0 + rows <= sq && c0 + BN <= sk);
  return q0 + rows > sq || c0 + BN > sk || (causal && c0 + BN - 1 > q0 + sk - sq) ? PARTIAL : FULL;
}

// -- forward ------------------------------------------------------------------------

template <int D>
struct FwdSmem {
  static constexpr int TQ = BM * D * 2;  // bytes of the Q tile
  static constexpr int TK = BN * D * 2;  // bytes of a K or V tile
  static constexpr int Q = 0;
  static constexpr int K = Q + TQ;                // [STAGES]
  static constexpr int V = K + STAGES * TK;       // [STAGES]
  static constexpr int COLS = V + STAGES * TK;    // [STAGES][BN] int4: a partial tile's bounds
  static constexpr int SLOT = COLS + STAGES * BN * 16;  // [STAGES] int2: (tile, kind); tile -1 ends
  // q, k_full[STAGES], v_full[STAGES], k_empty[STAGES], v_empty[STAGES]
  static constexpr int BAR = SLOT + STAGES * 8;
  static constexpr int BYTES = BAR + (1 + 4 * STAGES) * 8;
};

// Grid (query blocks of BM rows, bh). A stage's K (with its bounds and
// slot) and its V are freed apart: K once the masking has read it, V after
// P V, so the next K loads while this tile's softmax and P V run.
template <int D, bool MASKED>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tb,
                       bf16* __restrict__ out, float* __restrict__ lse, int sq, int sk, int causal,
                       float scale, Mask mk) {
  using L = FwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const uint32_t base = smem_u32(sm);
  int2* slot = reinterpret_cast<int2*>(sm + L::SLOT);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;
  const int q0 = ((int)gridDim.x - 1 - (int)blockIdx.x) * BM;  // longest rows first
  const int bh = blockIdx.y;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 4 * CONSUMERS);
      mbar_init(&v_empty[s], 4 * CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const Bands bands(mk, bh, sk, causal);
  const int n_kv = kv_tiles(q0, sq, sk, causal);

  if (wg == CONSUMERS) {  // the producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != 128 * CONSUMERS) return;
    mbar_expect_tx(q_full, L::TQ);
#pragma unroll
    for (int p = 0; p < D / PANEL; ++p)
      tma_load(base + L::Q + p * BM * 128, &tq, q_full, p * PANEL, q0, bh);
    const int nk = (sk + BN - 1) / BN;
    int st = 0, ph = 0;
    for (int it = 0; it < n_kv; ++it) {
      const int c0 = it * BN;
      const int kind = tile_kind<MASKED>(bands, q0, BM, c0, sq, sk, causal);
      if (MASKED && mk.kinds != nullptr)  // what this loop decides, for checking
        mk.kinds[((size_t)bh * gridDim.x + q0 / BM) * nk + it] = (signed char)kind;
      if (kind == SKIP) continue;
      mbar_wait_guarded(&k_empty[st], ph ^ 1);
      slot[st] = make_int2(it, kind);
      const bool cols = MASKED && kind == PARTIAL;
      mbar_expect_tx(&k_full[st], L::TK + (cols ? BN * 16 : 0));
#pragma unroll
      for (int p = 0; p < D / PANEL; ++p)
        tma_load(base + L::K + st * L::TK + p * BN * 128, &tk, &k_full[st], p * PANEL, c0, bh);
      if (cols) tma_load(base + L::COLS + st * BN * 16, &tb, &k_full[st], 0, c0, bands.row);
      mbar_wait_guarded(&v_empty[st], ph ^ 1);
      mbar_expect_tx(&v_full[st], L::TK);
#pragma unroll
      for (int p = 0; p < D / PANEL; ++p)
        tma_load(base + L::V + st * L::TK + p * BN * 128, &tv, &v_full[st], p * PANEL, c0, bh);
      if (++st == STAGES) st = 0, ph ^= 1;
    }
    mbar_wait_guarded(&k_empty[st], ph ^ 1);
    slot[st] = make_int2(-1, 0);
    mbar_arrive(&k_full[st]);
  } else {  // a consumer: rows q0 + 64 wg .. + 63
    setmaxnreg_inc<CONSUMER_REGS>();
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x & 31;
    const int t = lane & 3;
    const int row_lo = q0 + 64 * wg + 16 * warp + (lane >> 2);  // this thread's rows: +0, +8
    const int offset = sk - sq;
    const float c = scale * LOG2E;
    const int4* cols = reinterpret_cast<const int4*>(sm + L::COLS);
    float o[D / 2];
    zero(o);
    float m[2] = {-INFINITY, -INFINITY};  // running max of s * scale * log2(e)
    float l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    int st = 0, ph = 0;
    for (;;) {
      mbar_wait(&k_full[st], ph);
      const int2 info = slot[st];
      if (info.x < 0) break;
      const uint32_t q_s = base + L::Q;
      const uint32_t k_s = base + L::K + st * L::TK;
      const uint32_t v_s = base + L::V + st * L::TK;
      float s[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BN>(s, kmajor(q_s, BM, 64 * wg, kk), kmajor(k_s, BN, 0, kk), kk);
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);

      const int kv0 = info.x * BN;
      const bool partial = info.y != FULL;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        float x = s[i] * c;
        if (partial) {
          const int key = kv0 + 8 * (i / 4) + 2 * t + (i & 1);
          const int row = row_lo + 8 * ((i >> 1) & 1);
          bool vis;
          if constexpr (MASKED)
            vis = key < sk && bands.visible(row, key, cols[st * BN + key - kv0]);
          else
            vis = key < sk && (!causal || key <= row + offset);
          if (!vis) x = -INFINITY;
        }
        s[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&k_empty[st]);  // K, its bounds and the slot are read
      float mu[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        mu[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // a row that has seen no key yet
        alpha[r] = m[r] == -INFINITY ? 0.f : exp2_ftz(m[r] - mx[r]);
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const float p = exp2_ftz(s[i] - mu[(i >> 1) & 1]);  // 0 where masked
        s[i] = p;
        sum[(i >> 1) & 1] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = alpha[r] * l[r] + quad_sum(sum[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      uint32_t pa[BN / 16][4];
      to_a<BN>(pa, s);  // P rounded to v's dtype

      mbar_wait(&v_full[st], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs<D>(o, pa[kk], mnmajor(v_s, BN, 16 * kk));
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&v_empty[st]);
      if (++st == STAGES) st = 0, ph ^= 1;
    }

    float div[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) div[r] = l[r] == 0.f ? 1.f : l[r];
    store_rows<D>(out + (size_t)bh * sq * D, row_lo, sq, o, div);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_lo + 8 * r;
        if (row < sq)
          lse[(size_t)bh * sq + row] = l[r] == 0.f ? NEG_INF : m[r] * LN2 + logf(div[r]);
      }
    }
  }
}

// -- backward: dq -------------------------------------------------------------------

template <int D>
struct DqSmem {
  static constexpr int TQ = BM * D * 2;
  static constexpr int TK = BN * D * 2;
  static constexpr int Q = 0;
  static constexpr int DO = Q + TQ;
  static constexpr int K = DO + TQ;              // [STAGES]
  static constexpr int V = K + STAGES * TK;      // [STAGES]
  static constexpr int COLS = V + STAGES * TK;   // [STAGES][BN] int4
  static constexpr int SLOT = COLS + STAGES * BN * 16;
  static constexpr int BAR = SLOT + STAGES * 8;  // q (Q and dO), kv[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR + (1 + 2 * STAGES) * 8;
};

// Grid (query blocks of BM rows, bh). Each kv tile is taken in two halves
// of 64 keys: S and dP for a half, then dQ += dS K_half.
template <int D, bool MASKED>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tb, const bf16* __restrict__ out,
                          const bf16* __restrict__ dout, const float* __restrict__ lse,
                          float* __restrict__ delta, bf16* __restrict__ dq, int sq, int sk,
                          int causal, float scale, Mask mk) {
  using L = DqSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const uint32_t base = smem_u32(sm);
  int2* slot = reinterpret_cast<int2*>(sm + L::SLOT);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* kv_full = q_full + 1;
  uint64_t* empty = kv_full + STAGES;
  const int q0 = ((int)gridDim.x - 1 - (int)blockIdx.x) * BM;
  const int bh = blockIdx.y;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&empty[s], 4 * CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const Bands bands(mk, bh, sk, causal);
  const int n_kv = kv_tiles(q0, sq, sk, causal);

  if (wg == CONSUMERS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != 128 * CONSUMERS) return;
    mbar_expect_tx(q_full, 2 * L::TQ);
#pragma unroll
    for (int p = 0; p < D / PANEL; ++p) {
      tma_load(base + L::Q + p * BM * 128, &tq, q_full, p * PANEL, q0, bh);
      tma_load(base + L::DO + p * BM * 128, &tdo, q_full, p * PANEL, q0, bh);
    }
    int st = 0, ph = 0;
    for (int it = 0; it < n_kv; ++it) {
      const int c0 = it * BN;
      const int kind = tile_kind<MASKED>(bands, q0, BM, c0, sq, sk, causal);
      if (kind == SKIP) continue;
      mbar_wait_guarded(&empty[st], ph ^ 1);
      slot[st] = make_int2(it, kind);
      const bool cols = MASKED && kind == PARTIAL;
      mbar_expect_tx(&kv_full[st], 2 * L::TK + (cols ? BN * 16 : 0));
#pragma unroll
      for (int p = 0; p < D / PANEL; ++p) {
        tma_load(base + L::K + st * L::TK + p * BN * 128, &tk, &kv_full[st], p * PANEL, c0, bh);
        tma_load(base + L::V + st * L::TK + p * BN * 128, &tv, &kv_full[st], p * PANEL, c0, bh);
      }
      if (cols) tma_load(base + L::COLS + st * BN * 16, &tb, &kv_full[st], 0, c0, bands.row);
      if (++st == STAGES) st = 0, ph ^= 1;
    }
    mbar_wait_guarded(&empty[st], ph ^ 1);
    slot[st] = make_int2(-1, 0);
    mbar_arrive(&kv_full[st]);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x & 31;
    const int t = lane & 3;
    const int row_lo = q0 + 64 * wg + 16 * warp + (lane >> 2);
    const int offset = sk - sq;
    const float c = scale * LOG2E;
    const int4* cols = reinterpret_cast<const int4*>(sm + L::COLS);
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 8 * r;
      lse2[r] = row < sq ? lse[(size_t)bh * sq + row] * LOG2E : 0.f;
      dl[r] = row_delta<bf16, D>(out + (size_t)bh * sq * D, dout + (size_t)bh * sq * D, row, sq, t);
      if (t == 0 && row < sq) delta[(size_t)bh * sq + row] = dl[r];  // for the dk/dv kernel
    }
    float acc[D / 2];
    zero(acc);
    mbar_wait(q_full, 0);
    int st = 0, ph = 0;
    for (;;) {
      mbar_wait(&kv_full[st], ph);
      const int2 info = slot[st];
      if (info.x < 0) break;
      const uint32_t k_s = base + L::K + st * L::TK;
      const uint32_t v_s = base + L::V + st * L::TK;
      const bool partial = info.y != FULL;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t q_s = opaque(base + L::Q);
        const uint32_t do_s = opaque(base + L::DO);
        float s[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<64>(s, kmajor(q_s, BM, 64 * wg, kk), kmajor(k_s, BN, 64 * h, kk), kk);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<64>(dp, kmajor(do_s, BM, 64 * wg, kk), kmajor(v_s, BN, 64 * h, kk), kk);
        wgmma_commit();
        wgmma_wait();
        fence_regs(s);
        fence_regs(dp);
        const int kv0 = info.x * BN + 64 * h;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          bool vis = true;
          if (partial) {
            const int key = kv0 + 8 * (i / 4) + 2 * t + (i & 1);
            const int row = row_lo + 8 * r;
            if constexpr (MASKED)
              vis = key < sk && bands.visible(row, key, cols[st * BN + key - info.x * BN]);
            else
              vis = key < sk && (!causal || key <= row + offset);
          }
          const float p = vis ? exp2_ftz(s[i] * c - lse2[r]) : 0.f;
          s[i] = p * (dp[i] - dl[r]) * scale;
        }
        uint32_t da[4][4];
        to_a<64>(da, s);  // ds rounded to k's dtype
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(acc, da[kk], mnmajor(k_s, BN, 64 * h + 16 * kk));
        wgmma_commit();
        wgmma_wait();
        fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      if (++st == STAGES) st = 0, ph ^= 1;
    }
    const float one[2] = {1.f, 1.f};
    store_rows<D>(dq + (size_t)bh * sq * D, row_lo, sq, acc, one);
  }
}

// -- backward: dk and dv -------------------------------------------------------------

template <int D>
struct DkvSmem {
  static constexpr int TK = BN * D * 2;
  static constexpr int TQ = BQ * D * 2;
  static constexpr int K = 0;
  static constexpr int V = K + TK;
  static constexpr int Q = V + TK;                // [STAGES]
  static constexpr int DO = Q + STAGES * TQ;      // [STAGES]
  static constexpr int STATS = DO + STAGES * TQ;  // [STAGES][2][BQ] fp32: lse * log2(e), delta
  static constexpr int SLOT = STATS + STAGES * 2 * BQ * 4;
  static constexpr int BAR = SLOT + STAGES * 8;   // kv, full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR + (1 + 2 * STAGES) * 8;
};

// Grid (key blocks of BN keys, bh); each consumer warpgroup owns 64 keys
// and works on the transposed tiles s^T = k q^T and dp^T = v dO^T. Masked,
// each thread keeps the bounds of its two keys in registers.
template <int D, bool MASKED>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk, int causal,
                           float scale, Mask mk) {
  using L = DkvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const uint32_t base = smem_u32(sm);
  int2* slot = reinterpret_cast<int2*>(sm + L::SLOT);
  float* stats = reinterpret_cast<float*>(sm + L::STATS);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  const int k0 = blockIdx.x * BN;  // the first keys see the most rows: first
  const int bh = blockIdx.y;
  const int wg = threadIdx.x / 128;
  const int offset = sk - sq;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes, lane 0 with the TMA bytes
      mbar_init(&empty[s], 4 * CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const Bands bands(mk, bh, sk, causal);

  if (wg == CONSUMERS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x >= 128 * CONSUMERS + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * L::TK);
#pragma unroll
      for (int p = 0; p < D / PANEL; ++p) {
        tma_load(base + L::K + p * BN * 128, &tk, kv_full, p * PANEL, k0, bh);
        tma_load(base + L::V + p * BN * 128, &tv, kv_full, p * PANEL, k0, bh);
      }
    }
    const float* lg = lse + (size_t)bh * sq;
    const float* dg = delta + (size_t)bh * sq;
    const int n_qt = (sq + BQ - 1) / BQ;
    int st = 0, ph = 0;
    for (int it = causal ? max(0, k0 - offset) / BQ : 0; it < n_qt; ++it) {
      const int q0 = it * BQ;
      const int kind = tile_kind<MASKED>(bands, q0, BQ, k0, sq, sk, causal);
      if (kind == SKIP) continue;
      mbar_wait_guarded(&empty[st], ph ^ 1);
      float* sb = stats + st * 2 * BQ;
#pragma unroll
      for (int i = lane; i < BQ; i += 32) {
        const int row = q0 + i;
        sb[i] = row < sq ? lg[row] * LOG2E : 0.f;
        sb[BQ + i] = row < sq ? dg[row] : 0.f;
      }
      if (lane == 0) {
        slot[st] = make_int2(it, kind);
        mbar_expect_tx(&full[st], 2 * L::TQ);
#pragma unroll
        for (int p = 0; p < D / PANEL; ++p) {
          tma_load(base + L::Q + st * L::TQ + p * BQ * 128, &tq, &full[st], p * PANEL, q0, bh);
          tma_load(base + L::DO + st * L::TQ + p * BQ * 128, &tdo, &full[st], p * PANEL, q0, bh);
        }
      } else {
        mbar_arrive(&full[st]);
      }
      if (++st == STAGES) st = 0, ph ^= 1;
    }
    mbar_wait_guarded(&empty[st], ph ^ 1);
    if (lane == 0) slot[st] = make_int2(-1, 0);
    mbar_arrive(&full[st]);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x & 31;
    const int t = lane & 3;
    const int key_lo = k0 + 64 * wg + 16 * warp + (lane >> 2);  // this thread's keys: +0, +8
    const float c = scale * LOG2E;
    int4 key_b[2] = {};
    if constexpr (MASKED) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (key_lo + 8 * r < sk) key_b[r] = __ldg(bands.cols + key_lo + 8 * r);
    }
    float dk_acc[D / 2], dv_acc[D / 2];
    zero(dk_acc);
    zero(dv_acc);
    const uint32_t k_s = base + L::K;
    const uint32_t v_s = base + L::V;
    mbar_wait(kv_full, 0);
    int st = 0, ph = 0;
    for (;;) {
      mbar_wait(&full[st], ph);
      const int2 info = slot[st];
      if (info.x < 0) break;
      const uint32_t q_s = base + L::Q + st * L::TQ;
      const uint32_t do_s = base + L::DO + st * L::TQ;
      const float* sb = stats + st * 2 * BQ;
      float s[BQ / 2], dp[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ>(s, kmajor(k_s, BN, 64 * wg, kk), kmajor(q_s, BQ, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ>(dp, kmajor(v_s, BN, 64 * wg, kk), kmajor(do_s, BQ, 0, kk), kk);
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      fence_regs(dp);
      const int q0 = info.x * BQ;
      const bool partial = info.y != FULL;
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int col = 8 * (i / 4) + 2 * t + (i & 1);  // query row within the tile
        bool vis = true;
        if (partial) {
          const int row = q0 + col;
          const int key = key_lo + 8 * ((i >> 1) & 1);
          if constexpr (MASKED)
            vis = row < sq && bands.visible(row, key, key_b[(i >> 1) & 1]);
          else
            vis = row < sq && (!causal || key <= row + offset);
        }
        const float p = vis ? exp2_ftz(s[i] * c - sb[col]) : 0.f;
        dp[i] = p * (dp[i] - sb[BQ + col]) * scale;
        s[i] = p;
      }
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
      to_a<BQ>(pa, s);   // p^T rounded to dO's dtype
      to_a<BQ>(da, dp);  // ds^T rounded to q's dtype
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<D>(dv_acc, pa[kk], mnmajor(do_s, BQ, 16 * kk));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<D>(dk_acc, da[kk], mnmajor(q_s, BQ, 16 * kk));
      wgmma_commit();
      wgmma_wait();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      if (++st == STAGES) st = 0, ph ^= 1;
    }
    const float one[2] = {1.f, 1.f};
    store_rows<D>(dk + (size_t)bh * sk * D, key_lo, sk, dk_acc, one);
    store_rows<D>(dv + (size_t)bh * sk * D, key_lo, sk, dv_acc, one);
  }
}

// -- launches -----------------------------------------------------------------------

// A [bh, s, D] bf16 tensor's map in boxes of `rows` rows and one panel.
bool panel_map(CUtensorMap* map, const void* ptr, int d, int s, int bh, int rows) {
  return tensor_map(map, ptr, true, d, s, bh, PANEL, rows);
}

// The bounds [b * hb, sk, 4] in boxes of one key tile.
bool bounds_map(CUtensorMap* map, const Args& a) {
  return tensor_map(map, a.mk.bounds, false, 4, a.sk, a.bh / a.mk.h * a.mk.hb, 4, BN);
}

template <int D, bool MASKED>
cudaError_t launch_fwd(const Args& a) {
  CUtensorMap tq{}, tk{}, tv{}, tb{};
  if (!panel_map(&tq, a.q, D, a.sq, a.bh, BM) || !panel_map(&tk, a.k, D, a.sk, a.bh, BN) ||
      !panel_map(&tv, a.v, D, a.sk, a.bh, BN) || (MASKED && !bounds_map(&tb, a)))
    return cudaErrorInvalidValue;
  const size_t smem = FwdSmem<D>::BYTES + 1024;  // and the alignment to 1024 bytes
  auto kernel = flash_fwd_wgmma_kernel<D, MASKED>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.sq + BM - 1) / BM, a.bh), THREADS, smem, a.stream>>>(
      tq, tk, tv, tb, static_cast<bf16*>(a.out), static_cast<float*>(a.out2), a.sq, a.sk, a.causal,
      a.scale, a.mk);
  return cudaGetLastError();
}

template <int D, bool MASKED>
cudaError_t launch_dq(const Args& a) {
  CUtensorMap tq{}, tk{}, tv{}, tdo{}, tb{};
  if (!panel_map(&tq, a.q, D, a.sq, a.bh, BM) || !panel_map(&tk, a.k, D, a.sk, a.bh, BN) ||
      !panel_map(&tv, a.v, D, a.sk, a.bh, BN) || !panel_map(&tdo, a.dout, D, a.sq, a.bh, BM) ||
      (MASKED && !bounds_map(&tb, a)))
    return cudaErrorInvalidValue;
  const size_t smem = DqSmem<D>::BYTES + 1024;
  auto kernel = flash_bwd_dq_wgmma_kernel<D, MASKED>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.sq + BM - 1) / BM, a.bh), THREADS, smem, a.stream>>>(
      tq, tk, tv, tdo, tb, static_cast<const bf16*>(a.fwd_out), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<float*>(const_cast<void*>(a.delta)),
      static_cast<bf16*>(a.out), a.sq, a.sk, a.causal, a.scale, a.mk);
  return cudaGetLastError();
}

template <int D, bool MASKED>
cudaError_t launch_dkv(const Args& a) {
  CUtensorMap tq{}, tk{}, tv{}, tdo{};
  if (!panel_map(&tq, a.q, D, a.sq, a.bh, BQ) || !panel_map(&tk, a.k, D, a.sk, a.bh, BN) ||
      !panel_map(&tv, a.v, D, a.sk, a.bh, BN) || !panel_map(&tdo, a.dout, D, a.sq, a.bh, BQ))
    return cudaErrorInvalidValue;
  const size_t smem = DkvSmem<D>::BYTES + 1024;
  auto kernel = flash_bwd_dkv_wgmma_kernel<D, MASKED>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.sk + BN - 1) / BN, a.bh), THREADS, smem, a.stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.out), static_cast<bf16*>(a.out2), a.sq, a.sk, a.causal, a.scale, a.mk);
  return cudaGetLastError();
}

// which: 0 forward, 1 dq, 2 dk/dv.
template <int D, bool MASKED>
cudaError_t by_kind(int which, const Args& a) {
  if (which == 0) return launch_fwd<D, MASKED>(a);
  if (which == 1) return launch_dq<D, MASKED>(a);
  return launch_dkv<D, MASKED>(a);
}

template <int D>
cudaError_t by_mask(int which, const Args& a) {
  return a.mk.bounds != nullptr ? by_kind<D, true>(which, a) : by_kind<D, false>(which, a);
}

int dispatch(int which, int d, int dtype, const Args& a) {
  cudaError_t err = check_args(a);
  if (err != cudaSuccess || a.bh == 0 || a.sq == 0) return (int)err;
  if (dtype != 1) return (int)cudaErrorInvalidValue;  // float32: flash_attention.cu
  err = cudaErrorInvalidValue;
  if (d == 64) err = by_mask<64>(which, a);
  if (d == 128) err = by_mask<128>(which, a);
  return (int)err;
}

}  // namespace

extern "C" {

// The entry points of flash_attention.cu, for dtype 1 (bfloat16); d: 64
// or 128. Each returns a cudaError_t value. The dq kernel writes delta =
// rowsum(dout * out) [bh, sq] fp32, which the dk/dv kernel then reads, so
// dq runs first on the stream. FlashMask: bounds [b, hb, sk,
// 4] int32, 16-byte aligned, and summary [b, hb, ceil(sk / 128), 8] int32
// (from ptt_flashmask_summary); h: query heads (bh = b * h); hb: 1 or h;
// wl, wr: the window (2^30 for none). bounds == nullptr runs the dense
// kernel (summary, h, hb, wl, wr unused). kinds (forward, may be nullptr):
// int8 [bh, ceil(sq / 128), ceil(sk / 128)], where the masked forward
// writes the kind (0 skip, 1 partial, 2 full) of every tile its loop
// ranges over.
int ptt_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                  const void* bounds, const void* summary, void* kinds, int bh, int sq, int sk,
                  int d, int dtype, int causal, float scale, int h, int hb, int wl, int wr,
                  void* stream) {
  const Args a{q, k, v, nullptr, nullptr, nullptr, out, lse, bh, sq, sk, causal, scale,
               static_cast<cudaStream_t>(stream), mask_of(bounds, summary, kinds, h, hb, wl, wr)};
  return dispatch(0, d, dtype, a);
}

int ptt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* out, const void* lse, void* delta, void* dq, const void* bounds,
                     const void* summary, int bh, int sq, int sk, int d, int dtype, int causal,
                     float scale, int h, int hb, int wl, int wr, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, bh, sq, sk, causal, scale,
               static_cast<cudaStream_t>(stream), mask_of(bounds, summary, nullptr, h, hb, wl, wr),
               out};
  return dispatch(1, d, dtype, a);
}

int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dk, void* dv, const void* bounds,
                      const void* summary, int bh, int sq, int sk, int d, int dtype, int causal,
                      float scale, int h, int hb, int wl, int wr, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, causal, scale,
               static_cast<cudaStream_t>(stream), mask_of(bounds, summary, nullptr, h, hb, wl, wr)};
  return dispatch(2, d, dtype, a);
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
