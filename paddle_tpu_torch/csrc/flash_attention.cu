// Flash attention for training in float32, forward and backward, dense
// and with FlashMask column bounds; and the bounds' tile-summary pre-pass.
//
// Replaces paddle_tpu/kernels/flash_pallas.py: _flash_forward (_fa_kernel)
// and _flash_backward (_fa_dq_kernel, _fa_dkv_kernel), each with and
// without `bounds`/`window` (flashmask_attention), for float32 inputs; the
// bf16 kernels, which the training paths run, are flash_attention_bf16.cu,
// and its note gives the function, the rounding and the FlashMask test
// that both files share (flash_common.cuh). The float32 kernels serve the
// tiny float32 checks against the CPU.
//
// Design: one block of 4 warps per (64-row tile, batch*head), each warp
// owning 16 rows; K/V (or Q/dO) tiles of 64 rows in shared memory,
// double-buffered with cp.async; products by fp32 FMA in the mma.sync
// accumulator layout; online softmax in registers, a row's running max and
// sum in the 4 threads that hold it. Causal: the kv loop stops at the
// diagonal tile (the dk/dv loop starts there) and only tiles that cross
// the diagonal or the ragged end are masked. FlashMask: each (q tile, kv
// tile) is skip, full or partial from the summary of the 128-key tile
// that holds it (Bands::kind), and the loops prefetch the next tile that
// is not skipped. P (and ds) go through a small per-warp shared buffer.
// The FA2 backward split, no atomics: every run gives the same result;
// the dq kernel also computes delta = rowsum(dO * O) for the dk/dv one.
//
// The pre-pass (flashmask_summary_kernel, for both files' kernels): one
// warp per (row of bounds, 128-key tile), its lanes on neighbouring
// columns, writes the min and max of each bound over the tile's columns
// below sk (one thread a tile, walking 128 columns 2 KB from its
// neighbour's, ran [8, 1, 2048, 4] as 128 threads on one SM with no load
// coalesced).
//
// Plain C interface, loaded with ctypes. Launches go on the caller's
// stream; each function returns cudaGetLastError() so a refused launch is
// reported to the caller.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace flash;
using T = float;

constexpr int BM = 64;  // query rows of a tile
constexpr int BN = 64;  // key rows of a tile
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;

// Row padding in elements (16 bytes): keeps rows 16-byte aligned for
// cp.async and spreads a warp's fragment loads over the banks.
constexpr int PAD = 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// Rows [r0, r0 + ROWS) of a [n_rows, D] matrix into shared memory (row
// stride D + pad); rows at or past n_rows are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0, int n_rows) {
  constexpr int LD = D + PAD;
  constexpr int VE = 4;  // floats in 16 bytes
  constexpr int PER_ROW = D / VE;
  for (int c = threadIdx.x; c < ROWS * PER_ROW; c += THREADS) {
    const int r = c / PER_ROW;
    const int e = (c - r * PER_ROW) * VE;
    const int row = r0 + r;
    const bool ok = row < n_rows;
    cp_async16(dst + r * LD + e, src + (size_t)(ok ? row : 0) * D + e, ok);
  }
}

// One warp: C[16 x 8*NT] += A[16 x K] * B[K x 8*NT], all in shared memory.
// A is row-major (stride lda). B(k, n) = B[n * ldb + k] when NMAJOR (K of a
// q.k^T product), else B[k * ldb + n] (V of a p.V product). C is held in the
// mma.sync accumulator layout: lane = 4 * g + t holds c[j][0..1] at row g,
// columns 8j + 2t + {0, 1}, and c[j][2..3] at row g + 8, the same columns.
template <bool NMAJOR, int NT, int K>
__device__ __forceinline__ void warp_gemm(float (&c)[NT][4], const T* A, int lda, const T* B,
                                          int ldb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float a0 = A[g * lda + k];
    const float a1 = A[(g + 8) * lda + k];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = 8 * j + 2 * t;
      const float b0 = NMAJOR ? B[n * ldb + k] : B[k * ldb + n];
      const float b1 = NMAJOR ? B[(n + 1) * ldb + k] : B[k * ldb + n + 1];
      c[j][0] = fmaf(a0, b0, c[j][0]);
      c[j][1] = fmaf(a0, b1, c[j][1]);
      c[j][2] = fmaf(a1, b0, c[j][2]);
      c[j][3] = fmaf(a1, b1, c[j][3]);
    }
  }
}

// Two neighbouring values of a row, rounded to T, to shared or device memory.
__device__ __forceinline__ void store_pair(T* p, float x, float y) {
  p[0] = x;
  p[1] = y;
}

// A warp's [16 x 8*NT] accumulator, rounded to T, into a buffer of stride ld.
template <int NT>
__device__ __forceinline__ void store_frag(T* dst, int ld, const float (&c)[NT][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    store_pair(dst + g * ld + 8 * j + 2 * t, c[j][0], c[j][1]);
    store_pair(dst + (g + 8) * ld + 8 * j + 2 * t, c[j][2], c[j][3]);
  }
}

// The rows of a warp's accumulator that lie below n_rows, to device memory
// (row stride D); row0 is the device row of the warp's first row.
template <int D>
__device__ __forceinline__ void store_rows(T* dst, int row0, int n_rows, const float (&c)[D / 8][4],
                                           const float (&div)[2]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store_pair(dst + (size_t)row * D + 8 * j + 2 * t, c[j][2 * r] / div[r],
                 c[j][2 * r + 1] / div[r]);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int NT, int D>
__device__ __forceinline__ void zero(float (&c)[NT][D]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < D; ++e) c[j][e] = 0.f;
}

// Key tiles a query tile starting at q0 sees.
__device__ __forceinline__ int kv_tiles(int q0, int sq, int sk, int causal) {
  int n = (sk + BN - 1) / BN;
  if (causal) n = min(n, (min(q0 + BM, sq) - 1 + sk - sq) / BN + 1);
  return n;
}

// The bounds of keys [c0, c0 + BN) into shared memory (zeros past sk).
__device__ __forceinline__ void load_cols(int4* dst, const int4* src, int c0, int sk) {
  for (int c = threadIdx.x; c < BN; c += THREADS) {
    const int col = c0 + c;
    const bool ok = col < sk;
    cp_async16(dst + c, src + (ok ? col : 0), ok);
  }
}

// One warp per (row of bounds, summary tile of TILE keys): the min and max
// of each bound over the tile's columns below sk. The lanes read
// neighbouring columns (16 bytes each, so a warp's load is 512 contiguous
// bytes), TILE / 32 columns a lane, then a shuffle tree takes the min and
// max across the warp. min and max are exact, so the result is the plain
// version's bit for bit in any order.
constexpr int SUMMARY_WARPS = 4;  // tiles a block: [8, 1, 2048, 4] spreads over 32 SMs

__global__ void __launch_bounds__(32 * SUMMARY_WARPS)
flashmask_summary_kernel(const int4* __restrict__ bounds, int4* __restrict__ summary, int n_tiles,
                         int nk, int sk) {
  const int tile = blockIdx.x * SUMMARY_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (tile >= n_tiles) return;
  const int4* col = bounds + (size_t)(tile / nk) * sk;
  const int c0 = (tile % nk) * TILE;
  const int c1 = min(c0 + TILE, sk);
  int4 lo = make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX);
  int4 hi = make_int4(INT_MIN, INT_MIN, INT_MIN, INT_MIN);
#pragma unroll
  for (int j = c0 + lane; j < c0 + TILE; j += 32) {
    if (j >= c1) break;
    const int4 b = __ldg(col + j);
    lo = make_int4(min(lo.x, b.x), min(lo.y, b.y), min(lo.z, b.z), min(lo.w, b.w));
    hi = make_int4(max(hi.x, b.x), max(hi.y, b.y), max(hi.z, b.z), max(hi.w, b.w));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo.x = min(lo.x, __shfl_xor_sync(0xffffffffu, lo.x, o));
    lo.y = min(lo.y, __shfl_xor_sync(0xffffffffu, lo.y, o));
    lo.z = min(lo.z, __shfl_xor_sync(0xffffffffu, lo.z, o));
    lo.w = min(lo.w, __shfl_xor_sync(0xffffffffu, lo.w, o));
    hi.x = max(hi.x, __shfl_xor_sync(0xffffffffu, hi.x, o));
    hi.y = max(hi.y, __shfl_xor_sync(0xffffffffu, hi.y, o));
    hi.z = max(hi.z, __shfl_xor_sync(0xffffffffu, hi.z, o));
    hi.w = max(hi.w, __shfl_xor_sync(0xffffffffu, hi.w, o));
  }
  if (lane == 0) summary[2 * (size_t)tile] = make_int4(lo.x, hi.x, lo.y, hi.y);
  if (lane == 1) summary[2 * (size_t)tile + 1] = make_int4(lo.z, hi.z, lo.w, hi.w);
}

// -- forward --------------------------------------------------------------------

// Grid (query tiles, bh). Shared memory: Q [BM][LD], two buffers of K and V
// [BN][LD] each, per warp a [16][BN + pad] buffer for P and, masked, two
// buffers of the key tile's bounds [BN] int4.
template <int D, bool MASKED>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int sq, int sk, int causal,
                 float scale, Mask mk) {
  constexpr int LD = D + PAD;
  constexpr int LDP = BN + PAD;
  const int q0 = ((int)gridDim.x - 1 - (int)blockIdx.x) * BM;  // longest rows first
  const size_t bh = blockIdx.y;
  const int offset = sk - sq;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* kv_s = q_s + BM * LD;
  T* p_s = kv_s + 4 * BN * LD + warp * 16 * LDP;
  int4* cols_s = reinterpret_cast<int4*>(kv_s + 4 * BN * LD + WARPS * 16 * LDP);  // [2][BN]
  const T* kg = k + bh * sk * D;
  const T* vg = v + bh * sk * D;
  const Bands bands(mk, bh, sk, causal);

  const int n_kv = kv_tiles(q0, sq, sk, causal);
  auto kind = [&](int it) -> int {
    const int c0 = it * BN;
    if constexpr (MASKED)
      return bands.kind(q0, min(q0 + BM, sq) - 1, c0, min(c0 + BN, sk) - 1,
                        q0 + BM <= sq && c0 + BN <= sk);
    return c0 + BN > sk || (causal && c0 + BN - 1 > q0 + offset) ? PARTIAL : FULL;
  };
  auto next = [&](int it) {  // the first tile from it on that is not skipped
    if constexpr (MASKED)
      while (it < n_kv && kind(it) == SKIP) ++it;
    return it;
  };
  auto stage = [&](int it, int buf) {
    T* nb = kv_s + buf * 2 * BN * LD;
    load_tile<D, BN>(nb, kg, it * BN, sk);
    load_tile<D, BN>(nb + BN * LD, vg, it * BN, sk);
    if constexpr (MASKED) load_cols(cols_s + buf * BN, bands.cols, it * BN, sk);
  };

  if constexpr (MASKED) {
    if (mk.kinds != nullptr && threadIdx.x == 0) {  // what the loop below decides, for checking
      const int nk = (sk + BN - 1) / BN;
      signed char* row = mk.kinds + (bh * gridDim.x + q0 / BM) * nk;
      for (int i = 0; i < n_kv; ++i) row[i] = (signed char)kind(i);
    }
  }
  int it = next(0);
  load_tile<D, BM>(q_s, q + bh * sq * D, q0, sq);
  if (it < n_kv) stage(it, 0);
  cp_async_commit();

  float o[D / 8][4];
  zero(o);
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  for (int buf = 0; it < n_kv; buf ^= 1) {
    const int nx = next(it + 1);
    if (nx < n_kv) stage(nx, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prev();  // this tile has landed
    __syncthreads();
    const T* kb = kv_s + buf * 2 * BN * LD;
    const T* vb = kb + BN * LD;

    float s[BN / 8][4];
    zero(s);
    warp_gemm<true, BN / 8, D>(s, q_s + warp * 16 * LD, LD, kb, LD);
    const int kv0 = it * BN;
    const bool mask = kind(it) != FULL;
    uint32_t vis_bits = ~0u;  // masked: bit 4j + e of a visible entry
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (mask) {
          const int key = kv0 + 8 * j + 2 * t + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          bool vis;
          if constexpr (MASKED)
            vis = key < sk && bands.visible(row, key, cols_s[buf * BN + key - kv0]);
          else
            vis = key < sk && (!causal || key <= row + offset);
          if (!vis) {
            x = NEG_INF;
            vis_bits &= ~(1u << (4 * j + e));
          }
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] = quad_max(mx[r]);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(s[j][e] - mx[e >> 1]);
        // a row that has seen no key yet has max -1e30, where exp(0) = 1
        if (MASKED && !((vis_bits >> (4 * j + e)) & 1u)) p = 0.f;
        s[j][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = expf(m_r[r] - mx[r]);
      l_r[r] = alpha[r] * l_r[r] + quad_sum(sum[r]);
      m_r[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
    store_frag<BN / 8>(p_s, LDP, s);  // P rounded to v's dtype
    __syncwarp();
    warp_gemm<false, D / 8, BN>(o, p_s, LDP, vb, LD);
    __syncthreads();  // the tile buffer and P are written again next round
    it = nx;
  }
  cp_async_wait_all();  // a block that skipped every tile still has Q in flight

  float div[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) div[r] = l_r[r] == 0.f ? 1.f : l_r[r];
  store_rows<D>(out + bh * sq * D, q0 + warp * 16, sq, o, div);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < sq)
        lse[bh * sq + row] = l_r[r] == 0.f ? NEG_INF : m_r[r] + logf(div[r]);
    }
  }
}

// -- backward: dq ---------------------------------------------------------------

// Grid (query tiles, bh). Shared memory: Q and dO [BM][LD], two buffers of
// K and V [BN][LD], per warp a [16][BN + pad] buffer for ds and, masked,
// two buffers of the key tile's bounds [BN] int4.
template <int D, bool MASKED>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const T* __restrict__ out,
                    const float* __restrict__ lse, float* __restrict__ delta, T* __restrict__ dq,
                    int sq, int sk, int causal, float scale, Mask mk) {
  constexpr int LD = D + PAD;
  constexpr int LDP = BN + PAD;
  const int q0 = ((int)gridDim.x - 1 - (int)blockIdx.x) * BM;
  const size_t bh = blockIdx.y;
  const int offset = sk - sq;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* do_s = q_s + BM * LD;
  T* kv_s = do_s + BM * LD;
  T* ds_s = kv_s + 4 * BN * LD + warp * 16 * LDP;
  int4* cols_s = reinterpret_cast<int4*>(kv_s + 4 * BN * LD + WARPS * 16 * LDP);  // [2][BN]
  const T* kg = k + bh * sk * D;
  const T* vg = v + bh * sk * D;
  const Bands bands(mk, bh, sk, causal);

  const int n_kv = kv_tiles(q0, sq, sk, causal);
  auto kind = [&](int it) -> int {
    const int c0 = it * BN;
    if constexpr (MASKED)
      return bands.kind(q0, min(q0 + BM, sq) - 1, c0, min(c0 + BN, sk) - 1,
                        q0 + BM <= sq && c0 + BN <= sk);
    return c0 + BN > sk || (causal && c0 + BN - 1 > q0 + offset) ? PARTIAL : FULL;
  };
  auto next = [&](int it) {
    if constexpr (MASKED)
      while (it < n_kv && kind(it) == SKIP) ++it;
    return it;
  };
  auto stage = [&](int it, int buf) {
    T* nb = kv_s + buf * 2 * BN * LD;
    load_tile<D, BN>(nb, kg, it * BN, sk);
    load_tile<D, BN>(nb + BN * LD, vg, it * BN, sk);
    if constexpr (MASKED) load_cols(cols_s + buf * BN, bands.cols, it * BN, sk);
  };

  int it = next(0);
  load_tile<D, BM>(q_s, q + bh * sq * D, q0, sq);
  load_tile<D, BM>(do_s, dout + bh * sq * D, q0, sq);
  if (it < n_kv) stage(it, 0);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse_r[r] = row < sq ? lse[bh * sq + row] : 0.f;
    delta_r[r] = row_delta<T, D>(out + bh * sq * D, dout + bh * sq * D, row, sq, t);
    if (t == 0 && row < sq) delta[bh * sq + row] = delta_r[r];  // for the dk/dv kernel
  }
  float acc[D / 8][4];
  zero(acc);

  for (int buf = 0; it < n_kv; buf ^= 1) {
    const int nx = next(it + 1);
    if (nx < n_kv) stage(nx, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const T* kb = kv_s + buf * 2 * BN * LD;
    const T* vb = kb + BN * LD;

    float s[BN / 8][4], dp[BN / 8][4];
    zero(s);
    zero(dp);
    warp_gemm<true, BN / 8, D>(s, q_s + warp * 16 * LD, LD, kb, LD);
    warp_gemm<true, BN / 8, D>(dp, do_s + warp * 16 * LD, LD, vb, LD);
    const int kv0 = it * BN;
    const bool mask = kind(it) != FULL;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool vis = true;
        if (mask) {
          const int key = kv0 + 8 * j + 2 * t + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          if constexpr (MASKED)
            vis = key < sk && bands.visible(row, key, cols_s[buf * BN + key - kv0]);
          else
            vis = key < sk && (!causal || key <= row + offset);
        }
        const float p = vis ? expf(s[j][e] * scale - lse_r[e >> 1]) : 0.f;
        s[j][e] = p * (dp[j][e] - delta_r[e >> 1]) * scale;
      }
    store_frag<BN / 8>(ds_s, LDP, s);  // ds rounded to k's dtype
    __syncwarp();
    warp_gemm<false, D / 8, BN>(acc, ds_s, LDP, kb, LD);
    __syncthreads();
    it = nx;
  }
  cp_async_wait_all();
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq + bh * sq * D, q0 + warp * 16, sq, acc, one);
}

// -- backward: dk and dv ----------------------------------------------------------

// Grid (key tiles, bh); each warp owns 16 keys and works on the transposed
// tiles s^T = k q^T and dp^T = v dO^T. Shared memory: K and V [BN][LD], two
// buffers of Q and dO [BM][LD], per warp a [16][BM + pad] buffer for p^T,
// then ds^T, and two buffers of the q tile's lse and delta (fp32). Masked,
// each thread keeps the bounds of its two keys in registers.
template <int D, bool MASKED>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int sq, int sk, int causal, float scale, Mask mk) {
  constexpr int LD = D + PAD;
  constexpr int LDP = BM + PAD;
  const int k0 = blockIdx.x * BN;  // the first keys see the most rows: first
  const size_t bh = blockIdx.y;
  const int offset = sk - sq;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + BN * LD;
  T* qd_s = v_s + BN * LD;                       // [2][Q, dO][BM][LD]
  T* sc_s = qd_s + 4 * BM * LD + warp * 16 * LDP;
  float* st_s = reinterpret_cast<float*>(qd_s + 4 * BM * LD + WARPS * 16 * LDP);  // [2][lse, delta][BM]
  const T* qg = q + bh * sq * D;
  const T* dog = dout + bh * sq * D;
  const float* lg = lse + bh * sq;
  const float* dg = delta + bh * sq;
  const Bands bands(mk, bh, sk, causal);
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  int4 key_b[2] = {};
  if constexpr (MASKED) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (key0 + 8 * r < sk) key_b[r] = __ldg(bands.cols + key0 + 8 * r);
  }

  const int n_qt = (sq + BM - 1) / BM;
  auto kind = [&](int it) -> int {
    const int q0 = it * BM;
    if constexpr (MASKED)
      return bands.kind(q0, min(q0 + BM, sq) - 1, k0, min(k0 + BN, sk) - 1,
                        q0 + BM <= sq && k0 + BN <= sk);
    return q0 + BM > sq || (causal && q0 + offset < k0 + BN - 1) ? PARTIAL : FULL;
  };
  auto next = [&](int it) {
    if constexpr (MASKED)
      while (it < n_qt && kind(it) == SKIP) ++it;
    return it;
  };
  auto stage = [&](int it, int buf) {
    const int q0 = it * BM;
    T* qb = qd_s + buf * 2 * BM * LD;
    load_tile<D, BM>(qb, qg, q0, sq);
    load_tile<D, BM>(qb + BM * LD, dog, q0, sq);
    float* sb = st_s + buf * 2 * BM;
    for (int i = threadIdx.x; i < BM; i += THREADS) {
      const int row = q0 + i;
      sb[i] = row < sq ? lg[row] : 0.f;
      sb[BM + i] = row < sq ? dg[row] : 0.f;
    }
  };
  int it = next(causal ? max(0, k0 - offset) / BM : 0);
  load_tile<D, BN>(k_s, k + bh * sk * D, k0, sk);
  load_tile<D, BN>(v_s, v + bh * sk * D, k0, sk);
  if (it < n_qt) stage(it, 0);
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int buf = 0; it < n_qt; buf ^= 1) {
    const int nx = next(it + 1);
    const int q0 = it * BM;
    const T* qb = qd_s + buf * 2 * BM * LD;
    const T* dob = qb + BM * LD;
    const float* lb = st_s + buf * 2 * BM;
    const float* db = lb + BM;
    if (nx < n_qt) stage(nx, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    float st[BM / 8][4], dpt[BM / 8][4];
    zero(st);
    zero(dpt);
    warp_gemm<true, BM / 8, D>(st, k_s + warp * 16 * LD, LD, qb, LD);
    warp_gemm<true, BM / 8, D>(dpt, v_s + warp * 16 * LD, LD, dob, LD);
    const bool mask = kind(it) != FULL;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);  // query row within the tile
        bool vis = true;
        if (mask) {
          const int row = q0 + col;
          const int key = key0 + 8 * (e >> 1);
          if constexpr (MASKED)
            vis = row < sq && bands.visible(row, key, key_b[e >> 1]);
          else
            vis = row < sq && (!causal || key <= row + offset);
        }
        const float p = vis ? expf(st[j][e] * scale - lb[col]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - db[col]) * scale;
      }
    store_frag<BM / 8>(sc_s, LDP, st);  // p^T rounded to dO's dtype
    __syncwarp();
    warp_gemm<false, D / 8, BM>(dv_acc, sc_s, LDP, dob, LD);
    __syncwarp();
    store_frag<BM / 8>(sc_s, LDP, dpt);  // ds^T rounded to q's dtype
    __syncwarp();
    warp_gemm<false, D / 8, BM>(dk_acc, sc_s, LDP, qb, LD);
    __syncthreads();
    it = nx;
  }
  cp_async_wait_all();
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dk + bh * sk * D, k0 + warp * 16, sk, dk_acc, one);
  store_rows<D>(dv + bh * sk * D, k0 + warp * 16, sk, dv_acc, one);
}

// -- launches -------------------------------------------------------------------

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D, bool MASKED>
cudaError_t launch_fwd(const Args& a) {
  constexpr int LD = D + PAD;
  const size_t smem = (size_t)(BM * LD + 4 * BN * LD + WARPS * 16 * (BN + PAD)) * sizeof(T) +
                      (MASKED ? 2 * BN * sizeof(int4) : 0);
  auto kernel = flash_fwd_kernel<D, MASKED>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.sq + BM - 1) / BM, a.bh), THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out), static_cast<float*>(a.out2), a.sq, a.sk, a.causal, a.scale, a.mk);
  return cudaGetLastError();
}

template <int D, bool MASKED>
cudaError_t launch_dq(const Args& a) {
  constexpr int LD = D + PAD;
  const size_t smem =
      (size_t)(2 * BM * LD + 4 * BN * LD + WARPS * 16 * (BN + PAD)) * sizeof(T) +
      (MASKED ? 2 * BN * sizeof(int4) : 0);
  auto kernel = flash_bwd_dq_kernel<D, MASKED>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.sq + BM - 1) / BM, a.bh), THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const T*>(a.fwd_out),
      static_cast<const float*>(a.lse), static_cast<float*>(const_cast<void*>(a.delta)),
      static_cast<T*>(a.out), a.sq, a.sk, a.causal, a.scale, a.mk);
  return cudaGetLastError();
}

template <int D, bool MASKED>
cudaError_t launch_dkv(const Args& a) {
  constexpr int LD = D + PAD;
  const size_t smem =
      (size_t)(2 * BN * LD + 4 * BM * LD + WARPS * 16 * (BM + PAD)) * sizeof(T) +
      (size_t)4 * BM * sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<D, MASKED>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.sk + BN - 1) / BN, a.bh), THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.out), static_cast<T*>(a.out2),
      a.sq, a.sk, a.causal, a.scale, a.mk);
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
  if (dtype != 0) return (int)cudaErrorInvalidValue;  // bf16: flash_attention_bf16.cu
  err = cudaErrorInvalidValue;
  if (d == 64) err = by_mask<64>(which, a);
  if (d == 128) err = by_mask<128>(which, a);
  return (int)err;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (1, bfloat16, is flash_attention_bf16.cu's, with the
// same entry points); d: 64 or 128. Each returns a cudaError_t value.
// The dq kernel writes delta = rowsum(dout * out) [bh, sq] fp32, which the
// dk/dv kernel then reads, so dq runs first on the stream.
// FlashMask: bounds [b, hb, sk, 4] int32 and summary [b, hb, nk, 8] int32
// (nk = ceil(sk / 128), from ptt_flashmask_summary); h: query heads (bh =
// b * h); hb: 1 or h; wl, wr: the window (2^30 for none). bounds ==
// nullptr runs the dense kernel (summary, h, hb, wl, wr unused). kinds
// (forward, may be nullptr): int8 [bh, nq, nk] in 64 x 64 tiles, where
// the masked forward writes the kind (0 skip, 1 partial, 2 full) of every
// tile its loops range over.
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

// bounds [rows, sk, 4] int32 (rows = b * hb) -> summary [rows, nk, 8] int32.
int ptt_flashmask_summary(const void* bounds, void* summary, int rows, int sk, void* stream) {
  if (rows <= 0 || sk <= 0) return (int)cudaErrorInvalidValue;
  const int nk = (sk + TILE - 1) / TILE;
  const int n_tiles = rows * nk;
  flashmask_summary_kernel<<<(n_tiles + SUMMARY_WARPS - 1) / SUMMARY_WARPS, 32 * SUMMARY_WARPS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(bounds), static_cast<int4*>(summary), n_tiles, nk, sk);
  return (int)cudaGetLastError();
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
