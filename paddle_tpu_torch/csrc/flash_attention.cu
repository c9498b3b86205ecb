// Flash attention for training, forward and backward (Hopper, sm_90a), dense
// and with FlashMask column bounds.
//
// Replaces paddle_tpu/kernels/flash_pallas.py: _flash_forward (_fa_kernel)
// and _flash_backward (_fa_dq_kernel, _fa_dkv_kernel), each with and
// without `bounds`/`window` (flashmask_attention). Same function:
// q [bh, sq, D], k/v [bh, sk, D]; s = (q k^T) * scale in fp32; causal is
// bottom-right aligned (query i sees keys <= i + sk - sq, masked scores
// are -1e30); the forward writes out (q's dtype) and lse [bh, sq] (fp32).
// The dense kernels never meet a row that sees no key (causal needs
// sq <= sk). The masked kernels can: such a row gets output 0 and lse
// -1e30, since a masked entry's p is forced to 0 whatever the running max
// (the JAX kernel instead returns the mean of v over the tiles it did not
// skip). The backward is the FA2 split of the JAX code: the dq kernel
// sweeps the kv tiles of one q tile, the dk/dv kernel sweeps the q tiles
// of one kv tile; each tile recomputes p = exp(s - lse) and uses
// delta = rowsum(dO * O) (computed in fp32 by the caller). No atomics:
// every run gives the same result.
// Rounding as in the JAX kernels: P is cast to v's dtype before P.V; ds to
// k's dtype for dq; p to dO's dtype for dv and ds to q's dtype for dk.
//
// FlashMask (the masked kernels, sq == sk): canonical bounds [b, hb, sk, 4]
// int32 (LTS, LTE, UTS, UTE) per key column j, hb in {1, h} (read
// broadcast over the heads when 1). Query i is masked from key j where
// i > j and LTS <= i < LTE; where i < j under causal, or i < j and
// UTS <= i < UTE otherwise; where i > j + wl; and, not causal, where
// i < j - wr (wl, wr = 2^30 for no window). A pre-pass kernel writes the
// min and max of each bound over every 64-column key tile, [b, hb, nk, 8];
// from them and the tile's rows each (q tile, kv tile) is one of three
// kinds: skip (every entry provably masked: no load, no math), full (every
// entry provably visible: no per-entry test) or partial (the test above
// per entry). The test is conservative, so a skipped tile holds only
// masked entries, and the loops prefetch the next tile that is not
// skipped.
//
// Bound on the H100: operations. At training shapes (s = 2048, D = 128) a
// tile of 64 query rows does 4 * 64 * 64 * D flops per 64-key tile it
// reads (32 KB of bf16 K and V), ~128 flop/byte from device memory and far
// more from L2, so the tensor cores are the limit, not the bytes; with
// bounds, the visible (query, key) pairs set the work.
//
// Design against that bound, simple first:
//   * one block of 4 warps per (64-row tile, batch*head), each warp owning
//     16 rows; K/V (or Q/dO) tiles of 64 rows in shared memory, double-
//     buffered with cp.async so the next tile loads while this one is used;
//   * bf16 products on the tensor cores with mma.sync m16n8k16 (fp32
//     accumulation); float32 inputs take fp32 FMA in the same fragment
//     layout, so the softmax code is shared by both types;
//   * online softmax in registers: the running max and sum of a row live in
//     the 4 threads that hold it, reduced with two shuffles;
//   * causal: the kv loop stops at the diagonal tile (the dk/dv loop starts
//     there) and only tiles that cross the diagonal or the ragged end are
//     masked; the blocks with the most work are scheduled first;
//   * P (and ds) go through a small per-warp shared buffer in the input type,
//     which is the cast the JAX kernels make before their second product.
// Fragments are read from shared memory with plain loads (no ldmatrix), and
// neither wgmma nor TMA is used yet: those are the next steps for speed.
//
// Plain C interface, loaded with ctypes. Launches go on the caller's
// stream; each function returns cudaGetLastError() so a refused launch is
// reported to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 64;  // query rows of a tile
constexpr int BN = 64;  // key rows of a tile
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr float NEG_INF = -1e30f;
enum TileKind { SKIP, PARTIAL, FULL };

using bf16 = __nv_bfloat16;

// Row padding in elements (16 bytes): keeps rows 16-byte aligned for
// cp.async and spreads a warp's fragment loads over the banks.
template <typename T>
__host__ __device__ constexpr int pad() {
  return 16 / (int)sizeof(T);
}

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
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0, int n_rows) {
  constexpr int LD = D + pad<T>();
  constexpr int VE = 16 / (int)sizeof(T);
  constexpr int PER_ROW = D / VE;
  for (int c = threadIdx.x; c < ROWS * PER_ROW; c += THREADS) {
    const int r = c / PER_ROW;
    const int e = (c - r * PER_ROW) * VE;
    const int row = r0 + r;
    const bool ok = row < n_rows;
    cp_async16(dst + r * LD + e, src + (size_t)(ok ? row : 0) * D + e, ok);
  }
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp: C[16 x 8*NT] += A[16 x K] * B[K x 8*NT], all in shared memory.
// A is row-major (stride lda). B(k, n) = B[n * ldb + k] when NMAJOR (K of a
// q.k^T product), else B[k * ldb + n] (V of a p.V product). C is held in the
// mma.sync accumulator layout: lane = 4 * g + t holds c[j][0..1] at row g,
// columns 8j + 2t + {0, 1}, and c[j][2..3] at row g + 8, the same columns.
template <typename T, bool NMAJOR, int NT, int K>
__device__ __forceinline__ void warp_gemm(float (&c)[NT][4], const T* A, int lda, const T* B,
                                          int ldb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  if constexpr (std::is_same<T, float>::value) {
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
  } else {
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      const T* a_lo = A + g * lda + k0 + 2 * t;
      const T* a_hi = a_lo + 8 * lda;
      const uint32_t a[4] = {ld_pair(a_lo), ld_pair(a_hi), ld_pair(a_lo + 8), ld_pair(a_hi + 8)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = 8 * j + g;
        uint32_t b0, b1;
        if constexpr (NMAJOR) {
          const T* bp = B + n * ldb + k0 + 2 * t;
          b0 = ld_pair(bp);
          b1 = ld_pair(bp + 8);
        } else {
          const T* bp = B + (k0 + 2 * t) * ldb + n;
          b0 = pack(bp[0], bp[ldb]);
          b1 = pack(bp[8 * ldb], bp[9 * ldb]);
        }
        mma_bf16(c[j], a, b0, b1);
      }
    }
  }
}

// Two neighbouring values of a row, rounded to T, to shared or device memory.
template <typename T>
__device__ __forceinline__ void store_pair(T* p, float x, float y) {
  if constexpr (std::is_same<T, float>::value) {
    p[0] = x;
    p[1] = y;
  } else {
    *reinterpret_cast<uint32_t*>(p) = pack(__float2bfloat16(x), __float2bfloat16(y));
  }
}

// A warp's [16 x 8*NT] accumulator, rounded to T, into a buffer of stride ld.
template <typename T, int NT>
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
template <typename T, int D>
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

// -- FlashMask bounds -------------------------------------------------------------

// What the masked kernels take beyond the dense ones (bounds == nullptr:
// the dense kernels).
struct Mask {
  const int* bounds;   // [b, hb, sk, 4] canonical (LTS, LTE, UTS, UTE)
  const int* summary;  // [b, hb, nk, 8] per key tile: min, max of each bound
  signed char* kinds;  // or nullptr; [bh, nq, nk]: the forward writes each tile's kind
  int h, hb, wl, wr;
};

// One (batch, head)'s bounds: its columns, its tile summaries and the test.
struct Bands {
  const int4* cols;   // [sk]
  const int4* tiles;  // [nk][2]: (min LTS, max LTS, min LTE, max LTE), same for UTS, UTE
  int causal, wl, wr;

  __device__ Bands(const Mask& mk, size_t bh, int sk, int causal_)
      : cols(nullptr), tiles(nullptr), causal(causal_), wl(mk.wl), wr(mk.wr) {
    if (mk.bounds == nullptr) return;  // a dense kernel
    const size_t row = (bh / mk.h) * mk.hb + (mk.hb == 1 ? 0 : bh % mk.h);
    cols = reinterpret_cast<const int4*>(mk.bounds) + row * sk;
    tiles = reinterpret_cast<const int4*>(mk.summary) + row * ((sk + BN - 1) / BN) * 2;
  }

  // _flashmask_visible of query i and key j, whose bounds are b.
  __device__ __forceinline__ bool visible(int i, int j, int4 b) const {
    const bool low = i > j && i >= b.x && i < b.y;
    const bool up = i < j && (causal || (i >= b.z && i < b.w));
    const bool win = i - j > wl || (!causal && j - i > wr);
    return !(low || up || win);
  }

  // Kind of the tile of rows [r0, r1] and keys [c0, c1] (key tile kt);
  // whole: the tile lies inside sq x sk. Every SKIP holds only masked
  // entries and every FULL only visible ones.
  __device__ __forceinline__ int kind(int kt, int r0, int r1, int c0, int c1, bool whole) const {
    if (causal && r1 < c0) return SKIP;
    if (r0 - c1 > wl || (!causal && c0 - r1 > wr)) return SKIP;
    const int4 lo = __ldg(tiles + 2 * kt);
    const int4 up = __ldg(tiles + 2 * kt + 1);
    if (r0 > c1 && lo.y <= r0 && lo.z > r1) return SKIP;  // every lower band holds every row
    if (!causal && r1 < c0 && up.y <= r0 && up.z > r1) return SKIP;
    if (!whole || r1 - c0 > wl || (causal ? r0 < c1 : c1 - r0 > wr)) return PARTIAL;
    if (r1 > c0 && lo.w > r0 && lo.x <= r1) return PARTIAL;  // a lower band may meet the rows
    if (!causal && r0 < c1 && up.w > r0 && up.x <= r1) return PARTIAL;
    return FULL;
  }
};

// The bounds of keys [c0, c0 + BN) into shared memory (zeros past sk).
__device__ __forceinline__ void load_cols(int4* dst, const int4* src, int c0, int sk) {
  for (int c = threadIdx.x; c < BN; c += THREADS) {
    const int col = c0 + c;
    const bool ok = col < sk;
    cp_async16(dst + c, src + (ok ? col : 0), ok);
  }
}

// One thread per (row of bounds, key tile): the min and max of each bound
// over the tile's columns below sk.
__global__ void flashmask_summary_kernel(const int4* __restrict__ bounds, int4* __restrict__ summary,
                                         int n_tiles, int nk, int sk) {
  const int tile = blockIdx.x * blockDim.x + threadIdx.x;
  if (tile >= n_tiles) return;
  const int4* col = bounds + (size_t)(tile / nk) * sk;
  const int c0 = (tile % nk) * BN;
  int4 lo = make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX);
  int4 hi = make_int4(INT_MIN, INT_MIN, INT_MIN, INT_MIN);
  for (int j = c0; j < min(c0 + BN, sk); ++j) {
    const int4 b = col[j];
    lo = make_int4(min(lo.x, b.x), min(lo.y, b.y), min(lo.z, b.z), min(lo.w, b.w));
    hi = make_int4(max(hi.x, b.x), max(hi.y, b.y), max(hi.z, b.z), max(hi.w, b.w));
  }
  summary[2 * (size_t)tile] = make_int4(lo.x, hi.x, lo.y, hi.y);
  summary[2 * (size_t)tile + 1] = make_int4(lo.z, hi.z, lo.w, hi.w);
}

// -- forward --------------------------------------------------------------------

// Grid (query tiles, bh). Shared memory: Q [BM][LD], two buffers of K and V
// [BN][LD] each, per warp a [16][BN + pad] buffer for P and, masked, two
// buffers of the key tile's bounds [BN] int4.
template <typename T, int D, bool MASKED>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int sq, int sk, int causal,
                 float scale, Mask mk) {
  constexpr int LD = D + pad<T>();
  constexpr int LDP = BN + pad<T>();
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
      return bands.kind(it, q0, min(q0 + BM, sq) - 1, c0, min(c0 + BN, sk) - 1,
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
    load_tile<T, D, BN>(nb, kg, it * BN, sk);
    load_tile<T, D, BN>(nb + BN * LD, vg, it * BN, sk);
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
  load_tile<T, D, BM>(q_s, q + bh * sq * D, q0, sq);
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
    warp_gemm<T, true, BN / 8, D>(s, q_s + warp * 16 * LD, LD, kb, LD);
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
    store_frag<T, BN / 8>(p_s, LDP, s);  // P rounded to v's dtype
    __syncwarp();
    warp_gemm<T, false, D / 8, BN>(o, p_s, LDP, vb, LD);
    __syncthreads();  // the tile buffer and P are written again next round
    it = nx;
  }
  cp_async_wait_all();  // a block that skipped every tile still has Q in flight

  float div[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) div[r] = l_r[r] == 0.f ? 1.f : l_r[r];
  store_rows<T, D>(out + bh * sq * D, q0 + warp * 16, sq, o, div);
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
template <typename T, int D, bool MASKED>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int sq, int sk,
                    int causal, float scale, Mask mk) {
  constexpr int LD = D + pad<T>();
  constexpr int LDP = BN + pad<T>();
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
      return bands.kind(it, q0, min(q0 + BM, sq) - 1, c0, min(c0 + BN, sk) - 1,
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
    load_tile<T, D, BN>(nb, kg, it * BN, sk);
    load_tile<T, D, BN>(nb + BN * LD, vg, it * BN, sk);
    if constexpr (MASKED) load_cols(cols_s + buf * BN, bands.cols, it * BN, sk);
  };

  int it = next(0);
  load_tile<T, D, BM>(q_s, q + bh * sq * D, q0, sq);
  load_tile<T, D, BM>(do_s, dout + bh * sq * D, q0, sq);
  if (it < n_kv) stage(it, 0);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse_r[r] = row < sq ? lse[bh * sq + row] : 0.f;
    delta_r[r] = row < sq ? delta[bh * sq + row] : 0.f;
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
    warp_gemm<T, true, BN / 8, D>(s, q_s + warp * 16 * LD, LD, kb, LD);
    warp_gemm<T, true, BN / 8, D>(dp, do_s + warp * 16 * LD, LD, vb, LD);
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
    store_frag<T, BN / 8>(ds_s, LDP, s);  // ds rounded to k's dtype
    __syncwarp();
    warp_gemm<T, false, D / 8, BN>(acc, ds_s, LDP, kb, LD);
    __syncthreads();
    it = nx;
  }
  cp_async_wait_all();
  const float one[2] = {1.f, 1.f};
  store_rows<T, D>(dq + bh * sq * D, q0 + warp * 16, sq, acc, one);
}

// -- backward: dk and dv ----------------------------------------------------------

// Grid (key tiles, bh); each warp owns 16 keys and works on the transposed
// tiles s^T = k q^T and dp^T = v dO^T. Shared memory: K and V [BN][LD], two
// buffers of Q and dO [BM][LD], per warp a [16][BM + pad] buffer for p^T,
// then ds^T, and two buffers of the q tile's lse and delta (fp32). Masked,
// each thread keeps the bounds of its two keys in registers.
template <typename T, int D, bool MASKED>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int sq, int sk, int causal, float scale, Mask mk) {
  constexpr int LD = D + pad<T>();
  constexpr int LDP = BM + pad<T>();
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
      return bands.kind(blockIdx.x, q0, min(q0 + BM, sq) - 1, k0, min(k0 + BN, sk) - 1,
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
    load_tile<T, D, BM>(qb, qg, q0, sq);
    load_tile<T, D, BM>(qb + BM * LD, dog, q0, sq);
    float* sb = st_s + buf * 2 * BM;
    for (int i = threadIdx.x; i < BM; i += THREADS) {
      const int row = q0 + i;
      sb[i] = row < sq ? lg[row] : 0.f;
      sb[BM + i] = row < sq ? dg[row] : 0.f;
    }
  };
  int it = next(causal ? max(0, k0 - offset) / BM : 0);
  load_tile<T, D, BN>(k_s, k + bh * sk * D, k0, sk);
  load_tile<T, D, BN>(v_s, v + bh * sk * D, k0, sk);
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
    warp_gemm<T, true, BM / 8, D>(st, k_s + warp * 16 * LD, LD, qb, LD);
    warp_gemm<T, true, BM / 8, D>(dpt, v_s + warp * 16 * LD, LD, dob, LD);
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
    store_frag<T, BM / 8>(sc_s, LDP, st);  // p^T rounded to dO's dtype
    __syncwarp();
    warp_gemm<T, false, D / 8, BM>(dv_acc, sc_s, LDP, dob, LD);
    __syncwarp();
    store_frag<T, BM / 8>(sc_s, LDP, dpt);  // ds^T rounded to q's dtype
    __syncwarp();
    warp_gemm<T, false, D / 8, BM>(dk_acc, sc_s, LDP, qb, LD);
    __syncthreads();
    it = nx;
  }
  cp_async_wait_all();
  const float one[2] = {1.f, 1.f};
  store_rows<T, D>(dk + bh * sk * D, k0 + warp * 16, sk, dk_acc, one);
  store_rows<T, D>(dv + bh * sk * D, k0 + warp * 16, sk, dv_acc, one);
}

// -- launches -------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out, *out2;
  int bh, sq, sk, causal;
  float scale;
  cudaStream_t stream;
  Mask mk;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D, bool MASKED>
cudaError_t launch_fwd(const Args& a) {
  constexpr int LD = D + pad<T>();
  const size_t smem = (size_t)(BM * LD + 4 * BN * LD + WARPS * 16 * (BN + pad<T>())) * sizeof(T) +
                      (MASKED ? 2 * BN * sizeof(int4) : 0);
  auto kernel = flash_fwd_kernel<T, D, MASKED>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.sq + BM - 1) / BM, a.bh), THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out), static_cast<float*>(a.out2), a.sq, a.sk, a.causal, a.scale, a.mk);
  return cudaGetLastError();
}

template <typename T, int D, bool MASKED>
cudaError_t launch_dq(const Args& a) {
  constexpr int LD = D + pad<T>();
  const size_t smem =
      (size_t)(2 * BM * LD + 4 * BN * LD + WARPS * 16 * (BN + pad<T>())) * sizeof(T) +
      (MASKED ? 2 * BN * sizeof(int4) : 0);
  auto kernel = flash_bwd_dq_kernel<T, D, MASKED>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.sq + BM - 1) / BM, a.bh), THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.out), a.sq, a.sk, a.causal,
      a.scale, a.mk);
  return cudaGetLastError();
}

template <typename T, int D, bool MASKED>
cudaError_t launch_dkv(const Args& a) {
  constexpr int LD = D + pad<T>();
  const size_t smem =
      (size_t)(2 * BN * LD + 4 * BM * LD + WARPS * 16 * (BM + pad<T>())) * sizeof(T) +
      (size_t)4 * BM * sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<T, D, MASKED>;
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
template <typename T, int D, bool MASKED>
cudaError_t by_kind(int which, const Args& a) {
  if (which == 0) return launch_fwd<T, D, MASKED>(a);
  if (which == 1) return launch_dq<T, D, MASKED>(a);
  return launch_dkv<T, D, MASKED>(a);
}

template <typename T, int D>
cudaError_t by_mask(int which, const Args& a) {
  return a.mk.bounds != nullptr ? by_kind<T, D, true>(which, a) : by_kind<T, D, false>(which, a);
}

int dispatch(int which, int d, int dtype, const Args& a) {
  if (a.bh == 0 || a.sq == 0) return 0;
  if (a.bh < 0 || a.bh > 65535 || a.sq < 0 || a.sk <= 0) return (int)cudaErrorInvalidValue;
  if (a.causal && a.sq > a.sk) return (int)cudaErrorInvalidValue;
  if (a.mk.bounds != nullptr &&
      (a.mk.summary == nullptr || a.sq != a.sk || a.mk.h <= 0 || a.bh % a.mk.h ||
       (a.mk.hb != 1 && a.mk.hb != a.mk.h)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && d == 64) err = by_mask<float, 64>(which, a);
  if (dtype == 0 && d == 128) err = by_mask<float, 128>(which, a);
  if (dtype == 1 && d == 64) err = by_mask<bf16, 64>(which, a);
  if (dtype == 1 && d == 128) err = by_mask<bf16, 128>(which, a);
  return (int)err;
}

Mask mask_of(const void* bounds, const void* summary, void* kinds, int h, int hb, int wl, int wr) {
  return {static_cast<const int*>(bounds), static_cast<const int*>(summary),
          static_cast<signed char*>(kinds), h, hb, wl, wr};
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; d: 64 or 128. Each returns a
// cudaError_t value. FlashMask: bounds [b, hb, sk, 4] int32 and summary
// [b, hb, nk, 8] int32 (nk = ceil(sk / 64), from ptt_flashmask_summary); h:
// query heads (bh = b * h); hb: 1 or h; wl, wr: the window (2^30 for none).
// bounds == nullptr runs the dense kernel (summary, h, hb, wl, wr unused).
// kinds (forward, may be nullptr): int8 [bh, nq, nk], where the masked
// forward writes the kind (0 skip, 1 partial, 2 full) of every tile its
// loops range over.
int ptt_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                  const void* bounds, const void* summary, void* kinds, int bh, int sq, int sk,
                  int d, int dtype, int causal, float scale, int h, int hb, int wl, int wr,
                  void* stream) {
  const Args a{q, k, v, nullptr, nullptr, nullptr, out, lse, bh, sq, sk, causal, scale,
               static_cast<cudaStream_t>(stream), mask_of(bounds, summary, kinds, h, hb, wl, wr)};
  return dispatch(0, d, dtype, a);
}

int ptt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, const void* bounds,
                     const void* summary, int bh, int sq, int sk, int d, int dtype, int causal,
                     float scale, int h, int hb, int wl, int wr, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, bh, sq, sk, causal, scale,
               static_cast<cudaStream_t>(stream), mask_of(bounds, summary, nullptr, h, hb, wl, wr)};
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
  const int nk = (sk + BN - 1) / BN;
  const int n_tiles = rows * nk;
  flashmask_summary_kernel<<<(n_tiles + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(bounds), static_cast<int4*>(summary), n_tiles, nk, sk);
  return (int)cudaGetLastError();
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
