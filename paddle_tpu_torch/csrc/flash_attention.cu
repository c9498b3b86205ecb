// Flash attention for training, forward and backward (Hopper, sm_90a).
//
// Replaces paddle_tpu/kernels/flash_pallas.py: _flash_forward (_fa_kernel)
// and _flash_backward (_fa_dq_kernel, _fa_dkv_kernel). Same function:
// q [bh, sq, D], k/v [bh, sk, D]; s = (q k^T) * scale in fp32; causal is
// bottom-right aligned (query i sees keys <= i + sk - sq, masked scores
// are -1e30); the forward writes out (q's dtype) and lse [bh, sq] (fp32,
// -1e30 for a row that sees no key, whose output is 0). The backward is
// the FA2 split of the JAX code: the dq kernel sweeps the kv tiles of one
// q tile, the dk/dv kernel sweeps the q tiles of one kv tile; each tile
// recomputes p = exp(s - lse) and uses delta = rowsum(dO * O) (computed in
// fp32 by the caller). No atomics: every run gives the same result.
// Rounding as in the JAX kernels: P is cast to v's dtype before P.V; ds to
// k's dtype for dq; p to dO's dtype for dv and ds to q's dtype for dk.
//
// Bound on the H100: operations. At training shapes (s = 2048, D = 128) a
// tile of 64 query rows does 4 * 64 * 64 * D flops per 64-key tile it
// reads (32 KB of bf16 K and V), ~128 flop/byte from device memory and far
// more from L2, so the tensor cores are the limit, not the bytes.
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
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 64;  // query rows of a tile
constexpr int BN = 64;  // key rows of a tile
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr float NEG_INF = -1e30f;

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

// -- forward --------------------------------------------------------------------

// Grid (query tiles, bh). Shared memory: Q [BM][LD], two buffers of K and V
// [BN][LD] each, and per warp a [16][BN + pad] buffer for P.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int sq, int sk, int causal,
                 float scale) {
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
  const T* kg = k + bh * sk * D;
  const T* vg = v + bh * sk * D;

  const int n_kv = kv_tiles(q0, sq, sk, causal);
  load_tile<T, D, BM>(q_s, q + bh * sq * D, q0, sq);
  load_tile<T, D, BN>(kv_s, kg, 0, sk);
  load_tile<T, D, BN>(kv_s + BN * LD, vg, 0, sk);
  cp_async_commit();

  float o[D / 8][4];
  zero(o);
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  for (int it = 0; it < n_kv; ++it) {
    const T* kb = kv_s + (it & 1) * 2 * BN * LD;
    const T* vb = kb + BN * LD;
    if (it + 1 < n_kv) {
      T* nb = kv_s + ((it + 1) & 1) * 2 * BN * LD;
      load_tile<T, D, BN>(nb, kg, (it + 1) * BN, sk);
      load_tile<T, D, BN>(nb + BN * LD, vg, (it + 1) * BN, sk);
    }
    cp_async_commit();
    cp_async_wait_prev();  // this tile has landed
    __syncthreads();

    float s[BN / 8][4];
    zero(s);
    warp_gemm<T, true, BN / 8, D>(s, q_s + warp * 16 * LD, LD, kb, LD);
    const int kv0 = it * BN;
    const bool mask = kv0 + BN > sk || (causal && kv0 + BN - 1 > q0 + offset);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (mask) {
          const int key = kv0 + 8 * j + 2 * t + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          if (key >= sk || (causal && key > row + offset)) x = NEG_INF;
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
        const float p = expf(s[j][e] - mx[e >> 1]);
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
  }

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
// K and V [BN][LD], and per warp a [16][BN + pad] buffer for ds.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int sq, int sk,
                    int causal, float scale) {
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
  const T* kg = k + bh * sk * D;
  const T* vg = v + bh * sk * D;

  const int n_kv = kv_tiles(q0, sq, sk, causal);
  load_tile<T, D, BM>(q_s, q + bh * sq * D, q0, sq);
  load_tile<T, D, BM>(do_s, dout + bh * sq * D, q0, sq);
  load_tile<T, D, BN>(kv_s, kg, 0, sk);
  load_tile<T, D, BN>(kv_s + BN * LD, vg, 0, sk);
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

  for (int it = 0; it < n_kv; ++it) {
    const T* kb = kv_s + (it & 1) * 2 * BN * LD;
    const T* vb = kb + BN * LD;
    if (it + 1 < n_kv) {
      T* nb = kv_s + ((it + 1) & 1) * 2 * BN * LD;
      load_tile<T, D, BN>(nb, kg, (it + 1) * BN, sk);
      load_tile<T, D, BN>(nb + BN * LD, vg, (it + 1) * BN, sk);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    float s[BN / 8][4], dp[BN / 8][4];
    zero(s);
    zero(dp);
    warp_gemm<T, true, BN / 8, D>(s, q_s + warp * 16 * LD, LD, kb, LD);
    warp_gemm<T, true, BN / 8, D>(dp, do_s + warp * 16 * LD, LD, vb, LD);
    const int kv0 = it * BN;
    const bool mask = kv0 + BN > sk || (causal && kv0 + BN - 1 > q0 + offset);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool vis = true;
        if (mask) {
          const int key = kv0 + 8 * j + 2 * t + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          vis = key < sk && (!causal || key <= row + offset);
        }
        const float p = vis ? expf(s[j][e] * scale - lse_r[e >> 1]) : 0.f;
        s[j][e] = p * (dp[j][e] - delta_r[e >> 1]) * scale;
      }
    store_frag<T, BN / 8>(ds_s, LDP, s);  // ds rounded to k's dtype
    __syncwarp();
    warp_gemm<T, false, D / 8, BN>(acc, ds_s, LDP, kb, LD);
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  store_rows<T, D>(dq + bh * sq * D, q0 + warp * 16, sq, acc, one);
}

// -- backward: dk and dv ----------------------------------------------------------

// Grid (key tiles, bh); each warp owns 16 keys and works on the transposed
// tiles s^T = k q^T and dp^T = v dO^T. Shared memory: K and V [BN][LD], two
// buffers of Q and dO [BM][LD], per warp a [16][BM + pad] buffer for p^T,
// then ds^T, and two buffers of the q tile's lse and delta (fp32).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int sq, int sk, int causal, float scale) {
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

  const int n_qt = (sq + BM - 1) / BM;
  const int first = causal ? max(0, k0 - offset) / BM : 0;
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
  load_tile<T, D, BN>(k_s, k + bh * sk * D, k0, sk);
  load_tile<T, D, BN>(v_s, v + bh * sk * D, k0, sk);
  if (first < n_qt) stage(first, 0);
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8

  for (int it = first; it < n_qt; ++it) {
    const int buf = (it - first) & 1;
    const int q0 = it * BM;
    const T* qb = qd_s + buf * 2 * BM * LD;
    const T* dob = qb + BM * LD;
    const float* lb = st_s + buf * 2 * BM;
    const float* db = lb + BM;
    if (it + 1 < n_qt) stage(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    float st[BM / 8][4], dpt[BM / 8][4];
    zero(st);
    zero(dpt);
    warp_gemm<T, true, BM / 8, D>(st, k_s + warp * 16 * LD, LD, qb, LD);
    warp_gemm<T, true, BM / 8, D>(dpt, v_s + warp * 16 * LD, LD, dob, LD);
    const bool mask = q0 + BM > sq || (causal && q0 + offset < k0 + BN - 1);
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);  // query row within the tile
        bool vis = true;
        if (mask) {
          const int row = q0 + col;
          const int key = key0 + 8 * (e >> 1);
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
  }
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
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
cudaError_t launch_fwd(const Args& a) {
  constexpr int LD = D + pad<T>();
  const size_t smem = (size_t)(BM * LD + 4 * BN * LD + WARPS * 16 * (BN + pad<T>())) * sizeof(T);
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.sq + BM - 1) / BM, a.bh), THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out), static_cast<float*>(a.out2), a.sq, a.sk, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr int LD = D + pad<T>();
  const size_t smem =
      (size_t)(2 * BM * LD + 4 * BN * LD + WARPS * 16 * (BN + pad<T>())) * sizeof(T);
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.sq + BM - 1) / BM, a.bh), THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.out), a.sq, a.sk, a.causal,
      a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr int LD = D + pad<T>();
  const size_t smem =
      (size_t)(2 * BN * LD + 4 * BM * LD + WARPS * 16 * (BM + pad<T>())) * sizeof(T) +
      (size_t)4 * BM * sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.sk + BN - 1) / BN, a.bh), THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.out), static_cast<T*>(a.out2),
      a.sq, a.sk, a.causal, a.scale);
  return cudaGetLastError();
}

// which: 0 forward, 1 dq, 2 dk/dv.
template <typename T, int D>
cudaError_t by_kind(int which, const Args& a) {
  if (which == 0) return launch_fwd<T, D>(a);
  if (which == 1) return launch_dq<T, D>(a);
  return launch_dkv<T, D>(a);
}

int dispatch(int which, int d, int dtype, const Args& a) {
  if (a.bh == 0 || a.sq == 0) return 0;
  if (a.bh < 0 || a.bh > 65535 || a.sq < 0 || a.sk <= 0) return (int)cudaErrorInvalidValue;
  if (a.causal && a.sq > a.sk) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && d == 64) err = by_kind<float, 64>(which, a);
  if (dtype == 0 && d == 128) err = by_kind<float, 128>(which, a);
  if (dtype == 1 && d == 64) err = by_kind<bf16, 64>(which, a);
  if (dtype == 1 && d == 128) err = by_kind<bf16, 128>(which, a);
  return (int)err;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; d: 64 or 128. Each returns a
// cudaError_t value.
int ptt_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int bh,
                  int sq, int sk, int d, int dtype, int causal, float scale, void* stream) {
  const Args a{q, k, v, nullptr, nullptr, nullptr, out, lse, bh, sq, sk, causal, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch(0, d, dtype, a);
}

int ptt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, int bh, int sq, int sk, int d,
                     int dtype, int causal, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, bh, sq, sk, causal, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch(1, d, dtype, a);
}

int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
                      int sk, int d, int dtype, int causal, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, causal, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch(2, d, dtype, a);
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
