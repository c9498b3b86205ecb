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
// Design against that bound, simple first:
//   * gmm: one block of 8 warps per 128 x 128 output tile. The block loads
//     the group offsets into shared memory and walks the groups that cross
//     its row tile (one, or a few at a boundary). For each it runs the whole
//     k loop with the rows of other groups zero-filled, and stores only its
//     own rows: every output row is written once, by one block, with no
//     read-modify-write (the Pallas kernel revisits a tile and merges).
//     trans_w reads w[g] as [n, k], so the backward's dx = dy . w^T needs no
//     transposed copy of w.
//   * tgmm: one block per (group, 128-row k tile, 128-column n tile); it
//     walks its group's rows in chunks, accumulating x_g^T . dy_g in fp32
//     registers, and writes its tile once. No atomics: the same result on
//     every run.
//   * tiles of the reduction axis (64 bf16 or 16 fp32 values) stream through
//     a 3-deep ring in shared memory with cp.async (one barrier a tile);
//     rows outside the group and columns past the edge are zero-filled by
//     the copy itself. Two blocks share an SM (registers capped at 128 a
//     thread, ~110 KB of shared memory a block): at the slice's shapes on
//     an H100 80GB HBM3 (700 W), chip_smoke.py measured gmm at 0.54 ms and
//     tgmm at 0.37 ms with one block an SM and a 2-deep ring of 32, and
//     ~0.38 and ~0.30 ms with this;
//   * bf16 products on the tensor cores with mma.sync m16n8k16 (fp32
//     accumulation), fragments read with ldmatrix (.trans where the tile is
//     stored with the other axis contiguous); each warp owns a 32 x 64 piece
//     of the tile. float32 inputs take fp32 FMA in the same fragment layout,
//     so the staging and the epilogue are shared by both types.
// wgmma and TMA are not used yet: those are the next steps for speed.
//
// Plain C interface, loaded with ctypes. Launches go on the caller's
// stream; each function returns cudaGetLastError() so a refused launch is
// reported to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;  // rows of an output tile
constexpr int BN = 128;  // columns of an output tile
constexpr int WARPS = 8;  // 4 along the rows x 2 along the columns
constexpr int THREADS = 32 * WARPS;
constexpr int WM = 32;  // rows of a warp's piece
constexpr int WN = 64;  // columns of a warp's piece
constexpr int MAX_GROUPS = 1024;
constexpr int STAGES = 3;  // depth of the shared-memory ring
constexpr int MIN_BLOCKS = 2;  // blocks per SM: caps registers at 128 a thread

using bf16 = __nv_bfloat16;

template <typename T>
__host__ __device__ constexpr int bk() {  // reduction depth of a stage
  return std::is_same<T, float>::value ? 16 : 64;
}
template <typename T>
__host__ __device__ constexpr int pad() {  // 16 bytes of row padding
  return 16 / (int)sizeof(T);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
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
// memory (row stride COLS + pad): element (r, c) comes from src[(row0 + r)
// * ld + col0 + c]. Rows outside [lo, hi) and columns at or past col_end
// are zero-filled. COLS and col0, col_end are multiples of 16 bytes.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, size_t ld, int row0, int lo,
                                          int hi, int col0, int col_end) {
  constexpr int VE = 16 / (int)sizeof(T);
  constexpr int PER_ROW = COLS / VE;
  constexpr int LD = COLS + pad<T>();
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i - r * PER_ROW) * VE;
    const int row = row0 + r;
    const bool ok = row >= lo && row < hi && col0 + c < col_end;
    cp_async16(dst + r * LD + c, ok ? src + (size_t)row * ld + col0 + c : src, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared-memory stage of the A operand (BM rows of the product) and of B
// (BN columns), each in one of two layouts:
//   A_KM false: A stored [BM][BK] (row m, reduction index contiguous);
//   A_KM true:  A stored [BK][BM] (reduction rows, m contiguous);
//   B_NK false: B stored [BK][BN] (reduction rows, n contiguous);
//   B_NK true:  B stored [BN][BK] (row n, reduction index contiguous).
template <typename T, bool A_KM>
__host__ __device__ constexpr int lda() {
  return A_KM ? BM + pad<T>() : bk<T>() + pad<T>();
}
template <typename T, bool B_NK>
__host__ __device__ constexpr int ldb() {
  return B_NK ? bk<T>() + pad<T>() : BN + pad<T>();
}
template <typename T, bool A_KM>
__host__ __device__ constexpr int a_elems() {
  return A_KM ? bk<T>() * (BM + pad<T>()) : BM * (bk<T>() + pad<T>());
}
template <typename T, bool B_NK>
__host__ __device__ constexpr int b_elems() {
  return B_NK ? BN * (bk<T>() + pad<T>()) : bk<T>() * (BN + pad<T>());
}

// One warp: c[2][8] (its 32 x 64 piece, mma.sync accumulator layout: lane
// 4g + t holds c[i][j][0..1] at row 16i + g, columns 8j + 2t + {0, 1}, and
// c[i][j][2..3] at row 16i + g + 8) += A . B over one stage.
template <typename T, bool A_KM, bool B_NK>
__device__ __forceinline__ void warp_mma(float (&c)[2][8][4], const T* As, const T* Bs, int wm,
                                         int wn) {
  constexpr int LDA = lda<T, A_KM>();
  constexpr int LDB = ldb<T, B_NK>();
  const int lane = threadIdx.x & 31;
  if constexpr (std::is_same<T, float>::value) {
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll 4
    for (int kk = 0; kk < bk<T>(); ++kk) {
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
        const int n = wn + 8 * j + 2 * t;
        const float b0 = B_NK ? Bs[n * LDB + kk] : Bs[kk * LDB + n];
        const float b1 = B_NK ? Bs[(n + 1) * LDB + kk] : Bs[kk * LDB + n + 1];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          c[i][j][0] = fmaf(a[i][0], b0, c[i][j][0]);
          c[i][j][1] = fmaf(a[i][0], b1, c[i][j][1]);
          c[i][j][2] = fmaf(a[i][1], b0, c[i][j][2]);
          c[i][j][3] = fmaf(a[i][1], b1, c[i][j][3]);
        }
      }
    }
  } else {
    const int r8 = lane & 7;         // row of the 8 x 8 matrix this lane addresses
    const int q1 = (lane >> 3) & 1;  // which of the four matrices: bit 0
    const int q2 = lane >> 4;        // bit 1
#pragma unroll
    for (int kk = 0; kk < bk<T>(); kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m0 = wm + 16 * i;
        if constexpr (A_KM)
          ldsm_x4_t(a[i], As + (kk + r8 + 8 * q2) * LDA + m0 + 8 * q1);
        else
          ldsm_x4(a[i], As + (m0 + r8 + 8 * q1) * LDA + kk + 8 * q2);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // two n8 tiles at a time
        const int n0 = wn + 16 * j;
        uint32_t b[4];
        if constexpr (B_NK)
          ldsm_x4(b, Bs + (n0 + r8 + 8 * q2) * LDB + kk + 8 * q1);
        else
          ldsm_x4_t(b, Bs + (kk + r8 + 8 * q1) * LDB + n0 + 8 * q2);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(c[i][2 * j], a[i], b[0], b[1]);
          mma_bf16(c[i][2 * j + 1], a[i], b[2], b[3]);
        }
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
      for (int e = 0; e < 4; ++e) c[i][j][e] = 0.f;
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float x, float y) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  }
}

// The elements of a warp's piece whose tile row lies in [lo, hi) (rows
// relative to the tile) and whose column is below n_cols, to a row-major
// [*, ld] matrix whose tile starts at dst.
template <typename T>
__device__ __forceinline__ void store_piece(T* dst, size_t ld, const float (&c)[2][8][4], int wm,
                                            int wn, int lo, int hi, int n_cols) {
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
        const int n = wn + 8 * j + 2 * t;
        if (n < n_cols) store_pair(dst + (size_t)r * ld + n, c[i][j][2 * h], c[i][j][2 * h + 1]);
      }
    }
}

// -- gmm ------------------------------------------------------------------------

// Grid (column tiles, row tiles). Shared memory: the offsets, then two
// stages of A (x rows, [BM][BK]) and B (w[g], [BK][BN] or [BN][BK]).
template <typename T, bool TRANS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ off,
           T* __restrict__ out, int t, int k, int n, int e) {
  constexpr int BK = bk<T>();
  constexpr int A_SZ = a_elems<T, false>();
  constexpr int B_SZ = b_elems<T, TRANS>();
  __shared__ int s_off[MAX_GROUPS + 1];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a_s = reinterpret_cast<T*>(smem_raw);
  T* b_s = a_s + STAGES * A_SZ;

  const int c0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * BM;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp & 3) * WM;
  const int wn = (warp >> 2) * WN;
  for (int i = threadIdx.x; i <= e; i += THREADS) s_off[i] = min(max(off[i], 0), t);
  __syncthreads();
  const int rend = min(r0 + BM, t);
  const int n_k = (k + BK - 1) / BK;
  T* out_tile = out + (size_t)r0 * n + c0;
  const int n_cols = min(BN, n - c0);
  float c[2][8][4];

  for (int g = 0; g < e; ++g) {
    const int lo = max(s_off[g], r0);
    const int hi = min(s_off[g + 1], rend);
    if (lo >= hi) continue;  // the same for every thread of the block
    const T* wg = w + (size_t)g * k * n;
    auto stage = [&](int it, int buf) {
      const int k0 = it * BK;
      load_tile<T, BM, BK>(a_s + buf * A_SZ, x, k, r0, lo, hi, k0, k);
      if constexpr (TRANS)  // w[g] is [n, k]: B stored [BN][BK]
        load_tile<T, BN, BK>(b_s + buf * B_SZ, wg, k, c0, 0, n, k0, k);
      else  // w[g] is [k, n]: B stored [BK][BN]
        load_tile<T, BK, BN>(b_s + buf * B_SZ, wg, n, k0, 0, k, c0, n);
    };
    zero(c);
    pipeline(n_k, stage, [&](int buf) {
      warp_mma<T, false, TRANS>(c, a_s + buf * A_SZ, b_s + buf * B_SZ, wm, wn);
    });
    store_piece<T>(out_tile, n, c, wm, wn, lo - r0, hi - r0, n_cols);
  }
  // rows at or past the last group's end hold zeros
  const int z0 = max(s_off[e], r0);
  if (z0 < rend) {
    zero(c);
    store_piece<T>(out_tile, n, c, wm, wn, z0 - r0, rend - r0, n_cols);
  }
}

// -- tgmm -----------------------------------------------------------------------

// Grid (n tiles, k tiles, groups). Shared memory: two stages of A (x rows of
// the group, [BK][BM]: the product's rows are x's columns) and B (dy rows,
// [BK][BN]).
template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
tgmm_kernel(const T* __restrict__ x, const T* __restrict__ dy, const int* __restrict__ off,
            float* __restrict__ dw, int t, int k, int n) {
  constexpr int BK = bk<T>();
  constexpr int A_SZ = a_elems<T, true>();
  constexpr int B_SZ = b_elems<T, false>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a_s = reinterpret_cast<T*>(smem_raw);
  T* b_s = a_s + STAGES * A_SZ;

  const int c0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int g = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp & 3) * WM;
  const int wn = (warp >> 2) * WN;
  const int lo = min(max(off[g], 0), t);
  const int hi = max(min(off[g + 1], t), lo);
  const int n_q = (hi - lo + BK - 1) / BK;
  auto stage = [&](int it, int buf) {
    const int q0 = lo + it * BK;
    load_tile<T, BK, BM>(a_s + buf * A_SZ, x, k, q0, lo, hi, m0, k);
    load_tile<T, BK, BN>(b_s + buf * B_SZ, dy, n, q0, lo, hi, c0, n);
  };
  float c[2][8][4];
  zero(c);
  pipeline(n_q, stage, [&](int buf) {
    warp_mma<T, true, false>(c, a_s + buf * A_SZ, b_s + buf * B_SZ, wm, wn);
  });
  // an empty group writes its zeros
  store_piece<float>(dw + (size_t)g * k * n + (size_t)m0 * n + c0, n, c, wm, wn, 0,
                     min(BM, k - m0), min(BN, n - c0));
}

// -- launches -------------------------------------------------------------------

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, bool TRANS>
cudaError_t launch_gmm(const void* x, const void* w, const int* off, void* out, int t, int k,
                       int n, int e, cudaStream_t stream) {
  const size_t smem =
      (size_t)STAGES * (a_elems<T, false>() + b_elems<T, TRANS>()) * sizeof(T);
  auto kernel = gmm_kernel<T, TRANS>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((n + BN - 1) / BN, (t + BM - 1) / BM), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), off, static_cast<T*>(out), t, k, n, e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tgmm(const void* x, const void* dy, const int* off, void* dw, int t, int k,
                        int n, int e, cudaStream_t stream) {
  const size_t smem =
      (size_t)STAGES * (a_elems<T, true>() + b_elems<T, false>()) * sizeof(T);
  auto kernel = tgmm_kernel<T>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((n + BN - 1) / BN, (k + BM - 1) / BM, e), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), off, static_cast<float*>(dw), t, k, n);
  return cudaGetLastError();
}

bool bad_shape(int t, int k, int n, int e) {
  return t < 0 || k <= 0 || n <= 0 || e <= 0 || e > MAX_GROUPS || k % 16 || n % 16 ||
         (t + BM - 1) / BM > 65535;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. off: int32 [e + 1] on the device. Each
// returns a cudaError_t value.
int ptt_gmm(const void* x, const void* w, const void* off, void* out, int t, int k, int n, int e,
            int dtype, int trans_w, void* stream) {
  if (bad_shape(t, k, n, e)) return (int)cudaErrorInvalidValue;
  if (t == 0) return 0;
  const int* o = static_cast<const int*>(off);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(trans_w ? launch_gmm<float, true>(x, w, o, out, t, k, n, e, s)
                         : launch_gmm<float, false>(x, w, o, out, t, k, n, e, s));
  if (dtype == 1)
    return (int)(trans_w ? launch_gmm<bf16, true>(x, w, o, out, t, k, n, e, s)
                         : launch_gmm<bf16, false>(x, w, o, out, t, k, n, e, s));
  return (int)cudaErrorInvalidValue;
}

int ptt_tgmm(const void* x, const void* dy, const void* off, void* dw, int t, int k, int n, int e,
             int dtype, void* stream) {
  if (bad_shape(t, k, n, e) || e > 65535) return (int)cudaErrorInvalidValue;
  const int* o = static_cast<const int*>(off);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_tgmm<float>(x, dy, o, dw, t, k, n, e, s);
  if (dtype == 1) return (int)launch_tgmm<bf16>(x, dy, o, dw, t, k, n, e, s);
  return (int)cudaErrorInvalidValue;
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
