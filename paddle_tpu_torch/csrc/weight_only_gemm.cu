// Weight-only quantized GEMM: y = (x @ W) * s for bf16 activations x and
// an int8, nibble-packed int4 or float8 e4m3 weight W with one fp32 scale
// per output channel (Hopper, sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes this in jnp
// (paddle_tpu/quantization/_kernels.py:99 quant_matmul_arrays) and XLA
// fuses the narrow-to-bf16 convert, and the int4 nibble unpack, into the
// dot's operand read, so a quantized decode step reads the narrow bytes
// and nothing else. This kernel is the port of that fusion: a plain
// PyTorch `x @ q.to(bf16)` would write and read a bf16 copy of every
// weight on every step.
//
// Operands (kernels/quant_matmul.py checks them): x [M, K] bf16 row-major;
// W in the port's layout (quantization/_kernels.py), [N, K] int8 or e4m3,
// or [N, ceil(K/2)] int8 holding K positions 2j (low nibble) and 2j + 1
// (high nibble, sign-extended) in byte j; s [N] fp32; y [M, N] bf16. The
// result is rounded to bf16, scaled in fp32 and rounded again, as the
// plain version computes it, so the two differ in summation order only.
//
// Bound on the H100: at decode widths (M = 8) bytes: the weight, 1 byte
// (int8, fp8) or half a byte (int4) a parameter, against 2 for bf16. At
// the serving step (M = 256) and in the prefill (M = 4096) the bf16
// tensor-core operations.
//
// Design: mma.sync m16n8k16 (bf16 in, fp32 accumulate). A block stages
// x and W tiles into shared memory with cp.async, STAGES deep, as the raw
// narrow bytes; each warp reads its B fragments (two K-adjacent values of
// one output column, which the [N, K] layout keeps together) from shared
// memory and converts them to bf16 in registers right before the product.
// WK warps share each output tile, each taking a slice of every K stage,
// and hand their sums to one of them at the end: a decode-shaped call has
// one warp's worth of output columns per 8, too few warps to hide the
// latency of a load-convert-product chain without them. The converts are
// exact and take full-rate instructions (load_b below). The scale is
// applied in the epilogue. Two
// tilings, chosen by M: 16 x 32 output tiles with 256-deep K stages and 16
// warps for M <= 16 (four per 8 columns, each a quarter of a stage: every
// weight byte is loaded and converted once, and a block keeps 24 KB of
// weight in flight), 64 x 128 tiles with 64-deep stages and 8 warps (2 x 2
// over the tile, two along K) otherwise. A 16-byte chunk that lies past
// the matrix or is not 16-byte aligned is loaded element by element and
// zero-filled, so any M, N and K work (an odd-K int4 row ends in its zero
// pad nibble, against a zero-filled x column).
//
// Plain C interface, loaded with ctypes. The launch goes on the caller's
// stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Fmt { INT8 = 0, INT4 = 1, FP8 = 2 };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Two K-adjacent weights of one column, as a bf16x2 B-fragment register
// (the lower K position in the low half). Every convert is exact and uses
// full-rate integer and bf16x2 arithmetic only (an I2F runs at a quarter of
// the rate and was the kernel's limit):
//   int8: u = q + 128 as the low byte of the fp32 2^23 + u, minus 2^23 +
//     128, gives q exactly; a small integer's fp32 has zero low 16 bits, so
//     its top half is its bf16;
//   int4: u = q + 8 (the nibble xor 8) as bf16 128 + u (0x4300 | u, exact
//     in 7 mantissa bits), minus 136 in bf16x2;
//   e4m3: its exponent and mantissa bits placed in a bf16's low exponent
//     and top mantissa bits read as 2^-120 times the value (subnormals
//     too, as bf16 subnormals), times 2^120 in bf16x2. e4m3fn's nan
//     (S.1111.111) would read as 480; the quantizer clips, so none occurs.
template <int FMT>
__device__ __forceinline__ uint32_t load_b(const uint8_t* row, int k);

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 bits_bf162(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

template <>
__device__ __forceinline__ uint32_t load_b<INT8>(const uint8_t* row, int k) {
  const uint32_t u = *reinterpret_cast<const uint16_t*>(row + k) ^ 0x8080u;
  const float lo = __uint_as_float(0x4B000000u | (u & 0xFFu)) - 8388736.f;
  const float hi = __uint_as_float(0x4B000000u | (u >> 8)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

template <>
__device__ __forceinline__ uint32_t load_b<INT4>(const uint8_t* row, int k) {
  const uint32_t b = row[k >> 1];  // k is even: both nibbles of one byte
  const uint32_t t = ((b & 0x0Fu) | ((b & 0xF0u) << 12)) ^ 0x43084308u;
  return bf162_bits(__hsub2(bits_bf162(t), bits_bf162(0x43084308u)));
}

template <>
__device__ __forceinline__ uint32_t load_b<FP8>(const uint8_t* row, int k) {
  const uint32_t v = *reinterpret_cast<const uint16_t*>(row + k);
  const uint32_t t = ((v & 0x7Fu) << 4) | ((v & 0x80u) << 8) | ((v & 0x7F00u) << 12) |
                     ((v & 0x8000u) << 16);
  return bf162_bits(__hmul2(bits_bf162(t), bits_bf162(0x7B807B80u)));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int FMT, int BM, int BN, int BK, int WM, int WN, int WK, int STAGES>
struct Tiling {
  static constexpr int THREADS = 32 * WM * WN * WK;
  static constexpr int KB = FMT == INT4 ? BK / 2 : BK;  // weight bytes of a K stage
  static constexpr int LDA = BK + 8;                     // bf16 elements
  static constexpr int LDB = KB + 16;                    // bytes
  static constexpr int A_BYTES = BM * LDA * 2;
  static constexpr int B_BYTES = BN * LDB;
  static constexpr int SMEM = STAGES * (A_BYTES + B_BYTES);
  static constexpr int MT = BM / WM / 16;  // m16 tiles of a warp
  static constexpr int NT = BN / WN / 8;   // n8 tiles of a warp
  static constexpr int KS = BK / WK;       // K positions of a stage a warp takes
  static_assert(KS % 16 == 0, "a warp's share of a stage is whole k16 steps");
  // the partial sums that warps with wk > 0 hand over, in the stages' space
  static_assert((WK - 1) * WM * WN * MT * NT * 4 * 32 * 4 <= SMEM, "reduction space");
};

// One K stage of x ([BM, BK] bf16) and W ([BN, KB] bytes) into shared
// memory. vec_x / vec_w: the rows allow 16-byte cp.async (aligned base
// and row stride); otherwise, and for chunks that cross the matrix's
// edge, element loads with zero fill.
template <int FMT, int BM, int BN, int BK, int WM, int WN, int WK, int STAGES>
__device__ __forceinline__ void load_stage(__nv_bfloat16* As, uint8_t* Bs, const __nv_bfloat16* x,
                                           const uint8_t* w, int m0, int n0, int kt, int M, int N,
                                           int K, int ldw, bool vec_x, bool vec_w) {
  using T = Tiling<FMT, BM, BN, BK, WM, WN, WK, STAGES>;
  constexpr int A_CPR = BK / 8;  // 16-byte chunks of an x row
  for (int c = threadIdx.x; c < BM * A_CPR; c += T::THREADS) {
    const int r = c / A_CPR, e = (c % A_CPR) * 8;
    const int m = m0 + r, k = kt * BK + e;
    __nv_bfloat16* dst = As + r * T::LDA + e;
    if (vec_x && m < M && k + 8 <= K) {
      cp_async16(dst, x + (size_t)m * K + k);
    } else {
      for (int i = 0; i < 8; ++i)
        dst[i] = (m < M && k + i < K) ? x[(size_t)m * K + k + i] : __float2bfloat16(0.f);
    }
  }
  constexpr int B_CPR = T::KB / 16;
  for (int c = threadIdx.x; c < BN * B_CPR; c += T::THREADS) {
    const int r = c / B_CPR, e = (c % B_CPR) * 16;
    const int n = n0 + r, kb = kt * T::KB + e;
    uint8_t* dst = Bs + r * T::LDB + e;
    if (vec_w && n < N && kb + 16 <= ldw) {
      cp_async16(dst, w + (size_t)n * ldw + kb);
    } else {
      for (int i = 0; i < 16; ++i) dst[i] = (n < N && kb + i < ldw) ? w[(size_t)n * ldw + kb + i] : 0;
    }
  }
}

template <int FMT, int BM, int BN, int BK, int WM, int WN, int WK, int STAGES>
__global__ void __launch_bounds__(32 * WM * WN * WK)
    weight_only_gemm_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
                            const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int M,
                            int N, int K, int ldw, int vec_x, int vec_w) {
  using T = Tiling<FMT, BM, BN, BK, WM, WN, WK, STAGES>;
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* Bs = smem + STAGES * T::A_BYTES;

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wk = warp / (WM * WN), wmn = warp % (WM * WN);
  const int wm = wmn / WN, wn = wmn % WN;
  const int g = lane / 4, t = lane % 4;
  const int KT = (K + BK - 1) / BK;

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT)
      load_stage<FMT, BM, BN, BK, WM, WN, WK, STAGES>(As + s * (T::A_BYTES / 2),
                                                      Bs + s * T::B_BYTES, x, w, m0, n0, s, M, N,
                                                      K, ldw, vec_x, vec_w);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; every warp is done with stage kt - 1
    const int nk = kt + STAGES - 1;
    if (nk < KT) {
      const int ns = nk % STAGES;
      load_stage<FMT, BM, BN, BK, WM, WN, WK, STAGES>(As + ns * (T::A_BYTES / 2),
                                                      Bs + ns * T::B_BYTES, x, w, m0, n0, nk, M,
                                                      N, K, ldw, vec_x, vec_w);
    }
    cp_async_commit();

    const int st = kt % STAGES;
    const __nv_bfloat16* a_st = As + st * (T::A_BYTES / 2);
    const uint8_t* b_st = Bs + st * T::B_BYTES;
#pragma unroll
    for (int k16 = 0; k16 < T::KS; k16 += 16) {
      const int kk = wk * T::KS + k16;
      uint32_t a[T::MT][4];
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        const __nv_bfloat16* r0 = a_st + (wm * (BM / WM) + i * 16 + g) * T::LDA + kk + 2 * t;
        const __nv_bfloat16* r1 = r0 + 8 * T::LDA;
        a[i][0] = *reinterpret_cast<const uint32_t*>(r0);
        a[i][1] = *reinterpret_cast<const uint32_t*>(r1);
        a[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
        a[i][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
      }
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const uint8_t* row = b_st + (wn * (BN / WN) + j * 8 + g) * T::LDB;
        const int k = kk + 2 * t;  // K position within the stage
        const uint32_t b[2] = {load_b<FMT>(row, k), load_b<FMT>(row, k + 8)};
#pragma unroll
        for (int i = 0; i < T::MT; ++i) mma_bf16(acc[i][j], a[i], b);
      }
    }
  }
  cp_async_wait<0>();

  if (WK > 1) {
    // warps with wk > 0 summed other K positions of the same outputs: they
    // hand their sums to the wk == 0 warp through shared memory
    __syncthreads();  // every warp is done reading the stages
    float* red = reinterpret_cast<float*>(smem);
    constexpr int PER_WARP = T::MT * T::NT * 4 * 32;
    if (wk > 0) {
      float* dst = red + ((wk - 1) * WM * WN + wmn) * PER_WARP + lane;
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int j = 0; j < T::NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dst[((i * T::NT + j) * 4 + e) * 32] = acc[i][j][e];
    }
    __syncthreads();
    if (wk > 0) return;
#pragma unroll
    for (int o = 0; o < WK - 1; ++o) {
      const float* src = red + (o * WM * WN + wmn) * PER_WARP + lane;
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int j = 0; j < T::NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += src[((i * T::NT + j) * 4 + e) * 32];
    }
  }

  // epilogue: round to bf16, scale in fp32, round again (the plain version's
  // arithmetic)
#pragma unroll
  for (int j = 0; j < T::NT; ++j) {
    const int n = n0 + wn * (BN / WN) + j * 8 + 2 * t;
    const float s0 = n < N ? scale[n] : 0.f;
    const float s1 = n + 1 < N ? scale[n + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < T::MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * (BM / WM) + i * 16 + g + 8 * h;
        if (m >= M) continue;
        const float v0 = __bfloat162float(__float2bfloat16(acc[i][j][2 * h])) * s0;
        const float v1 = __bfloat162float(__float2bfloat16(acc[i][j][2 * h + 1])) * s1;
        if (n < N) y[(size_t)m * N + n] = __float2bfloat16(v0);
        if (n + 1 < N) y[(size_t)m * N + n + 1] = __float2bfloat16(v1);
      }
    }
  }
}

template <int FMT, int BM, int BN, int BK, int WM, int WN, int WK, int STAGES>
int launch(const void* x, const void* w, const void* s, void* y, int M, int N, int K, int ldw,
           cudaStream_t stream) {
  using T = Tiling<FMT, BM, BN, BK, WM, WN, WK, STAGES>;
  auto kernel = weight_only_gemm_kernel<FMT, BM, BN, BK, WM, WN, WK, STAGES>;
  static bool attr_set = false;  // set once, before any capture of a launch
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const bool vec_x = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (K % 8 == 0);
  const bool vec_w = (reinterpret_cast<uintptr_t>(w) % 16 == 0) && (ldw % 16 == 0);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(s), static_cast<__nv_bfloat16*>(y), M, N, K, ldw, vec_x, vec_w);
  return (int)cudaGetLastError();
}

template <int FMT>
int dispatch(const void* x, const void* w, const void* s, void* y, int M, int N, int K, int ldw,
             cudaStream_t stream) {
  if (M <= 16) return launch<FMT, 16, 32, 256, 1, 4, 4, 4>(x, w, s, y, M, N, K, ldw, stream);
  return launch<FMT, 64, 128, 64, 2, 2, 2, 4>(x, w, s, y, M, N, K, ldw, stream);
}

}  // namespace

extern "C" {

// x: [M, K] bf16; w: [N, ldw] bytes (fmt 0 int8 and 2 e4m3: ldw = K;
// fmt 1 int4: ldw = ceil(K / 2)); s: [N] fp32; y: [M, N] bf16. Returns a
// cudaError_t value.
int ptt_weight_only_gemm(const void* x, const void* w, const void* s, void* y, int M, int N, int K,
                         int fmt, int ldw, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (M < 0 || N < 0 || K < 1 || ldw < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case INT8:
      return dispatch<INT8>(x, w, s, y, M, N, K, ldw, st);
    case INT4:
      return dispatch<INT4>(x, w, s, y, M, N, K, ldw, st);
    case FP8:
      return dispatch<FP8>(x, w, s, y, M, N, K, ldw, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
