// Weight-only quantized GEMM: y = (x @ W) * s for bf16 activations x and
// an int8, nibble-packed int4 or float8 e4m3 weight W with one fp32 scale
// per output channel (Hopper, sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes this in jnp
// (paddle_tpu/quantization/_kernels.py:99 quant_matmul_arrays) and XLA
// fuses the narrow-to-bf16 convert, and the int4 nibble unpack, into the
// dot's operand read, so a quantized decode step reads the narrow bytes
// and nothing else. These kernels are the port of that fusion: a plain
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
// Two kernels, routed by shape in kernels/quant_matmul.py
// (weight_only_gemm_takes), never on failure:
//
// weight_only_gemm_wgmma_kernel takes what TMA can read: K % 8 == 0, the
// weight's rows a multiple of 16 bytes, N % 8 == 0, every base 16-byte
// aligned (every matrix of the served models). It computes y^T = W . x^T:
//   * the weight is wgmma's A operand from registers: a consumer thread
//     loads the two K-adjacent bytes (or the int4 byte) of each of its
//     fragment's values from shared memory with 16-bit (8-bit) loads and
//     converts them with the exact full-rate converts below (load_b); the
//     [N, K] layout keeps the two K positions of a register together;
//   * x is the B operand, K-major through a 128B-swizzled descriptor, and
//     the tokens are wgmma's N: a token tile of 8, 64, 128 or 256 rows
//     (the plan, below). Each weight byte is loaded and converted once a
//     token tile: once on the whole card up to 256 rows (where the plan
//     does not take 128-row tiles to fill the card), 16 times at M =
//     4096, against the mma.sync kernel's 128 (two warps of each of its
//     64 row blocks);
//   * a block is a producer warp and two consumer warpgroups of 64
//     channels (setmaxnreg), or one at the 256 x 64 tile (twice the
//     tiles where 256 x 128 would split K too many ways, as the serving
//     step's 4096-wide products would). The producer keeps TMA loads of
//     the weight tile ([channels, 64 K] as 64 or 32 bytes a row, swizzled over
//     that span, so the fragment loads of a warp hit 8 distinct 16-byte
//     chunks) and of the x tile ([tokens, 64 K], swizzled 128B) in flight
//     through a ring of stages (~200 KB, at most 16 stages) with full and
//     empty mbarriers. A consumer converts the fragments of stage i
//     (16-bit, or 8-bit, shared loads at 32-bit shared addresses) while
//     the wgmma batch of stage i - 1 runs (two register buffers, the
//     same two steps every turn of the loop, so that ptxas keeps the
//     batches asynchronous) and frees a stage once its batch is done. The
//     8-token tile, bound by its loads and converts, runs two blocks an
//     SM (~108 KB each);
//   * split K, deterministically: the plan (kernels/quant_matmul.py
//     weight_only_gemm_plan, passed in) gives the token tile and a split
//     count S <= 8 whose clusters the card holds at once; the S blocks of
//     an output tile form a cluster, block s taking stages [T s / S,
//     T (s + 1) / S) of the T = ceil(K / 64). Each block writes its fp32
//     partial tile into its shared memory (over the ring; a padded pitch
//     keeps the writes conflict-free); after a cluster barrier each block
//     takes 1/S of the tile's 16-byte output chunks, sums the partials of
//     blocks 0 .. S - 1 in that order through distributed shared memory
//     (no atomics: a repeated call, eager or captured, gives the same
//     bits), rounds, scales by the channels' scales (loaded before the k
//     loop), rounds, and stores the chunk;
//   * block b takes split b % S of token tile (b / S) % tiles_m of channel
//     tile b / (S tiles_m): the blocks at work at once share weight tiles,
//     so each is read from device memory about once;
//   * programmatic dependent launch: a launch may start before the kernel
//     ahead of it has finished and waits (griddepcontrol.wait) before it
//     reads anything, so its launch and set-up overlap that kernel's end.

// weight_only_gemm_kernel (mma.sync m16n8k16, bf16 in, fp32 accumulate)
// takes any M, N and K: it is the route for shapes TMA cannot read (an
// odd or unaligned K, a weight row that is no multiple of 16 bytes, an
// unaligned base). A block stages x and W tiles into shared memory with
// cp.async, STAGES deep, as the raw narrow bytes; each warp reads its B
// fragments (two K-adjacent values of one output column) from shared
// memory and converts them to bf16 in registers right before the product.
// WK warps share each output tile, each taking a slice of every K stage,
// and hand their sums to one of them at the end. Two tilings, chosen by
// M: 16 x 32 output tiles with 256-deep K stages and 16 warps for M <= 16
// (four per 8 columns, each a quarter of a stage), 64 x 128 tiles with
// 64-deep stages and 8 warps (2 x 2 over the tile, two along K)
// otherwise. A 16-byte chunk that lies past the matrix or is not 16-byte
// aligned is loaded element by element and zero-filled (an odd-K int4 row
// ends in its zero pad nibble, against a zero-filled x column).
//
// The choices of the wgmma kernel against their alternatives, each built
// and timed in one call: paddle_tpu_torch/tools/quant_gemm_variants.py.
//
// Plain C interface, loaded with ctypes. Launches go on the caller's
// stream and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

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

// Two K-adjacent weights of one output channel, as a bf16x2 fragment
// register (mma.sync's B, wgmma's A; the lower K position in the low
// half). Every convert is exact and uses
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
// cvt<FMT>(raw): raw holds the two bytes (int8, e4m3; the lower K position
// in the low byte) or the one byte (int4) of two K-adjacent weights.
template <int FMT>
__device__ __forceinline__ uint32_t cvt(uint32_t raw);

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 bits_bf162(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

template <>
__device__ __forceinline__ uint32_t cvt<INT8>(uint32_t raw) {
  const uint32_t u = raw ^ 0x8080u;
  const float lo = __uint_as_float(0x4B000000u | (u & 0xFFu)) - 8388736.f;
  const float hi = __uint_as_float(0x4B000000u | (u >> 8)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

template <>
__device__ __forceinline__ uint32_t cvt<INT4>(uint32_t b) {
  const uint32_t t = ((b & 0x0Fu) | ((b & 0xF0u) << 12)) ^ 0x43084308u;
  return bf162_bits(__hsub2(bits_bf162(t), bits_bf162(0x43084308u)));
}

template <>
__device__ __forceinline__ uint32_t cvt<FP8>(uint32_t v) {
  const uint32_t t = ((v & 0x7Fu) << 4) | ((v & 0x80u) << 8) | ((v & 0x7F00u) << 12) |
                     ((v & 0x8000u) << 16);
  return bf162_bits(__hmul2(bits_bf162(t), bits_bf162(0x7B807B80u)));
}

// The raw bits of the K positions k, k + 1 (k even) of a weight row.
template <int FMT>
__device__ __forceinline__ uint32_t raw_at(const uint8_t* row, int k) {
  if constexpr (FMT == INT4)
    return row[k >> 1];  // both nibbles of one byte
  else
    return *reinterpret_cast<const uint16_t*>(row + k);
}

template <int FMT>
__device__ __forceinline__ uint32_t load_b(const uint8_t* row, int k) {
  return cvt<FMT>(raw_at<FMT>(row, k));
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

// -- the wgmma kernel: y^T = W . x^T, W from registers ------------------------------

namespace sm90 {

using namespace hopper;

constexpr int SK_LARGE = 64;           // K positions of a stage: 64-column x panels
constexpr int SK_SMALL = 64;           // the same at the token tiles up to SMALL_TN
constexpr int PRODUCER_REGS = 40;
constexpr int SMALL_TN = 8;            // token tiles up to this run two blocks an SM
constexpr int MAX_STAGES = 16;
constexpr int MAX_SPLITS = 8;          // blocks of a cluster (the portable limit)
constexpr int DEPTH = 2;               // wgmma batches in flight (2 to 4)
constexpr bool EARLY_LAUNCH = true;    // programmatic dependent launch (below)

// A block of CONS consumer warpgroups of 64 channels (wgmma's M) each: a
// tile of BCH channels. A stage: the weight tile [BCH, RB bytes] as RB /
// SPAN boxes of [BCH, SPAN], then the x tile [TN, SK] bf16 as SK / 64
// panels of [TN, 64] (1024-byte aligned, as the 128B swizzle wants).
// After the k loop the partial tile [TN, PITCH] fp32 lies over the ring;
// the barriers follow.
template <int FMT, int TN, int CONS>
struct Layout {
  static constexpr int BCH = 64 * CONS;
  static constexpr int THREADS = 128 * (CONS + 1);
  static constexpr int PITCH = BCH + 4;  // floats of a token's row: conflict-free writes
  // a small token tile's block is bound by its loads and converts: two
  // blocks an SM, each with half the shared memory and registers
  static constexpr int BLOCKS = TN <= SMALL_TN ? 2 : 1;
  // 40 * 128 + CONSUMER_REGS * 128 CONS <= the launch's registers: 384
  // threads at 168 (one block) or 80 (two), 256 at 255
  static constexpr int CONSUMER_REGS = BLOCKS == 1 ? 232 : 96;
  static constexpr int RING_BYTES = BLOCKS == 1 ? 200 * 1024 : 108 * 1024;
  static constexpr int SK = TN <= SMALL_TN ? SK_SMALL : SK_LARGE;
  static constexpr int RB = FMT == INT4 ? SK / 2 : SK;  // weight bytes of a channel in a stage
  static constexpr int SPAN = RB < 128 ? RB : 128;     // bytes of a box row: its swizzle span
  static constexpr int W = BCH * RB;
  static constexpr int X = TN * 2 * SK;
  static constexpr int STAGE = W + X;
  static constexpr int STAGES = RING_BYTES / STAGE < MAX_STAGES ? RING_BYTES / STAGE : MAX_STAGES;
  static constexpr int PART = TN * PITCH * 4;
  static constexpr int BAR = STAGES * STAGE > PART ? STAGES * STAGE : PART;
  static constexpr int BYTES = BAR + 2 * STAGES * 8 + 1024;  // and the alignment to 1024 bytes
  static_assert(W % 1024 == 0 && X % 1024 == 0, "stages keep 1024-byte alignment");
  static_assert(SK % 64 == 0 && RB % SPAN == 0, "a weight row of a stage is whole boxes");
  static_assert(STAGES > DEPTH, "a stage is freed after the batch DEPTH - 1 later is issued");
  static_assert(BYTES * BLOCKS <= 232448, "the ring does not fit");
};

// Shared-memory loads and stores at 32-bit shared addresses: a pointer
// that went through align1024 is generic to the compiler, and generic
// loads take 64-bit address arithmetic and the slower path.
__device__ __forceinline__ uint32_t lds_u8(uint32_t a) {
  uint16_t v;
  asm volatile("ld.shared.u8 %0, [%1];\n" : "=h"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ uint32_t lds_u16(uint32_t a) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ float4 lds_f4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}
__device__ __forceinline__ void sts_f32(uint32_t a, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(a), "f"(v) : "memory");
}

// Programmatic dependent launch: a launch with the attribute may start
// before the kernel ahead of it in the stream has finished, and
// griddepcontrol.wait holds a thread until it has, its writes visible.
// Everything a kernel before may have written (x, the weight, its
// scales) is read, and y written, only after the wait: what the early
// start buys is the launch and the block's set-up (barriers, the tensor
// maps' prefetch). launch_dependents lets the next such launch (the next
// GEMM) start as SMs free up.
__device__ __forceinline__ void grid_dependency_wait() {
  if constexpr (EARLY_LAUNCH) asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void launch_dependents() {
  if constexpr (EARLY_LAUNCH) asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// The A fragment of k16 step kk (K positions 16 kk .. + 15 of the stage)
// for a thread's rows r (shared address w0 in a box of the weight tile,
// the box's base + r SPAN) and r + 8 (w1): {r, 2t}, {r + 8, 2t}, {r,
// 2t + 8}, {r + 8, 2t + 8}, each with its K neighbour. sw: the rows'
// swizzle, ((r SPAN / 128) % (SPAN / 16)) << 4, which moves the 16-byte
// chunks of a box row and keeps the bytes in a chunk.
template <int FMT, int SPAN, int BOX>
__device__ __forceinline__ void fragment(uint32_t (&a)[4], uint32_t w0, uint32_t w1, int sw,
                                         int kk, int t) {
  if constexpr (FMT == INT4) {  // K positions 2j, 2j + 1 in byte j: 8 bytes a k16 step
    const int b = 8 * kk;       // the step's first byte in the row
    const int c = b / SPAN * BOX + ((b % SPAN & ~15) ^ sw) + (b & 15) + t;
    a[0] = cvt<INT4>(lds_u8(w0 + c));
    a[1] = cvt<INT4>(lds_u8(w1 + c));
    a[2] = cvt<INT4>(lds_u8(w0 + c + 4));
    a[3] = cvt<INT4>(lds_u8(w1 + c + 4));
  } else {
    const int b = 16 * kk;
    const int c = b / SPAN * BOX + ((b % SPAN) ^ sw) + 2 * t;
    a[0] = cvt<FMT>(lds_u16(w0 + c));
    a[1] = cvt<FMT>(lds_u16(w1 + c));
    a[2] = cvt<FMT>(lds_u16(w0 + c + 8));
    a[3] = cvt<FMT>(lds_u16(w1 + c + 8));
  }
}

// Grid: splits x tiles_m x tiles_n blocks in clusters of `splits` (see
// the top of the file). tx: x [M, K] bf16, boxes [TN, 64] swizzled 128B;
// tw: W [N, ldw bytes], boxes [BCH, SPAN] swizzled over SPAN.
template <int FMT, int TN, int CONS>
__global__ void __launch_bounds__((Layout<FMT, TN, CONS>::THREADS), (Layout<FMT, TN, CONS>::BLOCKS))
    weight_only_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                                  const __grid_constant__ CUtensorMap tw,
                                  const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
                                  int M, int N, int K, int tiles_m, int splits) {
  using L = Layout<FMT, TN, CONS>;
  constexpr int STAGES = L::STAGES;
  constexpr int SK = L::SK;
  constexpr int CONSUMERS = CONS;
  constexpr int BCH = L::BCH;
  constexpr int PITCH = L::PITCH;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const uint32_t base = smem_u32(sm);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* empty = full + STAGES;
  const int split = blockIdx.x % splits;
  const int tile = blockIdx.x / splits;
  const int m0 = tile % tiles_m * TN;
  const int n0 = tile / tiles_m * BCH;
  const int n_st = (K + SK - 1) / SK;
  const int kb = n_st * split / splits, ke = n_st * (split + 1) / splits;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * CONSUMERS);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  launch_dependents();

  if (wg == CONSUMERS) {  // the producer: one thread issues the loads
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 128 * CONSUMERS) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tw)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tx)) : "memory");
      grid_dependency_wait();
      int st = 0, ph = 0;
      for (int i = kb; i < ke; ++i) {
        mbar_wait_guarded(&empty[st], ph ^ 1);
        mbar_expect_tx(&full[st], L::STAGE);
#pragma unroll
        for (int p = 0; p < L::RB / L::SPAN; ++p)
          tma_load(base + st * L::STAGE + p * BCH * L::SPAN, &tw, &full[st],
                   i * L::RB + p * L::SPAN, n0, 0);
#pragma unroll
        for (int p = 0; p < SK / 64; ++p)
          tma_load(base + st * L::STAGE + L::W + p * TN * 128, &tx, &full[st], i * SK + 64 * p,
                   m0, 0);
        if (++st == STAGES) st = 0, ph ^= 1;
      }
      // every stage freed again before the producer leaves: a consumer
      // stuck on a stage that never fills traps here instead of holding
      // the card
      for (int i = 0; i < STAGES; ++i) {
        mbar_wait_guarded(&empty[st], ph ^ 1);
        if (++st == STAGES) st = 0, ph ^= 1;
      }
    }
    __syncwarp();
    if (splits > 1) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // a consumer: channels n0 + 64 wg .. + 63
  setmaxnreg_inc<L::CONSUMER_REGS>();
  // this thread's 16-byte output chunks (8 channels of a token, below):
  // chunks lo + threadIdx.x + 256 i, always the same 8 channels, whose
  // scales are loaded now, long before the epilogue needs them
  constexpr int PER_TOKEN = BCH / 8;
  constexpr int CHUNKS = TN * PER_TOKEN;
  static_assert((128 * CONSUMERS) % PER_TOKEN == 0, "a thread keeps its channels");
  const int lo = CHUNKS * split / splits, hi = CHUNKS * (split + 1) / splits;
  const int c8 = (lo + (int)threadIdx.x) % PER_TOKEN * 8;
  float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f), s1 = s0;
  grid_dependency_wait();
  if (n0 + c8 < N) {
    s0 = __ldg(reinterpret_cast<const float4*>(scale + n0 + c8));
    s1 = __ldg(reinterpret_cast<const float4*>(scale + n0 + c8 + 4));
  }
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int r0 = 64 * wg + 16 * ((threadIdx.x / 32) & 3) + (lane >> 2);  // and r0 + 8
  const uint32_t o0 = r0 * L::SPAN, o1 = o0 + 8 * L::SPAN;
  const int sw = ((r0 * L::SPAN / 128) % (L::SPAN / 16)) << 4;  // the same for r0 + 8
  float acc[TN / 2];
  zero(acc);
  // DEPTH fragment buffers: a stage's converts are written while the
  // batches of the DEPTH - 1 stages before it run
  uint32_t frag[DEPTH][SK / 16][4];
  int st = 0, ph = 0, rel = 0, n_done = 0, n_freed = 0;
  auto free_stage = [&]() {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[rel]);
    if (++rel == STAGES) rel = 0;
    ++n_freed;
  };
  auto step = [&](uint32_t(&a)[SK / 16][4]) {
    mbar_wait(&full[st], ph);
    const uint32_t wt = base + st * L::STAGE;
#pragma unroll
    for (int kk = 0; kk < SK / 16; ++kk)
      fragment<FMT, L::SPAN, BCH * L::SPAN>(a[kk], wt + o0, wt + o1, sw, kk, t);
    const uint32_t xt = base + st * L::STAGE + L::W;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SK / 16; ++kk) wgmma_rs_kb<TN>(acc, a[kk], kmajor(xt, TN, 0, kk));
    wgmma_commit();
    wgmma_wait<DEPTH - 1>();  // the batch DEPTH - 1 before this one is done: free its stage
    if (++n_done - (DEPTH - 1) > n_freed) free_stage();
    if (++st == STAGES) st = 0, ph ^= 1;
  };
  // the same DEPTH steps in every turn of the loop and the rest nested
  // after it, so that ptxas can see which batches are in flight when a
  // buffer is written (a step that may or may not run would make it
  // serialize the batches)
  int i = kb;
  for (; i + DEPTH <= ke; i += DEPTH) {
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) step(frag[d]);
  }
  if (i < ke) {
    step(frag[0]);
    if constexpr (DEPTH > 2) {
      if (i + 1 < ke) {
        step(frag[1]);
        if constexpr (DEPTH > 3) {
          if (i + 2 < ke) step(frag[2]);
        }
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  while (n_freed < n_done) free_stage();

  // the partial tile over the ring, once both warpgroups are done with it:
  // acc[4 j + e] is channel r0 + 8 (e >> 1), token 8 j + 2 t + (e & 1)
  named_barrier(1, 128 * CONSUMERS);
#pragma unroll
  for (int j = 0; j < TN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sts_f32(base + ((8 * j + 2 * t + (e & 1)) * PITCH + r0 + 8 * (e >> 1)) * 4, acc[4 * j + e]);
  if (splits > 1)
    cluster_sync();
  else
    named_barrier(1, 128 * CONSUMERS);

  // this block's share of the tile's output chunks: the partials summed in
  // block order, rounded to bf16, scaled in fp32, rounded again (four
  // chunks a thread in flight at once)
  const int tok_end = min(TN, M - m0);
  if (n0 + c8 < N) {
#pragma unroll 4
    for (int u = lo + (int)threadIdx.x; u < hi; u += 128 * CONSUMERS) {
      const int tok = u / PER_TOKEN;
      if (tok >= tok_end) break;
      const uint32_t at = base + (tok * PITCH + c8) * 4;
      float4 v0, v1;
      if (splits == 1) {
        v0 = lds_f4(at);
        v1 = lds_f4(at + 16);
      } else {  // every block's loads in flight at once, then the sums in order
        float4 p[MAX_SPLITS][2];
#pragma unroll
        for (int q = 0; q < MAX_SPLITS; ++q)
          if (q < splits) p[q][0] = ld_cluster_f4(at, q), p[q][1] = ld_cluster_f4(at + 16, q);
        v0 = p[0][0];
        v1 = p[0][1];
#pragma unroll
        for (int q = 1; q < MAX_SPLITS; ++q)
          if (q < splits) {
            v0.x += p[q][0].x, v0.y += p[q][0].y, v0.z += p[q][0].z, v0.w += p[q][0].w;
            v1.x += p[q][1].x, v1.y += p[q][1].y, v1.z += p[q][1].z, v1.w += p[q][1].w;
          }
      }
      auto out = [](float v, float s) { return __bfloat162float(__float2bfloat16(v)) * s; };
      uint4 o;
      o.x = pack_bf16(out(v0.x, s0.x), out(v0.y, s0.y));
      o.y = pack_bf16(out(v0.z, s0.z), out(v0.w, s0.w));
      o.z = pack_bf16(out(v1.x, s1.x), out(v1.y, s1.y));
      o.w = pack_bf16(out(v1.z, s1.z), out(v1.w, s1.w));
      *reinterpret_cast<uint4*>(y + (size_t)(m0 + tok) * N + n0 + c8) = o;
    }
  }
  if (splits > 1) cluster_sync();  // no block leaves while another reads its partials
}

// A launch of token tile TN, or (clusters != nullptr) the number of its
// clusters of `splits` blocks that the card holds at once.
struct Call {
  const void *x, *w, *s;
  void* y;
  int M, N, K, ldw, channel_tile, splits;
  cudaStream_t stream;
  int* clusters;
};

template <int FMT, int TN, int CONS>
cudaError_t run(const Call& c) {
  using L = Layout<FMT, TN, CONS>;
  auto kernel = weight_only_gemm_wgmma_kernel<FMT, TN, CONS>;
  static bool attr_set = false;  // set once, before any capture of a launch
  if (!attr_set) {
    const cudaError_t err = prepare(kernel, L::BYTES);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = EARLY_LAUNCH;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = c.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (c.clusters != nullptr) {
    cfg.gridDim = dim3(c.splits);
    return cudaOccupancyMaxActiveClusters(c.clusters, kernel, &cfg);
  }
  cfg.numAttrs = 2;
  if (c.splits > (c.K + L::SK - 1) / L::SK) return cudaErrorInvalidValue;  // a split of no stage
  CUtensorMap tx{}, tw{};
  if (!tensor_map(&tx, c.x, true, c.K, c.M, 1, 64, TN) ||
      !tensor_map_bytes(&tw, c.w, c.ldw, c.N, L::SPAN, L::BCH))
    return cudaErrorInvalidValue;
  const int tiles_m = (c.M + TN - 1) / TN;
  const int tiles_n = (c.N + L::BCH - 1) / L::BCH;
  cfg.gridDim = dim3(c.splits * tiles_m * tiles_n);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, tx, tw, static_cast<const float*>(c.s), static_cast<__nv_bfloat16*>(c.y), c.M,
      c.N, c.K, tiles_m, c.splits);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The instantiations: token tiles 8, 64, 128 and 256 at 128 channels, and
// 256 tokens at 64 (one consumer warpgroup: twice the tiles at the
// 256-token tile's rate, for a serving step that splits few ways).
template <int FMT>
cudaError_t by_tile(int tn, const Call& c) {
  if (c.channel_tile == 64) return tn == 256 ? run<FMT, 256, 1>(c) : cudaErrorInvalidValue;
  if (c.channel_tile != 128) return cudaErrorInvalidValue;
  switch (tn) {
    case 8:
      return run<FMT, 8, 2>(c);
    case 64:
      return run<FMT, 64, 2>(c);
    case 128:
      return run<FMT, 128, 2>(c);
    case 256:
      return run<FMT, 256, 2>(c);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t by_format(int fmt, int tn, const Call& c) {
  if (c.splits < 1 || c.splits > MAX_SPLITS) return cudaErrorInvalidValue;
  switch (fmt) {
    case INT8:
      return by_tile<INT8>(tn, c);
    case INT4:
      return by_tile<INT4>(tn, c);
    case FP8:
      return by_tile<FP8>(tn, c);
    default:
      return cudaErrorInvalidValue;
  }
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace sm90

}  // namespace

extern "C" {

// Both kernels: x [M, K] bf16; w [N, ldw] bytes (fmt 0 int8 and 2 e4m3:
// ldw = K; fmt 1 int4: ldw = ceil(K / 2)); s [N] fp32; y [M, N] bf16.
// Each returns a cudaError_t value.

// The mma.sync kernel: any shape.
int ptt_weight_only_gemm_sm80(const void* x, const void* w, const void* s, void* y, int M, int N,
                              int K, int fmt, int ldw, void* stream) {
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

// The wgmma kernel on the plan (token_tile 8, 64, 128 or 256 at
// channel_tile 128, or 256 at 64; splits 1..8, at most the stages of K);
// refuses what TMA cannot read (K % 8, ldw % 16, N % 8, a base off 16
// bytes).
int ptt_weight_only_gemm_wgmma(const void* x, const void* w, const void* s, void* y, int M, int N,
                               int K, int fmt, int ldw, int token_tile, int channel_tile,
                               int splits, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (M < 0 || N < 0 || K < 1 || K % 8 || ldw % 16 || N % 8 || ldw != (fmt == INT4 ? K / 2 : K) ||
      !sm90::aligned(x) || !sm90::aligned(w) || !sm90::aligned(s) || !sm90::aligned(y))
    return (int)cudaErrorInvalidValue;
  const sm90::Call c{x, w, s, y, M, N, K, ldw, channel_tile, splits,
                     static_cast<cudaStream_t>(stream), nullptr};
  return (int)sm90::by_format(fmt, token_tile, c);
}

// How many clusters of `splits` blocks of the wgmma kernel (fmt,
// token_tile, channel_tile) the card holds at once, into *clusters.
int ptt_weight_only_gemm_clusters(int fmt, int token_tile, int channel_tile, int splits,
                                  int* clusters) {
  const sm90::Call c{nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0, channel_tile, splits,
                     nullptr, clusters};
  return (int)sm90::by_format(fmt, token_tile, c);
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
