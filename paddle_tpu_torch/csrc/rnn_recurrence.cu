// The recurrence of the stacked RNNs and the RNN cells, forward and
// backward (Hopper, sm_90a).
//
// No TPU kernel: the JAX package's SimpleRNN, LSTM and GRU run each layer
// and direction as one jax.lax.scan (paddle_tpu/nn/layer/rnn.py:281-302),
// which XLA compiles into one loop on the device; its body is the step of
// rnn.py:30-58. In eager PyTorch that body is about a dozen launches a
// step. Here the input term of every step (x . W_ih^T plus the biases
// that fold into it) is one product before the loop, and the recurrence
// is the kernels below: the recurrent product h_{t-1} . W_hh^T and the gate
// arithmetic, fp32 FMAs throughout, as the JAX scan computes (kernels/rnn.py
// holds the plain version beside it and says what each mode computes):
//   lstm (gates i, f, g, o): c = sig(f) c' + sig(i) tanh(g); h = sig(o) tanh(c)
//   gru (r, z, c): r = sig(x_r + h_r); z = sig(x_z + h_z);
//                  n = tanh(x_c + r (h'.W_c + b_hc)); h = (1 - z) n + z h'
//                  (b_hc stays inside the reset product: it cannot fold)
//   rnn_tanh, rnn_relu: h = act(x + h'.W)
// with sig(x) = 1 / (1 + exp(-x)).
//
// Bound on the H100, a step of one LSTM layer at B 128, H 512, each way:
// the recurrent product is 2.128.512.2048 = 268 MFLOP, 4.0 us at the 67
// TFLOP/s fp32 FMA peak; W_hh (4.2 MB) is read once a step (1.25 us from
// HBM at 3.35 TB/s), so the product's operations bound it.
//
// Forward: two kernels, chosen by kernels/rnn.py's rnn_forward_plan.
//
// Both give a thread 8 rows by 2 units and every gate of those units (64
// fp32 accumulators for the lstm): per 4 of the product's depth a thread
// loads 8 float4 of h and 2 G float4 of W_hh from shared memory for 64 G
// FMAs. A warp owns 32 rows by 16 units (threads 4 x 8; unit tx and tx +
// 8, so that a quarter-warp's W_hh rows fall in distinct banks at a row
// stride of 4 (mod 32) floats); a block's 8 warps split the product's
// depth, and their sums are added in warp order through shared memory (a
// float4 of gates a pair), so a block owns whole units and the gate
// arithmetic and the cell update stay in its epilogue.
//
// rnn_fwd_persistent_kernel, for T > 1: one launch for the whole sequence,
// one block of 32 rows by 16 units an SM, all co-resident (a cooperative
// launch, after the occupancy query confirms it). A block loads its units'
// rows of W_hh (all G gates by H) into shared memory once and keeps them
// for every step; each step a warp streams its depth of h_{t-1} for the 32
// rows from L2 through cp.async in H_PARTS parts (the later ones in flight
// while the first are multiplied). The carry of a block's (row, unit)
// pairs (c, and h for the gru) stays in registers; the next step's input
// terms are loaded before the barrier. A block reads only its own 32 rows
// of h_{t-1}, which the blocks of its row group (the same blockIdx.y)
// write, so each row group has its own barrier: h_t stored,
// __syncthreads, one release add (red.release.gpu) to the group's step
// counter, a word the wrapper zeroes on the same stream (so a captured
// graph zeroes it on every replay), then an acquire spin until every
// block of the group has arrived. LSTM at B 128, H 512: 4 row groups of
// 32 blocks, 129 KB of W_hh and 66 KB of h (or of the sums) each. A shape
// whose slice does not fit in 227 KB, or whose grid exceeds the SMs, goes
// to the step kernel by the plan, decided before the launch: no barrier
// ever waits on a block that is not running.
//
// rnn_fwd_step_kernel<WM>, for T = 1 (the decoder cell, the beam step) and
// for what the persistent kernel cannot hold: one launch a step; WM warps
// along the rows (a block 32 WM rows by 16 units) by 8 / WM along the
// depth. Tiles of h and W_hh, 128 of the depth, pass through a ring of
// three shared-memory stages filled by cp.async (16-byte copies where H %
// 4 == 0, else 4-byte), the later stages' loads in flight while a stage's
// FMAs run; the epilogue's inputs (the input terms, c', h') are loaded
// before the product. The plan takes 64 rows a block where that still
// gives every SM a block (the beam step's 1280 rows), else 32 (the
// decoder cell's 128).
//
// Backward: from dh_t (the output's gradient plus the recurrent one) and
// dc_t a step computes the gate gradients dgates_t, elementwise from what
// the forward saved (written to dxw: the weight product after the loop
// reads them), then dh_{t-1} = dgates_t . W_hh (+ dh_t z for the gru) and
// dc_{t-1} = dc f. Two routes, chosen by kernels/rnn.py's
// rnn_backward_plan; each computes a (row, unit) pair's gate gradients
// once (the earlier kernel rebuilt every row's in every column block).
//
// rnn_bwd_persistent_kernel, where it fits (at any T: at T = 1 too, where
// it beat the step route at the decoder cell): one cooperative launch for
// the sequence on the forward's grid (32 rows by 16 units a block, one an SM,
// all co-resident), with the forward's resident slice of W_hh: the block's
// 16 units' G gate rows by H in shared memory for every step. A step:
//   1. the gate gradients of the block's own (row, unit) pairs, from their
//      saved values (loaded ahead, before the previous barrier); dc stays
//      in registers;
//   2. the block's partial dh_{t-1} over all H for its 32 rows: the
//      product over its 16 G gate rows (the depth it owns), a thread 8
//      rows by 8 columns, both operands from shared memory (a float4 of
//      the rows' gradients, broadcast, and a float4 of W_hh a row), stored
//      to part[step % 2][row group][block] (32 x HP floats);
//   3. the row group's barrier (the forward's: red.release, acquire spin,
//      counters zeroed by the wrapper on the stream);
//   4. the block's own pairs of dh_{t-1}: the row group's partials added
//      in block order (two halves, then the halves), read past L1.
// Partials ping-pong by the step's parity, so one barrier a step is
// enough: a block writes a buffer again only after every block of its
// group has passed the next barrier, that is, has read it. LSTM at B 128,
// H 512: a block writes 64 KB and reads 64 KB a step (about 8 MB each
// over the 128 blocks), against the ~71 MB the earlier kernel staged.
//
// For what the persistent kernel cannot hold (the beam step's 1280 rows,
// H % 4 != 0, a W_hh slice past 227 KB), two launches a step: rnn_bwd_gates_kernel (a thread
// a pair: dxw_t, the gru's dhc_t, the lstm's dc_{t-1}), then
// rnn_bwd_step_kernel, the product read from dxw_t: a block 32 rows by 64
// columns of dh_{t-1}, a thread 8 rows by 8 columns (two float4 of W_hh
// and one of the gradients, broadcast, per 32 FMAs), its 8 warps splitting
// each 128-deep stage of a ring of three cp.async stages, their sums added
// in warp order. 64-row tiles (2 warps along the rows) measured no faster
// at the decoder cell and 8% slower at the beam step.
// The weight and bias gradients are sums over every step, one product
// each after the loop (kernels/rnn.py, torch.matmul over T.B rows).
//
// No float atomics: every sum runs in a fixed order, so two runs give the
// same bits, and a captured step its eager step's.
//
// Plain C interface, loaded with ctypes. Each entry point launches on the
// caller's stream and returns a cudaError_t value.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

enum Mode { LSTM = 0, GRU = 1, RNN_TANH = 2, RNN_RELU = 3 };

template <int MODE>
struct Gates {
  static constexpr int G = MODE == LSTM ? 4 : (MODE == GRU ? 3 : 1);
};

// forward: 8 warps a block, a warp 32 rows by 16 units
constexpr int F_THREADS = 256;
constexpr int F_UNITS = 16;
constexpr int F_ROWS = 32;
constexpr int F_KC = 128;      // the step kernel: depth a stage
constexpr int H_PARTS = 2;     // the persistent kernel: parts of a warp's h a step
constexpr int F_RED = 8 * F_ROWS * F_UNITS * 4;   // floats of the warps' sums
constexpr int F_STAGES = 3;    // the step kernel's ring
// The step kernel's blocks: WM warps of 32 rows by 16 units, 8 / WM along
// the depth; a stage's floats.
__host__ __device__ constexpr int step_stage(int G, int WM) {
  return (F_ROWS * WM + F_UNITS * G) * (F_KC + 4);
}
// The backward's step kernel: a block's tile is S_ROWS rows by S_COLS
// columns, its warps S_WM along the rows by S_WK along the depth; a stage
// holds 128 of the depth of the rows of the gate gradients and 128 rows by
// S_COLS columns of W_hh; the warps' sums take S_WK x S_ROWS x S_COLS
// floats.
constexpr int S_ROWS = 32, S_COLS = 64;
constexpr int S_WM = S_ROWS / F_ROWS, S_WK = 8 / S_WM;   // warps along the rows, the depth
__host__ __device__ constexpr int bwd_step_stage() {
  return S_ROWS * (F_KC + 4) + F_KC * S_COLS;
}
constexpr int bwd_step_floats() {
  return F_STAGES * bwd_step_stage() > S_WK * S_ROWS * S_COLS ? F_STAGES * bwd_step_stage()
                                                               : S_WK * S_ROWS * S_COLS;
}

__device__ __forceinline__ float sig(float x) { return 1.f / (1.f + expf(-x)); }

// -- cp.async ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes, or zeros where !ok (no bytes read)
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// at most n (0 to 3) groups still in flight
__device__ __forceinline__ void cp_wait_upto(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    default: cp_wait<3>(); break;
  }
}

// Rows [0, nrows) by columns [k0, k0 + kc) of a row-major fp32 matrix whose
// row r starts at rowp(r) (null: past the edge) into dst [nrows][ld], zero
// past the edges (rows, and columns from H), by threads t of nt. 16-byte
// copies where vec (H % 4 == 0, k0 % 4 == 0, kc % 4 == 0), else 4-byte.
template <class RowPtr>
__device__ __forceinline__ void load_tile(float* dst, int ld, int nrows, RowPtr rowp, int k0,
                                          int kc, int H, bool vec, int t, int nt,
                                          const float* any) {
  if (vec) {
    const int cpr = kc >> 2;
    for (int c = t; c < nrows * cpr; c += nt) {
      const int r = c / cpr, kk = (c - r * cpr) << 2;
      const float* p = rowp(r);
      const bool ok = p != nullptr && k0 + kk < H;
      cp16(dst + r * ld + kk, ok ? p + k0 + kk : any, ok);
    }
  } else {
    for (int c = t; c < nrows * kc; c += nt) {
      const int r = c / kc, kk = c - r * kc;
      const float* p = rowp(r);
      const bool ok = p != nullptr && k0 + kk < H;
      cp4(dst + r * ld + kk, ok ? p + k0 + kk : any, ok);
    }
  }
}

// -- the forward's pieces -----------------------------------------------------------

// acc[i][e][g] += sum over k in [k0, k1) (k1 - k0 a multiple of 4) of
// h[ty 8 + i][k] W[g 16 + tx + 8 e][k]: hs the warp's 32 rows (row stride
// sh), ws the block's 16 G rows of W_hh (row stride sw), in k order.
template <int G>
__device__ __forceinline__ void warp_fma(float (&acc)[8][2][G], const float* hs, int sh,
                                         const float* ws, int sw, int k0, int k1, int ty,
                                         int tx) {
  const float* hp = hs + ty * 8 * sh;
  const float* wp = ws + tx * sw;
#pragma unroll 2
  for (int k = k0; k < k1; k += 4) {
    float4 w4[G][2];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        w4[g][e] = *reinterpret_cast<const float4*>(wp + (g * F_UNITS + 8 * e) * sw + k);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 h4 = *reinterpret_cast<const float4*>(hp + i * sh + k);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float a = acc[i][e][g];
          a = fmaf(h4.x, w4[g][e].x, a);
          a = fmaf(h4.y, w4[g][e].y, a);
          a = fmaf(h4.z, w4[g][e].z, a);
          a = fmaf(h4.w, w4[g][e].w, a);
          acc[i][e][g] = a;
        }
    }
  }
}

// A warp's sums into red, a float4 of gates a (row, unit):
// red[((wk R + row) 16 + unit) 4 + g], R the block's rows, wk the warp's
// place along the depth, row0 its first row (a quarter-warp writes 128
// contiguous bytes).
template <int G>
__device__ __forceinline__ void put_sums(float* red, const float (&acc)[8][2][G], int wk, int R,
                                         int row0, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float4 v;
      v.x = acc[i][e][0];
      v.y = G > 1 ? acc[i][e][G > 1 ? 1 : 0] : 0.f;
      v.z = G > 2 ? acc[i][e][G > 2 ? 2 : 0] : 0.f;
      v.w = G > 3 ? acc[i][e][G > 3 ? 3 : 0] : 0.f;
      *reinterpret_cast<float4*>(red + ((wk * R + row0 + ty * 8 + i) * F_UNITS + tx + 8 * e) * 4) =
          v;
    }
}

// The product's sums of (row, unit) for each gate, the WK warps' added in
// warp order.
template <int WK>
__device__ __forceinline__ void get_sums(float (&a)[4], const float* red, int R, int row,
                                         int u) {
#pragma unroll
  for (int w = 0; w < WK; ++w) {
    const float4 v = *reinterpret_cast<const float4*>(red + ((w * R + row) * F_UNITS + u) * 4);
    a[0] += v.x;
    a[1] += v.y;
    a[2] += v.z;
    a[3] += v.w;
  }
}

// The cell update of one (row, unit) pair from the product's sums a, the
// input terms x (one a gate), the gru's b_hc, the carry c' and h'; the new
// h and c, and s: what the backward reads (lstm i, f, g, o; gru r, z, n, hc).
template <int MODE>
__device__ __forceinline__ void cell(const float (&a)[4], const float (&x)[4], float bhc,
                                     float cp, float hp, float& h, float& c, float (&s)[4]) {
  if constexpr (MODE == LSTM) {
    s[0] = sig(x[0] + a[0]);
    s[1] = sig(x[1] + a[1]);
    s[2] = tanhf(x[2] + a[2]);
    s[3] = sig(x[3] + a[3]);
    c = s[1] * cp + s[0] * s[2];
    h = s[3] * tanhf(c);
  } else if constexpr (MODE == GRU) {
    s[3] = a[2] + bhc;
    s[0] = sig(x[0] + a[0]);
    s[1] = sig(x[1] + a[1]);
    s[2] = tanhf(x[2] + s[0] * s[3]);
    h = (1.f - s[1]) * s[2] + s[1] * hp;
  } else {
    const float v = x[0] + a[0];
    h = MODE == RNN_TANH ? tanhf(v) : fmaxf(v, 0.f);
  }
}

// Writes a pair's results, o = b H + j, so = b 4 H + j: h into y_t (the
// step's slice of y), c into cs_t (lstm), what the backward reads into
// saved_t (lstm, gru: [B, 4 H]), and h_fin / c_fin where given.
template <int MODE>
__device__ __forceinline__ void put_pair(int64_t o, int64_t so, int H, float h, float c,
                                         const float (&s)[4], float* y_t, float* cs_t,
                                         float* saved_t, float* h_fin, float* c_fin) {
  y_t[o] = h;
  if (h_fin) h_fin[o] = h;
  if constexpr (MODE == LSTM) {
    cs_t[o] = c;
    if (c_fin) c_fin[o] = c;
  }
  if constexpr (MODE == LSTM || MODE == GRU) {
#pragma unroll
    for (int g = 0; g < 4; ++g) saved_t[so + g * H] = s[g];
  }
}

// Shared memory of the two kernels, bytes (kernels/rnn.py's plan computes
// the same).
constexpr int step_floats(int G, int WM) {
  return F_STAGES * step_stage(G, WM) > F_RED ? F_STAGES * step_stage(G, WM) : F_RED;
}
// HP: H rounded up to 128; a row of the resident slice and of h holds HP + 4
inline int persistent_floats(int G, int HP) {
  const int h = F_ROWS * (HP + 4);
  return F_UNITS * G * (HP + 4) + (h > F_RED ? h : F_RED);
}

// -- the step kernel ----------------------------------------------------------------

// Grid: (units / 16, rows / (32 WM)). One step: h_t (and c_t, saved) of
// rows [b0, b0 + 32 WM) by units [j0, j0 + 16).
template <int MODE, int WM>
__global__ void __launch_bounds__(F_THREADS, 1)
rnn_fwd_step_kernel(const float* __restrict__ xw, const float* __restrict__ h_prev,
                    const float* __restrict__ c_prev, const float* __restrict__ w_hh,
                    const float* __restrict__ b_hc, float* __restrict__ y,
                    float* __restrict__ cs, float* __restrict__ saved,
                    float* __restrict__ h_fin, float* __restrict__ c_fin, int B, int H) {
  constexpr int G = Gates<MODE>::G;
  constexpr int WK = 8 / WM;
  constexpr int R = F_ROWS * WM;
  constexpr int NS = F_STAGES;
  constexpr int KC = F_KC, KW = F_KC / WK;      // depth a stage, and a warp's share
  constexpr int LD = KC + 4;                    // 4 (mod 32) x an odd number of floats
  constexpr int STAGE = step_stage(G, WM);
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % WM, wk = warp / WM;
  const int ty = lane >> 3, tx = lane & 7;
  const int b0 = blockIdx.y * R, j0 = blockIdx.x * F_UNITS;
  const bool vec = (H & 3) == 0;
  auto hrow = [&](int r) -> const float* {
    return b0 + r < B ? h_prev + (int64_t)(b0 + r) * H : nullptr;
  };
  auto wrow = [&](int col) -> const float* {   // [G][16 units]
    const int j = j0 + col % F_UNITS;
    return j < H ? w_hh + ((int64_t)(col / F_UNITS) * H + j) * H : nullptr;
  };
  auto load = [&](int s) {
    float* st = smem + (s % NS) * STAGE;
    load_tile(st, LD, R, hrow, s * KC, KC, H, vec, tid, F_THREADS, w_hh);
    load_tile(st + R * LD, LD, F_UNITS * G, wrow, s * KC, KC, H, vec, tid, F_THREADS, w_hh);
  };
  const int ns = (H + KC - 1) / KC;
  float acc[8][2][G];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int g = 0; g < G; ++g) acc[i][e][g] = 0.f;
  // the epilogue's inputs of this thread's (row, unit) pairs, loaded ahead
  // of the product so that their latency hides under it
  constexpr int PAIRS = R * F_UNITS / F_THREADS;
  float xv[PAIRS][4], cpv[PAIRS], hpv[PAIRS], bv[PAIRS];
#pragma unroll
  for (int q = 0; q < PAIRS; ++q) {
    const int p = tid + q * F_THREADS, b = b0 + p / F_UNITS, j = j0 + p % F_UNITS;
    const bool ok = b < B && j < H;
    const int64_t o = (int64_t)b * H + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) xv[q][g] = ok && g < G ? xw[(int64_t)b * G * H + g * H + j] : 0.f;
    cpv[q] = ok && MODE == LSTM ? c_prev[o] : 0.f;
    hpv[q] = ok && MODE == GRU ? h_prev[o] : 0.f;
    bv[q] = ok && MODE == GRU && b_hc ? b_hc[j] : 0.f;
  }
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < ns) load(s);
    cp_commit();
  }
  for (int s = 0; s < ns; ++s) {
    cp_wait<NS - 2>();
    __syncthreads();  // stage s landed for every thread; stage s - 1 is free
    if (s + NS - 1 < ns) load(s + NS - 1);
    cp_commit();
    const float* st = smem + (s % NS) * STAGE;
    warp_fma<G>(acc, st + wm * F_ROWS * LD, LD, st + R * LD, LD, wk * KW, wk * KW + KW, ty, tx);
  }
  cp_wait<0>();
  __syncthreads();
  put_sums<G>(smem, acc, wk, R, wm * F_ROWS, ty, tx);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < PAIRS; ++q) {
    const int p = tid + q * F_THREADS, r = p / F_UNITS, u = p % F_UNITS;
    const int b = b0 + r, j = j0 + u;
    if (b >= B || j >= H) continue;
    float a[4] = {0.f, 0.f, 0.f, 0.f}, s[4] = {0.f, 0.f, 0.f, 0.f}, h, c = 0.f;
    get_sums<WK>(a, smem, R, r, u);
    cell<MODE>(a, xv[q], bv[q], cpv[q], hpv[q], h, c, s);
    put_pair<MODE>((int64_t)b * H + j, (int64_t)b * 4 * H + j, H, h, c, s, y, cs, saved, h_fin,
                   c_fin);
  }
}

// -- the persistent kernel ----------------------------------------------------------

// Every block of a group arrives at its counter once its threads' writes
// are done (release); the `target`-th arrival ends the wait (acquire).
__device__ __forceinline__ void group_barrier(unsigned* counter, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter) : "memory");
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(counter) : "memory");
    } while (v < target);
  }
  __syncthreads();
}

// Grid: (units / 16, rows / 32), all co-resident. The T steps of rows [b0,
// b0 + 32) by units [j0, j0 + 16); counter a zeroed word a row group.
template <int MODE>
__global__ void __launch_bounds__(F_THREADS, 1)
rnn_fwd_persistent_kernel(const float* __restrict__ xw, const float* __restrict__ h0,
                          const float* __restrict__ c0, const float* __restrict__ w_hh,
                          const float* __restrict__ b_hc, float* y, float* __restrict__ cs,
                          float* __restrict__ saved, float* __restrict__ h_fin,
                          float* __restrict__ c_fin, unsigned* counter, int T, int B, int H,
                          int HP, int reverse) {
  constexpr int G = Gates<MODE>::G;
  constexpr int PAIRS = F_ROWS * F_UNITS / F_THREADS;   // a thread's (row, unit) pairs
  extern __shared__ __align__(16) float smem[];
  const int ld = HP + 4;              // 4 (mod 32) x an odd number of floats
  float* ws = smem;                   // [16 G][ld]: the units' rows of W_hh
  float* hs = smem + F_UNITS * G * ld;  // [32][ld]: h_{t-1}; then the warps' sums
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = lane >> 3, tx = lane & 7;
  const int b0 = blockIdx.y * F_ROWS, j0 = blockIdx.x * F_UNITS;
  unsigned* group_counter = counter + blockIdx.y;
  const bool vec = (H & 3) == 0;
  load_tile(ws, ld, F_UNITS * G, [&](int col) -> const float* {
    const int j = j0 + col % F_UNITS;
    return j < H ? w_hh + ((int64_t)(col / F_UNITS) * H + j) * H : nullptr;
  }, 0, HP, H, vec, tid, F_THREADS, w_hh);
  cp_commit();

  int pb[PAIRS], pj[PAIRS];
  bool pv[PAIRS];
  float hc[PAIRS], cc[PAIRS], xv[PAIRS][4];
#pragma unroll
  for (int q = 0; q < PAIRS; ++q) {
    const int p = tid + q * F_THREADS;
    pb[q] = b0 + p / F_UNITS;
    pj[q] = j0 + p % F_UNITS;
    pv[q] = pb[q] < B && pj[q] < H;
    const int64_t o = (int64_t)pb[q] * H + pj[q];
    hc[q] = pv[q] && MODE == GRU ? h0[o] : 0.f;
    cc[q] = pv[q] && MODE == LSTM ? c0[o] : 0.f;
  }
  // the input terms of step t, loaded ahead of the step
  auto load_x = [&](int t) {
#pragma unroll
    for (int q = 0; q < PAIRS; ++q) {
      const float* xr = xw + ((int64_t)t * B + pb[q]) * G * H + pj[q];
#pragma unroll
      for (int g = 0; g < 4; ++g) xv[q][g] = (g < G && pv[q]) ? xr[g * H] : 0.f;
    }
  };
  load_x(reverse ? T - 1 : 0);
  cp_wait<0>();
  __syncthreads();

  const int kw = HP / 8, part = kw / H_PARTS, kb = warp * kw;
  for (int step = 0; step < T; ++step) {
    const int t = reverse ? T - 1 - step : step;
    const float* hsrc = step == 0 ? h0 : y + (int64_t)(reverse ? t + 1 : t - 1) * B * H;
    auto hrow = [&](int r) -> const float* {
      return b0 + r < B ? hsrc + (int64_t)(b0 + r) * H : nullptr;
    };
    // this warp's depth of h_{t-1} in parts, each multiplied as it lands
    // while the later ones are in flight
#pragma unroll
    for (int q = 0; q < H_PARTS; ++q) {
      load_tile(hs + kb + q * part, ld, F_ROWS, hrow, kb + q * part, part, H, vec, lane, 32,
                w_hh);
      cp_commit();
    }
    float acc[8][2][G];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int g = 0; g < G; ++g) acc[i][e][g] = 0.f;
#pragma unroll
    for (int q = 0; q < H_PARTS; ++q) {
      cp_wait_upto(H_PARTS - 1 - q);
      __syncwarp();
      warp_fma<G>(acc, hs, ld, ws, ld, kb + q * part, kb + (q + 1) * part, ty, tx);
    }
    __syncthreads();  // every warp is done with h_{t-1}
    put_sums<G>(hs, acc, warp, F_ROWS, 0, ty, tx);
    __syncthreads();
    const bool last = step == T - 1;
#pragma unroll
    for (int q = 0; q < PAIRS; ++q) {
      if (!pv[q]) continue;
      const int p = tid + q * F_THREADS;
      float a[4] = {0.f, 0.f, 0.f, 0.f}, s[4] = {0.f, 0.f, 0.f, 0.f}, h, c = 0.f;
      get_sums<8>(a, hs, F_ROWS, p / F_UNITS, p % F_UNITS);
      cell<MODE>(a, xv[q], (MODE == GRU && b_hc) ? b_hc[pj[q]] : 0.f, cc[q], hc[q], h, c, s);
      const int64_t bh = (int64_t)t * B * H;
      put_pair<MODE>((int64_t)pb[q] * H + pj[q], (int64_t)pb[q] * 4 * H + pj[q], H, h, c, s,
                     y + bh, MODE == LSTM ? cs + bh : nullptr,
                     MODE == LSTM || MODE == GRU ? saved + 4 * bh : nullptr,
                     last ? h_fin : nullptr, last ? c_fin : nullptr);
      hc[q] = h;
      cc[q] = c;
    }
    if (!last) {
      load_x(reverse ? t - 1 : t + 1);
      group_barrier(group_counter, (unsigned)(step + 1) * gridDim.x);
    }
  }
}

// -- the backward's pieces ----------------------------------------------------------

// What the backward reads of one (row, unit) pair at a step, besides the
// recurrent gradients: dy, then lstm: i, f, g, o, c_t, c_{t-1}; gru: r, z,
// n, hc, h_{t-1}; the simple RNN: h_t.
template <int MODE>
struct PairIn {
  static constexpr int N = MODE == LSTM ? 7 : (MODE == GRU ? 6 : 2);
};

// v: the pair's PairIn values at step t (o = b H + j, so = b 4 H + j, bh =
// t B H, bhp = tp B H for tp the forward's previous step; where first, the
// forward's first step, h0 / c0 instead); zeros where !ok.
template <int MODE>
__device__ __forceinline__ void pair_in(float (&v)[PairIn<MODE>::N], bool ok, int64_t o,
                                        int64_t so, int64_t bh, int64_t bhp, bool first, int H,
                                        const float* dy, const float* saved, const float* cs,
                                        const float* h0, const float* c0, const float* y) {
#pragma unroll
  for (int i = 0; i < PairIn<MODE>::N; ++i) v[i] = 0.f;
  if (!ok) return;
  v[0] = dy ? dy[bh + o] : 0.f;
  if constexpr (MODE == LSTM || MODE == GRU) {
    const float* sv = saved + 4 * bh + so;
#pragma unroll
    for (int g = 0; g < 4; ++g) v[1 + g] = sv[g * H];
  }
  if constexpr (MODE == LSTM) {
    v[5] = cs[bh + o];
    v[6] = first ? c0[o] : cs[bhp + o];
  } else if constexpr (MODE == GRU) {
    v[5] = first ? h0[o] : y[bhp + o];
  } else {
    v[1] = y[bh + o];
  }
}

// The gate gradients of one pair from dh (the output's gradient plus the
// recurrent one), the carried dc (lstm) and its PairIn values: x the
// input side's (what dxw holds), d the hidden side's (the product's
// operand: the gru's candidate term is da_n r, dhc), dc_prev = dc f (lstm),
// gz = dh z (gru: dh_{t-1}'s elementwise term).
template <int MODE>
__device__ __forceinline__ void pair_grads(const float (&v)[PairIn<MODE>::N], float dh, float dc_in,
                                           float (&x)[Gates<MODE>::G],
                                           float (&d)[Gates<MODE>::G], float& dc_prev,
                                           float& gz) {
  if constexpr (MODE == LSTM) {
    const float si = v[1], sf = v[2], tg = v[3], so = v[4];
    const float tc = tanhf(v[5]);
    const float dc = dc_in + dh * so * (1.f - tc * tc);
    x[0] = d[0] = dc * tg * si * (1.f - si);
    x[1] = d[1] = dc * v[6] * sf * (1.f - sf);
    x[2] = d[2] = dc * si * (1.f - tg * tg);
    x[3] = d[3] = dh * tc * so * (1.f - so);
    dc_prev = dc * sf;
  } else if constexpr (MODE == GRU) {
    const float r_ = v[1], z = v[2], n = v[3], hc = v[4];
    const float dan = dh * (1.f - z) * (1.f - n * n);
    x[0] = d[0] = dan * hc * r_ * (1.f - r_);
    x[1] = d[1] = dh * (v[5] - n) * z * (1.f - z);
    x[2] = dan;
    d[2] = dan * r_;
    gz = dh * z;
  } else {
    const float h = v[1];
    x[0] = d[0] = MODE == RNN_TANH ? dh * (1.f - h * h) : (h > 0.f ? dh : 0.f);
  }
}

// Writes a pair's input-side gate gradients (dxw_t [B, G H] at b G H + j)
// and the gru's hidden-side candidate term (dhc_t [B, H] at o).
template <int MODE>
__device__ __forceinline__ void put_grads(const float (&x)[Gates<MODE>::G],
                                          const float (&d)[Gates<MODE>::G], int64_t b, int j,
                                          int64_t o, int H, float* dxw_t, float* dhc_t) {
  constexpr int G = Gates<MODE>::G;
  float* dr = dxw_t + b * G * H + j;
#pragma unroll
  for (int g = 0; g < G; ++g) dr[g * H] = x[g];
  if constexpr (MODE == GRU) dhc_t[o] = d[2];
}

// acc[i][e][c] += sum over k < D of dg[k][i] ws[k][col_e + c] for the NE
// column groups: dg the rows' gradients (row stride F_ROWS, from this
// thread's 8 rows), ws the block's W_hh rows (row stride ld).
template <int D, int NE>
__device__ __forceinline__ void partial_product(float (&acc)[8][2][4], const float* dg,
                                                const float* ws, int ld, int col0, int col1) {
#pragma unroll 16
  for (int k = 0; k < D; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(dg + k * F_ROWS);
    const float4 a1 = *reinterpret_cast<const float4*>(dg + k * F_ROWS + 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const float4 w = *reinterpret_cast<const float4*>(ws + k * ld + (e ? col1 : col0));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][e][0] = fmaf(a[i], w.x, acc[i][e][0]);
        acc[i][e][1] = fmaf(a[i], w.y, acc[i][e][1]);
        acc[i][e][2] = fmaf(a[i], w.z, acc[i][e][2]);
        acc[i][e][3] = fmaf(a[i], w.w, acc[i][e][3]);
      }
    }
  }
}

// Shared memory of the persistent backward, floats: the block's rows of
// W_hh [16 G][HP + 4], the rows' hidden-side gate gradients [16 G][32]
// and the two halves' sums of the partials [2][32][16] (kernels/rnn.py's
// plan computes the same).
constexpr int P_RED = 2 * F_ROWS * F_UNITS;
inline int bwd_persistent_floats(int G, int HP) {
  return F_UNITS * G * (HP + 4) + F_UNITS * G * F_ROWS + P_RED;
}

// -- the persistent backward ----------------------------------------------------------

// Grid: (units / 16, rows / 32), all co-resident: the forward's blocks.
// The T steps from the last, for rows [b0, b0 + 32) by units [j0, j0 +
// 16): the block's units' gate gradients, then its partial dh_{t-1} over
// all H (the product over its 16 G gate rows of W_hh) into part[step % 2]
// [row group][block][32][HP], the row group's barrier, then its own pairs
// of dh_{t-1}: the group's partials added in block order.
template <int MODE>
__global__ void __launch_bounds__(F_THREADS, 1)
rnn_bwd_persistent_kernel(const float* __restrict__ dy, const float* __restrict__ dhT,
                          const float* __restrict__ dcT, const float* __restrict__ saved,
                          const float* __restrict__ cs, const float* __restrict__ h0,
                          const float* __restrict__ c0, const float* __restrict__ y,
                          const float* __restrict__ w_hh, float* __restrict__ dxw,
                          float* __restrict__ dhc, float* part, float* __restrict__ dh0,
                          float* __restrict__ dc0, unsigned* counter, int T, int B, int H,
                          int HP, int reverse) {
  constexpr int G = Gates<MODE>::G;
  constexpr int D = F_UNITS * G;                        // the product's depth
  constexpr int PAIRS = F_ROWS * F_UNITS / F_THREADS;   // a thread's (row, unit) pairs
  constexpr int NV = PairIn<MODE>::N;
  extern __shared__ __align__(16) float smem[];
  const int ld = HP + 4;
  float* ws = smem;                 // [D][ld]: the units' rows of W_hh
  float* dg = ws + D * ld;          // [D][32]: the rows' hidden-side gate gradients
  float* red = dg + D * F_ROWS;     // [2][32][16]: the two halves' sums
  const int tid = threadIdx.x;
  const int b0 = blockIdx.y * F_ROWS, j0 = blockIdx.x * F_UNITS;
  const int nbx = gridDim.x;
  unsigned* row_counter = counter + blockIdx.y;
  load_tile(ws, ld, D, [&](int col) -> const float* {
    const int j = j0 + col % F_UNITS;
    return j < H ? w_hh + ((int64_t)(col / F_UNITS) * H + j) * H : nullptr;
  }, 0, HP, H, true, tid, F_THREADS, w_hh);
  cp_commit();

  const int64_t BH = (int64_t)B * H;
  int pr[PAIRS], pu[PAIRS];
  bool pv[PAIRS];
  float dh_rec[PAIRS], dc_rec[PAIRS], gz[PAIRS], in[PAIRS][NV];
#pragma unroll
  for (int q = 0; q < PAIRS; ++q) {
    const int p = tid + q * F_THREADS;
    pr[q] = p / F_UNITS;
    pu[q] = p % F_UNITS;
    pv[q] = b0 + pr[q] < B && j0 + pu[q] < H;
    const int64_t o = (int64_t)(b0 + pr[q]) * H + j0 + pu[q];
    dh_rec[q] = pv[q] && dhT ? dhT[o] : 0.f;
    dc_rec[q] = pv[q] && dcT ? dcT[o] : 0.f;
    gz[q] = 0.f;
  }
  // the inputs of step t, loaded ahead of the step
  auto load_in = [&](int t) {
    const bool first = t == (reverse ? T - 1 : 0);
    const int64_t bhp = (int64_t)(reverse ? t + 1 : t - 1) * BH;
#pragma unroll
    for (int q = 0; q < PAIRS; ++q) {
      const int b = b0 + pr[q], j = j0 + pu[q];
      pair_in<MODE>(in[q], pv[q], (int64_t)b * H + j, (int64_t)b * 4 * H + j, (int64_t)t * BH,
                    bhp, first, H, dy, saved, cs, h0, c0, y);
    }
  };
  load_in(reverse ? 0 : T - 1);
  cp_wait<0>();
  __syncthreads();

  // the product's threads: rows ty 8 .. ty 8 + 7, columns c0 + 4 tx + 256 e
  // (a warp's 128 columns lie all below HP or all past it)
  const int tx = tid & 63, ty = tid >> 6;
  const size_t group = (size_t)F_ROWS * HP;                     // a block's partials
  const size_t parity = (size_t)gridDim.y * nbx * group;
  for (int step = 0; step < T; ++step) {
    const int t = reverse ? step : T - 1 - step;
    const bool last = step == T - 1;
    // 1. the gate gradients of the block's pairs
#pragma unroll
    for (int q = 0; q < PAIRS; ++q) {
      float x[G], d[G], dcp = 0.f;
      pair_grads<MODE>(in[q], in[q][0] + dh_rec[q], dc_rec[q], x, d, dcp, gz[q]);
      const int b = b0 + pr[q], j = j0 + pu[q];
      if (pv[q])
        put_grads<MODE>(x, d, b, j, (int64_t)b * H + j, H, dxw + (int64_t)t * G * BH,
                        MODE == GRU ? dhc + (int64_t)t * BH : nullptr);
      dc_rec[q] = dcp;
#pragma unroll
      for (int g = 0; g < G; ++g) dg[(g * F_UNITS + pu[q]) * F_ROWS + pr[q]] = pv[q] ? d[g] : 0.f;
    }
    __syncthreads();
    // 2. the partial dh_{t-1} of the block's rows over all H
    float* pp = part + (step & 1) * parity + ((size_t)blockIdx.y * nbx + blockIdx.x) * group;
    for (int cb = 0; cb < HP; cb += 512) {
      const int col[2] = {cb + 4 * tx, cb + 256 + 4 * tx};
      const bool on[2] = {col[0] < HP, col[1] < HP};
      float acc[8][2][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][e][c] = 0.f;
      // the column groups a warp covers (warp-uniform), as a constant of
      // the loop: no branch inside it
      if (on[1])
        partial_product<D, 2>(acc, dg + ty * 8, ws, ld, col[0], col[1]);
      else if (on[0])
        partial_product<D, 1>(acc, dg + ty * 8, ws, ld, col[0], col[1]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (!on[e]) continue;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          __stcg(reinterpret_cast<float4*>(pp + (size_t)(ty * 8 + i) * HP + col[e]),
                 make_float4(acc[i][e][0], acc[i][e][1], acc[i][e][2], acc[i][e][3]));
      }
    }
    // 3. the next step's inputs, ahead of the barrier
    if (!last) load_in(reverse ? t + 1 : t - 1);
    group_barrier(row_counter, (unsigned)(step + 1) * nbx);
    // 4. the block's pairs of dh_{t-1}: the row group's partials in block
    // order, in two halves (threads 0-127 the first, 128-255 the second),
    // then the halves added
    {
      const int h = tid >> 7, it = tid & 127, r = it >> 2, qd = it & 3;
      const int mid = (nbx + 1) >> 1, lo = h ? mid : 0, hi = h ? nbx : mid;
      const float* src = part + (step & 1) * parity + (size_t)blockIdx.y * nbx * group +
                         (size_t)r * HP + j0 + 4 * qd;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int x0 = lo; x0 < hi; x0 += 8) {
        float4 v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (x0 + k < hi) v[k] = __ldcg(reinterpret_cast<const float4*>(src + (x0 + k) * group));
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (x0 + k < hi) {
            s.x += v[k].x;
            s.y += v[k].y;
            s.z += v[k].z;
            s.w += v[k].w;
          }
      }
      *reinterpret_cast<float4*>(red + (h * F_ROWS + r) * F_UNITS + 4 * qd) = s;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < PAIRS; ++q) {
      const int i = pr[q] * F_UNITS + pu[q];
      float v = red[i] + red[F_ROWS * F_UNITS + i];
      if constexpr (MODE == GRU) v += gz[q];
      dh_rec[q] = v;
      if (last && pv[q]) {
        const int64_t o = (int64_t)(b0 + pr[q]) * H + j0 + pu[q];
        dh0[o] = v;
        if constexpr (MODE == LSTM) dc0[o] = dc_rec[q];
      }
    }
  }
}

// -- the step route's two kernels ------------------------------------------------------

// One step's gate gradients, a thread a (row, unit) pair: dxw_t, the gru's
// dhc_t (da_n r) and the lstm's dc_{t-1}.
template <int MODE>
__global__ void __launch_bounds__(256)
rnn_bwd_gates_kernel(const float* __restrict__ dy_t, const float* __restrict__ dh_in,
                     const float* __restrict__ dc_in, const float* __restrict__ saved_t,
                     const float* __restrict__ c_t, const float* __restrict__ c_prev,
                     const float* __restrict__ h_prev, const float* __restrict__ y_t,
                     float* __restrict__ dxw_t, float* __restrict__ dhc_t,
                     float* __restrict__ dc_out, int B, int H) {
  constexpr int G = Gates<MODE>::G;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)B * H) return;
  const int64_t b = i / H;
  const int j = (int)(i - b * H);
  // pair_in's values at bh = 0 with the step's own slices (cs = c_t for
  // c_t, c_prev and h_prev given as "first")
  float v[PairIn<MODE>::N];
  pair_in<MODE>(v, true, i, b * 4 * H + j, 0, 0, true, H, dy_t, saved_t, c_t, h_prev, c_prev,
                y_t);
  float x[G], d[G], dcp = 0.f, gz = 0.f;
  pair_grads<MODE>(v, v[0] + (dh_in ? dh_in[i] : 0.f), dc_in ? dc_in[i] : 0.f, x, d, dcp, gz);
  put_grads<MODE>(x, d, b, j, i, H, dxw_t, dhc_t);
  if constexpr (MODE == LSTM) dc_out[i] = dcp;
}

// One step's dh_{t-1} = dgates_t . W_hh (+ dh_t z for the gru): the
// hidden-side gate gradients A [B, G H] (dxw_t; the gru's third gate from
// dhc_t) by W_hh [G H, H]. Grid: (H / 64 column tiles, rows / 32): a
// block computes a 32 x 64 tile over the whole depth, 128 deep a stage;
// its 8 warps split each stage's depth (S_WM = 1, S_WK = 8), a thread 8
// rows by 8 columns (a float4 of A broadcast to a quarter-warp, two of
// W_hh a depth). Tiles pass through a ring of three cp.async stages. The
// depth warps' sums are added in warp order.
template <int MODE>
__global__ void __launch_bounds__(F_THREADS, 1)
rnn_bwd_step_kernel(const float* __restrict__ dxw_t, const float* __restrict__ dhc_t,
                    const float* __restrict__ w_hh, const float* __restrict__ dy_t,
                    const float* __restrict__ dh_in, const float* __restrict__ saved_t,
                    float* __restrict__ dh_out, int B, int H) {
  constexpr int G = Gates<MODE>::G;
  constexpr int NS = F_STAGES;
  constexpr int KC = F_KC, KW = F_KC / S_WK;
  constexpr int LDA = KC + 4, LDW = S_COLS;
  constexpr int STAGE = bwd_step_stage();
  constexpr int TILE = S_ROWS * S_COLS;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % S_WM, wk = warp / S_WM;
  const int ty = lane >> 3, tx = lane & 7;
  const int b0 = blockIdx.y * S_ROWS, n0 = blockIdx.x * S_COLS;
  const int GH = G * H;
  const bool vec = (H & 3) == 0;
  const int ns = (GH + KC - 1) / KC;   // the depth's stages
  // A[b][d]: the gru's third gate from dhc_t
  auto aptr = [&](int b, int d) -> const float* {
    if (MODE == GRU && d >= 2 * H) return dhc_t + (int64_t)b * H + (d - 2 * H);
    return dxw_t + (int64_t)b * GH + d;
  };
  auto load = [&](int s) {
    float* st = smem + (s % NS) * STAGE;
    float* ws = st + S_ROWS * LDA;
    const int d0 = s * KC;
    if (vec) {
      for (int c = tid; c < S_ROWS * (KC / 4); c += F_THREADS) {
        const int r = c / (KC / 4), kk = (c % (KC / 4)) * 4;
        const bool ok = b0 + r < B && d0 + kk < GH;
        cp16(st + r * LDA + kk, ok ? aptr(b0 + r, d0 + kk) : w_hh, ok);
      }
      for (int c = tid; c < KC * (S_COLS / 4); c += F_THREADS) {
        const int kk = c / (S_COLS / 4), n = (c % (S_COLS / 4)) * 4;
        const bool ok = d0 + kk < GH && n0 + n < H;
        cp16(ws + kk * LDW + n, ok ? w_hh + (int64_t)(d0 + kk) * H + n0 + n : w_hh, ok);
      }
    } else {
      for (int c = tid; c < S_ROWS * KC; c += F_THREADS) {
        const int r = c / KC, kk = c % KC;
        const bool ok = b0 + r < B && d0 + kk < GH;
        cp4(st + r * LDA + kk, ok ? aptr(b0 + r, d0 + kk) : w_hh, ok);
      }
      for (int c = tid; c < KC * S_COLS; c += F_THREADS) {
        const int kk = c / S_COLS, n = c % S_COLS;
        const bool ok = d0 + kk < GH && n0 + n < H;
        cp4(ws + kk * LDW + n, ok ? w_hh + (int64_t)(d0 + kk) * H + n0 + n : w_hh, ok);
      }
    }
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < ns) load(s);
    cp_commit();
  }
  for (int s = 0; s < ns; ++s) {
    cp_wait<NS - 2>();
    __syncthreads();  // stage s landed for every thread; stage s - 1 is free
    if (s + NS - 1 < ns) load(s + NS - 1);
    cp_commit();
    const float* as = smem + (s % NS) * STAGE + (wm * F_ROWS + ty * 8) * LDA;
    const float* ws = smem + (s % NS) * STAGE + S_ROWS * LDA + 4 * tx;
#pragma unroll
    for (int k = wk * KW; k < wk * KW + KW; k += 4) {
      float4 w[4][2];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        w[kk][0] = *reinterpret_cast<const float4*>(ws + (k + kk) * LDW);
        w[kk][1] = *reinterpret_cast<const float4*>(ws + (k + kk) * LDW + 32);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a4 = *reinterpret_cast<const float4*>(as + i * LDA + k);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            acc[i][4 * e + 0] = fmaf(a[kk], w[kk][e].x, acc[i][4 * e + 0]);
            acc[i][4 * e + 1] = fmaf(a[kk], w[kk][e].y, acc[i][4 * e + 1]);
            acc[i][4 * e + 2] = fmaf(a[kk], w[kk][e].z, acc[i][4 * e + 2]);
            acc[i][4 * e + 3] = fmaf(a[kk], w[kk][e].w, acc[i][4 * e + 3]);
          }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();
  // the depth warps' sums, red[wk][row][column], added in warp order
  float* red = smem;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float4*>(red + wk * TILE + (wm * F_ROWS + ty * 8 + i) * S_COLS + 32 * e +
                                 4 * tx) =
          make_float4(acc[i][4 * e], acc[i][4 * e + 1], acc[i][4 * e + 2], acc[i][4 * e + 3]);
  __syncthreads();
  for (int v = tid; v < TILE / 4; v += F_THREADS) {
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < S_WK; ++w) {
      const float4 r4 = *reinterpret_cast<const float4*>(red + w * TILE + 4 * v);
      t.x += r4.x;
      t.y += r4.y;
      t.z += r4.z;
      t.w += r4.w;
    }
    const int r = v / (S_COLS / 4), c = (v % (S_COLS / 4)) * 4;
    const int b = b0 + r;
    if (b >= B) continue;
    const float v4[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = n0 + c + e;
      if (k >= H) continue;
      const int64_t o = (int64_t)b * H + k;
      float v = v4[e];
      if constexpr (MODE == GRU) {
        const float dh = (dy_t ? dy_t[o] : 0.f) + (dh_in ? dh_in[o] : 0.f);
        v += dh * saved_t[(int64_t)b * 4 * H + H + k];
      }
      dh_out[o] = v;
    }
  }
}

template <int MODE, int WM>
int forward_steps(const float* xw, const float* h0, const float* c0, const float* w_hh,
                  const float* b_hc, float* y, float* cs, float* saved, float* h_fin,
                  float* c_fin, int T, int B, int H, int reverse, cudaStream_t s) {
  constexpr int G = Gates<MODE>::G;
  const int smem = step_floats(G, WM) * (int)sizeof(float);
  auto kernel = rnn_fwd_step_kernel<MODE, WM>;
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  const dim3 grid((H + F_UNITS - 1) / F_UNITS, (B + F_ROWS * WM - 1) / (F_ROWS * WM));
  const int64_t bh = (int64_t)B * H;
  for (int step = 0; step < T; ++step) {
    const int t = reverse ? T - 1 - step : step;
    const int tp = reverse ? t + 1 : t - 1;
    const bool last = step == T - 1;
    const float* hp = step == 0 ? h0 : y + tp * bh;
    const float* cp = MODE == LSTM ? (step == 0 ? c0 : cs + tp * bh) : nullptr;
    kernel<<<grid, F_THREADS, smem, s>>>(
        xw + t * bh * G, hp, cp, w_hh, b_hc, y + t * bh, MODE == LSTM ? cs + t * bh : nullptr,
        saved ? saved + t * bh * 4 : nullptr, last ? h_fin : nullptr,
        last && MODE == LSTM ? c_fin : nullptr, B, H);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

// One cooperative launch for the T steps; refused (an error, never another
// route) where H % 4 != 0 or the grid cannot be co-resident.
template <int MODE>
int forward_persistent(const float* xw, const float* h0, const float* c0, const float* w_hh,
                       const float* b_hc, float* y, float* cs, float* saved, float* h_fin,
                       float* c_fin, unsigned* counter, int T, int B, int H, int reverse,
                       cudaStream_t s) {
  constexpr int G = Gates<MODE>::G;
  if ((H & 3) != 0 || counter == nullptr) return (int)cudaErrorInvalidValue;
  const int HP = (H + 127) / 128 * 128;
  const int smem = persistent_floats(G, HP) * (int)sizeof(float);
  auto kernel = rnn_fwd_persistent_kernel<MODE>;
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  const dim3 grid((H + F_UNITS - 1) / F_UNITS, (B + F_ROWS - 1) / F_ROWS);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return err;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, F_THREADS,
                                                                 smem)))
    return err;
  if ((int64_t)per_sm * sms < (int64_t)grid.x * grid.y)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(F_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, xw, h0, c0, w_hh, b_hc, y, cs, saved, h_fin, c_fin,
                                counter, T, B, H, HP, reverse);
  if (err) return err;
  return (int)cudaGetLastError();
}

// route 1: the persistent kernel; route 0: the step kernel with wm (1 or
// 2) warps along the rows.
template <int MODE>
int forward(const float* xw, const float* h0, const float* c0, const float* w_hh,
            const float* b_hc, float* y, float* cs, float* saved, float* h_fin, float* c_fin,
            unsigned* counter, int T, int B, int H, int reverse, int route, int wm,
            cudaStream_t s) {
  if (route == 1)
    return forward_persistent<MODE>(xw, h0, c0, w_hh, b_hc, y, cs, saved, h_fin, c_fin, counter,
                                    T, B, H, reverse, s);
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (wm == 1)
    return forward_steps<MODE, 1>(xw, h0, c0, w_hh, b_hc, y, cs, saved, h_fin, c_fin, T, B, H,
                                  reverse, s);
  if (wm == 2)
    return forward_steps<MODE, 2>(xw, h0, c0, w_hh, b_hc, y, cs, saved, h_fin, c_fin, T, B, H,
                                  reverse, s);
  return (int)cudaErrorInvalidValue;
}

// The step route: two launches a step from the last, the gate gradients
// then the product.
template <int MODE>
int backward_steps(const float* dy, const float* dhT, const float* dcT, const float* saved,
                   const float* cs_, const float* h0, const float* c0, const float* y,
                   const float* w_hh, float* dxw, float* dhc, float* scratch, float* dh0,
                   float* dc0, int T, int B, int H, int reverse, cudaStream_t s) {
  constexpr int G = Gates<MODE>::G;
  const int smem = bwd_step_floats() * (int)sizeof(float);
  auto product = rnn_bwd_step_kernel<MODE>;
  int err = (int)cudaFuncSetAttribute(product, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  const dim3 grid((H + S_COLS - 1) / S_COLS, (B + S_ROWS - 1) / S_ROWS);
  const int64_t bh = (int64_t)B * H;
  const unsigned pairs = (unsigned)((bh + 255) / 256);
  // ping-pong: the recurrent gradients a step reads and the next writes
  float* dh_buf[2] = {scratch, scratch + bh};
  float* dc_buf[2] = {scratch + 2 * bh, scratch + 3 * bh};
  const float* dh_in = dhT;
  const float* dc_in = dcT;
  for (int step = T - 1; step >= 0; --step) {
    const int t = reverse ? T - 1 - step : step;
    const int tp = reverse ? t + 1 : t - 1;
    const int w = step & 1;
    float* dh_out = step == 0 ? dh0 : dh_buf[w];
    float* dc_out = MODE == LSTM ? (step == 0 ? dc0 : dc_buf[w]) : nullptr;
    const float* hp = step == 0 ? h0 : y + tp * bh;
    const float* cp = MODE == LSTM ? (step == 0 ? c0 : cs_ + tp * bh) : nullptr;
    const float* dy_t = dy ? dy + t * bh : nullptr;
    const float* saved_t = saved ? saved + t * bh * 4 : nullptr;
    float* dhc_t = MODE == GRU ? dhc + t * bh : nullptr;
    rnn_bwd_gates_kernel<MODE><<<pairs, 256, 0, s>>>(
        dy_t, dh_in, dc_in, saved_t, MODE == LSTM ? cs_ + t * bh : nullptr, cp, hp, y + t * bh,
        dxw + t * bh * G, dhc_t, dc_out, B, H);
    if ((err = (int)cudaGetLastError())) return err;
    product<<<grid, F_THREADS, smem, s>>>(dxw + t * bh * G, dhc_t, w_hh, dy_t, dh_in, saved_t,
                                          dh_out, B, H);
    if ((err = (int)cudaGetLastError())) return err;
    dh_in = dh_out;
    dc_in = dc_out;
  }
  return 0;
}

// The persistent route: one cooperative launch for the T steps; refused
// (an error, never another route) where H % 4 != 0 or the grid cannot be
// co-resident. part: 2 x ceil(B / 32) x ceil(H / 16) x 32 x HP floats.
template <int MODE>
int backward_persistent(const float* dy, const float* dhT, const float* dcT, const float* saved,
                        const float* cs, const float* h0, const float* c0, const float* y,
                        const float* w_hh, float* dxw, float* dhc, float* part, float* dh0,
                        float* dc0, unsigned* counter, int T, int B, int H, int reverse,
                        cudaStream_t s) {
  constexpr int G = Gates<MODE>::G;
  if ((H & 3) != 0 || counter == nullptr) return (int)cudaErrorInvalidValue;
  const int HP = (H + 127) / 128 * 128;
  const int smem = bwd_persistent_floats(G, HP) * (int)sizeof(float);
  auto kernel = rnn_bwd_persistent_kernel<MODE>;
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  const dim3 grid((H + F_UNITS - 1) / F_UNITS, (B + F_ROWS - 1) / F_ROWS);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return err;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, F_THREADS,
                                                                 smem)))
    return err;
  if ((int64_t)per_sm * sms < (int64_t)grid.x * grid.y)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(F_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, dy, dhT, dcT, saved, cs, h0, c0, y, w_hh, dxw, dhc,
                                part, dh0, dc0, counter, T, B, H, HP, reverse);
  if (err) return err;
  return (int)cudaGetLastError();
}

// route 1: the persistent kernel (scratch: its partials); route 0: the
// step kernels (scratch [4, B, H]).
template <int MODE>
int backward(const float* dy, const float* dhT, const float* dcT, const float* saved,
             const float* cs, const float* h0, const float* c0, const float* y,
             const float* w_hh, float* dxw, float* dhc, float* scratch, float* dh0, float* dc0,
             unsigned* counter, int T, int B, int H, int reverse, int route, cudaStream_t s) {
  if (route == 1)
    return backward_persistent<MODE>(dy, dhT, dcT, saved, cs, h0, c0, y, w_hh, dxw, dhc,
                                     scratch, dh0, dc0, counter, T, B, H, reverse, s);
  if (route != 0) return (int)cudaErrorInvalidValue;
  return backward_steps<MODE>(dy, dhT, dcT, saved, cs, h0, c0, y, w_hh, dxw, dhc, scratch, dh0,
                              dc0, T, B, H, reverse, s);
}


}  // namespace

extern "C" {

// mode: 0 lstm, 1 gru, 2 rnn_tanh, 3 rnn_relu. xw [T, B, G H] (the input
// term of every step, in time order); h0, c0 (lstm) [B, H]; w_hh [G H, H];
// b_hc [H] (gru, may be null); written: y [T, B, H] (h_t at its time
// index), cs [T, B, H] (lstm: c_t), saved [T, B, 4 H] (lstm, gru), h_fin
// and c_fin (lstm) [B, H] (the last step's). reverse: the steps run from
// T - 1 down to 0. route 1: the persistent kernel, one launch (counter:
// ceil(B / 32) zeroed uint32 on the device, one a row group); route 0: the
// step kernel with wm (1 or 2) warps along the rows, T launches. All
// float32, contiguous. Returns a cudaError_t value.
int ptt_rnn_forward(int mode, const void* xw, const void* h0, const void* c0,
                    const void* w_hh, const void* b_hc, void* y, void* cs, void* saved,
                    void* h_fin, void* c_fin, void* counter, int T, int B, int H, int reverse,
                    int route, int wm, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a[5] = {static_cast<const float*>(xw), static_cast<const float*>(h0),
                       static_cast<const float*>(c0), static_cast<const float*>(w_hh),
                       static_cast<const float*>(b_hc)};
  float* o[5] = {static_cast<float*>(y), static_cast<float*>(cs), static_cast<float*>(saved),
                 static_cast<float*>(h_fin), static_cast<float*>(c_fin)};
  unsigned* ctr = static_cast<unsigned*>(counter);
  switch (mode) {
    case LSTM:
      if (!a[2] || !o[1] || !o[2] || !o[4]) return (int)cudaErrorInvalidValue;
      return forward<LSTM>(a[0], a[1], a[2], a[3], a[4], o[0], o[1], o[2], o[3], o[4], ctr, T, B,
                           H, reverse, route, wm, s);
    case GRU:
      if (!o[2]) return (int)cudaErrorInvalidValue;
      return forward<GRU>(a[0], a[1], a[2], a[3], a[4], o[0], o[1], o[2], o[3], o[4], ctr, T, B,
                          H, reverse, route, wm, s);
    case RNN_TANH:
      return forward<RNN_TANH>(a[0], a[1], a[2], a[3], a[4], o[0], o[1], o[2], o[3], o[4], ctr, T,
                               B, H, reverse, route, wm, s);
    case RNN_RELU:
      return forward<RNN_RELU>(a[0], a[1], a[2], a[3], a[4], o[0], o[1], o[2], o[3], o[4], ctr, T,
                               B, H, reverse, route, wm, s);
  }
  return (int)cudaErrorInvalidValue;
}

// As the forward's, with the output's gradient dy [T, B, H] (may be null:
// none), the final states' dhT, dcT (lstm) [B, H] (may be null: none), what
// the forward saved and wrote (saved, cs, y), h0, c0 and w_hh; written:
// dxw [T, B, G H] (the gate gradients of the input side), dhc [T, B, H]
// (gru: the candidate's hidden-side gradient, da_n r), dh0 and dc0 (lstm)
// [B, H]. route 1: the persistent kernel, one launch (scratch: 2 x
// ceil(B / 32) x ceil(H / 16) x 32 x HP floats, HP = H rounded up to 128;
// counter: ceil(B / 32) zeroed uint32, one a row group); route 0: the step
// kernels, two launches a step (scratch [4, B, H]; counter unused).
int ptt_rnn_backward(int mode, const void* dy, const void* dhT, const void* dcT,
                     const void* saved, const void* cs, const void* h0, const void* c0,
                     const void* y, const void* w_hh, void* dxw, void* dhc, void* scratch,
                     void* dh0, void* dc0, void* counter, int T, int B, int H, int reverse,
                     int route, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a[9] = {static_cast<const float*>(dy),    static_cast<const float*>(dhT),
                       static_cast<const float*>(dcT),   static_cast<const float*>(saved),
                       static_cast<const float*>(cs),    static_cast<const float*>(h0),
                       static_cast<const float*>(c0),    static_cast<const float*>(y),
                       static_cast<const float*>(w_hh)};
  float* o[5] = {static_cast<float*>(dxw), static_cast<float*>(dhc), static_cast<float*>(scratch),
                 static_cast<float*>(dh0), static_cast<float*>(dc0)};
  unsigned* ctr = static_cast<unsigned*>(counter);
  switch (mode) {
    case LSTM:
      if (!a[3] || !a[4] || !a[6] || !o[4]) return (int)cudaErrorInvalidValue;
      return backward<LSTM>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], o[0], o[1],
                            o[2], o[3], o[4], ctr, T, B, H, reverse, route, s);
    case GRU:
      if (!a[3] || !o[1]) return (int)cudaErrorInvalidValue;
      return backward<GRU>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], o[0], o[1],
                           o[2], o[3], o[4], ctr, T, B, H, reverse, route, s);
    case RNN_TANH:
      return backward<RNN_TANH>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], o[0], o[1],
                                o[2], o[3], o[4], ctr, T, B, H, reverse, route, s);
    case RNN_RELU:
      return backward<RNN_RELU>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], o[0], o[1],
                                o[2], o[3], o[4], ctr, T, B, H, reverse, route, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
