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
// Bound on the H100, a step of one LSTM layer at B 128, H 512: the
// recurrent product is 2.128.512.2048 = 268 MFLOP, 4.0 us at the 67
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
// Backward, rnn_bwd_kernel, one launch a step in reverse: from dh_t (the
// output's gradient plus the recurrent one) and dc_t it computes the gate
// gradients dgates_t, then dh_{t-1} = dgates_t . W_hh (+ dh_t z for the
// gru) and dc_{t-1} = dc f. A block owns 16 rows by 32 units of dh_{t-1};
// the product runs over all the gates of all the units, 32 units' gates a
// stage split over four groups of 128 threads (partial sums added in group
// order), so each block computes dgates_t of its rows as it stages them
// (elementwise, from what the forward saved) and writes those of its own
// 32 units: dgates_t of the input side, the gru's hidden-side candidate
// term apart, and dc_{t-1}. The weight and bias gradients are sums over
// every step, one product each after the loop (kernels/rnn.py, torch.matmul
// over T.B rows).
//
// No float atomics: every sum runs in a fixed order, so two runs give the
// same bits, and a captured step its eager step's.
//
// Plain C interface, loaded with ctypes. Each entry point launches on the
// caller's stream and returns a cudaError_t value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { LSTM = 0, GRU = 1, RNN_TANH = 2, RNN_RELU = 3 };

template <int MODE>
struct Gates {
  static constexpr int G = MODE == LSTM ? 4 : (MODE == GRU ? 3 : 1);
};

// The backward's blocks are KG groups of 128 threads; the groups split each
// stage's depth and their partial sums are added in group order.
constexpr int KG = 4;
constexpr int GROUP = 128;
constexpr int THREADS = KG * GROUP;
// backward: a group is 32 x 4 threads, each 4 rows by 1 unit of dh_{t-1}
constexpr int B_TX = 32, B_TY = 4, B_TM = 4;
constexpr int B_BM = B_TY * B_TM;  // 16 rows a block
constexpr int B_BN = B_TX;         // 32 units a block
constexpr int KU = 32;              // units whose gates a backward stage holds

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

// What a backward stage reads for one (row, unit) pair: dy, dh_in, then
// lstm: dc_in, i, f, g, o, c_t, c_{t-1}; gru: r, z, n, hc, h_{t-1}; the
// simple RNN: h_t.
template <int MODE>
struct PairValues {
  static constexpr int N = MODE == LSTM ? 9 : (MODE == GRU ? 7 : 3);
};

template <int MODE>
__global__ void __launch_bounds__(THREADS)
rnn_bwd_kernel(const float* __restrict__ dy, const float* __restrict__ dh_in,
               const float* __restrict__ dc_in, const float* __restrict__ saved,
               const float* __restrict__ c_t, const float* __restrict__ c_prev,
               const float* __restrict__ h_prev, const float* __restrict__ h_t,
               const float* __restrict__ w_hh, float* __restrict__ dxw,
               float* __restrict__ dhc, float* __restrict__ dh_out, float* __restrict__ dc_out,
               int B, int H) {
  constexpr int G = Gates<MODE>::G;
  constexpr int KD = G * KU;                // the product's depth a stage
  constexpr int KS = KD / KG;               // a group's share of a stage
  constexpr int PL = B_BM * KU / THREADS;   // (row, unit) pairs a thread
  constexpr int WL = KD * B_BN / THREADS;   // W_hh values a thread stages
  constexpr int NV = PairValues<MODE>::N;
  __shared__ __align__(16) float as[KD][B_BM + 4];
  __shared__ float ws[KD][B_BN];
  __shared__ float red[KG - 1][B_TM][GROUP];
  const int grp = threadIdx.x / GROUP, lt = threadIdx.x % GROUP;
  const int tx = lt % B_TX, ty = lt / B_TX;
  const int b0 = blockIdx.y * B_BM, j0 = blockIdx.x * B_BN;
  float acc[B_TM];
#pragma unroll
  for (int i = 0; i < B_TM; ++i) acc[i] = 0.f;

  // a stage's inputs, in registers: the next stage's loads are in flight
  // while the current stage computes
  float in[PL][NV], wr[WL];
  auto load = [&](int u0) {
#pragma unroll
    for (int q = 0; q < PL; ++q) {
      const int p = threadIdx.x + q * THREADS, b = b0 + p / KU, j = u0 + p % KU;
      const bool ok = b < B && j < H;
      const int64_t o = (int64_t)b * H + j;
      float* v = in[q];
      v[0] = ok && dy ? dy[o] : 0.f;
      v[1] = ok && dh_in ? dh_in[o] : 0.f;
      if constexpr (MODE == LSTM) {
        const float* sv = saved + (int64_t)b * 4 * H + j;
        v[2] = ok && dc_in ? dc_in[o] : 0.f;
#pragma unroll
        for (int g = 0; g < 4; ++g) v[3 + g] = ok ? sv[g * H] : 0.f;
        v[7] = ok ? c_t[o] : 0.f;
        v[8] = ok ? c_prev[o] : 0.f;
      } else if constexpr (MODE == GRU) {
        const float* sv = saved + (int64_t)b * 4 * H + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) v[2 + g] = ok ? sv[g * H] : 0.f;
        v[6] = ok ? h_prev[o] : 0.f;
      } else {
        v[2] = ok ? h_t[o] : 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < WL; ++q) {
      const int e = threadIdx.x + q * THREADS, row = e / B_BN, k = j0 + e % B_BN;
      const int g = row / KU, j = u0 + row % KU;
      wr[q] = (j < H && k < H) ? w_hh[((int64_t)g * H + j) * H + k] : 0.f;
    }
  };
  load(0);
  for (int u0 = 0; u0 < H; u0 += KU) {
    // dgates of this block's rows for units u0 .. u0 + KU - 1; those of its
    // own units written out
#pragma unroll
    for (int q = 0; q < PL; ++q) {
      const int p = threadIdx.x + q * THREADS, r = p / KU, u = p % KU;
      const int b = b0 + r, j = u0 + u;
      const bool own = b < B && j < H && j >= j0 && j < j0 + B_BN;
      const int64_t o = (int64_t)b * H + j;
      const float* v = in[q];
      const float dh = v[0] + v[1];
      float d[G];
      if constexpr (MODE == LSTM) {
        const float si = v[3], sf = v[4], tg = v[5], so = v[6];
        const float tc = tanhf(v[7]);
        const float dc = v[2] + dh * so * (1.f - tc * tc);
        d[0] = dc * tg * si * (1.f - si);
        d[1] = dc * v[8] * sf * (1.f - sf);
        d[2] = dc * si * (1.f - tg * tg);
        d[3] = dh * tc * so * (1.f - so);
        if (own) {
          float* dr = dxw + (int64_t)b * 4 * H + j;
          dr[0] = d[0];
          dr[H] = d[1];
          dr[2 * H] = d[2];
          dr[3 * H] = d[3];
          dc_out[o] = dc * sf;
        }
      } else if constexpr (MODE == GRU) {
        const float r_ = v[2], z = v[3], n = v[4], hc = v[5];
        const float dan = dh * (1.f - z) * (1.f - n * n);
        d[0] = dan * hc * r_ * (1.f - r_);
        d[1] = dh * (v[6] - n) * z * (1.f - z);
        d[2] = dan * r_;
        if (own) {
          float* dr = dxw + (int64_t)b * 3 * H + j;
          dr[0] = d[0];
          dr[H] = d[1];
          dr[2 * H] = dan;
          dhc[o] = d[2];
        }
      } else {
        const float h = v[2];
        d[0] = MODE == RNN_TANH ? dh * (1.f - h * h) : (h > 0.f ? dh : 0.f);
        if (own) dxw[o] = d[0];
      }
#pragma unroll
      for (int g = 0; g < G; ++g) as[g * KU + u][r] = d[g];
    }
#pragma unroll
    for (int q = 0; q < WL; ++q) {
      const int e = threadIdx.x + q * THREADS;
      ws[e / B_BN][e % B_BN] = wr[q];
    }
    __syncthreads();
    if (u0 + KU < H) load(u0 + KU);
#pragma unroll 8
    for (int kq = 0; kq < KS; ++kq) {
      const int kk = grp * KS + kq;
      const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * B_TM]);
      const float w = ws[kk][tx];
      acc[0] = fmaf(a.x, w, acc[0]);
      acc[1] = fmaf(a.y, w, acc[1]);
      acc[2] = fmaf(a.z, w, acc[2]);
      acc[3] = fmaf(a.w, w, acc[3]);
    }
    __syncthreads();
  }
  if (grp > 0) {
#pragma unroll
    for (int i = 0; i < B_TM; ++i) red[grp - 1][i][lt] = acc[i];
  }
  __syncthreads();
  if (grp > 0) return;
#pragma unroll
  for (int q = 0; q < KG - 1; ++q)
#pragma unroll
    for (int i = 0; i < B_TM; ++i) acc[i] += red[q][i][lt];

  const int k = j0 + tx;
  if (k >= H) return;
#pragma unroll
  for (int i = 0; i < B_TM; ++i) {
    const int b = b0 + ty * B_TM + i;
    if (b >= B) continue;
    const int64_t o = (int64_t)b * H + k;
    float v = acc[i];
    if constexpr (MODE == GRU) {
      const float dh = (dy ? dy[o] : 0.f) + (dh_in ? dh_in[o] : 0.f);
      v += dh * saved[(int64_t)b * 4 * H + H + k];
    }
    dh_out[o] = v;
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

template <int MODE>
int backward(const float* dy, const float* dhT, const float* dcT, const float* saved,
             const float* cs, const float* h0, const float* c0, const float* y,
             const float* w_hh, float* dxw, float* dhc, float* scratch, float* dh0, float* dc0,
             int T, int B, int H, int reverse, cudaStream_t s) {
  constexpr int G = Gates<MODE>::G;
  const dim3 grid((H + B_BN - 1) / B_BN, (B + B_BM - 1) / B_BM);
  const int64_t bh = (int64_t)B * H;
  // ping-pong: the recurrent gradients a launch reads and the next writes
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
    const float* cp = MODE == LSTM ? (step == 0 ? c0 : cs + tp * bh) : nullptr;
    rnn_bwd_kernel<MODE><<<grid, THREADS, 0, s>>>(
        dy ? dy + t * bh : nullptr, dh_in, dc_in, saved ? saved + t * bh * 4 : nullptr,
        MODE == LSTM ? cs + t * bh : nullptr, cp, hp, y + t * bh, w_hh, dxw + t * bh * G,
        MODE == GRU ? dhc + t * bh : nullptr, dh_out, dc_out, B, H);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    dh_in = dh_out;
    dc_in = dc_out;
  }
  return 0;
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
// the forward saved and wrote (saved, cs, y), h0, c0 and w_hh; scratch [4,
// B, H] float32; written: dxw [T, B, G H] (the gate gradients of the input
// side), dhc [T, B, H] (gru: the candidate's hidden-side gradient, da_n r),
// dh0 and dc0 (lstm) [B, H].
int ptt_rnn_backward(int mode, const void* dy, const void* dhT, const void* dcT,
                     const void* saved, const void* cs, const void* h0, const void* c0,
                     const void* y, const void* w_hh, void* dxw, void* dhc, void* scratch,
                     void* dh0, void* dc0, int T, int B, int H, int reverse, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a[9] = {static_cast<const float*>(dy),    static_cast<const float*>(dhT),
                       static_cast<const float*>(dcT),   static_cast<const float*>(saved),
                       static_cast<const float*>(cs),    static_cast<const float*>(h0),
                       static_cast<const float*>(c0),    static_cast<const float*>(y),
                       static_cast<const float*>(w_hh)};
  float* o[5] = {static_cast<float*>(dxw), static_cast<float*>(dhc), static_cast<float*>(scratch),
                 static_cast<float*>(dh0), static_cast<float*>(dc0)};
  switch (mode) {
    case LSTM:
      if (!a[3] || !a[4] || !a[6] || !o[4]) return (int)cudaErrorInvalidValue;
      return backward<LSTM>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], o[0], o[1],
                            o[2], o[3], o[4], T, B, H, reverse, s);
    case GRU:
      if (!a[3] || !o[1]) return (int)cudaErrorInvalidValue;
      return backward<GRU>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], o[0], o[1],
                           o[2], o[3], o[4], T, B, H, reverse, s);
    case RNN_TANH:
      return backward<RNN_TANH>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], o[0], o[1],
                                o[2], o[3], o[4], T, B, H, reverse, s);
    case RNN_RELU:
      return backward<RNN_RELU>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], o[0], o[1],
                                o[2], o[3], o[4], T, B, H, reverse, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
