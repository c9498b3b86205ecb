// The recurrence of the stacked RNNs and the RNN cells, forward and
// backward, one launch a time step (Hopper, sm_90a).
//
// No TPU kernel: the JAX package's SimpleRNN, LSTM and GRU run each layer
// and direction as one jax.lax.scan (paddle_tpu/nn/layer/rnn.py:281-302),
// which XLA compiles into one loop on the device; its body is the step of
// rnn.py:30-58. In eager PyTorch that body is about a dozen launches a
// step. Here the input term of every step (x . W_ih^T plus the biases
// that fold into it) is one product before the loop, and each step is one
// kernel: the recurrent product h_{t-1} . W_hh^T and the gate arithmetic,
// fp32 throughout, as the JAX scan computes (kernels/rnn.py holds the
// plain version beside it and says what each mode computes):
//   lstm (gates i, f, g, o): c = sig(f) c' + sig(i) tanh(g); h = sig(o) tanh(c)
//   gru (r, z, c): r = sig(x_r + h_r); z = sig(x_z + h_z);
//                  n = tanh(x_c + r (h'.W_c + b_hc)); h = (1 - z) n + z h'
//                  (b_hc stays inside the reset product: it cannot fold)
//   rnn_tanh, rnn_relu: h = act(x + h'.W)
// with sig(x) = 1 / (1 + exp(-x)).
//
// Forward, rnn_fwd_kernel: a block owns 32 batch rows by 16 hidden units
// and all of those units' gates, so the cell update is local. It stages h
// and its rows of W_hh through shared memory, 32 of the product's depth at
// a time (each thread's share loaded into registers one stage ahead), and
// accumulates in fp32 FMAs in a fixed order: four groups of 128 threads
// split each stage's depth (a thread: 4 rows by one unit, every gate) and
// their partial sums are added in group order. It writes h_t, c_t (lstm)
// and what the
// backward reads: the activated gates i, f, g, o (lstm) or r, z, n and the
// candidate's hidden term (gru); the simple RNN's backward reads h_t.
//
// Backward, rnn_bwd_kernel, one launch a step in reverse: from dh_t (the
// output's gradient plus the recurrent one) and dc_t it computes the gate
// gradients dgates_t, then dh_{t-1} = dgates_t . W_hh (+ dh_t z for the
// gru) and dc_{t-1} = dc f. A block owns 16 rows by 32 units of dh_{t-1};
// the product runs over all the gates of all the units, 32 units' gates a
// stage split over the four groups as in the forward, so each block
// computes dgates_t of its rows as it stages them (elementwise, from what
// the forward saved) and writes those of its own 32 units: dgates_t of
// the input side, the gru's hidden-side candidate term apart, and
// dc_{t-1}. The weight and bias gradients are sums over every step, one
// product each after the loop (kernels/rnn.py, torch.matmul over T.B
// rows). No atomics: two runs give the same bits, and a captured step its
// eager step's.
//
// Bound on the H100, a step of one LSTM layer at B 128, H 512: the
// recurrent product is 2.128.512.2048 = 268 MFLOP, 4.0 us at the 67
// TFLOP/s fp32 FMA peak; W_hh (4.2 MB) is read once a step from the L2
// (1.25 us from HBM at 3.35 TB/s), so the product's operations bound it.
// One launch a step costs 1-2 us of the card's time between dependent
// kernels, so a kernel launched once a step reaches at most ~0.6-0.7 of
// that bound; and at B 128 the blocks fill one wave of the 132 SMs with
// one block each, which leaves the FMA units waiting on the staging. A
// persistent kernel that keeps W_hh resident in shared memory across the
// SMs (4.2 MB / 132 = 32 KB an SM) and steps with a grid barrier would
// remove both the launches and the restaging; it is later work.
//
// Plain C interface, loaded with ctypes. Each entry point launches its T
// kernels on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { LSTM = 0, GRU = 1, RNN_TANH = 2, RNN_RELU = 3 };

template <int MODE>
struct Gates {
  static constexpr int G = MODE == LSTM ? 4 : (MODE == GRU ? 3 : 1);
};

// A block is KG groups of 128 threads; the groups split each stage's depth
// (four warps an SM schedule could not hide the loads' latency) and their
// partial sums are added in group order at the end.
constexpr int KG = 4;
constexpr int GROUP = 128;
constexpr int THREADS = KG * GROUP;
// forward: a group is 16 x 8 threads, each 4 rows by 1 unit (all its gates)
constexpr int F_TX = 16, F_TY = 8, F_TM = 4;
constexpr int F_BM = F_TY * F_TM;  // 32 rows a block
constexpr int F_BN = F_TX;         // 16 units a block
constexpr int F_BK = 32;           // the product's depth a stage
// backward: a group is 32 x 4 threads, each 4 rows by 1 unit of dh_{t-1}
constexpr int B_TX = 32, B_TY = 4, B_TM = 4;
constexpr int B_BM = B_TY * B_TM;  // 16 rows a block
constexpr int B_BN = B_TX;         // 32 units a block
constexpr int KU = 32;              // units whose gates a backward stage holds

__device__ __forceinline__ float sig(float x) { return 1.f / (1.f + expf(-x)); }

template <int MODE>
__global__ void __launch_bounds__(THREADS)
rnn_fwd_kernel(const float* __restrict__ xw, const float* __restrict__ h_prev,
               const float* __restrict__ c_prev, const float* __restrict__ w_hh,
               const float* __restrict__ b_hc, float* __restrict__ h_out,
               float* __restrict__ c_out, float* __restrict__ saved,
               float* __restrict__ h_fin, float* __restrict__ c_fin, int B, int H) {
  constexpr int G = Gates<MODE>::G;
  constexpr int HL = F_BM * F_BK / THREADS;      // h values a thread stages
  constexpr int WL = G * F_BN * F_BK / THREADS;  // W_hh values a thread stages
  constexpr int KS = F_BK / KG;                  // a group's share of a stage
  __shared__ __align__(16) float hs[F_BK][F_BM + 4];
  __shared__ float ws[F_BK][G * F_BN + 1];
  __shared__ float red[KG - 1][G * F_TM][GROUP];
  const int grp = threadIdx.x / GROUP, lt = threadIdx.x % GROUP;
  const int tx = lt % F_TX, ty = lt / F_TX;
  const int b0 = blockIdx.y * F_BM, j0 = blockIdx.x * F_BN;
  float acc[G][F_TM];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < F_TM; ++i) acc[g][i] = 0.f;

  // a stage's h and W_hh values, in registers: the next stage's loads are
  // in flight while the current stage computes
  float hr[HL], wr[WL];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < HL; ++q) {
      const int e = threadIdx.x + q * THREADS, b = b0 + e / F_BK, kk = k0 + e % F_BK;
      hr[q] = (b < B && kk < H) ? h_prev[(int64_t)b * H + kk] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < WL; ++q) {
      const int e = threadIdx.x + q * THREADS, col = e / F_BK, kk = k0 + e % F_BK;
      const int g = col / F_BN, j = j0 + col % F_BN;
      wr[q] = (j < H && kk < H) ? w_hh[((int64_t)g * H + j) * H + kk] : 0.f;
    }
  };
  load(0);
  for (int k0 = 0; k0 < H; k0 += F_BK) {
#pragma unroll
    for (int q = 0; q < HL; ++q) {
      const int e = threadIdx.x + q * THREADS;
      hs[e % F_BK][e / F_BK] = hr[q];
    }
#pragma unroll
    for (int q = 0; q < WL; ++q) {
      const int e = threadIdx.x + q * THREADS;
      ws[e % F_BK][e / F_BK] = wr[q];
    }
    __syncthreads();
    if (k0 + F_BK < H) load(k0 + F_BK);
#pragma unroll
    for (int kq = 0; kq < KS; ++kq) {
      const int k = grp * KS + kq;
      const float4 hv = *reinterpret_cast<const float4*>(&hs[k][ty * F_TM]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float w = ws[k][g * F_BN + tx];
        acc[g][0] = fmaf(hv.x, w, acc[g][0]);
        acc[g][1] = fmaf(hv.y, w, acc[g][1]);
        acc[g][2] = fmaf(hv.z, w, acc[g][2]);
        acc[g][3] = fmaf(hv.w, w, acc[g][3]);
      }
    }
    __syncthreads();
  }
  if (grp > 0) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < F_TM; ++i) red[grp - 1][g * F_TM + i][lt] = acc[g][i];
  }
  __syncthreads();
  if (grp > 0) return;
#pragma unroll
  for (int q = 0; q < KG - 1; ++q)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < F_TM; ++i) acc[g][i] += red[q][g * F_TM + i][lt];

  const int j = j0 + tx;
  if (j >= H) return;
#pragma unroll
  for (int i = 0; i < F_TM; ++i) {
    const int b = b0 + ty * F_TM + i;
    if (b >= B) continue;
    const float* xr = xw + (int64_t)b * G * H;
    const int64_t o = (int64_t)b * H + j;
    float h;
    if constexpr (MODE == LSTM) {
      const float si = sig(xr[j] + acc[0][i]);
      const float sf = sig(xr[H + j] + acc[1][i]);
      const float tg = tanhf(xr[2 * H + j] + acc[2][i]);
      const float so = sig(xr[3 * H + j] + acc[3][i]);
      const float c = sf * c_prev[o] + si * tg;
      h = so * tanhf(c);
      c_out[o] = c;
      if (c_fin) c_fin[o] = c;
      float* sv = saved + (int64_t)b * 4 * H + j;
      sv[0] = si;
      sv[H] = sf;
      sv[2 * H] = tg;
      sv[3 * H] = so;
    } else if constexpr (MODE == GRU) {
      const float hc = acc[2][i] + (b_hc ? b_hc[j] : 0.f);
      const float r = sig(xr[j] + acc[0][i]);
      const float z = sig(xr[H + j] + acc[1][i]);
      const float n = tanhf(xr[2 * H + j] + r * hc);
      h = (1.f - z) * n + z * h_prev[o];
      float* sv = saved + (int64_t)b * 4 * H + j;
      sv[0] = r;
      sv[H] = z;
      sv[2 * H] = n;
      sv[3 * H] = hc;
    } else {
      const float a = xr[j] + acc[0][i];
      h = MODE == RNN_TANH ? tanhf(a) : fmaxf(a, 0.f);
    }
    h_out[o] = h;
    if (h_fin) h_fin[o] = h;
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

template <int MODE>
int forward(const float* xw, const float* h0, const float* c0, const float* w_hh,
            const float* b_hc, float* y, float* cs, float* saved, float* h_fin, float* c_fin,
            int T, int B, int H, int reverse, cudaStream_t s) {
  constexpr int G = Gates<MODE>::G;
  const dim3 grid((H + F_BN - 1) / F_BN, (B + F_BM - 1) / F_BM);
  const int64_t bh = (int64_t)B * H;
  for (int step = 0; step < T; ++step) {
    const int t = reverse ? T - 1 - step : step;
    const int tp = reverse ? t + 1 : t - 1;
    const bool last = step == T - 1;
    const float* hp = step == 0 ? h0 : y + tp * bh;
    const float* cp = MODE == LSTM ? (step == 0 ? c0 : cs + tp * bh) : nullptr;
    rnn_fwd_kernel<MODE><<<grid, THREADS, 0, s>>>(
        xw + t * bh * G, hp, cp, w_hh, b_hc, y + t * bh, MODE == LSTM ? cs + t * bh : nullptr,
        saved ? saved + t * bh * 4 : nullptr, last ? h_fin : nullptr,
        last && MODE == LSTM ? c_fin : nullptr, B, H);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
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
// T - 1 down to 0. All float32, contiguous. Returns a cudaError_t value.
int ptt_rnn_forward(int mode, const void* xw, const void* h0, const void* c0,
                    const void* w_hh, const void* b_hc, void* y, void* cs, void* saved,
                    void* h_fin, void* c_fin, int T, int B, int H, int reverse, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a[5] = {static_cast<const float*>(xw), static_cast<const float*>(h0),
                       static_cast<const float*>(c0), static_cast<const float*>(w_hh),
                       static_cast<const float*>(b_hc)};
  float* o[5] = {static_cast<float*>(y), static_cast<float*>(cs), static_cast<float*>(saved),
                 static_cast<float*>(h_fin), static_cast<float*>(c_fin)};
  switch (mode) {
    case LSTM:
      if (!a[2] || !o[1] || !o[2] || !o[4]) return (int)cudaErrorInvalidValue;
      return forward<LSTM>(a[0], a[1], a[2], a[3], a[4], o[0], o[1], o[2], o[3], o[4], T, B, H,
                           reverse, s);
    case GRU:
      if (!o[2]) return (int)cudaErrorInvalidValue;
      return forward<GRU>(a[0], a[1], a[2], a[3], a[4], o[0], o[1], o[2], o[3], o[4], T, B, H,
                          reverse, s);
    case RNN_TANH:
      return forward<RNN_TANH>(a[0], a[1], a[2], a[3], a[4], o[0], o[1], o[2], o[3], o[4], T, B,
                               H, reverse, s);
    case RNN_RELU:
      return forward<RNN_RELU>(a[0], a[1], a[2], a[3], a[4], o[0], o[1], o[2], o[3], o[4], T, B,
                               H, reverse, s);
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
