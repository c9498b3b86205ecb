// The dense attention's forward middle at short rows: the scale, the
// masks, the fp32 softmax and the probabilities' dropout in one pass, four
// keys a thread (Hopper, sm_90a).
//
// No TPU kernel: the JAX package's _sdpa_reference (paddle_tpu/nn/
// functional/attention.py:20-43) scales the fp32 scores, masks them, takes
// jax.nn.softmax and drops the probabilities, and XLA fuses those passes.
// kernels/dense_attention.py holds the port's Triton kernels (X2, forward
// and backward); this kernel takes the forward wherever
// dense_softmax_forward_plan sends it: fp32 scores whose rows are a
// multiple of 4 keys up to the plan's cap (Transformer-base's 64 keys).
//
// What it computes, over each row of z = scores * scale ([b, h, sq, sk],
// contiguous): z set to -1e30 where causal (j > i + sk - sq) or a bool mask
// (0) hides it, an additive mask added; probs = exp(z - max) / sum in fp32
// (a row that sees no key averages every key, as the JAX function); with a
// dropout the probabilities kept where kernels/dropout.py's mask under
// (key, site) keeps element e of [b, h, sq, sk] (csrc/philox_common.cuh),
// times the fp32 1 / (1 - p). The Triton backward draws the same mask again.
//
// Bound on the H100: bytes (the scores read, the probabilities and the
// dropped ones written: 12 bytes an element; about 30 operations an element
// and a quarter of a Philox4x32-10 block). The Triton kernel took 32 rows
// of a [R, G, 4] tile a program and drew a whole Philox block for each of
// its elements, keeping one word of four; it fetched a mask that is
// broadcast over the heads again for every head, and found the mask's
// offsets by int64 division. Here:
//   * a thread holds four consecutive keys: one float4 of scores and one
//     Philox block, whose four words serve exactly those four elements
//     (the row's start is a multiple of 4); a row takes L lanes (the next
//     power of two of sk / 4, at most 32; past 128 keys, up to the plan's
//     256, a lane takes CH = 2 chunks of four), so 64 keys are 16 lanes
//     and a warp holds 2 rows;
//     max and sum are xor shuffles over the row's lanes in a fixed order;
//   * a block takes all h heads of the same (batch, query rows): a thread
//     keeps its query row and walks the heads, HB heads' scores in flight
//     at once; a mask broadcast over the heads (stride 0) is read once a
//     block and kept in registers; causal comes from the indices; where
//     the (batch, query rows) are too few to fill the SMs (the UNet's 8 x
//     8 self-attention: 16 blocks), the heads are split over blocks;
//   * probs and dropped probs are written with 16-byte stores.
// Sums in a fixed order, no atomics: two calls give the same bits, and a
// captured step replays the eager one's.
//
// Plain C interface, loaded with ctypes; ptt_dense_softmax_fwd launches on
// the caller's stream and returns a cudaError_t value.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "philox_common.cuh"

namespace {

using philox::Mask;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -1e30f;    // the masked score, as the JAX function's

enum MaskDtype { M_F32 = 0, M_BF16 = 1, M_F16 = 2, M_U8 = 3 };

// four mask values at element offset off (the four consecutive keys at
// stride smk), as floats (a bool mask: 0 or 1); vec: one 4-, 8- or 16-byte
// access (smk 1, the offset a multiple of 4, the pointer aligned)
__device__ __forceinline__ float4 load_mask4(const void* m, int64_t off, int64_t smk, int mdt,
                                             bool vec) {
  float v[4];
  if (vec) {
    if (mdt == M_F32) {
      const float4 t = *reinterpret_cast<const float4*>(static_cast<const float*>(m) + off);
      return t;
    }
    if (mdt == M_U8) {
      const uint32_t t = *reinterpret_cast<const uint32_t*>(static_cast<const uint8_t*>(m) + off);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = (float)((t >> (8 * j)) & 0xffu);
    } else {
      const uint2 t = *reinterpret_cast<const uint2*>(static_cast<const uint16_t*>(m) + off);
      const uint32_t w[2] = {t.x, t.y};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint16_t u = (uint16_t)(w[j >> 1] >> (16 * (j & 1)));
        v[j] = mdt == M_BF16 ? __uint_as_float((uint32_t)u << 16)
                             : __half2float(__ushort_as_half(u));
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t o = off + j * smk;
      if (mdt == M_F32)
        v[j] = static_cast<const float*>(m)[o];
      else if (mdt == M_U8)
        v[j] = (float)static_cast<const uint8_t*>(m)[o];
      else if (mdt == M_BF16)
        v[j] = __bfloat162float(static_cast<const __nv_bfloat16*>(m)[o]);
      else
        v[j] = __half2float(static_cast<const __half*>(m)[o]);
    }
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Grid: b x ceil(sq / RQ) x hsplit blocks, RQ = WARPS (32 / L) query rows
// a block, each over hpb heads (all h, but where b ceil(sq / RQ) blocks
// would leave SMs idle). MK: the mask's kind (0 none, 1 bool, 2 additive);
// CH: chunks of four keys a lane (L = 32 where CH > 1).
template <int CH, int MK>
__global__ void __launch_bounds__(THREADS)
ptt_dense_softmax_fwd_kernel(const float* __restrict__ s, const void* __restrict__ m,
                             float* __restrict__ p, float* __restrict__ d,
                             const long long* __restrict__ key, int H, int SQ, int SK, int L,
                             int qtiles, int hsplit, int hpb, int diag, float scale,
                             long long smb, long long smh,
                             long long smq, long long smk, int mdt, int mvec, uint32_t site,
                             int thresh, float dscale, int causal, int drop) {
  constexpr int HB = 4 / CH;   // heads in flight a thread
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rq = WARPS * (32 / L);
  const int hg = blockIdx.x % hsplit, rest = blockIdx.x / hsplit;
  const int bi = rest / qtiles;
  const int qi = (rest - bi * qtiles) * rq + warp * (32 / L) + lane / L;
  const int h_lo = hg * hpb, h_hi = min(H, h_lo + hpb);
  const int sub = lane & (L - 1);
  const bool row_ok = qi < SQ;
  Mask mask{0u, 0u, site, thresh};
  if (drop) {
    mask.k0 = (uint32_t)key[0];
    mask.k1 = (uint32_t)key[1];
  }
  // this lane's chunks: keys col[k] .. col[k] + 3, in bounds where ok[k]
  int col[CH];
  bool ok[CH];
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    col[k] = 4 * (sub + k * L);
    ok[k] = row_ok && col[k] < SK;
  }
  // the mask's values of the block's (batch, query row), kept over the
  // heads where it is broadcast over them
  const int64_t mrow = (int64_t)bi * smb + (int64_t)qi * smq;
  float4 mv[CH];
#pragma unroll
  for (int k = 0; k < CH; ++k)
    mv[k] = MK != 0 && smh == 0 && ok[k] ? load_mask4(m, mrow + col[k] * smk, smk, mdt, mvec)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int h0 = h_lo; h0 < h_hi; h0 += HB) {
    float4 sc[HB][CH];
#pragma unroll
    for (int u = 0; u < HB; ++u) {
      const int64_t row = ((int64_t)bi * H + h0 + u) * SQ + qi;
#pragma unroll
      for (int k = 0; k < CH; ++k)
        sc[u][k] = ok[k] && h0 + u < h_hi
                       ? *reinterpret_cast<const float4*>(s + row * SK + col[k])
                       : make_float4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < HB; ++u) {
      const int hh = h0 + u;
      if (hh >= h_hi) break;   // uniform across the block
      const int64_t row = ((int64_t)bi * H + hh) * SQ + qi;
      float z[CH][4];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        float4 mk = mv[k];
        if (MK != 0 && smh != 0)
          mk = ok[k] ? load_mask4(m, mrow + hh * smh + col[k] * smk, smk, mdt, mvec)
                     : make_float4(0, 0, 0, 0);
        const float sv[4] = {sc[u][k].x, sc[u][k].y, sc[u][k].z, sc[u][k].w};
        const float ma[4] = {mk.x, mk.y, mk.z, mk.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = sv[j] * scale;
          bool vis = true;
          if (causal) vis = col[k] + j <= qi + diag;
          if (MK == 1) vis = vis && ma[j] != 0.f;
          t = vis ? t : NEG;
          if (MK == 2) t += ma[j];
          z[k][j] = ok[k] ? t : -CUDART_INF_F;
          mx = fmaxf(mx, z[k][j]);
        }
      }
      for (int off = L / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < CH; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          z[k][j] = expf(z[k][j] - mx);
          sum += z[k][j];
        }
      for (int off = L / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float inv = 1.f / sum;
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        if (!ok[k]) continue;
        const float4 pv = make_float4(z[k][0] * inv, z[k][1] * inv, z[k][2] * inv, z[k][3] * inv);
        const int64_t e = row * SK + col[k];   // a multiple of 4
        *reinterpret_cast<float4*>(p + e) = pv;
        if (drop) {
          const uint4 w = mask.block((uint64_t)e >> 2);
          *reinterpret_cast<float4*>(d + e) =
              make_float4(mask.keeps(w.x) ? pv.x * dscale : 0.f,
                          mask.keeps(w.y) ? pv.y * dscale : 0.f,
                          mask.keeps(w.z) ? pv.z * dscale : 0.f,
                          mask.keeps(w.w) ? pv.w * dscale : 0.f);
        }
      }
    }
  }
}

template <int CH, int MK>
int launch(const float* s, const void* m, float* p, float* d, const long long* key, int B, int H,
           int SQ, int SK, int L, float scale, const long long (&ms)[4], int mdt, int mvec,
           uint32_t site, int thresh, float dscale, int causal, int drop, cudaStream_t stream) {
  const int rq = WARPS * (32 / L);
  const int qtiles = (SQ + rq - 1) / rq;
  // the heads split over blocks where (batch, query rows) alone would
  // leave SMs idle: about two blocks an SM
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks = (long long)B * qtiles;
  int hpb = H;
  if (blocks < sms) {
    const int want = (int)min((long long)H, (2LL * sms + blocks - 1) / blocks);
    hpb = (H + want - 1) / want;
  }
  const int hsplit = (H + hpb - 1) / hpb;
  ptt_dense_softmax_fwd_kernel<CH, MK><<<(unsigned)(blocks * hsplit), THREADS, 0, stream>>>(
      s, m, p, d, key, H, SQ, SK, L, qtiles, hsplit, hpb, SK - SQ, scale, ms[0], ms[1], ms[2],
      ms[3], mdt, mvec, site, thresh, dscale, causal, drop);
  return (int)cudaGetLastError();
}

template <int CH>
int launch_mk(int mk, const float* s, const void* m, float* p, float* d, const long long* key,
              int B, int H, int SQ, int SK, int L, float scale, const long long (&ms)[4], int mdt,
              int mvec, uint32_t site, int thresh, float dscale, int causal, int drop,
              cudaStream_t stream) {
#define PTT_DS_MK(K)                                                                        \
  launch<CH, K>(s, m, p, d, key, B, H, SQ, SK, L, scale, ms, mdt, mvec, site, thresh, dscale, \
                causal, drop, stream)
  if (mk == 0) return PTT_DS_MK(0);
  if (mk == 1) return PTT_DS_MK(1);
  return PTT_DS_MK(2);
#undef PTT_DS_MK
}

}  // namespace

extern "C" {

// scores [B, H, SQ, SK] fp32 contiguous, 16-byte aligned, SK % 4 == 0, SK
// <= 256 (CH 1 or 2); mask: kind mk (0 none, 1 bool as uint8, 2 additive) of
// dtype mdt (0 float32, 1 bfloat16, 2 float16, 3 uint8) read at element
// offsets b smb + h smh + q smq + k smk (0 on a broadcast dimension); key
// int64 [2] on the card (read only with drop); written: probs, and dropped
// (with drop) [B, H, SQ, SK] fp32, 16-byte aligned.
int ptt_dense_softmax_fwd(const void* scores, const void* mask, void* probs, void* dropped,
                          const void* key, int B, int H, int SQ, int SK, float scale, int mk,
                          int mdt, long long smb, long long smh, long long smq, long long smk,
                          unsigned site, int thresh, float dscale, int causal, int drop,
                          void* stream) {
  if (B <= 0 || H <= 0 || SQ <= 0 || SK <= 0 || SK % 4 || SK > 256 || mk < 0 || mk > 2 ||
      (mk && (mdt < 0 || mdt > 3)) || (reinterpret_cast<uintptr_t>(scores) |
                                       reinterpret_cast<uintptr_t>(probs) |
                                       reinterpret_cast<uintptr_t>(dropped)) % 16)
    return (int)cudaErrorInvalidValue;
  const int chunks = SK / 4;
  int L = 1;
  while (L < chunks && L < 32) L *= 2;
  const int ch = (chunks + L - 1) / L;    // 1 up to 128 keys, else 2
  const long long ms[4] = {smb, smh, smq, smk};
  const int esize = mdt == 0 ? 4 : mdt == 3 ? 1 : 2;
  const int mvec = mk && ms[3] == 1 && ms[0] % 4 == 0 && ms[1] % 4 == 0 && ms[2] % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(mask) % (4 * esize) == 0;
  const float* s = static_cast<const float*>(scores);
  float* p = static_cast<float*>(probs);
  float* d = static_cast<float*>(dropped);
  const long long* k = static_cast<const long long*>(key);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PTT_DS_CH(C)                                                                          \
  launch_mk<C>(mk, s, mask, p, d, k, B, H, SQ, SK, L, scale, ms, mdt, mvec, site, thresh, \
               dscale, causal, drop, st)
  if (ch == 1) return PTT_DS_CH(1);
  return PTT_DS_CH(2);
#undef PTT_DS_CH
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
