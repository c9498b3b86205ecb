// What the two flash attention sources share: the FlashMask bounds and
// their tile test, the launch arguments and the checks every entry point
// makes. flash_attention.cu (float32 kernels and the bounds pre-pass) and
// flash_attention_bf16.cu (the bf16 kernels) each include it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

// Key columns of a bounds-summary tile: the bf16 kernels' key tile. The
// float32 kernels' 64-key tiles each lie inside one summary tile, whose
// bounds then hold for them too (conservatively).
constexpr int TILE = 128;
constexpr float NEG_INF = -1e30f;
enum TileKind { SKIP, PARTIAL, FULL };

// What the masked kernels take beyond the dense ones (bounds == nullptr:
// the dense kernels).
struct Mask {
  const int* bounds;   // [b, hb, sk, 4] canonical (LTS, LTE, UTS, UTE)
  const int* summary;  // [b, hb, ceil(sk / TILE), 8] per key tile: min, max of each bound
  signed char* kinds;  // or nullptr; [bh, nq, nk] in the kernel's tiles: each tile's kind
  int h, hb, wl, wr;
};

// One (batch, head)'s bounds: its columns, its tile summaries and the test.
struct Bands {
  const int4* cols;   // [sk]
  const int4* tiles;  // [nk][2]: (min LTS, max LTS, min LTE, max LTE), same for UTS, UTE
  int row;            // the (batch, bounds head) row of the bounds
  int causal, wl, wr;

  __device__ Bands(const Mask& mk, size_t bh, int sk, int causal_)
      : cols(nullptr), tiles(nullptr), row(0), causal(causal_), wl(mk.wl), wr(mk.wr) {
    if (mk.bounds == nullptr) return;  // a dense kernel
    row = (int)((bh / mk.h) * mk.hb + (mk.hb == 1 ? 0 : bh % mk.h));
    cols = reinterpret_cast<const int4*>(mk.bounds) + (size_t)row * sk;
    tiles = reinterpret_cast<const int4*>(mk.summary) + (size_t)row * ((sk + TILE - 1) / TILE) * 2;
  }

  // _flashmask_visible of query i and key j, whose bounds are b.
  __device__ __forceinline__ bool visible(int i, int j, int4 b) const {
    const bool low = i > j && i >= b.x && i < b.y;
    const bool up = i < j && (causal || (i >= b.z && i < b.w));
    const bool win = i - j > wl || (!causal && j - i > wr);
    return !(low || up || win);
  }

  // Kind of the tile of rows [r0, r1] and keys [c0, c1], keys inside one
  // summary tile; whole: the tile lies inside sq x sk. Every SKIP holds
  // only masked entries and every FULL only visible ones.
  __device__ __forceinline__ int kind(int r0, int r1, int c0, int c1, bool whole) const {
    if (causal && r1 < c0) return SKIP;
    if (r0 - c1 > wl || (!causal && c0 - r1 > wr)) return SKIP;
    const int kt = c0 / TILE;
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

// delta = rowsum(dO * O) of row `row` of out and dout ([n, D], the
// batch-head's rows), in fp32, 0 at or past sq: each of the 4 threads of a
// quad (t = lane & 3) sums a quarter of D from 16-byte loads, then the
// quad adds them up. Every thread of the quad returns the row's delta.
template <typename T, int D>
__device__ __forceinline__ float row_delta(const T* out, const T* dout, int row, int sq, int t) {
  constexpr int PER = 16 / (int)sizeof(T);  // values a load
  float acc = 0.f;
  if (row < sq) {
    const uint4* o = reinterpret_cast<const uint4*>(out + (size_t)row * D + t * (D / 4));
    const uint4* g = reinterpret_cast<const uint4*>(dout + (size_t)row * D + t * (D / 4));
#pragma unroll
    for (int i = 0; i < D / 4 / PER; ++i) {
      const uint4 a = __ldg(o + i), b = __ldg(g + i);
      const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        if constexpr (std::is_same<T, float>::value) {
          acc = fmaf(__uint_as_float(aw[w]), __uint_as_float(bw[w]), acc);
        } else {
          const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&aw[w]));
          const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bw[w]));
          acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
        }
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  return acc + __shfl_xor_sync(0xffffffffu, acc, 2);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out, *out2;
  int bh, sq, sk, causal;
  float scale;
  cudaStream_t stream;
  Mask mk;
  // dq: the forward's output. The dq kernels compute delta = rowsum(dO * O)
  // of their rows from it and write it to `delta` [bh, sq] for the dk/dv
  // kernels, which run after them.
  const void* fwd_out;
};

// cudaErrorInvalidValue for arguments no kernel takes, else cudaSuccess.
inline cudaError_t check_args(const Args& a) {
  if (a.bh < 0 || a.bh > 65535 || a.sq < 0 || a.sk <= 0) return cudaErrorInvalidValue;
  if (a.causal && a.sq > a.sk) return cudaErrorInvalidValue;
  if (a.mk.bounds != nullptr &&
      (a.mk.summary == nullptr || a.sq != a.sk || a.mk.h <= 0 || a.bh % a.mk.h ||
       (a.mk.hb != 1 && a.mk.hb != a.mk.h)))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

inline Mask mask_of(const void* bounds, const void* summary, void* kinds, int h, int hb, int wl,
                    int wr) {
  return {static_cast<const int*>(bounds), static_cast<const int*>(summary),
          static_cast<signed char*>(kinds), h, hb, wl, wr};
}

}  // namespace flash
