// Ragged paged attention in float32 for the continuous-batching engine
// (sm_90a); bf16 takes ragged_attention_bf16.cu.
//
// Replaces paddle_tpu/kernels/ragged_pallas.py:ragged_decode_attention
// (_rpa_kernel). Same function: every packed query token t runs an online
// softmax over the K/V slots of its own sequence's page list, seeing the
// slots whose absolute position is <= positions[t] on pages whose table
// entry is not -1; grouped-query attention maps query head h to kv head
// h / rep; invalid rows are written as zeros.
//
// Bound on the H100: bytes. Each K/V slot is used for 4*D flops per query
// head against 8*D bytes (fp32 K and V).
//
// Design against that bound:
//   * the TPU grid walks every page column (T x MP) and masks the columns
//     past the position, which reads the whole maximum context for every
//     token; this kernel loops only over columns 0 .. positions[t] / bs of
//     the token's own table row and skips -1 entries, so it reads only the
//     pages the token can see;
//   * one block per (token, kv head): the block reads each K/V page of its
//     head once into shared memory and serves all `rep` query heads of the
//     group from it (no repeat of K/V per query head);
//   * the walk goes in chunks of ~32 keys, double-buffered: while the block
//     computes on one chunk, cp.async copies the next chunk's pages into
//     the other shared buffer; the page-table row sits in shared memory;
//   * scores, the running max and sum, and the output accumulator stay in
//     fp32 in shared memory and registers; nothing but the output is
//     written to device memory.
// The bf16 kernels of ragged_attention_bf16.cu are the redesign for this
// card (a plan of query tiles and key splits, TMA, wgmma); float32 is not
// on the serving main path and keeps this kernel.
//
// Plain C interface, loaded with ctypes. The launch goes on the caller's
// stream; the function returns cudaGetLastError() so a refused launch is
// reported to the caller.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Pages a block stages at once: about 32 keys per chunk.
inline int pages_per_chunk(int BS) { return BS >= 32 ? 1 : 32 / BS; }

// Shared memory bytes of one block: two chunk buffers of K and V pages in
// the input dtype, then fp32 queries, probabilities and row state, then
// the token's page-table row.
template <typename T>
size_t smem_bytes(int D, int REP, int BS, int MP) {
  const int keys = pages_per_chunk(BS) * BS;
  return (size_t)4 * keys * D * sizeof(T) +
         (size_t)(REP * D + REP * keys + 3 * REP) * sizeof(float) +
         (size_t)MP * sizeof(int32_t);
}

// Grid (T, KVH); block D threads, thread d owns output dimension d of the
// group's REP query heads. The visible pages are walked in chunks of KC
// pages (KEYS = KC * BS keys). Shared memory:
//   kv    [2][2][KEYS][D] (T)  double-buffered K and V chunks of this kv
//                              head, filled by cp.async while the other
//                              buffer is in use
//   q_s   [REP][D]    (fp32)   the group's queries
//   p_s   [REP][KEYS] (fp32)   scores, then probabilities, of this chunk
//   a_s, m_s, l_s [REP]        rescale factor, running max, running sum
//   tab_s [MP]        (int32)  the token's page-table row
template <typename T, int D, int REP>
__global__ void __launch_bounds__(D)
ragged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                        const T* __restrict__ v_pool,
                        const int32_t* __restrict__ tables,
                        const int32_t* __restrict__ slot_ids,
                        const int32_t* __restrict__ positions,
                        const uint8_t* __restrict__ valid, T* __restrict__ out,
                        int H, int KVH, int P, int BS, int MP, int KC,
                        float scale) {
  constexpr int NW = D / 32;
  constexpr int VE = 16 / sizeof(T);  // elements per 16-byte copy
  const int t = blockIdx.x;
  const int g = blockIdx.y;
  const int d = threadIdx.x;
  const int lane = d & 31;
  const int warp = d >> 5;
  const int tile = BS * D;           // one page of one kv head
  const int keys = KC * BS;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kv = reinterpret_cast<T*>(smem_raw);
  float* q_s = reinterpret_cast<float*>(kv + 4 * keys * D);
  float* p_s = q_s + REP * D;
  float* a_s = p_s + REP * keys;
  float* m_s = a_s + REP;
  float* l_s = m_s + REP;
  int32_t* tab_s = reinterpret_cast<int32_t*>(l_s + REP);

  const size_t head0 = (size_t)t * H + (size_t)g * REP;
  T* o = out + head0 * D;
  const int pos = positions[t];
  if (!valid[t] || pos < 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) o[r * D + d] = from_float<T>(0.f);
    return;
  }
  // only the columns this token can see
  const int n_cols = min(pos / BS + 1, MP);
  const int32_t* row = tables + (size_t)slot_ids[t] * MP;
  for (int c = d; c < n_cols; c += D) tab_s[c] = row[c];
  const T* qt = q + head0 * D;
#pragma unroll
  for (int r = 0; r < REP; ++r) q_s[r * D + d] = to_float(qt[r * D + d]);
  if (d < REP) {
    m_s[d] = -INFINITY;
    l_s[d] = 0.f;
  }
  __syncthreads();

  // unassigned (-1) pages are skipped
  auto next_col = [&](int c) {
    while (c < n_cols && (tab_s[c] < 0 || tab_s[c] >= P)) ++c;
    return c;
  };
  // Stage up to KC visible pages from column `col` into buffer `buf`;
  // returns the pages staged, the last column staged and the next column.
  struct Chunk {
    int pages, last, next;
  };
  auto fetch = [&](int col, int buf) {
    T* kb = kv + (2 * buf) * keys * D;
    T* vb = kb + keys * D;
    Chunk ch{0, -1, col};
    while (ch.pages < KC && ch.next < n_cols) {
      const size_t base = ((size_t)tab_s[ch.next] * KVH + g) * (size_t)tile;
      const int dst = ch.pages * tile;
      for (int e = d * VE; e < tile; e += D * VE) {
        cp_async16(kb + dst + e, k_pool + base + e);
        cp_async16(vb + dst + e, v_pool + base + e);
      }
      ch.last = ch.next;
      ++ch.pages;
      ch.next = next_col(ch.next + 1);
    }
    return ch;
  };

  float acc[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) acc[r] = 0.f;

  Chunk cur = fetch(next_col(0), 0);
  cp_async_commit();
  for (int buf = 0; cur.pages > 0; buf ^= 1) {
    const Chunk nxt = fetch(cur.next, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prev();  // this chunk's pages have landed
    __syncthreads();
    const T* kb = kv + (2 * buf) * keys * D;
    const T* vb = kb + keys * D;
    // every staged page is full except the one holding position `pos`
    int n_keys = cur.pages * BS;
    if (cur.last == pos / BS) n_keys -= BS - (pos - cur.last * BS + 1);
    for (int idx = warp; idx < REP * n_keys; idx += NW) {
      const int r = idx / n_keys;
      const int kk = idx - r * n_keys;
      float s = 0.f;
#pragma unroll
      for (int e = lane; e < D; e += 32) s += q_s[r * D + e] * to_float(kb[kk * D + e]);
      s = warp_sum(s);
      if (lane == 0) p_s[r * keys + kk] = s * scale;
    }
    __syncthreads();
    for (int r = warp; r < REP; r += NW) {
      float* pr = p_s + r * keys;
      const float m_old = m_s[r];
      float mx = m_old;
      for (int kk = lane; kk < n_keys; kk += 32) mx = fmaxf(mx, pr[kk]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int kk = lane; kk < n_keys; kk += 32) {
        const float e = expf(pr[kk] - mx);
        pr[kk] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - mx);  // 0 on the first chunk
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = mx;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float a = acc[r] * a_s[r];
      const float* pr = p_s + r * keys;
      for (int kk = 0; kk < n_keys; ++kk) a += pr[kk] * to_float(vb[kk * D + d]);
      acc[r] = a;
    }
    __syncthreads();  // this buffer is refilled two chunks on
    cur = nxt;
  }
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const float l = l_s[r];
    o[r * D + d] = from_float<T>(l > 0.f ? acc[r] / l : 0.f);
  }
}

template <typename T, int D, int REP>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int32_t* tables, const int32_t* slot_ids,
                   const int32_t* positions, const uint8_t* valid, void* out,
                   int T_, int H, int KVH, int P, int BS, int MP, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(D, REP, BS, MP);
  auto kernel = ragged_attention_kernel<T, D, REP>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(T_, KVH), dim3(D), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, slot_ids, positions, valid,
      static_cast<T*>(out), H, KVH, P, BS, MP, pages_per_chunk(BS), scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_rep(int rep, const void* q, const void* k_pool, const void* v_pool,
                   const int32_t* tables, const int32_t* slot_ids,
                   const int32_t* positions, const uint8_t* valid, void* out,
                   int T_, int H, int KVH, int P, int BS, int MP, float scale,
                   cudaStream_t stream) {
#define PTT_REP_CASE(R)                                                         \
  case R:                                                                      \
    return launch<T, D, R>(q, k_pool, v_pool, tables, slot_ids, positions,     \
                           valid, out, T_, H, KVH, P, BS, MP, scale, stream);
  switch (rep) {
    PTT_REP_CASE(1)
    PTT_REP_CASE(2)
    PTT_REP_CASE(4)
    PTT_REP_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef PTT_REP_CASE
}

template <typename T>
cudaError_t by_head_dim(int D, int rep, const void* q, const void* k_pool,
                        const void* v_pool, const int32_t* tables,
                        const int32_t* slot_ids, const int32_t* positions,
                        const uint8_t* valid, void* out, int T_, int H, int KVH,
                        int P, int BS, int MP, float scale, cudaStream_t stream) {
  if (D == 64)
    return by_rep<T, 64>(rep, q, k_pool, v_pool, tables, slot_ids, positions,
                         valid, out, T_, H, KVH, P, BS, MP, scale, stream);
  if (D == 128)
    return by_rep<T, 128>(rep, q, k_pool, v_pool, tables, slot_ids, positions,
                          valid, out, T_, H, KVH, P, BS, MP, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (the only one this file takes). Returns a cudaError_t
// value.
int ptt_ragged_attention(const void* q, const void* k_pool, const void* v_pool,
                         const void* tables, const void* slot_ids,
                         const void* positions, const void* valid, void* out,
                         int T_, int H, int KVH, int D, int P, int BS, int MP,
                         int dtype, float scale, void* stream) {
  if (T_ == 0) return 0;
  if (KVH <= 0 || H % KVH != 0) return (int)cudaErrorInvalidValue;
  const int rep = H / KVH;
  const auto* tab = static_cast<const int32_t*>(tables);
  const auto* sid = static_cast<const int32_t*>(slot_ids);
  const auto* pos = static_cast<const int32_t*>(positions);
  const auto* val = static_cast<const uint8_t*>(valid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = by_head_dim<float>(D, rep, q, k_pool, v_pool, tab, sid, pos, val, out,
                             T_, H, KVH, P, BS, MP, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
