// Ragged paged attention in bf16 for the continuous-batching engine on Hopper
// (sm_90a): a work plan built on the card, a persistent kernel that walks the
// plan's items with TMA page loads and wgmma, and a combine of split key
// ranges.
//
// Replaces paddle_tpu/kernels/ragged_pallas.py:ragged_decode_attention
// (_rpa_kernel). Same function: every packed query token t runs a softmax
// over the K/V slots of its own sequence's page list, seeing the slots whose
// absolute position is <= positions[t] on pages whose table entry is not -1;
// grouped-query attention maps query head h to kv head h / rep; invalid rows
// are written as zeros. P is rounded to bf16 before P V, as the JAX kernel
// rounds it (ragged_pallas.py:90). float32 inputs take ragged_attention.cu.
//
// Bound on the H100: bytes. A decode token uses each K/V slot for 4 D flops
// per query head against 4 D bytes; a prefill chunk's rows share its pages,
// but at the engine's chunk of 256 rows the function still moves more bytes
// than its products need at the card's ~295 flop/byte.
//
// Three kernels a call, on the caller's stream, with no value sent back to
// the host (so a CUDA graph can capture the call); a call given a plan made
// for its batch by an earlier call (the serving step's other layers) skips
// the first:
//   1. ragged_attention_plan_kernel (one block) reads slot_ids, positions and
//      valid and writes the work items and their count, and per row the
//      splits of its tile (kernels/ragged_attention.py defines the plan;
//      ragged_plan_plain computes it in Python). A query tile is a run of
//      consecutive live rows of one slot at consecutive positions, cut every
//      BQ = 64 / rep rows, so that a tile's rows times the group's heads are
//      the 64 rows of one wgmma; a decode token is a tile of one row. A
//      split is a piece of at most ks keys of the tile's visible range; an
//      item is (tile, split, kv head). The count is rewritten on every call.
//   2. ragged_attention_wgmma_kernel: a persistent grid of two blocks an SM
//      whose blocks take items blockIdx.x, + gridDim.x, ... Each block is a
//      producer warp and one consumer warpgroup:
//      * the producer loads the tile's queries by TMA (a [BQ tokens, rep
//        heads, 64 columns] box of q [T, H, D]: the 64 rows in the order
//        token-major, group head minor; a one-row tile's box is its rep
//        rows) into a ring of Q_BUFS tiles, then the split's pages, skipping
//        -1 entries, into a ring of stages of 64 key rows; each page of one
//        kv head is a TMA box of the pool seen as [P * kvh, bs, D], written
//        as 128B-swizzled 64-column panels (the layout the wgmma helpers of
//        hopper_common.cuh read). A page of bs <= 64 keys takes a slot of
//        round_up(bs, 8) rows (so every box starts 1024-byte aligned; the
//        rows past bs are never written and stay zero), and a stage holds
//        64 / that slots; a longer page takes 64-row segments, one a stage,
//        the rows past bs zero-filled by TMA;
//      * the producer's 32 lanes share its work: they read 32 table entries
//        at once, rank the assigned pages by a ballot, and each lane issues
//        the loads of its own page and writes its slot's entry in the
//        stage's slot table (the key position of the slot's first row and
//        its rows of keys); the items and the next item's first 32 table
//        entries are loaded one item ahead. A single thread issuing all of
//        this held the consumers waiting for data half of the time;
//      * the consumers compute S = Q K^T (SS wgmma, m64 n64), mask by the
//        key positions from the slot table against each row's own position
//        (the causal limit inside a chunk, holes, the split's end), run the
//        online softmax in registers on the accumulator, and O += P V (RS
//        wgmma, P from registers). A decode tile uses 1..8 of the 64 rows:
//        at this bound the tensor cores have time to spare (without any
//        product the kernel ran within 8% of its time), and one code path
//        serves both kinds of tile. For GQA one K/V page serves the group's
//        rep heads;
//      * two blocks an SM, each with a ring of two 32 KB stages (D = 128),
//        measured faster than one block with four: a block's producer and
//        consumers each add latency per stage, and a second block hides it;
//      * every wait on a barrier traps after ~10 s (hopper_common.cuh's
//        guarded wait), so a fault in the protocol ends the launch with an
//        error instead of holding the card;
//      * a tile of one split writes its bf16 output; an item of a split tile
//        writes its unnormalised fp32 output, row max and row sum to a
//        workspace [T, H, n_splits_max, D]; before its first item, each
//        block writes the zeros of its share of the rows that are not live.
//   3. ragged_attention_combine_kernel (a block a row and 4 heads) merges a
//      split row's partials in split order by the running-max rule and
//      writes bf16. Nothing is added with atomics: the same inputs give the
//      same bits from call to call.
// The plan's buffers and the workspace come from PyTorch's allocator. The
// sizes (ks 128 keys for a one-row tile, 512 for a longer one, two stages,
// two blocks an SM) are the fastest of paddle_tpu_torch/tools/
// ragged_variants.py's runs at chip_smoke.py's shapes.
//
// Plain C interface, loaded with ctypes. Each function returns
// cudaGetLastError() after its launches, so a refused launch is reported.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int ROWS = 64;         // rows of a tile's product; key rows of a stage
constexpr int PANEL = 64;        // bf16 columns of a 128-byte swizzled panel
constexpr int THREADS = 160;     // a consumer warpgroup and a producer warp
constexpr int PLAN_THREADS = 512;
constexpr int COMBINE_HEADS = 4;  // heads a combine block merges
constexpr int PLAN_ROWS = 12288;  // rows the plan kernel takes: 16 bytes each in shared memory
constexpr int NO_KEY = INT_MAX;  // key position of a stage slot that holds no page
constexpr int MAX_SLOTS = ROWS / 8;  // pages a stage holds at most
constexpr float LOG2E = 1.4426950408889634f;

// -- the plan --------------------------------------------------------------------------

// The exclusive scan (a max or a sum) of v over the block's threads in
// order; tmp holds 32 ints.
template <bool MAX>
__device__ int block_exclusive_scan(int v, int* tmp, int identity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = MAX ? max(x, y) : x + y;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? tmp[lane] : identity;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = MAX ? max(w, y) : w + y;
    }
    tmp[lane] = w;
  }
  __syncthreads();
  int before = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) before = identity;
  if (warp > 0) before = MAX ? max(before, tmp[warp - 1]) : before + tmp[warp - 1];
  __syncthreads();  // tmp is free again
  return before;
}

// Flags and sizes of a row in the plan kernel's shared memory.
constexpr int LIVE = 1, CONT = 2, START = 4;  // live; continues the row above; starts a tile

// One block; thread i owns rows [i * per, (i + 1) * per). Each row's slot,
// position and info word (LIVE, CONT, START, and for a tile's first row its
// rows << 8 and splits << 16) are staged in shared memory. Two scans: the
// start of each row's run (a max of run-start indices; a row's tile starts
// at the run start plus a multiple of BQ) and each thread's first item (a
// sum of items). Then the warps take the tiles in turn, each writing a
// tile's items with its 32 lanes on consecutive items.
__global__ void __launch_bounds__(PLAN_THREADS)
ragged_attention_plan_kernel(const int32_t* __restrict__ slot_g, const int32_t* __restrict__ pos_g,
                             const uint8_t* __restrict__ valid_g, int4* __restrict__ items,
                             int32_t* __restrict__ count, int32_t* __restrict__ row_splits, int T,
                             int KVH, int BS, int MP, int BQ, int ks_dec, int ks_pre, int cap) {
  __shared__ int tmp[32];
  extern __shared__ int rows_s[];  // [T] slot, [T] position, [T] info, [T] first item
  int* slot = rows_s;
  int* pos = rows_s + T;
  int* info = rows_s + 2 * T;
  int* slot_first = rows_s + 3 * T;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const int p = pos_g[t];
    slot[t] = slot_g[t];
    pos[t] = p;
    info[t] = valid_g[t] != 0 && p >= 0 ? LIVE : 0;
  }
  __syncthreads();
  const int per = (T + blockDim.x - 1) / blockDim.x;
  const int r0 = min(T, (int)threadIdx.x * per), r1 = min(T, r0 + per);
  int last = -1;
  for (int t = r0; t < r1; ++t) {
    const bool cont = t > 0 && (info[t] & LIVE) && (info[t - 1] & LIVE) &&
                      slot[t] == slot[t - 1] && pos[t] == pos[t - 1] + 1;
    if (!cont) last = t;
    else info[t] |= CONT;
  }
  const int carry = block_exclusive_scan<true>(last, tmp, -1);  // syncs: CONT is visible
  // the last row of each tile writes the tile's rows and splits into the
  // word of its first row
  int start = carry;
  for (int t = r0; t < r1; ++t) {
    const int f = info[t];
    if (!(f & CONT)) start = t;
    if (!(f & LIVE)) continue;
    if (t + 1 < T && (info[t + 1] & CONT) && (t + 1 - start) % BQ) continue;
    const int first = start + (t - start) / BQ * BQ, n = t - first + 1;
    const long long keys = min((long long)pos[t] + 1, (long long)MP * BS);
    const int ks = n == 1 ? ks_dec : ks_pre;
    const int ns = (int)((keys + ks - 1) / ks);
    atomicOr(&info[first], START | n << 8 | ns << 16);
  }
  __syncthreads();
  int mine = 0;
  start = carry;
  for (int t = r0; t < r1; ++t) {
    const int f = info[t];
    if (!(f & CONT)) start = t;
    row_splits[t] = f & LIVE ? info[start + (t - start) / BQ * BQ] >> 16 : 0;
    if (f & START) mine += (f >> 16) * KVH;
  }
  int off = block_exclusive_scan<false>(mine, tmp, 0);
  if (threadIdx.x == blockDim.x - 1) *count = min(off + mine, cap);
  for (int t = r0; t < r1; ++t)  // each tile's first item, in its first row's slot word
    if (info[t] & START) {
      slot_first[t] = off;
      off += (info[t] >> 16) * KVH;
    }
  __syncthreads();
  // warp w writes the items of the tiles starting at rows w, w + warps, ...
  const int lane = threadIdx.x & 31, n_warps = blockDim.x / 32;
  for (int t = threadIdx.x / 32; t < T; t += n_warps) {
    const int f = info[t];
    if (!(f & START)) continue;
    const int n = (f >> 8) & 0xFF, ns = f >> 16, first = slot_first[t];
    for (int j = lane; j < ns * KVH && first + j < cap; j += 32) {
      items[2 * (first + j)] = make_int4(t, n, j / KVH, ns);
      items[2 * (first + j) + 1] = make_int4(j % KVH, pos[t], slot[t], 0);
    }
  }
}

// -- attention ---------------------------------------------------------------------------

// Byte offsets in the 1024-aligned dynamic shared memory: Q_BUFS query
// tiles, the K and V stages, each stage's slot table (per slot the key
// position of its first row, NO_KEY if empty, then per slot its rows of
// keys) and last-stage flag, and the barriers q_full[Q_BUFS],
// q_empty[Q_BUFS], full[stages], empty[stages].
constexpr int Q_BUFS = 2;
struct Layout {
  int q, k, v, meta, last, bar, bytes;
};
__host__ __device__ inline Layout layout(int D, int stages) {
  Layout L;
  const int tile = ROWS * D * 2;
  L.q = 0;
  L.k = Q_BUFS * tile;
  L.v = L.k + stages * tile;
  L.meta = L.v + stages * tile;
  L.last = L.meta + stages * 2 * MAX_SLOTS * 4;
  L.bar = (L.last + stages * 4 + 7) & ~7;
  L.bytes = L.bar + (2 * Q_BUFS + 2 * stages) * 8;
  return L;
}

struct Geometry {     // how pages fill the stages
  int slot_rows;      // stage rows a page (or a page's segment) takes
  int slots;          // pages (or segments) a stage holds
  int box_rows;       // rows of a page's TMA box
  int segs;           // segments of a page
};
__host__ __device__ inline Geometry geometry(int BS) {
  Geometry g;
  if (BS <= ROWS) {
    g.slot_rows = (BS + 7) / 8 * 8;
    g.slots = ROWS / g.slot_rows;
    g.box_rows = BS;
    g.segs = 1;
  } else {
    g.slot_rows = ROWS;
    g.slots = 1;
    g.box_rows = ROWS;
    g.segs = (BS + ROWS - 1) / ROWS;
  }
  return g;
}

struct Params {
  const int4* items;  // two a work item: (first row, rows, split, splits), (kv head, first position, slot, 0)
  const int32_t* count;
  const int32_t* tables;
  const int32_t* row_splits;
  bf16* out;
  float* ws;
  float2* ml;
  int T, H, KVH, P, BS, MP, rep, ks_dec, ks_pre, nsmax, stages, q_tile_rows;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 2)  // two blocks an SM: at most 204 registers
ragged_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq_tile,
                              const __grid_constant__ CUtensorMap tq_row,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv, const Params a) {
  constexpr int TILE = ROWS * D * 2;  // bytes of a Q tile and of a K or V stage
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const uint32_t base = smem_u32(sm);
  const Layout L = layout(D, a.stages);
  const Geometry geo = geometry(a.BS);
  int* meta = reinterpret_cast<int*>(sm + L.meta);
  int* last = reinterpret_cast<int*>(sm + L.last);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L.bar);
  uint64_t* q_empty = q_full + Q_BUFS;
  uint64_t* full = q_empty + Q_BUFS;
  uint64_t* empty = full + a.stages;

  // Q and the stages start zero: rows no box writes (past bs in a page's
  // slot, past the tile's rows) must hold finite values, since P V
  // multiplies a masked row's V by p = 0.
  for (int i = threadIdx.x; i < L.meta / 16; i += THREADS)
    reinterpret_cast<int4*>(sm)[i] = make_int4(0, 0, 0, 0);
  fence_proxy_async();
  if (threadIdx.x == 0) {
    for (int b = 0; b < Q_BUFS; ++b) {
      mbar_init(&q_full[b], 1);
      mbar_init(&q_empty[b], 4);
    }
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int n_items = *a.count;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;

  if (warp == 4) {  // the producer warp
    constexpr unsigned ALL = 0xffffffffu;
    const int slot_bytes = 2 * (D / PANEL) * geo.box_rows * 128;
    int st = 0, ph = 0, qb = 0, qph = 0;
    // an item's split: its table row and columns [c0, c1)
    auto split_cols = [&](const int4& ia, const int4& ib, const int32_t*& tab, int& c0, int& c1) {
      tab = a.tables + (size_t)ib.z * a.MP;
      const long long keys = min((long long)ib.y + ia.y, (long long)a.MP * a.BS);
      const int ks = ia.y == 1 ? a.ks_dec : a.ks_pre;
      const int k0 = ia.z * ks;
      const int k1 = (int)min((long long)k0 + ks, keys);
      c0 = k0 / a.BS;
      c1 = (k1 + a.BS - 1) / a.BS;
    };
    // the table entries of an item's first 32 columns, one a lane (-1 past
    // its columns)
    auto first_window = [&](const int4& ia, const int4& ib) {
      const int32_t* tab;
      int c0, c1;
      split_cols(ia, ib, tab, c0, c1);
      return c0 + lane < c1 ? tab[c0 + lane] : -1;
    };
    // loads run ahead: the items one and two ahead, the first window of the
    // next one, so that no item waits on a round trip for its metadata
    const int G = gridDim.x;
    int4 cur_a = make_int4(0, 0, 0, 0), cur_b = cur_a, nxt_a = cur_a, nxt_b = cur_a;
    int win = -1;
    if ((int)blockIdx.x < n_items) {
      cur_a = a.items[2 * blockIdx.x], cur_b = a.items[2 * blockIdx.x + 1];
      win = first_window(cur_a, cur_b);
    }
    if ((int)blockIdx.x + G < n_items)
      nxt_a = a.items[2 * (blockIdx.x + G)], nxt_b = a.items[2 * (blockIdx.x + G) + 1];
    for (int it = blockIdx.x; it < n_items; it += G) {
      const int4 ia = cur_a, ib = cur_b;
      const int w0 = win;
      cur_a = nxt_a, cur_b = nxt_b;
      if (it + G < n_items) win = first_window(cur_a, cur_b);
      if (it + 2 * G < n_items)
        nxt_a = a.items[2 * (it + 2 * G)], nxt_b = a.items[2 * (it + 2 * G) + 1];
      const int t0 = ia.x, n = ia.y, g = ib.x;
      if (lane == 0) {
        mbar_wait_guarded(&q_empty[qb], qph ^ 1);
        const int q_rows = n == 1 ? a.rep : a.q_tile_rows;
        mbar_expect_tx(&q_full[qb], q_rows * 128 * (D / PANEL));
#pragma unroll
        for (int p = 0; p < D / PANEL; ++p)
          tma_load(base + L.q + qb * TILE + p * ROWS * 128, n == 1 ? &tq_row : &tq_tile,
                   &q_full[qb], p * PANEL, g * a.rep, t0);
      }
      if (++qb == Q_BUFS) qb = 0, qph ^= 1;

      // the split's assigned pages, counted 32 columns a time by the lanes
      const int32_t* tab;
      int c0, c1;
      split_cols(ia, ib, tab, c0, c1);
      // page of column c + lane: from the first window while it covers it
      auto page_at = [&](int c) {
        const int src = c - c0 + lane;
        const int from_window = __shfl_sync(ALL, w0, src & 31);
        return c + lane >= c1 ? -1 : src < 32 ? from_window : tab[c + lane];
      };
      // a window of 32 columns fills stages of its own: its assigned pages
      // in order, geo.slots a stage (or, pages longer than a stage, a
      // segment a stage); lane l holds column cb + l and its page's rank
      auto window_stages = [&](unsigned m) {
        return (__popc(m) * geo.segs + geo.slots - 1) / geo.slots;
      };
      int n_stages = 0;
      for (int cb = c0; cb < c1; cb += 32) {
        const int pg = page_at(cb);
        n_stages += window_stages(__ballot_sync(ALL, pg >= 0 && pg < a.P));
      }
      const bool no_page = n_stages == 0;  // one empty stage ends the item
      int s = 0;
      for (int cb = c0; cb < c1; cb += 32) {
        const int pg = page_at(cb);
        const bool ok = pg >= 0 && pg < a.P;
        const unsigned m = __ballot_sync(ALL, ok);
        const int rank = __popc(m & ((1u << lane) - 1));
        const int ws = no_page ? cb == c0 : window_stages(m);
        for (int w = 0; w < ws; ++w, ++s) {
          if (lane == 0) mbar_wait_guarded(&empty[st], ph ^ 1);
          __syncwarp();
          int* sm_slots = meta + st * 2 * MAX_SLOTS;
          if (lane < MAX_SLOTS) sm_slots[lane] = NO_KEY, sm_slots[MAX_SLOTS + lane] = 0;
          __syncwarp();
          const bool mine = ok && (geo.segs == 1 ? rank / geo.slots == w : rank == w / geo.segs);
          const int slot = geo.segs == 1 ? rank % geo.slots : 0;
          const int seg = geo.segs == 1 ? 0 : w % geo.segs;
          if (mine) {
            sm_slots[slot] = (cb + lane) * a.BS + seg * ROWS;
            sm_slots[MAX_SLOTS + slot] = min(geo.box_rows, a.BS - seg * ROWS);
          }
          if (lane == 0) last[st] = s == max(n_stages, 1) - 1;
          const int used = __popc(__ballot_sync(ALL, mine));
          if (lane == 0) mbar_expect_tx(&full[st], used * slot_bytes);
          __syncwarp();
          if (mine) {
            const uint32_t off = slot * geo.slot_rows * 128;
            const uint32_t k_s = base + L.k + st * TILE + off, v_s = base + L.v + st * TILE + off;
            const int row = pg * a.KVH + g;
#pragma unroll
            for (int p = 0; p < D / PANEL; ++p) {
              tma_load(k_s + p * ROWS * 128, &tk, &full[st], p * PANEL, seg * ROWS, row);
              tma_load(v_s + p * ROWS * 128, &tv, &full[st], p * PANEL, seg * ROWS, row);
            }
          }
          if (++st == a.stages) st = 0, ph ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: thread (warp w, lane 4 gq + t4) holds rows 16 w + gq
  // and 16 w + gq + 8 of the tile's product, columns 8 j + 2 t4 (+1)
  const int t4 = lane & 3;
  const int m_lo = 16 * warp + (lane >> 2);
  int slot_of[ROWS / 8];  // the stage slot of each 8-column group
#pragma unroll
  for (int j = 0; j < ROWS / 8; ++j) slot_of[j] = j / (geo.slot_rows / 8);
  const float c = a.scale * LOG2E;
  // while the first pages load: the zeros of the rows that are not live
  for (int t = blockIdx.x; t < a.T; t += gridDim.x)
    if (a.row_splits[t] == 0)
      for (int e = threadIdx.x * 8; e < a.H * D; e += 128 * 8)
        *reinterpret_cast<int4*>(a.out + (size_t)t * a.H * D + e) = make_int4(0, 0, 0, 0);
  int st = 0, ph = 0, qb = 0, qph = 0;
  int4 next_a = make_int4(0, 0, 0, 0), next_b = next_a;
  if ((int)blockIdx.x < n_items) next_a = a.items[2 * blockIdx.x], next_b = a.items[2 * blockIdx.x + 1];
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int4 ia = next_a, ib = next_b;
    if (it + (int)gridDim.x < n_items) {
      next_a = a.items[2 * (it + gridDim.x)];
      next_b = a.items[2 * (it + gridDim.x) + 1];
    }
    const int t0 = ia.x, n = ia.y, split = ia.z, n_splits = ia.w;
    const int g = ib.x;
    const int pos0 = ib.y;
    int lim[2];  // the last key position each row sees; -1 past the tile's rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = (m_lo + 8 * r) / a.rep;
      lim[r] = i < n ? pos0 + i : -1;
    }
    float o[D / 2];
    zero(o);
    float m[2] = {-INFINITY, -INFINITY};  // running max of s * scale * log2(e)
    float l[2] = {0.f, 0.f};
    mbar_wait_guarded(&q_full[qb], qph);
    const uint32_t q_s = base + L.q + qb * TILE;
    for (;;) {
      mbar_wait_guarded(&full[st], ph);
      const uint32_t k_s = base + L.k + st * TILE, v_s = base + L.v + st * TILE;
      float s[ROWS / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<ROWS>(s, kmajor(q_s, ROWS, 0, kk), kmajor(k_s, ROWS, 0, kk), kk);
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);

      // column 8 j + 2 t4 + (e & 1) is row jr + (e & 1) of slot sl: its key
      // position, or masked past the slot's keys
      const int* sm_slots = meta + st * 2 * MAX_SLOTS;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < ROWS / 8; ++j) {
        const int sl = slot_of[j];
        const int jr = 8 * j + 2 * t4 - sl * geo.slot_rows;
        const int key0 = sm_slots[sl], rows = sm_slots[MAX_SLOTS + sl];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = jr + (e & 1);
          const int r = e >> 1;
          float x = s[4 * j + e] * c;
          if (jj >= rows || key0 + jj > lim[r]) x = -INFINITY;
          s[4 * j + e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      }
      float mu[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        mu[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // a row that has seen no key yet
        alpha[r] = m[r] == -INFINITY ? 0.f : exp2_ftz(m[r] - mx[r]);
      }
#pragma unroll
      for (int i = 0; i < ROWS / 2; ++i) {
        const float p = exp2_ftz(s[i] - mu[(i >> 1) & 1]);  // 0 where masked
        s[i] = p;
        sum[(i >> 1) & 1] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = alpha[r] * l[r] + quad_sum(sum[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      uint32_t pa[ROWS / 16][4];
      to_a<ROWS>(pa, s);  // P rounded to v's dtype
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk) wgmma_rs<D>(o, pa[kk], mnmajor(v_s, ROWS, 16 * kk));
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
      const int is_last = last[st];
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      if (++st == a.stages) st = 0, ph ^= 1;
      if (is_last) break;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&q_empty[qb]);
    if (++qb == Q_BUFS) qb = 0, qph ^= 1;

    const int rows = n * a.rep;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int mrow = m_lo + 8 * r;
      if (mrow >= rows) continue;
      const size_t th = (size_t)(t0 + mrow / a.rep) * a.H + g * a.rep + mrow % a.rep;
      if (n_splits == 1) {
        const float div = l[r] == 0.f ? 1.f : l[r];
        bf16* dst = a.out + th * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * t4) =
              pack_bf16(o[4 * j + 2 * r] / div, o[4 * j + 2 * r + 1] / div);
      } else {
        const size_t part = th * a.nsmax + split;
        float* dst = a.ws + part * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(dst + 8 * j + 2 * t4) =
              make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
        if (t4 == 0) a.ml[part] = make_float2(m[r], l[r]);
      }
    }
  }
}

// -- combine -----------------------------------------------------------------------------

// A block a (row, COMBINE_HEADS heads), a thread a (head, 4 columns): a
// split row's partials merged in split order by the running-max rule, eight
// splits' loads in flight together. A row of one split was written by the
// attention kernel, and the zeros of a row that is not live too.
template <int D>
__global__ void __launch_bounds__(COMBINE_HEADS * D / 4)
ragged_attention_combine_kernel(const int32_t* __restrict__ row_splits, const float* __restrict__ ws,
                                const float2* __restrict__ ml, bf16* __restrict__ out, int H,
                                int nsmax) {
  const int t = blockIdx.x;
  const int h = blockIdx.y * COMBINE_HEADS + threadIdx.x / (D / 4);
  const int d = threadIdx.x % (D / 4) * 4;
  const int ns = row_splits[t];
  if (ns <= 1 || h >= H) return;
  const float2* mlr = ml + ((size_t)t * H + h) * nsmax;
  const float* part = ws + ((size_t)t * H + h) * nsmax * D + d;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float big = -INFINITY, sum = 0.f;  // running max and sum, as in the attention kernel
  for (int s0 = 0; s0 < ns; s0 += 8) {
    float2 v[8];
    float4 x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (s0 + i < ns) {
        v[i] = mlr[s0 + i];
        x[i] = *reinterpret_cast<const float4*>(part + (size_t)(s0 + i) * D);
      }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (s0 + i >= ns || v[i].x == -INFINITY) continue;  // no key of this row in the split
      const float top = fmaxf(big, v[i].x);
      const float p = exp2f(big - top), w = exp2f(v[i].x - top);  // p = 0 on the first
      sum = p * sum + w * v[i].y;
      acc = make_float4(p * acc.x + w * x[i].x, p * acc.y + w * x[i].y, p * acc.z + w * x[i].z,
                        p * acc.w + w * x[i].w);
      big = top;
    }
  }
  const float div = sum == 0.f ? 1.f : sum;
  uint2 v;
  v.x = pack_bf16(acc.x / div, acc.y / div);
  v.y = pack_bf16(acc.z / div, acc.w / div);
  *reinterpret_cast<uint2*>(out + ((size_t)t * H + h) * D + d) = v;
}

cudaError_t launch_plan(const void* slot_ids, const void* positions, const void* valid, void* items,
                        void* count, void* row_splits, int T, int KVH, int BS, int MP, int BQ,
                        int ks_dec, int ks_pre, int cap, cudaStream_t s) {
  if (T > PLAN_ROWS) return cudaErrorInvalidValue;
  const size_t smem = (size_t)4 * T * sizeof(int);
  static size_t prepared = 48 * 1024;
  if (smem > prepared) {
    const cudaError_t err = prepare(ragged_attention_plan_kernel, smem);
    if (err != cudaSuccess) return err;
    prepared = smem;
  }
  ragged_attention_plan_kernel<<<1, PLAN_THREADS, smem, s>>>(
      static_cast<const int32_t*>(slot_ids), static_cast<const int32_t*>(positions),
      static_cast<const uint8_t*>(valid), static_cast<int4*>(items), static_cast<int32_t*>(count),
      static_cast<int32_t*>(row_splits), T, KVH, BS, MP, BQ, ks_dec, ks_pre, cap);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_attention(const CUtensorMap& tq_tile, const CUtensorMap& tq_row,
                             const CUtensorMap& tk, const CUtensorMap& tv, const Params& p,
                             int grid, cudaStream_t s) {
  auto kernel = ragged_attention_wgmma_kernel<D>;
  const size_t smem = layout(D, p.stages).bytes + 1024;
  static size_t prepared = 0;
  if (smem > prepared) {
    const cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    prepared = smem;
  }
  kernel<<<grid, THREADS, smem, s>>>(tq_tile, tq_row, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The plan alone: items [cap, 8], count [1], row_splits [T] (int32).
int ptt_ragged_plan(const void* slot_ids, const void* positions, const void* valid, void* items,
                    void* count, void* row_splits, int T, int KVH, int BS, int MP, int BQ,
                    int ks_dec, int ks_pre, int cap, void* stream) {
  if (T <= 0 || BQ <= 0 || ks_dec <= 0 || ks_pre <= 0) return (int)cudaErrorInvalidValue;
  return (int)launch_plan(slot_ids, positions, valid, items, count, row_splits, T, KVH, BS, MP, BQ,
                          ks_dec, ks_pre, cap, static_cast<cudaStream_t>(stream));
}

// q [T, H, D], pools [P, KVH, BS, D] bf16; out [T, H, D] bf16; the plan's
// buffers as ptt_ragged_plan's; ws [T, H, nsmax, D] and ml [T, H, nsmax, 2]
// fp32. BQ must be 64 / (H / KVH); grid blocks walk the items. make_plan 0:
// the buffers already hold this batch's plan (the serving step plans once
// and its layers share the plan), so the plan kernel is not launched.
int ptt_ragged_attention_bf16(const void* q, const void* k_pool, const void* v_pool,
                              const void* tables, const void* slot_ids, const void* positions,
                              const void* valid, void* out, void* items, void* count,
                              void* row_splits, void* ws, void* ml, int T, int H,
                              int KVH, int D, int P, int BS, int MP, int BQ, int ks_dec, int ks_pre,
                              int cap, int nsmax, int stages, int grid, int make_plan, float scale,
                              void* stream) {
  if (T <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || (D != 64 && D != 128) || BS <= 0 || stages < 2 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  const int rep = H / KVH;
  if (rep * BQ != ROWS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (make_plan) {
    err = launch_plan(slot_ids, positions, valid, items, count, row_splits, T, KVH, BS, MP, BQ,
                      ks_dec, ks_pre, cap, s);
    if (err != cudaSuccess) return (int)err;
  }
  // q seen as [T, H, D]: a tile's box is [min(BQ, T) tokens, rep heads, 64
  // columns], a one-row tile's [1, rep, 64]; the pools as [P * KVH, BS, D]
  const Geometry geo = geometry(BS);
  const int q_tokens = T < BQ ? T : BQ;
  CUtensorMap tq_tile, tq_row, tk, tv;
  if (!hopper::tensor_map(&tq_tile, q, true, D, H, T, PANEL, rep, q_tokens) ||
      !hopper::tensor_map(&tq_row, q, true, D, H, T, PANEL, rep, 1) ||
      !hopper::tensor_map(&tk, k_pool, true, D, BS, P * KVH, PANEL, geo.box_rows) ||
      !hopper::tensor_map(&tv, v_pool, true, D, BS, P * KVH, PANEL, geo.box_rows))
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const int4*>(items), static_cast<const int32_t*>(count),
           static_cast<const int32_t*>(tables), static_cast<const int32_t*>(row_splits),
           static_cast<bf16*>(out), static_cast<float*>(ws),
           static_cast<float2*>(ml), T, H, KVH, P, BS, MP, rep, ks_dec, ks_pre, nsmax, stages,
           q_tokens * rep, scale};
  err = D == 128 ? launch_attention<128>(tq_tile, tq_row, tk, tv, p, grid, s)
                 : launch_attention<64>(tq_tile, tq_row, tk, tv, p, grid, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_c(T, (H + COMBINE_HEADS - 1) / COMBINE_HEADS);
  if (D == 128)
    ragged_attention_combine_kernel<128><<<grid_c, COMBINE_HEADS * 32, 0, s>>>(
        static_cast<const int32_t*>(row_splits), static_cast<const float*>(ws),
        static_cast<const float2*>(ml), static_cast<bf16*>(out), H, nsmax);
  else
    ragged_attention_combine_kernel<64><<<grid_c, COMBINE_HEADS * 16, 0, s>>>(
        static_cast<const int32_t*>(row_splits), static_cast<const float*>(ws),
        static_cast<const float2*>(ml), static_cast<bf16*>(out), H, nsmax);
  return (int)cudaGetLastError();
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
