// Multi-scale deformable attention, backward: from the gradient of the
// output, the gradients of the value planes, the sampling locations and the
// attention weights, with the forward's semantics (csrc/msda.cu).
//
// Replaces: the custom VJPs of demf_tpu/ops/msda.py, _make_small_q_msda's
// _bwd (the decoder route, one-hot matmul d_value) and _make_msda's _bwd /
// _bwd_saved (the encoder route, quad-plane banded scatter).  Neither TPU
// layout is carried over: this kernel computes mmcv ms_deform_attn_backward
// directly (zero padding, align_corners=False, x = loc_x * W - 0.5).
//
// Per sample s = (batch, query, head, level, point) with attention a,
// bilinear corner weights w_k and upstream gradient g (one head's channels):
//   d_value[corner_k] += a * w_k * g
//   d_attn[s]          = sum_c sum_k w_k * g_c * v_k,c
//   d_loc_x[s]         = W * a * sum_c sum_k g_c * v_k,c * dw_k/dx
//   d_loc_y[s]         = H * a * sum_c sum_k g_c * v_k,c * dw_k/dy
//
// What bounds it on the card: the function must move value, locations,
// weights and grad_out in and the three gradients out once, but every
// sample adds to four rows of d_value and reads four rows of value at
// data-dependent places.  Done one by one through L2 (four fp32 atomics a
// sample and channel, 731 M at the encoder's shape of batch 2), the L2's
// atomic rate decides, some 20 times the byte bound.
//
// What this design does about it:
// - In the encoder the queries are the levels' own pixels and a query's
//   samples lie a few pixels around its own position on every level.  A
//   block owns a spatial tile of one level's queries for one head, K3's
//   tiling (csrc/msda_window.cuh, ops/msda.py::msda_tiling), keeps the
//   tile's grad_out rows in shared memory and goes through the levels with
//   the level's window of value rows under the tile in shared memory too
//   (cp.async; the next level's window is copied while this one is used).
// - Shared memory has no float atomic (the compiler makes a compare-and-
//   swap loop of it, and a d_value window summed that way cost as much as
//   everything else in the kernel).  So nothing is summed in shared memory;
//   a level takes two phases.  Sample-major: a thread owns 4 channels of a
//   (query, head), head_dim / 4 threads a query; they compute d_attn and
//   d_loc of the query's samples (sums over the channels by warp shuffles,
//   no atomics), and every corner that lies in the window becomes an
//   entry: its weight a * w_k, linked into a list of its window row with
//   one integer atomicExch.  Row-major: the threads of a slot walk a list,
//   sum weight * grad_out of the entries' queries in registers, and add
//   the sum to d_value with one 16-byte global reduction (atomicAdd on
//   float4, native on sm_90).  Global atomics fall from one a corner and
//   channel to about one a window row and tile.  A coarser level has fewer
//   rows for as many samples, so its rows have several lists each (a query
//   picks one by its index).
// - A corner outside the window goes to global memory directly, read and
//   atomic, so the window decides the speed and never the result.
// - One block of 1,024 threads an SM (222 KB of shared memory).
// - Queries that are not the levels' pixels (the decoder's proposals), and
//   the pixels of levels too coarse for a tile, keep the query-major
//   mapping: one thread per (batch, query, head, channel), a warp's corner
//   reads and atomics on one contiguous row.  Both kernels run in one call.
// - x and y are rounded as loc * W, then - 0.5, without an FMA, as the
//   forward and the plain version round them.
// - One source for both value types (a template): value and grad_out in
//   float32 or bfloat16, read 16 bytes at a time (4 or 8 channels a thread)
//   and widened in registers, windows and the tile's grad_out rows in
//   shared memory in that type (a bfloat16 window has twice the rows).
//   Locations, weights and their gradients are float32.  Every sum is
//   float32: with tiles, a bfloat16 d_value is summed into a float32
//   buffer, its 16-byte global reductions as above, and rounded to
//   bfloat16 once, by a last pass over it.
//
// The row-owner route (a bfloat16 value without tiles: the decoders, whose
// queries are proposals).  There the float32 buffer cost more than all the
// rest: zeroed, summed into and read again in full (730 MB at the stage-2
// decoder's batch of 16), while a (scene, head) touches fewer than 20,000
// of its 22,323 rows.  So d_value is built from its rows, each written once
// in bfloat16, and no buffer of the value's size exists:
// - the entries kernel computes d_attn and d_loc with hd / 8 lanes a
//   (query, head), 16 bytes of channels each (as the tile kernel), and
//   writes each corner's entry in place of its atomics: a key (the
//   corner's row in its level over the entry's index in the level's run,
//   15 bits; the level's row count where the corner adds nothing) and its
//   weight a * w_k;
// - one block a (scene, head, level) sorts that level's entries by row in
//   shared memory (least significant digit first, 4 bits a pass, stable,
//   so a row's entries stay in the order of their index), writes them as
//   (weight, query) pairs, and the first entry of every row: a row's list
//   is [first[r], first[r + 1]);
// - a grid over (token rows, scene) writes each row, all heads, once: a
//   thread takes 4 rows and 8 channels of a head, reads its rows' list
//   bounds at once and a list's entries 4 at a time, sums weight *
//   grad_out of each list in float32 in that order (no FMA) and rounds
//   once.  d_value is the same bit for bit
//   from call to call, and equal to ops/msda.py::msda_backward_rows_plain.
//
// The float32 lists route (a float32 value without tiles, the decoders).
// The query-major kernel's float32 atomics land in no fixed order and need
// d_value zeroed first (on an H100 the fill took nearly half the time at
// the stage-2 decoder); the bfloat16 route's three kernels on a float32
// value move each entry through global memory twice and write d_value
// from long dependent chains.  So one kernel does it all, its lists in
// shared memory:
// - a block owns a slice of at most kListPartRows rows of one level for one
//   (scene, head) and writes that head's channels of each row once, so
//   that the writes spread over the card and not over the level-0 blocks
//   alone; its share of the (scene, head)'s samples' d_attn and d_loc comes
//   along, so the value rows are read once;
// - it keeps the corners that land on its slice, in index order, and
//   orders them by row, stably, in shared memory (an owner warp a row, two
//   passes of counted places, lanes of one key found by a ballot a bit);
// - each row is summed from its list in the plain row order, float32
//   without an FMA, from the head's grad_out rows in shared memory, and
//   stored once: no fill, no float atomic, the same bits every call, equal
//   to ops/msda.py::msda_backward_rows_plain.
#include <cuda_runtime.h>

#include <cstdint>

#include "msda_window.cuh"

namespace {

using namespace msda;

// Timing only (tools/k4_phases.py builds copies with -DK4_SKIP=1..4):
// phases 1..K4_SKIP (1 the row-major phase, 2 the linking of entries, 3 the
// sample-major phase, 4 the tile kernel) get a bound that is never true at
// run time, so the rest compiles as it is and the results are wrong.  The
// library is built without it: K4_RUNS is then true at compile time.
#ifndef K4_SKIP
#define K4_SKIP 0
#endif
#define K4_RUNS(phase, batch) (K4_SKIP < (phase) || (batch) > (1 << 30))
// The same for the float32 lists route (tools/k4_phases.py --decoder,
// -DK4_LISTS_SKIP=1..4): 1 the rows' writes, 2 the ordering by row, 3 the
// slice's entries, 4 d_attn and d_loc.
#ifndef K4_LISTS_SKIP
#define K4_LISTS_SKIP 0
#endif
#define K4_LISTS_RUNS(phase, q) (K4_LISTS_SKIP < (phase) || (q) > (1 << 30))

constexpr int kThreads = 256;        // query-major blocks
constexpr int kTileThreads = 1024;   // tile blocks, one an SM
constexpr int kMaxPoints = 4;        // points a level that a tile takes
constexpr int kEntryShift = 4;       // log2 of a query's 4 * kMaxPoints entries
// a corner of a sample of a tile on one level, in the window, is an entry
constexpr int kEntries = kMaxTile * kMaxPoints * 4;
constexpr int kHeads = 1536;         // lists of entries, some a window row
// shared memory of a tile block: the tile's grad_out rows, two sets of
// locations and weights, the entries' weights (4 bytes) and links (2), the
// lists' heads, and two windows of value rows that share what is left as
// 729 : 361 (K3's window of the finest level and of the next, at 128 bytes
// a row and 16 x 16 pixels a tile)
constexpr int kTileBytes = 227584;
constexpr int kShareA = 729, kShareB = 361;
// the row-owner route: bits of an entry's index in its key, the sort's
// threads and digits, the most entries of a (scene, head, level), the
// shared memory a sort block may take (ops/msda.py mirrors these), the
// rows of a row block and its threads
constexpr int kIdBits = 15;
constexpr int kSortThreads = 512;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;
constexpr int kMaxEntries = 22528;
constexpr int kSortSmemLimit = 232448 - 1024;
constexpr int kRowsPerGroup = 4;
constexpr int kRowThreads = 256;
constexpr int kBatch = 4;   // entries a rows thread loads at once
constexpr unsigned kFullMask = 0xffffffffu;
// the float32 lists route: a block's threads and warps, the most rows of a
// block's slice (ops/msda.py mirrors both), the bits of a row's index
// among its owner warp's rows, the stride of the owners' counts (one more
// than a row of them, so that a warp's lanes of other owners fall in
// other banks)
constexpr int kListThreads = 512;
constexpr int kListWarps = kListThreads / 32;
constexpr int kListPartRows = 2048;
constexpr int kListOwnerBits = 4;   // log2(kListWarps)
constexpr int kListRowBits = 7;     // log2(kListPartRows / kListWarps)
constexpr int kBucketStride = kListWarps + 1;
static_assert(kListWarps == 1 << kListOwnerBits &&
                  kListPartRows == kListWarps << kListRowBits,
              "the lists route's bits");

template <typename T>
struct Args {
  const T* value;
  const int* level_info;   // (levels, 3): H, W, first token
  const int* tile_info;    // (levels, 5), see msda_window.cuh
  const float* locs;
  const float* attn;
  const T* grad_out;
  float* d_value;          // float32 sums, laid out as value
  float* d_locs;
  float* d_attn;
  int b, s, q, heads, hd, levels, points;
  int tiles;         // tiles of one (scene, head), over all tiled levels
  int direct_from;   // queries from here on take the query-major kernel
  int rows_a, rows_b;   // rows of head_dim values that the windows hold
};

// Sum over the n lanes of one group; n is a power of two dividing 32 and
// groups are n-aligned, so the xor partners stay inside the group.
__device__ __forceinline__ float group_sum(float v, int n, unsigned mask) {
  for (int off = n >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off);
  return v;
}

// The lanes whose key of `bits` bits equals this lane's, among the valid
// ones (a lane not valid gets itself alone): a ballot a bit, where
// __match_any_sync takes far longer on keys that are mostly distinct.
__device__ __forceinline__ unsigned match_bits(unsigned key, int bits,
                                               bool valid) {
  unsigned peers = __ballot_sync(kFullMask, valid);
  for (int b = 0; b < bits; ++b) {
    const unsigned set = __ballot_sync(kFullMask, (key >> b) & 1u);
    peers &= (key >> b) & 1u ? set : ~set;
  }
  return valid ? peers : 1u << (threadIdx.x & 31);
}

// a slice row's place among the lists kernel's counts: a slot more every
// 32 rows, so that an owner warp's rows (kListWarps apart) fall in other
// banks
__host__ __device__ constexpr int count_slot(int j) { return j + (j >> 5); }

// sum_i a[i] * b[i], in the order 0, 1, ... (a float32 row: the order of
// the first kernel's float4 dot product)
template <int kN>
__device__ __forceinline__ float dot(const float (&a)[kN],
                                     const float (&b)[kN]) {
  float s = a[0] * b[0];
#pragma unroll
  for (int i = 1; i < kN; ++i) s = fmaf(a[i], b[i], s);
  return s;
}

// d_value[0 : kN) += w * g, as 16-byte global reductions (native on sm_90)
template <int kN>
__device__ __forceinline__ void add_rows(float* d, const float (&g)[kN],
                                         float w) {
#pragma unroll
  for (int i = 0; i < kN; i += 4)
    atomicAdd(reinterpret_cast<float4*>(d + i),
              make_float4(w * g[i], w * g[i + 1], w * g[i + 2],
                          w * g[i + 3]));
}

// one level of one tile, as the loop below needs it
template <typename T>
struct Level {
  int hl, wl;
  const T* value;   // this head's channels of the level's first row
  float* d_value;
  Window<T> win;
};

// one tile of one level's queries for one head, level after level
template <typename T>
__global__ void __launch_bounds__(kTileThreads, 1)
    msda_backward_tile_kernel(const Args<T> a) {
  constexpr int kN = Row<T>::kN;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lpq = a.hd / kN;              // threads of one (query, head)
  const int qpp = kTileThreads / lpq;     // queries of one pass
  const int slot = tid / lpq;
  const int lane_q = tid % lpq;
  const int c4 = lane_q * kN;             // this thread's first channel
  // the lanes of this thread's (query, head), for __syncwarp
  const unsigned group_mask =
      (lpq == 32 ? 0xffffffffu : (1u << lpq) - 1u) << ((tid & 31) / lpq * lpq);
  // shared memory: two value windows (level l in window l % 2), the tile's
  // grad_out rows, two sets of locations and weights, the entries' weights
  // and links, the lists' heads
  T* vwin[2] = {reinterpret_cast<T*>(smem),
                reinterpret_cast<T*>(smem) + a.rows_a * a.hd};
  const int room[2] = {a.rows_a, a.rows_b};
  T* g_tile = vwin[1] + a.rows_b * a.hd;
  float2* s_loc = reinterpret_cast<float2*>(g_tile + kMaxTile * a.hd);
  float* s_aw = reinterpret_cast<float*>(s_loc + 2 * kMaxTile * kMaxPoints);
  float* ent_w = s_aw + 2 * kMaxTile * kMaxPoints;
  int* head = reinterpret_cast<int*>(ent_w + kEntries);
  unsigned short* ent_next =
      reinterpret_cast<unsigned short*>(head + kHeads);
  int t = blockIdx.x;
  const int tile = t % a.tiles;
  t /= a.tiles;
  const int h = t % a.heads;
  const int bi = t / a.heads;
  const Tile tl = decode_tile(a.tile_info, a.level_info, a.levels, tile);
  const int nq = tl.th * tl.tw;
  const long long row_stride = static_cast<long long>(a.heads) * a.hd;
  const long long plane =
      static_cast<long long>(bi) * a.s * row_stride + h * a.hd;

  auto level = [&](int l) {
    Level<T> lv;
    lv.hl = __ldg(a.level_info + 3 * l);
    lv.wl = __ldg(a.level_info + 3 * l + 1);
    const long long level0 =
        plane +
        static_cast<long long>(__ldg(a.level_info + 3 * l + 2)) * row_stride;
    lv.value = a.value + level0;
    lv.d_value = a.d_value + level0;
    lv.win = level_window<T>(tl, lv.hl, lv.wl, room[l & 1], vwin[l & 1]);
    return lv;
  };
  // starts the copies of level l: its window of value rows and the tile's
  // locations and weights on it
  auto prefetch = [&](int l, const Level<T>& lv) {
    copy_window(vwin[l & 1], lv.win, lv.value, lv.wl, row_stride, a.hd, slot,
                qpp, c4);
    float2* to_loc = s_loc + (l & 1) * kMaxTile * kMaxPoints;
    float* to_aw = s_aw + (l & 1) * kMaxTile * kMaxPoints;
    for (int i = tid; i < nq * a.points; i += kTileThreads) {
      const int qi = i / a.points;
      const int y = tl.ty0 + qi / tl.tw;
      const int x = tl.tx0 + qi % tl.tw;
      if (y >= tl.hq || x >= tl.wq) continue;
      const long long sp =
          (((static_cast<long long>(bi) * a.q + tl.startq + y * tl.wq + x) *
                a.heads + h) * a.levels + l) * a.points + i % a.points;
      copy_async<8>(to_loc + i, reinterpret_cast<const float2*>(a.locs) + sp);
      copy_async<4>(to_aw + i, a.attn + sp);
    }
  };

  // the tile's grad_out rows, and level 0
  for (int i = tid; i < nq * lpq; i += kTileThreads) {
    const int qi = i / lpq;
    const int y = tl.ty0 + qi / tl.tw;
    const int x = tl.tx0 + qi % tl.tw;
    if (y >= tl.hq || x >= tl.wq) continue;
    copy_async<16>(g_tile + qi * a.hd + (i % lpq) * kN,
                   a.grad_out + (static_cast<long long>(bi) * a.q + tl.startq +
                                 y * tl.wq + x) * row_stride + h * a.hd +
                       (i % lpq) * kN);
  }
  for (int i = tid; i < kHeads; i += kTileThreads) head[i] = -1;
  Level<T> lv = level(0);
  prefetch(0, lv);

  for (int l = 0; l < a.levels; ++l) {
    copy_async_wait();
    __syncthreads();   // level l has arrived; the last level's lists are read
    Level<T> next;
    if (l + 1 < a.levels) {   // the next level's copies run under this one
      next = level(l + 1);
      prefetch(l + 1, next);
    }
    const Window<T> win = lv.win;
    const int hl = lv.hl, wl = lv.wl;
    const T* vw = vwin[l & 1];
    const float2* loc_l = s_loc + (l & 1) * kMaxTile * kMaxPoints;
    const float* aw_l = s_aw + (l & 1) * kMaxTile * kMaxPoints;
    const int rows = win.w * win.h;
    // lists a window row: more on the coarser levels, where fewer rows
    // take the same number of samples
    int lists = 1;
    while (lists < 8 && rows * lists * 2 <= kHeads) lists *= 2;

    // phase A: sample-major.  d_attn and d_loc of every sample; every
    // corner in the window becomes an entry (its weight, linked into a
    // list of its window row), any other goes to global memory at once
    const int down = win.w * a.hd;
    for (int q0 = 0; q0 < nq && K4_RUNS(3, a.b); q0 += qpp) {
      const int qi = q0 + slot;
      const int qy = tl.ty0 + qi / tl.tw;
      const int qx = tl.tx0 + qi % tl.tw;
      const bool valid = qi < nq && qy < tl.hq && qx < tl.wq;
      // a (query, head)'s threads are all valid or all not; the shuffles
      // name only those that stay
      const unsigned mask = __ballot_sync(0xffffffffu, valid);
      if (!valid) continue;
      const Row<T> g = load_row16(g_tile + qi * a.hd + c4);
      const long long s0 =
          (((static_cast<long long>(bi) * a.q + tl.startq + qy * tl.wq + qx) *
                a.heads + h) * a.levels + l) * a.points;
      const int which = qi & (lists - 1);
      for (int pt = 0; pt < a.points; ++pt) {
        const float2 loc = loc_l[qi * a.points + pt];
        const float aw = aw_l[qi * a.points + pt];
        // rounded as the forward and the plain version: loc * W, then - 0.5
        const float x = __fsub_rn(__fmul_rn(loc.x, wl), 0.5f);
        const float y = __fsub_rn(__fmul_rn(loc.y, hl), 0.5f);
        const float xf = floorf(x);
        const float yf = floorf(y);
        const int x0 = static_cast<int>(xf);
        const int y0 = static_cast<int>(yf);
        const float lx = x - xf;
        const float ly = y - yf;
        const float hx = 1.0f - lx;
        const float hy = 1.0f - ly;
        const int e0 = (qi << kEntryShift) + pt * 4;
        float part_a = 0.0f, part_x = 0.0f, part_y = 0.0f;
        const unsigned wx = static_cast<unsigned>(x0 - win.x0);
        const unsigned wy = static_cast<unsigned>(y0 - win.y0);
        if (wx < static_cast<unsigned>(win.w - 1) &&
            wy < static_cast<unsigned>(win.h - 1)) {
          // the usual case: all four corners in the window (and so in the
          // map), one address and no further test
          const int r = (wy * win.w + wx) * a.hd + c4;
          const float d00 = dot(g.v, load_row16(vw + r).v);
          const float d01 = dot(g.v, load_row16(vw + r + a.hd).v);
          const float d10 = dot(g.v, load_row16(vw + r + down).v);
          const float d11 = dot(g.v, load_row16(vw + r + down + a.hd).v);
          part_a = hy * (hx * d00 + lx * d01) + ly * (hx * d10 + lx * d11);
          part_x = hy * (d01 - d00) + ly * (d11 - d10);
          part_y = hx * (d10 - d00) + lx * (d11 - d01);
          // thread k of the query links corner k
          for (int k = lane_q; k < 4 && K4_RUNS(2, a.b); k += lpq) {
            const int row = (wy + (k >> 1)) * win.w + wx + (k & 1);
            ent_w[e0 + k] = aw * ((k >> 1) ? ly : hy) * ((k & 1) ? lx : hx);
            ent_next[e0 + k] = static_cast<unsigned short>(
                atomicExch(head + row * lists + which, e0 + k));
          }
        } else if (x >= -1.0f && y >= -1.0f && x < wl && y < hl) {
          // some corner is inside the map (or on its edge, where its weight
          // is 0 but its location gradient is not, as in the plain
          // version's autograd): corner by corner, window or global memory
          for (int k = 0; k < 4; ++k) {
            const int yi = y0 + (k >> 1);
            const int xi = x0 + (k & 1);
            if (yi < 0 || yi >= hl || xi < 0 || xi >= wl) continue;
            const float wgt_y = (k >> 1) ? ly : hy;
            const float wgt_x = (k & 1) ? lx : hx;
            const unsigned cx = static_cast<unsigned>(xi - win.x0);
            const unsigned cy = static_cast<unsigned>(yi - win.y0);
            float gv;
            if (cx < static_cast<unsigned>(win.w) &&
                cy < static_cast<unsigned>(win.h)) {
              const int row = cy * win.w + cx;
              gv = dot(g.v, load_row16(vw + row * a.hd + c4).v);
              if (k % lpq == lane_q) {
                ent_w[e0 + k] = aw * wgt_x * wgt_y;
                ent_next[e0 + k] = static_cast<unsigned short>(
                    atomicExch(head + row * lists + which, e0 + k));
              }
            } else {
              const long long off =
                  static_cast<long long>(yi * wl + xi) * row_stride + c4;
              gv = dot(g.v, ldg_row16(lv.value + off).v);
              add_rows(lv.d_value + off, g.v, aw * wgt_x * wgt_y);
            }
            part_a += wgt_x * wgt_y * gv;
            part_x += (k & 1) ? wgt_y * gv : -wgt_y * gv;
            part_y += (k >> 1) ? wgt_x * gv : -wgt_x * gv;
          }
        }
        if (lpq >= 4) {
          // the three sums in 4 shuffles in place of 9: a lane passes on
          // the sum its partner goes on with, so thread 0 of the query
          // ends with part_a, thread lpq / 2 with part_x, thread lpq / 4
          // with part_y
          const int o1 = lpq >> 1, o2 = lpq >> 2;
          const bool hi1 = lane_q & o1, hi2 = lane_q & o2;
          float k1 = (hi1 ? part_x : part_a) +
                     __shfl_xor_sync(mask, hi1 ? part_a : part_x, o1);
          const float k2 = (hi1 ? 0.0f : part_y) +
                           __shfl_xor_sync(mask, hi1 ? part_y : 0.0f, o1);
          k1 = (hi2 ? k2 : k1) + __shfl_xor_sync(mask, hi2 ? k1 : k2, o2);
          k1 = group_sum(k1, o2, mask);
          if (lane_q == 0)
            a.d_attn[s0 + pt] = k1;
          else if (lane_q == o1)
            a.d_locs[2 * (s0 + pt)] = aw * k1 * wl;
          else if (lane_q == o2)
            a.d_locs[2 * (s0 + pt) + 1] = aw * k1 * hl;
        } else {
          part_a = group_sum(part_a, lpq, mask);
          part_x = group_sum(part_x, lpq, mask);
          part_y = group_sum(part_y, lpq, mask);
          if (lane_q == 0) {
            a.d_attn[s0 + pt] = part_a;
            reinterpret_cast<float2*>(a.d_locs)[s0 + pt] =
                make_float2(aw * part_x * wl, aw * part_y * hl);
          }
        }
      }
    }
    __syncthreads();   // every list of the level is complete

    // phase B: row-major.  The threads of a slot walk a list together, each
    // summing weight * grad_out for its 4 channels in registers, and add
    // the sum to d_value with one 16-byte reduction; they leave the list
    // empty for the next level
    // slot -> (a row of the window, one of its lists); a slot's rows lie
    // qpp / lists apart, and their place in the window is stepped without
    // a division (lists is a power of two that divides qpp)
    const int per_pass = qpp / lists;
    const int step_y = per_pass / win.w, step_x = per_pass % win.w;
    int row = slot / lists;
    int fy = row / win.w, fx = row % win.w;
    for (; row < rows && K4_RUNS(1, a.b); row += per_pass) {
      int* list = head + row * lists + (slot & (lists - 1));
      int e = *list;
      __syncwarp(group_mask);   // all have read the head
      if (e >= 0) {
        if (lane_q == 0) *list = -1;
        Row<T> acc = {};
        do {
          const float w = ent_w[e];
          const Row<T> g = load_row16(g_tile + (e >> kEntryShift) * a.hd + c4);
#pragma unroll
          for (int i = 0; i < kN; ++i) acc.v[i] = fmaf(w, g.v[i], acc.v[i]);
          e = ent_next[e];
        } while (e != 0xffff);   // what the first link took from the head
        add_rows(lv.d_value +
                     static_cast<long long>((win.y0 + fy) * wl + win.x0 +
                                            fx) * row_stride + c4,
                 acc.v, 1.0f);
      }
      fy += step_y;
      fx += step_x;
      if (fx >= win.w) {
        fx -= win.w;
        ++fy;
      }
    }
    lv = next;
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// query-major: one thread per (batch, query >= direct_from, head, channel)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    msda_backward_query_kernel(const T* __restrict__ value,
                               const int* __restrict__ level_info,
                               const float* __restrict__ locs,
                               const float* __restrict__ attn,
                               const T* __restrict__ grad_out,
                               float* __restrict__ d_value,
                               float* __restrict__ d_locs,
                               float* __restrict__ d_attn, int b, int s,
                               int q, int heads, int hd, int levels,
                               int points, int direct_from) {
  const int nq = q - direct_from;
  const long long total = static_cast<long long>(b) * nq * heads * hd;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // total is a multiple of hd, so a group is wholly in or wholly out; the
  // lanes past the end leave, and the shuffles name only those that stay.
  const unsigned mask = __ballot_sync(0xffffffffu, tid < total);
  if (tid >= total) return;

  const int c = static_cast<int>(tid % hd);
  long long r = tid / hd;
  const int h = static_cast<int>(r % heads);
  r /= heads;
  const int qi = direct_from + static_cast<int>(r % nq);
  const int bi = static_cast<int>(r / nq);

  const long long row_stride = static_cast<long long>(heads) * hd;
  const long long plane0 = static_cast<long long>(bi) * s * row_stride;
  const long long sample0 =
      ((static_cast<long long>(bi) * q + qi) * heads + h) * levels *
      points;
  const float* loc = locs + sample0 * 2;
  const float* aw = attn + sample0;
  const int col = h * hd + c;
  const float g = to_float(
      grad_out[(static_cast<long long>(bi) * q + qi) * row_stride + col]);

  for (int l = 0; l < levels; ++l) {
    const int hl = __ldg(level_info + 3 * l);
    const int wl = __ldg(level_info + 3 * l + 1);
    const int start = __ldg(level_info + 3 * l + 2);
    const long long base =
        plane0 + static_cast<long long>(start) * row_stride + col;
    const T* vl = value + base;
    float* dvl = d_value + base;
    for (int p = 0; p < points; ++p) {
      const int sp = l * points + p;
      const float x = __fsub_rn(__fmul_rn(__ldg(loc + 2 * sp), wl), 0.5f);
      const float y = __fsub_rn(__fmul_rn(__ldg(loc + 2 * sp + 1), hl), 0.5f);
      const float at = __ldg(aw + sp);
      float part_a = 0.0f, part_x = 0.0f, part_y = 0.0f;
      // some corner is inside (or on the edge, where its weight is 0 but
      // its location gradient is not, as in the plain version's autograd)
      if (x >= -1.0f && y >= -1.0f && x < wl && y < hl) {
        const float xf = floorf(x);
        const float yf = floorf(y);
        const int x0 = static_cast<int>(xf);
        const int y0 = static_cast<int>(yf);
        const float lx = x - xf;
        const float ly = y - yf;
        const float hx = 1.0f - lx;
        const float hy = 1.0f - ly;
        const float ga = g * at;
        // corners (dy, dx) with weights wy * wx; dwx/dx = +-1, dwy/dy = +-1
        for (int dy = 0; dy < 2; ++dy) {
          const int yi = y0 + dy;
          if (yi < 0 || yi >= hl) continue;
          const float wy = dy ? ly : hy;
          for (int dx = 0; dx < 2; ++dx) {
            const int xi = x0 + dx;
            if (xi < 0 || xi >= wl) continue;
            const float wx = dx ? lx : hx;
            const long long off = (static_cast<long long>(yi) * wl + xi) *
                                  row_stride;
            const float gv = g * to_float(vl[off]);
            part_a += wx * wy * gv;
            part_x += dx ? wy * gv : -wy * gv;
            part_y += dy ? wx * gv : -wx * gv;
            atomicAdd(dvl + off, ga * (wx * wy));
          }
        }
      }
      part_a = group_sum(part_a, hd, mask);
      part_x = group_sum(part_x, hd, mask);
      part_y = group_sum(part_y, hd, mask);
      if (c == 0) {
        d_attn[sample0 + sp] = part_a;
        d_locs[2 * (sample0 + sp)] = at * part_x * wl;
        d_locs[2 * (sample0 + sp) + 1] = at * part_y * hl;
      }
    }
  }
}

// The row-owner route's first kernel: d_attn and d_loc of every sample, as
// the query-major kernel computes them but with a (query, head, level)'s
// hd / kN lanes each holding 16 bytes of its channels (the tile kernel's
// layout), and corner k's entry in place of its atomics, written by lane k
// % lanes:
// at index ((level * q + query) * points + point) * 4 + k of its (scene,
// head), the key (the corner's row in its level << kIdBits | the index in
// the level's run of q * points * 4; the level's row count where the
// corner is off the map) and the weight a * (w_x * w_y).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    msda_backward_entries_kernel(const T* __restrict__ value,
                                 const int* __restrict__ level_info,
                                 const float* __restrict__ locs,
                                 const float* __restrict__ attn,
                                 const T* __restrict__ grad_out,
                                 float* __restrict__ d_locs,
                                 float* __restrict__ d_attn,
                                 unsigned* __restrict__ keys,
                                 float* __restrict__ weights, int b, int s,
                                 int q, int heads, int hd, int levels,
                                 int points) {
  constexpr int kN = Row<T>::kN;
  const int lpq = hd / kN;   // lanes of a (query, head): 1, 2 or 4
  const long long total =
      static_cast<long long>(b) * q * heads * levels * lpq;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // total is a multiple of lpq, so a group is wholly in or wholly out
  const unsigned mask = __ballot_sync(0xffffffffu, tid < total);
  if (tid >= total) return;
  const int lane_q = static_cast<int>(tid % lpq);
  long long r = tid / lpq;
  const int l = static_cast<int>(r % levels);
  r /= levels;
  const int h = static_cast<int>(r % heads);
  r /= heads;
  const int qi = static_cast<int>(r % q);
  const int bi = static_cast<int>(r / q);
  const int c = lane_q * kN;
  const long long row_stride = static_cast<long long>(heads) * hd;
  const Row<T> g = ldg_row16(
      grad_out + (static_cast<long long>(bi) * q + qi) * row_stride +
      h * hd + c);
  const T* vscene =
      value + static_cast<long long>(bi) * s * row_stride + h * hd + c;
  const long long sample0 =
      ((static_cast<long long>(bi) * q + qi) * heads + h) * levels * points;
  const int run = q * points * 4;   // entries of one level
  const long long list = (static_cast<long long>(bi) * heads + h) *
                         levels * run;

  {
    const int hl = __ldg(level_info + 3 * l);
    const int wl = __ldg(level_info + 3 * l + 1);
    const T* vl = vscene +
                  static_cast<long long>(__ldg(level_info + 3 * l + 2)) *
                      row_stride;
    for (int p = 0; p < points; ++p) {
      const int sp = l * points + p;
      const float x = __fsub_rn(__fmul_rn(__ldg(locs + 2 * (sample0 + sp)),
                                          wl), 0.5f);
      const float y = __fsub_rn(
          __fmul_rn(__ldg(locs + 2 * (sample0 + sp) + 1), hl), 0.5f);
      const float at = __ldg(attn + sample0 + sp);
      const int id = (qi * points + p) * 4;   // in the level's run
      unsigned* key = keys + list + static_cast<long long>(l) * run + id;
      float* weight = weights + list + static_cast<long long>(l) * run + id;
      float part_a = 0.0f, part_x = 0.0f, part_y = 0.0f;
      if (x >= -1.0f && y >= -1.0f && x < wl && y < hl) {
        // some corner is inside (or on the edge, where its weight is 0
        // but its location gradient is not, as in the plain version)
        const float xf = floorf(x);
        const float yf = floorf(y);
        const int x0 = static_cast<int>(xf);
        const int y0 = static_cast<int>(yf);
        const float lx = x - xf;
        const float ly = y - yf;
        const float hx = 1.0f - lx;
        const float hy = 1.0f - ly;
        float gv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int yi = y0 + (k >> 1);
          const int xi = x0 + (k & 1);
          const bool on = yi >= 0 && yi < hl && xi >= 0 && xi < wl;
          gv[k] = on ? dot(g.v, ldg_row16(vl + static_cast<long long>(
                                                   yi * wl + xi) *
                                                   row_stride).v)
                     : 0.0f;
          if (k % lpq == lane_q) {
            const float wy = (k >> 1) ? ly : hy;
            const float wx = (k & 1) ? lx : hx;
            key[k] = (static_cast<unsigned>(on ? yi * wl + xi : hl * wl)
                      << kIdBits) | (id + k);
            weight[k] = on ? __fmul_rn(at, __fmul_rn(wx, wy)) : 0.0f;
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float wy = (k >> 1) ? ly : hy;
          const float wx = (k & 1) ? lx : hx;
          part_a += wx * wy * gv[k];
          part_x += (k & 1) ? wy * gv[k] : -wy * gv[k];
          part_y += (k >> 1) ? wx * gv[k] : -wx * gv[k];
        }
      } else {
        for (int k = lane_q; k < 4; k += lpq) {
          key[k] = (static_cast<unsigned>(hl * wl) << kIdBits) | (id + k);
          weight[k] = 0.0f;
        }
      }
      part_a = group_sum(part_a, lpq, mask);
      part_x = group_sum(part_x, lpq, mask);
      part_y = group_sum(part_y, lpq, mask);
      if (lane_q == 0) {
        d_attn[sample0 + sp] = part_a;
        reinterpret_cast<float2*>(d_locs)[sample0 + sp] =
            make_float2(at * part_x * wl, at * part_y * hl);
      }
    }
  }
}

// the shared memory of a sort block of e entries over n rows: two buffers
// of keys, then each warp's digit counts during the sort and the rows'
// first entries after it
int sort_smem_bytes(int e, int n) {
  const int counts = 4 * kDigits * kSortWarps;
  return 8 * e + (counts > 2 * (n + 1) ? counts : 2 * (n + 1));
}

// the sum of v over the block's kBlock threads before this one (and, where
// asked, over all of them)
template <int kBlock>
__device__ __forceinline__ int block_sum_before(int v, int* warp_totals,
                                                int* total = nullptr) {
  constexpr int kWarps = kBlock / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_totals[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kWarps ? warp_totals[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFullMask, t, o);
      if (lane >= o) t += y;
    }
    if (lane < kWarps) warp_totals[lane] = t;
  }
  __syncthreads();
  const int before = (warp ? warp_totals[warp - 1] : 0) + x - v;
  if (total) *total = warp_totals[kWarps - 1];
  __syncthreads();   // warp_totals is free again
  return before;
}

// the least v of the sort block's threads after this one, 0xffff for the
// last
__device__ __forceinline__ int block_min_after(int v, int* warp_mins) {
  constexpr int kWarps = kSortThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;   // the least of lanes lane..31
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_down_sync(kFullMask, x, o);
    if (lane + o < 32) x = min(x, y);
  }
  if (lane == 0) warp_mins[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kWarps ? warp_mins[lane] : 0xffff;   // warps lane..
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_down_sync(kFullMask, t, o);
      if (lane + o < 32) t = min(t, y);
    }
    if (lane < kWarps) warp_mins[lane] = t;
  }
  __syncthreads();
  int after = __shfl_down_sync(kFullMask, x, 1);
  if (lane == 31) after = 0xffff;
  if (warp + 1 < kWarps) after = min(after, warp_mins[warp + 1]);
  __syncthreads();   // warp_mins is free again
  return after;
}

// One level of one (scene, head) of the row-owner route: its e entries
// sorted by their row in the level, stably, 8 bits of the row a pass
// (row_bits bits hold n, the level's row count, which the corners off the
// map carry); then written as (weight, query) pairs in that order, and
// the first entry of each row 0..n, at first[0..n] (a row without entries
// takes the next row's first; first[n] is where the corners off the map
// begin).  Warp w owns the run of entries [w * run, (w + 1) * run) and
// walks it 32 at a time in order: lanes of equal digit find each other
// with __match_any_sync, and each takes its place among them by lane; the
// warps' counts are summed digit-major, warp-minor, so that equal digits
// keep their order.  The walk runs twice a pass, counting, then placing.
__global__ void __launch_bounds__(kSortThreads)
    msda_backward_sort_kernel(const unsigned* __restrict__ keys,
                              const float* __restrict__ weights,
                              int2* __restrict__ entries,
                              unsigned short* __restrict__ first_out,
                              const int* __restrict__ level_info, int e,
                              int s, int levels, int per_query, int most) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_scan[32];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int l = blockIdx.x % levels;
  const long long list = blockIdx.x / levels;   // (scene, head)
  const int n = __ldg(level_info + 3 * l) * __ldg(level_info + 3 * l + 1);
  if (n > most) __trap();   // shared memory was sized for `most` rows
  int row_bits = 0;
  while ((n >> row_bits) != 0) ++row_bits;
  const long long run0 = (list * levels + l) * e;   // this level's entries
  unsigned* buf[2] = {reinterpret_cast<unsigned*>(smem),
                      reinterpret_cast<unsigned*>(smem) + e};
  int* counts = reinterpret_cast<int*>(buf[1] + e);   // [warp][digit]
  for (int i = tid; i < e; i += kSortThreads) buf[0][i] = keys[run0 + i];
  const int run = (e + kSortWarps - 1) / kSortWarps;
  const int w0 = min(e, warp * run), w1 = min(e, w0 + run);
  const unsigned below = (1u << lane) - 1u;
  int src = 0;
  for (int shift = kIdBits; shift < kIdBits + row_bits; shift += kDigitBits) {
    for (int i = tid; i < kDigits * kSortWarps; i += kSortThreads)
      counts[i] = 0;
    __syncthreads();   // the keys are in; the counts are zero
    const unsigned* from = buf[src];
    unsigned* to = buf[src ^ 1];
    for (int placing = 0; placing < 2; ++placing) {
      for (int i = w0 + lane; i - lane < w1; i += 32) {
        const bool valid = i < w1;
        const unsigned k = valid ? from[i] : 0u;
        const int d = valid ? static_cast<int>((k >> shift) &
                                               (kDigits - 1))
                            : kDigits;
        const unsigned peers = __match_any_sync(kFullMask, d);
        int* count = counts + warp * kDigits + d;
        const int before = valid ? *count : 0;
        __syncwarp();
        if (valid) {
          if (placing) to[before + __popc(peers & below)] = k;
          if (lane == __ffs(peers) - 1) *count = before + __popc(peers);
        }
        __syncwarp();
      }
      __syncthreads();
      if (!placing) {
        // counts -> places: in order (digit, warp), summed; thread t
        // takes places t * kPer .. of that order (a warp's counts lie a
        // row of kDigits apart, so that a warp's lanes of other digits
        // fall in other banks)
        constexpr int kPer = kDigits * kSortWarps / kSortThreads;
        int sum = 0;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int f = tid * kPer + j;
          sum += counts[(f % kSortWarps) * kDigits + f / kSortWarps];
        }
        int place = block_sum_before<kSortThreads>(sum, warp_scan);
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int f = tid * kPer + j;
          int* mine = counts + (f % kSortWarps) * kDigits + f / kSortWarps;
          const int c = *mine;
          *mine = place;
          place += c;
        }
        __syncthreads();
      }
    }
    src ^= 1;
  }
  const unsigned* sorted = buf[src];
  for (int i = tid; i < e; i += kSortThreads) {
    const unsigned k = sorted[i];
    const int id = static_cast<int>(k & ((1u << kIdBits) - 1));
    entries[run0 + i] =
        make_int2(__float_as_int(__ldg(weights + run0 + id)), id / per_query);
  }
  // each row's first entry: where it starts in the sorted keys, then the
  // least start at or after it (rows without entries)
  unsigned short* first = reinterpret_cast<unsigned short*>(counts);
  for (int r = tid; r <= n; r += kSortThreads) first[r] = 0xffff;
  __syncthreads();
  for (int i = tid; i < e; i += kSortThreads) {
    const unsigned r = sorted[i] >> kIdBits;
    if (i == 0 || (sorted[i - 1] >> kIdBits) != r)
      first[r] = static_cast<unsigned short>(i);
  }
  __syncthreads();
  if (tid == 0 && first[n] > e) first[n] = static_cast<unsigned short>(e);
  __syncthreads();
  const int per = (n + 1 + kSortThreads - 1) / kSortThreads;
  const int r0 = min(n + 1, tid * per), r1 = min(n + 1, r0 + per);
  int least = 0xffff;
  for (int r = r1 - 1; r >= r0; --r) {
    least = min(least, static_cast<int>(first[r]));
    first[r] = static_cast<unsigned short>(least);
  }
  const int after = block_min_after(least, warp_scan);
  for (int r = r0; r < r1; ++r)
    first[r] = static_cast<unsigned short>(
        min(static_cast<int>(first[r]), after));
  __syncthreads();
  // this level's rows of the (scene, head)'s table of s + levels: its
  // first row at its first token, one more a level before it
  unsigned short* out = first_out + list * (s + levels) +
                        __ldg(level_info + 3 * l + 2) + l;
  for (int r = tid; r <= n; r += kSortThreads) out[r] = first[r];
}

// d_value of the row-owner route: a group of heads * hd / kN threads (16
// bytes of channels each) writes kRowsPerGroup token rows of one scene,
// every head; a thread first reads the list bounds of all its rows, then
// sums each (row, head)'s list in the list's order in float32 without an
// FMA (as ops/msda.py::msda_backward_rows_plain), its entries kBatch at a
// time, and stores the 16 bytes once in T.  A row without entries is
// written as zero.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
    msda_backward_rows_kernel(const int2* __restrict__ entries,
                              const unsigned short* __restrict__ first,
                              const int* __restrict__ level_info,
                              const T* __restrict__ grad_out,
                              T* __restrict__ d_value, int s, int q,
                              int heads, int hd, int levels, int e) {
  constexpr int kN = Row<T>::kN;
  const int per_row = heads * hd / kN;   // threads of one token row
  const int group = threadIdx.x / per_row;
  if (group >= kRowThreads / per_row) return;
  const int bi = blockIdx.y;
  const int r0 = (blockIdx.x * (kRowThreads / per_row) + group) *
                 kRowsPerGroup;
  const int c = (threadIdx.x % per_row) * kN;
  const long long row_stride = static_cast<long long>(heads) * hd;
  const long long list = static_cast<long long>(bi) * heads + c / hd;
  const unsigned short* f = first + list * (s + levels);
  const T* grad = grad_out + static_cast<long long>(bi) * q * row_stride + c;
  int l = 0;   // the first row's level; a level's table has one more slot
  while (l + 1 < levels && r0 >= __ldg(level_info + 3 * (l + 1) + 2)) ++l;
  int from[kRowsPerGroup], to[kRowsPerGroup], at[kRowsPerGroup];
#pragma unroll
  for (int j = 0; j < kRowsPerGroup; ++j) {
    const int r = r0 + j;
    while (l + 1 < levels && r >= __ldg(level_info + 3 * (l + 1) + 2)) ++l;
    at[j] = l;
    from[j] = r < s ? __ldg(f + r + l) : 0;
    to[j] = r < s ? __ldg(f + r + l + 1) : 0;
  }
#pragma unroll
  for (int j = 0; j < kRowsPerGroup; ++j) {
    const int r = r0 + j;
    if (r >= s) break;
    const int2* ent = entries + (list * levels + at[j]) * e;
    float acc[kN] = {};
    // kBatch entries, then their grad_out rows, in flight at once; summed
    // in the list's order
    for (int i = from[j]; i < to[j]; i += kBatch) {
      int2 en[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        en[k] = i + k < to[j] ? __ldg(ent + i + k) : make_int2(0, 0);
      uint4 raw[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        raw[k] = __ldg(reinterpret_cast<const uint4*>(
            grad + static_cast<long long>(en[k].y) * row_stride));
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (i + k >= to[j]) break;
        const float w = __int_as_float(en[k].x);
        const Row<T> g = widen<T>(raw[k]);
#pragma unroll
        for (int m = 0; m < kN; ++m)
          acc[m] = __fadd_rn(acc[m], __fmul_rn(w, g.v[m]));
      }
    }
    Row<T> out;
#pragma unroll
    for (int m = 0; m < kN; ++m) out.v[m] = acc[m];
    store_row16(d_value + (static_cast<long long>(bi) * s + r) * row_stride +
                    c, out);
  }
}

// The float32 lists route.  A (scene, head)'s blocks each own a slice of
// at most kListPartRows rows of one level (ceil(rows / kListPartRows)
// slices a level) and write that head's channels of each of them once.
// - The head's grad_out rows of the scene go to shared memory first.
// - d_attn and d_loc: the (scene, head)'s samples, level-major, are shared
//   out evenly over its blocks, hd / 4 lanes a sample (4 channels each),
//   the sums over the channels by warp shuffles.
// - The slice's entries: a thread a sample of the slice's level, in index
//   order; each corner on a row of the slice (its row in the slice, its
//   weight a * (w_x * w_y), its query) is kept in shared memory in the
//   order of its index (a block scan of the threads' counts), and each
//   row's corners are counted.
// - A scan of the counts gives each row's first entry.  Then the entries
//   are ordered by row, stably, in two steps: into buckets by the warp
//   that owns their row (r % kListWarps), each warp placing a run of them
//   in order, then by row, each warp placing its bucket in order, so that
//   a row's entries keep the order of their index and no two warps share
//   a row's place.
// - The rows: hd / 4 lanes a row sum weight * grad_out of its list in that
//   order in float32 without an FMA (as
//   ops/msda.py::msda_backward_rows_plain), all from shared memory, and
//   store 16 bytes each once; a row without entries is stored as zero.
// Only the locations and weights of a level are read by each of its
// slices; the value rows once, for d_attn and d_loc.  Shared memory: the
// grad_out rows (q * hd floats), the slice's row counts, then first
// entries, then next places, the owners' counts, and of the kept entries
// (at most e) the weight, row, query and the two orders.
__global__ void __launch_bounds__(kListThreads)
    msda_backward_lists_kernel(const float* __restrict__ value,
                               const int* __restrict__ level_info,
                               const float* __restrict__ locs,
                               const float* __restrict__ attn,
                               const float* __restrict__ grad_out,
                               float* __restrict__ d_value,
                               float* __restrict__ d_locs,
                               float* __restrict__ d_attn, int s, int q,
                               int heads, int hd, int levels, int points,
                               int parts) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_scan[32];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int part = blockIdx.x % parts;
  const int list = blockIdx.x / parts;   // (scene, head)
  const int h = list % heads, bi = list / heads;
  // this block's level and slice of its rows
  int l = 0, first_part = 0, hl = 0, wl = 0, start = 0, slices = 0;
  for (;; ++l) {
    if (l == levels) __trap();   // parts does not match the levels
    hl = __ldg(level_info + 3 * l);
    wl = __ldg(level_info + 3 * l + 1);
    start = __ldg(level_info + 3 * l + 2);
    slices = (hl * wl + kListPartRows - 1) / kListPartRows;
    if (part < first_part + slices) break;
    first_part += slices;
  }
  if (part == parts - 1 && l + 1 != levels) __trap();
  const int n = hl * wl;
  const int r0 = static_cast<int>(
      static_cast<long long>(part - first_part) * n / slices);
  const int r1 = static_cast<int>(   // the slice's rows: [r0, r1)
      static_cast<long long>(part - first_part + 1) * n / slices);
  const int e = q * points * 4;
  const int samples = q * points;   // of a level
  float* g_rows = reinterpret_cast<float*>(smem);
  unsigned* count = reinterpret_cast<unsigned*>(g_rows + q * hd);
  float* weight = reinterpret_cast<float*>(
      count + count_slot(kListPartRows) + 1);
  int* bucket = reinterpret_cast<int*>(weight + e);
  unsigned short* row_of = reinterpret_cast<unsigned short*>(
      bucket + kListWarps * kBucketStride);
  unsigned short* query = row_of + e;
  unsigned short* sorted = query + e;   // the kept entries by owner
  unsigned short* order = sorted + e;   // and by row
  const int lanes = hd >> 2;   // lanes of a sample or a row: 1, 2, 4 or 8
  const int lane_q = tid & (lanes - 1);
  const int c4 = lane_q * 4;   // this thread's first channel
  const int per_pass = kListThreads / lanes;
  const long long row_stride = static_cast<long long>(heads) * hd;
  const float* grad = grad_out + static_cast<long long>(bi) * q * row_stride +
                      h * hd;
  for (int i = tid; i < q * lanes; i += kListThreads) {
    const int qi = i / lanes, c = (i - qi * lanes) * 4;
    *reinterpret_cast<float4*>(g_rows + qi * hd + c) =
        __ldg(reinterpret_cast<const float4*>(grad + qi * row_stride + c));
  }
  for (int i = tid; i <= count_slot(kListPartRows); i += kListThreads)
    count[i] = 0;
  for (int i = tid; i < kListWarps * kBucketStride; i += kListThreads)
    bucket[i] = 0;
  __syncthreads();

  // d_attn and d_loc of this block's share of the (scene, head)'s samples
  const long long sample0 =
      (static_cast<long long>(bi) * q * heads + h) * levels * points;
  const float* vscene =
      value + static_cast<long long>(bi) * s * row_stride + h * hd + c4;
  const int t0 = static_cast<int>(
      static_cast<long long>(part) * levels * samples / parts);
  const int t1 = static_cast<int>(
      static_cast<long long>(part + 1) * levels * samples / parts);
  for (int s0 = t0; s0 < t1 && K4_LISTS_RUNS(4, q); s0 += per_pass) {
    const int t = s0 + tid / lanes;
    // a sample's lanes are all valid or all not; the shuffles name only
    // those that stay
    const bool valid = t < t1;
    const unsigned mask = __ballot_sync(kFullMask, valid);
    if (!valid) continue;
    const int tl = t / samples, within = t - tl * samples;
    const int qi = within / points;
    const long long sp = sample0 +
                         (static_cast<long long>(qi) * heads * levels + tl) *
                             points + within - qi * points;
    const int hq = __ldg(level_info + 3 * tl);
    const int wq = __ldg(level_info + 3 * tl + 1);
    const float* vl =
        vscene + static_cast<long long>(__ldg(level_info + 3 * tl + 2)) *
                     row_stride;
    const float2 loc = __ldg(reinterpret_cast<const float2*>(locs) + sp);
    const float at = __ldg(attn + sp);
    const Row<float> g = load_row16(g_rows + qi * hd + c4);
    const float x = __fsub_rn(__fmul_rn(loc.x, wq), 0.5f);
    const float y = __fsub_rn(__fmul_rn(loc.y, hq), 0.5f);
    float part_a = 0.0f, part_x = 0.0f, part_y = 0.0f;
    if (x >= -1.0f && y >= -1.0f && x < wq && y < hq) {
      // some corner is inside (or on the edge, where its weight is 0 but
      // its location gradient is not, as in the plain version)
      const float xf = floorf(x);
      const float yf = floorf(y);
      const int x0 = static_cast<int>(xf);
      const int y0 = static_cast<int>(yf);
      const float lx = x - xf;
      const float ly = y - yf;
      const float hx = 1.0f - lx;
      const float hy = 1.0f - ly;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int yi = y0 + (k >> 1);
        const int xi = x0 + (k & 1);
        const float gv =
            yi >= 0 && yi < hq && xi >= 0 && xi < wq
                ? dot(g.v, ldg_row16(vl + (yi * wq + xi) * row_stride).v)
                : 0.0f;
        const float wy = (k >> 1) ? ly : hy;
        const float wx = (k & 1) ? lx : hx;
        part_a += wx * wy * gv;
        part_x += (k & 1) ? wy * gv : -wy * gv;
        part_y += (k >> 1) ? wx * gv : -wx * gv;
      }
    }
    if (lanes >= 4) {
      // the three sums in 4 shuffles, as the tile kernel takes them: lane
      // 0 of the sample ends with part_a, lane lanes / 2 with part_x, lane
      // lanes / 4 with part_y
      const int o1 = lanes >> 1, o2 = lanes >> 2;
      const bool hi1 = lane_q & o1, hi2 = lane_q & o2;
      float k1 = (hi1 ? part_x : part_a) +
                 __shfl_xor_sync(mask, hi1 ? part_a : part_x, o1);
      const float k2 = (hi1 ? 0.0f : part_y) +
                       __shfl_xor_sync(mask, hi1 ? part_y : 0.0f, o1);
      k1 = (hi2 ? k2 : k1) + __shfl_xor_sync(mask, hi2 ? k1 : k2, o2);
      k1 = group_sum(k1, o2, mask);
      if (lane_q == 0)
        d_attn[sp] = k1;
      else if (lane_q == o1)
        d_locs[2 * sp] = at * k1 * wq;
      else if (lane_q == o2)
        d_locs[2 * sp + 1] = at * k1 * hq;
    } else {
      part_a = group_sum(part_a, lanes, mask);
      part_x = group_sum(part_x, lanes, mask);
      part_y = group_sum(part_y, lanes, mask);
      if (lane_q == 0) {
        d_attn[sp] = part_a;
        reinterpret_cast<float2*>(d_locs)[sp] =
            make_float2(at * part_x * wq, at * part_y * hq);
      }
    }
  }

  // the slice's entries, kept in the order of their index
  int kept = 0;
  for (int s0 = 0; s0 < samples && K4_LISTS_RUNS(3, q);
       s0 += kListThreads) {
    const int sample = s0 + tid;
    bool in[4] = {false, false, false, false};
    int row[4] = {0, 0, 0, 0};
    float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const int qi = sample / points;
    if (sample < samples) {
      const long long sp = sample0 +
                           (static_cast<long long>(qi) * heads * levels + l) *
                               points + sample - qi * points;
      const float2 loc = __ldg(reinterpret_cast<const float2*>(locs) + sp);
      const float at = __ldg(attn + sp);
      const float x = __fsub_rn(__fmul_rn(loc.x, wl), 0.5f);
      const float y = __fsub_rn(__fmul_rn(loc.y, hl), 0.5f);
      if (x >= -1.0f && y >= -1.0f && x < wl && y < hl) {
        const float xf = floorf(x);
        const float yf = floorf(y);
        const int x0 = static_cast<int>(xf);
        const int y0 = static_cast<int>(yf);
        const float lx = x - xf;
        const float ly = y - yf;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int yi = y0 + (k >> 1);
          const int xi = x0 + (k & 1);
          row[k] = yi * wl + xi;
          in[k] = yi >= 0 && yi < hl && xi >= 0 && xi < wl &&
                  row[k] >= r0 && row[k] < r1;
          w[k] = __fmul_rn(at, __fmul_rn((k & 1) ? lx : 1.0f - lx,
                                         (k >> 1) ? ly : 1.0f - ly));
        }
      }
    }
    int taken;
    int place = kept + block_sum_before<kListThreads>(
                           in[0] + in[1] + in[2] + in[3], warp_scan, &taken);
    kept += taken;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!in[k]) continue;
      row_of[place] = static_cast<unsigned short>(row[k] - r0);
      query[place] = static_cast<unsigned short>(qi);
      weight[place] = w[k];
      atomicAdd(count + count_slot(row[k] - r0), 1u);
      ++place;
    }
  }
  __syncthreads();   // every kept entry is counted

  // counts -> first entries: row r0 + j's list is [first[j], first[j + 1])
  const int rows = r1 - r0;
  {
    const int per = (rows + kListThreads - 1) / kListThreads;
    const int j0 = min(rows, tid * per), j1 = min(rows, j0 + per);
    int sum = 0;
    for (int j = j0; j < j1; ++j) sum += count[count_slot(j)];
    int place = block_sum_before<kListThreads>(sum, warp_scan);
    for (int j = j0; j < j1; ++j) {
      const int c = count[count_slot(j)];
      count[count_slot(j)] = place;
      place += c;
    }
  }
  __syncthreads();   // from here row r0 + j's count is its next place

  // The kept entries ordered by row, stably, in two steps, each warp
  // walking a share of them in order.  First into buckets by owner, the
  // warp of a row (row % kListWarps): warp w takes the run [w * run, (w +
  // 1) * run) of the kept entries, counts each owner's in it, and after a
  // scan of the counts (owner-major, run-minor) places them; then the owner
  // warp walks its bucket, which holds its rows' entries in index order,
  // and places each at its row's next place.  Lanes of one owner or row
  // find each other (match_bits) and take their places by lane.
  const unsigned below = (1u << lane) - 1u;
  const int run = (kept + kListWarps - 1) / kListWarps;
  const int w0 = min(kept, warp * run), w1 = min(kept, w0 + run);
  for (int placing = 0; placing < 2 && K4_LISTS_RUNS(2, q); ++placing) {
    for (int i = w0 + lane; i - lane < w1; i += 32) {
      const bool valid = i < w1;
      const unsigned owner = valid ? row_of[i] & (kListWarps - 1) : 0;
      const unsigned peers = match_bits(owner, kListOwnerBits, valid);
      int* mine = bucket + owner * kBucketStride + warp;
      const int base = valid ? *mine : 0;
      if (valid && placing)
        sorted[base + __popc(peers & below)] = static_cast<unsigned short>(i);
      __syncwarp();
      if (valid && lane == __ffs(peers) - 1) *mine = base + __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    if (!placing) {
      // counts -> places, owner-major, run-minor (the stride's last slot
      // of each owner counts nothing): thread t the slots t * kPer ..
      constexpr int kSlots = kListWarps * kBucketStride;
      constexpr int kPer = (kSlots + kListThreads - 1) / kListThreads;
      int sum = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int f = tid * kPer + j;
        sum += f < kSlots ? bucket[f] : 0;
      }
      int place = block_sum_before<kListThreads>(sum, warp_scan);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int f = tid * kPer + j;
        if (f >= kSlots) break;
        const int c = bucket[f];
        bucket[f] = place;
        place += c;
      }
      __syncthreads();
    }
  }
  {
    // the last slot of owner o's counts now holds the end of its bucket,
    // which holds its rows' entries in index order
    const int b0 = warp ? bucket[warp * kBucketStride - 1] : 0;
    const int b1 = K4_LISTS_RUNS(2, q)
                       ? bucket[warp * kBucketStride + kListWarps]
                       : b0;
    for (int i = b0 + lane; i - lane < b1; i += 32) {
      const bool valid = i < b1;
      const int id = valid ? sorted[i] : 0;
      const int r = valid ? row_of[id] : 0;
      const unsigned peers =
          match_bits(static_cast<unsigned>(r) >> kListOwnerBits, kListRowBits,
                     valid);
      unsigned* next = count + count_slot(r);
      const int base = valid ? *next : 0;
      if (valid) order[base + __popc(peers & below)] =
          static_cast<unsigned short>(id);
      __syncwarp();
      if (valid && lane == __ffs(peers) - 1) *next = base + __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();   // row r0 + j's count is where its list ends

  // the rows, each written once
  float* dvl = d_value +
               (static_cast<long long>(bi) * s + start + r0) * row_stride +
               h * hd + c4;
  for (int j = tid / lanes; j < rows && K4_LISTS_RUNS(1, q); j += per_pass) {
    const int from = j ? count[count_slot(j - 1)] : 0;
    const int to = count[count_slot(j)];
    float acc[4] = {};
#pragma unroll 4
    for (int i = from; i < to; ++i) {
      const int id = order[i];
      const float w = weight[id];
      const float4 g = *reinterpret_cast<const float4*>(
          g_rows + query[id] * hd + c4);
      acc[0] = __fadd_rn(acc[0], __fmul_rn(w, g.x));
      acc[1] = __fadd_rn(acc[1], __fmul_rn(w, g.y));
      acc[2] = __fadd_rn(acc[2], __fmul_rn(w, g.z));
      acc[3] = __fadd_rn(acc[3], __fmul_rn(w, g.w));
    }
    *reinterpret_cast<float4*>(dvl + j * row_stride) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

// the shared memory of a lists block of q queries' grad_out rows (hd
// floats each) and e entries: the rows, a slice's row counts, the kept
// entries' weights, the owners' counts of each warp's run, the kept
// entries' rows, queries and their two orders
int lists_smem_bytes(int q, int hd, int e) {
  return 4 * q * hd + 4 * (count_slot(kListPartRows) + 1) + 4 * e +
         4 * kListWarps * kBucketStride + 8 * e;
}

// d_value's float32 sums rounded to bfloat16, once
__global__ void __launch_bounds__(kThreads)
    round_to_bf16_kernel(const float* __restrict__ from,
                         __nv_bfloat16* __restrict__ to, long long n) {
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads)
    to[i] = __float2bfloat16_rn(from[i]);
}

template <typename T>
int launch(const void* value, const void* level_info, const void* tile_info,
           const void* locs, const void* attn, const void* grad_out,
           void* d_value, void* d_locs, void* d_attn, int b, int s, int q,
           int heads, int hd, int levels, int points, int tiles,
           int direct_from, int max_tile, cudaStream_t st) {
  constexpr int kN = Row<T>::kN;
  constexpr int kSize = static_cast<int>(sizeof(T));
  if (hd <= 0 || hd > 32 || 32 % hd != 0 || tiles < 0 || direct_from < 0 ||
      direct_from > q || (tiles == 0 && direct_from != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Args<T> a;
  a.value = static_cast<const T*>(value);
  a.level_info = static_cast<const int*>(level_info);
  a.tile_info = static_cast<const int*>(tile_info);
  a.locs = static_cast<const float*>(locs);
  a.attn = static_cast<const float*>(attn);
  a.grad_out = static_cast<const T*>(grad_out);
  a.d_value = static_cast<float*>(d_value);
  a.d_locs = static_cast<float*>(d_locs);
  a.d_attn = static_cast<float*>(d_attn);
  a.b = b;
  a.s = s;
  a.q = q;
  a.heads = heads;
  a.hd = hd;
  a.levels = levels;
  a.points = points;
  a.tiles = tiles;
  a.direct_from = direct_from;
  a.rows_a = a.rows_b = 0;
  if (tiles) {
    if (hd % kN || max_tile < 1 || max_tile > kMaxTile || points < 1 ||
        points > kMaxPoints)
      return static_cast<int>(cudaErrorInvalidValue);
    // 16-byte loads, cp.async and reductions, and 8-byte ones
    if ((reinterpret_cast<uintptr_t>(value) |
         reinterpret_cast<uintptr_t>(grad_out) |
         reinterpret_cast<uintptr_t>(d_value)) % 16 ||
        (reinterpret_cast<uintptr_t>(locs) |
         reinterpret_cast<uintptr_t>(d_locs)) % 8)
      return static_cast<int>(cudaErrorInvalidValue);
    // what the rest leaves for the two windows; a window row has a list
    const int fixed = kMaxTile * hd * kSize + 2 * kMaxTile * kMaxPoints * 12 +
                      kEntries * 6 + kHeads * 4;
    const int rows = (kTileBytes - fixed) / (hd * kSize);
    a.rows_b = min(kHeads, rows * kShareB / (kShareA + kShareB));
    a.rows_a = min(kHeads, rows - a.rows_b);
  }
  const long long tile_blocks = static_cast<long long>(b) * heads * tiles;
  const long long direct =
      static_cast<long long>(b) * (q - direct_from) * heads * hd;
  if (tile_blocks && K4_RUNS(4, b)) {
    static bool configured = false;
    if (!configured) {
      cudaError_t err = cudaFuncSetAttribute(
          msda_backward_tile_kernel<T>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kTileBytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      configured = true;
    }
    msda_backward_tile_kernel<T><<<static_cast<unsigned>(tile_blocks),
                                   kTileThreads, kTileBytes, st>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (direct) {
    const unsigned blocks =
        static_cast<unsigned>((direct + kThreads - 1) / kThreads);
    msda_backward_query_kernel<T><<<blocks, kThreads, 0, st>>>(
        a.value, a.level_info, a.locs, a.attn, a.grad_out, a.d_value,
        a.d_locs, a.d_attn, b, s, q, heads, hd, levels, points, direct_from);
  }
  return static_cast<int>(cudaGetLastError());
}

// The row-owner route (no tiles): entries, their sort, the rows.  For n =
// b * heads * levels * e entries of e = q * points * 4 a (scene, head,
// level), scratch (16-byte aligned) holds the keys (n x 4 bytes), their
// weights (n x 4), the sorted (weight, query) pairs (n x 8) and each
// (scene, head)'s first entries of the rows, a level's rows and one more
// (b * heads * (s + levels) x 2 bytes).
template <typename T>
int launch_rows(const void* value, const void* level_info_v,
                const void* locs, const void* attn, const void* grad_out,
                void* scratch, void* d_value, void* d_locs, void* d_attn,
                int b, int s, int q, int heads, int hd, int levels,
                int points, int most, cudaStream_t st) {
  constexpr int kN = Row<T>::kN;
  const long long per_level = static_cast<long long>(q) * points * 4;
  if (b <= 0 || q <= 0 || s <= 0 || hd <= 0 || hd > 32 || 32 % hd ||
      hd % kN || heads <= 0 || heads * hd > kRowThreads * kN ||
      levels <= 0 || points <= 0 || b > 65535 ||
      per_level > kMaxEntries || most <= 0 || most > s ||
      most >= (1 << (32 - kIdBits)) - 1 ||
      sort_smem_bytes(static_cast<int>(per_level), most) > kSortSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const int e = static_cast<int>(per_level);
  if ((reinterpret_cast<uintptr_t>(grad_out) |
       reinterpret_cast<uintptr_t>(d_value) |
       reinterpret_cast<uintptr_t>(scratch)) % 16 ||
      reinterpret_cast<uintptr_t>(d_locs) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* level_info = static_cast<const int*>(level_info_v);
  const long long n = static_cast<long long>(b) * heads * levels * e;
  unsigned* keys = static_cast<unsigned*>(scratch);
  float* weights = reinterpret_cast<float*>(keys + n);
  int2* entries = reinterpret_cast<int2*>(weights + n);
  unsigned short* first = reinterpret_cast<unsigned short*>(entries + n);
  const long long threads =
      static_cast<long long>(b) * q * heads * levels * (hd / kN);
  msda_backward_entries_kernel<T>
      <<<static_cast<unsigned>((threads + kThreads - 1) / kThreads), kThreads,
         0, st>>>(static_cast<const T*>(value), level_info,
                  static_cast<const float*>(locs),
                  static_cast<const float*>(attn),
                  static_cast<const T*>(grad_out),
                  static_cast<float*>(d_locs), static_cast<float*>(d_attn),
                  keys, weights, b, s, q, heads, hd, levels, points);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool configured = false;
  if (!configured) {
    err = cudaFuncSetAttribute(msda_backward_sort_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSortSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  msda_backward_sort_kernel<<<static_cast<unsigned>(b * heads * levels),
                              kSortThreads, sort_smem_bytes(e, most), st>>>(
      keys, weights, entries, first, level_info, e, s, levels, points * 4,
      most);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_block = kRowThreads / (heads * hd / kN) * kRowsPerGroup;
  const dim3 grid((s + rows_per_block - 1) / rows_per_block, b);
  msda_backward_rows_kernel<T><<<grid, kRowThreads, 0, st>>>(
      entries, first, level_info, static_cast<const T*>(grad_out),
      static_cast<T*>(d_value), s, q, heads, hd, levels, e);
  return static_cast<int>(cudaGetLastError());
}

// The float32 lists route (no tiles): one kernel, no scratch; parts is
// the blocks of a (scene, head), the levels' slices.
int launch_lists(const void* value, const void* level_info,
                 const void* locs, const void* attn, const void* grad_out,
                 void* d_value, void* d_locs, void* d_attn, int b, int s,
                 int q, int heads, int hd, int levels, int points, int parts,
                 cudaStream_t st) {
  const long long per_level = static_cast<long long>(q) * points * 4;
  if (b <= 0 || q <= 0 || s <= 0 || hd <= 0 || hd > 32 || 32 % hd ||
      hd % 4 || heads <= 0 || levels <= 0 || points <= 0 ||
      per_level > kMaxEntries || parts < levels || parts > s ||
      lists_smem_bytes(q, hd, static_cast<int>(per_level)) > kSortSmemLimit ||
      static_cast<long long>(b) * heads * parts > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(value) |
       reinterpret_cast<uintptr_t>(grad_out) |
       reinterpret_cast<uintptr_t>(d_value)) % 16 ||
      (reinterpret_cast<uintptr_t>(locs) |
       reinterpret_cast<uintptr_t>(d_locs)) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        msda_backward_lists_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSortSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  msda_backward_lists_kernel<<<static_cast<unsigned>(b * heads * parts),
                               kListThreads,
                               lists_smem_bytes(q, hd,
                                                static_cast<int>(per_level)),
                               st>>>(
      static_cast<const float*>(value), static_cast<const int*>(level_info),
      static_cast<const float*>(locs), static_cast<const float*>(attn),
      static_cast<const float*>(grad_out), static_cast<float*>(d_value),
      static_cast<float*>(d_locs), static_cast<float*>(d_attn), s, q, heads,
      hd, levels, points, parts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// value: (B, S, heads, hd) f32; level_info: (levels, 3) int32 device array
// of (H, W, first token); tile_info: (levels, 5) int32 device array, as
// demf_msda_forward takes it, read only when tiles > 0: then hd is a
// multiple of 4, queries [0, direct_from) are the tokens of the tiled
// levels, points <= 4, max_tile is the most queries of any tile (at most
// 256), value, grad_out and d_value are 16-byte aligned and locs and d_locs
// 8-byte aligned; locs: (B, Q, heads, levels, points, 2) f32; attn: (B, Q,
// heads, levels, points) f32; grad_out: (B, Q, heads * hd) f32.  parts ==
// 0: d_value like value, zeroed by the caller.  parts > 0 (tiles 0,
// direct_from 0): the lists route, parts being the blocks of a (scene,
// head): the levels' slices of at most 2,048 rows
// (ops/msda.py::msda_lists_parts); hd a multiple of 4, q * points * 4 at
// most 22,528, the block's shared memory (ops/msda.py::msda_rows_route)
// within a block's, value, grad_out and d_value 16-byte aligned, locs and
// d_locs 8-byte aligned; d_value is written in full.  d_locs like locs and
// d_attn like attn, every element written here.  hd must divide 32.
// Anything else is refused with cudaErrorInvalidValue.
int demf_msda_backward(const void* value, const void* level_info,
                       const void* tile_info, const void* locs,
                       const void* attn, const void* grad_out, void* d_value,
                       void* d_locs, void* d_attn, int b, int s, int q,
                       int heads, int hd, int levels, int points, int tiles,
                       int direct_from, int max_tile, int parts,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (parts) {
    if (tiles || direct_from) return static_cast<int>(cudaErrorInvalidValue);
    return launch_lists(value, level_info, locs, attn, grad_out, d_value,
                        d_locs, d_attn, b, s, q, heads, hd, levels, points,
                        parts, st);
  }
  return launch<float>(value, level_info, tile_info, locs, attn, grad_out,
                       d_value, d_locs, d_attn, b, s, q, heads, hd, levels,
                       points, tiles, direct_from, max_tile, st);
}

// The same with value and grad_out in bfloat16 (with tiles, hd a multiple
// of 8).  rows == 0: the float32 sums go to scratch (f32, like value,
// zeroed by the caller, 16-byte aligned), and a last pass rounds them once
// into d_value (bf16, like value).  rows > 0 (tiles 0, direct_from 0): the
// row-owner route, rows being the most tokens of any level; hd a multiple
// of 8, heads * hd at most 2,048, q * points * 4 at most 22,528, rows
// below 131,071, the sort's
// shared memory (ops/msda.py::msda_rows_route) within a block's, grad_out,
// d_value and scratch 16-byte aligned and d_locs 8-byte aligned; scratch
// holds msda_rows_scratch_bytes, not zeroed; d_value is written in full.
int demf_msda_backward_bf16(const void* value, const void* level_info,
                            const void* tile_info, const void* locs,
                            const void* attn, const void* grad_out,
                            void* scratch, void* d_value, void* d_locs,
                            void* d_attn, int b, int s, int q, int heads,
                            int hd, int levels, int points, int tiles,
                            int direct_from, int max_tile, int rows,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows) {
    if (tiles || direct_from) return static_cast<int>(cudaErrorInvalidValue);
    return launch_rows<__nv_bfloat16>(value, level_info, locs, attn,
                                      grad_out, scratch, d_value, d_locs,
                                      d_attn, b, s, q, heads, hd, levels,
                                      points, rows, st);
  }
  const int err = launch<__nv_bfloat16>(
      value, level_info, tile_info, locs, attn, grad_out, scratch, d_locs,
      d_attn, b, s, q, heads, hd, levels, points, tiles, direct_from,
      max_tile, st);
  if (err) return err;
  const long long n = static_cast<long long>(b) * s * heads * hd;
  if (n) {
    const long long need = (n + kThreads - 1) / kThreads;
    const long long blocks = need < (1LL << 16) ? need : (1LL << 16);
    round_to_bf16_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const float*>(scratch),
        static_cast<__nv_bfloat16*>(d_value), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
