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
//   float32: a bfloat16 d_value is summed into a float32 buffer, its
//   16-byte global reductions as above, and rounded to bfloat16 once, by a
//   last pass over it.
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

}  // namespace

extern "C" {

// value: (B, S, heads, hd) f32; level_info: (levels, 3) int32 device array
// of (H, W, first token); tile_info: (levels, 5) int32 device array, as
// demf_msda_forward takes it, read only when tiles > 0: then hd is a
// multiple of 4, queries [0, direct_from) are the tokens of the tiled
// levels, points <= 4, max_tile is the most queries of any tile (at most 256), value,
// grad_out and d_value are 16-byte aligned and locs and d_locs 8-byte
// aligned; locs: (B, Q, heads, levels, points, 2) f32; attn: (B, Q, heads,
// levels, points) f32; grad_out: (B, Q, heads * hd) f32.  Outputs: d_value
// like value, zeroed by the caller; d_locs like locs and d_attn like attn,
// every element written here.  hd must divide 32.  Anything else is
// refused with cudaErrorInvalidValue.
int demf_msda_backward(const void* value, const void* level_info,
                       const void* tile_info, const void* locs,
                       const void* attn, const void* grad_out, void* d_value,
                       void* d_locs, void* d_attn, int b, int s, int q,
                       int heads, int hd, int levels, int points, int tiles,
                       int direct_from, int max_tile, void* stream) {
  return launch<float>(value, level_info, tile_info, locs, attn, grad_out,
                       d_value, d_locs, d_attn, b, s, q, heads, hd, levels,
                       points, tiles, direct_from, max_tile,
                       static_cast<cudaStream_t>(stream));
}

// The same with value and grad_out in bfloat16 (with tiles, hd a multiple
// of 8): the float32 sums go to d_value_sums (f32, like value, zeroed by
// the caller, 16-byte aligned), and a last pass rounds them once into
// d_value (bf16, like value).
int demf_msda_backward_bf16(const void* value, const void* level_info,
                            const void* tile_info, const void* locs,
                            const void* attn, const void* grad_out,
                            void* d_value_sums, void* d_value, void* d_locs,
                            void* d_attn, int b, int s, int q, int heads,
                            int hd, int levels, int points, int tiles,
                            int direct_from, int max_tile, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch<__nv_bfloat16>(
      value, level_info, tile_info, locs, attn, grad_out, d_value_sums,
      d_locs, d_attn, b, s, q, heads, hd, levels, points, tiles, direct_from,
      max_tile, st);
  if (err) return err;
  const long long n = static_cast<long long>(b) * s * heads * hd;
  if (n) {
    const long long need = (n + kThreads - 1) / kThreads;
    const long long blocks = need < (1LL << 16) ? need : (1LL << 16);
    round_to_bf16_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const float*>(d_value_sums),
        static_cast<__nv_bfloat16*>(d_value), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
