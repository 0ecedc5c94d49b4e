// Multi-scale deformable attention, forward: bilinear reads of the value
// planes at the sampling locations, weighted by attention, summed over
// levels and points.  The backward is kernel K4 (msda_backward.cu); the
// autograd.Function of ops/msda.py pairs the two.
//
// Replaces: demf_tpu/ops/msda.py::multi_scale_deformable_attention (the XLA
// forms _make_small_q_msda and _make_msda), and with it the two Pallas
// kernels written for that op's halves: ops/pallas/gather_rows.py
// (gather_rows, the row fetch) and ops/pallas/msda_fold.py
// (weighted_slot_fold, the weighted reduction).  This kernel does both in
// one pass and keeps the fetched rows in registers.
//
// Semantics: grid_sample with align_corners=False and zero padding, per
// level: x = loc_x * W - 0.5, y = loc_y * H - 0.5; corners outside the map
// read zero.  Accumulation is float32, in the order levels, points, corners.
//
// What bounds it on the card: bytes, and which memory they come from.  The
// function must move the value rows it samples, locations, weights and
// output once (160 MB at the encoder's shape: 0.05 ms from device memory),
// but every (query, head, level, point) sample reads four rows of head_dim
// floats at data-dependent addresses: 2.9 GB of 128-byte reads at the
// encoder's shape.  Served from L2 they cost ~0.7 ms, whatever the thread
// mapping.
//
// What this design does about it:
// - In the encoder the queries are the levels' own pixels and a query's
//   samples lie a few pixels around its own position on every level.  So a
//   block takes a spatial tile of one level's queries for one head (the
//   tiling comes from ops/msda.py::msda_tiling) and goes through the levels
//   one after the other: it copies the window of the level's value rows
//   that lies under the tile (kMargin pixels around it), and the tile's
//   locations and weights on that level, into shared memory with cp.async,
//   then every query of the tile takes its samples of that level from
//   there.  A thread keeps the sums of its (at most kMaxPasses) queries in
//   registers across the levels, so a query's sum keeps the order levels,
//   points, corners.  A sample whose four corners lie in the window (the
//   usual case) needs one address and no test of the map's edges; any other
//   corner is tested and read from global memory, so the window decides
//   the speed and never the result.  Two blocks share an SM: one copies
//   while the other samples.
// - A thread owns 16 bytes of a row's channels (4 float32 or 8 bfloat16:
//   one 16-byte load a corner, widened to float32 in registers) and
//   head_dim / 4 or head_dim / 8 threads a (query, head); they load a
//   sample's location and weight from one address.
// - One source for both value types (a template): the value, the window
//   and the output in float32 or bfloat16, the locations and weights
//   float32, the sums float32, a bfloat16 output rounded once at the
//   store.  A bfloat16 window holds twice the rows in the same bytes.
// - Queries that are not the levels' pixels (the decoder's 256 proposals),
//   and the pixels of levels too coarse for a tile, keep the query-major
//   mapping: a thread takes all samples of its (query, head, 4 channels)
//   from global memory.  Both kinds of block run in one launch.
// - x and y are rounded as loc * W, then - 0.5, without an FMA, as the
//   plain version and K4 round them.
// With the window in place a tile block is bound by what its warps run
// (some 50 operations a sample and thread, the geometry repeated in the
// head_dim / 4 threads of a query), not by shared memory or L2.
#include <cuda_runtime.h>

#include <cstdint>

#include "msda_window.cuh"

namespace {

using namespace msda;   // the tile, its window, cp.async, rows: shared with K4

constexpr int kThreads = 512;
constexpr int kMaxPasses = 4;   // queries of a tile that one thread sums
// shared memory of a tile block, two blocks an SM: the window (729 rows of
// 128 bytes with 4 points a level) and the tile's locations and weights
constexpr int kTileBytes = 105600;

template <int kN>
__device__ __forceinline__ void fma_row(float (&v)[kN], float w,
                                        const float (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) v[i] = fmaf(w, r[i], v[i]);
}

// the channels of row (y, x): from the window where it holds the row, else
// from global memory.  vl points at this thread's channels of the level's
// first row.
template <typename T, bool kWindowed>
__device__ __forceinline__ Row<T> load_row(const T* vl, long long row_stride,
                                           int wl, int y, int x,
                                           const Window<T>& win, int hd,
                                           int c) {
  if (kWindowed) {
    const unsigned wx = static_cast<unsigned>(x - win.x0);
    const unsigned wy = static_cast<unsigned>(y - win.y0);
    if (wx < static_cast<unsigned>(win.w) &&
        wy < static_cast<unsigned>(win.h))
      return load_row16(win.rows + (wy * win.w + wx) * hd + c);
  }
  return ldg_row16(vl + static_cast<long long>(y * wl + x) * row_stride);
}

// acc += a * (bilinear read at loc) for one sample
template <typename T, bool kWindowed>
__device__ __forceinline__ void sample(Row<T>& acc, const T* vl,
                                       long long row_stride, int hl, int wl,
                                       float2 loc, float a,
                                       const Window<T>& win, int hd, int c) {
  // rounded as loc * W, then - 0.5 (no FMA): the plain version's x, y
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
  Row<T> v = {};
  if (kWindowed) {
    // the usual case: all four corners in the window (and so in the map),
    // one address and no further test
    const unsigned wx = static_cast<unsigned>(x0 - win.x0);
    const unsigned wy = static_cast<unsigned>(y0 - win.y0);
    if (wx < static_cast<unsigned>(win.w - 1) &&
        wy < static_cast<unsigned>(win.h - 1)) {
      const T* r = win.rows + (wy * win.w + wx) * hd + c;
      const int down = win.w * hd;
      fma_row(v.v, hy * hx, load_row16(r).v);
      fma_row(v.v, hy * lx, load_row16(r + hd).v);
      fma_row(v.v, ly * hx, load_row16(r + down).v);
      fma_row(v.v, ly * lx, load_row16(r + down + hd).v);
      fma_row(acc.v, a, v.v);
      return;
    }
  }
  if (!(x > -1.0f && y > -1.0f && x < wl && y < hl)) return;
  if (y0 >= 0) {
    if (x0 >= 0)
      fma_row(v.v, hy * hx,
              load_row<T, kWindowed>(vl, row_stride, wl, y0, x0, win, hd, c)
                  .v);
    if (x0 + 1 < wl)
      fma_row(v.v, hy * lx,
              load_row<T, kWindowed>(vl, row_stride, wl, y0, x0 + 1, win, hd,
                                     c).v);
  }
  if (y0 + 1 < hl) {
    if (x0 >= 0)
      fma_row(v.v, ly * hx,
              load_row<T, kWindowed>(vl, row_stride, wl, y0 + 1, x0, win, hd,
                                     c).v);
    if (x0 + 1 < wl)
      fma_row(v.v, ly * lx,
              load_row<T, kWindowed>(vl, row_stride, wl, y0 + 1, x0 + 1, win,
                                     hd, c).v);
  }
  fma_row(acc.v, a, v.v);
}

template <typename T>
struct Args {
  const T* value;
  const int* level_info;   // (levels, 3): H, W, first token
  const int* tile_info;    // (levels, 5): tile H, tile W, tiles across,
                           // tiles of the level, first tile of the level
  const float* locs;
  const float* attn;
  T* out;
  int b, s, q, heads, hd, levels, points;
  int tiles;         // tiles of one (scene, head), over all tiled levels
  int direct_from;   // queries from here on take the query-major mapping
  int window_rows;   // rows of head_dim values that the window holds
};

// one tile of one level's queries for one head, level after level
template <typename T>
__device__ __forceinline__ void tile_block(const Args<T>& a,
                                           unsigned char* smem) {
  constexpr int kN = Row<T>::kN;
  const int tid = threadIdx.x;
  const int lpq = a.hd / kN;          // threads of one (query, head)
  const int qpp = kThreads / lpq;     // queries of one pass
  const int slot = tid / lpq;
  const int c = (tid % lpq) * kN;
  T* window = reinterpret_cast<T*>(smem);
  // after the window: the tile's locations and weights on one level
  float2* s_loc = reinterpret_cast<float2*>(window + a.window_rows * a.hd);
  float* s_aw = reinterpret_cast<float*>(s_loc + kMaxTile * a.points);
  int t = blockIdx.x;
  const int tile = t % a.tiles;
  t /= a.tiles;
  const int h = t % a.heads;
  const int bi = t / a.heads;

  const Tile tl = decode_tile(a.tile_info, a.level_info, a.levels, tile);
  const int th = tl.th, tw = tl.tw, ty0 = tl.ty0, tx0 = tl.tx0;
  const int hq = tl.hq, wq = tl.wq, startq = tl.startq;

  // this thread's queries: pass p takes query p * qpp + slot of the tile
  int query[kMaxPasses];
  Row<T> acc[kMaxPasses];
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) {
    const int qi = p * qpp + slot;
    const int y = ty0 + qi / tw;
    const int x = tx0 + qi % tw;
    query[p] = (qi < th * tw && y < hq && x < wq) ? startq + y * wq + x : -1;
    acc[p] = Row<T>{};
  }

  const long long row_stride = static_cast<long long>(a.heads) * a.hd;
  const T* vb =
      a.value + static_cast<long long>(bi) * a.s * row_stride + h * a.hd;
  for (int l = 0; l < a.levels; ++l) {
    const int hl = __ldg(a.level_info + 3 * l);
    const int wl = __ldg(a.level_info + 3 * l + 1);
    const T* vlevel =
        vb + static_cast<long long>(__ldg(a.level_info + 3 * l + 2)) *
                 row_stride;
    const Window<T> win = level_window<T>(tl, hl, wl, a.window_rows, window);
    __syncthreads();   // the last level's reads are done
    copy_window(window, win, vlevel, wl, row_stride, a.hd, slot, qpp, c);
    for (int i = tid; i < th * tw * a.points; i += kThreads) {
      const int qi = i / a.points;
      const int y = ty0 + qi / tw;
      const int x = tx0 + qi % tw;
      if (y >= hq || x >= wq) continue;
      const long long sp =
          (((static_cast<long long>(bi) * a.q + startq + y * wq + x) *
                a.heads + h) * a.levels + l) * a.points + i % a.points;
      copy_async<8>(s_loc + i, reinterpret_cast<const float2*>(a.locs) + sp);
      copy_async<4>(s_aw + i, a.attn + sp);
    }
    copy_async_wait();
    __syncthreads();

    const T* vl = vlevel + c;
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p) {
      if (query[p] < 0) continue;
      const int s0 = (p * qpp + slot) * a.points;
      for (int pt = 0; pt < a.points; ++pt)
        sample<T, true>(acc[p], vl, row_stride, hl, wl, s_loc[s0 + pt],
                        s_aw[s0 + pt], win, a.hd, c);
    }
  }
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) {
    if (query[p] < 0) continue;
    store_row16(a.out + (static_cast<long long>(bi) * a.q + query[p]) *
                            row_stride + h * a.hd + c,
                acc[p]);
  }
}

// query-major: a thread takes every sample of its (query, head, channels)
template <typename T>
__device__ __forceinline__ void query_block(const Args<T>& a, int block) {
  constexpr int kN = Row<T>::kN;
  const int lpq = a.hd / kN;
  const int nq = a.q - a.direct_from;
  const long long total = static_cast<long long>(a.b) * nq * a.heads * lpq;
  const long long item = static_cast<long long>(block) * kThreads + threadIdx.x;
  if (item >= total) return;
  const int c = static_cast<int>(item % lpq) * kN;
  long long r = item / lpq;
  const int h = static_cast<int>(r % a.heads);
  r /= a.heads;
  const int qi = a.direct_from + static_cast<int>(r % nq);
  const int bi = static_cast<int>(r / nq);

  const long long row_stride = static_cast<long long>(a.heads) * a.hd;
  const T* vb = a.value + static_cast<long long>(bi) * a.s * row_stride +
                h * a.hd + c;
  const long long s0 =
      ((static_cast<long long>(bi) * a.q + qi) * a.heads + h) * a.levels *
      a.points;
  const float2* loc = reinterpret_cast<const float2*>(a.locs) + s0;
  const float* aw = a.attn + s0;
  const Window<T> none = {nullptr, 0, 0, 0, 0};
  Row<T> acc = {};
  for (int l = 0; l < a.levels; ++l) {
    const int hl = __ldg(a.level_info + 3 * l);
    const int wl = __ldg(a.level_info + 3 * l + 1);
    const T* vl =
        vb + static_cast<long long>(__ldg(a.level_info + 3 * l + 2)) *
                 row_stride;
    for (int pt = 0; pt < a.points; ++pt) {
      const int sp = l * a.points + pt;
      sample<T, false>(acc, vl, row_stride, hl, wl, __ldg(loc + sp),
                       __ldg(aw + sp), none, a.hd, c);
    }
  }
  store_row16(a.out + (static_cast<long long>(bi) * a.q + qi) * row_stride +
                  h * a.hd + c,
              acc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    msda_forward_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_blocks = a.b * a.heads * a.tiles;
  if (static_cast<int>(blockIdx.x) < tile_blocks)
    tile_block(a, smem);
  else
    query_block(a, blockIdx.x - tile_blocks);
}

template <typename T>
int launch(const void* value, const void* level_info, const void* tile_info,
           const void* locs, const void* attn, void* out, int b, int s, int q,
           int heads, int hd, int levels, int points, int tiles,
           int direct_from, int max_tile, void* stream) {
  constexpr int kN = Row<T>::kN;
  if (hd < kN || hd % kN || kThreads % (hd / kN) || tiles < 0 ||
      direct_from < 0 || direct_from > q || (tiles == 0 && direct_from != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  // a larger tile would overrun its slots for locations or a thread's sums
  if (tiles && (max_tile < 1 || max_tile > kMaxTile ||
                max_tile > kMaxPasses * (kThreads / (hd / kN))))
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte loads and cp.async of the rows (value, out) and 8 (locs)
  if ((reinterpret_cast<uintptr_t>(value) | reinterpret_cast<uintptr_t>(out)) %
          16 ||
      reinterpret_cast<uintptr_t>(locs) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  Args<T> a;
  a.value = static_cast<const T*>(value);
  a.level_info = static_cast<const int*>(level_info);
  a.tile_info = static_cast<const int*>(tile_info);
  a.locs = static_cast<const float*>(locs);
  a.attn = static_cast<const float*>(attn);
  a.out = static_cast<T*>(out);
  a.b = b;
  a.s = s;
  a.q = q;
  a.heads = heads;
  a.hd = hd;
  a.levels = levels;
  a.points = points;
  a.tiles = tiles;
  a.direct_from = direct_from;
  // what the tile's locations and weights (12 bytes a sample) leave
  a.window_rows = (kTileBytes - kMaxTile * points * 12) /
                  (hd * static_cast<int>(sizeof(T)));
  if (tiles && a.window_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long direct = static_cast<long long>(b) * (q - direct_from) *
                           heads * (hd / kN);
  const long long blocks = static_cast<long long>(b) * heads * tiles +
                           (direct + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  const int smem = tiles ? kTileBytes : 0;
  static int configured = -1;   // the shared memory of the last launch
  if (smem != configured) {
    // tile blocks need the large shared-memory carve-out, query-major
    // launches the large L1
    cudaError_t err = cudaFuncSetAttribute(
        msda_forward_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kTileBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          msda_forward_kernel<T>,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          tiles ? cudaSharedmemCarveoutMaxShared : cudaSharedmemCarveoutMaxL1);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  msda_forward_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// value: (B, S, heads, hd) f32, 16-byte aligned, hd a multiple of 4 that
// divides 1024; level_info: (levels, 3) int32 device array of (H, W, first
// token); tile_info: (levels, 5) int32 device array of (tile H, tile W,
// tiles across, tiles of the level, first tile of the level), read only
// when tiles > 0: then queries [0, direct_from) are the tokens of the tiled
// levels, max_tile is the most queries (tile H x tile W) of any tile, at
// most 256 and at most 4 * (512 / (hd / 4)), the tile's locations and
// weights on one level leave room for a window (points <= 16 does), and
// the other queries take the query-major mapping; locs: (B, Q, heads,
// levels, points, 2) f32, 8-byte aligned; attn: (B, Q, heads, levels,
// points) f32; out: (B, Q, heads * hd) f32, 16-byte aligned.  Anything
// else is refused with cudaErrorInvalidValue.
int demf_msda_forward(const void* value, const void* level_info,
                      const void* tile_info, const void* locs,
                      const void* attn, void* out, int b, int s, int q,
                      int heads, int hd, int levels, int points, int tiles,
                      int direct_from, int max_tile, void* stream) {
  return launch<float>(value, level_info, tile_info, locs, attn, out, b, s,
                       q, heads, hd, levels, points, tiles, direct_from,
                       max_tile, stream);
}

// The same with value and out in bfloat16: hd a multiple of 8 that
// divides 4096, max_tile at most 4 * (512 / (hd / 8)) (and 256); the sums
// are float32 and each output is rounded to bfloat16 once.
int demf_msda_forward_bf16(const void* value, const void* level_info,
                           const void* tile_info, const void* locs,
                           const void* attn, void* out, int b, int s, int q,
                           int heads, int hd, int levels, int points,
                           int tiles, int direct_from, int max_tile,
                           void* stream) {
  return launch<__nv_bfloat16>(value, level_info, tile_info, locs, attn, out,
                               b, s, q, heads, hd, levels, points, tiles,
                               direct_from, max_tile, stream);
}

}  // extern "C"
