// RoIAlign over an FPN pyramid, forward, a whole batch in one launch:
// out[b, r, oy, ox, :] is the mean of samples x samples bilinear samples of
// RoI r's bin (oy, ox) on its assigned level, from up to 4 NHWC float32 or
// bfloat16 levels read in place; the output is float32 either way.
//
// Replaces: demf_tpu/models/rpn_roi.py::pyramid_roi_align (one XLA gather
// of the four corners of every sample from the concatenated pyramid),
// vmapped over the images by StandardRoIHead; demf_tpu/ops/roi_align.py::
// roi_align is its single-level form.  XLA code, not a Pallas kernel.  On
// the path: 1,000 RoIs an image pooled from 152x208, 76x104, 38x52 and
// 19x26 maps of 256 channels into (1000, 7, 7, 256).
//
// The rule (ops/roi_align.py): aligned=True (-0.5), sample (i + 0.5) / s of
// a bin, the corner indices clamped to the level (mmcv reads zero outside;
// the JAX package clamps), v00 (1 - wy)(1 - wx) + v01 (1 - wy) wx +
// v10 wy (1 - wx) + v11 wy wx, the mean of the s x s samples.  Every step
// is written with __fadd_rn / __fmul_rn / __fdiv_rn in the plain version's
// order (the samples summed row-major, then divided by their count), so
// nvcc contracts nothing into an FMA and the output equals the plain
// version's bit for bit: the R-CNN's scores, and so the order and the NMS
// of the 2D boxes downstream, are the same on both paths.
//
// What bounds it on the card: bytes.  The output, 50.2 MB an image at
// 1,000 RoIs, is written once; the pyramid (43 MB an image) is read through
// the cache, each pixel by the few samples near it.  The operations (~4e8
// an image) are far below the float32 rate.
//
// Bfloat16 levels (the FPN's under the bf16 policy; demf_roi_align_bf16):
// the JAX package gathers the bf16 corners and multiplies them by float32
// weights, so the products, the sums and the output are float32.  A lane
// reads its 4 channels as 8 bytes, widens them in registers (a bfloat16 is
// the high half of the float32 it widens to, exactly) and goes on as the
// float32 kernel does, so the output equals the float32 kernel's on the
// levels widened, bit for bit, from half the bytes of the pyramid.
//
// The design: a block owns one RoI for all its bins over a slice of 128
// channels (32 lanes of 16 bytes), a warp a bin column (ox), walking the
// bin rows (oy) in step, so that the corners a bin row shares with its
// neighbours and with the next row are served by L1.  The RoI's sample
// table (ops/roi_align.py::sample_table: each sample's two clamped corner
// offsets and its weights, a row and a column axis) is computed once into
// shared memory by the first threads, with the plain version's roundings;
// the inner loop has only 32-bit adds and no division by a runtime value.
// With 2 x 2 samples a bin (every config) the loop is unrolled, so a
// thread has its bin's 16 loads of 16 bytes in flight at once; other
// counts take the same sums in a loop over the runtime count.  The
// output goes out with streaming stores (__stcs), so that it does not push
// the pyramid out of L2.
//
// K12, the backward with respect to the levels (demf_roi_align_backward),
// replaces the gradient JAX's autodiff takes of that gather
// (demf_tpu/models/rpn_roi.py:199), a scatter-add: d_level[y, x, c] +=
// w_corner / (s * s) * d_out[roi, bin, c] over each RoI's bins, samples and
// four corners, clamped as the forward clamps them (two corners clamped
// onto one pixel add twice, as the scatter does).  On the path: 512 sampled
// RoIs an image, once a step of the image-only Faster R-CNN training.  What
// bounds it: bytes, d_out read once and the levels' gradient written once
// (1.10 GB at batch 16).
//
// A bfloat16 level's gradient (demf_roi_align_backward_bf16) is summed in
// float32 as the float32 one is, partial tiles included, and rounded to
// bfloat16 once, at the store: it equals the float32 kernel's result
// rounded, bit for bit, and no float32 plane of it is made.
//
// The design: each pixel of each level has one writer that sums its terms
// in a fixed order, so nothing is added atomically into the levels, nothing
// is zero-filled first, and every call gives the same bits.  The levels
// are cut into tiles of 8 x 8 pixels.  A tile's list is its entries, the
// (RoI, bin) pairs whose corners reach it, in (RoI, bin) order: the RoIs
// of the image on its level in order, and of each the bins whose corner
// rows meet the tile's rows times those whose corner columns meet its
// columns (runs of consecutive bins: a bin's corners grow with its index),
// row-major.  A bin's weight on a pixel is separable, w_y(y) * w_x(x), each
// the sum of its samples' corner weights on that row or column, so an
// entry adds one term to each pixel its corners reach: (d_out * (w_y /
// (s s))) * w_x.  Four kernels a call:
// - table: each RoI's sample table (stage_table's roundings, the clamped
//   corner indices themselves), each bin's first and last corner on each
//   axis, the RoI's span;
// - count: a warp a tile counts its list, the lanes over the image's RoIs;
// - plan: one block cuts each list longer than `chunk` into balanced
//   chunks (fewer where the partial tiles would pass `slots`) and lays out
//   the work items, one a chunk, in tile order;
// - tiles: a block a work item over 256 channels, a warp a row of 8 pixels
//   in one slice of 128 channels, kept in its registers; a lane 4
//   channels.  The block scans the image's RoIs once (a block-wide prefix
//   sum of their entry counts ranks the entries), keeps those whose
//   entries fall in its chunk, and stages the entries 16 at a time, 3
//   batches ahead (cp.async: each entry's d_out for both slices and its
//   samples).  For a batch, a warp an entry weighs it on the tile's 8
//   rows and 8 columns (a ballot marks those a corner reaches); then each
//   warp takes, in order, the entries that reach its row (a ballot over
//   the batch) and adds their terms to the columns they reach, registers
//   indexed by constants.  A tile of one chunk is written once from the
//   registers, zeros where no entry reaches; a chunk of a longer list
//   writes a partial tile, and the block that arrives last (an integer
//   counter, the only atomic) sums the partials in chunk order into the
//   level.
// ops/roi_align.py::pyramid_roi_align_backward_tiles_plain sums the same
// terms in the same order, and this equals it bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;  // float4 channel lanes a block (128 channels)
constexpr int kMaxLevels = 4;

// the levels read by the forward (P = const V*) or written by the
// backward (P = V*), V the type of 4 channels: float4 for float32 levels,
// uint2 (4 bfloat16s) for bfloat16 ones
template <typename P>
struct LevelsOf {
  P ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
};
using Levels = LevelsOf<const float4*>;

// 4 channels of a level, read through the read-only cache, in float32: a
// bfloat16 widens exactly (its bits are the float32's high half; the first
// channel in the low half of the first word)
__device__ inline float4 load4(const float4* p) { return __ldg(p); }

__device__ inline float4 load4(const uint2* p) {
  const uint2 u = __ldg(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// 4 float32 sums stored as 4 channels of a level: a bfloat16 rounded to
// nearest even once, here
__device__ inline void store4(float4* p, float4 v) { *p = v; }

__device__ inline void store4(uint2* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  *p = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                  *reinterpret_cast<const unsigned*>(&hi));
}

// a level's entry by a runtime index, as selects: indexing the kernel's
// parameter struct with it would copy the struct to local memory
template <typename T>
__device__ inline T of_level(const T (&a)[kMaxLevels], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

__device__ inline int clamp_index(float v, int size) {
  // the float clamped first so that a huge or negative value converts safely
  const float c = fminf(fmaxf(v, -1.f), static_cast<float>(size - 1));
  return min(max(static_cast<int>(c), 0), size - 1);
}

// (v * a) * b, one rounding a product, as the plain version's
// v00 * (1 - wy) * (1 - wx)
__device__ inline float4 scale2(float4 v, float a, float b) {
  return make_float4(__fmul_rn(__fmul_rn(v.x, a), b),
                     __fmul_rn(__fmul_rn(v.y, a), b),
                     __fmul_rn(__fmul_rn(v.z, a), b),
                     __fmul_rn(__fmul_rn(v.w, a), b));
}

__device__ inline float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// one sample of an axis: its two clamped corners (offsets in float4 units
// in the forward's table, indices in K12's), the far corner's weight and
// the near one's
struct Sample {
  int a, b;
  float w, h;
};

// sample k of an axis of a RoI from lo_px to hi_px on a level of `size`
// pixels at `scale`: its clamped corner indices, with the plain version's
// roundings in its order
__device__ inline Sample sample_of(float lo_px, float hi_px, float scale,
                                   int size, int out_size, int s, int k) {
  const float lo = __fmul_rn(lo_px, scale);
  const float hi = __fmul_rn(hi_px, scale);
  const float bin = __fdiv_rn(fmaxf(__fsub_rn(hi, lo), 1e-3f),
                              static_cast<float>(out_size));
  const float g = __fdiv_rn(__fadd_rn(static_cast<float>(k), 0.5f),
                            static_cast<float>(s));
  const float v = __fsub_rn(__fadd_rn(lo, __fmul_rn(g, bin)), 0.5f);
  const float v0 = floorf(v);
  const float far = __fsub_rn(v, v0);
  Sample e;
  e.a = clamp_index(v0, size);
  e.b = clamp_index(v0 + 1.f, size);
  e.w = far;
  e.h = __fsub_rn(1.f, far);
  return e;
}

// the RoI's sample table, rows then columns, staged by the block's threads,
// the corners as offsets in float4 units
__device__ inline void stage_table(Sample* table, float4 box, float scale,
                                   int h, int w, int c4, int out_size,
                                   int s) {
  const int axis = out_size * s;
  for (int i = threadIdx.x; i < 2 * axis; i += blockDim.x) {
    const bool is_y = i < axis;
    Sample e = sample_of(is_y ? box.y : box.x, is_y ? box.w : box.z, scale,
                         is_y ? h : w, out_size, s, is_y ? i : i - axis);
    const int step = is_y ? w * c4 : c4;
    e.a *= step;
    e.b *= step;
    table[i] = e;
  }
}

template <typename V>
__device__ inline float4 bilinear(const V* __restrict__ base, Sample y,
                                  Sample x) {
  const float4 v00 = load4(base + y.a + x.a);
  const float4 v01 = load4(base + y.a + x.b);
  const float4 v10 = load4(base + y.b + x.a);
  const float4 v11 = load4(base + y.b + x.b);
  return add4(add4(add4(scale2(v00, y.h, x.h), scale2(v01, y.h, x.w)),
                   scale2(v10, y.w, x.h)),
              scale2(v11, y.w, x.w));
}

// S: samples a bin axis at compile time, or 0 for the runtime `samples`;
// V: 4 channels of a level (float4 or uint2 for bfloat16)
template <int S, typename V>
__global__ void roi_align_kernel(LevelsOf<const V*> levels,
                                 const float4* __restrict__ rois,
                                 const int* __restrict__ lvl,
                                 float4* __restrict__ out, int r, int c4,
                                 int num_levels, int out_size, int samples) {
  extern __shared__ Sample table[];  // out * s rows, then out * s columns
  const int s = S > 0 ? S : samples;
  const int axis = out_size * s;
  Sample* ys = table;
  Sample* xs = table + axis;
  const int roi = blockIdx.x;
  const int image = roi / r;
  const int lv = min(max(lvl[roi], 0), num_levels - 1);
  const int h = of_level(levels.h, lv), w = of_level(levels.w, lv);
  const float scale = of_level(levels.scale, lv);

  stage_table(table, rois[roi], scale, h, w, c4, out_size, s);
  __syncthreads();

  const int lane = threadIdx.x % kLanes, ox = threadIdx.x / kLanes;
  const int ch = blockIdx.y * kLanes + lane;
  if (ch >= c4) return;
  const V* base = of_level(levels.ptr, lv) +
                  static_cast<size_t>(image) * h * w * c4 + ch;
  float4* dst = out + static_cast<size_t>(roi) * out_size * out_size * c4 +
                ox * c4 + ch;
  const float count = static_cast<float>(s * s);
  for (int oy = 0; oy < out_size; ++oy) {
    float4 acc;
    if constexpr (S > 0) {
      // the bin's S * S samples' 4 S * S loads issued together
      float4 vals[S * S];
#pragma unroll
      for (int k = 0; k < S * S; ++k)
        vals[k] = bilinear(base, ys[oy * S + k / S], xs[ox * S + k % S]);
      acc = vals[0];
#pragma unroll
      for (int k = 1; k < S * S; ++k) acc = add4(acc, vals[k]);
    } else {
      acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int iy = 0; iy < s; ++iy)
        for (int ix = 0; ix < s; ++ix) {
          const float4 val = bilinear(base, ys[oy * s + iy], xs[ox * s + ix]);
          acc = iy == 0 && ix == 0 ? val : add4(acc, val);
        }
    }
    __stcs(dst + oy * out_size * c4,
           make_float4(__fdiv_rn(acc.x, count), __fdiv_rn(acc.y, count),
                       __fdiv_rn(acc.z, count), __fdiv_rn(acc.w, count)));
  }
}

// ---- K12 ----------------------------------------------------------------

// Timing only (tools/k12_phases.py builds copies with -DK12_SKIP=1, 2):
// phases 1..K12_SKIP of the tiles kernel (1 the sums: staging, weights and
// rows; 2 the scan of the RoIs) get a bound that is never true at run time,
// so the rest compiles as it is and the results are wrong.  The library is
// built without it: K12_RUNS is then true at compile time.
#ifndef K12_SKIP
#define K12_SKIP 0
#endif
#define K12_RUNS(phase, r) (K12_SKIP < (phase) || (r) > (1 << 30))

// a tile is kTileH x kTileW pixels; a warp keeps a row in registers
constexpr int kTileH = 8;
constexpr int kTileW = 8;

// where a level's tiles start among an image's, and its tiles across
struct TileGrid {
  int base[kMaxLevels];
  int across[kMaxLevels];
  int per_image;
};

// a tile's image, level and first row and column
struct Tile {
  int image, level, y0, x0;
};

__device__ inline Tile tile_at(const TileGrid& g, int t) {
  Tile e;
  e.image = t / g.per_image;
  const int local = t - e.image * g.per_image;
  e.level = (local >= g.base[1]) + (local >= g.base[2]) +
            (local >= g.base[3]);
  const int in_level = local - of_level(g.base, e.level);
  const int across = of_level(g.across, e.level);
  e.y0 = in_level / across * kTileH;
  e.x0 = in_level % across * kTileW;
  return e;
}

// the run of bins of one axis whose corners reach pixels [lo, hi], from
// each bin's (first, last) corner; both grow with the bin, so the bins
// below the run are those whose last corner is below lo and the run ends
// where the first corner passes hi.  -> (first bin, count)
__device__ inline int2 bins_reaching(const int2* __restrict__ bounds,
                                     int out_size, int lo, int hi) {
  int first = 0, end = 0;
#pragma unroll 8
  for (int o = 0; o < out_size; ++o) {
    const int2 v = __ldg(bounds + o);
    first += v.y < lo;
    end += v.x <= hi;
  }
  return make_int2(first, max(end - first, 0));
}

// a RoI's entries in a tile: its bins' run on each axis, packed as
// first | count << 16
struct Reach {
  int rows, cols, n;
};

__device__ inline Reach reach(const int2* bounds, int4 span, int out_size,
                              int y0, int y1, int x0, int x1) {
  Reach q = {0, 0, 0};
  if (span.x > y1 || span.y < y0 || span.z > x1 || span.w < x0) return q;
  const int2 ys = bins_reaching(bounds, out_size, y0, y1);
  const int2 xs = bins_reaching(bounds + out_size, out_size, x0, x1);
  q.rows = ys.x | ys.y << 16;
  q.cols = xs.x | xs.y << 16;
  q.n = ys.y * xs.y;
  return q;
}

__device__ inline int roi_level(const int* lvl, int roi, int num_levels) {
  return min(max(__ldg(lvl + roi), 0), num_levels - 1);
}

// K12 step 1: a thread a sample of an axis of a RoI, its table row
// (ys then xs, out * s each, clamped indices); a bin's first sample also
// writes the bin's first corner and its last sample the bin's last corner
// (bounds: ys then xs, out int2 each), and the RoI's first and last bins
// its span (first row, last row, first column, last column)
__global__ void roi_align_backward_table_kernel(
    const float4* __restrict__ rois, const int* __restrict__ lvl,
    Levels levels, Sample* __restrict__ table, int2* __restrict__ bounds,
    int4* __restrict__ spans, int n_rois, int num_levels, int out_size,
    int s) {
  const int axis = out_size * s;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rois * 2 * axis) return;
  const int roi = i / (2 * axis), j = i - roi * 2 * axis;
  const bool is_y = j < axis;
  const int k = is_y ? j : j - axis;
  const int lv = roi_level(lvl, roi, num_levels);
  const float4 box = rois[roi];
  const Sample e = sample_of(
      is_y ? box.y : box.x, is_y ? box.w : box.z, of_level(levels.scale, lv),
      is_y ? of_level(levels.h, lv) : of_level(levels.w, lv), out_size, s, k);
  table[i] = e;
  int* bin = reinterpret_cast<int*>(bounds + (2 * roi + !is_y) * out_size +
                                    k / s);
  if (k % s == 0) bin[0] = e.a;
  if (k % s == s - 1) bin[1] = e.b;
  int* span = reinterpret_cast<int*>(spans + roi) + (is_y ? 0 : 2);
  if (k == 0) span[0] = e.a;
  if (k == axis - 1) span[1] = e.b;
}

// K12 step 2: a warp a tile counts the entries of its list
__global__ void roi_align_backward_count_kernel(
    const int2* __restrict__ bounds, const int4* __restrict__ spans,
    const int* __restrict__ lvl, TileGrid grid, int* __restrict__ tile_n,
    int tiles, int r, int num_levels, int out_size) {
  const int t = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (t >= tiles) return;
  const Tile e = tile_at(grid, t);
  int n = 0;
  for (int i = lane; i < r; i += 32) {
    const int roi = e.image * r + i;
    if (roi_level(lvl, roi, num_levels) != e.level) continue;
    n += reach(bounds + 2 * roi * out_size, __ldg(spans + roi), out_size,
               e.y0, e.y0 + kTileH - 1, e.x0, e.x0 + kTileW - 1)
             .n;
  }
  for (int d = 16; d > 0; d /= 2) n += __shfl_xor_sync(0xffffffffu, n, d);
  if (lane == 0) tile_n[t] = n;
}

// an exclusive prefix sum of v over the block (every thread calls it);
// *total gets the block's sum
__device__ int block_exclusive_scan(int v, int* total, int* scratch) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = (blockDim.x + 31) / 32;
  int x = v;
  for (int d = 1; d < 32; d *= 2) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int y = lane < warps ? scratch[lane] : 0;
    for (int d = 1; d < 32; d *= 2) {
      const int z = __shfl_up_sync(0xffffffffu, y, d);
      if (lane >= d) y += z;
    }
    scratch[lane] = y;
  }
  __syncthreads();
  const int before = warp > 0 ? scratch[warp - 1] : 0;
  *total = scratch[warps - 1];
  __syncthreads();
  return before + x - v;
}

// K12 step 3, one block: the chunks of every list (a list of n entries
// wants ceil(n / chunk); where the lists of more than one want more
// partial tiles than `slots`, each of those gets its share of the slots,
// at least one), then the work items in tile order, one a chunk: (tile,
// first rank, end rank, partial slot or -1), and (-1, ...) up to the
// grid's tiles + slots; plan[t] is the tile's chunks and its first
// partial slot; the tiles in rounds of the block, so that its loads
// coalesce
constexpr int kPlanThreads = 1024;

__global__ void __launch_bounds__(kPlanThreads)
    roi_align_backward_plan_kernel(const int* __restrict__ tile_n,
                                   int2* __restrict__ plan,
                                   int4* __restrict__ items,
                                   int* __restrict__ arrivals, int tiles,
                                   int chunk, int slots, int slices) {
  __shared__ int scratch[32];
  __shared__ long long demand_of[32];
  long long demand = 0;
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
    const int want = (tile_n[t] + chunk - 1) / chunk;
    if (want > 1) demand += want;
  }
  for (int d = 16; d > 0; d /= 2)
    demand += __shfl_xor_sync(0xffffffffu, demand, d);
  if (threadIdx.x % 32 == 0) demand_of[threadIdx.x / 32] = demand;
  __syncthreads();
  demand = 0;
  for (int i = 0; i < static_cast<int>(blockDim.x + 31) / 32; ++i)
    demand += demand_of[i];
  int done = 0, used = 0;
  for (int t0 = 0; t0 < tiles; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    int n = 0, len = 1, chunks = 0;
    if (t < tiles) {
      n = tile_n[t];
      long long want = max((n + chunk - 1) / chunk, 1);
      if (want > 1 && demand > slots)
        want = max(want * slots / demand, 1LL);
      len = n > 0 ? static_cast<int>((n + want - 1) / want) : 1;
      chunks = n > 0 ? (n + len - 1) / len : 1;
    }
    int round_items, round_used;
    const int item = done + block_exclusive_scan(chunks, &round_items,
                                                 scratch);
    const int slot = used + block_exclusive_scan(chunks > 1 ? chunks : 0,
                                                 &round_used, scratch);
    if (t < tiles) {
      plan[t] = make_int2(chunks, slot);
      for (int k = 0; k < chunks; ++k)
        items[item + k] = make_int4(t, k * len, min(n, (k + 1) * len),
                                    chunks > 1 ? slot + k : -1);
    }
    done += round_items;
    used += round_used;
  }
  for (int i = done + threadIdx.x; i < tiles + slots; i += blockDim.x)
    items[i] = make_int4(-1, 0, 0, -1);
  for (int i = threadIdx.x; i < tiles * slices; i += blockDim.x)
    arrivals[i] = 0;
}

// a bin's weight on pixel v of one axis, and whether a corner lands
// there: its samples' near and far corner weights at v, summed in sample
// then corner order from zero (ys or xs of the bin, in shared or global
// memory).  The bin's weight on pixel (y, x) is weight(y) * weight(x).
template <int S>
__device__ inline float axis_weight(const Sample* a, int s, int v,
                                    bool* hit) {
  float w = 0.f;
#pragma unroll
  for (int i = 0; i < (S > 0 ? S : s); ++i) {
    const Sample e = a[i];
    if (e.a == v) {
      w = __fadd_rn(w, e.h);
      *hit = true;
    }
    if (e.b == v) {
      w = __fadd_rn(w, e.w);
      *hit = true;
    }
  }
  return w;
}

__device__ inline float4 scale1(float4 v, float a) {
  return make_float4(__fmul_rn(v.x, a), __fmul_rn(v.y, a), __fmul_rn(v.z, a),
                     __fmul_rn(v.w, a));
}

__device__ inline void copy16(void* to, const void* from) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(to));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(from)
               : "memory");
}

// entries are staged kBatch at a time, their d_out slices and samples
// copied kStages - 1 batches ahead of the one being summed
constexpr int kBatch = 16;
constexpr int kStages = 4;
// a block covers 2 slices of 128 channels
constexpr int kSlices = 2;

// a tiles block's shared memory (dynamic: more than 48 KB)
template <int S>
struct TilesSmem {
  static constexpr int kThreads = kTileH * 32 * kSlices;
  static constexpr int kStaged = S > 0 ? 2 * S : 1;  // samples an entry
  float4 staged[kStages][kBatch][kSlices][32];
  Sample samples[kStages][kBatch][kStaged];
  // the pass's RoIs in the chunk: RoI, first rank, rows, columns
  int4 listed[kThreads];
  int3 entry[kStages][kBatch];  // RoI, bin row, bin column
  // an entry's row weights over s * s, then its column weights; the rows
  // and (<< 8) the columns a corner of it lands on
  __align__(16) float weight[kBatch][kTileH + kTileW];
  int reached[kBatch];
  int scratch[32];
  int last;
};

// K12 step 4: a block a work item (a chunk of a tile's list) over kSlices
// slices of 128 channels: a warp a row of a slice, a lane 4 channels; S
// as the forward's
template <int S, typename V>
__global__ void __launch_bounds__(kTileH * 32 * kSlices, 2)
    roi_align_backward_tiles_kernel(
        LevelsOf<V*> levels, const float4* __restrict__ d_out,
        const Sample* __restrict__ table, const int2* __restrict__ bounds,
        const int4* __restrict__ spans, const int* __restrict__ lvl,
        TileGrid grid, const int2* __restrict__ plan,
        const int4* __restrict__ items, int* __restrict__ arrivals,
        float4* __restrict__ partials, int r, int c4, int num_levels,
        int out_size, int samples) {
  using Smem = TilesSmem<S>;
  constexpr int kWarps = Smem::kThreads / 32;
  static_assert(kWarps >= kBatch, "a warp weighs an entry of a batch");
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_bytes);
  const int4 it = items[blockIdx.x];  // tile, first rank, end rank, slot
  if (it.x < 0) return;
  const int t = it.x, lo = it.y, hi = it.z;
  const Tile tile = tile_at(grid, t);
  const int s = S > 0 ? S : samples;
  const int axis = out_size * s;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_in = warp % kTileH, slice = warp / kTileH;
  const int row = tile.y0 + row_in;
  const int ch = (blockIdx.y * kSlices + slice) * 32 + lane;
  const bool live = ch < c4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 acc[kTileW];
#pragma unroll
  for (int x = 0; x < kTileW; ++x) acc[x] = zero;

  int before = 0;  // entries of the RoIs before this pass
  for (int r0 = 0; r0 < r && before < hi && K12_RUNS(2, r);
       r0 += Smem::kThreads) {
    const int i = r0 + threadIdx.x;
    Reach q = {0, 0, 0};
    if (i < r) {
      const int roi = tile.image * r + i;
      const int lv = roi_level(lvl, roi, num_levels);
      const int4 span = __ldg(spans + roi);
      if (lv == tile.level)
        q = reach(bounds + 2 * roi * out_size, span, out_size, tile.y0,
                  tile.y0 + kTileH - 1, tile.x0, tile.x0 + kTileW - 1);
    }
    int pass_total, taken;
    const int start = before + block_exclusive_scan(q.n, &pass_total,
                                                    sm.scratch);
    const bool take = q.n > 0 && start < hi && start + q.n > lo;
    const int at = block_exclusive_scan(take, &taken, sm.scratch);
    if (take)
      sm.listed[at] = make_int4(tile.image * r + i, start, q.rows, q.cols);
    __syncthreads();
    // the pass's entries in the chunk: ranks [first, end); warp w stages
    // entries w, w + kWarps, ... of a batch, both slices of each
    const int first = max(lo, before), end = min(hi, before + pass_total);
    const int batches =
        K12_RUNS(1, r) ? (max(end - first, 0) + kBatch - 1) / kBatch : 0;
    int cursor = 0;  // the warp's listed RoI: its ranks only grow
    auto stage = [&](int j) {
      const int buf = j % kStages, from = first + j * kBatch;
      for (int e = warp; e < kBatch && j < batches; e += kWarps) {
        const int rank = from + e;
        if (rank >= end) break;
        while (cursor + 1 < taken && sm.listed[cursor + 1].y <= rank)
          ++cursor;
        const int4 l = sm.listed[cursor];
        const int cols = l.w >> 16, local = rank - l.y;
        const int oy = (l.z & 0xffff) + local / cols;
        const int ox = (l.w & 0xffff) + local % cols;
        const float4* src =
            d_out + (static_cast<size_t>(l.x) * out_size * out_size +
                     oy * out_size + ox) * c4;
#pragma unroll
        for (int u = 0; u < kSlices; ++u) {
          const int c = (blockIdx.y * kSlices + u) * 32 + lane;
          if (c < c4) copy16(&sm.staged[buf][e][u][lane], src + c);
        }
        if constexpr (S > 0) {
          const Sample* tab = table + static_cast<size_t>(l.x) * 2 * axis;
          if (lane < S)
            copy16(&sm.samples[buf][e][lane], tab + oy * S + lane);
          else if (lane < 2 * S)
            copy16(&sm.samples[buf][e][lane],
                   tab + axis + ox * S + lane - S);
        }
        if (lane == 0) sm.entry[buf][e] = make_int3(l.x, oy, ox);
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
    };
#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) stage(j);
    for (int j = 0; j < batches; ++j) {
      stage(j + kStages - 1);
      asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1) : "memory");
      __syncthreads();
      const int buf = j % kStages, count = min(kBatch, end - first -
                                                       j * kBatch);
      // the batch's weights: warp e weighs entry e, its lanes 0..7 on the
      // tile's rows, lanes 8..15 on its columns
      if (warp < count) {
        const int e = warp;
        bool hit = false;
        if (lane < kTileH + kTileW) {
          const Sample* ys;
          const Sample* xs;
          if constexpr (S > 0) {
            ys = sm.samples[buf][e];
            xs = ys + S;
          } else {
            const int3 en = sm.entry[buf][e];
            ys = table + static_cast<size_t>(en.x) * 2 * axis + en.y * s;
            xs = table + static_cast<size_t>(en.x) * 2 * axis + axis +
                 en.z * s;
          }
          float wt;
          if (lane < kTileH) {
            wt = axis_weight<S>(ys, s, tile.y0 + lane, &hit);
            wt = S > 0 ? __fmul_rn(wt, 1.f / static_cast<float>(S * S))
                       : __fdiv_rn(wt, static_cast<float>(s * s));
          } else {
            wt = axis_weight<S>(xs, s, tile.x0 + lane - kTileH, &hit);
          }
          sm.weight[e][lane] = wt;
        }
        const unsigned on = __ballot_sync(0xffffffffu, hit);
        if (lane == 0) sm.reached[e] = on & 0xffffu;
      }
      __syncthreads();
      // the row's terms: each entry that reaches it, in order
      unsigned mine = __ballot_sync(
          0xffffffffu,
          lane < count && (sm.reached[lane % kBatch] >> row_in & 1));
      while (mine) {
        const int e = __ffs(mine) - 1;
        mine &= mine - 1;
        const unsigned cols = sm.reached[e] >> 8;
        const float4 gy =
            scale1(sm.staged[buf][e][slice][lane], sm.weight[e][row_in]);
        const float4 w0 =
            *reinterpret_cast<const float4*>(&sm.weight[e][kTileH]);
        const float4 w1 =
            *reinterpret_cast<const float4*>(&sm.weight[e][kTileH + 4]);
        const float wx[kTileW] = {w0.x, w0.y, w0.z, w0.w,
                                  w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int x = 0; x < kTileW; ++x)
          if (cols >> x & 1) acc[x] = add4(acc[x], scale1(gy, wx[x]));
      }
      __syncthreads();  // before the next stage rewrites this buffer
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    before += pass_total;
    __syncthreads();  // before the next pass rewrites the list
  }

  const int h = of_level(levels.h, tile.level);
  const int w = of_level(levels.w, tile.level);
  V* level = of_level(levels.ptr, tile.level) +
             (static_cast<size_t>(tile.image) * h + row) * w * c4 + ch;
  if (it.w < 0) {
    if (row < h && live)
#pragma unroll
      for (int x = 0; x < kTileW; ++x)
        if (tile.x0 + x < w) store4(level + (tile.x0 + x) * c4, acc[x]);
    return;
  }
  // a chunk of a longer list: its partial tile in slot it.w, then the last
  // to arrive sums the chunks' partials in order
  const int2 chunks = plan[t];  // chunks, first slot
  const size_t slot_size = static_cast<size_t>(kTileH) * kTileW * c4;
  float4* mine = partials + it.w * slot_size + row_in * kTileW * c4 + ch;
  if (live)
#pragma unroll
    for (int x = 0; x < kTileW; ++x) mine[x * c4] = acc[x];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    sm.last = atomicAdd(arrivals + t * gridDim.y + blockIdx.y, 1) ==
              chunks.x - 1;
  __syncthreads();
  if (!sm.last) return;
  __threadfence();
  if (row >= h || !live) return;
  const float4* first =
      partials + chunks.y * slot_size + row_in * kTileW * c4 + ch;
#pragma unroll
  for (int x = 0; x < kTileW; ++x) {
    if (tile.x0 + x >= w) continue;
    float4 sum = __ldcg(first + x * c4);
    for (int j = 1; j < chunks.x; ++j)
      sum = add4(sum, __ldcg(first + j * slot_size + x * c4));
    store4(level + (tile.x0 + x) * c4, sum);
  }
}

// launches the tiles kernel, its shared memory allowed once
template <int S, typename V>
cudaError_t launch_tiles(dim3 blocks, cudaStream_t st,
                         LevelsOf<V*> levels, const float4* d_out,
                         const Sample* table, const int2* bounds,
                         const int4* spans, const int* lvl, TileGrid grid,
                         const int2* plan, const int4* items, int* arrivals,
                         float4* partials, int r, int c4, int num_levels,
                         int out_size, int samples) {
  constexpr int kBytes = sizeof(TilesSmem<S>);
  static const cudaError_t allowed = cudaFuncSetAttribute(
      roi_align_backward_tiles_kernel<S, V>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (allowed != cudaSuccess) return allowed;
  roi_align_backward_tiles_kernel<S, V>
      <<<blocks, TilesSmem<S>::kThreads, kBytes, st>>>(
          levels, d_out, table, bounds, spans, lvl, grid, plan, items,
          arrivals, partials, r, c4, num_levels, out_size, samples);
  return cudaSuccess;
}

template <typename P>
LevelsOf<P> levels_of(const void* const (&ptrs)[kMaxLevels],
                      const int (&hs)[kMaxLevels],
                      const int (&ws)[kMaxLevels],
                      const float (&ss)[kMaxLevels]) {
  LevelsOf<P> levels;
  for (int i = 0; i < kMaxLevels; ++i) {
    levels.ptr[i] = static_cast<P>(const_cast<void*>(ptrs[i]));
    levels.h[i] = hs[i];
    levels.w[i] = ws[i];
    levels.scale[i] = ss[i];
  }
  return levels;
}

bool bad_shape(int out_size, int samples) {
  return out_size < 1 || out_size > 32 || samples < 1 ||
         out_size * samples > 1024;
}

// K11 with levels of V (float4: float32, uint2: bfloat16)
template <typename V>
int launch_forward(const void* const (&f)[kMaxLevels], const void* rois,
                   const void* lvl, void* out, int b, int r, int c,
                   int num_levels, int out_size, int samples,
                   const int (&hs)[kMaxLevels], const int (&ws)[kMaxLevels],
                   const float (&ss)[kMaxLevels], void* stream) {
  if (b == 0 || r == 0 || c == 0) return 0;
  if (bad_shape(out_size, samples))
    return static_cast<int>(cudaErrorInvalidValue);
  const LevelsOf<const V*> levels = levels_of<const V*>(f, hs, ws, ss);
  const int c4 = c / 4;
  const dim3 grid(b * r, (c4 + kLanes - 1) / kLanes);
  const int threads = kLanes * out_size;
  const size_t shared = 2 * sizeof(Sample) * out_size * samples;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* boxes = static_cast<const float4*>(rois);
  const int* levels_of_roi = static_cast<const int*>(lvl);
  float4* dst = static_cast<float4*>(out);
  if (samples == 2)
    roi_align_kernel<2, V><<<grid, threads, shared, s>>>(
        levels, boxes, levels_of_roi, dst, r, c4, num_levels, out_size,
        samples);
  else
    roi_align_kernel<0, V><<<grid, threads, shared, s>>>(
        levels, boxes, levels_of_roi, dst, r, c4, num_levels, out_size,
        samples);
  return static_cast<int>(cudaGetLastError());
}

// K12 writing level gradients of V
template <typename V>
int launch_backward(const void* const (&g)[kMaxLevels], const void* rois,
                    const void* lvl, const void* d_out, void* table,
                    void* bounds, void* spans, void* plan, void* tile_n,
                    void* items, void* arrivals, void* partials, int b, int r,
                    int c, int num_levels, int out_size, int samples,
                    const int (&hs)[kMaxLevels], const int (&ws)[kMaxLevels],
                    const float (&ss)[kMaxLevels], int chunk, int slots,
                    void* stream) {
  if (b == 0 || c == 0) return 0;
  if (bad_shape(out_size, samples) || chunk < 1 || slots < 0 ||
      num_levels < 1 || num_levels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  const LevelsOf<V*> levels = levels_of<V*>(g, hs, ws, ss);
  const Levels sizes = levels_of<const float4*>(g, hs, ws, ss);
  TileGrid grid;
  int per_image = 0;
  for (int i = 0; i < kMaxLevels; ++i) {
    grid.base[i] = per_image;
    grid.across[i] = (levels.w[i] + kTileW - 1) / kTileW;
    if (i < num_levels)
      per_image += (levels.h[i] + kTileH - 1) / kTileH * grid.across[i];
  }
  for (int i = num_levels; i < kMaxLevels; ++i) grid.base[i] = per_image;
  grid.per_image = per_image;
  const int tiles = b * per_image;
  if (tiles == 0) return 0;
  const int c4 = c / 4;
  const int slices = (c4 + kLanes - 1) / kLanes;
  const int n_rois = b * r;
  const int axis = out_size * samples;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Sample* tab = static_cast<Sample*>(table);
  int2* bins = static_cast<int2*>(bounds);
  int4* span = static_cast<int4*>(spans);
  const int* roi_lvl = static_cast<const int*>(lvl);
  int* counts = static_cast<int*>(tile_n);
  int2* plans = static_cast<int2*>(plan);
  int4* work = static_cast<int4*>(items);
  int* arrive = static_cast<int*>(arrivals);
  if (n_rois > 0) {
    const int threads = n_rois * 2 * axis;
    roi_align_backward_table_kernel<<<(threads + 255) / 256, 256, 0, st>>>(
        static_cast<const float4*>(rois), roi_lvl, sizes, tab, bins, span,
        n_rois, num_levels, out_size, samples);
  }
  roi_align_backward_count_kernel<<<(tiles + 7) / 8, 256, 0, st>>>(
      bins, span, roi_lvl, grid, counts, tiles, r, num_levels, out_size);
  roi_align_backward_plan_kernel<<<1, kPlanThreads, 0, st>>>(
      counts, plans, work, arrive, tiles, chunk, slots, slices);
  const dim3 blocks(tiles + slots, (slices + kSlices - 1) / kSlices);
  const float4* grad = static_cast<const float4*>(d_out);
  float4* parts = static_cast<float4*>(partials);
  const cudaError_t err =
      samples == 2
          ? launch_tiles<2, V>(blocks, st, levels, grad, tab, bins, span,
                               roi_lvl, grid, plans, work, arrive, parts, r,
                               c4, num_levels, out_size, samples)
          : launch_tiles<0, V>(blocks, st, levels, grad, tab, bins, span,
                               roi_lvl, grid, plans, work, arrive, parts, r,
                               c4, num_levels, out_size, samples);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// f0..f3: (B, H_l, W_l, C) f32 levels (unused ones may repeat f0); rois
// (B, R, 4) f32; lvl (B, R) int32; out (B, R, out, out, C) f32, every
// element written; C a multiple of 4, every pointer 16-byte aligned;
// out_size <= 32, out_size * samples <= 1024, a level's H * W * C / 4
// below 2^31.
int demf_roi_align(const void* f0, const void* f1, const void* f2,
                   const void* f3, const void* rois, const void* lvl,
                   void* out, int b, int r, int c, int num_levels,
                   int out_size, int samples, int h0, int h1, int h2, int h3,
                   int w0, int w1, int w2, int w3, float s0, float s1,
                   float s2, float s3, void* stream) {
  return launch_forward<float4>({f0, f1, f2, f3}, rois, lvl, out, b, r, c,
                                num_levels, out_size, samples,
                                {h0, h1, h2, h3}, {w0, w1, w2, w3},
                                {s0, s1, s2, s3}, stream);
}

// The same with bfloat16 levels (8-byte aligned); out is float32.
int demf_roi_align_bf16(const void* f0, const void* f1, const void* f2,
                        const void* f3, const void* rois, const void* lvl,
                        void* out, int b, int r, int c, int num_levels,
                        int out_size, int samples, int h0, int h1, int h2,
                        int h3, int w0, int w1, int w2, int w3, float s0,
                        float s1, float s2, float s3, void* stream) {
  return launch_forward<uint2>({f0, f1, f2, f3}, rois, lvl, out, b, r, c,
                               num_levels, out_size, samples,
                               {h0, h1, h2, h3}, {w0, w1, w2, w3},
                               {s0, s1, s2, s3}, stream);
}

// K12. g0..g3: (B, H_l, W_l, C) f32 gradients of the levels, every
// element written (unused ones may repeat g0); rois, lvl and the sizes as
// the forward's; d_out (B, R, out, out, C) f32.  The same limits.  A
// tile's list is cut into chunks of about `chunk` entries, with at most
// `slots` partial tiles.  Scratch,
// 16-byte aligned: table (B R 2 out samples Samples), bounds (B R 2 out
// int2), spans (B R int4), plan (T int2), tile_n (T ints), items (T +
// slots int4), arrivals (T ceil(C / 128) ints), partials (slots 64 C
// f32), T the tiles of 8 x 8 pixels of the batch.
int demf_roi_align_backward(
    void* g0, void* g1, void* g2, void* g3, const void* rois,
    const void* lvl, const void* d_out, void* table, void* bounds,
    void* spans, void* plan, void* tile_n, void* items, void* arrivals,
    void* partials, int b,
    int r, int c, int num_levels, int out_size, int samples, int h0, int h1,
    int h2, int h3, int w0, int w1, int w2, int w3, float s0, float s1,
    float s2, float s3, int chunk, int slots,
    void* stream) {
  return launch_backward<float4>(
      {g0, g1, g2, g3}, rois, lvl, d_out, table, bounds, spans, plan, tile_n,
      items, arrivals, partials, b, r, c, num_levels, out_size, samples,
      {h0, h1, h2, h3}, {w0, w1, w2, w3}, {s0, s1, s2, s3}, chunk, slots,
      stream);
}

// The same with bfloat16 gradients of the levels (8-byte aligned): summed
// in float32, partial tiles too, each rounded once at its store.
int demf_roi_align_backward_bf16(
    void* g0, void* g1, void* g2, void* g3, const void* rois,
    const void* lvl, const void* d_out, void* table, void* bounds,
    void* spans, void* plan, void* tile_n, void* items, void* arrivals,
    void* partials, int b, int r, int c, int num_levels, int out_size,
    int samples, int h0, int h1, int h2, int h3, int w0, int w1, int w2,
    int w3, float s0, float s1, float s2, float s3, int chunk, int slots,
    void* stream) {
  return launch_backward<uint2>(
      {g0, g1, g2, g3}, rois, lvl, d_out, table, bounds, spans, plan, tile_n,
      items, arrivals, partials, b, r, c, num_levels, out_size, samples,
      {h0, h1, h2, h3}, {w0, w1, w2, w3}, {s0, s1, s2, s3}, chunk, slots,
      stream);
}

}  // extern "C"
