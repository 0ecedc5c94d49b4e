// Points in rotated 3D boxes, counted for a whole batch:
// count[b, n] = the number of points of scene b inside box n.
//
// Replaces: the XLA computation of demf_tpu/models/vote_head.py:49-50,
// jnp.sum(box_ops.points_in_boxes(pts[:, :3], bottom), 0), with
// points_in_boxes at demf_tpu/core/boxes.py:105, vmapped over the batch by
// multiclass_nms_3d (the non-empty-box test, count > 5, before the NMS).
// In plain PyTorch it builds (P, N) float temporaries a scene: the shift,
// lx, ly and three comparisons.
//
// A point is inside a box when, with the shift s = p - gravity_center(box)
// and (lx, ly) the shift rotated by the box's yaw in the box_corners-
// consistent sense (core/boxes.py::points_in_boxes),
//   |lx| <= hx,  |ly| <= hy,  |s_z| <= hz,  h = 0.5 * dims + eps.
// The terms are computed here as ops/box_count.py::box_terms computes them
// (the centre's z is z + dz * 0.5, h is dims * 0.5 + eps, each rounded
// once), but cos and sin of the yaw, which the wrapper hands in from
// torch.cos / torch.sin; the test is written with __fsub_rn / __fmul_rn /
// __fadd_rn in the plain version's order (lx = sx*c - sy*s, ly = sx*s +
// sy*c), so nvcc contracts nothing into an FMA and the counts equal the
// plain version's.  A NaN point or box counts nothing: every comparison
// with a NaN is false.  Points are read through their element strides, so
// the model's (B, P, 4) clouds (the 4th column is the height) need no copy.
//
// What bounds it on the card: operations.  Each (point, box) pair tested
// is 12 float32 operations; all pairs are 20,000 points x 512 boxes a
// scene, ~1.2e8 operations, while a box's points are a few hundred.  A
// first version tested all pairs at 65-70% of the card's instruction rate
// for them; only testing fewer pairs makes it faster.
//
// The design: cull by a grid, in two kernels.
// - Bin (a cluster of 8 blocks a scene, each a run of its points, sharing
//   their extents and counts through distributed shared memory): the xy
//   extent of the scene's finite points, a grid of kGrid x kGrid cells over
//   it, the points counted a cell in shared memory, the counts summed into
//   each cell's first point, and the points (x, y, z) written in cell order
//   (row-major cells; a point with a non-finite x or y goes to one more
//   cell at the end, which every box tests).  Inside a cell the order is
//   that of shared-memory atomics: the counts are integer sums, so no order
//   changes them.
// - Count (a warp a box): the cells that the box's bounding circle,
//   sqrt(hx^2 + hy^2), covers, widened by a margin (2^-10 of the radius
//   and 2^-14 of the coordinates' magnitude), which holds every point the
//   rounded test can put inside (the rounded rotation keeps a point within
//   1 + 2^-21 of its radius; a cell's edge moves by less than 2^-16 of a
//   cell); a box with a non-finite term covers every cell.  A covered row
//   of cells is one run of the sorted points; the warp walks the runs of
//   all its rows as one, 8 points a lane at once, the warp sums its count
//   with __reduce_add_sync, and lane 0 writes it: no atomics, no
//   zero-fill.
// ops/box_count.py::box_cells is the same grid and cover in plain PyTorch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr int kGrid = 64;                 // cells on each axis
constexpr int kCells = kGrid * kGrid;     // + 1: the non-finite points
constexpr int kClusterBlocks = 8;         // bin blocks a scene
constexpr int kBinThreads = 1024;
// the most points of a scene (a block's run of them counts its places in
// a cell in 16 bits)
constexpr int kMaxPoints = kClusterBlocks * 65535;
constexpr int kCountThreads = 256;        // a warp a box
constexpr int kUnroll = 8;                // points a lane loads at once
constexpr unsigned kFull = 0xffffffffu;
// the margin of a box's circle: of its radius, and of the magnitudes of
// its centre and the grid's corner
constexpr float kRadiusMargin = 1.0f + 1.0f / 1024.0f;
constexpr float kMagnitudeMargin = 1.0f / 16384.0f;

// a scene's grid: its corner, the cells a metre on each axis, the largest
// magnitude of the corner's coordinates (written by the bin kernel)
struct Grid {
  float x0, y0, inv_x, inv_y, magnitude;
};

__device__ __forceinline__ bool finite(float v) { return isfinite(v); }

// the cell column (or row) of coordinate v: floor((v - v0) * inv), held in
// [0, kGrid - 1] before the conversion (a NaN falls to 0)
__device__ __forceinline__ int cell_of(float v, float v0, float inv) {
  const float f = floorf(__fmul_rn(__fsub_rn(v, v0), inv));
  return static_cast<int>(fminf(fmaxf(f, 0.0f), kGrid - 1.0f));
}

__device__ __forceinline__ int point_cell(float x, float y, const Grid& g) {
  if (!finite(x) || !finite(y)) return kCells;
  return cell_of(y, g.y0, g.inv_y) * kGrid + cell_of(x, g.x0, g.inv_x);
}

// cells a metre over an extent [lo, hi]: kGrid / (hi - lo), 0 where the
// extent is 0 (or there are no points), so that every point is in cell 0
__device__ __forceinline__ float cells_per_metre(float lo, float hi) {
  return hi > lo ? __fdiv_rn(static_cast<float>(kGrid), __fsub_rn(hi, lo))
                 : 0.0f;
}

// The points of one scene binned by a cluster of kClusterBlocks blocks,
// each taking a run of them; the blocks share their extents and their
// counts a cell through distributed shared memory.  (One block a scene,
// each thread holding 20 points in turn, took ~35 us on the H100: every
// pass waited on its loads and shared-memory atomics in series.)
__global__ void __cluster_dims__(kClusterBlocks, 1, 1)
    __launch_bounds__(kBinThreads)
    box_count_bin_kernel(const float* __restrict__ points,
                         float4* __restrict__ sorted, int* __restrict__ first,
                         Grid* __restrict__ grids, int p, long long sb,
                         long long sp, long long sc) {
  extern __shared__ unsigned short rank_in_cell[];   // of this block's run
  __shared__ int cell_count[kCells + 1];   // this block's points a cell
  __shared__ int cell_base[kCells + 1];    // its first place in a cell
  __shared__ float extent[4], red[4][32];
  __shared__ int warp_totals[32];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kClusterBlocks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* scene = points + b * sb;
  const int per_block = (p + kClusterBlocks - 1) / kClusterBlocks;
  const int i0 = min(p, rank * per_block), i1 = min(p, i0 + per_block);

  // the extent of the run's finite points, then the scene's
  float lo_x = CUDART_INF_F, hi_x = -CUDART_INF_F;
  float lo_y = CUDART_INF_F, hi_y = -CUDART_INF_F;
  for (int i = i0 + tid; i < i1; i += kBinThreads) {
    const float x = scene[i * sp], y = scene[i * sp + sc];
    if (finite(x) && finite(y)) {
      lo_x = fminf(lo_x, x);
      hi_x = fmaxf(hi_x, x);
      lo_y = fminf(lo_y, y);
      hi_y = fmaxf(hi_y, y);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo_x = fminf(lo_x, __shfl_xor_sync(kFull, lo_x, o));
    hi_x = fmaxf(hi_x, __shfl_xor_sync(kFull, hi_x, o));
    lo_y = fminf(lo_y, __shfl_xor_sync(kFull, lo_y, o));
    hi_y = fmaxf(hi_y, __shfl_xor_sync(kFull, hi_y, o));
  }
  if (lane == 0) {
    red[0][warp] = lo_x;
    red[1][warp] = hi_x;
    red[2][warp] = lo_y;
    red[3][warp] = hi_y;
  }
  for (int c = tid; c <= kCells; c += kBinThreads) cell_count[c] = 0;
  __syncthreads();
  if (tid < 4) {
    float v = red[tid][0];
    for (int w = 1; w < kBinThreads / 32; ++w)
      v = tid & 1 ? fmaxf(v, red[tid][w]) : fminf(v, red[tid][w]);
    extent[tid] = v;
  }
  cluster.sync();   // every block's extent is in
  if (tid < 4 * kClusterBlocks) {
    const int k = tid / 4, j = tid % 4;
    red[j][k] = cluster.map_shared_rank(extent, k)[j];
  }
  __syncthreads();
  lo_x = red[0][0], hi_x = red[1][0], lo_y = red[2][0], hi_y = red[3][0];
  for (int k = 1; k < kClusterBlocks; ++k) {
    lo_x = fminf(lo_x, red[0][k]);
    hi_x = fmaxf(hi_x, red[1][k]);
    lo_y = fminf(lo_y, red[2][k]);
    hi_y = fmaxf(hi_y, red[3][k]);
  }
  Grid g;
  g.x0 = hi_x >= lo_x ? lo_x : 0.0f;
  g.y0 = hi_y >= lo_y ? lo_y : 0.0f;
  g.inv_x = cells_per_metre(lo_x, hi_x);
  g.inv_y = cells_per_metre(lo_y, hi_y);
  g.magnitude = hi_x >= lo_x ? fmaxf(fmaxf(fabsf(lo_x), fabsf(hi_x)),
                                     fmaxf(fabsf(lo_y), fabsf(hi_y)))
                             : 0.0f;
  if (rank == 0 && tid == 0) grids[b] = g;

  // the run's points a cell, and each point's place among them
  for (int i = i0 + tid; i < i1; i += kBinThreads)
    rank_in_cell[i - i0] = static_cast<unsigned short>(atomicAdd(
        &cell_count[point_cell(scene[i * sp], scene[i * sp + sc], g)], 1));
  cluster.sync();   // every block's counts are in
  // block k takes the k-th slice of the cells: for each, every block's
  // count; the cells' first places in the scene by a scan over the
  // slice's totals and the totals of the slices before it; and each
  // block's first place in the cell, written into that block's cell_base
  constexpr int kSlice = (kCells + 1 + kClusterBlocks - 1) / kClusterBlocks;
  const int c = rank * kSlice + tid;
  const bool mine = tid < kSlice && c <= kCells;
  int counts[kClusterBlocks], total = 0;
#pragma unroll
  for (int k = 0; k < kClusterBlocks; ++k) {
    counts[k] = mine ? cluster.map_shared_rank(cell_count, k)[c] : 0;
    total += counts[k];
  }
  int x = total;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_totals[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = warp_totals[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, t, o);
      if (lane >= o) t += y;
    }
    warp_totals[lane] = t;
  }
  __syncthreads();
  const int in_slice = (warp ? warp_totals[warp - 1] : 0) + x - total;
  cluster.sync();   // every slice's total is in (warp_totals[31])
  int place = in_slice;
  for (int k = 0; k < rank; ++k)
    place += cluster.map_shared_rank(warp_totals, k)[31];
  if (mine) {
    first[static_cast<long long>(b) * (kCells + 2) + c] = place;
#pragma unroll
    for (int k = 0; k < kClusterBlocks; ++k) {
      cluster.map_shared_rank(cell_base, k)[c] = place;
      place += counts[k];
    }
  }
  if (rank == 0 && tid == 0)
    first[static_cast<long long>(b) * (kCells + 2) + kCells + 1] = p;
  cluster.sync();   // every block's cell_base is in; no remote access after
  // the run's points in cell order
  float4* out = sorted + static_cast<long long>(b) * p;
  for (int i = i0 + tid; i < i1; i += kBinThreads) {
    const float* pt = scene + i * sp;
    const float px = pt[0], py = pt[sc], pz = pt[2 * sc];
    out[cell_base[point_cell(px, py, g)] + rank_in_cell[i - i0]] =
        make_float4(px, py, pz, 0.0f);
  }
}

// 1 if the point v is inside the box (the test's order and roundings)
__device__ __forceinline__ int inside_box(const float4& v, float cx, float cy,
                                          float cz, float c, float s,
                                          float hx, float hy, float hz) {
  const float sx = __fsub_rn(v.x, cx);
  const float sy = __fsub_rn(v.y, cy);
  const float sz = __fsub_rn(v.z, cz);
  const float lx = __fsub_rn(__fmul_rn(sx, c), __fmul_rn(sy, s));
  const float ly = __fadd_rn(__fmul_rn(sx, s), __fmul_rn(sy, c));
  return (fabsf(lx) <= hx) & (fabsf(ly) <= hy) & (fabsf(sz) <= hz);
}

__global__ void __launch_bounds__(kCountThreads)
    box_count_kernel(const float4* __restrict__ sorted,
                     const int* __restrict__ first,
                     const Grid* __restrict__ grids,
                     const float* __restrict__ boxes,
                     const float* __restrict__ cos_yaw,
                     const float* __restrict__ sin_yaw,
                     int* __restrict__ count, int p, int n, float eps) {
  const int b = blockIdx.y;
  const int box = blockIdx.x * (kCountThreads / 32) + (threadIdx.x >> 5);
  if (box >= n) return;   // whole warps leave
  const int lane = threadIdx.x & 31;
  const long long at_box = static_cast<long long>(b) * n + box;
  const float* bx = boxes + at_box * 7;
  // box_terms' roundings
  const float cx = bx[0], cy = bx[1];
  const float half_z = __fmul_rn(bx[5], 0.5f);
  const float cz = __fadd_rn(bx[2], half_z);
  const float hx = __fadd_rn(__fmul_rn(bx[3], 0.5f), eps);
  const float hy = __fadd_rn(__fmul_rn(bx[4], 0.5f), eps);
  const float hz = __fadd_rn(half_z, eps);
  const float c = cos_yaw[at_box], s = sin_yaw[at_box];
  const Grid g = grids[b];
  int lo_x = 0, hi_x = kGrid - 1, lo_y = 0, hi_y = kGrid - 1;
  if (finite(cx) && finite(cy) && finite(hx) && finite(hy) && finite(c) &&
      finite(s)) {
    const float r = __fadd_rn(
        __fmul_rn(sqrtf(__fadd_rn(__fmul_rn(hx, hx), __fmul_rn(hy, hy))),
                  kRadiusMargin),
        __fmul_rn(__fadd_rn(__fadd_rn(g.magnitude, fabsf(cx)), fabsf(cy)),
                  kMagnitudeMargin));
    lo_x = cell_of(__fsub_rn(cx, r), g.x0, g.inv_x);
    hi_x = cell_of(__fadd_rn(cx, r), g.x0, g.inv_x);
    lo_y = cell_of(__fsub_rn(cy, r), g.y0, g.inv_y);
    hi_y = cell_of(__fadd_rn(cy, r), g.y0, g.inv_y);
  }
  const float4* pts = sorted + static_cast<long long>(b) * p;
  const int* f = first + static_cast<long long>(b) * (kCells + 2);
  // runs of sorted points, up to 32 at a time: the covered rows of cells
  // (lane j the run of row j), then the non-finite points (the last
  // lane's run in the last group).  The warp walks their concatenation,
  // kUnroll points a lane at once; a lane finds its point's run by a
  // binary search over the runs' offsets
  const int rows = hi_y - lo_y + 1;
  int inside = 0;
  for (int j0 = 0; j0 <= rows; j0 += 31) {
    int from = 0, len = 0;
    const int j = j0 + lane;
    if (lane < 31 && j < rows) {
      const int row = (lo_y + j) * kGrid;
      from = __ldg(f + row + lo_x);
      len = __ldg(f + row + hi_x + 1) - from;
    } else if (lane == 31 && j0 + 31 > rows) {
      from = __ldg(f + kCells);
      len = __ldg(f + kCells + 1) - from;
    }
    int end = len;   // inclusive prefix of the lengths
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, end, o);
      if (lane >= o) end += y;
    }
    const int begin = end - len;
    const int all = __shfl_sync(kFull, end, 31);
    for (int t0 = 0; t0 < all; t0 += 32 * kUnroll) {
      float4 v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int t = t0 + 32 * k + lane;
        int run = 0;   // the last run that begins at or before t
#pragma unroll
        for (int step = 16; step > 0; step >>= 1)
          if (__shfl_sync(kFull, begin, run + step) <= t) run += step;
        const int at = __shfl_sync(kFull, from, run) + t -
                       __shfl_sync(kFull, begin, run);
        v[k] = t < all ? __ldg(pts + at)
                       : make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F,
                                     0.0f);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        inside += inside_box(v[k], cx, cy, cz, c, s, hx, hy, hz);
    }
  }
  inside = __reduce_add_sync(kFull, inside);
  if (lane == 0) count[at_box] = inside;
}

}  // namespace

extern "C" {

// points: (B, P, >=3) float32, the coordinate c of point i of scene b at
// points + b*sb + i*sp + c*sc (element strides); boxes: (B, N, 7) float32
// contiguous; cos_yaw, sin_yaw: (B, N) float32 contiguous, the yaw's
// cosine and sine; scratch: 16-byte aligned, B * (16 P + 4 (kGrid^2 + 2) +
// 32) bytes (ops/box_count.py::scratch_bytes); count: (B, N) int32, every
// element written here.  grid must be kGrid (the wrapper's idea of the
// scratch's layout).  Returns cudaErrorInvalidValue for a batch beyond the
// grid's limits or another grid; an empty batch launches nothing.
int demf_box_count(const void* points, const void* boxes, const void* cos_yaw,
                   const void* sin_yaw, void* scratch, void* count, int b,
                   int p, int n, long long sb, long long sp, long long sc,
                   float eps, int grid, void* stream) {
  if (grid != kGrid || b > 65535 || b < 0 || p < 0 || p > kMaxPoints ||
      n < 0 || reinterpret_cast<uintptr_t>(scratch) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || p == 0 || n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* sorted = static_cast<float4*>(scratch);
  int* first = reinterpret_cast<int*>(sorted + static_cast<long long>(b) * p);
  Grid* grids = reinterpret_cast<Grid*>(
      first + static_cast<long long>(b) * (kCells + 2));
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        box_count_bin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        65535 * static_cast<int>(sizeof(unsigned short)));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int per_block = (p + kClusterBlocks - 1) / kClusterBlocks;
  box_count_bin_kernel<<<b * kClusterBlocks, kBinThreads,
                         per_block * sizeof(unsigned short), st>>>(
      static_cast<const float*>(points), sorted, first, grids, p, sb, sp, sc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kBoxesPerBlock = kCountThreads / 32;
  const dim3 blocks((n + kBoxesPerBlock - 1) / kBoxesPerBlock, b);
  box_count_kernel<<<blocks, kCountThreads, 0, st>>>(
      sorted, first, grids, static_cast<const float*>(boxes),
      static_cast<const float*>(cos_yaw), static_cast<const float*>(sin_yaw),
      static_cast<int*>(count), p, n, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
