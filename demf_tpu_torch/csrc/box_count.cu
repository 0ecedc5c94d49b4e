// Points in rotated 3D boxes, counted for a whole batch in one launch:
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
// The wrapper (ops/box_count.py::box_terms) hands in the per-box terms
// (center, cos yaw, sin yaw, h) computed by the plain version's own torch
// expressions, so no cosf runs here; the test is written with __fsub_rn /
// __fmul_rn / __fadd_rn in the plain version's order (lx = sx*c - sy*s,
// ly = sx*s + sy*c), so nvcc contracts nothing into an FMA and the counts
// equal the plain version's.  A NaN point or box counts nothing: every
// comparison with a NaN is false.  Points are read through their element
// strides, so the model's (B, P, 4) clouds (the 4th column is the height)
// need no copy.
//
// What bounds it on the card: operations.  Each (point, box) pair is one
// test of 12 float32 operations (3 subtracts, 4 multiplies, 2 adds, 3
// comparisons of absolute values); 20,000 points x 512 boxes a scene is
// ~1.2e8 operations, while the points are 240 KB a scene.
//
// The design: a grid over (chunk of 2,048 points, tile of 32 boxes,
// scene), 256 threads.  A thread holds 8 points in registers (a point past
// P is NaN and counts nothing); the tile's terms sit in shared memory and
// are read as broadcasts.  For each box of the tile a thread counts its 8
// points, the warp sums the counts with one __reduce_add_sync, and lane 0
// adds the sum to the block's count in shared memory.  At the end the
// block adds each nonzero count to the output with one integer atomicAdd a
// (block, box): integer sums do not depend on their order, so the counts
// are the same from run to run.  A chunk of 2,048 points keeps the global
// atomics at B x N x ceil(P / 2,048), ~82,000 at an eval batch of 16.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPointsPerThread = 8;
constexpr int kChunk = kThreads * kPointsPerThread;
constexpr int kTile = 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
    box_count_kernel(const float* __restrict__ points,
                     const float4* __restrict__ terms,
                     int* __restrict__ count, int p, int n, long long sb,
                     long long sp, long long sc) {
  // a box's terms as two float4: (cx, cy, cz, cos) and (sin, hx, hy, hz)
  __shared__ float4 s_terms[kTile][2];
  __shared__ int s_count[kTile];
  const int b = blockIdx.z;
  const int n0 = blockIdx.y * kTile;
  const int tile = min(kTile, n - n0);
  const int tid = threadIdx.x;
  if (tid < 2 * tile)
    s_terms[tid / 2][tid % 2] =
        terms[(static_cast<long long>(b) * n + n0) * 2 + tid];
  if (tid < kTile) s_count[tid] = 0;

  float px[kPointsPerThread], py[kPointsPerThread], pz[kPointsPerThread];
  const float* scene = points + b * sb;
  const long long first = static_cast<long long>(blockIdx.x) * kChunk + tid;
#pragma unroll
  for (int k = 0; k < kPointsPerThread; ++k) {
    const long long i = first + k * kThreads;
    if (i < p) {
      const float* pt = scene + i * sp;
      px[k] = pt[0];
      py[k] = pt[sc];
      pz[k] = pt[2 * sc];
    } else {
      px[k] = py[k] = pz[k] = CUDART_NAN_F;
    }
  }
  __syncthreads();

  const int lane = tid & 31;
  for (int j = 0; j < tile; ++j) {
    const float4 t0 = s_terms[j][0];
    const float4 t1 = s_terms[j][1];
    int inside = 0;
#pragma unroll
    for (int k = 0; k < kPointsPerThread; ++k) {
      const float sx = __fsub_rn(px[k], t0.x);
      const float sy = __fsub_rn(py[k], t0.y);
      const float sz = __fsub_rn(pz[k], t0.z);
      const float lx = __fsub_rn(__fmul_rn(sx, t0.w), __fmul_rn(sy, t1.x));
      const float ly = __fadd_rn(__fmul_rn(sx, t1.x), __fmul_rn(sy, t0.w));
      inside += (fabsf(lx) <= t1.y) & (fabsf(ly) <= t1.z) &
                (fabsf(sz) <= t1.w);
    }
    inside = __reduce_add_sync(kFull, inside);
    if (lane == 0 && inside) atomicAdd(&s_count[j], inside);
  }
  __syncthreads();
  if (tid < tile && s_count[tid])
    atomicAdd(count + static_cast<long long>(b) * n + n0 + tid,
              s_count[tid]);
}

}  // namespace

extern "C" {

// points: (B, P, >=3) float32, the coordinate c of point i of scene b at
// points + b*sb + i*sp + c*sc (element strides); terms: (B, N, 8) float32
// contiguous, 16-byte aligned, a box's (cx, cy, cz, cos, sin, hx, hy, hz);
// count: (B, N) int32, zeroed by the caller: the kernel adds to it.
// Returns cudaErrorInvalidValue for a grid beyond the card's limits.
int demf_box_count(const void* points, const void* terms, void* count, int b,
                   int p, int n, long long sb, long long sp, long long sc,
                   void* stream) {
  if (b <= 0 || p <= 0 || n <= 0) return 0;
  const long long chunks = (static_cast<long long>(p) + kChunk - 1) / kChunk;
  const int tiles = (n + kTile - 1) / kTile;
  if (b > 65535 || tiles > 65535 || chunks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(chunks), tiles, b);
  box_count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const float4*>(terms),
      static_cast<int*>(count), p, n, sb, sp, sc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
