// Class-wise rotated 3D NMS over one IoU matrix a scene, as FCAF3D's
// get_bboxes runs it: keep[b, c, i] for boxes (B, N, 7) (x, y, z_bottom,
// dx, dy, dz, yaw), class scores (B, N, C) and valid (B, N).  Box i takes
// part in class c's sweep when valid[b, i] and score[b, i, c] > score_thr;
// the sweep goes in the stable descending order of that class's scores and
// a kept box suppresses every later box whose IoU with it is above
// iou_thr.  All classes read the same IoU matrix.
//
// Replaces: demf_tpu/models/fcaf3d.py::get_bboxes (:314-327), XLA code:
// core/rotated_iou.py::iou3d_matrix over the top-nms_pre candidates, then
// ops/nms.py::_greedy_suppress once a class (an argsort, an N x N gather
// of the matrix and a fori_loop of N steps, ten times).
//
// What bounds it on the card: not bytes (a scene is 256 boxes of 28 bytes
// and 2,560 scores) but the pair IoUs (a polygon clip of ~600 operations
// and 24 arctangents each, on the SMs' float32 units) and the dependent
// work of each class's sweep, where whether a box survives is known only
// after every kept box before it is applied.
//
// The design, two kernels (measured faster than one launch whose last
// block swept all classes on one SM; PERF.md).
// (1) nms3d_pairs_kernel, a grid of (block, scene): a thread a pair of the
//     scene's upper triangle in row-major order (128 blocks of 256 a scene
//     at N 256: one wave on the card).  Only pairs of two boxes that take
//     part in some class get an IoU (with an IoU matrix asked for, every
//     pair), each pair once: above iou_thr it sets both rows' bits
//     (bits[b, i] holds the boxes that i suppresses; two atomicOr's into a
//     scratch that the call zeroes first) and, when asked, both places of
//     the matrix.  Before the clip, two boxes whose
//     BEV bounding circles are apart by more than a margin that covers the
//     roundings, or whose z-ranges do not overlap, get exactly 0, as the
//     plain arithmetic gives them.  The clip is the plain version's
//     arithmetic (the corners, the 8 corner-inside tests and 16 edge
//     crossings, the centroid, the angles sorted, the shoelace sum; every
//     product and sum rounded on its own with __fmul_rn / __fadd_rn /
//     __fsub_rn / __fdiv_rn, so that nvcc contracts nothing into an FMA
//     that the plain version does not do).  Of the 24 candidate vertices
//     only the valid ones (4 to 8 as a rule) go on, in slot order, into
//     the thread's columns of a scratch in shared memory: their angles,
//     a stable insertion sort by angle (the plain version's stable
//     argsort), the shoelace sum.
// (2) nms3d_sweep_kernel, a block a (class, scene), on as many SMs: the
//     scene's bits into shared memory, the class's order by counting (key = the
//     score's order bits, ties by index, as torch.argsort(stable=True)
//     orders them), then for each box the earlier boxes of its step of 32
//     in that order that suppress it, with the whole block.  Then one warp
//     sweeps, 32 boxes a step: a box is alive when its row meets none of
//     the kept boxes (a mask over the boxes, which is also the class's
//     keep row), and the step's kept boxes are the fixed point of "alive
//     and suppressed by none of them before it", found by a few rounds of
//     ballots from the alive ones.  At N 256 that is 8 steps a class in
//     place of 256 round trips to shared memory.
// The masks equal the plain sweep's fed these IoUs, bit for bit; the IoUs
// agree with iou3d_matrix's to the roundings of cosf / sinf / atan2f and of
// the sums' order (within 1e-6 for distinct boxes).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 24;

__device__ inline float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ inline float add(float a, float b) { return __fadd_rn(a, b); }
__device__ inline float sub(float a, float b) { return __fsub_rn(a, b); }

__host__ __device__ inline int words_of(int n) { return (n + 31) / 32; }

// the pairs (i, j) of a scene, j > i, or j >= i with the diagonal
__host__ __device__ inline long long pairs_of(int n, bool diagonal) {
  return static_cast<long long>(n) * (n + (diagonal ? 1 : -1)) / 2;
}

// blocks a scene: a pair a thread, and one block at least (the ranks and
// the sweep)
__host__ __device__ inline int blocks_of(int n, bool diagonal) {
  const long long p = (pairs_of(n, diagonal) + kThreads - 1) / kThreads;
  return p > 0 ? static_cast<int>(p) : 1;
}

// the CCW BEV corners of a box, as core/rotated_iou.py::_bev_corners_t
__device__ __forceinline__ void corners(const float* box, float* cx,
                                        float* cy) {
  const float c = cosf(box[6]), s = sinf(box[6]);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // the signs (-, -), (+, -), (+, +), (-, +) of the half sides
    const float sx = k == 1 || k == 2 ? 0.5f : -0.5f;
    const float sy = k >= 2 ? 0.5f : -0.5f;
    const float lx = mul(sx, box[3]), ly = mul(sy, box[4]);
    cx[k] = add(add(mul(lx, c), mul(ly, s)), box[0]);
    cy[k] = add(add(mul(-lx, s), mul(ly, c)), box[1]);
  }
}

// point (px, py) left of every edge of the quad (qx, qy), within 1e-9
__device__ __forceinline__ bool inside(float px, float py, const float* qx,
                              const float* qy) {
  bool in = true;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int f = (e + 1) & 3;
    const float ex = sub(qx[f], qx[e]), ey = sub(qy[f], qy[e]);
    const float cr = sub(mul(ex, sub(py, qy[e])), mul(ey, sub(px, qx[e])));
    in = in && cr >= -1e-9f;
  }
  return in;
}

// the BEV intersection area, core/rotated_iou.py::bev_intersection_batched;
// ``vx``, ``vy``, ``va``: this thread's columns of the block's scratch in
// shared memory (kSlots rows of kThreads), where the valid vertices go
__device__ __forceinline__ float bev_intersection(const float* a,
                                                 const float* b, float* vx,
                                                 float* vy, float* va) {
  float ax[4], ay[4], bx[4], by[4];
  corners(a, ax, ay);
  corners(b, bx, by);
  // the valid vertices, as each is found, in slot order (the corners of a
  // inside b, of b inside a, then the 16 edge crossings), and their sum
  int n = 0;
  float sx = 0.f, sy = 0.f;
  auto put = [&](bool ok, float x, float y) {
    if (ok) {
      vx[n * kThreads] = x;
      vy[n * kThreads] = y;
      ++n;
      sx = add(sx, x);
      sy = add(sy, y);
    }
  };
#pragma unroll
  for (int k = 0; k < 4; ++k) put(inside(ax[k], ay[k], bx, by), ax[k], ay[k]);
#pragma unroll
  for (int k = 0; k < 4; ++k) put(inside(bx[k], by[k], ax, ay), bx[k], by[k]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float dax = sub(ax[(i + 1) & 3], ax[i]);
    const float day = sub(ay[(i + 1) & 3], ay[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float dbx = sub(bx[(j + 1) & 3], bx[j]);
      const float dby = sub(by[(j + 1) & 3], by[j]);
      const float rx = sub(ax[i], bx[j]), ry = sub(ay[i], by[j]);
      const float denom = sub(mul(dax, dby), mul(day, dbx));
      const float safe = fabsf(denom) < 1e-12f ? 1e-12f : denom;
      const float t = __fdiv_rn(sub(mul(dbx, ry), mul(dby, rx)), safe);
      const float u = __fdiv_rn(sub(mul(dax, ry), mul(day, rx)), safe);
      put(fabsf(denom) > 1e-12f && t >= 0.f && t <= 1.f && u >= 0.f &&
              u <= 1.f,
          add(ax[i], mul(t, dax)), add(ay[i], mul(t, day)));
    }
  }
  if (n < 3) return 0.f;
  const float nf = static_cast<float>(n);
  const float cenx = __fdiv_rn(sx, nf), ceny = __fdiv_rn(sy, nf);
  // ordered by angle, a stable insertion sort (equal angles keep their
  // slots' order, as the plain version's stable argsort)
  for (int k = 0; k < n; ++k)
    va[k * kThreads] = atan2f(sub(vy[k * kThreads], ceny),
                              sub(vx[k * kThreads], cenx));
  for (int k = 1; k < n; ++k) {
    const float g = va[k * kThreads], x = vx[k * kThreads],
                y = vy[k * kThreads];
    int p = k;
    for (; p > 0 && va[(p - 1) * kThreads] > g; --p) {
      va[p * kThreads] = va[(p - 1) * kThreads];
      vx[p * kThreads] = vx[(p - 1) * kThreads];
      vy[p * kThreads] = vy[(p - 1) * kThreads];
    }
    va[p * kThreads] = g;
    vx[p * kThreads] = x;
    vy[p * kThreads] = y;
  }
  float area = 0.f;
  for (int k = 0; k < n; ++k) {
    const int l = (k + 1 < n ? k + 1 : 0) * kThreads;
    area = add(area, sub(mul(vx[k * kThreads], vy[l]),
                         mul(vx[l], vy[k * kThreads])));
  }
  return mul(0.5f, fabsf(area));
}

// the rotated 3D IoU, with the cull: exactly 0 where the plain arithmetic
// gives exactly 0 for certain (boxes within 1e15 m and of 1e15 m, so that
// the intersection is finite and 0 times it is 0), the whole clip
// otherwise
__device__ __forceinline__ float iou3d(const float* a, const float* b,
                                       float* scratch) {
  const float zmin = fmaxf(a[2], b[2]);
  const float zmax = fminf(add(a[2], a[5]), add(b[2], b[5]));
  const float zover = sub(zmax, zmin);
  bool tame = true;
#pragma unroll
  for (int d = 0; d < 7; ++d)
    tame = tame && isfinite(a[d]) && isfinite(b[d]);
  // the bounding circles' radii, and a margin far above the corners'
  // roundings and the inside test's 1e-9 over an edge of at least 1 mm
  const float ra = 0.5f * sqrtf(a[3] * a[3] + a[4] * a[4]);
  const float rb = 0.5f * sqrtf(b[3] * b[3] + b[4] * b[4]);
  const float reach0 = fabsf(a[0]) + fabsf(a[1]) + fabsf(b[0]) +
                       fabsf(b[1]) + ra + rb;
  tame = tame && reach0 < 1e15f;
  const float ddx = a[0] - b[0], ddy = a[1] - b[1];
  const float reach = ra + rb + 1e-4f * (1.f + reach0);
  const bool sized = fminf(fminf(a[3], a[4]), fminf(b[3], b[4])) >= 1e-3f;
  if (tame && (zover <= 0.f ||
               (sized && ddx * ddx + ddy * ddy > reach * reach)))
    return 0.f;
  const float inter2d = bev_intersection(
      a, b, scratch, scratch + kSlots * kThreads,
      scratch + 2 * kSlots * kThreads);
  const float inter = mul(inter2d, fmaxf(zover, 0.f));
  const float vol1 = mul(mul(a[3], a[4]), a[5]);
  const float vol2 = mul(mul(b[3], b[4]), b[5]);
  return __fdiv_rn(inter, fmaxf(sub(add(vol1, vol2), inter), 1e-7f));
}

// A key's bits mapped so that unsigned order is the floats' order, -0
// with +0; a box that takes no part gets 0, below every box that does
// (whose score is above score_thr, so neither NaN nor -inf).
__device__ inline unsigned ordered_bits(float key) {
  const unsigned u = __float_as_uint(key == 0.f ? 0.f : key);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// (1) the pair IoUs of a scene's boxes that take part in some class, into
// both rows' bits above iou_thr (and, when asked, every pair's IoU)
__global__ void __launch_bounds__(kThreads, 2)
    nms3d_pairs_kernel(const float* __restrict__ boxes,
                       const float* __restrict__ scores,
                       const unsigned char* __restrict__ valid,
                       float* __restrict__ iou, unsigned* __restrict__ bits,
                       int n, int classes, float iou_thr, float score_thr) {
  // the vertices' scratch (3 x kSlots rows of kThreads floats), then which
  // boxes take part
  extern __shared__ __align__(8) unsigned char smem[];
  float* s_vertices = reinterpret_cast<float*>(smem);
  unsigned char* s_part =
      reinterpret_cast<unsigned char*>(s_vertices + 3 * kSlots * kThreads);
  const int w = words_of(n);
  const int scene = blockIdx.y;
  boxes += static_cast<size_t>(scene) * n * 7;
  scores += static_cast<size_t>(scene) * n * classes;
  valid += static_cast<size_t>(scene) * n;
  bits += static_cast<size_t>(scene) * n * w;
  if (iou) iou += static_cast<size_t>(scene) * n * n;

  // which boxes take part in some class (valid, a score above score_thr;
  // NaN never is), read once, coalesced
  for (int i = threadIdx.x; i < n; i += kThreads) s_part[i] = 0;
  __syncthreads();
#pragma unroll 16
  for (int e = threadIdx.x; e < n * classes; e += kThreads) {
    const int i = e / classes;
    if (valid[i] && scores[e] > score_thr) s_part[i] = 1;
  }
  __syncthreads();
  // this thread's pair: the pairs in row-major order, row i holding
  // j = i + skip .. n - 1 (skip 0 with the diagonal, else 1)
  const int skip = iou ? 0 : 1;
  const long long pair =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (pair >= pairs_of(n, iou != nullptr)) return;
  // the row: the largest i whose first pair is at or before ``pair``
  const double m = 2.0 * (n - skip) + 1.0;
  int i = static_cast<int>((m - sqrt(m * m - 8.0 * pair)) / 2.0);
  auto first = [&](long long r) { return r * (n - skip) - r * (r - 1) / 2; };
  while (i > 0 && first(i) > pair) --i;
  while (first(i + 1) <= pair) ++i;
  const int j = i + skip + static_cast<int>(pair - first(i));
  const bool part = s_part[i] && s_part[j];
  if (!iou && !part) return;
  float a[7], c[7];
#pragma unroll
  for (int d = 0; d < 7; ++d) {
    a[d] = boxes[static_cast<size_t>(i) * 7 + d];
    c[d] = boxes[static_cast<size_t>(j) * 7 + d];
  }
  const float v = iou3d(a, c, s_vertices + threadIdx.x);
  if (iou) {
    iou[static_cast<size_t>(i) * n + j] = v;
    iou[static_cast<size_t>(j) * n + i] = v;
  }
  if (part && j > i && v > iou_thr) {
    atomicOr(&bits[static_cast<size_t>(i) * w + (j >> 5)], 1u << (j & 31));
    atomicOr(&bits[static_cast<size_t>(j) * w + (i >> 5)], 1u << (i & 31));
  }
}

// (2) one class of one scene: its order, the masks of its steps, the sweep
__global__ void __launch_bounds__(kThreads)
    nms3d_sweep_kernel(const float* __restrict__ scores,
                       const unsigned char* __restrict__ valid,
                       const unsigned* __restrict__ bits,
                       unsigned char* __restrict__ keep, int n, int classes,
                       float score_thr) {
  extern __shared__ __align__(8) unsigned char smem[];
  __shared__ int s_count;
  const int w = words_of(n), ws = w | 1;
  const int cls = blockIdx.x, scene = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  scores += static_cast<size_t>(scene) * n * classes;
  valid += static_cast<size_t>(scene) * n;
  bits += static_cast<size_t>(scene) * n * w;
  keep += (static_cast<size_t>(scene) * classes + cls) * n;
  // the bits at an odd stride (a warp reading the rows of 32 boxes meets
  // no bank twice), the class keys (later each place's mask), the order,
  // the kept mask over the boxes (also the class's keep row)
  unsigned* s_bits = reinterpret_cast<unsigned*>(smem);
  unsigned* s_key = s_bits + static_cast<size_t>(n) * ws;
  int* s_order = reinterpret_cast<int*>(s_key + n);
  unsigned* s_kept = reinterpret_cast<unsigned*>(s_order + n);
  if (threadIdx.x == 0) s_count = 0;
  for (int e = threadIdx.x; e < w; e += kThreads) s_kept[e] = 0u;
#pragma unroll 8
  for (int e = threadIdx.x; e < n * w; e += kThreads)
    s_bits[(e / w) * ws + e % w] = __ldcg(bits + e);
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float sc = scores[static_cast<size_t>(i) * classes + cls];
    s_key[i] = valid[i] && sc > score_thr ? ordered_bits(sc) : 0u;
  }
  __syncthreads();
  // each box's place in the class's order by counting the boxes before
  // it (ties by index, as torch.argsort(stable=True) orders them)
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const unsigned mine = s_key[i];
    if (!mine) continue;
    atomicAdd(&s_count, 1);
    int before = 0;
#pragma unroll 16
    for (int j = 0; j < n; ++j) {
      const unsigned other = s_key[j];
      before += other > mine || (other == mine && j < i);
    }
    s_order[before] = i;
  }
  __syncthreads();
  const int p = s_count;
  // the earlier boxes of its step of 32 that suppress each box (over the
  // keys, no longer needed): bit k of place r is box k of the step before
  // it, read from that box's row (IoU is symmetric), so a warp reads one
  // row at a time
  unsigned* s_sup = s_key;
  for (int r = threadIdx.x; r < p; r += kThreads) {
    const int box = s_order[r], base = r & ~31, last = min(base + 31, p - 1);
    unsigned sup = 0u;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int other = s_order[min(base + k, last)];
      const unsigned hit =
          (s_bits[other * ws + (box >> 5)] >> (box & 31)) & 1u;
      sup |= (base + k < r ? hit : 0u) << k;
    }
    s_sup[r] = sup;
  }
  __syncthreads();
  // the sweep, 32 boxes of the order a step: a box is alive when its row
  // meets no kept box; the step's kept boxes are the fixed point of "alive
  // and suppressed by none of them before it", found by iterating from the
  // alive ones (each round settles one more box at least, so it ends, and
  // the dependencies run one way, so the fixed point is the greedy one);
  // then they join the kept mask
  if (warp == 0) {
    for (int base = 0; base < p; base += 32) {
      const bool in = base + lane < p;
      const int box = in ? s_order[base + lane] : 0;
      const unsigned sup = in ? s_sup[base + lane] : 0u;
      const unsigned* row = s_bits + static_cast<size_t>(box) * ws;
      unsigned met = 0u;
#pragma unroll 8
      for (int q = 0; q < w; ++q) met |= row[q] & s_kept[q];
      const bool alive = in && !met;
      unsigned live = __ballot_sync(kFull, alive);
      for (;;) {
        const unsigned next = __ballot_sync(kFull, alive && !(sup & live));
        if (next == live) break;
        live = next;
      }
      const bool kept = (live >> lane) & 1u;
#pragma unroll 8
      for (int q = 0; q < w; ++q) {
        const unsigned add = __reduce_or_sync(
            kFull, kept && (box >> 5) == q ? 1u << (box & 31) : 0u);
        if (lane == 0) s_kept[q] |= add;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < n; x += kThreads)
    keep[x] = (s_kept[x >> 5] >> (x & 31)) & 1u;
}

// the shared memory of a pairs block: the vertices' scratch, the flags
__host__ inline size_t pairs_shared_bytes(int n) {
  return 4 * 3 * kSlots * kThreads + static_cast<size_t>(n);
}

// the shared memory of a sweep block: the bits (rows at an odd stride),
// the keys and later the masks, the order, the kept mask
__host__ inline size_t sweep_shared_bytes(int n) {
  const size_t w = words_of(n);
  return 4 * (static_cast<size_t>(n) * (w | 1) + 2 * static_cast<size_t>(n) +
              w);
}

// a kernel's dynamic shared memory on the current device, raised only
// when a call needs more than the largest set so far (the attribute is a
// driver call); ``allowed`` holds that a device
constexpr int kMaxDevices = 64;
size_t pairs_allowed[kMaxDevices], sweep_allowed[kMaxDevices];

cudaError_t allow_shared(const void* kernel, size_t bytes, size_t* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = bytes;
  return err;
}

}  // namespace

extern "C" {

// boxes (B, N, 7) f32; scores (B, N, C) f32; valid (B, N) bool; iou (B, N,
// N) f32, written whole, or null (no matrix); bits (B, N, ceil(N / 32))
// u32, scratch that the call zeroes on its stream before the pairs;
// keep (B, C, N) bool, every element written.
int demf_nms3d_rotated(const void* boxes, const void* scores,
                       const void* valid, void* iou, void* bits, void* keep,
                       int b, int n, int classes, float iou_thr,
                       float score_thr, void* stream) {
  if (b == 0 || n == 0 || classes == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool diagonal = iou != nullptr;
  cudaError_t err = cudaMemsetAsync(
      bits, 0, sizeof(unsigned) * b * static_cast<size_t>(n) * words_of(n), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (pairs_of(n, diagonal) > 0) {
    const size_t bytes = pairs_shared_bytes(n);
    err = allow_shared(
        reinterpret_cast<const void*>(nms3d_pairs_kernel), bytes,
        pairs_allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    nms3d_pairs_kernel<<<dim3(blocks_of(n, diagonal), b), kThreads, bytes,
                         s>>>(
        static_cast<const float*>(boxes), static_cast<const float*>(scores),
        static_cast<const unsigned char*>(valid), static_cast<float*>(iou),
        static_cast<unsigned*>(bits), n, classes, iou_thr, score_thr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t bytes = sweep_shared_bytes(n);
  err = allow_shared(
      reinterpret_cast<const void*>(nms3d_sweep_kernel), bytes,
      sweep_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  nms3d_sweep_kernel<<<dim3(classes, b), kThreads, bytes, s>>>(
      static_cast<const float*>(scores),
      static_cast<const unsigned char*>(valid),
      static_cast<const unsigned*>(bits), static_cast<unsigned char*>(keep),
      n, classes, score_thr);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
