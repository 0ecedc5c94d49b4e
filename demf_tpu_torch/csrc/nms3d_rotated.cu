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
// and 2,560 scores) and not the pair IoUs (65,536 a scene, ~600
// operations each) but dependent work: each class's sweep, where whether
// a box survives is known only after every kept box before it is applied.
//
// The design, two kernels.  (1) A warp a (scene, row i, 32 columns): each
// lane computes one pair's IoU in the plain version's arithmetic (the
// corners, the 8 corner-inside tests and 16 edge crossings, the centroid,
// the angles sorted, the shoelace sum; every product and sum rounded on
// its own with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, so that nvcc
// contracts nothing into an FMA that the plain version does not do), writes
// it to the IoU matrix and votes iou > iou_thr into the row's bit word:
// bits[b, i] holds the boxes that i would suppress, in the boxes' own
// order.  (2) A block a (scene, class): the scene's bits into shared
// memory; every box finds its place in the class's order by counting the
// boxes before it (key = score or -inf when it takes no part, ties by
// index, as torch.argsort(stable=True) orders them); then one warp sweeps
// the order, a box whose removed bit is clear is kept and ORs its row
// into the removed mask, a word a lane.  Removing a box that was already
// decided changes nothing, so the rows need no reordering.  The IoUs agree
// with iou3d_matrix's to the roundings of cosf / sinf / atan2f and of the
// sums' order (within 1e-6); the masks equal the plain sweep's fed these
// IoUs, bit for bit.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kIouThreads = 256;
constexpr int kSweepThreads = 256;

__device__ inline float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ inline float add(float a, float b) { return __fadd_rn(a, b); }
__device__ inline float sub(float a, float b) { return __fsub_rn(a, b); }

__host__ __device__ inline int words_of(int n) { return (n + 31) / 32; }

// the CCW BEV corners of a box, as core/rotated_iou.py::_bev_corners_t
__device__ inline void corners(const float* box, float* cx, float* cy) {
  const float sx[4] = {-0.5f, 0.5f, 0.5f, -0.5f};
  const float sy[4] = {-0.5f, -0.5f, 0.5f, 0.5f};
  const float c = cosf(box[6]), s = sinf(box[6]);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float lx = mul(sx[k], box[3]), ly = mul(sy[k], box[4]);
    cx[k] = add(add(mul(lx, c), mul(ly, s)), box[0]);
    cy[k] = add(add(mul(-lx, s), mul(ly, c)), box[1]);
  }
}

// point (px, py) left of every edge of the quad (qx, qy), within 1e-9
__device__ inline bool inside(float px, float py, const float* qx,
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

// the BEV intersection area, core/rotated_iou.py::bev_intersection_batched
__device__ float bev_intersection(const float* a, const float* b) {
  float ax[4], ay[4], bx[4], by[4];
  corners(a, ax, ay);
  corners(b, bx, by);
  float cx[24], cy[24];
  bool ok[24];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    cx[k] = ax[k];
    cy[k] = ay[k];
    ok[k] = inside(ax[k], ay[k], bx, by);
    cx[4 + k] = bx[k];
    cy[4 + k] = by[k];
    ok[4 + k] = inside(bx[k], by[k], ax, ay);
  }
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
      const int k = 8 + i * 4 + j;
      ok[k] = fabsf(denom) > 1e-12f && t >= 0.f && t <= 1.f && u >= 0.f &&
              u <= 1.f;
      cx[k] = add(ax[i], mul(t, dax));
      cy[k] = add(ay[i], mul(t, day));
    }
  }
  int n = 0;
  float sx = 0.f, sy = 0.f;
#pragma unroll
  for (int k = 0; k < 24; ++k) {
    if (ok[k]) {
      ++n;
      sx = add(sx, cx[k]);
      sy = add(sy, cy[k]);
    }
  }
  if (n < 3) return 0.f;
  const float nf = static_cast<float>(n);
  const float cenx = __fdiv_rn(sx, nf), ceny = __fdiv_rn(sy, nf);
  // the valid vertices by angle (insertion sort; equal angles keep their
  // slots' order, as the stable sort does)
  float ang[24], vx[24], vy[24];
  int m = 0;
  for (int k = 0; k < 24; ++k) {
    if (!ok[k]) continue;
    const float g = atan2f(sub(cy[k], ceny), sub(cx[k], cenx));
    int p = m++;
    while (p > 0 && ang[p - 1] > g) {
      ang[p] = ang[p - 1];
      vx[p] = vx[p - 1];
      vy[p] = vy[p - 1];
      --p;
    }
    ang[p] = g;
    vx[p] = cx[k];
    vy[p] = cy[k];
  }
  float area = 0.f;
  for (int k = 0; k < m; ++k) {
    const int l = k + 1 < m ? k + 1 : 0;
    area = add(area, sub(mul(vx[k], vy[l]), mul(vx[l], vy[k])));
  }
  return mul(0.5f, fabsf(area));
}

__device__ float iou3d(const float* a, const float* b) {
  const float inter2d = bev_intersection(a, b);
  const float zmin = fmaxf(a[2], b[2]);
  const float zmax = fminf(add(a[2], a[5]), add(b[2], b[5]));
  const float inter = mul(inter2d, fmaxf(sub(zmax, zmin), 0.f));
  const float vol1 = mul(mul(a[3], a[4]), a[5]);
  const float vol2 = mul(mul(b[3], b[4]), b[5]);
  return __fdiv_rn(inter, fmaxf(sub(add(vol1, vol2), inter), 1e-7f));
}

__global__ void __launch_bounds__(kIouThreads)
    rotated_iou_kernel(const float* __restrict__ boxes, float* __restrict__ iou,
                       unsigned* __restrict__ bits, int b, int n,
                       float iou_thr) {
  const int w = words_of(n);
  const long long warp_id =
      (static_cast<long long>(blockIdx.x) * kIouThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp_id >= static_cast<long long>(b) * n * w) return;
  const int word = static_cast<int>(warp_id % w);
  const long long row = warp_id / w;          // scene * n + i
  const int scene = static_cast<int>(row / n);
  const int j = word * 32 + lane;
  bool above = false;
  if (j < n) {
    float a[7], c[7];
    const float* pa = boxes + row * 7;
    const float* pc = boxes + (static_cast<long long>(scene) * n + j) * 7;
#pragma unroll
    for (int d = 0; d < 7; ++d) {
      a[d] = pa[d];
      c[d] = pc[d];
    }
    const float v = iou3d(a, c);
    iou[row * n + j] = v;
    above = v > iou_thr;
  }
  const unsigned vote = __ballot_sync(kFull, above);
  if (lane == 0) bits[row * w + word] = vote;
}

// A key's bits mapped so that unsigned order is the floats' order, -0
// with +0 and NaN below -inf (a NaN score never takes part, since
// NaN > score_thr is false, so its key is -inf).
__device__ inline unsigned ordered_bits(float key) {
  if (key != key) return 0;
  const unsigned u = __float_as_uint(key == 0.f ? 0.f : key);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(kSweepThreads)
    classwise_sweep_kernel(const unsigned* __restrict__ bits,
                           const float* __restrict__ scores,
                           const unsigned char* __restrict__ valid,
                           unsigned char* __restrict__ keep, int n,
                           int classes, float score_thr) {
  extern __shared__ __align__(8) unsigned char smem[];
  const int w = words_of(n);
  unsigned* s_bits = reinterpret_cast<unsigned*>(smem);
  unsigned* s_key = s_bits + static_cast<size_t>(n) * w;
  int* s_order = reinterpret_cast<int*>(s_key + n);
  unsigned* s_removed = reinterpret_cast<unsigned*>(s_order + n);
  unsigned char* s_kept = reinterpret_cast<unsigned char*>(s_removed + w);

  const int cls = blockIdx.x, scene = blockIdx.y;
  bits += static_cast<size_t>(scene) * n * w;
  scores += static_cast<size_t>(scene) * n * classes;
  valid += static_cast<size_t>(scene) * n;
  keep += (static_cast<size_t>(scene) * classes + cls) * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int e = threadIdx.x; e < n * w; e += kSweepThreads) s_bits[e] = bits[e];
  for (int e = threadIdx.x; e < w; e += kSweepThreads) s_removed[e] = 0u;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kSweepThreads) {
    const float sc = scores[static_cast<size_t>(i) * classes + cls];
    const bool part = valid[i] && sc > score_thr;
    s_key[i] = ordered_bits(part ? sc : -CUDART_INF_F);
    if (!part) atomicOr(&s_removed[i >> 5], 1u << (i & 31));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kSweepThreads) {
    const unsigned mine = s_key[i];
    int p = 0;  // the boxes before box i
    for (int j = 0; j < n; ++j) {
      const unsigned other = s_key[j];
      p += other > mine || (other == mine && j < i);
    }
    s_order[p] = i;
  }
  __syncthreads();
  if (warp == 0) {
    for (int r = 0; r < n; ++r) {
      const int i = s_order[r];
      const bool kept = !((s_removed[i >> 5] >> (i & 31)) & 1u);
      __syncwarp();
      if (kept) {
        for (int word = lane; word < w; word += 32)
          s_removed[word] |= s_bits[static_cast<size_t>(i) * w + word];
      }
      if (lane == 0) s_kept[i] = kept;
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kSweepThreads) keep[i] = s_kept[i];
}

__host__ inline size_t sweep_shared_bytes(int n) {
  const size_t w = words_of(n);
  return 4 * (static_cast<size_t>(n) * w + 2 * static_cast<size_t>(n) + w) +
         static_cast<size_t>(n);
}

}  // namespace

extern "C" {

// boxes (B, N, 7) f32; scores (B, N, C) f32; valid (B, N) bool; iou (B, N,
// N) f32 and bits (B, N, ceil(N / 32)) u32, scratch that this call writes
// whole; keep (B, C, N) bool, every element written.
int demf_nms3d_rotated(const void* boxes, const void* scores,
                       const void* valid, void* iou, void* bits, void* keep,
                       int b, int n, int classes, float iou_thr,
                       float score_thr, void* stream) {
  if (b == 0 || n == 0 || classes == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long warps = static_cast<long long>(b) * n * words_of(n);
  const long long blocks = (warps * 32 + kIouThreads - 1) / kIouThreads;
  rotated_iou_kernel<<<static_cast<unsigned>(blocks), kIouThreads, 0, s>>>(
      static_cast<const float*>(boxes), static_cast<float*>(iou),
      static_cast<unsigned*>(bits), b, n, iou_thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = sweep_shared_bytes(n);
  err = cudaFuncSetAttribute(classwise_sweep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  classwise_sweep_kernel<<<dim3(classes, b), kSweepThreads, bytes, s>>>(
      static_cast<const unsigned*>(bits), static_cast<const float*>(scores),
      static_cast<const unsigned char*>(valid),
      static_cast<unsigned char*>(keep), n, classes, score_thr);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
