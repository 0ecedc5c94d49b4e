// The vote heads' vote targets: for each point of each scene, the offsets
// to the gravity centers of the GT boxes that hold it, and its mask.
//
// Replaces: the XLA computation of demf_tpu/models/target_assign.py:30
// _vote_targets_single (vmapped at :126 and at demf_tpu/models/
// vote_head.py:271): points_in_boxes & gt_valid as a (P, G) mask, an int
// cumsum over it for each point's earlier hits, an argmax a slot, a take
// of the centers at each slot and the where / multiply after it.  The
// port's plain version (ops/vote_targets.py::vote_targets_plain) is the
// same chain in torch.
//
// What it computes, as the chain's expressions give it, for each point and
// gt_per_seed (S) slots, with hits counted in box order over the boxes
// that are valid and hold the point:
// - slot 0: the first hit's center - the point (box 0's center - the
//   point when there is none: the first vote);
// - slot k, 1 <= k < S - 1: the hit with k earlier hits, slot S - 1
//   (S > 1) the last hit with >= S - 1 earlier hits: its center - the
//   point, the first vote where the slot has no hit;
// - every slot times has1 (1 where the point has a hit, else 0: a NaN
//   stays NaN and -0 * 1 stays -0, as the chain's multiply keeps them);
// - the mask: has1 as int32.
// A point is inside a box by the test of core/boxes.py::points_in_boxes
// (csrc/box_count.cu's inside_box: the terms with box_terms' roundings,
// __fsub_rn / __fmul_rn / __fadd_rn in the plain version's order, so nvcc
// contracts nothing into an FMA; the yaw's cosine and sine by cosf and
// sinf, torch.cos's and torch.sin's bits on the card); a NaN point or box
// holds nothing.  The centers are core/boxes.py::gravity_center's, z +
// h * 0.5.  Points are read through their element strides (the model's
// (B, P, 4) clouds need no copy).
//
// What bounds it on the card: the (point, valid box) tests, ~12 float32
// operations each, at the rate their exact roundings allow (no FMA: half
// of 67 TFLOP/s), or the bytes: the points' coordinates read and the
// targets and masks written once.
//
// The design: one launch.  A block 512 points of one scene, 128 threads of
// 4 points each.  The block first compacts the scene's valid boxes into
// shared memory in box order (a ballot a warp), each as two float4 of its
// terms (center x, y, z and cos; sin and the three half sizes + eps), so
// the walk skips invalid boxes and reads a box with two 16-byte broadcast
// loads that serve the thread's 4 points.  A hit writes its box's place
// into the point's slot in shared memory (hits are few); after the walk
// each thread forms its points' targets from the slots' centers into a
// shared stage, and the block writes the stage out with coalesced stores.
// The (P, G) mask, its cumsum and the slots never reach device memory.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kPoints = 4;                       // points a thread
constexpr int kBlockPoints = kThreads * kPoints;
constexpr int kMaxSlots = 8;
constexpr int kMaxBoxes = 1024;
constexpr int kDefaultSmem = 48 * 1024;

size_t smem_bytes(int g, int s) {
  return sizeof(float4) * 2 * (g + 1) +
         sizeof(int) * kBlockPoints * s + sizeof(float) * kBlockPoints * 3 * s;
}

__global__ void __launch_bounds__(kThreads)
    vote_targets_kernel(const float* __restrict__ points,
                        const float* __restrict__ boxes,
                        const bool* __restrict__ gt_valid,
                        float* __restrict__ targets, int* __restrict__ masks,
                        int p, int g, int s, long long sb, long long sp,
                        long long sc, float eps) {
  // the valid boxes' terms, two float4 each, in box order; box 0's center
  // at 2 * g (the first vote of a point without a hit)
  extern __shared__ float4 box[];
  int* slot = reinterpret_cast<int*>(box + 2 * (g + 1));
  float* stage = reinterpret_cast<float*>(slot + kBlockPoints * s);
  __shared__ int warp_boxes[kThreads / 32];
  const int b = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float* scene = boxes + static_cast<long long>(b) * g * 7;
  int valid = 0;
  for (int j0 = 0; j0 < g; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    const bool v = j < g && gt_valid[static_cast<long long>(b) * g + j];
    const unsigned ballot = __ballot_sync(0xffffffffu, v);
    if (lane == 0) warp_boxes[warp] = __popc(ballot);
    __syncthreads();
    int at = valid + __popc(ballot & ((1u << lane) - 1));
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      at += w < warp ? warp_boxes[w] : 0;
      valid += warp_boxes[w];
    }
    if (v) {
      const float* bx = scene + j * 7;
      const float half_z = __fmul_rn(bx[5], 0.5f);
      box[2 * at] = make_float4(bx[0], bx[1], __fadd_rn(bx[2], half_z),
                                cosf(bx[6]));
      box[2 * at + 1] = make_float4(
          sinf(bx[6]), __fadd_rn(__fmul_rn(bx[3], 0.5f), eps),
          __fadd_rn(__fmul_rn(bx[4], 0.5f), eps), __fadd_rn(half_z, eps));
    }
    __syncthreads();                     // warp_boxes is read before reuse
  }
  if (threadIdx.x == 0)
    box[2 * g] = make_float4(scene[0], scene[1],
                             __fadd_rn(scene[2], __fmul_rn(scene[5], 0.5f)),
                             0.0f);
  const int p0 = blockIdx.x * kBlockPoints;
  float x[kPoints], y[kPoints], z[kPoints];
  int hits[kPoints];
#pragma unroll
  for (int i = 0; i < kPoints; ++i) {
    const int q = p0 + threadIdx.x + i * kThreads;
    x[i] = y[i] = z[i] = CUDART_NAN_F;
    if (q < p) {
      const float* pt = points + b * sb + q * sp;
      x[i] = pt[0], y[i] = pt[sc], z[i] = pt[2 * sc];
    }
    hits[i] = 0;
  }
  __syncthreads();
  for (int j = 0; j < valid; ++j) {
    const float4 t0 = box[2 * j], t1 = box[2 * j + 1];
#pragma unroll
    for (int i = 0; i < kPoints; ++i) {
      const float sx = __fsub_rn(x[i], t0.x);
      const float sy = __fsub_rn(y[i], t0.y);
      const float sz = __fsub_rn(z[i], t0.z);
      const float lx = __fsub_rn(__fmul_rn(sx, t0.w), __fmul_rn(sy, t1.x));
      const float ly = __fadd_rn(__fmul_rn(sx, t1.x), __fmul_rn(sy, t0.w));
      if ((fabsf(lx) <= t1.y) & (fabsf(ly) <= t1.z) & (fabsf(sz) <= t1.w)) {
        // slot 0 the first hit; then the k-th, the last slot overwritten
        const int n = hits[i];
        if (n == 0 || s > 1)
          slot[(threadIdx.x + i * kThreads) * s + min(n, s - 1)] = j;
        hits[i] = n + 1;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPoints; ++i) {
    const int local = threadIdx.x + i * kThreads;
    if (p0 + local < p) {
      const int n = hits[i];
      const float px = x[i], py = y[i], pz = z[i];
      const float has1 = n > 0 ? 1.0f : 0.0f;
      const float4 c0 = box[2 * (n > 0 ? slot[local * s] : g)];
      const float fx = __fsub_rn(c0.x, px), fy = __fsub_rn(c0.y, py),
                  fz = __fsub_rn(c0.z, pz);
      float* out = stage + local * 3 * s;
      for (int k = 0; k < s; ++k) {
        float vx = fx, vy = fy, vz = fz;
        if (k > 0 && n > k) {
          const float4 c = box[2 * slot[local * s + k]];
          vx = __fsub_rn(c.x, px);
          vy = __fsub_rn(c.y, py);
          vz = __fsub_rn(c.z, pz);
        }
        out[3 * k] = __fmul_rn(vx, has1);
        out[3 * k + 1] = __fmul_rn(vy, has1);
        out[3 * k + 2] = __fmul_rn(vz, has1);
      }
      masks[static_cast<long long>(b) * p + p0 + local] = n > 0;
    }
  }
  __syncthreads();
  const int values = min(kBlockPoints, p - p0) * 3 * s;
  float* dst = targets + (static_cast<long long>(b) * p + p0) * 3 * s;
  for (int e = threadIdx.x; e < values; e += kThreads) dst[e] = stage[e];
}

}  // namespace

extern "C" {

// points: float32 (B, P, >=3) read through element strides (sb, sp, sc);
// boxes: float32 (B, G, 7) bottom-center, contiguous; gt_valid: bool (B,
// G); targets: float32 (B, P, 3 * S); masks: int32 (B, P).  G 1 to 1,024,
// S 1 to 8, B <= 65,535.
int demf_vote_targets(const void* points, const void* boxes,
                      const void* gt_valid, void* targets, void* masks, int b,
                      int p, int g, int s, long long sb, long long sp,
                      long long sc, float eps, void* stream) {
  if (g < 1 || g > kMaxBoxes || s < 1 || s > kMaxSlots || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || p == 0) return 0;
  const size_t smem = smem_bytes(g, s);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        vote_targets_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((p + kBlockPoints - 1) / kBlockPoints, b);
  vote_targets_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const float*>(boxes),
      static_cast<const bool*>(gt_valid), static_cast<float*>(targets),
      static_cast<int*>(masks), p, g, s, sb, sp, sc, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
