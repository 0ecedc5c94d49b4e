// The vote targets' in-box slots: for each point of each scene, the GT
// boxes that hold it, as the indices the vote targets read.
//
// Replaces: the XLA computation of demf_tpu/models/target_assign.py:30
// _vote_targets_single (vmapped at :126 and at demf_tpu/models/
// vote_head.py:271): points_in_boxes & gt_valid as a (P, G) mask, an int
// cumsum over it for each point's earlier hits, and an argmax a slot.  The
// port's plain version (ops/vote_slots.py::vote_slots_plain) is the same
// chain in torch, a (B, P, G) mask and an int64 cumsum.
//
// What it computes, as the chain's expressions give it, for each point and
// gt_per_seed (S) slots, with hits counted in box order over the boxes
// that are valid and hold the point:
// - slot 0: the first hit (0 when none);
// - slot k, 1 <= k < S - 1: the hit with k earlier hits (0 when none);
// - slot S - 1 (S > 1): the last hit with >= S - 1 earlier hits (G - 1
//   when none: the chain's (G - 1) - argmax of the flipped mask);
// - has[k]: the point has more than k hits.
// A point is inside a box by the test of core/boxes.py::points_in_boxes
// (csrc/box_count.cu's inside_box: the terms with box_terms' roundings,
// cos and sin of the yaw from torch, __fsub_rn / __fmul_rn / __fadd_rn in
// the plain version's order, so nvcc contracts nothing into an FMA); a NaN
// point or box holds nothing.  Points are read through their element
// strides (the model's (B, P, 4) clouds need no copy).
//
// What bounds it on the card: bytes and operations alike.  A DeMF-VoteNet
// train step's call (16 scenes of 20,000 points, 64 GT slots, S = 3) reads
// 3.84 MB of points and writes 3.84 MB of slots and 0.96 MB of flags, ~2.6
// us at 3.35 TB/s; it tests 20.5 million (point, box) pairs of ~12
// operations, ~3.7 us at 67 TFLOP/s.
//
// The design: a block 256 points of one scene, the scene's box terms in
// shared memory (each block computes them: G x 8 floats, 32 KB at most),
// a thread a point walking the boxes in order with its counts in
// registers, so the (P, G) mask and its cumsum are never stored.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlots = 8;
constexpr int kMaxBoxes = 1024;

__global__ void __launch_bounds__(kThreads)
    vote_slots_kernel(const float* __restrict__ points,
                      const float* __restrict__ boxes,
                      const float* __restrict__ cos_yaw,
                      const float* __restrict__ sin_yaw,
                      const bool* __restrict__ gt_valid,
                      int* __restrict__ slots, bool* __restrict__ has, int p,
                      int g, int s, long long sb, long long sp, long long sc,
                      float eps) {
  // cx, cy, cz, cos, sin, hx, hy, hz of each box; hx is NaN for an invalid
  // box, which then holds no point
  extern __shared__ float terms[];
  const int b = blockIdx.y;
  for (int j = threadIdx.x; j < g; j += blockDim.x) {
    const long long at = static_cast<long long>(b) * g + j;
    const float* bx = boxes + at * 7;
    const float half_z = __fmul_rn(bx[5], 0.5f);
    float* t = terms + j * 8;
    t[0] = bx[0];
    t[1] = bx[1];
    t[2] = __fadd_rn(bx[2], half_z);
    t[3] = cos_yaw[at];
    t[4] = sin_yaw[at];
    t[5] = gt_valid[at] ? __fadd_rn(__fmul_rn(bx[3], 0.5f), eps)
                        : CUDART_NAN_F;
    t[6] = __fadd_rn(__fmul_rn(bx[4], 0.5f), eps);
    t[7] = __fadd_rn(half_z, eps);
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const float* pt = points + b * sb + i * sp;
  const float x = pt[0], y = pt[sc], z = pt[2 * sc];
  int count = 0, first = 0, last = g - 1;
  int mid[kMaxSlots];
#pragma unroll
  for (int k = 0; k < kMaxSlots; ++k) mid[k] = 0;
  for (int j = 0; j < g; ++j) {
    const float* t = terms + j * 8;
    const float sx = __fsub_rn(x, t[0]);
    const float sy = __fsub_rn(y, t[1]);
    const float sz = __fsub_rn(z, t[2]);
    const float lx = __fsub_rn(__fmul_rn(sx, t[3]), __fmul_rn(sy, t[4]));
    const float ly = __fadd_rn(__fmul_rn(sx, t[4]), __fmul_rn(sy, t[3]));
    if (!((fabsf(lx) <= t[5]) & (fabsf(ly) <= t[6]) & (fabsf(sz) <= t[7])))
      continue;
    if (count == 0) {
      first = j;
    } else if (count < s - 1) {
#pragma unroll
      for (int k = 1; k < kMaxSlots; ++k)
        if (k == count) mid[k] = j;
    } else {
      last = j;
    }
    ++count;
  }
  const long long at = (static_cast<long long>(b) * p + i) * s;
#pragma unroll
  for (int k = 0; k < kMaxSlots; ++k) {
    if (k >= s) break;
    slots[at + k] = k == 0 ? first : (k < s - 1 ? mid[k] : last);
    has[at + k] = count > k;
  }
}

}  // namespace

extern "C" {

// points: float32 (B, P, >=3) read through element strides (sb, sp, sc);
// boxes: float32 (B, G, 7) bottom-center, contiguous; cos_yaw, sin_yaw:
// float32 (B, G); gt_valid: bool (B, G); slots: int32 (B, P, S); has: bool
// (B, P, S).  G <= 1024, 1 <= S <= 8, B <= 65,535.
int demf_vote_slots(const void* points, const void* boxes,
                    const void* cos_yaw, const void* sin_yaw,
                    const void* gt_valid, void* slots, void* has, int b,
                    int p, int g, int s, long long sb, long long sp,
                    long long sc, float eps, void* stream) {
  if (g < 1 || g > kMaxBoxes || s < 1 || s > kMaxSlots || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || p == 0) return 0;
  const dim3 grid((p + kThreads - 1) / kThreads, b);
  vote_slots_kernel<<<grid, kThreads, g * 8 * sizeof(float),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const float*>(boxes),
      static_cast<const float*>(cos_yaw), static_cast<const float*>(sin_yaw),
      static_cast<const bool*>(gt_valid), static_cast<int*>(slots),
      static_cast<bool*>(has), p, g, s, sb, sp, sc, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
