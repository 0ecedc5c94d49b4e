// Axis-aligned 3D NMS with same-class suppression, a whole batch in one
// launch: keep[b, i] for boxes (B, N, 6), scores, classes and valid (B, N).
//
// Replaces: demf_tpu/ops/nms.py::aligned_3d_nms with _greedy_suppress,
// vmapped over the batch by models/vote_head.py::multiclass_nms_3d: XLA
// code (an N x N IoU matrix, an argsort, a fori_loop of N steps), not a
// Pallas kernel.  In plain PyTorch the sweep is a Python loop of N steps
// of a few launches each (~1,500 launches at N 512), bound by the host.
//
// What bounds it on the card: not bytes (a scene is 512 x 37 bytes) and
// not the N (N - 1) / 2 pair IoUs (22 operations a pair) but dependent
// work: the greedy sweep, where whether a box survives is known only after
// every kept box before it has been applied.
//
// The design, one block a scene, everything in shared memory: (1) every
// box finds its place in the stable descending order of torch.argsort /
// jnp.argsort by counting the boxes that come before it (key = score, or
// -inf when invalid, NaN last; equal keys by index), and is copied to that
// place.  (2) A warp a row computes the row's suppression bits, the later
// boxes of its class that it would suppress, 32 columns at a time, a
// ballot a word.  (3) One warp sweeps the order: a box whose bit in the
// removed mask is clear is kept and ORs its row into the mask, a word a
// lane.  (4) The mask is scattered back to the original order.
//
// Keep masks equal the plain version's bit for bit: the IoU arithmetic is
// written with __fsub_rn / __fmul_rn / __fadd_rn / __fdiv_rn in the plain
// version's order ((dx * dy) * dz, (vol_r + vol_c) - inter, the union
// clamped at 1e-8), so nvcc contracts nothing into an FMA.  A pair whose
// IoU is NaN suppresses nothing (NaN > thresh is false there too), and a
// box with a coordinate that is not finite neither suppresses nor is
// suppressed: in the plain version every IoU of such a box is 0 or NaN,
// and fmaxf would drop a NaN that torch.maximum keeps.  The wrapper
// refuses thresh < 0, where multiplying by the class equality and AND-ing
// with it differ.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int words_of(int n) { return (n + 31) / 32; }

// bytes of dynamic shared memory for a scene of n boxes (the wrapper,
// ops/nms.py::nms_shared_bytes, reckons the same and refuses a scene that
// does not fit a block)
__host__ __device__ inline size_t shared_bytes(int n) {
  const size_t w = words_of(n);
  return 8 * static_cast<size_t>(n)      // classes
         + 4 * (n * w                    // suppression bits
                + 9 * static_cast<size_t>(n)  // boxes, volumes, keys, order
                + w)                     // removed
         + n;                            // finite
}

// A key's bits mapped so that unsigned order is the floats' order, -0 with
// +0 and NaN below -inf.
__device__ inline unsigned ordered_bits(float key) {
  if (key != key) return 0;
  const unsigned u = __float_as_uint(key == 0.f ? 0.f : key);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(kThreads)
    nms3d_kernel(const float* __restrict__ boxes,
                 const float* __restrict__ scores,
                 const long long* __restrict__ classes,
                 const unsigned char* __restrict__ valid,
                 unsigned char* __restrict__ keep, int n, float thresh) {
  extern __shared__ __align__(8) unsigned char smem[];
  const int w = words_of(n);
  // all but s_key are in the sweep's order
  long long* s_cls = reinterpret_cast<long long*>(smem);
  unsigned* s_sup = reinterpret_cast<unsigned*>(s_cls + n);
  float* s_x1 = reinterpret_cast<float*>(s_sup + static_cast<size_t>(n) * w);
  float* s_y1 = s_x1 + n;
  float* s_z1 = s_y1 + n;
  float* s_x2 = s_z1 + n;
  float* s_y2 = s_x2 + n;
  float* s_z2 = s_y2 + n;
  float* s_vol = s_z2 + n;
  unsigned* s_key = reinterpret_cast<unsigned*>(s_vol + n);
  int* s_order = reinterpret_cast<int*>(s_key + n);
  unsigned* s_removed = reinterpret_cast<unsigned*>(s_order + n);
  unsigned char* s_finite = reinterpret_cast<unsigned char*>(s_removed + w);

  const int scene = blockIdx.x;
  boxes += static_cast<size_t>(scene) * n * 6;
  scores += static_cast<size_t>(scene) * n;
  classes += static_cast<size_t>(scene) * n;
  valid += static_cast<size_t>(scene) * n;
  keep += static_cast<size_t>(scene) * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // (1) the order.  Invalid boxes and the bits past n start as removed.
  for (int i = threadIdx.x; i < n; i += kThreads)
    s_key[i] = ordered_bits(valid[i] ? scores[i] : -CUDART_INF_F);
  for (int i = threadIdx.x; i < w; i += kThreads) s_removed[i] = kFull;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const unsigned mine = s_key[i];
    int p = 0;  // the boxes before box i
    for (int j = 0; j < n; ++j) {
      const unsigned other = s_key[j];
      p += other > mine || (other == mine && j < i);
    }
    const float* b = boxes + static_cast<size_t>(i) * 6;
    const float x1 = b[0], y1 = b[1], z1 = b[2];
    const float x2 = b[3], y2 = b[4], z2 = b[5];
    s_x1[p] = x1;
    s_y1[p] = y1;
    s_z1[p] = z1;
    s_x2[p] = x2;
    s_y2[p] = y2;
    s_z2[p] = z2;
    s_vol[p] = __fmul_rn(
        __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.f), fmaxf(__fsub_rn(y2, y1), 0.f)),
        fmaxf(__fsub_rn(z2, z1), 0.f));
    s_finite[p] = isfinite(x1) && isfinite(y1) && isfinite(z1) &&
                  isfinite(x2) && isfinite(y2) && isfinite(z2);
    s_cls[p] = classes[i];
    s_order[p] = i;
    if (valid[i]) atomicAnd(&s_removed[p >> 5], ~(1u << (p & 31)));
  }
  __syncthreads();

  // (2) the suppression bits: a warp a row, 32 columns at a time (the row's
  // box is a broadcast, the columns' boxes lie side by side)
  for (int r = warp; r < n; r += kThreads / 32) {
    const bool r_ok = s_finite[r];
    const long long rcls = s_cls[r];
    const float rx1 = s_x1[r], ry1 = s_y1[r], rz1 = s_z1[r];
    const float rx2 = s_x2[r], ry2 = s_y2[r], rz2 = s_z2[r];
    const float rvol = s_vol[r];
    for (int word = r >> 5; word < w; ++word) {
      const int c = word * 32 + lane;
      bool above = false;
      if (r_ok && c > r && c < n && s_finite[c] && s_cls[c] == rcls) {
        const float dx = fmaxf(
            __fsub_rn(fminf(rx2, s_x2[c]), fmaxf(rx1, s_x1[c])), 0.f);
        const float dy = fmaxf(
            __fsub_rn(fminf(ry2, s_y2[c]), fmaxf(ry1, s_y1[c])), 0.f);
        const float dz = fmaxf(
            __fsub_rn(fminf(rz2, s_z2[c]), fmaxf(rz1, s_z1[c])), 0.f);
        const float inter = __fmul_rn(__fmul_rn(dx, dy), dz);
        const float uni =
            fmaxf(__fsub_rn(__fadd_rn(rvol, s_vol[c]), inter), 1e-8f);
        above = __fdiv_rn(inter, uni) > thresh;
      }
      const unsigned bits = __ballot_sync(kFull, above);
      if (lane == 0) s_sup[static_cast<size_t>(r) * w + word] = bits;
    }
  }
  __syncthreads();

  // (3) the sweep, by one warp: a row has bits only at later places, so a
  // box's own bit is final when its turn comes
  if (warp == 0) {
    for (int r = 0; r < n; ++r) {
      const bool kept = !((s_removed[r >> 5] >> (r & 31)) & 1u);
      __syncwarp();
      if (kept)
        for (int word = (r >> 5) + lane; word < w; word += 32)
          s_removed[word] |= s_sup[static_cast<size_t>(r) * w + word];
      __syncwarp();
    }
  }
  __syncthreads();

  // (4) back to the original order
  for (int p = threadIdx.x; p < n; p += kThreads)
    keep[s_order[p]] = !((s_removed[p >> 5] >> (p & 31)) & 1u);
}

}  // namespace

extern "C" {

// boxes (B, N, 6) f32; scores (B, N) f32; classes (B, N) int64; valid
// (B, N) bool; keep (B, N) bool, every element written.
int demf_nms3d(const void* boxes, const void* scores, const void* classes,
               const void* valid, void* keep, int b, int n, float thresh,
               void* stream) {
  if (b == 0 || n == 0) return 0;
  const size_t bytes = shared_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      nms3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms3d_kernel<<<b, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<const long long*>(classes),
      static_cast<const unsigned char*>(valid),
      static_cast<unsigned char*>(keep), n, thresh);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
