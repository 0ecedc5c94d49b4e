// Greedy 2D NMS separated by group, a whole batch in one call: keep[b, i]
// for boxes (B, N, 4) xyxy that the wrapper has put in K10's order (by
// group, then by score descending, stable; invalid entries last in a group
// of their own: ops/nms2d.py::k10_order).
//
// Replaces: demf_tpu/ops/nms.py::batched_nms_2d and nms_2d, with
// _greedy_suppress (N <= 4096: an N x N IoU matrix and a fori_loop of N
// steps) and _greedy_suppress_rowwise_2d (N > 4096: one pivot's IoU row a
// step), vmapped over the images by models/rpn_roi.py: XLA code, not a
// Pallas kernel.  On the path it runs twice a request or a step: over the
// RPN's 4,390 candidates an image in 5 level groups and over the R-CNN's
// 10,000 (1,000 proposals x 10 classes) in 10 class groups.
//
// What bounds it on the card: not bytes (an image's candidates are 160 KB)
// and not the pair IoUs (at most N^2 / 2 of ~20 operations; within groups
// far fewer) but dependent work: the greedy sweep, where whether a box
// survives is known only after every kept box before it in its group has
// been applied.  K8's layout (all bits of a scene in shared memory) holds
// 1,184 boxes; 10,000 need 12.5 MB of bits.
//
// The design: (1) a grid of blocks of 64 rows, one thread a row: the block
// loads 64 column boxes at a time into shared memory and each thread writes
// its row's 64-bit word of suppression bits (the later columns of its own
// group whose IoU is above the threshold) into a (B, N, N / 64) scratch in
// device memory.  A row's group ends where the sorted group ids change
// (a binary search), so a block visits only the tiles its rows' groups
// reach: ~16 of the 157 a row of 10,000 has when a group holds 1,000.
// (2) one block an image sweeps: a warp a group, the removed bits of the
// whole image in shared memory (64-bit words, OR-ed atomically because two
// groups can share a word); the words of the next row are loaded while the
// current row is decided, so the chain of dependent steps waits on shared
// memory, not on device memory.  (3) the sweep writes the keep mask back in
// the original order.
//
// Keep masks equal the plain version's bit for bit: the IoU arithmetic is
// written with __fsub_rn / __fmul_rn / __fadd_rn / __fdiv_rn in the plain
// version's order (dx * dy, (area_r + area_c) - inter, the union clamped at
// 1e-8), so nvcc contracts nothing into an FMA, and compared in float32
// with the threshold.  A box with a coordinate that is not finite neither
// suppresses nor is suppressed (in the plain version all its IoUs are 0 or
// NaN, and fmaxf would drop a NaN that torch.maximum keeps).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;           // rows (and columns) of a tile
constexpr int kSweepThreads = 256;  // 8 warps: 8 groups swept at once
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kInvalid = 0x7fffffffffffffffLL;

__device__ inline float area_of(float x1, float y1, float x2, float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.f), fmaxf(__fsub_rn(y2, y1), 0.f));
}

__device__ inline bool finite_box(float4 b) {
  return isfinite(b.x) && isfinite(b.y) && isfinite(b.z) && isfinite(b.w);
}

// the first place after `from` whose group differs from `g` (groups sorted)
__device__ inline int group_end(const long long* groups, int from, int n,
                                long long g) {
  int lo = from, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (groups[mid] <= g) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kRows)
    nms2d_bits_kernel(const float4* __restrict__ boxes,
                      const long long* __restrict__ groups,
                      unsigned long long* __restrict__ bits, int n,
                      float thresh) {
  __shared__ float4 s_box[kRows];
  __shared__ float s_area[kRows];
  __shared__ bool s_finite[kRows];
  __shared__ int s_end;
  const int words = (n + 63) / 64;
  const int image = blockIdx.y;
  boxes += static_cast<size_t>(image) * n;
  groups += static_cast<size_t>(image) * n;
  bits += static_cast<size_t>(image) * n * words;

  const int r = blockIdx.x * kRows + threadIdx.x;
  if (threadIdx.x == 0) s_end = 0;
  __syncthreads();
  int end = r + 1;  // no columns unless the row is a valid box
  float4 rb = make_float4(0.f, 0.f, 0.f, 0.f);
  float r_area = 0.f;
  bool r_ok = false;
  if (r < n) {
    const long long g = groups[r];
    if (g != kInvalid) {
      end = group_end(groups, r + 1, n, g);
      rb = boxes[r];
      r_area = area_of(rb.x, rb.y, rb.z, rb.w);
      r_ok = finite_box(rb);
      atomicMax(&s_end, end);
    }
  }
  __syncthreads();
  const int last_word = s_end > 0 ? (s_end - 1) / 64 : -1;  // no columns

  for (int word = blockIdx.x; word <= last_word; ++word) {
    const int c = word * 64 + threadIdx.x;
    if (c < n) {
      const float4 cb = boxes[c];
      s_box[threadIdx.x] = cb;
      s_area[threadIdx.x] = area_of(cb.x, cb.y, cb.z, cb.w);
      s_finite[threadIdx.x] = finite_box(cb);
    }
    __syncthreads();
    if (r < n && word <= (end - 1) / 64) {
      unsigned long long row = 0ull;
      if (r_ok) {
        const int lo = max(r + 1, word * 64), hi = min(end, word * 64 + 64);
        for (int col = lo; col < hi; ++col) {
          const int j = col - word * 64;
          if (!s_finite[j]) continue;
          const float4 cb = s_box[j];
          const float dx = fmaxf(__fsub_rn(fminf(rb.z, cb.z), fmaxf(rb.x, cb.x)),
                                 0.f);
          const float dy = fmaxf(__fsub_rn(fminf(rb.w, cb.w), fmaxf(rb.y, cb.y)),
                                 0.f);
          const float inter = __fmul_rn(dx, dy);
          const float uni =
              fmaxf(__fsub_rn(__fadd_rn(r_area, s_area[j]), inter), 1e-8f);
          if (__fdiv_rn(inter, uni) > thresh) row |= 1ull << j;
        }
      }
      bits[static_cast<size_t>(r) * words + word] = row;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kSweepThreads)
    nms2d_sweep_kernel(const long long* __restrict__ groups,
                       const long long* __restrict__ order,
                       const unsigned long long* __restrict__ bits,
                       bool* __restrict__ keep, int n) {
  extern __shared__ __align__(8) unsigned char smem[];
  const int words = (n + 63) / 64;
  unsigned long long* s_removed = reinterpret_cast<unsigned long long*>(smem);
  int* s_starts = reinterpret_cast<int*>(s_removed + words);
  __shared__ int s_count;
  const int image = blockIdx.x;
  groups += static_cast<size_t>(image) * n;
  order += static_cast<size_t>(image) * n;
  bits += static_cast<size_t>(image) * n * words;
  keep += static_cast<size_t>(image) * n;

  if (threadIdx.x == 0) s_count = 0;
  for (int i = threadIdx.x; i < words; i += kSweepThreads) s_removed[i] = 0ull;
  __syncthreads();
  // the groups: where the sorted ids change (invalid entries are no group)
  for (int p = threadIdx.x; p < n; p += kSweepThreads) {
    const long long g = groups[p];
    if (g != kInvalid && (p == 0 || groups[p - 1] != g))
      s_starts[atomicAdd(&s_count, 1)] = p;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = warp; k < s_count; k += kSweepThreads / 32) {
    const int start = s_starts[k];
    const int end = group_end(groups, start + 1, n, groups[start]);
    const int last_word = (end - 1) / 64;
    // the lane's first word of row r: r / 64 + lane; words 32 and more
    // past a row's first come from device memory when the row is kept
    unsigned long long cur = 0ull;
    if (start / 64 + lane <= last_word)
      cur = bits[static_cast<size_t>(start) * words + start / 64 + lane];
    for (int r = start; r < end; ++r) {
      unsigned long long next = 0ull;
      if (r + 1 < end && (r + 1) / 64 + lane <= last_word)
        next = bits[static_cast<size_t>(r + 1) * words + (r + 1) / 64 + lane];
      const bool kept = !((s_removed[r >> 6] >> (r & 63)) & 1ull);
      if (kept) {
        if (cur) atomicOr(&s_removed[r / 64 + lane], cur);
        for (int word = r / 64 + 32 + lane; word <= last_word; word += 32) {
          const unsigned long long v =
              bits[static_cast<size_t>(r) * words + word];
          if (v) atomicOr(&s_removed[word], v);
        }
      }
      __syncwarp(kFull);
      cur = next;
    }
  }
  __syncthreads();

  // back to the original order
  for (int p = threadIdx.x; p < n; p += kSweepThreads)
    keep[order[p]] = groups[p] != kInvalid &&
                     !((s_removed[p >> 6] >> (p & 63)) & 1ull);
}

}  // namespace

extern "C" {

// boxes (B, N, 4) f32 and groups (B, N) int64 in K10's order, order (B, N)
// int64 (the original index of each place), bits (B, N, ceil(N / 64)) int64
// scratch, keep (B, N) bool in the original order, every element written.
int demf_nms2d(const void* boxes, const void* groups, const void* order,
               void* bits, void* keep, int b, int n, float thresh,
               void* stream) {
  if (b == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kRows - 1) / kRows, b);
  nms2d_bits_kernel<<<grid, kRows, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<const long long*>(groups),
      static_cast<unsigned long long*>(bits), n, thresh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t shared = 8 * static_cast<size_t>((n + 63) / 64) + 4 * n;
  err = cudaFuncSetAttribute(nms2d_sweep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shared));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms2d_sweep_kernel<<<b, kSweepThreads, shared, s>>>(
      static_cast<const long long*>(groups),
      static_cast<const long long*>(order),
      static_cast<const unsigned long long*>(bits), static_cast<bool*>(keep),
      n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
