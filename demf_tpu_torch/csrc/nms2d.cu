// Greedy 2D NMS separated by group, a whole batch in two launches:
// keep[b, i] for boxes (B, N, 4) xyxy, scores (B, N), integer groups
// (B, N) and valid (B, N), N <= 16,384.
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
// been applied, and the order that the sweep needs.  At the path's shapes
// the order's sort, one SM an image, takes about half the time: its merges
// are bound by shared memory (random 64-bit reads of the runs).
//
// The design (ops/nms2d.py::k10_keys and batched_nms_2d_tiled hold the
// same rule in plain Python):
// (1) nms2d_order_kernel, one block an image: each candidate's packed
//     63-bit key (the id's low 16 bits, or an invalid flag above them; the
//     score's order bits, descending, -0 as +0, every NaN last; the index)
//     is sorted in shared memory (up to 16,384 keys, 136 KB with a pad
//     slot every 16 against bank conflicts): each thread sorts 16 keys in
//     registers, then runs of 16, 32, ... are merged pairwise, each thread
//     finding the start of its 16 outputs on the merge path.  Every key is
//     unique, so the sort gives the stable order by (group, score
//     descending, index) with invalid entries last.  Two block scans give
//     each place the span of its code group; the block writes the boxes
//     and ids in that order, each place's original index and span, and
//     zeroes the groups' done counters.
// (2) nms2d_sweep_kernel, a grid of (64-row tile, 4 column chunks, image)
//     blocks: each writes its rows' 64-bit words of suppression bits for
//     every 4th column word (the later columns of the row's code group
//     with the same id and an IoU above the threshold; ids that share
//     their low 16 bits share a code group and are told apart here, so any
//     int64 id is taken) into a (B, N, N / 64) scratch, 4 threads a row,
//     16 columns each.  The block that arrives last at a group (a done
//     counter a group, after a fence) sweeps it a 64-row word at a time:
//     one warp resolves the diagonal word serially, 16 rows' words at a
//     time from registers (~8 clocks a row), and ORs the kept rows' next
//     words (staged a tile ahead) into the next removed word; meanwhile
//     the other warps stage the next tile's diagonal and next words and OR
//     the previous tile's kept rows into the words beyond, so the serial
//     chain never waits on device memory.  Groups run in parallel over the
//     SMs; a sweep shares its SM with blocks still making bits.
//
// Keep masks equal the plain version's bit for bit: the IoU arithmetic is
// written with __fsub_rn / __fmul_rn / __fadd_rn / __fdiv_rn in the plain
// version's order (dx * dy, (area_r + area_c) - inter, the union clamped at
// 1e-8), so nvcc contracts nothing into an FMA, and compared in float32
// with the threshold (>= 0: a pair that does not intersect has an IoU of 0
// and is skipped).  A box with a coordinate that is not finite neither
// suppresses nor is suppressed (in the plain version all its IoUs are 0 or
// NaN, and fmaxf would drop a NaN that torch.maximum keeps).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;             // rows (and columns) of a tile
constexpr int kChunks = 4;            // blocks a tile: every 4th word each
constexpr int kBatch = 8;             // far-word loads a helper issues at once
constexpr int kThreads = 256;         // the sweep kernel: 4 threads a row
constexpr int kOrderThreads = 1024;   // the order kernel at most
constexpr int kPer = 16;              // keys a thread of it holds
constexpr int kPerLog = 4;
constexpr int kMaxN = 16384;
constexpr int kMaxWords = kMaxN / 64;
constexpr int kIndexBits = 14;        // kMaxN = 2^14
constexpr int kScoreShift = kIndexBits;
constexpr int kGroupShift = kIndexBits + 32;
constexpr unsigned long long kInvalidCode = 1ull << 16;
constexpr unsigned long long kPad = 0x7fffffffffffffffull;
constexpr unsigned long long kSentinel = ~0ull;  // past every key and pad
constexpr unsigned kFull = 0xffffffffu;

__device__ inline float area_of(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

__device__ inline bool finite_box(float4 b) {
  return isfinite(b.x) && isfinite(b.y) && isfinite(b.z) && isfinite(b.w);
}

// the score's order bits: ascending in the key is descending in the score,
// -0 ties with +0, every NaN after -inf
__device__ inline unsigned long long score_bits(float s) {
  if (isnan(s)) return 0xffffffffull;
  const unsigned u = __float_as_uint(s == 0.f ? 0.f : s);
  const unsigned asc = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return static_cast<unsigned long long>(~asc);
}

// a key's place in the order kernel's shared memory: one empty slot after
// every kPer keys, so that a thread's kPer keys start kPer + 1 slots after
// its neighbour's and a warp's accesses to them fall in distinct banks
__device__ inline int slot(int i) { return i + (i >> kPerLog); }

// over the block's threads in order: the largest `v` of the threads
// before this one (-1 if none), the smallest of the threads after it
// (`none` if none); `s_warp` holds 32 ints; every thread calls them
__device__ inline int block_max_before(int v, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = max(v, x);
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < warps ? s_warp[lane] : -1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w = max(w, x);
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  int before = __shfl_up_sync(kFull, v, 1);
  if (lane == 0) before = -1;
  if (warp > 0) before = max(before, s_warp[warp - 1]);
  __syncthreads();
  return before;
}

__device__ inline int block_min_after(int v, int none, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_down_sync(kFull, v, o);
    if (lane + o < 32) v = min(v, x);
  }
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < warps ? s_warp[lane] : none;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_down_sync(kFull, w, o);
      if (lane + o < 32) w = min(w, x);
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  int after = __shfl_down_sync(kFull, v, 1);
  if (lane == 31) after = none;
  if (warp + 1 < warps) after = min(after, s_warp[warp + 1]);
  __syncthreads();
  return after;
}

__device__ inline void order_pair(unsigned long long& a,
                                  unsigned long long& b) {
  if (a > b) {
    const unsigned long long t = a;
    a = b;
    b = t;
  }
}

// the kPer keys a thread holds, sorted ascending: a bitonic network
__device__ inline void sort_registers(unsigned long long (&v)[kPer]) {
#pragma unroll
  for (int k = 2; k <= kPer; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1)
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        if ((e ^ j) > e) {
          if ((e & k) == 0) order_pair(v[e], v[e ^ j]);
          else order_pair(v[e ^ j], v[e]);
        }
}

__global__ void __launch_bounds__(kOrderThreads)
    nms2d_order_kernel(const float4* __restrict__ boxes,
                       const float* __restrict__ scores,
                       const long long* __restrict__ idxs,
                       const bool* __restrict__ valid,
                       float4* __restrict__ s_boxes,
                       long long* __restrict__ s_ids, int* __restrict__ orig,
                       int2* __restrict__ span, int* __restrict__ done,
                       bool* __restrict__ keep, int n, int padded) {
  extern __shared__ unsigned long long keys[];
  const int image = blockIdx.x;
  const size_t off = static_cast<size_t>(image) * n;
  __shared__ int s_warp[32];
  // the keys, read coalesced into shared memory; then kPer consecutive
  // keys a thread (padded / kPer threads)
  for (int i = threadIdx.x; i < padded; i += blockDim.x) {
    unsigned long long key = kPad;
    if (i < n) {
      const unsigned long long code =
          valid[off + i] ? (static_cast<unsigned long long>(idxs[off + i]) &
                            0xffffull)
                         : kInvalidCode;
      key = (code << kGroupShift) | (score_bits(scores[off + i])
                                     << kScoreShift) |
            static_cast<unsigned long long>(i);
    }
    keys[slot(i)] = key;
  }
  __syncthreads();
  const int base = threadIdx.x * kPer;
  unsigned long long v[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) v[e] = keys[slot(base + e)];
  // merge sort, ascending: each thread's kPer keys in registers, then runs
  // of kPer, 2 kPer, ... merged pairwise in shared memory, each thread
  // finding where its kPer outputs start on the merge path
  sort_registers(v);
#pragma unroll
  for (int e = 0; e < kPer; ++e) keys[slot(base + e)] = v[e];
  for (int run = kPer; run < padded; run <<= 1) {
    __syncthreads();
    const int start = base & ~(2 * run - 1), d = base - start;
    const unsigned long long* left = keys;
    int lo = max(0, d - run), hi = min(d, run);
    while (lo < hi) {  // the first i with left[i] > right[d - 1 - i]
      const int mid = (lo + hi) >> 1;
      if (left[slot(start + mid)] < left[slot(start + run + d - 1 - mid)])
        lo = mid + 1;
      else
        hi = mid;
    }
    int i = lo, j = d - lo;
    unsigned long long x = i < run ? keys[slot(start + i)] : kSentinel;
    unsigned long long y = j < run ? keys[slot(start + run + j)] : kSentinel;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if (x < y) {
        v[e] = x;
        ++i;
        x = i < run ? keys[slot(start + i)] : kSentinel;
      } else {
        v[e] = y;
        ++j;
        y = j < run ? keys[slot(start + run + j)] : kSentinel;
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kPer; ++e) keys[slot(base + e)] = v[e];
  }
  __syncthreads();
  // each place's code group [start, end): the last change of code at or
  // before it and the first after it (the pads past n have a code of
  // their own), from the thread's keys and one block scan each way
  const unsigned long long before =
      base > 0 ? keys[slot(base - 1)] >> kGroupShift : ~0ull;
  int first = 0x7fffffff, last = -1;
  unsigned starts = 0;  // bit e: place base + e starts a code group
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const unsigned long long prev = e > 0 ? v[e - 1] >> kGroupShift : before;
    if ((v[e] >> kGroupShift) != prev) {
      starts |= 1u << e;
      first = min(first, base + e);
      last = base + e;
    }
  }
  int start = block_max_before(last, s_warp);
  int end = block_min_after(first, padded, s_warp);
  int span_start[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    if ((starts >> e) & 1u) start = base + e;
    span_start[e] = start;
  }
  // each place packed for the coalesced writes below: its original index,
  // its code group's start and end, whether it is invalid
#pragma unroll
  for (int e = kPer - 1; e >= 0; --e) {
    const bool invalid = (v[e] >> kGroupShift) == kInvalidCode;
    keys[slot(base + e)] =
        (v[e] & (kMaxN - 1)) |
        (static_cast<unsigned long long>(span_start[e]) << 16) |
        (static_cast<unsigned long long>(end) << 32) |
        (static_cast<unsigned long long>(invalid) << 48);
    if ((starts >> e) & 1u) end = base + e;
  }
  __syncthreads();
#pragma unroll 4
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const unsigned long long packed = keys[slot(p)];
    const int o = static_cast<int>(packed & 0xffff);
    s_boxes[off + p] = boxes[off + o];
    s_ids[off + p] = idxs[off + o];
    orig[off + p] = o;
    done[off + p] = 0;
    if ((packed >> 48) & 1ull) {
      span[off + p] = make_int2(-1, -1);
      keep[off + o] = false;
    } else {
      span[off + p] = make_int2(static_cast<int>((packed >> 16) & 0xffff),
                                static_cast<int>((packed >> 32) & 0xffff));
    }
  }
}

// the group's words w0..w1 a tile at a time, by the whole block (see the
// note at the top); bits are read from L2 (__ldcg): other blocks wrote them
__device__ void sweep_group(const unsigned long long* bits,
                            const int* __restrict__ orig,
                            bool* __restrict__ keep, int words, int start,
                            int end, unsigned long long* s_removed,
                            unsigned long long (*s_diag)[kRows],
                            unsigned long long (*s_next)[kRows],
                            int (*s_rows)[kRows], int* s_kept_count,
                            unsigned long long* s_kept_bits) {
  const int w0 = start / 64, w1 = (end - 1) / 64;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i <= w1 - w0; i += kThreads) s_removed[i] = 0ull;
  // the first tile's diagonal and next words
  if (threadIdx.x < kRows) {
    const int r = w0 * 64 + threadIdx.x;
    const bool in = r >= start && r < end;
    const unsigned long long* row = bits + static_cast<size_t>(r) * words;
    s_diag[0][threadIdx.x] = in ? __ldcg(row + w0) : 0ull;
    s_next[0][threadIdx.x] = in && w0 < w1 ? __ldcg(row + w0 + 1) : 0ull;
  }
  if (threadIdx.x == 0) s_kept_count[1] = 0;
  __syncthreads();
  for (int w = w0; w <= w1; ++w) {
    const int b = (w - w0) & 1;
    const int first = w * 64;
    if (warp == 0) {
      // rows outside the group count as removed
      const int lo = max(start - first, 0), hi = min(end - first, 64);
      const unsigned long long in_group =
          (hi >= 64 ? ~0ull : ((1ull << hi) - 1)) & ~((1ull << lo) - 1);
      unsigned long long rem = s_removed[w - w0] | ~in_group;
      // 16 rows' words loaded at a time, none of them behind the chain
#pragma unroll
      for (int c = 0; c < 64; c += 16) {
        unsigned long long d[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) d[i] = s_diag[b][c + i];
#pragma unroll
        for (int i = 0; i < 16; ++i)
          rem |= ((rem >> (c + i)) & 1ull) ? 0ull : d[i];
      }
      const unsigned long long kept = ~rem;
      // the kept rows' next words into the next removed word
      unsigned long long v = 0ull;
      if ((kept >> lane) & 1ull) v |= s_next[b][lane];
      if ((kept >> (lane + 32)) & 1ull) v |= s_next[b][lane + 32];
      for (int o = 16; o > 0; o >>= 1) v |= __shfl_xor_sync(kFull, v, o);
      if (lane == 0) {
        if (w < w1 && v) atomicOr(&s_removed[w + 1 - w0], v);
        s_kept_count[b] = __popcll(kept);
      }
      // the kept rows' places, in order, for the far words
      for (int i = lane; i < 64; i += 32)
        if ((kept >> i) & 1ull)
          s_rows[b][__popcll(kept & ((1ull << i) - 1))] = first + i;
      if (lane == 0) s_kept_bits[w - w0] = kept;
    } else {
      const int t = threadIdx.x - 32, helpers = kThreads - 32;
      // stage the next tile's diagonal and next words
      if (w < w1 && t < kRows) {
        const int r = first + 64 + t;
        const bool in = r < end;
        const unsigned long long* row = bits + static_cast<size_t>(r) * words;
        s_diag[b ^ 1][t] = in ? __ldcg(row + w + 1) : 0ull;
        s_next[b ^ 1][t] = in && w + 1 < w1 ? __ldcg(row + w + 2) : 0ull;
      }
      // the previous tile's kept rows into the words past the next one
      const int count = s_kept_count[b ^ 1];
      const int far = w1 - w;  // words w + 1 .. w1
      for (int k0 = t; k0 < count * far; k0 += kBatch * helpers) {
        unsigned long long v[kBatch];
        int at[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {  // the loads issued together
          const int k = k0 + u * helpers;
          at[u] = k < count * far ? w + 1 + k % far - w0 : -1;
          v[u] = at[u] >= 0 ? __ldcg(bits + static_cast<size_t>(
                                  s_rows[b ^ 1][k / far]) * words +
                              w0 + at[u])
                            : 0ull;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (v[u]) atomicOr(&s_removed[at[u]], v[u]);
      }
    }
    __syncthreads();
  }
  // the keep mask back in the original order, off the serial chain
  for (int r = start + threadIdx.x; r < end; r += kThreads)
    keep[orig[r]] = (s_kept_bits[r / 64 - w0] >> (r & 63)) & 1ull;
}

__global__ void __launch_bounds__(kThreads)
    nms2d_sweep_kernel(const float4* __restrict__ s_boxes,
                       const long long* __restrict__ s_ids,
                       const int* __restrict__ orig,
                       const int2* __restrict__ span, int* __restrict__ done,
                       unsigned long long* __restrict__ bits,
                       bool* __restrict__ keep, int n, float thresh) {
  __shared__ float4 c_box[kRows];
  __shared__ float c_area[kRows];
  __shared__ bool c_finite[kRows];
  __shared__ long long c_id[kRows];
  __shared__ int s_last_word;
  __shared__ int s_count;
  __shared__ int2 s_groups[kRows];
  __shared__ unsigned long long s_removed[kMaxWords];
  __shared__ unsigned long long s_kept_bits[kMaxWords];
  __shared__ unsigned long long s_diag[2][kRows];
  __shared__ unsigned long long s_next[2][kRows];
  __shared__ int s_rows[2][kRows];
  __shared__ int s_kept_count[2];
  const int words = (n + 63) / 64;
  const int image = blockIdx.z;
  const size_t off = static_cast<size_t>(image) * n;
  s_boxes += off;
  s_ids += off;
  orig += off;
  span += off;
  done += off;
  keep += off;
  bits += off * words;

  const int tile = blockIdx.x;
  const int row_local = threadIdx.x >> 2, quarter = threadIdx.x & 3;
  const int r = tile * kRows + row_local;
  if (threadIdx.x == 0) {
    s_last_word = -1;
    s_count = 0;
  }
  __syncthreads();
  int2 rs = make_int2(-1, -1);
  float4 rb = make_float4(0.f, 0.f, 0.f, 0.f);
  float r_area = 0.f;
  bool r_ok = false;
  long long r_id = 0;
  if (r < n) {
    rs = span[r];
    if (rs.y >= 0) {
      rb = s_boxes[r];
      r_area = area_of(rb);
      r_ok = finite_box(rb);
      r_id = s_ids[r];
      if (quarter == 0) atomicMax(&s_last_word, (rs.y - 1) / 64);
    }
  }
  __syncthreads();
  const int last_word = s_last_word;
  if (last_word < 0) return;  // a tile of invalid entries only

  for (int word = tile + blockIdx.y; word <= last_word; word += kChunks) {
    if (threadIdx.x < kRows) {
      const int c = word * 64 + threadIdx.x;
      float4 cb = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < n) cb = s_boxes[c];
      c_box[threadIdx.x] = cb;
      c_area[threadIdx.x] = area_of(cb);
      c_finite[threadIdx.x] = c < n && finite_box(cb);
      c_id[threadIdx.x] = c < n ? s_ids[c] : 0;
    }
    __syncthreads();
    unsigned long long row = 0ull;
    if (r_ok) {
      const int lo = max(r + 1, word * 64 + quarter * 16);
      const int hi = min(rs.y, word * 64 + quarter * 16 + 16);
      for (int col = lo; col < hi; ++col) {
        const int j = col - word * 64;
        if (!c_finite[j] || c_id[j] != r_id) continue;
        const float4 cb = c_box[j];
        const float dx =
            fmaxf(__fsub_rn(fminf(rb.z, cb.z), fmaxf(rb.x, cb.x)), 0.f);
        const float dy =
            fmaxf(__fsub_rn(fminf(rb.w, cb.w), fmaxf(rb.y, cb.y)), 0.f);
        const float inter = __fmul_rn(dx, dy);
        if (!(inter > 0.f)) continue;  // IoU 0, never above thresh >= 0
        const float uni =
            fmaxf(__fsub_rn(__fadd_rn(r_area, c_area[j]), inter), 1e-8f);
        if (__fdiv_rn(inter, uni) > thresh) row |= 1ull << j;
      }
    }
    row |= __shfl_xor_sync(kFull, row, 1);
    row |= __shfl_xor_sync(kFull, row, 2);
    if (quarter == 0 && rs.y >= 0 && word <= (rs.y - 1) / 64)
      bits[static_cast<size_t>(r) * words + word] = row;
    __syncthreads();
  }

  // the groups of this tile: the block that finishes a group's last tile
  // sweeps it
  __threadfence();
  __syncthreads();
  if (quarter == 0 && rs.y >= 0 &&
      (row_local == 0 || r == rs.x)) {
    const int blocks = ((rs.y - 1) / 64 - rs.x / 64 + 1) * kChunks;
    if (atomicAdd(&done[rs.x], 1) == blocks - 1)
      s_groups[atomicAdd(&s_count, 1)] = rs;
  }
  __syncthreads();
  const int count = s_count;
  if (count == 0) return;
  __threadfence();
  for (int g = 0; g < count; ++g)
    sweep_group(bits, orig, keep, words, s_groups[g].x, s_groups[g].y,
                s_removed, s_diag, s_next, s_rows, s_kept_count,
                s_kept_bits);
}

// the order kernel's shared memory for `padded` keys, in slots
int order_smem_bytes(int padded) {
  return 8 * (padded + padded / kPer);
}

}  // namespace

extern "C" {

// boxes (B, N, 4) f32, scores (B, N) f32, idxs (B, N) int64, valid (B, N)
// bool; scratch: s_boxes (B, N, 4) f32, s_ids (B, N) int64, orig (B, N)
// int32, span (B, N, 2) int32, done (B, N) int32, bits (B, N, ceil(N / 64))
// int64; keep (B, N) bool in the original order, every element written.
// N <= 16,384.
int demf_nms2d(const void* boxes, const void* scores, const void* idxs,
               const void* valid, void* s_boxes, void* s_ids, void* orig,
               void* span, void* done, void* bits, void* keep, int b, int n,
               float thresh, void* stream) {
  if (b == 0 || n == 0) return 0;
  if (n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool configured = false;  // once a process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms2d_order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        order_smem_bytes(kMaxN));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  int padded = 32 * kPer;
  while (padded < n) padded <<= 1;
  nms2d_order_kernel<<<b, padded / kPer, order_smem_bytes(padded), s>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const long long*>(idxs), static_cast<const bool*>(valid),
      static_cast<float4*>(s_boxes), static_cast<long long*>(s_ids),
      static_cast<int*>(orig), static_cast<int2*>(span),
      static_cast<int*>(done), static_cast<bool*>(keep), n, padded);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kRows - 1) / kRows, kChunks, b);
  nms2d_sweep_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float4*>(s_boxes),
      static_cast<const long long*>(s_ids), static_cast<const int*>(orig),
      static_cast<const int2*>(span), static_cast<int*>(done),
      static_cast<unsigned long long*>(bits), static_cast<bool*>(keep), n,
      thresh);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
