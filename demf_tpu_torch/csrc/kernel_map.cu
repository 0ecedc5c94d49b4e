// The kernel maps of a sparse convolution, several tables a launch:
// out[b, q, t] = the row of scene b's voxel table whose coordinate is
// query[b, q] + offset[t] * stride, or -1 where there is none (or the query
// row is invalid); or, for a transposed convolution's table (a "cell" job),
// each fine row's parent row floor(query / cell) * cell held at the tap of
// its offset (query - parent) / stride, -1 at the other taps.
//
// Replaces: demf_tpu/ops/sparse.py::neighbor_table_batched (and the
// transposed conv's parent lookup, transposed_conv_to_batched), XLA code:
// a bucketed compare of each query key against 128-key lines of the sorted
// table, or the z-run form that resolves three taps from one line, both
// shaped for the TPU's gathers.  Both give the exact match of the key.
//
// What bounds it on the card: not bytes (a query's 12 bytes, a 4-byte row
// a tap, the table once) nor operations, but latency: a request's tables
// are small launches, and a lookup is a chain of dependent loads (a binary
// search over a scene's 32,768 keys is 15 of them).  The design:
// (1) A launch takes a short list of jobs by value in one kernel parameter
//     (__grid_constant__), so the tables that a model knows together (a
//     stride-2 block's strided table and its level's 27-tap table; the
//     head's three parent lookups) cost one launch and no torch op: the
//     kernel linearizes the key table's coordinates itself (a padding row
//     is KEY_PAD, INT32_MAX, past every real key) and makes each tap's
//     offset from the kernel's size and tap order.
// (2) A block owns 64 query rows of one scene.  Every target of its rows
//     lies between the smallest and the largest row key plus the smallest
//     and the largest tap offset (a key is affine in the coordinate), so
//     two 32-way warp searches (3 rounds of loads over 32,768 keys) bound
//     a window of the sorted table; its keys go to shared memory.
//     A thread takes a row's taps that differ in z only: their keys
//     ascend, so one binary search there finds the first and a step or two
//     each of the others (a search a tap with given offsets).  A window
//     over 4,096 keys (rows far apart in key order, a table that is not
//     presorted) is searched in device memory instead, within its bounds.
// A coordinate off [0, MAX_COORD] on any axis finds nothing, as the JAX
// package's clamped lookup finds nothing there.  The tables equal
// ops/sparse.py::kernel_table_plain's bit for bit.
#include <climits>
#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int kSpan = 1290;
constexpr int kShift = 16;
constexpr int kMaxCoord = kSpan - kShift - 2;
constexpr int kKeyPad = 0x7fffffff;
constexpr int kThreads = 256;
constexpr int kRows = 64;            // query rows a block
constexpr int kWindow = 4096;        // window keys held in shared memory
constexpr int kMaxJobs = 8;
constexpr int kMaxTaps = kThreads - kRows;
constexpr unsigned kFull = 0xffffffffu;

// one table; the layout matches ops/sparse.py::_JOB
struct Job {
  const int* coords;                 // key table (B, M, 3), presorted, or null
  const unsigned char* valid;        // (B, M) with coords
  const int* keys;                   // (B, M) sorted keys when coords is null
  const int* rows;                   // (B, M) the row of each rank, or null
  const int* query;                  // (B, Q, 3)
  const unsigned char* query_valid;  // (B, Q)
  const int* offsets;                // (K, 3), or null: the cubic kernel's
  int* out;                          // (B, Q, K)
  int b, m, q, k;                    // K: the taps of a row of out
  int size, me_order, stride, cell;  // cell > 0: a parent lookup
  int first_block;                   // set by the launcher
};

struct Jobs {
  int n;
  Job job[kMaxJobs];
};

__device__ inline long long lin(long long x, long long y, long long z) {
  return ((x + kShift) * kSpan + (y + kShift)) * kSpan + (z + kShift);
}

// tap t's offset of a cubic kernel of ``size`` (centred when odd, 0..k-1
// when even), the last axis fastest or with ``me_order`` the first
__device__ inline void tap_offset(const Job& j, int t, int* o) {
  if (j.offsets) {
    o[0] = j.offsets[t * 3 + 0];
    o[1] = j.offsets[t * 3 + 1];
    o[2] = j.offsets[t * 3 + 2];
    return;
  }
  const int s = j.size, c = (s & 1) ? (s - 1) / 2 : 0;
  const int fast = t % s - c, mid = (t / s) % s - c, slow = t / (s * s) - c;
  o[0] = j.me_order ? fast : slow;
  o[1] = mid;
  o[2] = j.me_order ? slow : fast;
}

// the key at position p of the scene's table (its four loads issued
// together: no chain)
__device__ inline int key_at(const Job& j, long long base, int p) {
  if (!j.coords) return __ldg(j.keys + base + p);
  const int* c = j.coords + (base + p) * 3;
  const int x = __ldg(c), y = __ldg(c + 1), z = __ldg(c + 2);
  return __ldg(j.valid + base + p) ? static_cast<int>(lin(x, y, z))
                                   : kKeyPad;
}

// the window [lo, lo + width) of the scene's table: its keys in ``keys``
// (shared memory) when not null
struct Window {
  const Job& j;
  long long base;
  const int* keys;
  int lo, width;

  __device__ int key(int p) const {
    return keys ? keys[p] : key_at(j, base, lo + p);
  }
  __device__ int row(int p) const {
    return j.rows ? __ldg(j.rows + base + lo + p) : lo + p;
  }
  // the first position in [a, width) whose key is not below ``key``
  __device__ int lower_bound(int a, int key_) const {
    int b = width;
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (key(mid) < key_)
        a = mid + 1;
      else
        b = mid;
    }
    return a;
  }
  // the same from a position known not to be past it: one or two steps
  // where the keys run on, as a tap's next z does
  __device__ int advance(int p, int key_) const {
    if (p < width && key(p) < key_) {
      ++p;
      if (p < width && key(p) < key_) p = lower_bound(p + 1, key_);
    }
    return p;
  }
  // the row of the coordinate's key at or after position p, or -1
  __device__ int find(int* p, int x, int y, int z) const {
    if (x < 0 || x > kMaxCoord || y < 0 || y > kMaxCoord || z < 0 ||
        z > kMaxCoord)
      return -1;
    const int k = static_cast<int>(lin(x, y, z));
    *p = advance(*p, k);
    return *p < width && key(*p) == k ? row(*p) : -1;
  }
};

// the first position in [lo, hi) of the scene's table whose key is not
// below ``target`` (hi if none), by the whole warp: each round its lanes
// probe the last key of 32 chunks of the range, so 32,768 keys take 3
// rounds of one load a lane
__device__ int warp_lower_bound(const Job& j, long long base,
                                long long target, int lo, int hi) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const long long n = hi - lo;
    const int end = lo + static_cast<int>((n * (lane + 1)) >> 5);
    const bool below = end - 1 < lo || key_at(j, base, end - 1) < target;
    const int c = __popc(__ballot_sync(kFull, below));
    if (c == 32) return hi;
    const int start = lo + static_cast<int>((n * c) >> 5);
    hi = lo + static_cast<int>((n * (c + 1)) >> 5) - 1;
    lo = start;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
    kernel_map_kernel(const __grid_constant__ Jobs jobs) {
  __shared__ int s_keys[kWindow];
  __shared__ int s_off[kMaxTaps][3];  // each tap's offset times the stride
  __shared__ int s_base[kRows][3];
  __shared__ int s_tap[kRows];       // a cell job's tap of each row
  __shared__ int s_found[kRows];     // a cell job's parent row
  __shared__ long long s_lo[2], s_hi[2];
  __shared__ int s_window[2];

  int ji = jobs.n - 1;
  while (ji > 0 && static_cast<int>(blockIdx.x) < jobs.job[ji].first_block)
    --ji;
  const Job& j = jobs.job[ji];
  const int tiles = (j.q + kRows - 1) / kRows;
  const int local = blockIdx.x - j.first_block;
  const int scene = local / tiles;
  const int q0 = (local - scene * tiles) * kRows;
  const int rows = min(kRows, j.q - q0);
  const long long tbase = static_cast<long long>(scene) * j.m;
  const long long qbase = static_cast<long long>(scene) * j.q + q0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // (1) each row's coordinate to look up (a cell job's parent) and the
  // block's smallest and largest key among its valid rows
  long long kmin = LLONG_MAX, kmax = LLONG_MIN;
  if (tid >= kRows && tid - kRows < j.k && j.cell == 0) {
    int o[3];
    tap_offset(j, tid - kRows, o);
    s_off[tid - kRows][0] = o[0] * j.stride;
    s_off[tid - kRows][1] = o[1] * j.stride;
    s_off[tid - kRows][2] = o[2] * j.stride;
  }
  if (tid < kRows) {
    int c[3] = {0, 0, 0};
    bool ok = false;
    if (tid < rows) {  // the flag and the coordinates loaded together
      const int* p = j.query + (qbase + tid) * 3;
      c[0] = p[0];
      c[1] = p[1];
      c[2] = p[2];
      ok = j.query_valid[qbase + tid];
    }
    if (ok && j.cell > 0) {
      int tap = 0;
#pragma unroll
      for (int a = 2; a >= 0; --a) {
        const int parent = c[a] >= 0 ? c[a] / j.cell * j.cell
                                     : -((-c[a] + j.cell - 1) / j.cell) *
                                           j.cell;
        tap = tap * j.size + (c[a] - parent) / j.stride;
        c[a] = parent;
      }
      s_tap[tid] = tap;
      ok = c[0] >= 0 && c[0] <= kMaxCoord && c[1] >= 0 &&
           c[1] <= kMaxCoord && c[2] >= 0 && c[2] <= kMaxCoord;
    }
    s_base[tid][0] = ok ? c[0] : INT_MIN;
    s_base[tid][1] = c[1];
    s_base[tid][2] = c[2];
    if (ok) kmin = kmax = lin(c[0], c[1], c[2]);
#pragma unroll
    for (int d = 16; d; d >>= 1) {
      kmin = min(kmin, __shfl_xor_sync(kFull, kmin, d));
      kmax = max(kmax, __shfl_xor_sync(kFull, kmax, d));
    }
    if (lane == 0) {
      s_lo[warp] = kmin;
      s_hi[warp] = kmax;
    }
  }
  __syncthreads();
  kmin = min(s_lo[0], s_lo[1]);
  kmax = max(s_hi[0], s_hi[1]);
  int* out = j.out + qbase * j.k;
  if (kmin > kmax) {  // no valid row: nothing to find
    for (int e = tid; e < rows * j.k; e += kThreads) out[e] = -1;
    return;
  }
  // (2) the window of the sorted table that holds every target: one warp
  // searches for each end
  if (warp < 2) {
    long long dlo = 0, dhi = 0;
    if (j.cell == 0) {
      dlo = LLONG_MAX;
      dhi = LLONG_MIN;
      for (int t = 0; t < j.k; ++t) {
        const long long d =
            lin(s_off[t][0], s_off[t][1], s_off[t][2]) - lin(0, 0, 0);
        dlo = min(dlo, d);
        dhi = max(dhi, d);
      }
    }
    const long long target = warp == 0 ? kmin + dlo : kmax + dhi + 1;
    const int at = warp_lower_bound(j, tbase, target, 0, j.m);
    if (lane == 0) s_window[warp] = at;
  }
  __syncthreads();
  const int lo = s_window[0], width = s_window[1] - lo;
  const bool shared = width <= kWindow;
  if (shared) {
    for (int e = tid; e < width; e += kThreads)
      s_keys[e] = key_at(j, tbase, lo + e);
    __syncthreads();
  }
  const Window win{j, tbase, shared ? s_keys : nullptr, lo, width};
  // (3) the lookups, neighbouring threads on neighbouring rows
  if (j.cell > 0) {
    if (tid < rows) {
      int p = 0;
      s_found[tid] = s_base[tid][0] == INT_MIN
                         ? -1
                         : win.find(&p, s_base[tid][0], s_base[tid][1],
                                    s_base[tid][2]);
    }
    __syncthreads();
    for (int e = tid; e < rows * j.k; e += kThreads) {
      const int r = e / j.k;
      out[e] = s_found[r] >= 0 && e - r * j.k == s_tap[r] ? s_found[r] : -1;
    }
    return;
  }
  if (j.offsets) {  // given offsets: a search a (row, tap)
    for (int e = tid; e < rows * j.k; e += kThreads) {
      const int r = e / j.k, t = e - r * j.k;
      int p = 0;
      out[e] = s_base[r][0] == INT_MIN
                   ? -1
                   : win.find(&p, s_base[r][0] + s_off[t][0],
                              s_base[r][1] + s_off[t][1],
                              s_base[r][2] + s_off[t][2]);
    }
    return;
  }
  // a cubic kernel: a thread a (row, x and y offset), its taps along z in
  // one run (their keys ascend, so each search starts where the last
  // ended: one binary search and a step or two a tap)
  const int s = j.size, groups = s * s, centre = (s & 1) ? (s - 1) / 2 : 0;
  const int tx = j.me_order ? 1 : groups, tz = j.me_order ? groups : 1;
  for (int e = tid; e < rows * groups; e += kThreads) {
    const int r = e / groups, g = e - r * groups;
    const int a = g % s, b = g / s;
    int* o = out + r * j.k + a * tx + b * s;
    const bool ok = s_base[r][0] != INT_MIN;
    const int x = s_base[r][0] + (a - centre) * j.stride;
    const int y = s_base[r][1] + (b - centre) * j.stride;
    int p = 0;
    for (int zi = 0; zi < s; ++zi)
      o[zi * tz] = ok ? win.find(&p, x, y,
                                 s_base[r][2] + (zi - centre) * j.stride)
                      : -1;
  }
}

}  // namespace

extern "C" {

// jobs: ``n`` (at most 8) packed Job structs in host memory, each writing
// every element of its (B, Q, K) int32 out; K at most 192.
int demf_kernel_map(const void* packed, int n, void* stream) {
  if (n < 1 || n > kMaxJobs) return static_cast<int>(cudaErrorInvalidValue);
  Jobs jobs;
  jobs.n = n;
  memcpy(jobs.job, packed, sizeof(Job) * n);
  long long blocks = 0;
  for (int i = 0; i < n; ++i) {
    Job& j = jobs.job[i];
    if (j.k < 1 || j.k > kMaxTaps)
      return static_cast<int>(cudaErrorInvalidValue);
    j.first_block = static_cast<int>(blocks);
    blocks += static_cast<long long>(j.b) * ((j.q + kRows - 1) / kRows);
  }
  if (blocks == 0) return 0;
  kernel_map_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(jobs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
