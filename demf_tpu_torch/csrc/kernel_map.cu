// The kernel map of a sparse convolution: out[b, q, t] = the row of scene
// b's voxel table whose coordinate is coords[b, q] + offsets[t] * stride,
// or -1 where there is none (or the query row is invalid).
//
// Replaces: demf_tpu/ops/sparse.py::neighbor_table_batched (and the
// transposed conv's parent lookup, transposed_conv_to_batched), XLA code:
// a bucketed compare of each query key against 128-key lines of the sorted
// table, or the z-run form that resolves three taps from one line, both
// shaped for the TPU's gathers.  Both give the exact match of the key.
//
// What bounds it on the card: the bytes are few (a query's 12 bytes and
// valid flag, a 4-byte row a tap; the table's keys once) and so are the
// operations; what costs is the dependent chain of a binary search, 15
// steps over a scene's 32,768 keys, each a load that hits L2 (a table is
// 128 KB) or L1.  The design: a thread a (query, tap), so that the chains
// of many threads overlap; neighbouring threads take the taps of one query
// and then the next query, whose keys lie close, so their searches walk
// the same lines of the table.  The table is sorted with padding rows last
// at key INT32_MAX, which no query key reaches (a key is at most
// 1290^3 - 1); a query coordinate off [0, MAX_COORD] on any axis finds
// nothing, as the JAX package's clamped lookup finds nothing there.
#include <cuda_runtime.h>

namespace {

constexpr int kSpan = 1290;
constexpr int kShift = 16;
constexpr int kMaxCoord = kSpan - kShift - 2;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    kernel_map_kernel(const int* __restrict__ skeys,
                      const int* __restrict__ order,
                      const int* __restrict__ coords,
                      const unsigned char* __restrict__ valid,
                      const int* __restrict__ offsets, int* __restrict__ out,
                      int m, int q, int k, int stride) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  const long long per_scene = static_cast<long long>(q) * k;
  if (i >= per_scene) return;
  const int row = static_cast<int>(i / k);
  const int t = static_cast<int>(i - static_cast<long long>(row) * k);
  const long long qi = static_cast<long long>(b) * q + row;
  int found = -1;
  if (valid[qi]) {
    const int x = coords[qi * 3 + 0] + offsets[t * 3 + 0] * stride;
    const int y = coords[qi * 3 + 1] + offsets[t * 3 + 1] * stride;
    const int z = coords[qi * 3 + 2] + offsets[t * 3 + 2] * stride;
    if (x >= 0 && x <= kMaxCoord && y >= 0 && y <= kMaxCoord && z >= 0 &&
        z <= kMaxCoord) {
      const int key = ((x + kShift) * kSpan + (y + kShift)) * kSpan +
                      (z + kShift);
      const int* keys = skeys + static_cast<long long>(b) * m;
      // the first position whose key is not below the query's
      int lo = 0, hi = m;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(keys + mid) < key)
          lo = mid + 1;
        else
          hi = mid;
      }
      if (lo < m && __ldg(keys + lo) == key)
        found = order ? __ldg(order + static_cast<long long>(b) * m + lo)
                      : lo;
    }
  }
  out[static_cast<long long>(b) * per_scene + i] = found;
}

}  // namespace

extern "C" {

// skeys (B, M) int32, sorted; order (B, M) int32 or null (the row is the
// position); coords (B, Q, 3) int32; valid (B, Q) bool; offsets (K, 3)
// int32; out (B, Q, K) int32, every element written.
int demf_kernel_map(const void* skeys, const void* order, const void* coords,
                    const void* valid, const void* offsets, void* out, int b,
                    int m, int q, int k, int stride, void* stream) {
  const long long per_scene = static_cast<long long>(q) * k;
  if (b == 0 || per_scene == 0) return 0;
  const dim3 grid(static_cast<unsigned>((per_scene + kThreads - 1) / kThreads),
                  b);
  kernel_map_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(skeys), static_cast<const int*>(order),
      static_cast<const int*>(coords),
      static_cast<const unsigned char*>(valid),
      static_cast<const int*>(offsets), static_cast<int*>(out), m, q, k,
      stride);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
