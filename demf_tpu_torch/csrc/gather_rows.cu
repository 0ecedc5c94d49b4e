// Row gather: rows[bh, s] = plane[bh, idx[bh, s]] over (BH, N, C) planes.
//
// Replaces: demf_tpu/ops/pallas/gather_rows.py::gather_rows (stage-and-
// select) and tools/bench_gather_kernel.py::pallas_gather (compare /
// select / reduce), two TPU forms of the same function.  On the TPU a
// dynamic single-row read of VMEM is not allowed, so both read aligned
// blocks of 8 or 16 rows and select the wanted row afterwards; Hopper
// reads any 16-byte-aligned address, so this kernel copies the row as is
// and needs no alignment of N (pallas_gather reads wrong rows from the last
// partial block when N is not a multiple of its block).
//
// The kernel copies bytes: any dtype works as long as a row is a whole
// number of 16-byte vectors (C % 128 == 0 gives that for bf16 and f32).
// Indices are clamped to [0, N), as JAX's gather clamps them.
//
// What bounds it on the card: memory traffic.  Each gathered row is read
// (from L2 when the bh plane fits there: 22,336 x 128 bf16 = 5.7 MB) and
// written once to device memory; the output (2.95 GB at BH 128, S 90,112)
// dwarfs the planes.
//
// What this design does about it: one thread per 16-byte vector of an
// output row, so a warp moves two bf16 rows or one f32 row with full
// 16-byte loads and stores, neighbouring lanes on neighbouring addresses.
// The index is one broadcast load per row.  Stores are streaming
// (__stcs), so the output does not evict the planes from L2.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const uint4* __restrict__ plane,
                       const int* __restrict__ idx, uint4* __restrict__ out,
                       int n, int s, int vecs, long long total) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int v = static_cast<int>(t % vecs);
  const long long row = t / vecs;  // bh * s + sample
  const long long bh = row / s;
  const int r = min(max(__ldg(idx + row), 0), n - 1);
  __stcs(out + t, __ldg(plane + (bh * n + r) * vecs + v));
}

}  // namespace

extern "C" {

// plane: (BH, N, row_bytes) of any dtype, 16-byte aligned; idx: (BH, S)
// int32; out: (BH, S, row_bytes).  row_bytes must be a multiple of 16.
int demf_gather_rows(const void* plane, const void* idx, void* out, int bh,
                     int n, int s, int row_bytes, void* stream) {
  const int vecs = row_bytes / 16;
  const long long total = static_cast<long long>(bh) * s * vecs;
  if (total == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  gather_rows_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(plane), static_cast<const int*>(idx),
      static_cast<uint4*>(out), n, s, vecs, total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
