// M-form MSDA sampling as a weighted gather-sum:
//
//   out[bh, q, j] = sum_k w[bh, k, q] * plane[bh, idx[bh, k, q], j],
//
// accumulated in float32 and rounded once to the plane's dtype.
//
// Replaces: tools/bench_msda_matmul.py::mform_sample (body _mform_kernel).
// The TPU kernel builds, for every (query tile, plane tile), the weighted
// one-hot matrix M (Q_t x N_t, K hits a row) in registers and multiplies it
// with the plane tile on the MXU: ~N/K times the useful arithmetic, paid
// because the MXU is fast and the TPU's per-row gather is slow.  Hopper
// gathers rows directly, so this kernel reads only the K rows it needs and
// never forms M.  (The TPU kernel sums M in bf16, so two hits on one plane
// row round twice there; this kernel rounds each product and sum in
// float32.)
//
// Indices are clamped to [0, N).  Each product and sum is rounded on its
// own (__fmul_rn, __fadd_rn: no FMA), in k order, so the plain version in
// ops/mform.py gets the same bits.
//
// What bounds it on the card: the K row reads per query, hd elements each
// (64 B at hd 32 in bf16), scattered over the bh plane, and the number of
// loads that fetch them.  A plane of 1 MB a bh (the finest level) is
// served by L2, and 16 rows a query at the probe's size are 2.95 GB from
// there: the kernel then runs at about the L2's rate; a plane of 96 KB or
// less is served by L1.
//
// What this design does about it:
// - A thread owns 16 bytes of a query's output row (8 bf16 or 4 f32
//   channels), so a slot costs it one 16-byte load of the plane
//   (ld.global.nc) and the output one 16-byte store.  The k loop runs in
//   unrolled groups of kUnroll slots whose loads all start before
//   the first sum.
// - A block owns a tile of consecutive queries of one bh.  Its warps copy
//   the tile's K rows of indices and weights from the K-major (BH, K, Q)
//   arrays into shared memory, 16 bytes a lane where the row starts at a
//   16-byte boundary, so every sector is read once and used whole; the
//   indices are clamped as they arrive and kept as row offsets, so a slot
//   costs a thread two shared-memory loads and one address.  Several
//   blocks fit an SM (48 KB of shared memory at 512 queries of 16 slots),
//   so one block's copy overlaps another's sums.
// - The rows come from L1 / L2.  (A block that first copied its bh's whole
//   plane into shared memory and served all of that bh's tiles from there
//   was slower on the H100 wherever the plane fits, 0.58-0.59 ms against
//   0.46-0.47 for this mapping at the two coarsest levels in bf16: the one
//   or two such blocks an SM holds cannot overlap their copies with their
//   sums, and the rows of a plane that small come from L1 as fast as from
//   shared memory.  It was taken out again.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 8;
constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 232448;   // what a block may use on sm_90

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// acc[0 .. V) += w * (the V channels packed in 16 bytes)
__device__ __forceinline__ void add_row(float* acc, const uint4& v, float w,
                                        const float*) {
  acc[0] = __fadd_rn(acc[0], __fmul_rn(w, __uint_as_float(v.x)));
  acc[1] = __fadd_rn(acc[1], __fmul_rn(w, __uint_as_float(v.y)));
  acc[2] = __fadd_rn(acc[2], __fmul_rn(w, __uint_as_float(v.z)));
  acc[3] = __fadd_rn(acc[3], __fmul_rn(w, __uint_as_float(v.w)));
}
__device__ __forceinline__ void add_row(float* acc, const uint4& v, float w,
                                        const __nv_bfloat16*) {
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a bf16 is the upper half of its float32
    acc[2 * i] = __fadd_rn(acc[2 * i],
                           __fmul_rn(w, __uint_as_float(u[i] << 16)));
    acc[2 * i + 1] = __fadd_rn(
        acc[2 * i + 1], __fmul_rn(w, __uint_as_float(u[i] & 0xffff0000u)));
  }
}

__device__ __forceinline__ uint4 pack_row(const float* acc, const float*) {
  return make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]),
                    __float_as_uint(acc[2]), __float_as_uint(acc[3]));
}
__device__ __forceinline__ uint4 pack_row(const float* acc,
                                          const __nv_bfloat16*) {
  unsigned u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    u[i] = static_cast<unsigned>(
               __bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * i]))) |
           (static_cast<unsigned>(
                __bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * i + 1])))
            << 16);
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// An index clamped to [0, n) as the offset of its row in 16-byte pieces
__device__ __forceinline__ int row_offset(int i, int n, int tq) {
  return min(max(i, 0), n - 1) * tq;
}

// One warp copies `count` indices of one k as row offsets
__device__ __forceinline__ void stage_idx(int* dst, const int* src, int count,
                                          int lane, int n, int tq) {
  int done = 0;
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int vec = count >> 2;
    for (int i = lane; i < vec; i += 32) {
      int4 v = __ldg(reinterpret_cast<const int4*>(src) + i);
      v.x = row_offset(v.x, n, tq);
      v.y = row_offset(v.y, n, tq);
      v.z = row_offset(v.z, n, tq);
      v.w = row_offset(v.w, n, tq);
      reinterpret_cast<int4*>(dst)[i] = v;
    }
    done = vec << 2;
  }
  for (int i = done + lane; i < count; i += 32)
    dst[i] = row_offset(src[i], n, tq);
}

// One warp copies `count` weights of one k
template <typename W>
__device__ __forceinline__ void stage_w(W* dst, const W* src, int count,
                                        int lane) {
  constexpr int kPer = 16 / sizeof(W);
  int done = 0;
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int vec = count / kPer;
    for (int i = lane; i < vec; i += 32)
      reinterpret_cast<uint4*>(dst)[i] =
          __ldg(reinterpret_cast<const uint4*>(src) + i);
    done = vec * kPer;
  }
  for (int i = done + lane; i < count; i += 32) dst[i] = src[i];
}

// One block a (bh, query tile).  Shared memory: K x q_tile row offsets, then
// K x q_tile weights; q_tile is a multiple of 8, so both start at a 16-byte
// boundary.
template <typename P, typename W>
__global__ void __launch_bounds__(kMaxThreads)
    mform_kernel(const P* __restrict__ plane, const int* __restrict__ idx,
                 const W* __restrict__ w, P* __restrict__ out, int n, int k,
                 int q, int hd, int q_tile, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kV = 16 / sizeof(P);   // channels a thread owns
  int* s_idx = reinterpret_cast<int*>(smem);
  W* s_w = reinterpret_cast<W*>(s_idx + k * q_tile);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int bh = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - bh * tiles) * q_tile;
  const int count = min(q_tile, q - q0);
  const int tq = hd / kV;   // threads a query
  // the bh's plane as rows of tq 16-byte pieces
  const uint4* rows = reinterpret_cast<const uint4*>(
      plane + static_cast<long long>(bh) * n * hd);

  for (int kk = warp; kk < k; kk += warps) {
    const long long at = (static_cast<long long>(bh) * k + kk) * q + q0;
    stage_idx(s_idx + kk * q_tile, idx + at, count, lane, n, tq);
    stage_w(s_w + kk * q_tile, w + at, count, lane);
  }
  __syncthreads();

  const P* const tag = nullptr;   // picks the overloads of the plane's dtype
  for (int it = threadIdx.x; it < count * tq; it += blockDim.x) {
    const int ql = it / tq;
    const uint4* piece = rows + (it - ql * tq);
    const int* si = s_idx + ql;   // the query's slots lie q_tile apart
    const W* sw = s_w + ql;
    float acc[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) acc[i] = 0.0f;
    int kk = 0;
    for (; kk + kUnroll <= k; kk += kUnroll) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = __ldg(piece + static_cast<unsigned>(si[u * q_tile]));
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        add_row(acc, v[u], to_float(sw[u * q_tile]), tag);
      si += kUnroll * q_tile;
      sw += kUnroll * q_tile;
    }
    for (; kk < k; ++kk) {
      add_row(acc, __ldg(piece + static_cast<unsigned>(*si)), to_float(*sw),
              tag);
      si += q_tile;
      sw += q_tile;
    }
    reinterpret_cast<uint4*>(
        out + (static_cast<long long>(bh) * q + q0 + ql) * hd)[it - ql * tq] =
        pack_row(acc, tag);
  }
}

template <typename P, typename W>
int launch(const void* plane, const void* idx, const void* w, void* out,
           int bh, int n, int k, int q, int hd, int q_tile, int threads,
           cudaStream_t stream) {
  // a row is a whole number of 16-byte pieces, read and written as such
  if (hd < 1 || (hd * sizeof(P)) % 16 ||
      (reinterpret_cast<uintptr_t>(plane) | reinterpret_cast<uintptr_t>(out)) %
          16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (q + q_tile - 1) / q_tile;
  const long long smem = static_cast<long long>(k) * q_tile * (4 + sizeof(W));
  // blocks and a plane's 16-byte pieces are counted in 32 bits
  if (smem > kMaxSmem || static_cast<long long>(bh) * tiles > 0x7fffffffll ||
      static_cast<long long>(n) * hd * sizeof(P) / 16 > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidValue);
  static long long allowed = 0;   // dynamic shared memory asked for so far
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        mform_kernel<P, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  mform_kernel<P, W><<<static_cast<unsigned>(bh) * tiles, threads,
                       static_cast<size_t>(smem), stream>>>(
      static_cast<const P*>(plane), static_cast<const int*>(idx),
      static_cast<const W*>(w), static_cast<P*>(out), n, k, q, hd, q_tile,
      tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// plane: (BH, N, hd) float32 (plane_bf16 = 0) or bfloat16 (1), rows a
// multiple of 16 bytes, at a 16-byte boundary; idx: (BH, K, Q) int32; w: (BH,
// K, Q) float32 (w_bf16 = 0) or bfloat16 (1); out: (BH, Q, hd) in the
// plane's dtype, at a 16-byte boundary.  All contiguous.  A block of
// `threads` (up to 512) takes a query tile of `q_tile` (a multiple of 8).
// Returns cudaErrorInvalidValue for a dtype code, a width, a pointer or a
// launch shape it cannot run, among them one whose shared memory a block
// cannot hold.
int demf_mform_sample(const void* plane, const void* idx, const void* w,
                      void* out, int bh, int n, int k, int q, int hd,
                      int plane_bf16, int w_bf16, int q_tile, int threads,
                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh < 0 || n < 0 || k < 0 || (n == 0 && k > 0) || q < 0 ||
      q_tile < 8 || q_tile % 8 || threads < 32 || threads > kMaxThreads ||
      threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((plane_bf16 | w_bf16) & ~1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bh == 0 || q == 0) return 0;
  if (plane_bf16 == 0 && w_bf16 == 0)
    return launch<float, float>(plane, idx, w, out, bh, n, k, q, hd, q_tile,
                                threads, st);
  if (plane_bf16 == 0 && w_bf16 == 1)
    return launch<float, __nv_bfloat16>(plane, idx, w, out, bh, n, k, q, hd,
                                        q_tile, threads, st);
  if (plane_bf16 == 1 && w_bf16 == 0)
    return launch<__nv_bfloat16, float>(plane, idx, w, out, bh, n, k, q, hd,
                                        q_tile, threads, st);
  return launch<__nv_bfloat16, __nv_bfloat16>(plane, idx, w, out, bh, n, k, q,
                                              hd, q_tile, threads, st);
}

}  // extern "C"
