// Exact ball query: the K nearest points inside a radius, one block per
// (batch, center).
//
// Replaces: demf_tpu/ops/grouping.py::ball_query with exact=True, the XLA op
// that builds the (B, M, N) squared-distance matrix and takes an exact top-k.
// Semantics: neighbours are the points with d2 < r^2 (strict), in ascending
// (d2, index) order; missing slots repeat the first hit and an empty
// neighbourhood gives index 0.  d2 = max(|a|^2 + |b|^2 - 2 a.b, 0), the
// formula of grouping._sqdist.
//
// What bounds it on the card: as cdist + topk the op writes and sorts a
// B x M x N float matrix (164 MB per scene at the first SA stage, M 2048 x
// N 20000), so it is bound by memory traffic.  Here each block streams the
// 240 KB point set of its scene (which stays in L2 across the M blocks of
// that scene) once and keeps only the in-radius candidates.
//
// What this design does about it: pass 1 computes every point's distance to
// the block's center and appends the in-radius ones, as (d2, index) pairs,
// to a shared-memory list.  Pass 2 runs K rounds of a block-wide
// lexicographic argmin over that list, each round taking the smallest pair
// above the previous pick, so no "taken" flags are needed.  If more than
// kCap points fall inside the radius, the rounds scan the whole point set
// from global memory instead: slower, same answer.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCap = 4096;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__device__ __forceinline__ float point_d2(const float* p, int i, float cx,
                                          float cy, float cz, float c2) {
  const float x = __ldg(p + 3 * i);
  const float y = __ldg(p + 3 * i + 1);
  const float z = __ldg(p + 3 * i + 2);
  const float ab = __fadd_rn(__fadd_rn(__fmul_rn(cx, x), __fmul_rn(cy, y)),
                             __fmul_rn(cz, z));
  const float d2 = __fsub_rn(__fadd_rn(c2, sq3(x, y, z)), __fmul_rn(2.0f, ab));
  return fmaxf(d2, 0.0f);
}

// (d, i) strictly after (pd, pi) in ascending lexicographic order
__device__ __forceinline__ bool after(float d, int i, float pd, int pi) {
  return d > pd || (d == pd && i > pi);
}

__device__ __forceinline__ bool before(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// Block-wide lexicographic argmin; every thread gets the result.
__device__ __forceinline__ void block_argmin(float& bd, int& bi, float* s_d,
                                             int* s_i) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_down_sync(0xffffffffu, bd, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (before(od, oi, bd, bi)) {
      bd = od;
      bi = oi;
    }
  }
  if (lane == 0) {
    s_d[warp] = bd;
    s_i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bd = lane < kWarps ? s_d[lane] : INFINITY;
    bi = lane < kWarps ? s_i[lane] : 0x7fffffff;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_down_sync(0xffffffffu, bd, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (before(od, oi, bd, bi)) {
        bd = od;
        bi = oi;
      }
    }
    if (lane == 0) {
      s_d[kWarps] = bd;
      s_i[kWarps] = bi;
    }
  }
  __syncthreads();
  bd = s_d[kWarps];
  bi = s_i[kWarps];
  __syncthreads();  // s_d / s_i are reused by the next round
}

__global__ void __launch_bounds__(kThreads)
    ball_query_kernel(const float* __restrict__ points,
                      const float* __restrict__ centers,
                      long long* __restrict__ out, int n, int m, int k,
                      float r2) {
  const int b = blockIdx.y;
  const int c = blockIdx.x;
  const float* p = points + static_cast<long long>(b) * n * 3;
  const float* q = centers + (static_cast<long long>(b) * m + c) * 3;
  long long* o = out + (static_cast<long long>(b) * m + c) * k;

  __shared__ float s_cd[kCap];
  __shared__ int s_ci[kCap];
  __shared__ float s_d[kWarps + 1];
  __shared__ int s_i[kWarps + 1];
  __shared__ int s_count;

  const float cx = q[0], cy = q[1], cz = q[2];
  const float c2 = sq3(cx, cy, cz);
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();

  // pass 1: gather the in-radius candidates
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float d2 = point_d2(p, i, cx, cy, cz, c2);
    if (d2 < r2) {
      const int slot = atomicAdd(&s_count, 1);
      if (slot < kCap) {
        s_cd[slot] = d2;
        s_ci[slot] = i;
      }
    }
  }
  __syncthreads();
  const int count = s_count;
  const bool in_smem = count <= kCap;

  // pass 2: K rounds of "smallest pair after the previous pick"
  float pd = -1.0f;
  int pi = -1;
  int found = 0;
  for (; found < k && found < count; ++found) {
    float bd = INFINITY;
    int bi = 0x7fffffff;
    if (in_smem) {
      for (int j = threadIdx.x; j < count; j += kThreads) {
        const float d = s_cd[j];
        const int i = s_ci[j];
        if (after(d, i, pd, pi) && before(d, i, bd, bi)) {
          bd = d;
          bi = i;
        }
      }
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const float d = point_d2(p, i, cx, cy, cz, c2);
        if (d < r2 && after(d, i, pd, pi) && before(d, i, bd, bi)) {
          bd = d;
          bi = i;
        }
      }
    }
    block_argmin(bd, bi, s_d, s_i);
    if (threadIdx.x == 0) o[found] = bi;
    pd = bd;
    pi = bi;
  }
  // pad: repeat the first hit, or 0 for an empty neighbourhood
  if (threadIdx.x == 0) {
    const long long pad = found > 0 ? o[0] : 0;
    for (int j = found; j < k; ++j) o[j] = pad;
  }
}

}  // namespace

extern "C" {

// points: (B, N, 3) f32, centers: (B, M, 3) f32, out: (B, M, K) int64.
int demf_ball_query(const void* points, const void* centers, void* out,
                    int b, int n, int m, int k, float r2, void* stream) {
  if (b == 0 || m == 0) return 0;
  dim3 grid(m, b);
  ball_query_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const float*>(centers),
      static_cast<long long*>(out), n, m, k, r2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
