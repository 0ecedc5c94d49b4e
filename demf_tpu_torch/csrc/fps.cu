// Furthest point sampling, one thread block per batch element.
//
// Replaces: demf_tpu/ops/pallas/fps.py::furthest_point_sample_pallas
// (body _fps_kernel), the TPU kernel that keeps coordinates and the running
// min-distance vector in VMEM for the whole selection loop.
//
// What bounds it on the card: K dependent steps, each a pass over N points
// and a block-wide argmax.  The steps cannot overlap, so only B SMs work and
// the time is K x (one pass over N + two block barriers).  At N = 20000 the
// coordinates (240 KB) and distances (80 KB) do not fit one block's 227 KB of
// shared memory together, and at 1024 threads a thread may hold only 64
// registers, so they do not both fit in registers either.
//
// What this design does about it: each thread owns the points
// i = tid + k * 1024 and keeps their running distances in registers (PPT
// per thread, a compile-time count so the array stays in registers).  The
// coordinates are re-read every step through the read-only path, where the
// 240 KB working set stays in the SM's L1 (the block asks for almost no
// shared memory).  The argmax keeps the lowest index on ties, like
// torch.argmax, and the distance is rounded as (dx*dx + dy*dy) + dz*dz with
// the _rn intrinsics so nothing is contracted into an FMA: the picks equal
// the plain PyTorch version bit for bit.  Using more than B SMs (a cluster
// per batch element) is left to a later change.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ float sqdist(float x, float y, float z, float lx,
                                        float ly, float lz) {
  const float dx = __fsub_rn(x, lx);
  const float dy = __fsub_rn(y, ly);
  const float dz = __fsub_rn(z, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

template <int PPT>
__global__ void __launch_bounds__(kThreads)
    fps_kernel(const float* __restrict__ xyz, long long* __restrict__ out,
               int n, int k) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* p = xyz + static_cast<long long>(b) * n * 3;
  long long* o = out + static_cast<long long>(b) * k;

  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ int s_next;

  float dist[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    // padded slots hold -1 and can never win against a real distance >= 0
    dist[j] = (tid + j * kThreads < n) ? 1e10f : -1.0f;
  }
  if (tid == 0) o[0] = 0;
  int last = 0;

  for (int step = 1; step < k; ++step) {
    const float lx = __ldg(p + 3 * last);
    const float ly = __ldg(p + 3 * last + 1);
    const float lz = __ldg(p + 3 * last + 2);
    float bv = -2.0f;
    int bi = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int i = tid + j * kThreads;
      if (i < n) {
        const float d = sqdist(__ldg(p + 3 * i), __ldg(p + 3 * i + 1),
                               __ldg(p + 3 * i + 2), lx, ly, lz);
        dist[j] = fminf(dist[j], d);
        // i grows with j, so a strict > keeps the lowest index on ties
        if (dist[j] > bv) {
          bv = dist[j];
          bi = i;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      s_val[warp] = bv;
      s_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = s_val[lane];
      bi = s_idx[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        s_next = bi;
        o[step] = bi;
      }
    }
    __syncthreads();
    last = s_next;
  }
}

template <int PPT>
cudaError_t launch(const float* xyz, long long* out, int b, int n, int k,
                   cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    // ask for the largest L1 share: the coordinates are re-read every step
    cudaFuncSetAttribute(fps_kernel<PPT>,
                         cudaFuncAttributePreferredSharedMemoryCarveout, 0);
    configured = true;
  }
  fps_kernel<PPT><<<b, kThreads, 0, stream>>>(xyz, out, n, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xyz: (B, N, 3) float32 contiguous, N <= 32 * 1024; out: (B, K) int64.
int demf_fps(const void* xyz, void* out, int b, int n, int k, void* stream) {
  const float* x = static_cast<const float*>(xyz);
  long long* o = static_cast<long long*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ppt = (n + kThreads - 1) / kThreads;
  cudaError_t err;
  if (ppt <= 1) err = launch<1>(x, o, b, n, k, s);
  else if (ppt <= 2) err = launch<2>(x, o, b, n, k, s);
  else if (ppt <= 4) err = launch<4>(x, o, b, n, k, s);
  else if (ppt <= 8) err = launch<8>(x, o, b, n, k, s);
  else if (ppt <= 16) err = launch<16>(x, o, b, n, k, s);
  else if (ppt <= 20) err = launch<20>(x, o, b, n, k, s);
  else if (ppt <= 32) err = launch<32>(x, o, b, n, k, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
