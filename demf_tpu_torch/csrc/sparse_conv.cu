// Gather-GEMM sparse convolution, forward: out[b, m, :] = sum over taps t
// of feats[b, nbr[b, m, t], :] @ W[t], a tap whose row is -1 adding 0.
// feats (B, M_in, C), nbr (B, M_out, K) int32, W (K, C, C_out); float32 or
// bfloat16 rows and weights (one dtype), float32 sums, the output in their
// dtype.
//
// Replaces: demf_tpu/ops/sparse.py::_conv_scan_math (reached through
// sparse_conv_apply_batched), XLA code: a scan over the K taps, each a row
// gather of (B * M_out, C) and one (C, C_out) matmul on the MXU, the sum
// kept in the rows' dtype.  Every convolution of MinkResNet and of the
// FCAF3D head goes through it (K 27, 8 or 1).
//
// What bounds it on the card: operations.  At full width (capacities
// 16,384 to 512 rows, C 3 to 512) a scene is ~110 GFLOP when every tap of
// every row exists, against ~1.6 ms at 67 TFLOP/s float32; the bytes (the
// features and weights read once, the output written once) are a few
// hundred MB at most.  What a scene really needs is the taps that exist:
// on real clouds most of a submanifold conv's 27 taps are absent.
//
// The design, the simple one: a block a tile of 64 output rows x 64 output
// channels of one scene, 256 threads each with a 4 x 4 tile of sums in
// float32 registers.  For each tap the block reads the tile's 64
// neighbour rows; a tap that none of them has is skipped whole (so are the
// padding rows past a scene's valid prefix, whose taps are all -1).
// Otherwise, 16 input channels at a time, the 64 gathered rows (0 for an
// absent one) and the tap's 16 x 64 slice of W are staged in shared memory
// as float32 and every thread adds its 4 x 4 products.  No tensor cores,
// no TMA: a later version would gather through cp.async into a ring of
// tiles and multiply with wgmma.  The sums are taken in another order than
// the plain version's (tap by tap, each a matmul), so the two agree to a
// float32 rounding of the sum, not bit for bit; a bfloat16 output is the
// float32 sum rounded once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;     // output rows a block
constexpr int kCols = 64;     // output channels a block
constexpr int kDepth = 16;    // input channels a step
constexpr int kThreads = 256;
constexpr int kPad = 4;       // keeps the float4 rows aligned, halves
                              // the bank conflicts of the gather's stores

__device__ inline float widen(float v) { return v; }
__device__ inline float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sparse_conv_kernel(const T* __restrict__ feats,
                       const int* __restrict__ nbr, const T* __restrict__ w,
                       T* __restrict__ out, int m_in, int c, int m_out,
                       int k, int c_out) {
  __shared__ __align__(16) float s_a[kDepth][kRows + kPad];
  __shared__ __align__(16) float s_b[kDepth][kCols];
  __shared__ int s_idx[kRows];

  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kRows;
  const int col0 = blockIdx.y * kCols;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;   // rows ty*4.., cols tx*4..
  const T* scene = feats + static_cast<long long>(b) * m_in * c;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < k; ++t) {
    int idx = -1;
    if (tid < kRows) {
      const int r = row0 + tid;
      if (r < m_out) idx = nbr[(static_cast<long long>(b) * m_out + r) * k + t];
      s_idx[tid] = idx;
    }
    // a tap that no row of the tile has costs one vote
    if (!__syncthreads_or(idx >= 0)) continue;
    const T* wt = w + static_cast<long long>(t) * c * c_out;
    for (int c0 = 0; c0 < c; c0 += kDepth) {
      // the gathered rows: a row's 16 channels side by side in 16 threads
      for (int e = tid; e < kRows * kDepth; e += kThreads) {
        const int r = e / kDepth, cc = e % kDepth;
        const int src = s_idx[r];
        float v = 0.f;
        if (src >= 0 && c0 + cc < c)
          v = widen(scene[static_cast<long long>(src) * c + c0 + cc]);
        s_a[cc][r] = v;
      }
      for (int e = tid; e < kDepth * kCols; e += kThreads) {
        const int kk = e / kCols, n = e % kCols;
        float v = 0.f;
        if (c0 + kk < c && col0 + n < c_out)
          v = widen(wt[static_cast<long long>(c0 + kk) * c_out + col0 + n]);
        s_b[kk][n] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&s_a[kk][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&s_b[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= m_out) continue;
    T* dst = out + (static_cast<long long>(b) * m_out + r) * c_out;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = col0 + tx * 4 + j;
      if (n < c_out) store(dst + n, acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* feats, const void* nbr, const void* w, void* out,
           int b, int m_in, int c, int m_out, int k, int c_out,
           void* stream) {
  if (b == 0 || m_out == 0 || c_out == 0) return 0;
  const dim3 grid((m_out + kRows - 1) / kRows, (c_out + kCols - 1) / kCols,
                  b);
  sparse_conv_kernel<T><<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(feats), static_cast<const int*>(nbr),
      static_cast<const T*>(w), static_cast<T*>(out), m_in, c, m_out, k,
      c_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// feats (B, M_in, C), nbr (B, M_out, K) int32, w (K, C, C_out), out (B,
// M_out, C_out), every element written; float32 here, bfloat16 in
// demf_sparse_conv_bf16.
int demf_sparse_conv(const void* feats, const void* nbr, const void* w,
                     void* out, int b, int m_in, int c, int m_out, int k,
                     int c_out, void* stream) {
  return launch<float>(feats, nbr, w, out, b, m_in, c, m_out, k, c_out,
                       stream);
}

int demf_sparse_conv_bf16(const void* feats, const void* nbr, const void* w,
                          void* out, int b, int m_in, int c, int m_out,
                          int k, int c_out, void* stream) {
  return launch<__nv_bfloat16>(feats, nbr, w, out, b, m_in, c, m_out, k,
                               c_out, stream);
}

}  // extern "C"
