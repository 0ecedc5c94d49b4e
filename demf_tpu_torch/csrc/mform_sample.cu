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
// float32.)  A tensor-core form is a later redesign.
//
// Indices are clamped to [0, N).  Each product and sum is rounded on its
// own (__fmul_rn, __fadd_rn: no FMA), in k order, so the plain version in
// ops/mform.py gets the same bits.
//
// What bounds it on the card: the K row reads per query, hd elements each
// (64 B at hd 32 in bf16), scattered over the bh plane; the plane (1 MB per
// bh at the finest level) stays in L2.
//
// What this design does about it: one thread per (bh, q, j), so a warp
// reads one whole row per k with neighbouring lanes on neighbouring
// channels; the index and weight of (bh, k, q) are one broadcast load.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename P, typename W>
__global__ void __launch_bounds__(kThreads)
    mform_kernel(const P* __restrict__ plane, const int* __restrict__ idx,
                 const W* __restrict__ w, P* __restrict__ out, int n, int k,
                 int q, int hd, long long total) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int j = static_cast<int>(t % hd);
  const long long r = t / hd;
  const int qi = static_cast<int>(r % q);
  const long long b = r / q;
  const P* pb = plane + b * n * hd + j;
  const long long s0 = b * k * q + qi;  // (b, 0, qi) in (BH, K, Q)
  float acc = 0.0f;
  for (int kk = 0; kk < k; ++kk) {
    const long long s = s0 + static_cast<long long>(kk) * q;
    const int row = min(max(__ldg(idx + s), 0), n - 1);
    acc = __fadd_rn(acc, __fmul_rn(to_float(w[s]),
                                   to_float(pb[static_cast<long long>(row) *
                                               hd])));
  }
  store(out + t, acc);
}

template <typename P, typename W>
int launch(const void* plane, const void* idx, const void* w, void* out,
           int bh, int n, int k, int q, int hd, cudaStream_t stream) {
  const long long total = static_cast<long long>(bh) * q * hd;
  if (total == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  mform_kernel<P, W><<<blocks, kThreads, 0, stream>>>(
      static_cast<const P*>(plane), static_cast<const int*>(idx),
      static_cast<const W*>(w), static_cast<P*>(out), n, k, q, hd, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// plane: (BH, N, hd) float32 (plane_bf16 = 0) or bfloat16 (1); idx: (BH,
// K, Q) int32; w: (BH, K, Q) float32 (w_bf16 = 0) or bfloat16 (1); out:
// (BH, Q, hd) in the plane's dtype.  All contiguous.  Returns
// cudaErrorInvalidValue for a dtype code other than 0 or 1.
int demf_mform_sample(const void* plane, const void* idx, const void* w,
                      void* out, int bh, int n, int k, int q, int hd,
                      int plane_bf16, int w_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plane_bf16 == 0 && w_bf16 == 0)
    return launch<float, float>(plane, idx, w, out, bh, n, k, q, hd, st);
  if (plane_bf16 == 0 && w_bf16 == 1)
    return launch<float, __nv_bfloat16>(plane, idx, w, out, bh, n, k, q, hd,
                                        st);
  if (plane_bf16 == 1 && w_bf16 == 0)
    return launch<__nv_bfloat16, float>(plane, idx, w, out, bh, n, k, q, hd,
                                        st);
  if (plane_bf16 == 1 && w_bf16 == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(plane, idx, w, out, bh, n, k,
                                                q, hd, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
