// MSDA weighted slot fold: the reduction of gathered quad rows to one
// head_dim vector per query,
//
//   out[bh, q, j] = sum_lp sum_slot rows[bh, lp, q, slot*hd + j]
//                                   * w[bh, lp, q, slot],
//
// accumulated in float32.
//
// Replaces: demf_tpu/ops/pallas/msda_fold.py::weighted_slot_fold and
// ::weighted_slot_fold_batched, and the fold prototype
// tools/bench_msda_layer.py::main18.pallas_fold.  The TPU kernels build
// the weight tile and the slot sum as matmuls with 0/1 selector matrices
// (the MXU is idle there) and carry the LP sum in scratch across a
// sequential grid axis; here the slot sum is a loop and one thread owns an
// output element for the whole LP sum.
//
// Rows come in float32 or bfloat16, weights in float32 or bfloat16 with
// their own element strides, so the (LP, Q, 4) layout of msda_fold.py and
// the slot-major (LP, 4, Q) layout of main18 read without a copy.  Each
// product and sum is rounded on its own (__fmul_rn, __fadd_rn: no FMA), in
// lp-major then slot order, so the plain version in ops/msda_fold.py gets
// the same bits.
//
// What bounds it on the card: reading the rows (1.48 GB of bf16 rows for
// 16 slices at the encoder shape); the weights are 1/hd of that and the
// arithmetic is one multiply-add per element read.
//
// What this design does about it: one thread per (bh, q, j), so a warp
// reads 32 neighbouring channels of one slot of one row (64 B in bf16,
// 128 B in f32) and the weight is one broadcast load.  Wider loads (two
// bf16 channels a thread) are left to a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename R, typename W>
__global__ void __launch_bounds__(kThreads)
    slot_fold_kernel(const R* __restrict__ rows, const W* __restrict__ w,
                     float* __restrict__ out, int lp, int q, int hd,
                     long long wb, long long wl, long long wq, long long ws,
                     long long total) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int j = static_cast<int>(t % hd);
  const long long r = t / hd;
  const int qi = static_cast<int>(r % q);
  const long long b = r / q;
  const long long row_len = 4LL * hd;
  const R* row = rows + (b * lp * q + qi) * row_len + j;
  const W* wt = w + b * wb + qi * wq;
  float acc = 0.0f;
  for (int l = 0; l < lp; ++l) {
    const R* rl = row + static_cast<long long>(l) * q * row_len;
    const W* wlp = wt + l * wl;
    for (int slot = 0; slot < 4; ++slot) {
      acc = __fadd_rn(acc, __fmul_rn(to_float(rl[slot * hd]),
                                     to_float(wlp[slot * ws])));
    }
  }
  out[t] = acc;
}

template <typename R, typename W>
int launch(const void* rows, const void* w, void* out, int bh, int lp, int q,
           int hd, long long wb, long long wl, long long wq, long long ws,
           cudaStream_t stream) {
  const long long total = static_cast<long long>(bh) * q * hd;
  if (total == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  slot_fold_kernel<R, W><<<blocks, kThreads, 0, stream>>>(
      static_cast<const R*>(rows), static_cast<const W*>(w),
      static_cast<float*>(out), lp, q, hd, wb, wl, wq, ws, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rows: (BH, LP, Q, 4*hd) contiguous, float32 (rows_bf16 = 0) or bfloat16
// (1); w: the weight of (bh, lp, q, slot) at w + bh*wb + lp*wl + q*wq +
// slot*ws (element strides), float32 (w_bf16 = 0) or bfloat16 (1);
// out: (BH, Q, hd) float32.  Returns cudaErrorInvalidValue for a dtype
// code other than 0 or 1.
int demf_msda_fold(const void* rows, const void* w, void* out, int bh,
                   int lp, int q, int hd, long long wb, long long wl,
                   long long wq, long long ws, int rows_bf16, int w_bf16,
                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows_bf16 == 0 && w_bf16 == 0)
    return launch<float, float>(rows, w, out, bh, lp, q, hd, wb, wl, wq, ws,
                                st);
  if (rows_bf16 == 0 && w_bf16 == 1)
    return launch<float, __nv_bfloat16>(rows, w, out, bh, lp, q, hd, wb, wl,
                                        wq, ws, st);
  if (rows_bf16 == 1 && w_bf16 == 0)
    return launch<__nv_bfloat16, float>(rows, w, out, bh, lp, q, hd, wb, wl,
                                        wq, ws, st);
  if (rows_bf16 == 1 && w_bf16 == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(rows, w, out, bh, lp, q, hd,
                                                wb, wl, wq, ws, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
