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
// sequential grid axis; here the slot sum is a loop and one thread owns a
// group of output channels for the whole LP sum.
//
// Rows come in float32 or bfloat16, weights in float32 or bfloat16 with
// their own element strides, so the (LP, Q, 4) layout of msda_fold.py and
// the slot-major (LP, 4, Q) layout of main18 read without a copy.  Each
// product and sum is rounded on its own (__fmul_rn, __fadd_rn: no FMA), in
// lp-major then slot order, so the plain version in ops/msda_fold.py gets
// the same bits on either kernel below.
//
// What bounds it on the card: reading the rows (1.48 GB of bf16 rows for
// 16 slices at the encoder shape); the weights are 1/hd of that and the
// arithmetic is one multiply and one add per element read.
//
// What this design does about it (slot_fold_vec_kernel): a thread owns 16
// bytes of channels of one query (8 bf16 or 4 float32 channels) and loads
// them from each of the 4 slots with one 16-byte load, so a warp-load
// moves 512 bytes; at hd 32 in bf16, 4 threads share a query and a warp
// covers 8.  Its query's 4 weights come in one 8- or 16-byte load in the
// (LP, Q, 4) layout and in 4 strided loads otherwise.  The LP loop runs 4
// lp at a time, 16 row loads issued before any is used, and is unrolled
// in full for LP 16 (a template case; other LP take a runtime loop), so
// ~256 bytes a thread are in flight: far more than HBM's latency needs.
// Rows are read with the streaming hint (__ldcs): each is read once.
// Rows whose channel groups are not 16-byte aligned (hd not a multiple of
// 8 in bf16 or 4 in float32, or a data pointer off the 16-byte grid) take
// slot_fold_kernel, one thread an output element with scalar loads; the
// wrapper chooses by shape and address (ops/msda_fold.py::
// fold_takes_vector_loads).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kLpStep = 4;   // lp whose row loads are issued together

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// the channels of 16 bytes of rows, as floats (bf16 -> float is exact)
template <typename R>
__device__ __forceinline__ void unpack(const uint4& v, float* f) {
  if constexpr (sizeof(R) == 2) {
    const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  } else {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
}

// the 4 slot weights of one (lp, q): one vector load when they are
// adjacent and aligned (kWVec), else 4 loads ws elements apart
template <typename W, bool kWVec>
__device__ __forceinline__ void load_weights(const W* p, long long ws,
                                             float* w) {
  if constexpr (kWVec && sizeof(W) == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if constexpr (kWVec) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = __uint_as_float(v.x << 16);
    w[1] = __uint_as_float(v.x & 0xffff0000u);
    w[2] = __uint_as_float(v.y << 16);
    w[3] = __uint_as_float(v.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int s = 0; s < 4; ++s) w[s] = to_float(p[s * ws]);
  }
}

// kLp > 0: LP known at compile time; 0: the runtime lp
template <typename R, typename W, int kLp, bool kWVec>
__global__ void __launch_bounds__(kThreads, 2)
    slot_fold_vec_kernel(const R* __restrict__ rows, const W* __restrict__ w,
                         float* __restrict__ out, int lp_runtime, int q,
                         int hd, long long wb, long long wl, long long wq,
                         long long ws, long long total) {
  constexpr int kV = 16 / sizeof(R);   // channels a thread owns
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int groups = hd / kV;
  const int g = static_cast<int>(t % groups);
  const long long r = t / groups;      // bh * q + qi
  const int qi = static_cast<int>(r % q);
  const long long b = r / q;
  const int lp = kLp > 0 ? kLp : lp_runtime;
  const long long row_len = 4LL * hd;
  const long long lp_stride = static_cast<long long>(q) * row_len;
  const R* row = rows + (b * lp * q + qi) * row_len + g * kV;
  const W* wt = w + b * wb + qi * wq;

  float acc[kV];
#pragma unroll
  for (int e = 0; e < kV; ++e) acc[e] = 0.0f;

  int l = 0;
#pragma unroll
  for (; l + kLpStep <= lp; l += kLpStep) {
    uint4 v[kLpStep][4];
    float wv[kLpStep][4];
#pragma unroll
    for (int i = 0; i < kLpStep; ++i) {
      load_weights<W, kWVec>(wt + (l + i) * wl, ws, wv[i]);
#pragma unroll
      for (int s = 0; s < 4; ++s)
        v[i][s] = __ldcs(reinterpret_cast<const uint4*>(
            row + (l + i) * lp_stride + s * hd));
    }
#pragma unroll
    for (int i = 0; i < kLpStep; ++i) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float f[kV];
        unpack<R>(v[i][s], f);
#pragma unroll
        for (int e = 0; e < kV; ++e)
          acc[e] = __fadd_rn(acc[e], __fmul_rn(f[e], wv[i][s]));
      }
    }
  }
  for (; l < lp; ++l) {
    float wv[4];
    load_weights<W, kWVec>(wt + l * wl, ws, wv);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float f[kV];
      unpack<R>(__ldcs(reinterpret_cast<const uint4*>(row + l * lp_stride +
                                                      s * hd)),
                f);
#pragma unroll
      for (int e = 0; e < kV; ++e)
        acc[e] = __fadd_rn(acc[e], __fmul_rn(f[e], wv[s]));
    }
  }
  float4* o = reinterpret_cast<float4*>(out + r * hd + g * kV);
#pragma unroll
  for (int e = 0; e < kV; e += 4)
    o[e / 4] = make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
}

// one thread an output element, scalar loads: rows off the 16-byte grid
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

unsigned blocks_for(long long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

template <typename R, typename W, int kLp, bool kWVec>
void launch_vec(const void* rows, const void* w, void* out, int bh, int lp,
                int q, int hd, long long wb, long long wl, long long wq,
                long long ws, cudaStream_t stream) {
  const long long total =
      static_cast<long long>(bh) * q * (hd / (16 / sizeof(R)));
  slot_fold_vec_kernel<R, W, kLp, kWVec>
      <<<blocks_for(total), kThreads, 0, stream>>>(
          static_cast<const R*>(rows), static_cast<const W*>(w),
          static_cast<float*>(out), lp, q, hd, wb, wl, wq, ws, total);
}

template <typename R, typename W>
int launch(const void* rows, const void* w, void* out, int bh, int lp, int q,
           int hd, long long wb, long long wl, long long wq, long long ws,
           int vec, int w_vec, cudaStream_t stream) {
  const long long total = static_cast<long long>(bh) * q * hd;
  if (total == 0) return 0;
  constexpr int kV = 16 / sizeof(R);
  if (!vec) {
    slot_fold_kernel<R, W><<<blocks_for(total), kThreads, 0, stream>>>(
        static_cast<const R*>(rows), static_cast<const W*>(w),
        static_cast<float*>(out), lp, q, hd, wb, wl, wq, ws, total);
  } else if (hd % kV != 0 ||
             reinterpret_cast<std::uintptr_t>(rows) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if (lp == 16 && w_vec) {
    launch_vec<R, W, 16, true>(rows, w, out, bh, lp, q, hd, wb, wl, wq, ws,
                               stream);
  } else if (lp == 16) {
    launch_vec<R, W, 16, false>(rows, w, out, bh, lp, q, hd, wb, wl, wq, ws,
                                stream);
  } else if (w_vec) {
    launch_vec<R, W, 0, true>(rows, w, out, bh, lp, q, hd, wb, wl, wq, ws,
                              stream);
  } else {
    launch_vec<R, W, 0, false>(rows, w, out, bh, lp, q, hd, wb, wl, wq, ws,
                               stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rows: (BH, LP, Q, 4*hd) contiguous, float32 (rows_bf16 = 0) or bfloat16
// (1); w: the weight of (bh, lp, q, slot) at w + bh*wb + lp*wl + q*wq +
// slot*ws (element strides), float32 (w_bf16 = 0) or bfloat16 (1);
// out: (BH, Q, hd) float32, 16-byte aligned.  vec = 1 takes the
// vector-load kernel: rows 16-byte aligned and hd a multiple of 8 (bf16)
// or 4 (float32); w_vec = 1 there reads a (lp, q)'s 4 weights as one
// vector (ws = 1, and wb, wl, wq multiples of 4 from a pointer aligned to
// 4 weights).  Returns cudaErrorInvalidValue for a dtype code other than
// 0 or 1 and for vec = 1 on rows the vector kernel cannot take.
int demf_msda_fold(const void* rows, const void* w, void* out, int bh,
                   int lp, int q, int hd, long long wb, long long wl,
                   long long wq, long long ws, int rows_bf16, int w_bf16,
                   int vec, int w_vec, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows_bf16 == 0 && w_bf16 == 0)
    return launch<float, float>(rows, w, out, bh, lp, q, hd, wb, wl, wq, ws,
                                vec, w_vec, st);
  if (rows_bf16 == 0 && w_bf16 == 1)
    return launch<float, __nv_bfloat16>(rows, w, out, bh, lp, q, hd, wb, wl,
                                        wq, ws, vec, w_vec, st);
  if (rows_bf16 == 1 && w_bf16 == 0)
    return launch<__nv_bfloat16, float>(rows, w, out, bh, lp, q, hd, wb, wl,
                                        wq, ws, vec, w_vec, st);
  if (rows_bf16 == 1 && w_bf16 == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(rows, w, out, bh, lp, q, hd,
                                                wb, wl, wq, ws, vec, w_vec,
                                                st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
