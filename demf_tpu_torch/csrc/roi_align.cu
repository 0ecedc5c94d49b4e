// RoIAlign over an FPN pyramid, forward, a whole batch in one launch:
// out[b, r, oy, ox, :] is the mean of samples x samples bilinear samples of
// RoI r's bin (oy, ox) on its assigned level, from up to 4 NHWC float32
// levels read in place.
//
// Replaces: demf_tpu/models/rpn_roi.py::pyramid_roi_align (one XLA gather
// of the four corners of every sample from the concatenated pyramid),
// vmapped over the images by StandardRoIHead; demf_tpu/ops/roi_align.py::
// roi_align is its single-level form.  XLA code, not a Pallas kernel.  On
// the path: 1,000 RoIs an image pooled from 152x208, 76x104, 38x52 and
// 19x26 maps of 256 channels into (1000, 7, 7, 256).
//
// The rule (ops/roi_align.py): aligned=True (-0.5), sample (i + 0.5) / s of
// a bin, the corner indices clamped to the level (mmcv reads zero outside;
// the JAX package clamps), v00 (1 - wy)(1 - wx) + v01 (1 - wy) wx +
// v10 wy (1 - wx) + v11 wy wx, the mean of the s x s samples.  Every step
// is written with __fadd_rn / __fmul_rn / __fdiv_rn in the plain version's
// order (the samples summed row-major, then divided by their count), so
// nvcc contracts nothing into an FMA and the output equals the plain
// version's bit for bit: the R-CNN's scores, and so the order and the NMS
// of the 2D boxes downstream, are the same on both paths.
//
// What bounds it on the card: bytes.  The output, 50.2 MB an image at
// 1,000 RoIs, is written once; the pyramid (43 MB an image) is read through
// the cache, each pixel by the few samples near it.  The operations (~4e8
// an image) are far below the float32 rate.
//
// The design: one thread owns 16 bytes (4 channels) of one bin and loops
// over its s x s samples, so 64 neighbouring threads read a pixel's 256
// channels as one coalesced run of 16-byte loads and write the bin's 1 KB
// the same way.  The sample geometry (a few dozen operations) is computed
// again by each of a bin's threads instead of being staged in shared
// memory: the loads, not the arithmetic, set its time.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 4;

struct Levels {
  const float4* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
};

__device__ inline int clamp_index(float v, int size) {
  // the float clamped first so that a huge or negative value converts safely
  const float c = fminf(fmaxf(v, -1.f), static_cast<float>(size - 1));
  return min(max(static_cast<int>(c), 0), size - 1);
}

// (v * a) * b, one rounding a product, as the plain version's
// v00 * (1 - wy) * (1 - wx)
__device__ inline float4 scale2(float4 v, float a, float b) {
  return make_float4(__fmul_rn(__fmul_rn(v.x, a), b),
                     __fmul_rn(__fmul_rn(v.y, a), b),
                     __fmul_rn(__fmul_rn(v.z, a), b),
                     __fmul_rn(__fmul_rn(v.w, a), b));
}

__device__ inline float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__global__ void __launch_bounds__(kThreads)
    roi_align_kernel(Levels levels, const float4* __restrict__ rois,
                     const int* __restrict__ lvl, float4* __restrict__ out,
                     int b, int r, int c4, int num_levels, int out_size,
                     int samples) {
  const long long bins = static_cast<long long>(out_size) * out_size;
  const long long total = static_cast<long long>(b) * r * bins * c4;
  const float out_f = static_cast<float>(out_size);
  const float s_f = static_cast<float>(samples);
  const float count = static_cast<float>(samples * samples);
  for (long long t = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       t < total; t += static_cast<long long>(gridDim.x) * kThreads) {
    const int ch = static_cast<int>(t % c4);
    const long long cell = t / c4;
    const int bin = static_cast<int>(cell % bins);
    const long long roi = cell / bins;
    const int image = static_cast<int>(roi / r);
    const int oy = bin / out_size, ox = bin % out_size;
    const int lv = min(max(lvl[roi], 0), num_levels - 1);
    const float4* feat = levels.ptr[lv];
    const int h = levels.h[lv], w = levels.w[lv];
    const float scale = levels.scale[lv];
    const float4 box = rois[roi];
    const float x1 = __fmul_rn(box.x, scale), y1 = __fmul_rn(box.y, scale);
    const float x2 = __fmul_rn(box.z, scale), y2 = __fmul_rn(box.w, scale);
    const float bin_w = __fdiv_rn(fmaxf(__fsub_rn(x2, x1), 1e-3f), out_f);
    const float bin_h = __fdiv_rn(fmaxf(__fsub_rn(y2, y1), 1e-3f), out_f);
    const float4* base = feat + static_cast<size_t>(image) * h * w * c4 + ch;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int iy = 0; iy < samples; ++iy) {
      const float gy = __fdiv_rn(
          __fadd_rn(static_cast<float>(oy * samples + iy), 0.5f), s_f);
      const float sy = __fsub_rn(__fadd_rn(y1, __fmul_rn(gy, bin_h)), 0.5f);
      const float y0 = floorf(sy);
      const float wy = __fsub_rn(sy, y0);
      const int ya = clamp_index(y0, h), yb = clamp_index(y0 + 1.f, h);
      for (int ix = 0; ix < samples; ++ix) {
        const float gx = __fdiv_rn(
            __fadd_rn(static_cast<float>(ox * samples + ix), 0.5f), s_f);
        const float sx = __fsub_rn(__fadd_rn(x1, __fmul_rn(gx, bin_w)), 0.5f);
        const float x0 = floorf(sx);
        const float wx = __fsub_rn(sx, x0);
        const int xa = clamp_index(x0, w), xb = clamp_index(x0 + 1.f, w);
        const float4 v00 = base[(static_cast<size_t>(ya) * w + xa) * c4];
        const float4 v01 = base[(static_cast<size_t>(ya) * w + xb) * c4];
        const float4 v10 = base[(static_cast<size_t>(yb) * w + xa) * c4];
        const float4 v11 = base[(static_cast<size_t>(yb) * w + xb) * c4];
        const float hy = __fsub_rn(1.f, wy), hx = __fsub_rn(1.f, wx);
        const float4 val = add4(
            add4(add4(scale2(v00, hy, hx), scale2(v01, hy, wx)),
                 scale2(v10, wy, hx)),
            scale2(v11, wy, wx));
        acc = iy == 0 && ix == 0 ? val : add4(acc, val);
      }
    }
    out[t] = make_float4(__fdiv_rn(acc.x, count), __fdiv_rn(acc.y, count),
                         __fdiv_rn(acc.z, count), __fdiv_rn(acc.w, count));
  }
}

}  // namespace

extern "C" {

// f0..f3: (B, H_l, W_l, C) f32 levels (unused ones may repeat f0); rois
// (B, R, 4) f32; lvl (B, R) int32; out (B, R, out, out, C) f32, every
// element written; C a multiple of 4, every pointer 16-byte aligned.
int demf_roi_align(const void* f0, const void* f1, const void* f2,
                   const void* f3, const void* rois, const void* lvl,
                   void* out, int b, int r, int c, int num_levels,
                   int out_size, int samples, int h0, int h1, int h2, int h3,
                   int w0, int w1, int w2, int w3, float s0, float s1,
                   float s2, float s3, void* stream) {
  if (b == 0 || r == 0 || c == 0) return 0;
  Levels levels;
  const void* ptrs[kMaxLevels] = {f0, f1, f2, f3};
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  const float ss[kMaxLevels] = {s0, s1, s2, s3};
  for (int i = 0; i < kMaxLevels; ++i) {
    levels.ptr[i] = static_cast<const float4*>(ptrs[i]);
    levels.h[i] = hs[i];
    levels.w[i] = ws[i];
    levels.scale[i] = ss[i];
  }
  const long long total =
      static_cast<long long>(b) * r * out_size * out_size * (c / 4);
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 1 << 20 ? want : 1 << 20);
  roi_align_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      levels, static_cast<const float4*>(rois), static_cast<const int*>(lvl),
      static_cast<float4*>(out), b, r, c / 4, num_levels, out_size, samples);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
