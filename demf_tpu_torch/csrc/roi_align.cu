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
// The design: a block owns one RoI for all its bins over a slice of 128
// channels (32 lanes of 16 bytes), a warp a bin column (ox), walking the
// bin rows (oy) in step, so that the corners a bin row shares with its
// neighbours and with the next row are served by L1.  The RoI's sample
// table (ops/roi_align.py::sample_table: each sample's two clamped corner
// offsets and its weights, a row and a column axis) is computed once into
// shared memory by the first threads, with the plain version's roundings;
// the inner loop has only 32-bit adds and no division by a runtime value.
// With 2 x 2 samples a bin (every config) the loop is unrolled, so a
// thread has its bin's 16 loads of 16 bytes in flight at once; other
// counts take the same sums in a loop over the runtime count.  The
// output goes out with streaming stores (__stcs), so that it does not push
// the pyramid out of L2.
//
// K12, the backward with respect to the levels (demf_roi_align_backward),
// replaces the gradient JAX's autodiff takes of that gather
// (demf_tpu/models/rpn_roi.py:199), a scatter-add: d_level[y, x, c] +=
// w_corner / (s * s) * d_out[roi, bin, c] over each RoI's bins, samples and
// four corners, clamped as the forward clamps them (two corners clamped
// onto one pixel add twice, as the scatter does).  On the path: 512 sampled
// RoIs an image, once a step of the image-only Faster R-CNN training.  What
// bounds it: bytes, d_out read once and the levels' gradient written once
// (1.10 GB at batch 16); the wrapper zero-fills that gradient first.  The
// design is the forward's: a block a RoI over 128 channels, a warp a bin
// column, the same sample table in shared memory; a thread reads its bin's
// float4 of d_out once, divides it by the sample count and adds each
// sample's four weighted corners into the level, one float4 atomicAdd a
// corner (sm_90's vector atomic; four scalar ones before CUDA 12.4).  The
// adds land in any order, so the gradient's last bits vary between calls.
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;  // float4 channel lanes a block (128 channels)
constexpr int kMaxLevels = 4;

// the levels read by the forward (P = const float4*) or written by the
// backward (P = float4*)
template <typename P>
struct LevelsOf {
  P ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
};
using Levels = LevelsOf<const float4*>;

// a level's entry by a runtime index, as selects: indexing the kernel's
// parameter struct with it would copy the struct to local memory
template <typename T>
__device__ inline T of_level(const T (&a)[kMaxLevels], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

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

// one sample of an axis: the offsets (in float4 units) of its two clamped
// corners, the far corner's weight and the near one's
struct Sample {
  int a, b;
  float w, h;
};

// the RoI's sample table, rows then columns, staged by the block's threads
// with the plain version's roundings in its order
__device__ inline void stage_table(Sample* table, float4 box, float scale,
                                   int h, int w, int c4, int out_size,
                                   int s) {
  const int axis = out_size * s;
  for (int i = threadIdx.x; i < 2 * axis; i += blockDim.x) {
    const bool is_y = i < axis;
    const int k = is_y ? i : i - axis;
    const float lo = __fmul_rn(is_y ? box.y : box.x, scale);
    const float hi = __fmul_rn(is_y ? box.w : box.z, scale);
    const float bin = __fdiv_rn(fmaxf(__fsub_rn(hi, lo), 1e-3f),
                                static_cast<float>(out_size));
    const float g = __fdiv_rn(__fadd_rn(static_cast<float>(k), 0.5f),
                              static_cast<float>(s));
    const float v = __fsub_rn(__fadd_rn(lo, __fmul_rn(g, bin)), 0.5f);
    const float v0 = floorf(v);
    const float far = __fsub_rn(v, v0);
    const int size = is_y ? h : w;
    const int step = is_y ? w * c4 : c4;
    Sample e;
    e.a = clamp_index(v0, size) * step;
    e.b = clamp_index(v0 + 1.f, size) * step;
    e.w = far;
    e.h = __fsub_rn(1.f, far);
    table[i] = e;
  }
}

__device__ inline float4 bilinear(const float4* __restrict__ base, Sample y,
                                  Sample x) {
  const float4 v00 = __ldg(base + y.a + x.a);
  const float4 v01 = __ldg(base + y.a + x.b);
  const float4 v10 = __ldg(base + y.b + x.a);
  const float4 v11 = __ldg(base + y.b + x.b);
  return add4(add4(add4(scale2(v00, y.h, x.h), scale2(v01, y.h, x.w)),
                   scale2(v10, y.w, x.h)),
              scale2(v11, y.w, x.w));
}

// S: samples a bin axis at compile time, or 0 for the runtime `samples`
template <int S>
__global__ void roi_align_kernel(Levels levels,
                                 const float4* __restrict__ rois,
                                 const int* __restrict__ lvl,
                                 float4* __restrict__ out, int r, int c4,
                                 int num_levels, int out_size, int samples) {
  extern __shared__ Sample table[];  // out * s rows, then out * s columns
  const int s = S > 0 ? S : samples;
  const int axis = out_size * s;
  Sample* ys = table;
  Sample* xs = table + axis;
  const int roi = blockIdx.x;
  const int image = roi / r;
  const int lv = min(max(lvl[roi], 0), num_levels - 1);
  const int h = of_level(levels.h, lv), w = of_level(levels.w, lv);
  const float scale = of_level(levels.scale, lv);

  stage_table(table, rois[roi], scale, h, w, c4, out_size, s);
  __syncthreads();

  const int lane = threadIdx.x % kLanes, ox = threadIdx.x / kLanes;
  const int ch = blockIdx.y * kLanes + lane;
  if (ch >= c4) return;
  const float4* base = of_level(levels.ptr, lv) +
                       static_cast<size_t>(image) * h * w * c4 + ch;
  float4* dst = out + static_cast<size_t>(roi) * out_size * out_size * c4 +
                ox * c4 + ch;
  const float count = static_cast<float>(s * s);
  for (int oy = 0; oy < out_size; ++oy) {
    float4 acc;
    if constexpr (S > 0) {
      // the bin's S * S samples' 4 S * S loads issued together
      float4 vals[S * S];
#pragma unroll
      for (int k = 0; k < S * S; ++k)
        vals[k] = bilinear(base, ys[oy * S + k / S], xs[ox * S + k % S]);
      acc = vals[0];
#pragma unroll
      for (int k = 1; k < S * S; ++k) acc = add4(acc, vals[k]);
    } else {
      acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int iy = 0; iy < s; ++iy)
        for (int ix = 0; ix < s; ++ix) {
          const float4 val = bilinear(base, ys[oy * s + iy], xs[ox * s + ix]);
          acc = iy == 0 && ix == 0 ? val : add4(acc, val);
        }
    }
    __stcs(dst + oy * out_size * c4,
           make_float4(__fdiv_rn(acc.x, count), __fdiv_rn(acc.y, count),
                       __fdiv_rn(acc.z, count), __fdiv_rn(acc.w, count)));
  }
}

__device__ inline void atomic_add4(float4* p, float4 v) {
#if CUDART_VERSION >= 12040
  atomicAdd(p, v);
#else
  atomicAdd(&p->x, v.x);
  atomicAdd(&p->y, v.y);
  atomicAdd(&p->z, v.z);
  atomicAdd(&p->w, v.w);
#endif
}

// a bin's sample (y, x) given its share g of d_out: its four corners'
// weighted shares added into the level
__device__ inline void scatter(float4* base, Sample y, Sample x, float4 g) {
  atomic_add4(base + y.a + x.a, scale2(g, y.h, x.h));
  atomic_add4(base + y.a + x.b, scale2(g, y.h, x.w));
  atomic_add4(base + y.b + x.a, scale2(g, y.w, x.h));
  atomic_add4(base + y.b + x.b, scale2(g, y.w, x.w));
}

// K12: the forward's blocks and table; S as there
template <int S>
__global__ void roi_align_backward_kernel(LevelsOf<float4*> levels,
                                          const float4* __restrict__ rois,
                                          const int* __restrict__ lvl,
                                          const float4* __restrict__ d_out,
                                          int r, int c4, int num_levels,
                                          int out_size, int samples) {
  extern __shared__ Sample table[];
  const int s = S > 0 ? S : samples;
  const int axis = out_size * s;
  const Sample* ys = table;
  const Sample* xs = table + axis;
  const int roi = blockIdx.x;
  const int image = roi / r;
  const int lv = min(max(lvl[roi], 0), num_levels - 1);
  const int h = of_level(levels.h, lv), w = of_level(levels.w, lv);
  const float scale = of_level(levels.scale, lv);

  stage_table(table, rois[roi], scale, h, w, c4, out_size, s);
  __syncthreads();

  const int lane = threadIdx.x % kLanes, ox = threadIdx.x / kLanes;
  const int ch = blockIdx.y * kLanes + lane;
  if (ch >= c4) return;
  float4* base = of_level(levels.ptr, lv) +
                 static_cast<size_t>(image) * h * w * c4 + ch;
  const float4* src = d_out +
                      static_cast<size_t>(roi) * out_size * out_size * c4 +
                      ox * c4 + ch;
  const float count = static_cast<float>(s * s);
  for (int oy = 0; oy < out_size; ++oy) {
    const float4 d = __ldcs(src + oy * out_size * c4);
    const float4 g = make_float4(__fdiv_rn(d.x, count), __fdiv_rn(d.y, count),
                                 __fdiv_rn(d.z, count), __fdiv_rn(d.w, count));
    if constexpr (S > 0) {
#pragma unroll
      for (int k = 0; k < S * S; ++k)
        scatter(base, ys[oy * S + k / S], xs[ox * S + k % S], g);
    } else {
      for (int iy = 0; iy < s; ++iy)
        for (int ix = 0; ix < s; ++ix)
          scatter(base, ys[oy * s + iy], xs[ox * s + ix], g);
    }
  }
}

template <typename P>
LevelsOf<P> levels_of(const void* const (&ptrs)[kMaxLevels],
                      const int (&hs)[kMaxLevels],
                      const int (&ws)[kMaxLevels],
                      const float (&ss)[kMaxLevels]) {
  LevelsOf<P> levels;
  for (int i = 0; i < kMaxLevels; ++i) {
    levels.ptr[i] = static_cast<P>(const_cast<void*>(ptrs[i]));
    levels.h[i] = hs[i];
    levels.w[i] = ws[i];
    levels.scale[i] = ss[i];
  }
  return levels;
}

bool bad_shape(int out_size, int samples) {
  return out_size < 1 || out_size > 32 || samples < 1 ||
         out_size * samples > 1024;
}

}  // namespace

extern "C" {

// f0..f3: (B, H_l, W_l, C) f32 levels (unused ones may repeat f0); rois
// (B, R, 4) f32; lvl (B, R) int32; out (B, R, out, out, C) f32, every
// element written; C a multiple of 4, every pointer 16-byte aligned;
// out_size <= 32, out_size * samples <= 1024, a level's H * W * C / 4
// below 2^31.
int demf_roi_align(const void* f0, const void* f1, const void* f2,
                   const void* f3, const void* rois, const void* lvl,
                   void* out, int b, int r, int c, int num_levels,
                   int out_size, int samples, int h0, int h1, int h2, int h3,
                   int w0, int w1, int w2, int w3, float s0, float s1,
                   float s2, float s3, void* stream) {
  if (b == 0 || r == 0 || c == 0) return 0;
  if (bad_shape(out_size, samples))
    return static_cast<int>(cudaErrorInvalidValue);
  const Levels levels = levels_of<const float4*>(
      {f0, f1, f2, f3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}, {s0, s1, s2, s3});
  const int c4 = c / 4;
  const dim3 grid(b * r, (c4 + kLanes - 1) / kLanes);
  const int threads = kLanes * out_size;
  const size_t shared = 2 * sizeof(Sample) * out_size * samples;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* boxes = static_cast<const float4*>(rois);
  const int* levels_of_roi = static_cast<const int*>(lvl);
  float4* dst = static_cast<float4*>(out);
  if (samples == 2)
    roi_align_kernel<2><<<grid, threads, shared, s>>>(
        levels, boxes, levels_of_roi, dst, r, c4, num_levels, out_size,
        samples);
  else
    roi_align_kernel<0><<<grid, threads, shared, s>>>(
        levels, boxes, levels_of_roi, dst, r, c4, num_levels, out_size,
        samples);
  return static_cast<int>(cudaGetLastError());
}

// K12. g0..g3: (B, H_l, W_l, C) f32 gradients of the levels, zero-filled by
// the caller (unused ones may repeat g0); rois, lvl and the sizes as the
// forward's; d_out (B, R, out, out, C) f32.  The same limits.
int demf_roi_align_backward(void* g0, void* g1, void* g2, void* g3,
                            const void* rois, const void* lvl,
                            const void* d_out, int b, int r, int c,
                            int num_levels, int out_size, int samples, int h0,
                            int h1, int h2, int h3, int w0, int w1, int w2,
                            int w3, float s0, float s1, float s2, float s3,
                            void* stream) {
  if (b == 0 || r == 0 || c == 0) return 0;
  if (bad_shape(out_size, samples))
    return static_cast<int>(cudaErrorInvalidValue);
  const LevelsOf<float4*> levels = levels_of<float4*>(
      {g0, g1, g2, g3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}, {s0, s1, s2, s3});
  const int c4 = c / 4;
  const dim3 grid(b * r, (c4 + kLanes - 1) / kLanes);
  const int threads = kLanes * out_size;
  const size_t shared = 2 * sizeof(Sample) * out_size * samples;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* boxes = static_cast<const float4*>(rois);
  const int* levels_of_roi = static_cast<const int*>(lvl);
  const float4* grad = static_cast<const float4*>(d_out);
  if (samples == 2)
    roi_align_backward_kernel<2><<<grid, threads, shared, s>>>(
        levels, boxes, levels_of_roi, grad, r, c4, num_levels, out_size,
        samples);
  else
    roi_align_backward_kernel<0><<<grid, threads, shared, s>>>(
        levels, boxes, levels_of_roi, grad, r, c4, num_levels, out_size,
        samples);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
