// Multi-scale deformable attention, forward: bilinear reads of the value
// planes at the sampling locations, weighted by attention, summed over
// levels and points.  The backward is kernel K4 (msda_backward.cu); the
// autograd.Function of ops/msda.py pairs the two.
//
// Replaces: demf_tpu/ops/msda.py::multi_scale_deformable_attention (the XLA
// forms _make_small_q_msda and _make_msda), and with it the two Pallas
// kernels written for that op's halves: ops/pallas/gather_rows.py
// (gather_rows, the row fetch) and ops/pallas/msda_fold.py
// (weighted_slot_fold, the weighted reduction).  This kernel does both in
// one pass and keeps the fetched rows in registers.
//
// Semantics: grid_sample with align_corners=False and zero padding, per
// level: x = loc_x * W - 0.5, y = loc_y * H - 0.5; corners outside the map
// read zero.  Accumulation is float32.
//
// What bounds it on the card: the reads.  Every (query, head, level, point)
// sample reads four value rows of head_dim floats at data-dependent
// addresses, and the arithmetic per byte is tiny, so the kernel is bound by
// the gather traffic through L2 (the value planes of one scene, 22k tokens x
// 256 channels x 4 B = 23 MB, fit in the 50 MB L2).
//
// What this design does about it: one thread per (batch, query, head,
// channel), so neighbouring threads read neighbouring channels of one value
// row: at head_dim 32 each corner read of a warp is one 128-byte
// transaction.  The
// location and weight of a sample are the same for the whole warp and come
// from one broadcast load.  Level shapes and start offsets live in a small
// device array.  Sorting samples for locality, vector loads and shared
// memory staging are left to later changes.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    msda_forward_kernel(const float* __restrict__ value,
                        const int* __restrict__ level_info,
                        const float* __restrict__ locs,
                        const float* __restrict__ attn,
                        float* __restrict__ out, int b, int s, int q,
                        int heads, int hd, int levels, int points) {
  const long long total = static_cast<long long>(b) * q * heads * hd;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= total) return;

  const int c = static_cast<int>(tid % hd);
  long long r = tid / hd;
  const int h = static_cast<int>(r % heads);
  r /= heads;
  const int qi = static_cast<int>(r % q);
  const int bi = static_cast<int>(r / q);

  const float* vb = value + static_cast<long long>(bi) * s * heads * hd;
  const long long sample0 =
      ((static_cast<long long>(bi) * q + qi) * heads + h) * levels * points;
  const float* loc = locs + sample0 * 2;
  const float* aw = attn + sample0;
  const long long row_stride = static_cast<long long>(heads) * hd;
  const int col = h * hd + c;

  float acc = 0.0f;
  for (int l = 0; l < levels; ++l) {
    const int hl = __ldg(level_info + 3 * l);
    const int wl = __ldg(level_info + 3 * l + 1);
    const int start = __ldg(level_info + 3 * l + 2);
    const float* vl = vb + static_cast<long long>(start) * row_stride + col;
    for (int p = 0; p < points; ++p) {
      const int sp = l * points + p;
      // rounded as loc * W, then - 0.5 (no FMA): the plain version's x, y
      const float x = __fsub_rn(__fmul_rn(__ldg(loc + 2 * sp), wl), 0.5f);
      const float y = __fsub_rn(__fmul_rn(__ldg(loc + 2 * sp + 1), hl), 0.5f);
      const float a = __ldg(aw + sp);
      if (!(x > -1.0f && y > -1.0f && x < wl && y < hl)) continue;
      const float xf = floorf(x);
      const float yf = floorf(y);
      const int x0 = static_cast<int>(xf);
      const int y0 = static_cast<int>(yf);
      const float lx = x - xf;
      const float ly = y - yf;
      const float hx = 1.0f - lx;
      const float hy = 1.0f - ly;
      float v = 0.0f;
      if (y0 >= 0) {
        if (x0 >= 0) v += hy * hx * __ldg(vl + (y0 * wl + x0) * row_stride);
        if (x0 + 1 < wl)
          v += hy * lx * __ldg(vl + (y0 * wl + x0 + 1) * row_stride);
      }
      if (y0 + 1 < hl) {
        if (x0 >= 0)
          v += ly * hx * __ldg(vl + ((y0 + 1) * wl + x0) * row_stride);
        if (x0 + 1 < wl)
          v += ly * lx * __ldg(vl + ((y0 + 1) * wl + x0 + 1) * row_stride);
      }
      acc += a * v;
    }
  }
  out[(static_cast<long long>(bi) * q + qi) * row_stride + col] = acc;
}

}  // namespace

extern "C" {

// value: (B, S, heads, hd) f32; level_info: (levels, 3) int32 device array
// of (H, W, start); locs: (B, Q, heads, levels, points, 2) f32;
// attn: (B, Q, heads, levels, points) f32; out: (B, Q, heads * hd) f32.
int demf_msda_forward(const void* value, const void* level_info,
                      const void* locs, const void* attn, void* out, int b,
                      int s, int q, int heads, int hd, int levels, int points,
                      void* stream) {
  const long long total = static_cast<long long>(b) * q * heads * hd;
  if (total == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  msda_forward_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const int*>(level_info),
      static_cast<const float*>(locs), static_cast<const float*>(attn),
      static_cast<float*>(out), b, s, q, heads, hd, levels, points);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
