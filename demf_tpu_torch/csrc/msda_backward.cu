// Multi-scale deformable attention, backward: from the gradient of the
// output, the gradients of the value planes, the sampling locations and the
// attention weights, with the forward's semantics (csrc/msda.cu).
//
// Replaces: the custom VJPs of demf_tpu/ops/msda.py, _make_small_q_msda's
// _bwd (the decoder route, one-hot matmul d_value) and _make_msda's _bwd /
// _bwd_saved (the encoder route, quad-plane banded scatter).  Neither TPU
// layout is carried over: this kernel computes mmcv ms_deform_attn_backward
// directly (zero padding, align_corners=False, x = loc_x * W - 0.5).
//
// Per sample s = (batch, query, head, level, point) with attention a,
// bilinear corner weights w_k and upstream gradient g (one head's channels):
//   d_value[corner_k] += a * w_k * g
//   d_attn[s]          = sum_c sum_k w_k * g_c * v_k,c
//   d_loc_x[s]         = W * a * sum_c sum_k g_c * v_k,c * dw_k/dx
//   d_loc_y[s]         = H * a * sum_c sum_k g_c * v_k,c * dw_k/dy
//
// What bounds it on the card: the scattered fp32 atomics into d_value (four
// per sample and channel, at data-dependent rows) and the data-dependent
// reads of the four value rows per sample, both through L2; the arithmetic
// per byte is tiny.  The caller also zeroes d_value, a full pass over the
// value planes (366 MB at batch 16 of the stage-2 step).
//
// What this design does about it: one thread per (batch, query, head,
// channel), as in the forward, so a warp's corner reads and its atomics hit
// one contiguous row of head_dim floats (one 128-byte line at head_dim 32).
// The two per-sample outputs are sums over the channels: each is reduced
// with warp shuffles across the head_dim lanes of one (batch, query, head)
// and written by its first lane, so d_attn and d_loc need no atomics.
// head_dim must divide 32, so a group of lanes never straddles a warp.
// Sorting samples by row to merge atomics, and staging in shared memory,
// are left to later changes.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Sum over the hd lanes of one group; hd is a power of two dividing 32 and
// groups are hd-aligned, so the xor partners stay inside the group.
__device__ __forceinline__ float group_sum(float v, int hd, unsigned mask) {
  for (int off = hd >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    msda_backward_kernel(const float* __restrict__ value,
                         const int* __restrict__ level_info,
                         const float* __restrict__ locs,
                         const float* __restrict__ attn,
                         const float* __restrict__ grad_out,
                         float* __restrict__ d_value,
                         float* __restrict__ d_locs,
                         float* __restrict__ d_attn, int b, int s, int q,
                         int heads, int hd, int levels, int points) {
  const long long total = static_cast<long long>(b) * q * heads * hd;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // total is a multiple of hd, so a group is wholly in or wholly out; the
  // lanes past the end leave, and the shuffles name only those that stay.
  const unsigned mask = __ballot_sync(0xffffffffu, tid < total);
  if (tid >= total) return;

  const int c = static_cast<int>(tid % hd);
  long long r = tid / hd;
  const int h = static_cast<int>(r % heads);
  r /= heads;
  const int qi = static_cast<int>(r % q);
  const int bi = static_cast<int>(r / q);

  const long long row_stride = static_cast<long long>(heads) * hd;
  const long long plane0 = static_cast<long long>(bi) * s * row_stride;
  const long long sample0 =
      ((static_cast<long long>(bi) * q + qi) * heads + h) * levels * points;
  const float* loc = locs + sample0 * 2;
  const float* aw = attn + sample0;
  const int col = h * hd + c;
  const float g =
      __ldg(grad_out + (static_cast<long long>(bi) * q + qi) * row_stride +
            col);

  for (int l = 0; l < levels; ++l) {
    const int hl = __ldg(level_info + 3 * l);
    const int wl = __ldg(level_info + 3 * l + 1);
    const int start = __ldg(level_info + 3 * l + 2);
    const long long base =
        plane0 + static_cast<long long>(start) * row_stride + col;
    const float* vl = value + base;
    float* dvl = d_value + base;
    for (int p = 0; p < points; ++p) {
      const int sp = l * points + p;
      // rounded as the forward and the plain version: loc * W, then - 0.5
      const float x = __fsub_rn(__fmul_rn(__ldg(loc + 2 * sp), wl), 0.5f);
      const float y = __fsub_rn(__fmul_rn(__ldg(loc + 2 * sp + 1), hl), 0.5f);
      const float a = __ldg(aw + sp);
      float part_a = 0.0f, part_x = 0.0f, part_y = 0.0f;
      // some corner is inside (or on the edge, where its weight is 0 but
      // its location gradient is not, as in the plain version's autograd)
      if (x >= -1.0f && y >= -1.0f && x < wl && y < hl) {
        const float xf = floorf(x);
        const float yf = floorf(y);
        const int x0 = static_cast<int>(xf);
        const int y0 = static_cast<int>(yf);
        const float lx = x - xf;
        const float ly = y - yf;
        const float hx = 1.0f - lx;
        const float hy = 1.0f - ly;
        const float ga = g * a;
        // corners (dy, dx) with weights wy * wx; dwx/dx = +-1, dwy/dy = +-1
        for (int dy = 0; dy < 2; ++dy) {
          const int yi = y0 + dy;
          if (yi < 0 || yi >= hl) continue;
          const float wy = dy ? ly : hy;
          for (int dx = 0; dx < 2; ++dx) {
            const int xi = x0 + dx;
            if (xi < 0 || xi >= wl) continue;
            const float wx = dx ? lx : hx;
            const long long off = (static_cast<long long>(yi) * wl + xi) *
                                  row_stride;
            const float gv = g * __ldg(vl + off);
            part_a += wx * wy * gv;
            part_x += dx ? wy * gv : -wy * gv;
            part_y += dy ? wx * gv : -wx * gv;
            atomicAdd(dvl + off, ga * (wx * wy));
          }
        }
      }
      part_a = group_sum(part_a, hd, mask);
      part_x = group_sum(part_x, hd, mask);
      part_y = group_sum(part_y, hd, mask);
      if (c == 0) {
        d_attn[sample0 + sp] = part_a;
        d_locs[2 * (sample0 + sp)] = a * part_x * wl;
        d_locs[2 * (sample0 + sp) + 1] = a * part_y * hl;
      }
    }
  }
}

}  // namespace

extern "C" {

// value: (B, S, heads, hd) f32; level_info: (levels, 3) int32 device array
// of (H, W, start); locs: (B, Q, heads, levels, points, 2) f32; attn:
// (B, Q, heads, levels, points) f32; grad_out: (B, Q, heads * hd) f32.
// Outputs: d_value like value, zeroed by the caller; d_locs like locs and
// d_attn like attn, every element written here.  hd must divide 32.
int demf_msda_backward(const void* value, const void* level_info,
                       const void* locs, const void* attn,
                       const void* grad_out, void* d_value, void* d_locs,
                       void* d_attn, int b, int s, int q, int heads, int hd,
                       int levels, int points, void* stream) {
  if (hd <= 0 || hd > 32 || 32 % hd != 0) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(b) * q * heads * hd;
  if (total == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  msda_backward_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const int*>(level_info),
      static_cast<const float*>(locs), static_cast<const float*>(attn),
      static_cast<const float*>(grad_out), static_cast<float*>(d_value),
      static_cast<float*>(d_locs), static_cast<float*>(d_attn), b, s, q,
      heads, hd, levels, points);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
