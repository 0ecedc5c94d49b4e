// What K3 (msda.cu) and K4 (msda_backward.cu) share: the spatial tile of
// one level's queries that a block owns (the tables come from
// ops/msda.py::msda_tiling), the window of a level's value rows under that
// tile, cp.async, and the value's element type: float32 or bfloat16, read
// 16 bytes at a time (4 or 8 channels) and widened to float32 in registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace msda {

constexpr int kMaxTile = 256;   // queries of a tile (16 x 16 pixels)
constexpr int kMargin = 5;      // pixels of window around a tile's footprint

// the kN channels of one value row in one 16-byte load, as float32
template <typename T>
struct Row {
  static constexpr int kN = 16 / sizeof(T);
  float v[kN];
};

template <typename T>
__device__ Row<T> widen(const uint4& raw);

template <>
__device__ __forceinline__ Row<float> widen<float>(const uint4& raw) {
  Row<float> r;
  r.v[0] = __uint_as_float(raw.x);
  r.v[1] = __uint_as_float(raw.y);
  r.v[2] = __uint_as_float(raw.z);
  r.v[3] = __uint_as_float(raw.w);
  return r;
}

// a 32-bit word holds two bfloat16s, the first in its low half; a
// bfloat16 is the high half of the float32 it widens to, exactly
template <>
__device__ __forceinline__ Row<__nv_bfloat16> widen<__nv_bfloat16>(
    const uint4& raw) {
  Row<__nv_bfloat16> r;
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r.v[2 * i] = __uint_as_float(w[i] << 16);
    r.v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
  return r;
}

// 16 bytes of T at p (shared or global memory), as float32
template <typename T>
__device__ __forceinline__ Row<T> load_row16(const T* p) {
  return widen<T>(*reinterpret_cast<const uint4*>(p));
}

// the same through the read-only cache (global memory)
template <typename T>
__device__ __forceinline__ Row<T> ldg_row16(const T* p) {
  return widen<T>(__ldg(reinterpret_cast<const uint4*>(p)));
}

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

// kN float32 sums stored as 16 bytes of T: a bfloat16 is rounded once, here
__device__ __forceinline__ void store_row16(float* p, const Row<float>& r) {
  *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2],
                                              r.v[3]);
}

__device__ __forceinline__ void store_row16(__nv_bfloat16* p,
                                            const Row<__nv_bfloat16>& r) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack2(r.v[0], r.v[1]), pack2(r.v[2], r.v[3]),
                 pack2(r.v[4], r.v[5]), pack2(r.v[6], r.v[7]));
}

// the window of one level's rows in shared memory: [y0, y0 + h) x [x0, x0 + w)
template <typename T>
struct Window {
  const T* rows;
  int x0, y0, w, h;
};

// a tile of th x tw queries whose first is pixel (ty0, tx0) of a level of
// hq x wq tokens that starts at token startq
struct Tile {
  int th, tw, ty0, tx0, hq, wq, startq;
};

// tile_info: (levels, 5) of tile H, tile W, tiles across, tiles of the
// level, first tile of the level; level_info: (levels, 3) of H, W, first
// token.  tile counts over all tiled levels of one (scene, head).
__device__ __forceinline__ Tile decode_tile(const int* tile_info,
                                            const int* level_info, int levels,
                                            int tile) {
  int lq = 0;
  while (lq + 1 < levels && tile >= __ldg(tile_info + 5 * (lq + 1) + 4) &&
         __ldg(tile_info + 5 * (lq + 1) + 3) > 0)
    ++lq;
  Tile t;
  t.th = __ldg(tile_info + 5 * lq);
  t.tw = __ldg(tile_info + 5 * lq + 1);
  const int across = __ldg(tile_info + 5 * lq + 2);
  const int in_level = tile - __ldg(tile_info + 5 * lq + 4);
  t.ty0 = (in_level / across) * t.th;
  t.tx0 = (in_level % across) * t.tw;
  t.hq = __ldg(level_info + 3 * lq);
  t.wq = __ldg(level_info + 3 * lq + 1);
  t.startq = __ldg(level_info + 3 * lq + 2);
  return t;
}

// the tile's footprint on a level of hl x wl rows, kMargin pixels around it
// and one more for the far corner, cut to the level and to `room` rows
template <typename T>
__device__ __forceinline__ Window<T> level_window(const Tile& t, int hl,
                                                  int wl, int room,
                                                  const T* rows) {
  Window<T> win;
  win.rows = rows;
  win.x0 = max(0, t.tx0 * wl / t.wq - kMargin);
  win.y0 = max(0, t.ty0 * hl / t.hq - kMargin);
  win.w = min(wl, ((t.tx0 + t.tw) * wl + t.wq - 1) / t.wq + kMargin + 1) -
          win.x0;
  win.h = min(hl, ((t.ty0 + t.th) * hl + t.hq - 1) / t.hq + kMargin + 1) -
          win.y0;
  while (win.w * win.h > room) {
    if (win.w >= win.h) {
      win.x0 += win.w & 1;
      --win.w;
    } else {
      win.y0 += win.h & 1;
      --win.h;
    }
  }
  return win;
}

// 4, 8 or 16 bytes from global to shared memory, not waited for
template <int kBytes>
__device__ __forceinline__ void copy_async(void* to, const void* from) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(to));
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                 "l"(from)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(dst),
                 "l"(from), "n"(kBytes)
                 : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Copies the window's rows (hd values each, of one head) from the level's
// plane to shared memory: the thread of `per_pass` slots that owns channels
// [c, c + 16 / sizeof(T)) copies its 16 bytes of rows slot, slot +
// per_pass, ...; (wy, wx) is the row's place in the window, stepped without
// a division.  vlevel points at the head's channels of the level's first
// row.
template <typename T>
__device__ __forceinline__ void copy_window(T* to, const Window<T>& win,
                                            const T* vlevel, int wl,
                                            long long row_stride, int hd,
                                            int slot, int per_pass, int c) {
  const int step_y = per_pass / win.w, step_x = per_pass % win.w;
  int wy = slot / win.w, wx = slot % win.w;
  for (int r = slot; r < win.w * win.h; r += per_pass) {
    copy_async<16>(to + r * hd + c,
                   vlevel + static_cast<long long>((win.y0 + wy) * wl +
                                                   win.x0 + wx) *
                                row_stride + c);
    wy += step_y;
    wx += step_x;
    if (wx >= win.w) {
      wx -= win.w;
      ++wy;
    }
  }
}

}  // namespace msda
