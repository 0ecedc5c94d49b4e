// The sparse convolution's weight gradient (kernel K16): for each tap t,
// dW[t] = sum over scenes b and output rows m of feats[b, nbr[b, m, t]]^T
// g[b, m], a row whose tap t is -1 adding 0.  feats (B, M_in, C), nbr
// (B, M_out, K) int32, g (B, M_out, C_out), all float32; dW (K, C, C_out)
// float32, every element written, the same bits every call.
//
// Replaces: demf_tpu/ops/sparse.py::_conv_dweights (:414), XLA code called
// from the custom VJPs _conv_sym_bwd (:452) and _conv_revgeo_bwd (:494): a
// scan over the K taps, each a row gather of (B * M_out, C) and one float32
// einsum over the rows.  Every sparse convolution of a FCAF3D train step
// takes it once in its backward (the stem's too: its colours take no
// gradient, its kernel does).
//
// What bounds it on the card: operations, 2 x sum over taps of the rows
// that have the tap x C x C_out, at float32's 67 TFLOP/s outside the
// tensor cores (this version's FMAs); the bytes (feats and g read once, dW
// written once) are ~C + C_out floats a row, so at MinkResNet's widths (C
// and C_out >= 64, ~10 taps a row) the operations bind; at the stem (C 3)
// the bytes.
//
// This first version:
// * It walks K14's row plan of the forward table (ops/sparse.py::
//   conv_plan): the rows of each scene sorted by tap mask, each 64-row
//   tile's taps as a bit list, so a block reads a tile's rows only where
//   the tile lists its tap.
// * A block owns one (tap, 64 x 64 tile of C x C_out, slice of the (scene,
//   row tile) list).  For each tile of its slice that lists its tap, it
//   gathers the 64 rows' feats[nbr[row, t]] (0 where absent) and g[row]
//   into shared memory, and 256 threads each add a 4 x 4 part of the 64 x
//   64 product over the 64 rows, float32 FMAs into registers.
// * The wrapper cuts the list into slices (ops/sparse.py::dweights_slices)
//   so that the grid holds 4 x 132 blocks; with more than one, each writes
//   its partial tile to scratch (slices, K, C, C_out), which the wrapper
//   makes with torch.empty, and dweights_sum adds the slices in order 0, 1,
//   .. (no float atomics: the same bits every call).
// * Not done here: 3xTF32 mma.sync as K14 runs it, a ring of stages, the
//   stem's C = 3 (a 64-wide channel tile, 3 of it used).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // a row tile of the plan
constexpr int kTile = 64;      // C and C_out a block
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 sums each
constexpr int kLd = kTile + 4; // a shared row, 16-byte aligned
constexpr int kMaxTaps = 32;

struct Args {
  const float* feats;
  const int* nbr;
  const float* g;
  const int* order;      // (B, M_out) the plan's rows
  const int* tile_taps;  // (B, tiles) each tile's taps as bits
  float* scratch;        // (slices, K, C, C_out) when slices > 1
  float* out;            // (K, C, C_out)
  int batch, m_in, c, m_out, k, c_out, tiles, slices, c_tiles, n_tiles;
};

__global__ void __launch_bounds__(kThreads) dweights_tiles(Args a) {
  __shared__ __align__(16) float sa[kRows * kLd];  // gathered feats
  __shared__ __align__(16) float sg[kRows * kLd];  // g of the same rows
  __shared__ int s_src[kRows];                     // feats row, or -1
  __shared__ int s_row[kRows];                     // g row, or -1

  const int nt = blockIdx.x % a.n_tiles;
  const int ct = (blockIdx.x / a.n_tiles) % a.c_tiles;
  const int t = blockIdx.x / (a.n_tiles * a.c_tiles);
  const int slice = blockIdx.y;
  const int c0 = ct * kTile, n0 = nt * kTile;
  const int tid = threadIdx.x, tc = tid / 16, tn = tid % 16;
  const int total = a.batch * a.tiles;  // (scene, row tile), scene-major
  const int per = (total + a.slices - 1) / a.slices;
  const int lo = slice * per, hi = min(lo + per, total);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int rt = lo; rt < hi; ++rt) {
    const int b = rt / a.tiles, tile = rt - b * a.tiles;
    const unsigned taps = static_cast<unsigned>(
        a.tile_taps[static_cast<long long>(b) * a.tiles + tile]);
    if (!((taps >> t) & 1u)) continue;  // the same for the whole block
    __syncthreads();                    // the last tile's products are done
    if (tid < kRows) {
      const int i = tile * kRows + tid;
      int row = -1, src = -1;
      if (i < a.m_out) {
        row = a.order[static_cast<long long>(b) * a.m_out + i];
        src = a.nbr[(static_cast<long long>(b) * a.m_out + row) * a.k + t];
      }
      s_src[tid] = src;
      s_row[tid] = src >= 0 ? row : -1;
    }
    __syncthreads();
    for (int e = tid; e < kRows * kTile; e += kThreads) {
      const int r = e / kTile, cc = e % kTile;
      const int src = s_src[r], row = s_row[r];
      float v = 0.f, w = 0.f;
      if (src >= 0 && c0 + cc < a.c)
        v = a.feats[(static_cast<long long>(b) * a.m_in + src) * a.c + c0 +
                    cc];
      if (row >= 0 && n0 + cc < a.c_out)
        w = a.g[(static_cast<long long>(b) * a.m_out + row) * a.c_out + n0 +
                cc];
      sa[r * kLd + cc] = v;
      sg[r * kLd + cc] = w;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kRows; ++r) {
      const float4 av = *reinterpret_cast<const float4*>(sa + r * kLd +
                                                         tc * 4);
      const float4 gv = *reinterpret_cast<const float4*>(sg + r * kLd +
                                                         tn * 4);
      const float x[4] = {av.x, av.y, av.z, av.w};
      const float y[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
  }

  float* dst = a.slices > 1
                   ? a.scratch + static_cast<long long>(slice) * a.k * a.c *
                                     a.c_out
                   : a.out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + tc * 4 + i;
    if (c >= a.c) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn * 4 + j;
      if (n < a.c_out)
        dst[(static_cast<long long>(t) * a.c + c) * a.c_out + n] = acc[i][j];
    }
  }
}

// dW = the slices' partial tiles summed in order 0, 1, .. (rounded adds).
__global__ void dweights_sum(const float* __restrict__ scratch,
                             float* __restrict__ out, long long n,
                             int slices) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < n; e += stride) {
    float s = scratch[e];
    for (int p = 1; p < slices; ++p) s = __fadd_rn(s, scratch[p * n + e]);
    out[e] = s;
  }
}

}  // namespace

extern "C" {

// feats (B, M_in, C), nbr (B, M_out, K) int32, g (B, M_out, C_out), the
// plan's order (B, M_out) and tile taps (B, ceil(M_out / 64)) int32,
// float32 scratch (slices, K, C, C_out) when slices > 1 (else null), out
// (K, C, C_out) float32, every element written.
int demf_sparse_conv_dweights(const void* feats, const void* nbr,
                              const void* g, const void* order,
                              const void* tile_taps, void* scratch,
                              void* out, int b, int m_in, int c, int m_out,
                              int k, int c_out, int slices, void* stream) {
  if (k == 0 || c == 0 || c_out == 0) return 0;
  if (k < 0 || k > kMaxTaps || slices < 1 || (slices > 1 && !scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a;
  a.feats = static_cast<const float*>(feats);
  a.nbr = static_cast<const int*>(nbr);
  a.g = static_cast<const float*>(g);
  a.order = static_cast<const int*>(order);
  a.tile_taps = static_cast<const int*>(tile_taps);
  a.scratch = static_cast<float*>(scratch);
  a.out = static_cast<float*>(out);
  a.batch = b;
  a.m_in = m_in;
  a.c = c;
  a.m_out = m_out;
  a.k = k;
  a.c_out = c_out;
  a.tiles = (m_out + kRows - 1) / kRows;
  a.slices = slices;
  a.c_tiles = (c + kTile - 1) / kTile;
  a.n_tiles = (c_out + kTile - 1) / kTile;
  const dim3 grid(k * a.c_tiles * a.n_tiles, slices);
  dweights_tiles<<<grid, kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(k) * c * c_out;
  const int blocks =
      static_cast<int>((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  dweights_sum<<<blocks, 256, 0, s>>>(a.scratch, a.out, n, slices);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
