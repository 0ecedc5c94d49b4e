// Sparse max pool with kernel == stride (MinkowskiMaxPooling, the stem's
// 2x2x2 pool of MinkResNet), forward and backward, on float32 or bfloat16
// rows.
//
// Replaces: demf_tpu/ops/sparse.py:636 sparse_max_pool_batched, whose
// lax.scan over the taps (:652-659) XLA ran as a gather and a maximum a
// tap, and its autograd (the JVP of the chained maximum, transposed into a
// scatter-add a tap).  The port's plain version (ops/sparse.py::
// sparse_max_pool_batched on a CPU tensor) is the same chain in torch; on
// the card autograd turned each tap's gather into an accumulating
// index_put_, which sorts every (row, tap) pair, absent taps clamped onto
// row 0 of their scene.
//
// What it computes, as the chain does:
// - forward: out[b, o, c] = the torch.maximum chain over the valid taps of
//   output row o in table order, from -inf (a NaN operand wins, as in
//   torch.maximum and jnp.maximum; this file takes torch's own expression:
//   the first NaN operand, else fmaxf); a non-finite result (no valid tap,
//   a NaN, +-inf) is 0, and so is an invalid output row.  With a mask
//   pointer it also writes mask[b, o, c]: bit t set where tap t is valid
//   and equal to the output, the output finite and the row valid (the ties
//   of the chain's maximum).
// - backward: the chain's tie rule.  torch.maximum's backward (and
//   jax.lax.max's) halves the gradient on a tie: walking the taps from the
//   last, a tap in the mask gets the running gradient halved, and the
//   running gradient is halved with it, except at the lowest tap of the
//   mask, which takes what is left.  The halvings run in the rows' type,
//   one at a time, as autograd runs them; every other tap gets 0.  The
//   result is written as 0 + share, as the index_put_ that accumulates
//   into zeros writes it (-0 becomes +0).  An input row that no output
//   reads is 0.  With kernel == stride each input row has one parent at
//   most, so each element of d_in is written by one thread at most: no
//   atomics and no sort.  d_in is zeroed first (cudaMemsetAsync in the
//   entry), then the kernel writes the rows that are read.
//
// What bounds it on the card: bytes.  At the stem of a FCAF3D train step
// (8 scenes, 16,384 rows of 64 channels in, 8,192 out, 8 taps) the forward
// reads the rows (33.6 MB float32) and the table (2.1 MB) and writes the
// output (16.8 MB) and the mask (4.2 MB): ~57 MB, ~17 us at 3.35 TB/s; the
// backward moves the same bytes the other way.
//
// The design: a thread owns 16 bytes of channels of an output row (4
// float32 or 8 bf16 values), neighbouring threads on neighbouring channels
// of a row, so a tap's row is read with whole 16-byte loads; the row's 8
// table entries are one broadcast read.  The backward keeps the forward's
// mask (one byte a (row, channel): 4 MB against 34 MB of rows to read
// again) and reads the output gradient, the mask and the table once.
// Rows whose bytes are no multiple of 16 take the same kernels one value a
// thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 8;

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <int V>
struct alignas(V) Bytes {
  uint8_t v[V];
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// torch.maximum(a, b) on the card: a NaN operand wins (a first), else fmaxf
__device__ __forceinline__ float torch_maximum(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    pool_forward_kernel(const T* __restrict__ rows,
                        const int* __restrict__ nbr,
                        const bool* __restrict__ out_valid,
                        T* __restrict__ out, uint8_t* __restrict__ mask,
                        int m_in, int m_out, int c, int k, long long total) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int vecs = c / V;
  const long long row = t / vecs;          // b * m_out + o
  const int col = static_cast<int>(t % vecs) * V;
  const long long base = row / m_out * m_in;
  const int* taps = nbr + row * k;
  float x[kMaxTaps][V];
  int at[kMaxTaps];
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < kMaxTaps; ++i) {
    at[i] = i < k ? __ldg(taps + i) : -1;
    if (at[i] >= 0) {
      const Vec<T, V> r = *reinterpret_cast<const Vec<T, V>*>(
          rows + (base + at[i]) * c + col);
#pragma unroll
      for (int v = 0; v < V; ++v) x[i][v] = widen(r.v[v]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) x[i][v] = -CUDART_INF_F;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = torch_maximum(acc[v], x[i][v]);
  }
  const bool ok = out_valid[row];
  Vec<T, V> o;
  Bytes<V> bits;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const bool keep = ok && isfinite(acc[v]);
    o.v[v] = narrow<T>(keep ? acc[v] : 0.0f);
    uint8_t b = 0;
#pragma unroll
    for (int i = 0; i < kMaxTaps; ++i)
      b |= static_cast<uint8_t>((keep && at[i] >= 0 && x[i][v] == acc[v])
                                << i);
    bits.v[v] = b;
  }
  *reinterpret_cast<Vec<T, V>*>(out + row * c + col) = o;
  if (mask != nullptr)
    *reinterpret_cast<Bytes<V>*>(mask + row * c + col) = bits;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    pool_backward_kernel(const T* __restrict__ grad,
                         const int* __restrict__ nbr,
                         const uint8_t* __restrict__ mask,
                         T* __restrict__ d_in, int m_in, int m_out, int c,
                         int k, long long total) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int vecs = c / V;
  const long long row = t / vecs;
  const int col = static_cast<int>(t % vecs) * V;
  const long long base = row / m_out * m_in;
  const int* taps = nbr + row * k;
  const Vec<T, V> g =
      *reinterpret_cast<const Vec<T, V>*>(grad + row * c + col);
  const Bytes<V> bits =
      *reinterpret_cast<const Bytes<V>*>(mask + row * c + col);
  // each tap's share, walked from the last tap as autograd walks the chain
  float share[kMaxTaps][V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int b = bits.v[v];
    const int lowest = __ffs(b) - 1;
    float run = widen(g.v[v]);
#pragma unroll
    for (int i = kMaxTaps - 1; i >= 0; --i) {
      float s = 0.0f;
      if ((b >> i) & 1) {
        if (i != lowest) run = widen(narrow<T>(run * 0.5f));
        s = run;
      }
      share[i][v] = s;
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxTaps; ++i) {
    const int at = i < k ? __ldg(taps + i) : -1;
    if (at < 0) continue;
    Vec<T, V> d;
#pragma unroll
    for (int v = 0; v < V; ++v)
      d.v[v] = narrow<T>(__fadd_rn(0.0f, share[i][v]));
    *reinterpret_cast<Vec<T, V>*>(d_in + (base + at) * c + col) = d;
  }
}

unsigned blocks_for(long long total) {
  return static_cast<unsigned>((total + kThreads - 1) / kThreads);
}

// a thread 16 bytes of a row where the rows and pointers allow it, else one
// value
template <typename T>
bool whole_vectors(int c, const void* a, const void* b, const void* m) {
  constexpr int kV = 16 / sizeof(T);
  return c % kV == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(m) % kV == 0;
}

template <typename T>
int pool_forward(const void* rows, const void* nbr, const void* out_valid,
                 void* out, void* mask, int b, int m_in, int m_out, int c,
                 int k, void* stream) {
  if (k > kMaxTaps) return static_cast<int>(cudaErrorInvalidValue);
  const long long cells = static_cast<long long>(b) * m_out * c;
  if (cells == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kV = 16 / sizeof(T);
  const T* r = static_cast<const T*>(rows);
  const int* n = static_cast<const int*>(nbr);
  const bool* ov = static_cast<const bool*>(out_valid);
  T* o = static_cast<T*>(out);
  uint8_t* mk = static_cast<uint8_t*>(mask);
  if (whole_vectors<T>(c, rows, out, mask)) {
    pool_forward_kernel<T, kV><<<blocks_for(cells / kV), kThreads, 0, s>>>(
        r, n, ov, o, mk, m_in, m_out, c, k, cells / kV);
  } else {
    pool_forward_kernel<T, 1><<<blocks_for(cells), kThreads, 0, s>>>(
        r, n, ov, o, mk, m_in, m_out, c, k, cells);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int pool_backward(const void* grad, const void* nbr, const void* mask,
                  void* d_in, int b, int m_in, int m_out, int c, int k,
                  void* stream) {
  if (k > kMaxTaps) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t in_bytes = static_cast<size_t>(b) * m_in * c * sizeof(T);
  if (in_bytes) {
    const cudaError_t err = cudaMemsetAsync(d_in, 0, in_bytes, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long cells = static_cast<long long>(b) * m_out * c;
  if (cells == 0) return static_cast<int>(cudaGetLastError());
  constexpr int kV = 16 / sizeof(T);
  const T* g = static_cast<const T*>(grad);
  const int* n = static_cast<const int*>(nbr);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  T* d = static_cast<T*>(d_in);
  if (whole_vectors<T>(c, grad, d_in, mask)) {
    pool_backward_kernel<T, kV><<<blocks_for(cells / kV), kThreads, 0, s>>>(
        g, n, mk, d, m_in, m_out, c, k, cells / kV);
  } else {
    pool_backward_kernel<T, 1><<<blocks_for(cells), kThreads, 0, s>>>(
        g, n, mk, d, m_in, m_out, c, k, cells);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rows: (B, M_in, C); nbr: (B, M_out, K) int32, -1 for an absent tap, each
// entry a row of its own scene; out_valid: (B, M_out) bool; out: (B, M_out,
// C) of the rows' type; mask: (B, M_out, C) uint8 or null (inference).
// K <= 8.
int demf_sparse_max_pool(const void* rows, const void* nbr,
                         const void* out_valid, void* out, void* mask, int b,
                         int m_in, int m_out, int c, int k, void* stream) {
  return pool_forward<float>(rows, nbr, out_valid, out, mask, b, m_in, m_out,
                             c, k, stream);
}

int demf_sparse_max_pool_bf16(const void* rows, const void* nbr,
                              const void* out_valid, void* out, void* mask,
                              int b, int m_in, int m_out, int c, int k,
                              void* stream) {
  return pool_forward<__nv_bfloat16>(rows, nbr, out_valid, out, mask, b,
                                     m_in, m_out, c, k, stream);
}

// grad: (B, M_out, C) of the rows' type; nbr and mask the forward's; d_in:
// (B, M_in, C), zeroed here, then each read row written once.  The table
// must give each input row one reader at most (kernel == stride).
int demf_sparse_max_pool_backward(const void* grad, const void* nbr,
                                  const void* mask, void* d_in, int b,
                                  int m_in, int m_out, int c, int k,
                                  void* stream) {
  return pool_backward<float>(grad, nbr, mask, d_in, b, m_in, m_out, c, k,
                              stream);
}

int demf_sparse_max_pool_backward_bf16(const void* grad, const void* nbr,
                                       const void* mask, void* d_in, int b,
                                       int m_in, int m_out, int c, int k,
                                       void* stream) {
  return pool_backward<__nv_bfloat16>(grad, nbr, mask, d_in, b, m_in, m_out,
                                      c, k, stream);
}

}  // extern "C"
