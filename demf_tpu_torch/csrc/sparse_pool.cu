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
//   of the chain's maximum); and the reverse index reader[b, i] = o * 8 + t
//   of the one (output row, tap) of a valid row that reads input row i.
//   The index is not filled: the backward takes an entry only where the
//   table confirms it (nbr[b, o, t] == i), so an entry that no thread of
//   this forward wrote (stale memory) is either rejected or names a tap
//   that does read row i, of an invalid row, whose mask is 0.
// - backward: the chain's tie rule.  torch.maximum's backward (and
//   jax.lax.max's) halves the gradient on a tie: walking the taps from the
//   last, a tap in the mask gets the running gradient halved, and the
//   running gradient is halved with it, except at the lowest tap of the
//   mask, which takes what is left.  So tap t's share is the gradient
//   halved once for each mask bit at or above t, the lowest bit not
//   counted; the halvings run in the rows' type, one at a time, as
//   autograd runs them; a tap not in the mask gets 0.  The result is
//   written as 0 + share, as the index_put_ that accumulates into zeros
//   writes it (-0 becomes +0).  An input row that no valid output reads is
//   0.  With kernel == stride each input row has one reader at most, so a
//   thread a (input row, 16 bytes of channels) reads its reader from the
//   reverse index, checks it against the table and writes its part of d_in
//   once: every row of d_in, read or not, in one pass, with no fill of
//   d_in or of the index, no atomics and no sort.
//
// What bounds it on the card: bytes.  At the stem of a FCAF3D train step
// (8 scenes, 16,384 rows of 64 channels in, 8,192 out, 8 taps) the forward
// reads the rows its present taps point to, the table and out_valid and
// writes the output; the backward reads the output gradient and writes
// d_in whole.  The tie mask (a byte a (output row, channel)) and the
// reverse index (4 bytes an input row, 0.5 MB at the stem) are this
// design's bytes on top.
//
// The design: neighbouring threads on neighbouring channels of a row, so a
// row is read and written with whole vector loads and stores; each launch
// one kernel, its index math in 32 bits.
// - forward, a thread a (output row, 4 channels: 16 bytes of float32, 8 of
//   bf16; 8 bf16 values a thread took 100 registers and left fewer
//   threads resident than a float32 forward): the row's 8 table entries
//   come in as two 16-byte loads beside its validity; then every present
//   tap's row load is issued before the first of them is used, so a
//   thread's loads overlap; an invalid row loads no tap.  bf16 values stay
//   packed as they were loaded until each is compared, and the running
//   maximum stays in the rows' type (exact: it is one of them).  The tie
//   mask is built while walking the taps: (running maximum, bits of the
//   taps equal to it), a greater tap clearing the bits, an equal one
//   adding its bit; a NaN makes the maximum NaN for good and a non-finite
//   maximum clears the mask at the end, so the bits equal those of the
//   final compare in every case (NaN, +-inf, +-0, absent taps, invalid
//   rows, ties of 2 to 8 taps) with no tap's values kept.
// - backward, a thread a (input row, 16 bytes): the reader, its table
//   entry, then the output gradient's and the mask's bytes of that row,
//   the shares, one store.  An input row without a reader is written 0
//   without a read of either.
// Rows whose bytes are no multiple of 16 take the same kernels one value a
// thread; tables of fewer than 8 taps (or not 16-byte aligned) are read
// an entry at a time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
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

// a row's K table entries, -1 beyond K; kWide: K == 8 on a 16-byte aligned
// table, two 16-byte loads
template <bool kWide>
__device__ __forceinline__ void load_taps(const int* __restrict__ taps,
                                          int k, int (&at)[kMaxTaps]) {
  if (kWide) {
    const int4 lo = __ldg(reinterpret_cast<const int4*>(taps));
    const int4 hi = __ldg(reinterpret_cast<const int4*>(taps) + 1);
    at[0] = lo.x, at[1] = lo.y, at[2] = lo.z, at[3] = lo.w;
    at[4] = hi.x, at[5] = hi.y, at[6] = hi.z, at[7] = hi.w;
  } else {
#pragma unroll
    for (int i = 0; i < kMaxTaps; ++i) at[i] = i < k ? __ldg(taps + i) : -1;
  }
}

template <typename T, int V, bool kWide>
__global__ void __launch_bounds__(kThreads)
    pool_forward_kernel(const T* __restrict__ rows,
                        const int* __restrict__ nbr,
                        const bool* __restrict__ out_valid,
                        T* __restrict__ out, uint8_t* __restrict__ mask,
                        int* __restrict__ reader, int m_in, int m_out, int c,
                        int k, int total) {
  constexpr int kWords = (V + 3) / 4;      // the mask's bytes, 4 a word
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int vecs = c / V;
  const int row = t / vecs;                // b * m_out + o
  const int col = (t - row * vecs) * V;
  const int scene = row / m_out;
  const long long base = static_cast<long long>(scene) * m_in;
  int at[kMaxTaps];
  load_taps<kWide>(nbr + static_cast<long long>(row) * k, k, at);
  const bool ok = out_valid[row];
  // every present tap's row in flight before the first is used
  Vec<T, V> x[kMaxTaps];
#pragma unroll
  for (int i = 0; i < kMaxTaps; ++i)
    if (ok && at[i] >= 0)
      x[i] = *reinterpret_cast<const Vec<T, V>*>(rows + (base + at[i]) * c +
                                                 col);
  Vec<T, V> acc;
  uint32_t bits[kWords];
#pragma unroll
  for (int v = 0; v < V; ++v) acc.v[v] = narrow<T>(-CUDART_INF_F);
#pragma unroll
  for (int w = 0; w < kWords; ++w) bits[w] = 0;
#pragma unroll
  for (int i = 0; i < kMaxTaps; ++i) {
    if (!(ok && at[i] >= 0)) continue;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float a = widen(acc.v[v]), y = widen(x[i].v[v]);
      const int shift = (v % 4) * 8;
      if (y > a)
        bits[v / 4] = (bits[v / 4] & ~(0xffu << shift)) | (1u << (shift + i));
      else if (y == a)
        bits[v / 4] |= 1u << (shift + i);
      acc.v[v] = narrow<T>(torch_maximum(a, y));
    }
  }
  Vec<T, V> o;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float a = widen(acc.v[v]);
    const bool keep = ok && isfinite(a);
    o.v[v] = narrow<T>(keep ? a : 0.0f);
    if (!keep) bits[v / 4] &= ~(0xffu << ((v % 4) * 8));
  }
  const long long at_out = static_cast<long long>(row) * c + col;
  *reinterpret_cast<Vec<T, V>*>(out + at_out) = o;
  if (mask == nullptr) return;
  Bytes<V> b;
#pragma unroll
  for (int v = 0; v < V; ++v) b.v[v] = (bits[v / 4] >> ((v % 4) * 8)) & 0xff;
  *reinterpret_cast<Bytes<V>*>(mask + at_out) = b;
  if (col != 0 || !ok) return;
  const int me = (row - scene * m_out) * kMaxTaps;
#pragma unroll
  for (int i = 0; i < kMaxTaps; ++i)
    if (at[i] >= 0) reader[base + at[i]] = me + i;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    pool_backward_kernel(const T* __restrict__ grad,
                         const int* __restrict__ reader,
                         const int* __restrict__ nbr,
                         const uint8_t* __restrict__ mask,
                         T* __restrict__ d_in, int m_in, int m_out, int c,
                         int k, int total) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int vecs = c / V;
  const int row = t / vecs;                // b * m_in + i
  const int col = (t - row * vecs) * V;
  const int scene = row / m_in;
  const int who = __ldg(reader + row);
  const int tap = who % kMaxTaps;
  const long long o =
      static_cast<long long>(scene) * m_out + who / kMaxTaps;
  // an entry counts where the table confirms it: one this forward did not
  // write is stale memory
  const bool read = who >= 0 && who / kMaxTaps < m_out && tap < k &&
                    __ldg(nbr + o * k + tap) == row - scene * m_in;
  Vec<T, V> d;
  if (!read) {
#pragma unroll
    for (int v = 0; v < V; ++v) d.v[v] = narrow<T>(0.0f);
  } else {
    const Vec<T, V> g =
        *reinterpret_cast<const Vec<T, V>*>(grad + o * c + col);
    const Bytes<V> bits =
        *reinterpret_cast<const Bytes<V>*>(mask + o * c + col);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int b = bits.v[v];
      float share = 0.0f;
      if ((b >> tap) & 1) {
        // halved once a mask bit at or above the tap, the lowest not
        const int halvings =
            __popc(b >> tap) - ((b & ((1 << tap) - 1)) == 0 ? 1 : 0);
        share = widen(g.v[v]);
        for (int h = 0; h < halvings; ++h)
          share = widen(narrow<T>(share * 0.5f));
      }
      d.v[v] = narrow<T>(__fadd_rn(0.0f, share));
    }
  }
  *reinterpret_cast<Vec<T, V>*>(d_in + static_cast<long long>(row) * c +
                              col) = d;
}

unsigned blocks_for(int total) {
  return static_cast<unsigned>((total + kThreads - 1) / kThreads);
}

// a thread kV values of a row where the rows and pointers allow it, else
// one value
template <typename T, int kV>
bool whole_vectors(int c, const void* a, const void* b, const void* m) {
  constexpr uintptr_t kAlign = sizeof(T) * kV;
  return c % kV == 0 && reinterpret_cast<uintptr_t>(a) % kAlign == 0 &&
         reinterpret_cast<uintptr_t>(b) % kAlign == 0 &&
         reinterpret_cast<uintptr_t>(m) % kV == 0;
}

template <typename T, int V>
void launch_forward(bool wide, int threads, cudaStream_t s,
                    const T* r, const int* n, const bool* ov, T* o,
                    uint8_t* mk, int* rd, int m_in, int m_out, int c, int k) {
  if (wide)
    pool_forward_kernel<T, V, true><<<blocks_for(threads), kThreads, 0, s>>>(
        r, n, ov, o, mk, rd, m_in, m_out, c, k, threads);
  else
    pool_forward_kernel<T, V, false><<<blocks_for(threads), kThreads, 0, s>>>(
        r, n, ov, o, mk, rd, m_in, m_out, c, k, threads);
}

// the most threads (and rows) a launch indexes in 32 bits
bool fits(int b, int m, int c) {
  return static_cast<long long>(b) * m * c <= INT_MAX;
}

template <typename T>
int pool_forward(const void* rows, const void* nbr, const void* out_valid,
                 void* out, void* mask, void* reader, int b, int m_in,
                 int m_out, int c, int k, void* stream) {
  if (k > kMaxTaps || m_out > INT_MAX / kMaxTaps || !fits(b, m_out, c) ||
      !fits(b, m_in, 1) || (mask == nullptr) != (reader == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cells = b * m_out * c;
  if (cells == 0) return 0;
  constexpr int kV = 4;
  const bool wide =
      k == kMaxTaps && reinterpret_cast<uintptr_t>(nbr) % 16 == 0;
  const T* r = static_cast<const T*>(rows);
  const int* n = static_cast<const int*>(nbr);
  const bool* ov = static_cast<const bool*>(out_valid);
  T* o = static_cast<T*>(out);
  uint8_t* mk = static_cast<uint8_t*>(mask);
  int* rd = static_cast<int*>(reader);
  if (whole_vectors<T, kV>(c, rows, out, mask))
    launch_forward<T, kV>(wide, cells / kV, s, r, n, ov, o, mk, rd, m_in,
                          m_out, c, k);
  else
    launch_forward<T, 1>(wide, cells, s, r, n, ov, o, mk, rd, m_in, m_out,
                         c, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int pool_backward(const void* grad, const void* reader, const void* nbr,
                  const void* mask, void* d_in, int b, int m_in, int m_out,
                  int c, int k, void* stream) {
  if (k > kMaxTaps || m_out > INT_MAX / kMaxTaps || !fits(b, m_in, c))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cells = b * m_in * c;
  if (cells == 0) return 0;
  constexpr int kV = 16 / sizeof(T);
  const T* g = static_cast<const T*>(grad);
  const int* rd = static_cast<const int*>(reader);
  const int* n = static_cast<const int*>(nbr);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  T* d = static_cast<T*>(d_in);
  if (whole_vectors<T, kV>(c, grad, d_in, mask)) {
    pool_backward_kernel<T, kV><<<blocks_for(cells / kV), kThreads, 0, s>>>(
        g, rd, n, mk, d, m_in, m_out, c, k, cells / kV);
  } else {
    pool_backward_kernel<T, 1><<<blocks_for(cells), kThreads, 0, s>>>(
        g, rd, n, mk, d, m_in, m_out, c, k, cells);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rows: (B, M_in, C); nbr: (B, M_out, K) int32, -1 for an absent tap, each
// entry a row of its own scene; out_valid: (B, M_out) bool; out: (B, M_out,
// C) of the rows' type; mask: (B, M_out, C) uint8 and reader: (B, M_in)
// int32 (written where read, not filled), both null (inference) or
// neither.  K <= 8; B * M_out * C and B * M_in at most 2^31 - 1.
int demf_sparse_max_pool(const void* rows, const void* nbr,
                         const void* out_valid, void* out, void* mask,
                         void* reader, int b, int m_in, int m_out, int c,
                         int k, void* stream) {
  return pool_forward<float>(rows, nbr, out_valid, out, mask, reader, b,
                             m_in, m_out, c, k, stream);
}

int demf_sparse_max_pool_bf16(const void* rows, const void* nbr,
                              const void* out_valid, void* out, void* mask,
                              void* reader, int b, int m_in, int m_out,
                              int c, int k, void* stream) {
  return pool_forward<__nv_bfloat16>(rows, nbr, out_valid, out, mask, reader,
                                     b, m_in, m_out, c, k, stream);
}

// grad: (B, M_out, C) of the rows' type; reader, nbr and mask the
// forward's; d_in: (B, M_in, C), every row written once.  The table must
// give each input row one reader at most (kernel == stride).
int demf_sparse_max_pool_backward(const void* grad, const void* reader,
                                  const void* nbr, const void* mask,
                                  void* d_in, int b, int m_in, int m_out,
                                  int c, int k, void* stream) {
  return pool_backward<float>(grad, reader, nbr, mask, d_in, b, m_in, m_out,
                              c, k, stream);
}

int demf_sparse_max_pool_backward_bf16(const void* grad, const void* reader,
                                       const void* nbr, const void* mask,
                                       void* d_in, int b, int m_in, int m_out,
                                       int c, int k, void* stream) {
  return pool_backward<__nv_bfloat16>(grad, reader, nbr, mask, d_in, b, m_in,
                                      m_out, c, k, stream);
}

}  // extern "C"
