// Gather-GEMM sparse convolution, forward: out[b, m, :] = sum over taps t
// of feats[b, nbr[b, m, t], :] @ W[t], a tap whose row is -1 adding 0.
// feats (B, M_in, C), nbr (B, M_out, K) int32, W (K, C, C_out); float32 or
// bfloat16 rows and weights (one dtype), float32 sums, the output in their
// dtype, rounded once.
//
// Replaces: demf_tpu/ops/sparse.py::_conv_scan_math (reached through
// sparse_conv_apply_batched), XLA code: a scan over the K taps, each a row
// gather of (B * M_out, C) and one (C, C_out) matmul on the MXU, the sum
// kept in the rows' dtype.  Every convolution of MinkResNet and of the
// FCAF3D head goes through it (K 27, 8 or 1).
//
// What bounds it on the card: operations, the taps that exist (45 GFLOP a
// FCAF3D request of 2 scenes; 67 TFLOP/s float32, 989 bf16 on the tensor
// cores; the float32 entry's 3xTF32 below does three TF32 products a
// multiply-add, so its own floor is TF32's 495 / 3 = 165); the bytes (features and weights read once, the output written
// once) are ~0.25 GB.  Layers 3-4 (1,024 and 512 rows a scene, C 256 and
// 512) carry most of the operations on few rows: at batch 2 they give a
// card of 132 SMs only ~128 tiles of 64 x 64.
//
// The first version (a 64 x 64 tile of rows in key order, float32 FMAs
// from shared memory, a tap skipped only when no row of the tile had it)
// computed ~220 GFLOP for those 45 and ran at 2.6 TFLOP/s.  This design:
//
// * A row plan (ops/sparse.py::conv_plan, built once a neighbour table by
//   sparse_conv_plan below and shared by the convolutions that read it):
//   each row's tap mask (bit t set where nbr >= 0), the rows of each scene
//   sorted stably by mask, so that rows with the same taps share a tile,
//   and each tile's taps (the OR of its 64 rows' masks) as a bit list.
//   Rows with no tap (padding, an empty scene) stay in the order and are
//   written as 0.
// * A block owns a tile of 64 plan-ordered rows x 64 output channels, 4
//   warps of 32 x 32.  It stages its rows' table entries for its taps in
//   shared memory, then walks (tap of its list, chunk of 32 input
//   channels): the 64 gathered input rows (zero-filled for an absent tap)
//   and the tap's 32 x 64 slice of W go by 16-byte cp.async into a ring of
//   stages (4 in bf16, 3 in float32), so the next stages load while this
//   one is multiplied.  Rows or weights that 16-byte copies cannot carry
//   (C or C_out not a multiple of 8 bf16 / 4 float32: the stem's C = 3) go
//   by element over the flat depth of the tile's taps (C = 3, 27 taps: one
//   product of depth 81), through the same ring.
// * bf16: mma.sync.m16n8k16 on the tensor cores (ldmatrix; float32
//   accumulators in registers).  wgmma would take A from registers and B
//   from shared memory in its swizzled layout; that is the next step and
//   not this version's.
// * float32: 3xTF32 on the tensor cores (mma.sync.m16n8k8): each operand
//   split into a TF32 high part and the TF32 rounding of the rest, and
//   lo*hi + hi*lo + hi*hi summed, which keeps float32's accuracy (plain
//   TF32 keeps ~3 digits).  The tensor cores' own additions truncate, so
//   each 32-channel chunk is summed apart and added to the float32 sums
//   with a rounded add: the truncations never pile up over a long depth.
//   It measured faster than FMAs outside the tensor cores on every case
//   timed (PERF.md).
// * Each output row is written once, from registers, to its own place
//   out[b, order[i]]: no atomics, no zero-fill, the same bits every call.
// * Where the grid is smaller than the card (fewer than 8 x 132 blocks:
//   layers 1-4 at batch 2), the wrapper cuts each tile's tap list into parts
//   of G taps (ops/sparse.py::taps_a_part: G = the fewest taps that walk 16
//   chunks, 2 at C 256, 1 at C 512; the whole list where the grid fills the
//   card or C is the stem's).  A fixed number of parts a tile would leave the
//   card waiting on its tiles with every tap (a request's layer-3 tiles list
//   9 of the 27 on average): parts of G taps make the blocks' work even, and
//   the card's scheduler fills the slots of the light tiles' finished blocks.
//   Block p of a tile takes list positions [p G, (p + 1) G); past the list's
//   end it returns at once.  A tile of one part is written by its block; a
//   longer one's parts write float32 partial tiles, in plan order, to scratch
//   (K / G, B, M_out, C_out) that the wrapper makes with torch.empty, and
//   sparse_conv_sum_parts sums each of its rows' parts in order 0, 1, .. over
//   the whole card and rounds once (a last-arriving part summing its tile
//   alone was slower: the tiles' sums then run one block each, at the grid's
//   tail).  One C entry a call: 1 kernel, or 2 when split.
//
// What bounds this version (tools/compare_kernels.py --only sparse_conv, its
// device time by shape; an H100 80GB HBM3 at 700 W): not the tensor cores.
// On a request's layers 1-3 it runs ~70-85 TFLOP/s of computed work in bf16
// and ~30 in float32, far below mma.sync's rate: a block's latency leads
// (three dependent loads before its first product, a barrier every 32
// channels, 16-32 stages a block), with the blocks of empty parts and the sum
// pass beside it; and the tiles compute 67 GFLOP for the 45 that exist (the
// OR of 64 sorted masks).  Next: wgmma with a producer warp keeping the ring
// full, and blocks that walk several tiles.
//
// The sums are taken in another order than the plain version's (tap by
// tap, each a matmul), so the two agree to a float32 rounding of the sum,
// not bit for bit (ops/sparse.py::sparse_conv_tiles_plain walks the
// kernel's order); a bfloat16 output is the float32 sum rounded once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_radix_sort.cuh>

namespace {

constexpr int kRows = 64;      // output rows a tile (the plan's tile)
constexpr int kDepth = 32;     // input channels a stage
constexpr int kMaxTaps = 32;   // a tap mask is 32 bits

// The ring's stages (PERF.md: 2, 3 and 4 in float32, 2, 3, 4 and 6 in
// bf16 were timed; these were the fastest)
constexpr int kStagesF32 = 3;
constexpr int kStagesBf16 = 4;

// A block: 64 rows x 64 output channels, 4 warps of 32 x 32, and its ring
// of stages in shared memory.
template <typename T>
struct Ring {
  using Type = T;
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kCols = 64;
  static constexpr int kWarpCols = kCols / 32;
  static constexpr int kThreads = 32 * (kRows / 32) * kWarpCols;
  static constexpr int kStages = kF32 ? kStagesF32 : kStagesBf16;
  // rows padded so that fragment reads (float32) and ldmatrix rows (bf16)
  // meet no bank conflict
  static constexpr int kLda = kDepth + (kF32 ? 4 : 8);
  static constexpr int kLdb = kCols + 8;
  static constexpr int kStage = kRows * kLda + kDepth * kLdb;
  static constexpr int kBytes = kStages * kStage * static_cast<int>(sizeof(T));
};

struct Args {
  const void* feats;
  const int* nbr;
  const void* w;
  const int* order;      // (B, M_out) the plan's rows
  const int* tile_taps;  // (B, tiles) each tile's taps as bits
  void* out;             // (B, M_out, C_out) in T
  float* scratch;        // (parts, B, M_out, C_out): partial tiles
  // group: the taps a part takes; parts = ceil(K / group)
  int m_in, c, m_out, k, c_out, tiles, group, parts, batch;
};

__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ inline void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ inline void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <typename T>
__device__ inline T zero();
template <>
__device__ inline float zero<float>() { return 0.f; }
template <>
__device__ inline __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

__device__ inline void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ inline void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ inline void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ inline void mma_bf16(float* c, const uint32_t* a,
                                const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ inline void mma_tf32(float* c, const uint32_t* a,
                                const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// x = hi + lo, both TF32 (10-bit mantissas); lo carries what hi rounded off
__device__ inline void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// Where acc[mi][nj][2h .. 2h + 1] (2 x 4 fragments of 16 x 8 a warp) lie
// in the tile: row r, channels n, n + 1.
__device__ inline void mma_place(int mi, int nj, int h, int wm, int wn,
                                 int lane, int& r, int& n) {
  r = wm + mi * 16 + (lane >> 2) + h * 8;
  n = wn + nj * 8 + 2 * (lane & 3);
}

// One stage's products into acc.
template <typename T>
struct Multiply;

template <>
struct Multiply<__nv_bfloat16> {
  template <typename R>
  static __device__ inline void run(float (&acc)[2][4][4],
                                    const __nv_bfloat16* sa,
                                    const __nv_bfloat16* sb, int wm, int wn,
                                    int lane) {
#pragma unroll
    for (int ks = 0; ks < kDepth; ks += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], sa + (wm + mi * 16 + (lane & 15)) * R::kLda + ks +
                               (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, sb + (ks + (lane & 15)) * R::kLdb + wn +
                                 np * 16 + (lane >> 4) * 8);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) mma_bf16(acc[mi][nj], a[mi], b[nj]);
    }
  }
};

// float32 as 3xTF32 on the tensor cores (the header note).
template <>
struct Multiply<float> {
  template <typename R>
  static __device__ inline void run(float (&acc)[2][4][4], const float* sa,
                                    const float* sb, int wm, int wn,
                                    int lane) {
    const int g = lane >> 2, t = lane & 3;
    float chunk[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) chunk[mi][nj][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kDepth; ks += 8) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* p = sa + (wm + mi * 16 + g) * R::kLda + ks + t;
        split_tf32(p[0], ah[mi][0], al[mi][0]);
        split_tf32(p[8 * R::kLda], ah[mi][1], al[mi][1]);
        split_tf32(p[4], ah[mi][2], al[mi][2]);
        split_tf32(p[8 * R::kLda + 4], ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const float* q = sb + (ks + t) * R::kLdb + wn + nj * 8 + g;
        split_tf32(q[0], bh[nj][0], bl[nj][0]);
        split_tf32(q[4 * R::kLdb], bh[nj][1], bl[nj][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          mma_tf32(chunk[mi][nj], al[mi], bh[nj]);
          mma_tf32(chunk[mi][nj], ah[mi], bl[nj]);
          mma_tf32(chunk[mi][nj], ah[mi], bh[nj]);
        }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mi][nj][e] = __fadd_rn(acc[mi][nj][e], chunk[mi][nj][e]);
  }
};

// The block's walk over (tap of its list, chunk of 32 input channels),
// one stage after the other into the ring.  Loader<R, true>: by 16-byte
// cp.async, a stage one tap's chunk; each thread copies fixed rows and
// columns of it and keeps their offsets, moved on a chunk at a time (a
// tap's table entries read once, at its first chunk).  Loader<R, false>:
// by element over the flat depth of the part's taps.
template <typename R, bool kVec>
struct Loader;

template <typename R>
struct Loader<R, true> {
  using T = typename R::Type;
  static constexpr int kVecElems = 16 / sizeof(T);
  static constexpr int kAVecs = kDepth / kVecElems;  // copies an A row
  static constexpr int kARows = R::kThreads / kAVecs;  // A rows a pass
  static constexpr int kAPer = kRows / kARows;
  static constexpr int kBVecs = R::kCols / kVecElems;  // copies a W row
  static constexpr int kBRows = R::kThreads / kBVecs;
  static constexpr int kBPer = kDepth / kBRows;
  const T* feats;
  const T* w;
  const int* s_nbr;
  const int* s_taps;
  long long scene, step;  // b * M_in; W rows of a pass
  int c, ntaps, ti, c0, qa, ra, qb, rb, n;
  bool col_ok;
  long long a_row[kAPer];  // each A row's offset in feats, or -1
  long long b_off;         // W[tap, c0 + rb, n]

  __device__ Loader(const Args& a, int b, int col0, int taps,
                    const int* nbr_s, const int* taps_s, int tid)
      : feats(static_cast<const T*>(a.feats)),
        w(static_cast<const T*>(a.w)),
        s_nbr(nbr_s),
        s_taps(taps_s),
        scene(static_cast<long long>(b) * a.m_in),
        step(static_cast<long long>(kBRows) * a.c_out),
        c(a.c),
        ntaps(taps),
        ti(0),
        c0(0),
        qa(tid % kAVecs),
        ra(tid / kAVecs),
        qb(tid % kBVecs),
        rb(tid / kBVecs),
        n(col0 + (tid % kBVecs) * kVecElems),
        col_ok(col0 + (tid % kBVecs) * kVecElems < a.c_out) {
    if (ntaps > 0) start_tap(a.c_out);
  }

  __device__ void start_tap(int c_out) {
#pragma unroll
    for (int j = 0; j < kAPer; ++j) {
      const int src = s_nbr[ti * kRows + ra + j * kARows];
      a_row[j] = src >= 0 ? (scene + src) * c : -1;
    }
    b_off = (static_cast<long long>(s_taps[ti]) * c + rb) * c_out + n;
  }

  __device__ void load(T* sa, T* sb, int c_out) {
    const int ch = c0 + qa * kVecElems;
#pragma unroll
    for (int j = 0; j < kAPer; ++j) {
      const bool ok = a_row[j] >= 0 && ch < c;
      cp_async16(sa + (ra + j * kARows) * R::kLda + qa * kVecElems,
                 ok ? feats + a_row[j] + ch : feats, ok);
    }
#pragma unroll
    for (int j = 0; j < kBPer; ++j) {
      const bool ok = col_ok && c0 + rb + j * kBRows < c;
      cp_async16(sb + (rb + j * kBRows) * R::kLdb + qb * kVecElems,
                 ok ? w + b_off + j * step : w, ok);
    }
    c0 += kDepth;
    if (c0 < c) {
      b_off += static_cast<long long>(kDepth) * c_out;
    } else {
      c0 = 0;
      if (++ti < ntaps) start_tap(c_out);
    }
  }
};

template <typename R>
struct Loader<R, false> {
  using T = typename R::Type;
  const T* feats;
  const T* w;
  const int* s_nbr;
  const int* s_taps;
  long long scene;
  int c, depth, d0, col0, tid;

  __device__ Loader(const Args& a, int b, int col0_, int taps,
                    const int* nbr_s, const int* taps_s, int tid_)
      : feats(static_cast<const T*>(a.feats)),
        w(static_cast<const T*>(a.w)),
        s_nbr(nbr_s),
        s_taps(taps_s),
        scene(static_cast<long long>(b) * a.m_in),
        c(a.c),
        depth(taps * a.c),
        d0(0),
        col0(col0_),
        tid(tid_) {}

  __device__ void load(T* sa, T* sb, int c_out) {
    for (int e = tid; e < kRows * kDepth; e += R::kThreads) {
      const int r = e / kDepth, kk = e % kDepth, d = d0 + kk;
      T v = zero<T>();
      if (d < depth) {
        const int ti = d / c;
        const int src = s_nbr[ti * kRows + r];
        if (src >= 0) v = feats[(scene + src) * c + d - ti * c];
      }
      sa[r * R::kLda + kk] = v;
    }
    for (int e = tid; e < kDepth * R::kCols; e += R::kThreads) {
      const int kk = e / R::kCols, nn = e % R::kCols, d = d0 + kk;
      T v = zero<T>();
      if (d < depth && col0 + nn < c_out) {
        const int ti = d / c;
        v = w[(static_cast<long long>(s_taps[ti]) * c + d - ti * c) * c_out +
              col0 + nn];
      }
      sb[kk * R::kLdb + nn] = v;
    }
    d0 += kDepth;
  }
};

// Templated on the element type, not on Ring<T>: a profiler then names it
// sparse_conv_tiles (tools.device_kernels reads the name up to its first
// parenthesis, and Ring's namespace would bring one in first).
template <typename T, bool kVec>
__global__ void __launch_bounds__(Ring<T>::kThreads)
    sparse_conv_tiles(Args a) {
  using R = Ring<T>;
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ int s_nbr[kMaxTaps * kRows];  // tap-major: [ti][row]
  __shared__ int s_order[kRows];
  __shared__ int s_taps[kMaxTaps];
  __shared__ int s_ntaps;
  __shared__ bool s_split;

  const int tile = blockIdx.x;
  const int col0 = blockIdx.y * R::kCols;
  const int b = blockIdx.z / a.parts, part = blockIdx.z % a.parts;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp / R::kWarpCols) * 32, wn = (warp % R::kWarpCols) * 32;

  if (tid < kRows) {
    const int i = tile * kRows + tid;
    s_order[tid] =
        i < a.m_out ? a.order[static_cast<long long>(b) * a.m_out + i] : -1;
  }
  if (tid == 0) {
    // the tile's list, and this part's positions [lo, hi) of it; a part
    // past the list's end has nothing to do (part 0 writes a tile with no
    // tap as zeros)
    const unsigned mask = static_cast<unsigned>(
        a.tile_taps[static_cast<long long>(b) * a.tiles + tile]);
    const int n = __popc(mask);
    const int lo = part * a.group, hi = min(lo + a.group, n);
    int j = 0, cnt = 0;
    for (unsigned m = mask; m; m &= m - 1, ++j)
      if (j >= lo && j < hi) s_taps[cnt++] = __ffs(m) - 1;
    s_ntaps = part > 0 && lo >= n ? -1 : cnt;
    s_split = n > a.group;
  }
  __syncthreads();
  const int ntaps = s_ntaps;
  if (ntaps < 0) return;
  const bool split = s_split;
  for (int e = tid; e < ntaps * kRows; e += R::kThreads) {
    const int ti = e / kRows, r = e % kRows;
    const int row = s_order[r];
    s_nbr[e] = row >= 0 ? a.nbr[(static_cast<long long>(b) * a.m_out + row) *
                                    a.k + s_taps[ti]]
                        : -1;
  }
  __syncthreads();

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

  T* stages = reinterpret_cast<T*>(ring);
  constexpr int kStage = R::kStage;
  const int iters = kVec ? ntaps * ((a.c + kDepth - 1) / kDepth)
                         : (ntaps * a.c + kDepth - 1) / kDepth;
  Loader<R, kVec> loader(a, b, col0, ntaps, s_nbr, s_taps, tid);
#pragma unroll
  for (int s = 0; s < R::kStages - 1; ++s) {
    if (s < iters) {
      T* sa = stages + s * kStage;
      loader.load(sa, sa + kRows * R::kLda, a.c_out);
    }
    cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<R::kStages - 2>();
    __syncthreads();
    const int next = it + R::kStages - 1;
    if (next < iters) {
      T* sa = stages + (next % R::kStages) * kStage;
      loader.load(sa, sa + kRows * R::kLda, a.c_out);
    }
    cp_async_commit();
    const T* sa = stages + (it % R::kStages) * kStage;
    Multiply<T>::template run<R>(acc, sa, sa + kRows * R::kLda, wm, wn,
                                 lane);
  }
  cp_async_wait<0>();

  // each row once, to its own place: out[b, order[i]]; a split tile's part
  // to its scratch slice, in plan order
  const bool pairs = (a.c_out & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int r, n;
        mma_place(mi, nj, h, wm, wn, lane, r, n);
        const int row = s_order[r];
        if (row < 0) continue;
        const long long base =
            split ? ((static_cast<long long>(part) * a.batch + b) * a.m_out +
                     tile * kRows + r) * a.c_out
                  : (static_cast<long long>(b) * a.m_out + row) * a.c_out;
        n += col0;
        const float v0 = acc[mi][nj][2 * h], v1 = acc[mi][nj][2 * h + 1];
        if (split) {
          float* dst = a.scratch + base + n;
          if (pairs && n < a.c_out) {
            store2(dst, v0, v1);
          } else {
            if (n < a.c_out) store(dst, v0);
            if (n + 1 < a.c_out) store(dst + 1, v1);
          }
        } else {
          T* dst = static_cast<T*>(a.out) + base + n;
          if (pairs && n < a.c_out) {
            store2(dst, v0, v1);
          } else {
            if (n < a.c_out) store(dst, v0);
            if (n + 1 < a.c_out) store(dst + 1, v1);
          }
        }
      }
}

// The split tiles' rows: out[b, order[i], n] = the sum over the tile's
// parts p = 0 .. ceil(taps / group) - 1, in that order, of scratch[p, b,
// i, n], rounded once to T.  A tile of one part was written by its block.
template <typename T>
__global__ void sparse_conv_sum_parts(Args a) {
  const long long n = static_cast<long long>(a.batch) * a.m_out * a.c_out;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < n; e += stride) {
    const long long row = e / a.c_out;  // b * M_out + i
    const int b = static_cast<int>(row / a.m_out);
    const int i = static_cast<int>(row - static_cast<long long>(b) * a.m_out);
    const int taps = __popc(static_cast<unsigned>(
        a.tile_taps[static_cast<long long>(b) * a.tiles + i / kRows]));
    if (taps <= a.group) continue;
    const int parts = (taps + a.group - 1) / a.group;
    float s = a.scratch[e];
    for (int p = 1; p < parts; ++p) s = __fadd_rn(s, a.scratch[p * n + e]);
    store(static_cast<T*>(a.out) +
              (static_cast<long long>(b) * a.m_out + a.order[row]) *
                  a.c_out + (e - row * a.c_out),
          s);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, bool kVec>
cudaError_t launch_tiles(const Args& a, cudaStream_t stream) {
  using R = Ring<T>;
  static bool ready = false;   // the ring above 48 KB, set once
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        sparse_conv_tiles<T, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, R::kBytes);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const dim3 grid(a.tiles, (a.c_out + R::kCols - 1) / R::kCols,
                  a.batch * a.parts);
  sparse_conv_tiles<T, kVec><<<grid, R::kThreads, R::kBytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* feats, const void* nbr, const void* w,
           const void* order, const void* tile_taps, void* scratch,
           void* out, int b, int m_in, int c, int m_out, int k, int c_out,
           int group, void* stream) {
  if (b == 0 || m_out == 0 || c_out == 0) return 0;
  if (k < 1 || k > kMaxTaps || group < 1 || (group < k && !scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a;
  a.feats = feats;
  a.nbr = static_cast<const int*>(nbr);
  a.w = w;
  a.order = static_cast<const int*>(order);
  a.tile_taps = static_cast<const int*>(tile_taps);
  a.out = out;
  a.scratch = static_cast<float*>(scratch);
  a.m_in = m_in;
  a.c = c;
  a.m_out = m_out;
  a.k = k;
  a.c_out = c_out;
  a.tiles = (m_out + kRows - 1) / kRows;
  a.group = group < k ? group : k;
  a.parts = (k + a.group - 1) / a.group;
  a.batch = b;
  constexpr int kVecElems = 16 / sizeof(T);
  const bool vec = c % kVecElems == 0 && c_out % kVecElems == 0 &&
                   aligned16(feats) && aligned16(w);
  const cudaError_t err = vec ? launch_tiles<T, true>(a, s)
                              : launch_tiles<T, false>(a, s);
  if (err != cudaSuccess || a.parts == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(b) * m_out * c_out;
  const int blocks = static_cast<int>((n + 255) / 256 < 4096
                                          ? (n + 255) / 256 : 4096);
  sparse_conv_sum_parts<T><<<blocks, 256, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The row plan of a (B, M, K) table, one block a (chunk of kT x kItems
// rows, scene): each row's mask (bit t where nbr >= 0), the chunk's rows
// stably sorted by it (cub's block radix sort over the K low bits of the
// keys, in registers and shared memory), and each 64-row tile's OR of its
// sorted masks.  A chunk of 16,384 rows holds a whole scene of every
// config; a larger scene is sorted chunk by chunk (tiles never straddle
// two chunks).  Padding past M takes an all-ones key and, being last in
// the input, sorts last.
template <int kT, int kItems>
__global__ void __launch_bounds__(kT)
    sparse_conv_plan(const int* __restrict__ nbr, int* __restrict__ mask,
                     int* __restrict__ order, int* __restrict__ tile_taps,
                     int m, int k) {
  using Sort = cub::BlockRadixSort<unsigned, kT, kItems, int>;
  extern __shared__ __align__(16) unsigned char smem[];
  auto& temp = *reinterpret_cast<typename Sort::TempStorage*>(smem);
  const int b = blockIdx.y;
  const int first = blockIdx.x * kT * kItems + threadIdx.x * kItems;
  unsigned keys[kItems];
  int rows[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = first + j;
    unsigned mk = 0xffffffffu;
    if (i < m) {
      const int* row = nbr + (static_cast<long long>(b) * m + i) * k;
      mk = 0;
      for (int t = 0; t < k; ++t) mk |= (row[t] >= 0 ? 1u : 0u) << t;
      mask[static_cast<long long>(b) * m + i] = static_cast<int>(mk);
    }
    keys[j] = mk;
    rows[j] = i;
  }
  Sort(temp).Sort(keys, rows, 0, k);
  unsigned taps = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int p = first + j;
    if (p < m) {
      order[static_cast<long long>(b) * m + p] = rows[j];
      taps |= keys[j];
    }
  }
  // a tile's 64 positions lie in 64 / kItems neighbouring lanes
#pragma unroll
  for (int d = 1; d < kRows / kItems; d <<= 1)
    taps |= __shfl_xor_sync(0xffffffffu, taps, d);
  const int tiles = (m + kRows - 1) / kRows;
  if (first % kRows == 0 && first < m)
    tile_taps[static_cast<long long>(b) * tiles + first / kRows] =
        static_cast<int>(taps);
}

template <int kT, int kItems>
int launch_plan(const void* nbr, void* mask, void* order, void* tile_taps,
                int b, int m, int k, cudaStream_t stream) {
  static_assert(kRows % kItems == 0 && kRows / kItems <= 32, "tile lanes");
  using Sort = cub::BlockRadixSort<unsigned, kT, kItems, int>;
  constexpr int bytes = sizeof(typename Sort::TempStorage);
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        sparse_conv_plan<kT, kItems>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const dim3 grid((m + kT * kItems - 1) / (kT * kItems), b);
  sparse_conv_plan<kT, kItems><<<grid, kT, bytes, stream>>>(
      static_cast<const int*>(nbr), static_cast<int*>(mask),
      static_cast<int*>(order), static_cast<int*>(tile_taps), m, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The row plan of nbr (B, M, K) int32, K <= 32: mask (B, M), order (B, M)
// and tile_taps (B, ceil(M / 64)), all int32, every element written.
int demf_sparse_conv_plan(const void* nbr, void* mask, void* order,
                          void* tile_taps, int b, int m, int k,
                          void* stream) {
  if (b == 0 || m == 0) return 0;
  if (k < 1 || k > kMaxTaps) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 1024) return launch_plan<128, 8>(nbr, mask, order, tile_taps, b,
                                            m, k, s);
  if (m <= 4096) return launch_plan<256, 16>(nbr, mask, order, tile_taps, b,
                                             m, k, s);
  return launch_plan<1024, 16>(nbr, mask, order, tile_taps, b, m, k, s);
}

// feats (B, M_in, C), nbr (B, M_out, K) int32, w (K, C, C_out), the plan's
// order (B, M_out) int32 and tile taps (B, ceil(M_out / 64)) int32, float32
// scratch (ceil(K / group), B, M_out, C_out) when group < K (else null),
// out (B, M_out, C_out), every element written; a part takes `group` taps
// of a tile's list.  float32 here, bfloat16 in demf_sparse_conv_bf16.
int demf_sparse_conv(const void* feats, const void* nbr, const void* w,
                     const void* order, const void* tile_taps,
                     void* scratch, void* out, int b, int m_in, int c,
                     int m_out, int k, int c_out, int group, void* stream) {
  return launch<float>(feats, nbr, w, order, tile_taps, scratch, out, b,
                       m_in, c, m_out, k, c_out, group, stream);
}

int demf_sparse_conv_bf16(const void* feats, const void* nbr, const void* w,
                          const void* order, const void* tile_taps,
                          void* scratch, void* out, int b, int m_in, int c,
                          int m_out, int k, int c_out, int group,
                          void* stream) {
  return launch<__nv_bfloat16>(feats, nbr, w, order, tile_taps, scratch,
                               out, b, m_in, c, m_out, k, c_out, group,
                               stream);
}

}  // extern "C"
