// The sparse convolution's weight gradient (kernel K16): for each tap t,
// dW[t] = sum over scenes b and output rows m of feats[b, nbr[b, m, t]]^T
// g[b, m], a row whose tap t is -1 adding 0.  feats (B, M_in, C), nbr
// (B, M_out, K) int32, g (B, M_out, C_out): float32, or bfloat16 (the bf16
// policy's rows and output gradient); dW (K, C, C_out) float32, every
// element written, the same bits every call.
//
// Replaces: demf_tpu/ops/sparse.py::_conv_dweights (:414), XLA code called
// from the custom VJPs _conv_sym_bwd (:452) and _conv_revgeo_bwd (:494): a
// scan over the K taps, each a row gather of (B * M_out, C) and one float32
// einsum over the rows.  Every sparse convolution of a FCAF3D train step
// takes it once in its backward (the stem's too: its colours take no
// gradient, its kernel does).
//
// What bounds it on the card: operations, 2 x sum over taps of the rows
// that have the tap x C x C_out (180 GFLOP a FCAF3D train step of 8
// scenes): at float32's 67 TFLOP/s outside the tensor cores 2.69 ms, at
// the 3xTF32 rate this kernel runs (TF32's 495 TFLOP/s over 3) 1.09 ms, in
// bf16 on the tensor cores (989) 0.18 ms; the bytes (feats and g read
// once, dW written once) are ~C + C_out values a row, so at MinkResNet's
// widths (C and C_out >= 64, ~10 taps a row) the operations bind; at the
// stem (C 3) the bytes.
//
// A first version (SIMT FMAs, each 64-row tile's rows gathered by scalar
// loads behind a barrier, a 64 x 64 channel tile whatever the shape) ran
// 9.9 TFLOP/s.  This design, after K14's (csrc/sparse_conv.cu):
//
// * It walks K14's row plan of the forward table (ops/sparse.py::
//   conv_plan): the rows of each scene sorted by tap mask, each 64-row
//   tile's taps as a bit list, so a block reads a tile's rows only where
//   the tile lists its tap.
// * A block owns one (tap, tile of C x C_out, chunk of the tiles that list
//   the tap: below).  It first lists its chunk's tiles in shared memory,
//   then walks them in stages of 32 rows (half a plan tile): the
//   32 gathered feats rows and the 32 g rows of the stage, each a row of
//   the channels of its tile, go by 16-byte cp.async into a ring of stages
//   (3 in float32, 4 in bf16), so that the next stages load while this one
//   is multiplied.  Rows that 16-byte copies cannot carry (C or C_out not
//   a multiple of 4 float32 / 8 bf16: the stem's C = 3) go by 4-byte
//   cp.async in float32 and by element in bf16.
// * A row's table entries are two dependent loads (the plan's order, then
//   the table at the tap).  Two warps fetch them a tile ahead of the
//   copies, a load a stage apart, and hand them over through two slots in
//   shared memory, so that neither load waits in the walk.
// * The reduction runs over rows, so the gathered feats tile is the mma's
//   operand transposed: a stage stays as it arrived, rows x channels, and
//   both operands are read down its columns.  float32: 3xTF32 on
//   mma.sync.m16n8k8 (K14's split_tf32: each operand a TF32 high part and
//   the TF32 rounding of the rest, lo*hi + hi*lo + hi*hi), its fragments
//   read as scalars from rows padded to 8 modulo 32 words (no bank
//   conflict).  bf16: mma.sync.m16n8k16, both operands by
//   ldmatrix.x4.trans from rows padded to an odd number of 16-byte units.
//   Each stage's products are summed apart and added to the float32 sums
//   with a rounded add, so the tensor cores' truncating additions never
//   pile up over a long reduction (a bf16 product is exact in float32).
// * Orientation by call: the mma's M side (64 channels) is C, its N side
//   64 channels of C_out; where one side is narrow (at most 16 channels:
//   the stem's C = 3, a one-tap conv's C_out = 1, 8 or 10) that side is the
//   N side at 8 or 16 channels and the other the M side, so no 64-wide tile
//   is filled with zeros (ops/sparse.py::dweights_widths).
// * Work cut by each tap's own rows: a tap's listed tiles go in chunks of
//   W (ops/sparse.py::dweights_chunk: W so that the grid holds ~32 x 132
//   blocks in float32, ~8 x 132 in bf16, whole taps where the tiles of C x
//   C_out fill 8 x 132), block s of a tap taking those of rank [s W, (s +
//   1) W), each block ranking the tap's tiles itself (a block scan of
//   per-thread counts).  Blocks past a tap's last chunk return at once, so
//   the centre tap (every tile lists it) and a corner tap (a few do) both
//   run in blocks of W tiles, and no block waits on a heavy one at the
//   grid's tail (slices that were ranges of the (scene, tile) list, the
//   same for every tap, ran layers 1-3 at 1.3-1.6x K14's time on the same
//   shapes).
// * No float atomics: with more than one chunk, each block writes its
//   partial tile to scratch (chunks, K, C, C_out), which the wrapper makes
//   with torch.empty, chunk 0's first block writes the tap's count of
//   listed tiles, and dweights_sum adds each tap's chunks in order 0, 1,
//   ..: the same bits every call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 64;  // a row tile of the plan
constexpr int kDepth = 32;     // rows a stage: half a plan tile
constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTaps = 32;
constexpr int kMaxList = 1024;  // listed tiles a block (the chunk W)
constexpr int kScan = 8;        // tap words a thread ranks a pass

// A stage's row pitch in elements: 8 modulo 32 words for float32 (the
// fragments' column reads), an odd number of 16-byte units for bf16 (the
// ldmatrix rows); 24 serves both at 8 and 16 channels
constexpr int pitch(int width) { return width <= 16 ? 24 : width + 8; }

// A block's tile: the gathered feats rows P (kPW channels of C) and the
// output gradient's rows Q (kQW channels of C_out); the mma's M side (64
// channels) is P, or Q when kSwap.  4 warps: 2 x 2 of 32 x 32 where both
// sides are 64 wide, else 4 x 1 of 16 x the N side.
template <typename T, int kPW, int kQW, bool kSwapSides>
struct Tile {
  using Type = T;
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr bool kSwap = kSwapSides;
  static constexpr int kMW = kSwap ? kQW : kPW;
  static constexpr int kNW = kSwap ? kPW : kQW;
  static_assert(kMW == 64, "the mma's M side is 64 channels");
  static constexpr int kWarpsN = kNW == 64 ? 2 : 1;
  static constexpr int kWarpsM = kWarps / kWarpsN;
  static constexpr int kMI = kMW / kWarpsM / 16;  // 16-row fragments a warp
  static constexpr int kNJ = kNW / kWarpsN / 8;   // 8-column fragments
  static constexpr int kLdP = pitch(kPW);
  static constexpr int kLdQ = pitch(kQW);
  static constexpr int kLdA = kSwap ? kLdQ : kLdP;
  static constexpr int kLdB = kSwap ? kLdP : kLdQ;
  static constexpr int kStage = kDepth * (kLdP + kLdQ);
  // the ring's stages, K14's (PERF.md)
  static constexpr int kStages = kF32 ? 3 : 4;
  static constexpr int kBytes = kStages * kStage * static_cast<int>(sizeof(T));
};

struct Args {
  const void* feats;
  const int* nbr;
  const void* g;
  const int* order;      // (B, M_out) the plan's rows
  const int* tile_taps;  // (B, tiles) each tile's taps as bits
  float* scratch;        // (chunks, K, C, C_out) when chunks > 1
  int* counts;           // (K,) each tap's listed tiles, when chunks > 1
  float* out;            // (K, C, C_out)
  // chunk: listed tiles a block; chunks: the grid's blocks a tile of C x
  // C_out a tap, ceil(B tiles / chunk)
  int batch, m_in, c, m_out, k, c_out, tiles, chunk, chunks, p_tiles,
      q_tiles;
  bool vec_p, vec_q;     // feats / g rows by 16-byte copies
};

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

// One element of a row that 16-byte copies cannot carry: float32 by a
// 4-byte cp.async (0 where !ok), bf16 by a load and a store.
__device__ inline void copy_element(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ inline void copy_element(__nv_bfloat16* dst,
                                    const __nv_bfloat16* src, bool ok) {
  *dst = ok ? *src : __float2bfloat16_rn(0.f);
}

// A stage's kDepth rows of one side into dst (rows x kW channels at pitch
// kLd): row r from base + rows[r] * width + ch0 (rows[r] < 0: zeros),
// channels past `width` zero.
template <typename T, int kW, int kLd>
__device__ inline void copy_rows(T* dst, const T* base, const int* rows,
                                 int ch0, int width, bool vec, int tid) {
  if (vec) {
    constexpr int kV = 16 / sizeof(T);
    constexpr int kVecs = kW / kV;
#pragma unroll
    for (int e = tid; e < kDepth * kVecs; e += kThreads) {
      const int r = e / kVecs, q = e - r * kVecs;
      const int row = rows[r], ch = ch0 + q * kV;
      const bool ok = row >= 0 && ch < width;
      cp_async16(dst + r * kLd + q * kV,
                 ok ? base + static_cast<long long>(row) * width + ch : base,
                 ok);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < kDepth * kW; e += kThreads) {
      const int r = e / kW, q = e - r * kW;
      const int row = rows[r], ch = ch0 + q;
      const bool ok = row >= 0 && ch < width;
      copy_element(dst + r * kLd + q,
                   ok ? base + static_cast<long long>(row) * width + ch : base,
                   ok);
    }
  }
}

__device__ inline void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ inline void ldmatrix_x2_trans(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
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

// One stage's products into acc: A (the M side) and B (the N side) both
// stored rows x channels, the reduction running down the rows, so A is
// read transposed.  Summed apart and added with rounded adds (the header).
template <typename R>
__device__ inline void multiply(float (&acc)[R::kMI][R::kNJ][4],
                                const typename R::Type* sa,
                                const typename R::Type* sb, int wm, int wn,
                                int lane) {
  float chunk[R::kMI][R::kNJ][4];
#pragma unroll
  for (int mi = 0; mi < R::kMI; ++mi)
#pragma unroll
    for (int nj = 0; nj < R::kNJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) chunk[mi][nj][e] = 0.f;
  if constexpr (R::kF32) {
    // A[m][k] = sa[k][m]: a0 (m g, k t), a1 (g + 8, t), a2 (g, t + 4), a3
    // (g + 8, t + 4); B[k][n] = sb[k][n]: b0 (k t, n g), b1 (t + 4, g)
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int ks = 0; ks < kDepth; ks += 8) {
      uint32_t ah[R::kMI][4], al[R::kMI][4], bh[R::kNJ][2], bl[R::kNJ][2];
#pragma unroll
      for (int mi = 0; mi < R::kMI; ++mi) {
        const float* p = sa + (ks + t) * R::kLdA + wm + mi * 16 + g;
        split_tf32(p[0], ah[mi][0], al[mi][0]);
        split_tf32(p[8], ah[mi][1], al[mi][1]);
        split_tf32(p[4 * R::kLdA], ah[mi][2], al[mi][2]);
        split_tf32(p[4 * R::kLdA + 8], ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int nj = 0; nj < R::kNJ; ++nj) {
        const float* q = sb + (ks + t) * R::kLdB + wn + nj * 8 + g;
        split_tf32(q[0], bh[nj][0], bl[nj][0]);
        split_tf32(q[4 * R::kLdB], bh[nj][1], bl[nj][1]);
      }
#pragma unroll
      for (int mi = 0; mi < R::kMI; ++mi)
#pragma unroll
        for (int nj = 0; nj < R::kNJ; ++nj) {
          mma_tf32(chunk[mi][nj], al[mi], bh[nj]);
          mma_tf32(chunk[mi][nj], ah[mi], bl[nj]);
          mma_tf32(chunk[mi][nj], ah[mi], bh[nj]);
        }
    }
  } else {
    // ldmatrix.trans: lane l gives row l & 7 of 8 x 8 matrix l >> 3; A's
    // four are (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7), (k 8-15,
    // m 8-15) of its 16 x 16, B's (k 0-7, n 0-7), (k 8-15, n 0-7), then
    // the next 8 columns
#pragma unroll
    for (int ks = 0; ks < kDepth; ks += 16) {
      uint32_t a[R::kMI][4], b[R::kNJ][2];
#pragma unroll
      for (int mi = 0; mi < R::kMI; ++mi)
        ldmatrix_x4_trans(a[mi], sa + (ks + (lane >> 4) * 8 + (lane & 7)) *
                                          R::kLdA +
                                      wm + mi * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int np = 0; np < R::kNJ / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, sb + (ks + (lane & 15)) * R::kLdB + wn +
                                 np * 16 + (lane >> 4) * 8);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
      if constexpr (R::kNJ % 2 == 1)
        ldmatrix_x2_trans(b[R::kNJ - 1], sb + (ks + (lane & 15)) * R::kLdB +
                                             wn + (R::kNJ - 1) * 8);
#pragma unroll
      for (int mi = 0; mi < R::kMI; ++mi)
#pragma unroll
        for (int nj = 0; nj < R::kNJ; ++nj)
          mma_bf16(chunk[mi][nj], a[mi], b[nj]);
    }
  }
#pragma unroll
  for (int mi = 0; mi < R::kMI; ++mi)
#pragma unroll
    for (int nj = 0; nj < R::kNJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[mi][nj][e] = __fadd_rn(acc[mi][nj][e], chunk[mi][nj][e]);
}

// Templated on the element type and widths, not on Tile<>: a profiler
// names it dweights_tiles (tools.device_kernels reads the name up to its
// first parenthesis).
template <typename T, int kPW, int kQW, bool kSwap>
__global__ void __launch_bounds__(kThreads) dweights_tiles(Args a) {
  using R = Tile<T, kPW, kQW, kSwap>;
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ int s_list[kMaxList];         // this block's tiles of tap t
  __shared__ int s_warp[kWarps];
  __shared__ int s_src[2][kTileRows];      // a tile's feats rows (b M_in +)
  __shared__ int s_row[2][kTileRows];      // its g rows (b M_out +), or -1

  const int qt = blockIdx.x % a.q_tiles;
  const int pt = (blockIdx.x / a.q_tiles) % a.p_tiles;
  const int t = blockIdx.x / (a.q_tiles * a.p_tiles);
  const int part = blockIdx.y;          // the tap's chunk of tiles
  const int p0 = pt * kPW, q0 = qt * kQW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int total = a.batch * a.tiles;  // (scene, row tile), scene-major
  const int lo = part * a.chunk;        // this block's ranks among tap t's

  // Tap t's tiles ranked in order, those of rank [lo, lo + chunk) kept: a
  // pass ranks kThreads x kScan tiles, a thread a run of kScan (its words
  // read at once), the runs' counts scanned over the block.
  int listed = 0;
  for (int base = 0; base < total; base += kThreads * kScan) {
    const int first = base + tid * kScan;
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < kScan; ++j)
      if (first + j < total &&
          ((static_cast<unsigned>(a.tile_taps[first + j]) >> t) & 1u))
        bits |= 1u << j;
    const int cnt = __popc(bits);
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int rank = listed + incl - cnt, pass = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) rank += s_warp[w];
      pass += s_warp[w];
    }
    for (unsigned b = bits; b; b &= b - 1, ++rank)
      if (rank >= lo && rank < lo + a.chunk)
        s_list[rank - lo] = first + __ffs(b) - 1;
    listed += pass;
    __syncthreads();  // s_warp is read again; s_list is whole after the last
  }
  if (part == 0 && pt == 0 && qt == 0 && tid == 0 && a.counts)
    a.counts[t] = listed;
  const int n_list = max(0, min(a.chunk, listed - lo));
  if (part > 0 && n_list == 0) return;  // past the tap's last chunk

  // The fetch of a tile's entries (threads 0-63, one plan row each): the
  // order a tile ahead of the table, the table a stage ahead of the slot.
  const bool fetcher = tid < kTileRows;
  int row_a = -1, scene_a = 0;              // order value of tile p + 2
  int row_b = -1, scene_b = 0, src_b = -1;  // tile p + 1, with its entry
  auto load_row = [&](int p) {
    row_a = -1;
    if (p < n_list) {
      const int rt = s_list[p];
      scene_a = rt / a.tiles;
      const int i = (rt - scene_a * a.tiles) * kTileRows + tid;
      if (i < a.m_out)
        row_a = a.order[static_cast<long long>(scene_a) * a.m_out + i];
    }
  };
  auto load_src = [&]() {
    row_b = row_a;
    scene_b = scene_a;
    src_b = -1;
    if (row_b >= 0)
      src_b = a.nbr[(static_cast<long long>(scene_b) * a.m_out + row_b) *
                        a.k + t];
  };
  auto store_slot = [&](int p) {
    const bool has = src_b >= 0;
    s_src[p & 1][tid] = has ? scene_b * a.m_in + src_b : -1;
    s_row[p & 1][tid] = has ? scene_b * a.m_out + row_b : -1;
  };

  using T_ = typename R::Type;
  T_* stages = reinterpret_cast<T_*>(ring);
  const T_* feats = static_cast<const T_*>(a.feats);
  const T_* g = static_cast<const T_*>(a.g);
  const int n_stages = 2 * n_list;
  // stage n: rows [32 (n & 1), + 32) of tile n >> 1; its copies, then the
  // fetch's step (even n: the table of tile q + 1 and the order of q + 2;
  // odd n: tile q + 1's slot, read from stage n + 1 on, after a barrier)
  auto issue = [&](int n) {
    T_* sp = stages + (n % R::kStages) * R::kStage;
    const int slot = (n >> 1) & 1, h = (n & 1) * kDepth;
    copy_rows<T_, kPW, R::kLdP>(sp, feats, &s_src[slot][h], p0, a.c, a.vec_p,
                                tid);
    copy_rows<T_, kQW, R::kLdQ>(sp + kDepth * R::kLdP, g, &s_row[slot][h],
                                q0, a.c_out, a.vec_q, tid);
    if (fetcher) {
      const int q = n >> 1;
      if (n % 2 == 0) {
        load_src();
        load_row(q + 2);
      } else if (q + 1 < n_list) {
        store_slot(q + 1);
      }
    }
  };

  if (fetcher && n_list > 0) {
    load_row(0);
    load_src();
    store_slot(0);
    load_row(1);
  }
  __syncthreads();

  float acc[R::kMI][R::kNJ][4];
#pragma unroll
  for (int mi = 0; mi < R::kMI; ++mi)
#pragma unroll
    for (int nj = 0; nj < R::kNJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
  const int wm = (warp / R::kWarpsN) * (R::kMI * 16);
  const int wn = (warp % R::kWarpsN) * (R::kNJ * 8);

#pragma unroll
  for (int s = 0; s < R::kStages - 1; ++s) {
    if (s < n_stages) issue(s);
    cp_async_commit();
    __syncthreads();  // a slot written at an odd stage is read at the next
  }
  for (int it = 0; it < n_stages; ++it) {
    cp_async_wait<R::kStages - 2>();
    __syncthreads();
    const int next = it + R::kStages - 1;
    if (next < n_stages) issue(next);
    cp_async_commit();
    const T_* sp = stages + (it % R::kStages) * R::kStage;
    const T_* sq = sp + kDepth * R::kLdP;
    multiply<R>(acc, R::kSwap ? sq : sp, R::kSwap ? sp : sq, wm, wn, lane);
  }
  cp_async_wait<0>();

  float* dst = a.chunks > 1
                   ? a.scratch + static_cast<long long>(part) * a.k * a.c *
                                     a.c_out
                   : a.out;
  const long long tap = static_cast<long long>(t) * a.c;
  const bool pairs = (a.c_out & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < R::kMI; ++mi)
#pragma unroll
    for (int nj = 0; nj < R::kNJ; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm + mi * 16 + (lane >> 2) + h * 8;
        const int n = wn + nj * 8 + 2 * (lane & 3);
        const float v0 = acc[mi][nj][2 * h], v1 = acc[mi][nj][2 * h + 1];
        if (!R::kSwap) {  // (m, n) = (C, C_out)
          const int c = p0 + m, o = q0 + n;
          if (c >= a.c || o >= a.c_out) continue;
          float* p = dst + (tap + c) * a.c_out + o;
          if (pairs) {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            p[0] = v0;
            if (o + 1 < a.c_out) p[1] = v1;
          }
        } else {  // (m, n) = (C_out, C)
          const int o = q0 + m, c = p0 + n;
          if (o >= a.c_out) continue;
          if (c < a.c) dst[(tap + c) * a.c_out + o] = v0;
          if (c + 1 < a.c) dst[(tap + c + 1) * a.c_out + o] = v1;
        }
      }
}

// dW[t] = tap t's chunks' partial tiles summed in order 0, 1, .. (rounded
// adds): chunk 0 and those of the tap's listed tiles, counts[t].
__global__ void dweights_sum(const float* __restrict__ scratch,
                             const int* __restrict__ counts,
                             float* __restrict__ out, long long n,
                             long long per_tap, int chunk) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < n; e += stride) {
    const int parts = max(1, (counts[e / per_tap] + chunk - 1) / chunk);
    float s = scratch[e];
    for (int p = 1; p < parts; ++p) s = __fadd_rn(s, scratch[p * n + e]);
    out[e] = s;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int kPW, int kQW, bool kSwap>
cudaError_t launch_tiles(Args& a, cudaStream_t stream) {
  using R = Tile<T, kPW, kQW, kSwap>;
  static bool ready = false;  // the ring above 48 KB, set once
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        dweights_tiles<T, kPW, kQW, kSwap>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, R::kBytes);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  a.p_tiles = (a.c + kPW - 1) / kPW;
  a.q_tiles = (a.c_out + kQW - 1) / kQW;
  const dim3 grid(a.k * a.p_tiles * a.q_tiles, a.chunks);
  dweights_tiles<T, kPW, kQW, kSwap><<<grid, kThreads, R::kBytes, stream>>>(
      a);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* feats, const void* nbr, const void* g,
           const void* order, const void* tile_taps, void* scratch,
           void* counts, void* out, int b, int m_in, int c, int m_out, int k,
           int c_out, int chunk, void* stream) {
  if (k == 0 || c == 0 || c_out == 0) return 0;
  const int tiles = (m_out + kTileRows - 1) / kTileRows;
  const int total = b * tiles;
  const int chunks = total > chunk ? (total + chunk - 1) / chunk : 1;
  if (k < 0 || k > kMaxTaps || chunk < 1 || chunk > kMaxList ||
      (chunks > 1 && (!scratch || !counts)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kV = 16 / sizeof(T);
  Args a;
  a.feats = feats;
  a.nbr = static_cast<const int*>(nbr);
  a.g = g;
  a.order = static_cast<const int*>(order);
  a.tile_taps = static_cast<const int*>(tile_taps);
  a.scratch = static_cast<float*>(scratch);
  a.counts = chunks > 1 ? static_cast<int*>(counts) : nullptr;
  a.out = static_cast<float*>(out);
  a.batch = b;
  a.m_in = m_in;
  a.c = c;
  a.m_out = m_out;
  a.k = k;
  a.c_out = c_out;
  a.tiles = tiles;
  a.chunk = chunk;
  a.chunks = chunks;
  a.vec_p = c % kV == 0 && aligned16(feats);
  a.vec_q = c_out % kV == 0 && aligned16(g);
  // the tile's widths: ops/sparse.py::dweights_widths
  cudaError_t err;
  if (c_out <= 16 && c_out <= c)
    err = c_out <= 8 ? launch_tiles<T, 64, 8, false>(a, s)
                     : launch_tiles<T, 64, 16, false>(a, s);
  else if (c <= 16)
    err = c <= 8 ? launch_tiles<T, 8, 64, true>(a, s)
                 : launch_tiles<T, 16, 64, true>(a, s);
  else
    err = launch_tiles<T, 64, 64, false>(a, s);
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(k) * c * c_out;
  const int blocks =
      static_cast<int>((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  dweights_sum<<<blocks, 256, 0, s>>>(a.scratch, a.counts, a.out, n,
                                      static_cast<long long>(c) * c_out,
                                      chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// feats (B, M_in, C), nbr (B, M_out, K) int32, g (B, M_out, C_out), the
// plan's order (B, M_out) and tile taps (B, ceil(M_out / 64)) int32; with
// more than one chunk (B ceil(M_out / 64) > chunk) float32 scratch
// (chunks, K, C, C_out) and int32 counts (K,), else null; out (K, C, C_out)
// float32, every element written; a block takes `chunk` (1 to 1,024) of a
// tap's listed tiles.  float32 feats and g here, bfloat16 in
// demf_sparse_conv_dweights_bf16.
int demf_sparse_conv_dweights(const void* feats, const void* nbr,
                              const void* g, const void* order,
                              const void* tile_taps, void* scratch,
                              void* counts, void* out, int b, int m_in, int c,
                              int m_out, int k, int c_out, int chunk,
                              void* stream) {
  return launch<float>(feats, nbr, g, order, tile_taps, scratch, counts, out,
                       b, m_in, c, m_out, k, c_out, chunk, stream);
}

int demf_sparse_conv_dweights_bf16(const void* feats, const void* nbr,
                                   const void* g, const void* order,
                                   const void* tile_taps, void* scratch,
                                   void* counts, void* out, int b, int m_in,
                                   int c, int m_out, int k, int c_out,
                                   int chunk, void* stream) {
  return launch<__nv_bfloat16>(feats, nbr, g, order, tile_taps, scratch,
                               counts, out, b, m_in, c, m_out, k, c_out,
                               chunk, stream);
}

}  // extern "C"
