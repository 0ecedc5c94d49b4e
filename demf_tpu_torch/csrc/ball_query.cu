// Exact ball query: the K nearest points inside a radius.  A block owns a
// tile of centers of one scene and streams the scene's points once for all
// of them.
//
// Replaces: demf_tpu/ops/grouping.py::ball_query with exact=True, the XLA op
// that builds the (B, M, N) squared-distance matrix and takes an exact top-k.
// Semantics: neighbours are the points with d2 < r^2 (strict), in ascending
// (d2, index) order; missing slots repeat the first hit and an empty
// neighbourhood gives index 0.  d2 = max(|c|^2 + |p|^2 - 2 c.p, 0), the
// formula of grouping._sqdist, each product and sum rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn: no FMA), so the picks do not depend on
// the launch shape.
//
// What bounds it on the card: the B x M x N pair tests, about a dozen
// float32 and integer operations each; the inputs (240 KB a scene) and the
// output are small beside them.  A block that owns one center re-reads the
// scene from L2 for every center and spends its time on loads and block
// barriers instead.
//
// What this design does about it:
// - A block of W warps owns C = W * CW centers of one scene.  The scene's
//   points pass through shared memory once a block, in tiles copied with
//   16-byte cp.async, double-buffered, so the next tile's copy overlaps this
//   tile's tests.  When a tile has arrived it is laid out once as (x, y, z,
//   |p|^2), 16 bytes a point, so |p|^2 is computed once a point and a lane
//   gets its point in one load.
// - A warp keeps its CW centers (x, y, z, |c|^2) in registers.  Each lane
//   takes one point of the tile from shared memory and tests it against all
//   of them; one vote tells the warp whether any lane hit any center, and
//   only then are the hits of each center looked at.
// - In-radius points go to their center's list in shared memory at a slot
//   computed from __ballot_sync + __popc: no atomics, and the list is in
//   ascending index order on every run.  A key is 64 bits,
//   (bits of d2) << 32 | index; d2 >= 0, so the unsigned order of keys is
//   the (d2, index) order of the semantics.
// - A list holds `cap` keys (a power of two, at least K + 32).  When the
//   next 32 points might not fit, the center's warp selects the K smallest
//   in order (each lane ranks its keys by counting the smaller ones, or a
//   bitonic network for a long list: __syncwarp only), keeps them and from
//   then on tests later points against the K-th kept distance with a
//   strict <.
//   This is exact: a warp takes the points in ascending index order, so a
//   later point that ties the K-th kept distance has a larger index than
//   every kept key, would sort after the K-th key and is rightly refused; a
//   later point with a smaller distance passes the test and displaces it
//   at the next sort.  The threshold only ever falls, so no refused point
//   could have entered a later top K either.
// - After the last tile one selection gives the K picks, and the warp writes
//   them and the padding together, 32 neighbouring int64 a store.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long Key;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;   // what a block may use on sm_90
// A block has at most 16 warps; one whose warps keep 4 or 8 centers each
// at most 8, so that the compiler may give a thread the registers for them
// (for 4 centers, up to the 85 that let three blocks share an SM: told only
// of the larger block it keeps to 64 and computes every |c|^2 anew for every
// 32 points).
constexpr int max_warps(int cw) { return cw >= 4 ? 8 : 16; }

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// 16 bytes from global to shared memory, of which the first `bytes` are read
// and the rest filled with zeros; not waited for
__device__ __forceinline__ void copy_async16(void* to, const void* from,
                                             int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(to));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(from), "r"(bytes)
               : "memory");
}

// Ascending sort of list[0 .. p) in shared memory by one warp; p is a power
// of two >= 2 and the keys from `count` on are set to the largest key first.
__device__ __forceinline__ void warp_sort(Key* list, int count, int p,
                                          int lane) {
  for (int i = count + lane; i < p; i += 32) list[i] = ~0ull;
  __syncwarp();
  for (int k2 = 2; k2 <= p; k2 <<= 1) {
    for (int j = k2 >> 1; j > 0; j >>= 1) {
      for (int t = lane; t < (p >> 1); t += 32) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int o = i | j;
        const Key a = list[i];
        const Key b = list[o];
        const bool up = (i & k2) == 0;
        if ((a > b) == up) {
          list[i] = b;
          list[o] = a;
        }
      }
      __syncwarp();
    }
  }
}

// Leaves the min(count, k) smallest of list[0 .. count) at the front of the
// list in ascending order.  Up to kRanked keys a lane holds its (at most
// kRanked / 32) keys in registers and ranks each by counting the smaller
// ones, every lane reading the same key at a time: no exchange between
// lanes and two __syncwarp in all, which a bitonic network pays a stage.
// Keys are unique (they end in the point's index), so are the ranks.  A
// longer list (K > 96) takes the network.
constexpr int kRanked = 128;

__device__ __forceinline__ void warp_select(Key* list, int count, int k,
                                            int lane) {
  if (count > kRanked) {
    int p = 2 * kRanked;
    while (p < count) p <<= 1;
    warp_sort(list, count, p, lane);
    return;
  }
  __syncwarp();   // the appends are written
  Key key[kRanked / 32];
  int rank[kRanked / 32];
#pragma unroll
  for (int r = 0; r < kRanked / 32; ++r) {
    key[r] = r * 32 + lane < count ? list[r * 32 + lane] : ~0ull;
    rank[r] = 0;
  }
  for (int j = 0; j < count; ++j) {
    const Key other = list[j];
#pragma unroll
    for (int r = 0; r < kRanked / 32; ++r) rank[r] += other < key[r];
  }
  __syncwarp();   // every lane has read the list
#pragma unroll
  for (int r = 0; r < kRanked / 32; ++r)
    if (r * 32 + lane < count && rank[r] < k) list[rank[r]] = key[r];
  __syncwarp();
}

// Shared memory: the centers' lists, two raw point tiles (x y z as they lie
// in global memory, from a 16-byte boundary on) and one tile of (x, y, z,
// |p|^2).
template <int CW>
__global__ void __launch_bounds__(max_warps(CW) * 32, CW == 4 ? 3 : 1)
    ball_query_kernel(const float* __restrict__ points,
                      const float* __restrict__ centers,
                      long long* __restrict__ out, int n, int m, int k,
                      float r2, int cap, int tile, long long total_floats) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int raw_len = 3 * tile + 4;   // a tile's floats and the scene's shift
  Key* lists = reinterpret_cast<Key*>(smem);
  float* raw = reinterpret_cast<float*>(lists + warps * CW * cap);
  float4* s_pts = reinterpret_cast<float4*>(raw + 2 * raw_len);

  const int b = blockIdx.y;
  // the scene starts `shift` floats after a 16-byte boundary
  const long long scene = static_cast<long long>(b) * n * 3;
  const int shift = static_cast<int>(scene & 3);
  const float* gbase = points + (scene - shift);
  const long long left = total_floats - (scene - shift);
  const int ntiles = (n + tile - 1) / tile;

  auto stage = [&](int t) {
    float* dst = raw + (t & 1) * raw_len;
    const int count = min(tile, n - t * tile);
    const int chunks = (shift + 3 * count + 3) >> 2;
    const long long first = static_cast<long long>(t) * 3 * tile;
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
      const long long g = first + 4 * c;
      const long long rest = left - g;   // floats up to the tensor's end
      copy_async16(dst + 4 * c, gbase + g,
                   rest >= 4 ? 16 : static_cast<int>(rest) * 4);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  float cx[CW], cy[CW], cz[CW], c2[CW], thr[CW];
  int have[CW];
  const int first_center = (blockIdx.x * warps + warp) * CW;
#pragma unroll
  for (int c = 0; c < CW; ++c) {
    const int ci = min(first_center + c, m - 1);
    const float* q = centers + (static_cast<long long>(b) * m + ci) * 3;
    cx[c] = q[0];
    cy[c] = q[1];
    cz[c] = q[2];
    c2[c] = sq3(cx[c], cy[c], cz[c]);
    // a slot past the last center tests against 0 and so collects nothing
    thr[c] = first_center + c < m ? r2 : 0.0f;
    have[c] = 0;
  }
  const unsigned below = (1u << lane) - 1u;
  Key* my_lists = lists + static_cast<long long>(warp) * CW * cap;

  stage(0);
  for (int t = 0; t < ntiles; ++t) {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();   // tile t is here, and tile t - 1 is done with
    if (t + 1 < ntiles) stage(t + 1);
    const float* rw = raw + (t & 1) * raw_len + shift;
    const int count = min(tile, n - t * tile);
    const int padded = (count + 31) & ~31;
    for (int i = threadIdx.x; i < padded; i += blockDim.x) {
      // past the tile's last point: infinitely far from every center
      float4 p = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(0x7f800000));
      if (i < count) {
        p.x = rw[3 * i];
        p.y = rw[3 * i + 1];
        p.z = rw[3 * i + 2];
        p.w = sq3(p.x, p.y, p.z);
      }
      s_pts[i] = p;
    }
    __syncthreads();

    for (int j0 = 0; j0 < padded; j0 += 32) {
      const float4 p = s_pts[j0 + lane];
      float d2[CW];   // before the max with 0
      bool any = false;
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const float ab =
            __fadd_rn(__fadd_rn(__fmul_rn(cx[c], p.x), __fmul_rn(cy[c], p.y)),
                      __fmul_rn(cz[c], p.z));
        d2[c] = __fsub_rn(__fadd_rn(c2[c], p.w), __fmul_rn(2.0f, ab));
        any = any || d2[c] < thr[c];
      }
      // the max with 0 can only raise d2, so no hit escapes this vote
      if (__any_sync(kFull, any)) {
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const float d = fmaxf(d2[c], 0.0f);
          const bool hit = d < thr[c];
          const unsigned mask = __ballot_sync(kFull, hit);
          if (mask != 0) {
            Key* list = my_lists + c * cap;
            if (hit)
              list[have[c] + __popc(mask & below)] =
                  (static_cast<Key>(__float_as_uint(d)) << 32) |
                  static_cast<unsigned>(t * tile + j0 + lane);
            have[c] += __popc(mask);
            if (have[c] > cap - 32) {   // the next 32 points might not fit
              warp_select(list, have[c], k, lane);
              have[c] = k;
              thr[c] =
                  __uint_as_float(static_cast<unsigned>(list[k - 1] >> 32));
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < CW; ++c) {
    if (first_center + c < m) {
      Key* list = my_lists + c * cap;
      warp_select(list, have[c], k, lane);
      const int found = min(have[c], k);
      // pad: repeat the first hit, or 0 for an empty neighbourhood
      const long long pad =
          found > 0 ? static_cast<long long>(list[0] & 0xffffffffull) : 0;
      long long* o =
          out + (static_cast<long long>(b) * m + first_center + c) * k;
      for (int j = lane; j < k; j += 32)
        o[j] = j < found ? static_cast<long long>(list[j] & 0xffffffffull)
                         : pad;
    }
  }
}

template <int CW>
int launch(const float* points, const float* centers, long long* out, int b,
           int n, int m, int k, float r2, int warps, int cap, int tile,
           size_t smem, cudaStream_t stream) {
  if (warps > max_warps(CW)) return static_cast<int>(cudaErrorInvalidValue);
  static size_t allowed = 0;   // dynamic shared memory asked for so far
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        ball_query_kernel<CW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  const int per_block = warps * CW;
  dim3 grid((m + per_block - 1) / per_block, b);
  ball_query_kernel<CW><<<grid, warps * 32, smem, stream>>>(
      points, centers, out, n, m, k, r2, cap, tile,
      static_cast<long long>(b) * n * 3);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of one block (ops/grouping.py::ball_query_smem_bytes is the
// same sum).
long long smem_bytes(int warps, int centers_per_warp, int cap, int tile) {
  return static_cast<long long>(warps) * centers_per_warp * cap * 8 +
         2ll * (3ll * tile + 4) * 4 + 16ll * tile;
}

}  // namespace

extern "C" {

// points: (B, N, 3) f32 at a 16-byte boundary, centers: (B, M, 3) f32, out:
// (B, M, K) int64.  A block has `warps` warps (up to 16; up to 8 of 4 or 8
// centers) of `centers_per_warp` (1, 2, 4 or 8) centers each, lists of
// `cap` keys (a power of two >= K + 32) and point tiles of `tile` points (a
// multiple of 32).  Returns cudaErrorInvalidValue for a launch shape it
// cannot run, among them one whose shared memory a block cannot hold:
// nothing is truncated.
int demf_ball_query(const void* points, const void* centers, void* out, int b,
                    int n, int m, int k, float r2, int warps,
                    int centers_per_warp, int cap, int tile, void* stream) {
  if (b < 0 || m < 0 || n < 1 || k < 1 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (warps < 1 || tile < 32 || tile % 32 || cap < k + 32 ||
      (cap & (cap - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = smem_bytes(warps, centers_per_warp, cap, tile);
  if (smem > kMaxSmem || reinterpret_cast<uintptr_t>(points) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || m == 0) return 0;
  const float* p = static_cast<const float*>(points);
  const float* c = static_cast<const float*>(centers);
  long long* o = static_cast<long long*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(smem);
  switch (centers_per_warp) {
    case 1:
      return launch<1>(p, c, o, b, n, m, k, r2, warps, cap, tile, bytes, st);
    case 2:
      return launch<2>(p, c, o, b, n, m, k, r2, warps, cap, tile, bytes, st);
    case 4:
      return launch<4>(p, c, o, b, n, m, k, r2, warps, cap, tile, bytes, st);
    case 8:
      return launch<8>(p, c, o, b, n, m, k, r2, warps, cap, tile, bytes, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
