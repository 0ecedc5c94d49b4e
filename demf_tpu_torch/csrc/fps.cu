// Furthest point sampling, one thread-block cluster per batch element.
//
// Replaces: demf_tpu/ops/pallas/fps.py::furthest_point_sample_pallas
// (body _fps_kernel), the TPU kernel that keeps coordinates and the running
// min-distance vector in VMEM for the whole selection loop.
//
// What bounds it on the card: latency, not bytes or operations.  K - 1
// dependent steps, each a pass over N points and an arg-max over all of
// them; a step's arithmetic is ~10 operations a point (0.1 ms for 16 scenes
// of 20,000 points and 2,048 picks at the card's fp32 rate), so the time is
// (K - 1) x the length of one step's dependent chain: the pass over one
// thread's points, the reductions, and whatever synchronises the threads
// that share a scene.
//
// What this design does about it:
// - A cluster of blocks shares a scene (cluster size and block size are the
//   caller's, ops/sampling.py::fps_launch_shape picks them by N), so a
//   scene's pass runs on several SMs and each thread owns few points.  Block
//   r of the cluster owns the points [r * share, (r + 1) * share); thread t
//   owns t, t + T, ... of them and keeps their coordinates and running
//   distances in registers for the whole loop (PPT, a compile-time count).
//   Nothing is read from global memory inside the loop.
// - The pass takes the minimum, a running maximum and the slot that holds
//   it (12 operations a point); the coordinates of that slot are looked
//   up afterwards in a copy of the block's points in shared memory, by the
//   one lane that needs them.
// - Distances are >= 0, so their float bits order as unsigned integers, and
//   the key (bits, 0xffffffff - index) orders as "largest distance, lowest
//   index on ties".  A warp finds its largest key with one redux on the
//   bits and a ballot; the index decides only when two lanes tie, which
//   costs a second redux then.
// - Inside a block: the lane that owns a warp's winner writes (key, x, y, z)
//   into the warp's slot in shared memory, double-buffered by the step's
//   parity, so one __syncthreads a step is enough; then the slots are
//   reduced the same way (every thread going through all slots itself took
//   longer: the time then grew with the number of warps).  A cluster of one
//   block (small N) is done here.
// - Between the blocks, one exchange a step, without a barrier of the whole
//   cluster: warp 0 sends the block's winner into the block's slot in the
//   shared memory of every block of the cluster (distributed shared memory)
//   with st.async, which also counts the bytes in on that block's mbarrier;
//   every thread waits on its own block's mbarrier until all slots are in,
//   then every warp reduces them redundantly.  That is one one-way trip
//   between SMs a step and one slot a block: the time grew with the number
//   of slots when every warp sent its own.  Slots and mbarriers are
//   double-buffered by the step's parity: a block can run at most one step
//   ahead of another, since it needs that block's slot to go on.  The
//   winner's coordinates travel with it, so the next step starts without a
//   dependent load.
// - The distance is rounded as (dx*dx + dy*dy) + dz*dz with the _rn
//   intrinsics so nothing is contracted into an FMA: the picks equal the
//   plain PyTorch version bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 8;   // the portable cluster size

// a slot: key high word (distance bits), key low word (0xffffffff - index),
// x, y; then z on its own.  Both sets are double-buffered by a step's parity.
struct Slots {
  uint4 head[2][kMaxCluster];   // one a block of the cluster, sent to
  float z[2][kMaxCluster];
  uint4 warp_head[2][kMaxWarps];   // one a warp of this block
  float warp_z[2][kMaxWarps];
  unsigned long long arrived[2];   // mbarriers: a step's slots are all in
};
constexpr unsigned kSlotBytes = sizeof(uint4) + sizeof(float);

__device__ __forceinline__ float sqdist(float x, float y, float z, float lx,
                                        float ly, float lz) {
  const float dx = __fsub_rn(x, lx);
  const float dy = __fsub_rn(y, ly);
  const float dz = __fsub_rn(z, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

// every thread of every block of the cluster arrives; writes made before it
// are visible after it
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the address of this block's shared-memory address `local` in block `rank`
__device__ __forceinline__ unsigned remote_address(unsigned local,
                                                   unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  return remote;
}

// store into a block of the cluster and count the bytes in on its mbarrier
__device__ __forceinline__ void send(unsigned addr, uint4 v, unsigned mbar) {
  asm volatile(
      "st.async.weak.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(mbar)
      : "memory");
}

__device__ __forceinline__ void send(unsigned addr, unsigned v,
                                     unsigned mbar) {
  asm volatile(
      "st.async.weak.shared::cluster.mbarrier::complete_tx::bytes.b32 "
      "[%0], %1, [%2];" ::"r"(addr),
      "r"(v), "r"(mbar)
      : "memory");
}

// this step's arrival of the block itself, expecting `bytes` from the sends
__device__ __forceinline__ void expect(unsigned mbar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(mbar),
      "r"(bytes)
      : "memory");
}

// wait until the mbarrier's phase of parity `phase` is complete; the sends
// counted in by it, from any block of the cluster, are then visible
__device__ __forceinline__ void wait(unsigned mbar, unsigned phase) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "%1;\n"
      "@done bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}" ::"r"(mbar),
      "r"(phase)
      : "memory");
}

// the lane that holds the largest key (hi, lo) of the warp, the same in
// every lane; `lo` is asked for only when two lanes tie on `hi`
template <typename Lo>
__device__ __forceinline__ int warp_argmax(unsigned hi, Lo lo) {
  const unsigned m = __reduce_max_sync(0xffffffffu, hi);
  unsigned tied = __ballot_sync(0xffffffffu, hi == m);
  if (tied & (tied - 1)) {
    const unsigned mine = hi == m ? lo() : 0u;
    const unsigned l = __reduce_max_sync(0xffffffffu, mine);
    tied = __ballot_sync(0xffffffffu, hi == m && mine == l);
  }
  return __ffs(tied) - 1;
}

// the slot with the largest key among the first `count` (at most 32)
__device__ __forceinline__ void max_slot(const uint4* head, const float* z,
                                         int count, int lane, uint4& best,
                                         float& best_z) {
  uint2 key = make_uint2(0u, 0u);
  if (lane < count) key = *reinterpret_cast<const uint2*>(head + lane);
  const int from = warp_argmax(key.x, [&] { return key.y; });
  best = head[from];
  best_z = z[from];
}

template <int PPT>
__global__ void __launch_bounds__(kMaxThreads, 1)
    fps_kernel(const float* __restrict__ xyz, long long* __restrict__ out,
               int n, int k, int share) {
  extern __shared__ __align__(16) unsigned char smem[];
  Slots& slots = *reinterpret_cast<Slots*>(smem);
  // the block's points once more, for the one lane that owns a winner
  float* s_xyz = reinterpret_cast<float*>(smem + sizeof(Slots));

  const unsigned rank = cluster_rank();
  const unsigned csize = cluster_size();
  const int b = blockIdx.x / csize;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = threads >> 5;
  const float* p = xyz + static_cast<long long>(b) * n * 3;
  long long* o = out + static_cast<long long>(b) * k;
  const int base = rank * share;
  const int end = min(n, base + share);
  const bool owns = base + tid < end;   // this thread has a point at all

  // slots past the block's share hold distance 0 and can win only against
  // real points at distance 0, which come first in the thread
  float px[PPT], py[PPT], pz[PPT], dist[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int i = base + tid + j * threads;
    const bool real = i < end;
    px[j] = real ? p[3 * i] : 0.0f;
    py[j] = real ? p[3 * i + 1] : 0.0f;
    pz[j] = real ? p[3 * i + 2] : 0.0f;
    dist[j] = real ? 1e10f : 0.0f;
    const int local = tid + j * threads;
    s_xyz[3 * local] = px[j];
    s_xyz[3 * local + 1] = py[j];
    s_xyz[3 * local + 2] = pz[j];
  }
  float lx = p[0], ly = p[1], lz = p[2];
  if (rank == 0 && tid == 0) o[0] = 0;
  const unsigned mbar0 = shared_address(&slots.arrived[0]);
  const unsigned mbar1 = shared_address(&slots.arrived[1]);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(mbar0));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(mbar1));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // where lane r of warp 0 sends the block's slot of either parity: into
  // block r
  const unsigned to = lane < csize ? lane : 0u;
  const unsigned to_mbar0 = remote_address(mbar0, to);
  const unsigned to_mbar1 = remote_address(mbar1, to);
  const unsigned to_head0 =
      remote_address(shared_address(&slots.head[0][rank]), to);
  const unsigned to_head1 =
      remote_address(shared_address(&slots.head[1][rank]), to);
  const unsigned to_z0 = remote_address(shared_address(&slots.z[0][rank]), to);
  const unsigned to_z1 = remote_address(shared_address(&slots.z[1][rank]), to);
  // no block may send into another's shared memory before that block runs
  // and its mbarriers stand
  cluster_barrier();

  for (int step = 1; step < k; ++step) {
    const int parity = step & 1;
    const unsigned mbar = parity ? mbar1 : mbar0;
    if (csize > 1 && tid == 0) expect(mbar, csize * kSlotBytes);
    // the thread's largest distance and its first slot at that distance
    // (a strict > keeps the lowest index)
    float best = -1.0f;
    int at = 0;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      dist[j] = fminf(dist[j], sqdist(px[j], py[j], pz[j], lx, ly, lz));
      if (dist[j] > best) {
        best = dist[j];
        at = j;
      }
    }
    // a thread without a point holds key (0, 0), below every real point's
    const int local = tid + at * threads;
    const unsigned hi = owns ? __float_as_uint(best) : 0u;
    const unsigned lo =
        owns ? 0xffffffffu - static_cast<unsigned>(base + local) : 0u;
    if (lane == warp_argmax(hi, [&] { return lo; })) {
      slots.warp_head[parity][warp] =
          make_uint4(hi, lo, __float_as_uint(s_xyz[3 * local]),
                     __float_as_uint(s_xyz[3 * local + 1]));
      slots.warp_z[parity][warp] = s_xyz[3 * local + 2];
    }
    __syncthreads();

    uint4 head;
    float z;
    if (csize == 1) {
      max_slot(slots.warp_head[parity], slots.warp_z[parity], warps, lane,
               head, z);
    } else {
      if (warp == 0) {
        max_slot(slots.warp_head[parity], slots.warp_z[parity], warps, lane,
                 head, z);
        if (lane < csize) {
          const unsigned to_mbar = parity ? to_mbar1 : to_mbar0;
          send(parity ? to_head1 : to_head0, head, to_mbar);
          send(parity ? to_z1 : to_z0, __float_as_uint(z), to_mbar);
        }
      }
      // steps 1 and 2 wait for phase 0 of their mbarriers, 3 and 4 for 1
      wait(mbar, ((step - 1) >> 1) & 1);
      max_slot(slots.head[parity], slots.z[parity], csize, lane, head, z);
    }
    lx = __uint_as_float(head.z);
    ly = __uint_as_float(head.w);
    lz = z;
    if (rank == 0 && tid == 0) o[step] = 0xffffffffu - head.y;
  }
  // no block may leave while another may still send to it
  cluster_barrier();
}

template <int PPT>
cudaError_t launch(const float* xyz, long long* out, int b, int n, int k,
                   int cluster, int threads, int share, cudaStream_t stream) {
  const size_t smem = sizeof(Slots) + sizeof(float) * 3 * PPT * threads;
  static size_t allowed = 0;   // dynamic shared memory asked for so far
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        fps_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(b) * cluster);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, fps_kernel<PPT>, xyz, out, n, k, share);
}

}  // namespace

extern "C" {

// xyz: (B, N, 3) float32 contiguous; out: (B, K) int64.  A cluster of
// `cluster` blocks (1..8) of `threads` threads (a multiple of 32, at most
// 512) per batch element; each thread then owns
// ceil(ceil(N / cluster) / threads) points, at most 16.
int demf_fps(const void* xyz, void* out, int b, int n, int k, int cluster,
             int threads, void* stream) {
  const float* x = static_cast<const float*>(xyz);
  long long* o = static_cast<long long*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster < 1 || cluster > kMaxCluster || threads < 32 ||
      threads > kMaxThreads || threads % 32 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int share = (n + cluster - 1) / cluster;
  const int ppt = (share + threads - 1) / threads;
  cudaError_t err;
#define DEMF_FPS_CASE(P) \
  if (ppt <= P) err = launch<P>(x, o, b, n, k, cluster, threads, share, s)
  DEMF_FPS_CASE(1);
  else DEMF_FPS_CASE(2);
  else DEMF_FPS_CASE(3);
  else DEMF_FPS_CASE(4);
  else DEMF_FPS_CASE(5);
  else DEMF_FPS_CASE(6);
  else DEMF_FPS_CASE(8);
  else DEMF_FPS_CASE(10);
  else DEMF_FPS_CASE(12);
  else DEMF_FPS_CASE(16);
  else err = cudaErrorInvalidValue;
#undef DEMF_FPS_CASE
  return static_cast<int>(err);
}

}  // extern "C"
