// A design the shipped ring was measured against, kept for
// tools/reducer_kernels.py: the same reduce-scatter as
// src/repro_torch/kernels/csrc/peer_ring.cu (same rounds, same additions,
// the same bits), with the n ranks of one slice in one thread-block
// cluster and every partial handed to the successor's shared memory
// (distributed shared memory) instead of through an L2 FIFO.
//
// Block (i, j) of the grid is ring position i of slice j; the cluster is
// the n blocks of a slice, so the hand-off never leaves the cluster and no
// block waits on another cluster (no residency condition, no counters in
// device memory, no epochs).  Each block has kSlots receive slots of
// kTileBytes in its shared memory.  Round s of tile k (write w = k (n-2) +
// s for s <= n-3): the block waits for its slot (w-1) mod kSlots to be
// full (the predecessor's mbarrier arrive, release.cluster), adds its own
// tile (TMA-prefetched, as the shipped kernel does), stores the sum into
// the successor's slot w mod kSlots (st.shared::cluster) once the
// successor has emptied it (its arrive on this block's empty barrier), and
// after a __syncthreads thread 0 arrives on the successor's full barrier
// and on the predecessor's empty barrier.  A cluster barrier at the start
// (barriers initialised) and the end (no arrive lands on a block that has
// left) brackets the ring.  Loopback only, n <= 8 (a portable cluster),
// 16-byte aligned rows and chunks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRanks = 8;
constexpr int kTileBytes = 16384;
constexpr int kSlots = 2;
constexpr int kStages = 3;
constexpr int kSmem = (kSlots + kStages) * kTileBytes;

struct ClusterTable {
  const void* in[kMaxRanks];
  void* out[kMaxRanks];
  int perm[kMaxRanks];
  int n;
  long long units;       // 16-byte units in a chunk
  long long per_block;   // units of a chunk one slice holds
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t remote(uint32_t local, int cta) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(local), "r"(cta));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}

// arrive on a barrier of another block of the cluster, releasing this
// block's writes (ordered before by a __syncthreads) at cluster scope
__device__ __forceinline__ void remote_arrive(uint32_t cluster_addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
                   cluster_addr) : "memory");
}

__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t ok = 0;
  const long long t0 = clock64();
  while (!ok) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(a), "r"(parity) : "memory");
    if (!ok && clock64() - t0 > 20000000000LL) __trap();
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void st_remote(uint32_t addr, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

__device__ __forceinline__ void st_remote(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
}

__device__ __forceinline__ float4 add_unit(float4 a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
  return a;
}

__device__ __forceinline__ uint4 add_unit(uint4 a, uint4 b) {
  uint4 z;
  const __nv_bfloat162* ap = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* bp = reinterpret_cast<const __nv_bfloat162*>(&b);
  __nv_bfloat162* zp = reinterpret_cast<__nv_bfloat162*>(&z);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 fa = __bfloat1622float2(ap[k]);
    const float2 fb = __bfloat1622float2(bp[k]);
    zp[k] = __floats2bfloat162_rn(fa.x + fb.x, fa.y + fb.y);
  }
  return z;
}

template <typename U>
__global__ void __launch_bounds__(kThreads)
ring_cluster_kernel(const __grid_constant__ ClusterTable t) {
  constexpr int kTile = kTileBytes / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full_in[kStages];
  __shared__ __align__(8) uint64_t slot_full[kSlots];
  __shared__ __align__(8) uint64_t slot_empty[kSlots];
  unsigned char* slots = smem;
  unsigned char* stages = smem + kSlots * kTileBytes;

  const int n = t.n;
  const int i = blockIdx.x;          // the cluster's rank: the ring position
  const int j = blockIdx.y;
  const int prev = (i + n - 1) % n, next = (i + 1) % n;
  const long long lo = (long long)j * t.per_block;
  const long long hi = min(lo + t.per_block, t.units);
  const int tiles = hi > lo ? (int)((hi - lo + kTile - 1) / kTile) : 0;
  const int tid = threadIdx.x;
  const U* in_me = static_cast<const U*>(t.in[t.perm[i]]);
  const U* in_pd = static_cast<const U*>(t.in[t.perm[prev]]);
  U* out = static_cast<U*>(t.out[t.perm[i]]);
  const int items = tiles * n;
  auto chunk_of = [&](int s) { return t.perm[((i - s - 2) % n + n) % n]; };
  auto issue = [&](int item) {
    const int k = item / n, q = item - k * n;
    const long long off = (long long)chunk_of(q == 0 ? 0 : q - 1) * t.units +
                          lo + (long long)k * kTile;
    const uint32_t bytes =
        (uint32_t)min((long long)kTile, hi - lo - (long long)k * kTile) * 16u;
    uint64_t* bar = &full_in[item % kStages];
    mbar_expect_tx(bar, bytes);
    bulk_load(stages + (item % kStages) * kTileBytes,
              (q == 0 ? in_pd : in_me) + off, bytes, bar);
  };

  if (tid == 0) {
    for (int q = 0; q < kStages; ++q) mbar_init(&full_in[q], 1);
    for (int q = 0; q < kSlots; ++q) {
      mbar_init(&slot_full[q], 1);
      mbar_init(&slot_empty[q], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();
  int issued = 0;
  if (tid == 0)
    while (issued < items && issued < kStages) issue(issued++);
  const uint32_t succ_slots = remote(smem_u32(slots), next);
  const uint32_t succ_full = remote(smem_u32(slot_full), next);
  const uint32_t pred_empty = remote(smem_u32(slot_empty), prev);

  for (int k = 0; k < tiles; ++k) {
    const long long tlo = lo + (long long)k * kTile;
    const int cnt = (int)min((long long)kTile, hi - tlo);
    for (int s = 0; s < n - 1; ++s) {
      const bool reads_slot = s >= 1;
      const bool writes_slot = s <= n - 3;
      const int w = k * (n - 2) + s;
      const int m = k * n + 1 + s;
      if (s == 0)
        mbar_wait_cluster(&full_in[(m - 1) % kStages], ((m - 1) / kStages) & 1);
      mbar_wait_cluster(&full_in[m % kStages], (m / kStages) & 1);
      if (reads_slot)
        mbar_wait_cluster(&slot_full[(w - 1) % kSlots], ((w - 1) / kSlots) & 1);
      if (writes_slot && w >= kSlots)
        mbar_wait_cluster(&slot_empty[w % kSlots], ((w / kSlots) - 1) & 1);
      const U* mine = reinterpret_cast<const U*>(stages + (m % kStages) * kTileBytes);
      const U* recv = s == 0
          ? reinterpret_cast<const U*>(stages + ((m - 1) % kStages) * kTileBytes)
          : reinterpret_cast<const U*>(slots + ((w - 1) % kSlots) * kTileBytes);
      const uint32_t dst = succ_slots + (w % kSlots) * kTileBytes;
      for (int u = tid; u < cnt; u += kThreads) {
        const U z = add_unit(recv[u], mine[u]);
        if (writes_slot)
          st_remote(dst + u * 16, z);
        else
          out[tlo + u] = z;
      }
      __syncthreads();
      if (tid == 0) {
        if (writes_slot) remote_arrive(succ_full + (w % kSlots) * 8);
        if (reads_slot) remote_arrive(pred_empty + ((w - 1) % kSlots) * 8);
        while (issued < items && issued < k * n + 2 + s + kStages) issue(issued++);
      }
    }
  }
  cluster_sync();
}

template <typename U>
int launch(ClusterTable& t, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(ring_cluster_kernel<U>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kSmem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = t.n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // one wave of clusters: as many slices as clusters fit at once
  cfg.gridDim = dim3(t.n, 1);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, ring_cluster_kernel<U>, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long tiles = (t.units + kTileBytes / 16 - 1) / (kTileBytes / 16);
  const long long blocks = tiles < clusters ? tiles : clusters;
  t.per_block = (t.units + blocks - 1) / blocks;
  cfg.gridDim = dim3(t.n, (unsigned)blocks);
  e = cudaLaunchKernelEx(&cfg, ring_cluster_kernel<U>, t);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0 = float32, 1 = bfloat16; n = 2..8 ranks in ring order perm; per
// rank r: in_rows[r] (n * chunk elements), out_rows[r] (chunk elements),
// all 16-byte aligned, chunk a whole number of 16-byte units.
int peer_ring_cluster_fwd(int dtype, int n, const int* perm,
                          const unsigned long long* in_rows,
                          const unsigned long long* out_rows, long long chunk,
                          void* stream) {
  if (n < 2 || n > kMaxRanks || chunk < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long per_vec = dtype == 0 ? 4 : 8;
  ClusterTable t = {};
  t.n = n;
  uintptr_t bits = 0;
  for (int r = 0; r < n; ++r) {
    if (perm[r] < 0 || perm[r] >= n) return (int)cudaErrorInvalidValue;
    t.perm[r] = perm[r];
    t.in[r] = reinterpret_cast<const void*>(in_rows[r]);
    t.out[r] = reinterpret_cast<void*>(out_rows[r]);
    bits |= in_rows[r] | out_rows[r];
  }
  if (bits % 16 || chunk % per_vec) return (int)cudaErrorInvalidValue;
  t.units = chunk / per_vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float4>(t, s) : launch<uint4>(t, s);
}

}  // extern "C"
