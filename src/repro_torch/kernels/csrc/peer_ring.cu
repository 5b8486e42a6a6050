// The rank-reordered ring reduce-scatter as one kernel over peer memory,
// for Hopper (sm_90a): a tile-pipelined ring through a FIFO of slots that
// stays in L2.
//
// Replaces the TPU kernel `_rdma_ring_kernel` /
// `remote_ring_reduce_scatter_tpu` (src/repro/kernels/ring_collective.py),
// the hand-written transport of the paper's ring: n-1 rounds in which each
// device copies a buffer to its ring successor by remote DMA and
// accumulates.  The reference kernel is not a reduce-scatter: it forwards
// its running sum, so after s rounds row i holds sum_j C(s,j) x_{i-j}
// (binomial weights, 136 where the true sum is 52 at n=4), it returns
// full-length rows instead of L/n chunks, and it ignores the ring order.
// This kernel computes what the port's `ring_reduce_scatter(x, perm)` computes
// (repro_torch/kernels/ring_collective.py), in the same order of additions:
// in round s the rank at ring position i receives its predecessor's partial
// (the link perm[i-1] -> perm[i]) and adds its own chunk perm[(i-s-2) mod n],
// each add `received.f32 + mine.f32` rounded once to the dtype, as
// `fused_add` does.  After n-1 rounds rank d holds the reduced chunk d.
//
// Layout.  One launch does the whole reduce-scatter on a grid of B x n
// blocks: block (j, r) owns element slice j of every chunk of rank r and
// walks it in tiles of kTileBytes.  A descriptor table gives each rank a
// pointer to its input row [L], its FIFO [max_blocks][kSlots] tiles, its
// output row [L/n] and its counters [2][max_blocks].  The table is a kernel
// parameter (the constant bank, captured by value in a CUDA graph).  In the
// loopback mode that is built here all n ranks' buffers live on one card;
// across cards the same table would hold peer-mapped pointers (cudaIpc /
// NVLink P2P) with the FIFO in the receiver's memory, and the kernel would
// not change but for `.sys` in place of `.gpu` on the counter operations.
//
// Schedule: tile-major.  For tile k of its slice a block runs all n-1
// rounds before it moves to tile k+1.  Round s reads `recv`: in round 0 the
// predecessor's input chunk, later the predecessor's partial of round s-1
// from its FIFO; it adds tile k of its own chunk perm[(i-s-2) mod n] and
// writes the last round (s = n-2) to the output row, every other round to
// its FIFO: write w = k (n-2) + s goes to slot w mod kSlots.  A partial
// travels one hop and is consumed, so it only ever occupies a slot: the
// FIFO is n x max_blocks x kSlots x kTileBytes bytes whatever L is (at most
// kFifoBudget, 16 MiB, so it stays in the 50 MB L2 beside the streaming
// inputs), and device memory sees what `x.sum(0)` moves, x read once and
// the output written once, (n+1) L itemsize bytes, where a round-major ring
// with its partials in device memory moves 3 (n-1) L itemsize.
//
// Counters.  Each (rank, block j) has `produced` (its FIFO writes) and
// `consumed` (the predecessor's FIFO writes it has read).  Before reading
// the predecessor's write w-1 a block waits for produced_pred >= base + w
// and afterwards releases consumed = base + w.  Before its own write w it
// waits for consumed_succ >= base + w - kSlots + 1 (the slot's last tenant,
// write w - kSlots, has been read: the back pressure) and afterwards
// releases produced = base + w + 1.
//
// Epochs come from the device, not the host.  A launch advances both
// counters of every (rank, block j) by tiles_j (n-2), where tiles_j is the
// tile count of slice j: per_block and units are launch-wide, so tiles_j is
// the same on every rank.  The counters start at zero; so, by induction
// over launches, all 2n counters of slice j are equal when a launch starts,
// whatever B, L or perm the earlier launches used (a slice a launch does
// not reach keeps its equal values), and each block reads its own two as
// `base`.  A CUDA graph replays with the bases it finds on the device.
//
// No deadlock.  Number a block's steps o = k (n-1) + s.  A wait at step o
// is (a) for the predecessor's step o-1 (its round s-1 of tile k), or (b)
// for the successor's read of write w - kSlots, which it makes one step
// after the step o' that wrote it; each write has a step of its own, so o'
// <= o - kSlots and o' + 1 <= o - 1 when kSlots >= 2.  Every wait therefore
// points at a strictly earlier step of some block, and with all blocks
// resident (checked at launch) every step completes, by induction on o.
//
// Trouble spots, and what the design does about them:
// * Residency.  Every block spins on counters other blocks of the launch
//   set, so all B x n blocks must be resident at once: B is capped by
//   cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs / n (and by the
//   FIFO budget), and a larger grid is refused
//   (cudaErrorCooperativeLaunchTooLarge).
// * Memory ordering, with no fence on the handshake's path (CUTLASS's
//   inter-block barrier does the same): a block's threads load and store,
//   __syncthreads(), then thread 0 release-stores its counters
//   (st.release.gpu, cumulative over what the barrier ordered before it);
//   thread 0 spins with ld.acquire.gpu (no sleep: the hop's latency is the
//   ring's pace), then __syncthreads(); partials are read with
//   ld.global.cg (L2, not the incoherent L1).
// * Hiding the input latency.  The tiles a block reads from the input rows
//   depend on no counter, so thread 0 streams them with cp.async.bulk (TMA
//   bulk copies, L2 evict-first) into a ring of kStages shared-memory
//   stages, each completing on an mbarrier, kStages - 1 tiles ahead of the
//   step that reads them; the predecessor's round-0 tile is one of them.
//   Slots are stored with an L2 evict-last hint.  The scalar variants (rows
//   or chunks not 16-byte aligned) read the inputs straight from memory.
// * Hangs.  Every spin is bounded by %globaltimer (2 s from the block's
//   start), the back-pressure spin too.  On expiry the block writes 1 to
//   the status word, waits for its outstanding bulk copies and returns;
//   the blocks that wait on it time out in turn.  The caller reads the
//   status after its synchronise.
//
// What bounds it.  One f32 add per element moved: bytes, (n+1) L itemsize
// of device memory, 0.7315 ms for the training path's largest call,
// [8, 136134656] bf16, at 3.35 TB/s (H100 SXM).  A tile's n-1 rounds are
// n-1 dependent handshakes, so a block's time is also at least its steps
// (tiles x (n-1)) times one handshake: a release store that waits for the
// block's slot stores to reach L2, and the successor's acquire.  That
// bound rules at small L, and at the largest L too, where the 16 MiB FIFO
// hands on 8 MiB a hop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRanks = 32;
// kTileBytes, kSlots and kFifoBudget are ring_collective.py's
// RING_TILE_BYTES, RING_SLOTS and RING_FIFO_BUDGET (a test holds them
// equal): the caller allocates the FIFO from them
constexpr int kTileBytes = 16384;               // a slot, a stage
constexpr int kSlots = 2;                       // FIFO slots a block
constexpr int kStages = 3;                      // input tiles in flight + 1
constexpr long long kFifoBudget = 16ll << 20;   // all ranks' FIFOs
constexpr int kBatch = 4;   // units a thread loads before it stores
constexpr unsigned long long kTimeoutNs = 2000000000ull;
static_assert(kSlots >= 2, "the back pressure needs two slots to be acyclic");
static_assert(kStages >= 2, "a stage in use and one loading");
static_assert(kTileBytes % 128 == 0, "whole L2 lines a tile");

struct RankDesc {
  const void* in;        // input row, L elements
  void* fifo;            // max_blocks x kSlots tiles of kTileBytes
  void* out;             // output row, L/n elements
  unsigned int* flags;   // [2][max_blocks]: produced, consumed
};

struct RingTable {
  RankDesc rank[kMaxRanks];
  int perm[kMaxRanks];     // perm[i] = rank at ring position i
  int pos_of[kMaxRanks];   // pos_of[perm[i]] = i
  int n;
  int max_blocks;          // the counters' and the FIFO's blocks a rank
  long long units;         // units (vectors or scalars) in a chunk
  long long per_block;     // units of a chunk one block owns
  int* status;             // 0 = ok, 1 = a spin timed out
};

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned int* p, unsigned int v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// spin until *p >= want (wrapping); false once the block's time is up
__device__ __forceinline__ bool spin_until(const unsigned int* p,
                                           unsigned int want,
                                           unsigned long long t0) {
  while ((int)(ld_acquire(p) - want) < 0)
    if (globaltimer() - t0 > kTimeoutNs) return false;
  return true;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.b32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

// a bulk copy from device memory lands unless the schedule is broken:
// trap then, rather than hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const unsigned long long t0 = globaltimer();
  while (!mbar_try_wait(a, parity))
    if (globaltimer() - t0 > 2 * kTimeoutNs) __trap();
}

__device__ __forceinline__ uint64_t l2_policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// `bytes` (a multiple of 16) from 16-byte aligned device memory into shared
// memory; completes on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy) : "memory");
}

// slot stores, kept in L2 before the streaming inputs
__device__ __forceinline__ void st_slot(uint4* p, uint4 v, uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.v4.u32 [%0], {%1, %2, %3, %4}, %5;" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "l"(pol) : "memory");
}

__device__ __forceinline__ void st_slot(float4* p, float4 v, uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;" ::"l"(p),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "l"(pol) : "memory");
}

__device__ __forceinline__ void st_slot(float* p, float v, uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.f32 [%0], %1, %2;" ::"l"(p), "f"(v),
               "l"(pol) : "memory");
}

__device__ __forceinline__ void st_slot(unsigned short* p, unsigned short v,
                                        uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.u16 [%0], %1, %2;" ::"l"(p), "h"(v),
               "l"(pol) : "memory");
}

// received + mine, summed in f32 and rounded once (what fused_add does)
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

__device__ __forceinline__ float add_unit(float a, float b) { return a + b; }

// bf16 scalars travel as their bits
__device__ __forceinline__ unsigned short add_unit(unsigned short a,
                                                   unsigned short b) {
  const float s = __bfloat162float(__ushort_as_bfloat16(a)) +
                  __bfloat162float(__ushort_as_bfloat16(b));
  return __bfloat16_as_ushort(__float2bfloat16(s));
}

// 16-byte units stream their inputs through shared memory; scalars do not
template <typename U>
constexpr int stage_bytes() {
  return sizeof(U) == 16 ? kStages * kTileBytes : 0;
}

template <typename U>
__global__ void __launch_bounds__(kThreads, 4)
peer_ring_kernel(const __grid_constant__ RingTable t) {
  constexpr bool kBulk = sizeof(U) == 16;
  constexpr int kTile = kTileBytes / (int)sizeof(U);   // units a tile
  extern __shared__ __align__(128) unsigned char stage_mem[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ unsigned int s_base_p, s_base_c;
  __shared__ int s_abort;

  const int j = blockIdx.x;
  const int r = blockIdx.y;
  const int n = t.n;
  const long long lo = (long long)j * t.per_block;
  const long long hi = min(lo + t.per_block, t.units);
  // an empty slice is empty on every rank, so no block waits on it
  if (hi <= lo) return;
  const int tiles = (int)((hi - lo + kTile - 1) / kTile);
  const int i = t.pos_of[r];
  const RankDesc me = t.rank[r];
  const RankDesc pd = t.rank[t.perm[(i + n - 1) % n]];
  const int mb = t.max_blocks;
  unsigned int* my_prod = me.flags + j;
  unsigned int* my_cons = me.flags + mb + j;
  const unsigned int* pd_prod = pd.flags + j;
  const unsigned int* nx_cons = t.rank[t.perm[(i + 1) % n]].flags + mb + j;
  const U* in_me = static_cast<const U*>(me.in);
  const U* in_pd = static_cast<const U*>(pd.in);
  U* fifo_me = static_cast<U*>(me.fifo) + (long long)j * kSlots * kTile;
  const U* fifo_pd =
      static_cast<const U*>(pd.fifo) + (long long)j * kSlots * kTile;
  U* out = static_cast<U*>(me.out);
  const int tid = threadIdx.x;
  // the input tiles a block streams: for each tile the predecessor's
  // round-0 tile, then its own tile of each round
  const int items = tiles * n;

  if (tid == 0) {
    // only this block writes its counters, and the last launch has ended
    s_base_p = *reinterpret_cast<volatile unsigned int*>(my_prod);
    s_base_c = *reinterpret_cast<volatile unsigned int*>(my_cons);
    s_abort = 0;
    if (kBulk) {
      for (int q = 0; q < kStages; ++q) mbar_init(&full[q], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __syncthreads();
  const unsigned int base_p = s_base_p;
  const unsigned int base_c = s_base_c;
  const unsigned long long t0 = globaltimer();
  const uint64_t keep = l2_policy_evict_last();
  uint64_t stream = 0;
  int issued = 0;   // items thread 0 has issued

  auto chunk_of = [&](int s) { return t.perm[((i - s - 2) % n + n) % n]; };
  auto stage = [&](int item) {
    return reinterpret_cast<const U*>(stage_mem + (item % kStages) * kTileBytes);
  };
  auto issue = [&](int item) {
    const int k = item / n, q = item - k * n;
    const long long off = (long long)chunk_of(q == 0 ? 0 : q - 1) * t.units +
                          lo + (long long)k * kTile;
    const uint32_t bytes =
        (uint32_t)min((long long)kTile, hi - lo - (long long)k * kTile) * 16u;
    uint64_t* bar = &full[item % kStages];
    mbar_expect_tx(bar, bytes);
    bulk_load(stage_mem + (item % kStages) * kTileBytes,
              (q == 0 ? in_pd : in_me) + off, bytes, bar, stream);
  };

  if (kBulk && tid == 0) {
    stream = l2_policy_evict_first();
    while (issued < items && issued < kStages) issue(issued++);
  }
  for (int k = 0; k < tiles; ++k) {
    const long long tlo = lo + (long long)k * kTile;
    const int cnt = (int)min((long long)kTile, hi - tlo);
    for (int s = 0; s < n - 1; ++s) {
      const bool reads_slot = s >= 1;
      const bool writes_slot = s <= n - 3;
      const unsigned int w = (unsigned int)(k * (n - 2) + s);
      if (tid == 0) {
        bool ok = true;
        if (reads_slot) ok = spin_until(pd_prod, base_c + w, t0);
        if (ok && writes_slot && w >= (unsigned int)kSlots)
          ok = spin_until(nx_cons, base_p + w - kSlots + 1, t0);
        if (!ok) {
          atomicCAS(t.status, 0, 1);
          s_abort = 1;
        }
      }
      __syncthreads();
      if (s_abort) {
        // let the bulk copies in flight land before the block's shared
        // memory goes away
        if (kBulk && tid == 0)
          for (int q = s == 0 ? k * n : k * n + 1 + s; q < issued; ++q)
            mbar_wait(&full[q % kStages], (q / kStages) & 1);
        return;
      }
      const U* recv;
      const U* mine;
      if (kBulk) {
        const int m = k * n + 1 + s;
        if (s == 0) mbar_wait(&full[(m - 1) % kStages], ((m - 1) / kStages) & 1);
        mbar_wait(&full[m % kStages], (m / kStages) & 1);
        mine = stage(m);
        recv = s == 0 ? stage(m - 1) : fifo_pd + ((w - 1) % kSlots) * kTile;
      } else {
        const long long off = (long long)chunk_of(s) * t.units + tlo;
        mine = in_me + off;
        recv = s == 0 ? in_pd + off : fifo_pd + ((w - 1) % kSlots) * kTile;
      }
      U* dst = writes_slot ? fifo_me + (w % kSlots) * kTile : out + tlo;
      for (int b0 = 0; b0 < cnt; b0 += kThreads * kBatch) {
        U ra[kBatch], rb[kBatch];
#pragma unroll
        for (int e = 0; e < kBatch; ++e) {
          const int u = b0 + tid + e * kThreads;
          if (u < cnt) {
            if (reads_slot)
              ra[e] = __ldcg(recv + u);
            else
              ra[e] = kBulk ? recv[u] : __ldcs(recv + u);
            rb[e] = kBulk ? mine[u] : __ldcs(mine + u);
          }
        }
#pragma unroll
        for (int e = 0; e < kBatch; ++e) {
          const int u = b0 + tid + e * kThreads;
          if (u >= cnt) continue;
          if (writes_slot)
            st_slot(dst + u, add_unit(ra[e], rb[e]), keep);
          else
            dst[u] = add_unit(ra[e], rb[e]);
        }
      }
      __syncthreads();
      if (tid == 0) {
        if (reads_slot) st_release(my_cons, base_c + w);
        if (writes_slot) st_release(my_prod, base_p + w + 1);
        // the stages of the items consumed so far (k n + 2 + s) are free
        if (kBulk)
          while (issued < items && issued < k * n + 2 + s + kStages)
            issue(issued++);
      }
    }
  }
}

template <typename U>
int resident_blocks(int* out) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(peer_ring_kernel<U>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             stage_bytes<U>());
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, peer_ring_kernel<U>, kThreads, stage_bytes<U>());
  *out = per_sm * sms;
  return (int)e;
}

template <typename U>
int launch(RingTable& t, long long elems_per_unit, long long chunk,
           int max_blocks, cudaStream_t stream) {
  int resident = 0;
  const int err = resident_blocks<U>(&resident);
  if (err) return err;
  constexpr long long kTile = kTileBytes / (long long)sizeof(U);
  t.units = chunk / elems_per_unit;
  t.max_blocks = max_blocks;
  const long long tiles = (t.units + kTile - 1) / kTile;
  const long long blocks = tiles < max_blocks ? tiles : max_blocks;
  // every block of the grid must be resident at once, or a spin never ends
  if (blocks * t.n > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  t.per_block = (t.units + blocks - 1) / blocks;
  peer_ring_kernel<U><<<dim3((unsigned)blocks, (unsigned)t.n), kThreads,
                        stage_bytes<U>(), stream>>>(t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks a rank may have: the resident blocks of the card over n, for the
// kernel instance with the lowest occupancy, and at most what keeps all
// n ranks' FIFOs within kFifoBudget.  The caller sizes each rank's
// counters (2 x max_blocks) and FIFO by it.
int peer_ring_max_blocks(int n, int* out) {
  if (n < 2 || n > kMaxRanks) return (int)cudaErrorInvalidValue;
  int a = 0, b = 0, c = 0, d = 0, e = 0;
  if ((e = resident_blocks<float4>(&a))) return e;
  if ((e = resident_blocks<uint4>(&b))) return e;
  if ((e = resident_blocks<float>(&c))) return e;
  if ((e = resident_blocks<unsigned short>(&d))) return e;
  int m = a < b ? a : b;
  m = m < c ? m : c;
  m = m < d ? m : d;
  m /= n;
  const long long fit = kFifoBudget / ((long long)n * kSlots * kTileBytes);
  if (n > 2 && m > fit) m = (int)fit;
  *out = m;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16.  n ranks (2..32) in ring order perm;
// per rank r: in_rows[r] (L = n * chunk elements), fifo_rows[r]
// (max_blocks x kSlots x kTileBytes bytes; unused
// when n == 2), out_rows[r] (chunk elements), flag_rows[r] (2 x max_blocks
// counters, zero when first allocated and touched by nothing else).
// status: one int, 0 before the first launch.  Launches on `stream`, does
// not synchronise, returns cudaGetLastError() after the launch (0 on
// success).
int peer_ring_fwd(int dtype, int n, const int* perm,
                  const unsigned long long* in_rows,
                  const unsigned long long* fifo_rows,
                  const unsigned long long* out_rows,
                  const unsigned long long* flag_rows, long long chunk,
                  int max_blocks, int* status, void* stream) {
  if (n < 2 || n > kMaxRanks || chunk < 1 || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  RingTable t = {};
  t.n = n;
  t.status = status;
  uintptr_t bits = 0;
  for (int i = 0; i < n; ++i) {
    const int p = perm[i];
    if (p < 0 || p >= n) return (int)cudaErrorInvalidValue;
    t.perm[i] = p;
    t.pos_of[p] = i;
  }
  for (int r = 0; r < n; ++r) {
    t.rank[r].in = reinterpret_cast<const void*>(in_rows[r]);
    t.rank[r].fifo = reinterpret_cast<void*>(fifo_rows[r]);
    t.rank[r].out = reinterpret_cast<void*>(out_rows[r]);
    t.rank[r].flags = reinterpret_cast<unsigned int*>(flag_rows[r]);
    bits |= in_rows[r] | out_rows[r] | (n > 2 ? fifo_rows[r] : 0);
  }
  const int itemsize = dtype == 0 ? 4 : 2;
  const long long per_vec = 16 / itemsize;
  const bool vec = (bits % 16) == 0 && (chunk % per_vec) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec ? launch<float4>(t, per_vec, chunk, max_blocks, s)
               : launch<float>(t, 1, chunk, max_blocks, s);
  return vec ? launch<uint4>(t, per_vec, chunk, max_blocks, s)
             : launch<unsigned short>(t, 1, chunk, max_blocks, s);
}

}  // extern "C"
