// The rank-reordered ring reduce-scatter as one kernel over peer memory,
// for Hopper (sm_90a).
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
// Layout.  One launch does the whole reduce-scatter on a grid of n x B
// blocks: block (j, r) owns element slice j of every chunk of rank r.  A
// descriptor table gives each rank a pointer to its input row [L], its
// per-round partial slots [(n-2) * L/n], its output row [L/n] and its B
// flags.  The table is a kernel parameter (the constant bank, captured by
// value in a CUDA graph).  In the loopback mode that is built here all n
// ranks' buffers live on one card; across cards the same table would hold
// peer-mapped pointers (cudaIpc / NVLink P2P) and the kernel would not
// change, with `.sys` in place of `.gpu` on the flag operations.
//
// The trouble spots and what the design does about them:
// * Residency.  Every block spins on a flag another block of the same
//   launch sets, so all n x B blocks must be resident at once: B is capped
//   by cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs / n, and a larger
//   grid is refused (cudaErrorCooperativeLaunchTooLarge).
// * Memory ordering.  The producer stores its slice, __syncthreads(), then
//   thread 0 does __threadfence() and a release store of its flag
//   (st.release.gpu).  The consumer's thread 0 spins with ld.acquire.gpu,
//   then __syncthreads(); the partials are read with ld.global.cg (L2, not
//   the incoherent L1).
// * Buffer reuse.  Each intermediate round has its own slot, so a producer
//   that runs ahead never overwrites a partial not yet read; round 0 reads
//   the predecessor's input row directly and the last round writes the
//   output row.  Scratch: (n-2) * L/n elements a rank.
// * Flags across launches and graph replay.  No epoch comes from the host.
//   Each block reads its own flag at entry as the base; every flag of slice
//   j advances by n-2 a launch, so all ranks' flags of one slice are equal
//   when a launch starts, whatever B or perm the launches used.
// * Hangs.  Every spin is bounded by %globaltimer (2 s from the block's
//   start).  On expiry the block writes 1 to the status word and returns;
//   the blocks downstream of it time out in turn.  The caller reads the
//   status after its synchronise.
//
// What bounds it.  The kernel does one f32 add per element moved, so it is
// bound by bytes.  In loopback the ring moves 3 (n-1) L itemsize bytes of
// device memory (each round, each rank reads the predecessor's partial and
// its own chunk and writes its partial): 1.707 ms for the largest call of
// the training path, [8, 136134656] bf16, at 3.35 TB/s (H100 SXM).  A plain
// `x.sum(0)` computes the same function from 9 L itemsize bytes at n=8, so
// on one card the ring cannot beat it: its worth is across links, where
// each rank sends (n-1)/n L itemsize bytes over NVLink (450 GB/s each way).
// 16-byte vector loads and stores (float4, or 8 bf16) where every row and
// chunk is 16-byte aligned, scalars otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRanks = 32;
// units a thread handles per round before another block is worth having
constexpr int kUnitsPerThread = 4;
constexpr unsigned long long kTimeoutNs = 2000000000ull;

struct RankDesc {
  const void* in;        // input row, L elements
  void* slots;           // (n-2) partial slots of L/n elements
  void* out;             // output row, L/n elements
  unsigned int* flags;   // one flag per block of this rank
};

struct RingTable {
  RankDesc rank[kMaxRanks];
  int perm[kMaxRanks];     // perm[i] = rank at ring position i
  int pos_of[kMaxRanks];   // pos_of[perm[i]] = i
  int n;
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

template <typename U>
__global__ void __launch_bounds__(kThreads)
peer_ring_kernel(const __grid_constant__ RingTable t) {
  const int j = blockIdx.x;
  const int r = blockIdx.y;
  const int n = t.n;
  const int i = t.pos_of[r];
  const int prev = t.perm[(i - 1 + n) % n];
  const RankDesc me = t.rank[r];
  const RankDesc pd = t.rank[prev];
  unsigned int* my_flag = me.flags + j;
  const unsigned int* prev_flag = pd.flags + j;
  const long long lo = (long long)j * t.per_block;
  const long long hi = min(lo + t.per_block, t.units);

  __shared__ unsigned int s_base;
  __shared__ int s_abort;
  if (threadIdx.x == 0) {
    // only this block writes its flag, and the last launch has ended
    s_base = *reinterpret_cast<volatile unsigned int*>(my_flag);
    s_abort = 0;
  }
  __syncthreads();
  const unsigned int base = s_base;
  const unsigned long long t0 = globaltimer();

  const U* in_me = static_cast<const U*>(me.in);
  for (int s = 0; s < n - 1; ++s) {
    const int c = t.perm[((i - s - 2) % n + n) % n];
    const U* mine = in_me + (long long)c * t.units;
    const U* recv;
    if (s == 0) {
      recv = static_cast<const U*>(pd.in) + (long long)c * t.units;
    } else {
      if (threadIdx.x == 0) {
        const unsigned int want = base + (unsigned int)s;
        while ((int)(ld_acquire(prev_flag) - want) < 0) {
          if (globaltimer() - t0 > kTimeoutNs) {
            atomicCAS(t.status, 0, 1);
            s_abort = 1;
            break;
          }
          __nanosleep(32);
        }
        __threadfence();
      }
      __syncthreads();
      if (s_abort) return;
      recv = static_cast<const U*>(pd.slots) + (long long)(s - 1) * t.units;
    }
    U* dst = (s == n - 2) ? static_cast<U*>(me.out)
                          : static_cast<U*>(me.slots) + (long long)s * t.units;
    for (long long k = lo + threadIdx.x; k < hi; k += kThreads)
      dst[k] = add_unit(__ldcg(recv + k), mine[k]);
    if (s < n - 2) {
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        st_release(my_flag, base + (unsigned int)(s + 1));
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
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, peer_ring_kernel<U>, kThreads, 0);
  *out = per_sm * sms;
  return (int)e;
}

template <typename U>
int launch(RingTable& t, long long elems_per_unit, long long chunk,
           int max_blocks, cudaStream_t stream) {
  int resident = 0;
  const int err = resident_blocks<U>(&resident);
  if (err) return err;
  t.units = chunk / elems_per_unit;
  const long long want =
      (t.units + (long long)kThreads * kUnitsPerThread - 1) /
      ((long long)kThreads * kUnitsPerThread);
  long long blocks = want < 1 ? 1 : want;
  if (blocks > max_blocks) blocks = max_blocks;
  // every block of the grid must be resident at once, or a spin never ends
  if (blocks * t.n > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  t.per_block = (t.units + blocks - 1) / blocks;
  peer_ring_kernel<U><<<dim3((unsigned)blocks, (unsigned)t.n), kThreads, 0,
                        stream>>>(t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks a rank may have: the resident blocks of the card over n, for the
// kernel instance with the lowest occupancy.  The caller sizes each rank's
// flag array by it.
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
  *out = m / n;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16.  n ranks (2..32) in ring order perm;
// per rank r: in_rows[r] (L = n * chunk elements), slot_rows[r] ((n-2) *
// chunk elements; unused when n == 2), out_rows[r] (chunk elements),
// flag_rows[r] (max_blocks flags, zero when first allocated and touched by
// nothing else).  status: one int, 0 before the first launch.  Launches on
// `stream`, does not synchronise, returns cudaGetLastError() after the
// launch (0 on success).
int peer_ring_fwd(int dtype, int n, const int* perm,
                  const unsigned long long* in_rows,
                  const unsigned long long* slot_rows,
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
    t.rank[r].slots = reinterpret_cast<void*>(slot_rows[r]);
    t.rank[r].out = reinterpret_cast<void*>(out_rows[r]);
    t.rank[r].flags = reinterpret_cast<unsigned int*>(flag_rows[r]);
    bits |= in_rows[r] | out_rows[r] | (n > 2 ? slot_rows[r] : 0);
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
