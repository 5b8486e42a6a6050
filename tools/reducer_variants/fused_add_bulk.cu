// The design `fused_add` was measured against, kept for
// tools/reducer_kernels.py: out = (a.f32 + b.f32) rounded once, as a stream
// of TMA bulk copies through shared memory (sm_90a), with the same C
// interface as src/repro_torch/kernels/csrc/fused_add.cu (whose register
// kernel runs the calls with no common 16-byte body here too).
//
// Replaces the TPU kernel `_add_kernel` / `fused_add`
// (src/repro/kernels/ring_collective.py), the reduce of every ring step and
// of every `reduce` step of the schedule runner and the overlap state
// machine.  The TPU version tiles the flattened, zero-padded inputs into
// 1024-element VMEM blocks on a sequential grid; here there is no padding.
//
// What bounds it: one f32 add per element against 3 * n * itemsize bytes
// (two reads, one write), so device memory (3.35 TB/s on an H100 SXM),
// never arithmetic.  What keeps device memory busy is the bytes each SM
// has in flight, and the design gets them without spending registers:
// * a persistent grid of kCtasPerSm blocks an SM; block c takes tiles c,
//   c + G, c + 2G, ... of the 16-byte aligned body;
// * a ring of kStages shared-memory stages, each an a-tile and a b-tile of
//   kTileBytes; thread 0 fills a stage with two cp.async.bulk loads that
//   complete on the stage's mbarrier, kStages - 1 tiles ahead of the adds,
//   so an SM keeps up to 2 x 2 x 2 x 16 KB of loads in flight;
// * every thread adds its 16-byte units of the stage into the a-tile;
//   after fence.proxy.async and a __syncthreads, thread 0 stores the tile
//   with one cp.async.bulk (bulk_group), and before it refills a stage it
//   waits (cp.async.bulk.wait_group.read) until that stage's store has read
//   it, so the stream never waits on a store reaching memory.
// In place (out == a, or out == b) is safe: a tile is stored only after
// both its inputs are in shared memory, and tiles do not overlap.
//
// Alignment: bulk copies take 16-byte addresses and sizes.  When a, b and
// out sit at the same offset from a 16-byte boundary, the head up to the
// first boundary and the tail after the last whole 16 bytes are added in
// scalars by block 0; when they sit at different offsets there is no
// common body, and the register kernel runs the whole call in scalars.
//
// The register kernel (fused_add_reg) is the design measured beside the
// bulk stream (the shipped fused_add.cu): a grid sized
// to the data, four 16-byte units a thread all loaded before any store,
// __restrict__ pointers out of place and a single read-write pointer in
// place, and b through ld.global.nc.L1::no_allocate.
//
// f32 and bf16; the sum is taken in f32 and rounded to nearest even once,
// which is what `(a.float() + b.float()).to(dtype)` does in PyTorch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileBytes = 16384;   // an a-tile, a b-tile
constexpr int kStages = 3;
constexpr int kCtasPerSm = 2;
constexpr int kSmem = kStages * 2 * kTileBytes;
constexpr int kRegUnits = 4;        // the register kernel's units a thread

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
// trap after about ten seconds then, rather than hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - t0 > 20000000000LL) __trap();
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the stores issued before the last N have read their shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
  return a;
}

// 8 bf16
__device__ __forceinline__ uint4 add(uint4 a, uint4 b) {
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

__device__ __forceinline__ float add(float a, float b) { return a + b; }

// a bf16 scalar travels as its bits
__device__ __forceinline__ unsigned short add(unsigned short a, unsigned short b) {
  const float s = __bfloat162float(__ushort_as_bfloat16(a)) +
                  __bfloat162float(__ushort_as_bfloat16(b));
  return __bfloat16_as_ushort(__float2bfloat16(s));
}

// b: read once, through the non-coherent path, kept out of L1
__device__ __forceinline__ uint4 ld_nc(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ float4 ld_nc(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ float ld_nc(const float* p) {
  float v;
  asm volatile("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned short ld_nc(const unsigned short* p) {
  unsigned short v;
  asm volatile("ld.global.nc.L1::no_allocate.u16 %0, [%1];" : "=h"(v) : "l"(p));
  return v;
}

// the scalars before and after the 16-byte body (one thread an element, so
// in place is safe)
template <typename S>
__device__ __forceinline__ void scalar_edges(const S* a, const S* b, S* out,
                                             long long n, long long head,
                                             long long body) {
  for (long long e = threadIdx.x; e < head; e += kThreads) out[e] = add(a[e], b[e]);
  for (long long e = head + body + threadIdx.x; e < n; e += kThreads)
    out[e] = add(a[e], b[e]);
}

// V: a 16-byte unit of the scalar S (float4 of float, uint4 of bf16 bits)
template <typename V, typename S>
__global__ void __launch_bounds__(kThreads)
fused_add_bulk(const S* a, const S* b, S* out, long long n, long long head,
               long long body) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  if (blockIdx.x == 0) scalar_edges(a, b, out, n, head, body);
  const unsigned char* ab = reinterpret_cast<const unsigned char*>(a + head);
  const unsigned char* bb = reinterpret_cast<const unsigned char*>(b + head);
  unsigned char* ob = reinterpret_cast<unsigned char*>(out + head);
  const long long bytes = body * (long long)sizeof(S);
  const long long tiles = (bytes + kTileBytes - 1) / kTileBytes;
  const long long g = gridDim.x;
  const long long c = blockIdx.x;
  const int mine = tiles > c ? (int)((tiles - c + g - 1) / g) : 0;
  if (mine == 0) return;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int q) {
    const long long off = (c + (long long)q * g) * kTileBytes;
    const uint32_t nb = (uint32_t)min((long long)kTileBytes, bytes - off);
    unsigned char* st = smem + (q % kStages) * 2 * kTileBytes;
    uint64_t* bar = &full[q % kStages];
    mbar_expect_tx(bar, 2 * nb);
    bulk_load(st, ab + off, nb, bar);
    bulk_load(st + kTileBytes, bb + off, nb, bar);
  };

  if (tid == 0)
    for (int q = 0; q < mine && q < kStages; ++q) issue(q);
  for (int q = 0; q < mine; ++q) {
    const long long off = (c + (long long)q * g) * kTileBytes;
    const int nb = (int)min((long long)kTileBytes, bytes - off);
    V* sa = reinterpret_cast<V*>(smem + (q % kStages) * 2 * kTileBytes);
    const V* sb = sa + kTileBytes / 16;
    mbar_wait(&full[q % kStages], (q / kStages) & 1);
    for (int u = tid; u < nb / 16; u += kThreads) sa[u] = add(sa[u], sb[u]);
    // the adds (generic proxy) before the bulk store (async proxy) reads them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      bulk_store(ob + off, sa, (uint32_t)nb);
      // refill the stage of tile q-1 once its store has read it
      if (q >= 1 && q - 1 + kStages < mine) {
        bulk_wait_read<1>();
        issue(q - 1 + kStages);
      }
    }
  }
  if (tid == 0) bulk_wait_all();
}

// out of place: a, b and out do not overlap
template <typename V, typename S>
__global__ void __launch_bounds__(kThreads)
fused_add_reg(const S* __restrict__ a, const S* __restrict__ b,
              S* __restrict__ out, long long n, long long head, long long body) {
  if (blockIdx.x == 0) scalar_edges(a, b, out, n, head, body);
  const V* __restrict__ av = reinterpret_cast<const V*>(a + head);
  const V* __restrict__ bv = reinterpret_cast<const V*>(b + head);
  V* __restrict__ ov = reinterpret_cast<V*>(out + head);
  const long long units = body * (long long)sizeof(S) / (long long)sizeof(V);
  const long long u0 = (long long)blockIdx.x * kThreads * kRegUnits + threadIdx.x;
  V x[kRegUnits], y[kRegUnits];
#pragma unroll
  for (int e = 0; e < kRegUnits; ++e) {
    const long long u = u0 + e * kThreads;
    if (u < units) {
      x[e] = av[u];
      y[e] = ld_nc(bv + u);
    }
  }
#pragma unroll
  for (int e = 0; e < kRegUnits; ++e) {
    const long long u = u0 + e * kThreads;
    if (u < units) ov[u] = add(x[e], y[e]);
  }
}

// in place: acc = acc + b, acc the one read-write pointer
template <typename V, typename S>
__global__ void __launch_bounds__(kThreads)
fused_add_reg_inplace(S* __restrict__ acc, const S* __restrict__ b, long long n,
                      long long head, long long body) {
  if (blockIdx.x == 0) scalar_edges<S>(acc, b, acc, n, head, body);
  V* __restrict__ av = reinterpret_cast<V*>(acc + head);
  const V* __restrict__ bv = reinterpret_cast<const V*>(b + head);
  const long long units = body * (long long)sizeof(S) / (long long)sizeof(V);
  const long long u0 = (long long)blockIdx.x * kThreads * kRegUnits + threadIdx.x;
  V x[kRegUnits], y[kRegUnits];
#pragma unroll
  for (int e = 0; e < kRegUnits; ++e) {
    const long long u = u0 + e * kThreads;
    if (u < units) {
      x[e] = av[u];
      y[e] = ld_nc(bv + u);
    }
  }
#pragma unroll
  for (int e = 0; e < kRegUnits; ++e) {
    const long long u = u0 + e * kThreads;
    if (u < units) av[u] = add(x[e], y[e]);
  }
}

template <typename V, typename S>
int launch_reg(const S* a, const S* b, S* out, long long n, long long head,
               long long body, cudaStream_t stream) {
  const long long units = body * (long long)sizeof(S) / (long long)sizeof(V);
  const long long per_block = (long long)kThreads * kRegUnits;
  const long long grid = units > 0 ? (units + per_block - 1) / per_block : 1;
  if (out == a)
    fused_add_reg_inplace<V, S><<<(unsigned)grid, kThreads, 0, stream>>>(
        out, b, n, head, body);
  else if (out == b)   // (b + a) == (a + b): one f32 add, rounded once
    fused_add_reg_inplace<V, S><<<(unsigned)grid, kThreads, 0, stream>>>(
        out, a, n, head, body);
  else
    fused_add_reg<V, S><<<(unsigned)grid, kThreads, 0, stream>>>(a, b, out, n,
                                                                 head, body);
  return (int)cudaGetLastError();
}

template <typename V, typename S>
int launch_bulk(const S* a, const S* b, S* out, long long n, long long head,
                long long body, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fused_add_bulk<V, S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (body * (long long)sizeof(S) + kTileBytes - 1) / kTileBytes;
  const long long cap = (long long)sms * kCtasPerSm;
  const long long grid = tiles < cap ? tiles : cap;
  fused_add_bulk<V, S><<<(unsigned)grid, kThreads, kSmem, stream>>>(a, b, out, n,
                                                                   head, body);
  return (int)cudaGetLastError();
}

template <typename V, typename S>
int launch(const S* a, const S* b, S* out, long long n, cudaStream_t stream) {
  const uintptr_t oa = reinterpret_cast<uintptr_t>(a) % 16;
  const bool common = oa == reinterpret_cast<uintptr_t>(b) % 16 &&
                      oa == reinterpret_cast<uintptr_t>(out) % 16 &&
                      oa % sizeof(S) == 0;
  const long long per = 16 / (long long)sizeof(S);
  long long head = 0, body = 0;
  if (common) {
    head = (long long)((16 - oa) % 16) / (long long)sizeof(S);
    head = head < n ? head : n;
    body = (n - head) / per * per;
  }
  // no common 16-byte body: every element in scalars
  if (body == 0) return launch_reg<S, S>(a, b, out, n, 0, n, stream);
  return launch_bulk<V, S>(a, b, out, n, head, body, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (a, b and out share it).  n elements,
// any n >= 1, at any element offset; out may equal a (or b).  Launches on
// `stream`, does not synchronise, returns cudaGetLastError() after the
// launch (0 on success).
int fused_add_fwd(int dtype, const void* a, const void* b, void* out,
                  long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float4, float>(static_cast<const float*>(a),
                                 static_cast<const float*>(b),
                                 static_cast<float*>(out), n, s);
  if (dtype == 1)
    return launch<uint4, unsigned short>(static_cast<const unsigned short*>(a),
                                         static_cast<const unsigned short*>(b),
                                         static_cast<unsigned short*>(out), n, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
