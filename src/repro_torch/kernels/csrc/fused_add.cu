// Elementwise accumulate out = (a.f32 + b.f32) rounded once to the output
// type, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_add_kernel` / `fused_add`
// (src/repro/kernels/ring_collective.py), the reduce of every ring step and
// of every `reduce` step of the schedule runner and the overlap state
// machine.  The TPU version tiles the flattened, zero-padded inputs into
// 1024-element VMEM blocks on a sequential grid; here there is no padding.
//
// What bounds it: one f32 add per element against 3 * n * itemsize bytes
// (two reads, one write), so device memory (3.35 TB/s on an H100 SXM),
// never arithmetic.  What keeps device memory busy is the bytes in flight,
// and the design puts them there without a loop: a grid sized to the data,
// each thread four 16-byte units of a and b, all eight loads issued before
// any store.  Out of place the three pointers are __restrict__; in place
// (out == a, the runner's accumulate) the same kernel, instantiated for
// it, reads and writes through the single pointer out, so the compiler may
// keep the loads ahead of the stores either way; b goes through the
// non-coherent path and skips L1 (ld.global.nc.L1::no_allocate).
//
// Alignment: when a, b and out sit at the same offset from a 16-byte
// boundary (the runner passes contiguous views at any element offset), the
// head up to the first boundary and the tail after the last whole 16 bytes
// are added in scalars by block 0; when they sit at different offsets, the
// same kernel runs on scalar units throughout.
//
// A stream of TMA bulk copies through shared memory (a persistent grid, a
// stage ring per block, bulk stores back) was the other design; it kept up
// to 128 KB of loads in flight an SM but ran behind this one in both dtypes
// at the training path's largest call (tools/reducer_kernels.py, which
// builds it from tools/reducer_variants/fused_add_bulk.cu).
//
// f32 and bf16; the sum is taken in f32 and rounded to nearest even once,
// which is what `(a.float() + b.float()).to(dtype)` does in PyTorch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRegUnits = 4;   // 16-byte units (or scalars) a thread

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

// V: a unit, 16 bytes of the scalar S (float4 of float, uint4 of bf16 bits)
// or S itself.  Out of place (kInPlace false): a, b and out do not overlap.
// In place (kInPlace true): out = out + b, read and written through the one
// pointer out, and a is not touched.
template <typename V, typename S, bool kInPlace>
__global__ void __launch_bounds__(kThreads)
fused_add_reg(const S* __restrict__ a, const S* __restrict__ b,
              S* __restrict__ out, long long n, long long head, long long body) {
  if (blockIdx.x == 0) scalar_edges(kInPlace ? out : a, b, out, n, head, body);
  V* __restrict__ ov = reinterpret_cast<V*>(out + head);
  const V* __restrict__ bv = reinterpret_cast<const V*>(b + head);
  const V* av = kInPlace ? ov : reinterpret_cast<const V*>(a + head);
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

template <typename V, typename S>
int launch_reg(const S* a, const S* b, S* out, long long n, long long head,
               long long body, cudaStream_t stream) {
  const long long units = body * (long long)sizeof(S) / (long long)sizeof(V);
  const long long per_block = (long long)kThreads * kRegUnits;
  const long long grid = units > 0 ? (units + per_block - 1) / per_block : 1;
  if (out == a)
    fused_add_reg<V, S, true><<<(unsigned)grid, kThreads, 0, stream>>>(
        nullptr, b, out, n, head, body);
  else if (out == b)   // (b + a) == (a + b): one f32 add, rounded once
    fused_add_reg<V, S, true><<<(unsigned)grid, kThreads, 0, stream>>>(
        nullptr, a, out, n, head, body);
  else
    fused_add_reg<V, S, false><<<(unsigned)grid, kThreads, 0, stream>>>(
        a, b, out, n, head, body);
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
  return launch_reg<V, S>(a, b, out, n, head, body, stream);
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
