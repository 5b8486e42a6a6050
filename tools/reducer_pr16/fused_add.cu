// Elementwise accumulate out = (a.f32 + b.f32) rounded once to the output
// type, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_add_kernel` / `fused_add`
// (src/repro/kernels/ring_collective.py), the reduce of every ring step and
// of every `reduce` step of the schedule runner and the overlap state
// machine.  The TPU version tiles the flattened, zero-padded inputs into
// 1024-element VMEM blocks on a sequential grid; here there is no padding:
// a grid-stride loop walks the n elements, and a scalar tail handles any
// length.
//
// What bounds it: one f32 add per element against 3 * n * itemsize bytes
// (two reads, one write), so it is bound by device memory (3.35 TB/s on an
// H100 SXM), never by arithmetic.  The design does the one thing that
// matters for that: each thread moves 16 bytes per load and store (float4,
// or 8 bf16 as uint4) when all three pointers are 16-byte aligned, with
// enough blocks in flight (8 per SM) to keep HBM busy.  `out` may alias `a`
// (the in-place accumulate): every element is read and written by the same
// thread, so no pointer is declared __restrict__.
//
// f32 and bf16; the sum is taken in f32 and rounded to nearest even once,
// which is what `(a.float() + b.float()).to(dtype)` does in PyTorch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__global__ void __launch_bounds__(kThreads)
fused_add_f32(const float* a, const float* b, float* out, long long n, int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nv = vec ? n / 4 : 0;
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (long long i = tid; i < nv; i += stride) {
    float4 x = a4[i];
    const float4 y = b4[i];
    x.x += y.x;
    x.y += y.y;
    x.z += y.z;
    x.w += y.w;
    o4[i] = x;
  }
  for (long long i = nv * 4 + tid; i < n; i += stride) out[i] = a[i] + b[i];
}

__global__ void __launch_bounds__(kThreads)
fused_add_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b,
               __nv_bfloat16* out, long long n, int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nv = vec ? n / 8 : 0;
  const uint4* a8 = reinterpret_cast<const uint4*>(a);
  const uint4* b8 = reinterpret_cast<const uint4*>(b);
  uint4* o8 = reinterpret_cast<uint4*>(out);
  for (long long i = tid; i < nv; i += stride) {
    const uint4 x = a8[i];
    const uint4 y = b8[i];
    uint4 z;
    const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
    __nv_bfloat162* zp = reinterpret_cast<__nv_bfloat162*>(&z);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 fx = __bfloat1622float2(xp[k]);
      const float2 fy = __bfloat1622float2(yp[k]);
      zp[k] = __floats2bfloat162_rn(fx.x + fy.x, fx.y + fy.y);
    }
    o8[i] = z;
  }
  for (long long i = nv * 8 + tid; i < n; i += stride)
    out[i] = __float2bfloat16(__bfloat162float(a[i]) + __bfloat162float(b[i]));
}

int grid_for(long long items) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long want = (items + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSm;
  return (int)(want < 1 ? 1 : (want < cap ? want : cap));
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (a, b and out share it).  n elements,
// any n >= 1; out may equal a.  Launches on `stream`, does not
// synchronise, returns cudaGetLastError() after the launch (0 on success).
int fused_add_fwd(int dtype, const void* a, const void* b, void* out,
                  long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(out);
  const int vec = (bits % 16) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const long long items = vec ? (n / 4 > 0 ? n / 4 : n) : n;
    fused_add_f32<<<grid_for(items), kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(out), n, vec);
  } else if (dtype == 1) {
    const long long items = vec ? (n / 8 > 0 ? n / 8 : n) : n;
    fused_add_bf16<<<grid_for(items), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(out), n, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
