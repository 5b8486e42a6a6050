// A stream's L2 access-policy window, for tools/reducer_kernels.py: pins
// [base, base + bytes) as persisting in L2 for the kernels launched (or
// captured) on `stream`, and takes the pin away again.

#include <cuda_runtime.h>

extern "C" {

// hit_ratio of the window persists; the rest streams.  Sets aside up to
// `bytes` of L2 for persisting lines first.  Returns a CUDA error code.
int l2_window_set(void* stream, void* base, unsigned long long bytes,
                  float hit_ratio) {
  cudaError_t e = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, bytes);
  if (e != cudaSuccess) return (int)e;
  cudaStreamAttrValue v = {};
  v.accessPolicyWindow.base_ptr = base;
  v.accessPolicyWindow.num_bytes = bytes;
  v.accessPolicyWindow.hitRatio = hit_ratio;
  v.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
  v.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
  return (int)cudaStreamSetAttribute(static_cast<cudaStream_t>(stream),
                                     cudaStreamAttributeAccessPolicyWindow, &v);
}

int l2_window_clear(void* stream) {
  cudaStreamAttrValue v = {};
  v.accessPolicyWindow.num_bytes = 0;
  cudaError_t e = cudaStreamSetAttribute(static_cast<cudaStream_t>(stream),
                                         cudaStreamAttributeAccessPolicyWindow, &v);
  if (e == cudaSuccess) e = cudaCtxResetPersistingL2Cache();
  if (e == cudaSuccess) e = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, 0);
  return (int)e;
}

}  // extern "C"
