// RWKV6 WKV as the exact token-by-token recurrence, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_wkv_kernel` / `wkv_scan`
// (src/repro/kernels/rwkv6_scan.py).  From a zero [K, V] f32 state S, for
// every token t of one (b, h):
//
//   y_t[j] = sum_k r_t[k] * (S[k][j] + u[k] * k_t[k] * v_t[j])
//   S[k][j] = w_t[k] * S[k][j] + k_t[k] * v_t[j]
//
// All arithmetic in f32; y is stored in the input type.  Unlike the chunk
// kernel (wkv_chunked.cu) nothing is reassociated: this is the recurrence
// itself, not its matmul form, and no final state is written (the
// reference returns y only).
//
// Design: one thread block per (b, h); the TPU's sequential chunk axis
// becomes a loop over the tokens inside the block, which carries the state
// across chunk boundaries and starts from zero at every launch.  Each of
// the V threads owns one state column: its K f32 values live in registers
// (64 at rwkv6's head width).  A stage of up to kMaxStage tokens (a whole
// chunk at the reference's chunk of 64) is loaded into shared memory with
// coalesced loads, as the TPU kernel holds a chunk in VMEM; then each
// thread walks the stage's tokens, reading r, k, w as broadcasts from
// shared memory, and writes its y element (a warp writes contiguous y).
// Inputs are read through their (b, s, h) strides, so the [B, S, H, K]
// layout needs no transposed copies.
//
// What bounds it: at B=8, S=512, H=32, K=V=64 in bf16 a call moves
// 83,894,272 bytes (0.025 ms at 3.35 TB/s) and needs 5*K*V + 3*K + 2*V
// f32 operations a token and head (the u bonus is rank one), 2.73 GFLOP
// (0.0407 ms at 67 TFLOP/s without tensor cores): operations bound it.  This first version has 256 blocks of 64
// threads, about two blocks (four warps) an SM, so latency rather than
// either rate limits it; several threads a column with a shuffle
// reduction, more blocks a head and TMA staging are for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 64;
constexpr int kMaxV = 64;
constexpr int kMaxStage = 64;   // tokens staged in shared memory at once

// Element strides of r, k, v, w (index 0..3) over b, s and h; the last
// dimension is contiguous.
struct Strides {
  long long b[4], s[4], h[4];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Dynamic shared memory: u [K], then per staged token r, k, w [stage][K]
// and v [stage][V], all f32.
template <typename T>
__global__ void __launch_bounds__(kMaxV)
wkv_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const float* __restrict__ u, T* __restrict__ y,
                int S, int H, int K, int V, int stage, Strides st) {
  extern __shared__ float smem[];
  float* s_u = smem;                     // [K]
  float* s_r = s_u + kMaxK;              // [stage][K]
  float* s_k = s_r + stage * K;          // [stage][K]
  float* s_w = s_k + stage * K;          // [stage][K]
  float* s_v = s_w + stage * K;          // [stage][V]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x;             // this thread's state column
  const int nthreads = blockDim.x;

  const T* rb = r + b * st.b[0] + h * st.h[0];
  const T* kb = k + b * st.b[1] + h * st.h[1];
  const T* vb = v + b * st.b[2] + h * st.h[2];
  const T* wb = w + b * st.b[3] + h * st.h[3];
  T* yb = y + ((long long)b * S * H + h) * V;     // y is [B, S, H, V] contiguous
  const long long y_s = (long long)H * V;

  for (int i = j; i < K; i += nthreads) s_u[i] = u[(long long)h * K + i];

  float state[kMaxK];                    // S[:, j], fresh at every launch
#pragma unroll
  for (int kk = 0; kk < kMaxK; ++kk) state[kk] = 0.f;

  for (int s0 = 0; s0 < S; s0 += stage) {
    const int n = min(stage, S - s0);
    __syncthreads();  // the previous stage is read; s_u is written
    // 1. stage n tokens of r, k, w and v in f32 (consecutive threads on
    //    consecutive elements of a token's row)
    for (int i = j; i < n * K; i += nthreads) {
      const int t = i / K, c = i - t * K;
      const long long s = s0 + t;
      s_r[i] = to_f32(rb[s * st.s[0] + c]);
      s_k[i] = to_f32(kb[s * st.s[1] + c]);
      s_w[i] = to_f32(wb[s * st.s[3] + c]);
    }
    for (int i = j; i < n * V; i += nthreads) {
      const int t = i / V, c = i - t * V;
      s_v[i] = to_f32(vb[(s0 + t) * st.s[2] + c]);
    }
    __syncthreads();
    if (j >= V) continue;
    // 2. the recurrence over the stage, token by token
    for (int t = 0; t < n; ++t) {
      const float* rt = s_r + t * K;
      const float* kt = s_k + t * K;
      const float* wt = s_w + t * K;
      const float vj = s_v[t * V + j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};   // four chains over k
#pragma unroll
      for (int kk = 0; kk < kMaxK; ++kk) {
        if (kk < K) {
          const float kv = kt[kk] * vj;
          acc[kk & 3] = fmaf(rt[kk], fmaf(s_u[kk], kv, state[kk]), acc[kk & 3]);
          state[kk] = fmaf(wt[kk], state[kk], kv);
        }
      }
      yb[(s0 + t) * y_s + j] = from_f32<T>((acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, void* y, int B, int S, int H, int K, int V,
           int stage, const Strides& st, cudaStream_t s) {
  const size_t smem = sizeof(float) * (kMaxK + (size_t)stage * (3 * K + V));
  // above 48 KB only by the attribute; set it for the largest stage, once
  // a device
  constexpr int kMaxDevices = 64;
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices || !configured[dev]) {
    e = cudaFuncSetAttribute(
        wkv_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * (kMaxK + kMaxStage * (3 * kMaxK + kMaxV))));
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) configured[dev] = true;
  }
  // one warp-multiple of threads covering the V columns
  const int threads = ((V + 31) / 32) * 32;
  wkv_scan_kernel<T><<<B * H, threads, smem, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u,
      static_cast<T*>(y), S, H, K, V, stage, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w and y); u is f32 [H, K].
// chunk: the reference's block of tokens (S % chunk == 0); the kernel
// stages min(chunk, 64) tokens at a time, which changes no result.
// strides: 12 element strides, r/k/v/w over b, then s, then h.
// Returns cudaGetLastError() after the launch (0 on success).
int wkv_scan_fwd(int dtype, const void* r, const void* k, const void* v,
                 const void* w, const float* u, void* y, int B, int S, int H,
                 int K, int V, int chunk, const long long* strides,
                 void* stream) {
  if (K < 1 || K > kMaxK || V < 1 || V > kMaxV || chunk < 1 ||
      S % chunk != 0)
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 4; ++i) {
    st.b[i] = strides[i];
    st.s[i] = strides[4 + i];
    st.h[i] = strides[8 + i];
  }
  const int stage = chunk < kMaxStage ? chunk : kMaxStage;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, y, B, S, H, K, V, stage, st, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, y, B, S, H, K, V, stage, st, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
