// RWKV6 WKV in chunked matmul form, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_wkv_chunk_kernel` / `wkv_chunked_matmul`
// (src/repro/kernels/rwkv6_chunked.py).  Per chunk of T <= 32 tokens, with
// A_t = prod_{s<=t} w_s (cumulative decay inside the chunk),
// r~_t = r_t * A_{t-1} and k~_s = k_s / A_s:
//
//   y_t = r~_t S_0 + sum_{s<t} (r~_t . k~_s) v_s + (r_t . (u * k_t)) v_t
//   S_T = A_T (.) S_0 + (k~ A_T)^T V            (carried to the next chunk)
//
// All arithmetic in f32; y is stored in the input type, the final state
// [B, H, K, V] in f32 (the TPU kernel kept it in VMEM scratch and dropped it).
//
// Design: one thread block per (b, h) walks its chunks in order; that loop
// replaces the TPU's sequential grid axis, and the [K, V] f32 state (16 KB at
// K = V = 64) lives in shared memory with the chunk's r~, k~ and v tiles.
// Inputs are read through their (b, s, h) strides, so the [B, S, H, K] layout
// needs no transposed copies.  What bounds it: at B=8, S=512, H=32, K=V=64 in
// bf16 a call moves ~88 MB (~26 us at 3.35 TB/s) and does ~2.4 GFLOP of f32
// multiply-adds (~36 us at 67 TFLOP/s without tensor cores), so it sits where
// both matter.  This first version runs its contractions on CUDA cores from
// shared memory with one block per (b, h); wgmma, TMA and more blocks per
// head are for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 64;
constexpr int kMaxV = 64;
constexpr int kMaxT = 32;
constexpr int kThreads = 256;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv_chunked_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ w,
                   const float* __restrict__ u, T* __restrict__ y,
                   float* __restrict__ state_out, int S, int H, int K, int V,
                   int chunk, Strides st) {
  __shared__ float s_state[kMaxK * kMaxV];       // S, [K][V]
  __shared__ float s_r[kMaxT * kMaxK];           // r, then r~   [T][K]
  __shared__ float s_k[kMaxT * (kMaxK + 1)];     // k, then k~   [T][K+1]
  __shared__ float s_v[kMaxT * kMaxV];           // v            [T][V]
  __shared__ float s_qk[kMaxT * kMaxT];          // strict-lower r~ k~^T
  __shared__ float s_bonus[kMaxT];               // r . (u * k)
  __shared__ float s_decay[kMaxK];               // A_T

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int KP = K + 1;  // padded k~ rows: the qk loop reads columns

  const T* rb = r + b * st.b[0] + h * st.h[0];
  const T* kb = k + b * st.b[1] + h * st.h[1];
  const T* vb = v + b * st.b[2] + h * st.h[2];
  const T* wb = w + b * st.b[3] + h * st.h[3];
  const float* uh = u + (long long)h * K;
  T* yb = y + ((long long)b * S * H + h) * V;     // y is [B, S, H, V] contiguous
  const long long y_s = (long long)H * V;

  for (int i = tid; i < K * V; i += nthreads) s_state[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    __syncthreads();  // the previous chunk is done with s_r, s_k, s_v
    // 1. the chunk's r, k, v in f32
    for (int i = tid; i < chunk * K; i += nthreads) {
      const int t = i / K, c = i - t * K;
      s_r[t * K + c] = to_f32(rb[(c0 + t) * st.s[0] + c]);
      s_k[t * KP + c] = to_f32(kb[(c0 + t) * st.s[1] + c]);
    }
    for (int i = tid; i < chunk * V; i += nthreads) {
      const int t = i / V, c = i - t * V;
      s_v[t * V + c] = to_f32(vb[(c0 + t) * st.s[2] + c]);
    }
    __syncthreads();
    // 2. bonus r_t . (u * k_t): one warp per token
    for (int t = warp; t < chunk; t += nwarps) {
      float acc = 0.f;
      for (int c = lane; c < K; c += 32) acc += s_r[t * K + c] * uh[c] * s_k[t * KP + c];
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) s_bonus[t] = acc;
    }
    __syncthreads();
    // 3. decay: one thread per channel runs the log-cumsum down the chunk
    if (tid < K) {
      float la = 0.f;  // log A_{t-1}
      for (int t = 0; t < chunk; ++t) {
        const float lw = logf(to_f32(wb[(c0 + t) * st.s[3] + tid]));
        s_r[t * K + tid] *= expf(la);
        la += lw;
        s_k[t * KP + tid] *= expf(-la);
      }
      s_decay[tid] = expf(la);
    }
    __syncthreads();
    // 4. qk[t][s] = r~_t . k~_s for s < t, else 0
    for (int i = tid; i < chunk * chunk; i += nthreads) {
      const int t = i / chunk, s = i - t * chunk;
      float acc = 0.f;
      if (s < t)
        for (int c = 0; c < K; ++c) acc += s_r[t * K + c] * s_k[s * KP + c];
      s_qk[i] = acc;
    }
    __syncthreads();
    // 5. y_t = r~_t S_0 + sum_{s<t} qk[t][s] v_s + bonus_t v_t
    for (int i = tid; i < chunk * V; i += nthreads) {
      const int t = i / V, c = i - t * V;
      float acc = s_bonus[t] * s_v[t * V + c];
      for (int kk = 0; kk < K; ++kk) acc += s_r[t * K + kk] * s_state[kk * V + c];
      for (int s = 0; s < t; ++s) acc += s_qk[t * chunk + s] * s_v[s * V + c];
      yb[(c0 + t) * y_s + c] = from_f32<T>(acc);
    }
    __syncthreads();  // every y read S_0 before it is overwritten
    // 6. S_T = A_T (.) S_0 + (k~ A_T)^T V
    for (int i = tid; i < K * V; i += nthreads) {
      const int kk = i / V, c = i - kk * V;
      const float a = s_decay[kk];
      float acc = 0.f;
      for (int t = 0; t < chunk; ++t) acc += (s_k[t * KP + kk] * a) * s_v[t * V + c];
      s_state[i] = a * s_state[i] + acc;
    }
  }
  __syncthreads();
  float* so = state_out + (long long)bh * K * V;
  for (int i = tid; i < K * V; i += nthreads) so[i] = s_state[i];
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w and y); u and the state are
// f32.  strides: 12 element strides, r/k/v/w over b, then s, then h.
// Returns cudaGetLastError() after the launch (0 on success).
int wkv_chunked_fwd(int dtype, const void* r, const void* k, const void* v,
                    const void* w, const float* u, void* y, float* state,
                    int B, int S, int H, int K, int V, int chunk,
                    const long long* strides, void* stream) {
  if (K < 1 || K > kMaxK || V < 1 || V > kMaxV || chunk < 1 ||
      chunk > kMaxT || S % chunk != 0)
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 4; ++i) {
    st.b[i] = strides[i];
    st.s[i] = strides[4 + i];
    st.h[i] = strides[8 + i];
  }
  const dim3 grid(B * H), block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    wkv_chunked_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(r), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(w), u,
        static_cast<float*>(y), state, S, H, K, V, chunk, st);
  } else if (dtype == 1) {
    wkv_chunked_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(r), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(w), u,
        static_cast<__nv_bfloat16*>(y), state, S, H, K, V, chunk, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
