// The flash kernel's online softmax alone on the card, in cycles a call
// (tools/flash_schedules.py builds and runs it).  One block an SM of two
// warpgroups: warpgroup 0 runs `online_softmax` (or, in mode 4, 64
// exponentials and 64 FMAs: the special-function units' pace) on scores in
// registers; warpgroup 1 exits (modes 0 and 4), runs the softmax too (mode
// 1: two warps a scheduler), or keeps the tensor cores busy with the
// kernel's S = Q K^T (mode 2, operands in shared memory) or O += P V
// (mode 3, A in registers) on zeros.
#include "../src/repro_torch/kernels/csrc/flash_attention.cu"

namespace {

__device__ __forceinline__ void softmax_loop(int iters, int mode, float* out,
                                             long long* cyc) {
  float sc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j)
    sc[j] = (float)((threadIdx.x * 7 + j * 13) % 29) * 0.1f;
  Params p{};
  p.S = 1 << 30;
  p.scale_log2 = 0.127f;
  float m_a = kNegBig, m_b = kNegBig, l_a = 0.f, l_b = 0.f, al_a = 0.f,
        al_b = 0.f, acc = 0.f;
  const int t = threadIdx.x & 3;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    if (mode == 4) {
#pragma unroll
      for (int j = 0; j < 64; ++j) sc[j] = ex2(sc[j]);
    } else {
      online_softmax(sc, p, 0, 1 << 20, 1 << 20, (1 << 20) + 8, t, m_a, m_b,
                     l_a, l_b, al_a, al_b);
    }
    // the next call's scores depend on this one's (64 FMAs)
#pragma unroll
    for (int j = 0; j < 64; ++j) sc[j] = fmaf(sc[j], 0.5f, (float)it);
    acc += al_a + al_b;
  }
  const long long t1 = clock64();
  float s = acc + l_a + l_b;
#pragma unroll
  for (int j = 0; j < 64; ++j) s += sc[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}

__global__ void __launch_bounds__(256, 1)
softmax_bench(float* out, long long* cyc, int iters, int mode) {
  extern __shared__ unsigned char raw[];
  unsigned char* sm = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  for (int i = threadIdx.x; i < 96 * 1024 / 4; i += blockDim.x)
    reinterpret_cast<float*>(sm)[i] = 0.f;
  __syncthreads();
  if (threadIdx.x < 128 || mode == 1) {
    softmax_loop(iters, mode, out, cyc);
  } else if (mode == 2 || mode == 3) {
    float d[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) d[j] = 0.f;
    const uint32_t a[4] = {0u, 0u, 0u, 0u};
    const uint32_t base = smem_u32(sm);
    // a fixed count that outlasts warpgroup 0's loop (a flag read by each
    // warp on its own would let a partial warpgroup issue wgmma)
    for (int rep = 0; rep < 4 * iters; ++rep) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (mode == 2)
          wgmma_ss_n128(d, sw128_desc(base + (kk / 4) * 16384 + (kk % 4) * 32, 16, 1024),
                        sw128_desc(base + 32768 + (kk / 4) * 16384 + (kk % 4) * 32, 16, 1024),
                        1);
        else
          wgmma_rs_n128(d, a, sw128_desc(base + 65536 + kk * 2048, 16384, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(d);
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 64; ++j) s += d[j];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  }
}

}  // namespace

// mode as above; cyc[b] gets block b's cycles for `iters` calls.  Launches
// one block on each of `blocks` SMs (120 KB of shared memory keeps them
// apart) and returns the CUDA error of the launch.
extern "C" int run_softmax_bench(float* out, long long* cyc, int blocks,
                                 int iters, int mode) {
  const int smem = 120 * 1024;
  cudaError_t err = cudaFuncSetAttribute(
      softmax_bench, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  softmax_bench<<<blocks, 256, smem>>>(out, cyc, iters, mode);
  return (int)cudaGetLastError();
}
