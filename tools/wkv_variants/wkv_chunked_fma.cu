// A measured alternative to src/repro_torch/kernels/csrc/wkv_chunked.cu, not
// shipped (tools/wkv_kernels.py builds and times it): the same staging and
// decays with every product on the CUDA cores in f32, the state in
// registers over four channel groups a column.  The tensor-core kernel ran
// faster on an H100 in both dtypes (PERF.md, §6).
//
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
// All arithmetic in f32 on the CUDA cores; y is stored in the input type,
// the final state [B, H, K, V] in f32 (the TPU kernel kept it in VMEM
// scratch and dropped it).
//
// What bounds it: at B=8, S=512, H=32, K=V=64, T=16 in bf16 a call moves
// 88,088,576 bytes (0.0263 ms at 3.35 TB/s) and needs 2.56 GFLOP of f32
// arithmetic (0.0382 ms at 67 TFLOP/s): operations, on the CUDA cores.
// The one serial dependency is the state, from chunk to chunk; everything
// else in a chunk (decays, r~, k~, r~ k~^T, the bonus) is independent of it.
//
// Design:
// * Grid (B*H) x ceil(V / 64): a block owns 64 state columns of one head,
//   256 threads (256 blocks at the layer shape, about 2 an SM, 16 warps).
// * Warp w holds channel group g = w % 4 of 32 columns: each thread keeps
//   16 of its column's K state values in registers (channels in float4
//   units q = g + 4m).  r~ S_0 and (k~ A_T)^T V run from those registers;
//   every shared float4 of r~ or k~ A_T a warp reads is one address for all
//   32 lanes (a broadcast) and feeds 4 FMAs in each.  The 4 groups' partial
//   r~ S_0 meet in shared memory, summed by the thread that writes y.
// * The decays run on every thread: lanes are tokens, log2 w is scanned
//   along them with shuffles (width T rounded up to a power of two) and
//   r~, k~, k~ A_T and A_T come from one exp2 each.  w is staged with r, k
//   and v.
// * The next chunks' r, k, w and v are in flight while this one computes:
//   one TMA load of a 4-D tensor map over [B, S, H, K] (box [1, T, 1, K])
//   an array, issued by thread 0, into a ring of 2 raw stages on
//   mbarriers, when every row is 16-byte aligned; otherwise the same
//   stages are filled by element loads (any view whose last dimension is
//   contiguous is taken).
// * Three barriers a chunk (stage in and the last chunk's y done, decays
//   ready, r~ k~^T and the partial sums ready); y leaves a row of 32
//   columns a warp at a time.
// Decays are divided out over one chunk only (T <= 32), as before.

#include <cuda.h>          // CUtensorMap and its enums; the encoder is reached
                           // through the runtime, so nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 64;
constexpr int kMaxV = 64;
constexpr int kMaxT = 32;
constexpr int kG = 4;                    // channel groups: threads a state column
constexpr int kVb = 64;                  // state columns a block
constexpr int kThreads = kG * kVb;       // 256
constexpr int kWarps = kThreads / 32;
constexpr int kQ = kMaxK / (4 * kG);     // float4s of a group's channels a row
constexpr unsigned kFull = 0xffffffffu;
static_assert(kVb % 32 == 0, "a warp holds one group of 32 columns");
static_assert(kG == 4 || kG == 8, "channel groups of 16 or 8 state values");

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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
// trap after about ten seconds then, rather than hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - t0 > 20000000000LL) __trap();
}

// one box of a 4-D tensor map into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// r, k, w and v: [B, S, H, K] (v [B, S, H, V]) as 4-D tensor maps
struct Maps {
  CUtensorMap m[4];
};

#ifdef WKV_PROFILE
// clock64 phases of thread 0, summed over blocks (tools/wkv_kernels.py)
constexpr int kProf = 10;
__device__ unsigned long long g_prof[kProf + 1];
#define PROF_DECL                 \
  long long prof_t = clock64();   \
  long long prof_acc[kProf] = {};
#define PROF(i)                                   \
  do {                                            \
    if (threadIdx.x == 0) {                       \
      const long long n_ = clock64();             \
      prof_acc[i] += n_ - prof_t;                 \
      prof_t = n_;                                \
    }                                             \
  } while (0)
#define PROF_END                                                         \
  if (threadIdx.x == 0) {                                                \
    for (int i_ = 0; i_ < kProf; ++i_)                                   \
      atomicAdd(&g_prof[i_], (unsigned long long)prof_acc[i_]);          \
    atomicAdd(&g_prof[kProf], 1ull);                                     \
  }
#else
#define PROF_DECL
#define PROF(i)
#define PROF_END
#endif

// The shared-memory plan of a block, for chunks of up to TT tokens (bytes).
// A raw stage holds TT rows of r, k and w of pK elements (the tensor maps'
// box width: K, 16-byte rows, and 16 bytes more that skew the rows across
// banks, zero-filled) and TT rows of kVb columns of v, each array on 128
// bytes.
template <int TT>
struct Layout {
  int pK, KP, pF, pQ;
  int raw_arr, raw_v, raw_stage;
  int off_rt, off_kt, off_ka, off_at, off_v, off_qk, off_beta, off_part, total;
  __host__ __device__ Layout(int K, int isz) {
    const int per16 = 16 / isz;
    pK = (K + per16 - 1) / per16 * per16 + per16;
    raw_arr = (TT * pK * isz + 127) / 128 * 128;
    raw_v = (TT * kVb * isz + 127) / 128 * 128;
    raw_stage = 3 * raw_arr + raw_v;               // r, k, w, v
    KP = (K + 4 * kG - 1) / (4 * kG) * (4 * kG);
    pF = KP + 4;
    pQ = TT + 4;
    int o = 2 * raw_stage;
    off_rt = o; o += TT * pF * 4;                  // r~      [TT][pF]
    off_kt = o; o += TT * pF * 4;                  // k~      [TT][pF]
    off_ka = o; o += TT * pF * 4;                  // k~ A_T  [TT][pF]
    off_at = o; o += KP * 4;                       // A_T     [KP]
    off_v = o; o += TT * kVb * 4;                  // v       [TT][kVb]
    off_qk = o; o += TT * pQ * 4;                  // (r~ k~^T)^T, strict [s][t]
    off_beta = o; o += TT * 4;                     // r . (u * k)
    off_part = o; o += kG * TT * kVb * 4;          // r~ S_0 by group [g][t][col]
    total = o;
  }
};

// Stage tokens [c0, c0 + TT) of r, k, w and this block's v columns into one
// raw stage: one tensor-map box an array, issued by thread 0 and completing
// on `bar`, if vec; element copies of tokens [c0, c0 + n) by every thread
// otherwise.
template <typename T, int TT>
__device__ __forceinline__ void load_stage(
    unsigned char* raw, uint64_t* bar, const Maps& maps, const T* rb,
    const T* kb, const T* wb, const T* vb, const Strides& st, int b, int h,
    int v0, int c0, int n, int K, int vcols, const Layout<TT>& L, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    if (tid != 0) return;
    mbar_expect_tx(bar, (uint32_t)(TT * (3 * L.pK + kVb) * sizeof(T)));
    for (int a = 0; a < 3; ++a)
      tma_load_4d(raw + a * L.raw_arr, &maps.m[a], bar, 0, c0, h, b);
    tma_load_4d(raw + 3 * L.raw_arr, &maps.m[3], bar, v0, c0, h, b);
    return;
  }
  T* dr = reinterpret_cast<T*>(raw);
  T* dk = reinterpret_cast<T*>(raw + L.raw_arr);
  T* dw = reinterpret_cast<T*>(raw + 2 * L.raw_arr);
  T* dv = reinterpret_cast<T*>(raw + 3 * L.raw_arr);
  const int pK = L.pK, row = 3 * K + vcols;
  for (int i = tid; i < n * row; i += kThreads) {
    const int t = i / row;
    int c = i - t * row;
    const long long s = c0 + t;
    if (c < K) {
      dr[t * pK + c] = rb[s * st.s[0] + c];
    } else if (c < 2 * K) {
      c -= K;
      dk[t * pK + c] = kb[s * st.s[1] + c];
    } else if (c < 3 * K) {
      c -= 2 * K;
      dw[t * pK + c] = wb[s * st.s[3] + c];
    } else {
      c -= 3 * K;
      dv[t * kVb + c] = vb[s * st.s[2] + c];
    }
  }
}

template <typename T, int TT>
__global__ void __launch_bounds__(kThreads)
wkv_chunked_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ w,
                   const float* __restrict__ u, T* __restrict__ y,
                   float* __restrict__ state_out, int S, int H, int K, int V,
                   int chunk, Strides st, const __grid_constant__ Maps maps,
                   int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t s_full[2];
  const Layout<TT> L(K, (int)sizeof(T));
  float* s_rt = reinterpret_cast<float*>(smem + L.off_rt);
  float* s_kt = reinterpret_cast<float*>(smem + L.off_kt);
  float* s_ka = reinterpret_cast<float*>(smem + L.off_ka);
  float* s_at = reinterpret_cast<float*>(smem + L.off_at);
  float* s_v = reinterpret_cast<float*>(smem + L.off_v);
  float* s_qk = reinterpret_cast<float*>(smem + L.off_qk);
  float* s_beta = reinterpret_cast<float*>(smem + L.off_beta);
  float* s_part = reinterpret_cast<float*>(smem + L.off_part);
  const int pK = L.pK, KP = L.KP, pF = L.pF, pQ = L.pQ;
  const int nq = KP / (4 * kG);               // float4s a group a row, 1..kQ

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int v0 = blockIdx.y * kVb;
  const int vcols = min(kVb, V - v0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = warp % kG;                    // this warp's channel group
  const int col = (warp / kG) * 32 + lane;    // this thread's column in the block
  const int j = v0 + col;

  const T* rb = r + b * st.b[0] + h * st.h[0];
  const T* kb = k + b * st.b[1] + h * st.h[1];
  const T* vb = v + b * st.b[2] + h * st.h[2] + v0;
  const T* wb = w + b * st.b[3] + h * st.h[3];
  T* yb = y + ((long long)b * S * H + h) * V;     // y is [B, S, H, V] contiguous
  const long long y_s = (long long)H * V;
  const float u0 = lane < K ? u[(long long)h * K + lane] : 0.f;
  const float u1 = lane + 32 < K ? u[(long long)h * K + lane + 32] : 0.f;

  if (tid == 0) {
    mbar_init(&s_full[0], 1);
    mbar_init(&s_full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int nch = S / chunk;
  unsigned char* const raw0 = smem;
  unsigned char* const raw1 = smem + L.raw_stage;
  load_stage<T, TT>(raw0, &s_full[0], maps, rb, kb, wb, vb, st, b, h, v0, 0,
                    chunk, K, vcols, L, vec);
  if (nch > 1)
    load_stage<T, TT>(raw1, &s_full[1], maps, rb, kb, wb, vb, st, b, h, v0,
                      chunk, chunk, K, vcols, L, vec);

  float S_[kQ][4];                            // S[4 (g + kG m) + e][j]
#pragma unroll
  for (int m = 0; m < kQ; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) S_[m][e] = 0.f;

  PROF_DECL
  for (int c = 0; c < nch; ++c) {
    const int c0 = c * chunk;
    unsigned char* const cur = (c & 1) ? raw1 : raw0;
    if (vec) mbar_wait(&s_full[c & 1], (c >> 1) & 1);
    PROF(0);
    __syncthreads();                          // B1: stage c is in; chunk c-1 done
    PROF(1);
    // -- 1. decays, r~, k~, k~ A_T, A_T; v in f32; the bonus -------------
    {
      const T* cr = reinterpret_cast<const T*>(cur);
      const T* ck = reinterpret_cast<const T*>(cur + L.raw_arr);
      const T* cw = reinterpret_cast<const T*>(cur + 2 * L.raw_arr);
      const T* cv = reinterpret_cast<const T*>(cur + 3 * L.raw_arr);
      constexpr int segs = 32 / TT;           // channels a warp a round
      const int tl = lane % TT, seg = lane / TT;
      for (int k0 = warp * segs; k0 < KP; k0 += kWarps * segs) {
        const int kk = k0 + seg;
        const bool real = tl < chunk && kk < K;
        const float wv = real ? to_f32(cw[tl * pK + kk]) : 1.f;
        const float rv = real ? to_f32(cr[tl * pK + kk]) : 0.f;
        const float kv = real ? to_f32(ck[tl * pK + kk]) : 0.f;
        const float lw = lg2(wv);
        float la = lw;                        // log2 A_t, inclusive scan
#pragma unroll
        for (int off = 1; off < TT; off <<= 1) {
          const float o = __shfl_up_sync(kFull, la, off, TT);
          if (tl >= off) la += o;
        }
        const float laT = __shfl_sync(kFull, la, TT - 1, TT);
        s_rt[tl * pF + kk] = rv * ex2(la - lw);
        s_kt[tl * pF + kk] = kv * ex2(-la);
        s_ka[tl * pF + kk] = kv * ex2(laT - la);
        if (tl == 0) s_at[kk] = ex2(laT);
      }
      for (int i = tid; i < TT * kVb; i += kThreads) {
        const int t = i / kVb, cc = i - t * kVb;
        s_v[i] = (t < chunk && cc < vcols) ? to_f32(cv[t * kVb + cc]) : 0.f;
      }
      for (int t = warp; t < TT; t += kWarps) {
        float acc = 0.f;
        if (t < chunk) {
          if (lane < K)
            acc = to_f32(cr[t * pK + lane]) * u0 * to_f32(ck[t * pK + lane]);
          if (lane + 32 < K)
            acc = fmaf(to_f32(cr[t * pK + lane + 32]) * u1,
                       to_f32(ck[t * pK + lane + 32]), acc);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
        if (lane == 0) s_beta[t] = acc;
      }
    }
    PROF(2);
    __syncthreads();                          // B2: decays ready; stage c free
    PROF(3);
    if (c + 2 < nch)
      load_stage<T, TT>(cur, &s_full[c & 1], maps, rb, kb, wb, vb, st, b, h, v0,
                        c0 + 2 * chunk, chunk, K, vcols, L, vec);
    PROF(4);
    // -- 2. strict-lower r~ k~^T, stored transposed [s][t] ----------------
    for (int p = tid; p < TT * TT; p += kThreads) {
      const int s = p / TT, t = p - s * TT;
      if (!(s < t && t < chunk)) s_qk[s * pQ + t] = 0.f;
    }
    const int npairs = chunk * (chunk - 1) / 2;
    for (int p = tid; p < npairs; p += kThreads) {
      int t = (int)((1.f + sqrtf(1.f + 8.f * (float)p)) * 0.5f);
      while (t * (t - 1) / 2 > p) --t;
      while ((t + 1) * t / 2 <= p) ++t;
      const int s = p - t * (t - 1) / 2;
      const float4* a4 = reinterpret_cast<const float4*>(s_rt + t * pF);
      const float4* b4 = reinterpret_cast<const float4*>(s_kt + s * pF);
      float acc0 = 0.f, acc1 = 0.f;
      for (int q = 0; q < KP / 4; ++q) {
        const float4 x = a4[q], z = b4[q];
        acc0 = fmaf(x.x, z.x, acc0);
        acc1 = fmaf(x.y, z.y, acc1);
        acc0 = fmaf(x.z, z.z, acc0);
        acc1 = fmaf(x.w, z.w, acc1);
      }
      s_qk[s * pQ + t] = acc0 + acc1;
    }
    PROF(5);
    // -- 3. this group's share of r~ S_0, from the registers --------------
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      if (t < chunk) {
        const float4* x4 = reinterpret_cast<const float4*>(s_rt + t * pF);
        float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
        for (int m = 0; m < kQ; ++m) {
          if (m < nq) {
            const float4 x = x4[g + kG * m];
            acc0 = fmaf(x.x, S_[m][0], acc0);
            acc1 = fmaf(x.y, S_[m][1], acc1);
            acc0 = fmaf(x.z, S_[m][2], acc0);
            acc1 = fmaf(x.w, S_[m][3], acc1);
          }
        }
        s_part[(g * TT + t) * kVb + col] = acc0 + acc1;
      }
    }
    PROF(6);
    // -- 4. S_T = A_T (.) S_0 + (k~ A_T)^T V, in the registers ------------
#pragma unroll
    for (int m = 0; m < kQ; ++m) {
      if (m < nq) {
        const float4 a = reinterpret_cast<const float4*>(s_at)[g + kG * m];
        S_[m][0] *= a.x;
        S_[m][1] *= a.y;
        S_[m][2] *= a.z;
        S_[m][3] *= a.w;
      }
    }
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      if (t < chunk) {
        const float vv = s_v[t * kVb + col];
        const float4* x4 = reinterpret_cast<const float4*>(s_ka + t * pF);
#pragma unroll
        for (int m = 0; m < kQ; ++m) {
          if (m < nq) {
            const float4 x = x4[g + kG * m];
            S_[m][0] = fmaf(x.x, vv, S_[m][0]);
            S_[m][1] = fmaf(x.y, vv, S_[m][1]);
            S_[m][2] = fmaf(x.z, vv, S_[m][2]);
            S_[m][3] = fmaf(x.w, vv, S_[m][3]);
          }
        }
      }
    }
    PROF(7);
    __syncthreads();                          // B3: r~ k~^T and the parts ready
    PROF(8);
    // -- 5. y_t = r~_t S_0 + sum_{s<t} qk[t][s] v_s + beta_t v_t ----------
    // this thread's tokens t0 .. t0 + TQ - 1 of column j
    constexpr int TQ = TT / kG;
    const int t0 = g * TQ;
    float yo[TQ];
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int t = t0 + i;
      float acc = 0.f;
#pragma unroll
      for (int gg = 0; gg < kG; ++gg) acc += s_part[(gg * TT + t) * kVb + col];
      yo[i] = fmaf(s_beta[t], s_v[t * kVb + col], acc);
    }
#pragma unroll
    for (int s = 0; s < TT; ++s) {
      if (s < chunk) {
        const float vs = s_v[s * kVb + col];
        const float* qrow = s_qk + s * pQ + t0;
        if constexpr (TQ % 2 == 0) {
#pragma unroll
          for (int i = 0; i < TQ; i += 2) {
            const float2 x = *reinterpret_cast<const float2*>(qrow + i);
            yo[i] = fmaf(x.x, vs, yo[i]);
            yo[i + 1] = fmaf(x.y, vs, yo[i + 1]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < TQ; ++i) yo[i] = fmaf(qrow[i], vs, yo[i]);
        }
      }
    }
    if (j < V) {
#pragma unroll
      for (int i = 0; i < TQ; ++i)
        if (t0 + i < chunk) yb[(c0 + t0 + i) * y_s + j] = from_f32<T>(yo[i]);
    }
    PROF(9);
  }
  PROF_END
  if (j < V) {
    float* so = state_out + (long long)bh * K * V;
#pragma unroll
    for (int m = 0; m < kQ; ++m) {
      if (m < nq) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = 4 * (g + kG * m) + e;
          if (kk < K) so[(long long)kk * V + j] = S_[m][e];
        }
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// cuTensorMapEncodeTiled, a driver function, through the runtime's entry
// point query (its 12.0 ABI), so the build links no libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      cached = reinterpret_cast<EncodeTiled>(ptr);
  }
  return cached;
}

// The map of one [B, S, H, width] operand (element strides st over b, s
// and h; a dimension of extent 1 is never stepped and gets a packed
// stride), boxes of `rows` tokens x `box` elements (past `width` filled
// with zeros).  False if the map cannot be made.
bool encode_map(CUtensorMap* map, const void* base, int isz, int B, int S,
                int H, int width, long long sb, long long ss, long long sh,
                int rows, int box) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const long long step[3] = {B > 1 ? sb : (long long)S * H * width,
                             S > 1 ? ss : (long long)H * width,
                             H > 1 ? sh : (long long)width};
  for (long long x : step)
    if (x <= 0 || (x * isz) % 16 != 0) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(step[1] * isz),
                                 (cuuint64_t)(step[2] * isz),
                                 (cuuint64_t)(step[0] * isz)};
  const cuuint32_t boxd[4] = {(cuuint32_t)box, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map,
                isz == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4, const_cast<void*>(base), dims, strides, boxd, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int TT>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, void* y, float* state, int B, int S, int H, int K,
           int V, int chunk, const Strides& st, cudaStream_t s) {
  const int isz = (int)sizeof(T);
  bool vec = (K * isz) % 16 == 0 && (V * isz) % 16 == 0 && aligned16(r) &&
             aligned16(k) && aligned16(v) && aligned16(w);
  const Layout<TT> L(K, isz);
  Maps maps = {};
  const void* base[4] = {r, k, w, v};
  const int ix[4] = {0, 1, 3, 2};                 // strides of r, k, w, v
  for (int a = 0; a < 4 && vec; ++a)
    vec = encode_map(&maps.m[a], base[a], isz, B, S, H, a < 3 ? K : V,
                     st.b[ix[a]], st.s[ix[a]], st.h[ix[a]], TT,
                     a < 3 ? L.pK : kVb);
  const size_t smem = L.total;
  // above 48 KB only by the attribute; set it for the largest K, once a
  // device
  constexpr int kMaxDevices = 64;
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices || !configured[dev]) {
    e = cudaFuncSetAttribute(wkv_chunked_kernel<T, TT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Layout<TT>(kMaxK, isz).total);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) configured[dev] = true;
  }
  const dim3 grid(B * H, (V + kVb - 1) / kVb), block(kThreads);
  wkv_chunked_kernel<T, TT><<<grid, block, smem, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), u, static_cast<T*>(y), state, S, H, K, V, chunk,
      st, maps, vec ? 1 : 0);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const void* r, const void* k, const void* v, const void* w,
             const float* u, void* y, float* state, int B, int S, int H, int K,
             int V, int chunk, const Strides& st, cudaStream_t s) {
  if (chunk <= 8) return launch<T, 8>(r, k, v, w, u, y, state, B, S, H, K, V, chunk, st, s);
  if (chunk <= 16) return launch<T, 16>(r, k, v, w, u, y, state, B, S, H, K, V, chunk, st, s);
  return launch<T, 32>(r, k, v, w, u, y, state, B, S, H, K, V, chunk, st, s);
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
  if (S < 1 || K < 1 || K > kMaxK || V < 1 || V > kMaxV || chunk < 1 ||
      chunk > kMaxT || S % chunk != 0)
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 4; ++i) {
    st.b[i] = strides[i];
    st.s[i] = strides[4 + i];
    st.h[i] = strides[8 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(r, k, v, w, u, y, state, B, S, H, K, V, chunk, st, s);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(r, k, v, w, u, y, state, B, S, H, K, V, chunk, st, s);
  return (int)cudaErrorInvalidValue;
}

#ifdef WKV_PROFILE
// Copies thread 0's cycles by phase (and the block count last) and zeroes them.
int wkv_chunked_prof(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  const unsigned long long zero[kProf + 1] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
  return (int)e;
}
#endif

}  // extern "C"
