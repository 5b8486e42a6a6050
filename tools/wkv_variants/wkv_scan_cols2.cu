// A measured alternative to src/repro_torch/kernels/csrc/wkv_scan.cu, not
// shipped (tools/wkv_kernels.py builds and times it): two state columns a
// thread, so each shared float4 feeds 8 FMAs, and 128 threads a block.  It
// ran no faster on an H100 (PERF.md, §6).
//
// RWKV6 WKV as the exact token-by-token recurrence, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_wkv_kernel` / `wkv_scan`
// (src/repro/kernels/rwkv6_scan.py).  From a zero [K, V] f32 state S, for
// every token t of one (b, h):
//
//   y_t[j] = sum_k r_t[k] * (S[k][j] + u[k] * k_t[k] * v_t[j])
//          = sum_k r_t[k] * S[k][j] + beta_t * v_t[j],
//            beta_t = sum_k r_t[k] * u[k] * k_t[k]        (the bonus is rank one)
//   S[k][j] = w_t[k] * S[k][j] + k_t[k] * v_t[j]
//
// All arithmetic in f32; y is stored in the input type.  Unlike the chunk
// kernel (wkv_chunked.cu) nothing is reassociated across tokens and no decay
// is divided out: this is the recurrence itself, so any decay in (0, 1) and
// any chunk is safe.  Only the sum over k is split, four ways, in a fixed
// order, so two launches on the same inputs give the same bits.  No final
// state is written (the reference returns y only).
//
// What bounds it: at B=8, S=512, H=32, K=V=64 in bf16 a call moves
// 83,894,272 bytes (0.025 ms at 3.35 TB/s) and needs 5*K*V + 3*K + 2*V f32
// operations a token and head, 2.73 GFLOP (0.0407 ms at 67 TFLOP/s without
// tensor cores): operations bound it.
//
// Design:
// * Grid (B*H) x ceil(V / 64): a block owns 64 state columns of one head,
//   256 threads (256 blocks at the layer shape, about 2 an SM, 16 warps).
// * Warp w holds channel group g = w % 4 of 32 columns: each thread keeps
//   16 of its column's K state values in registers (channels in float4
//   units q = g + 4m).  Every shared float4 of r, k or w a warp reads is one
//   address for all 32 lanes (a broadcast).  A token's 4 partial sums
//   r . S[:, j] go to shared memory and meet when the stage's y is written,
//   a row of 64 columns at a time; nothing waits on them inside the
//   recurrence.
// * beta_t is computed once a token while a stage is converted (8 lanes a
//   token), not once a column; group 0 adds beta_t v_t[j] to its part.
// * Stages of 16 tokens of r, k, w and the block's v columns: one TMA load
//   of a 4-D tensor map over [B, S, H, K] (box [1, 16, 1, K]) an array,
//   issued by thread 0, into a ring of 2 raw stages on mbarriers, two
//   stages ahead of the recurrence, when every row is 16-byte aligned;
//   otherwise element loads into the same stages (any view whose last
//   dimension is contiguous is taken).  A stage is
//   converted once to f32 rows padded to 16 channels, 8 channels a thread.

#include <cuda.h>          // CUtensorMap and its enums; the encoder is reached
                           // through the runtime, so nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 64;
constexpr int kMaxV = 64;
constexpr int kG = 4;                    // channel groups: threads a state column
constexpr int kVb = 64;                  // state columns a block
constexpr int kCols = 2;                 // state columns a thread
constexpr int kThreads = kG * kVb / kCols;   // 256
constexpr int kQ = kMaxK / (4 * kG);     // float4s of a group's channels a row
constexpr int kStage = 16;               // tokens a stage
constexpr unsigned kFull = 0xffffffffu;
static_assert(kVb % (32 * kCols) == 0 && kVb <= 64,
              "a warp holds one group of 32 * kCols columns");
static_assert(kCols == 1 || kCols == 2, "one or two columns a thread");
static_assert(kMaxK == 64 && (kStage & (kStage - 1)) == 0, "8 groups of 8 channels");
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

// 8 consecutive elements of a raw row (16-byte aligned) in f32
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t wds[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(wds[i] << 16);
    o[2 * i + 1] = __uint_as_float(wds[i] & 0xffff0000u);
  }
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
constexpr int kProf = 7;
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

// The shared-memory plan of a block (bytes).  A raw stage holds kStage rows
// of r, k and w of pK elements (the tensor maps' box width: K rounded up to
// 8 channels, zero-filled) and kStage rows of kVb columns of v, each array
// on 128 bytes.
struct Layout {
  int pK, KP, raw_arr, raw_v, raw_stage;
  int off_r, off_k, off_w, off_v, off_beta, off_part, total;
  __host__ __device__ Layout(int K, int isz) {
    pK = (K + 7) / 8 * 8;
    raw_arr = (kStage * pK * isz + 127) / 128 * 128;
    raw_v = (kStage * kVb * isz + 127) / 128 * 128;
    raw_stage = 3 * raw_arr + raw_v;               // r, k, w, v
    KP = (K + 4 * kG - 1) / (4 * kG) * (4 * kG);
    int o = 2 * raw_stage;
    off_r = o; o += kStage * KP * 4;               // r  [kStage][KP] f32
    off_k = o; o += kStage * KP * 4;               // k
    off_w = o; o += kStage * KP * 4;               // w
    off_v = o; o += kStage * kVb * 4;              // v  [kStage][kVb]
    off_beta = o; o += kStage * 4;                 // r . (u * k)
    off_part = o; o += kG * kStage * kVb * 4;      // r . S by group [g][t][col]
    total = o;
  }
};

// Stage tokens [s0, s0 + kStage) of r, k, w and this block's v columns into
// one raw stage: one tensor-map box an array, issued by thread 0 and
// completing on `bar`, if vec; element copies of tokens [s0, s0 + n) by
// every thread otherwise.
template <typename T>
__device__ __forceinline__ void load_stage(
    unsigned char* raw, uint64_t* bar, const Maps& maps, const T* rb,
    const T* kb, const T* wb, const T* vb, const Strides& st, int b, int h,
    int v0, int s0, int n, int K, int vcols, const Layout& L, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    if (tid != 0) return;
    mbar_expect_tx(bar, (uint32_t)(kStage * (3 * L.pK + kVb) * sizeof(T)));
    for (int a = 0; a < 3; ++a)
      tma_load_4d(raw + a * L.raw_arr, &maps.m[a], bar, 0, s0, h, b);
    tma_load_4d(raw + 3 * L.raw_arr, &maps.m[3], bar, v0, s0, h, b);
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
    const long long s = s0 + t;
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

// y of tokens [s0, s0 + n): the sum of the 4 groups' parts, 4 columns a
// thread
template <typename T>
__device__ __forceinline__ void write_y(T* yb, long long y_s, const float* s_part,
                                        int s0, int n, int vcols, bool vec4) {
  for (int e = threadIdx.x; e < kStage * (kVb / 4); e += kThreads) {
    const int t = e / (kVb / 4), c = 4 * (e - t * (kVb / 4));
    if (t >= n || c >= vcols) continue;
    float4 acc = reinterpret_cast<const float4*>(s_part + t * kVb + c)[0];
#pragma unroll
    for (int g = 1; g < kG; ++g) {
      const float4 x = reinterpret_cast<const float4*>(s_part + (g * kStage + t) * kVb + c)[0];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    T* dst = yb + (s0 + t) * y_s + c;
    const float a[4] = {acc.x, acc.y, acc.z, acc.w};
    if (vec4 && c + 4 <= vcols) {
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(dst) = acc;
      } else {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
        uint2 pk;
        pk.x = *reinterpret_cast<const uint32_t*>(&lo);
        pk.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(dst) = pk;
      }
    } else {
      for (int i = 0; i < 4 && c + i < vcols; ++i) dst[i] = from_f32<T>(a[i]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const float* __restrict__ u, T* __restrict__ y,
                int S, int H, int K, int V, Strides st,
                const __grid_constant__ Maps maps, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t s_full[2];
  const Layout L(K, (int)sizeof(T));
  float* s_r = reinterpret_cast<float*>(smem + L.off_r);
  float* s_k = reinterpret_cast<float*>(smem + L.off_k);
  float* s_w = reinterpret_cast<float*>(smem + L.off_w);
  float* s_v = reinterpret_cast<float*>(smem + L.off_v);
  float* s_beta = reinterpret_cast<float*>(smem + L.off_beta);
  float* s_part = reinterpret_cast<float*>(smem + L.off_part);
  const int pK = L.pK, KP = L.KP;
  const int nq = KP / (4 * kG);               // float4s a group a row, 1..kQ

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int v0 = blockIdx.y * kVb;
  const int vcols = min(kVb, V - v0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = warp % kG;                    // this warp's channel group
  // this thread's first column in the block; it holds col .. col + kCols - 1
  const int col = (warp / kG) * 32 * kCols + lane * kCols;

  const T* rb = r + b * st.b[0] + h * st.h[0];
  const T* kb = k + b * st.b[1] + h * st.h[1];
  const T* vb = v + b * st.b[2] + h * st.h[2] + v0;
  const T* wb = w + b * st.b[3] + h * st.h[3];
  T* yb = y + ((long long)b * S * H + h) * V + v0;   // y is [B, S, H, V] contiguous
  const long long y_s = (long long)H * V;
  const bool vec4 = (V % 4) == 0;             // y rows of 4 columns aligned
  // conversion: thread e handles token (e / 8) % kStage, channels / columns
  // 8 (e % 8) .. + 8 of r and k (first half) or w and v (second half)
  const int grp = tid & 7;
  float ug[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    ug[i] = 8 * grp + i < K ? u[(long long)h * K + 8 * grp + i] : 0.f;

  if (tid == 0) {
    mbar_init(&s_full[0], 1);
    mbar_init(&s_full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int nst = (S + kStage - 1) / kStage;
  unsigned char* const raw0 = smem;
  unsigned char* const raw1 = smem + L.raw_stage;
  load_stage<T>(raw0, &s_full[0], maps, rb, kb, wb, vb, st, b, h, v0, 0,
                min(kStage, S), K, vcols, L, vec);
  if (nst > 1)
    load_stage<T>(raw1, &s_full[1], maps, rb, kb, wb, vb, st, b, h, v0, kStage,
                  min(kStage, S - kStage), K, vcols, L, vec);

  float S_[kCols][kQ][4];                     // S[4 (g + kG m) + e][v0 + col + i]
#pragma unroll
  for (int i = 0; i < kCols; ++i)
#pragma unroll
    for (int m = 0; m < kQ; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) S_[i][m][e] = 0.f;

  PROF_DECL
  for (int i = 0; i < nst; ++i) {
    const int s0 = i * kStage, n = min(kStage, S - s0);
    unsigned char* const cur = (i & 1) ? raw1 : raw0;
    const T* cr = reinterpret_cast<const T*>(cur);
    const T* ck = reinterpret_cast<const T*>(cur + L.raw_arr);
    const T* cw = reinterpret_cast<const T*>(cur + 2 * L.raw_arr);
    const T* cv = reinterpret_cast<const T*>(cur + 3 * L.raw_arr);
    if (vec) mbar_wait(&s_full[i & 1], (i >> 1) & 1);
    PROF(0);
    __syncthreads();                          // B1: stage i is in; stage i-1 done
    PROF(1);
    // -- 1. y of the previous stage out; this stage to f32; beta ----------
    if (i > 0) write_y<T>(yb, y_s, s_part, s0 - kStage, kStage, vcols, vec4);
    for (int e = tid; e < 2 * kStage * 8; e += kThreads) {
      const int t = (e >> 3) & (kStage - 1), c = 8 * grp;
      const bool rk = e < kStage * 8;         // warp-uniform
      float a[8], z[8];
      if (rk) {
        load8(cr + t * pK + c, a);                        // r
        load8(ck + t * pK + c, z);                        // k
        float bp = 0.f;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (c + q >= K) a[q] = z[q] = 0.f;
          bp = fmaf(a[q] * ug[q], z[q], bp);
        }
        bp += __shfl_xor_sync(kFull, bp, 1);
        bp += __shfl_xor_sync(kFull, bp, 2);
        bp += __shfl_xor_sync(kFull, bp, 4);
        if (t < n && c < KP) {
          float4* dr4 = reinterpret_cast<float4*>(s_r + t * KP + c);
          float4* dk4 = reinterpret_cast<float4*>(s_k + t * KP + c);
          dr4[0] = make_float4(a[0], a[1], a[2], a[3]);
          dr4[1] = make_float4(a[4], a[5], a[6], a[7]);
          dk4[0] = make_float4(z[0], z[1], z[2], z[3]);
          dk4[1] = make_float4(z[4], z[5], z[6], z[7]);
          if (grp == 0) s_beta[t] = bp;
        }
      } else if (t < n) {
        if (c < KP) {
          load8(cw + t * pK + c, a);                      // w
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (c + q >= K) a[q] = 0.f;
          float4* dw4 = reinterpret_cast<float4*>(s_w + t * KP + c);
          dw4[0] = make_float4(a[0], a[1], a[2], a[3]);
          dw4[1] = make_float4(a[4], a[5], a[6], a[7]);
        }
        if (c < kVb) {
          load8(cv + t * kVb + c, z);                     // v
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (c + q >= vcols) z[q] = 0.f;
          float4* dv4 = reinterpret_cast<float4*>(s_v + t * kVb + c);
          dv4[0] = make_float4(z[0], z[1], z[2], z[3]);
          dv4[1] = make_float4(z[4], z[5], z[6], z[7]);
        }
      }
    }
    PROF(2);
    __syncthreads();                          // B2: f32 stage ready; raw free
    PROF(3);
    if (i + 2 < nst)
      load_stage<T>(cur, &s_full[i & 1], maps, rb, kb, wb, vb, st, b, h, v0,
                    s0 + 2 * kStage, min(kStage, S - s0 - 2 * kStage), K, vcols,
                    L, vec);
    PROF(4);
    // -- 2. the recurrence over the stage, token by token -----------------
    for (int t = 0; t < n; ++t) {
      float vj[kCols];
      if constexpr (kCols == 2) {
        const float2 v2 = *reinterpret_cast<const float2*>(s_v + t * kVb + col);
        vj[0] = v2.x;
        vj[kCols - 1] = v2.y;
      } else {
        vj[0] = s_v[t * kVb + col];
      }
      const float4* r4 = reinterpret_cast<const float4*>(s_r + t * KP);
      const float4* k4 = reinterpret_cast<const float4*>(s_k + t * KP);
      const float4* w4 = reinterpret_cast<const float4*>(s_w + t * KP);
      float a0[kCols], a1[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        a0[i] = g == 0 ? s_beta[t] * vj[i] : 0.f;
        a1[i] = 0.f;
      }
#pragma unroll
      for (int m = 0; m < kQ; ++m) {
        if (m < nq) {
          const int q = g + kG * m;
          const float4 rr = r4[q], kk = k4[q], ww = w4[q];
#pragma unroll
          for (int i = 0; i < kCols; ++i) {
            float* Sm = S_[i][m];
            a0[i] = fmaf(rr.x, Sm[0], a0[i]);
            a1[i] = fmaf(rr.y, Sm[1], a1[i]);
            a0[i] = fmaf(rr.z, Sm[2], a0[i]);
            a1[i] = fmaf(rr.w, Sm[3], a1[i]);
            Sm[0] = fmaf(ww.x, Sm[0], kk.x * vj[i]);
            Sm[1] = fmaf(ww.y, Sm[1], kk.y * vj[i]);
            Sm[2] = fmaf(ww.z, Sm[2], kk.z * vj[i]);
            Sm[3] = fmaf(ww.w, Sm[3], kk.w * vj[i]);
          }
        }
      }
      float* dst = s_part + (g * kStage + t) * kVb + col;
      if constexpr (kCols == 2)
        *reinterpret_cast<float2*>(dst) = make_float2(a0[0] + a1[0],
                                                      a0[kCols - 1] + a1[kCols - 1]);
      else
        dst[0] = a0[0] + a1[0];
    }
    PROF(5);
  }
  __syncthreads();
  write_y<T>(yb, y_s, s_part, (nst - 1) * kStage, S - (nst - 1) * kStage, vcols, vec4);
  PROF(6);
  PROF_END
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

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, void* y, int B, int S, int H, int K, int V,
           const Strides& st, cudaStream_t s) {
  const int isz = (int)sizeof(T);
  bool vec = (K * isz) % 16 == 0 && (V * isz) % 16 == 0 && aligned16(r) &&
             aligned16(k) && aligned16(v) && aligned16(w);
  const Layout L(K, isz);
  Maps maps = {};
  const void* base[4] = {r, k, w, v};
  const int ix[4] = {0, 1, 3, 2};                 // strides of r, k, w, v
  for (int a = 0; a < 4 && vec; ++a)
    vec = encode_map(&maps.m[a], base[a], isz, B, S, H, a < 3 ? K : V,
                     st.b[ix[a]], st.s[ix[a]], st.h[ix[a]], kStage,
                     a < 3 ? L.pK : kVb);
  // above 48 KB only by the attribute; set it for the largest K, once a
  // device
  constexpr int kMaxDevices = 64;
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices || !configured[dev]) {
    e = cudaFuncSetAttribute(wkv_scan_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Layout(kMaxK, isz).total);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) configured[dev] = true;
  }
  const dim3 grid(B * H, (V + kVb - 1) / kVb), block(kThreads);
  wkv_scan_kernel<T><<<grid, block, L.total, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u,
      static_cast<T*>(y), S, H, K, V, st, maps, vec ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w and y); u is f32 [H, K].
// chunk: the reference's block of tokens (S % chunk == 0); the kernel
// stages 16 tokens at a time whatever the chunk, which changes no result.
// strides: 12 element strides, r/k/v/w over b, then s, then h.
// Returns cudaGetLastError() after the launch (0 on success).
int wkv_scan_fwd(int dtype, const void* r, const void* k, const void* v,
                 const void* w, const float* u, void* y, int B, int S, int H,
                 int K, int V, int chunk, const long long* strides,
                 void* stream) {
  if (S < 1 || K < 1 || K > kMaxK || V < 1 || V > kMaxV || chunk < 1 ||
      S % chunk != 0)
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 4; ++i) {
    st.b[i] = strides[i];
    st.s[i] = strides[4 + i];
    st.h[i] = strides[8 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, y, B, S, H, K, V, st, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, y, B, S, H, K, V, st, s);
  return (int)cudaErrorInvalidValue;
}

#ifdef WKV_PROFILE
// Copies thread 0's cycles by phase (and the block count last) and zeroes them.
int wkv_scan_prof(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  const unsigned long long zero[kProf + 1] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
  return (int)e;
}
#endif

}  // extern "C"
