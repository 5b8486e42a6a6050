// Flash attention forward (causal / full / sliding window, GQA) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention`
// (src/repro/kernels/flash_attention.py).  It computes the same function:
// for query row i and key j of one (batch row, head),
//     s_ij = (q_i . k_j) * sm_scale,  masked to -1e30 outside the band
//     o_i  = sum_j softmax_j(s_ij) v_j
// with the softmax taken online over key tiles (running max m, denominator
// l and accumulator in f32), query head h reading kv head h / group, and
// rows with l == 0 giving 0.  The TPU grid walks key blocks in order on one
// core with m/l/acc in VMEM scratch; here one thread block owns a tile of
// query rows of one (head, batch row) and loops over its key tiles, staging
// K and V through shared memory, with m/l/acc in registers.
//
// Masking keeps the reference's -1e30 (never -inf).  Whenever `causal` or
// `window` is set, every row's diagonal key is valid, so a key tile that
// lies wholly outside the causal/window band of every row of the block
// contributes exp(-1e30 - m) = 0 once a valid key has been seen, and before
// that its contribution is wiped by the rescale alpha = exp(-1e30 - m) = 0:
// skipping such tiles computes the same function, bit for bit in the
// arithmetic that remains.  Keys past S (the ragged tail of the last tile)
// are masked the same way and their shared-memory rows are zero-filled, so
// any sequence length is taken.
//
// Two kernels:
//  * flash_fwd_mma: bf16 q/k/v with a head width that is a multiple of 16.
//    4 warps x 16 query rows; scores and P.V on the tensor cores with
//    mma.sync.m16n8k16 (bf16 operands, f32 accumulate).  P is rounded to
//    bf16 for the P.V product (the reference keeps it in f32: one bf16
//    rounding of each probability, inside the stated tolerance).  K/V tiles
//    arrive by cp.async, double-buffered, so the next tile's loads overlap
//    this tile's products.
//  * flash_fwd_fma: f32 inputs (and bf16 at head width 8).  32 query rows,
//    4 threads a row; every product in f32 FMA from shared memory, as the
//    reference computes it.
//
// What bounds it: at the dense serving prefill (glm4-9b, B=8, H=32, KV=2,
// S=2048, hd=128, causal, bf16) a call does 2.75e11 FLOP against 285 MB, so
// it is bound by the tensor cores (0.28 ms at 989 TFLOP/s), not by HBM.
// This version issues mma.sync (Hopper's wgmma and TMA are what reach the
// full rate, later work) with every fragment loaded by ldmatrix, reads each
// K/V tile once per 64 query rows, and runs the heaviest causal query tiles
// first so the tail of the grid is short.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegBig = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;                  // [B, H, S, HD] contiguous
  long long sq[3], sk[3], sv[3];  // strides (elements) of batch, head, seq
  int H, S, group, causal, window;
  float scale_log2;         // sm_scale * log2(e): exp(x) = exp2(x * log2 e)
};

__device__ __forceinline__ bool valid_key(int qp, int kp, const Params& p) {
  if (kp >= p.S) return false;
  const int rel = qp - kp;
  if (p.causal && rel < 0) return false;
  if (p.window && rel >= p.window) return false;
  return true;
}

// The key tiles [lo, hi) that hold a valid key for some row of
// [q0, q0 + bq): tiles wholly outside the band are skipped (see above).
__device__ __forceinline__ void key_tiles(const Params& p, int q0, int bq,
                                          int bk, int* lo, int* hi) {
  const int n = (p.S + bk - 1) / bk;
  *hi = n;
  if (p.causal) {
    const int last = min(q0 + bq - 1, p.S - 1);
    *hi = last / bk + 1;
  }
  *lo = 0;
  if (p.window) {
    const int first = q0 - p.window + 1;  // smallest valid key of row q0
    if (first > 0) *lo = first / bk;
  }
}

// ---------------------------------------------------------------------------
// bf16, tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D += A (16x16 bf16, row) * B (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory (lanes 8i..8i+7 give the row
// addresses of matrix i): the A fragment of Q and the B fragments of K^T
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// The same, each matrix transposed on the way (the B operand of P.V from
// row-major V tiles)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
struct MmaTile {
  static constexpr int BQ = 64;                 // 4 warps x 16 rows
  // key tiles of 32 from head width 128 keep three blocks (12 warps) on
  // a SM, whose latency hiding is what this kernel lacks most
  static constexpr int BK = HD >= 128 ? 32 : 64;
  static constexpr int kMinBlocks = HD >= 256 ? 1 : 3;
  static constexpr int LD = HD + 8;             // padded row: no bank conflicts
  static constexpr int kSmem = (BQ + 4 * BK) * LD * 2;  // Q + 2 x (K, V)
};

// rows [row0, row0 + n) of a [S, HD] bf16 matrix into shared memory,
// 16 bytes a copy; rows past S are zero-filled
template <int HD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0, int n,
                                          int S) {
  constexpr int kChunks = HD / 8;
  constexpr int LD = MmaTile<HD>::LD;
  for (int i = threadIdx.x; i < n * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int gr = row0 + r;
    const __nv_bfloat16* s = src + (long long)min(gr, S - 1) * stride + c * 8;
    cp_async16(dst + r * LD + c * 8, s, gr < S ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, MmaTile<HD>::kMinBlocks)
flash_fwd_mma(const Params p) {
  using T = MmaTile<HD>;
  constexpr int BQ = T::BQ, BK = T::BK, LD = T::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;       // [2][BK][LD]
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;   // [2][BK][LD]

  const int n_qt = (p.S + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.group;
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.sk[0] + kvh * p.sk[1];
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.sv[0] + kvh * p.sv[1];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;

  int kt_lo, kt_hi;
  key_tiles(p, q0, BQ, BK, &kt_lo, &kt_hi);

  load_rows<HD>(Qs, qg, p.sq[2], q0, BQ, p.S);
  load_rows<HD>(Ks, kg, p.sk[2], kt_lo * BK, BK, p.S);
  load_rows<HD>(Vs, vg, p.sv[2], kt_lo * BK, BK, p.S);
  cp_async_commit();

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = kNegBig, m_b = kNegBig, l_a = 0.f, l_b = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int buf = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) {
      load_rows<HD>(Ks + (buf ^ 1) * BK * LD, kg, p.sk[2], (kt + 1) * BK, BK, p.S);
      load_rows<HD>(Vs + (buf ^ 1) * BK * LD, vg, p.sv[2], (kt + 1) * BK, BK, p.S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kb = Ks + buf * BK * LD;
    const __nv_bfloat16* Vb = Vs + buf * BK * LD;

    // S = Q K^T for this warp's 16 rows and the tile's BK keys
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    // ldmatrix row addresses: Q rows warp*16 + (lane % 16), column half
    // lane / 16 (a0..a3); K rows 8j + lane % 8 (+8 for lanes 16..31, the
    // next key tile), column half (lane / 8) % 2 (b0, b1 of two tiles)
    const __nv_bfloat16* qa = Qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
    const __nv_bfloat16* ka =
        Kb + ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, qa + kk * 16);
#pragma unroll
      for (int j = 0; j < BK / 8; j += 2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, ka + j * 8 * LD + kk * 16);
        mma_bf16(s[j], a, kb[0], kb[1]);
        mma_bf16(s[j + 1], a, kb[2], kb[3]);
      }
    }

    // scale, mask, online softmax; this thread holds rows row_a (s[.][0..1])
    // and row_b (s[.][2..3]), shared with the 3 other threads of its quad
    // the per-element mask only where the tile meets the band's edge or
    // the tail, for some row of this warp
    const int k0 = kt * BK, w0 = q0 + warp * 16;
    const bool edge = k0 + BK > p.S || (p.causal && k0 + BK - 1 > w0) ||
                      (p.window && w0 + 15 - k0 >= p.window);
    float mx_a = kNegBig, mx_b = kNegBig;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 2 * t + j * 8 + (e & 1);
        const int qp = e < 2 ? row_a : row_b;
        const float x = !edge || valid_key(qp, kp, p) ? s[j][e] * p.scale_log2
                                                      : kNegBig;
        s[j][e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x); else mx_b = fmaxf(mx_b, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mn_a);
      s[j][1] = exp2f(s[j][1] - mn_a);
      s[j][2] = exp2f(s[j][2] - mn_b);
      s[j][3] = exp2f(s[j][3] - mn_b);
      rs_a += s[j][0] + s[j][1];
      rs_b += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rs_a += __shfl_xor_sync(0xffffffffu, rs_a, off);
      rs_b += __shfl_xor_sync(0xffffffffu, rs_b, off);
    }
    l_a = l_a * al_a + rs_a;
    l_b = l_b * al_b + rs_b;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= al_a;
      o[n][1] *= al_a;
      o[n][2] *= al_b;
      o[n][3] *= al_b;
    }

    // O += P V: the score accumulators are the A fragments of P
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      a[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      a[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      a[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
      const int vrow = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int n = 0; n < HD / 8; n += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vb + vrow * LD + n * 8 + (lane >> 4) * 8);
        mma_bf16(o[n], a, bv[0], bv[1]);
        mma_bf16(o[n + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();   // this buffer is refilled two tiles on
  }

  const float sa = l_a == 0.f ? 1.f : l_a, sb = l_b == 0.f ? 1.f : l_b;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) +
                       ((long long)b * p.H + h) * p.S * HD;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (row_a < p.S)
      *reinterpret_cast<uint32_t*>(out + (long long)row_a * HD + col) =
          pack_bf16(o[n][0] / sa, o[n][1] / sa);
    if (row_b < p.S)
      *reinterpret_cast<uint32_t*>(out + (long long)row_b * HD + col) =
          pack_bf16(o[n][2] / sb, o[n][3] / sb);
  }
}

// ---------------------------------------------------------------------------
// f32 FMA (f32 inputs; bf16 at head width 8)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

template <int HD>
struct FmaTile {
  static constexpr int BQ = 32;   // 4 threads a row
  static constexpr int BK = 32;
  static constexpr int LD = HD + 1;  // odd row stride: no bank conflicts
  static constexpr int kSmem = (BQ * LD + 2 * BK * LD + BQ * (BK + 1)) * 4;
};

template <typename E, int HD>
__device__ __forceinline__ void load_rows_f32(float* dst, const E* src,
                                              long long stride, int row0,
                                              int n, int S) {
  constexpr int LD = FmaTile<HD>::LD;
  for (int i = threadIdx.x; i < n * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    const int gr = row0 + r;
    dst[r * LD + c] = gr < S ? to_f32(src[(long long)gr * stride + c]) : 0.f;
  }
}

template <typename E, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_fma(const Params p) {
  using T = FmaTile<HD>;
  constexpr int BQ = T::BQ, BK = T::BK, LD = T::LD;
  constexpr int NJ = BK / 4, NC = HD / 4;
  extern __shared__ float smem_f[];
  float* Qs = smem_f;              // [BQ][LD]
  float* Ks = Qs + BQ * LD;        // [BK][LD]
  float* Vs = Ks + BK * LD;        // [BK][LD]
  float* Ps = Vs + BK * LD;        // [BQ][BK + 1]

  const int n_qt = (p.S + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.group;
  const E* qg = static_cast<const E*>(p.q) + b * p.sq[0] + h * p.sq[1];
  const E* kg = static_cast<const E*>(p.k) + b * p.sk[0] + kvh * p.sk[1];
  const E* vg = static_cast<const E*>(p.v) + b * p.sv[0] + kvh * p.sv[1];

  const int r = threadIdx.x >> 2, c = threadIdx.x & 3;  // row, quarter
  const int qp = q0 + r;
  int kt_lo, kt_hi;
  key_tiles(p, q0, BQ, BK, &kt_lo, &kt_hi);
  load_rows_f32<E, HD>(Qs, qg, p.sq[2], q0, BQ, p.S);

  float acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = 0.f;
  float m = kNegBig, l = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    __syncthreads();   // the previous tile is consumed
    load_rows_f32<E, HD>(Ks, kg, p.sk[2], kt * BK, BK, p.S);
    load_rows_f32<E, HD>(Vs, vg, p.sv[2], kt * BK, BK, p.S);
    __syncthreads();

    // this thread's keys: c, c + 4, ..., c + BK - 4
    float s[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float qd = Qs[r * LD + d];
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[j] = fmaf(qd, Ks[(c + 4 * j) * LD + d], s[j]);
    }
    float mx = kNegBig;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[j] = valid_key(qp, kt * BK + c + 4 * j, p) ? s[j] * p.scale_log2 : kNegBig;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m, mx);
    const float alpha = exp2f(m - mn);
    m = mn;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float e = exp2f(s[j] - mn);
      rs += e;
      Ps[r * (BK + 1) + c + 4 * j] = e;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l = l * alpha + rs;
    __syncwarp();      // a row's P is written and read within one warp
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[i] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float pj = Ps[r * (BK + 1) + j];
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[i] = fmaf(pj, Vs[j * LD + c + 4 * i], acc[i]);
    }
  }

  if (qp < p.S) {
    const float safe = l == 0.f ? 1.f : l;
    E* out = static_cast<E*>(p.o) + (((long long)b * p.H + h) * p.S + qp) * HD;
#pragma unroll
    for (int i = 0; i < NC; ++i) from_f32(out + c + 4 * i, acc[i] / safe);
  }
}

// Above 48 KB a block's shared memory must be asked for, once per kernel
// and device (`configured` is a bit per device, one per instantiation), so
// no attribute call lands inside a CUDA-graph capture after the first use.
template <typename K>
int launch(K kernel, unsigned* configured, int bq, int smem, int B,
           const Params& p, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned bit = 1u << (dev & 31);
  if (!(*configured & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    *configured |= bit;
  }
  const dim3 grid((p.S + bq - 1) / bq, p.H, B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_mma(int B, const Params& p, cudaStream_t s) {
  static unsigned configured = 0;
  return launch(flash_fwd_mma<HD>, &configured, MmaTile<HD>::BQ,
                MmaTile<HD>::kSmem, B, p, s);
}

template <typename E, int HD>
int launch_fma(int B, const Params& p, cudaStream_t s) {
  static unsigned configured = 0;
  return launch(flash_fwd_fma<E, HD>, &configured, FmaTile<HD>::BQ,
                FmaTile<HD>::kSmem, B, p, s);
}

template <typename E>
int dispatch_fma(int hd, int B, const Params& p, cudaStream_t s) {
  switch (hd) {
    case 8: return launch_fma<E, 8>(B, p, s);
    case 16: return launch_fma<E, 16>(B, p, s);
    case 32: return launch_fma<E, 32>(B, p, s);
    case 64: return launch_fma<E, 64>(B, p, s);
    case 128: return launch_fma<E, 128>(B, p, s);
    case 256: return launch_fma<E, 256>(B, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  q is
// [B, H, S, hd], k/v [B, KV, S, hd], each with element strides
// strides[3*i + {0,1,2}] for batch, head and sequence (i = q, k, v) and a
// contiguous last dimension; bf16 rows must start on 16 bytes.  o is a
// contiguous [B, H, S, hd].  hd in {8, 16, 32, 64, 128, 256}, H % KV == 0,
// any S >= 1.  window = 0 means no window.  Launches on `stream`, does
// not synchronise, returns the CUDA error of the launch (0 on success).
int flash_attention_fwd(int dtype, const void* q, const void* k,
                        const void* v, void* o, int B, int H, int KV, int S,
                        int hd, int causal, int window, float sm_scale,
                        const long long* strides, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || S < 1 || H % KV || window < 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  for (int d = 0; d < 3; ++d) {
    p.sq[d] = strides[d];
    p.sk[d] = strides[3 + d];
    p.sv[d] = strides[6 + d];
  }
  p.H = H;
  p.S = S;
  p.group = H / KV;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = sm_scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_fma<float>(hd, B, p, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 8: return dispatch_fma<__nv_bfloat16>(hd, B, p, s);
    case 16: return launch_mma<16>(B, p, s);
    case 32: return launch_mma<32>(B, p, s);
    case 64: return launch_mma<64>(B, p, s);
    case 128: return launch_mma<128>(B, p, s);
    case 256: return launch_mma<256>(B, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
