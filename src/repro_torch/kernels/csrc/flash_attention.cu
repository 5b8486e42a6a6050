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
// What bounds it: at the dense serving prefill (glm4-9b, B=8, H=32, KV=2,
// S=2048, hd=128, causal, bf16) a call does 2.75e11 FLOP against 285 MB, so
// it is bound by the tensor cores (0.28 ms at 989 TFLOP/s), not by HBM; on
// Hopper only wgmma reaches their full rate.  Beside the products, each
// 128 x 128 tile needs 16,384 exponentials on the special-function units
// (16 a clock an SM): the softmax, not the products, is what a consumer
// spends most of a tile on.
//
// Three kernels, chosen by dtype and head width alone:
//  * flash_fwd_wgmma: bf16 at head width 64 and 128 (every dense config
//    the port serves).  A block of 3 warpgroups owns 128 query rows:
//    warpgroup 0 is the producer, one thread of which issues TMA loads (Q
//    once, then K and V tiles of 128 keys into a ring of 2 stages at HD 128
//    and 4 at HD 64, each stage with a full and an empty mbarrier) and
//    gives its registers up with setmaxnreg; warpgroups 1 and 2 are the
//    consumers, 64 query rows each, which raise theirs.  S = Q K^T is
//    wgmma m64n128k16 with both operands in shared memory; the online
//    softmax runs on the accumulator in registers (the mask only on tiles
//    that meet the band's edge, as per-row key bounds; the rescale of O
//    only where a row's max moved); P, rounded to bf16 in registers, is the
//    A operand of O += P V (wgmma m64n{HD}k16, V read MN-major).  A
//    consumer runs its tiles in series and releases a stage once the P.V
//    product that reads it has retired; the two consumers are not
//    synchronised, so one's softmax overlaps the other's products.  (A
//    ping-pong of the two with named barriers, and issuing the next S
//    before the softmax, were both slower: the softmax outlasts a
//    consumer's products, and the second needs more than the 168 registers
//    ptxas gives a thread here.)  The tensor maps are 4-D [B, heads, S, hd]
//    built from each tensor's strides (the model's q/k/v are transposed
//    views), with 128-byte swizzle: a tile arrives as HD/64 boxes of 128
//    rows x 64 columns, and rows past S come back zero-filled from inside
//    their own (b, h).
//  * flash_fwd_mma: bf16 at head width 16, 32 and 256.  4 warps x 16 query
//    rows; scores and P.V on the tensor cores with mma.sync.m16n8k16 (bf16
//    operands, f32 accumulate); K/V tiles by cp.async, double-buffered.
//  * flash_fwd_fma: f32 inputs (and bf16 at head width 8).  32 query rows,
//    4 threads a row; every product in f32 FMA from shared memory, as the
//    reference computes it.
// The tensor-core kernels round P to bf16 for the P.V product (the
// reference keeps it in f32: one bf16 rounding of each probability, inside
// the stated tolerance).  All run the heaviest causal query tiles first so
// the tail of the grid is short.

#include <cuda.h>          // CUtensorMap and its enums; the encoder is reached
                           // through the runtime, so no -lcuda
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
  // key tiles of 32 at head width 256 keep its shared memory at 99 KB
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

// ---------------------------------------------------------------------------
// bf16 at head width 64 and 128: wgmma on TMA-fed tiles, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;          // producer + 2 consumer warpgroups
constexpr int kProducerRegs = 24;        // 128 x 24 + 256 x 240 <= 65,536
constexpr int kConsumerRegs = 240;
// a wait that outlasts this many clock cycles (about ten seconds) is a
// broken phase: trap rather than hang the card
constexpr long long kWaitCycles = 20000000000LL;

template <int HD>
struct WgTile {
  static constexpr int BQ = 128, BK = 128;   // query rows, keys a tile
  static constexpr int kStages = HD == 128 ? 2 : 4;   // K/V ring depth
  static constexpr int kBoxes = HD / 64;     // 64 columns: 128 bytes a row
  static constexpr int kBoxBytes = 128 * 128;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  static constexpr int kBarOffset = kTileBytes * (1 + 2 * kStages);
  // Q + kStages x (K, V), then 2 x kStages + 1 barriers, and 1 KB to align
  // the tiles to the swizzle's 1 KB period: 148,552 bytes at HD 64,
  // 164,904 at HD 128 (of the 232,448 a block may have)
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (2 * kStages + 1);
};

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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
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

// wait for the phase of parity `parity` to complete
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - t0 > kWaitCycles) __trap();
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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of products are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the accumulators are written by the asynchronous product: keep the
// compiler from touching them before the wait that retires it
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.  K-major operands (Q
// and K, rows of 128 bytes): the stride between 8-row groups is 1 KB and
// the leading offset is unused.  MN-major V: the stride between 8-key
// groups is 1 KB, the leading offset (the next 64 columns) one box.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lead,
                                               uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(stride >> 4) << 32) | (1ull << 62);
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128]: A and B in shared memory, both
// K-major, 128-byte swizzled; D in f32 registers (wgmma accumulator layout)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64]: A in registers (bf16 pairs, the
// mma.sync A fragment of each warp's 16 rows), B in shared memory,
// MN-major (transposed), 128-byte swizzled
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128]: A in registers (bf16 pairs, the
// mma.sync A fragment of each warp's 16 rows), B in shared memory,
// MN-major (transposed), 128-byte swizzled
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db);
}

// S = Q K^T over a tile's 128 keys, issued and committed (not waited on):
// HD / 16 steps of 16 columns, each step's 32 bytes inside the 128-byte
// swizzled rows of its box; the first step overwrites the accumulator
template <int HD>
__device__ __forceinline__ void qk_issue(float (&sc)[64], uint32_t q_base,
                                         uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk / 4) * WgTile<HD>::kBoxBytes + (kk % 4) * 32;
    wgmma_ss_n128(sc, sw128_desc(q_base + off, 16, 1024),
                  sw128_desc(k_tile + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P V over a tile's 128 keys, issued and committed: the scores of
// keys 16ks .. 16ks + 15 are the A fragment of step ks, whose 16 rows of V
// start 2 KB on
template <int HD>
__device__ __forceinline__ void pv_issue(float (&o)[HD / 2],
                                         const uint32_t (&pa)[8][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
    wgmma_pv<HD>(o, pa[ks],
                 sw128_desc(v_tile + ks * 16 * 128, WgTile<HD>::kBoxBytes, 1024));
  wgmma_commit();
}

// 2^x on the special-function unit (denormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One thread's rows of the online softmax over a tile, in place: sc[4j + e]
// is key k0 + 8j + 2t + (e & 1) of row row_a (e < 2) or row_b, shared with
// the quad's 3 other threads.  Raises the running max m (of the scaled
// scores), turns the scores into 2^(x - m) and folds their sum into l;
// returns in al_* the factor by which the accumulator must be rescaled.
// Off the band's edge the scale rides in the FMA of the exponent's
// argument (the max of the raw scores, scaled once).  Where the tile
// meets the edge or the tail, for some row of this warp (w0 .. w0 + 15),
// a branch of its own scales and masks each score to -1e30 first (so
// does a scale that is not positive, under which the max would not
// commute with it).  Max and sum run in four partial chains a row.
__device__ __forceinline__ void online_softmax(float (&sc)[64], const Params& p,
                                               int k0, int w0, int row_a,
                                               int row_b, int t, float& m_a,
                                               float& m_b, float& l_a,
                                               float& l_b, float& al_a,
                                               float& al_b) {
  constexpr int BK = 128;
  const bool edge = k0 + BK > p.S || (p.causal && k0 + BK - 1 > w0) ||
                    (p.window && w0 + 15 - k0 >= p.window);
  float scale = p.scale_log2;
  if (edge || !(scale > 0.f)) {
    // a row's valid keys are lo .. hi (valid_key's three tests, as bounds)
    const int hi_a = p.causal ? min(row_a, p.S - 1) : p.S - 1;
    const int hi_b = p.causal ? min(row_b, p.S - 1) : p.S - 1;
    const int lo_a = p.window ? row_a - p.window + 1 : 0;
    const int lo_b = p.window ? row_b - p.window + 1 : 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * j + 2 * t + (e & 1);
        const bool ok =
            e < 2 ? kp >= lo_a && kp <= hi_a : kp >= lo_b && kp <= hi_b;
        sc[4 * j + e] = ok ? sc[4 * j + e] * scale : kNegBig;
      }
    }
    scale = 1.f;
  }
  float ma[4], mb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) ma[i] = mb[i] = kNegBig;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    ma[j & 3] = fmaxf(ma[j & 3], fmaxf(sc[4 * j + 0], sc[4 * j + 1]));
    mb[j & 3] = fmaxf(mb[j & 3], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  float mx_a = fmaxf(fmaxf(ma[0], ma[1]), fmaxf(ma[2], ma[3])) * scale;
  float mx_b = fmaxf(fmaxf(mb[0], mb[1]), fmaxf(mb[2], mb[3])) * scale;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
  al_a = ex2(m_a - mn_a);
  al_b = ex2(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
  float ra[4] = {0.f, 0.f, 0.f, 0.f}, rb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    sc[4 * j + 0] = ex2(fmaf(sc[4 * j + 0], scale, -mn_a));
    sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale, -mn_a));
    sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale, -mn_b));
    sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale, -mn_b));
    ra[j & 3] += sc[4 * j + 0] + sc[4 * j + 1];
    rb[j & 3] += sc[4 * j + 2] + sc[4 * j + 3];
  }
  float rs_a = (ra[0] + ra[1]) + (ra[2] + ra[3]);
  float rs_b = (rb[0] + rb[1]) + (rb[2] + rb[3]);
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    rs_a += __shfl_xor_sync(0xffffffffu, rs_a, off);
    rs_b += __shfl_xor_sync(0xffffffffu, rs_b, off);
  }
  l_a = l_a * al_a + rs_a;
  l_b = l_b * al_b + rs_b;
}

// P in bf16: the A fragments of the P.V product
__device__ __forceinline__ void to_fragments(const float (&sc)[64],
                                             uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    pa[ks][0] = pack_bf16(sc[8 * ks + 0], sc[8 * ks + 1]);
    pa[ks][1] = pack_bf16(sc[8 * ks + 2], sc[8 * ks + 3]);
    pa[ks][2] = pack_bf16(sc[8 * ks + 4], sc[8 * ks + 5]);
    pa[ks][3] = pack_bf16(sc[8 * ks + 6], sc[8 * ks + 7]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const Params p) {
  using T = WgTile<HD>;
  constexpr int BQ = T::BQ, BK = T::BK, kStages = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem;                          // [kBoxes][128][64]
  unsigned char* Ks = Qs + T::kTileBytes;            // [kStages] tiles
  unsigned char* Vs = Ks + kStages * T::kTileBytes;  // [kStages] tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int n_qt = (p.S + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.z) * BQ;  // heaviest tiles first
  int kt_lo, kt_hi;
  key_tiles(p, q0, BQ, BK, &kt_lo, &kt_hi);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);       // each consumer warp releases a stage
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread keeps the ring full; the others leave
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      const int kvh = h / p.group;
      mbar_expect_tx(q_full, T::kTileBytes);
#pragma unroll
      for (int x = 0; x < T::kBoxes; ++x)
        tma_load_4d(Qs + x * T::kBoxBytes, &tq, q_full, 64 * x, q0, h, b);
      for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
        const int s = i % kStages;
        // the first pass over the ring finds every stage free
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        // the whole boxes' bytes, rows past S (zero-filled) included
        mbar_expect_tx(&full[s], 2 * T::kTileBytes);
#pragma unroll
        for (int x = 0; x < T::kBoxes; ++x) {
          tma_load_4d(Ks + s * T::kTileBytes + x * T::kBoxBytes, &tk, &full[s],
                      64 * x, kt * BK, kvh, b);
          tma_load_4d(Vs + s * T::kTileBytes + x * T::kBoxBytes, &tv, &full[s],
                      64 * x, kt * BK, kvh, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup 1 takes rows q0 .. q0 + 63, warpgroup 2 the next 64
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int w0 = q0 + 64 * wg + 16 * warp;   // this warp's first row
  const int row_a = w0 + g, row_b = row_a + 8;
  // this warpgroup's 64 rows inside each Q box (8 KB on)
  const uint32_t q_base = smem_u32(Qs) + wg * 64 * 128;
  const uint32_t k_base = smem_u32(Ks), v_base = smem_u32(Vs);
  const int n = kt_hi - kt_lo;

  // o[4j + {0,1}]: row row_a, columns 8j + 2t + {0,1}; o[4j + {2,3}]: row_b
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_a = kNegBig, m_b = kNegBig, l_a = 0.f, l_b = 0.f, al_a, al_b;
  float sc[64];      // the first step of every S = Q K^T overwrites it
#pragma unroll
  for (int j = 0; j < 64; ++j) sc[j] = 0.f;
  uint32_t pa[8][4];

  // Each tile in series: S = Q K^T, the softmax, O += P V, then the stage
  // goes back to the producer.  The two consumers run unsynchronised, so
  // one's softmax overlaps the other's products wherever they drift apart.
  mbar_wait(q_full, 0);
  for (int j = 0; j < n; ++j) {
    const int s = j % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
    wgmma_fence();
    qk_issue<HD>(sc, q_base, k_base + s * T::kTileBytes);
    wgmma_wait<0>();
    reg_fence(sc);
    online_softmax(sc, p, (kt_lo + j) * BK, w0, row_a, row_b, t, m_a, m_b,
                   l_a, l_b, al_a, al_b);
    // rescale only where some row's max moved (a factor of 1 is exact)
    if (__any_sync(0xffffffffu, al_a != 1.f || al_b != 1.f)) {
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        o[4 * i + 0] *= al_a;
        o[4 * i + 1] *= al_a;
        o[4 * i + 2] *= al_b;
        o[4 * i + 3] *= al_b;
      }
    }
    to_fragments(sc, pa);
    wgmma_fence();
    pv_issue<HD>(o, pa, v_base + s * T::kTileBytes);
    wgmma_wait<0>();
    reg_fence(o);
    // both products that read this stage have retired
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const float sa = l_a == 0.f ? 1.f : l_a, sb = l_b == 0.f ? 1.f : l_b;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) +
                       ((long long)b * p.H + h) * p.S * HD;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (row_a < p.S)
      *reinterpret_cast<uint32_t*>(out + (long long)row_a * HD + col) =
          pack_bf16(o[4 * j + 0] / sa, o[4 * j + 1] / sa);
    if (row_b < p.S)
      *reinterpret_cast<uint32_t*>(out + (long long)row_b * HD + col) =
          pack_bf16(o[4 * j + 2] / sb, o[4 * j + 3] / sb);
  }
}

// Above 48 KB a block's shared memory must be asked for, once per kernel
// and device (`configured` is a bit per device, one per instantiation), so
// no attribute call lands inside a CUDA-graph capture after the first use.
template <typename K>
cudaError_t configure(K kernel, unsigned* configured, int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (!(*configured & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    *configured |= bit;
  }
  return cudaSuccess;
}

template <typename K>
int launch(K kernel, unsigned* configured, int bq, int smem, int B,
           const Params& p, cudaStream_t stream) {
  const cudaError_t err = configure(kernel, configured, smem);
  if (err != cudaSuccess) return (int)err;
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

// cuTensorMapEncodeTiled, a driver function, through the runtime's entry
// point query (its 12.0 ABI), so the build links no libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t tensor_map_encoder(EncodeTiled* fn) {
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
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || ptr == nullptr)
      return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(ptr);
  }
  *fn = cached;
  return cudaSuccess;
}

// The 4-D map [B, heads, S, hd] of one bf16 operand, boxes of 128 rows x 64
// columns with 128-byte swizzle.  `st` holds the element strides of batch,
// head and sequence; a dimension of extent 1 is never stepped, so it gets
// the packed stride (the map wants every stride a multiple of 16 bytes).
cudaError_t encode_map(EncodeTiled encode, CUtensorMap* map, const void* base,
                       int B, int heads, int S, int hd, const long long* st) {
  const long long packed[3] = {(long long)heads * S * hd, (long long)S * hd, hd};
  const int extent[3] = {B, heads, S};
  long long bytes[3];
  for (int d = 0; d < 3; ++d) bytes[d] = 2 * (extent[d] > 1 ? st[d] : packed[d]);
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)heads,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)bytes[2], (cuuint64_t)bytes[1],
                                 (cuuint64_t)bytes[0]};
  const cuuint32_t box[4] = {64, 128, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD>
int launch_wgmma(int B, int KV, const Params& p, cudaStream_t stream) {
  using T = WgTile<HD>;
  static unsigned configured = 0;
  cudaError_t err = configure(flash_fwd_wgmma<HD>, &configured, T::kSmem);
  if (err != cudaSuccess) return (int)err;
  EncodeTiled encode;
  if ((err = tensor_map_encoder(&encode)) != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv;
  if ((err = encode_map(encode, &tq, p.q, B, p.H, p.S, HD, p.sq)) ||
      (err = encode_map(encode, &tk, p.k, B, KV, p.S, HD, p.sk)) ||
      (err = encode_map(encode, &tv, p.v, B, KV, p.S, HD, p.sv)))
    return (int)err;
  const dim3 grid(p.H, B, (p.S + T::BQ - 1) / T::BQ);
  flash_fwd_wgmma<HD><<<grid, kWgThreads, T::kSmem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  q is
// [B, H, S, hd], k/v [B, KV, S, hd], each with element strides
// strides[3*i + {0,1,2}] for batch, head and sequence (i = q, k, v) and a
// contiguous last dimension; bf16 rows must start on 16 bytes, and every
// stride of a dimension longer than 1 be a positive multiple of 16 bytes.
// o is a contiguous [B, H, S, hd].  hd in {8, 16, 32, 64, 128, 256},
// H % KV == 0, any S >= 1.  window = 0 means no window.  Sets *kernel to
// the kernel it launches (0 = flash_fwd_fma, 1 = flash_fwd_mma,
// 2 = flash_fwd_wgmma), launches on `stream`, does not synchronise, and
// returns the CUDA error of the launch (0 on success).
int flash_attention_fwd(int dtype, const void* q, const void* k,
                        const void* v, void* o, int B, int H, int KV, int S,
                        int hd, int causal, int window, float sm_scale,
                        const long long* strides, void* stream, int* kernel) {
  *kernel = dtype != 1 || hd == 8 ? 0 : hd == 64 || hd == 128 ? 2 : 1;
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
    case 64: return launch_wgmma<64>(B, KV, p, s);
    case 128: return launch_wgmma<128>(B, KV, p, s);
    case 256: return launch_mma<256>(B, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
