// Flash attention for Hopper (sm_90a): the forward and both blocked
// backward kernels, all on the tensor cores.
//
// Replaces the TPU kernels of fedml_tpu/ops/attention.py:
//   flash_fwd_kernel     <- _flash_fwd_kernel     (pallas_call in _flash_fwd, :142)
//   flash_bwd_dq_kernel  <- _flash_bwd_dq_kernel  (pallas_call in _flash_bwd, :281)
//   flash_bwd_dkv_kernel <- _flash_bwd_dkv_kernel (pallas_call in _flash_bwd, :300)
//
// What they compute, as the JAX kernels do: scores s = (q * scale) . k^T
// with scale = 1 / sqrt(D), causally masked (key index > query index is
// dead) when asked; the forward keeps a running max m, denominator l and
// numerator in float32 (the online softmax) and writes O = numerator / l
// and the row logsumexp lse = m + log(l); the backward recomputes
// p = exp(s - lse) per tile, takes ds = p * (dO . V^T - delta) with
// delta = rowsum(dO * O) computed by the caller, and accumulates
// dQ = ds . K * scale (sweeping key tiles), dV = p^T . dO and
// dK = ds^T . Q * scale (sweeping query tiles).
//
// What bounds them on this card. For a causal (b, h) pair of length T and
// head dim D the forward does 2 products of T(T+1)/2 x D multiply-adds
// (dq 3, dkv 4) against 4 T D values moved: at T = 2048, D = 32 that is
// ~250 FLOP per byte, above the ridge of every route (float32 SIMT 20,
// TF32 148, bf16 295 FLOP per byte at 3.35 TB/s), so long sequences are
// bound by operations; at D = 32 the exponentials and the softmax's
// per-score arithmetic weigh as much as the products. At the NWP model's
// T = 20 a (b, h) pair is ~27 kFLOP against ~10 KB: bound by bytes on
// paper, and in practice by the launch, a few microseconds.
//
// The forward. A block of 128 threads (4 warps) owns 64 query rows of one
// (b, h), 16 rows a warp; the grid is (B*H, query tiles), and in causal
// mode the tiles with the most live keys are launched first. K and V
// stream through shared memory in 64-key tiles in the input type, two
// stages deep with cp.async: 16-byte copies where every row address and
// the row length allow it, else 8 or 4 bytes, else (bf16 rows of odd
// length or address) element copies; rows past T are zero-filled (source
// size 0) and the head dim is zero-padded to the instantiation's width.
// Rows are padded by 16 bytes, so the fragment loads hit 32 distinct banks.
// Each warp computes its 16 x 64 score tile with mma.sync:
//   - bf16: m16n8k16 (f32 accumulate; products of bf16 are exact in f32),
//     then S * scale in f32; P.V with P split into hi = bf16(p) and
//     lo = bf16(p - hi), two MMAs against the same V fragment (one bf16 P
//     misses the bf16 contract);
//   - float32: 3xTF32 with m16n8k8: each operand x is split into
//     big = tf32(x) and small = tf32(x - big) (cvt.rna), and a product is
//     big.big + big.small + small.big, which keeps the float32 contract
//     (one TF32 product misses it); q is multiplied by scale first.
// The softmax runs on the accumulator fragments: a thread holds rows g and
// g + 8 of its warp's tile (g = lane / 4), masks dead keys to -inf, and
// reduces max over its quad with two shuffles. Exponentials are ex2.approx
// (__expf): its relative error over the softmax's range is a small
// fraction of either contract, and it costs a few instructions where expf
// costs about ten. The C fragments of the score tile are the A fragments
// of P.V without a shuffle (bf16: n-tiles 2j, 2j + 1 are k-step j; TF32:
// slot t holds key 2t and slot t + 4 key 2t + 1, with V's B fragment
// loaded in the same order). Q's fragments stay in registers (bf16, and
// float32 up to D = 64; else they are reloaded from shared memory per
// tile). O = acc / max(l, 1e-30) is rounded once.
//
// The backward kernels are the same two products with the roles of the
// operands swapped, on the same block, tiles, copies, padding and routes:
//   - dQ: a block owns 64 query rows and streams K and V tiles (the grid
//     order and the causal tile count are the forward's). Per tile a warp
//     takes S = qk_product(Q, K tile, scale), dP = qk_product(dO, V tile,
//     1), P = exp(S - lse) with its rows' lse and delta in registers (no
//     online softmax), dS = P * (dP - delta), and dQ += pv_product(dS,
//     K tile): dS's C fragments are the A fragments, as P's are in the
//     forward. dQ is scaled once at the end.
//   - dK/dV: a block owns 64 key rows and streams Q and dO tiles with
//     their lse and delta entries (4-byte cp.async beside them). Per tile
//     S^T = qk_product(K, Q tile, scale), P^T = exp(S^T - lse[column]),
//     dV += pv_product(P^T, dO tile), dP^T = qk_product(V, dO tile, 1),
//     dS^T = P^T * (dP^T - delta[column]), dK += pv_product(dS^T, Q tile);
//     dK is scaled once at the end. In causal mode a key tile starts at
//     its diagonal query tile, so key tile 0, launched first, has the most
//     work.
// Where the score and dP fragments would not fit in registers beside the
// accumulators (float32 dK/dV, and D = 128 in float32 dQ or bf16 dK/dV) a
// streamed tile is taken in two parts of 32 rows.
// bf16 P and dS are both split hi/lo (one bf16 term of P misses the bf16
// contract in dV, one of dS in dQ and dK); float32 is 3xTF32 throughout.
// The owned operands' A fragments (Q and dO, or K and V) stay in registers
// where a row of them is at most 128 bytes (bf16 D <= 64; float32 D <= 32
// in dQ only, since beside dK/dV's two accumulators they spilled), else
// they are reloaded from shared memory per tile. Every dead pair
// (query past tq, key past tk, key after the query) is set to p = 0
// explicitly: a zero-filled row with its lse read as 0 would give exp(0).
//
// Layout. All three kernels read q, k, v (and dO) as [B, T, H, D] views
// with their own batch, token and head strides (in elements; the D stride
// is 1), so the three views that a qkv projection is cut into need no copy,
// and write O, dQ, dK and dV as contiguous [B, T, H, D] tensors. lse and
// delta are [B*H, T] float32.
//
// C interface (ctypes): flash_fwd, flash_bwd_dq, flash_bwd_dkv (each
// returns the first CUDA error of its launch, 0 on success, or a negative
// code for a shape it rejects) and flash_error_string. Each takes the
// views' three strides as 64-bit ints after the shape (b, h, tq, tk, d).
//
// Checks. chip_smoke.py holds every kernel against its plain PyTorch
// version (ops/attention.py) at (B, T, H, D) = (16, 20, 4, 32), (2, 333, 2,
// 64), (8, 2048, 4, 32), (2, 100, 3, 20) and (2, 70, 2, 127). (2, 100, 3,
// 20) has a ragged T, a D that is no multiple of 8 and 40-byte bf16 rows,
// so its tiles are staged with 8-byte copies; (2, 70, 2, 127) runs the
// D <= 128 instantiations, reloading fragments per tile and copying bf16
// rows element by element. It runs all three kernels on q, k, v cut from
// one [B, T, 3H, D] tensor too, which must give the same bits. On the CPU,
// tests/test_torch_flash_numerics.py emulates the kernels' rounding points
// (the bf16 hi/lo splits, 3xTF32 with cvt.rna) against the same tolerance.

#include <cmath>
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows a block owns, 16 a warp: queries, or keys (dkv)
constexpr int kTile = 64;           // rows of the streamed operand per shared-memory tile
constexpr int kNt = kTile / 8;      // 8-column n-tiles of a warp's score tile
constexpr int kErrHeadDim = -1;
constexpr int kErrGrid = -2;
static_assert(kRows == kTile, "the causal tile counts assume equal tiles");

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The MMA depth (the head-dim step of one S = Q.K^T product) and the row
// padding that keeps the fragment loads free of bank conflicts (a pitch of
// 4 * odd 32-bit words), per input type.
template <typename T>
struct Mma;
template <>
struct Mma<float> {
  static constexpr int kDepth = 8;  // m16n8k8 TF32
  static constexpr int kPad = 4;
};
template <>
struct Mma<__nv_bfloat16> {
  static constexpr int kDepth = 16;  // m16n8k16 bf16
  static constexpr int kPad = 8;
};

// The forward's Q fragments stay in registers for bf16 and for float32 up
// to D = 64.
template <typename T, int DMAX>
constexpr bool kQInRegs = sizeof(T) == 2 || DMAX <= 64;

// The backward kernels hold two operands' fragments beside ACCS
// accumulators: in registers where a row of them is at most 128 bytes, and
// beside dK/dV's two accumulators only in bf16 (float32 fragments take 8
// registers a k-step; at D = 32 they made dK/dV spill).
template <typename T, int DMAX, int ACCS>
constexpr bool kBwdInRegs = DMAX * sizeof(T) <= 128 && (ACCS == 1 || sizeof(T) == 2);

// The n-tiles of a streamed tile that a backward warp takes at once: all 8,
// or two parts of 4 where the score and dP fragments would not fit beside
// the accumulators (float32 dK/dV, and D = 128 in float32 dQ or bf16 dK/dV).
template <typename T, int DMAX, int ACCS>
constexpr int kBwdNt =
    (sizeof(T) == 4 && (ACCS == 2 || DMAX > 64)) || (ACCS == 2 && DMAX > 64) ? kNt / 2 : kNt;

template <typename T, int DMAX>
struct Smem {
  static constexpr int kPitch = DMAX + Mma<T>::kPad;  // elements per tile row
  static constexpr int kTileElems = kTile * kPitch;   // one [64][kPitch] tile
  static constexpr size_t kTileBytes = kTileElems * sizeof(T);
  static_assert(kPitch * sizeof(T) % 16 == 0, "rows must stay 16-byte aligned");
};

// Geometry of one call: strides in elements of the [B, T, H, D] views
// (batch, token, head) of q, k, v and dO (unused by the forward), and the
// width of the staging copies.
struct Geom {
  long long qs[3], ks[3], vs[3], ds[3];
  int h, tq, tk, d, causal, vec;
  float scale;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` bytes (16, 8 or 4) of which the first `src_bytes`
// come from global memory and the rest are zero-filled.
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, int src_bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a . b: m16n8k16, bf16 inputs, float32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a . b: m16n8k8, TF32 inputs, float32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// x = big + small + (what neither holds), each a TF32 bit pattern rounded
// to nearest, ties away (cvt.rna): a float32 is never handed to the MMA raw.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(x - __uint_as_float(big)));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

// The pair (p0, p1) as two bf16 pairs, hi = bf16(p) and lo = bf16(p - hi);
// p0 in the low halves.
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(p0 - __low2float(h), p1 - __high2float(h)));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 from two rows packed into one register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_rows(const __nv_bfloat16* lo, const __nv_bfloat16* hi) {
  return uint32_t(*reinterpret_cast<const unsigned short*>(lo)) |
         (uint32_t(*reinterpret_cast<const unsigned short*>(hi)) << 16);
}

// Rows [r0, r0 + 64) of a strided [rows, d] matrix (row r at src + r *
// stride) into a shared-memory tile of pitch P, columns [0, d); rows past
// `rows` read 0. Copies of `vec` bytes with cp.async; vec == 2 (bf16 rows of
// odd length or address) copies element by element.
template <typename T, int P>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, long long stride, int r0,
                                           int rows, int d, int vec) {
  if (vec == 2) {
    for (int i = threadIdx.x; i < kTile * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      dst[r * P + c] = r0 + r < rows ? src[(r0 + r) * stride + c] : from_f<T>(0.f);
    }
    return;
  }
  const int chunks = d * (int)sizeof(T) / vec;
  for (int i = threadIdx.x; i < kTile * chunks; i += kThreads) {
    const int r = i / chunks, c = i - r * chunks;
    const bool live = r0 + r < rows;
    const char* s = live ? reinterpret_cast<const char*>(src + (r0 + r) * stride) + c * vec
                         : reinterpret_cast<const char*>(src);
    cp_async(reinterpret_cast<char*>(dst + r * P) + c * vec, s, vec, live ? vec : 0);
  }
}

// Entries [r0, r0 + 64) of a float32 row (lse or delta) into shared
// memory, 4-byte cp.async; entries past `rows` read 0.
__device__ __forceinline__ void stage_row(float* dst, const float* src, int r0, int rows) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const bool live = r0 + i < rows;
    cp_async(dst + i, live ? src + r0 + i : src, 4, live ? 4 : 0);
  }
}

// Registers of one A fragment of an owned operand (one k-step of this
// warp's 16 rows): bf16 4 (pairs), float32 8 (4 big then 4 small TF32
// halves of x * scale).
template <typename T>
constexpr int kQRegs = sizeof(T) == 2 ? 4 : 8;

template <typename T, int DMAX>
__device__ __forceinline__ void q_frag(uint32_t (&a)[kQRegs<T>], const T* qw, int ks, int g,
                                       int t, float scale) {
  constexpr int P = Smem<T, DMAX>::kPitch;
  if constexpr (sizeof(T) == 2) {
    // a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
    const T* p = qw + g * P + ks * 16 + 2 * t;
    a[0] = ld32(p);
    a[1] = ld32(p + 8 * P);
    a[2] = ld32(p + 8);
    a[3] = ld32(p + 8 * P + 8);
  } else {
    // a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
    const float* p = qw + g * P + ks * 8 + t;
    const float x[4] = {p[0] * scale, p[8 * P] * scale, p[4] * scale, p[8 * P + 4] * scale};
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(x[i], a[i], a[4 + i]);
  }
}

template <typename T, int DMAX, bool REGS = kQInRegs<T, DMAX>>
struct QFrags {
  uint32_t a[DMAX / Mma<T>::kDepth][kQRegs<T>];
};
template <typename T, int DMAX>
struct QFrags<T, DMAX, false> {};  // reloaded from shared memory per tile

// All k-steps of an owned operand's fragments into registers.
template <typename T, int DMAX>
__device__ __forceinline__ void load_frags(QFrags<T, DMAX, true>& f, const T* w, int g, int t,
                                           float scale) {
#pragma unroll
  for (int ks = 0; ks < DMAX / Mma<T>::kDepth; ++ks) q_frag<T, DMAX>(f.a[ks], w, ks, g, t, scale);
}
template <typename T, int DMAX>
__device__ __forceinline__ void load_frags(QFrags<T, DMAX, false>&, const T*, int, int, float) {}

// s = (q * scale) . k^T for this warp's 16 rows (A: the fragments `qf`, or
// the rows at `qw`) and NT * 8 rows of a tile (B: the rows at `kt`), as NT
// n-tiles of C fragments: s[n][0..1] row g, columns 8n + 2t..2t+1;
// s[n][2..3] row g + 8. Head-dim steps past d (all zero) are skipped.
template <typename T, int DMAX, bool REGS, int NT>
__device__ __forceinline__ void qk_product(float (&s)[NT][4], const QFrags<T, DMAX, REGS>& qf,
                                           const T* qw, const T* kt, int d, int g, int t,
                                           float scale) {
  constexpr int P = Smem<T, DMAX>::kPitch, DEPTH = Mma<T>::kDepth;
#pragma unroll
  for (int ks = 0; ks < DMAX / DEPTH; ++ks) {
    if (ks * DEPTH >= d) continue;
    uint32_t a[kQRegs<T>];
    if constexpr (REGS) {
#pragma unroll
      for (int i = 0; i < kQRegs<T>; ++i) a[i] = qf.a[ks][i];
    } else {
      q_frag<T, DMAX>(a, qw, ks, g, t, scale);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const T* kr = kt + (n * 8 + g) * P + ks * DEPTH;  // key 8n + g
      if constexpr (sizeof(T) == 2) {
        // b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
        mma_bf16(s[n], a[0], a[1], a[2], a[3], ld32(kr + 2 * t), ld32(kr + 2 * t + 8));
      } else {
        // b0 (k t, n g), b1 (k t+4, n g)
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(kr[t], bb0, bs0);
        split_tf32(kr[t + 4], bb1, bs1);
        mma_tf32(s[n], a[4], a[5], a[6], a[7], bb0, bb1);  // small . big
        mma_tf32(s[n], a[0], a[1], a[2], a[3], bs0, bs1);  // big . small
        mma_tf32(s[n], a[0], a[1], a[2], a[3], bb0, bb1);  // big . big
      }
    }
  }
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= scale;
  }
}

// o += p . v for this warp's 16 rows, p in the C-fragment layout of
// qk_product (NT * 8 columns, the rows of v at `vt`); o[j] holds columns
// 8j + 2t..2t+1 of rows g and g + 8.
template <typename T, int DMAX, int NT>
__device__ __forceinline__ void pv_product(float (&o)[DMAX / 8][4], const float (&p)[NT][4],
                                           const T* vt, int d, int g, int t) {
  constexpr int P = Smem<T, DMAX>::kPitch;
  if constexpr (sizeof(T) == 2) {
    // k-step j (keys 16j..16j+15): its A fragment is the C fragments of
    // n-tiles 2j and 2j+1, split into hi and lo bf16 terms
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t hi[4], lo[4];
      split_bf16(p[2 * j][0], p[2 * j][1], hi[0], lo[0]);
      split_bf16(p[2 * j][2], p[2 * j][3], hi[1], lo[1]);
      split_bf16(p[2 * j + 1][0], p[2 * j + 1][1], hi[2], lo[2]);
      split_bf16(p[2 * j + 1][2], p[2 * j + 1][3], hi[3], lo[3]);
      const T* vr = vt + (16 * j + 2 * t) * P + g;  // key 16j + 2t, column g
#pragma unroll
      for (int n = 0; n < DMAX / 8; ++n) {
        if (n * 8 >= d) continue;
        const T* c = vr + n * 8;
        const uint32_t b0 = pack_rows(c, c + P), b1 = pack_rows(c + 8 * P, c + 9 * P);
        mma_bf16(o[n], lo[0], lo[1], lo[2], lo[3], b0, b1);
        mma_bf16(o[n], hi[0], hi[1], hi[2], hi[3], b0, b1);
      }
    }
  } else {
    // k-step j (keys 8j..8j+7) is n-tile j; slot t holds key 2t and slot
    // t + 4 key 2t + 1, on both sides of the product
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ab[4], as[4];
      split_tf32(p[j][0], ab[0], as[0]);  // a0 (g, slot t): key 2t
      split_tf32(p[j][2], ab[1], as[1]);  // a1 (g+8, slot t)
      split_tf32(p[j][1], ab[2], as[2]);  // a2 (g, slot t+4): key 2t+1
      split_tf32(p[j][3], ab[3], as[3]);  // a3 (g+8, slot t+4)
      const float* vr = vt + (8 * j + 2 * t) * P + g;  // key 8j + 2t, column g
#pragma unroll
      for (int n = 0; n < DMAX / 8; ++n) {
        if (n * 8 >= d) continue;
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(vr[n * 8], bb0, bs0);      // b0 (slot t, n g)
        split_tf32(vr[n * 8 + P], bb1, bs1);  // b1 (slot t+4, n g)
        mma_tf32(o[n], as[0], as[1], as[2], as[3], bb0, bb1);
        mma_tf32(o[n], ab[0], ab[1], ab[2], ab[3], bs0, bs1);
        mma_tf32(o[n], ab[0], ab[1], ab[2], ab[3], bb0, bb1);
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
}

// Zero the head-dim padding (columns d..DMAX) of `tiles` consecutive tiles
// once; the copies never touch it.
template <typename T, int DMAX>
__device__ __forceinline__ void zero_padding(T* first, int tiles, int d) {
  if (d >= DMAX) return;
  constexpr int P = Smem<T, DMAX>::kPitch;
  const int pad = DMAX - d;
  for (int i = threadIdx.x; i < tiles * kTile * pad; i += kThreads)
    first[(i / pad) * P + d + i % pad] = from_f<T>(0.f);
}

// Rows `rows` (g and g + 8 of a warp) of acc * mul into a contiguous
// [B, T, H, D] tensor `out` whose (b, h) slice starts at `ob`; rows at or
// past `n` are not written.
template <typename T, int DMAX>
__device__ __forceinline__ void store_rows(T* ob, const float (&acc)[DMAX / 8][4],
                                           const int (&rows)[2], int n, long long row_stride,
                                           int d, int t, float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= n) continue;
    T* orow = ob + rows[r] * row_stride;
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      const int c = j * 8 + 2 * t;
      if (c < d) orow[c] = from_f<T>(acc[j][2 * r] * mul);
      if (c + 1 < d) orow[c + 1] = from_f<T>(acc[j][2 * r + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------- forward

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, const Geom geo) {
  using S = Smem<T, DMAX>;
  constexpr int P = S::kPitch;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  T* qs = reinterpret_cast<T*>(fwd_smem);  // [64][P]
  T* ks = qs + S::kTileElems;              // 2 stages of [64][P]
  T* vs = ks + 2 * S::kTileElems;          // 2 stages of [64][P]

  const int d = geo.d, tq = geo.tq, tk = geo.tk, causal = geo.causal;
  const int bh = blockIdx.x, b = bh / geo.h, h = bh % geo.h;
  // causal: the last query tiles have the most live keys; launch them first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kRows;
  const T* qb = q + b * geo.qs[0] + h * geo.qs[2];
  const T* kb = k + b * geo.ks[0] + h * geo.ks[2];
  const T* vb = v + b * geo.vs[0] + h * geo.vs[2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int w0 = q0 + warp * 16;                     // the warp's first row
  const int rows[2] = {w0 + g, w0 + g + 8};          // this thread's two rows
  const bool warp_live = w0 < tq;                    // every warp still syncs
  const T* qw = qs + warp * 16 * P;

  zero_padding<T, DMAX>(qs, 5, d);
  int tiles = (tk + kTile - 1) / kTile;
  if (causal) tiles = min(tiles, qt + 1);  // past the diagonal: all dead
  stage_tile<T, P>(qs, qb, geo.qs[1], q0, tq, d, geo.vec);
  stage_tile<T, P>(ks, kb, geo.ks[1], 0, tk, d, geo.vec);
  stage_tile<T, P>(vs, vb, geo.vs[1], 0, tk, d, geo.vec);
  cp_async_commit();

  QFrags<T, DMAX> qf;
  float acc[DMAX / 8][4];
  zero(acc);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's share

  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * kTile, cur = (it & 1) * S::kTileElems;
    if (it + 1 < tiles) {  // the next tile into the other stage
      const int nxt = S::kTileElems - cur;
      stage_tile<T, P>(ks + nxt, kb, geo.ks[1], k0 + kTile, tk, d, geo.vec);
      stage_tile<T, P>(vs + nxt, vb, geo.vs[1], k0 + kTile, tk, d, geo.vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (warp_live) {
      if (it == 0) load_frags<T, DMAX>(qf, qw, g, t, geo.scale);
      float s[kNt][4];
      zero(s);
      qk_product<T, DMAX>(s, qf, qw, ks + cur, d, g, t, geo.scale);

      // dead scores (key past tk, or past the query) to -inf; a tile whose
      // keys all precede the warp's first row and tk is all live
      const bool full = k0 + kTile <= tk && (!causal || k0 + kTile - 1 <= w0);
      if (!full) {
#pragma unroll
        for (int n = 0; n < kNt; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + n * 8 + 2 * t + (e & 1);
            if (key >= tk || (causal && key > rows[e >> 1])) s[n][e] = -INFINITY;
          }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        // exp(-inf - -inf) guard: a row with no live score yet keeps m = -inf
        const float alpha = (m[r] == -INFINITY) ? 1.f : __expf(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha;
#pragma unroll
        for (int n = 0; n < DMAX / 8; ++n) {
          acc[n][2 * r] *= alpha;
          acc[n][2 * r + 1] *= alpha;
        }
      }
      // p = exp(s - m); a dead score gives exp(-inf) = 0, and while a row
      // has no live score (m = -inf) it is taken against 0 instead
      const float mref[2] = {m[0] == -INFINITY ? 0.f : m[0], m[1] == -INFINITY ? 0.f : m[1]};
#pragma unroll
      for (int n = 0; n < kNt; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = __expf(s[n][e] - mref[e >> 1]);
          s[n][e] = p;
          l[e >> 1] += p;
        }
      pv_product<T, DMAX>(acc, s, vs + cur, d, g, t);
    }
    __syncthreads();  // the stage just read is the next iteration's target
  }

  if (!warp_live) return;
  const long long o_row = (long long)geo.h * d;  // O is contiguous [B, T, H, D]
  T* ob = o + (long long)b * tq * o_row + (long long)h * d;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rows[r];
    if (row >= tq) continue;
    const float lsafe = fmaxf(l[r], 1e-30f);
    T* orow = ob + row * o_row;
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < d) orow[c] = from_f<T>(acc[n][2 * r] / lsafe);
      if (c + 1 < d) orow[c + 1] = from_f<T>(acc[n][2 * r + 1] / lsafe);
    }
    if (t == 0) lse[(long long)bh * tq + row] = m[r] + logf(lsafe);
  }
}

// ------------------------------------------------------------ backward dQ

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, const Geom geo) {
  using S = Smem<T, DMAX>;
  constexpr int P = S::kPitch;
  constexpr bool REGS = kBwdInRegs<T, DMAX, 1>;
  constexpr int NT = kBwdNt<T, DMAX, 1>;
  extern __shared__ __align__(16) unsigned char dq_smem[];
  T* qs = reinterpret_cast<T*>(dq_smem);  // [64][P]
  T* dos = qs + S::kTileElems;            // [64][P]
  T* ks = dos + S::kTileElems;            // 2 stages of [64][P]
  T* vs = ks + 2 * S::kTileElems;         // 2 stages of [64][P]

  const int d = geo.d, tq = geo.tq, tk = geo.tk, causal = geo.causal;
  const int bh = blockIdx.x, b = bh / geo.h, h = bh % geo.h;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // as the forward
  const int q0 = qt * kRows;
  const T* qb = q + b * geo.qs[0] + h * geo.qs[2];
  const T* kb = k + b * geo.ks[0] + h * geo.ks[2];
  const T* vb = v + b * geo.vs[0] + h * geo.vs[2];
  const T* db = dout + b * geo.ds[0] + h * geo.ds[2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int w0 = q0 + warp * 16;
  const int rows[2] = {w0 + g, w0 + g + 8};
  const bool warp_live = w0 < tq;
  const T* qw = qs + warp * 16 * P;
  const T* dw = dos + warp * 16 * P;

  zero_padding<T, DMAX>(qs, 6, d);
  int tiles = (tk + kTile - 1) / kTile;
  if (causal) tiles = min(tiles, qt + 1);
  stage_tile<T, P>(qs, qb, geo.qs[1], q0, tq, d, geo.vec);
  stage_tile<T, P>(dos, db, geo.ds[1], q0, tq, d, geo.vec);
  stage_tile<T, P>(ks, kb, geo.ks[1], 0, tk, d, geo.vec);
  stage_tile<T, P>(vs, vb, geo.vs[1], 0, tk, d, geo.vec);
  cp_async_commit();

  float lse_r[2], dl_r[2];  // this thread's rows' lse and delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = rows[r] < tq;
    lse_r[r] = ok ? lse[(long long)bh * tq + rows[r]] : 0.f;
    dl_r[r] = ok ? delta[(long long)bh * tq + rows[r]] : 0.f;
  }
  QFrags<T, DMAX, REGS> qf, df;
  float acc[DMAX / 8][4];
  zero(acc);

  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * kTile, cur = (it & 1) * S::kTileElems;
    if (it + 1 < tiles) {
      const int nxt = S::kTileElems - cur;
      stage_tile<T, P>(ks + nxt, kb, geo.ks[1], k0 + kTile, tk, d, geo.vec);
      stage_tile<T, P>(vs + nxt, vb, geo.vs[1], k0 + kTile, tk, d, geo.vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (warp_live) {
      if (it == 0) {
        load_frags<T, DMAX>(qf, qw, g, t, geo.scale);
        load_frags<T, DMAX>(df, dw, g, t, 1.f);
      }
      // every pair live: keys before tk and the warp's first row, rows before tq
      const bool full = k0 + kTile <= tk && w0 + 16 <= tq && (!causal || k0 + kTile - 1 <= w0);
#pragma unroll 1
      for (int part = 0; part < kNt / NT; ++part) {
        const int c0 = part * NT * 8;  // the part's first key in the tile
        const T* kt = ks + cur + c0 * P;
        float s[NT][4], dp[NT][4];
        zero(s);
        zero(dp);
        qk_product<T, DMAX>(s, qf, qw, kt, d, g, t, geo.scale);         // S = (q * scale) . k^T
        qk_product<T, DMAX>(dp, df, dw, vs + cur + c0 * P, d, g, t, 1.f);  // dP = dO . v^T
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, key = k0 + c0 + n * 8 + 2 * t + (e & 1);
            const bool live = full || (key < tk && rows[r] < tq && (!causal || key <= rows[r]));
            const float p = live ? __expf(s[n][e] - lse_r[r]) : 0.f;
            s[n][e] = p * (dp[n][e] - dl_r[r]);  // dS
          }
        pv_product<T, DMAX>(acc, s, kt, d, g, t);  // dQ += dS . k
      }
    }
    __syncthreads();
  }

  if (!warp_live) return;
  const long long row_stride = (long long)geo.h * d;  // dQ is contiguous [B, T, H, D]
  store_rows<T, DMAX>(dq + (long long)b * tq * row_stride + (long long)h * d, acc, rows, tq,
                      row_stride, d, t, geo.scale);
}

// -------------------------------------------------------- backward dK, dV

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     const Geom geo) {
  using S = Smem<T, DMAX>;
  constexpr int P = S::kPitch;
  constexpr bool REGS = kBwdInRegs<T, DMAX, 2>;
  constexpr int NT = kBwdNt<T, DMAX, 2>;
  extern __shared__ __align__(16) unsigned char dkv_smem[];
  T* ks = reinterpret_cast<T*>(dkv_smem);  // [64][P]
  T* vs = ks + S::kTileElems;              // [64][P]
  T* qs = vs + S::kTileElems;              // 2 stages of [64][P]
  T* dos = qs + 2 * S::kTileElems;         // 2 stages of [64][P]
  float* ls = reinterpret_cast<float*>(dos + 2 * S::kTileElems);  // 2 stages of [64] lse
  float* dls = ls + 2 * kTile;                                     // 2 stages of [64] delta

  const int d = geo.d, tq = geo.tq, tk = geo.tk, causal = geo.causal;
  const int bh = blockIdx.x, b = bh / geo.h, h = bh % geo.h;
  const int k0 = blockIdx.y * kRows;
  const T* qb = q + b * geo.qs[0] + h * geo.qs[2];
  const T* kb = k + b * geo.ks[0] + h * geo.ks[2];
  const T* vb = v + b * geo.vs[0] + h * geo.vs[2];
  const T* db = dout + b * geo.ds[0] + h * geo.ds[2];
  const float* lb = lse + (long long)bh * tq;
  const float* deb = delta + (long long)bh * tq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int w0 = k0 + warp * 16;
  const int keys[2] = {w0 + g, w0 + g + 8};
  const bool warp_live = w0 < tk;
  const T* kw = ks + warp * 16 * P;
  const T* vw = vs + warp * 16 * P;

  zero_padding<T, DMAX>(ks, 6, d);
  // causal: query tiles before this key tile's diagonal are all dead
  const int first = causal ? blockIdx.y : 0;
  const int tiles = max(0, (tq + kTile - 1) / kTile - first);
  stage_tile<T, P>(ks, kb, geo.ks[1], k0, tk, d, geo.vec);
  stage_tile<T, P>(vs, vb, geo.vs[1], k0, tk, d, geo.vec);
  if (tiles > 0) {
    const int q0 = first * kTile;
    stage_tile<T, P>(qs, qb, geo.qs[1], q0, tq, d, geo.vec);
    stage_tile<T, P>(dos, db, geo.ds[1], q0, tq, d, geo.vec);
    stage_row(ls, lb, q0, tq);
    stage_row(dls, deb, q0, tq);
  }
  cp_async_commit();

  QFrags<T, DMAX, REGS> kf, vf;
  float dk_acc[DMAX / 8][4], dv_acc[DMAX / 8][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int it = 0; it < tiles; ++it) {
    const int q0 = (first + it) * kTile, stage = it & 1;
    const int cur = stage * S::kTileElems, rcur = stage * kTile;
    if (it + 1 < tiles) {
      const int nxt = S::kTileElems - cur, rnxt = kTile - rcur;
      stage_tile<T, P>(qs + nxt, qb, geo.qs[1], q0 + kTile, tq, d, geo.vec);
      stage_tile<T, P>(dos + nxt, db, geo.ds[1], q0 + kTile, tq, d, geo.vec);
      stage_row(ls + rnxt, lb, q0 + kTile, tq);
      stage_row(dls + rnxt, deb, q0 + kTile, tq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (warp_live) {
      if (it == 0) {
        load_frags<T, DMAX>(kf, kw, g, t, geo.scale);
        load_frags<T, DMAX>(vf, vw, g, t, 1.f);
      }
      // every pair live: queries before tq and after the warp's last key,
      // keys before tk
      const bool full = q0 + kTile <= tq && w0 + 16 <= tk && (!causal || w0 + 15 <= q0);
#pragma unroll 1
      for (int part = 0; part < kNt / NT; ++part) {
        const int c0 = part * NT * 8;  // the part's first column (query) in the tile
        const T* qt = qs + cur + c0 * P;
        const T* dt = dos + cur + c0 * P;
        float s[NT][4], dp[NT][4];
        zero(s);
        zero(dp);
        qk_product<T, DMAX>(s, kf, kw, qt, d, g, t, geo.scale);  // S^T = (k * scale) . q^T
        qk_product<T, DMAX>(dp, vf, vw, dt, d, g, t, 1.f);       // dP^T = v . dO^T
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + n * 8 + 2 * t + (e & 1), query = q0 + col;
            const int key = keys[e >> 1];
            const bool live = full || (query < tq && key < tk && (!causal || key <= query));
            const float p = live ? __expf(s[n][e] - ls[rcur + col]) : 0.f;
            s[n][e] = p;                                    // P^T
            dp[n][e] = p * (dp[n][e] - dls[rcur + col]);  // dS^T
          }
        pv_product<T, DMAX>(dv_acc, s, dt, d, g, t);   // dV += P^T . dO
        pv_product<T, DMAX>(dk_acc, dp, qt, d, g, t);  // dK += dS^T . q
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();  // with no live query tile the owned tiles' copies are still in flight

  if (!warp_live) return;
  const long long row_stride = (long long)geo.h * d;  // dK, dV are contiguous [B, T, H, D]
  const long long off = (long long)b * tk * row_stride + (long long)h * d;
  store_rows<T, DMAX>(dk + off, dk_acc, keys, tk, row_stride, d, t, geo.scale);
  store_rows<T, DMAX>(dv + off, dv_acc, keys, tk, row_stride, d, t, 1.f);
}

// ---------------------------------------------------------------- launch

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;
  int bh;
  Geom geo;
};

// `kernel` on a (bh, tiles of `rows`) grid with `smem` bytes of dynamic
// shared memory.
template <typename... Params, typename... Given>
int launch(void (*kernel)(Params...), int bh, int rows, size_t smem, cudaStream_t st,
           Given... given) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (rows + kRows - 1) / kRows;
  if (tiles > 65535) return kErrGrid;
  kernel<<<dim3(bh, tiles), kThreads, smem, st>>>(given...);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
struct Fwd {
  static int run(const Args& a, cudaStream_t st) {
    return launch(flash_fwd_kernel<T, DMAX>, a.bh, a.geo.tq, 5 * Smem<T, DMAX>::kTileBytes, st,
                  static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                  static_cast<const T*>(a.v), static_cast<T*>(a.out0),
                  static_cast<float*>(a.out1), a.geo);
  }
};

template <typename T, int DMAX>
struct BwdDq {
  static int run(const Args& a, cudaStream_t st) {
    return launch(flash_bwd_dq_kernel<T, DMAX>, a.bh, a.geo.tq, 6 * Smem<T, DMAX>::kTileBytes,
                  st, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                  static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
                  static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
                  static_cast<T*>(a.out0), a.geo);
  }
};

template <typename T, int DMAX>
struct BwdDkv {
  static int run(const Args& a, cudaStream_t st) {
    const size_t smem = 6 * Smem<T, DMAX>::kTileBytes + 4 * kTile * sizeof(float);
    return launch(flash_bwd_dkv_kernel<T, DMAX>, a.bh, a.geo.tk, smem, st,
                  static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                  static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
                  static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
                  static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.geo);
  }
};

// The instantiation for the input type and the smallest head-dim width
// (32, 64 or 128) that holds d.
template <template <typename, int> class Launch>
int dispatch(const Args& a, int bf16, cudaStream_t st) {
  const int d = a.geo.d;
  if (d < 1 || d > 128) return kErrHeadDim;
  if (a.bh == 0 || a.geo.tq == 0 || a.geo.tk == 0) return 0;
  if (bf16) {
    if (d <= 32) return Launch<__nv_bfloat16, 32>::run(a, st);
    if (d <= 64) return Launch<__nv_bfloat16, 64>::run(a, st);
    return Launch<__nv_bfloat16, 128>::run(a, st);
  }
  if (d <= 32) return Launch<float, 32>::run(a, st);
  if (d <= 64) return Launch<float, 64>::run(a, st);
  return Launch<float, 128>::run(a, st);
}

// The geometry of `views` [B, T, H, D] views (q, k, v and, for the
// backward, dO) with (batch, token, head) strides `s`, three a view, and
// the widest copy (16, 8 or 4 bytes) that every row address and the row
// length allow; 2 means element copies.
Geom geometry(const void* const* ptrs, const long long* s, int views, int h, int tq, int tk,
              int d, float scale, int causal, int bf16) {
  Geom geo{};
  long long* dst[4] = {geo.qs, geo.ks, geo.vs, geo.ds};
  const unsigned long long es = bf16 ? 2 : 4;
  unsigned long long align = (unsigned long long)d * es;
  for (int i = 0; i < views; ++i) {
    align |= (uintptr_t)ptrs[i];
    for (int j = 0; j < 3; ++j) {
      dst[i][j] = s[3 * i + j];
      align |= (unsigned long long)s[3 * i + j] * es;
    }
  }
  geo.h = h;
  geo.tq = tq;
  geo.tk = tk;
  geo.d = d;
  geo.causal = causal;
  geo.scale = scale;
  geo.vec = align % 16 == 0 ? 16 : align % 8 == 0 ? 8 : align % 4 == 0 ? 4 : 2;
  return geo;
}

}  // namespace

// q, k, v: [B, T, H, D] views, each with its own (batch, token, head)
// strides in elements and a D stride of 1; o: contiguous [B, Tq, H, D];
// lse: [B*H, Tq] float32.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int b, int h, int tq, int tk, int d, long long q_sb, long long q_st,
                         long long q_sh, long long k_sb, long long k_st, long long k_sh,
                         long long v_sb, long long v_st, long long v_sh, float scale,
                         int causal, int bf16, void* stream) {
  const void* ptrs[3] = {q, k, v};
  const long long s[9] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh};
  Args a{q, k, v, nullptr, nullptr, nullptr, o, lse, b * h,
         geometry(ptrs, s, 3, h, tq, tk, d, scale, causal, bf16)};
  return dispatch<Fwd>(a, bf16, static_cast<cudaStream_t>(stream));
}

// q, k, v, dout: [B, T, H, D] views with strides as flash_fwd's (dout's
// after v's); lse, delta: [B*H, Tq] float32; dq: contiguous [B, Tq, H, D].
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int b, int h, int tq,
                            int tk, int d, long long q_sb, long long q_st, long long q_sh,
                            long long k_sb, long long k_st, long long k_sh, long long v_sb,
                            long long v_st, long long v_sh, long long do_sb, long long do_st,
                            long long do_sh, float scale, int causal, int bf16, void* stream) {
  const void* ptrs[4] = {q, k, v, dout};
  const long long s[12] = {q_sb, q_st, q_sh, k_sb,  k_st,  k_sh,
                           v_sb, v_st, v_sh, do_sb, do_st, do_sh};
  Args a{q, k, v, dout, lse, delta, dq, nullptr, b * h,
         geometry(ptrs, s, 4, h, tq, tk, d, scale, causal, bf16)};
  return dispatch<BwdDq>(a, bf16, static_cast<cudaStream_t>(stream));
}

// As flash_bwd_dq; dk, dv: contiguous [B, Tk, H, D].
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int b,
                             int h, int tq, int tk, int d, long long q_sb, long long q_st,
                             long long q_sh, long long k_sb, long long k_st, long long k_sh,
                             long long v_sb, long long v_st, long long v_sh, long long do_sb,
                             long long do_st, long long do_sh, float scale, int causal,
                             int bf16, void* stream) {
  const void* ptrs[4] = {q, k, v, dout};
  const long long s[12] = {q_sb, q_st, q_sh, k_sb,  k_st,  k_sh,
                           v_sb, v_st, v_sh, do_sb, do_st, do_sh};
  Args a{q, k, v, dout, lse, delta, dk, dv, b * h,
         geometry(ptrs, s, 4, h, tq, tk, d, scale, causal, bf16)};
  return dispatch<BwdDkv>(a, bf16, static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_error_string(int code) {
  if (code == kErrHeadDim) return "head dim must be between 1 and 128";
  if (code == kErrGrid) return "more than 65535 tiles of 64 rows";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
