// Fused local-SGD epoch of CNN_DropOut for Hopper (sm_90a).
//
// Replaces the TPU kernel fedml_tpu/ops/fused_sgd.py::_epoch_kernel
// (pallas_call in fused_epoch, fused_sgd.py:461): one client's whole local
// epoch — conv 3x3 32, conv 3x3 64, ReLU, 2x2 max-pool, dropout, dense 128,
// dropout, dense C, float32 softmax cross-entropy, the backward pass, a
// global-norm clip and SGD — for every client of a round.
//
// What bounds it on this card. At the flagship shape (10 clients x 10 steps
// of batch 20, 28x28, 62 classes) a round is 143.2 GFLOP, 89% of it (127.4
// GFLOP) in conv2's forward, weight gradient and input gradient, against
// ~59 MB that must move (the data, the global weights read once, 10 x 4.8 MB
// of client weights written once): far above the card's operations-per-byte
// line, so it is bound by operations. float32 is held to the float32
// reference at 2e-5 / 1e-5; 3xTF32 (below) keeps that contract, so its
// floor is 143.2 GFLOP at 495 / 3 TFLOP/s, 0.868 ms; bf16's is 0.145 ms at
// 989 TFLOP/s.
//
// Design. The TPU kernel keeps one client's 74 MB working set in VMEM for
// the whole epoch, one grid step per client. A Hopper SM has 227 KB of
// shared memory, and one block per client would leave 122 of 132 SMs idle.
// So here the per-client weights live in one packed float32 row per client
// in device memory (10 x 4.8 MB, mostly L2-resident), seeded once from the
// global weights, and each SGD step is a fixed sequence of kernels, each
// batched over clients (the client is part of the grid) and tiled over
// outputs so a step fills the card:
//   conv1 -> conv2 forward -> pool + dropout -> dense1 (split-K GEMM,
//   K = 9216) -> bias/ReLU/dropout -> dense2 + CE + dense2 backward (one
//   block per client) -> dense1 weight gradient -> dense1 input gradient ->
//   pool backward -> conv2 weight gradient (split over positions) + its
//   fixed-order reduce -> conv2 input gradient -> conv1 weight gradient
//   (split-K) -> per-client sum of squares -> clip + SGD.
// The clip scale stays on the device: there is no host synchronisation
// inside the epoch. Split-K partial sums are reduced in a fixed order and
// no kernel uses atomics, so a run is deterministic.
//
// conv2's three products run on the tensor cores with mma.sync (each
// kernel's section below gives its tiles): float32 as 3xTF32, every operand
// split into big = tf32(x) and small = tf32(x - big) with cvt.rna and
// small.big + big.small + big.big on m16n8k8; bf16 as one m16n8k16, since
// every operand (a1, dz2, and w2 rounded as it is staged) is a bf16 value
// already. The tensor core's own float32 accumulation is kept short: each
// k-step's MMAs (float32; the bf16 forward, each 32-wide k tile's) start
// from a zero fragment that joins the running sum by a float32 add, which
// rounds to nearest; one accumulator over all of K drifted far enough from
// the plain version to flip max-pool routes, which an epoch amplifies past
// the agreement limits. The bf16 forward recomputes the few outputs whose
// bf16 rounding the order of the sum decides in the plain version's order
// (see conv2_fwd_kernel). Tiles are staged by 16-byte cp.async; rows of
// shared memory are padded so fragment loads hit distinct banks; ragged
// tiles and conv halos are zero-filled in the staged tile. Shared memory
// per block: forward 73 KB float32 (two w2 slices, split, and two 128-row A
// tiles) / 132 KB bf16 (w2 whole and all nine A tiles of an m-tile), input
// gradient 104 / 47 KB, weight gradient 74 / 18 KB.
//
// What stays on the CUDA cores (gemm_kernel, a shared-memory-tiled SIMT
// template with float32 accumulation): dense1's three products, which have
// the batch (20) as M or K and do ~10 FLOP per byte of their 4.7 MB weight
// block per client, below the card's ridge, so tensor cores would not move
// them; conv1's weight gradient (N = 32, K = positions, 0.3% of the work);
// conv1, pooling, the head, the clip and SGD, which are elementwise or
// reductions.
//
// Semantics (bit for bit where integer) follow the JAX kernel: dropout bits
// are lowbias32 over the JAX kernel's (chunk, Hp, Wp, 64) / (chunk, 128)
// geometry with its seed and chunk-index mixing constants; max-pool
// backward routes to the first maximum in row-major window order; values
// are rounded to the compute type (float or bf16) where the JAX kernel
// casts; weight gradients accumulate in float32; the input gradient of
// conv2 is summed over the nine filter offsets in the compute type.
//
// Packed row of a client (floats): [w1 9x32; b1] [w2 288x64; b2]
// [w3 Fx128; b3] [w4 128xC; b4], each layer a [K + 1, N] block with the bias
// as its last row, so a weight gradient and its bias gradient come out of
// one GEMM whose A operand has an extra row of ones.
//
// C interface (ctypes): fused_sgd_workspace_bytes, fused_sgd_epoch (returns
// the first cudaGetLastError() that is not cudaSuccess, or a negative code
// for a geometry it rejects), fused_sgd_error_string.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define LAUNCH(fn, grid, block, smem, stream, ...) \
  fn<<<grid, block, smem, stream>>>(__VA_ARGS__)

namespace {

constexpr int kThreads = 256;
constexpr int kSqBlocks = 64;          // sum-of-squares partials per client
constexpr int kDense1Splits = 36;      // split-K targets
constexpr int kGw1Splits = 32;
constexpr int kErrGeometry = -1;
constexpr int kErrSmem = -2;
constexpr int kErrDevice = -3;

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline long long cdiv(long long a, long long b) {
  return (a + b - 1) / b;
}

// ---------------------------------------------------------------- types

template <typename T>
struct Cd;

template <>
struct Cd<float> {
  __device__ static inline float rnd(float v) { return v; }
  __device__ static inline float ld(float v) { return v; }
  __device__ static inline float st(float v) { return v; }
};

template <>
struct Cd<__nv_bfloat16> {
  __device__ static inline float rnd(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
  __device__ static inline float ld(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  __device__ static inline __nv_bfloat16 st(float v) {
    return __float2bfloat16(v);
  }
};

struct Geo {
  int cl, n, H, W, C, b, chunk, nchunks, steps;
  int H1, W1, H2, W2, Hp, Wp, F;
  int NP, o1, o2, o3, o4;
  float lr, clip;
  int has_clip, drop1, drop2;
  uint32_t thr1, thr2;
  float kv1, kv2, inv_b;
  int s1, s2, s3;  // split counts: dense1, conv2 wgrad, conv1 wgrad
  int tper2;       // conv2 wgrad k tiles per split
  int s;           // current step
};

template <typename T>
struct Bufs {
  const float* x;
  const int* y;
  const uint32_t* seeds;
  float* wb;  // [cl, NP] working weights (the output)
  float* g;   // [cl, NP] gradients of the current step
  float* met; // [cl, 3] loss_sum, correct, total
  T *a1, *a2, *d, *h, *hd, *dh, *dd, *dz2, *dz1;
  float *part, *sq;
};

// ------------------------------------------------------------- dropout

__device__ inline uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// sample bi of step s is row bi % chunk of global chunk s * nchunks + bi / chunk
__device__ inline bool keep1(const Geo& g, uint32_t seed, int bi, int f) {
  uint32_t gi = (uint32_t)(g.s * g.nchunks + bi / g.chunk);
  uint32_t off = seed * 0x9E3779B9u + gi * 0x85EBCA77u;
  return lowbias32((uint32_t)((bi % g.chunk) * g.F + f) + off) >= g.thr1;
}

__device__ inline bool keep2(const Geo& g, uint32_t seed, int bi, int n) {
  uint32_t gi = (uint32_t)(g.s * g.nchunks + bi / g.chunk);
  uint32_t off = seed * 0xC2B2AE35u + gi * 0x27D4EB2Fu + 0x165667B1u;
  return lowbias32((uint32_t)((bi % g.chunk) * 128 + n) + off) >= g.thr2;
}

// ----------------------------------------------------------- tiled GEMM
//
// C[z](M x N) = A[z](M x K) B[z](K x N), float32 accumulation. The problem
// P supplies element loads a(z, m, k) / b(z, k, n) (already rounded to the
// compute type), its shape, split-K geometry and the epilogue store(). kAK /
// kBK say that A / B is contiguous along k (loads walk k fastest). It runs
// the products that stay on the CUDA cores: dense1's three (M or K = the
// batch) and conv1's weight gradient.

struct GemmShape {
  int M, N, K, splits, kper;
};

inline void set_split(GemmShape& p, int want, int bk) {
  p.kper = (int)(cdiv(cdiv(p.K, want), bk) * bk);
  p.splits = (int)cdiv(p.K, p.kper);
}

template <int BM, int BN, int BK, int TM, int TN, class P>
__global__ void __launch_bounds__((BM / TM) * (BN / TN)) gemm_kernel(P p) {
  constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY;
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int z = blockIdx.z / p.splits, split = blockIdx.z % p.splits;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kbeg = split * p.kper, kend = imin(p.K, kbeg + p.kper);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int k = P::kAK ? e % BK : e / BM;
      const int m = P::kAK ? e / BK : e % BM;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < p.M && gk < kend) ? p.a(z, gm, gk) : 0.f;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int k = P::kBK ? e % BK : e / BN;
      const int n = P::kBK ? e / BK : e % BN;
      const int gn = n0 + n, gk = k0 + k;
      Bs[k][n] = (gn < p.N && gk < kend) ? p.b(z, gk, gn) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[k][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[k][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gm = m0 + ty + i * TY, gn = n0 + tx + j * TX;
      if (gm < p.M && gn < p.N)
        p.store(z, split, gm, gn, acc[i][j]);
    }
}

// ------------------------------------------------------- GEMM problems

// dense1 forward, split over K = F: partial sums to B.part
template <typename T>
struct Dense1Fwd : GemmShape {
  static constexpr bool kAK = true, kBK = false;
  Geo g;
  Bufs<T> B;
  __device__ float a(int z, int m, int k) const {
    return Cd<T>::ld(B.d[((size_t)z * g.b + m) * g.F + k]);
  }
  __device__ float b(int z, int k, int n) const {
    return Cd<T>::rnd(B.wb[(size_t)z * g.NP + g.o3 + (size_t)k * 128 + n]);
  }
  __device__ void store(int z, int split, int m, int n, float acc) const {
    B.part[(((size_t)z * splits + split) * g.b + m) * 128 + n] = acc;
  }
};

// dense1 weight + bias gradient: rows f (F of them, then a row of ones)
template <typename T>
struct Gw3 : GemmShape {
  static constexpr bool kAK = false, kBK = false;
  Geo g;
  Bufs<T> B;
  __device__ float a(int z, int m, int k) const {
    return m < g.F ? Cd<T>::ld(B.d[((size_t)z * g.b + k) * g.F + m]) : 1.f;
  }
  __device__ float b(int z, int k, int n) const {
    return Cd<T>::ld(B.dh[((size_t)z * g.b + k) * 128 + n]);
  }
  __device__ void store(int z, int, int m, int n, float acc) const {
    B.g[(size_t)z * g.NP + g.o3 + (size_t)m * 128 + n] = acc;
  }
};

// dense1 input gradient (times the dropout-1 mask)
template <typename T>
struct DP3 : GemmShape {
  static constexpr bool kAK = true, kBK = true;
  Geo g;
  Bufs<T> B;
  __device__ float a(int z, int m, int k) const {
    return Cd<T>::ld(B.dh[((size_t)z * g.b + m) * 128 + k]);
  }
  __device__ float b(int z, int k, int n) const {
    return Cd<T>::rnd(B.wb[(size_t)z * g.NP + g.o3 + (size_t)n * 128 + k]);
  }
  __device__ void store(int z, int, int m, int n, float acc) const {
    float v = Cd<T>::rnd(acc);
    if (g.drop1) v = Cd<T>::rnd(v * (keep1(g, B.seeds[z], m, n) ? g.kv1 : 0.f));
    B.dd[((size_t)z * g.b + m) * g.F + n] = Cd<T>::st(v);
  }
};

// conv1 weight + bias gradient: rows (di, dj) then ones, k = positions
template <typename T>
struct Gw1 : GemmShape {
  static constexpr bool kAK = true, kBK = false;
  Geo g;
  Bufs<T> B;
  __device__ float a(int z, int m, int k) const {
    if (m == 9) return 1.f;
    const int hw = g.H1 * g.W1, bi = k / hw, r = k - bi * hw;
    const int i = r / g.W1 + m / 3, j = r % g.W1 + m % 3;
    return Cd<T>::rnd(B.x[((size_t)(z * g.n + g.s * g.b + bi) * g.H + i) * g.W + j]);
  }
  __device__ float b(int z, int k, int n) const {
    return Cd<T>::ld(B.dz1[((size_t)z * g.b * g.H1 * g.W1 + k) * 32 + n]);
  }
  __device__ void store(int z, int split, int m, int n, float acc) const {
    B.part[(((size_t)z * splits + split) * 10 + m) * 32 + n] = acc;
  }
};

// ------------------------------------------------- tensor-core helpers
//
// smem_addr, cp_async16, cp_async_commit / cp_async_wait, mma_bf16,
// mma_tf32, split_tf32 and ld32 are copies of flash_attention.cu's: a
// library is keyed by the hash of its own source only (ops/_build.py), so
// the two files do not share a header yet.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 bytes, of which the first `src_bytes` (16 or 0) come from
// global memory and the rest are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc += a . b for one k-step of a 16 x 8 fragment tile. The MMA starts from
// a zero accumulator and its sum joins acc by a float32 add that rounds to
// nearest, so the tensor core's own accumulation spans one k-step only.
__device__ __forceinline__ void step_bf16(float (&acc)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(p, a[0], a[1], a[2], a[3], b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += p[e];
}

// The same for 3xTF32: small.big + big.small + big.big of the split
// operands (A: big ab, small as; B: big bb0/bb1, small bs0/bs1).
__device__ __forceinline__ void step_3xtf32(float (&acc)[4], const uint32_t (&ab)[4],
                                            const uint32_t (&as)[4], uint32_t bb0, uint32_t bb1,
                                            uint32_t bs0, uint32_t bs1) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(p, as[0], as[1], as[2], as[3], bb0, bb1);
  mma_tf32(p, ab[0], ab[1], ab[2], ab[3], bs0, bs1);
  mma_tf32(p, ab[0], ab[1], ab[2], ab[3], bb0, bb1);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += p[e];
}

// Four 8x8 bf16 matrices, transposed: lane L gives the address of row L % 8
// of matrix L / 8 (16 contiguous bytes) and receives, of matrix q, rows
// 2 (L % 4) and 2 (L % 4) + 1 of column L / 4 in r[q] (the lower row in the
// low half): the A or B fragment of m16n8k16 from a tile stored k-major.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Padding of a shared-memory row of k-contiguous operands: 4 floats or 8
// bf16, so that a row pitch of 4 x (odd) 32-bit words sends the 32 lanes of
// a fragment load (row g, word t) to 32 distinct banks.
template <typename T>
constexpr int kPad = sizeof(T) == 4 ? 4 : 8;

// acc[i][j] += A . B for a warp's MT x NT fragment tiles (16 rows, 8
// columns each) over K values of k. A: MT * 16 rows at `a`, pitch PA; B:
// NT * 8 rows ([n][k]) at `b`, pitch PB; both k-contiguous in shared
// memory. float: 3xTF32 (small.big + big.small + big.big) on m16n8k8; bf16:
// m16n8k16, the operands being bf16 values already. With MAG (bf16 only),
// mag[i][j] += |A| . |B| beside it, the sum of the products' magnitudes,
// and both accumulate in the MMA over the K values (the caller passes
// fragments of this k tile alone).
// With SPLITB (float32 only), B is split already: b holds the big TF32
// halves and bsmall the small ones, in the same layout.
template <typename T, int MT, int NT, int K, int PA, int PB, bool MAG = false, bool SPLITB = false>
__device__ __forceinline__ void warp_mma_kmajor(float (&acc)[MT][NT][4], float (&mag)[MT][NT][4],
                                                const T* a, const T* b, int g, int t,
                                                const uint32_t* bsmall = nullptr) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int ks = 0; ks < K; ks += 16) {
      // a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const T* p = a + (16 * i + g) * PA + ks + 2 * t;
        af[i][0] = ld32(p);
        af[i][1] = ld32(p + 8 * PA);
        af[i][2] = ld32(p + 8);
        af[i][3] = ld32(p + 8 * PA + 8);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
        const T* q = b + (8 * j + g) * PB + ks + 2 * t;
        const uint32_t b0 = ld32(q), b1 = ld32(q + 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if constexpr (MAG) {
            constexpr uint32_t kAbs = 0x7FFF7FFFu;  // clears the sign of both bf16 halves
            mma_bf16(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3], b0, b1);
            mma_bf16(mag[i][j], af[i][0] & kAbs, af[i][1] & kAbs, af[i][2] & kAbs,
                     af[i][3] & kAbs, b0 & kAbs, b1 & kAbs);
          } else {
            step_bf16(acc[i][j], af[i], b0, b1);
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < K; ks += 8) {
      // a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* p = a + (16 * i + g) * PA + ks + t;
        split_tf32(p[0], ab[i][0], as[i][0]);
        split_tf32(p[8 * PA], ab[i][1], as[i][1]);
        split_tf32(p[4], ab[i][2], as[i][2]);
        split_tf32(p[8 * PA + 4], ab[i][3], as[i][3]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // b0 (k t, n g), b1 (k t+4, n g)
        const int at = (8 * j + g) * PB + ks + t;
        uint32_t bb0, bs0, bb1, bs1;
        if constexpr (SPLITB) {
          const uint32_t* q = reinterpret_cast<const uint32_t*>(b) + at;
          bb0 = q[0];
          bb1 = q[4];
          bs0 = bsmall[at];
          bs1 = bsmall[at + 4];
        } else {
          split_tf32(b[at], bb0, bs0);
          split_tf32(b[at + 4], bb1, bs1);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) step_3xtf32(acc[i][j], ab[i], as[i], bb0, bb1, bs0, bs1);
      }
    }
  }
}

// Blocks per client of a persistent grid over `tiles` tiles: at most
// `slots` resident blocks on the card shared by `cl` clients (one wave),
// each block taking an equal count of tiles.
inline int persistent_blocks(int tiles, int slots, int cl) {
  const int want = slots > cl ? slots / cl : 1;
  const int per = (int)cdiv(tiles, want);
  return (int)cdiv(tiles, per);
}

// ------------------------------------------- conv2 forward (tensor cores)
//
// a2 = relu(rnd(rnd(a1 (*) w2) + b2)) as an implicit-im2col GEMM: M = b H2
// W2 output positions, N = 64, K = 288 = 9 filter offsets x 32 channels, one
// offset per k tile. A block walks m-tiles of 128 rows (persistent grid)
// with w2 as [n][k]: in bf16 whole, rounded once; in float32 one offset's
// slice at a time, split into its TF32 halves once for all warps. Per
// m-tile a table gives
// each row's a1 offset, so an A row of a k tile (32 contiguous channels of
// one shifted a1 position) costs one add. A tiles are staged by 16-byte
// cp.async into a ring, float32 two deep, bf16 all nine. 8 warps as 4
// (rows) x 2 (columns) of 32 x 32.
constexpr int kFwdBM = 128;
constexpr int kFixCap = 64;  // bf16: outputs a warp recomputes at once (see below)

template <typename T>
struct FwdSmem {
  static constexpr int PA = 32 + kPad<T>;   // A row: 36 floats, 40 bf16
  static constexpr int PW = 288 + kPad<T>;  // w2^T row: 292 floats, 296 bf16
  // A tiles in the ring: float32 two; bf16 all nine of an m-tile, which the
  // outputs recomputed in the plain version's order (below) read again
  static constexpr int NS = sizeof(T) == 2 ? 9 : 2;
  // w2: bf16 whole as [n][k]; float32 one offset's 32 x 64 slice at a time
  // as [n][k], split into big and small TF32 halves, two buffers of each
  static constexpr int kWElems = sizeof(T) == 2 ? 64 * PW : 2 * 2 * 64 * PA;
  static constexpr size_t kBytes =
      (size_t)(kWElems + NS * kFwdBM * PA) * sizeof(T) + (64 + kFwdBM) * sizeof(float) +
      (sizeof(T) == 2 ? (kThreads / 32) * kFixCap * 2 * sizeof(float) : 0);
};

// bf16 rounds the sum a2 = rnd(acc) at once, so where acc lies near a bf16
// rounding midpoint, the order of its float32 additions decides the bf16
// value; one flipped value in a max-pool window can reroute a gradient and,
// over an epoch, a client's training (with the tensor cores' order alone
// the flagship epoch read far outside chip_smoke.py's TOL). There the
// forward takes the order of the plain version's float32 GEMM on the card,
// which the SIMT loop this kernel replaced matched bit for bit: the 288
// products in k order, one FMA each. "Near" is within kSerialMargin float32
// half-ulps of the products' magnitude sum (|a| . |b|, a second MMA) of
// zero or of a midpoint, and not where every rounding leaves relu(acc + b)
// at 0: a few percent of the outputs at the flagship shape.
constexpr float kSerialMargin = 32.f * 0x1p-24f;

__device__ __forceinline__ bool near_bf16_midpoint(float x, float margin) {
  const float ax = fabsf(x);
  if (ax <= margin) return true;
  const uint32_t u = __float_as_uint(ax);
  const float half_ulp = __uint_as_float(u & 0x7F800000u) * 0x1p-24f;
  return fabsf((float)((int)(u & 0xFFFFu) - 0x8000)) * half_ulp <= margin;
}

// The plain version's float32 sum of one bf16 conv2 output, k = (di, dj,
// ci) in order: a, its A row in the first of the m-tile's nine resident A
// tiles (one offset each, `stride` elements apart); w, its row of w2^T.
__device__ __noinline__ float conv2_fwd_serial(const __nv_bfloat16* a, int stride,
                                               const __nv_bfloat16* w) {
  float acc = 0.f;
  for (int kk = 0; kk < 9; ++kk) {
    const uint4* ak = reinterpret_cast<const uint4*>(a + kk * stride);
    const uint4* wk = reinterpret_cast<const uint4*>(w + kk * 32);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 av = ak[q], wv = wk[q];
      const __nv_bfloat162* ap = reinterpret_cast<const __nv_bfloat162*>(&av);
      const __nv_bfloat162* wp = reinterpret_cast<const __nv_bfloat162*>(&wv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(ap[e]), y = __bfloat1622float2(wp[e]);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
      }
    }
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) conv2_fwd_kernel(Geo g, Bufs<T> B) {
  using S = FwdSmem<T>;
  constexpr int CH = 32 * (int)sizeof(T) / 16;  // 16-byte chunks of an A row
  constexpr int EL = 16 / (int)sizeof(T);       // elements of a chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sW = reinterpret_cast<T*>(smem_raw);
  uint32_t* sWbig = reinterpret_cast<uint32_t*>(sW);  // float32 only
  uint32_t* sWsmall = sWbig + 2 * 64 * S::PA;
  T* sA = sW + S::kWElems;
  float* sBias = reinterpret_cast<float*>(sA + S::NS * kFwdBM * S::PA);
  int* sRow = reinterpret_cast<int*>(sBias + 64);
  int* sFixList = sRow + kFwdBM;                              // bf16 only
  float* sFixRes = reinterpret_cast<float*>(sFixList + (kThreads / 32) * kFixCap);
  const int z = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3, wm = warp >> 1, wn = warp & 1;
  const int hw = g.H2 * g.W2, M = g.b * hw;
  const float* w = B.wb + (size_t)z * g.NP + g.o2;
  if constexpr (sizeof(T) == 2) {
#pragma unroll 8
    for (int e = tid; e < 288 * 64; e += kThreads)
      sW[(e & 63) * S::PW + (e >> 6)] = Cd<T>::st(w[e]);
  }
  if (tid < 64) sBias[tid] = Cd<T>::rnd(w[288 * 64 + tid]);
  const T* a1 = B.a1 + (size_t)z * g.b * g.H1 * g.W1 * 32;
  T* a2 = B.a2 + (size_t)z * M * 64;

  const int mtiles = (int)cdiv(M, kFwdBM);
  for (int mt = blockIdx.x; mt < mtiles; mt += gridDim.x) {
    const int m0 = mt * kFwdBM;
    __syncthreads();  // the last m-tile's readers of sRow are done
    if (tid < kFwdBM) {
      const int m = m0 + tid;
      int off = -1;
      if (m < M) {
        const int bi = m / hw, r = m - bi * hw, i = r / g.W2, j = r - i * g.W2;
        off = ((bi * g.H1 + i) * g.W1 + j) * 32;
      }
      sRow[tid] = off;
    }
    __syncthreads();
    // A tile kk into ring slot kk % NS; past the last tile an empty group,
    // so that every iteration waits for the same count
    auto stage = [&](int kk) {
      if (kk < 9) {
        const int shift = ((kk / 3) * g.W1 + kk % 3) * 32;
        T* dst = sA + (kk % S::NS) * kFwdBM * S::PA;
        for (int c = tid; c < kFwdBM * CH; c += kThreads) {
          const int r = c / CH, q = c - r * CH, off = sRow[r];
          cp_async16(dst + r * S::PA + q * EL, off >= 0 ? a1 + off + shift + q * EL : a1,
                     off >= 0 ? 16 : 0);
        }
      }
      cp_async_commit();
    };
    // float32: offset kk's w2 slice, loaded into registers a tile ahead and
    // stored, split, after the current tile's MMAs
    float wr[32 * 64 / kThreads];
    auto load_w = [&](int kk) {
#pragma unroll
      for (int e = 0; e < 32 * 64 / kThreads; ++e) wr[e] = w[kk * 32 * 64 + tid + e * kThreads];
    };
    auto store_w = [&](int kk) {
#pragma unroll
      for (int e = 0; e < 32 * 64 / kThreads; ++e) {
        const int at = tid + e * kThreads;  // k = at / 64, n = at % 64
        const int to = (kk & 1) * 64 * S::PA + (at & 63) * S::PA + (at >> 6);
        split_tf32(wr[e], sWbig[to], sWsmall[to]);
      }
    };
    float acc[2][4][4] = {}, mag[2][4][4] = {};
#pragma unroll
    for (int kk = 0; kk < S::NS - 1; ++kk) stage(kk);
    if constexpr (sizeof(T) == 4) {
      load_w(0);
      store_w(0);
    }
    for (int kk = 0; kk < 9; ++kk) {
      cp_async_wait<S::NS - 2>();  // tile kk has landed
      __syncthreads();             // ... for every thread; tile kk - 1 is read
      stage(kk + S::NS - 1);       // into the slot of tile kk - 1
      if constexpr (sizeof(T) == 4)
        if (kk + 1 < 9) load_w(kk + 1);
      if constexpr (sizeof(T) == 2) {
        // this offset's sums in fresh fragments, added to the totals with
        // float32 adds that round to nearest
        float part[2][4][4] = {}, pmag[2][4][4] = {};
        warp_mma_kmajor<T, 2, 4, 32, S::PA, S::PW, true>(
            part, pmag, sA + (kk % S::NS) * kFwdBM * S::PA + wm * 32 * S::PA,
            sW + wn * 32 * S::PW + kk * 32, gq, tq);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[i][j][e] += part[i][j][e];
              mag[i][j][e] += pmag[i][j][e];
            }
      } else {
        const int wb = (kk & 1) * 64 * S::PA + wn * 32 * S::PA;
        warp_mma_kmajor<T, 2, 4, 32, S::PA, S::PA, false, true>(
            acc, mag, sA + (kk % S::NS) * kFwdBM * S::PA + wm * 32 * S::PA,
            reinterpret_cast<const T*>(sWbig + wb), gq, tq, sWsmall + wb);
        if (kk + 1 < 9) store_w(kk + 1);  // the buffer read at kk - 1
      }
    }
    if constexpr (sizeof(T) == 2) {
      // The outputs near a bf16 midpoint, gathered per warp in (element,
      // lane) order and shared out over its lanes: a lane's element q is
      // acc[q / 16][q / 4 % 4][q % 4].
      uint32_t flags = 0;
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        const int m = m0 + wm * 32 + 16 * (q >> 4) + gq + 8 * ((q & 3) >> 1);
        const float x = acc[q >> 4][(q >> 2) & 3][q & 3];
        const float margin = kSerialMargin * mag[q >> 4][(q >> 2) & 3][q & 3];
        // skipped where any rounding of x leaves a2 = relu(x + b) at 0
        const float bias = sBias[wn * 32 + 8 * ((q >> 2) & 3) + 2 * tq + (q & 1)];
        if (m < M && x + fabsf(x) * 0x1p-6f + margin + bias >= 0.f &&
            near_bf16_midpoint(x, margin))
          flags |= 1u << q;
      }
      const uint32_t below = (1u << lane) - 1u;
      int total = 0;
#pragma unroll
      for (int q = 0; q < 32; ++q) total += __popc(__ballot_sync(0xFFFFFFFFu, (flags >> q) & 1u));
      int* list = sFixList + warp * kFixCap;
      float* res = sFixRes + warp * kFixCap;
      for (int b0 = 0; b0 < total; b0 += kFixCap) {
        int base = 0;
#pragma unroll
        for (int q = 0; q < 32; ++q) {
          const uint32_t bq = __ballot_sync(0xFFFFFFFFu, (flags >> q) & 1u);
          const int at = base + __popc(bq & below) - b0;
          if (((flags >> q) & 1u) && at >= 0 && at < kFixCap) list[at] = (lane << 5) | q;
          base += __popc(bq);
        }
        __syncwarp();
        for (int e = lane; e < imin(kFixCap, total - b0); e += 32) {
          const int owner = list[e] >> 5, q = list[e] & 31;
          const int r = wm * 32 + 16 * (q >> 4) + (owner >> 2) + 8 * ((q & 3) >> 1);
          const int n = wn * 32 + 8 * ((q >> 2) & 3) + 2 * (owner & 3) + (q & 1);
          res[e] = conv2_fwd_serial(sA + r * S::PA, kFwdBM * S::PA, sW + n * S::PW);
        }
        __syncwarp();
        base = 0;
#pragma unroll
        for (int q = 0; q < 32; ++q) {
          const uint32_t bq = __ballot_sync(0xFFFFFFFFu, (flags >> q) & 1u);
          const int at = base + __popc(bq & below) - b0;
          if (((flags >> q) & 1u) && at >= 0 && at < kFixCap)
            acc[q >> 4][(q >> 2) & 3][q & 3] = res[at];
          base += __popc(bq);
        }
        __syncwarp();
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + 16 * i + gq + 8 * h;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = wn * 32 + 8 * j + 2 * tq;
          const float v0 = Cd<T>::rnd(Cd<T>::rnd(acc[i][j][2 * h]) + sBias[n]);
          const float v1 = Cd<T>::rnd(Cd<T>::rnd(acc[i][j][2 * h + 1]) + sBias[n + 1]);
          st2(a2 + (size_t)m * 64 + n, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        }
      }
  }
}

// -------------------------------------- conv2 input gradient (tensor cores)
//
// dz1 = (a1 > 0) * sum over offsets kk = 0..8, in that order and in the
// compute type, of rnd(dz2 shifted by kk . w2[kk]^T): an implicit-col2im
// GEMM, M = b H1 W1 conv1 positions, N = 32, K = 9 x 64, one offset per k
// tile. Each offset's product is taken into a fresh fragment and folded into
// the running total as tot = rnd(tot + rnd(part)). A row of a k tile is the
// 64 channels of dz2 at (i - di, j - dj), or zeros where that lies outside
// H2 x W2 (cp.async with source size 0). The B tile of offset kk is w2's
// rows kk * 32..kk * 32 + 31 as they lie ([n = c][k = co]), loaded into
// registers a tile ahead and stored after the current tile's MMAs. m-tiles
// of 128 rows, persistent grid; 8 warps of 16 x 32; two blocks an SM.
constexpr int kDgBM = 128;

template <typename T>
struct DgSmem {
  static constexpr int P = 64 + kPad<T>;  // A and B rows: 68 floats, 72 bf16
  static constexpr int NS = 2;            // A tiles in the ring
  // the A ring, two B tiles, (float32) their small TF32 halves, row table
  static constexpr int kSmallB = sizeof(T) == 4 ? 2 * 32 * P : 0;
  static constexpr size_t kBytes =
      (size_t)(NS * kDgBM + 2 * 32) * P * sizeof(T) + kSmallB * 4 + 3 * kDgBM * sizeof(int);
};

template <typename T>
__global__ void __launch_bounds__(kThreads) conv2_dgrad_kernel(Geo g, Bufs<T> B) {
  using S = DgSmem<T>;
  constexpr int CH = 64 * (int)sizeof(T) / 16;
  constexpr int EL = 16 / (int)sizeof(T);
  constexpr int WPT = 32 * 64 / kThreads;  // w2 values a thread stages per tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sA = reinterpret_cast<T*>(smem_raw);  // [NS][128][P]
  T* sW = sA + S::NS * kDgBM * S::P;       // [2][32][P]; float32: the big TF32 halves
  uint32_t* sWs = reinterpret_cast<uint32_t*>(sW + 2 * 32 * S::P);  // float32: small halves
  int* sI = reinterpret_cast<int*>(sWs + S::kSmallB);
  int* sJ = sI + kDgBM;
  int* sOff = sJ + kDgBM;
  const int z = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int hw = g.H1 * g.W1, M = g.b * hw;
  const float* w = B.wb + (size_t)z * g.NP + g.o2;
  const T* dz2 = B.dz2 + (size_t)z * g.b * g.H2 * g.W2 * 64;
  const T* a1 = B.a1 + (size_t)z * M * 32;
  T* dz1 = B.dz1 + (size_t)z * M * 32;

  const int mtiles = (int)cdiv(M, kDgBM);
  for (int mt = blockIdx.x; mt < mtiles; mt += gridDim.x) {
    const int m0 = mt * kDgBM;
    __syncthreads();
    if (tid < kDgBM) {
      const int m = m0 + tid;
      int i = -4, j = -4, off = 0;  // rows past M read zeros at every offset
      if (m < M) {
        const int bi = m / hw, r = m - bi * hw;
        i = r / g.W1;
        j = r - i * g.W1;
        off = ((bi * g.H2 + i) * g.W2 + j) * 64;
      }
      sI[tid] = i;
      sJ[tid] = j;
      sOff[tid] = off;
    }
    __syncthreads();
    // A tile kk into ring slot kk % NS; past the last tile an empty group
    auto stage_a = [&](int kk) {
      if (kk >= 9) {
        cp_async_commit();
        return;
      }
      const int di = kk / 3, dj = kk % 3, shift = (di * g.W2 + dj) * 64;
      T* dst = sA + (kk % S::NS) * kDgBM * S::P;
      for (int c = tid; c < kDgBM * CH; c += kThreads) {
        const int r = c / CH, q = c - r * CH;
        const int i = sI[r] - di, j = sJ[r] - dj;
        const bool live = i >= 0 && i < g.H2 && j >= 0 && j < g.W2;
        cp_async16(dst + r * S::P + q * EL, live ? dz2 + sOff[r] - shift + q * EL : dz2,
                   live ? 16 : 0);
      }
      cp_async_commit();
    };
    float wr[WPT];
    auto load_w = [&](int kk) {
#pragma unroll
      for (int e = 0; e < WPT; ++e) wr[e] = w[kk * 32 * 64 + tid + e * kThreads];
    };
    auto store_w = [&](int kk) {
#pragma unroll
      for (int e = 0; e < WPT; ++e) {
        const int at = tid + e * kThreads;
        const int to = (kk & 1) * 32 * S::P + (at >> 6) * S::P + (at & 63);
        if constexpr (sizeof(T) == 4) {
          uint32_t big, small;
          split_tf32(wr[e], big, small);
          reinterpret_cast<uint32_t*>(sW)[to] = big;
          sWs[to] = small;
        } else {
          sW[to] = Cd<T>::st(wr[e]);
        }
      }
    };
    float tot[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < S::NS - 1; ++kk) stage_a(kk);
    load_w(0);
    store_w(0);
    for (int kk = 0; kk < 9; ++kk) {
      cp_async_wait<S::NS - 2>();  // tile kk has landed
      __syncthreads();             // ... for every thread; tile kk - 1 is read
      stage_a(kk + S::NS - 1);     // into the slot of tile kk - 1
      if (kk + 1 < 9) load_w(kk + 1);
      float part[1][4][4] = {};
      warp_mma_kmajor<T, 1, 4, 64, S::P, S::P, false, sizeof(T) == 4>(
          part, part, sA + (kk % S::NS) * kDgBM * S::P + warp * 16 * S::P,
          sW + (kk & 1) * 32 * S::P, gq, tq,
          sizeof(T) == 4 ? sWs + (kk & 1) * 32 * S::P : nullptr);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[j][e] = Cd<T>::rnd(tot[j][e] + Cd<T>::rnd(part[0][j][e]));
      if (kk + 1 < 9) store_w(kk + 1);  // the other buffer, read last at kk - 1
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + warp * 16 + gq + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const size_t at = (size_t)m * 32 + 8 * j + 2 * tq;
        st2(dz1 + at, Cd<T>::ld(a1[at]) > 0.f ? tot[j][2 * h] : 0.f,
            Cd<T>::ld(a1[at + 1]) > 0.f ? tot[j][2 * h + 1] : 0.f);
      }
    }
  }
}

// ----------------------------------- conv2 weight gradient (tensor cores)
//
// gw2[kk * 32 + ci][n] = sum over output positions p of a1[p + (di, dj)][ci]
// dz2[p][n], and the bias gradient gb2[n] = sum of dz2[p][n], split over
// positions. A k tile is 4 x 8 output positions of one sample: the block
// stages dz2's 32 rows and a1's 6 x 10 strip (the tile with its halo) once,
// by 16-byte cp.async, two deep, with everything past H1 x W1 or H2 x W2
// zero-filled, and warp kk forms its offset's window from the strip: its
// A operand (32 channels x 32 positions, k-major) and dz2 (B) come by
// ldmatrix.trans in bf16; in float32 the stage is split into its big and
// small TF32 halves once, for all warps. 18 warps, two per offset, each
// 32 rows x 32 columns; one block an SM. Split s takes tiles
// [s tper, (s + 1) tper), as many splits as fill one wave, and writes its
// partial sums to B.part; the bias row is summed as four partial sums a
// column, added in a fixed order; reduce_parts_kernel adds the splits in
// split order.
constexpr int kGwTR = 4, kGwTJ = 8;                  // output rows x columns of a k tile
constexpr int kGwTP = kGwTR * kGwTJ;                 // its 32 positions
constexpr int kGwSR = kGwTR + 2, kGwSJ = kGwTJ + 2;  // the a1 strip with its halo
constexpr int kGwSP = kGwSR * kGwSJ;
constexpr int kGwThreads = 18 * 32;

template <typename T>
struct GwSmem {
  // pitches 40 and 72 elements: float32 fragment loads (position t, channel
  // g) land on t * 8 + g mod 32; bf16 rows of 80 and 144 bytes put the 8
  // rows of an ldmatrix on distinct 16-byte bank groups
  static constexpr int PS = 32 + 8, PD = 64 + 8;
  static constexpr int kStage = kGwSP * PS + kGwTP * PD;  // elements of one stage
  // two stages as copied; float32 also the current stage split into its
  // big and small TF32 halves, once for all nine warps
  static constexpr size_t kBytes = (sizeof(T) == 4 ? 4 : 2) * (size_t)kStage * sizeof(T);
};

__host__ __device__ inline int gw2_tiles(const Geo& g) {
  return g.b * (int)cdiv(g.H2, kGwTR) * (int)cdiv(g.W2, kGwTJ);
}

template <typename T>
__global__ void __launch_bounds__(kGwThreads) conv2_wgrad_kernel(Geo g, Bufs<T> B, int tper) {
  using S = GwSmem<T>;
  constexpr int CHA = 32 * (int)sizeof(T) / 16, CHD = 64 * (int)sizeof(T) / 16;
  constexpr int EL = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stages = reinterpret_cast<T*>(smem_raw);
  uint32_t* sBig = reinterpret_cast<uint32_t*>(stages + 2 * S::kStage);  // float32 only
  uint32_t* sSmall = sBig + S::kStage;
  const int z = blockIdx.y, split = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, kk = tid >> 6, nh = (tid >> 5) & 1, di = kk / 3, dj = kk % 3;
  const int gq = lane >> 2, tq = lane & 3;
  const int tr = (int)cdiv(g.H2, kGwTR), tj = (int)cdiv(g.W2, kGwTJ);
  const int tbeg = split * tper, tend = imin(gw2_tiles(g), tbeg + tper);
  const T* a1 = B.a1 + (size_t)z * g.b * g.H1 * g.W1 * 32;
  const T* dz2 = B.dz2 + (size_t)z * g.b * g.H2 * g.W2 * 64;

  auto stage = [&](int tile, int buf) {
    const int bi = tile / (tr * tj), rem = tile - bi * tr * tj;
    const int i0 = rem / tj * kGwTR, j0 = (rem % tj) * kGwTJ;
    T* strip = stages + buf * S::kStage;
    T* dz = strip + kGwSP * S::PS;
    for (int c = tid; c < kGwSP * CHA + kGwTP * CHD; c += kGwThreads) {
      if (c < kGwSP * CHA) {
        const int p = c / CHA, q = c - p * CHA, i = i0 + p / kGwSJ, j = j0 + p % kGwSJ;
        const bool live = i < g.H1 && j < g.W1;
        cp_async16(strip + p * S::PS + q * EL,
                   live ? a1 + ((size_t)(bi * g.H1 + i) * g.W1 + j) * 32 + q * EL : a1,
                   live ? 16 : 0);
      } else {
        const int d = c - kGwSP * CHA, p = d / CHD, q = d - p * CHD;
        const int i = i0 + p / kGwTJ, j = j0 + p % kGwTJ;
        const bool live = i < g.H2 && j < g.W2;
        cp_async16(dz + p * S::PD + q * EL,
                   live ? dz2 + ((size_t)(bi * g.H2 + i) * g.W2 + j) * 64 + q * EL : dz2,
                   live ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[2][4][4] = {};
  float bias = 0.f;
  if (tbeg < tend) stage(tbeg, 0);
  for (int tile = tbeg; tile < tend; ++tile) {
    const int buf = (tile - tbeg) & 1;
    if (tile + 1 < tend) {
      stage(tile + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* strip = stages + buf * S::kStage;
    const T* dz = strip + kGwSP * S::PS;
    if constexpr (sizeof(T) == 2) {
      const int q = lane >> 3, rr = lane & 7;
#pragma unroll
      for (int s = 0; s < kGwTP / 16; ++s) {  // positions 16s..16s+15: tile rows 2s, 2s+1
        // A: matrix q is (k half q >> 1, row half q & 1): strip position
        // (2s + (q >> 1) + di, rr + dj), channels 16 i + 8 (q & 1)..
        uint32_t af[2][4];
        const T* arow = strip + ((2 * s + (q >> 1) + di) * kGwSJ + rr + dj) * S::PS + 8 * (q & 1);
        ldsm_x4_trans(af[0], arow);
        ldsm_x4_trans(af[1], arow + 16);
        // B: matrix q is (k half q & 1, n-tile j + (q >> 1)): dz2 row
        // 16s + 8 (q & 1) + rr
        const T* brow = dz + (16 * s + 8 * (q & 1) + rr) * S::PD + 8 * (q >> 1) + 32 * nh;
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, brow + 8 * j);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            step_bf16(acc[i][j], af[i], bf[0], bf[1]);
            step_bf16(acc[i][j + 1], af[i], bf[2], bf[3]);
          }
        }
      }
    } else {
      for (int e = tid; e < S::kStage; e += kGwThreads) split_tf32(strip[e], sBig[e], sSmall[e]);
      __syncthreads();
#pragma unroll 1
      for (int s = 0; s < kGwTR; ++s) {  // positions 8s..8s+7: tile row s
        // a0 (channel g, position t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
        uint32_t ab[2][4], as[2][4];
        const int arow = ((s + di) * kGwSJ + tq + dj) * S::PS + gq;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int at[4] = {arow + 16 * i, arow + 16 * i + 8, arow + 16 * i + 4 * S::PS,
                             arow + 16 * i + 4 * S::PS + 8};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            ab[i][r] = sBig[at[r]];
            as[i][r] = sSmall[at[r]];
          }
        }
        // b0 (position t, n g), b1 (position t+4, n g)
        const int brow = kGwSP * S::PS + (8 * s + tq) * S::PD + gq + 32 * nh;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int b0 = brow + 8 * j, b1 = b0 + 4 * S::PD;
#pragma unroll
          for (int i = 0; i < 2; ++i)
            step_3xtf32(acc[i][j], ab[i], as[i], sBig[b0], sBig[b1], sSmall[b0], sSmall[b1]);
        }
      }
    }
    if (tid < 256)  // column tid % 64, positions 8 (tid / 64)..+7 of the tile
      for (int p = 8 * (tid >> 6); p < 8 * (tid >> 6) + 8; ++p)
        bias += Cd<T>::ld(dz[p * S::PD + (tid & 63)]);
    __syncthreads();  // this buffer is staged again two tiles on
  }
  float* out = B.part + ((size_t)z * gridDim.x + split) * 289 * 64;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = kk * 32 + 16 * i + gq + 8 * h;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        st2(out + m * 64 + 32 * nh + 8 * j + 2 * tq, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
  // the bias row: each column's four partial sums added in a fixed order
  float* parts = reinterpret_cast<float*>(smem_raw);  // the stages are free now
  if (tid < 256) parts[tid] = bias;
  __syncthreads();
  if (tid < 64) out[288 * 64 + tid] = ((parts[tid] + parts[64 + tid]) + parts[128 + tid]) + parts[192 + tid];
}

// ----------------------------------------------------- elementwise kernels

template <typename T>
__global__ void __launch_bounds__(kThreads) conv1_kernel(Geo g, Bufs<T> B) {
  const int z = blockIdx.y;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= g.b * g.H1 * g.W1 * 32) return;
  const int c = idx & 31, pos = idx >> 5;
  const int j1 = pos % g.W1, i1 = (pos / g.W1) % g.H1, bi = pos / (g.W1 * g.H1);
  const float* xs = B.x + ((size_t)z * g.n + (size_t)g.s * g.b + bi) * g.H * g.W;
  const float* w = B.wb + (size_t)z * g.NP + g.o1;
  float acc = 0.f;
  for (int k = 0; k < 9; ++k)
    acc += Cd<T>::rnd(xs[(i1 + k / 3) * g.W + j1 + k % 3]) * Cd<T>::rnd(w[k * 32 + c]);
  const float v = Cd<T>::rnd(Cd<T>::rnd(acc) + Cd<T>::rnd(w[9 * 32 + c]));
  B.a1[((size_t)z * g.b * g.H1 * g.W1 + pos) * 32 + c] = Cd<T>::st(fmaxf(v, 0.f));
}

// index of the first pooled-window element of flat (bi, f) in a2 / dz2
__device__ inline size_t window_base(const Geo& g, int z, int bi, int f) {
  const int p = f >> 6, hp = p / g.Wp, wp = p - hp * g.Wp;
  return (((size_t)(z * g.b + bi) * g.H2 + 2 * hp) * g.W2 + 2 * wp) * 64 + (f & 63);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) pool_fwd_kernel(Geo g, Bufs<T> B) {
  const int z = blockIdx.y;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= g.b * g.F) return;
  const int bi = idx / g.F, f = idx - bi * g.F;
  const size_t w0 = window_base(g, z, bi, f), row = (size_t)g.W2 * 64;
  const float pooled = fmaxf(fmaxf(Cd<T>::ld(B.a2[w0]), Cd<T>::ld(B.a2[w0 + 64])),
                             fmaxf(Cd<T>::ld(B.a2[w0 + row]), Cd<T>::ld(B.a2[w0 + row + 64])));
  float v = pooled;
  if (g.drop1) v = Cd<T>::rnd(v * (keep1(g, B.seeds[z], bi, f) ? g.kv1 : 0.f));
  B.d[(size_t)z * g.b * g.F + idx] = Cd<T>::st(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dense1_epilogue_kernel(Geo g, Bufs<T> B) {
  const int z = blockIdx.y;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= g.b * 128) return;
  const int bi = idx >> 7, n = idx & 127;
  float sum = 0.f;
  for (int s = 0; s < g.s1; ++s) sum += B.part[(((size_t)z * g.s1 + s) * g.b + bi) * 128 + n];
  const float bias = Cd<T>::rnd(B.wb[(size_t)z * g.NP + g.o3 + (size_t)g.F * 128 + n]);
  const float h = fmaxf(Cd<T>::rnd(Cd<T>::rnd(sum) + bias), 0.f);
  float hd = h;
  if (g.drop2) hd = Cd<T>::rnd(h * (keep2(g, B.seeds[z], bi, n) ? g.kv2 : 0.f));
  B.h[(size_t)z * g.b * 128 + idx] = Cd<T>::st(h);
  B.hd[(size_t)z * g.b * 128 + idx] = Cd<T>::st(hd);
}

// dense2 forward, float32 softmax cross-entropy, metrics, dense2 weight
// gradient and dense2 input gradient — one block per client
template <typename T>
__global__ void __launch_bounds__(kThreads) head_kernel(Geo g, Bufs<T> B) {
  extern __shared__ float smem[];
  const int z = blockIdx.x, tid = threadIdx.x, C = g.C, b = g.b;
  float* sHD = smem;             // [b, 128]
  float* sLG = sHD + b * 128;    // [b, C] logits
  float* sDL = sLG + b * C;      // [b, C] dlogits
  float* sPer = sDL + b * C;     // [b]
  float* sCor = sPer + b;        // [b]
  const float* w4 = B.wb + (size_t)z * g.NP + g.o4;
  const int* ys = B.y + (size_t)z * g.n + (size_t)g.s * b;

  for (int e = tid; e < b * 128; e += kThreads)
    sHD[e] = Cd<T>::ld(B.hd[(size_t)z * b * 128 + e]);
  __syncthreads();
  for (int e = tid; e < b * C; e += kThreads) {
    const int bi = e / C, c = e - bi * C;
    float acc = 0.f;
    for (int n = 0; n < 128; ++n) acc += sHD[bi * 128 + n] * Cd<T>::rnd(w4[n * C + c]);
    sLG[e] = Cd<T>::rnd(Cd<T>::rnd(acc) + Cd<T>::rnd(w4[128 * C + c]));
  }
  __syncthreads();
  for (int bi = tid; bi < b; bi += kThreads) {
    const float* row = sLG + bi * C;
    float lmax = row[0];
    int am = 0;
    for (int c = 1; c < C; ++c)
      if (row[c] > lmax) { lmax = row[c]; am = c; }  // first maximum
    float sumex = 0.f;
    for (int c = 0; c < C; ++c) sumex += expf(row[c] - lmax);
    const int yy = ys[bi];
    const bool yok = yy >= 0 && yy < C;
    sPer[bi] = logf(sumex) + lmax - (yok ? row[yy] : 0.f);
    sCor[bi] = (yok && am == yy) ? 1.f : 0.f;
    for (int c = 0; c < C; ++c) {
      const float sm = expf(row[c] - lmax) / sumex;
      sDL[bi * C + c] = Cd<T>::rnd((sm - (c == yy ? 1.f : 0.f)) * g.inv_b);
    }
  }
  __syncthreads();
  if (tid == 0) {
    float loss = 0.f, cor = 0.f;
    for (int bi = 0; bi < b; ++bi) {
      loss += sPer[bi];
      cor += sCor[bi];
    }
    B.met[z * 3 + 0] += loss;
    B.met[z * 3 + 1] += cor;
  }
  float* gw4 = B.g + (size_t)z * g.NP + g.o4;
  for (int e = tid; e < 129 * C; e += kThreads) {
    const int r = e / C, c = e - r * C;
    float acc = 0.f;
    for (int bi = 0; bi < b; ++bi)
      acc += (r < 128 ? sHD[bi * 128 + r] : 1.f) * sDL[bi * C + c];
    gw4[e] = acc;
  }
  for (int e = tid; e < b * 128; e += kThreads) {
    const int bi = e >> 7, n = e & 127;
    float acc = 0.f;
    for (int c = 0; c < C; ++c) acc += sDL[bi * C + c] * Cd<T>::rnd(w4[n * C + c]);
    float v = Cd<T>::rnd(acc);
    if (g.drop2) v = Cd<T>::rnd(v * (keep2(g, B.seeds[z], bi, n) ? g.kv2 : 0.f));
    const size_t at = (size_t)z * b * 128 + e;
    B.dh[at] = Cd<T>::st(Cd<T>::ld(B.h[at]) > 0.f ? v : 0.f);
  }
}

// max-pool backward (first maximum of the window, row-major) and ReLU'
template <typename T>
__global__ void __launch_bounds__(kThreads) pool_bwd_kernel(Geo g, Bufs<T> B) {
  const int z = blockIdx.y;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= g.b * g.F) return;
  const int bi = idx / g.F, f = idx - bi * g.F;
  const size_t w0 = window_base(g, z, bi, f), row = (size_t)g.W2 * 64;
  const size_t at[4] = {w0, w0 + 64, w0 + row, w0 + row + 64};
  float v[4];
  for (int q = 0; q < 4; ++q) v[q] = Cd<T>::ld(B.a2[at[q]]);
  const float pooled = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
  int first = -1;
  for (int q = 3; q >= 0; --q)
    if (v[q] == pooled) first = q;
  const float dd = Cd<T>::ld(B.dd[(size_t)z * g.b * g.F + idx]);
  for (int q = 0; q < 4; ++q)
    B.dz2[at[q]] = Cd<T>::st((q == first && v[q] > 0.f) ? dd : 0.f);
}

// out[z, off + e] = sum over splits of part[z, s, e], in split order
__global__ void __launch_bounds__(kThreads) reduce_parts_kernel(
    const float* part, int splits, int len, float* out, int np, int off) {
  const int z = blockIdx.y;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= len) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += part[((size_t)z * splits + s) * len + e];
  out[(size_t)z * np + off + e] = acc;
}

__global__ void __launch_bounds__(kThreads) sumsq_kernel(const float* g, int np, float* sq) {
  __shared__ float red[kThreads];
  const int z = blockIdx.y, tid = threadIdx.x;
  float acc = 0.f;
  for (int i = blockIdx.x * kThreads + tid; i < np; i += kSqBlocks * kThreads) {
    const float v = g[(size_t)z * np + i];
    acc += v * v;
  }
  red[tid] = acc;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  if (tid == 0) sq[z * kSqBlocks + blockIdx.x] = red[0];
}

// clip scale g / max(1, ||g|| / clip) from the per-client partials, then SGD
__global__ void __launch_bounds__(kThreads) sgd_kernel(Geo g, float* wb, const float* grad,
                                                       const float* sq) {
  __shared__ float s_step;
  const int z = blockIdx.y, tid = threadIdx.x;
  if (tid == 0) {
    float normsq = 0.f;
    for (int j = 0; j < kSqBlocks; ++j) normsq += sq[z * kSqBlocks + j];
    const float scale = g.has_clip ? 1.f / fmaxf(1.f, sqrtf(normsq) / g.clip) : 1.f;
    s_step = g.lr * scale;
  }
  __syncthreads();
  const float step = s_step;
  for (int i = blockIdx.x * kThreads + tid; i < g.NP; i += gridDim.x * kThreads) {
    const size_t at = (size_t)z * g.NP + i;
    wb[at] = wb[at] - step * grad[at];
  }
}

// ------------------------------------------------------------------ host

struct Layout {
  size_t a1, a2, d, h, hd, dh, dd, dz2, dz1, g, part, sq, total;
};

inline size_t align_up(size_t v) { return (v + 255) & ~(size_t)255; }

inline Layout layout(const Geo& g, size_t tsize) {
  Layout L;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off = align_up(off + bytes);
    return at;
  };
  const size_t cl = g.cl, b = g.b;
  const size_t n1 = cl * b * g.H1 * g.W1 * 32, n2 = cl * b * g.H2 * g.W2 * 64;
  L.a1 = take(n1 * tsize);
  L.a2 = take(n2 * tsize);
  L.d = take(cl * b * g.F * tsize);
  L.h = take(cl * b * 128 * tsize);
  L.hd = take(cl * b * 128 * tsize);
  L.dh = take(cl * b * 128 * tsize);
  L.dd = take(cl * b * g.F * tsize);
  L.dz2 = take(n2 * tsize);
  L.dz1 = take(n1 * tsize);
  L.g = take(cl * g.NP * sizeof(float));
  size_t part = cl * g.s1 * b * 128;
  if (cl * g.s2 * 289 * 64 > part) part = cl * g.s2 * 289 * 64;
  if (cl * g.s3 * 10 * 32 > part) part = cl * g.s3 * 10 * 32;
  L.part = take(part * sizeof(float));
  L.sq = take(cl * kSqBlocks * sizeof(float));
  L.total = off;
  return L;
}

template <class P, class Bs>
inline P problem(const Geo& g, const Bs& B, int M, int N, int K) {
  P p;
  p.g = g;
  p.B = B;
  p.M = M;
  p.N = N;
  p.K = K;
  p.splits = 1;
  p.kper = K;
  return p;
}

template <int BM, int BN, int BK, int TM, int TN, class P>
cudaError_t launch_gemm(const P& p, int cl, cudaStream_t st) {
  const dim3 grid((unsigned)cdiv(p.M, BM), (unsigned)cdiv(p.N, BN), (unsigned)(cl * p.splits));
  auto kfn = gemm_kernel<BM, BN, BK, TM, TN, P>;
  LAUNCH(kfn, grid, dim3((BM / TM) * (BN / TN)), 0, st, p);
  return cudaGetLastError();
}

// split-K geometry shared by the workspace layout and the launches
// `sms`: the card's SM count. The conv2 weight gradient runs one block an SM
// (its registers), so its splits are as many as fill one wave.
inline void plan_splits(Geo& g, int sms) {
  GemmShape s;
  s.K = g.F;
  set_split(s, kDense1Splits, 32);
  g.s1 = s.splits;
  const int tiles = gw2_tiles(g);
  g.tper2 = (int)cdiv(tiles, sms > g.cl ? sms / g.cl : 1);
  g.s2 = (int)cdiv(tiles, g.tper2);
  s.K = g.b * g.H1 * g.W1;
  set_split(s, kGw1Splits, 32);
  g.s3 = s.splits;
}

inline int make_geo(Geo& g, int cl, int n, int H, int W, int C, int b, int chunk) {
  if (cl <= 0 || b <= 0 || n <= 0 || n % b || chunk <= 0 || b % chunk || C <= 0 ||
      H < 6 || W < 6 || (H - 4) % 2 || (W - 4) % 2 ||
      (long long)b * (H - 2) * (W - 2) * 64 >= (1LL << 31))  // per-client offsets are int
    return kErrGeometry;
  g.cl = cl; g.n = n; g.H = H; g.W = W; g.C = C; g.b = b;
  g.chunk = chunk; g.nchunks = b / chunk; g.steps = n / b;
  g.H1 = H - 2; g.W1 = W - 2; g.H2 = H - 4; g.W2 = W - 4;
  g.Hp = g.H2 / 2; g.Wp = g.W2 / 2; g.F = g.Hp * g.Wp * 64;
  g.o1 = 0;
  g.o2 = g.o1 + 10 * 32;
  g.o3 = g.o2 + 289 * 64;
  g.o4 = g.o3 + (g.F + 1) * 128;
  g.NP = g.o4 + 129 * C;
  g.inv_b = (float)(1.0 / b);
  g.s = 0;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return kErrDevice;
  plan_splits(g, sms);
  return 0;
}

inline size_t head_smem(const Geo& g) {
  return sizeof(float) * ((size_t)g.b * (128 + 2 * g.C) + 2 * g.b);
}

#define CK(expr)                                  \
  do {                                            \
    const cudaError_t e_ = (expr);                \
    if (e_ != cudaSuccess) return (int)e_;        \
  } while (0)

// The conv2 kernels' grids: the forward and input gradient persistent over
// their m-tiles at the occupancy their shared memory allows; shared memory
// above 48 KB opted into first.
struct Conv2Grids {
  dim3 fwd, dg;
};

template <typename T>
int conv2_grids(const Geo& g, Conv2Grids& cv) {
  int dev = 0, sms = 0, nf = 0, nd = 0;
  CK(cudaGetDevice(&dev));
  CK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  CK(cudaFuncSetAttribute(conv2_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                          (int)FwdSmem<T>::kBytes));
  CK(cudaFuncSetAttribute(conv2_dgrad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                          (int)DgSmem<T>::kBytes));
  CK(cudaFuncSetAttribute(conv2_wgrad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                          (int)GwSmem<T>::kBytes));
  CK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nf, conv2_fwd_kernel<T>, kThreads,
                                                   FwdSmem<T>::kBytes));
  CK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nd, conv2_dgrad_kernel<T>, kThreads,
                                                   DgSmem<T>::kBytes));
  if (nf <= 0 || nd <= 0) return kErrSmem;
  cv.fwd = dim3(persistent_blocks((int)cdiv(g.b * g.H2 * g.W2, kFwdBM), sms * nf, g.cl), g.cl);
  cv.dg = dim3(persistent_blocks((int)cdiv(g.b * g.H1 * g.W1, kDgBM), sms * nd, g.cl), g.cl);
  return 0;
}

template <typename T>
int run_epoch(Geo g, Bufs<T> B, cudaStream_t st) {
  const int cl = g.cl, b = g.b;
  const size_t smem = head_smem(g);
  if (smem > 232448) return kErrSmem;
  if (smem > 48 * 1024)
    CK(cudaFuncSetAttribute(head_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)smem));
  const dim3 blk(kThreads);
  Conv2Grids cv;
  if (const int rc = conv2_grids<T>(g, cv)) return rc;
  for (int s = 0; s < g.steps; ++s) {
    g.s = s;
    // ---- forward
    LAUNCH(conv1_kernel<T>, dim3((unsigned)cdiv(b * g.H1 * g.W1 * 32, kThreads), cl), blk, 0,
           st, g, B);
    CK(cudaGetLastError());
    LAUNCH(conv2_fwd_kernel<T>, cv.fwd, blk, FwdSmem<T>::kBytes, st, g, B);
    CK(cudaGetLastError());
    LAUNCH(pool_fwd_kernel<T>, dim3((unsigned)cdiv(b * g.F, kThreads), cl), blk, 0, st, g, B);
    CK(cudaGetLastError());
    {
      auto p = problem<Dense1Fwd<T>>(g, B, b, 128, g.F);
      set_split(p, kDense1Splits, 32);
      CK((launch_gemm<32, 64, 32, 2, 4>(p, cl, st)));
    }
    LAUNCH(dense1_epilogue_kernel<T>, dim3((unsigned)cdiv(b * 128, kThreads), cl), blk, 0, st,
           g, B);
    CK(cudaGetLastError());
    // ---- dense2 + loss + dense2 backward
    LAUNCH(head_kernel<T>, dim3(cl), blk, smem, st, g, B);
    CK(cudaGetLastError());
    // ---- dense1 backward
    CK((launch_gemm<64, 64, 32, 4, 4>(problem<Gw3<T>>(g, B, g.F + 1, 128, b), cl, st)));
    CK((launch_gemm<32, 64, 32, 2, 4>(problem<DP3<T>>(g, B, b, g.F, 128), cl, st)));
    // ---- pool + conv2 backward
    LAUNCH(pool_bwd_kernel<T>, dim3((unsigned)cdiv(b * g.F, kThreads), cl), blk, 0, st, g, B);
    CK(cudaGetLastError());
    LAUNCH(conv2_wgrad_kernel<T>, dim3(g.s2, cl), dim3(kGwThreads), GwSmem<T>::kBytes, st, g,
           B, g.tper2);
    CK(cudaGetLastError());
    LAUNCH(reduce_parts_kernel, dim3((unsigned)cdiv(289 * 64, kThreads), cl), blk, 0, st, B.part,
           g.s2, 289 * 64, B.g, g.NP, g.o2);
    CK(cudaGetLastError());
    LAUNCH(conv2_dgrad_kernel<T>, cv.dg, blk, DgSmem<T>::kBytes, st, g, B);
    CK(cudaGetLastError());
    // ---- conv1 backward
    {
      auto p = problem<Gw1<T>>(g, B, 10, 32, b * g.H1 * g.W1);
      set_split(p, kGw1Splits, 32);
      CK((launch_gemm<16, 32, 32, 1, 2>(p, cl, st)));
      LAUNCH(reduce_parts_kernel, dim3((unsigned)cdiv(10 * 32, kThreads), cl), blk, 0, st,
             B.part, p.splits, 10 * 32, B.g, g.NP, g.o1);
      CK(cudaGetLastError());
    }
    // ---- global-norm clip + SGD
    LAUNCH(sumsq_kernel, dim3(kSqBlocks, cl), blk, 0, st, B.g, g.NP, B.sq);
    CK(cudaGetLastError());
    LAUNCH(sgd_kernel, dim3((unsigned)cdiv(g.NP, 4 * kThreads), cl), blk, 0, st, g, B.wb, B.g,
           B.sq);
    CK(cudaGetLastError());
  }
  return 0;
}

template <typename T>
Bufs<T> carve(const Geo& g, void* ws, const float* x, const int* y, const uint32_t* seeds,
              float* wb, float* met) {
  const Layout L = layout(g, sizeof(T));
  char* base = static_cast<char*>(ws);
  Bufs<T> B;
  B.x = x; B.y = y; B.seeds = seeds; B.wb = wb; B.met = met;
  B.a1 = reinterpret_cast<T*>(base + L.a1);
  B.a2 = reinterpret_cast<T*>(base + L.a2);
  B.d = reinterpret_cast<T*>(base + L.d);
  B.h = reinterpret_cast<T*>(base + L.h);
  B.hd = reinterpret_cast<T*>(base + L.hd);
  B.dh = reinterpret_cast<T*>(base + L.dh);
  B.dd = reinterpret_cast<T*>(base + L.dd);
  B.dz2 = reinterpret_cast<T*>(base + L.dz2);
  B.dz1 = reinterpret_cast<T*>(base + L.dz1);
  B.g = reinterpret_cast<float*>(base + L.g);
  B.part = reinterpret_cast<float*>(base + L.part);
  B.sq = reinterpret_cast<float*>(base + L.sq);
  return B;
}

}  // namespace

extern "C" long long fused_sgd_workspace_bytes(int clients, int n, int H, int W, int C,
                                               int batch, int bf16) {
  Geo g;
  const int chunk = 1;  // the workspace does not depend on the chunk
  const int rc = make_geo(g, clients, n, H, W, C, batch, chunk);
  if (rc) return rc;
  return (long long)layout(g, bf16 ? sizeof(__nv_bfloat16) : sizeof(float)).total;
}

extern "C" int fused_sgd_epoch(const void* x, const void* y, const void* seeds, void* wb,
                               void* met, void* ws, int clients, int n, int H, int W, int C,
                               int batch, int chunk, float lr, float clip, int has_clip,
                               int drop1, unsigned thr1, float kv1, int drop2, unsigned thr2,
                               float kv2, int bf16, void* stream) {
  Geo g;
  const int rc = make_geo(g, clients, n, H, W, C, batch, chunk);
  if (rc) return rc;
  g.lr = lr; g.clip = clip; g.has_clip = has_clip;
  g.drop1 = drop1; g.thr1 = thr1; g.kv1 = kv1;
  g.drop2 = drop2; g.thr2 = thr2; g.kv2 = kv2;
  const auto* xf = static_cast<const float*>(x);
  const auto* yi = static_cast<const int*>(y);
  const auto* sd = static_cast<const uint32_t*>(seeds);
  auto* w = static_cast<float*>(wb);
  auto* m = static_cast<float*>(met);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run_epoch<__nv_bfloat16>(g, carve<__nv_bfloat16>(g, ws, xf, yi, sd, w, m), st);
  return run_epoch<float>(g, carve<float>(g, ws, xf, yi, sd, w, m), st);
}

extern "C" const char* fused_sgd_error_string(int code) {
  if (code == kErrGeometry)
    return "geometry rejected (n % batch, batch % chunk, pool size, or activations of 2**31 "
           "elements or more per client)";
  if (code == kErrDevice) return "no CUDA device to plan the launches for";
  if (code == kErrSmem)
    return "shared memory: batch x classes too large for the head kernel, or a conv2 kernel "
           "cannot be resident";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
