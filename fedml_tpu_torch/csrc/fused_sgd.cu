// Fused local-SGD epoch of CNN_DropOut for Hopper (sm_90a).
//
// Replaces the TPU kernel fedml_tpu/ops/fused_sgd.py::_epoch_kernel
// (pallas_call in fused_epoch, fused_sgd.py:461): one client's whole local
// epoch — conv 3x3 32, conv 3x3 64, ReLU, 2x2 max-pool, dropout, dense 128,
// dropout, dense C, float32 softmax cross-entropy, the backward pass, a
// global-norm clip and SGD — for every client of a round.
//
// What bounds it on this card. At the flagship shape (10 clients x 10 steps
// of batch 20, 28x28, 62 classes) a round is 143.2 GFLOP, 89% of it in conv2
// (forward, its weight gradient and its input gradient), against ~48 MB of
// weights read and written once per round plus ~0.5 MB of data: far above
// the card's operations-per-byte line, so it is bound by operations. The
// float32 path may not use TF32 (it is held to the float32 reference at
// 2e-5), so its floor is the 67 TFLOP/s of the non-tensor float32 units.
//
// Design. The TPU kernel keeps one client's 74 MB working set in VMEM for
// the whole epoch, one grid step per client. A Hopper SM has 227 KB of
// shared memory, and one block per client would leave 122 of 132 SMs idle.
// So here the per-client weights live in one packed float32 row per client
// in device memory (10 x 4.8 MB, mostly L2-resident), seeded once from the
// global weights, and each SGD step is a fixed sequence of kernels, each
// batched over clients (the client is part of blockIdx.z) and tiled over
// outputs so a step fills the card:
//   conv1 -> conv2 (implicit-im2col GEMM, K = 288) -> pool + dropout ->
//   dense1 (split-K GEMM, K = 9216) -> bias/ReLU/dropout -> dense2 + CE +
//   dense2 backward (one block per client) -> dense1 weight gradient ->
//   dense1 input gradient -> pool backward -> conv2 weight gradient
//   (split-K) -> conv2 input gradient (implicit col2im GEMM) -> conv1 weight
//   gradient (split-K) -> per-client sum of squares -> clip + SGD.
// The clip scale stays on the device: there is no host synchronisation
// inside the epoch. The GEMMs are one shared-memory-tiled SIMT template with
// float32 accumulation; tensor cores (wgmma/TMA) are later work. Split-K
// partial sums are reduced in a fixed order, so a run is deterministic.
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
constexpr int kGw2Splits = 20;
constexpr int kGw1Splits = 32;
constexpr int kErrGeometry = -1;
constexpr int kErrSmem = -2;

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
// kBK say that A / B is contiguous along k (loads walk k fastest). With
// kFold, each BK-wide k tile is folded into the running total by P::fold
// (used to sum per-offset partial products in the compute type).

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
  float acc[TM][TN], tot[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = tot[i][j] = 0.f;

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
    if constexpr (P::kFold) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          tot[i][j] = p.fold(tot[i][j], acc[i][j]);
          acc[i][j] = 0.f;
        }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gm = m0 + ty + i * TY, gn = n0 + tx + j * TX;
      if (gm < p.M && gn < p.N)
        p.store(z, split, gm, gn, P::kFold ? tot[i][j] : acc[i][j]);
    }
}

// ------------------------------------------------------- GEMM problems

// conv2 forward: rows = (bi, i, j) output positions, k = (di, dj, ci)
template <typename T>
struct Conv2Fwd : GemmShape {
  static constexpr bool kAK = true, kBK = false, kFold = false;
  Geo g;
  Bufs<T> B;
  __device__ float a(int z, int m, int k) const {
    const int hw = g.H2 * g.W2, bi = m / hw, r = m - bi * hw;
    const int i = r / g.W2, j = r - i * g.W2;
    const int kk = k >> 5, ci = k & 31, di = kk / 3, dj = kk - di * 3;
    return Cd<T>::ld(B.a1[(((size_t)(z * g.b + bi) * g.H1 + i + di) * g.W1 + j + dj) * 32 + ci]);
  }
  __device__ float b(int z, int k, int n) const {
    return Cd<T>::rnd(B.wb[(size_t)z * g.NP + g.o2 + k * 64 + n]);
  }
  __device__ void store(int z, int, int m, int n, float acc) const {
    const float bias = Cd<T>::rnd(B.wb[(size_t)z * g.NP + g.o2 + 288 * 64 + n]);
    const float v = Cd<T>::rnd(Cd<T>::rnd(acc) + bias);
    B.a2[((size_t)z * g.b * g.H2 * g.W2 + m) * 64 + n] = Cd<T>::st(fmaxf(v, 0.f));
  }
};

// dense1 forward, split over K = F: partial sums to B.part
template <typename T>
struct Dense1Fwd : GemmShape {
  static constexpr bool kAK = true, kBK = false, kFold = false;
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
  static constexpr bool kAK = false, kBK = false, kFold = false;
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
  static constexpr bool kAK = true, kBK = true, kFold = false;
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

// conv2 weight + bias gradient: rows (di, dj, ci) then ones, k = positions
template <typename T>
struct Gw2 : GemmShape {
  static constexpr bool kAK = false, kBK = false, kFold = false;
  Geo g;
  Bufs<T> B;
  __device__ float a(int z, int m, int k) const {
    if (m == 288) return 1.f;
    const int hw = g.H2 * g.W2, bi = k / hw, r = k - bi * hw;
    const int i = r / g.W2, j = r - i * g.W2;
    const int kk = m >> 5, ci = m & 31, di = kk / 3, dj = kk - di * 3;
    return Cd<T>::ld(B.a1[(((size_t)(z * g.b + bi) * g.H1 + i + di) * g.W1 + j + dj) * 32 + ci]);
  }
  __device__ float b(int z, int k, int n) const {
    return Cd<T>::ld(B.dz2[((size_t)z * g.b * g.H2 * g.W2 + k) * 64 + n]);
  }
  __device__ void store(int z, int split, int m, int n, float acc) const {
    B.part[(((size_t)z * splits + split) * 289 + m) * 64 + n] = acc;
  }
};

// conv2 input gradient (implicit col2im): rows = conv1 output positions,
// k = (offset kk, co) with BK = 64 so each k tile is one offset; the nine
// per-offset products are summed in the compute type, offset by offset
template <typename T>
struct Da1 : GemmShape {
  static constexpr bool kAK = true, kBK = true, kFold = true;
  Geo g;
  Bufs<T> B;
  __device__ float a(int z, int m, int k) const {
    const int hw = g.H1 * g.W1, bi = m / hw, r = m - bi * hw;
    const int kk = k >> 6, co = k & 63, di = kk / 3, dj = kk - di * 3;
    const int i = r / g.W1 - di, j = r % g.W1 - dj;
    if (i < 0 || i >= g.H2 || j < 0 || j >= g.W2) return 0.f;
    return Cd<T>::ld(B.dz2[(((size_t)(z * g.b + bi) * g.H2 + i) * g.W2 + j) * 64 + co]);
  }
  __device__ float b(int z, int k, int n) const {
    const int kk = k >> 6, co = k & 63;
    return Cd<T>::rnd(B.wb[(size_t)z * g.NP + g.o2 + (kk * 32 + n) * 64 + co]);
  }
  __device__ float fold(float tot, float part) const {
    return Cd<T>::rnd(tot + Cd<T>::rnd(part));
  }
  __device__ void store(int z, int, int m, int n, float tot) const {
    const size_t at = ((size_t)z * g.b * g.H1 * g.W1 + m) * 32 + n;
    B.dz1[at] = Cd<T>::st(Cd<T>::ld(B.a1[at]) > 0.f ? tot : 0.f);
  }
};

// conv1 weight + bias gradient: rows (di, dj) then ones, k = positions
template <typename T>
struct Gw1 : GemmShape {
  static constexpr bool kAK = true, kBK = false, kFold = false;
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
inline void plan_splits(Geo& g) {
  GemmShape s;
  s.K = g.F;
  set_split(s, kDense1Splits, 32);
  g.s1 = s.splits;
  s.K = g.b * g.H2 * g.W2;
  set_split(s, kGw2Splits, 32);
  g.s2 = s.splits;
  s.K = g.b * g.H1 * g.W1;
  set_split(s, kGw1Splits, 32);
  g.s3 = s.splits;
}

inline int make_geo(Geo& g, int cl, int n, int H, int W, int C, int b, int chunk) {
  if (cl <= 0 || b <= 0 || n <= 0 || n % b || chunk <= 0 || b % chunk || C <= 0 ||
      H < 6 || W < 6 || (H - 4) % 2 || (W - 4) % 2)
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
  plan_splits(g);
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

template <typename T>
int run_epoch(Geo g, Bufs<T> B, cudaStream_t st) {
  const int cl = g.cl, b = g.b;
  const size_t smem = head_smem(g);
  if (smem > 232448) return kErrSmem;
  if (smem > 48 * 1024)
    CK(cudaFuncSetAttribute(head_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)smem));
  const dim3 blk(kThreads);
  for (int s = 0; s < g.steps; ++s) {
    g.s = s;
    // ---- forward
    LAUNCH(conv1_kernel<T>, dim3((unsigned)cdiv(b * g.H1 * g.W1 * 32, kThreads), cl), blk, 0,
           st, g, B);
    CK(cudaGetLastError());
    CK((launch_gemm<64, 64, 32, 4, 4>(
        problem<Conv2Fwd<T>>(g, B, b * g.H2 * g.W2, 64, 288), cl, st)));
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
    {
      auto p = problem<Gw2<T>>(g, B, 289, 64, b * g.H2 * g.W2);
      set_split(p, kGw2Splits, 32);
      CK((launch_gemm<64, 64, 32, 4, 4>(p, cl, st)));
      LAUNCH(reduce_parts_kernel, dim3((unsigned)cdiv(289 * 64, kThreads), cl), blk, 0, st,
             B.part, p.splits, 289 * 64, B.g, g.NP, g.o2);
      CK(cudaGetLastError());
    }
    CK((launch_gemm<64, 32, 64, 4, 2>(problem<Da1<T>>(g, B, b * g.H1 * g.W1, 32, 576), cl,
                                      st)));
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
  if (code == kErrGeometry) return "geometry rejected (n % batch, batch % chunk or pool size)";
  if (code == kErrSmem) return "batch x classes too large for the head kernel's shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
