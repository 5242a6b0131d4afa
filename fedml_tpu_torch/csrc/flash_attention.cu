// Flash attention for Hopper (sm_90a): the forward and both blocked
// backward kernels.
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
// dK = ds^T . Q * scale (sweeping query tiles). All arithmetic is float32
// FMA with float32 accumulation, for float and bf16 inputs alike (bf16 is
// widened on load and the outputs rounded once): no TF32, since the float32
// path is held to the JAX kernel's HIGHEST-precision contract (2e-5).
//
// What bounds them on this card. For a causal (b, h) pair of length T and
// head dim D the forward does 2 products of T(T+1)/2 x D multiply-adds
// (dq 3, dkv 4) against 4 T D values moved: at T = 2048, D = 32 that is
// ~250 FLOP per byte, far above the float32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20), so long sequences are bound by operations. At the NWP
// model's T = 20 a (b, h) pair is ~27 kFLOP against ~10 KB: bound by bytes
// on paper, and in practice by the launch, a few microseconds.
//
// Design (simple and right first). One block per (b*h, 64-row tile) with
// 256 threads: 4 threads per row, each holding every 4th column of the
// row's head-dim vectors in registers (D <= 128, so at most 32 per
// thread). The other operand streams through shared memory in 64-row
// tiles (K and V for the forward and dq, Q and dO for dkv); a dot product
// is 4 partial sums joined by two warp shuffles. Causal tiles past the
// diagonal are skipped, and a ragged tail (T not a multiple of 64) is
// masked inside the one tile shape, so any T runs with the same blocks.
// Tensor cores (wgmma, bf16), TMA and reading the strided qkv projection
// directly are later work.
//
// Layout: q, k, v, dO, O, dQ, dK, dV are contiguous [B*H, T, D] in the
// input type; lse and delta are [B*H, T] float32.
//
// C interface (ctypes): flash_fwd, flash_bwd_dq, flash_bwd_dkv (each
// returns the first CUDA error of its launch, 0 on success, or a negative
// code for a shape it rejects) and flash_error_string.

#include <cmath>
#include <cstddef>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;   // rows a block owns: queries (fwd, dq) or keys (dkv)
constexpr int kTile = 64;   // rows of the streamed operand per shared-memory tile
constexpr int kLanes = 4;   // threads per owned row
constexpr int kThreads = kRows * kLanes;
constexpr int kErrHeadDim = -1;
static_assert(kRows == kTile, "the causal tile skipping assumes equal tiles");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Sum over the kLanes adjacent threads that share a row.
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// This thread's columns (lane, lane + 4, ...) of row `row` of a [rows, d]
// matrix, times `mul`; rows and columns out of range read 0.
template <typename T, int DS>
__device__ __forceinline__ void load_row(float (&dst)[DS], const T* src, int row,
                                         int rows, int d, int lane, float mul) {
#pragma unroll
  for (int j = 0; j < DS; ++j) {
    const int c = lane + kLanes * j;
    dst[j] = (row < rows && c < d) ? to_f(src[(size_t)row * d + c]) * mul : 0.f;
  }
}

template <typename T, int DS>
__device__ __forceinline__ void store_row(T* dst, const float (&src)[DS], int row,
                                          int rows, int d, int lane, float mul) {
  if (row >= rows) return;
#pragma unroll
  for (int j = 0; j < DS; ++j) {
    const int c = lane + kLanes * j;
    if (c < d) dst[(size_t)row * d + c] = from_f<T>(src[j] * mul);
  }
}

// Rows [r0, r0 + kTile) of a [rows, d] matrix, times `mul`, into a
// [kTile][DMAX] float tile; rows and columns out of range read 0.
template <typename T, int DMAX>
__device__ __forceinline__ void stage(float* tile, const T* src, int r0, int rows,
                                      int d, float mul) {
  for (int i = threadIdx.x; i < kTile * DMAX; i += kThreads) {
    const int r = i / DMAX, c = i % DMAX;
    tile[i] = (r0 + r < rows && c < d) ? to_f(src[(size_t)(r0 + r) * d + c]) * mul : 0.f;
  }
}

// Partial dot product of this thread's columns with row j of a tile.
template <int DS, int DMAX>
__device__ __forceinline__ float partial_dot(const float (&x)[DS], const float* tile,
                                             int j, int lane) {
  const float* r = tile + j * DMAX + lane;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < DS; ++c) acc = fmaf(x[c], r[c * kLanes], acc);
  return acc;
}

// ---------------------------------------------------------------- forward

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                 int tq, int tk, int d, float scale, int causal) {
  constexpr int DS = DMAX / kLanes;
  extern __shared__ float smem[];
  float* ks = smem;                 // [kTile][DMAX]
  float* vs = smem + kTile * DMAX;  // [kTile][DMAX]
  const int bh = blockIdx.x, q0 = blockIdx.y * kRows;
  const int lane = threadIdx.x % kLanes, qi = q0 + threadIdx.x / kLanes;
  const T* qb = q + (size_t)bh * tq * d;
  const T* kb = k + (size_t)bh * tk * d;
  const T* vb = v + (size_t)bh * tk * d;

  float qr[DS], acc[DS];
  load_row<T, DS>(qr, qb, qi, tq, d, lane, scale);
#pragma unroll
  for (int c = 0; c < DS; ++c) acc[c] = 0.f;
  float m = -INFINITY, l = 0.f;

  int tiles = (tk + kTile - 1) / kTile;
  if (causal) tiles = min(tiles, (q0 + kRows - 1) / kTile + 1);  // past the diagonal: all dead
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    stage<T, DMAX>(ks, kb, k0, tk, d, 1.f);
    stage<T, DMAX>(vs, vb, k0, tk, d, 1.f);
    __syncthreads();

    float s[kTile];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float dot = row_sum(partial_dot<DS, DMAX>(qr, ks, j, lane));
      const int kj = k0 + j;
      s[j] = (kj < tk && (!causal || kj <= qi)) ? dot : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    // exp(-inf - -inf) guard: a row with no live score yet keeps m = -inf
    const float alpha = (m == -INFINITY) ? 1.f : expf(m - m_new);
#pragma unroll
    for (int c = 0; c < DS; ++c) acc[c] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float p = (s[j] == -INFINITY) ? 0.f : expf(s[j] - m_new);
      psum += p;
      const float* vr = vs + j * DMAX + lane;
#pragma unroll
      for (int c = 0; c < DS; ++c) acc[c] = fmaf(p, vr[c * kLanes], acc[c]);
    }
    l = l * alpha + psum;
    m = m_new;
  }
  const float lsafe = fmaxf(l, 1e-30f);
  store_row<T, DS>(o + (size_t)bh * tq * d, acc, qi, tq, d, lane, 1.f / lsafe);
  if (lane == 0 && qi < tq) lse[(size_t)bh * tq + qi] = m + logf(lsafe);
}

// ------------------------------------------------------------ backward dQ

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int tq, int tk, int d, float scale, int causal) {
  constexpr int DS = DMAX / kLanes;
  extern __shared__ float smem[];
  float* ks = smem;                 // [kTile][DMAX]
  float* vs = smem + kTile * DMAX;  // [kTile][DMAX]
  const int bh = blockIdx.x, q0 = blockIdx.y * kRows;
  const int lane = threadIdx.x % kLanes, qi = q0 + threadIdx.x / kLanes;
  const size_t qoff = (size_t)bh * tq * d;
  const T* kb = k + (size_t)bh * tk * d;
  const T* vb = v + (size_t)bh * tk * d;

  float qr[DS], dor[DS], acc[DS];
  load_row<T, DS>(qr, q + qoff, qi, tq, d, lane, scale);
  load_row<T, DS>(dor, dout + qoff, qi, tq, d, lane, 1.f);
#pragma unroll
  for (int c = 0; c < DS; ++c) acc[c] = 0.f;
  const bool row_ok = qi < tq;
  const float lse_i = row_ok ? lse[(size_t)bh * tq + qi] : 0.f;
  const float dl_i = row_ok ? delta[(size_t)bh * tq + qi] : 0.f;

  int tiles = (tk + kTile - 1) / kTile;
  if (causal) tiles = min(tiles, (q0 + kRows - 1) / kTile + 1);
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    stage<T, DMAX>(ks, kb, k0, tk, d, 1.f);
    stage<T, DMAX>(vs, vb, k0, tk, d, 1.f);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float s = row_sum(partial_dot<DS, DMAX>(qr, ks, j, lane));
      const float dp = row_sum(partial_dot<DS, DMAX>(dor, vs, j, lane));
      const int kj = k0 + j;
      const bool live = row_ok && kj < tk && (!causal || kj <= qi);
      const float p = live ? expf(s - lse_i) : 0.f;
      const float ds = p * (dp - dl_i);
      const float* kr = ks + j * DMAX + lane;
#pragma unroll
      for (int c = 0; c < DS; ++c) acc[c] = fmaf(ds, kr[c * kLanes], acc[c]);
    }
  }
  store_row<T, DS>(dq + qoff, acc, qi, tq, d, lane, scale);
}

// -------------------------------------------------------- backward dK, dV

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int tq, int tk, int d,
                     float scale, int causal) {
  constexpr int DS = DMAX / kLanes;
  extern __shared__ float smem[];
  float* qs = smem;                   // [kTile][DMAX], q * scale
  float* dos = smem + kTile * DMAX;   // [kTile][DMAX]
  float* ls = dos + kTile * DMAX;     // [kTile] lse
  float* dls = ls + kTile;            // [kTile] delta
  const int bh = blockIdx.x, k0 = blockIdx.y * kRows;
  const int lane = threadIdx.x % kLanes, kj = k0 + threadIdx.x / kLanes;
  const size_t koff = (size_t)bh * tk * d;
  const T* qb = q + (size_t)bh * tq * d;
  const T* db = dout + (size_t)bh * tq * d;
  const float* lb = lse + (size_t)bh * tq;
  const float* deb = delta + (size_t)bh * tq;

  float kr[DS], vr[DS], dk_acc[DS], dv_acc[DS];
  load_row<T, DS>(kr, k + koff, kj, tk, d, lane, 1.f);
  load_row<T, DS>(vr, v + koff, kj, tk, d, lane, 1.f);
#pragma unroll
  for (int c = 0; c < DS; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  const int tiles = (tq + kTile - 1) / kTile;
  // causal: query tiles that end before this key tile starts are all dead
  for (int t = causal ? k0 / kTile : 0; t < tiles; ++t) {
    const int q0 = t * kTile;
    __syncthreads();
    stage<T, DMAX>(qs, qb, q0, tq, d, scale);
    stage<T, DMAX>(dos, db, q0, tq, d, 1.f);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool ok = q0 + i < tq;
      ls[i] = ok ? lb[q0 + i] : 0.f;
      dls[i] = ok ? deb[q0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      const float s = row_sum(partial_dot<DS, DMAX>(kr, qs, i, lane));
      const float dp = row_sum(partial_dot<DS, DMAX>(vr, dos, i, lane));
      const int qi = q0 + i;
      const bool live = qi < tq && (!causal || kj <= qi);
      const float p = live ? expf(s - ls[i]) : 0.f;
      const float ds = p * (dp - dls[i]);
      const float* qrow = qs + i * DMAX + lane;
      const float* drow = dos + i * DMAX + lane;
#pragma unroll
      for (int c = 0; c < DS; ++c) {
        dv_acc[c] = fmaf(p, drow[c * kLanes], dv_acc[c]);
        dk_acc[c] = fmaf(ds, qrow[c * kLanes], dk_acc[c]);
      }
    }
  }
  // dK = ds^T . (q * scale): the scale rode in with the staged q
  store_row<T, DS>(dk + koff, dk_acc, kj, tk, d, lane, 1.f);
  store_row<T, DS>(dv + koff, dv_acc, kj, tk, d, lane, 1.f);
}

// ---------------------------------------------------------------- launch

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;
  int bh, tq, tk, d, causal;
  float scale;
};

template <typename T, int DMAX>
int fwd(const Args& a, cudaStream_t st) {
  const size_t smem = 2 * kTile * DMAX * sizeof(float);
  auto kernel = flash_fwd_kernel<T, DMAX>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.bh, (a.tq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out0), static_cast<float*>(a.out1), a.tq, a.tk, a.d, a.scale,
      a.causal);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int bwd_dq(const Args& a, cudaStream_t st) {
  const size_t smem = 2 * kTile * DMAX * sizeof(float);
  auto kernel = flash_bwd_dq_kernel<T, DMAX>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.bh, (a.tq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.out0), a.tq, a.tk, a.d,
      a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int bwd_dkv(const Args& a, cudaStream_t st) {
  const size_t smem = (2 * kTile * DMAX + 2 * kTile) * sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<T, DMAX>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.bh, (a.tk + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.out0), static_cast<T*>(a.out1),
      a.tq, a.tk, a.d, a.scale, a.causal);
  return (int)cudaGetLastError();
}

// The instantiation for the input type and the smallest head-dim width
// (32, 64 or 128) that holds d.
template <template <typename, int> class Launch>
int dispatch(const Args& a, int bf16, cudaStream_t st) {
  if (a.d < 1 || a.d > 128) return kErrHeadDim;
  if (a.bh == 0 || a.tq == 0 || a.tk == 0) return 0;
  if (bf16) {
    if (a.d <= 32) return Launch<__nv_bfloat16, 32>::run(a, st);
    if (a.d <= 64) return Launch<__nv_bfloat16, 64>::run(a, st);
    return Launch<__nv_bfloat16, 128>::run(a, st);
  }
  if (a.d <= 32) return Launch<float, 32>::run(a, st);
  if (a.d <= 64) return Launch<float, 64>::run(a, st);
  return Launch<float, 128>::run(a, st);
}

template <typename T, int DMAX>
struct Fwd {
  static int run(const Args& a, cudaStream_t st) { return fwd<T, DMAX>(a, st); }
};
template <typename T, int DMAX>
struct BwdDq {
  static int run(const Args& a, cudaStream_t st) { return bwd_dq<T, DMAX>(a, st); }
};
template <typename T, int DMAX>
struct BwdDkv {
  static int run(const Args& a, cudaStream_t st) { return bwd_dkv<T, DMAX>(a, st); }
};

}  // namespace

extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int bh, int tq, int tk, int d, float scale, int causal, int bf16,
                         void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, o, lse, bh, tq, tk, d, causal, scale};
  return dispatch<Fwd>(a, bf16, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int bh, int tq,
                            int tk, int d, float scale, int causal, int bf16, void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, bh, tq, tk, d, causal, scale};
  return dispatch<BwdDq>(a, bf16, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int bh,
                             int tq, int tk, int d, float scale, int causal, int bf16,
                             void* stream) {
  Args a{q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, causal, scale};
  return dispatch<BwdDkv>(a, bf16, static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_error_string(int code) {
  if (code == kErrHeadDim) return "head dim must be between 1 and 128";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
