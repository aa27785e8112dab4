// MatrixFlow blocked GEMM for Hopper (sm_90a): the paper's Algorithm 1.
//
// Replaces the Pallas TPU kernels repro/kernels/matrixflow_gemm.py::_kernel
// (mf_gemm_kernel) and ::_kernel_fused_dequant (mf_gemm_dequant_kernel, the
// W8A8 route: int8 operands, int32 accumulation, and the flush writes
// float(acc) * s_a[m] * s_b[n] in the output dtype). Both take the
// block-major operands as they are:
//
//   A_bm (nbm, nbk, bm, bk)   B_bm (nbn, nbk, bk, bn)   ->   C_bm (nbm, nbn, bm, bn)
//   C_bm[i, j] = sum_k A_bm[i, k] @ B_bm[j, k]
//
// One CTA owns one (i, j) C block and walks the K stream inside the CTA:
// the TPU grid's sequential K axis becomes this loop, so nothing carries
// between CTAs and each C block is written exactly once. Every A and B
// block is one contiguous region; the CTA streams it in 32-deep K slices
// with 16-byte loads, staged through registers one slice ahead of the
// shared-memory tile the FMAs read (a two-stage software pipeline).
//
// What bounds it on an H100: the serving path's decode GEMMs have
// M = batch_slots rows, so the weights dominate the bytes and the kernel is
// bound by HBM bandwidth (3.35 TB/s); the row tile shrinks to 16 for those
// so the padding rows cost registers, not bytes. Prefill GEMMs
// (M = slots x prompt bucket) are bound by arithmetic, and this kernel does
// it with plain FMA on the CUDA cores (fp32 accumulate; int32 for int8),
// not on the tensor cores: wgmma and TMA are later work.
//
// The dequant epilogue rounds the exact int32 sum to fp32 with
// __int2float_rn and multiplies by s_a[m], then by s_b[n], each a separate
// round-to-nearest product (__fmul_rn: never contracted), as the plain
// version and the JAX reference do; an int8 GEMM at K = 1536 reaches
// |acc| ~ 2.5e7 > 2^24, so that rounding is part of the contract. It is
// bound like K1: HBM bytes at decode (half of bf16's, the weights being
// int8), CUDA-core integer MACs at prefill; dp4a and the tensor cores'
// s8 mma are later work.
//
// Interface: plain C functions, loaded with ctypes
// (src/repro_torch/kernels/matrixflow_gemm.py checks every argument).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads, each owns a TM x TN sub-tile
constexpr int kSlice = 32;     // K depth of one staged slice (layout.K_SLICE)

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<int8_t> { using type = int; };

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ int to_acc(int8_t x) { return static_cast<int>(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(int* p, int x) { *p = x; }

// One CTA's C block (i = blockIdx.y, j = blockIdx.x) accumulated over the
// whole K stream into acc; thread (tx, ty) owns rows ty + 16 m and columns
// tx + 16 n of the block.
template <typename T, int BM, int BN>
__device__ __forceinline__ void gemm_tile(
    const T* __restrict__ a_bm, const T* __restrict__ b_bm, int nbk, int bk,
    typename AccOf<T>::type (&acc)[BM / 16][BN / 16]) {
  using Acc = typename AccOf<T>::type;
  constexpr int kVec = 16 / sizeof(T);              // elements per 16-byte load
  constexpr int kRowVecs = kSlice / kVec;           // loads per A row slice
  constexpr int kAVecs = BM * kRowVecs;             // loads per A slice
  constexpr int kBVecs = kSlice * BN / kVec;        // loads per B slice (contiguous)
  constexpr int kAPer = (kAVecs + kThreads - 1) / kThreads;
  constexpr int kBPer = (kBVecs + kThreads - 1) / kThreads;
  constexpr int TM = BM / 16, TN = BN / 16;

  __shared__ Acc As[kSlice][BM];   // A slice, K-major so a row is a broadcast
  __shared__ Acc Bs[kSlice][BN];

  const int j = blockIdx.x, i = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int slices = bk / kSlice;
  const int n_steps = nbk * slices;
  const T* a_i = a_bm + static_cast<size_t>(i) * nbk * BM * bk;  // A_bm[i, 0]
  const T* b_j = b_bm + static_cast<size_t>(j) * nbk * bk * BN;  // B_bm[j, 0]

  uint4 ra[kAPer], rb[kBPer];
  auto load = [&](int step) {
    const int k = step / slices, kc = (step % slices) * kSlice;
    const T* a_blk = a_i + static_cast<size_t>(k) * BM * bk;
    const T* b_sl = b_j + static_cast<size_t>(k) * bk * BN + static_cast<size_t>(kc) * BN;
#pragma unroll
    for (int t = 0; t < kAPer; ++t) {
      const int v = tid + t * kThreads;
      if (v < kAVecs) {
        const int r = v / kRowVecs, c = (v % kRowVecs) * kVec;
        ra[t] = *reinterpret_cast<const uint4*>(a_blk + static_cast<size_t>(r) * bk + kc + c);
      }
    }
#pragma unroll
    for (int t = 0; t < kBPer; ++t) {
      const int v = tid + t * kThreads;
      if (v < kBVecs) rb[t] = *reinterpret_cast<const uint4*>(b_sl + static_cast<size_t>(v) * kVec);
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int t = 0; t < kAPer; ++t) {
      const int v = tid + t * kThreads;
      if (v < kAVecs) {
        const int r = v / kRowVecs, c = (v % kRowVecs) * kVec;
        const T* e = reinterpret_cast<const T*>(&ra[t]);
#pragma unroll
        for (int u = 0; u < kVec; ++u) As[c + u][r] = to_acc(e[u]);
      }
    }
#pragma unroll
    for (int t = 0; t < kBPer; ++t) {
      const int v = tid + t * kThreads;
      if (v < kBVecs) {
        const int flat = v * kVec;       // BN % kVec == 0: one row per load
        const int row = flat / BN, col = flat % BN;
        const T* e = reinterpret_cast<const T*>(&rb[t]);
#pragma unroll
        for (int u = 0; u < kVec; ++u) Bs[row][col + u] = to_acc(e[u]);
      }
    }
  };

#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = Acc(0);

  if (n_steps > 0) load(0);
  for (int step = 0; step < n_steps; ++step) {
    stage();
    __syncthreads();
    if (step + 1 < n_steps) load(step + 1);   // next slice in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < kSlice; ++kk) {
      Acc av[TM], bv[TN];
#pragma unroll
      for (int m = 0; m < TM; ++m) av[m] = As[kk][ty + 16 * m];
#pragma unroll
      for (int n = 0; n < TN; ++n) bv[n] = Bs[kk][tx + 16 * n];
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) acc[m][n] += av[m] * bv[n];
    }
    __syncthreads();
  }
}

template <typename T, typename Out, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
mf_gemm_kernel(const T* __restrict__ a_bm, const T* __restrict__ b_bm,
               Out* __restrict__ c_bm, int nbn, int nbk, int bk) {
  typename AccOf<T>::type acc[BM / 16][BN / 16];
  gemm_tile<T, BM, BN>(a_bm, b_bm, nbk, bk, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  Out* c_blk = c_bm + (static_cast<size_t>(blockIdx.y) * nbn + blockIdx.x) * BM * BN;
#pragma unroll
  for (int m = 0; m < BM / 16; ++m)
#pragma unroll
    for (int n = 0; n < BN / 16; ++n) store(&c_blk[(ty + 16 * m) * BN + tx + 16 * n], acc[m][n]);
}

// K2: K1's int8 instance with the dequant fused into the flush. sa holds
// n_sa row scales and sb n_sb channel scales; rows and channels past them
// (the block grid's padding, or a null pointer with n = 0) read a scale of 1.
template <typename Out, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
mf_gemm_dequant_kernel(const int8_t* __restrict__ a_bm, const int8_t* __restrict__ b_bm,
                       const float* __restrict__ sa, int n_sa,
                       const float* __restrict__ sb, int n_sb,
                       Out* __restrict__ c_bm, int nbn, int nbk, int bk) {
  int acc[BM / 16][BN / 16];
  gemm_tile<int8_t, BM, BN>(a_bm, b_bm, nbk, bk, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int i = blockIdx.y, j = blockIdx.x;
  Out* c_blk = c_bm + (static_cast<size_t>(i) * nbn + j) * BM * BN;
#pragma unroll
  for (int m = 0; m < BM / 16; ++m) {
    const int row = i * BM + ty + 16 * m;
    const float s_m = row < n_sa ? sa[row] : 1.f;
#pragma unroll
    for (int n = 0; n < BN / 16; ++n) {
      const int col = j * BN + tx + 16 * n;
      const float s_n = col < n_sb ? sb[col] : 1.f;
      const float c = __fmul_rn(__fmul_rn(__int2float_rn(acc[m][n]), s_m), s_n);
      store(&c_blk[(ty + 16 * m) * BN + tx + 16 * n], c);
    }
  }
}

template <typename T, typename Out>
cudaError_t launch(int bm, int bn, const void* a, const void* b, void* c,
                   int nbm, int nbn, int nbk, int bk, cudaStream_t s) {
  const dim3 grid(nbn, nbm);
#define MF_CASE(BM_, BN_)                                                      \
  if (bm == BM_ && bn == BN_) {                                                \
    mf_gemm_kernel<T, Out, BM_, BN_><<<grid, kThreads, 0, s>>>(                \
        static_cast<const T*>(a), static_cast<const T*>(b),                    \
        static_cast<Out*>(c), nbn, nbk, bk);                                   \
    return cudaGetLastError();                                                 \
  }
  MF_CASE(16, 32) MF_CASE(16, 64) MF_CASE(16, 128)
  MF_CASE(32, 32) MF_CASE(32, 64) MF_CASE(32, 128)
  MF_CASE(64, 32) MF_CASE(64, 64) MF_CASE(64, 128)
#undef MF_CASE
  return cudaErrorInvalidValue;
}

template <typename Out>
cudaError_t launch_dequant(int bm, int bn, const void* a, const void* b, const float* sa,
                           int n_sa, const float* sb, int n_sb, void* c, int nbm, int nbn,
                           int nbk, int bk, cudaStream_t s) {
  const dim3 grid(nbn, nbm);
#define MF_CASE(BM_, BN_)                                                      \
  if (bm == BM_ && bn == BN_) {                                                \
    mf_gemm_dequant_kernel<Out, BM_, BN_><<<grid, kThreads, 0, s>>>(           \
        static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), sa, n_sa,\
        sb, n_sb, static_cast<Out*>(c), nbn, nbk, bk);                         \
    return cudaGetLastError();                                                 \
  }
  MF_CASE(16, 32) MF_CASE(16, 64) MF_CASE(16, 128)
  MF_CASE(32, 32) MF_CASE(32, 64) MF_CASE(32, 128)
  MF_CASE(64, 32) MF_CASE(64, 64) MF_CASE(64, 128)
#undef MF_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// Type codes: 0 = float32, 1 = bfloat16, 2 = int8 (inputs) / int32 (output).
// Returns a cudaError_t; 0 is success. Asynchronous on `stream`.
extern "C" int mf_gemm(int in_code, int out_code, int bm, int bn,
                       const void* a_bm, const void* b_bm, void* c_bm,
                       int nbm, int nbn, int nbk, int bk, void* stream) {
  if (nbm == 0 || nbn == 0) return 0;
  if (bk % kSlice != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_code == 0 && out_code == 0)
    return launch<float, float>(bm, bn, a_bm, b_bm, c_bm, nbm, nbn, nbk, bk, s);
  if (in_code == 1 && out_code == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(bm, bn, a_bm, b_bm, c_bm, nbm, nbn, nbk, bk, s);
  if (in_code == 1 && out_code == 0)
    return launch<__nv_bfloat16, float>(bm, bn, a_bm, b_bm, c_bm, nbm, nbn, nbk, bk, s);
  if (in_code == 2 && out_code == 2)
    return launch<int8_t, int>(bm, bn, a_bm, b_bm, c_bm, nbm, nbn, nbk, bk, s);
  return cudaErrorInvalidValue;
}

// K2: int8 block-major operands, fp32 scales sa (n_sa <= nbm * bm rows)
// and sb (n_sb <= nbn * bn channels), either null with n = 0 (all ones);
// out_code 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int mf_gemm_dequant(int out_code, int bm, int bn, const void* a_bm,
                               const void* b_bm, const float* sa, int n_sa,
                               const float* sb, int n_sb, void* c_bm, int nbm, int nbn,
                               int nbk, int bk, void* stream) {
  if (nbm == 0 || nbn == 0) return 0;
  if (bk % kSlice != 0 || n_sa < 0 || n_sb < 0 || (n_sa > 0 && sa == nullptr) ||
      (n_sb > 0 && sb == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_code == 0)
    return launch_dequant<float>(bm, bn, a_bm, b_bm, sa, n_sa, sb, n_sb, c_bm, nbm, nbn, nbk,
                                 bk, s);
  if (out_code == 1)
    return launch_dequant<__nv_bfloat16>(bm, bn, a_bm, b_bm, sa, n_sa, sb, n_sb, c_bm, nbm,
                                         nbn, nbk, bk, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* mf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
