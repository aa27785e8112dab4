// MatrixFlow blocked GEMM for Hopper (sm_90a): the paper's Algorithm 1.
//
// Replaces the Pallas TPU kernels repro/kernels/matrixflow_gemm.py::_kernel
// (mf_gemm_kernel) and ::_kernel_fused_dequant (mf_gemm_dequant_kernel, the
// W8A8 route: int8 operands, int32 accumulation, and the flush writes
// float(acc) * s_a[m] * s_b[n] in the output dtype). All take the
// block-major operands as they are:
//
//   A_bm (nbm, nbk, bm, bk)   B_bm (nbn, nbk, bk, bn)   ->   C_bm (nbm, nbn, bm, bn)
//   C_bm[i, j] = sum_k A_bm[i, k] @ B_bm[j, k]
//
// A block is row-major inside (A: K contiguous; B: N contiguous, "MN-major"
// in wgmma's terms), so every block, and every 32-deep K slice of one, is
// one contiguous region. The TPU kernel is a jnp.dot on the matrix unit;
// on Hopper that unit is the tensor cores, and bf16 operands go there by
// two routes, picked by bm (core/layout.py::bm_for):
//
// * bm = 64, prefill and encoders: mf_gemm_wgmma_kernel. A CTA owns GM
//   (1 or 2) C blocks along M times TN / bn (TN = 64, 128 or 256) along N,
//   one warpgroup per 64-row block, and runs wgmma.mma_async m64nTNk16
//   (bf16, fp32 accumulate) with both operands in shared memory, B with the
//   transpose bit (MN-major). The K stream arrives through a ring of five
//   32-deep stages filled by 16-byte cp.async into wgmma's 64-byte swizzled
//   layout: a 32-deep K slice of A is one 64-byte row per M row; a 32-wide
//   column strip of B is one 64-byte row per K row, 2 KB per strip. Loads
//   run three stages ahead and one wgmma batch stays in flight while the
//   next is issued. The regime is bound by operations (989 TFLOP/s bf16
//   dense), but a 128 x 128 tile reads 64 FLOP per byte from L2, so the
//   largest tile that still fills the card is taken: 128 x 256 where the
//   grid allows, down to 64 x 64 (bert-base's bn = 32 projections).
// * bm = 16 or 32, decode: mf_gemm_mma_kernel. wgmma would waste 48 of its
//   64 rows, so four warps run mma.sync m16n8k16 fed by ldmatrix (.trans
//   for B) from the same swizzled layout. The bytes of the weights bound
//   this regime (3.35 TB/s), so the kernel is built for bytes in flight:
//   K is split across the four warps (each takes every fourth 32-deep
//   slice, the warps' sums added through shared memory in warp order) and,
//   when the C blocks alone give fewer CTAs than SMs, across up to eight
//   CTAs of one thread-block cluster, whose partial tiles the cluster adds
//   through distributed shared memory in rank order; each CTA keeps a ring
//   of 3-4 stages of 128 K rows in flight.
//
// Every C block is written once, by plain stores; no float atomics, and
// every sum is taken in a fixed order, so results repeat bitwise from run
// to run. Products of bf16 are exact in fp32; the tensor cores add them
// in fp32 (their internal rounding of a k16 group is not round-to-
// nearest, tests/test_torch_cuda.py states the bound it is held to).
//
// The W8A8 GEMM (K2) takes the same two routes with int8 operands and an
// exact int32 sum (1,979 TOP/s int8 dense; at decode half of bf16's bytes):
//
// * bm = 64: mf_gemm_dequant_wgmma_kernel, wgmma.mma_async m64nTNk32
//   (.s32.s8.s8), the CTA tiles, ring and batch in flight of the bf16
//   route. A 32-deep K slice of int8 is 32 bytes, so A's slice is one
//   32-byte row per M row in wgmma's 32-byte swizzle.
// * bm = 16 or 32: mf_gemm_dequant_mma_kernel, mma.sync m16n8k32 (s8 ->
//   s32) with K split over the four warps and up to eight cluster CTAs as
//   on the bf16 route, A by ldmatrix (a b16 pair is two int8 of a row).
//
// B_bm is N-contiguous, and neither route can read that for 8-bit types:
// wgmma takes K-major 8-bit operands only, ldmatrix (.trans too) moves 16-
// bit elements, and the s8 B fragment wants four consecutive K bytes of
// one column in a register. So B's bytes arrive as they lie, by cp.async,
// into a raw slice laid out by 16-column chunk (conflict-free 32-bit reads
// of four K rows at one column word), and are transposed in registers
// four by four with byte permutes (prmt): on the mma route straight into
// the B fragments, where each lane's four columns become one column of
// four n8 tiles (the C columns are permuted back at the flush); on the
// wgmma route into a K-major B tile of TN rows x 32 bytes (32-byte
// swizzle, double-buffered), one pass per K slice that runs beside the
// previous slice's wgmma batch.
//
// fp32 and K1's int8 -> int32 instance keep the CUDA-core routine
// (gemm_tile): one CTA per C block walks K with plain FMA (TF32 stays off,
// so fp32 sums are full fp32) or integer MACs.
//
// K2's flush rounds the exact int32 sum (after the warp and cluster sums)
// to fp32 with __int2float_rn and multiplies by s_a[m], then by s_b[n],
// each a separate round-to-nearest product (__fmul_rn: never contracted),
// as the plain version and the JAX reference do; an int8 GEMM at K = 1536
// reaches |acc| ~ 2.5e7 > 2^24, so that rounding is part of the contract,
// and every route is bitwise the plain version. Rows past n_sa and columns
// past n_sb (the block grid's padding) read a scale of 1.
//
// Interface: plain C functions, loaded with ctypes
// (src/repro_torch/kernels/matrixflow_gemm.py checks every argument and
// picks the tensor-core tile, tc_tile).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// CUDA-core routine: fp32 and int8 operands
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // 16 x 16 threads, each owns a TM x TN sub-tile
constexpr int kSlice = 32;     // K depth of one staged slice (layout.K_SLICE)

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<int8_t> { using type = int; };

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ int to_acc(int8_t x) { return static_cast<int>(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }
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

// Problem blockIdx.z of a batch: its operands and C follow the previous
// problem's in memory (gridDim.y = nbm blocks of A and C per problem).
template <typename T, typename Out, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
mf_gemm_kernel(const T* __restrict__ a_bm, const T* __restrict__ b_bm,
               Out* __restrict__ c_bm, int nbn, int nbk, int bk) {
  const size_t z = blockIdx.z, nbm = gridDim.y;
  a_bm += z * nbm * nbk * BM * bk;
  b_bm += z * nbn * nbk * bk * BN;
  c_bm += z * nbm * nbn * BM * BN;
  typename AccOf<T>::type acc[BM / 16][BN / 16];
  gemm_tile<T, BM, BN>(a_bm, b_bm, nbk, bk, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  Out* c_blk = c_bm + (static_cast<size_t>(blockIdx.y) * nbn + blockIdx.x) * BM * BN;
#pragma unroll
  for (int m = 0; m < BM / 16; ++m)
#pragma unroll
    for (int n = 0; n < BN / 16; ++n) store(&c_blk[(ty + 16 * m) * BN + tx + 16 * n], acc[m][n]);
}

template <typename T, typename Out>
cudaError_t launch(int bm, int bn, const void* a, const void* b, void* c,
                   int nbm, int nbn, int nbk, int bk, int batch, cudaStream_t s) {
  const dim3 grid(nbn, nbm, batch);
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

// ---------------------------------------------------------------------------
// Tensor-core routes: bf16 operands
// ---------------------------------------------------------------------------

constexpr int kTcSlice = 32;    // K rows per staged slice: one 64-byte smem row of A
constexpr int kWgStages = 5;    // wgmma route: ring depth
constexpr int kMaxSplits = 8;   // mma route: CTAs of one cluster sharing a C block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (0..3) of 64-byte row r in wgmma's 64-byte
// swizzle (8 rows x 64 bytes an atom, 512-byte aligned): the chunk index is
// XORed with address bits 7-8, which ldmatrix also reads without conflicts.
__device__ __forceinline__ uint32_t swz64(int r, int c) {
  return static_cast<uint32_t>(r * 64 + ((c ^ ((r >> 1) & 3)) << 4));
}

// B tiles hold 32-wide column strips of 32 K rows, 2 KB each: element
// (k, n) of a slice lies in strip n / 32, row k, chunk (n / 8) % 4.
__device__ __forceinline__ uint32_t b_off(int k, int n) {
  return static_cast<uint32_t>((n >> 5) * 2048) + swz64(k, (n >> 3) & 3);
}

// 16 bytes global -> shared, asynchronous; !valid fills zeros, reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// wgmma shared-memory matrix descriptor, 64-byte swizzle.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// cp.async writes shared memory through the generic proxy; wgmma reads it
// through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int x = 0; x < N; ++x) asm volatile("" : "+f"(d[x]) :: "memory");
}

// D (64 x N, fp32, in registers) += A (64 x 16, K-major) B (16 x N, MN-major).
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int TN> __device__ __forceinline__ void wgmma_tile(
    float (&d)[TN / 2], uint64_t da, uint64_t db) {
  if constexpr (TN == 256) wgmma_m64n256(d, da, db);
  else if constexpr (TN == 128) wgmma_m64n128(d, da, db);
  else wgmma_m64n64(d, da, db);
}

// bm = 64. CTA (x, y) owns C blocks i0 .. i0 + GM - 1 (i0 = y * GM) by
// j0 .. j0 + TN / bn - 1 (j0 = x * TN / bn); blocks past nbm or nbn (a
// ragged group at the grid's edge) read zeros and are not written.
template <typename Out, int GM, int TN>
__global__ void __launch_bounds__(128 * GM)
mf_gemm_wgmma_kernel(const bf16* __restrict__ a_bm, const bf16* __restrict__ b_bm,
                     Out* __restrict__ c_bm, int nbm, int nbn, int nbk, int bk, int bn) {
  constexpr int BM = 64, kT = 128 * GM;
  constexpr int A_BYTES = GM * BM * 64, STAGE = A_BYTES + TN * 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int lg_cpr = __ffs(bn) - 1 - 3;          // log2 of 16-byte chunks per B row
  const int gn = TN / bn;
  const int i0 = blockIdx.y * GM, j0 = blockIdx.x * gn;
  const int spb = bk / kTcSlice, steps = nbk * spb;
  {                           // problem blockIdx.z of a batch
    const size_t z = blockIdx.z;
    a_bm += z * nbm * nbk * BM * bk;
    b_bm += z * nbn * nbk * bk * bn;
    c_bm += z * nbm * nbn * BM * bn;
  }

  auto load = [&](int step, int stage) {
    const int kb = step / spb, kc = (step - kb * spb) * kTcSlice;
    const uint32_t sa = base + stage * STAGE, sb = sa + A_BYTES;
#pragma unroll
    for (int t = 0; t < GM * BM * 4 / kT; ++t) {     // A: GM * 64 rows x 4 chunks
      const int q = tid + t * kT, r = q >> 2, c = q & 3;
      const int i = i0 + (r >> 6);
      const bool ok = i < nbm;
      const bf16* src = a_bm + ((static_cast<size_t>(ok ? i : 0) * nbk + kb) * BM + (r & 63)) *
                                   static_cast<size_t>(bk) + kc + c * 8;
      cp_async16(sa + swz64(r, c), src, ok);
    }
#pragma unroll
    for (int t = 0; t < 4 * TN / kT; ++t) {          // B: 32 rows x TN / 8 chunks
      const int q = tid + t * kT;
      const int jj = q >> (5 + lg_cpr), off = q & ((32 << lg_cpr) - 1);
      const int kr = off >> lg_cpr, c8 = off & ((1 << lg_cpr) - 1);
      const int j = j0 + jj;
      const bool ok = j < nbn;
      const bf16* src = b_bm + ((static_cast<size_t>(ok ? j : 0) * nbk + kb) * bk + kc + kr) *
                                   static_cast<size_t>(bn) + c8 * 8;
      cp_async16(sb + b_off(kr, jj * bn + c8 * 8), src, ok);
    }
  };

  float acc[TN / 2];
#pragma unroll
  for (int x = 0; x < TN / 2; ++x) acc[x] = 0.f;

  // Loads run kWgStages - 2 stages ahead and one wgmma batch stays in
  // flight: at step s the barrier finds every warpgroup past its wait for
  // batch s - 2, whose stage the loads of step s + kWgStages - 2 refill.
#pragma unroll
  for (int s = 0; s < kWgStages - 2; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kWgStages - 3>();
    fence_proxy_async();
    __syncthreads();          // stage s landed; every warpgroup is done with s - 2
    const int nx = s + kWgStages - 2;
    if (nx < steps) load(nx, nx % kWgStages);
    cp_async_commit();
    const uint32_t sa = base + (s % kWgStages) * STAGE + wg * BM * 64;
    const uint32_t sb = base + (s % kWgStages) * STAGE + A_BYTES;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kTcSlice / 16; ++ks)   // A: +32 bytes a k16 step; B: +16 rows
      wgmma_tile<TN>(acc, wg_desc(sa + ks * 32, 16, 512), wg_desc(sb + ks * 1024, 2048, 512));
    wgmma_commit();
    wgmma_wait<1>();          // batch s - 1 is done; batch s runs on
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // Accumulator layout: n8 tile t of warp w, lane l holds rows 16 w + l / 4
  // (+ 8) and columns 8 t + 2 (l % 4) (+ 1).
  const int i = i0 + wg;
  if (i >= nbm) return;
  const int w = (tid >> 5) & 3, l = tid & 31;
  const int r0 = 16 * w + (l >> 2);
#pragma unroll
  for (int t = 0; t < TN / 8; ++t) {
    const int n = 8 * t + 2 * (l & 3);
    const int j = j0 + n / bn, cc = n % bn;
    if (j >= nbn) continue;
    Out* blk = c_bm + (static_cast<size_t>(i) * nbn + j) * BM * bn;
    store2(blk + static_cast<size_t>(r0) * bn + cc, acc[4 * t], acc[4 * t + 1]);
    store2(blk + static_cast<size_t>(r0 + 8) * bn + cc, acc[4 * t + 2], acc[4 * t + 3]);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BM, int BN> struct MmaShape {
  static constexpr int kStages = BN == 128 ? 3 : 4;
  static constexpr int kSliceBytes = (BM + BN) * 64;   // one warp's 32-deep slice
  static constexpr int kStage = 4 * kSliceBytes;       // four warps' slices
  static constexpr int kRed = 4 * BM * BN * 4;         // the warps' fp32 partial tiles
  static constexpr int kSmem =
      1024 + (kStages * kStage > kRed ? kStages * kStage : kRed);
};

// bm = 16 or 32. CTA (j, i, z) owns C block (i, j) and, of the K stream's
// 32-deep slices, the z-th of gridDim.z even shares; warp w takes every
// fourth slice of it. With gridDim.z > 1 the CTAs (j, i, *) form one
// cluster and add their partial tiles in rank order.
template <typename Out, int BM, int BN>
__global__ void __launch_bounds__(128)
mf_gemm_mma_kernel(const bf16* __restrict__ a_bm, const bf16* __restrict__ b_bm,
                   Out* __restrict__ c_bm, int nbn, int nbk, int bk) {
  using S = MmaShape<BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - smem_u32(smem_raw));

  const int tid = threadIdx.x, w = tid >> 5, l = tid & 31;
  const int j = blockIdx.x, i = blockIdx.y, z = blockIdx.z, nz = gridDim.z;
  const int spb = bk / kTcSlice, total = nbk * spb;
  const int lo = static_cast<int>(static_cast<long long>(total) * z / nz);
  const int hi = static_cast<int>(static_cast<long long>(total) * (z + 1) / nz);
  const int chunks = (hi - lo + 3) / 4;
  const bf16* a_i = a_bm + static_cast<size_t>(i) * nbk * BM * bk;
  const bf16* b_j = b_bm + static_cast<size_t>(j) * nbk * bk * BN;

  auto load = [&](int chunk, int stage) {
    const uint32_t st = base + stage * S::kStage;
#pragma unroll
    for (int t = 0; t < BM / 8; ++t) {               // A: 4 slices x BM rows x 4 chunks
      const int q = tid + t * 128;
      const int ws = q / (BM * 4), r = (q >> 2) % BM, c = q & 3;
      const int g = lo + 4 * chunk + ws;
      const bool ok = g < hi;
      const int kb = ok ? g / spb : 0, kc = ok ? (g - kb * spb) * kTcSlice : 0;
      const bf16* src = a_i + (static_cast<size_t>(kb) * BM + r) * bk + kc + c * 8;
      cp_async16(st + ws * S::kSliceBytes + swz64(r, c), src, ok);
    }
    // B: 4 slices x 32 rows x BN / 8 chunks; at 32 x 128 the unrolled
    // addresses beside 128 accumulators would spill
#pragma unroll(BM * BN > 2048 ? 1 : BN / 8)
    for (int t = 0; t < BN / 8; ++t) {
      const int q = tid + t * 128;
      const int ws = q / (4 * BN), off = q % (4 * BN);
      const int kr = off / (BN / 8), c8 = off % (BN / 8);
      const int g = lo + 4 * chunk + ws;
      const bool ok = g < hi;
      const int kb = ok ? g / spb : 0, kc = ok ? (g - kb * spb) * kTcSlice : 0;
      const bf16* src = b_j + (static_cast<size_t>(kb) * bk + kc + kr) * BN + c8 * 8;
      cp_async16(st + ws * S::kSliceBytes + BM * 64 + b_off(kr, c8 * 8), src, ok);
    }
  };

  float acc[BM / 16][BN / 8][4];
#pragma unroll
  for (int m = 0; m < BM / 16; ++m)
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[m][n][x] = 0.f;

#pragma unroll
  for (int s = 0; s < S::kStages - 1; ++s) {
    if (s < chunks) load(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<S::kStages - 2>();
    __syncthreads();          // chunk c landed; every warp is done with c - 1
    const int nx = c + S::kStages - 1;
    if (nx < chunks) load(nx, nx % S::kStages);
    cp_async_commit();
    if (lo + 4 * c + w >= hi) continue;           // this warp's slice is past the share
    const uint32_t sa = base + (c % S::kStages) * S::kStage + w * S::kSliceBytes;
    const uint32_t sb = sa + BM * 64;
#pragma unroll
    for (int ks = 0; ks < kTcSlice / 16; ++ks) {
      uint32_t af[BM / 16][4];
#pragma unroll
      for (int m = 0; m < BM / 16; ++m)             // rows m16 + l % 16, k chunk 2 ks + l / 16
        ldsm_x4(sa + swz64(16 * m + (l & 15), 2 * ks + (l >> 4)), af[m]);
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {        // n8 tiles 2 np and 2 np + 1
        uint32_t bf[4];
        ldsm_x4_trans(sb + b_off(16 * ks + (l & 15), 8 * (2 * np + (l >> 4))), bf);
#pragma unroll
        for (int m = 0; m < BM / 16; ++m) {
          mma_bf16(acc[m][2 * np], af[m], bf[0], bf[1]);
          mma_bf16(acc[m][2 * np + 1], af[m], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();            // the ring is free: it becomes the reduction buffer

  // The four warps' partial tiles, then their sum in warp order.
  float* red = reinterpret_cast<float*>(base_ptr);
  {
    const int g = l >> 2, cq = 2 * (l & 3);
#pragma unroll
    for (int m = 0; m < BM / 16; ++m)
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        float* p = red + w * BM * BN + (16 * m + g) * BN + 8 * n + cq;
        p[0] = acc[m][n][0];
        p[1] = acc[m][n][1];
        p[8 * BN] = acc[m][n][2];
        p[8 * BN + 1] = acc[m][n][3];
      }
  }
  __syncthreads();
  Out* c_blk = c_bm + (static_cast<size_t>(i) * nbn + j) * BM * BN;
  constexpr int E = BM * BN;
  if (nz == 1) {
    for (int e = tid; e < E; e += 128)
      store(&c_blk[e], ((red[e] + red[E + e]) + red[2 * E + e]) + red[3 * E + e]);
    return;
  }
  for (int e = tid; e < E; e += 128)
    red[e] = ((red[e] + red[E + e]) + red[2 * E + e]) + red[3 * E + e];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();             // every rank's partial tile is in its shared memory
  const int e_lo = E * z / nz, e_hi = E * (z + 1) / nz;
  for (int e = e_lo + tid; e < e_hi; e += 128) {
    float v = cluster.map_shared_rank(red, 0)[e];
    for (int r = 1; r < nz; ++r) v += cluster.map_shared_rank(red, r)[e];
    store(&c_blk[e], v);
  }
  cluster.sync();             // no rank leaves while another still reads it
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

template <typename Out, int GM, int TN>
cudaError_t launch_wgmma(const void* a, const void* b, void* c, int nbm, int nbn, int nbk,
                         int bk, int bn, int batch, cudaStream_t s) {
  constexpr int smem = 1024 + kWgStages * (GM * 64 * 64 + TN * 64);
  auto kernel = mf_gemm_wgmma_kernel<Out, GM, TN>;
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((nbn + TN / bn - 1) / (TN / bn), (nbm + GM - 1) / GM, batch);
  kernel<<<grid, 128 * GM, smem, s>>>(static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                                      static_cast<Out*>(c), nbm, nbn, nbk, bk, bn);
  return cudaGetLastError();
}

// Launch an mma-route kernel on (nbn, nbm, splits) CTAs of 128 threads,
// the `splits` CTAs of one C block forming a cluster.
template <class Kernel, class... Args>
cudaError_t launch_split(Kernel kernel, int nbm, int nbn, int splits, int smem, cudaStream_t s,
                         Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nbn, nbm, splits);
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = splits;
  cfg.attrs = cluster;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename Out, int BM, int BN>
cudaError_t launch_mma(const void* a, const void* b, void* c, int nbm, int nbn, int nbk,
                       int bk, int splits, cudaStream_t s) {
  constexpr int smem = MmaShape<BM, BN>::kSmem;
  auto kernel = mf_gemm_mma_kernel<Out, BM, BN>;
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  return launch_split(kernel, nbm, nbn, splits, smem, s, static_cast<const bf16*>(a),
                      static_cast<const bf16*>(b), static_cast<Out*>(c), nbn, nbk, bk);
}

template <typename Out>
cudaError_t launch_tc(int bm, int bn, int gm, int tn, int splits, const void* a, const void* b,
                      void* c, int nbm, int nbn, int nbk, int bk, int batch, cudaStream_t s) {
  if (bm == 64) {
    if (splits != 1 || tn % bn != 0) return cudaErrorInvalidValue;
#define WG_CASE(GM_, TN_)                                                                \
    if (gm == GM_ && tn == TN_)                                                          \
      return launch_wgmma<Out, GM_, TN_>(a, b, c, nbm, nbn, nbk, bk, bn, batch, s);
    WG_CASE(2, 256) WG_CASE(2, 128) WG_CASE(1, 128) WG_CASE(1, 64)
#undef WG_CASE
    return cudaErrorInvalidValue;
  }
  // the mma route's grid z holds its K splits: one problem a launch
  if (batch != 1 || gm != 1 || tn != bn || splits < 1 || splits > kMaxSplits)
    return cudaErrorInvalidValue;
#define MF_CASE(BM_, BN_)                                                      \
  if (bm == BM_ && bn == BN_) return launch_mma<Out, BM_, BN_>(a, b, c, nbm, nbn, nbk, bk, splits, s);
  MF_CASE(16, 32) MF_CASE(16, 64) MF_CASE(16, 128)
  MF_CASE(32, 32) MF_CASE(32, 64) MF_CASE(32, 128)
#undef MF_CASE
  return cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// Tensor-core routes: int8 operands, dequant flush (K2)
// ---------------------------------------------------------------------------

// Byte offset of 16-byte chunk c (0, 1) of 32-byte row r in wgmma's 32-byte
// swizzle (8 rows x 32 bytes an atom, 256-byte aligned): the chunk index is
// XORed with address bit 7, which ldmatrix also reads without conflicts.
__device__ __forceinline__ uint32_t swz32(int r, int c) {
  return static_cast<uint32_t>(r * 32 + ((c ^ ((r >> 2) & 1)) << 4));
}

// A raw int8 B slice: 32 K rows as they lie in B_bm, by 16-column chunk c
// (512 bytes each), K row k of chunk c at 16-byte slot ((k >> 2) & 3) +
// 4 (k >> 4) + 8 (k & 3), XOR 4 for odd c. The four K rows 4 t .. 4 t + 3
// of one column word then sit in distinct bank groups for t = 0..3 and for
// both chunks of a 32-column group, so the reads below are conflict-free.
__device__ __forceinline__ uint32_t raw_b_off(int k, int c) {
  const int slot = (((k >> 2) & 3) | ((k >> 4) << 2) | ((k & 3) << 3)) ^ ((c & 1) << 2);
  return static_cast<uint32_t>(c * 512 + slot * 16);
}

// A 4 x 4 byte transpose by byte permutes: byte r of out[x] is byte x of
// in[r].
__device__ __forceinline__ void transpose4(const uint32_t (&in)[4], uint32_t (&out)[4]) {
  const uint32_t t0 = __byte_perm(in[0], in[1], 0x5140), t1 = __byte_perm(in[0], in[1], 0x7362);
  const uint32_t t2 = __byte_perm(in[2], in[3], 0x5140), t3 = __byte_perm(in[2], in[3], 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

// Byte offset of the 32-bit word holding columns 4 nw .. 4 nw + 3 of K row
// k of a raw slice.
__device__ __forceinline__ uint32_t raw_b_word(int k, int nw) {
  return raw_b_off(k, nw >> 2) + 4 * (nw & 3);
}

// Columns 4 nw .. 4 nw + 3 of K rows k0 .. k0 + 3 of a raw slice: out[x]
// holds K rows k0 .. k0 + 3 (lowest byte first) of column 4 nw + x.
__device__ __forceinline__ void raw_b_cols(const uint8_t* raw, int k0, int nw,
                                           uint32_t (&out)[4]) {
  uint32_t in[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    in[r] = *reinterpret_cast<const uint32_t*>(raw + raw_b_word(k0 + r, nw));
  transpose4(in, out);
}

// The flush: float(acc) * s_m, then * s_n, each rounded to nearest.
__device__ __forceinline__ float dequant(int acc, float s_m, float s_n) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), s_m), s_n);
}
__device__ __forceinline__ float scale_at(const float* s, int n_s, int x) {
  return x < n_s ? s[x] : 1.f;
}

// wgmma shared-memory matrix descriptor, 32-byte swizzle, K-major: 8-row
// groups of 32-byte rows 256 bytes apart (the leading offset is unused).
__device__ __forceinline__ uint64_t wg_desc32(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32) | (3ull << 62);
}

// D (64 x N, s32, in registers) += A (64 x 32, K-major) B (32 x N, K-major).
__device__ __forceinline__ void wgmma_s8_m64n64(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_s8_m64n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_s8_m64n256(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int TN> __device__ __forceinline__ void wgmma_s8_tile(
    int (&d)[TN / 2], uint64_t da, uint64_t db) {
  if constexpr (TN == 256) wgmma_s8_m64n256(d, da, db);
  else if constexpr (TN == 128) wgmma_s8_m64n128(d, da, db);
  else wgmma_s8_m64n64(d, da, db);
}
template <int N> __device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int x = 0; x < N; ++x) asm volatile("" : "+r"(d[x]) :: "memory");
}

// bm = 64: the CTA tiles of mf_gemm_wgmma_kernel. A stage holds GM * 64 A
// rows of one 32-deep K slice (32-byte swizzle) and the raw B slice of TN
// columns; after it lands, the CTA transposes its B into one of two
// K-major B tiles while the previous slice's wgmma batch runs on.
template <typename Out, int GM, int TN>
__global__ void __launch_bounds__(128 * GM)
mf_gemm_dequant_wgmma_kernel(const int8_t* __restrict__ a_bm, const int8_t* __restrict__ b_bm,
                             const float* __restrict__ sa, int n_sa,
                             const float* __restrict__ sb, int n_sb, Out* __restrict__ c_bm,
                             int nbm, int nbn, int nbk, int bk, int bn) {
  constexpr int BM = 64, kT = 128 * GM;
  constexpr int A_BYTES = GM * BM * 32, STAGE = A_BYTES + 32 * TN, BT_BYTES = TN * 32;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - smem_u32(smem_raw));

  const int tid = threadIdx.x, wg = tid >> 7;
  const int lg_cpr = __ffs(bn) - 1 - 4;          // log2 of 16-byte chunks per B row
  const int gn = TN / bn;
  const int i0 = blockIdx.y * GM, j0 = blockIdx.x * gn;
  const int spb = bk / kTcSlice, steps = nbk * spb;

  auto load = [&](int step, int stage) {
    const int kb = step / spb, kc = (step - kb * spb) * kTcSlice;
    const uint32_t sa_s = base + stage * STAGE, sb_s = sa_s + A_BYTES;
    {                                                  // A: GM * 64 rows x 2 chunks
      const int r = tid >> 1, c = tid & 1;
      const int i = i0 + (r >> 6);
      const bool ok = i < nbm;
      const int8_t* src = a_bm + ((static_cast<size_t>(ok ? i : 0) * nbk + kb) * BM + (r & 63)) *
                                     static_cast<size_t>(bk) + kc + c * 16;
      cp_async16(sa_s + swz32(r, c), src, ok);
    }
#pragma unroll
    for (int t = 0; t < 2 * TN / kT; ++t) {            // B: 32 rows x TN / 16 chunks
      const int q = tid + t * kT;
      const int jj = q >> (5 + lg_cpr), off = q & ((32 << lg_cpr) - 1);
      const int kr = off >> lg_cpr, c16 = off & ((1 << lg_cpr) - 1);
      const int j = j0 + jj;
      const bool ok = j < nbn;
      const int8_t* src = b_bm + ((static_cast<size_t>(ok ? j : 0) * nbk + kb) * bk + kc + kr) *
                                     static_cast<size_t>(bn) + c16 * 16;
      cp_async16(sb_s + raw_b_off(kr, (jj << lg_cpr) + c16), src, ok);
    }
  };
  // The raw B slice of `stage` into K-major tile `buf`: thread q takes the
  // 4 x 4 bytes of K rows 4 (q % 8) .. + 3 at column word q / 8, the same
  // ones every slice, so its offsets are computed once. The four lane
  // groups of a warp (nw % 4) store their columns in rotated order (each
  // row word rotated by nw % 4 bytes before the transpose), so the stores,
  // like the loads, fall on distinct banks.
  constexpr int kBlocks = 2 * TN / kT;            // 4 x 4 byte blocks a thread moves a slice
  uint32_t src_off[kBlocks][4], dst_off[kBlocks][4];
  const uint32_t rot = (0x3210u + 0x1111u * ((tid >> 3) & 3)) & 0x3333u;  // nibble c: (c + nw) % 4
#pragma unroll
  for (int t = 0; t < kBlocks; ++t) {
    const int q = tid + t * kT, kg = q & 7, nw = q >> 3;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      src_off[t][r] = raw_b_word(4 * kg + r, nw);
      dst_off[t][r] = swz32(4 * nw + ((r + nw) & 3), kg >> 2) + 4 * (kg & 3);
    }
  }
  auto transpose = [&](int stage, int buf) {
    const uint8_t* raw = base_ptr + stage * STAGE + A_BYTES;
    uint8_t* bt = base_ptr + kWgStages * STAGE + buf * BT_BYTES;
#pragma unroll
    for (int t = 0; t < kBlocks; ++t) {
      uint32_t in[4], o[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        in[r] = __byte_perm(*reinterpret_cast<const uint32_t*>(raw + src_off[t][r]), 0, rot);
      transpose4(in, o);
#pragma unroll
      for (int x = 0; x < 4; ++x) *reinterpret_cast<uint32_t*>(bt + dst_off[t][x]) = o[x];
    }
  };

  int acc[TN / 2];
#pragma unroll
  for (int x = 0; x < TN / 2; ++x) acc[x] = 0;

#pragma unroll
  for (int s = 0; s < kWgStages - 2; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kWgStages - 3>();
    __syncthreads();          // stage s landed; every warpgroup is done with batch s - 2
    const int nx = s + kWgStages - 2;
    if (nx < steps) load(nx, nx % kWgStages);
    cp_async_commit();
    transpose(s % kWgStages, s & 1);
    fence_proxy_async();
    __syncthreads();          // B tile s & 1 (and A of stage s) in place for the async proxy
    const uint32_t a_s = base + (s % kWgStages) * STAGE + wg * BM * 32;
    const uint32_t b_s = base + kWgStages * STAGE + (s & 1) * BT_BYTES;
    fence_acc(acc);
    wgmma_fence();
    wgmma_s8_tile<TN>(acc, wg_desc32(a_s), wg_desc32(b_s));
    wgmma_commit();
    wgmma_wait<1>();          // batch s - 1 is done; batch s runs on
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // Accumulator layout as on the bf16 route.
  const int i = i0 + wg;
  if (i >= nbm) return;
  const int w = (tid >> 5) & 3, l = tid & 31;
  const int r0 = 16 * w + (l >> 2);
  const float s_a0 = scale_at(sa, n_sa, i * BM + r0), s_a1 = scale_at(sa, n_sa, i * BM + r0 + 8);
#pragma unroll
  for (int t = 0; t < TN / 8; ++t) {
    const int n = 8 * t + 2 * (l & 3);
    const int j = j0 + n / bn, cc = n % bn;
    if (j >= nbn) continue;
    const float s_n0 = scale_at(sb, n_sb, j * bn + cc), s_n1 = scale_at(sb, n_sb, j * bn + cc + 1);
    Out* blk = c_bm + (static_cast<size_t>(i) * nbn + j) * BM * bn;
    store2(blk + static_cast<size_t>(r0) * bn + cc, dequant(acc[4 * t], s_a0, s_n0),
           dequant(acc[4 * t + 1], s_a0, s_n1));
    store2(blk + static_cast<size_t>(r0 + 8) * bn + cc, dequant(acc[4 * t + 2], s_a1, s_n0),
           dequant(acc[4 * t + 3], s_a1, s_n1));
  }
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BM, int BN> struct MmaS8Shape {
  static constexpr int kStages = BN == 128 ? 4 : 6;
  static constexpr int kABytes = BM * 32;                // a warp's A slice (32-byte swizzle)
  static constexpr int kSliceBytes = kABytes + 32 * BN;  // then its raw B slice
  static constexpr int kStage = 4 * kSliceBytes;         // four warps' slices
  static constexpr int kRed = 4 * BM * BN * 4;           // the warps' int32 partial tiles
  static constexpr int kSmem =
      1024 + (kStages * kStage > kRed ? kStages * kStage : kRed);
};

// bm = 16 or 32: the CTA, warp and cluster split of mf_gemm_mma_kernel.
// Lane (g, t) of a warp builds the B fragments of a 32-column group from
// column word g: its four columns 4 g .. 4 g + 3 become column g of the
// group's four n8 tiles, so n8 tile x of group u holds real columns
// 32 u + 4 v + x (v = 0..7).
template <typename Out, int BM, int BN>
__global__ void __launch_bounds__(128)
mf_gemm_dequant_mma_kernel(const int8_t* __restrict__ a_bm, const int8_t* __restrict__ b_bm,
                           const float* __restrict__ sa, int n_sa,
                           const float* __restrict__ sb, int n_sb, Out* __restrict__ c_bm,
                           int nbn, int nbk, int bk) {
  using S = MmaS8Shape<BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - smem_u32(smem_raw));

  const int tid = threadIdx.x, w = tid >> 5, l = tid & 31;
  const int gq = l >> 2, tq = l & 3;
  const int j = blockIdx.x, i = blockIdx.y, z = blockIdx.z, nz = gridDim.z;
  const int spb = bk / kTcSlice, total = nbk * spb;
  const int lo = static_cast<int>(static_cast<long long>(total) * z / nz);
  const int hi = static_cast<int>(static_cast<long long>(total) * (z + 1) / nz);
  const int chunks = (hi - lo + 3) / 4;
  const int8_t* a_i = a_bm + static_cast<size_t>(i) * nbk * BM * bk;
  const int8_t* b_j = b_bm + static_cast<size_t>(j) * nbk * bk * BN;

  auto load = [&](int chunk, int stage) {
    const uint32_t st = base + stage * S::kStage;
#pragma unroll
    for (int t = 0; t < BM / 16; ++t) {                // A: 4 slices x BM rows x 2 chunks
      const int q = tid + t * 128;
      const int ws = q / (BM * 2), r = (q >> 1) % BM, c = q & 1;
      const int g = lo + 4 * chunk + ws;
      const bool ok = g < hi;
      const int kb = ok ? g / spb : 0, kc = ok ? (g - kb * spb) * kTcSlice : 0;
      const int8_t* src = a_i + (static_cast<size_t>(kb) * BM + r) * bk + kc + c * 16;
      cp_async16(st + ws * S::kSliceBytes + swz32(r, c), src, ok);
    }
#pragma unroll
    for (int t = 0; t < BN / 16; ++t) {                // B: 4 slices x 32 rows x BN / 16 chunks
      const int q = tid + t * 128;
      const int ws = q / (2 * BN), off = q % (2 * BN);
      const int kr = off / (BN / 16), c16 = off % (BN / 16);
      const int g = lo + 4 * chunk + ws;
      const bool ok = g < hi;
      const int kb = ok ? g / spb : 0, kc = ok ? (g - kb * spb) * kTcSlice : 0;
      const int8_t* src = b_j + (static_cast<size_t>(kb) * bk + kc + kr) * BN + c16 * 16;
      cp_async16(st + ws * S::kSliceBytes + S::kABytes + raw_b_off(kr, c16), src, ok);
    }
  };

  int acc[BM / 16][BN / 8][4];
#pragma unroll
  for (int m = 0; m < BM / 16; ++m)
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[m][n][x] = 0;

#pragma unroll
  for (int s = 0; s < S::kStages - 1; ++s) {
    if (s < chunks) load(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<S::kStages - 2>();
    __syncthreads();          // chunk c landed; every warp is done with c - 1
    const int nx = c + S::kStages - 1;
    if (nx < chunks) load(nx, nx % S::kStages);
    cp_async_commit();
    if (lo + 4 * c + w >= hi) continue;           // this warp's slice is past the share
    const int off = (c % S::kStages) * S::kStage + w * S::kSliceBytes;
    uint32_t af[BM / 16][4];
#pragma unroll
    for (int m = 0; m < BM / 16; ++m)               // rows 16 m + l % 16, k chunk l / 16
      ldsm_x4(base + off + swz32(16 * m + (l & 15), l >> 4), af[m]);
    const uint8_t* raw = base_ptr + off + S::kABytes;
#pragma unroll
    for (int u = 0; u < BN / 32; ++u) {
      uint32_t b0[4], b1[4];                        // K rows 4 t.., and 16 + 4 t..
      raw_b_cols(raw, 4 * tq, 8 * u + gq, b0);
      raw_b_cols(raw, 16 + 4 * tq, 8 * u + gq, b1);
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int m = 0; m < BM / 16; ++m) mma_s8(acc[m][4 * u + x], af[m], b0[x], b1[x]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();            // the ring is free: it becomes the reduction buffer

  // The four warps' partial tiles at their real columns, then their sum in
  // warp order (int32: exact in any order; the order is fixed all the same).
  int* red = reinterpret_cast<int*>(base_ptr);
#pragma unroll
  for (int m = 0; m < BM / 16; ++m)
#pragma unroll
    for (int u = 0; u < BN / 32; ++u)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int* v = acc[m][4 * u + x];
        int* p = red + w * BM * BN + (16 * m + gq) * BN + 32 * u + 8 * tq + x;
        p[0] = v[0];
        p[4] = v[1];
        p[8 * BN] = v[2];
        p[8 * BN + 4] = v[3];
      }
  __syncthreads();
  Out* c_blk = c_bm + (static_cast<size_t>(i) * nbn + j) * BM * BN;
  constexpr int E = BM * BN;
  auto flush = [&](int e, int v) {
    store(&c_blk[e], dequant(v, scale_at(sa, n_sa, i * BM + e / BN),
                             scale_at(sb, n_sb, j * BN + e % BN)));
  };
  if (nz == 1) {
    for (int e = tid; e < E; e += 128)
      flush(e, ((red[e] + red[E + e]) + red[2 * E + e]) + red[3 * E + e]);
    return;
  }
  for (int e = tid; e < E; e += 128)
    red[e] = ((red[e] + red[E + e]) + red[2 * E + e]) + red[3 * E + e];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();             // every rank's partial tile is in its shared memory
  const int e_lo = E * z / nz, e_hi = E * (z + 1) / nz;
  for (int e = e_lo + tid; e < e_hi; e += 128) {
    int v = cluster.map_shared_rank(red, 0)[e];
    for (int r = 1; r < nz; ++r) v += cluster.map_shared_rank(red, r)[e];
    flush(e, v);
  }
  cluster.sync();             // no rank leaves while another still reads it
}

template <typename Out, int GM, int TN>
cudaError_t launch_dq_wgmma(const void* a, const void* b, const float* sa, int n_sa,
                            const float* sb, int n_sb, void* c, int nbm, int nbn, int nbk,
                            int bk, int bn, cudaStream_t s) {
  constexpr int smem = 1024 + kWgStages * (GM * 64 * 32 + 32 * TN) + 2 * TN * 32;
  auto kernel = mf_gemm_dequant_wgmma_kernel<Out, GM, TN>;
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((nbn + TN / bn - 1) / (TN / bn), (nbm + GM - 1) / GM);
  kernel<<<grid, 128 * GM, smem, s>>>(static_cast<const int8_t*>(a),
                                      static_cast<const int8_t*>(b), sa, n_sa, sb, n_sb,
                                      static_cast<Out*>(c), nbm, nbn, nbk, bk, bn);
  return cudaGetLastError();
}

template <typename Out, int BM, int BN>
cudaError_t launch_dq_mma(const void* a, const void* b, const float* sa, int n_sa,
                          const float* sb, int n_sb, void* c, int nbm, int nbn, int nbk, int bk,
                          int splits, cudaStream_t s) {
  constexpr int smem = MmaS8Shape<BM, BN>::kSmem;
  auto kernel = mf_gemm_dequant_mma_kernel<Out, BM, BN>;
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  return launch_split(kernel, nbm, nbn, splits, smem, s, static_cast<const int8_t*>(a),
                      static_cast<const int8_t*>(b), sa, n_sa, sb, n_sb, static_cast<Out*>(c),
                      nbn, nbk, bk);
}

template <typename Out>
cudaError_t launch_dq(int bm, int bn, int gm, int tn, int splits, const void* a, const void* b,
                      const float* sa, int n_sa, const float* sb, int n_sb, void* c, int nbm,
                      int nbn, int nbk, int bk, cudaStream_t s) {
  if (bm == 64) {
    if (splits != 1 || tn % bn != 0) return cudaErrorInvalidValue;
#define DQ_WG(GM_, TN_)                                                                   \
    if (gm == GM_ && tn == TN_)                                                           \
      return launch_dq_wgmma<Out, GM_, TN_>(a, b, sa, n_sa, sb, n_sb, c, nbm, nbn, nbk, bk, \
                                            bn, s);
    DQ_WG(2, 256) DQ_WG(2, 128) DQ_WG(1, 128) DQ_WG(1, 64)
#undef DQ_WG
    return cudaErrorInvalidValue;
  }
  if (gm != 1 || tn != bn || splits < 1 || splits > kMaxSplits) return cudaErrorInvalidValue;
#define DQ_MMA(BM_, BN_)                                                                 \
  if (bm == BM_ && bn == BN_)                                                            \
    return launch_dq_mma<Out, BM_, BN_>(a, b, sa, n_sa, sb, n_sb, c, nbm, nbn, nbk, bk,   \
                                        splits, s);
  DQ_MMA(16, 32) DQ_MMA(16, 64) DQ_MMA(16, 128)
  DQ_MMA(32, 32) DQ_MMA(32, 64) DQ_MMA(32, 128)
#undef DQ_MMA
  return cudaErrorInvalidValue;
}

}  // namespace

// The CUDA-core instances of K1. Type codes: 0 = float32, 2 = int8 (inputs)
// / int32 (output); bf16 operands take mf_gemm_tc. `batch` problems of one
// geometry lie one after another in a_bm, b_bm and c_bm (the grid's z axis
// walks them, as a vmap of the TPU kernel adds a grid axis); 1 for one.
// Returns a cudaError_t; 0 is success. Asynchronous on `stream`.
extern "C" int mf_gemm(int in_code, int out_code, int bm, int bn,
                       const void* a_bm, const void* b_bm, void* c_bm,
                       int nbm, int nbn, int nbk, int bk, int batch, void* stream) {
  if (nbm == 0 || nbn == 0 || batch == 0) return 0;
  if (bk % kSlice != 0 || batch < 0 || batch > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_code == 0 && out_code == 0)
    return launch<float, float>(bm, bn, a_bm, b_bm, c_bm, nbm, nbn, nbk, bk, batch, s);
  if (in_code == 2 && out_code == 2)
    return launch<int8_t, int>(bm, bn, a_bm, b_bm, c_bm, nbm, nbn, nbk, bk, batch, s);
  return cudaErrorInvalidValue;
}

// The tensor-core instances of K1: bf16 block-major operands, out_code 0 =
// float32, 1 = bfloat16. bm = 64 takes the wgmma route with CTA tiles of gm
// (1, 2) blocks along M by tn (64, 128) columns, splits = 1; bm = 16 or 32
// the mma route with gm = 1, tn = bn and 1..8 K splits. `batch` problems
// as for mf_gemm, on the wgmma route only (the mma route takes 1). Returns
// a cudaError_t; asynchronous on `stream`.
extern "C" int mf_gemm_tc(int out_code, int bm, int bn, int gm, int tn, int splits,
                          const void* a_bm, const void* b_bm, void* c_bm, int nbm, int nbn,
                          int nbk, int bk, int batch, void* stream) {
  if (nbm == 0 || nbn == 0 || batch == 0) return 0;
  if (bk % kTcSlice != 0 || batch < 0 || batch > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_code == 0)
    return launch_tc<float>(bm, bn, gm, tn, splits, a_bm, b_bm, c_bm, nbm, nbn, nbk, bk, batch,
                            s);
  if (out_code == 1)
    return launch_tc<bf16>(bm, bn, gm, tn, splits, a_bm, b_bm, c_bm, nbm, nbn, nbk, bk, batch,
                           s);
  return cudaErrorInvalidValue;
}

// K2 on the tensor cores: int8 block-major operands, fp32 scales sa (n_sa
// <= nbm * bm rows) and sb (n_sb <= nbn * bn channels), either null with
// n = 0 (all ones); out_code 0 = float32, 1 = bfloat16. The tiles and
// splits as mf_gemm_tc's: bm = 64 takes the wgmma route, bm = 16 or 32
// the mma route. Returns a cudaError_t; asynchronous on `stream`.
extern "C" int mf_gemm_dequant(int out_code, int bm, int bn, int gm, int tn, int splits,
                               const void* a_bm, const void* b_bm, const float* sa, int n_sa,
                               const float* sb, int n_sb, void* c_bm, int nbm, int nbn,
                               int nbk, int bk, void* stream) {
  if (nbm == 0 || nbn == 0) return 0;
  if (bk % kTcSlice != 0 || n_sa < 0 || n_sb < 0 || (n_sa > 0 && sa == nullptr) ||
      (n_sb > 0 && sb == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_code == 0)
    return launch_dq<float>(bm, bn, gm, tn, splits, a_bm, b_bm, sa, n_sa, sb, n_sb, c_bm, nbm,
                            nbn, nbk, bk, s);
  if (out_code == 1)
    return launch_dq<bf16>(bm, bn, gm, tn, splits, a_bm, b_bm, sa, n_sa, sb, n_sb, c_bm, nbm,
                           nbn, nbk, bk, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* mf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
