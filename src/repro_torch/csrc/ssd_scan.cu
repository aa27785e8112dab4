// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::_kernel (with
// the pre-scale and head-major transposes of its wrapper, ssd_scan.py:
// 179-186, folded into index math here). Contract:
//
//   x (B, S, H, P) in T, dt (B, S, H) fp32, A (H,) fp32, Bm / Cm (B, S, N)
//   in T, all read through the strides the caller passes (the last dim of
//   x, Bm and Cm must be contiguous); y (B, S, H, P) contiguous, in T; when
//   state_out is not null, the fp32 state after the last chunk,
//   (B, H, P, N) contiguous. T is float or bf16.
//
//   The sequence is cut into chunks of Q steps (Q divides S; the wrapper
//   derives it as the reference does). Per chunk, in the TPU kernel's
//   order, with a = dt * A and dtx = dt * x in fp32:
//     cum = cumsum(a) over the chunk, accumulated in fp64: the decays are
//       exp of differences cum_i - cum_j of sums that reach -100 and
//       more, and fp32 sums there keep too few digits (~1e-4 relative
//       error in y at Mamba-2's Q = 128; the differences and the exps are
//       fp32);
//     L[i, j] = exp(cum_i - cum_j) for j <= i, 0 above the diagonal (never
//       evaluated there, where it overflows);
//     y = (L o C B^T) dtx + exp(cum) o (C h^T);
//     h = exp(cum_Q) h + (exp(cum_Q - cum) o dtx)^T B,
//   with h the fp32 (P, N) state, zero before the first chunk.
//
// Layout of the work: the TPU walks the chunks along a sequential grid
// axis with h in VMEM scratch. Hopper blocks run in no order, so one CTA
// owns one (head h, batch row b) and walks the chunks in a loop, h staying
// in shared memory. Each chunk stages B and C (Q x N), dtx (Q x P) and the
// per-step decays in shared memory as fp32 (cum as fp64). Staging L o C
// B^T whole beside them would not fit at Mamba-2's Q = N = 128, P = 64
// (256 KB with h, over the 227 KB a block may use), so it is built 32 rows
// at a time, and each tile's rows of y are finished and written before the
// next is built. h and B rows are padded by one float so that threads of a
// warp, which take neighbouring rows, read distinct banks.
//
// What bounds it on an H100: ~(Q + 4 N) P FLOPs per step and head against
// the 4 P bytes of bf16 x and y (dt, B and C are small; the final state
// adds 4 P N bytes per head and sequence): ~160 FLOPs a byte at Mamba-2's
// shapes, under the card's ~295 for bf16, so the bound is bytes. This
// first version runs every product as fp32 FMAs on the CUDA cores, each
// reading its operands from shared memory, so shared-memory bandwidth
// bounds it instead. Tensor cores (mma.sync / wgmma) for the four products
// are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRowTile = 32;                 // rows of L o C B^T per tile
constexpr int kMaxChunk = 128;               // the scan's warp holds 4 steps a lane
constexpr int kMaxSmem = 232448;             // dynamic shared memory a block may use
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Strides {          // element strides of a (B, S, heads, ...) operand
  long long b, s, h;
};

// Shared memory, in floats, for a (Q, P, N) problem; the kernel's carve-up
// follows the same order.
inline size_t smem_floats(int Q, int P, int N) {
  return 2 * static_cast<size_t>(Q)            // cum (fp64)
         + static_cast<size_t>(P) * (N + 1)    // h
         + static_cast<size_t>(Q) * (N + 1)    // B
         + static_cast<size_t>(Q) * N          // C
         + static_cast<size_t>(Q) * P          // dtx
         + static_cast<size_t>(kRowTile) * Q   // one tile of L o C B^T
         + 3 * static_cast<size_t>(Q);         // dt, exp(cum), exp(cum_Q - cum)
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int P, int N,
                int Q, Strides xs_, Strides dts_, Strides bs_, Strides cs_) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int NB = N + 1;
  double* cum = reinterpret_cast<double*>(smem_raw);   // (Q,)
  float* hs = reinterpret_cast<float*>(cum + Q);       // (P, NB)
  float* bsm = hs + P * NB;                  // (Q, NB)
  float* csm = bsm + Q * NB;                 // (Q, N)
  float* xsm = csm + Q * N;                  // (Q, P): dt * x
  float* msm = xsm + Q * P;                  // (kRowTile, Q)
  float* dts = msm + kRowTile * Q;           // (Q,)
  float* ein = dts + Q;                      // exp(cum)
  float* eout = ein + Q;                     // exp(cum_Q - cum)

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float a_h = A[h];
  const int nc = S / Q;
  const T* xb = x + b * xs_.b + h * xs_.h;
  const float* dtb = dt + b * dts_.b + h * dts_.h;
  const T* bb = Bm + b * bs_.b;
  const T* cb = Cm + b * cs_.b;

  for (int e = tid; e < P * N; e += kThreads) hs[(e / N) * NB + e % N] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int s0 = c * Q;
    __syncthreads();                         // the previous chunk's readers are done
    for (int q = tid; q < Q; q += kThreads) dts[q] = dtb[(s0 + q) * dts_.s];
    __syncthreads();
    for (int e = tid; e < Q * N; e += kThreads) {
      const int q = e / N, n = e % N;
      bsm[q * NB + n] = to_f(bb[(s0 + q) * bs_.s + n]);
      csm[e] = to_f(cb[(s0 + q) * cs_.s + n]);
    }
    for (int e = tid; e < Q * P; e += kThreads) {
      const int q = e / P, p = e % P;
      xsm[e] = to_f(xb[(s0 + q) * xs_.s + p]) * dts[q];
    }
    if (warp == 0) {                         // cum: lane l holds steps 4l .. 4l+3
      double v[4], run = 0.0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = 4 * lane + j;
        run += q < Q ? static_cast<double>(dts[q] * a_h) : 0.0;
        v[j] = run;
      }
      double tot = run;                      // inclusive scan of the lanes' sums
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double t = __shfl_up_sync(kFull, tot, o);
        if (lane >= o) tot += t;
      }
      double before = __shfl_up_sync(kFull, tot, 1);
      if (lane == 0) before = 0.0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * lane + j < Q) cum[4 * lane + j] = before + v[j];
    }
    __syncthreads();
    for (int q = tid; q < Q; q += kThreads) {
      ein[q] = expf(static_cast<float>(cum[q]));
      eout[q] = expf(static_cast<float>(cum[Q - 1] - cum[q]));
    }
    __syncthreads();

    for (int r0 = 0; r0 < Q; r0 += kRowTile) {
      const int R = min(kRowTile, Q - r0);
      const int cols = r0 + R;               // columns past the tile's last row are 0
      for (int e = tid; e < R * cols; e += kThreads) {
        const int i = e / cols, k = e % cols, q = r0 + i;
        float v = 0.f;
        if (k <= q) {
          const float* cr = csm + q * N;
          const float* br = bsm + k * NB;
          float dot = 0.f;
          for (int n = 0; n < N; ++n) dot += cr[n] * br[n];
          v = expf(static_cast<float>(cum[q] - cum[k])) * dot;
        }
        msm[i * Q + k] = v;
      }
      __syncthreads();
      for (int e = tid; e < R * P; e += kThreads) {
        const int i = e / P, p = e % P, q = r0 + i;
        const float* mr = msm + i * Q;
        float acc = 0.f;
        for (int k = 0; k <= q; ++k) acc += mr[k] * xsm[k * P + p];
        if (c > 0) {                         // h is zero before the first chunk
          const float* cr = csm + q * N;
          const float* hr = hs + p * NB;
          float inter = 0.f;
          for (int n = 0; n < N; ++n) inter += cr[n] * hr[n];
          acc += inter * ein[q];
        }
        store(&y[((static_cast<long long>(b) * S + s0 + q) * H + h) * P + p], acc);
      }
      __syncthreads();                       // the tile's readers are done
    }

    if (c + 1 < nc || state_out != nullptr) {
      const float g = expf(static_cast<float>(cum[Q - 1]));
      for (int e = tid; e < P * N; e += kThreads) {
        const int p = e / N, n = e % N;
        float acc = 0.f;
        for (int q = 0; q < Q; ++q) acc += eout[q] * xsm[q * P + p] * bsm[q * NB + n];
        hs[p * NB + n] = hs[p * NB + n] * g + acc;
      }
    }
  }

  if (state_out != nullptr) {                // each thread reads back its own h entries
    float* so = state_out + (static_cast<long long>(b) * H + h) * P * N;
    for (int e = tid; e < P * N; e += kThreads) so[e] = hs[(e / N) * NB + e % N];
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, void* y, float* state_out,
                   int B, int S, int H, int P, int N, int Q, Strides xs,
                   Strides dts, Strides bs, Strides cs, cudaStream_t stream) {
  static bool opted_in = false;              // above 48 KB only by opting in
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const size_t bytes = smem_floats(Q, P, N) * sizeof(float);
  ssd_scan_kernel<T><<<dim3(H, B), kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), state_out, S, H, P, N, Q,
      xs, dts, bs, cs);
  return cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16 (x, Bm, Cm and y alike; dt, A and
// the state are fp32). Strides are in elements: x (b, s, h), dt (b, s, h),
// Bm and Cm (b, s, unused). Q must divide S and be at most 128; state_out
// may be null; the problem's tiles must fit in shared memory (227 KB).
// Returns a cudaError_t; asynchronous on `stream`.
extern "C" int ssd_scan(int dtype_code, const void* x, const float* dt,
                        const float* A, const void* Bm, const void* Cm,
                        void* y, float* state_out, int B, int S, int H, int P,
                        int N, int Q, long long x_sb, long long x_ss,
                        long long x_sh, long long dt_sb, long long dt_ss,
                        long long dt_sh, long long b_sb, long long b_ss,
                        long long c_sb, long long c_ss, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (Q < 1 || Q > kMaxChunk || S % Q || P < 1 || N < 1
      || smem_floats(Q, P, N) * sizeof(float) > static_cast<size_t>(kMaxSmem))
    return cudaErrorInvalidValue;
  const Strides xs{x_sb, x_ss, x_sh}, dts{dt_sb, dt_ss, dt_sh};
  const Strides bs{b_sb, b_ss, 0}, cs{c_sb, c_ss, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0)
    return launch<float>(x, dt, A, Bm, Cm, y, state_out, B, S, H, P, N, Q, xs,
                         dts, bs, cs, s);
  if (dtype_code == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state_out, B, S, H, P,
                                 N, Q, xs, dts, bs, cs, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
