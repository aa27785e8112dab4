// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::_kernel (with
// the pre-scale and head-major transposes of its wrapper, ssd_scan.py:
// 179-186, folded into index math here). Contract:
//
//   x (B, S, H, P) in T, dt (B, S, H) fp32, A (H,) fp32, Bm / Cm (B, S, N)
//   in T, all read through the strides the caller passes (the last dim of
//   x, Bm and Cm must be contiguous); y (B, S, H, P) contiguous, in T; when
//   state_out is not null, the fp32 state after the last step, (B, H, P,
//   N) contiguous. T is float or bf16.
//
//   Per chunk of Q steps, with a = dt * A and dtx = dt * x in fp32:
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
// What bounds it on an H100: ~(Q + 4 N) P FLOPs per step and head against
// the 4 P bytes of bf16 x and y (dt, B and C are small; the final state
// adds 4 P N bytes per head and sequence): ~160 FLOPs a byte at Mamba-2's
// shapes, under the card's ~295 for bf16, so the bound is bytes. Two
// kernels compute it.
//
// fp32 (route cuda_cores, ssd_scan_kernel): one CTA owns one (head h,
// batch row b) and walks the reference's chunks in a loop, every product
// an fp32 FMA on the CUDA cores reading its operands from shared memory,
// so shared-memory bandwidth bounds it (~10x under the CUDA cores' peak).
// It keeps fp32 products throughout, as fp32 K1, K3, K4 and K5 do.
//
// bf16 (routes walk and chunks, ssd_walk_kernel and ssd_segment_*): the
// four products on the tensor cores, mma.sync.m16n8k16 through ldmatrix
// (the warp-tile primitives of attn_mma.cuh). The sequence is tiled by
// kT = 64 steps whatever Q is: the scan's function does not depend on how
// the sequence is cut (the state carries everything across a cut), only
// its rounding does, so Q 1, 37, 100 and 125 run as 64-step tiles with
// the last one ragged, and no 1-step chunk is ever walked. Eight warps own
// a tile: each takes a row block (16 rows) of y with half the p columns,
// and a row block of the state with half of N (P padded to 64, N to 64 or
// 128 with zeros); the two warps of a row block both build its L o C B^T,
// and the two warps that share an SM sub-partition hold row blocks whose
// triangles add up to the same work. Per tile:
//   C B^T      A = C rows (ldmatrix), B operand = B rows (ldmatrix, like K
//              in attention); only the n8 tiles on or below the diagonal;
//   C h^T      the same C fragments against h's rows (hi and lo);
//   L o C B^T  on the accumulator fragments: cum is summed in fp64 and
//              kept as log2(e) cum in fp32 hi + lo, so a difference costs
//              two fp32 subtractions and one exp2 (no fp64 work per
//              element); the exponent is -inf above the diagonal; then fed
//              back as A fragments (two n8 tiles = one k16 step);
//   . dtx      B operand = dtx rows through ldmatrix.trans (like V);
//   state      A = (exp(cum_Q - cum) o dtx)^T through ldmatrix.trans,
//              B operand = B rows through ldmatrix.trans, P x N
//              accumulators a warp holds in registers.
// B and C are bf16 in the models, so C B^T is exact products summed in
// fp32. dtx, L o C B^T, exp(cum_Q - cum) o dtx and h are fp32, and one
// bf16 rounding (2^-9) of any would cost the state its (1e-4, 1e-4)
// bound: each enters as bf16 hi + lo (hi = bf16(v), lo = bf16(v - hi),
// v to ~2^-17), and a product of two such operands takes three mma
// (hi.hi + hi.lo + lo.hi), of one such and one bf16 operand two. The
// hi/lo parts add tensor-core work, not bytes. The state stays in fp32
// registers from tile to tile (h = fma(exp(cum_T), h, S_tile)); its bf16
// hi/lo copy in shared memory feeds C h^T of the next tile.
//
// Routes: walk (a row's tiles fit one segment of seg_tiles tiles, which
// the wrapper sets: kernels/ssd_scan.py SEG_TILES): one CTA per (head,
// row) walks them, h never leaving the SM. chunks (longer rows): the
// tiles are cut into segments of seg_tiles, spread over CTAs
// as the Mamba-2 paper's GPU algorithm does (arXiv:2405.21060, sec. 6-7):
//   1. ssd_segment_state_kernel, one CTA per (head, segment, row) but the
//      last segment: the segment's state from zero (the state products
//      only) and the product of its tiles' exp(cum_T);
//   2. ssd_segment_pass_kernel, elementwise on (P, N): each segment's
//      starting state, h_k+1 = G_k h_k + S_k, in place of S_k;
//   3. ssd_walk_kernel, one CTA per (head, segment, row): the walk from
//      the segment's starting state, y and (last segment) the final state.
// The route and the segments depend on S alone, never on B, and nothing
// sums across CTAs: a row's y and state are the same bits whatever else
// shares the batch, and two launches agree bitwise.
//
// What the design does about the bound: every product is on the tensor
// cores (the CUDA-core kernel spent ~10x the bound in shared-memory
// operand traffic); x, B and C are read once per (head, tile) (B and C
// from L2 after the first head); the chunks route moves one fp32 state
// per (head, segment) through memory, not per chunk. C B^T is recomputed
// by every head's CTA, by both warps of a row block (~20% of a tile's
// mma at Mamba-2's shapes): reading it from memory instead would add a
// launch and a round trip per tile. What bounds it in fact is latency:
// mma.sync runs at ~50 cycles an mma a warp here, at 2 CTAs of 8 warps
// an SM (scripts/torch_k6_ablation.py; PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32: the CUDA-core kernel
// ---------------------------------------------------------------------------
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

constexpr int kThreads = 512;
constexpr int kRowTile = 32;                 // rows of L o C B^T per tile
constexpr int kMaxChunk = 128;               // the scan's warp holds 4 steps a lane
constexpr int kMaxSmem = 232448;             // dynamic shared memory a block may use
constexpr unsigned kFull = 0xffffffffu;

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

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ y,
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
  const float* xb = x + b * xs_.b + h * xs_.h;
  const float* dtb = dt + b * dts_.b + h * dts_.h;
  const float* bb = Bm + b * bs_.b;
  const float* cb = Cm + b * cs_.b;

  for (int e = tid; e < P * N; e += kThreads) hs[(e / N) * NB + e % N] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int s0 = c * Q;
    __syncthreads();                         // the previous chunk's readers are done
    for (int q = tid; q < Q; q += kThreads) dts[q] = dtb[(s0 + q) * dts_.s];
    __syncthreads();
    for (int e = tid; e < Q * N; e += kThreads) {
      const int q = e / N, n = e % N;
      bsm[q * NB + n] = bb[(s0 + q) * bs_.s + n];
      csm[e] = cb[(s0 + q) * cs_.s + n];
    }
    for (int e = tid; e < Q * P; e += kThreads) {
      const int q = e / P, p = e % P;
      xsm[e] = xb[(s0 + q) * xs_.s + p] * dts[q];
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
        y[((static_cast<long long>(b) * S + s0 + q) * H + h) * P + p] = acc;
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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels
// ---------------------------------------------------------------------------

namespace tc {

using attn_mma::bf16;
using attn_mma::ldsm_x4;
using attn_mma::ldsm_x4_trans;
using attn_mma::mma_bf16;
using attn_mma::pack_bf16;
using attn_mma::smem_u32;
using attn_mma::split_bf16;

constexpr int kT = 64;            // steps a tile
constexpr int kWarps = 8;         // warp w: a row block of y and of h, half w / 4 (walk)
constexpr int kThreads = 32 * kWarps;
constexpr int kP = 64;            // P padded (P <= 64)
constexpr int kXRow = 2 * kP + 16;  // bytes of a padded (., P) bf16 row: 9 16-byte chunks

// Shared memory of a CTA for N padded to NP (64 or 128). Rows are padded
// to an odd number of 16-byte chunks, so the eight rows an ldmatrix phase
// reads fall on eight distinct bank groups.
template <int NP> struct Lay {
  static constexpr int kRow = 2 * NP + 16;     // a (., N) bf16 row: B, C, h
  static constexpr int kB = 0;                 // B (kT, NP)
  static constexpr int kC = kB + kT * kRow;    // C (kT, NP)
  static constexpr int kXhi = kC + kT * kRow;  // dtx hi, lo (kT, kP)
  static constexpr int kXlo = kXhi + kT * kXRow;
  static constexpr int kWhi = kXlo + kT * kXRow;   // exp(cum_T - cum) o dtx hi, lo
  static constexpr int kWlo = kWhi + kT * kXRow;
  static constexpr int kHhi = kWlo + kT * kXRow;   // h hi, lo (kP, NP)
  static constexpr int kHlo = kHhi + kP * kRow;
  static constexpr int kCum = kHlo + kP * kRow;    // cum log2(e) as fp32 hi + lo (kT)
  static constexpr int kDt = kCum + 8 * kT;        // dt (kT)
  static constexpr int kEin = kDt + 4 * kT;        // exp(cum)
  static constexpr int kEout = kEin + 4 * kT;      // exp(cum_T - cum)
  static constexpr int kG = kEout + 4 * kT;        // exp(cum_T), one float (16 reserved)
  static constexpr int kBytes = kG + 16;
};

struct Params {
  const bf16* x;            // (B, S, H, P) through x_s*
  const float* dt;          // (B, S, H) through dt_s*
  const float* A;           // (H,)
  const bf16* Bm;           // (B, S, N) through b_s*
  const bf16* Cm;           // (B, S, N) through c_s*
  bf16* y;                  // (B, S, H, P), contiguous
  float* state_out;         // (B, H, P, N) or null
  float* seg_state;         // chunks: (B, H, nseg - 1, P, N)
  float* seg_decay;         // chunks: (B, H, nseg - 1)
  int B, S, H, P, N, seg_tiles, nseg;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss;
  int vec_x, vec_bc;        // rows may be read 16 bytes at a time
};

// B and C of tile rows [s0, s0 + R) into shared memory, zero past R and N.
__device__ __forceinline__ void stage_rows(const bf16* src, long long ss, int s0, int R, int N,
                                           int vec, uint8_t* dst, int row_bytes, int NP) {
  const int chunks = NP / 8;
  if (vec) {
    for (int e = threadIdx.x; e < kT * chunks; e += kThreads) {
      const int q = e / chunks, c = e % chunks;
      const bool ok = q < R && 8 * c < N;
      const bf16* g = ok ? src + (s0 + q) * ss + 8 * c : src;
      attn_mma::cp_async16(smem_u32(dst + q * row_bytes + 16 * c), g, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kT * NP; e += kThreads) {
      const int q = e / NP, n = e % NP;
      const bf16 v = q < R && n < N ? src[(s0 + q) * ss + n] : __float2bfloat16(0.f);
      *reinterpret_cast<bf16*>(dst + q * row_bytes + 2 * n) = v;
    }
  }
}

// Tile t's x, as raw bf16 in 2 chunks of 8 values a thread (chunk e: row
// e / 8, columns 8 (e % 8) ..), and (warp 0) its dt, lane l steps 2l and
// 2l + 1; zero past the tile's R steps and past P. Issued a tile ahead, so
// that the loads' latency hides behind the tile before.
constexpr int kXChunks = kT * kP / 8 / kThreads;
struct TileIn {
  uint4 x[kXChunks];
  float d0, d1;
};
__device__ __forceinline__ void load_tile(const Params& p, const bf16* xb, const float* dtb,
                                          int t, TileIn& in) {
  const int s0 = t * kT, R = min(kT, p.S - s0);
#pragma unroll
  for (int i = 0; i < kXChunks; ++i) {
    const int e = threadIdx.x + kThreads * i, q = e >> 3, p0 = 8 * (e & 7);
    const bf16* src = xb + (s0 + q) * p.x_ss + p0;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (q < R && p0 < p.P) {
      if (p.vec_x) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        uint16_t u[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          u[k] = p0 + k < p.P ? __bfloat16_as_ushort(src[k]) : 0;
        uint32_t wd[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) wd[k] = u[2 * k] | static_cast<uint32_t>(u[2 * k + 1]) << 16;
        v = make_uint4(wd[0], wd[1], wd[2], wd[3]);
      }
    }
    in.x[i] = v;
  }
  if (threadIdx.x < 32) {
    const int q0 = 2 * threadIdx.x;
    in.d0 = q0 < R ? dtb[(s0 + q0) * p.dt_ss] : 0.f;
    in.d1 = q0 + 1 < R ? dtb[(s0 + q0 + 1) * p.dt_ss] : 0.f;
  }
}

// cum log2(e) as an fp32 pair hi + lo (hi = fp32(v), lo = fp32(v - hi)):
// the differences L needs, to ~1 ulp of their fp32 rounding.
__device__ __forceinline__ float2 log2_hi_lo(double cum) {
  const double v = cum * 1.4426950408889634;
  const float hi = static_cast<float>(v);
  return make_float2(hi, static_cast<float>(v - static_cast<double>(hi)));
}

// A warp's part of h (rows 16 rb + .., n8 tiles from hf NP / 16) as bf16 hi
// and lo into shared memory, where C h^T reads it.
template <int NP>
__device__ __forceinline__ void store_h(const float (&hreg)[NP / 16][4], uint8_t* smem, int rb,
                                        int hf, int g4, int t4) {
  using L = Lay<NP>;
#pragma unroll
  for (int j = 0; j < NP / 16; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t hi, lo;
      split_bf16(hreg[j][2 * r], hreg[j][2 * r + 1], hi, lo);
      const int off = (16 * rb + g4 + 8 * r) * L::kRow + 2 * (8 * (hf * NP / 16 + j) + 2 * t4);
      *reinterpret_cast<uint32_t*>(smem + L::kHhi + off) = hi;
      *reinterpret_cast<uint32_t*>(smem + L::kHlo + off) = lo;
    }
}

// The walk over tiles [t0, t1) of (head h, row b): kY computes y (and the
// state when h_out is set or a tile follows); !kY the state alone. h_init
// null: the state starts at zero. On return the state is in h_out (if
// set) and, !kY, the product of the tiles' exp(cum_T) in *decay_out.
template <int NP, bool kY>
__device__ __forceinline__ void walk(const Params& p, uint8_t* smem, int h, int b, int t0,
                                     int t1, const float* h_init, float* h_out,
                                     float* decay_out) {
  using L = Lay<NP>;
  // Warp w owns row block rb and half hf = w / 4: of y, rows
  // 16 rb .. 16 rb + 15 and the p n8 tiles 4 hf .. 4 hf + 3; of the state,
  // rows p = 16 rb .. and the kNH n8 tiles of N from hf kNH.
  constexpr int kNH = NP / 16;     // n8 tiles of the state's N a warp holds
  const int tid = threadIdx.x, w = tid >> 5, l = tid & 31, g4 = l >> 2, t4 = l & 3;
  // warps w and w + 4 share a sub-partition (w % 4): row blocks 0..3 for
  // w < 4 and 3..0 after, so each sub-partition holds one heavy and one light
  // block of the triangle (5 key tiles of C B^T between them)
  const int rb = w < 4 ? w : 7 - w, hf = w >> 2;
  const float a_h = p.A[h];
  const bf16* xb = p.x + b * p.x_sb + h * p.x_sh;
  const float* dtb = p.dt + b * p.dt_sb + h * p.dt_sh;
  const bf16* bb = p.Bm + b * p.b_sb;
  const bf16* cb = p.Cm + b * p.c_sb;
  float2* cum2 = reinterpret_cast<float2*>(smem + L::kCum);
  float* dts = reinterpret_cast<float*>(smem + L::kDt);
  float* ein = reinterpret_cast<float*>(smem + L::kEin);
  float* eout = reinterpret_cast<float*>(smem + L::kEout);
  float* gsm = reinterpret_cast<float*>(smem + L::kG);
  const uint32_t s_base = smem_u32(smem);

  // h: rows p = 16 rb + g4 (+8), columns n = 8 (hf kNH + j) + 2 t4 (+1)
  float hreg[kNH][4];
  bool has_state = h_init != nullptr;
#pragma unroll
  for (int j = 0; j < kNH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pp = 16 * rb + g4 + 8 * (e >> 1), n = 8 * (hf * kNH + j) + 2 * t4 + (e & 1);
      hreg[j][e] = has_state && pp < p.P && n < p.N ? h_init[pp * p.N + n] : 0.f;
    }
  if (kY && has_state) store_h<NP>(hreg, smem, rb, hf, g4, t4);
  float decay = 1.f;
  TileIn in;
  load_tile(p, xb, dtb, t0, in);

  for (int t = t0; t < t1; ++t) {
    const int s0 = t * kT, R = min(kT, p.S - s0);
    const bool need_state = !kY || t + 1 < t1 || h_out != nullptr;
    // --- stage: B (and C) by cp.async; cum from dt by warp 0 (x and dt were
    // loaded a tile ahead)
    stage_rows(bb, p.b_ss, s0, R, p.N, p.vec_bc, smem + L::kB, L::kRow, NP);
    if (kY) stage_rows(cb, p.c_ss, s0, R, p.N, p.vec_bc, smem + L::kC, L::kRow, NP);
    attn_mma::cp_async_commit();
    if (w == 0) {                    // lane l: steps 2l, 2l + 1
      const int q0 = 2 * l, q1 = 2 * l + 1;
      const float d0 = in.d0, d1 = in.d1;
      const double v0 = static_cast<double>(d0 * a_h);
      const double v1 = v0 + static_cast<double>(d1 * a_h);
      double tot = v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(kFull, tot, o);
        if (l >= o) tot += u;
      }
      double before = __shfl_up_sync(kFull, tot, 1);
      if (l == 0) before = 0.0;
      const double c0 = before + v0, c1 = before + v1;
      const double last_pair = __shfl_sync(kFull, ((R - 1) & 1) ? c1 : c0, (R - 1) >> 1);
      const double cT = last_pair;     // cum at the tile's last step (steps past R add 0)
      cum2[q0] = log2_hi_lo(c0);
      cum2[q1] = log2_hi_lo(c1);
      dts[q0] = d0;
      dts[q1] = d1;
      ein[q0] = expf(static_cast<float>(c0));
      ein[q1] = expf(static_cast<float>(c1));
      eout[q0] = expf(static_cast<float>(cT - c0));
      eout[q1] = expf(static_cast<float>(cT - c1));
      if (l == 0) *gsm = expf(static_cast<float>(cT));
    }
    __syncthreads();
    // dtx = dt * x and W = exp(cum_T - cum) o dtx, each as bf16 hi + lo
#pragma unroll
    for (int i = 0; i < kXChunks; ++i) {
      const int e = tid + kThreads * i, q = e >> 3, c = e & 7;
      const float d = dts[q], eo = eout[q];
      const uint32_t xw[4] = {in.x[i].x, in.x[i].y, in.x[i].z, in.x[i].w};
      uint32_t xh[4], xl[4], wh[4], wl[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {    // a bf16 is the high half of its float
        const float a0 = __uint_as_float(xw[k] << 16) * d;
        const float a1 = __uint_as_float(xw[k] & 0xffff0000u) * d;
        split_bf16(a0, a1, xh[k], xl[k]);
        split_bf16(a0 * eo, a1 * eo, wh[k], wl[k]);
      }
      const int off = q * kXRow + 16 * c;
      if (kY) {
        *reinterpret_cast<uint4*>(smem + L::kXhi + off) = make_uint4(xh[0], xh[1], xh[2], xh[3]);
        *reinterpret_cast<uint4*>(smem + L::kXlo + off) = make_uint4(xl[0], xl[1], xl[2], xl[3]);
      }
      *reinterpret_cast<uint4*>(smem + L::kWhi + off) = make_uint4(wh[0], wh[1], wh[2], wh[3]);
      *reinterpret_cast<uint4*>(smem + L::kWlo + off) = make_uint4(wl[0], wl[1], wl[2], wl[3]);
    }
    attn_mma::cp_async_wait<0>();
    __syncthreads();
    const float gT = *gsm;
    if (t + 1 < t1) load_tile(p, xb, dtb, t + 1, in);

    if (kY) {
      // --- y for rows r0 = 16 rb + g4 and r1 = r0 + 8 of the tile, p n8
      // tiles 4 hf .. 4 hf + 3 (yacc[j]: tile 4 hf + j); both halves of a
      // row block build its L o C B^T
      const int i0 = 16 * rb, r0 = i0 + g4, r1 = r0 + 8;
      float yacc[4][4], cbf[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          cbf[j][e] = 0.f;
          if (j < 4) yacc[j][e] = 0.f;
        }
      // C h^T (hi + lo) and C B^T, over N in k16 steps, sharing C's fragments
      const uint32_t frag_row = (l & 7) + 8 * (l >> 4), frag_col = 8 * ((l >> 3) & 1);
#pragma unroll
      for (int ks = 0; ks < NP / 16; ++ks) {
        uint32_t a[4];
        ldsm_x4(s_base + L::kC + (i0 + (l & 15)) * L::kRow + 2 * (16 * ks + 8 * (l >> 4)), a);
        if (has_state) {             // h's hi parts, then its lo parts
#pragma unroll
          for (int part = 0; part < 2; ++part)
#pragma unroll
            for (int jp = 0; jp < 2; ++jp) {
              uint32_t bh[4];
              ldsm_x4(s_base + (part ? L::kHlo : L::kHhi)
                          + (16 * (2 * hf + jp) + frag_row) * L::kRow + 2 * (16 * ks + frag_col),
                      bh);
              mma_bf16(yacc[2 * jp], a, bh[0], bh[1]);
              mma_bf16(yacc[2 * jp + 1], a, bh[2], bh[3]);
            }
        }
#pragma unroll
        for (int jk = 0; jk < 4; ++jk) {
          if (jk <= rb) {              // key tiles on or below the block's diagonal
            uint32_t bq[4];
            ldsm_x4(s_base + L::kB + (16 * jk + frag_row) * L::kRow + 2 * (16 * ks + frag_col),
                    bq);
            mma_bf16(cbf[2 * jk], a, bq[0], bq[1]);
            mma_bf16(cbf[2 * jk + 1], a, bq[2], bq[3]);
          }
        }
      }
      const float e0 = ein[r0], e1 = ein[r1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        yacc[j][0] *= e0;
        yacc[j][1] *= e0;
        yacc[j][2] *= e1;
        yacc[j][3] *= e1;
      }
      // L o C B^T: L = 2^(log2(e) (cum_i - cum_k)), the difference of two
      // hi + lo pairs (to ~1 ulp of its fp32 rounding, as the reference's
      // fp64 difference rounded to fp32); above the diagonal the exponent
      // is -inf, so exp is never evaluated where it would overflow
      const float2 c0 = cum2[r0], c1 = cum2[r1];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j / 2 <= rb) {
          // columns 8 j + 2 t4 and + 1: one 16-byte load
          const float4 kk = *reinterpret_cast<const float4*>(cum2 + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = 8 * j + 2 * t4 + (e & 1), r = e < 2 ? r0 : r1;
            const float2 cr = e < 2 ? c0 : c1;
            const float2 ck = e & 1 ? make_float2(kk.z, kk.w) : make_float2(kk.x, kk.y);
            const float arg = k <= r ? (cr.x - ck.x) + (cr.y - ck.y) : __int_as_float(0xff800000);  // -inf
            cbf[j][e] *= exp2f(arg);
          }
        }
      }
      // (L o C B^T) dtx: the masked products as A fragments, hi.hi + hi.lo + lo.hi
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (s <= rb) {
          uint32_t ah[4], al[4];
          split_bf16(cbf[2 * s][0], cbf[2 * s][1], ah[0], al[0]);
          split_bf16(cbf[2 * s][2], cbf[2 * s][3], ah[1], al[1]);
          split_bf16(cbf[2 * s + 1][0], cbf[2 * s + 1][1], ah[2], al[2]);
          split_bf16(cbf[2 * s + 1][2], cbf[2 * s + 1][3], ah[3], al[3]);
          // three passes over the p tiles (hi.hi, hi.lo, lo.hi), so that
          // consecutive mma accumulate into different tiles
#pragma unroll
          for (int part = 0; part < 3; ++part)
#pragma unroll
            for (int jp = 0; jp < 2; ++jp) {
              uint32_t bx[4];
              ldsm_x4_trans(s_base + (part == 1 ? L::kXlo : L::kXhi)
                                + (16 * s + (l & 7) + 8 * ((l >> 3) & 1)) * kXRow
                                + 2 * (16 * (2 * hf + jp) + 8 * (l >> 4)), bx);
              const uint32_t(&am)[4] = part == 2 ? al : ah;
              mma_bf16(yacc[2 * jp], am, bx[0], bx[1]);
              mma_bf16(yacc[2 * jp + 1], am, bx[2], bx[3]);
            }
        }
      }
      // y, rounded once to bf16
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pp = 8 * (4 * hf + j) + 2 * t4;
        if (pp >= p.P) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r ? r1 : r0;
          if (row >= R) continue;
          bf16* dst = p.y + ((static_cast<long long>(b) * p.S + s0 + row) * p.H + h) * p.P + pp;
          if (pp + 1 < p.P) {
            *reinterpret_cast<uint32_t*>(dst) = pack_bf16(yacc[j][2 * r], yacc[j][2 * r + 1]);
          } else {
            *dst = __float2bfloat16(yacc[j][2 * r]);
          }
        }
      }
    }

    if (need_state) {
      // --- S = W^T B over the tile's steps: the warp's rows and half of N
      float sacc[kNH][4];
#pragma unroll
      for (int j = 0; j < kNH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kT / 16; ++ks) {
        if (16 * ks >= R) break;       // rows past R are zero
        const int mi = l >> 3;
        const uint32_t waddr = s_base + L::kWhi
            + (16 * ks + (l & 7) + 8 * (mi >> 1)) * kXRow + 2 * (16 * rb + 8 * (mi & 1));
        uint32_t wh[4], wl[4];
        ldsm_x4_trans(waddr, wh);
        ldsm_x4_trans(waddr + (L::kWlo - L::kWhi), wl);
#pragma unroll
        for (int part = 0; part < 2; ++part)  // W's hi parts over the warp's N, then its lo
#pragma unroll
          for (int jn = 0; jn < kNH / 2; ++jn) {
            uint32_t bq[4];
            ldsm_x4_trans(s_base + L::kB + (16 * ks + (l & 7) + 8 * ((l >> 3) & 1)) * L::kRow
                              + 2 * (16 * (hf * kNH / 2 + jn) + 8 * (l >> 4)), bq);
            mma_bf16(sacc[2 * jn], part ? wl : wh, bq[0], bq[1]);
            mma_bf16(sacc[2 * jn + 1], part ? wl : wh, bq[2], bq[3]);
          }
      }
#pragma unroll
      for (int j = 0; j < kNH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hreg[j][e] = has_state ? __fmaf_rn(gT, hreg[j][e], sacc[j][e]) : sacc[j][e];
      has_state = true;
      decay *= gT;
    }
    __syncthreads();                   // every read of this tile's shared memory is done
    if (kY && t + 1 < t1) store_h<NP>(hreg, smem, rb, hf, g4, t4);  // for the next C h^T
  }

  if (h_out != nullptr) {
#pragma unroll
    for (int j = 0; j < kNH; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pp = 16 * rb + g4 + 8 * (e >> 1), n = 8 * (hf * kNH + j) + 2 * t4 + (e & 1);
        if (pp < p.P && n < p.N) h_out[pp * p.N + n] = hreg[j][e];
      }
  }
  if (!kY && tid == 0) *decay_out = decay;
}

__device__ __forceinline__ long long seg_slot(const Params& p, int b, int h, int k) {
  return (static_cast<long long>(b) * p.H + h) * (p.nseg - 1) + k;
}

// CTA (h, k, b): the tiles of segment k of row b, head h; y, and the final
// state after the last segment. Segment k > 0 starts from the state the
// segment pass left in slot k - 1.
template <int NP>
__global__ void __launch_bounds__(kThreads, 2) ssd_walk_kernel(Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int h = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int nt = (p.S + kT - 1) / kT;
  const int t0 = k * p.seg_tiles, t1 = min(nt, t0 + p.seg_tiles);
  const long long PN = static_cast<long long>(p.P) * p.N;
  const float* h_init = k > 0 ? p.seg_state + seg_slot(p, b, h, k - 1) * PN : nullptr;
  float* h_out = k + 1 == p.nseg && p.state_out != nullptr
                     ? p.state_out + (static_cast<long long>(b) * p.H + h) * PN
                     : nullptr;
  walk<NP, true>(p, smem, h, b, t0, t1, h_init, h_out, nullptr);
}

// CTA (h, k, b), k < nseg - 1: segment k's state from zero, and the product
// of its tiles' exp(cum_T).
template <int NP>
__global__ void __launch_bounds__(kThreads, 2) ssd_segment_state_kernel(Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int h = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int t0 = k * p.seg_tiles, t1 = t0 + p.seg_tiles;
  const long long slot = seg_slot(p, b, h, k);
  walk<NP, false>(p, smem, h, b, t0, t1, nullptr,
                  p.seg_state + slot * p.P * p.N, p.seg_decay + slot);
}

// One thread per (b, h, state entry): the segments' starting states in
// order, h_k+1 = G_k h_k + S_k, h_0 = 0, written over S_k.
__global__ void __launch_bounds__(256) ssd_segment_pass_kernel(Params p) {
  const long long PN = static_cast<long long>(p.P) * p.N;
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= static_cast<long long>(p.B) * p.H * PN) return;
  const long long bh = i / PN, e = i % PN;   // bh = b * H + h
  float* s = p.seg_state + bh * (p.nseg - 1) * PN + e;
  const float* g = p.seg_decay + bh * (p.nseg - 1);
  float hcur = 0.f;
  for (int k = 0; k + 1 < p.nseg; ++k) {
    hcur = __fmaf_rn(g[k], hcur, s[k * PN]);
    s[k * PN] = hcur;
  }
}

template <int NP>
cudaError_t launch_tc(const Params& p, cudaStream_t stream) {
  const int B = p.B;
  constexpr int bytes = Lay<NP>::kBytes;
  static bool opted_in = false;      // above 48 KB only by opting in
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_walk_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_segment_state_kernel<NP>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  if (p.nseg > 1) {
    ssd_segment_state_kernel<NP><<<dim3(p.H, p.nseg - 1, B), kThreads, bytes, stream>>>(p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long n = static_cast<long long>(B) * p.H * p.P * p.N;
    ssd_segment_pass_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  ssd_walk_kernel<NP><<<dim3(p.H, p.nseg, B), kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

// fp32, the CUDA-core route. Strides are in elements: x (b, s, h), dt (b,
// s, h), Bm and Cm (b, s). Q must divide S and be at most 128; state_out
// may be null; the problem's tiles must fit in shared memory (227 KB).
// Returns a cudaError_t; asynchronous on `stream`.
extern "C" int ssd_scan(const float* x, const float* dt, const float* A,
                        const float* Bm, const float* Cm, float* y,
                        float* state_out, int B, int S, int H, int P, int N,
                        int Q, long long x_sb, long long x_ss, long long x_sh,
                        long long dt_sb, long long dt_ss, long long dt_sh,
                        long long b_sb, long long b_ss, long long c_sb,
                        long long c_ss, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (Q < 1 || Q > kMaxChunk || S % Q || P < 1 || N < 1
      || smem_floats(Q, P, N) * sizeof(float) > static_cast<size_t>(kMaxSmem))
    return cudaErrorInvalidValue;
  static bool opted_in = false;              // above 48 KB only by opting in
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const size_t bytes = smem_floats(Q, P, N) * sizeof(float);
  ssd_scan_kernel<<<dim3(H, B), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, dt, A, Bm, Cm, y, state_out, S, H, P, N, Q, Strides{x_sb, x_ss, x_sh},
      Strides{dt_sb, dt_ss, dt_sh}, Strides{b_sb, b_ss, 0}, Strides{c_sb, c_ss, 0});
  return cudaGetLastError();
}

// bf16, the tensor-core routes: walk (nseg 1) or chunks (nseg > 1, with
// seg_state (B, H, nseg - 1, P, N) and seg_decay (B, H, nseg - 1) fp32
// scratch). P <= 64, N <= 128; seg_tiles 64-step tiles a segment, nseg
// = ceil(ceil(S / 64) / seg_tiles). Strides as for ssd_scan. Returns a
// cudaError_t; asynchronous on `stream`.
extern "C" int ssd_scan_tc(const void* x, const float* dt, const float* A,
                           const void* Bm, const void* Cm, void* y,
                           float* state_out, float* seg_state, float* seg_decay,
                           int B, int S, int H, int P, int N, int seg_tiles,
                           int nseg, long long x_sb, long long x_ss,
                           long long x_sh, long long dt_sb, long long dt_ss,
                           long long dt_sh, long long b_sb, long long b_ss,
                           long long c_sb, long long c_ss, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  const int nt = (S + tc::kT - 1) / tc::kT;
  if (P < 1 || P > tc::kP || N < 1 || N > 128 || seg_tiles < 1
      || nseg != (nt + seg_tiles - 1) / seg_tiles || B > 65535
      || (nseg > 1 && (seg_state == nullptr || seg_decay == nullptr)))
    return cudaErrorInvalidValue;
  tc::Params p;
  p.x = static_cast<const tc::bf16*>(x);
  p.dt = dt;
  p.A = A;
  p.Bm = static_cast<const tc::bf16*>(Bm);
  p.Cm = static_cast<const tc::bf16*>(Cm);
  p.y = static_cast<tc::bf16*>(y);
  p.state_out = state_out;
  p.seg_state = seg_state;
  p.seg_decay = seg_decay;
  p.B = B;
  p.S = S;
  p.H = H;
  p.P = P;
  p.N = N;
  p.seg_tiles = seg_tiles;
  p.nseg = nseg;
  p.x_sb = x_sb;
  p.x_ss = x_ss;
  p.x_sh = x_sh;
  p.dt_sb = dt_sb;
  p.dt_ss = dt_ss;
  p.dt_sh = dt_sh;
  p.b_sb = b_sb;
  p.b_ss = b_ss;
  p.c_sb = c_sb;
  p.c_ss = c_ss;
  p.vec_x = P % 8 == 0 && aligned16(x) && x_sb % 8 == 0 && x_ss % 8 == 0 && x_sh % 8 == 0;
  p.vec_bc = N % 8 == 0 && aligned16(Bm) && aligned16(Cm) && b_sb % 8 == 0
             && b_ss % 8 == 0 && c_sb % 8 == 0 && c_ss % 8 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return N <= 64 ? tc::launch_tc<64>(p, s) : tc::launch_tc<128>(p, s);
}

extern "C" const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
