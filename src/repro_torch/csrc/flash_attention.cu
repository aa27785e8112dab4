// Offset-aware flash attention over dense K/V for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::_kernel
// (the cache-less forward, the BERT/ViT encoders, and serving from
// contiguous (slots, max_len) KV caches). Contract, as there:
//
//   q (B, Sq, H, D), k/v (B, Sk, Hkv, D), model layout, read through the
//   strides the caller passes (the last dim must be contiguous);
//   q_positions (B, Sq) int32 (-1 = masked row); kv_valid_len (B,) int32.
//   Key col is visible to query row i iff col < min(kv_valid_len[b], Sk)
//   and, when causal, col <= q_positions[b, i]. fp32 scores s = q.k * scale
//   (soft-capped as cap * tanh(s / cap) when cap > 0), fp32 running max and
//   denominator; p is zeroed where invalid, not only set to -inf; p is
//   rounded to v's dtype before the P.V product, as the TPU kernel's
//   p.astype(v.dtype) does; the flush divides by max(l, 1e-30), so a row
//   that sees no key is exactly 0. Key blocks past every valid key, or
//   beyond the furthest causal position of the CTA's rows, are skipped.
//
// Layout of the work: the TPU walks its key blocks along a sequential grid
// axis with the running max, denominator and accumulator in VMEM scratch.
// Hopper blocks run in no order, so one CTA owns one (query tile, kv head
// g, batch row b) and walks the keys in a loop, writing its output once.
// Its rows are the query positions of the tile times the rep = H / Hkv
// query heads that share kv head g (GQA folded into the CTA, at most 16
// rows), so each K/V tile is read once per CTA and used by every row.
// Ragged Sq and Sk are bounds-checked here; nothing is padded in memory.
//
// Each key block of 32 keys is staged in shared memory as fp32. Threads
// fetch K and V in 16-byte chunks (the wrapper guarantees the alignment),
// and the next block's chunks are fetched into registers while the current
// block is scored, so memory latency is paid once per CTA, not per block. Each of the 4 warps owns up to 4 rows and scores them
// together: lane t takes key t, reading q (broadcast) and k in 16-byte
// vectors, so one k load serves four rows. The rows' p values go through
// shared memory as one float4 per key, and lane d accumulates output dims
// d, d + 32, d + 64 of all four rows.
//
// What bounds it on an H100: the encoders' attention (S <= 257) does
// 4 * S * S * D FLOPs per head over 4 * S * D elements, so it is bound by
// operations; this kernel runs them as fp32 FMAs on the CUDA cores (no
// tensor cores yet), far below the bf16 tensor-core peak. Decode (Sq = 1)
// reads each cache row's valid keys once: bytes, at few CTAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRows = 16;                 // rows (query position x head) per CTA
constexpr int kRowsPerWarp = kMaxRows / kWarps;
constexpr int kBlockK = 32;                  // keys per block: one per lane
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// p.astype(v.dtype): identity for fp32, round-to-nearest-even for bf16.
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

struct Strides {          // element strides of a (B, S, heads, D) operand
  long long b, s, h;
};

// One key block's (kBlockK, D) tiles of K and V move in 16-byte chunks (8
// bf16 or 4 fp32 values); thread tid takes chunks tid + i * kThreads.
template <typename T, int D>
struct Tile {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kRowChunks = D / kVec;
  static constexpr int kChunks = kBlockK * kRowChunks;
  static constexpr int kPer = (kChunks + kThreads - 1) / kThreads;
};

// Fetch this thread's chunks of the block at col0 (zero past key Sk).
template <typename T, int D>
__device__ __forceinline__ void fetch_block(const T* __restrict__ kb,
                                            const T* __restrict__ vb,
                                            long long k_ss, long long v_ss,
                                            int col0, int Sk, int tid,
                                            uint4 (&kr)[Tile<T, D>::kPer],
                                            uint4 (&vr)[Tile<T, D>::kPer]) {
  using TL = Tile<T, D>;
#pragma unroll
  for (int i = 0; i < TL::kPer; ++i) {
    const int c = tid + i * kThreads;
    const int col = col0 + c / TL::kRowChunks, d = (c % TL::kRowChunks) * TL::kVec;
    const bool in = c < TL::kChunks && col < Sk;
    kr[i] = in ? *reinterpret_cast<const uint4*>(kb + col * k_ss + d) : make_uint4(0, 0, 0, 0);
    vr[i] = in ? *reinterpret_cast<const uint4*>(vb + col * v_ss + d) : make_uint4(0, 0, 0, 0);
  }
}

// A 16-byte chunk as fp32, written to dst[0 .. kVec) (16-byte aligned).
__device__ __forceinline__ void unpack(uint4 x, float* dst, const float*) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&x);
}
__device__ __forceinline__ void unpack(uint4 x, float* dst, const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ q_positions,
                  const int* __restrict__ kv_valid_len, T* __restrict__ out,
                  int Sq, int Sk, int H, int Hkv, Strides qst, Strides kst,
                  Strides vst, float scale, float soft_cap, int causal) {
  static_assert(D % 4 == 0 && D <= 96, "head_dim must be a multiple of 4, <= 96");
  constexpr int kDPerLane = (D + 31) / 32;
  constexpr int kKStride = D + 4;            // 16-byte rows, conflict-free float4 reads
  using TL = Tile<T, D>;
  static_assert(D % TL::kVec == 0, "rows split into 16-byte chunks");

  const int tile = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int rep = H / Hkv;
  const int qt = kMaxRows / rep;             // query positions per CTA
  const int s0 = tile * qt;
  const int n_rows = min(qt, Sq - s0) * rep; // row r: s = s0 + r / rep, h = g * rep + r % rep
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  __shared__ __align__(16) float qs[kMaxRows][D];
  __shared__ __align__(16) float ks[kBlockK][kKStride];
  __shared__ __align__(16) float vs[kBlockK][D];
  __shared__ float4 ps[kWarps][kBlockK];     // p of a warp's 4 rows, per key
  __shared__ int qpos_s[kMaxRows];

  for (int e = tid; e < kMaxRows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float x = 0.f;
    if (r < n_rows) {
      const int s = s0 + r / rep, h = g * rep + r % rep;
      x = to_f(q[b * qst.b + s * qst.s + h * qst.h + d]);
    }
    qs[r][d] = x;
  }
  for (int r = tid; r < kMaxRows; r += kThreads)
    qpos_s[r] = r < n_rows ? q_positions[static_cast<long long>(b) * Sq + s0 + r / rep] : -1;
  __syncthreads();

  const int kvlen = min(kv_valid_len[b], Sk);
  int qmax = -1;
  for (int r = 0; r < n_rows; ++r) qmax = max(qmax, qpos_s[r]);
  // Keys [0, kv_end) are all any row of this CTA can see: later blocks are
  // past the valid length, or strictly in the future of every row.
  const int kv_end = causal ? min(kvlen, qmax + 1) : kvlen;
  const T* kb = k + b * kst.b + g * kst.h;
  const T* vb = v + b * vst.b + g * vst.h;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < kDPerLane; ++u) acc[i][u] = 0.f;
  }

  uint4 kr[TL::kPer], vr[TL::kPer];
  if (kv_end > 0) fetch_block<T, D>(kb, vb, kst.s, vst.s, 0, Sk, tid, kr, vr);
  for (int col0 = 0; col0 < kv_end; col0 += kBlockK) {
    const int nk = min(kBlockK, Sk - col0);
    __syncthreads();                         // the previous block's readers are done
#pragma unroll
    for (int i = 0; i < TL::kPer; ++i) {
      const int c = tid + i * kThreads;
      if (c < TL::kChunks) {
        const int t = c / TL::kRowChunks, d = (c % TL::kRowChunks) * TL::kVec;
        unpack(kr[i], &ks[t][d], k);
        unpack(vr[i], &vs[t][d], v);
      }
    }
    __syncthreads();
    if (col0 + kBlockK < kv_end)             // in flight while this block is scored
      fetch_block<T, D>(kb, vb, kst.s, vst.s, col0 + kBlockK, Sk, tid, kr, vr);

    // Scores of this warp's rows against key `lane`.
    float dot[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) dot[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(&ks[lane][d]);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(&qs[warp + i * kWarps][d]);
        dot[i] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }
    const int col = col0 + lane;
    float pr[kRowsPerWarp], corr[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + i * kWarps;
      const bool valid = r < n_rows && col < kvlen && (!causal || col <= qpos_s[r]);
      float s = dot[i] * scale;
      if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
      s = valid ? s : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + warp_sum(p);
      pr[i] = round_as(p, v);
      m[i] = m_new;
    }
    ps[warp][lane] = make_float4(pr[0], pr[1], pr[2], pr[3]);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int u = 0; u < kDPerLane; ++u) acc[i][u] *= corr[i];
    for (int t = 0; t < nk; ++t) {
      const float4 pt = ps[warp][t];
#pragma unroll
      for (int u = 0; u < kDPerLane; ++u) {
        const int d = lane + 32 * u;
        if (d < D) {
          const float vx = vs[t][d];
          acc[0][u] += pt.x * vx;
          acc[1][u] += pt.y * vx;
          acc[2][u] += pt.z * vx;
          acc[3][u] += pt.w * vx;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + i * kWarps;
    if (r >= n_rows) continue;
    const int s = s0 + r / rep, h = g * rep + r % rep;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + ((static_cast<long long>(b) * Sq + s) * H + h) * D;
#pragma unroll
    for (int u = 0; u < kDPerLane; ++u) {
      const int d = lane + 32 * u;
      if (d < D) store(&o[d], acc[i][u] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* qpos,
                   const int* kvlen, void* out, int B, int Sq, int Sk, int H,
                   int Hkv, Strides qs, Strides ks, Strides vs, float scale,
                   float soft_cap, int causal, cudaStream_t stream) {
  const int qt = kMaxRows / (H / Hkv);
  const dim3 grid((Sq + qt - 1) / qt, Hkv, B);
  flash_attn_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      qpos, kvlen, static_cast<T*>(out), Sq, Sk, H, Hkv, qs, ks, vs, scale,
      soft_cap, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16 (q, k, v and the output alike).
// head_dim: 64 or 80. Strides are in elements; the output is a contiguous
// (B, Sq, H, head_dim) tensor. H / Hkv must be an integer <= 16.
// soft_cap <= 0 means none. Returns a cudaError_t; asynchronous on `stream`.
extern "C" int flash_attention(int dtype_code, int head_dim, const void* q,
                               const void* k, const void* v,
                               const int* q_positions, const int* kv_valid_len,
                               void* out, int B, int Sq, int Sk, int H, int Hkv,
                               long long q_sb, long long q_ss, long long q_sh,
                               long long k_sb, long long k_ss, long long k_sh,
                               long long v_sb, long long v_ss, long long v_sh,
                               float scale, float soft_cap, int causal,
                               void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (Hkv < 1 || H % Hkv || H / Hkv > kMaxRows) return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_LAUNCH(T, D)                                                         \
  return launch<T, D>(q, k, v, q_positions, kv_valid_len, out, B, Sq, Sk, H, \
                      Hkv, qs, ks, vs, scale, soft_cap, causal, s)
  if (dtype_code == 0 && head_dim == 64) FA_LAUNCH(float, 64);
  if (dtype_code == 0 && head_dim == 80) FA_LAUNCH(float, 80);
  if (dtype_code == 1 && head_dim == 64) FA_LAUNCH(__nv_bfloat16, 64);
  if (dtype_code == 1 && head_dim == 80) FA_LAUNCH(__nv_bfloat16, 80);
#undef FA_LAUNCH
  return cudaErrorInvalidValue;
}

extern "C" const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
