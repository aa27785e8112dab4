// Offset-aware flash attention over dense K/V for Hopper (sm_90a): K3.
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
// What bounds it on an H100: the encoders' attention (S <= 257) does
// 4 * S * S * D FLOPs per head over 4 * S * D elements, so it is bound by
// operations; decode (Sq = 1) reads each cache row's valid keys once, so
// it is bound by bytes, and by how many SMs share that read.
//
// bf16 runs on the tensor cores, through the warp tile of attn_mma.cuh
// (mma.sync m16n8k16, Q held in registers as A fragments, P fed back from
// the S accumulators as A fragments of P.V), on one of two routes picked
// by rows = query positions x rep (kernels/flash_attention.py::route_for):
//
// * flash_attn_rows_kernel (rows > 16: encoders, prefill buckets, chunks):
//   one CTA per (64 rows, kv head g, batch row b), 16 rows a warp, walking
//   64-key stages of K and V through a two-stage cp.async ring. At
//   bert-base that is 192 CTAs, each reading K and V of its (b, g) once
//   for 64 rows, where a CUDA-core CTA of 16 rows read them 8 times.
// * flash_attn_split_kernel (rows <= 16: decode): one m16 row tile per
//   (g, b), its keys split over the 4 warps and, for caches of 512 keys
//   and more, over up to 8 CTAs of a thread-block cluster, merged in warp
//   and rank order (no atomics). At smollm-135m's 256-key decode one CTA
//   per (b, g) runs fastest (a cluster's merge costs more than it saves;
//   kernels/flash_attention.py::split_count, scripts/torch_attn_sweep.py).
//
// fp32 (TF32 stays off, and ATTN_TOLS["float32"] = 3e-5 cannot hold with
// it) keeps the CUDA-core kernel flash_attn_kernel: one CTA owns one
// (query tile, kv head g, batch row b), its rows the query positions of
// the tile times the rep = H / Hkv query heads that share kv head g (GQA
// folded into the CTA, at most 16 rows), so each K/V tile is read once per
// CTA and used by every row. Each key block of 32 keys is staged in shared
// memory as fp32; threads fetch K and V in 16-byte chunks, and the next
// block's chunks are fetched into registers while the current block is
// scored. Each of the 4 warps owns up to 4 rows and scores them together:
// lane t takes key t, reading q (broadcast) and k in 16-byte vectors, so
// one k load serves four rows. The rows' p values go through shared memory
// as one float4 per key, and lane d accumulates output dims d, d + 32,
// d + 64 of all four rows. Ragged Sq and Sk are bounds-checked on both
// paths; nothing is padded in memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_mma.cuh"

namespace {

namespace am = attn_mma;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRows = 16;                 // rows (query position x head) per CTA
constexpr int kRowsPerWarp = kMaxRows / kWarps;
constexpr int kBlockK = 32;                  // keys per block: one per lane
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
// p.astype(v.dtype): the identity for fp32.
__device__ __forceinline__ float round_as(float x, const float*) { return x; }

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

// One key block's (kBlockK, D) tiles of K and V move in 16-byte chunks (4
// fp32 values); thread tid takes chunks tid + i * kThreads.
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

// The bf16 instances: the attention of attn_mma.cuh over a dense cache.
template <int D, bool kSplit>
__device__ __forceinline__ void flash_attn_tc(const am::Params& p, const am::bf16* k,
                                              const am::bf16* v, Strides kst, Strides vst) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int g = blockIdx.y, b = blockIdx.z;
  am::DenseKV src{k + b * kst.b + g * kst.h, v + b * vst.b + g * vst.h, kst.s, vst.s};
  am::attend<D, kSplit>(p, src, smem);
}

template <int D>
__global__ void __launch_bounds__(am::kThreads)
flash_attn_rows_kernel(am::Params p, const am::bf16* k, const am::bf16* v, Strides kst,
                       Strides vst) {
  flash_attn_tc<D, false>(p, k, v, kst, vst);
}

template <int D>
__global__ void __launch_bounds__(am::kThreads)
flash_attn_split_kernel(am::Params p, const am::bf16* k, const am::bf16* v, Strides kst,
                        Strides vst) {
  flash_attn_tc<D, true>(p, k, v, kst, vst);
}

template <int D, bool kSplit>
cudaError_t launch_tc(const am::Params& p, const void* k, const void* v, int B, int splits,
                      Strides ks, Strides vs, cudaStream_t stream) {
  constexpr int smem = am::Smem<D, kSplit>::kBytes;
  auto kernel = flash_attn_rows_kernel<D>;
  if constexpr (kSplit) kernel = flash_attn_split_kernel<D>;
  static int granted = 0;
  const cudaError_t attr = am::reserve_smem(kernel, smem, granted);
  if (attr != cudaSuccess) return attr;
  const int qt = am::kRowsTile / (p.H / p.Hkv);
  const dim3 grid(kSplit ? splits : (p.Sq + qt - 1) / qt, p.Hkv, B);
  return am::launch_grid(kernel, grid, kSplit ? splits : 1, smem, stream, p,
                         static_cast<const am::bf16*>(k), static_cast<const am::bf16*>(v),
                         ks, vs);
}

}  // namespace

// The fp32 instance (the CUDA cores); bf16 takes flash_attention_tc.
// head_dim: 64 or 80. Strides are in elements; the output is a contiguous
// (B, Sq, H, head_dim) tensor. H / Hkv must be an integer <= 16.
// soft_cap <= 0 means none. Returns a cudaError_t; asynchronous on
// `stream`.
extern "C" int flash_attention(int head_dim, const void* q,
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
  if (head_dim == 64) FA_LAUNCH(float, 64);
  if (head_dim == 80) FA_LAUNCH(float, 80);
#undef FA_LAUNCH
  return cudaErrorInvalidValue;
}

// The bf16 instances (the tensor cores). splits = 0 takes the rows route
// (any Sq); splits = 1..8 the split route, which needs Sq * H / Hkv <= 16
// and puts `splits` CTAs of one cluster on each (kv head, batch row).
// head_dim: 64 or 80; H / Hkv <= 16. q_positions may be null (the
// bottom-right default, s + Sk - Sq) and kv_valid_len null (Sk); a given
// kv_valid_len is clamped to Sk here. Strides, output and return as for
// flash_attention.
extern "C" int flash_attention_tc(int head_dim, int splits, const void* q, const void* k,
                                  const void* v, const int* q_positions,
                                  const int* kv_valid_len, void* out, int B, int Sq, int Sk,
                                  int H, int Hkv, long long q_sb, long long q_ss,
                                  long long q_sh, long long k_sb, long long k_ss,
                                  long long k_sh, long long v_sb, long long v_ss,
                                  long long v_sh, float scale, float soft_cap, int causal,
                                  void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (Hkv < 1 || H % Hkv || H / Hkv > am::kSplitRows) return cudaErrorInvalidValue;
  if (splits < 0 || splits > am::kMaxSplits || (splits > 0 && Sq * (H / Hkv) > am::kSplitRows))
    return cudaErrorInvalidValue;
  const am::Params p{static_cast<const am::bf16*>(q), q_sb, q_ss, q_sh, q_positions,
                     kv_valid_len, static_cast<am::bf16*>(out), Sq, H, Hkv, Sk, Sk - Sq,
                     scale, soft_cap, causal};
  const Strides ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return splits ? launch_tc<64, true>(p, k, v, B, splits, ks, vs, s)
                  : launch_tc<64, false>(p, k, v, B, 0, ks, vs, s);
  if (head_dim == 80)
    return splits ? launch_tc<80, true>(p, k, v, B, splits, ks, vs, s)
                  : launch_tc<80, false>(p, k, v, B, 0, ks, vs, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
