// Offset-aware flash attention over dense K/V for Hopper (sm_90a): K3.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::_kernel
// (the cache-less forward, the BERT/ViT encoders, and serving from
// contiguous (slots, max_len) KV caches). Contract, as there:
//
//   q (B, Sq, H, D), k (B, Sk, Hkv, D), v (B, Sk, Hkv, Dv), model layout,
//   read through the strides the caller passes (the last dim must be
//   contiguous); out (B, Sq, H, Dv). Dv = D but for MLA (deepseek-v2: D
//   192 = 128 nope + 64 rope dims, Dv 128, v a strided view of the
//   up-projection);
//   q_positions (B, Sq) int32 (-1 = masked row); kv_valid_len (B,) int32;
//   lse (B, Sq, H) fp32 or null: each row's log-sum-exp m + log(l) of its
//   visible scores, -inf where it sees none (what merges partial
//   attentions over a KV cache cut over the sequence; attn_mma.cuh).
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
// * flash_attn_rows_kernel (Sq > 1 and rows > 16: encoders, prefill
//   buckets, chunks): one CTA per (64 rows, kv head g, batch row b), 16 rows
//   a warp, walking
//   64-key stages of K and V through a two-stage cp.async ring. At
//   bert-base that is 192 CTAs, each reading K and V of its (b, g) once
//   for 64 rows, where a CUDA-core CTA of 16 rows read them 8 times.
// * flash_attn_split_kernel (decode, or rows <= 16): one CTA per (m16 row
//   tile, g, b), its keys split over the 4 warps and, for caches of 512 keys
//   and more, over up to 8 CTAs of a thread-block cluster, merged in warp
//   and rank order (no atomics). At smollm-135m's 256-key decode one CTA
//   per (b, g) runs fastest (a cluster's merge costs more than it saves;
//   kernels/flash_attention.py::split_count, scripts/torch_attn_sweep.py).
//
// Rows are flat on every route: row F of (b, g) is query position F / rep
// of head g * rep + F % rep (rep = H / Hkv query heads share kv head g), so
// any GQA group fits, and each K/V tile is read once per CTA for every row
// of it.
//
// fp32 (TF32 stays off, and ATTN_TOLS["float32"] = 3e-5 cannot hold with
// it) keeps the CUDA-core kernel flash_attn_kernel: one CTA owns 16
// consecutive rows of one (kv head g, batch row b). Each key block of 32 keys is staged in shared
// memory as fp32; threads fetch K and V in 16-byte chunks, and the next
// block's chunks are fetched into registers while the current block is
// scored. Each of the 4 warps owns up to 4 rows and scores them together:
// lane t takes key t, reading q (broadcast) and k in 16-byte vectors, so
// one k load serves four rows. The rows' p values go through shared memory
// as one float4 per key, and lane d accumulates output dims d, d + 32, ...
// of all four rows. Its shared memory is dynamic: 42.6 KB at D 128, and
// 54.6 KB at MLA's D 192 / Dv 128, past the 48 KB a launch gets without
// opting in (am::reserve_smem). Ragged Sq and Sk are bounds-checked on both
// paths; nothing is padded in memory.
//
// fp32 q over a bf16 cache (an fp32 model serving from the default bf16
// cache, as the reference's ServeConfig pairs them) takes the same kernel
// with K/V typed bf16 (flash_attn_kernel<float, bf16, D, Dv>): the 16-byte
// chunks hold 8 keys' dims, widened to fp32 in shared memory (exact), and
// p is rounded to bf16 before P.V, as the TPU kernel's p.astype(v.dtype).

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
// p.astype(v.dtype): the identity for fp32 V, a round to nearest for bf16 V.
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

// One key block's (kBlockK, D) tile of K or (kBlockK, Dv) tile of V moves in
// 16-byte chunks (4 fp32 values); thread tid takes chunks tid + i * kThreads.
template <typename T, int D>
struct Tile {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kRowChunks = D / kVec;
  static constexpr int kChunks = kBlockK * kRowChunks;
  static constexpr int kPer = (kChunks + kThreads - 1) / kThreads;
};

// Fetch this thread's chunks of one operand's block at col0 (zero past key
// Sk).
template <typename T, int D>
__device__ __forceinline__ void fetch_block(const T* __restrict__ base, long long ss, int col0,
                                            int Sk, int tid, uint4 (&r)[Tile<T, D>::kPer]) {
  using TL = Tile<T, D>;
#pragma unroll
  for (int i = 0; i < TL::kPer; ++i) {
    const int c = tid + i * kThreads;
    const int col = col0 + c / TL::kRowChunks, d = (c % TL::kRowChunks) * TL::kVec;
    const bool in = c < TL::kChunks && col < Sk;
    r[i] = in ? *reinterpret_cast<const uint4*>(base + col * ss + d) : make_uint4(0, 0, 0, 0);
  }
}

// The fp32 kernel's shared memory, carved from the dynamic allocation:
// q rows, K rows padded to 16-byte steps for conflict-free float4 reads,
// V rows, the warps' p values and the rows' positions.
template <int D, int Dv>
struct FpSmem {
  static constexpr int kKStride = D + 4;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kMaxRows * D * 4;
  static constexpr int kV = kK + kBlockK * kKStride * 4;
  static constexpr int kP = kV + kBlockK * Dv * 4;
  static constexpr int kPos = kP + kWarps * kBlockK * 16;
  static constexpr int kBytes = kPos + kMaxRows * 4;
};

// A 16-byte chunk as fp32, written to dst[0 .. kVec) (16-byte aligned):
// 4 fp32 values, or 8 bf16 values widened (exactly) to fp32.
__device__ __forceinline__ void unpack(uint4 x, float* dst, const float*) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&x);
}
__device__ __forceinline__ void unpack(uint4 x, float* dst, const __nv_bfloat16*) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  float f[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

template <typename T, typename KV, int D, int Dv>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                  const KV* __restrict__ v, const int* __restrict__ q_positions,
                  const int* __restrict__ kv_valid_len, T* __restrict__ out,
                  float* __restrict__ lse, int Sq, int Sk, int H, int Hkv,
                  Strides qst, Strides kst,
                  Strides vst, float scale, float soft_cap, int causal) {
  static_assert(D % 4 == 0 && D <= 192 && Dv % 4 == 0 && Dv <= 128,
                "head dims: multiples of 4, q/k up to 192, v up to 128");
  constexpr int kDPerLane = (Dv + 31) / 32;
  using SM = FpSmem<D, Dv>;
  constexpr int kKStride = SM::kKStride;
  using TK = Tile<KV, D>;
  using TV = Tile<KV, Dv>;
  static_assert(D % TK::kVec == 0 && Dv % TV::kVec == 0, "rows split into 16-byte chunks");

  const int g = blockIdx.y, b = blockIdx.z;
  const int rep = H / Hkv;
  // row r is flat row row0 + r: s = (row0 + r) / rep, h = g * rep + (row0 + r) % rep
  const int row0 = blockIdx.x * kMaxRows;
  const int n_rows = min(kMaxRows, Sq * rep - row0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) uint8_t fp_smem[];
  auto qs = reinterpret_cast<float(*)[D]>(fp_smem + SM::kQ);
  auto ks = reinterpret_cast<float(*)[kKStride]>(fp_smem + SM::kK);
  auto vs = reinterpret_cast<float(*)[Dv]>(fp_smem + SM::kV);
  auto ps = reinterpret_cast<float4(*)[kBlockK]>(fp_smem + SM::kP);  // p of a warp's 4 rows, per key
  int* qpos_s = reinterpret_cast<int*>(fp_smem + SM::kPos);

  for (int e = tid; e < kMaxRows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float x = 0.f;
    if (r < n_rows) {
      const int s = (row0 + r) / rep, h = g * rep + (row0 + r) % rep;
      x = to_f(q[b * qst.b + s * qst.s + h * qst.h + d]);
    }
    qs[r][d] = x;
  }
  for (int r = tid; r < kMaxRows; r += kThreads)
    qpos_s[r] = r < n_rows ? q_positions[static_cast<long long>(b) * Sq + (row0 + r) / rep] : -1;
  __syncthreads();

  const int kvlen = min(kv_valid_len[b], Sk);
  int qmax = -1;
  for (int r = 0; r < n_rows; ++r) qmax = max(qmax, qpos_s[r]);
  // Keys [0, kv_end) are all any row of this CTA can see: later blocks are
  // past the valid length, or strictly in the future of every row.
  const int kv_end = causal ? min(kvlen, qmax + 1) : kvlen;
  const KV* kb = k + b * kst.b + g * kst.h;
  const KV* vb = v + b * vst.b + g * vst.h;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < kDPerLane; ++u) acc[i][u] = 0.f;
  }

  uint4 kr[TK::kPer], vr[TV::kPer];
  if (kv_end > 0) {
    fetch_block<KV, D>(kb, kst.s, 0, Sk, tid, kr);
    fetch_block<KV, Dv>(vb, vst.s, 0, Sk, tid, vr);
  }
  for (int col0 = 0; col0 < kv_end; col0 += kBlockK) {
    const int nk = min(kBlockK, Sk - col0);
    __syncthreads();                         // the previous block's readers are done
#pragma unroll
    for (int i = 0; i < TK::kPer; ++i) {
      const int c = tid + i * kThreads;
      if (c < TK::kChunks) {
        const int t = c / TK::kRowChunks, d = (c % TK::kRowChunks) * TK::kVec;
        unpack(kr[i], &ks[t][d], k);
      }
    }
#pragma unroll
    for (int i = 0; i < TV::kPer; ++i) {
      const int c = tid + i * kThreads;
      if (c < TV::kChunks) {
        const int t = c / TV::kRowChunks, d = (c % TV::kRowChunks) * TV::kVec;
        unpack(vr[i], &vs[t][d], v);
      }
    }
    __syncthreads();
    if (col0 + kBlockK < kv_end) {           // in flight while this block is scored
      fetch_block<KV, D>(kb, kst.s, col0 + kBlockK, Sk, tid, kr);
      fetch_block<KV, Dv>(vb, vst.s, col0 + kBlockK, Sk, tid, vr);
    }

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
        if (d < Dv) {
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
    const int s = (row0 + r) / rep, h = g * rep + (row0 + r) % rep;
    const float denom = fmaxf(l[i], 1e-30f);
    const long long row = (static_cast<long long>(b) * Sq + s) * H + h;
    // m[i] and l[i] are the same in every lane (warp_max, warp_sum)
    if (lse && lane == 0) lse[row] = am::row_lse(m[i], l[i]);
    T* o = out + row * Dv;
#pragma unroll
    for (int u = 0; u < kDPerLane; ++u) {
      const int d = lane + 32 * u;
      if (d < Dv) store(&o[d], acc[i][u] / denom);
    }
  }
}

template <typename T, typename KV, int D, int Dv>
cudaError_t launch(const void* q, const void* k, const void* v, const int* qpos,
                   const int* kvlen, void* out, float* lse, int B, int Sq, int Sk, int H,
                   int Hkv, Strides qs, Strides ks, Strides vs, float scale,
                   float soft_cap, int causal, cudaStream_t stream) {
  constexpr int smem = FpSmem<D, Dv>::kBytes;
  static int granted = 0;
  const cudaError_t attr = am::reserve_smem(flash_attn_kernel<T, KV, D, Dv>, smem, granted);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((Sq * (H / Hkv) + kMaxRows - 1) / kMaxRows, Hkv, B);
  flash_attn_kernel<T, KV, D, Dv><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      qpos, kvlen, static_cast<T*>(out), lse, Sq, Sk, H, Hkv, qs, ks, vs, scale,
      soft_cap, causal);
  return cudaGetLastError();
}

// The bf16 instances: the attention of attn_mma.cuh over a dense cache.
template <int D, int Dv, bool kSplit>
__device__ __forceinline__ void flash_attn_tc(const am::Params& p, const am::bf16* k,
                                              const am::bf16* v, Strides kst, Strides vst) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int g = blockIdx.y, b = blockIdx.z;
  am::DenseKV src{k + b * kst.b + g * kst.h, v + b * vst.b + g * vst.h, kst.s, vst.s};
  am::attend<D, kSplit, am::DenseKV, Dv>(p, src, smem);
}

template <int D, int Dv>
__global__ void __launch_bounds__(am::kThreads)
flash_attn_rows_kernel(am::Params p, const am::bf16* k, const am::bf16* v, Strides kst,
                       Strides vst) {
  flash_attn_tc<D, Dv, false>(p, k, v, kst, vst);
}

template <int D, int Dv>
__global__ void __launch_bounds__(am::kThreads)
flash_attn_split_kernel(am::Params p, const am::bf16* k, const am::bf16* v, Strides kst,
                        Strides vst) {
  flash_attn_tc<D, Dv, true>(p, k, v, kst, vst);
}

template <int D, int Dv, bool kSplit>
cudaError_t launch_tc(const am::Params& p, const void* k, const void* v, int B, int splits,
                      Strides ks, Strides vs, cudaStream_t stream) {
  constexpr int smem = am::Smem<D, kSplit, false, Dv>::kBytes;
  auto kernel = flash_attn_rows_kernel<D, Dv>;
  if constexpr (kSplit) kernel = flash_attn_split_kernel<D, Dv>;
  static int granted = 0;
  const cudaError_t attr = am::reserve_smem(kernel, smem, granted);
  if (attr != cudaSuccess) return attr;
  const int rows = p.Sq * (p.H / p.Hkv), tile = kSplit ? am::kSplitRows : am::kRowsTile;
  const dim3 grid((rows + tile - 1) / tile * (kSplit ? splits : 1), p.Hkv, B);
  return am::launch_grid(kernel, grid, kSplit ? splits : 1, smem, stream, p,
                         static_cast<const am::bf16*>(k), static_cast<const am::bf16*>(v),
                         ks, vs);
}

}  // namespace

// The fp32-q instances (the CUDA cores); bf16 q takes flash_attention_tc.
// kv_code: 0 for fp32 K/V, 1 for bf16 K/V (an fp32 model over a bf16
// cache: K/V widened exactly to fp32, p rounded to bf16 before P.V as
// p.astype(v.dtype)); q and the output are fp32 either way.
// (head_dim, v_head_dim): (64, 64), (80, 80), (128, 128) or MLA's
// (192, 128). Strides are in elements; the output is a contiguous (B, Sq,
// H, v_head_dim) tensor, lse a contiguous (B, Sq, H) fp32 one or null.
// H / Hkv must be an integer. soft_cap <= 0 means none. Returns a
// cudaError_t; asynchronous on `stream`.
extern "C" int flash_attention(int kv_code, int head_dim, int v_head_dim, const void* q,
                               const void* k, const void* v,
                               const int* q_positions, const int* kv_valid_len,
                               void* out, float* lse, int B, int Sq, int Sk, int H, int Hkv,
                               long long q_sb, long long q_ss, long long q_sh,
                               long long k_sb, long long k_ss, long long k_sh,
                               long long v_sb, long long v_ss, long long v_sh,
                               float scale, float soft_cap, int causal,
                               void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (Hkv < 1 || H % Hkv) return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_LAUNCH(KV, D, Dv)                                                           \
  return launch<float, KV, D, Dv>(q, k, v, q_positions, kv_valid_len, out, lse, B, Sq, Sk, H, \
                                  Hkv, qs, ks, vs, scale, soft_cap, causal, s)
#define FA_DIMS(KV)                                                      \
  if (head_dim == 64 && v_head_dim == 64) FA_LAUNCH(KV, 64, 64);         \
  if (head_dim == 80 && v_head_dim == 80) FA_LAUNCH(KV, 80, 80);         \
  if (head_dim == 128 && v_head_dim == 128) FA_LAUNCH(KV, 128, 128);     \
  if (head_dim == 192 && v_head_dim == 128) FA_LAUNCH(KV, 192, 128);
  if (kv_code == 0) { FA_DIMS(float) }
  if (kv_code == 1) { FA_DIMS(__nv_bfloat16) }
#undef FA_DIMS
#undef FA_LAUNCH
  return cudaErrorInvalidValue;
}

// The bf16 instances (the tensor cores). splits = 0 takes the rows route;
// splits = 1..8 the split route, which puts `splits` CTAs of one cluster on
// each m16 tile of rows of a (kv head, batch row). (head_dim, v_head_dim)
// as for flash_attention; H / Hkv any integer. q_positions may be null (the
// bottom-right default, s + Sk - Sq) and kv_valid_len null (Sk); a given
// kv_valid_len is clamped to Sk here. Strides, output, lse and return as
// for flash_attention.
extern "C" int flash_attention_tc(int head_dim, int v_head_dim, int splits, const void* q,
                                  const void* k,
                                  const void* v, const int* q_positions,
                                  const int* kv_valid_len, void* out, float* lse, int B,
                                  int Sq, int Sk,
                                  int H, int Hkv, long long q_sb, long long q_ss,
                                  long long q_sh, long long k_sb, long long k_ss,
                                  long long k_sh, long long v_sb, long long v_ss,
                                  long long v_sh, float scale, float soft_cap, int causal,
                                  void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (Hkv < 1 || H % Hkv || splits < 0 || splits > am::kMaxSplits) return cudaErrorInvalidValue;
  const am::Params p{static_cast<const am::bf16*>(q), q_sb, q_ss, q_sh, q_positions,
                     kv_valid_len, static_cast<am::bf16*>(out), Sq, H, Hkv, Sk, Sk - Sq,
                     scale, soft_cap, causal, splits, lse};
  const Strides ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_TC(D, Dv)                                                       \
  if (head_dim == D && v_head_dim == Dv)                                   \
    return splits ? launch_tc<D, Dv, true>(p, k, v, B, splits, ks, vs, s) \
                  : launch_tc<D, Dv, false>(p, k, v, B, 0, ks, vs, s);
  FA_TC(64, 64)
  FA_TC(80, 80)
  FA_TC(128, 128)
  FA_TC(192, 128)
#undef FA_TC
  return cudaErrorInvalidValue;
}

extern "C" const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
