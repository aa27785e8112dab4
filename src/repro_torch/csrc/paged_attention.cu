// Paged (block-table) flash attention for Hopper (sm_90a): K4 and K5.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py::_kernel:
// paged_attn_rows_kernel / paged_attn_split_kernel for bf16 pools and
// paged_attn_kernel for fp32 pools (K4); paged_attn_int8_rows_kernel /
// paged_attn_int8_split_kernel for its int8 branch with bf16 q and
// paged_attn_int8_kernel with fp32 q (K5). Contract, as there:
//
//   q (B, Sq, H, D) model layout; k/v pools (P, ps, Hkv, D|Dv);
//   block_tables (B, nb) int32: logical key block j of row b is physical
//   page block_tables[b, j]; q_positions (B, Sq) int32 (-1 = masked row);
//   kv_valid_len (B,) int32, clamped to nb * ps by the caller.
//   Key col (a LOGICAL position, j * ps + t) is visible to query row i iff
//   col < kv_valid_len[b] and, when causal, col <= q_positions[b, i].
//   Online softmax in fp32; p is zeroed where invalid; p is rounded to the
//   pool dtype before the P.V product, as the TPU kernel's
//   p.astype(v.dtype) does (an int8 page is dequantized to fp32 first, so
//   there p is not rounded); the flush divides by max(l, 1e-30), so a row
//   that sees no key is exactly 0. Keys past the valid length or beyond
//   every row's causal frontier are skipped, and the block-table entries
//   that name them are never read: they may hold any value.
//
// What bounds it on an H100: the bytes of the visible K/V pages (decode
// reads every populated page of every slot once per layer), so HBM
// bandwidth, and how many SMs share that read; int8 pages halve them
// against bf16.
//
// bf16 pools (K4) and int8 pools with bf16 q (K5) run on the tensor cores,
// through the warp tile of attn_mma.cuh, with keys fetched through the
// block table (PagedKV<bf16>, PagedKV<int8_t>): the CTA copies the table
// entries of its keys into shared memory once (for int8 pools with each
// page's k and v scales), and each key's row of one kv head (D * 2
// contiguous bytes of a bf16 pool, D bytes of an int8 one) arrives by
// 16-byte cp.async into a two-stage ring of 64 keys, the next 64 in flight
// while these are multiplied: at ps 16 and D 64 a bf16 page is 128 chunks,
// one per thread. An int8 stage is converted to bf16 in shared memory once
// it lands (attn_mma.cuh's header says where the scales go and how p
// escapes rounding). A 16-key tile of the warp tile is one page of 16, half
// a page of 32, or two pages of 8. Two routes, picked by rows = query
// positions x rep (kernels/flash_attention.py::route_for, shared with K3):
//
// * paged_attn_split_kernel, paged_attn_int8_split_kernel (rows <= 16:
//   decode): the keys of each (g, b) split over the 4 warps, a page of 16
//   each, and for caches of 512 keys and more over up to 8 CTAs of a
//   cluster, merged in warp and rank order. At smollm-135m's decode a CTA
//   takes a slot's 16 pages four at a time with the next four in flight,
//   where the CUDA-core kernel staged them one at a time in 16 serial
//   rounds.
// * paged_attn_rows_kernel (rows > 16: the prefill buckets, chunks): 64
//   rows a CTA, 16 a warp, walking every visible page.
//   paged_attn_int8_rows_kernel: one m16 tile of rows a CTA, its keys
//   walked as on the split route, so that a row's result is the same bits
//   on both routes (attn_mma.cuh's header says why serving needs that).
//
// fp32 q (K4 over fp32 pools, TF32 off; K5 over int8 pools) keeps the
// CUDA-core body paged_attn_body: one CTA per (query tile, kv head g, batch
// row b), GQA folded into the CTA (at most 16 rows), each page staged
// element by element into fp32 shared tiles (an int8 element as float(x) *
// scale, the (page, g) scale riding the same indirection as the page), lane
// t scoring key t of the page (page_size <= 32) and lane d accumulating
// output dims d, d + 32, ... (head_dim <= 128). As in the TPU kernel, which
// dequantizes a page to fp32 before the block step, an int8 pool's p is NOT
// rounded before P.V.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_mma.cuh"

namespace {

namespace am = attn_mma;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRows = 16;            // rows (query position x head) per CTA
constexpr int kRowsPerWarp = kMaxRows / kWarps;
constexpr int kMaxPage = 32;            // page_size <= 32: one key per lane
constexpr int kMaxD = 128;              // head_dim <= 128
constexpr int kDPerLane = kMaxD / 32;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// A pool element as fp32: fp32 pools are, int8 pools dequantize by the
// (page, kv head) scale (one fp32 product, as x.astype(f32) * s).
__device__ __forceinline__ float from_pool(float x, float) { return x; }
__device__ __forceinline__ float from_pool(int8_t x, float s) {
  return __fmul_rn(static_cast<float>(x), s);
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

// The CTA body: fp32 q and output; KV the pools' dtype. k_scales and
// v_scales are read only for int8 pools.
template <typename KV>
__device__ __forceinline__ void paged_attn_body(
    const float* __restrict__ q, const KV* __restrict__ kp, const KV* __restrict__ vp,
    const float* __restrict__ k_scales, const float* __restrict__ v_scales,
    const int* __restrict__ block_tables, const int* __restrict__ q_positions,
    const int* __restrict__ kv_valid_len, float* __restrict__ out, int Sq, int H, int Hkv,
    int D, int Dv, int ps, int nb, int qt, float scale, float soft_cap, int causal) {
  constexpr bool kInt8 = sizeof(KV) == 1;
  const int tile = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int rep = H / Hkv;
  const int s0 = tile * qt;
  const int n_rows = min(qt, Sq - s0) * rep;   // row r: s = s0 + r / rep, h = g * rep + r % rep
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  __shared__ float qs[kMaxRows][kMaxD];
  __shared__ float ks[kMaxPage][kMaxD + 1];    // +1: lane t reads row t, no bank conflicts
  __shared__ float vs[kMaxPage][kMaxD];
  __shared__ int qpos_s[kMaxRows];

  for (int e = tid; e < n_rows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int s = s0 + r / rep, h = g * rep + r % rep;
    qs[r][d] = q[((static_cast<size_t>(b) * Sq + s) * H + h) * D + d];
  }
  for (int r = tid; r < n_rows; r += kThreads)
    qpos_s[r] = q_positions[static_cast<size_t>(b) * Sq + s0 + r / rep];
  __syncthreads();

  const int kvlen = kv_valid_len[b];
  int qmax = -1;
  for (int r = 0; r < n_rows; ++r) qmax = max(qmax, qpos_s[r]);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < kDPerLane; ++u) acc[i][u] = 0.f;
  }

  for (int j = 0; j < nb; ++j) {
    const int col0 = j * ps;
    // Block-uniform skips: every later block is past the valid length, or
    // strictly in the future of every row of this CTA.
    if (col0 >= kvlen) break;
    if (causal && col0 > qmax) break;
    const size_t page = static_cast<size_t>(block_tables[static_cast<size_t>(b) * nb + j]);
    const float k_sc = kInt8 ? k_scales[page * Hkv + g] : 1.f;
    const float v_sc = kInt8 ? v_scales[page * Hkv + g] : 1.f;
    __syncthreads();                        // the previous page's readers are done
    for (int e = tid; e < ps * D; e += kThreads) {
      const int t = e / D, d = e % D;
      ks[t][d] = from_pool(kp[((page * ps + t) * Hkv + g) * D + d], k_sc);
    }
    for (int e = tid; e < ps * Dv; e += kThreads) {
      const int t = e / Dv, d = e % Dv;
      vs[t][d] = from_pool(vp[((page * ps + t) * Hkv + g) * Dv + d], v_sc);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + i * kWarps;
      if (r >= n_rows) continue;            // uniform across the warp
      const int col = col0 + lane;
      const bool valid = lane < ps && col < kvlen && (!causal || col <= qpos_s[r]);
      float s = kNegInf;
      if (valid) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += qs[r][d] * ks[lane][d];
        s = dot * scale;
        if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
      }
      const float m_new = fmaxf(m[i], warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p);
      float sum[kDPerLane];
#pragma unroll
      for (int u = 0; u < kDPerLane; ++u) sum[u] = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float pt = __shfl_sync(kFull, p, t);
#pragma unroll
        for (int u = 0; u < kDPerLane; ++u) {
          const int d = lane + 32 * u;
          if (d < Dv) sum[u] += pt * vs[t][d];
        }
      }
#pragma unroll
      for (int u = 0; u < kDPerLane; ++u) acc[i][u] = acc[i][u] * corr + sum[u];
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + i * kWarps;
    if (r >= n_rows) continue;
    const int s = s0 + r / rep, h = g * rep + r % rep;
    const float denom = fmaxf(l[i], 1e-30f);
    float* o = out + ((static_cast<size_t>(b) * Sq + s) * H + h) * Dv;
#pragma unroll
    for (int u = 0; u < kDPerLane; ++u) {
      const int d = lane + 32 * u;
      if (d < Dv) o[d] = acc[i][u] / denom;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const float* __restrict__ q, const float* __restrict__ kp,
                  const float* __restrict__ vp, const int* __restrict__ block_tables,
                  const int* __restrict__ q_positions,
                  const int* __restrict__ kv_valid_len, float* __restrict__ out,
                  int Sq, int H, int Hkv, int D, int Dv, int ps, int nb, int qt,
                  float scale, float soft_cap, int causal) {
  paged_attn_body<float>(q, kp, vp, nullptr, nullptr, block_tables, q_positions,
                         kv_valid_len, out, Sq, H, Hkv, D, Dv, ps, nb, qt, scale,
                         soft_cap, causal);
}

// K5 with fp32 q: int8 pools, per-(page, kv head) fp32 scales.
__global__ void __launch_bounds__(kThreads)
paged_attn_int8_kernel(const float* __restrict__ q, const int8_t* __restrict__ kp,
                       const int8_t* __restrict__ vp, const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ q_positions,
                       const int* __restrict__ kv_valid_len, float* __restrict__ out,
                       int Sq, int H, int Hkv, int D, int Dv, int ps, int nb, int qt,
                       float scale, float soft_cap, int causal) {
  paged_attn_body<int8_t>(q, kp, vp, k_scales, v_scales, block_tables, q_positions,
                          kv_valid_len, out, Sq, H, Hkv, D, Dv, ps, nb, qt, scale,
                          soft_cap, causal);
}

// The tensor-core instances: the attention of attn_mma.cuh over the pools
// (T = bf16, K4; T = int8_t with its scales, K5) through the block-table
// row of b.
template <int D, bool kSplit, class T>
__device__ __forceinline__ void paged_attn_tc(const am::Params& p, const T* kp, const T* vp,
                                              const float* ks, const float* vs,
                                              const int* block_tables, int nb, int lg_ps) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int g = blockIdx.y, b = blockIdx.z;
  am::PagedKV<T> src{kp + g * D, vp + g * D, ks ? ks + g : nullptr, vs ? vs + g : nullptr,
                     block_tables + static_cast<long long>(b) * nb,
                     static_cast<long long>(p.Hkv) * D, lg_ps, nb, p.Hkv};
  am::attend<D, kSplit>(p, src, smem);
}

#define PA_TC_KERNEL(NAME, SPLIT, T)                                                   \
  template <int D>                                                                    \
  __global__ void __launch_bounds__(am::kThreads)                                     \
  NAME(am::Params p, const T* kp, const T* vp, const float* ks, const float* vs,      \
       const int* block_tables, int nb, int lg_ps) {                                  \
    paged_attn_tc<D, SPLIT, T>(p, kp, vp, ks, vs, block_tables, nb, lg_ps);           \
  }
PA_TC_KERNEL(paged_attn_rows_kernel, false, am::bf16)
PA_TC_KERNEL(paged_attn_split_kernel, true, am::bf16)
PA_TC_KERNEL(paged_attn_int8_rows_kernel, false, int8_t)
PA_TC_KERNEL(paged_attn_int8_split_kernel, true, int8_t)
#undef PA_TC_KERNEL

// The kernel of a (D, route, pool dtype).
template <int D, bool kSplit, class T> auto tc_kernel() {
  if constexpr (sizeof(T) == 1)
    return kSplit ? paged_attn_int8_split_kernel<D> : paged_attn_int8_rows_kernel<D>;
  else
    return kSplit ? paged_attn_split_kernel<D> : paged_attn_rows_kernel<D>;
}

template <int D, bool kSplit, class T>
cudaError_t launch_tc(const am::Params& p, const void* kp, const void* vp, const float* ks,
                      const float* vs, const int* block_tables, int B, int nb, int lg_ps,
                      int splits, cudaStream_t stream) {
  // the attention's shared memory, then the block-table entries of a CTA's
  // keys (and, for int8 pools, their scales)
  const int smem =
      am::Smem<D, kSplit, sizeof(T) == 1>::kBytes + am::PagedKV<T>::shared_bytes(nb);
  const auto kernel = tc_kernel<D, kSplit, T>();
  static int granted = 0;
  const cudaError_t attr = am::reserve_smem(kernel, smem, granted);
  if (attr != cudaSuccess) return attr;
  const int qt = am::cta_rows<kSplit, sizeof(T) == 1>() / (p.H / p.Hkv);
  const dim3 grid(kSplit ? splits : (p.Sq + qt - 1) / qt, p.Hkv, B);
  return am::launch_grid(kernel, grid, kSplit ? splits : 1, smem, stream, p,
                         static_cast<const T*>(kp), static_cast<const T*>(vp), ks, vs,
                         block_tables, nb, lg_ps);
}

template <bool kSplit, class T>
cudaError_t launch_tc_d(int D, const am::Params& p, const void* kp, const void* vp,
                        const float* ks, const float* vs, const int* bt, int B, int nb,
                        int lg_ps, int splits, cudaStream_t s) {
  switch (D) {
#define PA_CASE(D_) \
    case D_: return launch_tc<D_, kSplit, T>(p, kp, vp, ks, vs, bt, B, nb, lg_ps, splits, s);
    PA_CASE(16) PA_CASE(32) PA_CASE(48) PA_CASE(64)
    PA_CASE(80) PA_CASE(96) PA_CASE(112) PA_CASE(128)
#undef PA_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The CUDA-core instances, fp32 q and output. pool_code: 0 for fp32 pools
// (K4), 2 for int8 pools (K5, with k_scales/v_scales fp32 (P, Hkv); null
// otherwise); bf16 q takes paged_attention_tc. qt: query positions per
// CTA, with qt * (H / Hkv) <= 16. soft_cap <= 0 means none. Returns a
// cudaError_t; asynchronous on `stream`.
extern "C" int paged_attention(int pool_code, const void* q, const void* k_pages,
                               const void* v_pages, const float* k_scales,
                               const float* v_scales, const int* block_tables,
                               const int* q_positions, const int* kv_valid_len, void* out,
                               int B, int Sq, int H, int Hkv, int D, int Dv, int ps, int nb,
                               int qt, float scale, float soft_cap, int causal, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (ps > kMaxPage || D > kMaxD || Dv > kMaxD || qt * (H / Hkv) > kMaxRows || qt < 1)
    return cudaErrorInvalidValue;
  const dim3 grid((Sq + qt - 1) / qt, Hkv, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  float* of = static_cast<float*>(out);
  if (pool_code == 0) {
    paged_attn_kernel<<<grid, kThreads, 0, s>>>(
        qf, static_cast<const float*>(k_pages), static_cast<const float*>(v_pages),
        block_tables, q_positions, kv_valid_len, of, Sq, H, Hkv, D, Dv, ps, nb, qt, scale,
        soft_cap, causal);
  } else if (pool_code == 2 && k_scales != nullptr && v_scales != nullptr) {
    paged_attn_int8_kernel<<<grid, kThreads, 0, s>>>(
        qf, static_cast<const int8_t*>(k_pages), static_cast<const int8_t*>(v_pages),
        k_scales, v_scales, block_tables, q_positions, kv_valid_len, of, Sq, H, Hkv, D, Dv,
        ps, nb, qt, scale, soft_cap, causal);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The tensor-core instances: bf16 q and output, contiguous; bf16 pools
// (K4, k_scales = v_scales = null) or int8 pools with fp32 (P, Hkv) scales
// (K5); head_dim a multiple of 16 up to 128 (Dv = D); page_size 8, 16 or
// 32; H / Hkv <= 16. q_positions may be null (the default, s) and
// kv_valid_len null (nb * ps); a given kv_valid_len is clamped to nb * ps
// here. splits = 0 takes the rows route (any Sq);
// splits = 1..8 the split route, which needs Sq * H / Hkv <= 16 and puts
// `splits` CTAs of one cluster on each (kv head, batch row). Returns a
// cudaError_t; asynchronous on `stream`.
extern "C" int paged_attention_tc(int D, int ps, int splits, const void* q,
                                  const void* k_pages, const void* v_pages,
                                  const float* k_scales, const float* v_scales,
                                  const int* block_tables, const int* q_positions,
                                  const int* kv_valid_len, void* out, int B, int Sq, int H,
                                  int Hkv, int nb, float scale, float soft_cap, int causal,
                                  void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (Hkv < 1 || H % Hkv || H / Hkv > am::kSplitRows) return cudaErrorInvalidValue;
  if (splits < 0 || splits > am::kMaxSplits || (splits > 0 && Sq * (H / Hkv) > am::kSplitRows))
    return cudaErrorInvalidValue;
  const int lg_ps = ps == 8 ? 3 : ps == 16 ? 4 : ps == 32 ? 5 : -1;
  if (lg_ps < 0 || nb < 1) return cudaErrorInvalidValue;
  const bool int8 = k_scales != nullptr;
  if (int8 != (v_scales != nullptr)) return cudaErrorInvalidValue;
  const long long q_ss = static_cast<long long>(H) * D;
  const am::Params p{static_cast<const am::bf16*>(q), Sq * q_ss, q_ss, D, q_positions,
                     kv_valid_len, static_cast<am::bf16*>(out), Sq, H, Hkv, nb * ps, 0,
                     scale, soft_cap, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *ks = k_scales, *vs = v_scales;
  const int* bt = block_tables;
  if (int8)
    return splits ? launch_tc_d<true, int8_t>(D, p, k_pages, v_pages, ks, vs, bt, B, nb, lg_ps,
                                              splits, s)
                  : launch_tc_d<false, int8_t>(D, p, k_pages, v_pages, ks, vs, bt, B, nb,
                                               lg_ps, 0, s);
  return splits ? launch_tc_d<true, am::bf16>(D, p, k_pages, v_pages, ks, vs, bt, B, nb, lg_ps,
                                              splits, s)
                : launch_tc_d<false, am::bf16>(D, p, k_pages, v_pages, ks, vs, bt, B, nb,
                                               lg_ps, 0, s);
}

extern "C" const char* pa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
