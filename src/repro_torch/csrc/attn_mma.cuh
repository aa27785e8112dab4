// The tensor-core attention tile shared by the bf16 instances of K3
// (csrc/flash_attention.cu) and K4 (csrc/paged_attention.cu), for Hopper
// (sm_90a).
//
// Both kernels compute the same function, the TPU kernels'
// (repro/kernels/flash_attention.py::_kernel, paged_attention.py::_kernel):
// rows are (query position, head) pairs; key col is visible to a row iff
// col < kv_valid_len[b] and, when causal, col <= the row's position; fp32
// scores s = q.k * scale (cap * tanh(s / cap) when cap > 0), fp32 running
// max m and sum l, p zeroed where invalid, p rounded to bf16 before P.V
// (the reference's p.astype(v.dtype)), and out = acc / max(l, 1e-30), so a
// row that sees no key is exactly 0. They differ only in where a key's row
// of K and V lies: a strided dense cache, or a page named by a block table.
// So the CTA body here is templated on a key source (DenseKV, PagedKV).
//
// The warp tile: 16 rows, mma.sync.m16n8k16 (bf16 in, fp32 accumulate).
// The rows' Q is loaded once by ldmatrix into A fragments and held in
// registers for the whole key walk. S = Q.K^T takes K as the B operand by
// ldmatrix from shared memory (a key's D values are contiguous, which is
// the B operand's "col" layout); the scale, soft cap and validity are
// applied to the fp32 accumulator fragments; each row's max and sum are
// reduced across the quad of lanes that hold it (two __shfl_xor_sync);
// p is rounded to bf16 in registers and fed straight back as the A
// fragment of P.V (the S accumulator layout of two n8 tiles is the A
// layout of one k16 step); V is the B operand through ldmatrix.trans.
// Rows are (query position, head-in-group) pairs with the GQA group folded
// in, so each K/V tile is read from memory once per CTA for every head
// that shares it.
//
// Shared rows of K, V and Q are padded to 2 D + 16 bytes: (D / 8 + 1)
// 16-byte chunks, an odd number for every D that is a multiple of 16, so
// the eight rows an ldmatrix phase reads fall on eight distinct bank
// groups (a plain 128-byte row at D 64 would be an 8-way conflict).
// Keys arrive 64 at a time by 16-byte cp.async (zero-filled, and never
// read, past the CTA's last visible key) into a two-stage ring: the next
// stage is in flight while this one is multiplied.
//
// Two routes, by rows = query positions of a CTA x rep:
//
// * rows (Sq x rep > 16: encoders, prefill buckets, chunks): 4 warps own
//   64 rows, 16 each (64 / rep query positions), and each warp walks every
//   64-key stage. A warp skips a stage past its own rows' last visible key
//   (bitwise the same as computing it: every p there is 0 and the max is
//   unchanged). Over int8 keys a rows-route CTA holds one m16 tile and
//   walks its keys as a split-route CTA does (below).
// * split (Sq x rep <= 16: decode): one m16 row tile. The keys are cut in
//   16-key tiles; the CTAs of a thread-block cluster (up to 8, one per
//   blockIdx.x) take even shares of them, and within a stage warp w takes
//   keys 16 w .. 16 w + 15. Each warp's partial (m, l, acc) is merged with
//   the others' in warp order through shared memory, then the CTAs'
//   partials in rank order through distributed shared memory: no atomics,
//   no workspace, the same bits every run. The split count comes from
//   shapes the host knows (B, Hkv, the keys in memory) and never from
//   kv_valid_len: each CTA clips its share to the last visible key on the
//   device, and an empty share contributes (m = -1e30, l = 0, acc = 0).
//   One CTA (gridDim.x = 1) takes the same path without the cluster.
//
// Rounding: p is rounded to bf16 against the running max of the warp (and
// CTA) that scored it, not the one global running max of a sequential
// walk. Either way p = exp(s - m) <= 1 is rounded to bf16 once, with the
// same relative error (2^-9), and the merge rescales it by the exact fp32
// factor exp(m_part - m); the result stays within ATTN_TOLS["bfloat16"]
// of the plain version (tests/test_torch_cuda.py).
//
// int8 pools (K5, bf16 q): the key source is PagedKV<int8_t>. A key's row
// of one kv head is D contiguous bytes and arrives as it is, by 16-byte
// cp.async, into a ring of int8 stages (half the bytes of a bf16 stage).
// ldmatrix moves 16-bit elements only, so each landed stage is converted
// once, in shared memory, into one bf16 stage of the padded layout above
// (an int8 value is exact in bf16), and the Q.K^T and P.V code reads it
// as it reads bf16 pools. A pass in shared memory and not a conversion in
// registers: the B fragments of both products then come from ldmatrix
// unchanged (V's by .trans, which a register conversion would have to
// redo byte by byte), and the pass costs one read and two writes of 16
// bytes a thread per 16 keys of a row, beside a 64-key stage of mma work.
// The (page, kv head) scales ride the block-table entries prepare()
// copies (clipped to the visible keys like them): a 16-key tile is one
// page at ps 16, half a page at ps 32 and two pages at ps 8, so scales are
// looked up per 8-key n8 tile, which always lies in one page. Each S
// column is multiplied by its k scale after the exact product; the v
// scale is folded into p after the row sum, before P.V. p is not rounded
// to bf16 (the reference dequantizes pages to fp32, so p.astype(v.dtype)
// is the identity): p' = p * v_scale is split into hi = bf16(p') and
// lo = bf16(p' - hi), and P.V runs two mma a k16 step, which carries p' to
// 2^-18 relative (the product with an int8 V is exact).
//
// int8 pools: a row's result must not depend on the route. A request that
// is preempted is re-prefilled (rows) over keys it decoded (split), and the
// int8 KV write keeps its stream identical to a solo run's only if each
// row's attention is the same bits either way. So on the rows route a CTA
// over int8 pools takes one m16 tile of rows (16 / rep query positions) and
// walks its keys as the split route does, a stage's keys over the four
// warps, merged in warp order: per row the same products, maxima,
// exponentials and sums in the same order. With one CTA per (kv head, batch
// row) on the split route (split_count 1, caches under 512 keys) the two
// routes agree bitwise; the CTAs of a cluster (from 512 keys) merge their
// partials in rank order as for bf16.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_mma {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockN = 64;       // keys per stage of the ring
constexpr int kStages = 2;
constexpr int kRowsTile = 64;     // rows route: rows per CTA, 16 a warp
constexpr int kSplitRows = 16;    // split route: one m16 tile
constexpr int kMaxSplits = 8;     // CTAs of one cluster sharing a row tile
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <int D> struct Geo {
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "head_dim: a multiple of 16 up to 128");
  static constexpr int kChunks = D / 8;             // 16-byte chunks of a row
  static constexpr int kRowBytes = 2 * D + 16;      // padded: an odd number of chunks
  static constexpr int kTileBytes = kBlockN * kRowBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;  // K, then V
  static constexpr int kInt8TileBytes = kBlockN * D;  // int8 keys as they arrive, unpadded
};

// Rows a CTA holds: one m16 tile on the split route and for int8 keys (see
// header), kRowsTile on the rows route over bf16 keys.
template <bool kSplit, bool kInt8> __host__ __device__ constexpr int cta_rows() {
  return kSplit || kInt8 ? kSplitRows : kRowsTile;
}

// kInt8: the ring holds kStages int8 stages, then the one bf16 stage they
// are converted into.
template <int D, bool kSplit, bool kInt8 = false> struct Smem {
  static constexpr int kQRows = cta_rows<kSplit, kInt8>();
  static constexpr int kQBytes = kQRows * Geo<D>::kRowBytes;
  static constexpr int kRingBytes =
      kInt8 ? kStages * 2 * Geo<D>::kInt8TileBytes + Geo<D>::kStageBytes
            : kStages * Geo<D>::kStageBytes;
  // What the attention uses; a key source may append its own (PagedKV's
  // block-table entries) at this offset.
  static constexpr int kBytes = kQBytes + kRingBytes + kQRows * 4;
  // The split route's merge reuses the ring: four warps' (16, D) partials,
  // their m, l and weights, then the CTA's m, l, 1 / l and (16, D) partial.
  static constexpr int kMergeBytes = (4 * 16 * D + 3 * 4 * 16 + 3 * 16 + 16 * D) * 4;
  static_assert(kMergeBytes <= kRingBytes, "the merge fits in the ring");
};

// What both kernels take besides their key source.
struct Params {
  const bf16* q;                  // (B, Sq, H, D) through its element strides
  long long q_sb, q_ss, q_sh;
  const int* q_positions;         // (B, Sq); -1 = masked row; null: s + pos_offset
  const int* kv_valid_len;        // (B,), clamped to n_keys here; null: n_keys
  bf16* out;                      // (B, Sq, H, D), contiguous
  int Sq, H, Hkv, n_keys;         // n_keys: keys in memory (Sk, or nb * ps)
  int pos_offset;                 // the default position of query s is s + pos_offset
  float scale, soft_cap;          // soft_cap <= 0: none
  int causal;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
// Two fp32 values as one bf16x2 register, round-to-nearest-even; lo in the
// low half (the lower column of a fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// p' as the sum of two bf16x2 A-fragment registers, hi = bf16(p') and
// lo = bf16(p' - hi): together p' to 2^-18 relative.
__device__ __forceinline__ void split_bf16(float lo_col, float hi_col, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(lo_col, hi_col);
  lo = pack_bf16(lo_col - __uint_as_float(hi << 16), hi_col - __uint_as_float(hi & 0xffff0000u));
}
// 16 int8 values (one 16-byte chunk) as 16 bf16 (two chunks), exactly: a
// float of an int8 has its low 16 mantissa bits zero, so its high half is
// the bf16.
__device__ __forceinline__ void int8x16_to_bf16(const int4 in, int4 (&out)[2]) {
  const uint32_t w[4] = {static_cast<uint32_t>(in.x), static_cast<uint32_t>(in.y),
                         static_cast<uint32_t>(in.z), static_cast<uint32_t>(in.w)};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t x = w[i / 2] >> (16 * (i % 2));
    const float a = static_cast<float>(static_cast<int8_t>(x & 0xffu));
    const float b = static_cast<float>(static_cast<int8_t>((x >> 8) & 0xffu));
    o[i] = __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
  }
  out[0] = make_int4(o[0], o[1], o[2], o[3]);
  out[1] = make_int4(o[4], o[5], o[6], o[7]);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// Keys of a dense (B, Sk, Hkv, D) cache, already offset to (b, g).
struct DenseKV {
  const bf16* k;
  const bf16* v;
  long long k_ss, v_ss;
  static constexpr bool kTable = false, kInt8 = false;
  __device__ __forceinline__ void prepare(int, int, void*) {}
  __device__ __forceinline__ const bf16* k_row(int col) const { return k + col * k_ss; }
  __device__ __forceinline__ const bf16* v_row(int col) const { return v + col * v_ss; }
};

// Keys of (P, ps, Hkv, D) page pools (T = bf16, or int8 with fp32 (P, Hkv)
// scales) through the block-table row of b. prepare() copies the entries
// of keys [lo, hi) into shared memory once, with, for int8 pools, each
// entry's k and v scales of kv head g; entries past the last visible key
// are never read, nor are the scales of their pages, so they may hold any
// value.
template <class T> struct PagedKV {
  const T* kp;                    // pools offset to kv head g
  const T* vp;
  const float* ks;                // int8: scales offset to kv head g (stride Hkv)
  const float* vs;
  const int* table;               // block_tables[b]
  long long token_stride;         // Hkv * D: elements between a page's tokens
  int lg_ps, nb, Hkv, j0;         // nb: entries a table row holds
  const int* tab;                 // the copied entries, from page j0
  const float* ksc;               // int8: their scales
  const float* vsc;
  static constexpr bool kTable = true;
  static constexpr bool kInt8 = sizeof(T) == 1;
  // Shared memory the copies take beyond Smem<...>::kBytes.
  static constexpr int shared_bytes(int nb) { return (kInt8 ? 12 : 4) * nb; }
  __device__ __forceinline__ void prepare(int lo, int hi, void* shared) {
    int* tab_s = static_cast<int*>(shared);
    float* ksc_s = reinterpret_cast<float*>(tab_s + nb);
    float* vsc_s = ksc_s + nb;
    tab = tab_s;
    ksc = ksc_s;
    vsc = vsc_s;
    j0 = lo >> lg_ps;
    if (hi <= lo) return;
    const int n = ((hi - 1) >> lg_ps) - j0 + 1;
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int page = table[j0 + j];
      tab_s[j] = page;
      if constexpr (kInt8) {
        ksc_s[j] = ks[static_cast<long long>(page) * Hkv];
        vsc_s[j] = vs[static_cast<long long>(page) * Hkv];
      }
    }
  }
  __device__ __forceinline__ long long token(int col) const {
    const long long page = tab[(col >> lg_ps) - j0];
    return ((page << lg_ps) + (col & ((1 << lg_ps) - 1))) * token_stride;
  }
  __device__ __forceinline__ const T* k_row(int col) const { return kp + token(col); }
  __device__ __forceinline__ const T* v_row(int col) const { return vp + token(col); }
  // the scales of the page holding visible key col
  __device__ __forceinline__ float k_scale(int col) const { return ksc[(col >> lg_ps) - j0]; }
  __device__ __forceinline__ float v_scale(int col) const { return vsc[(col >> lg_ps) - j0]; }
};

// The CTA (x, g = blockIdx.y, b = blockIdx.z): x is the query tile on the
// rows route, the split rank on the split route (gridDim.x CTAs of one
// cluster). `smem` holds Smem<D, kSplit, Src::kInt8>::kBytes, then the key
// source's.
template <int D, bool kSplit, class Src>
__device__ __forceinline__ void attend(const Params& p, Src& src, uint8_t* smem) {
  using G = Geo<D>;
  constexpr bool kI8 = Src::kInt8;
  using S = Smem<D, kSplit, kI8>;
  // A staged key row: bf16 padded for ldmatrix, int8 as it arrives.
  constexpr int kSrcChunks = kI8 ? D / 16 : G::kChunks;
  constexpr int kSrcRowBytes = kI8 ? D : G::kRowBytes;
  constexpr int kSrcTileBytes = kBlockN * kSrcRowBytes;
  // One m16 row tile a CTA, a stage's keys split over the warps: the split
  // route, and the rows route over int8 keys (see header).
  constexpr bool kTile = cta_rows<kSplit, kI8>() == kSplitRows;
  constexpr int NT = kTile ? 2 : 8;             // n8 key tiles a warp takes from a stage
  const int tid = threadIdx.x, w = tid >> 5, l = tid & 31;
  const int g = blockIdx.y, b = blockIdx.z;
  const int rep = p.H / p.Hkv;
  const int qt = kSplit ? p.Sq : cta_rows<kSplit, kI8>() / rep;  // query positions of the CTA
  const int s0 = kSplit ? 0 : blockIdx.x * qt;
  const int n_rows = min(qt, p.Sq - s0) * rep;  // row r: s0 + r / rep, head g * rep + r % rep
  const int z = kSplit ? blockIdx.x : 0, nz = kSplit ? gridDim.x : 1;

  uint8_t* qs = smem;
  uint8_t* ring = smem + S::kQBytes;
  int* qpos_s = reinterpret_cast<int*>(ring + S::kRingBytes);

  // What does not depend on the key range goes out at once: the valid
  // length, the rows' positions (read only when causal) and Q (zero past
  // n_rows; its own cp.async group, ahead of the first stage's).
  const int kv_valid = p.kv_valid_len ? p.kv_valid_len[b] : p.n_keys;
  for (int r = tid; r < S::kQRows; r += kThreads) {
    const int s = s0 + r / rep;
    qpos_s[r] = r >= n_rows || !p.causal ? -1
                : p.q_positions          ? p.q_positions[static_cast<long long>(b) * p.Sq + s]
                                         : s + p.pos_offset;
  }
#pragma unroll
  for (int i = 0; i < (S::kQRows * G::kChunks + kThreads - 1) / kThreads; ++i) {
    const int c = tid + i * kThreads;
    if (c >= S::kQRows * G::kChunks) break;
    const int r = c / G::kChunks, ch = c % G::kChunks;
    const bool ok = r < n_rows;
    const bf16* from = p.q;
    if (ok)
      from = p.q + b * p.q_sb + (s0 + r / rep) * p.q_ss + (g * rep + r % rep) * p.q_sh + ch * 8;
    cp_async16(smem_u32(qs + r * G::kRowBytes + ch * 16), from, ok);
  }
  cp_async_commit();
  __syncthreads();
  int qmax = -1;
  for (int r = 0; p.causal && r < n_rows; ++r) qmax = max(qmax, qpos_s[r]);
  const int kvlen = min(kv_valid, p.n_keys);
  // Keys [lo, hi) are all this CTA's rows can see of its share.
  const int kv_end = p.causal ? min(kvlen, qmax + 1) : kvlen;
  int lo = 0, hi = kv_end;
  if (kSplit) {                                 // CTA z: the z-th of nz even shares of 16-key tiles
    const int tiles = (p.n_keys + 15) / 16;
    lo = tiles * z / nz * 16;
    hi = min(tiles * (z + 1) / nz * 16, kv_end);
  }
  const int n_tiles = hi > lo ? (hi - lo + kBlockN - 1) / kBlockN : 0;

  src.prepare(lo, hi, smem + S::kBytes);
  if constexpr (Src::kTable) __syncthreads();            // the key source's shared entries are in place

  auto load = [&](int t, int stage) {
    uint8_t* kst = ring + stage * 2 * kSrcTileBytes;
    uint8_t* vst = kst + kSrcTileBytes;
    const int col0 = lo + t * kBlockN;
#pragma unroll
    for (int i = 0; i < (kBlockN * kSrcChunks + kThreads - 1) / kThreads; ++i) {
      const int c = tid + i * kThreads;
      if (c >= kBlockN * kSrcChunks) break;
      const int key = c / kSrcChunks, ch = c % kSrcChunks;
      const bool ok = col0 + key < hi;
      const uint8_t* kf = reinterpret_cast<const uint8_t*>(p.q);
      const uint8_t* vf = kf;
      if (ok) {
        kf = reinterpret_cast<const uint8_t*>(src.k_row(col0 + key)) + ch * 16;
        vf = reinterpret_cast<const uint8_t*>(src.v_row(col0 + key)) + ch * 16;
      }
      cp_async16(smem_u32(kst + key * kSrcRowBytes + ch * 16), kf, ok);
      cp_async16(smem_u32(vst + key * kSrcRowBytes + ch * 16), vf, ok);
    }
  };

  // This thread's rows (a, b = a + 8) of the warp's m16 tile, and the keys
  // of a stage the warp takes: all 64 (rows), or 16 w .. 16 w + 15 (split).
  const int r0 = kTile ? 0 : 16 * w;
  const int kb = kTile ? 16 * w : 0;
  const int gq = l >> 2, tq = l & 3;
  const bool ok_a = r0 + gq < n_rows, ok_b = r0 + gq + 8 < n_rows;
  // keys [lo, end) are visible to row a, b: past the row's position none is
  const int pos_a = qpos_s[r0 + gq], pos_b = qpos_s[r0 + gq + 8];
  const int end_a = ok_a ? (p.causal ? min(hi, pos_a + 1) : hi) : 0;
  const int end_b = ok_b ? (p.causal ? min(hi, pos_b + 1) : hi) : 0;
  int w_end = lo;                               // past the last key the warp's rows see
  for (int r = r0; r < min(r0 + 16, n_rows); ++r)
    w_end = p.causal ? max(w_end, min(hi, qpos_s[r] + 1)) : hi;

  uint32_t qf[D / 16][4];
  float m[2] = {kNegInf, kNegInf}, lsum[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  if (n_tiles > 0) load(0, 0);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load(t + 1, (t + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                            // stage t (and Q) landed for every thread
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(smem_u32(qs + (r0 + (l & 15)) * G::kRowBytes + (2 * kk + (l >> 4)) * 16),
                qf[kk]);
    }
    const uint8_t* kst = ring + (t % kStages) * G::kStageBytes;
    if constexpr (kI8) {
      // int8 stage t -> the bf16 stage after the ring, in ldmatrix's layout
      uint8_t* work = ring + kStages * 2 * kSrcTileBytes;
      const uint8_t* st8 = ring + (t % kStages) * 2 * kSrcTileBytes;
      for (int c = tid; c < 2 * kBlockN * kSrcChunks; c += kThreads) {
        const int half = c / (kBlockN * kSrcChunks), r = c % (kBlockN * kSrcChunks);
        const int key = r / kSrcChunks, ch = r % kSrcChunks;
        int4 o[2];
        int8x16_to_bf16(*reinterpret_cast<const int4*>(st8 + half * kSrcTileBytes + key * D + ch * 16),
                        o);
        int4* dst = reinterpret_cast<int4*>(work + half * G::kTileBytes + key * G::kRowBytes +
                                            ch * 32);
        dst[0] = o[0];
        dst[1] = o[1];
      }
      __syncthreads();                          // the converted stage is in place
      kst = work;
    }
    const int c0 = lo + t * kBlockN + kb;       // the warp's first key of the stage
    if (c0 < w_end) {
      const uint8_t* vst = kst + G::kTileBytes;
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      // S = Q K^T: per k16 step, the B fragments of two n8 key tiles
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          uint32_t r[4];
          ldsm_x4(smem_u32(kst + (kb + 16 * jp + (l & 7) + ((l >> 4) << 3)) * G::kRowBytes +
                           (2 * kk + ((l >> 3) & 1)) * 16),
                  r);
          mma_bf16(s[2 * jp], qf[kk], r[0], r[1]);
          mma_bf16(s[2 * jp + 1], qf[kk], r[2], r[3]);
        }
      // int8 pools: each n8 key tile (8 keys of one page) by its k scale;
      // a tile past the last visible key reads no scale
      if constexpr (kI8) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float sc = c0 + 8 * j < hi ? src.k_scale(c0 + 8 * j) : 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= sc;
        }
      }
      // the scale, and the soft cap behind one warp-uniform branch
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= p.scale;
      if (p.soft_cap > 0.f) {
        const float inv_cap = 1.f / p.soft_cap;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = p.soft_cap * tanhf(s[j][e] * inv_cap);
      }
      // fragment (j, e): row a (e < 2) or b, key c0 + 8 j + 2 tq + e % 2
      uint32_t valid = 0;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = c0 + 8 * j + 2 * tq + (e & 1) < (e < 2 ? end_a : end_b);
          s[j][e] = ok ? s[j][e] : kNegInf;
          valid |= static_cast<uint32_t>(ok) << (4 * j + e);
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(mx[i]));
        corr[i] = __expf(m[i] - m_new);
        m[i] = m_new;
        lsum[i] *= corr[i];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = (valid >> (4 * j + e)) & 1u ? __expf(s[j][e] - m[e >> 1]) : 0.f;
          lsum[e >> 1] += pe;
          s[j][e] = pe;
        }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][0] *= corr[0];
        acc[j][1] *= corr[0];
        acc[j][2] *= corr[1];
        acc[j][3] *= corr[1];
      }
      // P V: p in bf16 as the A fragment of each k16 step of keys; int8
      // pools: p' = p * v scale as hi + lo, two products a step
      if constexpr (kI8) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float sc = c0 + 8 * j < hi ? src.v_scale(c0 + 8 * j) : 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= sc;
        }
      }
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        uint32_t a[4], a_lo[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float* f = s[2 * kk + (x >> 1)] + 2 * (x & 1);
          if constexpr (kI8) split_bf16(f[0], f[1], a[x], a_lo[x]);
          else a[x] = pack_bf16(f[0], f[1]);
        }
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t r[4];
          ldsm_x4_trans(smem_u32(vst + (kb + 16 * kk + (l & 15)) * G::kRowBytes +
                                 (2 * dp + (l >> 4)) * 16),
                        r);
          mma_bf16(acc[2 * dp], a, r[0], r[1]);
          mma_bf16(acc[2 * dp + 1], a, r[2], r[3]);
          if constexpr (kI8) {
            mma_bf16(acc[2 * dp], a_lo, r[0], r[1]);
            mma_bf16(acc[2 * dp + 1], a_lo, r[2], r[3]);
          }
        }
      }
    }
    __syncthreads();                            // every warp is done with stage t
  }
  cp_async_wait<0>();
  __syncthreads();                              // the ring is free
#pragma unroll
  for (int i = 0; i < 2; ++i) lsum[i] = quad_sum(lsum[i]);

  // fragment (j, e) of acc: row a (e < 2) or b, dim 8 j + 2 tq + e % 2
  auto out_row = [&](int r) {
    const int s = s0 + r / rep, h = g * rep + r % rep;
    return p.out + ((static_cast<long long>(b) * p.Sq + s) * p.H + h) * D;
  };
  if (!kTile) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!(i ? ok_b : ok_a)) continue;
      // one division a row (a row with no key: acc = 0, so 0 * 1e30 = 0)
      const float inv = 1.f / fmaxf(lsum[i], 1e-30f);
      bf16* o = out_row(r0 + gq + 8 * i) + 2 * tq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =
            __floats2bfloat162_rn(acc[j][2 * i] * inv, acc[j][2 * i + 1] * inv);
    }
    return;
  }

  // One row tile: the warps' partials, merged in warp order.
  float* red = reinterpret_cast<float*>(ring);  // [warp][row][D]
  float* red_m = red + 4 * 16 * D;              // [warp][row]
  float* red_l = red_m + 64;
  float* wgt = red_l + 64;                      // exp(m_warp - m_cta), [warp][row]
  float* cta_m = wgt + 64;                      // this CTA's partial: [row]
  float* cta_l = cta_m + 16;
  float* cta_inv = cta_l + 16;                  // 1 / max(l, 1e-30), for nz = 1
  float* cta_acc = cta_inv + 16;                // [row][D]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = gq + 8 * i;
    float* dst = red + (w * 16 + r) * D + 2 * tq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      dst[8 * j] = acc[j][2 * i];
      dst[8 * j + 1] = acc[j][2 * i + 1];
    }
    if (tq == 0) {
      red_m[w * 16 + r] = m[i];
      red_l[w * 16 + r] = lsum[i];
    }
  }
  __syncthreads();
  if (tid < 16) {
    float mc = red_m[tid];
    for (int u = 1; u < kWarps; ++u) mc = fmaxf(mc, red_m[u * 16 + tid]);
    float lc = 0.f;
    for (int u = 0; u < kWarps; ++u) {
      const float wu = __expf(red_m[u * 16 + tid] - mc);
      wgt[u * 16 + tid] = wu;
      lc += red_l[u * 16 + tid] * wu;
    }
    cta_m[tid] = mc;
    cta_l[tid] = lc;
    cta_inv[tid] = 1.f / fmaxf(lc, 1e-30f);
  }
  __syncthreads();
  for (int e = tid; e < 16 * D; e += kThreads) {
    const int r = e / D;
    float a = 0.f;
    for (int u = 0; u < kWarps; ++u) a += red[u * 16 * D + e] * wgt[u * 16 + r];
    if (nz == 1) {
      if (r < n_rows) out_row(r)[e % D] = __float2bfloat16(a * cta_inv[r]);
    } else {
      cta_acc[e] = a;
    }
  }
  if (nz == 1) return;

  // The cluster's CTAs' partials, merged in rank order; CTA z writes the
  // z-th of nz even shares of the (16, D) tile.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                               // every rank's partial is in its shared memory
  const int e_lo = 16 * D * z / nz, e_hi = 16 * D * (z + 1) / nz;
  for (int e = e_lo + tid; e < e_hi; e += kThreads) {
    const int r = e / D;
    if (r >= n_rows) continue;
    float mc = kNegInf;
    for (int u = 0; u < nz; ++u) mc = fmaxf(mc, cluster.map_shared_rank(cta_m, u)[r]);
    float a = 0.f, lc = 0.f;
    for (int u = 0; u < nz; ++u) {
      const float wu = __expf(cluster.map_shared_rank(cta_m, u)[r] - mc);
      a += cluster.map_shared_rank(cta_acc, u)[e] * wu;
      lc += cluster.map_shared_rank(cta_l, u)[r] * wu;
    }
    out_row(r)[e % D] = __float2bfloat16(a / fmaxf(lc, 1e-30f));
  }
  cluster.sync();                               // no rank leaves while another still reads it
}

// Raise a kernel's dynamic shared memory limit to `bytes` when it is past
// the default 48 KB and past what was granted before (`have`, per kernel).
template <class Kernel>
cudaError_t reserve_smem(Kernel kernel, int bytes, int& have) {
  if (bytes <= 48 * 1024 || bytes <= have) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) have = bytes;
  return err;
}

// Launch `kernel` on a grid of (x, Hkv, B) CTAs of kThreads; with
// cluster_x > 1 the x CTAs of one (g, b) form a cluster.
template <class Kernel, class... Args>
cudaError_t launch_grid(Kernel kernel, dim3 grid, int cluster_x, int smem, cudaStream_t s,
                   Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = cluster_x;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = cluster_x > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace attn_mma
