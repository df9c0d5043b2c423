// Paged-KV attention for Hopper (sm_90a): single-token decode (K4) and the
// multi-token verify / chunk append (K5), one kernel body.
//
// Replaces: trlx_tpu/ops/paged_attention.py::_paged_kernel (decode, reached
// through paged_attention_pallas / paged_decode_attention) and
// ::_paged_verify_kernel (verify, through paged_verify_attention_pallas /
// paged_verify_attention). Pools [NB,BS,Hkv,D] in the JAX layout (row stride
// Hkv*D, read as they are), block tables [B,MB] int32, lens [B] int32.
// int8 pools carry f32 per-row scales [NB,BS,Hkv]: k_scale folds into the
// scores, and v_scale into the probabilities AFTER they are summed into l
// (the algebra of paged_attention.py:214-234 and :96-107).
//
// - decode: q [B,H,D], one token per slot; lens count this step's token;
//   a query sees positions < lens. A slot with len 0 writes 0.
// - verify: q [B,Q,H,D], Q tokens appended per slot; lens count the tokens
//   BEFORE the append; query j sees positions < lens + j + 1.
//
// Both are one kernel body: the Q query tokens fold into the grouped-head
// row axis (row r is query r / rep, head r % rep of the CTA's kv head), and
// row r's mask limit is lens + r / rep + OFFSET, with OFFSET 0 for decode
// and 1 for verify. Decode's q [B,H,D] is verify's [B,1,H,D], so decode is
// the verify body at Q=1 with OFFSET 0: verify at Q=1 with lens runs the
// same block walk, products and reductions on the same values as decode
// with lens+1, bit for bit. The rows of a CTA are a function of Q, rep
// and the dtypes only (dispatch below), so both entry points tile alike.
//
// What bounds it on the H100: Q*rep query rows against a slot's context,
// ~4*Q*rep flops per KV element, far below the ~295 flops/byte ridge at the
// engine's Q <= 5 (chunked prefill's Q=64 is still under it): it is bound
// by the bytes of live K/V it must read (3.35 TB/s), and at a chunk append
// (one slot) by latency.
//
// bf16 queries (bf16 or int8 pools): tc::paged_mma_kernel, the products on
// the tensor cores (mma.sync.m16n8k16, bf16 in, f32 accumulate).
// - Rows on the M axis. A CTA owns one m16 tile of 16 rows (padded: 1 of 16
//   at decode with rep 1, 5 of 16 at Q=5); S = Q K^T puts keys on N, so the
//   C fragment of S is, rounded to bf16, the A fragment of O += P V, and P
//   never leaves registers. Keys on M (S^T = K Q^T, rows on n8) would waste
//   less of each mma, but its C fragment is not P V's A fragment: P would
//   go through shared memory or shuffles. The padding costs issue slots,
//   and the kernel is bound by bytes, not by the mma issue rate.
// - One CTA per (slot, kv head, 16-row tile), so a chunk append of 64 rows
//   runs 4 CTAs per kv head. The 4 warps split every 64-position step into
//   four 16-position slices (one k16 step of P V, two n8 tiles of Q K^T),
//   each keeping its own running max, sum and output in registers; at the
//   end the four partials are combined through shared memory in a fixed
//   order (no atomics: two launches give the same bits).
// - Many blocks in flight: each step gathers its 64 positions' K/V rows
//   through the block table (position p is row table[p / BS] * BS + p % BS,
//   any BS) with 16-byte cp.async, double-buffered, so the next step's bytes
//   load while this one computes. Positions at or past the tile's last
//   limit, or the table's reach MB*BS, are never read (zero-filled) and
//   masked. The per-element mask runs only on slices that reach past the
//   tile's first row's limit; a masked score is selected to -1e30 and its
//   probability to 0, never multiplied.
// - int8 pools: the raw rows and their scales are staged the same way; each
//   thread converts the chunks it copied to bf16 (exact: |x| <= 127) into a
//   shared bf16 tile; k_scale multiplies a score column after the product,
//   v_scale a probability after it is summed into l and before P is split
//   for P V.
// - P enters P V as two bf16 parts, hi = bf16(p) and lo = bf16(p - hi), so
//   P V keeps ~16 bits of each probability (bf16(p) alone keeps 8): the
//   output differs from the f32 reference by summation order, not by a bf16
//   rounding of P; the extra mma instructions cost no bytes.
// - D = 256 (GPT-J): Q's A fragments (64 registers beside O's 128) are read
//   again from the resident Q tile for each step instead of held in
//   registers.
// f32 queries (f32 or int8 pools) keep the first design (below), bit for bit:
// one CTA per (slot, kv head, row tile) converting each block's K/V rows to
// f32 in shared memory, one score per thread as an f32 FMA chain, the
// softmax one warp per row, the running max / sum / output in shared memory.
// Where a block's f32 tiles do not fit the CTA's shared memory (D = 256 at
// block sizes from 64), the walk stages part of a block at a time.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------- f32 (SIMT)

constexpr int ROW_TILE = 64;  // verify rows per CTA

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

size_t smem_bytes(int rows, int D, int KT) {
  // q_s [rows][D], acc_s [rows][D], k_s [KT][D+1], v_s [KT][D], p_s [rows][KT],
  // ks_s/vs_s [KT], m_s/l_s/alpha_s [rows]
  return sizeof(float) *
         (size_t)(2 * rows * D + KT * (D + 1) + KT * D + rows * KT + 2 * KT + 3 * rows);
}

// grid (B, Hkv, row tiles of tile_rows rows); q/out [B, Q, H, D] (decode:
// [B, H, D], Q = 1, one tile of rep rows). The walk stages KT positions at a
// time, KT a divisor of BS, so a step is KT consecutive rows of one block:
// KT = BS wherever that fits, and every block is one step as in this body's
// first design (STEPPED false: its code, and its speed); the dispatch takes
// smaller divisors of BS (and then fewer rows a tile) until the f32 tiles
// fit the CTA's shared memory (D = 256 at BS = 64 would take 280 KB).
template <typename QT, typename KVT, bool QUANT, bool VERIFY, bool STEPPED>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const QT* __restrict__ q, const KVT* __restrict__ k_pool,
                  const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, const int32_t* __restrict__ tables,
                  const int32_t* __restrict__ lens, QT* __restrict__ out, int Q, int H, int Hkv,
                  int D, int BS, int MB, int tile_rows, int KT, float scale) {
  constexpr int OFFSET = VERIFY ? 1 : 0;
  const int b = blockIdx.x;
  const int hk = blockIdx.y;
  const int rep = H / Hkv;
  const int r0 = blockIdx.z * tile_rows;  // first row of this tile in [0, Q*rep)
  const int rows = min(tile_rows, Q * rep - r0);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int DK = D + 1;

  extern __shared__ float smem[];
  float* q_s = smem;                 // [rows][D]
  float* acc_s = q_s + rows * D;     // [rows][D]
  float* k_s = acc_s + rows * D;     // [KT][D+1]
  float* v_s = k_s + KT * DK;        // [KT][D]
  float* p_s = v_s + KT * D;         // [rows][KT]
  float* ks_s = p_s + rows * KT;     // [KT]
  float* vs_s = ks_s + KT;           // [KT]
  float* m_s = vs_s + KT;            // [rows]
  float* l_s = m_s + rows;           // [rows]
  float* alpha_s = l_s + rows;       // [rows]

  const int len = lens[b];
  // row r sees positions below its limit (decode: len, without a divide in
  // the score loop); the tile's last row sees the most
  auto row_limit = [&](int r) -> int { return VERIFY ? len + (r0 + r) / rep + OFFSET : len; };
  const int n_steps = min((row_limit(rows - 1) + KT - 1) / KT, MB * (BS / KT));
  const int32_t* table = tables + (size_t)b * MB;

  // element i = r * D + d of the tile in q/out: row r is query (r0 + r) / rep,
  // head hk*rep + (r0 + r) % rep (decode: head hk*rep + r0 + r, contiguous)
  auto qo_index = [&](int i) -> size_t {
    if (!VERIFY) return ((size_t)b * H + (size_t)hk * rep + r0) * D + i;
    const int gr = r0 + i / D;
    return (((size_t)b * Q + gr / rep) * H + (size_t)hk * rep + gr % rep) * D + i % D;
  };

  for (int i = tid; i < rows * D; i += THREADS) {
    q_s[i] = to_f32(q[qo_index(i)]);
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < rows; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  for (int j = 0; j < n_steps; ++j) {
    __syncthreads();  // previous step's readers are done (and q_s/acc_s are set)
    const int p0 = j * KT;
    // the step's first pool row: KT divides BS, so a step is rows of one block
    const size_t row0 = STEPPED ? (size_t)table[p0 / BS] * BS + p0 % BS : (size_t)table[j] * BS;
    for (int i = tid; i < KT * D; i += THREADS) {
      const int t = i / D, d = i % D;
      const size_t src = ((row0 + t) * Hkv + hk) * D + d;
      k_s[t * DK + d] = to_f32(k_pool[src]);
      v_s[t * D + d] = to_f32(v_pool[src]);
    }
    if (QUANT) {
      for (int t = tid; t < KT; t += THREADS) {
        ks_s[t] = k_scale[(row0 + t) * Hkv + hk];
        vs_s[t] = v_scale[(row0 + t) * Hkv + hk];
      }
    }
    __syncthreads();

    // scores [rows][KT]; tokens at or past the row's limit are masked
    for (int i = tid; i < rows * KT; i += THREADS) {
      const int r = i / KT, t = i % KT;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(q_s[r * D + d], k_s[t * DK + d], dot);
      float s = dot * scale;
      if (QUANT) s *= ks_s[t];
      p_s[i] = p0 + t < row_limit(r) ? s : NEG_INF;
    }
    __syncthreads();

    // online-softmax update, one warp per query row
    for (int r = warp; r < rows; r += WARPS) {
      float m_cur = NEG_INF;
      for (int t = lane; t < KT; t += 32) m_cur = fmaxf(m_cur, p_s[r * KT + t]);
      for (int off = 16; off > 0; off >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, m_cur);
      float p_sum = 0.f;
      for (int t = lane; t < KT; t += 32) {
        // fully-masked steps keep m == NEG_INF; exp(s - m) would be exp(0) there
        float p = m_new > NEG_INF / 2 ? expf(p_s[r * KT + t] - m_new) : 0.f;
        p_sum += p;  // l sums p BEFORE the v_scale fold
        if (QUANT) p *= vs_s[t];
        p_s[r * KT + t] = p;
      }
      for (int off = 16; off > 0; off >>= 1)
        p_sum += __shfl_xor_sync(0xffffffffu, p_sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + p_sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < rows * D; i += THREADS) {
      const int r = i / D, d = i % D;
      float a = acc_s[i] * alpha_s[r];
      for (int t = 0; t < KT; ++t) a = fmaf(p_s[r * KT + t], v_s[t * D + d], a);
      acc_s[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < rows * D; i += THREADS) {
    const float l = l_s[i / D];
    out[qo_index(i)] = from_f32<QT>(acc_s[i] / (l == 0.f ? 1.f : l));
  }
}

// The dynamic shared memory a CTA may opt into on this device (232,448 B on the H100).
int smem_cap() {
  static const int cap = [] {
    int dev = 0, bytes = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return bytes;
  }();
  return cap;
}

template <typename QT, typename KVT, bool QUANT, bool VERIFY>
int launch(const void* q, const void* k_pool, const void* v_pool, const float* k_scale,
           const float* v_scale, const int32_t* tables, const int32_t* lens, void* out, int B,
           int Q, int H, int Hkv, int D, int BS, int MB, int tile_rows, float scale,
           cudaStream_t stream) {
  const int total_rows = Q * (H / Hkv);
  int kt = BS;  // the next smaller divisor of BS while the tiles do not fit (BS / 2 for a power of two)
  while (smem_bytes(tile_rows, D, kt) > (size_t)smem_cap() && kt > 16) {
    do --kt; while (BS % kt);
  }
  while (smem_bytes(tile_rows, D, kt) > (size_t)smem_cap() && tile_rows > 1) tile_rows = (tile_rows + 1) / 2;
  const size_t smem = smem_bytes(tile_rows, D, kt);
  // a block in one step (KT = BS) walks the table as this body's first design did
  auto kernel = kt < BS ? paged_attn_kernel<QT, KVT, QUANT, VERIFY, true>
                        : paged_attn_kernel<QT, KVT, QUANT, VERIFY, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, Hkv, (total_rows + tile_rows - 1) / tile_rows);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), k_scale, v_scale, tables, lens, static_cast<QT*>(out),
      Q, H, Hkv, D, BS, MB, tile_rows, kt, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- bf16 (tensor cores)

namespace tc {

// the shared tensor-core helpers (mma_sm90.cuh); THREADS and WARPS are the
// header's (equal to the SIMT body's)
using namespace ::sm90;
using sm90::THREADS;
using sm90::WARPS;

constexpr int ROWS = 16;           // query rows per CTA: one m16 tile
constexpr int STEP = TILE;         // positions per pipeline step
constexpr int SLICE = STEP / WARPS;  // positions per warp and step

// Shared memory of one CTA. The K/V tiles are Tile<D>'s padded bf16 rows;
// int8 pools stage their raw rows (D bytes each) and scales, converted into
// one bf16 K/V pair. After the walk the stages hold the warps' partials.
template <int D, bool QUANT>
struct Layout {
  static constexpr int ROW = Tile<D>::ROW_BYTES;
  static constexpr int Q_BYTES = ROWS * ROW;
  static constexpr int KV_BYTES = Tile<D>::BYTES;  // one bf16 K or V tile of STEP rows
  static constexpr int RAW = STEP * D;             // one int8 K or V tile
  static constexpr int STAGE = QUANT ? 2 * RAW + 2 * STEP * 4 : 2 * KV_BYTES;
  static constexpr int CONV = QUANT ? 2 * KV_BYTES : 0;
  static constexpr int WALK = Q_BYTES + CONV + 2 * STAGE;
  static constexpr int COMBINE = Q_BYTES + WARPS * ROWS * (D + 2) * 4;  // acc, m, l per warp
  static constexpr int BYTES = WALK > COMBINE ? WALK : COMBINE;
};

// 16 int8 values (one 16-byte chunk) -> 16 bf16 values at dst (32 bytes),
// exactly and without the quarter-rate int-to-float conversion: byte x + 128
// becomes the low mantissa byte of 2^23 (one byte permute), a subtraction of
// 2^23 + 128 leaves x as an f32, and the high halves of two such f32 (exact
// in bf16: |x| <= 128 has at most 8 significant bits) are one bf16 pair.
__device__ __forceinline__ void int8x16_to_bf16(const unsigned char* src, unsigned char* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t o[8];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const uint32_t biased = w[u] ^ 0x80808080u;  // x + 128 per byte
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + i)) - 8388736.f;
    o[2 * u] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
    o[2 * u + 1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// grid (B, Hkv, ceil(Q*rep / ROWS)); q/out [B, Q, H, D] (decode: Q = 1).
template <int D, bool QUANT>
__global__ void __launch_bounds__(THREADS)
paged_mma_kernel(const bf16* __restrict__ q, const unsigned char* __restrict__ k_pool,
                 const unsigned char* __restrict__ v_pool, const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale, const int32_t* __restrict__ tables,
                 const int32_t* __restrict__ lens, bf16* __restrict__ out, int Q, int H, int Hkv, int BS,
                 int MB, int offset, float scale) {
  using L = Layout<D, QUANT>;
  constexpr int E = QUANT ? 1 : 2;       // bytes per pool element
  constexpr int CPR = D * E / 16;        // 16-byte chunks per pool row
  extern __shared__ __align__(16) unsigned char smem[];

  const int b = blockIdx.x, hk = blockIdx.y, r0 = blockIdx.z * ROWS;
  const int rep = H / Hkv;
  const int R = min(ROWS, Q * rep - r0);  // real rows of this tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int len = lens[b];
  const int reach = MB * BS;
  // row r sees positions below its limit, never past the table's reach;
  // padded rows (r >= R) repeat the last real row
  auto limit = [&](int r) { return min(len + (r0 + min(r, R - 1)) / rep + offset, reach); };
  const int n_keys = limit(R - 1);  // the tile's last row sees the most
  const int lim_lo = limit(0);
  const int lim[2] = {limit(g), limit(g + 8)};
  const int n_steps = (n_keys + STEP - 1) / STEP;
  // element (row gr, column d) of q/out: query gr / rep, head hk*rep + gr % rep
  auto qo_row = [&](int gr) -> size_t { return (((size_t)b * Q + gr / rep) * H + hk * rep + gr % rep) * D; };

  const uint32_t q_s = smem_addr(smem), conv = q_s + L::Q_BYTES, stages = conv + L::CONV;
  for (int i = threadIdx.x; i < ROWS * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = i % (D / 8);
    cp_async_16(q_s + r * L::ROW + c * 16, q + qo_row(r0 + min(r, R - 1)) + c * 8, r < R);
  }
  cp_async_commit();  // group 0: Q

  const int32_t* table = tables + (size_t)b * MB;
  auto pool_row = [&](int p) -> size_t {  // pool row of position p (< reach)
    return (size_t)table[p / BS] * BS + p % BS;
  };
  auto issue = [&](int step, int st) {
    const uint32_t base = stages + st * L::STAGE;
    const int p0 = step * STEP;
    for (int i = threadIdx.x; i < STEP * CPR; i += THREADS) {
      const int tok = i / CPR, c = i % CPR;
      const bool ok = p0 + tok < n_keys;
      const size_t off = ((ok ? pool_row(p0 + tok) : 0) * Hkv + hk) * (D * E) + c * 16;
      const uint32_t dst = base + (QUANT ? tok * D : tok * L::ROW) + c * 16;
      cp_async_16(dst, k_pool + off, ok);
      cp_async_16(dst + (QUANT ? L::RAW : L::KV_BYTES), v_pool + off, ok);
    }
    if (QUANT) {  // k_scale by threads 0..63, v_scale by 64..127
      const int tok = threadIdx.x % STEP;
      const bool ok = p0 + tok < n_keys;
      const size_t row = ok ? pool_row(p0 + tok) : 0;
      cp_async_4(base + 2 * L::RAW + threadIdx.x * 4, (threadIdx.x < STEP ? k_scale : v_scale) + row * Hkv + hk,
                 ok);
    }
  };
  if (n_steps > 0) issue(0, 0);
  cp_async_commit();  // group 1: step 0

  const uint32_t la = lane_a<D>(lane), lb = lane_b<D>(lane);
  cp_async_wait_1();  // Q has landed
  __syncthreads();
  // every warp holds the same 16 rows' A fragments, in registers up to D =
  // 128; at D = 256 (64 registers beside O's 128) they are read again from
  // the resident Q tile for each step, as flash_fwd.cu does
  constexpr bool Q_REGS = D <= 128;
  uint32_t qa[Q_REGS ? D / 16 : 1][4];
  if constexpr (Q_REGS) load_a_frags<D>(qa, q_s + la);

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // log2 units; l is this thread's share
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_steps; ++it) {
    if (it + 1 < n_steps) issue(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait_1();
    const int stage_off = (int)(stages - q_s) + (it & 1) * L::STAGE;  // byte offset in smem
    if (QUANT) {  // the chunks this thread copied, now visible to it
      for (int i = threadIdx.x; i < STEP * CPR; i += THREADS) {
        const int tok = i / CPR, c = i % CPR;
#pragma unroll
        for (int kv = 0; kv < 2; ++kv)
          int8x16_to_bf16(smem + stage_off + kv * L::RAW + tok * D + c * 16,
                          smem + L::Q_BYTES + kv * L::KV_BYTES + tok * L::ROW + c * 32);
      }
    }
    __syncthreads();
    const int p0 = it * STEP, pw = p0 + SLICE * warp;  // this warp's first position
    if (pw < n_keys) {
      const bool masked = pw + SLICE > lim_lo;
      const uint32_t k_t = (QUANT ? conv : q_s + stage_off) + SLICE * warp * L::ROW;
      const uint32_t v_t = k_t + L::KV_BYTES;
      const float* scales = reinterpret_cast<const float*>(smem + stage_off + 2 * L::RAW);  // QUANT only
      // S = Q K^T: 16 rows x this warp's 16 positions, in log2 units
      float s[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      if constexpr (Q_REGS)
        mma_abt_regs<D, 2>(s, qa, k_t + lb);
      else
        mma_abt<D, 2>(s, q_s + la, k_t + lb);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = SLICE * warp + 8 * j + 2 * tq + (e & 1);  // position p0 + key
          float x = s[j][e] * scale_log2;
          if (QUANT) x *= scales[key];
          if (masked) x = p0 + key < lim[e / 2] ? x : NEG_INF;
          s[j][e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mx[half] = quad_max(mx[half]);
        alpha[half] = exp2f(m[half] - mx[half]);  // 0 when m was -1e30 and mx is not
        m[half] = mx[half];
        l[half] *= alpha[half];
      }
      // P, summed into l, then (int8) times v_scale, as bf16 hi + lo A
      // fragments of one k16 step (k = position)
      uint32_t ph[1][4], pl[1][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2f(s[j][e] - m[e / 2]);
          if (masked) p[e] = s[j][e] > NEG_INF / 2 ? p[e] : 0.f;
          l[e / 2] += p[e];
          if (QUANT) p[e] *= scales[STEP + SLICE * warp + 8 * j + 2 * tq + (e & 1)];
        }
        pack_bf16_split(p[0], p[1], ph[0][2 * j], pl[0][2 * j]);
        pack_bf16_split(p[2], p[3], ph[0][2 * j + 1], pl[0][2 * j + 1]);
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e / 2];
      mma_ab_split<D>(acc, ph, pl, v_t + la);  // O += P V
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }

  // the four warps' partials, combined in a fixed order
  cp_async_wait_all();
  float* part = reinterpret_cast<float*>(smem + L::Q_BYTES);  // [WARPS][ROWS][D]
  float* ml = part + WARPS * ROWS * D;                         // [WARPS][ROWS] of (m, l)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = g + 8 * half;
    const float lt = quad_sum(l[half]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(part + (warp * ROWS + row) * D + 8 * j + 2 * tq) =
          make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
    if (tq == 0) *reinterpret_cast<float2*>(ml + 2 * (warp * ROWS + row)) = make_float2(m[half], lt);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = i % (D / 8);
    float mw[WARPS], mmax = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      mw[w] = ml[2 * (w * ROWS + r)];
      mmax = fmaxf(mmax, mw[w]);
    }
    float f[WARPS], lsum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      f[w] = exp2f(mw[w] - mmax);
      lsum = fmaf(ml[2 * (w * ROWS + r) + 1], f[w], lsum);
    }
    const float inv = lsum > 0.f ? 1.f / lsum : 0.f;  // a slot at len 0 (decode) writes 0
    uint32_t o[4];
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) {
      float x[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) a = fmaf(part[(w * ROWS + r) * D + 8 * c + 2 * k2 + u], f[w], a);
        x[u] = a * inv;
      }
      o[k2] = pack_bf16(x[0], x[1]);
    }
    *reinterpret_cast<uint4*>(out + qo_row(r0 + r) + 8 * c) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

struct Args {
  const void *q, *k_pool, *v_pool;
  const float *k_scale, *v_scale;
  const int32_t *tables, *lens;
  void* out;
  int B, Q, H, Hkv, BS, MB, offset;
  float scale;
  cudaStream_t stream;
};

template <int D, bool QUANT>
int launch_mma(const Args& a) {
  const size_t smem = Layout<D, QUANT>::BYTES;
  auto kernel = paged_mma_kernel<D, QUANT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.B, a.Hkv, (a.Q * (a.H / a.Hkv) + ROWS - 1) / ROWS);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const unsigned char*>(a.k_pool),
      static_cast<const unsigned char*>(a.v_pool), a.k_scale, a.v_scale, a.tables, a.lens,
      static_cast<bf16*>(a.out), a.Q, a.H, a.Hkv, a.BS, a.MB, a.offset, a.scale);
  return (int)cudaGetLastError();
}

// -1 for an unsupported head dim, -3 for a tensor not 16-byte aligned.
int dispatch_mma(int D, bool quant, const Args& a) {
  const void* ptrs[] = {a.q, a.k_pool, a.v_pool, a.out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return -3;
#define TRLX_PAGED_CASE(DIM) \
  case DIM: return quant ? launch_mma<DIM, true>(a) : launch_mma<DIM, false>(a);
  switch (D) {
    TRLX_PAGED_CASE(16)
    TRLX_PAGED_CASE(32)
    TRLX_PAGED_CASE(64)
    TRLX_PAGED_CASE(80)
    TRLX_PAGED_CASE(96)
    TRLX_PAGED_CASE(128)
    TRLX_PAGED_CASE(256)
    default: return -1;  // the wrapper checks D first
  }
#undef TRLX_PAGED_CASE
}

}  // namespace tc

template <bool VERIFY>
int dispatch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
             const void* v_scale, const void* tables, const void* lens, void* out, int B, int Q,
             int H, int Hkv, int D, int BS, int MB, float scale, int q_dtype, int kv_dtype,
             void* stream) {
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int32_t* tb = static_cast<const int32_t*>(tables);
  const int32_t* ln = static_cast<const int32_t*>(lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 1 && (kv_dtype == 1 || kv_dtype == 2)) {
    const tc::Args a{q, k_pool, v_pool, ks, vs, tb, ln, out, B, Q, H, Hkv, BS, MB, VERIFY ? 1 : 0, scale, st};
    return tc::dispatch_mma(D, kv_dtype == 2, a);
  }
  // the SIMT body: tiles of ROW_TILE rows, at least rep, so Q=1 (decode,
  // and verify at Q=1) is one tile of the step's rep rows
  const int rep = H / Hkv;
  const int widest = rep > ROW_TILE ? rep : ROW_TILE;
  const int tile_rows = Q * rep < widest ? Q * rep : widest;
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float, false, VERIFY>(q, k_pool, v_pool, ks, vs, tb, ln, out, B, Q, H,
                                               Hkv, D, BS, MB, tile_rows, scale, st);
  if (q_dtype == 0 && kv_dtype == 2)
    return launch<float, int8_t, true, VERIFY>(q, k_pool, v_pool, ks, vs, tb, ln, out, B, Q, H,
                                               Hkv, D, BS, MB, tile_rows, scale, st);
  return -2;
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (out shares it). kv_dtype: the pools'
// type, the same as q_dtype, or 2 = int8 with k_scale/v_scale given.
// Both entry points return cudaGetLastError() after the launch (0 on
// success), -1 for a head dim the tensor-core body lacks, -2 for an
// unsupported dtype pair, -3 for a bfloat16 or int8 tensor not 16-byte
// aligned.

// K4: q/out [B,H,D]; lens count this step's token.
extern "C" int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                            const void* k_scale, const void* v_scale, const void* tables,
                            const void* lens, void* out, int B, int H, int Hkv, int D, int BS,
                            int MB, float scale, int q_dtype, int kv_dtype, void* stream) {
  return dispatch<false>(q, k_pool, v_pool, k_scale, v_scale, tables, lens, out, B, 1, H, Hkv, D,
                         BS, MB, scale, q_dtype, kv_dtype, stream);
}

// K5: q/out [B,Q,H,D]; lens count the tokens before the append.
extern "C" int paged_verify(const void* q, const void* k_pool, const void* v_pool,
                            const void* k_scale, const void* v_scale, const void* tables,
                            const void* lens, void* out, int B, int Q, int H, int Hkv, int D,
                            int BS, int MB, float scale, int q_dtype, int kv_dtype,
                            void* stream) {
  return dispatch<true>(q, k_pool, v_pool, k_scale, v_scale, tables, lens, out, B, Q, H, Hkv, D,
                        BS, MB, scale, q_dtype, kv_dtype, stream);
}
