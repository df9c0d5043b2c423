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
// and 1 for verify. VERIFY is a template parameter: the decode instance
// has OFFSET 0, Q = 1 and one tile of rep rows as compile-time constants,
// so it folds to the single-token kernel; verify at Q=1 with lens runs the
// same block walk, products and reductions on the same values as decode
// with lens+1, bit for bit.
//
// What bounds it on the H100: Q*rep query rows against a slot's context,
// ~4*Q*rep flops per KV element, far below the ~295 flops/byte ridge at the
// engine's Q <= 5 (chunked prefill's Q=64 is still under it): it is bound
// by the bytes of live K/V it must read (3.35 TB/s).
//
// Design: one CTA per (slot, kv head, row tile). A tile holds up to
// ROW_TILE rows (decode: all rep rows in one tile), so shared memory stays
// bounded for any chunk length; the K/V of each block are read once per
// tile for all its rows. There is no scalar prefetch on the GPU: the CTA
// reads its own block-table row and walks only the blocks below its last
// row's limit, min(ceil(limit/BS), MB) — the TPU kernels walk all MB blocks
// and mask the dead ones; a block past a row's limit gives p = 0 and
// alpha = 1 there, so the row's result is unchanged and fewer bytes move.
// Each block's K/V rows are converted to f32 (int8 in registers) into
// shared memory with neighbouring threads on neighbouring elements; the
// flash running max / sum / accumulator live in shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int ROW_TILE = 64;  // verify rows per CTA
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int rows, int D, int BS) {
  // q_s [rows][D], acc_s [rows][D], k_s [BS][D+1], v_s [BS][D], p_s [rows][BS],
  // ks_s/vs_s [BS], m_s/l_s/alpha_s [rows]
  return sizeof(float) *
         (size_t)(2 * rows * D + BS * (D + 1) + BS * D + rows * BS + 2 * BS + 3 * rows);
}

// grid (B, Hkv, row tiles); q/out [B, Q, H, D]. The decode instance
// (VERIFY false) takes q/out [B, H, D] and ignores Q and tile_rows.
template <typename QT, typename KVT, bool QUANT, bool VERIFY>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const QT* __restrict__ q, const KVT* __restrict__ k_pool,
                  const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, const int32_t* __restrict__ tables,
                  const int32_t* __restrict__ lens, QT* __restrict__ out, int Q, int H, int Hkv,
                  int D, int BS, int MB, int tile_rows, float scale) {
  constexpr int OFFSET = VERIFY ? 1 : 0;
  const int b = blockIdx.x;
  const int hk = blockIdx.y;
  const int rep = H / Hkv;
  const int r0 = VERIFY ? blockIdx.z * tile_rows : 0;  // first row of this tile in [0, Q*rep)
  const int rows = VERIFY ? min(tile_rows, Q * rep - r0) : rep;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int DK = D + 1;

  extern __shared__ float smem[];
  float* q_s = smem;                 // [rows][D]
  float* acc_s = q_s + rows * D;     // [rows][D]
  float* k_s = acc_s + rows * D;     // [BS][D+1]
  float* v_s = k_s + BS * DK;        // [BS][D]
  float* p_s = v_s + BS * D;         // [rows][BS]
  float* ks_s = p_s + rows * BS;     // [BS]
  float* vs_s = ks_s + BS;           // [BS]
  float* m_s = vs_s + BS;            // [rows]
  float* l_s = m_s + rows;           // [rows]
  float* alpha_s = l_s + rows;       // [rows]

  const int len = lens[b];
  // row r sees positions below its limit; the tile's last row sees the most
  auto row_limit = [&](int r) -> int { return VERIFY ? len + (r0 + r) / rep + OFFSET : len; };
  const int n_blocks = min((row_limit(rows - 1) + BS - 1) / BS, MB);

  // element i = r * D + d of the tile in q/out: row r is query (r0 + r) / rep,
  // head hk*rep + (r0 + r) % rep (decode: the CTA's rep heads, contiguous)
  auto qo_index = [&](int i) -> size_t {
    if (!VERIFY) return ((size_t)b * H + (size_t)hk * rep) * D + i;
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

  for (int j = 0; j < n_blocks; ++j) {
    __syncthreads();  // previous block's readers are done (and q_s/acc_s are set)
    const size_t row0 = (size_t)tables[(size_t)b * MB + j] * BS;  // first pool row
    for (int i = tid; i < BS * D; i += THREADS) {
      const int t = i / D, d = i % D;
      const size_t src = ((row0 + t) * Hkv + hk) * D + d;
      k_s[t * DK + d] = to_f32(k_pool[src]);
      v_s[t * D + d] = to_f32(v_pool[src]);
    }
    if (QUANT) {
      for (int t = tid; t < BS; t += THREADS) {
        ks_s[t] = k_scale[(row0 + t) * Hkv + hk];
        vs_s[t] = v_scale[(row0 + t) * Hkv + hk];
      }
    }
    __syncthreads();

    // scores [rows][BS]; tokens at or past the row's limit are masked
    for (int i = tid; i < rows * BS; i += THREADS) {
      const int r = i / BS, t = i % BS;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(q_s[r * D + d], k_s[t * DK + d], dot);
      float s = dot * scale;
      if (QUANT) s *= ks_s[t];
      p_s[i] = j * BS + t < row_limit(r) ? s : NEG_INF;
    }
    __syncthreads();

    // online-softmax update, one warp per query row
    for (int r = warp; r < rows; r += WARPS) {
      float m_cur = NEG_INF;
      for (int t = lane; t < BS; t += 32) m_cur = fmaxf(m_cur, p_s[r * BS + t]);
      for (int off = 16; off > 0; off >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, m_cur);
      float p_sum = 0.f;
      for (int t = lane; t < BS; t += 32) {
        // fully-masked blocks keep m == NEG_INF; exp(s - m) would be exp(0) there
        float p = m_new > NEG_INF / 2 ? expf(p_s[r * BS + t] - m_new) : 0.f;
        p_sum += p;  // l sums p BEFORE the v_scale fold
        if (QUANT) p *= vs_s[t];
        p_s[r * BS + t] = p;
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
      for (int t = 0; t < BS; ++t) a = fmaf(p_s[r * BS + t], v_s[t * D + d], a);
      acc_s[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < rows * D; i += THREADS) {
    const float l = l_s[i / D];
    out[qo_index(i)] = from_f32<QT>(acc_s[i] / (l == 0.f ? 1.f : l));
  }
}

template <typename QT, typename KVT, bool QUANT, bool VERIFY>
int launch(const void* q, const void* k_pool, const void* v_pool, const float* k_scale,
           const float* v_scale, const int32_t* tables, const int32_t* lens, void* out, int B,
           int Q, int H, int Hkv, int D, int BS, int MB, int tile_rows, float scale,
           cudaStream_t stream) {
  const int total_rows = Q * (H / Hkv);
  const size_t smem = smem_bytes(tile_rows, D, BS);
  auto kernel = paged_attn_kernel<QT, KVT, QUANT, VERIFY>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, Hkv, (total_rows + tile_rows - 1) / tile_rows);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), k_scale, v_scale, tables, lens, static_cast<QT*>(out),
      Q, H, Hkv, D, BS, MB, tile_rows, scale);
  return (int)cudaGetLastError();
}

template <bool VERIFY>
int dispatch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
             const void* v_scale, const void* tables, const void* lens, void* out, int B, int Q,
             int H, int Hkv, int D, int BS, int MB, int tile_rows, float scale, int q_dtype,
             int kv_dtype, void* stream) {
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int32_t* tb = static_cast<const int32_t*>(tables);
  const int32_t* ln = static_cast<const int32_t*>(lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float, false, VERIFY>(q, k_pool, v_pool, ks, vs, tb, ln, out, B, Q, H,
                                               Hkv, D, BS, MB, tile_rows, scale, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, false, VERIFY>(
        q, k_pool, v_pool, ks, vs, tb, ln, out, B, Q, H, Hkv, D, BS, MB, tile_rows, scale, st);
  if (q_dtype == 0 && kv_dtype == 2)
    return launch<float, int8_t, true, VERIFY>(q, k_pool, v_pool, ks, vs, tb, ln, out, B, Q, H,
                                               Hkv, D, BS, MB, tile_rows, scale, st);
  if (q_dtype == 1 && kv_dtype == 2)
    return launch<__nv_bfloat16, int8_t, true, VERIFY>(q, k_pool, v_pool, ks, vs, tb, ln, out, B,
                                                       Q, H, Hkv, D, BS, MB, tile_rows, scale,
                                                       st);
  return -2;
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (out shares it). kv_dtype: the pools'
// type, the same as q_dtype, or 2 = int8 with k_scale/v_scale given.
// Both entry points return cudaGetLastError() after the launch (0 on
// success), -2 for an unsupported dtype pair.

// K4: q/out [B,H,D]; lens count this step's token. One tile of rep rows.
extern "C" int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                            const void* k_scale, const void* v_scale, const void* tables,
                            const void* lens, void* out, int B, int H, int Hkv, int D, int BS,
                            int MB, float scale, int q_dtype, int kv_dtype, void* stream) {
  return dispatch<false>(q, k_pool, v_pool, k_scale, v_scale, tables, lens, out, B, 1, H, Hkv, D,
                         BS, MB, H / Hkv, scale, q_dtype, kv_dtype, stream);
}

// K5: q/out [B,Q,H,D]; lens count the tokens before the append. Tiles of
// ROW_TILE rows (at least rep, so Q=1 is one tile as in decode).
extern "C" int paged_verify(const void* q, const void* k_pool, const void* v_pool,
                            const void* k_scale, const void* v_scale, const void* tables,
                            const void* lens, void* out, int B, int Q, int H, int Hkv, int D,
                            int BS, int MB, float scale, int q_dtype, int kv_dtype,
                            void* stream) {
  const int rep = H / Hkv;
  const int widest = rep > ROW_TILE ? rep : ROW_TILE;
  const int tile_rows = Q * rep < widest ? Q * rep : widest;
  return dispatch<true>(q, k_pool, v_pool, k_scale, v_scale, tables, lens, out, B, Q, H, Hkv, D,
                        BS, MB, tile_rows, scale, q_dtype, kv_dtype, stream);
}
