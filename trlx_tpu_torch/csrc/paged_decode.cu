// Paged-KV single-token decode attention for Hopper (sm_90a).
//
// Replaces: trlx_tpu/ops/paged_attention.py::_paged_kernel (the Pallas TPU
// kernel reached through paged_attention_pallas / paged_decode_attention).
// The same contract: q [B,H,D] (one decode token per slot), per-layer pools
// [NB,BS,Hkv,D] in the JAX layout (row stride Hkv*D, read as they are), block
// tables [B,MB] int32, context lens [B] int32 counting this step's token.
// int8 pools carry f32 per-row scales [NB,BS,Hkv]: k_scale folds into the
// scores, and v_scale into the probabilities AFTER they are summed into l
// (the algebra of paged_attention.py:214-234 and :96-107). A slot with
// len 0 writes 0; an idle slot at len 1 reads the null block 0 and stays
// finite.
//
// What bounds it on the H100: one query row per head against its whole
// context, ~4 flops per KV byte, far below the ~295 flops/byte ridge: it
// is bound by the bytes of live K/V it must read (3.35 TB/s).
//
// Design: one CTA per (slot, kv head) computing that head's rep = H/Hkv
// query rows, so grouped K/V are read once for the whole group. There is no
// scalar prefetch on the GPU: the CTA reads its own block-table row and
// walks only the ceil(len/BS) blocks that hold live tokens — the TPU kernel
// walks all MB blocks and masks the dead ones, which contribute exactly 0,
// so the result is the same with fewer bytes moved. Each block's K/V rows
// are converted to f32 (int8 in registers) into shared memory with
// neighbouring threads on neighbouring elements; the flash running max /
// sum / accumulator live in shared memory, so any D and rep fit one kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int rep, int D, int BS) {
  // q_s [rep][D], acc_s [rep][D], k_s [BS][D+1], v_s [BS][D], p_s [rep][BS],
  // ks_s/vs_s [BS], m_s/l_s/alpha_s [rep]
  return sizeof(float) *
         (size_t)(2 * rep * D + BS * (D + 1) + BS * D + rep * BS + 2 * BS + 3 * rep);
}

template <typename QT, typename KVT, bool QUANT>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const QT* __restrict__ q, const KVT* __restrict__ k_pool,
                    const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int32_t* __restrict__ tables,
                    const int32_t* __restrict__ lens, QT* __restrict__ out, int H, int Hkv,
                    int D, int BS, int MB, float scale) {
  const int b = blockIdx.x;
  const int hk = blockIdx.y;
  const int rep = H / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int DK = D + 1;

  extern __shared__ float smem[];
  float* q_s = smem;                 // [rep][D]
  float* acc_s = q_s + rep * D;      // [rep][D]
  float* k_s = acc_s + rep * D;      // [BS][D+1]
  float* v_s = k_s + BS * DK;        // [BS][D]
  float* p_s = v_s + BS * D;         // [rep][BS]
  float* ks_s = p_s + rep * BS;      // [BS]
  float* vs_s = ks_s + BS;           // [BS]
  float* m_s = vs_s + BS;            // [rep]
  float* l_s = m_s + rep;            // [rep]
  float* alpha_s = l_s + rep;        // [rep]

  const int len = lens[b];
  const int n_blocks = min((len + BS - 1) / BS, MB);
  const size_t q_row0 = (size_t)b * H + (size_t)hk * rep;

  for (int i = tid; i < rep * D; i += THREADS) {
    q_s[i] = to_f32(q[q_row0 * D + i]);
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < rep; r += THREADS) {
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

    // scores [rep][BS]; tokens at or past len are masked
    for (int i = tid; i < rep * BS; i += THREADS) {
      const int r = i / BS, t = i % BS;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(q_s[r * D + d], k_s[t * DK + d], dot);
      float s = dot * scale;
      if (QUANT) s *= ks_s[t];
      p_s[i] = j * BS + t < len ? s : NEG_INF;
    }
    __syncthreads();

    // online-softmax update, one warp per query row
    for (int r = warp; r < rep; r += WARPS) {
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

    for (int i = tid; i < rep * D; i += THREADS) {
      const int r = i / D, d = i % D;
      float a = acc_s[i] * alpha_s[r];
      for (int t = 0; t < BS; ++t) a = fmaf(p_s[r * BS + t], v_s[t * D + d], a);
      acc_s[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < rep * D; i += THREADS) {
    const float l = l_s[i / D];
    out[q_row0 * D + i] = from_f32<QT>(acc_s[i] / (l == 0.f ? 1.f : l));
  }
}

template <typename QT, typename KVT, bool QUANT>
int launch(const void* q, const void* k_pool, const void* v_pool, const float* k_scale,
           const float* v_scale, const int32_t* tables, const int32_t* lens, void* out, int B,
           int H, int Hkv, int D, int BS, int MB, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / Hkv, D, BS);
  auto kernel = paged_decode_kernel<QT, KVT, QUANT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, Hkv);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), k_scale, v_scale, tables, lens, static_cast<QT*>(out),
      H, Hkv, D, BS, MB, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (out shares it). kv_dtype: the pools'
// type, the same as q_dtype, or 2 = int8 with k_scale/v_scale given.
// Returns cudaGetLastError() after the launch (0 on success), -2 for an
// unsupported dtype pair.
extern "C" int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                            const void* k_scale, const void* v_scale, const void* tables,
                            const void* lens, void* out, int B, int H, int Hkv, int D, int BS,
                            int MB, float scale, int q_dtype, int kv_dtype, void* stream) {
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int32_t* tb = static_cast<const int32_t*>(tables);
  const int32_t* ln = static_cast<const int32_t*>(lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float, false>(q, k_pool, v_pool, ks, vs, tb, ln, out, B, H, Hkv, D,
                                       BS, MB, scale, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(q, k_pool, v_pool, ks, vs, tb, ln, out,
                                                       B, H, Hkv, D, BS, MB, scale, st);
  if (q_dtype == 0 && kv_dtype == 2)
    return launch<float, int8_t, true>(q, k_pool, v_pool, ks, vs, tb, ln, out, B, H, Hkv, D,
                                       BS, MB, scale, st);
  if (q_dtype == 1 && kv_dtype == 2)
    return launch<__nv_bfloat16, int8_t, true>(q, k_pool, v_pool, ks, vs, tb, ln, out, B, H,
                                               Hkv, D, BS, MB, scale, st);
  return -2;
}
