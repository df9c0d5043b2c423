// Causal flash-attention forward for Hopper (sm_90a).
//
// Replaces: trlx_tpu/ops/attention.py::_flash_kernel (the Pallas TPU kernel
// reached through _flash_forward / flash_attention), forward only. The same
// contract: q [B,H,T,D], k/v [B,Hkv,S,D] (query head h reads kv head
// h / (H/Hkv), never expanded), key mask kv_valid[b,s] > 0 combined with
// slot causality s <= t, f32 online softmax, fully-masked rows written as 0,
// optional per-row logsumexp m + log(l) (-1e30 on empty rows).
//
// What bounds it on the H100: at serving-prefill shapes (T = S <= 2048,
// D = 64..128) attention does 2*T*S*D*2 flops per (b,h) on 2*S*D*2 bytes
// of K/V, i.e. hundreds of flops per byte: above the card's ~295 bf16
// flops/byte ridge, so it is bound by operations. This first version runs
// its products as f32 FMAs on the CUDA cores (67 TFLOP/s peak), not on the
// tensor cores; wgmma tiles, TMA loads and warp specialisation are later work.
//
// Design: one CTA per (64-row query tile, head, batch). The TPU kernel's
// sequential kv grid axis and its VMEM scratch carry become a loop inside
// the CTA over 64-row K/V tiles staged in shared memory (converted to f32
// once per tile); the running max / sum / accumulator stay in registers.
// 256 threads: 4 per query row, each owning 16 of the tile's 64 keys for
// the scores and D/4 output columns for the P@V update. Tiles wholly above
// the causal diagonal are never visited (the pl.when(run) skip). The ragged
// edge (T, S not multiples of 64) is masked in the kernel, so the host pads
// nothing. Shared rows are padded by one float to keep the 4-row / 8-row
// access patterns free of bank conflicts.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per K/V tile
constexpr int THREADS = 256;
constexpr int TPR = THREADS / BQ;  // threads per query row
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int D) {
  // q_s [BQ][D+1], k_s [BK][D+1], v_s [BK][D], p_s [BQ][BK+1] floats, valid_s [BK] ints
  return sizeof(float) * (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1)) +
         sizeof(int) * BK;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int32_t* __restrict__ kv_valid, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Hkv, int T_len, int S, int causal,
                 float scale) {
  constexpr int DQ = D + 1;
  constexpr int DPT = D / TPR;   // output columns per thread
  constexpr int KPT = BK / TPR;  // keys per thread per tile
  extern __shared__ float smem[];
  float* q_s = smem;             // [BQ][D+1]
  float* k_s = q_s + BQ * DQ;    // [BK][D+1]
  float* v_s = k_s + BK * DQ;    // [BK][D]
  float* p_s = v_s + BK * D;     // [BQ][BK+1]
  int* valid_s = reinterpret_cast<int*>(p_s + BQ * (BK + 1));  // [BK]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int sub = tid % TPR;
  const int t = q0 + row;  // this thread's query slot
  const size_t q_base = (size_t)(b * H + h) * T_len * D;
  const size_t kv_base = (size_t)(b * Hkv + hk) * S * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int tt = q0 + r;
    q_s[r * DQ + d] = tt < T_len ? to_f32(q[q_base + (size_t)tt * D + d]) : 0.f;
  }

  float acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) acc[c] = 0.f;
  float m = NEG_INF, l = 0.f;

  // keys past the tile's last query slot are all causally masked: skip them
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done (and q_s is written)
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const int s = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (s < S) {
        kx = to_f32(k[kv_base + (size_t)s * D + d]);
        vx = to_f32(v[kv_base + (size_t)s * D + d]);
      }
      k_s[r * DQ + d] = kx;
      v_s[r * D + d] = vx;
    }
    for (int i = tid; i < BK; i += THREADS) {
      const int s = k0 + i;
      valid_s[i] = (s < S) && kv_valid[(size_t)b * S + s] > 0;
    }
    __syncthreads();

    float sc[KPT];
    float m_cur = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = sub + TPR * jj;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(q_s[row * DQ + d], k_s[j * DQ + d], dot);
      const int s = k0 + j;
      const bool ok = valid_s[j] && t < T_len && (!causal || s <= t);
      sc[jj] = ok ? dot * scale : NEG_INF;
      m_cur = fmaxf(m_cur, sc[jj]);
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, off));
    const float m_new = fmaxf(m, m_cur);
    // fully-masked rows keep m == NEG_INF; exp(s - m) would be exp(0) = 1 there
    float p_sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const float p = m_new > NEG_INF / 2 ? expf(sc[jj] - m_new) : 0.f;
      p_s[row * (BK + 1) + sub + TPR * jj] = p;
      p_sum += p;
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      p_sum += __shfl_xor_sync(0xffffffffu, p_sum, off);
    const float alpha = expf(m - m_new);
    l = alpha * l + p_sum;
    m = m_new;
    __syncwarp();  // the row's 4 threads are adjacent lanes of one warp
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = sub + TPR * c;
      float a = acc[c] * alpha;
#pragma unroll 16
      for (int j = 0; j < BK; ++j) a = fmaf(p_s[row * (BK + 1) + j], v_s[j * D + d], a);
      acc[c] = a;
    }
  }

  if (t < T_len) {
    // rows with no valid keys (fully masked) produce 0, not NaN
    const float safe_l = l == 0.f ? 1.f : l;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = sub + TPR * c;
      o[q_base + (size_t)t * D + d] = from_f32<T>(acc[c] / safe_l);
    }
    if (lse != nullptr && sub == 0)
      lse[(size_t)(b * H + h) * T_len + t] = l > 0.f ? m + logf(safe_l) : NEG_INF;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int32_t* kv_valid, void* o,
           float* lse, int B, int H, int Hkv, int T_len, int S, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv_valid,
      static_cast<T*>(o), lse, H, Hkv, T_len, S, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const int32_t* kv_valid, void* o,
               float* lse, int B, int H, int Hkv, int T_len, int S, int D, int causal,
               float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, kv_valid, o, lse, B, H, Hkv, T_len, S, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, kv_valid, o, lse, B, H, Hkv, T_len, S, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, kv_valid, o, lse, B, H, Hkv, T_len, S, causal, scale, stream);
    case 96: return launch<T, 96>(q, k, v, kv_valid, o, lse, B, H, Hkv, T_len, S, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, kv_valid, o, lse, B, H, Hkv, T_len, S, causal, scale, stream);
    default: return -1;  // the wrapper checks D first
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it). lse may be null.
// Returns cudaGetLastError() after the launch (0 on success), -1 for an
// unsupported head dim, -2 for an unsupported dtype.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* kv_valid,
                         void* o, void* lse, int B, int H, int Hkv, int T_len, int S, int D,
                         int causal, float scale, int dtype, void* stream) {
  const int32_t* valid = static_cast<const int32_t*>(kv_valid);
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, valid, o, lse_f, B, H, Hkv, T_len, S, D, causal, scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, valid, o, lse_f, B, H, Hkv, T_len, S, D, causal,
                                     scale, st);
  return -2;
}
