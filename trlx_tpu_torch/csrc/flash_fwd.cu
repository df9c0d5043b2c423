// Causal flash-attention forward for Hopper (sm_90a).
//
// Replaces: trlx_tpu/ops/attention.py::_flash_kernel (the Pallas TPU kernel
// reached through _flash_forward / flash_attention), forward only. The same
// contract: q [B,H,T,D], k/v [B,Hkv,S,D] (query head h reads kv head
// h / (H/Hkv), never expanded), key mask kv_valid[b,s] > 0 combined with
// slot causality s <= t, f32 online softmax, fully-masked rows written as 0,
// optional per-row logsumexp m + log(l) (-1e30 on empty rows; the backward
// kernels of flash_bwd.cu read it).
//
// What bounds it on the H100: attention does 2*T*S*D*2 flops per (b,h) on
// 2*S*D*2 bytes of K/V. At the engine's prefill wave (B=16, H=12, T=S=128,
// D=64, bf16) that is ~0.1 GFLOP over the visible pairs against ~1.6 MB
// moved: 0.0038 ms of bytes at 3.35 TB/s, 0.0001 ms of tensor-core work at
// 989 TFLOP/s. At these T the kernel is bound by bytes and by latency (one
// to six 64-key tiles per query tile), not by the tensor cores' issue rate,
// so the warp-level mma.sync.m16n8k16 serves; wgmma and TMA would come only
// if a profile shows the mma issue rate binding at long T.
//
// Design of the bf16 instances (tc::fwd_mma_kernel; 4 warps, each owning 16
// rows of a 64-row query tile, every product on the tensor cores): one CTA
// per (64-query tile, head, batch). Q is staged once with 16-byte cp.async
// and held in registers as A fragments; K, V and the key flags of each
// 64-key tile up to the causal diagonal are double-buffered with cp.async,
// so the next tile loads while this one computes. A warp forms S = Q K^T
// (16 queries x 64 keys) in f32 registers, keeps the running max, sum and
// rescaled output in registers, and feeds P straight from the C fragments
// as the A operand of O += P V, V read through ldmatrix.trans (no P in
// shared memory). P goes in as two bf16 parts, hi = bf16(p) and lo =
// bf16(p - hi), so P V keeps ~16 bits of each probability where bf16(p)
// alone keeps 8: the output then differs from the f32 reference by
// summation order only, not by a bf16 rounding of P, and twice the P V
// mma instructions cost no bytes. Work skipped: tiles above the
// causal diagonal, and kv tiles whose keys are all invalid (a uniform vote
// on the staged flags). The per-element mask runs only on the diagonal, a
// tile holding an invalid key, and the ragged edge (keys past S are
// zero-filled and flagged invalid); a masked score is selected to -1e30 and
// its probability to 0, never multiplied. Shared rows are padded by 16
// bytes (conflict-free ldmatrix); the host pads nothing.
//
// Head dims: every multiple of 16 the switches below name (FLASH_HEAD_DIMS
// of ops/attention.py). At D = 256 (GPT-J) one warp's O would be 128 f32
// registers beside S (32), P (32) and Q's fragments (64): over the 255 a
// thread may have. So there Q stays in shared memory (its fragments read
// again for each key tile) and two warps share each 16-query group (8
// warps, FwdSplit): both form the group's S and softmax state, each
// accumulates half of O's columns; 169,472 bytes of shared memory, one CTA
// an SM.
//
// The f32 instances stay this file's first design, bit for bit: every
// product as f32 FMAs on the CUDA cores out of f32 shared memory (256
// threads, 4 per query row), since TF32 keeps too few digits for the f32
// contract (214,016 bytes of shared memory at D = 256).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per K/V tile
constexpr int THREADS = 256;
constexpr int TPR = THREADS / BQ;  // threads per query row
constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------- f32 (SIMT)
// The f32 instances: every product as f32 FMAs out of f32 shared memory
// (this file's first design, unchanged, so f32 results stay bit for bit).

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

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
    case 80: return launch<T, 80>(q, k, v, kv_valid, o, lse, B, H, Hkv, T_len, S, causal, scale, stream);
    case 96: return launch<T, 96>(q, k, v, kv_valid, o, lse, B, H, Hkv, T_len, S, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, kv_valid, o, lse, B, H, Hkv, T_len, S, causal, scale, stream);
    case 256: return launch<T, 256>(q, k, v, kv_valid, o, lse, B, H, Hkv, T_len, S, causal, scale, stream);
    default: return -1;  // the wrapper checks D first
  }
}

// ------------------------------------------------------- bf16 (tensor cores)

namespace tc {

// the shared tensor-core helpers (mma_sm90.cuh). The using-declaration makes
// THREADS the header's 128, not the SIMT kernel's 256 of the enclosing
// namespace.
using namespace ::sm90;
using sm90::THREADS;

template <int D>
size_t fwd_smem_bytes() {
  // Q tile + 2 stages of (K, V, key flags [TILE])
  return (size_t)Tile<D>::BYTES + 2 * (2 * Tile<D>::BYTES + TILE * sizeof(int32_t));
}

// Warps owning a 16-query group: one up to D = 128. At D = 256 O alone is
// 128 f32 registers a thread, and beside S, P and the fragment loads the
// compiler spills at 255, so two warps share each group (8 warps): both
// form the group's S and softmax state on the same values (the same bits),
// and each accumulates half of O's columns (64 registers). The tensor cores
// compute S twice; the kernel is bound by bytes, not by their issue rate.
template <int D>
struct FwdSplit {
  static constexpr int N = D > 128 ? 2 : 1;
  static constexpr int NTH = THREADS * N;
  static constexpr int DC = D / N;  // O's columns a warp
};

template <int D>
__global__ void __launch_bounds__(FwdSplit<D>::NTH)
fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               const int32_t* __restrict__ kv_valid, bf16* __restrict__ o, float* __restrict__ lse, int H,
               int Hkv, int T_len, int S, int causal, float scale) {
  using TL = Tile<D>;
  using SP = FwdSplit<D>;
  constexpr int STAGE = 2 * TL::BYTES + TILE * 4;  // K, V, key flags
  extern __shared__ __align__(16) unsigned char smem[];

  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  // query group; which half of O's columns (0 without a split)
  const int rg = SP::N > 1 ? warp % WARPS : warp, part = SP::N > 1 ? warp / WARPS : 0;
  const size_t row_base = (size_t)(b * H + h) * T_len;
  const size_t q_base = row_base * D, kv_base = (size_t)(b * Hkv + hk) * S * D;
  // keys past the tile's last query slot are all causally masked: skip them
  const int kv_end = causal ? min(S, q0 + TILE) : S;
  const int n_tiles = (kv_end + TILE - 1) / TILE;

  const uint32_t q_s = smem_addr(smem), stages = q_s + TL::BYTES;
  auto issue = [&](int tile, int st) {
    const int k0 = tile * TILE;
    const uint32_t base = stages + st * STAGE;
    load_tile_async<D, SP::NTH>(base, k + kv_base, k0, S);
    load_tile_async<D, SP::NTH>(base + TL::BYTES, v + kv_base, k0, S);
    if (threadIdx.x < TILE) {
      const int s = k0 + threadIdx.x;
      cp_async_4(base + 2 * TL::BYTES + threadIdx.x * 4, kv_valid + (size_t)b * S + (s < S ? s : 0), s < S);
    }
  };
  load_tile_async<D, SP::NTH>(q_s, q + q_base, q0, T_len);
  cp_async_commit();  // group 0: Q
  if (n_tiles > 0) issue(0, 0);
  cp_async_commit();  // group 1: kv tile 0

  // this thread's two query rows (the C fragment's rows g and g + 8)
  const int t_lo = q0 + 16 * rg + g, t_hi = t_lo + 8;
  const uint32_t la = lane_a<D>(lane), lb = lane_b<D>(lane);
  cp_async_wait_1();  // Q has landed (tile 0 may still be in flight)
  __syncthreads();
  // Q's A fragments stay in registers up to D = 128; at D = 256 (64
  // registers) they are read again from the resident Q tile for each key
  // tile (FlashAttention-2's choice at that head dim)
  constexpr bool Q_REGS = D <= 128;
  const uint32_t q_warp = q_s + 16 * rg * TL::ROW_BYTES + la;
  uint32_t qa[Q_REGS ? D / 16 : 1][4];
  if constexpr (Q_REGS) load_a_frags<D>(qa, q_warp);
  const uint32_t col_off = part * SP::DC * 2;  // this warp's columns of V and O (bytes)

  // running max (log2 units: scores times scale * log2 e), this thread's
  // share of the running sum, and the rescaled output, per row half
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[SP::DC / 8][4];
#pragma unroll
  for (int j = 0; j < SP::DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) issue(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const int k0 = it * TILE;
    const uint32_t k_s = stages + (it & 1) * STAGE, v_s = k_s + TL::BYTES;
    const int* valid_s = reinterpret_cast<const int*>(smem + (k_s - q_s) + 2 * TL::BYTES);
    const bool v0 = valid_s[lane] > 0, v1 = valid_s[lane + 32] > 0;  // zero past S
    if (__any_sync(FULL, v0 || v1)) {
      const bool masked = !__all_sync(FULL, v0 && v1) || (causal && k0 + TILE - 1 > q0);
      // S = Q K^T: this warp's 16 queries x 64 keys, in log2 units
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      if constexpr (Q_REGS)
        mma_abt_regs<D, 8>(s, qa, k_s + lb);
      else
        mma_abt<D, 8>(s, q_warp, k_s + lb);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (masked) {
            const int key = 8 * j + 2 * tq + (e & 1);
            const bool ok = valid_s[key] > 0 && (!causal || k0 + key <= (e < 2 ? t_lo : t_hi));
            x = ok ? x : NEG_INF;
          }
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
      // P as bf16 hi + lo A fragments (k = key); masked scores give 0
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2f(s[j][e] - m[e / 2]);
          if (masked) p[e] = s[j][e] > NEG_INF / 2 ? p[e] : 0.f;
          l[e / 2] += p[e];
        }
        pack_bf16_split(p[0], p[1], ph[j / 2][(j % 2) * 2], pl[j / 2][(j % 2) * 2]);
        pack_bf16_split(p[2], p[3], ph[j / 2][(j % 2) * 2 + 1], pl[j / 2][(j % 2) * 2 + 1]);
      }
#pragma unroll
      for (int j = 0; j < SP::DC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e / 2];
      mma_ab_split<D, 4, SP::DC>(acc, ph, pl, v_s + la + col_off);  // O += P V
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }

  // rows with no visible key (l == 0) write 0 and lse -1e30
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float lt = quad_sum(l[half]);
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
#pragma unroll
    for (int j = 0; j < SP::DC / 8; ++j) {
      acc[j][2 * half] *= inv;
      acc[j][2 * half + 1] *= inv;
    }
    const int t = half ? t_hi : t_lo;
    if (lse != nullptr && tq == 0 && part == 0 && t < T_len)
      lse[row_base + t] = lt > 0.f ? m[half] * LN2 + logf(lt) : NEG_INF;
  }
  store_rows<D, SP::DC>(o + q_base, acc, t_lo, T_len, tq, part * SP::DC);
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const int32_t* kv_valid, void* o, float* lse,
               int B, int H, int Hkv, int T_len, int S, int causal, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<D>();
  auto kernel = fwd_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + TILE - 1) / TILE, H, B);
  kernel<<<grid, FwdSplit<D>::NTH, smem, stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                          static_cast<const bf16*>(v), kv_valid, static_cast<bf16*>(o), lse,
                                          H, Hkv, T_len, S, causal, scale);
  return (int)cudaGetLastError();
}

int dispatch_mma(const void* q, const void* k, const void* v, const int32_t* kv_valid, void* o, float* lse,
                 int B, int H, int Hkv, int T_len, int S, int D, int causal, float scale, cudaStream_t stream) {
  // the kernel moves rows in 16-byte units
  const void* ptrs[] = {q, k, v, o};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return -3;
#define TRLX_FWD_CASE(DIM) \
  case DIM: return launch_mma<DIM>(q, k, v, kv_valid, o, lse, B, H, Hkv, T_len, S, causal, scale, stream);
  switch (D) {
    TRLX_FWD_CASE(16)
    TRLX_FWD_CASE(32)
    TRLX_FWD_CASE(64)
    TRLX_FWD_CASE(80)
    TRLX_FWD_CASE(96)
    TRLX_FWD_CASE(128)
    TRLX_FWD_CASE(256)
    default: return -1;  // the wrapper checks D first
  }
#undef TRLX_FWD_CASE
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32 (the SIMT kernel), 1 = bfloat16 (the tensor-core
// kernel); q, k, v and o share it. lse may be null. Returns
// cudaGetLastError() after the launch (0 on success), -1 for an unsupported
// head dim, -2 for an unsupported dtype, -3 for a bfloat16 tensor not
// 16-byte aligned.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* kv_valid,
                         void* o, void* lse, int B, int H, int Hkv, int T_len, int S, int D,
                         int causal, float scale, int dtype, void* stream) {
  const int32_t* valid = static_cast<const int32_t*>(kv_valid);
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, valid, o, lse_f, B, H, Hkv, T_len, S, D, causal, scale, st);
  if (dtype == 1)
    return tc::dispatch_mma(q, k, v, valid, o, lse_f, B, H, Hkv, T_len, S, D, causal, scale, st);
  return -2;
}
