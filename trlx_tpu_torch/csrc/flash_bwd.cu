// Flash-attention backward for Hopper (sm_90a): dK/dV and dQ.
//
// Replaces: trlx_tpu/ops/attention.py::_flash_bwd_dkv_kernel (flash_bwd_dkv
// below) and ::_flash_bwd_dq_kernel (flash_bwd_dq), the two Pallas TPU
// kernels of _flash_backward. The same contract: q/dO [B,H,T,D], k/v
// [B,Hkv,S,D] (query head h reads kv head h / (H/Hkv), never expanded), the
// forward's per-row logsumexp lse and delta = rowsum(dO * O) [B,H,T] in f32,
// key mask kv_valid[b,s] > 0 combined with slot causality s <= t. The
// forward's P = exp(S - lse) is recomputed tile by tile; rows whose lse is
// -1e30 (no visible key) give P = 0 and so exactly zero gradients.
// dS = P * (dP - delta) * scale with dP = dO V^T; dV = P^T dO, dK = dS^T Q
// summed over the query-head group, dQ = dS K. Sums in f32, outputs cast to
// the input dtype. Two kernels and no atomics, as the JAX package splits
// them: no two CTAs write the same output, so a launch gives the same bits
// every time.
//
// What bounds it on the H100. Per visible (query, key) pair dK/dV does four
// D-long products (S and dP recomputed, then dV and dK), dQ three. At the
// training shape (B=32, H=12, T=S=256, D=64, bf16, causal, a P=128
// left-padded + R=128 right-padded batch) dK/dV's products over the visible
// pairs are ~4 GFLOP: 0.005 ms at the tensor cores' dense bf16 rate (989
// TFLOP/s), against 0.023 ms to move its inputs and outputs once at 3.35
// TB/s. So the kernels are bound by bytes and by latency, not by the
// tensor cores' issue rate; even at half that rate mma.sync leaves them
// memory- and latency-bound. That is why this version uses the warp-level
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) and not wgmma with TMA:
// those are the step after, and only if a profile shows the mma issue rate
// binding. The first version of this file ran every product as f32 FMAs on
// the CUDA cores out of f32 shared memory, one shared load per FMA (16-20 GB
// through shared memory for dK/dV at that shape, ~0.9 ms); that code stays,
// as the f32 instances below: TF32 keeps ~3 digits, too few for the f32
// contract.
//
// Design of the bf16 instances (4 warps per CTA, 64-row tiles, each warp
// owning 16 rows of the CTA's tile, every product on the tensor cores):
// - dkv_mma_kernel: one CTA per (64-key tile, kv head, batch). K and V of
//   the tile sit in shared memory for the CTA's life. The CTA walks the q
//   tiles from the causal start (the tile holding slot k0) and, inside each,
//   the rep = H/Hkv query heads of the group. Each step's Q, dO, lse and
//   delta are staged with 16-byte cp.async, double-buffered: the next step
//   loads while this one computes. A warp forms S^T = K Q^T and
//   dP^T = V dO^T (16 keys x 64 queries) in registers, P^T = exp(S^T*scale
//   - lse) under the mask and dS^T = P^T (dP^T - delta) scale, rounds both
//   to bf16 and feeds them straight from the accumulator registers as the A
//   operand of dV += P^T dO and dK += dS^T Q (FlashAttention-2's reuse of
//   the C fragment as an A fragment); dO and Q come from shared memory
//   through ldmatrix.trans. dK and dV stay in f32 registers to the end.
//   At D=64 this takes 228 registers a thread, two CTAs per SM; forming
//   S^T and dP^T over two 32-query halves instead cut that to 201 but ran
//   8 % slower on the H100 (same bits), so the 64-query form stays.
// - dq_mma_kernel: one CTA per (64-query tile, head, batch). Q and dO are
//   staged once; K, V and the key flags of each kv tile up to the causal
//   diagonal are double-buffered. A warp forms S = Q K^T and dP = dO V^T
//   (16 queries x 64 keys), dS as above, and accumulates dQ += dS K with
//   dS from registers and K through ldmatrix.trans.
// - Work skipped: tiles above the causal diagonal; in dq, kv tiles whose
//   keys are all invalid; in dkv, q steps whose rows all have lse == -1e30
//   (the learner's left padding makes such tiles). A dkv CTA whose keys are
//   all invalid, or a dq CTA whose rows all are dead, writes zeros and
//   exits. The per-element mask is computed only on tiles that need it: the
//   diagonal, a tile holding an invalid key or a dead row, the ragged edge.
// - Shared rows are padded by 16 bytes (row stride D + 8 bf16), so the eight
//   16-byte rows of every ldmatrix phase fall in distinct banks for every
//   supported D. The ragged edge (T, S not multiples of 64) is zero-filled
//   by cp.async and masked; the host pads nothing.
// - Numerics: P and dS are rounded to bf16 before the second products, as
//   every tensor-core flash backward does; accumulators are f32.
// - D = 256 (GPT-J): a warp's dK and dV alone would be 256 f32 registers, so
//   the warps of a row group split the work (Split below): in dkv four warps
//   share each 16-key group of a 32-key tile (8 warps), each forms S^T and
//   dP^T for 16 of the 64 queries at the full D, the four trade their bf16
//   P^T / dS^T fragments through shared memory, and each accumulates 64 of
//   dK's and dV's columns (64 registers); in dq two warps share each 16-query
//   group, 32 keys and 128 of dQ's columns each. The f32 instances step
//   through 32-query (dkv) and 32-key (dq) tiles there: four [64][D+1] f32
//   tiles alone would take 263 KB, over the 227 KB a CTA may have.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;
constexpr int TPR = THREADS / 64;  // threads per tile row
constexpr int PS = BK + 1;         // row stride of the [BQ][BK] score tiles
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// ---------------------------------------------------------------- f32 (SIMT)
// The f32 instances: every product as f32 FMAs out of f32 shared memory
// (this file's first design, unchanged, so f32 results stay bit for bit).

// The SIMT tiles: 64 keys by 64 queries up to D = 128. At D = 256 four
// [64][D+1] f32 tiles alone take 263 KB, over the 227 KB a CTA may have, so
// dK/dV steps through 32-query tiles and dQ through 32-key tiles there
// (214.5 KB and 206 KB).
template <int D>
struct Simt {
  static constexpr int QR = D > 128 ? 32 : 64;  // dkv: query rows a step
  static constexpr int KR = D > 128 ? 32 : 64;  // dq: keys a tile
};

// Stage rows [r0, r0 + ROWS) of a row-major [len][D] matrix into shared
// memory as f32 with row stride D + 1; rows at or past len are zero.
template <typename T, int D, int ROWS = 64>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int r0, int len) {
  for (int i = threadIdx.x; i < ROWS * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int rr = r0 + r;
    dst[r * (D + 1) + d] = rr < len ? to_f32(src[(size_t)rr * D + d]) : 0.f;
  }
}

// P and dS of one ROWS x KEYS tile, THREADS / ROWS threads a query row: this
// thread's row `row` (global slot t), keys j = sub + (THREADS/ROWS)*jj
// (global slot k0 + j). Writes P (when p_out is not null) and dS into shared
// [ROWS][KEYS+1] tiles.
template <int D, int ROWS = 64, int KEYS = BK>
__device__ __forceinline__ void tile_p_ds(const float* q_s, const float* do_s, const float* k_s,
                                          const float* v_s, const int* valid_s, float lse,
                                          float delta, int row, int sub, int t, int k0, int T_len,
                                          int causal, float scale, float* p_out, float* ds_out) {
  constexpr int DQ = D + 1;
  constexpr int TP = THREADS / ROWS;  // threads per query row
  constexpr int RS = KEYS + 1;        // row stride of the score tiles
  // rows with no visible key carry lse = NEG_INF; their mask is all false,
  // and the guard keeps exp() away from inf
  const float lse_safe = lse > NEG_INF / 2 ? lse : 0.f;
#pragma unroll 4
  for (int jj = 0; jj < KEYS / TP; ++jj) {
    const int j = sub + TP * jj;
    float s = 0.f, dp = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      s = fmaf(q_s[row * DQ + d], k_s[j * DQ + d], s);
      dp = fmaf(do_s[row * DQ + d], v_s[j * DQ + d], dp);
    }
    const int sk = k0 + j;
    const bool ok = valid_s[j] && t < T_len && (!causal || sk <= t);
    const float p = ok ? expf(s * scale - lse_safe) : 0.f;
    if (p_out != nullptr) p_out[row * RS + j] = p;
    ds_out[row * RS + j] = p * (dp - delta) * scale;
  }
}

template <int D>
size_t dkv_smem_bytes() {
  // k_s, v_s [64][D+1]; q_s, do_s [QR][D+1]; p_s, ds_s [QR][BK+1]; lse_s, delta_s [QR]; valid_s [BK]
  constexpr int QR = Simt<D>::QR;
  return sizeof(float) * (size_t)(2 * 64 * (D + 1) + 2 * QR * (D + 1) + 2 * QR * PS + 2 * QR) +
         sizeof(int) * BK;
}

template <int D>
size_t dq_smem_bytes() {
  // q_s, do_s [64][D+1]; k_s, v_s [KR][D+1]; ds_s [BQ][KR+1]; valid_s [KR]
  constexpr int KR = Simt<D>::KR;
  return sizeof(float) * (size_t)(2 * 64 * (D + 1) + 2 * KR * (D + 1) + BQ * (KR + 1)) + sizeof(int) * KR;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int32_t* __restrict__ kv_valid,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int Hkv, int T_len, int S,
                     int causal, float scale) {
  constexpr int DQ = D + 1;
  constexpr int DPT = D / TPR;  // output columns per thread
  constexpr int QR = Simt<D>::QR;
  constexpr int TPQ = THREADS / QR;  // threads per query row of the P / dS tile
  extern __shared__ float smem[];
  float* k_s = smem;               // [BK][DQ]
  float* v_s = k_s + BK * DQ;      // [BK][DQ]
  float* q_s = v_s + BK * DQ;      // [QR][DQ]
  float* do_s = q_s + QR * DQ;     // [QR][DQ]
  float* p_s = do_s + QR * DQ;     // [QR][PS]
  float* ds_s = p_s + QR * PS;     // [QR][PS]
  float* lse_s = ds_s + QR * PS;   // [QR]
  float* delta_s = lse_s + QR;     // [QR]
  int* valid_s = reinterpret_cast<int*>(delta_s + QR);  // [BK]

  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / Hkv;
  const int tid = threadIdx.x;
  const int row = tid / TPR;  // this thread's key row of dK / dV
  const int sub = tid % TPR;
  const int prow = tid / TPQ, psub = tid % TPQ;  // its query row and keys of the P / dS tile
  const size_t kv_base = (size_t)(b * Hkv + hk) * S * D;

  load_tile<T, D>(k_s, k + kv_base, k0, S);
  load_tile<T, D>(v_s, v + kv_base, k0, S);
  for (int i = tid; i < BK; i += THREADS) {
    const int s = k0 + i;
    valid_s[i] = (s < S) && kv_valid[(size_t)b * S + s] > 0;
  }

  float dk_acc[DPT], dv_acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  // under causality no query slot before k0 sees this tile: start at the
  // q tile holding slot k0
  const int q_start = causal ? (k0 / QR) * QR : 0;
  for (int q0 = q_start; q0 < T_len; q0 += QR) {
    for (int r = 0; r < rep; ++r) {
      const int h = hk * rep + r;
      const size_t row_base = (size_t)(b * H + h) * T_len;
      const size_t q_base = row_base * D;
      __syncthreads();  // the previous tile's readers are done (and k_s/v_s are written)
      load_tile<T, D, QR>(q_s, q + q_base, q0, T_len);
      load_tile<T, D, QR>(do_s, dout + q_base, q0, T_len);
      for (int i = tid; i < QR; i += THREADS) {
        const int tt = q0 + i;
        lse_s[i] = tt < T_len ? lse[row_base + tt] : NEG_INF;
        delta_s[i] = tt < T_len ? delta[row_base + tt] : 0.f;
      }
      __syncthreads();
      tile_p_ds<D, QR>(q_s, do_s, k_s, v_s, valid_s, lse_s[prow], delta_s[prow], prow, psub, q0 + prow,
                       k0, T_len, causal, scale, p_s, ds_s);
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q for key row `row`
#pragma unroll 4
      for (int t = 0; t < QR; ++t) {
        const float p = p_s[t * PS + row];
        const float ds = ds_s[t * PS + row];
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          const int d = sub + TPR * c;
          dv_acc[c] = fmaf(p, do_s[t * DQ + d], dv_acc[c]);
          dk_acc[c] = fmaf(ds, q_s[t * DQ + d], dk_acc[c]);
        }
      }
    }
  }

  const int s = k0 + row;
  if (s < S) {
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = sub + TPR * c;
      dk[kv_base + (size_t)s * D + d] = from_f32<T>(dk_acc[c]);
      dv[kv_base + (size_t)s * D + d] = from_f32<T>(dv_acc[c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int32_t* __restrict__ kv_valid,
                    T* __restrict__ dq, int H, int Hkv, int T_len, int S, int causal,
                    float scale) {
  constexpr int DQ = D + 1;
  constexpr int DPT = D / TPR;
  constexpr int KR = Simt<D>::KR;
  constexpr int RS = KR + 1;  // row stride of ds_s
  extern __shared__ float smem[];
  float* q_s = smem;               // [BQ][DQ]
  float* do_s = q_s + BQ * DQ;     // [BQ][DQ]
  float* k_s = do_s + BQ * DQ;     // [KR][DQ]
  float* v_s = k_s + KR * DQ;      // [KR][DQ]
  float* ds_s = v_s + KR * DQ;     // [BQ][RS]
  int* valid_s = reinterpret_cast<int*>(ds_s + BQ * RS);  // [KR]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int sub = tid % TPR;
  const int t = q0 + row;
  const size_t row_base = (size_t)(b * H + h) * T_len;
  const size_t q_base = row_base * D;
  const size_t kv_base = (size_t)(b * Hkv + hk) * S * D;

  load_tile<T, D>(q_s, q + q_base, q0, T_len);
  load_tile<T, D>(do_s, dout + q_base, q0, T_len);
  const float lse_t = t < T_len ? lse[row_base + t] : NEG_INF;
  const float delta_t = t < T_len ? delta[row_base + t] : 0.f;

  float dq_acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) dq_acc[c] = 0.f;

  // keys past the tile's last query slot are all causally masked: skip them
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kv_end; k0 += KR) {
    __syncthreads();  // the previous tile's readers are done (and q_s/do_s are written)
    load_tile<T, D, KR>(k_s, k + kv_base, k0, S);
    load_tile<T, D, KR>(v_s, v + kv_base, k0, S);
    for (int i = tid; i < KR; i += THREADS) {
      const int s = k0 + i;
      valid_s[i] = (s < S) && kv_valid[(size_t)b * S + s] > 0;
    }
    __syncthreads();
    tile_p_ds<D, BQ, KR>(q_s, do_s, k_s, v_s, valid_s, lse_t, delta_t, row, sub, t, k0, T_len, causal,
                         scale, nullptr, ds_s);
    __syncwarp();  // the row's 4 threads are adjacent lanes of one warp
    // dQ += dS K for query row `row`
#pragma unroll 4
    for (int j = 0; j < KR; ++j) {
      const float ds = ds_s[row * RS + j];
#pragma unroll
      for (int c = 0; c < DPT; ++c) dq_acc[c] = fmaf(ds, k_s[j * DQ + sub + TPR * c], dq_acc[c]);
    }
  }

  if (t < T_len) {
#pragma unroll
    for (int c = 0; c < DPT; ++c) dq[q_base + (size_t)t * D + sub + TPR * c] = from_f32<T>(dq_acc[c]);
  }
}

// ------------------------------------------------------- bf16 (tensor cores)

namespace tc {

// the shared tensor-core helpers (mma_sm90.cuh): bf16, WARPS, THREADS,
// TILE, Tile<D>, cp.async, ldmatrix, mma_16816, mma_abt, mma_ab, lane maps.
// The using-declaration makes THREADS the header's 128, not the SIMT
// kernels' 256 of the enclosing namespace.
using namespace ::sm90;
using sm90::THREADS;

// How a CTA's warps share its tile: RG groups of 16 rows (keys in dkv,
// queries in dq), each owned by N warps. Up to D = 128 one warp owns its 16
// rows alone (N = 1, RG = 4: a 64-row tile). At D = 256 a warp's dK and dV
// accumulators alone would be 256 f32 registers, over the 255 a thread may
// have, so N warps share each row group: each forms the scores over 64 / N
// of the other axis (queries in dkv, keys in dq) at the full D, they hand
// each other their bf16 P / dS fragments through shared memory
// (put_frags), and each accumulates D / N of the output's columns. dkv
// takes N = 4 over 32-key tiles (RG = 2; dK + dV 64 registers a thread),
// dq N = 2 over 64-query tiles (dQ 64 registers); 8 warps either way.
template <int D, int N_, int RG_>
struct Split {
  static constexpr int N = N_, RG = RG_;
  static constexpr int ROWS = 16 * RG;          // rows of the CTA's tile
  static constexpr int NTH = 32 * N * RG;       // threads of a CTA
  static constexpr int DC = D / N;              // output columns a warp
  static constexpr int CW = TILE / N;           // score columns a warp
  static constexpr int KCW = CW / 16;           // their k16 chunks
  // the fragment exchange: a slot of P and dS a warp (dq uses half)
  static constexpr int SLOT = 2 * KCW * 4 * 32;  // words
  static constexpr int XCH = N > 1 ? N * RG * SLOT * 4 : 0;
};
template <int D>
using DkvSplit = Split<D, (D > 128 ? 4 : 1), (D > 128 ? 2 : 4)>;
template <int D>
using DqSplit = Split<D, (D > 128 ? 2 : 1), 4>;

template <int D>
size_t dkv_smem_bytes() {
  // K, V [ROWS] + 2 stages of (Q, dO [64], lse and delta [64] each) + the exchange
  using SP = DkvSplit<D>;
  return (size_t)2 * SP::ROWS * Tile<D>::ROW_BYTES + 2 * (2 * Tile<D>::BYTES + 2 * TILE * sizeof(float)) + SP::XCH;
}

template <int D>
size_t dq_smem_bytes() {
  // Q, dO + 2 stages of (K, V, key flags [64]) + the exchange
  return (size_t)2 * Tile<D>::BYTES + 2 * (2 * Tile<D>::BYTES + TILE * sizeof(int32_t)) + DqSplit<D>::XCH;
}

template <int D>
__global__ void __launch_bounds__(DkvSplit<D>::NTH)
dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
               const int32_t* __restrict__ kv_valid, bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
               int Hkv, int T_len, int S, int causal, float scale) {
  using TL = Tile<D>;
  using SP = DkvSplit<D>;
  constexpr int STAGE = 2 * TL::BYTES + 2 * TILE * 4;  // Q, dO, lse, delta
  extern __shared__ __align__(16) unsigned char smem[];

  const int k0 = blockIdx.x * SP::ROWS, hk = blockIdx.y, b = blockIdx.z;
  const int rep = H / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  // row group; which part of the split (0 without one)
  const int rg = SP::N > 1 ? warp % SP::RG : warp, part = SP::N > 1 ? warp / SP::RG : 0;
  const size_t kv_base = (size_t)(b * Hkv + hk) * S * D;
  // this thread's two key rows (the C fragment's rows g and g + 8)
  const int key_lo = k0 + 16 * rg + g, key_hi = key_lo + 8;
  const bool valid_lo = key_lo < S && kv_valid[(size_t)b * S + key_lo] > 0;
  const bool valid_hi = key_hi < S && kv_valid[(size_t)b * S + key_hi] > 0;
  // under causality no query slot before k0 sees this tile: start at the q
  // tile holding slot k0; then every (q tile, query head of the group)
  const int q_start = causal ? k0 : 0;
  const int n_items = q_start < T_len ? (T_len - q_start + TILE - 1) / TILE * rep : 0;
  if (!__syncthreads_or(valid_lo || valid_hi) || n_items == 0) {
    zero_rows<D, SP::NTH, SP::ROWS>(dk + kv_base, k0, S);
    zero_rows<D, SP::NTH, SP::ROWS>(dv + kv_base, k0, S);
    return;
  }
  const bool keys_all_valid = __syncthreads_and(valid_lo && valid_hi);

  const uint32_t k_s = smem_addr(smem), v_s = k_s + SP::ROWS * TL::ROW_BYTES, stages = v_s + SP::ROWS * TL::ROW_BYTES;
  auto issue = [&](int item, int st) {
    const int q0 = q_start + (item / rep) * TILE;
    const size_t row_base = (size_t)(b * H + hk * rep + item % rep) * T_len;
    const uint32_t base = stages + st * STAGE;
    load_tile_async<D, SP::NTH>(base, q + row_base * D, q0, T_len);
    load_tile_async<D, SP::NTH>(base + TL::BYTES, dout + row_base * D, q0, T_len);
    // lse by threads 0..63, delta by 64..127
    if (SP::NTH == 2 * TILE || threadIdx.x < 2 * TILE) {
      const int t = q0 + threadIdx.x % TILE;
      cp_async_4(base + 2 * TL::BYTES + threadIdx.x * 4,
                 (threadIdx.x < TILE ? lse : delta) + row_base + (t < T_len ? t : 0), t < T_len);
    }
  };
  load_tile_async<D, SP::NTH, SP::ROWS>(k_s, k + kv_base, k0, S);
  load_tile_async<D, SP::NTH, SP::ROWS>(v_s, v + kv_base, k0, S);
  issue(0, 0);
  cp_async_commit();

  float acc_dk[SP::DC / 8][4], acc_dv[SP::DC / 8][4];
#pragma unroll
  for (int j = 0; j < SP::DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;
  const uint32_t la = lane_a<D>(lane), lb = lane_b<D>(lane);
  const uint32_t warp_rows = 16 * rg * TL::ROW_BYTES;
  const int q_own = part * SP::CW;             // this warp's queries of S^T, dP^T
  const uint32_t col_off = part * SP::DC * 2;  // its columns of dK, dV (bytes)
  uint32_t* xch = reinterpret_cast<uint32_t*>(smem + (stages - k_s) + 2 * STAGE);  // [warp][P, dS]
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_items; ++it) {
    if (it + 1 < n_items) issue(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const int q0 = q_start + (it / rep) * TILE;
    const uint32_t q_s = stages + (it & 1) * STAGE, do_s = q_s + TL::BYTES;
    const float* lse_s = reinterpret_cast<const float*>(smem + (q_s - k_s) + 2 * TL::BYTES);
    const float* delta_s = lse_s + TILE;
    // a row is live when it exists and sees a key (lse > -1e30); the same
    // on every warp, so the branch below (and its barrier) is the CTA's
    const bool live0 = q0 + lane < T_len && lse_s[lane] > NEG_INF / 2;
    const bool live1 = q0 + lane + 32 < T_len && lse_s[lane + 32] > NEG_INF / 2;
    if (__any_sync(FULL, live0 || live1)) {
      const bool masked = !keys_all_valid || !__all_sync(FULL, live0 && live1) ||
                          (causal && q0 < k0 + SP::ROWS - 1);
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x its CW queries
      float s[SP::CW / 8][4], dp[SP::CW / 8][4];
#pragma unroll
      for (int j = 0; j < SP::CW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mma_abt<D, SP::CW / 8>(s, k_s + warp_rows + la, q_s + q_own * TL::ROW_BYTES + lb);
      mma_abt<D, SP::CW / 8>(dp, v_s + warp_rows + la, do_s + q_own * TL::ROW_BYTES + lb);
      // P^T and dS^T, rounded to bf16 as A fragments (k = query)
      uint32_t pa[SP::KCW][4], dsa[SP::KCW][4];
#pragma unroll
      for (int j = 0; j < SP::CW / 8; ++j) {
        const int c = q_own + 8 * j + 2 * tq;  // this thread's query columns c, c + 1
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = e & 1;
          p[e] = exp2f(fmaf(s[j][e], scale_log2, -lse_s[c + x] * LOG2E));
          if (masked) {
            const int query = q0 + c + x, key = e < 2 ? key_lo : key_hi;
            const bool ok = (e < 2 ? valid_lo : valid_hi) && query < T_len && lse_s[c + x] > NEG_INF / 2 &&
                            (!causal || key <= query);
            p[e] = ok ? p[e] : 0.f;
          }
          ds[e] = p[e] * (dp[j][e] - delta_s[c + x]) * scale;
        }
        pa[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
        dsa[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
        dsa[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      if constexpr (SP::N > 1) {
        put_frags<SP::KCW>(xch + warp * SP::SLOT, pa, lane);
        put_frags<SP::KCW>(xch + warp * SP::SLOT + SP::SLOT / 2, dsa, lane);
      }
      mma_ab<D, SP::KCW, SP::DC>(acc_dv, pa, do_s + q_own * TL::ROW_BYTES + la + col_off);  // dV += P^T dO
      mma_ab<D, SP::KCW, SP::DC>(acc_dk, dsa, q_s + q_own * TL::ROW_BYTES + la + col_off);  // dK += dS^T Q
      if constexpr (SP::N > 1) {
        // the other queries: the row group's other warps' P^T and dS^T fragments
        __syncthreads();
#pragma unroll
        for (int o = 1; o < SP::N; ++o) {
          const int other = (part + o) % SP::N, w = other * SP::RG + rg, q_other = other * SP::CW;
          get_frags<SP::KCW>(pa, xch + w * SP::SLOT, lane);
          get_frags<SP::KCW>(dsa, xch + w * SP::SLOT + SP::SLOT / 2, lane);
          mma_ab<D, SP::KCW, SP::DC>(acc_dv, pa, do_s + q_other * TL::ROW_BYTES + la + col_off);
          mma_ab<D, SP::KCW, SP::DC>(acc_dk, dsa, q_s + q_other * TL::ROW_BYTES + la + col_off);
        }
      }
    }
    __syncthreads();  // this stage's (and the exchange's) readers are done before it is refilled
  }

  store_rows<D, SP::DC>(dk + kv_base, acc_dk, key_lo, S, tq, part * SP::DC);
  store_rows<D, SP::DC>(dv + kv_base, acc_dv, key_lo, S, tq, part * SP::DC);
}

template <int D>
__global__ void __launch_bounds__(DqSplit<D>::NTH)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
              const int32_t* __restrict__ kv_valid, bf16* __restrict__ dq, int H, int Hkv, int T_len, int S,
              int causal, float scale) {
  using TL = Tile<D>;
  using SP = DqSplit<D>;
  constexpr int STAGE = 2 * TL::BYTES + TILE * 4;  // K, V, key flags
  extern __shared__ __align__(16) unsigned char smem[];

  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  // row group; which part of the split (0 without one)
  const int rg = SP::N > 1 ? warp % SP::RG : warp, part = SP::N > 1 ? warp / SP::RG : 0;
  const size_t row_base = (size_t)(b * H + h) * T_len;
  const size_t q_base = row_base * D, kv_base = (size_t)(b * Hkv + hk) * S * D;
  // this thread's two query rows (the C fragment's rows g and g + 8)
  int t[2];
  float lse2[2], dlt[2];
  bool live[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    t[half] = q0 + 16 * rg + g + 8 * half;
    const float l = t[half] < T_len ? lse[row_base + t[half]] : NEG_INF;
    live[half] = l > NEG_INF / 2;
    lse2[half] = l * LOG2E;
    dlt[half] = t[half] < T_len ? delta[row_base + t[half]] : 0.f;
  }
  // keys past the tile's last query slot are all causally masked
  const int kv_end = causal ? min(S, q0 + TILE) : S;
  const int n_tiles = (kv_end + TILE - 1) / TILE;
  if (!__syncthreads_or(live[0] || live[1]) || n_tiles == 0) {
    zero_rows<D, SP::NTH>(dq + q_base, q0, T_len);
    return;
  }
  const bool rows_all_live = __syncthreads_and(live[0] && live[1]);

  const uint32_t q_s = smem_addr(smem), do_s = q_s + TL::BYTES, stages = do_s + TL::BYTES;
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
  load_tile_async<D, SP::NTH>(do_s, dout + q_base, q0, T_len);
  issue(0, 0);
  cp_async_commit();

  float acc[SP::DC / 8][4];
#pragma unroll
  for (int j = 0; j < SP::DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const uint32_t la = lane_a<D>(lane), lb = lane_b<D>(lane);
  const uint32_t warp_rows = 16 * rg * TL::ROW_BYTES;
  const int k_own = part * SP::CW;  // this warp's keys of S, dP
  const uint32_t col_off = part * SP::DC * 2;  // its columns of dQ (bytes)
  uint32_t* xch = reinterpret_cast<uint32_t*>(smem + (stages - q_s) + 2 * STAGE);  // [warp][dS]
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) issue(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const int k0 = it * TILE;
    const uint32_t k_s = stages + (it & 1) * STAGE, v_s = k_s + TL::BYTES;
    const int* valid_s = reinterpret_cast<const int*>(smem + (k_s - q_s) + 2 * TL::BYTES);
    // the same on every warp, so the branch below (and its barrier) is the CTA's
    const bool v0 = valid_s[lane] > 0, v1 = valid_s[lane + 32] > 0;  // zero past S
    if (__any_sync(FULL, v0 || v1)) {
      const bool masked = !rows_all_live || !__all_sync(FULL, v0 && v1) || (causal && k0 + TILE - 1 > q0);
      // S = Q K^T and dP = dO V^T: this warp's 16 queries x its CW keys
      float s[SP::CW / 8][4], dp[SP::CW / 8][4];
#pragma unroll
      for (int j = 0; j < SP::CW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mma_abt<D, SP::CW / 8>(s, q_s + warp_rows + la, k_s + k_own * TL::ROW_BYTES + lb);
      mma_abt<D, SP::CW / 8>(dp, do_s + warp_rows + la, v_s + k_own * TL::ROW_BYTES + lb);
      // dS, rounded to bf16 as A fragments (k = key)
      uint32_t dsa[SP::KCW][4];
#pragma unroll
      for (int j = 0; j < SP::CW / 8; ++j) {
        const int c = k_own + 8 * j + 2 * tq;  // this thread's key columns c, c + 1
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int half = e / 2, x = e & 1;
          float p = exp2f(fmaf(s[j][e], scale_log2, -lse2[half]));
          if (masked) {
            const bool ok = valid_s[c + x] > 0 && live[half] && (!causal || k0 + c + x <= t[half]);
            p = ok ? p : 0.f;
          }
          ds[e] = p * (dp[j][e] - dlt[half]) * scale;
        }
        dsa[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
        dsa[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      if constexpr (SP::N > 1) put_frags<SP::KCW>(xch + warp * SP::SLOT, dsa, lane);
      mma_ab<D, SP::KCW, SP::DC>(acc, dsa, k_s + k_own * TL::ROW_BYTES + la + col_off);  // dQ += dS K
      if constexpr (SP::N > 1) {
        // the other keys: the row group's other warps' dS fragments
        __syncthreads();
#pragma unroll
        for (int o = 1; o < SP::N; ++o) {
          const int other = (part + o) % SP::N;
          get_frags<SP::KCW>(dsa, xch + (other * SP::RG + rg) * SP::SLOT, lane);
          mma_ab<D, SP::KCW, SP::DC>(acc, dsa, k_s + other * SP::CW * TL::ROW_BYTES + la + col_off);
        }
      }
    }
    __syncthreads();  // this stage's (and the exchange's) readers are done before it is refilled
  }

  store_rows<D, SP::DC>(dq + q_base, acc, t[0], T_len, tq, part * SP::DC);
}

}  // namespace tc

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int32_t* kv_valid;
  void *dq, *dk, *dv;
  int B, H, Hkv, T_len, S, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dkv(const Args& a) {
  const size_t smem = dkv_smem_bytes<D>();
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.S + BK - 1) / BK, a.Hkv, a.B);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, a.kv_valid, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.H, a.Hkv, a.T_len, a.S, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const Args& a) {
  const size_t smem = dq_smem_bytes<D>();
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.T_len + BQ - 1) / BQ, a.H, a.B);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, a.kv_valid, static_cast<T*>(a.dq), a.H,
      a.Hkv, a.T_len, a.S, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_mma(const Args& a) {
  using tc::bf16;
  const size_t smem = tc::dkv_smem_bytes<D>();
  auto kernel = tc::dkv_mma_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.S + tc::DkvSplit<D>::ROWS - 1) / tc::DkvSplit<D>::ROWS, a.Hkv, a.B);
  kernel<<<grid, tc::DkvSplit<D>::NTH, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), a.lse, a.delta, a.kv_valid, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.H, a.Hkv, a.T_len, a.S, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_mma(const Args& a) {
  using tc::bf16;
  const size_t smem = tc::dq_smem_bytes<D>();
  auto kernel = tc::dq_mma_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.T_len + tc::TILE - 1) / tc::TILE, a.H, a.B);
  kernel<<<grid, tc::DqSplit<D>::NTH, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), a.lse, a.delta, a.kv_valid, static_cast<bf16*>(a.dq), a.H,
      a.Hkv, a.T_len, a.S, a.causal, a.scale);
  return (int)cudaGetLastError();
}

// which = 0: dK/dV, 1: dQ. -1 for an unsupported head dim (the wrapper
// checks D first).
template <typename T>
int dispatch_d(int which, int D, const Args& a) {
#define TRLX_BWD_CASE(DIM) \
  case DIM: return which == 0 ? launch_dkv<T, DIM>(a) : launch_dq<T, DIM>(a);
  switch (D) {
    TRLX_BWD_CASE(16)
    TRLX_BWD_CASE(32)
    TRLX_BWD_CASE(64)
    TRLX_BWD_CASE(80)
    TRLX_BWD_CASE(96)
    TRLX_BWD_CASE(128)
    TRLX_BWD_CASE(256)
    default: return -1;
  }
#undef TRLX_BWD_CASE
}

int dispatch_mma(int which, int D, const Args& a) {
#define TRLX_MMA_CASE(DIM) \
  case DIM: return which == 0 ? launch_dkv_mma<DIM>(a) : launch_dq_mma<DIM>(a);
  switch (D) {
    TRLX_MMA_CASE(16)
    TRLX_MMA_CASE(32)
    TRLX_MMA_CASE(64)
    TRLX_MMA_CASE(80)
    TRLX_MMA_CASE(96)
    TRLX_MMA_CASE(128)
    TRLX_MMA_CASE(256)
    default: return -1;
  }
#undef TRLX_MMA_CASE
}

int dispatch(int which, int D, int dtype, const Args& a) {
  if (dtype == 0) return dispatch_d<float>(which, D, a);
  if (dtype == 1) {
    // the tensor-core kernels move rows in 16-byte units (null: the other
    // entry point's output)
    const void* ptrs[] = {a.q, a.k, a.v, a.dout, a.dq, a.dk, a.dv};
    for (const void* p : ptrs)
      if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return -3;
    return dispatch_mma(which, D, a);
  }
  return -2;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the gradients share
// it); lse and delta are float32 [B,H,T]. Each returns cudaGetLastError()
// after its launch (0 on success), -1 for an unsupported head dim, -2 for an
// unsupported dtype, -3 for a bfloat16 tensor not 16-byte aligned.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* kv_valid, void* dk,
                             void* dv, int B, int H, int Hkv, int T_len, int S, int D, int causal,
                             float scale, int dtype, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         static_cast<const int32_t*>(kv_valid), nullptr, dk, dv, B, H, Hkv, T_len, S, causal,
         scale, static_cast<cudaStream_t>(stream)};
  return dispatch(0, D, dtype, a);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* kv_valid, void* dq,
                            int B, int H, int Hkv, int T_len, int S, int D, int causal,
                            float scale, int dtype, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
         static_cast<const int32_t*>(kv_valid), dq, nullptr, nullptr, B, H, Hkv, T_len, S, causal,
         scale, static_cast<cudaStream_t>(stream)};
  return dispatch(1, D, dtype, a);
}
