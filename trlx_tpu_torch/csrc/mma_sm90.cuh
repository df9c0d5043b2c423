// Warp-level tensor-core building blocks shared by the bf16 kernels of
// flash_fwd.cu, flash_bwd.cu and paged_decode.cu (sm_90a).
//
// A warp owns 16 rows of a tile and runs mma.sync.m16n8k16 (bf16 in, f32
// accumulate) with operands loaded from shared memory by ldmatrix; global
// tiles reach shared memory through 16-byte cp.async. The accumulator's C
// fragment of a product A B^T is, once rounded to bf16, the A fragment of
// the next product (FlashAttention-2's register reuse), so probabilities
// never go through shared memory; split into hi + lo bf16 parts
// (pack_bf16_split) it is two A fragments that keep ~16 bits of it.
//
// Fragment maps (PTX ISA, mma.m16n8k16): lane = 4 g + tq. C / D: c0, c1 at
// (row g, cols 2tq, 2tq+1), c2, c3 at (row g+8, same cols). A: a0 (row g, k
// 2tq..+1), a1 (row g+8, k 2tq..+1), a2 (row g, k 2tq+8..+9), a3 (row g+8,
// k 2tq+8..+9). B: b0 (k 2tq..+1, col g), b1 (k 2tq+8..+9, col g).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;  // 16 tile rows per warp
constexpr int TILE = 64;             // rows of a shared tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

// Shared layout of a [rows][D] bf16 tile: rows padded by 8 elements (16
// bytes). A row is then D/8 + 1 16-byte units; D is a multiple of 16 (one
// k16 step of mma, two 16-byte ldmatrix columns), so D/8 is even and the
// unit count odd for every such D (80: 11, 256: 33), and the 8 rows one
// ldmatrix phase reads start in 8 distinct 4-bank groups.
template <int D>
struct Tile {
  static_assert(D % 16 == 0 && D >= 16 && D <= 256, "head dim: a multiple of 16 up to 256");
  static constexpr int ROW_BYTES = (D + 8) * 2;
  static constexpr int BYTES = TILE * ROW_BYTES;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronous; zero-filled when !pred.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// Wait until every committed group has landed.
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair, `lo` in the low half (the lower k index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats as two bf16 pairs whose sum is the floats to ~16 bits: hi =
// bf16(x), lo = bf16(x - hi). A product fed hi and lo (mma_ab_split) loses
// ~2^-17 of a probability where one fed bf16(x) alone loses ~2^-9.
__device__ __forceinline__ void pack_bf16_split(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Rows [r0, r0 + ROWS) of a row-major [len][D] bf16 matrix into a shared
// tile at `dst` (Tile<D>'s row stride), asynchronously, by the NTH threads
// of the CTA; rows at or past len are zero-filled.
template <int D, int NTH = THREADS, int ROWS = TILE>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* __restrict__ src, int r0, int len) {
  constexpr int PER_ROW = D / 8, CHUNKS = ROWS * PER_ROW;
#pragma unroll
  for (int j = 0; j < (CHUNKS + NTH - 1) / NTH; ++j) {
    const int i = threadIdx.x + j * NTH;
    if (CHUNKS % NTH != 0 && i >= CHUNKS) break;
    const int r = i / PER_ROW, c = i % PER_ROW;
    const bool ok = r0 + r < len;
    cp_async_16(dst + r * Tile<D>::ROW_BYTES + c * 16, src + (size_t)(ok ? r0 + r : 0) * D + c * 8, ok);
  }
}

// acc[NT][4] += A B^T for this warp: A is 16 rows x D of a shared tile
// (lane address a_addr, from lane_a), B is NT*8 rows x D of a shared tile
// (lane address b_addr, from lane_b), both read with ldmatrix. acc[j] holds
// output columns 8j..8j+7 as mma C fragments.
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_addr + kk * 32);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, b_addr + np * 16 * Tile<D>::ROW_BYTES + kk * 32);
      mma_16816(acc[2 * np], a, b[0], b[1]);
      mma_16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// The A fragments of this warp's 16 rows x D of a shared tile (lane address
// a_addr, from lane_a), one per k16 chunk, for products that reuse them.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4], uint32_t a_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(a[kk], a_addr + kk * 32);
}

// mma_abt with A already in registers (load_a_frags).
template <int D, int NT>
__device__ __forceinline__ void mma_abt_regs(float (&acc)[NT][4], const uint32_t (&a)[D / 16][4], uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, b_addr + np * 16 * Tile<D>::ROW_BYTES + kk * 32);
      mma_16816(acc[2 * np], a[kk], b[0], b[1]);
      mma_16816(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc[NC/8][4] += A B for this warp: A is 16 rows x 16*KC given as KC
// k-chunks of A fragments (from registers), B is 16*KC rows x NC columns of
// a shared tile of row width D read transposed (lane address b_addr, from
// lane_a, plus 2 bytes a column where NC < D takes columns from c0).
template <int D, int KC, int NC = D>
__device__ __forceinline__ void mma_ab(float (&acc)[NC / 8][4], const uint32_t (&a)[KC][4], uint32_t b_addr) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
    for (int dp = 0; dp < NC / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, b_addr + kc * 16 * Tile<D>::ROW_BYTES + dp * 32);
      mma_16816(acc[2 * dp], a[kc], b[0], b[1]);
      mma_16816(acc[2 * dp + 1], a[kc], b[2], b[3]);
    }
  }
}

// mma_ab with A given as hi + lo parts (pack_bf16_split): each B fragment
// is loaded once and multiplied by both.
template <int D, int KC, int NC = D>
__device__ __forceinline__ void mma_ab_split(float (&acc)[NC / 8][4], const uint32_t (&hi)[KC][4],
                                             const uint32_t (&lo)[KC][4], uint32_t b_addr) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
    for (int dp = 0; dp < NC / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, b_addr + kc * 16 * Tile<D>::ROW_BYTES + dp * 32);
      mma_16816(acc[2 * dp], lo[kc], b[0], b[1]);
      mma_16816(acc[2 * dp + 1], lo[kc], b[2], b[3]);
      mma_16816(acc[2 * dp], hi[kc], b[0], b[1]);
      mma_16816(acc[2 * dp + 1], hi[kc], b[2], b[3]);
    }
  }
}

// Per-lane byte offsets into a shared tile for ldmatrix.x4:
// lane_a: an A operand (16 rows x 16) or a transposed B operand (16 k-rows x
//   16 n-columns): lanes 0-15 rows 0-15 at column 0, lanes 16-31 at column 8.
// lane_b: a B operand stored n-major (16 n-rows x 16 k-columns): lanes 0-7
//   rows 0-7 col 0, 8-15 rows 0-7 col 8, 16-23 rows 8-15 col 0, 24-31 rows
//   8-15 col 8.
template <int D>
__device__ __forceinline__ uint32_t lane_a(int lane) {
  return (lane % 16) * Tile<D>::ROW_BYTES + (lane / 16) * 16;
}

template <int D>
__device__ __forceinline__ uint32_t lane_b(int lane) {
  return ((lane % 8) + 8 * (lane / 16)) * Tile<D>::ROW_BYTES + ((lane / 8) % 2) * 16;
}

// Zero rows [r0, min(r0 + ROWS, len)) of a row-major [len][D] bf16 matrix,
// by the NTH threads of the CTA.
template <int D, int NTH = THREADS, int ROWS = TILE>
__device__ __forceinline__ void zero_rows(bf16* __restrict__ dst, int r0, int len) {
  const int n = min(ROWS, len - r0) * D / 8;
  uint4* p = reinterpret_cast<uint4*>(dst + (size_t)r0 * D);
  for (int i = threadIdx.x; i < n; i += NTH) p[i] = make_uint4(0, 0, 0, 0);
}

// Store an accumulator tile (16 rows x NC columns from column c0, C
// fragments) as bf16: rows r_lo and r_lo + 8 of a row-major [len][D]
// matrix, skipping rows at or past len.
template <int D, int NC = D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float (&acc)[NC / 8][4], int r_lo,
                                           int len, int tq, int c0 = 0) {
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r_lo + 8 * half;
      if (r < len)
        *reinterpret_cast<uint32_t*>(dst + (size_t)r * D + c0 + 8 * j + 2 * tq) =
            pack_bf16(acc[j][2 * half], acc[j][2 * half + 1]);
    }
  }
}

// A fragments handed between the warps of a CTA through shared memory (the
// D = 256 kernels split a product's k range over two warps): a slot holds
// KC k-chunks as [KC][4][32] words, one word a register and lane, so a warp
// writes or reads 128 contiguous bytes a register (no bank conflict), and a
// warp reading another warp's slot by its own lane gets exactly the
// fragments that warp's lanes held.
template <int KC>
__device__ __forceinline__ void put_frags(uint32_t* slot, const uint32_t (&a)[KC][4], int lane) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int e = 0; e < 4; ++e) slot[(kc * 4 + e) * 32 + lane] = a[kc][e];
}

template <int KC>
__device__ __forceinline__ void get_frags(uint32_t (&a)[KC][4], const uint32_t* slot, int lane) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kc][e] = slot[(kc * 4 + e) * 32 + lane];
}

// Max and sum over the 4 lanes of a quad (the lanes sharing C-fragment rows).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

}  // namespace sm90
