// Building blocks of the tensor-core pass 1 (nw_pass1.cuh:
// nw_prepared_tc_kernel, K1/K2/K4/K5/K6 and the lab's L1 fused_variant,
// whose x3 products are x3_product here) and of K3's dq and ds passes
// (nw_fused.cu: nw_raw_dq_tc_kernel, nw_raw_ds_tc_kernel): the staged
// slices' layout and shared-memory sizes, the TMA and its mbarriers, the
// plain-load staging path, the products on the tensor cores, and the
// self-products that give a query coincident with a support row a
// distance of exactly 0.

#pragma once

#include <climits>
#include <cstdint>

#include <cuda.h>

#include <type_traits>

#include "nw_common.cuh"
#include "vit_mma.cuh"

namespace nw {

constexpr int kTcThreads = 256;                   // a scoring group's threads
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTcBlock = 2 * kTcThreads + 64;     // two scoring groups and their producers
constexpr int kTcStages = 3;                      // slices in each group's ring, by default
constexpr int kTcRowBytes = 128;                  // a staged row: 128 bytes of features
constexpr int kTcAlign = 1024;                    // the 128-byte swizzle's period
constexpr int kTcScoreStride = kSupportTile + 4;  // floats a row of the score tile
constexpr int kTcMaxQuery = 32;                   // the largest query tile
constexpr int kTcListCap = 512;                   // K6: score tiles a block gathers at a time
constexpr int kTcMaxClasses = 8;                  // classes of a tile summed by reductions
constexpr int kX3RowBytes = 64;                   // x3: a slice's 32 bf16 of a hi or lo row

// Bytes of a staged support row: a slice's 128 bytes, or of an int4 bank
// 64 packed bytes (the 128 features of the slice's 128 query bytes).
__host__ __device__ constexpr int tc_bank_row_bytes(bool int4) { return int4 ? 64 : kTcRowBytes; }

// Query rows staged a slice (an m-tile holds 16), and the bytes of one ring
// stage: query rows, 64 support rows (room for 128 bytes each), the tile's
// 64 labels, 64 self-norms and 64 row scales (raw rows: the self-norms'
// two split-K halves in the last two), padded to the swizzle's period.
__host__ __device__ constexpr int tc_query_rows(int qb) { return qb < 16 ? 16 : qb; }
__host__ __device__ constexpr int tc_stage_bytes(int qb) {
  return (tc_query_rows(qb) + kSupportTile) * kTcRowBytes + kTcAlign;
}

// Score tiles a scoring group keeps: one, or at qb <= 16 one for each half
// of the features (the group's two warp halves split each slice's features
// then, as a tile of 16 queries leaves no second m-tile to give them).
__host__ __device__ constexpr int tc_score_bufs(int qb) { return qb <= 16 ? 2 : 1; }

// Dynamic shared memory of one block whose rings hold `stages` slices
// each: the alignment slack, the two groups' rings, each group's score
// tiles, |q|^2 and the queries' running (m, l), K6's tile list and its
// count, the rings' full and empty barriers, acc[qb][C].
inline size_t tc_smem_bytes(int qb, int C, bool sel, int stages = kTcStages) {
  return kTcAlign + static_cast<size_t>(2 * stages) * tc_stage_bytes(qb) +
         sizeof(float) * (2 * tc_score_bufs(qb) * qb * kTcScoreStride + 3 * kTcMaxQuery) +
         (sel ? sizeof(int) * (kTcListCap + 4) : 0) + 32 * static_cast<size_t>(stages) +
         sizeof(float) * static_cast<size_t>(qb) * C;
}

struct TcArgs {
  const void* q;  // (B, D) f32, bf16 or int8 codes (int4 bank: in the bank's k order)
  const void* s;  // the bank, (bank_rows, ds): q's dtype, or packed int4 bytes (x3: bf16 hi)
  const void* s_lo;     // x3: the bank's bf16 lo half, s - hi
  const float* s2;
  const int* labels;
  const float* scale;   // float banks
  const float* qcol;    // int8/int4 banks: (B,) the query's dequant column
  const float* sscale;  // int8/int4 banks: (bank_rows,) the rows' scales
  int l2_mode, B, D, ds, C;
  int tma;                                                  // 0: the rows staged by plain loads
  int S, rows_per_split;                                    // K2
  const int* tile_sel;                                      // K6
  int n_sel, qtiles_per_row, n_tiles, block_s;              // K6
  float* m_out;
  float* l_out;
  float* acc_out;
};

// The TMA's descriptors of q, the bank, its labels, self-norms and row
// scales, and x3's lo half of the bank (unused when the rows are staged by
// plain loads).
struct TcMaps {
  CUtensorMap q, s, labels, s2, sscale, s_lo;
};

// A warp's max and warp_sum (nw_common.cuh) of kN values at once: the
// same butterfly for each, so each gets the same bits, with the trees
// interleaved.
template <int kN>
__device__ __forceinline__ void warp_max_n(float (&v)[kN]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < kN; ++i) v[i] = fmaxf(v[i], __shfl_xor_sync(0xffffffffu, v[i], o));
}

template <int kN>
__device__ __forceinline__ void warp_sum_n(float (&v)[kN]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < kN; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
}

// Byte offset of byte b of row r in a staged tile of 128-byte rows under
// the TMA's 128-byte swizzle: 16-byte chunk c of row r sits at chunk
// c ^ (r mod 8), so the eight rows of a fragment load fall in distinct
// banks.
__device__ __forceinline__ int swz(int r, int b) {
  return r * kTcRowBytes + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

// The same for 64-byte rows under the TMA's 64-byte swizzle (an int4
// bank's staged rows): chunk c of row r sits at chunk c ^ (r / 2 mod 4),
// so eight rows' 32-bit loads at one offset fall in distinct banks.
__device__ __forceinline__ int swz64(int r, int b) {
  return r * 64 + ((((b >> 4) ^ (r >> 1)) & 3) << 4) + (b & 15);
}

template <int kRowBytes>
__device__ __forceinline__ int swz_rows(int r, int b) {
  return kRowBytes == 64 ? swz64(r, b) : swz(r, b);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(vit::smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   vit::smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(vit::smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(vit::smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// A box of the tensor map at (c0 inner, c1 outer) into shared memory,
// completing on bar.
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(vit::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(vit::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_1d(void* dst, const CUtensorMap* map, int c0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2}], [%3];\n" ::"r"(vit::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(vit::smem_u32(bar))
      : "memory");
}

// Rows r0 .. r0 + kRows - 1, elements c0 .. of a (n_rows, D) matrix into a
// swizzled tile of kRowBytes-byte rows by plain loads of one warp (zeros
// past n_rows and D): the path of a matrix whose rows the TMA cannot
// address (D * sizeof(T) not a multiple of 16 bytes, or a base off 16
// bytes).
template <typename T, int kRows, int kRowBytes = kTcRowBytes>
__device__ __forceinline__ void stage_plain(const T* __restrict__ x, int D, int r0, int c0,
                                            int n_rows, char* dst) {
  constexpr int kPerRow = kRowBytes / static_cast<int>(sizeof(T));
  for (int i = threadIdx.x & 31; i < kRows * kPerRow; i += 32) {
    const int r = i / kPerRow, k = i % kPerRow;
    T v = vit::from_float<T>(0.f);
    if (r0 + r < n_rows && c0 + k < D) v = x[static_cast<size_t>(r0 + r) * D + c0 + k];
    *reinterpret_cast<T*>(dst + swz_rows<kRowBytes>(r, k * static_cast<int>(sizeof(T)))) = v;
  }
}

// x = big + small for 3xTF32, both rounded to TF32 to nearest, ties away
// from zero: the bits of cvt.rna.tf32.f32 (as vit_mma.cuh's split_tf32),
// by an integer add and a mask a value instead of two conversions.
template <int kN>
__device__ __forceinline__ void split_rna(const float (&x)[kN], uint32_t (&big)[kN],
                                          uint32_t (&small)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    big[i] = (__float_as_uint(x[i]) + 0x1000u) & 0xffffe000u;
    small[i] = (__float_as_uint(x[i] - __uint_as_float(big[i])) + 0x1000u) & 0xffffe000u;
  }
}

// acc (16 kMI x 8 kNJ: kMI m-tiles of kNJ n-tiles, kNJ 1 or 2) += rows 0
// .. 16 kMI - 1 of swizzled tile a times the 8 kNJ rows at n0 of swizzled
// tile b, over the features k0 .. k0 + kDepth - 1: bf16 mma.sync m16n8k16
// (ldmatrix), f32 3xTF32 m16n8k8 (per accumulator the terms in vit::mma's
// order, small x big, big x small, big x big). The f32 operands split by
// rounding (split_rna: K7's cvt.rna bits), not by truncation as
// warp_product's, and each call's products sum from zero (the small terms
// apart) before one round-to-nearest add into acc: truncated operands, and
// the tensor core's own sums into a long-running accumulator, err the same
// way on every term, so on features of one sign (a ReLU network's) the
// errors add up along the dot product instead of cancelling, and |q|^2 -
// 2 q.s + |s|^2 magnifies them. With truncated operands and one accumulator
// per tile, served ResNet-18 log-probs moved by 4e-3 (H100 80GB HBM3), 20
// times the f32 limit; with rounded operands, 2e-3. The fragments of two
// mma steps are loaded first, then their products are issued accumulator
// by accumulator in turn, so that no product waits on the one before it;
// each accumulator takes its terms in the same order whatever kMI, kNJ and
// kSelf are (the self-products below rely on it). int8 (k0 and kDepth in
// query bytes): s8 m16n8k32 into acc's int32 sums, exact in any order;
// with kInt4 b holds 64-byte rows of packed bytes, query byte k pairing
// with packed byte k / 2 (see the note at the top of nw_prepared.cu).
//
// kSelf (f32 and bf16, kMI = 1, kNJ = 2): also self[jj] += b's 16 rows at
// n0 times themselves, n-tile jj (kSelf = 2) or n-tile self_j (kSelf = 1,
// into self[0]), summed as acc is. Those rows' A fragment is the two
// n-tiles' B fragments, register for register (the 16 x 16 x k block of
// b read by rows is both), so it costs no load.
template <typename T, bool kInt4, int kMI, int kDepth, int kNJ, int kSelf>
__device__ __forceinline__ void tc_product_impl(const char* a, const char* b, int n0, int k0,
                                                typename vit::Frag<T>::Acc (&acc)[kMI][2][4],
                                                float (&self)[2][4], int self_j) {
  static_assert(kNJ == 1 || kNJ == 2, "one or two n-tiles");
  static_assert(kSelf == 0 || (kMI == 1 && kNJ == 2 && !std::is_same_v<T, int8_t>),
                "self-products of float rows beside one m-tile's two n-tiles");
  using F = vit::Frag<T>;
  using Acc = typename F::Acc;
  constexpr int kSteps = kDepth / F::kK;
  constexpr int kBatch = kSteps < 2 ? kSteps : 2;  // mma steps whose fragments load together
  const int lane = threadIdx.x & 31;
  // This call's sums start from zero (f32: big x big apart from the two
  // small terms) and join acc by round-to-nearest adds at its end.
  Acc hi[kMI][2][4] = {}, lo[kMI][2][4] = {};
  float shi[2][4] = {}, slo[2][4] = {};
  // The self-product's right factor: n-tile jj, or self_j.
  const auto self_b = [&](const typename F::B (&fb)[2], int jj) -> typename F::B {
    return kSelf == 2 ? fb[jj] : (self_j ? fb[1] : fb[0]);
  };
#pragma unroll
  for (int s0 = 0; s0 < kSteps; s0 += kBatch) {
    typename F::A fa[kBatch][kMI];
    typename F::B fb[kBatch][2];
    if constexpr (std::is_same_v<T, float>) {
      const int g = lane >> 2, t = lane & 3;
      const float* ar = reinterpret_cast<const float*>(a);
      const float* br = reinterpret_cast<const float*>(b);
#pragma unroll
      for (int s = 0; s < kBatch; ++s) {
        // byte columns of k + t and k + t + 4
        const int c0 = 4 * (k0 + 8 * (s0 + s) + t), c1 = c0 + 16;
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const float x[2] = {br[swz(n0 + 8 * j + g, c0) / 4], br[swz(n0 + 8 * j + g, c1) / 4]};
          split_rna(x, fb[s][j].big, fb[s][j].small);
        }
#pragma unroll
        for (int i = 0; i < kMI; ++i) {
          const int r = 16 * i + g;
          const float x[4] = {ar[swz(r, c0) / 4], ar[swz(r + 8, c0) / 4], ar[swz(r, c1) / 4],
                              ar[swz(r + 8, c1) / 4]};
          split_rna(x, fa[s][i].big, fa[s][i].small);
        }
      }
#pragma unroll
      for (int s = 0; s < kBatch; ++s) {
        typename F::A fs{};  // b's 16 rows as a left factor (rows g, g + 8 at k t, t + 4)
        if constexpr (kSelf > 0) {
          fs = {{fb[s][0].big[0], fb[s][1].big[0], fb[s][0].big[1], fb[s][1].big[1]},
                {fb[s][0].small[0], fb[s][1].small[0], fb[s][0].small[1], fb[s][1].small[1]}};
        }
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
          for (int j = 0; j < kNJ; ++j) vit::mma_tf32(lo[i][j], fa[s][i].small, fb[s][j].big);
#pragma unroll
        for (int jj = 0; jj < kSelf; ++jj) vit::mma_tf32(slo[jj], fs.small, self_b(fb[s], jj).big);
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
          for (int j = 0; j < kNJ; ++j) vit::mma_tf32(lo[i][j], fa[s][i].big, fb[s][j].small);
#pragma unroll
        for (int jj = 0; jj < kSelf; ++jj) vit::mma_tf32(slo[jj], fs.big, self_b(fb[s], jj).small);
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
          for (int j = 0; j < kNJ; ++j) vit::mma_tf32(hi[i][j], fa[s][i].big, fb[s][j].big);
#pragma unroll
        for (int jj = 0; jj < kSelf; ++jj) vit::mma_tf32(shi[jj], fs.big, self_b(fb[s], jj).big);
      }
    } else {  // bf16 and int8: 16-byte rows of 8 bf16 or 16 int8 for ldmatrix
#pragma unroll
      for (int s = 0; s < kBatch; ++s) {
        const int k = (k0 + F::kK * (s0 + s)) * static_cast<int>(sizeof(T));  // in bytes
        if constexpr (kInt4) {
          const int g = lane >> 2, t = lane & 3;
#pragma unroll
          for (int j = 0; j < kNJ; ++j) {
            // Low nibbles hold code + 8, high nibbles the two's-complement code.
            const uint32_t w =
                *reinterpret_cast<const uint32_t*>(b + swz64(n0 + 8 * j + g, k / 2 + 4 * t));
            fb[s][j].r[0] = __vsub4(w & 0x0F0F0F0Fu, 0x08080808u);
            fb[s][j].r[1] = __vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
          }
        } else if constexpr (kNJ == 2) {
          const uint32_t pb = vit::smem_u32(
              b + swz(n0 + (lane & 7) + (lane >> 4) * 8, k + ((lane >> 3) & 1) * 16));
          asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                       : "=r"(fb[s][0].r[0]), "=r"(fb[s][0].r[1]), "=r"(fb[s][1].r[0]),
                         "=r"(fb[s][1].r[1])
                       : "r"(pb));
        } else {  // lanes 0-15 address the n-tile's rows, as x4's first two matrices
          const uint32_t pb = vit::smem_u32(b + swz(n0 + (lane & 7), k + ((lane >> 3) & 1) * 16));
          asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                       : "=r"(fb[s][0].r[0]), "=r"(fb[s][0].r[1])
                       : "r"(pb));
        }
#pragma unroll
        for (int i = 0; i < kMI; ++i) {
          const uint32_t pa = vit::smem_u32(a + swz(16 * i + (lane & 15), k + (lane >> 4) * 16));
          asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                       : "=r"(fa[s][i].r[0]), "=r"(fa[s][i].r[1]), "=r"(fa[s][i].r[2]),
                         "=r"(fa[s][i].r[3])
                       : "r"(pa));
        }
      }
#pragma unroll
      for (int s = 0; s < kBatch; ++s) {
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
          for (int j = 0; j < kNJ; ++j) vit::mma(hi[i][j], fa[s][i], fb[s][j]);
        if constexpr (kSelf > 0) {
          // ldmatrix's four 8 x 8 matrices of b: rows 0-7 and 8-15 at k-lo,
          // k-hi are the A fragment's r[0], r[1], r[2], r[3] in that order.
          const typename F::A fs = {{fb[s][0].r[0], fb[s][1].r[0], fb[s][0].r[1], fb[s][1].r[1]}};
#pragma unroll
          for (int jj = 0; jj < kSelf; ++jj) vit::mma(shi[jj], fs, self_b(fb[s], jj));
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += hi[i][j][e] + lo[i][j][e];
#pragma unroll
  for (int jj = 0; jj < kSelf; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) self[jj][e] += shi[jj][e] + slo[jj][e];
}

template <typename T, bool kInt4, int kMI, int kDepth, int kNJ = 2>
__device__ __forceinline__ void tc_product(const char* a, const char* b, int n0, int k0,
                                           typename vit::Frag<T>::Acc (&acc)[kMI][2][4]) {
  float none[2][4];
  tc_product_impl<T, kInt4, kMI, kDepth, kNJ, 0>(a, b, n0, k0, acc, none, 0);
}

// x3, the kernel lab's f32 mode of three bf16 products: acc (16 queries x
// the two n-tiles at n0) += qh.sh + ql.sh + qh.sl over the features k0 ..
// k0 + kDepth - 1 of a slice of 32, on bf16 mma.sync m16n8k16 with f32
// sums. The query's f32 rows (a: swizzled 128-byte rows) split in
// registers into qh = bf16(q) and ql = bf16(q - qh), round to nearest
// even, as the lab splits the bank; the bank arrives split, its hi rows at
// b and its lo rows at b + 64 rows (64-byte rows of 32 bf16 under the
// 64-byte swizzle), 32-bit loads of the B fragments. The order of the sums,
// per call as tc_product's 3xTF32: the two small products (ql.sh, then
// qh.sl) from zero into one accumulator, qh.sh from zero into another,
// then acc += hi + lo (labs/kernel_lab.py: _fused_variant_plain states the
// same order).
__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int kDepth>
__device__ __forceinline__ void x3_product(const char* a, const char* b, int n0, int k0,
                                           float (&acc)[1][2][4]) {
  using F = vit::Frag<__nv_bfloat16>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const char* b_lo = b + kSupportTile * kX3RowBytes;
  float hi[2][4] = {}, lo[2][4] = {};
#pragma unroll
  for (int s = 0; s < kDepth / F::kK; ++s) {
    const int k = k0 + F::kK * s;
    F::A ah, al;  // rows g, g + 8 at k + 2t, 2t + 1 (r[0], r[1]), then at k + 8 + 2t ..
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = *reinterpret_cast<const float2*>(
          a + swz(g + 8 * (i & 1), 4 * (k + 2 * t + 8 * (i >> 1))));
      const __nv_bfloat162 h = __floats2bfloat162_rn(x.x, x.y);
      const float2 hf = __bfloat1622float2(h);
      ah.r[i] = bf16x2_bits(h);
      al.r[i] = bf16x2_bits(__floats2bfloat162_rn(x.x - hf.x, x.y - hf.y));
    }
    F::B bh[2], bl[2];  // column g of each n-tile at k + 2t, 2t + 1, then k + 8 + 2t ..
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int off = swz64(n0 + 8 * j + g, 2 * (k + 2 * t + 8 * h));
        bh[j].r[h] = *reinterpret_cast<const uint32_t*>(b + off);
        bl[j].r[h] = *reinterpret_cast<const uint32_t*>(b_lo + off);
      }
#pragma unroll
    for (int j = 0; j < 2; ++j) vit::mma(lo[j], al, bh[j]);
#pragma unroll
    for (int j = 0; j < 2; ++j) vit::mma(lo[j], ah, bl[j]);
#pragma unroll
    for (int j = 0; j < 2; ++j) vit::mma(hi[j], ah, bh[j]);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][j][e] += hi[j][e] + lo[j][e];
}

// The kernel lab's split p: f32(bf16(p)) + f32(bf16(p - bf16(p))).
__device__ __forceinline__ float bf16_pair(float p) {
  const float h = __bfloat162float(__float2bfloat16(p));
  return h + __bfloat162float(__float2bfloat16(p - h));
}

// The raw-row route's slice of a score tile (K1 on raw rows, K3's dq and ds
// passes: one device function for the three). A query that is also a
// support row must get a distance of exactly 0, so in l2 mode |q_b|^2 and
// |s_j|^2 come from the tensor cores by the route q.s_j takes: the same
// instructions over the same slices (at kSplitK the same feature halves,
// added half 0 + half 1), each the diagonal of a self-product. Then a
// coincident pair's q2 - 2 dot + s2 is three equal numbers, x - 2x + x =
// 0, provided the tensor core's sum of an output does not depend on where
// in the tile the output sits (on an H100 it does not: chip_smoke.py's
// duplicate-row cases hold m == 0 exactly, at 8- and 32-query tiles, f32
// and bf16). A NaN in a masked support row reaches only that row's column
// and its own diagonal, which the label sets aside.
//
// Per slice, each warp (ws, wh) of a scoring group (ws: its 16 support
// rows, wh: its query m-tile, or at kSplitK its half of the slice's
// features) takes its 16 queries x 16 rows of q.s into dacc and, beside
// them in the same tc_product (l2 mode, kRows), s2 as its 16 rows times
// themselves: at kSplitK both n-tiles of that 16 x 16 block over its half,
// else the n-tile wh, whose diagonal is rows 8 wh .. 8 wh + 7 of the 16.
// Without kRows q.s alone (ds, whose support rows stay while its query
// tiles change, takes s2 on its first query tile only; each accumulator's
// terms come in the same order with or without the self-products, so q.s
// keeps its bits). q2 the same over the query rows on the block's first
// tile (`first`; ds on every tile) (warps ws = 0, and at kQB = 32 also
// ws = 1, which take the two n-tiles of m-tile wh). st is the slice's
// stage: the query rows, then 64 support rows, 128 bytes each. A lane
// keeps only its diagonal element of each self n-tile, s2d[j] and q2d[j]
// (j: the n-tile at kSplitK, else 0), summed over the slices as tc_product
// sums acc: each slice's products from zero, then one add (0 + x is x).
__device__ __forceinline__ float diag_of(const float (&c)[4], bool upper) {
  const int lane = threadIdx.x & 31, e = (lane >> 2) - 2 * (lane & 3);
  return upper ? (e == 1 ? c[3] : c[2]) : (e == 1 ? c[1] : c[0]);
}

template <typename T, int kQB, bool kRows = true>
__device__ __forceinline__ void raw_slice(const char* st, int ws, int wh, bool l2, bool first,
                                          float (&dacc)[1][2][4], float (&s2d)[2],
                                          float (&q2d)[2]) {
  constexpr int kChunk = kTcRowBytes / static_cast<int>(sizeof(T));
  constexpr bool kSplitK = tc_score_bufs(kQB) == 2;
  constexpr int kDepth = kSplitK ? kChunk / 2 : kChunk;
  const char* qa = st + (kSplitK ? 0 : 16 * wh * kTcRowBytes);  // the warp's query m-tile
  const char* s = st + tc_query_rows(kQB) * kTcRowBytes;
  const int k0 = kSplitK ? wh * kDepth : 0;
  if (!l2) {
    tc_product<T, false, 1, kDepth>(qa, s, 16 * ws, k0, dacc);
    return;
  }
  if constexpr (kRows) {
    float x[2][4] = {};
    tc_product_impl<T, false, 1, kDepth, 2, kSplitK ? 2 : 1>(qa, s, 16 * ws, k0, dacc, x, wh);
    if constexpr (kSplitK) {
      s2d[0] += diag_of(x[0], false);
      s2d[1] += diag_of(x[1], true);
    } else {
      s2d[0] += diag_of(x[0], wh == 1);
    }
  } else {
    tc_product<T, false, 1, kDepth>(qa, s, 16 * ws, k0, dacc);
  }
  if (first && ws < (kSplitK ? 1 : 2)) {
    float y[1][2][4] = {};
    if constexpr (kSplitK) {
      tc_product<T, false, 1, kDepth, 2>(st, st, 0, k0, y);
      q2d[0] += diag_of(y[0][0], false);
      q2d[1] += diag_of(y[0][1], true);
    } else {
      tc_product<T, false, 1, kDepth, 1>(qa, st, 16 * wh + 8 * ws, 0, y);
      q2d[0] += diag_of(y[0][0], ws == 1);
    }
  }
}

// The self-norms of raw_slice after a tile's last slice, from the
// lanes (g, t) with g - 2t in {0, 1}, which hold the diagonal of row g of
// their n-tiles: s2h (2 x 64 floats) takes the support rows' (at kSplitK
// half 0, then half 1 at s2h + 64), q2h (32 floats) the queries' on the
// first tile (at kSplitK half 0 at q2h, half 1 at q2h + 16). raw_norm adds
// the halves.
template <int kQB>
__device__ __forceinline__ void raw_self_store(const float (&s2d)[2], const float (&q2d)[2],
                                               int ws, int wh, bool first, float* s2h,
                                               float* q2h) {
  const int lane = threadIdx.x & 31, g = lane >> 2, e = g - 2 * (lane & 3);
  if (e != 0 && e != 1) return;
  if constexpr (tc_score_bufs(kQB) == 2) {
    s2h[64 * wh + 16 * ws + g] = s2d[0];
    s2h[64 * wh + 16 * ws + 8 + g] = s2d[1];
    if (first && ws == 0) {
      q2h[16 * wh + g] = q2d[0];
      q2h[16 * wh + 8 + g] = q2d[1];
    }
  } else {
    s2h[16 * ws + 8 * wh + g] = s2d[0];
    if (first && ws < 2) q2h[16 * wh + 8 * ws + g] = q2d[0];
  }
}

// Row i's self-norm from raw_self_store's halves (h: 64 for s2h, 16 for q2h).
template <int kQB>
__device__ __forceinline__ float raw_norm(const float* x, int i, int h) {
  return tc_score_bufs(kQB) == 2 ? x[i] + x[h + i] : x[i];
}

// A barrier of one scoring group's eight warps (named barriers 3 and 4).
__device__ __forceinline__ void group_sync(int group) {
  if (group == 0) {
    asm volatile("bar.sync 3, %0;\n" ::"n"(kTcThreads) : "memory");
  } else {
    asm volatile("bar.sync 4, %0;\n" ::"n"(kTcThreads) : "memory");
  }
}

// cuTensorMapEncodeTiled, fetched from the driver at run time (the library
// links only the runtime); null when the driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A (rows, cols) row-major matrix as boxes of (box_rows, box_bytes), under
// the swizzle of box_bytes (128 or 64) (rank 2), or a vector as boxes of 64
// (rank 1); zeros past its edges. L2 fetches in 256-byte sectors: a box
// reads 128 bytes of each row, and the next slice the next 128.
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base,
                       long long rows, long long cols, int box_rows,
                       int box_bytes = kTcRowBytes) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t ones[2] = {1, 1};
  if (cols == 0) {
    const cuuint64_t dims[1] = {static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(rows) * elem};
    const cuuint32_t box[1] = {static_cast<cuuint32_t>(kSupportTile)};
    return fn(map, type, 1, const_cast<void*>(base), dims, strides, box, ones,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
              CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_bytes / elem),
                             static_cast<cuuint32_t>(box_rows)};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            box_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace nw
