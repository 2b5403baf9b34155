// Tensor-core building blocks of the ViT attention kernels (K7 in
// vit_attn.cu, K8 in vit_attn_bwd.cu): tiles staged with cp.async, and
// warp-level mma.sync products whose operands come from shared memory or,
// for a product whose left factor the warp has just computed, straight from
// the accumulator registers.
//
// A warp owns 16 rows of every product and computes 16 x 8 accumulator
// tiles ("n-tiles"). Thread (g, t) = (lane / 4, lane % 4) holds rows g and
// g + 8 and columns 2t, 2t + 1 of each n-tile: c[0], c[1] on row g, c[2],
// c[3] on row g + 8.
//   * bf16: mma.sync.m16n8k16 (bf16 operands, f32 sums), operands loaded
//     with ldmatrix (x4: a right factor two n-tiles at a time),
//     ldmatrix.trans for a right factor stored k-major. The
//     accumulator layout of two n-tiles is the A layout of the next
//     product's 16-deep step, so P and dS never leave the registers.
//   * f32: 3xTF32 on mma.sync.m16n8k8 (CUTLASS's OpMultiplyAddFastF32):
//     each operand x splits as big = tf32(x) and small = tf32(x - big), and
//     big * big + big * small + small * big goes into the f32 sums (small *
//     small, below f32's precision, is left out). Operands are 32-bit shared
//     loads; a product whose left factor comes from the accumulators sums
//     its 8-deep step over keys in the order (2t, 2t + 1) -> (t, t + 4),
//     which the right factor's loads follow, so no shuffles are needed.
// Staged tiles are row-major, rows of kHd elements plus 16 bytes of
// padding: ldmatrix's eight 16-byte rows and the f32 loads' (g, t) pattern
// then fall in 32 different banks.
//
// The MLP kernels (K9, K11 and K11 int8 in vit_mlp.cu, the K9 backward in
// vit_mlp_bwd.cu) and K10's projections (proj_tc_kernel in vit_attn.cu,
// bf16 and int8) use the same fragments on tiles of any width (stage_tile,
// mlp_stride, warp_product below): their depths run to 4,096, their rows
// may be ragged, and their left factors also come k-major (load_a_km: the
// weight gradients, whose depth is tokens). An f32 tile read by rows g
// (load_a, load_b_nk) is padded to a stride of 4 mod 32 words, one read by
// rows t (load_a_km, load_b_kn_nat) to 8 mod 32, so that each load's 32
// lanes hit 32 banks.
//   * int8 (K11 int8, K10 int8): mma.sync.m16n8k32 (s8 operands, exact s32 sums).
//     Its A fragment is the bf16 one byte for byte, so a row-major code
//     tile loads with ldmatrix. Its B fragment wants four consecutive k of
//     one column in a register, and ldmatrix.trans moves only 16-bit
//     elements, so a right factor stored k-major (the weights as stored,
//     (in, out)) loads by 32-bit words and is transposed in registers with
//     __byte_perm (load_b_kn4), four n-tiles at a time. Rows of 16 mod 128
//     bytes serve both loads without bank conflicts.

#pragma once

#include <type_traits>

#include "vit_common.cuh"

namespace vit {

constexpr int kAttnWarps = 4;
constexpr int kAttnThreads = 32 * kAttnWarps;
constexpr int kAttnTile = 16 * kAttnWarps;  // rows (queries or keys) a block owns

// Row stride, in elements, of a staged tile of kHd-wide rows.
template <typename T, int kHd>
__host__ __device__ constexpr int tile_stride() {
  return kHd + 16 / static_cast<int>(sizeof(T));
}

template <typename T, int kHd>
__host__ __device__ constexpr int tile_elems(int rows) { return rows * tile_stride<T, kHd>(); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (nothing is read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)), "l"(gmem),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Rows r0 .. r0 + kRows - 1 of a (n, kHd) slab whose row r starts at
// base + r * row_stride, into a staged tile; rows past n are zeros.
template <typename T, int kHd, int kRows>
__device__ __forceinline__ void stage_rows(const T* __restrict__ base, long long row_stride, int r0,
                                           int n, T* __restrict__ dst) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kSegs = kHd / kVec;
  constexpr int kStride = tile_stride<T, kHd>();
  for (int i = threadIdx.x; i < kRows * kSegs; i += kAttnThreads) {
    const int r = i / kSegs, s = i % kSegs;
    const bool valid = r0 + r < n;
    cp_async16(dst + r * kStride + s * kVec, base + (valid ? r0 + r : 0) * row_stride + s * kVec,
               valid);
  }
}

template <typename T>
struct Frag;

template <>
struct Frag<__nv_bfloat16> {
  static constexpr int kK = 16;  // depth of one mma
  using Acc = float;             // the accumulator's element
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
};

template <>
struct Frag<float> {
  static constexpr int kK = 8;
  using Acc = float;
  struct A { uint32_t big[4], small[4]; };
  struct B { uint32_t big[2], small[2]; };
};

// Four codes a register: A rows g, g + 8 at k = 4t .. 4t + 3 and 16 + 4t
// ..; B column g at k = 4t .. and 16 + 4t ...
template <>
struct Frag<int8_t> {
  static constexpr int kK = 32;
  using Acc = int;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// kTrunc (the MLP kernels): big = x with its low 13 mantissa bits cleared
// and small = x - big (exact), whose low bits the TF32 product ignores: an
// error of at most 2^-20 |x| in small, and no cvt (the rounding conversions
// cost the f32 MLP kernels a sixth of their time on the card).
template <bool kTrunc = false, int kN>
__device__ __forceinline__ void split_tf32(const float (&x)[kN], uint32_t (&big)[kN],
                                           uint32_t (&small)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    if constexpr (kTrunc) {
      big[i] = __float_as_uint(x[i]) & 0xffffe000u;
      small[i] = __float_as_uint(x[i] - __uint_as_float(big[i]));
    } else {
      big[i] = to_tf32(x[i]);
      small[i] = to_tf32(x[i] - __uint_as_float(big[i]));
    }
  }
}

// A: rows row0 .. row0 + 15, columns k0 .. k0 + kK - 1 of a staged tile.
template <int kStride, bool kTrunc = false>
__device__ __forceinline__ void load_a(const __nv_bfloat16* tile, int row0, int k0,
                                       Frag<__nv_bfloat16>::A& a) {
  const int lane = threadIdx.x & 31;
  const uint32_t addr = smem_u32(tile + (row0 + (lane & 15)) * kStride + k0 + (lane >> 4) * 8);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a.r[0]), "=r"(a.r[1]), "=r"(a.r[2]), "=r"(a.r[3])
               : "r"(addr));
}

// int8: the same four 8 x 16-byte matrices as bf16, k0 in bytes.
template <int kStride, bool kTrunc = false>
__device__ __forceinline__ void load_a(const int8_t* tile, int row0, int k0, Frag<int8_t>::A& a) {
  const int lane = threadIdx.x & 31;
  const uint32_t addr = smem_u32(tile + (row0 + (lane & 15)) * kStride + k0 + (lane >> 4) * 16);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a.r[0]), "=r"(a.r[1]), "=r"(a.r[2]), "=r"(a.r[3])
               : "r"(addr));
}

template <int kStride, bool kTrunc = false>
__device__ __forceinline__ void load_a(const float* tile, int row0, int k0, Frag<float>::A& a) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = tile + (row0 + g) * kStride + k0 + t;
  const float x[4] = {p[0], p[8 * kStride], p[4], p[8 * kStride + 4]};
  split_tf32<kTrunc>(x, a.big, a.small);
}

// B[k][n] = tile[n0 + n][k0 + k] for the two n-tiles at n0 and n0 + 8: the
// right factor of A B^T, its rows staged (K in q K^T, V in dO V^T, Q and dO
// in K Q^T and V dO^T).
template <int kStride, bool kTrunc = false>
__device__ __forceinline__ void load_b_nk(const __nv_bfloat16* tile, int n0, int k0,
                                          Frag<__nv_bfloat16>::B& b0,
                                          Frag<__nv_bfloat16>::B& b1) {
  const int lane = threadIdx.x & 31;
  const uint32_t addr =
      smem_u32(tile + (n0 + (lane & 7) + (lane >> 4) * 8) * kStride + k0 + ((lane >> 3) & 1) * 8);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b0.r[0]), "=r"(b0.r[1]), "=r"(b1.r[0]), "=r"(b1.r[1])
               : "r"(addr));
}

template <int kStride, bool kTrunc = false>
__device__ __forceinline__ void load_b_nk(const float* tile, int n0, int k0, Frag<float>::B& b0,
                                          Frag<float>::B& b1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = tile + (n0 + g) * kStride + k0 + t;
  const float x0[2] = {p[0], p[4]}, x1[2] = {p[8 * kStride], p[8 * kStride + 4]};
  split_tf32<kTrunc>(x0, b0.big, b0.small);
  split_tf32<kTrunc>(x1, b1.big, b1.small);
}

// B[k][n] = tile[k0 + k][n0 + n] for the two n-tiles at n0 and n0 + 8: a
// right factor stored k-major (V in P V, dO in P^T dO, Q in dS^T Q, K in
// dS K). f32: k = t, t + 4 read rows 2t, 2t + 1, the order a_from_acc
// gives the left factor.
template <int kStride>
__device__ __forceinline__ void load_b_kn(const __nv_bfloat16* tile, int k0, int n0,
                                          Frag<__nv_bfloat16>::B& b0,
                                          Frag<__nv_bfloat16>::B& b1) {
  const int lane = threadIdx.x & 31;
  const uint32_t addr =
      smem_u32(tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride + n0 + (lane >> 4) * 8);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b0.r[0]), "=r"(b0.r[1]), "=r"(b1.r[0]), "=r"(b1.r[1])
               : "r"(addr));
}

template <int kStride>
__device__ __forceinline__ void load_b_kn(const float* tile, int k0, int n0, Frag<float>::B& b0,
                                          Frag<float>::B& b1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = tile + (k0 + 2 * t) * kStride + n0 + g;
  const float x0[2] = {p[0], p[kStride]}, x1[2] = {p[8], p[kStride + 8]};
  split_tf32(x0, b0.big, b0.small);
  split_tf32(x1, b1.big, b1.small);
}

// B[k][n] = tile[k0 + k][n0 + n] with k in its natural order (f32: k = t,
// t + 4 read rows t, t + 4), the right factor of a product whose left
// factor load_a or load_a_km reads from shared memory; bf16 is load_b_kn.
template <int kStride, bool kTrunc = false>
__device__ __forceinline__ void load_b_kn_nat(const __nv_bfloat16* tile, int k0, int n0,
                                              Frag<__nv_bfloat16>::B& b0,
                                              Frag<__nv_bfloat16>::B& b1) {
  load_b_kn<kStride>(tile, k0, n0, b0, b1);
}

template <int kStride, bool kTrunc = false>
__device__ __forceinline__ void load_b_kn_nat(const float* tile, int k0, int n0,
                                              Frag<float>::B& b0, Frag<float>::B& b1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = tile + (k0 + t) * kStride + n0 + g;
  const float x0[2] = {p[0], p[4 * kStride]}, x1[2] = {p[8], p[4 * kStride + 8]};
  split_tf32<kTrunc>(x0, b0.big, b0.small);
  split_tf32<kTrunc>(x1, b1.big, b1.small);
}

// B[k][n] = tile[k0 + k][n0 + c(j, n)] for the four int8 n-tiles j < 4 of
// columns n0 .. n0 + 31, whose column n is c(j, n) = 4 n + j: thread (g,
// t) reads the word of columns n0 + 4g .. + 3 from each of rows k0 + 4t ..
// + 3 (and k0 + 16 + 4t ..), and the 4 x 4 transpose of those bytes gives
// its register of each n-tile. So each thread's accumulator elements of
// the four n-tiles are 8 consecutive columns (acc_col_s8). Threads t >= 2
// read their rows in the order 2, 3, 0, 1: with a row stride of 16 mod 128
// bytes each load's 32 lanes then fall in 32 banks.
template <int kStride>
__device__ __forceinline__ void load_b_kn4(const int8_t* tile, int k0, int n0,
                                           Frag<int8_t>::B (&b)[4]) {
  static_assert(kStride % 128 == 16, "rows of 16 mod 128 bytes");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int sw = t & 2;
  // Byte selectors of the last step, for rows read in order or swapped.
  const uint32_t lo = sw ? 0x1054u : 0x5410u, hi = sw ? 0x3276u : 0x7632u;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int8_t* p = tile + (k0 + 16 * h + 4 * t) * kStride + n0 + 4 * g;
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = *reinterpret_cast<const uint32_t*>(p + (i ^ sw) * kStride);
    const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140), t3 = __byte_perm(w[2], w[3], 0x7362);
    b[0].r[h] = __byte_perm(t0, t2, lo);
    b[1].r[h] = __byte_perm(t0, t2, hi);
    b[2].r[h] = __byte_perm(t1, t3, lo);
    b[3].r[h] = __byte_perm(t1, t3, hi);
  }
}

// Column (within the warp's n0 ..) of accumulator element e of int8
// n-tile j under load_b_kn4's order: 32 (j / 4) + 8t + 4 (e & 1) + j % 4.
__device__ __forceinline__ int acc_col_s8(int j, int e) {
  return 32 * (j >> 2) + 8 * (threadIdx.x & 3) + 4 * (e & 1) + (j & 3);
}

// A[m][k] = tile[k0 + k][row0 + m], m < 16: a left factor stored k-major
// (x and g in the weight gradients, whose depth is tokens); bf16 through
// ldmatrix.trans.
template <int kStride, bool kTrunc = false>
__device__ __forceinline__ void load_a_km(const __nv_bfloat16* tile, int row0, int k0,
                                          Frag<__nv_bfloat16>::A& a) {
  const int lane = threadIdx.x & 31;
  const uint32_t addr = smem_u32(tile + (k0 + (lane & 7) + ((lane >> 4) & 1) * 8) * kStride +
                                 row0 + ((lane >> 3) & 1) * 8);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a.r[0]), "=r"(a.r[1]), "=r"(a.r[2]), "=r"(a.r[3])
               : "r"(addr));
}

template <int kStride, bool kTrunc = false>
__device__ __forceinline__ void load_a_km(const float* tile, int row0, int k0, Frag<float>::A& a) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = tile + (k0 + t) * kStride + row0 + g;
  const float x[4] = {p[0], p[8], p[4 * kStride], p[4 * kStride + 8]};
  split_tf32<kTrunc>(x, a.big, a.small);
}

// The left factor of a product's kk-th step from accumulator n-tiles: bf16
// rounds n-tiles 2 kk and 2 kk + 1 to bf16 (round to nearest even, the
// rounding point of P and dS) and packs them, f32 splits n-tile kk
// (columns 2t, 2t + 1 as k = t, t + 4).
template <int kNT>
__device__ __forceinline__ void a_from_acc(const float (&c)[kNT][4], int kk,
                                           Frag<__nv_bfloat16>::A& a) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* lo = c[2 * kk + h];
    const __nv_bfloat162 top = __floats2bfloat162_rn(lo[0], lo[1]);
    const __nv_bfloat162 bot = __floats2bfloat162_rn(lo[2], lo[3]);
    a.r[2 * h] = *reinterpret_cast<const uint32_t*>(&top);
    a.r[2 * h + 1] = *reinterpret_cast<const uint32_t*>(&bot);
  }
}

template <int kNT>
__device__ __forceinline__ void a_from_acc(const float (&c)[kNT][4], int kk, Frag<float>::A& a) {
  const float x[4] = {c[kk][0], c[kk][2], c[kk][1], c[kk][3]};
  split_tf32(x, a.big, a.small);
}

__device__ __forceinline__ void mma(float (&d)[4], const Frag<__nv_bfloat16>::A& a,
                                    const Frag<__nv_bfloat16>::B& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]), "r"(b.r[1]));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// int8 codes, int32 sums (exact: no rounding, any order).
__device__ __forceinline__ void mma(int (&d)[4], const Frag<int8_t>::A& a,
                                    const Frag<int8_t>::B& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]), "r"(b.r[1]));
}

// 3xTF32: the two small cross terms first, then big * big.
__device__ __forceinline__ void mma(float (&d)[4], const Frag<float>::A& a,
                                    const Frag<float>::B& b) {
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

// acc[j] = the warp's 16 rows (row0 ..) of tile a times rows 8 j .. 8 j + 7
// of tile b, summed over kHd: (A B^T) in kNT n-tiles. n-tiles at or past
// n_valid rows of b are skipped and stay 0.
template <typename T, int kHd, int kNT>
__device__ __forceinline__ void tile_abt(const T* __restrict__ a_tile, int row0,
                                         const T* __restrict__ b_tile, int n_valid,
                                         float (&acc)[kNT][4]) {
  constexpr int kStride = tile_stride<T, kHd>();
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < kHd; k0 += Frag<T>::kK) {
    typename Frag<T>::A a;
    load_a<kStride>(a_tile, row0, k0, a);
#pragma unroll
    for (int j = 0; j < kNT; j += 2) {
      if (8 * j < n_valid) {
        typename Frag<T>::B b0, b1;
        load_b_nk<kStride>(b_tile, 8 * j, k0, b0, b1);
        mma(acc[j], a, b0);
        if (8 * j + 8 < n_valid) mma(acc[j + 1], a, b1);
      }
    }
  }
}

// acc (16 x kHd, kHd / 8 n-tiles) += P (16 x 8 kNT, in accumulator n-tiles,
// rounded to T here) times tile b's rows 0 .. 8 kNT - 1. Steps wholly at or
// past n_valid rows of b are skipped (their P is 0).
template <typename T, int kHd, int kNT>
__device__ __forceinline__ void acc_pb(const float (&p)[kNT][4], const T* __restrict__ b_tile,
                                       int n_valid, float (&acc)[kHd / 8][4]) {
  constexpr int kStride = tile_stride<T, kHd>();
  constexpr int kK = Frag<T>::kK;
#pragma unroll
  for (int kk = 0; kk < 8 * kNT / kK; ++kk) {
    if (kk * kK < n_valid) {
      typename Frag<T>::A a;
      a_from_acc(p, kk, a);
#pragma unroll
      for (int n = 0; n < kHd / 8; n += 2) {
        typename Frag<T>::B b0, b1;
        load_b_kn<kStride>(b_tile, kk * kK, 8 * n, b0, b1);
        mma(acc[n], a, b0);
        mma(acc[n + 1], a, b1);
      }
    }
  }
}

// Two neighbouring output values (columns 2t, 2t + 1 of an n-tile) as T.
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// Row stride, in elements, of a staged MLP tile kCols wide: int8 and bf16
// 16 bytes of padding; f32 to 4 mod 32 words for a tile read by rows g, 8
// mod 32 for one read by rows t (kByT).
template <typename T, int kCols, bool kByT>
__host__ __device__ constexpr int mlp_stride() {
  return sizeof(T) == 1 ? kCols + 16 : sizeof(T) == 2 ? kCols + 8 : kCols + (kByT ? 8 : 4);
}

// 1 if a row-major matrix at p with leading dimension ld (elements) takes
// stage_tile's 16-byte copies (p and every row 16-byte aligned), else 0.
template <typename T>
inline int vec16_ok(const void* p, long long ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         ld * static_cast<long long>(sizeof(T)) % 16 == 0;
}

// Rows r0 .. r0 + kRows - 1, columns c0 .. c0 + kCols - 1 of a row-major
// matrix with n_rows rows, n_cols columns and leading dimension ld, into a
// tile of row stride kStride, by kThreads threads. What lies outside the
// matrix reads 0, except column ones_col (>= 0), which reads 1 on the
// matrix's rows: the row of ones whose product is a bias gradient. vec16
// (ld and base 16-byte aligned): cp.async of 16 bytes where a segment lies
// wholly inside or outside; elsewhere (a ragged width, the ones column)
// plain loads, so that no shape is refused.
template <typename T, int kRows, int kCols, int kStride, int kThreads>
__device__ __forceinline__ void stage_tile(const T* __restrict__ base, long long ld, int r0,
                                           int c0, int n_rows, int n_cols, bool vec16,
                                           T* __restrict__ dst, int ones_col = -1) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kSegs = kCols / kVec;
  constexpr int kTotal = kRows * kSegs;
  static_assert(kCols % kVec == 0, "whole 16-byte segments");
  // Unrolled over a trip count known at compile time: a segment's row and
  // column come from constants, not a division in a runtime loop.
#pragma unroll
  for (int u = 0; u < (kTotal + kThreads - 1) / kThreads; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (kTotal % kThreads != 0 && i >= kTotal) break;
    const int r = i / kSegs, col = c0 + (i % kSegs) * kVec;
    const long long row = r0 + r;
    const bool row_ok = row < n_rows;
    const bool whole = col + kVec <= n_cols;
    T* d = dst + r * kStride + (i % kSegs) * kVec;
    if (vec16 && (whole || col >= n_cols) && (ones_col < col || ones_col >= col + kVec)) {
      const bool valid = row_ok && whole;
      cp_async16(d, base + (valid ? row * ld + col : 0), valid);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int c = col + e;
        float v = 0.f;
        if (row_ok) v = c < n_cols ? to_float(base[row * ld + c]) : (c == ones_col ? 1.f : 0.f);
        d[e] = from_float<T>(v);
      }
    }
  }
}

// A ring of kStages stages of kStage elements each, through which the MLP
// kernels stream their slices: load(s, buf) stages slice s (cp.async, one
// commit group a slice), compute(s, buf) consumes it. One barrier a slice:
// at the top of slice s, slice s is in and every warp is done with slice s
// - 1, whose stage the load of slice s + kStages - 1 then takes.
template <int kStages, int kStage, typename T, typename Load, typename Compute>
__device__ __forceinline__ void ring_loop(T* ring, int total, Load load, Compute compute) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load(s, ring + s * kStage);
    cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = s + kStages - 1;
    if (next < total) load(next, ring + (next % kStages) * kStage);
    cp_async_commit();
    compute(s, ring + (s % kStages) * kStage);
  }
}

// acc (a warp's 16 kMI x 8 kNT product tile) += A B over a staged depth
// kDepth: A's rows row0 .. row0 + 16 kMI - 1 from a tile stored m-major
// (load_a) or k-major (kAKMajor, load_a_km), its depth from a_k0; B's
// columns n0 .. n0 + 8 kNT - 1 from a tile stored n-major (load_b_nk) or
// k-major (kBKMajor, load_b_kn_nat). Each B fragment feeds kMI products;
// f32 operands split by truncation (split_tf32<true>). int8 takes A
// m-major and B k-major only, four n-tiles a load (load_b_kn4: the
// columns in acc_col_s8's order).
// No branch in the loop, so loads and products interleave freely: columns
// past the matrix are staged as zeros and cost only their products.
template <typename T, int kMI, int kNT, int kDepth, int kStrideA, int kStrideB, bool kAKMajor,
          bool kBKMajor>
__device__ __forceinline__ void warp_product(const T* __restrict__ a_tile, int row0, int a_k0,
                                             const T* __restrict__ b_tile, int n0,
                                             typename Frag<T>::Acc (&acc)[kMI][kNT][4]) {
  if constexpr (std::is_same_v<T, int8_t>) {
    static_assert(kNT % 4 == 0 && !kAKMajor && kBKMajor, "int8: n-tiles in fours, B k-major");
#pragma unroll
    for (int k = 0; k < kDepth; k += Frag<T>::kK) {
      Frag<int8_t>::A a[kMI];
#pragma unroll
      for (int i = 0; i < kMI; ++i) load_a<kStrideA>(a_tile, row0 + 16 * i, a_k0 + k, a[i]);
#pragma unroll
      for (int j = 0; j < kNT; j += 4) {
        Frag<int8_t>::B b[4];
        load_b_kn4<kStrideB>(b_tile, k, n0 + 8 * j, b);
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) mma(acc[i][j + q], a[i], b[q]);
      }
    }
  } else {
    static_assert(kNT % 2 == 0, "n-tiles in pairs");
#pragma unroll
    for (int k = 0; k < kDepth; k += Frag<T>::kK) {
      typename Frag<T>::A a[kMI];
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        if constexpr (kAKMajor) {
          load_a_km<kStrideA, true>(a_tile, row0 + 16 * i, a_k0 + k, a[i]);
        } else {
          load_a<kStrideA, true>(a_tile, row0 + 16 * i, a_k0 + k, a[i]);
        }
      }
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        typename Frag<T>::B b0, b1;
        if constexpr (kBKMajor) {
          load_b_kn_nat<kStrideB, true>(b_tile, k, n0 + 8 * j, b0, b1);
        } else {
          load_b_nk<kStrideB, true>(b_tile, n0 + 8 * j, k, b0, b1);
        }
#pragma unroll
        for (int i = 0; i < kMI; ++i) {
          mma(acc[i][j], a[i], b0);
          mma(acc[i][j + 1], a[i], b1);
        }
      }
    }
  }
}

// Max and sum over the four lanes of a quad (the threads that share a row).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Column of accumulator element e of n-tile j: 8 j + 2 t + (e & 1).
__device__ __forceinline__ int acc_col(int j, int e) {
  return 8 * j + 2 * (threadIdx.x & 3) + (e & 1);
}

// The softmax runs in base 2: with scale2 = scale * log2(e), exp(s * scale
// - m) = exp2(s * scale2 - m2), and the normalized probability exp2(s *
// scale2 - lse2), lse2 = m2 + log2(l), needs no division: a multiply, a
// subtraction and one MUFU.EX2 a score. P then differs from the plain
// version's exp(s - m) / l by a few f32 ulps, as the tensor cores' sums
// make the scores differ anyway.
constexpr float kLog2e = 1.4426950408889634f;

// 2^x by one MUFU.EX2 (ex2.approx.ftz: about 2 ulps, as exp2f): exp2f adds
// a rescaling for results below 2^-126, a probability whose share of any
// sum here is nil, and flushing those to 0 saves its instructions.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One key chunk's scores s * scale2 (the product rounded on its own), keys
// at or past n_valid set to kNeg (only a chunk that ends past N has any).
template <int kNT>
__device__ __forceinline__ void scale_and_mask(float (&s)[kNT][4], float scale2, int n_valid) {
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(s[j][e], scale2);
  if (n_valid < 8 * kNT) {
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = acc_col(j, e) < n_valid ? s[j][e] : kNeg;
  }
}

// One chunk's step of the rows' running max m2 and sum l of exp2(s - m2)
// (rows g, g + 8), and with dp of the sum dl of exp2(s - m2) dp: l and dl
// are rescaled as m2 grows. Masked keys (kNeg) add 0 once m2 is finite,
// and the first chunk always holds a valid key.
template <int kNT>
__device__ __forceinline__ void online_max_sum(const float (&s)[kNT][4], float (&m)[2],
                                               float (&l)[2], const float (*dp)[4] = nullptr,
                                               float* dl = nullptr) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNeg;
#pragma unroll
    for (int j = 0; j < kNT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    const float m_new = fmaxf(m[r], quad_max(mx));
    const float alpha = exp2_approx(m[r] - m_new);
    float sum = 0.f, dsum = 0.f;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int c = 2 * r; c < 2 * r + 2; ++c) {
        const float e = exp2_approx(s[j][c] - m_new);
        sum += e;
        if (dp != nullptr) dsum += e * dp[j][c];
      }
    l[r] = l[r] * alpha + quad_sum(sum);
    if (dp != nullptr) dl[r] = dl[r] * alpha + quad_sum(dsum);
    m[r] = m_new;
  }
}

// A row's lse2 = m2 + log2(l) once the sweep over its keys is done.
__device__ __forceinline__ float lse2(float m, float l) { return m + log2f(fmaxf(l, 1e-30f)); }

// exp2(s * scale2 - lse2) with the product rounded on its own, as the max
// m2 was taken (no FMA): the largest score of a row with l = 1 gives P = 1
// exactly, as the plain version's exp(0) / 1 does, and a query alone in
// its softmax (N = 1) gets dS = 0 exactly.
__device__ __forceinline__ float exp2_prob(float s, float scale2, float lse) {
  return exp2_approx(__fsub_rn(__fmul_rn(s, scale2), lse));
}

}  // namespace vit
