// The ViT half-blocks' shared pieces (K10 and K10 int8 in vit_attn.cu, K11
// and K11 int8 in vit_mlp.cu): the prologue that writes x's LayerNorm or
// int8 codes once per row, the folds after the last product, and the
// epilogue that applies them to a warp's mma.sync accumulators.
//
// The int8 kernels' bit-equality with their plain versions rests on these
// expressions: the codes clip(rint(x * (1/a)), -127, 127) of x or of its
// LayerNorm (row_stats_f64's statistics, rounded to bf16), and the
// dequantized sum acc * (a * s) + b with two roundings and no FMA.

#pragma once

#include <type_traits>

#include "vit_mma.cuh"

namespace vit {

// The half-blocks' folds after the last product, and the int8 scales.
struct Folds {
  const __nv_bfloat16* res;  // residual: the un-normalized x (M, d_out), or null
  const __nv_bfloat16* ls;   // LayerScale (d_out,), or null
  const float* s1;           // K11 int8: W1's per-column scales (d_h,)
  const float* s2;           // int8: the last product's per-column scales (d_out,)
  float a1, inv_a2, a2;      // K11 int8: fc1's input scale, the hidden codes' 1 / scale; a2 the
                             // last product's input scale
};

// The half-block's tail on one output value (f32, before any rounding):
// rounded to bf16, [times ls, rounded], [plus x, rounded].
__device__ __forceinline__ float block_tail(float v, const Folds& f, size_t at, int col) {
  v = round_to<__nv_bfloat16>(v);
  if (f.ls != nullptr) v = round_to<__nv_bfloat16>(v * to_float(f.ls[col]));
  if (f.res != nullptr) v = round_to<__nv_bfloat16>(to_float(f.res[at]) + v);
  return v;
}

// A warp's product tile out: acc[i][n] holds rows row0 + 16 i + g and + 8
// and, from column col0, columns 8 n + 2t, + 1 (int8: acc_col_s8's
// order, n-tiles n and n + 1 neighbours). Two neighbouring columns a call:
// the bias (int8: the sum dequantized first, with f.a2 and f.s2), [the
// half-block's tail], the store; rows past M and columns past d_out are
// left alone.
template <bool kBlock, typename Acc, int kMI, int kNT, typename OutT>
__device__ __forceinline__ void store_tile(const Acc (&acc)[kMI][kNT][4], int row0, int col0,
                                           int M, int d_out, const float* __restrict__ bias,
                                           const Folds& f, OutT* __restrict__ out) {
  constexpr bool kInt8 = std::is_same_v<Acc, int>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool pairs = d_out % 2 == 0;
#pragma unroll
  for (int q = 0; q < 2 * kMI; ++q) {
    const int i = q >> 1, r = q & 1;
    const int row = row0 + 16 * i + g + 8 * r;
    if (row >= M) continue;
    const size_t at = static_cast<size_t>(row) * d_out;
    OutT* dst = out + at;
    auto emit = [&](int col, Acc a0, Acc a1) {
      if (col >= d_out) return;
      const bool second = col + 1 < d_out;
      float v0, v1;
      if constexpr (kInt8) {
        v0 = __fadd_rn(__fmul_rn(__int2float_rn(a0), __fmul_rn(f.a2, f.s2[col])), bias[col]);
        v1 = second ? __fadd_rn(__fmul_rn(__int2float_rn(a1), __fmul_rn(f.a2, f.s2[col + 1])),
                                bias[col + 1])
                    : 0.f;
      } else {
        v0 = a0 + bias[col];
        v1 = a1 + (second ? bias[col + 1] : 0.f);
      }
      if constexpr (kBlock) {
        v0 = block_tail(v0, f, at + col, col);
        if (second) v1 = block_tail(v1, f, at + col + 1, col + 1);
      }
      if (pairs) {
        store2(dst + col, v0, v1);
      } else {
        dst[col] = from_float<OutT>(v0);
        if (second) dst[col + 1] = from_float<OutT>(v1);
      }
    };
    if constexpr (kInt8) {  // n-tiles n and n + 1 hold neighbouring columns
#pragma unroll
      for (int n = 0; n < kNT; n += 2)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          emit(col0 + acc_col_s8(n, p), acc[i][n][2 * r + p], acc[i][n + 1][2 * r + p]);
    } else {
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        emit(col0 + 8 * n + 2 * t, acc[i][n][2 * r], acc[i][n][2 * r + 1]);
    }
  }
}

// The half-blocks' prologue, one warp a row of x (M, d_in) bf16. bf16: LN(x)
// with row_stats' f32 statistics, rounded to bf16. int8 (d_in a multiple
// of 4): x's codes, quantize_i8 by 1/a of x or of ln_bf16 with
// row_stats_f64's statistics, four a 32-bit word.
template <bool kInt8>
__global__ void __launch_bounds__(kThreads)
block_prologue_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ ln_g,
                      const float* __restrict__ ln_b, float eps, float inv_a1,
                      std::conditional_t<kInt8, int8_t, __nv_bfloat16>* __restrict__ dst, int M,
                      int d_in) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= M) return;  // a whole warp
  const __nv_bfloat16* src = x + static_cast<size_t>(row) * d_in;
  float mean = 0.f, rstd = 1.f;
  if constexpr (kInt8) {
    if (ln_g != nullptr) row_stats_f64(src, d_in, eps, mean, rstd);
    int* codes = reinterpret_cast<int*>(dst + static_cast<size_t>(row) * d_in);
    for (int kw = lane; kw < d_in / 4; kw += 32) {
      int c[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * kw + e;
        float v = to_float(src[k]);
        if (ln_g != nullptr) v = ln_bf16(v, mean, rstd, ln_g[k], ln_b[k]);
        c[e] = quantize_i8(v, inv_a1);
      }
      codes[kw] = pack4(c[0], c[1], c[2], c[3]);
    }
  } else {
    row_stats(src, d_in, eps, mean, rstd);
    __nv_bfloat16* xn = dst + static_cast<size_t>(row) * d_in;
    for (int k = lane; k < d_in; k += 32) {
      xn[k] = from_float<__nv_bfloat16>((to_float(src[k]) - mean) * rstd * ln_g[k] + ln_b[k]);
    }
  }
}

template <bool kInt8>
cudaError_t prologue(cudaStream_t stream, const void* x, const void* ln_g, const void* ln_b,
                     float eps, float inv_a1, void* dst, int M, int d_in) {
  block_prologue_kernel<kInt8><<<(M + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), eps, inv_a1,
      static_cast<std::conditional_t<kInt8, int8_t, __nv_bfloat16>*>(dst), M, d_in);
  return cudaGetLastError();
}

}  // namespace vit
