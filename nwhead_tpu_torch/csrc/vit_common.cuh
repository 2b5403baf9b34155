// Device code shared by the ViT kernels (vit_attn.cu, vit_attn_bwd.cu,
// vit_mlp.cu, vit_mlp_bwd.cu): dtype conversion and rounding, warp
// reductions, the LayerNorm statistics of a row, the exact GELU, the
// register-tiled FFMA product step of the MLP kernels and of K10's
// projections, and the int8 kernels' activation codes.
//
// fma_tile's products are f32 FMAs on values widened from the inputs'
// dtype (f32 or bf16): a bf16 x bf16 product is exact in f32, so those
// paths differ from the plain PyTorch versions (bf16 values, f32 products
// and sums) only in the order of the f32 sums, and they run at the card's
// 67 TFLOP/s f32 rate, not on its tensor cores. The attention kernels (K7,
// K8) take the tensor cores through vit_mma.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>
#include <cstdint>

namespace vit {

constexpr int kThreads = 256;  // every ViT kernel runs 8 warps
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -FLT_MAX;  // jnp.finfo(float32).min, the JAX kernels' "-inf"

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and widened back: the rounding points of the JAX kernels
// (a value cast to the working dtype before the next product).
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Mean and 1/sqrt(var + eps) of one row of n values, by one warp, in f32:
// the biased variance of the JAX LayerNorms, mean((x - mean)^2). Every
// lane returns both.
template <typename T>
__device__ __forceinline__ void row_stats(const T* __restrict__ row, int n, float eps,
                                          float& mean, float& rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int k = lane; k < n; k += 32) s += to_float(row[k]);
  mean = warp_sum(s) / static_cast<float>(n);
  float v = 0.f;
  for (int k = lane; k < n; k += 32) {
    const float d = to_float(row[k]) - mean;
    v = fmaf(d, d, v);
  }
  rstd = 1.f / sqrtf(warp_sum(v) / static_cast<float>(n) + eps);
}

// The LayerNorm statistics of the int8 kernels (K10 int8, K11 int8), where
// one bf16 rounding of a normalized value that flips moves an activation
// code, and a moved code changes a whole token downstream. The sums run in
// f64 (the sum of a row of bf16 values is exact there), and mean and 1 /
// sqrt(var + eps) are each rounded once to f32, so the plain version, which
// computes them the same way, gets the same f32 values whatever the order
// of its sums.
template <typename T>
__device__ __forceinline__ void row_stats_f64(const T* __restrict__ row, int n, float eps,
                                              float& mean, float& rstd) {
  const int lane = threadIdx.x & 31;
  double s = 0.0;
  for (int k = lane; k < n; k += 32) s += static_cast<double>(to_float(row[k]));
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  mean = static_cast<float>(s / n);
  double v = 0.0;
  for (int k = lane; k < n; k += 32) {
    const double d = __fsub_rn(to_float(row[k]), mean);
    v = fma(d, d, v);
  }
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  rstd = static_cast<float>(1.0 / sqrt(v / n + static_cast<double>(eps)));
}

// One normalized value of the int8 kernels, rounded to bf16: ((x - mean) *
// rstd) * g + b with every operation rounded (no FMA), as PyTorch computes
// the plain version's expression.
__device__ __forceinline__ float ln_bf16(float x, float mean, float rstd, float g, float b) {
  return round_to<__nv_bfloat16>(
      __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), rstd), g), b));
}

// Exact (erf) GELU in f32, CUDA's erff (the JAX kernels use an
// approximation of erf with an absolute error of 1.5e-7).
__device__ __forceinline__ float gelu_exact(float h) {
  return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
}

// An activation code as the JAX int8 kernels compute it (int8 modes of K10
// and K11): x times the reciprocal of its scale, rounded half to even
// (rintf, as jnp.round; not roundf), clipped to [-127, 127].
__device__ __forceinline__ int quantize_i8(float x, float inv_a) {
  return static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(x, inv_a)), -127.f), 127.f));
}

// Four int8 codes in one 32-bit word, the first in the low byte.
__device__ __forceinline__ int pack4(int c0, int c1, int c2, int c3) {
  return static_cast<int>((c0 & 0xFF) | ((c1 & 0xFF) << 8) | ((c2 & 0xFF) << 16) |
                          (static_cast<unsigned>(c3 & 0xFF) << 24));
}

// The exact GELU of the TPU int8 MLP kernel (pallas_mlp.py:_erf, used by
// K11 int8): erf by Abramowitz & Stegun 7.1.26, absolute error 1.5e-7, in
// the TPU kernel's order of operations, each rounded (no FMA) as the plain
// version's are: its output is rounded to an activation code.
__device__ __forceinline__ float gelu_as(float h) {
  const float x = __fmul_rn(h, 0.70710678118654752f);
  const float ax = fabsf(x);
  const float t = __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(0.3275911f, ax)));
  float poly = __fadd_rn(-1.453152027f, __fmul_rn(t, 1.061405429f));
  poly = __fadd_rn(1.421413741f, __fmul_rn(t, poly));
  poly = __fadd_rn(-0.284496736f, __fmul_rn(t, poly));
  poly = __fmul_rn(t, __fadd_rn(0.254829592f, __fmul_rn(t, poly)));
  const float sign = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float erf = __fmul_rn(sign, __fsub_rn(1.f, __fmul_rn(poly, expf(-__fmul_rn(ax, ax)))));
  return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.f, erf));
}

// kRows consecutive floats from shared memory (16-byte aligned for
// kRows % 4 == 0, 8-byte for kRows == 2).
template <int kRows>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float (&a)[kRows]) {
  if constexpr (kRows % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kRows; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      a[i] = v.x;
      a[i + 1] = v.y;
      a[i + 2] = v.z;
      a[i + 3] = v.w;
    }
  } else {
    static_assert(kRows == 2, "rows per thread: 2 or a multiple of 4");
    const float2 v = *reinterpret_cast<const float2*>(p);
    a[0] = v.x;
    a[1] = v.y;
  }
}

// One product step of a register tile: acc[i][4 j + c] += a[i] * b_j[c],
// where a holds kRows rows of the left factor at one k and the kGroups
// float4s at b + 128 j hold the right factor's columns 4 lane + 128 j .. +3.
template <int kRows, int kGroups>
__device__ __forceinline__ void fma_tile(const float (&a)[kRows], const float* __restrict__ b,
                                         float (&acc)[kRows][4 * kGroups]) {
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(b + 128 * j);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      acc[i][4 * j] = fmaf(a[i], v.x, acc[i][4 * j]);
      acc[i][4 * j + 1] = fmaf(a[i], v.y, acc[i][4 * j + 1]);
      acc[i][4 * j + 2] = fmaf(a[i], v.z, acc[i][4 * j + 2]);
      acc[i][4 * j + 3] = fmaf(a[i], v.w, acc[i][4 * j + 3]);
    }
  }
}

// Set the dynamic shared memory a kernel needs above the 48 KB default.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The device's opt-in shared memory per block, or 0.
inline size_t smem_optin() {
  int device = 0, optin = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess) {
    return 0;
  }
  return static_cast<size_t>(optin);
}

}  // namespace vit
