// ViT MLP for Hopper (sm_90a): the fused MLP forward (K9) and the bf16 MLP
// half-block (K11), one kernel for both.
//
// K9 replaces nwhead_tpu/ops/pallas_mlp.py:_mlp_kernel (forward):
//   out = gelu(x W1 + b1) W2 + b2, x (M, D_in), W1 (D_in, D_h), W2 (D_h,
//   D_out) in x's dtype (f32 or bf16), biases f32, the exact GELU in f32,
//   its output rounded to x's dtype before fc2, out in x's dtype.
// K11 replaces pallas_mlp.py:_mlp_int8_kernel with quant=False (the launch
// of fused_mlp_block_bf16): the same in bf16 with an optional LayerNorm
// before fc1 (f32 statistics, output rounded to bf16) and an optional
// LayerScale (rounded to bf16) and residual add (rounded to bf16) after
// fc2's bias (rounded to bf16).
//
// The hidden (M, D_h) activation never leaves the chip, as on the TPU. A
// block owns TM = 8 kRows tokens and all of D_out: each warp owns kRows
// rows, each lane columns 4 lane + 128 j (j < kGroups), so the fc2
// accumulator (TM x D_out, f32) lives in registers, kRows x 4 kGroups per
// thread (96 at ViT-S/14: TM = 64, D_out = 384). The x tile sits in shared
// memory, transposed, with the LayerNorm applied once as it loads. Then for
// each chunk of 128 hidden units: fc1 over K slices of 16 (W1 slice staged
// in shared memory), bias + GELU + rounding into a transposed hidden chunk
// in shared memory, and fc2 of that chunk into the accumulator over slices
// of 16 rows of W2. All products are f32 FMAs on widened values.
// What bounds it at ViT-S/14 serving (M = 64 x 257 = 16,448 tokens, D =
// 384, D_h = 1,536): 4 M D D_h = 38.8 GFLOP, 0.58 ms at the 67 TFLOP/s f32
// rate and 39 us at the 989 TFLOP/s bf16 tensor-core rate, which this
// first FFMA version cannot reach; wgmma and TMA are later work.

#include "vit_common.cuh"

namespace vit {

constexpr int kHidden = 128;  // hidden units per chunk
constexpr int kSlice = 16;    // K rows per staged weight slice

template <int kRows, int kGroups>
size_t mlp_smem_bytes(int d_in) {
  constexpr int kStride = kWarps * kRows + 4;
  return sizeof(float) * (static_cast<size_t>(round_up(d_in, kSlice)) * kStride  // x^T
                          + kSlice * kHidden                                    // W1 slice
                          + kHidden * kStride                                   // hidden^T
                          + kSlice * kHidden * kGroups);                        // W2 slice
}

// grid (ceil(M / TM)), 256 threads. ln_g == nullptr: no LayerNorm; ls may
// be null; residual needs d_out == d_in.
template <typename T, int kRows, int kGroups>
__global__ void __launch_bounds__(kThreads, 1)
mlp_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
           const float* __restrict__ ln_b, float eps, const T* __restrict__ w1,
           const float* __restrict__ b1, const T* __restrict__ w2, const float* __restrict__ b2,
           const T* __restrict__ ls, int residual, T* __restrict__ out, int M, int d_in,
           int d_h, int d_out) {
  constexpr int kTm = kWarps * kRows;
  constexpr int kStride = kTm + 4;
  constexpr int kOutCols = kHidden * kGroups;
  const int d_in_pad = round_up(d_in, kSlice);
  extern __shared__ float4 smem4[];
  float* xt = reinterpret_cast<float*>(smem4);
  float* w1s = xt + static_cast<size_t>(d_in_pad) * kStride;
  float* ht = w1s + kSlice * kHidden;
  float* w2s = ht + kHidden * kStride;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * kTm;
  const int r0 = warp * kRows;  // this warp's rows in the tile

  for (int rr = 0; rr < kRows; ++rr) {
    const int r = r0 + rr;
    const bool valid = m0 + r < M;
    const T* row = x + static_cast<size_t>(m0 + r) * d_in;
    float mean = 0.f, rstd = 1.f;
    if (ln_g != nullptr && valid) row_stats(row, d_in, eps, mean, rstd);
    for (int k = lane; k < d_in_pad; k += 32) {
      float v = 0.f;
      if (valid && k < d_in) {
        v = to_float(row[k]);
        if (ln_g != nullptr) v = round_to<T>((v - mean) * rstd * ln_g[k] + ln_b[k]);
      }
      xt[k * kStride + r] = v;
    }
  }

  float acc[kRows][4 * kGroups];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kGroups; ++c) acc[i][c] = 0.f;

  for (int h0 = 0; h0 < d_h; h0 += kHidden) {
    float hacc[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) hacc[i][c] = 0.f;
    for (int k0 = 0; k0 < d_in; k0 += kSlice) {
      __syncthreads();  // the previous W1 slice (and hidden chunk) is consumed
#pragma unroll
      for (int u = 0; u < kSlice * kHidden / kThreads; ++u) {
        const int idx = tid + u * kThreads;
        const int kk = idx / kHidden, c = idx % kHidden;
        const int k = k0 + kk, hc = h0 + c;
        w1s[idx] = k < d_in && hc < d_h ? to_float(w1[static_cast<size_t>(k) * d_h + hc]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kSlice; ++kk) {
        float a[kRows];
        load_vec<kRows>(xt + (k0 + kk) * kStride + r0, a);
        fma_tile<kRows, 1>(a, w1s + kk * kHidden + 4 * lane, hacc);
      }
    }
    // Every thread passed a barrier after the last fc2 read of ht.
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int hc = h0 + 4 * lane + c;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        ht[(4 * lane + c) * kStride + r0 + i] =
            hc < d_h ? round_to<T>(gelu_exact(hacc[i][c] + b1[hc])) : 0.f;
      }
    }
    for (int k0 = 0; k0 < kHidden && h0 + k0 < d_h; k0 += kSlice) {
      __syncthreads();  // the hidden chunk is written; the previous W2 slice consumed
      for (int idx = tid; idx < kSlice * kOutCols; idx += kThreads) {
        const int kk = idx / kOutCols, c = idx % kOutCols;
        const int hr = h0 + k0 + kk;
        w2s[idx] = hr < d_h && c < d_out ? to_float(w2[static_cast<size_t>(hr) * d_out + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kSlice; ++kk) {
        float a[kRows];
        load_vec<kRows>(ht + (k0 + kk) * kStride + r0, a);
        fma_tile<kRows, kGroups>(a, w2s + kk * kOutCols + 4 * lane, acc);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = m0 + r0 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 4 * lane + kHidden * j + c;
        if (col >= d_out) continue;
        float v = round_to<T>(acc[i][4 * j + c] + b2[col]);
        if (ls != nullptr) v = round_to<T>(v * to_float(ls[col]));
        if (residual) v = round_to<T>(to_float(x[static_cast<size_t>(row) * d_in + col]) + v);
        out[static_cast<size_t>(row) * d_out + col] = from_float<T>(v);
      }
    }
  }
}

template <typename T, int kRows, int kGroups>
cudaError_t launch_mlp(cudaStream_t stream, const void* x, const void* ln_g, const void* ln_b,
                       float eps, const void* w1, const void* b1, const void* w2, const void* b2,
                       const void* ls, int residual, void* out, int M, int d_in, int d_h,
                       int d_out) {
  const size_t smem = mlp_smem_bytes<kRows, kGroups>(d_in);
  if (smem > smem_optin()) return cudaErrorInvalidConfiguration;
  const cudaError_t err = allow_smem(mlp_kernel<T, kRows, kGroups>, smem);
  if (err != cudaSuccess) return err;
  const int grid = (M + kWarps * kRows - 1) / (kWarps * kRows);
  mlp_kernel<T, kRows, kGroups><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
      eps, static_cast<const T*>(w1), static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<const T*>(ls), residual, static_cast<T*>(out),
      M, d_in, d_h, d_out);
  return cudaGetLastError();
}

// The tile shape for an output width: TM = 64 tokens up to D_out = 384,
// 32 up to 768, 16 up to 1,024, so the accumulator stays at most 128
// registers a thread.
template <typename T>
cudaError_t mlp(cudaStream_t stream, const void* x, const void* ln_g, const void* ln_b, float eps,
                const void* w1, const void* b1, const void* w2, const void* b2, const void* ls,
                int residual, void* out, int M, int d_in, int d_h, int d_out) {
  const int groups = (d_out + kHidden - 1) / kHidden;
#define VIT_MLP(R, G) \
  launch_mlp<T, R, G>(stream, x, ln_g, ln_b, eps, w1, b1, w2, b2, ls, residual, out, M, d_in, d_h, d_out)
  if (groups <= 1) return VIT_MLP(8, 1);
  if (groups <= 2) return VIT_MLP(8, 2);
  if (groups <= 3) return VIT_MLP(8, 3);
  if (groups <= 6) return VIT_MLP(4, 6);
  if (groups <= 8) return VIT_MLP(2, 8);
#undef VIT_MLP
  return cudaErrorInvalidValue;
}

}  // namespace vit

extern "C" {

const char* vit_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Largest output width the kernel takes.
int vit_mlp_max_out() { return 8 * vit::kHidden; }

// K9 (ln_g, ln_b, ls null, residual 0) and K11 (bf16, any of the folds):
// x (M, d_in), w1 (d_in, d_h), w2 (d_h, d_out) and out (M, d_out) in f32 or
// bf16 (bf16 != 0); b1, b2, ln_g, ln_b f32; ls (d_out,) in x's dtype.
// Launches on `stream`, does not synchronize, returns cudaGetLastError().
int vit_mlp_forward(const void* x, const void* ln_g, const void* ln_b, float eps, const void* w1,
                    const void* b1, const void* w2, const void* b2, const void* ls, int residual,
                    void* out, int M, int d_in, int d_h, int d_out, int bf16, void* stream) {
  if (M <= 0 || d_in <= 0 || d_h <= 0 || d_out <= 0 || (residual && d_in != d_out) ||
      (ln_g == nullptr) != (ln_b == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? vit::mlp<__nv_bfloat16>(st, x, ln_g, ln_b, eps, w1, b1, w2, b2, ls, residual, out,
                                     M, d_in, d_h, d_out)
           : vit::mlp<float>(st, x, ln_g, ln_b, eps, w1, b1, w2, b2, ls, residual, out, M, d_in,
                             d_h, d_out));
}

}  // extern "C"
