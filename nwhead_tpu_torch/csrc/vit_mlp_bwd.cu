// ViT MLP backward for Hopper (sm_90a): the K9 backward, the VJP of
// out = gelu(x W1 + b1) W2 + b2.
//
// Replaces nwhead_tpu/ops/pallas_mlp.py:_mlp_bwd_kernel. From x (M, D_in),
// W1 (D_in, D_h), b1, W2 (D_h, D_out) and dO (M, D_out) in x's dtype (f32
// or bf16; biases f32), with the TPU kernel's rounding points:
//   h = x W1 + b1 (f32), cdf = (1 + erf(h / sqrt 2)) / 2, g = round(h cdf)
//   dg = dO W2^T (f32), dh = round(dg (cdf + h phi(h)))
//   dx = dh W1^T, dW1 = x^T dh, db1 = sum dh, dW2 = g^T dO, db2 = sum dO
// (round = to x's dtype; sums in f32; dW in x's dtype, db in f32).
// The TPU kernel walks token tiles in order on one core and carries the
// weight gradients in VMEM from tile to tile. Blocks here run in parallel,
// so the work is split where it changes owner:
//   1. mlp_bwd_token_kernel: a block owns TM = 8 kRows tokens and all of
//      D_in (dx). x and dO tiles sit in shared memory, transposed; for each
//      chunk of 128 hidden units it recomputes h (W1 slices staged in
//      shared memory), forms dg (W2 slices), g and dh, writes g and dh
//      (x's dtype, one (M, D_h) scratch tensor each) and adds dh W1^T of
//      the chunk into the dx accumulator in registers. TM is 32 up to
//      D = 384 and 16 beyond, so both tiles fit in shared memory.
//   2. wgrad_kernel: dW1 = x^T dh and dW2 = g^T dO, each with the bias
//      gradient as one more row (a column of ones beside x or g). A block
//      owns a 64 x 128 tile of one product for one of `splits` consecutive
//      token ranges and sums over it in token order.
//   3. wgrad_finalize_kernel: each gradient element adds its splits'
//      partials in split order and is written once. No float atomics: the
//      gradient is the same on every run.
// What bounds it at ViT-S/14 (M = 16,448 tokens, D = 384, D_h = 1,536): the
// five products (h, dg, dx, dW1, dW2), 10 M D D_h = 97.0 GFLOP, 1.45 ms at
// the 67 TFLOP/s f32 rate and 98 us at 989 TFLOP/s bf16; this first
// version runs all of them on FFMA and writes g and dh through device
// memory (2 M D_h values); wgmma and TMA are later work.

#include "vit_common.cuh"

namespace vit {

constexpr int kHidden = 128;  // hidden units per chunk
constexpr int kSlice = 8;     // rows per staged weight slice
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

template <int kRows, int kGroups>
size_t token_smem_bytes(int d_in, int d_out) {
  constexpr int kStride = kWarps * kRows + 4;
  return sizeof(float) * ((static_cast<size_t>(round_up(d_in, kSlice)) + round_up(d_out, kSlice) +
                           kHidden) * kStride +
                          static_cast<size_t>(kSlice) * kHidden * kGroups);
}

// grid (ceil(M / TM)), 256 threads; 128 kGroups >= d_in.
template <typename T, int kRows, int kGroups>
__global__ void __launch_bounds__(kThreads, 1)
mlp_bwd_token_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                     const float* __restrict__ b1, const T* __restrict__ w2,
                     const T* __restrict__ dout, T* __restrict__ dx, T* __restrict__ g_out,
                     T* __restrict__ dh_out, int M, int d_in, int d_h, int d_out) {
  constexpr int kTm = kWarps * kRows;
  constexpr int kStride = kTm + 4;
  constexpr int kDxCols = kHidden * kGroups;
  const int d_in_pad = round_up(d_in, kSlice);
  const int d_out_pad = round_up(d_out, kSlice);
  extern __shared__ float4 smem4[];
  float* xt = reinterpret_cast<float*>(smem4);                // x^T   (d_in_pad x TM)
  float* dot = xt + static_cast<size_t>(d_in_pad) * kStride;   // dO^T  (d_out_pad x TM)
  float* ht = dot + static_cast<size_t>(d_out_pad) * kStride;  // h, then dh (128 x TM)
  float* ws = ht + kHidden * kStride;                          // weight slice

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * kTm;
  const int r0 = warp * kRows;  // this warp's rows in the tile; it alone writes and reads them

  for (int rr = 0; rr < kRows; ++rr) {
    const int r = r0 + rr;
    const bool valid = m0 + r < M;
    const size_t row = static_cast<size_t>(m0 + r);
    for (int k = lane; k < d_in_pad; k += 32) {
      xt[k * kStride + r] = valid && k < d_in ? to_float(x[row * d_in + k]) : 0.f;
    }
    for (int k = lane; k < d_out_pad; k += 32) {
      dot[k * kStride + r] = valid && k < d_out ? to_float(dout[row * d_out + k]) : 0.f;
    }
  }

  float acc[kRows][4 * kGroups];  // dx: rows r0 + i, columns 4 lane + 128 j + c
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kGroups; ++c) acc[i][c] = 0.f;

  for (int h0 = 0; h0 < d_h; h0 += kHidden) {
    // h = x W1[:, h0 .. h0 + 127]: rows r0 + i, hidden units h0 + 4 lane + c.
    float hacc[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) hacc[i][c] = 0.f;
    for (int k0 = 0; k0 < d_in; k0 += kSlice) {
      __syncthreads();  // the previous slice is consumed
#pragma unroll
      for (int u = 0; u < kSlice * kHidden / kThreads; ++u) {
        const int idx = tid + u * kThreads;
        const int kk = idx / kHidden, c = idx % kHidden;
        const int k = k0 + kk, hc = h0 + c;
        ws[idx] = k < d_in && hc < d_h ? to_float(w1[static_cast<size_t>(k) * d_h + hc]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kSlice; ++kk) {
        float a[kRows];
        load_vec<kRows>(xt + (k0 + kk) * kStride + r0, a);
        fma_tile<kRows, 1>(a, ws + kk * kHidden + 4 * lane, hacc);
      }
    }
    // Each thread parks its h in its own slots of ht.
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int hc = h0 + 4 * lane + c;
      const float bias = hc < d_h ? b1[hc] : 0.f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) ht[(4 * lane + c) * kStride + r0 + i] = hacc[i][c] + bias;
    }
    // dg = dO W2[h0 .., :]^T, the same slots.
    float dg[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) dg[i][c] = 0.f;
    for (int k0 = 0; k0 < d_out; k0 += kSlice) {
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kSlice * kHidden / kThreads; ++u) {
        const int idx = tid + u * kThreads;
        const int c = idx / kSlice, kk = idx % kSlice;  // neighbours read along a W2 row
        const int hc = h0 + c, k = k0 + kk;
        ws[kk * kHidden + c] =
            hc < d_h && k < d_out ? to_float(w2[static_cast<size_t>(hc) * d_out + k]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kSlice; ++kk) {
        float a[kRows];
        load_vec<kRows>(dot + (k0 + kk) * kStride + r0, a);
        fma_tile<kRows, 1>(a, ws + kk * kHidden + 4 * lane, dg);
      }
    }
    // g and dh; dh replaces h in ht for the dx product.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = m0 + r0 + i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 4 * lane + c, hc = h0 + col;
        float* slot = ht + col * kStride + r0 + i;
        const float h = *slot;
        const float cdf = 0.5f * (1.f + erff(h * 0.70710678118654752f));
        const float dh =
            hc < d_h ? round_to<T>(dg[i][c] * (cdf + h * (expf(-0.5f * h * h) * kInvSqrt2Pi)))
                     : 0.f;
        *slot = dh;
        if (row < M && hc < d_h) {
          const size_t at = static_cast<size_t>(row) * d_h + hc;
          g_out[at] = from_float<T>(h * cdf);
          dh_out[at] = from_float<T>(dh);
        }
      }
    }
    // dx += dh W1[:, h0 ..]^T over slices of kSlice hidden units.
    for (int k0 = 0; k0 < kHidden && h0 + k0 < d_h; k0 += kSlice) {
      __syncthreads();  // dh is in ht; the previous slice is consumed
      for (int idx = tid; idx < kSlice * kDxCols; idx += kThreads) {
        const int c = idx / kSlice, kk = idx % kSlice;  // neighbours read along a W1 row
        const int hc = h0 + k0 + kk;
        ws[kk * kDxCols + c] =
            c < d_in && hc < d_h ? to_float(w1[static_cast<size_t>(c) * d_h + hc]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kSlice; ++kk) {
        float a[kRows];
        load_vec<kRows>(ht + (k0 + kk) * kStride + r0, a);
        fma_tile<kRows, kGroups>(a, ws + kk * kDxCols + 4 * lane, acc);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = m0 + r0 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < kGroups; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 4 * lane + kHidden * j + c;
        if (col < d_in) dx[static_cast<size_t>(row) * d_in + col] = from_float<T>(acc[i][4 * j + c]);
      }
  }
}

constexpr int kWgRows = 64;
constexpr int kWgCols = 128;
constexpr int kWgK = 16;
constexpr int kWgStride = kWgRows + 4;

// partial[s] ((R + 1) x n) = [A | 1]^T B over tokens [s rows, (s + 1) rows)
// of split s = blockIdx.z: A (M, R), B (M, n); row R is the column sums of
// B. grid (ceil((R + 1) / 64), ceil(n / 128), splits); each thread 8 rows x
// 4 columns of the block's 64 x 128 tile, token slices of 16 staged in
// shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const T* __restrict__ A, const T* __restrict__ B, float* __restrict__ partial,
             int M, int R, int n, int rows) {
  __shared__ __align__(16) float as[kWgK * kWgStride];
  __shared__ __align__(16) float bs[kWgK * kWgCols];
  constexpr int kRows = kWgRows / kWarps;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = blockIdx.x * kWgRows, c0 = blockIdx.y * kWgCols;
  const int m_begin = blockIdx.z * rows;
  const int m_end = min(M, m_begin + rows);
  float acc[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int m0 = m_begin; m0 < m_end; m0 += kWgK) {
    __syncthreads();  // the previous slice is consumed
#pragma unroll
    for (int u = 0; u < kWgK * kWgRows / kThreads; ++u) {
      const int idx = tid + u * kThreads;
      const int mm = idx / kWgRows, r = idx % kWgRows;
      const int m = m0 + mm, row = r0 + r;
      float a = 0.f;
      if (m < m_end) a = row < R ? to_float(A[static_cast<size_t>(m) * R + row]) : (row == R ? 1.f : 0.f);
      as[mm * kWgStride + r] = a;
    }
#pragma unroll
    for (int u = 0; u < kWgK * kWgCols / kThreads; ++u) {
      const int idx = tid + u * kThreads;
      const int mm = idx / kWgCols, c = idx % kWgCols;
      const int m = m0 + mm, col = c0 + c;
      bs[idx] = m < m_end && col < n ? to_float(B[static_cast<size_t>(m) * n + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < kWgK; ++mm) {
      float a[kRows];
      load_vec<kRows>(as + mm * kWgStride + warp * kRows, a);
      fma_tile<kRows, 1>(a, bs + mm * kWgCols + 4 * lane, acc);
    }
  }
  float* out = partial + static_cast<size_t>(blockIdx.z) * (R + 1) * n;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = r0 + warp * kRows + i;
    if (row > R) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = c0 + 4 * lane + c;
      if (col < n) out[static_cast<size_t>(row) * n + col] = acc[i][c];
    }
  }
}

// dw (R x n, T) and db (n, f32) = the sum of the splits' partials, in split
// order.
template <typename T>
__global__ void wgrad_finalize_kernel(const float* __restrict__ partial, int splits, int R, int n,
                                      T* __restrict__ dw, float* __restrict__ db) {
  const size_t total = static_cast<size_t>(R + 1) * n;
  const size_t weights = static_cast<size_t>(R) * n;
  for (size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; idx < total;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += partial[s * total + idx];
    if (idx < weights) {
      dw[idx] = from_float<T>(v);
    } else {
      db[idx - weights] = v;
    }
  }
}

template <typename T>
cudaError_t wgrad(cudaStream_t stream, const T* A, const T* B, float* partial, T* dw, float* db,
                  int M, int R, int n, int splits) {
  const int rows = (M + splits - 1) / splits;
  const dim3 grid((R + 1 + kWgRows - 1) / kWgRows, (n + kWgCols - 1) / kWgCols, splits);
  wgrad_kernel<T><<<grid, kThreads, 0, stream>>>(A, B, partial, M, R, n, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(R + 1) * n;
  const size_t needed = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(needed < 4096 ? needed : 4096);
  wgrad_finalize_kernel<T><<<blocks, kThreads, 0, stream>>>(partial, splits, R, n, dw, db);
  return cudaGetLastError();
}

template <typename T, int kRows, int kGroups>
cudaError_t launch_token(cudaStream_t stream, const T* x, const T* w1, const float* b1, const T* w2,
                         const T* dout, T* dx, T* g, T* dh, int M, int d_in, int d_h, int d_out) {
  const size_t smem = token_smem_bytes<kRows, kGroups>(d_in, d_out);
  if (smem > smem_optin()) return cudaErrorInvalidConfiguration;
  const cudaError_t err = allow_smem(mlp_bwd_token_kernel<T, kRows, kGroups>, smem);
  if (err != cudaSuccess) return err;
  const int grid = (M + kWarps * kRows - 1) / (kWarps * kRows);
  mlp_bwd_token_kernel<T, kRows, kGroups><<<grid, kThreads, smem, stream>>>(
      x, w1, b1, w2, dout, dx, g, dh, M, d_in, d_h, d_out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(cudaStream_t stream, const void* x_v, const void* w1_v, const float* b1,
                     const void* w2_v, const void* dout_v, void* dx_v, void* dw1, float* db1,
                     void* dw2, float* db2, void* g_v, void* dh_v, float* partial, int M,
                     int d_in, int d_h, int d_out, int splits) {
  const T* x = static_cast<const T*>(x_v);
  const T* dout = static_cast<const T*>(dout_v);
  T* g = static_cast<T*>(g_v);
  T* dh = static_cast<T*>(dh_v);
  const int width = d_in > d_out ? d_in : d_out;
  const int groups = (d_in + kHidden - 1) / kHidden;
  cudaError_t err;
#define VIT_MLP_BWD(R, G)                                                                         \
  launch_token<T, R, G>(stream, x, static_cast<const T*>(w1_v), b1, static_cast<const T*>(w2_v), \
                        dout, static_cast<T*>(dx_v), g, dh, M, d_in, d_h, d_out)
  if (width <= 384 && groups <= 1) {
    err = VIT_MLP_BWD(4, 1);
  } else if (width <= 384 && groups <= 2) {
    err = VIT_MLP_BWD(4, 2);
  } else if (width <= 384) {
    err = VIT_MLP_BWD(4, 3);
  } else if (groups <= 6) {
    err = VIT_MLP_BWD(2, 6);
  } else if (groups <= 8) {
    err = VIT_MLP_BWD(2, 8);
  } else {
    err = cudaErrorInvalidValue;
  }
#undef VIT_MLP_BWD
  if (err != cudaSuccess) return err;
  float* partial2 = partial + static_cast<size_t>(splits) * (d_in + 1) * d_h;
  err = wgrad<T>(stream, x, dh, partial, static_cast<T*>(dw1), db1, M, d_in, d_h, splits);
  if (err != cudaSuccess) return err;
  return wgrad<T>(stream, g, dout, partial2, static_cast<T*>(dw2), db2, M, d_h, d_out, splits);
}

}  // namespace vit

extern "C" {

const char* vit_mlp_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Token ranges the weight gradients are split into for M tokens: about one
// per 2,048 tokens, at most 16, so that the reduction over M fills the card.
int vit_mlp_bwd_splits(int M) {
  const int s = (M + 2047) / 2048;
  return s < 1 ? 1 : (s > 16 ? 16 : s);
}

// The K9 backward: x (M, d_in), w1 (d_in, d_h), w2 (d_h, d_out), dout (M,
// d_out), dx (M, d_in), dw1, dw2 and the scratch g, dh (M, d_h) in f32 or
// bf16 (bf16 != 0); b1 (d_h,), db1 (d_h,), db2 (d_out,) and partial
// (splits ((d_in + 1) d_h + (d_h + 1) d_out)) f32. d_in <= 1,024. Five
// launches on `stream`, no synchronization; returns the first error.
int vit_mlp_backward(const void* x, const void* w1, const void* b1, const void* w2,
                     const void* dout, void* dx, void* dw1, void* db1, void* dw2, void* db2,
                     void* g, void* dh, void* partial, int M, int d_in, int d_h, int d_out,
                     int splits, int bf16, void* stream) {
  if (M <= 0 || d_in <= 0 || d_h <= 0 || d_out <= 0 || splits <= 0 || splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bias = static_cast<const float*>(b1);
  float* p = static_cast<float*>(partial);
  float* d1 = static_cast<float*>(db1);
  float* d2 = static_cast<float*>(db2);
  return static_cast<int>(
      bf16 ? vit::backward<__nv_bfloat16>(st, x, w1, bias, w2, dout, dx, dw1, d1, dw2, d2, g, dh,
                                          p, M, d_in, d_h, d_out, splits)
           : vit::backward<float>(st, x, w1, bias, w2, dout, dx, dw1, d1, dw2, d2, g, dh, p, M,
                                  d_in, d_h, d_out, splits));
}

}  // extern "C"
