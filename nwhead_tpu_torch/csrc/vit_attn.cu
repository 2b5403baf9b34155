// ViT attention for Hopper (sm_90a): multi-head attention straight off the
// packed qkv (K7), and the bf16 attention half-block (K10).
//
// K7 replaces nwhead_tpu/ops/pallas_attn.py:_attn_qkv_kernel (forward).
// qkv (B, N, 3 D) holds q | k | v, heads of hd contiguous inside each, as
// the qkv projection writes it; out (B, N, D). Per head:
//   out = softmax(q k^T * scale) v, the softmax in f32.
// The TPU kernel keeps one batch row's whole (N, N) score matrix in VMEM.
// Here a block owns 64 queries of one (batch, head) and sweeps the keys in
// chunks of 64 rows twice, so any N fits in about 70 KB of shared memory
// (hd = 64) and the scores never leave the chip:
//   * Q (transposed) and one K chunk (transposed) are staged in shared
//     memory as f32; each thread computes 4 x 4 scores with FMAs from
//     float4 reads;
//   * sweep 1 keeps each row's running max m and sum l (one warp per 8
//     rows, l rescaled as m grows);
//   * sweep 2 recomputes the scores, turns them into the normalized
//     probabilities exp(s - m) / l, rounds them to the input dtype as the
//     TPU kernel's single pass does before its PV product, and each thread
//     accumulates 4 rows x hd/16 output columns of p V in registers.
// The second sweep costs the score products again (1.5x the FLOPs of one
// online pass), but an online pass rounds unnormalized probabilities: in
// bf16 that moved each attention output by about one ulp from the TPU
// kernel's values, and twelve blocks of ViT-S/14 carried that to 1.8% of
// the served features (measured on the H100).
// What bounds it at ViT-S/14 serving (B = 64, N = 257, H = 6, hd = 64):
// 4 B H N^2 hd = 6.49 GFLOP, 97 us at the 67 TFLOP/s f32 rate outside the
// tensor cores; in bf16 the 50.5 MB of qkv and out over 3.35 TB/s (15 us).
// This first version runs on FFMA; wgmma is later work.
//
// K10 replaces pallas_attn.py:_attn_int8_kernel with quant=False (the
// launch of fused_attention_block_bf16): [LayerNorm ->] qkv -> attention
// -> proj [-> * LayerScale] [-> + x], bf16 in and out. One block's (N, 3 D)
// qkv tensor (592 KB at ViT-S/14) does not fit in shared memory as it fits
// in VMEM, so K10 runs three stages through device memory:
//   1. ln_gemm_kernel: LayerNorm in the prologue (f32 statistics, output
//      rounded to bf16), x W_qkv + b, rounded to bf16 -> qkv scratch;
//   2. K7's attention_kernel in bf16 -> att scratch (the f32 attention
//      output rounded to bf16 before proj, as the TPU kernel rounds it);
//   3. ln_gemm_kernel: att W_proj + b rounded to bf16, then * LayerScale
//      (rounded to bf16) and + x (rounded to bf16) in the epilogue.
// Each stage keeps the TPU kernel's bf16 rounding points. Its bound at
// B = 64: 25.9 GFLOP over 989 TFLOP/s (26 us) in bf16; the products run on
// FFMA here, at most 67 TFLOP/s.
//
// K10 int8 replaces the same TPU kernel with quant=True (the launch of
// fused_attention_qkv_int8): stages 1 and 3 become ln_gemm_i8_kernel, which
// quantizes its (LayerNorm'd, bf16-rounded) input as it stages it,
// clip(rint(x * (1/a)), -127, 127), multiplies int8 codes by the int8
// weights with __dp4a into int32 sums, and dequantizes in the epilogue as
// acc * (a * w_scale[c]) + bias[c] (two roundings, no FMA, as the TPU
// kernel computes it), then rounds to bf16; its LayerNorm statistics are
// row_stats_f64's, which the plain version reproduces exactly, since a
// normalized value whose bf16 rounding flips can move a code and with it a
// whole token downstream. Stage 2 is K7 in bf16, as on the
// TPU (bf16 score and PV products, f32 softmax). Its bound at B = 64: the
// projections' 19.4 G int8 operations over 1,979 TOP/s (10 us) and the
// attention's 6.5 GFLOP over 989 TFLOP/s (7 us); __dp4a runs at the card's
// integer rate, far below the tensor cores'.

#include "vit_common.cuh"

namespace vit {

template <int kHd>
constexpr size_t attention_smem_bytes() {
  return sizeof(float) * (2 * kHd * kTileStride      // Q^T, K^T
                          + kTile * (kHd + 4)        // V
                          + kTile * kTileStride      // scores, then p
                          + 2 * kTile);              // m, l
}

// Stage keys (and with kWithV values) k0 .. k0 + 63 of one head: K
// transposed into kt, V into vs; keys past N load as 0.
template <bool kWithV, typename T, int kHd>
__device__ __forceinline__ void load_kv(const T* __restrict__ base, size_t row_stride, int D,
                                        int k0, int N, float* __restrict__ kt,
                                        float* __restrict__ vs) {
  for (int idx = threadIdx.x; idx < kTile * kHd; idx += kThreads) {
    const int j = idx / kHd, d = idx % kHd;
    const bool valid = k0 + j < N;
    const T* row = base + (k0 + j) * row_stride;
    kt[d * kTileStride + j] = valid ? to_float(row[D + d]) : 0.f;
    if (kWithV) vs[j * (kHd + 4) + d] = valid ? to_float(row[2 * D + d]) : 0.f;
  }
}

// The staged chunk's scores q.k * scale into ss (row-major, 64 x 64; keys
// past N score kNeg). Thread (tr, tc) owns rows 4 tr .. and keys 4 tc ...
template <int kHd>
__device__ __forceinline__ void score_tile(const float* __restrict__ qt,
                                           const float* __restrict__ kt, int k0, int N,
                                           float scale, float* __restrict__ ss) {
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
  for (int d = 0; d < kHd; ++d) {
    float a[4];
    load_vec<4>(qt + d * kTileStride + 4 * tr, a);
    fma_tile<4, 1>(a, kt + d * kTileStride + 4 * tc, s);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 v;
    v.x = k0 + 4 * tc < N ? s[i][0] * scale : kNeg;
    v.y = k0 + 4 * tc + 1 < N ? s[i][1] * scale : kNeg;
    v.z = k0 + 4 * tc + 2 < N ? s[i][2] * scale : kNeg;
    v.w = k0 + 4 * tc + 3 < N ? s[i][3] * scale : kNeg;
    *reinterpret_cast<float4*>(ss + (4 * tr + i) * kTileStride + 4 * tc) = v;
  }
}

// grid (ceil(N / 64), H, B), 256 threads.
template <typename T, int kHd>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ qkv, T* __restrict__ out, int N, int H, float scale) {
  constexpr int kCols = kHd / 16;  // output columns per thread
  constexpr int kVStride = kHd + 4;
  constexpr int kRowsPerWarp = kTile / kWarps;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);
  float* kt = qt + kHd * kTileStride;
  float* vs = kt + kHd * kTileStride;
  float* ss = vs + kTile * kVStride;
  float* m_row = ss + kTile * kTileStride;
  float* l_row = m_row + kTile;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tr = tid >> 4;  // rows 4 tr .. 4 tr + 3
  const int tc = tid & 15;  // output columns kCols tc ..
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * kHd;
  const size_t row_stride = 3 * static_cast<size_t>(D);
  const T* base = qkv + static_cast<size_t>(b) * N * row_stride + h * kHd;

  for (int idx = tid; idx < kTile * kHd; idx += kThreads) {
    const int r = idx / kHd, d = idx % kHd;
    qt[d * kTileStride + r] = q0 + r < N ? to_float(base[(q0 + r) * row_stride + d]) : 0.f;
  }
  if (tid < kTile) {
    m_row[tid] = kNeg;
    l_row[tid] = 0.f;
  }

  // Sweep 1: each row's max and sum of exp(s - max). The first chunk always
  // holds a valid key, so m is finite after it and exp(kNeg - m) is 0 for
  // the initial state and for masked keys.
  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();  // the previous chunk's K and scores are consumed
    load_kv<false, T, kHd>(base, row_stride, D, k0, N, kt, vs);
    __syncthreads();
    score_tile<kHd>(qt, kt, k0, N, scale, ss);
    __syncthreads();
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const float s0 = ss[r * kTileStride + lane], s1 = ss[r * kTileStride + lane + 32];
      const float m_prev = m_row[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float sum = warp_sum(expf(s0 - m_new) + expf(s1 - m_new));
      if (lane == 0) {
        l_row[r] = l_row[r] * expf(m_prev - m_new) + sum;
        m_row[r] = m_new;
      }
    }
  }

  // Sweep 2: the normalized probabilities, rounded to T, times V.
  float o[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[i][c] = 0.f;
  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();  // sweep 1's statistics are written; the previous chunk consumed
    load_kv<true, T, kHd>(base, row_stride, D, k0, N, kt, vs);
    __syncthreads();
    score_tile<kHd>(qt, kt, k0, N, scale, ss);
    __syncthreads();
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const float m = m_row[r], l = fmaxf(l_row[r], 1e-30f);
      float* row = ss + r * kTileStride;
      row[lane] = round_to<T>(expf(row[lane] - m) / l);
      row[lane + 32] = round_to<T>(expf(row[lane + 32] - m) / l);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float v[kCols];
      load_vec<kCols>(vs + j * kVStride + kCols * tc, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ss[(4 * tr + i) * kTileStride + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) o[i][c] = fmaf(p, v[c], o[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * tr + i;
    if (q0 + r >= N) continue;
    T* dst = out + (static_cast<size_t>(b) * N + q0 + r) * D + h * kHd + kCols * tc;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dst[c] = from_float<T>(o[i][c]);
  }
}

template <typename T, int kHd>
cudaError_t launch_attention(cudaStream_t stream, const void* qkv, void* out, int B, int N, int H,
                             float scale) {
  const size_t smem = attention_smem_bytes<kHd>();
  const cudaError_t err = allow_smem(attention_kernel<T, kHd>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTile - 1) / kTile, H, B);
  attention_kernel<T, kHd><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), N, H, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t attention(cudaStream_t stream, const void* qkv, void* out, int B, int N, int H, int hd,
                      float scale) {
  switch (hd) {
    case 32: return launch_attention<T, 32>(stream, qkv, out, B, N, H, scale);
    case 64: return launch_attention<T, 64>(stream, qkv, out, B, N, H, scale);
    case 128: return launch_attention<T, 128>(stream, qkv, out, B, N, H, scale);
    default: return cudaErrorInvalidValue;
  }
}

// out (M, n_out) = [LN](A) (M, K) W (K, n_out) + bias, rounded to T, then
// [* ls, rounded] [+ resid, rounded]. A block computes 64 rows x 128
// columns; each thread 8 rows x 4 columns, from K slices of 16 staged in
// shared memory (A transposed, with the LayerNorm applied as it loads).
// ln_g == nullptr: no LayerNorm; ls, resid may be null.
constexpr int kGemmRows = 64;
constexpr int kGemmCols = 128;
constexpr int kGemmK = 16;
constexpr int kGemmStride = kGemmRows + 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_gemm_kernel(const T* __restrict__ A, const float* __restrict__ ln_g,
               const float* __restrict__ ln_b, float eps, const T* __restrict__ W,
               const float* __restrict__ bias, const T* __restrict__ ls,
               const T* __restrict__ resid, T* __restrict__ out, int M, int K, int n_out) {
  __shared__ __align__(16) float at[kGemmK * kGemmStride];
  __shared__ __align__(16) float ws[kGemmK * kGemmCols];
  __shared__ float mean_s[kGemmRows], rstd_s[kGemmRows];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * kGemmRows;
  const int n0 = blockIdx.y * kGemmCols;
  constexpr int kRows = kGemmRows / kWarps;  // 8 rows per thread, one row group per warp

  if (ln_g != nullptr) {
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = warp * kRows + rr;
      float mean = 0.f, rstd = 1.f;
      if (m0 + r < M) row_stats(A + static_cast<size_t>(m0 + r) * K, K, eps, mean, rstd);
      if (lane == 0) {
        mean_s[r] = mean;
        rstd_s[r] = rstd;
      }
    }
  }
  float acc[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kGemmK) {
    __syncthreads();  // the previous slice is consumed (and the LN statistics written)
#pragma unroll
    for (int u = 0; u < kGemmRows * kGemmK / kThreads; ++u) {
      const int idx = tid + u * kThreads;
      const int r = idx / kGemmK, kk = idx % kGemmK;
      const int row = m0 + r, k = k0 + kk;
      float a = 0.f;
      if (row < M && k < K) {
        a = to_float(A[static_cast<size_t>(row) * K + k]);
        if (ln_g != nullptr) a = round_to<T>((a - mean_s[r]) * rstd_s[r] * ln_g[k] + ln_b[k]);
      }
      at[kk * kGemmStride + r] = a;
    }
#pragma unroll
    for (int u = 0; u < kGemmK * kGemmCols / kThreads; ++u) {
      const int idx = tid + u * kThreads;
      const int kk = idx / kGemmCols, c = idx % kGemmCols;
      const int k = k0 + kk, col = n0 + c;
      ws[idx] = k < K && col < n_out ? to_float(W[static_cast<size_t>(k) * n_out + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGemmK; ++kk) {
      float a[kRows];
      load_vec<kRows>(at + kk * kGemmStride + warp * kRows, a);
      fma_tile<kRows, 1>(a, ws + kk * kGemmCols + 4 * lane, acc);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = m0 + warp * kRows + i;
    if (row >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = n0 + 4 * lane + c;
      if (col >= n_out) continue;
      const size_t at_out = static_cast<size_t>(row) * n_out + col;
      float v = round_to<T>(acc[i][c] + bias[col]);
      if (ls != nullptr) v = round_to<T>(v * to_float(ls[col]));
      if (resid != nullptr) v = round_to<T>(to_float(resid[at_out]) + v);
      out[at_out] = from_float<T>(v);
    }
  }
}

// The int8 ln_gemm: out (M, n_out) bf16 = dequant([LN](A) codes W) + bias,
// then [* ls] [+ resid], each rounded to bf16. A (M, K) bf16, K a multiple
// of 4; W (K, n_out) int8; w_scale, bias (n_out,) f32. A block computes 64
// rows x 128 columns, each thread 8 rows x 4 columns in int32, from K slices
// of 32 staged in shared memory as words of four codes along K: A's rows
// quantized as they load, W's columns packed from four rows.
constexpr int kQGemmWords = 8;  // 32-bit words (4 K values each) per staged slice

__global__ void __launch_bounds__(kThreads)
ln_gemm_i8_kernel(const __nv_bfloat16* __restrict__ A, const float* __restrict__ ln_g,
                  const float* __restrict__ ln_b, float eps, float inv_a, float a,
                  const int8_t* __restrict__ W, const float* __restrict__ w_scale,
                  const float* __restrict__ bias, const __nv_bfloat16* __restrict__ ls,
                  const __nv_bfloat16* __restrict__ resid, __nv_bfloat16* __restrict__ out,
                  int M, int K, int n_out) {
  using bf = __nv_bfloat16;
  __shared__ __align__(16) int at[kQGemmWords * kGemmStride];
  __shared__ __align__(16) int ws[kQGemmWords * kGemmCols];
  __shared__ float mean_s[kGemmRows], rstd_s[kGemmRows];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * kGemmRows;
  const int n0 = blockIdx.y * kGemmCols;
  constexpr int kRows = kGemmRows / kWarps;

  if (ln_g != nullptr) {
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = warp * kRows + rr;
      float mean = 0.f, rstd = 1.f;
      if (m0 + r < M) row_stats_f64(A + static_cast<size_t>(m0 + r) * K, K, eps, mean, rstd);
      if (lane == 0) {
        mean_s[r] = mean;
        rstd_s[r] = rstd;
      }
    }
  }
  int acc[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0;

  for (int k0 = 0; k0 < K; k0 += 4 * kQGemmWords) {
    __syncthreads();  // the previous slice is consumed (and the LN statistics written)
#pragma unroll
    for (int u = 0; u < kGemmRows * kQGemmWords / kThreads; ++u) {
      const int idx = tid + u * kThreads;
      const int r = idx / kQGemmWords, kw = idx % kQGemmWords;
      const int row = m0 + r, k = k0 + 4 * kw;
      int c[4] = {0, 0, 0, 0};
      if (row < M && k < K) {  // K % 4 == 0: the word is whole
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = to_float(A[static_cast<size_t>(row) * K + k + e]);
          if (ln_g != nullptr) {
            v = ln_bf16(v, mean_s[r], rstd_s[r], ln_g[k + e], ln_b[k + e]);
          }
          c[e] = quantize_i8(v, inv_a);
        }
      }
      at[kw * kGemmStride + r] = pack4(c[0], c[1], c[2], c[3]);
    }
#pragma unroll
    for (int u = 0; u < kQGemmWords * kGemmCols / kThreads; ++u) {
      const int idx = tid + u * kThreads;
      const int kw = idx / kGemmCols, col = n0 + idx % kGemmCols;
      const int k = k0 + 4 * kw;
      int c[4] = {0, 0, 0, 0};
      if (k < K && col < n_out) {
#pragma unroll
        for (int e = 0; e < 4; ++e) c[e] = W[static_cast<size_t>(k + e) * n_out + col];
      }
      ws[idx] = pack4(c[0], c[1], c[2], c[3]);
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kQGemmWords; ++kw) {
      const int4 a0 = *reinterpret_cast<const int4*>(at + kw * kGemmStride + warp * kRows);
      const int4 a1 = *reinterpret_cast<const int4*>(at + kw * kGemmStride + warp * kRows + 4);
      const int4 b = *reinterpret_cast<const int4*>(ws + kw * kGemmCols + 4 * lane);
      const int av[kRows] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        acc[i][0] = __dp4a(av[i], b.x, acc[i][0]);
        acc[i][1] = __dp4a(av[i], b.y, acc[i][1]);
        acc[i][2] = __dp4a(av[i], b.z, acc[i][2]);
        acc[i][3] = __dp4a(av[i], b.w, acc[i][3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = m0 + warp * kRows + i;
    if (row >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = n0 + 4 * lane + c;
      if (col >= n_out) continue;
      const size_t at_out = static_cast<size_t>(row) * n_out + col;
      const float deq = __fmul_rn(__int2float_rn(acc[i][c]), __fmul_rn(a, w_scale[col]));
      float v = round_to<bf>(__fadd_rn(deq, bias[col]));
      if (ls != nullptr) v = round_to<bf>(v * to_float(ls[col]));
      if (resid != nullptr) v = round_to<bf>(to_float(resid[at_out]) + v);
      out[at_out] = from_float<bf>(v);
    }
  }
}

inline cudaError_t ln_gemm_i8(cudaStream_t stream, const void* A, const void* ln_g,
                              const void* ln_b, float eps, float inv_a, float a, const void* W,
                              const void* w_scale, const void* bias, const void* ls,
                              const void* resid, void* out, int M, int K, int n_out) {
  using bf = __nv_bfloat16;
  const dim3 grid((M + kGemmRows - 1) / kGemmRows, (n_out + kGemmCols - 1) / kGemmCols);
  ln_gemm_i8_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const bf*>(A), static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
      eps, inv_a, a, static_cast<const int8_t*>(W), static_cast<const float*>(w_scale),
      static_cast<const float*>(bias), static_cast<const bf*>(ls), static_cast<const bf*>(resid),
      static_cast<bf*>(out), M, K, n_out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t ln_gemm(cudaStream_t stream, const void* A, const void* ln_g, const void* ln_b,
                    float eps, const void* W, const void* bias, const void* ls, const void* resid,
                    void* out, int M, int K, int n_out) {
  const dim3 grid((M + kGemmRows - 1) / kGemmRows, (n_out + kGemmCols - 1) / kGemmCols);
  ln_gemm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(A), static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
      eps, static_cast<const T*>(W), static_cast<const float*>(bias), static_cast<const T*>(ls),
      static_cast<const T*>(resid), static_cast<T*>(out), M, K, n_out);
  return cudaGetLastError();
}

}  // namespace vit

extern "C" {

const char* vit_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K7: qkv (B, N, 3 H hd) -> out (B, N, H hd), both f32 or both bf16
// (bf16 != 0); hd in {32, 64, 128}. Launches on `stream`, does not
// synchronize, returns cudaGetLastError().
int vit_attention_forward(const void* qkv, void* out, int B, int N, int H, int hd, float scale,
                          int bf16, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? vit::attention<__nv_bfloat16>(st, qkv, out, B, N, H, hd, scale)
           : vit::attention<float>(st, qkv, out, B, N, H, hd, scale));
}

// K10 (bf16): x (B, N, D); ln_g, ln_b (D,) f32 or both null; w_qkv (D, 3D)
// and w_proj (D, D) bf16; b_qkv (3D,), b_proj (D,) f32; ls (D,) bf16 or
// null; residual != 0 adds x. qkv (B, N, 3D) and att (B, N, D) bf16
// scratch; out (B, N, D) bf16. Three launches on `stream`.
int vit_attention_block_bf16(const void* x, const void* ln_g, const void* ln_b, float eps,
                             const void* w_qkv, const void* b_qkv, const void* w_proj,
                             const void* b_proj, const void* ls, int residual, void* qkv,
                             void* att, void* out, int B, int N, int D, int H, float scale,
                             void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || D % H != 0 || (ln_g == nullptr) != (ln_b == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using bf = __nv_bfloat16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  cudaError_t err = vit::ln_gemm<bf>(st, x, ln_g, ln_b, eps, w_qkv, b_qkv, nullptr, nullptr, qkv,
                                     M, D, 3 * D);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = vit::attention<bf>(st, qkv, att, B, N, H, D / H, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(vit::ln_gemm<bf>(st, att, nullptr, nullptr, eps, w_proj, b_proj, ls,
                                           residual ? x : nullptr, out, M, D, D));
}

// K10 int8: x (B, N, D) bf16, D a multiple of 4; ln_g, ln_b (D,) f32 or both
// null; w_qkv (D, 3D) and w_proj (D, D) int8 with per-column scales s_qkv
// (3D,) and s_proj (D,) f32; b_qkv (3D,), b_proj (D,) f32; inv_a_* and a_*
// the activation scales' reciprocals and the scales; ls (D,) bf16 or null;
// residual != 0 adds x. qkv (B, N, 3D) and att (B, N, D) bf16 scratch; out
// (B, N, D) bf16. Three launches on `stream`.
int vit_attention_block_int8(const void* x, const void* ln_g, const void* ln_b, float eps,
                             const void* w_qkv, const void* s_qkv, const void* b_qkv,
                             float inv_a_qkv, float a_qkv, const void* w_proj,
                             const void* s_proj, const void* b_proj, float inv_a_proj,
                             float a_proj, const void* ls, int residual, void* qkv, void* att,
                             void* out, int B, int N, int D, int H, float scale, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || D % H != 0 || D % 4 != 0 ||
      (ln_g == nullptr) != (ln_b == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  cudaError_t err = vit::ln_gemm_i8(st, x, ln_g, ln_b, eps, inv_a_qkv, a_qkv, w_qkv, s_qkv, b_qkv,
                                    nullptr, nullptr, qkv, M, D, 3 * D);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = vit::attention<__nv_bfloat16>(st, qkv, att, B, N, H, D / H, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(vit::ln_gemm_i8(st, att, nullptr, nullptr, eps, inv_a_proj, a_proj,
                                          w_proj, s_proj, b_proj, ls, residual ? x : nullptr,
                                          out, M, D, D));
}

}  // extern "C"
