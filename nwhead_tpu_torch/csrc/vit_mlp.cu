// ViT MLP for Hopper (sm_90a): the fused MLP forward K9 on the tensor cores,
// and the MLP half-blocks K11 (bf16) and K11 int8 on FFMA and __dp4a.
//
// K9 replaces nwhead_tpu/ops/pallas_mlp.py:_mlp_kernel (forward):
//   out = gelu(x W1 + b1) W2 + b2, x (M, D_in), W1 (D_in, D_h), W2 (D_h,
//   D_out) in x's dtype (f32 or bf16), biases f32, h = x W1 + b1 summed in
//   f32, the exact GELU (erff) in f32, its output g rounded to x's dtype
//   before fc2, out = g W2 + b2 summed in f32 and rounded to x's dtype.
// What bounds it at ViT-S/14 serving (M = 64 x 257 = 16,448 tokens, D =
// 384, D_h = 1,536): 4 M D D_h = 38.8 GFLOP, 39 us at the 989 TFLOP/s bf16
// tensor-core rate and 235 us at 165 TFLOP/s in f32 (three TF32 passes at
// 495 TFLOP/s, the least time in which the card gives an f32-exact
// product); its bytes (x, out, the weights) take 8-15 us. PR 3's kernel ran
// every product on FFMA at 1-3% of that.
// mlp_tc_kernel: a block owns 64 tokens and up to 384 output columns; the
// fc2 accumulator (32 x 96 a warp, 96 f32 registers a thread at D_out =
// 384) stays in registers while the block walks the hidden units in chunks
// of 128. Each chunk is fc1 over D_in in slices 128 bytes deep (an x slice
// and a W1 slice a step), then the bias, the GELU and the rounding to x's
// dtype into a 64 x 128 tile of g in shared memory, then fc2 over the chunk
// (a W2 slice a step, g the left factor). Every slice goes through one
// three-stage cp.async ring, so later slices load while the tensor cores
// run; products are vit_mma.cuh's warp mma.sync: bf16 on m16n8k16
// (ldmatrix, ldmatrix.trans for the k-major weights), f32 on 3xTF32
// (m16n8k8, big and small halves split by truncation as each operand loads,
// g among them). The hidden activation never leaves the chip, as on the
// TPU. The weights stream from the L2 once for every 64 tokens (2.4 MB in
// bf16 at ViT-S/14, with x restaged for each chunk), about 0.8 TB at M =
// 16,448: that stream, not the tensor cores, sets the time (PERF.md, PR 10),
// and 64 tokens is as many as the fc2 accumulators leave room for. A D_out
// above 384 (ViT-B 768, ViT-L 1,024) takes more column blocks, each
// recomputing fc1 (1.5x the products at ViT-B).
//
// K11 replaces pallas_mlp.py:_mlp_int8_kernel with quant=False (the launch
// of fused_mlp_block_bf16), mlp_kernel below: the same function in bf16
// with an optional LayerNorm before fc1 (f32 statistics, output rounded to
// bf16) and an optional LayerScale (rounded to bf16) and residual add
// (rounded to bf16) after fc2's bias (rounded to bf16). A block owns TM = 8
// kRows tokens and all of D_out: each warp owns kRows rows, each lane
// columns 4 lane + 128 j (j < kGroups), so the fc2 accumulator (TM x D_out,
// f32) lives in registers, kRows x 4 kGroups per thread (96 at ViT-S/14: TM
// = 64, D_out = 384). The x tile sits in shared memory, transposed, with the
// LayerNorm applied once as it loads. Then for each chunk of 128 hidden
// units: fc1 over K slices of 16 (W1 slice staged in shared memory), bias +
// GELU + rounding into a transposed hidden chunk in shared memory, and fc2
// of that chunk into the accumulator over slices of 16 rows of W2. All
// products are f32 FMAs on widened values (39 us bound at M = 16,448, far
// below what FFMA reaches; its move to the tensor cores is later work).
//
// K11 int8 replaces pallas_mlp.py:_mlp_int8_kernel with quant=True (the
// launch of fused_mlp_int8), mlp_i8_kernel below: the same tiling with both
// products on int8 codes. The x tile is quantized as it loads (after the
// LayerNorm with row_stats_f64's statistics, rounded to bf16),
// clip(rint(x * (1/a1)), -127, 127), four codes a 32-bit word along D_in;
// fc1 runs __dp4a into int32 sums; each hidden unit
// is dequantized, acc * (a1 * s1) + b1, through the TPU kernel's GELU (erf by
// Abramowitz & Stegun) in f32, and requantized by 1/a2 into the hidden chunk
// in shared memory, a lane's four units one word; fc2 runs __dp4a into the
// int32 register accumulator, dequantized once at the end, acc * (a2 * s2) +
// b2, rounded to bf16, then the bf16 tail (LayerScale, residual) of the bf16
// mode. Bound at M = 16,448: 38.8 G int8 operations over 1,979 TOP/s (20
// us); __dp4a runs at the card's integer rate, far below it.

#include "vit_mma.cuh"

namespace vit {

constexpr int kHidden = 128;  // hidden units per chunk (K9's and K11's)
constexpr int kSlice = 16;    // K rows per staged weight slice (K11)

// K9's tiles: 64 tokens a block, slices 128 bytes deep (64 bf16, 32 f32)
// through a three-stage ring_loop, an output block of 32 kNT columns. Warp w
// owns rows 32 (w % 2) .. + 31 (two m-tiles, so that each B fragment feeds
// two products): hidden units 32 (w / 2) .. + 31 of each chunk in fc1,
// output columns 8 kNT (w / 2) .. + 8 kNT - 1 of the block in fc2.
constexpr int kK9Tm = 64;
constexpr int kK9Stages = 3;

template <typename T, int kNT>
struct K9Tiles {
  static constexpr int kDepth = 128 / static_cast<int>(sizeof(T));
  static constexpr int kWc = 32 * kNT;
  static constexpr int kSX = mlp_stride<T, kDepth, false>();   // x slice, 64 x depth
  static constexpr int kSW1 = mlp_stride<T, kHidden, true>();  // W1 slice, depth x 128
  static constexpr int kSW2 = mlp_stride<T, kWc, true>();      // W2 slice, depth x kWc
  static constexpr int kSG = mlp_stride<T, kHidden, false>();  // g, 64 x 128
  static constexpr int kFc1 = kK9Tm * kSX + kDepth * kSW1;
  static constexpr int kFc2 = kDepth * kSW2;
  static constexpr int kStage = kFc1 > kFc2 ? kFc1 : kFc2;
  static constexpr size_t kSmem = sizeof(T) * (kK9Stages * kStage + kK9Tm * kSG);
};

// K9. grid (ceil(M / 64), ceil(d_out / (32 kNT))), 256 threads. vec: bit 0
// x, bit 1 W1, bit 2 W2 take 16-byte cp.async.
template <typename T, int kNT>
__global__ void __launch_bounds__(kThreads, 1)
mlp_tc_kernel(const T* __restrict__ x, const T* __restrict__ w1, const float* __restrict__ b1,
              const T* __restrict__ w2, const float* __restrict__ b2, T* __restrict__ out, int M,
              int d_in, int d_h, int d_out, int vec) {
  using Tl = K9Tiles<T, kNT>;
  constexpr int kDepth = Tl::kDepth;
  constexpr int kFc2Steps = kHidden / kDepth;
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);
  T* gs = ring + kK9Stages * Tl::kStage;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 32 * (warp & 1), wc = warp >> 1;
  const int m0 = blockIdx.x * kK9Tm, c0 = blockIdx.y * Tl::kWc;
  const int fc1_steps = (d_in + kDepth - 1) / kDepth;
  const int per_chunk = fc1_steps + kFc2Steps;
  const int total = (d_h + kHidden - 1) / kHidden * per_chunk;
  float acc[2][kNT][4] = {};
  float h[2][4][4];
  ring_loop<kK9Stages, Tl::kStage>(
      ring, total,
      [&](int s, T* buf) {
        const int h0 = s / per_chunk * kHidden, j = s % per_chunk;
        if (j < fc1_steps) {
          stage_tile<T, kK9Tm, kDepth, Tl::kSX, kThreads>(x, d_in, m0, j * kDepth, M, d_in,
                                                          vec & 1, buf);
          stage_tile<T, kDepth, kHidden, Tl::kSW1, kThreads>(w1, d_h, j * kDepth, h0, d_in, d_h,
                                                             vec & 2, buf + kK9Tm * Tl::kSX);
        } else {
          stage_tile<T, kDepth, Tl::kWc, Tl::kSW2, kThreads>(
              w2, d_out, h0 + (j - fc1_steps) * kDepth, c0, d_h, d_out, vec & 4, buf);
        }
      },
      [&](int s, const T* buf) {
        const int h0 = s / per_chunk * kHidden, j = s % per_chunk;
        if (j < fc1_steps) {
          if (j == 0) {
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int n = 0; n < 4; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) h[i][n][e] = 0.f;
          }
          warp_product<T, 2, 4, kDepth, Tl::kSX, Tl::kSW1, false, true>(
              buf, row0, 0, buf + kK9Tm * Tl::kSX, 32 * wc, h);
          if (j == fc1_steps - 1) {
            // g = round(gelu(h + b1)) into the chunk's tile (read by fc2
            // after the next barrier); hidden units past d_h read b1 = 0
            // (their W1 columns are 0), so their g is 0.
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              const int col = 32 * wc + 8 * n + 2 * t;
              const int hid = h0 + col;
              const float bias0 = hid < d_h ? b1[hid] : 0.f;
              const float bias1 = hid + 1 < d_h ? b1[hid + 1] : 0.f;
#pragma unroll
              for (int q = 0; q < 4; ++q) {  // m-tile q / 2, row g + 8 (q % 2)
                const int i = q >> 1, r = q & 1;
                store2(gs + (row0 + 16 * i + g + 8 * r) * Tl::kSG + col,
                       gelu_exact(h[i][n][2 * r] + bias0), gelu_exact(h[i][n][2 * r + 1] + bias1));
              }
            }
          }
        } else if (h0 + (j - fc1_steps) * kDepth < d_h) {
          warp_product<T, 2, kNT, kDepth, Tl::kSG, Tl::kSW2, false, true>(
              gs, row0, (j - fc1_steps) * kDepth, buf, 8 * kNT * wc, acc);
        }
      });

  const bool pairs = d_out % 2 == 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = q >> 1, r = q & 1;
    const int row = m0 + row0 + 16 * i + g + 8 * r;
    if (row >= M) continue;
    T* dst = out + static_cast<size_t>(row) * d_out;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int col = c0 + 8 * kNT * wc + 8 * n + 2 * t;
      if (col >= d_out) continue;
      const float v0 = acc[i][n][2 * r] + b2[col];
      const float v1 = acc[i][n][2 * r + 1] + (col + 1 < d_out ? b2[col + 1] : 0.f);
      if (pairs) {
        store2(dst + col, v0, v1);
      } else {
        dst[col] = from_float<T>(v0);
        if (col + 1 < d_out) dst[col + 1] = from_float<T>(v1);
      }
    }
  }
}

template <typename T, int kNT>
cudaError_t launch_k9(cudaStream_t stream, const void* x, const void* w1, const void* b1,
                      const void* w2, const void* b2, void* out, int M, int d_in, int d_h,
                      int d_out) {
  using Tl = K9Tiles<T, kNT>;
  if (Tl::kSmem > smem_optin()) return cudaErrorInvalidConfiguration;
  const cudaError_t err = allow_smem(mlp_tc_kernel<T, kNT>, Tl::kSmem);
  if (err != cudaSuccess) return err;
  const int vec = vec16_ok<T>(x, d_in) | vec16_ok<T>(w1, d_h) << 1 | vec16_ok<T>(w2, d_out) << 2;
  const dim3 grid((M + kK9Tm - 1) / kK9Tm, (d_out + Tl::kWc - 1) / Tl::kWc);
  mlp_tc_kernel<T, kNT><<<grid, kThreads, Tl::kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const float*>(b2), static_cast<T*>(out), M, d_in,
      d_h, d_out, vec);
  return cudaGetLastError();
}

// K9's output block for a width: 128, 256 or 384 columns (above 384, more
// column blocks of 384).
template <typename T>
cudaError_t k9(cudaStream_t stream, const void* x, const void* w1, const void* b1, const void* w2,
               const void* b2, void* out, int M, int d_in, int d_h, int d_out) {
  if (d_out <= 128) return launch_k9<T, 4>(stream, x, w1, b1, w2, b2, out, M, d_in, d_h, d_out);
  if (d_out <= 256) return launch_k9<T, 8>(stream, x, w1, b1, w2, b2, out, M, d_in, d_h, d_out);
  return launch_k9<T, 12>(stream, x, w1, b1, w2, b2, out, M, d_in, d_h, d_out);
}

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

// K11 int8's shared memory: x codes, a W1 slice, the hidden chunk's codes
// and a W2 slice, all as 32-bit words of four codes.
template <int kRows, int kGroups>
size_t mlp_i8_smem_bytes(int d_in) {
  constexpr int kStride = kWarps * kRows + 4;
  return sizeof(int) * (static_cast<size_t>(round_up(d_in, kSlice) / 4) * kStride  // x codes^T
                        + kSlice / 4 * kHidden                                      // W1 slice
                        + kHidden / 4 * kStride                                     // hidden^T
                        + kSlice / 4 * kHidden * kGroups);                          // W2 slice
}

// grid (ceil(M / TM)), 256 threads; d_in a multiple of 4. ln_g == nullptr:
// no LayerNorm; ls may be null; residual needs d_out == d_in.
template <int kRows, int kGroups>
__global__ void __launch_bounds__(kThreads, 1)
mlp_i8_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ ln_g,
              const float* __restrict__ ln_b, float eps, float inv_a1, float a1,
              const int8_t* __restrict__ w1, const float* __restrict__ s1,
              const float* __restrict__ b1, float inv_a2, float a2,
              const int8_t* __restrict__ w2, const float* __restrict__ s2,
              const float* __restrict__ b2, const __nv_bfloat16* __restrict__ ls, int residual,
              __nv_bfloat16* __restrict__ out, int M, int d_in, int d_h, int d_out) {
  using bf = __nv_bfloat16;
  constexpr int kTm = kWarps * kRows;
  constexpr int kStride = kTm + 4;
  constexpr int kOutCols = kHidden * kGroups;
  constexpr int kSliceW = kSlice / 4;  // words per staged slice
  const int in_words = round_up(d_in, kSlice) / 4;
  extern __shared__ int4 smem_i4[];
  int* xt = reinterpret_cast<int*>(smem_i4);
  int* w1s = xt + static_cast<size_t>(in_words) * kStride;
  int* ht = w1s + kSliceW * kHidden;
  int* w2s = ht + kHidden / 4 * kStride;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * kTm;
  const int r0 = warp * kRows;

  for (int rr = 0; rr < kRows; ++rr) {
    const int r = r0 + rr;
    const bool valid = m0 + r < M;
    const bf* row = x + static_cast<size_t>(m0 + r) * d_in;
    float mean = 0.f, rstd = 1.f;
    if (ln_g != nullptr && valid) row_stats_f64(row, d_in, eps, mean, rstd);
    for (int kw = lane; kw < in_words; kw += 32) {
      int c[4] = {0, 0, 0, 0};
      if (valid && 4 * kw < d_in) {  // d_in % 4 == 0: the word is whole
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 4 * kw + e;
          float v = to_float(row[k]);
          if (ln_g != nullptr) v = ln_bf16(v, mean, rstd, ln_g[k], ln_b[k]);
          c[e] = quantize_i8(v, inv_a1);
        }
      }
      xt[kw * kStride + r] = pack4(c[0], c[1], c[2], c[3]);
    }
  }

  int acc[kRows][4 * kGroups];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kGroups; ++c) acc[i][c] = 0;

  for (int h0 = 0; h0 < d_h; h0 += kHidden) {
    int hacc[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) hacc[i][c] = 0;
    for (int k0 = 0; k0 < d_in; k0 += kSlice) {
      __syncthreads();  // the previous W1 slice (and hidden chunk) is consumed
#pragma unroll
      for (int u = 0; u < kSliceW * kHidden / kThreads; ++u) {
        const int idx = tid + u * kThreads;
        const int kw = idx / kHidden, hc = h0 + idx % kHidden;
        const int k = k0 + 4 * kw;
        int c[4] = {0, 0, 0, 0};
        if (k < d_in && hc < d_h) {
#pragma unroll
          for (int e = 0; e < 4; ++e) c[e] = w1[static_cast<size_t>(k + e) * d_h + hc];
        }
        w1s[idx] = pack4(c[0], c[1], c[2], c[3]);
      }
      __syncthreads();
#pragma unroll
      for (int kw = 0; kw < kSliceW; ++kw) {
        const int* a = xt + (k0 / 4 + kw) * kStride + r0;
        const int4 b = *reinterpret_cast<const int4*>(w1s + kw * kHidden + 4 * lane);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          hacc[i][0] = __dp4a(a[i], b.x, hacc[i][0]);
          hacc[i][1] = __dp4a(a[i], b.y, hacc[i][1]);
          hacc[i][2] = __dp4a(a[i], b.z, hacc[i][2]);
          hacc[i][3] = __dp4a(a[i], b.w, hacc[i][3]);
        }
      }
    }
    // Every thread passed a barrier after the last fc2 read of ht. Lane l
    // holds hidden units 4 l .. 4 l + 3: one word of codes per row.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      int c[4] = {0, 0, 0, 0};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hc = h0 + 4 * lane + e;
        if (hc < d_h) {
          const float deq = __fmul_rn(__int2float_rn(hacc[i][e]), __fmul_rn(a1, s1[hc]));
          c[e] = quantize_i8(gelu_as(__fadd_rn(deq, b1[hc])), inv_a2);
        }
      }
      ht[lane * kStride + r0 + i] = pack4(c[0], c[1], c[2], c[3]);
    }
    for (int k0 = 0; k0 < kHidden && h0 + k0 < d_h; k0 += kSlice) {
      __syncthreads();  // the hidden chunk is written; the previous W2 slice consumed
      for (int idx = tid; idx < kSliceW * kOutCols; idx += kThreads) {
        const int kw = idx / kOutCols, col = idx % kOutCols;
        const int hr = h0 + k0 + 4 * kw;
        int c[4] = {0, 0, 0, 0};
        if (col < d_out) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (hr + e < d_h) c[e] = w2[static_cast<size_t>(hr + e) * d_out + col];
          }
        }
        w2s[idx] = pack4(c[0], c[1], c[2], c[3]);
      }
      __syncthreads();
#pragma unroll
      for (int kw = 0; kw < kSliceW; ++kw) {
        const int* a = ht + (k0 / 4 + kw) * kStride + r0;
#pragma unroll
        for (int j = 0; j < kGroups; ++j) {
          const int4 b = *reinterpret_cast<const int4*>(w2s + kw * kOutCols + 4 * lane + 128 * j);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            acc[i][4 * j] = __dp4a(a[i], b.x, acc[i][4 * j]);
            acc[i][4 * j + 1] = __dp4a(a[i], b.y, acc[i][4 * j + 1]);
            acc[i][4 * j + 2] = __dp4a(a[i], b.z, acc[i][4 * j + 2]);
            acc[i][4 * j + 3] = __dp4a(a[i], b.w, acc[i][4 * j + 3]);
          }
        }
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
        const float deq = __fmul_rn(__int2float_rn(acc[i][4 * j + c]), __fmul_rn(a2, s2[col]));
        float v = round_to<bf>(__fadd_rn(deq, b2[col]));
        if (ls != nullptr) v = round_to<bf>(v * to_float(ls[col]));
        if (residual) v = round_to<bf>(to_float(x[static_cast<size_t>(row) * d_in + col]) + v);
        out[static_cast<size_t>(row) * d_out + col] = from_float<bf>(v);
      }
    }
  }
}

template <int kRows, int kGroups>
cudaError_t launch_mlp_i8(cudaStream_t stream, const void* x, const void* ln_g,
                          const void* ln_b, float eps, float inv_a1, float a1, const void* w1,
                          const void* s1, const void* b1, float inv_a2, float a2, const void* w2,
                          const void* s2, const void* b2, const void* ls, int residual,
                          void* out, int M, int d_in, int d_h, int d_out) {
  using bf = __nv_bfloat16;
  const size_t smem = mlp_i8_smem_bytes<kRows, kGroups>(d_in);
  if (smem > smem_optin()) return cudaErrorInvalidConfiguration;
  const cudaError_t err = allow_smem(mlp_i8_kernel<kRows, kGroups>, smem);
  if (err != cudaSuccess) return err;
  const int grid = (M + kWarps * kRows - 1) / (kWarps * kRows);
  mlp_i8_kernel<kRows, kGroups><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf*>(x), static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
      eps, inv_a1, a1, static_cast<const int8_t*>(w1), static_cast<const float*>(s1),
      static_cast<const float*>(b1), inv_a2, a2, static_cast<const int8_t*>(w2),
      static_cast<const float*>(s2), static_cast<const float*>(b2), static_cast<const bf*>(ls),
      residual, static_cast<bf*>(out), M, d_in, d_h, d_out);
  return cudaGetLastError();
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

// K11 int8's tile shape for an output width, as mlp's.
inline cudaError_t mlp_i8(cudaStream_t stream, const void* x, const void* ln_g, const void* ln_b,
                          float eps, float inv_a1, float a1, const void* w1, const void* s1,
                          const void* b1, float inv_a2, float a2, const void* w2, const void* s2,
                          const void* b2, const void* ls, int residual, void* out, int M,
                          int d_in, int d_h, int d_out) {
  const int groups = (d_out + kHidden - 1) / kHidden;
#define VIT_MLP_I8(R, G)                                                                         \
  launch_mlp_i8<R, G>(stream, x, ln_g, ln_b, eps, inv_a1, a1, w1, s1, b1, inv_a2, a2, w2, s2, b2, \
                      ls, residual, out, M, d_in, d_h, d_out)
  if (groups <= 1) return VIT_MLP_I8(8, 1);
  if (groups <= 2) return VIT_MLP_I8(8, 2);
  if (groups <= 3) return VIT_MLP_I8(8, 3);
  if (groups <= 6) return VIT_MLP_I8(4, 6);
  if (groups <= 8) return VIT_MLP_I8(2, 8);
#undef VIT_MLP_I8
  return cudaErrorInvalidValue;
}

}  // namespace vit

extern "C" {

const char* vit_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Largest output width K11 takes (K9 takes any).
int vit_mlp_max_out() { return 8 * vit::kHidden; }

// K9: x (M, d_in), w1 (d_in, d_h), w2 (d_h, d_out) and out (M, d_out) in f32
// or bf16 (bf16 != 0); b1, b2 f32. Launches on `stream`, does not
// synchronize, returns cudaGetLastError().
int vit_mlp_forward(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                    void* out, int M, int d_in, int d_h, int d_out, int bf16, void* stream) {
  if (M <= 0 || d_in <= 0 || d_h <= 0 || d_out <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? vit::k9<__nv_bfloat16>(st, x, w1, b1, w2, b2, out, M, d_in, d_h, d_out)
           : vit::k9<float>(st, x, w1, b1, w2, b2, out, M, d_in, d_h, d_out));
}

// K11 (bf16, any of the folds): x (M, d_in), w1 (d_in, d_h), w2 (d_h,
// d_out), out (M, d_out) and ls (d_out,) bf16; b1, b2, ln_g, ln_b f32.
// Launches on `stream`, does not synchronize, returns cudaGetLastError().
int vit_mlp_block_forward(const void* x, const void* ln_g, const void* ln_b, float eps,
                          const void* w1, const void* b1, const void* w2, const void* b2,
                          const void* ls, int residual, void* out, int M, int d_in, int d_h,
                          int d_out, void* stream) {
  if (M <= 0 || d_in <= 0 || d_h <= 0 || d_out <= 0 || (residual && d_in != d_out) ||
      (ln_g == nullptr) != (ln_b == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(vit::mlp<__nv_bfloat16>(static_cast<cudaStream_t>(stream), x, ln_g,
                                                  ln_b, eps, w1, b1, w2, b2, ls, residual, out, M,
                                                  d_in, d_h, d_out));
}

// K11 int8: x (M, d_in) bf16, d_in a multiple of 4; w1 (d_in, d_h) and w2
// (d_h, d_out) int8 with per-column scales s1 (d_h,), s2 (d_out,) f32; b1,
// b2, ln_g, ln_b f32; inv_a* and a* the activation scales' reciprocals and
// the scales; ls (d_out,) bf16 or null; out (M, d_out) bf16. Launches on
// `stream`, does not synchronize, returns cudaGetLastError().
int vit_mlp_int8_forward(const void* x, const void* ln_g, const void* ln_b, float eps,
                         const void* w1, const void* s1, const void* b1, float inv_a1, float a1,
                         const void* w2, const void* s2, const void* b2, float inv_a2, float a2,
                         const void* ls, int residual, void* out, int M, int d_in, int d_h,
                         int d_out, void* stream) {
  if (M <= 0 || d_in <= 0 || d_h <= 0 || d_out <= 0 || d_in % 4 != 0 ||
      (residual && d_in != d_out) || (ln_g == nullptr) != (ln_b == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(vit::mlp_i8(static_cast<cudaStream_t>(stream), x, ln_g, ln_b, eps,
                                      inv_a1, a1, w1, s1, b1, inv_a2, a2, w2, s2, b2, ls,
                                      residual, out, M, d_in, d_h, d_out));
}

}  // extern "C"
