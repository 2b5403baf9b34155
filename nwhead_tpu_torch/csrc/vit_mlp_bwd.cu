// ViT MLP backward for Hopper (sm_90a): the K9 backward, the VJP of
// out = gelu(x W1 + b1) W2 + b2, on the tensor cores.
//
// Replaces nwhead_tpu/ops/pallas_mlp.py:_mlp_bwd_kernel. From x (M, D_in),
// W1 (D_in, D_h), b1, W2 (D_h, D_out) and dO (M, D_out) in x's dtype (f32
// or bf16; biases f32), with the TPU kernel's rounding points:
//   h = x W1 + b1 (f32), cdf = (1 + erf(h / sqrt 2)) / 2, g = round(h cdf)
//   dg = dO W2^T (f32), dh = round(dg (cdf + h phi(h)))
//   dx = dh W1^T, dW1 = x^T dh, db1 = sum dh, dW2 = g^T dO, db2 = sum dO
// (round = to x's dtype; sums in f32; dW in x's dtype, db in f32).
// What bounds it at ViT-S/14 (D = 384, D_h = 1,536): the five products,
// 10 M D D_h operations, 98 us at M = 16,448 and 1.85 ms at the training
// step's M = 310,456 on the 989 TFLOP/s bf16 tensor-core rate; 0.59 ms and
// 11.1 ms in f32 at 165 TFLOP/s (three TF32 passes at 495). PR 4's kernels
// ran all five on FFMA, at 2x the time of cuBLAS and elementwise passes.
// The TPU kernel walks token tiles in order on one core and carries the
// weight gradients in VMEM from tile to tile. Blocks here run in parallel,
// so the work is split where it changes owner, every product a warp's
// mma.sync from vit_mma.cuh (bf16 m16n8k16 through ldmatrix, f32 3xTF32 on
// m16n8k8, split by truncation) on 128 x 128 block tiles of eight 32 x 64
// warp tiles, their operands in slices 128 bytes deep through a three-stage
// cp.async ring:
//   1. mlp_bwd_token_kernel: a block owns 128 tokens x 128 hidden units. It
//      sums h over D_in (x and W1 slices), then dg over D_out (dO slices and
//      W2's rows as an n-major right factor), both in registers, and writes
//      g and dh, each once, rounded (two (M, D_h) tensors in x's dtype: dh
//      leaves the registers only as its rounded value), staged through
//      shared memory so that they leave in whole 16-byte rows. Tiling the
//      hidden units as well as the tokens fills the card with no sum
//      carried across blocks. Going through device memory costs 2 M D_h
//      values written and 3 M D_h read back (3.8 GB and 5.7 GB in f32 at the
//      step's M, about 2.8 ms at the card's 3.35 TB/s): less than
//      recomputing h and dg for each of the three products that need them.
//   2. mlp_bwd_dx_kernel: dx = dh W1^T over D_h, W1's rows n-major.
//   3. wgrad_kernel: dW1 = x^T dh and dW2 = g^T dO, their depth the tokens:
//      the left factor loads k-major (ldmatrix.trans in bf16, the transposed
//      32-bit pattern in f32), and the bias gradient is one more row of it,
//      ones on the tokens. A block owns a 128 x 128 tile of one product for
//      one of `splits` consecutive token ranges, summed in token order; the
//      splits fill whole waves of the card (wgrad_splits).
//   4. wgrad_finalize_kernel: each gradient element adds its splits'
//      partials in split order and is written once. No float atomics: two
//      runs give the same gradients bit for bit.

#include <algorithm>

#include "vit_mma.cuh"

namespace vit {

constexpr int kWarpMI = 2;    // 16-row m-tiles a warp owns
constexpr int kWarpNT = 8;    // 8-column n-tiles a warp owns
constexpr int kBwdTm = 64 * kWarpMI;  // rows a block owns: four warp rows
constexpr int kBwdTn = 128;           // columns a block owns: two warp columns
constexpr int kBwdStages = 3;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

// Slices are 128 bytes deep (64 bf16, 32 f32).
template <typename T>
struct BwdTiles {
  static constexpr int kDepth = 128 / static_cast<int>(sizeof(T));
  static constexpr int kSM = mlp_stride<T, kDepth, false>();  // 128 x depth left factor (x, dO, dh)
  static constexpr int kSN = mlp_stride<T, kDepth, false>();  // 128 x depth n-major right factor
  static constexpr int kSK = mlp_stride<T, kBwdTn, true>();   // depth x 128 k-major right factor
  static constexpr int kSKA = mlp_stride<T, kBwdTm, true>();  // depth x 128 k-major left factor
  static constexpr int kA = kBwdTm * kSM;
  static constexpr int kTokenStage = kA + (kDepth * kSK > kBwdTn * kSN ? kDepth * kSK
                                                                       : kBwdTn * kSN);
  static constexpr int kDxStage = kA + kBwdTn * kSN;
  static constexpr int kWgStage = kDepth * kSKA + kDepth * kSK;
};

// Two neighbouring values of a row-major (., ld) output at column col (even),
// col + 1 written only below ld; paired stores where ld is even.
template <typename T>
__device__ __forceinline__ void store_pair(T* row, int col, int ld, float v0, float v1) {
  if (ld % 2 == 0) {
    store2(row + col, v0, v1);
  } else {
    row[col] = from_float<T>(v0);
    if (col + 1 < ld) row[col + 1] = from_float<T>(v1);
  }
}

// The token kernel's 128 x 128 output tile in shared memory: row stride.
template <typename T>
constexpr int kStageOut = kBwdTn + 16 / static_cast<int>(sizeof(T));

// A warp's accumulators (rows row0 .., columns n0 ..) into the staged output
// tile, rounded to T.
template <typename T>
__device__ __forceinline__ void store_tile(const float (&acc)[kWarpMI][kWarpNT][4], T* tile,
                                           int row0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < kWarpMI; ++i)
#pragma unroll
    for (int n = 0; n < kWarpNT; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        store2(tile + (row0 + 16 * i + g + 8 * r) * kStageOut<T> + n0 + 8 * n + 2 * t,
               acc[i][n][2 * r], acc[i][n][2 * r + 1]);
      }
}

// The staged tile to rows m0 .., columns c0 .. of a row-major (M, ld)
// output: 16-byte stores where the row allows (vec16), else element stores.
template <typename T>
__device__ __forceinline__ void copy_out(const T* tile, T* out, int m0, int c0, int M, int ld,
                                         bool vec16) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kSegs = kBwdTn / kVec;
#pragma unroll
  for (int u = 0; u < kBwdTm * kSegs / kThreads; ++u) {
    const int i = threadIdx.x + u * kThreads, r = i / kSegs, c = (i % kSegs) * kVec;
    const int row = m0 + r, col = c0 + c;
    if (row >= M || col >= ld) continue;
    const T* src = tile + r * kStageOut<T> + c;
    T* dst = out + static_cast<size_t>(row) * ld + col;
    if (vec16 && col + kVec <= ld) {
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        if (col + e < ld) dst[e] = src[e];
      }
    }
  }
}

// 1. grid (ceil(M / 128), ceil(d_h / 128)), 256 threads. vec: bit 0 x, 1 W1,
// 2 W2, 3 dO take 16-byte cp.async, bit 4 g and dh 16-byte stores.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
mlp_bwd_token_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                     const float* __restrict__ b1, const T* __restrict__ w2,
                     const T* __restrict__ dout, T* __restrict__ g_out, T* __restrict__ dh_out,
                     int M, int d_in, int d_h, int d_out, int vec) {
  using Tl = BwdTiles<T>;
  constexpr int kDepth = Tl::kDepth;
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 3;
  const int row0 = 16 * kWarpMI * (warp & 3), n0 = 64 * (warp >> 2);
  const int m0 = blockIdx.x * kBwdTm, h0 = blockIdx.y * kBwdTn;
  const int h_steps = (d_in + kDepth - 1) / kDepth;
  const int total = h_steps + (d_out + kDepth - 1) / kDepth;
  float h[kWarpMI][kWarpNT][4] = {}, dg[kWarpMI][kWarpNT][4] = {};
  ring_loop<kBwdStages, Tl::kTokenStage>(
      reinterpret_cast<T*>(smem4), total,
      [&](int s, T* buf) {
        if (s < h_steps) {
          stage_tile<T, kBwdTm, kDepth, Tl::kSM, kThreads>(x, d_in, m0, s * kDepth, M, d_in,
                                                              vec & 1, buf);
          stage_tile<T, kDepth, kBwdTn, Tl::kSK, kThreads>(w1, d_h, s * kDepth, h0, d_in,
                                                              d_h, vec & 2, buf + Tl::kA);
        } else {
          const int k0 = (s - h_steps) * kDepth;
          stage_tile<T, kBwdTm, kDepth, Tl::kSM, kThreads>(dout, d_out, m0, k0, M, d_out,
                                                              vec & 8, buf);
          stage_tile<T, kBwdTn, kDepth, Tl::kSN, kThreads>(w2, d_out, h0, k0, d_h, d_out,
                                                              vec & 4, buf + Tl::kA);
        }
      },
      [&](int s, const T* buf) {
        if (s < h_steps) {
          warp_product<T, kWarpMI, kWarpNT, kDepth, Tl::kSM, Tl::kSK, false, true>(
              buf, row0, 0, buf + Tl::kA, n0, h);
        } else {
          warp_product<T, kWarpMI, kWarpNT, kDepth, Tl::kSM, Tl::kSN, false, false>(
              buf, row0, 0, buf + Tl::kA, n0, dg);
        }
      });
  // The elementwise pass in registers: h becomes g and dg becomes dh, each
  // then rounded as it is staged. Hidden units past d_h read b1 = 0; their
  // dg is 0 (W2's rows are), so is dh.
#pragma unroll
  for (int n = 0; n < kWarpNT; ++n) {
    const int col = h0 + n0 + 8 * n + 2 * t;
    const float bias[2] = {col < d_h ? b1[col] : 0.f, col + 1 < d_h ? b1[col + 1] : 0.f};
#pragma unroll
    for (int i = 0; i < kWarpMI; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float hv = h[i][n][e] + bias[e & 1];
        const float cdf = 0.5f * (1.f + erff(hv * 0.70710678118654752f));
        h[i][n][e] = hv * cdf;
        dg[i][n][e] *= cdf + hv * (expf(-0.5f * hv * hv) * kInvSqrt2Pi);
      }
  }
  // g, then dh, staged in the ring's memory (every warp is done with the
  // ring after this barrier), so that each leaves in whole 16-byte rows.
  __syncthreads();
  T* tile = reinterpret_cast<T*>(smem4);
  store_tile(h, tile, row0, n0);
  __syncthreads();
  copy_out(tile, g_out, m0, h0, M, d_h, vec & 16);
  __syncthreads();
  store_tile(dg, tile, row0, n0);
  __syncthreads();
  copy_out(tile, dh_out, m0, h0, M, d_h, vec & 16);
}

// 2. grid (ceil(M / 128), ceil(d_in / 128)), 256 threads: dx = dh W1^T. vec:
// bit 0 dh, bit 1 W1.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
mlp_bwd_dx_kernel(const T* __restrict__ dh, const T* __restrict__ w1, T* __restrict__ dx, int M,
                  int d_in, int d_h, int vec) {
  using Tl = BwdTiles<T>;
  constexpr int kDepth = Tl::kDepth;
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 16 * kWarpMI * (warp & 3), n0 = 64 * (warp >> 2);
  const int m0 = blockIdx.x * kBwdTm, c0 = blockIdx.y * kBwdTn;
  float acc[kWarpMI][kWarpNT][4] = {};
  ring_loop<kBwdStages, Tl::kDxStage>(
      reinterpret_cast<T*>(smem4), (d_h + kDepth - 1) / kDepth,
      [&](int s, T* buf) {
        stage_tile<T, kBwdTm, kDepth, Tl::kSM, kThreads>(dh, d_h, m0, s * kDepth, M, d_h,
                                                            vec & 1, buf);
        stage_tile<T, kBwdTn, kDepth, Tl::kSN, kThreads>(w1, d_h, c0, s * kDepth, d_in,
                                                            d_h, vec & 2, buf + Tl::kA);
      },
      [&](int, const T* buf) {
        warp_product<T, kWarpMI, kWarpNT, kDepth, Tl::kSM, Tl::kSN, false, false>(
            buf, row0, 0, buf + Tl::kA, n0, acc);
      });
#pragma unroll
  for (int q = 0; q < 2 * kWarpMI; ++q) {
    const int i = q >> 1, r = q & 1;
    const int row = m0 + row0 + 16 * i + g + 8 * r;
    if (row >= M) continue;
#pragma unroll
    for (int n = 0; n < kWarpNT; ++n) {
      const int col = c0 + n0 + 8 * n + 2 * t;
      if (col < d_in) {
        store_pair(dx + static_cast<size_t>(row) * d_in, col, d_in, acc[i][n][2 * r],
                   acc[i][n][2 * r + 1]);
      }
    }
  }
}

// 3. partial[z] ((R + 1) x n, f32) = [A | 1]^T B over tokens [z rows, (z +
// 1) rows) of split z = blockIdx.z: A (M, R), B (M, n); row R is the column
// sums of B. grid (ceil((R + 1) / 128), ceil(n / 128), splits), 256 threads.
// vec: bit 0 A, bit 1 B.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
wgrad_kernel(const T* __restrict__ A, const T* __restrict__ B, float* __restrict__ partial, int M,
             int R, int n, int rows, int vec) {
  using Tl = BwdTiles<T>;
  constexpr int kDepth = Tl::kDepth;
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 16 * kWarpMI * (warp & 3), n0 = 64 * (warp >> 2);
  const int r0 = blockIdx.x * kBwdTm, c0 = blockIdx.y * kBwdTn;
  const int m_begin = blockIdx.z * rows;
  const int m_end = min(M, m_begin + rows);
  const int steps = m_end > m_begin ? (m_end - m_begin + kDepth - 1) / kDepth : 0;
  float acc[kWarpMI][kWarpNT][4] = {};
  ring_loop<kBwdStages, Tl::kWgStage>(
      reinterpret_cast<T*>(smem4), steps,
      [&](int s, T* buf) {
        const int m0 = m_begin + s * kDepth;
        stage_tile<T, kDepth, kBwdTm, Tl::kSKA, kThreads>(A, R, m0, r0, m_end, R, vec & 1, buf,
                                                             R);
        stage_tile<T, kDepth, kBwdTn, Tl::kSK, kThreads>(B, n, m0, c0, m_end, n, vec & 2,
                                                            buf + kDepth * Tl::kSKA);
      },
      [&](int, const T* buf) {
        warp_product<T, kWarpMI, kWarpNT, kDepth, Tl::kSKA, Tl::kSK, true, true>(
            buf, row0, 0, buf + kDepth * Tl::kSKA, n0, acc);
      });
  float* out = partial + static_cast<size_t>(blockIdx.z) * (R + 1) * n;
#pragma unroll
  for (int q = 0; q < 2 * kWarpMI; ++q) {
    const int i = q >> 1, r = q & 1;
    const int row = r0 + row0 + 16 * i + g + 8 * r;
    if (row > R) continue;
#pragma unroll
    for (int j = 0; j < kWarpNT; ++j) {
      const int col = c0 + n0 + 8 * j + 2 * t;
      if (col < n) store_pair(out + static_cast<size_t>(row) * n, col, n, acc[i][j][2 * r],
                              acc[i][j][2 * r + 1]);
    }
  }
}

// 4. dw (R x n, T) and db (n, f32) = the sum of the splits' partials, in
// split order.
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

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > smem_optin()) return cudaErrorInvalidConfiguration;
  return allow_smem(kernel, smem);
}

template <typename T>
constexpr size_t kWgSmem = sizeof(T) * kBwdStages * BwdTiles<T>::kWgStage;

// Token ranges [A | 1]^T B (A (M, R), B (M, n)) is split into: the waves
// that about one range per 2,048 tokens (at most 16) would take on this
// card, filled whole with the blocks its occupancy allows (at M = 16,448
// for dW2 at ViT-S/14, 13 ranges in two full waves where 9 left a third of
// the second wave idle); at most one range per slice of tokens.
template <typename T>
int wgrad_splits(int M, int R, int n) {
  const int tiles = (R + 1 + kBwdTm - 1) / kBwdTm * ((n + kBwdTn - 1) / kBwdTn);
  int device = 0, sms = 0, per_sm = 0;
  if (prepare(wgrad_kernel<T>, kWgSmem<T>) != cudaSuccess ||
      cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wgrad_kernel<T>, kThreads,
                                                    kWgSmem<T>) != cudaSuccess) {
    return 0;
  }
  const int slots = sms * (per_sm > 0 ? per_sm : 1);
  const int nominal = std::min(16, std::max(1, (M + 2047) / 2048));
  const int waves = (tiles * nominal + slots - 1) / slots;
  const int most = (M + BwdTiles<T>::kDepth - 1) / BwdTiles<T>::kDepth;
  return std::max(1, std::min(waves * slots / tiles, most));
}

template <typename T>
cudaError_t wgrad(cudaStream_t stream, const T* A, const T* B, float* partial, T* dw, float* db,
                  int M, int R, int n, int splits) {
  constexpr size_t smem = kWgSmem<T>;
  cudaError_t err = prepare(wgrad_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int rows = (M + splits - 1) / splits;
  const dim3 grid((R + 1 + kBwdTm - 1) / kBwdTm, (n + kBwdTn - 1) / kBwdTn, splits);
  wgrad_kernel<T><<<grid, kThreads, smem, stream>>>(A, B, partial, M, R, n, rows,
                                                    vec16_ok<T>(A, R) | vec16_ok<T>(B, n) << 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(R + 1) * n;
  const size_t needed = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(needed < 4096 ? needed : 4096);
  wgrad_finalize_kernel<T><<<blocks, kThreads, 0, stream>>>(partial, splits, R, n, dw, db);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(cudaStream_t stream, const void* x_v, const void* w1_v, const float* b1,
                     const void* w2_v, const void* dout_v, void* dx_v, void* dw1, float* db1,
                     void* dw2, float* db2, void* g_v, void* dh_v, float* partial, int M,
                     int d_in, int d_h, int d_out, int splits1, int splits2) {
  using Tl = BwdTiles<T>;
  const T* x = static_cast<const T*>(x_v);
  const T* w1 = static_cast<const T*>(w1_v);
  const T* w2 = static_cast<const T*>(w2_v);
  const T* dout = static_cast<const T*>(dout_v);
  T* g = static_cast<T*>(g_v);
  T* dh = static_cast<T*>(dh_v);
  const int m_tiles = (M + kBwdTm - 1) / kBwdTm;
  constexpr size_t smem_token = sizeof(T) * kBwdStages * Tl::kTokenStage;
  cudaError_t err = prepare(mlp_bwd_token_kernel<T>, smem_token);
  if (err != cudaSuccess) return err;
  const int vec = vec16_ok<T>(x, d_in) | vec16_ok<T>(w1, d_h) << 1 |
                  vec16_ok<T>(w2, d_out) << 2 | vec16_ok<T>(dout, d_out) << 3 |
                  (vec16_ok<T>(g, d_h) & vec16_ok<T>(dh, d_h)) << 4;
  mlp_bwd_token_kernel<T><<<dim3(m_tiles, (d_h + kBwdTn - 1) / kBwdTn), kThreads, smem_token,
                            stream>>>(x, w1, b1, w2, dout, g, dh, M, d_in, d_h, d_out, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr size_t smem_dx = sizeof(T) * kBwdStages * Tl::kDxStage;
  if ((err = prepare(mlp_bwd_dx_kernel<T>, smem_dx)) != cudaSuccess) return err;
  mlp_bwd_dx_kernel<T><<<dim3(m_tiles, (d_in + kBwdTn - 1) / kBwdTn), kThreads, smem_dx,
                         stream>>>(dh, w1, static_cast<T*>(dx_v), M, d_in, d_h,
                                   vec16_ok<T>(dh, d_h) | vec16_ok<T>(w1, d_h) << 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  float* partial2 = partial + static_cast<size_t>(splits1) * (d_in + 1) * d_h;
  err = wgrad<T>(stream, x, dh, partial, static_cast<T*>(dw1), db1, M, d_in, d_h, splits1);
  if (err != cudaSuccess) return err;
  return wgrad<T>(stream, g, dout, partial2, static_cast<T*>(dw2), db2, M, d_h, d_out, splits2);
}

}  // namespace vit

extern "C" {

const char* vit_mlp_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Token ranges a weight gradient of R rows (one more for the bias) and n
// columns is split into for M tokens on the current device (bf16 != 0 for
// the bf16 kernel), or 0 if the device cannot be queried.
int vit_mlp_bwd_splits(int M, int R, int n, int bf16) {
  return bf16 ? vit::wgrad_splits<__nv_bfloat16>(M, R, n) : vit::wgrad_splits<float>(M, R, n);
}

// The K9 backward: x (M, d_in), w1 (d_in, d_h), w2 (d_h, d_out), dout (M,
// d_out), dx (M, d_in), dw1, dw2 and the scratch g, dh (M, d_h) in f32 or
// bf16 (bf16 != 0); b1 (d_h,), db1 (d_h,), db2 (d_out,) and partial
// (splits1 (d_in + 1) d_h + splits2 (d_h + 1) d_out) f32, the splits those
// of vit_mlp_bwd_splits for dW1 and dW2. Six launches on `stream`, no
// synchronization; returns the first error.
int vit_mlp_backward(const void* x, const void* w1, const void* b1, const void* w2,
                     const void* dout, void* dx, void* dw1, void* db1, void* dw2, void* db2,
                     void* g, void* dh, void* partial, int M, int d_in, int d_h, int d_out,
                     int splits1, int splits2, int bf16, void* stream) {
  if (M <= 0 || d_in <= 0 || d_h <= 0 || d_out <= 0 || splits1 <= 0 || splits1 > 65535 ||
      splits2 <= 0 || splits2 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bias = static_cast<const float*>(b1);
  float* p = static_cast<float*>(partial);
  float* d1 = static_cast<float*>(db1);
  float* d2 = static_cast<float*>(db2);
  return static_cast<int>(
      bf16 ? vit::backward<__nv_bfloat16>(st, x, w1, bias, w2, dout, dx, dw1, d1, dw2, d2, g, dh,
                                          p, M, d_in, d_h, d_out, splits1, splits2)
           : vit::backward<float>(st, x, w1, bias, w2, dout, dx, dw1, d1, dw2, d2, g, dh, p, M,
                                  d_in, d_h, d_out, splits1, splits2));
}

}  // extern "C"
