// Fused Nadaraya-Watson head over a prepared support bank, for Hopper (sm_90a).
//
// Replaces the TPU kernel nwhead_tpu/ops/pallas_nw.py:_nw_prepared_kernel
// (f32 and bf16 banks). For each query b it computes, in one pass over the
// bank rows j:
//   l2 mode:  score = -sqrt(max(|q|^2 - 2 q.s_j + s2_j, 0))
//   dot mode: score = scale * q.s_j
//   rows with label -1 score NEG (masked; in l2 mode their s2 is 1e30 too)
//   online softmax: m_new = max(m, max_j score); m_safe = m_new > NEG/2 ? m_new : 0
//                   alpha = m > NEG/2 ? exp(m - m_safe) : 0
//                   p_j = score_j > NEG/2 ? exp(score_j - m_safe) : 0
//                   l = l * alpha + sum_j p_j;  acc[y_j] = acc[y_j] * alpha + p_j
//   out[b, c] = log(acc[c] / max(l, 1e-30) + 1e-12)
// A bf16 bank takes a bf16 query; products accumulate in f32 and the softmax
// state is f32.
//
// What bounds it: at serving batches (B = 64) the bank is read once per
// query tile, S * D * 4 bytes for f32 (12.3 MB at S = 5994, D = 512), about
// 4 us at the card's 3.35 TB/s, while the score products are 2 * B * S * D
// flops (0.39 GFLOP at that shape), about 6 us at the 67 TFLOP/s f32 rate
// outside the tensor cores. So neither the bytes nor the flops leave room
// for a pass that keeps few SMs busy. The design:
//   * Pass 1 runs on a grid of (query tiles of 16) x (support splits); the
//     wrapper picks the split count so the grid holds about 8 blocks per SM,
//     which hides the memory latency of blocks that do not prefetch. Each
//     block streams its rows through shared memory in tiles of 64 rows x 32
//     features, scores them with f32 FMAs from float4 shared-memory reads
//     (4 score accumulators per thread), and keeps the per-query (m, l) and
//     an acc[16][C] in shared memory. It writes partials (m, l, acc) per
//     split. Query tiles re-read the bank from L2 (50 MB), not from device
//     memory.
//   * The label sum writes straight into acc[b][y]: lane (y mod 32) of the
//     warp that owns query b adds p_j for every row j of the tile, so each
//     class has one writer. No atomics, and the order of the sum is fixed.
//   * Pass 2 merges the splits exactly, as
//     nwhead_tpu/parallel/sharded_bank.py:merge_partials does, and takes the
//     log.
// Tensor cores (wgmma) and TMA are left for later: this is the simple first
// version of the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

namespace {

constexpr int kQueryTile = 16;                 // queries per block
constexpr int kSupportTile = 64;               // support rows per tile
constexpr int kFeatChunk = 32;                 // features per shared-memory chunk
constexpr int kChunkStride = kFeatChunk + 4;   // padded row stride in floats
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kThreadsPerQuery = kThreads / kQueryTile;           // 16
constexpr int kRowsPerThread = kSupportTile / kThreadsPerQuery;   // 4
constexpr int kMergeThreads = 128;
constexpr float kNeg = -FLT_MAX;  // jnp.finfo(float32).min, the JAX kernels' "-inf"
constexpr float kLogFloor = 1e-12f;

static_assert(kSupportTile == 64, "the softmax step gives each lane two columns");
static_assert((kQueryTile * kFeatChunk) % kThreads == 0, "query chunk load");
static_assert((kSupportTile * kFeatChunk) % kThreads == 0, "support chunk load");
static_assert(kChunkStride % 4 == 0, "float4 reads need 16-byte aligned rows");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

size_t partials_smem_bytes(int n_classes) {
  return sizeof(float) * (static_cast<size_t>(kQueryTile) * n_classes  // acc
                          + kQueryTile * kChunkStride                  // query chunk
                          + kSupportTile * kChunkStride                // support chunk
                          + kQueryTile * kSupportTile                  // scores, then p
                          + 3 * kQueryTile)                            // |q|^2, m, l
         + sizeof(int) * kSupportTile;                                 // tile labels
}

// Pass 1: block (x, y) = (query tile, support split).
template <typename T>
__global__ void __launch_bounds__(kThreads)
nw_partials_kernel(const T* __restrict__ q, const T* __restrict__ s,
                   const float* __restrict__ s2, const int* __restrict__ labels,
                   const float* __restrict__ scale_ptr, int l2_mode,
                   int B, int S, int D, int C, int rows_per_split,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   float* __restrict__ acc_out) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  float* q_chunk = acc + kQueryTile * C;
  float* s_chunk = q_chunk + kQueryTile * kChunkStride;
  float* prob = s_chunk + kSupportTile * kChunkStride;
  float* q2 = prob + kQueryTile * kSupportTile;
  float* m_run = q2 + kQueryTile;
  float* l_run = m_run + kQueryTile;
  int* tile_labels = reinterpret_cast<int*>(l_run + kQueryTile);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b0 = blockIdx.x * kQueryTile;
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(S, r_begin + rows_per_split);
  const float scale = *scale_ptr;

  for (int i = tid; i < kQueryTile * C; i += kThreads) acc[i] = 0.f;
  for (int b = warp; b < kQueryTile; b += kWarps) {
    float sum = 0.f;
    if (b0 + b < B) {
      const T* row = q + static_cast<size_t>(b0 + b) * D;
      for (int k = lane; k < D; k += 32) {
        const float v = to_float(row[k]);
        sum = fmaf(v, v, sum);
      }
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      q2[b] = sum;
      m_run[b] = kNeg;
      l_run[b] = 0.f;
    }
  }
  __syncthreads();

  // Score layout: thread -> query tq, support rows tr + 16 r (r < 4).
  const int tq = tid / kThreadsPerQuery;
  const int tr = tid % kThreadsPerQuery;

  for (int t0 = r_begin; t0 < r_end; t0 += kSupportTile) {
    float dot[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) dot[r] = 0.f;

    for (int k0 = 0; k0 < D; k0 += kFeatChunk) {
#pragma unroll
      for (int i = 0; i < kQueryTile * kFeatChunk / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int b = e / kFeatChunk, k = e % kFeatChunk;
        float v = 0.f;
        if (b0 + b < B && k0 + k < D) v = to_float(q[static_cast<size_t>(b0 + b) * D + k0 + k]);
        q_chunk[b * kChunkStride + k] = v;
      }
#pragma unroll
      for (int i = 0; i < kSupportTile * kFeatChunk / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int j = e / kFeatChunk, k = e % kFeatChunk;
        float v = 0.f;
        if (t0 + j < r_end && k0 + k < D) v = to_float(s[static_cast<size_t>(t0 + j) * D + k0 + k]);
        s_chunk[j * kChunkStride + k] = v;
      }
      __syncthreads();
      const float4* qv = reinterpret_cast<const float4*>(q_chunk + tq * kChunkStride);
#pragma unroll
      for (int k4 = 0; k4 < kFeatChunk / 4; ++k4) {
        const float4 a = qv[k4];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          const float4 c = reinterpret_cast<const float4*>(
              s_chunk + (tr + kThreadsPerQuery * r) * kChunkStride)[k4];
          dot[r] = fmaf(a.x, c.x, dot[r]);
          dot[r] = fmaf(a.y, c.y, dot[r]);
          dot[r] = fmaf(a.z, c.z, dot[r]);
          dot[r] = fmaf(a.w, c.w, dot[r]);
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int j = tr + kThreadsPerQuery * r;
      const int row = t0 + j;
      float score = kNeg;
      if (row < r_end && labels[row] >= 0) {
        if (l2_mode) {
          score = -sqrtf(fmaxf(q2[tq] - 2.f * dot[r] + s2[row], 0.f));
        } else {
          score = dot[r] * scale;
        }
      }
      prob[tq * kSupportTile + j] = score;
    }
    if (tid < kSupportTile) tile_labels[tid] = t0 + tid < r_end ? labels[t0 + tid] : -1;
    __syncthreads();

    // Online softmax and label sum: warp w owns queries w and w + 8.
    for (int b = warp; b < kQueryTile; b += kWarps) {
      float* row = prob + b * kSupportTile;
      const float m_prev = m_run[b];
      const float s0 = row[lane];
      const float s1 = row[lane + 32];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float m_safe = m_new > kNeg / 2 ? m_new : 0.f;
      const float alpha = m_prev > kNeg / 2 ? expf(m_prev - m_safe) : 0.f;
      const float p0 = s0 > kNeg / 2 ? expf(s0 - m_safe) : 0.f;
      const float p1 = s1 > kNeg / 2 ? expf(s1 - m_safe) : 0.f;
      const float p_sum = warp_sum(p0 + p1);
      row[lane] = p0;
      row[lane + 32] = p1;
      __syncwarp();
      float* acc_row = acc + b * C;
      for (int c = lane; c < C; c += 32) acc_row[c] *= alpha;
      for (int j = 0; j < kSupportTile; ++j) {
        const int y = tile_labels[j];
        if (y >= 0 && (y & 31) == lane) acc_row[y] += row[j];
      }
      if (lane == 0) {
        m_run[b] = m_new;
        l_run[b] = l_run[b] * alpha + p_sum;
      }
      __syncwarp();
    }
    __syncthreads();
  }

  for (int i = tid; i < kQueryTile * C; i += kThreads) {
    const int b = i / C;
    if (b0 + b < B) {
      acc_out[(static_cast<size_t>(split) * B + b0 + b) * C + i % C] = acc[i];
    }
  }
  if (tid < kQueryTile && b0 + tid < B) {
    m_out[static_cast<size_t>(split) * B + b0 + tid] = m_run[tid];
    l_out[static_cast<size_t>(split) * B + b0 + tid] = l_run[tid];
  }
}

// Pass 2: one block per query; exact merge of the splits, then the log.
__global__ void __launch_bounds__(kMergeThreads)
nw_merge_kernel(const float* __restrict__ m_in, const float* __restrict__ l_in,
                const float* __restrict__ acc_in, int n_splits, int B, int C,
                float* __restrict__ out) {
  extern __shared__ float weight[];  // n_splits
  const int b = blockIdx.x;
  float m_g = kNeg;
  for (int p = 0; p < n_splits; ++p) m_g = fmaxf(m_g, m_in[static_cast<size_t>(p) * B + b]);
  for (int p = threadIdx.x; p < n_splits; p += blockDim.x) {
    const float m = m_in[static_cast<size_t>(p) * B + b];
    weight[p] = m > kNeg / 2 ? expf(m - m_g) : 0.f;
  }
  __syncthreads();
  float l_g = 0.f;
  for (int p = 0; p < n_splits; ++p) l_g += l_in[static_cast<size_t>(p) * B + b] * weight[p];
  const float inv_l = 1.f / fmaxf(l_g, 1e-30f);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f;
    for (int p = 0; p < n_splits; ++p) {
      a += acc_in[(static_cast<size_t>(p) * B + b) * C + c] * weight[p];
    }
    out[static_cast<size_t>(b) * C + c] = logf(a * inv_l + kLogFloor);
  }
}

template <typename T>
cudaError_t launch_partials(dim3 grid, size_t smem, cudaStream_t stream,
                            const void* q, const void* s, const void* s2,
                            const void* labels, const void* scale, int l2_mode,
                            int B, int S, int D, int C, int rows_per_split,
                            void* m_part, void* l_part, void* acc_part) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nw_partials_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  nw_partials_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(s),
      static_cast<const float*>(s2), static_cast<const int*>(labels),
      static_cast<const float*>(scale), l2_mode, B, S, D, C, rows_per_split,
      static_cast<float*>(m_part), static_cast<float*>(l_part),
      static_cast<float*>(acc_part));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int nw_prepared_query_tile() { return kQueryTile; }

int nw_prepared_support_tile() { return kSupportTile; }

// Dynamic shared memory of one pass-1 block for `n_classes` classes.
int nw_prepared_smem_bytes(int n_classes) {
  return static_cast<int>(partials_smem_bytes(n_classes));
}

// Largest class count whose accumulator fits the device's shared memory.
int nw_prepared_max_classes(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess) {
    return 0;
  }
  const size_t fixed = partials_smem_bytes(0);
  if (static_cast<size_t>(optin) <= fixed) return 0;
  return static_cast<int>((optin - fixed) / (sizeof(float) * kQueryTile));
}

const char* nw_prepared_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, D), s (S, D) in f32 or bf16 (bf16 != 0); s2 (S,) f32 (l2 mode only,
// may be null otherwise); labels (S,) int32, -1 = masked; scale (1,) f32;
// partials m, l (n_splits, B) and acc (n_splits, B, C) f32 scratch; out (B, C)
// f32. Launches on `stream`, does not synchronize, returns cudaGetLastError().
int nw_prepared_forward(const void* q, const void* s, const void* s2,
                        const void* labels, const void* scale, void* m_part,
                        void* l_part, void* acc_part, void* out, int B, int S,
                        int D, int C, int l2_mode, int bf16, int n_splits,
                        int rows_per_split, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || C <= 0 || n_splits <= 0 || rows_per_split <= 0 ||
      static_cast<long long>(n_splits) * rows_per_split < S ||
      n_splits > 48 * 1024 / static_cast<int>(sizeof(float)) || (l2_mode && s2 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C > nw_prepared_max_classes(device)) return static_cast<int>(cudaErrorInvalidValue);

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + kQueryTile - 1) / kQueryTile, n_splits);
  const size_t smem = partials_smem_bytes(C);
  err = bf16 ? launch_partials<__nv_bfloat16>(grid, smem, st, q, s, s2, labels, scale,
                                              l2_mode, B, S, D, C, rows_per_split,
                                              m_part, l_part, acc_part)
             : launch_partials<float>(grid, smem, st, q, s, s2, labels, scale, l2_mode,
                                      B, S, D, C, rows_per_split, m_part, l_part,
                                      acc_part);
  if (err != cudaSuccess) return static_cast<int>(err);
  nw_merge_kernel<<<B, kMergeThreads, n_splits * sizeof(float), st>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float*>(acc_part), n_splits, B, C, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
