// Device code shared by the fused Nadaraya-Watson kernels (nw_prepared.cu,
// nw_fused.cu): tile shapes, the score tile, the forward pass over support
// splits and the exact merge of the splits.
//
// A forward pass computes, for each query b, over the support rows j:
//   l2 mode:  score = -sqrt(max(|q|^2 - 2 q.s_j + s2_j, 0))
//   dot mode: score = scale * q.s_j
//   rows with label -1 score NEG (masked), by selection: a masked row may
//   hold anything, NaN included, and its features load as 0
//   online softmax: m_new = max(m, max_j score); m_safe = m_new > NEG/2 ? m_new : 0
//                   alpha = m > NEG/2 ? exp(m - m_safe) : 0
//                   p_j = score_j > NEG/2 ? exp(score_j - m_safe) : 0
//                   l = l * alpha + sum_j p_j;  acc[y_j] = acc[y_j] * alpha + p_j
//   out[b, c] = log(acc[c] / max(l, 1e-30) + 1e-12)
// q and s share one dtype (f32 or bf16); products accumulate in f32 and the
// softmax state is f32. s2_j is either read from a prepared bank (K2) or
// computed here from the raw rows in f32 (K1). On raw rows |q|^2 and s2 are
// summed in the order of the dot products, so a query that is also a
// support row (common in training episodes) gets a distance of exactly 0,
// not the square root of rounding residue (about 1e-2 at ResNet-18's
// feature norms, which moved every log-prob of that query by as much).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

namespace nw {

constexpr int kQueryTile = 16;                 // queries per score tile
constexpr int kSupportTile = 64;               // support rows per score tile
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

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Shared memory of one score tile's staging buffers, in floats.
constexpr int kTileSmemFloats = kQueryTile * kChunkStride     // query chunk
                                + kSupportTile * kChunkStride  // support chunk
                                + kSupportTile;                // self-norms s2

// |q_b|^2 in f32 for the queries b0 .. b0 + kQueryTile - 1 (0 past B), one
// warp per query. The prepared bank's s2 is not summed in tile_dots' order,
// so the prepared forward takes this faster sum.
template <typename T>
__device__ __forceinline__ void query_norms(const T* __restrict__ q, int b0, int B, int D,
                                            float* __restrict__ q2) {
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x >> 5; b < kQueryTile; b += kWarps) {
    float sum = 0.f;
    if (b0 + b < B) {
      const T* row = q + static_cast<size_t>(b0 + b) * D;
      for (int k = lane; k < D; k += 32) {
        const float v = to_float(row[k]);
        sum = fmaf(v, v, sum);
      }
    }
    sum = warp_sum(sum);
    if (lane == 0) q2[b] = sum;
  }
}

// Query chunk load: queries b0 .. b0 + 15, features k0 .. k0 + 31, as f32;
// queries past B and features past D load as 0.
template <typename T>
__device__ __forceinline__ void load_query_chunk(const T* __restrict__ q, int b0, int B, int k0,
                                                 int D, float* __restrict__ q_chunk) {
#pragma unroll
  for (int i = 0; i < kQueryTile * kFeatChunk / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int b = e / kFeatChunk, k = e % kFeatChunk;
    float v = 0.f;
    if (b0 + b < B && k0 + k < D) v = to_float(q[static_cast<size_t>(b0 + b) * D + k0 + k]);
    q_chunk[b * kChunkStride + k] = v;
  }
}

// Support chunk load: rows t0 .. t0 + 63, features k0 .. k0 + 31, as f32.
// Rows past r_end and features past D load as 0; with kMaskRows, masked
// rows (label < 0) too, since raw rows may hold NaN there (a prepared bank
// has zeroed them already, and skips the test).
template <bool kMaskRows, typename T>
__device__ __forceinline__ void load_support_chunk(const T* __restrict__ s, int t0, int r_end,
                                                   int k0, int D, const int* __restrict__ labels,
                                                   float* __restrict__ s_chunk) {
#pragma unroll
  for (int i = 0; i < kSupportTile * kFeatChunk / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int j = e / kFeatChunk, k = e % kFeatChunk;
    float v = 0.f;
    if (t0 + j < r_end && k0 + k < D && (!kMaskRows || labels[t0 + j] >= 0)) {
      v = to_float(s[static_cast<size_t>(t0 + j) * D + k0 + k]);
    }
    s_chunk[j * kChunkStride + k] = v;
  }
}

// Labels of the rows t0 .. t0 + 63 into shared memory (-1 past r_end). The
// first synchronization of the tile_dots that follows makes them visible.
__device__ __forceinline__ void load_tile_labels(const int* __restrict__ labels, int t0,
                                                 int r_end, int* __restrict__ tile_labels) {
  if (threadIdx.x < kSupportTile) {
    const int row = t0 + threadIdx.x;
    tile_labels[threadIdx.x] = row < r_end ? labels[row] : -1;
  }
}

// A sum of squares of one shared-memory row chunk, accumulated in feature
// order: the order tile_dots accumulates q.s in.
__device__ __forceinline__ float chunk_norm(const float* __restrict__ row, float acc) {
  const float4* v = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int k4 = 0; k4 < kFeatChunk / 4; ++k4) {
    const float4 c = v[k4];
    acc = fmaf(c.x, c.x, acc);
    acc = fmaf(c.y, c.y, acc);
    acc = fmaf(c.z, c.z, acc);
    acc = fmaf(c.w, c.w, acc);
  }
  return acc;
}

// The dot products of one score tile: queries b0 .. b0 + 15 against support
// rows t0 .. t0 + 63. Thread tid owns query tq = tid / 16 and rows
// tr + 16 r (tr = tid % 16, r < 4); dot[r] is q_tq . s_row in f32. With
// self_norms, the rows' |s_j|^2 (0 for masked rows) land in s2 (shared,
// kSupportTile floats); with q2 != null, the queries' |q_b|^2 land there.
// Both sums run in the dot products' order, so a query equal to a support
// row gets |q|^2 - 2 q.s + |s|^2 = 0 exactly, not rounding residue.
// kMaskRows as in load_support_chunk. Ends synchronized.
template <bool kMaskRows, typename T>
__device__ __forceinline__ void tile_dots(const T* __restrict__ q, const T* __restrict__ s,
                                          int b0, int B, int t0, int r_end, int D,
                                          const int* __restrict__ labels, bool self_norms,
                                          float* __restrict__ q2, float* __restrict__ smem_tile,
                                          float (&dot)[kRowsPerThread]) {
  float* q_chunk = smem_tile;
  float* s_chunk = q_chunk + kQueryTile * kChunkStride;
  float* s2 = s_chunk + kSupportTile * kChunkStride;
  const int tid = threadIdx.x;
  const int tq = tid / kThreadsPerQuery;
  const int tr = tid % kThreadsPerQuery;
  float s2_acc = 0.f, q2_acc = 0.f;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) dot[r] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kFeatChunk) {
    load_query_chunk(q, b0, B, k0, D, q_chunk);
    load_support_chunk<kMaskRows>(s, t0, r_end, k0, D, labels, s_chunk);
    __syncthreads();
    if (self_norms && tid < kSupportTile) s2_acc = chunk_norm(s_chunk + tid * kChunkStride, s2_acc);
    if (q2 != nullptr && tid < kQueryTile) q2_acc = chunk_norm(q_chunk + tid * kChunkStride, q2_acc);
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
  if (self_norms && tid < kSupportTile) s2[tid] = s2_acc;
  if (q2 != nullptr && tid < kQueryTile) q2[tid] = q2_acc;
  if (self_norms || q2 != nullptr) __syncthreads();
}

// The l2 distance of a score from its dot product (the expanded form the
// plain PyTorch versions use, clamped at 0 before the sqrt).
__device__ __forceinline__ float l2_dist(float q2, float dot, float s2) {
  return sqrtf(fmaxf(q2 - 2.f * dot + s2, 0.f));
}

// Shared memory of one forward pass-1 block for `n_classes` classes.
inline size_t partials_smem_bytes(int n_classes) {
  return sizeof(float) * (static_cast<size_t>(kQueryTile) * n_classes  // acc
                          + kTileSmemFloats                            // tile staging
                          + kQueryTile * kSupportTile                  // scores, then p
                          + 3 * kQueryTile)                            // |q|^2, m, l
         + sizeof(int) * kSupportTile;                                 // tile labels
}

// Largest class count whose forward accumulator fits the device's shared memory.
inline int max_forward_classes(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess) {
    return 0;
  }
  const size_t fixed = partials_smem_bytes(0);
  if (static_cast<size_t>(optin) <= fixed) return 0;
  return static_cast<int>((optin - fixed) / (sizeof(float) * kQueryTile));
}

// Forward pass 1: block (x, y) = (query tile, support split). Writes the
// split's partials (m, l, acc). kRawSupport: s2 computed from the rows here
// and masked rows loaded as 0 (K1); otherwise s2 read from the prepared
// bank (K2). Four blocks per SM (64 registers a thread): the blocks do not
// prefetch, so the ones waiting on memory must be covered by others.
template <typename T, bool kRawSupport>
__global__ void __launch_bounds__(kThreads, 4)
nw_partials_kernel(const T* __restrict__ q, const T* __restrict__ s,
                   const float* __restrict__ s2, const int* __restrict__ labels,
                   const float* __restrict__ scale_ptr, int l2_mode,
                   int B, int S, int D, int C, int rows_per_split,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   float* __restrict__ acc_out) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  float* tile = acc + kQueryTile * C;
  float* prob = tile + kTileSmemFloats;
  float* q2 = prob + kQueryTile * kSupportTile;
  float* m_run = q2 + kQueryTile;
  float* l_run = m_run + kQueryTile;
  int* tile_labels = reinterpret_cast<int*>(l_run + kQueryTile);
  const float* s2_tile = tile + kQueryTile * kChunkStride + kSupportTile * kChunkStride;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b0 = blockIdx.x * kQueryTile;
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(S, r_begin + rows_per_split);
  const float scale = *scale_ptr;

  for (int i = tid; i < kQueryTile * C; i += kThreads) acc[i] = 0.f;
  if (!kRawSupport) query_norms(q, b0, B, D, q2);
  if (tid < kQueryTile) {
    m_run[tid] = kNeg;
    l_run[tid] = 0.f;
  }
  __syncthreads();

  const int tq = tid / kThreadsPerQuery;
  const int tr = tid % kThreadsPerQuery;
  const bool self_norms = kRawSupport && l2_mode;

  for (int t0 = r_begin; t0 < r_end; t0 += kSupportTile) {
    load_tile_labels(labels, t0, r_end, tile_labels);
    float dot[kRowsPerThread];
    tile_dots<kRawSupport>(q, s, b0, B, t0, r_end, D, labels, self_norms,
                           kRawSupport && t0 == r_begin ? q2 : nullptr, tile, dot);

#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int j = tr + kThreadsPerQuery * r;
      float score = kNeg;
      if (tile_labels[j] >= 0) {
        if (l2_mode) {
          score = -l2_dist(q2[tq], dot[r], kRawSupport ? s2_tile[j] : s2[t0 + j]);
        } else {
          score = dot[r] * scale;
        }
      }
      prob[tq * kSupportTile + j] = score;
    }
    __syncthreads();

    // Online softmax and label sum: warp w owns queries w and w + 8. Lane
    // (y mod 32) adds every p_j of class y, so each class has one writer:
    // no atomics, and the order of the sum is fixed.
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
        if (y >= 0 && y < C && (y & 31) == lane) acc_row[y] += row[j];
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

// sum_{p < n} x[p * stride] (times w[p] with kWeighted), added in the order
// p = 0, 1, ... as a plain loop adds them, with kSplitBatch loads issued
// before they are summed: a loop over splits is otherwise one memory
// latency per split.
constexpr int kSplitBatch = 8;

template <bool kWeighted>
__device__ __forceinline__ float split_sum(const float* __restrict__ x, size_t stride, int n,
                                           const float* __restrict__ w) {
  float acc = 0.f;
  int p = 0;
  for (; p + kSplitBatch <= n; p += kSplitBatch) {
    float v[kSplitBatch];
#pragma unroll
    for (int u = 0; u < kSplitBatch; ++u) v[u] = x[static_cast<size_t>(p + u) * stride];
#pragma unroll
    for (int u = 0; u < kSplitBatch; ++u) acc += kWeighted ? v[u] * w[p + u] : v[u];
  }
  for (; p < n; ++p) acc += kWeighted ? x[static_cast<size_t>(p) * stride] * w[p]
                                      : x[static_cast<size_t>(p) * stride];
  return acc;
}

// Forward pass 2: one block per query; exact merge of the splits (as
// nwhead_tpu/parallel/sharded_bank.py:merge_partials does), then, with
// kFinalize, the log. m_final / l_final (may be null) receive the merged
// softmax statistics. Without kFinalize, out receives the merged label sums
// unfinalized (relative to m_final, as l_final is): the partials a caller
// merges across support shards (K1/K2/K4/K5/K6 partials=True). The
// finalizing instantiation compiles as the kernel did before the partials
// route existed.
template <bool kFinalize>
__global__ void __launch_bounds__(kMergeThreads)
nw_merge_kernel(const float* __restrict__ m_in, const float* __restrict__ l_in,
                const float* __restrict__ acc_in, int n_splits, int B, int C,
                float* __restrict__ out, float* __restrict__ m_final,
                float* __restrict__ l_final) {
  extern __shared__ float weight[];  // n_splits
  const int b = blockIdx.x;
  float m_g = kNeg;
  for (int p = 0; p < n_splits; ++p) m_g = fmaxf(m_g, m_in[static_cast<size_t>(p) * B + b]);
  for (int p = threadIdx.x; p < n_splits; p += blockDim.x) {
    const float m = m_in[static_cast<size_t>(p) * B + b];
    weight[p] = m > kNeg / 2 ? expf(m - m_g) : 0.f;
  }
  __syncthreads();
  const float l_g = split_sum<true>(l_in + b, B, n_splits, weight);
  if constexpr (!kFinalize) {
    // Written before the class loop: written after it (as the finalizing
    // instantiation does), the partials route ran a few microseconds slower
    // than the finalizing one on an H100, its l sum left to thread 0 after
    // the loop.
    if (threadIdx.x == 0 && m_final != nullptr) {
      m_final[b] = m_g;
      l_final[b] = l_g;
    }
  }
  const float inv_l = 1.f / fmaxf(l_g, 1e-30f);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float a = split_sum<true>(acc_in + static_cast<size_t>(b) * C + c,
                                    static_cast<size_t>(B) * C, n_splits, weight);
    out[static_cast<size_t>(b) * C + c] = kFinalize ? logf(a * inv_l + kLogFloor) : a;
  }
  if (kFinalize && threadIdx.x == 0 && m_final != nullptr) {
    m_final[b] = m_g;
    l_final[b] = l_g;
  }
}

// Forward pass 2 on `stream`: the merged partials unfinalized (partials:
// out receives acc, m_final / l_final the statistics) or the log-probs.
inline cudaError_t launch_merge(cudaStream_t stream, bool partials, const void* m_part,
                                const void* l_part, const void* acc_part, int n_splits, int B,
                                int C, void* out, void* m_final, void* l_final) {
  const size_t smem = n_splits * sizeof(float);
  const float* m_in = static_cast<const float*>(m_part);
  const float* l_in = static_cast<const float*>(l_part);
  const float* acc_in = static_cast<const float*>(acc_part);
  if (partials) {
    nw_merge_kernel<false><<<B, kMergeThreads, smem, stream>>>(
        m_in, l_in, acc_in, n_splits, B, C, static_cast<float*>(out),
        static_cast<float*>(m_final), static_cast<float*>(l_final));
  } else {
    nw_merge_kernel<true><<<B, kMergeThreads, smem, stream>>>(
        m_in, l_in, acc_in, n_splits, B, C, static_cast<float*>(out),
        static_cast<float*>(m_final), static_cast<float*>(l_final));
  }
  return cudaGetLastError();
}

// Pass 1 then pass 2 of the forward on `stream`; returns cudaGetLastError().
template <typename T, bool kRawSupport>
cudaError_t launch_forward(cudaStream_t stream, const void* q, const void* s, const void* s2,
                           const void* labels, const void* scale, int l2_mode, int B, int S,
                           int D, int C, int n_splits, int rows_per_split, void* m_part,
                           void* l_part, void* acc_part, void* out, void* m_final,
                           void* l_final, bool partials) {
  const dim3 grid((B + kQueryTile - 1) / kQueryTile, n_splits);
  const size_t smem = partials_smem_bytes(C);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nw_partials_kernel<T, kRawSupport>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  nw_partials_kernel<T, kRawSupport><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(s), static_cast<const float*>(s2),
      static_cast<const int*>(labels), static_cast<const float*>(scale), l2_mode, B, S, D, C,
      rows_per_split, static_cast<float*>(m_part), static_cast<float*>(l_part),
      static_cast<float*>(acc_part));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge(stream, partials, m_part, l_part, acc_part, n_splits, B, C, out, m_final,
                      l_final);
}

// The shape checks both forward entry points share.
inline bool forward_args_ok(int B, int S, int D, int C, int n_splits, int rows_per_split) {
  return B > 0 && S > 0 && D > 0 && C > 0 && n_splits > 0 && rows_per_split > 0 &&
         static_cast<long long>(n_splits) * rows_per_split >= S &&
         n_splits <= 48 * 1024 / static_cast<int>(sizeof(float));
}

}  // namespace nw
