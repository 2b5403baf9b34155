// Device code shared by the fused Nadaraya-Watson kernels (nw_prepared.cu,
// nw_fused.cu, lab_nw.cu): tile shapes, small helpers, and the exact merge
// of a forward's support splits.
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
// softmax state is f32. Every forward's pass 1 is the tensor-core kernel
// of nw_pass1.cuh (K1 over raw rows, K2/K4/K5/K6 over prepared banks, the
// labs' L1 fused_variant and L3 manual_fused);
// its splits merge here (nw_merge_kernel). Over raw rows a query that is
// also a support row (common in training episodes) gets a distance of
// exactly 0, not the square root of rounding residue (about 1e-2 at
// ResNet-18's feature norms, which moved every log-prob of that query by
// as much): K1 and both passes of K3 take |q|^2 and s2_j by q.s's own
// products on the tensor cores (nw_tc.cuh's raw_slice). No kernel keeps an
// FFMA score tile any more (K3's ds moved to that route, L3 manual_fused
// to the pass); the class cap of every forward entry point still comes
// from that tile's layout (max_forward_classes).

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
constexpr int kMergeThreads = 128;
constexpr float kNeg = -FLT_MAX;  // jnp.finfo(float32).min, the JAX kernels' "-inf"
constexpr float kLogFloor = 1e-12f;

static_assert(kSupportTile == 64, "the softmax step gives each lane two columns");

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

// Shared memory of one FFMA score tile's staging buffers, in floats (the
// measure of max_forward_classes below).
constexpr int kTileSmemFloats = kQueryTile * kChunkStride     // query chunk
                                + kSupportTile * kChunkStride  // support chunk
                                + kSupportTile;                // self-norms s2

// The l2 distance of a score from its dot product (the expanded form the
// plain PyTorch versions use, clamped at 0 before the sqrt).
__device__ __forceinline__ float l2_dist(float q2, float dot, float s2) {
  return sqrtf(fmaxf(q2 - 2.f * dot + s2, 0.f));
}

// Shared memory of a forward block of the FFMA layout (16 queries' acc[C]
// beside one score tile's staging) for `n_classes` classes: the measure of
// max_forward_classes, the class cap every forward entry point has kept
// since the first port, below the 4,768 the tensor-core pass 1 would take
// at its 8-query tile.
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

// The shape checks both forward entry points share.
inline bool forward_args_ok(int B, int S, int D, int C, int n_splits, int rows_per_split) {
  return B > 0 && S > 0 && D > 0 && C > 0 && n_splits > 0 && rows_per_split > 0 &&
         static_cast<long long>(n_splits) * rows_per_split >= S &&
         n_splits <= 48 * 1024 / static_cast<int>(sizeof(float));
}

}  // namespace nw
