// Fused Nadaraya-Watson head over raw support features, forward and
// backward, for Hopper (sm_90a): the training path.
//
// Replaces the TPU kernels of nwhead_tpu/ops/pallas_nw.py:
//   K1  _nw_fwd_kernel      -> nw_fused_forward: the pass of nw_common.cuh
//       with the self-norms s2_j computed here from the raw rows, writing
//       the log-probs and the final softmax statistics (m, l) per query;
//   K3  _nw_bwd_dq_kernel   -> nw_fused_bwd_dq, and
//       _nw_bwd_ds_kernel   -> nw_fused_bwd_ds.
// The backward recomputes each score tile from (m, l), flash style:
//   w_bj = exp(score_bj - m_safe_b) / max(l_b, 1e-30)
//   dscore_bj = w_bj * (u[b, y_j] - r_b)      (u, r from the upstream gradient)
//   l2 mode:  t_bj = dscore_bj / dist_bj (0 where dist == 0)
//             dq_b = sum_j t_bj s_j - q_b sum_j t_bj
//             ds_j = sum_b t_bj q_b - s_j sum_b t_bj
//   dot mode: dq_b = scale * sum_j dscore_bj s_j;  ds_j = scale * sum_b dscore_bj q_b
// Gradients are written in the input dtype; every sum is f32. Masked rows
// (label -1) load as 0 and get t = 0, so their NaN never reaches a product;
// their ds is 0.
//
// What bounds them: at the training episode (B = 8, S = 1200, D = 512) each
// pass does 2 to 4 * B * S * D = 10-20 MFLOP and moves about 2.5 MB of f32,
// a few microseconds of the card at best; at B = 64, S = 5994 the forward
// needs 0.39 GFLOP and 12.3 MB, each backward pass 0.79 GFLOP (recompute
// plus product), so the f32 FMA rate (67 TFLOP/s) bounds them. With B this
// small there is one query tile, so parallelism comes from the support:
//   * K1 splits S across blocks and merges the splits exactly (the K2 design).
//   * dq splits S across blocks too. Each block keeps sum_j t s_j for its
//     16 queries in shared memory (16 x D floats) and writes it with
//     sum_j t as a per-split partial; a second kernel sums the splits in a
//     fixed order. No float atomics: the gradient is the same on every run.
//   * ds gives each block 64 support rows and loops over every query tile,
//     keeping t for all B queries of its rows in shared memory (B x 64
//     floats); then it writes its rows' gradient, which no other block
//     touches.
// The score tile (16 queries x 64 rows, f32 FMAs from shared memory) is the
// forward's; tensor cores and TMA are later work.

#include "nw_common.cuh"

namespace {

using namespace nw;

constexpr int kStatFloats = 4 * kQueryTile;  // |q|^2, m_safe, max(l, 1e-30), r

// The per-query statistics of one query tile after |q|^2 (which tile_dots
// writes to stats[0 .. 15]): m_safe, max(l, 1e-30) and r (neutral past B).
// The caller synchronizes.
__device__ __forceinline__ void load_backward_stats(const float* __restrict__ m,
                                                    const float* __restrict__ l,
                                                    const float* __restrict__ r, int b0, int B,
                                                    float* __restrict__ stats) {
  const int i = threadIdx.x;
  if (i < kQueryTile) {
    const int b = b0 + i;
    float m_safe = 0.f, l_cl = 1.f, r_b = 0.f;
    if (b < B) {
      m_safe = m[b] > kNeg / 2 ? m[b] : 0.f;
      l_cl = fmaxf(l[b], 1e-30f);
      r_b = r[b];
    }
    stats[kQueryTile + i] = m_safe;
    stats[2 * kQueryTile + i] = l_cl;
    stats[3 * kQueryTile + i] = r_b;
  }
}

// t (l2 mode) or dscore (dot mode) of one score tile into tbuf[16][64].
__device__ __forceinline__ void tile_grads(const float (&dot)[kRowsPerThread],
                                           const int* __restrict__ tile_labels,
                                           const float* __restrict__ s2_tile,
                                           const float* __restrict__ stats,
                                           const float* __restrict__ u, int b0, int B, int C,
                                           int l2_mode, float scale, float* __restrict__ tbuf) {
  const int tq = threadIdx.x / kThreadsPerQuery;
  const int tr = threadIdx.x % kThreadsPerQuery;
  const int b = b0 + tq;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int j = tr + kThreadsPerQuery * r;
    const int y = tile_labels[j];
    float t = 0.f;
    if (y >= 0 && b < B) {
      float score, dist = 0.f;
      if (l2_mode) {
        dist = l2_dist(stats[tq], dot[r], s2_tile[j]);
        score = -dist;
      } else {
        score = dot[r] * scale;
      }
      const float w = score > kNeg / 2
                          ? expf(score - stats[kQueryTile + tq]) / stats[2 * kQueryTile + tq]
                          : 0.f;
      const float uy = y < C ? u[static_cast<size_t>(b) * C + y] : 0.f;
      const float dscore = w * (uy - stats[3 * kQueryTile + tq]);
      t = l2_mode ? (dist > 0.f ? dscore / dist : 0.f) : dscore;
    }
    tbuf[tq * kSupportTile + j] = t;
  }
}

size_t dq_smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(kTileSmemFloats)   // tile staging
                          + kQueryTile * kSupportTile            // t of the tile
                          + kStatFloats + kQueryTile             // stats, sum_j t
                          + static_cast<size_t>(kQueryTile) * D)  // sum_j t s_j
         + sizeof(int) * kSupportTile;
}

size_t ds_smem_bytes(int B) {
  const size_t b_pad = static_cast<size_t>((B + kQueryTile - 1) / kQueryTile) * kQueryTile;
  return sizeof(float) * (kTileSmemFloats + kStatFloats + kSupportTile  // staging, stats, colsum
                          + b_pad * kSupportTile)                      // t of all queries
         + sizeof(int) * kSupportTile;
}

int optin_smem(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess) {
    return 0;
  }
  return optin;
}

// dq pass 1: block (x, y) = (query tile, support split). Writes
// ts_out[split, b, :] = sum_j t_bj s_j and tsum_out[split, b] = sum_j t_bj
// (dot mode: sum_j dscore_bj s_j; tsum unused).
template <typename T>
__global__ void __launch_bounds__(kThreads)
nw_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ s,
                 const int* __restrict__ labels, const float* __restrict__ u,
                 const float* __restrict__ r, const float* __restrict__ m,
                 const float* __restrict__ l, const float* __restrict__ scale_ptr, int l2_mode,
                 int B, int S, int D, int C, int rows_per_split, float* __restrict__ ts_out,
                 float* __restrict__ tsum_out) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  float* s_chunk = tile + kQueryTile * kChunkStride;
  const float* s2_tile = s_chunk + kSupportTile * kChunkStride;
  float* tbuf = tile + kTileSmemFloats;
  float* stats = tbuf + kQueryTile * kSupportTile;
  float* tsum = stats + kStatFloats;
  float* acc = tsum + kQueryTile;
  int* tile_labels = reinterpret_cast<int*>(acc + kQueryTile * D);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b0 = blockIdx.x * kQueryTile;
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(S, r_begin + rows_per_split);
  const float scale = *scale_ptr;

  for (int i = tid; i < kQueryTile * D; i += kThreads) acc[i] = 0.f;
  if (tid < kQueryTile) tsum[tid] = 0.f;
  load_backward_stats(m, l, r, b0, B, stats);
  __syncthreads();

  for (int t0 = r_begin; t0 < r_end; t0 += kSupportTile) {
    load_tile_labels(labels, t0, r_end, tile_labels);
    float dot[kRowsPerThread];
    tile_dots<true>(q, s, b0, B, t0, r_end, D, labels, l2_mode != 0,
                    t0 == r_begin ? stats : nullptr, tile, dot);
    tile_grads(dot, tile_labels, s2_tile, stats, u, b0, B, C, l2_mode, scale, tbuf);
    __syncthreads();
    if (l2_mode) {
      for (int b = warp; b < kQueryTile; b += kWarps) {
        const float v = warp_sum(tbuf[b * kSupportTile + lane] +
                                 tbuf[b * kSupportTile + lane + 32]);
        if (lane == 0) tsum[b] += v;
      }
    }
    // acc[b][k] += sum_j t_bj s_jk, one (b, k) per thread and chunk pass.
    for (int k0 = 0; k0 < D; k0 += kFeatChunk) {
      load_support_chunk<true>(s, t0, r_end, k0, D, labels, s_chunk);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kQueryTile * kFeatChunk / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int b = e / kFeatChunk, kk = e % kFeatChunk;
        if (k0 + kk < D) {
          float sum = 0.f;
#pragma unroll 8
          for (int j = 0; j < kSupportTile; ++j) {
            sum = fmaf(tbuf[b * kSupportTile + j], s_chunk[j * kChunkStride + kk], sum);
          }
          acc[b * D + k0 + kk] += sum;
        }
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < kQueryTile * D; i += kThreads) {
    const int b = i / D;
    if (b0 + b < B) ts_out[(static_cast<size_t>(split) * B + b0 + b) * D + i % D] = acc[i];
  }
  if (tid < kQueryTile && b0 + tid < B) tsum_out[static_cast<size_t>(split) * B + b0 + tid] = tsum[tid];
}

// dq pass 2: one block per query; sums the splits in order.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
nw_bwd_dq_merge_kernel(const T* __restrict__ q, const float* __restrict__ ts,
                       const float* __restrict__ tsum, const float* __restrict__ scale_ptr,
                       int l2_mode, int n_splits, int B, int D, T* __restrict__ dq) {
  const int b = blockIdx.x;
  const float t_total = l2_mode ? split_sum<false>(tsum + b, B, n_splits, nullptr) : 0.f;
  const float scale = *scale_ptr;
  for (int k = threadIdx.x; k < D; k += blockDim.x) {
    const size_t at = static_cast<size_t>(b) * D + k;
    const float a = split_sum<false>(ts + at, static_cast<size_t>(B) * D, n_splits, nullptr);
    dq[at] = from_float<T>(l2_mode ? a - to_float(q[at]) * t_total : scale * a);
  }
}

// ds: one block per 64 support rows, looping over every query tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
nw_bwd_ds_kernel(const T* __restrict__ q, const T* __restrict__ s,
                 const int* __restrict__ labels, const float* __restrict__ u,
                 const float* __restrict__ r, const float* __restrict__ m,
                 const float* __restrict__ l, const float* __restrict__ scale_ptr, int l2_mode,
                 int B, int S, int D, int C, T* __restrict__ ds) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  float* q_chunk = tile;
  const float* s2_tile = tile + kQueryTile * kChunkStride + kSupportTile * kChunkStride;
  float* stats = tile + kTileSmemFloats;
  float* colsum = stats + kStatFloats;
  float* t_all = colsum + kSupportTile;  // [n_qt * 16][64]
  const int n_qt = (B + kQueryTile - 1) / kQueryTile;
  int* tile_labels = reinterpret_cast<int*>(t_all + n_qt * kQueryTile * kSupportTile);

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kSupportTile;
  const int r_end = min(S, t0 + kSupportTile);
  const float scale = *scale_ptr;

  load_tile_labels(labels, t0, r_end, tile_labels);
  for (int qt = 0; qt < n_qt; ++qt) {
    const int b0 = qt * kQueryTile;
    load_backward_stats(m, l, r, b0, B, stats);
    float dot[kRowsPerThread];
    // The rows' self-norms are computed on the first query tile and kept.
    tile_dots<true>(q, s, b0, B, t0, r_end, D, labels, l2_mode != 0 && qt == 0, stats, tile,
                    dot);
    tile_grads(dot, tile_labels, s2_tile, stats, u, b0, B, C, l2_mode, scale,
               t_all + qt * kQueryTile * kSupportTile);
    __syncthreads();
  }
  if (tid < kSupportTile) {
    float sum = 0.f;
    if (l2_mode) {
      for (int b = 0; b < B; ++b) sum += t_all[b * kSupportTile + tid];
    }
    colsum[tid] = sum;
  }
  __syncthreads();

  // ds[j][k] = sum_b t_bj q_bk (- s_jk colsum_j): thread -> rows tid/32 + 8 i,
  // feature lane; q streams through shared memory 16 queries at a time.
  constexpr int kOut = kSupportTile * kFeatChunk / kThreads;  // 8
  for (int k0 = 0; k0 < D; k0 += kFeatChunk) {
    float acc[kOut];
#pragma unroll
    for (int i = 0; i < kOut; ++i) acc[i] = 0.f;
    for (int qt = 0; qt < n_qt; ++qt) {
      load_query_chunk(q, qt * kQueryTile, B, k0, D, q_chunk);
      __syncthreads();
      const float* t_qt = t_all + qt * kQueryTile * kSupportTile;
#pragma unroll
      for (int i = 0; i < kOut; ++i) {
        const int e = tid + i * kThreads;
        const int j = e / kFeatChunk, kk = e % kFeatChunk;
#pragma unroll
        for (int bb = 0; bb < kQueryTile; ++bb) {
          acc[i] = fmaf(t_qt[bb * kSupportTile + j], q_chunk[bb * kChunkStride + kk], acc[i]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      const int e = tid + i * kThreads;
      const int j = e / kFeatChunk, kk = e % kFeatChunk;
      const int row = t0 + j, k = k0 + kk;
      if (row < r_end && k < D) {
        const size_t at = static_cast<size_t>(row) * D + k;
        float v = 0.f;
        if (tile_labels[j] >= 0) {
          v = l2_mode ? acc[i] - to_float(s[at]) * colsum[j] : scale * acc[i];
        }
        ds[at] = from_float<T>(v);
      }
    }
  }
}

template <typename T>
cudaError_t launch_dq(cudaStream_t stream, const void* q, const void* s, const void* labels,
                      const void* u, const void* r, const void* m, const void* l,
                      const void* scale, int l2_mode, int B, int S, int D, int C, int n_splits,
                      int rows_per_split, void* ts_part, void* tsum_part, void* dq) {
  const size_t smem = dq_smem_bytes(D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nw_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((B + kQueryTile - 1) / kQueryTile, n_splits);
  nw_bwd_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(s), static_cast<const int*>(labels),
      static_cast<const float*>(u), static_cast<const float*>(r),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(scale), l2_mode, B, S, D, C, rows_per_split,
      static_cast<float*>(ts_part), static_cast<float*>(tsum_part));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nw_bwd_dq_merge_kernel<T><<<B, kMergeThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const float*>(ts_part),
      static_cast<const float*>(tsum_part), static_cast<const float*>(scale), l2_mode,
      n_splits, B, D, static_cast<T*>(dq));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ds(cudaStream_t stream, const void* q, const void* s, const void* labels,
                      const void* u, const void* r, const void* m, const void* l,
                      const void* scale, int l2_mode, int B, int S, int D, int C, void* ds) {
  const size_t smem = ds_smem_bytes(B);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nw_bwd_ds_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  nw_bwd_ds_kernel<T><<<(S + kSupportTile - 1) / kSupportTile, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(s), static_cast<const int*>(labels),
      static_cast<const float*>(u), static_cast<const float*>(r),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(scale), l2_mode, B, S, D, C, static_cast<T*>(ds));
  return cudaGetLastError();
}

bool current_device(int* device) { return cudaGetDevice(device) == cudaSuccess; }

}  // namespace

extern "C" {

int nw_fused_query_tile() { return kQueryTile; }

int nw_fused_support_tile() { return kSupportTile; }

// Largest class count whose forward accumulator fits shared memory.
int nw_fused_max_classes(int device) { return max_forward_classes(device); }

// Largest feature width the dq pass's accumulator (16 x D floats) allows.
int nw_fused_dq_max_features(int device) {
  const size_t fixed = dq_smem_bytes(0);
  const size_t optin = static_cast<size_t>(optin_smem(device));
  return optin > fixed ? static_cast<int>((optin - fixed) / (sizeof(float) * kQueryTile)) : 0;
}

// Largest batch the ds pass's t buffer (B x 64 floats) allows.
int nw_fused_ds_max_batch(int device) {
  const size_t fixed = ds_smem_bytes(0);
  const size_t optin = static_cast<size_t>(optin_smem(device));
  if (optin <= fixed) return 0;
  const size_t per_tile = sizeof(float) * kQueryTile * kSupportTile;
  return static_cast<int>((optin - fixed) / per_tile) * kQueryTile;
}

int nw_fused_smem_bytes(int which, int n) {
  switch (which) {
    case 0: return static_cast<int>(partials_smem_bytes(n));
    case 1: return static_cast<int>(dq_smem_bytes(n));
    default: return static_cast<int>(ds_smem_bytes(n));
  }
}

const char* nw_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1. q (B, D), s (S, D) in f32 or bf16 (bf16 != 0); labels (S,) int32, -1 =
// masked; scale (1,) f32; partials m, l (n_splits, B) and acc (n_splits, B, C)
// f32 scratch; out (B, C), m_final, l_final (B,) f32. partials != 0 (K1
// partials=True, the per-shard pass of a sharded bank): out receives the
// merged label sums unfinalized, relative to m_final as l_final is.
int nw_fused_forward(const void* q, const void* s, const void* labels, const void* scale,
                     void* m_part, void* l_part, void* acc_part, void* out, void* m_final,
                     void* l_final, int B, int S, int D, int C, int l2_mode, int bf16,
                     int n_splits, int rows_per_split, int partials, void* stream) {
  int device = 0;
  if (!forward_args_ok(B, S, D, C, n_splits, rows_per_split) || m_final == nullptr ||
      l_final == nullptr || !current_device(&device) || C > max_forward_classes(device)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch_forward<__nv_bfloat16, true>(st, q, s, nullptr, labels, scale, l2_mode, B,
                                                 S, D, C, n_splits, rows_per_split, m_part,
                                                 l_part, acc_part, out, m_final, l_final,
                                                 partials != 0)
           : launch_forward<float, true>(st, q, s, nullptr, labels, scale, l2_mode, B, S, D, C,
                                         n_splits, rows_per_split, m_part, l_part, acc_part,
                                         out, m_final, l_final, partials != 0));
}

// K3 dq. u (B, C), r, m, l (B,) f32 from the forward and the upstream
// gradient; partials ts (n_splits, B, D) and tsum (n_splits, B) f32 scratch;
// dq (B, D) in the input dtype.
int nw_fused_bwd_dq(const void* q, const void* s, const void* labels, const void* u,
                    const void* r, const void* m, const void* l, const void* scale,
                    void* ts_part, void* tsum_part, void* dq, int B, int S, int D, int C,
                    int l2_mode, int bf16, int n_splits, int rows_per_split, void* stream) {
  int device = 0;
  if (B <= 0 || S <= 0 || D <= 0 || C <= 0 || n_splits <= 0 || rows_per_split <= 0 ||
      static_cast<long long>(n_splits) * rows_per_split < S || !current_device(&device) ||
      D > nw_fused_dq_max_features(device)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch_dq<__nv_bfloat16>(st, q, s, labels, u, r, m, l, scale, l2_mode, B, S, D, C,
                                      n_splits, rows_per_split, ts_part, tsum_part, dq)
           : launch_dq<float>(st, q, s, labels, u, r, m, l, scale, l2_mode, B, S, D, C,
                              n_splits, rows_per_split, ts_part, tsum_part, dq));
}

// K3 ds. Inputs as nw_fused_bwd_dq; ds (S, D) in the input dtype.
int nw_fused_bwd_ds(const void* q, const void* s, const void* labels, const void* u,
                    const void* r, const void* m, const void* l, const void* scale, void* ds,
                    int B, int S, int D, int C, int l2_mode, int bf16, void* stream) {
  int device = 0;
  if (B <= 0 || S <= 0 || D <= 0 || C <= 0 || !current_device(&device) ||
      B > nw_fused_ds_max_batch(device)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch_ds<__nv_bfloat16>(st, q, s, labels, u, r, m, l, scale, l2_mode, B, S, D, C,
                                      ds)
           : launch_ds<float>(st, q, s, labels, u, r, m, l, scale, l2_mode, B, S, D, C, ds));
}

}  // extern "C"
