// Fused Nadaraya-Watson head over a prepared support bank, for Hopper (sm_90a).
//
// Replaces the TPU kernel nwhead_tpu/ops/pallas_nw.py:_nw_prepared_kernel
// (f32 and bf16 banks). The pass it computes is written out in
// nw_common.cuh; here the bank's self-norms s2 come precomputed (1e30 on
// masked rows) and a bf16 bank takes a bf16 query.
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
//   * Pass 2 merges the splits exactly and takes the log.
// Tensor cores (wgmma) and TMA are left for later: this is the simple first
// version of the kernel.
//
// K4 and K5 replace the same TPU kernel with quant=True (an int8 bank) and
// quant4=True (an int4 bank, two codes a byte: byte j of a row holds the
// code of feature j plus 8 in its low nibble and the code of feature
// j + D/2 in its high nibble, nwhead_tpu/ops/pallas_nw.py:_int4_pack).
// The query comes quantized per row (int8 codes q8, scale qs); the bank
// per row (codes, scale ss):
//   dot_i = sum_k q8_k s8_k in int32, exact;
//   dot   = float(dot_i) * qcol_b * ss_j, qcol = qs (l2) or qs * scale (dot);
//   l2:   score = -sqrt(max(q2 - 2 dot + s2_j, 0)), q2 = sum_k (q8_k qs)^2
//         (the dequantized query), s2_j the dequantized row's self-norm;
//   dot:  score = dot.
// The softmax, label sum, partials and merge are K2's. At the CUB-200 shape
// (B = 64, S = 5994, D = 512) the int8 bank is 3.1 MB (0.96 us at 3.35
// TB/s), the int4 bank 1.5 MB, and the products 0.39 G int8 operations;
// neither bound sets the kernel's time (0.047 ms on an H100 at 700 W, K2
// f32 0.076), the per-tile staging, softmax and label sum and the
// synchronizations around them do. A stage holds 128 int8 features of a
// row where K2's holds 32 floats. The products run on __dp4a over 32-bit
// words staged in shared memory (4 int8 products a word, int32 sums); K5
// unpacks each packed word into two words of int8 codes as it stages the
// tile, per byte and exactly (__vsub4 borrows nothing across bytes), so
// both banks share one inner loop. Tensor-core int8 (mma.sync / wgmma s8)
// is later work.
//
// K6 replaces the same TPU kernel with tile_sel (n_sel > 0,
// nwhead_tpu/ops/pallas_nw.py:850-856, :969-975): the pass of K2 (f32/bf16
// banks) or K4/K5 (int8/int4 banks) over only the bank tiles a list names,
// for IVF-pruned serving (nwhead_tpu_torch/ops/ivf.py). The bank is tiled
// in block_s rows (a multiple of 128); slot r of the list names bank tile
// tile_sel[r], -1 an empty slot. The list is one row shared by the batch, or
// one row per group of queries (grouped routing), and a query tile of 16
// reads row blockIdx.x / qtiles_per_row: the wrapper pads each group to
// whole query tiles. What bounds it is what bounds K2/K4/K5, over the
// union's rows instead of the bank's. The design is K2's, over slot-order
// rows: slot-order row v is bank row tile_sel[v / block_s] * block_s +
// v % block_s, and a 64-row score tile never straddles two slots, so an
// empty slot (or an id past the bank) skips the whole tile,
// block-uniformly, and leaves the running state as it was. The split
// count comes from n_sel, a static shape: nothing is read back to the
// host, so how many slots hold a tile is known only here. The union's ids
// come first in the list (ascending, -1 padding after them), so split p
// takes score tiles p, p + n_splits, p + 2 n_splits, ...: a union of any
// size spreads over every split, where ranges of slots would leave it to
// the first few. Pass 2 is the same exact merge. K2/K4/K5's own kernels
// are untouched.

#include <climits>
#include <cstdint>

#include "nw_common.cuh"

namespace nw {

// K4/K5's online softmax and label sum of one scored tile: prob (kQueryTile
// x kSupportTile) holds the scores and is overwritten with p; acc
// (kQueryTile x C), m_run and l_run are the block's running state. Warp w
// owns queries w and w + 8. Lane (y mod 32) adds every p_j of class y, so
// each class has one writer: no atomics, and the order of the sum is fixed.
// Ends synchronized. nw_partials_kernel (nw_common.cuh) runs the same step
// inline: calling this function from there made K1 f32 5-6% slower on an
// H100 (chip_smoke.py's K1/K3 phase, both versions in one run).
__device__ __forceinline__ void softmax_label_step(float* __restrict__ prob,
                                                   const int* __restrict__ tile_labels,
                                                   float* __restrict__ acc, int C,
                                                   float* __restrict__ m_run,
                                                   float* __restrict__ l_run) {
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x >> 5; b < kQueryTile; b += kWarps) {
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

// The block's partials (m, l, acc) for its queries b0 .. b0 + 15 into split
// `split` of the pass-1 outputs.
__device__ __forceinline__ void store_partials(const float* __restrict__ acc,
                                               const float* __restrict__ m_run,
                                               const float* __restrict__ l_run, int b0, int B,
                                               int C, int split, float* __restrict__ m_out,
                                               float* __restrict__ l_out,
                                               float* __restrict__ acc_out) {
  const int tid = threadIdx.x;
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

// The integer dot products of one score tile, as tile_dots computes the
// float ones: thread tid owns query tid / 16 and rows tid % 16 + 16 r. q8 is
// (B, 4 * q_words) int8 viewed as 32-bit words; the bank row has row_words
// words: int8 codes (q_words of them), or with kInt4 packed bytes
// (q_words / 2 of them). A chunk stages 32 words of codes per row: 32 int8
// words, or 16 packed words unpacked into their 16 low-nibble words
// (features 4 w ..) and 16 high-nibble words (features D/2 + 4 w ..), with
// the query's words laid out to match. Words past the row load as 0. Ends
// synchronized.
template <bool kInt4>
__device__ __forceinline__ void quant_tile_dots(const int* __restrict__ q8,
                                                const unsigned* __restrict__ s, int b0, int B,
                                                int t0, int r_end, int q_words, int row_words,
                                                int* __restrict__ smem_tile,
                                                int (&dot)[kRowsPerThread]) {
  int* q_chunk = smem_tile;
  int* s_chunk = q_chunk + kQueryTile * kChunkStride;
  const int tid = threadIdx.x;
  const int tq = tid / kThreadsPerQuery;
  const int tr = tid % kThreadsPerQuery;
  constexpr int kStep = kInt4 ? kFeatChunk / 2 : kFeatChunk;  // bank words per chunk
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) dot[r] = 0;

  for (int w0 = 0; w0 < row_words; w0 += kStep) {
#pragma unroll
    for (int i = 0; i < kQueryTile * kFeatChunk / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int b = e / kFeatChunk, p = e % kFeatChunk;
      // kInt4: words p < 16 are the low half's, p >= 16 the high half's.
      const int w = kInt4 ? w0 + (p % kStep) : w0 + p;
      const int src = kInt4 && p >= kStep ? row_words + w : w;
      int v = 0;
      if (b0 + b < B && w < row_words) v = q8[static_cast<size_t>(b0 + b) * q_words + src];
      q_chunk[b * kChunkStride + p] = v;
    }
#pragma unroll
    for (int i = 0; i < kSupportTile * kStep / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int j = e / kStep, p = e % kStep;
      const bool valid = t0 + j < r_end && w0 + p < row_words;
      const unsigned v = valid ? s[static_cast<size_t>(t0 + j) * row_words + w0 + p] : 0u;
      if constexpr (kInt4) {
        // Low nibbles hold code + 8, high nibbles the two's-complement code.
        const unsigned lo = __vsub4(v & 0x0F0F0F0Fu, 0x08080808u);
        const unsigned hi = __vsub4(((v >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
        s_chunk[j * kChunkStride + p] = valid ? static_cast<int>(lo) : 0;
        s_chunk[j * kChunkStride + kStep + p] = valid ? static_cast<int>(hi) : 0;
      } else {
        s_chunk[j * kChunkStride + p] = static_cast<int>(v);
      }
    }
    __syncthreads();
    const int4* qv = reinterpret_cast<const int4*>(q_chunk + tq * kChunkStride);
#pragma unroll
    for (int k4 = 0; k4 < kFeatChunk / 4; ++k4) {
      const int4 a = qv[k4];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int4 c = reinterpret_cast<const int4*>(
            s_chunk + (tr + kThreadsPerQuery * r) * kChunkStride)[k4];
        dot[r] = __dp4a(a.x, c.x, dot[r]);
        dot[r] = __dp4a(a.y, c.y, dot[r]);
        dot[r] = __dp4a(a.z, c.z, dot[r]);
        dot[r] = __dp4a(a.w, c.w, dot[r]);
      }
    }
    __syncthreads();
  }
}

// K4 / K5 pass 1: K2's block layout and shared memory, integer tiles.
template <bool kInt4>
__global__ void __launch_bounds__(kThreads, 4)
nw_quant_partials_kernel(const int8_t* __restrict__ q, const void* __restrict__ s,
                         const float* __restrict__ s2, const int* __restrict__ labels,
                         const float* __restrict__ qcol, const float* __restrict__ sscale,
                         int l2_mode, int B, int S, int D, int C, int rows_per_split,
                         float* __restrict__ m_out, float* __restrict__ l_out,
                         float* __restrict__ acc_out) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  int* tile = reinterpret_cast<int*>(acc + kQueryTile * C);
  float* prob = reinterpret_cast<float*>(tile + kTileSmemFloats);
  float* q2 = prob + kQueryTile * kSupportTile;
  float* m_run = q2 + kQueryTile;
  float* l_run = m_run + kQueryTile;
  int* tile_labels = reinterpret_cast<int*>(l_run + kQueryTile);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int b0 = blockIdx.x * kQueryTile;
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(S, r_begin + rows_per_split);
  const int q_words = D / 4;
  const int row_words = kInt4 ? D / 8 : D / 4;

  for (int i = tid; i < kQueryTile * C; i += kThreads) acc[i] = 0.f;
  // |q|^2 of the dequantized queries (l2 mode), one warp per query.
  for (int b = tid >> 5; b < kQueryTile; b += kWarps) {
    float sum = 0.f;
    if (l2_mode && b0 + b < B) {
      const int8_t* row = q + static_cast<size_t>(b0 + b) * D;
      const float qs = qcol[b0 + b];
      for (int k = lane; k < D; k += 32) {
        const float v = static_cast<float>(row[k]) * qs;
        sum = fmaf(v, v, sum);
      }
    }
    sum = warp_sum(sum);
    if (lane == 0) q2[b] = sum;
  }
  if (tid < kQueryTile) {
    m_run[tid] = kNeg;
    l_run[tid] = 0.f;
  }
  __syncthreads();

  const int tq = tid / kThreadsPerQuery;
  const int tr = tid % kThreadsPerQuery;
  const float qc = b0 + tq < B ? qcol[b0 + tq] : 0.f;

  for (int t0 = r_begin; t0 < r_end; t0 += kSupportTile) {
    load_tile_labels(labels, t0, r_end, tile_labels);
    int dot[kRowsPerThread];
    quant_tile_dots<kInt4>(reinterpret_cast<const int*>(q), static_cast<const unsigned*>(s), b0,
                           B, t0, r_end, q_words, row_words, tile, dot);
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int j = tr + kThreadsPerQuery * r;
      float score = kNeg;
      if (tile_labels[j] >= 0) {
        // (dot * qcol) * sscale, the TPU kernel's order.
        const float d = __int2float_rn(dot[r]) * qc * sscale[t0 + j];
        score = l2_mode ? -l2_dist(q2[tq], d, s2[t0 + j]) : d;
      }
      prob[tq * kSupportTile + j] = score;
    }
    __syncthreads();
    softmax_label_step(prob, tile_labels, acc, C, m_run, l_run);
  }
  store_partials(acc, m_run, l_run, b0, B, C, split, m_out, l_out, acc_out);
}

template <bool kInt4>
cudaError_t launch_quant_forward(cudaStream_t stream, const void* q, const void* s,
                                 const void* s2, const void* labels, const void* qcol,
                                 const void* sscale, int l2_mode, int B, int S, int D, int C,
                                 int n_splits, int rows_per_split, void* m_part, void* l_part,
                                 void* acc_part, void* out, void* m_final, void* l_final,
                                 bool partials) {
  const dim3 grid((B + kQueryTile - 1) / kQueryTile, n_splits);
  const size_t smem = partials_smem_bytes(C);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nw_quant_partials_kernel<kInt4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  nw_quant_partials_kernel<kInt4><<<grid, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(q), s, static_cast<const float*>(s2),
      static_cast<const int*>(labels), static_cast<const float*>(qcol),
      static_cast<const float*>(sscale), l2_mode, B, S, D, C, rows_per_split,
      static_cast<float*>(m_part), static_cast<float*>(l_part), static_cast<float*>(acc_part));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge(stream, partials, m_part, l_part, acc_part, n_splits, B, C, out, m_final,
                      l_final);
}

// K6 pass 1: K2's (kQuant false, T float or bf16) or K4/K5's (kQuant true,
// T int8, kInt4 for the packed bank) block over the selected tiles: split
// blockIdx.y takes every gridDim.y-th score tile of the slot-order rows
// (see the note above).
template <typename T, bool kQuant, bool kInt4>
__global__ void __launch_bounds__(kThreads, 4)
nw_sel_partials_kernel(const T* __restrict__ q, const void* __restrict__ s,
                       const float* __restrict__ s2, const int* __restrict__ labels,
                       const float* __restrict__ scale_ptr, const float* __restrict__ qcol,
                       const float* __restrict__ sscale, const int* __restrict__ tile_sel,
                       int n_sel, int qtiles_per_row, int n_tiles, int block_s, int l2_mode,
                       int B, int D, int C, float* __restrict__ m_out,
                       float* __restrict__ l_out, float* __restrict__ acc_out) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  float* tile = acc + kQueryTile * C;
  float* prob = tile + kTileSmemFloats;
  float* q2 = prob + kQueryTile * kSupportTile;
  float* m_run = q2 + kQueryTile;
  float* l_run = m_run + kQueryTile;
  int* tile_labels = reinterpret_cast<int*>(l_run + kQueryTile);

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kQueryTile;
  const int split = blockIdx.y;
  const int n_score_tiles = n_sel * (block_s / kSupportTile);
  const int* sel = tile_sel + static_cast<size_t>(blockIdx.x / qtiles_per_row) * n_sel;

  for (int i = tid; i < kQueryTile * C; i += kThreads) acc[i] = 0.f;
  if constexpr (kQuant) {
    // |q|^2 of the dequantized queries (l2 mode), one warp per query, as K4.
    const int lane = tid & 31;
    for (int b = tid >> 5; b < kQueryTile; b += kWarps) {
      float sum = 0.f;
      if (l2_mode && b0 + b < B) {
        const T* row = q + static_cast<size_t>(b0 + b) * D;
        const float qs = qcol[b0 + b];
        for (int k = lane; k < D; k += 32) {
          const float v = static_cast<float>(row[k]) * qs;
          sum = fmaf(v, v, sum);
        }
      }
      sum = warp_sum(sum);
      if (lane == 0) q2[b] = sum;
    }
  } else {
    query_norms(q, b0, B, D, q2);
  }
  if (tid < kQueryTile) {
    m_run[tid] = kNeg;
    l_run[tid] = 0.f;
  }
  __syncthreads();

  const int tq = tid / kThreadsPerQuery;
  const int tr = tid % kThreadsPerQuery;
  float mult = 0.f;  // the similarity scale (float banks) or the query's dequant column
  if constexpr (kQuant) {
    mult = b0 + tq < B ? qcol[b0 + tq] : 0.f;
  } else {
    mult = *scale_ptr;
  }

  for (int v = split; v < n_score_tiles; v += gridDim.y) {
    const int v0 = v * kSupportTile;
    const int id = sel[v0 / block_s];
    if (id < 0 || id >= n_tiles) continue;  // empty slot: every thread skips the tile
    const int t0 = id * block_s + v0 % block_s;
    const int t_end = t0 + kSupportTile;
    load_tile_labels(labels, t0, t_end, tile_labels);
    float dot[kRowsPerThread];
    if constexpr (kQuant) {
      int idot[kRowsPerThread];
      quant_tile_dots<kInt4>(reinterpret_cast<const int*>(q), static_cast<const unsigned*>(s),
                             b0, B, t0, t_end, D / 4, kInt4 ? D / 8 : D / 4,
                             reinterpret_cast<int*>(tile), idot);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        // (dot * qcol) * sscale, the TPU kernel's order.
        dot[r] = __int2float_rn(idot[r]) * mult * sscale[t0 + tr + kThreadsPerQuery * r];
      }
    } else {
      tile_dots<false>(q, static_cast<const T*>(s), b0, B, t0, t_end, D, labels, false,
                       nullptr, tile, dot);
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int j = tr + kThreadsPerQuery * r;
      float score = kNeg;
      if (tile_labels[j] >= 0) {
        if (l2_mode) {
          score = -l2_dist(q2[tq], dot[r], s2[t0 + j]);
        } else {
          score = kQuant ? dot[r] : dot[r] * mult;
        }
      }
      prob[tq * kSupportTile + j] = score;
    }
    __syncthreads();
    softmax_label_step(prob, tile_labels, acc, C, m_run, l_run);
  }
  store_partials(acc, m_run, l_run, b0, B, C, split, m_out, l_out, acc_out);
}

template <typename T, bool kQuant, bool kInt4>
cudaError_t launch_sel_forward(cudaStream_t stream, const void* q, const void* s, const void* s2,
                               const void* labels, const void* scale, const void* qcol,
                               const void* sscale, const void* tile_sel, int n_sel,
                               int qtiles_per_row, int n_tiles, int block_s, int l2_mode, int B,
                               int D, int C, int n_splits, void* m_part, void* l_part,
                               void* acc_part, void* out, void* m_final, void* l_final,
                               bool partials) {
  const dim3 grid((B + kQueryTile - 1) / kQueryTile, n_splits);
  const size_t smem = partials_smem_bytes(C);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nw_sel_partials_kernel<T, kQuant, kInt4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  nw_sel_partials_kernel<T, kQuant, kInt4><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), s, static_cast<const float*>(s2), static_cast<const int*>(labels),
      static_cast<const float*>(scale), static_cast<const float*>(qcol),
      static_cast<const float*>(sscale), static_cast<const int*>(tile_sel), n_sel,
      qtiles_per_row, n_tiles, block_s, l2_mode, B, D, C, static_cast<float*>(m_part),
      static_cast<float*>(l_part), static_cast<float*>(acc_part));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge(stream, partials, m_part, l_part, acc_part, n_splits, B, C, out, m_final,
                      l_final);
}

}  // namespace nw

extern "C" {

int nw_prepared_query_tile() { return nw::kQueryTile; }

int nw_prepared_support_tile() { return nw::kSupportTile; }

// Dynamic shared memory of one pass-1 block for `n_classes` classes.
int nw_prepared_smem_bytes(int n_classes) {
  return static_cast<int>(nw::partials_smem_bytes(n_classes));
}

// Largest class count whose accumulator fits the device's shared memory.
int nw_prepared_max_classes(int device) { return nw::max_forward_classes(device); }

const char* nw_prepared_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, D), s (S, D) in f32 or bf16 (bf16 != 0); s2 (S,) f32 (l2 mode only,
// may be null otherwise); labels (S,) int32, -1 = masked; scale (1,) f32;
// partials m, l (n_splits, B) and acc (n_splits, B, C) f32 scratch; out (B, C)
// f32. partials != 0: out receives the merged label sums unfinalized and
// m_final, l_final (B,) f32 the softmax statistics they are relative to
// (the partials=True route; an all-masked query gives -FLT_MAX, 0, 0);
// otherwise out receives the log-probs and m_final, l_final may be null.
// Launches on `stream`, does not synchronize, returns cudaGetLastError().
int nw_prepared_forward(const void* q, const void* s, const void* s2,
                        const void* labels, const void* scale, void* m_part,
                        void* l_part, void* acc_part, void* out, void* m_final,
                        void* l_final, int B, int S, int D, int C, int l2_mode, int bf16,
                        int n_splits, int rows_per_split, int partials, void* stream) {
  if (!nw::forward_args_ok(B, S, D, C, n_splits, rows_per_split) ||
      (l2_mode && s2 == nullptr) || (partials && (m_final == nullptr || l_final == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C > nw::max_forward_classes(device)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? nw::launch_forward<__nv_bfloat16, false>(st, q, s, s2, labels, scale, l2_mode, B,
                                                      S, D, C, n_splits, rows_per_split,
                                                      m_part, l_part, acc_part, out, m_final,
                                                      l_final, partials != 0)
           : nw::launch_forward<float, false>(st, q, s, s2, labels, scale, l2_mode, B, S, D, C,
                                              n_splits, rows_per_split, m_part, l_part,
                                              acc_part, out, m_final, l_final, partials != 0));
}

// K4 (int4 == 0) and K5 (int4 != 0): q (B, D) int8 codes, D the padded
// feature width (a multiple of 4, of 8 for int4); s (S, D) int8 codes, or
// (S, D / 2) packed int4 bytes; s2 (S,) f32 (l2 mode only, may be null
// otherwise); labels (S,) int32, -1 = masked; qcol (B,) f32 the query's
// dequant scale (times the similarity scale in dot mode); sscale (S,) f32
// the rows' scales; partials, out, m_final, l_final and partials as
// nw_prepared_forward's. q and s start on 4-byte boundaries. Launches on
// `stream`, does not synchronize, returns cudaGetLastError().
int nw_prepared_quant_forward(const void* q, const void* s, const void* s2, const void* labels,
                              const void* qcol, const void* sscale, void* m_part, void* l_part,
                              void* acc_part, void* out, void* m_final, void* l_final, int B,
                              int S, int D, int C, int l2_mode, int int4, int n_splits,
                              int rows_per_split, int partials, void* stream) {
  if (!nw::forward_args_ok(B, S, D, C, n_splits, rows_per_split) || D % (int4 ? 8 : 4) != 0 ||
      (partials && (m_final == nullptr || l_final == nullptr)) ||
      (l2_mode && s2 == nullptr) || reinterpret_cast<uintptr_t>(q) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(s) % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C > nw::max_forward_classes(device)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      int4 ? nw::launch_quant_forward<true>(st, q, s, s2, labels, qcol, sscale, l2_mode, B, S, D,
                                            C, n_splits, rows_per_split, m_part, l_part,
                                            acc_part, out, m_final, l_final, partials != 0)
           : nw::launch_quant_forward<false>(st, q, s, s2, labels, qcol, sscale, l2_mode, B, S,
                                             D, C, n_splits, rows_per_split, m_part, l_part,
                                             acc_part, out, m_final, l_final, partials != 0));
}

// K6: the pass of nw_prepared_forward (bank 0 f32, 1 bf16) or
// nw_prepared_quant_forward (bank 2 int8, 3 int4) over the bank tiles that
// tile_sel names. The bank has n_tiles * block_s rows, block_s a multiple of
// 64; tile_sel is (n_rows, n_sel) int32, -1 = empty slot (an id outside
// [0, n_tiles) is skipped too); query tile i (16 queries) reads row
// i / qtiles_per_row. scale (1,) f32 goes with a float bank; qcol (B,) and
// sscale (n_tiles * block_s,) f32 with a quantized one, as in those entry
// points. n_splits splits share the n_sel * block_s / 64 score tiles of
// slot-order rows in turn; partials m, l (n_splits, B), acc (n_splits, B,
// C), out (B, C), m_final, l_final and partials as nw_prepared_forward's
// (empty slots and masked-only tiles leave a query at -FLT_MAX, 0, 0).
// Launches on `stream`, does not synchronize, returns cudaGetLastError().
int nw_prepared_sel_forward(const void* q, const void* s, const void* s2, const void* labels,
                            const void* scale, const void* qcol, const void* sscale,
                            const void* tile_sel, void* m_part, void* l_part, void* acc_part,
                            void* out, void* m_final, void* l_final, int B, int D, int C,
                            int l2_mode, int bank, int n_sel, int qtiles_per_row, int n_tiles,
                            int block_s, int n_splits, int partials, void* stream) {
  const bool quant = bank == 2 || bank == 3;
  if (bank < 0 || bank > 3 || B <= 0 || D <= 0 || C <= 0 || n_sel <= 0 || block_s <= 0 ||
      (partials && (m_final == nullptr || l_final == nullptr)) ||
      block_s % nw::kSupportTile != 0 || n_tiles <= 0 || qtiles_per_row <= 0 ||
      static_cast<long long>(n_sel) * block_s > INT_MAX ||
      static_cast<long long>(n_tiles) * block_s > INT_MAX || n_splits <= 0 ||
      n_splits > 48 * 1024 / static_cast<int>(sizeof(float)) || tile_sel == nullptr || (l2_mode && s2 == nullptr) ||
      (quant ? (qcol == nullptr || sscale == nullptr || D % (bank == 3 ? 8 : 4) != 0 ||
                reinterpret_cast<uintptr_t>(q) % 4 != 0 || reinterpret_cast<uintptr_t>(s) % 4 != 0)
             : scale == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C > nw::max_forward_classes(device)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bank) {
    case 0:
      return static_cast<int>(nw::launch_sel_forward<float, false, false>(
          st, q, s, s2, labels, scale, qcol, sscale, tile_sel, n_sel, qtiles_per_row, n_tiles,
          block_s, l2_mode, B, D, C, n_splits, m_part, l_part, acc_part, out, m_final, l_final,
          partials != 0));
    case 1:
      return static_cast<int>(nw::launch_sel_forward<__nv_bfloat16, false, false>(
          st, q, s, s2, labels, scale, qcol, sscale, tile_sel, n_sel, qtiles_per_row, n_tiles,
          block_s, l2_mode, B, D, C, n_splits, m_part, l_part, acc_part, out, m_final, l_final,
          partials != 0));
    case 2:
      return static_cast<int>(nw::launch_sel_forward<int8_t, true, false>(
          st, q, s, s2, labels, scale, qcol, sscale, tile_sel, n_sel, qtiles_per_row, n_tiles,
          block_s, l2_mode, B, D, C, n_splits, m_part, l_part, acc_part, out, m_final, l_final,
          partials != 0));
    default:
      return static_cast<int>(nw::launch_sel_forward<int8_t, true, true>(
          st, q, s, s2, labels, scale, qcol, sscale, tile_sel, n_sel, qtiles_per_row, n_tiles,
          block_s, l2_mode, B, D, C, n_splits, m_part, l_part, acc_part, out, m_final, l_final,
          partials != 0));
  }
}

}  // extern "C"
