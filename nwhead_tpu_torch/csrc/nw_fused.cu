// Fused Nadaraya-Watson head over raw support features, the backward, for
// Hopper (sm_90a): the training path. (The forward, K1, is the tensor-core
// pass 1 of nw_prepared.cu over raw rows: nw_raw_forward.)
//
// Replaces the TPU kernels of nwhead_tpu/ops/pallas_nw.py:
//   K3  _nw_bwd_dq_kernel   -> nw_fused_bwd_dq (nw_raw_dq_tc_kernel, then
//                              nw_bwd_dq_merge_kernel), and
//       _nw_bwd_ds_kernel   -> nw_fused_bwd_ds.
// The backward recomputes each score tile from (m, l), flash style:
//   w_bj = exp(score_bj - m_safe_b) / max(l_b, 1e-30)
//   dscore_bj = w_bj * (u[b, y_j] - r_b)      (u, r from the upstream gradient)
//   l2 mode:  t_bj = dscore_bj / dist_bj (0 where dist == 0)
//             dq_b = sum_j t_bj s_j - q_b sum_j t_bj
//             ds_j = sum_b t_bj q_b - s_j sum_b t_bj
//   dot mode: dq_b = scale * sum_j dscore_bj s_j;  ds_j = scale * sum_b dscore_bj q_b
// Gradients are written in the input dtype; every sum is f32. Masked rows
// (label -1) read as 0 and get t = 0, so their NaN never reaches a product;
// their ds is 0.
//
// What bounds them: at the training episode (B = 8, S = 1200, D = 512) each
// pass does 2 to 4 * B * S * D = 10-20 MFLOP and moves about 2.5 MB of f32,
// a few microseconds of the card at best; at B = 64, S = 5994 each backward
// pass needs 0.79 GFLOP (recompute plus product) and 12.3 MB. With B this
// small there is one query tile, so parallelism comes from the support:
//   * dq splits S across blocks (one wave of (query tile x split) blocks,
//     as K1's pass 1). Its block recomputes the score tile on the tensor
//     cores by K1's very route (tc_product and the self-products of
//     nw_tc.cuh, so a query that is also a support row has t = 0 there as
//     dist = 0 in the forward), then multiplies t by the tile's rows on the
//     tensor cores, keeping sum_j t s_j for its queries in shared memory
//     (kQB x D floats) and writing it with sum_j t as a per-split partial;
//     a second kernel sums the splits in a fixed order. No float atomics:
//     the gradient is the same on every run.
//   * ds gives each block 64 support rows and loops over every query tile,
//     keeping t for all B queries of its rows in shared memory (B x 64
//     floats); then it writes its rows' gradient, which no other block
//     touches. Its score tile (16 queries x 64 rows, f32 FMAs from shared
//     memory, |q|^2, |s|^2 and q.s summed in one order) is nw_common.cuh's
//     tile_dots; the tensor cores are later work.

#include "nw_tc.cuh"

namespace nw {

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

// The dq pass 1's arguments: as nw_fused_bwd_dq's.
struct DqArgs {
  const void* q;  // (B, D) f32 or bf16
  const void* s;  // (S, D), q's dtype
  const int* labels;
  const float *u, *r, *m, *l, *scale;
  int l2_mode, B, S, D, C, rows_per_split;
  int tma;  // 0: the rows staged by plain loads
  float* ts_out;
  float* tsum_out;
};

constexpr int kDqStages = 6;                     // slices in the ring
constexpr int kDqBlock = kTcThreads + 32;        // one scoring group and its producer warp

// Floats a row of the dq block's sum_j t s_j (a padded stride, so that the
// eight rows of a fragment's store spread over the banks).
__host__ __device__ constexpr int dq_acc_stride(int D) { return D + 8; }

// Dynamic shared memory of one dq block: the alignment slack, the ring,
// the score tile(s), t (16 rows at least), |q|^2's halves, the queries'
// m_safe, max(l, 1e-30), r and sum_j t, the ring's barriers, and
// sum_j t s_j for the kQB queries.
inline size_t dq_tc_smem_bytes(int qb, int D) {
  return kTcAlign + static_cast<size_t>(kDqStages) * tc_stage_bytes(qb) +
         sizeof(float) * (static_cast<size_t>(tc_score_bufs(qb)) * qb * kTcScoreStride +
                          tc_query_rows(qb) * kTcScoreStride + 5 * kTcMaxQuery) +
         16 * kDqStages + sizeof(float) * static_cast<size_t>(qb) * dq_acc_stride(D);
}

// dq pass 1 (K3 dq, TPU nwhead_tpu/ops/pallas_nw.py:1749 _nw_bwd_dq_kernel)
// on the tensor cores: block (x, y) = (query tile of kQB, support split).
// One scoring group of eight warps and a producer warp, whose lane 0 asks
// the TMA for each slice (or whose lanes stage it by plain loads) once the
// group has released its stage. Each 64-row tile of the split goes through
// the ring twice:
//   A. its slices of query and support rows (labels with the last): the
//      score tile on the tensor cores exactly as K1's pass 1 computes it
//      (raw_slice: tc_product, in l2 mode with |q|^2 and |s|^2 beside);
//      after the last slice each warp, for its kQB / 8 queries, takes w =
//      exp(score - m_safe) / max(l, 1e-30), dscore = w (u[b, y_j] - r_b)
//      and t = dscore / dist (0 where dist == 0), or dscore in dot mode,
//      in f32 as the TPU kernel's _bwd_tile_dscore keeps them, into t
//      (kQB x 64, shared), and adds sum_j t_bj to the query's sum (l2);
//   B. its slices of support rows again (from the L2: a whole f32 tile at
//      D = 512 is 128 KB, which the ring, t and the sums leave no room
//      for): sum_j t_bj s_j for the slice's features on the tensor cores,
//      t split as big + small TF32 (3xTF32 with an f32 tile, two products
//      with a bf16 one, whose values TF32 holds exactly), the rows of
//      masked support rows (and rows past the split) read as 0, since
//      their NaN times t = 0 would be NaN; each product sums from zero
//      (its even and odd steps of 8 rows apart, two chains of half the
//      depth) and joins the block's f32 sum by one add, in tile order.
// Then the block writes its sums as the split's partials: ts_out[split, b,
// :] and tsum_out[split, b]. No float atomics: the gradient repeats bit for
// bit. One block an SM.
template <typename T, int kQB>
__global__ void __launch_bounds__(kDqBlock, 1)
    nw_raw_dq_tc_kernel(const DqArgs a, const __grid_constant__ TcMaps maps) {
  static_assert(kQB % kTcWarps == 0 && kQB <= kTcMaxQuery, "query tile");
  constexpr int kChunk = kTcRowBytes / static_cast<int>(sizeof(T));  // features a slice
  constexpr int kQA = tc_query_rows(kQB);
  constexpr bool kSplitK = tc_score_bufs(kQB) == 2;
  constexpr int kOwn = kQB / kTcWarps;
  constexpr int kStage = tc_stage_bytes(kQB);
  constexpr int kSupportOff = kQA * kTcRowBytes;
  constexpr int kLabelOff = kSupportOff + kSupportTile * kTcRowBytes;
  constexpr int kScores = kQB * kTcScoreStride;
  // t s: each warp keeps one m-tile of the queries (mi) and takes n-tiles
  // wi, wi + kWarpsPerM, .. of the slice's kNT (at 16 queries or fewer
  // with f32 rows, four of the eight warps).
  constexpr int kNT = kChunk / 8;                // n-tiles of a slice's features in t s
  constexpr int kWarpsPerM = kTcWarps / (kQA / 16);
  constexpr int kTilesPerWarp = (kNT + kWarpsPerM - 1) / kWarpsPerM;

  extern __shared__ float4 smem4[];
  char* ring = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem4) + kTcAlign - 1) & ~static_cast<uintptr_t>(kTcAlign - 1));
  float* sc = reinterpret_cast<float*>(ring + kDqStages * kStage);
  float* tb = sc + tc_score_bufs(kQB) * kScores;  // t, rows past kQB 0
  float* q2h = tb + kQA * kTcScoreStride;
  float* m_safe = q2h + kTcMaxQuery;
  float* l_cl = m_safe + kTcMaxQuery;
  float* r_b = l_cl + kTcMaxQuery;
  float* tsum = r_b + kTcMaxQuery;
  uint64_t* full = reinterpret_cast<uint64_t*>(tsum + kTcMaxQuery);
  uint64_t* empty = full + kDqStages;
  float* acc = reinterpret_cast<float*>(empty + kDqStages);
  const int stride = dq_acc_stride(a.D);

  const int lane = threadIdx.x & 31;
  const bool producer = threadIdx.x >= kTcThreads;
  const int warp = (threadIdx.x >> 5) % kTcWarps;
  const int ws = warp & 3, wh = warp >> 2;
  const int g = lane >> 2, tt = lane & 3;
  const int mi = warp / kWarpsPerM, wi = warp % kWarpsPerM;
  const int b0 = blockIdx.x * kQB;
  const int split = blockIdx.y;
  const int r_begin = split * a.rows_per_split;
  const int r_end = min(a.S, r_begin + a.rows_per_split);
  const int n_tiles = (r_end - r_begin + kSupportTile - 1) / kSupportTile;
  const bool l2 = a.l2_mode != 0, tma = a.tma != 0;
  const float scale = *a.scale;
  const int nK = (a.D + kChunk - 1) / kChunk;

  for (int i = threadIdx.x; i < kQB * stride; i += kDqBlock) acc[i] = 0.f;
  for (int i = threadIdx.x; i < kQA * kTcScoreStride; i += kDqBlock) tb[i] = 0.f;
  if (threadIdx.x < kTcMaxQuery) {
    const int b = b0 + threadIdx.x;
    const bool ok = threadIdx.x < kQB && b < a.B;
    m_safe[threadIdx.x] = ok && a.m[b] > kNeg / 2 ? a.m[b] : 0.f;
    l_cl[threadIdx.x] = ok ? fmaxf(a.l[b], 1e-30f) : 1.f;
    r_b[threadIdx.x] = ok ? a.r[b] : 0.f;
    tsum[threadIdx.x] = 0.f;
  }
  if (threadIdx.x == 0) {
    for (int k = 0; k < kDqStages; ++k) {
      mbar_init(full + k, 1);
      mbar_init(empty + k, kTcWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (producer) {
    // Slice q of the block's sequence: tile q / (2 nK), phase (q / nK) % 2,
    // slice q % nK.
    for (int q = 0; q < 2 * nK * n_tiles; ++q) {
      const int u = q / kDqStages, kc = q % nK;
      const bool scores = (q / nK) % 2 == 0, last = scores && kc == nK - 1;
      const int t0 = r_begin + (q / (2 * nK)) * kSupportTile, c0 = kc * kChunk;
      char* st = ring + (q % kDqStages) * kStage;
      uint64_t* bar = full + q % kDqStages;
      if (u > 0) mbar_wait(empty + q % kDqStages, (u - 1) & 1);
      if (tma) {
        if (lane == 0) {
          mbar_expect(bar, (scores ? kQA * kTcRowBytes : 0) + kSupportTile * kTcRowBytes +
                               (last ? kSupportTile * 4 : 0));
          if (scores) tma_2d(st, &maps.q, c0, b0, bar);
          tma_2d(st + kSupportOff, &maps.s, c0, t0, bar);
          if (last) tma_1d(st + kLabelOff, &maps.labels, t0, bar);
        }
      } else {
        if (scores) stage_plain<T, kQA>(static_cast<const T*>(a.q), a.D, b0, c0,
                                        min(a.B, b0 + kQB), st);
        stage_plain<T, kSupportTile>(static_cast<const T*>(a.s), a.D, t0, c0, r_end,
                                     st + kSupportOff);
        for (int r = lane; last && r < kSupportTile; r += 32) {
          reinterpret_cast<int*>(st + kLabelOff)[r] = t0 + r < r_end ? a.labels[t0 + r] : -1;
        }
        __threadfence_block();
        __syncwarp();
        if (lane == 0) mbar_arrive(bar);
      }
    }
    return;
  }

  float dacc[1][2][4], s2d[2], q2d[2] = {};
  unsigned long long valid = 0ull;  // the tile's rows that take part (label >= 0)
  int q = 0;
  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = r_begin + i * kSupportTile;
    for (int kc = 0; kc < nK; ++kc, ++q) {  // A: the score tile, then t
      const char* st = ring + (q % kDqStages) * kStage;
      mbar_wait(full + q % kDqStages, (q / kDqStages) & 1);
      if (kc == 0) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dacc[0][j][e] = 0.f;
        s2d[0] = s2d[1] = 0.f;
      }
      raw_slice<T, kQB>(st, ws, wh, l2, i == 0, dacc, s2d, q2d);  // K1's very products
      if (kc == nK - 1) {
        float* scw = sc + (kSplitK ? wh * kScores : 0);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = (kSplitK ? 0 : 16 * wh) + (lane >> 2) + 8 * h;
            const int col = 16 * ws + 8 * j + 2 * (lane & 3);
            if (row < kQB) {
              *reinterpret_cast<float2*>(scw + row * kTcScoreStride + col) =
                  make_float2(dacc[0][j][2 * h], dacc[0][j][2 * h + 1]);
            }
          }
        const int* lab = reinterpret_cast<const int*>(st + kLabelOff);
        float* s2t = const_cast<float*>(reinterpret_cast<const float*>(lab + kSupportTile));
        if (l2) raw_self_store<kQB>(s2d, q2d, ws, wh, i == 0, s2t, q2h);
        group_sync(0);  // the score tile and the self-norms are whole

        const int n_valid = min(kSupportTile, r_end - t0);
        const int y0 = lane < n_valid ? lab[lane] : -1;
        const int y1 = lane + 32 < n_valid ? lab[lane + 32] : -1;
        valid = static_cast<unsigned long long>(__ballot_sync(0xffffffffu, y0 >= 0)) |
                (static_cast<unsigned long long>(__ballot_sync(0xffffffffu, y1 >= 0)) << 32);
        const float s20 = l2 ? raw_norm<kQB>(s2t, lane, kSupportTile) : 0.f;
        const float s21 = l2 ? raw_norm<kQB>(s2t, lane + 32, kSupportTile) : 0.f;
#pragma unroll
        for (int o = 0; o < kOwn; ++o) {
          const int b = warp + kTcWarps * o, bq = b0 + b;
          const float* row = sc + b * kTcScoreStride;
          const float q2 = l2 ? raw_norm<kQB>(q2h, b, 16) : 0.f;
          float t[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = lane + 32 * h, y = h ? y1 : y0;
            t[h] = 0.f;
            if (y >= 0 && bq < a.B) {
              const float d = kSplitK ? row[j] + row[kScores + j] : row[j];
              const float dist = l2 ? l2_dist(q2, d, h ? s21 : s20) : 0.f;
              const float score = l2 ? -dist : d * scale;
              const float w = score > kNeg / 2 ? expf(score - m_safe[b]) / l_cl[b] : 0.f;
              const float uy = y < a.C ? a.u[static_cast<size_t>(bq) * a.C + y] : 0.f;
              const float dscore = w * (uy - r_b[b]);
              t[h] = l2 ? (dist > 0.f ? dscore / dist : 0.f) : dscore;
            }
          }
          tb[b * kTcScoreStride + lane] = t[0];
          tb[b * kTcScoreStride + lane + 32] = t[1];
          if (l2) {
            const float v = warp_sum(t[0] + t[1]);
            if (lane == 0) tsum[b] += v;
          }
        }
        group_sync(0);  // t is whole
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + q % kDqStages);
    }
    // B: sum_j t_bj s_j over each slice's features. The warp's m-tile of
    // t, split once a tile into its A fragments for the 8 steps of 8 rows.
    uint32_t abig[kSupportTile / 8][4], asmall[kSupportTile / 8][4];
#pragma unroll
    for (int ks = 0; ks < kSupportTile / 8; ++ks) {
      const float* ta = tb + (16 * mi + g) * kTcScoreStride + 8 * ks + tt;
      const float xa[4] = {ta[0], ta[8 * kTcScoreStride], ta[4], ta[8 * kTcScoreStride + 4]};
      split_rna(xa, abig[ks], asmall[ks]);
    }
    for (int kc = 0; kc < nK; ++kc, ++q) {
      const char* st = ring + (q % kDqStages) * kStage + kSupportOff;
      mbar_wait(full + q % kDqStages, (q / kDqStages) & 1);
#pragma unroll
      for (int v = 0; v < kTilesPerWarp; ++v) {
        const int ni = wi + kWarpsPerM * v, f0 = kc * kChunk + 8 * ni;
        if (ni >= kNT || f0 >= a.D) continue;
        // Even and odd steps in their own sums (two chains of half the
        // depth), added in a fixed order at the end.
        float hi[2][4] = {}, lo[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < kSupportTile / 8; ++ks) {
          const int k0 = 8 * ks + tt, k1 = k0 + 4;
          const int byte = (8 * ni + g) * static_cast<int>(sizeof(T));
          float xb[2] = {vit::to_float(*reinterpret_cast<const T*>(st + swz(k0, byte))),
                         vit::to_float(*reinterpret_cast<const T*>(st + swz(k1, byte)))};
          xb[0] = (valid >> k0) & 1ull ? xb[0] : 0.f;
          xb[1] = (valid >> k1) & 1ull ? xb[1] : 0.f;
          uint32_t bbig[2], bsmall[2];
          if constexpr (std::is_same_v<T, float>) {
            split_rna(xb, bbig, bsmall);
            vit::mma_tf32(lo[ks & 1], asmall[ks], bbig);
            vit::mma_tf32(lo[ks & 1], abig[ks], bsmall);
          } else {  // a bf16 value is a TF32 value: no small part
            bbig[0] = __float_as_uint(xb[0]);
            bbig[1] = __float_as_uint(xb[1]);
            vit::mma_tf32(lo[ks & 1], asmall[ks], bbig);
          }
          vit::mma_tf32(hi[ks & 1], abig[ks], bbig);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * mi + g + 8 * (e >> 1), f = f0 + 2 * tt + (e & 1);
          if (row < kQB && f < a.D) {
            acc[row * stride + f] += (hi[0][e] + lo[0][e]) + (hi[1][e] + lo[1][e]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + q % kDqStages);
    }
  }
  group_sync(0);
  for (int b = 0; b < kQB && b0 + b < a.B; ++b) {
    float* dst = a.ts_out + (static_cast<size_t>(split) * a.B + b0 + b) * a.D;
    for (int f = threadIdx.x; f < a.D; f += kTcThreads) dst[f] = acc[b * stride + f];
  }
  if (threadIdx.x < kQB && b0 + threadIdx.x < a.B) {
    a.tsum_out[static_cast<size_t>(split) * a.B + b0 + threadIdx.x] = tsum[threadIdx.x];
  }
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

// cuTensorMapEncodeTiled's maps of q, s and the labels for the dq pass;
// false (the rows staged by plain loads) where the TMA cannot address them.
template <typename T>
bool dq_maps(const DqArgs& a, int qb, TcMaps* maps) {
  constexpr CUtensorMapDataType kType = std::is_same_v<T, float> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr int kElem = static_cast<int>(sizeof(T));
  return vit::vec16_ok<T>(a.q, a.D) && vit::vec16_ok<T>(a.s, a.D) &&
         reinterpret_cast<uintptr_t>(a.labels) % 16 == 0 &&
         encode_map(&maps->q, kType, kElem, a.q, a.B, a.D, tc_query_rows(qb)) &&
         encode_map(&maps->s, kType, kElem, a.s, a.S, a.D, kSupportTile) &&
         encode_map(&maps->labels, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, a.labels, a.S, 0, 0);
}

template <typename T, int kQB>
cudaError_t launch_dq_pass1(cudaStream_t stream, DqArgs a, int n_splits) {
  const size_t smem = dq_tc_smem_bytes(kQB, a.D);
  const cudaError_t err =
      cudaFuncSetAttribute(nw_raw_dq_tc_kernel<T, kQB>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  TcMaps maps{};
  a.tma = dq_maps<T>(a, kQB, &maps);
  const dim3 grid((a.B + kQB - 1) / kQB, n_splits);
  nw_raw_dq_tc_kernel<T, kQB><<<grid, kDqBlock, smem, stream>>>(a, maps);
  return cudaGetLastError();
}

// dq pass 1 (query tiles of qb) then pass 2 on `stream`.
template <typename T>
cudaError_t launch_dq(cudaStream_t stream, const DqArgs& a, int qb, int n_splits, void* dq) {
  cudaError_t err = cudaErrorInvalidValue;
  switch (qb) {
    case 8: err = launch_dq_pass1<T, 8>(stream, a, n_splits); break;
    case 16: err = launch_dq_pass1<T, 16>(stream, a, n_splits); break;
    case 32: err = launch_dq_pass1<T, 32>(stream, a, n_splits); break;
    default: break;
  }
  if (err != cudaSuccess) return err;
  nw_bwd_dq_merge_kernel<T><<<a.B, kMergeThreads, 0, stream>>>(
      static_cast<const T*>(a.q), a.ts_out, a.tsum_out, a.scale, a.l2_mode, n_splits, a.B, a.D,
      static_cast<T*>(dq));
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

}  // namespace nw

using namespace nw;

extern "C" {

// The dq pass 1's dynamic shared memory for query tiles of qb and D
// features.
int nw_fused_dq_smem_bytes(int qb, int D) { return static_cast<int>(dq_tc_smem_bytes(qb, D)); }

// Largest feature width the dq pass's sums (qb x D floats) allow at its
// smallest query tile, 8.
int nw_fused_dq_max_features(int device) {
  const size_t fixed = dq_tc_smem_bytes(8, 0);
  const size_t optin = static_cast<size_t>(optin_smem(device));
  return optin > fixed ? static_cast<int>((optin - fixed) / (sizeof(float) * 8)) : 0;
}

// Largest batch the ds pass's t buffer (B x 64 floats) allows.
int nw_fused_ds_max_batch(int device) {
  const size_t fixed = ds_smem_bytes(0);
  const size_t optin = static_cast<size_t>(optin_smem(device));
  if (optin <= fixed) return 0;
  const size_t per_tile = sizeof(float) * kQueryTile * kSupportTile;
  return static_cast<int>((optin - fixed) / per_tile) * kQueryTile;
}

int nw_fused_ds_smem_bytes(int B) { return static_cast<int>(ds_smem_bytes(B)); }

const char* nw_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K3 dq. q (B, D), s (S, D) in f32 or bf16 (bf16 != 0), any D up to
// nw_fused_dq_max_features; labels (S,) int32, -1 = masked (such a row
// may hold anything, NaN included); u (B, C), r, m, l (B,) f32 from the
// forward and the upstream gradient; scale (1,) f32; partials ts
// (n_splits, B, D) and tsum (n_splits, B) f32 scratch; qb the query tile
// (8, 16 or 32, its block within the device's shared memory); splits of
// rows_per_split rows, a multiple of 64; dq (B, D) in the input dtype.
int nw_fused_bwd_dq(const void* q, const void* s, const void* labels, const void* u,
                    const void* r, const void* m, const void* l, const void* scale,
                    void* ts_part, void* tsum_part, void* dq, int B, int S, int D, int C,
                    int l2_mode, int bf16, int n_splits, int rows_per_split, int qb,
                    void* stream) {
  int device = 0;
  if (B <= 0 || S <= 0 || D <= 0 || C <= 0 || n_splits <= 0 || rows_per_split <= 0 ||
      rows_per_split % kSupportTile != 0 ||
      static_cast<long long>(n_splits) * rows_per_split < S ||
      (qb != 8 && qb != 16 && qb != 32) || !current_device(&device) ||
      dq_tc_smem_bytes(qb, D) > static_cast<size_t>(optin_smem(device))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DqArgs a{};
  a.q = q;
  a.s = s;
  a.labels = static_cast<const int*>(labels);
  a.u = static_cast<const float*>(u);
  a.r = static_cast<const float*>(r);
  a.m = static_cast<const float*>(m);
  a.l = static_cast<const float*>(l);
  a.scale = static_cast<const float*>(scale);
  a.l2_mode = l2_mode;
  a.B = B;
  a.S = S;
  a.D = D;
  a.C = C;
  a.rows_per_split = rows_per_split;
  a.ts_out = static_cast<float*>(ts_part);
  a.tsum_out = static_cast<float*>(tsum_part);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? launch_dq<__nv_bfloat16>(st, a, qb, n_splits, dq)
                               : launch_dq<float>(st, a, qb, n_splits, dq));
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
