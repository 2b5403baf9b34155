// Fused Nadaraya-Watson head over raw support features, the backward, for
// Hopper (sm_90a): the training path. (The forward, K1, is the tensor-core
// pass 1 of nw_prepared.cu over raw rows: nw_raw_forward.)
//
// Replaces the TPU kernels of nwhead_tpu/ops/pallas_nw.py:
//   K3  _nw_bwd_dq_kernel   -> nw_fused_bwd_dq (nw_raw_dq_tc_kernel, then
//                              nw_bwd_dq_merge_kernel), and
//       _nw_bwd_ds_kernel   -> nw_fused_bwd_ds (nw_raw_ds_tc_kernel).
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
// pass needs 0.79 GFLOP (recompute plus product) and 12.3 MB. Neither is
// near the card's rates: what costs time is the chain of feature slices a
// block walks through its ring (16 f32 or 8 bf16 slices a score tile at
// D = 512) and how few blocks the small B leaves in flight. Both passes take
// their score tiles by K1's very route (nw_tc.cuh's raw_slice: the products
// on the tensor cores, |q|^2 and |s|^2 as diagonals of self-products in the
// same calls), so a query that is also a support row has dist = 0 and t = 0
// in dq and ds as in the forward, and their products on the tensor cores
// with t split as big + small TF32 (two products for bf16 operands, whose
// values TF32 holds exactly; three for f32). No float atomics: both
// gradients repeat bit for bit.
//   * dq splits S across blocks (one wave of (query tile x split) blocks,
//     as K1's pass 1); each block multiplies t by its tiles' rows and
//     writes per-split partials that a second kernel sums in a fixed order.
//   * ds gives each 64 support rows a thread-block cluster of 1, 2 or 4
//     blocks (the plan: as many as one wave of the SMs holds), each taking
//     its share of the feature slices: each block scores its slices of
//     every query tile, the blocks exchange their partial score tiles and
//     self-norms through distributed shared memory and add them in rank
//     order (so every block holds the same bits, and a coincident pair's
//     q2 - 2 q.s + s2 is still x - 2x + x = 0), keep t for the queries in
//     shared memory, then stream the query rows once more for t^T q over
//     their own features. Nothing is shared between clusters, so there is
//     no merge pass; a batch larger than the t buffer runs in query groups
//     whose sums meet in an f32 scratch.

#include <cooperative_groups.h>

#include "nw_tc.cuh"

namespace nw {

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

// The ds pass's arguments: as nw_fused_bwd_ds's.
struct DsArgs {
  const void* q;  // (B, D) f32 or bf16
  const void* s;  // (S, D), q's dtype
  const int* labels;
  const float *u, *r, *m, *l, *scale;
  int l2_mode, B, S, D, C, group;
  int tma;         // 0: the rows staged by plain loads
  float* scratch;  // (S, D) f32: the sums of the earlier query groups (B > group)
  void* ds;        // (S, D), q's dtype
};

// The TMA's descriptors of the ds pass: q as a score tile's query rows and
// as the t^T q product's stage of kDsChunk rows, and the support rows.
struct DsMaps {
  CUtensorMap q, qp, s;
};

constexpr int kDsStages = 6;                   // slices in the ring
constexpr int kDsBlock = kTcThreads + 32;      // one scoring group and its producer warp
constexpr int kDsChunk = 64;                   // query rows a stage of t^T q
constexpr int kDsTStride = kSupportTile + 8;   // floats a row of t: conflict-free A fragments
constexpr int kDsNorms = 2 * kSupportTile + kTcMaxQuery;  // s2's halves, q2's

// Bytes of a ds ring stage: a score tile's slices (query rows and 64
// support rows), or the t^T q product's kDsChunk query rows and, on a
// slice's last stage, its 64 support rows for the epilogue.
__host__ __device__ constexpr int ds_stage_bytes(int qb) {
  return tc_stage_bytes(qb) > (kDsChunk + kSupportTile) * kTcRowBytes
             ? tc_stage_bytes(qb)
             : (kDsChunk + kSupportTile) * kTcRowBytes;
}

// Floats of one block's partial score tile(s) and self-norms, and how many
// of them a block keeps: its own, or in a cluster one from each block for
// each of two query tiles in turn.
__host__ __device__ constexpr int ds_partial_floats(int qb) {
  return tc_score_bufs(qb) * qb * kTcScoreStride + kDsNorms;
}
__host__ __device__ constexpr int ds_inbox_count(int cluster) {
  return cluster > 1 ? 2 * cluster : 1;
}
// Rows of t a block keeps: the query group, in whole 32-row steps.
__host__ __device__ constexpr int ds_t_rows(int group) { return (group + 31) / 32 * 32; }

// Dynamic shared memory of one ds block: the alignment slack, the ring, its
// full and empty barriers and the two exchange barriers, the partials, t
// for the query group, sum_b t, the rows' |s|^2 and the tile's labels.
inline size_t ds_tc_smem_bytes(int qb, int cluster, int group) {
  return kTcAlign + static_cast<size_t>(kDsStages) * ds_stage_bytes(qb) +
         8 * (2 * kDsStages + 2) +
         sizeof(float) * (static_cast<size_t>(ds_inbox_count(cluster)) * ds_partial_floats(qb) +
                          static_cast<size_t>(ds_t_rows(group)) * kDsTStride + 2 * kSupportTile) +
         sizeof(int) * kSupportTile;
}

// One arrival on the mbarrier at bar's offset in the shared memory of the
// cluster's block `rank`, ordered after this thread's writes (release at
// cluster scope).
__device__ __forceinline__ void mbar_arrive_rank(uint64_t* bar, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(vit::smem_u32(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}

// mbar_wait that also sees the writes of the cluster's other blocks.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(vit::smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ds (K3 ds, TPU nwhead_tpu/ops/pallas_nw.py:1788 _nw_bwd_ds_kernel) on the
// tensor cores: a cluster of n blocks (1, 2 or 4) for each 64-row support
// tile, block rank r taking feature slices [r nK / n, (r + 1) nK / n) of
// the nK. One scoring group of eight warps and a producer warp, whose lane
// 0 asks the TMA for each slice (or whose lanes stage it by plain loads)
// once the group has released its stage. For each query group (all of B,
// or `group` queries at a time):
//   A. for each query tile of kQB, its slices of query and support rows:
//      the block's partial score tile and self-norms by raw_slice (K1's and
//      dq's very products; the rows' self-products on the first query tile
//      only, their sum kept for the others); each block writes them into
//      every block's inbox (distributed shared memory; two inboxes in turn,
//      so that a block that runs ahead writes where nobody reads) and
//      arrives on its exchange barrier; then every block adds the n
//      partials in rank order and takes t = dscore / dist (0 where dist ==
//      0), or dscore in dot mode, in f32 as dq does, into t (shared, a row
//      per query).
//   B. sum_b t_bj over the group into sum_b t (l2), then for each of the
//      block's slices the query rows of the group again, kDsChunk a stage
//      (the last also with the slice's support rows, for the epilogue):
//      ds[64 rows x slice] = t^T (64 x B) q (B x slice) on the tensor
//      cores, t split as big + small TF32: with f32 queries 3xTF32, each
//      stage's big x big and small terms summed from zero and joined to
//      the slice's sum by one add, in stage order; with bf16 ones two
//      products straight into the slice's sum.
// The epilogue writes ds = sum - s_j sum_b t_bj (l2) or scale sum (dot),
// 0 for masked rows, whose s is never read; with more than one query group
// the earlier groups' sums wait in the f32 scratch. No float atomics.
template <typename T, int kQB>
__global__ void __launch_bounds__(kDsBlock, 1)
    nw_raw_ds_tc_kernel(const DsArgs a, const __grid_constant__ DsMaps maps) {
  static_assert(kQB % kTcWarps == 0 && kQB <= kTcMaxQuery, "query tile");
  static_assert(kDsChunk % kQB == 0, "a stage of t^T q holds whole query tiles");
  constexpr int kChunk = kTcRowBytes / static_cast<int>(sizeof(T));  // features a slice
  constexpr int kQA = tc_query_rows(kQB);
  constexpr bool kSplitK = tc_score_bufs(kQB) == 2;
  constexpr int kOwn = kQB / kTcWarps;
  constexpr int kStage = ds_stage_bytes(kQB);
  constexpr int kScores = kQB * kTcScoreStride;
  constexpr int kNorms = tc_score_bufs(kQB) * kScores;  // s2's halves, then q2's
  constexpr int kPart = ds_partial_floats(kQB);
  // t^T q: warp w keeps m-tile w % 4 (16 support rows) and takes n-tiles
  // w / 4, w / 4 + 2, .. of the slice's kNT.
  constexpr int kNT = kChunk / 8;
  constexpr int kTilesPerWarp = kNT / 2;
  constexpr bool kF32 = std::is_same_v<T, float>;

  extern __shared__ float4 smem4[];
  char* ring = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem4) + kTcAlign - 1) & ~static_cast<uintptr_t>(kTcAlign - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kDsStages * kStage);
  uint64_t* empty = full + kDsStages;
  uint64_t* xbar = empty + kDsStages;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  float* inbox = reinterpret_cast<float*>(xbar + 2);
  float* tall = inbox + ds_inbox_count(n_ranks) * kPart;
  float* colsum = tall + ds_t_rows(a.group) * kDsTStride;
  float* s2sum = colsum + kSupportTile;  // the rows' |s|^2, from the first query tile
  int* lab = reinterpret_cast<int*>(s2sum + kSupportTile);

  const int lane = threadIdx.x & 31;
  const bool producer = threadIdx.x >= kTcThreads;
  const int warp = (threadIdx.x >> 5) % kTcWarps;
  const int ws = warp & 3, wh = warp >> 2;
  const int g = lane >> 2, tt = lane & 3;
  const int t0 = (blockIdx.x / n_ranks) * kSupportTile;
  const bool l2 = a.l2_mode != 0, tma = a.tma != 0;
  const float scale = *a.scale;
  const int nK = (a.D + kChunk - 1) / kChunk;
  const int k_lo = rank * nK / n_ranks, k_hi = (rank + 1) * nK / n_ranks;
  const int n_groups = (a.B + a.group - 1) / a.group;

  if (threadIdx.x < kSupportTile) {
    const int row = t0 + threadIdx.x;
    lab[threadIdx.x] = row < a.S ? a.labels[row] : -1;
    colsum[threadIdx.x] = 0.f;
  }
  if (threadIdx.x == 0) {
    for (int k = 0; k < kDsStages; ++k) {
      mbar_init(full + k, 1);
      mbar_init(empty + k, kTcWarps);
    }
    mbar_init(xbar, n_ranks);
    mbar_init(xbar + 1, n_ranks);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (n_ranks > 1) cluster.sync();  // every block's barriers exist before anyone arrives

  if (producer) {
    int q = 0;  // the ring's sequence of stages
    for (int grp = 0; grp < n_groups; ++grp) {
      const int gb0 = grp * a.group, gb1 = min(a.B, gb0 + a.group);
      const int n_qt = (gb1 - gb0 + kQB - 1) / kQB, n_pc = (gb1 - gb0 + kDsChunk - 1) / kDsChunk;
      for (int i = 0; i < n_qt * (k_hi - k_lo) + (k_hi - k_lo) * n_pc; ++i, ++q) {
        const bool scores = i < n_qt * (k_hi - k_lo);
        const int j = scores ? i : i - n_qt * (k_hi - k_lo);
        // A: query tile j / (slices), slice k_lo + j % (slices); B: slice
        // k_lo + j / n_pc, stage j % n_pc, the last with the support rows.
        const int kc = scores ? k_lo + j % (k_hi - k_lo) : k_lo + j / n_pc;
        const bool rows = !scores && j % n_pc == n_pc - 1;
        const int b0 = scores ? gb0 + (j / (k_hi - k_lo)) * kQB : gb0 + (j % n_pc) * kDsChunk;
        const int c0 = kc * kChunk;
        char* st = ring + (q % kDsStages) * kStage;
        uint64_t* bar = full + q % kDsStages;
        if (q >= kDsStages) mbar_wait(empty + q % kDsStages, (q / kDsStages - 1) & 1);
        if (tma) {
          if (lane == 0) {
            if (scores) {
              mbar_expect(bar, (kQA + kSupportTile) * kTcRowBytes);
              tma_2d(st, &maps.q, c0, b0, bar);
              tma_2d(st + kQA * kTcRowBytes, &maps.s, c0, t0, bar);
            } else {
              mbar_expect(bar, (kDsChunk + (rows ? kSupportTile : 0)) * kTcRowBytes);
              tma_2d(st, &maps.qp, c0, b0, bar);
              if (rows) tma_2d(st + kDsChunk * kTcRowBytes, &maps.s, c0, t0, bar);
            }
          }
        } else {
          if (scores) {
            stage_plain<T, kQA>(static_cast<const T*>(a.q), a.D, b0, c0, min(gb1, b0 + kQB), st);
            stage_plain<T, kSupportTile>(static_cast<const T*>(a.s), a.D, t0, c0, a.S,
                                         st + kQA * kTcRowBytes);
          } else {
            stage_plain<T, kDsChunk>(static_cast<const T*>(a.q), a.D, b0, c0, gb1, st);
            if (rows) {
              stage_plain<T, kSupportTile>(static_cast<const T*>(a.s), a.D, t0, c0, a.S,
                                           st + kDsChunk * kTcRowBytes);
            }
          }
          __threadfence_block();
          __syncwarp();
          if (lane == 0) mbar_arrive(bar);
        }
      }
    }
    return;
  }

  int q = 0, x = 0;  // the ring's sequence of stages; the exchanges so far
  for (int grp = 0; grp < n_groups; ++grp) {
    const int gb0 = grp * a.group, gb1 = min(a.B, gb0 + a.group);
    const int n_qt = (gb1 - gb0 + kQB - 1) / kQB, n_pc = (gb1 - gb0 + kDsChunk - 1) / kDsChunk;
    for (int qt = 0; qt < n_qt; ++qt, ++x) {  // A
      const int b0 = gb0 + qt * kQB;
      // The warp's queries' m_safe, max(l, 1e-30), r and u[b, y_j], loaded
      // now so that they arrive while the slices are scored.
      float m_safe[kOwn], l_cl[kOwn], r_b[kOwn], uy[kOwn][2];
#pragma unroll
      for (int o = 0; o < kOwn; ++o) {
        const int bq = b0 + warp + kTcWarps * o;
        const bool live = bq < gb1;
        const float mb = live ? a.m[bq] : 0.f;
        m_safe[o] = mb > kNeg / 2 ? mb : 0.f;
        l_cl[o] = live ? fmaxf(a.l[bq], 1e-30f) : 1.f;
        r_b[o] = live ? a.r[bq] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int y = lab[lane + 32 * h];
          uy[o][h] = live && y >= 0 && y < a.C ? a.u[static_cast<size_t>(bq) * a.C + y] : 0.f;
        }
      }
      float dacc[1][2][4] = {}, s2d[2] = {}, q2d[2] = {};
      // The block's slices; the rows' self-products on the first tile only.
      const auto slices = [&](auto rows) {
        for (int kc = k_lo; kc < k_hi; ++kc, ++q) {
          mbar_wait(full + q % kDsStages, (q / kDsStages) & 1);
          raw_slice<T, kQB, decltype(rows)::value>(ring + (q % kDsStages) * kStage, ws, wh, l2,
                                                    true, dacc, s2d, q2d);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + q % kDsStages);
        }
      };
      if (x == 0) {
        slices(std::true_type{});
      } else {
        slices(std::false_type{});
      }
      // This block's partials into inbox `rank` of the pair's half `par`,
      // in every block of the cluster.
      const int par = n_ranks > 1 ? x & 1 : 0;
      for (int dst = 0; dst < n_ranks; ++dst) {
        float* p = inbox + (par * n_ranks + rank) * kPart;
        if (n_ranks > 1) p = cluster.map_shared_rank(p, dst);
        float* scw = p + (kSplitK ? wh * kScores : 0);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = (kSplitK ? 0 : 16 * wh) + g + 8 * h;
            const int col = 16 * ws + 8 * j + 2 * tt;
            if (row < kQB) {
              *reinterpret_cast<float2*>(scw + row * kTcScoreStride + col) =
                  make_float2(dacc[0][j][2 * h], dacc[0][j][2 * h + 1]);
            }
          }
        if (l2) {
          raw_self_store<kQB>(s2d, q2d, ws, wh, true, p + kNorms, p + kNorms + 2 * kSupportTile);
        }
      }
      if (n_ranks > 1) {
        asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
        group_sync(0);
        if (threadIdx.x == 0) {
          for (int dst = 0; dst < n_ranks; ++dst) mbar_arrive_rank(xbar + par, dst);
        }
        mbar_wait_cluster(xbar + par, (x >> 1) & 1);
      } else {
        group_sync(0);  // the score tile and the self-norms are whole
      }
      // t of the tile's queries: the partials added in rank order, each
      // rank's split-K halves first (q.s, |q|^2 and |s|^2 alike; |s|^2 on
      // the first tile, then kept).
      const float* parts = inbox + par * n_ranks * kPart;
      float s2c[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2 && l2; ++h) {
        const int j = lane + 32 * h;
        if (x == 0) {
          for (int rr = 0; rr < n_ranks; ++rr) {
            s2c[h] += raw_norm<kQB>(parts + rr * kPart + kNorms, j, kSupportTile);
          }
          if (warp == 0) s2sum[j] = s2c[h];
        } else {
          s2c[h] = s2sum[j];
        }
      }
#pragma unroll
      for (int o = 0; o < kOwn; ++o) {
        const int b = warp + kTcWarps * o, bq = b0 + b;
        const bool live = bq < gb1;
        float q2 = 0.f;
        if (l2) {
          for (int rr = 0; rr < n_ranks; ++rr) {
            q2 += raw_norm<kQB>(parts + rr * kPart + kNorms + 2 * kSupportTile, b, 16);
          }
        }
        float t[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = lane + 32 * h, y = lab[j];
          t[h] = 0.f;
          if (y >= 0 && live) {
            float d = 0.f;
            for (int rr = 0; rr < n_ranks; ++rr) {
              const float* row = parts + rr * kPart + b * kTcScoreStride;
              d += kSplitK ? row[j] + row[kScores + j] : row[j];
            }
            const float dist = l2 ? l2_dist(q2, d, s2c[h]) : 0.f;
            const float score = l2 ? -dist : d * scale;
            const float w = score > kNeg / 2 ? expf(score - m_safe[o]) / l_cl[o] : 0.f;
            const float dscore = w * (uy[o][h] - r_b[o]);
            t[h] = l2 ? (dist > 0.f ? dscore / dist : 0.f) : dscore;
          }
        }
        tall[(bq - gb0) * kDsTStride + lane] = t[0];
        tall[(bq - gb0) * kDsTStride + lane + 32] = t[1];
      }
      group_sync(0);  // t is whole; the inbox may be written again
    }
    if (l2 && threadIdx.x < kSupportTile) {
      float c = colsum[threadIdx.x];
      for (int b = 0; b < gb1 - gb0; ++b) c += tall[b * kDsTStride + threadIdx.x];
      colsum[threadIdx.x] = c;
    }
    group_sync(0);  // sum_b t is whole

    // B: ds over the block's slices, t^T q on the tensor cores.
    const int mi = warp & 3, nh = warp >> 2;
    const bool last = grp == n_groups - 1;
    for (int kc = k_lo; kc < k_hi; ++kc) {
      float acc[kTilesPerWarp][4] = {};
      const char* st = ring;
      for (int pc = 0; pc < n_pc; ++pc, ++q) {
        st = ring + (q % kDsStages) * kStage;
        mbar_wait(full + q % kDsStages, (q / kDsStages) & 1);
        const int n_ks = (min(kDsChunk, gb1 - gb0 - pc * kDsChunk) + 7) / 8;
        // f32: this stage's big x big and small terms apart from zero;
        // bf16: both products straight into the slice's sum.
        float hi[kF32 ? kTilesPerWarp : 1][4] = {}, lo[kF32 ? kTilesPerWarp : 1][4] = {};
#pragma unroll
        for (int ks = 0; ks < kDsChunk / 8; ++ks) {
          if (ks >= n_ks) break;
          // A: t^T's rows 16 mi + g (+ 8) at queries 8 ks + tt (+ 4).
          const float* ta = tall + (pc * kDsChunk + 8 * ks + tt) * kDsTStride + 16 * mi + g;
          const float xa[4] = {ta[0], ta[8], ta[4 * kDsTStride], ta[4 * kDsTStride + 8]};
          uint32_t abig[4], asmall[4];
          split_rna(xa, abig, asmall);
          const int k0 = 8 * ks + tt, k1 = k0 + 4;
#pragma unroll
          for (int v = 0; v < kTilesPerWarp; ++v) {
            const int ni = nh + 2 * v;
            const int byte = (8 * ni + g) * static_cast<int>(sizeof(T));
            float xb[2] = {vit::to_float(*reinterpret_cast<const T*>(st + swz(k0, byte))),
                           vit::to_float(*reinterpret_cast<const T*>(st + swz(k1, byte)))};
            uint32_t bbig[2], bsmall[2];
            if constexpr (kF32) {
              split_rna(xb, bbig, bsmall);
              vit::mma_tf32(lo[v], asmall, bbig);
              vit::mma_tf32(lo[v], abig, bsmall);
              vit::mma_tf32(hi[v], abig, bbig);
            } else {  // a bf16 value is a TF32 value: no small part
              bbig[0] = __float_as_uint(xb[0]);
              bbig[1] = __float_as_uint(xb[1]);
              vit::mma_tf32(acc[v], asmall, bbig);
              vit::mma_tf32(acc[v], abig, bbig);
            }
          }
        }
        if constexpr (kF32) {
#pragma unroll
          for (int v = 0; v < kTilesPerWarp; ++v)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[v][e] += hi[v][e] + lo[v][e];
        }
        if (pc < n_pc - 1) {  // the last stage holds the epilogue's support rows
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + q % kDsStages);
        }
      }
      const char* srows = st + kDsChunk * kTcRowBytes;
#pragma unroll
      for (int v = 0; v < kTilesPerWarp; ++v)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 16 * mi + g + 8 * (e >> 1);
          const int f = kc * kChunk + 8 * (nh + 2 * v) + 2 * tt + (e & 1);
          if (t0 + j >= a.S || f >= a.D) continue;
          const size_t at = static_cast<size_t>(t0 + j) * a.D + f;
          float sum = acc[v][e];
          if (grp > 0) sum += a.scratch[at];
          if (!last) {
            a.scratch[at] = sum;
          } else {
            float out = 0.f;
            if (lab[j] >= 0) {
              const int byte = (f - kc * kChunk) * static_cast<int>(sizeof(T));
              out = l2 ? sum - vit::to_float(*reinterpret_cast<const T*>(srows + swz(j, byte))) *
                                   colsum[j]
                       : scale * sum;
            }
            static_cast<T*>(a.ds)[at] = from_float<T>(out);
          }
        }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + (q - 1) % kDsStages);
    }
    group_sync(0);  // t is read: the next group may write it
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

// The TMA's maps of the ds pass; false (the rows staged by plain loads)
// where the TMA cannot address them.
template <typename T>
bool ds_maps(const DsArgs& a, int qb, DsMaps* maps) {
  constexpr CUtensorMapDataType kType = std::is_same_v<T, float> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr int kElem = static_cast<int>(sizeof(T));
  return vit::vec16_ok<T>(a.q, a.D) && vit::vec16_ok<T>(a.s, a.D) &&
         encode_map(&maps->q, kType, kElem, a.q, a.B, a.D, tc_query_rows(qb)) &&
         encode_map(&maps->qp, kType, kElem, a.q, a.B, a.D, kDsChunk) &&
         encode_map(&maps->s, kType, kElem, a.s, a.S, a.D, kSupportTile);
}

// ds with query tiles of kQB and clusters of `cluster` blocks on `stream`.
template <typename T, int kQB>
cudaError_t launch_ds_tc(cudaStream_t stream, DsArgs a, int cluster) {
  const size_t smem = ds_tc_smem_bytes(kQB, cluster, a.group);
  const cudaError_t err =
      cudaFuncSetAttribute(nw_raw_ds_tc_kernel<T, kQB>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  DsMaps maps{};
  a.tma = ds_maps<T>(a, kQB, &maps);
  cudaLaunchAttribute dims{};
  dims.id = cudaLaunchAttributeClusterDimension;
  dims.val.clusterDim.x = static_cast<unsigned>(cluster);
  dims.val.clusterDim.y = 1;
  dims.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(static_cast<unsigned>((a.S + kSupportTile - 1) / kSupportTile * cluster));
  cfg.blockDim = dim3(kDsBlock);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &dims;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, nw_raw_ds_tc_kernel<T, kQB>, a, maps);
}

template <typename T>
cudaError_t launch_ds(cudaStream_t stream, const DsArgs& a, int qb, int cluster) {
  switch (qb) {
    case 8: return launch_ds_tc<T, 8>(stream, a, cluster);
    case 16: return launch_ds_tc<T, 16>(stream, a, cluster);
    case 32: return launch_ds_tc<T, 32>(stream, a, cluster);
    default: return cudaErrorInvalidValue;
  }
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

// The ds block's dynamic shared memory for query tiles of qb, clusters of
// `cluster` blocks and query groups of `group`.
int nw_fused_ds_smem_bytes(int qb, int cluster, int group) {
  return static_cast<int>(ds_tc_smem_bytes(qb, cluster, group));
}

// The largest query group (a multiple of 64) whose t the ds block keeps
// with that plan on the device; a larger batch runs in groups of it.
int nw_fused_ds_max_group(int qb, int cluster, int device) {
  const size_t fixed = ds_tc_smem_bytes(qb, cluster, 0);
  const size_t optin = static_cast<size_t>(optin_smem(device));
  if (optin <= fixed) return 0;
  const size_t rows = (optin - fixed) / (sizeof(float) * kDsTStride);
  return static_cast<int>(rows / kDsChunk * kDsChunk);
}

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

// K3 ds. Inputs as nw_fused_bwd_dq; qb the query tile (8, 16 or 32);
// clusters of `cluster` blocks (1, 2 or 4, no more than D's slices of 128
// bytes) on each 64 support rows; query groups of `group` (all of B, or a
// multiple of 64 through scratch (S, D) f32); ds (S, D) in the input dtype.
int nw_fused_bwd_ds(const void* q, const void* s, const void* labels, const void* u,
                    const void* r, const void* m, const void* l, const void* scale,
                    void* scratch, void* ds, int B, int S, int D, int C, int l2_mode, int bf16,
                    int qb, int cluster, int group, void* stream) {
  int device = 0;
  const int slices = (D * (bf16 ? 2 : 4) + kTcRowBytes - 1) / kTcRowBytes;
  if (B <= 0 || S <= 0 || D <= 0 || C <= 0 || (qb != 8 && qb != 16 && qb != 32) ||
      (cluster != 1 && cluster != 2 && cluster != 4) || cluster > slices || group <= 0 ||
      (group < B && (group % kDsChunk != 0 || scratch == nullptr)) || !current_device(&device) ||
      ds_tc_smem_bytes(qb, cluster, group) > static_cast<size_t>(optin_smem(device))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DsArgs a{};
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
  a.group = group;
  a.scratch = static_cast<float*>(scratch);
  a.ds = ds;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? launch_ds<__nv_bfloat16>(st, a, qb, cluster)
                               : launch_ds<float>(st, a, qb, cluster));
}

}  // extern "C"
