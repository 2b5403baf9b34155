// The tensor-core pass 1 of the forward (nw_prepared_tc_kernel) and its
// launch: K1 over raw rows, K2/K4/K5/K6 over prepared banks (their entry
// points and the design are in nw_prepared.cu), and the kernel lab's L1
// fused_variant (lab_nw.cu), which runs its options on the same pass.

#pragma once

#include "nw_tc.cuh"

namespace nw {

// Pass 1 of K2 (kSel false: split blockIdx.y takes rows [y rows_per_split,
// (y + 1) rows_per_split)) and of K6 (kSel: every gridDim.y-th score tile
// of the slot-order rows of tile_sel's row blockIdx.x / qtiles_per_row)
// for the queries blockIdx.x * kQB ..: writes the split's partials (m, l,
// acc). Two scoring groups of eight warps take the tiles in turn, group
// (tile mod 2), each with its own ring of kStages slices, fed by its own
// producer warp (16 + group, whose lane 0 asks the TMA for each slice once
// the group has released its stage): each scores its tile's slices on the
// tensor cores, then runs the tile's softmax and label sum, each warp for
// kQB / 8 queries. The softmax steps keep the tiles' order (each group
// waits for the other's step on the tile before, named barriers 1 and 2),
// so acc, m and l take their terms in row order, while one group's
// products overlap the other's softmax. One block an SM (112 registers a
// thread). T = int8_t: K4 (kInt4 false) or K5 (an int4 bank, kInt4).
// kRaw (K1, f32 and bf16): the caller's raw rows and labels, no s2 read;
// in l2 mode |q|^2 and |s|^2 come from the tensor cores by q.s's route
// (raw_slice, nw_tc.cuh), |s|^2 into the last slice's stage.
// The kernel lab's options (labs/kernel_lab.py, csrc/lab_nw.cu), off by
// default, so that K1, K2, K4, K5 and K6 compile as without them: kX3 (T =
// float) scores an f32 query against a bank split into bf16 hi and lo rows
// by x3_product (nw_tc.cuh), each slice's 32 features as two 64-byte
// boxes; kSplitP sums f32(bf16(p)) + f32(bf16(p - bf16(p))) into the
// classes in place of p_j, while l keeps the unsplit p. kStages, the
// slices of each group's ring, is kTcStages for every kernel but the lab's
// L3 manual_fused, which sweeps it (lab_nw.cu).
template <typename T, int kQB, bool kSel, bool kInt4, bool kRaw = false, bool kX3 = false,
          bool kSplitP = false, int kStages = kTcStages>
__global__ void __launch_bounds__(kTcBlock, 1)
    nw_prepared_tc_kernel(const TcArgs a, const __grid_constant__ TcMaps maps) {
  static_assert(kQB % kTcWarps == 0 && kQB <= kTcMaxQuery, "query tile");
  constexpr bool kQuant = std::is_same_v<T, int8_t>;
  static_assert(kQuant || !kInt4, "an int4 bank takes int8 queries");
  static_assert(!kRaw || (!kQuant && !kSel), "raw rows: f32 or bf16, no tile list");
  static_assert(!kX3 || (std::is_same_v<T, float> && !kRaw && !kSel), "x3: an f32 query");
  static_assert(kStages >= 2, "a ring of at least two slices");
  using Acc = typename vit::Frag<T>::Acc;  // f32, or exact int32 sums
  using TS = std::conditional_t<kX3, __nv_bfloat16, T>;  // the bank's element
  constexpr int kChunk = kTcRowBytes / static_cast<int>(sizeof(T));  // features a slice
  // Bytes a staged support row (x3: each of the hi and lo rows).
  constexpr int kBankRow = kX3 ? kX3RowBytes : tc_bank_row_bytes(kInt4);
  constexpr int kBankChunk = kBankRow / static_cast<int>(sizeof(TS));  // its elements a slice
  constexpr int kBankBoxes = kX3 ? 2 : 1;
  constexpr int kQA = tc_query_rows(kQB);
  constexpr bool kSplitK = tc_score_bufs(kQB) == 2;
  constexpr int kDepth = kSplitK ? kChunk / 2 : kChunk;  // features a warp takes of a slice
  constexpr int kOwn = kQB / kTcWarps;                   // queries a warp owns per tile
  constexpr int kStage = tc_stage_bytes(kQB);
  constexpr int kSupportOff = kQA * kTcRowBytes;             // the stage's support rows
  constexpr int kLabelOff = kSupportOff + kSupportTile * kTcRowBytes;  // labels, s2, scales
  constexpr int kQ2Lanes = kTcThreads / kQA;             // threads that sum one |q|^2
  constexpr int kQ2Feat = kChunk / kQ2Lanes;             // features each takes a slice
  constexpr int kScores = kQB * kTcScoreStride;
  constexpr int kGroupScores = tc_score_bufs(kQB) * kScores;

  extern __shared__ float4 smem4[];
  char* ring = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem4) + kTcAlign - 1) & ~static_cast<uintptr_t>(kTcAlign - 1));
  float* q2s = reinterpret_cast<float*>(ring + 2 * kStages * kStage);
  float* m_s = q2s + kTcMaxQuery;  // the queries' running max and sum
  float* l_s = m_s + kTcMaxQuery;
  int* list = reinterpret_cast<int*>(l_s + kTcMaxQuery);
  uint64_t* full = reinterpret_cast<uint64_t*>(list + (kSel ? kTcListCap + 4 : 0));
  uint64_t* empty = full + 2 * kStages;
  float* sc_all = reinterpret_cast<float*>(empty + 2 * kStages);  // 16-byte aligned
  float* acc = sc_all + 2 * kGroupScores;

  const int lane = threadIdx.x & 31;
  const bool producer = threadIdx.x >= 2 * kTcThreads;
  // The scoring group, or the group a producer warp feeds.
  const int group = producer ? (threadIdx.x - 2 * kTcThreads) / 32 : threadIdx.x / kTcThreads;
  const int tid = threadIdx.x % kTcThreads;    // the thread within its group
  const int warp = tid >> 5;
  const int ws = warp & 3;   // the warp's 16 rows of the support tile
  const int wh = warp >> 2;  // its m-tile of the queries, or (kSplitK) half of the features
  float* sc = sc_all + group * kGroupScores;  // the group's score tiles
  char* gring = ring + group * kStages * kStage;  // the group's ring
  uint64_t* gfull = full + group * kStages;
  uint64_t* gempty = empty + group * kStages;
  const int b0 = blockIdx.x * kQB;
  const int split = blockIdx.y;
  const float scale = kQuant ? 1.f : *a.scale;
  const bool l2 = a.l2_mode != 0, tma = a.tma != 0;
  const int C = a.C;
  const int nK = (a.D + kChunk - 1) / kChunk;  // slices a tile
  // int8/int4: the dequant column of each query this warp owns.
  float qc[kOwn];
#pragma unroll
  for (int o = 0; o < kOwn; ++o) {
    const int b = b0 + warp + kTcWarps * o;
    qc[o] = kQuant && !producer && b < a.B ? a.qcol[b] : 0.f;
  }

  for (int i = threadIdx.x; i < kQB * C; i += kTcBlock) acc[i] = 0.f;
  if (threadIdx.x < kTcMaxQuery) {
    m_s[threadIdx.x] = kNeg;
    l_s[threadIdx.x] = 0.f;
  }
  if (threadIdx.x == 0) {
    for (int k = 0; k < 2 * kStages; ++k) {
      mbar_init(full + k, 1);
      mbar_init(empty + k, kTcWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  Acc dacc[1][2][4];
  float s2d[2], q2d[2] = {};  // kRaw: a lane's diagonals of the self-products
  float q2_sum = 0.f;  // this thread's share of |q|^2 over the first tile's slices
  int used = 0;        // slices the group's ring has taken (its barriers' phases)
  int tiles = 0;       // tiles taken before this chunk (whose group, whose turn)

  int r_begin = 0, r_end = 0;
  const int* sel = nullptr;
  if constexpr (kSel) {
    sel = a.tile_sel + static_cast<size_t>(blockIdx.x / a.qtiles_per_row) * a.n_sel;
  } else {
    r_begin = split * a.rows_per_split;
    r_end = min(a.S, r_begin + a.rows_per_split);
  }
  int cursor = 0;  // K6 (warp 0): this split's score tiles looked at so far
  __syncthreads();
  // Group 0 takes the first softmax turn.
  if (group == 1 && !producer) asm volatile("bar.arrive 1, %0;\n" ::"n"(2 * kTcThreads));

  for (;;) {
    int n_tiles;
    if constexpr (kSel) {
      // Warp 0 lists the split's next non-empty tiles (bank rows), in order.
      if (threadIdx.x < 32) {
        const int n_score = a.n_sel * (a.block_s / kSupportTile);
        const int n_mine = split < n_score
                               ? (n_score - split + static_cast<int>(gridDim.y) - 1) /
                                     static_cast<int>(gridDim.y)
                               : 0;
        int n = 0;
        while (cursor < n_mine && n < kTcListCap) {
          const int i = cursor + lane;
          bool ok = false;
          int t0 = 0;
          if (i < n_mine) {
            const int v0 = (split + i * static_cast<int>(gridDim.y)) * kSupportTile;
            const int id = sel[v0 / a.block_s];
            ok = id >= 0 && id < a.n_tiles;
            t0 = id * a.block_s + v0 % a.block_s;
          }
          const unsigned bal = __ballot_sync(0xffffffffu, ok);
          const int pos = n + __popc(bal & ((1u << lane) - 1u));
          if (ok && pos < kTcListCap) list[pos] = t0;
          const int room = kTcListCap - n;
          if (__popc(bal) <= room) {
            n += __popc(bal);
            cursor += 32;
          } else {  // the list is full after the room-th of these: resume past it
            unsigned rest = bal;
            for (int k = 1; k < room; ++k) rest &= rest - 1u;
            cursor += __ffs(rest);
            n = kTcListCap;
          }
        }
        if (lane == 0) list[kTcListCap] = n;
      }
      __syncthreads();
      n_tiles = list[kTcListCap];
    } else {
      n_tiles = (r_end - r_begin + kSupportTile - 1) / kSupportTile;
    }
    if (n_tiles == 0) break;
    const auto origin = [&](int i) { return kSel ? list[i] : r_begin + i * kSupportTile; };
    const auto row_end = [&](int t0) { return kSel ? t0 + kSupportTile : r_end; };

    // Slice kc of tile i (features kc kChunk ..), the group's q-th, into its
    // stage, by the group's producer warp: by the TMA (lane 0; zeros past B,
    // the bank and D), or by plain loads (every lane). The last slice of a
    // tile brings its labels and self-norms.
    const auto load = [&](int i, int kc, int q) {
      const int t0 = origin(i), c0 = kc * kChunk, cs = kc * kBankChunk;
      char* st = gring + (q % kStages) * kStage;
      uint64_t* bar = gfull + q % kStages;
      const bool last = kc == nK - 1;
      if (tma) {
        if (lane == 0) {
          mbar_expect(bar, kQA * kTcRowBytes + kBankBoxes * kSupportTile * kBankRow +
                               (last ? (1 + (l2 && !kRaw) + kQuant) * kSupportTile * 4 : 0));
          tma_2d(st, &maps.q, c0, b0, bar);
          tma_2d(st + kSupportOff, &maps.s, cs, t0, bar);
          if (kX3) tma_2d(st + kSupportOff + kSupportTile * kBankRow, &maps.s_lo, cs, t0, bar);
          if (last) {
            tma_1d(st + kLabelOff, &maps.labels, t0, bar);
            if (l2 && !kRaw) tma_1d(st + kLabelOff + kSupportTile * 4, &maps.s2, t0, bar);
            if (kQuant) tma_1d(st + kLabelOff + 2 * kSupportTile * 4, &maps.sscale, t0, bar);
          }
        }
      } else {
        stage_plain<T, kQA>(static_cast<const T*>(a.q), a.D, b0, c0, min(a.B, b0 + kQB), st);
        stage_plain<TS, kSupportTile, kBankRow>(static_cast<const TS*>(a.s), a.ds, t0, cs,
                                                row_end(t0), st + kSupportOff);
        if constexpr (kX3) {
          stage_plain<TS, kSupportTile, kBankRow>(static_cast<const TS*>(a.s_lo), a.ds, t0, cs,
                                                  row_end(t0),
                                                  st + kSupportOff + kSupportTile * kBankRow);
        }
        for (int r = lane; last && r < kSupportTile; r += 32) {
          const bool ok = t0 + r < row_end(t0);
          float* tail = reinterpret_cast<float*>(st + kLabelOff);
          reinterpret_cast<int*>(tail)[r] = ok ? a.labels[t0 + r] : -1;
          if (l2 && !kRaw) tail[kSupportTile + r] = ok ? a.s2[t0 + r] : 0.f;
          if (kQuant) tail[2 * kSupportTile + r] = ok ? a.sscale[t0 + r] : 0.f;
        }
        __threadfence_block();
        __syncwarp();
        if (lane == 0) mbar_arrive(bar);
      }
    };

    const auto compute = [&](int i, int kc, int q) {
      const char* st = gring + (q % kStages) * kStage;
      if (kc == 0) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dacc[0][j][e] = 0;
        s2d[0] = s2d[1] = 0.f;
      }
      const bool first = tiles + i == 0;  // the block's first tile (group 0's)
      if constexpr (kRaw) {  // q.s and, in l2 mode, the self-norms beside it
        raw_slice<T, kQB>(st, ws, wh, l2, first, dacc, s2d, q2d);
      } else if constexpr (kX3) {
        x3_product<kDepth>(st + (kSplitK ? 0 : swz(16 * wh, 0)), st + kSupportOff, 16 * ws,
                           kSplitK ? wh * kDepth : 0, dacc);
      } else {
        tc_product<T, kInt4, 1, kDepth>(st + (kSplitK ? 0 : swz(16 * wh, 0)),
                                        st + kSupportOff, 16 * ws, kSplitK ? wh * kDepth : 0,
                                        dacc);
      }
      if (!kRaw && l2 && first) {
        // |q|^2 in f32: kQ2Lanes threads a query row, a fixed order; an
        // int8 query's dequantized (code x its scale, which l2 mode's
        // column is).
        const int r = tid / kQ2Lanes, f0 = (tid % kQ2Lanes) * kQ2Feat;
        const float qs = kQuant && r < kQB && b0 + r < a.B ? a.qcol[b0 + r] : 1.f;
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < kQ2Feat; ++k) {
          float v = vit::to_float(
              *reinterpret_cast<const T*>(st + swz(r, (f0 + k) * static_cast<int>(sizeof(T)))));
          if constexpr (kQuant) v *= qs;
          sum = fmaf(v, v, sum);
        }
#pragma unroll
        for (int o = kQ2Lanes / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        q2_sum += sum;
      }
      if (kc != nK - 1) return;

      // The tile's dot products into the group's score tile (at kSplitK each
      // half of the features into its own), then, in the tile's turn, its
      // softmax and label sum.
      float* scw = sc + (kSplitK ? wh * kScores : 0);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = (kSplitK ? 0 : 16 * wh) + (lane >> 2) + 8 * h;
          const int col = 16 * ws + 8 * j + 2 * (lane & 3);
          if (row < kQB) {
            if constexpr (kQuant) {  // the integer sums, as they are
              *reinterpret_cast<int2*>(scw + row * kTcScoreStride + col) =
                  make_int2(dacc[0][j][2 * h], dacc[0][j][2 * h + 1]);
            } else {
              *reinterpret_cast<float2*>(scw + row * kTcScoreStride + col) =
                  make_float2(dacc[0][j][2 * h], dacc[0][j][2 * h + 1]);
            }
          }
        }
      if constexpr (kRaw) {
        if (l2) {
          raw_self_store<kQB>(s2d, q2d, ws, wh, first,
                              reinterpret_cast<float*>(gring + (q % kStages) * kStage +
                                                       kLabelOff) + kSupportTile,
                              q2s);
        }
      } else if (l2 && first && tid % kQ2Lanes == 0 && tid / kQ2Lanes < kQB) {
        q2s[tid / kQ2Lanes] = q2_sum;
      }
      group_sync(group);
      // The other group's softmax of the tile before is done.
      if (group == 0) {
        asm volatile("bar.sync 1, %0;\n" ::"n"(2 * kTcThreads) : "memory");
      } else {
        asm volatile("bar.sync 2, %0;\n" ::"n"(2 * kTcThreads) : "memory");
      }

      const int* lab = reinterpret_cast<const int*>(st + kLabelOff);
      const float* s2t = reinterpret_cast<const float*>(lab + kSupportTile);
      const int t0 = origin(i);
      const int n_valid = min(kSupportTile, row_end(t0) - t0);
      const int y0 = lane < n_valid ? lab[lane] : -1;
      const int y1 = lane + 32 < n_valid ? lab[lane + 32] : -1;
      // kRaw: the self-norms raw_self_store left in the stage, as halves.
      const float s20 = !l2 ? 0.f : kRaw ? raw_norm<kQB>(s2t, lane, kSupportTile) : s2t[lane];
      const float s21 = !l2    ? 0.f
                        : kRaw ? raw_norm<kQB>(s2t, lane + 32, kSupportTile)
                               : s2t[lane + 32];
      const float* sst = s2t + kSupportTile;  // int8/int4: the rows' scales
      const float ss0 = kQuant ? sst[lane] : 0.f, ss1 = kQuant ? sst[lane + 32] : 0.f;
      // The warp's kOwn queries side by side, so that their shuffle trees
      // interleave: x holds the scores, then the p_j.
      float x0[kOwn], x1[kOwn], v[kOwn], alpha[kOwn];
#pragma unroll
      for (int o = 0; o < kOwn; ++o) {
        const int b = warp + kTcWarps * o;
        const float* row = sc + b * kTcScoreStride;
        float d0, d1;
        if constexpr (kQuant) {
          // (dot * qcol) * sscale, the TPU kernel's order; the halves'
          // integer sums add exactly.
          const int* ri = reinterpret_cast<const int*>(row);
          const int i0 = kSplitK ? ri[lane] + ri[kScores + lane] : ri[lane];
          const int i1 = kSplitK ? ri[lane + 32] + ri[kScores + lane + 32] : ri[lane + 32];
          d0 = __int2float_rn(i0) * qc[o] * ss0;
          d1 = __int2float_rn(i1) * qc[o] * ss1;
        } else {
          d0 = kSplitK ? row[lane] + row[kScores + lane] : row[lane];
          d1 = kSplitK ? row[lane + 32] + row[kScores + lane + 32] : row[lane + 32];
        }
        const float q2 = !l2 ? 0.f : kRaw ? raw_norm<kQB>(q2s, b, 16) : q2s[b];
        // int8/int4: the similarity scale rides in the query's column.
        x0[o] = y0 < 0 ? kNeg : l2 ? -l2_dist(q2, d0, s20) : kQuant ? d0 : d0 * scale;
        x1[o] = y1 < 0 ? kNeg : l2 ? -l2_dist(q2, d1, s21) : kQuant ? d1 : d1 * scale;
        v[o] = fmaxf(x0[o], x1[o]);
      }
      warp_max_n(v);
      float m_new[kOwn];
#pragma unroll
      for (int o = 0; o < kOwn; ++o) {
        const float m_prev = m_s[warp + kTcWarps * o];
        m_new[o] = fmaxf(m_prev, v[o]);
        const float m_safe = m_new[o] > kNeg / 2 ? m_new[o] : 0.f;
        alpha[o] = m_prev > kNeg / 2 ? expf(m_prev - m_safe) : 0.f;
        x0[o] = x0[o] > kNeg / 2 ? expf(x0[o] - m_safe) : 0.f;
        x1[o] = x1[o] > kNeg / 2 ? expf(x1[o] - m_safe) : 0.f;
        v[o] = x0[o] + x1[o];
      }
      warp_sum_n(v);
      if constexpr (kSplitP) {  // the classes take p as two bf16 terms; l took it whole
#pragma unroll
        for (int o = 0; o < kOwn; ++o) {
          x0[o] = bf16_pair(x0[o]);
          x1[o] = bf16_pair(x1[o]);
        }
      }
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (int o = 0; o < kOwn; ++o) {
          const int b = warp + kTcWarps * o;
          l_s[b] = l_s[b] * alpha[o] + v[o];
          m_s[b] = m_new[o];
        }
      }
#pragma unroll
      for (int o = 0; o < kOwn; ++o) {
        if (alpha[o] != 1.f) {  // x * 1 is x: the sweep would change no bit
          float* acc_row = acc + (warp + kTcWarps * o) * C;
          if ((C & 3) == 0) {  // rows of whole float4s: independent 16-byte accesses
            float4* row4 = reinterpret_cast<float4*>(acc_row);
#pragma unroll 4
            for (int c = lane; c < C / 4; c += 32) {
              float4 x = row4[c];
              x.x *= alpha[o];
              x.y *= alpha[o];
              x.z *= alpha[o];
              x.w *= alpha[o];
              row4[c] = x;
            }
          } else {
#pragma unroll 4
            for (int c = lane; c < C; c += 32) acc_row[c] *= alpha[o];
          }
        }
      }
      __syncwarp();
      // The label sum, one writer per class and a fixed order. Up to
      // kTcMaxClasses classes of the tile (the class of its lowest row not
      // yet summed, in turn: one or two in a class-sorted bank, a few in a
      // cluster of an IVF bank) each get their p_j summed in warp_sum's
      // fixed tree and added once by lane 0. Every warp finds the same
      // classes. A tile whose first two classes hold fewer than 4 of its
      // rows has many classes (a bank in row order: about 62 in 64 rows at
      // C = 1,000), and leaves its rows to the groups below.
      unsigned long long rest =
          static_cast<unsigned long long>(__ballot_sync(0xffffffffu, y0 >= 0 && y0 < C)) |
          (static_cast<unsigned long long>(__ballot_sync(0xffffffffu, y1 >= 0 && y1 < C)) << 32);
      int summed = 0;  // rows the reductions have taken
      for (int n = 0; n < kTcMaxClasses && rest != 0ull && (n != 2 || summed >= 4); ++n) {
        const int r0 = __ffsll(static_cast<long long>(rest)) - 1;
        const int ya = __shfl_sync(0xffffffffu, y0, r0 & 31);
        const int yb = __shfl_sync(0xffffffffu, y1, r0 & 31);
        const int y = r0 < 32 ? ya : yb;
        const bool in0 = y0 == y, in1 = y1 == y;
        const unsigned long long taken =
            static_cast<unsigned long long>(__ballot_sync(0xffffffffu, in0)) |
            (static_cast<unsigned long long>(__ballot_sync(0xffffffffu, in1)) << 32);
        summed += __popcll(taken);
        rest &= ~taken;
#pragma unroll
        for (int o = 0; o < kOwn; ++o) v[o] = (in0 ? x0[o] : 0.f) + (in1 ? x1[o] : 0.f);
        warp_sum_n(v);
        if (lane == 0) {
#pragma unroll
          for (int o = 0; o < kOwn; ++o) acc[(warp + kTcWarps * o) * C + y] += v[o];
        }
      }
      if (rest != 0ull) {
        // The rows of the classes left: rows j and j' whose classes agree
        // mod 32 form a group (__match_any_sync, within each half of the
        // tile); its first lane adds the group's p_j in row order, the first
        // half before the second. So each class has one writer at a time,
        // and a warp takes as many steps as its largest group, not 64.
#pragma unroll
        for (int o = 0; o < kOwn; ++o) {
          float* row = sc + (warp + kTcWarps * o) * kTcScoreStride;
          row[lane] = x0[o];
          row[lane + 32] = x1[o];
        }
        __syncwarp();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int y = h ? y1 : y0;
          const bool ok = (rest >> (32 * h + lane)) & 1ull;
          const unsigned grp = __match_any_sync(0xffffffffu, ok ? (y & 31) : 32 + lane);
          if (ok && lane == __ffs(grp) - 1) {
            for (unsigned more = grp; more != 0u; more &= more - 1u) {
              const int j = 32 * h + __ffs(more) - 1;
              const int yj = lab[j];
#pragma unroll
              for (int o = 0; o < kOwn; ++o) {
                acc[(warp + kTcWarps * o) * C + yj] +=
                    sc[(warp + kTcWarps * o) * kTcScoreStride + j];
              }
            }
          }
          __syncwarp();
        }
      }
      // The next tile's turn is the other group's; this group's warps are
      // all done with its score tile before any writes its next tile's.
      if (group == 0) {
        asm volatile("bar.arrive 2, %0;\n" ::"n"(2 * kTcThreads) : "memory");
      } else {
        asm volatile("bar.arrive 1, %0;\n" ::"n"(2 * kTcThreads) : "memory");
      }
      group_sync(group);
    };

    // Each group's ring: its q-th slice (counted over its tiles and the
    // block's chunks) goes to stage q mod kStages, its u-th use, u = q /
    // kStages: full completes when the slice has landed, empty when the
    // group's eight warps are done with it, once a use, so use u waits on
    // phase parity u & 1 of full and the producer on (u - 1) & 1 of empty
    // (the use before), at any depth. The producer runs up to kStages
    // slices ahead of its group; each group's ring is its own, so no depth
    // ties one group's producer to the other group's softmax turn.
    int q = used;
    for (int i = (tiles + group) % 2; i < n_tiles; i += 2) {
      for (int kc = 0; kc < nK; ++kc, ++q) {
        const int u = q / kStages;
        if (producer) {
          if (u > 0) mbar_wait(gempty + q % kStages, (u - 1) & 1);
          load(i, kc, q);
        } else {
          mbar_wait(gfull + q % kStages, u & 1);
          compute(i, kc, q);
          __syncwarp();
          if (lane == 0) mbar_arrive(gempty + q % kStages);
        }
      }
    }
    used = q;
    tiles += n_tiles;
    if constexpr (!kSel) break;
    __syncthreads();  // every warp is done with the ring and the list
  }

  // The group whose turn is next takes the last turn's arrival.
  if (!producer && group == tiles % 2) {
    if (group == 0) {
      asm volatile("bar.sync 1, %0;\n" ::"n"(2 * kTcThreads) : "memory");
    } else {
      asm volatile("bar.sync 2, %0;\n" ::"n"(2 * kTcThreads) : "memory");
    }
  }
  __syncthreads();
  if (producer) return;
  for (int b = 0; b < kQB && b0 + b < a.B; ++b) {
    float* dst = a.acc_out + (static_cast<size_t>(split) * a.B + b0 + b) * C;
    for (int c = threadIdx.x; c < C; c += 2 * kTcThreads) dst[c] = acc[b * C + c];
  }
  if (threadIdx.x < kQB && b0 + threadIdx.x < a.B) {
    a.m_out[static_cast<size_t>(split) * a.B + b0 + threadIdx.x] = m_s[threadIdx.x];
    a.l_out[static_cast<size_t>(split) * a.B + b0 + threadIdx.x] = l_s[threadIdx.x];
  }
}

template <typename T, int kQB, bool kSel, bool kInt4, bool kRaw, bool kX3 = false,
          bool kSplitP = false, int kStages = kTcStages>
cudaError_t launch_tc_pass1(cudaStream_t stream, const TcArgs& a, int bank_rows, int n_splits) {
  const size_t smem = tc_smem_bytes(kQB, a.C, kSel, kStages);
  const auto kernel = nw_prepared_tc_kernel<T, kQB, kSel, kInt4, kRaw, kX3, kSplitP, kStages>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  constexpr bool kQuant = std::is_same_v<T, int8_t>;
  using TS = std::conditional_t<kX3, __nv_bfloat16, T>;
  TcMaps maps{};
  TcArgs args = a;
  constexpr CUtensorMapDataType kType =
      kQuant ? CU_TENSOR_MAP_DATA_TYPE_UINT8
             : std::is_same_v<T, float> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapDataType kSType = kX3 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : kType;
  constexpr int kElem = static_cast<int>(sizeof(T));
  constexpr int kSElem = static_cast<int>(sizeof(TS));
  constexpr int kBankRow = kX3 ? kX3RowBytes : tc_bank_row_bytes(kInt4);
  const auto vector_ok = [&](CUtensorMap* map, const void* v) {
    return reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
           encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, v, bank_rows, 0, 0);
  };
  // The TMA addresses rows of a multiple of 16 bytes from a 16-byte aligned
  // base; anything else is staged by plain loads.
  args.tma = vit::vec16_ok<T>(a.q, a.D) && vit::vec16_ok<TS>(a.s, a.ds) &&
             reinterpret_cast<uintptr_t>(a.labels) % 16 == 0 &&
             encode_map(&maps.q, kType, kElem, a.q, a.B, a.D, tc_query_rows(kQB)) &&
             encode_map(&maps.s, kSType, kSElem, a.s, bank_rows, a.ds, kSupportTile, kBankRow) &&
             (!kX3 || (vit::vec16_ok<TS>(a.s_lo, a.ds) &&
                       encode_map(&maps.s_lo, kSType, kSElem, a.s_lo, bank_rows, a.ds,
                                  kSupportTile, kBankRow))) &&
             encode_map(&maps.labels, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, a.labels, bank_rows, 0,
                        0) &&
             (!a.l2_mode || kRaw || vector_ok(&maps.s2, a.s2)) &&
             (!kQuant || vector_ok(&maps.sscale, a.sscale));
  const dim3 grid((a.B + kQB - 1) / kQB, n_splits);
  kernel<<<grid, kTcBlock, smem, stream>>>(args, maps);
  return cudaGetLastError();
}

// Pass 1 (the tensor-core kernel with kQB = qb) then pass 2 on `stream`.
template <typename T, bool kSel, bool kInt4 = false, bool kRaw = false, bool kX3 = false,
          bool kSplitP = false, int kStages = kTcStages>
cudaError_t launch_tc_forward(cudaStream_t stream, int qb, const TcArgs& a, int bank_rows,
                              int n_splits, bool partials, void* out, void* m_final,
                              void* l_final) {
  cudaError_t err = cudaErrorInvalidValue;
  switch (qb) {
    case 8:
      err = launch_tc_pass1<T, 8, kSel, kInt4, kRaw, kX3, kSplitP, kStages>(stream, a, bank_rows,
                                                                       n_splits);
      break;
    case 16:
      err = launch_tc_pass1<T, 16, kSel, kInt4, kRaw, kX3, kSplitP, kStages>(stream, a, bank_rows,
                                                                        n_splits);
      break;
    case 32:
      err = launch_tc_pass1<T, 32, kSel, kInt4, kRaw, kX3, kSplitP, kStages>(stream, a, bank_rows,
                                                                        n_splits);
      break;
    default: break;
  }
  if (err != cudaSuccess) return err;
  return launch_merge(stream, partials, a.m_out, a.l_out, a.acc_out, n_splits, a.B, a.C, out,
                      m_final, l_final);
}

// Whether the tensor-core pass 1 takes query tiles of qb for C classes,
// with rings of `stages` slices, on `device`.
inline bool tc_config_ok(int qb, int C, bool sel, int device, int stages = kTcStages) {
  if (qb != 8 && qb != 16 && qb != 32) return false;
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess) {
    return false;
  }
  return tc_smem_bytes(qb, C, sel, stages) <= static_cast<size_t>(optin);
}
}  // namespace nw
