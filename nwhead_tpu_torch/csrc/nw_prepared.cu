// Fused Nadaraya-Watson head's forward pass 1 on the tensor cores, for
// Hopper (sm_90a), over a prepared support bank or raw support rows.
//
// One pass 1 (nw_prepared_tc_kernel, in nw_pass1.cuh, which the kernel
// lab's lab_nw.cu also runs) serves every prepared bank: K2 (f32
// and bf16 banks), K4 (int8), K5 (int4), and K6 (tile_sel) over all four;
// and, with kRaw, K1 over raw f32 or bf16 rows (nw_raw_forward, the
// training path's forward and the raw shards' and host chunks' partials).
// K2 replaces the TPU kernel nwhead_tpu/ops/pallas_nw.py:_nw_prepared_kernel
// on float banks, K1 its _nw_fwd_kernel. The pass it computes is written
// out in nw_common.cuh; a prepared bank's self-norms s2 come precomputed
// (1e30 on masked rows) and a bf16 bank takes a bf16 query. Raw rows bring
// no s2 and may hold NaN in masked rows: in l2 mode |q|^2 and |s_j|^2 are
// diagonals of self-products on the tensor cores, by the very calls that
// give q.s_j (nw_tc.cuh: raw_slice), so that a query equal to a
// support row (a query drawn into its own training episode) scores exactly
// 0, as the TPU kernel's one-order f32 sums give it. s2 is taken in the
// pass, once a tile per block (at B = 64 the two query tiles' blocks each
// take it), in the very tc_product call of the warp's 16 x 16 of scores:
// one more n-tile a warp and slice (two at split-K), whose left factor is
// the call's own B fragments. It cost K1's pass 1 +35% in f32 and +2% in
// bf16 over K2's on a 65,536-row chunk (H100 80GB HBM3,
// labs/raw_head_lab.py); a pre-pass over S would read the rows once more.
//
// What bounds it: the bank's bytes and the score products. At the
// million-row bank (2^20 rows, D = 512) and B = 64 the f32 bank is 2.1 GB,
// 0.64 ms at the card's 3.35 TB/s, and the products 2 B S D = 69 GFLOP,
// 0.42 ms at 165 TFLOP/s (three TF32 passes) or 0.07 ms in bf16. Behind
// them lies what each 64-row tile costs beside its products: the softmax
// state of every query, acc[b][C] (4 KB a query at C = 1,000), is rescaled
// as its running max grows and gains p_j at each row's class. The design
// (nw_prepared_tc_kernel, one template for K2, K4, K5 and K6):
//   * Pass 1 runs on a grid of (query tiles of kQB) x (support splits);
//     acc[kQB][C] lives in shared memory, so kQB follows C: the wrapper
//     takes the largest of 32, 16 and 8 whose block fits (32 at the CUB
//     bank's C = 200 and at C = 1,000, where the L2 serves each bank tile
//     to two blocks; 8 up to C = 4,768). The split count fills the SMs
//     once (a block keeps its own loads in flight, so it needs no other
//     block to cover its waits), since each split costs B x C x 4 bytes of
//     partials written here and read again by pass 2.
//   * Slices of 128 bytes of features (32 f32, 64 bf16 or 128 int8) of the
//     block's query rows and of a 64-row support tile come by the TMA (two
//     boxes of tensor maps, 128-byte swizzled so that fragment loads hit
//     distinct banks; zeros past B, the bank and D), the tile's labels,
//     self-norms and (int8/int4) row scales with its last slice. Copies by
//     cp.async, 16 bytes a thread, stalled the warps that issued them:
//     loads, products and softmax then took their times one after another
//     (1.85 + 1.5 + 0.65 ms of K2 f32's 4.05 on the million-row bank, H100
//     80GB HBM3).
//   * Two scoring groups of eight warps take the tiles in turn, each with
//     its own 3-stage ring, mbarriers and producer warp: one group's
//     products overlap the other's softmax. Products on the tensor cores:
//     bf16 mma.sync m16n8k16 with f32 sums (products of bf16 values are
//     exact), f32 on 3xTF32 m16n8k8, int8/int4 on s8 m16n8k32 with int32
//     sums. A warp covers 16 queries x 16 rows over the slice (at kQB <= 16
//     half the slice's features, the halves' sums added in a fixed order),
//     its independent accumulators issued in turn. |q|^2 (l2 mode) is
//     summed from the first tile's staged slices (kRaw: see above).
//   * Per tile, in the tile's turn (named barriers between the groups, so
//     acc, m and l take their terms in row order), each warp owns kQB / 8
//     queries: l2 or dot scores and the mask, the online softmax with its
//     m_safe / alpha guards (acc *= alpha skipped when alpha is exactly 1,
//     which changes no bit), and the label sum with one writer per class
//     and a fixed order. Up to 8 classes of the tile (one or two in a
//     class-sorted bank: at C > 128 prepare_support sorts, as the TPU
//     kernel's class window assumes; a few in an IVF bank's cluster) each
//     get their p_j summed by a warp reduction in a fixed tree and added
//     once; the rows of any further classes (banks at C <= 128, keep_order
//     banks, raw rows) go by class mod 32 to one lane each, in row order.
//     A tile whose first two classes hold fewer than 4 rows (rows in bank
//     order: about 62 classes in 64 rows at C = 1,000) goes to the lanes
//     at once: with eight reductions of a row or two each first, K2's
//     pass 1 on 65,536 such rows took 0.1315 ms against 0.0785 sorted
//     (bf16, C = 1,000, H100 80GB HBM3, labs/raw_head_lab.py).
//   * Pass 2 (nw_merge_kernel) merges the splits exactly and takes the log,
//     or leaves the merged (m, l, acc) unfinalized (partials=True).
// No float atomics anywhere: two calls on the same inputs give the same
// bits.
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
// They run the pass above with T = int8_t; only the product and the score
// differ. An int8 slice is 128 codes (D = 512 is 4 slices a tile). The
// int32 sums are exact in any order, so dot_i is the plain version's
// integer and float(dot_i) its f32 (round to nearest, as .to(float32)):
// the scores are its bits up to |q|^2's summation order. An int4 slice is
// 64 packed bytes of each support row (boxes of 64 bytes, the TMA's 64-byte
// swizzle), the 128 features of the slice's 128 query bytes: a thread's
// 32-bit load of packed bytes 4t .. 4t + 3 gives both of its B registers,
// the low nibbles minus 8 for k = 4t .. 4t + 3 and the high nibbles
// sign-extended for k = 16 + 4t .. 16 + 4t + 3, per byte and exactly
// (__vsub4 borrows nothing across bytes), so the bank is never widened in
// memory. The query comes in the matching order (the wrapper permutes its
// columns once a batch: for each run of 16 packed bytes, their 16 low
// features, then their 16 high ones), which changes no exact sum. At the
// million-row bank the int8 bank is 0.54 GB (0.16 ms at 3.35 TB/s; int4
// 0.08 ms) and the products 69 G int8 operations (0.03 ms at 1,979 TOP/s):
// the per-tile softmax and label sum are what is left, as for K2 bf16.
//
// K6 replaces the same TPU kernel with tile_sel (n_sel > 0,
// nwhead_tpu/ops/pallas_nw.py:850-856, :969-975): the pass of K2/K4/K5
// (nw_prepared_tc_kernel with kSel) over only the bank tiles a list names,
// for IVF-pruned serving (nwhead_tpu_torch/ops/ivf.py). The bank is tiled
// in block_s rows (a multiple of 128); slot r of the list names bank tile
// tile_sel[r], -1 an empty slot. The list is one row shared by the batch, or
// one row per group of queries (grouped routing), and a query tile of kQB
// queries reads row blockIdx.x / qtiles_per_row: the wrapper pads each
// group to whole query tiles. What bounds it is what bounds K2/K4/K5, over
// the union's rows instead of the bank's. Slot-order row v is bank row
// tile_sel[v / block_s] * block_s + v % block_s, and a 64-row score tile
// never straddles two slots, so an empty slot (or an id past the bank)
// skips the whole tile and leaves the running state as it was. The split
// count comes from n_sel, a static shape: nothing is read back to the
// host, so how many slots hold a tile is known only here. The union's ids
// come first in the list (ascending, -1 padding after them), so split p
// takes score tiles p, p + n_splits, p + 2 n_splits, ...: a union of any
// size spreads over every split, where ranges of slots would leave it to
// the first few; a block first gathers its non-empty tiles into a list (up
// to kTcListCap at a time), so that its ring streams only those. Pass 2 is
// the same exact merge.

#include "nw_pass1.cuh"

namespace nw {

// Pass 1 and 2 for a bank of `bank` (0 f32, 1 bf16, 2 int8, 3 int4).
template <bool kSel>
cudaError_t launch_bank(cudaStream_t stream, int bank, int qb, const TcArgs& a, int bank_rows,
                        int n_splits, bool partials, void* out, void* m_final, void* l_final) {
  switch (bank) {
    case 0:
      return launch_tc_forward<float, kSel>(stream, qb, a, bank_rows, n_splits, partials, out,
                                            m_final, l_final);
    case 1:
      return launch_tc_forward<__nv_bfloat16, kSel>(stream, qb, a, bank_rows, n_splits, partials,
                                                    out, m_final, l_final);
    case 2:
      return launch_tc_forward<int8_t, kSel, false>(stream, qb, a, bank_rows, n_splits, partials,
                                                    out, m_final, l_final);
    case 3:
      return launch_tc_forward<int8_t, kSel, true>(stream, qb, a, bank_rows, n_splits, partials,
                                                   out, m_final, l_final);
    default: return cudaErrorInvalidValue;
  }
}

// The checks and arguments every entry point shares: the query is (B, D)
// (an int8 query for an int4 bank in the bank's k order: D rounded up to
// 32); d_pad the bank's feature width (int8/int4: a multiple of 4 / 8);
// raw rows (K1) bring no s2.
inline cudaError_t prepared_args(const void* q, const void* s, const void* s2,
                                 const void* labels, const void* scale, const void* qcol,
                                 const void* sscale, int B, int d_pad, int C, int l2_mode,
                                 int bank, int qb, bool sel, bool partials, void* m_final,
                                 void* l_final, TcArgs* a, bool raw = false) {
  const bool quant = bank == 2 || bank == 3;
  if (bank < 0 || bank > 3 || B <= 0 || d_pad <= 0 || C <= 0 || q == nullptr ||
      s == nullptr || labels == nullptr || (l2_mode && s2 == nullptr && !raw) ||
      (partials && (m_final == nullptr || l_final == nullptr)) ||
      (quant ? (qcol == nullptr || sscale == nullptr || d_pad % (bank == 3 ? 8 : 4) != 0)
             : scale == nullptr)) {
    return cudaErrorInvalidValue;
  }
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (C > max_forward_classes(device) || !tc_config_ok(qb, C, sel, device)) {
    return cudaErrorInvalidValue;
  }
  *a = TcArgs{};
  a->q = q;
  a->s = s;
  a->s2 = static_cast<const float*>(s2);
  a->labels = static_cast<const int*>(labels);
  a->scale = static_cast<const float*>(scale);
  a->qcol = static_cast<const float*>(qcol);
  a->sscale = static_cast<const float*>(sscale);
  a->l2_mode = l2_mode;
  a->B = B;
  a->D = bank == 3 ? (d_pad + 31) / 32 * 32 : d_pad;
  a->ds = bank == 3 ? d_pad / 2 : d_pad;
  a->C = C;
  return cudaSuccess;
}

}  // namespace nw

extern "C" {

int nw_prepared_support_tile() { return nw::kSupportTile; }

// Largest class count whose K1-layout accumulator fits the device's shared
// memory (nw_common.cuh); every prepared-bank entry point refuses more,
// though the tensor-core pass 1 would take up to 4,768 at its 8-query tile.
int nw_prepared_max_classes(int device) { return nw::max_forward_classes(device); }

const char* nw_prepared_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The tensor-core pass 1's dynamic shared memory for query tiles of qb
// and n_classes classes, with (sel != 0) or without K6's tile list.
int nw_prepared_tc_smem_bytes(int qb, int n_classes, int sel) {
  return static_cast<int>(nw::tc_smem_bytes(qb, n_classes, sel != 0));
}

// The shared memory a block may opt in to on `device`; 0 on error.
int nw_prepared_smem_optin(int device) {
  int bytes = 0;
  return cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) ==
                 cudaSuccess
             ? bytes
             : 0;
}

// K2: q (B, D), s (S, D) in f32 or bf16 (bf16 != 0); s2 (S,) f32 (l2 mode
// only, may be null otherwise); labels (S,) int32, -1 = masked; scale (1,)
// f32; partials m, l (n_splits, B) and acc (n_splits, B, C) f32 scratch;
// out (B, C) f32; qb the query tile (8, 16 or 32, and its block must fit
// the device's shared memory). partials != 0: out receives the merged
// label sums unfinalized and m_final, l_final (B,) f32 the softmax
// statistics they are relative to (the partials=True route; an all-masked
// query gives -FLT_MAX, 0, 0); otherwise out receives the log-probs and
// m_final, l_final may be null. Launches on `stream`, does not
// synchronize, returns cudaGetLastError().
int nw_prepared_forward(const void* q, const void* s, const void* s2,
                        const void* labels, const void* scale, void* m_part,
                        void* l_part, void* acc_part, void* out, void* m_final,
                        void* l_final, int B, int S, int D, int C, int l2_mode, int bf16,
                        int n_splits, int rows_per_split, int qb, int partials, void* stream) {
  nw::TcArgs a{};
  if (!nw::forward_args_ok(B, S, D, C, n_splits, rows_per_split) ||
      rows_per_split % nw::kSupportTile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err =
      nw::prepared_args(q, s, s2, labels, scale, nullptr, nullptr, B, D, C, l2_mode, bf16 ? 1 : 0,
                        qb, false, partials != 0, m_final, l_final, &a);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.S = S;
  a.rows_per_split = rows_per_split;
  a.m_out = static_cast<float*>(m_part);
  a.l_out = static_cast<float*>(l_part);
  a.acc_out = static_cast<float*>(acc_part);
  return static_cast<int>(nw::launch_bank<false>(static_cast<cudaStream_t>(stream), bf16 ? 1 : 0,
                                                 qb, a, S, n_splits, partials != 0, out, m_final,
                                                 l_final));
}

// K1 (TPU nwhead_tpu/ops/pallas_nw.py:579 _nw_fwd_kernel) on the
// tensor-core pass 1 over raw rows (kRaw): q (B, D), s (S, D) in f32 or
// bf16 (bf16 != 0), any D (rows the TMA cannot address are staged by plain
// loads); labels (S,) int32, -1 = masked (a masked row may hold anything,
// NaN included); scale (1,) f32; in l2 mode |q|^2 and |s|^2 from the tensor
// cores by q.s's route, so a query equal to a support row scores exactly 0.
// m_final, l_final (B,) f32 always receive the merged softmax statistics;
// the rest as nw_prepared_forward's. Launches on `stream`, does not
// synchronize, returns cudaGetLastError().
int nw_raw_forward(const void* q, const void* s, const void* labels, const void* scale,
                   void* m_part, void* l_part, void* acc_part, void* out, void* m_final,
                   void* l_final, int B, int S, int D, int C, int l2_mode, int bf16,
                   int n_splits, int rows_per_split, int qb, int partials, void* stream) {
  nw::TcArgs a{};
  if (!nw::forward_args_ok(B, S, D, C, n_splits, rows_per_split) ||
      rows_per_split % nw::kSupportTile != 0 || m_final == nullptr || l_final == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err =
      nw::prepared_args(q, s, nullptr, labels, scale, nullptr, nullptr, B, D, C, l2_mode,
                        bf16 ? 1 : 0, qb, false, partials != 0, m_final, l_final, &a, true);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.S = S;
  a.rows_per_split = rows_per_split;
  a.m_out = static_cast<float*>(m_part);
  a.l_out = static_cast<float*>(l_part);
  a.acc_out = static_cast<float*>(acc_part);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? nw::launch_tc_forward<__nv_bfloat16, false, false, true>(
                 st, qb, a, S, n_splits, partials != 0, out, m_final, l_final)
           : nw::launch_tc_forward<float, false, false, true>(st, qb, a, S, n_splits,
                                                              partials != 0, out, m_final,
                                                              l_final));
}

// K4 (int4 == 0) and K5 (int4 != 0): D the padded feature width (a
// multiple of 4, of 8 for int4); s (S, D) int8 codes, or (S, D / 2) packed
// int4 bytes; q the int8 codes, (B, D) for an int8 bank, or for an int4
// bank (B, D rounded up to 32) in the bank's k order (see the note at the
// top); s2 (S,) f32 (l2 mode only, may be null otherwise); labels (S,)
// int32, -1 = masked; qcol (B,) f32 the query's dequant scale (times the
// similarity scale in dot mode); sscale (S,) f32 the rows' scales; qb,
// partials, out, m_final, l_final and partials as nw_prepared_forward's.
// Launches on `stream`, does not synchronize, returns cudaGetLastError().
int nw_prepared_quant_forward(const void* q, const void* s, const void* s2, const void* labels,
                              const void* qcol, const void* sscale, void* m_part, void* l_part,
                              void* acc_part, void* out, void* m_final, void* l_final, int B,
                              int S, int D, int C, int l2_mode, int int4, int n_splits,
                              int rows_per_split, int qb, int partials, void* stream) {
  nw::TcArgs a{};
  if (!nw::forward_args_ok(B, S, D, C, n_splits, rows_per_split) ||
      rows_per_split % nw::kSupportTile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bank = int4 ? 3 : 2;
  const cudaError_t err = nw::prepared_args(q, s, s2, labels, nullptr, qcol, sscale, B, D, C,
                                            l2_mode, bank, qb, false, partials != 0, m_final,
                                            l_final, &a);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.S = S;
  a.rows_per_split = rows_per_split;
  a.m_out = static_cast<float*>(m_part);
  a.l_out = static_cast<float*>(l_part);
  a.acc_out = static_cast<float*>(acc_part);
  return static_cast<int>(nw::launch_bank<false>(static_cast<cudaStream_t>(stream), bank, qb, a,
                                                 S, n_splits, partials != 0, out, m_final,
                                                 l_final));
}

// K6: the pass of nw_prepared_forward (bank 0 f32, 1 bf16) or
// nw_prepared_quant_forward (bank 2 int8, 3 int4; q and D as there) over
// the bank tiles that tile_sel names. The bank has n_tiles * block_s rows,
// block_s a multiple of 64; tile_sel is (n_rows, n_sel) int32, -1 = empty
// slot (an id outside [0, n_tiles) is skipped too); query tile i (qb
// queries: 8, 16 or 32) reads row i / qtiles_per_row. scale (1,) f32 goes
// with a float bank; qcol (B,) and sscale (n_tiles * block_s,) f32 with a
// quantized one, as in those entry points. n_splits splits share the
// n_sel * block_s / 64 score tiles of slot-order rows in turn; partials m,
// l (n_splits, B), acc (n_splits, B, C), out (B, C), m_final, l_final and
// partials as nw_prepared_forward's (empty slots and masked-only tiles
// leave a query at -FLT_MAX, 0, 0). Launches on `stream`, does not
// synchronize, returns cudaGetLastError().
int nw_prepared_sel_forward(const void* q, const void* s, const void* s2, const void* labels,
                            const void* scale, const void* qcol, const void* sscale,
                            const void* tile_sel, void* m_part, void* l_part, void* acc_part,
                            void* out, void* m_final, void* l_final, int B, int D, int C,
                            int l2_mode, int bank, int n_sel, int qtiles_per_row, int n_tiles,
                            int block_s, int n_splits, int qb, int partials, void* stream) {
  nw::TcArgs a{};
  if (n_sel <= 0 || block_s <= 0 || block_s % nw::kSupportTile != 0 || n_tiles <= 0 ||
      qtiles_per_row <= 0 || static_cast<long long>(n_sel) * block_s > INT_MAX ||
      static_cast<long long>(n_tiles) * block_s > INT_MAX || n_splits <= 0 ||
      n_splits > 48 * 1024 / static_cast<int>(sizeof(float)) || tile_sel == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = nw::prepared_args(q, s, s2, labels, scale, qcol, sscale, B, D, C,
                                            l2_mode, bank, qb, true, partials != 0, m_final,
                                            l_final, &a);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.tile_sel = static_cast<const int*>(tile_sel);
  a.n_sel = n_sel;
  a.qtiles_per_row = qtiles_per_row;
  a.n_tiles = n_tiles;
  a.block_s = block_s;
  a.m_out = static_cast<float*>(m_part);
  a.l_out = static_cast<float*>(l_part);
  a.acc_out = static_cast<float*>(acc_part);
  return static_cast<int>(nw::launch_bank<true>(static_cast<cudaStream_t>(stream), bank, qb, a,
                                                n_tiles * block_s, n_splits, partials != 0, out,
                                                m_final, l_final));
}

}  // extern "C"
