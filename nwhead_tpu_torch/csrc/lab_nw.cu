// The NW head lab kernels, for Hopper (sm_90a): L1 fused_variant and L3
// manual_fused. Both compute the l2 Nadaraya-Watson forward written out in
// nw_common.cuh (masked rows score NEG, online softmax, label sum, then
// log(acc / max(l, 1e-30) + 1e-12)) and merge their support splits with
// its nw_merge_kernel<true>, used unchanged.
//
// L1 fused_variant replaces scripts/kernel_lab.py:fused_variant (its
// _make_kernel): the raw forward with the lab's options, on raw features.
// It runs on the forward's tensor-core pass 1, nw_prepared_tc_kernel
// (nw_pass1.cuh), the pass K1, K2, K4, K5 and K6 share: TMA rings, two
// scoring groups on mma.sync, one block a (query tile x split). Each
// option is a route or a template flag of that pass:
//   * dist 0 "f32": K1's raw route as it stands (kRaw): |q|^2 and the rows'
//     self-norms as diagonals of self-products on the tensor cores, q.s on
//     3xTF32 (bf16 rows: bf16 products, f32 sums);
//     dist 1 "f32s2": s2 computed once outside the kernel, read by the
//     pass's s2 map, over raw rows: the rows are not zeroed and a masked
//     row (label -1) may hold anything, NaN included, since the pass masks
//     by the label, never by s2 (a NaN reaches only its own column);
//     dist 2 "x3": the query (f32) split in registers into bf16 hi and lo,
//     the bank arriving split (hi, lo bf16, kernel_lab.py:328-336) as two
//     64-byte boxes a slice, qh.sh + ql.sh + qh.sl on bf16 mma.sync
//     (nw_tc.cuh: x3_product, which states the order of the sums); s2
//     precomputed from the f32 rows.
//   * agg "split" (kSplitP): p replaced by f32(bf16(p)) + f32(bf16(p -
//     bf16(p))) before the label sum (kernel_lab.py:279-283); l keeps the
//     unsplit p.
//   * The TPU's label layouts (wide, wide_u8, compact) are one int32 label
//     array here, -1 masked.
//   * block_s is the rows a split streams, rounded up to the pass's 64-row
//     tiles; block_b picks the pass's query tile (32, 16 or 8, as C
//     allows). So the lab's block-size sweep still moves the blocks in use:
//     at the CUB shape (B = 64, S = 5,994, C = 200) block_s = 2,048 gives 3
//     splits of 2 query tiles, 6 blocks on 132 SMs; K1's own plan (64-row
//     multiples that fill the SMs once) is block_s = 128, 47 splits.
//   What bounds it: the bank's bytes, 12.3 MB f32 at the CUB shape (3.7 us
//   at 3.35 TB/s; bf16 1.9 us), above the products (2 B S D = 0.39 GFLOP:
//   2.4 us at 165 TFLOP/s on 3xTF32, 0.4 us in bf16, x3's three bf16
//   products 1.2 us); below a few hundred blocks, what one block streams.
//
// L3 manual_fused replaces scripts/manual_pipe_lab.py:manual_fused: the l2
// forward over a prepared f32 or bf16 bank (prepare_support with block_s:
// whole tiles of block_s rows, zeroed masked rows, s2 = 1e30 on them,
// labels -1), the query in the bank's dtype, on a grid of (query tiles) x
// (one block_s tile a split). The TPU lab asked whether a kernel that
// prefetches its own bank tiles reaches the stream rate; here it runs K2's
// prepared-bank route of the same pass 1 (s2 by its map, masked by the
// label), so that its few blocks (12 at B = 64, block_s = 1,024; 6 at
// B = 8) each stream a whole split through their rings alone, and its
// variable is what a block keeps in flight: the depth of each scoring
// group's ring, kStages slices of 64 rows x 128 bytes (kManualStages: 2,
// the TPU lab's double buffer; 3, K2's depth; 4 and 6; and 7, the deepest
// whose block fits the 232,448 bytes an H100 block may opt in to at the CUB
// shape's 32-query tile and C = 200). Every other user of the pass keeps
// kTcStages.
//   What bounds it: the bank's bytes (12.6 MB f32 prepared at the CUB
//   shape, 3.8 us at 3.35 TB/s; bf16 1.9 us), above the products (0.39
//   GFLOP); with 12 blocks on 132 SMs, what one block streams: the rate a
//   block reaches with its ring's bytes in flight, which the depth sweep
//   measures.

#include <cstdint>

#include "nw_pass1.cuh"

namespace lab {

// The pass's arguments for an l2 forward over q (B, D) and rows s (S, D),
// n_splits splits of rows_per_split rows writing m_part, l_part, acc_part.
inline nw::TcArgs pass_args(const void* q, const void* s, const void* s2, const void* labels,
                            const void* scale, void* m_part, void* l_part, void* acc_part, int B,
                            int S, int D, int C, int rows_per_split) {
  nw::TcArgs a{};
  a.q = q;
  a.s = s;
  a.s2 = static_cast<const float*>(s2);
  a.labels = static_cast<const int*>(labels);
  a.scale = static_cast<const float*>(scale);
  a.l2_mode = 1;
  a.B = B;
  a.D = a.ds = D;
  a.C = C;
  a.S = S;
  a.rows_per_split = rows_per_split;
  a.m_out = static_cast<float*>(m_part);
  a.l_out = static_cast<float*>(l_part);
  a.acc_out = static_cast<float*>(acc_part);
  return a;
}

// Whether the pass takes these splits and a query tile of qb for C classes
// with rings of `stages` slices on the current device.
inline cudaError_t pass_ok(int B, int S, int D, int C, int n_splits, int rows_per_split, int qb,
                           int stages) {
  if (!nw::forward_args_ok(B, S, D, C, n_splits, rows_per_split) ||
      rows_per_split % nw::kSupportTile != 0) {
    return cudaErrorInvalidValue;
  }
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return C > nw::max_forward_classes(device) || !nw::tc_config_ok(qb, C, false, device, stages)
             ? cudaErrorInvalidValue
             : cudaSuccess;
}

// ---------------------------------------------------------------------------
// L1 fused_variant: the forward's tensor-core pass 1 (kRaw for "f32", the
// s2 route for "f32s2" and the bf16 cast, kX3 for "x3"; kSplitP for
// agg="split"), then the merge.

template <typename T, bool kRaw, bool kX3>
cudaError_t variant_forward(cudaStream_t stream, bool split, int qb, const nw::TcArgs& a,
                            int n_splits, void* out) {
  return split ? nw::launch_tc_forward<T, false, false, kRaw, kX3, true>(
                     stream, qb, a, a.S, n_splits, false, out, nullptr, nullptr)
               : nw::launch_tc_forward<T, false, false, kRaw, kX3, false>(
                     stream, qb, a, a.S, n_splits, false, out, nullptr, nullptr);
}

// ---------------------------------------------------------------------------
// L3 manual_fused: K2's route of the pass with rings of kStages slices,
// then the merge.

// The ring depths L3 is built for, manual_forward's cases.
constexpr int kManualStages[] = {2, 3, 4, 6, 7};

template <typename T, int kStages>
cudaError_t manual_at(cudaStream_t stream, int qb, const nw::TcArgs& a, int n_splits, void* out) {
  return nw::launch_tc_forward<T, false, false, false, false, false, kStages>(
      stream, qb, a, a.S, n_splits, false, out, nullptr, nullptr);
}

template <typename T>
cudaError_t manual_forward(cudaStream_t stream, int stages, int qb, const nw::TcArgs& a,
                           int n_splits, void* out) {
  switch (stages) {
    case 2: return manual_at<T, 2>(stream, qb, a, n_splits, out);
    case 3: return manual_at<T, 3>(stream, qb, a, n_splits, out);
    case 4: return manual_at<T, 4>(stream, qb, a, n_splits, out);
    case 6: return manual_at<T, 6>(stream, qb, a, n_splits, out);
    case 7: return manual_at<T, 7>(stream, qb, a, n_splits, out);
    default: return cudaErrorInvalidValue;
  }
}

inline int optin_smem(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess) {
    return 0;
  }
  return optin;
}

}  // namespace lab

extern "C" {

const char* lab_nw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory of a manual_fused block: query tiles of qb, C
// classes, rings of `stages` slices, in bytes.
int lab_manual_smem_bytes(int qb, int C, int stages) {
  return static_cast<int>(nw::tc_smem_bytes(qb, C, false, stages));
}

int lab_optin_smem(int device) { return lab::optin_smem(device); }

// L1 fused_variant on the tensor-core pass 1. dist 0 (f32) / 1 (f32s2):
// q (B, D), s (S, D) in f32 or bf16 (bf16 != 0); dist 2 (x3): q (B, D)
// f32, s and s_lo (S, D) bf16, the bank's hi and lo halves. s2 (S,) f32
// for dist 1 and 2 (may be null for dist 0, and hold anything on masked
// rows); labels (S,) int32, -1 = masked; scale (1,) f32 (read, unused in
// l2 mode); split != 0: the split-p label sum. n_splits splits of
// rows_per_split rows (a multiple of 64) over query tiles of qb (8, 16 or
// 32, and its block must fit the device's shared memory); m_part, l_part
// (n_splits, B), acc_part (n_splits, B, C) f32 scratch, out (B, C) f32
// log-probs. Launches on `stream`, does not synchronize, returns
// cudaGetLastError().
int lab_fused_variant(const void* q, const void* s, const void* s_lo, const void* s2,
                      const void* labels, const void* scale, void* m_part, void* l_part,
                      void* acc_part, void* out, int B, int S, int D, int C, int dist, int split,
                      int bf16, int n_splits, int rows_per_split, int qb, void* stream) {
  if (q == nullptr || s == nullptr || labels == nullptr || scale == nullptr || dist < 0 ||
      dist > 2 || (dist != 0 && s2 == nullptr) || (dist == 2 && (s_lo == nullptr || bf16))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = lab::pass_ok(B, S, D, C, n_splits, rows_per_split, qb, nw::kTcStages);
  if (err != cudaSuccess) return static_cast<int>(err);
  nw::TcArgs a = lab::pass_args(q, s, s2, labels, scale, m_part, l_part, acc_part, B, S, D, C,
                                rows_per_split);
  a.s_lo = s_lo;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const bool sp = split != 0;
  switch (dist) {
    case 0:  // K1's raw route
      return static_cast<int>(
          bf16 ? lab::variant_forward<bf, true, false>(st, sp, qb, a, n_splits, out)
               : lab::variant_forward<float, true, false>(st, sp, qb, a, n_splits, out));
    case 1:  // s2 by its map, over raw rows
      return static_cast<int>(
          bf16 ? lab::variant_forward<bf, false, false>(st, sp, qb, a, n_splits, out)
               : lab::variant_forward<float, false, false>(st, sp, qb, a, n_splits, out));
    default:  // x3
      return static_cast<int>(
          lab::variant_forward<float, false, true>(st, sp, qb, a, n_splits, out));
  }
}

// L3 manual_fused: q (B, D) and s (S, D) in f32 or bf16 (bf16 != 0), any
// D (rows the TMA cannot address are staged by plain loads); s2 (S,) f32
// (1e30 on masked rows); labels (S,) int32, -1 = masked; scale (1,) f32
// (read, unused in l2 mode); n_splits splits of rows_per_split rows (a
// multiple of 64: the bank's block_s) over query tiles of qb (8, 16 or
// 32), each scoring group's ring `stages` slices deep (2, 3, 4, 6 or 7;
// the block must fit the device's shared memory); m_part, l_part
// (n_splits, B), acc_part (n_splits, B, C) f32 scratch, out (B, C) f32
// log-probs. Launches on `stream`, does not synchronize, returns
// cudaGetLastError().
int lab_manual_fused(const void* q, const void* s, const void* s2, const void* labels,
                     const void* scale, void* m_part, void* l_part, void* acc_part, void* out,
                     int B, int S, int D, int C, int bf16, int n_splits, int rows_per_split,
                     int qb, int stages, void* stream) {
  bool known = false;
  for (const int k : lab::kManualStages) known = known || k == stages;
  if (!known || q == nullptr || s == nullptr || s2 == nullptr || labels == nullptr ||
      scale == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = lab::pass_ok(B, S, D, C, n_splits, rows_per_split, qb, stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  const nw::TcArgs a = lab::pass_args(q, s, s2, labels, scale, m_part, l_part, acc_part, B, S, D,
                                      C, rows_per_split);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? lab::manual_forward<__nv_bfloat16>(st, stages, qb, a, n_splits, out)
           : lab::manual_forward<float>(st, stages, qb, a, n_splits, out));
}

}  // extern "C"
