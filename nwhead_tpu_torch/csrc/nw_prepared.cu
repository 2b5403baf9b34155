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

#include "nw_common.cuh"

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
// f32. Launches on `stream`, does not synchronize, returns cudaGetLastError().
int nw_prepared_forward(const void* q, const void* s, const void* s2,
                        const void* labels, const void* scale, void* m_part,
                        void* l_part, void* acc_part, void* out, int B, int S,
                        int D, int C, int l2_mode, int bf16, int n_splits,
                        int rows_per_split, void* stream) {
  if (!nw::forward_args_ok(B, S, D, C, n_splits, rows_per_split) ||
      (l2_mode && s2 == nullptr)) {
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
                                                      m_part, l_part, acc_part, out, nullptr,
                                                      nullptr)
           : nw::launch_forward<float, false>(st, q, s, s2, labels, scale, l2_mode, B, S, D, C,
                                              n_splits, rows_per_split, m_part, l_part,
                                              acc_part, out, nullptr, nullptr));
}

}  // extern "C"
