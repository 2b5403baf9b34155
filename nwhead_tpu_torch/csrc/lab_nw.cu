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
// labels -1), the query in the bank's dtype. The lab tests a hypothesis:
// a kernel that hides memory latency with occupancy (many blocks a SM that
// do not prefetch, K2's first design) against one that hides it by
// prefetching. Its grid is (query tiles of 16) x (splits of whole block_s
// tiles), one tile a split, not the TPU's one program per 128 queries.
// Each block keeps its 16 queries in shared memory as f32 and streams its
// split through a two-stage ring of 64-row x 64-feature bank sub-tiles
// copied with cp.async (commit_group / wait_group 1): the copy of the next
// sub-tile is in flight while this one is scored. The scores read the
// stage in the bank's dtype, 8 features (16 bytes of bf16, two float4 of
// f32) a step, FFMA.
//   What bounds it: at B = 64 operations (2 B S D at 67 TFLOP/s, 6 us), at
//   B = 8 the bank's bytes (12.3 MB f32, 3.7 us at 3.35 TB/s); with one
//   block_s tile a split the grid is 4 x 6 blocks at B = 64, block_s =
//   1024, which is what the lab measures against K2 (one wave of blocks).

#include <cstdint>

#include "nw_pass1.cuh"

namespace lab {

using nw::kChunkStride;
using nw::kFeatChunk;
using nw::kNeg;
using nw::kQueryTile;
using nw::kRowsPerThread;
using nw::kSupportTile;
using nw::kThreads;
using nw::kThreadsPerQuery;
using nw::kWarps;

// Online softmax and label sum of one scored tile (nw_common.cuh's step,
// inline there): prob holds the scores and is overwritten with p. Ends
// synchronized.
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
    const float m_new = fmaxf(m_prev, nw::warp_max(fmaxf(s0, s1)));
    const float m_safe = m_new > kNeg / 2 ? m_new : 0.f;
    const float alpha = m_prev > kNeg / 2 ? expf(m_prev - m_safe) : 0.f;
    const float p0 = s0 > kNeg / 2 ? expf(s0 - m_safe) : 0.f;
    const float p1 = s1 > kNeg / 2 ? expf(s1 - m_safe) : 0.f;
    const float p_sum = nw::warp_sum(p0 + p1);
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
// L3 manual_fused

constexpr int kPipeFeat = 64;  // features of a bank sub-tile (a ring stage)

template <typename T>
struct Pipe {
  // Row stride of a stage in elements: 16-byte aligned rows whose 4-word
  // offset mod 32 banks makes the 16-byte reads of 8 consecutive rows
  // conflict-free.
  static constexpr int kStride = kPipeFeat + 16 / sizeof(T);
  static constexpr int kStageElems = kSupportTile * kStride;
  static constexpr int kSegs = kPipeFeat * sizeof(T) / 16;  // 16-byte copies a row
  static constexpr int kElemsPerSeg = 16 / sizeof(T);
};

inline size_t pipe_smem_bytes(int C, int D, int elem_bytes) {
  const int stride = kPipeFeat + 16 / elem_bytes;
  return sizeof(float) * (static_cast<size_t>(kQueryTile) * D  // the query tile, f32
                          + static_cast<size_t>(kQueryTile) * C  // acc
                          + kQueryTile * kSupportTile            // scores, then p
                          + 3 * kQueryTile)                      // |q|^2, m, l
         + static_cast<size_t>(2) * kSupportTile * stride * elem_bytes  // the ring
         + sizeof(int) * kSupportTile;                                  // tile labels
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Issue the copy of sub-tile `step` (64 rows from t0, features k0 ..
// k0 + 63) into a stage; rows past r_end and features past D fill with 0.
template <typename T>
__device__ __forceinline__ void issue_subtile(const T* __restrict__ s, int t0, int r_end, int k0,
                                              int D, T* __restrict__ stage) {
  using P = Pipe<T>;
  for (int e = threadIdx.x; e < kSupportTile * P::kSegs; e += kThreads) {
    const int j = e / P::kSegs, g = e % P::kSegs;
    const int k = k0 + g * P::kElemsPerSeg;
    const bool valid = t0 + j < r_end && k < D;
    const T* src = valid ? s + static_cast<size_t>(t0 + j) * D + k : s;
    cp_async16_zfill(stage + j * P::kStride + g * P::kElemsPerSeg, src, valid);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
manual_pipe_kernel(const T* __restrict__ q, const T* __restrict__ s, const float* __restrict__ s2,
                   const int* __restrict__ labels, int B, int S, int D, int C,
                   int rows_per_split, float* __restrict__ m_out, float* __restrict__ l_out,
                   float* __restrict__ acc_out) {
  using P = Pipe<T>;
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);  // 2 stages, 16-byte aligned
  float* q_tile = reinterpret_cast<float*>(ring + 2 * P::kStageElems);
  float* acc = q_tile + kQueryTile * D;
  float* prob = acc + kQueryTile * C;
  float* q2 = prob + kQueryTile * kSupportTile;
  float* m_run = q2 + kQueryTile;
  float* l_run = m_run + kQueryTile;
  int* tile_labels = reinterpret_cast<int*>(l_run + kQueryTile);

  const int tid = threadIdx.x;
  const int tq = tid / kThreadsPerQuery;
  const int tr = tid % kThreadsPerQuery;
  const int b0 = blockIdx.x * kQueryTile;
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(S, r_begin + rows_per_split);
  const int n_kc = (D + kPipeFeat - 1) / kPipeFeat;
  const int n_steps = (r_end - r_begin + kSupportTile - 1) / kSupportTile * n_kc;

  if (n_steps > 0) issue_subtile(s, r_begin, r_end, 0, D, ring);
  cp_async_commit();

  for (int i = tid; i < kQueryTile * D; i += kThreads) {
    const int b = i / D;
    q_tile[i] = b0 + b < B ? nw::to_float(q[static_cast<size_t>(b0) * D + i]) : 0.f;
  }
  for (int i = tid; i < kQueryTile * C; i += kThreads) acc[i] = 0.f;
  nw::query_norms(q, b0, B, D, q2);
  if (tid < kQueryTile) {
    m_run[tid] = kNeg;
    l_run[tid] = 0.f;
  }

  float dot[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) dot[r] = 0.f;
  for (int step = 0; step < n_steps; ++step) {
    const int kc = step % n_kc;
    const int t0 = r_begin + (step / n_kc) * kSupportTile;
    if (step + 1 < n_steps) {
      const int kn = (step + 1) % n_kc;
      const int tn = r_begin + ((step + 1) / n_kc) * kSupportTile;
      issue_subtile(s, tn, r_end, kn * kPipeFeat, D, ring + ((step + 1) & 1) * P::kStageElems);
    }
    cp_async_commit();  // empty on the last step: wait_group 1 stays exact
    if (kc == 0 && tid < kSupportTile) {
      tile_labels[tid] = t0 + tid < r_end ? labels[t0 + tid] : -1;
    }
    cp_async_wait<1>();
    __syncthreads();

    const T* cur = ring + (step & 1) * P::kStageElems;
    const int k0 = kc * kPipeFeat;
    const int kn = min(kPipeFeat, D - k0);
    const float* qrow = q_tile + tq * D + k0;
    for (int k8 = 0; k8 < kn; k8 += 8) {
      float a[8];
      load8(qrow + k8, a);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        float c[8];
        load8(cur + (tr + kThreadsPerQuery * r) * P::kStride + k8, c);
#pragma unroll
        for (int u = 0; u < 8; ++u) dot[r] = fmaf(a[u], c[u], dot[r]);
      }
    }
    if (kc == n_kc - 1) {
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int j = tr + kThreadsPerQuery * r;
        prob[tq * kSupportTile + j] =
            tile_labels[j] >= 0 ? -nw::l2_dist(q2[tq], dot[r], s2[t0 + j]) : kNeg;
        dot[r] = 0.f;
      }
      __syncthreads();
      softmax_label_step(prob, tile_labels, acc, C, m_run, l_run);
    }
    __syncthreads();  // this stage is refilled by the copy issued next step
  }
  cp_async_wait<0>();

  for (int i = tid; i < kQueryTile * C; i += kThreads) {
    const int b = i / C;
    if (b0 + b < B) acc_out[(static_cast<size_t>(split) * B + b0 + b) * C + i % C] = acc[i];
  }
  if (tid < kQueryTile && b0 + tid < B) {
    m_out[static_cast<size_t>(split) * B + b0 + tid] = m_run[tid];
    l_out[static_cast<size_t>(split) * B + b0 + tid] = l_run[tid];
  }
}

template <typename T>
cudaError_t launch_manual(cudaStream_t stream, const void* q, const void* s, const void* s2,
                          const void* labels, int B, int S, int D, int C, int block_s,
                          void* m_part, void* l_part, void* acc_part, void* out) {
  const int n_splits = (S + block_s - 1) / block_s;
  const dim3 grid((B + kQueryTile - 1) / kQueryTile, n_splits);
  const size_t smem = pipe_smem_bytes(C, D, sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        manual_pipe_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  manual_pipe_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(s), static_cast<const float*>(s2),
      static_cast<const int*>(labels), B, S, D, C, block_s, static_cast<float*>(m_part),
      static_cast<float*>(l_part), static_cast<float*>(acc_part));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return nw::launch_merge(stream, false, m_part, l_part, acc_part, n_splits, B, C, out, nullptr,
                          nullptr);
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

// Dynamic shared memory of a manual_fused block (elem_bytes 4 or 2), in
// bytes.
int lab_manual_smem_bytes(int C, int D, int elem_bytes) {
  return static_cast<int>(lab::pipe_smem_bytes(C, D, elem_bytes));
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
  if (!nw::forward_args_ok(B, S, D, C, n_splits, rows_per_split) ||
      rows_per_split % nw::kSupportTile != 0 || q == nullptr || s == nullptr ||
      labels == nullptr || scale == nullptr || dist < 0 || dist > 2 ||
      (dist != 0 && s2 == nullptr) || (dist == 2 && (s_lo == nullptr || bf16))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C > nw::max_forward_classes(device) || !nw::tc_config_ok(qb, C, false, device)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nw::TcArgs a{};
  a.q = q;
  a.s = s;
  a.s_lo = s_lo;
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

// L3 manual_fused: q (B, D) and s (S, D) in f32 or bf16 (bf16 != 0), D a
// multiple of 8, both 16-byte aligned; s2 (S,) f32 (1e30 on masked rows);
// labels (S,) int32, -1 = masked; block_s the rows of a split. m_part,
// l_part (n_splits, B), acc_part (n_splits, B, C) f32 scratch, n_splits =
// ceil(S / block_s); out (B, C) f32 log-probs. Launches on `stream`, does
// not synchronize, returns cudaGetLastError().
int lab_manual_fused(const void* q, const void* s, const void* s2, const void* labels,
                     void* m_part, void* l_part, void* acc_part, void* out, int B, int S, int D,
                     int C, int bf16, int block_s, void* stream) {
  const int n_splits = block_s > 0 ? (S + block_s - 1) / block_s : 0;
  if (B <= 0 || S <= 0 || D <= 0 || D % 8 != 0 || C <= 0 || block_s <= 0 || s2 == nullptr ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 || reinterpret_cast<uintptr_t>(s) % 16 != 0 ||
      n_splits > 48 * 1024 / static_cast<int>(sizeof(float))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (lab::pipe_smem_bytes(C, D, bf16 ? 2 : 4) >
      static_cast<size_t>(lab::optin_smem(device))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = bf16 ? lab::launch_manual<__nv_bfloat16>(st, q, s, s2, labels, B, S, D, C, block_s,
                                                 m_part, l_part, acc_part, out)
             : lab::launch_manual<float>(st, q, s, s2, labels, B, S, D, C, block_s, m_part,
                                         l_part, acc_part, out);
  return static_cast<int>(err);
}

}  // extern "C"
