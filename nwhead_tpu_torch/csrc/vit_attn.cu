// ViT attention for Hopper (sm_90a): multi-head attention straight off the
// packed qkv (K7), the same kernel over separate q, k, v (K12), and the
// bf16 attention half-block (K10).
//
// K7 replaces nwhead_tpu/ops/pallas_attn.py:_attn_qkv_kernel (forward).
// qkv (B, N, 3 D) holds q | k | v, heads of hd contiguous inside each, as
// the qkv projection writes it; out (B, N, D). Per head:
//   out = softmax(q k^T * scale) v, the softmax in f32.
// K12 (pallas_attn.py:_attn_kernel) is the same kernel given (B, H, N, hd)
// q, k, v and out by their batch, head and token strides.
// The TPU kernel keeps one batch row's whole (N, N) score matrix in VMEM
// and rounds the normalized probabilities to the input dtype before its PV
// product. Here a block owns 64 queries of one (batch, head), four warps of
// 16 rows, and sweeps the keys twice in chunks (64 keys in bf16, 32 in
// f32), staged with cp.async into a two-stage ring (Q once, then K, then K
// and V), so any N fits and neither scores nor probabilities leave the
// registers:
//   * sweep 1: scores q k^T on the tensor cores (vit_mma.cuh: bf16 on
//     mma.sync m16n8k16, f32 on 3xTF32), scaled in f32, each row's running
//     max m and sum l kept by the quad of lanes that holds the row;
//   * sweep 2: the scores again, turned in registers into the normalized
//     f32 probabilities exp(s - m) / l (in base 2, exp2(s log2(e) - m2 -
//     log2(l)): a multiply, a subtraction and one MUFU.EX2 a score, no
//     division), rounded to the input dtype as they are packed straight
//     into the left operand of the P V product, summed in f32.
// An online single sweep would round unnormalized probabilities: in bf16
// that moved each attention output by about one ulp from the TPU kernel's
// values, and twelve blocks of ViT-S/14 carried that to 1.8% of the served
// features (measured on the H100), so the scores are computed twice.
// Ragged edges: 8-key score tiles and 16-key (f32: 8-key) PV steps at or
// past N are skipped, so N = 257's last chunk costs one pair of score
// tiles and one PV step; a warp whose 16 queries all lie past N computes
// nothing.
// What bounds it at ViT-S/14 serving (B = 64, N = 257, H = 6, hd = 64):
// the 50.5 MB of qkv and out in bf16 over 3.35 TB/s, 15 us, above the
// 4 B H N^2 hd = 6.49 GFLOP at 989 TFLOP/s (6.6 us). The kernel issues 1.5x
// those products (the two sweeps) through mma.sync, which reaches only part
// of the tensor cores' rate (wgmma reaches all of it), stages each 64-key
// chunk of K twice and V once for every 64-query tile from the L2, and
// reads every B operand from shared memory once per warp; f32 issues each
// product three times on TF32 (495 TFLOP/s) and splits each operand it
// loads. PERF.md holds the times; wgmma and TMA are the next step.
//
// K10 replaces pallas_attn.py:_attn_int8_kernel with quant=False (the
// launch of fused_attention_block_bf16): [LayerNorm ->] qkv -> attention
// -> proj [-> * LayerScale] [-> + x], bf16 in and out. One block's (N, 3 D)
// qkv tensor (592 KB at ViT-S/14) does not fit in shared memory as it fits
// in VMEM, so K10 runs its stages through device memory, each keeping the
// TPU kernel's bf16 rounding points:
//   0. with the LayerNorm, vit_block.cuh's prologue (K11's): LN(x) with f32
//      statistics, rounded to bf16, once per row;
//   1. proj_tc_kernel: x (or LN(x)) W_qkv + b, rounded to bf16 -> qkv;
//   2. K7's attention_kernel in bf16 -> att (the f32 attention output
//      rounded to bf16 before proj, as the TPU kernel rounds it);
//   3. proj_tc_kernel: att W_proj + b rounded to bf16, then * LayerScale
//      (rounded to bf16) and + x (rounded to bf16) in its epilogue.
// proj_tc_kernel is the projections' tensor-core GEMM: a block owns a 128 x
// 128 output tile, eight warps of 64 x 32, and streams A (M, K) and W (K,
// n_out), the weights as stored (in, out), in slices 128 bytes deep (64
// bf16, 128 int8) through vit_mma.cuh's three-stage cp.async ring_loop
// into warp_product: bf16 on mma.sync m16n8k16, int8 on m16n8k32 with
// load_b_kn4 transposing the weights' bytes in registers (K11's
// fragments). K = D is shallow (6 bf16 or 3 int8 slices at ViT-S/14), so
// the grid is persistent, two blocks to an SM, each running one ring over
// the slices of all its tiles: the next tile's first slices load under
// this one's last products and its epilogue. The 128-row tile halves the
// weights' restaging against K11's 64. Rows past M and columns past n_out
// are staged as zeros. Its bound at B = 64, N = 257: the projections' 19.4
// GFLOP over 989 TFLOP/s (20 us), the attention's 6.5 over the same (7
// us); it runs at about 150 TFLOP/s (PERF.md).
//
// K10 int8 replaces the same TPU kernel with quant=True (the launch of
// fused_attention_qkv_int8): the prologue writes x's codes, clip(rint(x *
// (1/a)), -127, 127) of x or of its LayerNorm (row_stats_f64's
// statistics, rounded to bf16); proj_tc_kernel multiplies int8 codes by
// the int8 weights on s8 mma.sync into int32 sums, exact in any order, and
// dequantizes in the epilogue as acc * (a * w_scale[c]) + bias[c] (two
// roundings, no FMA, as the TPU kernel computes it), then rounds to bf16.
// Its attention stage is K7's function in bf16 (bf16 score and PV
// products, f32 softmax), as on the TPU, but on FFMA in the plain
// version's summation order (seq_attention_kernel below): a bf16 flip of
// the attention output moves its int8 code, and with K7's tensor-core
// kernel there the int8 stack's limits failed (PERF.md, PR 9). That stage
// writes the codes of its bf16-rounded output by 1/a_proj itself, so the
// proj stage reads codes (no pass over the attention output). Every
// expression of the int8 path is the one the kernels before this design
// used, so its output keeps their bits. Bound at B = 64: the projections'
// 19.4 G int8 operations over 1,979 TOP/s (10 us) and the attention's 6.5
// GFLOP over 989 TFLOP/s (7 us); the FFMA attention stage, 3.2 G FFMA once
// its scores are kept, runs at the card's 67 TFLOP/s f32 rate at best
// (about 0.1 ms).

#include <algorithm>

#include "vit_block.cuh"

namespace vit {

// Where one call's q, k, v and out lie: element strides of a batch row, a
// head and a token (q, k and v share theirs).
struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  long long in_b, in_h, in_n;
  long long out_b, out_h, out_n;
  int N;
  float scale;
};

// Keys a chunk stages: 64 in bf16, 32 in f32, whose rows take twice the
// bytes, so that four blocks of either fit in an SM's shared memory.
template <typename T>
__host__ __device__ constexpr int attn_chunk() { return sizeof(T) == 4 ? 32 : 64; }

template <typename T, int kHd>
constexpr size_t attention_smem_bytes() {
  // Q; K and V, two stages each
  return sizeof(T) * (tile_elems<T, kHd>(kAttnTile) + 4 * tile_elems<T, kHd>(attn_chunk<T>()));
}

// The normalized f32 probabilities of a chunk's raw scores, exp2(s * scale2
// - lse2) with each row's lse2; 0 for keys at or past n_valid.
template <int kNT>
__device__ __forceinline__ void normalized_probs(float (&s)[kNT][4], float scale2,
                                                 const float (&lse)[2], int n_valid) {
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = exp2_prob(s[j][e], scale2, lse[e >> 1]);
  if (n_valid < 8 * kNT) {
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = acc_col(j, e) < n_valid ? s[j][e] : 0.f;
  }
}

// grid (ceil(N / 64), H, B), 128 threads.
template <typename T, int kHd>
__global__ void __launch_bounds__(kAttnThreads) attention_kernel(const AttnArgs args) {
  constexpr int kKeys = attn_chunk<T>();
  constexpr int kNT = kKeys / 8;  // 8-key n-tiles of a chunk
  constexpr int kKElems = tile_elems<T, kHd>(kKeys);
  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);
  T* ks = qs + tile_elems<T, kHd>(kAttnTile);  // two stages
  T* vs = ks + 2 * kKElems;                    // two stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kAttnTile, h = blockIdx.y, b = blockIdx.z;
  const int N = args.N;
  const long long in_off = b * args.in_b + h * args.in_h;
  const T* qb = static_cast<const T*>(args.q) + in_off;
  const T* kb = static_cast<const T*>(args.k) + in_off;
  const T* vb = static_cast<const T*>(args.v) + in_off;
  const int n_chunks = (N + kKeys - 1) / kKeys;
  const int steps = 2 * n_chunks;  // sweep 1 over K, sweep 2 over K and V
  auto load = [&](int step) {
    const int k0 = (step % n_chunks) * kKeys;
    T* dst = ks + (step & 1) * kKElems;
    stage_rows<T, kHd, kKeys>(kb, args.in_n, k0, N, dst);
    if (step >= n_chunks) stage_rows<T, kHd, kKeys>(vb, args.in_n, k0, N, dst + 2 * kKElems);
  };
  stage_rows<T, kHd, kAttnTile>(qb, args.in_n, q0, N, qs);
  load(0);
  cp_async_commit();

  const int row0 = 16 * warp;
  const bool active = q0 + row0 < N;  // warp-uniform: the warp holds a query
  const float scale2 = args.scale * kLog2e;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, lse[2];  // rows g and g + 8
  float o[kHd / 8][4] = {};
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      load(step + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int n_valid = N - (step % n_chunks) * kKeys;
    if (active) {
      float s[kNT][4];
      tile_abt<T, kHd>(qs, row0, ks + (step & 1) * kKElems, n_valid, s);
      if (step < n_chunks) {
        scale_and_mask(s, scale2, n_valid);
        online_max_sum(s, m, l);
      } else {
        if (step == n_chunks) lse[0] = lse2(m[0], l[0]), lse[1] = lse2(m[1], l[1]);
        normalized_probs(s, scale2, lse, n_valid);
        acc_pb<T, kHd>(s, vs + (step & 1) * kKElems, n_valid, o);  // P rounded to T here
      }
    }
    __syncthreads();
  }
  if (!active) return;

  const int g = lane >> 2, t = lane & 3;
  T* ob = static_cast<T*>(args.out) + b * args.out_b + h * args.out_h + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = q0 + row0 + g + 8 * r;
    if (q >= N) continue;
#pragma unroll
    for (int n = 0; n < kHd / 8; ++n) {
      store2(ob + q * args.out_n + 8 * n, o[n][2 * r], o[n][2 * r + 1]);
    }
  }
}

template <typename T, int kHd>
cudaError_t launch_attention(cudaStream_t stream, const AttnArgs& args, int B, int H) {
  const size_t smem = attention_smem_bytes<T, kHd>();
  const cudaError_t err = allow_smem(attention_kernel<T, kHd>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((args.N + kAttnTile - 1) / kAttnTile, H, B);
  attention_kernel<T, kHd><<<grid, kAttnThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

template <typename T>
cudaError_t attention(cudaStream_t stream, const AttnArgs& args, int B, int H, int hd) {
  switch (hd) {
    case 32: return launch_attention<T, 32>(stream, args, B, H);
    case 64: return launch_attention<T, 64>(stream, args, B, H);
    case 128: return launch_attention<T, 128>(stream, args, B, H);
    default: return cudaErrorInvalidValue;
  }
}

// The packed (B, N, 3 H hd) qkv -> (B, N, H hd) out of K7 and K10.
template <typename T>
cudaError_t attention(cudaStream_t stream, const void* qkv, void* out, int B, int N, int H, int hd,
                      float scale) {
  const long long D = static_cast<long long>(H) * hd;
  const T* base = static_cast<const T*>(qkv);
  const AttnArgs args{base, base + D, base + 2 * D, out, N * 3 * D, hd, 3 * D, N * D, hd, D,
                      N, scale};
  return attention<T>(stream, args, B, H, hd);
}

// K10 int8's attention stage: K7's function on FFMA in the plain version's
// summation order, one fused multiply-add at a time. The int8 stack
// quantizes the attention output to codes, and one bf16 flip of a
// probability moves a code: with the scores summed in any other order (the
// tensor cores', or rounded exactly from an f64 sum) the K10 int8 check
// misses its 1e-2 by 7% and the served int8 features their 0.9999 cosine
// (PERF.md, PR 9). So these values, and each one's order, are fixed:
//   * a score q . k is one fmaf chain over d = 0 .. hd - 1 from 0, then
//     * scale; keys at or past N score kNeg;
//   * sweep 1, over 64-key chunks in order: each row's max m and running
//     sum l = l * expf(m_prev - m) + S, S the chunk's sum of expf(s - m)
//     in the tree of a warp_sum over 32 lanes that each add keys j and j +
//     32 first;
//   * sweep 2: p = round_to<bf16>(expf(s - m) / l) (a true division), and
//     o = one fmaf chain of p v over the keys in order, from 0.
// Masked keys add exactly 0 to l and o, so the chunk past N runs its PV
// product over its valid keys only.
// A block owns 64 queries of one (batch, head), four warps of 16. Thread
// (tr, tc) = (tid / 16, tid % 16) owns rows 8 tr .. 8 tr + 7 and, in a
// 64-key chunk, keys tc + 16 m, m < 4: an 8 x 4 score tile in registers
// (two 16-byte loads of Q^T and one of K^T for 32 FFMA a step, K^T's
// columns ordered so that those four keys lie side by side). The four keys
// are the ones warp_sum's tree adds first (j and j + 32, then j ^ 16), so
// a row's sum takes four shuffles over the 16 lanes of its rows, its max
// four more. Sweep 1 computes each score once and keeps it in global
// scratch (16 KB a block and chunk, written and read back by the same
// thread, coalesced); sweep 2 reads it back in place of computing it again
// (a third of the FFMA), turns it into probabilities in registers and
// writes them to its warp's columns of P^T, from which each thread
// accumulates its 8 rows x hd / 16 output columns. Each chunk of K (V in
// sweep 2) is fetched into registers with 16-byte loads while the previous
// chunk computes, then widened to f32 (exact) into shared memory; sweep 2's
// V and P^T lie over sweep 1's Q^T and K^T (35 KB a block at hd = 64, four
// blocks an SM). A warp whose 16 queries all lie past N skips its work, and
// a chunk whose only valid keys are its first four (N = 257's last) spreads
// their chains over all lanes (score_tile). The output's int8 codes,
// quantize_i8 of the bf16-rounded value by 1/a_proj, go straight to the
// proj stage.
constexpr int kSeqTile = 64;              // queries per block, keys per chunk
constexpr int kSeqThreads = 128;          // four warps of 16 queries
constexpr int kSeqStride = kSeqTile + 4;  // row stride (floats) of Q^T, K^T and P^T

// Shared memory: Q^T and K^T in sweep 1; V and P^T, over them, in sweep 2.
template <int kHd>
constexpr size_t seq_attention_smem_bytes() {
  constexpr size_t sweep1 = 2 * kHd * kSeqStride;                        // Q^T, K^T
  constexpr size_t sweep2 = kSeqTile * (kHd + 4) + kSeqTile * kSeqStride;  // V, P^T
  return sizeof(float) * (sweep1 > sweep2 ? sweep1 : sweep2);
}

// Sweep 1's scores of one block: a chunk's 8 x 4 tiles, 16 KB, as float4
// (chunk c, row i of the tile) of thread t at [(c * 8 + i) * 128 + t].
__host__ __device__ constexpr long long seq_scores_per_block(int chunks) {
  return static_cast<long long>(chunks) * 8 * kSeqThreads;  // float4s
}

// Rows r0 .. r0 + 63 of one head's (n, kHd) bf16 slab (row r at base + r *
// row_stride): the thread's 16-byte segments, fetched into registers
// (rows past n are 0) so that the next chunk's loads run under this one's
// products, then widened to f32 in shared memory by put_f32. Lanes take
// consecutive rows, so put_f32's transposed stores hit 32 banks.
template <int kHd>
struct Chunk {
  static constexpr int kSegs = kHd / 8;  // 16-byte segments of a row
  static constexpr int kPer = kSeqTile * kSegs / kSeqThreads;
  uint4 w[kPer];
};

template <int kHd>
__device__ __forceinline__ void fetch(const __nv_bfloat16* __restrict__ base, size_t row_stride,
                                      int r0, int n, Chunk<kHd>& c) {
#pragma unroll
  for (int u = 0; u < Chunk<kHd>::kPer; ++u) {
    const int idx = threadIdx.x + u * kSeqThreads;
    const int r = idx % kSeqTile, seg = idx / kSeqTile;
    c.w[u] = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n) {
      c.w[u] = *reinterpret_cast<const uint4*>(base + (r0 + r) * row_stride + 8 * seg);
    }
  }
}

// Where put_f32 writes a chunk: Q^T[d][row], K^T[d][key_pos(key)], V[key][d].
enum class Put { kQ, kK, kV };

// Key j of a chunk's column in K^T: thread tc's four consecutive columns
// 4 tc .. 4 tc + 3 hold keys tc, tc + 16, tc + 32 and tc + 48, the keys
// that warp_sum's tree adds first (j, j + 32, then j ^ 16).
__device__ __forceinline__ int key_pos(int j) { return 4 * (j & 15) + (j >> 4); }

// A fetched chunk widened to f32 (exact), as `where` says.
template <int kHd, Put kWhere>
__device__ __forceinline__ void put_f32(const Chunk<kHd>& c, float* __restrict__ dst) {
#pragma unroll
  for (int u = 0; u < Chunk<kHd>::kPer; ++u) {
    const int idx = threadIdx.x + u * kSeqThreads;
    const int r = idx % kSeqTile, seg = idx / kSeqTile;
    const uint32_t words[4] = {c.w[u].x, c.w[u].y, c.w[u].z, c.w[u].w};
    float v[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[2 * e] = __uint_as_float(words[e] << 16);
      v[2 * e + 1] = __uint_as_float(words[e] & 0xffff0000u);
    }
    if constexpr (kWhere != Put::kV) {
      const int col = kWhere == Put::kK ? key_pos(r) : r;
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[(8 * seg + e) * kSeqStride + col] = v[e];
    } else {
      float4* d = reinterpret_cast<float4*>(dst + r * (kHd + 4) + 8 * seg);
      d[0] = make_float4(v[0], v[1], v[2], v[3]);
      d[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

// The thread's 8 x 4 tile of a chunk's scores q . k * scale, s[i][m] of
// row 8 tr + i and key k0 + tc + 16 m; keys at or past N score kNeg, and a
// thread whose four keys all lie past N sums nothing. A chunk whose valid
// keys are its first four (N = 257's last) spreads the warp's 16 x 4 chains
// of those keys over its 32 lanes (row lane / 2, keys 2 (lane % 2) and + 1)
// and gathers them into the lanes tc < 4 by shuffles: the same chains, a
// sixteenth of the steps.
template <int kHd>
__device__ __forceinline__ void score_tile(const float* __restrict__ qt,
                                           const float* __restrict__ kt, int k0, int N,
                                           float scale, float (&s)[8][4]) {
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
  if (N - k0 <= 4) {
    const int lane = threadIdx.x & 31;
    const int r = 16 * (threadIdx.x >> 5) + (lane >> 1), j = 2 * (lane & 1);
    float t0 = 0.f, t1 = 0.f;
#pragma unroll 8
    for (int d = 0; d < kHd; ++d) {
      const float q = qt[d * kSeqStride + r];
      t0 = fmaf(q, kt[d * kSeqStride + key_pos(j)], t0);
      t1 = fmaf(q, kt[d * kSeqStride + key_pos(j + 1)], t1);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int src = 2 * (8 * (tr & 1) + i) + ((tc >> 1) & 1);
      const float a = __shfl_sync(0xffffffffu, t0, src), b = __shfl_sync(0xffffffffu, t1, src);
      s[i][0] = tc & 1 ? b : a;
    }
  } else if (k0 + tc < N) {
#pragma unroll 8
    for (int d = 0; d < kHd; ++d) {
      const float4 a0 = *reinterpret_cast<const float4*>(qt + d * kSeqStride + 8 * tr);
      const float4 a1 = *reinterpret_cast<const float4*>(qt + d * kSeqStride + 8 * tr + 4);
      const float4 kv = *reinterpret_cast<const float4*>(kt + d * kSeqStride + 4 * tc);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float k[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(a[i], k[c], s[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[i][c] = k0 + tc + 16 * c < N ? s[i][c] * scale : kNeg;
}

// Sweep 1's step over one chunk for the thread's 8 rows (every lane of a
// row's 16 holds the same m and l). The sum runs warp_sum's tree over the
// 32 lanes j that hold keys j and j + 32: here key j's thread adds key j +
// 32 (s[i][0] + s[i][2], s[i][1] + s[i][3]), then the level 16 (the two
// sums), then levels 8, 4, 2, 1 over the lanes tc.
__device__ __forceinline__ void online_stats(const float (&s)[8][4], float (&m)[8],
                                             float (&l)[8]) {
  constexpr unsigned kAll = 0xffffffffu;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, o));
    const float m_prev = m[i];
    const float m_new = fmaxf(m_prev, mx);
    float e[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) e[c] = expf(s[i][c] - m_new);
    float sum = (e[0] + e[2]) + (e[1] + e[3]);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(kAll, sum, o);
    l[i] = l[i] * expf(m_prev - m_new) + sum;
    m[i] = m_new;
  }
}

// grid (ceil(N / 64), H, b), 128 threads, over images b0 .. b0 + b - 1 of
// qkv (B, N, 3 H kHd) bf16 and codes (B, N, H kHd) int8; scores holds
// seq_scores_per_block float4s for each block of the grid.
template <int kHd>
__global__ void __launch_bounds__(kSeqThreads, kHd >= 128 ? 2 : 4)
seq_attention_kernel(const __nv_bfloat16* __restrict__ qkv, int8_t* __restrict__ codes,
                     float4* __restrict__ scores, int b0, int N, int H, float scale,
                     float inv_a) {
  constexpr int kC = kHd / 16;  // output columns per thread
  constexpr int kVStride = kHd + 4;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // sweep 1
  float* kt = qt + kHd * kSeqStride;
  float* vs = reinterpret_cast<float*>(smem4);  // sweep 2
  float* pt = vs + kSeqTile * kVStride;

  const int tid = threadIdx.x;
  const int tr = tid >> 4;  // rows 8 tr .. 8 tr + 7 (warp w: rows 16 w ..)
  const int tc = tid & 15;  // keys tc + 16 m of a chunk; output columns kC tc ..
  const int q0 = blockIdx.x * kSeqTile;
  const int h = blockIdx.y;
  const int b = b0 + blockIdx.z;
  const int D = H * kHd;
  const size_t row_stride = 3 * static_cast<size_t>(D);
  const __nv_bfloat16* base = qkv + static_cast<size_t>(b) * N * row_stride + h * kHd;
  const bool active = q0 + 16 * (tid >> 5) < N;  // warp-uniform: the warp holds a query
  const int chunks = (N + kSeqTile - 1) / kSeqTile;
  float4* mine = scores + tid +
                 ((static_cast<long long>(blockIdx.z) * H + h) * gridDim.x + blockIdx.x) *
                     seq_scores_per_block(chunks);

  Chunk<kHd> kc;  // the next chunk of K (then of V), in flight
  fetch<kHd>(base, row_stride, q0, N, kc);
  put_f32<kHd, Put::kQ>(kc, qt);
  fetch<kHd>(base + D, row_stride, 0, N, kc);
  // Sweep 1: the scores, kept for sweep 2, and each row's max and sum of
  // exp(s - max). The first chunk always holds a valid key, so m is finite
  // after it and exp(kNeg - m) is 0 for the initial state and for masked
  // keys.
  float m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = kNeg, l[i] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const int k0 = c * kSeqTile;
    __syncthreads();  // Q^T is written; the previous chunk's K^T is consumed
    put_f32<kHd, Put::kK>(kc, kt);
    __syncthreads();
    // The next chunk of K, or sweep 2's first of V.
    fetch<kHd>(base + (c + 1 < chunks ? D : 2 * D), row_stride, c + 1 < chunks ? k0 + kSeqTile : 0,
               N, kc);
    if (active) {
      float s[8][4];
      score_tile<kHd>(qt, kt, k0, N, scale, s);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        mine[(c * 8 + i) * kSeqThreads] = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      }
      online_stats(s, m, l);
    }
  }

  // Sweep 2: the normalized probabilities, rounded to bf16, times V.
  float o[8][kC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) o[i][c] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const int k0 = c * kSeqTile;
    __syncthreads();  // sweep 1's K^T, or the previous chunk's V, is consumed
    put_f32<kHd, Put::kV>(kc, vs);
    __syncthreads();
    if (c + 1 < chunks) fetch<kHd>(base + 2 * D, row_stride, k0 + kSeqTile, N, kc);
    if (!active) continue;
    float4 st[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) st[i] = mine[(c * 8 + i) * kSeqThreads];
    // P^T[key][row]: the warp's own rows, read back only by the warp.
#pragma unroll
    for (int mk = 0; mk < 4; ++mk) {
      float p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float sc = mk == 0 ? st[i].x : mk == 1 ? st[i].y : mk == 2 ? st[i].z : st[i].w;
        p[i] = round_to<__nv_bfloat16>(expf(sc - m[i]) / fmaxf(l[i], 1e-30f));
      }
      float4* dst = reinterpret_cast<float4*>(pt + (tc + 16 * mk) * kSeqStride + 8 * tr);
      dst[0] = make_float4(p[0], p[1], p[2], p[3]);
      dst[1] = make_float4(p[4], p[5], p[6], p[7]);
    }
    __syncwarp();
    const int n_keys = min(kSeqTile, N - k0);  // keys past N would add 0
#pragma unroll 4
    for (int j = 0; j < n_keys; ++j) {
      const float4 p0 = *reinterpret_cast<const float4*>(pt + j * kSeqStride + 8 * tr);
      const float4 p1 = *reinterpret_cast<const float4*>(pt + j * kSeqStride + 8 * tr + 4);
      const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      float v[kC];
      const float* vrow = vs + j * kVStride + kC * tc;
      if constexpr (kC % 4 == 0) {
#pragma unroll
        for (int q = 0; q < kC; q += 4) {
          const float4 w = *reinterpret_cast<const float4*>(vrow + q);
          v[q] = w.x, v[q + 1] = w.y, v[q + 2] = w.z, v[q + 3] = w.w;
        }
      } else {
        const float2 w = *reinterpret_cast<const float2*>(vrow);
        v[0] = w.x, v[1] = w.y;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < kC; ++q) o[i][q] = fmaf(p[i], v[q], o[i][q]);
    }
  }
  if (!active) return;

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + 8 * tr + i;
    if (r >= N) continue;
    int c8[kC];
#pragma unroll
    for (int q = 0; q < kC; ++q) c8[q] = quantize_i8(round_to<__nv_bfloat16>(o[i][q]), inv_a);
    int8_t* dst = codes + (static_cast<size_t>(b) * N + r) * D + h * kHd + kC * tc;
    if constexpr (kC == 2) {
      *reinterpret_cast<int16_t*>(dst) = static_cast<int16_t>(pack4(c8[0], c8[1], 0, 0));
    } else {
#pragma unroll
      for (int q = 0; q < kC; q += 4) {
        *reinterpret_cast<int*>(dst + q) = pack4(c8[q], c8[q + 1], c8[q + 2], c8[q + 3]);
      }
    }
  }
}

// Launches over batch slices of `images` images, reusing the scores scratch
// (vit_seq_scores_bytes(images, N, H) bytes).
template <int kHd>
cudaError_t launch_seq_attention(cudaStream_t stream, const void* qkv, void* codes,
                                 void* scores, int images, int B, int N, int H, float scale,
                                 float inv_a) {
  const size_t smem = seq_attention_smem_bytes<kHd>();
  const cudaError_t err = allow_smem(seq_attention_kernel<kHd>, smem);
  if (err != cudaSuccess) return err;
  for (int b0 = 0; b0 < B; b0 += images) {
    const dim3 grid((N + kSeqTile - 1) / kSeqTile, H, std::min(images, B - b0));
    seq_attention_kernel<kHd><<<grid, kSeqThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(qkv), static_cast<int8_t*>(codes),
        static_cast<float4*>(scores), b0, N, H, scale, inv_a);
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return launched;
  }
  return cudaSuccess;
}

inline cudaError_t seq_attention(cudaStream_t stream, const void* qkv, void* codes, void* scores,
                                 int images, int B, int N, int H, int hd, float scale,
                                 float inv_a) {
  switch (hd) {
    case 32:
      return launch_seq_attention<32>(stream, qkv, codes, scores, images, B, N, H, scale, inv_a);
    case 64:
      return launch_seq_attention<64>(stream, qkv, codes, scores, images, B, N, H, scale, inv_a);
    case 128:
      return launch_seq_attention<128>(stream, qkv, codes, scores, images, B, N, H, scale, inv_a);
    default: return cudaErrorInvalidValue;
  }
}

// The projections' GEMM (see the top of this file): out (M, n_out) = A (M,
// K) W (K, n_out) + bias, then store_tile's epilogue (int8: A and W codes,
// dequantized with f.a2 and f.s2; kBlock: the half-block's tail). The grid
// is persistent, two blocks an SM of 256 threads: block b takes output
// tiles b, b + gridDim.x, ... (tile t is row tile t % ceil(M / 128) of
// column tile t / ceil(M / 128)), and one ring_loop runs over all their
// slices, so the next tile's first slices load while this tile's last ones
// and its epilogue run (a tile is only 3 to 6 slices deep at ViT-S/14).
// vec: bit 0 A, bit 1 W take 16-byte cp.async.
constexpr int kProjTm = 128;  // rows of a block's output tile
constexpr int kProjTn = 128;  // columns
constexpr int kProjStages = 3;
constexpr int kProjBlocksPerSm = 2;

template <typename T>
struct ProjTiles {
  static constexpr int kDepth = 128 / static_cast<int>(sizeof(T));  // a slice's k
  static constexpr int kSA = mlp_stride<T, kDepth, false>();          // A slice, 128 x depth
  static constexpr int kSW = mlp_stride<T, kProjTn, true>();          // W slice, depth x 128
  static constexpr int kStage = kProjTm * kSA + kDepth * kSW;
  static constexpr size_t kSmem = sizeof(T) * kProjStages * kStage;
};

template <typename T, typename OutT, bool kBlock>
__global__ void __launch_bounds__(kThreads, kProjBlocksPerSm)
proj_tc_kernel(const T* __restrict__ a, const T* __restrict__ w, const float* __restrict__ bias,
               OutT* __restrict__ out, int M, int K, int n_out, int vec, Folds f) {
  using Tl = ProjTiles<T>;
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);
  const int warp = threadIdx.x >> 5;
  const int row0 = 64 * (warp & 1), wc = warp >> 1;  // the warp's 64 rows and 32 columns
  const int m_tiles = (M + kProjTm - 1) / kProjTm;
  const int tiles = m_tiles * ((n_out + kProjTn - 1) / kProjTn);
  const int slices = (K + Tl::kDepth - 1) / Tl::kDepth;
  const int grid = gridDim.x, block = blockIdx.x;
  const int mine = (tiles - block + grid - 1) / grid;
  // Output tile of step s: its first row and column.
  auto origin = [&](int s, int& m0, int& c0) {
    const int t = block + (s / slices) * grid;
    m0 = (t % m_tiles) * kProjTm;
    c0 = (t / m_tiles) * kProjTn;
  };
  typename Frag<T>::Acc acc[4][4][4];
  ring_loop<kProjStages, Tl::kStage>(
      ring, mine * slices,
      [&](int s, T* buf) {
        int m0, c0;
        origin(s, m0, c0);
        const int k0 = (s % slices) * Tl::kDepth;
        stage_tile<T, kProjTm, Tl::kDepth, Tl::kSA, kThreads>(a, K, m0, k0, M, K, vec & 1, buf);
        stage_tile<T, Tl::kDepth, kProjTn, Tl::kSW, kThreads>(w, n_out, k0, c0, K, n_out,
                                                              vec & 2, buf + kProjTm * Tl::kSA);
      },
      [&](int s, const T* buf) {
        const int j = s % slices;
        if (j == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[i][n][e] = 0;
        }
        warp_product<T, 4, 4, Tl::kDepth, Tl::kSA, Tl::kSW, false, true>(
            buf, row0, 0, buf + kProjTm * Tl::kSA, 32 * wc, acc);
        if (j == slices - 1) {
          int m0, c0;
          origin(s, m0, c0);
          store_tile<kBlock>(acc, m0 + row0, c0 + 32 * wc, M, n_out, bias, f, out);
        }
      });
}

template <typename T, typename OutT, bool kBlock>
cudaError_t proj_tc(cudaStream_t stream, const void* a, const void* w, const void* bias, void* out,
                    int M, int K, int n_out, const Folds& f) {
  using Tl = ProjTiles<T>;
  const cudaError_t err = allow_smem(proj_tc_kernel<T, OutT, kBlock>, Tl::kSmem);
  if (err != cudaSuccess) return err;
  const int vec = vec16_ok<T>(a, K) | vec16_ok<T>(w, n_out) << 1;
  const long long tiles = static_cast<long long>((M + kProjTm - 1) / kProjTm) *
                          ((n_out + kProjTn - 1) / kProjTn);
  const int grid = static_cast<int>(std::min<long long>(tiles, kProjBlocksPerSm * sm_count()));
  proj_tc_kernel<T, OutT, kBlock><<<grid, kThreads, Tl::kSmem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<OutT*>(out), M, K, n_out, vec, f);
  return cudaGetLastError();
}

// K10 int8's qkv stage: x's codes (the prologue, into `codes`), then their
// product with w_qkv dequantized, + b_qkv, as OutT (bf16 for the
// half-block, f32 for the stage alone).
template <typename OutT>
cudaError_t qkv_int8(cudaStream_t stream, const void* x, const void* ln_g, const void* ln_b,
                     float eps, const void* w_qkv, const void* s_qkv, const void* b_qkv,
                     float inv_a, float a, void* codes, void* out, int M, int D, int n_out) {
  const cudaError_t err = prologue<true>(stream, x, ln_g, ln_b, eps, inv_a, codes, M, D);
  if (err != cudaSuccess) return err;
  Folds f{};
  f.s2 = static_cast<const float*>(s_qkv);
  f.a2 = a;
  return proj_tc<int8_t, OutT, std::is_same_v<OutT, __nv_bfloat16>>(stream, codes, w_qkv, b_qkv,
                                                                     out, M, D, n_out, f);
}

}  // namespace vit

extern "C" {

const char* vit_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

static bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// K7: qkv (B, N, 3 H hd) -> out (B, N, H hd), both f32 or both bf16
// (bf16 != 0), both 16-byte aligned; hd in {32, 64, 128}. Launches on
// `stream`, does not synchronize, returns cudaGetLastError().
int vit_attention_forward(const void* qkv, void* out, int B, int N, int H, int hd, float scale,
                          int bf16, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned16(qkv) || !aligned16(out)) return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? vit::attention<__nv_bfloat16>(st, qkv, out, B, N, H, hd, scale)
           : vit::attention<float>(st, qkv, out, B, N, H, hd, scale));
}

// K12: K7's kernel over separate q, k, v and out, element (b, h, n, d) of
// each at b * stride_b + h * stride_h + n * stride_n + d (q, k and v share
// `in_*`, out has `out_*`); every pointer and every stride's bytes a
// multiple of 16.
int vit_attention_forward_strided(const void* q, const void* k, const void* v, void* out, int B,
                                  int N, int H, int hd, long long in_b, long long in_h,
                                  long long in_n, long long out_b, long long out_h,
                                  long long out_n, float scale, int bf16, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long vec = bf16 ? 8 : 4;  // elements in 16 bytes
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out) || in_b % vec ||
      in_h % vec || in_n % vec || out_b % vec || out_h % vec || out_n % vec) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const vit::AttnArgs args{q, k, v, out, in_b, in_h, in_n, out_b, out_h, out_n, N, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? vit::attention<__nv_bfloat16>(st, args, B, H, hd)
                               : vit::attention<float>(st, args, B, H, hd));
}

// K10 (bf16): x (B, N, D); ln_g, ln_b (D,) f32 or both null; w_qkv (D, 3D)
// and w_proj (D, D) bf16; b_qkv (3D,), b_proj (D,) f32; ls (D,) bf16 or
// null; residual != 0 adds x. qkv (B, N, 3D) and att (B, N, D) bf16
// scratch (att also holds LN(x) until the attention overwrites it); out
// (B, N, D) bf16. Three launches on `stream`, four with the LayerNorm.
int vit_attention_block_bf16(const void* x, const void* ln_g, const void* ln_b, float eps,
                             const void* w_qkv, const void* b_qkv, const void* w_proj,
                             const void* b_proj, const void* ls, int residual, void* qkv,
                             void* att, void* out, int B, int N, int D, int H, float scale,
                             void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || D % H != 0 || (ln_g == nullptr) != (ln_b == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using bf = __nv_bfloat16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  cudaError_t err = cudaSuccess;
  if (ln_g != nullptr) err = vit::prologue<false>(st, x, ln_g, ln_b, eps, 0.f, att, M, D);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = vit::proj_tc<bf, bf, true>(st, ln_g != nullptr ? att : x, w_qkv, b_qkv, qkv, M, D, 3 * D,
                                   vit::Folds{});
  if (err != cudaSuccess) return static_cast<int>(err);
  err = vit::attention<bf>(st, qkv, att, B, N, H, D / H, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  vit::Folds f{};
  f.res = residual ? static_cast<const bf*>(x) : nullptr;
  f.ls = static_cast<const bf*>(ls);
  return static_cast<int>(vit::proj_tc<bf, bf, true>(st, att, w_proj, b_proj, out, M, D, D, f));
}

// K10 int8: x (B, N, D) bf16, D a multiple of 4; ln_g, ln_b (D,) f32 or both
// null; w_qkv (D, 3D) and w_proj (D, D) int8 with per-column scales s_qkv
// (3D,) and s_proj (D,) f32; b_qkv (3D,), b_proj (D,) f32; inv_a_* and a_*
// the activation scales' reciprocals and the scales; ls (D,) bf16 or null;
// residual != 0 adds x. qkv (B, N, 3D) bf16 and codes (B, N, D) int8
// scratch (x's codes, then the attention output's); scores f32 scratch of
// vit_seq_scores_bytes(images, N, H) bytes, the attention stage's scores
// for `images` images at a time; out (B, N, D) bf16. Four launches on
// `stream`, more when images < B.
int vit_attention_block_int8(const void* x, const void* ln_g, const void* ln_b, float eps,
                             const void* w_qkv, const void* s_qkv, const void* b_qkv,
                             float inv_a_qkv, float a_qkv, const void* w_proj,
                             const void* s_proj, const void* b_proj, float inv_a_proj,
                             float a_proj, const void* ls, int residual, void* qkv, void* codes,
                             void* scores, int images, void* out, int B, int N, int D, int H,
                             float scale, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || D % H != 0 || D % 4 != 0 || images <= 0 ||
      (ln_g == nullptr) != (ln_b == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using bf = __nv_bfloat16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  cudaError_t err = vit::qkv_int8<bf>(st, x, ln_g, ln_b, eps, w_qkv, s_qkv, b_qkv, inv_a_qkv,
                                      a_qkv, codes, qkv, M, D, 3 * D);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = vit::seq_attention(st, qkv, codes, scores, images, B, N, H, D / H, scale, inv_a_proj);
  if (err != cudaSuccess) return static_cast<int>(err);
  vit::Folds f{};
  f.res = residual ? static_cast<const bf*>(x) : nullptr;
  f.ls = static_cast<const bf*>(ls);
  f.s2 = static_cast<const float*>(s_proj);
  f.a2 = a_proj;
  return static_cast<int>(
      vit::proj_tc<int8_t, bf, true>(st, codes, w_proj, b_proj, out, M, D, D, f));
}

// Bytes of K10 int8's scores scratch for `images` images of N tokens and H
// heads: ceil(N / 64)^2 H 16 KB an image.
long long vit_seq_scores_bytes(int images, int N, int H) {
  const int tiles = (N + vit::kSeqTile - 1) / vit::kSeqTile;
  return static_cast<long long>(images) * H * tiles * vit::seq_scores_per_block(tiles) *
         static_cast<long long>(sizeof(float4));
}

// K10 int8's qkv stage alone: x (M, D) bf16, D a multiple of 4; ln_g, ln_b,
// w_qkv (D, n_out) int8, s_qkv and b_qkv (n_out,) f32 as above; codes (M,
// D) int8 scratch; out (M, n_out) f32, the dequantized product before its
// rounding to bf16. Two launches on `stream`.
int vit_qkv_proj_int8(const void* x, const void* ln_g, const void* ln_b, float eps,
                      const void* w_qkv, const void* s_qkv, const void* b_qkv, float inv_a,
                      float a, void* codes, void* out, int M, int D, int n_out, void* stream) {
  if (M <= 0 || D <= 0 || n_out <= 0 || D % 4 != 0 || (ln_g == nullptr) != (ln_b == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(vit::qkv_int8<float>(static_cast<cudaStream_t>(stream), x, ln_g, ln_b,
                                               eps, w_qkv, s_qkv, b_qkv, inv_a, a, codes, out, M,
                                               D, n_out));
}

}  // extern "C"
