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
// in VMEM, so K10 runs three stages through device memory:
//   1. ln_gemm_kernel: LayerNorm in the prologue (f32 statistics, output
//      rounded to bf16), x W_qkv + b, rounded to bf16 -> qkv scratch;
//   2. K7's attention_kernel in bf16 -> att scratch (the f32 attention
//      output rounded to bf16 before proj, as the TPU kernel rounds it);
//   3. ln_gemm_kernel: att W_proj + b rounded to bf16, then * LayerScale
//      (rounded to bf16) and + x (rounded to bf16) in the epilogue.
// Each stage keeps the TPU kernel's bf16 rounding points. Its bound at
// B = 64: 25.9 GFLOP over 989 TFLOP/s (26 us) in bf16; the projections run
// on FFMA here, at most 67 TFLOP/s, the attention on the tensor cores.
//
// K10 int8 replaces the same TPU kernel with quant=True (the launch of
// fused_attention_qkv_int8): stages 1 and 3 become ln_gemm_i8_kernel, which
// quantizes its (LayerNorm'd, bf16-rounded) input as it stages it,
// clip(rint(x * (1/a)), -127, 127), multiplies int8 codes by the int8
// weights with __dp4a into int32 sums, and dequantizes in the epilogue as
// acc * (a * w_scale[c]) + bias[c] (two roundings, no FMA, as the TPU
// kernel computes it), then rounds to bf16; its LayerNorm statistics are
// row_stats_f64's, which the plain version reproduces exactly, since a
// normalized value whose bf16 rounding flips can move a code and with it a
// whole token downstream. Stage 2 is K7's function in bf16 (bf16 score
// and PV products, f32 softmax), as on the TPU, but on FFMA in the plain
// version's summation order (seq_attention_kernel below): a bf16 flip of
// the attention output moves its int8 code too. Its bound at B = 64: the
// projections' 19.4 G int8 operations over 1,979 TOP/s (10 us) and the
// attention's 6.5 GFLOP over 989 TFLOP/s (7 us); __dp4a and FFMA run far
// below the tensor cores' rates.

#include "vit_mma.cuh"

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

// K10 int8's attention stage: K7's function on FFMA, the scores summed
// over the head's columns in order, one fused multiply-add at a time, as
// the plain version's cuBLAS product sums them. The int8 stack quantizes
// the attention output to codes, and one bf16 flip of a probability moves
// a code: with the scores summed in any other order (the tensor cores', or
// rounded exactly from an f64 sum) the K10 int8 check misses its 1e-2 by
// 7% and the served int8 features their 0.9999 cosine (PERF.md, PR 9).
// A block owns 64 queries of one (batch, head), 256 threads, and sweeps
// the keys twice in chunks of 64 staged as f32 in shared memory (Q and K
// transposed): sweep 1 keeps each row's running max and sum, sweep 2
// recomputes the scores, rounds the normalized probabilities to bf16 and
// accumulates P V, each thread 4 rows x hd / 16 columns.
constexpr int kSeqTile = 64;              // queries per block, keys per chunk
constexpr int kSeqStride = kSeqTile + 4;  // padded row stride (floats) of the staged tiles

template <int kHd>
constexpr size_t seq_attention_smem_bytes() {
  return sizeof(float) * (2 * kHd * kSeqStride      // Q^T, K^T
                          + kSeqTile * (kHd + 4)     // V
                          + kSeqTile * kSeqStride    // scores, then p
                          + 2 * kSeqTile);           // m, l
}

// Stage keys (and with kWithV values) k0 .. k0 + 63 of one head: K
// transposed into kt, V into vs; keys past N load as 0.
template <bool kWithV, typename T, int kHd>
__device__ __forceinline__ void load_kv(const T* __restrict__ base, size_t row_stride, int D,
                                        int k0, int N, float* __restrict__ kt,
                                        float* __restrict__ vs) {
  for (int idx = threadIdx.x; idx < kSeqTile * kHd; idx += kThreads) {
    const int j = idx / kHd, d = idx % kHd;
    const bool valid = k0 + j < N;
    const T* row = base + (k0 + j) * row_stride;
    kt[d * kSeqStride + j] = valid ? to_float(row[D + d]) : 0.f;
    if (kWithV) vs[j * (kHd + 4) + d] = valid ? to_float(row[2 * D + d]) : 0.f;
  }
}

// The staged chunk's scores q.k * scale into ss (row-major, 64 x 64; keys
// past N score kNeg). Thread (tr, tc) owns rows 4 tr .. and keys 4 tc ...
template <int kHd>
__device__ __forceinline__ void score_tile(const float* __restrict__ qt,
                                           const float* __restrict__ kt, int k0, int N,
                                           float scale, float* __restrict__ ss) {
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
  for (int d = 0; d < kHd; ++d) {
    float a[4];
    load_vec<4>(qt + d * kSeqStride + 4 * tr, a);
    fma_tile<4, 1>(a, kt + d * kSeqStride + 4 * tc, s);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 v;
    v.x = k0 + 4 * tc < N ? s[i][0] * scale : kNeg;
    v.y = k0 + 4 * tc + 1 < N ? s[i][1] * scale : kNeg;
    v.z = k0 + 4 * tc + 2 < N ? s[i][2] * scale : kNeg;
    v.w = k0 + 4 * tc + 3 < N ? s[i][3] * scale : kNeg;
    *reinterpret_cast<float4*>(ss + (4 * tr + i) * kSeqStride + 4 * tc) = v;
  }
}

template <typename T, int kHd>
__global__ void __launch_bounds__(kThreads)
seq_attention_kernel(const T* __restrict__ qkv, T* __restrict__ out, int N, int H, float scale) {
  constexpr int kCols = kHd / 16;  // output columns per thread
  constexpr int kVStride = kHd + 4;
  constexpr int kRowsPerWarp = kSeqTile / kWarps;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);
  float* kt = qt + kHd * kSeqStride;
  float* vs = kt + kHd * kSeqStride;
  float* ss = vs + kSeqTile * kVStride;
  float* m_row = ss + kSeqTile * kSeqStride;
  float* l_row = m_row + kSeqTile;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tr = tid >> 4;  // rows 4 tr .. 4 tr + 3
  const int tc = tid & 15;  // output columns kCols tc ..
  const int q0 = blockIdx.x * kSeqTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * kHd;
  const size_t row_stride = 3 * static_cast<size_t>(D);
  const T* base = qkv + static_cast<size_t>(b) * N * row_stride + h * kHd;

  for (int idx = tid; idx < kSeqTile * kHd; idx += kThreads) {
    const int r = idx / kHd, d = idx % kHd;
    qt[d * kSeqStride + r] = q0 + r < N ? to_float(base[(q0 + r) * row_stride + d]) : 0.f;
  }
  if (tid < kSeqTile) {
    m_row[tid] = kNeg;
    l_row[tid] = 0.f;
  }

  // Sweep 1: each row's max and sum of exp(s - max). The first chunk always
  // holds a valid key, so m is finite after it and exp(kNeg - m) is 0 for
  // the initial state and for masked keys.
  for (int k0 = 0; k0 < N; k0 += kSeqTile) {
    __syncthreads();  // the previous chunk's K and scores are consumed
    load_kv<false, T, kHd>(base, row_stride, D, k0, N, kt, vs);
    __syncthreads();
    score_tile<kHd>(qt, kt, k0, N, scale, ss);
    __syncthreads();
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const float s0 = ss[r * kSeqStride + lane], s1 = ss[r * kSeqStride + lane + 32];
      const float m_prev = m_row[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float sum = warp_sum(expf(s0 - m_new) + expf(s1 - m_new));
      if (lane == 0) {
        l_row[r] = l_row[r] * expf(m_prev - m_new) + sum;
        m_row[r] = m_new;
      }
    }
  }

  // Sweep 2: the normalized probabilities, rounded to T, times V.
  float o[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[i][c] = 0.f;
  for (int k0 = 0; k0 < N; k0 += kSeqTile) {
    __syncthreads();  // sweep 1's statistics are written; the previous chunk consumed
    load_kv<true, T, kHd>(base, row_stride, D, k0, N, kt, vs);
    __syncthreads();
    score_tile<kHd>(qt, kt, k0, N, scale, ss);
    __syncthreads();
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const float m = m_row[r], l = fmaxf(l_row[r], 1e-30f);
      float* row = ss + r * kSeqStride;
      row[lane] = round_to<T>(expf(row[lane] - m) / l);
      row[lane + 32] = round_to<T>(expf(row[lane + 32] - m) / l);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kSeqTile; ++j) {
      float v[kCols];
      load_vec<kCols>(vs + j * kVStride + kCols * tc, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ss[(4 * tr + i) * kSeqStride + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) o[i][c] = fmaf(p, v[c], o[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * tr + i;
    if (q0 + r >= N) continue;
    T* dst = out + (static_cast<size_t>(b) * N + q0 + r) * D + h * kHd + kCols * tc;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dst[c] = from_float<T>(o[i][c]);
  }
}

template <typename T, int kHd>
cudaError_t launch_seq_attention(cudaStream_t stream, const void* qkv, void* out, int B, int N,
                                 int H, float scale) {
  const size_t smem = seq_attention_smem_bytes<kHd>();
  const cudaError_t err = allow_smem(seq_attention_kernel<T, kHd>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kSeqTile - 1) / kSeqTile, H, B);
  seq_attention_kernel<T, kHd><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), N, H, scale);
  return cudaGetLastError();
}

inline cudaError_t seq_attention(cudaStream_t stream, const void* qkv, void* out, int B, int N,
                                 int H, int hd, float scale) {
  using bf = __nv_bfloat16;
  switch (hd) {
    case 32: return launch_seq_attention<bf, 32>(stream, qkv, out, B, N, H, scale);
    case 64: return launch_seq_attention<bf, 64>(stream, qkv, out, B, N, H, scale);
    case 128: return launch_seq_attention<bf, 128>(stream, qkv, out, B, N, H, scale);
    default: return cudaErrorInvalidValue;
  }
}

// out (M, n_out) = [LN](A) (M, K) W (K, n_out) + bias, rounded to T, then
// [* ls, rounded] [+ resid, rounded]. A block computes 64 rows x 128
// columns; each thread 8 rows x 4 columns, from K slices of 16 staged in
// shared memory (A transposed, with the LayerNorm applied as it loads).
// ln_g == nullptr: no LayerNorm; ls, resid may be null.
constexpr int kGemmRows = 64;
constexpr int kGemmCols = 128;
constexpr int kGemmK = 16;
constexpr int kGemmStride = kGemmRows + 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_gemm_kernel(const T* __restrict__ A, const float* __restrict__ ln_g,
               const float* __restrict__ ln_b, float eps, const T* __restrict__ W,
               const float* __restrict__ bias, const T* __restrict__ ls,
               const T* __restrict__ resid, T* __restrict__ out, int M, int K, int n_out) {
  __shared__ __align__(16) float at[kGemmK * kGemmStride];
  __shared__ __align__(16) float ws[kGemmK * kGemmCols];
  __shared__ float mean_s[kGemmRows], rstd_s[kGemmRows];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * kGemmRows;
  const int n0 = blockIdx.y * kGemmCols;
  constexpr int kRows = kGemmRows / kWarps;  // 8 rows per thread, one row group per warp

  if (ln_g != nullptr) {
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = warp * kRows + rr;
      float mean = 0.f, rstd = 1.f;
      if (m0 + r < M) row_stats(A + static_cast<size_t>(m0 + r) * K, K, eps, mean, rstd);
      if (lane == 0) {
        mean_s[r] = mean;
        rstd_s[r] = rstd;
      }
    }
  }
  float acc[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kGemmK) {
    __syncthreads();  // the previous slice is consumed (and the LN statistics written)
#pragma unroll
    for (int u = 0; u < kGemmRows * kGemmK / kThreads; ++u) {
      const int idx = tid + u * kThreads;
      const int r = idx / kGemmK, kk = idx % kGemmK;
      const int row = m0 + r, k = k0 + kk;
      float a = 0.f;
      if (row < M && k < K) {
        a = to_float(A[static_cast<size_t>(row) * K + k]);
        if (ln_g != nullptr) a = round_to<T>((a - mean_s[r]) * rstd_s[r] * ln_g[k] + ln_b[k]);
      }
      at[kk * kGemmStride + r] = a;
    }
#pragma unroll
    for (int u = 0; u < kGemmK * kGemmCols / kThreads; ++u) {
      const int idx = tid + u * kThreads;
      const int kk = idx / kGemmCols, c = idx % kGemmCols;
      const int k = k0 + kk, col = n0 + c;
      ws[idx] = k < K && col < n_out ? to_float(W[static_cast<size_t>(k) * n_out + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGemmK; ++kk) {
      float a[kRows];
      load_vec<kRows>(at + kk * kGemmStride + warp * kRows, a);
      fma_tile<kRows, 1>(a, ws + kk * kGemmCols + 4 * lane, acc);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = m0 + warp * kRows + i;
    if (row >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = n0 + 4 * lane + c;
      if (col >= n_out) continue;
      const size_t at_out = static_cast<size_t>(row) * n_out + col;
      float v = round_to<T>(acc[i][c] + bias[col]);
      if (ls != nullptr) v = round_to<T>(v * to_float(ls[col]));
      if (resid != nullptr) v = round_to<T>(to_float(resid[at_out]) + v);
      out[at_out] = from_float<T>(v);
    }
  }
}

// The int8 ln_gemm: out (M, n_out) bf16 = dequant([LN](A) codes W) + bias,
// then [* ls] [+ resid], each rounded to bf16. A (M, K) bf16, K a multiple
// of 4; W (K, n_out) int8; w_scale, bias (n_out,) f32. A block computes 64
// rows x 128 columns, each thread 8 rows x 4 columns in int32, from K slices
// of 32 staged in shared memory as words of four codes along K: A's rows
// quantized as they load, W's columns packed from four rows.
constexpr int kQGemmWords = 8;  // 32-bit words (4 K values each) per staged slice

__global__ void __launch_bounds__(kThreads)
ln_gemm_i8_kernel(const __nv_bfloat16* __restrict__ A, const float* __restrict__ ln_g,
                  const float* __restrict__ ln_b, float eps, float inv_a, float a,
                  const int8_t* __restrict__ W, const float* __restrict__ w_scale,
                  const float* __restrict__ bias, const __nv_bfloat16* __restrict__ ls,
                  const __nv_bfloat16* __restrict__ resid, __nv_bfloat16* __restrict__ out,
                  int M, int K, int n_out) {
  using bf = __nv_bfloat16;
  __shared__ __align__(16) int at[kQGemmWords * kGemmStride];
  __shared__ __align__(16) int ws[kQGemmWords * kGemmCols];
  __shared__ float mean_s[kGemmRows], rstd_s[kGemmRows];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * kGemmRows;
  const int n0 = blockIdx.y * kGemmCols;
  constexpr int kRows = kGemmRows / kWarps;

  if (ln_g != nullptr) {
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = warp * kRows + rr;
      float mean = 0.f, rstd = 1.f;
      if (m0 + r < M) row_stats_f64(A + static_cast<size_t>(m0 + r) * K, K, eps, mean, rstd);
      if (lane == 0) {
        mean_s[r] = mean;
        rstd_s[r] = rstd;
      }
    }
  }
  int acc[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0;

  for (int k0 = 0; k0 < K; k0 += 4 * kQGemmWords) {
    __syncthreads();  // the previous slice is consumed (and the LN statistics written)
#pragma unroll
    for (int u = 0; u < kGemmRows * kQGemmWords / kThreads; ++u) {
      const int idx = tid + u * kThreads;
      const int r = idx / kQGemmWords, kw = idx % kQGemmWords;
      const int row = m0 + r, k = k0 + 4 * kw;
      int c[4] = {0, 0, 0, 0};
      if (row < M && k < K) {  // K % 4 == 0: the word is whole
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = to_float(A[static_cast<size_t>(row) * K + k + e]);
          if (ln_g != nullptr) {
            v = ln_bf16(v, mean_s[r], rstd_s[r], ln_g[k + e], ln_b[k + e]);
          }
          c[e] = quantize_i8(v, inv_a);
        }
      }
      at[kw * kGemmStride + r] = pack4(c[0], c[1], c[2], c[3]);
    }
#pragma unroll
    for (int u = 0; u < kQGemmWords * kGemmCols / kThreads; ++u) {
      const int idx = tid + u * kThreads;
      const int kw = idx / kGemmCols, col = n0 + idx % kGemmCols;
      const int k = k0 + 4 * kw;
      int c[4] = {0, 0, 0, 0};
      if (k < K && col < n_out) {
#pragma unroll
        for (int e = 0; e < 4; ++e) c[e] = W[static_cast<size_t>(k + e) * n_out + col];
      }
      ws[idx] = pack4(c[0], c[1], c[2], c[3]);
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kQGemmWords; ++kw) {
      const int4 a0 = *reinterpret_cast<const int4*>(at + kw * kGemmStride + warp * kRows);
      const int4 a1 = *reinterpret_cast<const int4*>(at + kw * kGemmStride + warp * kRows + 4);
      const int4 b = *reinterpret_cast<const int4*>(ws + kw * kGemmCols + 4 * lane);
      const int av[kRows] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        acc[i][0] = __dp4a(av[i], b.x, acc[i][0]);
        acc[i][1] = __dp4a(av[i], b.y, acc[i][1]);
        acc[i][2] = __dp4a(av[i], b.z, acc[i][2]);
        acc[i][3] = __dp4a(av[i], b.w, acc[i][3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = m0 + warp * kRows + i;
    if (row >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = n0 + 4 * lane + c;
      if (col >= n_out) continue;
      const size_t at_out = static_cast<size_t>(row) * n_out + col;
      const float deq = __fmul_rn(__int2float_rn(acc[i][c]), __fmul_rn(a, w_scale[col]));
      float v = round_to<bf>(__fadd_rn(deq, bias[col]));
      if (ls != nullptr) v = round_to<bf>(v * to_float(ls[col]));
      if (resid != nullptr) v = round_to<bf>(to_float(resid[at_out]) + v);
      out[at_out] = from_float<bf>(v);
    }
  }
}

inline cudaError_t ln_gemm_i8(cudaStream_t stream, const void* A, const void* ln_g,
                              const void* ln_b, float eps, float inv_a, float a, const void* W,
                              const void* w_scale, const void* bias, const void* ls,
                              const void* resid, void* out, int M, int K, int n_out) {
  using bf = __nv_bfloat16;
  const dim3 grid((M + kGemmRows - 1) / kGemmRows, (n_out + kGemmCols - 1) / kGemmCols);
  ln_gemm_i8_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const bf*>(A), static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
      eps, inv_a, a, static_cast<const int8_t*>(W), static_cast<const float*>(w_scale),
      static_cast<const float*>(bias), static_cast<const bf*>(ls), static_cast<const bf*>(resid),
      static_cast<bf*>(out), M, K, n_out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t ln_gemm(cudaStream_t stream, const void* A, const void* ln_g, const void* ln_b,
                    float eps, const void* W, const void* bias, const void* ls, const void* resid,
                    void* out, int M, int K, int n_out) {
  const dim3 grid((M + kGemmRows - 1) / kGemmRows, (n_out + kGemmCols - 1) / kGemmCols);
  ln_gemm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(A), static_cast<const float*>(ln_g), static_cast<const float*>(ln_b),
      eps, static_cast<const T*>(W), static_cast<const float*>(bias), static_cast<const T*>(ls),
      static_cast<const T*>(resid), static_cast<T*>(out), M, K, n_out);
  return cudaGetLastError();
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
// scratch; out (B, N, D) bf16. Three launches on `stream`.
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
  cudaError_t err = vit::ln_gemm<bf>(st, x, ln_g, ln_b, eps, w_qkv, b_qkv, nullptr, nullptr, qkv,
                                     M, D, 3 * D);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = vit::attention<bf>(st, qkv, att, B, N, H, D / H, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(vit::ln_gemm<bf>(st, att, nullptr, nullptr, eps, w_proj, b_proj, ls,
                                           residual ? x : nullptr, out, M, D, D));
}

// K10 int8: x (B, N, D) bf16, D a multiple of 4; ln_g, ln_b (D,) f32 or both
// null; w_qkv (D, 3D) and w_proj (D, D) int8 with per-column scales s_qkv
// (3D,) and s_proj (D,) f32; b_qkv (3D,), b_proj (D,) f32; inv_a_* and a_*
// the activation scales' reciprocals and the scales; ls (D,) bf16 or null;
// residual != 0 adds x. qkv (B, N, 3D) and att (B, N, D) bf16 scratch; out
// (B, N, D) bf16. Three launches on `stream`.
int vit_attention_block_int8(const void* x, const void* ln_g, const void* ln_b, float eps,
                             const void* w_qkv, const void* s_qkv, const void* b_qkv,
                             float inv_a_qkv, float a_qkv, const void* w_proj,
                             const void* s_proj, const void* b_proj, float inv_a_proj,
                             float a_proj, const void* ls, int residual, void* qkv, void* att,
                             void* out, int B, int N, int D, int H, float scale, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || D % H != 0 || D % 4 != 0 ||
      (ln_g == nullptr) != (ln_b == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  cudaError_t err = vit::ln_gemm_i8(st, x, ln_g, ln_b, eps, inv_a_qkv, a_qkv, w_qkv, s_qkv, b_qkv,
                                    nullptr, nullptr, qkv, M, D, 3 * D);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = vit::seq_attention(st, qkv, att, B, N, H, D / H, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(vit::ln_gemm_i8(st, att, nullptr, nullptr, eps, inv_a_proj, a_proj,
                                          w_proj, s_proj, b_proj, ls, residual ? x : nullptr,
                                          out, M, D, D));
}

}  // extern "C"
