// ViT attention backward for Hopper (sm_90a): K8, the VJP of K7.
//
// Replaces nwhead_tpu/ops/pallas_attn.py:_attn_qkv_bwd_kernel (the single
// pass) and _attn_qkv_chunked_bwd_kernel (its long-N form). From the packed
// qkv (B, N, 3 D) and dO (B, N, D) alone (nothing else is saved by the
// forward), per head, with P = softmax(q k^T * scale) recomputed in f32:
//   dV = round(P)^T dO                      (P rounded to the input dtype)
//   dP = dO v^T                             (f32)
//   delta = rowsum(dP * P)                  (the f32 P)
//   dS = round(P * (dP - delta))            (rounded to the input dtype)
//   dQ = dS k * scale,  dK = dS^T q * scale
// and dqkv (B, N, 3 D) in the input dtype, every element written once.
// The TPU kernel holds one batch row's (N, N) scores in VMEM; here no block
// sees more than a 64 x 64 tile, and the three parts of the VJP are three
// launches over grids of (64-row tile, head, batch row), so any N runs:
//   1. stats: 64 queries a block sweep the keys twice, for each row's max m
//      and sum l (online), then for delta = sum_j P_ij dP_ij; they write
//      (m, l, delta) to a (3, B, H, N) f32 scratch tensor. delta is the
//      single pass's rowsum(dP * P) up to the order of the f32 sums.
//   2. dK, dV: a block owns 64 keys and loops over every query tile,
//      recomputes P and dP from the stats and accumulates dV and dK for
//      its keys in registers;
//   3. dQ: a block owns 64 queries and loops over every key tile,
//      accumulating dQ in registers.
// Each output element has one owner block and every sum runs in a fixed
// order (no atomics). Tiles are staged in shared memory transposed and as
// f32 (16 B reads along the 64 rows); a thread computes 4 x 4 of each 64 x 64
// product and, in the accumulations, 4 rows x hd / 16 columns.
// What bounds it at ViT-S/14 (B = 64, N = 257, H = 6, hd = 64): the five
// products of the VJP, 10 B H N^2 hd = 16.2 GFLOP, 0.24 ms at the 67 TFLOP/s
// f32 rate outside the tensor cores (this version recomputes the scores
// three times and dP twice: 20 B H N^2 hd on FFMA); bytes (qkv, dO, dqkv)
// are 177 MB in f32, 53 us. wgmma and TMA are later work.

#include "vit_common.cuh"

namespace vit {

// Rows r0 .. r0 + 63 of hd columns from column `col` of a row-major matrix
// (row_stride elements a row), transposed into dst[d * kTileStride + r];
// rows past N load as 0.
template <typename T, int kHd>
__device__ __forceinline__ void stage_t(const T* __restrict__ base, size_t row_stride, int col,
                                        int r0, int N, float* __restrict__ dst) {
  for (int idx = threadIdx.x; idx < kTile * kHd; idx += kThreads) {
    const int r = idx / kHd, d = idx % kHd;
    dst[d * kTileStride + r] =
        r0 + r < N ? to_float(base[static_cast<size_t>(r0 + r) * row_stride + col + d]) : 0.f;
  }
}

// acc[i][c] = sum_d a[d][4 tr + i] * b[d][4 tc + c] for two staged
// (transposed) 64-row tiles; thread (tr, tc) = (tid / 16, tid % 16).
template <int kHd>
__device__ __forceinline__ void tile_dot(const float* __restrict__ a, const float* __restrict__ b,
                                         float (&acc)[4][4]) {
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
#pragma unroll 8
  for (int d = 0; d < kHd; ++d) {
    float x[4];
    load_vec<4>(a + d * kTileStride + 4 * tr, x);
    fma_tile<4, 1>(x, b + d * kTileStride + 4 * tc, acc);
  }
}

// Sum and max over the 16 lanes that share tr (one half of a warp).
__device__ __forceinline__ float half_warp_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float half_warp_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The pointers and offsets of one (batch row, head).
template <typename T>
struct Head {
  const T* qkv;   // batch row b of qkv
  const T* dout;  // batch row b of dO
  size_t stride;  // 3 D
  int D, q_col, k_col, v_col;
  __device__ Head(const T* qkv_all, const T* dout_all, int b, int h, int N, int H, int hd)
      : qkv(qkv_all + static_cast<size_t>(b) * N * 3 * H * hd),
        dout(dout_all + static_cast<size_t>(b) * N * H * hd),
        stride(3 * static_cast<size_t>(H) * hd), D(H * hd), q_col(h * hd), k_col(D + h * hd),
        v_col(2 * D + h * hd) {}
};

template <int kHd>
constexpr size_t bwd_tile_bytes() { return sizeof(float) * kHd * kTileStride; }
constexpr size_t kSquareBytes = sizeof(float) * kTile * kTileStride;

// Part 1. grid (ceil(N / 64), H, B). stats (3, B, H, N): m, l, delta.
template <typename T, int kHd>
__global__ void __launch_bounds__(kThreads)
attn_bwd_stats_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                      float* __restrict__ stats, int B, int N, int H, float scale) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);
  float* dot = qt + kHd * kTileStride;
  float* kt = dot + kHd * kTileStride;
  float* vt = kt + kHd * kTileStride;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const Head<T> hp(qkv, dout, b, h, N, H, kHd);
  stage_t<T, kHd>(hp.qkv, hp.stride, hp.q_col, q0, N, qt);
  stage_t<T, kHd>(hp.dout, hp.D, hp.q_col, q0, N, dot);

  // Sweep 1: max and sum of exp(s - max) per row, online. The first chunk
  // holds a valid key, so m is finite after it and exp(kNeg - m) is 0.
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();  // the previous chunk is consumed
    stage_t<T, kHd>(hp.qkv, hp.stride, hp.k_col, k0, N, kt);
    __syncthreads();
    float s[4][4];
    tile_dot<kHd>(qt, kt, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = k0 + 4 * tc + c < N ? s[i][c] * scale : kNeg;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) sum += expf(s[i][c] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + half_warp_sum(sum);
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) l[i] = fmaxf(l[i], 1e-30f);

  // Sweep 2: delta = sum_j P_ij (dO_i . v_j), P normalized in f32.
  float delta[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();
    stage_t<T, kHd>(hp.qkv, hp.stride, hp.k_col, k0, N, kt);
    stage_t<T, kHd>(hp.qkv, hp.stride, hp.v_col, k0, N, vt);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<kHd>(qt, kt, s);
    tile_dot<kHd>(dot, vt, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (k0 + 4 * tc + c < N) delta[i] += expf(s[i][c] * scale - m[i]) / l[i] * dp[i][c];
  }
  const size_t plane = static_cast<size_t>(B) * H * N;
  float* st = stats + (static_cast<size_t>(b) * H + h) * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    delta[i] = half_warp_sum(delta[i]);
    const int row = q0 + 4 * tr + i;
    if (tc == 0 && row < N) {
      st[row] = m[i];
      st[plane + row] = l[i];
      st[2 * plane + row] = delta[i];
    }
  }
}

// P and dS of the staged 64 x 64 tile (queries q0.., keys k0..) into ps and
// dss (row = query, rounded to T), from the rows' (m, l, delta).
template <typename T, int kHd>
__device__ __forceinline__ void grad_tile(const float* __restrict__ qt,
                                          const float* __restrict__ dot,
                                          const float* __restrict__ kt,
                                          const float* __restrict__ vt, int q0, int k0, int N,
                                          float scale, const float (&m)[4], const float (&l)[4],
                                          const float (&delta)[4], float* __restrict__ ps,
                                          float* __restrict__ dss) {
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  float s[4][4], dp[4][4];
  tile_dot<kHd>(qt, kt, s);
  tile_dot<kHd>(dot, vt, dp);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool valid = q0 + 4 * tr + i < N && k0 + 4 * tc + c < N;
      const float p = valid ? expf(s[i][c] * scale - m[i]) / l[i] : 0.f;
      const int at = (4 * tr + i) * kTileStride + 4 * tc + c;
      if (ps != nullptr) ps[at] = round_to<T>(p);
      dss[at] = round_to<T>(p * (dp[i][c] - delta[i]));
    }
}

// Part 2. grid (ceil(N / 64), H, B): the block's 64 keys' dK and dV.
template <typename T, int kHd>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                     const float* __restrict__ stats, T* __restrict__ dqkv, int B, int N, int H,
                     float scale) {
  constexpr int kCols = kHd / 16;  // columns per thread in the accumulations
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);
  float* vt = kt + kHd * kTileStride;
  float* qt = vt + kHd * kTileStride;
  float* dot = qt + kHd * kTileStride;
  float* ps = dot + kHd * kTileStride;
  float* dss = ps + kTile * kTileStride;
  float* row_stats = dss + kTile * kTileStride;  // m, l, delta of the query tile
  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const Head<T> hp(qkv, dout, b, h, N, H, kHd);
  const size_t plane = static_cast<size_t>(B) * H * N;
  const float* st = stats + (static_cast<size_t>(b) * H + h) * N;
  stage_t<T, kHd>(hp.qkv, hp.stride, hp.k_col, k0, N, kt);
  stage_t<T, kHd>(hp.qkv, hp.stride, hp.v_col, k0, N, vt);

  float dk[4][kCols], dv[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[r][c] = dv[r][c] = 0.f;
  for (int q0 = 0; q0 < N; q0 += kTile) {
    __syncthreads();  // the previous query tile is consumed
    stage_t<T, kHd>(hp.qkv, hp.stride, hp.q_col, q0, N, qt);
    stage_t<T, kHd>(hp.dout, hp.D, hp.q_col, q0, N, dot);
    if (tid < kTile) {
      const bool valid = q0 + tid < N;
      row_stats[tid] = valid ? st[q0 + tid] : 0.f;
      row_stats[kTile + tid] = valid ? st[plane + q0 + tid] : 1.f;
      row_stats[2 * kTile + tid] = valid ? st[2 * plane + q0 + tid] : 0.f;
    }
    __syncthreads();
    float m[4], l[4], delta[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = row_stats[4 * tr + i];
      l[i] = row_stats[kTile + 4 * tr + i];
      delta[i] = row_stats[2 * kTile + 4 * tr + i];
    }
    grad_tile<T, kHd>(qt, dot, kt, vt, q0, k0, N, scale, m, l, delta, ps, dss);
    __syncthreads();
    // Thread (tr, tc) owns keys 4 tr + r and columns tc + 16 c.
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      float p[4], ds[4];
      load_vec<4>(ps + i * kTileStride + 4 * tr, p);
      load_vec<4>(dss + i * kTileStride + 4 * tr, ds);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float o = dot[(tc + 16 * c) * kTileStride + i];
        const float q = qt[(tc + 16 * c) * kTileStride + i];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          dv[r][c] = fmaf(p[r], o, dv[r][c]);
          dk[r][c] = fmaf(ds[r], q, dk[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + 4 * tr + r;
    if (key >= N) continue;
    T* row = dqkv + (static_cast<size_t>(b) * N + key) * hp.stride;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      row[hp.k_col + tc + 16 * c] = from_float<T>(dk[r][c] * scale);
      row[hp.v_col + tc + 16 * c] = from_float<T>(dv[r][c]);
    }
  }
}

// Part 3. grid (ceil(N / 64), H, B): the block's 64 queries' dQ.
template <typename T, int kHd>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                   const float* __restrict__ stats, T* __restrict__ dqkv, int B, int N, int H,
                   float scale) {
  constexpr int kCols = kHd / 16;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);
  float* dot = qt + kHd * kTileStride;
  float* kt = dot + kHd * kTileStride;
  float* vt = kt + kHd * kTileStride;
  float* dss = vt + kHd * kTileStride;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const Head<T> hp(qkv, dout, b, h, N, H, kHd);
  const size_t plane = static_cast<size_t>(B) * H * N;
  const float* st = stats + (static_cast<size_t>(b) * H + h) * N;
  stage_t<T, kHd>(hp.qkv, hp.stride, hp.q_col, q0, N, qt);
  stage_t<T, kHd>(hp.dout, hp.D, hp.q_col, q0, N, dot);
  float m[4], l[4], delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * tr + i;
    const bool valid = row < N;
    m[i] = valid ? st[row] : 0.f;
    l[i] = valid ? st[plane + row] : 1.f;
    delta[i] = valid ? st[2 * plane + row] : 0.f;
  }

  float dq[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[i][c] = 0.f;
  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();  // the previous key tile is consumed
    stage_t<T, kHd>(hp.qkv, hp.stride, hp.k_col, k0, N, kt);
    stage_t<T, kHd>(hp.qkv, hp.stride, hp.v_col, k0, N, vt);
    __syncthreads();
    grad_tile<T, kHd>(qt, dot, kt, vt, q0, k0, N, scale, m, l, delta, nullptr, dss);
    __syncthreads();
    // Thread (tr, tc) owns queries 4 tr + i and columns tc + 16 c.
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dss[(4 * tr + i) * kTileStride + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float k = kt[(tc + 16 * c) * kTileStride + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][c] = fmaf(ds[i], k, dq[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * tr + i;
    if (row >= N) continue;
    T* dst = dqkv + (static_cast<size_t>(b) * N + row) * hp.stride + hp.q_col;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dst[tc + 16 * c] = from_float<T>(dq[i][c] * scale);
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > smem_optin()) return cudaErrorInvalidConfiguration;
  return allow_smem(kernel, smem);
}

template <typename T, int kHd>
cudaError_t launch_backward(cudaStream_t stream, const void* qkv_v, const void* dout_v,
                            void* dqkv_v, float* stats, int B, int N, int H, float scale) {
  const T* qkv = static_cast<const T*>(qkv_v);
  const T* dout = static_cast<const T*>(dout_v);
  T* dqkv = static_cast<T*>(dqkv_v);
  const dim3 grid((N + kTile - 1) / kTile, H, B);
  constexpr size_t tile = bwd_tile_bytes<kHd>();
  const size_t smem_stats = 4 * tile;
  const size_t smem_dkdv = 4 * tile + 2 * kSquareBytes + sizeof(float) * 3 * kTile;
  const size_t smem_dq = 4 * tile + kSquareBytes;
  cudaError_t err = prepare(attn_bwd_stats_kernel<T, kHd>, smem_stats);
  if (err != cudaSuccess) return err;
  attn_bwd_stats_kernel<T, kHd><<<grid, kThreads, smem_stats, stream>>>(qkv, dout, stats, B, N, H,
                                                                        scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = prepare(attn_bwd_dkdv_kernel<T, kHd>, smem_dkdv)) != cudaSuccess) return err;
  attn_bwd_dkdv_kernel<T, kHd><<<grid, kThreads, smem_dkdv, stream>>>(qkv, dout, stats, dqkv, B, N,
                                                                      H, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = prepare(attn_bwd_dq_kernel<T, kHd>, smem_dq)) != cudaSuccess) return err;
  attn_bwd_dq_kernel<T, kHd><<<grid, kThreads, smem_dq, stream>>>(qkv, dout, stats, dqkv, B, N, H,
                                                                  scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(cudaStream_t stream, const void* qkv, const void* dout, void* dqkv,
                     float* stats, int B, int N, int H, int hd, float scale) {
  switch (hd) {
    case 32: return launch_backward<T, 32>(stream, qkv, dout, dqkv, stats, B, N, H, scale);
    case 64: return launch_backward<T, 64>(stream, qkv, dout, dqkv, stats, B, N, H, scale);
    case 128: return launch_backward<T, 128>(stream, qkv, dout, dqkv, stats, B, N, H, scale);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace vit

extern "C" {

const char* vit_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K8: qkv (B, N, 3 H hd) and dout (B, N, H hd), both f32 or both bf16
// (bf16 != 0) -> dqkv (B, N, 3 H hd) in the same dtype; stats is f32
// scratch of 3 B H N floats; hd in {32, 64, 128}. Three launches on
// `stream`, no synchronization; returns the first launch error.
int vit_attention_backward(const void* qkv, const void* dout, void* dqkv, void* stats, int B,
                           int N, int H, int hd, float scale, int bf16, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* s = static_cast<float*>(stats);
  return static_cast<int>(
      bf16 ? vit::backward<__nv_bfloat16>(st, qkv, dout, dqkv, s, B, N, H, hd, scale)
           : vit::backward<float>(st, qkv, dout, dqkv, s, B, N, H, hd, scale));
}

}  // extern "C"
