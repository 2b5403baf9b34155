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
// sees more than a 64 x 32 tile, and the three parts of the VJP are three
// launches over grids of (64-row tile, head, batch row), so any N runs:
//   1. stats: 64 queries a block sweep the keys once, 32 at a time, for
//      each row's max m, sum l and delta = sum_j P_ij dP_ij (all three
//      online: the running sums are rescaled as m grows); they write (lse,
//      delta) to a (2, B, H, N) f32 scratch tensor, lse = m + log(l) in base
//      2 (vit_mma.cuh: P = exp2(s log2(e) - lse), no division). delta is the
//      single pass's rowsum(dP * P) up to the order and rounding of the f32
//      sums;
//   2. dK, dV: a block owns 64 keys and loops over the queries, 32 at a
//      time. Each warp computes its 16 keys' S^T = K Q^T and dP^T = V dO^T,
//      turns them in registers into P^T and dS^T from the queries' (lse,
//      delta), and feeds those accumulators straight in, rounded to the
//      input dtype, as the left factors of dV += round(P)^T dO and
//      dK += dS^T Q;
//   3. dQ: a block owns 64 queries and loops over the keys, 32 at a time:
//      S, dP and dS in registers, dQ += dS K.
// Every product is a warp's mma.sync (vit_mma.cuh: bf16 on m16n8k16, f32 on
// 3xTF32), its tiles staged with cp.async into a two-stage ring (the
// queries' statistics ride along in part 2). 32-row steps keep part 2's
// four 16 x 32 tiles and its dK and dV sums in registers at three blocks an
// SM. Each output element has one owner block and every sum runs in a fixed
// order (no atomics), so a run repeats bit for bit. Tiles and products
// past N are skipped as in K7.
// What bounds it at ViT-S/14 (B = 64, N = 257, H = 6, hd = 64): the bytes
// (qkv, dO, dqkv), 88 MB in bf16 over 3.35 TB/s, 26 us, above the five
// products of the VJP, 10 B H N^2 hd = 16.2 GFLOP at 989 TFLOP/s (16 us).
// The three launches issue 18 B H N^2 hd (the scores three times, dP
// three times) through mma.sync and restage K, V, Q and dO from the L2 for
// every tile; f32 issues each product three times on TF32 (495 TFLOP/s).
// PERF.md holds the times; wgmma and TMA are the next step.

#include "vit_mma.cuh"

namespace vit {

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

// Keys a step of parts 1 and 3, and queries a step of part 2, stage: 32
// keeps each warp's score, dP and gradient tiles in registers at three or
// four blocks an SM (bf16, hd = 64), where 64 left part 2 two.
constexpr int kBwdChunk = 32;

template <typename T, int kHd>
constexpr size_t stats_smem_bytes() {  // Q, dO; K and V, two stages each (also part 3's)
  return sizeof(T) * (2 * tile_elems<T, kHd>(kAttnTile) + 4 * tile_elems<T, kHd>(kBwdChunk));
}

template <typename T, int kHd>
constexpr size_t dkdv_smem_bytes() {  // K, V; Q and dO, two stages; lse, delta, two stages
  constexpr int kQT = kBwdChunk;
  return sizeof(T) * (2 * tile_elems<T, kHd>(kAttnTile) + 4 * tile_elems<T, kHd>(kQT)) +
         sizeof(float) * 2 * 2 * kQT;
}

// Part 1. grid (ceil(N / 64), H, B), 128 threads. stats (2, B, H, N): lse, delta.
// One sweep over the keys keeps each row's running max m2, its sum l of
// exp2(s - m2) and the sum dl of exp2(s - m2) dP, both rescaled as m2
// grows; delta = dl / l, sum_j P_ij dP_ij with P in f32.
template <typename T, int kHd>
__global__ void __launch_bounds__(kAttnThreads)
attn_bwd_stats_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                      float* __restrict__ stats, int B, int N, int H, float scale) {
  constexpr int kKeys = kBwdChunk;
  constexpr int kNT = kKeys / 8;
  constexpr int kKElems = tile_elems<T, kHd>(kKeys);
  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);
  T* dos = qs + tile_elems<T, kHd>(kAttnTile);
  T* ks = dos + tile_elems<T, kHd>(kAttnTile);  // two stages of (K, V)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kAttnTile, h = blockIdx.y, b = blockIdx.z;
  const Head<T> hp(qkv, dout, b, h, N, H, kHd);
  const long long stride = static_cast<long long>(hp.stride);
  const int steps = (N + kKeys - 1) / kKeys;
  auto load = [&](int step) {
    T* dst = ks + (step & 1) * 2 * kKElems;
    stage_rows<T, kHd, kKeys>(hp.qkv + hp.k_col, stride, step * kKeys, N, dst);
    stage_rows<T, kHd, kKeys>(hp.qkv + hp.v_col, stride, step * kKeys, N, dst + kKElems);
  };
  stage_rows<T, kHd, kAttnTile>(hp.qkv + hp.q_col, stride, q0, N, qs);
  stage_rows<T, kHd, kAttnTile>(hp.dout + hp.q_col, hp.D, q0, N, dos);
  load(0);
  cp_async_commit();

  const int row0 = 16 * warp;
  const bool active = q0 + row0 < N;
  const float scale2 = scale * kLog2e;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      load(step + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int n_valid = N - step * kKeys;
    if (active) {
      const T* kt = ks + (step & 1) * 2 * kKElems;
      float s[kNT][4], dp[kNT][4];
      tile_abt<T, kHd>(qs, row0, kt, n_valid, s);
      tile_abt<T, kHd>(dos, row0, kt + kKElems, n_valid, dp);
      scale_and_mask(s, scale2, n_valid);
      online_max_sum(s, m, l, dp, dl);
    }
    __syncthreads();
  }
  if (!active) return;
  const size_t plane = static_cast<size_t>(B) * H * N;
  float* st = stats + (static_cast<size_t>(b) * H + h) * N;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + g + 8 * r;
    if (t == 0 && row < N) {
      st[row] = lse2(m[r], l[r]);
      st[plane + row] = dl[r] / fmaxf(l[r], 1e-30f);
    }
  }
}

// Part 2. grid (ceil(N / 64), H, B), 128 threads: the block's 64 keys' dK
// and dV.
template <typename T, int kHd>
__global__ void __launch_bounds__(kAttnThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                     const float* __restrict__ stats, T* __restrict__ dqkv, int B, int N, int H,
                     float scale) {
  constexpr int kQT = kBwdChunk;
  constexpr int kNT = kQT / 8;
  constexpr int kKeyElems = tile_elems<T, kHd>(kAttnTile);
  constexpr int kQElems = tile_elems<T, kHd>(kQT);
  extern __shared__ float4 smem4[];
  T* kts = reinterpret_cast<T*>(smem4);
  T* vts = kts + kKeyElems;
  T* qs = vts + kKeyElems;                                  // two stages of (Q, dO)
  float* sts = reinterpret_cast<float*>(qs + 4 * kQElems);  // two stages of (lse, delta)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * kAttnTile, h = blockIdx.y, b = blockIdx.z;
  const Head<T> hp(qkv, dout, b, h, N, H, kHd);
  const long long stride = static_cast<long long>(hp.stride);
  const size_t plane = static_cast<size_t>(B) * H * N;
  const float* st = stats + (static_cast<size_t>(b) * H + h) * N;
  const int steps = (N + kQT - 1) / kQT;
  auto load = [&](int step) {
    const int q0 = step * kQT;
    T* dst = qs + (step & 1) * 2 * kQElems;
    stage_rows<T, kHd, kQT>(hp.qkv + hp.q_col, stride, q0, N, dst);
    stage_rows<T, kHd, kQT>(hp.dout + hp.q_col, hp.D, q0, N, dst + kQElems);
    float* sd = sts + (step & 1) * 2 * kQT;
    for (int i = threadIdx.x; i < 2 * kQT; i += kAttnThreads) {
      const int part = i / kQT, q = q0 + i % kQT;
      const bool valid = q < N;
      cp_async4(sd + i, st + part * plane + (valid ? q : 0), valid);
    }
  };
  stage_rows<T, kHd, kAttnTile>(hp.qkv + hp.k_col, stride, k0, N, kts);
  stage_rows<T, kHd, kAttnTile>(hp.qkv + hp.v_col, stride, k0, N, vts);
  load(0);
  cp_async_commit();

  const int row0 = 16 * warp;
  const bool active = k0 + row0 < N;
  const int g = lane >> 2, t = lane & 3;
  const float scale2 = scale * kLog2e;
  const bool key_ok[2] = {k0 + row0 + g < N, k0 + row0 + g + 8 < N};
  float dk[kHd / 8][4] = {}, dv[kHd / 8][4] = {};
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      load(step + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int n_valid = N - step * kQT;
    if (active) {
      const T* qt = qs + (step & 1) * 2 * kQElems;
      const T* dot = qt + kQElems;
      const float* sd = sts + (step & 1) * 2 * kQT;
      float s[kNT][4], dp[kNT][4];
      tile_abt<T, kHd>(kts, row0, qt, n_valid, s);    // S^T: keys x queries
      tile_abt<T, kHd>(vts, row0, dot, n_valid, dp);  // dP^T
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = acc_col(j, e);
          const bool valid = qi < n_valid && key_ok[e >> 1];
          const float p = valid ? exp2_prob(s[j][e], scale2, sd[qi]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - sd[kQT + qi]);  // dS
        }
      acc_pb<T, kHd>(s, dot, n_valid, dv);  // dV += round(P)^T dO
      acc_pb<T, kHd>(dp, qt, n_valid, dk);  // dK += round(dS)^T Q
    }
    __syncthreads();
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + row0 + g + 8 * r;
    if (key >= N) continue;
    T* row = dqkv + (static_cast<size_t>(b) * N + key) * hp.stride + 2 * t;
#pragma unroll
    for (int n = 0; n < kHd / 8; ++n) {
      store2(row + hp.k_col + 8 * n, dk[n][2 * r] * scale, dk[n][2 * r + 1] * scale);
      store2(row + hp.v_col + 8 * n, dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// Part 3. grid (ceil(N / 64), H, B), 128 threads: the block's 64 queries' dQ.
template <typename T, int kHd>
__global__ void __launch_bounds__(kAttnThreads)
attn_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                   const float* __restrict__ stats, T* __restrict__ dqkv, int B, int N, int H,
                   float scale) {
  constexpr int kKeys = kBwdChunk;
  constexpr int kNT = kKeys / 8;
  constexpr int kKElems = tile_elems<T, kHd>(kKeys);
  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);
  T* dos = qs + tile_elems<T, kHd>(kAttnTile);
  T* ks = dos + tile_elems<T, kHd>(kAttnTile);  // two stages of (K, V)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kAttnTile, h = blockIdx.y, b = blockIdx.z;
  const Head<T> hp(qkv, dout, b, h, N, H, kHd);
  const long long stride = static_cast<long long>(hp.stride);
  const int steps = (N + kKeys - 1) / kKeys;
  auto load = [&](int step) {
    T* dst = ks + (step & 1) * 2 * kKElems;
    stage_rows<T, kHd, kKeys>(hp.qkv + hp.k_col, stride, step * kKeys, N, dst);
    stage_rows<T, kHd, kKeys>(hp.qkv + hp.v_col, stride, step * kKeys, N, dst + kKElems);
  };
  stage_rows<T, kHd, kAttnTile>(hp.qkv + hp.q_col, stride, q0, N, qs);
  stage_rows<T, kHd, kAttnTile>(hp.dout + hp.q_col, hp.D, q0, N, dos);
  load(0);
  cp_async_commit();

  const int row0 = 16 * warp;
  const bool active = q0 + row0 < N;
  const int g = lane >> 2, t = lane & 3;
  const size_t plane = static_cast<size_t>(B) * H * N;
  const float* st = stats + (static_cast<size_t>(b) * H + h) * N;
  const float scale2 = scale * kLog2e;
  float lse[2], delta[2];
  bool row_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + g + 8 * r;
    row_ok[r] = row < N;
    lse[r] = row_ok[r] ? st[row] : 0.f;
    delta[r] = row_ok[r] ? st[plane + row] : 0.f;
  }
  float dq[kHd / 8][4] = {};
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      load(step + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int n_valid = N - step * kKeys;
    if (active) {
      const T* kt = ks + (step & 1) * 2 * kKElems;
      float s[kNT][4], dp[kNT][4];
      tile_abt<T, kHd>(qs, row0, kt, n_valid, s);
      tile_abt<T, kHd>(dos, row0, kt + kKElems, n_valid, dp);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool valid = row_ok[r] && acc_col(j, e) < n_valid;
          const float p = valid ? exp2_prob(s[j][e], scale2, lse[r]) : 0.f;
          s[j][e] = p * (dp[j][e] - delta[r]);  // dS
        }
      acc_pb<T, kHd>(s, kt, n_valid, dq);  // dQ += round(dS) K
    }
    __syncthreads();
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!row_ok[r]) continue;
    T* dst = dqkv + (static_cast<size_t>(b) * N + q0 + row0 + g + 8 * r) * hp.stride + hp.q_col +
             2 * t;
#pragma unroll
    for (int n = 0; n < kHd / 8; ++n) {
      store2(dst + 8 * n, dq[n][2 * r] * scale, dq[n][2 * r + 1] * scale);
    }
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
  const dim3 grid((N + kAttnTile - 1) / kAttnTile, H, B);
  constexpr size_t smem_stats = stats_smem_bytes<T, kHd>();
  constexpr size_t smem_dkdv = dkdv_smem_bytes<T, kHd>();
  constexpr size_t smem_dq = stats_smem_bytes<T, kHd>();
  cudaError_t err = prepare(attn_bwd_stats_kernel<T, kHd>, smem_stats);
  if (err != cudaSuccess) return err;
  attn_bwd_stats_kernel<T, kHd><<<grid, kAttnThreads, smem_stats, stream>>>(qkv, dout, stats, B,
                                                                            N, H, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = prepare(attn_bwd_dkdv_kernel<T, kHd>, smem_dkdv)) != cudaSuccess) return err;
  attn_bwd_dkdv_kernel<T, kHd><<<grid, kAttnThreads, smem_dkdv, stream>>>(qkv, dout, stats, dqkv,
                                                                          B, N, H, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = prepare(attn_bwd_dq_kernel<T, kHd>, smem_dq)) != cudaSuccess) return err;
  attn_bwd_dq_kernel<T, kHd><<<grid, kAttnThreads, smem_dq, stream>>>(qkv, dout, stats, dqkv, B,
                                                                      N, H, scale);
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
// scratch of 2 B H N floats; hd in {32, 64, 128}; qkv, dout and dqkv
// 16-byte aligned. Three launches on `stream`, no synchronization; returns
// the first launch error.
int vit_attention_backward(const void* qkv, const void* dout, void* dqkv, void* stats, int B,
                           int N, int H, int hd, float scale, int bf16, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(dqkv)) % 16) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* s = static_cast<float*>(stats);
  return static_cast<int>(
      bf16 ? vit::backward<__nv_bfloat16>(st, qkv, dout, dqkv, s, B, N, H, hd, scale)
           : vit::backward<float>(st, qkv, dout, dqkv, s, B, N, H, hd, scale));
}

}  // extern "C"
