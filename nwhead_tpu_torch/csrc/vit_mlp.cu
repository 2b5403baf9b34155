// ViT MLP for Hopper (sm_90a) on the tensor cores: the fused MLP forward
// K9 and the MLP half-blocks K11 (bf16) and K11 int8, one kernel
// (mlp_tc_kernel) for the three.
//
// K9 replaces nwhead_tpu/ops/pallas_mlp.py:_mlp_kernel (forward):
//   out = gelu(x W1 + b1) W2 + b2, x (M, D_in), W1 (D_in, D_h), W2 (D_h,
//   D_out) in x's dtype (f32 or bf16), biases f32, h = x W1 + b1 summed in
//   f32, the exact GELU (erff) in f32, its output g rounded to x's dtype
//   before fc2, out = g W2 + b2 summed in f32 and rounded to x's dtype.
// What bounds it at ViT-S/14 serving (M = 64 x 257 = 16,448 tokens, D =
// 384, D_h = 1,536): 4 M D D_h = 38.8 GFLOP, 39 us at the 989 TFLOP/s bf16
// tensor-core rate and 235 us at 165 TFLOP/s in f32 (three TF32 passes at
// 495 TFLOP/s, the least time in which the card gives an f32-exact
// product); its bytes (x, out, the weights) take 8-15 us.
// mlp_tc_kernel: a block owns 64 tokens and up to 384 output columns; the
// fc2 accumulator (32 x 96 a warp, 96 registers a thread at D_out = 384)
// stays in registers while the block walks the hidden units in chunks of
// 128. Each chunk is fc1 over D_in in slices 128 bytes deep (an x slice and
// a W1 slice a step), then the bias, the GELU and the rounding to x's dtype
// into a 64 x 128 tile of g in shared memory, then fc2 over the chunk (a W2
// slice a step, g the left factor). Every slice goes through one
// three-stage cp.async ring, so later slices load while the tensor cores
// run; products are vit_mma.cuh's warp mma.sync: bf16 on m16n8k16
// (ldmatrix, ldmatrix.trans for the k-major weights), f32 on 3xTF32
// (m16n8k8, big and small halves split by truncation as each operand loads,
// g among them). The hidden activation never leaves the chip, as on the
// TPU. The weights stream from the L2 once for every 64 tokens (2.4 MB in
// bf16 at ViT-S/14, with x restaged for each chunk), about 0.8 TB at M =
// 16,448: that stream, not the tensor cores, sets the time (PERF.md), and
// 64 tokens is as many as the fc2 accumulators leave room for. A D_out
// above 384 (ViT-B 768, ViT-L 1,024) takes more column blocks, each
// recomputing fc1 (1.5x the products at ViT-B).
//
// K11 replaces pallas_mlp.py:_mlp_int8_kernel with quant=False (the launch
// of fused_mlp_block_bf16): K9's function in bf16 with an optional
// LayerNorm before fc1 (f32 statistics, output rounded to bf16) and an
// optional LayerScale (rounded to bf16) and residual add (rounded to bf16)
// after fc2's bias (rounded to bf16). It is K9's kernel with that tail
// compiled into its epilogue (kBlock; the residual reads the un-normalized
// x). cp.async copies bytes unchanged and cannot normalize x, so with the
// LayerNorm a prologue kernel (vit_block.cuh's block_prologue_kernel, one
// warp a row, shared with K10) first writes the normalized, rounded x to
// scratch, which the ring stages as K9 stages x: 2 x 2 M D_in bytes more,
// 25 MB at ViT-S/14 serving. A
// normalized tile kept in shared memory for the block's life instead would
// take 50 KB at D_in = 384 and 132 KB at 1,024 beside the ring's 167 KB,
// more than a block has from ViT-B's width on. With every fold off K11 is
// K9 bit for bit.
//
// K11 int8 replaces pallas_mlp.py:_mlp_int8_kernel with quant=True (the
// launch of fused_mlp_int8). The prologue writes x's codes, clip(rint(x *
// (1/a1)), -127, 127) of x or of its LayerNorm (row_stats_f64's statistics,
// rounded to bf16); then the same kernel runs on int8 operands, fc1 and fc2
// on mma.sync.m16n8k32 s8 with int32 sums, which are exact in any order, so
// the output equals the plain version's bit for bit. Each hidden chunk is
// dequantized, acc * (a1 * s1) + b1, put through the TPU kernel's GELU (erf
// by Abramowitz & Stegun) in f32 and requantized by 1/a2 into the chunk's
// 64 x 128 code tile; the end dequantizes, acc * (a2 * s2) + b2, rounds to
// bf16 and runs the bf16 tail. The weights stay (in, out), as the plain
// version and the TPU kernel take them: the s8 B fragment wants four
// consecutive k of a column in a register, which vit_mma.cuh's load_b_kn4
// makes by transposing 4 x 4 bytes in registers as it loads. Slices are 128
// k deep. Bound at M = 16,448: 38.8 G int8 operations over 1,979 TOP/s (20
// us); the weights' stream from the L2 is half of bf16's (1.2 MB for every
// 64 tokens).

#include "vit_block.cuh"

namespace vit {

constexpr int kHidden = 128;  // hidden units per chunk

// The tiles: 64 tokens a block, slices 128 bytes deep (32 f32, 64 bf16,
// 128 int8) through a three-stage ring_loop, an output block of 32 kNT
// columns. Warp w owns rows 32 (w % 2) .. + 31 (two m-tiles, so that each
// B fragment feeds two products): hidden units 32 (w / 2) .. + 31 of each
// chunk in fc1, output columns 8 kNT (w / 2) .. + 8 kNT - 1 of the block
// in fc2 (int8: in acc_col_s8's order within each 32).
constexpr int kK9Tm = 64;
constexpr int kK9Stages = 3;

template <typename T, int kNT>
struct K9Tiles {
  static constexpr int kDepth = 128 / static_cast<int>(sizeof(T));
  static constexpr int kWc = 32 * kNT;
  static constexpr int kSX = mlp_stride<T, kDepth, false>();   // x slice, 64 x depth
  static constexpr int kSW1 = mlp_stride<T, kHidden, true>();  // W1 slice, depth x 128
  static constexpr int kSW2 = mlp_stride<T, kWc, true>();      // W2 slice, depth x kWc
  static constexpr int kSG = mlp_stride<T, kHidden, false>();  // g, 64 x 128
  static constexpr int kFc1 = kK9Tm * kSX + kDepth * kSW1;
  static constexpr int kFc2 = kDepth * kSW2;
  static constexpr int kStage = kFc1 > kFc2 ? kFc1 : kFc2;
  static constexpr size_t kSmem = sizeof(T) * (kK9Stages * kStage + kK9Tm * kSG);
};

// The output's dtype: x's; bf16 for K11 int8's codes.
template <typename T>
using OutT = std::conditional_t<std::is_same_v<T, int8_t>, __nv_bfloat16, T>;

// K9 (T f32 or bf16), K11 (kBlock, T bf16) and K11 int8 (kBlock, T int8: x
// the codes, out bf16). grid (ceil(M / 64), ceil(d_out / (32 kNT))), 256
// threads. vec: bit 0 x, bit 1 W1, bit 2 W2 take 16-byte cp.async.
template <typename T, int kNT, bool kBlock>
__global__ void __launch_bounds__(kThreads, 1)
mlp_tc_kernel(const T* __restrict__ x, const T* __restrict__ w1, const float* __restrict__ b1,
              const T* __restrict__ w2, const float* __restrict__ b2, OutT<T>* __restrict__ out,
              int M, int d_in, int d_h, int d_out, int vec, Folds f) {
  constexpr bool kInt8 = std::is_same_v<T, int8_t>;
  static_assert(kBlock || !kInt8, "int8 runs the half-block");
  using Tl = K9Tiles<T, kNT>;
  using Acc = typename Frag<T>::Acc;
  constexpr int kDepth = Tl::kDepth;
  constexpr int kFc2Steps = kHidden / kDepth;
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);
  T* gs = ring + kK9Stages * Tl::kStage;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 32 * (warp & 1), wc = warp >> 1;
  const int m0 = blockIdx.x * kK9Tm, c0 = blockIdx.y * Tl::kWc;
  const int fc1_steps = (d_in + kDepth - 1) / kDepth;
  const int per_chunk = fc1_steps + kFc2Steps;
  const int total = (d_h + kHidden - 1) / kHidden * per_chunk;
  Acc acc[2][kNT][4] = {};
  Acc h[2][4][4];
  ring_loop<kK9Stages, Tl::kStage>(
      ring, total,
      [&](int s, T* buf) {
        const int h0 = s / per_chunk * kHidden, j = s % per_chunk;
        if (j < fc1_steps) {
          stage_tile<T, kK9Tm, kDepth, Tl::kSX, kThreads>(x, d_in, m0, j * kDepth, M, d_in,
                                                          vec & 1, buf);
          stage_tile<T, kDepth, kHidden, Tl::kSW1, kThreads>(w1, d_h, j * kDepth, h0, d_in, d_h,
                                                             vec & 2, buf + kK9Tm * Tl::kSX);
        } else {
          stage_tile<T, kDepth, Tl::kWc, Tl::kSW2, kThreads>(
              w2, d_out, h0 + (j - fc1_steps) * kDepth, c0, d_h, d_out, vec & 4, buf);
        }
      },
      [&](int s, const T* buf) {
        const int h0 = s / per_chunk * kHidden, j = s % per_chunk;
        if (j < fc1_steps) {
          if (j == 0) {
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int n = 0; n < 4; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) h[i][n][e] = 0;
          }
          warp_product<T, 2, 4, kDepth, Tl::kSX, Tl::kSW1, false, true>(
              buf, row0, 0, buf + kK9Tm * Tl::kSX, 32 * wc, h);
          if (j == fc1_steps - 1) {
            if constexpr (kInt8) {
              // The chunk's codes, read by fc2 after the next barrier:
              // thread (g, t) holds hidden units 8t .. 8t + 7 of the warp's
              // 32 (acc_col_s8), one 8-byte segment of a row; units past
              // d_h get code 0.
              float scale[8], bias[8];
#pragma unroll
              for (int u = 0; u < 8; ++u) {
                const int hid = h0 + 32 * wc + 8 * t + u;
                scale[u] = hid < d_h ? __fmul_rn(f.a1, f.s1[hid]) : 0.f;
                bias[u] = hid < d_h ? b1[hid] : 0.f;
              }
#pragma unroll
              for (int q = 0; q < 4; ++q) {  // m-tile q / 2, row g + 8 (q % 2)
                const int i = q >> 1, r = q & 1;
                int c[8];
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                  const float deq =
                      __fmul_rn(__int2float_rn(h[i][u & 3][2 * r + (u >> 2)]), scale[u]);
                  c[u] = h0 + 32 * wc + 8 * t + u < d_h
                             ? quantize_i8(gelu_as(__fadd_rn(deq, bias[u])), f.inv_a2)
                             : 0;
                }
                *reinterpret_cast<int2*>(gs + (row0 + 16 * i + g + 8 * r) * Tl::kSG + 32 * wc +
                                         8 * t) =
                    make_int2(pack4(c[0], c[1], c[2], c[3]), pack4(c[4], c[5], c[6], c[7]));
              }
            } else {
              // g = round(gelu(h + b1)) into the chunk's tile (read by fc2
              // after the next barrier); hidden units past d_h read b1 = 0
              // (their W1 columns are 0), so their g is 0.
#pragma unroll
              for (int n = 0; n < 4; ++n) {
                const int col = 32 * wc + 8 * n + 2 * t;
                const int hid = h0 + col;
                const float bias0 = hid < d_h ? b1[hid] : 0.f;
                const float bias1 = hid + 1 < d_h ? b1[hid + 1] : 0.f;
#pragma unroll
                for (int q = 0; q < 4; ++q) {  // m-tile q / 2, row g + 8 (q % 2)
                  const int i = q >> 1, r = q & 1;
                  store2(gs + (row0 + 16 * i + g + 8 * r) * Tl::kSG + col,
                         gelu_exact(h[i][n][2 * r] + bias0),
                         gelu_exact(h[i][n][2 * r + 1] + bias1));
                }
              }
            }
          }
        } else if (h0 + (j - fc1_steps) * kDepth < d_h) {
          warp_product<T, 2, kNT, kDepth, Tl::kSG, Tl::kSW2, false, true>(
              gs, row0, (j - fc1_steps) * kDepth, buf, 8 * kNT * wc, acc);
        }
      });

  // Bias (int8: dequantized first), the half-block's tail, the store.
  store_tile<kBlock>(acc, m0 + row0, c0 + 8 * kNT * wc, M, d_out, b2, f, out);
}

template <typename T, int kNT, bool kBlock>
cudaError_t launch_mlp_tc(cudaStream_t stream, const T* x, const T* w1, const float* b1,
                          const T* w2, const float* b2, OutT<T>* out, int M, int d_in, int d_h,
                          int d_out, const Folds& f) {
  using Tl = K9Tiles<T, kNT>;
  if (Tl::kSmem > smem_optin()) return cudaErrorInvalidConfiguration;
  const cudaError_t err = allow_smem(mlp_tc_kernel<T, kNT, kBlock>, Tl::kSmem);
  if (err != cudaSuccess) return err;
  const int vec = vec16_ok<T>(x, d_in) | vec16_ok<T>(w1, d_h) << 1 | vec16_ok<T>(w2, d_out) << 2;
  const dim3 grid((M + kK9Tm - 1) / kK9Tm, (d_out + Tl::kWc - 1) / Tl::kWc);
  mlp_tc_kernel<T, kNT, kBlock><<<grid, kThreads, Tl::kSmem, stream>>>(
      x, w1, b1, w2, b2, out, M, d_in, d_h, d_out, vec, f);
  return cudaGetLastError();
}

// The output block for a width: 128, 256 or 384 columns (above 384, more
// column blocks of 384).
template <typename T, bool kBlock>
cudaError_t mlp_tc(cudaStream_t stream, const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* out, int M, int d_in, int d_h, int d_out,
                   const Folds& f) {
#define VIT_MLP_TC(NT)                                                                          \
  launch_mlp_tc<T, NT, kBlock>(stream, static_cast<const T*>(x), static_cast<const T*>(w1),    \
                               static_cast<const float*>(b1), static_cast<const T*>(w2),        \
                               static_cast<const float*>(b2), static_cast<OutT<T>*>(out), M,    \
                               d_in, d_h, d_out, f)
  if (d_out <= 128) return VIT_MLP_TC(4);
  if (d_out <= 256) return VIT_MLP_TC(8);
  return VIT_MLP_TC(12);
#undef VIT_MLP_TC
}

}  // namespace vit

extern "C" {

const char* vit_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K9: x (M, d_in), w1 (d_in, d_h), w2 (d_h, d_out) and out (M, d_out) in f32
// or bf16 (bf16 != 0); b1, b2 f32. Launches on `stream`, does not
// synchronize, returns cudaGetLastError().
int vit_mlp_forward(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                    void* out, int M, int d_in, int d_h, int d_out, int bf16, void* stream) {
  if (M <= 0 || d_in <= 0 || d_h <= 0 || d_out <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const vit::Folds none{};
  return static_cast<int>(
      bf16 ? vit::mlp_tc<__nv_bfloat16, false>(st, x, w1, b1, w2, b2, out, M, d_in, d_h, d_out,
                                               none)
           : vit::mlp_tc<float, false>(st, x, w1, b1, w2, b2, out, M, d_in, d_h, d_out, none));
}

// K11 (bf16, any of the folds): x (M, d_in), w1 (d_in, d_h), w2 (d_h,
// d_out), out (M, d_out) and ls (d_out,) bf16; b1, b2, ln_g, ln_b f32; xn
// (M, d_in) bf16 scratch for the normalized x, needed with ln_g. Launches
// the prologue (with ln_g) and the kernel on `stream`, does not
// synchronize, returns the first error.
int vit_mlp_block_forward(const void* x, const void* ln_g, const void* ln_b, float eps,
                          const void* w1, const void* b1, const void* w2, const void* b2,
                          const void* ls, int residual, void* xn, void* out, int M, int d_in,
                          int d_h, int d_out, void* stream) {
  if (M <= 0 || d_in <= 0 || d_h <= 0 || d_out <= 0 || (residual && d_in != d_out) ||
      (ln_g == nullptr) != (ln_b == nullptr) || (ln_g != nullptr && xn == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ln_g != nullptr) {
    const cudaError_t err = vit::prologue<false>(st, x, ln_g, ln_b, eps, 0.f, xn, M, d_in);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  vit::Folds f{};
  f.res = residual ? static_cast<const __nv_bfloat16*>(x) : nullptr;
  f.ls = static_cast<const __nv_bfloat16*>(ls);
  return static_cast<int>(vit::mlp_tc<__nv_bfloat16, true>(
      st, ln_g != nullptr ? xn : x, w1, b1, w2, b2, out, M, d_in, d_h, d_out, f));
}

// K11 int8: x (M, d_in) bf16, d_in a multiple of 4; w1 (d_in, d_h) and w2
// (d_h, d_out) int8 with per-column scales s1 (d_h,), s2 (d_out,) f32; b1,
// b2, ln_g, ln_b f32; inv_a* and a* the activation scales' reciprocals and
// the scales; ls (d_out,) bf16 or null; codes (M, d_in) int8 scratch for
// x's codes; out (M, d_out) bf16. Launches the prologue and the kernel on
// `stream`, does not synchronize, returns the first error.
int vit_mlp_int8_forward(const void* x, const void* ln_g, const void* ln_b, float eps,
                         const void* w1, const void* s1, const void* b1, float inv_a1, float a1,
                         const void* w2, const void* s2, const void* b2, float inv_a2, float a2,
                         const void* ls, int residual, void* codes, void* out, int M, int d_in,
                         int d_h, int d_out, void* stream) {
  if (M <= 0 || d_in <= 0 || d_h <= 0 || d_out <= 0 || d_in % 4 != 0 ||
      (residual && d_in != d_out) || (ln_g == nullptr) != (ln_b == nullptr) ||
      codes == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = vit::prologue<true>(st, x, ln_g, ln_b, eps, inv_a1, codes, M, d_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const vit::Folds f{residual ? static_cast<const __nv_bfloat16*>(x) : nullptr,
                     static_cast<const __nv_bfloat16*>(ls), static_cast<const float*>(s1),
                     static_cast<const float*>(s2), a1, inv_a2, a2};
  return static_cast<int>(
      vit::mlp_tc<int8_t, true>(st, codes, w1, b1, w2, b2, out, M, d_in, d_h, d_out, f));
}

}  // extern "C"
