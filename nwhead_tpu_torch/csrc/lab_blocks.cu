// ResNet BasicBlocks with folded BatchNorm as one inference kernel, for
// Hopper (sm_90a): L2 fused_blocks.
//
// Replaces the TPU kernel scripts/block_lab.py:_block_pair_kernel. It runs
// n_blocks BasicBlocks (ResNet-18's layer1 is two, at 56 x 56 x 64) on NHWC
// bf16 activations: per block
//   h   = bf16(relu(conv3x3(x, w1) + b1))
//   out = bf16(relu(conv3x3(h, w2) + b2 + x))
// each conv 3x3 with zero padding 1, bf16 weights with the eval-mode BN
// folded in, products summed in f32 plus an f32 bias; h and the block's
// output are rounded to bf16 as the lab's buf_ref holds them.
//
// What bounds it: operations. At B = 64 the four convs are 59.2 GFLOP, 60 us
// at the 989 TFLOP/s of bf16 tensor cores; the bytes (the input and output,
// 51 MB) take 15 us. This first version runs FFMA on widened bf16 (67
// TFLOP/s), so the FLOPs set its time; mma.sync / wgmma come later.
//
// The design differs from the TPU's, which keeps a whole image resident in
// VMEM in a 64 x 64 zero-halo layout: one image's 56 x 56 x 64 bf16
// activation is 401 KB, above the 227 KB a block may hold. So each block
// takes one image's 8 x 8 output tile and recomputes its halo: it loads the
// (8 + 4 n_blocks)^2 input region (zeros outside the image), and each conv
// shrinks the region by one pixel a side, so the last conv gives the 8 x 8
// tile. The intermediates stay in shared memory in bf16, zeroed outside the
// image at every conv (the next conv's padding), in three buffers that
// rotate (block input, h, block output = next input); the residual is read
// from the block input's buffer. One conv's folded weights (9 x 64 x 64 bf16
// = 72 KB) are streamed into shared memory at a time. A thread computes 4
// output pixels x 8 output channels: per tap and 8 input channels it reads
// 4 x 16 bytes of activations and 8 x 16 bytes of weights and does 256 FMAs.
// At n_blocks = 2 the halo makes 504 conv pixels per 64 outputs (1.97x the
// work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace lab {

constexpr int kBlockThreads = 256;
constexpr int kTile = 8;  // output pixels a side of a block's tile

using bf = __nv_bfloat16;

__device__ __forceinline__ void widen8(const uint4& u, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 narrow8(const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return u;
}

inline size_t blocks_smem_bytes(int C, int n_blocks) {
  const size_t side = kTile + 4 * n_blocks;
  return static_cast<size_t>(9) * C * C * sizeof(bf)  // one conv's weights
         + C * sizeof(float)                          // its bias
         + 3 * side * side * C * sizeof(bf);          // the rotating activations
}

template <int kC>
__device__ __forceinline__ void load_conv(const bf* __restrict__ w, const float* __restrict__ b,
                                          bf* __restrict__ w_s, float* __restrict__ b_s) {
  const uint4* src = reinterpret_cast<const uint4*>(w);
  uint4* dst = reinterpret_cast<uint4*>(w_s);
  for (int i = threadIdx.x; i < 9 * kC * kC / 8; i += kBlockThreads) dst[i] = src[i];
  for (int i = threadIdx.x; i < kC; i += kBlockThreads) b_s[i] = b[i];
}

// One 3x3 conv over a square region: src has side Ls, its pixel (0, 0) at
// image (gy, gx); the output has side Ls - 2, its pixel (0, 0) at image
// (gy + 1, gx + 1). Epilogue: + bias (+ resid, a region of side Lr whose
// pixel (py + 2, px + 2) is output pixel (py, px)), ReLU, 0 outside the
// image, rounded to bf16 into dst (shared) or, with out_g, the pixels
// inside the image into the global output of image img.
template <int kC>
__device__ __forceinline__ void conv3x3(const bf* __restrict__ src, int Ls, int gy, int gx,
                                        int H, int W, const bf* __restrict__ w_s,
                                        const float* __restrict__ b_s,
                                        const bf* __restrict__ resid, int Lr,
                                        bf* __restrict__ dst, bf* __restrict__ out_g, int img) {
  constexpr int kGroups = kC / 8;  // output-channel groups of 8
  const int Ld = Ls - 2;
  const int n_pix = Ld * Ld;
  const int n_items = (n_pix + 3) / 4 * kGroups;
  for (int item = threadIdx.x; item < n_items; item += kBlockThreads) {
    const int cg = item % kGroups;
    const int pg = item / kGroups;
    int sp[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = min(pg * 4 + u, n_pix - 1);
      sp[u] = (p / Ld) * Ls + p % Ld;  // the window's top-left pixel in src
    }
    float acc[4][8];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int o = 0; o < 8; ++o) acc[u][o] = 0.f;
    }
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * Ls + tap % 3;
      const bf* wt = w_s + tap * kC * kC + cg * 8;
#pragma unroll 2
      for (int ci0 = 0; ci0 < kC; ci0 += 8) {
        float xv[4][8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          widen8(*reinterpret_cast<const uint4*>(src + (sp[u] + off) * kC + ci0), xv[u]);
        }
#pragma unroll
        for (int ci = 0; ci < 8; ++ci) {
          float wv[8];
          widen8(*reinterpret_cast<const uint4*>(wt + (ci0 + ci) * kC), wv);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int o = 0; o < 8; ++o) acc[u][o] = fmaf(xv[u][ci], wv[o], acc[u][o]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = pg * 4 + u;
      if (p >= n_pix) break;
      const int py = p / Ld, px = p % Ld;
      const int y = gy + 1 + py, x = gx + 1 + px;
      const bool inside = y >= 0 && y < H && x >= 0 && x < W;
      float r[8];
      if (resid != nullptr) {
        widen8(*reinterpret_cast<const uint4*>(resid + ((py + 2) * Lr + px + 2) * kC + cg * 8), r);
      }
      float v[8];
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        float t = acc[u][o] + b_s[cg * 8 + o];
        if (resid != nullptr) t += r[o];
        v[o] = inside ? fmaxf(t, 0.f) : 0.f;
      }
      const uint4 packed = narrow8(v);
      if (out_g != nullptr) {
        if (inside) {
          *reinterpret_cast<uint4*>(
              out_g + ((static_cast<size_t>(img) * H + y) * W + x) * kC + cg * 8) = packed;
        }
      } else {
        *reinterpret_cast<uint4*>(dst + p * kC + cg * 8) = packed;
      }
    }
  }
}

// Block = one image's 8 x 8 output tile: blockIdx.x = img * tiles_per_img +
// ty * tiles_x + tx.
template <int kC>
__global__ void __launch_bounds__(kBlockThreads, 1)
fused_blocks_kernel(const bf* __restrict__ x, const bf* __restrict__ w,
                    const float* __restrict__ bias, bf* __restrict__ out, int H, int W,
                    int n_blocks, int tiles_x, int tiles_per_img) {
  extern __shared__ uint4 smem16[];
  bf* w_s = reinterpret_cast<bf*>(smem16);
  float* b_s = reinterpret_cast<float*>(w_s + 9 * kC * kC);
  const int L0 = kTile + 4 * n_blocks;
  bf* buf[3];
  buf[0] = reinterpret_cast<bf*>(b_s + kC);
  buf[1] = buf[0] + L0 * L0 * kC;
  buf[2] = buf[1] + L0 * L0 * kC;

  const int img = blockIdx.x / tiles_per_img;
  const int tile = blockIdx.x % tiles_per_img;
  int gy = (tile / tiles_x) * kTile - 2 * n_blocks;
  int gx = (tile % tiles_x) * kTile - 2 * n_blocks;

  constexpr int kGroups = kC / 8;
  const uint4* x16 = reinterpret_cast<const uint4*>(x);
  uint4* in16 = reinterpret_cast<uint4*>(buf[0]);
  for (int i = threadIdx.x; i < L0 * L0 * kGroups; i += kBlockThreads) {
    const int p = i / kGroups, g = i % kGroups;
    const int y = gy + p / L0, xx = gx + p % L0;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (y >= 0 && y < H && xx >= 0 && xx < W) {
      v = x16[((static_cast<size_t>(img) * H + y) * W + xx) * kGroups + g];
    }
    in16[i] = v;
  }

  int in = 0, L = L0;
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int h = (in + 1) % 3, o = (in + 2) % 3;
    __syncthreads();  // the last conv is done with the weights
    load_conv<kC>(w + static_cast<size_t>(2 * blk) * 9 * kC * kC, bias + 2 * blk * kC, w_s, b_s);
    __syncthreads();
    conv3x3<kC>(buf[in], L, gy, gx, H, W, w_s, b_s, nullptr, 0, buf[h], nullptr, img);
    __syncthreads();
    load_conv<kC>(w + static_cast<size_t>(2 * blk + 1) * 9 * kC * kC, bias + (2 * blk + 1) * kC,
                  w_s, b_s);
    __syncthreads();
    const bool last = blk == n_blocks - 1;
    conv3x3<kC>(buf[h], L - 2, gy + 1, gx + 1, H, W, w_s, b_s, buf[in], L, buf[o],
                last ? out : nullptr, img);
    in = o;
    L -= 4;
    gy += 2;
    gx += 2;
  }
}

template <int kC>
cudaError_t launch_blocks(cudaStream_t stream, const void* x, const void* w, const void* bias,
                          void* out, int B, int H, int W, int n_blocks) {
  const int tiles_x = (W + kTile - 1) / kTile;
  const int tiles_per_img = tiles_x * ((H + kTile - 1) / kTile);
  const size_t smem = blocks_smem_bytes(kC, n_blocks);
  cudaError_t err = cudaFuncSetAttribute(fused_blocks_kernel<kC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_blocks_kernel<kC><<<B * tiles_per_img, kBlockThreads, smem, stream>>>(
      static_cast<const bf*>(x), static_cast<const bf*>(w), static_cast<const float*>(bias),
      static_cast<bf*>(out), H, W, n_blocks, tiles_x, tiles_per_img);
  return cudaGetLastError();
}

}  // namespace lab

extern "C" {

const char* lab_blocks_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, H, W, C) bf16 NHWC; w (2 n_blocks, 9, C, C) bf16, conv i's tap
// t = 3 dy + dx as (C_in, C_out); bias (2 n_blocks, C) f32; out (B, H, W,
// C) bf16. C is 8, 16, 32 or 64; all pointers 16-byte aligned. Launches on
// `stream`, does not synchronize, returns cudaGetLastError().
int lab_fused_blocks(const void* x, const void* w, const void* bias, void* out, int B, int H,
                     int W, int C, int n_blocks, void* stream) {
  if (x == nullptr || w == nullptr || bias == nullptr || out == nullptr || B <= 0 || H <= 0 ||
      W <= 0 || n_blocks <= 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (lab::blocks_smem_bytes(C, n_blocks) > static_cast<size_t>(optin)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8:
      return static_cast<int>(lab::launch_blocks<8>(st, x, w, bias, out, B, H, W, n_blocks));
    case 16:
      return static_cast<int>(lab::launch_blocks<16>(st, x, w, bias, out, B, H, W, n_blocks));
    case 32:
      return static_cast<int>(lab::launch_blocks<32>(st, x, w, bias, out, B, H, W, n_blocks));
    case 64:
      return static_cast<int>(lab::launch_blocks<64>(st, x, w, bias, out, B, H, W, n_blocks));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
