// Streaming read of an f32 bank, the HBM yardstick, for Hopper (sm_90a).
//
// Replaces the TPU kernels bench.py:_stream_case `stream` (K13), the same
// body at scripts/prepared_lab.py, scripts/roofline_lab.py and
// scripts/bigbank_lab.py (L4), and scripts/kernel_lab.py:stream_reduce (L1).
// Over an (rows, D) f32 bank cut into tiles of block_s rows (rows past the
// last whole tile are not read), it computes:
//   touch_only: out (8, D)  = sum over tiles t of rows 0..7 of tile t;
//   otherwise:  out (1, D)  = sum of every row of every tile.
// K13 and L4 are touch_only at block_s = 2048.
//
// What bounds it: the bytes. Its job is the read rate, so it reads every
// byte of every tile in both modes, as the TPU's DMA copies the whole tile
// into VMEM even when the kernel adds only 8 of its rows. A version that
// loaded rows 0..7 alone would read 1/256 of the bank. So each block copies
// its rows into shared memory with cp.async (16 bytes a thread, cg: L2
// only), an asm volatile the compiler cannot drop, whether or not the rows
// are added afterwards. A 2048 x 512 f32 tile is 4 MB, far more than a
// block's shared memory, so a tile's copy is spread over many blocks:
//   * Pass 1: block p streams chunks_per_block chunks of chunk_rows rows
//     (16 KB at D = 512) of one tile through a two-stage ring (the copy of
//     the next chunk is in flight while this one is summed). touch_only:
//     the tile's first block writes rows 0..7 of its first chunk to
//     partial[t] (8, D); full: every block sums its rows, in a fixed order,
//     into partial[p] (1, D).
//   * Pass 2 adds the partials in a fixed order (warp g of a block takes
//     partials g, g + 8, ..., then the eight warps' sums are added in
//     order): no float atomics, the same result on every run.
// The wrapper picks chunks_per_block so that the grid holds about four
// blocks a SM; both modes use the same grid, so their times compare the
// summing only.

#include <cuda_runtime.h>

#include <cstdint>

namespace lab {

constexpr int kStreamThreads = 256;
constexpr int kMaxSlots = 8;  // 16-byte slots a thread holds per chunk: chunks up to 32 KB
constexpr int kSumWarps = kStreamThreads / 32;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <bool kTouchOnly>
__global__ void __launch_bounds__(kStreamThreads)
stream_pass1_kernel(const float* __restrict__ s, int D, int block_s, int chunk_rows,
                    int chunks_per_block, float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  const int n4 = chunk_rows * D / 4;  // 16-byte copies a chunk
  const int blocks_per_tile = block_s / (chunk_rows * chunks_per_block);
  const int t = blockIdx.x / blocks_per_tile;
  const int bt = blockIdx.x % blocks_per_tile;
  const float4* src = reinterpret_cast<const float4*>(
      s + (static_cast<size_t>(t) * block_s +
           static_cast<size_t>(bt) * chunks_per_block * chunk_rows) * D);
  const int tid = threadIdx.x;

  for (int i = tid; i < n4; i += kStreamThreads) cp_async16(smem4 + i, src + i);
  cp_async_commit();

  float4 acc[kMaxSlots];
#pragma unroll
  for (int j = 0; j < kMaxSlots; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int c = 0; c < chunks_per_block; ++c) {
    float4* cur = smem4 + (c & 1) * n4;
    if (c + 1 < chunks_per_block) {
      float4* nxt = smem4 + ((c + 1) & 1) * n4;
      const float4* from = src + static_cast<size_t>(c + 1) * n4;
      for (int i = tid; i < n4; i += kStreamThreads) cp_async16(nxt + i, from + i);
    }
    cp_async_commit();  // an empty group on the last chunk keeps wait_group 1 exact
    cp_async_wait<1>();
    __syncthreads();
    if (kTouchOnly) {
      if (bt == 0 && c == 0) {
        const float4* rows = cur;
        float4* out = reinterpret_cast<float4*>(partial + static_cast<size_t>(t) * 8 * D);
        for (int i = tid; i < 2 * D; i += kStreamThreads) out[i] = rows[i];
      }
    } else {
#pragma unroll
      for (int j = 0; j < kMaxSlots; ++j) {
        const int i = tid + j * kStreamThreads;
        if (i < n4) acc[j] = add4(acc[j], cur[i]);
      }
    }
    __syncthreads();  // the stage is refilled two chunks on
  }
  cp_async_wait<0>();
  if (kTouchOnly) return;

  // Slot i of every chunk sums one (row, 4-column) cell over the block's
  // chunks; now the chunk's rows are added, in row order.
#pragma unroll
  for (int j = 0; j < kMaxSlots; ++j) {
    const int i = tid + j * kStreamThreads;
    if (i < n4) smem4[i] = acc[j];
  }
  __syncthreads();
  const int d4 = D / 4;
  float4* out = reinterpret_cast<float4*>(partial + static_cast<size_t>(blockIdx.x) * D);
  for (int k = tid; k < d4; k += kStreamThreads) {
    float4 sum = smem4[k];
    for (int r = 1; r < chunk_rows; ++r) sum = add4(sum, smem4[r * d4 + k]);
    out[k] = sum;
  }
}

// out[i] = sum_p partial[p * width + i] for i < width: block x takes 32
// consecutive i; warp g adds partials g, g + 8, g + 16, ... in that order,
// then warp 0's lanes add the eight warps' sums in order.
__global__ void __launch_bounds__(kStreamThreads)
stream_pass2_kernel(const float* __restrict__ partial, int n, int width,
                    float* __restrict__ out) {
  __shared__ float sums[kSumWarps][32];
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (i < width) {
    int p = g;
    for (; p + 3 * kSumWarps < n; p += 4 * kSumWarps) {
      const float v0 = partial[static_cast<size_t>(p) * width + i];
      const float v1 = partial[static_cast<size_t>(p + kSumWarps) * width + i];
      const float v2 = partial[static_cast<size_t>(p + 2 * kSumWarps) * width + i];
      const float v3 = partial[static_cast<size_t>(p + 3 * kSumWarps) * width + i];
      acc += v0;
      acc += v1;
      acc += v2;
      acc += v3;
    }
    for (; p < n; p += kSumWarps) acc += partial[static_cast<size_t>(p) * width + i];
  }
  sums[g][lane] = acc;
  __syncthreads();
  if (g == 0 && i < width) {
    float total = sums[0][lane];
    for (int w = 1; w < kSumWarps; ++w) total += sums[w][lane];
    out[i] = total;
  }
}

}  // namespace lab

extern "C" {

// Largest chunk, in bytes, a block's slots hold.
int lab_stream_max_chunk_bytes() { return lab::kMaxSlots * lab::kStreamThreads * 16; }

const char* lab_stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// s (rows, D) f32, 16-byte aligned, D a multiple of 4; n_tiles tiles of
// block_s rows are read (n_tiles * block_s <= rows). block_s is a multiple
// of chunk_rows * chunks_per_block, chunk_rows >= 8, chunk_rows * D * 4 <=
// lab_stream_max_chunk_bytes(). partial: (n_tiles, 8, D) f32 scratch
// (touch_only) or (n_tiles * block_s / (chunk_rows * chunks_per_block), D);
// out (8, D) (touch_only) or (1, D) f32. Launches on `stream`, does not
// synchronize, returns cudaGetLastError().
int lab_stream_reduce(const void* s, void* partial, void* out, int n_tiles, int block_s, int D,
                      int chunk_rows, int chunks_per_block, int touch_only, void* stream) {
  const long long rows_per_block = static_cast<long long>(chunk_rows) * chunks_per_block;
  if (s == nullptr || partial == nullptr || out == nullptr || n_tiles <= 0 || D <= 0 ||
      D % 4 != 0 || chunk_rows < 8 || chunks_per_block <= 0 || block_s % rows_per_block != 0 ||
      static_cast<long long>(chunk_rows) * D * 4 > lab_stream_max_chunk_bytes() ||
      reinterpret_cast<uintptr_t>(s) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = static_cast<int>(n_tiles * (block_s / rows_per_block));
  const size_t smem = 2 * static_cast<size_t>(chunk_rows) * D * sizeof(float);
  const float* src = static_cast<const float*>(s);
  float* part = static_cast<float*>(partial);
  cudaError_t err;
  if (touch_only) {
    err = cudaFuncSetAttribute(lab::stream_pass1_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    lab::stream_pass1_kernel<true><<<n_blocks, lab::kStreamThreads, smem, st>>>(
        src, D, block_s, chunk_rows, chunks_per_block, part);
  } else {
    err = cudaFuncSetAttribute(lab::stream_pass1_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    lab::stream_pass1_kernel<false><<<n_blocks, lab::kStreamThreads, smem, st>>>(
        src, D, block_s, chunk_rows, chunks_per_block, part);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int width = touch_only ? 8 * D : D;
  const int n = touch_only ? n_tiles : n_blocks;
  lab::stream_pass2_kernel<<<(width + 31) / 32, lab::kStreamThreads, 0, st>>>(
      part, n, width, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
