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
// output are rounded to bf16 as the lab's buf_ref holds them. Products of
// bf16 values are exact in f32, so only the order of the sums differs from
// the plain version.
//
// What bounds it: operations. At B = 64 the four convs are 59.2 GFLOP, 60 us
// at the 989 TFLOP/s of bf16 tensor cores; the bytes (the input and output,
// 51 MB) take 15 us.
//
// The design. One image's 56 x 56 x 64 bf16 activation is 401 KB, above the
// 227 KB a block may hold (the TPU keeps a whole image in VMEM), so a block
// takes one image's T x T output tile and recomputes its halo: it loads the
// (T + 4 n_blocks)^2 input region (zeros outside the image), and each conv
// shrinks the region by one pixel a side, so the last conv gives the tile.
//   * Each conv is an implicit GEMM on the bf16 tensor cores with f32 sums:
//     M the region's output pixels (16 an m-tile, in row-major order), N =
//     C_out, K = 9 x C_in in the order (tap, c_in). A's 16 rows for tap (dy,
//     dx) are the input pixels p + dy Ls + dx: ldmatrix takes a row address
//     per lane, so the tap shift costs no copy. At C = 64 (layer1) the
//     products run on wgmma m64n64k16, A from registers (each warp's 16
//     rows, loaded by ldmatrix exactly as mma.sync's A fragment) and B, the
//     tap's weights, read by the tensor cores from shared memory through a
//     descriptor (MN-major, 128-byte swizzle: the layout below); a
//     warpgroup's task is four m-tiles (64 pixels), and it loads the next
//     tap's A fragments while the current tap's four wgmma run. At C = 8,
//     16 and 32 the products run on mma.sync m16n8k16 (B by
//     ldmatrix.trans); at C_in = 8 two taps share a k16 step (lanes 0-15
//     address one tap, 16-31 the next; the tenth tap's weights are zeros).
//     At layer1 wgmma ran faster than mma.sync on the card (PERF.md).
//   * Activations and weights sit in shared memory in rows of C x 2 bytes
//     (a pixel, or a weight row k of C_out), each 16-byte chunk c of row r
//     at chunk c ^ (r >> s) (s = 0, 1, 2 at C = 64, 32, 16), so that the
//     eight rows of an ldmatrix fall in eight distinct 16-byte bank groups.
//     The weights stay k-major, a tap (C_in x C_out) at a time, at a
//     1024-byte aligned base: at C = 64 this is the hardware's 128-byte
//     swizzle of wgmma's MN-major B (eight 128-byte rows an atom).
//   * Two region buffers, not three: X (side L0 = T + 4 n_blocks) holds the
//     block input, H (side L0 - 2) the first conv's output. The second conv
//     writes the block output in place over X: output pixel (py, px) reads
//     its residual from the very elements it overwrites, and only the warp
//     that owns them touches them. Both buffers keep their side as the row
//     stride, so block k's regions sit at offset 2k in each.
//   * mma.sync: a warp's task is two m-tiles (32 output pixels) by all of
//     N: per k16 step 2 ldmatrix for A and C / 16 ldmatrix.trans for B feed
//     2 x C / 8 mma. The eight warps take the tasks in turn; the tap loop,
//     with no barrier in it, runs unrolled a row of three taps at a time.
//     wgmma: the two warpgroups take the tasks in turn, 32 f32 accumulators
//     a thread; eight m-tiles a task, or 12 or 16 warps, ran slower on the
//     card (spills).
//   * Copies by cp.async, 16 bytes a thread: the region with explicit zeros
//     outside the image (src-size 0), and each conv's nine taps of weights
//     (72 KB at C = 64) once the conv before it is done with theirs. The
//     weights come from the L2 (every block reads the same ones): tap
//     slots beyond nine that took the next conv's first taps during a conv
//     gained nothing on the card, and the barrier they need inside the tap
//     loop kept it from unrolling, which was worth more (PERF.md).
//   * Epilogue: bias (f32, from global memory), the residual, ReLU, zero
//     outside the image (the next conv's padding), rounded to bf16 into the
//     shared buffer; after the last conv the tile's pixels inside the image
//     go to the global NHWC output in 16-byte stores.
//   * The tile: the lab's wrapper (labs/block_lab.py: tile_plan) takes the T
//     whose m-tiles on a block's critical path, times the waves of blocks
//     the grid makes on the card, are fewest, among the T whose two
//     buffers and a conv's weights fit: T = 14 at (64, 56, 56, 64), two
//     blocks (56 = 4 x 14, the halo work 1.5x, against 1.97x at an 8 x 8
//     tile; buffers of 62 and 51 KB and 72 KB of weights: 187,904 bytes
//     with the alignment's slack). chip_smoke.py times it beside tiles 8,
//     12 and 16 (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "vit_mma.cuh"

namespace lab {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMT = 2;  // m-tiles (16 output pixels each) of a warp's task
constexpr int kTaps = 9;
constexpr int kAlign = 1024;  // the 128-byte swizzle's period: the weights' base

using bf = __nv_bfloat16;
using Frag = vit::Frag<bf>;

template <int kC>
struct Geo {
  static constexpr int kRow = kC * 2;      // bytes of a pixel, or of a weight row
  static constexpr int kChunks = kC / 8;   // its 16-byte chunks
  static constexpr int kShift = kC == 64 ? 0 : kC == 32 ? 1 : kC == 16 ? 2 : 3;
  static constexpr int kNT = kC / 8;       // n-tiles of C_out
  static constexpr int kTap = kC * kC * 2; // bytes of one tap's weights
};

// Byte offset of 16-byte chunk c of row r (a pixel, or a weight row) under
// the swizzle: chunk c ^ (r >> kShift), within the row's chunks.
template <int kC>
__device__ __forceinline__ int swz(int r, int c) {
  using G = Geo<kC>;
  return r * G::kRow + (((c ^ (r >> G::kShift)) & (G::kChunks - 1)) << 4);
}

// Dynamic shared memory of a block: the weights' alignment slack, a conv's
// nine taps, the region buffers X (side tile + 4 n_blocks) and H.
inline size_t blocks_smem_bytes(int C, int n_blocks, int tile) {
  const size_t l0 = static_cast<size_t>(tile) + 4 * n_blocks;
  return kAlign + (static_cast<size_t>(kTaps) * C + l0 * l0 + (l0 - 2) * (l0 - 2)) * C * 2;
}

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(vit::smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(const void* p, uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(vit::smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(const void* p, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(vit::smem_u32(p)));
}

// The input region of side L0 whose pixel (0, 0) is image pixel (gy, gx)
// into X: 16-byte copies, zeros outside the image.
template <int kC>
__device__ __forceinline__ void load_region(const bf* __restrict__ x, int img, int H, int W,
                                            int gy, int gx, int L0, char* xs) {
  using G = Geo<kC>;
  for (int i = threadIdx.x; i < L0 * L0 * G::kChunks; i += kThreads) {
    const int p = i / G::kChunks, c = i % G::kChunks;
    const int y = gy + p / L0, xx = gx + p % L0;
    const bool ok = y >= 0 && y < H && xx >= 0 && xx < W;
    const bf* src = ok ? x + ((static_cast<size_t>(img) * H + y) * W + xx) * kC + 8 * c : x;
    vit::cp_async16(xs + swz<kC>(p, c), src, ok);
  }
}

// Conv cv's nine taps (w is (2 n_blocks, 9, C_in, C_out)) into ws, tap t
// at ws + t C C, each weight row k swizzled.
template <int kC>
__device__ __forceinline__ void load_conv(const bf* __restrict__ w, int cv, char* ws) {
  using G = Geo<kC>;
  constexpr int kPer = kC * G::kChunks;  // 16-byte chunks a tap
  for (int i = threadIdx.x; i < kTaps * kPer; i += kThreads) {
    const int tap = i / kPer, e = i % kPer, k = e / G::kChunks, c = e % G::kChunks;
    vit::cp_async16(ws + tap * G::kTap + swz<kC>(k, c),
                    w + ((static_cast<size_t>(cv) * kTaps + tap) * kC + k) * kC + 8 * c, true);
  }
}

// acc (kMT m-tiles x all C_out) += the A rows r0[i] (+ the tap's shift
// toff) of src times tap weights wt, over the tap's C_in: C_in / 16 k16
// steps (C_in >= 16).
template <int kC>
__device__ __forceinline__ void tap_product(const char* src, const int (&r0)[kMT], int toff,
                                            const char* wt, float (&acc)[kMT][kC / 8][4]) {
  using G = Geo<kC>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int cs = 0; cs < kC / 16; ++cs) {
    Frag::A a[kMT];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      ldsm_x4(src + swz<kC>(r0[i] + toff, 2 * cs + (lane >> 4)), a[i].r[0], a[i].r[1], a[i].r[2],
              a[i].r[3]);
    }
    const int k = 16 * cs + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int jp = 0; jp < G::kNT / 2; ++jp) {
      Frag::B b0, b1;
      ldsm_x4_t(wt + swz<kC>(k, 2 * jp + (lane >> 4)), b0.r[0], b0.r[1], b1.r[0], b1.r[1]);
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        vit::mma(acc[i][2 * jp], a[i], b0);
        vit::mma(acc[i][2 * jp + 1], a[i], b1);
      }
    }
  }
}

// C_in = 8: one k16 step of taps ta and tb = ta + 1 (tb = 9: zero weights).
__device__ __forceinline__ void pair_product(const char* src, const int (&r0)[kMT], int sp,
                                             int ta, const char* ws, float (&acc)[kMT][1][4]) {
  const int lane = threadIdx.x & 31;
  const int tb = ta + 1;
  const int tap = (lane >> 4) ? min(tb, kTaps - 1) : ta;  // lanes 16-31 address the k-hi half
  const int toff = (tap / 3) * sp + tap % 3;
  Frag::A a[kMT];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    ldsm_x4(src + swz<8>(r0[i] + toff, 0), a[i].r[0], a[i].r[1], a[i].r[2], a[i].r[3]);
  }
  // Lanes 0-7 address tap ta's eight rows, 8-15 tap tb's.
  const int bt = ((lane >> 3) & 1) ? min(tb, kTaps - 1) : ta;
  Frag::B b;
  ldsm_x2_t(ws + bt * Geo<8>::kTap + swz<8>(lane & 7, 0), b.r[0], b.r[1]);
  if (tb >= kTaps) b.r[1] = 0u;
#pragma unroll
  for (int i = 0; i < kMT; ++i) vit::mma(acc[i][0], a[i], b);
}

// The epilogue of kN m-tiles from m-tile mt0 (accumulators in mma.sync's
// layout): + bias (+ the residual read from dst's own elements, kResid),
// ReLU, 0 outside the image (output (0, 0) at image (oy, ox)), rounded to
// bf16 into dst at offset doff (stride dp).
template <int kC, int kN, bool kResid>
__device__ __forceinline__ void store_tile(const float (&acc)[kN][kC / 8][4], int mt0, int Ld,
                                           char* dst, int dp, int doff, int oy, int ox, int H,
                                           int W, const float* __restrict__ bias) {
  const int lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = 16 * (mt0 + i) + (lane >> 2) + 8 * h;
      if (p >= Ld * Ld) continue;
      const int py = p / Ld, px = p - py * Ld;
      const int y = oy + py, x = ox + px;
      const bool inside = y >= 0 && y < H && x >= 0 && x < W;
      const int r = (doff + py) * dp + doff + px;
#pragma unroll
      for (int j = 0; j < kC / 8; ++j) {
        const int ch = 8 * j + 2 * t;
        __nv_bfloat162* at = reinterpret_cast<__nv_bfloat162*>(dst + swz<kC>(r, j) + 4 * t);
        float v0 = acc[i][j][2 * h] + __ldg(bias + ch);
        float v1 = acc[i][j][2 * h + 1] + __ldg(bias + ch + 1);
        if constexpr (kResid) {
          const float2 res = __bfloat1622float2(*at);
          v0 += res.x;
          v1 += res.y;
        }
        *at = inside ? __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f))
                     : __floats2bfloat162_rn(0.f, 0.f);
      }
    }
}

// One 3x3 conv: the output region of side Ld (its pixel (0, 0) at image
// (oy, ox)) from src, whose region sits at offset so (in pixels, both
// axes) in a buffer of row stride sp; the output at offset doff in dst
// (stride dp); the conv's weights in ws; store_tile's epilogue. C = 8, 16
// and 32, on mma.sync.
template <int kC, bool kResid>
__device__ __forceinline__ void conv3x3(const char* src, int sp, int so, int Ld, char* dst, int dp,
                                        int doff, int oy, int ox, int H, int W, const char* ws,
                                        const float* __restrict__ bias) {
  using G = Geo<kC>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_pix = Ld * Ld;
  const int n_tasks = ((n_pix + 15) / 16 + kMT - 1) / kMT;
  for (int task = warp; task < n_tasks; task += kWarps) {
    int r0[kMT];  // this lane's A row of each m-tile: its output pixel's window origin in src
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const int p = min(16 * (kMT * task + i) + (lane & 15), n_pix - 1);
      const int py = p / Ld, px = p - py * Ld;
      r0[i] = (so + py) * sp + so + px;
    }
    float acc[kMT][G::kNT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < G::kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    if constexpr (kC >= 16) {
#pragma unroll 3  // a row of taps at a time
      for (int tap = 0; tap < kTaps; ++tap) {
        tap_product<kC>(src, r0, (tap / 3) * sp + tap % 3, ws + tap * G::kTap, acc);
      }
    } else {
#pragma unroll
      for (int ta = 0; ta < kTaps; ta += 2) pair_product(src, r0, sp, ta, ws, acc);
    }
    store_tile<kC, kMT, kResid>(acc, kMT * task, Ld, dst, dp, doff, oy, ox, H, W, bias);
  }
}

// wgmma's descriptor of one k16 step of a tap's weights at p: MN-major B
// under the 128-byte swizzle, N = 64 one atom wide, its 16 k-rows two
// groups of eight 128-byte rows (SBO 1,024 bytes); the leading offset, the
// stride between atoms along N, has no second atom to reach.
__device__ __forceinline__ uint64_t b_desc(const void* p) {
  return static_cast<uint64_t>((vit::smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

// d (64 x 64, f32) += A (each warp's 16 rows, mma.sync's A fragment) x B
// (desc), or = A x B when !accumulate: wgmma m64n64k16, B transposed
// (MN-major).
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const Frag::A& a, uint64_t desc,
                                          bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "l"(desc),
        "r"(static_cast<int>(accumulate)));
}

// The C = 64 conv3x3 (its arguments as conv3x3's) on wgmma: warpgroup g
// takes tasks g, g + 2, ..., each four m-tiles, warp q of the group the
// fourth q. Per tap: the four k16 steps' A fragments, loaded while the
// tap before's wgmma run, then four wgmma, committed as one group.
template <bool kResid>
__device__ __forceinline__ void conv3x3_wg(const char* src, int sp, int so, int Ld, char* dst,
                                           int dp, int doff, int oy, int ox, int H, int W,
                                           const char* ws, const float* __restrict__ bias) {
  constexpr int kGroups = kWarps / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_pix = Ld * Ld;
  const int n_tasks = ((n_pix + 15) / 16 + 3) / 4;
  for (int task = warp / 4; task < n_tasks; task += kGroups) {
    const int mt = 4 * task + warp % 4;  // this warp's m-tile
    const int p0 = min(16 * mt + (lane & 15), n_pix - 1);
    const int r0 = (so + p0 / Ld) * sp + so + p0 % Ld;
    Frag::A a[2][4];  // a tap's four k16 steps, double-buffered
    const auto load_tap = [&](int tap, Frag::A (&f)[4]) {
      const int r = r0 + (tap / 3) * sp + tap % 3;
#pragma unroll
      for (int cs = 0; cs < 4; ++cs) {
        ldsm_x4(src + swz<64>(r, 2 * cs + (lane >> 4)), f[cs].r[0], f[cs].r[1], f[cs].r[2],
                f[cs].r[3]);
      }
    };
    float d[32] = {};
    load_tap(0, a[0]);
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int cs = 0; cs < 4; ++cs) {
        wgmma_n64(d, a[tap & 1][cs], b_desc(ws + tap * Geo<64>::kTap + cs * 16 * Geo<64>::kRow),
                  tap > 0 || cs > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (tap + 1 < kTaps) {
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // a[(tap + 1) & 1] free
        load_tap(tap + 1, a[(tap + 1) & 1]);
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    float acc[1][8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][j][e] = d[4 * j + e];
    store_tile<64, 1, kResid>(acc, mt, Ld, dst, dp, doff, oy, ox, H, W, bias);
  }
}

// Block = one image's tile x tile output tile: blockIdx.x = img *
// tiles_per_img + ty * tiles_x + tx.
template <int kC>
__global__ void __launch_bounds__(kThreads, 1)
    fused_blocks_kernel(const bf* __restrict__ x, const bf* __restrict__ w,
                        const float* __restrict__ bias, bf* __restrict__ out, int H, int W,
                        int n_blocks, int tile, int tiles_x, int tiles_per_img) {
  using G = Geo<kC>;
  extern __shared__ uint4 smem16[];
  const int L0 = tile + 4 * n_blocks;
  char* ws = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem16) + kAlign - 1) &
                                     ~static_cast<uintptr_t>(kAlign - 1));
  char* xs = ws + kTaps * G::kTap;
  char* hs = xs + L0 * L0 * G::kRow;
  const int img = blockIdx.x / tiles_per_img;
  const int ty = (blockIdx.x % tiles_per_img) / tiles_x, tx = blockIdx.x % tiles_per_img % tiles_x;
  const int gy = ty * tile - 2 * n_blocks, gx = tx * tile - 2 * n_blocks;
  const int n_convs = 2 * n_blocks;

  load_region<kC>(x, img, H, W, gy, gx, L0, xs);
  load_conv<kC>(w, 0, ws);
  vit::cp_async_commit();
  for (int cv = 0; cv < n_convs; ++cv) {
    vit::cp_async_wait<0>();
    // The weights, written by cp.async, are read by wgmma's async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // the conv's weights, and the conv before it's output
    const int k = cv / 2;
    const int side = L0 - 4 * k;  // the block input's region
    const float* b = bias + cv * kC;
    if constexpr (kC == 64) {
      if ((cv & 1) == 0) {
        conv3x3_wg<false>(xs, L0, 2 * k, side - 2, hs, L0 - 2, 2 * k, gy + 2 * k + 1,
                          gx + 2 * k + 1, H, W, ws, b);
      } else {
        conv3x3_wg<true>(hs, L0 - 2, 2 * k, side - 4, xs, L0, 2 * k + 2, gy + 2 * k + 2,
                         gx + 2 * k + 2, H, W, ws, b);
      }
    } else if ((cv & 1) == 0) {
      conv3x3<kC, false>(xs, L0, 2 * k, side - 2, hs, L0 - 2, 2 * k, gy + 2 * k + 1,
                         gx + 2 * k + 1, H, W, ws, b);
    } else {
      conv3x3<kC, true>(hs, L0 - 2, 2 * k, side - 4, xs, L0, 2 * k + 2, gy + 2 * k + 2,
                        gx + 2 * k + 2, H, W, ws, b);
    }
    __syncthreads();  // src, dst and the weights are free
    if (cv + 1 < n_convs) {
      load_conv<kC>(w, cv + 1, ws);
      vit::cp_async_commit();
    }
  }

  // The tile: X's region at offset 2 n_blocks, its pixels inside the image.
  const int o = 2 * n_blocks;
  for (int i = threadIdx.x; i < tile * tile * G::kChunks; i += kThreads) {
    const int p = i / G::kChunks, c = i % G::kChunks;
    const int py = p / tile, px = p % tile;
    const int y = ty * tile + py, xx = tx * tile + px;
    if (y < H && xx < W) {
      *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(img) * H + y) * W + xx) * kC + 8 * c) =
          *reinterpret_cast<const uint4*>(xs + swz<kC>((o + py) * L0 + o + px, c));
    }
  }
}

template <int kC>
cudaError_t launch_blocks(cudaStream_t stream, const void* x, const void* w, const void* bias,
                          void* out, int B, int H, int W, int n_blocks, int tile) {
  const int tiles_x = (W + tile - 1) / tile;
  const int tiles_per_img = tiles_x * ((H + tile - 1) / tile);
  const size_t smem = blocks_smem_bytes(kC, n_blocks, tile);
  cudaError_t err = cudaFuncSetAttribute(fused_blocks_kernel<kC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_blocks_kernel<kC><<<B * tiles_per_img, kThreads, smem, stream>>>(
      static_cast<const bf*>(x), static_cast<const bf*>(w), static_cast<const float*>(bias),
      static_cast<bf*>(out), H, W, n_blocks, tile, tiles_x, tiles_per_img);
  return cudaGetLastError();
}

}  // namespace lab

extern "C" {

const char* lab_blocks_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The shared memory a block may opt in to on `device`; 0 on error.
int lab_blocks_smem_optin(int device) {
  int bytes = 0;
  return cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) ==
                 cudaSuccess
             ? bytes
             : 0;
}

// x (B, H, W, C) bf16 NHWC; w (2 n_blocks, 9, C, C) bf16, conv i's tap
// t = 3 dy + dx as (C_in, C_out); bias (2 n_blocks, C) f32; out (B, H, W,
// C) bf16, all contiguous. C is 8, 16, 32 or 64; all pointers 16-byte
// aligned; output tiles of tile x tile pixels, and the block must fit the
// device's shared memory. Launches on `stream`, does not synchronize,
// returns cudaGetLastError().
int lab_fused_blocks(const void* x, const void* w, const void* bias, void* out, int B, int H,
                     int W, int C, int n_blocks, int tile, void* stream) {
  if (x == nullptr || w == nullptr || bias == nullptr || out == nullptr || B <= 0 || H <= 0 ||
      W <= 0 || n_blocks <= 0 || tile <= 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      static_cast<long long>(B) * ((H + tile - 1) / tile) * ((W + tile - 1) / tile) > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (lab::blocks_smem_bytes(C, n_blocks, tile) >
      static_cast<size_t>(lab_blocks_smem_optin(device))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 8:
      return static_cast<int>(
          lab::launch_blocks<8>(st, x, w, bias, out, B, H, W, n_blocks, tile));
    case 16:
      return static_cast<int>(
          lab::launch_blocks<16>(st, x, w, bias, out, B, H, W, n_blocks, tile));
    case 32:
      return static_cast<int>(
          lab::launch_blocks<32>(st, x, w, bias, out, B, H, W, n_blocks, tile));
    case 64:
      return static_cast<int>(
          lab::launch_blocks<64>(st, x, w, bias, out, B, H, W, n_blocks, tile));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
