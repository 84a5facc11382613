// Implicit-GEMM stride-1 convolution in bf16 on Hopper's tensor cores
// (wgmma), for sm_90a, behind a plain C interface.
//
// Replaces, for bf16 activations:
//   K13 retinex_tpu/ops/conv_pallas.py::_conv_kernel (pallas_call in
//       conv2d_pallas) and
//   K15 retinex_tpu/ops/conv_pallas.py::_conv_im2col_kernel (pallas_call in
//       conv2d_pallas_im2col),
// which compute one function: a stride-1 convolution with torch-parity
// padding (k//2 before, k-1-k//2 after, per axis; kernels up to 3x3), NHWC
// bf16 in and out, an HWIO kernel in bf16, exact bf16 x bf16 products summed
// in f32, then the f32 bias, the optional ReLU and one rounding to bf16
// (__float2bfloat16_rn, round to nearest even). The wrapper
// (retinex_tpu_torch/ops/conv_pallas.py) sends a call here when Cin % 8 == 0
// and x's base is 16-byte aligned (TMA's stride and address rules); every
// other bf16 call goes to conv_direct.cu.
//
// Bound on the card: at [2,544,960,128] 3x3 -> 128 the convolution is
// 3.08e11 FLOP, 0.311 ms of the H100's 989 TFLOP/s of dense bf16, against
// 0.160 ms for its bytes (x read once, out written once) at 3.35 TB/s: the
// tensor cores bound it, so the design keeps them fed.
//
// Design: one GEMM per output tile. M = the 16 x 16 = 256 output pixels of a
// spatial tile, N = a Cout tile of 128 (64 or 32 when Cout is narrower), K =
// taps x Cin in chunks of 64 channels (one 128-byte row per pixel, four k16
// steps).
// - The halo tile. For each chunk, one TMA copy of a 4-D tiled tensor map
//   over [B, H, W, Cin] brings a box {64, 18, 18, 1} into shared memory with
//   the 128-byte swizzle; its start is (x0 - pad_l, y0 - pad_t), and TMA's
//   zero fill of what lies outside the tensor is the padding (and the
//   channels past Cin in the last chunk). The box is 18 x 18 for every
//   kernel size, so its shape is a constant.
// - A from registers. For tap (u, v), A is the halo window shifted by
//   (u, v); its rows are not one uniform wgmma shared-memory matrix (the halo
//   row is 18 pixels), so each consumer warp loads its 16-row fragments with
//   ldmatrix from per-lane pixel addresses that apply TMA's swizzle (the
//   16-byte chunk index XOR the pixel index mod 8), and issues wgmma
//   m64nNk16 in its register-A form. The fragments are double-buffered:
//   k-block kb + 1's ldmatrix runs while kb's wgmmas do (wait_group 1).
// - B through TMA. The wrapper packs the HWIO kernel once per call into
//   [tap][chunk][Cout_pad][64] bf16 (K-major B, zeros past Cin and Cout); a
//   producer thread streams the (tap, chunk) B tiles (16 KB at N = 128)
//   through a ring of four mbarrier-guarded stages with the 128-byte
//   swizzle, and wgmma reads them through shared-memory descriptors.
// - Warp specialisation. Block = one producer warpgroup (one thread issues
//   every TMA copy; setmaxnreg gives its registers away) + two consumer
//   warpgroups, each owning 128 rows of M (two m64 accumulators of N f32 per
//   thread). Full and empty mbarriers both ways; halo tiles double-buffered.
// - A persistent grid, one block per SM, walks the tiles (Cout tile
//   fastest, then tile column, tile row, image), so the producer loads the
//   next tile while the consumers run the last one's epilogue.
// - Epilogue: f32 bias, ReLU, __float2bfloat16_rn into a per-warp staging
//   tile in shared memory (16-byte chunks XOR-swizzled by pixel), then whole
//   16-byte NHWC stores, masked at the ragged H and W edges and at Cout.
//   Storing the accumulator fragments straight to global memory (4 bytes a
//   lane, eight pixels a warp instruction) cost more than a quarter of the
//   kernel's time.
// The weights (295 KB at 128 -> 128, 3x3) are re-read from L2 by every
// tile, 1.2 GB a call at [2,544,960,128]; no cluster multicasts them.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTH = 16, kTW = 16;             // output tile: M = 256 pixels
constexpr int kHH = kTH + 2, kHW = kTW + 2;   // halo box, kernels up to 3x3
constexpr int kCK = 64;                       // channels per chunk: 128 B per pixel
constexpr int kHaloBytes = kHH * kHW * kCK * 2;
constexpr int kHaloStride = (kHaloBytes + 1023) / 1024 * 1024;  // 1024-aligned (swizzle atom)
constexpr int kHaloStages = 2;
constexpr int kBStages = 4;
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kConsumerThreads = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Spins on a barrier phase. A phase that never completes (a lost copy or
// arrival) traps after 2^28 polls, so a fault surfaces as a launch error
// instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (polls == (1u << 28)) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Shared-memory matrix descriptor of a K-major tile with the 128-byte
// swizzle: rows of 128 B, 8-row groups 1024 B apart (SBO), LBO unused (1).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

// D[64 x N] += A[64 x 16] (registers, ldmatrix fragments) x B[16 x N]
// (shared memory, K-major, descriptor), f32 accumulators.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (N == 128) {
    wgmma_m64n128k16(d, a, desc_b);
  } else if constexpr (N == 64) {
    wgmma_m64n64k16(d, a, desc_b);
  } else {
    wgmma_m64n32k16(d, a, desc_b);
  }
}

// Keep the compiler from reusing or moving registers that an asynchronous
// wgmma may still read (A fragments) or write (accumulators).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

using Frags = uint32_t[2][4][4];  // A of one k-block: [m64][k16 step][registers]

__device__ __forceinline__ void fence_frags(Frags& f) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(f[j][kk][r])::"memory");
}

// The lane's rows of both m64 halves for one tap: pixel `pix` of the halo
// (m64 1 is 4 tile rows further), k16 step kk in 16-byte chunks 2kk and
// 2kk + 1, each at its swizzled place (chunk XOR pixel mod 8).
__device__ __forceinline__ void load_frags(Frags& f, uint32_t halo, int pix, int khalf) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int p = pix + 4 * j * kHW;
    const uint32_t row = halo + p * (kCK * 2);
    const int sw = p & 7;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(f[j][kk], row + (((2 * kk + khalf) ^ sw) << 4));
  }
}

struct WgArgs {
  int H, W, cin, cout, cout_pad, kh, kw, relu, n_chunks, tiles_x, tiles_y, co_tiles, n_tiles;
};

template <int N>
struct Smem {
  static constexpr int kBBytes = N * kCK * 2;  // one (tap, chunk) B tile
  static constexpr int kEpiBytes = kTW * N * 2;  // one warp's 16 output pixels in bf16
  static constexpr int kBars = 2 * kHaloStages + 2 * kBStages;
  static constexpr int kBytes =
      1024 + kHaloStages * kHaloStride + kBStages * kBBytes + (kConsumerThreads / 32) * kEpiBytes + 8 * kBars;
};

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    conv_wgmma_bf16_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                           const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, const WgArgs a) {
  using S = Smem<N>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t halo0 = base;
  const uint32_t b0 = halo0 + kHaloStages * kHaloStride;
  const uint32_t epi0 = b0 + kBStages * S::kBBytes;  // per-warp epilogue staging
  const uint32_t bars = epi0 + (kConsumerThreads / 32) * S::kEpiBytes;
  // Barriers: halo full [kHaloStages], halo empty, B full [kBStages], B empty.
  const uint32_t h_full = bars, h_empty = bars + 8 * kHaloStages;
  const uint32_t b_full = bars + 16 * kHaloStages, b_empty = b_full + 8 * kBStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kHaloStages; ++s) {
      mbar_init(h_full + 8 * s, 1);
      mbar_init(h_empty + 8 * s, kConsumerThreads);
    }
    for (int s = 0; s < kBStages; ++s) {
      mbar_init(b_full + 8 * s, 1);
      mbar_init(b_empty + 8 * s, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int taps = a.kh * a.kw;
  const int pad_t = a.kh / 2, pad_l = a.kw / 2;

  if (wg == 0) {
    // Producer warpgroup: one thread issues every copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x != 0) return;
    int hs = 0, hph = 0, bs = 0, bph = 0;
    for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
      int r = tile;
      const int ct = r % a.co_tiles;
      r /= a.co_tiles;
      const int tx = r % a.tiles_x;
      r /= a.tiles_x;
      const int ty = r % a.tiles_y, b = r / a.tiles_y;
      const int x0 = tx * kTW - pad_l, y0 = ty * kTH - pad_t, co0 = ct * N;
      for (int c = 0; c < a.n_chunks; ++c) {
        mbar_wait(h_empty + 8 * hs, hph ^ 1);
        mbar_expect_tx(h_full + 8 * hs, kHaloBytes);
        tma_load_4d(halo0 + hs * kHaloStride, &xmap, h_full + 8 * hs, c * kCK, x0, y0, b);
        if (++hs == kHaloStages) hs = 0, hph ^= 1;
        for (int t = 0; t < taps; ++t) {
          mbar_wait(b_empty + 8 * bs, bph ^ 1);
          mbar_expect_tx(b_full + 8 * bs, S::kBBytes);
          tma_load_2d(b0 + bs * S::kBBytes, &wmap, b_full + 8 * bs, 0, (t * a.n_chunks + c) * a.cout_pad + co0);
          if (++bs == kBStages) bs = 0, bph ^= 1;
        }
      }
    }
    return;
  }

  // Consumer warpgroup g owns tile rows 8g..8g+7: m64 j covers rows
  // 8g + 4j + warp, one 16-pixel tile row per warp.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int g = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid / 32, lane = tid % 32;
  // ldmatrix x4: lanes 8q..8q+7 address the rows of 8x8 matrix q; q & 1
  // picks pixels 8-15 of the warp's row, q >> 1 the upper 8 channels of a
  // k16 step. Halo pixel of this lane's row at tap (0, 0), m64 0:
  const int q = lane >> 3;
  const int pix0 = (8 * g + warp) * kHW + (q & 1) * 8 + (lane & 7);
  const int khalf = q >> 1;
  int hs = 0, hph = 0, bs = 0, bph = 0;

  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    int r = tile;
    const int ct = r % a.co_tiles;
    r /= a.co_tiles;
    const int tx = r % a.tiles_x;
    r /= a.tiles_x;
    const int ty = r % a.tiles_y, b = r / a.tiles_y;

    float acc[2][N / 2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[j][i] = 0.f;

    // K-blocks (chunk, tap) in order. Each step issues k-block kb's wgmmas
    // from `cur`, retires kb - 1 (its B stage and its fragment registers)
    // and loads kb + 1's fragments into them while kb's wgmmas run.
    const int nkb = a.n_chunks * taps;
    Frags fa, fb;
    int t = 0;  // tap of the k-block whose fragments were loaded last
    mbar_wait(h_full + 8 * hs, hph);
    load_frags(fa, halo0 + hs * kHaloStride, pix0, khalf);
    auto step = [&](Frags& cur, Frags& nxt, int kb) {
      mbar_wait(b_full + 8 * bs, bph);
      const uint64_t desc = sw128_desc(b0 + bs * S::kBBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int j = 0; j < 2; ++j) wgmma_rs<N>(acc[j], cur[j][kk], desc + 2 * kk);  // +32 B per k16
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_frags(nxt);
      if (kb > 0) mbar_arrive(b_empty + 8 * (bs == 0 ? kBStages - 1 : bs - 1));
      if (++bs == kBStages) bs = 0, bph ^= 1;
      if (++t == taps) {  // kb + 1 starts a chunk: kb's halo has been read
        t = 0;
        mbar_arrive(h_empty + 8 * hs);
        if (++hs == kHaloStages) hs = 0, hph ^= 1;
        if (kb + 1 < nkb) mbar_wait(h_full + 8 * hs, hph);
      }
      if (kb + 1 < nkb) {
        const int u = t / a.kw, v = t - u * a.kw;
        load_frags(nxt, halo0 + hs * kHaloStride, pix0 + u * kHW + v, khalf);
      }
    };
    for (int kb = 0; kb < nkb; kb += 2) {
      step(fa, fb, kb);
      if (kb + 1 < nkb) step(fb, fa, kb + 1);
    }
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    fence_frags(fa);
    fence_frags(fb);
    mbar_arrive(b_empty + 8 * (bs == 0 ? kBStages - 1 : bs - 1));

    // Epilogue, per m64 half: the warp rounds its 16 pixels x N channels
    // (f32 + bias, ReLU, then bf16) into its staging tile, 16-byte chunks
    // XOR-swizzled by pixel so neither side conflicts on banks, and stores
    // them as whole chunks: consecutive lanes on consecutive chunks of one
    // pixel, consecutive pixels after. Accumulator i of an m64: n8 group
    // i / 4, pixel lane / 4 (+8 for i % 4 >= 2), channels 2 (lane % 4) + i % 2.
    constexpr int kChunks = N / 8;  // 16-byte chunks per pixel
    constexpr int kSwz = kChunks < 8 ? kChunks - 1 : 7;
    constexpr int kPixPerStore = 32 / kChunks;
    uint8_t* stage = smem_raw + (epi0 - smem_u32(smem_raw)) + (4 * g + warp) * S::kEpiBytes;
    const int co_l = ct * N + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int px = (lane >> 2) + 8 * h;
#pragma unroll
        for (int n8 = 0; n8 < kChunks; ++n8) {
          const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + co_l + 8 * n8));  // padded to cout_pad
          float v0 = acc[j][4 * n8 + 2 * h] + bv.x, v1 = acc[j][4 * n8 + 2 * h + 1] + bv.y;
          if (a.relu) v0 = fmaxf(v0, 0.f), v1 = fmaxf(v1, 0.f);
          *reinterpret_cast<__nv_bfloat162*>(stage + px * (N * 2) + ((n8 ^ (px & kSwz)) << 4) + 4 * (lane & 3)) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
      __syncwarp();
      const int gy = ty * kTH + 8 * g + 4 * j + warp;
      if (gy < a.H) {
        const int ch = lane % kChunks, co = ct * N + 8 * ch;
#pragma unroll
        for (int m = 0; m < kTW / kPixPerStore; ++m) {
          const int px = m * kPixPerStore + lane / kChunks, gx = tx * kTW + px;
          if (gx >= a.W || co >= a.cout) continue;
          const uint4 v = *reinterpret_cast<const uint4*>(stage + px * (N * 2) + ((ch ^ (px & kSwz)) << 4));
          __nv_bfloat16* o = out + (((size_t)b * a.H + gy) * a.W + gx) * a.cout + co;
          if (a.cout % 8 == 0) {
            *reinterpret_cast<uint4*>(o) = v;
          } else {  // element by element, from registers
            uint16_t* o16 = reinterpret_cast<uint16_t*>(o);
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const uint32_t word = k < 2 ? v.x : k < 4 ? v.y : k < 6 ? v.z : v.w;
              if (co + k < a.cout) o16[k] = (uint16_t)(k & 1 ? word >> 16 : word);
            }
          }
        }
      }
      __syncwarp();  // the staging tile is free for the next half
    }
  }
}

// libcuda's tensor-map encoder, fetched through the runtime so that the
// library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Error codes past the runtime's: the encoder is missing, or refused a map
// (kEncodeFailed + its CUresult).
constexpr int kNoEncoder = 10000;
constexpr int kEncodeFailed = 20000;

template <int N>
int launch(const void* x, const void* w, const void* bias, void* out, int batch, const WgArgs& a, void* stream) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kNoEncoder;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdim[4] = {(cuuint64_t)a.cin, (cuuint64_t)a.W, (cuuint64_t)a.H, (cuuint64_t)batch};
  const cuuint64_t xstride[3] = {(cuuint64_t)a.cin * 2, (cuuint64_t)a.W * a.cin * 2, (cuuint64_t)a.H * a.W * a.cin * 2};
  const cuuint32_t xbox[4] = {kCK, kHW, kHH, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult res = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), xdim, xstride, xbox, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return kEncodeFailed + (int)res;
  const cuuint64_t wrows = (cuuint64_t)a.kh * a.kw * a.n_chunks * a.cout_pad;
  const cuuint64_t wdim[2] = {kCK, wrows};
  const cuuint64_t wstride[1] = {kCK * 2};
  const cuuint32_t wbox[2] = {kCK, N};
  res = encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), wdim, wstride, wbox, ones,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return kEncodeFailed + (int)res;

  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv_wgmma_bf16_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<N>::kBytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = a.n_tiles < sms ? a.n_tiles : sms;
  conv_wgmma_bf16_kernel<N><<<grid, kThreads, Smem<N>::kBytes, (cudaStream_t)stream>>>(
      xmap, wmap, (const float*)bias, (__nv_bfloat16*)out, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [batch, H, W, cin] bf16, cin % 8 == 0, 16-byte aligned; w the packed
// kernel [kh * kw, n_chunks, cout_pad, 64] bf16 (n_chunks = ceil(cin / 64),
// zeros past cin and cout); bias f32 [cout_pad]; out [batch, H, W, cout]
// bf16. n_tile (32, 64 or 128) divides cout_pad.
int conv_wgmma_bf16(const void* x, const void* w, const void* bias, void* out, int batch, int H, int W, int cin,
                    int cout, int cout_pad, int kh, int kw, int relu, int n_tile, void* stream) {
  if (cin % 8 != 0 || kh < 1 || kh > 3 || kw < 1 || kw > 3 || cout_pad % n_tile != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  WgArgs a{H, W, cin, cout, cout_pad, kh, kw, relu, (cin + kCK - 1) / kCK, (W + kTW - 1) / kTW,
           (H + kTH - 1) / kTH, cout_pad / n_tile, 0};
  a.n_tiles = batch * a.tiles_y * a.tiles_x * a.co_tiles;
  switch (n_tile) {
    case 32: return launch<32>(x, w, bias, out, batch, a, stream);
    case 64: return launch<64>(x, w, bias, out, batch, a, stream);
    case 128: return launch<128>(x, w, bias, out, batch, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory per block for Cout tile n_tile, or -1.
int conv_wgmma_smem(int n_tile) {
  switch (n_tile) {
    case 32: return Smem<32>::kBytes;
    case 64: return Smem<64>::kBytes;
    case 128: return Smem<128>::kBytes;
    default: return -1;
  }
}

}  // extern "C"
