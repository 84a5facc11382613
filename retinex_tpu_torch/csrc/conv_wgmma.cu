// Implicit-GEMM stride-1 convolution in bf16 on Hopper's tensor cores
// (wgmma), for sm_90a, behind a plain C interface.
//
// Replaces, for bf16 activations:
//   K13 retinex_tpu/ops/conv_pallas.py::_conv_kernel (pallas_call in
//       conv2d_pallas) and
//   K15 retinex_tpu/ops/conv_pallas.py::_conv_im2col_kernel (pallas_call in
//       conv2d_pallas_im2col): torch-parity padding (k//2 before, k-1-k//2
//       after, per axis; kernels up to 3x3);
//   K14 retinex_tpu/ops/conv_pallas.py::_conv_narrow_kernel (pallas_call in
//       conv2d_narrow): a 3x3 or 5x5 kernel, dilation 1 or 2, symmetric
//       padding (k//2) * dilation.
// One function: NHWC bf16 in and out, an HWIO kernel in bf16, exact bf16 x
// bf16 products summed in f32, then the f32 bias, the optional ReLU and one
// rounding to bf16 (__float2bfloat16_rn, round to nearest even). The kernel
// takes kh, kw, the dilation and the low padding of each axis, so one body
// computes both conventions. The wrapper
// (retinex_tpu_torch/ops/conv_pallas.py) sends a bf16 call here when
// Cin % 8 == 0 and x's base is 16-byte aligned (TMA's stride and address
// rules); every other bf16 call goes to conv_direct.cu.
// It also carries K12 (retinex_tpu/ops/fused_blocks.py::_fam_kernel) in
// bf16 as two launches (retinex_tpu_torch/ops/fused_blocks.py: fam_dual_y,
// 128 -> 256 with ReLU, y stored in bf16 as the JAX kernel's ys scratch;
// fam_dual_out, the two half convolutions as one launch with groups = 2),
// and K4 (retinex_tpu/ops/fused_blocks.py::_fam_conv_kernel) in bf16 as its
// two 3x3 convolutions: fam_conv_y (128 -> 256 with ReLU, y rounded to bf16
// as the JAX kernel's ys scratch) and fam_conv_z (256 -> 128 plus
// bias_total) in the f32-output mode (out_f32): the JAX kernel sums its four
// branches in f32, so z is stored as the f32 sum plus bias, not rounded.
// Groups: Cout tile t reads only input channels [g * Cin/groups, (g + 1) *
// Cin/groups), g = t / (Cout tiles per group), from an HWIO kernel [kh, kw,
// Cin/groups, Cout]: the halo box's channel coordinate starts at the
// group's first channel (the tensor map keeps the whole Cin, and a box never
// straddles two groups: Cin/groups is a multiple of the K chunk).
//
// Bound on the card. K13/K15 at [2,544,960,128] 3x3 -> 128: 3.08e11 FLOP,
// 0.311 ms of the H100's 989 TFLOP/s of dense bf16, against 0.160 ms for
// its bytes: the tensor cores bound it. K14 at [2,1088,1920,32] 3x3 32 -> 32:
// 7.7e10 FLOP (0.078 ms) against 534 MB (0.160 ms at 3.35 TB/s): its bytes
// bound it, so there the design keeps HBM streaming.
//
// Design: one GEMM per output tile. M = the 16 x 16 = 256 output pixels of a
// spatial tile, N = a Cout tile of 128 (64 or 32 when Cout is narrower), K =
// taps x Cin in chunks of CK channels: 64 (one 128-byte row per pixel, four
// k16 steps) or, when Cin <= 32, 32 (one 64-byte row, two k16 steps), so a
// narrow Cin sends no zero half through ldmatrix and wgmma.
// - The halo tile. For each chunk, one TMA copy of a 4-D tiled tensor map
//   over [B, H, W, Cin] brings a box {CK, 16 + (kw-1)*dil, 16 + (kh-1)*dil,
//   1} (18, 20 or 24 pixels a side for the 3x3 and 5x5 kernels at dilation
//   1 and 2) into shared memory with the 128-byte (CK 64) or 64-byte (CK 32)
//   swizzle; its start is (x0 - pad_l, y0 - pad_t), and TMA's zero fill of
//   what lies outside the tensor is the padding (and the channels past Cin
//   in the last chunk).
// - A from registers. For tap (u, v), A is the halo window at offset
//   (u*dil, v*dil); its rows are not one uniform wgmma shared-memory matrix
//   (a halo row is wider than 16 pixels), so each consumer warp loads its
//   16-row fragments with ldmatrix from per-lane pixel addresses that apply
//   TMA's swizzle (the 16-byte chunk index XOR the pixel's row-address bits
//   7-9 (CK 64) or 7-8 (CK 32)), and issues wgmma m64nNk16 in its
//   register-A form. The fragments are double-buffered: k-block kb + 1's
//   ldmatrix runs while kb's wgmmas do (wait_group 1). (Triple buffering,
//   wait_group 2, measured slower for K14 in development.)
// - B through TMA. The wrapper packs the HWIO kernel into
//   [tap][chunk][Cout_pad][CK] bf16 (K-major B, zeros past Cin and Cout),
//   with the tiles' swizzle. Two ways to hold it, chosen at launch by what
//   fits in shared memory:
//   - resident (one Cout tile, and the whole kernel fits, as for K14's
//     narrow convolutions): the producer loads every (tap, chunk) tile once
//     per block, and from then on issues halo copies only, up to four tiles
//     ahead, so HBM keeps streaming; the weights are never re-read;
//   - a ring of mbarrier-guarded stages (K13/K15's wide kernels: 295 KB at
//     128 -> 128, 3x3) that the producer streams (tap, chunk) tiles
//     through, from L2, with two halo stages: four stages, or as many down
//     to two as fit beside the largest halo boxes (5x5 at dilation 2 with
//     64-channel chunks and N = 128 takes three).
//   wgmma reads B through shared-memory descriptors.
// - Warp specialisation. Block = one producer warpgroup (one thread issues
//   every TMA copy; setmaxnreg gives its registers away) + two consumer
//   warpgroups, each owning 128 rows of M (two m64 accumulators of N f32 per
//   thread). Full and empty mbarriers both ways.
// - A persistent grid, one block per SM, walks the tiles (Cout tile
//   fastest, then tile column, tile row, image), so the producer loads the
//   next tile while the consumers run the last one's epilogue.
// - Epilogue: f32 bias, ReLU, __float2bfloat16_rn into a per-warp staging
//   tile in shared memory (16-byte chunks XOR-swizzled by pixel), then whole
//   16-byte NHWC stores, masked at the ragged H and W edges and at Cout.
//   Storing the accumulator fragments straight to global memory (4 bytes a
//   lane, eight pixels a warp instruction) cost more than a quarter of the
//   kernel's time.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTH = 16, kTW = 16;  // output tile: M = 256 pixels
constexpr int kMaxHaloStages = 4;
constexpr int kMaxRingStages = 4;  // B ring stages when the weights are not resident
constexpr int kThreads = 384;      // producer warpgroup + two consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block can use

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

// Shared-memory matrix descriptor of a K-major tile of CK-element (2*CK-byte)
// rows with the matching swizzle: CK 64 the 128-byte swizzle (layout 1),
// 8-row groups 1024 B apart; CK 32 the 64-byte swizzle (layout 2), 8-row
// groups 512 B apart (SBO). LBO is unused (1).
template <int CK>
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr) {
  constexpr uint64_t kLayout = CK == 64 ? 1 : 2;
  constexpr uint64_t kSbo = 8 * CK * 2;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((kSbo >> 4) << 32) | (kLayout << 62);
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

// A of one k-block: [m64][k16 step][registers].
template <int KK>
using Frags = uint32_t[2][KK][4];

template <int KK>
__device__ __forceinline__ void fence_frags(Frags<KK>& f) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(f[j][kk][r])::"memory");
}

// The lane's rows of both m64 halves for one tap: pixel `pix` of the halo
// (m64 1 is 4 tile rows, 4 * box_w halo pixels, further), k16 step kk in
// 16-byte chunks 2kk and 2kk + 1, each at its swizzled place: the chunk
// index XOR address bits 7-9 of the pixel's row (CK 64: pix mod 8) or bits
// 7-8 (CK 32: (pix / 2) mod 4).
template <int CK>
__device__ __forceinline__ void load_frags(Frags<CK / 16>& f, uint32_t halo, int pix, int box_w, int khalf) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int p = pix + 4 * j * box_w;
    const uint32_t row = halo + p * (CK * 2);
    const int sw = CK == 64 ? (p & 7) : ((p >> 1) & 3);
#pragma unroll
    for (int kk = 0; kk < CK / 16; ++kk) ldmatrix_x4(f[j][kk], row + (((2 * kk + khalf) ^ sw) << 4));
  }
}

struct WgArgs {
  int H, W, cin, cout, cout_pad, kh, kw, dil, pad_t, pad_l, relu, n_chunks, tiles_x, tiles_y, co_tiles, n_tiles;
  int cin_g;           // input channels a Cout tile reads (Cin / groups)
  int group_tiles;     // Cout tiles per group
  int box_w, box_h;    // halo box: 16 + (kw-1)*dil by 16 + (kh-1)*dil pixels
  int halo_bytes;      // one box, CK * box_w * box_h * 2
  int halo_stride;     // its shared-memory stage, rounded up to 1024 B
  int halo_stages;     // 2..4
  int resident;        // 1: every B tile loaded once; 0: a ring of b_stages
  int b_stages;        // 2..4 (ring only)
  int out_f32;         // 1: the output is f32 (sum + bias, ReLU), not rounded to bf16
};

// A tile's coordinates: Cout tile (fastest), tile column, tile row, image.
// A block walks tiles blockIdx.x, + gridDim.x, ...: the first is split by
// division once, and each step adds gridDim.x's own digits with carries, so
// no division sits between one tile and the next.
struct TileCoord {
  int ct, tx, ty, b;
  __device__ TileCoord(int tile, const WgArgs& a) {
    ct = tile % a.co_tiles;
    tile /= a.co_tiles;
    tx = tile % a.tiles_x;
    tile /= a.tiles_x;
    ty = tile % a.tiles_y;
    b = tile / a.tiles_y;
  }
  __device__ void advance(const TileCoord& step, const WgArgs& a) {
    int carry;
    ct += step.ct;
    carry = ct >= a.co_tiles;
    if (carry) ct -= a.co_tiles;
    tx += step.tx + carry;
    carry = tx >= a.tiles_x;
    if (carry) tx -= a.tiles_x;
    ty += step.ty + carry;
    carry = ty >= a.tiles_y;
    if (carry) ty -= a.tiles_y;
    b += step.b + carry;
  }
};

template <int N, int CK>
struct Tile {
  static constexpr int kBBytes = N * CK * 2;     // one (tap, chunk) B tile
  static constexpr int kEpiBytes = kTW * N * 2;  // one warp's 16 output pixels in bf16
};

// Dynamic shared memory of a launch: alignment slack, the halo stages, the B
// tiles (all of them, or the ring), the 8 consumer warps' epilogue staging
// and 4 x 4 barriers.
template <int N, int CK>
int smem_bytes(const WgArgs& a) {
  using T = Tile<N, CK>;
  const int b_tiles = a.resident ? a.kh * a.kw * a.n_chunks : a.b_stages;
  return 1024 + a.halo_stages * a.halo_stride + b_tiles * T::kBBytes + (kConsumerThreads / 32) * T::kEpiBytes +
         8 * 4 * kMaxHaloStages;
}

template <int N, int CK>
__global__ void __launch_bounds__(kThreads, 1)
    conv_wgmma_bf16_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                           const float* __restrict__ bias, void* __restrict__ out, const WgArgs a) {
  using T = Tile<N, CK>;
  constexpr int KK = CK / 16;  // k16 steps per k-block
  extern __shared__ uint8_t smem_raw[];
  const int taps = a.kh * a.kw;
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t halo0 = base;
  const uint32_t b0 = halo0 + a.halo_stages * a.halo_stride;
  const uint32_t epi0 = b0 + (a.resident ? taps * a.n_chunks : a.b_stages) * T::kBBytes;
  const uint32_t bars = epi0 + (kConsumerThreads / 32) * T::kEpiBytes;
  // Barriers: halo full [4], halo empty [4], B full [4], B empty [4]. With
  // resident weights only B full [0] is used, once.
  const uint32_t h_full = bars, h_empty = bars + 8 * kMaxHaloStages;
  const uint32_t b_full = bars + 16 * kMaxHaloStages, b_empty = b_full + 8 * kMaxRingStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.halo_stages; ++s) {
      mbar_init(h_full + 8 * s, 1);
      mbar_init(h_empty + 8 * s, kConsumerThreads);
    }
    for (int s = 0; s < kMaxRingStages; ++s) {
      mbar_init(b_full + 8 * s, 1);
      mbar_init(b_empty + 8 * s, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // Producer warpgroup: one thread issues every copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x != 0) return;
    if (a.resident) {  // every (tap, chunk) tile, once: rows (tap * n_chunks + chunk) * cout_pad
      const int n_b = taps * a.n_chunks;
      mbar_expect_tx(b_full, n_b * T::kBBytes);
      for (int s = 0; s < n_b; ++s) tma_load_2d(b0 + s * T::kBBytes, &wmap, b_full, 0, s * a.cout_pad);
    }
    int hs = 0, hph = 0, bs = 0, bph = 0;
    const TileCoord step(gridDim.x, a);
    TileCoord tc(blockIdx.x, a);
    for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x, tc.advance(step, a)) {
      const int x0 = tc.tx * kTW - a.pad_l, y0 = tc.ty * kTH - a.pad_t, co0 = tc.ct * N, b = tc.b;
      // The group's first input channel; one group skips the division,
      // which K14's byte-bound producer feels.
      const int ci0 = a.group_tiles == a.co_tiles ? 0 : (tc.ct / a.group_tiles) * a.cin_g;
      for (int c = 0; c < a.n_chunks; ++c) {
        mbar_wait(h_empty + 8 * hs, hph ^ 1);
        mbar_expect_tx(h_full + 8 * hs, a.halo_bytes);
        tma_load_4d(halo0 + hs * a.halo_stride, &xmap, h_full + 8 * hs, ci0 + c * CK, x0, y0, b);
        if (++hs == a.halo_stages) hs = 0, hph ^= 1;
        if (a.resident) continue;
        for (int t = 0; t < taps; ++t) {
          mbar_wait(b_empty + 8 * bs, bph ^ 1);
          mbar_expect_tx(b_full + 8 * bs, T::kBBytes);
          tma_load_2d(b0 + bs * T::kBBytes, &wmap, b_full + 8 * bs, 0, (t * a.n_chunks + c) * a.cout_pad + co0);
          if (++bs == a.b_stages) bs = 0, bph ^= 1;
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
  const int pix0 = (8 * g + warp) * a.box_w + (q & 1) * 8 + (lane & 7);
  const int khalf = q >> 1;
  int hs = 0, hph = 0, bs = 0, bph = 0;
  if (a.resident) mbar_wait(b_full, 0);

  const TileCoord step(gridDim.x, a);
  TileCoord tc(blockIdx.x, a);
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x, tc.advance(step, a)) {
    const int ct = tc.ct, tx = tc.tx, ty = tc.ty, b = tc.b;

    float acc[2][N / 2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[j][i] = 0.f;

    // K-blocks (chunk, tap) in order. Each step issues k-block kb's wgmmas
    // from `cur`, retires kb - 1 (its B stage and its fragment registers)
    // and loads kb + 1's fragments into them while kb's wgmmas run. The tap
    // (u, v) advances by counters, keeping a division by kw off the path
    // from one k-block's wgmmas to the next.
    const int nkb = a.n_chunks * taps;
    Frags<KK> fa, fb;
    int c = 0, t = 0, u = 0, v = 0;  // chunk, tap (u, v) of the k-block whose fragments were loaded last
    mbar_wait(h_full + 8 * hs, hph);
    load_frags<CK>(fa, halo0 + hs * a.halo_stride, pix0, a.box_w, khalf);
    auto step = [&](Frags<KK>& cur, Frags<KK>& nxt, int kb) {
      uint32_t btile;
      if (a.resident) {
        btile = b0 + (t * a.n_chunks + c) * T::kBBytes;
      } else {
        mbar_wait(b_full + 8 * bs, bph);
        btile = b0 + bs * T::kBBytes;
      }
      const uint64_t desc = sw_desc<CK>(btile);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
        for (int j = 0; j < 2; ++j) wgmma_rs<N>(acc[j], cur[j][kk], desc + 2 * kk);  // +32 B per k16
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_frags<KK>(nxt);
      if (!a.resident) {
        if (kb > 0) mbar_arrive(b_empty + 8 * (bs == 0 ? a.b_stages - 1 : bs - 1));
        if (++bs == a.b_stages) bs = 0, bph ^= 1;
      }
      if (++v == a.kw) v = 0, ++u;
      if (++t == taps) {  // kb + 1 starts a chunk: kb's halo has been read
        t = 0;
        u = 0;
        ++c;
        mbar_arrive(h_empty + 8 * hs);
        if (++hs == a.halo_stages) hs = 0, hph ^= 1;
        if (kb + 1 < nkb) mbar_wait(h_full + 8 * hs, hph);
      }
      if (kb + 1 < nkb) {
        load_frags<CK>(nxt, halo0 + hs * a.halo_stride, pix0 + (u * a.box_w + v) * a.dil, a.box_w, khalf);
      }
    };
    for (int kb = 0; kb < nkb; kb += 2) {
      step(fa, fb, kb);
      if (kb + 1 < nkb) step(fb, fa, kb + 1);
    }
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    fence_frags<KK>(fa);
    fence_frags<KK>(fb);
    if (!a.resident) mbar_arrive(b_empty + 8 * (bs == 0 ? a.b_stages - 1 : bs - 1));
    // Epilogue, per m64 half: the warp rounds its 16 pixels x N channels
    // (f32 + bias, ReLU, then bf16) into its staging tile, 16-byte chunks
    // XOR-swizzled by pixel so neither side conflicts on banks, and stores
    // them as whole chunks: consecutive lanes on consecutive chunks of one
    // pixel, consecutive pixels after. Accumulator i of an m64: n8 group
    // i / 4, pixel lane / 4 (+8 for i % 4 >= 2), channels 2 (lane % 4) + i % 2.
    constexpr int kChunks = N / 8;  // 16-byte chunks per pixel
    constexpr int kSwz = kChunks < 8 ? kChunks - 1 : 7;
    constexpr int kPixPerStore = 32 / kChunks;
    uint8_t* stage = smem_raw + (epi0 - smem_u32(smem_raw)) + (4 * g + warp) * T::kEpiBytes;
    const int co_l = ct * N + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int gy = ty * kTH + 8 * g + 4 * j + warp;
      if (a.out_f32) {
        // f32 out: each lane stores its channel pairs straight from the
        // accumulators (8 B a lane, four lanes cover a 32-byte sector).
        if (gy < a.H) {
          float* orow = reinterpret_cast<float*>(out) + ((size_t)b * a.H + gy) * a.W * (size_t)a.cout;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int gx = tx * kTW + (lane >> 2) + 8 * h;
            if (gx >= a.W) continue;
#pragma unroll
            for (int n8 = 0; n8 < kChunks; ++n8) {
              const int co = co_l + 8 * n8;
              if (co >= a.cout) continue;
              const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + co));  // padded to cout_pad
              float v0 = acc[j][4 * n8 + 2 * h] + bv.x, v1 = acc[j][4 * n8 + 2 * h + 1] + bv.y;
              if (a.relu) v0 = fmaxf(v0, 0.f), v1 = fmaxf(v1, 0.f);
              float* o = orow + (size_t)gx * a.cout + co;
              if (a.cout % 2 == 0) {
                *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
              } else {
                o[0] = v0;
                if (co + 1 < a.cout) o[1] = v1;
              }
            }
          }
        }
        continue;
      }
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
      if (gy < a.H) {
        const int ch = lane % kChunks, co = ct * N + 8 * ch;
#pragma unroll
        for (int m = 0; m < kTW / kPixPerStore; ++m) {
          const int px = m * kPixPerStore + lane / kChunks, gx = tx * kTW + px;
          if (gx >= a.W || co >= a.cout) continue;
          const uint4 v = *reinterpret_cast<const uint4*>(stage + px * (N * 2) + ((ch ^ (px & kSwz)) << 4));
          __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(out) + (((size_t)b * a.H + gy) * a.W + gx) * a.cout + co;
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

// Chooses how the B tiles are held and how many stages fit: resident
// weights with as many halo stages as fit (4 down to 2) where there is one
// Cout tile, else two halo stages and a ring of as many B stages as fit (4
// down to 2). Every call make_args takes fits (the largest, a 24x24 box of
// 64 channels at N = 128, with three B stages); -1 would mean none does.
template <int N, int CK>
int plan(WgArgs& a) {
  a.b_stages = 0;
  if (a.co_tiles == 1) {
    a.resident = 1;
    for (a.halo_stages = kMaxHaloStages; a.halo_stages >= 2; --a.halo_stages) {
      if (smem_bytes<N, CK>(a) <= kMaxSmem) return smem_bytes<N, CK>(a);
    }
  }
  a.resident = 0;
  a.halo_stages = 2;
  for (a.b_stages = kMaxRingStages; a.b_stages >= 2; --a.b_stages) {
    if (smem_bytes<N, CK>(a) <= kMaxSmem) return smem_bytes<N, CK>(a);
  }
  return -1;
}

template <int N, int CK>
int launch(const void* x, const void* w, const void* bias, void* out, int batch, WgArgs a, void* stream) {
  const int smem = plan<N, CK>(a);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kNoEncoder;
  constexpr CUtensorMapSwizzle kSwizzle = CK == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdim[4] = {(cuuint64_t)a.cin, (cuuint64_t)a.W, (cuuint64_t)a.H, (cuuint64_t)batch};
  const cuuint64_t xstride[3] = {(cuuint64_t)a.cin * 2, (cuuint64_t)a.W * a.cin * 2, (cuuint64_t)a.H * a.W * a.cin * 2};
  const cuuint32_t xbox[4] = {CK, (cuuint32_t)a.box_w, (cuuint32_t)a.box_h, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult res = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), xdim, xstride, xbox, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, kSwizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return kEncodeFailed + (int)res;
  const cuuint64_t wrows = (cuuint64_t)a.kh * a.kw * a.n_chunks * a.cout_pad;
  const cuuint64_t wdim[2] = {CK, wrows};
  const cuuint64_t wstride[1] = {CK * 2};
  const cuuint32_t wbox[2] = {CK, N};
  res = encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), wdim, wstride, wbox, ones,
               CU_TENSOR_MAP_INTERLEAVE_NONE, kSwizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return kEncodeFailed + (int)res;

  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv_wgmma_bf16_kernel<N, CK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = a.n_tiles < sms ? a.n_tiles : sms;
  conv_wgmma_bf16_kernel<N, CK><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      xmap, wmap, (const float*)bias, out, a);
  return (int)cudaGetLastError();
}

// The arguments of a call, without its plan; false where the kernel does
// not take it. groups > 1 takes whole K chunks and whole Cout tiles per
// group: (cin / groups) % ck == 0, so no halo box straddles two groups, and
// cout = cout_pad a multiple of groups * n_tile.
bool make_args(WgArgs& a, int H, int W, int cin, int cout, int cout_pad, int kh, int kw, int dil, int pad_t,
               int pad_l, int relu, int n_tile, int ck, int groups, int batch) {
  if (cin % 8 != 0 || kh < 1 || kh > 5 || kw < 1 || kw > 5 || dil < 1 || dil > 2 || (ck != 32 && ck != 64) ||
      (n_tile != 32 && n_tile != 64 && n_tile != 128) || cout_pad % n_tile != 0 || groups < 1 || cin % groups != 0)
    return false;
  const int cin_g = cin / groups;
  if (groups > 1 && (cin_g % ck != 0 || cout != cout_pad || cout_pad % (groups * n_tile) != 0)) return false;
  a = WgArgs{H, W, cin, cout, cout_pad, kh, kw, dil, pad_t, pad_l, relu, (cin_g + ck - 1) / ck, (W + kTW - 1) / kTW,
             (H + kTH - 1) / kTH, cout_pad / n_tile, 0, cin_g, cout_pad / n_tile / groups, kTW + (kw - 1) * dil,
             kTH + (kh - 1) * dil, 0, 0, 0, 0, 0};
  a.n_tiles = batch * a.tiles_y * a.tiles_x * a.co_tiles;
  a.halo_bytes = ck * a.box_w * a.box_h * 2;
  a.halo_stride = (a.halo_bytes + 1023) / 1024 * 1024;  // the swizzle atoms stay aligned
  return true;
}

}  // namespace

extern "C" {

// x [batch, H, W, cin] bf16, cin % 8 == 0, 16-byte aligned; w the packed
// kernel [kh * kw, n_chunks, cout_pad, ck] bf16 of an HWIO kernel [kh, kw,
// cin / groups, cout] (ck 32 or 64, n_chunks = ceil(cin / groups / ck),
// zeros past its input channels and cout); bias f32 [cout_pad]; out
// [batch, H, W, cout] bf16, or f32 where out_f32. Kernels up to 5x5,
// dilation 1 or 2, low padding pad_t, pad_l (the box covers the rest).
// n_tile (32, 64 or 128) divides cout_pad; groups as make_args takes them.
int conv_wgmma_bf16(const void* x, const void* w, const void* bias, void* out, int batch, int H, int W, int cin,
                    int cout, int cout_pad, int kh, int kw, int dil, int pad_t, int pad_l, int relu, int n_tile,
                    int ck, int groups, int out_f32, void* stream) {
  WgArgs a;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      !make_args(a, H, W, cin, cout, cout_pad, kh, kw, dil, pad_t, pad_l, relu, n_tile, ck, groups, batch))
    return (int)cudaErrorInvalidValue;
  a.out_f32 = out_f32 != 0;
#define CONV_WGMMA_CASE(NT, CK_) \
  if (n_tile == NT && ck == CK_) return launch<NT, CK_>(x, w, bias, out, batch, a, stream);
  CONV_WGMMA_CASE(32, 32)
  CONV_WGMMA_CASE(64, 32)
  CONV_WGMMA_CASE(128, 32)
  CONV_WGMMA_CASE(32, 64)
  CONV_WGMMA_CASE(64, 64)
  CONV_WGMMA_CASE(128, 64)
#undef CONV_WGMMA_CASE
  return (int)cudaErrorInvalidValue;
}

// The plan of a call: plan_out = {dynamic shared memory in bytes, halo
// stages, B ring stages (0: the weights are resident)}. Returns 0, or -1
// where the kernel does not take the call.
int conv_wgmma_plan(int cin, int cout_pad, int kh, int kw, int dil, int n_tile, int ck, int groups, int* plan_out) {
  WgArgs a;
  if (!make_args(a, 16, 16, cin, cout_pad, cout_pad, kh, kw, dil, 0, 0, 0, n_tile, ck, groups, 1)) return -1;
  int smem = -1;
  if (ck == 32) {
    smem = n_tile == 32 ? plan<32, 32>(a) : n_tile == 64 ? plan<64, 32>(a) : plan<128, 32>(a);
  } else {
    smem = n_tile == 32 ? plan<32, 64>(a) : n_tile == 64 ? plan<64, 64>(a) : plan<128, 64>(a);
  }
  if (smem < 0) return -1;
  plan_out[0] = smem;
  plan_out[1] = a.halo_stages;
  plan_out[2] = a.resident ? 0 : a.b_stages;
  return 0;
}

}  // extern "C"
