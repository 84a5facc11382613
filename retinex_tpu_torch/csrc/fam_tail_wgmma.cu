// K6's dense instance in bf16 on Hopper's tensor cores (wgmma), for
// sm_90a, behind a plain C interface.
//
// Replaces, for bf16 activations and a dense w,
// retinex_tpu/ops/fused_blocks.py::_tail_apply_g1_kernel (pallas_call in
// fam_tail_apply_g1): out = bf16((bf16(bf16(x * ca) * sa of the pixel's
// quadrant)) @ w), x [n_pix, 128] bf16, ca [B, 128] f32 (rounded to bf16
// inside, as the JAX kernel casts it to x.dtype), sa [n_pix, 4] bf16, w
// [128, Cout] f32 (Cout a multiple of 4 up to 128), the product summed in
// f32 and rounded to bf16 once. The quadrant-diagonal w of the packed
// model's fusion folds runs on fam_tail_apply_g1_mma_kernel
// (csrc/fam_fused.cu); every other bf16 call of fam_tail_apply_g1 runs here
// (retinex_tpu_torch/ops/fused_blocks.py).
//
// Bound on the card: bytes. A pixel moves 520 B at Cout 128 (x 256 and sa
// 8 in, out 256): 0.0861 ms per 1088x1920 image (554,880 packed pixels) at
// 3.35 TB/s. The product must be exact against the f32 w, so it runs on w's
// three bf16 pieces (w0 = bf16(w), w1 = bf16(w - w0), w2 = w - w0 - w1, each
// product with a bf16 x exact in f32): 98,304 tensor FLOP a pixel, 54.5
// GFLOP an image, 0.055 ms at 989 TFLOP/s. On the CUDA cores the 32,768
// FLOP a pixel of the f32 product alone take 0.2735 ms an image at 67
// TFLOP/s, three times the byte bound, and mma.sync's rate would about tie
// with the bytes; wgmma's leaves the bytes the bound.
//
// Design:
// - A persistent grid, one 384-thread block per SM: a producer warpgroup
//   (one thread issues every copy; setmaxnreg gives its registers away) and
//   two consumer warpgroups. The block's tiles of 64 packed pixels go to the
//   consumers in turn.
// - B, resident: w's three bf16 pieces, [3 pieces][2 k chunks of 64][N
//   columns][64 k] bf16, N = Cout rounded up to 32, 64 or 128 (zero columns
//   past Cout), in wgmma's K-major layout with the 128-byte swizzle (each
//   128-byte row's 16-byte chunk c stored at chunk c ^ (row & 7)). The
//   wrapper makes it (fused_blocks.tail_g1_wgmma_b: once per model in
//   pack_tail_g1, or on the call for an unpacked w) already swizzled, so
//   one bulk copy per (piece, chunk) tile brings it in: 96 KB at N = 128,
//   read once per block. Its columns are the output channels permuted as
//   fused_blocks.mma_channels permutes them, so that a lane's accumulator
//   pairs of four n8 tiles are eight consecutive channels.
// - x through TMA: a 2-D tensor map over [n_pix, 128] bf16, two 64-channel
//   boxes a tile (8 KB each, the 128-byte swizzle), into a ring of eight
//   16-KB stages guarded by full and empty mbarriers. The rows past n_pix
//   of the last tile are TMA's zero fill and are never stored.
// - A from registers. Each consumer warp loads its 16 rows of raw x with
//   eight ldmatrix.x4 (the A fragment of wgmma m64nNk16 in registers is
//   mma.sync m16n8k16's, warp w of the warpgroup holding rows 16w..16w+15),
//   frees the stage, and scales the fragments in registers with the plain
//   version's two roundings: bf16x2 multiplies by bf16(ca), then by the sa
//   of the channel's quadrant (sa read from global memory, 8 B a row).
// - 8 k16 steps x 3 pieces of wgmma.mma_async m64nNk16 into N / 2 f32
//   accumulators a thread, in that order (each k step's three pieces), then
//   one wait.
// - ca is per image: a lane keeps the bf16 ca of its channels for the image
//   of the rows it last scaled and reloads it where its rows cross into the
//   next image (a lane's rows only grow).
// - Epilogue: each lane rounds its rows' eight consecutive channels of each
//   32-column block to bf16 and stores them as one 16-byte chunk (two
//   8-byte ones where Cout is not a multiple of 8; one 8-byte one for the
//   last four channels of such a Cout), only the Cout channels.
// - The products are exact in f32 and summed in the tensor cores' order,
//   not the plain version's: an output next to a bf16 rounding boundary may
//   round the other way, one bf16 ulp.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 128;                    // packed FAM width: 4 quadrants x 32 channels
constexpr int kM = 64;                     // packed pixels a tile: one m64 of one consumer warpgroup
constexpr int kConsumers = 2;              // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kStages = 8;                 // x tiles in the ring
constexpr int kBoxBytes = kM * 64 * 2;     // one 64-channel box of a tile, 8 KB
constexpr int kXBytes = 2 * kBoxBytes;     // one tile of x, 16 KB
constexpr int kPieces = 3;
constexpr int kMaxSmem = 232448;           // dynamic shared memory a block can use
static_assert(kStages % kConsumers == 0, "a stage always serves the same consumer warpgroup");

// B: [3 pieces][2 k chunks][N][64] bf16, 128 bytes a column's row.
template <int N>
__host__ __device__ constexpr int b_bytes() {
  return kPieces * 2 * N * 128;
}
// Alignment slack, B, the ring, full and empty barriers per stage and B's.
template <int N>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + b_bytes<N>() + kStages * kXBytes + 8 * (2 * kStages + 1);
}
static_assert(smem_bytes<128>() <= kMaxSmem, "B at N = 128 and the ring fit in one block's shared memory");

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

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// A contiguous copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Shared-memory matrix descriptor of a K-major tile of 64-element (128-byte)
// rows with the 128-byte swizzle (layout 1), 8-row groups 1024 B apart
// (SBO); LBO is unused (1).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

// D[64 x N] += A[64 x 16] (registers) x B[16 x N] (shared memory, K-major,
// descriptor), f32 accumulators.
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
__device__ __forceinline__ void fence_frags(uint32_t (&f)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(f[kk][r])::"memory");
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) { return *reinterpret_cast<const uint32_t*>(&v); }
__device__ __forceinline__ __nv_bfloat162 as_bf16x2(uint32_t v) { return *reinterpret_cast<const __nv_bfloat162*>(&v); }
// Two f32 rounded to bf16, the first in the low half (the lower address).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) { return bf16x2_bits(__floats2bfloat162_rn(lo, hi)); }
// bf16(bf16(v * c) * s), lane by lane, on two bf16 pairs.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, uint32_t c, uint32_t s) {
  return bf16x2_bits(__hmul2(__hmul2(as_bf16x2(v), as_bf16x2(c)), as_bf16x2(s)));
}
// Quadrant q's sa of a pixel (its four bf16 in `s`) in both halves.
__device__ __forceinline__ uint32_t sa_pair(uint2 s, int q) {
  return __byte_perm(q < 2 ? s.x : s.y, 0, (q & 1) ? 0x3232 : 0x1010);
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    fam_tail_apply_g1_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ ca,
                                   const __nv_bfloat16* __restrict__ sa, const __nv_bfloat16* __restrict__ wb,
                                   __nv_bfloat16* __restrict__ out, long long hw, int n_pix, int cout, int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle atoms need 1024-byte alignment
  const uint32_t b0 = base;                                    // B [3][2][N][64]
  const uint32_t x0 = b0 + b_bytes<N>();                       // the ring: kStages x [2 boxes][64 px][64 ch]
  const uint32_t bars = x0 + kStages * kXBytes;
  const uint32_t full = bars, empty = bars + 8 * kStages, b_full = bars + 16 * kStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128);  // the consumer warpgroup that reads the stage
    }
    mbar_init(b_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer warpgroup: one thread issues every copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x != 0) return;
    mbar_expect_tx(b_full, b_bytes<N>());
    for (int i = 0; i < 2 * kPieces; ++i) bulk_load(b0 + i * N * 128, wb + i * N * 64, N * 128, b_full);
    int j = 0;  // the block's tile count: tile j lands in stage j % kStages
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++j) {
      const int s = j % kStages;
      mbar_wait(empty + 8 * s, ((j / kStages) & 1) ^ 1);
      mbar_expect_tx(full + 8 * s, kXBytes);
      tma_load_2d(x0 + s * kXBytes, &xmap, full + 8 * s, 0, tile * kM);
      tma_load_2d(x0 + s * kXBytes + kBoxBytes, &xmap, full + 8 * s, 64, tile * kM);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int c = wg - 1, tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  // ldmatrix.x4 of a k16 step: lanes 0-15 give rows 0-15 at its first 8
  // channels, lanes 16-31 the same rows at the next 8; the warp's row in the
  // tile and its 16-byte chunk's swizzle.
  const int arow = 16 * warp + (lane & 15), khalf = lane >> 4, swz = lane & 7;
  // The bf16 ca of channels 16 kk + 8 h + 2 tq, +1 of the image that ends at
  // img_end (none yet).
  long long img_end = -1;
  uint32_t cab[8][2];
  auto ensure_ca = [&](int p) {
    if (p >= img_end) {  // the first row, or the next image (past n_pix: the last image's)
      const long long img = (long long)min(p, n_pix - 1) / hw;
      img_end = (img + 1) * hw;
      const float* cp = ca + img * kC + 2 * tq;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 v = __ldg(reinterpret_cast<const float2*>(cp + 16 * kk + 8 * h));
          cab[kk][h] = pack_bf16x2(v.x, v.y);
        }
    }
  };
  mbar_wait(b_full, 0);

  int j = c;
#pragma unroll 1
  for (int tile = blockIdx.x + c * gridDim.x; tile < n_tiles; tile += kConsumers * gridDim.x, j += kConsumers) {
    const int s = j % kStages;
    const int row0 = tile * kM + 16 * warp + g;  // this lane's rows: row0 and row0 + 8
    uint2 sav[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      sav[hr] = __ldg(reinterpret_cast<const uint2*>(sa + (size_t)min(row0 + 8 * hr, n_pix - 1) * 4));
    mbar_wait(full + 8 * s, (j / kStages) & 1);

    // A: [k16 step kk][row g, k 2tq..; row g + 8; row g, k 8 + 2tq..; row g + 8].
    uint32_t a[8][4];
    const uint32_t xs = x0 + s * kXBytes + arow * 128;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      ldmatrix_x4(a[kk], xs + (kk >> 2) * kBoxBytes + (((2 * (kk & 3) + khalf) ^ swz) << 4));
    // The scaling, row g then row g + 8 (ca reloaded between them where they
    // lie in two images).
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      ensure_ca(row0 + 8 * hr);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t s2 = sa_pair(sav[hr], kk >> 1);
        a[kk][hr] = scale_bf16x2(a[kk][hr], cab[kk][0], s2);
        a[kk][2 + hr] = scale_bf16x2(a[kk][2 + hr], cab[kk][1], s2);
      }
    }
    mbar_arrive(empty + 8 * s);  // the fragments are in registers: the stage is free

    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int i = 0; i < kPieces; ++i)
        wgmma_rs<N>(acc, a[kk], sw128_desc(b0 + (2 * i + (kk >> 2)) * N * 128) + 2 * (kk & 3));  // +32 B a k16 step
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    fence_frags(a);

    // Accumulator 4 jn + 2 hr + e: n8 tile jn, row g + 8 hr, column 8 jn + 2
    // tq + e; with jn = 4 blk + s that column computes channel 32 blk + 8 tq
    // + 2 s + e.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int p = row0 + 8 * hr;
      if (p >= n_pix) continue;
      __nv_bfloat16* op = out + (size_t)p * cout;
#pragma unroll
      for (int blk = 0; blk < N / 32; ++blk) {
        const int co = 32 * blk + 8 * tq;
        if (co >= cout) break;
        uint32_t v[4];
#pragma unroll
        for (int s4 = 0; s4 < 4; ++s4)
          v[s4] = pack_bf16x2(acc[4 * (4 * blk + s4) + 2 * hr], acc[4 * (4 * blk + s4) + 2 * hr + 1]);
        if (co + 8 <= cout && cout % 8 == 0) {
          *reinterpret_cast<uint4*>(op + co) = make_uint4(v[0], v[1], v[2], v[3]);
        } else {
          *reinterpret_cast<uint2*>(op + co) = make_uint2(v[0], v[1]);
          if (co + 8 <= cout) *reinterpret_cast<uint2*>(op + co + 4) = make_uint2(v[2], v[3]);
        }
      }
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

// Error codes past the runtime's: the encoder is missing, or refused the map
// (kEncodeFailed + its CUresult).
constexpr int kNoEncoder = 10000;
constexpr int kEncodeFailed = 20000;

template <int N>
int launch(const void* x, const void* ca, const void* sa, const void* w, void* out, int n_pix, long long hw,
           int cout, void* stream) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kNoEncoder;
  CUtensorMap xmap;
  const cuuint64_t xdim[2] = {(cuuint64_t)kC, (cuuint64_t)n_pix};
  const cuuint64_t xstride[1] = {(cuuint64_t)kC * 2};
  const cuuint32_t xbox[2] = {64, kM};
  const cuuint32_t ones[2] = {1, 1};
  const CUresult res = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), xdim, xstride, xbox,
                              ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return kEncodeFailed + (int)res;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fam_tail_apply_g1_wgmma_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<N>());
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n_pix + kM - 1) / kM;
  const int grid = n_tiles < sms ? n_tiles : sms;
  fam_tail_apply_g1_wgmma_kernel<N><<<grid, kThreads, smem_bytes<N>(), (cudaStream_t)stream>>>(
      xmap, (const float*)ca, (const __nv_bfloat16*)sa, (const __nv_bfloat16*)w, (__nv_bfloat16*)out, hw, n_pix,
      cout, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [batch, hw, 128] bf16 (16-byte aligned), ca [batch, 128] f32 (8-byte
// aligned), sa [batch, hw, 4] bf16 (8-byte aligned), out [batch, hw, cout]
// bf16 (16-byte aligned), cout a multiple of 4 in (n_tile / 2, n_tile] or,
// at n_tile 32, in [4, 32]; w the B image of fused_blocks.tail_g1_wgmma_b,
// [3, 2, n_tile, 64] bf16 (16-byte aligned), n_tile 32, 64 or 128.
// batch * hw below 2^31 - 64.
int fam_tail_apply_g1_wgmma(const void* x, const void* ca, const void* sa, const void* w, void* out, long long batch,
                            long long hw, int cout, int n_tile, void* stream) {
  const long long n = batch * hw;
  if (n == 0) return 0;
  if (n < 0 || n > 0x7FFFFFFFLL - kM || hw <= 0 || cout % 4 != 0 || cout < 4 || cout > n_tile ||
      (n_tile > 32 && cout <= n_tile / 2) || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ca) % 8 != 0 || reinterpret_cast<uintptr_t>(sa) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  switch (n_tile) {
    case 32:
      return launch<32>(x, ca, sa, w, out, (int)n, hw, cout, stream);
    case 64:
      return launch<64>(x, ca, sa, w, out, (int)n, hw, cout, stream);
    case 128:
      return launch<128>(x, ca, sa, w, out, (int)n, hw, cout, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
