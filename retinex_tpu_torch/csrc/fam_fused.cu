// FAM kernels for Hopper (sm_90a), behind a plain C interface.
//
// Four kernels carry the packed (space-to-depth) EnhancedFAM of the scale-1
// and scale-2 towers on f32 or bf16 NHWC activations [B, H, W, 128], the 128
// channels being four quadrants of 32 (packed channel (a*2 + b)*32 + c):
//
//   fam_conv_out_kernel       K4's last stage: relu(z + x @ ka + maxpool(x) @
//                             kb) -> [B, H, W, 128], after K4's two 3x3
//                             convolutions (y, z) on conv_pipelined.cu (f32)
//                             or conv_wgmma.cu (bf16, z in f32); in bf16
//                             fam_conv_out_mma_kernel, on the tensor cores
//   fam_tail_stats_kernel     x * ca -> per-quadrant channel mean/max [B,H,W,8]
//   fam_tail_apply_g1_kernel  (x * ca * sa per quadrant) @ W -> [B,H,W,Cout]
//                             (templated: W dense or quadrant-block-diagonal,
//                             f32; bf16 with a diagonal W:
//                             fam_tail_apply_g1_mma_kernel; bf16 with a dense
//                             W: csrc/fam_tail_wgmma.cu)
//   fam_tail_apply_kernel     x * ca * sa per quadrant -> [B,H,W,128] (the
//                             tail where the tower's fusion does not fold)
//
// The Python wrappers (retinex_tpu_torch/ops/fused_blocks.py) check device,
// dtype, shape and contiguity, allocate every output, and pass PyTorch's
// current stream. Each launch function returns cudaGetLastError().
//
// Each function has an instance for the activations' element type T, f32
// or bf16 (K5 and K11 templated on T; fam_conv_out and tail_apply_g1 have
// f32 kernels and bf16 kernels of their own, named below, K6's dense bf16
// one in csrc/fam_tail_wgmma.cu); the bf16 instances, the --use_amp net's,
// round where the JAX
// kernels round their bf16 instances (a bf16 x bf16 product is exact in
// f32 and rounded to bf16 once, so it equals JAX's bf16 multiply):
//   fam_conv_out   x, ka, kb bf16; z f32 (K4 never rounds it); the products
//                  summed in f32; the output rounded once;
//   tail_stats     x * ca rounded; means and maxima in f32; output rounded;
//   tail_apply_g1  x * ca rounded, * sa rounded; the product with the f32 w
//                  in f32 (by its three bf16 pieces, whose products are
//                  exact); the output rounded;
//   tail_apply     x * ca rounded, * sa rounded.
// ca and w are f32 in both (ca is rounded to T inside, as the JAX kernels
// cast it to x.dtype); sa is in T. The f32 instances compute what they did
// before the templates, bit for bit.
//
// Arithmetic is f32 on the CUDA cores (no TF32, no tensor cores), but for
// two bf16 instances that run their products on the tensor cores
// (mma.sync bf16 x bf16 with f32 accumulation): fam_conv_out's
// (fam_conv_out_mma_kernel) and the quadrant-diagonal tail_apply_g1's
// (fam_tail_apply_g1_mma_kernel). The CUDA-core dot products call fmaf
// explicitly; the file builds with -fmad=false like the other sources,
// which only keeps the compiler from contracting anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kC = 128;  // packed FAM width: 4 quadrants x 32 channels
constexpr int kC4 = kC / 4;
constexpr int kQ = 32;   // channels per quadrant

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Loads, stores and rounding of one element type: four consecutive
// elements go through one 16-byte (f32) or 8-byte (bf16) access.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  __device__ static __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
  __device__ static __forceinline__ float4 gload4(const float* p) { return ldg4(p); }
  __device__ static __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
  __device__ static __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  __device__ static __forceinline__ float to_f(float v) { return v; }
  __device__ static __forceinline__ float from_f(float v) { return v; }
  __device__ static __forceinline__ float round(float v) { return v; }
};

template <>
struct Elem<__nv_bfloat16> {
  __device__ static __forceinline__ float4 unpack(uint2 r) {
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  __device__ static __forceinline__ float4 load4(const __nv_bfloat16* p) {
    return unpack(*reinterpret_cast<const uint2*>(p));
  }
  __device__ static __forceinline__ float4 gload4(const __nv_bfloat16* p) {
    return unpack(__ldg(reinterpret_cast<const uint2*>(p)));
  }
  __device__ static __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 r;
    r.x = *reinterpret_cast<const uint32_t*>(&lo);
    r.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = r;
  }
  __device__ static __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
  __device__ static __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __forceinline__ __nv_bfloat16 from_f(float v) { return __float2bfloat16_rn(v); }
  __device__ static __forceinline__ float round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
};

// Elements of T in one 16-byte chunk, and a shared-memory pixel row of 128
// channels padded by one chunk (consecutive pixels 4 banks apart).
template <typename T>
__host__ __device__ constexpr int chunk_elems() {
  return 16 / (int)sizeof(T);
}
template <typename T>
__host__ __device__ constexpr int px_stride() {
  return kC + chunk_elems<T>();
}

// ---------------------------------------------------------------------------
// K4, last stage. K4 replaces retinex_tpu/ops/fused_blocks.py::_fam_conv_kernel
// (pallas_call in fam_conv_fused), which computes on the packed post-ReLU FAM
// input x [B, H, W, 128]:
//
//   relu(x @ ka + maxpool3x3(x) @ kb + conv3(y3, k32) + conv3(y4, k42) + bt),
//   (y3 | y4) = relu(conv3(x, k1) + b1), y zero outside the image.
//
// On the card K4 is three launches (retinex_tpu_torch/ops/fused_blocks.py):
// y = relu(conv3(x, k1) + b1) and z = conv3(y, [k32; k42]) + bt on
// conv_pipelined.cu (its two 3x3 convolutions, 128 -> 256 and 256 -> 128,
// each at two thirds of the f32 rate; y goes through device memory once
// instead of being recomputed over every tile's halo), then this kernel:
//
//   out = relu(z + [x | maxpool3x3(x)] @ [ka; kb]).
//
// In bf16 y and z run on conv_wgmma.cu's tensor cores (z in its f32-output
// mode, since the JAX kernel never rounds it), and this stage on
// fam_conv_out_mma_kernel below. This kernel is the f32 instance.
//
// Bound on the card: operations - 2 * 256 * 128 FLOP per packed pixel
// against 1.5 KB moved (z and x in, out), 0.54 ms at 67 TFLOP/s for the
// 554,880 packed pixels of a 1088x1920 image.
// Design, conv_pipelined's: a block of 128 threads owns 4 x 16 packed pixels
// x 128 output channels; thread (pg, cg) owns 8 pixels of one tile row and
// channels 4cg..4cg+3 and 64+4cg..64+4cg+3, an 8 x 8 register outer product.
// The x tile with a halo of 1 comes into shared memory by cp.async (zeros
// outside the image), the block computes the pooled tile from it, then the K
// loop walks the 256 rows of [ka; kb] (x's centre channels, then the pooled
// ones) in chunks of 16, each staged by cp.async into one of two buffers
// while the other is read. 107,200 B of shared memory put two blocks on an
// SM, so one block's tile load, pooling and barriers run under the other's
// FMAs (8 x 16 tiles, one 179,008-B block per SM, measured slower).
// The 3x3 max pool is per ORIGINAL pixel, across quadrants: original row
// 2I + a + dr is packed row (2I + a + dr) >> 1, quadrant row (.. & 1). It
// relies on x >= 0 (the FAM input is post-ReLU), so the zero halo equals
// 'SAME' -inf padding.
// ---------------------------------------------------------------------------
constexpr int kOutTH = 4, kOutTW = 16;                          // output tile, packed pixels
constexpr int kOutHW = kOutTW + 2;                              // halo row
constexpr int kOutHaloPx = (kOutTH + 2) * kOutHW;               // 108
constexpr int kOutPix = kOutTH * kOutTW;                        // 64
constexpr int kWRows = 16;                                      // rows of [ka; kb] per stage
constexpr int kOutThreads = kOutTH * 32;                        // 16 threads per 8-pixel row half
constexpr int kOutBlocks = 2;                                   // blocks per SM the smem allows
// Shared memory: the x tile, the pooled tile (both px_stride<float>() a
// pixel) and two stages of [ka; kb] rows: 107,200 B.
constexpr size_t kOutSmem = sizeof(float) * ((size_t)(kOutHaloPx + kOutPix) * px_stride<float>() + 2 * kWRows * kC);
static_assert(kOutThreads == kOutPix / 8 * 16, "16 threads own 8 pixels' 128 channels");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// acc[0..7] += x[k] * (w[k][0] | w[k][1]) for four input channels k.
__device__ __forceinline__ void fma_px(float (&acc)[8], const float4 x, const float4 (&w)[4][2]) {
  const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc[0] = fmaf(xv[k], w[k][0].x, acc[0]);
    acc[1] = fmaf(xv[k], w[k][0].y, acc[1]);
    acc[2] = fmaf(xv[k], w[k][0].z, acc[2]);
    acc[3] = fmaf(xv[k], w[k][0].w, acc[3]);
    acc[4] = fmaf(xv[k], w[k][1].x, acc[4]);
    acc[5] = fmaf(xv[k], w[k][1].y, acc[5]);
    acc[6] = fmaf(xv[k], w[k][1].z, acc[6]);
    acc[7] = fmaf(xv[k], w[k][1].w, acc[7]);
  }
}

__global__ void __launch_bounds__(kOutThreads, kOutBlocks)
    fam_conv_out_kernel(const float* __restrict__ z, const float* __restrict__ x, const float* __restrict__ w,
                        float* __restrict__ out, int H, int W) {
  using T = float;  // the f32 instance only; bf16 runs fam_conv_out_mma_kernel
  using E = Elem<T>;
  constexpr int kS = px_stride<T>();          // elements per pixel row in shared memory
  constexpr int kCh = kC / chunk_elems<T>();  // 16-byte chunks per pixel
  extern __shared__ float4 smem[];
  T* xs = reinterpret_cast<T*>(smem);  // x tile [kOutHaloPx][kS]
  T* ps = xs + kOutHaloPx * kS;        // pooled tile [kOutPix][kS]
  T* ws = ps + kOutPix * kS;           // [2][kWRows][kC]
  const int t = threadIdx.x, cg = t % 16, pg = t / 16;
  const int row = pg / 2, col0 = (pg % 2) * 8;
  const int r0 = blockIdx.y * kOutTH, c0 = blockIdx.x * kOutTW, b = blockIdx.z;
  const T* xb = x + (size_t)b * H * W * kC;
  const uint32_t xs_s = smem_u32(xs), ws_s = smem_u32(ws);

  auto load_w = [&](int chunk) {  // rows chunk * kWRows.. of [ka; kb], one commit group
    const T* src = w + (size_t)chunk * kWRows * kC;
    const uint32_t dst = ws_s + (chunk & 1) * (kWRows * kC * (int)sizeof(T));
#pragma unroll 1
    for (int i = t; i < kWRows * kCh; i += kOutThreads) cp_async16(dst + 16 * i, src + chunk_elems<T>() * i, 16);
    cp_async_commit();
  };
#pragma unroll 1
  for (int i = t; i < kOutHaloPx * kCh; i += kOutThreads) {
    const int px = i / kCh, ch = i % kCh;
    const int gy = r0 - 1 + px / kOutHW, gx = c0 - 1 + px % kOutHW;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    cp_async16(xs_s + (px * kS + chunk_elems<T>() * ch) * (int)sizeof(T),
               in ? xb + ((size_t)gy * W + gx) * kC + chunk_elems<T>() * ch : xb, in ? 16 : 0);
  }
  load_w(0);  // one group: the x tile and the first weight rows
  cp_async_wait<0>();
  __syncthreads();

  // The pooled tile: per original pixel, the max of its 3x3 neighbourhood
  // (exact in either type).
  for (int i = t; i < kOutPix * kC; i += kOutThreads) {
    const int ch = i % kC, q = i / kC;
    const int quad = ch / kQ, cc = ch % kQ;
    const int rbase = 2 * (q / kOutTW + 1) + (quad >> 1), cbase = 2 * (q % kOutTW + 1) + (quad & 1);
    float m = -INFINITY;
#pragma unroll
    for (int dr = -1; dr <= 1; ++dr) {
      const int rr = rbase + dr;
#pragma unroll
      for (int dc = -1; dc <= 1; ++dc) {
        const int cc2 = cbase + dc;
        m = fmaxf(m, E::to_f(xs[((rr >> 1) * kOutHW + (cc2 >> 1)) * kS + ((rr & 1) * 2 + (cc2 & 1)) * kQ + cc]));
      }
    }
    ps[q * kS + ch] = E::from_f(m);
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  constexpr int kChunks = 2 * kC / kWRows;
  for (int chunk = 0; chunk < kChunks; ++chunk) {
    if (chunk + 1 < kChunks) {
      load_w(chunk + 1);
    } else {
      cp_async_commit();  // an empty group keeps wait_group 1 exact
    }
    cp_async_wait<1>();
    __syncthreads();  // this chunk's rows (and, the first time, the pooled tile) are in
    const T* wt = ws + (chunk & 1) * kWRows * kC;
    const int k0 = (chunk * kWRows) % kC;
    const T* arow = chunk * kWRows < kC ? xs + ((row + 1) * kOutHW + col0 + 1) * kS + k0
                                        : ps + (row * kOutTW + col0) * kS + k0;
#pragma unroll
    for (int k4 = 0; k4 < kWRows / 4; ++k4) {
      float4 wv[4][2];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wv[k][0] = E::load4(wt + (4 * k4 + k) * kC + 4 * cg);
        wv[k][1] = E::load4(wt + (4 * k4 + k) * kC + 64 + 4 * cg);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) fma_px(acc[i], E::load4(arow + i * kS + 4 * k4), wv);
    }
    __syncthreads();  // this stage is free for the load two chunks on
  }

  const int gy = r0 + row;
  if (gy >= H) return;
  const size_t row_off = ((size_t)b * H + gy) * W;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int co = 64 * h + 4 * cg;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int gx = c0 + col0 + i;
      if (gx >= W) break;
      const size_t o = (row_off + gx) * kC + co;
      const float4 zv = ldg4(z + o);
      E::store4(out + o, make_float4(fmaxf(acc[i][4 * h] + zv.x, 0.f), fmaxf(acc[i][4 * h + 1] + zv.y, 0.f),
                                     fmaxf(acc[i][4 * h + 2] + zv.z, 0.f), fmaxf(acc[i][4 * h + 3] + zv.w, 0.f)));
    }
  }
}

// ---------------------------------------------------------------------------
// K4's last stage in bf16, on the tensor cores (fam_conv_out_mma_kernel):
// fam_conv_out_kernel's function, out = relu(z + [x | maxpool3x3(x)] @
// [ka; kb]) per packed pixel, x and [ka; kb] bf16, z f32, the output
// rounded to bf16 once.
//
// Bound on the card: bytes. Its 2 * 256 * 128 FLOP a packed pixel take
// 0.037 ms per 1088x1920 image at 989 TFLOP/s, against 1,024 B moved (z 512
// in, x 256 in, out 256): 0.1697 ms at 3.35 TB/s for the image's 554,880
// packed pixels, 4.6 FLOP a byte. On the CUDA cores the FLOP alone take
// 0.54 ms at 67 TFLOP/s, so the products go to the tensor cores. mma.sync
// (m16n8k16, both operands from shared memory by ldmatrix) suffices at that
// ratio: wgmma's asynchrony buys nothing for a stage the bytes bound, and
// its A would still come from the pooled tile the block computes.
//
// Design:
// - A persistent grid, one 256-thread block per SM, walks 8 x 16 tiles of
//   packed pixels. [ka; kb], transposed to [128 columns][256] and rounded
//   to bf16 once per model (pack_fam_conv), is the B operand: it comes into
//   shared memory once and stays (rows padded to 528 B, so that ldmatrix
//   meets no bank conflict; pixel rows are padded to 272 B likewise).
// - The x tile with a halo of one packed pixel (zeros outside the image)
//   streams in by cp.async into one of two buffers, and the tile's z into
//   registers by 16-byte loads, both one tile ahead: each tile's loads are
//   in flight under the previous tile's pooling and products.
// - The block computes the pooled tile from the halo tile into shared
//   memory, separably: a thread owns a packed column, 8 channels of each
//   quadrant and two packed rows; it takes the 3-wide max along each of the
//   six original rows it needs (four 16-byte loads a row), then the 3-high
//   max down them. Exact in bf16. The pool is per ORIGINAL pixel, across
//   quadrants (original row 2I + a is packed row I, quadrant row a); x >= 0
//   (post-ReLU), so the zero halo equals 'SAME' -inf padding.
// - Warp w owns tile rows 2(w/2) and 2(w/2) + 1 (two m16 tiles) and the
//   64 columns 64(w%2).. (eight n8 tiles). Its accumulators start at z and
//   take 16 k16 steps, over x's centre channels, then the pooled ones: per
//   step two A and four B ldmatrix.x4 and sixteen mma.sync, f32
//   accumulation.
// - The B operand's columns are the output channels permuted
//   (fused_blocks.mma_channels): in each block of 32, column 8s + 2t + e
//   computes channel 8t + 2s + e, so the pairs of the four n8 tiles that
//   lane (g, t) holds for a pixel are eight consecutive channels. A lane
//   reads their z as two 16-byte loads and writes their output as one
//   16-byte store, with no staging.
// - The products are exact in f32 (bf16 x bf16) and are summed onto z in
//   the tensor cores' order, not fmaf's: an output next to a bf16 rounding
//   boundary may round the other way, one bf16 ulp.
// ---------------------------------------------------------------------------
constexpr int kMTH = 8, kMTW = 16;               // output tile, packed pixels
constexpr int kMHW = kMTW + 2;                   // halo row, 18 pixels
constexpr int kMHaloPx = (kMTH + 2) * kMHW;      // 180
constexpr int kMPix = kMTH * kMTW;               // 128
constexpr int kMThreads = 256;                   // 8 warps x (32 pixels x 64 columns)
constexpr int kMK = 2 * kC;                      // 256: x's channels, then the pooled ones
constexpr int kMXS = kC + 8;                     // bf16 a pixel row in shared memory (272 B)
constexpr int kMWS = kMK + 8;                    // bf16 a B row in shared memory (528 B)
// B, two halo tiles and the pooled tile: 200,320 B.
constexpr size_t kMSmem = sizeof(__nv_bfloat16) * ((size_t)kC * kMWS + (size_t)(2 * kMHaloPx + kMPix) * kMXS);
static_assert(kMThreads == kMTW * (kQ / 8) * (kMTH / 2), "pooling: a thread per column, 8-channel chunk and row pair");
static_assert(kMThreads == 32 * (kMTH / 2) * 2, "a warp per two tile rows and 64 columns");

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
// d += a @ b: one m16n8k16 product, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) { return *reinterpret_cast<const uint32_t*>(&v); }
__device__ __forceinline__ __nv_bfloat162 as_bf16x2(uint32_t v) { return *reinterpret_cast<const __nv_bfloat162*>(&v); }
// Two f32 rounded to bf16, the first in the low half (the lower address).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) { return bf16x2_bits(__floats2bfloat162_rn(lo, hi)); }
// The elementwise max of three rows of 8 bf16 (exact).
__device__ __forceinline__ uint4 max3_bf16x8(uint4 a, uint4 b, uint4 c) {
  auto m = [](uint32_t u, uint32_t v, uint32_t w) {
    return bf16x2_bits(__hmax2(__hmax2(as_bf16x2(u), as_bf16x2(v)), as_bf16x2(w)));
  };
  return make_uint4(m(a.x, b.x, c.x), m(a.y, b.y, c.y), m(a.z, b.z, c.z), m(a.w, b.w, c.w));
}

__global__ void __launch_bounds__(kMThreads, 1)
    fam_conv_out_mma_kernel(const float* __restrict__ z, const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ wt, __nv_bfloat16* __restrict__ out, int H, int W,
                            int tiles_x, int tiles_per_image, long long n_tiles) {
  using bf16 = __nv_bfloat16;
  extern __shared__ float4 smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);  // B [128 columns][kMWS]
  bf16* xs0 = ws + kC * kMWS;                // two halo tiles [kMHaloPx][kMXS]
  bf16* ps = xs0 + 2 * kMHaloPx * kMXS;      // the pooled tile [kMPix][kMXS]
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g = lane >> 2, tq = lane & 3;
  const int rp = warp >> 1, half = warp & 1;

  struct Tile {
    int b, r0, c0;
  };
  auto tile_at = [&](long long tile) {
    const int rem = (int)(tile % tiles_per_image);
    return Tile{(int)(tile / tiles_per_image), rem / tiles_x * kMTH, rem % tiles_x * kMTW};
  };
  auto load_x = [&](Tile tl, int stage) {  // one commit group
    const bf16* xb = x + (size_t)tl.b * H * W * kC;
    bf16* xs = xs0 + stage * kMHaloPx * kMXS;
#pragma unroll 4
    for (int i = t; i < kMHaloPx * (kC / 8); i += kMThreads) {
      const int px = i >> 4, ch = i & 15;
      const int gy = tl.r0 - 1 + px / kMHW, gx = tl.c0 - 1 + px % kMHW;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async16(smem_u32(xs + px * kMXS + 8 * ch), in ? xb + ((size_t)gy * W + gx) * kC + 8 * ch : x, in ? 16 : 0);
    }
    cp_async_commit();
  };
  // z for this lane's accumulators: m16 tile mt (tile row 2 rp + mt), row hr
  // (tile column g + 8 hr), channels 64 half + 32 q + 8 tq.. +7 (zeros
  // outside the image).
  auto load_z = [&](Tile tl, float4 (&zr)[2][2][2][2]) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int gy = tl.r0 + 2 * rp + mt, gx = tl.c0 + g + 8 * hr;
        const bool in = gy < H && gx < W;
        const float* zp = z + (((size_t)tl.b * H + (in ? gy : 0)) * W + (in ? gx : 0)) * kC + 64 * half + 8 * tq;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          zr[mt][hr][q][0] = in ? ldg4(zp + 32 * q) : make_float4(0.f, 0.f, 0.f, 0.f);
          zr[mt][hr][q][1] = in ? ldg4(zp + 32 * q + 4) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
  };

  // B once: the global [128][256] rows into rows of kMWS (in the first commit group).
#pragma unroll 4
  for (int i = t; i < kC * (kMK / 8); i += kMThreads) cp_async16(smem_u32(ws + (i >> 5) * kMWS + 8 * (i & 31)), wt + 8 * i, 16);
  long long tile = blockIdx.x;  // the grid is at most n_tiles
  float4 zr[2][2][2][2];
  load_x(tile_at(tile), 0);
  load_z(tile_at(tile), zr);

  // Per-lane shared-memory addresses. ldmatrix.x4 of A: lanes 0-15 give rows
  // 0-15 at channels k.., lanes 16-31 the same rows at k + 8... Of B: lanes
  // 0-7 and 8-15 give columns n..n+7 at k.. and k + 8.., lanes 16-31 the
  // next eight columns.
  const int arow = lane & 15, acol = 8 * (lane >> 4);
  const bf16* b_lane = ws + (64 * half + (lane & 7) + 8 * (lane >> 4)) * kMWS + 8 * ((lane >> 3) & 1);
  // The pooling thread's packed column, 8-channel chunk and row pair; in a
  // quarter warp the eight columns of one chunk, 272 B apart (no conflict).
  const int pj = (t & 7) + 8 * ((t >> 5) & 1), pchunk = (t >> 3) & 3, prow = t >> 6;

  int stage = 0;
#pragma unroll 1
  for (; tile < n_tiles; tile += gridDim.x, stage ^= 1) {
    const Tile tl = tile_at(tile);
    float acc[2][8][4];  // [m16 tile][n8 tile 4q + s][row g: e, row g + 8: 2 + e]
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float4 lo = zr[mt][hr][q][0], hi = zr[mt][hr][q][1];
          const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};  // channels 8 tq + 2 s + e
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            acc[mt][4 * q + s][2 * hr] = v[2 * s];
            acc[mt][4 * q + s][2 * hr + 1] = v[2 * s + 1];
          }
        }
    const long long next = tile + gridDim.x;
    if (next < n_tiles) {
      load_x(tile_at(next), stage ^ 1);
      load_z(tile_at(next), zr);
    } else {
      cp_async_commit();  // an empty group keeps wait_group 1 exact
    }
    cp_async_wait<1>();
    __syncthreads();  // this tile's x (and, the first time, B) landed
    const bf16* xs = xs0 + stage * kMHaloPx * kMXS;

    {  // The pooled tile. Original row R (relative to the tile's first) is
       // halo row (R + 2) / 2, quadrant row R & 1; halo column j + 1 holds
       // packed column j.
      uint4 hm[6][2];  // the 3-wide max of original rows 4 prow - 1 + i, at quadrant columns 0 and 1
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const int R = 4 * prow - 1 + i;
        const bf16* rowp = xs + ((R + 2) >> 1) * kMHW * kMXS + (R & 1) * 2 * kQ + 8 * pchunk;
        const uint4 l0 = *reinterpret_cast<const uint4*>(rowp + pj * kMXS + kQ);  // column 2 pj - 1
        const uint4 l1 = *reinterpret_cast<const uint4*>(rowp + (pj + 1) * kMXS);       // 2 pj
        const uint4 l2 = *reinterpret_cast<const uint4*>(rowp + (pj + 1) * kMXS + kQ);  // 2 pj + 1
        const uint4 l3 = *reinterpret_cast<const uint4*>(rowp + (pj + 2) * kMXS);       // 2 pj + 2
        hm[i][0] = max3_bf16x8(l0, l1, l2);
        hm[i][1] = max3_bf16x8(l1, l2, l3);
        if (i >= 2) {  // original row 4 prow + i - 2: packed row 2 prow + (i - 2) / 2, quadrant row i & 1
          bf16* o = ps + ((2 * prow + ((i - 2) >> 1)) * kMTW + pj) * kMXS + (i & 1) * 2 * kQ + 8 * pchunk;
          *reinterpret_cast<uint4*>(o) = max3_bf16x8(hm[i - 2][0], hm[i - 1][0], hm[i][0]);
          *reinterpret_cast<uint4*>(o + kQ) = max3_bf16x8(hm[i - 2][1], hm[i - 1][1], hm[i][1]);
        }
      }
    }
    __syncthreads();  // the pooled tile is whole

    const bf16* a_x[2];
    const bf16* a_p[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int tr = 2 * rp + mt;
      a_x[mt] = xs + ((tr + 1) * kMHW + 1 + arow) * kMXS + acol;
      a_p[mt] = ps + (tr * kMTW + arow) * kMXS + acol;
    }
#pragma unroll
    for (int ks = 0; ks < kMK / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) ldmatrix_x4(a[mt], (ks < kC / 16 ? a_x[mt] : a_p[mt]) + 16 * (ks % (kC / 16)));
#pragma unroll
      for (int pr = 0; pr < 4; ++pr) {
        uint32_t b[4];
        ldmatrix_x4(b, b_lane + 16 * pr * kMWS + 16 * ks);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * pr], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * pr + 1], a[mt], b[2], b[3]);
        }
      }
    }

#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int gy = tl.r0 + 2 * rp + mt, gx = tl.c0 + g + 8 * hr;
        if (gy < H && gx < W) {
          bf16* op = out + (((size_t)tl.b * H + gy) * W + gx) * kC + 64 * half + 8 * tq;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            uint32_t v[4];
#pragma unroll
            for (int s = 0; s < 4; ++s)
              v[s] = pack_bf16x2(fmaxf(acc[mt][4 * q + s][2 * hr], 0.f), fmaxf(acc[mt][4 * q + s][2 * hr + 1], 0.f));
            *reinterpret_cast<uint4*>(op + 32 * q) = make_uint4(v[0], v[1], v[2], v[3]);
          }
        }
      }
    __syncthreads();  // the pooled tile and this halo buffer are free
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// K5. Replaces retinex_tpu/ops/fused_blocks.py::_tail_stats_kernel
// (pallas_call in fam_tail_stats). Bound on the card: bytes — 512 B read and
// 32 B written per pixel for ~260 operations (half the bytes in bf16).
// Design: one warp per pixel, lane l reading channels 4l..4l+3 as one
// float4 or four bf16 (a coalesced 512 or 256 B row), so
// each quadrant's 32 channels sit in 8 lanes and reduce in three xor
// shuffles; lane 8q writes the quadrant's (mean, max) pair. The TPU's 8-row
// replication of ca is not needed.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void fam_tail_stats_kernel(const T* __restrict__ x, const float* __restrict__ ca, T* __restrict__ out,
                                      long long hw, long long n_pix) {
  using E = Elem<T>;
  const long long pix = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (pix >= n_pix) return;
  float4 v = E::gload4(x + pix * kC + 4 * lane);
  const float4 c = ldg4(ca + (pix / hw) * kC + 4 * lane);
  v.x = E::round(v.x * E::round(c.x));
  v.y = E::round(v.y * E::round(c.y));
  v.z = E::round(v.z * E::round(c.z));
  v.w = E::round(v.w * E::round(c.w));
  float s = (v.x + v.y) + (v.z + v.w);
  float m = fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  if ((lane & 7) == 0) E::store2(out + pix * 8 + 2 * (lane >> 3), s * (1.0f / kQ), m);
}

// ---------------------------------------------------------------------------
// K6. Replaces retinex_tpu/ops/fused_blocks.py::_tail_apply_g1_kernel
// (pallas_call in fam_tail_apply_g1): out = (x * ca * sa of the pixel's
// quadrant) @ w, x [n_pix, 128], w [128, Cout].
//
// Bound on the card. Each pixel moves 512 B of x and 16 B of sa in and
// 4 * Cout B out. For a dense w that is 2 * 128 * Cout FLOP against them:
// at Cout = 128, 32,768 FLOP for 1,040 B, operations-bound (0.2735 ms per
// 1088x1920 image, 554,880 packed pixels, at 67 TFLOP/s). The main path's w
// is the packed fusion slice (pack_pointwise of a [32, 32] 1x1), block-
// diagonal over the four quadrants: three quarters of those products
// multiply exact zeros. Only the four [32 x 32] products are needed, 8,448
// FLOP a pixel (8.1 FLOP per byte, under the card's f32 ratio of 20), so
// the main path is bytes-bound: 577 MB per image, 0.1723 ms at 3.35 TB/s.
//
// Design: one f32 kernel body, templated on w's layout. kDiag: the four
// diagonal blocks, [128 x 32] (row k holds quadrant k/32's block row, 16 KB);
// dense: [128 x 128], zero columns past Cout (64 KB). pack_tail_g1
// in retinex_tpu_torch/ops/fused_blocks.py makes either once per model.
// - The weights are loaded into shared memory once and stay for the block's
//   lifetime; the grid is persistent (one 256-thread block per SM) and walks
//   tiles of 128 pixels.
// - x tiles and their sa stream in by cp.async into a ring of two stages,
//   so the next tile's load is in flight under this tile's scaling and FMAs.
// - When a tile lands, each warp scales in place the x values its own
//   products read, (x * ca) * sa, the plain version's order.
// - Warp w owns output quadrant w % 4 (32 channels) of pixel half w / 4;
//   lane (pg, c) owns pixels pg + 16 i (i < 8; consecutive lanes on
//   consecutive pixels, so the x reads meet no bank conflict) and channels
//   32q + 4c.. and 32q + 16 + 4c..: an 8 x 8 register outer product, f32
//   fmaf in increasing k. kDiag walks k over the quadrant's 32 input
//   channels, dense over all 128; the zero terms a dense walk adds to a
//   block-diagonal w leave every sum as it is, so the two instances give
//   the same bits there.
// - Outputs are stored as float4, each warp instruction 64 contiguous bytes
//   of every pixel it writes. No TF32, no tensor cores.
// - In bf16 the quadrant-diagonal instance is fam_tail_apply_g1_mma_kernel,
//   below, and the dense one fam_tail_apply_g1_wgmma_kernel
//   (csrc/fam_tail_wgmma.cu), both on the tensor cores.
// ---------------------------------------------------------------------------
constexpr int kG1Pix = 128;                                      // pixels per tile
constexpr int kG1Threads = 256;
// x stages in the ring: two fit beside either instance's weights. A third
// fits beside the diagonal weights only (225,280 B in f32) and leaves L1 3 KB.
constexpr int kG1Stages = 2;
static_assert(kG1Threads == 2 * 4 * 32 && kG1Pix == 2 * 8 * 8, "8 warps: 4 quadrants x 2 pixel halves");

// One stage in elements of T: the x tile [kG1Pix][px_stride<T>()], then its sa [kG1Pix][4].
template <typename T>
__host__ __device__ constexpr int g1_stage_elems() {
  return kG1Pix * px_stride<T>() + kG1Pix * 4;
}
template <bool kDiag>
__host__ __device__ constexpr int g1_wcols() {
  return kDiag ? kQ : kC;
}
template <bool kDiag>
constexpr size_t g1_smem() {
  return sizeof(float) * ((size_t)kC * g1_wcols<kDiag>() + kG1Stages * (size_t)g1_stage_elems<float>());
}

template <bool kDiag>
__global__ void __launch_bounds__(kG1Threads, 1)
    fam_tail_apply_g1_kernel(const float* __restrict__ x, const float* __restrict__ ca, const float* __restrict__ sa,
                             const float* __restrict__ w, float* __restrict__ out, long long hw, long long n_pix,
                             int cout) {
  using T = float;  // the f32 instances only; bf16 runs the tensor-core kernels
  using E = Elem<T>;
  constexpr int kWCols = g1_wcols<kDiag>();
  constexpr int kS = px_stride<T>();
  constexpr int kCh = kC / chunk_elems<T>();  // 16-byte chunks per pixel
  extern __shared__ float4 smem[];
  float* ws = reinterpret_cast<float*>(smem);            // [128][kWCols]
  T* stages = reinterpret_cast<T*>(ws + kC * kWCols);    // kG1Stages x ([kG1Pix][kS] x, [kG1Pix][4] sa)
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int q = warp & 3, c = lane & 3, pg = (lane >> 2) + 8 * (warp >> 2);
  const long long n_tiles = (n_pix + kG1Pix - 1) / kG1Pix;

#pragma unroll 1
  for (int i = t; i < kC * kWCols / 4; i += kG1Threads) cp_async16(smem_u32(ws + 4 * i), w + 4 * i, 16);
  cp_async_commit();

  auto load_tile = [&](long long tile, int stage) {  // one commit group; zeros past n_pix
    T* xs = stages + stage * g1_stage_elems<T>();
    const long long p0 = tile * kG1Pix;
#pragma unroll 4
    for (int i = t; i < kG1Pix * kCh; i += kG1Threads) {
      const int px = i / kCh, ch = i % kCh;
      const bool in = p0 + px < n_pix;
      cp_async16(smem_u32(xs + px * kS + chunk_elems<T>() * ch), in ? x + (p0 + px) * kC + chunk_elems<T>() * ch : x,
                 in ? 16 : 0);
    }
    if (t < kG1Pix) {  // the pixel's 4 sa values, 16 B
      const bool in = p0 + t < n_pix;
      cp_async16(smem_u32(xs + kG1Pix * kS + 4 * t), in ? sa + (p0 + t) * 4 : sa, in ? 16 : 0);
    }
    cp_async_commit();
  };

  // The ring: tile i of this block lands in stage i % kG1Stages, loaded
  // kG1Stages - 1 tiles ahead (an empty group where there is none, so that
  // wait_group kG1Stages - 1 is exact).
#pragma unroll
  for (int st = 0; st < kG1Stages - 1; ++st) {
    const long long tile = blockIdx.x + (long long)st * gridDim.x;
    if (tile < n_tiles) {
      load_tile(tile, st);
    } else {
      cp_async_commit();
    }
  }
  int stage = 0;
#pragma unroll 1
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, stage = stage + 1 == kG1Stages ? 0 : stage + 1) {
    const long long ahead = tile + (long long)(kG1Stages - 1) * gridDim.x;
    if (ahead < n_tiles) {
      load_tile(ahead, stage == 0 ? kG1Stages - 1 : stage - 1);  // the stage computed last iteration
    } else {
      cp_async_commit();
    }
    cp_async_wait<kG1Stages - 1>();
    __syncthreads();  // this tile (and, the first time, the weights) landed

    T* xs = stages + stage * g1_stage_elems<T>();
    const T* ss = xs + kG1Pix * kS;
    const long long p0 = tile * kG1Pix;
    // Each warp scales what its own products read: the quadrant-q channels
    // of its half's 64 pixels (8 * half + r + 16 i, r, i < 8), lane l pixel
    // r = 4 (j % 2) + l / 8, i = j / 2 of step j < 16, at channels 32q +
    // 4 (l % 8)... Its ca stays in registers while the pixels lie in one
    // image (a division only where the tile crosses into the next), so the
    // loads of the unrolled loop do not wait on one another. The diagonal
    // instance reads no other warp's values (a warp barrier); the dense one
    // reads its half's four quadrants (a barrier of those four warps).
    const int half = warp >> 2, cq = kQ * q + 4 * (lane & 7);
    const int px0 = 8 * half + (lane >> 3);
    long long img = min(p0 + px0, n_pix - 1) / hw, next = (img + 1) * hw;  // in range on a ragged tile
    float4 cv = ldg4(ca + img * kC + cq);
#pragma unroll
    for (int j = 0; j < kG1Pix / 8; ++j) {
      const int px = px0 + 16 * (j >> 1) + 4 * (j & 1);
      if (p0 + px < n_pix) {
        if (p0 + px >= next) {
          img = (p0 + px) / hw;
          next = (img + 1) * hw;
          cv = ldg4(ca + img * kC + cq);
        }
        T* xp = xs + px * kS + cq;
        const float4 v = E::load4(xp);
        const float s = E::to_f(ss[4 * px + q]);
        E::store4(xp, make_float4(E::round(E::round(v.x * E::round(cv.x)) * s),
                                  E::round(E::round(v.y * E::round(cv.y)) * s),
                                  E::round(E::round(v.z * E::round(cv.z)) * s),
                                  E::round(E::round(v.w * E::round(cv.w)) * s)));
      }
    }
    if (kDiag) {
      __syncwarp();
    } else {
      asm volatile("bar.sync %0, %1;" ::"r"(1 + half), "r"(kG1Threads / 2) : "memory");
    }

    if (kQ * q < cout) {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      const int k0 = kDiag ? kQ * q : 0;
      const float* wc = ws + (kDiag ? 0 : kQ * q) + 4 * c;
      const T* xrow = xs + pg * kS;
#pragma unroll 4
      for (int k = k0; k < k0 + (kDiag ? kQ : kC); k += 4) {
        float4 wv[4][2];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wv[kk][0] = *reinterpret_cast<const float4*>(wc + (k + kk) * kWCols);
          wv[kk][1] = *reinterpret_cast<const float4*>(wc + (k + kk) * kWCols + 16);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) fma_px(acc[i], E::load4(xrow + 16 * i * kS + k), wv);
      }
      const int co = kQ * q + 4 * c;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long p = p0 + pg + 16 * i;
        if (p >= n_pix) break;
        T* o = out + p * cout + co;
        if (co < cout) E::store4(o, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
        if (co + 16 < cout) E::store4(o + 16, make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
      }
    }
    __syncthreads();  // this stage is free for the next load
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// K6's quadrant-diagonal instance in bf16, on the tensor cores
// (fam_tail_apply_g1_mma_kernel): out = round(round(x * ca) * sa of the
// pixel's quadrant) @ w, x and sa bf16, ca and w f32, w's four diagonal
// [32 x 32] blocks only, the output rounded to bf16 once.
//
// Bound on the card: bytes, 520 B a pixel (x 256 and sa 8 in, out 256),
// 0.0861 ms per 1088x1920 image at 3.35 TB/s. The template's bf16 instance,
// which this kernel replaced, moved half the f32 instance's bytes in the
// same time: its 8,448 FLOP a pixel on the CUDA cores, the bf16 unpacking
// and the scaling pass over shared memory set its pace.
//
// Design:
// - No bf16 product takes the f32 w exactly, so pack_tail_g1 splits it once
//   per model into three bf16 pieces, w0 = bf16(w), w1 = bf16(w - w0), w2 =
//   w - w0 - w1 (exact in bf16): they sum to w, and each piece's products
//   with a bf16 x are exact in f32, so the result departs from the plain
//   f32 product by the order of summation only. The three [32 x 32]
//   products a quadrant are ~14 GFLOP an image on the tensor cores.
// - The pieces (fused_blocks.TailG1Packed.mma_w: [3][4 quadrants][32
//   columns][32 k] bf16, the columns permuted as fam_conv_out_mma_kernel's)
//   are the B operand. A warp's quadrant needs 48 registers of them, loaded
//   once for the block's lifetime; shared memory holds only the x ring.
// - The template's persistent grid and cp.async ring walk tiles of 128
//   pixels, with four stages.
// - Warp w owns quadrant w % 4 of pixel half w / 4: four m16 tiles. Each
//   takes its A fragments (the raw x of its quadrant) by two ldmatrix.x4
//   and scales them in registers: x * bf16(ca), rounded, then * sa of the
//   pixel's quadrant, rounded (bf16x2 multiplies, each rounding once: the
//   plain version's two roundings, with no pass over shared memory); then
//   24 mma.sync with f32 accumulators.
// - ca is per image: a lane keeps the bf16 ca of its eight channels for
//   each of its two fragment rows and reloads it where the pixels cross into
//   the next image.
// - As in fam_conv_out_mma_kernel's epilogue, a lane holds eight
//   consecutive output channels of a pixel and stores them as one 16-byte
//   chunk.
// ---------------------------------------------------------------------------
constexpr int kG1MmaStages = 4;
constexpr size_t kG1MmaSmem = sizeof(__nv_bfloat16) * kG1MmaStages * (size_t)g1_stage_elems<__nv_bfloat16>();

// bf16(bf16(v * c) * s), lane by lane, on two bf16 pairs.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, uint32_t c, uint32_t s) {
  return bf16x2_bits(__hmul2(__hmul2(as_bf16x2(v), as_bf16x2(c)), as_bf16x2(s)));
}

__global__ void __launch_bounds__(kG1Threads, 1)
    fam_tail_apply_g1_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ ca,
                                 const __nv_bfloat16* __restrict__ sa, const __nv_bfloat16* __restrict__ wp,
                                 __nv_bfloat16* __restrict__ out, long long hw, long long n_pix) {
  using bf16 = __nv_bfloat16;
  constexpr int kS = px_stride<bf16>();  // 136 elements a pixel row
  constexpr int kCh = kC / 8;            // 16-byte chunks a pixel
  extern __shared__ float4 smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);  // kG1MmaStages x ([kG1Pix][kS] x, [kG1Pix][4] sa)
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g = lane >> 2, tq = lane & 3;
  const int q = warp & 3, half = warp >> 2;
  const long long n_tiles = (n_pix + kG1Pix - 1) / kG1Pix;

  // B: piece i, k16 step kk, n8 tile j: column 8 j + g, k = 16 kk + 2 tq.. and + 8..
  uint32_t bw[3][2][4][2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16* r = wp + ((i * 4 + q) * kQ + 8 * j + g) * kQ + 16 * kk + 2 * tq;
        bw[i][kk][j][0] = __ldg(reinterpret_cast<const unsigned int*>(r));
        bw[i][kk][j][1] = __ldg(reinterpret_cast<const unsigned int*>(r + 8));
      }

  auto load_tile = [&](long long tile, int stage) {  // one commit group; zeros past n_pix
    bf16* xs = stages + stage * g1_stage_elems<bf16>();
    const long long p0 = tile * kG1Pix;
#pragma unroll 4
    for (int i = t; i < kG1Pix * kCh; i += kG1Threads) {
      const int px = i / kCh, ch = i % kCh;
      const bool in = p0 + px < n_pix;
      cp_async16(smem_u32(xs + px * kS + 8 * ch), in ? x + (p0 + px) * kC + 8 * ch : x, in ? 16 : 0);
    }
    if (t < kG1Pix) {  // the pixel's 4 sa values
      const bool in = p0 + t < n_pix;
      cp_async8(smem_u32(xs + kG1Pix * kS + 4 * t), in ? sa + (p0 + t) * 4 : sa, in ? 8 : 0);
    }
    cp_async_commit();
  };

  // The ring, as the template's: tile i of this block in stage i % kG1MmaStages.
#pragma unroll
  for (int st = 0; st < kG1MmaStages - 1; ++st) {
    const long long tile = blockIdx.x + (long long)st * gridDim.x;
    if (tile < n_tiles) {
      load_tile(tile, st);
    } else {
      cp_async_commit();
    }
  }
  // ca of each fragment row (g, g + 8): where the image whose ca is held ends,
  // and its bf16 values at channels 32 q + 16 kk + 8 h + 2 tq, +1 as [kk][h].
  long long img_end[2] = {-1, -1};
  uint32_t cab[2][2][2];
  int stage = 0;
#pragma unroll 1
  for (long long tile = blockIdx.x; tile < n_tiles;
       tile += gridDim.x, stage = stage + 1 == kG1MmaStages ? 0 : stage + 1) {
    const long long ahead = tile + (long long)(kG1MmaStages - 1) * gridDim.x;
    if (ahead < n_tiles) {
      load_tile(ahead, stage == 0 ? kG1MmaStages - 1 : stage - 1);  // the stage computed last iteration
    } else {
      cp_async_commit();
    }
    cp_async_wait<kG1MmaStages - 1>();
    __syncthreads();  // this tile landed

    const bf16* xs = stages + stage * g1_stage_elems<bf16>();
    const bf16* ss = xs + kG1Pix * kS;
    const long long p0 = tile * kG1Pix;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int r0 = 64 * half + 16 * m;  // the m16 tile's first pixel in the tile
      uint32_t a[2][4];  // [kk]: rows g, g + 8 at channels 16 kk + 2 tq.., then the same at + 8
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) ldmatrix_x4(a[kk], xs + (r0 + (lane & 15)) * kS + kQ * q + 16 * kk + 8 * (lane >> 4));
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = r0 + g + 8 * hr;
        const long long p = p0 + row;
        if (p >= img_end[hr]) {  // the first row, or the next image (past n_pix: the last image's)
          const long long img = min(p, n_pix - 1) / hw;
          img_end[hr] = (img + 1) * hw;
          const float* cp = ca + img * kC + kQ * q + 2 * tq;
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float2 c = __ldg(reinterpret_cast<const float2*>(cp + 16 * kk + 8 * h));
              cab[hr][kk][h] = pack_bf16x2(c.x, c.y);
            }
        }
        const uint32_t s2 = bf16x2_bits(__bfloat162bfloat162(ss[4 * row + q]));
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          a[kk][hr] = scale_bf16x2(a[kk][hr], cab[hr][kk][0], s2);
          a[kk][2 + hr] = scale_bf16x2(a[kk][2 + hr], cab[hr][kk][1], s2);
        }
      }
      float acc[4][4] = {};
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[j], a[kk], bw[i][kk][j][0], bw[i][kk][j][1]);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const long long p = p0 + r0 + g + 8 * hr;
        if (p < n_pix) {
          *reinterpret_cast<uint4*>(out + p * kC + kQ * q + 8 * tq) =
              make_uint4(pack_bf16x2(acc[0][2 * hr], acc[0][2 * hr + 1]), pack_bf16x2(acc[1][2 * hr], acc[1][2 * hr + 1]),
                         pack_bf16x2(acc[2][2 * hr], acc[2][2 * hr + 1]), pack_bf16x2(acc[3][2 * hr], acc[3][2 * hr + 1]));
        }
      }
    }
    __syncthreads();  // this stage is free for the next load
  }
  cp_async_wait<0>();
}

int launch_tail_apply_g1_mma(const void* x, const void* ca, const void* sa, const void* w, void* out, long long n_pix,
                             long long hw, void* stream) {
  if (n_pix == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(fam_tail_apply_g1_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kG1MmaSmem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)err;
  const long long n_tiles = (n_pix + kG1Pix - 1) / kG1Pix;
  const unsigned blocks = (unsigned)(n_tiles < sms ? n_tiles : sms);
  fam_tail_apply_g1_mma_kernel<<<blocks, kG1Threads, kG1MmaSmem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)ca, (const __nv_bfloat16*)sa, (const __nv_bfloat16*)w,
      (__nv_bfloat16*)out, hw, n_pix);
  return (int)cudaGetLastError();
}

template <bool kDiag>
int launch_tail_apply_g1(const void* x, const void* ca, const void* sa, const void* w, void* out, long long n_pix,
                         long long hw, int cout, void* stream) {
  if (n_pix == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(fam_tail_apply_g1_kernel<kDiag>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g1_smem<kDiag>());
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)err;
  const long long n_tiles = (n_pix + kG1Pix - 1) / kG1Pix;
  const unsigned blocks = (unsigned)(n_tiles < sms ? n_tiles : sms);
  fam_tail_apply_g1_kernel<kDiag><<<blocks, kG1Threads, g1_smem<kDiag>(), (cudaStream_t)stream>>>(
      (const float*)x, (const float*)ca, (const float*)sa, (const float*)w, (float*)out, hw, n_pix, cout);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K11. Replaces retinex_tpu/ops/fused_blocks.py::_tail_apply_kernel
// (pallas_call in fam_tail_apply): K6 without the product, for shapes whose
// fusion does not fold into the tail (a frame whose height or width is not a
// multiple of 16, such as 1080 rows). Bound on the card: bytes — 512 B read,
// 16 B of sa and 512 B written per pixel for 256 multiplies (half the bytes
// in bf16). Design: one thread per four channels of the output, consecutive
// threads on consecutive channels, so each warp reads and writes one
// coalesced pixel row; the products run x * ca * sa in that order, as the
// plain version does (in bf16 each rounded).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void fam_tail_apply_kernel(const T* __restrict__ x, const float* __restrict__ ca,
                                      const T* __restrict__ sa, T* __restrict__ out, long long hw, long long n4) {
  using E = Elem<T>;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const long long p = i / kC4;
  const int c4 = (int)(i % kC4);
  const float4 v = E::gload4(x + 4 * i);
  const float4 c = ldg4(ca + (p / hw) * kC + 4 * c4);
  const float s = E::to_f(sa[p * 4 + (4 * c4) / kQ]);
  E::store4(out + 4 * i, make_float4(E::round(E::round(v.x * E::round(c.x)) * s),
                                     E::round(E::round(v.y * E::round(c.y)) * s),
                                     E::round(E::round(v.z * E::round(c.z)) * s),
                                     E::round(E::round(v.w * E::round(c.w)) * s)));
}

int launch_conv_out_mma(const void* z, const void* x, const void* w, void* out, int batch, int H, int W,
                        void* stream) {
  if (batch == 0 || H == 0 || W == 0) return 0;
  cudaError_t err =
      cudaFuncSetAttribute(fam_conv_out_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMSmem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)err;
  const int tiles_x = (W + kMTW - 1) / kMTW, tiles_per_image = (H + kMTH - 1) / kMTH * tiles_x;
  const long long n_tiles = (long long)batch * tiles_per_image;
  const unsigned blocks = (unsigned)(n_tiles < sms ? n_tiles : sms);
  fam_conv_out_mma_kernel<<<blocks, kMThreads, kMSmem, (cudaStream_t)stream>>>(
      (const float*)z, (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)out, H, W, tiles_x,
      tiles_per_image, n_tiles);
  return (int)cudaGetLastError();
}

int launch_conv_out(const void* z, const void* x, const void* w, void* out, int batch, int H, int W, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(fam_conv_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kOutSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kOutTW - 1) / kOutTW, (H + kOutTH - 1) / kOutTH, batch);
  fam_conv_out_kernel<<<grid, kOutThreads, kOutSmem, (cudaStream_t)stream>>>(
      (const float*)z, (const float*)x, (const float*)w, (float*)out, H, W);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tail_stats(const void* x, const void* ca, void* out, long long n_pix, long long hw, void* stream) {
  const long long blocks = (n_pix * 32 + 255) / 256;
  fam_tail_stats_kernel<T><<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)ca, (T*)out, hw, n_pix);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tail_apply(const void* x, const void* ca, const void* sa, void* out, long long n4, long long hw,
                      void* stream) {
  const long long blocks = (n4 + 255) / 256;
  fam_tail_apply_kernel<T><<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)ca, (const T*)sa, (T*)out, hw, n4);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// z [batch, H, W, 128] f32; x and out [batch, H, W, 128] f32, or bf16 where
// is_bf16: out = relu(z + x @ ka + maxpool3x3_s2d(x) @ kb). w: [ka; kb]
// [256, 128] f32, or for bf16 the tensor-core kernel's B, [ka; kb] in bf16
// with its columns permuted and transposed, [128, 256] (pack_fam_conv).
int fam_conv_out(const void* z, const void* x, const void* w, void* out, int batch, int H, int W, int is_bf16,
                 void* stream) {
  return is_bf16 ? launch_conv_out_mma(z, x, w, out, batch, H, W, stream)
                 : launch_conv_out(z, x, w, out, batch, H, W, stream);
}

// x [batch, hw, 128] and out [batch, hw, 8] f32, or bf16 where is_bf16; ca
// [batch, 128] f32.
int fam_tail_stats(const void* x, const void* ca, void* out, long long batch, long long hw, int is_bf16,
                   void* stream) {
  return is_bf16 ? launch_tail_stats<__nv_bfloat16>(x, ca, out, batch * hw, hw, stream)
                 : launch_tail_stats<float>(x, ca, out, batch * hw, hw, stream);
}

// x [batch, hw, 128], sa [batch, hw, 4] and out [batch, hw, cout] f32, or
// bf16 where is_bf16 (diag only: a bf16 dense call is
// fam_tail_apply_g1_wgmma's, csrc/fam_tail_wgmma.cu); ca [batch, 128] f32; w
// in the kernel's layout (pack_tail_g1): f32, the four diagonal [32, 32]
// blocks stacked to [128, 32] when diag (cout 128), else [128, 128] with
// zero columns past cout (a multiple of 4, at most 128); bf16 and diag: the
// three bf16 pieces of the diagonal blocks, [3, 4, 32, 32]
// (TailG1Packed.mma_w).
int fam_tail_apply_g1(const void* x, const void* ca, const void* sa, const void* w, void* out, long long batch,
                      long long hw, int cout, int diag, int is_bf16, void* stream) {
  const long long n = batch * hw;
  if (is_bf16) {
    return diag ? launch_tail_apply_g1_mma(x, ca, sa, w, out, n, hw, stream) : (int)cudaErrorInvalidValue;
  }
  return diag ? launch_tail_apply_g1<true>(x, ca, sa, w, out, n, hw, cout, stream)
              : launch_tail_apply_g1<false>(x, ca, sa, w, out, n, hw, cout, stream);
}

// x and out [batch, hw, 128], sa [batch, hw, 4], f32 or bf16 where is_bf16;
// ca [batch, 128] f32.
int fam_tail_apply(const void* x, const void* ca, const void* sa, void* out, long long batch, long long hw,
                   int is_bf16, void* stream) {
  return is_bf16 ? launch_tail_apply<__nv_bfloat16>(x, ca, sa, out, batch * hw * kC4, hw, stream)
                 : launch_tail_apply<float>(x, ca, sa, out, batch * hw * kC4, hw, stream);
}

}  // extern "C"
