// FAM kernels for Hopper (sm_90a), behind a plain C interface.
//
// Four kernels carry the packed (space-to-depth) EnhancedFAM of the scale-1
// and scale-2 towers on f32 or bf16 NHWC activations [B, H, W, 128], the 128
// channels being four quadrants of 32 (packed channel (a*2 + b)*32 + c):
//
//   fam_conv_out_kernel       K4's last stage: relu(z + x @ ka + maxpool(x) @
//                             kb) -> [B, H, W, 128], after K4's two 3x3
//                             convolutions (y, z) on conv_pipelined.cu (f32)
//                             or conv_wgmma.cu (bf16, z in f32)
//   fam_tail_stats_kernel     x * ca -> per-quadrant channel mean/max [B,H,W,8]
//   fam_tail_apply_g1_kernel  (x * ca * sa per quadrant) @ W -> [B,H,W,Cout]
//                             (templated: W dense or quadrant-block-diagonal)
//   fam_tail_apply_kernel     x * ca * sa per quadrant -> [B,H,W,128] (the
//                             tail where the tower's fusion does not fold)
//
// The Python wrappers (retinex_tpu_torch/ops/fused_blocks.py) check device,
// dtype, shape and contiguity, allocate every output, and pass PyTorch's
// current stream. Each launch function returns cudaGetLastError().
//
// Each kernel is templated on the activations' element type T: f32, or bf16
// for the --use_amp net, whose instances round where the JAX kernels round
// their bf16 instances (T = bf16 there: a bf16 x bf16 product is exact in
// f32 and rounded to bf16 once, so it equals JAX's bf16 multiply):
//   fam_conv_out   x, ka, kb bf16; z f32 (K4 never rounds it); the products
//                  summed in f32; the output rounded once;
//   tail_stats     x * ca rounded; means and maxima in f32; output rounded;
//   tail_apply_g1  x * ca rounded, * sa rounded; the product with the f32 w
//                  in f32; the output rounded;
//   tail_apply     x * ca rounded, * sa rounded.
// ca and w are f32 in both (ca is rounded to T inside, as the JAX kernels
// cast it to x.dtype); sa is in T. The f32 instances compute what they did
// before the templates, bit for bit.
//
// Arithmetic is f32 on the CUDA cores (no TF32, no tensor cores). The dot
// products call fmaf explicitly; the file builds with -fmad=false like the
// other sources, which only keeps the compiler from contracting anything else.

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
// mode, since the JAX kernel never rounds it); this kernel reads bf16 x and
// [ka; kb], f32 z, and rounds the output once.
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
// Shared memory: the x tile, the pooled tile (both px_stride<T>() a pixel)
// and two stages of [ka; kb] rows, in T: 107,200 B in f32, 54,976 B in bf16.
template <typename T>
constexpr size_t out_smem() {
  return sizeof(T) * ((size_t)(kOutHaloPx + kOutPix) * px_stride<T>() + 2 * kWRows * kC);
}
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

template <typename T>
__global__ void __launch_bounds__(kOutThreads, kOutBlocks)
    fam_conv_out_kernel(const float* __restrict__ z, const T* __restrict__ x, const T* __restrict__ w,
                        T* __restrict__ out, int H, int W) {
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
// Design: one kernel body, templated on w's layout. kDiag: the four
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
// - bf16 (T = bf16): the x tile and its sa stay bf16 in shared memory (a
//   pixel row of 136 elements), the scaling rounds x * ca and then * sa to
//   bf16 in place (lossless: the values are bf16), the products read them
//   as f32 against the f32 w, and the outputs are rounded to bf16 (8-byte
//   stores). Its bytes a pixel are half the f32 instance's.
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
template <typename T, bool kDiag>
constexpr size_t g1_smem() {
  return sizeof(float) * (size_t)kC * g1_wcols<kDiag>() + sizeof(T) * kG1Stages * (size_t)g1_stage_elems<T>();
}

template <typename T, bool kDiag>
__global__ void __launch_bounds__(kG1Threads, 1)
    fam_tail_apply_g1_kernel(const T* __restrict__ x, const float* __restrict__ ca, const T* __restrict__ sa,
                             const float* __restrict__ w, T* __restrict__ out, long long hw, long long n_pix,
                             int cout) {
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
    if (t < kG1Pix) {  // the pixel's 4 sa values: 16 B in f32, 8 B in bf16
      const bool in = p0 + t < n_pix;
      const uint32_t dst = smem_u32(xs + kG1Pix * kS + 4 * t);
      const T* src = in ? sa + (p0 + t) * 4 : sa;
      if (sizeof(T) == 4) {
        cp_async16(dst, src, in ? 16 : 0);
      } else {
        cp_async8(dst, src, in ? 8 : 0);
      }
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

template <typename T, bool kDiag>
int launch_tail_apply_g1(const void* x, const void* ca, const void* sa, const void* w, void* out, long long n_pix,
                         long long hw, int cout, void* stream) {
  if (n_pix == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(fam_tail_apply_g1_kernel<T, kDiag>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g1_smem<T, kDiag>());
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)err;
  const long long n_tiles = (n_pix + kG1Pix - 1) / kG1Pix;
  const unsigned blocks = (unsigned)(n_tiles < sms ? n_tiles : sms);
  fam_tail_apply_g1_kernel<T, kDiag><<<blocks, kG1Threads, g1_smem<T, kDiag>(), (cudaStream_t)stream>>>(
      (const T*)x, (const float*)ca, (const T*)sa, (const float*)w, (T*)out, hw, n_pix, cout);
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

template <typename T>
int launch_conv_out(const void* z, const void* x, const void* w, void* out, int batch, int H, int W, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(fam_conv_out_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)out_smem<T>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kOutTW - 1) / kOutTW, (H + kOutTH - 1) / kOutTH, batch);
  fam_conv_out_kernel<T><<<grid, kOutThreads, out_smem<T>(), (cudaStream_t)stream>>>(
      (const float*)z, (const T*)x, (const T*)w, (T*)out, H, W);
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
// is_bf16; w = [ka; kb] [256, 128] in x's type: out = relu(z + x @ ka +
// maxpool3x3_s2d(x) @ kb).
int fam_conv_out(const void* z, const void* x, const void* w, void* out, int batch, int H, int W, int is_bf16,
                 void* stream) {
  return is_bf16 ? launch_conv_out<__nv_bfloat16>(z, x, w, out, batch, H, W, stream)
                 : launch_conv_out<float>(z, x, w, out, batch, H, W, stream);
}

// x [batch, hw, 128] and out [batch, hw, 8] f32, or bf16 where is_bf16; ca
// [batch, 128] f32.
int fam_tail_stats(const void* x, const void* ca, void* out, long long batch, long long hw, int is_bf16,
                   void* stream) {
  return is_bf16 ? launch_tail_stats<__nv_bfloat16>(x, ca, out, batch * hw, hw, stream)
                 : launch_tail_stats<float>(x, ca, out, batch * hw, hw, stream);
}

// x [batch, hw, 128], sa [batch, hw, 4] and out [batch, hw, cout] f32, or
// bf16 where is_bf16; ca [batch, 128] f32; w f32 in the kernel's layout
// (pack_tail_g1): the four diagonal [32, 32] blocks stacked to [128, 32]
// when diag (cout 128), else [128, 128] with zero columns past cout (a
// multiple of 4, at most 128).
int fam_tail_apply_g1(const void* x, const void* ca, const void* sa, const void* w, void* out, long long batch,
                      long long hw, int cout, int diag, int is_bf16, void* stream) {
  const long long n = batch * hw;
  if (is_bf16) {
    return diag ? launch_tail_apply_g1<__nv_bfloat16, true>(x, ca, sa, w, out, n, hw, cout, stream)
                : launch_tail_apply_g1<__nv_bfloat16, false>(x, ca, sa, w, out, n, hw, cout, stream);
  }
  return diag ? launch_tail_apply_g1<float, true>(x, ca, sa, w, out, n, hw, cout, stream)
              : launch_tail_apply_g1<float, false>(x, ca, sa, w, out, n, hw, cout, stream);
}

// x and out [batch, hw, 128], sa [batch, hw, 4], f32 or bf16 where is_bf16;
// ca [batch, 128] f32.
int fam_tail_apply(const void* x, const void* ca, const void* sa, void* out, long long batch, long long hw,
                   int is_bf16, void* stream) {
  return is_bf16 ? launch_tail_apply<__nv_bfloat16>(x, ca, sa, out, batch * hw * kC4, hw, stream)
                 : launch_tail_apply<float>(x, ca, sa, out, batch * hw * kC4, hw, stream);
}

}  // extern "C"
