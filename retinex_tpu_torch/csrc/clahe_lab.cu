// Lab-CLAHE kernels for Hopper (sm_90a), behind a plain C interface.
//
// Three kernels carry the exact OpenCV Lab-CLAHE pipeline on uint8 images
// (H, W multiples of 2 * tiles):
//
//   lab_fwd_u8_kernel    sRGB u8 -> OpenCV 8-bit Lab u8, planar [B, 3, H, W]
//   clahe_tables_kernel  a u8 plane (L of Lab, or luma) -> per-tile
//                        256-entry CLAHE LUTs (row strips of each tile
//                        over the whole card)
//   clahe_apply_u8_kernel  LUT blend on L, then Lab -> sRGB u8
//
// K1 and K3 are templated on the layout of the sRGB side: planar
// [B, 3, H, W] (K1, K3) or interleaved NHWC [B, H, W, 3] (the two K8
// kernels, for the directory batches). The Lab intermediate is planar in
// both, so K2 reads a contiguous L plane; the arithmetic is the same.
//
// The Python wrappers (retinex_tpu_torch/ops/clahe_gather.py) check device,
// dtype, shape and contiguity, allocate every output, and pass PyTorch's
// current stream. Each launch function returns cudaGetLastError().
//
// Numerics follow the exact (non-fast-math) branch of the JAX package's
// kernels: true divisions, cbrtf/powf, round half to even (rintf). Build with
// -fmad=false so the compiler contracts no multiply-add into an FMA: a
// contracted matrix row can move a value across a .5 rounding tie. The LUT
// blend calls fmaf explicitly where the plain version fuses. Every float
// constant is the f32 rounding of the double the JAX package writes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHist = 256;

// Linear RGB -> XYZ (D65) and back, OpenCV's matrices.
__constant__ float kRgb2Xyz[3][3] = {
    {(float)0.412453, (float)0.357580, (float)0.180423},
    {(float)0.212671, (float)0.715160, (float)0.072169},
    {(float)0.019334, (float)0.119193, (float)0.950227},
};
__constant__ float kXyz2Rgb[3][3] = {
    {(float)3.240479, (float)-1.537150, (float)-0.498535},
    {(float)-0.969256, (float)1.875992, (float)0.041556},
    {(float)0.055648, (float)-0.204043, (float)1.057311},
};
constexpr float kXn = (float)0.950456;
constexpr float kZn = (float)1.088754;
constexpr float k16_116 = (float)(16.0 / 116.0);
constexpr float k6_29 = (float)(6.0 / 29.0);

__device__ __forceinline__ float clamp_round_u8(float v) {
  return fminf(fmaxf(rintf(v), 0.0f), 255.0f);
}

// CIE f(t): cube root above the linear-domain threshold, affine below.
__device__ __forceinline__ float lab_f(float t) {
  return t > (float)0.008856 ? cbrtf(fmaxf(t, (float)1e-12)) : (float)7.787 * t + k16_116;
}

__device__ __forceinline__ float lab_f_inv(float ft) {
  return ft > k6_29 ? ft * ft * ft : (ft - k16_116) / (float)7.787;
}

__device__ __forceinline__ float linear_to_srgb(float x) {
  x = fmaxf(x, (float)1e-12);
  return x <= (float)0.0031308 ? x * (float)12.92
                               : (float)1.055 * powf(x, (float)(1.0 / 2.4)) - (float)0.055;
}

// floor((c - 1) / 2) for c >= 0, clipped to [0, tiles - 1]: C's integer
// division truncates, so c = 0 must not be written as (c - 1) / 2.
__device__ __forceinline__ void neighbor_tiles(int c, int tiles, int* t0, int* t1) {
  const int f = (c + 1) / 2 - 1;
  *t0 = min(max(f, 0), tiles - 1);
  *t1 = min(max(f + 1, 0), tiles - 1);
}

// Blend weight of offset u inside a cell of `cell` pixels, by cell parity.
__device__ __forceinline__ float blend_weight(int c, int u, int cell) {
  const float w = (float)u / (float)(2 * cell);
  return (c & 1) ? w : w + 0.5f;
}

// ---------------------------------------------------------------------------
// K1. Replaces retinex_tpu/ops/clahe_gather.py::_fwd_kernel5 (pallas_call in
// _fwd_stage5). Bound on the card: bytes — 3 B/pixel in, 3 B/pixel out and
// ~45 operations/pixel, far under the H100's ratio of operations to bytes. Design: one
// thread per pixel, the three planes read and written at unit stride across
// a warp (coalesced), the 256-entry de-gamma table in shared memory so the
// sRGB power law costs one lookup per channel; the exact cbrtf stays.
//
// K8 (forward half). kNhwcIn = true replaces
// retinex_tpu/ops/clahe_gather.py::_fwd_kernel (pallas_call in _fwd_stage),
// which the JAX package reaches through clahe_rgb_u8_gather after an XLA
// transpose of the NHWC batch. Here the transpose is the kernel's own read:
// a warp reads 96 contiguous bytes of interleaved RGB with byte loads (a
// pixel is 3 bytes, so 16-byte vectors do not line up with pixels) and
// writes the three Lab planes at unit stride. Same bound, same arithmetic.
// ---------------------------------------------------------------------------
template <bool kNhwcIn>
__global__ void lab_fwd_u8_kernel(const uint8_t* __restrict__ rgb, uint8_t* __restrict__ lab,
                                  const float* __restrict__ degamma, long long n_pix,
                                  long long plane) {
  __shared__ float tab[kHist];
  for (int i = threadIdx.x; i < kHist; i += blockDim.x) tab[i] = degamma[i];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_pix; i += stride) {
    const long long b = i / plane;
    const long long p = b * 3 * plane + (i - b * plane);
    const uint8_t* px = rgb + (kNhwcIn ? 3 * i : p);
    const long long cs = kNhwcIn ? 1 : plane;  // channel stride of the input
    const float r = tab[px[0]], g = tab[px[cs]], bl = tab[px[2 * cs]];
    const float X = (kRgb2Xyz[0][0] * r + kRgb2Xyz[0][1] * g + kRgb2Xyz[0][2] * bl) / kXn;
    const float Y = kRgb2Xyz[1][0] * r + kRgb2Xyz[1][1] * g + kRgb2Xyz[1][2] * bl;
    const float Z = (kRgb2Xyz[2][0] * r + kRgb2Xyz[2][1] * g + kRgb2Xyz[2][2] * bl) / kZn;
    const float fx = lab_f(X), fy = lab_f(Y), fz = lab_f(Z);
    const float L8 = ((float)116.0 * fy - (float)16.0) * (float)(255.0 / 100.0);
    const float a8 = (float)500.0 * (fx - fy) + (float)128.0;
    const float b8 = (float)200.0 * (fy - fz) + (float)128.0;
    lab[p] = (uint8_t)clamp_round_u8(L8);
    lab[p + plane] = (uint8_t)clamp_round_u8(a8);
    lab[p + 2 * plane] = (uint8_t)clamp_round_u8(b8);
  }
}

// ---------------------------------------------------------------------------
// K2. Replaces retinex_tpu/ops/clahe_gather.py::_tables_kernel (pallas_call
// in _tables_stage) together with the XLA histogram _hist_cells that fed it.
// The plane is the L channel of planar Lab (img_stride 3*H*W) or a [B, H, W]
// luma plane (img_stride H*W: the clahe_luma route, as the JAX luma path
// reuses _tables_stage). Bound on the card: bytes — one read of the plane
// (1 B/pixel), 256 B out per tile; at 1088x1920 that is 0.6 us, so a launch
// and the few microseconds of one block's latency set the floor.
// Design: the histogram is spread over the whole card. Each tile's sampled
// rows are cut into `strips` row strips (clahe_gather.tables_plan: about
// four blocks per SM), one 256-thread block each, grid (tiles * strips,
// batch). A block walks its strip 16 (or 4, or 1) bytes a thread, as the
// tile's width and the row stride allow; rows advance by counters (sampled
// row j is tile row j*s in the first half-tile cell, hh + (j - per_cell)*s
// in the second), and the in-cell column decimation is a byte mask built
// once per block in shared memory, so no pixel costs a division. Pixels go
// into per-warp sub-histograms (eight copies) so that a flat region's
// pixels, which all hit one bin, contend within a warp rather than across
// the block; the block then adds its histogram into a global int32 scratch
// [B, tiles, 256] (atomicAdd, which no order changes) and counts its
// arrival at the tile (the wrapper zeroes the scratch on each call). The
// last block to arrive reads the tile's histogram from L2 and runs the tail: clip, redistribute and residual as integer math
// on the thread's own bin, the excess a block reduction, the CDF a block
// scan (warp shuffles), the LUT written straight out as [B, tiles_y,
// tiles_x, 256] u8. The TPU's byte-packed neighbour words and selection
// matmul are not needed: K3 looks up the four neighbour tables directly.
// ---------------------------------------------------------------------------
template <int kVec>
__device__ __forceinline__ void load_words(const uint8_t* p, uint32_t (&w)[(kVec + 3) / 4]) {
  if constexpr (kVec == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if constexpr (kVec == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    w[0] = *p;
  }
}

template <int kVec>
__global__ void __launch_bounds__(kHist)
    clahe_tables_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ luts, int* __restrict__ hist,
                        int* __restrict__ arrived, long long img_stride, int H, int W, int tiles_y,
                        int tiles_x, int s, int clip, float lut_scale, int strips, int rows_per_strip) {
  constexpr int kWarps = kHist / 32;
  constexpr int kWords = (kVec + 3) / 4;
  __shared__ int whist[kWarps][kHist];
  __shared__ int warp_excess[kWarps];
  __shared__ int warp_total[kWarps];
  __shared__ int is_last;
  extern __shared__ uint4 colmask_s[];  // s > 1: 1 for each tile column whose in-cell index is a multiple of s
  uint8_t* colmask = reinterpret_cast<uint8_t*>(colmask_s);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  for (int w = 0; w < kWarps; ++w) whist[w][t] = 0;

  const int tile = blockIdx.x / strips, strip = blockIdx.x - tile * strips, b = blockIdx.y;
  const int ty = tile / tiles_x, tx = tile - ty * tiles_x;
  const int hh = H / (2 * tiles_y), hw = W / (2 * tiles_x), tile_w = 2 * hw;
  if (s > 1) {
    for (int c = t; c < tile_w; c += kHist) colmask[c] = (c < hw ? c : c - hw) % s == 0;
  }
  __syncthreads();

  const uint8_t* L = src + (size_t)b * img_stride + (size_t)ty * 2 * hh * W + (size_t)tx * tile_w;
  const int per_cell = (hh + s - 1) / s;  // sampled rows per half-tile cell
  const int j0 = strip * rows_per_strip;
  const int n_rows = min(rows_per_strip, 2 * per_cell - j0);
  // Thread t reads chunk ch_first (+ 256 k where a row has more chunks than
  // threads) of rows r_first, r_first + rows_per_pass, ... of the strip.
  const int n_ch = tile_w / kVec;
  const bool narrow = n_ch <= kHist;
  const int rows_per_pass = narrow ? kHist / n_ch : 1;
  const int r_first = narrow ? t / n_ch : 0;
  const int ch_first = narrow ? t - r_first * n_ch : t;
  if (r_first < rows_per_pass) {
    for (int r = r_first; r < n_rows; r += rows_per_pass) {
      const int j = j0 + r;
      const uint8_t* row = L + (size_t)(j < per_cell ? j * s : hh + (j - per_cell) * s) * W;
      for (int ch = ch_first; ch < n_ch; ch += kHist) {
        uint32_t v[kWords], m[kWords] = {};
        load_words<kVec>(row + ch * kVec, v);
        if (s > 1) {
          load_words<kVec>(colmask + ch * kVec, m);
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int sh = 8 * (e & 3);
          if (s == 1 || ((m[e >> 2] >> sh) & 0xffu)) atomicAdd(&whist[warp][(v[e >> 2] >> sh) & 0xffu], 1);
        }
      }
    }
  }
  __syncthreads();

  int h = 0;
  for (int w = 0; w < kWarps; ++w) h += whist[w][t];
  const size_t tile_id = (size_t)b * tiles_y * tiles_x + tile;
  int* tile_hist = hist + tile_id * kHist;
  if (h) atomicAdd(tile_hist + t, h);
  __threadfence();
  __syncthreads();
  if (t == 0) is_last = atomicAdd(arrived + tile_id, 1) == strips - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  h = __ldcg(tile_hist + t);  // the other blocks' adds are in L2, not in this SM's L1

  const int clipped = min(h, clip);
  int ex = h - clipped;
  for (int o = 16; o > 0; o >>= 1) ex += __shfl_xor_sync(0xffffffffu, ex, o);
  if (lane == 0) warp_excess[warp] = ex;
  __syncthreads();
  int excess = 0;
  for (int w = 0; w < kWarps; ++w) excess += warp_excess[w];

  const int redist = excess / kHist;
  const int residual = excess - redist * kHist;
  const int step = max(kHist / max(residual, 1), 1);
  const int gets_one = (t % step == 0) && (t / step < residual);
  int v = clipped + redist + gets_one;

  // Inclusive scan over the 256 bins.
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) warp_total[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += warp_total[w];

  const float lut = clamp_round_u8((float)v * lut_scale);
  luts[tile_id * kHist + t] = (uint8_t)lut;
}

template <int kVec>
int launch_tables(const void* src, void* luts, void* scratch, long long img_stride, int batch, int H, int W,
                  int tiles_y, int tiles_x, int s, int clip, float lut_scale, int strips, int rows_per_strip,
                  void* stream) {
  const int tile_w = W / tiles_x;
  const size_t smem = s > 1 ? (size_t)(tile_w + 15) / 16 * 16 : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(clahe_tables_kernel<kVec>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long n_tiles = (long long)batch * tiles_y * tiles_x;
  int* hist = (int*)scratch;
  const dim3 grid(tiles_y * tiles_x * strips, batch);
  clahe_tables_kernel<kVec><<<grid, kHist, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (uint8_t*)luts, hist, hist + n_tiles * kHist, img_stride, H, W, tiles_y, tiles_x, s,
      clip, lut_scale, strips, rows_per_strip);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K3. Replaces retinex_tpu/ops/clahe_gather.py::_apply_kernel5 (pallas_call
// in _apply_stage5). Bound on the card: bytes — 3 B/pixel in, 3 B/pixel out
// (the tables are 16 KB per image); its ~75 operations/pixel with powf are
// still under the card's ratio. Design: a block covers 256 columns by kApplyRows
// rows inside one half-tile cell row, so its two neighbour tile rows (t0y,
// t1y) are fixed; it stages those two rows of LUTs (2 * tiles_x * 256 B) in
// shared memory and every pixel gathers its four entries from there. A
// thread keeps its column's x-neighbours and x-weight across the rows. The
// blend and the inverse Lab -> XYZ -> sRGB path are the exact branch.
//
// K8 (apply half). kNhwcOut = true replaces
// retinex_tpu/ops/clahe_gather.py::_apply_kernel (pallas_call in
// _apply_stage), whose planar output the JAX package transposes back to
// NHWC in XLA: here each thread writes its pixel's three bytes interleaved,
// so a warp stores 96 contiguous bytes. Same bound, same arithmetic.
// ---------------------------------------------------------------------------
constexpr int kApplyThreads = 256;
constexpr int kApplyRows = 16;

template <bool kNhwcOut>
__global__ void __launch_bounds__(kApplyThreads)
    clahe_apply_u8_kernel(const uint8_t* __restrict__ lab, const uint8_t* __restrict__ luts,
                          uint8_t* __restrict__ rgb, int H, int W, int tiles_y, int tiles_x,
                          int row_blocks) {
  extern __shared__ uint8_t slut[];  // [2][tiles_x][256]
  const int hh = H / (2 * tiles_y), hw = W / (2 * tiles_x);
  const int cy = blockIdx.y / row_blocks;
  const int iy0 = (blockIdx.y - cy * row_blocks) * kApplyRows;
  const int b = blockIdx.z;
  int t0y, t1y;
  neighbor_tiles(cy, tiles_y, &t0y, &t1y);

  const int n = tiles_x * kHist;
  const uint8_t* tab = luts + (size_t)b * tiles_y * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    slut[i] = tab[(size_t)t0y * n + i];
    slut[n + i] = tab[(size_t)t1y * n + i];
  }
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= W) return;
  const int cx = x / hw;
  int t0x, t1x;
  neighbor_tiles(cx, tiles_x, &t0x, &t1x);
  const float xa = blend_weight(cx, x - cx * hw, hw);
  const uint8_t* s0 = slut + t0x * kHist;
  const uint8_t* s1 = slut + t1x * kHist;
  const uint8_t* s2 = slut + n + t0x * kHist;
  const uint8_t* s3 = slut + n + t1x * kHist;

  const size_t plane = (size_t)H * W;
  const int iy1 = min(iy0 + kApplyRows, hh);
  for (int iy = iy0; iy < iy1; ++iy) {
    const float ya = blend_weight(cy, iy, hh);
    const size_t p = (size_t)b * 3 * plane + (size_t)(cy * hh + iy) * W + x;
    const int v = lab[p];
    const float l00 = s0[v], l01 = s1[v], l10 = s2[v], l11 = s3[v];
    // The three fused multiply-adds of the plain version's blend
    // (ops/clahe_fast.py::blend), each absorbing the same product.
    const float top = fmaf(l01, xa, __fmul_rn(l00, 1.0f - xa));
    const float bot = fmaf(l10, 1.0f - xa, __fmul_rn(l11, xa));
    const float L2 = clamp_round_u8(fmaf(top, 1.0f - ya, __fmul_rn(bot, ya)));

    const float a8 = lab[p + plane], b8 = lab[p + 2 * plane];
    const float fy = (L2 * (float)(100.0 / 255.0) + (float)16.0) / (float)116.0;
    const float fx = fy + (a8 - (float)128.0) / (float)500.0;
    const float fz = fy - (b8 - (float)128.0) / (float)200.0;
    const float Y = lab_f_inv(fy);
    const float X = lab_f_inv(fx) * kXn;
    const float Z = lab_f_inv(fz) * kZn;
    uint8_t* out = kNhwcOut ? rgb + 3 * ((size_t)b * plane + (size_t)(cy * hh + iy) * W + x) : rgb + p;
    const size_t cs = kNhwcOut ? 1 : plane;  // channel stride of the output
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float lin = kXyz2Rgb[c][0] * X + kXyz2Rgb[c][1] * Y + kXyz2Rgb[c][2] * Z;
      const float srgb = fminf(fmaxf(linear_to_srgb(lin), 0.0f), 1.0f);
      out[c * cs] = (uint8_t)rintf(srgb * 255.0f);
    }
  }
}

template <bool kNhwcIn>
int launch_lab_fwd(const void* rgb, void* lab, const void* degamma, long long batch,
                   long long plane, void* stream) {
  const long long n_pix = batch * plane;
  const long long want = (n_pix + 255) / 256;
  const int blocks = (int)(want < 4096 ? (want > 0 ? want : 1) : 4096);
  lab_fwd_u8_kernel<kNhwcIn><<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)rgb, (uint8_t*)lab, (const float*)degamma, n_pix, plane);
  return (int)cudaGetLastError();
}

template <bool kNhwcOut>
int launch_apply(const void* lab, const void* luts, void* rgb, int batch, int H, int W,
                 int tiles_y, int tiles_x, void* stream) {
  const int hh = H / (2 * tiles_y);
  const int row_blocks = (hh + kApplyRows - 1) / kApplyRows;
  const dim3 grid((W + kApplyThreads - 1) / kApplyThreads, 2 * tiles_y * row_blocks, batch);
  const size_t smem = (size_t)2 * tiles_x * kHist;
  clahe_apply_u8_kernel<kNhwcOut><<<grid, kApplyThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)lab, (const uint8_t*)luts, (uint8_t*)rgb, H, W, tiles_y, tiles_x,
      row_blocks);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" {

int clahe_lab_fwd_u8(const void* rgb, void* lab, const void* degamma, long long batch,
                     long long plane, void* stream) {
  return launch_lab_fwd<false>(rgb, lab, degamma, batch, plane, stream);
}

int clahe_lab_fwd_u8_nhwc(const void* rgb, void* lab, const void* degamma, long long batch,
                          long long plane, void* stream) {
  return launch_lab_fwd<true>(rgb, lab, degamma, batch, plane, stream);
}

// scratch: int32 [batch * tiles * 257], zero: the tiles' histograms, then
// their arrival counters. vec: 16, 4 or 1 bytes a
// load (the plane, img_stride, W and the tile width all multiples of it).
int clahe_tables(const void* src, void* luts, void* scratch, long long img_stride, int batch, int H, int W,
                 int tiles_y, int tiles_x, int s, int clip, float lut_scale, int strips, int rows_per_strip,
                 int vec, void* stream) {
  switch (vec) {
    case 16:
      return launch_tables<16>(src, luts, scratch, img_stride, batch, H, W, tiles_y, tiles_x, s, clip, lut_scale,
                               strips, rows_per_strip, stream);
    case 4:
      return launch_tables<4>(src, luts, scratch, img_stride, batch, H, W, tiles_y, tiles_x, s, clip, lut_scale,
                              strips, rows_per_strip, stream);
    default:
      return launch_tables<1>(src, luts, scratch, img_stride, batch, H, W, tiles_y, tiles_x, s, clip, lut_scale,
                              strips, rows_per_strip, stream);
  }
}

int clahe_apply_u8(const void* lab, const void* luts, void* rgb, int batch, int H, int W,
                   int tiles_y, int tiles_x, void* stream) {
  return launch_apply<false>(lab, luts, rgb, batch, H, W, tiles_y, tiles_x, stream);
}

int clahe_apply_u8_nhwc(const void* lab, const void* luts, void* rgb, int batch, int H, int W,
                        int tiles_y, int tiles_x, void* stream) {
  return launch_apply<true>(lab, luts, rgb, batch, H, W, tiles_y, tiles_x, stream);
}

}  // extern "C"
