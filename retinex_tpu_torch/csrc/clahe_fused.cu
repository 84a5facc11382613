// The older fused Lab-CLAHE (K16) for Hopper (sm_90a), behind a plain C
// interface: two kernels around a LUT build that stays in PyTorch.
//
//   clahe_pallas_hist_kernel   f32 NHWC RGB [B, H, W, 3] -> u8-quantised RGB
//                              -> 8-bit-scale Lab rounded to u8, planar
//                              [B, 3, H, W], and the 256-bin histogram of
//                              every tile's L, int32 [B, ty, tx, 256]
//   clahe_pallas_apply_kernel  planar u8 Lab + u8 LUTs [B, ty, tx, 256] ->
//                              4-neighbour LUT blend on L -> f32 NHWC RGB at
//                              round(v * 255) / 255
//
// They replace retinex_tpu/ops/clahe_pallas.py::_hist_kernel and
// ::_apply_kernel (the two pallas_calls in clahe_lab_rgb_pallas). H and W are
// multiples of 2 * tiles. The TPU's cell layout (an XLA transpose of the
// image into half-tile cells and back) has no counterpart: both kernels index
// NHWC f32 directly, and the Lab intermediate is planar u8 (its values are
// integers; the TPU kept them as f32 cells).
//
// The Python wrappers (retinex_tpu_torch/ops/clahe_pallas.py) check device,
// dtype, shape and contiguity, allocate every output (the histogram zeroed),
// and pass PyTorch's current stream. Each launch function returns
// cudaGetLastError().
//
// Numbers: K16's own colour arithmetic (the de-gamma as a power law on every
// pixel, the cube root as powf(max(t, 1e-12), 1/3)), written as the JAX
// function's compiled CPU program computes it and as the plain version
// writes it: every division by a constant is a multiply by its f32
// reciprocal, and fmaf stands where that program fuses a multiply-add (the
// Lab scalings, a and b's offsets, the blend). The file builds with
// -fmad=false like the others, so nothing else is contracted.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHist = 256;

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

// The f32 reciprocal of the f32 constant c (a correctly rounded division).
__device__ __forceinline__ float rc(float c) { return 1.0f / c; }

__device__ __forceinline__ float clamp_round_u8(float v) {
  return fminf(fmaxf(rintf(v), 0.0f), 255.0f);
}

__device__ __forceinline__ float srgb_to_linear(float x) {
  return x <= (float)0.04045 ? x * rc((float)12.92)
                             : powf((x + (float)0.055) * rc((float)1.055), (float)2.4);
}

__device__ __forceinline__ float lab_f(float t) {
  return t > (float)0.008856 ? powf(fmaxf(t, (float)1e-12), (float)(1.0 / 3.0))
                             : fmaf((float)7.787, t, k16_116);
}

__device__ __forceinline__ float lab_f_inv(float ft) {
  return ft > (float)(6.0 / 29.0) ? ft * ft * ft : (ft - k16_116) * rc((float)7.787);
}

// floor((c - 1) / 2) for c >= 0, clipped to [0, tiles - 1].
__device__ __forceinline__ void neighbor_tiles(int c, int tiles, int* t0, int* t1) {
  const int f = (c + 1) / 2 - 1;
  *t0 = min(max(f, 0), tiles - 1);
  *t1 = min(max(f + 1, 0), tiles - 1);
}

// K16's blend weight of offset u inside a cell of `cell` pixels, by parity.
__device__ __forceinline__ float blend_weight(int c, int u, int cell) {
  const float w = (float)u * rc((float)(2 * cell));
  return (c & 1) ? w : w + 0.5f;
}

// ---------------------------------------------------------------------------
// K16, first kernel. Bound on the card: bytes — 12 B/pixel in and 3 B/pixel
// out (plus 1 KB of histogram per tile) against ~80 operations/pixel, under
// the H100's ratio of operations to bytes. Design: a block of 256 threads
// takes kHistRows rows of one tile row across the whole width (so the grid
// has H / kHistRows * B blocks, not one per tile: a tile per block would
// leave most of the 132 SMs idle at batch 1, as 64 tiles do), converts its
// pixels one per thread per step (three loads 12 B apart, coalesced across
// the warp), writes the three Lab planes at unit stride, and counts L into
// tiles_x shared-memory histograms (shared atomics). It then adds its
// nonzero bins to the image's histograms with global atomics; integer sums,
// so the order of the blocks does not change the result.
// ---------------------------------------------------------------------------
constexpr int kHistRows = 4;

__global__ void __launch_bounds__(256)
    clahe_pallas_hist_kernel(const float* __restrict__ x, uint8_t* __restrict__ lab,
                             int* __restrict__ hist, int H, int W, int tiles_y, int tiles_x) {
  extern __shared__ int shist[];  // [tiles_x][256]
  const int n_bins = tiles_x * kHist;
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) shist[i] = 0;
  __syncthreads();

  const int th = H / tiles_y, tw = W / tiles_x;
  const int ty = blockIdx.y, b = blockIdx.z;
  const int row0 = ty * th + blockIdx.x * kHistRows;
  const int rows = min(kHistRows, (ty + 1) * th - row0);
  const size_t plane = (size_t)H * W;
  for (int i = threadIdx.x; i < rows * W; i += blockDim.x) {
    const int r = i / W, c = i - r * W;
    const size_t p = (size_t)(row0 + r) * W + c;
    const float* px = x + ((size_t)b * plane + p) * 3;
    float rgb[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float q = rintf(fminf(fmaxf(px[k], 0.0f), 1.0f) * 255.0f) * rc(255.0f);
      rgb[k] = srgb_to_linear(q);
    }
    const float X = (kRgb2Xyz[0][0] * rgb[0] + kRgb2Xyz[0][1] * rgb[1] + kRgb2Xyz[0][2] * rgb[2]) * rc(kXn);
    const float Y = kRgb2Xyz[1][0] * rgb[0] + kRgb2Xyz[1][1] * rgb[1] + kRgb2Xyz[1][2] * rgb[2];
    const float Z = (kRgb2Xyz[2][0] * rgb[0] + kRgb2Xyz[2][1] * rgb[1] + kRgb2Xyz[2][2] * rgb[2]) * rc(kZn);
    const float fx = lab_f(X), fy = lab_f(Y), fz = lab_f(Z);
    const float L8 = clamp_round_u8(fmaf(116.0f, fy, -16.0f) * (float)2.55);
    const float a8 = clamp_round_u8(fmaf(500.0f, fx - fy, 128.0f));
    const float b8 = clamp_round_u8(fmaf(200.0f, fy - fz, 128.0f));
    uint8_t* out = lab + (size_t)b * 3 * plane + p;
    out[0] = (uint8_t)L8;
    out[plane] = (uint8_t)a8;
    out[2 * plane] = (uint8_t)b8;
    atomicAdd(&shist[(c / tw) * kHist + (int)L8], 1);
  }
  __syncthreads();
  int* dst = hist + ((size_t)b * tiles_y + ty) * n_bins;
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) {
    const int n = shist[i];
    if (n) atomicAdd(&dst[i], n);
  }
}

// ---------------------------------------------------------------------------
// K16, second kernel. Bound on the card: bytes — 3 B/pixel in and 12 B/pixel
// out (the tables are 16 KB per image) against ~80 operations/pixel with
// three powf. Design: K3's (csrc/clahe_lab.cu) — a block covers 256 columns
// by kApplyRows rows inside one half-tile cell row, stages that cell row's
// two neighbour rows of LUTs (2 * tiles_x * 256 B) in shared memory, and each
// thread keeps its column's x-neighbours and x-weight across the rows — with
// K16's weights and blend, and f32 NHWC out: each thread writes its pixel's
// three floats, so a warp stores 384 contiguous bytes.
// ---------------------------------------------------------------------------
constexpr int kApplyThreads = 256;
constexpr int kApplyRows = 16;

__global__ void __launch_bounds__(kApplyThreads)
    clahe_pallas_apply_kernel(const uint8_t* __restrict__ lab, const uint8_t* __restrict__ luts,
                              float* __restrict__ rgb, int H, int W, int tiles_y, int tiles_x,
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
    const size_t p = (size_t)(cy * hh + iy) * W + x;
    const uint8_t* lp = lab + (size_t)b * 3 * plane + p;
    const int v = lp[0];
    const float l00 = s0[v], l01 = s1[v], l10 = s2[v], l11 = s3[v];
    // The three fused multiply-adds of the plain version's blend
    // (ops/clahe_pallas.py::_blend), each absorbing the same product.
    const float top = fmaf(l01, xa, __fmul_rn(l00, 1.0f - xa));
    const float bot = fmaf(l11, xa, __fmul_rn(l10, 1.0f - xa));
    const float L2 = clamp_round_u8(fmaf(top, 1.0f - ya, __fmul_rn(bot, ya)));

    const float a8 = lp[plane], b8 = lp[2 * plane];
    const float fy = (L2 * (float)(100.0 / 255.0) + 16.0f) * rc(116.0f);
    const float fx = fmaf(a8 - 128.0f, rc(500.0f), fy);
    const float fz = fmaf(128.0f - b8, rc(200.0f), fy);
    const float Y = lab_f_inv(fy);
    const float X = lab_f_inv(fx) * kXn;
    const float Z = lab_f_inv(fz) * kZn;
    float* out = rgb + ((size_t)b * plane + p) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float lin = fmaxf(kXyz2Rgb[c][0] * X + kXyz2Rgb[c][1] * Y + kXyz2Rgb[c][2] * Z, 0.0f);
      const float s = lin <= (float)0.0031308
                          ? lin * (float)12.92
                          : (float)1.055 * powf(lin, (float)(1.0 / 2.4)) - (float)0.055;
      out[c] = rintf(fminf(fmaxf(s, 0.0f), 1.0f) * 255.0f) * rc(255.0f);
    }
  }
}

}  // namespace

extern "C" {

int clahe_pallas_hist(const void* x, void* lab, void* hist, int batch, int H, int W, int tiles_y,
                      int tiles_x, void* stream) {
  const int th = H / tiles_y;
  const int row_blocks = (th + kHistRows - 1) / kHistRows;
  const dim3 grid(row_blocks, tiles_y, batch);
  const size_t smem = (size_t)tiles_x * kHist * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(clahe_pallas_hist_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  clahe_pallas_hist_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      (const float*)x, (uint8_t*)lab, (int*)hist, H, W, tiles_y, tiles_x);
  return (int)cudaGetLastError();
}

int clahe_pallas_apply(const void* lab, const void* luts, void* rgb, int batch, int H, int W,
                       int tiles_y, int tiles_x, void* stream) {
  const int hh = H / (2 * tiles_y);
  const int row_blocks = (hh + kApplyRows - 1) / kApplyRows;
  const dim3 grid((W + kApplyThreads - 1) / kApplyThreads, 2 * tiles_y * row_blocks, batch);
  const size_t smem = (size_t)2 * tiles_x * kHist;
  clahe_pallas_apply_kernel<<<grid, kApplyThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)lab, (const uint8_t*)luts, (float*)rgb, H, W, tiles_y, tiles_x, row_blocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
