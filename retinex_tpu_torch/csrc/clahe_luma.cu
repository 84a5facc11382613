// Luma-gain CLAHE apply for Hopper (sm_90a), behind a plain C interface.
//
// One kernel, templated on where the luma comes from and on the RGB layout,
// carries the apply stage of the clahe_luma mode on uint8 images (H, W
// multiples of 2 * tiles):
//
//   clahe_luma_apply_kernel<false, kNhwc>  (K7) takes the u8 luma plane
//                                          [B, H, W]; RGB in and out planar
//                                          [B, 3, H, W] or, with kNhwc, NHWC
//                                          [B, H, W, 3]
//   clahe_luma_apply_kernel<true, false>   (K9) recomputes the luma from the
//                                          planar RGB it already loads (no
//                                          luma operand)
//
// The tile LUTs come from K2 (clahe_lab.cu::clahe_tables_kernel) run on the
// luma plane. The Python wrappers (retinex_tpu_torch/ops/clahe_luma.py)
// check device, dtype, shape and contiguity, allocate every output, and pass
// PyTorch's current stream. Each launch function returns cudaGetLastError().
//
// Numerics: build with -fmad=false, so the compiler contracts nothing; the
// LUT blend calls fmaf where the plain version (ops/clahe_fast.py::blend)
// fuses, and the in-kernel luma calls fmaf where the JAX package's compiled
// CPU program contracts 0.299 r + 0.587 g + 0.114 b (settled over all 2^24
// RGB triples). The gain is a true division, as _RECIP_GAIN=False has it,
// and every rounding is half to even (rintf).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHist = 256;
constexpr int kThreads = 256;
constexpr int kRows = 16;
constexpr float kLumaR = (float)0.299;
constexpr float kLumaG = (float)0.587;
constexpr float kLumaB = (float)0.114;

__device__ __forceinline__ float clamp_round_u8(float v) {
  return fminf(fmaxf(rintf(v), 0.0f), 255.0f);
}

// floor((c - 1) / 2) for c >= 0, clipped to [0, tiles - 1] (as in
// clahe_lab.cu: C's integer division truncates, so c = 0 is special).
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

// BT.601 luma of u8-valued channels, rounded to u8:
// fma(0.114, b, fma(0.299, r, 0.587 * g)).
__device__ __forceinline__ float luma_u8(float r, float g, float b) {
  return clamp_round_u8(fmaf(kLumaB, b, fmaf(kLumaR, r, __fmul_rn(kLumaG, g))));
}

// ---------------------------------------------------------------------------
// K7. Replaces retinex_tpu/ops/clahe_luma.py::_apply_luma_kernel5
// (pallas_call in _apply_luma_stage5). K9 (kFused = true) replaces
// ::_apply_luma_kernel5_fused (pallas_call in _apply_luma_stage5_fused).
// Bound on the card: bytes — K7 reads 3 B of RGB and 1 B of luma per pixel
// and writes 3 B; K9 drops the luma byte. About 25 operations per pixel
// (blend, one division, three scales), far under the card's ratio of
// operations to bytes. Design: as K3, one thread per pixel; a block covers
// 256 columns by kRows rows inside one half-tile cell row, so its two
// neighbour tile rows are fixed and it stages those two rows of LUTs
// (2 * tiles_x * 256 B) in shared memory; a thread keeps its column's
// x-neighbours and x-weight across the rows. Loads and stores are one byte a
// thread at unit stride across the warp, plane by plane; with kNhwc a warp
// covers 96 contiguous bytes, as K8 does (clahe_lab.cu), and the transpose
// the JAX package does in XLA is the kernel's own indexing. The TPU kernel's
// byte-packed neighbour words and lane gathers are not needed: each pixel
// reads its four LUT entries from shared memory directly.
// ---------------------------------------------------------------------------
template <bool kFused, bool kNhwc>
__global__ void __launch_bounds__(kThreads)
    clahe_luma_apply_kernel(const uint8_t* __restrict__ rgb, const uint8_t* __restrict__ luma,
                            const uint8_t* __restrict__ luts, uint8_t* __restrict__ out, int H,
                            int W, int tiles_y, int tiles_x, int row_blocks) {
  extern __shared__ uint8_t slut[];  // [2][tiles_x][256]
  const int hh = H / (2 * tiles_y), hw = W / (2 * tiles_x);
  const int cy = blockIdx.y / row_blocks;
  const int iy0 = (blockIdx.y - cy * row_blocks) * kRows;
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
  const int iy1 = min(iy0 + kRows, hh);
  for (int iy = iy0; iy < iy1; ++iy) {
    const float ya = blend_weight(cy, iy, hh);
    const size_t q = (size_t)b * plane + (size_t)(cy * hh + iy) * W + x;  // luma index
    const size_t p = kNhwc ? 3 * q : q + (size_t)b * 2 * plane;          // red index
    const size_t cs = kNhwc ? 1 : plane;                                 // channel stride
    const float r = rgb[p], g = rgb[p + cs], bl = rgb[p + 2 * cs];
    const int v = kFused ? (int)luma_u8(r, g, bl) : (int)luma[q];
    const float l00 = s0[v], l01 = s1[v], l10 = s2[v], l11 = s3[v];
    // The three fused multiply-adds of ops/clahe_fast.py::blend.
    const float top = fmaf(l01, xa, __fmul_rn(l00, 1.0f - xa));
    const float bot = fmaf(l10, 1.0f - xa, __fmul_rn(l11, xa));
    const float y_eq = clamp_round_u8(fmaf(top, 1.0f - ya, __fmul_rn(bot, ya)));
    const float gain = __fdiv_rn(y_eq + 1.0f, (float)v + 1.0f);
    out[p] = (uint8_t)rintf(fminf(fmaxf(__fmul_rn(r, gain), 0.0f), 255.0f));
    out[p + cs] = (uint8_t)rintf(fminf(fmaxf(__fmul_rn(g, gain), 0.0f), 255.0f));
    out[p + 2 * cs] = (uint8_t)rintf(fminf(fmaxf(__fmul_rn(bl, gain), 0.0f), 255.0f));
  }
}

template <bool kFused, bool kNhwc>
int launch_luma_apply(const void* rgb, const void* luma, const void* luts, void* out, int batch,
                      int H, int W, int tiles_y, int tiles_x, void* stream) {
  const int hh = H / (2 * tiles_y);
  const int row_blocks = (hh + kRows - 1) / kRows;
  const dim3 grid((W + kThreads - 1) / kThreads, 2 * tiles_y * row_blocks, batch);
  const size_t smem = (size_t)2 * tiles_x * kHist;
  clahe_luma_apply_kernel<kFused, kNhwc><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)rgb, (const uint8_t*)luma, (const uint8_t*)luts, (uint8_t*)out, H, W,
      tiles_y, tiles_x, row_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int clahe_luma_apply_u8(const void* rgb, const void* luma, const void* luts, void* out, int batch,
                        int H, int W, int tiles_y, int tiles_x, void* stream) {
  return launch_luma_apply<false, false>(rgb, luma, luts, out, batch, H, W, tiles_y, tiles_x, stream);
}

int clahe_luma_apply_u8_nhwc(const void* rgb, const void* luma, const void* luts, void* out,
                             int batch, int H, int W, int tiles_y, int tiles_x, void* stream) {
  return launch_luma_apply<false, true>(rgb, luma, luts, out, batch, H, W, tiles_y, tiles_x, stream);
}

int clahe_luma_apply_u8_fused(const void* rgb, const void* luts, void* out, int batch, int H,
                              int W, int tiles_y, int tiles_x, void* stream) {
  return launch_luma_apply<true, false>(rgb, nullptr, luts, out, batch, H, W, tiles_y, tiles_x, stream);
}

}  // extern "C"
