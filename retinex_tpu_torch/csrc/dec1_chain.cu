// K10, the packed dec1 chain, for Hopper (sm_90a), behind a plain C interface.
//
// Replaces retinex_tpu/ops/fused_blocks.py::_dec1_kernel (pallas_call in
// dec1_chain). On f32 NHWC tensors, with the BatchNorm affines folded into the
// kernels and biases by the caller (models/packed_inference.py):
//
//   y1  = d2 @ k_up + b_up                       1x1, 64 -> 128
//   y2  = relu(conv3x3(y1, k_c1) + b_c1)          128 -> 128
//   y3  = relu(conv3x3(y2, k_c2) + b_c2) + x1p    128 -> 128
//   out = relu(conv3x3(y3, k_rc) + b_rc)          128 -> 128 (residual_conv)
//
// d2 [B,H,W,64], x1p and out [B,H,W,128], k_up [64,128], the 3x3 kernels HWIO
// [3,3,128,128], biases [128]. Every conv has 'SAME' zero padding, so each
// intermediate is exactly zero outside the image before the next stage reads
// it: the 1x1's bias and relu(bias) must not leak into the halo.
//
// Bound on the card: operations — 2 * (64*128 + 3*9*128*128) FLOP per pixel
// against 1.25 KB of activations in and out, ~700 FLOP/B, far above the
// H100's f32 ratio of 20 FLOP/B. Design: one block of 256 threads per 8x8
// output tile; no intermediate goes to device memory.
//  - Halo growth: three 3x3 stages after the 1x1 need y1 on a 14x14 tile
//    (halo 3), y2 on 12x12 (halo 2) and y3 on 10x10 (halo 1). y1 (100,352 B)
//    and y2 (73,728 B) sit in shared memory, 174,080 B, one block per SM. The
//    d2 tile (14x14x64, 50,176 B) is staged in y2's buffer before y2 exists,
//    and y3 overwrites y1's buffer once y2 is made.
//  - Recompute: the halos cost (144 + 100 + 64) / 64 = 4.8 of the 3 ideal 3x3
//    stages per output pixel, 1.6x the chain's operations.
//  - Register tiling as in K4 (csrc/fam_fused.cu): warp w owns pixels w,
//    w + 8, ... of a stage, lane l output channels 4l..4l+3; the activations
//    are shared-memory broadcasts (every lane of a warp reads one float4), and
//    each weight row is one coalesced 512 B warp read from L1/L2 (the 1.8 MB
//    of weights stay L2-resident). The x1p residual is read from device
//    memory in the y3 stage, the same way.
//  - The dot products call fmaf; the file builds with -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 128;   // packed dec1 width
constexpr int kC4 = kC / 4;
constexpr int kCin0 = 64;  // d2 channels
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 8;  // output tile side
constexpr int kS1 = kT + 6, kS2 = kT + 4, kS3 = kT + 2;  // y1, y2, y3 tile sides
constexpr int kY1Float4 = kS1 * kS1 * kC4;
constexpr int kY2Float4 = kS2 * kS2 * kC4;
constexpr size_t kSmem = (size_t)(kY1Float4 + kY2Float4) * sizeof(float4);
static_assert(kS1 * kS1 * (kCin0 / 4) <= kY2Float4, "the d2 tile fits y2's buffer");
static_assert(kS3 * kS3 <= kS1 * kS1, "y3 fits y1's buffer");

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// acc[0..3] += x . (w0, w1, w2, w3): four input channels into four outputs.
__device__ __forceinline__ void fma4(float (&acc)[4], const float4 x, const float4 w0,
                                     const float4 w1, const float4 w2, const float4 w3) {
  acc[0] = fmaf(x.x, w0.x, acc[0]);
  acc[1] = fmaf(x.x, w0.y, acc[1]);
  acc[2] = fmaf(x.x, w0.z, acc[2]);
  acc[3] = fmaf(x.x, w0.w, acc[3]);
  acc[0] = fmaf(x.y, w1.x, acc[0]);
  acc[1] = fmaf(x.y, w1.y, acc[1]);
  acc[2] = fmaf(x.y, w1.z, acc[2]);
  acc[3] = fmaf(x.y, w1.w, acc[3]);
  acc[0] = fmaf(x.z, w2.x, acc[0]);
  acc[1] = fmaf(x.z, w2.y, acc[1]);
  acc[2] = fmaf(x.z, w2.z, acc[2]);
  acc[3] = fmaf(x.z, w2.w, acc[3]);
  acc[0] = fmaf(x.w, w3.x, acc[0]);
  acc[1] = fmaf(x.w, w3.y, acc[1]);
  acc[2] = fmaf(x.w, w3.z, acc[2]);
  acc[3] = fmaf(x.w, w3.w, acc[3]);
}

enum Stage { kY1, kY2, kY3, kOut };

// One stage on a tile of side `out_side` whose first pixel is image pixel
// (r0 - halo, c0 - halo): out = src (*) w + bias, a KS x KS conv over the
// src tile (side out_side + KS - 1, CIN channels, float4 pixel stride CIN/4),
// then the stage's epilogue. Pixels are taken NPIX per warp per pass.
template <int NPIX, int KS, int CIN, Stage S>
__device__ __forceinline__ void conv_stage(const float4* __restrict__ src, float4* __restrict__ dst,
                                          int out_side, int halo, const float* __restrict__ w,
                                          const float* __restrict__ bias, int r0, int c0, int H,
                                          int W, const float* __restrict__ x1p,
                                          float* __restrict__ out) {
  constexpr int kCin4 = CIN / 4;
  const int cg = threadIdx.x & 31, pg = threadIdx.x >> 5;
  const int src_side = out_side + KS - 1;
  const int n_pix = out_side * out_side;
  const float4 b = ldg4(bias + 4 * cg);
  for (int base = 0; base < n_pix; base += kWarps * NPIX) {
    // Pixels past the tile (the last pass) read pixel 0 and are never stored.
    int off[NPIX];
    float acc[NPIX][4];
#pragma unroll
    for (int i = 0; i < NPIX; ++i) {
      const int p = base + pg + kWarps * i;
      const int q = p < n_pix ? p : 0;
      off[i] = ((q / out_side) * src_side + q % out_side) * kCin4;
      acc[i][0] = b.x;
      acc[i][1] = b.y;
      acc[i][2] = b.z;
      acc[i][3] = b.w;
    }
    for (int u = 0; u < KS; ++u) {
      for (int v = 0; v < KS; ++v) {
        const float* wt = w + (size_t)(u * KS + v) * CIN * kC + 4 * cg;
        const float4* s = src + (u * src_side + v) * kCin4;
#pragma unroll 2
        for (int k = 0; k < CIN; k += 4) {
          const float4 w0 = ldg4(wt + (size_t)k * kC), w1 = ldg4(wt + (size_t)(k + 1) * kC);
          const float4 w2 = ldg4(wt + (size_t)(k + 2) * kC), w3 = ldg4(wt + (size_t)(k + 3) * kC);
#pragma unroll
          for (int i = 0; i < NPIX; ++i) fma4(acc[i], s[off[i] + k / 4], w0, w1, w2, w3);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NPIX; ++i) {
      const int p = base + pg + kWarps * i;
      if (p >= n_pix) continue;
      const int gy = r0 - halo + p / out_side, gx = c0 - halo + p % out_side;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      if (S != kY1) v = make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
      if (S == kOut) {
        if (in) *reinterpret_cast<float4*>(out + ((size_t)gy * W + gx) * kC + 4 * cg) = v;
        continue;
      }
      if (S == kY3 && in) {
        const float4 r = ldg4(x1p + ((size_t)gy * W + gx) * kC + 4 * cg);
        v = make_float4(v.x + r.x, v.y + r.y, v.z + r.z, v.w + r.w);
      }
      dst[p * kC4 + cg] = in ? v : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    dec1_chain_kernel(const float* __restrict__ d2, const float* __restrict__ x1p,
                      const float* __restrict__ k_up, const float* __restrict__ b_up,
                      const float* __restrict__ k_c1, const float* __restrict__ b_c1,
                      const float* __restrict__ k_c2, const float* __restrict__ b_c2,
                      const float* __restrict__ k_rc, const float* __restrict__ b_rc,
                      float* __restrict__ out, int H, int W) {
  extern __shared__ float4 smem[];
  float4* y1 = smem;              // y1 [14*14][32], then y3 [10*10][32]
  float4* y2 = smem + kY1Float4;  // the d2 tile [14*14][16], then y2 [12*12][32]
  const int r0 = blockIdx.y * kT, c0 = blockIdx.x * kT;
  const size_t img = (size_t)blockIdx.z * H * W;
  const float* d2b = d2 + img * kCin0;
  const float* x1b = x1p + img * kC;
  float* ob = out + img * kC;

  // The d2 tile with halo 3, zero outside the image (y1 is masked there anyway).
  constexpr int kD4 = kCin0 / 4;
  for (int i = threadIdx.x; i < kS1 * kS1 * kD4; i += kThreads) {
    const int c4 = i % kD4, pix = i / kD4;
    const int gy = r0 - 3 + pix / kS1, gx = c0 - 3 + pix % kS1;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = ldg4(d2b + ((size_t)gy * W + gx) * kCin0 + 4 * c4);
    y2[i] = v;
  }
  __syncthreads();
  // 196 pixels: two passes of 8 warps x 13.
  conv_stage<13, 1, kCin0, kY1>(y2, y1, kS1, 3, k_up, b_up, r0, c0, H, W, nullptr, nullptr);
  __syncthreads();
  conv_stage<18, 3, kC, kY2>(y1, y2, kS2, 2, k_c1, b_c1, r0, c0, H, W, nullptr, nullptr);  // 144
  __syncthreads();
  conv_stage<13, 3, kC, kY3>(y2, y1, kS3, 1, k_c2, b_c2, r0, c0, H, W, x1b, nullptr);  // 100
  __syncthreads();
  conv_stage<8, 3, kC, kOut>(y1, nullptr, kT, 0, k_rc, b_rc, r0, c0, H, W, nullptr, ob);  // 64
}

}  // namespace

extern "C" {

int dec1_chain(const void* d2, const void* x1p, const void* k_up, const void* b_up,
               const void* k_c1, const void* b_c1, const void* k_c2, const void* b_c2,
               const void* k_rc, const void* b_rc, void* out, int batch, int H, int W,
               void* stream) {
  cudaError_t err = cudaFuncSetAttribute(dec1_chain_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kT - 1) / kT, (H + kT - 1) / kT, batch);
  dec1_chain_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      (const float*)d2, (const float*)x1p, (const float*)k_up, (const float*)b_up,
      (const float*)k_c1, (const float*)b_c1, (const float*)k_c2, (const float*)b_c2,
      (const float*)k_rc, (const float*)b_rc, (float*)out, H, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
