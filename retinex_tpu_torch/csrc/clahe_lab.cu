// Lab-CLAHE kernels for Hopper (sm_90a), behind a plain C interface.
//
// Three kernels carry the exact OpenCV Lab-CLAHE pipeline:
//
//   lab_fwd_kernel       sRGB -> OpenCV 8-bit Lab u8, planar [B, 3, H, W]
//                        (any H and W)
//   clahe_tables_kernel  a u8 plane (L of Lab, or luma) -> per-tile
//                        256-entry CLAHE LUTs (row strips of each tile
//                        over the whole card)
//   clahe_apply_kernel   LUT blend on L, then Lab -> sRGB
//
// K2 and K3 each run in two modes. On cell-divisible frames (H, W
// multiples of 2 * tiles) they use the half-tile cells (ApplyMode kCells).
// On every other frame they run clahe_u8's semantics (ops/clahe.py): K2
// builds the tables of the reflect-101 padded tiles (kPad), and K3 reads
// each row's and each column's tile pair and weight from a geometry the
// host made with the plain version's own arithmetic (kTiles). A third body,
// lab_hist_kernel, and K3's kK16 mode run the older fused op K16
// (ops/clahe_pallas.py) with its own arithmetic.
//
// K1 and K3 are templated on the layout of the sRGB side (Layout below):
// planar u8 [B, 3, H, W] (K1, K3), interleaved u8 NHWC [B, H, W, 3] (the two
// K8 kernels, for the directory batches), and float [B, H, W, 3] in [0, 1]
// (the main path's instances: K1 quantises the net's output as it reads it,
// K3 writes the float image, so no elementwise pass runs around them). The
// Lab intermediate is planar in all of them, so K2 reads a contiguous L
// plane; the arithmetic is the same in every instance.
//
// The Python wrappers (retinex_tpu_torch/ops/clahe_gather.py) check device,
// dtype, shape, contiguity and alignment, pick the access width and K3's
// row bands, allocate every output, and pass PyTorch's current stream. Each
// launch function returns cudaGetLastError().
//
// Numerics follow the exact (non-fast-math) branch of the JAX package's
// kernels: true divisions, cbrtf, round half to even (rintf). Build with
// -fmad=false so the compiler contracts no multiply-add into an FMA: a
// contracted matrix row can move a value across a .5 rounding tie. The LUT
// blend calls fmaf explicitly where the plain version fuses. Every float
// constant is the f32 rounding of the double the JAX package writes. K3's
// tables are built on the host by the plain version's own f32 operations
// (clahe_gather.apply_tables), so a lookup returns the bits the expression
// would.

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

// Layouts of the sRGB side of K1 and K3 (clahe_gather.py numbers them alike).
enum Layout : int {
  kU8Planar = 0,   // u8 [B, 3, H, W]
  kU8Nhwc = 1,     // u8 [B, H, W, 3]
  kF32Planar = 2,  // f32 [B, H, W, 3] stored channels first (the net's output is a permuted NCHW tensor); K1 only
  kF32Nhwc = 3,    // f32 [B, H, W, 3] contiguous
};

__device__ __forceinline__ float clamp_round_u8(float v) {
  return fminf(fmaxf(rintf(v), 0.0f), 255.0f);
}

// The same byte as clamp_round_u8, as an integer (rounding half to even).
__device__ __forceinline__ int to_u8(float v) {
  return min(max(__float2int_rn(v), 0), 255);
}

// CIE f(t): cube root above the linear-domain threshold, affine below;
// both sides computed, so a thread's pixels share no branch.
__device__ __forceinline__ float lab_f(float t) {
  const float root = cbrtf(fmaxf(t, (float)1e-12)), line = (float)7.787 * t + k16_116;
  return t > (float)0.008856 ? root : line;
}

// The cube root of t > 0 rounded to nearest, as the plain version's
// pow(double(t), 1/3) rounded to f32 gives it (the two part only where the
// root lies within 2^-51 of a tie; the cube test over every sRGB triple
// checks that none does), from cbrtf's root r (within 1 ulp): r moved to a
// neighbour where the root lies past the midpoint between them. The
// midpoints have 25 significant bits, so their squares are exact in double
// and their cubes within 2^-53.
__device__ __forceinline__ float cbrt_rn(float r, float t) {
  const int bits = __float_as_int(r);
  const double d = r, td = t;
  const double up = 0.5 * (d + (double)__int_as_float(bits + 1));
  const double dn = 0.5 * (d + (double)__int_as_float(bits - 1));
  if (__dmul_rn(__dmul_rn(up, up), up) < td) return __int_as_float(bits + 1);
  if (__dmul_rn(__dmul_rn(dn, dn), dn) > td) return __int_as_float(bits - 1);
  return r;
}

// lab_f's value f at t, with the root rounded to nearest.
__device__ __forceinline__ float lab_f_rn(float f, float t) {
  return t > (float)0.008856 ? cbrt_rn(f, fmaxf(t, (float)1e-12)) : f;
}

// K1's Lab values (before rounding) from f(X), f(Y), f(Z).
__device__ __forceinline__ float lab_l(float fy) { return ((float)116.0 * fy - (float)16.0) * (float)(255.0 / 100.0); }
__device__ __forceinline__ float lab_a(float fx, float fy) { return (float)500.0 * (fx - fy) + (float)128.0; }
__device__ __forceinline__ float lab_b(float fy, float fz) { return (float)200.0 * (fy - fz) + (float)128.0; }

// Whether v lies within eps of a rounding tie (k + 0.5).
__device__ __forceinline__ bool near_tie(float v, float eps) { return fabsf(fabsf(v - rintf(v)) - 0.5f) < eps; }

// K1's Lab bytes with the roots rounded to nearest: the rare path of
// lab_bytes_k1, out of line so that the pixel loop keeps its registers
// (and the SASS count of the loop, which reads the common path, leaves it out).
__device__ __noinline__ int lab_bytes_exact(float X, float Y, float Z, float fx, float fy, float fz) {
  fx = lab_f_rn(fx, X);
  fy = lab_f_rn(fy, Y);
  fz = lab_f_rn(fz, Z);
  return to_u8(lab_l(fy)) | to_u8(lab_a(fx, fy)) << 8 | to_u8(lab_b(fy, fz)) << 16;
}

// Whether lab_bytes_k1 tests for a rounding tie. chip_smoke.py builds this
// source once more with LAB_COUNT_WITHOUT_TIE_TEST defined, only to read
// from its SASS the operations K1's function needs without the test, which
// bound K1, K8's forward half and K16's first kernel; no library is built so.
#ifdef LAB_COUNT_WITHOUT_TIE_TEST
constexpr bool kTieTest = false;
#else
constexpr bool kTieTest = true;
#endif

// K1's Lab bytes (L | a << 8 | b << 16) of one pixel's linear RGB. cbrtf is
// within 1 ulp of the root, the plain version's root within half an ulp,
// so the two differ by at most 1 ulp, which moves L by under 6e-5, a by
// under 1.6e-4 and b by under 7e-5 (the operations after the root each
// round once more); a pixel whose L, a or b lies within twice that of a
// rounding tie takes the rounded-to-nearest roots (lab_bytes_exact).
__device__ __forceinline__ int lab_bytes_k1(float r, float g, float bl) {
  const float X = (kRgb2Xyz[0][0] * r + kRgb2Xyz[0][1] * g + kRgb2Xyz[0][2] * bl) / kXn;
  const float Y = kRgb2Xyz[1][0] * r + kRgb2Xyz[1][1] * g + kRgb2Xyz[1][2] * bl;
  const float Z = (kRgb2Xyz[2][0] * r + kRgb2Xyz[2][1] * g + kRgb2Xyz[2][2] * bl) / kZn;
  const float fx = lab_f(X), fy = lab_f(Y), fz = lab_f(Z);
  const float L = lab_l(fy), a = lab_a(fx, fy), b = lab_b(fy, fz);
  if (kTieTest && (near_tie(L, 1.2e-4f) | near_tie(a, 3.2e-4f) | near_tie(b, 1.4e-4f)))
    return lab_bytes_exact(X, Y, Z, fx, fy, fz);
  return to_u8(L) | to_u8(a) << 8 | to_u8(b) << 16;
}

// K16's arithmetic (ops/clahe_pallas.py, the JAX function's compiled CPU
// program): divisions by a constant as products by its f32 reciprocal, the
// Lab scalings fused. The plain version takes the cube root as
// powf(t, 1/3); the kernel takes cbrtf, and powf where a byte lies near a
// rounding tie (lab_bytes_k16), which gives powf's bytes: cbrtf's root and
// powf's part by a few ulp, so only such a pixel can round otherwise. Over
// every sRGB triple the kernel equals its plain version on the card
// (tests/test_torch_cuda.py). PERF.md gives the times of cbrtf alone and
// of powf alone, each measured once.
constexpr float kRcXn = 1.0f / kXn, kRcZn = 1.0f / kZn;
constexpr float kRc500 = 1.0f / 500.0f, kRc200 = 1.0f / 200.0f, kRc7787 = 1.0f / (float)7.787;
constexpr float kRc255 = 1.0f / 255.0f;

template <bool kPow>
__device__ __forceinline__ float lab_f_k16(float t) {
  const float tt = fmaxf(t, (float)1e-12);
  const float root = kPow ? powf(tt, (float)(1.0 / 3.0)) : cbrtf(tt);
  return t > (float)0.008856 ? root : fmaf((float)7.787, t, k16_116);
}

__device__ __forceinline__ float lab_l_k16(float fy) { return fmaf(116.0f, fy, -16.0f) * (float)2.55; }
__device__ __forceinline__ float lab_a_k16(float fx, float fy) { return fmaf(500.0f, fx - fy, 128.0f); }
__device__ __forceinline__ float lab_b_k16(float fy, float fz) { return fmaf(200.0f, fy - fz, 128.0f); }

// K16's Lab bytes with powf's roots: the rare path of lab_bytes_k16.
__device__ __noinline__ int lab_bytes_k16_pow(float X, float Y, float Z) {
  const float fx = lab_f_k16<true>(X), fy = lab_f_k16<true>(Y), fz = lab_f_k16<true>(Z);
  return to_u8(lab_l_k16(fy)) | to_u8(lab_a_k16(fx, fy)) << 8 | to_u8(lab_b_k16(fy, fz)) << 16;
}

// K16's Lab bytes (L | a << 8 | b << 16) of one pixel's linear RGB. cbrtf
// (1 ulp) and powf (4 ulp, and 1/3 rounded to f32: about 1 ulp more) part
// by at most 6 ulp, which moves L by under 2.7e-4, a by under 7.8e-4 and b
// by under 3.3e-4; a pixel whose L, a or b lies within about 1.5 to 2
// times that of a rounding tie takes powf's roots.
__device__ __forceinline__ int lab_bytes_k16(float r, float g, float bl) {
  const float X = (kRgb2Xyz[0][0] * r + kRgb2Xyz[0][1] * g + kRgb2Xyz[0][2] * bl) * kRcXn;
  const float Y = kRgb2Xyz[1][0] * r + kRgb2Xyz[1][1] * g + kRgb2Xyz[1][2] * bl;
  const float Z = (kRgb2Xyz[2][0] * r + kRgb2Xyz[2][1] * g + kRgb2Xyz[2][2] * bl) * kRcZn;
  const float fx = lab_f_k16<false>(X), fy = lab_f_k16<false>(Y), fz = lab_f_k16<false>(Z);
  const float L = lab_l_k16(fy), a = lab_a_k16(fx, fy), b = lab_b_k16(fy, fz);
  if (near_tie(L, 5e-4f) | near_tie(a, 1.2e-3f) | near_tie(b, 6e-4f)) return lab_bytes_k16_pow(X, Y, Z);
  return to_u8(L) | to_u8(a) << 8 | to_u8(b) << 16;
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

// Wide access: N bytes (or N floats) at p, as 16-byte vectors where N bytes
// make whole vectors, else 8-, 4- or 1-byte accesses (stores: 8, 4 or 1).
// The caller aligns p.
template <int N>
__device__ __forceinline__ void load_u8(const uint8_t* p, uint32_t (&w)[(N + 3) / 4]) {
  if constexpr (N % 16 == 0) {
#pragma unroll
    for (int i = 0; i < N / 16; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  } else if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint2 v = reinterpret_cast<const uint2*>(p)[i];
      w[2 * i] = v.x;
      w[2 * i + 1] = v.y;
    }
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) w[i] = reinterpret_cast<const uint32_t*>(p)[i];
  } else {
#pragma unroll
    for (int i = 0; i < (N + 3) / 4; ++i) w[i] = 0;
#pragma unroll
    for (int e = 0; e < N; ++e) w[e >> 2] |= (uint32_t)p[e] << (8 * (e & 3));
  }
}

template <int N>
__device__ __forceinline__ void store_u8(uint8_t* p, const uint32_t (&w)[(N + 3) / 4]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) reinterpret_cast<uint2*>(p)[i] = make_uint2(w[2 * i], w[2 * i + 1]);
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) reinterpret_cast<uint32_t*>(p)[i] = w[i];
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) p[e] = (uint8_t)(w[e >> 2] >> (8 * (e & 3)));
  }
}

template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = p[e];
  }
}

template <int M>
__device__ __forceinline__ int byte_at(const uint32_t (&w)[M], int e) {
  return (int)((w[e >> 2] >> (8 * (e & 3))) & 0xffu);
}

template <int M>
__device__ __forceinline__ void put_byte(uint32_t (&w)[M], int e, int v) {
  w[e >> 2] |= (uint32_t)v << (8 * (e & 3));
}

// ---------------------------------------------------------------------------
// K1. Replaces retinex_tpu/ops/clahe_gather.py::_fwd_kernel5 (pallas_call in
// _fwd_stage5). Bound on the card: instruction issue for u8 input (a pixel
// moves 6 bytes but issues about 122 instructions, read from the SASS:
// three exact cbrtf, two IEEE divisions by Xn and Zn, which a reciprocal
// multiply would round differently, and the 3x3 matrix without FMA), bytes
// for the float input (15 bytes a pixel). So the design cuts every
// instruction that is not that arithmetic. A
// grid of (pixel groups, image) gives each thread kVec consecutive pixels
// of one image with no index division (the parent port divided a 64-bit
// flat index by the plane per pixel, a software routine of tens of
// instructions); a thread moves its 4 pixels in one 4-byte access per u8
// plane, one 16-byte access per float plane, or three of either for
// interleaved pixels (16 pixels a thread, tried, issued more and ran
// slower); the sRGB de-gamma is a 256-entry table in shared memory, one
// lookup per channel; the quantisation of the float input,
// rint(clamp(x, 0, 1) * 255), is done on the loaded registers. cbrtf is
// not correctly rounded, so a pixel whose L, a or b lies near a rounding
// tie takes its roots rounded to nearest (lab_bytes_k1): K1 then gives its
// plain version's bytes for every sRGB triple, which the Lab-CLAHE route's
// card-equals-CPU gate needs (a near-tie check a channel, about 18 more
// instructions a pixel in the SASS).
//
// K8 (forward half). kIn = kU8Nhwc replaces
// retinex_tpu/ops/clahe_gather.py::_fwd_kernel (pallas_call in _fwd_stage),
// which the JAX package reaches through clahe_rgb_u8_gather after an XLA
// transpose of the NHWC batch. Here the transpose is the kernel's own read
// of 3 * kVec interleaved bytes. Same arithmetic.
// ---------------------------------------------------------------------------
constexpr int kFwdThreads = kHist;

__device__ __forceinline__ int quantise_u8(float x) {
  return __float2int_rn(fminf(fmaxf(x, 0.0f), 1.0f) * 255.0f);
}

// The sRGB bytes q[channel][e] of pixels p .. p + kVec - 1 of image img.
template <int kVec, int kIn>
__device__ __forceinline__ void load_rgb(const void* src, size_t img, size_t plane, size_t p, int (&q)[3][kVec]) {
  if constexpr (kIn == kU8Planar) {
    const uint8_t* s = static_cast<const uint8_t*>(src) + img * 3 * plane + p;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      uint32_t w[(kVec + 3) / 4];
      load_u8<kVec>(s + c * plane, w);
#pragma unroll
      for (int e = 0; e < kVec; ++e) q[c][e] = byte_at(w, e);
    }
  } else if constexpr (kIn == kU8Nhwc) {
    uint32_t w[(3 * kVec + 3) / 4];
    load_u8<3 * kVec>(static_cast<const uint8_t*>(src) + (img * plane + p) * 3, w);
#pragma unroll
    for (int e = 0; e < kVec; ++e)
#pragma unroll
      for (int c = 0; c < 3; ++c) q[c][e] = byte_at(w, 3 * e + c);
  } else if constexpr (kIn == kF32Planar) {
    const float* s = static_cast<const float*>(src) + img * 3 * plane + p;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float v[kVec];
      load_f32<kVec>(s + c * plane, v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) q[c][e] = quantise_u8(v[e]);
    }
  } else {
    float v[3 * kVec];
    load_f32<3 * kVec>(static_cast<const float*>(src) + (img * plane + p) * 3, v);
#pragma unroll
    for (int e = 0; e < kVec; ++e)
#pragma unroll
      for (int c = 0; c < 3; ++c) q[c][e] = quantise_u8(v[3 * e + c]);
  }
}

template <int kVec, int kIn>
__global__ void __launch_bounds__(kFwdThreads)
    lab_fwd_kernel(const void* __restrict__ src, uint8_t* __restrict__ lab, const float* __restrict__ degamma,
                   int plane) {
  __shared__ float tab[kHist];
  tab[threadIdx.x] = degamma[threadIdx.x];
  __syncthreads();
  const int grp = blockIdx.x * kFwdThreads + threadIdx.x;
  if (grp >= plane / kVec) return;
  const size_t img = blockIdx.y, p = (size_t)grp * kVec;
  int q[3][kVec];
  load_rgb<kVec, kIn>(src, img, plane, p, q);
  uint32_t out[3][(kVec + 3) / 4] = {};
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const int v = lab_bytes_k1(tab[q[0][e]], tab[q[1][e]], tab[q[2][e]]);
#pragma unroll
    for (int c = 0; c < 3; ++c) put_byte(out[c], e, (v >> (8 * c)) & 0xff);
  }
  uint8_t* dst = lab + img * 3 * plane + p;
#pragma unroll
  for (int c = 0; c < 3; ++c) store_u8<kVec>(dst + c * plane, out[c]);
}

// ---------------------------------------------------------------------------
// K16, first kernel. Replaces retinex_tpu/ops/clahe_pallas.py::_hist_kernel
// (pallas_call in clahe_lab_rgb_pallas): f32 NHWC RGB [B, H, W, 3] (H, W
// multiples of 2 * tiles) -> planar u8 Lab [B, 3, H, W] and the 256-bin
// histogram of every tile's L, int32 [B, tiles_y, tiles_x, 256] (zeroed by
// the caller). Bound on the card: bytes (12 B in and 3 B out a pixel). K1's
// body with K16's arithmetic (lab_bytes_k16) and K2's histogram: a block of
// 256 threads walks a row strip of one tile (clahe_gather.tables_plan, about
// four blocks per SM), kVec pixels a thread (three 16-byte loads, 4-byte
// stores per Lab plane); the de-gamma is a 256-entry table of K16's own
// srgb_to_linear on the quantised byte (clahe_pallas.degamma_table_k16,
// made by the plain version's operations on the card); L goes into per-warp sub-histograms in shared memory,
// which the block adds into the image's tile histogram with one global
// atomic per nonzero bin (integer sums: no order changes them).
// ---------------------------------------------------------------------------
template <int kVec>
__global__ void __launch_bounds__(kHist)
    lab_hist_kernel(const float* __restrict__ x, uint8_t* __restrict__ lab, const float* __restrict__ degamma,
                    int* __restrict__ hist, int H, int W, int tiles_y, int tiles_x, int strips, int rows_per_strip) {
  constexpr int kWarps = kHist / 32;
  __shared__ float tab[kHist];
  __shared__ int whist[kWarps][kHist];
  const int t = threadIdx.x, warp = t >> 5;
  tab[t] = degamma[t];
  for (int w = 0; w < kWarps; ++w) whist[w][t] = 0;
  __syncthreads();

  const int tile = blockIdx.x / strips, strip = blockIdx.x - tile * strips, b = blockIdx.y;
  const int ty = tile / tiles_x, tx = tile - ty * tiles_x;
  const int th = H / tiles_y, tw = W / tiles_x;
  const int j0 = strip * rows_per_strip, n_rows = min(rows_per_strip, th - j0);
  const int n_ch = tw / kVec;
  const bool narrow = n_ch <= kHist;
  const int rows_per_pass = narrow ? kHist / n_ch : 1;
  const int r_first = narrow ? t / n_ch : 0;
  const int ch_first = narrow ? t - r_first * n_ch : t;
  const size_t plane = (size_t)H * W;
  if (r_first < rows_per_pass) {
    for (int r = r_first; r < n_rows; r += rows_per_pass) {
      const size_t row = (size_t)(ty * th + j0 + r) * W + (size_t)tx * tw;
      for (int ch = ch_first; ch < n_ch; ch += kHist) {
        const size_t p = row + (size_t)ch * kVec;
        int q[3][kVec];
        load_rgb<kVec, kF32Nhwc>(x, b, plane, p, q);
        uint32_t out[3][(kVec + 3) / 4] = {};
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int v = lab_bytes_k16(tab[q[0][e]], tab[q[1][e]], tab[q[2][e]]);
#pragma unroll
          for (int c = 0; c < 3; ++c) put_byte(out[c], e, (v >> (8 * c)) & 0xff);
          atomicAdd(&whist[warp][v & 0xff], 1);
        }
        uint8_t* dst = lab + (size_t)b * 3 * plane + p;
#pragma unroll
        for (int c = 0; c < 3; ++c) store_u8<kVec>(dst + c * plane, out[c]);
      }
    }
  }
  __syncthreads();
  int h = 0;
  for (int w = 0; w < kWarps; ++w) h += whist[w][t];
  if (h) atomicAdd(hist + ((size_t)b * tiles_y * tiles_x + tile) * kHist + t, h);
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
//
// kPad (the tile-row mode, frames that are not cell-divisible; s = 1): a
// tile is tile_h x tile_w pixels of the frame padded by reflect-101 to
// tiles_y * tile_h rows and tiles_x * tile_w columns (clahe.clahe_u8). A
// row r past H reads row 2(H - 1) - r; a chunk that starts past W (only in
// the last tile column, and whole, as W is a multiple of kVec) reads its
// reflected columns byte by byte. The wrapper passes the padded tile's clip
// and LUT scale. Without kPad, tile_h and tile_w are 2 * hh and 2 * hw.
// ---------------------------------------------------------------------------
template <int kVec, bool kPad>
__global__ void __launch_bounds__(kHist)
    clahe_tables_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ luts, int* __restrict__ hist,
                        int* __restrict__ arrived, long long img_stride, int H, int W, int tiles_y,
                        int tiles_x, int tile_h, int tile_w, int s, int clip, float lut_scale, int strips,
                        int rows_per_strip) {
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
  const int hh = tile_h >> 1, hw = tile_w >> 1;
  if (!kPad && s > 1) {
    for (int c = t; c < tile_w; c += kHist) colmask[c] = (c < hw ? c : c - hw) % s == 0;
  }
  __syncthreads();

  const uint8_t* img = src + (size_t)b * img_stride;
  const int col0 = tx * tile_w;
  const int per_cell = (hh + s - 1) / s;  // sampled rows per half-tile cell
  const int j0 = strip * rows_per_strip;
  const int n_rows = min(rows_per_strip, (kPad ? tile_h : 2 * per_cell) - j0);
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
      int y = ty * tile_h + (kPad || j < per_cell ? j * s : hh + (j - per_cell) * s);
      if (kPad && y >= H) y = 2 * (H - 1) - y;
      const uint8_t* row = img + (size_t)y * W;
      for (int ch = ch_first; ch < n_ch; ch += kHist) {
        const int c0 = col0 + ch * kVec;
        if (kPad && c0 >= W) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) atomicAdd(&whist[warp][row[2 * (W - 1) - (c0 + e)]], 1);
          continue;
        }
        uint32_t v[kWords], m[kWords] = {};
        load_u8<kVec>(row + c0, v);
        if (!kPad && s > 1) {
          load_u8<kVec>(colmask + ch * kVec, m);
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int sh = 8 * (e & 3);
          if (kPad || s == 1 || ((m[e >> 2] >> sh) & 0xffu)) atomicAdd(&whist[warp][(v[e >> 2] >> sh) & 0xffu], 1);
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

template <int kVec, bool kPad>
int launch_tables(const void* src, void* luts, void* scratch, long long img_stride, int batch, int H, int W,
                  int tiles_y, int tiles_x, int tile_h, int tile_w, int s, int clip, float lut_scale, int strips,
                  int rows_per_strip, void* stream) {
  const size_t smem = !kPad && s > 1 ? (size_t)(tile_w + 15) / 16 * 16 : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(clahe_tables_kernel<kVec, kPad>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long n_tiles = (long long)batch * tiles_y * tiles_x;
  int* hist = (int*)scratch;
  const dim3 grid(tiles_y * tiles_x * strips, batch);
  clahe_tables_kernel<kVec, kPad><<<grid, kHist, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (uint8_t*)luts, hist, hist + n_tiles * kHist, img_stride, H, W, tiles_y, tiles_x,
      tile_h, tile_w, s, clip, lut_scale, strips, rows_per_strip);
  return (int)cudaGetLastError();
}

template <bool kPad>
int launch_tables_vec(const void* src, void* luts, void* scratch, long long img_stride, int batch, int H, int W,
                      int tiles_y, int tiles_x, int tile_h, int tile_w, int s, int clip, float lut_scale,
                      int strips, int rows_per_strip, int vec, void* stream) {
  switch (vec) {
    case 16:
      return launch_tables<16, kPad>(src, luts, scratch, img_stride, batch, H, W, tiles_y, tiles_x, tile_h, tile_w,
                                     s, clip, lut_scale, strips, rows_per_strip, stream);
    case 4:
      return launch_tables<4, kPad>(src, luts, scratch, img_stride, batch, H, W, tiles_y, tiles_x, tile_h, tile_w,
                                    s, clip, lut_scale, strips, rows_per_strip, stream);
    default:
      return launch_tables<1, kPad>(src, luts, scratch, img_stride, batch, H, W, tiles_y, tiles_x, tile_h, tile_w,
                                    s, clip, lut_scale, strips, rows_per_strip, stream);
  }
}

// ---------------------------------------------------------------------------
// K3. Replaces retinex_tpu/ops/clahe_gather.py::_apply_kernel5 (pallas_call
// in _apply_stage5). Bound on the card: instruction issue for the u8
// output (about 83 issued instructions a pixel in the SASS against 6
// bytes), bytes for the float output (15 bytes a pixel). The parent port spent
// several hundred instructions a pixel on three accurate powf, up to six
// IEEE divisions and byte-wide memory traffic. The design computes the
// same bytes with tables built once on the host by the plain version's own
// f32 operations:
//   - fy and Y = f^-1(fy) depend on the blended L alone, (a - 128) / 500
//     and (b - 128) / 200 on one byte each: 256-entry tables, so a pixel
//     keeps two adds, two f^-1 (lab_f_inv_k3, without a branch), the
//     matrix and the quantiser;
//   - the quantiser rint(clamp(linear_to_srgb(lin), 0, 1) * 255) is a
//     non-decreasing step function of lin, fixed by the least f32 of each
//     byte (found on the host by bisection over the plain version's bytes).
//     A bucket of the f32 bit patterns (sign, exponent and 7 mantissa bits,
//     from 2^-13 up to the bucket of 1.0) holds at most one step, so its
//     32-bit entry (byte at the bucket's start << 17 | low 16 bits of the
//     step, or 0x10000 for none) gives the byte in one lookup and one
//     integer compare, for the linear branch and the power law alike;
//   - the float output v / 255 is v * (1/255) corrected by two FMAs, which
//     gives the IEEE quotient for every byte (tests check all 256).
// A pixel makes six table lookups at data-dependent addresses: the four
// neighbour LUT entries of each value are packed into one 32-bit word per
// pair of x-tiles when a block stages its band's two tile rows, so the
// blend takes one lookup, not four. A thread takes kVec consecutive pixels of a
// row (8 or 4, as the cell width and alignment allow, so the group stays
// in one cell): one wide load per Lab plane, one wide store per output
// plane (or 3 * kVec interleaved values), its columns' neighbour word row
// and x-weights kept across rows; the interleaved layouts' stores go
// through shared memory so that a warp writes its span side by side
// (store_span). A block of blockDim.y rows of threads walks a band of
// `band_rows` rows inside one half-tile cell row, blockDim.y rows at once:
// few large blocks, since each block pays for its staging
// (clahe_gather.apply_plan sizes the grid to about one block per SM).
//
// K8 (apply half). kOut = kU8Nhwc replaces
// retinex_tpu/ops/clahe_gather.py::_apply_kernel (pallas_call in
// _apply_stage), whose planar output the JAX package transposes back to
// NHWC in XLA: here each thread writes its 3 * kVec interleaved bytes.
//
// kMode = kTiles (G1: frames that are not cell-divisible, float NHWC out)
// runs clahe.clahe_u8's blend: each row's tile pair (y0i, y1i) and weight
// ya, each column's x-tile pair and weight xa, all from the plain version's
// own coordinate arithmetic on the host (clahe_gather.tile_geometry), and
// the three fmas top = l00 (1 - xa) + l01 xa, bot = l10 (1 - xa) + l11 xa,
// top (1 - ya) + bot ya. A block walks a band of rows that share one tile
// pair (the geometry's band table), so it stages one pair of LUT rows as
// the cells do; each pixel of a thread's group keeps its own x pair and
// weight in registers (a group may straddle a tile boundary). The Lab ->
// sRGB half is the cells' (the same tables and quantiser).
//
// kMode = kK16 replaces retinex_tpu/ops/clahe_pallas.py::_apply_kernel
// (pallas_call in clahe_lab_rgb_pallas), float NHWC out, with K16's own
// arithmetic: cell weights u * (1 / (2 cell)), bot = l11 xa + l10 (1 - xa),
// fx = (a - 128) * (1 / 500) + fy and fz fused in the kernel (a fused
// product cannot live in a table), fy and Y by L from K16's table
// (clahe_pallas.apply_table_block_k16), f^-1's lower side a product by
// 1 / 7.787, the sRGB byte from the same quantiser (K16's linear_to_srgb
// after its clamp at 0 is the same function of lin), and the float output
// byte * (1 / 255), K16's product.
// ---------------------------------------------------------------------------
constexpr int kApplyThreads = 256;  // threads of a block along a row; blockDim.y rows at once
constexpr int kApplyRowsMax = 4;

enum ApplyMode : int { kCells = 0, kTiles = 1, kK16 = 2 };

// The table block (clahe_gather.apply_tables, as 32-bit words).
constexpr int kTabFy = 0;        // float2 [256] by L: fy, and Y = lab_f_inv(fy)
constexpr int kTabDa = 512;      // float [256] by a: (a - 128) / 500
constexpr int kTabDb = 768;      // float [256] by b: (b - 128) / 200
constexpr int kTabQuant = 1024;  // u32 [kQuantLast + 1]: the quantiser's buckets
constexpr int kQuantBase = (127 - 13) << 7;          // the bucket of 2^-13: bits >> 16
constexpr int kQuantLast = (127 << 7) - kQuantBase;  // the bucket of 1.0; everything above is 255
constexpr int kTabWords = (kTabQuant + kQuantLast + 1 + 3) / 4 * 4;

__device__ __forceinline__ int srgb_byte(float lin, const uint32_t* quant) {
  const int bits = __float_as_int(lin);
  const uint32_t e = quant[min(max((bits >> 16) - kQuantBase, 0), kQuantLast)];
  return (int)(e >> 17) + ((uint32_t)(bits & 0xffff) >= (e & 0x1ffffu));
}

// lab_f_inv without a branch, so the compiler can interleave a thread's
// pixels: the division (ft - 16/116) / 7.787 is the product by the rounded
// reciprocal corrected by two FMAs, which gives the IEEE quotient for
// every ft that K3 can form below the threshold (fy + (a - 128) / 500 and
// fy - (b - 128) / 200 over all bytes; tests check all 21205 of them).
__device__ __forceinline__ float lab_f_inv_k3(float ft) {
  constexpr float c = (float)7.787;
  constexpr float r = 1.0f / c;
  const float x = ft - k16_116;
  const float q = __fmul_rn(x, r);
  const float below = fmaf(fmaf(-q, c, x), r, q);
  const float above = ft * ft * ft;
  return ft > k6_29 ? above : below;
}

// K16's f^-1: the lower side a product by the f32 reciprocal of 7.787.
__device__ __forceinline__ float lab_f_inv_k16(float ft) {
  return ft > (float)(6.0 / 29.0) ? ft * ft * ft : __fmul_rn(ft - k16_116, kRc7787);
}

// K16's cell weight: u * (1 / (2 cell)), + 0.5 in even cells.
__device__ __forceinline__ float blend_weight_k16(int c, int u, int cell) {
  const float w = __fmul_rn((float)u, 1.0f / (float)(2 * cell));
  return (c & 1) ? w : w + 0.5f;
}

// v / 255 rounded as IEEE division rounds it, for v = 0 .. 255.
__device__ __forceinline__ float div255(int v) {
  constexpr float r = 1.0f / 255.0f;
  const float x = (float)v;
  const float q = __fmul_rn(x, r);
  return fmaf(fmaf(-q, 255.0f, x), r, q);
}

// 32-bit words a lane stages for the warp's interleaved store (0: the
// layout is stored directly): 3 * kVec floats, or 3 * kVec bytes as words.
template <int kVec, int kOut>
__host__ __device__ constexpr int stage_words() {
  return kOut == kF32Nhwc ? 3 * kVec : kOut == kU8Nhwc && kVec % 4 == 0 ? 3 * kVec / 4 : 0;
}

// The interleaved layouts: each lane holds the N words of its kVec pixels,
// and the warp's lanes hold consecutive runs, so the warp's output is one
// span. The words go through shared memory so that the warp writes the
// span in 16-byte vectors (floats) or 32-bit words (bytes) side by side,
// not each lane its own run at a stride of N words.
template <int N, bool kWide>
__device__ __forceinline__ void store_span(uint32_t* span, const uint32_t (&w)[N], uint32_t* stage, int lane,
                                           int lanes) {
#pragma unroll
  for (int i = 0; i < N; ++i) stage[lane * N + i] = w[i];
  __syncwarp();
  const int total = lanes * N;
  if constexpr (kWide) {
    for (int j = 4 * lane; j < total; j += 128)
      *reinterpret_cast<uint4*>(span + j) = *reinterpret_cast<const uint4*>(stage + j);
  } else {
    for (int j = lane; j < total; j += 32) span[j] = stage[j];
  }
  __syncwarp();
}

// The float output is byte / 255 as IEEE division rounds it (div255), or
// with kByRc byte * (1 / 255), K16's product.
template <int kVec, int kOut, bool kByRc = false>
__device__ __forceinline__ void store_rgb(void* out, size_t img, size_t plane, size_t p, size_t p_warp,
                                          const int (&q)[3][kVec], bool active, uint32_t* stage, int lane, int lanes) {
  if constexpr (kOut == kU8Planar) {
    uint8_t* d = static_cast<uint8_t*>(out) + img * 3 * plane + p;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      uint32_t w[(kVec + 3) / 4] = {};
#pragma unroll
      for (int e = 0; e < kVec; ++e) put_byte(w, e, q[c][e]);
      if (active) store_u8<kVec>(d + c * plane, w);
    }
  } else if constexpr (kOut == kU8Nhwc) {
    uint32_t w[(3 * kVec + 3) / 4] = {};
#pragma unroll
    for (int e = 0; e < kVec; ++e)
#pragma unroll
      for (int c = 0; c < 3; ++c) put_byte(w, 3 * e + c, q[c][e]);
    if constexpr (stage_words<kVec, kOut>() > 0) {
      uint8_t* span = static_cast<uint8_t*>(out) + (img * plane + p_warp) * 3;
      store_span<3 * kVec / 4, false>(reinterpret_cast<uint32_t*>(span), w, stage, lane, lanes);
    } else if (active) {
      store_u8<3 * kVec>(static_cast<uint8_t*>(out) + (img * plane + p) * 3, w);
    }
  } else {
    uint32_t v[3 * kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        v[3 * e + c] = __float_as_uint(kByRc ? __fmul_rn((float)q[c][e], kRc255) : div255(q[c][e]));
    float* span = static_cast<float*>(out) + (img * plane + p_warp) * 3;
    store_span<3 * kVec, kVec % 4 == 0>(reinterpret_cast<uint32_t*>(span), v, stage, lane, lanes);
  }
}

template <int kVec, int kOut, int kMode>
__global__ void __launch_bounds__(kApplyThreads * kApplyRowsMax)
    clahe_apply_kernel(const uint8_t* __restrict__ lab, const uint8_t* __restrict__ luts,
                       const uint4* __restrict__ tables, const int* __restrict__ geom, void* __restrict__ out, int H,
                       int W, int tiles_y, int tiles_x, int bands, int band_rows, int row0, int cell_rows) {
  // The tables, then the neighbour words [tiles_x + 1][256]: for the x-tile
  // pair p (tiles p - 1 and p, clipped) and value v, the LUT entries of the
  // tiles (t0y, p - 1), (t0y, p), (t1y, p - 1), (t1y, p) as bytes 0..3;
  // then each warp's store staging (stage_words a lane).
  extern __shared__ uint4 smem[];
  // Rows [iy0, iy1): of cell row cy (kCells, kK16), or of the frame (kTiles:
  // the geometry's band table [bands][4]: first row, end, t0y, t1y). The
  // cell modes take a slab of `cell_rows` whole cell rows whose first is
  // the frame's cell row `row0` (2 * tiles_y and 0 for a whole frame): cy
  // counts the slab's cell rows, cy + row0 the frame's, which pick the
  // neighbour tile rows and the blend weight's parity.
  int iy0, iy1, t0y, t1y, cy = 0, hh = 0, hw = 0;
  if constexpr (kMode == kTiles) {
    const int4 band = reinterpret_cast<const int4*>(geom)[blockIdx.y];
    iy0 = band.x;
    iy1 = band.y;
    t0y = band.z;
    t1y = band.w;
  } else {
    hh = H / cell_rows;
    hw = W / (2 * tiles_x);
    cy = blockIdx.y / bands;
    iy0 = (blockIdx.y - cy * bands) * band_rows;
    iy1 = min(iy0 + band_rows, hh);
    neighbor_tiles(cy + row0, tiles_y, &t0y, &t1y);
  }
  const int b = blockIdx.z;

  const int tid = threadIdx.y * kApplyThreads + threadIdx.x, n_threads = kApplyThreads * blockDim.y;
#pragma unroll 4
  for (int i = tid; i < kTabWords / 4; i += n_threads) smem[i] = tables[i];
  uint32_t* nbr = reinterpret_cast<uint32_t*>(smem + kTabWords / 4);
  const int lut_row = tiles_x * kHist;
  const uint8_t* lut0 = luts + ((size_t)b * tiles_y + t0y) * lut_row;
  const uint8_t* lut1 = luts + ((size_t)b * tiles_y + t1y) * lut_row;
#pragma unroll 4
  for (int i = tid; i < (tiles_x + 1) * kHist; i += n_threads) {
    const int pair = i >> 8, v = i & (kHist - 1);
    const int t0 = max(pair - 1, 0) * kHist + v, t1 = min(pair, tiles_x - 1) * kHist + v;
    nbr[i] = (uint32_t)lut0[t0] | (uint32_t)lut0[t1] << 8 | (uint32_t)lut1[t0] << 16 | (uint32_t)lut1[t1] << 24;
  }
  __syncthreads();
  const uint32_t* tab = reinterpret_cast<const uint32_t*>(smem);
  const float2* fyy = reinterpret_cast<const float2*>(tab + kTabFy);
  const float* da = reinterpret_cast<const float*>(tab + kTabDa);
  const float* db = reinterpret_cast<const float*>(tab + kTabDb);
  const uint32_t* quant = tab + kTabQuant;

  // A lane past the row's last group repeats that group's columns (in
  // bounds) and stores nothing; a warp with no group leaves.
  const int groups = W / kVec, lane = threadIdx.x & 31;
  const int g = blockIdx.x * kApplyThreads + threadIdx.x;
  const int lanes = min(32, groups - (g - lane));
  if (lanes <= 0) return;
  const bool active = lane < lanes;
  const int x0 = min(g, groups - 1) * kVec;
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem + kTabWords / 4) + (tiles_x + 1) * kHist +
                    (tid & ~31) * stage_words<kVec, kOut>();
  // The group's neighbour words (kCells, kK16: the group lies in one cell),
  // or each pixel's (kTiles: xo, the offset of its x pair's words).
  const uint32_t* words = nbr;
  float xa[kVec], xb[kVec];
  int xo[kVec];
  if constexpr (kMode == kTiles) {
    const float* xa_g = reinterpret_cast<const float*>(geom + 4 * bands + H);
    const int* xp_g = geom + 4 * bands + H + W;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      xa[e] = xa_g[x0 + e];
      xb[e] = 1.0f - xa[e];
      xo[e] = xp_g[x0 + e] * kHist;
    }
  } else {
    const int cx = x0 / hw;  // hw % kVec == 0: the group lies in one cell
    words = nbr + ((cx + 1) >> 1) * kHist;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      xa[e] = kMode == kK16 ? blend_weight_k16(cx, x0 - cx * hw + e, hw) : blend_weight(cx, x0 - cx * hw + e, hw);
      xb[e] = 1.0f - xa[e];
    }
  }

  const size_t plane = (size_t)H * W;
  const uint8_t* src = lab + (size_t)b * 3 * plane;
#pragma unroll 1
  for (int iy = iy0 + threadIdx.y; iy < iy1; iy += blockDim.y) {
    float ya;
    size_t row;
    if constexpr (kMode == kTiles) {
      ya = __int_as_float(geom[4 * bands + iy]);
      row = (size_t)iy * W;
    } else {
      ya = kMode == kK16 ? blend_weight_k16(cy + row0, iy, hh) : blend_weight(cy + row0, iy, hh);
      row = (size_t)(cy * hh + iy) * W;
    }
    const float yb = 1.0f - ya;
    const size_t p = row + x0;
    uint32_t lw[(kVec + 3) / 4], aw[(kVec + 3) / 4], bw[(kVec + 3) / 4];
    load_u8<kVec>(src + p, lw);
    load_u8<kVec>(src + plane + p, aw);
    load_u8<kVec>(src + 2 * plane + p, bw);
    int q[3][kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      uint32_t n;
      if constexpr (kMode == kTiles) {
        n = nbr[xo[e] + byte_at(lw, e)];
      } else {
        n = words[byte_at(lw, e)];
      }
      const float l00 = (float)(n & 0xffu), l01 = (float)((n >> 8) & 0xffu);
      const float l10 = (float)((n >> 16) & 0xffu), l11 = (float)(n >> 24);
      // The three fused multiply-adds of each plain version's blend, each
      // absorbing the product it absorbs there: ops/clahe_fast.py::blend
      // (kCells), ops/clahe.py::clahe_u8 (kTiles), ops/clahe_pallas.py::_blend.
      float top, bot;
      if constexpr (kMode == kCells) {
        top = fmaf(l01, xa[e], __fmul_rn(l00, xb[e]));
        bot = fmaf(l10, xb[e], __fmul_rn(l11, xa[e]));
      } else if constexpr (kMode == kTiles) {
        top = fmaf(l00, xb[e], __fmul_rn(l01, xa[e]));
        bot = fmaf(l10, xb[e], __fmul_rn(l11, xa[e]));
      } else {
        top = fmaf(l01, xa[e], __fmul_rn(l00, xb[e]));
        bot = fmaf(l11, xa[e], __fmul_rn(l10, xb[e]));
      }
      const float2 f = fyy[to_u8(fmaf(top, yb, __fmul_rn(bot, ya)))];
      float X, Z;
      if constexpr (kMode == kK16) {
        X = lab_f_inv_k16(fmaf((float)byte_at(aw, e) - 128.0f, kRc500, f.x)) * kXn;
        Z = lab_f_inv_k16(fmaf(128.0f - (float)byte_at(bw, e), kRc200, f.x)) * kZn;
      } else {
        X = lab_f_inv_k3(f.x + da[byte_at(aw, e)]) * kXn;
        Z = lab_f_inv_k3(f.x - db[byte_at(bw, e)]) * kZn;
      }
#pragma unroll
      for (int c = 0; c < 3; ++c)
        q[c][e] = srgb_byte(kXyz2Rgb[c][0] * X + kXyz2Rgb[c][1] * f.y + kXyz2Rgb[c][2] * Z, quant);
    }
    store_rgb<kVec, kOut, kMode == kK16>(out, b, plane, p, row + (g - lane) * kVec, q, active, stage, lane, lanes);
  }
}

template <int kVec>
int launch_lab_fwd_vec(const void* src, void* lab, const void* degamma, int batch, int plane, int layout,
                       cudaStream_t stream) {
  const dim3 grid((plane / kVec + kFwdThreads - 1) / kFwdThreads, batch);
  const auto* tab = static_cast<const float*>(degamma);
  auto* dst = static_cast<uint8_t*>(lab);
  switch (layout) {
    case kU8Planar:
      lab_fwd_kernel<kVec, kU8Planar><<<grid, kFwdThreads, 0, stream>>>(src, dst, tab, plane);
      break;
    case kU8Nhwc:
      lab_fwd_kernel<kVec, kU8Nhwc><<<grid, kFwdThreads, 0, stream>>>(src, dst, tab, plane);
      break;
    case kF32Planar:
      lab_fwd_kernel<kVec, kF32Planar><<<grid, kFwdThreads, 0, stream>>>(src, dst, tab, plane);
      break;
    case kF32Nhwc:
      lab_fwd_kernel<kVec, kF32Nhwc><<<grid, kFwdThreads, 0, stream>>>(src, dst, tab, plane);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// One launch of K3 in `kMode`: grid (column blocks, row bands, batch). bands:
// row bands per cell row (kCells, kK16: band_rows rows each, over the
// slab's cell_rows cell rows, the first the frame's row0) or in all (kTiles:
// the geometry's band table).
template <int kVec, int kOut, int kMode>
int launch_apply_as(const void* lab, const void* luts, const void* tables, const void* geom, void* out, int batch,
                    int H, int W, int tiles_y, int tiles_x, int bands, int band_rows, int rows_par,
                    cudaStream_t stream, int row0 = 0, int cell_rows = 0) {
  if (rows_par < 1 || rows_par > kApplyRowsMax) return (int)cudaErrorInvalidValue;
  if (kMode != kTiles && (cell_rows < 1 || row0 < 0 || row0 + cell_rows > 2 * tiles_y || H % cell_rows))
    return (int)cudaErrorInvalidValue;
  const int grid_y = kMode == kTiles ? bands : cell_rows * bands;
  const dim3 grid((W / kVec + kApplyThreads - 1) / kApplyThreads, grid_y, batch);
  const size_t words = (size_t)kTabWords + (size_t)(tiles_x + 1) * kHist +
                       (size_t)kApplyThreads * rows_par * stage_words<kVec, kOut>();
  const size_t smem = 4 * words;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(clahe_apply_kernel<kVec, kOut, kMode>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  clahe_apply_kernel<kVec, kOut, kMode><<<grid, dim3(kApplyThreads, rows_par), smem, stream>>>(
      static_cast<const uint8_t*>(lab), static_cast<const uint8_t*>(luts), static_cast<const uint4*>(tables),
      static_cast<const int*>(geom), out, H, W, tiles_y, tiles_x, bands, band_rows, row0, cell_rows);
  return (int)cudaGetLastError();
}

template <int kVec>
int launch_apply_vec(const void* lab, const void* luts, const void* tables, void* out, int batch, int H, int W,
                     int tiles_y, int tiles_x, int layout, int band_rows, int rows_par, int row0, int cell_rows,
                     cudaStream_t stream) {
  if (cell_rows < 1 || H % cell_rows) return (int)cudaErrorInvalidValue;
  const int bands = (H / cell_rows + band_rows - 1) / band_rows;
  switch (layout) {
    case kU8Planar:
      return launch_apply_as<kVec, kU8Planar, kCells>(lab, luts, tables, nullptr, out, batch, H, W, tiles_y, tiles_x,
                                                      bands, band_rows, rows_par, stream, row0, cell_rows);
    case kU8Nhwc:
      return launch_apply_as<kVec, kU8Nhwc, kCells>(lab, luts, tables, nullptr, out, batch, H, W, tiles_y, tiles_x,
                                                    bands, band_rows, rows_par, stream, row0, cell_rows);
    case kF32Nhwc:
      return launch_apply_as<kVec, kF32Nhwc, kCells>(lab, luts, tables, nullptr, out, batch, H, W, tiles_y, tiles_x,
                                                     bands, band_rows, rows_par, stream, row0, cell_rows);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int kVec>
int launch_hist_as(const void* x, void* lab, void* hist, const void* degamma, int batch, int H, int W, int tiles_y,
                   int tiles_x, int strips, int rows_per_strip, cudaStream_t stream) {
  const dim3 grid(tiles_y * tiles_x * strips, batch);
  lab_hist_kernel<kVec><<<grid, kHist, 0, stream>>>(static_cast<const float*>(x), static_cast<uint8_t*>(lab),
                                                    static_cast<const float*>(degamma), static_cast<int*>(hist), H, W,
                                                    tiles_y, tiles_x, strips, rows_per_strip);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// layout: a Layout; vec: 4 or 1 pixels a thread (plane a multiple of it,
// src aligned to the access: clahe_gather._fwd_width).
int clahe_lab_fwd(const void* src, void* lab, const void* degamma, int batch, int plane, int layout, int vec,
                  void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 4:
      return launch_lab_fwd_vec<4>(src, lab, degamma, batch, plane, layout, s);
    case 1:
      return launch_lab_fwd_vec<1>(src, lab, degamma, batch, plane, layout, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// scratch: int32 [batch * tiles * 257], zero: the tiles' histograms, then
// their arrival counters. tile_h x tile_w: a tile's rows and columns (2 hh x
// 2 hw on cell-divisible frames; pad: the reflect-101 padded tiles of any
// frame, s = 1). vec: 16, 4 or 1 bytes a load (the plane, img_stride, W and
// tile_w all multiples of it).
int clahe_tables(const void* src, void* luts, void* scratch, long long img_stride, int batch, int H, int W,
                 int tiles_y, int tiles_x, int tile_h, int tile_w, int pad, int s, int clip, float lut_scale,
                 int strips, int rows_per_strip, int vec, void* stream) {
  if (pad) {
    if (s != 1) return (int)cudaErrorInvalidValue;
    return launch_tables_vec<true>(src, luts, scratch, img_stride, batch, H, W, tiles_y, tiles_x, tile_h, tile_w, s,
                                   clip, lut_scale, strips, rows_per_strip, vec, stream);
  }
  return launch_tables_vec<false>(src, luts, scratch, img_stride, batch, H, W, tiles_y, tiles_x, tile_h, tile_w, s,
                                  clip, lut_scale, strips, rows_per_strip, vec, stream);
}

// tables: clahe_gather's table block (kTabWords words); layout: kU8Planar,
// kU8Nhwc or kF32Nhwc; vec: 8, 4 or 1 (the cell width a multiple of it, lab
// aligned to it: clahe_gather._apply_width);
// band_rows: rows a block walks, rows_par (1 to 4) of them at once, one
// row of threads each (clahe_gather.apply_plan); the H rows are a slab of
// cell_rows whole cell rows of a frame, the first its cell row row0 (a
// whole frame: row0 0, cell_rows 2 * tiles_y), and luts the frame's.
int clahe_apply(const void* lab, const void* luts, const void* tables, void* out, int batch, int H, int W,
                int tiles_y, int tiles_x, int layout, int vec, int band_rows, int rows_par, int row0, int cell_rows,
                void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 8:
      return launch_apply_vec<8>(lab, luts, tables, out, batch, H, W, tiles_y, tiles_x, layout, band_rows, rows_par,
                                 row0, cell_rows, s);
    case 4:
      return launch_apply_vec<4>(lab, luts, tables, out, batch, H, W, tiles_y, tiles_x, layout, band_rows, rows_par,
                                 row0, cell_rows, s);
    case 1:
      return launch_apply_vec<1>(lab, luts, tables, out, batch, H, W, tiles_y, tiles_x, layout, band_rows, rows_par,
                                 row0, cell_rows, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K3 in its tile-coordinate mode, float NHWC out: geom is
// clahe_gather.tile_geometry's int32 block (the band table [bands][4], then
// ya [H], xa [W] as float bits, the x pair [W]); vec: 4 or 1 (W a multiple
// of it, lab aligned to it); rows_par (1 to 4) rows of a band at once.
int clahe_apply_tiles(const void* lab, const void* luts, const void* tables, const void* geom, void* out, int batch,
                      int H, int W, int tiles_y, int tiles_x, int bands, int vec, int rows_par, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 4:
      return launch_apply_as<4, kF32Nhwc, kTiles>(lab, luts, tables, geom, out, batch, H, W, tiles_y, tiles_x, bands,
                                                  0, rows_par, s);
    case 1:
      return launch_apply_as<1, kF32Nhwc, kTiles>(lab, luts, tables, geom, out, batch, H, W, tiles_y, tiles_x, bands,
                                                  0, rows_par, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K16, first kernel: x f32 NHWC, degamma K16's table (256 floats), hist int32
// [batch, tiles_y, tiles_x, 256] zeroed; the grid as K2's (strips per tile,
// rows_per_strip rows each, clahe_gather.tables_plan); vec 4 or 1 pixels a
// thread (W / tiles_x a multiple of it, x 16-byte aligned).
int clahe_pallas_hist(const void* x, void* lab, void* hist, const void* degamma, int batch, int H, int W,
                      int tiles_y, int tiles_x, int strips, int rows_per_strip, int vec, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 4:
      return launch_hist_as<4>(x, lab, hist, degamma, batch, H, W, tiles_y, tiles_x, strips, rows_per_strip, s);
    case 1:
      return launch_hist_as<1>(x, lab, hist, degamma, batch, H, W, tiles_y, tiles_x, strips, rows_per_strip, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K16, second kernel: K3's body in its kK16 mode, float NHWC out; tables:
// clahe_pallas's table block (K3's layout: K16's fy and Y by L, the same
// quantiser); vec 4 or 1, band_rows and rows_par as clahe_apply's.
int clahe_pallas_apply(const void* lab, const void* luts, const void* tables, void* out, int batch, int H, int W,
                       int tiles_y, int tiles_x, int vec, int band_rows, int rows_par, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int bands = (H / (2 * tiles_y) + band_rows - 1) / band_rows;
  switch (vec) {
    case 4:
      return launch_apply_as<4, kF32Nhwc, kK16>(lab, luts, tables, nullptr, out, batch, H, W, tiles_y, tiles_x, bands,
                                                band_rows, rows_par, s, 0, 2 * tiles_y);
    case 1:
      return launch_apply_as<1, kF32Nhwc, kK16>(lab, luts, tables, nullptr, out, batch, H, W, tiles_y, tiles_x, bands,
                                                band_rows, rows_par, s, 0, 2 * tiles_y);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K3's table block as this build lays it out: 0 the quantiser's first
// bucket, 1 its last bucket index, 2 the block's length in 32-bit words.
int clahe_apply_table_layout(int what) {
  return what == 0 ? kQuantBase : what == 1 ? kQuantLast : kTabWords;
}

}  // extern "C"
