// Direct (implicit-im2col) stride-1 convolution for Hopper (sm_90a), behind a
// plain C interface.
//
// One kernel, templated on the element type (float or __nv_bfloat16) and on
// the block's output-channel tile, carries three TPU kernels:
//
//   K13 replaces retinex_tpu/ops/conv_pallas.py::_conv_kernel (pallas_call in
//       conv2d_pallas): kernels up to 3x3, torch-parity padding (k//2 before,
//       k-1-k//2 after, per axis);
//   K15 replaces retinex_tpu/ops/conv_pallas.py::_conv_im2col_kernel
//       (pallas_call in conv2d_pallas_im2col): the same function, which the
//       TPU ran as one long-K GEMM over patches built in VMEM;
//   K14 replaces retinex_tpu/ops/conv_pallas.py::_conv_narrow_kernel
//       (pallas_call in conv2d_narrow): 3x3 or 5x5, dilation 1 or 2,
//       symmetric padding (k//2)*dilation.
//
// A call reaches this kernel only where the faster ones cannot take it
// (conv_pallas.route): bf16 with Cin % 8 != 0 (conv_wgmma.cu needs TMA's
// 16-byte strides), f32 with Cin % 4 != 0 (conv_pipelined.cu and
// conv_narrow.cu copy 16 bytes at a time), or an x whose base is not
// 16-byte aligned.
//
// The kernel takes kh, kw, the dilation and the low padding of each axis, so
// one body computes both padding conventions. The Python wrappers
// (retinex_tpu_torch/ops/conv_pallas.py) check device, dtype, shape and
// contiguity, cast the HWIO kernel to the activation type and zero-pad it to
// [kh, kw, cin_pad, cout_pad] (whole input-channel chunks, whole output tiles;
// x is never copied), pass the bias as f32 [cout_pad], allocate the output and
// pass PyTorch's current stream. The launch function returns
// cudaGetLastError().
//
// Numbers: the products and their sum are f32 (fmaf on the CUDA cores; bf16
// operands are widened exactly with __bfloat162float, so a bf16 x bf16
// product is exact in f32, as on the TPU's MXU with f32 accumulation); then
// the f32 bias, the optional ReLU, and one rounding to the element type
// (__float2bfloat16_rn: round to nearest even, as torch's .to(bfloat16)).
//
// Bound on the card: operations. 2 * kh * kw * Cin * Cout FLOP per output
// pixel against (Cin + Cout) elements moved: for 3x3, 128 -> 128 that is
// 295 kFLOP per 1 KB of f32, far above the H100's f32 ratio (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/B); in bf16 the tensor cores' 989 TFLOP/s bound it at
// 0.31 ms for [2,544,960,128], which this CUDA-core kernel does not reach.
//
// Design: a block of 256 threads owns an output tile of kTH rows x 16
// columns x kCot channels. Thread (pr, cg) owns tile row pr and channels
// 4cg..4cg+3 of the tile: 64 f32 accumulators in registers. The block walks
// the input channels in chunks of 32: it stages the chunk's halo tile
// ((kTH + (kh-1)*dil) x (16 + (kw-1)*dil) pixels, zero outside the image and
// past Cin) in shared memory as f32, then for every tap and every 4 input
// channels reads 4 weight rows of its 4 channels (one 16 B or 8 B load each,
// coalesced across the warp, L1/L2-resident) and broadcasts 16 pixels' float4
// from shared memory into 256 fmaf. kCot is 128, 64 or 32 (the smallest that
// holds Cout), so narrow layers keep every lane busy: kTH = 256 / (kCot / 4)
// = 8, 16 or 32 rows. No tensor cores, TMA or wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTW = 16;  // output columns per thread
constexpr int kCK = 32;  // input channels staged per pass
constexpr int kCK4 = kCK / 4;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// Four consecutive elements as f32 (16 B aligned for float, 8 B for bf16).
__device__ __forceinline__ float4 load4(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
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

struct ConvArgs {
  int H, W, cin, cout, cin_pad, cout_pad, kh, kw, dil, pad_t, pad_l, relu, co_tiles;
};

template <typename T, int kCot>
__global__ void __launch_bounds__(kThreads)
    conv_direct_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ bias, T* __restrict__ out, const ConvArgs a) {
  constexpr int kNcg = kCot / 4;          // lanes across the channel tile
  constexpr int kTH = kThreads / kNcg;    // output rows of the tile
  extern __shared__ float4 xs[];          // [XH * XW][kCK4], f32
  const int XH = kTH + (a.kh - 1) * a.dil, XW = kTW + (a.kw - 1) * a.dil;
  const int t = threadIdx.x, cg = t % kNcg, pr = t / kNcg;
  const int r0 = blockIdx.y * kTH, c0 = blockIdx.x * kTW;
  const int b = blockIdx.z / a.co_tiles, co0 = (blockIdx.z % a.co_tiles) * kCot;
  const T* xb = x + (size_t)b * a.H * a.W * a.cin;
  float* xsf = reinterpret_cast<float*>(xs);

  float acc[kTW][4];
#pragma unroll
  for (int i = 0; i < kTW; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int ci0 = 0; ci0 < a.cin_pad; ci0 += kCK) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = t; i < XH * XW * kCK; i += kThreads) {
      const int c = i % kCK, pix = i / kCK;
      const int gy = r0 - a.pad_t + pix / XW, gx = c0 - a.pad_l + pix % XW, ci = ci0 + c;
      float v = 0.f;
      if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && ci < a.cin) v = to_f(xb[((size_t)gy * a.W + gx) * a.cin + ci]);
      xsf[i] = v;
    }
    __syncthreads();
    for (int u = 0; u < a.kh; ++u) {
      for (int v = 0; v < a.kw; ++v) {
        const T* wt = w + ((size_t)(u * a.kw + v) * a.cin_pad + ci0) * a.cout_pad + co0 + 4 * cg;
        const float4* xrow = xs + ((pr + u * a.dil) * XW + v * a.dil) * kCK4;
#pragma unroll 2
        for (int k = 0; k < kCK; k += 4) {
          const float4 w0 = load4(wt + (size_t)k * a.cout_pad), w1 = load4(wt + (size_t)(k + 1) * a.cout_pad);
          const float4 w2 = load4(wt + (size_t)(k + 2) * a.cout_pad), w3 = load4(wt + (size_t)(k + 3) * a.cout_pad);
#pragma unroll
          for (int i = 0; i < kTW; ++i) fma4(acc[i], xrow[i * kCK4 + k / 4], w0, w1, w2, w3);
        }
      }
    }
  }

  const int gy = r0 + pr, co = co0 + 4 * cg;
  if (gy >= a.H || co >= a.cout) return;
  const float4 bv = __ldg(reinterpret_cast<const float4*>(bias + co));
  T* ob = out + ((size_t)b * a.H + gy) * a.W * a.cout;
#pragma unroll
  for (int i = 0; i < kTW; ++i) {
    const int gx = c0 + i;
    if (gx >= a.W) break;
    float r[4] = {acc[i][0] + bv.x, acc[i][1] + bv.y, acc[i][2] + bv.z, acc[i][3] + bv.w};
    if (a.relu) {
#pragma unroll
      for (int j = 0; j < 4; ++j) r[j] = fmaxf(r[j], 0.f);
    }
    T* o = ob + (size_t)gx * a.cout + co;
    if (a.cout % 4 == 0) {
      store4(o, make_float4(r[0], r[1], r[2], r[3]));
    } else {
      for (int j = 0; j < 4 && co + j < a.cout; ++j) o[j] = from_f<T>(r[j]);
    }
  }
}

template <typename T, int kCot>
int launch(const void* x, const void* w, const void* bias, void* out, int batch, const ConvArgs& a,
           void* stream) {
  constexpr int kTH = kThreads / (kCot / 4);
  const int XH = kTH + (a.kh - 1) * a.dil, XW = kTW + (a.kw - 1) * a.dil;
  const size_t smem = (size_t)XH * XW * kCK * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(conv_direct_kernel<T, kCot>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.W + kTW - 1) / kTW, (a.H + kTH - 1) / kTH, batch * a.co_tiles);
  conv_direct_kernel<T, kCot><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w, (const float*)bias, (T*)out, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tile(const void* x, const void* w, const void* bias, void* out, int batch, const ConvArgs& a,
                int co_tile, void* stream) {
  switch (co_tile) {
    case 32: return launch<T, 32>(x, w, bias, out, batch, a, stream);
    case 64: return launch<T, 64>(x, w, bias, out, batch, a, stream);
    case 128: return launch<T, 128>(x, w, bias, out, batch, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x [batch, H, W, cin] and out [batch, H, W, cout] in the element type (bf16
// when is_bf16, else f32); w [kh, kw, cin_pad, cout_pad] in the element type;
// bias f32 [cout_pad]; co_tile 32, 64 or 128 divides cout_pad; 32 divides
// cin_pad.
int conv_direct(const void* x, const void* w, const void* bias, void* out, int batch, int H, int W,
                int cin, int cout, int cin_pad, int cout_pad, int kh, int kw, int dil, int pad_t,
                int pad_l, int relu, int is_bf16, int co_tile, void* stream) {
  const ConvArgs a{H, W, cin, cout, cin_pad, cout_pad, kh, kw, dil, pad_t, pad_l, relu, cout_pad / co_tile};
  return is_bf16 ? launch_tile<__nv_bfloat16>(x, w, bias, out, batch, a, co_tile, stream)
                 : launch_tile<float>(x, w, bias, out, batch, a, co_tile, stream);
}

}  // extern "C"
