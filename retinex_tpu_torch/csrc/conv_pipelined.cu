// Stride-1 f32 convolution on the CUDA cores with a cp.async pipeline, for
// Hopper (sm_90a), behind a plain C interface.
//
// Replaces, for f32 activations:
//   K13 retinex_tpu/ops/conv_pallas.py::_conv_kernel (pallas_call in
//       conv2d_pallas) and
//   K15 retinex_tpu/ops/conv_pallas.py::_conv_im2col_kernel (pallas_call in
//       conv2d_pallas_im2col),
// one function: torch-parity padding (k//2 before, k-1-k//2 after, per
// axis; kernels up to 3x3), NHWC f32 in and out, an HWIO f32 kernel, f32
// products and sums (fmaf), then the f32 bias and the optional ReLU. The
// wrapper (retinex_tpu_torch/ops/conv_pallas.py) sends a call here when
// Cin % 4 == 0 and x's base is 16-byte aligned (whole 16-byte copies); other
// f32 calls, and K14 (conv2d_narrow), go to conv_direct.cu.
// It also carries K4's two 3x3 convolutions (retinex_tpu/ops/fused_blocks.py::
// _fam_conv_kernel; retinex_tpu_torch/ops/fused_blocks.py: fam_conv_y,
// 128 -> 256 with ReLU, and fam_conv_z, 256 -> 128 on the stacked second
// convs), with its weights packed once per model, and, through two options:
//   K12 retinex_tpu/ops/fused_blocks.py::_fam_kernel in f32 (fam_dual_y,
//       128 -> 256 with ReLU, then fam_dual_out, the two half convolutions
//       as one launch with groups = 2);
//   K10 retinex_tpu/ops/fused_blocks.py::_dec1_kernel (dec1_up, the 1x1;
//       dec1_c1, dec1_c2 with the +x1p residual; dec1_rc), all four stages.
// Groups: Cout tile t reads only input channels [g * Cin/groups, (g + 1) *
// Cin/groups), g = t / (Cout tiles per group), from an HWIO kernel [kh, kw,
// Cin/groups, Cout], so a block-diagonal kernel does none of the zero
// products. Residual: out = relu(acc + bias) + residual, in that order, as
// the JAX dec1 kernel adds x1p after its ReLU; an instance of its own
// (kRes), since a run-time test in the epilogue cost every call 2 % through
// the main loop's schedule.
//
// Bound on the card: operations. At [2,544,960,128] 3x3 -> 128 the
// convolution is 3.08e11 FLOP, 4.60 ms at the H100's 67 TFLOP/s of f32
// outside the tensor cores (TF32 stays off: the parity rule), against 0.6 ms
// for its bytes. So the design is about keeping the FMA pipes issuing.
//
// Design: a block of 256 threads owns 8 x 16 output pixels x 128 output
// channels; thread (pg, cg) owns 8 pixels of one tile row (pg) and channels
// 4cg..4cg+3 and 64+4cg..64+4cg+3 (cg < 16): 64 f32 accumulators, an
// 8 x 8 register outer product. The block walks the input channels in
// chunks of 8. For each chunk it stages, with cp.async (16 bytes a copy,
// zero-filled outside the image), the 10 x 18-pixel halo tile and the
// chunk's weight slice for every tap ([tap][8][128] f32, packed by the
// wrapper as [chunk][tap][8][Cout_pad]) into one of two shared-memory
// stages, so the next chunk's loads run under this chunk's FMAs. Per 4
// input channels a thread reads 8 weight float4 and 8 pixel float4 from
// shared memory for 256 fmaf. 85 KB of shared memory per block at 3x3 and
// __launch_bounds__(256, 2) put two blocks (16 warps) on an SM, in 128
// registers: the copy loops stay rolled (unrolled, their address arithmetic
// made ptxas spill next to the 64 live accumulators).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTH = 8, kTW = 16;             // output tile
constexpr int kHH = kTH + 2, kHW = kTW + 2;  // halo, kernels up to 3x3
constexpr int kHaloPx = kHH * kHW;
constexpr int kCK = 8;                       // input channels per chunk
constexpr int kCot = 128;                    // output channels per block
constexpr int kPx = 8;                       // pixels per thread

struct PipeArgs {
  int H, W, cin, cout, cout_pad, kh, kw, relu, n_chunks, co_tiles;
  int cin_g;        // input channels a Cout tile reads (Cin / groups)
  int group_tiles;  // Cout tiles per group
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;" ::: "memory"); }

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

template <bool kRes>
__global__ void __launch_bounds__(kThreads, 2)
    conv_pipelined_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                              const float* __restrict__ bias, const float* __restrict__ residual,
                              float* __restrict__ out, const PipeArgs a) {
  extern __shared__ float4 smem[];
  const int taps = a.kh * a.kw;
  // One stage: the halo [kHaloPx][kCK] then the weights [taps][kCK][kCot].
  const int stage_f4 = kHaloPx * kCK / 4 + taps * kCK * kCot / 4;
  const int t = threadIdx.x, cg = t % 16, pg = t / 16;
  const int row = pg / 2, col0 = (pg % 2) * kPx;
  const int r0 = blockIdx.y * kTH, c0 = blockIdx.x * kTW;
  const int b = blockIdx.z / a.co_tiles, ct = blockIdx.z % a.co_tiles, co0 = ct * kCot;
  const int pad_t = a.kh / 2, pad_l = a.kw / 2;
  const float* xb = x + (size_t)b * a.H * a.W * a.cin + (ct / a.group_tiles) * a.cin_g;  // the group's channels

  auto load = [&](int chunk, int stage) {
    const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem + stage * stage_f4));
    // Halo: two 16-byte copies per pixel; zeros outside the image and past
    // the group's channels.
#pragma unroll 1
    for (int i = t; i < kHaloPx * 2; i += kThreads) {
      const int px = i / 2, half = i % 2;
      const int gy = r0 - pad_t + px / kHW, gx = c0 - pad_l + px % kHW, ci = chunk * kCK + 4 * half;
      const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && ci < a.cin_g;
      const float* src = in ? xb + ((size_t)gy * a.W + gx) * a.cin + ci : xb;
      cp_async16(s0 + 16 * i, src, in ? 16 : 0);
    }
    // Weights: taps * kCK rows of kCot floats.
    const float* wc = w + (size_t)chunk * taps * kCK * a.cout_pad + co0;
    const uint32_t ws0 = s0 + 16 * (kHaloPx * kCK / 4);
#pragma unroll 1
    for (int i = t; i < taps * kCK * (kCot / 4); i += kThreads) {
      const int r = i / (kCot / 4), c4 = i % (kCot / 4);
      cp_async16(ws0 + 16 * i, wc + (size_t)r * a.cout_pad + 4 * c4, 16);
    }
    cp_async_commit();
  };

  float acc[kPx][8];
#pragma unroll
  for (int i = 0; i < kPx; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0, 0);
  for (int chunk = 0; chunk < a.n_chunks; ++chunk) {
    if (chunk + 1 < a.n_chunks) {
      load(chunk + 1, (chunk + 1) & 1);
    } else {
      cp_async_commit();  // an empty group keeps wait_group 1 exact
    }
    cp_async_wait1();
    __syncthreads();
    const float4* xs = smem + (chunk & 1) * stage_f4;
    const float4* ws = xs + kHaloPx * kCK / 4;
    for (int tap = 0; tap < taps; ++tap) {
      const int u = tap / a.kw, v = tap - u * a.kw;
      const float4* xrow = xs + ((row + u) * kHW + col0 + v) * (kCK / 4);
      const float4* wt = ws + tap * kCK * (kCot / 4);
#pragma unroll
      for (int k4 = 0; k4 < kCK / 4; ++k4) {
        float4 wv[4][2];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          wv[k][0] = wt[(4 * k4 + k) * (kCot / 4) + cg];
          wv[k][1] = wt[(4 * k4 + k) * (kCot / 4) + 16 + cg];
        }
#pragma unroll
        for (int i = 0; i < kPx; ++i) fma_px(acc[i], xrow[i * (kCK / 4) + k4], wv);
      }
    }
    __syncthreads();  // this stage is free for the load two chunks on
  }

  const int gy = r0 + row;
  if (gy >= a.H) return;
  const size_t row0 = ((size_t)b * a.H + gy) * a.W * a.cout;
  float* ob = out + row0;
  const float* rb = kRes ? residual + row0 : nullptr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int co = co0 + 64 * h + 4 * cg;
    if (co >= a.cout) continue;
    const float4 bv = __ldg(reinterpret_cast<const float4*>(bias + co));
#pragma unroll
    for (int i = 0; i < kPx; ++i) {
      const int gx = c0 + col0 + i;
      if (gx >= a.W) break;
      float r[4] = {acc[i][4 * h] + bv.x, acc[i][4 * h + 1] + bv.y, acc[i][4 * h + 2] + bv.z, acc[i][4 * h + 3] + bv.w};
      if (a.relu) {
#pragma unroll
        for (int j = 0; j < 4; ++j) r[j] = fmaxf(r[j], 0.f);
      }
      const size_t off = (size_t)gx * a.cout + co;
      float* o = ob + off;
      if (a.cout % 4 == 0) {
        if (kRes) {
          const float4 rv = __ldg(reinterpret_cast<const float4*>(rb + off));
          r[0] += rv.x, r[1] += rv.y, r[2] += rv.z, r[3] += rv.w;
        }
        *reinterpret_cast<float4*>(o) = make_float4(r[0], r[1], r[2], r[3]);
      } else {
        for (int j = 0; j < 4 && co + j < a.cout; ++j) o[j] = kRes ? r[j] + rb[off + j] : r[j];
      }
    }
  }
}

// Two stages of halo and weights.
size_t smem_bytes(int kh, int kw) { return 2 * sizeof(float) * (size_t)(kHaloPx * kCK + kh * kw * kCK * kCot); }

}  // namespace

extern "C" {

// x [batch, H, W, cin] f32, cin % 4 == 0, 16-byte aligned; w the packed
// kernel [n_chunks, kh * kw, 8, cout_pad] f32 of an HWIO kernel [kh, kw,
// cin / groups, cout] (n_chunks = ceil(cin / groups / 8), zeros past its
// input channels and cout; cout_pad a multiple of 128); bias f32
// [cout_pad]; residual null or [batch, H, W, cout] f32, 16-byte aligned;
// out [batch, H, W, cout] f32. groups > 1 takes whole chunks and whole Cout
// tiles per group: (cin / groups) % 8 == 0 and (cout / groups) % 128 == 0.
int conv_pipelined_f32(const void* x, const void* w, const void* bias, const void* residual, void* out, int batch,
                       int H, int W, int cin, int cout, int cout_pad, int kh, int kw, int relu, int groups,
                       void* stream) {
  if (cin % 4 != 0 || kh < 1 || kh > 3 || kw < 1 || kw > 3 || cout_pad % kCot != 0 || groups < 1 ||
      cin % groups != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(residual) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int cin_g = cin / groups;
  if (groups > 1 && (cin_g % kCK != 0 || cout != cout_pad || (cout / groups) % kCot != 0))
    return (int)cudaErrorInvalidValue;
  const PipeArgs a{H, W, cin, cout, cout_pad, kh, kw, relu, (cin_g + kCK - 1) / kCK, cout_pad / kCot,
                   cin_g, cout_pad / kCot / groups};
  const size_t smem = smem_bytes(kh, kw);
  auto kernel = residual == nullptr ? conv_pipelined_f32_kernel<false> : conv_pipelined_f32_kernel<true>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, batch * a.co_tiles);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>((const float*)x, (const float*)w, (const float*)bias,
                                                         (const float*)residual, (float*)out, a);
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block for a kh x kw kernel.
int conv_pipelined_smem(int kh, int kw) { return (int)smem_bytes(kh, kw); }

}  // extern "C"
