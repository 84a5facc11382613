// Narrow stride-1 f32 convolution on the CUDA cores with a cp.async
// pipeline and a persistent grid, for Hopper (sm_90a), behind a plain C
// interface.
//
// Replaces, for f32 activations:
//   K14 retinex_tpu/ops/conv_pallas.py::_conv_narrow_kernel (pallas_call in
//       conv2d_narrow): a square 3x3 or 5x5 kernel, dilation 1 or 2,
//       symmetric padding (k//2) * dilation, NHWC f32 in and out, an HWIO
//       f32 kernel, f32 products and sums (fmaf), then the f32 bias and the
//       optional ReLU.
// The wrapper (retinex_tpu_torch/ops/conv_pallas.py) sends an f32
// conv2d_narrow call here when Cin % 4 == 0 and x's base is 16-byte aligned
// (whole 16-byte copies); other f32 calls go to conv_direct.cu, bf16 calls
// to conv_wgmma.cu.
//
// Bound on the card: operations. At [2,1088,1920,32] 3x3 32 -> 32 the
// convolution is 7.7e10 FLOP, 1.149 ms at the H100's 67 TFLOP/s of f32
// outside the tensor cores (TF32 stays off: the parity rule), against 0.160
// ms for its bytes. So the design is about keeping the FMA pipes issuing.
//
// Design. A block of 256 threads owns output tiles of kTH x kTW pixels x kCot
// channels, kCot 32, 64 or 128 (the smallest that holds Cout; wider Cout
// takes several tiles of 128), so a 32-wide layer computes no padded
// channels: 16 x 32 pixels at 32 channels, 8 x 32 at 64, 8 x 16 at 128.
// Thread (pg, cg) owns 8 pixels of one tile row, columns phase + kG*i (the
// row's kG pixel groups interleaved, so the pixel groups of a warp read
// neighbouring pixels), and channels 4cg..4cg+3 and kCot/2+4cg..kCot/2+4cg+3:
// an 8-pixel x 8-channel register outer product, 64 f32 accumulators. Per 4
// input channels a thread reads 8 pixel float4 and 8 weight float4 from
// shared memory for 256 fmaf; the halo rows are kRow4 float4 apart, one more
// than a multiple of 8 (16 bytes past a multiple of 128), so a warp's two
// tile rows fall on other banks and no load conflicts (the Cout-128 tile's
// weight loads, 16 distinct float4, take two wavefronts).
// The kernel walks input channels in chunks of 8: for each it stages the
// halo tile ((kTH + (k-1)*dil) x (kTW + (k-1)*dil) pixels x 8 channels,
// 16-byte cp.async copies zero-filled outside the image and past Cin) and
// the chunk's weights for every tap ([tap][8][kCot], packed by the wrapper
// as [Cout tile][chunk][tap][8][kCot], one contiguous run) into one of
// kStages stages: 3 where three fit in shared memory, else 2 (the Cout-128
// tile at 5x5). A persistent grid (as many blocks as fit on the card) walks
// the tiles, Cout tile fastest, then tile column, tile row, image, and its
// pipeline runs over the block's (tile, chunk) items as one stream: with
// Cin = 32 a tile has only four chunks, and the next tile's first chunks
// load while the last one's FMAs and epilogue run. The kernel size and
// dilation are template parameters (the 3x3 and 5x5 halos at dilation 1
// and 2), so the halo's geometry and the tap loop's address arithmetic are
// constants.
// One block of 256 threads an SM, __launch_bounds__(256, 1): the 64
// accumulators, the weights of 4 input channels for two taps in flight (the
// tap loop unrolled by two, which measured faster than by one, three or
// nine) and the loop's pointers take about 160 registers. Held to 128 for
// a second block, as conv_pipelined.cu is, ptxas spilled, and that build
// measured slower on the H100. conv_pipelined.cu's instances (K4, K10, K12
// f32, K13/K15 f32) are left as they are.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kCK = 8;  // input channels per chunk
constexpr int kPx = 8;  // pixels per thread
// The most dynamic shared memory one block may take.
constexpr int kMaxSmem = 232448;

template <int kCot, int kKS, int kDil>
struct Geom {
  static constexpr int kCg = kCot / 8;            // channel groups of a tile
  static constexpr int kPg = kThreads / kCg;      // pixel groups of a tile
  static constexpr int kTW = kCot == 128 ? 16 : 32;
  static constexpr int kG = kTW / kPx;            // pixel groups per tile row
  static constexpr int kTH = kPg / kG;
  static constexpr int kXH = kTH + (kKS - 1) * kDil, kXW = kTW + (kKS - 1) * kDil;
  static constexpr int kRow4 = (2 * kXW + 6) / 8 * 8 + 1;  // >= 2 * kXW, 1 mod 8
  static constexpr int kHalo4 = kXH * kRow4;
  static constexpr int kTaps = kKS * kKS;
  static constexpr int kW4 = kTaps * kCK * kCot / 4;
  static constexpr int kStage4 = kHalo4 + kW4;
  static constexpr int kStageBytes = 16 * kStage4;
  static constexpr int kStages = 3 * kStageBytes <= kMaxSmem ? 3 : 2;
  static constexpr int kSmem = kStages * kStageBytes;
  static_assert(kG * kTH == kPg && kSmem <= kMaxSmem, "tile geometry");
};

struct NarrowArgs {
  int H, W, cin, cout, relu, n_chunks, co_tiles, tiles_x, tiles_y, n_tiles;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int kN>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;" ::"n"(kN) : "memory"); }

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

template <int kCot, int kKS, int kDil>
__global__ void __launch_bounds__(kThreads, 1)
    conv_narrow_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                           const float* __restrict__ bias, float* __restrict__ out, const NarrowArgs a) {
  using G = Geom<kCot, kKS, kDil>;
  extern __shared__ float4 smem[];
  constexpr int kPad = (kKS / 2) * kDil;
  const int t = threadIdx.x, cg = t % G::kCg, pg = t / G::kCg;
  const int row = pg / G::kG, phase = pg % G::kG;
  const int my_tiles = (a.n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int n_items = my_tiles * a.n_chunks;

  // Tile -> (image, first row, first column, Cout tile): Cout tile fastest,
  // then tile column, tile row, image.
  auto tile_of = [&](int k, int& b, int& y0, int& x0, int& ct) {
    int tile = (int)blockIdx.x + k * (int)gridDim.x;
    ct = tile % a.co_tiles;
    tile /= a.co_tiles;
    x0 = (tile % a.tiles_x) * G::kTW;
    tile /= a.tiles_x;
    y0 = (tile % a.tiles_y) * G::kTH;
    b = tile / a.tiles_y;
  };

  auto load = [&](int q, int stage) {
    const int k = q / a.n_chunks, chunk = q - k * a.n_chunks;
    int b, y0, x0, ct;
    tile_of(k, b, y0, x0, ct);
    const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem + stage * G::kStage4));
    const float* xb = x + (size_t)b * a.H * a.W * a.cin;
    // Halo: two 16-byte copies per pixel; zeros outside the image and past Cin.
#pragma unroll 1
    for (int i = t; i < G::kXH * G::kXW * 2; i += kThreads) {
      const int px = i >> 1, half = i & 1;
      const int r = px / G::kXW, c = px - r * G::kXW;
      const int gy = y0 - kPad + r, gx = x0 - kPad + c, ci = chunk * kCK + 4 * half;
      const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && ci < a.cin;
      const float* src = in ? xb + ((size_t)gy * a.W + gx) * a.cin + ci : xb;
      cp_async16(s0 + 16 * (r * G::kRow4 + 2 * c + half), src, in ? 16 : 0);
    }
    // Weights: the (Cout tile, chunk) run of kW4 float4.
    const float4* wc = reinterpret_cast<const float4*>(w) + ((size_t)ct * a.n_chunks + chunk) * G::kW4;
    const uint32_t ws0 = s0 + 16 * G::kHalo4;
#pragma unroll 1
    for (int i = t; i < G::kW4; i += kThreads) cp_async16(ws0 + 16 * i, wc + i, 16);
  };

  float acc[kPx][8];
#pragma unroll
  for (int i = 0; i < kPx; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < G::kStages - 1; ++s) {
    if (s < n_items) load(s, s);
    cp_async_commit();  // empty groups keep wait_group's count exact
  }
  for (int q = 0; q < n_items; ++q) {
    cp_async_wait<G::kStages - 2>();
    __syncthreads();  // item q is in; every thread is done with item q - 1's stage
    {
      const int nq = q + G::kStages - 1;
      if (nq < n_items) load(nq, nq % G::kStages);
      cp_async_commit();
    }
    const float4* xs = smem + (q % G::kStages) * G::kStage4;
    const float4* ws = xs + G::kHalo4 + cg;
#pragma unroll 2
    for (int tap = 0; tap < G::kTaps; ++tap) {
      const int u = tap / kKS, v = tap - u * kKS;
      const float4* xp = xs + (row + u * kDil) * G::kRow4 + 2 * (phase + v * kDil);
      const float4* wt = ws + tap * kCK * (kCot / 4);
#pragma unroll
      for (int k4 = 0; k4 < kCK / 4; ++k4) {
        float4 wv[4][2];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wv[kk][0] = wt[(4 * k4 + kk) * (kCot / 4)];
          wv[kk][1] = wt[(4 * k4 + kk) * (kCot / 4) + kCot / 8];
        }
#pragma unroll
        for (int i = 0; i < kPx; ++i) fma_px(acc[i], xp[2 * G::kG * i + k4], wv);
      }
    }
    // The counters are derived from q (no register carries them across the
    // tap loop): the tile's last chunk stores it, while the next tile's
    // first chunks are already loading.
    const int k = q / a.n_chunks;
    if (q - k * a.n_chunks != a.n_chunks - 1) continue;
    int b, y0, x0, ct;
    tile_of(k, b, y0, x0, ct);
    const int gy = y0 + row;
    if (gy < a.H) {
      float* ob = out + ((size_t)b * a.H + gy) * a.W * a.cout;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = ct * kCot + h * (kCot / 2) + 4 * cg;
        if (co >= a.cout) continue;
        const float4 bv = __ldg(reinterpret_cast<const float4*>(bias + co));
#pragma unroll
        for (int i = 0; i < kPx; ++i) {
          const int gx = x0 + phase + G::kG * i;
          if (gx >= a.W) continue;
          float r[4] = {acc[i][4 * h] + bv.x, acc[i][4 * h + 1] + bv.y, acc[i][4 * h + 2] + bv.z,
                        acc[i][4 * h + 3] + bv.w};
          if (a.relu) {
#pragma unroll
            for (int j = 0; j < 4; ++j) r[j] = fmaxf(r[j], 0.f);
          }
          float* o = ob + (size_t)gx * a.cout + co;
          if (a.cout % 4 == 0) {
            *reinterpret_cast<float4*>(o) = make_float4(r[0], r[1], r[2], r[3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (co + j < a.cout) o[j] = r[j];
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPx; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
}

// Devices whose resident-block count an instance keeps (more are set up on
// every launch).
constexpr int kMaxDevices = 32;

// One instance's launch on a persistent grid (as many blocks as fit on every
// SM, at most one per tile). The shared-memory attribute and the grid's
// blocks are set and found at the instance's first launch on a device and
// kept. With plan set, fills {dynamic shared memory, stages, blocks per SM,
// registers, local (spilled) bytes per thread} and launches nothing.
template <int kCot, int kKS, int kDil>
int launch(const void* x, const void* w, const void* bias, void* out, int batch, int H, int W, int cin, int cout,
           int relu, int* plan, void* stream) {
  using G = Geom<kCot, kKS, kDil>;
  auto kernel = conv_narrow_f32_kernel<kCot, kKS, kDil>;
  static std::atomic<int> resident[kMaxDevices];  // 0 until set up on that device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int blocks = dev < kMaxDevices ? resident[dev].load(std::memory_order_relaxed) : 0;
  if (blocks == 0 || plan != nullptr) {
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem)) != cudaSuccess)
      return (int)err;
    int per_sm = 0, sms = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, G::kSmem)) != cudaSuccess)
      return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
    if (plan != nullptr) {
      cudaFuncAttributes attr;
      if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return (int)err;
      plan[0] = G::kSmem, plan[1] = G::kStages, plan[2] = per_sm, plan[3] = attr.numRegs;
      plan[4] = (int)attr.localSizeBytes;
      return 0;
    }
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    blocks = per_sm * sms;
    if (dev < kMaxDevices) resident[dev].store(blocks, std::memory_order_relaxed);
  }
  NarrowArgs a{H, W, cin, cout, relu, (cin + kCK - 1) / kCK, (cout + kCot - 1) / kCot,
               (W + G::kTW - 1) / G::kTW, (H + G::kTH - 1) / G::kTH, 0};
  const long long n_tiles = (long long)batch * a.tiles_y * a.tiles_x * a.co_tiles;
  if (n_tiles == 0) return 0;
  if (n_tiles > (1LL << 30)) return (int)cudaErrorInvalidValue;
  a.n_tiles = (int)n_tiles;
  const int grid = (int)(n_tiles < blocks ? n_tiles : blocks);
  kernel<<<grid, kThreads, G::kSmem, (cudaStream_t)stream>>>((const float*)x, (const float*)w, (const float*)bias,
                                                             (float*)out, a);
  return (int)cudaGetLastError();
}

template <int kCot>
int launch_ks(int ks, int dil, const void* x, const void* w, const void* bias, void* out, int batch, int H, int W,
              int cin, int cout, int relu, int* plan, void* stream) {
  if (ks == 3 && dil == 1) return launch<kCot, 3, 1>(x, w, bias, out, batch, H, W, cin, cout, relu, plan, stream);
  if (ks == 3 && dil == 2) return launch<kCot, 3, 2>(x, w, bias, out, batch, H, W, cin, cout, relu, plan, stream);
  if (ks == 5 && dil == 1) return launch<kCot, 5, 1>(x, w, bias, out, batch, H, W, cin, cout, relu, plan, stream);
  if (ks == 5 && dil == 2) return launch<kCot, 5, 2>(x, w, bias, out, batch, H, W, cin, cout, relu, plan, stream);
  return (int)cudaErrorInvalidValue;
}

int dispatch(int cot, int ks, int dil, const void* x, const void* w, const void* bias, void* out, int batch, int H,
             int W, int cin, int cout, int relu, int* plan, void* stream) {
  switch (cot) {
    case 32: return launch_ks<32>(ks, dil, x, w, bias, out, batch, H, W, cin, cout, relu, plan, stream);
    case 64: return launch_ks<64>(ks, dil, x, w, bias, out, batch, H, W, cin, cout, relu, plan, stream);
    case 128: return launch_ks<128>(ks, dil, x, w, bias, out, batch, H, W, cin, cout, relu, plan, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x [batch, H, W, cin] f32, cin % 4 == 0, 16-byte aligned; w the packed
// kernel [ceil(cout / cot), ceil(cin / 8), ks * ks, 8, cot] f32 of an HWIO
// kernel [ks, ks, cin, cout] (zeros past cin and cout); bias f32 [cout
// rounded up to cot]; out [batch, H, W, cout] f32. cot is 32, 64 or 128, ks 3
// or 5, dil 1 or 2; the padding is (ks / 2) * dil on every side.
int conv_narrow_f32(const void* x, const void* w, const void* bias, void* out, int batch, int H, int W, int cin,
                    int cout, int ks, int dil, int relu, int cot, void* stream) {
  if (cin % 4 != 0 || cin < 4 || cout < 1 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return dispatch(cot, ks, dil, x, w, bias, out, batch, H, W, cin, cout, relu, nullptr, stream);
}

// The instance's plan: {dynamic shared memory per block, pipeline stages,
// blocks per SM, registers per thread, local bytes per thread}; 0, or a
// cudaError where the instance does not exist.
int conv_narrow_plan(int cot, int ks, int dil, int* plan) {
  return dispatch(cot, ks, dil, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 4, 1, 0, plan, nullptr);
}

}  // extern "C"
