// Luma-gain CLAHE apply for Hopper (sm_90a), behind a plain C interface.
//
// One kernel, templated on where the luma comes from, on the RGB layout and
// on the pixels a thread takes, carries the apply stage of the clahe_luma
// mode on uint8 images (H, W multiples of 2 * tiles):
//
//   clahe_luma_apply_kernel<false, kNhwc, *>  (K7) takes the u8 luma plane
//                                             [B, H, W]; RGB in and out
//                                             planar [B, 3, H, W] or, with
//                                             kNhwc, NHWC [B, H, W, 3]
//   clahe_luma_apply_kernel<true, false, *>   (K9) recomputes the luma from
//                                             the planar RGB it already
//                                             loads (no luma operand)
//
// The tile LUTs come from K2 (clahe_lab.cu::clahe_tables_kernel) run on the
// luma plane. The Python wrappers (retinex_tpu_torch/ops/clahe_luma.py)
// check device, dtype, shape and contiguity, allocate every output, pass
// the frame's blend geometry (``luma_geometry``: per column the x-weight and
// the two neighbour tiles' LUT offsets, per row the y-weight, made once per
// shape on the CPU by the plain version's own _cell_maps) and PyTorch's
// current stream. Each launch function returns cudaGetLastError().
//
// Numerics: build with -fmad=false, so the compiler contracts nothing; the
// LUT blend calls fmaf where the plain version (ops/clahe_fast.py::blend)
// fuses, and the in-kernel luma calls fmaf where the JAX package's compiled
// CPU program contracts 0.299 r + 0.587 g + 0.114 b (settled over all 2^24
// RGB triples). The gain is the IEEE quotient (y_eq + 1) / (y + 1), as
// _RECIP_GAIN=False has it, computed as q0 = n * r, q = fma(fma(-d, q0, n),
// r, q0) from r = 1/d rounded to f32 (a table of the 256 reciprocals made on
// the CPU): Markstein's correction, which gives the correctly rounded
// quotient of every n, d in 1..256 (all 65536 pairs checked in
// tests/test_torch_clahe_luma.py), with no slow-path call; every rounding
// is half to even: for 0 <= v < 255.5, rint(v)
// is the low byte of the f32 bits of v + 2^23 (the add rounds to an
// integer, half to even, as rintf); a byte b becomes the float b as the f32
// with bits 0x4B000000 | b, less 2^23 (both exact). The plain version's
// clamps to [0, 255] are kept where they can act: the scaled channels'
// upper one. The others cannot: the luma of bytes and every product and
// fused sum of the blend are non-negative, the luma is at most 255.00002
// (over all 2^24 triples, tests/test_torch_clahe_luma.py), and the blend
// of four values in [0, 255] with weights in [0, 1], rounded six times, at
// most 255 (1 + 2^-24)^6 < 255.5; so rint of each lies in [0, 255].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHist = 256;
constexpr int kThreads = 256;
constexpr int kSegRows = 8;  // rows of a half-cell band a block takes
constexpr float kLumaR = (float)0.299;
constexpr float kLumaG = (float)0.587;
constexpr float kLumaB = (float)0.114;
constexpr float kTwo23 = 8388608.0f;
constexpr uint32_t kTwo23Bits = 0x4B000000u;

// floor((c - 1) / 2) for c >= 0, clipped to [0, tiles - 1] (as in
// clahe_lab.cu: C's integer division truncates, so c = 0 is special).
__device__ __forceinline__ void neighbor_tiles(int c, int tiles, int* t0, int* t1) {
  const int f = (c + 1) / 2 - 1;
  *t0 = min(max(f, 0), tiles - 1);
  *t1 = min(max(f + 1, 0), tiles - 1);
}

// rint(v) + 2^23 for 0 <= v < 255.5: its f32 bits are 0x4B000000 | the byte.
__device__ __forceinline__ float round_biased(float v) { return __fadd_rn(v, kTwo23); }

// Byte k of a run of bytes held in 32-bit words (four a word where the
// thread takes kVec > 1 pixels, else one, in the low byte), as a float.
template <int kPerWord>
__device__ __forceinline__ float byte_f(const uint32_t* w, int k) {
  const uint32_t bits = __byte_perm(w[k / kPerWord], kTwo23Bits, 0x7440 | (k % kPerWord));
  return __fsub_rn(__uint_as_float(bits), kTwo23);
}

// Four biased bytes (round_biased) packed into one word, in order.
__device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d) {
  const uint32_t lo = __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x0040);
  const uint32_t hi = __byte_perm(__float_as_uint(c), __float_as_uint(d), 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

// kVec bytes from p into words (kVec 8: one 8-byte load; 1: one byte).
template <int kVec>
__device__ __forceinline__ void load_run(const uint8_t* p, uint32_t* w) {
  if constexpr (kVec == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = __ldg(p);
  }
}

template <int kVec>
__device__ __forceinline__ void store_run(uint8_t* p, const float* o) {
  if constexpr (kVec == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack4(o[0], o[1], o[2], o[3]), pack4(o[4], o[5], o[6], o[7]));
  } else {
    *p = (uint8_t)__float_as_uint(o[0]);
  }
}

// ---------------------------------------------------------------------------
// K7. Replaces retinex_tpu/ops/clahe_luma.py::_apply_luma_kernel5
// (pallas_call in _apply_luma_stage5). K9 (kFused = true) replaces
// ::_apply_luma_kernel5_fused (pallas_call in _apply_luma_stage5_fused).
// Bound on the card: bytes and instructions about alike. K7 reads 3 B of
// RGB and 1 B of luma per pixel and writes 3 B; K9 drops the luma byte;
// their instructions a pixel, read from the SASS (chip_smoke.py), over the
// card's issue rate give a bound of the same size.
// Design: a block takes kSegRows rows of one half-cell band (so its two
// neighbour tile rows are fixed) across the frame's whole width, and stages
// those two rows of LUTs as floats, interleaved (2 * tiles_x * 256 * 4 B),
// and the 256 reciprocals in shared memory once for its kSegRows x W
// pixels. A thread takes kVec = 8
// neighbouring pixels of a row (one 8-byte load and store per plane; NHWC:
// 24 contiguous bytes, three 8-byte accesses), their x-weights and LUT
// offsets loaded once from the geometry table, and walks the block's rows
// (one y-weight load a row), loading the next row's run while it computes
// this one; indices are 32-bit within an image. A pixel then costs its luma
// (K9), two 8-byte LUT reads from shared memory, the blend, the gain's quotient
// (a reciprocal read from shared memory and three operations) and three
// scaled bytes, with no conversion instruction (the 2^23 bias above) and no
// clamp that cannot act. kVec = 1 takes any width and alignment.
// ---------------------------------------------------------------------------
template <bool kFused, bool kNhwc, int kVec>
__global__ void __launch_bounds__(kThreads)
    clahe_luma_apply_kernel(const uint8_t* __restrict__ rgb, const uint8_t* __restrict__ luma,
                            const uint8_t* __restrict__ luts, const int* __restrict__ geo,
                            uint8_t* __restrict__ out, int H, int W, int tiles_y, int tiles_x, int row0,
                            int cell_rows) {
  constexpr int kPerWord = kVec == 8 ? 4 : 1;
  constexpr int kRunWords = kVec / kPerWord;  // words of one plane's run
  // The two tile rows' LUTs interleaved, [tiles_x][256][2] (one 8-byte read
  // gives a pixel's two entries of one x-tile), then [256] reciprocals.
  extern __shared__ float slut[];
  // The H rows are a slab of cell_rows whole cell rows of a frame, the
  // first its cell row row0 (a whole frame: 0 and 2 * tiles_y): cy counts
  // the slab's cell rows, cy + row0 the frame's, which picks the two
  // neighbour tile rows; the geometry's y-weights are the slab's rows'.
  const int hh = H / cell_rows;
  const int cy = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * kSegRows, r1 = min(r0 + kSegRows, hh);
  int t0y, t1y;
  neighbor_tiles(cy + row0, tiles_y, &t0y, &t1y);

  const int n = tiles_x * kHist;
  float* srcp = slut + 2 * n;  // 1 / (v + 1) by byte v
  srcp[threadIdx.x] = __ldg(reinterpret_cast<const float*>(geo + 2 * W + H) + threadIdx.x);
  const uint32_t* tab0 = reinterpret_cast<const uint32_t*>(luts + ((size_t)b * tiles_y + t0y) * n);
  const uint32_t* tab1 = reinterpret_cast<const uint32_t*>(luts + ((size_t)b * tiles_y + t1y) * n);
  for (int i = threadIdx.x; i < n / 4; i += kThreads) {
    const uint32_t w0[1] = {__ldg(tab0 + i)}, w1[1] = {__ldg(tab1 + i)};
#pragma unroll
    for (int k = 0; k < 4; ++k) reinterpret_cast<float2*>(slut)[4 * i + k] = make_float2(byte_f<4>(w0, k), byte_f<4>(w1, k));
  }
  __syncthreads();

  const int ncg = W / kVec;  // pixel runs of a row
  const int used = min(ncg, kThreads), slices = kThreads / used;
  const int slice = threadIdx.x / used;
  if (slice >= slices) return;
  const int plane = H * W;
  const uint8_t* img = rgb + (size_t)b * 3 * plane;
  uint8_t* dst = out + (size_t)b * 3 * plane;
  const uint8_t* lum = kFused ? nullptr : luma + (size_t)b * plane;
  const float* xw = reinterpret_cast<const float*>(geo);
  const int* offs = geo + W;
  const float* yw = reinterpret_cast<const float*>(geo + 2 * W) + cy * hh;
  const char* lut = reinterpret_cast<const char*>(slut);

  // One row's run: the RGB words (planar: plane by plane; NHWC: the 3 kVec
  // bytes in order) and, for K7, the luma words.
  auto load = [&](int p, uint32_t* w, uint32_t* lw) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      load_run<kVec>(kNhwc ? img + 3 * p + c * kVec : img + c * plane + p, w + c * kRunWords);
    if constexpr (!kFused) load_run<kVec>(lum + p, lw);
  };

  for (int g = threadIdx.x % used; g < ncg; g += used) {
    const int x0 = g * kVec;
    float xa[kVec];
    int o0[kVec], o1[kVec];  // byte offsets of the two neighbour x-tiles' LUT pairs
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      xa[i] = __ldg(xw + x0 + i);
      const int o = __ldg(offs + x0 + i);
      o0[i] = 8 * (o & 0xFFFF), o1[i] = 8 * (o >> 16);
    }
    // The next row's run loads while this one is computed.
    uint32_t w[3 * kRunWords], lw[kRunWords];
    int iy = r0 + slice;
    if (iy < r1) load((cy * hh + iy) * W + x0, w, lw);
#pragma unroll 1
    for (; iy < r1; iy += slices) {
      const int p = (cy * hh + iy) * W + x0;  // pixel index of the run's first pixel
      uint32_t wn[3 * kRunWords], lwn[kRunWords];
      if (iy + slices < r1) load(p + slices * W, wn, lwn);
      const float ya = __ldg(yw + iy), ya1 = __fsub_rn(1.0f, ya);
      float o[3 * kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        // Byte k of the run: planar c * kVec + i, NHWC 3 i + c.
        const int kr = kNhwc ? 3 * i : i, step = kNhwc ? 1 : kVec;
        const float r = byte_f<kPerWord>(w, kr), g = byte_f<kPerWord>(w, kr + step);
        const float bl = byte_f<kPerWord>(w, kr + 2 * step);
        int v;
        float v1;  // the luma byte and the byte + 1
        if constexpr (kFused) {
          const float s = round_biased(fmaf(kLumaB, bl, fmaf(kLumaR, r, __fmul_rn(kLumaG, g))));
          v = (int)(__float_as_uint(s) & 0xFF);
          v1 = __fsub_rn(s, kTwo23 - 1.0f);
        } else {
          v = (int)__byte_perm(lw[i / kPerWord], 0, 0x4440 | (i % kPerWord));
          v1 = __fsub_rn(__uint_as_float(kTwo23Bits | v), kTwo23 - 1.0f);
        }
        const char* lv = lut + 8 * v;
        const float2 t0 = *reinterpret_cast<const float2*>(lv + o0[i]);  // (l00, l10)
        const float2 t1 = *reinterpret_cast<const float2*>(lv + o1[i]);  // (l01, l11)
        const float l00 = t0.x, l10 = t0.y, l01 = t1.x, l11 = t1.y;
        // The three fused multiply-adds of ops/clahe_fast.py::blend.
        const float xa1 = __fsub_rn(1.0f, xa[i]);
        const float top = fmaf(l01, xa[i], __fmul_rn(l00, xa1));
        const float bot = fmaf(l10, xa1, __fmul_rn(l11, xa[i]));
        const float e = round_biased(fmaf(top, ya1, __fmul_rn(bot, ya)));
        // gain = (y_eq + 1) / (y + 1), the IEEE quotient (see the top).
        const float num = __fsub_rn(e, kTwo23 - 1.0f), rcp = srcp[v];
        const float q0 = __fmul_rn(num, rcp);
        const float gain = fmaf(fmaf(-v1, q0, num), rcp, q0);
        const int ko = kNhwc ? 3 * i : i;
        o[ko] = round_biased(fminf(__fmul_rn(r, gain), 255.0f));
        o[ko + step] = round_biased(fminf(__fmul_rn(g, gain), 255.0f));
        o[ko + 2 * step] = round_biased(fminf(__fmul_rn(bl, gain), 255.0f));
      }
#pragma unroll
      for (int c = 0; c < 3; ++c)
        store_run<kVec>(kNhwc ? dst + 3 * p + c * kVec : dst + c * plane + p, o + c * kVec);
#pragma unroll
      for (int k = 0; k < 3 * kRunWords; ++k) w[k] = wn[k];
      if constexpr (!kFused) {
#pragma unroll
        for (int k = 0; k < kRunWords; ++k) lw[k] = lwn[k];
      }
    }
  }
}

template <bool kFused, bool kNhwc>
int launch_luma_apply(const void* rgb, const void* luma, const void* luts, const void* geo, void* out, int batch,
                      int H, int W, int tiles_y, int tiles_x, int row0, int cell_rows, void* stream) {
  if (cell_rows < 1 || row0 < 0 || row0 + cell_rows > 2 * tiles_y || H % cell_rows) return (int)cudaErrorInvalidValue;
  const int hh = H / cell_rows;
  if ((long long)3 * H * W >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const dim3 grid((hh + kSegRows - 1) / kSegRows, cell_rows, batch);
  const int smem = (2 * tiles_x + 1) * kHist * (int)sizeof(float);
  const bool wide = W % 8 == 0 && ((uintptr_t)rgb | (uintptr_t)out | (kFused ? 0 : (uintptr_t)luma)) % 8 == 0;
  auto kernel = wide ? clahe_luma_apply_kernel<kFused, kNhwc, 8> : clahe_luma_apply_kernel<kFused, kNhwc, 1>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>((const uint8_t*)rgb, (const uint8_t*)luma,
                                                          (const uint8_t*)luts, (const int*)geo, (uint8_t*)out, H,
                                                          W, tiles_y, tiles_x, row0, cell_rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// geo: the int32 [2 W + H + 256] blend geometry of luma_geometry (x-weights
// as f32 bits, LUT offsets t0x * 256 | t1x * 256 << 16, y-weights as f32
// bits, then 1 / d for d = 1..256 as f32 bits). The H rows are a slab of
// cell_rows whole cell rows of a frame, the first its cell row row0 (a
// whole frame: 0 and 2 * tiles_y); luts are the frame's, geo the slab's.
int clahe_luma_apply_u8(const void* rgb, const void* luma, const void* luts, const void* geo, void* out, int batch,
                        int H, int W, int tiles_y, int tiles_x, int row0, int cell_rows, void* stream) {
  return launch_luma_apply<false, false>(rgb, luma, luts, geo, out, batch, H, W, tiles_y, tiles_x, row0, cell_rows,
                                         stream);
}

int clahe_luma_apply_u8_nhwc(const void* rgb, const void* luma, const void* luts, const void* geo, void* out,
                             int batch, int H, int W, int tiles_y, int tiles_x, int row0, int cell_rows,
                             void* stream) {
  return launch_luma_apply<false, true>(rgb, luma, luts, geo, out, batch, H, W, tiles_y, tiles_x, row0, cell_rows,
                                        stream);
}

int clahe_luma_apply_u8_fused(const void* rgb, const void* luts, const void* geo, void* out, int batch, int H,
                              int W, int tiles_y, int tiles_x, void* stream) {
  return launch_luma_apply<true, false>(rgb, nullptr, luts, geo, out, batch, H, W, tiles_y, tiles_x, 0, 2 * tiles_y,
                                        stream);
}

}  // extern "C"
