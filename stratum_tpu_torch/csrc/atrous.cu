// The SVGF a-trous filter for Hopper (sm_90a): one launch computes one
// whole iteration of stratum_tpu_torch/render/denoise.py::atrous_filter.
//
// It replaces no TPU kernel: the JAX package's atrous_filter
// (stratum_tpu/render/denoise.py) is jnp, which XLA fuses. The torch loop
// it replaces issues ~750 ops an iteration (25 edge-clamped copies of a
// 9-channel image and ~25 elementwise ops around each tap, the 3x3
// variance prefilter, a cat and the divides), each a launch that moves
// tens of MB through device memory. The torch loop stays beside the kernel
// as its plain version; the wrapper takes it for CPU tensors only.
//
// Per pixel (one thread; 32 x 8 threads a CTA, so the taps of a warp read
// 32 neighbouring pixels of one row):
//   * the 3x3 Gaussian-prefiltered variance at the centre, giving the
//     luminance sigma, and the centre's Rec.709 luminance;
//   * the taps (dy, dx, kernel weight) of _filter_taps in that list order,
//     each an edge-clamped read img[clamp(y - dy*step), clamp(x - dx*step)]
//     with the luminance, normal and depth edge-stopping weights, summed
//     into the colour, variance and weight accumulators;
//   * colour acc / max(wsum, 1e-6), background pixels keeping the filter's
//     input colour, and variance acc_v / max(wsum^2, 1e-6) on every pixel.
// Every op is the torch loop's, in its order, rounded once: products and
// sums through __fmul_rn / __fadd_rn, which are never contracted into an
// FMA; expf, powf and sqrtf in full f32 (no fast-math), divisions IEEE.
// The dot products sum left to right, as the CPU's torch.sum over 3.
//
// Layout: the first iteration reads the caller's tensors (colour and normal
// [H, W, 3], variance and depth [H, W]) and writes, besides its output, the
// iteration-invariant guide (normal | depth with background at the 3.0e37
// sentinel, a float4 a pixel) and the depth gradient dz = max(|dz_x|,
// |dz_y|) + 1e-4, stored negated on background pixels. Each later
// iteration reads colour | variance as one float4 a pixel (the previous
// iteration's output, ping-ponged), the guide and dz: a tap is two 16-byte
// loads. A background pixel's colour is the filter's input colour after
// every iteration, so a later iteration keeps the colour it reads. The
// last iteration (and the history tap's) also writes colour [H, W, 3].
//
// What bounds it: per pixel an iteration needs colour, variance, normal and
// depth in (32 B) and colour | variance out (16 B), ~100 MB at 1920x1080,
// ~30 us at 3.35 TB/s (the guide and dz are this layout's own, not needed
// bytes); the 25 taps hit L1 / L2, not device memory. The taps' arithmetic
// bounds it instead: at 1920x1080 an iteration is 52 M taps, each at least
// five special-function ops (ex2 for each expf and for powf, rcp for each
// IEEE division: 16 a clock an SM, ~62 us) and 29 unfused f32 adds,
// multiplies and maxes (~46 us). chip_smoke.py (phase 16) times each
// launch beside the larger of the two bounds.

#include <cuda_runtime.h>
#include <stdlib.h>

namespace {

constexpr int kMaxTaps = 25;  // the most _filter_taps gives (atrous, box5)
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr float kFar = 3.0e37f;  // background depth, finite so no inf - inf

struct Taps {
  int n;
  int dy[kMaxTaps];
  int dx[kMaxTaps];
  float kw[kMaxTaps];     // kernel weight
  float reach[kMaxTaps];  // (float)(|dy| + |dx| + 1e-3), as torch casts the scalar
};

struct Inputs {
  // the first iteration: the filter's inputs as the caller holds them
  const float* color;     // [H, W, 3]
  const float* variance;  // [H, W]
  const float* normal;    // [H, W, 3]
  const float* depth;     // [H, W], inf on background
  // later iterations
  const float4* cv;     // [H, W] colour | variance of the previous iteration
  const float4* guide;  // [H, W] normal | depth at the sentinel
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// torch.clamp(v, min=lo) and torch.maximum: NaN propagates
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// smath.luminance: sum(rgb * [0.2126, 0.7152, 0.0722]) left to right
__device__ __forceinline__ float luminance(float r, float g, float b) {
  return add(add(mul(r, 0.2126f), mul(g, 0.7152f)), mul(b, 0.0722f));
}

__device__ __forceinline__ float depth_at(const Inputs& in, int p) {
  const float z = __ldg(in.depth + p);
  return isfinite(z) ? z : kFar;
}

template <bool kFirst>
__device__ __forceinline__ void load_pixel(const Inputs& in, int p, float4& cv, float4& g) {
  if (kFirst) {
    const float* c = in.color + 3 * (size_t)p;
    const float* n = in.normal + 3 * (size_t)p;
    cv = make_float4(__ldg(c), __ldg(c + 1), __ldg(c + 2), __ldg(in.variance + p));
    g = make_float4(__ldg(n), __ldg(n + 1), __ldg(n + 2), depth_at(in, p));
  } else {
    cv = __ldg(in.cv + p);
    g = __ldg(in.guide + p);
  }
}

template <bool kFirst>
__device__ __forceinline__ float load_variance(const Inputs& in, int p) {
  return kFirst ? __ldg(in.variance + p) : __ldg(reinterpret_cast<const float*>(in.cv + p) + 3);
}

template <bool kFirst>
__global__ void __launch_bounds__(kBlockX * kBlockY)
atrous_kernel(Inputs in, float4* guide_out, float* dz_buf, float4* cv_out, float* color_out,
              int h, int w, int step, Taps taps, float sigma_luminance, float sigma_normal,
              float sigma_depth) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const int p = y * w + x;
  float4 c, g;
  load_pixel<kFirst>(in, p, c, g);

  float dz;
  bool fg;
  if (kFirst) {
    fg = isfinite(__ldg(in.depth + p));
    const float zl = depth_at(in, y * w + max(x - 1, 0));  // _shift(depth, 0, 1)
    const float zu = depth_at(in, max(y - 1, 0) * w + x);  // _shift(depth, 1, 0)
    dz = add(maximum(fabsf(sub(zl, g.w)), fabsf(sub(zu, g.w))), 1e-4f);
    guide_out[p] = g;
    dz_buf[p] = fg ? dz : -dz;  // dz >= 1e-4, so its sign carries the flag
  } else {
    const float s = dz_buf[p];
    fg = s > 0.0f;
    dz = fabsf(s);
  }

  // 3x3 Gaussian-prefiltered variance -> the luminance sigma
  float gvar = 0.0f;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    const int row = clampi(y - dy, 0, h - 1) * w;
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const float k = (dy ? 1.0f : 2.0f) * (dx ? 1.0f : 2.0f);
      gvar = add(gvar, mul(k, load_variance<kFirst>(in, row + clampi(x - dx, 0, w - 1))));
    }
  }
  const float sigma_l = add(mul(sigma_luminance, sqrtf(div(gvar, 16.0f))), 1e-6f);
  const float lum_c = luminance(c.x, c.y, c.z);

  float ar = 0.0f, ag = 0.0f, ab = 0.0f, av = 0.0f, wsum = 0.0f;
  // unrolled so every tap's constants are static kernel-parameter reads
#pragma unroll
  for (int t = 0; t < kMaxTaps; ++t) {
    if (t >= taps.n) break;
    const int yy = clampi(y - taps.dy[t] * step, 0, h - 1);
    const int xx = clampi(x - taps.dx[t] * step, 0, w - 1);
    float4 nc, ng;
    load_pixel<kFirst>(in, yy * w + xx, nc, ng);
    const float w_l = expf(div(-fabsf(sub(luminance(nc.x, nc.y, nc.z), lum_c)), sigma_l));
    const float cos_n = add(add(mul(ng.x, g.x), mul(ng.y, g.y)), mul(ng.z, g.z));
    const float w_n = powf(clamp_min(cos_n, 0.0f), sigma_normal);
    const float denom =
        add(mul(mul(mul(sigma_depth, dz), taps.reach[t]), static_cast<float>(step)), 1e-6f);
    const float w_z = expf(div(-fabsf(sub(ng.w, g.w)), denom));
    const float wgt = mul(mul(mul(taps.kw[t], w_l), w_n), w_z);
    ar = add(ar, mul(nc.x, wgt));
    ag = add(ag, mul(nc.y, wgt));
    ab = add(ab, mul(nc.z, wgt));
    av = add(av, mul(mul(nc.w, wgt), wgt));
    wsum = add(wsum, wgt);
  }

  const float norm = clamp_min(wsum, 1e-6f);
  const float r = fg ? div(ar, norm) : c.x;
  const float gr = fg ? div(ag, norm) : c.y;
  const float b = fg ? div(ab, norm) : c.z;
  const float var = div(av, clamp_min(mul(wsum, wsum), 1e-6f));
  if (cv_out) cv_out[p] = make_float4(r, gr, b, var);
  if (color_out) {
    float* o = color_out + 3 * (size_t)p;
    o[0] = r;
    o[1] = gr;
    o[2] = b;
  }
}

}  // namespace

// One a-trous iteration on `stream`. The first (first = 1) reads color,
// variance, normal and depth and writes guide and dz; a later one reads
// cv_in, guide and dz. cv_out (colour | variance, float4 a pixel) and
// color_out ([H, W, 3]) are written where not null. The taps are host
// arrays of num_taps entries (at most 25). Returns the launch's error.
extern "C" cudaError_t atrous_iteration(const float* color, const float* variance,
                                        const float* normal, const float* depth,
                                        const float* cv_in, float* guide, float* dz,
                                        float* cv_out, float* color_out, int h, int w, int step,
                                        int first, int num_taps, const int* tap_dy,
                                        const int* tap_dx, const float* tap_kw,
                                        float sigma_luminance, float sigma_normal,
                                        float sigma_depth, void* stream) {
  if (num_taps < 1 || num_taps > kMaxTaps || h < 0 || w < 0 || step < 1 || !guide || !dz)
    return cudaErrorInvalidValue;
  if (first ? !(color && variance && normal && depth) : !cv_in) return cudaErrorInvalidValue;
  if ((long long)h * w >= (1ll << 31) || (h + kBlockY - 1) / kBlockY > 65535)
    return cudaErrorInvalidValue;
  Taps taps = {};
  taps.n = num_taps;
  for (int i = 0; i < num_taps; ++i) {
    taps.dy[i] = tap_dy[i];
    taps.dx[i] = tap_dx[i];
    taps.kw[i] = tap_kw[i];
    taps.reach[i] = static_cast<float>(static_cast<double>(abs(tap_dy[i]) + abs(tap_dx[i])) + 1e-3);
  }
  if (h == 0 || w == 0) return cudaSuccess;
  const Inputs in = {color, variance, normal, depth, reinterpret_cast<const float4*>(cv_in),
                     reinterpret_cast<const float4*>(guide)};
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* g4 = reinterpret_cast<float4*>(guide);
  float4* o4 = reinterpret_cast<float4*>(cv_out);
  if (first)
    atrous_kernel<true><<<grid, block, 0, s>>>(in, g4, dz, o4, color_out, h, w, step, taps,
                                               sigma_luminance, sigma_normal, sigma_depth);
  else
    atrous_kernel<false><<<grid, block, 0, s>>>(in, g4, dz, o4, color_out, h, w, step, taps,
                                                sigma_luminance, sigma_normal, sigma_depth);
  return cudaGetLastError();
}

// Registers, local (spill) bytes and resident CTAs per SM of the first
// (first = 1) or a later iteration's kernel; then the CTA's threads.
extern "C" cudaError_t atrous_info(int first, int* out) {
  cudaFuncAttributes attr;
  int blocks = 0;
  const void* fn = first ? reinterpret_cast<const void*>(atrous_kernel<true>)
                         : reinterpret_cast<const void*>(atrous_kernel<false>);
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kBlockX * kBlockY, 0);
  if (e != cudaSuccess) return e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = kBlockX * kBlockY;
  return cudaSuccess;
}
