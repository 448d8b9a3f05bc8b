// The Disney principled BSDF for Hopper (sm_90a): one launch computes
// stratum_tpu_torch/render/disney.py::disney_eval (the full mixture's f,
// pdf and reverse pdf at a given wi) or disney_sample (the lobe pick, the
// direction of the picked lobe and the full mixture's eval there) for every
// lane of a wave.
//
// It replaces no TPU kernel: the JAX package's disney.py is jnp, which XLA
// fuses. The torch body it replaces issues ~840 ops an eval and ~1,060 a
// sample (the microfacet terms of every lobe, each a launch over the whole
// wave). That body stays beside the kernel as its plain version; the
// wrapper takes it for CPU tensors only.
//
// Bit for bit with the plain body on the card. Each torch op of the plain
// body is one op here, in the same order, rounded once:
//   * products, sums and differences through __fmul_rn / __fadd_rn /
//     __fsub_rn, which are never contracted into an FMA (torch's add and
//     sub kernels compute a + alpha * b, which for alpha = +-1 is the same
//     single rounding);
//   * divisions IEEE (__fdiv_rn); `s / t` with a Python scalar s is torch's
//     t.reciprocal() * s (rdiv); square roots __fsqrt_rn; torch.rsqrt is
//     rsqrtf, torch.sin / cos / log / pow are sinf / cosf / logf / powf,
//     the functions torch's CUDA kernels call, built with the same default
//     flags (no fast-math, no flush to zero);
//   * a Python float constant is the f32 that torch casts it to (F(x));
//   * torch.clamp propagates NaN and then takes fmaxf / fminf; torch.sign
//     is (0 < x) - (x < 0), so sign(NaN) = 0; torch.where selects;
//   * torch.sum(..., dim=-1) over 3 components is the card's reduction
//     kernel: two threads an output, the first adding components 0 and 2,
//     the second component 1, each from a +0 identity, then the two
//     combined: (x0 + x2) + x1, a zero result +0 (sum3).
//     tests/test_torch_cuda.py establishes that order on the card.
// Every lobe is computed on every lane, dead lanes included, as the plain
// body does: a lobe of weight 0 still adds 0 * f, which is NaN where f is
// inf.
//
// Inputs by pointer and strides (element strides between lanes and between
// a vector's components): the material columns are strided views of the
// [N, 88] slot payload, eta a contiguous [N]; wo, wi and u may be views.
// Outputs are contiguous: f [N, 3], pdf and pdf_rev [N]; a sample's wi
// [N, 3] and eta [N] (the relative IOR on the transmitted lanes, else 0).
//
// What bounds it: a lane reads 11 material floats and two 3-vectors (68 B)
// and writes 20 (eval) or 36 (sample) bytes: 0.055 / 0.064 ms at 2,073,600
// lanes and 3.35 TB/s. The arithmetic is a few hundred unfused f32 ops and
// ~60 IEEE divisions, square roots and special functions a lane, each
// division and square root a multi-instruction sequence: on an H100 a
// launch at that wave takes 0.15-0.17 ms (eval) and 0.22-0.24 ms (sample),
// 2.8-3.7x the bytes. chip_smoke.py (phase 18) times each launch beside
// the bytes bound. One thread a lane, 128 a CTA; the registers are allowed
// up to 128 a thread (4 CTAs an SM), so that neither kernel spills.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;  // CTAs an SM the registers must allow: up to 128 a thread

// a Python float constant as torch casts it to f32
#define F(x) static_cast<float>(x)
constexpr double kPi = 3.141592653589793;  // np.pi
constexpr double kInvPi = 1.0 / kPi;       // smath.INV_PI
constexpr double kTwoPi = 2.0 * kPi;       // smath.TWO_PI

enum Field {
  kBaseColor, kMetallic, kRoughness, kAnisotropic, kSubsurface, kClearcoat,
  kClearcoatGloss, kTransmission, kEta, kWo, kArg, kFields  // kArg: wi (eval) or u (sample)
};

struct Lanes {
  const float* ptr[kFields];
  long long lane[kFields];  // element stride from one lane to the next
  long long comp[kFields];  // element stride between a vector's components
};

struct V3 {
  float x, y, z;
};

struct Mat {
  float bc[3], metallic, roughness, anisotropic, subsurface, clearcoat, gloss, transmission, eta;
};

struct Eval {
  float f[3], pdf, rev;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sqrt_(float a) { return __fsqrt_rn(a); }
// s / t with a Python scalar s: torch's t.reciprocal() * s
__device__ __forceinline__ float rdiv(float s, float t) { return mul(div(1.0f, t), s); }

// torch.clamp: NaN propagates
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp01(float v) {
  return v != v ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}
__device__ __forceinline__ float sgn(float a) {
  return static_cast<float>((0.0f < a) - (a < 0.0f));
}

// smath.safe_div (eps 1e-20), safe_sqrt, pow5, lerp
__device__ __forceinline__ float safe_div(float a, float b) {
  return fabsf(b) > F(1e-20) ? div(a, b) : 0.0f;
}
__device__ __forceinline__ float safe_sqrt(float x) { return sqrt_(clamp_min(x, 0.0f)); }
__device__ __forceinline__ float pow5(float x) {
  const float x2 = mul(x, x);
  return mul(mul(x2, x2), x);
}
__device__ __forceinline__ float lerp(float a, float b, float t) { return add(a, mul(sub(b, a), t)); }

// torch.sum over the last axis of 3 on the card (see the head comment)
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return add(add(add(x0, x2), x1), 0.0f);
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return sum3(mul(a.x, b.x), mul(a.y, b.y), mul(a.z, b.z));
}
__device__ __forceinline__ V3 scale(V3 v, float s) { return {mul(v.x, s), mul(v.y, s), mul(v.z, s)}; }
__device__ __forceinline__ V3 normalize(V3 v) {
  return scale(v, rsqrtf(clamp_min(dot(v, v), F(1e-20))));
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {sub(mul(a.y, b.z), mul(a.z, b.y)), sub(mul(a.z, b.x), mul(a.x, b.z)),
          sub(mul(a.x, b.y), mul(a.y, b.x))};
}
__device__ __forceinline__ V3 abs3(V3 v) { return {fabsf(v.x), fabsf(v.y), fabsf(v.z)}; }
__device__ __forceinline__ V3 select(bool c, V3 a, V3 b) { return c ? a : b; }
__device__ __forceinline__ float cos_pdf(float c) { return mul(clamp_min(c, 0.0f), F(kInvPi)); }

// ---- core/microfacet.py ---------------------------------------------------

__device__ __forceinline__ float fresnel_dielectric(float cos_theta_i, float eta) {
  const float ci = clamp01(fabsf(cos_theta_i));
  const float sin2_t = div(sub(1.0f, mul(ci, ci)), clamp_min(mul(eta, eta), F(1e-12)));
  const bool tir = sin2_t >= 1.0f;
  const float ct = safe_sqrt(sub(1.0f, sin2_t));
  const float r_s = div(sub(ci, mul(eta, ct)), clamp_min(add(ci, mul(eta, ct)), F(1e-12)));
  const float r_p = div(sub(mul(eta, ci), ct), clamp_min(add(mul(eta, ci), ct), F(1e-12)));
  const float f = mul(add(mul(r_s, r_s), mul(r_p, r_p)), 0.5f);
  return tir ? 1.0f : clamp01(f);
}

__device__ __forceinline__ void ggx_alpha(float roughness, float anisotropic, float& ax,
                                          float& ay) {
  const float aspect = sqrt_(sub(1.0f, mul(anisotropic, F(0.9))));
  const float r2 = mul(roughness, roughness);
  ax = clamp_min(div(r2, aspect), F(1e-4));
  ay = clamp_min(mul(r2, aspect), F(1e-4));
}

__device__ __forceinline__ float gtr2_ndf(V3 h, float ax, float ay) {
  const float d = add(add(div(mul(h.x, h.x), mul(ax, ax)), div(mul(h.y, h.y), mul(ay, ay))),
                      mul(h.z, h.z));
  return rdiv(1.0f, clamp_min(mul(mul(mul(mul(ax, F(kPi)), ay), d), d), F(1e-20)));
}

__device__ __forceinline__ float smith_g1(V3 w, float ax, float ay) {
  const float a = mul(w.x, ax);
  const float b = mul(w.y, ay);
  const float a2 = add(mul(a, a), mul(b, b));
  const float lambda =
      mul(sub(sqrt_(add(div(a2, clamp_min(mul(w.z, w.z), F(1e-12))), 1.0f)), 1.0f), 0.5f);
  return rdiv(1.0f, add(lambda, 1.0f));
}

__device__ __forceinline__ float vndf_pdf(V3 w, V3 h, float ax, float ay) {
  return safe_div(mul(mul(smith_g1(w, ax, ay), gtr2_ndf(h, ax, ay)), clamp_min(dot(w, h), 0.0f)),
                  fabsf(w.z));
}

__device__ __forceinline__ float gtr1_ndf(float hz, float alpha) {
  const float a2 = mul(alpha, alpha);
  const float denom = mul(mul(logf(clamp_min(a2, F(1e-12))), F(kPi)),
                          add(mul(mul(sub(a2, 1.0f), hz), hz), 1.0f));
  return safe_div(sub(a2, 1.0f), denom);
}

__device__ __forceinline__ V3 sample_vndf(V3 wo, float ax, float ay, float u1, float u2) {
  const V3 v = normalize({mul(ax, wo.x), mul(ay, wo.y), wo.z});
  const float lensq = add(mul(v.x, v.x), mul(v.y, v.y));
  const float inv_len = rdiv(1.0f, sqrt_(clamp_min(lensq, F(1e-20))));
  const V3 t1 = select(lensq > F(1e-12), V3{mul(-v.y, inv_len), mul(v.x, inv_len), 0.0f},
                       V3{1.0f, 0.0f, 0.0f});
  const V3 t2 = cross(v, t1);
  const float r = sqrt_(u1);
  const float phi = mul(u2, F(kTwoPi));
  const float p1 = mul(r, cosf(phi));
  float p2 = mul(r, sinf(phi));
  const float s = mul(add(v.z, 1.0f), 0.5f);
  p2 = add(mul(sub(1.0f, s), safe_sqrt(sub(1.0f, mul(p1, p1)))), mul(s, p2));
  const float p3 = safe_sqrt(sub(sub(1.0f, mul(p1, p1)), mul(p2, p2)));
  const V3 nh = {add(add(mul(p1, t1.x), mul(p2, t2.x)), mul(p3, v.x)),
                 add(add(mul(p1, t1.y), mul(p2, t2.y)), mul(p3, v.y)),
                 add(add(mul(p1, t1.z), mul(p2, t2.z)), mul(p3, v.z))};
  return normalize({mul(ax, nh.x), mul(ay, nh.y), clamp_min(nh.z, 0.0f)});
}

__device__ __forceinline__ V3 sample_gtr1(float alpha, float u1, float u2) {
  const float a2 = mul(alpha, alpha);
  const float cos2 = div(sub(1.0f, powf(a2, sub(1.0f, u1))), clamp_min(sub(1.0f, a2), F(1e-12)));
  const float cos_t = safe_sqrt(cos2);
  const float sin_t = safe_sqrt(sub(1.0f, cos2));
  const float phi = mul(u2, F(kTwoPi));
  return {mul(sin_t, cosf(phi)), mul(sin_t, sinf(phi)), cos_t};
}

__device__ __forceinline__ V3 reflect(V3 w, V3 n) {
  const float d2 = mul(dot(w, n), 2.0f);
  return {sub(mul(d2, n.x), w.x), sub(mul(d2, n.y), w.y), sub(mul(d2, n.z), w.z)};
}

__device__ __forceinline__ V3 refract(V3 w, V3 n, float eta, bool& valid) {
  const float cos_i = dot(w, n);
  const float sin2_t = div(sub(1.0f, mul(cos_i, cos_i)), clamp_min(mul(eta, eta), F(1e-20)));
  valid = sin2_t < 1.0f;
  const float cos_t = safe_sqrt(sub(1.0f, sin2_t));
  const float k = sub(div(cos_i, eta), cos_t);
  return normalize({add(div(-w.x, eta), mul(k, n.x)), add(div(-w.y, eta), mul(k, n.y)),
                    add(div(-w.z, eta), mul(k, n.z))});
}

// ---- render/disney.py: the lobes --------------------------------------------

__device__ __forceinline__ float cc_alpha(const Mat& m) {  // lerp(0.1, 0.001, gloss)
  return add(mul(m.gloss, F(0.001 - 0.1)), F(0.1));
}

__device__ __forceinline__ Eval diffuse_eval(const Mat& m, V3 wo, V3 wi, V3 h) {
  const float ci = fabsf(wi.z);
  const float co = fabsf(wo.z);
  const float hdotwi = dot(h, wi);
  const float fd90 = add(mul(mul(mul(m.roughness, 2.0f), hdotwi), hdotwi), 0.5f);
  const float pi5 = pow5(sub(1.0f, ci));
  const float po5 = pow5(sub(1.0f, co));
  const float fd = mul(add(mul(sub(fd90, 1.0f), pi5), 1.0f), add(mul(sub(fd90, 1.0f), po5), 1.0f));
  const float fss90 = mul(mul(m.roughness, hdotwi), hdotwi);
  const float fss_in = add(mul(sub(fss90, 1.0f), pi5), 1.0f);
  const float fss_out = add(mul(sub(fss90, 1.0f), po5), 1.0f);
  const float ss = mul(
      add(mul(mul(fss_in, fss_out), sub(safe_div(1.0f, add(ci, co)), 0.5f)), 0.5f), 1.25f);
  const bool refl = wi.z > 0.0f && wo.z > 0.0f;
  const float k = mul(lerp(fd, ss, m.subsurface), F(kInvPi));
  Eval e;
  for (int c = 0; c < 3; ++c) e.f[c] = refl ? mul(m.bc[c], k) : 0.0f;
  e.pdf = refl ? cos_pdf(wi.z) : 0.0f;
  e.rev = refl ? cos_pdf(wo.z) : 0.0f;
  return e;
}

__device__ __forceinline__ Eval metal_eval(const Mat& m, V3 wo, V3 wi, V3 h, float ax, float ay) {
  const bool refl = wi.z > 0.0f && wo.z > 0.0f;
  const float w = pow5(sub(1.0f, clamp01(dot(h, wi))));  // schlick_fresnel(base_color, .)
  const float D = gtr2_ndf(h, ax, ay);
  const float G = mul(smith_g1(wi, ax, ay), smith_g1(wo, ax, ay));
  const float denom = mul(mul(fabsf(wi.z), 4.0f), fabsf(wo.z));
  const float s = safe_div(mul(D, G), denom);
  Eval e;
  for (int c = 0; c < 3; ++c) {
    const float Fc = add(m.bc[c], mul(sub(1.0f, m.bc[c]), w));
    e.f[c] = refl ? mul(Fc, s) : 0.0f;
  }
  e.pdf = refl ? safe_div(vndf_pdf(wo, h, ax, ay), mul(fabsf(dot(wo, h)), 4.0f)) : 0.0f;
  e.rev = refl ? safe_div(vndf_pdf(wi, h, ax, ay), mul(fabsf(dot(wi, h)), 4.0f)) : 0.0f;
  return e;
}

__device__ __forceinline__ Eval glass_eval(const Mat& m, V3 wo, V3 wi, float ax, float ay) {
  const float eta = m.eta;
  const bool is_refl = wi.z > 0.0f;
  const V3 h_r = normalize({add(wi.x, wo.x), add(wi.y, wo.y), add(wi.z, wo.z)});
  const V3 h_t =
      normalize({add(wo.x, mul(wi.x, eta)), add(wo.y, mul(wi.y, eta)), add(wo.z, mul(wi.z, eta))});
  V3 h = select(is_refl, h_r, h_t);
  h = scale(h, sgn(h.z));
  const float hdwo = dot(h, wo);
  const float hdwi = dot(h, wi);
  const float fr = fresnel_dielectric(hdwo, eta);
  const float D = gtr2_ndf(h, ax, ay);
  const float G = mul(smith_g1(wi, ax, ay), smith_g1(wo, ax, ay));
  const float ci = fabsf(wi.z);
  const float co = fabsf(wo.z);
  const float vo = vndf_pdf(wo, h, ax, ay);
  const float s_refl = safe_div(mul(mul(fr, D), G), mul(mul(ci, 4.0f), co));
  const float pdf_refl = mul(safe_div(vo, mul(fabsf(hdwo), 4.0f)), fr);
  const float pdf_refl_rev = mul(safe_div(vndf_pdf(wi, h, ax, ay), mul(fabsf(hdwi), 4.0f)),
                                 fresnel_dielectric(fabsf(hdwi), rdiv(1.0f, eta)));
  const float denom_t = add(hdwo, mul(eta, hdwi));
  const float s_trans = safe_div(mul(mul(mul(sub(1.0f, fr), D), G), fabsf(mul(hdwi, hdwo))),
                                 mul(mul(mul(ci, co), denom_t), denom_t));
  const float pdf_trans = mul(
      safe_div(mul(mul(mul(vo, fabsf(hdwi)), eta), eta), mul(denom_t, denom_t)), sub(1.0f, fr));
  const float inv_eta = rdiv(1.0f, clamp_min(eta, F(1e-12)));
  const float denom_rev = add(hdwi, mul(inv_eta, hdwo));
  const float F_rev = fresnel_dielectric(fabsf(hdwi), inv_eta);
  const float pdf_trans_rev =
      mul(safe_div(mul(mul(mul(vndf_pdf(abs3(wi), h, ax, ay), fabsf(hdwo)), inv_eta), inv_eta),
                   mul(denom_rev, denom_rev)),
          sub(1.0f, F_rev));
  const bool valid = fabsf(denom_t) > F(1e-9);
  Eval e;
  for (int c = 0; c < 3; ++c) {
    const float f = is_refl ? mul(m.bc[c], s_refl) : mul(sqrt_(clamp_min(m.bc[c], 0.0f)), s_trans);
    e.f[c] = valid ? f : 0.0f;
  }
  e.pdf = valid ? (is_refl ? pdf_refl : pdf_trans) : 0.0f;
  e.rev = valid ? (is_refl ? pdf_refl_rev : pdf_trans_rev) : 0.0f;
  return e;
}

__device__ __forceinline__ Eval clearcoat_eval(const Mat& m, V3 wo, V3 wi, V3 h) {
  const bool refl = wi.z > 0.0f && wo.z > 0.0f;
  const float D = gtr1_ndf(h.z, cc_alpha(m));
  const float w = pow5(sub(1.0f, clamp01(dot(h, wi))));
  const float fr = add(mul(w, F(1.0 - 0.04)), F(0.04));  // schlick_fresnel(0.04, .)
  const float q = F(0.25);
  const float G = mul(smith_g1(wi, q, q), smith_g1(wo, q, q));
  const float denom = mul(mul(fabsf(wi.z), 4.0f), fabsf(wo.z));
  const float fval = safe_div(mul(mul(fr, D), G), denom);
  Eval e;
  for (int c = 0; c < 3; ++c) e.f[c] = refl ? fval : 0.0f;
  e.pdf = refl ? safe_div(mul(D, fabsf(h.z)), mul(fabsf(dot(h, wi)), 4.0f)) : 0.0f;
  e.rev = e.pdf;
  return e;
}

struct Weights {
  float wd, wm, wg, wc, pd, pm, pg, pc;
};

__device__ __forceinline__ Weights lobe_weights(const Mat& m) {
  Weights w;
  w.wd = mul(sub(1.0f, m.metallic), sub(1.0f, m.transmission));
  w.wm = m.metallic;
  w.wg = mul(sub(1.0f, m.metallic), m.transmission);
  w.wc = mul(m.clearcoat, 0.25f);
  const float total = clamp_min(add(add(add(w.wd, w.wm), w.wg), w.wc), F(1e-12));
  w.pd = div(w.wd, total);
  w.pm = div(w.wm, total);
  w.pg = div(w.wg, total);
  w.pc = div(w.wc, total);
  return w;
}

__device__ __forceinline__ Eval disney_eval(const Mat& m, V3 wo, V3 wi) {
  float ax, ay;
  ggx_alpha(m.roughness, m.anisotropic, ax, ay);
  V3 h = normalize({add(wi.x, wo.x), add(wi.y, wo.y), add(wi.z, wo.z)});
  h = scale(h, sgn(h.z));
  const Weights w = lobe_weights(m);
  const Eval d = diffuse_eval(m, wo, wi, h);
  const Eval me = metal_eval(m, wo, wi, h, ax, ay);
  const Eval g = glass_eval(m, wo, wi, ax, ay);
  const Eval c = clearcoat_eval(m, wo, wi, h);
  Eval e;
  for (int k = 0; k < 3; ++k)
    e.f[k] = add(add(add(mul(w.wd, d.f[k]), mul(w.wm, me.f[k])), mul(w.wg, g.f[k])),
                 mul(w.wc, c.f[k]));
  e.pdf = add(add(add(mul(w.pd, d.pdf), mul(w.pm, me.pdf)), mul(w.pg, g.pdf)), mul(w.pc, c.pdf));
  e.rev = add(add(add(mul(w.pd, d.rev), mul(w.pm, me.rev)), mul(w.pg, g.rev)), mul(w.pc, c.rev));
  return e;
}

// ---- the kernels --------------------------------------------------------------

__device__ __forceinline__ float load(const Lanes& in, int f, long long i, int c = 0) {
  return __ldg(in.ptr[f] + i * in.lane[f] + c * in.comp[f]);
}

__device__ __forceinline__ V3 load3(const Lanes& in, int f, long long i) {
  return {load(in, f, i, 0), load(in, f, i, 1), load(in, f, i, 2)};
}

__device__ __forceinline__ Mat load_mat(const Lanes& in, long long i) {
  Mat m;
  for (int c = 0; c < 3; ++c) m.bc[c] = load(in, kBaseColor, i, c);
  m.metallic = load(in, kMetallic, i);
  m.roughness = load(in, kRoughness, i);
  m.anisotropic = load(in, kAnisotropic, i);
  m.subsurface = load(in, kSubsurface, i);
  m.clearcoat = load(in, kClearcoat, i);
  m.gloss = load(in, kClearcoatGloss, i);
  m.transmission = load(in, kTransmission, i);
  m.eta = load(in, kEta, i);
  return m;
}

__device__ __forceinline__ void store(const Eval& e, long long i, float* f, float* pdf, float* rev) {
  for (int c = 0; c < 3; ++c) f[3 * i + c] = e.f[c];
  pdf[i] = e.pdf;
  rev[i] = e.rev;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
disney_eval_kernel(Lanes in, long long n, float* f, float* pdf, float* rev) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n) return;
  store(disney_eval(load_mat(in, i), load3(in, kWo, i), load3(in, kArg, i)), i, f, pdf, rev);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
disney_sample_kernel(Lanes in, long long n, float* wi_out, float* f, float* pdf, float* rev,
                     float* eta_out) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n) return;
  const Mat m = load_mat(in, i);
  const V3 wo = load3(in, kWo, i);
  const float u1 = load(in, kArg, i, 0);
  const float u2 = load(in, kArg, i, 1);
  const float usel = load(in, kArg, i, 2);
  float ax, ay;
  ggx_alpha(m.roughness, m.anisotropic, ax, ay);
  const Weights w = lobe_weights(m);
  const float phi = mul(u2, F(kTwoPi));  // sample_cos_hemisphere
  const float r = sqrt_(u1);
  const V3 wi_diffuse = {mul(r, cosf(phi)), mul(r, sinf(phi)), safe_sqrt(sub(1.0f, u1))};
  const V3 h_vndf = sample_vndf(wo, ax, ay, u1, u2);
  const V3 wi_metal = reflect(wo, h_vndf);
  const float fr = fresnel_dielectric(dot(h_vndf, wo), m.eta);
  bool can_refract;
  const V3 wt = refract(wo, h_vndf, m.eta, can_refract);
  const float u_glass = clamp01(safe_div(sub(usel, add(w.pd, w.pm)), clamp_min(w.pg, F(1e-12))));
  const bool glass_reflects = (u_glass < fr) || !can_refract;
  const V3 wi_glass = select(glass_reflects, wi_metal, wt);
  const V3 wi_clear = reflect(wo, sample_gtr1(cc_alpha(m), u1, u2));
  const float c_d = w.pd;
  const float c_m = add(w.pd, w.pm);
  const float c_g = add(add(w.pd, w.pm), w.pg);
  const V3 wi = normalize(
      select(usel < c_d, wi_diffuse,
             select(usel < c_m, wi_metal, select(usel < c_g, wi_glass, wi_clear))));
  store(disney_eval(m, wo, wi), i, f, pdf, rev);
  wi_out[3 * i] = wi.x;
  wi_out[3 * i + 1] = wi.y;
  wi_out[3 * i + 2] = wi.z;
  const bool took_trans = usel >= c_m && usel < c_g && !glass_reflects;
  eta_out[i] = took_trans ? m.eta : 0.0f;
}

cudaError_t fill(Lanes& in, const float* const* ptr, const long long* lane, const long long* comp) {
  for (int k = 0; k < kFields; ++k) {
    if (!ptr[k]) return cudaErrorInvalidValue;
    in.ptr[k] = ptr[k];
    in.lane[k] = lane[k];
    in.comp[k] = comp[k];
  }
  return cudaSuccess;
}

}  // namespace

// The full mixture's eval for n lanes on `stream`: ptr / lane / comp give
// each input (the Field order: base_color, metallic, roughness,
// anisotropic, subsurface, clearcoat, clearcoat_gloss, transmission, eta,
// wo, wi) as a base pointer and element strides between lanes and between
// components; f [n, 3], pdf and pdf_rev [n] are contiguous. Returns the
// launch's error.
extern "C" cudaError_t disney_eval(const float* const* ptr, const long long* lane,
                                   const long long* comp, long long n, float* f, float* pdf,
                                   float* pdf_rev, void* stream) {
  Lanes in;
  if (n < 0 || !f || !pdf || !pdf_rev || fill(in, ptr, lane, comp) != cudaSuccess)
    return cudaErrorInvalidValue;
  if ((n + kThreads - 1) / kThreads >= (1ll << 31)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  disney_eval_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(in, n, f, pdf,
                                                                               pdf_rev);
  return cudaGetLastError();
}

// The sample for n lanes: the inputs as disney_eval's with u [n, 3] in
// wi's place; writes wi [n, 3], f [n, 3], pdf, pdf_rev and eta [n].
extern "C" cudaError_t disney_sample(const float* const* ptr, const long long* lane,
                                     const long long* comp, long long n, float* wi, float* f,
                                     float* pdf, float* pdf_rev, float* eta, void* stream) {
  Lanes in;
  if (n < 0 || !wi || !f || !pdf || !pdf_rev || !eta ||
      fill(in, ptr, lane, comp) != cudaSuccess)
    return cudaErrorInvalidValue;
  if ((n + kThreads - 1) / kThreads >= (1ll << 31)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  disney_sample_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, n, wi, f, pdf, pdf_rev, eta);
  return cudaGetLastError();
}

// Registers, local (spill) bytes and resident CTAs per SM of the eval
// (sample = 0) or the sample kernel; then the CTA's threads.
extern "C" cudaError_t disney_info(int sample, int* out) {
  cudaFuncAttributes attr;
  int blocks = 0;
  const void* fn = sample ? reinterpret_cast<const void*>(disney_sample_kernel)
                          : reinterpret_cast<const void*>(disney_eval_kernel);
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, 0);
  if (e != cudaSuccess) return e;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks;
  out[3] = kThreads;
  return cudaSuccess;
}
