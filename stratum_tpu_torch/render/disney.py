"""Disney principled BSDF: diffuse + metal + glass + clearcoat mixture
(counterpart of stratum_tpu/render/disney.py). Every lobe is evaluated for
every lane and blended by lobe weights; sampling picks a lobe per lane but
f and pdf always come from the full mixture.

Conventions: local frame with wo.z > 0; wi.z < 0 is transmission;
``mat.eta`` is the relative IOR of the transmitted side; f excludes
|cos theta_i|.

On CUDA tensors (f32 [N] and [N, 3], views as they are) :func:`disney_eval`
and :func:`disney_sample` are one launch each of ``csrc/disney.cu``
(``cuda_build.launches()`` counts them as ``disney_eval`` /
``disney_sample``), bit for bit with the plain bodies on the
card; on CPU tensors the plain bodies, :func:`_disney_eval_plain` and
:func:`_disney_sample_plain`, run. There is
no fallback from one to the other: a CUDA tensor launches the kernel or
raises. Each call is a ``bsdf`` span with ``op`` (``eval`` / ``sample``),
``lanes`` and ``kernels`` (the launches it enqueued).
"""

from __future__ import annotations

import ctypes

import torch

from stratum_tpu_torch.core import math as smath
from stratum_tpu_torch.core import microfacet as mf
from stratum_tpu_torch.render.bsdf import BSDFEval, BSDFSample
from stratum_tpu_torch.render.shading import MaterialSample
from stratum_tpu_torch.utils import cuda_build
from stratum_tpu_torch.utils import profiler as sprof


def _lobe_weights(mat: MaterialSample):
    w_diffuse = (1.0 - mat.metallic) * (1.0 - mat.transmission)
    w_metal = mat.metallic
    w_glass = (1.0 - mat.metallic) * mat.transmission
    w_clear = 0.25 * mat.clearcoat
    total = torch.clamp(w_diffuse + w_metal + w_glass + w_clear, min=1e-12)
    return (
        w_diffuse, w_metal, w_glass, w_clear,
        w_diffuse / total, w_metal / total, w_glass / total, w_clear / total,
    )


def _cc_alpha(mat):
    return smath.lerp(0.1, 0.001, mat.clearcoat_gloss)


def _diffuse_eval(mat, wo, wi, h):
    """Burley diffuse + subsurface lerp."""
    ci = torch.abs(wi[..., 2])
    co = torch.abs(wo[..., 2])
    hdotwi = smath.dot(h, wi)
    fd90 = 0.5 + 2.0 * mat.roughness * hdotwi * hdotwi
    fd = (1.0 + (fd90 - 1.0) * smath.pow5(1.0 - ci)) * (
        1.0 + (fd90 - 1.0) * smath.pow5(1.0 - co)
    )
    fss90 = mat.roughness * hdotwi * hdotwi
    fss_in = 1.0 + (fss90 - 1.0) * smath.pow5(1.0 - ci)
    fss_out = 1.0 + (fss90 - 1.0) * smath.pow5(1.0 - co)
    ss = 1.25 * (
        fss_in * fss_out * (smath.safe_div(torch.ones_like(ci), ci + co) - 0.5) + 0.5
    )
    refl = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    val = smath.lerp(fd, ss, mat.subsurface)
    f = torch.where(refl[..., None], mat.base_color * (smath.INV_PI * val)[..., None], 0.0)
    pdf = torch.where(refl, smath.cosine_hemisphere_pdfW(wi[..., 2]), 0.0)
    pdf_rev = torch.where(refl, smath.cosine_hemisphere_pdfW(wo[..., 2]), 0.0)
    return f, pdf, pdf_rev


def _metal_eval(mat, wo, wi, h, ax, ay):
    """GGX metal with Schlick base-color fresnel."""
    refl = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    F = mf.schlick_fresnel(mat.base_color, smath.dot(h, wi)[..., None])
    D = mf.gtr2_ndf(h, ax, ay)
    G = mf.smith_g1(wi, ax, ay) * mf.smith_g1(wo, ax, ay)
    denom = 4.0 * torch.abs(wi[..., 2]) * torch.abs(wo[..., 2])
    f = torch.where(refl[..., None], F * smath.safe_div(D * G, denom)[..., None], 0.0)
    pdf = torch.where(
        refl,
        smath.safe_div(mf.vndf_pdf(wo, h, ax, ay), 4.0 * torch.abs(smath.dot(wo, h))),
        0.0,
    )
    pdf_rev = torch.where(
        refl,
        smath.safe_div(mf.vndf_pdf(wi, h, ax, ay), 4.0 * torch.abs(smath.dot(wi, h))),
        0.0,
    )
    return f, pdf, pdf_rev


def _glass_eval(mat, wo, wi, ax, ay):
    """Rough dielectric reflect/refract (radiance transport)."""
    eta = mat.eta
    is_refl = wi[..., 2] > 0
    h_r = smath.normalize(wi + wo)
    h_t = smath.normalize(wo + wi * eta[..., None])
    h = torch.where(is_refl[..., None], h_r, h_t)
    h = h * torch.sign(h[..., 2:3])
    hdwo = smath.dot(h, wo)
    hdwi = smath.dot(h, wi)
    F = mf.fresnel_dielectric(hdwo, eta)
    D = mf.gtr2_ndf(h, ax, ay)
    G = mf.smith_g1(wi, ax, ay) * mf.smith_g1(wo, ax, ay)
    ci = torch.abs(wi[..., 2])
    co = torch.abs(wo[..., 2])
    f_refl = mat.base_color * smath.safe_div(F * D * G, 4.0 * ci * co)[..., None]
    pdf_refl = smath.safe_div(mf.vndf_pdf(wo, h, ax, ay), 4.0 * torch.abs(hdwo)) * F
    pdf_refl_rev = smath.safe_div(
        mf.vndf_pdf(wi, h, ax, ay), 4.0 * torch.abs(hdwi)
    ) * mf.fresnel_dielectric(torch.abs(hdwi), 1.0 / eta)
    denom_t = hdwo + eta * hdwi
    f_trans = torch.sqrt(torch.clamp(mat.base_color, min=0.0)) * smath.safe_div(
        (1.0 - F) * D * G * torch.abs(hdwi * hdwo), ci * co * denom_t * denom_t
    )[..., None]
    pdf_trans = smath.safe_div(
        mf.vndf_pdf(wo, h, ax, ay) * torch.abs(hdwi) * eta * eta, denom_t * denom_t
    ) * (1.0 - F)
    inv_eta = 1.0 / torch.clamp(eta, min=1e-12)
    denom_rev = hdwi + inv_eta * hdwo
    F_rev = mf.fresnel_dielectric(torch.abs(hdwi), inv_eta)
    pdf_trans_rev = smath.safe_div(
        mf.vndf_pdf(torch.abs(wi), h, ax, ay) * torch.abs(hdwo) * inv_eta * inv_eta,
        denom_rev * denom_rev,
    ) * (1.0 - F_rev)
    f = torch.where(is_refl[..., None], f_refl, f_trans)
    pdf = torch.where(is_refl, pdf_refl, pdf_trans)
    pdf_rev = torch.where(is_refl, pdf_refl_rev, pdf_trans_rev)
    valid = torch.abs(denom_t) > 1e-9
    return (
        torch.where(valid[..., None], f, 0.0),
        torch.where(valid, pdf, 0.0),
        torch.where(valid, pdf_rev, 0.0),
    )


def _clearcoat_eval(mat, wo, wi, h):
    """GTR1 clearcoat, fixed 0.04 fresnel, 0.25 Smith alpha."""
    refl = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    D = mf.gtr1_ndf(h[..., 2], _cc_alpha(mat))
    F = mf.schlick_fresnel(0.04, smath.dot(h, wi))
    G = mf.smith_g1(wi, 0.25, 0.25) * mf.smith_g1(wo, 0.25, 0.25)
    denom = 4.0 * torch.abs(wi[..., 2]) * torch.abs(wo[..., 2])
    fval = smath.safe_div(F * D * G, denom)
    f = torch.where(refl[..., None], fval[..., None].expand(fval.shape + (3,)), 0.0)
    pdf = torch.where(
        refl,
        smath.safe_div(D * torch.abs(h[..., 2]), 4.0 * torch.abs(smath.dot(h, wi))),
        0.0,
    )
    return f, pdf, pdf


def _disney_eval_plain(mat: MaterialSample, wo, wi) -> BSDFEval:
    """:func:`disney_eval` in plain torch ops, on any device."""
    ax, ay = mf.ggx_alpha(mat.roughness, mat.anisotropic)
    h_refl = smath.normalize(wi + wo)
    h_refl = h_refl * torch.sign(h_refl[..., 2:3])
    wd, wm, wg, wc, pd, pm, pg, pc = _lobe_weights(mat)
    f_d, pdf_d, rev_d = _diffuse_eval(mat, wo, wi, h_refl)
    f_m, pdf_m, rev_m = _metal_eval(mat, wo, wi, h_refl, ax, ay)
    f_g, pdf_g, rev_g = _glass_eval(mat, wo, wi, ax, ay)
    f_c, pdf_c, rev_c = _clearcoat_eval(mat, wo, wi, h_refl)
    f = (
        wd[..., None] * f_d + wm[..., None] * f_m
        + wg[..., None] * f_g + wc[..., None] * f_c
    )
    pdf = pd * pdf_d + pm * pdf_m + pg * pdf_g + pc * pdf_c
    pdf_rev = pd * rev_d + pm * rev_m + pg * rev_g + pc * rev_c
    return BSDFEval(f=f, pdf_fwd=pdf, pdf_rev=pdf_rev)


def _disney_sample_plain(mat: MaterialSample, wo, u) -> BSDFSample:
    """:func:`disney_sample` in plain torch ops, on any device."""
    ax, ay = mf.ggx_alpha(mat.roughness, mat.anisotropic)
    _, _, _, _, pd, pm, pg, pc = _lobe_weights(mat)
    u1, u2, usel = u[..., 0], u[..., 1], u[..., 2]
    wi_diffuse = smath.sample_cos_hemisphere(u1, u2)
    h_vndf = mf.sample_vndf(wo, ax, ay, u1, u2)
    wi_metal = mf.reflect(wo, h_vndf)
    eta = mat.eta
    F = mf.fresnel_dielectric(smath.dot(h_vndf, wo), eta)
    wt, can_refract = mf.refract(wo, h_vndf, eta)
    u_glass = torch.clamp(
        smath.safe_div(usel - (pd + pm), torch.clamp(pg, min=1e-12)), 0.0, 1.0
    )
    glass_reflects = (u_glass < F) | ~can_refract
    wi_glass = torch.where(glass_reflects[..., None], wi_metal, wt)
    wi_clear = mf.reflect(wo, mf.sample_gtr1(_cc_alpha(mat), u1, u2))
    c_d = pd
    c_m = pd + pm
    c_g = pd + pm + pg
    wi = torch.where(
        (usel < c_d)[..., None],
        wi_diffuse,
        torch.where(
            (usel < c_m)[..., None],
            wi_metal,
            torch.where((usel < c_g)[..., None], wi_glass, wi_clear),
        ),
    )
    wi = smath.normalize(wi)
    ev = _disney_eval_plain(mat, wo, wi)
    took_trans = (usel >= c_m) & (usel < c_g) & ~glass_reflects
    return BSDFSample(
        wi=wi, f=ev.f, pdf_fwd=ev.pdf_fwd, pdf_rev=ev.pdf_rev,
        eta=torch.where(took_trans, eta, 0.0), roughness=mat.roughness,
    )


def disney_eval(mat: MaterialSample, wo, wi) -> BSDFEval:
    """Full-mixture eval: f [..., 3], the forward and the reverse pdf."""
    return _bsdf(False, mat, wo, wi)


def disney_sample(mat: MaterialSample, wo, u) -> BSDFSample:
    """Pick a lobe by weight with u[..., 2], generate wi with u[..., 0:2],
    then evaluate the full mixture at wi."""
    return _bsdf(True, mat, wo, u)


def _bsdf(sample: bool, mat: MaterialSample, wo, arg):
    """One ``bsdf`` span around the kernel (CUDA tensors) or the plain body
    (CPU ones), with its ``op``, ``lanes`` and the ``kernels`` enqueued."""
    span = sprof.begin("bsdf")
    try:
        if wo.device.type == "cuda":
            out, launched = _launch(sample, mat, wo, arg)
        else:
            plain = _disney_sample_plain if sample else _disney_eval_plain
            out, launched = plain(mat, wo, arg), 0
        sprof.count(span, "op", "sample" if sample else "eval")
        sprof.count(span, "lanes", out.pdf_fwd.numel())
        sprof.count(span, "kernels", launched)
    finally:
        sprof.end(span)  # its end event follows the kernel
    return out


# the material columns in the kernel's Field order; wo and wi (eval) or u
# (sample) follow
_FIELDS = ("base_color", "metallic", "roughness", "anisotropic", "subsurface", "clearcoat",
           "clearcoat_gloss", "transmission", "eta")
_VECTORS = ("base_color", "wo", "wi", "u")  # [N, 3]; the rest [N]


# the inputs' pointers, lane and component strides, the lanes, the outputs
_EVAL = cuda_build.entry("disney.cu", "disney_eval", "ppp q ppp p")
_SAMPLE = cuda_build.entry("disney.cu", "disney_sample", "ppp q ppppp p")
_INFO = cuda_build.entry("disney.cu", "disney_info", "i p")


def kernel_info(sample: bool) -> dict:
    """Registers, local bytes, resident CTAs per SM and CTA threads of the
    eval or the sample kernel; then, from ptxas's report of the library,
    its stack frame and spilled bytes (stores, loads), None without a
    report."""
    return cuda_build.kernel_info(
        _INFO, ("registers", "local_bytes", "ctas_per_sm", "threads"), int(sample),
        kernel="disney_sample_kernel" if sample else "disney_eval_kernel")


def _launch(sample: bool, mat: MaterialSample, wo, arg):
    """One ``csrc/disney.cu`` launch over the N lanes of the inputs -> (
    BSDFEval or BSDFSample, launches enqueued: 1, or 0 for N = 0). Every
    input is an f32 [N] or [N, 3] tensor on one CUDA device, passed by
    pointer and strides as it is (the material columns are views of the
    payload rows)."""
    dev, n = wo.device, wo.shape[0]
    names = _FIELDS + ("wo", "u" if sample else "wi")
    inputs = [getattr(mat, k) for k in _FIELDS] + [wo, arg]
    ptrs = (ctypes.c_void_p * len(names))()
    lane, comp = (ctypes.c_longlong * len(names))(), (ctypes.c_longlong * len(names))()
    for k, (x, name) in enumerate(zip(inputs, names)):
        vec = name in _VECTORS
        cuda_build.check(x, name, torch.float32, (n, 3) if vec else (n,), dev, contiguous=False)
        ptrs[k], lane[k], comp[k] = x.data_ptr(), x.stride(0), x.stride(1) if vec else 0
    f32 = dict(dtype=torch.float32, device=dev)
    f, pdf, rev = torch.empty((n, 3), **f32), torch.empty((n,), **f32), torch.empty((n,), **f32)
    if sample:
        wi, eta = torch.empty((n, 3), **f32), torch.empty((n,), **f32)
    launched = 0
    if n > 0 and sample:
        launched = cuda_build.launch(_SAMPLE, dev, ptrs, lane, comp, n, wi.data_ptr(),
                                     f.data_ptr(), pdf.data_ptr(), rev.data_ptr(), eta.data_ptr())
    elif n > 0:
        launched = cuda_build.launch(_EVAL, dev, ptrs, lane, comp, n, f.data_ptr(),
                                     pdf.data_ptr(), rev.data_ptr())
    if sample:
        return BSDFSample(wi=wi, f=f, pdf_fwd=pdf, pdf_rev=rev, eta=eta,
                          roughness=mat.roughness), launched
    return BSDFEval(f=f, pdf_fwd=pdf, pdf_rev=rev), launched
