"""BSDF interface records and the Lambertian BSDF (counterpart of
stratum_tpu/render/bsdf.py). Directions live in the local shading frame
(+z = shading normal); f never includes |cos theta_i|.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stratum_tpu_torch.core import math as smath
from stratum_tpu_torch.render.shading import MaterialSample


class BSDFEval(NamedTuple):
    f: torch.Tensor  # [N, 3]
    pdf_fwd: torch.Tensor  # [N]
    pdf_rev: torch.Tensor  # [N]


class BSDFSample(NamedTuple):
    wi: torch.Tensor  # [N, 3]
    f: torch.Tensor  # [N, 3]
    pdf_fwd: torch.Tensor  # [N]
    pdf_rev: torch.Tensor  # [N]
    eta: torch.Tensor  # [N] relative IOR on transmission, 0 on reflection
    roughness: torch.Tensor  # [N]


def lambert_eval(mat: MaterialSample, wo, wi) -> BSDFEval:
    same_side = (wo[..., 2] > 0) & (wi[..., 2] > 0)
    f = torch.where(same_side[..., None], mat.base_color * smath.INV_PI, 0.0)
    pdf = torch.where(same_side, smath.cosine_hemisphere_pdfW(wi[..., 2]), 0.0)
    pdf_rev = torch.where(same_side, smath.cosine_hemisphere_pdfW(wo[..., 2]), 0.0)
    return BSDFEval(f=f, pdf_fwd=pdf, pdf_rev=pdf_rev)


def lambert_sample(mat: MaterialSample, wo, u) -> BSDFSample:
    sgn = torch.sign(wo[..., 2:3])
    wi = smath.sample_cos_hemisphere(u[..., 0], u[..., 1]) * sgn
    ev = lambert_eval(mat, wo * sgn, wi * sgn)
    return BSDFSample(
        wi=wi, f=ev.f, pdf_fwd=ev.pdf_fwd, pdf_rev=ev.pdf_rev,
        eta=torch.zeros_like(wo[..., 0]), roughness=torch.ones_like(wo[..., 0]),
    )
