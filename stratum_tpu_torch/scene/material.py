"""Host-side material description.

The port's copy of stratum_tpu/scene/material.py (numpy only, unchanged),
so that the port builds scenes without importing the JAX package.

TPU-native analog of the reference host material (src/Node/Material.hpp:12-70):
a Disney parameter set where each slot is a constant factor times an optional
texture (the ImageValue pattern, src/Shaders/image_value.h). Host materials
are deduplicated by value into rows of the device ``DisneyMaterials`` SoA at
flatten time (reference dedups via byte-stream hashing, Scene.cpp:387-396).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Material:
    base_color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.full(3, 0.8, np.float32)
    )
    emission: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    metallic: float = 0.0
    roughness: float = 1.0
    anisotropic: float = 0.0
    subsurface: float = 0.0
    clearcoat: float = 0.0
    clearcoat_gloss: float = 1.0
    transmission: float = 0.0
    eta: float = 1.5
    # optional textures, numpy [H,W,C] float32 linear
    base_color_image: Optional[np.ndarray] = None
    emission_image: Optional[np.ndarray] = None
    rough_metal_image: Optional[np.ndarray] = None  # g=roughness, b=metallic
    normal_image: Optional[np.ndarray] = None
    alpha_image: Optional[np.ndarray] = None
    alpha_cutoff: float = 0.5
    name: str = ""

    def key(self):
        """Value-dedup key (images dedup by object identity)."""
        return (
            tuple(np.asarray(self.base_color, np.float32).ravel()),
            tuple(np.asarray(self.emission, np.float32).ravel()),
            float(self.metallic),
            float(self.roughness),
            float(self.anisotropic),
            float(self.subsurface),
            float(self.clearcoat),
            float(self.clearcoat_gloss),
            float(self.transmission),
            float(self.eta),
            id(self.base_color_image) if self.base_color_image is not None else -1,
            id(self.emission_image) if self.emission_image is not None else -1,
            id(self.rough_metal_image) if self.rough_metal_image is not None else -1,
            id(self.normal_image) if self.normal_image is not None else -1,
            id(self.alpha_image) if self.alpha_image is not None else -1,
            float(self.alpha_cutoff),
        )


def make_metallic_roughness_material(
    base_color, metallic=0.0, roughness=1.0, emission=None, **kw
) -> Material:
    """glTF metallic-roughness -> Disney (reference:
    Scene::make_metallic_roughness_material, Node/Scene.cpp:156-256; the GPU
    conversion kernel material_convert.hlsl maps the same parameters)."""
    return Material(
        base_color=np.asarray(base_color, np.float32),
        metallic=float(metallic),
        roughness=float(roughness),
        emission=(
            np.zeros(3, np.float32)
            if emission is None
            else np.asarray(emission, np.float32)
        ),
        **kw,
    )


def make_diffuse_specular_material(
    diffuse, specular, shininess: float = 0.0, emission=None, **kw
) -> Material:
    """Classic diffuse/specular(Phong-ish) -> Disney, following the parameter
    mapping of the reference's diffuse_specular conversion
    (Node/Scene.cpp:156-256, kernels/material_convert.hlsl:29-50):
    roughness = sqrt(2/(shininess+2)), metallic from specular weight."""
    diffuse = np.asarray(diffuse, np.float32)
    specular = np.asarray(specular, np.float32)
    ld = float(diffuse.mean())
    ls = float(specular.mean())
    metallic = ls / max(ld + ls, 1e-6)
    base = diffuse + specular
    m = max(base.max(), 1.0)
    return Material(
        base_color=base / m,
        metallic=metallic,
        roughness=float(np.sqrt(2.0 / (shininess + 2.0))) if shininess > 0 else 1.0,
        emission=(
            np.zeros(3, np.float32)
            if emission is None
            else np.asarray(emission, np.float32)
        ),
        **kw,
    )
