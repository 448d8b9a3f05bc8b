"""Scene bridge: the reference's SceneData arrays (as numpy) -> the port's
SceneData, so a test can feed both packages the very same scene.

``numpy_fields`` walks any nested NamedTuple (the JAX SceneData included)
into ``{"geo.positions": array, ...}`` with ``np.asarray`` on the leaves;
``scene_from_numpy`` builds the port's scene from such a dict. Neither
imports JAX.
"""

from __future__ import annotations

import numpy as np

from stratum_tpu_torch.core.distribution import Dist1D, Dist2D
from stratum_tpu_torch.ops.packet import FatBVH
from stratum_tpu_torch.scene import schema


def numpy_fields(tree, prefix: str = "") -> dict:
    """Nested NamedTuple -> {dotted name: numpy array}; None and non-array
    leaves (e.g. texture stacks) are skipped."""
    out = {}
    for name, value in zip(tree._fields, tree):
        key = prefix + name
        if isinstance(value, tuple) and hasattr(value, "_fields"):
            out.update(numpy_fields(value, key + "."))
        elif hasattr(value, "__array__"):
            out[key] = np.asarray(value)
    return out


def _dist1d(f, key):
    return Dist1D(pdf=f[key + ".pdf"], cdf=f[key + ".cdf"])


def scene_from_numpy(fields: dict, device) -> schema.SceneData:
    """Port SceneData on ``device`` from :func:`numpy_fields` output."""
    f = fields
    if "spheres.radius" in f and f["spheres.radius"].shape[0] > 0:
        raise NotImplementedError("analytic spheres: ROADMAP Queue 1 item 4")
    if "media.density" in f and f["media.density"].shape[1] > 1:
        raise NotImplementedError("participating media: ROADMAP Queue 1 item 4")
    if any((f["materials." + t] >= 0).any() for t in schema.MATERIAL_TEXTURES):
        raise NotImplementedError("textured materials: ROADMAP Queue 1 item 2")
    if f["env.emission"].shape[:2] != (1, 1):
        raise NotImplementedError("environment images: ROADMAP Queue 1 item 2")

    def sub(nt, prefix):
        return nt(**{k: f[prefix + k] for k in nt._fields})

    scene = schema.SceneData(
        geo=sub(schema.GeometrySoA, "geo."),
        materials=sub(schema.DisneyMaterials, "materials."),
        lights=schema.LightData(
            tri_index=f["lights.tri_index"],
            area=f["lights.area"],
            power=f["lights.power"],
            power_dist=_dist1d(f, "lights.power_dist"),
            num_lights=int(f["lights.num_lights"]),
            env_probability=float(f["lights.env_probability"]),
            packed=f["lights.packed"],
        ),
        env=schema.Environment(
            emission=f["env.emission"],
            dist=Dist2D(
                marginal=_dist1d(f, "env.dist.marginal"),
                cond_pdf=f["env.dist.cond_pdf"],
                cond_cdf=f["env.dist.cond_cdf"],
            ),
            emission_pdf=f["env.emission_pdf"],
        ),
        fat_bvh=sub(FatBVH, "fat_bvh."),
        slot_payload=f["slot_payload"],
        tri_features=f["tri_features"],
        # the reference builds this table but leaves SceneData.tri_payload
        # None (its flatten.py:523-545); the same rows come from its tables
        tri_payload=schema.build_tri_payload(f["geo.packed_tri"], f["materials.packed"]),
    )
    return schema.to_device(scene, device)
