"""Scene flattening: node graph -> the port's SceneData (counterpart of
stratum_tpu/scene/flatten.py:50-93, 184-609).

Walks the node graph (``scene/graph.py``), bakes meshes to
world space, dedups materials by value and their images by identity, builds
the texture stack, the environment tables, the light table, the native SAH
fat BVH (K = 256), the LBVH, the fused per-slot hit payload and the dense
tracers' triangle features and per-triangle payload, all in numpy, then
moves the result onto ``device`` (the card unless the caller names
another). Analytic spheres become a ``SphereSoA`` with their shading rows
after the padded triangles' (and sphere lights in the light table);
``MediumComponent`` volumes become the density bricks of ``build_media``.
With ``time``, ``AnimationComponent`` keyframes replace the static
transforms they sit beside; with ``prev_time`` every instance also gets
its motion transform (current world -> previous world) for the
G-buffer's motion vectors.
"""

from __future__ import annotations

import dataclasses
import warnings
import zlib

import numpy as np

from stratum_tpu_torch.scene.graph import (
    CameraComponent,
    EnvironmentComponent,
    MediumComponent,
    MeshPrimitive,
    Node,
    SpherePrimitive,
)
from stratum_tpu_torch.scene.material import Material
from stratum_tpu_torch.core.distribution import Dist1D, Dist2D, build_env_dist2d
from stratum_tpu_torch.ops.bvh import build_bvh
from stratum_tpu_torch.ops.mxu import build_tri_features
from stratum_tpu_torch.ops.packet import build_fat_bvh_sah, empty_fat_bvh
from stratum_tpu_torch.render import texture as stex
from stratum_tpu_torch.render.medium import build_media
from stratum_tpu_torch.scene import schema

LEAF_SIZE = 256
# the texture atlases' budget (flat + quad f16 with their mips, ~53 B per
# texel): the reference's value, kept so the stack resolution it clamps to
# is the reference's
TEX_BUDGET_BYTES = 2 << 30
_TEXTURE_SLOTS = (  # material image field, its texture-id column, its slot bit
    ("base_color_image", "base_color_tex", stex.SLOT_BASE_COLOR),
    ("emission_image", "emission_tex", stex.SLOT_EMISSION),
    ("rough_metal_image", "rough_metal_tex", stex.SLOT_ROUGH_METAL),
    ("normal_image", "normal_tex", stex.SLOT_NORMAL),
    ("alpha_image", "alpha_tex", stex.SLOT_ALPHA),
)


@dataclasses.dataclass
class FlattenStats:
    num_instances: int = 0
    num_triangles: int = 0
    num_vertices: int = 0
    num_materials: int = 0
    num_lights: int = 0
    instance_names: list = dataclasses.field(default_factory=list)


def tessellate_sphere(radius: float, stacks: int = 32, slices: int = 64):
    """UV-sphere triangulation with outward winding (numpy)."""
    i = np.arange(stacks + 1, dtype=np.float32)
    j = np.arange(slices + 1, dtype=np.float32)
    theta = i / stacks * np.pi
    phi = j / slices * 2.0 * np.pi
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    sp, cp = np.sin(phi)[None, :], np.cos(phi)[None, :]
    x = st * cp
    y = ct * np.ones_like(sp)
    z = st * sp
    pos = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    uv = np.stack(
        [np.broadcast_to(j / slices, x.shape),
         np.broadcast_to((i / stacks)[:, None], x.shape)],
        axis=-1,
    ).reshape(-1, 2)
    idx = []
    for a in range(stacks):
        for b in range(slices):
            v00 = a * (slices + 1) + b
            v01 = v00 + 1
            v10 = v00 + (slices + 1)
            v11 = v10 + 1
            if a > 0:
                idx.append((v00, v10, v01))
            if a < stacks - 1:
                idx.append((v01, v10, v11))
    indices = np.asarray(idx, np.int32)
    p = pos.astype(np.float32)
    fn = np.cross(p[indices[:, 1]] - p[indices[:, 0]], p[indices[:, 2]] - p[indices[:, 0]])
    centroid = (p[indices[:, 0]] + p[indices[:, 1]] + p[indices[:, 2]]) / 3
    flip = np.einsum("ij,ij->i", fn, centroid) < 0
    indices[flip] = indices[flip][:, ::-1]
    return (pos * radius).astype(np.float32), p, uv.astype(np.float32), indices


def _transform_mesh(m, positions, normals):
    """Bake node-to-world into vertices; normals via inverse-transpose."""
    pw = positions @ m[:, :3].T + m[:, 3]
    lin = m[:, :3]
    nw = normals @ np.linalg.inv(lin)
    nw /= np.maximum(np.linalg.norm(nw, axis=-1, keepdims=True), 1e-20)
    if np.linalg.det(lin) < 0:
        nw = -nw
    return pw.astype(np.float32), nw.astype(np.float32)


def compute_smooth_normals(positions, indices):
    """Area-weighted smooth vertex normals."""
    n = np.zeros_like(positions)
    p0 = positions[indices[:, 0]]
    face_n = np.cross(positions[indices[:, 1]] - p0, positions[indices[:, 2]] - p0)
    for k in range(3):
        np.add.at(n, indices[:, k], face_n)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return np.where(
        ln > 1e-12, n / np.maximum(ln, 1e-20), [0.0, 0.0, 1.0]
    ).astype(np.float32)


def flatten(root: Node, env_probability: float = 0.5, time: float | None = None,
            prev_time: float | None = None, device="cuda"):
    """Walk the subtree under ``root`` -> (SceneData on ``device``,
    FlattenStats). ``time`` evaluates AnimationComponents; ``prev_time``
    also records each instance's motion transform (reference
    flatten.py:184-215). Without a CUDA device the default raises; CPU
    callers pass ``device="cpu"``."""
    stats = FlattenStats()
    instance_motion: list = []

    def motion_for(node) -> np.ndarray:
        """prev_M o inv(M): this instance's current world positions -> its
        previous frame's."""
        if prev_time is None:
            return np.eye(3, 4, dtype=np.float32)
        m = node.to_world(time)
        pm = node.to_world(prev_time)
        inv3 = np.linalg.inv(m[:, :3])
        inv = np.empty((3, 4), np.float32)
        inv[:, :3] = inv3
        inv[:, 3] = -inv3 @ m[:, 3]
        out = np.empty((3, 4), np.float32)
        out[:, :3] = pm[:, :3] @ inv[:, :3]
        out[:, 3] = pm[:, :3] @ inv[:, 3] + pm[:, 3]
        return out

    all_pos, all_nrm, all_uv, all_idx, all_mat, all_inst = [], [], [], [], [], []
    materials: list[Material] = []
    mat_rows: dict = {}
    vert_base = 0
    default_mat = Material()
    # object-space smooth normals of meshes whose nodes share their arrays
    # (instances of one mesh), with the arrays, so their ids stay theirs
    smooth: dict = {}

    def material_row(mat) -> int:
        m = mat if mat is not None else default_mat
        k = m.key()
        if k not in mat_rows:
            mat_rows[k] = len(materials)
            materials.append(m)
        return mat_rows[k]

    def add_mesh(node, positions, indices, normals, uvs, material):
        nonlocal vert_base
        if normals is None:
            key = (id(positions), id(indices))
            if key not in smooth:
                smooth[key] = (positions, indices, compute_smooth_normals(positions, indices))
            normals = smooth[key][2]
        if uvs is None:
            uvs = np.zeros((positions.shape[0], 2), np.float32)
        pw, nw = _transform_mesh(node.to_world(time), positions, normals)
        instance_motion.append(motion_for(node))
        row = material_row(material)
        all_pos.append(pw)
        all_nrm.append(nw)
        all_uv.append(np.asarray(uvs, np.float32))
        all_idx.append(np.asarray(indices, np.int32) + vert_base)
        all_mat.append(np.full(indices.shape[0], row, np.int32))
        all_inst.append(np.full(indices.shape[0], stats.num_instances, np.int32))
        vert_base += positions.shape[0]
        stats.num_instances += 1
        stats.instance_names.append(node.name)

    env_component = None
    media_list, sphere_list = [], []
    for node in root.descendants():
        mp = node.find(MeshPrimitive)
        if mp is not None:
            add_mesh(node, mp.positions, mp.indices, mp.normals, mp.uvs, mp.material)
        sp = node.find(SpherePrimitive)
        if sp is not None:
            if sp.analytic:
                # exact quadratic hits; a uniform scale is assumed (the
                # sphere carries a radius, not a general transform)
                m = node.to_world(time)
                instance_motion.append(motion_for(node))
                sphere_list.append(dict(
                    center=np.asarray(m[:, 3], np.float32),
                    radius=np.float32(sp.radius * float(np.cbrt(abs(np.linalg.det(m[:, :3]))))),
                    material=material_row(sp.material), instance=stats.num_instances,
                ))
                stats.num_instances += 1
                stats.instance_names.append(node.name)
            else:
                pos, nrm, uv, idx = tessellate_sphere(sp.radius, sp.stacks, sp.slices)
                add_mesh(node, pos, idx, nrm, uv, sp.material)
        ec = node.find(EnvironmentComponent)
        if ec is not None:
            env_component = ec
        mc = node.find(MediumComponent)
        if mc is not None:
            m = node.to_world(time)
            lo = m[:, :3] @ np.asarray(mc.box_lo, np.float32) + m[:, 3]
            hi = m[:, :3] @ np.asarray(mc.box_hi, np.float32) + m[:, 3]
            media_list.append(dict(density=mc.density, box_lo=np.minimum(lo, hi),
                                   box_hi=np.maximum(lo, hi), albedo=mc.albedo, g=mc.g))
    if not all_pos and not sphere_list:
        raise ValueError("scene contains no geometry")
    if not all_pos:
        # an all-analytic scene: one degenerate, unhittable triangle anchors
        # the padded triangle arrays
        all_pos.append(np.zeros((3, 3), np.float32))
        all_nrm.append(np.tile([[0.0, 0.0, 1.0]], (3, 1)).astype(np.float32))
        all_uv.append(np.zeros((3, 2), np.float32))
        all_idx.append(np.zeros((1, 3), np.int32))
        all_mat.append(np.full((1,), -1, np.int32))
        all_inst.append(np.zeros((1,), np.int32))
        instance_motion.append(np.eye(3, 4, dtype=np.float32))

    tex_images: list = []
    tex_ids: dict = {}

    def texture_row(img) -> int:
        """Stack index of an image, deduplicated by identity; -1 for none."""
        if img is None:
            return -1
        if id(img) not in tex_ids:
            tex_ids[id(img)] = len(tex_images)
            tex_images.append(np.asarray(img, np.float32))
        return tex_ids[id(img)]

    arrs = schema.default_material_arrays(len(materials))
    for i, m in enumerate(materials):
        arrs["base_color"][i] = np.asarray(m.base_color, np.float32)
        arrs["emission"][i] = np.asarray(m.emission, np.float32)
        for f in schema.MATERIAL_FLOATS + ("alpha_cutoff",):
            arrs[f][i] = getattr(m, f)
        for image, column, _ in _TEXTURE_SLOTS:
            arrs[column][i] = texture_row(getattr(m, image))
    mats = schema.finalize_materials(arrs)
    textures = stex.build_texture_stack(tex_images, res=texture_resolution(tex_images))
    textures = textures._replace(slot_mask=sum(
        bit for _, column, bit in _TEXTURE_SLOTS if np.any(arrs[column] >= 0)))

    has_env = env_component is not None and (
        np.any(np.asarray(env_component.color) > 0)
        or env_component.image is not None
    )
    if has_env and env_component.image is not None:
        img = np.asarray(env_component.image, np.float32)
        img = img * np.asarray(env_component.color, np.float32)
        lum = img @ np.asarray([0.2126, 0.7152, 0.0722], np.float32)
        dist, mips = env_tables(lum, getattr(env_component, "source_path", None))
        env = schema.make_environment(img, dist, mips)
    else:
        env = schema.constant_environment(
            env_component.color if has_env else (0.0, 0.0, 0.0))

    pos_p, nrm_p, uv_p, idx_p, mat_p, inst_p = schema.build_geometry(
        np.concatenate(all_pos), np.concatenate(all_nrm),
        np.concatenate(all_uv), np.concatenate(all_idx),
        np.concatenate(all_mat), np.concatenate(all_inst),
    )
    spheres = schema.empty_spheres()
    if sphere_list:
        spheres = schema.SphereSoA(
            center=np.stack([x["center"] for x in sphere_list]),
            radius=np.asarray([x["radius"] for x in sphere_list], np.float32),
            material=np.asarray([x["material"] for x in sphere_list], np.int32),
            light=spheres.light,
            instance=np.asarray([x["instance"] for x in sphere_list], np.int32),
        )
    lights, tri_light, sphere_light = schema.build_lights(
        pos_p, idx_p, mat_p, mats.emission,
        env_probability=env_probability if has_env else 0.0,
        sphere_center=spheres.center, sphere_radius=spheres.radius,
        sphere_material=spheres.material,
    )
    spheres = spheres._replace(light=sphere_light)
    packed_rows = schema.pack_tri_rows(
        pos_p, nrm_p, uv_p, idx_p, mat_p, tri_light, inst_p
    )
    if sphere_list:  # a hit with tri >= T is sphere tri - T
        packed_rows = np.concatenate([packed_rows, schema.pack_sphere_rows(*spheres)])
    geo = schema.GeometrySoA(
        positions=pos_p, normals=nrm_p, uvs=uv_p, indices=idx_p,
        tri_material=mat_p, tri_light=tri_light, tri_instance=inst_p,
        packed_tri=packed_rows,
    )
    tri_features = build_tri_features(pos_p, idx_p, mat_p >= 0)
    fat = (build_fat_bvh_sah(pos_p, idx_p, mat_p >= 0, leaf_size=LEAF_SIZE,
                             features=tri_features)
           if (mat_p >= 0).any() else empty_fat_bvh(LEAF_SIZE))
    scene = schema.SceneData(
        geo=geo, materials=mats, lights=lights, env=env, fat_bvh=fat,
        slot_payload=build_slot_payload(packed_rows, mats, fat),
        tri_features=tri_features,
        tri_payload=schema.build_tri_payload(packed_rows, mats.packed),
        bvh=build_bvh(pos_p, idx_p, mat_p >= 0),
        textures=textures,
        spheres=spheres,
        media=build_media(media_list),
        instance_motion=np.stack(instance_motion),
    )
    stats.num_triangles = int(sum(i.shape[0] for i in all_idx))
    stats.num_vertices = int(vert_base)
    stats.num_materials = len(materials)
    stats.num_lights = lights.num_lights
    return schema.to_device(scene, device), stats


def texture_resolution(images) -> int:
    """The stack's resolution: the largest source side rounded up to a
    power of 2 in [64, 2048], halved while the stack would pass
    TEX_BUDGET_BYTES (with a warning); 512 without images."""
    if not images:
        return 512
    max_dim = max(max(im.shape[0], im.shape[1]) for im in images)
    res = 64
    while res < max_dim and res < 2048:
        res *= 2
    while res > 64 and len(images) * res * res * 53 > TEX_BUDGET_BYTES:
        res //= 2
        warnings.warn(
            f"texture stack clamped to {res}^2: {len(images)} textures exceed the "
            f"{TEX_BUDGET_BYTES >> 20} MiB budget", stacklevel=3)
    return res


def env_tables(lum: np.ndarray, source_path=None):
    """Environment sampling tables (2D CDF distribution and luminance mip
    pyramid, numpy), cached beside an image that came from a file as
    ``<file>.dists.npz``. The cache key is the table shape and a strided
    CRC of the scaled luminance, so an edited image or another scale
    rebuilds; a missing, stale or unreadable cache is rebuilt, and a cache
    that cannot be written is skipped."""
    cache = str(source_path) + ".dists.npz" if source_path else None
    key = None
    if cache:
        stride = max(1, lum.shape[0] // 64)
        key = np.asarray([lum.shape[0], lum.shape[1],
                          zlib.crc32(np.ascontiguousarray(lum[::stride]).tobytes()), 1],
                         np.int64)
        try:
            with np.load(cache) as z:
                if np.array_equal(z["key"], key):
                    dist = Dist2D(marginal=Dist1D(pdf=z["m_pdf"], cdf=z["m_cdf"]),
                                  cond_pdf=z["c_pdf"], cond_cdf=z["c_cdf"])
                    return dist, z["mips"]
        except (OSError, KeyError, ValueError):
            pass
    dist = build_env_dist2d(lum)
    mips = schema.build_env_mips(lum)
    if cache:
        try:
            np.savez(cache, key=key, m_pdf=dist.marginal.pdf, m_cdf=dist.marginal.cdf,
                     c_pdf=dist.cond_pdf, c_cdf=dist.cond_cdf, mips=mips)
        except OSError:
            pass
    return dist, mips


def build_slot_payload(packed_tri, mats, fat) -> np.ndarray:
    """Fused per-slot hit payload [L*K, 88] (numpy; see SceneData)."""
    slot_tri = np.asarray(fat.leaf_tri).reshape(-1)
    if packed_tri.shape[0] >= (1 << 24):
        raise ValueError("tri ids must stay f32-exact (< 2^24)")
    pk = np.asarray(packed_tri)[np.maximum(slot_tri, 0)]
    feat = np.asarray(fat.leaf_feat).reshape(slot_tri.shape[0], 10, 4)
    auv = feat[:, :, 0:3].reshape(-1, 30)
    mat_ids = np.maximum(pk[:, 24].astype(np.int32), 0)
    mrows = np.asarray(mats.packed)[mat_ids]
    ntex = np.asarray(mats.normal_tex)[mat_ids].astype(np.float32)
    return np.concatenate(
        [pk, auv, slot_tri.astype(np.float32)[:, None], ntex[:, None], mrows],
        axis=1,
    ).astype(np.float32)


def find_camera(root: Node):
    """First camera in the subtree -> (node, CameraComponent) or None."""
    for node, cam in root.find_in_descendants(CameraComponent):
        return node, cam
    return None
