"""Scene inspector: node tree and component / stat report as a CLI
(counterpart of stratum_tpu/tools/inspect.py; the reference's ImGui
Inspector, src/Node/Inspector.{hpp,cpp}, and its Scene stats panel,
Node/Scene.cpp:284-297). Prints the tree; with ``--flatten`` the flattened
scene's counts, its tensors of 64 KiB or more with shapes and sizes, the
materials, lights and fat-leaf BVH; ``--pick=x,y`` what the pixel's
centre ray hits (``aov.pick``).

Usage:
    python -m stratum_tpu_torch.tools.inspect --scene=cornell [--flatten]
        [--pick=x,y --width=512 --height=512] [--cpu]

The flatten and the pick run on the card unless given ``--cpu``.
"""

from __future__ import annotations

import sys


def _tree(node, depth=0, lines=None):
    lines = [] if lines is None else lines
    comps = ", ".join(type(c).__name__ for c in node.components.values())
    lines.append(f"{'  ' * depth}{node.name}" + (f"  [{comps}]" if comps else ""))
    for c in node.children:
        _tree(c, depth + 1, lines)
    return lines


def _tensors(tree, path=""):
    """(".field.path", tensor) of every tensor in nested NamedTuples, in
    field order."""
    import torch

    if torch.is_tensor(tree):
        yield path, tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, value in zip(tree._fields, tree):
            yield from _tensors(value, f"{path}.{name}")


def main(argv=None) -> int:
    from stratum_tpu_torch.utils.flags import Options

    opts = Options(sys.argv[1:] if argv is None else argv)
    import numpy as np

    from stratum_tpu_torch.cli import build_scene, select_device

    g = build_scene(opts)
    print("\n".join(_tree(g.root)))

    if not (opts.has("flatten") or opts.has("pick")):
        return 0
    from stratum_tpu_torch.scene import flatten as sflatten

    device = select_device(opts)
    scene, stats = sflatten.flatten(g.root, device=device)

    if opts.has("pick"):
        # --pick=x,y: pixel -> instance/prim/depth readback (reference:
        # Inspector selection via VisibilityInfo pick, Node/BDPT.cpp:360-371)
        from stratum_tpu_torch.render import aov as saov
        from stratum_tpu_torch.render import camera as scamera
        from stratum_tpu_torch.render.integrator import RenderConfig

        x, y = (int(v) for v in opts.get_str("pick").split(","))
        width = opts.get_int("width", 512)
        height = opts.get_int("height", 512)
        node, cam = sflatten.find_camera(g.root)
        view = scamera.make_view(node.to_world(), cam.fovy, width, height, device=device)
        cfg = RenderConfig(width=width, height=height)
        r = saov.pick(scene, view, cfg, x, y)
        inst = int(r.instance[0])
        names = stats.instance_names
        pos = r.position[0].cpu().numpy()
        print(
            f"\npick ({x},{y}): instance={inst}"
            + (f" ({names[inst]})" if 0 <= inst < len(names) else "")
            + f" prim={int(r.prim[0])} material={int(r.material[0])}"
            f" depth={float(r.depth[0]):.4f}"
            f" pos=({pos[0]:.3f},{pos[1]:.3f},{pos[2]:.3f})"
        )

    if not opts.has("flatten"):
        return 0
    print(
        f"\ninstances {stats.num_instances}  triangles {stats.num_triangles}"
        f"  vertices {stats.num_vertices}  materials {stats.num_materials}"
        f"  lights {stats.num_lights}"
    )
    total = 0
    print("\ndevice buffers:")
    for name, leaf in _tensors(scene):
        nbytes = leaf.numel() * leaf.element_size()
        total += nbytes
        if nbytes >= 1 << 16:
            print(f"  {name:<55s} {str(tuple(leaf.shape)):>18s} {nbytes / 1e6:8.2f} MB")
    print(f"total device memory: {total / 1e6:.1f} MB")

    print("\nmaterials:")
    m = scene.materials
    for i in range(m.base_color.shape[0]):
        bc = m.base_color[i].cpu().numpy()
        em = m.emission[i].cpu().numpy()
        print(
            f"  [{i}] base=({bc[0]:.2f},{bc[1]:.2f},{bc[2]:.2f})"
            f" metal={float(m.metallic[i]):.2f}"
            f" rough={float(m.roughness[i]):.2f}"
            f" trans={float(m.transmission[i]):.2f}"
            + (f" Le={em.max():.1f}" if em.max() > 0 else "")
        )
    nl = int(scene.lights.num_lights)
    print(f"\nlights: {nl} emissive triangles, total power "
          f"{float(scene.lights.power.sum()):.1f}")

    # traversal-cost telemetry: a visited leaf costs its real triangles'
    # tests, so fill is the share of work and the total box area tracks
    # false-positive visits
    fb = scene.fat_bvh
    tri = fb.leaf_tri.cpu().numpy()
    fill = float((tri >= 0).mean())
    d = np.maximum(fb.leaf_hi.cpu().numpy() - fb.leaf_lo.cpu().numpy(), 0.0)
    area = float(
        (2 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])).sum()
    )
    print(
        f"\nBVH: {fb.num_leaves} fat leaves x K={tri.shape[1]}, "
        f"slot fill {fill:.1%}, total leaf surface area {area:.3g}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
