"""SPD's sphereflake (``scene/builtin.py::sphereflake``, the benchmark's
``portbench/scenes/sphereflake.py``): the generator's sphere counts and
geometry, the triangle count, the port's scene and the benchmark's frozen
copy giving the same triangles, and a whole CPU run of the
``sphereflake-path`` cell at a small size (size factor 2, 4 x 8 spheres,
32 x 24 pixels, the block tracer's plain version) judged correct against
the plain reference, with the reference in bfloat16 in the program's
place judged not correct."""

import numpy as np
import pytest

from portbench import harness
from portbench.reference import geometry
from portbench.scenes import sphereflake as frozen
from portbench.tests import _tiny
from stratum_tpu_torch import cli
from stratum_tpu_torch.scene import builtin, flatten
from stratum_tpu_torch.scene.graph import EnvironmentComponent, MeshPrimitive
from stratum_tpu_torch.utils.flags import Options

SMALL = {"size_factor": 2, "stacks": 4, "slices": 8}


@pytest.mark.parametrize("sf, n", [(0, 1), (1, 10), (2, 91), (3, 820), (4, 7381)])
def test_sphere_counts(sf, n):
    centres, radii = builtin.sphereflake_spheres(sf)
    assert centres.shape == (n, 3) and radii.shape == (n,)
    assert len(frozen.spheres(sf)[0]) == n


def test_children_touch_their_parent_and_siblings_do_not_overlap():
    """At size factor 3, in the depth-first order: each sphere's nine
    children have a third of its radius r, lie at r + r / 3 from its
    centre, six on its equator and three above (about the direction away
    from its own parent), and no two siblings overlap."""
    sf = 3
    centres, radii = builtin.sphereflake_spheres(sf)
    size = [sum(9 ** k for k in range(d + 1)) for d in range(sf + 1)]

    def check(i, depth, up):
        if depth == 0:
            return
        kids = [i + 1 + j * size[depth - 1] for j in range(9)]
        c, r = centres[i], radii[i]
        off = centres[kids] - c
        np.testing.assert_allclose(radii[kids], r / 3.0, rtol=1e-12)
        np.testing.assert_allclose(np.linalg.norm(off, axis=1), r * 4.0 / 3.0, rtol=1e-12)
        elev = np.degrees(np.arcsin(np.clip(off @ up / (r * 4.0 / 3.0), -1.0, 1.0)))
        assert np.sum(np.abs(elev) < 1e-6) == 6 and np.sum(np.abs(elev - 54.7356) < 1e-3) == 3
        gap = np.linalg.norm(off[:, None] - off[None], axis=-1) + np.eye(9)
        assert (gap >= 2 * r / 3.0 - 1e-12).all()
        for k in kids:
            check(k, depth - 1, (centres[k] - c) / np.linalg.norm(centres[k] - c))

    check(0, sf, np.asarray([0.0, 0.0, 1.0]))


def _triangles(size_factor=4, stacks=12, slices=24):
    """A UV sphere has 2 (stacks - 1) slices triangles (one fan row at each
    pole), the ground 2, each of the 3 light spheres 120 (6 x 12)."""
    return (sum(9 ** k for k in range(size_factor + 1)) * 2 * (stacks - 1) * slices
            + 2 + 3 * 120)


def test_triangle_count():
    """528 triangles a 12 x 24 sphere: 3,897,530 with the ground and the
    lights at size factor 4; the formula is what flatten counts."""
    assert _triangles() == 7381 * 528 + 2 + 3 * 120 == 3_897_530
    _, stats = flatten.flatten(builtin.sphereflake(**SMALL).root, device="cpu")
    assert stats.num_triangles == _triangles(**SMALL) == 91 * 48 + 362
    assert stats.num_instances == 91 + 1 + 3


def test_cli_names_the_scene():
    g = cli.build_scene(Options(["--scene=sphereflake"]))
    meshes = [n for n in g.root.descendants() if n.find(MeshPrimitive) is not None]
    assert len(meshes) == 7381 + 1 + 3


def test_the_port_and_the_frozen_copy_give_the_same_triangles():
    """At size factor 2 and 4 x 8: the port's node graph, each node's mesh
    under its world transform, against the benchmark's arrays through the
    reference's ``geometry.world``: the same triangles bit for bit, the same
    materials, environment and camera."""
    g = builtin.sphereflake(**SMALL)
    nodes = [n for n in g.root.descendants() if n.find(MeshPrimitive) is not None]
    tris = []
    for n in nodes:
        mp, m = n.find(MeshPrimitive), n.to_world()
        pos = (np.asarray(mp.positions, np.float32) @ m[:, :3].T + m[:, 3]).astype(np.float32)
        tris.append(pos[np.asarray(mp.indices, np.int64)])
    raw = frozen.build(dict(SMALL, camera={}), 0, None)
    world = geometry.world(raw, "cpu", normals=False)
    assert np.array_equal(np.concatenate(tris), world.tri.numpy())
    for n, m in zip(nodes, raw["meshes"]):
        mat = n.find(MeshPrimitive).material
        assert n.name == m["name"]
        assert np.array_equal(np.float32(mat.base_color), np.float32(m["material"]["base_color"]))
        assert np.array_equal(np.float32(mat.emission), np.float32(m["material"]["emission"]))
        assert (mat.metallic, mat.roughness) == (m["material"]["metallic"],
                                                 m["material"]["roughness"])
    (_, env), = g.root.find_in_descendants(EnvironmentComponent)
    assert np.array_equal(env.color, np.float32(raw["environment"]))
    node, cam = flatten.find_camera(g.root)
    assert np.array_equal(node.to_world(), raw["camera"]["camera_to_world"])
    assert cam.fovy == pytest.approx(raw["camera"]["fovy"])


def test_a_small_run_of_the_cell_is_correct_and_the_control_is_not():
    """The cell's whole run on the CPU at a small size: the program's hits,
    shadow rays and radiance on seeded pixels within the cell's limits of
    the plain reference; the reference computed in bfloat16 fails some."""
    o = dict(width=32, height=24, check={"lanes": 256, "pixels": 256},
             render=dict(_tiny.RENDER), scene_params=dict(SMALL))
    r = harness.run("sphereflake-path", 2_147_483_659, 0.1, False, device="cpu", overrides=o,
                    control=True)
    assert r["correct"], r["check"]
    assert r["judged"]["closest_lanes"] > 0 and r["judged"]["radiance_pixels"] > 0
    assert any(not ok for *_, ok in r["control"]), r["control"]
