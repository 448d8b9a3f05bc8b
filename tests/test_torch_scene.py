"""The port's scene build (stratum_tpu_torch/scene) against the JAX
reference: the same node graph flattened by both packages gives the same SAH
leaves and the same packed tables; the bridge carries the reference's scene
into the port unchanged; light sampling matches on the bridged scene; and the
port builds and renders without importing JAX.

Tolerance: geometry tables are copies and must be equal; the Plucker
features are cross products of coordinates up to ~40 in f32, computed by
numpy here and by XLA there (FMA contraction may differ), so they match to
a few ulps of |p|^2: atol 1e-4 (measured 1.9e-6).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratum_tpu.render import lights as jlights
from stratum_tpu.scene import builtin as jbuiltin
from stratum_tpu.scene import flatten as jflatten
from stratum_tpu_torch.render import lights as plights
from stratum_tpu_torch.scene import bridge, builtin, flatten
from stratum_tpu_torch.scene.graph import (
    EnvironmentComponent,
    MediumComponent,
    MeshPrimitive,
    SpherePrimitive,
)
from stratum_tpu_torch.scene.material import Material

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FEAT = dict(rtol=0, atol=1e-4)
TINY = dict(columns=1, stacks=6, slices=12)


@pytest.fixture(scope="module")
def scenes():
    js, jstats = jflatten.flatten(jbuiltin.atrium(**TINY).root)
    ps, pstats = flatten.flatten(builtin.atrium(**TINY).root, device="cpu")
    return js, ps, jstats, pstats


def test_atrium_build_matches_reference(scenes):
    js, ps, jstats, pstats = scenes
    assert pstats.num_triangles == jstats.num_triangles == 1258
    assert ps.fat_bvh.leaf_tri.shape == (13, 256)
    np.testing.assert_array_equal(ps.fat_bvh.leaf_tri.numpy(), np.asarray(js.fat_bvh.leaf_tri))
    for name in ("leaf_lo", "leaf_hi"):
        np.testing.assert_array_equal(getattr(ps.fat_bvh, name).numpy(),
                                      np.asarray(getattr(js.fat_bvh, name)))
    np.testing.assert_allclose(ps.fat_bvh.leaf_feat.numpy(), np.asarray(js.fat_bvh.leaf_feat), **FEAT)
    np.testing.assert_allclose(ps.slot_payload.numpy(), np.asarray(js.slot_payload), **FEAT)
    np.testing.assert_array_equal(ps.geo.packed_tri.numpy(), np.asarray(js.geo.packed_tri))
    np.testing.assert_array_equal(ps.lights.packed.numpy(), np.asarray(js.lights.packed))
    np.testing.assert_array_equal(ps.materials.packed.numpy(), np.asarray(js.materials.packed))
    np.testing.assert_array_equal(ps.env.emission_pdf.numpy(), np.asarray(js.env.emission_pdf))
    assert ps.lights.num_lights == int(js.lights.num_lights) == 2
    assert ps.lights.env_probability == float(js.lights.env_probability)


def test_cornell_build_matches_reference():
    js, _ = jflatten.flatten(jbuiltin.cornell_box().root)
    ps, _ = flatten.flatten(builtin.cornell_box().root, device="cpu")
    np.testing.assert_array_equal(ps.fat_bvh.leaf_tri.numpy(), np.asarray(js.fat_bvh.leaf_tri))
    np.testing.assert_array_equal(ps.geo.packed_tri.numpy(), np.asarray(js.geo.packed_tri))
    np.testing.assert_array_equal(ps.lights.packed.numpy(), np.asarray(js.lights.packed))
    # Cornell coordinates reach 555, so Plucker terms reach ~3e5 and their
    # ulps ~0.03; measured 2e-3 at most
    np.testing.assert_allclose(ps.slot_payload.numpy(), np.asarray(js.slot_payload),
                               rtol=0, atol=1e-2)
    assert ps.env.emission.abs().sum() == 0 and ps.lights.env_probability == 0.0


def test_bridge_round_trips(scenes):
    js, _, _, _ = scenes
    fields = bridge.numpy_fields(js)
    bs = bridge.scene_from_numpy(fields, "cpu")
    ported = bridge.numpy_fields(bs)
    assert len(ported) > 40
    # the reference leaves SceneData.tri_payload None: the bridge builds it
    # from the rows it is made of
    payload = ported.pop("tri_payload")
    for key, value in ported.items():
        np.testing.assert_array_equal(value, fields[key], err_msg=key)
    rows = fields["geo.packed_tri"]
    mat = fields["materials.packed"][np.maximum(rows[:, 24].astype(np.int64), 0)]
    np.testing.assert_array_equal(payload, np.concatenate([rows, mat], axis=1))
    assert bs.lights.num_lights == 2 and bs.device == torch.device("cpu")


def test_light_sampling_matches_reference(scenes):
    js, ps, _, _ = scenes
    rng = np.random.default_rng(5)
    u = rng.random((4096, 3), dtype=np.float32)
    lp = plights.sample_light(ps, *(torch.from_numpy(u[:, i].copy()) for i in range(3)))
    lj = jlights.sample_light(js, *(jnp.asarray(u[:, i]) for i in range(3)))
    for name in lp._fields:
        # env pdfs carry 1/sin(theta) = 1/sqrt(1 - cos^2): near the poles an
        # ulp of difference in cos(theta) (XLA vs torch) grows to ~1e-3
        # relative (measured 2.5e-3 at most, on 6 of 4096 lanes)
        rtol = 5e-3 if name == "pdf_area" else 1e-5
        np.testing.assert_allclose(getattr(lp, name).numpy(), np.asarray(getattr(lj, name)),
                                   rtol=rtol, atol=1e-6, err_msg=name)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for x, y in zip(plights.env_eval_and_pdf_w_mis(ps, torch.from_numpy(d)),
                    jlights.env_eval_and_pdf_w_mis(js, jnp.asarray(d))):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5, atol=1e-6)
    light_row = torch.from_numpy(rng.integers(-1, 2, 4096).astype(np.int32))
    np.testing.assert_allclose(
        plights.light_pdf_area(ps, None, light_row).numpy(),
        np.asarray(jlights.light_pdf_area(js, None, jnp.asarray(light_row.numpy()))),
        rtol=1e-6,
    )


def _scene_with(component_node):
    g = builtin.cornell_box(boxes=False)
    n = g.root.add_child("extra")
    component_node(n)
    return g


@pytest.mark.parametrize("what", ["analytic_sphere", "medium", "texture", "env_image"])
def test_unported_scene_features_raise(what):
    def add(n):
        if what == "analytic_sphere":
            n.make_component(SpherePrimitive(radius=5.0, analytic=True))
        elif what == "medium":
            n.make_component(MediumComponent(density=np.ones((2, 2, 2), np.float32)))
        elif what == "texture":
            n.make_component(MeshPrimitive(
                positions=np.eye(3, dtype=np.float32), indices=np.asarray([[0, 1, 2]], np.int32),
                material=Material(base_color_image=np.ones((4, 4, 3), np.float32)),
            ))
        else:
            n.make_component(EnvironmentComponent(
                color=np.ones(3, np.float32), image=np.ones((4, 8, 3), np.float32)))

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flatten.flatten(_scene_with(add).root, device="cpu")


def test_entry_points_default_to_the_card():
    """``flatten`` and ``make_view`` put their tensors on the card unless the
    caller asks for the CPU; without a card the default raises rather than
    falling back."""
    import inspect

    from stratum_tpu_torch.render import camera

    for fn in (flatten.flatten, camera.make_view):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert camera.make_view(np.eye(3, 4), 0.9, 8, 8).camera_to_world.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            camera.make_view(np.eye(3, 4), 0.9, 8, 8)


def test_port_runs_without_jax():
    """Import the port (its microbenchmark tools and flag parser included),
    build the atrium, render a tiny frame on the CPU (binned tracer
    included) and run a tool on the CPU in a fresh interpreter: neither JAX
    nor any module of the JAX package may be imported."""
    code = (
        "import sys\n"
        "import torch\n"
        "from stratum_tpu_torch.scene import builtin, flatten\n"
        "from stratum_tpu_torch.render import camera, integrator\n"
        "from stratum_tpu_torch import profile_sample\n"
        "from stratum_tpu_torch.utils import flags\n"
        "from stratum_tpu_torch.tools import (bench_mxu_model, perf_commit_pipeline,"
        " perf_epilogue, probe_mxu_loop)\n"
        "perf_commit_pipeline.main(['--cpu', '--k=8', '--iters=2', '--base_iters=1'])\n"
        "g = builtin.atrium(columns=1, stacks=6, slices=12)\n"
        "scene, _ = flatten.flatten(g.root, device='cpu')\n"
        "node, cam = flatten.find_camera(g.root)\n"
        "view = camera.make_view(node.to_world(), cam.fovy, 32, 16, device='cpu')\n"
        "cfg = integrator.RenderConfig(width=32, height=16, bsdf='disney', tracer='pallas',"
        " presample_lights=256, coherent_tiles=16, binned_secondary=8, binned_shadow=8)\n"
        "img, n = integrator.render_path_with_counts(scene, view, cfg, 0)\n"
        "assert torch.isfinite(img).all() and int(n) > 0\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "ref = [m for m in sys.modules if m == 'stratum_tpu' or m.startswith('stratum_tpu.')]\n"
        "assert not ref, ref\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"
