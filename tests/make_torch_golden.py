"""Write tests/golden/torch_atrium_tiny.npz: the JAX reference's
``render_path_with_counts`` images and ray counts on the tiny atrium at the
bench configuration, for the PyTorch port to be checked against where JAX is
not installed (``chip_smoke.py`` on a GPU machine).

    python tests/make_torch_golden.py

The JAX side uses ``tracer="packet"``: "auto" resolves to the dense MXU
tracer below 16,384 triangles, while "packet" keeps the port's structure
(unsorted primary peel, sorted closest waves, one deferred shadow wave).
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

ATRIUM = dict(columns=1, stacks=6, slices=12)
WIDTH, HEIGHT = 64, 32
SEEDS = (0, 1, 2, 3)
CONFIG = dict(
    width=WIDTH, height=HEIGHT, max_bounces=4, bsdf="disney",
    presample_lights=4096, coherent_tiles=16,
)
OUT = ROOT / "tests" / "golden" / "torch_atrium_tiny.npz"


def render_reference():
    """(images [S, H, W, 3], n_rays [S], camera_to_world [3, 4], fovy)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from stratum_tpu.render import camera, integrator
    from stratum_tpu.scene import builtin, flatten

    g = builtin.atrium(**ATRIUM)
    scene, _ = flatten.flatten(g.root)
    node, cam = flatten.find_camera(g.root)
    view = camera.make_view(node.to_world(), cam.fovy, WIDTH, HEIGHT)
    cfg = integrator.RenderConfig(tracer="packet", **CONFIG)
    imgs, rays = [], []
    for seed in SEEDS:
        img, n = integrator.render_path_with_counts(scene, view, cfg, seed)
        imgs.append(np.asarray(img))
        rays.append(int(n))
    return (np.stack(imgs).astype(np.float32), np.asarray(rays, np.int64),
            np.asarray(node.to_world(), np.float32), float(cam.fovy))


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    images, n_rays, c2w, fovy = render_reference()
    np.savez(
        OUT, images=images, n_rays=n_rays, seeds=np.asarray(SEEDS),
        camera_to_world=c2w, fovy=np.float32(fovy),
        config=np.asarray(repr(sorted(CONFIG.items()))),
        atrium=np.asarray(repr(sorted(ATRIUM.items()))),
    )
    print(f"wrote {OUT}: means {images.mean(axis=(1, 2, 3))} n_rays {n_rays}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
