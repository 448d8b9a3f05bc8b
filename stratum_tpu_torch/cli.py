"""Command-line renderer of the port (counterpart of stratum_tpu/cli.py):
build a scene, flatten it, render progressively, optionally denoise,
tonemap, write the image and print a stats report.

Usage:
    python -m stratum_tpu_torch.cli --scene=cornell --width=512 --height=512 \\
        --spp=64 --out=cornell.png --tonemap=aces --exposure=0

Flags are the reference's (``--key=value``). The render runs on the card;
``--cpu`` runs it on the CPU, and without ``--cpu`` a machine with no card
raises. ``--scene`` takes ``cornell``, ``furnace``, ``spheres``, ``atrium``
or a file: ``.obj``, ``.gltf`` / ``.glb``, Mitsuba ``.xml``, ``.ply``,
``.stl`` or binary ``.fbx`` (``.blend`` is refused with the export to use).
``--volume=file`` (repeatable; ``.vol``, ``.nvdb`` or ``.npy``) adds a
medium, its density scaled by ``--densityScale``. ``--compileCache`` (the
reference's JAX compile cache) is accepted and has nothing to do here.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np


def build_scene(opts):
    from stratum_tpu_torch.scene import builtin
    from stratum_tpu_torch.scene.graph import NodeGraph
    from stratum_tpu_torch.scene.loaders.obj import load_obj

    name = opts.get_str("scene", "cornell")
    if name == "cornell":
        return builtin.cornell_box()
    if name == "furnace":
        return builtin.furnace()
    if name == "spheres":
        return builtin.material_spheres()
    if name == "atrium":
        return builtin.atrium()
    path = Path(name)
    if not path.exists():
        raise FileNotFoundError(f"scene {name!r} not found")
    g = NodeGraph()
    ext = path.suffix.lower()
    if ext == ".obj":
        load_obj(g.root, path)
    elif ext in (".gltf", ".glb"):
        from stratum_tpu_torch.scene.loaders.gltf import load_gltf

        load_gltf(g.root, path)
    elif ext == ".xml":
        from stratum_tpu_torch.scene.loaders.mitsuba import load_mitsuba

        load_mitsuba(g.root, path)
    elif ext == ".ply":
        from stratum_tpu_torch.scene.graph import MeshPrimitive
        from stratum_tpu_torch.scene.loaders.ply import load_ply_mesh

        pos, nrm, uvs, idx = load_ply_mesh(path)
        g.root.add_child(path.stem).make_component(
            MeshPrimitive(positions=pos, indices=idx, normals=nrm, uvs=uvs)
        )
    elif ext == ".stl":
        from stratum_tpu_torch.scene.loaders.stl import load_stl

        load_stl(g.root, path)
    elif ext == ".fbx":
        from stratum_tpu_torch.scene.loaders.fbx import load_fbx

        load_fbx(g.root, path)
    elif ext == ".blend":
        raise ValueError(
            f"{path}: .blend is unsupported — export from Blender as "
            "glTF/GLB (best fidelity) or OBJ/FBX and load that instead"
        )
    else:
        raise ValueError(f"unsupported scene extension {ext!r}")
    return g


def ensure_camera(g, opts, scene_aabb):
    """The scene's camera, or one synthesized to frame the scene (with
    the ``cameraPosX/Y/Z`` and ``fovy`` flags) -> (camera-to-world, fovy)."""
    from stratum_tpu_torch.core import transform as xform
    from stratum_tpu_torch.scene import flatten as sflatten

    found = sflatten.find_camera(g.root)
    if found is not None and not opts.has("cameraPosX"):
        node, cam = found
        return node.to_world(), cam.fovy
    lo, hi = scene_aabb
    center = (lo + hi) / 2
    extent = float(np.linalg.norm(hi - lo))
    eye = np.asarray(
        [
            opts.get_float("cameraPosX", center[0]),
            opts.get_float("cameraPosY", center[1]),
            opts.get_float("cameraPosZ", center[2] - 1.5 * extent),
        ],
        np.float32,
    )
    fovy = np.radians(opts.get_float("fovy", 70.0))
    return xform.look_at(eye, center), fovy


def select_device(opts) -> str:
    """"cpu" with ``--cpu``, else "cuda"; raises when there is no card."""
    import torch

    if opts.has("cpu"):
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu to render on the CPU")
    return "cuda"


def main(argv=None) -> int:
    from stratum_tpu_torch.utils.flags import Options

    opts = Options(sys.argv[1:] if argv is None else argv)
    if opts.has("help"):
        print(__doc__)
        return 0
    device = select_device(opts)

    from stratum_tpu_torch.core import rng as srng
    from stratum_tpu_torch.render import camera as scamera
    from stratum_tpu_torch.render import integrator as sintegrator
    from stratum_tpu_torch.render import lights as slights
    from stratum_tpu_torch.scene import flatten as sflatten

    t0 = time.time()
    g = build_scene(opts)
    for vol in opts.find_all("volume"):
        from stratum_tpu_torch.scene.loaders.volumes import load_volume

        load_volume(g.root, vol, density_scale=opts.get_float("densityScale", 1.0))
    if opts.has("envmap"):
        # an equirect HDR environment light
        from stratum_tpu_torch.io.image import load_image
        from stratum_tpu_torch.scene.graph import EnvironmentComponent

        g.root.add_child("envmap").make_component(
            EnvironmentComponent(
                color=np.full(3, opts.get_float("envScale", 1.0), np.float32),
                image=load_image(opts.get_str("envmap"), srgb=None)[..., :3],
                source_path=opts.get_str("envmap"),
            )
        )
    # plugins: python modules with a register(graph, opts) hook
    for plug in opts.find_all("plugin"):
        import importlib

        mod = importlib.import_module(plug)
        if hasattr(mod, "register"):
            mod.register(g, opts)
    anim_time = opts.get_float("time", None) if opts.has("time") else None
    prev_time = opts.get_float("prevTime", None) if opts.has("prevTime") else None
    scene, stats = sflatten.flatten(
        g.root, env_probability=opts.get_float("envProb", 0.5), time=anim_time,
        prev_time=prev_time, device=device,
    )
    pos = scene.geo.positions.cpu().numpy()
    lo, hi = pos.min(axis=0), pos.max(axis=0)
    t_flatten = time.time() - t0

    width = opts.get_int("width", 512)
    height = opts.get_int("height", 512)
    spp = opts.get_int("spp", 16)
    seed = opts.get_int("seed", 0)
    c2w, fovy = ensure_camera(g, opts, (lo, hi))
    view = scamera.make_view(c2w, fovy, width, height, device=device)

    # --quality: the Kronecker lattice, shadow-ray RR (0.05) and adaptive
    # allocation together; each piece's own flag still overrides it
    quality = opts.get_bool("quality", False)
    cfg = sintegrator.RenderConfig(
        width=width,
        height=height,
        max_bounces=opts.get_int("maxBounces", 4),
        use_nee=opts.get_bool("nee", True),
        use_mis=opts.get_bool("mis", True),
        bsdf=opts.get_str("bsdf", "disney"),
        rr_depth=opts.get_int("rrDepth", 2),
        rr_min_beta=opts.get_float("rrMinBeta", 0.05),
        tracer=opts.get_str("tracer", "auto"),
        alpha_test=opts.get_bool("alphaTest", False),
        ris_candidates=opts.get_int("ris", 1)
        if opts.get_str("integrator", "path") != "restir" else 1,
        sort_rays=opts.get_bool("sortRays", True),
        defer_shadows=opts.get_bool("deferShadows", True),
        presample_lights=opts.get_int("presampleLights", 0),
        coherent_tiles=opts.get_int("coherentTiles", 0),
        lvc_connections=opts.get_int("lvcConnections", 0),
        shadow_rr=opts.get_float("shadowRr", 0.05 if quality else 0.0),
        clamp_indirect=opts.get_float("clampIndirect", 0.0),
        tex_filter=opts.get_str("texFilter", "trilinear"),
        wave_caps=tuple(
            float(x) for x in opts.get_str("waveCaps", "").split(",") if x.strip()
        ),
    )
    integrator_name = opts.get_str("integrator", "path")
    # the environment sampler and the lattice are process-global: set for
    # this render and restored after it, since main() also runs in-process
    prev_env_sampler = slights.ENV_SAMPLER
    prev_qmc = srng.QMC
    slights.ENV_SAMPLER = opts.get_str("envSampler", slights.ENV_SAMPLER)
    srng.QMC = opts.get_str("sampler", "kron" if quality else srng.QMC)
    try:
        return _render_and_write(
            opts, scene, stats, view, cfg, integrator_name, width, height, spp, seed,
            t_flatten,
        )
    finally:
        slights.ENV_SAMPLER = prev_env_sampler
        srng.QMC = prev_qmc


def _render_and_write(opts, scene, stats, view, cfg, integrator_name, width, height, spp,
                      seed, t_flatten):
    import torch

    from stratum_tpu_torch.io.image import save_image
    from stratum_tpu_torch.render import integrator as sintegrator
    from stratum_tpu_torch.render import tonemap as stonemap

    t0 = time.time()
    if opts.has("debug"):
        from stratum_tpu_torch.render import debug as sdebug

        img = sdebug.render_debug(scene, view, cfg, opts.get_str("debug", "albedo"), seed, spp)
    elif integrator_name == "direct":
        img = sintegrator.render_direct_progressive(scene, view, cfg, spp, seed)
    elif integrator_name == "path" and opts.get_bool("adaptive", opts.get_bool("quality", False)):
        # spp is the average per-pixel budget
        from stratum_tpu_torch.render import adaptive as sadaptive

        img, _ = sadaptive.render_adaptive(
            scene, view, cfg, spp,
            pilot=opts.get_int("adaptivePilot", max(2, spp // 4)),
            frac=opts.get_float("adaptiveFrac", 0.25),
            seed0=seed,
        )
    elif integrator_name == "path":
        # --sppBatch=N caps the samples handed to one render_path_batched
        # call (the image is the same); --sppLanes=N traces N samples a
        # call as extra wavefront lanes (memory grows with N)
        batch = opts.get_int("sppBatch", spp)
        lanes = opts.get_int("sppLanes", 0)
        img = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                          device=scene.device)
        done = 0
        while done < spp:
            if lanes > 1:
                b = min(lanes, spp - done)
                mean_b, _ = sintegrator.render_path_lanes(scene, view, cfg, b, seed + done)
            else:
                b = min(batch, spp - done)
                mean_b, _ = sintegrator.render_path_batched(scene, view, cfg, b, seed + done)
            img = img + mean_b * b
            done += b
        img = img / spp
    elif integrator_name == "lt":
        from stratum_tpu_torch.render import lighttrace

        img = lighttrace.render_lt_progressive(scene, view, cfg, spp, seed)
    elif integrator_name == "bdpt":
        from stratum_tpu_torch.render import bdpt as sbdpt

        if opts.get_bool("lvcReuse", False) and cfg.lvc_connections > 0:
            # cross-frame light-vertex-cache reuse: the reservoir state is
            # threaded from frame to frame
            acc = None
            state = None
            for s in range(spp):
                frame, state = sbdpt.render_bdpt_reuse(scene, view, cfg, seed + s, state)
                acc = frame if acc is None else acc + frame
            img = acc / spp
        else:
            img = sbdpt.render_bdpt_progressive(
                scene, view, cfg, spp, seed, chunks=opts.get_int("bdptChunks", 0) or None)
    elif integrator_name == "restir":
        # ReSTIR DI (reservoirs persist across the spp frames) plus
        # indirect-only path samples, as the session composes them
        from stratum_tpu_torch.render import session as ssession

        sess = ssession.RenderSession(
            scene, view, cfg,
            use_restir=True,
            restir_candidates=opts.get_int("ris", 4),
            restir_spatial_taps=opts.get_int("spatialTaps", 1),
            restir_hash_jitter=opts.get_bool("hashJitter", False),
            seed0=seed,
        )
        img = sess.step(spp)
    else:
        raise ValueError(f"unknown integrator {integrator_name!r}")
    if opts.get_bool("denoise", False):
        from stratum_tpu_torch.render import aov as saov
        from stratum_tpu_torch.render import denoise as sdenoise

        gbuf = saov.render_gbuffer(scene, view, view, cfg)
        state = sdenoise.init_state(height, width, scene.device)
        dcfg = sdenoise.DenoiseConfig(
            atrous_iterations=opts.get_int("atrousIters", 5),
            filter_type=opts.get_str("filterType", "atrous"),
            history_tap=opts.get_int("historyTap", 0),
            debug_mode=opts.get_str("denoiserDebug", "none"),
        )
        state, img = sdenoise.denoise(state, img, gbuf, dcfg)
    img = img.cpu().numpy()
    t_render = time.time() - t0

    mode = stonemap.TonemapMode(opts.get_str("tonemap", "raw"))
    out = opts.get_str("out", "render.png")
    exposure = opts.get_float("exposure", 0.0)
    if opts.get_bool("autoexposure", False):
        # normalise by the frame max
        max_c, _ = stonemap.reduce_max_color(img)
        exposure = exposure - float(np.log2(max(float(max_c), 1e-4)))
    display = stonemap.tonemap(img, mode, exposure=exposure).numpy()
    save_image(out, display if out.endswith(".png") else img)

    rays = width * height * spp
    print(
        f"scene: {stats.num_instances} instances, {stats.num_triangles} tris, "
        f"{stats.num_materials} materials, {stats.num_lights} lights "
        f"(flatten {t_flatten:.2f}s)"
    )
    print(
        f"render: {width}x{height} @ {spp}spp, {integrator_name} integrator, "
        f"{t_render:.2f}s, {rays / max(t_render, 1e-9) / 1e6:.2f} Mcamera-rays/s"
    )
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
