"""Interactive preview: one viewer in a closed loop through
``render.session.RenderSession(denoise=True)``. Each frame is ``frame()``
(a 1 spp sample, the G-buffer when the view is new, the SVGF denoiser) and
the ACES tonemap, ending in a synchronise; before every ``move_every``-th
frame the camera moves one step along a fly path drawn from the run's
seed, which restarts the accumulation and costs a G-buffer wave and a
history reprojection.
"""

from __future__ import annotations

import numpy as np


def units(params: dict) -> int:
    return 1


def fly_path(seed: int, start: dict, steps: int) -> list:
    """Camera-to-world [3, 4] poses: a walk down the hall from ``start``
    (``eye`` range, ``yaw`` and ``pitch`` wander, ``step`` length), the same
    kind of path for every seed."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(start["eye_lo"], np.float64), np.asarray(start["eye_hi"], np.float64)
    eye = lo + (hi - lo) * rng.random(3)
    yaw = pitch = 0.0
    poses = []
    for _ in range(steps):
        yaw = float(np.clip(yaw + rng.normal() * start["yaw_step"], -start["yaw_max"],
                            start["yaw_max"]))
        pitch = float(np.clip(pitch + rng.normal() * start["pitch_step"], -start["pitch_max"],
                              start["pitch_max"]))
        fwd = np.asarray([np.sin(yaw) * np.cos(pitch), np.sin(pitch),
                          np.cos(yaw) * np.cos(pitch)])
        right = np.asarray([np.cos(yaw), 0.0, -np.sin(yaw)])
        up = np.cross(fwd, right)
        poses.append(np.concatenate([np.stack([right, up, fwd], axis=-1), eye[:, None]],
                                    axis=-1).astype(np.float32))
        eye = eye + np.asarray([fwd[0], 0.0, fwd[2]]) * start["step"]
    return poses


def setup(ctx, params: dict) -> dict:
    from stratum_tpu_torch.render import session

    poses = fly_path(ctx.seed, params["fly"], int(params["path_poses"]))
    sess = session.RenderSession(ctx.scene, ctx.make_view(poses[0]), ctx.cfg, denoise=True)
    return dict(sess=sess, poses=poses, params=params, move=0, views=[None, poses[0]])


def _frame(ctx, st):
    import torch
    from stratum_tpu_torch.render import tonemap

    img = st["sess"].frame()
    ctx.tracer.mark("tonemap", "begin")
    out = tonemap.tonemap(img, tonemap.TonemapMode.ACES)
    ctx.tracer.mark("tonemap", "end")
    if out.is_cuda:
        torch.cuda.synchronize()
    return img, out


def _move(ctx, st):
    st["move"] += 1
    pose = st["poses"][st["move"] % len(st["poses"])]
    st["views"] = [st["views"][1], pose]
    st["sess"].set_view(ctx.make_view(pose))


def warm(ctx, st):
    # a moved frame and a still one: every shape of the window
    for i in range(int(st["params"].get("warm_calls", 3))):
        if i % 2 == 0:
            _move(ctx, st)
        _frame(ctx, st)


def call(ctx, st, i: int):
    if i % int(st["params"]["move_every"]) == 0:
        _move(ctx, st)
    _, out = _frame(ctx, st)
    ctx.output(i, tonemapped=out, views=list(st["views"]), spp=st["sess"].spp)
