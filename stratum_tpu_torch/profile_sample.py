"""Where one path-traced sample's time goes, layer by layer.

    python3 -m stratum_tpu_torch.profile_sample [--seed N] [--binned]

Builds the full atrium and renders it on ``cuda:0`` at 1920x1080 with the
bench configuration (Disney, 4 bounces, presample 4096, coherent tiles 16;
with ``--binned`` also ``binned_secondary=8, binned_shadow=8``), through
``render_path_with_counts``: one warm-up sample, then

1. the wall time of two plain samples (host clock, ending in a device
   synchronise);
2. a layer split of one sample, with a device synchronise around every call
   of a layer so each is timed alone (host clock): the light prep
   (``block_trace._prepare``: padding to whole CTAs, ray features, inverse
   directions, group boxes), the trace kernel (``block_trace.launch``,
   whose list phase builds each CTA's front-to-back candidate list), the
   rest of the tracer wrappers,
   ``finalize_hit``, and the glue (everything else: camera, shading,
   Disney, NEE, RNG, sort, accumulation). With ``--binned`` the binned
   tracer's layers come apart too: emission (``binned.emit``: the emission
   kernel on the card), sort and padding (the rest of ``binned.bin_pairs``),
   the bin step (``binned.launch``, K5) and the resolve (the rest of
   ``binned_closest`` / ``binned_occluded``); the block tracer's layers then
   hold the primary wave only;
3. a torch.profiler trace of one sample: device busy time (the summed
   durations of the device's kernels, copies and fills, which run on one
   stream and do not overlap), its share of the plain sample's wall time,
   and the torch ops with the most device time.

Prints one line per result, the ``nvidia-smi`` name and power limit, and a
JSON summary as the last line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import time

import torch

from stratum_tpu_torch.ops import binned, block_trace
from stratum_tpu_torch.render import camera, integrator
from stratum_tpu_torch.scene import builtin, flatten

BENCH = dict(max_bounces=4, bsdf="disney", presample_lights=4096, coherent_tiles=16)
BINNED = dict(binned_secondary=8, binned_shadow=8)
_PATCHED = (  # (module, attribute, layer)
    (block_trace, "_prepare", "prep"),
    (block_trace, "launch", "kernel"),
    (block_trace, "block_closest", "trace"),
    (block_trace, "block_occluded", "trace"),
    (block_trace, "finalize_hit", "finalize_hit"),
    (binned, "emit", "emit"),
    (binned, "bin_pairs", "bin_pairs"),
    (binned, "launch", "bin_step"),
    (binned, "binned_closest", "binned"),
    (binned, "binned_occluded", "binned"),
)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timed_layers(device):
    """Time every call of the tracers' layers (ms, calls) while the
    context is open; the modules' functions are restored on exit."""
    acc = {layer: [0.0, 0] for _, _, layer in _PATCHED}
    saved = []
    for mod, name, layer in _PATCHED:
        real = getattr(mod, name)

        def timed(*a, _real=real, _layer=layer, **k):
            _sync(device)
            t0 = time.perf_counter()
            out = _real(*a, **k)
            _sync(device)
            acc[_layer][0] += (time.perf_counter() - t0) * 1e3
            acc[_layer][1] += 1
            return out

        saved.append((mod, name, real))
        setattr(mod, name, timed)
    try:
        yield acc
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


def layer_split(scene, view, cfg, seed: int) -> dict:
    """One sample with each layer timed alone -> {layer: ms}, plus calls.
    ``trace_other`` is the block tracer wrappers' time outside prep and
    kernel (slicing, and on CPU tensors the plain versions); ``sort_pad``
    is ``bin_pairs`` outside the emission, ``resolve`` the binned wrappers
    outside ``bin_pairs`` and the bin step; ``glue`` is the sample's time
    outside the tracer wrappers and ``finalize_hit``."""
    dev = scene.device
    _sync(dev)
    t0 = time.perf_counter()
    with timed_layers(dev) as acc:
        integrator.render_path_with_counts(scene, view, cfg, seed)
        _sync(dev)
    total = (time.perf_counter() - t0) * 1e3
    ms = {layer: v[0] for layer, v in acc.items()}
    return dict(
        sample=total,
        prep=ms["prep"],
        kernel=ms["kernel"],
        trace_other=ms["trace"] - ms["prep"] - ms["kernel"],
        emit=ms["emit"],
        sort_pad=ms["bin_pairs"] - ms["emit"],
        bin_step=ms["bin_step"],
        resolve=ms["binned"] - ms["bin_pairs"] - ms["bin_step"],
        finalize_hit=ms["finalize_hit"],
        glue=total - ms["trace"] - ms["binned"] - ms["finalize_hit"],
        calls={layer: v[1] for layer, v in acc.items()},
    )


def _kernel_label(name: str) -> str:
    """A device kernel's name cut to its functor or function
    (``...BinaryFunctor<..., MulFunctor<float>>...`` -> ``MulFunctor``)."""
    functors = re.findall(r"(\w+Functor)\b", name)
    if functors:
        return functors[-1]
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return re.split(r"[<(]", name)[0].strip()[:80]


def device_profile(scene, view, cfg, seed: int, top: int = 8, render=None, cpu_ops=True):
    """(device busy ms, [(op, device ms)] of the top ops) over one sample
    of ``render(scene, view, cfg, seed)`` (default: the path tracer's).
    ``cpu_ops=False`` traces the device alone and names the top kernels
    instead of the torch ops: recording every host op costs the profiler
    far more than the op on a sample of hundreds of thousands of ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    render = render or integrator.render_path_with_counts
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu_ops else [])
    with profile(activities=acts) as prof:
        render(scene, view, cfg, seed)
        torch.cuda.synchronize()
    device_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in device_events) / 1e3
    ops = {}  # kernels of one label (instantiations) summed
    for e in prof.key_averages():
        if e.device_type != (DeviceType.CPU if cpu_ops else DeviceType.CUDA):
            continue
        key = e.key if cpu_ops else _kernel_label(e.key)
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        ops[key] = ops.get(key, 0.0) + dev_us / 1e3
    ops = sorted(ops.items(), key=lambda x: -x[1])
    return (busy_ms if device_events else None), ops[:top]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--binned", action="store_true",
                    help="profile the binned path (binned_secondary=8, binned_shadow=8)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_sample: torch.cuda.is_available() is false")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    g = builtin.atrium()
    scene, _ = flatten.flatten(g.root, device=dev)
    node, cam = flatten.find_camera(g.root)
    W, H = 1920, 1080
    view = camera.make_view(node.to_world(), cam.fovy, W, H, device=dev)
    cfg = integrator.RenderConfig(width=W, height=H, **BENCH, **(BINNED if args.binned else {}))
    integrator.render_path_with_counts(scene, view, cfg, 0)  # warm-up
    torch.cuda.synchronize()

    walls = []
    for s in (args.seed, args.seed + 1):
        t0 = time.perf_counter()
        integrator.render_path_with_counts(scene, view, cfg, s)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = sum(walls) / len(walls)
    print(f"[wall] plain samples {walls[0]:.3f} / {walls[1]:.3f} ms, mean {wall:.3f} ms")

    split = layer_split(scene, view, cfg, args.seed)
    binned_layers = ("emit", "sort_pad", "bin_step", "resolve") if args.binned else ()
    layers = ("prep", "kernel", "trace_other", *binned_layers, "finalize_hit", "glue")
    for layer in layers:
        print(f"[layer] {layer}: {split[layer]:.3f} ms "
              f"({100 * split[layer] / split['sample']:.1f} % of {split['sample']:.3f} ms)")
    print(f"[layer] calls: {split['calls']}")

    busy, ops = device_profile(scene, view, cfg, args.seed)
    if busy is None:
        print("[device] busy time not measured: the profiler recorded no device events")
    else:
        print(f"[device] busy {busy:.3f} ms of a {wall:.3f} ms plain sample "
              f"({100 * busy / wall:.1f} %)")
    for name, ms in ops:
        print(f"[device] op {name}: {ms:.3f} ms")
    print(smi)
    print(json.dumps(dict(
        device=smi, binned=args.binned, wall_ms=wall,
        split_ms={k: v for k, v in split.items() if k != "calls"},
        calls=split["calls"], device_busy_ms=busy,
        busy_share=None if busy is None else busy / wall,
        top_ops_ms=ops,
    )))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
