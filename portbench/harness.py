"""One run of one cell: set-up, the measured window, the traced stretch,
the check, and the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration file, ``portbench/scenes/<scene>.py``, the traffic mix
``portbench/traffic/<traffic>.json`` and its driver
``portbench/drivers/<driver>.py``, each metric's reader
``portbench/metrics/<metric>.py`` and the cell's limits
``portbench/limits/<workload>.json``. Adding a cell, a configuration, a mix
or a metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "stratum_tpu")  # whole top-level module names


def process_age_s() -> float | None:
    """Seconds since this process started (Linux), else None."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return None


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_json(path: Path):
    return json.loads(Path(path).read_text())


def load_file_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(f"portbench_file_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(bench: dict, workload: str) -> dict:
    """Everything a run of ``workload`` reads, found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    conf = load_json(ROOT / config["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")

    def applies(metric, reported=None):
        ws = metric.get("workloads")
        if ws is not None:
            return workload in ws
        return reported is None or metric["moves"] in reported

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if applies(m, names)]
    return dict(cell=cell, config=conf, traffic=traffic, end_to_end=e2e, per_layer=layer,
                limits=load_json(HERE / "limits" / f"{workload}.json"))


def set_cache_dirs(root: Path):
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = root / "build" / "portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(cache / sub)


def card_name_and_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def build_program_scene(raw: dict):
    """The benchmark's scene handed to the program: a scene graph of the
    raw meshes."""
    import numpy as np
    from stratum_tpu_torch.scene import graph
    from stratum_tpu_torch.scene.material import Material

    g = graph.NodeGraph()
    for m in raw["meshes"]:
        node = g.root.add_child(m["name"])
        if m["matrix"] is not None:
            node.make_component(graph.TransformComponent(matrix=np.asarray(m["matrix"],
                                                                           np.float32)))
        mat = m["material"]
        node.make_component(graph.MeshPrimitive(
            positions=m["positions"], indices=m["indices"],
            material=Material(base_color=np.asarray(mat["base_color"], np.float32),
                              emission=np.asarray(mat["emission"], np.float32),
                              metallic=float(mat.get("metallic", 0.0)),
                              roughness=float(mat.get("roughness", 1.0)))))
    env = g.root.add_child("env")
    env.make_component(graph.EnvironmentComponent(
        color=np.asarray(raw["environment"], np.float32)))
    return g


def draw_judged(seed: int, ranges: list) -> list:
    """Call indices whose outputs the check judges: from each ``[lo, hi,
    step]`` or ``[lo, hi, step, run]`` range one call drawn and the ``run
    - 1`` calls after it (consecutive frames), distinct."""
    import numpy as np

    seed %= 1 << 64
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 7])
    out = []
    for lo, hi, step, *run in ranges:
        n = run[0] if run else 1
        choices = [i for i in range(lo, hi, step) if not set(range(i, i + n)) & set(out)]
        first = int(rng.choice(choices))
        out.extend(range(first, first + n))
    return sorted(out)


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        overrides: dict | None = None, control: bool = False) -> dict:
    """One run -> the result dict (the result line's keys). ``device`` and
    ``overrides`` (configuration keys replaced) serve the CPU tests;
    ``control`` adds the control's readings (``control.py``)."""
    t_begin = time.perf_counter()
    bench = load_json(ROOT / "BENCHMARK.json")
    spec = cell_spec(bench, workload)
    conf = dict(spec["config"])
    conf.update(overrides or {})
    traffic = spec["traffic"]
    set_cache_dirs(ROOT)

    import torch

    from portbench import check, devtrace, hooks

    if device == "cuda":
        want = int(spec["cell"]["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < want:
            raise NoCard(f"portbench: needs {want} CUDA device(s); "
                         f"torch.cuda.is_available() = {torch.cuda.is_available()}")
        dev = torch.device("cuda:0")
        torch.cuda.init()
        # the issuing thread on one core of its own (CUDA's threads, started
        # above, stay free): the runs of a cell spread less
        os.sched_setaffinity(0, {sorted(os.sched_getaffinity(0))[-1]})
        torch.cuda.reset_peak_memory_stats(dev)
    else:
        dev = torch.device(device)

    from stratum_tpu_torch.render import camera, integrator
    from stratum_tpu_torch.scene import flatten
    from stratum_tpu_torch.utils import cuda_build

    if dev.type == "cuda":
        cuda_build.load("block_trace")  # the only kernel source the path launches

    # -- the scene: generated, handed over, loaded and flattened ------------
    scene_mod = importlib.import_module(f"portbench.scenes.{conf['scene']}")
    workdir = ROOT / "build" / "portbench" / "scenes" / workload
    raw = scene_mod.build({**conf.get("scene_params", {}), "camera": conf["camera"]}, seed,
                          workdir)
    t0 = time.perf_counter()
    g = build_program_scene(raw)
    scene, _ = flatten.flatten(g.root, env_probability=float(conf["env_probability"]),
                               device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    flatten_s = time.perf_counter() - t0

    W, H = int(conf["width"]), int(conf["height"])
    cfg = integrator.RenderConfig(width=W, height=H, **conf["render"])
    if integrator.resolved_tracer(scene, cfg) != "pallas":
        raise RuntimeError("portbench: the cell must run the block tracer (K1/K2)")
    tracer = devtrace.Tracer()
    judged = draw_judged(seed, traffic["judge_calls"])
    hk = hooks.Hooks(dev, seed, W * H, int(conf["check"]["lanes"]), tracer)
    outputs: dict = {}

    def output(i, **kw):
        if i in judged:
            outputs[i] = kw

    ctx = SimpleNamespace(
        device=dev, scene=scene, cfg=cfg, seed=seed, seed_base=1 + seed % (1 << 24),
        view=camera.make_view(raw["camera"]["camera_to_world"], raw["camera"]["fovy"], W, H,
                              device=dev),
        make_view=lambda c2w: camera.make_view(c2w, raw["camera"]["fovy"], W, H, device=dev),
        tracer=tracer, output=output)
    drv = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    params = traffic["params"]
    units = drv.units(params)
    state = drv.setup(ctx, params)
    hk.install()
    records = []
    try:
        drv.warm(ctx, state)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        age = process_age_s()
        setup_s = age if age is not None else time.perf_counter() - t_begin

        # -- the window: a closed loop of calls, ending in a synchronise ---
        trace_first, trace_calls = int(traffic["trace_skip"]), int(traffic["trace_calls"])
        call_s, stretch = [], None
        i = 0
        t_start = time.perf_counter()
        end = t_start + seconds
        while True:
            if trace and i == trace_first:
                torch.cuda.synchronize(dev)
                tracer.start()
                t_a = time.perf_counter()
            judging = i in judged
            if judging:
                hk.begin(i)
            t_c = time.perf_counter()
            drv.call(ctx, state, i)
            call_s.append(time.perf_counter() - t_c)
            if judging:
                records.append(hk.end())
            i += 1
            if trace and i == trace_first + trace_calls:
                torch.cuda.synchronize(dev)
                stretch_window = time.perf_counter() - t_a
                stretch = tracer.stop(stretch_window, trace_calls * units)
            done = (time.perf_counter() >= end and i > max(judged)
                    and (not trace or stretch is not None))
            if done:
                break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall_s = time.perf_counter() - t_start
    finally:
        hk.remove()
    calls = i
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kind = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    card = card_name_and_limit() if dev.type == "cuda" else "cpu"

    # -- metrics ------------------------------------------------------------
    reading = SimpleNamespace(setup_s=setup_s, wall_s=wall_s, calls=calls, units=units,
                              call_s=call_s, flatten_s=flatten_s, stretch=stretch)
    metrics = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]):
        reader = load_file_module(HERE / "metrics" / f"{m['name']}.py", m["name"])
        value = reader.read(reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # -- the check, with the program's state freed ---------------------------
    for rec in records:
        rec.update(outputs.get(rec["index"], {}))
    del state, scene, g
    ctx.scene = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.judge(raw, conf, records, dev, W, H, seed)
    limits = spec["limits"]
    verdict = check.verdict(numbers, limits)
    result = dict(
        correct=all(ok for _, _, _, ok in verdict) and bool(records),
        attempted=calls * units,
        failed=check.failed_calls(numbers, limits),
        metrics=metrics,
        device=dict(platform="gpu" if dev.type == "cuda" else dev.type, kind=kind,
                    count=int(spec["cell"]["chips"]) if dev.type == "cuda" else 0,
                    memory_peak_bytes=int(peak)),
        card=card,
    )
    if trace and stretch is not None:
        result["device"].update(busy_s=devtrace.busy_s(stretch), window_s=stretch.window_s)
        result["breakdown"] = dict(device_ops=devtrace.top_ops(stretch),
                                   idle_gaps=devtrace.idle_gaps(stretch))
    if control:
        result["control"] = check.verdict(
            check.judge(raw, conf, records, dev, W, H, seed, control=True), limits)
    mean = sum(call_s) / len(call_s)
    result["window"] = dict(calls=calls, wall_s=wall_s, call_ms_mean=mean * 1e3,
                            call_ms_sd=(sum((c - mean) ** 2 for c in call_s)
                                        / max(len(call_s) - 1, 1)) ** 0.5 * 1e3)
    result["judged"] = numbers["counts"]
    result["check"] = {name: [value, limit] for name, value, limit, _ in verdict}
    return result


class NoCard(RuntimeError):
    pass
