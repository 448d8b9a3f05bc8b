"""BENCHMARK.json against the contract's shape, every file a cell needs
found by name, and a new cell added by files and entries alone."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 2 + 14 * 24 <= 43200 and (2 + 14 * 24) * (BENCH["run_seconds"] + 60) \
        + 24 * 180 + 1200 <= 43200
    assert len(BENCH["command"]) <= 32 and all(_text_ok(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/")
        assert not p.endswith("_torch") and ".." not in p


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}[section]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        assert set(e) - {"workloads"} == keys, e
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert _text_ok(e[k]), e
        if section == "configs":
            assert all(NAME.match(k) for k in e["reduced"]) and len(e["reduced"]) <= 16
        if section == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"]) and e["chips"] in (1, 4)
        if section == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0 < e["bound"] <= 0.25
        if section == "per_layer":
            assert e["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
            assert e["moves"] in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(cell):
    from portbench import harness

    spec = harness.cell_spec(BENCH, cell)
    conf = spec["config"]
    assert (PB / "scenes" / f"{conf['scene']}.py").is_file()
    assert (PB / "drivers" / f"{spec['traffic']['driver']}.py").is_file()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (PB / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"}
    assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
    for m in spec["per_layer"]:  # each reports the end-to-end metric it moves
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
    assert spec["limits"]
    files = {c["name"]: c["file"] for c in BENCH["configs"]}
    assert files[spec["cell"]["config"]].startswith("portbench/")


def test_four_chip_cells_and_pairs():
    cells = BENCH["workloads"]
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


def test_a_new_cell_takes_only_new_files(tmp_path):
    """Copy the benchmark, add a configuration, a traffic mix, a metric and
    a cell as new files and entries, and run the new cell on the CPU."""
    from portbench.tests import _tiny

    shutil.copytree(PB, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    new = tmp_path / "portbench"
    conf = json.loads((new / "configs" / "atrium.json").read_text())
    conf.update(_tiny.overrides("atrium"))
    (new / "configs" / "atrium_small.json").write_text(json.dumps(conf))
    mix = json.loads((new / "traffic" / "progressive.json").read_text())
    mix["params"]["warm_calls"] = 1
    (new / "traffic" / "progressive_short.json").write_text(json.dumps(mix))
    (new / "metrics" / "calls_done.py").write_text("def read(r):\n    return r.calls\n")
    (new / "limits" / "small-path.json").write_text(
        (new / "limits" / "atrium-path.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="atrium_small",
                                 file="portbench/configs/atrium_small.json"))
    bench["workloads"].append(dict(name="small-path", config="atrium_small",
                                   traffic="progressive_short", chips=1, why="a test cell"))
    for m in bench["end_to_end"]:
        if m["name"] == "ms_per_spp":
            m["workloads"].append("small-path")
    bench["end_to_end"].append(dict(name="calls_done", unit="calls", better="higher",
                                    bound=0.25, source="host_clock",
                                    workloads=["small-path"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json; from portbench import harness; "
            "r = harness.run('small-path', 5, 0.2, False, device='cpu'); "
            "print(json.dumps([r['correct'], sorted(r['metrics'])]))")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    correct, metrics = json.loads(p.stdout.strip().splitlines()[-1])
    assert correct and metrics == ["calls_done", "ms_per_spp", "setup_s"]
