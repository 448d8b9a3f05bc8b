"""Nothing the harness, the reference or a whole run loads has ``jax`` or
``stratum_tpu`` (whole top-level names) among its modules, and the
reference loads nothing of the program."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _modules_after(code: str) -> list:
    probe = (code + "\nimport sys, json\n"
             "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = str(ROOT)
    p = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_the_reference_loads_nothing_of_the_program_or_jax():
    mods = _modules_after("import portbench.reference.intersect, portbench.reference.geometry, "
                          "portbench.reference.svgf, portbench.reference.path, portbench.check, "
                          "portbench.devtrace, "
                          "portbench.scenes.atrium")
    for bad in ("jax", "jaxlib", "flax", "stratum_tpu", "stratum_tpu_torch"):
        assert bad not in mods


def test_a_whole_run_loads_no_jax():
    code = ("from portbench import harness\nfrom portbench.tests import _tiny\n"
            "r = harness.run('atrium-frame', 9, 0.1, False, device='cpu', "
            "overrides=_tiny.overrides('atrium-frame'))\nassert r['correct'], r['check']\n"
            "assert harness.forbidden_modules() == []")
    mods = _modules_after(code)
    assert "stratum_tpu_torch" in mods
    for bad in ("jax", "jaxlib", "flax", "stratum_tpu"):
        assert bad not in mods
