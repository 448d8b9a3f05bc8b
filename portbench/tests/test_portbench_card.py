"""A short run of a cell on the card; skips without one (decided inside
the test). On the chip: python -m pytest --noconftest -p no:cacheprovider
portbench/tests/test_portbench_card.py -m cuda -q"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
def test_atrium_path_runs_correct_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "atrium-path",
                        "--seed", "2147483659", "--seconds", "3", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu", r["check"]
    assert list(r)[-1] == "check"
