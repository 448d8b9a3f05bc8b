"""The port's CLI (``python -m stratum_tpu_torch.cli``), driven in-process
with ``--cpu`` on a 32x32 Cornell box: every integrator and post flag of
the reference's tests/test_cli.py that needs no loader beyond OBJ, the
loaders and ``--volume`` that are still ROADMAP Queue 1 item 7 raising
``NotImplementedError``, ``--envmap`` through the port's HDR reader, the
process-global samplers restored after a run, ``--sppBatch`` leaving the
image alone (rtol 1e-5), no card without ``--cpu`` raising, and one PFM
render against the JAX CLI at the same flags (``--tracer=brute``, mean
within 2 % relative, as test_torch_slice.py's bound).
"""

import numpy as np
import pytest
import torch

from stratum_tpu import cli as jcli
from stratum_tpu_torch import cli
from stratum_tpu_torch.core import rng as prng
from stratum_tpu_torch.io import image as pimage
from stratum_tpu_torch.render import lights as plights

torch.set_num_threads(2)


def _run(tmp_path, *args, out_name="out.png"):
    out = tmp_path / out_name
    rc = cli.main(["--cpu", "--scene=cornell", "--width=32", "--height=32", "--spp=2",
                   f"--out={out}", *args])
    assert rc == 0
    img = pimage.load_image(str(out))
    assert img.shape[:2] == (32, 32) and np.isfinite(img).all()
    return img


@pytest.mark.parametrize("args", [
    ("--tonemap=aces",),
    ("--integrator=direct",),
    ("--integrator=lt",),
    ("--integrator=bdpt", "--maxBounces=2"),
    ("--integrator=bdpt", "--maxBounces=2", "--lvcConnections=2", "--lvcReuse"),
    ("--integrator=restir", "--ris=2"),
    ("--adaptive", "--sampler=kron", "--spp=4"),
    ("--quality", "--spp=4"),
    ("--quality", "--adaptive=0", "--spp=4"),
    ("--denoise", "--tonemap=aces"),
    ("--denoise", "--tonemap=filmic", "--autoexposure", "--filterType=box3_subsampled",
     "--historyTap=1"),
    ("--denoise", "--denoiserDebug=variance"),
    ("--debug=normal",),
    ("--debug=path_length_2",),
    ("--sppLanes=2", "--spp=4"),
    ("--presampleLights=256", "--coherentTiles=16"),
    ("--waveCaps=1,1,0.5", "--tracer=brute"),
], ids=lambda a: "_".join(x.strip("-").split("=")[0] for x in a))
def test_cli_renders(tmp_path, args):
    img = _run(tmp_path, *args)
    if "--debug=path_length_2" not in args:
        assert img[..., :3].mean() > 0.005


def test_cli_hdr_output(tmp_path):
    img = _run(tmp_path, out_name="out.hdr")
    assert img.shape == (32, 32, 3)


def test_cli_unknown_integrator_fails(tmp_path):
    with pytest.raises(ValueError):
        _run(tmp_path, "--integrator=nope")


def test_cli_plugin_hook(tmp_path, monkeypatch):
    """--plugin=module imports the module and calls register(graph, opts)."""
    (tmp_path / "stratum_torch_test_plugin.py").write_text(
        "CALLS = []\n"
        "def register(graph, opts):\n"
        "    CALLS.append(graph.root.name)\n"
        "    graph.root.add_child('from_plugin')\n"
    )
    monkeypatch.syspath_prepend(str(tmp_path))
    _run(tmp_path, "--plugin=stratum_torch_test_plugin", "--spp=1")
    import stratum_torch_test_plugin

    assert stratum_torch_test_plugin.CALLS == ["root"]


def test_cli_unported_loaders_raise(tmp_path):
    gltf = tmp_path / "scene.gltf"
    gltf.write_text("{}")
    with pytest.raises(NotImplementedError, match="item 7"):
        cli.main(["--cpu", f"--scene={gltf}", f"--out={tmp_path / 'x.png'}"])
    with pytest.raises(NotImplementedError, match="item 7"):
        _run(tmp_path, f"--volume={tmp_path / 'smoke.vol'}")
    with pytest.raises(FileNotFoundError):
        cli.main(["--cpu", f"--scene={tmp_path / 'missing.obj'}"])


def test_cli_obj_and_envmap(tmp_path):
    """An OBJ scene (a camera synthesised to frame it) lit by an HDR
    environment read through the port's io/image.py."""
    obj = tmp_path / "quad.obj"
    obj.write_text("v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\nf 1 2 3\nf 1 3 4\n")
    env = np.full((8, 16, 3), 0.5, np.float32)
    env[:4] = 2.0
    pimage.write_hdr(str(tmp_path / "sky.hdr"), env)
    out = tmp_path / "o.pfm"
    assert cli.main(["--cpu", f"--scene={obj}", f"--envmap={tmp_path / 'sky.hdr'}",
                     "--width=16", "--height=16", "--spp=1", f"--out={out}"]) == 0
    img = pimage.load_image(str(out))
    assert np.isfinite(img).all() and img.max() > 0.4


def test_cli_restores_samplers(tmp_path):
    """--sampler=kron and --envSampler=mip are process-global while the
    render runs and restored after it, also when it raises."""
    _run(tmp_path, "--sampler=kron", "--envSampler=mip", "--spp=1")
    assert prng.QMC == "rand" and plights.ENV_SAMPLER == "dist2d"
    with pytest.raises(ValueError):
        _run(tmp_path, "--sampler=kron", "--integrator=nope")
    assert prng.QMC == "rand"


def test_cli_spp_batch_keeps_image(tmp_path):
    a = _run(tmp_path, "--spp=3", "--tracer=brute", out_name="a.pfm")
    b = _run(tmp_path, "--spp=3", "--tracer=brute", "--sppBatch=1", out_name="b.pfm")
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_cli_needs_a_card_without_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--cpu"):
        cli.main(["--scene=cornell", f"--out={tmp_path / 'x.png'}"])


def test_cli_matches_reference_cli(tmp_path):
    flags = ["--cpu", "--scene=cornell", "--width=24", "--height=24", "--spp=2",
             "--tracer=brute", "--maxBounces=3"]
    assert jcli.main(flags + [f"--out={tmp_path / 'j.pfm'}"]) == 0
    assert cli.main(flags + [f"--out={tmp_path / 'p.pfm'}"]) == 0
    j = pimage.load_image(str(tmp_path / "j.pfm"))
    p = pimage.load_image(str(tmp_path / "p.pfm"))
    assert p.shape == j.shape == (24, 24, 3)
    assert abs(p.mean() - j.mean()) <= 0.02 * j.mean(), (p.mean(), j.mean())


def test_cli_imports_no_jax(tmp_path):
    """The CLI and every module of the frame pipeline, in a fresh
    interpreter, render a denoised frame, a ReSTIR frame and a debug view
    without importing JAX or any module of the JAX package."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = (
        "import sys\n"
        "from stratum_tpu_torch import cli, version\n"
        "from stratum_tpu_torch.core import octahedral, quaternion, spline\n"
        "from stratum_tpu_torch.ops import anim\n"
        "from stratum_tpu_torch.render import aov, debug, denoise, flycamera, session, tonemap\n"
        f"out = {str(tmp_path / 'n.png')!r}\n"
        "for extra in (['--denoise', '--tonemap=aces'], ['--integrator=restir'],"
        " ['--debug=instance']):\n"
        "    assert cli.main(['--cpu', '--scene=cornell', '--width=16', '--height=16',"
        " '--spp=1', '--out=' + out] + extra) == 0\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "ref = [m for m in sys.modules if m == 'stratum_tpu' or m.startswith('stratum_tpu.')]\n"
        "assert not ref, ref\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(root))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"
