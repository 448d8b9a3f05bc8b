"""The port's image metrics, profiler and the compare / inspect tools
(stratum_tpu_torch/utils/{compare,profiler}.py, tools/{compare,inspect}.py)
against the JAX package's.

Bounds: the metrics within 1e-6 relative of their float64 value and
within 2e-6 of the reference's (its float32 mean is itself 1.0e-6 off the
float64 one on the test's MSE);
the tools' printed lines equal, their numbers (6 significant digits)
within 1e-5 relative; the profiler's tree and report equal but for the
times.
"""

import re

import numpy as np
import pytest
import torch

from stratum_tpu.tools import compare as jtcompare
from stratum_tpu.tools import inspect as jinspect
from stratum_tpu.utils import compare as jcompare
from stratum_tpu.utils import profiler as jprofiler
from stratum_tpu_torch.io import image as pimage
from stratum_tpu_torch.tools import compare as ptcompare
from stratum_tpu_torch.tools import inspect as pinspect
from stratum_tpu_torch.utils import compare as pcompare
from stratum_tpu_torch.utils import profiler as pprofiler

REL = 1e-6  # the port against the float64 value
REF_REL = 2e-6  # the port against the reference
PRINT_REL = 1e-5


def _images(seed=0, shape=(24, 40, 3)):
    rng = np.random.default_rng(seed)
    a = rng.random(shape).astype(np.float32) * 2.0
    return a, (a + rng.normal(0, 0.1, shape)).astype(np.float32)


def _float64(metric, a, b=None):
    """The metric in float64 from the float32 inputs."""
    a = a.astype(np.float64)
    if metric == "average":
        return float(a.mean())
    b = b.astype(np.float64)
    d = a - b
    return float({"mse": (d * d).mean(), "rmse": np.sqrt((d * d).mean()),
                  "smape": (np.abs(d) / (np.abs(a) + np.abs(b) + 1e-2)).mean(),
                  "relative_mse": (d * d / (b * b + 1e-2)).mean()}[metric])


@pytest.mark.parametrize("metric", ["mse", "rmse", "smape", "relative_mse", "average"])
def test_metrics_match_reference(metric):
    a, b = _images()
    args = (a,) if metric == "average" else (a, b)
    want = float(getattr(jcompare, metric)(*args))
    got = getattr(pcompare, metric)(*(torch.from_numpy(x) for x in args))
    assert torch.is_tensor(got) and got.dtype == torch.float32 and got.device.type == "cpu"
    assert float(got) == pytest.approx(want, rel=REF_REL)
    assert float(got) == pytest.approx(_float64(metric, *args), rel=REL)
    # numpy inputs go to the CPU; a tensor's device is kept
    assert float(getattr(pcompare, metric)(*args)) == float(got)


def _numbers(text):
    return [float(x) for x in re.findall(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?", text)]


def _same_lines(want, got):
    want, got = want.strip().splitlines(), got.strip().splitlines()
    assert len(want) == len(got), (want, got)
    for w, g in zip(want, got):
        assert re.sub(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?", "#", w) == re.sub(
            r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?", "#", g), (w, g)
        np.testing.assert_allclose(_numbers(g), _numbers(w), rtol=PRINT_REL)


def test_compare_tool_matches_reference(tmp_path, capsys):
    a, b = _images(1)
    pimage.save_image(str(tmp_path / "a.pfm"), a)
    pimage.save_image(str(tmp_path / "b.pfm"), b)
    for extra in ([], ["--quantize=8"], ["--metric=smape"]):
        args = [str(tmp_path / "a.pfm"), str(tmp_path / "b.pfm"), *extra]
        assert jtcompare.main(args) == 0
        want = capsys.readouterr().out
        assert ptcompare.main(["--cpu", *args]) == 0
        _same_lines(want, capsys.readouterr().out)
    args = [str(tmp_path / "a.pfm"), str(tmp_path / "b.pfm"), f"--diff={tmp_path / 'd.png'}"]
    assert jtcompare.main([*args[:2], f"--diff={tmp_path / 'jd.png'}"]) == 0
    assert ptcompare.main(["--cpu", *args]) == 0
    np.testing.assert_array_equal(pimage.read_png(tmp_path / "d.png"),
                                  pimage.read_png(tmp_path / "jd.png"))
    assert pimage.read_png(tmp_path / "d.png").shape == (24, 40, 3)
    assert ptcompare.main([str(tmp_path / "a.pfm")]) == 1
    capsys.readouterr()


def test_compare_tool_needs_a_card_without_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    a, b = _images(1)
    pimage.save_image(str(tmp_path / "a.pfm"), a)
    pimage.save_image(str(tmp_path / "b.pfm"), b)
    with pytest.raises(RuntimeError, match="--cpu"):
        ptcompare.main([str(tmp_path / "a.pfm"), str(tmp_path / "b.pfm")])


def test_inspect_tool_matches_reference(capsys):
    """The tree, the counts, the materials, the lights, the BVH line and
    a pick on the Cornell box; the tensor list is the port's own (its
    scene holds other fields) and is only checked for its total."""
    args = ["--scene=cornell", "--flatten", "--pick=16,20", "--width=32", "--height=32"]
    assert jinspect.main(args) == 0
    want = capsys.readouterr().out
    assert pinspect.main(["--cpu", *args]) == 0
    got = capsys.readouterr().out

    def sections(text):
        head, _, rest = text.partition("\ndevice buffers:\n")
        buffers, _, tail = rest.partition("\nmaterials:\n")
        return head, buffers, tail

    wh, _, wt = sections(want)
    gh, gb, gt = sections(got)
    _same_lines(wh, gh)
    _same_lines(wt, gt)
    assert "total device memory" in gb and ".slot_payload" in gb
    assert pinspect.main(["--scene=cornell"]) == 0  # the tree alone needs no device
    tree = capsys.readouterr().out.splitlines()
    assert len(tree) > 5 and tree == want.splitlines()[:len(tree)]


def test_profiler_tree_and_report(tmp_path):
    """The same regions give the reference's tree and report (times
    aside); ``sync=`` takes a tensor or a device; ``device_trace`` writes a
    Chrome trace."""
    reports = []
    for mod in (jprofiler, pprofiler):
        prof = mod.Profiler()
        for frame in range(3):
            prof.begin_frame()
            with prof.region("render"):
                with prof.region("trace", sync=None):
                    pass
                with prof.region("shade"):
                    pass
            with prof.region("denoise"):
                pass
            prof.end_frame()
        reports.append(re.sub(r"\d+\.\d+", "#", prof.report()))
    assert reports[0] == reports[1]
    assert reports[1].splitlines()[0].startswith("frames: 2  mean # ms")
    assert [ln.split()[0] for ln in reports[1].splitlines()[1:]] == [
        "frame", "render", "trace", "shade", "denoise"]
    prof = pprofiler.Profiler()
    x = torch.ones(4)
    with prof.region("a", sync=x):
        with prof.region("b", sync="cpu"):
            y = x * 2
    assert float(y.sum()) == 8.0
    tree = prof.report().splitlines()
    assert tree[0].startswith("frame") and tree[1].strip().startswith("a") and \
        tree[2].startswith("    b")
    prof.enabled = False
    with prof.region("off"):
        pass
    assert "off" not in prof.report()
    with pprofiler.PROFILER.device_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
