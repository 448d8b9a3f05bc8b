"""The port's microbenchmark tools (stratum_tpu_torch/tools, T1-T4) against
the JAX package's tools in Pallas interpret mode, at small sizes.

The references run unchanged: T1 through its own ``run_inner(...,
interpret=True)``, T2 through its ``main()`` under
``pltpu.force_tpu_interpret_mode`` (its inputs swapped in through
``np.random.default_rng``, each variant's output caught at
``jax.block_until_ready``), T3 through its ``run`` under the same context,
and T4 through its ``_mm_kernel`` in a test-local ``pl.pallas_call`` with
scratch memory zeroed (``uninitialized_memory="zero"``: the reference never
zeroes its accumulator, and interpret mode's NaN fill would poison it).

Two input sets, from a seed with numpy:

* small integers: every product and sum is exact in any order, so the
  port's plain versions must give the reference's bits;
* standard normal values: within the tools' stated bounds (the packed
  argmin's 2^-13 band and the f32 error of the sums).

Each case asserts that its inputs commit (or, for the tools without a
commit, reach the output) on at least half of the lanes. The CUDA kernels
are held to the same plain versions on the card by ``chip_smoke.py`` phase 8
and by the ``cuda``-marked test here.
"""

from __future__ import annotations

import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from stratum_tpu_torch import tools
from stratum_tpu_torch.ops import mt_commit
from stratum_tpu_torch.tools import (
    bench_mxu_model,
    perf_commit_pipeline,
    perf_epilogue,
    probe_mxu_loop,
)

ROOT = Path(__file__).resolve().parent.parent
SETS = ("int", "normal")
NONZERO = np.array([-3, -2, -1, 1, 2, 3], np.float32)


@functools.lru_cache(maxsize=None)
def _ref(name):
    """tools/<name>.py of the JAX package, loaded as a module."""
    spec = importlib.util.spec_from_file_location(f"ref_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _values(rng, kind, shape, nonzero=False, scale=1.0):
    """f32 inputs times ``scale``: small integers (``nonzero`` leaves out 0)
    or standard normal values."""
    if kind == "int":
        x = rng.choice(NONZERO, shape) if nonzero else rng.integers(-3, 4, shape)
    else:
        x = rng.standard_normal(shape)
    return x.astype(np.float32) * np.float32(scale)


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


# ---- T1 -----------------------------------------------------------------------

T1_K, T1_ITERS = 16, 8


@pytest.mark.parametrize("kind", SETS)
@pytest.mark.parametrize("variant", perf_commit_pipeline.VARIANTS)
def test_commit_pipeline_matches_reference(variant, kind):
    """T1, every variant: run_inner against the reference's run_inner in
    interpret mode. ``bare`` and ``classify`` never commit and return
    3e38 + acc[0]: their operands are scaled by 2^58 so that acc reaches
    the output (products of ~1e35, past the 1e37 determinant cap in sums)."""
    rng = np.random.default_rng(31 + perf_commit_pipeline.VARIANTS.index(variant))
    k, lanes = T1_K, perf_commit_pipeline.lanes_of(variant)
    scale = 2.0 ** 58 if variant in ("bare", "classify") else 1.0
    rays = _values(rng, kind, (48, lanes), scale=scale)
    feat = _values(rng, kind, (4, 48, 4 * k), scale=scale)
    word = np.array([1, 0, 3, 1, 0, 1, 1, 2], np.int32)
    n = np.array([T1_ITERS - 2], np.int32)
    ref = np.asarray(_ref("perf_commit_pipeline").run_inner(
        jnp.asarray(rays).astype(jnp.bfloat16), jnp.asarray(feat).astype(jnp.bfloat16),
        jnp.asarray(word), jnp.asarray(n), variant, k, T1_ITERS, True))
    got = perf_commit_pipeline.run_inner(
        _bf16(rays), _bf16(feat), torch.from_numpy(word), torch.from_numpy(n),
        variant, k, T1_ITERS)
    assert got.shape == (2, 128) and got.dtype == torch.float32
    got = got.numpy()
    if variant in ("bare", "classify"):
        reached = ref[0] != np.float32(3e38)
        assert reached.mean() >= 0.5, reached.mean()
    else:
        assert (ref[1] >= 0).mean() >= 0.5, (ref[1] >= 0).mean()
    if kind == "int":
        np.testing.assert_array_equal(_bits(got), _bits(ref))
        return
    # equal values (inf included: a ring lane whose last visit had no hit)
    # differ by 0
    with np.errstate(invalid="ignore"):
        diff = np.where(got[0] == ref[0], 0.0, np.abs(got[0].astype(np.float64) - ref[0]))
    same = got[1] == ref[1]
    tol = perf_commit_pipeline.tolerance(_bf16(rays), _bf16(feat), k, T1_ITERS, variant,
                                         torch.from_numpy(ref.copy())).numpy()
    assert np.all(same | (diff <= tol)), "slots differ beyond a near-tie"
    assert np.all(diff[same] <= tol[same]), (diff / tol)[same].max()


@pytest.mark.parametrize("variant", ["epi", "epi_drain", "ring", "epi_w256"])
def test_commit_pipeline_ctas_are_independent(variant):
    """Rays of several CTAs side by side (how the card-full timing launches
    T1): each CTA's [2, 128] columns equal the reference's run_inner on that
    CTA's lanes alone, bit for bit on the integer set (``epi_drain`` and
    ``ring`` gate on a min over one CTA's lanes)."""
    rng = np.random.default_rng(41 + perf_commit_pipeline.VARIANTS.index(variant))
    k, lanes, ctas = T1_K, perf_commit_pipeline.lanes_of(variant), 3
    rays = _values(rng, "int", (48, ctas * lanes))
    feat = _values(rng, "int", (4, 48, 4 * k))
    word = np.array([1, 0, 3, 1, 0, 1, 1, 2], np.int32)
    n = np.array([T1_ITERS - 2], np.int32)
    got = perf_commit_pipeline.run_inner(
        _bf16(rays), _bf16(feat), torch.from_numpy(word), torch.from_numpy(n),
        variant, k, T1_ITERS)
    assert got.shape == (2, ctas * 128)
    for c in range(ctas):
        ref = np.asarray(_ref("perf_commit_pipeline").run_inner(
            jnp.asarray(rays[:, c * lanes:(c + 1) * lanes]).astype(jnp.bfloat16),
            jnp.asarray(feat).astype(jnp.bfloat16), jnp.asarray(word), jnp.asarray(n),
            variant, k, T1_ITERS, True))
        assert (ref[1] >= 0).mean() >= 0.5
        np.testing.assert_array_equal(_bits(got[:, c * 128:(c + 1) * 128].numpy()), _bits(ref))


def test_commit_pipeline_reference_operands_never_commit():
    """The reference's own timing operands (uniform [0, 0.5)) commit no
    candidate (perf_commit_pipeline.py:43-46): every variant returns 3e38
    and slot -1, or inf for ``ring``, in both implementations."""
    k, iters = 16, 8
    for variant in perf_commit_pipeline.VARIANTS:
        args = perf_commit_pipeline.operands(variant, k, iters, "cpu")
        got = perf_commit_pipeline.run_inner(*args, variant, k, iters).numpy()
        ref = np.asarray(_ref("perf_commit_pipeline").run_inner(
            *(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in args[:2]),
            jnp.asarray(args[2].numpy()), jnp.asarray(args[3].numpy()),
            variant, k, iters, True))
        np.testing.assert_array_equal(_bits(got), _bits(ref))
        assert np.all(got[1] == -1)
        assert np.all(got[0] == (np.inf if variant == "ring" else np.float32(3e38)))


# ---- T2 -----------------------------------------------------------------------


class _Rng:
    """Stands in for np.random.default_rng in the reference's main(): hands
    out the given arrays in the order main() draws them."""

    def __init__(self, *arrays):
        self.arrays = list(arrays)

    def standard_normal(self, shape):
        x = self.arrays.pop(0)
        assert x.shape == shape
        return x


def _epilogue_reference(monkeypatch, slab, rays, k, sw, iters):
    """Each variant's output of perf_epilogue.main() in interpret mode."""
    ref = _ref("perf_epilogue")
    caught = []
    block = jax.block_until_ready

    def catch(x):
        caught.append(np.asarray(x))
        return block(x)

    with monkeypatch.context() as mp:
        mp.setattr(np.random, "default_rng", lambda seed: _Rng(slab, rays))
        mp.setattr(jax, "block_until_ready", catch)
        mp.setattr(sys, "argv", ["perf_epilogue", f"--k={k}", f"--sw={sw}",
                                 f"--iters={iters}", "--reps=1"])
        with pltpu.force_tpu_interpret_mode():
            ref.main()
    # main() waits twice per variant: after its warm-up call and its timed loop
    return dict(zip(perf_epilogue.VARIANTS, caught[1::2]))


@pytest.mark.parametrize("kind", SETS)
def test_epilogue_matches_reference(monkeypatch, kind):
    """T2, all five variants: run against the reference's main(). The rays
    of the integer set leave out 0, so the f32 perturbation rays + i * 1e-9
    rounds away and the products stay exact."""
    k, sw, iters = 64, 128, 4
    rng = np.random.default_rng(7)
    slab = _values(rng, kind, (48, 4 * k))
    rays = _values(rng, kind, (48, sw), nonzero=True)
    refs = _epilogue_reference(monkeypatch, slab, rays, k, sw, iters)
    assert list(refs) == list(perf_epilogue.VARIANTS)
    for variant, ref in refs.items():
        got = perf_epilogue.run(_bf16(slab), _bf16(rays), variant, k, sw, iters)
        assert got.shape == (1, sw)
        got = got.numpy()
        if variant != "none":
            assert (ref < np.float32(3e38)).mean() >= 0.5, variant
        if kind == "int":
            np.testing.assert_array_equal(_bits(got), _bits(ref), err_msg=variant)
        else:
            np.testing.assert_array_less(np.abs(got - ref), perf_epilogue.REL_TOL * np.abs(ref)
                                         + 1e-30, err_msg=variant)


def test_epilogue_f32_rays_are_not_rounded():
    """The perturbed rays are f32 and the product uses them unrounded (the
    finding the kernel's three-part split rests on): an all-ones slab
    against rays of 1 + 2^-12, in the plain version as in interpret mode."""
    slab = torch.ones((48, 4 * 8), dtype=torch.bfloat16)
    r = torch.full((48, 128), 1 + 2.0 ** -12)
    assert float(mt_commit.mt_product(slab, r)[0, 0]) == 48 * (1 + 2.0 ** -12)
    out = jax.lax.dot_general(jnp.asarray(slab.float().numpy()).astype(jnp.bfloat16),
                              jnp.asarray(r.numpy()), (((0,), (0,)), ((), ())),
                              preferred_element_type=jnp.float32)
    assert float(out[0, 0]) == 48 * (1 + 2.0 ** -12)


# ---- T3 -----------------------------------------------------------------------


@pytest.mark.parametrize("kind", SETS)
@pytest.mark.parametrize("dep", [False, True])
def test_mxu_loop_matches_reference(kind, dep):
    """T3 at dep 0 and 1: run against the reference's run in interpret mode
    (rays without 0 in the integer set: rays + bf16(carry) stays exact)."""
    k, iters = 32, 8
    rng = np.random.default_rng(11 + dep)
    rays = _values(rng, kind, (48, 128), nonzero=True)
    feat = _values(rng, kind, (4, 48, 4 * k))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(_ref("probe_mxu_loop").run(
            jnp.asarray(rays).astype(jnp.bfloat16), jnp.asarray(feat).astype(jnp.bfloat16),
            iters, dep))
    got = probe_mxu_loop.run(_bf16(rays), _bf16(feat), iters, dep)
    assert got.shape == (1, 128)
    got = got.numpy()
    assert (ref != 0).mean() >= 0.5
    if kind == "int":
        np.testing.assert_array_equal(_bits(got), _bits(ref))
    else:
        tol = probe_mxu_loop.tolerance(_bf16(rays), _bf16(feat), iters).numpy()
        np.testing.assert_array_less(np.abs(got - ref), tol)


# ---- T4 -----------------------------------------------------------------------


def _model_reference(a, b, iters, passes, reps):
    m, nb = a.shape[1], b.shape[1]
    kernel = functools.partial(_ref("bench_mxu_model")._mm_kernel,
                               iters=iters, passes=passes, reps=reps)
    with pltpu.force_tpu_interpret_mode(pltpu.InterpretParams(uninitialized_memory="zero")):
        call = pl.pallas_call(
            kernel,
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((m, nb), jnp.float32),
            scratch_shapes=[pltpu.VMEM((m, nb), jnp.float32)],
        )
        return np.asarray(jax.jit(call)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("kind", SETS)
@pytest.mark.parametrize("reps", [1, 8])
@pytest.mark.parametrize("passes", [0, 1, 5])
@pytest.mark.parametrize("c", [8, 16, 128])
def test_mxu_model_matches_reference(c, passes, reps, kind):
    """T4: run against _mm_kernel in interpret mode with zeroed scratch. In
    the integer set b >= 0, so b * fi + p never cancels to a tiny non-integer
    (-1.0000001 + 1 would) and every pass operand stays an integer."""
    iters, m, nb = 4, 16 * reps, 32
    rng = np.random.default_rng(100 * c + 10 * passes + reps)
    a = _values(rng, kind, (c, m))
    b = np.abs(_values(rng, kind, (c, nb))) if kind == "int" else _values(rng, kind, (c, nb))
    ref = _model_reference(a, b, iters, passes, reps)
    got = bench_mxu_model.run(torch.from_numpy(a), torch.from_numpy(b), iters, passes, reps)
    assert got.shape == (m, nb)
    got = got.numpy()
    assert np.isfinite(ref).all() and (ref != 0).mean() >= 0.5
    if kind == "int":
        np.testing.assert_array_equal(_bits(got), _bits(ref))
    else:
        tol = bench_mxu_model.tolerance(torch.from_numpy(a), torch.from_numpy(b), iters,
                                        passes).numpy()
        np.testing.assert_array_less(np.abs(got - ref), tol + 1e-30)


def test_mxu_model_zeroes_its_accumulator():
    """The reference's accumulator is never zeroed (bench_mxu_model.py:35-73):
    interpret mode's default NaN fill comes through, while with zeroed
    scratch it gives 15360 for C=16, passes=3 at ITERS=512 (a = 0.5, b =
    0.25), which the port gives from its own zeroed start."""
    a = np.full((16, 64), 0.5, np.float32)
    b = np.full((16, 32), 0.25, np.float32)
    got = bench_mxu_model.run(torch.from_numpy(a), torch.from_numpy(b), 512, 3, 1)
    assert torch.all(got == 15360.0)
    np.testing.assert_array_equal(_model_reference(a, b, 512, 3, 1), got.numpy())
    kernel = functools.partial(_ref("bench_mxu_model")._mm_kernel, iters=2, passes=1, reps=1)
    with pltpu.force_tpu_interpret_mode():
        call = pl.pallas_call(
            kernel, in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((64, 32), jnp.float32),
            scratch_shapes=[pltpu.VMEM((64, 32), jnp.float32)])
        assert np.isnan(np.asarray(jax.jit(call)(jnp.asarray(a), jnp.asarray(b)))).all()


# ---- the tools' command lines ------------------------------------------------


@pytest.mark.parametrize("tool, argv, lines", [
    (perf_commit_pipeline, ["--cpu", "--k=16", "--iters=4", "--base_iters=2"], 10),
    (perf_epilogue, ["--cpu", "--k=16", "--sw=128", "--iters=2", "--reps=1"], 7),
    (probe_mxu_loop, ["--cpu", "--k=16"], 5),
    (bench_mxu_model, ["--cpu"], 3),
])
def test_tool_cli(monkeypatch, capsys, tool, argv, lines):
    """Each tool's main(["--cpu", ...]) runs its plain versions and prints
    the reference's table (trip counts and cases cut for the CPU)."""
    monkeypatch.setattr(probe_mxu_loop, "TRIPS", (2, 4))
    monkeypatch.setattr(bench_mxu_model, "ITERS", 2)
    monkeypatch.setattr(bench_mxu_model, "CASES", [
        ("C=16", 16, 64, 32, 3, 1), ("C=8, reps 2", 8, 128, 32, 3, 2)])
    results = tool.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("devices: cpu") and len(out) == lines, out
    assert results


def test_tools_refuse_a_cpu_default_without_a_card():
    """Without --cpu the tools run on the card and raise where there is none;
    the kernel wrappers take CUDA tensors only."""
    from stratum_tpu_torch.utils.flags import Options

    if torch.cuda.is_available():
        assert tools.device_of(Options([])).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            tools.device_of(Options([]))
    assert tools.device_of(Options(["--cpu"])).type == "cpu"
    with pytest.raises(ValueError):
        tools.check(torch.zeros(4), "x", torch.float32, (4,))


@pytest.mark.cuda
def test_kernels_match_plain_on_gpu():
    """T1-T4 kernels against their plain versions on the card, integer sets
    (bit for bit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(5)
    k, iters = 64, 6
    for variant in perf_commit_pipeline.VARIANTS:
        lanes = perf_commit_pipeline.lanes_of(variant)
        rays = _bf16(_values(rng, "int", (48, lanes))).to(dev)
        feat = _bf16(_values(rng, "int", (4, 48, 4 * k))).to(dev)
        word = torch.tensor([1, 0, 3, 1, 0, 1, 1, 2], dtype=torch.int32, device=dev)
        n = torch.tensor([iters - 1], dtype=torch.int32, device=dev)
        got = perf_commit_pipeline.run_inner(rays, feat, word, n, variant, k, iters)
        want = perf_commit_pipeline.run_inner_plain(rays, feat, word, n, variant, k, iters)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), variant
        rays = _bf16(_values(rng, "int", (48, 3 * lanes))).to(dev)  # three CTAs
        got = perf_commit_pipeline.run_inner(rays, feat, word, n, variant, k, iters)
        want = perf_commit_pipeline.run_inner_plain(rays, feat, word, n, variant, k, iters)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (variant, 3)
    slab = _bf16(_values(rng, "int", (48, 4 * k))).to(dev)
    rays = _bf16(_values(rng, "int", (48, 256), nonzero=True)).to(dev)
    for variant in perf_epilogue.VARIANTS:
        got = perf_epilogue.run(slab, rays, variant, k, 256, iters)
        want = perf_epilogue.run_plain(slab, rays, variant, k, 256, iters)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), variant
    rays = rays[:, :128].contiguous()
    feat = _bf16(_values(rng, "int", (4, 48, 4 * k))).to(dev)
    for dep in (False, True):
        got = probe_mxu_loop.run(rays, feat, iters, dep)
        assert torch.equal(got, probe_mxu_loop.run_plain(rays, feat, iters, dep))
    for c, passes, reps in ((8, 3, 1), (16, 0, 1), (128, 5, 2)):
        a = torch.from_numpy(_values(rng, "int", (c, 128))).to(dev)
        b = torch.from_numpy(np.abs(_values(rng, "int", (c, 64)))).to(dev)
        got = bench_mxu_model.run(a, b, iters, passes, reps)
        assert torch.equal(got, bench_mxu_model.run_plain(a, b, iters, passes, reps))
