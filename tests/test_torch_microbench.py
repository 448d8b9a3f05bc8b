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
from stratum_tpu_torch.utils import cuda_build

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
        cuda_build.check(torch.zeros(4), "x", torch.float32, (4,), torch.device("cpu"))


@pytest.mark.parametrize("flops, tests, ops, clock, tensor_us, epilogue_us, by", [
    # T1 epi at k = 1024: 2 x 48 x 4096 x 128 flop; 128 x 1024 tests of
    # 14 fp32 + 12.84375 alu + 6.5 other instructions at 1.98 GHz: issue
    # 131,072 x 33.34375 / (128 x 1.98e9) s, alu 131,072 x 12.84375 / 64 / ...
    (50_331_648, 131_072, dict(fp32=14, alu=12.84375, other=6.5), 1.98e9, 6.717672,
     17.244444, "epilogue (issue)"),
    # T2 at K = 512: three products of 2 x 48 x 2048 x 128 flop; a short epilogue
    (75_497_472, 65_536, dict(alu=2, other=8), 1.98e9, 10.076508, 2.585859, "product"),
    # mostly compares: alu 10 / 64 over issue 12 / 128
    (12_582_912, 32_768, dict(fp32=2, alu=10), 1.98e9, 1.679418, 2.585859, "epilogue (alu)"),
    # the multifunction unit: 2 / 16 over issue 3 / 128
    (12_582_912, 32_768, dict(mufu=2, other=1), 1.98e9, 1.679418, 2.068687, "epilogue (mufu)"),
    # no epilogue work; then half the clock doubles the epilogue's time
    (12_582_912, 32_768, {}, 1.98e9, 1.679418, 0.0, "product"),
    (50_331_648, 131_072, dict(fp32=14, alu=12.84375, other=6.5), 0.99e9, 6.717672,
     34.488889, "epilogue (issue)"),
    # T4, one pass on the busiest SM: its CTAs' flop (2 x 16 KS x 64 x N
    # each) against their staging and issue instructions by pipe ("tests"
    # are CTAs, the ops a CTA's thread instructions of a pass). At C = 16,
    # M = 1024, B = 128 one 64 x 16 tile on the SM, 1,728 instructions
    (32_768, 1, dict(fp32=256, alu=224, other=1248), 1.98e9, 0.004373484, 0.006818182,
     "epilogue (issue)"),
    # at M = 8192, B = 512: 1,024 tiles of 64 x 64, 8 on the busiest SM
    (1_048_576, 8, dict(fp32=1024, alu=512, other=1920), 1.98e9, 0.139951498, 0.109090909,
     "product"),
])
def test_visit_bound_sm_counts_the_epilogue(flops, tests, ops, clock, tensor_us, epilogue_us,
                                            by):
    """The per-SM bound of a visit is the larger of the tensor-core time
    (flop at 989 / 132 TFLOP/s) and the epilogue's CUDA-core time, the
    longest of its pipes (every instruction issued at 128 a clock, fp32 at
    128, alu at 64, mufu at 16), both halves and every pipe returned:
    hand-counted cases."""
    b = tools.visit_bound_sm(flops, tests, ops, clock)
    assert b["tensor_s"] * 1e6 == pytest.approx(tensor_us, rel=1e-6)
    assert b["epilogue_s"] * 1e6 == pytest.approx(epilogue_us, rel=1e-6, abs=1e-12)
    assert b["epilogue_s"] == max(b["pipes_s"].values())
    assert b["bound_s"] == max(b["tensor_s"], b["epilogue_s"]) and b["bound_by"] == by


def _sass(symbol, lines):
    """A cuobjdump -sass listing of one function: ``lines`` of "label:" or
    instructions, branches naming a label, at 16-byte addresses."""
    at, addr = {}, 0
    for ln in lines:
        if ln.endswith(":"):
            at[ln[:-1]] = addr
        else:
            addr += 16
    out, addr = [f"\t\tFunction : {symbol}", "\t.headerflags\t@\"EF_CUDA_SM90\""], 0
    for ln in lines:
        if ln.endswith(":"):
            continue
        for name, a in at.items():
            ln = ln.replace(f"<{name}>", hex(a))
        out.append(f"        /*{addr:04x}*/                   {ln} ;   /* 0x0000000000000000 */")
        out.append("                                                   /* 0x0000000000000000 */")
        addr += 16
    return "\n".join(out) + "\n"


# one tile of a T1-like loop (MT = 1): 12 HGMMA.64x32x16 (16 tests a thread);
# per test 2 fp32 + 1 alu in the epilogue
_TILE = ["HGMMA.64x32x16.F32.BF16 R24, R88, gdesc[UR4].tnspB, R24"] * 12 + [
    "FMUL R1, R2, R3", "FADD R1, R2, R3", "FSETP.GT.AND P0, PT, R1, R2, PT"] * 16


@pytest.mark.parametrize("name, lines, parts, want", [
    # the loop's path: a spin wait (a loop without wgmma), the tile, the
    # back branch; the prologue's HGMMA and the epilogue after are not read
    ("plain", ["HGMMA.64x32x16.F32.BF16 R24, R88, gdesc[UR4].tnspB, RZ", "head:",
               "SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR8], R3", "spin:",
               "@!P0 BRA <spin>"] + _TILE + ["ISETP.NE.AND P1, PT, R4, R5, PT",
                                             "@P1 BRA <head>", "MUFU.RCP R1, R2", "EXIT"],
     1, dict(fp32=2, alu=1 + 1 / 16, mufu=0, other=(12 + 3) / 16, tests=16)),
    # a forward branch over the tail's copy is not taken; one over a block
    # that opens with FCHK (the division's exact redo) is; an unconditional
    # branch is followed
    ("redo", ["head:"] + _TILE + ["@P0 BRA <tail>", "MUFU.RCP R1, R2", "@!P2 BRA <done>",
                                  "FCHK P1, R1, R2", "MUFU.RCP R1, R2", "FFMA R1, R2, R3, R4",
                                  "done:", "BRA <end>", "tail:", "FMUL R1, R2, R3", "end:",
                                  "@P1 BRA <head>", "EXIT"],
     3, dict(fp32=2 * 3, alu=1 * 3, mufu=3 / 16, other=(12 + 4) * 3 / 16, tests=16 / 3)),
])
def test_sass_visit_ops_walks_the_tile_loop(name, lines, parts, want):
    """tools.sass_visit_ops on hand-made listings: the innermost loop that
    issues wgmmas, walked along a tile's path, instructions per test by
    pipe, the tests from the HGMMAs' shape and ``parts``."""
    symbol = f"_Z6kernel_{name}"
    sass = _sass("_Z5other", ["FADD R1, R2, R3", "EXIT"]) + _sass(symbol, lines)
    got = tools.sass_visit_ops(sass, symbol, parts)
    assert got == pytest.approx(want)


def _model_loop(stage, issue):
    """A T4-like iteration loop: b * fi, the staging loop over the passes
    (``stage``, then its counter and back branch), the barrier, the issue
    loop (``issue``, then its back branch), the wait; prologue and tail
    outside."""
    return (["LDG.E R2, desc[UR6][R4.64]", "outer:", "FMUL R40, R19, R10", "stage:"] + stage
            + ["VIADD R20, R20, 0x4", "ISETP.GE.AND P1, PT, R20, R17, PT", "@!P1 BRA <stage>",
               "BAR.SYNC.DEFER_BLOCKING 0x1, 0x80", "issue:"] + issue
            + ["UISETP.GE.AND UP0, UPT, UR5, UR6, UPT", "@!UP0 BRA <issue>",
               "WARPGROUP.DEPBAR.LE gsb0, 0x1", "ISETP.GE.AND P2, PT, R18, R19, PT",
               "@!P2 BRA <outer>", "WARPGROUP.DEPBAR.LE gsb0, 0x0", "STG.E desc[UR6][R2.64], R24",
               "EXIT"])


_STAGE = ["I2FP.F32.S32 R7, R20", "FADD R4, R40, R7", "FADD R5, R39, R7",
          "F2FP.BF16.F32.PACK_AB R4, R5, R4", "STS.128 [R41], R4"]
_ISSUE = ["WARPGROUP.ARRIVE", "UIADD3 UR8, UR4, 0x20, URZ",
          "HGMMA.64x16x16.F32.BF16 R24, R32, gdesc[UR8].tnspB, R24, gsb0"]


@pytest.mark.parametrize("stage, issue, stagers, want", [
    # a pass staged by 32 threads (the threads of a chunk split the passes):
    # 8 staging instructions a pass (2 fp32, 2 alu, 4 other) and 5 issue
    # instructions (all other) on all 128 threads
    (_STAGE, _ISSUE, 32, dict(fp32=2 * 32, alu=2 * 32, mufu=0, other=4 * 32 + 5 * 128, hgmma=1)),
    # two chunks a thread on all 128, two k-steps a pass
    (_STAGE + _STAGE[1:], _ISSUE + _ISSUE[1:], 128,
     dict(fp32=4 * 128, alu=2 * 128, mufu=0, other=6 * 128 + 7 * 128, hgmma=2)),
])
def test_sass_pass_ops_walks_the_model_loop(stage, issue, stagers, want):
    """tools.sass_pass_ops on hand-made T4 listings: the staging loop (the
    innermost loop that stores to shared memory) on ``stagers`` threads and
    the issue loop (the innermost that holds HGMMA) on 128, each walked
    once; the outer iteration loop, its prologue and tail are not read."""
    symbol = "_Z6kernel_model"
    sass = _sass("_Z5other", ["STS [R1], R2", "EXIT"]) + _sass(symbol, _model_loop(stage, issue))
    assert tools.sass_pass_ops(sass, symbol, stagers) == pytest.approx(want)


@pytest.mark.parametrize("variant", perf_epilogue.VARIANTS)
@pytest.mark.parametrize("kind", ["int", "normal"])
def test_epilogue_witness_agrees_with_plain(variant, kind):
    """perf_epilogue.witness, the float64 run that names each lane's winning
    candidate: its best agrees with the plain version's f32 best within
    perf_epilogue.tolerance (exactly on the integer set where no argmin is
    packed), the winner is valid (|a| > 1e-12), and its sums' cancellation
    is at least 1 (the sum of magnitudes over the magnitude of the sum);
    perf_epilogue.past_band names a lane moved past REL_TOL, and no other."""
    k, sw, iters = 24, 64, 3
    rng = np.random.default_rng(24)
    if kind == "int":
        slab = rng.integers(-3, 4, (48, 4 * k))
        rays = rng.choice([-3.0, -2.0, -1.0, 1.0, 2.0, 3.0], (48, sw))
    else:
        slab, rays = rng.standard_normal((48, 4 * k)), rng.standard_normal((48, sw))
    slab = torch.from_numpy(slab.astype(np.float32)).to(torch.bfloat16)
    rays = torch.from_numpy(rays.astype(np.float32)).to(torch.bfloat16)
    want = perf_epilogue.run_plain(slab, rays, variant, k, sw, iters)[0].double()
    w = perf_epilogue.witness(slab, rays, variant, k, iters)
    found = torch.isfinite(w["best"])
    assert bool(found.any())
    assert bool((want[~found] == float(np.float32(mt_commit.T_INIT))).all())
    tol = perf_epilogue.tolerance(slab, rays, variant, k, iters, want[None].float())[0]
    diff = (want - w["best"])[found].abs()
    if kind == "int" and variant in ("none", "classify"):
        assert bool((diff == 0).all())
    assert bool((diff <= tol[found]).all()), float((diff / tol[found]).max())
    if variant != "none":
        assert bool((w["abs_a"][found] > 1e-12).all())
    assert bool((w["cancel_a"][found] >= 1 - 1e-12).all())
    assert bool((w["cancel_t"][found] >= 1 - 1e-12).all())
    # past_band names the lanes two runs put more than REL_TOL apart
    lane = int(found.nonzero()[0])
    got = want.float()[None].clone()
    assert perf_epilogue.past_band(slab, rays, variant, k, iters, got, want.float()[None]) == []
    got[0, lane] *= 1 + 4 * perf_epilogue.REL_TOL
    (entry,) = perf_epilogue.past_band(slab, rays, variant, k, iters, got, want.float()[None])
    assert entry["lane"] == lane and entry["cancel"] >= 1 - 1e-12
