"""The one seam between the port and its native entry points
(``stratum_tpu_torch/utils/cuda_build.py``), on the CPU: every declared
signature against its ``extern "C"`` declaration in ``csrc/``, the
argument count checked before C, the launch registry, the info reader
and ptxas's report, the tensor check. No kernel runs here."""

import collections
import re

import pytest
import torch

from stratum_tpu_torch.ops import binned, block_trace  # noqa: F401  (declare their entries)
from stratum_tpu_torch.render import denoise, disney  # noqa: F401
from stratum_tpu_torch.tools import (  # noqa: F401
    bench_mxu_model,
    perf_commit_pipeline,
    perf_epilogue,
    probe_mxu_loop,
)
from stratum_tpu_torch.utils import cuda_build, native  # noqa: F401

_EXTERN = re.compile(r'extern "C"\s+(\w+)\s+(\w+)\s*\(([^)]*)\)')


def _c_kind(param: str) -> str:
    """A C parameter's kind: ``n`` for ``int*`` (a declaration may pass it
    as ``p``), ``p`` for any other pointer, else by its type."""
    ctype = re.sub(r"\s+", " ", re.sub(r"\w+$", "", param.strip())).strip()
    if "*" in ctype:
        return "n" if ctype.replace(" ", "") == "int*" else "p"
    return {"int": "i", "float": "f", "long long": "q"}[ctype]


def _c_entries() -> dict:
    """{name: (source file, return type, kinds)} of every ``extern "C"``
    function in ``csrc/``."""
    out = {}
    for src in sorted(cuda_build.CSRC.glob("*.c*")):
        for ret, name, params in _EXTERN.findall(src.read_text()):
            out[name] = (src.name, ret, "".join(_c_kind(p) for p in params.split(",")))
    return out


C_ENTRIES = _c_entries()


def test_every_c_entry_point_is_declared_once():
    assert sorted(cuda_build.ENTRIES) == sorted(C_ENTRIES)


@pytest.mark.parametrize("name", sorted(cuda_build.ENTRIES))
def test_declared_signature_matches_the_source(name):
    """Argument count and kind as the C declaration has them; a C ``int*``
    is a pointer (``p``) or the int the function writes (``n``), and every
    entry returns a cudaError_t or an int."""
    e = cuda_build.ENTRIES[name]
    source, ret, kinds = C_ENTRIES[name]
    assert e.source == source and ret in ("cudaError_t", "int")
    assert len(e.signature) == len(kinds), (e.signature, kinds)
    for declared, c in zip(e.signature, kinds):
        assert declared == c or (declared, c) == ("p", "n"), (e.signature, kinds)


@pytest.mark.parametrize("name", sorted(cuda_build.ENTRIES))
def test_a_wrong_argument_count_raises_before_c(name):
    """Too few or too many arguments raise TypeError without the library
    being built or loaded."""
    e = cuda_build.ENTRIES[name]

    def refuse():
        raise AssertionError("the library was loaded")

    fake = cuda_build.Entry(e.source, e.name, e.signature, refuse)
    for n in (len(e.signature) - 1, len(e.signature) + 1):
        with pytest.raises(TypeError, match=e.name):
            fake(*([0] * n))


def test_c_kinds_of_the_parser():
    assert [_c_kind(p) for p in ("const float* const* ptr", "long long n", "int* launched",
                                 "const int* leaf_count", "unsigned long long* words",
                                 "void* stream", "float t_min", "int g", "const char** name")
            ] == ["p", "q", "n", "p", "p", "p", "f", "i", "p"]


def _fake(name: str, signature: str, fn) -> cuda_build.Entry:
    e = cuda_build.Entry("fake.cu", name, signature, lambda: None)
    e.fn = fn
    return e


@pytest.fixture
def registry(monkeypatch):
    """An empty launch registry, and ``torch.cuda``'s device and stream
    stand-ins so that a launch runs on the CPU (stream 7)."""
    monkeypatch.setattr(cuda_build, "_LAUNCHES", collections.Counter())
    monkeypatch.setattr(torch.cuda, "device", lambda device: _NullContext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 7})())


class _NullContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_registry_adds_copies_and_resets(registry):
    """A plain launch adds 1 under the entry's name (``name/op`` with an
    op), a launcher with an out-int what it writes there; the stream is the
    last argument; a read is a copy; a cudaError raises naming the entry."""
    seen = []
    plain = _fake("fake_plain", "ii p", lambda *a: seen.append(a) or 0)

    def chunks(*a):
        a[-2]._obj.value = 3  # the launcher's count, through its int pointer
        return 0

    counted = _fake("fake_counted", "p np", chunks)
    cpu = torch.device("cpu")
    assert cuda_build.launch(plain, cpu, 4, 5) == 1 and seen == [(4, 5, 7)]
    assert cuda_build.launch(plain, cpu, 4, 5, op="closest") == 1
    assert cuda_build.launch(counted, cpu, None) == 3
    read = cuda_build.launches()
    assert read == {"fake_plain": 1, "fake_plain/closest": 1, "fake_counted": 3}
    read["fake_plain"] += 10
    assert cuda_build.launches()["fake_plain"] == 1
    with pytest.raises(RuntimeError, match="fake_refused.*cudaError 1"):
        cuda_build.launch(_fake("fake_refused", "p", lambda *a: 1), cpu)
    assert cuda_build.launches() == read - collections.Counter(fake_plain=10)
    cuda_build.reset_launches()
    assert cuda_build.launches() == {} and read["fake_counted"] == 3


_REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z11fake_kernelILb0EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z11fake_kernelILb0EEvPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 368 bytes cmem[0]
ptxas info    : Compiling entry function '_Z11fake_kernelILb1EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z11fake_kernelILb1EEvPf
    24 bytes stack frame, 38 bytes spill stores, 88 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 24 bytes cumulative stack size
"""


def test_info_reader_names_fields_and_reads_ptxas(monkeypatch):
    """The out-array's fields by name (None skips one); the named kernel's
    stack and spill bytes from ptxas's report, the last symbol that holds
    the name; None without a report; a cudaError raises."""

    def info(flag, out):
        for i in range(len(out)):
            out[i] = 10 * flag + i
        return 0

    e = _fake("fake_info", "i p", info)
    e.source = "fake_seam.cu"
    assert cuda_build.kernel_info(e, ("registers", None, "threads"), 2) == dict(
        registers=20, threads=22)
    assert cuda_build.kernel_info(e, ("registers",), 1, kernel="fake_kernel") == dict(
        registers=10, stack_bytes=None, spill_stores=None, spill_loads=None)
    monkeypatch.setitem(cuda_build.BUILD_LOG, "fake_seam.cu", _REPORT)
    assert cuda_build.ptxas_report("fake_seam.cu") == {
        "_Z11fake_kernelILb0EEvPf": dict(registers=40, stack_bytes=0, spill_stores=0,
                                         spill_loads=0),
        "_Z11fake_kernelILb1EEvPf": dict(registers=64, stack_bytes=24, spill_stores=38,
                                         spill_loads=88)}
    assert cuda_build.kernel_info(e, ("registers",), 0, kernel="fake_kernel") == dict(
        registers=0, stack_bytes=24, spill_stores=38, spill_loads=88)
    assert cuda_build.kernel_info(e, ("registers",), 0, kernel="fake_kernelILb0") == dict(
        registers=0, stack_bytes=0, spill_stores=0, spill_loads=0)
    with pytest.raises(RuntimeError, match="fake_info failed: cudaError 2"):
        cuda_build.kernel_info(_fake("fake_info", "p", lambda out: 2), ("registers",))


@pytest.mark.parametrize("contiguous", [True, False])
def test_check_refuses_cpu_tensors(contiguous):
    """The one tensor check takes CUDA tensors only, strided or not."""
    x = torch.zeros((4, 3))[:, 0]
    with pytest.raises(ValueError, match="CUDA"):
        cuda_build.check(x, "x", torch.float32, (4,), x.device, contiguous=contiguous)
