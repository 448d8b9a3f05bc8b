"""The port's RNG (stratum_tpu_torch/core/rng.py) against the JAX reference:
raw uint32 words, bit for bit. The port holds words in int32 tensors
(wrapping add/multiply, masked logical shifts); every comparison below views
both sides as uint32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stratum_tpu.core import rng as jrng
from stratum_tpu_torch.core import rng as prng

torch.set_num_threads(2)


def _words(seed, shape):
    """uint32 words covering the whole range, high bit included."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
    w.flat[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]
    return w


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words.view(np.int32).copy())


@pytest.mark.parametrize("seed", [0, 1])
def test_pcg_bit_exact(seed):
    w = _words(seed, (4096,))
    np.testing.assert_array_equal(_u32(prng.pcg(_t(w))), np.asarray(jrng.pcg(w)))


@pytest.mark.parametrize("seed", [0, 1])
def test_pcg4d_bit_exact(seed):
    w = _words(seed, (2048, 4))
    np.testing.assert_array_equal(_u32(prng.pcg4d(_t(w))), np.asarray(jrng.pcg4d(w)))


def test_rng_init_bit_exact():
    px = np.arange(300, dtype=np.uint32)
    py = (px * 7) % 97
    for seed, offset in ((0, 0), (5, 3), (0xFFFFFFFF, 17)):
        ref = np.asarray(jrng.rng_init(px, py, np.uint32(seed), np.uint32(offset)))
        got = prng.rng_init(torch.from_numpy(px.astype(np.int64)),
                            torch.from_numpy(py.astype(np.int64)), seed, offset)
        np.testing.assert_array_equal(_u32(got), ref)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_next_floats_bit_exact(k):
    """Draw words, floats and the advanced state all match."""
    st = _words(3, (1000, 4))
    uj, sj = jrng.next_floats(jnp.asarray(st), k)
    up, sp = prng.next_floats(_t(st), k)
    np.testing.assert_array_equal(up.numpy().view(np.uint32), np.asarray(uj).view(np.uint32))
    np.testing.assert_array_equal(_u32(sp), np.asarray(sj))


def test_next_float_and_skip_bit_exact():
    st = _words(4, (512, 4))
    uj, sj = jrng.next_float(jnp.asarray(st))
    up, sp = prng.next_float(_t(st))
    np.testing.assert_array_equal(up.numpy().view(np.uint32), np.asarray(uj).view(np.uint32))
    np.testing.assert_array_equal(_u32(sp), np.asarray(sj))
    np.testing.assert_array_equal(
        _u32(prng.skip(_t(st), 5)), np.asarray(jrng.skip(jnp.asarray(st), 5))
    )


def test_bits_to_float_bit_exact():
    w = _words(5, (8192,))
    ref = np.asarray(jrng._bits_to_float(jnp.asarray(w)))
    got = prng._bits_to_float(_t(w))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref.view(np.uint32))
    assert (got >= 0).all() and (got < 1).all()


def test_logical_shift_and_constants():
    w = _words(6, (1000,))
    for s in (1, 9, 16, 22, 28, 31):
        np.testing.assert_array_equal(_u32(prng.shr(_t(w), s)), w >> np.uint32(s))
    assert prng.u32(0xFFFFFFFF) == -1 and prng.u32(2891336453) == 2891336453 - (1 << 32)
    np.testing.assert_array_equal(
        prng.as_u32(torch.from_numpy(w.astype(np.int64))).numpy(), w.view(np.int32)
    )
