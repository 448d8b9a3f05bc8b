"""Counter-based deterministic RNG (counterpart of stratum_tpu/core/rng.py).

pcg4d over per-pixel states ``(pixel.x, pixel.y, seed, dimension)``; every
draw is a pure function of (pixel, seed, dimension), so images are
bit-identical under any tiling of the pixel domain.

Torch cannot add, shift or compare ``uint32`` tensors, so states are int32
tensors holding the same 32 bits: wrapping int32 add and multiply give the
uint32 bits exactly, and logical right shifts are emulated with a mask,
``(x >> s) & ((1 << (32 - s)) - 1)``. Constants above 2^31 enter as their
signed int32 twins (:func:`u32`). Words are bit-exact against the JAX
reference (tests/test_torch_rng.py, tests/test_torch_sampling.py).

``QMC`` picks the sampler, read at each draw as the reference reads it at
trace time: ``"rand"`` is the pcg4d counter RNG; ``"kron"`` the
Cranley-Patterson-rotated Kronecker lattice, where dimension d of sample s
of a pixel is ``frac(rot(pixel, d) + (s + 1) * alpha_d)`` with alpha_d =
frac(sqrt(prime_d)) in uint32 fixed point (the sum wraps mod 2^32, so the
lattice is exact at any sample index) and rot a pcg4d hash of (pixel, dim).
The setting is process-global: whoever sets it restores it.
"""

from __future__ import annotations

import numpy as np
import torch

QMC = "rand"


def u32(c: int) -> int:
    """A uint32 constant as the int32 value with the same bits."""
    c &= 0xFFFFFFFF
    return c - (1 << 32) if c >= (1 << 31) else c


def shr(x: torch.Tensor, s) -> torch.Tensor:
    """Logical right shift of int32-held uint32 words (``s`` int or tensor)."""
    if isinstance(s, int):
        return (x >> s) & ((1 << (32 - s)) - 1)
    return (x >> s) & ((torch.ones_like(s) << (32 - s)) - 1)


def as_u32(x) -> torch.Tensor:
    """Any integer tensor/value -> int32 words (low 32 bits)."""
    x = torch.as_tensor(x)
    if x.dtype == torch.int32:
        return x
    x = x.to(torch.int64) & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def pcg(v: torch.Tensor) -> torch.Tensor:
    """Scalar pcg hash (rng.py:24-31)."""
    v = as_u32(v)
    state = v * 747796405 + u32(2891336453)
    word = (shr(state, shr(state, 28) + 4) ^ state) * 277803737
    return shr(word, 22) ^ word


def pcg4d(v: torch.Tensor) -> torch.Tensor:
    """pcg4d mixing on [..., 4] words (rng.py:48-62)."""
    v = as_u32(v) * 1664525 + 1013904223
    x, y, z, w = v.unbind(-1)
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    x, y, z, w = (t ^ shr(t, 16) for t in (x, y, z, w))
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return torch.stack([x, y, z, w], dim=-1)


def rng_init(pixel_x, pixel_y, seed, offset=0) -> torch.Tensor:
    """State words [..., 4] from pixel coords, frame seed, start dim."""
    px = as_u32(pixel_x)
    dev = px.device
    py = as_u32(torch.as_tensor(pixel_y, device=dev)).expand(px.shape)
    s = as_u32(torch.as_tensor(seed, device=dev)).expand(px.shape)
    o = as_u32(torch.as_tensor(offset, device=dev)).expand(px.shape)
    return torch.stack([px, py, s, o], dim=-1)


def _bits_to_float(bits: torch.Tensor) -> torch.Tensor:
    """Words -> float in [0, 1) via the mantissa trick (rng.py:74-79)."""
    mantissa = shr(bits, 9) | 0x3F800000
    return mantissa.view(torch.float32) - 1.0


def _alpha_table(n: int = 512) -> np.ndarray:
    """frac(sqrt(prime)) of the first ``n`` primes in uint32 fixed point
    (rng.py:103-112); dimensions past the table wrap."""
    sieve = np.ones(8192, bool)
    sieve[:2] = False
    for i in range(2, 91):
        if sieve[i]:
            sieve[i * i:: i] = False
    primes = np.nonzero(sieve)[0][:n].astype(np.float64)
    frac = np.sqrt(primes) % 1.0
    return (frac * 4294967296.0).astype(np.uint64).astype(np.uint32)


_ALPHAS = _alpha_table().astype(np.int64)
_ALPHA_CACHE: dict = {}


def _alphas(device) -> torch.Tensor:
    key = str(device)
    if key not in _ALPHA_CACHE:
        _ALPHA_CACHE[key] = torch.from_numpy(_ALPHAS).to(device)
    return _ALPHA_CACHE[key]


def _kron_bits(state, dims):
    """Lattice words of dimensions ``dims`` ([..., k] words) of the state's
    sample index (state[..., 2]); the rotation is keyed by (pixel, dim)
    (rng.py:118-135). ``rot + (s + 1) * alpha mod 2^32`` is formed in int64
    on 16-bit halves of alpha, so no product leaves int64."""
    rot_state = torch.stack([
        state[..., 0:1].expand(dims.shape), state[..., 1:2].expand(dims.shape),
        torch.full_like(dims, u32(0xA511E9B3)), dims,
    ], dim=-1)
    rot = pcg4d(rot_state)[..., 0].to(torch.int64) & 0xFFFFFFFF
    alpha = _alphas(dims.device)[(dims & (_ALPHAS.shape[0] - 1)).long()]
    s1 = ((state[..., 2:3].to(torch.int64) & 0xFFFFFFFF) + 1) & 0xFFFFFFFF
    prod = s1 * (alpha & 0xFFFF) + (((s1 * (alpha >> 16)) & 0xFFFF) << 16)
    return as_u32((rot + prod) & 0xFFFFFFFF)


def next_uint(state):
    state = skip(state, 1)
    if QMC == "kron":
        return _kron_bits(state, state[..., 3:4])[..., 0], state
    return pcg4d(state)[..., 0], state


def next_float(state):
    """One uniform per state; returns (u, new_state)."""
    bits, state = next_uint(state)
    return _bits_to_float(bits), state


def next_floats(state, k: int):
    """k uniforms per state; draw i uses dimension ``w + 1 + i`` and the
    returned state has ``w += k`` (rng.py:150-165). Returns (u[..., k], st)."""
    w = state[..., 3]
    offs = torch.arange(1, k + 1, dtype=torch.int32, device=state.device)
    if QMC == "kron":
        return _bits_to_float(_kron_bits(state, w[..., None] + offs)), skip(state, k)
    states = state[..., None, :].expand(state.shape[:-1] + (k, 4)).clone()
    states[..., 3] = w[..., None] + offs
    bits = pcg4d(states)[..., 0]
    return _bits_to_float(bits), skip(state, k)


def skip(state, k: int = 1):
    out = state.clone()
    out[..., 3] += k
    return out
