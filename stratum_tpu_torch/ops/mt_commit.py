"""The c48 leaf-visit commit of the TPU tracer as plain torch (counterpart
of stratum_tpu/ops/pallas_trace.py:412-529 and of the epilogue variants in
tools/perf_epilogue.py:54-104).

One visit multiplies a bf16 [48, 4K] slab by bf16 [48, B] rays with f32
accumulation, splits the [4K, B] product into the four [K, B] bands
(a, u_num, v_num, t_num), classifies them and commits each lane's closest
candidate with a packed argmin. These functions are the plain versions the
microbenchmark kernels of ``stratum_tpu_torch/tools`` are held to; they
keep the reference's arithmetic step for step (separate roundings, the
exponent-negation reciprocal seed, slots as f32), so on inputs whose
products are exact they give the reference's bits.
"""

from __future__ import annotations

import torch

C = 48  # contraction depth of the c48 product (three bf16 bands of 16)
IDX_BITS = 10  # pallas_trace._IDX_BITS: row index packed into t's low bits
MASK = ~((1 << IDX_BITS) - 1)  # int32 mask that clears the index bits
RECIP_SEED = 0x7EF311C3  # exponent-negation seed of the Newton reciprocal
T_INIT = 3.0e38  # the tools' initial best t
_SIGN = -(1 << 31)  # int32 sign bit


def mt_product(slab: torch.Tensor, rays: torch.Tensor) -> torch.Tensor:
    """``_mt_matmul(mode="c48")``: [C, 4K] slab x [C, B] rays -> f32
    [4K, B], contracting dim 0 of both. bf16 products are exact in f32; the
    sum is f32 (TF32 stays off, see ``stratum_tpu_torch/__init__.py``)."""
    return slab.float().T @ rays.float()


def bands(out: torch.Tensor):
    """The four [K, B] bands (a, u_num, v_num, t_num) of a [4K, B] product."""
    return out.chunk(4, dim=0)


def mt_classify(a, u, v, t, cap: bool = True):
    """``pallas_trace._mt_classify``: sign-normalised accept rule ->
    (abs_a, stn, valid). ``sign(0) = 0``, so a zero determinant is invalid.
    ``cap=False`` drops the ``abs_a < 1e37`` clause, as perf_epilogue's
    ``classify`` does."""
    s = torch.sign(a)
    abs_a, su, sv, stn = a * s, u * s, v * s, t * s
    valid = (
        (abs_a > 1e-12) & (su >= 0.0) & (sv >= 0.0)
        & (su + sv <= abs_a) & (stn > 1e-4 * abs_a)
    )
    if cap:
        valid = valid & (abs_a < 1e37)
    return abs_a, stn, valid


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _float(bits: torch.Tensor) -> torch.Tensor:
    return bits.contiguous().view(torch.float32)


def recip(abs_a: torch.Tensor) -> torch.Tensor:
    """1 / abs_a by the exponent-negation seed and two Newton steps, each a
    separate multiply and subtract (pallas_trace.py:497-503)."""
    r = _float(RECIP_SEED - _bits(abs_a))
    r = r * (2.0 - abs_a * r)
    return r * (2.0 - abs_a * r)


def packed_min(tt: torch.Tensor) -> torch.Tensor:
    """Min over rows of ``(bits(tt) & MASK) | row``: [K, B] f32 -> [B] int32
    (positive floats order as ints; t loses its low IDX_BITS bits)."""
    iota = torch.arange(tt.shape[0], dtype=torch.int32, device=tt.device)[:, None]
    return torch.amin((_bits(tt) & MASK) | iota, dim=0)


def unpack(packed: torch.Tensor):
    """(t, row as f32) of a packed minimum."""
    return _float(packed & MASK), (packed & ~MASK).float()


def select_update(valid, stn, abs_a, best, slot, slot_base):
    """``pallas_trace._select_update`` with ``packed_argmin=True``: commit
    each lane's closest valid candidate of a [K, B] slice into ``best`` /
    ``slot`` ([B] f32) -> (best, slot). Misses are +inf; the slot is the f32
    ``slot_base + row``, as the reference keeps it."""
    valid = valid & (stn < best * abs_a)
    tt = torch.where(valid, stn * recip(abs_a), float("inf"))
    tk, kbest = unpack(packed_min(tt))
    closer = tk < best
    slot_id = torch.tensor(slot_base, dtype=torch.float32) + kbest
    return torch.where(closer, tk, best), torch.where(closer, slot_id, slot)


def ring_pack(valid, stn, abs_a, visit: int, k: int):
    """perf_commit_pipeline's ``ring_commit`` (:178-197): the per-visit
    (t, slot) minimum without the ``closer`` test -> ([B] t, [B] slot)."""
    tt = torch.where(valid, stn * recip(abs_a), float("inf"))
    tk, kbest = unpack(packed_min(tt))
    return tk, kbest + torch.tensor(float(visit), dtype=torch.float32) * float(k)


def select_update_tool(valid, stn, abs_a, best, div: bool = True):
    """perf_epilogue's ``select_update``: the closer-than-best test, t by a
    true division (``div``) or a multiply by the determinant (the timing
    variant ``nodiv``), packed argmin -> the new [B] best."""
    valid = valid & (stn < best * abs_a)
    denom = torch.where(abs_a > 0.0, abs_a, 1.0)
    tt = torch.where(valid, stn / denom if div else stn * denom, float("inf"))
    tk, _ = unpack(packed_min(tt))
    return torch.minimum(tk, best)


def classify_fused(a, u, v, t):
    """perf_epilogue's ``classify_fused``: signs flipped by xor with a's
    sign bit (a = -0.0 flips them too, where ``sign(a) * x`` would give
    zeros) and the accept rule folded into two min chains -> (abs_a, stn,
    m1, m2)."""
    ab = _bits(a)
    sm = ab & _SIGN
    abs_a = _float(ab ^ sm)
    su, sv, stn = (_float(_bits(x) ^ sm) for x in (u, v, t))
    m1 = torch.minimum(torch.minimum(su, sv), abs_a - (su + sv))
    m2 = torch.minimum(stn - 1e-4 * abs_a, abs_a - 1e-12)
    return abs_a, stn, m1, m2


def select_fused(m1, m2, stn, abs_a, best):
    """perf_epilogue's ``select_fused`` -> the new [B] best."""
    m3 = torch.minimum(m2, best * abs_a - stn)
    valid = (m1 >= 0.0) & (m3 > 0.0)
    tt = torch.where(valid, stn, float("inf")) / abs_a
    tk, _ = unpack(packed_min(tt))
    return torch.minimum(tk, best)
