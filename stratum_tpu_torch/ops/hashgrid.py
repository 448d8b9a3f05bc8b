"""Spatial hash grid, rebuilt by a sort each frame (counterpart of
stratum_tpu/ops/hashgrid.py).

Cells are keyed by a pcg hash of their integer coordinates; the grid is the
stable sort of the inserted items' keys, and a query is a binary search for
the first entry of its cell followed by ``max_results`` probes. Keys are
uint32 words held in int64 in [0, 2^32), so the sort and the search keep
the reference's unsigned order (int32 words would move the cells whose key
has the top bit set to the front).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stratum_tpu_torch.core import math as smath
from stratum_tpu_torch.core import rng as srng


class HashGrid(NamedTuple):
    sorted_keys: torch.Tensor  # int64 [N], uint32 values in ascending order
    order: torch.Tensor  # int32 [N] item index of each sorted entry
    cell_size: torch.Tensor  # f32 scalar
    origin: torch.Tensor  # f32 [3]


def cell_size_for(camera_pos, positions, base_size):
    """Cells grow with the mean distance to the camera (hashgrid.py:32-36)."""
    d = smath.length(positions - camera_pos)
    return base_size * torch.clamp(torch.mean(d), min=1.0)


def _cell_key(positions, origin, cell_size):
    """uint32 cell hash of each position, as int64 in [0, 2^32)."""
    q = torch.floor((positions - origin) / cell_size).to(torch.int32)
    k = (srng.pcg(q[..., 0])
         ^ srng.pcg(q[..., 1] + srng.u32(0x9E3779B9))
         ^ srng.pcg(q[..., 2] + srng.u32(0x85EBCA6B)))
    return k.to(torch.int64) & 0xFFFFFFFF


def build_hashgrid(positions, cell_size, origin=None) -> HashGrid:
    """Insert positions [N, 3] (origin: their minimum unless given)."""
    if origin is None:
        origin = torch.amin(positions, dim=0)
    keys = _cell_key(positions, origin, cell_size)
    order = torch.sort(keys, stable=True).indices
    return HashGrid(
        sorted_keys=keys[order],
        order=order.to(torch.int32),
        cell_size=torch.as_tensor(cell_size, dtype=torch.float32, device=positions.device),
        origin=origin,
    )


def query(grid: HashGrid, positions, max_results: int = 8):
    """Items in each query position's cell -> (ids [Q, R] int32, -1 where
    invalid; valid [Q, R] bool), R = ``max_results`` probes."""
    keys = _cell_key(positions, grid.origin, grid.cell_size)
    start = torch.searchsorted(grid.sorted_keys, keys, side="left")
    slots = start[..., None] + torch.arange(max_results, device=keys.device)
    n = grid.sorted_keys.shape[0]
    slots_c = torch.clamp(slots, max=n - 1)
    valid = (slots < n) & (grid.sorted_keys[slots_c] == keys[..., None])
    return torch.where(valid, grid.order[slots_c], -1), valid
