"""Collectives over a list of per-shard tensors, for the single-controller
mesh (they stand where the JAX package's ``jax.lax.all_gather``, ``psum``
and ``pmax`` stand inside ``shard_map``).

Each takes the shards' tensors in shard order, copies them to ``dst``
(``.to`` does nothing on the same device, and is a cross-device copy over
NVLink or P2P between cards) and combines them there in that order:

- `all_gather`: concatenation along ``dim``;
- `all_reduce_sum`: ``((t0 + t1) + t2) + ...``; exact where one shard holds
  the only non-zero term of an element (the sharded engine's owned-row
  sums);
- `all_reduce_max`: the elementwise max.

All three are differentiable (``.to``, ``cat``, ``+`` and ``amax`` are):
the sharded train step runs its backward through them. ``amax`` splits
the gradient evenly over tied maxima, where the JAX package's ``pmax``
rule is its own; the port takes gradients through `all_gather` and
`all_reduce_sum` only.
"""
from __future__ import annotations

from typing import Sequence

import torch


def all_gather(tensors: Sequence[torch.Tensor], dst, dim: int = 0
               ) -> torch.Tensor:
    """The shards' tensors concatenated along ``dim`` on ``dst``."""
    return torch.cat([t.to(dst) for t in tensors], dim=dim)


def all_reduce_sum(tensors: Sequence[torch.Tensor], dst) -> torch.Tensor:
    """The elementwise sum on ``dst``, added in shard order."""
    out = tensors[0].to(dst)
    for t in tensors[1:]:
        out = out + t.to(dst)
    return out


def all_reduce_max(tensors: Sequence[torch.Tensor], dst) -> torch.Tensor:
    """The elementwise max on ``dst``."""
    return torch.stack([t.to(dst) for t in tensors]).amax(dim=0)
