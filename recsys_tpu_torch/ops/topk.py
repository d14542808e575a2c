"""A top-k with XLA's order among equal values.

``jax.lax.top_k`` returns equal values lowest index first; ``torch.topk``
promises no order among them. The device indexes (``ops/quant.py``,
``ops/ivf.py``) are held to the JAX package's ids, ties included (duplicate
items, an int32 accumulator, -inf padding), so they take the top-k of one
unique int64 key a value: the value's order in the high 32 bits, the
position's reverse in the low 32. ``torch.topk`` of unique keys has one
answer.
"""

from __future__ import annotations

import torch

_LOW = (1 << 32) - 1


def _order_bits(values: torch.Tensor) -> torch.Tensor:
    """int32 whose order is the values' order: an int32 as it is; a float32's
    bits with the magnitude bits flipped where the sign is set."""
    if values.dtype == torch.int32:
        return values
    if values.dtype != torch.float32:
        raise TypeError(f"stable_topk takes int32 or float32 values, got {values.dtype}")
    bits = values.view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def stable_topk(values: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, N) int32 or float32 -> (vals, idx) (B, k), largest first, equal
    values lowest index first (as ``jax.lax.top_k``). NaN is not ordered."""
    n = values.shape[-1]
    if n > _LOW:
        raise ValueError(f"stable_topk: {n} columns do not fit the key's 32 low bits")
    return topk_by_id(values, torch.arange(n, device=values.device), k)


def topk_by_id(values: torch.Tensor, ids: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, M) int32 or float32 values and their ids ((M,) or (B, M), distinct
    in a row, below 2^32) -> (vals, ids) (B, k): largest first, equal values
    smallest id first."""
    key = torch.add(_LOW - ids.long(), _order_bits(values), alpha=1 << 32)
    pos = torch.topk(key, k, dim=-1).indices
    return values.gather(-1, pos), ids.expand(values.shape).gather(-1, pos)
