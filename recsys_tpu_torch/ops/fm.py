"""Factorization-machine second-order interaction, plain PyTorch forms.

Counterpart of ``recsys_tpu/ops/fm.py``. Uses the O(F*K) identity
``sum_{i<j} <v_i, v_j> = 0.5 * (||sum_f v_f||^2 - sum_f ||v_f||^2)``. The
arithmetic is fp32 whatever the input type. The hand-written CUDA twin of
``fm_interaction`` is ``ops/fm_kernel.fused_fm_interaction``; these forms
serve CPU tensors and are the oracle the kernel is held against.
"""

from __future__ import annotations

import torch


def fm_interaction(v: torch.Tensor) -> torch.Tensor:
    """(B, F, K) field embeddings -> (B,) FM second-order term."""
    v = v.float()
    sum_sq = v.sum(dim=1) ** 2          # (B, K)
    sq_sum = (v ** 2).sum(dim=1)        # (B, K)
    return 0.5 * (sum_sq - sq_sum).sum(dim=-1)


def fm_interaction_vector(v: torch.Tensor) -> torch.Tensor:
    """(B, F, K) -> (B, K): the per-dimension interaction vector (kept
    unsummed so a deep head can consume it, DeepFM-style)."""
    v = v.float()
    return 0.5 * (v.sum(dim=1) ** 2 - (v ** 2).sum(dim=1))
