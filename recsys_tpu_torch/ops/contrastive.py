"""Plain PyTorch forms of the in-batch contrastive losses.

Counterpart of ``recsys_tpu/ops/contrastive.py``: the same fp32 math and the
same -3e4 mask value. These are the CPU path and the oracle for the
hand-written kernel in ``ops/contrastive_kernel.py``. Only the two losses
that the item-tower and user-tower main paths use are ported so far.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG = -3.0e4  # bf16-safe "minus infinity", as in the JAX package


def _ce_with_diag_labels(logits: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy with labels = row index (diagonal positives)."""
    return -torch.diagonal(F.log_softmax(logits, dim=-1)).mean()


def bidirectional_infonce(emb1: torch.Tensor, emb2: torch.Tensor,
                          temperature: float = 0.08) -> torch.Tensor:
    """SimCSE: sim = e1 @ e2.T / tau, CE both directions, averaged.
    Inputs are L2-normalized (B, D)."""
    sim = emb1.float() @ emb2.float().T / temperature
    return 0.5 * (_ce_with_diag_labels(sim) + _ce_with_diag_labels(sim.T))


def inbatch_logq_loss(user_emb: torch.Tensor, item_emb: torch.Tensor,
                      pos_item_ids: torch.Tensor, log_q: torch.Tensor, *,
                      temperature: float = 0.1, lambda_logq: float = 1.0,
                      user_ids: torch.Tensor | None = None,
                      valid: torch.Tensor | None = None) -> torch.Tensor:
    """In-batch sampled softmax with LogQ popularity correction and
    same-item / same-user / invalid-column masking (see the JAX form)."""
    logits = user_emb.float() @ item_emb.float().T / temperature
    logits = logits - lambda_logq * log_q.float()[pos_item_ids][None, :]
    B = logits.shape[0]
    eye = torch.eye(B, dtype=torch.bool, device=logits.device)
    mask = (pos_item_ids[None, :] == pos_item_ids[:, None]) & ~eye
    if user_ids is not None:
        mask = mask | ((user_ids[None, :] == user_ids[:, None]) & ~eye)
    if valid is not None:
        mask = mask | ((valid[None, :] == 0) & ~eye)
    logits = torch.where(mask, torch.full_like(logits, NEG), logits)
    logp = torch.diagonal(F.log_softmax(logits, dim=-1))
    if valid is None:
        return -logp.mean()
    v = valid.float()
    return -(logp * v).sum() / v.sum().clamp(min=1.0)
