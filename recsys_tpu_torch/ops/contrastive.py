"""Plain PyTorch forms of the in-batch contrastive losses.

Counterpart of ``recsys_tpu/ops/contrastive.py``: the same fp32 math and the
same -3e4 mask value. ``bidirectional_infonce`` and ``inbatch_logq_loss`` are
the CPU path and the oracle for the hand-written kernel in
``ops/contrastive_kernel.py``. The stage-2 family that the JAX package
computes outside any Pallas kernel is plain PyTorch here too: ``duorec_loss``
(every stage-2 step) and the hard-negative variants ``hnm_corrected_loss``,
``mixed_hnm_loss`` and ``full_batch_hard_emphasis_loss``. Not ported yet:
``corrected_logq_with_recovery`` (the hybrid trainer's).
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


def duorec_loss(z1: torch.Tensor, z2: torch.Tensor, target_ids: torch.Tensor, *,
                temperature: float = 0.1, lambda_sup: float = 0.1,
                valid: torch.Tensor | None = None) -> torch.Tensor:
    """DuoRec regularizer: unsupervised InfoNCE between two dropout views +
    supervised SupCon treating same-target rows as extra positives."""
    sim = z1.float() @ z2.float().T / temperature
    B = sim.shape[0]
    eye = torch.eye(B, dtype=torch.bool, device=sim.device)
    v = (torch.ones(B, device=sim.device) if valid is None else valid.float())
    row_mask = (v[:, None] * v[None, :]) > 0
    sim = torch.where(row_mask, sim, torch.full_like(sim, NEG))
    n_valid = v.sum().clamp(min=1.0)
    unsup = 0.5 * (
        -(torch.diagonal(F.log_softmax(sim, -1)) * v).sum() / n_valid
        - (torch.diagonal(F.log_softmax(sim.T, -1)) * v).sum() / n_valid)
    # SupCon: positives = other rows with the same target item (both views)
    pos_mask = (target_ids[None, :] == target_ids[:, None]) & row_mask & ~eye
    logp = F.log_softmax(sim, dim=-1)
    pos_cnt = pos_mask.sum(-1)
    sup_row = -torch.where(pos_mask, logp, torch.zeros_like(logp)).sum(-1) \
        / pos_cnt.clamp(min=1)
    has_pos = (pos_cnt > 0) & (v > 0)
    sup = torch.where(has_pos, sup_row, torch.zeros_like(sup_row)).sum() \
        / has_pos.sum().clamp(min=1)
    return unsup + lambda_sup * sup


def _hard_negative_mask(cos: torch.Tensor, pos_item_ids: torch.Tensor,
                        top_k_percent: float, threshold: float):
    """Boolean (B, B) mask of mined hard negatives: highest-cosine
    off-diagonal candidates, excluding same-item columns and anything with
    cosine > threshold ('too similar' = probable false negative)."""
    B = cos.shape[0]
    eye = torch.eye(B, dtype=torch.bool, device=cos.device)
    same_item = pos_item_ids[None, :] == pos_item_ids[:, None]
    eligible = ~eye & ~same_item & (cos <= threshold)
    k = max(int(B * top_k_percent), 1)
    masked_cos = torch.where(eligible, cos, torch.full_like(cos, NEG))
    kth = torch.sort(masked_cos, dim=-1).values[:, -k][:, None]
    return eligible & (masked_cos >= kth), k


def _mined_logits(user_emb, item_emb, pos_item_ids, log_q, temperature, lambda_logq,
                  top_k_percent, threshold):
    """cos (B, B), hard mask, k, LogQ-corrected logits and the positive column."""
    cos = user_emb.float() @ item_emb.float().T
    hard, k = _hard_negative_mask(cos, pos_item_ids, top_k_percent, threshold)
    logits_all = cos / temperature - lambda_logq * log_q.float()[pos_item_ids][None, :]
    return cos, hard, k, logits_all, torch.diagonal(logits_all)[:, None]


def _first_column_ce(logits: torch.Tensor) -> torch.Tensor:
    """The JAX form's expression: the diagonal of the (B, 1) first column is
    its row 0 alone, so the mean is row 0's cross entropy. Kept as it is so
    that both packages compute the same loss (ROADMAP, Queue 3)."""
    return -torch.diagonal(F.log_softmax(logits, dim=-1)[:, :1]).mean()


def hnm_corrected_loss(user_emb: torch.Tensor, item_emb: torch.Tensor,
                       pos_item_ids: torch.Tensor, log_q: torch.Tensor, *,
                       temperature: float = 0.1, lambda_logq: float = 1.0,
                       top_k_percent: float = 0.01, threshold: float = 0.90):
    """Hard-negative-mined sampled softmax: CE over [positive | top-K% hard
    negatives], both LogQ-corrected. Returns (loss, stats)."""
    cos, hard, k, logits_all, pos = _mined_logits(
        user_emb, item_emb, pos_item_ids, log_q, temperature, lambda_logq,
        top_k_percent, threshold)
    hard_logits = torch.where(hard, logits_all, torch.full_like(logits_all, NEG))
    topk_vals = torch.topk(hard_logits, k, dim=-1).values   # k columns a row
    loss = _first_column_ce(torch.cat([pos, topk_vals], dim=-1))
    eye = torch.eye(cos.shape[0], dtype=torch.bool, device=cos.device)
    stats = {
        "hard_k": k,
        "hard_sim_mean": torch.where(hard, cos, torch.zeros_like(cos)).sum()
        / hard.sum().clamp(min=1),
        "excluded_too_similar": ((cos > threshold) & ~eye).sum(),
    }
    return loss, stats


def mixed_hnm_loss(user_emb: torch.Tensor, item_emb: torch.Tensor,
                   pos_item_ids: torch.Tensor, log_q: torch.Tensor,
                   generator: torch.Generator | None = None, *,
                   temperature: float = 0.1, lambda_logq: float = 1.0,
                   top_k_percent: float = 0.01, threshold: float = 0.90,
                   num_random: int = 100, rand_cols: torch.Tensor | None = None):
    """Hard + ``num_random`` uniformly drawn in-batch negatives. The random
    columns (B, min(num_random, B)) come from ``generator``, or are given as
    ``rand_cols``. Returns (loss, stats)."""
    B = user_emb.shape[0]
    _, hard, k, logits_all, pos = _mined_logits(
        user_emb, item_emb, pos_item_ids, log_q, temperature, lambda_logq,
        top_k_percent, threshold)
    topk_vals = torch.topk(torch.where(hard, logits_all, torch.full_like(logits_all, NEG)),
                           k, dim=-1).values
    if rand_cols is None:
        rand_cols = torch.randint(0, B, (B, min(num_random, B)), generator=generator,
                                  device=logits_all.device)
    rand_cols = rand_cols.long()
    rand_logits = torch.gather(logits_all, 1, rand_cols)
    eye = torch.eye(B, dtype=torch.bool, device=logits_all.device)
    self_or_same = torch.gather(
        (pos_item_ids[None, :] == pos_item_ids[:, None]) | eye, 1, rand_cols)
    rand_logits = torch.where(self_or_same, torch.full_like(rand_logits, NEG), rand_logits)
    loss = _first_column_ce(torch.cat([pos, topk_vals, rand_logits], dim=-1))
    return loss, {"hard_k": k}


def full_batch_hard_emphasis_loss(user_emb: torch.Tensor, item_emb: torch.Tensor,
                                  pos_item_ids: torch.Tensor, log_q: torch.Tensor, *,
                                  temperature: float = 0.1, lambda_logq: float = 1.0,
                                  top_k_percent: float = 0.01, threshold: float = 0.90,
                                  margin: float = 0.01) -> torch.Tensor:
    """Full-batch CE with an additive margin pushing mined hard negatives
    (``logits += mask * margin / tau``) and same-item masking."""
    _, hard, _, logits, _ = _mined_logits(
        user_emb, item_emb, pos_item_ids, log_q, temperature, lambda_logq,
        top_k_percent, threshold)
    logits = logits + hard.float() * (margin / temperature)
    B = logits.shape[0]
    eye = torch.eye(B, dtype=torch.bool, device=logits.device)
    same_item = (pos_item_ids[None, :] == pos_item_ids[:, None]) & ~eye
    return _ce_with_diag_labels(torch.where(same_item, torch.full_like(logits, NEG), logits))
