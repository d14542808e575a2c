"""SimCSE view corruption on the device, driven by a ``torch.Generator``.

Counterpart of ``corrupt_view`` / ``two_views`` in
``recsys_tpu/ops/augment.py``. Item tensors carry per-token value ids, so
the reference's dict corruption is pure masking:

  * drop individual RE values with prob ``p``          (value-level dropout)
  * drop whole RE fields with prob ``max(p - 0.1, 0)`` (key-level dropout)
  * delete one random word of the product name with prob 0.5, never
    emptying a name of one token

Only the masks change. The random bits differ from ``jax.random``'s; the
contract and the rates are the same.

``random_cut`` is the stage-2 sequence augmentation. The random draws of
both augmentations (``corrupt_view_draws``; the gate and the cut position,
``random_cut_draws``) are kept apart from their arithmetic
(``apply_corrupt_view``, ``apply_random_cut``), so that a test can feed them
the JAX package's draws and hold the arithmetic exactly.
"""

from __future__ import annotations

import torch

MAX_VALUES = 16  # upper bound on distinct values per RE field


def _bernoulli(p: float, shape, generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device) < p


def corrupt_view_draws(batch: dict, generator: torch.Generator | None,
                       dropout_prob: float) -> dict:
    """The random draws of one view, in the generator's order: ``value_drop``
    (B, F, MAX_VALUES) and ``key_drop`` (B, F), the drop coins of the RE
    values and fields; ``name_gate`` (B,), whether a name word is deleted;
    ``victim`` (B,), which word, uniform over the name's real tokens."""
    re_mask, txt_mask = batch["re_mask"], batch["txt_mask"]
    B, F, _ = re_mask.shape
    dev = re_mask.device
    value_drop = _bernoulli(dropout_prob, (B, F, MAX_VALUES), generator, dev)
    key_drop = _bernoulli(max(dropout_prob - 0.1, 0.0), (B, F), generator, dev)
    name_gate = _bernoulli(0.5, (B,), generator, dev)
    scores = torch.rand(txt_mask.shape, generator=generator, device=dev)
    victim = torch.where(txt_mask > 0, scores, torch.full_like(scores, -1.0)).argmax(-1)
    return {"value_drop": value_drop, "key_drop": key_drop, "name_gate": name_gate,
            "victim": victim}


def apply_corrupt_view(batch: dict, draws: dict) -> dict:
    """The view that ``draws`` (``corrupt_view_draws``) make of the batch:
    only the masks change."""
    re_mask, re_value = batch["re_mask"], batch["re_value"]   # (B, F, T)
    # value-level dropout: one coin per (item, field, value)
    token_dropped = torch.gather(draws["value_drop"], 2,
                                 (re_value.long() - 1).clamp(0, MAX_VALUES - 1))
    # key-level dropout: one coin per (item, field)
    keep = ~token_dropped & ~draws["key_drop"][..., None]
    new_re_mask = re_mask * keep.to(re_mask.dtype)

    # name-word deletion: zero the victim token of the gated names
    txt_mask = batch["txt_mask"]                              # (B, Tn)
    one_hot = torch.nn.functional.one_hot(draws["victim"].long(), txt_mask.shape[1])
    one_hot = one_hot.to(txt_mask.dtype)
    # a name of one token keeps it (an empty name would zero the mean pool)
    delete = draws["name_gate"] & (txt_mask.sum(-1) > 1)
    new_txt_mask = torch.where(delete[:, None], txt_mask * (1 - one_hot), txt_mask)

    out = dict(batch)
    out["re_mask"] = new_re_mask
    out["txt_mask"] = new_txt_mask
    return out


def corrupt_view(batch: dict, generator: torch.Generator | None,
                 dropout_prob: float) -> dict:
    """Return a corrupted copy of the item batch (only masks change)."""
    return apply_corrupt_view(batch, corrupt_view_draws(batch, generator, dropout_prob))


def two_views(batch: dict, generator: torch.Generator | None,
              dropout_prob: float) -> tuple[dict, dict]:
    return (corrupt_view(batch, generator, dropout_prob),
            corrupt_view(batch, generator, dropout_prob))


SASREC_SEQ_KEYS = ("input_ids", "target_ids", "time_buckets", "seq_mask")


def random_cut_draws(seq_mask: torch.Tensor, prob: float,
                     generator: torch.Generator | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(gate (B,) bool, cut (B,) int64): which rows are cut, with probability
    ``prob``, and at which position, uniform over the row's real positions."""
    B, L = seq_mask.shape
    dev = seq_mask.device
    gate = _bernoulli(prob, (B,), generator, dev)
    scores = torch.rand((B, L), generator=generator, device=dev)
    cut = torch.where(seq_mask > 0, scores, torch.full_like(scores, -1.0)).argmax(-1)
    return gate, cut


def apply_random_cut(batch: dict, gate: torch.Tensor, cut: torch.Tensor) -> dict:
    """Truncate the gated rows after ``cut`` and shift them right so that the
    cut point sits at the last slot (the left-padding invariant); other rows
    are left as they are. Positions shifted in from the left are zeros."""
    mask = batch["seq_mask"]
    B, L = mask.shape
    cut = torch.where(gate.to(mask.device), cut.to(mask.device), torch.full_like(cut, L - 1))
    shift = (L - 1) - cut                                     # right-shift amount
    src = torch.arange(L, device=mask.device)[None, :] - shift[:, None]
    inside = src >= 0
    src = src.clamp(0, L - 1)
    out = dict(batch)
    for key in SASREC_SEQ_KEYS:
        rolled = torch.gather(batch[key], 1, src)
        out[key] = torch.where(inside, rolled, torch.zeros_like(rolled))
    return out


def random_cut(batch: dict, prob: float = 0.2,
               generator: torch.Generator | None = None) -> dict:
    """Random-cut augmentation of a SASRec batch (input_ids, target_ids,
    time_buckets, seq_mask, all (B, L), left-padded): with probability
    ``prob`` per user, keep the history up to a uniformly chosen real position
    and re-align it to the right. A cut row keeps at least one real position."""
    gate, cut = random_cut_draws(batch["seq_mask"], prob, generator)
    return apply_random_cut(batch, gate, cut)
