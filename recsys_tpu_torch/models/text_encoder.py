"""Pluggable text encoder: two implementations behind one interface.

Counterpart of ``recsys_tpu/models/text_encoder.py``. ``embed_tokens`` is
the embedding-only path for the RE fields, ``encode`` the full contextual
encoding of the product name:

  * ``HashTextEncoder``: the trainable default over hashed token ids;
  * ``PretrainedTextEncoder``: a frozen corpus-pretrained token table (the
    PPMI-SVD artifact of ``data/text_pretrain.py``) under a trainable
    projection and contextual encoder. The table is frozen twice over, as in
    the JAX package: the parameter takes no gradient (``requires_grad`` off,
    and ``_table`` hands it on detached), and the optimizer leaves it out
    (``train/state.grouped_adamw``), so neither an update nor weight decay
    ever touches it. It is still a parameter, so it rides ``state_dict`` and
    every checkpoint.
"""

from __future__ import annotations

import torch
from torch import nn

from recsys_tpu_torch.models.layers import (BF16, Dense, Embed, TransformerEncoder,
                                            masked_mean, normal_param)


class HashTextEncoder(nn.Module):
    def __init__(self, vocab_size: int = 8192, dim: int = 128, num_layers: int = 2,
                 nhead: int = 4, max_len: int = 32):
        super().__init__()
        self.token_embedding = Embed(vocab_size, dim)
        self.pos_embedding = normal_param(max_len, dim)
        self.encoder = TransformerEncoder(dim, nhead, num_layers)

    def embed_tokens(self, ids: torch.Tensor) -> torch.Tensor:
        """(..., T) -> (..., T, dim)."""
        return self.token_embedding(ids)

    def encode(self, ids: torch.Tensor, mask: torch.Tensor,
               generator: torch.Generator | None = None) -> torch.Tensor:
        """Contextual encoding + masked mean pool. (B, T) -> (B, dim)."""
        x = self.token_embedding(ids) + self.pos_embedding[None, : ids.shape[1]].to(BF16)
        x = self.encoder(x, pad_mask=mask, generator=generator)
        return masked_mean(x, mask)


class PretrainedTextEncoder(nn.Module):
    """Frozen (vocab_size, pretrained_dim) token table + trainable projection
    and encoder. The artifact is copied into ``pretrained_embedding`` after
    init (``train/simcse.train_simcse``)."""

    def __init__(self, vocab_size: int = 8192, dim: int = 128, pretrained_dim: int = 128,
                 num_layers: int = 2, nhead: int = 4, max_len: int = 32):
        super().__init__()
        self.pretrained_embedding = nn.Parameter(
            torch.randn(vocab_size, pretrained_dim) * 0.02, requires_grad=False)
        self.pretrained_proj = Dense(pretrained_dim, dim)
        self.pos_embedding = normal_param(max_len, dim)
        self.encoder = TransformerEncoder(dim, nhead, num_layers)

    def _table(self) -> torch.Tensor:
        return self.pretrained_embedding.detach()

    def embed_tokens(self, ids: torch.Tensor) -> torch.Tensor:
        """Frozen-table lookup (gathered in fp32, then cast, as ``jnp.take``
        then ``astype``) + trainable projection. (..., T) -> (..., T, dim)."""
        return self.pretrained_proj(self._table()[ids].to(BF16))

    def encode(self, ids: torch.Tensor, mask: torch.Tensor,
               generator: torch.Generator | None = None) -> torch.Tensor:
        """Frozen embeddings -> trainable contextual encoder + masked mean.
        (B, T) -> (B, dim)."""
        x = self.embed_tokens(ids) + self.pos_embedding[None, : ids.shape[1]].to(BF16)
        x = self.encoder(x, pad_mask=mask, generator=generator)
        return masked_mean(x, mask)
