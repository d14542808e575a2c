"""Trainable hash-token text encoder.

Counterpart of ``HashTextEncoder`` in ``recsys_tpu/models/text_encoder.py``:
``embed_tokens`` is the embedding-only path for the RE fields, ``encode`` the
full contextual encoding of the product name. ``PretrainedTextEncoder`` is
not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from recsys_tpu_torch.models.layers import (BF16, Embed, TransformerEncoder, masked_mean,
                                            normal_param)


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
