"""Stage-1 item tower: 3-branch hybrid encoder + SimCSE projector.

Counterpart of ``recsys_tpu/models/item_tower.py``:

  branch A (STD):  Embed(std_vocab, D) + learned per-field embedding + LN
  branch B (RE):   token embeddings of the 9 LLM fields, masked mean-pool
                   per field -> (B, 9, D), + field-position params
  branch C (text): full text-encoder forward on the product name -> (B, 1, D)

The (B, F+9+1, D) token sequence is fused by a small pre-norm transformer,
masked-mean-pooled, passed through ``DeepResidualHead`` and L2-normalized.
Activations are bf16 over fp32 parameters, as in the JAX tower.
``cfg.text_encoder`` picks the text encoder (``"hash"`` or ``"pretrained"``,
``models/text_encoder.py``); either is the submodule ``text_encoder``.
"""

from __future__ import annotations

import torch
from torch import nn

from recsys_tpu_torch.config import ItemTowerConfig, VocabConfig
from recsys_tpu_torch.models.layers import (
    BF16,
    Dense,
    DeepResidualHead,
    Embed,
    LayerNorm,
    TransformerEncoder,
    gelu,
    l2_normalize,
    masked_mean,
    normal_param,
)
from recsys_tpu_torch.models.text_encoder import HashTextEncoder, PretrainedTextEncoder


class HybridItemTower(nn.Module):
    def __init__(self, std_vocab_size: int, num_std_fields: int,
                 cfg: ItemTowerConfig = ItemTowerConfig(),
                 vocab_cfg: VocabConfig = VocabConfig(), num_re_fields: int = 9):
        super().__init__()
        D = cfg.dim
        self.std_embedding = Embed(std_vocab_size, D)
        self.std_field_embedding = normal_param(num_std_fields, D)
        self.std_norm = LayerNorm(D)
        text = dict(vocab_size=vocab_cfg.text_vocab_size, dim=cfg.text_dim,
                    num_layers=cfg.text_layers, nhead=cfg.text_heads,
                    max_len=vocab_cfg.max_name_tokens)
        if cfg.text_encoder == "pretrained":
            self.text_encoder = PretrainedTextEncoder(pretrained_dim=cfg.pretrained_dim,
                                                      **text)
        elif cfg.text_encoder == "hash":
            self.text_encoder = HashTextEncoder(**text)
        else:
            raise ValueError(f"unknown item_tower.text_encoder {cfg.text_encoder!r} "
                             "(hash | pretrained)")
        self.re_projection = Dense(cfg.text_dim, D)
        self.re_field_embedding = normal_param(num_re_fields, D)
        self.re_norm = LayerNorm(D)
        self.text_projection = Dense(cfg.text_dim, D)
        self.fusion = TransformerEncoder(D, cfg.fusion_heads, cfg.fusion_layers,
                                         dropout_rate=cfg.dropout)
        self.head = DeepResidualHead(D, D, tuple(cfg.head_hidden))

    def forward(self, std, re_ids, re_mask, txt_ids, txt_mask,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B,F) (B,9,T) (B,9,T) (B,Tn) (B,Tn) -> (B, D) L2-normalized."""
        # A: STD categorical tokens; PAD fields masked
        a = self.std_norm(self.std_embedding(std)
                          + self.std_field_embedding[None].to(BF16))
        a_mask = (std > 0).int()

        # B: RE fields, embedding-only path + per-field masked mean pool
        pooled = masked_mean(self.text_encoder.embed_tokens(re_ids), re_mask, dim=-2)
        b = self.re_norm(self.re_projection(pooled)
                         + self.re_field_embedding[None].to(BF16))
        b_mask = (re_mask.sum(-1) > 0).int()

        # C: full text encoding of the product name
        c = self.text_projection(self.text_encoder.encode(txt_ids, txt_mask, generator))
        c_mask = torch.ones(std.shape[0], 1, dtype=torch.int32, device=std.device)

        seq = torch.cat([a, b, c[:, None, :].to(BF16)], dim=1)   # (B, F+9+1, D)
        mask = torch.cat([a_mask, b_mask, c_mask], dim=1)
        fused = self.fusion(seq, pad_mask=mask, generator=generator)
        return l2_normalize(self.head(masked_mean(fused, mask)))


class SimCSEProjector(nn.Module):
    """128 -> 128 -> 128 projection head + L2 norm, used only in training."""

    def __init__(self, dim: int = 128):
        super().__init__()
        self.Dense_0 = Dense(dim, dim)
        self.Dense_1 = Dense(dim, dim)

    def forward(self, x):
        return l2_normalize(self.Dense_1(gelu(self.Dense_0(x.to(BF16)))))


class SimCSEModel(nn.Module):
    """encoder + projector; ``encode`` is the deterministic serving path."""

    def __init__(self, std_vocab_size: int, num_std_fields: int,
                 cfg: ItemTowerConfig = ItemTowerConfig(),
                 vocab_cfg: VocabConfig = VocabConfig()):
        super().__init__()
        self.encoder = HybridItemTower(std_vocab_size, num_std_fields, cfg, vocab_cfg)
        self.projector = SimCSEProjector(cfg.dim)

    def forward(self, std, re_ids, re_mask, txt_ids, txt_mask,
                generator: torch.Generator | None = None):
        return self.projector(self.encoder(std, re_ids, re_mask, txt_ids, txt_mask,
                                           generator))

    def encode(self, std, re_ids, re_mask, txt_ids, txt_mask):
        """Encoder output without dropout, whatever the module's mode."""
        was_training = self.encoder.training
        self.encoder.eval()
        try:
            return self.encoder(std, re_ids, re_mask, txt_ids, txt_mask)
        finally:
            self.encoder.train(was_training)
