"""Hybrid user tower: content + GNN fusion with gated adapters.

Counterpart of ``recsys_tpu/models/hybrid_tower.py``:

  * ``ResidualAdapter`` - gated residual MLP whose gate starts at +2
    (sigmoid ~= 0.88: the output begins ~88% passthrough);
  * ``ParallelAdapter`` - content (Dc) (+) GNN (Dg) -> D item representation:
    two Dense projections, summed, LayerNorm;
  * ``SequenceCentricFusion`` - the sequence signal at weight 1.0, the GNN-user
    and metadata signals through sigmoid gates that start at -5 (~= 0.007);
  * ``HybridUserTower`` - a causal transformer over the adapted item vectors
    (4 layers: the class default, which the trainer keeps, not
    ``user_tower.num_layers``), a metadata MLP, the user's GNN embedding scaled
    by ``gnn_signal_scale`` and, in training, dropped whole per user with
    probability ``gnn_dropout`` (one (B, 1) Bernoulli draw, no rescaling), and
    the learnable CLIP scale ``logit_scale`` (starts at log(1 / 0.07)) that
    the trainer's loss, ``ops/contrastive.corrected_logq_with_recovery``, reads.

Dense layers compute in bf16 over fp32 parameters, LayerNorms output bf16,
the gates and ``logit_scale`` are fp32 scalars of shape (). Submodules carry
the Flax names (``item_adapter``, ``id_embedding``, ``fusion/gnn_user_proj``,
...), so ``bridge.py`` maps the JAX parameter tree one to one. Dropout and the
GNN keep mask draw from the ``generator`` passed to ``forward`` in train mode;
``gnn_keep`` fixes the mask instead.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from recsys_tpu_torch.config import UserTowerConfig
from recsys_tpu_torch.models.layers import (
    BF16, MLP, BucketEmbed, Dense, Embed, LayerNorm, TransformerEncoder, gelu, l2_normalize,
    normal_param)


class ResidualAdapter(nn.Module):
    def __init__(self, dim: int, gate_bias_init: float = 2.0, in_dim: int | None = None):
        super().__init__()
        self.Dense_0 = Dense(in_dim or dim, dim)
        self.Dense_1 = Dense(dim, dim)
        self.gate = nn.Parameter(torch.tensor(float(gate_bias_init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.Dense_1(gelu(self.Dense_0(x)))
        g = torch.sigmoid(self.gate.float())
        return g * x.float() + (1.0 - g) * h.float()


class ParallelAdapter(nn.Module):
    """content (Dc) + gnn (Dg) -> fused item representation (D)."""

    def __init__(self, content_dim: int, gnn_dim: int, out_dim: int = 128):
        super().__init__()
        self.content_proj = Dense(content_dim, out_dim)
        self.gnn_proj = Dense(gnn_dim, out_dim)
        self.LayerNorm_0 = LayerNorm(out_dim)

    def forward(self, content: torch.Tensor, gnn: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm_0(self.content_proj(content) + self.gnn_proj(gnn))


class SequenceCentricFusion(nn.Module):
    """seq * 1.0 + sigmoid(gate_gnn) * gnn + sigmoid(gate_meta) * meta."""

    def __init__(self, dim: int = 128, gnn_dim: int = 64, gate_init: float = -5.0):
        super().__init__()
        self.gate_gnn = nn.Parameter(torch.tensor(float(gate_init)))
        self.gate_meta = nn.Parameter(torch.tensor(float(gate_init)))
        self.gnn_user_proj = Dense(gnn_dim, dim)
        self.meta_proj = Dense(dim, dim)
        self.out_proj = Dense(dim, dim)

    def forward(self, seq: torch.Tensor, gnn_user: torch.Tensor,
                meta: torch.Tensor) -> torch.Tensor:
        g_gnn = torch.sigmoid(self.gate_gnn.float())
        g_meta = torch.sigmoid(self.gate_meta.float())
        fused = (seq.float() + g_gnn * self.gnn_user_proj(gnn_user).float()
                 + g_meta * self.meta_proj(meta).float())
        return self.out_proj(fused)


class HybridUserTower(nn.Module):
    def __init__(self, cfg: UserTowerConfig = UserTowerConfig(), num_id_embeddings: int = 1,
                 content_dim: int = 128, gnn_dim: int = 64, num_layers: int = 4,
                 gnn_signal_scale: float = 1.0, gnn_dropout: float = 0.3):
        super().__init__()
        c = self.cfg = cfg
        D = c.d_model
        self.gnn_signal_scale = gnn_signal_scale
        self.gnn_dropout = gnn_dropout
        self.item_adapter = ParallelAdapter(content_dim, gnn_dim, D)
        self.id_embedding = Embed(num_id_embeddings, D)
        self.time_embedding = BucketEmbed(c.num_time_buckets, D)
        self.pos_embedding = normal_param(c.max_len, D, std=0.02)
        self.seq_norm = LayerNorm(D)
        self.encoder = TransformerEncoder(D, c.nhead, num_layers, dropout_rate=c.dropout)
        meta_in = c.static_bucket_fields + c.static_cat_fields + c.static_cont_fields
        self.meta_mlp = MLP(meta_in, [64, D], dropout_rate=c.dropout)
        self.fusion = SequenceCentricFusion(D, gnn_dim)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def adapt_items(self, content_vecs: torch.Tensor, gnn_item_vecs: torch.Tensor) -> torch.Tensor:
        """Item-side path, also used to precompute the catalog matrix."""
        return self.item_adapter(content_vecs, gnn_item_vecs)

    def forward(self, content_vecs, gnn_item_vecs, input_ids, time_buckets, seq_mask,
                gnn_user, user_buckets, user_cats, user_cont, *,
                generator: torch.Generator | None = None,
                gnn_keep: torch.Tensor | None = None) -> torch.Tensor:
        """Last-step user vector (B, D), L2-normalized. In train mode dropout
        and the GNN keep mask are drawn from ``generator`` (``gnn_keep``, a
        (B, 1) bool tensor, fixes the mask)."""
        B, L = input_ids.shape
        x = (self.item_adapter(content_vecs, gnn_item_vecs) + self.id_embedding(input_ids)
             + self.time_embedding(time_buckets))
        x = x + self.pos_embedding[None, :L].to(BF16)
        x = self.seq_norm(x)
        seq_out = self.encoder(x, pad_mask=seq_mask, causal=True, generator=generator)[:, -1]

        gnn_sig = gnn_user.float() * self.gnn_signal_scale
        if self.training and self.gnn_dropout > 0:
            if gnn_keep is None:
                gnn_keep = torch.rand((B, 1), generator=generator,
                                      device=gnn_sig.device) < 1.0 - self.gnn_dropout
            gnn_sig = gnn_sig * gnn_keep.to(gnn_sig.device, gnn_sig.dtype)
        meta = torch.cat([user_buckets.float(), user_cats.float(), user_cont.float()], dim=-1)
        meta = self.meta_mlp(meta, generator)
        return l2_normalize(self.fusion(seq_out, gnn_sig, meta))
