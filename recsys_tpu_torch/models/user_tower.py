"""Stage-2 user tower: SASRec-style causal transformer + gated static branch.

Counterpart of ``recsys_tpu/models/user_tower.py``:

  * sequence branch - per-position sum of the projected content item vector
    (from the stage-1 matrix), a learnable id embedding and a time-bucket
    embedding, each scaled by a sigmoid feature gate (``seq_gate``), plus a
    learned positional embedding, LayerNorm, dropout, then a causal pre-norm
    transformer with a key-padding mask. The side-info gates are off
    (``enable_side_gates=False``, as in the JAX tower): their embeddings are
    never called, so the JAX tree has no ``side_embedding_*`` parameter and
    this module has none either;
  * static branch - bucket embeddings (16-d), low-cardinality categorical
    embeddings (4-d) and a continuous projection, each gated
    (``static_gate``), concatenated -> MLP -> d_model;
  * late fusion - concat(seq, static) -> output projection -> fp32 L2 norm.
    ``all_timesteps=True`` gives (B, L, D); ``False`` the last slot's (B, D),
    which left padding makes every user's newest event.

Activations are bf16 over fp32 parameters. A query on a padding row sees only
padding keys; both packages give it a uniform softmax over the dtype's
minimum, and this module keeps that. Submodules carry the Flax names, so
``bridge.py`` maps the JAX parameter trees one to one.

``SASRecItemTower`` holds the trainable (N+1, D) item matrix (row 0 = PAD),
initialised from the stage-1 artifact; ``Stage2Model`` holds both towers as
``user`` and ``item``, the JAX package's ``{"user": ..., "item": ...}`` tree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from recsys_tpu_torch.config import UserTowerConfig
from recsys_tpu_torch.models.layers import (
    BF16,
    MLP,
    BucketEmbed,
    Dense,
    Embed,
    LayerNorm,
    TransformerEncoder,
    dropout,
    l2_normalize,
    normal_param,
)


class SASRecItemTower(nn.Module):
    """Trainable item-embedding matrix, PAD row 0. The lookup is an embedding
    lookup: its gradient sums each row's incoming gradients, the function of
    ``jnp.take`` and its scatter-add VJP, through the embedding backward
    rather than the slower index backward of ``item_matrix[ids]``."""

    def __init__(self, num_items: int, dim: int = 128):
        super().__init__()
        self.item_matrix = normal_param(num_items, dim, std=0.02)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.item_matrix)


class SASRecUserTower(nn.Module):
    def __init__(self, cfg: UserTowerConfig = UserTowerConfig(), num_id_embeddings: int = 1):
        super().__init__()
        c = self.cfg = cfg
        D = c.d_model
        self.item_proj = Dense(D, D)
        self.id_embedding = Embed(num_id_embeddings, D)
        self.time_embedding = BucketEmbed(c.num_time_buckets, D)
        # [content, id, time, side0..sideS]; the side gates stay unused
        self.seq_gate = nn.Parameter(torch.zeros(3 + c.num_side_fields))
        self.pos_embedding = normal_param(c.max_len, D, std=0.02)
        self.seq_norm = LayerNorm(D)
        self.encoder = TransformerEncoder(D, c.nhead, c.num_layers, dropout_rate=c.dropout)
        for i in range(c.static_bucket_fields):
            setattr(self, f"bucket_embedding_{i}", Embed(16, c.bucket_emb_dim))
        for i in range(c.static_cat_fields):
            setattr(self, f"cat_embedding_{i}", Embed(8, c.cat_emb_dim))
        self.cont_proj = Dense(c.static_cont_fields, c.cont_proj_dim)
        self.static_gate = nn.Parameter(
            torch.zeros(c.static_bucket_fields + c.static_cat_fields + 1))
        static_in = (c.static_bucket_fields * c.bucket_emb_dim
                     + c.static_cat_fields * c.cat_emb_dim + c.cont_proj_dim)
        self.static_mlp = MLP(static_in, [static_in, D], dropout_rate=c.dropout)
        self.output_proj = Dense(2 * D, D)

    def forward(self, item_vecs, input_ids, time_buckets, seq_mask, user_buckets,
                user_cats, user_cont, *, all_timesteps: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """item_vecs (B, L, D) content vectors of the input items; returns
        (B, L, D) if ``all_timesteps`` else (B, D), L2-normalized. Dropout
        runs in train mode, drawn from ``generator``."""
        c = self.cfg
        L = input_ids.shape[1]
        gates = torch.sigmoid(self.seq_gate.float()).to(BF16)
        x = self.item_proj(item_vecs) * gates[0]
        x = x + self.id_embedding(input_ids) * gates[1]
        x = x + self.time_embedding(time_buckets) * gates[2]
        x = x + self.pos_embedding[None, :L].to(BF16)
        x = dropout(self.seq_norm(x), c.dropout, self.training, generator)
        seq_out = self.encoder(x, pad_mask=seq_mask, causal=True, generator=generator)

        sg = torch.sigmoid(self.static_gate.float()).to(BF16)
        parts = [getattr(self, f"bucket_embedding_{i}")(user_buckets[:, i].clamp(0, 15)) * sg[i]
                 for i in range(c.static_bucket_fields)]
        off = c.static_bucket_fields
        parts += [getattr(self, f"cat_embedding_{i}")(user_cats[:, i].clamp(0, 7)) * sg[off + i]
                  for i in range(c.static_cat_fields)]
        parts.append(self.cont_proj(user_cont) * sg[off + c.static_cat_fields])
        static = self.static_mlp(torch.cat(parts, dim=-1), generator)          # (B, D)

        if all_timesteps:
            fused = torch.cat([seq_out, static[:, None, :].expand_as(seq_out)], dim=-1)
        else:
            fused = torch.cat([seq_out[:, -1], static], dim=-1)
        return l2_normalize(self.output_proj(fused))


class Stage2Model(nn.Module):
    """Both stage-2 towers: ``user`` (SASRec) and ``item`` (the matrix)."""

    def __init__(self, cfg: UserTowerConfig, num_items_pad: int):
        super().__init__()
        self.user = SASRecUserTower(cfg, num_id_embeddings=num_items_pad)
        self.item = SASRecItemTower(num_items_pad, cfg.d_model)
