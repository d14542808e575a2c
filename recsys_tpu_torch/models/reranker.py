"""Reranker models: DCN-v2 cross network + DeepFM.

Counterpart of ``recsys_tpu/models/reranker.py``, fp32 throughout:

  * ``CrossNet`` — explicit feature crossing
    ``x_{l+1} = x_0 * (W x_l + b) + x_l`` (DCN-v2);
  * ``DCNRanker`` — dual-path cross + deep -> score logit, with a broadcast
    ``score_for_user`` helper;
  * ``DeepFM`` — per-field id embeddings, first-order weights, the FM
    second-order term + a deep MLP over the concatenated field embeddings.
    The FM term goes through ``ops.select_fm("auto")``: the hand-written CUDA
    kernel (``ops/fm_kernel.py``, forward and backward) for CUDA tensors, the
    plain form for CPU ones.

Submodules carry the Flax names (``CrossNet_0``/``cross_{i}``, ``MLP_0``,
``score``, ``fm_embed_{f}``, ``fm_first_{f}``, ``dense_embed``, ``bias``) so
that ``bridge.py`` maps a Flax parameter tree by path. Dropout follows the
module's train/eval mode, like every module of the port; the trainers in
``train/reranker.py`` keep these models in eval mode.

The gradient-boosted alternative lives in ``train/reranker.py`` as
``GBDTRanker``.
"""

from __future__ import annotations

import torch
from torch import nn

from recsys_tpu_torch.config import RerankerConfig
from recsys_tpu_torch.models.layers import MLP, Dense, Embed
from recsys_tpu_torch.ops import select_fm

F32 = torch.float32


class CrossNet(nn.Module):
    def __init__(self, dim: int, num_layers: int = 3):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"cross_{i}", Dense(dim, dim, F32))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x0 = x0.float()
        x = x0
        for i in range(self.num_layers):
            x = x0 * getattr(self, f"cross_{i}")(x) + x
        return x


class DCNRanker(nn.Module):
    """(B, F) dense features -> (B,) click probability logit."""

    def __init__(self, num_features: int, cfg: RerankerConfig = RerankerConfig()):
        super().__init__()
        self.cfg = cfg
        hidden = list(cfg.deep_hidden)
        self.CrossNet_0 = CrossNet(num_features, cfg.cross_layers)
        self.MLP_0 = MLP(num_features, hidden, activate_last=True,
                         dropout_rate=cfg.dropout, dtype=F32)
        self.score = Dense(num_features + hidden[-1], 1, F32)

    def forward(self, features: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        cross = self.CrossNet_0(features)
        deep = self.MLP_0(features.float(), generator)
        return self.score(torch.cat([cross, deep], dim=-1))[..., 0]

    def score_for_user(self, user_features: torch.Tensor, item_features: torch.Tensor,
                       generator: torch.Generator | None = None) -> torch.Tensor:
        """(F_u,) x (N, F_i) -> (N,) — broadcast one user over candidates."""
        u = user_features[None, :].expand(item_features.shape[0], -1)
        return self(torch.cat([u, item_features], dim=-1), generator)


class DeepFM(nn.Module):
    """Sparse-field DeepFM: ids (B, F) [+ dense (B, num_dense)] -> logit (B,).

    With ``num_dense`` the dense block is embedded as one more field, so the
    FM term and the deep input see F + 1 fields."""

    def __init__(self, field_sizes: tuple[int, ...], cfg: RerankerConfig = RerankerConfig(),
                 num_dense: int = 0):
        super().__init__()
        self.field_sizes, self.cfg, self.num_dense = tuple(field_sizes), cfg, num_dense
        K = cfg.fm_embed_dim
        for f, size in enumerate(self.field_sizes):
            self.add_module(f"fm_embed_{f}", Embed(size, K, F32))
            self.add_module(f"fm_first_{f}", Embed(size, 1, F32))
        if num_dense:
            self.dense_embed = Dense(num_dense, K, F32)
        fields = len(self.field_sizes) + (1 if num_dense else 0)
        self.MLP_0 = MLP(fields * K, [*cfg.deep_hidden, 1], dropout_rate=cfg.dropout,
                         dtype=F32)
        self.bias = nn.Parameter(torch.zeros(()))
        self.fm = select_fm("auto")

    def forward(self, ids: torch.Tensor, dense: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        ids = ids.long()
        embs = [getattr(self, f"fm_embed_{f}")(ids[:, f])
                for f in range(len(self.field_sizes))]
        firsts = [getattr(self, f"fm_first_{f}")(ids[:, f])
                  for f in range(len(self.field_sizes))]
        if dense is not None and self.num_dense:
            embs.append(self.dense_embed(dense.float()))
        v = torch.stack(embs, dim=1)                          # (B, F, K)
        first_order = torch.cat(firsts, dim=-1).sum(dim=-1)
        second = self.fm(v)                                   # (B,)
        deep = self.MLP_0(v.reshape(v.shape[0], -1), generator)[..., 0]
        return self.bias + first_order + second + deep
