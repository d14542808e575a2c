"""LightGCL: SVD-augmented graph contrastive learning + the
magnitude->cosine distillation projector.

Counterpart of ``recsys_tpu/models/lightgcl.py``:

  * user/item embeddings (dim 64, xavier uniform init);
  * LOCAL view — n-layer propagation through the normalized adjacency,
    layer-mean;
  * GLOBAL view — propagation through the rank-q SVD reconstruction,
    layer-mean;
  * BPR pairwise loss on the local view; InfoNCE SSL between the local and
    global views of the batch's users/items (logits clamped to +-100,
    duplicate ids masked off the diagonal and weighted by 1/multiplicity;
    on the card the fused contrastive kernel K1, with the clamp inside it);
    L2 regularization on the batch's layer-0 embeddings.

``MagnitudeEncoder``: MLP 64 -> 128 -> 64 + L2 norm + learnable CLIP-style
logit scale, distilling the teacher's DOT-product scores (which carry
popularity via embedding magnitude) into pure cosine geometry.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from recsys_tpu_torch.config import GNNConfig
from recsys_tpu_torch.models.layers import gelu, l2_normalize, lecun_normal_
from recsys_tpu_torch.ops import use_kernel
from recsys_tpu_torch.ops.contrastive_kernel import fused_diag_ce
from recsys_tpu_torch.ops.graph import propagate, svd_propagate


class LightGCL(nn.Module):
    """``prop_fn(prop_args, x) -> A_norm @ x`` is the pluggable propagation
    backend: the plain gather + ``index_add_`` (ops/graph.propagate, the
    default, with ``prop_args = (src, dst, weight)``) or the CSR sparse
    product (ops/spmm.spmm) — selected in train/gnn.py."""

    def __init__(self, num_users: int, num_items: int, cfg: GNNConfig = GNNConfig(),
                 prop_fn: Callable | None = None):
        super().__init__()
        self.num_users, self.num_items, self.cfg = num_users, num_items, cfg
        self.prop_fn = prop_fn
        self.user_emb = nn.Parameter(torch.empty(num_users, cfg.emb_dim))
        self.item_emb = nn.Parameter(torch.empty(num_items, cfg.emb_dim))
        nn.init.xavier_uniform_(self.user_emb)
        nn.init.xavier_uniform_(self.item_emb)

    def forward(self, prop_args, svd_u, svd_s, svd_v):
        """Full-graph forward -> (local_u, local_i, global_u, global_i)."""
        n = self.num_users + self.num_items
        prop = self.prop_fn or (
            lambda args, x: propagate(x, args[0], args[1], args[2], n))
        x0 = torch.cat([self.user_emb, self.item_emb]).float()
        local_sum, global_sum = x0, x0
        x_loc, x_glb = x0, x0
        for _ in range(self.cfg.num_layers):
            x_loc = prop(prop_args, x_loc)
            x_glb = svd_propagate(x_glb, svd_u, svd_s, svd_v)
            local_sum = local_sum + x_loc
            global_sum = global_sum + x_glb
        denom = self.cfg.num_layers + 1
        local = local_sum / denom
        glob = global_sum / denom
        return (local[: self.num_users], local[self.num_users:],
                glob[: self.num_users], glob[self.num_users:])


def bpr_loss(local_u, local_i, users, pos, neg) -> torch.Tensor:
    u, p, ng = local_u[users.long()], local_i[pos.long()], local_i[neg.long()]
    diff = (u * p).sum(-1) - (u * ng).sum(-1)
    return -F.logsigmoid(diff).mean()


def ssl_loss_plain(local, glob, ids, temperature: float, clamp: float = 100.0) -> torch.Tensor:
    """InfoNCE aligning local vs global views of the SAME nodes against the
    other batch nodes. Duplicate batch ids are not negatives of each other
    and are down-weighted so that each unique node counts once. The plain
    form: the JAX package's passes over the (B, B) logits."""
    ids = ids.long()
    a = l2_normalize(local[ids])
    b = l2_normalize(glob[ids])
    logits = torch.clamp(a @ b.T / temperature, -clamp, clamp)
    same = ids[None, :] == ids[:, None]
    eye = torch.eye(ids.shape[0], dtype=torch.bool, device=ids.device)
    logits = logits.masked_fill(same & ~eye, -3e4)
    logp = torch.diagonal(F.log_softmax(logits, dim=-1))
    mult = same.sum(-1).float()
    return -(logp / mult).sum() / (1.0 / mult).sum().clamp(min=1.0)


def id_multiplicity(ids: torch.Tensor) -> torch.Tensor:
    """How often each entry's id occurs in ``ids`` (fp32): ``same.sum(-1)``
    of the plain form without the (B, B) compare. Two binary searches in the
    sorted ids; no host sync and no shape that depends on the data, so a
    CUDA graph captures it."""
    ids = ids.contiguous()
    sorted_ids = torch.sort(ids).values
    return (torch.searchsorted(sorted_ids, ids, right=True)
            - torch.searchsorted(sorted_ids, ids)).float()


def ssl_loss_fused(local, glob, ids, temperature: float, clamp: float = 100.0) -> torch.Tensor:
    """``ssl_loss_plain`` through the fused contrastive cross entropy (K1):
    per row ``lse_i - logit_ii`` with q, k the normalized local and global
    rows, no correction, every column valid and the batch ids as both
    masking ids (a duplicate is masked off the diagonal), the logits clamped
    in the kernel; then each row weighted by 1 / multiplicity. On CUDA
    tensors the kernels launch (or the call raises); on CPU tensors the same
    autograd function runs their plain math."""
    ids = ids.long()
    q = l2_normalize(local[ids])
    k = l2_normalize(glob[ids])
    B, dev = ids.shape[0], ids.device
    ids32 = ids.to(torch.int32)
    rows = fused_diag_ce(q, k, torch.zeros(B, dtype=torch.float32, device=dev), ids32, ids32,
                         torch.ones(B, dtype=torch.int32, device=dev), temperature, clamp)
    w = 1.0 / id_multiplicity(ids)
    return (rows * w).sum() / w.sum().clamp(min=1.0)


def ssl_route(device: torch.device | str) -> str:
    """Which form ``ssl_loss`` takes on ``device``: "diag_ce" (the kernel,
    on CUDA tensors) or "plain" (``ops.use_kernel("auto", ...)``)."""
    return "diag_ce" if use_kernel("auto", device) else "plain"


def ssl_loss(local, glob, ids, temperature: float, clamp: float = 100.0) -> torch.Tensor:
    """LightGCL's SSL InfoNCE: ``ssl_loss_fused`` on CUDA tensors,
    ``ssl_loss_plain`` on the CPU (``ssl_route``)."""
    fn = ssl_loss_fused if ssl_route(local.device) == "diag_ce" else ssl_loss_plain
    return fn(local, glob, ids, temperature, clamp)


def reg_loss(model: LightGCL, users, pos, neg) -> torch.Tensor:
    """L2 on the batch's rows of the layer-0 tables."""
    u = model.user_emb[users.long()]
    p = model.item_emb[pos.long()]
    ng = model.item_emb[neg.long()]
    return 0.5 * ((u ** 2).sum() + (p ** 2).sum() + (ng ** 2).sum()) / users.shape[0]


class MagnitudeEncoder(nn.Module):
    """Student projector folding dot-product magnitude into cosine angles.
    The activation is the tanh form of GELU, as in the JAX package."""

    def __init__(self, in_dim: int = 64, hidden: int = 128, out_dim: int = 64):
        super().__init__()
        # named as the Flax submodules, so the bridge maps them by path;
        # fp32 layers with Flax's default init (lecun normal, zero bias)
        self.Dense_0 = nn.Linear(in_dim, hidden)
        self.Dense_1 = nn.Linear(hidden, out_dim)
        for layer in (self.Dense_0, self.Dense_1):
            lecun_normal_(layer.weight)
            nn.init.zeros_(layer.bias)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(10.0)))

    def forward(self, x):
        h = self.Dense_1(gelu(self.Dense_0(x.float())))
        return l2_normalize(h), self.logit_scale


def distill_loss(student_u, student_i, scale, teacher_u, teacher_i) -> torch.Tensor:
    """MSE between teacher dot scores and student cos * exp(scale)."""
    t = teacher_u @ teacher_i.T
    s = (student_u @ student_i.T) * torch.exp(scale)
    return ((t - s) ** 2).mean()
