"""Shared building blocks (bf16 compute over fp32 params).

Counterpart of ``recsys_tpu/models/layers.py``. The JAX modules compute in
bf16 over fp32 parameters (every ``nn.Dense(dtype=bf16)``); these modules do
the same with explicit casts. Numerics follow Flax's defaults:

  * GELU is the tanh approximation (``nn.gelu``);
  * LayerNorm has eps 1e-6 and computes its statistics in fp32;
  * attention masks keys with the dtype's finite minimum, so a query whose
    keys are all masked gets uniform weights, not NaN;
  * attention dropout is one mask broadcast over batch and heads.

Submodules carry the Flax names (``Dense_0``, ``LayerNorm_1``, ...) so that
``bridge.py`` maps a Flax parameter tree onto a ``state_dict`` by path.
Dropout draws from the ``generator`` passed to ``forward`` (train mode
only), so every random bit of a training step comes from one
``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

BF16 = torch.bfloat16


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: torch.Generator | None = None,
            shape: Sequence[int] | None = None) -> torch.Tensor:
    """Inverted dropout; ``shape`` broadcasts one mask over some dims."""
    if not training or p <= 0.0:
        return x
    keep = torch.rand(tuple(shape or x.shape), generator=generator,
                      device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                         device=x.device))


def lecun_normal_(weight: torch.Tensor) -> torch.Tensor:
    """Flax's default kernel init: truncated normal, variance 1 / fan_in."""
    std = 1.0 / math.sqrt(weight.shape[1]) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)


class Dense(nn.Linear):
    """``nn.Dense(dtype=...)``: fp32 params; inputs and output in ``dtype``
    (bf16 by default, fp32 for the reranker models)."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = BF16):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype
        lecun_normal_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Embed(nn.Embedding):
    """``nn.Embed(dtype=...)``: fp32 table, rows out in ``dtype``."""

    def __init__(self, num_embeddings: int, features: int, dtype: torch.dtype = BF16):
        super().__init__(num_embeddings, features)
        self.compute_dtype = dtype
        nn.init.normal_(self.weight, std=1.0 / math.sqrt(features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return super().forward(ids).to(self.compute_dtype)


class _FewRowsLookup(torch.autograd.Function):
    """Rows of a table by id, the table's gradient summed in a fixed order:
    the product of the ids' one-hot matrix with the rows' gradients. On the
    card, PyTorch's embedding backward adds the gradients of a row that
    thousands of ids name in an order that changes from run to run, so two
    runs of one step from one state part at the last bit, and Adam can turn a
    last-bit sign of a near-zero gradient into a full step."""

    @staticmethod
    def forward(ctx, weight: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.rows = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (ids,) = ctx.saved_tensors
        rows = torch.arange(ctx.rows, device=ids.device)
        one_hot = (ids.reshape(-1, 1) == rows).to(grad.dtype)
        return one_hot.T @ grad.reshape(-1, grad.shape[-1]), None


class BucketEmbed(Embed):
    """``Embed`` for a table of a few rows that every position of a batch
    looks up (the time buckets): the same rows, the gradient by
    ``_FewRowsLookup``, the same from run to run."""

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return _FewRowsLookup.apply(self.weight, ids).to(self.compute_dtype)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm(dtype=bf16)``: fp32 statistics, bf16 output."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(BF16)


def normal_param(*shape: int, std: float = 0.02) -> nn.Parameter:
    return nn.Parameter(torch.randn(*shape) * std)


class MultiHeadDotProductAttention(nn.Module):
    """Flax ``nn.MultiHeadDotProductAttention`` for self-attention, with
    ``query``/``key``/``value``/``out`` stored as (H*hd, D) Linear layers."""

    def __init__(self, dim: int, num_heads: int, dropout_rate: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.query = Dense(dim, dim)
        self.key = Dense(dim, dim)
        self.value = Dense(dim, dim)
        self.out = Dense(dim, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        B, L, D = x.shape
        H = self.num_heads
        hd = D // H
        q = self.query(x).view(B, L, H, hd)
        k = self.key(x).view(B, L, H, hd)
        v = self.value(x).view(B, L, H, hd)
        q = q / torch.full((), math.sqrt(hd), dtype=q.dtype, device=q.device)  # no host copy
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            w = w.masked_fill(~mask, torch.finfo(w.dtype).min)
        w = torch.softmax(w.float(), dim=-1).to(q.dtype)
        w = dropout(w, self.dropout_rate, self.training, generator,
                    shape=(1, 1, L, L))
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, L, D)
        return self.out(o)


class MLP(nn.Module):
    def __init__(self, in_dim: int, features: Sequence[int],
                 activate_last: bool = False, dropout_rate: float = 0.0,
                 dtype: torch.dtype = BF16):
        super().__init__()
        self.n = len(features)
        self.activate_last = activate_last
        self.dropout_rate = dropout_rate
        dims = [in_dim, *features]
        for i in range(self.n):
            self.add_module(f"Dense_{i}", Dense(dims[i], dims[i + 1], dtype))

    def forward(self, x, generator: torch.Generator | None = None):
        for i in range(self.n):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n - 1 or self.activate_last:
                x = gelu(x)
                x = dropout(x, self.dropout_rate, self.training, generator)
        return x


class SEResidualBlock(nn.Module):
    """LayerNorm -> dim->4dim->dim GELU MLP, gated by a squeeze-excitation
    sigmoid path, residual add."""

    def __init__(self, dim: int, se_ratio: int = 4):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim)
        self.Dense_0 = Dense(dim, 4 * dim)
        self.Dense_1 = Dense(4 * dim, dim)
        self.Dense_2 = Dense(dim, dim // se_ratio)
        self.Dense_3 = Dense(dim // se_ratio, dim)

    def forward(self, x):
        h = self.Dense_1(gelu(self.Dense_0(self.LayerNorm_0(x))))
        gate = torch.sigmoid(self.Dense_3(gelu(self.Dense_2(h))))
        return x + h * gate


class DeepResidualHead(nn.Module):
    """Progressive expansion dim -> hidden[...] with SE blocks, compression
    back to dim, plus a global input skip."""

    def __init__(self, in_dim: int, dim: int = 128,
                 hidden: Sequence[int] = (256, 512)):
        super().__init__()
        self.n = len(hidden)
        self.input_skip = Dense(in_dim, dim)
        prev = in_dim
        for i, f in enumerate(hidden):
            self.add_module(f"Dense_{i}", Dense(prev, f))
            self.add_module(f"SEResidualBlock_{i}", SEResidualBlock(f))
            prev = f
        self.add_module(f"Dense_{self.n}", Dense(prev, dim))
        self.LayerNorm_0 = LayerNorm(dim)

    def forward(self, x):
        skip = self.input_skip(x)
        h = x
        for i in range(self.n):
            h = gelu(getattr(self, f"Dense_{i}")(h))
            h = getattr(self, f"SEResidualBlock_{i}")(h)
        h = getattr(self, f"Dense_{self.n}")(h)
        return self.LayerNorm_0(h + skip)


class TransformerBlock(nn.Module):
    """Pre-norm MHA + MLP block; the mask is over keys only."""

    def __init__(self, d_model: int, nhead: int, mlp_ratio: int = 4,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(d_model)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            d_model, nhead, dropout_rate)
        self.LayerNorm_1 = LayerNorm(d_model)
        self.MLP_0 = MLP(d_model, [mlp_ratio * d_model, d_model],
                         dropout_rate=dropout_rate)

    def forward(self, x, pad_mask=None, causal: bool = False,
                generator: torch.Generator | None = None):
        L = x.shape[1]
        attn_mask = None
        if pad_mask is not None:
            # (B, 1, 1, L): every query may attend only to real keys
            attn_mask = pad_mask[:, None, None, :].bool()
        if causal:
            tri = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x.device))
            attn_mask = tri[None, None] if attn_mask is None else attn_mask & tri
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x),
                                                    attn_mask, generator)
        return x + self.MLP_0(self.LayerNorm_1(x), generator)


class TransformerEncoder(nn.Module):
    def __init__(self, d_model: int, nhead: int, num_layers: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"TransformerBlock_{i}",
                            TransformerBlock(d_model, nhead, dropout_rate=dropout_rate))
        self.LayerNorm_0 = LayerNorm(d_model)

    def forward(self, x, pad_mask=None, causal: bool = False,
                generator: torch.Generator | None = None):
        for i in range(self.num_layers):
            x = getattr(self, f"TransformerBlock_{i}")(x, pad_mask, causal, generator)
        return self.LayerNorm_0(x)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """fp32 L2 normalization (embeddings leave towers normalized)."""
    x = x.float()
    return x / torch.sqrt((x * x).sum(dim=dim, keepdim=True) + eps)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """Mean over ``dim`` counting only mask==1 positions (safe for empty)."""
    m = mask.to(x.dtype)[..., None]
    return (x * m).sum(dim=dim) / m.sum(dim=dim).clamp(min=1e-6)
