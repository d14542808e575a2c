"""Int8-quantized full-catalog retrieval scoring.

Counterpart of ``recsys_tpu/ops/quant.py``. The catalog is stored per-CHANNEL
symmetric int8 over the (row-normalized) item matrix, and the channel scales
are folded into the query:

    score_j = sum_d u_d * (q_jd * s_d) = sum_d (u_d * s_d) * q_jd

The query is then per-ROW quantized (v ~= alpha * vq), so the product is
int8 x int8 into an int32 accumulator; alpha > 0 never reorders a row.

On the card the product is ``torch._int_mm`` (the int8 tensor cores; the JAX
package leaves it to XLA's ``dot_general`` outside any Pallas kernel, so it
stays a library call here too) on operands padded with zeros to the shapes
it takes; on the CPU it is a float64 product, exact for these integers. Both
equal the exact integer product. The top-k is ``ops/topk.stable_topk``:
equal scores lowest index first, as ``jax.lax.top_k``, PAD row 0 last.
``method="approx"`` is ``jax.lax.approx_max_k`` as the TPU computes it
(``ops/approx_topk.py``): the int8 kernel bins the dequantized scores inside
the scan on the card, the plain form does on the CPU, then the top-k of the
bins' winners.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from recsys_tpu_torch.device import resolve_device
from recsys_tpu_torch.ops.approx_topk import approx_bins, approx_topk_int8
from recsys_tpu_torch.ops.topk import stable_topk

_INT32_MIN = -(1 << 31)
# an int32 accumulator keeps the float scores' order while 127^2 * D < 2^23
_EXACT_ORDER_DIM = (1 << 23) // (127 * 127)
# scores held at once: (query rows of a chunk) x (catalog rows)
_CHUNK_ELEMENTS = 1 << 28


@dataclass
class QuantizedItems:
    """int8 catalog + the per-channel dequantization scale."""

    q: torch.Tensor            # (N+1, D) int8, row 0 = PAD
    col_scale: torch.Tensor    # (D,) float32; items ~= q * col_scale[None, :]
    _padded: torch.Tensor | None = field(default=None, repr=False)

    def gemm_operand(self) -> torch.Tensor:
        """q with zero rows and columns up to multiples of 8 (what
        ``torch._int_mm`` takes), made once."""
        if self._padded is None:
            n, d = self.q.shape
            pad = torch.zeros((-(-n // 8) * 8, -(-d // 8) * 8), dtype=torch.int8,
                              device=self.q.device)
            pad[:n, :d] = self.q
            self._padded = pad
        return self._padded


def quantize_items_int8(item_matrix, normalize: bool = True,
                        device: torch.device | str = "cuda") -> QuantizedItems:
    """Per-channel symmetric int8 quantization of the item matrix, on
    ``device``. ``normalize`` L2-normalizes rows first (cosine retrieval, the
    serving default, as ``topk_scores(normalize_items=True)``)."""
    items = torch.as_tensor(item_matrix, dtype=torch.float32, device=resolve_device(device))
    if normalize:
        items = items / torch.linalg.vector_norm(items, dim=-1, keepdim=True).clamp(min=1e-12)
    amax = items.abs().amax(dim=0)
    col_scale = (amax / 127.0).clamp(min=1e-12)
    q = torch.round(items / col_scale[None, :]).clamp(-127, 127).to(torch.int8)
    return QuantizedItems(q, col_scale)


def _quantize_queries(user_vecs: torch.Tensor, col_scale: torch.Tensor):
    u = user_vecs.float() * col_scale[None, :]
    alpha = (u.abs().amax(dim=-1, keepdim=True) / 127.0).clamp(min=1e-12)
    uq = torch.round(u / alpha).clamp(-127, 127).to(torch.int8)
    return uq, alpha


def int8_accumulate(uq: torch.Tensor, qitems: QuantizedItems) -> torch.Tensor:
    """(B, D) int8 x (N+1, D) int8 -> (B, N+1) int32, the exact integer
    product. On the card: ``torch._int_mm`` on zero-padded operands (at
    least 17 query rows, sizes in multiples of 8); on the CPU: float64."""
    n, d = qitems.q.shape
    if not uq.is_cuda:
        return (uq.double() @ qitems.q.double().T).to(torch.int32)
    rows = uq.shape[0]
    a = torch.zeros((max(17, -(-rows // 8) * 8), -(-d // 8) * 8), dtype=torch.int8,
                    device=uq.device)
    a[:rows, :d] = uq
    return torch._int_mm(a, qitems.gemm_operand().T)[:rows, :n]


def int8_topk(user_vecs, qitems: QuantizedItems, k: int, method: str = "exact",
              recall_target: float = 0.95):
    """(B, D) fp queries x int8 catalog -> (approx fp32 vals, idx) (B, k).

    PAD row 0 is excluded, same contract as ``eval/recall.topk_scores``.
    Queries are taken in chunks so that at most 2^28 scores (with
    ``method="approx"`` on the card, bins) are held at once.
    ``method="approx"`` takes ``jax.lax.approx_max_k``'s answer at
    ``recall_target`` on the dequantized scores, through
    ``ops/approx_topk.approx_topk_int8``.
    """
    if method not in ("exact", "approx"):
        raise ValueError(f"int8_topk method {method!r}: want 'exact' or 'approx'")
    u = torch.as_tensor(user_vecs, dtype=torch.float32, device=qitems.q.device)
    uq, alpha = _quantize_queries(u, qitems.col_scale)
    n, d = qitems.q.shape
    held = n
    if method == "approx":
        bins, _ = approx_bins(n, k, recall_target)
        held = bins if qitems.q.is_cuda else n
    step = max(1, _CHUNK_ELEMENTS // held)
    vals, idx = [], []
    for s in range(0, uq.shape[0], step):
        a = alpha[s:s + step]
        if method == "approx":
            v, i = approx_topk_int8(uq[s:s + step], qitems.q, a.reshape(-1), k, recall_target)
        elif d <= _EXACT_ORDER_DIM:   # the accumulator orders as the scores do
            acc = int8_accumulate(uq[s:s + step], qitems)
            acc[:, 0] = _INT32_MIN
            top, i = stable_topk(acc, k)
            v = top.float() * a
        else:
            scores = int8_accumulate(uq[s:s + step], qitems).float() * a
            scores[:, 0] = -torch.inf
            v, i = stable_topk(scores, k)
        vals.append(torch.where(i == 0, -torch.inf, v))
        idx.append(i)
    if not vals:
        return (torch.zeros((0, k), device=u.device), torch.zeros((0, k), dtype=torch.int64,
                                                                   device=u.device))
    return torch.cat(vals), torch.cat(idx)


def int8_topk_plain(user_vecs, qitems: QuantizedItems, k: int):
    """The same top-k written out plainly, as a reference: the int64 product
    of the quantized operands, then a stable descending sort of the float
    scores (equal scores lowest index first)."""
    u = torch.as_tensor(user_vecs, dtype=torch.float32, device=qitems.q.device)
    uq, alpha = _quantize_queries(u, qitems.col_scale)
    acc = (uq.double() @ qitems.q.double().T).to(torch.int64)
    scores = acc.float() * alpha
    scores[:, 0] = -torch.inf
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k], acc


def quantization_recall(item_matrix, user_vecs, k: int = 100, normalize: bool = True,
                        device: torch.device | str = "cuda") -> float:
    """Fraction of the fp32-exact top-k recovered by the int8 path, the
    offline quality gate to run before flipping a serving fleet to int8."""
    from recsys_tpu_torch.eval.recall import topk_scores

    device = resolve_device(device)
    items = torch.as_tensor(item_matrix, dtype=torch.float32, device=device)
    users = torch.as_tensor(user_vecs, dtype=torch.float32, device=device)
    _, exact = topk_scores(users, items, k, normalize_items=normalize)
    _, qidx = int8_topk(users, quantize_items_int8(items, normalize, device), k)
    exact, qidx = exact.cpu().numpy(), qidx.cpu().numpy()
    hits = sum(len(set(exact[r].tolist()) & set(qidx[r].tolist()))
               for r in range(exact.shape[0]))
    return hits / max(exact.size, 1)

