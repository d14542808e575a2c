"""GNN standalone retrieval eval + distillation fidelity.

Counterpart of ``recsys_tpu/eval/gnn_eval.py``. The LightGCL artifacts are
evaluated with RAW DOT-PRODUCT scores over the GNN embedding space — not
cosine, because the embedding magnitudes carry popularity mass — and the
distillation folds that magnitude into angles so that cosine-only ANN
engines preserve the ranking. Four retrieval rows against the validation
targets plus direct teacher-student ranking fidelity:

  gnn_dot          — teacher users x teacher items, dot (the protocol row)
  gnn_cos          — same vectors, cosine (how much magnitude matters)
  distill_cos      — student users x student items, cosine (the pairing
                     the distill trains — what an ANN engine would serve)
  distill_cos_raw_users — teacher users x student items (kept as the
                     regression row)

  fidelity@k       — mean |teacher-dot top-k ∩ X top-k| / k on a user
                     sample, for X in {distill_cos, distill_cos_raw_users}
"""

from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.device import resolve_device
from recsys_tpu_torch.eval.recall import recall_at_ks, topk_scores


def _pad_matrix(items: np.ndarray, multiple: int = 1) -> np.ndarray:
    """GNN artifacts are dense 0-based (no PAD row, export meta records
    it); topk_scores masks row 0 — prepend a zero PAD row and shift. Zero
    rows at the end bring the row count to a multiple (for row sharding)."""
    tail = -(len(items) + 1) % multiple
    return np.concatenate([np.zeros((1, items.shape[1]), np.float32),
                           np.asarray(items, np.float32),
                           np.zeros((tail, items.shape[1]), np.float32)])


def topk_rows(users: np.ndarray, items: np.ndarray, k: int,
              normalize: bool, batch: int = 4096,
              device: torch.device | str = "cuda", mesh=None) -> np.ndarray:
    """(U, k) top-k item indices in PADDED indexing (real item i -> i+1).
    Chunked scoring on ``device``, or row-sharded over ``mesh``'s model axis
    (rows added to make the catalog divide are kept out by a -inf prior)."""
    device = resolve_device(device)
    k = min(k, len(items))  # tiny catalogs: top_k caps at N real items
    shards = 1 if mesh is None else mesh.shape[mesh.axis_names[1]]
    im = torch.as_tensor(_pad_matrix(items, shards), device=device)
    prior = None
    if len(im) > len(items) + 1:
        prior = torch.zeros(len(im), device=device)
        prior[len(items) + 1:] = -torch.inf
    u = np.asarray(users, np.float32)
    if normalize:
        u = u / np.clip(np.linalg.norm(u, axis=-1, keepdims=True), 1e-12, None)
    out = [topk_scores(torch.as_tensor(u[s:s + batch], device=device), im, k, mesh=mesh,
                       normalize_items=normalize, prior=prior)[1].cpu().numpy()
           for s in range(0, len(u), batch)]
    if not out:
        return np.zeros((0, k), np.int64)
    return np.concatenate(out).astype(np.int64)


def standalone_rows(gnn_users: np.ndarray, user_ids: list[str],
                    gnn_items: np.ndarray, item_ids: list[str],
                    targets: dict, ks=(20, 100, 500),
                    distilled_items: np.ndarray | None = None,
                    distilled_users: np.ndarray | None = None,
                    device: torch.device | str = "cuda", mesh=None) -> dict:
    """Recall rows against ``targets`` ({user_id: [item_id, ...]}), all in
    the GNN artifact's own id space (reference protocol — no stage-2 map
    involved)."""
    item_row = {str(i): r + 1 for r, i in enumerate(item_ids)}  # padded idx
    targets_idx = {}
    for u, its in targets.items():
        s = {item_row[i] for i in map(str, its) if i in item_row}
        if s:
            targets_idx[u] = s
    rows = [r for r, u in enumerate(user_ids) if u in targets_idx]
    uids = [user_ids[r] for r in rows]
    tu = np.asarray(gnn_users, np.float32)[rows]
    max_k = max(ks)
    out = {"n_eval_users": len(rows)}
    out["gnn_dot"] = recall_at_ks(
        topk_rows(tu, gnn_items, max_k, normalize=False, device=device, mesh=mesh),
        uids, targets_idx, ks)
    out["gnn_cos"] = recall_at_ks(
        topk_rows(tu, gnn_items, max_k, normalize=True, device=device, mesh=mesh),
        uids, targets_idx, ks)
    if distilled_items is not None:
        # the raw-user x distilled-item pairing only type-checks when the
        # student keeps the teacher's width (distill.out_dim == gnn.emb_dim)
        if distilled_items.shape[1] == gnn_users.shape[1]:
            out["distill_cos_raw_users"] = recall_at_ks(
                topk_rows(tu, distilled_items, max_k, normalize=True, device=device, mesh=mesh),
                uids, targets_idx, ks)
        if distilled_users is not None:
            su = np.asarray(distilled_users, np.float32)[rows]
            out["distill_cos"] = recall_at_ks(
                topk_rows(su, distilled_items, max_k, normalize=True, device=device, mesh=mesh),
                uids, targets_idx, ks)
    return out


def distill_fidelity(gnn_users: np.ndarray, gnn_items: np.ndarray,
                     distilled_items: np.ndarray,
                     distilled_users: np.ndarray | None = None,
                     k: int = 100, sample: int = 4096, seed: int = 0,
                     device: torch.device | str = "cuda") -> dict:
    """Teacher-student ranking fidelity: the fraction of the teacher's
    dot-product top-k reproduced by the student's cosine top-k, averaged
    over a user sample (the distill's entire purpose — reference
    `distill_mag_to_cos_l2.py:6-108`)."""
    rng = np.random.default_rng(seed)
    n = len(gnn_users)
    k = min(k, len(gnn_items))
    rows = (rng.choice(n, sample, replace=False) if sample < n
            else np.arange(n))
    tu = np.asarray(gnn_users, np.float32)[rows]
    teacher = topk_rows(tu, gnn_items, k, normalize=False, device=device)
    out = {"k": k, "sample": int(len(rows))}

    def overlap(student_idx):
        hits = [len(set(t.tolist()) & set(s.tolist())) / k
                for t, s in zip(teacher, student_idx)]
        return float(np.mean(hits))

    if distilled_items.shape[1] == gnn_users.shape[1]:
        out["fidelity_raw_users"] = overlap(
            topk_rows(tu, distilled_items, k, normalize=True, device=device))
    if distilled_users is not None:
        su = np.asarray(distilled_users, np.float32)[rows]
        out["fidelity"] = overlap(
            topk_rows(su, distilled_items, k, normalize=True, device=device))
    return out
