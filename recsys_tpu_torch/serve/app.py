"""Serving application context: the vectorization flows over the store and
the ANN index.

Counterpart of ``recsys_tpu/serve/app.py``. The store
(``serve/store.py``), the native indexes (``serve/ann.py``) and the dynamic
batcher (``serve/batcher.py``) are the port's copies of the JAX package's
framework-free modules. ``model_vectorizer`` runs the torch item encoder
under ``torch.inference_mode`` on the configured device.

``tower_user_vectorizer`` and ``hybrid_user_vectorizer`` are the
model-backed user vectorizers: store histories -> left-padded id sequences ->
the trained stage-2 or hybrid tower's eval forward on the device (the hybrid
one with the user's GNN embedding, zeros for a user the GNN never saw).

``recommend_for_user`` answers in ``cosine``, ``blend`` or ``rerank`` mode;
the last two run the recipes of ``serve/recommend.py`` over ``rec_assets``
and, when those (or the rerank ranker) are not loaded, answer in cosine mode,
flagged in the response, as the JAX server does.

``serve.ann_backend`` picks the item index: ``exact`` and ``hnsw`` are the
native host indexes, ``ivf`` and ``int8`` the device-resident ones
(``serve/ann.IvfDeviceIndex``, ``Int8DeviceIndex``) on the context's device.
"""

from __future__ import annotations

import hashlib
import os
import threading
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from recsys_tpu_torch.config import Config
from recsys_tpu_torch.serve.ann import (HnswIndex, Int8DeviceIndex, IvfDeviceIndex,
                                        VectorIndex)
from recsys_tpu_torch.serve.store import ServeStore, TrainingItem
from recsys_tpu_torch.train.checkpoint import save_array_with_ids


def pid_to_int(pid: str) -> int:
    """Stable 63-bit id for the native index (store keys are strings)."""
    return int(hashlib.md5(pid.encode()).hexdigest()[:15], 16)


def hash_vectorizer(dim: int = 128) -> Callable[[list[TrainingItem]], np.ndarray]:
    """Deterministic non-learned embedding: feature tokens hashed into a
    bag-of-features vector, L2-normalized (test and cold-start backend)."""

    def fn(items: list[TrainingItem]) -> np.ndarray:
        out = np.zeros((len(items), dim), np.float32)
        for r, it in enumerate(items):
            tokens = [it.product_name or ""]

            def walk(v, prefix=""):
                if isinstance(v, dict):
                    for k, vv in sorted(v.items()):
                        walk(vv, f"{prefix}{k}.")
                elif isinstance(v, (list, tuple)):
                    for vv in v:
                        walk(vv, prefix)
                elif v is not None:
                    tokens.append(f"{prefix}{v}")

            walk(it.feature_data)
            for t in tokens:
                h = int(hashlib.md5(t.encode()).hexdigest()[:8], 16)
                out[r, h % dim] += 1.0 if (h >> 16) % 2 else -1.0
            n = np.linalg.norm(out[r])
            if n > 0:
                out[r] /= n
        return out

    return fn


def items_to_frame(items: list[TrainingItem]):
    """Store records -> the item-master frame ``tokenize_items`` takes."""
    import pandas as pd

    rows = []
    for it in items:
        row = {"item_id": it.product_id, "product_name": it.product_name}
        fd = dict(it.feature_data)
        row["reinforced_feature"] = fd.pop("reinforced_feature",
                                           fd.pop("reinforced_feature_value", {}))
        row.update({k: v for k, v in fd.items() if np.isscalar(v) or v is None})
        rows.append(row)
    return pd.DataFrame(rows)


def model_vectorizer(cfg: Config, model, device: torch.device | str
                     ) -> Callable[[list[TrainingItem]], np.ndarray]:
    """The encoder-backed vectorizer: store rows -> item tensors -> the
    torch item encoder on ``device``. PyTorch runs eagerly, so ragged
    request sizes need no shape buckets."""
    from recsys_tpu_torch.data.dataset import tokenize_items
    from recsys_tpu_torch.data.vocab import StdVocab
    from recsys_tpu_torch.train.simcse import MODEL_INPUTS

    vocab = StdVocab()
    model = model.to(device).eval()

    def fn(items: list[TrainingItem]) -> np.ndarray:
        tensors = tokenize_items(items_to_frame(items), vocab, cfg.vocab)
        with torch.inference_mode():
            out = model.encode(*(torch.as_tensor(tensors[k], device=device)
                                 for k in MODEL_INPUTS)).cpu().numpy()
        # tokenize_items sorts by id; restore the caller's order
        order = {pid: i for i, pid in enumerate(tensors["item_ids"])}
        return out[[order[it.product_id] for it in items]]

    return fn


def history_user_vectorizer(ctx: "AppContext", half_life_s: float = 7 * 86400.0):
    """Default user-vector backend: action-weighted, recency-decayed mean of
    the user's interacted item vectors, L2-normalized. Decay is relative to
    the user's latest event."""

    def fn(profiles: list[dict]) -> np.ndarray:
        dim = ctx.cfg.item_tower.dim
        ids = [p["user_id"] for p in profiles]
        hists = ctx.store.user_histories(ids)
        out = np.zeros((len(profiles), dim), np.float32)
        for r, uid in enumerate(ids):
            acc = np.zeros(dim, np.float32)
            events = hists.get(uid, [])
            t_last = max((e["ts"] for e in events), default=0.0)
            for e in events:
                ivec = ctx.store.get_vector(str(e["product_id"]))
                if ivec is None or ivec.shape[0] != dim:
                    continue
                w = float(e["action_type"]) * 0.5 ** ((t_last - e["ts"]) / half_life_s)
                acc += w * ivec
            n = np.linalg.norm(acc)
            out[r] = acc / n if n > 0 else acc
        return out

    return fn


def tower_user_vectorizer(ctx: "AppContext", cfg: Config, user_vectors,
                          item_ids: list[str], device: torch.device | str):
    """Model-backed user vectorizer: store histories -> left-padded id
    sequences (newest event last, time buckets by days before it) -> the
    stage-2 tower's eval forward, ``user_vectors`` of
    ``train/sasrec.restore_stage2``. ``item_ids`` is the stage-2 id map's row
    order (index 0 = PAD). Static user features are not known at serve time
    and enter as zeros (the static gates make that a graceful degradation)."""

    from recsys_tpu_torch.train.sasrec import tensors_to

    id_of = {str(p): i for i, p in enumerate(item_ids)}

    def fn(profiles: list[dict]) -> np.ndarray:
        batch = history_batch(ctx, cfg, [p["user_id"] for p in profiles], id_of)
        return user_vectors(tensors_to(batch, device)).float().cpu().numpy()

    return fn


def history_batch(ctx: "AppContext", cfg: Config, user_ids: list, id_of: dict) -> dict:
    """The users' store histories as a stage-2 batch (numpy): left-padded
    ids, newest event last, time buckets by days before it, static features
    zero (not known at serve time)."""
    from recsys_tpu_torch.data.dataset import TIME_BUCKET_EDGES

    utc = cfg.user_tower
    L = utc.max_len
    hists = ctx.store.user_histories(user_ids)
    B = len(user_ids)
    batch = {key: np.zeros((B, L), np.int64)
             for key in ("input_ids", "target_ids", "time_buckets", "seq_mask")}
    batch["user_buckets"] = np.zeros((B, utc.static_bucket_fields), np.int64)
    batch["user_cats"] = np.zeros((B, utc.static_cat_fields), np.int64)
    batch["user_cont"] = np.zeros((B, utc.static_cont_fields), np.float32)
    for r, uid in enumerate(user_ids):
        events = [e for e in hists.get(uid, []) if str(e["product_id"]) in id_of][-L:]
        if not events:
            continue
        k = len(events)
        batch["input_ids"][r, L - k:] = [id_of[str(e["product_id"])] for e in events]
        days = np.array([(events[-1]["ts"] - e["ts"]) / 86400.0 for e in events])
        batch["time_buckets"][r, L - k:] = np.digitize(days, TIME_BUCKET_EDGES[1:])
        batch["seq_mask"][r, L - k:] = 1
    return batch


def hybrid_user_vectorizer(ctx: "AppContext", cfg: Config, user_vectors, item_ids: list[str],
                           gnn_user_of: dict[str, np.ndarray] | None,
                           gnn_dim: int, device: torch.device | str):
    """Hybrid-tower user vectorizer: store histories -> the batch of
    ``history_batch`` + the user's GNN embedding (artifact lookup; zeros for
    an unseen user, which the tower's gates take gracefully) -> the eval
    forward ``user_vectors(batch, gnn_user)`` of
    ``train/hybrid.restore_hybrid``. ``item_ids`` is the stage-2 id map's row
    order (index 0 = PAD)."""
    from recsys_tpu_torch.train.sasrec import tensors_to

    id_of = {str(p): i for i, p in enumerate(item_ids)}
    gnn_user_of = gnn_user_of or {}

    def fn(profiles: list[dict]) -> np.ndarray:
        ids = [p["user_id"] for p in profiles]
        gnn_u = np.zeros((len(ids), gnn_dim), np.float32)
        for r, uid in enumerate(ids):
            gv = gnn_user_of.get(str(uid))
            if gv is not None:
                gnn_u[r] = gv
        batch = history_batch(ctx, cfg, ids, id_of)
        return user_vectors(tensors_to(batch, device),
                            torch.as_tensor(gnn_u, device=device)).float().cpu().numpy()

    return fn


@dataclass
class AppContext:
    cfg: Config
    store: ServeStore
    index: VectorIndex
    vectorize_fn: Callable[[list[TrainingItem]], np.ndarray]
    user_vectorize_fn: Callable[[list[dict]], np.ndarray] | None = None
    train_item_fn: Callable[..., dict] | None = None
    train_user_fn: Callable[..., dict] | None = None
    rec_assets: object | None = None    # serve/recommend.RecommendAssets
    user_backend: str = "history mean"   # what ``_user_vectorize`` runs
    int_to_pid: dict[int, str] = field(default_factory=dict)
    _bg_threads: list = field(default_factory=list)

    @property
    def batch_size(self) -> int:
        return self.cfg.serve.batch_size

    def _index_add(self, ids: list[str], vecs: np.ndarray) -> None:
        ints = [pid_to_int(p) for p in ids]
        self.int_to_pid.update(dict(zip(ints, ids)))
        self.index.add(ints, vecs)

    # -- flows ------------------------------------------------------------
    def _vectorize_and_save(self, items: list[TrainingItem], table: str) -> list[str]:
        vecs = self.vectorize_fn(items)
        ids = [it.product_id for it in items]
        self.store.save_vectors(ids, vecs, table)
        self._index_add(ids, vecs)
        return ids

    def process_pending(self, batch_size: int | None = None,
                        table: str = "inference") -> dict:
        items = self.store.pending_products(batch_size or self.batch_size, table)
        if not items:
            return {"processed_count": 0, "remaining": 0}
        ids = self._vectorize_and_save(items, table)
        return {"processed_count": len(ids),
                "remaining": self.store.pending_count(table)}

    def process_by_ids(self, product_ids: list[str], table: str = "inference") -> dict:
        items = self.store.products_by_ids(product_ids, table)
        if not items:
            return {"processed_count": 0, "missing": product_ids}
        found = set(self._vectorize_and_save(items, table))
        return {"processed_count": len(found),
                "missing": [p for p in product_ids if p not in found]}

    def refresh_item_vectors(self, artifact_path: str | None = None,
                             table: str = "inference") -> dict:
        items = self.store.all_products(table)
        if not items:
            return {"count": 0}
        all_ids, chunks = [], []
        bs = self.batch_size * self.cfg.serve.fast_mode_multiplier
        for s in range(0, len(items), bs):
            chunk = items[s:s + bs]
            chunks.append(self.vectorize_fn(chunk))
            all_ids.extend(it.product_id for it in chunk)
        vecs = np.concatenate(chunks)
        self.store.save_vectors(all_ids, vecs, table)
        self._index_add(all_ids, vecs)
        if artifact_path:
            os.makedirs(os.path.dirname(artifact_path) or ".", exist_ok=True)
            full = np.concatenate([np.zeros((1, vecs.shape[1]), np.float32), vecs])
            save_array_with_ids(artifact_path, full, all_ids,
                                meta={"source": "refresh_item_vectors"})
        return {"count": len(all_ids)}

    # -- user-vector flows ------------------------------------------------
    def _user_vectorize(self, profiles: list[dict]) -> np.ndarray:
        fn = self.user_vectorize_fn or history_user_vectorizer(self)
        return fn(profiles)

    def process_pending_users(self, batch_size: int | None = None) -> dict:
        profiles = self.store.pending_users(batch_size or self.batch_size)
        if not profiles:
            return {"processed_count": 0, "remaining": 0}
        vecs = self._user_vectorize(profiles)
        ids = [p["user_id"] for p in profiles]
        self.store.save_user_vectors(ids, vecs)
        return {"processed_count": len(ids),
                "remaining": self.store.user_pending_count()}

    def refresh_user_vectors(self) -> dict:
        profiles = self.store.all_user_profiles()
        if not profiles:
            return {"count": 0}
        vecs = self._user_vectorize(profiles)
        self.store.save_user_vectors([p["user_id"] for p in profiles], vecs)
        return {"count": len(profiles)}

    def recommend_for_user(self, user_id: str, top_k: int | None = None,
                           exclude_seen: bool = True, season: str | None = None,
                           mode: str | None = None) -> dict:
        """Top-k recommendations for a user in ``mode`` (``serve.mode`` when
        not given):

        * ``cosine`` - ANN top-k over the index, seen items excluded when
          ``exclude_seen``, optionally season-aware (``season="auto"`` reads
          the user's latest session season);
        * ``blend`` / ``rerank`` - the recipes of ``serve/recommend.py``,
          which keep seen items (the seen-item signal is where their lift
          comes from). Without ``rec_assets`` (or, for rerank, its ranker)
          they answer in cosine mode, flagged in the response."""
        mode = mode or self.cfg.serve.mode
        if mode in ("blend", "rerank"):
            out = self._recommend_recipe(user_id, mode, top_k)
            if out is not None:
                return out
            fallback = {"requested_mode": mode, "mode": "cosine",
                        "fallback": "no serving assets loaded"}
        else:
            fallback = {}
        vec = self.store.get_user_vector(user_id)
        if vec is None:
            return {"error": f"no vector for user {user_id}", "results": []}
        if season == "auto":
            season = self.store.latest_session_season(user_id)
        seen = set()
        if exclude_seen:
            hist = self.store.user_histories([user_id]).get(user_id, [])
            seen = {str(e["product_id"]) for e in hist}
        want = top_k or self.cfg.serve.similarity_top_k
        k = want + len(seen) + (want if season else 0)  # season re-rank margin
        ids, scores = self.index.topk(vec[None], k)
        results = []
        for i, s in zip(ids[0].tolist(), scores[0].tolist()):
            pid = self.int_to_pid.get(i)
            if pid is None or pid in seen:
                continue
            results.append({"product_id": pid, "score": round(float(s), 6)})
        if season:
            item_sea = self.store.item_seasons([r["product_id"] for r in results])
            bonus = self.cfg.serve.season_bonus
            for r in results:
                if item_sea.get(r["product_id"]) == season:
                    r["score"] = round(r["score"] + bonus, 6)
                    r["in_season"] = True
            results.sort(key=lambda r: -r["score"])
        out = {"user_id": user_id, "results": results[:want]}
        if season:
            out["season"] = season
        out.update(fallback)
        return out

    def _recommend_recipe(self, user_id: str, mode: str, top_k: int | None) -> dict | None:
        """Blend / rerank serving through the offline pipeline's own scoring
        functions; None when the assets (or the rerank ranker) are missing."""
        from recsys_tpu_torch.serve import recommend as RC

        assets = self.rec_assets
        if assets is None or (mode == "rerank" and assets.ranker is None):
            return None
        vec = self.store.get_user_vector(user_id)
        if vec is None:
            return {"error": f"no vector for user {user_id}", "results": []}
        sc = self.cfg.serve
        k = top_k or sc.similarity_top_k
        events = self.store.user_histories([user_id]).get(user_id, [])
        iidx, days = RC.store_events_arrays(assets, events)
        if mode == "blend":
            idx = RC.blend_topk(assets, vec[None], [iidx], sc.blend_alpha, sc.blend_beta, k,
                                backend=sc.blend_backend)
        else:
            now_day = int(days.max()) + 1 if len(days) else 0
            idx = RC.rerank_serve_topk(assets, vec[None], [(iidx, days)], now_day, k,
                                       pool_size=sc.rerank_pool, m_cos=sc.rerank_m_cos,
                                       m_pop=sc.rerank_m_pop)
        results = [{"product_id": assets.pid_of(int(r)), "rank": j + 1}
                   for j, r in enumerate(idx[0]) if int(r) != 0]
        return {"user_id": user_id, "mode": mode, "vectors": assets.vectors,
                "results": results}

    def similar_items(self, item_id: str, top_k: int | None = None) -> dict:
        vec = self.store.get_vector(item_id)
        if vec is None:
            return {"error": f"no vector for {item_id}", "results": []}
        k = (top_k or self.cfg.serve.similarity_top_k) + 1
        ids, scores = self.index.topk(vec[None], k)
        results = []
        for i, s in zip(ids[0].tolist(), scores[0].tolist()):
            pid = self.int_to_pid.get(i)
            if pid is None or pid == item_id:
                continue
            results.append({"product_id": pid, "score": round(float(s), 6)})
        return {"query": item_id, "results": results[: k - 1]}

    def start_background(self, fn, *args) -> str:
        t = threading.Thread(target=fn, args=args, daemon=True)
        t.start()
        self._bg_threads.append(t)
        return f"bg-{len(self._bg_threads)}"


def build_app_context(cfg: Config, vectorizer: Callable | None = None,
                      device: torch.device | str | None = None) -> AppContext:
    """Store, item index and vectorizer of ``cfg.serve``. ``device`` places
    a device index (``ivf``, ``int8``; default ``cuda``, which raises without
    a card); the host indexes take none."""
    db = cfg.serve.db_path
    if db != ":memory:":
        os.makedirs(os.path.dirname(db) or ".", exist_ok=True)
    store = ServeStore(db)
    backend = cfg.serve.ann_backend
    if backend == "hnsw":
        index = HnswIndex(cfg.item_tower.dim, m=cfg.serve.hnsw_m,
                          ef_construction=cfg.serve.hnsw_ef_construction,
                          ef_search=cfg.serve.hnsw_ef_search)
    elif backend == "exact":
        index = VectorIndex(cfg.item_tower.dim, cosine=True)
    elif backend == "ivf":
        index = IvfDeviceIndex(cfg.item_tower.dim, nlist=cfg.serve.ivf_nlist or None,
                               nprobe=cfg.serve.ivf_nprobe, device=device or "cuda")
    elif backend == "int8":
        index = Int8DeviceIndex(cfg.item_tower.dim, cosine=True, device=device or "cuda")
    else:
        raise ValueError(f"unknown serve.ann_backend {backend!r}")
    vec_fn = vectorizer or hash_vectorizer(cfg.item_tower.dim)
    if cfg.serve.batch_window_ms > 0:
        from recsys_tpu_torch.serve.batcher import DynamicBatcher

        vec_fn = DynamicBatcher(vec_fn, max_batch=cfg.serve.max_dynamic_batch,
                                max_wait_ms=cfg.serve.batch_window_ms)
    ctx = AppContext(cfg, store, index, vec_fn)
    # warm the index from any vectors already in the store
    ids, vecs = store.all_vectors()
    if len(ids):
        ctx._index_add(ids, vecs)
    return ctx
