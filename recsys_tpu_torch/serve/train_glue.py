"""Store-backed training triggers for the serving endpoints.

Counterpart of ``recsys_tpu/serve/train_glue.py``. The reference's live
``/train/item-tower`` endpoint trains SimCSE directly from DB rows
(`train_simcse_from_db`, `item_tower.py:887-1127`) and the designed
``/train/user-tower`` endpoint trains the user tower from DB sessions (dead
`serving_controller.py:496-618`). These builders wire the same flows over
the sqlite store: store rows -> item tensors / session sequences -> the
port's trainers on the serving process's device, returning JSON-able
summaries. Each answer holds the JAX answer's keys; the port adds the
steps taken and the losses.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import pandas as pd
import torch

from recsys_tpu_torch.config import Config
from recsys_tpu_torch.serve.store import ActionType, ServeStore, TrainingItem


def _items_frame(items: list[TrainingItem]) -> pd.DataFrame:
    """DB rows -> the item-master frame tokenize_items expects (the
    `parse_db_row` transform: RE flattening + scalar field lift)."""
    rows = []
    for it in items:
        fd = dict(it.feature_data)
        row = {"item_id": it.product_id, "product_name": it.product_name,
               "reinforced_feature": fd.pop("reinforced_feature",
                                            fd.pop("reinforced_feature_value", {}))}
        row.update({k: v for k, v in fd.items()
                    if np.isscalar(v) or v is None})
        rows.append(row)
    frame = pd.DataFrame(rows)
    # columns the downstream ETL expects, defaulted when the payload lacks them
    if "price" not in frame:
        frame["price"] = 10.0
    if "release_day" not in frame:
        frame["release_day"] = 0
    return frame


def make_item_trainer(cfg: Config, store: ServeStore, device: torch.device | str,
                      workdir: str):
    """-> callable(epochs=None, lr=None, init_ckpt=None) training SimCSE on
    every product currently in the store, on ``device``. As in the JAX
    route, no ``pretrain-text`` artifact is loaded: with
    ``item_tower.text_encoder=pretrained`` the frozen table keeps its random
    init (or ``init_ckpt``'s table)."""
    from recsys_tpu_torch.data.dataset import tokenize_items
    from recsys_tpu_torch.data.vocab import StdVocab
    from recsys_tpu_torch.train.simcse import train_simcse

    def train(epochs: int | None = None, lr: float | None = None,
              init_ckpt: str | None = None, **_ignored) -> dict:
        items = store.all_products()
        if len(items) < 4:
            return {"error": f"not enough products to train ({len(items)})"}
        frame = _items_frame(items)
        tensors = tokenize_items(frame, StdVocab(), cfg.vocab)
        sim = cfg.simcse
        if epochs:
            sim = replace(sim, epochs=int(epochs))
        if lr:
            sim = replace(sim, lr=float(lr))
        bs = min(sim.batch_size, max(len(items) // 2, 2))
        sim = replace(sim, batch_size=bs)
        run_cfg = replace(cfg, simcse=sim)
        state = train_simcse(run_cfg, tensors, workdir, device=device, init_ckpt=init_ckpt)
        return {"trained": "item-tower", "items": len(items),
                "steps": int(state.step), "ckpt_dir": workdir,
                "losses": [float(x) for x in state.losses]}

    return train


def sessions_to_transactions(store: ServeStore) -> pd.DataFrame:
    """Purchase sessions -> the transaction frame the stage-2 ETL expects."""
    recs = []
    for s in store.purchase_sessions():
        day = int(s["started_at"] // 86400) % 10_000
        for e in s["events"]:
            if e["action_type"] == ActionType.PURCHASE:
                recs.append({"user_id": s["user_id"], "item_id": e["product_id"],
                             "day": day, "price": 1.0, "channel": 1})
    return pd.DataFrame(recs)


def make_user_trainer(cfg: Config, store: ServeStore, device: torch.device | str,
                      workdir: str):
    """-> callable(epochs=None) training the SASRec tower from the store's
    purchase sessions + stored item vectors, on ``device``."""
    from recsys_tpu_torch.train.sasrec import prepare_stage2, train_user_tower

    def train(epochs: int | None = None, **_ignored) -> dict:
        tx = sessions_to_transactions(store)
        if len(tx) < 8 or tx["user_id"].nunique() < 2:
            return {"error": f"not enough purchase sessions ({len(tx)} events)"}
        items = _items_frame(store.all_products())
        users = pd.DataFrame({"user_id": sorted(tx["user_id"].unique())})
        for col, default in (("age_group", "25-34"), ("gender", "female"),
                             ("style", "classic"), ("club_member_status", "active"),
                             ("fashion_news_frequency", "none"),
                             ("fn", 0), ("active", 1)):
            users[col] = default
        # spread days so a time split exists even for bursty test data
        if tx["day"].nunique() < 3:
            tx = tx.copy()
            tx["day"] = np.arange(len(tx)) % 14
        ut = cfg.user_train
        if epochs:
            ut = replace(ut, epochs=int(epochs))
        ut = replace(ut, batch_size=min(ut.batch_size, max(len(users), 8)))
        run_cfg = replace(cfg, user_train=ut,
                          data=replace(cfg.data, valid_days=max(
                              int(tx["day"].max() // 4), 1)))
        data = prepare_stage2(run_cfg, items, users, tx)
        if data["tensors"]["input_ids"].shape[0] == 0:
            return {"error": "no users with >=2 purchases"}
        ids, vecs = store.all_vectors()
        pretrained = None
        if len(ids) and vecs.shape[1] != cfg.user_tower.d_model:
            ids = []  # stored vectors are from a different-dim encoder; skip
        if len(ids):
            from recsys_tpu_torch.train.checkpoint import align_rows
            aligned, _ = align_rows(vecs, ids, data["item_map"].ids, fill="random")
            pretrained = np.concatenate(
                [np.zeros((1, vecs.shape[1]), np.float32), aligned.astype(np.float32)])
        state, history, _ = train_user_tower(run_cfg, data, pretrained, workdir, device=device)
        return {"trained": "user-tower", "epochs": len(history),
                "final": history[-1] if history else {},
                "steps": len(state.step_seconds), "losses": list(state.losses)}

    return train
