"""The store-backed training triggers (``serve/train_glue.py``) against the
JAX package's, on the CPU: the store rows -> frames transforms equal the JAX
frames, the guards answer with the JAX messages, and the ``/train/item-tower``
and ``/train/user-tower`` routes of the port's server train on a tiny store
(the verify recipe's widths, one epoch) and answer with the JAX answer's
keys, finite losses and the steps taken.

Frames are compared exactly (the same host code on the same rows).
"""

import json
import urllib.request

import numpy as np
import pandas as pd
import pytest
import torch

from recsys_tpu.config import load_config as jax_load_config
from recsys_tpu.serve import store as JS
from recsys_tpu.serve import train_glue as JG
from recsys_tpu_torch.config import load_config
from recsys_tpu_torch.serve import store as TS
from recsys_tpu_torch.serve import train_glue as TG
from recsys_tpu_torch.serve.app import build_app_context
from recsys_tpu_torch.serve.server import make_server, serve_forever_in_thread

# the verify recipe's widths, one epoch, a few steps
OVERRIDES = {"vocab": {"max_field_tokens": 8, "max_name_tokens": 8},
             "item_tower": {"head_hidden": [128], "fusion_layers": 1, "text_layers": 1},
             "simcse": {"batch_size": 16, "epochs": 1, "steps_per_epoch_min": 1},
             "user_tower": {"max_len": 10, "num_layers": 1},
             "user_train": {"batch_size": 16, "epochs": 1, "steps_per_epoch_min": 4,
                            "eval_ks": [5, 20]},
             "serve": {"db_path": ":memory:", "batch_window_ms": 0.0}}
# the keys of the JAX triggers' answers (recsys_tpu/serve/train_glue.py)
JAX_ITEM_KEYS = {"trained", "items", "steps", "ckpt_dir"}
JAX_USER_KEYS = {"trained", "epochs", "final"}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers on few cores: torch's default of one
    thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


_WORDS = ("red blue green black white wool cotton linen silk denim shirt dress coat "
          "skirt scarf boot sneaker jacket knit striped floral plain slim loose").split()


def _products(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        fd = {"reinforced_feature": {"CAT": [str(rng.choice(_WORDS[10:18]))],
                                     "COL": [str(rng.choice(_WORDS[:5]))]},
              "product_type_name": str(rng.choice(_WORDS[10:18])),
              "colour_group_name": str(rng.choice(_WORDS[:5])),
              "material": str(rng.choice(_WORDS[5:10]))}
        if i % 3 == 0:
            fd["price"] = float(rng.uniform(5, 50))
        if i % 4 == 1:   # the older payload key
            fd["reinforced_feature_value"] = fd.pop("reinforced_feature")
        out.append({"product_id": f"p{i}",
                    "product_name": " ".join(rng.choice(_WORDS, 3, replace=False)),
                    "feature_data": fd})
    return out


def _sessions(users, n_products, seed=1, purchases=6):
    """One session a purchase, days apart, plus a click-only session."""
    rng = np.random.default_rng(seed)
    sessions = []
    for u in range(users):
        for j in range(purchases):
            day = int(rng.integers(0, 60))
            sessions.append({"user_id": f"u{u}", "started_at": 86400.0 * day + j,
                             "events": [{"product_id": f"p{rng.integers(0, n_products)}",
                                         "action_type": 5, "ts": 86400.0 * day + j},
                                        {"product_id": f"p{rng.integers(0, n_products)}",
                                         "action_type": 1, "ts": 86400.0 * day + j + 1}]})
        sessions.append({"user_id": f"u{u}", "started_at": 100.0,
                         "events": [{"product_id": "p0", "action_type": 1, "ts": 100.0}]})
    return sessions


def _fill(store, products, users=0, vectors=True):
    store.ingest_products(products)
    if vectors:   # insert-manual-data wants every product to have a vector
        rng = np.random.default_rng(2)
        ids = [p["product_id"] for p in products]
        store.save_vectors(ids, rng.normal(size=(len(ids), 128)).astype(np.float32))
    if users:
        out = store.insert_manual_data([{"user_id": f"u{u}"} for u in range(users)],
                                       _sessions(users, len(products)))
        assert out["ok"], out
    return store


def test_items_frame_equals_the_jax_frame():
    products = _products(30)
    jf = JG._items_frame(_fill(JS.ServeStore(":memory:"), products).all_products())
    tf = TG._items_frame(_fill(TS.ServeStore(":memory:"), products).all_products())
    pd.testing.assert_frame_equal(tf, jf)
    assert {"price", "release_day", "reinforced_feature"} <= set(tf.columns)


def test_sessions_to_transactions_equals_the_jax_frame():
    products = _products(30)
    jt = JG.sessions_to_transactions(_fill(JS.ServeStore(":memory:"), products, users=8))
    tt = TG.sessions_to_transactions(_fill(TS.ServeStore(":memory:"), products, users=8))
    pd.testing.assert_frame_equal(tt, jt)
    assert len(tt) == 8 * 6 and set(tt.columns) == {"user_id", "item_id", "day", "price",
                                                     "channel"}


@pytest.mark.parametrize("case", ["few_products", "no_sessions", "one_user",
                                  "one_purchase_each"])
def test_guards_answer_as_the_jax_triggers(tmp_path, case):
    n_products = 3 if case == "few_products" else 30
    products = _products(n_products)
    stores = [_fill(S.ServeStore(":memory:"), products) for S in (JS, TS)]
    for store in stores:
        if case == "one_user":     # eight purchases, one user
            store.insert_manual_data([{"user_id": "u0"}], [
                {"user_id": "u0", "started_at": 86400.0 * d,
                 "events": [{"product_id": f"p{d}", "action_type": 5}]} for d in range(8)])
        if case == "one_purchase_each":
            store.insert_manual_data([{"user_id": f"u{u}"} for u in range(10)], [
                {"user_id": f"u{u}", "started_at": 86400.0 * u,
                 "events": [{"product_id": f"p{u}", "action_type": 5}]} for u in range(10)])
    jcfg, tcfg = jax_load_config(overrides=OVERRIDES), load_config(overrides=OVERRIDES)
    if case == "few_products":
        want = JG.make_item_trainer(jcfg, stores[0], None, str(tmp_path / "j"))()
        got = TG.make_item_trainer(tcfg, stores[1], "cpu", str(tmp_path / "t"))()
    else:
        want = JG.make_user_trainer(jcfg, stores[0], None, str(tmp_path / "j"))()
        got = TG.make_user_trainer(tcfg, stores[1], "cpu", str(tmp_path / "t"))()
    assert "error" in want and got == want


def _post(base, path, payload):
    req = urllib.request.Request(base + path, method="POST", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def test_train_routes_through_the_server(tmp_path):
    cfg = load_config(overrides=OVERRIDES)
    ctx = build_app_context(cfg)
    _fill(ctx.store, _products(40), users=20)
    ctx.train_item_fn = TG.make_item_trainer(cfg, ctx.store, "cpu", str(tmp_path / "item"))
    ctx.train_user_fn = TG.make_user_trainer(cfg, ctx.store, "cpu", str(tmp_path / "user"))
    server = make_server(ctx, host="127.0.0.1", port=0)
    serve_forever_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        item = _post(base, "/ai-api/serving/train/item-tower", {"epochs": 1})
        user = _post(base, "/ai-api/serving/train/user-tower", {"epochs": 1})
    finally:
        server.shutdown()
        server.server_close()
    assert JAX_ITEM_KEYS <= set(item) and item["trained"] == "item-tower"
    assert item["items"] == 40 and item["steps"] == len(item["losses"]) > 0
    assert np.isfinite(item["losses"]).all()
    assert (tmp_path / "item" / "manifest.json").exists()
    assert JAX_USER_KEYS <= set(user) and user["trained"] == "user-tower"
    assert user["epochs"] == 1 and user["steps"] > 0 and np.isfinite(user["losses"]).all()
    assert {"recall@5", "recall@20", "n_eval"} <= set(user["final"])


def test_serve_stage_attaches_the_trainers(tmp_path):
    from recsys_tpu_torch.pipeline import cli

    args = cli.parse_args(["serve", "--set", f"data.root={tmp_path}",
                           "--set", "serve.db_path=:memory:", "--device", "cpu"])
    ctx = cli.build_app(cli.config_from_args(args), args)
    assert callable(ctx.train_item_fn) and callable(ctx.train_user_fn)
    assert ctx.train_item_fn() == {"error": "not enough products to train (0)"}
    assert ctx.train_user_fn() == {"error": "not enough purchase sessions (0 events)"}
