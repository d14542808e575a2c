"""The user-tower slice of the port on the CPU: ``train-user`` -> ``eval``
through the port's CLI on the verify recipe's world, ``eval.json`` against
the JAX ``eval`` stage, the baselines and the blend sweep against the JAX
functions, resume, and model-backed serving with the stage-2 tower.

Tolerances: recalls of the training-free baselines and of the blend sweep are
equal to the JAX package's (the same numpy code on the host; the torch path on
the CPU scores continuous values, so no tie sits at a k boundary); the served
user vector is within 2e-2 of the tower's eval forward on the same
left-padded history (the serving bound of tests/test_serve.py).
"""

import json
import shutil

import numpy as np
import pytest
import torch

from recsys_tpu_torch.eval import baselines as TB
from recsys_tpu_torch.pipeline import cli
from recsys_tpu_torch.serve.server import make_server, serve_forever_in_thread
from recsys_tpu_torch.train.checkpoint import CheckpointStore, load_array_with_ids

WORLD = ["--set", "data.num_items=120", "--set", "data.num_users=60", "--set", "data.days=40",
         "--set", "vocab.max_field_tokens=8", "--set", "vocab.max_name_tokens=8",
         "--set", "item_tower.head_hidden=[128]", "--set", "item_tower.fusion_layers=1",
         "--set", "item_tower.text_layers=1"]
USER = ["--set", "user_tower.max_len=10", "--set", "user_tower.num_layers=1",
        "--set", "user_train.batch_size=16", "--set", "user_train.epochs=1",
        "--set", "user_train.eval_ks=[5,20]", "--set", "serve.db_path=:memory:"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers on few cores: torch's default of one
    thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("user_world")
    sets = ["--set", f"data.root={root}", *WORLD, "--device", "cpu"]
    out = {stage: cli.main([stage, *sets, *extra]) for stage, extra in (
        ("gen-data", []), ("etl", []),
        ("train-item", ["--set", "simcse.batch_size=16", "--set", "simcse.epochs=1"]),
        ("vectorize", []), ("train-user", USER), ("eval", USER))}
    return root, sets, out


def test_train_user_then_eval_recall(world):
    root, _, out = world
    tu, ev = out["train-user"], out["eval"]
    assert tu["device"] == "cpu" and tu["epochs"] == 1 and tu["steps"] >= 100
    assert np.isfinite(tu["epoch_losses"]).all() and tu["step_ms_median"] > 0
    assert tu["final"]["n_eval"] > 0 and tu["final"]["recall@20"] > 0
    assert ev["device"] == "cpu" and ev["n_eval"] > 0 and ev["recall@20"] > 0
    # eval scores the best checkpoint: the training run's own numbers
    assert ev["recall@20"] == pytest.approx(tu["best"]["recall@20"], abs=1e-9)
    uvecs, uids, _ = load_array_with_ids(f"{root}/eval_uvecs")
    mat, ids, _ = load_array_with_ids(f"{root}/eval_item_matrix")
    assert uvecs.shape == (ev["n_eval"], 128) and len(uids) == ev["n_eval"]
    assert mat.shape == (121, 128) and ids[0] == "<pad>"
    np.testing.assert_allclose(np.linalg.norm(uvecs, axis=1), 1.0, atol=1e-4)


def test_eval_json_has_the_jax_stages_keys(world, tmp_path):
    """The JAX ``eval`` stage on the same world and stage-1 matrix (with its
    own random-init tower, so only keys and the training-free rows compare)."""
    from recsys_tpu.pipeline import cli as jax_cli

    root, _, out = world
    for f in ("items.parquet", "users.parquet", "transactions.parquet",
              "item_matrix.npy", "item_matrix.ids.json"):
        shutil.copy(f"{root}/{f}", tmp_path)
    jsets = ["--set", f"data.root={tmp_path}", *WORLD, *USER]
    ref = jax_cli.main(["eval", *jsets])
    got = json.load(open(f"{root}/eval.json"))

    def keys(d, pre=""):
        found = set()
        for k, v in d.items():
            found.add(pre + k)
            if isinstance(v, dict):
                found |= keys(v, f"{pre}{k}/")
        return found

    assert keys(got) == keys(ref)
    assert {"baselines", "blend", "significance", "blend_seasonal"} <= set(got)
    assert got["baselines"] == ref["baselines"]
    assert set(out["eval"]) == set(ref) | {"device", "step_ms_median"}


@pytest.fixture(scope="module")
def blend_inputs():
    rng = np.random.default_rng(0)
    n_users, n_items, L = 40, 90, 6
    hist = rng.integers(0, n_items, (n_users, L))
    hist[:5, :3] = 0                                      # left padding
    targets = {f"u{r}": set(rng.integers(1, n_items, 3).tolist()) for r in range(0, n_users, 2)}
    return {"uvecs": rng.normal(size=(n_users, 16)).astype(np.float32),
            "items": rng.normal(size=(n_items, 16)).astype(np.float32),
            "logq": rng.normal(size=n_items).astype(np.float32),
            "hist": hist, "uids": [f"u{r}" for r in range(n_users)], "targets": targets}


@pytest.mark.parametrize("device", [None, "cpu"], ids=["host", "torch"])
def test_blend_sweep_recalls_equal_jax(blend_inputs, device):
    from recsys_tpu.eval import baselines as JB

    x = blend_inputs
    args = (x["uvecs"], x["items"], x["logq"], x["hist"], x["uids"], x["targets"])
    ref = JB.blend_sweep(*args, ks=(5, 20), device=False, per_user_k=5)
    got = TB.blend_sweep(*args, ks=(5, 20), device=device, per_user_k=5)
    assert got["table"] == ref["table"] and got["best"] == ref["best"]
    for k in ("best", "model_only", "uids"):
        np.testing.assert_array_equal(got["_per_user"][k], ref["_per_user"][k])


@pytest.mark.parametrize("device", [None, "cpu"], ids=["host", "torch"])
def test_baseline_report_recalls_equal_jax(blend_inputs, device):
    from recsys_tpu.eval import baselines as JB

    x = blend_inputs
    tensors = {"user_ids": x["uids"], "input_ids": x["hist"][:, :-1],
               "target_ids": x["hist"][:, 1:]}
    ref = JB.baseline_report(tensors, x["logq"], x["targets"], ks=(5, 20),
                             item_matrix=x["items"], per_user_k=20)
    got = TB.baseline_report(tensors, x["logq"], x["targets"], ks=(5, 20),
                             item_matrix=x["items"], per_user_k=20, device=device)
    ref_pu, got_pu = ref.pop("_per_user"), got.pop("_per_user")
    assert got == ref and set(got) == {"popularity", "repurchase", "content_profile",
                                       "content_profile_recency"}
    for k in ref_pu:
        np.testing.assert_array_equal(got_pu[k], ref_pu[k])


def test_stages_ask_for_cuda_by_default(world):
    root, sets, _ = world
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is there: the default takes it")
    no_device = [a for a in sets if a not in ("--device", "cpu")]
    for stage in ("train-user", "eval"):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main([stage, *no_device, *USER])


def test_train_user_resume_continues_after_the_last_epoch(world, tmp_path):
    root, _, out = world
    for f in ("items.parquet", "users.parquet", "transactions.parquet",
              "item_matrix.npy", "item_matrix.ids.json"):
        shutil.copy(f"{root}/{f}", tmp_path)
    shutil.copytree(f"{root}/ckpt_user", tmp_path / "ckpt_user")
    sets = ["--set", f"data.root={tmp_path}", *WORLD, "--device", "cpu",
            *USER, "--set", "user_train.epochs=2"]
    again = cli.main(["train-user", *sets, "--resume"])
    assert again["epochs"] == 1                       # epoch 2 only
    assert again["steps"] == 2 * out["train-user"]["steps"]
    entry = CheckpointStore(str(tmp_path / "ckpt_user")).restore_latest()[1]
    assert entry["extra"]["epoch"] == 2 and entry["step"] == again["steps"]
    assert entry["extra"]["plateau_best"] is not None and "plateau_scale" in entry["extra"]


def _http(base, method, path, payload=None):
    import urllib.request

    req = urllib.request.Request(base + path, method=method,
                                 data=None if payload is None else json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_serve_answers_recommendations_from_the_stage2_tower(world):
    import pandas as pd

    from recsys_tpu_torch.train.sasrec import prepare_stage2, restore_stage2, tensors_to

    root, sets, _ = world
    argv = ["serve", *sets, *USER, "--set", "serve.user_backend=stage2", "--model-backed"]
    args = cli.parse_args(argv)
    cfg = cli.config_from_args(args)
    ctx = cli.build_app(cfg, args)
    assert ctx.user_backend == "stage-2 tower (best checkpoint)"
    items = pd.read_parquet(f"{root}/items.parquet").sort_values("item_id")
    products = [{"product_id": str(r["item_id"]), "product_name": r["product_name"],
                 "feature_data": {}} for r in items.to_dict("records")]
    server = make_server(ctx, host="127.0.0.1", port=0)
    thread = serve_forever_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        _http(base, "POST", "/api/controller/products/ingest", {"products": products})
        while _http(base, "POST", "/ai-api/serving/vectors/process-pending",
                    {})["processed_count"]:
            pass
        hist = [str(i) for i in items["item_id"].iloc[[3, 17, 40, 41, 90]]]
        sessions = [{"user_id": "shopper", "events": [
            {"product_id": pid, "action_type": 1, "ts": 1000.0 + 86400.0 * d}
            for d, pid in enumerate(hist)]}]
        ins = _http(base, "POST", "/api/v1/debug/insert-manual-data",
                    {"users": [{"user_id": "shopper"}], "sessions": sessions})
        assert ins.get("ok", True) is not False, ins
        assert _http(base, "POST", "/ai-api/serving/users/process-pending",
                     {})["processed_count"] == 1
        rec = _http(base, "GET", "/api/controller/recommendations/shopper?top_k=10")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    # the tower's eval forward on the same left-padded history
    from recsys_tpu_torch.data.dataset import TIME_BUCKET_EDGES

    items_df, users, tx = cli._load_world(cfg)
    data = prepare_stage2(cfg, items_df, users, tx)
    _, user_vectors, _ = restore_stage2(cfg, data, f"{root}/ckpt_user", "cpu")
    L = cfg.user_tower.max_len
    b = {k: np.zeros((1, L), np.int64) for k in ("input_ids", "target_ids", "time_buckets",
                                                 "seq_mask")}
    b.update(user_buckets=np.zeros((1, 4), np.int64), user_cats=np.zeros((1, 5), np.int64),
             user_cont=np.zeros((1, 4), np.float32))
    b["input_ids"][0, L - 5:] = [data["item_map"].idx(p) for p in hist]
    b["time_buckets"][0, L - 5:] = np.digitize(np.array([4.0, 3, 2, 1, 0]), TIME_BUCKET_EDGES[1:])
    b["seq_mask"][0, L - 5:] = 1
    want = user_vectors(tensors_to(b, "cpu")).numpy()[0]
    served = ctx.store.get_user_vector("shopper")
    assert float(np.abs(served - want).max()) <= 2e-2
    res = rec["results"]
    assert 0 < len(res) <= 10 and not set(r["product_id"] for r in res) & set(hist)
    assert all(r["product_id"] != "<pad>" for r in res)
    for r in res:                                      # cosine of the tower's vector
        v = ctx.store.get_vector(r["product_id"])
        ref = float(served @ v / (np.linalg.norm(served) * np.linalg.norm(v)))
        assert r["score"] == pytest.approx(ref, abs=1e-4)


@pytest.mark.parametrize("backend,attached", [("auto", "stage-2 tower (best checkpoint)"),
                                              ("history", "history mean")])
def test_user_backend_choice(world, backend, attached):
    _, sets, _ = world
    args = cli.parse_args(["serve", *sets, *USER, "--set", f"serve.user_backend={backend}",
                           "--model-backed"])
    assert cli.build_app(cli.config_from_args(args), args).user_backend == attached


def test_user_backend_hybrid_and_a_missing_checkpoint_raise(world, tmp_path):
    """As the JAX server: ``hybrid`` without a hybrid checkpoint (this world
    has none, nor GNN artifacts) raises FileNotFoundError, and ``auto`` then
    takes the stage-2 tower (``test_user_backend_choice``); with the
    checkpoint ``auto`` takes the hybrid tower (tests/test_torch_hybrid_slice.py)."""
    root, sets, _ = world
    args = cli.parse_args(["serve", *sets, *USER, "--set", "serve.user_backend=hybrid",
                           "--model-backed"])
    with pytest.raises(FileNotFoundError):
        cli.build_app(cli.config_from_args(args), args)
    for f in ("items.parquet", "users.parquet", "transactions.parquet"):
        shutil.copy(f"{root}/{f}", tmp_path)
    shutil.copytree(f"{root}/ckpt_item", tmp_path / "ckpt_item")
    other = ["--set", f"data.root={tmp_path}", *WORLD, "--device", "cpu", *USER]
    args = cli.parse_args(["serve", *other, "--set", "serve.user_backend=auto",
                           "--model-backed"])
    assert cli.build_app(cli.config_from_args(args), args).user_backend == "history mean"
    args = cli.parse_args(["serve", *other, "--set", "serve.user_backend=stage2",
                           "--model-backed"])
    with pytest.raises(FileNotFoundError):
        cli.build_app(cli.config_from_args(args), args)
