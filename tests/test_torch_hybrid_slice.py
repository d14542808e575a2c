"""The hybrid slice of the port on the CPU, through its CLI on the verify
recipe's world: ``train-gnn`` -> ``distill`` -> ``gnn-eval`` -> ``train-user``
-> ``eval`` -> ``train-hybrid`` -> ``ensemble-eval`` -> ``rerank-eval
--vectors hybrid`` -> ``serve --vectors hybrid`` with the hybrid user backend,
answering in rerank, blend and cosine mode; the JAX stages on the same
artifacts; the serving recipes against the JAX package's.

Tolerances: ``ensemble-eval`` reads artifacts only, so the port's report equals
the JAX stage's exactly; the served user vector is within 2e-2 of the tower's
eval forward on the same left-padded history and GNN vector (the serving bound
of tests/test_serve.py); the HTTP lists equal the offline recipes' lists
exactly; the device blend equals the host blend exactly.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from recsys_tpu_torch.pipeline import cli
from recsys_tpu_torch.serve import recommend as RC
from recsys_tpu_torch.serve.server import make_server, serve_forever_in_thread

WORLD = ["--set", "data.num_items=120", "--set", "data.num_users=60", "--set", "data.days=40",
         "--set", "vocab.max_field_tokens=8", "--set", "vocab.max_name_tokens=8",
         "--set", "item_tower.head_hidden=[128]", "--set", "item_tower.fusion_layers=1",
         "--set", "item_tower.text_layers=1"]
GNN = ["--set", "gnn.epochs=2", "--set", "gnn.batch_size=256", "--set", "gnn.steps_per_epoch_min=20",
       "--set", "distill.epochs=3", "--set", "distill.steps_per_epoch=10"]
USER = ["--set", "user_tower.max_len=10", "--set", "user_tower.num_layers=1",
        "--set", "user_train.batch_size=16", "--set", "user_train.epochs=2",
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
    root = tmp_path_factory.mktemp("hybrid_world")
    sets = ["--set", f"data.root={root}", *WORLD, "--device", "cpu"]
    out = {}
    for stage, extra in (
            ("gen-data", []), ("etl", []),
            ("train-item", ["--set", "simcse.batch_size=16", "--set", "simcse.epochs=1",
                            "--set", "simcse.steps_per_epoch_min=20"]),
            ("vectorize", []), ("train-gnn", GNN), ("distill", GNN), ("gnn-eval", USER),
            ("train-user", [*USER, "--set", "user_train.epochs=1"]), ("eval", USER),
            ("train-hybrid", USER),
            ("ensemble-eval", USER),
            ("rerank-eval", [*USER, "--vectors", "hybrid", "--iterations", "30"])):
        out[stage] = cli.main([stage, *sets, *extra])
    return root, sets, out


def test_train_hybrid_learns_and_reports(world):
    root, _, out = world
    th = out["train-hybrid"]
    assert th["device"] == "cpu" and len(th["hybrid_history"]) == 2 and th["steps"] > 0
    assert np.isfinite(th["epoch_losses"]).all() and th["step_ms_median"] > 0
    assert th["hybrid_best"]["recall@20"] > 0 and th["hybrid_best"]["n_eval"] > 0
    assert th["gnn_arm"] in ("gnn_dot", "gnn_cos", "distill_cos")
    assert {"blend", "ensemble", "ensemble_alive", "significance"} <= set(th)
    assert set(th["ensemble_alive"]) == {"hybrid_x_repurchase", "hybrid_x_content"}
    for rep in (th["ensemble"], *th["ensemble_alive"].values()):
        assert set(rep) == {"standalone_a", "standalone_b", "count_mix", "weighted", "rrf"}
    mat = np.load(f"{root}/hybrid_item_matrix.npy")
    assert mat.shape == (121, 128)       # the PAD row adapts too, as in the JAX stage
    np.testing.assert_allclose(np.linalg.norm(mat, axis=1), 1.0, atol=1e-5)
    assert json.load(open(f"{root}/ensemble_report.json")).keys() == th["ensemble"].keys()


def test_train_hybrid_without_report_and_the_jax_stages_keys(world, tmp_path):
    """``hybrid_report`` off returns the curve only; the JAX ``train-hybrid``
    on the same artifacts returns the same keys (its own tower, so only
    keys compare)."""
    from recsys_tpu.pipeline import cli as jax_cli

    root, _, out = world
    for f in ("items.parquet", "users.parquet", "transactions.parquet", "item_matrix.npy",
              "item_matrix.ids.json", "gnn_items.npy", "gnn_items.ids.json", "gnn_users.npy",
              "gnn_users.ids.json"):
        shutil.copy(f"{root}/{f}", tmp_path)
    sets = ["--set", f"data.root={tmp_path}", *WORLD, *USER,
            "--set", "user_train.hybrid_report=false", "--set", "user_train.epochs=1"]
    ref = jax_cli.main(["train-hybrid", *sets])
    got = cli.main(["train-hybrid", *sets, "--device", "cpu"])
    assert got["report"] == ref["report"] == "skipped"
    assert set(ref) <= set(got) and len(got["hybrid_history"]) == 1
    assert set(got["hybrid_best"]) == set(ref["hybrid_best"])


def test_ensemble_eval_equals_the_jax_stage(world, tmp_path):
    """A pure artifact consumer: the JAX stage on the port's artifacts gives
    the same report."""
    from recsys_tpu.pipeline import cli as jax_cli

    root, _, out = world
    shutil.copytree(root, tmp_path / "w")
    sets = ["--set", f"data.root={tmp_path / 'w'}", *WORLD, *USER]
    ref = jax_cli.main(["ensemble-eval", *sets])
    got = {k: v for k, v in out["ensemble-eval"].items() if k not in ("device", "seconds")}
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(ref, default=str))
    assert got["stage2_x_gnn"]["standalone_a"]["recall@20"] > 0


def test_rerank_eval_hybrid_saves_the_ports_ranker(world):
    from recsys_tpu_torch.train.reranker import GBDTRanker

    root, _, out = world
    rr = out["rerank-eval"]
    assert rr["vectors"] == "hybrid" and rr["reranked"]["recall@20"] > 0
    assert rr["gbdt_auc"] is not None and "reranked_dcn" in rr and rr["dcn_auc"] is not None
    assert rr["pool_ceiling"]["recall@512"] >= rr["reranked"]["recall@20"]
    ranker = GBDTRanker.load(f"{root}/rerank_gbdt_hybrid.pkl", device="cpu")
    assert ranker.n_iter_ == rr["gbdt_iterations"] > 0
    assert json.load(open(f"{root}/rerank_eval_hybrid.json"))["vectors"] == "hybrid"


def test_rerank_eval_stage2_pools_from_the_stage2_tower(world):
    """``--vectors stage2``: the pools from eval's stored user vectors and the
    best stage-2 checkpoint's item matrix; its own ranker file."""
    root, sets, _ = world
    rr = cli.main(["rerank-eval", *sets, *USER, "--vectors", "stage2", "--iterations", "20"])
    assert rr["vectors"] == "stage2" and rr["reranked"]["recall@20"] > 0
    assert rr["reranked"]["n_eval"] == json.load(open(f"{root}/eval.json"))["n_eval"]
    assert rr["gbdt_iterations"] == 20 and "reranked_dcn" in rr
    assert json.load(open(f"{root}/rerank_eval_stage2.json"))["vectors"] == "stage2"
    with pytest.raises(SystemExit):
        cli.main(["rerank-eval", *sets, *USER, "--vectors", "gnn"])


def _http(base, method, path, payload=None):
    import urllib.request

    req = urllib.request.Request(base + path, method=method,
                                 data=None if payload is None else json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_serve_hybrid_answers_rerank_blend_and_cosine(world):
    """``serve --vectors hybrid --model-backed`` with ``user_backend=hybrid``:
    the served vector is the tower's; the HTTP rerank and blend lists are the
    offline recipes' lists for that vector and history."""
    import pandas as pd

    from recsys_tpu_torch.serve.app import history_batch
    from recsys_tpu_torch.train import hybrid as H
    from recsys_tpu_torch.train.checkpoint import load_array_with_ids
    from recsys_tpu_torch.train.sasrec import prepare_stage2, tensors_to

    root, sets, _ = world
    args = cli.parse_args(["serve", *sets, *USER, "--vectors", "hybrid", "--model-backed",
                           "--set", "serve.user_backend=hybrid"])
    cfg = cli.config_from_args(args)
    ctx = cli.build_app(cfg, args)
    assert ctx.user_backend == "hybrid tower (best checkpoint)"
    assets = ctx.rec_assets
    assert assets.vectors == "hybrid" and assets.ranker is not None
    items = pd.read_parquet(f"{root}/items.parquet").sort_values("item_id")
    products = [{"product_id": str(r["item_id"]), "product_name": r["product_name"],
                 "feature_data": {}} for r in items.to_dict("records")]
    gu, gu_ids, _ = load_array_with_ids(f"{root}/gnn_users")
    uid = str(gu_ids[0])                                  # a user the GNN saw
    hist = [str(i) for i in items["item_id"].iloc[[3, 17, 40, 41, 90]]]
    server = make_server(ctx, host="127.0.0.1", port=0)
    thread = serve_forever_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        _http(base, "POST", "/api/controller/products/ingest", {"products": products})
        while _http(base, "POST", "/ai-api/serving/vectors/process-pending",
                    {})["processed_count"]:
            pass
        sessions = [{"user_id": uid, "events": [
            {"product_id": pid, "action_type": 1, "ts": 1000.0 + 86400.0 * d}
            for d, pid in enumerate(hist)]}]
        ins = _http(base, "POST", "/api/v1/debug/insert-manual-data",
                    {"users": [{"user_id": uid}], "sessions": sessions})
        assert ins.get("ok", True) is not False, ins
        assert _http(base, "POST", "/ai-api/serving/users/process-pending",
                     {})["processed_count"] == 1
        got = {mode: _http(base, "GET",
                           f"/api/controller/recommendations/{uid}?top_k=10&mode={mode}")
               for mode in ("rerank", "blend", "cosine")}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    served = ctx.store.get_user_vector(uid)
    items_df, users, tx = cli._load_world(cfg)
    data = prepare_stage2(cfg, items_df, users, tx)
    content, gnn_items, _, _ = cli._hybrid_inputs(cfg, data)
    _, uv, _ = H.restore_hybrid(cfg, data, content, gnn_items, f"{root}/ckpt_hybrid", "cpu")
    id_of = {p: i for i, p in enumerate(["<pad>"] + list(data["item_map"].ids))}
    batch = history_batch(ctx, cfg, [uid], id_of)
    assert batch["seq_mask"][0].sum() == 5
    want = uv(tensors_to(batch, "cpu"), torch.as_tensor(gu[:1])).numpy()[0]
    assert float(np.abs(served - want).max()) <= 2e-2
    events = ctx.store.user_histories([uid])[uid]
    iidx, days = RC.store_events_arrays(assets, events)
    offline = RC.rerank_serve_topk(assets, served[None], [(iidx, days)], int(days.max()) + 1,
                                   10, pool_size=cfg.serve.rerank_pool,
                                   m_cos=cfg.serve.rerank_m_cos, m_pop=cfg.serve.rerank_m_pop)
    assert got["rerank"]["mode"] == "rerank" and got["rerank"]["vectors"] == "hybrid"
    assert [r["product_id"] for r in got["rerank"]["results"]] == [
        assets.pid_of(int(r)) for r in offline[0]]
    blend = RC.blend_topk(assets, served[None], [iidx], cfg.serve.blend_alpha,
                          cfg.serve.blend_beta, 10)
    assert [r["product_id"] for r in got["blend"]["results"]] == [
        assets.pid_of(int(r)) for r in blend[0]]
    assert set(hist) <= {r["product_id"] for r in got["blend"]["results"]}   # seen bonus
    assert "mode" not in got["cosine"] and len(got["cosine"]["results"]) == 10
    assert not {r["product_id"] for r in got["cosine"]["results"]} & set(hist)


def test_user_backend_auto_picks_hybrid_then_stage2(world, tmp_path):
    root, sets, _ = world
    args = cli.parse_args(["serve", *sets, *USER, "--model-backed"])      # auto
    assert cli.build_app(cli.config_from_args(args), args).user_backend == \
        "hybrid tower (best checkpoint)"
    shutil.copytree(root, tmp_path / "w", ignore=shutil.ignore_patterns("ckpt_hybrid"))
    other = ["--set", f"data.root={tmp_path / 'w'}", *WORLD, "--device", "cpu", *USER]
    args = cli.parse_args(["serve", *other, "--model-backed"])
    assert cli.build_app(cli.config_from_args(args), args).user_backend == \
        "stage-2 tower (best checkpoint)"
    args = cli.parse_args(["serve", *other, "--model-backed", "--set",
                           "serve.user_backend=hybrid"])
    with pytest.raises(FileNotFoundError):
        cli.build_app(cli.config_from_args(args), args)


def test_recipe_modes_fall_back_to_cosine_without_assets(world, tmp_path):
    root, sets, _ = world
    shutil.copytree(root, tmp_path / "w", ignore=shutil.ignore_patterns(
        "hybrid_item_matrix*", "rerank_gbdt_*"))
    other = ["--set", f"data.root={tmp_path / 'w'}", *WORLD, "--device", "cpu", *USER]
    args = cli.parse_args(["serve", *other, "--vectors", "hybrid"])
    ctx = cli.build_app(cli.config_from_args(args), args)
    assert ctx.rec_assets is None
    ctx.store.insert_manual_data([{"user_id": "u"}], [])
    ctx.store.save_user_vectors(["u"], np.ones((1, 128), np.float32))
    ctx._index_add(["a", "b"], np.eye(2, 128, dtype=np.float32))
    for mode in ("rerank", "blend"):
        out = ctx.recommend_for_user("u", top_k=5, mode=mode)
        assert out["requested_mode"] == mode and out["mode"] == "cosine" and out["fallback"]
        assert [r["product_id"] for r in out["results"]] == ["a", "b"]


def test_new_stages_ask_for_cuda_by_default(world):
    _, sets, _ = world
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is there: the default takes it")
    no_device = [a for a in sets if a not in ("--device", "cpu")]
    for stage in ("train-hybrid", "ensemble-eval", "rerank-eval"):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main([stage, *no_device, *USER])
