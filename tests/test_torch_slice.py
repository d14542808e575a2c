"""The port's slice end to end on the CPU: CLI gen-data -> train-item ->
vectorize on the verify-recipe world, the matrix against the JAX
materialization on the same weights, and the HTTP server.

Matrix tolerance: 2e-2 abs, the JAX suite's served-vs-materialized bound
(tests/test_serve.py): both towers compute in bf16.
"""

import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from recsys_tpu.config import MeshConfig
from recsys_tpu.parallel.mesh import build_mesh
from recsys_tpu.train.checkpoint import load_array_with_ids
from recsys_tpu.train.simcse import materialize_item_vectors as jax_materialize
from recsys_tpu_torch.bridge import torch_to_flax
from recsys_tpu_torch.pipeline import cli
from recsys_tpu_torch.serve.server import make_server, serve_forever_in_thread
from recsys_tpu_torch.train.simcse import restore_model

WORLD = ["--set", "data.num_items=120", "--set", "data.num_users=60",
         "--set", "data.days=40", "--set", "vocab.max_field_tokens=8",
         "--set", "vocab.max_name_tokens=8", "--set", "item_tower.head_hidden=[128]",
         "--set", "item_tower.fusion_layers=1", "--set", "item_tower.text_layers=1",
         "--set", "simcse.batch_size=16", "--set", "simcse.epochs=1",
         "--set", "simcse.steps_per_epoch_min=8",
         "--set", "serve.db_path=:memory:"]


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
    root = tmp_path_factory.mktemp("world")
    sets = ["--set", f"data.root={root}", *WORLD, "--device", "cpu"]
    out = {stage: cli.main([stage, *sets])
           for stage in ("gen-data", "etl", "train-item", "vectorize")}
    return root, sets, out


def test_cli_stages_write_a_matrix_the_jax_package_reads(world):
    root, _, out = world
    assert out["gen-data"]["items"] == 120
    assert "sanity" in out["etl"]
    assert out["train-item"]["steps"] > 0 and np.isfinite(out["train-item"]["losses"]).all()
    assert out["vectorize"]["shape"] == [121, 128]
    mat, ids, meta = load_array_with_ids(f"{root}/item_matrix")
    assert mat.shape == (121, 128) and ids[0] == "<pad>" and meta["pad_row"] == 0
    np.testing.assert_array_equal(mat[0], 0.0)
    np.testing.assert_allclose(np.linalg.norm(mat[1:], axis=1), 1.0, atol=1e-3)
    items = pd.read_parquet(f"{root}/items.parquet")
    assert ids[1:] == sorted(items["item_id"].astype(str))


def test_matrix_matches_jax_materialization_on_the_same_weights(world):
    root, sets, _ = world
    args = cli.parse_args(["vectorize", *sets])
    cfg = cli.config_from_args(args)
    tensors = cli._item_tensors(cfg)
    model, entry = restore_model(cfg, f"{root}/ckpt_item", tensors["std"].shape[1], "cpu")
    assert entry is not None
    mesh = build_mesh(MeshConfig(num_data=1, num_model=1), jax.devices()[:1])
    ref = jax_materialize(cfg, torch_to_flax(model), tensors, mesh,
                          f"{root}/jax_matrix", batch_size=32)
    mat, _, _ = load_array_with_ids(f"{root}/item_matrix")
    np.testing.assert_allclose(mat, ref, atol=2e-2)


def test_device_cuda_without_a_card_raises(world):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, sets, _ = world
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["vectorize", *sets[:-1], "cuda"])


def _call(base, method, path, payload=None, raw=None):
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(base + path, method=method, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _product(row):
    std = ("product_type_name", "graphical_appearance_name", "colour_group_name",
           "department_name", "section_name", "perceived_colour_value_name")
    rf = row["reinforced_feature"] or {}
    return {"product_id": str(row["item_id"]), "product_name": row["product_name"],
            "feature_data": {"reinforced_feature": {k: [str(x) for x in v]
                                                    for k, v in rf.items() if v is not None},
                             **{f: row[f] for f in std}}}


def test_http_server_serves_the_trained_encoder(world):
    root, sets, _ = world
    args = cli.parse_args(["serve", *sets, "--model-backed"])
    ctx = cli.build_app(cli.config_from_args(args), args)
    server = make_server(ctx, host="127.0.0.1", port=0)
    thread = serve_forever_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        code, health = _call(base, "GET", "/")
        assert code == 200 and health["status"] == "ok" and "devices" in health
        code, body = _call(base, "POST", "/api/controller/products/ingest", raw=b"{bad")
        assert code == 400 and body["error"] == "invalid json"
        code, body = _call(base, "GET", "/no/such/route")
        assert code == 404
        items = pd.read_parquet(f"{root}/items.parquet").sort_values("item_id")
        picked = items.head(24).to_dict("records")
        code, body = _call(base, "POST", "/api/controller/products/ingest",
                           {"products": [_product(r) for r in picked]})
        assert code == 200 and body["created"] == 24
        pid = str(picked[0]["item_id"])
        code, body = _call(base, "GET", f"/api/controller/similarity/{pid}")
        assert body["error"] == f"no vector for {pid}" and body["results"] == []
        processed = 0
        while True:
            code, body = _call(base, "POST", "/ai-api/serving/vectors/process-pending",
                               {"batch_size": 10})
            assert code == 200
            if body["processed_count"] == 0:
                break
            processed += body["processed_count"]
        assert processed == 24
        code, sim = _call(base, "GET", f"/api/controller/similarity/{pid}?top_k=5")
        assert code == 200 and len(sim["results"]) == 5
        assert all(r["product_id"] != pid for r in sim["results"])
        # served vectors = the vectorize rows of the same ids
        mat, ids, _ = load_array_with_ids(f"{root}/item_matrix")
        row_of = {p: r for r, p in enumerate(ids)}
        pids = [str(r["item_id"]) for r in picked]
        served = np.stack([ctx.store.get_vector(p) for p in pids])
        np.testing.assert_allclose(served, mat[[row_of[p] for p in pids]], atol=2e-2)
        for r in sim["results"]:
            assert r["score"] == pytest.approx(
                float(mat[row_of[pid]] @ mat[row_of[r["product_id"]]]), abs=2e-2)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_checkpoint_store_keeps_best_and_rotates(tmp_path):
    from recsys_tpu_torch.train.checkpoint import CheckpointStore

    store = CheckpointStore(str(tmp_path), keep=2, maximize=False)
    for step, metric in enumerate([0.9, 0.5, 0.7, 0.6], start=1):
        store.save(f"ep{step}", {"model": {"w": torch.full((2,), float(step))}},
                   step=step, metric=metric)
    names = [c["name"] for c in json.load(open(tmp_path / "manifest.json"))["checkpoints"]]
    assert names == ["ep3", "ep4"]
    assert not (tmp_path / "ep1.pt").exists() and not (tmp_path / "ep2.pt").exists()
    payload, best = CheckpointStore(str(tmp_path), maximize=False).restore_best()
    assert best["step"] == 2 and best["metric"] == 0.5
    assert torch.equal(payload["model"]["w"], torch.full((2,), 2.0))


def test_align_rows_realigns_the_port_matrix_to_a_consumer_order(world):
    from recsys_tpu_torch.train.checkpoint import align_rows

    root, _, _ = world
    mat, ids, _ = load_array_with_ids(f"{root}/item_matrix")
    target = [ids[5], "unknown-id", ids[2]]
    out, found = align_rows(mat, ids, target)
    np.testing.assert_array_equal(out[0], mat[5])
    np.testing.assert_array_equal(out[2], mat[2])
    np.testing.assert_array_equal(out[1], 0.0)
    assert found.tolist() == [True, False, True]
