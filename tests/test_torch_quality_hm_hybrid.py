"""``scripts/torch_quality_hm.py --recipe hybrid`` on the CPU: the headline
chain (train-gnn -> gnn-eval -> distill -> gnn-eval -> train-hybrid ->
rerank-eval -> serve) at a toy world, and its comparison rows.

The toy world is the verify recipe's, so the exact gates against the
committed JAX run miss and the script exits 1. The comparison is then held
against a synthetic reference directory, the run's own stage JSONs: every
row passes; a band number moved outside its band fails its band and leaves
the exact rows passing (exit 0); an exact number moved fails (exit 1).
"""

import copy
import importlib.util
import json
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = ["data.num_items=120", "data.num_users=60", "data.days=40", "vocab.max_field_tokens=8",
       "vocab.max_name_tokens=8", "item_tower.head_hidden=[128]", "item_tower.fusion_layers=1",
       "item_tower.text_layers=1", "simcse.batch_size=16", "user_tower.max_len=10",
       "user_tower.num_layers=1", "user_train.batch_size=16", "user_train.eval_ks=[20,100]",
       "gnn.batch_size=256", "gnn.steps_per_epoch_min=20", "distill.epochs=3",
       "distill.steps_per_epoch=10"]


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "torch_quality_hm", os.path.join(REPO, "scripts", "torch_quality_hm.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def toy_run(script, tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    tmp = tmp_path_factory.mktemp("hybrid_recipe")
    out_dir = tmp / "out"
    try:
        rc = script.main(["--recipe", "hybrid", "--out", str(out_dir), "--device", "cpu",
                          "--root", str(tmp / "w"), "--item-epochs", "1", "--requests", "4",
                          *[a for kv in TOY for a in ("--set", kv)]])
    finally:
        torch.set_num_threads(n)
    return rc, out_dir


def test_the_chain_runs_at_a_toy_world(script, toy_run):
    rc, out_dir = toy_run
    assert rc == 1                     # a toy world is not the committed one
    for name in (*script.HYBRID_REFERENCE, "serve", "summary"):
        assert (out_dir / f"{name}.json").exists(), name
    summary = json.loads((out_dir / "summary.json").read_text())
    assert summary["recipe"] == "hybrid" and not summary["exact_ok"]
    assert {"gen.items", "distill.shape", "hybrid.hybrid_best.n_eval"} <= set(summary["misses"])
    assert set(summary["stages"]) == {*script.HYBRID_REFERENCE, "serve"}
    gnn = summary["train_gnn"]
    assert gnn["steps"] == 20 and gnn["graph"]["nodes"] == 180
    assert gnn["k2_launches"] == {"spmm_csr": 0}          # the CPU's plain form
    hybrid = json.loads((out_dir / "hybrid.json").read_text())
    assert len(hybrid["hybrid_history"]) == 2                 # user_train.epochs=2
    assert summary["train_hybrid"]["steps"] == hybrid["steps"] > 0
    assert summary["train_hybrid"]["graph_replays"] == 0      # eager on the CPU
    serve = json.loads((out_dir / "serve.json").read_text())
    assert serve["users"] == 4 and serve["rerank_equal_offline"] == 4
    assert serve["served_vs_tower_err"] <= script.SERVE_TOL
    assert set(serve["latency"]) == {"rerank", "blend", "cosine"}
    rows = {r["name"]: r for r in summary["comparisons"]}
    assert rows["serve.rerank_equal_offline"]["ok"] and rows["gnn.check.ok"]["ok"]


def test_rows_against_a_synthetic_reference(script, toy_run):
    _, out_dir = toy_run
    ref = script.load_reference(str(out_dir), script.HYBRID_REFERENCE)
    got = copy.deepcopy(ref)
    out = script.compare_hybrid(got, ref)
    assert out["exact_ok"] and out["bands_ok"] and out["misses"] == []
    kinds = {r["name"]: r["kind"] for r in out["comparisons"]}
    assert kinds["hybrid.hybrid_history.epoch2.recall@100"] == "band"
    assert kinds["gnn_eval_distilled.distill_cos.recall@100"] == "band"
    assert kinds["gnn_eval_distilled.gnn_cos.recall@100"] == "info"
    assert kinds["rerank_hybrid.gbdt_auc"] == "band" and kinds["hybrid.gnn_arm"] == "exact"

    banded = copy.deepcopy(ref)
    banded["hybrid"]["hybrid_best"]["recall@100"] *= 1.2             # band 10%
    banded["rerank_hybrid"]["gbdt_auc"] += 0.03                       # band 0.02 abs
    banded["rerank_hybrid"]["reranked"]["recall@100"] *= 1.04         # inside 5%
    out = script.compare_hybrid(got, banded)
    assert out["exact_ok"] and not out["bands_ok"]
    assert set(out["misses"]) == {"hybrid.hybrid_best.recall@100", "rerank_hybrid.gbdt_auc"}

    exact = copy.deepcopy(ref)
    exact["distill"]["shape"] = [105000, 64]
    exact["rerank_hybrid"]["pool_arms"]["m_cos"] += 1
    out = script.compare_hybrid(got, exact)
    assert not out["exact_ok"] and out["bands_ok"]
    assert set(out["misses"]) == {"distill.shape", "rerank_hybrid.pool_arms"}


def test_rows_of_the_committed_run_pass(script):
    ref = script.load_reference(script.REFERENCE, script.HYBRID_REFERENCE)
    out = script.compare_hybrid(copy.deepcopy(ref), ref)
    assert out["exact_ok"] and out["bands_ok"] and out["misses"] == []
    rows = {r["name"]: r for r in out["comparisons"]}
    assert rows["rerank_hybrid.pool_ceiling.recall@512"]["kind"] == "band"
    assert rows["hybrid.gnn_arm"]["jax"] == "gnn_cos"
    assert rows["gnn_eval.n_eval_users"]["jax"] == 216834
    assert rows["hybrid.hybrid_best.n_eval"]["jax"] == 216802


def test_a_cut_run_is_compared_from_its_stage_jsons(script, toy_run, tmp_path):
    """``--compare DIR``: the rows of a run cut before its serve stage, from
    the stage JSONs it wrote (the toy world misses the exact gates: exit 1)."""
    import shutil

    _, out_dir = toy_run
    for name in script.HYBRID_REFERENCE:
        shutil.copy(out_dir / f"{name}.json", tmp_path / f"{name}.json")
    assert script.main(["--compare", str(tmp_path)]) == 1
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary["cut_before"] == "serve" and "gen.items" in summary["misses"]
    rows = {r["name"]: r for r in summary["comparisons"]}
    assert {"gnn.launches", "gnn.graph_replays", "rerank_hybrid.dcn_graph_replays"} <= set(rows)


def test_the_committed_cut_run_passes(script, tmp_path):
    """The committed card run on the JAX package's inits, cut in its serve
    stage: every exact gate and band of its other stages."""
    import shutil

    src = os.path.join(REPO, "artifacts", "torch_quality_hm_v4_hybrid_flaxinit")
    for name in script.HYBRID_REFERENCE:
        shutil.copy(os.path.join(src, f"{name}.json"), tmp_path / f"{name}.json")
    assert script.main(["--compare", str(tmp_path)]) == 0
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary["exact_ok"] and summary["bands_ok"] and summary["misses"] == []
