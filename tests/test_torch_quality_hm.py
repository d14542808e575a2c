"""``scripts/torch_quality_hm.py`` on the CPU: every stage of the H&M-scale
run at a toy world, and the comparison with the committed JAX run.

The toy world is the verify recipe's (120 items, 60 users, 40 days, narrow
towers), so the exact gates against ``artifacts/quality_hm_v4/`` miss and
the script exits 1; the test holds that every stage ran to the summary. The
comparison code is held on the committed numbers themselves (every row
passes) and on numbers moved out of their bands (each is flagged).
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
       "user_tower.num_layers=1", "user_train.batch_size=16", "user_train.eval_ks=[5,20]"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "torch_quality_hm", os.path.join(REPO, "scripts", "torch_quality_hm.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def as_run(ref: dict) -> dict:
    """The committed stage JSONs in the shape ``compare`` takes for this run."""
    got = {name: copy.deepcopy(ref[name])
           for name in ("gen", "etl", "item", "vectorize", "knn_purity", "eval")}
    got["curve"] = copy.deepcopy(ref["user_curve"]["curve"])
    got["eval_epoch"] = len(got["curve"])
    return got


def test_compare_passes_the_committed_run(script):
    ref = script.load_reference()
    out = script.compare(as_run(ref), ref)
    assert out["exact_ok"] and out["bands_ok"] and out["misses"] == []
    names = {r["name"] for r in out["comparisons"]}
    assert {"gen.transactions", "etl.sanity.target_users", "item.steps", "vectorize.shape",
            "eval.baselines.repurchase.recall@100", "train-user.n_eval", "knn_purity",
            "curve.epoch3.recall@100", "eval.blend.best.recall@100",
            "eval.baselines.content_profile.recall@100"} <= names


def test_compare_flags_numbers_outside_their_bands(script):
    ref = script.load_reference()
    got = as_run(ref)
    got["gen"]["transactions"] += 1
    got["eval"]["baselines"]["popularity"]["recall@100"] += 1e-9
    got["knn_purity"]["knn_purity"] *= 1.2                    # band 15%
    got["curve"][4]["recall@100"] *= 0.85                     # band 10%, epoch 5
    got["curve"][1]["recall@100"] *= 0.5                      # epoch 2: not gated
    got["eval"]["blend"]["best_metrics"]["recall@100"] *= 1.04   # inside 5%
    out = script.compare(got, ref)
    assert not out["exact_ok"] and not out["bands_ok"]
    assert set(out["misses"]) == {"gen.transactions", "eval.baselines.popularity.recall@100",
                                  "knn_purity", "curve.epoch5.recall@100"}
    rows = {r["name"]: r for r in out["comparisons"]}
    assert rows["curve.epoch5.recall@100"]["rel_gap"] == pytest.approx(-0.15)
    assert rows["eval.blend.best.recall@100"]["ok"]


def test_compare_with_fewer_epochs_holds_only_those(script):
    ref = script.load_reference()
    got = as_run(ref)
    got["curve"] = got["curve"][:6]
    got["eval_epoch"] = 6
    got["eval"].update({k: v for k, v in got["curve"][5].items() if k.startswith("recall@")})
    out = script.compare(got, ref)
    rows = {r["name"]: r for r in out["comparisons"]}
    assert out["exact_ok"] and out["bands_ok"]
    assert rows["curve.epoch7.recall@100"]["kind"] == "info"
    assert rows["eval.blend.best.recall@100"]["kind"] == "info"     # no JAX blend at epoch 6
    assert rows["eval.model_only.recall@100"]["jax"] == ref["user_curve"]["curve"][5][
        "recall@100"] and rows["eval.model_only.recall@100"]["kind"] == "band"


def test_every_stage_runs_at_a_toy_world(script, tmp_path, capsys):
    out_dir = tmp_path / "out"
    rc = script.main(["--out", str(out_dir), "--device", "cpu", "--root", str(tmp_path / "w"),
                      "--user-epochs", "2", "--item-epochs", "1", "--requests", "4",
                      *[a for kv in TOY for a in ("--set", kv)]])
    assert rc == 1                     # a toy world is not the committed one
    for name in ("gen", "etl", "item", "vectorize", "knn_purity", "user", "user_curve", "eval",
                 "serve", "summary"):
        assert (out_dir / f"{name}.json").exists(), name
    summary = json.loads((out_dir / "summary.json").read_text())
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == summary and lines[-2] == "cpu"
    assert summary["epochs_run"] == 2 and summary["device"] == "cpu"
    assert "gen.items" in summary["misses"] and not summary["exact_ok"]
    assert set(summary["stages"]) == {"gen", "etl", "item", "vectorize", "knn_purity", "user",
                                      "eval", "serve"}
    assert summary["stages"]["user"]["k1_launches"]["diag_ce_fwd"] == 0    # the CPU's plain form
    epoch_rows = [json.loads(ln)["epoch_eval"] for ln in lines if '"epoch_eval"' in ln]
    assert [r["step"] for r in epoch_rows] == [1, 2]
    serve = json.loads((out_dir / "serve.json").read_text())
    assert serve["users"] == 4 and serve["served_vs_tower_err"] <= script.SERVE_TOL
    assert serve["stage2_rows_vs_eval_uvecs_err"] <= script.SERVE_TOL
    assert serve["refresh_item_vectors"]["count"] == 120
    assert set(serve["latency"]) == {"cosine", "blend"}
    purity = json.loads((out_dir / "knn_purity.json").read_text())
    assert purity["n_items"] == 120 and 0 <= purity["knn_purity"] <= 1
