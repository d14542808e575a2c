"""``scripts/torch_quality_hm.py --recipe stage1`` on the CPU: the comparison
with the committed JAX runs of the stage-1 A/B (``artifacts/text_pretrain_ab_v4/``
at 5,000 items, ``artifacts/quality_hm_v4/`` at the H&M world), the
5,000-item world through the port's CLI against the JAX package's JSONs and
table, the recipe end to end at a toy world, and the item step with the
pretrained encoder through ``StepGraph``.

The committed JSONs fed in as the port's must pass every row; each number
moved out of its band or gate, and each A/B sign flipped, must be flagged.
The table is held to the JAX package's (``TABLE_REF``) by its nonzero rows
and its input, the PPMI matrix, bit for bit; its own bits follow the LAPACK
build its SVD runs on, so they are not held. The runner's eager path is held
bit for bit against the step it wraps, and the frozen table bit for bit
against the artifact.
"""

import copy
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from recsys_tpu_torch.config import (Config, DataConfig, ItemTowerConfig, SimCSEConfig,
                                     VocabConfig)
from recsys_tpu_torch.data import text_pretrain as TT
from recsys_tpu_torch.data.dataset import tokenize_items
from recsys_tpu_torch.data.synthetic import generate_dataset
from recsys_tpu_torch.data.vocab import StdVocab
from recsys_tpu_torch.pipeline import cli
from recsys_tpu_torch.train import simcse as TSC
from recsys_tpu_torch.train import state as TST
from recsys_tpu_torch.train.step_graph import StepGraph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = ["data.num_items=120", "data.num_users=60", "data.days=40", "vocab.max_field_tokens=8",
       "vocab.max_name_tokens=8", "item_tower.head_hidden=[128]", "item_tower.fusion_layers=1",
       "item_tower.text_layers=1", "simcse.batch_size=16", "simcse.steps_per_epoch_min=1",
       "vocab.text_vocab_size=512"]
K1 = ("diag_ce_fwd", "diag_ce_bwd_dq", "diag_ce_bwd_dk")


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


def as_run(script) -> tuple[dict, dict, dict, dict]:
    """The committed JSONs of both worlds as this run's, with the JAX tables'
    checksums and the card's replay and launch counts of 1,638 / 312 steps."""
    ref_ab = script.load_reference(script.AB_REFERENCE, script.AB_NAMES)
    ref = script.load_reference(names=script.STAGE1_REFERENCE)
    got_ab, got = copy.deepcopy(ref_ab), copy.deepcopy(ref)
    for run, world in ((got_ab, "ab"), (got, "hm")):
        run["table"] = {**copy.deepcopy(script.TABLE_REF[world]),
                        "max_change_after_train_item": 0.0}
        steps = ref_ab["item_hash"]["steps"] if world == "ab" else ref["item"]["steps"]
        run["train_item"] = {arm: {"steps": steps, "graph_replays": steps - 2,
                                   "k1_launches": {k: 2 * steps for k in K1}}
                             for arm in script.ARMS}
    return got_ab, ref_ab, got, ref


def test_compare_stage1_passes_the_committed_runs(script):
    out = script.compare_stage1(*as_run(script))
    assert out["exact_ok"] and out["bands_ok"] and out["misses"] == []
    rows = {r["name"]: r for r in out["comparisons"]}
    assert {"ab.gen.transactions", "ab.etl_pretrained.split_day", "ab.pretrain.nonzero_rows",
            "ab.table.abs_sum", "ab.item_pretrained.steps", "ab.purity_hash",
            "ab.purity_pretrained", "ab.purity_pretrained_minus_hash", "gen.transactions",
            "etl.sanity.target_users", "item.steps", "vectorize.shape", "pretrain.nonzero_rows",
            "table.max_change_after_train_item", "item_pt.steps", "vectorize_pt.shape",
            "knn_purity", "knn_purity_pt", "knn_purity_pt.within_cos",
            "knn_purity_pt.cross_cos", "purity_pretrained_minus_hash",
            "hm.train_item_pretrained.graph_replays",
            "ab.train_item_hash.k1_launches"} <= set(rows)
    assert rows["ab.purity_pretrained_minus_hash"]["jax"] == pytest.approx(0.184 - 0.1546)
    assert rows["purity_pretrained_minus_hash"]["jax"] < 0
    assert rows["table.sha256"]["bits_equal"] and rows["table.sha256"]["kind"] == "info"
    assert rows["table.abs_sum"]["kind"] == "info" and rows["table.ppmi"]["kind"] == "exact"


def _set(run: dict, path: str, value) -> None:
    keys = path.split(".")
    for key in keys[:-1]:
        run = run[key]
    run[keys[-1]] = value


# each case: changes to (got_ab, got), then the rows that must miss and whether an exact
# gate is among them
CASES = {
    "5k purity out of its band": (
        {"ab": {"purity_pretrained.knn_purity": 0.184 * 1.2}}, {"ab.purity_pretrained"}, True),
    "5k sign flipped inside both bands": (
        {"ab": {"purity_hash.knn_purity": 0.17, "purity_pretrained.knn_purity": 0.165}},
        {"ab.purity_pretrained_minus_hash"}, True),
    "105k sign flipped": (
        {"hm": {"knn_purity.knn_purity": 0.060, "knn_purity_pt.knn_purity": 0.065}},
        {"knn_purity", "knn_purity_pt", "purity_pretrained_minus_hash"}, True),
    "105k cosine out of its band": (
        {"hm": {"knn_purity_pt.within_cos": 0.445 * 0.8}}, {"knn_purity_pt.within_cos"}, True),
    "table moved in training": (
        {"hm": {"table.max_change_after_train_item": 1e-8}},
        {"table.max_change_after_train_item"}, False),
    "table input off the JAX one": (
        {"ab": {"table.ppmi.sha256": "0" * 64}}, {"ab.table.ppmi"}, False),
    "table bits off the JAX ones": (
        {"hm": {"table.abs_sum": 1535.7363733491452, "table.sha256": "f" * 64}}, set(), True),
    "nonzero rows and steps": (
        {"ab": {"pretrain.nonzero_rows": 221}, "hm": {"item_pt.steps": 1637}},
        {"ab.pretrain.nonzero_rows", "item_pt.steps"}, False),
    "a step not replayed": (
        {"hm": {"train_item.pretrained.graph_replays": 1635}},
        {"hm.train_item_pretrained.graph_replays"}, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_compare_stage1_flags_each_miss(script, case):
    changes, misses, exact_ok = CASES[case]
    got_ab, ref_ab, got, ref = as_run(script)
    for world, run in (("ab", got_ab), ("hm", got)):
        for path, value in changes.get(world, {}).items():
            _set(run, path, value)
    out = script.compare_stage1(got_ab, ref_ab, got, ref)
    assert set(out["misses"]) == misses
    assert out["exact_ok"] == exact_ok


@pytest.fixture(scope="module")
def ab_world(script, tmp_path_factory):
    """gen-data -> etl -> pretrain-text of the 5,000-item A/B world through
    the port's CLI: (the stages' JSONs, the CLI arguments, the data root)."""
    root = tmp_path_factory.mktemp("ab_world")
    sets = ["--set", f"data.root={root}", *script.AB_WORLD,
            "--set", "item_tower.text_encoder=pretrained", "--device", "cpu"]
    got = {name: cli.main([stage, *sets]) for name, stage in
           (("gen", "gen-data"), ("etl_pretrained", "etl"), ("pretrain", "pretrain-text"))}
    return got, sets, str(root)


def test_5k_world_through_the_cli_equals_the_jax_run(script, ab_world):
    """gen-data -> etl -> pretrain-text of the 5,000-item A/B world: every
    field of the committed JSONs, and the JAX package's table input bit for
    bit."""
    ref = script.load_reference(script.AB_REFERENCE, ("gen", "etl_pretrained", "pretrain"))
    got, sets, _ = ab_world
    for name in ("gen", "etl_pretrained"):
        assert {k: v for k, v in ref[name].items() if k != "command"} == got[name], name
    assert got["pretrain"]["shape"] == ref["pretrain"]["shape"]
    assert got["pretrain"]["nonzero_rows"] == ref["pretrain"]["nonzero_rows"] == 220
    table = TT.table_checksum(TT.load_text_pretrain(got["pretrain"]["artifact"]))
    want = script.TABLE_REF["ab"]
    assert table["nonzero_rows"] == want["nonzero_rows"] and table["shape"] == want["shape"]
    cfg = cli.config_from_args(cli.parse_args(["pretrain-text", *sets]))
    m = TT.ppmi_matrix(cli._item_tensors(cfg), cfg.vocab.text_vocab_size)
    assert TT.ppmi_checksum(m) == want["ppmi"]


def test_stage1_recipe_runs_every_stage_at_a_toy_world(script, tmp_path, capsys):
    out_dir = tmp_path / "out"
    rc = script.main(["--recipe", "stage1", "--out", str(out_dir), "--device", "cpu",
                      "--root", str(tmp_path / "w"), "--item-epochs", "1", "--requests", "4",
                      *[a for kv in TOY for a in ("--set", kv)]])
    assert rc == 1                     # a toy world is not the committed ones
    for name in (*script.STAGE1_REFERENCE, "etl", "serve", "summary"):
        assert (out_dir / f"{name}.json").exists(), name
    for name in ("gen", "etl_hash", "etl_pretrained", "pretrain", "item_hash", "item_pretrained",
                 "vectorize_hash", "vectorize_pretrained", "purity_hash", "purity_pretrained"):
        assert (out_dir / "ab" / f"{name}.json").exists(), name
    summary = json.loads((out_dir / "summary.json").read_text())
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == summary and lines[-2] == "cpu"
    assert summary["recipe"] == "stage1" and "gen.items" in summary["misses"]
    assert "ab.gen.items" in summary["misses"] and not summary["exact_ok"]
    rows = {r["name"]: r for r in summary["comparisons"]}
    for name in ("ab.table.max_change_after_train_item", "table.max_change_after_train_item",
                 "serve.served_vs_vectorize_err", "serve.similarity_score_err",
                 "serve.similarity_best_hit_first"):
        assert rows[name]["ok"], rows[name]
    assert not any(name.startswith(("ab.train_item", "hm.train_item")) for name in rows)
    for world in ("ab", "hm"):
        for arm in script.ARMS:
            run = summary["train_item"][world][arm]
            assert run["steps"] == 7 and run["graph_replays"] == 0
            assert set(run["k1_launches"].values()) == {0}          # the CPU's plain form
            assert 0 <= summary["purity"][world][arm] <= 1
    pt = summary["train_item"]["hm"]["pretrained"]["table"]
    assert pt["nonzero_rows"] > 0 and pt["max_change_after_train_item"] == 0.0
    serve = json.loads((out_dir / "serve.json").read_text())
    assert serve["refresh_item_vectors"]["count"] == 120 and serve["similarity_requests"] == 4
    assert json.loads((out_dir / "ab" / "purity_hash.json").read_text())["query_sample"] == 120
    assert os.path.islink(tmp_path / "w" / "world_pt" / "features_sequence.parquet")


def test_step_graph_with_the_pretrained_encoder_is_the_step(tmp_path):
    """Three steps through the runner (``capture=False``) and through
    ``make_train_step`` with the pretrained encoder, the view corruption and
    dropout on, generators of one seed: the same losses, embeddings and
    parameters, bit for bit; the frozen table is the artifact after them."""
    cfg = Config(
        data=DataConfig(num_items=64, num_users=16, days=30, seed=3),
        vocab=VocabConfig(max_field_tokens=8, max_name_tokens=8, text_vocab_size=512),
        item_tower=ItemTowerConfig(head_hidden=(128,), fusion_layers=1, text_layers=1,
                                   text_encoder="pretrained", pretrained_dim=32),
        simcse=SimCSEConfig(batch_size=16, epochs=1, steps_per_epoch_min=1))
    items, _, _ = generate_dataset(cfg.data)
    tensors = tokenize_items(items, StdVocab(), cfg.vocab)
    artifact = TT.pretrain_embeddings(tensors, 512, dim=32, seed=3)
    data = TSC.item_tensors_to(tensors, "cpu")
    n, bs = tensors["std"].shape[0], cfg.simcse.batch_size
    runs = []
    for _ in range(2):
        model = TSC.build_model(cfg, StdVocab().size, tensors["std"].shape[1], "cpu", seed=0)
        TSC.load_text_pretrain_into(model, artifact)
        state = TST.TrainState(model, *TSC.make_optimizer(cfg, model, total_steps=10))
        runs.append((model, state, TSC.make_train_step(state, cfg)))
    runner = StepGraph(runs[0][2], runs[0][1], data, bs, torch.Generator().manual_seed(1),
                       capture=False)
    gen = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(2)
    for _ in range(3):
        idx = rng.permutation(n)[:bs]
        got = runner(idx)
        ix = torch.as_tensor(idx)
        ref = runs[1][2]({k: v[ix] for k, v in data.items()}, gen)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    for a, b in zip(runs[0][0].state_dict().values(), runs[1][0].state_dict().values()):
        assert torch.equal(a, b)
    assert runs[0][1].step == 3
    table = runs[0][0].state_dict()["encoder.text_encoder.pretrained_embedding"]
    np.testing.assert_array_equal(table.numpy(), artifact)
    proj = runs[0][0].state_dict()["encoder.text_encoder.pretrained_proj.weight"]
    init = TSC.build_model(cfg, StdVocab().size, tensors["std"].shape[1], "cpu", seed=0)
    assert not torch.equal(proj, init.state_dict()["encoder.text_encoder.pretrained_proj.weight"])


def test_seed_spread_script_at_a_toy_world(tmp_path, capsys):
    """``scripts/text_ab_seeds.py``: both arms over two seeds, the pretrained
    arm over a given table; one line a run, then each arm's spread."""
    spec = importlib.util.spec_from_file_location(
        "text_ab_seeds", os.path.join(REPO, "scripts", "text_ab_seeds.py"))
    seeds = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(seeds)
    table = np.random.default_rng(0).normal(size=(512, 128)).astype(np.float32)
    TT.save_text_pretrain(str(tmp_path / "table"), table)
    assert seeds.main(["--device", "cpu", "--seeds", "42,1", "--table",
                       str(tmp_path / "table.npz"),
                       *[a for kv in TOY for a in ("--set", kv)]]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith(('{"run"', '{"spread"'))]
    runs = [ln["run"] for ln in lines[:-1]]
    assert [(r["arm"], r["seed"]) for r in runs] == [("hash", 42), ("pretrained", 42),
                                                     ("hash", 1), ("pretrained", 1)]
    assert all(r["steps"] == 3 * 7 and r["query_sample"] == 120 for r in runs)   # 3 epochs
    spread = lines[-1]["spread"]
    assert spread["pretrained"]["knn_purity"]["values"] == [r["knn_purity"] for r in runs[1::2]]
    assert lines[-1]["table"].endswith("table.npz")


def test_table_probe_prints_each_step(script, ab_world, tmp_path, capsys):
    """``scripts/text_table_probe.py`` on the 5,000-item world (the one
    ``gen-data`` made for the test above): a line a step of
    ``pretrain_embeddings``, the PPMI input the JAX package's, and the table's
    live rows beside a given table's."""
    spec = importlib.util.spec_from_file_location(
        "text_table_probe", os.path.join(REPO, "scripts", "text_table_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    table = np.zeros((8192, 128), np.float32)
    table[1:3, 0] = 1.0
    TT.save_text_pretrain(str(tmp_path / "t"), table)
    assert probe.main(["--table", str(tmp_path / "t.npz"), "--root", ab_world[2]]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith(('{"probe"', '{"table_rows"'))]
    steps = {ln.pop("probe"): ln for ln in lines[:-1]}
    assert list(steps) == ["ppmi", "omega", "y0", "y1", "y2", "y3", "y4", "qr", "b", "svd_s",
                           "table"]
    assert steps["ppmi"] == script.TABLE_REF["ab"]["ppmi"]
    assert steps["table"]["nonzero_rows"] == 220 and steps["svd_s"]["top"][0] > 0
    assert lines[-1]["table_rows"]["live"] == 2
