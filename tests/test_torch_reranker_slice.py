"""The reranker slice of the port through its CLI on the tiny world of the
verify recipe: gen-data -> etl -> train-item -> vectorize -> train-reranker,
beside the JAX package's ``train-reranker`` stage on the same artifacts.

Both stages draw the same training rows (numpy importers under the same
``Generator``), so ``examples`` is equal; the AUCs are not (another held-out
draw in the GBDT, other initial weights in the DCN) and are held by range.
"""

import json
import os

import numpy as np
import pytest
import torch

from recsys_tpu.pipeline import cli as jax_cli
from recsys_tpu_torch.pipeline import cli
from recsys_tpu_torch.train.reranker import GBDTRanker

WORLD = ["--set", "data.num_items=120", "--set", "data.num_users=60", "--set", "data.days=40",
         "--set", "vocab.max_field_tokens=8", "--set", "vocab.max_name_tokens=8",
         "--set", "item_tower.head_hidden=[128]", "--set", "item_tower.fusion_layers=1",
         "--set", "item_tower.text_layers=1", "--set", "simcse.batch_size=16",
         "--set", "simcse.epochs=1", "--set", "reranker.epochs=5"]
JAX_KEYS = {"gbdt_auc", "dcn_auc", "negative_source", "dcn_loss", "examples"}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("reranker_world")
    sets = ["--set", f"data.root={root}", *WORLD]
    for stage in ("gen-data", "etl", "train-item", "vectorize"):
        cli.main([stage, *sets, "--device", "cpu"])
    # the JAX stage first: it reads the port's item matrix and leaves its own
    # (scikit-learn) pickle under the artifact's name
    ref = jax_cli.main(["train-reranker", *sets, "--iterations", "30"])
    with open(f"{root}/reranker_gbdt.pkl", "rb") as f:
        sklearn_pickle = f.read()
    got = cli.main(["train-reranker", *sets, "--iterations", "30", "--device", "cpu"])
    return root, sets, ref, got, sklearn_pickle


def test_train_reranker_reports_the_jax_stage_s_keys(world):
    _, _, ref, got, _ = world
    assert set(ref) == JAX_KEYS and JAX_KEYS <= set(got)
    assert got["examples"] == ref["examples"] > 0        # the same rows were drawn
    assert got["negative_source"] == ref["negative_source"] == "candidates"
    assert got["dcn_loss"] == ref["dcn_loss"] == "bce"
    for key in ("gbdt_auc", "dcn_auc"):
        assert 0.0 <= got[key] <= 1.0 and got[key] == round(got[key], 4)
    assert got["device"] == "cpu" and 0 < got["gbdt_iterations"] <= 30
    assert got["dcn_steps"] > 0 and np.isfinite(got["dcn_step_ms_median"])
    json.dumps(got)                                      # one JSON line, as every stage


def test_the_artifact_loads_and_scores(world):
    root, _, _, got, sklearn_pickle = world
    path = f"{root}/reranker_gbdt.pkl"                   # the JAX stage's path
    assert os.path.exists(path)
    model = GBDTRanker.load(path, "cpu")
    assert model.n_iter_ == got["gbdt_iterations"]
    X = np.random.default_rng(0).normal(size=(50, 10))
    p = model.predict_proba(X)
    assert p.shape == (50,) and ((p > 0) & (p < 1)).all()
    np.testing.assert_array_equal(GBDTRanker.load(path, "cpu").predict_proba(X), p)
    with open(path, "rb") as f:
        assert f.read() != sklearn_pickle                # the port's own format
    legacy = f"{root}/from_sklearn.pkl"
    with open(legacy, "wb") as f:
        f.write(sklearn_pickle)
    with pytest.raises(ValueError, match="scikit-learn"):
        GBDTRanker.load(legacy, "cpu")


@pytest.mark.parametrize("overrides,expected", [
    (["--set", "reranker.negative_source=uniform"], ("uniform", "bce")),
    (["--set", "reranker.loss=pairwise"], ("candidates", "pairwise")),
])
def test_train_reranker_options(world, overrides, expected):
    _, sets, _, _, _ = world
    out = cli.main(["train-reranker", *sets, *overrides, "--iterations", "5", "--device", "cpu"])
    assert (out["negative_source"], out["dcn_loss"]) == expected
    assert out["examples"] > 0 and 0.0 <= out["dcn_auc"] <= 1.0


def test_train_reranker_refuses_device_cuda_without_a_card(world):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, sets, _, _, _ = world
    assert cli.parse_args(["train-reranker"]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train-reranker", *sets])
