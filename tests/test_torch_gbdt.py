"""The port's ``GBDTRanker`` (histogram gradient boosting in plain PyTorch)
against scikit-learn's, which the JAX package's class wraps.

Two holds: (1) a fitted scikit-learn model converted by
``bridge.gbdt_from_sklearn`` predicts the same probabilities through the
port's tree walk (1e-6: fp64 thresholds and leaf values on both sides);
(2) the port's own ``fit`` cannot match tree for tree (its held-out rows are
another draw), so it is held by contract: held-out AUC within 0.02 of
scikit-learn's on the same problem, early stopping, determinism, save/load.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from sklearn.ensemble import HistGradientBoostingClassifier

import recsys_tpu.train.reranker as JR
import recsys_tpu_torch.train.reranker as TR
from recsys_tpu_torch.bridge import gbdt_from_sklearn
from recsys_tpu_torch.data.ranker_features import build_rank_features


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _synthetic_ranking_problem(n=3000, seed=0):
    """The problem of tests/test_reranker.py."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 16)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    i = rng.normal(size=(n, 16)).astype(np.float32)
    i /= np.linalg.norm(i, axis=1, keepdims=True)
    um = rng.normal(size=(n, 3)).astype(np.float32)
    im = rng.normal(size=(n, 2)).astype(np.float32)
    X = build_rank_features(u, i, um, im)
    logit = np.clip(3.0 * X[:, 0] - 1.5 * np.abs(X[:, 9]) + 0.5 * X[:, 7], -60, 60)
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.int32)
    return X, y


@pytest.fixture(scope="module")
def problem():
    return _synthetic_ranking_problem()


@pytest.fixture(scope="module")
def sklearn_ranker(problem):
    X, y = problem
    ranker = JR.GBDTRanker(iterations=100)
    ranker.model.set_params(random_state=0)      # its held-out draw, fixed for the test
    return ranker.fit(X[:2400], y[:2400])


@pytest.fixture(scope="module")
def port_ranker(problem):
    X, y = problem
    return TR.GBDTRanker(iterations=100, device="cpu").fit(X[:2400], y[:2400])


def test_the_constants_are_scikit_learn_s_defaults():
    sk = HistGradientBoostingClassifier()
    assert (TR.MAX_BINS, TR.MAX_LEAF_NODES, TR.MIN_SAMPLES_LEAF) == (
        sk.max_bins, sk.max_leaf_nodes, sk.min_samples_leaf)
    assert sk.l2_regularization == 0.0 and TR.TOL == sk.tol
    wrapped = JR.GBDTRanker().model
    port = TR.GBDTRanker(device="cpu")
    assert (port.iterations, port.lr, port.depth, port.early_stopping) == (
        wrapped.max_iter, wrapped.learning_rate, wrapped.max_depth, wrapped.n_iter_no_change)
    assert TR.VALIDATION_FRACTION == wrapped.validation_fraction


def test_converted_sklearn_trees_predict_the_same(problem, sklearn_ranker):
    X, _ = problem
    arrays = gbdt_from_sklearn(sklearn_ranker.model)
    assert arrays["feature"].shape[0] == sklearn_ranker.model.n_iter_
    port = TR.GBDTRanker.from_trees(arrays, "cpu")
    got = port.predict_proba(X)
    assert got.shape == (len(X),)
    np.testing.assert_allclose(got, sklearn_ranker.predict_proba(X), atol=1e-6, rtol=0)
    # rows with a missing value take the side scikit-learn recorded
    Xn = X[:200].astype(np.float64).copy()
    Xn[::3, 0] = np.nan
    Xn[1::3, 9] = np.nan
    np.testing.assert_allclose(port.predict_proba(Xn),
                               sklearn_ranker.model.predict_proba(Xn)[:, 1], atol=1e-6, rtol=0)


def test_converted_trees_survive_save_and_load(problem, sklearn_ranker, tmp_path):
    X, _ = problem
    port = TR.GBDTRanker.from_trees(gbdt_from_sklearn(sklearn_ranker.model), "cpu")
    port.save(str(tmp_path / "reranker_gbdt.pkl"))
    again = TR.GBDTRanker.load(str(tmp_path / "reranker_gbdt.pkl"), "cpu")
    np.testing.assert_array_equal(again.predict_proba(X), port.predict_proba(X))


def test_gbdt_from_sklearn_refuses_what_it_cannot_carry():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 3))
    y3 = rng.integers(0, 3, 300)
    with pytest.raises(ValueError, match="binary"):
        gbdt_from_sklearn(HistGradientBoostingClassifier(max_iter=3).fit(X, y3))
    Xc = X.copy()
    Xc[:, 0] = rng.integers(0, 4, 300)
    cat = HistGradientBoostingClassifier(max_iter=5, categorical_features=[0]).fit(
        Xc, (Xc[:, 0] % 2 == 0).astype(int))
    with pytest.raises(ValueError, match="categorical"):
        gbdt_from_sklearn(cat)


def test_own_fit_reaches_scikit_learn_s_auc(problem, sklearn_ranker, port_ranker):
    X, y = problem
    ref = sklearn_ranker.auc(X[2400:], y[2400:])
    got = port_ranker.auc(X[2400:], y[2400:])
    assert got > 0.7
    assert abs(got - ref) <= 0.02, (got, ref)
    proba = port_ranker.predict_proba(X[2400:])
    assert proba.dtype == np.float64 and ((proba > 0) & (proba < 1)).all()


def test_own_fit_starts_where_scikit_learn_starts_and_learns(sklearn_ranker, port_ranker):
    """Both start from the log-odds of the positives, so the held-out loss
    before the first tree is the same up to the draw of the held-out 15%; the
    curves after it depend on that draw and are not compared."""
    ref = -np.asarray(sklearn_ranker.model.validation_score_)
    got = np.asarray(port_ranker.validation_losses_)
    assert len(got) == port_ranker.n_iter_ + 1
    np.testing.assert_allclose(got[0], ref[0], atol=5e-3)
    assert got.min() < 0.85 * got[0] and ref.min() < 0.85 * ref[0]


def test_trees_respect_the_growth_limits(port_ranker):
    t = port_ranker.trees
    assert t["feature"].shape[0] == port_ranker.n_iter_
    leaves = t["is_leaf"] & (t["value"] != 0)
    assert leaves.sum(1).max() <= TR.MAX_LEAF_NODES
    assert port_ranker.max_depth_ <= 6
    shallow = TR.GBDTRanker(iterations=3, depth=1, early_stopping=0, device="cpu")
    X = np.random.default_rng(0).normal(size=(400, 2))
    shallow.fit(X, (X[:, 0] > 0).astype(int))
    assert shallow.max_depth_ == 1 and (~shallow.trees["is_leaf"]).sum(1).max() == 1
    assert shallow.trees["feature"][0, 0] == 0           # the stump splits on the signal
    assert abs(shallow.trees["threshold"][0, 0]) < 0.2


def test_min_samples_leaf_and_goes_left_on_equal():
    """A tree is never split into a leaf of under 20 rows; a row whose value
    equals a threshold goes left."""
    X = np.repeat(np.arange(6.0), 30)[:, None]            # six distinct values
    y = (X[:, 0] >= 3).astype(int)
    m = TR.GBDTRanker(iterations=5, early_stopping=0, device="cpu").fit(X, y)
    assert m.trees["threshold"][0, 0] == 2.5              # the midpoint of 2 and 3
    p = m.predict_proba(np.array([[2.0], [2.5], [2.5000001], [3.0]]))
    assert p[0] == p[1] < p[2] == p[3]
    few = TR.GBDTRanker(iterations=2, early_stopping=0, device="cpu").fit(X[:30], y[:30] | 1)
    assert few.trees["is_leaf"].all()                     # 30 rows cannot give two leaves of 20


def test_early_stopping_stops():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(600, 4))
    y = rng.integers(0, 2, 600)                           # noise: nothing to learn
    m = TR.GBDTRanker(iterations=200, early_stopping=5, device="cpu").fit(X, y)
    assert m.n_iter_ < 60
    losses = m.validation_losses_
    assert len(losses) == m.n_iter_ + 1
    assert not any(loss < losses[-6] - TR.TOL for loss in losses[-5:])
    full = TR.GBDTRanker(iterations=12, early_stopping=0, device="cpu").fit(X, y)
    assert full.n_iter_ == 12 and full.validation_losses_ == []   # no rows held out


def test_save_load_round_trip_and_same_seed_same_trees(problem, port_ranker, tmp_path):
    X, y = problem
    path = str(tmp_path / "reranker_gbdt.pkl")
    port_ranker.save(path)
    again = TR.GBDTRanker.load(path, "cpu")
    np.testing.assert_array_equal(again.predict_proba(X), port_ranker.predict_proba(X))
    assert (again.iterations, again.lr, again.depth, again.early_stopping, again.seed) == (
        100, 0.05, 6, 50, 0)
    twin = TR.GBDTRanker(iterations=100, device="cpu").fit(X[:2400], y[:2400])
    for k in TR.FOREST_KEYS:
        np.testing.assert_array_equal(twin.trees[k], port_ranker.trees[k])
    other = TR.GBDTRanker(iterations=100, seed=1, device="cpu").fit(X[:2400], y[:2400])
    assert not np.array_equal(other.predict_proba(X), port_ranker.predict_proba(X))


def test_load_refuses_a_scikit_learn_pickle_and_says_why(sklearn_ranker, tmp_path):
    path = str(tmp_path / "reranker_gbdt.pkl")
    sklearn_ranker.save(path)
    with pytest.raises(ValueError, match="scikit-learn"):
        TR.GBDTRanker.load(path, "cpu")
    with pytest.raises(FileNotFoundError):
        TR.GBDTRanker.load(str(tmp_path / "missing.pkl"), "cpu")


def test_fit_and_predict_refuse_bad_input():
    m = TR.GBDTRanker(device="cpu")
    X = np.zeros((10, 2))
    with pytest.raises(RuntimeError, match="not fitted"):
        m.predict_proba(X)
    with pytest.raises(ValueError, match="labels"):
        m.fit(X, np.arange(10))
    with pytest.raises(ValueError, match="NaN"):
        m.fit(np.full((10, 2), np.nan), np.zeros(10, int))
    with pytest.raises(ValueError, match="rows"):
        m.fit(X, np.zeros(9, int))


def test_port_ranker_runs_where_scikit_learn_cannot_be_imported(tmp_path):
    """The machine with the card has no scikit-learn: fit, save, load and
    predict in a process whose import system refuses it."""
    code = r"""
import sys
BLOCKED = ("sklearn", "scipy", "jax", "flax", "optax", "recsys_tpu")
for m in list(sys.modules):
    if m.split(".")[0] in BLOCKED:
        del sys.modules[m]
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np
from recsys_tpu_torch.train.reranker import GBDTRanker
rng = np.random.default_rng(0)
X = rng.normal(size=(400, 3))
y = (X[:, 0] + 0.3 * rng.normal(size=400) > 0).astype(int)
m = GBDTRanker(iterations=10, device="cpu").fit(X, y)
m.save(sys.argv[1])
again = GBDTRanker.load(sys.argv[1], "cpu")
assert np.array_equal(again.predict_proba(X), m.predict_proba(X))
assert m.auc(X, y) > 0.9
assert not [k for k in sys.modules if k.split(".")[0] in BLOCKED]
print("ok")
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "reranker_gbdt.pkl")],
                         cwd=repo, env={**os.environ, "PYTHONPATH": repo},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
