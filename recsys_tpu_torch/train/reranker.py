"""Reranker training + retrieve-then-rerank inference.

Counterpart of ``recsys_tpu/train/reranker.py``:

  * ``GBDTRanker`` — gradient-boosted classifier with early stopping and AUC
    tracking. The JAX package wraps scikit-learn's histogram gradient
    boosting; this is the port's own, in plain PyTorch on the given device,
    with the settings that class gets from scikit-learn's defaults (the
    constants below);
  * ``train_dcn`` / ``train_deepfm`` — BCE (or group-wise pairwise) training
    of the neural rerankers, each returning ``(state, model, scorer)``. On a
    CUDA device each step is one CUDA graph replay (``neural_runner``, the
    rows gathered on the device), as the JAX steps are jitted, and
    ``DeepFM``'s FM term is the hand-written kernel (``ops/fm_kernel.py``),
    forward and backward, in training and in scoring;
  * ``ReRankingSystem`` — dot-product top-K candidates -> feature build ->
    reranker proba -> final top-k, sharing the retrieval top-k path with eval.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from recsys_tpu_torch.config import Config
from recsys_tpu_torch.data.ranker_features import build_rank_features
from recsys_tpu_torch.device import resolve_device
from recsys_tpu_torch.eval.recall import topk_scores
from recsys_tpu_torch.models import flax_init
from recsys_tpu_torch.models.reranker import DCNRanker, DeepFM
from recsys_tpu_torch.train.state import StepTimer, TrainState, device_adam
from recsys_tpu_torch.train.step_graph import StepGraph


def auc_score(labels: np.ndarray, scores: np.ndarray) -> float:
    """Rank-statistic AUC (ties handled by midranks)."""
    order = np.argsort(scores, kind="stable")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    # midranks for ties
    s_sorted = scores[order]
    i = 0
    while i < len(s_sorted):
        j = i
        while j + 1 < len(s_sorted) and s_sorted[j + 1] == s_sorted[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    pos = labels == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


# -- histogram gradient boosting -------------------------------------------------

# scikit-learn's HistGradientBoostingClassifier defaults, which the JAX
# package's GBDTRanker trains under
MAX_BINS = 255               # value bins per feature, from training quantiles
MAX_LEAF_NODES = 31          # leaves per tree, grown best-gain-first
MIN_SAMPLES_LEAF = 20
MIN_HESSIAN_TO_SPLIT = 1e-3
VALIDATION_FRACTION = 0.15   # held out (stratified) for early stopping
TOL = 1e-7                   # an iteration improves if its loss falls by more
BINNING_SUBSAMPLE = 200_000  # rows the quantiles are taken from
FOREST_KEYS = ("feature", "threshold", "left", "right", "value", "is_leaf", "missing_left")
GBDT_FORMAT = "recsys_tpu_torch.gbdt.v1"
_NB = MAX_BINS + 1           # histogram width per feature
_PREDICT_ROWS = 16384        # rows walked through the forest at once


def _forest_raw(forest: Mapping[str, torch.Tensor], X: torch.Tensor, depth: int,
                baseline: float) -> torch.Tensor:
    """Sum of the trees' leaf values + baseline for fp64 rows ``X`` (n, F).
    A row goes left when ``x <= threshold`` (a NaN where ``missing_left``)."""
    T, M = forest["feature"].shape
    flat = {k: v.reshape(-1) for k, v in forest.items()}
    tree_off = (torch.arange(T, device=X.device) * M)[None, :]
    out = torch.full((X.shape[0],), baseline, dtype=torch.float64, device=X.device)
    for s in range(0, X.shape[0], _PREDICT_ROWS):
        x = X[s:s + _PREDICT_ROWS]
        node = torch.zeros((x.shape[0], T), dtype=torch.int64, device=X.device)
        for _ in range(depth):
            at = node + tree_off
            xv = torch.gather(x, 1, flat["feature"][at])
            go_left = torch.where(torch.isnan(xv), flat["missing_left"][at],
                                  xv <= flat["threshold"][at])
            nxt = torch.where(go_left, flat["left"][at], flat["right"][at])
            node = torch.where(flat["is_leaf"][at], node, nxt)
        out[s:s + _PREDICT_ROWS] += flat["value"][node + tree_off].sum(dim=1)
    return out


def _stack_trees(trees: list[dict]) -> tuple[dict[str, np.ndarray], int]:
    """Per-tree node arrays -> (T, M) arrays padded with zero-valued leaves,
    and the deepest tree's depth."""
    M = max((len(t["value"]) for t in trees), default=1)
    dtypes = {"feature": np.int64, "threshold": np.float64, "left": np.int64,
              "right": np.int64, "value": np.float64, "is_leaf": bool, "missing_left": bool}
    out = {k: np.zeros((len(trees), M), dt) for k, dt in dtypes.items()}
    out["is_leaf"][:] = True
    for t, tree in enumerate(trees):
        for k in FOREST_KEYS:
            out[k][t, :len(tree[k])] = tree[k]
    return out, max((int(t["depth"]) for t in trees), default=0)


@dataclass
class _Node:
    rows: torch.Tensor        # training-row indices in this node
    depth: int
    G: float                  # gradient, hessian and row totals
    H: float
    N: float
    hist: torch.Tensor        # (3, F, _NB): gradient, hessian, count per bin
    split: tuple | None = None   # (gain, feature, bin, G_left, H_left, N_left)
    index: int = -1
    children: tuple = ()


class GBDTRanker:
    """Gradient-boosted reranker: histogram boosting on the binary log loss.

    Trees are grown best-gain-first to at most ``MAX_LEAF_NODES`` leaves under
    ``depth``, over ``MAX_BINS`` quantile bins of the training rows; training
    stops when the loss on a held-out ``VALIDATION_FRACTION`` (stratified,
    drawn from ``seed``) has not improved for ``early_stopping`` iterations.
    Binning, histograms, split search and prediction are tensor operations on
    ``device``."""

    def __init__(self, iterations: int = 200, lr: float = 0.05, depth: int = 6,
                 early_stopping: int = 50, seed: int = 0,
                 device: torch.device | str = "cuda"):
        self.iterations, self.lr, self.depth = iterations, lr, depth
        self.early_stopping, self.seed = early_stopping, seed
        self.device = resolve_device(device)
        self.baseline = 0.0
        self.max_depth_ = 0
        self.n_iter_ = 0
        self.validation_losses_: list[float] = []
        self.trees: dict[str, np.ndarray] = _stack_trees([])[0]
        self._forest: dict[str, torch.Tensor] | None = None

    # -- fitted state ---------------------------------------------------------

    def _set_trees(self, trees: Mapping[str, np.ndarray], depth: int,
                   baseline: float) -> "GBDTRanker":
        self.trees = {k: np.asarray(trees[k]) for k in FOREST_KEYS}
        self.max_depth_, self.baseline = int(depth), float(baseline)
        self.n_iter_ = self.trees["feature"].shape[0]
        self._forest = {k: torch.as_tensor(v, device=self.device)
                        for k, v in self.trees.items()}
        return self

    @classmethod
    def from_trees(cls, arrays: Mapping, device: torch.device | str = "cuda"
                   ) -> "GBDTRanker":
        """A ranker over given tree arrays (``FOREST_KEYS`` as (T, M) arrays,
        ``depth``, ``baseline``), e.g. ``bridge.gbdt_from_sklearn``'s."""
        return cls(device=device)._set_trees(arrays, arrays["depth"], arrays["baseline"])

    # -- training ---------------------------------------------------------------

    def _holdout(self, y: np.ndarray) -> np.ndarray:
        """Mask of the held-out rows: ``VALIDATION_FRACTION`` of each class."""
        val = np.zeros(len(y), bool)
        if not self.early_stopping:
            return val
        rng = np.random.default_rng(self.seed)
        for c in (0, 1):
            idx = rng.permutation(np.flatnonzero(y == c))
            val[idx[:int(round(VALIDATION_FRACTION * len(idx)))]] = True
        return val

    def _bin_thresholds(self, X: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(F, MAX_BINS - 1) thresholds padded with +inf, and each feature's bin
        count. Few distinct values: the midpoints between them; else quantiles."""
        if X.shape[0] > BINNING_SUBSAMPLE:
            pick = np.random.default_rng(self.seed).choice(X.shape[0], BINNING_SUBSAMPLE,
                                                          replace=False)
            X = X[torch.as_tensor(pick, device=X.device)]
        qs = torch.linspace(0, 1, MAX_BINS + 1, dtype=torch.float64, device=X.device)[1:-1]
        thr = torch.full((X.shape[1], MAX_BINS - 1), torch.inf, dtype=torch.float64,
                         device=X.device)
        n_bins = torch.ones(X.shape[1], dtype=torch.int64, device=X.device)
        for f in range(X.shape[1]):
            distinct = torch.unique(X[:, f])
            if distinct.shape[0] <= MAX_BINS:
                cuts = (distinct[:-1] + distinct[1:]) / 2
            else:
                cuts = torch.unique(torch.quantile(X[:, f], qs, interpolation="midpoint"))
            thr[f, :cuts.shape[0]] = cuts
            n_bins[f] = cuts.shape[0] + 1
        return thr, n_bins

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GBDTRanker":
        X, y = np.asarray(X, np.float64), np.asarray(y)
        if X.ndim != 2 or len(y) != len(X) or not len(X):
            raise ValueError(f"X {X.shape} and y {y.shape}: want (n, F) rows and n labels")
        if not np.isfinite(X).all():
            raise ValueError("X holds NaN or infinite values")
        if not np.isin(y, (0, 1)).all():
            raise ValueError("y must hold the labels 0 and 1")
        dev, f64 = self.device, torch.float64
        val = self._holdout(y)
        Xt = torch.as_tensor(X[~val], device=dev)
        yt = torch.as_tensor(y[~val], dtype=f64, device=dev)
        Xv = torch.as_tensor(X[val], device=dev)
        yv = torch.as_tensor(y[val], dtype=f64, device=dev)
        n, nf = Xt.shape

        thr, n_bins = self._bin_thresholds(Xt)
        binned = torch.searchsorted(thr, Xt.T.contiguous()).T.contiguous()   # (n, F)
        flat_bins = binned + torch.arange(nf, device=dev)[None, :] * _NB
        # a split at bin b needs a bin to its right
        splittable = torch.arange(_NB, device=dev)[None, :] < (n_bins[:, None] - 1)
        thr_host = thr.cpu().numpy()

        p = float(np.clip(y[~val].mean(), 1e-15, 1 - 1e-15))
        baseline = float(np.log(p / (1 - p)))
        raw = torch.full((n,), baseline, dtype=f64, device=dev)
        raw_val = torch.full((Xv.shape[0],), baseline, dtype=f64, device=dev)

        def val_loss() -> float:
            return float(F.binary_cross_entropy_with_logits(raw_val, yv))

        def histogram(rows, g, h):
            idx = flat_bins[rows].reshape(-1)
            size = nf * _NB
            return torch.stack([
                torch.bincount(idx, weights=g[rows].repeat_interleave(nf), minlength=size),
                torch.bincount(idx, weights=h[rows].repeat_interleave(nf), minlength=size),
                torch.bincount(idx, minlength=size).to(f64)]).reshape(3, nf, _NB)

        def best_split(node: _Node):
            left = node.hist.cumsum(dim=-1)
            GL, HL, NL = left[0], left[1], left[2]
            GR, HR, NR = node.G - GL, node.H - HL, node.N - NL
            ok = (splittable & (NL >= MIN_SAMPLES_LEAF) & (NR >= MIN_SAMPLES_LEAF)
                  & (HL >= MIN_HESSIAN_TO_SPLIT) & (HR >= MIN_HESSIAN_TO_SPLIT))
            gain = GL * GL / HL + GR * GR / HR - node.G * node.G / node.H
            gain = torch.where(ok & (gain > 0), gain, -torch.inf).reshape(-1)
            at = torch.argmax(gain)
            got = torch.stack([gain[at], at.to(f64), GL.reshape(-1)[at], HL.reshape(-1)[at],
                               NL.reshape(-1)[at]]).tolist()
            if got[0] == -np.inf:
                return None
            return (got[0], int(got[1]) // _NB, int(got[1]) % _NB, got[2], got[3], got[4])

        def grow(g, h) -> tuple[dict, list[_Node]]:
            rows = torch.arange(n, device=dev)
            root = _Node(rows, 0, float(g.sum()), float(h.sum()), float(n),
                         histogram(rows, g, h))
            nodes, heap, leaves = [root], [], 1

            def consider(node: _Node) -> None:
                node.index = len(nodes) - 1
                if node.depth < self.depth and node.N >= 2 * MIN_SAMPLES_LEAF:
                    node.split = best_split(node)
                    if node.split is not None:
                        heapq.heappush(heap, (-node.split[0], node.index))

            consider(root)
            while heap and leaves < MAX_LEAF_NODES:
                node = nodes[heapq.heappop(heap)[1]]
                _, feat, b, GL, HL, NL = node.split
                goes_left = binned[node.rows, feat] <= b
                parts = (node.rows[goes_left], node.rows[~goes_left])
                small = 0 if NL <= node.N - NL else 1
                hists = [None, None]
                hists[small] = histogram(parts[small], g, h)
                hists[1 - small] = node.hist - hists[small]
                totals = ((GL, HL, NL), (node.G - GL, node.H - HL, node.N - NL))
                kids = []
                for side in (0, 1):
                    kid = _Node(parts[side], node.depth + 1, *totals[side], hists[side])
                    nodes.append(kid)
                    consider(kid)
                    kids.append(kid)
                node.children, node.rows, node.hist = tuple(kids), None, None
                leaves += 1

            tree = {k: np.zeros(len(nodes), dt) for k, dt in (
                ("feature", np.int64), ("threshold", np.float64), ("left", np.int64),
                ("right", np.int64), ("value", np.float64), ("is_leaf", bool),
                ("missing_left", bool))}
            tree["depth"] = max(nd.depth for nd in nodes)
            final = []
            for nd in nodes:
                if nd.children:
                    _, feat, b, _, _, NL = nd.split
                    tree["feature"][nd.index], tree["threshold"][nd.index] = feat, thr_host[feat, b]
                    tree["left"][nd.index] = nd.children[0].index
                    tree["right"][nd.index] = nd.children[1].index
                    tree["missing_left"][nd.index] = NL > nd.N - NL
                else:
                    tree["is_leaf"][nd.index] = True
                    tree["value"][nd.index] = -self.lr * nd.G / (nd.H + 1e-15)
                    final.append(nd)
            return tree, final

        trees: list[dict] = []
        self.validation_losses_ = [val_loss()] if val.any() else []
        for _ in range(self.iterations):
            prob = torch.sigmoid(raw)
            tree, final = grow(prob - yt, prob * (1 - prob))
            trees.append(tree)
            for leaf in final:
                raw[leaf.rows] += float(tree["value"][leaf.index])
            if val.any():
                one, depth = _stack_trees([tree])
                raw_val += _forest_raw({k: torch.as_tensor(v, device=dev)
                                        for k, v in one.items()}, Xv, depth, 0.0)
                self.validation_losses_.append(val_loss())
                if self._should_stop():
                    break
        stacked, depth = _stack_trees(trees)
        return self._set_trees(stacked, depth, baseline)

    def _should_stop(self) -> bool:
        """No loss of the last ``early_stopping`` iterations is better, by more
        than ``TOL``, than the one before them."""
        ref = self.early_stopping + 1
        losses = self.validation_losses_
        if len(losses) < ref:
            return False
        return not any(loss < losses[-ref] - TOL for loss in losses[-ref + 1:])

    # -- inference ----------------------------------------------------------------

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        if self._forest is None:
            raise RuntimeError("GBDTRanker is not fitted")
        Xt = torch.as_tensor(np.asarray(X, np.float64), device=self.device)
        if Xt.dim() != 2:
            raise ValueError(f"X: want (n, F) rows, got {tuple(Xt.shape)}")
        raw = _forest_raw(self._forest, Xt, self.max_depth_, self.baseline)
        return torch.sigmoid(raw).cpu().numpy()

    def auc(self, X: np.ndarray, y: np.ndarray) -> float:
        return auc_score(y, self.predict_proba(X))

    def save(self, path: str) -> None:
        """The tree arrays as one ``.npz`` archive (no pickled objects)."""
        with open(path, "wb") as f:
            np.savez(f, format=np.array(GBDT_FORMAT), depth=np.array(self.max_depth_),
                     baseline=np.array(self.baseline),
                     settings=np.array([self.iterations, self.lr, self.depth,
                                        self.early_stopping, self.seed], np.float64),
                     **self.trees)

    @classmethod
    def load(cls, path: str, device: torch.device | str = "cuda") -> "GBDTRanker":
        try:
            with np.load(path, allow_pickle=False) as z:
                if str(z["format"]) != GBDT_FORMAT:
                    raise ValueError(f"format {z['format']!r}")
                arrays = {k: z[k] for k in FOREST_KEYS}
                depth, baseline = int(z["depth"]), float(z["baseline"])
                it, lr, dp, es, seed = z["settings"].tolist()
        except (ValueError, KeyError) as e:
            raise ValueError(
                f"{path} is not a GBDTRanker file of this package ({e}). A model that "
                "scikit-learn pickled (the JAX package's GBDTRanker.save) can only be "
                "read with scikit-learn: unpickle it there and convert it with "
                "recsys_tpu_torch.bridge.gbdt_from_sklearn, or fit again here.") from e
        obj = cls(int(it), lr, int(dp), int(es), int(seed), device)
        return obj._set_trees(arrays, depth, baseline)


# -- neural rerankers ----------------------------------------------------------------

def _new_model(build: Callable[[], torch.nn.Module], device: torch.device, seed: int,
               init_state: Mapping[str, torch.Tensor] | None) -> torch.nn.Module:
    """A model with the JAX trainers' init for ``seed`` (``model.init(PRNGKey(
    seed))``, not jitted), or with ``init_state`` loaded. It stays in eval
    mode: the JAX trainers call ``model.apply`` without ``deterministic``,
    whose default is True, so dropout is never on in training either, and the
    port trains the same function (and its step draws no random numbers)."""
    model = flax_init.build(build, None if init_state is not None else flax_init.key(seed),
                            jitted=False)
    if init_state is not None:
        model.load_state_dict(init_state, strict=True)
    return model.to(device).eval()


def _parts(parts, device) -> dict:
    """The feature parts as device data: ``x0``, ``x1``, ... in order."""
    return {f"x{j}": torch.as_tensor(x, device=device) for j, x in enumerate(parts)}


def neural_runner(model, data: dict, sizes: dict, gather: dict, lr: float, loss_fn,
                  capture: bool | None = None) -> StepGraph:
    """The neural rerankers' step through a ``StepGraph``: ``loss_fn(batch)``
    of the batch that the index vectors (a dict of the lengths ``sizes``;
    ``gather`` names each data key's vector) gather from ``data`` (device
    tensors), its backward and one Adam update (``device_adam``). On the card
    one CUDA graph replay a step after the warm-up, as the JAX step is one
    jitted program (``capture=False``: eagerly). The state is ``.state``."""
    state = TrainState(model, device_adam(model, lr))

    def step(batch: dict, generator):
        loss = loss_fn(batch)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    return StepGraph(step, state, data, sizes, None, gather=gather, capture=capture)


def bce_loss(apply_fn, n_parts: int):
    """Mean BCE-with-logits of ``apply_fn(parts)`` against the batch's labels;
    the parts are the batch's ``x0``, ``x1``, ..."""
    def loss_fn(batch):
        parts = tuple(batch[f"x{j}"] for j in range(n_parts))
        return F.binary_cross_entropy_with_logits(apply_fn(parts), batch["label"])

    return loss_fn


def _fit_batches(runner: StepGraph, cfg: Config, batches, device) -> TrainState:
    """One step of ``runner`` per batch of ``batches()`` (a dict of index
    vectors) for every epoch; ``state.losses`` holds each epoch's mean loss."""
    state = runner.state
    timer = StepTimer(device)
    for _ in range(cfg.reranker.epochs):
        losses = []
        for idx in batches():
            losses.append(runner(idx))
            timer.mark()
        if losses:
            state.losses.append(float(torch.stack(losses).mean()))
    state.step_seconds = timer.seconds()
    state.graph_replays = runner.replays
    return state


def _train_neural(model, X_parts, y, cfg: Config, apply_fn, device,
                  capture: bool | None = None) -> TrainState:
    """Mean BCE-with-logits over shuffled batches. The batch order is numpy's
    (``default_rng(0)``, the ragged tail dropped), as in the JAX package, so
    both frameworks see the same batches. The parts and the labels live on
    the device; a step gathers its rows."""
    n = len(y)
    bs = min(cfg.reranker.batch_size, n)
    rng = np.random.default_rng(0)
    data = {**_parts(X_parts, device),
            "label": torch.as_tensor(np.asarray(y, np.float32), device=device)}

    def batches():
        order = rng.permutation(n)
        for s in range(0, n - n % bs, bs):
            yield {"rows": order[s:s + bs]}

    runner = neural_runner(model, data, {"rows": bs}, dict.fromkeys(data, "rows"),
                           cfg.reranker.lr, bce_loss(apply_fn, len(X_parts)), capture)
    return _fit_batches(runner, cfg, batches, device)


def _train_neural_pairwise(model, X_parts, y, groups, cfg: Config, apply_fn,
                           device, capture: bool | None = None) -> TrainState:
    """Group-wise pairwise ranking (softplus(neg - pos) within each group).

    The importers (``import_interactions*``) emit 1 positive + ``neg_per_pos``
    negatives per group — fixed group size S, so a batch of G groups is a
    (G*S,) row block reshaped to (G, S). A batch is its rows and its groups'
    ids, which gather the (G, S) positive mask on the device."""
    order = np.argsort(groups, kind="stable")
    _, counts = np.unique(groups[order], return_counts=True)
    S = int(counts[0])
    if not (counts == S).all():
        raise ValueError("pairwise loss needs constant group size")
    idx_mat = order.reshape(-1, S)
    pos_mask = (np.asarray(y)[order].reshape(-1, S) == 1)
    G = idx_mat.shape[0]
    gb = max(1, min(cfg.reranker.batch_size // S, G))
    rng = np.random.default_rng(0)
    data = {**_parts(X_parts, device), "pos_mask": torch.as_tensor(pos_mask, device=device)}
    gather = {**dict.fromkeys(data, "rows"), "pos_mask": "groups"}

    def batches():
        gorder = rng.permutation(G)
        for s in range(0, G - G % gb, gb):
            picked = gorder[s:s + gb]
            yield {"rows": idx_mat[picked].reshape(-1), "groups": picked}

    def loss_fn(batch):
        pos_m = batch["pos_mask"]
        parts = tuple(batch[f"x{j}"] for j in range(len(X_parts)))
        logits = apply_fn(parts).reshape(pos_m.shape)
        pos = torch.where(pos_m, logits, 0.0).sum(dim=1, keepdim=True)
        pair = F.softplus(logits - pos)
        return torch.where(pos_m, 0.0, pair).sum() / (~pos_m).sum().clamp(min=1)

    runner = neural_runner(model, data, {"rows": gb * S, "groups": gb}, gather,
                           cfg.reranker.lr, loss_fn, capture)
    return _fit_batches(runner, cfg, batches, device)


def train_dcn(cfg: Config, X: np.ndarray, y: np.ndarray,
              groups: np.ndarray | None = None, device: torch.device | str = "cuda",
              init_state: Mapping[str, torch.Tensor] | None = None, seed: int = 0, *,
              capture: bool | None = None):
    """Train ``DCNRanker`` on dense rows; returns ``(state, model, scorer)``
    with ``scorer(X) -> probabilities`` (numpy). On the card each step is a
    CUDA graph replay after the warm-up (``capture=False``: eagerly);
    ``state.graph_replays`` counts them."""
    device = resolve_device(device)
    # standardize on train stats — CrossNet is ill-conditioned on raw
    # mixed-scale features (dot products next to log prices)
    mu = X.mean(axis=0, keepdims=True)
    sd = X.std(axis=0, keepdims=True) + 1e-6
    Xs = ((X - mu) / sd).astype(np.float32)
    model = _new_model(lambda: DCNRanker(X.shape[1], cfg.reranker), device, seed, init_state)
    if cfg.reranker.loss == "pairwise" and groups is not None:
        state = _train_neural_pairwise(model, (Xs,), y, groups, cfg,
                                       lambda b: model(b[0]), device, capture)
    else:
        state = _train_neural(model, (Xs,), y, cfg, lambda b: model(b[0]), device, capture)

    @torch.no_grad()
    def scorer(Xq):
        Xq = ((np.asarray(Xq) - mu) / sd).astype(np.float32)
        return torch.sigmoid(model(torch.as_tensor(Xq, device=device))).cpu().numpy()

    return state, model, scorer


def train_deepfm(cfg: Config, ids: np.ndarray, dense: np.ndarray | None,
                 y: np.ndarray, field_sizes: tuple[int, ...],
                 device: torch.device | str = "cuda",
                 init_state: Mapping[str, torch.Tensor] | None = None, seed: int = 0, *,
                 capture: bool | None = None):
    """Train ``DeepFM`` on sparse ids (+ optional dense rows); returns
    ``(state, model, scorer)`` with ``scorer(ids, dense) -> probabilities``.
    On the card each step is a CUDA graph replay after the warm-up, with the
    FM kernel's forward and backward inside (``capture=False``: eagerly).
    The scorer takes all its rows in one forward (one FM launch on the card)."""
    device = resolve_device(device)
    num_dense = 0 if dense is None else dense.shape[1]
    model = _new_model(lambda: DeepFM(field_sizes, cfg.reranker, num_dense=num_dense),
                       device, seed, init_state)
    parts = (ids,) if dense is None else (ids, np.asarray(dense, np.float32))
    state = _train_neural(model, parts, y, cfg, lambda b: model(*b), device, capture)

    @torch.no_grad()
    def scorer(i, d=None):
        args = [torch.as_tensor(np.asarray(i), device=device)]
        if num_dense:
            args.append(torch.as_tensor(np.asarray(d, np.float32), device=device))
        return torch.sigmoid(model(*args)).cpu().numpy()

    return state, model, scorer


@dataclass
class ReRankingSystem:
    """Retrieve top-``retrieve_k`` by dot product, rerank, return top-``final_k``."""

    item_matrix: np.ndarray            # (N+1, D)
    item_meta: np.ndarray              # (N+1, 2) [pop, price]
    scorer: object                     # callable(features (B,F)) -> proba
    retrieve_k: int = 100
    final_k: int = 10
    device: torch.device | str = "cuda"
    _items: torch.Tensor = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._items = torch.as_tensor(self.item_matrix, device=self.device)

    def recommend(self, user_vec: np.ndarray, user_meta: np.ndarray):
        _, idx = topk_scores(torch.as_tensor(user_vec[None], device=self.device),
                             self._items, self.retrieve_k)
        idx = idx[0].cpu().numpy()
        cand_vecs = self.item_matrix[idx]
        feats = build_rank_features(
            np.repeat(user_vec[None], len(idx), 0), cand_vecs,
            np.repeat(user_meta[None], len(idx), 0), self.item_meta[idx])
        proba = np.asarray(self.scorer(feats))
        order = np.argsort(-proba)[: self.final_k]
        return idx[order], proba[order]
