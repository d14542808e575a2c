"""Recommendation recipes for the serving layer: blend and rerank.

Counterpart of ``recsys_tpu/serve/recommend.py``. The HTTP path serves the
measured-best recipes by calling the same functions the offline pipeline
uses (``eval/rerank_eval.py``, the scoring of ``eval/baselines.blend_sweep``),
so the served list is the evaluated list by construction. Three serving modes
(``ServeConfig.mode``, a request's ``?mode=`` wins):

  cosine  - ANN top-k over the item index.
  blend   - full-catalog  (1-a)*minmax(cos) + a*minmax(logq) + b*seen
            with the configured (alpha, beta); the no-ranker recipe.
  rerank  - candidate union (cosine top-M, seen, popularity top-P) ->
            pair features -> GBDT score -> top-k.

``blend_topk`` has a host form (numpy) and a device form: the same scoring in
plain torch on the card over the cached device copy of the matrix, full fp32
matmul (``torch.backends.cuda.matmul.allow_tf32`` is off by default), so
both return the same list where no two scores tie. Among equal scores each
form keeps its JAX twin's order: the host form numpy's (``argpartition``),
the device form ``jax.lax.top_k``'s (lowest index first).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from recsys_tpu_torch.config import Config
from recsys_tpu_torch.device import resolve_device
from recsys_tpu_torch.eval import rerank_eval as R
from recsys_tpu_torch.eval.baselines import popularity_ranking
from recsys_tpu_torch.ops.topk import stable_topk

PAD = 0
_DAY_S = 86400.0


@dataclass
class RecommendAssets:
    """Catalog-aligned artifacts the blend/rerank recipes score with.

    ``item_matrix`` is (N+1, D) with the zero PAD row 0: the matrix the
    offline eval retrieved against (stage 2's trained item matrix or the
    hybrid tower's adapted one). ``item_ids`` excludes the PAD row:
    ``item_ids[r]`` is matrix row ``r + 1``. ``device`` is where the device
    blend keeps its copy of the matrix: the card unless the caller asks for
    the CPU (``"cuda"`` without a card raises where it is resolved).
    """

    item_ids: list[str]
    item_matrix: np.ndarray            # (N+1, D), row 0 = PAD
    logq: np.ndarray                   # (N+1,), PAD row -20
    price_log: np.ndarray              # (N+1,)
    ranker: object | None = None       # GBDTRanker (rerank mode)
    vectors: str = "stage2"            # provenance label
    device: torch.device | str = "cuda"
    _idx: dict = field(default_factory=dict, repr=False)
    _cache: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self._idx = {str(p): r + 1 for r, p in enumerate(self.item_ids)}

    def idx_of(self, pid: str) -> int:
        return self._idx.get(str(pid), PAD)

    def pid_of(self, row: int) -> str | None:
        return self.item_ids[row - 1] if 0 < row <= len(self.item_ids) else None

    # -- request-invariant derived state, computed once per asset load ----

    @property
    def items_norm(self) -> np.ndarray:
        """L2-normalized item matrix (host, cached)."""
        if "items_norm" not in self._cache:
            m = np.array(self.item_matrix, np.float32)
            m /= np.clip(np.linalg.norm(m, axis=-1, keepdims=True), 1e-12, None)
            self._cache["items_norm"] = m
        return self._cache["items_norm"]

    @property
    def pop_norm(self) -> np.ndarray:
        """Min-max normalized log-popularity prior (host, cached)."""
        if "pop_norm" not in self._cache:
            lq = np.asarray(self.logq, np.float64)
            lo, hi = float(lq.min()), float(lq.max())
            self._cache["pop_norm"] = (
                (lq - lo) / (hi - lo) if hi > lo else np.zeros_like(lq)
            ).astype(np.float32)
        return self._cache["pop_norm"]

    def pop_ranking(self, m: int) -> np.ndarray:
        """Global popularity top-m ranking (cached per m)."""
        key = ("pop_ranking", m)
        if key not in self._cache:
            self._cache[key] = popularity_ranking(self.logq, m)
        return self._cache[key]

    def device_state(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(items_norm, pop_norm) on ``device``, cached across requests: the
        device blend's working set."""
        if "device" not in self._cache:
            dev = resolve_device(self.device)
            self._cache["device"] = (torch.as_tensor(self.items_norm, device=dev),
                                     torch.as_tensor(self.pop_norm, device=dev))
        return self._cache["device"]


def load_recommend_assets(cfg: Config, vectors: str = "stage2", require_ranker: bool = False,
                          device: torch.device | str = "cuda") -> RecommendAssets:
    """The serving assets the offline stages wrote to ``data.root``: the item
    matrix and its id sidecar (``eval_item_matrix`` from ``eval``, or
    ``hybrid_item_matrix`` from ``train-hybrid``), the item features ->
    logq / price, and ``rerank_gbdt_{vectors}.pkl`` (``rerank-eval``) when it
    is there. Raises FileNotFoundError without the matrix."""
    import pandas as pd

    from recsys_tpu_torch.data.etl import logq_from_item_features
    from recsys_tpu_torch.train.checkpoint import load_array_with_ids
    from recsys_tpu_torch.train.reranker import GBDTRanker

    root = cfg.data.root
    name = "hybrid_item_matrix" if vectors == "hybrid" else "eval_item_matrix"
    mat, ids, _ = load_array_with_ids(f"{root}/{name}")
    ids = [i for i in ids if i != "<pad>"]
    feats = pd.read_parquet(f"{root}/features_item.parquet").set_index("item_id")
    logq = logq_from_item_features(feats.reset_index(), ids)
    price = np.zeros(len(ids) + 1, np.float32)
    for r, iid in enumerate(ids, start=1):
        if iid in feats.index:
            price[r] = feats.loc[iid, "avg_item_price_log"]
    ranker = None
    try:
        ranker = GBDTRanker.load(f"{root}/rerank_gbdt_{vectors}.pkl", device=device)
    except FileNotFoundError:
        if require_ranker:
            raise
    return RecommendAssets(ids, np.asarray(mat, np.float32), logq, price, ranker, vectors,
                           device)


def store_events_arrays(assets: RecommendAssets, events: list[dict]):
    """One user's store events -> (item_idx, day) arrays in catalog
    indexing. Day = floor(ts / 86400): the serving twin of the transaction
    day the offline pair features use."""
    iidx = np.array([assets.idx_of(e["product_id"]) for e in events], np.int64)
    day = np.array([int(e["ts"] // _DAY_S) for e in events], np.int64)
    keep = iidx != PAD
    return iidx[keep], day[keep]


def blend_topk(assets: RecommendAssets, uvecs: np.ndarray, hists: list[np.ndarray],
               alpha: float, beta: float, k: int, backend: str = "host") -> np.ndarray:
    """(U, k) blended top-k, the scoring of ``eval/baselines.blend_sweep``
    for one (alpha, beta):

        score = (1-alpha) * minmax_u(cos) + alpha * minmax(logq) + beta * seen

    with PAD masked, items L2-normalized. ``backend="device"`` scores on
    ``assets.device`` (``_blend_topk_device``); ``"auto"`` takes it when that
    is a CUDA device. Both return the same list."""
    if backend == "auto":
        backend = "device" if resolve_device(assets.device).type == "cuda" else "host"
    if backend not in ("host", "device"):
        raise ValueError(f"blend backend {backend!r} (want auto|host|device)")
    if backend == "device":
        return _blend_topk_device(assets, uvecs, hists, alpha, beta, k)
    items = assets.items_norm
    pop = assets.pop_norm
    u = np.asarray(uvecs, np.float32)
    cos = u @ items.T
    cos = (cos - cos.min(1, keepdims=True)) / np.clip(
        cos.max(1, keepdims=True) - cos.min(1, keepdims=True), 1e-12, None)
    seen = np.zeros_like(cos)
    for r, h in enumerate(hists):
        seen[r, np.asarray(h, np.int64)] = 1.0
    s = (1 - alpha) * cos + alpha * pop[None, :] + beta * seen
    s[:, PAD] = -np.inf
    k = min(k, s.shape[1] - 1)
    idx = np.argpartition(-s, k, axis=1)[:, :k]
    order = np.take_along_axis(s, idx, 1).argsort(1)[:, ::-1]
    return np.take_along_axis(idx, order, 1)


def _blend_scores(items: torch.Tensor, pop: torch.Tensor, u: torch.Tensor,
                  hist: torch.Tensor, hist_mask: torch.Tensor, alpha: float,
                  beta: float, k: int):
    """normalize -> cosine -> per-row minmax -> popularity prior -> seen
    scatter -> top-k: plain torch, the device form of the host scoring. Equal
    scores come back lowest index first, as the JAX device blend's
    ``jax.lax.top_k`` returns them."""
    cos = u @ items.T
    lo = cos.min(1, keepdim=True).values
    hi = cos.max(1, keepdim=True).values
    cosn = (cos - lo) / (hi - lo).clamp(min=1e-12)
    seen = torch.zeros_like(cosn).scatter_reduce_(1, hist, hist_mask, reduce="amax")
    s = (1 - alpha) * cosn + alpha * pop[None, :] + beta * seen
    s[:, PAD] = -torch.inf
    return stable_topk(s, k)


def _blend_topk_device(assets: RecommendAssets, uvecs, hists, alpha, beta,
                       k: int) -> np.ndarray:
    """Device twin of the host blend scoring. Histories are padded with the
    PAD row (mask 0)."""
    items, pop = assets.device_state()
    k = min(k, items.shape[0] - 1)
    H = max([1, *(len(h) for h in hists)])
    hist = np.zeros((len(hists), H), np.int64)
    mask = np.zeros((len(hists), H), np.float32)
    for r, h in enumerate(hists):
        h = np.asarray(h, np.int64)
        hist[r, :len(h)] = h
        mask[r, :len(h)] = 1.0
    dev = items.device
    _, idx = _blend_scores(items, pop, torch.tensor(np.asarray(uvecs, np.float32), device=dev),
                           torch.as_tensor(hist, device=dev), torch.as_tensor(mask, device=dev),
                           float(alpha), float(beta), k)
    return idx.cpu().numpy()


def rerank_serve_topk(assets: RecommendAssets, uvecs: np.ndarray, event_arrays: list[tuple],
                      now_day: int, k: int, pool_size: int = 512, m_cos: int = 300,
                      m_pop: int = 100) -> np.ndarray:
    """(U, k) reranked top-k: the recipe of ``rerank-eval``'s deployment
    side on store-fed users (candidate union -> pair features -> GBDT ->
    top-k) through the same ``eval/rerank_eval`` functions.
    ``event_arrays[r]`` = (item_idx, day) of user r (``store_events_arrays``)."""
    if assets.ranker is None:
        raise ValueError("rerank mode needs a trained ranker asset "
                         f"(rerank_gbdt_{assets.vectors}.pkl)")
    N1 = assets.item_matrix.shape[0]
    urow = np.concatenate([np.full(len(ii), r, np.int64)
                           for r, (ii, _) in enumerate(event_arrays)]
                          or [np.empty(0, np.int64)])
    iidx = np.concatenate([ii for ii, _ in event_arrays] or [np.empty(0, np.int64)])
    days = np.concatenate([dd for _, dd in event_arrays] or [np.empty(0, np.int64)])
    keys, counts, last = R.pair_index(urow, iidx, days, N1)
    cos_idx = R.cosine_topm(np.asarray(uvecs, np.float32), assets.items_norm,
                            min(m_cos, N1 - 2), device=False, prenormalized=True)
    pop = assets.pop_ranking(min(m_pop, N1 - 2))
    hists = [ii for ii, _ in event_arrays]
    pools, flags = R.build_pools(cos_idx, hists, pop, pool_size)
    hist_lens = np.array([len(ii) for ii, _ in event_arrays], np.int64)
    user_last = np.array([int(dd.max()) if len(dd) else -1 for _, dd in event_arrays],
                         np.int64)
    user_price = np.array([float(assets.price_log[ii].mean()) if len(ii) else 0.0
                           for ii, _ in event_arrays], np.float32)
    feats = R.pool_features(pools, flags, uvecs, assets.items_norm, assets.logq, keys, counts,
                            last, now_day, N1, assets.price_log, hist_lens=hist_lens,
                            user_last_day=user_last, items_prenormalized=True,
                            user_price=user_price)
    return R.rerank_topk(assets.ranker, feats, pools, k)
