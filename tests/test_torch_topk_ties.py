"""Equal scores in the port's dense top-k sites come back in the JAX package's
order: largest first, equal values lowest index first, as ``jax.lax.top_k``.
The sites: ``topk_scores`` (dense and on a mesh), the device blend, the blend
sweep, distill's hard-pair mining, ``simcse.topk_items`` and the ring's
sharded top-k.

The item matrix holds each of a few unit directions many times over, so
every score comes in groups of exact ties, and the top-k cuts through such a
group at every k tested. A query's score for a direction is one of its own
coordinates (the directions are basis vectors), so the products are exact in
both frameworks and the distinct values lie 0.1 apart: only the order among
equal values is under test. Each function's index lists must equal its JAX
counterpart's, run on the CPU, and a numpy reference that sorts by (value
descending, index ascending) with ``np.lexsort``; ids exactly, no tolerance.
"""

import numpy as np
import pytest
import torch

from recsys_tpu_torch.config import MeshConfig
from recsys_tpu_torch.eval import baselines as TB
from recsys_tpu_torch.eval import recall as TRc
from recsys_tpu_torch.parallel.mesh import build_mesh
from recsys_tpu_torch.serve import recommend as TRec

N_ITEMS, GROUPS, D, B = 400, 12, 16, 8


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tied():
    """(N+1, D) items (row 0 = PAD, zero), each row one of GROUPS basis
    directions; (B, D) queries whose coordinates are distinct multiples of
    0.1; a log-popularity equal within each direction's group; histories."""
    rng = np.random.default_rng(0)
    group = rng.integers(0, GROUPS, N_ITEMS)
    items = np.zeros((N_ITEMS + 1, D), np.float32)
    items[np.arange(1, N_ITEMS + 1), group] = 1.0
    users = np.stack([rng.permutation(D) for _ in range(B)]).astype(np.float32) * 0.1 - 0.7
    logq = np.concatenate([[-20.0], rng.permutation(GROUPS)[group] * 0.5 - 3.0]).astype(
        np.float32)
    hist = rng.integers(0, N_ITEMS + 1, (B, 5))
    hist[:2, :2] = 0                                          # left padding
    return {"items": items, "users": users, "logq": logq, "hist": hist, "group": group}


def lexsort_topk(scores: np.ndarray, k: int) -> np.ndarray:
    """Top-k ids of each row by (value descending, index ascending)."""
    cols = np.broadcast_to(np.arange(scores.shape[1]), scores.shape)
    return np.lexsort((cols, -scores), axis=1)[:, :k]


def minmax(x: np.ndarray) -> np.ndarray:
    lo, hi = float(x.min()), float(x.max())
    return ((x - lo) / (hi - lo)).astype(np.float32)


def blend_scores(x: dict, alpha: float, beta: float) -> np.ndarray:
    """The blend's scores in float32 numpy (the items are unit rows already)."""
    cos = x["users"] @ x["items"].T
    cos = (cos - cos.min(1, keepdims=True)) / (cos.max(1, keepdims=True)
                                                - cos.min(1, keepdims=True))
    seen = np.zeros_like(cos)
    seen[np.repeat(np.arange(B), x["hist"].shape[1]), x["hist"].reshape(-1)] = 1.0
    s = (np.float32(1 - alpha) * cos + np.float32(alpha) * minmax(x["logq"])[None, :]
         + np.float32(beta) * seen)
    s[:, 0] = -np.inf
    return s


def test_the_inputs_tie_at_every_k(tied):
    scores = tied["users"] @ tied["items"].T
    for k in (5, 60, 150):
        kth, nxt = np.sort(scores[:, 1:], axis=1)[:, ::-1][:, [k - 1, k]].T
        assert (kth == nxt).mean() >= 0.75          # a tie group straddles the boundary


@pytest.mark.parametrize("with_prior", [False, True], ids=["no_prior", "prior"])
@pytest.mark.parametrize("k", [5, 60, 150])
def test_topk_scores_orders_ties_as_jax(tied, k, with_prior):
    import jax.numpy as jnp

    from recsys_tpu.eval.recall import topk_scores as jax_topk_scores

    prior = tied["logq"] * 0.1 if with_prior else None
    ref_vals, ref_idx = jax_topk_scores(
        jnp.asarray(tied["users"]), jnp.asarray(tied["items"]), k,
        prior=None if prior is None else jnp.asarray(prior))
    vals, idx = TRc.topk_scores(torch.tensor(tied["users"]), torch.tensor(tied["items"]), k,
                                prior=None if prior is None else torch.tensor(prior))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))
    scores = tied["users"] @ tied["items"].T + (0 if prior is None else prior[None, :])
    scores[:, 0] = -np.inf
    np.testing.assert_array_equal(idx.numpy(), lexsort_topk(scores, k))


@pytest.mark.parametrize("k", [5, 60, 150])
def test_topk_scores_mesh_branch_orders_ties_as_one_device(tied, k):
    """The row-sharded branch (8 virtual shards, model axis 4) merges to the
    one-device list, ties included."""
    mesh = build_mesh(MeshConfig(num_data=2, num_model=4), ["cpu"] * 8)
    u, it = torch.tensor(tied["users"]), torch.tensor(np.concatenate(
        [tied["items"], tied["items"][1:4]]))       # 404 rows: divisible by the axis
    _, dense = TRc.topk_scores(u, it, k)
    _, sharded = TRc.topk_scores(u, it, k, mesh=mesh)
    np.testing.assert_array_equal(sharded.numpy(), dense.numpy())


@pytest.mark.parametrize("alpha,beta", [(0.0, 0.0), (0.3, 1.0), (1.0, 0.3)])
@pytest.mark.parametrize("k", [5, 60, 150])
def test_device_blend_orders_ties_as_jax(tied, k, alpha, beta):
    from recsys_tpu.serve import recommend as JRec

    ids = [f"p{r}" for r in range(1, N_ITEMS + 1)]
    price = np.zeros(N_ITEMS + 1, np.float32)
    hists = [h[h > 0] for h in tied["hist"]]
    jax_assets = JRec.RecommendAssets(ids, tied["items"], tied["logq"], price)
    assets = TRec.RecommendAssets(ids, tied["items"], tied["logq"], price, device="cpu")
    ref = JRec._blend_topk_device(jax_assets, tied["users"], hists, alpha, beta, k)
    got = TRec._blend_topk_device(assets, tied["users"], hists, alpha, beta, k)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, lexsort_topk(blend_scores(tied, alpha, beta), k))


def _capture_lists(monkeypatch, module) -> list:
    """Record the index lists ``module.blend_sweep`` hands ``recall_at_ks``,
    one a (alpha, beta) combination in the sweep's order."""
    lists, real = [], module.recall_at_ks

    def capture(idx, *args, **kwargs):
        lists.append(np.array(idx))
        return real(idx, *args, **kwargs)

    monkeypatch.setattr(module, "recall_at_ks", capture)
    return lists


def test_blend_sweep_device_orders_ties_as_jax(tied, monkeypatch):
    from recsys_tpu.eval import baselines as JB

    alphas, betas, ks = (0.0, 0.3, 1.0), (0.0, 1.0), (5, 60, 150)
    uids = [f"u{r}" for r in range(B)]
    targets = {u: {int(i) for i in np.flatnonzero(tied["group"] == r % GROUPS)[:3] + 1}
               for r, u in enumerate(uids)}
    args = (tied["users"], tied["items"], tied["logq"], tied["hist"], uids, targets)
    ref_lists = _capture_lists(monkeypatch, JB)
    ref = JB.blend_sweep(*args, ks=ks, alphas=alphas, betas=betas, device=True)
    got_lists = _capture_lists(monkeypatch, TB)
    got = TB.blend_sweep(*args, ks=ks, alphas=alphas, betas=betas, device="cpu")
    assert len(got_lists) == len(ref_lists) == len(alphas) * len(betas)
    for (alpha, beta), g, r in zip([(a, b) for a in alphas for b in betas],
                                   got_lists, ref_lists):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, lexsort_topk(blend_scores(tied, alpha, beta), 150))
    assert got["table"] == ref["table"] and got["best"] == ref["best"]


@pytest.mark.parametrize("k", [5, 60, 150])
def test_distill_mining_orders_ties_as_jax(tied, k):
    """Distill's mining (the JAX package's ``mine``: ``jax.lax.top_k`` of the
    teacher's dot scores) on tied scores: the same (B, k) indices, so the
    same pool after ``np.unique``."""
    import jax
    import jax.numpy as jnp

    from recsys_tpu_torch.train.gnn import mine_hard_items

    users, items = tied["users"], tied["items"][1:]
    _, ref = jax.lax.top_k(jnp.asarray(users) @ jnp.asarray(items).T, k)
    got = mine_hard_items(torch.tensor(users), torch.tensor(items), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(got, lexsort_topk(users @ items.T, k))
    np.testing.assert_array_equal(np.unique(got), np.unique(np.asarray(ref)))


@pytest.mark.parametrize("k", [5, 60, 150])
def test_simcse_topk_items_orders_ties_as_jax(tied, k):
    from recsys_tpu.train.simcse import topk_items as jax_topk_items
    from recsys_tpu_torch.train.simcse import topk_items

    ref_vals, ref_idx = jax_topk_items(tied["items"], tied["users"], k)
    vals, idx = topk_items(tied["items"], tied["users"], k, device="cpu")
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(vals, ref_vals)
    scores = tied["users"] @ tied["items"].T
    scores[:, 0] = -np.inf
    np.testing.assert_array_equal(idx, lexsort_topk(scores, k))


@pytest.mark.parametrize("bidirectional", [False, True], ids=["one_way", "both_ways"])
def test_ring_sharded_topk_orders_ties_as_jax(tied, bidirectional):
    """The ring's sharded top-k over 4 column shards of the tied scores, the
    JAX package's run through its Pallas ring under the TPU interpreter on 4
    devices of the CPU mesh (as tests/test_torch_ring.py runs it): every
    shard's indices equal JAX's, ties cut at the k-th place and across
    shards."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from recsys_tpu.config import MeshConfig
    from recsys_tpu.parallel import pallas_ring as JR
    from recsys_tpu.parallel.mesh import build_mesh, smap
    from recsys_tpu_torch.parallel import ring as TR

    k, S = 60, 4
    scores = tied["users"] @ tied["items"][1:].T                 # (B, 400): 100 a shard
    mesh = build_mesh(MeshConfig(num_data=S, num_model=1), jax.devices()[:S])
    f = smap(lambda s: JR.ring_sharded_topk(s, k, "data", bidirectional=bidirectional),
             mesh, P(None, "data"), out_specs=(P(None, None), P(None, None)))
    ref_vals, ref_idx = (np.asarray(a) for a in f(jnp.asarray(scores)))
    out = TR.ring_sharded_topk(list(torch.tensor(scores).chunk(S, dim=1)), k, bidirectional)
    assert len(out) == S
    for vals, idx in out:
        np.testing.assert_array_equal(idx.numpy(), ref_idx)
        np.testing.assert_array_equal(vals.numpy(), ref_vals)
        np.testing.assert_array_equal(idx.numpy(), lexsort_topk(scores, k))
