"""The IVF index (``ops/ivf.py``) against the JAX package's, on the CPU, and
the JAX file's invariants (``tests/test_ivf.py``) mirrored on the port.

The same numpy inputs, made from a seed, go through ``recsys_tpu.ops.ivf``
and ``recsys_tpu_torch.ops.ivf``. Tolerances: k-means centroids 1e-5 (the
same draws and assignments; the sums in numpy); bucket ids exactly (the same
greedy fill over the same choice ranks); search ids exactly and values
within 1e-5 (a dot product of unit rows summed in another order), with the
JAX ids' tie order and -inf padding where fewer than k items are probed.
The parity cases use clustered data: in one tight cluster every centroid
scores a point within a few ulps of the others, and the two products'
rounding picks different buckets (the spill invariant is held on the port
alone there).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from recsys_tpu.ops import ivf as JI
from recsys_tpu_torch.bridge import ivf_from_jax
from recsys_tpu_torch.ops import ivf as TI


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers on few cores: torch's default of one
    thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _clustered_catalog(rng, n_clusters=8, per=40, dim=16):
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
    rows = [c + 0.05 * rng.normal(size=(per, dim)).astype(np.float32) for c in centers]
    mat = np.concatenate([np.zeros((1, dim), np.float32), np.concatenate(rows)])
    return mat, centers


def _exact(mat, q):
    items = mat / np.clip(np.linalg.norm(mat, axis=-1, keepdims=True), 1e-12, None)
    scores = (q / np.linalg.norm(q, axis=-1, keepdims=True)) @ items.T
    scores[:, 0] = -np.inf
    return scores


@pytest.fixture(scope="module")
def built():
    """A clustered catalog with ten duplicated rows, both packages' indexes
    built from it with a tight capacity (spills), and queries (three of them
    catalog rows)."""
    rng = np.random.default_rng(0)
    mat, _ = _clustered_catalog(rng)
    mat[100:110] = mat[90:100]
    kw = dict(nlist=8, iters=5, seed=0, balance=1.1)
    q = rng.normal(size=(12, mat.shape[1])).astype(np.float32)
    q[:3] = mat[91:94]
    return mat, q, JI.build_ivf(mat, **kw), TI.build_ivf(mat, **kw, device="cpu")


@pytest.mark.parametrize("nlist,iters,seed", [(8, 5, 0), (4, 10, 1), (16, 3, 2)])
def test_kmeans_matches_jax(nlist, iters, seed):
    mat, _ = _clustered_catalog(np.random.default_rng(seed + 10))
    want = JI.kmeans(mat[1:], nlist, iters=iters, seed=seed)
    got = TI.kmeans(mat[1:], nlist, iters=iters, seed=seed, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_kmeans_reseeds_empty_clusters_as_jax():
    x = np.random.default_rng(4).normal(size=(10, 8)).astype(np.float32)
    got = TI.kmeans(x, nlist=10, iters=3, seed=0, device="cpu")
    assert got.shape == (10, 8) and np.isfinite(got).all()
    np.testing.assert_allclose(got, JI.kmeans(x, nlist=10, iters=3, seed=0), atol=1e-5)


def test_build_matches_jax(built):
    _, _, jix, tix = built
    np.testing.assert_array_equal(tix.bucket_ids.numpy(), np.asarray(jix.bucket_ids))
    np.testing.assert_allclose(tix.centroids.numpy(), np.asarray(jix.centroids), atol=1e-5)
    np.testing.assert_allclose(tix.bucket_vecs.numpy(), np.asarray(jix.bucket_vecs), atol=1e-6)
    assert tix.bucket_ids.dtype == torch.int32 and (tix.nlist, tix.cap) == (8, jix.cap)


@pytest.mark.parametrize("nprobe,k", [(1, 10), (4, 10), (8, 10), (8, 64),
                                      (1, 100), (2, 200)],
                         ids=["p1", "p4", "full", "full_k64", "p1_k_above_probed",
                              "p2_k_above_probed"])
def test_search_matches_jax(built, nprobe, k):
    _, q, jix, tix = built
    jv, ji = JI.ivf_search(jix, jnp.asarray(q), k, nprobe)
    tv, ti = TI.ivf_search(tix, q, k, nprobe)
    jv, tv = np.asarray(jv), tv.numpy()
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(np.isfinite(tv), np.isfinite(jv))
    fin = np.isfinite(jv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=0, atol=1e-5)
    if k > tix.cap * nprobe:             # fewer items probed than k: -inf, id 0
        assert (~np.isfinite(tv)).any() and (ti.numpy()[~np.isfinite(tv)] == 0).all()


def test_index_built_by_jax_searched_in_the_port(built):
    _, q, jix, tix = built
    carried = ivf_from_jax(np.asarray(jix.centroids), np.asarray(jix.bucket_ids),
                           np.asarray(jix.bucket_vecs), device="cpu")
    tv, ti = TI.ivf_search(carried, q, 10, 3)
    jv, ji = JI.ivf_search(jix, jnp.asarray(q), 10, 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    # and the port's arrays in the JAX structure
    back = JI.IvfIndexArrays(jnp.asarray(tix.centroids.numpy()),
                             jnp.asarray(tix.bucket_ids.numpy()),
                             jnp.asarray(tix.bucket_vecs.numpy()))
    np.testing.assert_array_equal(np.asarray(JI.ivf_search(back, jnp.asarray(q), 10, 3)[1]),
                                  TI.ivf_search(tix, q, 10, 3)[1].numpy())


# -- the invariants of tests/test_ivf.py, on the port --------------------------------

def test_build_partitions_catalog_exactly_once():
    mat, _ = _clustered_catalog(np.random.default_rng(0))
    n = mat.shape[0] - 1
    idx = TI.build_ivf(mat, nlist=8, iters=5, seed=0, device="cpu")
    ids = idx.bucket_ids.numpy()
    assert sorted(ids[ids > 0].tolist()) == list(range(1, n + 1))
    assert idx.centroids.shape == (8, mat.shape[1])
    norms = np.linalg.norm(idx.bucket_vecs.numpy(), axis=-1)
    assert np.allclose(norms[ids > 0], 1.0, atol=1e-5)
    assert np.allclose(norms[ids == 0], 0.0)


def test_full_probe_matches_exact_topk():
    rng = np.random.default_rng(1)
    mat, _ = _clustered_catalog(rng, n_clusters=4, per=25)
    idx = TI.build_ivf(mat, nlist=4, iters=5, seed=0, device="cpu")
    q = rng.normal(size=(6, mat.shape[1])).astype(np.float32)
    vals, got = TI.ivf_search(idx, q, 10, idx.nlist)
    scores = _exact(mat, q)
    want = np.argsort(-scores, axis=1)[:, :10]
    np.testing.assert_allclose(vals.numpy(), np.take_along_axis(scores, want, 1), atol=1e-5)
    assert (got.numpy() > 0).all()


def test_low_probe_high_recall_on_clustered_data():
    rng = np.random.default_rng(2)
    mat, centers = _clustered_catalog(rng, n_clusters=8, per=40)
    idx = TI.build_ivf(mat, nlist=8, iters=10, seed=0, device="cpu")
    q = centers + 0.01 * rng.normal(size=centers.shape).astype(np.float32)
    _, got = TI.ivf_search(idx, q, 10, 2)
    want = np.argsort(-_exact(mat, q), axis=1)[:, :10]
    recall = np.mean([len(set(a) & set(b)) / 10.0 for a, b in zip(got.numpy(), want)])
    assert recall > 0.9


def test_capacity_spill_keeps_rectangular_buckets():
    rng = np.random.default_rng(3)
    base = rng.normal(size=(1, 12)).astype(np.float32)
    mat = np.concatenate([np.zeros((1, 12), np.float32),
                          base + 0.01 * rng.normal(size=(64, 12)).astype(np.float32)])
    idx = TI.build_ivf(mat, nlist=4, iters=3, seed=0, balance=1.1, device="cpu")
    ids = idx.bucket_ids.numpy()
    assert sorted(ids[ids > 0].tolist()) == list(range(1, 65))
    assert ids.shape[0] == 4 and (ids > 0).sum(axis=1).max() <= ids.shape[1]


def test_build_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    mat, _ = _clustered_catalog(np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        TI.build_ivf(mat, nlist=4)
