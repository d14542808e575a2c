"""The port's sharded retrieval and edge-sharded propagation against the JAX
package's, on the CPU.

The JAX functions run on the 4 x 2 virtual CPU mesh of ``tests/conftest.py``;
the port's on eight virtual shards laid over ``"cpu"``. Scores are continuous
random numbers (no ties), so top-k indices are held equal and values at rtol
1e-6. The propagation is held at the tolerances of
``tests/test_parallel.py``: forward rtol 1e-5 / atol 1e-6, gradient rtol 1e-4
/ atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.eval.recall import topk_scores as jax_topk_scores
from recsys_tpu.ops import graph as JG
from recsys_tpu_torch.config import GNNConfig, MeshConfig
from recsys_tpu_torch.eval import gnn_eval as TE
from recsys_tpu_torch.eval import recall as TRc
from recsys_tpu_torch.ops import graph as TG
from recsys_tpu_torch.parallel.mesh import build_mesh
from recsys_tpu_torch.train import gnn as TGnn


def torch_mesh(num_data=4, num_model=2):
    return build_mesh(MeshConfig(num_data=num_data, num_model=num_model),
                      ["cpu"] * (num_data * num_model))


def _retrieval_inputs(seed, B=6, N=64, D=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, D)).astype(np.float32),
            rng.normal(size=(N, D)).astype(np.float32),
            (rng.random(N) * 0.5).astype(np.float32))


# -- topk_scores on a mesh -------------------------------------------------

@pytest.mark.parametrize("with_prior", [False, True], ids=["no_prior", "prior"])
@pytest.mark.parametrize("normalize", [True, False], ids=["cos", "dot"])
def test_topk_scores_mesh_matches_jax_and_dense(mesh8, with_prior, normalize):
    u, items, prior = _retrieval_inputs(int(with_prior) + 2 * int(normalize))
    items[0] = 100.0 * u[0]                     # the PAD row would win if it were scored
    prior = prior if with_prior else None
    k = 10
    ref_vals, ref_idx = jax_topk_scores(
        jnp.asarray(u), jnp.asarray(items), k, mesh=mesh8, normalize_items=normalize,
        prior=None if prior is None else jnp.asarray(prior))
    tp = None if prior is None else torch.tensor(prior)
    vals, idx = TRc.topk_scores(torch.tensor(u), torch.tensor(items), k, mesh=torch_mesh(),
                                normalize_items=normalize, prior=tp)
    np.testing.assert_allclose(vals.numpy(), np.asarray(ref_vals), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    dense_vals, dense_idx = TRc.topk_scores(torch.tensor(u), torch.tensor(items), k,
                                            normalize_items=normalize, prior=tp)
    np.testing.assert_allclose(vals.numpy(), dense_vals.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(idx.numpy(), dense_idx.numpy())
    assert int(idx.min()) > 0                   # PAD never returned


@pytest.mark.parametrize("num_model", [2, 4, 8])
def test_sharded_scores_mask_the_pad_row_on_shard_0_only(num_model):
    u, items, prior = _retrieval_inputs(9)
    mesh = torch_mesh(8 // num_model, num_model)
    shards = TRc.sharded_scores(torch.tensor(u), torch.tensor(items), mesh, True,
                                torch.tensor(prior))
    assert len(shards) == num_model
    full = torch.cat(shards, dim=1)
    assert torch.isinf(full[:, 0]).all() and torch.isfinite(full[:, 1:]).all()
    unit = items / np.linalg.norm(items, axis=1, keepdims=True)
    np.testing.assert_allclose(full[:, 1:].numpy(), (u @ unit.T + prior[None])[:, 1:],
                               rtol=1e-5, atol=1e-6)
    # a 1-wide model axis is the dense path: no sharding at all
    vals, idx = TRc.topk_scores(torch.tensor(u), torch.tensor(items), 5,
                                mesh=torch_mesh(8, 1))
    dense = TRc.topk_scores(torch.tensor(u), torch.tensor(items), 5)
    assert torch.equal(idx, dense[1]) and torch.equal(vals, dense[0])
    with pytest.raises(ValueError, match="cannot shard"):
        TRc.topk_scores(torch.tensor(u), torch.tensor(items[:63]), 5, mesh=torch_mesh())


def test_evaluate_retrieval_and_topk_rows_with_a_mesh():
    """The eval entry points hand the mesh through: the same rows as without
    one. ``topk_rows`` pads a catalog that does not divide (21 items + PAD over
    4 shards) and keeps the pads out."""
    rng = np.random.default_rng(11)
    users = rng.normal(size=(9, 8)).astype(np.float32)
    items = rng.normal(size=(21, 8)).astype(np.float32)
    mesh = torch_mesh(2, 4)
    for normalize in (False, True):
        ref = TE.topk_rows(users, items, 21, normalize, device="cpu")
        got = TE.topk_rows(users, items, 21, normalize, device="cpu", mesh=mesh)
        np.testing.assert_array_equal(got, ref)
        assert got.min() >= 1 and got.max() <= 21
    padded = torch.tensor(np.concatenate([np.zeros((1, 8), np.float32), items,
                                          np.zeros((2, 8), np.float32)]))
    targets = {f"u{r}": {int(r % 21) + 1} for r in range(9)}
    batches = [(torch.tensor(users[:5]), [f"u{r}" for r in range(5)]),
               (torch.tensor(users[5:]), [f"u{r}" for r in range(5, 9)])]
    ref = TRc.evaluate_retrieval(lambda b: b, batches, padded[:22], targets, ks=(3, 10))
    prior_free = TRc.evaluate_retrieval(lambda b: b, batches, padded[:22], targets,
                                        ks=(3, 10), mesh=torch_mesh(4, 2))
    assert prior_free == ref and ref["n_eval"] == 9


# -- edge-sharded propagation ------------------------------------------------

def _edges(seed, N, E, D):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, N, E).astype(np.int32), rng.integers(0, N, E).astype(np.int32),
            rng.normal(size=E).astype(np.float32), rng.normal(size=(N, D)).astype(np.float32))


def test_edge_sharded_propagate_matches_jax(mesh8):
    """E = 37 is odd, so the weight-0 pad edges are exercised."""
    N, E, D = 20, 37, 8
    src, dst, w, x = _edges(0, N, E, D)
    jprop, jplace = JG.make_edge_sharded_propagate(mesh8, N, "model")
    ref = np.asarray(jprop(jplace(src, dst, w), jnp.asarray(x)))
    prop_fn, place_edges = TG.make_edge_sharded_propagate(torch_mesh(), N, "model")
    args = place_edges(src, dst, w)
    assert len(args) == 2 and all(len(s) == 19 for s, _, _ in args)
    assert float(args[1][2][-1]) == 0.0 and int(args[1][1][-1]) == 0    # the pad edge
    out = prop_fn(args, torch.tensor(x))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    dense = TG.propagate(torch.tensor(x), torch.tensor(src).long(), torch.tensor(dst).long(),
                         torch.tensor(w), N)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), rtol=1e-5, atol=1e-6)
    # the data axis shards as well (4 shards: 37 -> 40 edges)
    prop4, place4 = TG.make_edge_sharded_propagate(torch_mesh(), N, "data")
    np.testing.assert_allclose(prop4(place4(src, dst, w), torch.tensor(x)).numpy(), ref,
                               rtol=1e-5, atol=1e-6)


def test_edge_sharded_propagate_grad_matches_jax(mesh8):
    N, E, D = 12, 16, 4
    src, dst, w, x = _edges(1, N, E, D)
    jprop, jplace = JG.make_edge_sharded_propagate(mesh8, N, "model")
    jargs = jplace(src, dst, w)
    ref = np.asarray(jax.grad(lambda xx: jnp.sum(jprop(jargs, xx) ** 2))(jnp.asarray(x)))
    prop_fn, place_edges = TG.make_edge_sharded_propagate(torch_mesh(), N, "model")
    xt = torch.tensor(x, requires_grad=True)
    (prop_fn(place_edges(src, dst, w), xt) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_select_propagation_segment_sum_sharded():
    rng = np.random.default_rng(0)
    graph = TG.build_graph(rng.integers(0, 30, 201), rng.integers(0, 20, 201), 30, 20,
                           svd_rank=2, pad_multiple=1)
    cfg = GNNConfig(propagation="segment_sum_sharded")
    with pytest.raises(ValueError, match="needs a mesh"):
        TGnn.select_propagation(cfg, graph, graph.num_nodes, "cpu")
    prop_fn, args = TGnn.select_propagation(cfg, graph, graph.num_nodes, "cpu", torch_mesh())
    assert len(args) == 2                       # the model axis of the 4 x 2 mesh
    x = torch.tensor(rng.normal(size=(graph.num_nodes, 8)).astype(np.float32))
    plain_fn, plain_args = TGnn.select_propagation(GNNConfig(propagation="segment_sum"),
                                                   graph, graph.num_nodes, "cpu")
    np.testing.assert_allclose(prop_fn(args, x).numpy(), plain_fn(plain_args, x).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_lightgcl_step_on_sharded_edges_matches_the_plain_step():
    """One LightGCL step with the edge list over the model axis: the same
    loss and the same updated embeddings as with the plain propagation."""
    from recsys_tpu_torch.models.lightgcl import LightGCL
    from recsys_tpu_torch.train.state import TrainState

    rng = np.random.default_rng(2)
    graph = TG.build_graph(rng.integers(0, 30, 200), rng.integers(0, 20, 200), 30, 20,
                           svd_rank=2, pad_multiple=1)
    batch = [torch.tensor(rng.integers(0, n, 16)) for n in (30, 20, 20)]
    losses, weights = [], []
    for mode, mesh in (("segment_sum", None), ("segment_sum_sharded", torch_mesh())):
        cfg = GNNConfig(emb_dim=8, svd_rank=2, batch_size=16, propagation=mode)
        prop_fn, args = TGnn.select_propagation(cfg, graph, graph.num_nodes, "cpu", mesh)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = LightGCL(30, 20, cfg, prop_fn=prop_fn)
        step = TGnn.make_gnn_step(TrainState(model, TGnn._adam(model, 1e-2)), graph, cfg, args)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(1)
            losses.append(float(step(*batch)["loss"]))
        weights.append([p.detach().clone() for p in model.parameters()])
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    for a, b in zip(*weights):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
