"""LightGCL's SSL InfoNCE on the fused contrastive cross entropy (K1's
route, ``models/lightgcl.ssl_loss_fused``) against the JAX package's
``recsys_tpu.models.lightgcl.ssl_loss``, on the CPU.

On CPU tensors the route runs ``DiagCE``'s plain math: the same autograd
function whose CUDA path launches K1's three kernels, with the ids as both
masking ids, no correction, every column valid, the logit clamp, and the
1 / multiplicity weights from two binary searches in the sorted ids. The
inputs are numpy draws from a seed; tolerances are the JAX suite's for the
Pallas kernel (tests/test_pallas.py): loss 1e-4, gradients 1e-5 (abs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recsys_tpu.models.lightgcl as JL
import recsys_tpu_torch.models.lightgcl as TL
from recsys_tpu.config import GNNConfig
from recsys_tpu.ops.graph import build_graph
from recsys_tpu_torch.bridge import load_flax_params

LOSS_TOL, GRAD_TOL = 1e-4, 1e-5
N, D, B = 64, 16, 48     # table rows, width, batch rows


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ids(kind: str, rng) -> np.ndarray:
    if kind == "duplicates":     # a few hot nodes, as a popularity-skewed batch
        return (N * rng.random(B) ** 5).astype(np.int32)
    if kind == "distinct":
        return rng.permutation(N)[:B].astype(np.int32)
    return np.full(B, 7, np.int32)   # one node B times


def _tables(seed: int, *, related: bool):
    """(local, global) (N, D) fp32 views; ``related``: each global row its
    local row plus noise of a scale drawn per row (diagonal logits from near
    the largest down to those of unrelated rows, as in training)."""
    rng = np.random.default_rng(seed)
    local = rng.normal(size=(N, D)).astype(np.float32)
    glob = (local + rng.uniform(0.2, 3.0, (N, 1)) * rng.normal(size=(N, D)) if related
            else rng.normal(size=(N, D))).astype(np.float32)
    return local, glob


def _jax_value_and_grads(local, glob, ids, tau, clamp):
    fn = lambda a, b: JL.ssl_loss(a, b, jnp.asarray(ids), tau, clamp)
    loss, (ga, gb) = jax.value_and_grad(fn, argnums=(0, 1))(jnp.asarray(local),
                                                           jnp.asarray(glob))
    return float(loss), np.asarray(ga), np.asarray(gb)


def _torch_value_and_grads(fn, local, glob, ids, tau, clamp):
    a = torch.as_tensor(local).requires_grad_(True)
    b = torch.as_tensor(glob).requires_grad_(True)
    loss = fn(a, b, torch.as_tensor(ids), tau, clamp)
    ga, gb = torch.autograd.grad(loss, (a, b))
    return float(loss.detach()), ga.numpy(), gb.numpy()


def _held(got, ref):
    assert abs(got[0] - ref[0]) <= LOSS_TOL, (got[0], ref[0])
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g, r, atol=GRAD_TOL, rtol=0)


@pytest.mark.parametrize("kind", ["duplicates", "distinct", "equal"])
def test_routed_ssl_loss_matches_jax(kind):
    """The kernel's route on the CPU (``DiagCE``'s plain path) at the
    default temperature and clamp, with heavy duplicate ids, all ids
    distinct, and one id B times (every off-diagonal entry masked)."""
    rng = np.random.default_rng({"duplicates": 0, "distinct": 1, "equal": 2}[kind])
    local, glob = _tables(3, related=True)
    ids = _ids(kind, rng)
    n_unique = len(np.unique(ids))
    assert {"duplicates": n_unique < B // 2, "distinct": n_unique == B,
            "equal": n_unique == 1}[kind]
    ref = _jax_value_and_grads(local, glob, ids, 0.2, 100.0)
    got = _torch_value_and_grads(TL.ssl_loss_fused, local, glob, ids, 0.2, 100.0)
    _held(got, ref)
    # not a comparison of zeros, but where every other entry is masked: the
    # loss and its gradients are zero there
    assert (np.abs(got[1]).max() == 0.0) == (kind == "equal")


@pytest.mark.parametrize("tau,clamp", [(0.05, 10.0), (0.02, 20.0)])
def test_routed_ssl_loss_matches_jax_where_the_clamp_binds(tau, clamp):
    """A temperature small enough that the clamp cuts part of the logits,
    the diagonal among them: the clipped entries' gradient is zero, as
    ``jnp.clip``'s."""
    local, glob = _tables(4, related=True)
    ids = _ids("duplicates", np.random.default_rng(5))
    unit = lambda x: x / np.linalg.norm(x, axis=1, keepdims=True)
    raw = unit(local[ids]) @ unit(glob[ids]).T / tau
    cut = np.abs(raw) > clamp
    assert 0.02 < cut.mean() < 0.98 and cut.diagonal().any() and not cut.diagonal().all()
    ref = _jax_value_and_grads(local, glob, ids, tau, clamp)
    got = _torch_value_and_grads(TL.ssl_loss_fused, local, glob, ids, tau, clamp)
    _held(got, ref)
    # the plain form, the CPU path of ``ssl_loss``, holds to the same numbers
    _held(_torch_value_and_grads(TL.ssl_loss, local, glob, ids, tau, clamp), ref)


@pytest.mark.parametrize("kind", ["duplicates", "distinct", "equal"])
def test_multiplicity_from_the_sorted_ids_equals_the_same_id_count(kind):
    ids = torch.as_tensor(_ids(kind, np.random.default_rng(6)))
    same = (ids[None, :] == ids[:, None]).sum(-1).float()
    assert torch.equal(TL.id_multiplicity(ids), same)
    assert TL.id_multiplicity(ids.long()).dtype == torch.float32


def test_ssl_loss_takes_the_plain_form_on_the_cpu():
    local, glob = _tables(7, related=False)
    ids = torch.as_tensor(_ids("duplicates", np.random.default_rng(8)))
    a, b = torch.as_tensor(local), torch.as_tensor(glob)
    assert TL.ssl_route("cpu") == "plain" and TL.ssl_route("cuda") == "diag_ce"
    assert torch.equal(TL.ssl_loss(a, b, ids, 0.2), TL.ssl_loss_plain(a, b, ids, 0.2))


@pytest.fixture(scope="module")
def model_setup():
    rng = np.random.default_rng(0)
    nu, ni = 40, 30
    cfg = GNNConfig(emb_dim=D, num_layers=2, svd_rank=4)
    edges = np.array([(u, i) for u in range(nu)
                      for i in rng.choice(15, size=6, replace=False) + (0 if u < 20 else 15)])
    graph = build_graph(edges[:, 0], edges[:, 1], nu, ni, svd_rank=4, pad_multiple=64)
    jmodel = JL.LightGCL(nu, ni, cfg)
    jargs = ((jnp.asarray(graph.src), jnp.asarray(graph.dst), jnp.asarray(graph.weight)),
             jnp.asarray(graph.svd_u), jnp.asarray(graph.svd_s), jnp.asarray(graph.svd_v))
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(3), *jargs)["params"])
    targs = ((torch.as_tensor(graph.src), torch.as_tensor(graph.dst),
              torch.as_tensor(graph.weight)),
             torch.as_tensor(graph.svd_u), torch.as_tensor(graph.svd_s),
             torch.as_tensor(graph.svd_v))
    users = (nu * rng.random(32) ** 2).astype(np.int32)     # duplicate users and items
    pos = (ni * rng.random(32) ** 2).astype(np.int32)
    neg = rng.integers(0, ni, 32).astype(np.int32)
    return {"jmodel": jmodel, "params": params, "jargs": jargs, "targs": targs,
            "nu": nu, "ni": ni, "cfg": cfg, "batch": (users, pos, neg)}


def test_lightgcl_loss_gradients_through_the_routed_ssl_match_jax(model_setup):
    """BPR + both SSL losses (users, positives) through the route + L2 reg,
    as ``train/gnn.make_gnn_step`` sums them, against the JAX loss: the
    gradients of both embedding tables."""
    s = model_setup
    cfg, (users, pos, neg) = s["cfg"], s["batch"]
    assert len(np.unique(users)) < len(users) and len(np.unique(pos)) < len(pos)

    def jax_loss(params):
        lu, li, gu, gi = s["jmodel"].apply({"params": params}, *s["jargs"])
        return (JL.bpr_loss(lu, li, users, pos, neg)
                + cfg.lambda_ssl * (JL.ssl_loss(lu, gu, users, cfg.temperature, cfg.logit_clamp)
                                    + JL.ssl_loss(li, gi, pos, cfg.temperature,
                                                  cfg.logit_clamp))
                + cfg.lambda_reg * JL.reg_loss(params, users, pos, neg))

    ref_loss, ref_grads = jax.value_and_grad(jax_loss)(s["params"])
    model = load_flax_params(TL.LightGCL(s["nu"], s["ni"], cfg), s["params"])
    tu, tp, tn = (torch.as_tensor(a) for a in (users, pos, neg))
    lu, li, gu, gi = model(*s["targs"])
    total = (TL.bpr_loss(lu, li, tu, tp, tn)
             + cfg.lambda_ssl * (TL.ssl_loss_fused(lu, gu, tu, cfg.temperature, cfg.logit_clamp)
                                 + TL.ssl_loss_fused(li, gi, tp, cfg.temperature,
                                                     cfg.logit_clamp))
             + cfg.lambda_reg * TL.reg_loss(model, tu, tp, tn))
    grads = torch.autograd.grad(total, (model.user_emb, model.item_emb))
    assert abs(float(total) - float(ref_loss)) <= LOSS_TOL
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(ref_grads["user_emb"]),
                               atol=GRAD_TOL, rtol=0)
    np.testing.assert_allclose(grads[1].numpy(), np.asarray(ref_grads["item_emb"]),
                               atol=GRAD_TOL, rtol=0)
    assert float(grads[0].abs().max()) > 1e-4
