"""LightGCL and the distillation student of the port against the JAX
package, with the JAX parameters carried across by the bridge.

Everything here is fp32 on both sides at a small size (40 + 30 nodes, dim 16):
the two frameworks round sums differently, so values and gradients are held
to atol 1e-5, the JAX suite's bound for the propagation math
(tests/test_gnn.py). The JAX model runs its plain segment_sum propagation.
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
from recsys_tpu_torch.bridge import flax_to_torch, load_flax_params, torch_to_flax
from recsys_tpu_torch.ops.spmm import csr_graph, spmm

ATOL = 1e-5
CFG = GNNConfig(emb_dim=16, num_layers=2, svd_rank=4)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    nu, ni = 40, 30
    edges = np.array([(u, i) for u in range(nu)
                      for i in rng.choice(15, size=6, replace=False) + (0 if u < 20 else 15)])
    graph = build_graph(edges[:, 0], edges[:, 1], nu, ni, svd_rank=4, pad_multiple=64)
    jmodel = JL.LightGCL(nu, ni, CFG)
    jargs = ((jnp.asarray(graph.src), jnp.asarray(graph.dst), jnp.asarray(graph.weight)),
             jnp.asarray(graph.svd_u), jnp.asarray(graph.svd_s), jnp.asarray(graph.svd_v))
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(3), *jargs)["params"])
    tmodel = load_flax_params(TL.LightGCL(nu, ni, CFG), params)
    targs = ((torch.as_tensor(graph.src), torch.as_tensor(graph.dst),
              torch.as_tensor(graph.weight)),
             torch.as_tensor(graph.svd_u), torch.as_tensor(graph.svd_s),
             torch.as_tensor(graph.svd_v))
    # a batch with duplicate users and duplicate positives
    users = np.array([0, 1, 2, 2, 5, 7, 7, 7, 21, 30, 30, 39], np.int32)
    pos = np.array([3, 3, 4, 4, 9, 1, 2, 2, 20, 25, 25, 29], np.int32)
    neg = rng.integers(0, ni, len(users)).astype(np.int32)
    return {"graph": graph, "jmodel": jmodel, "tmodel": tmodel, "params": params,
            "jargs": jargs, "targs": targs, "batch": (users, pos, neg)}


def _close(got, ref, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=0)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_xavier_init_has_the_flax_scale():
    torch.manual_seed(0)
    m = TL.LightGCL(400, 300, GNNConfig(emb_dim=64))
    for table, rows in ((m.user_emb, 400), (m.item_emb, 300)):
        # the limit as the float32 table holds it: xavier_uniform_ may draw
        # the float64 limit rounded up to float32
        limit = np.sqrt(6.0 / (rows + 64))
        assert table.detach().abs().max().item() <= np.float32(limit)
        assert float(table.detach().std()) == pytest.approx(limit / np.sqrt(3.0), rel=0.05)


@pytest.mark.parametrize("k", range(4), ids=["local_u", "local_i", "global_u", "global_i"])
def test_forward_outputs_match(setup, k):
    ref = setup["jmodel"].apply({"params": setup["params"]}, *setup["jargs"])
    got = setup["tmodel"](*setup["targs"])
    assert got[k].shape == ref[k].shape
    _close(got[k], ref[k])


def test_forward_through_the_spmm_prop_fn_matches(setup):
    """The trainer's other backend: ``prop_fn = spmm`` over the CSR layout
    (its plain form on the CPU) gives the same four outputs."""
    g = setup["graph"]
    model = load_flax_params(TL.LightGCL(g.num_users, g.num_items, CFG, prop_fn=spmm),
                             setup["params"])
    layout = csr_graph(g.src, g.dst, g.weight, g.num_nodes, device="cpu")
    ref = setup["jmodel"].apply({"params": setup["params"]}, *setup["jargs"])
    for got, want in zip(model(layout, *setup["targs"][1:]), ref):
        _close(got, want)


def test_losses_match(setup):
    users, pos, neg = setup["batch"]
    lu, li, gu, gi = setup["jmodel"].apply({"params": setup["params"]}, *setup["jargs"])
    tlu, tli, tgu, tgi = setup["tmodel"](*setup["targs"])
    tu, tp, tn = _t(users), _t(pos), _t(neg)
    _close(TL.bpr_loss(tlu, tli, tu, tp, tn), JL.bpr_loss(lu, li, users, pos, neg))
    for ids, tids, a, b, ta, tb in ((users, tu, lu, gu, tlu, tgu), (pos, tp, li, gi, tli, tgi)):
        assert len(np.unique(ids)) < len(ids)            # duplicates are in the batch
        _close(TL.ssl_loss(ta, tb, tids, 0.2, 100.0), JL.ssl_loss(a, b, ids, 0.2, 100.0))
        _close(TL.ssl_loss(ta, tb, tids, 0.01, 5.0), JL.ssl_loss(a, b, ids, 0.01, 5.0))
    _close(TL.reg_loss(setup["tmodel"], tu, tp, tn),
           JL.reg_loss(setup["params"], users, pos, neg))


def _jax_total(setup):
    users, pos, neg = setup["batch"]

    def loss_fn(params):
        lu, li, gu, gi = setup["jmodel"].apply({"params": params}, *setup["jargs"])
        return (JL.bpr_loss(lu, li, users, pos, neg)
                + 0.01 * (JL.ssl_loss(lu, gu, users, 0.2) + JL.ssl_loss(li, gi, pos, 0.2))
                + 1e-5 * JL.reg_loss(params, users, pos, neg))

    return jax.value_and_grad(loss_fn)(setup["params"])


@pytest.mark.parametrize("backend", ["propagate", "spmm"])
def test_total_loss_gradients_match(setup, backend):
    users, pos, neg = (_t(a) for a in setup["batch"])
    g = setup["graph"]
    if backend == "spmm":
        model = load_flax_params(TL.LightGCL(g.num_users, g.num_items, CFG, prop_fn=spmm),
                                 setup["params"])
        args = (csr_graph(g.src, g.dst, g.weight, g.num_nodes, device="cpu"), *setup["targs"][1:])
    else:
        model, args = setup["tmodel"], setup["targs"]
    lu, li, gu, gi = model(*args)
    total = (TL.bpr_loss(lu, li, users, pos, neg)
             + 0.01 * (TL.ssl_loss(lu, gu, users, 0.2) + TL.ssl_loss(li, gi, pos, 0.2))
             + 1e-5 * TL.reg_loss(model, users, pos, neg))
    grads = torch.autograd.grad(total, (model.user_emb, model.item_emb))
    ref_loss, ref_grads = _jax_total(setup)
    _close(total, ref_loss)
    _close(grads[0], ref_grads["user_emb"])
    _close(grads[1], ref_grads["item_emb"])
    assert float(grads[0].abs().max()) > 1e-4            # not a comparison of zeros


@pytest.fixture(scope="module")
def student():
    jm = JL.MagnitudeEncoder(16, 32, 16)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 16)))["params"])
    # flax starts biases at 0: move them so that a dropped bias would show
    rng = np.random.default_rng(2)
    for name in ("Dense_0", "Dense_1"):
        params[name]["bias"] = rng.normal(0, 0.1, params[name]["bias"].shape).astype(np.float32)
    tm = load_flax_params(TL.MagnitudeEncoder(16, 32, 16), params)
    x = (3.0 * rng.normal(size=(24, 16))).astype(np.float32)   # |x| up to ~9: erf vs tanh differ
    return jm, params, tm, x


def test_magnitude_encoder_matches(student):
    """Also catches an erf GELU: at these activations the two forms differ
    by up to ~5e-4 before the second layer."""
    jm, params, tm, x = student
    ref_out, ref_scale = jm.apply({"params": params}, jnp.asarray(x))
    out, scale = tm(_t(x))
    _close(out, ref_out)
    _close(scale, ref_scale)
    assert float(scale.detach()) == pytest.approx(np.log(10.0))
    erf = torch.nn.functional.normalize(
        tm.Dense_1(torch.nn.functional.gelu(tm.Dense_0(_t(x)))), dim=-1)
    assert float((erf - out).detach().abs().max()) > 10 * ATOL   # the test can tell them apart


def test_magnitude_encoder_fresh_init():
    m = TL.MagnitudeEncoder(64, 128, 64)
    assert float(m.logit_scale.detach()) == pytest.approx(np.log(10.0))
    assert float(m.Dense_0.bias.detach().abs().max()) == 0.0
    assert float(m.Dense_0.weight.detach().std()) == pytest.approx(1 / np.sqrt(64), rel=0.1)
    assert m.Dense_0.weight.dtype == torch.float32


def test_distill_loss_and_its_gradients_match(student):
    jm, params, tm, x = student
    uu, ii = x[:10], x[10:]

    def loss_fn(p):
        su, scale = jm.apply({"params": p}, jnp.asarray(uu))
        si, _ = jm.apply({"params": p}, jnp.asarray(ii))
        return JL.distill_loss(su, si, scale, jnp.asarray(uu), jnp.asarray(ii))

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(params)
    su, scale = tm(_t(uu))
    si, _ = tm(_t(ii))
    loss = TL.distill_loss(su, si, scale, _t(uu), _t(ii))
    # teacher dots reach ~|x|^2 = 100s, so the loss is ~1e3: relative 1e-5
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    loss.backward()
    got = flax_to_torch(jax.device_get(ref_grads))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), got[name].numpy(),
                                   atol=ATOL * max(1.0, float(got[name].abs().max())),
                                   rtol=0, err_msg=name)


def test_bridge_round_trips(setup, student):
    back = torch_to_flax(setup["tmodel"])
    assert set(back) == {"user_emb", "item_emb"}
    for k in back:                                        # tables do not transpose
        np.testing.assert_array_equal(back[k], setup["params"][k])
    _, params, tm, _ = student
    back = torch_to_flax(tm)
    assert set(back) == {"Dense_0", "Dense_1", "logit_scale"}
    for name in ("Dense_0", "Dense_1"):                   # Dense kernels do
        assert back[name]["kernel"].shape == params[name]["kernel"].shape
        np.testing.assert_array_equal(back[name]["kernel"], params[name]["kernel"])
        np.testing.assert_array_equal(back[name]["bias"], params[name]["bias"])
    np.testing.assert_array_equal(back["logit_scale"], params["logit_scale"])
    sd = flax_to_torch(back)
    for k, v in tm.state_dict().items():
        assert torch.equal(sd[k], v), k
