"""The port's contrastive losses against the JAX package's, on the CPU.

The plain PyTorch forms are held against ``recsys_tpu.ops.contrastive``;
the autograd function of kernel K1 (which runs the kernels' plain math on
CPU tensors) against the Pallas kernel run in interpret mode, as
tests/test_pallas.py runs it. Inputs come from one numpy seed, B=200 (not a
tile multiple), D=32. Tolerances are the JAX suite's for the Pallas kernel:
loss 1e-4 abs, grads 1e-5 abs (both sides fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.ops import contrastive as C
from recsys_tpu.ops.pallas_contrastive import (
    fused_bidirectional_infonce as jax_fused_infonce,
    fused_diag_ce as jax_fused_diag_ce,
    fused_inbatch_logq_loss as jax_fused_logq,
)
from recsys_tpu_torch.ops import contrastive as TC
from recsys_tpu_torch.ops import contrastive_kernel as TK

LOSS_TOL, GRAD_TOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers on few cores: torch's default of one
    thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    B, D = 200, 32
    u = rng.normal(size=(B, D)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    it = rng.normal(size=(B, D)).astype(np.float32)
    it /= np.linalg.norm(it, axis=1, keepdims=True)
    return {"u": u, "i": it,
            "pos": rng.integers(1, 50, B).astype(np.int32),
            "uid": rng.integers(0, 60, B).astype(np.int32),
            "logq": rng.uniform(-8, -1, 60).astype(np.float32),
            "valid": (rng.random(B) > 0.1).astype(np.int32),
            "g": rng.normal(size=B).astype(np.float32)}


def _torch_value_and_grads(fn, a, b):
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    loss = fn(ta, tb)
    loss.backward()
    return float(loss.detach()), ta.grad.numpy(), tb.grad.numpy()


def _jax_value_and_grads(fn, a, b):
    val, (ga, gb) = jax.value_and_grad(fn, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    return float(val), np.asarray(ga), np.asarray(gb)


def _assert_close(got, ref):
    assert got[0] == pytest.approx(ref[0], abs=LOSS_TOL)
    np.testing.assert_allclose(got[1], ref[1], atol=GRAD_TOL)
    np.testing.assert_allclose(got[2], ref[2], atol=GRAD_TOL)


def _logq_fns(p, jax_fn, torch_fn):
    jkw = dict(temperature=0.1, user_ids=jnp.asarray(p["uid"]),
               valid=jnp.asarray(p["valid"]))
    tkw = dict(temperature=0.1, user_ids=torch.tensor(p["uid"]),
               valid=torch.tensor(p["valid"]))
    jpos, tpos = jnp.asarray(p["pos"]), torch.tensor(p["pos"]).long()
    return (lambda a, b: jax_fn(a, b, jpos, jnp.asarray(p["logq"]), **jkw),
            lambda a, b: torch_fn(a, b, tpos, torch.tensor(p["logq"]), **tkw))


@pytest.mark.parametrize("torch_fn", [TC.inbatch_logq_loss, TK.fused_inbatch_logq_loss],
                         ids=["plain", "kernel_function"])
def test_logq_loss_matches_jax_xla_form(problem, torch_fn):
    jfn, tfn = _logq_fns(problem, C.inbatch_logq_loss, torch_fn)
    _assert_close(_torch_value_and_grads(tfn, problem["u"], problem["i"]),
                  _jax_value_and_grads(jfn, problem["u"], problem["i"]))


@pytest.mark.parametrize("torch_fn", [TC.inbatch_logq_loss, TK.fused_inbatch_logq_loss],
                         ids=["plain", "kernel_function"])
def test_logq_loss_matches_pallas_interpret(problem, torch_fn):
    jfn, tfn = _logq_fns(problem, jax_fused_logq, torch_fn)
    _assert_close(_torch_value_and_grads(tfn, problem["u"], problem["i"]),
                  _jax_value_and_grads(jfn, problem["u"], problem["i"]))


def test_logq_loss_without_user_ids_or_valid(problem):
    p = problem
    ref = _jax_value_and_grads(
        lambda a, b: C.inbatch_logq_loss(a, b, jnp.asarray(p["pos"]),
                                         jnp.asarray(p["logq"]), temperature=0.1),
        p["u"], p["i"])
    for fn in (TC.inbatch_logq_loss, TK.fused_inbatch_logq_loss):
        got = _torch_value_and_grads(
            lambda a, b: fn(a, b, torch.tensor(p["pos"]).long(),
                            torch.tensor(p["logq"]), temperature=0.1),
            p["u"], p["i"])
        _assert_close(got, ref)


@pytest.mark.parametrize("torch_fn,jax_fn", [
    (TC.bidirectional_infonce, C.bidirectional_infonce),
    (TK.fused_bidirectional_infonce, C.bidirectional_infonce),
    (TK.fused_bidirectional_infonce, jax_fused_infonce),
], ids=["plain_vs_xla", "kernel_function_vs_xla", "kernel_function_vs_pallas"])
def test_infonce_matches_jax(problem, torch_fn, jax_fn):
    _assert_close(
        _torch_value_and_grads(lambda a, b: torch_fn(a, b, 0.08), problem["u"], problem["i"]),
        _jax_value_and_grads(lambda a, b: jax_fn(a, b, 0.08), problem["u"], problem["i"]))


def test_per_row_diag_ce_and_vjp_match_pallas(problem):
    """Per-row losses and the VJP of a random upstream gradient g (so the
    backward sees other than the 1/B of a mean). g ~ N(0, 1), so the grads
    are B times a mean loss's: 1e-4 abs keeps the JAX bound per unit of g."""
    p = problem
    corr = p["logq"][p["pos"]]
    args_np = (corr, p["pos"], p["uid"], p["valid"])
    jargs = tuple(jnp.asarray(a) for a in args_np)
    targs = tuple(torch.tensor(a) for a in args_np)
    g = p["g"]
    ref = _jax_value_and_grads(
        lambda a, b: jnp.sum(jax_fused_diag_ce(a, b, *jargs, 0.1) * g), p["u"], p["i"])
    got = _torch_value_and_grads(
        lambda a, b: (TK.fused_diag_ce(a, b, *targs, 0.1) * torch.tensor(g)).sum(),
        p["u"], p["i"])
    oracle = _torch_value_and_grads(
        lambda a, b: (TK.fused_diag_ce_reference(a, b, *targs, 0.1) * torch.tensor(g)).sum(),
        p["u"], p["i"])
    for x in (got, oracle):
        assert x[0] == pytest.approx(ref[0], abs=1e-3)  # a sum of 200 rows
        np.testing.assert_allclose(x[1], ref[1], atol=1e-4)
        np.testing.assert_allclose(x[2], ref[2], atol=1e-4)


def test_kernel_function_composes_in_a_bigger_loss(problem):
    """The analogue of test_fused_under_jit_and_vjp_composition: the
    autograd function is one term of a larger loss, on the CPU path."""
    p = problem
    jpos, tpos = jnp.asarray(p["pos"]), torch.tensor(p["pos"]).long()

    def jax_composite(q, k):
        a = jax_fused_logq(q, k, jpos, jnp.asarray(p["logq"]), temperature=0.1)
        return a + 0.1 * jnp.sum(q ** 2)

    def torch_composite(q, k):
        a = TK.fused_inbatch_logq_loss(q, k, tpos, torch.tensor(p["logq"]), temperature=0.1)
        return a + 0.1 * (q ** 2).sum()

    got = _torch_value_and_grads(torch_composite, p["u"], p["i"])
    assert np.isfinite(got[0]) and np.isfinite(got[1]).all() and np.isfinite(got[2]).all()
    _assert_close(got, _jax_value_and_grads(jax.jit(jax_composite), p["u"], p["i"]))
    # no kernel launched: every tensor was on the CPU
    assert TK.LAUNCHES == {"diag_ce_fwd": 0, "diag_ce_bwd_dq": 0, "diag_ce_bwd_dk": 0}


def test_masked_rows_get_no_gradient_from_forbidden_columns(problem):
    """Forbidden logits are constants (-3e4): the backward must not send a
    gradient through them, in the kernel math as in autograd of the plain form."""
    B = 6
    q = torch.eye(B, 8)
    k = torch.eye(B, 8)
    pos = torch.tensor([1, 1, 2, 3, 4, 5], dtype=torch.int32)
    ids = torch.arange(B, dtype=torch.int32)
    valid = torch.ones(B, dtype=torch.int32)
    corr = torch.zeros(B)
    lse = TK.diag_ce_fwd_plain(q, k, corr, pos, ids, valid, 0.1)[1]
    g = torch.ones(B)
    dq = TK.diag_ce_bwd_dq_plain(q, k, corr, pos, ids, valid, lse, g, 0.1)
    # row 0's only other same-item column is 1: k_1 must not move q_0
    assert float(dq[0, 1]) == 0.0
