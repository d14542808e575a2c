"""The stage-2 user tower with ``enable_side_gates=True`` against the JAX one,
on the CPU: the parameter tree, the forward, and the gradients.

Tolerances: the forward at the user-tower tests' bf16 bound (per-row cosine
>= 0.999, 2e-2 abs; both towers compute in bf16 over fp32 parameters); the
gradients at the JAX suite's kernel tolerance (1e-5 abs) with both towers
computing in fp32, where no bf16 rounding stands between the two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.config import UserTowerConfig as JaxUserTowerConfig
from recsys_tpu.models import layers as JL
from recsys_tpu.models import user_tower as JU
from recsys_tpu_torch.bridge import flax_to_torch, torch_to_flax
from recsys_tpu_torch.config import UserTowerConfig
from recsys_tpu_torch.models import layers as TL
from recsys_tpu_torch.models import user_tower as TU

TOWER = dict(d_model=32, max_len=8, nhead=2, num_layers=1, dropout=0.0)
N, S = 30, 4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tower_inputs(B=6, L=8, seed=0):
    """Left-padded rows of every length from 1 to L, side ids up to 1000."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, L), np.int32)
    for r in range(B):
        mask[r, L - (1 + r * (L - 1) // (B - 1)):] = 1
    return (rng.normal(size=(B, L, TOWER["d_model"])).astype(np.float32),
            rng.integers(1, N, (B, L)).astype(np.int32) * mask,
            rng.integers(0, 10, (B, L)).astype(np.int32) * mask,
            rng.integers(0, 1001, (B, L, S)).astype(np.int32) * mask[..., None],
            mask,
            rng.integers(0, 16, (B, 4)).astype(np.int32),
            rng.integers(0, 8, (B, 5)).astype(np.int32),
            rng.normal(size=(B, 4)).astype(np.float32))


def port_args(args):
    vecs, ids, times, side, mask, buckets, cats, cont = (torch.as_tensor(a) for a in args)
    return ((vecs, ids.long(), times.long(), mask, buckets.long(), cats.long(), cont),
            side.long())


@pytest.fixture(scope="module")
def towers():
    """A JAX tower with side gates, its init bridged into the port's, every
    gate nonzero."""
    jt = JU.SASRecUserTower(JaxUserTowerConfig(**TOWER), num_id_embeddings=N,
                            enable_side_gates=True)
    args = tower_inputs()
    params = dict(jax.device_get(jt.init(jax.random.PRNGKey(3), *args)["params"]))
    rng = np.random.default_rng(4)
    for gate in ("seq_gate", "static_gate"):
        params[gate] = rng.normal(size=params[gate].shape).astype(np.float32)
    tt = TU.SASRecUserTower(UserTowerConfig(**TOWER), num_id_embeddings=N,
                            enable_side_gates=True)
    tt.load_state_dict(flax_to_torch(params), strict=True)
    return jt, params, tt.eval(), args


def test_side_embeddings_exist_only_with_the_flag(towers):
    _, params, tt, _ = towers
    assert {f"side_embedding_{i}" for i in range(S)} <= set(params)
    assert params["side_embedding_0"]["embedding"].shape == (1001, TOWER["d_model"])
    back = torch_to_flax(tt)
    assert set(back) == set(params)
    for i in range(S):
        np.testing.assert_array_equal(back[f"side_embedding_{i}"]["embedding"],
                                      params[f"side_embedding_{i}"]["embedding"])
    off = TU.SASRecUserTower(UserTowerConfig(**TOWER), num_id_embeddings=N)
    assert not any("side_embedding" in k for k in off.state_dict())


def test_side_ids_are_required_with_the_flag(towers):
    _, _, tt, args = towers
    targs, _ = port_args(args)
    with pytest.raises(ValueError, match="side_ids"):
        tt(*targs)


@pytest.mark.parametrize("all_timesteps", [True, False])
def test_forward_with_side_gates_matches_jax(towers, all_timesteps):
    jt, params, tt, args = towers
    ref = np.asarray(jt.apply({"params": params}, *args, all_timesteps=all_timesteps,
                              deterministic=True))
    targs, side = port_args(args)
    with torch.no_grad():
        got = tt(*targs, all_timesteps=all_timesteps, side_ids=side).numpy()
        without = tt.__class__(UserTowerConfig(**TOWER), num_id_embeddings=N)
        without.load_state_dict({k: v for k, v in tt.state_dict().items()
                                 if "side_embedding" not in k}, strict=True)
        base = without.eval()(*targs, all_timesteps=all_timesteps).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - base).max() > 0.05          # the side ids change the rows
    rows = (got, ref) if not all_timesteps else (got[:, -1], ref[:, -1])
    for g, r in ((got, ref), rows):
        g = g.reshape(-1, g.shape[-1])
        r = r.reshape(-1, r.shape[-1])
        cos = (g * r).sum(1) / (np.linalg.norm(g, axis=1) * np.linalg.norm(r, axis=1))
        assert cos.min() >= 0.999, cos.min()
        np.testing.assert_allclose(g, r, atol=2e-2)


class _Fp32Numpy:
    """``jnp`` with ``bfloat16`` meaning float32: the JAX tower in fp32."""

    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


def test_gradients_with_side_gates_match_jax_in_fp32(towers, monkeypatch):
    """Both towers in fp32, all timesteps, a fixed random projection of the
    rows as the loss: loss to 1e-4, every gradient to 1e-5 abs."""
    _, params, _, args = towers
    monkeypatch.setattr(JU, "jnp", _Fp32Numpy())
    for module in (TL, TU):
        monkeypatch.setattr(module, "BF16", torch.float32)
    w = np.random.default_rng(7).normal(size=(*args[1].shape, TOWER["d_model"]))
    w = w.astype(np.float32)
    jt = JU.SASRecUserTower(JaxUserTowerConfig(**TOWER), num_id_embeddings=N,
                            enable_side_gates=True)

    def jloss(p):
        out = jt.apply({"params": p}, *args, all_timesteps=True, deterministic=True)
        return jnp.sum(JL.l2_normalize(out) * w)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
    tt = TU.SASRecUserTower(UserTowerConfig(**TOWER), num_id_embeddings=N,
                            enable_side_gates=True)
    for m in tt.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float32
    tt.load_state_dict(flax_to_torch(params), strict=True)
    targs, side = port_args(args)
    loss = (tt.eval()(*targs, all_timesteps=True, side_ids=side) * torch.as_tensor(w)).sum()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref_loss), abs=1e-4)
    ref = flax_to_torch(jax.device_get(ref_grads))
    for name, p in tt.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), atol=1e-5, err_msg=name)
    assert np.abs(ref["side_embedding_0.weight"].numpy()).max() > 0
