"""Flax <-> torch parameter bridge for SimCSEModel: round trips are exact."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from recsys_tpu.config import Config, DataConfig, ItemTowerConfig, SimCSEConfig, VocabConfig
from recsys_tpu.data.dataset import tokenize_items
from recsys_tpu.data.synthetic import generate_dataset
from recsys_tpu.data.vocab import StdVocab
from recsys_tpu.train.simcse import build_model as jax_build_model
from recsys_tpu.train.simcse import init_params
from recsys_tpu_torch.bridge import flax_to_torch, load_flax_params, torch_to_flax
from recsys_tpu_torch.train.simcse import build_model

SMALL_CFG = Config(
    data=DataConfig(num_items=64, num_users=16, days=30, seed=3),
    vocab=VocabConfig(max_field_tokens=8, max_name_tokens=8, text_vocab_size=512),
    item_tower=ItemTowerConfig(head_hidden=(128,), fusion_layers=1, text_layers=1),
    simcse=SimCSEConfig(batch_size=16, epochs=2, metrics_every=2, steps_per_epoch_min=1),
)
# two blocks per encoder and two head stages: exercises the _0/_1 naming
DEEP_CFG = dataclasses.replace(SMALL_CFG, item_tower=ItemTowerConfig(
    head_hidden=(128, 256), fusion_layers=2, text_layers=2, text_dim=64))


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers on few cores: torch's default of one
    thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def tensors():
    items, _, _ = generate_dataset(SMALL_CFG.data)
    return tokenize_items(items, StdVocab(), SMALL_CFG.vocab)


@pytest.mark.parametrize("cfg", [SMALL_CFG, DEEP_CFG], ids=["small", "deep"])
def test_flax_torch_flax_round_trip_is_exact(cfg, tensors):
    model = jax_build_model(cfg, StdVocab().size, tensors["std"].shape[1])
    params = jax.device_get(init_params(model, tensors, jax.random.PRNGKey(0)))
    tm = build_model(cfg, StdVocab().size, tensors["std"].shape[1], "cpu")
    load_flax_params(tm, params)  # strict: every torch key is mapped
    back = _flat(torch_to_flax(tm))
    ref = _flat(params)
    assert set(back) == set(ref)
    for k in ref:
        assert back[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)


@pytest.mark.parametrize("cfg", [SMALL_CFG, DEEP_CFG], ids=["small", "deep"])
def test_torch_flax_torch_round_trip_is_exact(cfg, tensors):
    tm = build_model(cfg, StdVocab().size, tensors["std"].shape[1], "cpu", seed=1)
    sd = flax_to_torch(torch_to_flax(tm))
    ref = tm.state_dict()
    assert set(sd) == set(ref)
    for k in ref:
        assert torch.equal(sd[k], ref[k]), k


def test_mha_layout_matches_flax_head_split(tensors):
    """q/k/v kernels (in, H, hd) become (H*hd, in) rows grouped by head."""
    model = jax_build_model(SMALL_CFG, StdVocab().size, tensors["std"].shape[1])
    params = jax.device_get(init_params(model, tensors, jax.random.PRNGKey(0)))
    mha = params["encoder"]["fusion"]["TransformerBlock_0"]["MultiHeadDotProductAttention_0"]
    sd = flax_to_torch(params)
    w = sd["encoder.fusion.TransformerBlock_0.MultiHeadDotProductAttention_0.query.weight"]
    kern = np.asarray(mha["query"]["kernel"])           # (in, H, hd)
    hd = kern.shape[2]
    # row h*hd + j of the torch weight is head h, feature j
    np.testing.assert_array_equal(w[hd + 3].numpy(), kern[:, 1, 3])
    out_w = sd["encoder.fusion.TransformerBlock_0.MultiHeadDotProductAttention_0.out.weight"]
    np.testing.assert_array_equal(out_w[:, hd + 3].numpy(), np.asarray(mha["out"]["kernel"])[1, 3])
