"""The port's item tower against the JAX one, on the CPU.

Modules get the JAX modules' parameters through the bridge and the same
numpy inputs. Both towers compute in bf16 over fp32 parameters and round at
different places, so module outputs are held at bf16 tolerance: per-row
cosine >= 0.999 and 2e-2 abs (the JAX suite's served-vs-materialized bound,
tests/test_serve.py). Losses, optimizer updates and view statistics are
held at the tolerances stated in each test.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.config import Config, DataConfig, ItemTowerConfig, SimCSEConfig, VocabConfig
from recsys_tpu.data.dataset import slice_item_batch, tokenize_items
from recsys_tpu.data.synthetic import generate_dataset
from recsys_tpu.data.vocab import StdVocab
from recsys_tpu.models import layers as JL
from recsys_tpu.models.item_tower import SimCSEModel as JaxSimCSEModel
from recsys_tpu.models.text_encoder import HashTextEncoder as JaxHashTextEncoder
from recsys_tpu.ops import contrastive as JC
from recsys_tpu.ops.augment import corrupt_view as jax_corrupt_view
from recsys_tpu.train.simcse import build_model as jax_build_model
from recsys_tpu.train.simcse import init_params
from recsys_tpu.train.simcse import make_optimizer as jax_make_optimizer
from recsys_tpu.train.state import TrainState as JaxTrainState
from recsys_tpu_torch.bridge import flax_to_torch, load_flax_params
from recsys_tpu_torch.models import layers as TL
from recsys_tpu_torch.models.text_encoder import HashTextEncoder
from recsys_tpu_torch.ops.augment import corrupt_view, two_views
from recsys_tpu_torch.train import simcse as TS

SMALL_CFG = Config(
    data=DataConfig(num_items=64, num_users=16, days=30, seed=3),
    vocab=VocabConfig(max_field_tokens=8, max_name_tokens=8, text_vocab_size=512),
    item_tower=ItemTowerConfig(head_hidden=(128,), fusion_layers=1, text_layers=1),
    simcse=SimCSEConfig(batch_size=16, epochs=2, metrics_every=2, steps_per_epoch_min=1),
)
INPUTS = ("std", "re_ids", "re_mask", "txt_ids", "txt_mask")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers on few cores: torch's default of one
    thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def assert_rows_close(got, ref, cos_min=0.999, atol=2e-2):
    got = np.asarray(got, np.float32).reshape(len(ref), -1)
    ref = np.asarray(ref, np.float32).reshape(len(ref), -1)
    live = np.linalg.norm(ref, axis=1) > 1e-6  # an all-masked mean pool is 0
    g, r = got[live], ref[live]
    cos = (g * r).sum(1) / (np.linalg.norm(g, axis=1) * np.linalg.norm(r, axis=1))
    assert cos.min() >= cos_min, cos.min()
    np.testing.assert_allclose(got, ref, atol=atol)


def bridged(flax_module, torch_module, *init_args, method=None):
    params = jax.device_get(flax_module.init(jax.random.PRNGKey(0), *init_args,
                                             method=method)["params"])
    torch_module.load_state_dict(flax_to_torch(params), strict=True)
    return params, torch_module.eval()


@pytest.fixture(scope="module")
def item_tensors():
    items, _, _ = generate_dataset(SMALL_CFG.data)
    return tokenize_items(items, StdVocab(), SMALL_CFG.vocab)


@pytest.fixture(scope="module")
def models(item_tensors):
    jm = jax_build_model(SMALL_CFG, StdVocab().size, item_tensors["std"].shape[1])
    params = jax.device_get(init_params(jm, item_tensors, jax.random.PRNGKey(0)))
    tm = TS.build_model(SMALL_CFG, StdVocab().size, item_tensors["std"].shape[1], "cpu")
    load_flax_params(tm, params)
    return jm, params, tm


# -- layers ------------------------------------------------------------------

def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("name", ["mlp", "se_block", "head"])
def test_dense_layers_match_flax(name):
    x = _x(12, 64)
    if name == "mlp":
        fm, tm = JL.MLP((96, 32)), TL.MLP(64, [96, 32])
    elif name == "se_block":
        fm, tm = JL.SEResidualBlock(64), TL.SEResidualBlock(64)
    else:
        fm, tm = JL.DeepResidualHead(32, (64, 128)), TL.DeepResidualHead(64, 32, (64, 128))
    params, tm = bridged(fm, tm, x)
    ref = fm.apply({"params": params}, x)
    with torch.no_grad():
        got = tm(torch.tensor(x)).float().numpy()
    assert_rows_close(got, np.asarray(ref, np.float32))


@pytest.mark.parametrize("causal", [False, True], ids=["padded", "causal"])
def test_transformer_encoder_matches_flax(causal):
    x = _x(5, 7, 64)
    mask = np.ones((5, 7), np.int32)
    mask[1, 4:] = 0
    mask[3] = 0  # a row whose keys are all masked: uniform attention, not NaN
    fm, tm = JL.TransformerEncoder(64, 4, 2), TL.TransformerEncoder(64, 4, 2)
    params, tm = bridged(fm, tm, x)
    ref = fm.apply({"params": params}, x, pad_mask=mask, causal=causal)
    with torch.no_grad():
        got = tm(torch.tensor(x), pad_mask=torch.tensor(mask), causal=causal).float().numpy()
    assert np.isfinite(got).all()
    ref = np.asarray(ref, np.float32).reshape(35, -1)
    # un-normalized activations up to |x| ~ 4: allow two bf16 ulps of the
    # largest output (2 * 2^-8 * max|ref|), never less than 2e-2
    assert_rows_close(got.reshape(35, -1), ref,
                      atol=max(2e-2, 2 * 2.0 ** -8 * float(np.abs(ref).max())))


def test_l2_normalize_and_masked_mean_match_flax():
    x = _x(4, 6, 16)
    mask = np.array([[1, 1, 0, 0, 0, 0], [1] * 6, [0] * 6, [1, 0, 1, 0, 1, 0]], np.int32)
    np.testing.assert_allclose(TL.masked_mean(torch.tensor(x), torch.tensor(mask)).numpy(),
                               np.asarray(JL.masked_mean(x, mask)), atol=1e-6)
    np.testing.assert_allclose(TL.l2_normalize(torch.tensor(x)).numpy(),
                               np.asarray(JL.l2_normalize(x)), atol=1e-6)


def test_hash_text_encoder_matches_flax(item_tensors):
    ids = item_tensors["txt_ids"][:10]
    mask = item_tensors["txt_mask"][:10].copy()
    mask[2] = 0  # the zero-padded rows of a serving batch
    fm = JaxHashTextEncoder(vocab_size=512, dim=128, num_layers=1, nhead=4, max_len=8)
    tm = HashTextEncoder(vocab_size=512, dim=128, num_layers=1, nhead=4, max_len=8)
    params, tm = bridged(fm, tm, ids, mask, method=JaxHashTextEncoder.encode)
    ref = fm.apply({"params": params}, ids, mask, method=JaxHashTextEncoder.encode)
    with torch.no_grad():
        got = tm.encode(torch.tensor(ids), torch.tensor(mask)).float().numpy()
        tok = tm.embed_tokens(torch.tensor(ids)).float().numpy()
    assert np.isfinite(got).all()
    assert_rows_close(got, np.asarray(ref, np.float32))
    ref_tok = fm.apply({"params": params}, ids, method=JaxHashTextEncoder.embed_tokens)
    np.testing.assert_array_equal(tok, np.asarray(ref_tok, np.float32))


@pytest.mark.parametrize("method", ["encode", "projector"])
def test_simcse_model_matches_flax(models, item_tensors, method):
    jm, params, tm = models
    b = slice_item_batch(item_tensors, np.arange(24))
    b["txt_mask"][5] = 0
    args = [b[k] for k in INPUTS]
    targs = [torch.tensor(a) for a in args]
    with torch.no_grad():
        if method == "encode":
            ref = jm.apply({"params": params}, *args, method=JaxSimCSEModel.encode)
            got = tm.encode(*targs)
        else:
            ref = jm.apply({"params": params}, *args, deterministic=True)
            got = tm.eval()(*targs)
    assert_rows_close(got.numpy(), np.asarray(ref))
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0, atol=1e-5)


# -- one training step ---------------------------------------------------------

def _fixed_views(item_tensors, n=32, seed=7):
    """Two corrupted views made with numpy, handed to both frameworks."""
    rng = np.random.default_rng(seed)
    b = slice_item_batch(item_tensors, np.arange(n))
    views = []
    for _ in range(2):
        v = dict(b)
        v["re_mask"] = b["re_mask"] * (rng.random(b["re_mask"].shape) > 0.2)
        v["re_mask"] = v["re_mask"].astype(np.int32)
        views.append(v)
    return views


def test_simcse_loss_and_grads_match_jax(item_tensors):
    """Dropout 0 on both sides, identical views. Loss within 1e-2 abs and
    grads at per-tensor cosine >= 0.99: bf16 activations in both towers
    round differently, and the error compounds through the backward.
    Tensors whose true gradient is ~0 (attention key biases: softmax does not
    see a per-row constant) carry only rounding noise; they are held to
    1e-2 of the largest gradient norm instead."""
    cfg = dataclasses.replace(SMALL_CFG, item_tower=dataclasses.replace(
        SMALL_CFG.item_tower, dropout=0.0))
    jm = jax_build_model(cfg, StdVocab().size, 6)
    params = jax.device_get(init_params(jm, item_tensors, jax.random.PRNGKey(1)))
    v1, v2 = _fixed_views(item_tensors)

    def jloss(p):
        e1 = jm.apply({"params": p}, *[v1[k] for k in INPUTS], deterministic=True)
        e2 = jm.apply({"params": p}, *[v2[k] for k in INPUTS], deterministic=True)
        return JC.bidirectional_infonce(e1, e2, cfg.simcse.temperature)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
    tm = TS.build_model(cfg, StdVocab().size, 6, "cpu")
    load_flax_params(tm, params)
    tm.train()
    loss, _, _ = TS.loss_on_views(tm, cfg, {k: torch.tensor(v) for k, v in v1.items()},
                                  {k: torch.tensor(v) for k, v in v2.items()})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref_loss), abs=1e-2)
    ref = flax_to_torch(jax.device_get(ref_grads))
    scale = max(float(r.norm()) for r in ref.values())
    for name, p in tm.named_parameters():
        g, r = p.grad.flatten(), ref[name].flatten()
        if float(r.norm()) < 1e-3 * scale:
            assert float((g - r).norm()) < 1e-2 * scale, name
            continue
        cos = float(g @ r / (g.norm() * r.norm()))
        assert cos >= 0.99, (name, cos)


def test_adamw_groups_and_schedule_match_optax(models):
    """Three updates of identical grads through both optimizers: the same
    parameters to 1e-6 abs (fp32 rounding of the moment updates). lr 1e-2 /
    1e-3 so the updates are far above that."""
    cfg = dataclasses.replace(SMALL_CFG, simcse=dataclasses.replace(
        SMALL_CFG.simcse, lr=1e-2, text_encoder_lr=1e-3))
    _, params, _ = models
    tm = TS.build_model(cfg, StdVocab().size, 6, "cpu")
    load_flax_params(tm, params)
    state = JaxTrainState.create(params, jax_make_optimizer(cfg, params, 10))
    opt, sched = TS.make_optimizer(cfg, tm, 10)
    rng = np.random.default_rng(0)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        state = state.apply_gradients(grads)
        for name, g in flax_to_torch(grads).items():
            dict(tm.named_parameters())[name].grad = g
        opt.step()
        sched.step()
    got = tm.state_dict()
    for name, ref in flax_to_torch(jax.device_get(state.params)).items():
        np.testing.assert_allclose(got[name].numpy(), ref.numpy(), atol=1e-6, err_msg=name)
    # next lr: warmup of 1 step, then linear decay over 9 -> 1 - (3 - 1) / 9
    lrs = {g["name"]: g["lr"] for g in opt.param_groups}
    assert lrs == pytest.approx({"text": 1e-3 * 7 / 9, "rest": 1e-2 * 7 / 9})


# -- view corruption ---------------------------------------------------------

def _corruption_batch(B=4000):
    """9 fields of 4 values x 2 tokens each; names of 1..8 tokens."""
    rng = np.random.default_rng(0)
    F, T = 9, 8
    re_value = np.tile(np.repeat(np.arange(1, 5), 2), (B, F, 1)).astype(np.int32)
    re_mask = np.ones((B, F, T), np.int32)
    lens = rng.integers(1, 9, B)
    txt_mask = (np.arange(8)[None, :] < lens[:, None]).astype(np.int32)
    return {"std": rng.integers(1, 9, (B, 6)).astype(np.int32),
            "re_ids": rng.integers(1, 500, (B, F, T)).astype(np.int32),
            "re_mask": re_mask, "re_value": re_value,
            "txt_ids": rng.integers(1, 500, (B, 8)).astype(np.int32) * txt_mask,
            "txt_mask": txt_mask}


def _rates(out, batch):
    re_mask = np.asarray(out["re_mask"])
    txt = np.asarray(out["txt_mask"])
    multi = batch["txt_mask"].sum(-1) > 1
    field_dropped = re_mask.sum(-1) == 0
    return {"token_kept": re_mask.mean(),
            "field_dropped": field_dropped.mean(),
            "name_deleted": (txt.sum(-1) < batch["txt_mask"].sum(-1))[multi].mean()}


def test_corrupt_view_contract_and_rates():
    """Only masks change; value-level drop p, key-level drop p - 0.1, name
    deletion 0.5 of multi-token names; one-token names never emptied. Rates
    within 0.02 of the contract and of the JAX implementation's on the same
    batch (4000 items: the binomial sd of a 0.5 rate is 0.008)."""
    p = 0.3
    batch = _corruption_batch()
    out = corrupt_view({k: torch.tensor(v) for k, v in batch.items()},
                       torch.Generator().manual_seed(0), p)
    for k in ("std", "re_ids", "re_value", "txt_ids"):
        assert torch.equal(out[k], torch.tensor(batch[k])), k
    re_mask, txt = out["re_mask"].numpy(), out["txt_mask"].numpy()
    assert (re_mask <= batch["re_mask"]).all() and (txt <= batch["txt_mask"]).all()
    # tokens of one value are kept or dropped together
    assert (re_mask[..., 0::2] == re_mask[..., 1::2]).all()
    single = batch["txt_mask"].sum(-1) == 1
    np.testing.assert_array_equal(txt[single], batch["txt_mask"][single])
    assert ((batch["txt_mask"].sum(-1) - txt.sum(-1)) <= 1).all()

    rates = _rates(out, batch)
    key_p = p - 0.1
    expected = {"token_kept": (1 - p) * (1 - key_p),
                "field_dropped": key_p + (1 - key_p) * p ** 4,
                "name_deleted": 0.5}
    jout = jax_corrupt_view({k: jnp.asarray(v) for k, v in batch.items()},
                            jax.random.PRNGKey(0), p)
    jrates = _rates(jout, batch)
    for k in expected:
        assert rates[k] == pytest.approx(expected[k], abs=0.02), (k, rates[k])
        assert rates[k] == pytest.approx(jrates[k], abs=0.02), (k, rates[k], jrates[k])


def test_corrupt_view_p0_keeps_fields_and_views_differ():
    batch = {k: torch.tensor(v) for k, v in _corruption_batch(64).items()}
    out = corrupt_view(batch, torch.Generator().manual_seed(1), 0.0)
    assert torch.equal(out["re_mask"], batch["re_mask"])
    v1, v2 = two_views(batch, torch.Generator().manual_seed(2), 0.5)
    assert not torch.equal(v1["re_mask"], v2["re_mask"])


# -- training end to end ---------------------------------------------------------

def test_simcse_training_learns_and_retrieves(item_tensors, tmp_path):
    """train -> loss drops; materialize -> each item's own vector at rank 1."""
    from recsys_tpu.train.checkpoint import load_array_with_ids

    state = TS.train_simcse(SMALL_CFG, item_tensors, str(tmp_path), device="cpu")
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    losses = [r["loss"] for r in recs if r["kind"] == "epoch"]
    assert len(losses) == 2 and losses[-1] < losses[0]
    assert state.step == 8 and all(np.isfinite(state.losses))
    train = [r for r in recs if r["kind"] == "train"]
    assert [r["step"] for r in train] == [2, 4, 6, 8]
    assert all(np.isfinite([r["align"], r["uniform"]]).all() for r in train)

    mat = TS.materialize_item_vectors(SMALL_CFG, state.model, item_tensors,
                                      str(tmp_path / "item_matrix"), batch_size=32)
    assert mat.shape == (65, 128)
    np.testing.assert_allclose(np.linalg.norm(mat[1:], axis=1), 1.0, rtol=1e-3)
    _, idx = TS.topk_items(mat, mat[1:9], k=3, device="cpu")
    assert (idx[:, 0] == np.arange(1, 9)).all()
    arr, ids, meta = load_array_with_ids(str(tmp_path / "item_matrix"))
    assert ids[0] == "<pad>" and len(ids) == 65 and meta["pad_row"] == 0

    # the best checkpoint restores to the trained weights
    model, entry = TS.restore_model(SMALL_CFG, str(tmp_path), 6, "cpu")
    assert entry["name"] == "best" and entry["metric"] == pytest.approx(min(losses))
    for k, v in model.state_dict().items():
        assert torch.equal(v, state.model.state_dict()[k]), k


def test_simcse_steps_floor_multiplies_passes(item_tensors, tmp_path):
    cfg = dataclasses.replace(SMALL_CFG, simcse=dataclasses.replace(
        SMALL_CFG.simcse, epochs=1, metrics_every=1, steps_per_epoch_min=9))
    TS.train_simcse(cfg, item_tensors, str(tmp_path), device="cpu")
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    # 64 items / bs 16 = 4 steps/pass -> ceil(9/4) = 3 passes -> 12 steps
    assert max(r["step"] for r in recs if r["kind"] == "train") == 12
