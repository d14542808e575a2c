"""The pretrained text encoder of the port against the JAX package's, on the CPU.

``data/text_pretrain.py`` is the same numpy / scipy arithmetic in both
packages, so its outputs are held bit for bit. Modules get the JAX modules'
parameters through the bridge and the same numpy inputs; outputs are held at
the bf16 tolerance of ``tests/test_torch_item_tower.py`` (per-row cosine >=
0.999, 2e-2 abs). The loss and gradients are held at the JAX suite's kernel
tolerances (loss 1e-4, gradients 1e-5 abs) on the encoder computing in fp32
on both sides, where no bf16 rounding stands between the two. The frozen
table is held bit for bit wherever it must not move.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.config import Config as JaxConfig
from recsys_tpu.config import DataConfig as JaxDataConfig
from recsys_tpu.config import ItemTowerConfig as JaxItemTowerConfig
from recsys_tpu.config import SimCSEConfig as JaxSimCSEConfig
from recsys_tpu.config import VocabConfig as JaxVocabConfig
from recsys_tpu.data import text_pretrain as JT
from recsys_tpu.data.dataset import slice_item_batch, tokenize_items
from recsys_tpu.data.synthetic import generate_dataset
from recsys_tpu.data.vocab import StdVocab
from recsys_tpu.models import layers as JL
from recsys_tpu.models.item_tower import SimCSEModel as JaxSimCSEModel
from recsys_tpu.models.text_encoder import PretrainedTextEncoder as JaxPretrainedTextEncoder
from recsys_tpu.ops import contrastive as JC
from recsys_tpu.pipeline import cli as jax_cli
from recsys_tpu.train.simcse import build_model as jax_build_model
from recsys_tpu.train.simcse import init_params
from recsys_tpu.train.simcse import make_optimizer as jax_make_optimizer
from recsys_tpu.train.state import TrainState as JaxTrainState
from recsys_tpu_torch.bridge import flax_to_torch, load_flax_params, torch_to_flax
from recsys_tpu_torch.config import (Config, DataConfig, ItemTowerConfig, MeshConfig,
                                     SimCSEConfig, VocabConfig)
from recsys_tpu_torch.data import text_pretrain as TT
from recsys_tpu_torch.models import layers as TL
from recsys_tpu_torch.models.text_encoder import PretrainedTextEncoder
from recsys_tpu_torch.ops import select_infonce
from recsys_tpu_torch.parallel.mesh import build_mesh
from recsys_tpu_torch.pipeline import cli
from recsys_tpu_torch.train import simcse as TS
from recsys_tpu_torch.train.state import TrainState

V, DP = 512, 32
CFG = Config(
    data=DataConfig(num_items=64, num_users=16, days=30, seed=3),
    vocab=VocabConfig(max_field_tokens=8, max_name_tokens=8, text_vocab_size=V),
    item_tower=ItemTowerConfig(head_hidden=(128,), fusion_layers=1, text_layers=1,
                               text_encoder="pretrained", pretrained_dim=DP),
    simcse=SimCSEConfig(batch_size=16, epochs=1, metrics_every=2, steps_per_epoch_min=1),
)
JAX_CFG = JaxConfig(
    data=JaxDataConfig(num_items=64, num_users=16, days=30, seed=3),
    vocab=JaxVocabConfig(max_field_tokens=8, max_name_tokens=8, text_vocab_size=V),
    item_tower=JaxItemTowerConfig(head_hidden=(128,), fusion_layers=1, text_layers=1,
                                  text_encoder="pretrained", pretrained_dim=DP),
    simcse=JaxSimCSEConfig(batch_size=16, epochs=1, metrics_every=2, steps_per_epoch_min=1),
)
INPUTS = ("std", "re_ids", "re_mask", "txt_ids", "txt_mask")
STD_FIELDS = ("product_type_name", "graphical_appearance_name", "colour_group_name",
              "department_name", "section_name", "perceived_colour_value_name")
TABLE = "encoder.text_encoder.pretrained_embedding"


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
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


@pytest.fixture(scope="module")
def item_tensors():
    items, _, _ = generate_dataset(JAX_CFG.data)
    return tokenize_items(items, StdVocab(), JAX_CFG.vocab)


@pytest.fixture(scope="module")
def artifact(item_tensors):
    return TT.pretrain_embeddings(item_tensors, V, dim=DP, seed=3)


@pytest.fixture(scope="module")
def models(item_tensors, artifact):
    """The JAX model's parameters (the artifact in its table) and the port's
    model carrying them."""
    jm = jax_build_model(JAX_CFG, StdVocab().size, item_tensors["std"].shape[1])
    params = jax.device_get(init_params(jm, item_tensors, jax.random.PRNGKey(0)))
    params["encoder"]["text_encoder"]["pretrained_embedding"] = artifact
    tm = TS.build_model(CFG, StdVocab().size, item_tensors["std"].shape[1], "cpu")
    load_flax_params(tm, params)
    return jm, params, tm


# -- data/text_pretrain.py -------------------------------------------------------

def test_pretrain_functions_equal_jax_bit_for_bit(item_tensors, artifact):
    bags = TT.item_token_bags(item_tensors)
    ref_bags = JT.item_token_bags(item_tensors)
    assert bags.shape == ref_bags.shape and (bags != ref_bags).nnz == 0
    cooc = (bags.T @ bags).tocsr()
    got, ref = TT.ppmi(cooc, shift=0.5), JT.ppmi(cooc, shift=0.5)
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_array_equal(got.data, ref.data)
    np.testing.assert_array_equal(artifact, JT.pretrain_embeddings(item_tensors, V, dim=DP,
                                                                   seed=3))
    assert artifact.shape == (V, DP) and artifact.dtype == np.float32
    assert not artifact[0].any()     # PAD
    live = np.abs(artifact).sum(1) > 0
    np.testing.assert_allclose(np.linalg.norm(artifact[live], axis=1), 1.0, atol=1e-5)


def test_each_package_loads_the_others_artifact(tmp_path, artifact):
    TT.save_text_pretrain(str(tmp_path / "port"), artifact)
    JT.save_text_pretrain(str(tmp_path / "jax.npz"), artifact)
    np.testing.assert_array_equal(JT.load_text_pretrain(str(tmp_path / "port.npz")), artifact)
    np.testing.assert_array_equal(TT.load_text_pretrain(str(tmp_path / "jax")), artifact)
    with np.load(tmp_path / "port.npz") as z:
        np.testing.assert_array_equal(z["meta"], [V, DP])
        assert z["meta"].dtype == np.int64


# -- the encoder and the tower -----------------------------------------------------

def test_pretrained_text_encoder_matches_flax(item_tensors, artifact):
    ids, mask = item_tensors["txt_ids"][:10], item_tensors["txt_mask"][:10].copy()
    mask[2] = 0  # the zero-padded rows of a serving batch
    re_ids = item_tensors["re_ids"][:4]
    fm = JaxPretrainedTextEncoder(vocab_size=V, dim=64, pretrained_dim=DP, num_layers=1,
                                  nhead=4, max_len=8)
    params = jax.device_get(jax.jit(lambda key: fm.init(
        key, ids, mask, method=JaxPretrainedTextEncoder.encode))(jax.random.PRNGKey(0))["params"])
    params["pretrained_embedding"] = artifact
    tm = PretrainedTextEncoder(vocab_size=V, dim=64, pretrained_dim=DP, num_layers=1,
                               nhead=4, max_len=8)
    tm.load_state_dict(flax_to_torch(params), strict=True)
    assert not tm.pretrained_embedding.requires_grad
    with torch.no_grad():
        got = tm.encode(torch.tensor(ids), torch.tensor(mask)).float().numpy()
        tok = tm.embed_tokens(torch.tensor(re_ids)).float().numpy()
    ref, ref_tok = jax.jit(lambda p: (
        fm.apply({"params": p}, ids, mask, method=JaxPretrainedTextEncoder.encode),
        fm.apply({"params": p}, re_ids, method=JaxPretrainedTextEncoder.embed_tokens)))(params)
    assert np.isfinite(got).all() and tok.shape == (4, 9, 8, 64)
    assert_rows_close(got, np.asarray(ref, np.float32))
    assert_rows_close(tok.reshape(-1, 64), np.asarray(ref_tok, np.float32).reshape(-1, 64))


@pytest.mark.parametrize("method", ["encode", "projector"])
def test_simcse_model_with_pretrained_encoder_matches_flax(models, item_tensors, method):
    jm, params, tm = models
    assert isinstance(tm.encoder.text_encoder, PretrainedTextEncoder)
    b = slice_item_batch(item_tensors, np.arange(24))
    args = [b[k] for k in INPUTS]
    targs = [torch.tensor(a) for a in args]
    with torch.no_grad():
        if method == "encode":
            ref = jax.jit(lambda p: jm.apply({"params": p}, *args,
                                             method=JaxSimCSEModel.encode))(params)
            got = tm.encode(*targs)
        else:
            ref = jax.jit(lambda p: jm.apply({"params": p}, *args, deterministic=True))(params)
            got = tm.eval()(*targs)
    assert_rows_close(got.numpy(), np.asarray(ref))


def test_bridge_round_trip_carries_the_table_and_projection(models):
    _, params, tm = models
    back = torch_to_flax(tm)
    te = back["encoder"]["text_encoder"]
    assert set(te) == {"pretrained_embedding", "pretrained_proj", "pos_embedding", "encoder"}
    assert set(te["pretrained_proj"]) == {"kernel", "bias"}
    ref = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(ref)
    for path, leaf in ref:
        np.testing.assert_array_equal(got[path], np.asarray(leaf), err_msg=str(path))


def test_unknown_text_encoder_raises():
    cfg = dataclasses.replace(CFG, item_tower=dataclasses.replace(CFG.item_tower,
                                                                  text_encoder="bert"))
    with pytest.raises(ValueError, match="text_encoder"):
        TS.build_model(cfg, StdVocab().size, 6, "cpu")


# -- one step: loss, gradients, optimizer ----------------------------------------------

@pytest.fixture()
def fp32_port(monkeypatch):
    """The port's layers computing in fp32: every cast to bf16 casts to fp32."""
    from recsys_tpu_torch.models import text_encoder

    for module in (TL, text_encoder):
        monkeypatch.setattr(module, "BF16", torch.float32)


def test_encoder_loss_and_grads_match_jax_value_and_grad(item_tensors, artifact, fp32_port):
    """Both encoders in fp32; two views differ in their name masks. Loss to
    1e-4, every trainable gradient to 1e-5; the table's JAX gradient is zero
    (``stop_gradient``) and the port's is None (no gradient flows to it)."""
    rng = np.random.default_rng(5)
    n = 24
    ids, mask = item_tensors["txt_ids"][:n], item_tensors["txt_mask"][:n]
    re_ids = item_tensors["re_ids"][:n].reshape(n, -1)
    re_mask = item_tensors["re_mask"][:n].reshape(n, -1)
    m1 = (mask * (rng.random(mask.shape) > 0.2)).astype(np.int32)
    m2 = (mask * (rng.random(mask.shape) > 0.2)).astype(np.int32)
    kw = dict(vocab_size=V, dim=64, pretrained_dim=DP, num_layers=1, nhead=4, max_len=8)
    fm = JaxPretrainedTextEncoder(**kw, dtype=jnp.float32)
    params = jax.device_get(jax.jit(lambda key: fm.init(
        key, ids, mask, method=JaxPretrainedTextEncoder.encode))(jax.random.PRNGKey(1))["params"])
    params["pretrained_embedding"] = artifact

    def jrows(p, m):
        enc = fm.apply({"params": p}, ids, m, method=JaxPretrainedTextEncoder.encode)
        tok = fm.apply({"params": p}, re_ids, method=JaxPretrainedTextEncoder.embed_tokens)
        return JL.l2_normalize(enc + JL.masked_mean(tok, re_mask, axis=-2))

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: JC.bidirectional_infonce(jrows(p, m1), jrows(p, m2), 0.08)))(params)
    assert not np.asarray(ref_grads["pretrained_embedding"]).any()

    tm = PretrainedTextEncoder(**kw)
    for m in tm.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float32
    tm.load_state_dict(flax_to_torch(params), strict=True)

    def trows(m):
        enc = tm.encode(torch.tensor(ids), torch.tensor(m))
        tok = tm.embed_tokens(torch.tensor(re_ids))
        return TL.l2_normalize(enc + TL.masked_mean(tok, torch.tensor(re_mask), dim=-2))

    loss = select_infonce("xla")(trows(m1), trows(m2), 0.08)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref_loss), abs=1e-4)
    assert tm.pretrained_embedding.grad is None
    ref = flax_to_torch(jax.device_get(ref_grads))
    for name, p in tm.named_parameters():
        if name == "pretrained_embedding":
            continue
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), atol=1e-5,
                                   err_msg=name)


def test_optimizer_leaves_the_table_alone_as_optax_set_to_zero(models):
    """Three updates of the same gradients (the table's too) through both
    optimizers: every parameter to 1e-6, the table bit for bit unchanged;
    the text group holds the projection and the encoder."""
    _, params, _ = models
    cfg = dataclasses.replace(CFG, simcse=dataclasses.replace(
        CFG.simcse, lr=1e-2, text_encoder_lr=1e-3))
    jcfg = dataclasses.replace(JAX_CFG, simcse=dataclasses.replace(
        JAX_CFG.simcse, lr=1e-2, text_encoder_lr=1e-3))
    tm = TS.build_model(cfg, StdVocab().size, 6, "cpu")
    load_flax_params(tm, params)
    state = JaxTrainState.create(params, jax_make_optimizer(jcfg, params, 10))
    opt, sched = TS.make_optimizer(cfg, tm, 10)
    text = {id(p) for g in opt.param_groups if g["name"] == "text" for p in g["params"]}
    named = dict(tm.named_parameters())
    assert id(named["encoder.text_encoder.pretrained_proj.weight"]) in text
    assert id(named[TABLE]) not in {id(p) for g in opt.param_groups for p in g["params"]}
    apply = jax.jit(lambda s, g: s.apply_gradients(g))
    rng = np.random.default_rng(0)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        state = apply(state, grads)
        for name, g in flax_to_torch(grads).items():
            named[name].grad = g
        opt.step()
        sched.step()
    got = tm.state_dict()
    for name, ref in flax_to_torch(jax.device_get(state.params)).items():
        np.testing.assert_allclose(got[name].numpy(), ref.numpy(), atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(got[TABLE].numpy(),
                                  params["encoder"]["text_encoder"]["pretrained_embedding"])


# -- the trainer ---------------------------------------------------------------------

def test_train_simcse_keeps_the_artifact_and_raises_as_jax(item_tensors, artifact, tmp_path):
    state = TS.train_simcse(CFG, item_tensors, str(tmp_path), device="cpu",
                            text_pretrain=artifact)
    assert state.step == 4 and all(np.isfinite(state.losses))
    np.testing.assert_array_equal(state.model.state_dict()[TABLE].numpy(), artifact)
    init = TS.build_model(CFG, StdVocab().size, 6, "cpu", seed=CFG.data.seed).state_dict()
    for name in ("encoder.text_encoder.pretrained_proj.weight",
                 "encoder.text_encoder.pos_embedding"):
        assert not torch.equal(state.model.state_dict()[name], init[name]), name
    # the checkpoint carries the table: restore builds a random one and loads it
    model, entry = TS.restore_model(CFG, str(tmp_path), 6, "cpu")
    assert entry is not None
    np.testing.assert_array_equal(model.state_dict()[TABLE].numpy(), artifact)

    hash_cfg = dataclasses.replace(CFG, item_tower=dataclasses.replace(
        CFG.item_tower, text_encoder="hash"))
    with pytest.raises(ValueError, match="is not 'pretrained'"):
        TS.train_simcse(hash_cfg, item_tensors, str(tmp_path / "h"), device="cpu",
                        text_pretrain=artifact)
    with pytest.raises(ValueError, match="pretrain artifact"):
        TS.train_simcse(CFG, item_tensors, str(tmp_path / "s"), device="cpu",
                        text_pretrain=artifact[:, :16])


def test_data_parallel_step_keeps_every_replica_on_the_artifact(item_tensors, artifact):
    """Four data shards, two of them through a copy of the module on another
    device name: after a step every replica's table is the artifact and its
    other weights the master's."""
    cfg = dataclasses.replace(CFG, simcse=dataclasses.replace(CFG.simcse, batch_size=32))
    model = TS.build_model(cfg, StdVocab().size, 6, "cpu", seed=0)
    TS.load_text_pretrain_into(model, artifact)
    opt, sched = TS.make_optimizer(cfg, model, 4)
    state = TrainState(model, opt, sched)
    mesh = build_mesh(MeshConfig(num_data=4, num_model=1), ["cpu", "cpu:0", "cpu", "cpu:0"])
    step = TS.make_data_parallel_step(state, cfg, mesh)
    replicas = next(c.cell_contents for c in step.__closure__
                    if isinstance(c.cell_contents, TS.Replicas))
    assert replicas.copies
    data = TS.item_tensors_to(item_tensors, "cpu")
    loss, _, _ = step({k: v[:32] for k, v in data.items()}, torch.Generator().manual_seed(0))
    assert np.isfinite(float(loss)) and state.step == 1
    master = model.state_dict()
    for replica in replicas.models:
        sd = replica.state_dict()
        np.testing.assert_array_equal(sd[TABLE].numpy(), artifact)
        for name, value in master.items():
            assert torch.equal(sd[name], value), name


# -- the CLI on the verify recipe's tiny world ---------------------------------------

SETS = ["--set", "data.num_items=120", "--set", "data.num_users=60", "--set", "data.days=40",
        "--set", "vocab.max_field_tokens=8", "--set", "vocab.max_name_tokens=8",
        "--set", "item_tower.head_hidden=[128]", "--set", "item_tower.fusion_layers=1",
        "--set", "item_tower.text_layers=1", "--set", "simcse.batch_size=16",
        "--set", "simcse.epochs=1", "--set", "simcse.steps_per_epoch_min=1",
        "--set", "item_tower.text_encoder=pretrained", "--set", "serve.db_path=:memory:"]


def test_cli_pretrain_text_train_item_vectorize_serve(tmp_path):
    from recsys_tpu_torch.data.vocab import StdVocab as TVocab
    from recsys_tpu_torch.train.checkpoint import load_array_with_ids

    root = str(tmp_path / "w")
    sets = [*SETS, "--set", f"data.root={root}"]
    cli.main(["gen-data", *sets, "--device", "cpu"])
    with pytest.raises(FileNotFoundError):        # the artifact is not there yet
        cli.main(["train-item", *sets, "--device", "cpu"])
    out = cli.main(["pretrain-text", *sets, "--device", "cpu"])
    art = TT.load_text_pretrain(out["artifact"])
    assert out["shape"] == [8192, 128] and out["nonzero_rows"] > 0
    # the JAX stage on the same world writes the same artifact, under the same keys
    os.rename(out["artifact"], root + "/port_text_pretrain.npz")
    ref = jax_cli.main(["pretrain-text", *sets])
    assert set(ref) == set(out) and ref["nonzero_rows"] == out["nonzero_rows"]
    np.testing.assert_array_equal(JT.load_text_pretrain(ref["artifact"]), art)

    train = cli.main(["train-item", *sets, "--device", "cpu"])
    assert {"steps", "ckpt_dir", "text_encoder"} <= set(train)
    assert train["text_encoder"] == "pretrained" and train["steps"] > 0
    os.remove(out["artifact"])          # vectorize and serve read the table from the checkpoint
    vec = cli.main(["vectorize", *sets, "--device", "cpu"])
    assert {"matrix", "shape"} <= set(vec) and vec["shape"] == [121, 128]
    mat, ids, _ = load_array_with_ids(vec["matrix"])
    np.testing.assert_allclose(np.linalg.norm(mat[1:], axis=1), 1.0, atol=1e-3)
    cfg = cli.config_from_args(cli.parse_args(["vectorize", *sets]))
    model, _ = TS.restore_model(cfg, f"{root}/ckpt_item", TVocab().num_fields, "cpu")
    np.testing.assert_array_equal(model.state_dict()[TABLE].numpy(), art)

    # serve --model-backed: the app's item encoder is the pretrained tower
    import pandas as pd

    args = cli.parse_args(["serve", *sets, "--model-backed", "--device", "cpu"])
    ctx = cli.build_app(cli.config_from_args(args), args)
    items = pd.read_parquet(f"{root}/items.parquet").sort_values("item_id").head(6)
    rows = []
    for r in items.to_dict("records"):
        rf = r["reinforced_feature"]
        rows.append({"product_id": str(r["item_id"]), "product_name": r["product_name"],
                     "feature_data": {"reinforced_feature": {
                         k: [str(v) for v in vals] for k, vals in rf.items()
                         if vals is not None},
                         **{f: r[f] for f in STD_FIELDS}}})
    ctx.store.ingest_products(rows)
    assert ctx.process_pending()["processed_count"] == 6
    row_of = {pid: i for i, pid in enumerate(ids)}
    for r in rows:
        got = ctx.store.get_vector(r["product_id"])
        np.testing.assert_allclose(got, mat[row_of[r["product_id"]]], atol=2e-2)

    # /train/item-tower over the store's products answers with the pretrained tower
    res = ctx.train_item_fn(epochs=1)
    assert res["trained"] == "item-tower" and res["steps"] > 0
    assert all(np.isfinite(res["losses"]))
    with open(f"{root}/ckpt_item/manifest.json") as f:
        assert json.load(f)
