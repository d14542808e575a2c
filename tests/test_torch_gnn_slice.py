"""The GNN slice of the port on the CPU: batch sampling, five optimizer
steps against the JAX step, training / resume / fine-tune, distillation, the
CLI stages against the JAX ``gnn-eval`` stage, and the retrieval-eval helpers.

Tolerances: the step comparison is fp32 on both sides with Adam (eps 1e-8 in
both packages); early Adam updates are ~lr * sign(g), so an entry whose
gradient is within rounding of zero can move differently. Losses and tables
are held to 1e-4 abs over five steps at lr 5e-3.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import recsys_tpu.eval.gnn_eval as JE
import recsys_tpu.train.gnn as JG
import recsys_tpu_torch.eval.gnn_eval as TE
import recsys_tpu_torch.train.gnn as TG
from recsys_tpu.models.lightgcl import LightGCL as JaxLightGCL
from recsys_tpu.ops.graph import build_graph
from recsys_tpu.train.state import TrainState as JaxTrainState
from recsys_tpu_torch.bridge import load_flax_params
from recsys_tpu_torch.config import Config, DataConfig, DistillConfig, GNNConfig
from recsys_tpu_torch.eval.recall import topk_scores
from recsys_tpu_torch.models.lightgcl import LightGCL
from recsys_tpu_torch.pipeline import cli
from recsys_tpu_torch.train.checkpoint import CheckpointStore, load_array_with_ids
from recsys_tpu_torch.train.state import TrainState

CFG = Config(
    data=DataConfig(seed=5),
    gnn=GNNConfig(emb_dim=16, num_layers=2, svd_rank=4, batch_size=256, epochs=4,
                  lr=5e-2, propagation="segment_sum"),
    distill=DistillConfig(hidden_dim=64, out_dim=16, epochs=6, steps_per_epoch=25,
                          batch_size=128, lr=3e-3),
)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers on few cores: torch's default of one
    thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_graph():
    """The graph of tests/test_gnn.py: two communities of users and items."""
    rng = np.random.default_rng(0)
    nu, ni = 40, 30
    e = np.array([(u, i) for u in range(nu)
                  for i in rng.choice(15, size=6, replace=False) + (0 if u < 20 else 15)])
    graph = build_graph(e[:, 0], e[:, 1], nu, ni, svd_rank=4, pad_multiple=64)
    return graph, e[:, 0], e[:, 1]


def test_sample_bpr_batches_draws_the_same_batches(tiny_graph):
    graph, u, i = tiny_graph
    ref = list(JG.sample_bpr_batches(u, i, graph.num_items, 64, np.random.default_rng(2)))
    got = list(TG.sample_bpr_batches(u, i, graph.num_items, 64, np.random.default_rng(2)))
    assert len(got) == len(ref) == len(u) // 64
    for a, b in zip(got, ref):
        for x, y in zip(a, b):
            assert x.dtype == np.int32
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(TG.edge_key_index(u, i, graph.num_items),
                                  JG.edge_key_index(u, i, graph.num_items))


def test_five_steps_match_the_jax_step(tiny_graph):
    graph, u, i = tiny_graph
    g = dataclasses.replace(CFG.gnn, lr=5e-3)
    jprop, jargs = JG.select_propagation(g, graph, graph.num_nodes)
    jmodel = JaxLightGCL(graph.num_users, graph.num_items, g, prop_fn=jprop)
    params = jmodel.init(jax.random.PRNGKey(7), jargs, jnp.asarray(graph.svd_u),
                         jnp.asarray(graph.svd_s), jnp.asarray(graph.svd_v))["params"]
    jstate = JaxTrainState.create(params, optax.adam(g.lr))
    jstep = JG.make_gnn_step(jmodel, graph, g, jargs)

    tprop, targs = TG.select_propagation(g, graph, graph.num_nodes, "cpu")
    tmodel = load_flax_params(LightGCL(graph.num_users, graph.num_items, g, prop_fn=tprop),
                              jax.device_get(params))
    tstate = TrainState(tmodel, TG._adam(tmodel, g.lr))
    tstep = TG.make_gnn_step(tstate, graph, g, targs)

    batches = list(TG.sample_bpr_batches(u, i, graph.num_items, 48,
                                         np.random.default_rng(1)))[:5]
    assert len(batches) == 5
    for users, pos, neg in batches:
        jstate, jaux = jstep(jstate, jnp.asarray(users), jnp.asarray(pos), jnp.asarray(neg))
        taux = tstep(torch.as_tensor(users), torch.as_tensor(pos), torch.as_tensor(neg))
        for key in ("loss", "bpr", "ssl", "reg"):
            assert float(taux[key]) == pytest.approx(float(jaux[key]), abs=1e-4), key
    assert tstate.step == 5
    for name in ("user_emb", "item_emb"):
        np.testing.assert_allclose(getattr(tmodel, name).detach().numpy(),
                                   np.asarray(jstate.params[name]), atol=1e-4, rtol=0)
        moved = np.abs(np.asarray(jstate.params[name]) - np.asarray(params[name])).max()
        assert moved > 1e-2                              # five Adam steps did move them


def test_trainer_spmm_mode_is_the_jax_trainers_bf16_mode(tiny_graph):
    """``gnn.propagation=spmm`` (what ``auto`` picks on the card): both
    trainers propagate through their sparse-product kernel in its "bf16" mode,
    the JAX one in interpret mode, the port through the kernel's plain form.
    Both round the embeddings to bf16; the JAX kernel also keeps its sums in
    bf16 where the port sums in fp32, a few relative 2^-8 of a row's sum of
    |terms| (tests/test_torch_spmm.py derives the 2^-6 bound). Over three
    steps at lr 5e-3 that leaves the losses ~2e-5 apart and the SSL term, a
    log-sum-exp of embedding dots at temperature 0.2, ~3e-4 (measured); they
    are held to ten times that. The export stays fp32."""
    from recsys_tpu_torch.ops import spmm as S

    graph, u, i = tiny_graph
    g = dataclasses.replace(CFG.gnn, lr=5e-3, propagation="spmm", spmm_block_n=128)
    jprop, jargs = JG.select_propagation(g, graph, graph.num_nodes)
    tprop, layout = TG.select_propagation(g, graph, graph.num_nodes, "cpu")
    assert tprop is TG.spmm_bf16 and isinstance(layout, S.CsrGraph)

    x = np.random.default_rng(1).normal(size=(graph.num_nodes, 16)).astype(np.float32)
    ref = np.asarray(jprop(jargs, jnp.asarray(x)))[: graph.num_nodes]
    got = tprop(layout, torch.as_tensor(x)).numpy()
    row_sums = S.spmm_plain(layout, torch.as_tensor(np.abs(x))).numpy()
    assert (np.abs(got - ref) <= 2.0 ** -6 * row_sums + 1e-7).all()
    np.testing.assert_array_equal(got, S.spmm_plain(layout, torch.as_tensor(x), "bf16").numpy())
    assert np.abs(got - S.spmm_plain(layout, torch.as_tensor(x)).numpy()).max() > 1e-4

    jmodel = JaxLightGCL(graph.num_users, graph.num_items, g, prop_fn=jprop)
    params = jmodel.init(jax.random.PRNGKey(7), jargs, jnp.asarray(graph.svd_u),
                         jnp.asarray(graph.svd_s), jnp.asarray(graph.svd_v))["params"]
    jstate = JaxTrainState.create(params, optax.adam(g.lr))
    jstep = JG.make_gnn_step(jmodel, graph, g, jargs)
    tmodel = load_flax_params(LightGCL(graph.num_users, graph.num_items, g, prop_fn=tprop),
                              jax.device_get(params))
    tstate = TrainState(tmodel, TG._adam(tmodel, g.lr))
    tstep = TG.make_gnn_step(tstate, graph, g, layout)
    batches = list(TG.sample_bpr_batches(u, i, graph.num_items, 48,
                                         np.random.default_rng(1)))[:3]
    for users, pos, neg in batches:
        jstate, jaux = jstep(jstate, jnp.asarray(users), jnp.asarray(pos), jnp.asarray(neg))
        taux = tstep(torch.as_tensor(users), torch.as_tensor(pos), torch.as_tensor(neg))
        for key, tol in (("loss", 2e-4), ("bpr", 2e-4), ("ssl", 3e-3), ("reg", 1e-5)):
            assert float(taux[key]) == pytest.approx(float(jaux[key]), abs=tol), key
    for name in ("user_emb", "item_emb"):
        assert torch.isfinite(getattr(tmodel, name)).all()
        assert getattr(tmodel, name).grad is not None    # the bf16 backward reached the tables

    # the export and the check propagate in fp32, whatever the trainer's mode
    fu, fi = TG.final_embeddings(tmodel, graph, device="cpu")
    x0 = torch.cat([tmodel.user_emb, tmodel.item_emb]).detach()
    h1 = S.spmm_plain(layout, x0)
    want = ((x0 + h1 + S.spmm_plain(layout, h1)) / 3).numpy()
    np.testing.assert_allclose(np.concatenate([fu, fi]), want, atol=1e-5, rtol=0)


def test_cosine_factor_is_the_optax_schedule():
    sched = optax.cosine_decay_schedule(2e-3, 40, alpha=1e-5 / 2e-3)
    factor = TG._cosine_factor(40, 1e-5 / 2e-3)
    for step in (0, 1, 13, 39, 40, 55):
        assert 2e-3 * factor(step) == pytest.approx(float(sched(step)), rel=1e-5)


def test_train_lightgcl_learns_checkpoints_resumes_and_fine_tunes(tiny_graph, tmp_path):
    graph, u, i = tiny_graph
    seen = []
    state, model = TG.train_lightgcl(CFG, graph, u, i, str(tmp_path), "cpu",
                                     step_hook=seen.append)
    assert seen == list(range(1, 401))                   # the hook runs after every step
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    losses = [r["loss"] for r in recs if r["kind"] == "epoch"]
    assert losses == state.losses and len(losses) == 4
    assert losses[-1] < losses[0]
    assert len(state.step_seconds) == state.step == 4 * 100   # the steps floor
    assert TG.gnn_propagation_check(model, graph, "cpu")["ok"]

    # trained communities: users score their own block's items higher
    fu, fi = TG.final_embeddings(model, graph, device="cpu")
    scores = fu @ fi.T
    assert scores[:20, :15].mean() > scores[:20, 15:].mean()
    # the state_dict and a plain mapping of arrays are accepted alike
    fu2, _ = TG.final_embeddings({k: v.numpy() for k, v in model.state_dict().items()}, graph,
                                 device="cpu")
    np.testing.assert_array_equal(fu, fu2)

    uu, ii = TG.export_gnn_artifacts(model, graph, [f"us{k}" for k in range(40)],
                                     [f"it{k}" for k in range(30)], str(tmp_path / "gnn"),
                                     device="cpu")
    arr, ids, meta = load_array_with_ids(str(tmp_path / "gnn_items"))
    assert arr.shape == (30, 16) and meta == {"pad_row": None, "space": "gnn_dot"}
    assert ids[0] == "it0"                               # no <pad> row

    store = CheckpointStore(str(tmp_path), maximize=False)
    payload, entry = store.restore_latest()
    assert entry["name"] == "ep004" and entry["extra"] == {"epoch": 4}
    assert set(payload) == {"model", "optimizer"}
    assert torch.equal(payload["model"]["user_emb"], model.user_emb.detach())

    # resume: one more epoch on top of the stored model and optimizer state
    cfg5 = dataclasses.replace(CFG, gnn=dataclasses.replace(CFG.gnn, epochs=5))
    state2, model2 = TG.train_lightgcl(cfg5, graph, u, i, str(tmp_path), "cpu", resume=True)
    assert len(state2.losses) == 1 and state2.step == 500
    assert state2.optimizer.state_dict()["state"][0]["step"] == 500   # Adam's count carried on
    # the JAX trainer's count: the resumed run's checkpoint carries its own 100
    # steps, ranks below the first run's three and is rotated out at once
    manifest = CheckpointStore(str(tmp_path)).manifest
    assert [(c["name"], c["step"]) for c in manifest["checkpoints"]] == [
        ("ep002", 200), ("ep003", 300), ("ep004", 400)]
    # so a second resume starts after epoch 4 again
    state3, _ = TG.train_lightgcl(cfg5, graph, u, i, str(tmp_path), "cpu", resume=True)
    assert len(state3.losses) == 1 and state3.step == 500

    # fine-tune: previous weights, fresh optimizer, cosine decay from 0.4 * lr
    before = model2.user_emb.detach().clone()
    state4, model4 = TG.train_lightgcl(cfg5, graph, u, i, str(tmp_path / "ft"), "cpu",
                                       fine_tune=True)
    assert len(state4.losses) == 5                       # no checkpoint there: from scratch
    state5, model5 = TG.train_lightgcl(
        dataclasses.replace(CFG, gnn=dataclasses.replace(CFG.gnn, epochs=1)),
        graph, u, i, str(tmp_path), "cpu", fine_tune=True)
    assert state5.step == 100 and state5.scheduler is not None
    assert state5.optimizer.state_dict()["state"][0]["step"] == 100   # a fresh Adam
    assert state5.scheduler.get_last_lr()[0] == pytest.approx(1e-5, rel=1e-3)
    assert float((model5.user_emb.detach() - before).abs().max()) < 1.0  # started from them
    assert state5.losses[0] < losses[0]


def test_resume_counts_steps_as_the_jax_trainer(tiny_graph, tmp_path):
    """Two epochs, then a resume to four, in both packages: the manifest's
    checkpoint steps and the ``train`` records' steps are the same (each run
    counts its own steps from 0), and the port's ``state.step`` is the JAX
    state's update count."""
    graph, u, i = tiny_graph
    g = dataclasses.replace(CFG.gnn, steps_per_epoch_min=50)
    two = dataclasses.replace(CFG, gnn=dataclasses.replace(g, epochs=2))
    four = dataclasses.replace(CFG, gnn=dataclasses.replace(g, epochs=4))
    runs = {}
    for name, train in (("jax", lambda c, d, **kw: JG.train_lightgcl(c, graph, u, i, d, **kw)),
                        ("port", lambda c, d, **kw: TG.train_lightgcl(c, graph, u, i, d, "cpu",
                                                                      **kw))):
        d = str(tmp_path / name)
        train(two, d)
        state, _ = train(four, d, resume=True)
        manifest = json.load(open(tmp_path / name / "manifest.json"))
        recs = [json.loads(line) for line in open(tmp_path / name / "metrics.jsonl")]
        runs[name] = {"state_step": int(state.step),
                      "checkpoints": [(c["name"], c["step"]) for c in manifest["checkpoints"]],
                      "train_steps": [r["step"] for r in recs if r["kind"] == "train"],
                      "epochs": [r["step"] for r in recs if r["kind"] == "epoch"]}
    assert runs["port"] == runs["jax"]
    assert runs["port"]["train_steps"] == [100, 100] and runs["port"]["state_step"] == 200
    assert runs["port"]["checkpoints"] == [("ep003", 50), ("ep002", 100), ("ep004", 100)]


@pytest.mark.parametrize("hard_frac", [0.0, 0.5])
def test_train_distill_lowers_its_loss(tmp_path, hard_frac):
    rng = np.random.default_rng(3)
    tu = rng.normal(size=(50, 16)).astype(np.float32)
    ti = rng.normal(size=(40, 16)).astype(np.float32)
    ti[:5] *= 4.0                                        # popular items: big magnitude
    cfg = dataclasses.replace(CFG, distill=dataclasses.replace(
        CFG.distill, hard_frac=hard_frac, hard_k=8, batch_size=32))
    state, model = TG.train_distill(cfg, tu, ti, str(tmp_path), "cpu")
    assert len(state.losses) == 6 and np.isfinite(state.losses).all()
    assert state.losses[-1] < 0.7 * state.losses[0]
    si, su = TG.distilled_vectors(model, ti), TG.distilled_vectors(model, tu)
    np.testing.assert_allclose(np.linalg.norm(si, axis=1), 1.0, rtol=1e-4)
    pred = (su @ si.T) * np.exp(float(model.logit_scale.detach()))
    assert np.corrcoef(pred.ravel(), (tu @ ti.T).ravel())[0, 1] > 0.5


def test_hard_mining_draws_the_jax_packages_rows(tmp_path):
    """Same seed, same teacher: both packages mine the same item rows on
    the first step (continuous scores, so the top-k has no ties)."""
    rng = np.random.default_rng(4)
    tu = rng.normal(size=(50, 16)).astype(np.float32)
    ti = rng.normal(size=(40, 16)).astype(np.float32)
    draw = np.random.default_rng(0)
    uu = tu[draw.integers(0, 50, 32)]
    _, jidx = jax.lax.top_k(jnp.asarray(uu) @ jnp.asarray(ti).T, 8)
    tidx = torch.topk(torch.as_tensor(uu) @ torch.as_tensor(ti).T, 8, dim=1).indices
    np.testing.assert_array_equal(np.unique(np.asarray(jidx)), np.unique(tidx.numpy()))


WORLD = ["--set", "data.num_items=120", "--set", "data.num_users=60", "--set", "data.days=40",
         "--set", "gnn.epochs=2", "--set", "gnn.batch_size=256",
         "--set", "gnn.steps_per_epoch_min=20", "--set", "distill.epochs=3",
         "--set", "distill.steps_per_epoch=10", "--set", "user_train.eval_ks=[5,20]"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("gnn_world")
    sets = ["--set", f"data.root={root}", *WORLD, "--device", "cpu"]
    out = {stage: cli.main([stage, *sets])
           for stage in ("gen-data", "etl", "train-gnn", "distill", "gnn-eval")}
    return root, sets, out


def test_cli_stages_write_the_artifacts(world):
    root, _, out = world
    assert out["train-gnn"]["check"]["ok"] and out["train-gnn"]["device"] == "cpu"
    assert out["train-gnn"]["steps"] == 40
    assert out["train-gnn"]["epoch_losses"][1] < out["train-gnn"]["epoch_losses"][0]
    for name, width in (("gnn_users", 64), ("gnn_items", 64),
                        ("gnn_distilled_items", 64), ("gnn_distilled_users", 64)):
        arr, ids, meta = load_array_with_ids(f"{root}/{name}")
        assert arr.shape == (len(ids), width) and np.isfinite(arr).all()
        assert meta["space"] == ("gnn_dot" if "distilled" not in name
                                 else "gnn_cosine_distilled")
    assert out["distill"]["shape"] == [120, 64] and "fidelity" in out["distill"]["fidelity"]
    assert out["gnn-eval"]["n_eval_users"] > 0
    assert out["gnn-eval"]["gnn_dot"]["recall@20"] > 0
    with open(f"{root}/gnn_eval.json") as f:
        assert json.load(f)["gnn_dot"] == out["gnn-eval"]["gnn_dot"]


def test_jax_gnn_eval_reads_the_ports_artifacts_to_the_same_rows(world):
    """Same sidecar format: the JAX package's ``gnn-eval`` stage scores the
    port's artifacts and reports the same recall rows and fidelity."""
    from recsys_tpu.pipeline import cli as jax_cli

    root, sets, out = world
    ref = jax_cli.main(["gnn-eval", *sets[:-2]])       # the JAX CLI has no --device
    got = out["gnn-eval"]
    assert set(ref) == set(got)
    for row in ("gnn_dot", "gnn_cos", "distill_cos", "distill_cos_raw_users", "fidelity"):
        for key, value in ref[row].items():
            assert got[row][key] == pytest.approx(value, abs=1e-9), (row, key)


def test_train_gnn_resume_and_fine_tune_flags(world):
    root, sets, out = world
    again = cli.main(["train-gnn", *sets, "--resume"])
    assert again["steps"] == 40 and again["epoch_losses"] == []   # both epochs were done
    tuned = cli.main(["train-gnn", *sets, "--fine-tune"])
    assert tuned["steps"] == 40 and len(tuned["epoch_losses"]) == 2
    assert tuned["epoch_losses"][0] < out["train-gnn"]["epoch_losses"][0]


@pytest.fixture(scope="module")
def vectors():
    """Random continuous vectors: no two scores tie, so top-k sets and orders
    are comparable. Ties are not compared: ``torch.topk`` does not promise
    ``lax.top_k``'s lowest-index-first order."""
    rng = np.random.default_rng(6)
    return {"users": rng.normal(size=(70, 16)).astype(np.float32),
            "items": rng.normal(size=(90, 16)).astype(np.float32),
            "d_users": rng.normal(size=(70, 16)).astype(np.float32),
            "d_items": rng.normal(size=(90, 16)).astype(np.float32)}


@pytest.mark.parametrize("normalize", [False, True])
def test_topk_rows_match(vectors, normalize):
    for batch in (4096, 32):                              # one chunk, and a ragged tail
        ref = JE.topk_rows(vectors["users"], vectors["items"], 20, normalize, batch=batch)
        got = TE.topk_rows(vectors["users"], vectors["items"], 20, normalize, batch=batch,
                           device="cpu")
        np.testing.assert_array_equal(got, ref)
    assert got.min() >= 1                                 # padded indexing, PAD excluded
    assert TE.topk_rows(vectors["users"][:0], vectors["items"], 5, normalize,
                        device="cpu").shape == (0, 5)
    assert TE.topk_rows(vectors["users"], vectors["items"][:3], 5, normalize,
                        device="cpu").shape == (70, 3)


def test_topk_scores_prior_pad_and_method(vectors):
    from recsys_tpu.eval.recall import topk_scores as jax_topk

    items = np.concatenate([np.zeros((1, 16), np.float32), vectors["items"]])
    prior = np.random.default_rng(7).normal(size=91).astype(np.float32)
    for kw in ({}, {"normalize_items": False}):
        ref_v, ref_i = jax_topk(jnp.asarray(vectors["users"]), jnp.asarray(items), 10,
                                prior=jnp.asarray(prior), **kw)
        got_v, got_i = topk_scores(torch.as_tensor(vectors["users"]), torch.as_tensor(items),
                                   10, prior=torch.as_tensor(prior), **kw)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
        np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), atol=1e-5)
    assert int(got_i.min()) >= 1
    # every column a bin (recall_target 1.0): the approximate top-k is JAX's answer
    ref_v, ref_i = jax_topk(jnp.asarray(vectors["users"]), jnp.asarray(items), 10,
                            method="approx", recall_target=1.0)
    got_v, got_i = topk_scores(torch.as_tensor(vectors["users"]), torch.as_tensor(items), 10,
                               method="approx", recall_target=1.0)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), atol=1e-5)
    with pytest.raises(ValueError):
        topk_scores(torch.as_tensor(vectors["users"]), torch.as_tensor(items), 10,
                    method="ann")


def test_standalone_rows_and_fidelity_match(vectors):
    user_ids = [f"u{k}" for k in range(70)]
    item_ids = [f"i{k}" for k in range(90)]
    rng = np.random.default_rng(8)
    targets = {f"u{k}": [f"i{j}" for j in rng.choice(95, 4, replace=False)]   # some unknown
               for k in range(0, 80, 2)}                                     # some absent users
    kw = dict(ks=(5, 20), distilled_items=vectors["d_items"],
              distilled_users=vectors["d_users"])
    ref = JE.standalone_rows(vectors["users"], user_ids, vectors["items"], item_ids,
                             targets, **kw)
    got = TE.standalone_rows(vectors["users"], user_ids, vectors["items"], item_ids,
                             targets, device="cpu", **kw)
    assert got == ref and got["n_eval_users"] == 35
    assert set(got) == {"n_eval_users", "gnn_dot", "gnn_cos", "distill_cos",
                        "distill_cos_raw_users"}
    args = (vectors["users"], vectors["items"], vectors["d_items"], vectors["d_users"])
    assert TE.distill_fidelity(*args, k=10, sample=30, device="cpu") == JE.distill_fidelity(
        *args, k=10, sample=30)
    assert TE.distill_fidelity(*args[:3], k=10, device="cpu")["sample"] == 70
