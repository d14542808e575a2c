"""The trainers whose step is one CUDA graph on the card (LightGCL, distill,
the neural rerankers), on the CPU, where the same step runs eagerly through
``StepGraph(capture=False)``.

Each trainer is held against the eager loop it replaced, kept here as the
reference: the same batches from the same seeds, with ``torch.optim.Adam``
(and ``LambdaLR`` for the fine-tune's cosine schedule) driven from the host.
The trainers now update through ``device_adam``, whose learning rate is a
float32 tensor: the step size rounds in float32 where ``torch.optim.Adam``
rounds a host double, so weights part in the last bits and the losses follow.
Losses and parameters are held to 1e-6 (absolute, or relative where the
value is large), a few float32 ulps of the values over the steps run here.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import recsys_tpu_torch.train.gnn as TG
import recsys_tpu_torch.train.reranker as TR
from recsys_tpu_torch.config import (
    Config,
    DataConfig,
    DistillConfig,
    GNNConfig,
    RerankerConfig,
)
from recsys_tpu_torch.models.lightgcl import distill_loss
from recsys_tpu_torch.models.reranker import DCNRanker, DeepFM
from recsys_tpu_torch.ops.graph import build_graph
from recsys_tpu_torch.train.checkpoint import CheckpointStore
from recsys_tpu_torch.train.state import TrainState
from recsys_tpu_torch.train.step_graph import StepGraph

TOL = 1e-6
CFG = Config(
    data=DataConfig(seed=5),
    gnn=GNNConfig(emb_dim=16, num_layers=2, svd_rank=4, batch_size=48, epochs=2,
                  lr=5e-3, steps_per_epoch_min=8, propagation="spmm", spmm_block_n=128),
    distill=DistillConfig(hidden_dim=32, out_dim=16, epochs=2, steps_per_epoch=4,
                          batch_size=16, lr=3e-3, hard_k=6),
    reranker=RerankerConfig(cross_layers=2, deep_hidden=(16, 8), fm_embed_dim=4,
                            batch_size=24, epochs=2),
)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_graph():
    """Two communities of users and items, 240 edges."""
    rng = np.random.default_rng(0)
    nu, ni = 40, 30
    e = np.array([(u, i) for u in range(nu)
                  for i in rng.choice(15, size=6, replace=False) + (0 if u < 20 else 15)])
    graph = build_graph(e[:, 0], e[:, 1], nu, ni, svd_rank=4, pad_multiple=64)
    return graph, e[:, 0], e[:, 1]


def assert_close(got, want, rel: bool = False):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want), 1.0) if rel else 1.0
    assert (np.abs(got - want) <= TOL * scale).all(), float(np.abs(got - want).max())


def assert_params_close(model, ref_model, free: tuple = ()):
    """Every parameter within 1e-6 (relative above 1) but those in ``free``,
    which the loss does not depend on."""
    for (name, p), q in zip(model.state_dict().items(), ref_model.state_dict().values()):
        assert p.shape == q.shape, name
        if name not in free:
            assert_close(p.float().numpy(), q.float().numpy(), rel=True)


# -- StepGraph with several index vectors ---------------------------------------------

def test_step_graph_named_vectors_eager_is_the_step_on_its_batch():
    """Two tables of different lengths, gathered by two vectors, and a third
    vector handed to the step as it is: the runner's eager path gives the
    same bits as the step called on the batch gathered by hand."""
    rng = np.random.default_rng(1)
    users, items = torch.randn(30, 4), torch.randn(50, 4)

    def step(batch, generator):
        return (batch["u"] * batch["i"]).sum(-1) + batch["neg"].float()

    runner = StepGraph(step, None, {"u": users, "i": items}, {"user": 6, "item": 6, "neg": 6},
                       None, gather={"u": "user", "i": "item"}, capture=False)
    for _ in range(3):
        idx = {"user": rng.integers(0, 30, 6), "item": rng.integers(0, 50, 6),
               "neg": rng.integers(0, 50, 6).astype(np.int32)}
        want = step({"u": users[idx["user"]], "i": items[idx["item"]],
                     "neg": torch.as_tensor(idx["neg"], dtype=torch.int64)}, None)
        assert torch.equal(runner(idx), want)
    assert runner.replays == 0
    with pytest.raises(ValueError, match="a batch of"):
        runner({"user": np.zeros(5, np.int64), "item": np.zeros(6, np.int64),
                "neg": np.zeros(6, np.int64)})
    with pytest.raises(ValueError, match="index vectors"):
        runner({"user": np.zeros(6, np.int64), "item": np.zeros(6, np.int64)})
    with pytest.raises(ValueError, match="gather"):
        StepGraph(step, None, {"u": users}, {"user": 6}, None, gather={}, capture=False)
    with pytest.raises(ValueError, match="share a name"):
        StepGraph(step, None, {"u": users}, {"u": 6}, None, gather={"u": "u"}, capture=False)
    one = StepGraph(lambda b, g: b["u"].sum(0), None, {"u": users}, 6, None, capture=False)
    with pytest.raises(ValueError, match="a batch of"):
        one(np.arange(5))


# -- LightGCL ---------------------------------------------------------------------

def eager_lightgcl(cfg, graph, u, i, *, fine_tune=False, start=None, epochs=None):
    """The eager trainer the captured one replaced: ``torch.optim.Adam`` (a cosine
    ``LambdaLR`` in the fine-tune) stepped from the host, the batch's users,
    positives and negatives sent as tensors. ``start``: a (model, optimizer)
    state to resume from. Returns (epoch losses, model, optimizer)."""
    g = cfg.gnn
    prop_fn, prop_args = TG.select_propagation(g, graph, graph.num_nodes, "cpu")
    model = TG.init_lightgcl(graph.num_users, graph.num_items, cfg, prop_fn)
    passes = max(1, -(-g.steps_per_epoch_min // max(len(u) // g.batch_size, 1)))
    steps_per_epoch = max(len(u) // g.batch_size, 1) * passes
    lr = g.lr * 0.4 if fine_tune else g.lr
    opt = TG._adam(model, lr)
    sched = (torch.optim.lr_scheduler.LambdaLR(
        opt, TG._cosine_factor(steps_per_epoch * g.epochs, 1e-5 / lr)) if fine_tune else None)
    if start is not None:
        model.load_state_dict(start[0])
        opt.load_state_dict(start[1])
    state = TrainState(model, opt, sched)
    step = TG.make_gnn_step(state, graph, g, prop_args)
    rng = np.random.default_rng(cfg.data.seed)
    keys = TG.edge_key_index(u, i, graph.num_items)
    losses = []
    for _ in range(epochs or g.epochs):
        ep = []
        for _pass in range(passes):
            for users, pos, neg in TG.sample_bpr_batches(u, i, graph.num_items, g.batch_size,
                                                         rng, keys):
                ep.append(float(step(torch.as_tensor(users), torch.as_tensor(pos),
                                     torch.as_tensor(neg))["loss"]))
        losses.append(float(np.mean(ep)))
    return losses, model, opt


def test_sample_bpr_positions_are_the_batches_draws(tiny_graph):
    graph, u, i = tiny_graph
    got = list(TG.sample_bpr_positions(u, i, graph.num_items, 48, np.random.default_rng(2)))
    ref = list(TG.sample_bpr_batches(u, i, graph.num_items, 48, np.random.default_rng(2)))
    assert len(got) == len(ref) == 5
    for (edge, neg), (users, pos, rneg) in zip(got, ref):
        np.testing.assert_array_equal(u[edge], users)
        np.testing.assert_array_equal(i[edge], pos)
        np.testing.assert_array_equal(neg, rneg)
    assert TG.bpr_batch_rows(len(u), 48) == 48 and TG.bpr_batch_rows(len(u), 1000) == len(u)
    (short,) = TG.sample_bpr_positions(u, i, graph.num_items, 1000, np.random.default_rng(2))
    assert len(short[0]) == len(u)                       # a graph smaller than one batch


@pytest.mark.parametrize("fine_tune", [False, True], ids=["train", "fine_tune"])
def test_train_lightgcl_is_the_eager_loop(tiny_graph, tmp_path, fine_tune):
    """Two epochs of 10 steps (two passes of five batches), the trainer's
    default on the CPU (the runner, eager) against the replaced loop: epoch
    losses and tables within 1e-6; the fine-tune's schedule (a ``DeviceLR``)
    ends at the same learning rate as the ``LambdaLR``."""
    graph, u, i = tiny_graph
    state, model = TG.train_lightgcl(CFG, graph, u, i, str(tmp_path), "cpu",
                                     fine_tune=fine_tune)
    ref_losses, ref_model, ref_opt = eager_lightgcl(CFG, graph, u, i, fine_tune=fine_tune)
    assert state.step == 20 and state.graph_replays == 0 and len(state.step_seconds) == 20
    assert_close(state.losses, ref_losses)
    assert_params_close(model, ref_model)
    moved = float((model.user_emb.detach() - eager_lightgcl(
        dataclasses.replace(CFG, gnn=dataclasses.replace(CFG.gnn, epochs=0)),
        graph, u, i)[1].user_emb.detach()).abs().max())
    assert moved > 1e-3                                   # the steps did move the tables
    if fine_tune:
        assert state.scheduler.get_last_lr()[0] == pytest.approx(
            ref_opt.param_groups[0]["lr"], rel=1e-6)


def test_resume_continues_an_eager_trainers_checkpoint(tiny_graph, tmp_path):
    """A checkpoint as the eager trainer wrote it (a ``torch.optim.Adam``
    state) is resumed by ``train_lightgcl``: the count carries on and the
    epoch after it is the eager loop's resumed epoch."""
    graph, u, i = tiny_graph
    one = dataclasses.replace(CFG, gnn=dataclasses.replace(CFG.gnn, epochs=1))
    losses, model, opt = eager_lightgcl(one, graph, u, i)
    CheckpointStore(str(tmp_path), maximize=False).save(
        "ep001", {"model": model.state_dict(), "optimizer": opt.state_dict()},
        step=10, metric=losses[0], extra={"epoch": 1})
    start = (model.state_dict(), opt.state_dict())
    state, resumed = TG.train_lightgcl(CFG, graph, u, i, str(tmp_path), "cpu", resume=True)
    ref_losses, ref_model, ref_opt = eager_lightgcl(CFG, graph, u, i, start=start, epochs=1)
    assert len(state.losses) == 1 and state.step == 20
    assert int(state.optimizer.param_groups[0]["updates"]) == 20
    assert int(state.optimizer.state_dict()["state"][0]["step"]) == 20
    assert_close(state.losses, ref_losses)
    assert_params_close(resumed, ref_model)


# -- distill ---------------------------------------------------------------------

def eager_distill(cfg, tu, ti):
    """The replaced distill loop: host Adam, rows sent as tensors, the mining
    with ``torch.topk`` (no ties in these continuous scores)."""
    d = cfg.distill
    model = TG.init_magnitude_encoder(ti.shape[1], d)
    opt = TG._adam(model, d.lr)
    tu, ti = torch.as_tensor(tu), torch.as_tensor(ti)
    rng = np.random.default_rng(0)
    bs = min(d.batch_size, len(tu), len(ti))
    n_hard = int(bs * min(max(d.hard_frac, 0.0), 1.0))
    losses = []
    for _ in range(d.epochs):
        tot = 0.0
        for _ in range(d.steps_per_epoch):
            uu = tu[torch.as_tensor(rng.integers(0, len(tu), bs))]
            if n_hard:
                pool = np.unique(torch.topk(uu @ ti.T, min(d.hard_k, len(ti)), dim=1)
                                 .indices.numpy())
                rows = np.concatenate([pool[rng.integers(0, len(pool), n_hard)],
                                       rng.integers(0, len(ti), bs - n_hard)])
            else:
                rows = rng.integers(0, len(ti), bs)
            ii = ti[torch.as_tensor(rows)]
            su, scale = model(uu)
            si, _ = model(ii)
            loss = distill_loss(su, si, scale, uu, ii)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            tot += float(loss)
        losses.append(tot / d.steps_per_epoch)
    return losses, model


@pytest.mark.parametrize("hard_frac", [0.0, 0.5])
def test_train_distill_is_the_eager_loop(tmp_path, hard_frac):
    rng = np.random.default_rng(3)
    tu = rng.normal(size=(50, 16)).astype(np.float32)
    ti = rng.normal(size=(40, 16)).astype(np.float32)
    cfg = dataclasses.replace(CFG, distill=dataclasses.replace(CFG.distill,
                                                               hard_frac=hard_frac))
    state, model = TG.train_distill(cfg, tu, ti, str(tmp_path), "cpu")
    ref_losses, ref_model = eager_distill(cfg, tu, ti)
    assert state.step == 8 and state.graph_replays == 0 and len(state.step_seconds) == 8
    assert_close(state.losses, ref_losses, rel=True)
    assert_params_close(model, ref_model)


# -- the neural rerankers -----------------------------------------------------------

def eager_fit(model, parts, y, cfg, apply_fn, groups=None):
    """The replaced ``_fit_batches``: host Adam, each batch's rows sent as a
    tensor; BCE, or the pairwise loss over (G, S) groups."""
    opt = torch.optim.Adam(model.parameters(), lr=cfg.reranker.lr, betas=(0.9, 0.999),
                           eps=1e-8)
    parts = tuple(torch.as_tensor(x) for x in parts)
    rng = np.random.default_rng(0)
    if groups is None:
        n = len(y)
        bs = min(cfg.reranker.batch_size, n)
        labels = np.asarray(y, np.float32)

        def batches():
            order = rng.permutation(n)
            for s in range(0, n - n % bs, bs):
                yield order[s:s + bs], labels[order[s:s + bs]]

        def loss_fn(batch, target):
            return F.binary_cross_entropy_with_logits(apply_fn(batch), target)
    else:
        order = np.argsort(groups, kind="stable")
        S = int(np.unique(groups[order], return_counts=True)[1][0])
        idx_mat, pos_mask = order.reshape(-1, S), (y[order].reshape(-1, S) == 1)
        G = idx_mat.shape[0]
        gb = max(1, min(cfg.reranker.batch_size // S, G))

        def batches():
            gorder = rng.permutation(G)
            for s in range(0, G - G % gb, gb):
                yield idx_mat[gorder[s:s + gb]].reshape(-1), pos_mask[gorder[s:s + gb]]

        def loss_fn(batch, pos_m):
            logits = apply_fn(batch).reshape(pos_m.shape)
            pos = torch.where(pos_m, logits, 0.0).sum(dim=1, keepdim=True)
            pair = F.softplus(logits - pos)
            return torch.where(pos_m, 0.0, pair).sum() / (~pos_m).sum().clamp(min=1)

    losses = []
    for _ in range(cfg.reranker.epochs):
        ep = []
        for rows, target in batches():
            loss = loss_fn(tuple(x[torch.as_tensor(rows)] for x in parts),
                           torch.as_tensor(target))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            ep.append(float(loss))
        losses.append(float(np.mean(ep)))
    return losses


@pytest.fixture(scope="module")
def rank_rows():
    """120 rows in 20 groups of 1 positive + 5 negatives, 6 dense features
    and 4 sparse fields."""
    rng = np.random.default_rng(4)
    groups = np.repeat(np.arange(20), 6)
    y = np.tile([1, 0, 0, 0, 0, 0], 20)
    X = (rng.normal(size=(120, 6)) + y[:, None] * 0.8).astype(np.float32)
    sizes = (7, 5, 9, 4)
    ids = np.stack([rng.integers(0, s, 120) for s in sizes], 1).astype(np.int32)
    return {"X": X, "y": y, "groups": groups, "ids": ids, "sizes": sizes}


@pytest.mark.parametrize("loss", ["bce", "pairwise"])
def test_train_dcn_is_the_eager_loop(rank_rows, loss):
    cfg = dataclasses.replace(CFG, reranker=dataclasses.replace(CFG.reranker, loss=loss))
    X, y, groups = rank_rows["X"], rank_rows["y"], rank_rows["groups"]
    state, model, scorer = TR.train_dcn(cfg, X, y, groups=groups, device="cpu")
    Xs = ((X - X.mean(0, keepdims=True)) / (X.std(0, keepdims=True) + 1e-6)).astype(np.float32)
    ref = TR._new_model(lambda: DCNRanker(X.shape[1], cfg.reranker), torch.device("cpu"), 0,
                        None)
    ref_losses = eager_fit(ref, (Xs,), y, cfg, lambda b: ref(b[0]),
                           groups=groups if loss == "pairwise" else None)
    steps = 2 * 5                                     # 120 // 24 rows, or 20 // 4 groups
    assert state.step == steps and state.graph_replays == 0
    assert len(state.step_seconds) == steps
    assert_close(state.losses, ref_losses)
    if loss == "pairwise":
        # the output bias cancels in (logits - pos): its gradient is rounding
        # noise, which Adam scales to steps of up to ~lr, so once the weights
        # part in their last bits it wanders; it moves no loss and no ranking
        assert_params_close(model, ref, free=("score.bias",))
        gap = float((model.score.bias - ref.score.bias).abs().max())
        assert gap <= cfg.reranker.lr * steps
    else:
        assert_params_close(model, ref)
    assert scorer(X[:3]).shape == (3,)


def test_train_deepfm_is_the_eager_loop(rank_rows):
    ids, X, y = rank_rows["ids"], rank_rows["X"], rank_rows["y"]
    state, model, scorer = TR.train_deepfm(CFG, ids, X, y, rank_rows["sizes"], device="cpu")
    ref = TR._new_model(lambda: DeepFM(rank_rows["sizes"], CFG.reranker, num_dense=6),
                        torch.device("cpu"), 0, None)
    ref_losses = eager_fit(ref, (ids, X), y, CFG, lambda b: ref(*b))
    assert state.step == 10 and state.graph_replays == 0
    assert_close(state.losses, ref_losses)
    assert_params_close(model, ref)
    assert scorer(ids[:3], X[:3]).shape == (3,)
