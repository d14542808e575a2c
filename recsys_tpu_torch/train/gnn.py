"""LightGCL training / resume / fine-tune + post-hoc export + distillation.

Counterpart of ``recsys_tpu/train/gnn.py``:

  * full-graph forward every step — fp32 graph math at dim 64, BPR +
    clamped SSL InfoNCE + L2 reg. On a CUDA device the propagation is the
    hand-written CSR sparse product (``ops/spmm.py``) in its "bf16" mode, as
    the JAX trainer's, forward and backward: four launches a step at two
    layers; the two SSL losses (users, positive items) are the fused
    contrastive kernel K1 (``models/lightgcl.ssl_loss``): each of its three
    kernels twice a step, on one workspace. There the step (forward,
    backward, Adam) is one CUDA graph replay (``gnn_runner``), as the JAX
    step is one jitted program; so is the distillation step;
  * vectorized host-side rejection sampling for BPR negatives (the JAX
    package's draws, so both packages draw the same batches from the same
    seed; a rejection round probes only the negatives drawn again);
  * model + optimizer + epoch checkpoints, resume, fine-tune with a fresh
    optimizer and cosine decay. Step counting is the JAX trainer's: the
    manifest ``step`` of a checkpoint and the every-100-steps ``train``
    records count the steps of the run that wrote them, from 0 again after
    a ``--resume`` (``recsys_tpu/train/gnn.py`` restarts ``gstep``), while
    ``state.step`` is the optimizer's update count, carried over by a resume
    as the JAX ``TrainState.step`` is. With three checkpoints kept and
    rotated by manifest step, a resumed run's first checkpoints rank below
    the first run's, as in the JAX store;
  * post-hoc n-layer propagation of the trained layer-0 tables for export
    and eval (dot-product recall, not cosine);
  * magnitude->cosine distillation of the teacher's dot scores.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Callable, Mapping

import numpy as np
import torch

from recsys_tpu_torch.config import Config, DistillConfig, GNNConfig
from recsys_tpu_torch.data.dataset import map_each
from recsys_tpu_torch.device import resolve_device
from recsys_tpu_torch.models import flax_init
from recsys_tpu_torch.models.lightgcl import (
    LightGCL,
    MagnitudeEncoder,
    bpr_loss,
    distill_loss,
    reg_loss,
    ssl_loss,
)
from recsys_tpu_torch.ops.graph import (
    BipartiteGraph,
    build_graph,
    make_edge_sharded_propagate,
    propagate,
    propagate_chunked,
)
from recsys_tpu_torch.ops.spmm import CsrGraph, csr_graph, spmm
from recsys_tpu_torch.ops.topk import stable_topk
from recsys_tpu_torch.train.checkpoint import CheckpointStore, save_array_with_ids
from recsys_tpu_torch.train.metrics import MetricWriter
from recsys_tpu_torch.train.state import DeviceLR, StepTimer, TrainState, device_adam
from recsys_tpu_torch.train.step_graph import StepGraph


def transaction_indices(tx_df, user_map: Mapping, item_map: Mapping
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Each transaction's 0-based dense graph user and item index (no PAD
    row); KeyError for an id a map lacks."""
    return (map_each(tx_df["user_id"], user_map.__getitem__, np.int64),
            map_each(tx_df["item_id"], item_map.__getitem__, np.int64))


def graph_from_transactions(tx_df, user_map, item_map, cfg: GNNConfig,
                            seed: int = 0) -> BipartiteGraph:
    """Transactions + id maps -> normalized bipartite COO graph."""
    u, i = transaction_indices(tx_df, user_map, item_map)
    return build_graph(u, i, len(user_map), len(item_map),
                       svd_rank=cfg.svd_rank, svd_iters=cfg.svd_iters, seed=seed)


def edge_key_index(graph_u: np.ndarray, graph_i: np.ndarray,
                   num_items: int) -> np.ndarray:
    """Sorted unique (user*num_items+item) keys for O(log E) membership."""
    return np.unique(graph_u.astype(np.int64) * num_items
                     + graph_i.astype(np.int64))


def _in_edges(sorted_keys: np.ndarray, users: np.ndarray, neg: np.ndarray,
              num_items: int) -> np.ndarray:
    cand = users.astype(np.int64) * num_items + neg.astype(np.int64)
    so = np.argsort(cand, kind="stable")  # ordered probes: fewer cache misses
    pos = np.minimum(np.searchsorted(sorted_keys, cand[so]),
                     len(sorted_keys) - 1)
    out = np.zeros(len(cand), bool)
    out[so] = sorted_keys[pos] == cand[so]
    return out


def bpr_batch_rows(num_edges: int, batch_size: int) -> int:
    """The one batch length ``sample_bpr_batches`` yields: ``batch_size``, or
    every edge on a graph of fewer edges (its single short batch)."""
    return min(batch_size, num_edges)


def sample_bpr_positions(graph_u: np.ndarray, graph_i: np.ndarray, num_items: int,
                         batch_size: int, rng: np.random.Generator,
                         sorted_keys: np.ndarray | None = None):
    """Shuffled (edge positions, rejection-sampled neg) batches over all
    edges: the batch's users and positives are ``graph_u`` and ``graph_i`` at
    those positions. The ragged tail is dropped, except on a graph of fewer
    edges than one batch, whose single short batch is all of them.

    Negative rejection is a searchsorted probe against the sorted edge-key
    array — pure numpy, no Python set membership. A rejection round probes
    only the negatives the round before drew again: the others were found
    off the edges already, so the draws are those of the JAX package's loop,
    which probes the whole batch each round (at 11.3M edges that second
    probe doubled the host's time a batch). Pass ``sorted_keys`` (from
    :func:`edge_key_index`) to amortize the sort across epochs."""
    if sorted_keys is None:
        sorted_keys = edge_key_index(graph_u, graph_i, num_items)
    order = rng.permutation(len(graph_u))
    end = len(order) - len(order) % batch_size
    if end == 0 and len(order) > 0:
        end = len(order)  # single short batch for tiny graphs
    for s in range(0, end, batch_size):
        idx = order[s:s + batch_size]
        users = graph_u[idx]
        neg = rng.integers(0, num_items, size=len(idx))
        fresh = np.arange(len(idx))   # positions whose negative is not probed yet
        for _ in range(10):  # vectorized rejection rounds
            bad = fresh[_in_edges(sorted_keys, users[fresh], neg[fresh], num_items)]
            if not len(bad):
                break
            neg[bad] = rng.integers(0, num_items, size=len(bad))
            fresh = bad
        yield idx, neg


def sample_bpr_batches(graph_u: np.ndarray, graph_i: np.ndarray, num_items: int,
                       batch_size: int, rng: np.random.Generator,
                       sorted_keys: np.ndarray | None = None):
    """Shuffled (users, pos, rejection-sampled neg) int32 batches over all
    edges: ``sample_bpr_positions``' batches, the same draws, with the edges'
    users and positives read out."""
    for idx, neg in sample_bpr_positions(graph_u, graph_i, num_items, batch_size, rng,
                                         sorted_keys):
        yield graph_u[idx].astype(np.int32), graph_i[idx].astype(np.int32), neg.astype(np.int32)


def spmm_bf16(layout: CsrGraph, x: torch.Tensor) -> torch.Tensor:
    """The trainer's sparse product: ``spmm`` in the JAX trainer's "bf16" mode
    (``x`` gathered in bf16, weights and sums in fp32, forward and backward)."""
    return spmm(layout, x, "bf16")


def select_propagation(cfg: GNNConfig, graph: BipartiteGraph, num_nodes: int,
                       device: torch.device | str = "cuda", mesh=None):
    """Pick the propagation backend + its device-resident args.

    ``auto`` -> the CSR sparse-product kernel when ``device`` is a CUDA
    device, the plain gather + ``index_add_`` on the CPU. ``spmm`` -> that
    kernel (its plain form on CPU tensors), in its "bf16" mode as in the JAX
    trainer; the export (``final_embeddings``) stays "f32". ``segment_sum`` ->
    the plain form on either device. ``segment_sum_sharded`` (needs ``mesh``)
    shards the edge list over the mesh's model axis: each shard sums its slice
    on its device, one sum merges on the model's device."""
    device = resolve_device(device)
    mode = cfg.propagation
    if mode == "auto":
        mode = "spmm" if device.type == "cuda" else "segment_sum"
    if mode == "segment_sum_sharded":
        if mesh is None:
            raise ValueError("segment_sum_sharded propagation needs a mesh")
        prop_fn, place_edges = make_edge_sharded_propagate(mesh, num_nodes,
                                                           mesh.axis_names[1])
        return prop_fn, place_edges(graph.src, graph.dst, graph.weight)
    if mode == "spmm":
        layout = csr_graph(graph.src, graph.dst, graph.weight, num_nodes, device=device)
        return spmm_bf16, layout
    if mode != "segment_sum":
        raise ValueError(f"unknown gnn.propagation {cfg.propagation!r}")
    args = (torch.as_tensor(graph.src, device=device).long(),
            torch.as_tensor(graph.dst, device=device).long(),
            torch.as_tensor(graph.weight, device=device))
    return (lambda a, x: propagate(x, a[0], a[1], a[2], num_nodes)), args


def make_gnn_step(state: TrainState, graph: BipartiteGraph, cfg: GNNConfig,
                  prop_args):
    """``step(users, pos, neg) -> {"loss", "bpr", "ssl", "reg"}`` (detached
    device scalars); one optimizer update per call, on the model's device."""
    model = state.model
    device = model.user_emb.device
    svd = tuple(torch.as_tensor(a, device=device)
                for a in (graph.svd_u, graph.svd_s, graph.svd_v))

    def step(users, pos, neg):
        lu, li, gu, gi = model(prop_args, *svd)
        l_bpr = bpr_loss(lu, li, users, pos, neg)
        l_ssl = (ssl_loss(lu, gu, users, cfg.temperature, cfg.logit_clamp)
                 + ssl_loss(li, gi, pos, cfg.temperature, cfg.logit_clamp))
        l_reg = reg_loss(model, users, pos, neg)
        total = l_bpr + cfg.lambda_ssl * l_ssl + cfg.lambda_reg * l_reg
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1
        return {"loss": total.detach(), "bpr": l_bpr.detach(),
                "ssl": l_ssl.detach(), "reg": l_reg.detach()}

    return step


def _cosine_factor(total_steps: int, alpha: float):
    """Multiplier of the base lr: 1 -> ``alpha`` over ``total_steps`` on a
    half cosine, then flat (optax ``cosine_decay_schedule``). Takes an int,
    or a count tensor (the factor is then a tensor on its device, as a
    ``DeviceLR`` wants it)."""
    def factor(step):
        if isinstance(step, torch.Tensor):
            t = step.float().clamp(max=total_steps) / max(total_steps, 1)
            return (1.0 - alpha) * 0.5 * (1.0 + torch.cos(math.pi * t)) + alpha
        t = min(step, total_steps) / max(total_steps, 1)
        return (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t)) + alpha

    return factor


def _adam(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """optax ``adam(lr)`` as a host-driven ``torch.optim.Adam``: the step
    functions' eager reference (the trainers take ``device_adam``)."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def gnn_runner(step_fn, state: TrainState, edges_u: np.ndarray, edges_i: np.ndarray,
               rows: int, device: torch.device, *, capture: bool | None = None) -> StepGraph:
    """``make_gnn_step``'s step through a ``StepGraph``: the edge lists live on
    ``device`` and ``runner({"edge": positions, "neg": negatives})`` gathers
    the batch's users and positives from them inside the step; the negatives
    go through the runner's index ring. Both vectors have ``rows`` entries.
    Captured on the card unless ``capture`` says otherwise."""
    data = {"users": torch.as_tensor(np.asarray(edges_u, np.int32), device=device),
            "pos": torch.as_tensor(np.asarray(edges_i, np.int32), device=device)}

    def step(batch: dict, generator):
        return step_fn(batch["users"], batch["pos"], batch["neg"])

    return StepGraph(step, state, data, {"edge": rows, "neg": rows}, None,
                     gather={"users": "edge", "pos": "edge"}, capture=capture)


def init_lightgcl(num_users: int, num_items: int, cfg: Config,
                  prop_fn: Callable | None = None) -> LightGCL:
    """LightGCL on the host with the JAX package's init for ``cfg.data.seed``
    (``jax.jit(model.init)(PRNGKey(seed))``, ``train_lightgcl``'s)."""
    return flax_init.build(lambda: LightGCL(num_users, num_items, cfg.gnn, prop_fn=prop_fn),
                           flax_init.key(cfg.data.seed))


def init_magnitude_encoder(in_dim: int, d: DistillConfig) -> MagnitudeEncoder:
    """The distill student on the host with the JAX package's init
    (``model.init(PRNGKey(0))``, not jitted: ``train_distill``'s)."""
    return flax_init.build(lambda: MagnitudeEncoder(in_dim, d.hidden_dim, d.out_dim),
                           flax_init.key(0), jitted=False)


def train_lightgcl(cfg: Config, graph: BipartiteGraph, edges_u: np.ndarray,
                   edges_i: np.ndarray, workdir: str,
                   device: torch.device | str = "cuda", *,
                   resume: bool = False, fine_tune: bool = False,
                   writer: MetricWriter | None = None, propagation=None,
                   step_hook: Callable[[int], None] | None = None, mesh=None,
                   capture: bool | None = None):
    """Train (or resume / cosine-fine-tune) LightGCL over the whole edge set.

    Returns ``(state, model)``; ``state.losses`` holds each epoch's mean loss,
    ``state.step_seconds`` each step's time (CUDA events on the card, so
    no step waits for the host), ``state.graph_replays`` the steps run as
    a CUDA graph replay and ``state.init_seconds`` the host time of the
    initial tables (the JAX package's init for ``data.seed``, drawn in
    numpy). ``propagation`` is a ``select_propagation`` result to reuse; by
    default one is built here (``mesh`` goes to it, for
    ``segment_sum_sharded``). ``step_hook(step)`` is called after every step
    (a profiler's switch; it may wait for the card).

    On the card each step is a replay of one CUDA graph (``gnn_runner``,
    after ``step_graph.WARMUP_STEPS`` eager steps), as the JAX step is one
    jitted program: forward, the four sparse products, backward and the Adam
    update (``device_adam``; the fine-tune's cosine schedule a ``DeviceLR``).
    ``capture=False`` runs the same step eagerly; the CPU and the
    edge-sharded propagation always do."""
    g = cfg.gnn
    device = resolve_device(device)
    prop_fn, prop_args = propagation or select_propagation(g, graph, graph.num_nodes,
                                                            device, mesh)
    t0 = time.perf_counter()
    model = init_lightgcl(graph.num_users, graph.num_items, cfg, prop_fn)
    init_seconds = time.perf_counter() - t0
    model = model.to(device)
    passes = max(1, -(-g.steps_per_epoch_min //
                      max(len(edges_u) // g.batch_size, 1)))
    steps_per_epoch = max(len(edges_u) // g.batch_size, 1) * passes
    if g.steps_per_epoch_max:
        steps_per_epoch = min(steps_per_epoch, g.steps_per_epoch_max)

    def fresh_state() -> TrainState:
        if not fine_tune:
            return TrainState(model, device_adam(model, g.lr))
        opt = device_adam(model, g.lr * 0.4)
        sched = DeviceLR(opt, _cosine_factor(steps_per_epoch * g.epochs,
                                             1e-5 / (g.lr * 0.4)))
        return TrainState(model, opt, sched)

    store = CheckpointStore(workdir, maximize=False)
    start_epoch = 1
    restored = store.restore_latest(device) if (resume or fine_tune) else None
    if restored is not None:
        payload, entry = restored
        model.load_state_dict(payload["model"])
    state = fresh_state()  # fine-tune: fresh optimizer, previous params
    state.init_seconds = init_seconds
    if restored is not None and resume:
        state.optimizer.load_state_dict(payload["optimizer"])
        if state.scheduler is not None and "scheduler" in payload:
            state.scheduler.load_state_dict(payload["scheduler"])
        state.step = _updates_done(state.optimizer)
        start_epoch = entry["extra"].get("epoch", 0) + 1
    if capture is None:
        capture = device.type == "cuda" and g.propagation != "segment_sum_sharded"
    runner = gnn_runner(make_gnn_step(state, graph, g, prop_args), state, edges_u, edges_i,
                        bpr_batch_rows(len(edges_u), g.batch_size), device, capture=capture)
    rng = np.random.default_rng(cfg.data.seed)
    sorted_keys = edge_key_index(edges_u, edges_i, graph.num_items)

    gstep = 0   # this run's steps: the manifest's and the records' count
    with contextlib.ExitStack() as stack:
        if writer is None:
            writer = stack.enter_context(contextlib.closing(
                MetricWriter(f"{workdir}/metrics.jsonl", "lightgcl")))
        model.train()
        for epoch in range(start_epoch, g.epochs + 1):
            losses: list = []   # device scalars: a float() per step would
            timer = StepTimer(device)   # make every step wait for the host
            ep_steps = 0
            for _pass in range(passes):   # steps floor: shuffled re-passes
                for edge, neg in sample_bpr_positions(edges_u, edges_i, graph.num_items,
                                                      g.batch_size, rng, sorted_keys):
                    aux = runner({"edge": edge, "neg": neg})
                    losses.append(aux["loss"])
                    timer.mark()
                    ep_steps += 1
                    gstep += 1
                    if step_hook is not None:
                        step_hook(state.step)
                    if gstep % 100 == 0:
                        writer.write("train", gstep, loss=aux["loss"],
                                     bpr=aux["bpr"], ssl=aux["ssl"])
                    if g.steps_per_epoch_max and ep_steps >= steps_per_epoch:
                        break
                if g.steps_per_epoch_max and ep_steps >= steps_per_epoch:
                    break
            mean = float(torch.stack(losses).mean()) if losses else 0.0
            state.step_seconds += timer.seconds()
            state.losses.append(mean)
            writer.write("epoch", epoch, loss=mean)
            payload = {"model": model.state_dict(),
                       "optimizer": state.optimizer.state_dict()}
            if state.scheduler is not None:
                payload["scheduler"] = state.scheduler.state_dict()
            store.save(f"ep{epoch:03d}", payload, step=gstep, metric=mean,
                       extra={"epoch": epoch})
    state.graph_replays = runner.replays
    return state, model


def _updates_done(optimizer: torch.optim.Optimizer) -> int:
    """Adam's update count in a restored optimizer state (0 when empty)."""
    for st in optimizer.state.values():
        return int(st["step"])
    return 0


def _layer0_tables(params) -> tuple[torch.Tensor, torch.Tensor]:
    """``params``: a LightGCL module, or a mapping with ``user_emb`` and
    ``item_emb`` (a state_dict or numpy arrays)."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    return (torch.as_tensor(params["user_emb"]).detach(),
            torch.as_tensor(params["item_emb"]).detach())


@torch.no_grad()
def final_embeddings(params: torch.nn.Module | Mapping, graph: BipartiteGraph,
                     num_layers: int = 2, device: torch.device | str = "cuda",
                     layout: CsrGraph | None = None):
    """Post-hoc n-layer propagation of the trained layer-0 tables (the
    export/eval path) -> (users, items) numpy arrays.

    On a CUDA device the propagation is the CSR sparse-product kernel in its
    "f32" mode, which never builds the (E, D) message array (``layout`` reuses
    the trainer's; otherwise one is built here). On the CPU it is the
    edge-chunked plain form, which bounds that array."""
    device = resolve_device(device)
    user_emb, item_emb = _layer0_tables(params)
    x0 = torch.cat([user_emb, item_emb]).to(device=device, dtype=torch.float32)
    if device.type == "cuda":
        if layout is None:
            layout = csr_graph(graph.src, graph.dst, graph.weight, graph.num_nodes,
                               device=device)

        def prop(x):
            return spmm(layout, x, "f32")
    else:
        def prop(x):
            return propagate_chunked(x, graph.src, graph.dst, graph.weight,
                                     graph.num_nodes)
    acc, x = x0, x0
    for _ in range(num_layers):
        x = prop(x)
        acc = acc + x
    out = (acc / (num_layers + 1)).cpu().numpy()
    return out[: graph.num_users], out[graph.num_users:]


def export_gnn_artifacts(params, graph: BipartiteGraph, user_ids, item_ids,
                         out_prefix: str, num_layers: int = 2,
                         device: torch.device | str = "cuda",
                         layout: CsrGraph | None = None):
    """Save propagated user/item embeddings with id sidecars (graph indices
    are dense 0-based; NO pad row — meta records that)."""
    u, i = final_embeddings(params, graph, num_layers, device, layout)
    save_array_with_ids(out_prefix + "_users", u, list(user_ids),
                        meta={"pad_row": None, "space": "gnn_dot"})
    save_array_with_ids(out_prefix + "_items", i, list(item_ids),
                        meta={"pad_row": None, "space": "gnn_dot"})
    return u, i


def gnn_propagation_check(params, graph: BipartiteGraph,
                          device: torch.device | str = "cuda",
                          layout: CsrGraph | None = None) -> dict:
    """The before/after propagation sanity check as data: propagation must
    change the embedding statistics."""
    before = torch.cat(_layer0_tables(params)).float().cpu().numpy()
    u, i = final_embeddings(params, graph, device=device, layout=layout)
    after = np.concatenate([u, i])
    delta = float(np.abs(after - before).mean())
    return {"mean_abs_delta": delta, "ok": delta > 1e-7}


# -- magnitude -> cosine distillation --------------------------------------

@torch.no_grad()
def mine_hard_items(uu: torch.Tensor, teacher_items: torch.Tensor, k: int) -> torch.Tensor:
    """Distill's hard-pair mining: each user row's top-``k`` teacher items by
    dot score, (B, k) indices, equal scores lowest index first (the JAX
    package's ``mine``, ``jax.lax.top_k``)."""
    return stable_topk(uu @ teacher_items.T, k)[1]


def train_distill(cfg: Config, teacher_users: np.ndarray, teacher_items: np.ndarray,
                  workdir: str, device: torch.device | str = "cuda",
                  writer: MetricWriter | None = None, *, capture: bool | None = None):
    """Distill the teacher's dot-product geometry into a cosine-only space.
    Returns ``(state, model)``; ``state.losses`` holds each epoch's mean,
    ``state.step_seconds`` each step's time and ``state.graph_replays`` the
    steps run as a CUDA graph replay.

    The step gathers its user and item rows from the teacher tables on the
    device (a ``StepGraph`` of two index vectors), so on the card it is one
    CUDA graph replay (``capture=False``: eagerly), as the JAX step is one
    jitted program. The mining is a program of its own, as the JAX package's
    ``mine``: one product and ``mine_hard_items`` on the card, then the host's
    ``np.unique`` of the indices. The loss is read every step, as the JAX
    loop's ``float(loss)``."""
    d = cfg.distill
    device = resolve_device(device)
    model = init_magnitude_encoder(teacher_items.shape[1], d).to(device).train()
    state = TrainState(model, device_adam(model, d.lr))
    tu = torch.as_tensor(teacher_users, dtype=torch.float32, device=device)
    ti = torch.as_tensor(teacher_items, dtype=torch.float32, device=device)

    def step(batch: dict, generator):
        uu, ii = batch["uu"], batch["ii"]
        su, scale = model(uu)
        si, _ = model(ii)
        loss = distill_loss(su, si, scale, uu, ii)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    rng = np.random.default_rng(0)
    bs = min(d.batch_size, len(teacher_users), len(teacher_items))
    if capture is None:
        capture = device.type == "cuda"
    runner = StepGraph(step, state, {"uu": tu, "ii": ti}, {"user": bs, "item": bs}, None,
                       gather={"uu": "user", "ii": "item"}, capture=capture)
    # teacher-top-k hard-pair mining (cfg.distill.hard_frac): without it
    # the item batch is uniform over the catalog, so the pairs that decide
    # top-100 ordering are a sliver of the MSE mass and the student never
    # learns the tail
    n_hard = int(bs * min(max(d.hard_frac, 0.0), 1.0))
    mine_k = min(d.hard_k, ti.shape[0])
    timer = StepTimer(device)
    with contextlib.ExitStack() as stack:
        if writer is None:
            writer = stack.enter_context(contextlib.closing(
                MetricWriter(f"{workdir}/metrics.jsonl", "distill")))
        for epoch in range(1, d.epochs + 1):
            tot = 0.0
            for _ in range(max(d.steps_per_epoch, 1)):
                users = rng.integers(0, len(teacher_users), bs)
                if n_hard:
                    mined = mine_hard_items(tu[torch.as_tensor(users, device=device)], ti,
                                            mine_k)
                    pool = np.unique(mined.cpu().numpy())
                    items = np.concatenate([
                        pool[rng.integers(0, len(pool), n_hard)],
                        rng.integers(0, len(teacher_items), bs - n_hard)])
                else:
                    items = rng.integers(0, len(teacher_items), bs)
                tot += float(runner({"user": users, "item": items}))
                timer.mark()
            state.losses.append(tot / max(d.steps_per_epoch, 1))
            writer.write("epoch", epoch, loss=state.losses[-1])
    state.step_seconds = timer.seconds()
    state.graph_replays = runner.replays
    return state, model


@torch.no_grad()
def distilled_vectors(model: MagnitudeEncoder, vecs: np.ndarray) -> np.ndarray:
    device = next(model.parameters()).device
    out, _ = model(torch.as_tensor(vecs, dtype=torch.float32, device=device))
    return out.cpu().numpy()
