"""Hybrid (content + GNN) user-tower training and ensemble evaluation.

Counterpart of ``recsys_tpu/train/hybrid.py``: align the stage-1 content
vectors and the GNN artifacts to the stage-2 id order
(``train/checkpoint.align_rows``), train ``models/hybrid_tower.HybridUserTower``
with the positive-recovery LogQ loss
(``ops/contrastive.corrected_logq_with_recovery``, plain PyTorch: the JAX
trainer runs no Pallas kernel here either) under its learnable CLIP scale,
then evaluate the sequence model, the GNN standalone and their count-mix /
weighted / RRF ensembles (``eval/ensemble.py``).

One step: random-cut augmentation, the tower's train forward (dropout and the
per-user GNN keep mask), the targets' adapted item vectors, the loss, then
``GroupedAdamW`` (global-norm clip, AdamW, the slow modules' lr factor) under
``state.hybrid_schedule``, computed on the device (``state.DeviceLR``). Every
random draw of a step comes from one ``torch.Generator``; ``draws`` may fix
the cut (``"cut"``: gate, cut) and the GNN keep mask (``"gnn_keep"``: (B, 1)
bool), so that a test can replay the JAX step's. The tower is built without
``num_layers`` (the class default, 4), as the JAX trainer builds it.

``train_hybrid`` runs its steps through ``train/step_graph.StepGraph``
(``hybrid_runner``): the GNN user matrix is one of the device data's keys, so
its rows are gathered with the batch's, and on the card the step is one CUDA
graph replayed once a batch, as the JAX step is one jitted program
(``recsys_tpu/train/hybrid.py:82``); on the CPU the same step runs eagerly.
The eval forward and the item matrix stay eager.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from recsys_tpu_torch.config import Config
from recsys_tpu_torch.data.dataset import batch_iterator
from recsys_tpu_torch.device import resolve_device
from recsys_tpu_torch.eval.ensemble import alpha_sweep
from recsys_tpu_torch.eval.recall import recall_at_ks, target_rows, topk_scores
from recsys_tpu_torch.models.hybrid_tower import HybridUserTower
from recsys_tpu_torch.models.layers import l2_normalize
from recsys_tpu_torch.ops.augment import apply_random_cut, random_cut_draws
from recsys_tpu_torch.ops.contrastive import corrected_logq_with_recovery
from recsys_tpu_torch.parallel.mesh import Mesh
from recsys_tpu_torch.train.checkpoint import CheckpointStore, align_rows, snapshot_due
from recsys_tpu_torch.train.metrics import MetricWriter
from recsys_tpu_torch.train.sasrec import _slice, tensors_to
from recsys_tpu_torch.train.state import (
    DeviceLR, StepTimer, TrainState, grouped_adamw, hybrid_schedule)
from recsys_tpu_torch.train.step_graph import StepGraph


def align_gnn_to_catalog(gnn_vecs: np.ndarray, gnn_ids: list[str], item_map) -> np.ndarray:
    """(G, Dg) GNN item artifact -> (N+1, Dg) aligned to model indexing
    (PAD row 0 zeros; missing items random-init)."""
    aligned, _ = align_rows(gnn_vecs, gnn_ids, item_map.ids, fill="random")
    return np.concatenate([np.zeros((1, gnn_vecs.shape[1]), np.float32),
                           aligned.astype(np.float32)])


def align_gnn_users(gnn_vecs: np.ndarray, gnn_ids: list[str], user_ids: list[str]) -> np.ndarray:
    aligned, _ = align_rows(gnn_vecs, gnn_ids, user_ids, fill="zero")
    return aligned.astype(np.float32)


def build_hybrid_model(cfg: Config, num_items_pad: int, content_dim: int, gnn_dim: int,
                       device: torch.device | str = "cuda", seed: int = 0) -> HybridUserTower:
    """The tower the trainer builds (the class default of 4 layers), seeded,
    on ``device``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = HybridUserTower(cfg.user_tower, num_id_embeddings=num_items_pad,
                                content_dim=content_dim, gnn_dim=gnn_dim)
    return model.to(resolve_device(device))


def make_hybrid_optimizer(ut, model: HybridUserTower, total_steps: int):
    """(optimizer, scheduler): AdamW behind the global-norm clip, the modules
    of ``hybrid_slow_modules`` at ``hybrid_slow_scale`` of the update, the
    learning rate ``hybrid_schedule`` of ``hybrid_lr or lr`` on the device."""
    base_lr = ut.hybrid_lr or ut.lr
    slow = set(ut.hybrid_slow_modules) if ut.hybrid_slow_scale != 1.0 else set()
    opt = grouped_adamw(model, lambda name: "slow" if name.split(".")[0] in slow else "base",
                        {"base": base_lr, "slow": base_lr}, ut.weight_decay,
                        grad_clip=ut.grad_clip, lr_factors={"slow": ut.hybrid_slow_scale})
    sched = hybrid_schedule(base_lr, ut.hybrid_warmup_steps, ut.hybrid_lr_decay, total_steps)
    return opt, DeviceLR(opt, lambda count: sched(count) / base_lr)


def make_hybrid_step(cfg: Config, state: TrainState, content: np.ndarray,
                     gnn_items: np.ndarray, logq: np.ndarray):
    """``(step, user_vectors, item_matrix)``: ``step(batch, gnn_user,
    generator, draws=None)`` runs one update and returns the detached loss;
    ``user_vectors(batch, gnn_user)`` is the eval forward (B, D);
    ``item_matrix()`` the L2-normalized adapted catalog (N+1, D)."""
    ut = cfg.user_train
    model = state.model
    device = next(model.parameters()).device
    content_c = torch.as_tensor(np.asarray(content, np.float32), device=device)
    gnn_c = torch.as_tensor(np.asarray(gnn_items, np.float32), device=device)
    logq_c = torch.as_tensor(np.asarray(logq, np.float32), device=device)

    def forward(batch, gnn_user, generator=None, gnn_keep=None):
        ids = batch["input_ids"]
        return model(content_c[ids], gnn_c[ids], ids, batch["time_buckets"],
                     batch["seq_mask"], gnn_user, batch["user_buckets"], batch["user_cats"],
                     batch["user_cont"], generator=generator, gnn_keep=gnn_keep)

    def loss_fn(batch, gnn_user, generator, draws):
        if ut.random_cut_prob > 0:
            cut = draws.get("cut")
            if cut is None:
                cut = random_cut_draws(batch["seq_mask"], ut.random_cut_prob, generator)
            batch = apply_random_cut(batch, *cut)
        u = forward(batch, gnn_user, generator, draws.get("gnn_keep"))
        tgt_ids = batch["target_ids"][:, -1]
        tgt = l2_normalize(model.adapt_items(content_c[tgt_ids], gnn_c[tgt_ids]))
        return corrected_logq_with_recovery(u, tgt, tgt_ids, logq_c, model.logit_scale,
                                            lambda_logq=ut.lambda_logq)

    def step(batch: dict, gnn_user: torch.Tensor, generator: torch.Generator | None = None,
             draws: dict | None = None) -> dict:
        model.train()
        loss = loss_fn(batch, gnn_user, generator, draws or {})
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1
        return {"loss": loss.detach()}

    @torch.no_grad()
    def user_vectors(batch: dict, gnn_user: torch.Tensor) -> torch.Tensor:
        model.eval()
        return forward(batch, gnn_user)

    @torch.no_grad()
    def item_matrix() -> torch.Tensor:
        return l2_normalize(model.adapt_items(content_c, gnn_c))

    return step, user_vectors, item_matrix


def hybrid_runner(step_fn, state: TrainState, dev_tensors: dict, gnn_users: torch.Tensor,
                  batch_size: int, generator: torch.Generator | None,
                  capture: bool | None = None) -> StepGraph:
    """``make_hybrid_step``'s step through a ``StepGraph`` over the stage-2
    tensors and the GNN user rows (aligned to them): ``runner(idx, draws=None)``
    gathers the rows ``idx`` of both inside the step. Captured on the card
    unless ``capture`` says otherwise."""
    def step(batch: dict, generator: torch.Generator | None, draws: dict | None = None):
        batch = dict(batch)
        return step_fn(batch, batch.pop("gnn_user"), generator, draws)

    return StepGraph(step, state, {**dev_tensors, "gnn_user": gnn_users}, batch_size,
                     generator, capture=capture)


def _batch_size(cfg: Config, n: int) -> int:
    return min(cfg.user_train.batch_size, max(n - n % 8, 8))


def hybrid_user_vectors(uv_fn, dev_tensors: dict, gnn_users: torch.Tensor, rows,
                        bs: int) -> torch.Tensor:
    """The eval forward over ``rows`` of the tensors, ``bs`` at a time, the
    last batch padded with row 0 to ``bs`` (and its padding dropped)."""
    rows = np.asarray(rows, np.int64)
    out = []
    for s in range(0, len(rows), bs):
        idx = rows[s:s + bs]
        n = len(idx)
        if n < bs:
            idx = np.concatenate([idx, np.zeros(bs - n, np.int64)])
        ix = torch.as_tensor(idx, device=gnn_users.device)
        out.append(uv_fn(_slice(dev_tensors, idx), gnn_users[ix])[:n])
    if not out:
        return torch.zeros(0, 0, device=gnn_users.device)
    return torch.cat(out)


def hybrid_eval(cfg: Config, uv_fn, im_fn, data: dict, gnn_users: torch.Tensor, bs: int,
                dev_tensors: dict, mesh: Mesh | None = None) -> dict:
    """Recall@ks over the users with validation targets only; the item matrix
    is computed once."""
    tensors, targets = data["tensors"], data["targets_idx"]
    rows = target_rows(tensors["user_ids"], targets)
    max_k = max(cfg.user_train.eval_ks)
    if not len(rows):
        return recall_at_ks(np.zeros((0, max_k), np.int64), [], targets,
                            cfg.user_train.eval_ks)
    im = im_fn()
    idx = []
    for s in range(0, len(rows), bs):
        u = hybrid_user_vectors(uv_fn, dev_tensors, gnn_users, rows[s:s + bs], bs)
        idx.append(topk_scores(u, im, max_k, mesh=mesh, normalize_items=False)[1].cpu())
    uids = [tensors["user_ids"][r] for r in rows]
    return recall_at_ks(torch.cat(idx).numpy(), uids, targets, cfg.user_train.eval_ks)


def train_hybrid(cfg: Config, data: dict, content: np.ndarray, gnn_items: np.ndarray,
                 gnn_users: np.ndarray, workdir: str, device: torch.device | str = "cuda",
                 mesh: Mesh | None = None, writer: MetricWriter | None = None):
    """data: ``sasrec.prepare_stage2`` output; content (N+1, Dc); gnn_items
    (N+1, Dg); gnn_users aligned to ``data["tensors"]["user_ids"]``. Returns
    ``(state, history, (model, user_vectors, item_matrix))`` with the best
    checkpoint (by Recall@100) restored; ``state.graph_replays`` counts the
    steps run as a CUDA graph replay."""
    ut = cfg.user_train
    device = resolve_device(device)
    tensors = data["tensors"]
    n = tensors["input_ids"].shape[0]
    bs = _batch_size(cfg, n)
    model = build_hybrid_model(cfg, len(data["item_map"]) + 1, content.shape[1],
                               gnn_items.shape[1], device, seed=cfg.data.seed)
    # small worlds: several shuffled passes an epoch (hybrid_steps_per_epoch_min)
    passes = max(1, -(-ut.hybrid_steps_per_epoch_min // max(n // bs, 1)))
    opt, sched = make_hybrid_optimizer(ut, model, passes * max(n // bs, 1) * ut.epochs)
    state = TrainState(model, opt, sched)
    step_fn, uv_fn, im_fn = make_hybrid_step(cfg, state, content, gnn_items, data["logq"])
    store = CheckpointStore(workdir, maximize=True)
    dev_tensors = tensors_to(tensors, device)
    gnn_dev = torch.as_tensor(np.asarray(gnn_users, np.float32), device=device)
    rng = np.random.default_rng(cfg.data.seed + 2)
    gen = torch.Generator(device).manual_seed(cfg.data.seed)
    runner = hybrid_runner(step_fn, state, dev_tensors, gnn_dev, bs, gen)
    gstep, history, best_metric = 0, [], -float("inf")
    with contextlib.ExitStack() as stack:
        if writer is None:
            writer = stack.enter_context(contextlib.closing(
                MetricWriter(f"{workdir}/metrics.jsonl", "hybrid")))
        for epoch in range(1, ut.epochs + 1):
            timer, losses = StepTimer(device), []
            for _pass in range(passes):
                for idx in batch_iterator(n, bs, rng):
                    aux = runner(idx)
                    timer.mark()
                    losses.append(aux["loss"])
                    gstep += 1
                    if gstep % 50 == 0:
                        writer.write("train", gstep, loss=float(aux["loss"]),
                                     logit_scale=model.logit_scale.item())
            state.step_seconds += timer.seconds()
            state.losses.append(float(torch.stack(losses).mean()) if losses else 0.0)
            metrics = hybrid_eval(cfg, uv_fn, im_fn, data, gnn_dev, bs, dev_tensors, mesh)
            writer.write("eval", epoch, **metrics)
            history.append(metrics)
            m = metrics.get("recall@100", metrics.get("recall@20", 0.0))
            improved = m > best_metric
            best_metric = max(best_metric, m)
            if snapshot_due(epoch, ut.epochs, ut.ckpt_every, improved):
                store.save(f"ep{epoch:03d}", {"model": model.state_dict(),
                                              "optimizer": opt.state_dict(),
                                              "scheduler": sched.state_dict()},
                           step=gstep, metric=m, extra={"epoch": epoch})
    # best-checkpoint selection on Recall@100: hand the winner back to callers
    try:
        payload, _ = store.restore_best(device)
        model.load_state_dict(payload["model"])
        opt.load_state_dict(payload["optimizer"])
        sched.load_state_dict(payload["scheduler"])
    except FileNotFoundError:
        pass
    state.graph_replays = runner.replays
    return state, history, (model, uv_fn, im_fn)


def restore_hybrid(cfg: Config, data: dict, content: np.ndarray, gnn_items: np.ndarray,
                   workdir: str, device: torch.device | str = "cuda"):
    """The best hybrid checkpoint's tower, without training (rerank pools,
    serving): ``(model, user_vectors, item_matrix)``. A params-only restore,
    so a checkpoint of any optimizer recipe loads; raises FileNotFoundError
    when the store is empty."""
    model = build_hybrid_model(cfg, len(data["item_map"]) + 1, content.shape[1],
                               gnn_items.shape[1], device, seed=cfg.data.seed)
    params, _ = CheckpointStore(workdir, maximize=True).restore_best_params(
        resolve_device(device))
    model.load_state_dict(params)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))
    _, uv_fn, im_fn = make_hybrid_step(cfg, state, content, gnn_items, data["logq"])
    return model, uv_fn, im_fn


def topm_for_model(user_vecs: np.ndarray, item_matrix: np.ndarray, m: int,
                   device: torch.device | str = "cuda", mesh: Mesh | None = None,
                   normalize_items: bool = True, batch_size: int = 2048):
    """Per-user top-M candidates (ids + scores), chunked over users: an
    unchunked (U, N) score matrix does not fit at catalog scale. The item
    matrix goes to the device once."""
    device = resolve_device(device)
    im = torch.as_tensor(np.asarray(item_matrix, np.float32), device=device)
    ids, vals = [], []
    for s in range(0, len(user_vecs), batch_size):
        u = torch.as_tensor(np.asarray(user_vecs[s:s + batch_size], np.float32), device=device)
        v, i = topk_scores(u, im, m, mesh=mesh, normalize_items=normalize_items)
        ids.append(i.cpu().numpy())
        vals.append(v.float().cpu().numpy())
    if not ids:
        return np.zeros((0, m), np.int64), np.zeros((0, m), np.float32)
    return np.concatenate(ids), np.concatenate(vals)


def ensemble_report(model_a: tuple, model_b: tuple, user_ids, targets_idx,
                    ks=(20, 100, 500), device: torch.device | str | None = None) -> dict:
    """The three fusion strategies + both standalone recalls; ``device`` runs
    the fusers there (``eval/ensemble.alpha_sweep``)."""
    out = {"standalone_a": recall_at_ks(model_a[0], user_ids, targets_idx, ks),
           "standalone_b": recall_at_ks(model_b[0], user_ids, targets_idx, ks)}
    for method in ("count_mix", "weighted", "rrf"):
        out[method] = alpha_sweep(method, model_a, model_b, user_ids, targets_idx, ks,
                                  device=device)
    return out
