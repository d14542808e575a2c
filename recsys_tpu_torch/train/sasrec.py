"""Stage-2 user-tower training: data, the step, eval and the training loop.

Counterpart of ``recsys_tpu/train/sasrec.py``:

  * one step: item-matrix lookups, two dropout-view forwards of the tower,
    the LogQ-corrected in-batch sampled softmax over ``positions_per_user``
    valid positions drawn per user (with replacement, uniform over the real
    slots), with same-user masking, + DuoRec on the last position. The main
    loss sees B * positions_per_user rows (768 * 4 = 3072 at the default
    config); the default ``loss_variant="logq"`` goes through
    ``ops.select_logq_loss(user_train.kernel)``, so on CUDA tensors the
    hand-written kernel K1 runs once a step, forward and both backward halves;
  * random-cut augmentation (``ops/augment.random_cut``) before the forwards;
  * the optimizer is ``train/state.GroupedAdamW``: global-norm clip, a
    "user" group and an "item" group (the matrix) whose gradients are gated to
    zero during the first ``freeze_item_epochs`` epochs and whose lr is
    ``lr * unfrozen_item_lr_scale``, and the plateau's lr factor;
  * per-epoch full-catalog Recall@{20,100,500} over the users with targets;
    ReduceLROnPlateau on Recall@100 through the lr factor; best checkpoint by
    Recall@100, snapshots on the ``ckpt_every`` cadence; ``resume=True``
    restores the latest full state (model, optimizer with its lr factor) and
    the plateau's ``best`` / ``scale`` from the manifest entry.

Every random draw of a step (cut gates and positions, sampled positions,
dropout, the random columns of ``mixed_hnm``) comes from one
``torch.Generator``; ``draws`` hands a step fixed draws instead, so that a
test can replay the JAX package's. ``train_user_tower`` runs its steps
through ``train/step_graph.StepGraph``: on the card the step (the batch's
gather, both forwards, the loss, the backward, the optimizer) is one CUDA
graph replayed once a batch, as the JAX step is one jitted program; on the
CPU the same step runs eagerly. With ``user_train.lookup="a2a"`` the item
lookups go through ``parallel/collectives.rowsharded_lookup_a2a`` over the
mesh's model axis; the rest of the step runs on the first device, eagerly
(that path is not captured). The tower's side-info gates are off, as in the
JAX package, so the hashed side ids (``data["side"]``) are never read.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
import torch.nn.functional as F

from recsys_tpu_torch.config import Config
from recsys_tpu_torch.data import etl
from recsys_tpu_torch.data.dataset import (
    batch_iterator, build_side_info, sasrec_tensors_from_windows, target_index)
from recsys_tpu_torch.device import resolve_device
from recsys_tpu_torch.eval.recall import recall_at_ks, target_rows, topk_scores
from recsys_tpu_torch.models import flax_init
from recsys_tpu_torch.models.layers import l2_normalize
from recsys_tpu_torch.models.user_tower import Stage2Model
from recsys_tpu_torch.ops import select_logq_loss
from recsys_tpu_torch.ops.augment import apply_random_cut, random_cut_draws
from recsys_tpu_torch.ops.contrastive import (
    duorec_loss, full_batch_hard_emphasis_loss, hnm_corrected_loss, mixed_hnm_loss)
from recsys_tpu_torch.parallel.collectives import rowsharded_lookup_a2a
from recsys_tpu_torch.parallel.mesh import Mesh
from recsys_tpu_torch.train.checkpoint import CheckpointStore, snapshot_due
from recsys_tpu_torch.train.metrics import MetricWriter, gate_weights, static_branch_importance
from recsys_tpu_torch.train.state import (
    PlateauScheduler, StepTimer, TrainState, grouped_adamw, set_lr_factor)
from recsys_tpu_torch.train.step_graph import StepGraph

BATCH_KEYS = ("input_ids", "target_ids", "time_buckets", "seq_mask",
              "user_buckets", "user_cats", "user_cont")


def prepare_stage2(cfg: Config, items, users, tx_df) -> dict:
    """ETL -> fixed-shape stage-2 training data."""
    train_tx, valid_tx, split_day = etl.time_split(tx_df, cfg.data.valid_days)
    side, item_map = build_side_info(items, cfg.vocab.num_hash_buckets)
    user_feats, scaler = etl.make_user_features(train_tx, users, split_day)
    uids, lens, seq_items, deltas = etl.sequence_windows(train_tx, cfg.user_tower.max_len)
    tensors = sasrec_tensors_from_windows(uids, lens, item_map.idx_array(seq_items), deltas,
                                          user_feats, cfg.user_tower)
    item_feats = etl.make_item_features(train_tx, items, split_day)
    logq = etl.logq_from_item_features(item_feats, item_map.ids)
    targets_idx = target_index(etl.make_validation_target(valid_tx), item_map)
    return {
        "tensors": tensors, "side": side, "item_map": item_map, "logq": logq,
        "targets_idx": targets_idx, "user_feats": user_feats, "scaler": scaler,
        "split_day": split_day, "item_feats": item_feats,
    }


def init_stage2_params(cfg: Config, num_items_pad: int, pretrained: np.ndarray | None,
                       device: torch.device | str = "cuda", seed: int | None = 0) -> Stage2Model:
    """Both towers on ``device`` with the JAX package's init for ``seed``: the
    user tower from k1 and the item tower from k2 of ``split(PRNGKey(seed))``;
    the item matrix is the stage-1 matrix when ``pretrained`` is given.
    ``seed`` None: no draw, for a caller that loads a checkpoint into it."""
    device = resolve_device(device)
    model = flax_init.build(lambda: Stage2Model(cfg.user_tower, num_items_pad), None)
    if seed is not None:
        k_user, k_item = flax_init.split(flax_init.key(seed))
        flax_init.init_from_seed(model.user, k_user)
        if pretrained is None:
            flax_init.init_from_seed(model.item, k_item)
    if pretrained is not None:
        with torch.no_grad():
            model.item.item_matrix.copy_(torch.as_tensor(np.asarray(pretrained, np.float32)))
    return model.to(device)


def make_stage2_optimizer(cfg: Config, model: Stage2Model, steps_per_epoch: int):
    ut = cfg.user_train
    return grouped_adamw(
        model, lambda name: "item" if name.startswith("item") else "user",
        {"user": ut.lr, "item": ut.lr * ut.unfrozen_item_lr_scale}, ut.weight_decay,
        grad_clip=ut.grad_clip,
        freeze_steps={"item": ut.freeze_item_epochs * steps_per_epoch})


def _make_a2a_lookup(model: Stage2Model, mesh: Mesh):
    """DLRM-style row-sharded item lookup: each data shard's ids are split
    over the model axis, every model shard answers its slice against its
    rows of the matrix through ``rowsharded_lookup_a2a``, and the slices are
    gathered back in order."""
    data_ax, model_ax = mesh.axis_names
    n_data, n_model = mesh.shape[data_ax], mesh.shape[model_ax]
    devices = mesh.axis_devices(model_ax)

    def lookup(ids: torch.Tensor) -> torch.Tensor:
        table = model.item.item_matrix
        if table.shape[0] % n_model or ids.shape[0] % n_data:
            raise ValueError(f"a2a lookup: {table.shape[0]} rows / batch {ids.shape[0]} "
                             f"do not divide over the mesh {mesh.shape}")
        rows = table.shape[0] // n_model
        shards = [table[j * rows:(j + 1) * rows].to(dev) for j, dev in enumerate(devices)]
        out = []
        for local in ids.split(ids.shape[0] // n_data):
            flat = local.reshape(-1)
            b = flat.shape[0]
            flat = F.pad(flat, (0, -b % n_model))
            chunk = flat.shape[0] // n_model
            mine = [flat[j * chunk:(j + 1) * chunk].to(dev) for j, dev in enumerate(devices)]
            emb = torch.cat([e.to(ids.device) for e in rowsharded_lookup_a2a(shards, mine)])
            out.append(emb[:b].reshape(*local.shape, table.shape[1]))
        return torch.cat(out)

    return lookup


def make_item_lookup(cfg: Config, model: Stage2Model, mesh: Mesh | None = None):
    """``lookup(ids) -> rows of the item matrix`` for ``user_train.lookup``."""
    if cfg.user_train.lookup == "a2a":
        if mesh is None:
            raise ValueError("lookup='a2a' needs a mesh")
        return _make_a2a_lookup(model, mesh)
    if cfg.user_train.lookup != "dense":
        raise ValueError(f"unknown user_train.lookup {cfg.user_train.lookup!r}")
    return model.item


def sample_positions(seq_mask: torch.Tensor, count: int,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """(B, count) positions per row, with replacement, uniform over the real
    slots (a row without any takes all slots alike, as ``categorical`` over
    equal logits)."""
    w = (seq_mask > 0).float()
    w = torch.where(w.sum(1, keepdim=True) > 0, w, torch.ones_like(w))
    return torch.multinomial(w, count, replacement=True, generator=generator)


def tower_forward(model: Stage2Model, lookup, batch: dict, *, all_timesteps: bool,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    return model.user(lookup(batch["input_ids"]), batch["input_ids"], batch["time_buckets"],
                      batch["seq_mask"], batch["user_buckets"], batch["user_cats"],
                      batch["user_cont"], all_timesteps=all_timesteps, generator=generator)


def main_loss(cfg: Config, rows: torch.Tensor, tgt_emb: torch.Tensor, tgt_ids: torch.Tensor,
              logq: torch.Tensor, user_row_ids: torch.Tensor,
              generator: torch.Generator | None = None,
              rand_cols: torch.Tensor | None = None) -> torch.Tensor:
    """The ``loss_variant`` over the (B * P, D) sampled rows and their targets."""
    ut = cfg.user_train
    mined = dict(temperature=ut.temperature, lambda_logq=ut.lambda_logq,
                 top_k_percent=ut.top_k_percent, threshold=ut.hnm_threshold)
    if ut.loss_variant == "hnm":
        return hnm_corrected_loss(rows, tgt_emb, tgt_ids, logq, **mined)[0]
    if ut.loss_variant == "mixed_hnm":
        return mixed_hnm_loss(rows, tgt_emb, tgt_ids, logq, generator,
                              num_random=ut.num_random_negs, rand_cols=rand_cols, **mined)[0]
    if ut.loss_variant == "margin":
        return full_batch_hard_emphasis_loss(rows, tgt_emb, tgt_ids, logq,
                                             margin=ut.hard_margin, **mined)
    if ut.loss_variant != "logq":
        raise ValueError(f"unknown loss_variant {ut.loss_variant!r} "
                         "(logq | hnm | mixed_hnm | margin)")
    return select_logq_loss(ut.kernel)(rows, tgt_emb, tgt_ids, logq,
                                       temperature=ut.temperature,
                                       lambda_logq=ut.lambda_logq, user_ids=user_row_ids)


def stage2_loss(cfg: Config, model: Stage2Model, lookup, logq: torch.Tensor, batch: dict,
                generator: torch.Generator | None = None, draws: dict | None = None):
    """(loss, {"main", "cl"}) of one batch in train mode. ``draws`` may fix
    ``cut`` (gate, cut), ``positions`` (B, P) and ``rand_cols``; the rest is
    drawn from ``generator``."""
    ut = cfg.user_train
    draws = draws or {}
    if ut.random_cut_prob > 0:
        cut = draws.get("cut")
        if cut is None:
            cut = random_cut_draws(batch["seq_mask"], ut.random_cut_prob, generator)
        batch = apply_random_cut(batch, *cut)
    u1 = tower_forward(model, lookup, batch, all_timesteps=True, generator=generator)
    u2 = tower_forward(model, lookup, batch, all_timesteps=True, generator=generator)
    B, _, D = u1.shape
    P = ut.positions_per_user
    pos = draws.get("positions")
    if pos is None:
        pos = sample_positions(batch["seq_mask"], P, generator)
    pos = pos.to(u1.device).long()
    rows = torch.gather(u1, 1, pos[..., None].expand(B, P, D)).reshape(B * P, D)
    tgt_ids = torch.gather(batch["target_ids"], 1, pos).reshape(-1)
    tgt_emb = lookup(tgt_ids)
    if ut.item_target_norm == "l2" or ut.loss_variant in ("hnm", "mixed_hnm", "margin"):
        tgt_emb = l2_normalize(tgt_emb)     # mining assumes cosine
    user_row_ids = torch.arange(B * P, device=u1.device) // P    # each user's P rows
    main = main_loss(cfg, rows, tgt_emb, tgt_ids, logq, user_row_ids, generator,
                     draws.get("rand_cols"))
    cl = duorec_loss(u1[:, -1], u2[:, -1], batch["target_ids"][:, -1],
                     temperature=ut.temperature, lambda_sup=ut.lambda_sup)
    return main + ut.lambda_cl * cl, {"main": main, "cl": cl}


def make_stage2_step(cfg: Config, state: TrainState, logq: np.ndarray,
                     mesh: Mesh | None = None):
    """``(step, user_vectors)``: ``step(batch, generator, draws=None)`` runs one
    optimizer update and returns detached ``loss`` / ``main`` / ``cl``;
    ``user_vectors(batch)`` is the eval forward, (B, D) from the last slot."""
    model = state.model
    device = model.item.item_matrix.device
    lookup = make_item_lookup(cfg, model, mesh)
    logq_t = torch.as_tensor(np.asarray(logq, np.float32), device=device)

    def step(batch: dict, generator: torch.Generator | None = None,
             draws: dict | None = None) -> dict:
        model.train()
        loss, aux = stage2_loss(cfg, model, lookup, logq_t, batch, generator, draws)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach(), "main": aux["main"].detach(), "cl": aux["cl"].detach()}

    return step, make_user_vectors(model, lookup)


def make_user_vectors(model: Stage2Model, lookup):
    """The eval forward: ``user_vectors(batch) -> (B, D)`` from the last slot."""
    @torch.no_grad()
    def user_vectors(batch: dict) -> torch.Tensor:
        model.eval()
        return tower_forward(model, lookup, batch, all_timesteps=False)

    return user_vectors


def tensors_to(tensors: dict, device: torch.device | str) -> dict:
    """The stage-2 arrays as tensors on ``device`` (ids as int64)."""
    return {k: torch.as_tensor(tensors[k], device=device,
                               dtype=torch.float32 if k == "user_cont" else torch.int64)
            for k in BATCH_KEYS}


def _slice(dev_tensors: dict, idx) -> dict:
    ix = torch.as_tensor(np.asarray(idx), device=dev_tensors["input_ids"].device)
    return {k: v[ix] for k, v in dev_tensors.items()}


def collect_user_vectors(cfg: Config, user_vectors_fn, data: dict, device,
                         batch_size: int | None = None, rows: np.ndarray | None = None,
                         dev_tensors: dict | None = None):
    """Eval forward over the users (all, or ``rows`` of the tensors) ->
    (uvecs (n, D) numpy, user_ids)."""
    tensors = data["tensors"]
    all_rows = (np.arange(tensors["input_ids"].shape[0]) if rows is None
                else np.asarray(rows))
    uids = [tensors["user_ids"][r] for r in all_rows]
    if not len(all_rows):
        return np.zeros((0, cfg.user_tower.d_model), np.float32), uids
    dev_tensors = dev_tensors or tensors_to(tensors, device)
    bs = batch_size or cfg.user_train.batch_size
    vecs = [user_vectors_fn(_slice(dev_tensors, all_rows[s:s + bs]))
            for s in range(0, len(all_rows), bs)]
    return torch.cat(vecs).float().cpu().numpy(), uids


def evaluate_stage2(cfg: Config, model: Stage2Model, user_vectors_fn, data: dict, device,
                    mesh: Mesh | None = None, batch_size: int | None = None,
                    dev_tensors: dict | None = None, timer: StepTimer | None = None) -> dict:
    """Recall@ks over the users with validation targets only (the others
    drop out of the denominator anyway): per batch of users their vectors,
    then the full-catalog top-k against the item matrix, which stays on the
    device. ``timer`` is marked after every batch."""
    targets = data["targets_idx"]
    tensors = data["tensors"]
    rows = target_rows(tensors["user_ids"], targets)
    uids = [tensors["user_ids"][r] for r in rows]
    max_k = max(cfg.user_train.eval_ks)
    if not len(rows):
        return recall_at_ks(np.zeros((0, max_k), np.int64), [], targets,
                            cfg.user_train.eval_ks)
    dev_tensors = dev_tensors or tensors_to(tensors, device)
    items = model.item.item_matrix.detach()
    norm = cfg.user_train.eval_score != "dot"
    bs = batch_size or cfg.user_train.batch_size
    idx = []
    for s in range(0, len(rows), bs):
        u = user_vectors_fn(_slice(dev_tensors, rows[s:s + bs]))
        idx.append(topk_scores(u, items, max_k, mesh=mesh, normalize_items=norm)[1])
        if timer is not None:
            timer.mark()
    return recall_at_ks(torch.cat(idx).cpu().numpy(), uids, targets, cfg.user_train.eval_ks)


def batch_plan(cfg: Config, n: int) -> tuple[int, int, int]:
    """(batch size, passes an epoch, steps an epoch) for ``n`` users: small
    worlds re-pass until an epoch has ``steps_per_epoch_min`` steps."""
    ut = cfg.user_train
    bs = min(ut.batch_size, max(n - n % 8, 8))
    base_steps = max(n // bs, 1)
    passes = max(1, -(-ut.steps_per_epoch_min // base_steps))
    return bs, passes, base_steps * passes


def train_user_tower(cfg: Config, data: dict, pretrained_matrix: np.ndarray | None,
                     workdir: str, device: torch.device | str = "cuda",
                     mesh: Mesh | None = None, resume: bool = False,
                     writer: MetricWriter | None = None, deadline: float | None = None):
    """Train the stage-2 towers; returns ``(state, history, user_vectors_fn)``.
    ``history`` holds each epoch's eval metrics, ``state.losses`` each epoch's
    mean loss and ``state.step_seconds`` each step's time (``StepTimer``).
    ``deadline`` (a ``time.time()`` value): no epoch starts that the last
    epoch's length says would end after it; the best epoch is checkpointed
    as always."""
    ut = cfg.user_train
    device = resolve_device(device)
    tensors = data["tensors"]
    n = tensors["input_ids"].shape[0]
    bs, passes, steps_per_epoch = batch_plan(cfg, n)

    model = init_stage2_params(cfg, len(data["item_map"]) + 1, pretrained_matrix, device,
                               seed=cfg.data.seed)
    state = TrainState(model, make_stage2_optimizer(cfg, model, steps_per_epoch))
    store = CheckpointStore(workdir, maximize=True)
    start_epoch = 1
    plateau = PlateauScheduler(ut.plateau_factor, ut.plateau_patience)
    if resume:
        restored = store.restore_latest(device)
        if restored is not None:
            payload, entry = restored
            model.load_state_dict(payload["model"])
            state.optimizer.load_state_dict(payload["optimizer"])
            state.step = entry["step"]
            start_epoch = entry["extra"].get("epoch", 0) + 1
            if entry["extra"].get("plateau_best") is not None:
                plateau.best = entry["extra"]["plateau_best"]
                plateau.scale = entry["extra"].get("plateau_scale", 1.0)
    step_fn, user_vectors_fn = make_stage2_step(cfg, state, data["logq"], mesh)
    dev_tensors = tensors_to(tensors, device)
    rng = np.random.default_rng(cfg.data.seed + 1)
    gen = torch.Generator(device).manual_seed(cfg.data.seed)
    runner = StepGraph(step_fn, state, dev_tensors, bs, gen,
                       capture=device.type == "cuda" and ut.lookup == "dense")
    gstep = (start_epoch - 1) * steps_per_epoch
    history: list[dict] = []
    with contextlib.ExitStack() as stack:
        if writer is None:
            writer = stack.enter_context(contextlib.closing(
                MetricWriter(f"{workdir}/metrics.jsonl", "sasrec")))
        for epoch in range(start_epoch, ut.epochs + 1):
            t0, seen, losses = time.time(), 0, []
            if deadline is not None and history and t0 + epoch_s > deadline:
                break
            timer = StepTimer(device)
            for _pass in range(passes):
                for idx in batch_iterator(n, bs, rng):
                    aux = runner(idx)
                    timer.mark()
                    losses.append(aux["loss"])
                    gstep += 1
                    seen += bs
                    if gstep % min(100, steps_per_epoch) == 0:
                        writer.write("train", gstep, loss=float(aux["loss"]),
                                     main=float(aux["main"]), cl=float(aux["cl"]),
                                     examples_per_s=seen / max(time.time() - t0, 1e-9),
                                     **gate_weights(model.user))
            state.step_seconds += timer.seconds()
            state.losses.append(float(torch.stack(losses).mean()) if losses else 0.0)
            metrics = evaluate_stage2(cfg, model, user_vectors_fn, data, device, mesh, bs,
                                      dev_tensors)
            r100 = metrics.get("recall@100", 0.0)
            writer.write("eval", epoch, **metrics,
                         **{f"imp_{k}": v for k, v in static_branch_importance(
                             model.user, cfg.user_tower).items()})
            history.append(metrics)
            improved = plateau.best is None or r100 > plateau.best
            set_lr_factor(state.optimizer, plateau.update(r100))
            if snapshot_due(epoch, ut.epochs, ut.ckpt_every, improved):
                store.save(f"ep{epoch:03d}", {"model": model.state_dict(),
                                              "optimizer": state.optimizer.state_dict()},
                           step=gstep, metric=r100,
                           extra={"epoch": epoch, "plateau_best": plateau.best,
                                  "plateau_scale": plateau.scale, **metrics})
            epoch_s = time.time() - t0
    state.graph_replays = runner.replays
    return state, history, user_vectors_fn


def restore_stage2(cfg: Config, data: dict, ckpt_dir: str, device: torch.device | str = "cuda",
                   pretrained: np.ndarray | None = None):
    """The best stage-2 checkpoint's towers (the model alone, whatever the
    optimizer recipe) and their eval forward: ``(model, user_vectors, entry)``.
    Without a checkpoint: a seeded init (the JAX stage's fall-back), entry None."""
    device = resolve_device(device)
    n_pad = len(data["item_map"]) + 1
    try:
        params, entry = CheckpointStore(ckpt_dir, maximize=True).restore_best_params(device)
    except FileNotFoundError:
        model = init_stage2_params(cfg, n_pad, pretrained, device, seed=0)
        return model, make_user_vectors(model, model.item), None
    model = init_stage2_params(cfg, n_pad, None, device, seed=None)
    model.load_state_dict(params)
    return model, make_user_vectors(model, model.item), entry
