"""Stage-1 SimCSE training of the item tower + item-vector materialization.

Counterpart of ``recsys_tpu/train/simcse.py``. One step: two corrupted views
(on the device, ``ops/augment.py``), both tower forwards with dropout, the
bidirectional InfoNCE at tau = 0.08 through ``select_infonce`` (on CUDA the
hand-written kernel K1, forward and backward), AdamW with the text encoder
at its own learning rate, linear warmup/decay computed on the device. On the
card ``train_simcse`` runs the step (the batch's gather, both views, both
forwards, the loss, the backward, the optimizer) as one CUDA graph replayed
once a batch (``train/step_graph.StepGraph``), as the JAX step is one jitted
program; on the CPU the same step runs eagerly. Alignment/uniformity every
``metrics_every`` steps; per-epoch checkpoints, best by loss.

On a mesh whose data axis is > 1 the step is data-parallel under one
controller: the two views are made on the whole batch, split over the data
axis, each shard's views go through the tower on its device, the embeddings
are gathered onto the master's device, which makes the in-batch negatives
global (the JAX step is one global-batch program), the loss is the same
``select_infonce`` on the (B_global, D) views (K1 on CUDA, as on one device),
the gradients are summed onto one set of master weights and one optimizer
step follows. Shards that share a device share the module; a shard on another
device has a replica that is refreshed after every step. This step is not
captured: it runs eagerly.

``materialize_item_vectors`` writes the (N+1, D) matrix (row 0 = PAD) with
its id sidecar, in the JAX package's format.
"""

from __future__ import annotations

import contextlib
import copy
import time

import numpy as np
import torch

from recsys_tpu_torch.config import Config
from recsys_tpu_torch.data.dataset import batch_iterator
from recsys_tpu_torch.device import resolve_device
from recsys_tpu_torch.data.vocab import StdVocab
from recsys_tpu_torch.models import flax_init
from recsys_tpu_torch.models.item_tower import SimCSEModel
from recsys_tpu_torch.models.text_encoder import PretrainedTextEncoder
from recsys_tpu_torch.ops import select_infonce
from recsys_tpu_torch.ops.augment import two_views
from recsys_tpu_torch.ops.topk import stable_topk
from recsys_tpu_torch.parallel.mesh import Mesh, shard_batch
from recsys_tpu_torch.train.checkpoint import CheckpointStore, save_array_with_ids
from recsys_tpu_torch.train.metrics import MetricWriter, alignment, uniformity
from recsys_tpu_torch.train.state import TrainState, WarmupLinearLR, grouped_adamw
from recsys_tpu_torch.train.step_graph import StepGraph

ITEM_KEYS = ("std", "re_ids", "re_mask", "re_value", "txt_ids", "txt_mask")
MODEL_INPUTS = ("std", "re_ids", "re_mask", "txt_ids", "txt_mask")


def build_model(cfg: Config, std_vocab_size: int, num_std_fields: int,
                device: torch.device | str = "cuda", seed: int | None = 0) -> SimCSEModel:
    """A fresh model on ``device`` with the JAX package's init for ``seed``
    (``init_params(model, tensors, PRNGKey(seed))``); ``seed`` None: no draw,
    for a caller that loads a checkpoint into it."""
    device = resolve_device(device)
    return flax_init.build(
        lambda: SimCSEModel(std_vocab_size, num_std_fields, cfg.item_tower, cfg.vocab),
        None if seed is None else flax_init.key(seed)).to(device)


def item_tensors_to(tensors: dict, device: torch.device | str) -> dict:
    """The tokenized catalog's arrays as tensors on ``device``."""
    return {k: torch.as_tensor(tensors[k], device=device) for k in ITEM_KEYS
            if k in tensors}


def make_optimizer(cfg: Config, model: SimCSEModel, total_steps: int):
    """(optimizer, schedule): AdamW with the text encoder at its own learning
    rate, under the linear warmup and decay computed on the device from the
    update count. The frozen pretrained table (the JAX package's
    ``"frozen"`` group) takes no gradient, so ``grouped_adamw`` leaves it out
    of both groups."""
    sc = cfg.simcse
    opt = grouped_adamw(
        model, lambda name: "text" if "text_encoder" in name else "rest",
        {"text": sc.text_encoder_lr, "rest": sc.lr}, sc.weight_decay)
    return opt, WarmupLinearLR(opt, total_steps, sc.warmup_frac)


def loss_on_views(model: SimCSEModel, cfg: Config, v1: dict, v2: dict,
                  generator: torch.Generator | None = None):
    """Both forwards and the InfoNCE; returns (loss, emb1, emb2)."""
    infonce = select_infonce(cfg.simcse.kernel)
    emb1 = model(*(v1[k] for k in MODEL_INPUTS), generator=generator)
    emb2 = model(*(v2[k] for k in MODEL_INPUTS), generator=generator)
    return infonce(emb1, emb2, cfg.simcse.temperature), emb1, emb2


def make_train_step(state: TrainState, cfg: Config, views=two_views):
    """The training step; ``views(batch, generator, feature_dropout)`` makes
    its two corrupted views (a test may pass given draws in)."""
    def step(batch: dict, generator: torch.Generator):
        state.model.train()
        v1, v2 = views(batch, generator, cfg.simcse.feature_dropout)
        loss, e1, e2 = loss_on_views(state.model, cfg, v1, v2, generator)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return loss.detach(), e1.detach(), e2.detach()

    return step


def data_parallel(mesh: Mesh | None) -> bool:
    return mesh is not None and mesh.shape[mesh.axis_names[0]] > 1


class Replicas:
    """The model for every shard of the mesh's data axis: the master itself
    for a shard on the master's device, one copy per other device (shared by
    the shards that lie there). Devices are told apart as the mesh names
    them."""

    def __init__(self, model: SimCSEModel, mesh: Mesh):
        self.master = model
        self.devices = mesh.axis_devices(mesh.axis_names[0])
        home = next(model.parameters()).device
        self.copies = {dev: copy.deepcopy(model).to(dev)
                       for dev in dict.fromkeys(self.devices) if dev != home}
        self.models = [self.copies.get(dev, model) for dev in self.devices]

    def collect_grads(self) -> None:
        """Add every copy's gradients onto the master's and clear them."""
        for replica in self.copies.values():
            for p, q in zip(self.master.parameters(), replica.parameters()):
                if q.grad is not None:
                    g = q.grad.to(p.device)
                    p.grad = g if p.grad is None else p.grad + g
                    q.grad = None

    @torch.no_grad()
    def refresh(self) -> None:
        """The master's weights and buffers into every copy (the frozen
        pretrained table too, so every replica holds the master's)."""
        for replica in self.copies.values():
            for q, p in zip(replica.parameters(), self.master.parameters()):
                q.copy_(p)
            for q, p in zip(replica.buffers(), self.master.buffers()):
                q.copy_(p)


def loss_on_sharded_views(replicas: Replicas, cfg: Config, v1: dict, v2: dict,
                          mesh: Mesh, generators: dict | None = None):
    """``loss_on_views`` over the data axis: the views of the whole batch are
    split and each shard goes through the tower on its device. The shards'
    embeddings are gathered onto the master's device (autograd sends every
    shard its rows' gradient back) and the loss is the single-device one on
    the (B_global, D) views, so on CUDA kernel K1 runs once a step, forward
    and backward. Returns (loss, emb1, emb2)."""
    home = next(replicas.master.parameters()).device
    emb1, emb2 = [], []
    for model, dev, s1, s2 in zip(replicas.models, replicas.devices,
                                  shard_batch(mesh, {k: v1[k] for k in MODEL_INPUTS}),
                                  shard_batch(mesh, {k: v2[k] for k in MODEL_INPUTS})):
        gen = None if generators is None else generators[dev]
        emb1.append(model(*(s1[k] for k in MODEL_INPUTS), generator=gen))
        emb2.append(model(*(s2[k] for k in MODEL_INPUTS), generator=gen))
    all1, all2 = (torch.cat([e.to(home) for e in embs]) for embs in (emb1, emb2))
    loss = select_infonce(cfg.simcse.kernel)(all1, all2, cfg.simcse.temperature)
    return loss, all1.detach(), all2.detach()


def make_data_parallel_step(state: TrainState, cfg: Config, mesh: Mesh):
    """``make_train_step`` on a mesh whose data axis is > 1 (see the module
    docstring). The batch size must divide by the axis size."""
    replicas = Replicas(state.model, mesh)
    generators: dict = {}

    def step(batch: dict, generator: torch.Generator):
        for dev in replicas.devices:   # dropout needs a generator on the shard's device
            if dev not in generators:
                generators[dev] = (generator if dev.type == generator.device.type
                                   and dev not in replicas.copies else
                                   torch.Generator(dev).manual_seed(generator.initial_seed()))
        state.model.train()
        for replica in replicas.copies.values():
            replica.train()
        v1, v2 = two_views(batch, generator, cfg.simcse.feature_dropout)
        loss, e1, e2 = loss_on_sharded_views(replicas, cfg, v1, v2, mesh, generators)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        replicas.collect_grads()
        state.optimizer.step()
        state.scheduler.step()
        replicas.refresh()
        state.step += 1
        return loss.detach(), e1, e2

    return step


def load_text_pretrain_into(model: SimCSEModel, text_pretrain: np.ndarray) -> None:
    """Copy the (V, dp) corpus-pretrained token matrix into the frozen
    ``pretrained_embedding`` of the model's text encoder."""
    te = model.encoder.text_encoder
    if not isinstance(te, PretrainedTextEncoder):
        raise ValueError("text_pretrain given but item_tower.text_encoder "
                         "is not 'pretrained'")
    if tuple(te.pretrained_embedding.shape) != tuple(text_pretrain.shape):
        raise ValueError(f"pretrain artifact {tuple(text_pretrain.shape)} != "
                         f"param {tuple(te.pretrained_embedding.shape)}")
    with torch.no_grad():
        te.pretrained_embedding.copy_(torch.as_tensor(np.asarray(text_pretrain, np.float32)))


def train_simcse(cfg: Config, tensors: dict, workdir: str,
                 device: torch.device | str = "cuda",
                 writer: MetricWriter | None = None,
                 init_ckpt: str | None = None, mesh: Mesh | None = None,
                 text_pretrain: np.ndarray | None = None) -> TrainState:
    """Full stage-1 training over pre-tokenized item tensors. The model, the
    optimizer and the batches live on ``device``; on a ``mesh`` whose data
    axis is > 1 every step is split over that axis's devices.

    ``text_pretrain``: the (V, dp) artifact of ``data/text_pretrain.py``,
    copied into the frozen table after init and before ``init_ckpt`` is
    restored, as in the JAX trainer."""
    sc = cfg.simcse
    device = resolve_device(device)
    if data_parallel(mesh) and sc.batch_size % mesh.shape[mesh.axis_names[0]]:
        raise ValueError(f"simcse.batch_size={sc.batch_size} does not divide over "
                         f"{mesh.shape}")
    n = tensors["std"].shape[0]
    steps_per_epoch = max(n // sc.batch_size, 1)
    # small catalogs re-pass (fresh shuffles + fresh views) until an epoch
    # has reference-scale step counts
    passes = max(1, -(-sc.steps_per_epoch_min // steps_per_epoch))
    total_steps = steps_per_epoch * passes * sc.epochs

    model = build_model(cfg, StdVocab().size, tensors["std"].shape[1], device,
                        seed=cfg.data.seed)
    if text_pretrain is not None:
        load_text_pretrain_into(model, text_pretrain)
    store = CheckpointStore(workdir, maximize=False)
    if init_ckpt:
        model.load_state_dict(store.restore(init_ckpt, device)["model"])
    opt, sched = make_optimizer(cfg, model, total_steps)
    state = TrainState(model, opt, sched)
    step_fn = (make_data_parallel_step(state, cfg, mesh) if data_parallel(mesh)
               else make_train_step(state, cfg))
    data = item_tensors_to(tensors, device)
    gen = torch.Generator(device).manual_seed(cfg.data.seed)
    runner = StepGraph(step_fn, state, data, sc.batch_size, gen,
                       capture=device.type == "cuda" and not data_parallel(mesh))
    rng = np.random.default_rng(cfg.data.seed)
    t0, seen = time.time(), 0
    with contextlib.ExitStack() as stack:
        if writer is None:
            writer = stack.enter_context(contextlib.closing(
                MetricWriter(f"{workdir}/metrics.jsonl", "simcse")))
        for epoch in range(1, sc.epochs + 1):
            epoch_loss, nb = 0.0, 0
            for _pass in range(passes):
                for idx in batch_iterator(n, sc.batch_size, rng):
                    t_step = time.perf_counter()
                    loss, e1, e2 = runner(idx)
                    loss = float(loss)  # waits for the step to finish
                    state.step_seconds.append(time.perf_counter() - t_step)
                    state.losses.append(loss)
                    epoch_loss += loss
                    nb += 1
                    seen += sc.batch_size
                    if state.step % sc.metrics_every == 0:
                        writer.write("train", state.step, loss=loss,
                                     align=float(alignment(e1, e2)),
                                     uniform=float(uniformity(e1)),
                                     examples_per_s=seen / max(time.time() - t0, 1e-9))
            mean_loss = epoch_loss / max(nb, 1)
            writer.write("epoch", epoch, loss=mean_loss)
            store.save(f"encoder_ep{epoch:02d}",
                       {"model": model.state_dict(), "optimizer": opt.state_dict()},
                       step=state.step, metric=mean_loss)
    state.graph_replays = runner.replays
    return state


def restore_model(cfg: Config, ckpt_dir: str, num_std_fields: int,
                  device: torch.device | str) -> tuple[SimCSEModel, dict | None]:
    """The best checkpoint's model, or a seeded random init when there is
    none (the JAX stages' fallback)."""
    try:
        payload, entry = CheckpointStore(ckpt_dir, maximize=False).restore_best(device)
    except FileNotFoundError:
        return build_model(cfg, StdVocab().size, num_std_fields, device, seed=0).eval(), None
    model = build_model(cfg, StdVocab().size, num_std_fields, device, seed=None)
    model.load_state_dict(payload["model"])
    return model.eval(), entry


# -- materialization + retrieval ------------------------------------------

@torch.inference_mode()
def encode_items(model: SimCSEModel, data: dict, batch_size: int) -> torch.Tensor:
    """Deterministic encoder forward over device-resident item tensors."""
    model.eval()
    n = data["std"].shape[0]
    outs = [model.encode(*(data[k][s:s + batch_size] for k in MODEL_INPUTS))
            for s in range(0, n, batch_size)]
    return torch.cat(outs)


@torch.inference_mode()
def encode_items_sharded(model: SimCSEModel, data: dict, batch_size: int,
                         mesh: Mesh) -> torch.Tensor:
    """``encode_items`` with every batch split over the mesh's data axis; the
    tail is padded with the last row to keep the split even, as the JAX stage
    pads it to keep one compiled shape."""
    replicas = Replicas(model.eval(), mesh)
    n, shards = data["std"].shape[0], len(replicas.devices)
    home, outs = data["std"].device, []
    for s in range(0, n, batch_size):
        idx = torch.arange(s, min(s + batch_size, n), device=home)
        pad = -len(idx) % shards
        if pad:
            idx = torch.cat([idx, idx.new_full((pad,), n - 1)])
        parts = shard_batch(mesh, {k: data[k][idx] for k in MODEL_INPUTS})
        rows = torch.cat([m.eval().encode(*(p[k] for k in MODEL_INPUTS)).to(home)
                          for m, p in zip(replicas.models, parts)])
        outs.append(rows[:len(idx) - pad])
    return torch.cat(outs)


def materialize_item_vectors(cfg: Config, model: SimCSEModel, tensors: dict,
                             out_path: str, batch_size: int | None = None,
                             device: torch.device | str | None = None,
                             mesh: Mesh | None = None) -> np.ndarray:
    """Encoder forward over the whole catalog -> (N+1, D) matrix (row 0 =
    PAD) + id sidecar at ``out_path``. On a ``mesh`` whose data axis is > 1
    every batch is split over that axis's devices."""
    device = device or next(model.parameters()).device
    bs = batch_size or cfg.serve.batch_size * cfg.serve.fast_mode_multiplier
    data = item_tensors_to(tensors, device)
    mat = (encode_items_sharded(model, data, bs, mesh) if data_parallel(mesh)
           else encode_items(model, data, bs)).cpu().numpy()
    full = np.concatenate([np.zeros((1, mat.shape[1]), mat.dtype), mat])
    save_array_with_ids(out_path, full, tensors["item_ids"],
                        meta={"dim": int(mat.shape[1]), "pad_row": 0})
    return full


def topk_items(item_matrix: np.ndarray, queries: np.ndarray, k: int = 50,
               device: torch.device | str = "cuda"):
    """Exact dot-product top-k against the catalog; rows are L2-normalized
    so dot == cosine. Returns (scores, indices into the padded matrix); row
    0 (PAD) is excluded. Equal scores come back lowest index first, as
    ``jax.lax.top_k`` gives them."""
    device = resolve_device(device)
    q = torch.as_tensor(queries, dtype=torch.float32, device=device)
    m = torch.as_tensor(item_matrix, dtype=torch.float32, device=device)
    scores = q @ m.T
    scores[:, 0] = -torch.inf
    vals, idx = stable_topk(scores, k)
    return vals.cpu().numpy(), idx.cpu().numpy()
