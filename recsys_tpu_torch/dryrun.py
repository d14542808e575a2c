"""Multi-shard dry run: the sharded steps of the port on tiny shapes.

Counterpart of ``dryrun_multichip`` in the JAX package's ``__graft_entry__.py``.
``dryrun_multichip(n)`` lays an ``(n/2, 2)`` (data, model) mesh over the
visible cards, several shards a card where there are fewer cards than shards
(or all of them on the CPU with ``device="cpu"``), and runs

  * stage-1 SimCSE: one data-parallel step with global in-batch negatives;
  * LightGCL: one step with the edge list sharded over ``model``
    (``gnn.propagation=segment_sum_sharded``: partial sums + one merge);
  * a sharded full-catalog top-k over the row-sharded item matrix, without
    and with a popularity prior riding the same sharding;
  * checkpoint save -> restore -> re-place on the mesh -> step, for the
    stage-1 state.

  * stage 2: one SASRec step with the dense item lookup (``stage2``), the
    eval forward and a sharded top-k over the matrix, then the same step from
    the same state and draws with the all-to-all lookup over ``model``
    (``a2a``, when the model axis is > 1), whose loss must agree within 1e-3
    relative;
  * the hybrid tower: one step of ``train/hybrid.make_hybrid_step`` on the
    stage-2 batch (its size a multiple of the data axis) with per-user GNN
    vectors, content and GNN item vectors made from a seed (``hybrid``). As
    the stage-2 step, it runs on the mesh's first device.

It asserts finite losses and the top-k shapes and prints one line in the JAX
function's format.

    python -m recsys_tpu_torch.dryrun 8 [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import tempfile

import numpy as np
import torch

from recsys_tpu_torch.config import (Config, DataConfig, GNNConfig, ItemTowerConfig,
                                     MeshConfig, SimCSEConfig, UserTowerConfig,
                                     UserTrainConfig, VocabConfig)
from recsys_tpu_torch.device import resolve_device

_CFG = Config(
    data=DataConfig(num_items=64, num_users=32, days=30, seed=0),
    vocab=VocabConfig(max_field_tokens=8, max_name_tokens=8, text_vocab_size=1024),
    item_tower=ItemTowerConfig(),
    simcse=SimCSEConfig(batch_size=16),
)


def dryrun_multichip(n_devices: int, device: torch.device | str = "cuda") -> dict:
    """See the module docstring. Returns what the printed line holds."""
    from recsys_tpu_torch.data.dataset import tokenize_items
    from recsys_tpu_torch.data.synthetic import generate_dataset
    from recsys_tpu_torch.data.vocab import StdVocab
    from recsys_tpu_torch.eval.recall import topk_scores
    from recsys_tpu_torch.models.lightgcl import LightGCL
    from recsys_tpu_torch.ops.graph import BipartiteGraph
    from recsys_tpu_torch.parallel.mesh import build_mesh, mesh_devices
    from recsys_tpu_torch.train import simcse
    from recsys_tpu_torch.train.checkpoint import CheckpointStore
    from recsys_tpu_torch.train.gnn import _adam, make_gnn_step, select_propagation
    from recsys_tpu_torch.train.state import TrainState

    num_model = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = build_mesh(MeshConfig(num_model=num_model),
                      mesh_devices(resolve_device(device), n_devices))
    n_data = n_devices // num_model
    home = mesh.devices[0, 0]

    # -- stage-1 SimCSE: global in-batch negatives over the data axis ----------
    cfg = dataclasses.replace(_CFG, simcse=dataclasses.replace(
        _CFG.simcse, batch_size=max(16, n_data * 4)))
    items, _, _ = generate_dataset(cfg.data)
    tensors = tokenize_items(items, StdVocab(), cfg.vocab)
    data = simcse.item_tensors_to(tensors, home)
    rows = torch.arange(cfg.simcse.batch_size, device=home) % data["std"].shape[0]
    batch = {k: v[rows] for k, v in data.items()}

    def stage1_state() -> TrainState:
        model = simcse.build_model(cfg, StdVocab().size, data["std"].shape[1], home, seed=0)
        opt, sched = simcse.make_optimizer(cfg, model, total_steps=8)
        return TrainState(model, opt, sched)

    state = stage1_state()
    gen = torch.Generator(home).manual_seed(2)
    step = (simcse.make_data_parallel_step(state, cfg, mesh) if simcse.data_parallel(mesh)
            else simcse.make_train_step(state, cfg))
    step(batch, gen)                       # the first update has learning rate 0
    s1_loss = float(step(batch, gen)[0])
    assert math.isfinite(s1_loss)

    # -- LightGCL: edge-sharded full-graph propagation over `model` ------------
    rng = np.random.default_rng(0)
    NU, NI, E, q = 32, 32, 100, 4
    gu = rng.integers(0, NU, E).astype(np.int32)
    gi = rng.integers(0, NI, E).astype(np.int32)
    w = rng.random(E).astype(np.float32)
    graph = BipartiteGraph(
        NU, NI, np.concatenate([gu, NU + gi]).astype(np.int32),
        np.concatenate([NU + gi, gu]).astype(np.int32), np.concatenate([w, w]),
        rng.normal(0, 0.1, (NU + NI, q)).astype(np.float32),
        np.abs(rng.normal(1, 0.1, q)).astype(np.float32),
        rng.normal(0, 0.1, (NU + NI, q)).astype(np.float32))
    gcfg = GNNConfig(emb_dim=16, batch_size=max(16, n_data * 4),
                     propagation="segment_sum_sharded")
    prop_fn, prop_args = select_propagation(gcfg, graph, NU + NI, home, mesh)
    gmodel = LightGCL(NU, NI, gcfg, prop_fn=prop_fn).to(home)
    gstep = make_gnn_step(TrainState(gmodel, _adam(gmodel, 1e-3)), graph, gcfg, prop_args)
    gnn_loss = float(gstep(*(torch.as_tensor(rng.integers(0, n, gcfg.batch_size), device=home)
                             for n in (NU, NI, NI)))["loss"])
    assert math.isfinite(gnn_loss)

    # -- sharded retrieval over the row-sharded item matrix, then with a prior -
    n_pad = 64 * num_model                 # PAD row included; divides by num_model
    item_matrix = torch.as_tensor(rng.normal(size=(n_pad, 128)).astype(np.float32),
                                  device=home)
    state.model.eval()
    with torch.no_grad():
        u = state.model.encode(*(batch[k] for k in simcse.MODEL_INPUTS)).float()
    _, idx = topk_scores(u, item_matrix, 10, mesh=mesh)
    assert tuple(idx.shape) == (cfg.simcse.batch_size, 10) and int(idx.min()) > 0
    prior = torch.as_tensor(rng.random(n_pad).astype(np.float32) * 0.1, device=home)
    _, bidx = topk_scores(u, item_matrix, 10, mesh=mesh, prior=prior)
    assert tuple(bidx.shape) == (cfg.simcse.batch_size, 10) and int(bidx.min()) > 0

    # -- checkpoint save -> restore -> re-place on the mesh -> step ------------
    with tempfile.TemporaryDirectory() as td:
        store = CheckpointStore(td, maximize=False)
        store.save("ep001", {"model": state.model.state_dict(),
                             "optimizer": state.optimizer.state_dict(),
                             "scheduler": state.scheduler.state_dict()},
                   step=state.step, metric=s1_loss)
        payload, entry = store.restore_best("cpu")
        assert entry["step"] == state.step
        restored = stage1_state()
        restored.model.load_state_dict(payload["model"])
        restored.optimizer.load_state_dict(payload["optimizer"])
        restored.scheduler.load_state_dict(payload["scheduler"])
        restored.step = entry["step"]
        for a, b in zip(restored.model.parameters(), state.model.parameters()):
            assert torch.equal(a, b)
        rstep = (simcse.make_data_parallel_step(restored, cfg, mesh)   # replicas made anew
                 if simcse.data_parallel(mesh) else simcse.make_train_step(restored, cfg))
        ckpt_loss = float(rstep(batch, gen)[0])
        assert math.isfinite(ckpt_loss) and restored.step == state.step + 1

    world = _stage2_world(n_data, num_model, home)
    s2_loss, a2a_loss, s2_topk = _stage2_dryrun(mesh, world, num_model, home)
    assert s2_topk[1] == 10
    hybrid_loss = _hybrid_dryrun(world, home)
    out = {"mesh": mesh.shape, "stage2": s2_loss, "a2a": a2a_loss,
           "stage1": s1_loss, "gnn": gnn_loss, "hybrid": hybrid_loss,
           "topk": tuple(idx.shape), "ckpt_resume": ckpt_loss,
           "blend_topk": tuple(bidx.shape)}
    print(f"dryrun_multichip ok: mesh={out['mesh']} stage2={s2_loss:.4f} a2a={a2a_loss:.4f} "
          f"stage1={s1_loss:.4f} gnn={gnn_loss:.4f} hybrid={hybrid_loss:.4f} "
          f"topk={out['topk']} ckpt_resume={ckpt_loss:.4f} "
          f"blend_topk={out['blend_topk']}", flush=True)
    return out


def _stage2_world(n_data: int, num_model: int, home) -> dict:
    """The stage-2 dry-run world: config, data, one batch of ``bs`` users (a
    multiple of the data axis) on ``home``."""
    from recsys_tpu_torch.data.synthetic import generate_dataset
    from recsys_tpu_torch.train import sasrec

    cfg = Config(data=DataConfig(num_items=64 * num_model - 1, num_users=64, days=40, seed=0),
                 vocab=VocabConfig(num_hash_buckets=50),
                 user_tower=UserTowerConfig(max_len=8, num_layers=1),
                 user_train=UserTrainConfig(batch_size=max(16, n_data * 4),
                                            positions_per_user=2, kernel="xla"))
    items, users, tx = generate_dataset(cfg.data)
    data = sasrec.prepare_stage2(cfg, items, users, tx)
    n = data["tensors"]["input_ids"].shape[0]
    bs = min(cfg.user_train.batch_size, n - n % n_data)
    batch = sasrec._slice(sasrec.tensors_to(data["tensors"], home), np.arange(bs))
    return {"cfg": cfg, "data": data, "batch": batch, "bs": bs}


def _stage2_dryrun(mesh, world: dict, num_model: int, home) -> tuple[float, float, tuple]:
    """One stage-2 step with the dense lookup and, from the same state and
    the same draws, with the all-to-all lookup; (loss, a2a loss, top-k shape)."""
    import copy

    from recsys_tpu_torch.eval.recall import topk_scores
    from recsys_tpu_torch.train import sasrec
    from recsys_tpu_torch.train.state import TrainState

    cfg, data, batch, bs = world["cfg"], world["data"], world["batch"], world["bs"]
    n_pad = len(data["item_map"]) + 1      # divisible by num_model by construction
    model = sasrec.init_stage2_params(cfg, n_pad, None, home, seed=0)

    def one_step(lookup: str):
        m = copy.deepcopy(model)
        state = TrainState(m, sasrec.make_stage2_optimizer(cfg, m, steps_per_epoch=4))
        c = dataclasses.replace(cfg, user_train=dataclasses.replace(cfg.user_train,
                                                                    lookup=lookup))
        step, uv = sasrec.make_stage2_step(c, state, data["logq"], mesh)
        loss = float(step(batch, torch.Generator(home).manual_seed(1))["loss"])
        assert math.isfinite(loss)
        return loss, m, uv

    loss, m, uv = one_step("dense")
    _, idx = topk_scores(uv(batch), m.item.item_matrix.detach(), 10, mesh=mesh)
    assert tuple(idx.shape) == (bs, 10) and int(idx.min()) > 0
    a2a_loss = float("nan")
    if num_model > 1:
        a2a_loss = one_step("a2a")[0]
        assert abs(a2a_loss - loss) < 1e-3 * max(1.0, abs(loss)), (a2a_loss, loss)
    return loss, a2a_loss, tuple(idx.shape)


def _hybrid_dryrun(world: dict, home) -> float:
    """One hybrid step (Adam 1e-3, as the JAX dry run) on the stage-2 batch
    with per-user GNN vectors; the loss."""
    from recsys_tpu_torch.train import hybrid
    from recsys_tpu_torch.train.state import TrainState

    cfg, data, batch, bs = world["cfg"], world["data"], world["batch"], world["bs"]
    rng = np.random.default_rng(0)
    n_pad = len(data["item_map"]) + 1
    Dg, Dc = 16, 32
    content = rng.normal(0, 0.1, (n_pad, Dc)).astype(np.float32)
    gnn_items = rng.normal(0, 0.1, (n_pad, Dg)).astype(np.float32)
    model = hybrid.build_hybrid_model(cfg, n_pad, Dc, Dg, home, seed=0)
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-3))
    step, _, _ = hybrid.make_hybrid_step(cfg, state, content, gnn_items, data["logq"])
    gnn_users = torch.as_tensor(rng.normal(0, 0.1, (bs, Dg)).astype(np.float32), device=home)
    loss = float(step(batch, gnn_users, torch.Generator(home).manual_seed(3))["loss"])
    assert math.isfinite(loss)
    return loss


if __name__ == "__main__":
    parser = argparse.ArgumentParser("recsys_tpu_torch dry run")
    parser.add_argument("n_devices", type=int, nargs="?", default=8)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    dryrun_multichip(args.n_devices, args.device)
