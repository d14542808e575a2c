"""Pipeline CLI of the port: every stage of the JAX package's CLI.

Counterpart of ``recsys_tpu/pipeline/cli.py``, with the same ``--set``
overrides, artifact paths and one JSON line per stage:

  gen-data     synthetic persona world -> parquet (items/users/transactions)
  ingest-hm    the H&M Kaggle CSVs (``--hm-dir``, ``--date-min``,
               ``--date-max``) -> the same parquet trio + std_vocab.json
  enrich       re-run the rule-based RE enrichment over the item master
  etl          splits + item/user/sequence features + validation targets
  pretrain-text  PPMI-SVD token table over the catalog -> text_pretrain.npz
  train-item   stage-1 SimCSE                        -> checkpoints; with
               ``item_tower.text_encoder=pretrained`` over the frozen table
               of ``pretrain-text``
  vectorize    materialize the (N+1, 128) item matrix artifact
  train-gnn    LightGCL (``--resume``, ``--fine-tune``) -> graph embeddings
  distill      magnitude->cosine projector           -> distilled vectors
  gnn-eval     GNN recall rows + distillation fidelity -> gnn_eval.json
  train-user   stage-2 SASRec user tower (``--resume``)  -> checkpoints
  eval         full-catalog Recall@{20,100,500} + baselines + blend sweep +
               paired-bootstrap significance -> eval.json
  train-reranker  GBDT (``--iterations``) + DCN rerankers on tower candidates
               -> reranker_gbdt.pkl
  train-hybrid hybrid content+GNN user tower -> ckpt_hybrid, hybrid_item_matrix,
               then (``user_train.hybrid_report``) the ensemble report
               (hybrid x GNN, hybrid x repurchase / content), the blend sweep
               and significance -> ensemble_report.json
  ensemble-eval  stage-2 tower x GNN fusion (count-mix / weighted / RRF),
               then the best fused list x repurchase -> ensemble_eval.json
  rerank-eval  candidate union -> pair features -> GBDT (+ a DCN arm) rerank,
               trained on an inner time split; ``--vectors stage2|hybrid``
               picks the tower -> rerank_gbdt_{vectors}.pkl,
               rerank_eval_{vectors}.json
  serve        HTTP server; ``--vectors stage2|hybrid`` loads the blend/rerank
               assets of that tower when they exist; ``--model-backed``
               vectorizes items with the trained encoder and users per
               ``serve.user_backend`` (``hybrid``, ``stage2``: that tower's
               best checkpoint; ``auto``: the hybrid tower, else the stage-2
               tower, else the history mean); ``serve.ann_backend``
               ``exact|hnsw|ivf|int8`` (the last two on the card); the
               ``/train/item-tower`` and ``/train/user-tower`` routes train
               on the store's rows
  orchestrate  the hourly / weekly scheduler against a running server
               (``--server``; ``--once``: one hourly cycle)

``--device`` (default ``cuda``) places the model; ``--device cuda`` on a
machine without a CUDA device raises and never falls back to the CPU.
``--set mesh.num_data=4`` / ``mesh.num_model=2`` shard train-item, vectorize,
train-gnn (with ``gnn.propagation=segment_sum_sharded``) and gnn-eval over the
visible cards (train-user and eval: the item lookup with
``user_train.lookup=a2a`` and the eval top-k over the model axis); a mesh larger than the cards there are raises unless
``--virtual-shards`` lays it over them (several shards a card, or all on the
CPU with ``--device cpu``).

    python -m recsys_tpu_torch.pipeline.cli train-item --set data.root=/tmp/w
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from itertools import chain

import numpy as np
import pandas as pd
import torch

from recsys_tpu_torch.config import Config, load_config
from recsys_tpu_torch.device import resolve_device


class _Laps:
    """Seconds between calls, by name; a name called twice adds up."""

    def __init__(self):
        self.seconds: dict = {}
        self._last = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self._last
        self._last = now


def _paths(cfg: Config) -> dict:
    root = cfg.data.root
    return {
        "root": root,
        "items": f"{root}/items.parquet",
        "users": f"{root}/users.parquet",
        "tx": f"{root}/transactions.parquet",
        "item_feats": f"{root}/features_item.parquet",
        "user_feats": f"{root}/features_user.parquet",
        "seqs": f"{root}/features_sequence.parquet",
        "targets": f"{root}/targets_val.json",
        "item_ckpts": f"{root}/ckpt_item",
        "user_ckpts": f"{root}/ckpt_user",
        "gnn_ckpts": f"{root}/ckpt_gnn",
        "item_matrix": f"{root}/item_matrix",
        "text_pretrain": f"{root}/text_pretrain.npz",
        "gnn_prefix": f"{root}/gnn",
        "distilled": f"{root}/gnn_distilled_items",
        "distilled_users": f"{root}/gnn_distilled_users",
        "eval": f"{root}/eval.json",
    }


def _load_world(cfg: Config):
    p = _paths(cfg)
    items = pd.read_parquet(p["items"])
    users = pd.read_parquet(p["users"])
    tx = pd.read_parquet(p["tx"])
    return items, users, tx


def _mesh(cfg: Config, args):
    """The (data, model) mesh of ``cfg.mesh`` over every visible card, or over
    the CPU with ``--device cpu``. ``--virtual-shards`` repeats the devices
    until the mesh is full; it changes where shards lie, not what is computed."""
    from recsys_tpu_torch.parallel.mesh import build_mesh, mesh_devices

    device = resolve_device(args.device)
    devices = mesh_devices(device)
    if getattr(args, "virtual_shards", False):
        want = max(cfg.mesh.num_model, 1) * max(cfg.mesh.num_data, 1)
        devices = mesh_devices(device, max(want, len(devices)))
    return build_mesh(cfg.mesh, devices)


def _item_tensors(cfg: Config) -> dict:
    from recsys_tpu_torch.data.dataset import tokenize_items
    from recsys_tpu_torch.data.vocab import StdVocab

    items, _, _ = _load_world(cfg)
    return tokenize_items(items, StdVocab(), cfg.vocab)


def cmd_gen_data(cfg: Config, args) -> dict:
    from recsys_tpu_torch.data.synthetic import generate_dataset
    p = _paths(cfg)
    os.makedirs(p["root"], exist_ok=True)
    items, users, tx = generate_dataset(cfg.data)
    items.to_parquet(p["items"])
    users.to_parquet(p["users"])
    tx.to_parquet(p["tx"])
    # learnability diagnostic: latent-cluster oracle vs popularity Recall@100
    # (sampled; tells whether the world has per-user structure worth training on)
    from recsys_tpu_torch.data.synthetic import cluster_oracle_recall
    split_day = int(tx["day"].max()) - cfg.data.valid_days + 1
    oracle = cluster_oracle_recall(items, tx, split_day)
    return {"items": len(items), "users": len(users), "transactions": len(tx),
            "oracle": oracle}


def cmd_ingest_hm(cfg: Config, args) -> dict:
    """Real-data front door: the three H&M Kaggle CSVs -> the canonical
    parquet trio + a fitted STD vocab, so every later stage runs unchanged."""
    from recsys_tpu_torch.data.hm_adapter import load_hm_dataset, vocab_from_items
    p = _paths(cfg)
    os.makedirs(p["root"], exist_ok=True)
    items, users, tx = load_hm_dataset(
        args.hm_dir, date_min=getattr(args, "date_min", None),
        date_max=getattr(args, "date_max", None))
    items.to_parquet(p["items"])
    users.to_parquet(p["users"])
    tx.to_parquet(p["tx"])
    vocab_from_items(items).to_json(f"{p['root']}/std_vocab.json")
    return {"items": len(items), "users": len(users), "transactions": len(tx),
            "vocab": f"{p['root']}/std_vocab.json"}


def cmd_enrich(cfg: Config, args) -> dict:
    """Re-run the RE enrichment over the item master (idempotent)."""
    from recsys_tpu_torch.data.synthetic import enrich_item
    p = _paths(cfg)
    items = pd.read_parquet(p["items"])
    items["reinforced_feature"] = [enrich_item(r)["reinforced_feature_value"]
                                   for r in items.to_dict("records")]
    items.to_parquet(p["items"])
    return {"enriched": len(items)}


def cmd_etl(cfg: Config, args) -> dict:
    from recsys_tpu_torch.data import etl
    p = _paths(cfg)
    items, users, tx = _load_world(cfg)
    train_tx, valid_tx, split_day = etl.time_split(tx, cfg.data.valid_days)
    item_feats = etl.make_item_features(train_tx, items, split_day)
    user_feats, _ = etl.make_user_features(train_tx, users, split_day)
    seqs = etl.make_sequences(train_tx, cfg.data.max_seq_len)
    targets = etl.make_validation_target(valid_tx)
    item_feats.to_parquet(p["item_feats"])
    user_feats.to_parquet(p["user_feats"])
    seqs.to_parquet(p["seqs"])
    with open(p["targets"], "w") as f:
        json.dump(targets, f)
    sanity = etl.final_sanity_check(seqs, targets)
    missing = etl.deep_inspect_missing_items(tx, items)
    return {"split_day": split_day, "sanity": sanity, "missing": missing}


def cmd_pretrain_text(cfg: Config, args) -> dict:
    """Corpus-pretrain the frozen text-embedding artifact (PPMI-SVD over the
    catalog's names + RE fields, ``data/text_pretrain.py``). Host work."""
    from recsys_tpu_torch.data.text_pretrain import pretrain_embeddings, save_text_pretrain
    p = _paths(cfg)
    emb = pretrain_embeddings(_item_tensors(cfg), cfg.vocab.text_vocab_size,
                              dim=cfg.item_tower.pretrained_dim, seed=cfg.data.seed)
    save_text_pretrain(p["text_pretrain"], emb)
    nz = int((np.abs(emb).sum(axis=1) > 0).sum())
    return {"artifact": p["text_pretrain"], "shape": list(emb.shape),
            "nonzero_rows": nz}


def cmd_train_item(cfg: Config, args) -> dict:
    from recsys_tpu_torch.train.simcse import train_simcse

    device = resolve_device(args.device)
    p = _paths(cfg)
    tensors = _item_tensors(cfg)
    text_pretrain = None
    if cfg.item_tower.text_encoder == "pretrained":
        from recsys_tpu_torch.data.text_pretrain import load_text_pretrain
        text_pretrain = load_text_pretrain(p["text_pretrain"])
    t0 = time.perf_counter()
    mesh = _mesh(cfg, args)
    state = train_simcse(cfg, tensors, p["item_ckpts"], device,
                         init_ckpt=getattr(args, "init_ckpt", None), mesh=mesh,
                         text_pretrain=text_pretrain)
    seconds = time.perf_counter() - t0
    steady = state.step_seconds[1:] or state.step_seconds
    return {"steps": state.step, "graph_replays": state.graph_replays,
            "ckpt_dir": p["item_ckpts"],
            "text_encoder": cfg.item_tower.text_encoder, "device": str(device),
            "mesh": mesh.shape, "seconds": seconds, "losses": state.losses,
            "step_ms_median": 1e3 * statistics.median(steady) if steady else None,
            "first_step_ms": 1e3 * state.step_seconds[0] if state.step_seconds else None}


def cmd_vectorize(cfg: Config, args) -> dict:
    from recsys_tpu_torch.train.simcse import materialize_item_vectors, restore_model

    device = resolve_device(args.device)
    p = _paths(cfg)
    tensors = _item_tensors(cfg)
    model, entry = restore_model(cfg, p["item_ckpts"], tensors["std"].shape[1], device)
    t0 = time.perf_counter()
    mat = materialize_item_vectors(cfg, model, tensors, p["item_matrix"], device=device,
                                   mesh=_mesh(cfg, args))
    seconds = time.perf_counter() - t0
    return {"matrix": p["item_matrix"], "shape": list(mat.shape),
            "checkpoint": entry["name"] if entry else None, "device": str(device),
            "seconds": seconds, "items_per_s": (mat.shape[0] - 1) / seconds}


def _best_epoch(history: list[dict]) -> dict:
    """Best epoch by Recall@100, else the final epoch."""
    if not history:
        return {}
    if any("recall@100" in h for h in history):
        return max(history, key=lambda h: h.get("recall@100", 0.0))
    return history[-1]


def _pretrained_matrix(cfg: Config, item_map, required: bool) -> np.ndarray | None:
    """The stage-1 item matrix re-ordered to the stage-2 id map (PAD row 0;
    ids it lacks get seeded random rows), or None when there is none and it
    is not ``required``."""
    from recsys_tpu_torch.train.checkpoint import align_rows, load_array_with_ids

    try:
        mat, ids, _ = load_array_with_ids(_paths(cfg)["item_matrix"])
    except FileNotFoundError:
        if required:
            raise
        return None
    aligned, _ = align_rows(mat[1:], ids[1:], item_map.ids, fill="random")
    return np.concatenate([np.zeros((1, mat.shape[1]), np.float32), aligned])


def _median_ms(seconds: list[float]):
    steady = seconds[1:] or seconds
    return 1e3 * statistics.median(steady) if steady else None


def _launch_counts() -> dict:
    """Every hand kernel's launch count so far in this process."""
    from recsys_tpu_torch.ops import contrastive_kernel, fm_kernel, spmm
    from recsys_tpu_torch.parallel import ring

    return {**contrastive_kernel.LAUNCHES, **spmm.LAUNCHES, **fm_kernel.LAUNCHES,
            **ring.LAUNCHES}


def _launches_since(before: dict) -> dict:
    """The hand kernels launched since ``before`` (a ``_launch_counts()``), by
    name; a graph replay counts each launch it holds."""
    now = _launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def cmd_train_user(cfg: Config, args) -> dict:
    from recsys_tpu_torch.train.sasrec import prepare_stage2, train_user_tower

    device = resolve_device(args.device)
    p = _paths(cfg)
    items, users, tx = _load_world(cfg)
    data = prepare_stage2(cfg, items, users, tx)
    pretrained = _pretrained_matrix(cfg, data["item_map"], required=False)
    t0 = time.perf_counter()
    state, history, _ = train_user_tower(cfg, data, pretrained, p["user_ckpts"], device,
                                         mesh=_mesh(cfg, args),
                                         resume=getattr(args, "resume", False),
                                         deadline=getattr(args, "deadline", None))
    return {"epochs": len(history), "best": _best_epoch(history),
            "final": history[-1] if history else {}, "device": str(device),
            "steps": state.step, "graph_replays": state.graph_replays,
            "seconds": time.perf_counter() - t0,
            "epoch_losses": state.losses, "step_ms_median": _median_ms(state.step_seconds)}


def _on_card(device: torch.device):
    """Where the device paths of the baselines, the blend and the fusers run:
    the card, or None elsewhere (their host numpy forms, the JAX package's
    code)."""
    return device if device.type == "cuda" else None


def cmd_eval(cfg: Config, args) -> dict:
    """The best stage-2 checkpoint's Recall@ks, the training-free baselines,
    the prior-blend sweep (global and eval-season prior) and paired-bootstrap
    significance at the primary k -> eval.json, plus the eval users' vectors
    and the trained item matrix as sidecars."""
    from recsys_tpu_torch.data.etl import seasonal_logq, time_split
    from recsys_tpu_torch.data.synthetic import SEASONS, season_of_day
    from recsys_tpu_torch.eval.baselines import baseline_report, blend_sweep
    from recsys_tpu_torch.eval.recall import bootstrap_mean_ci, paired_delta_ci, target_rows
    from recsys_tpu_torch.train.checkpoint import save_array_with_ids
    from recsys_tpu_torch.train.sasrec import (
        batch_plan, collect_user_vectors, evaluate_stage2, prepare_stage2, restore_stage2,
        tensors_to)
    from recsys_tpu_torch.train.state import StepTimer

    device = resolve_device(args.device)
    p = _paths(cfg)
    laps = _Laps()
    items, users, tx = _load_world(cfg)
    data = prepare_stage2(cfg, items, users, tx)
    pretrained = _pretrained_matrix(cfg, data["item_map"], required=True)
    laps("prepare")
    tens = data["tensors"]
    bs = batch_plan(cfg, tens["input_ids"].shape[0])[0]
    model, uv_fn, _ = restore_stage2(cfg, data, p["user_ckpts"], device, pretrained)
    mesh = _mesh(cfg, args)
    dev_tensors = tensors_to(tens, device)
    timer = StepTimer(device)
    metrics = evaluate_stage2(cfg, model, uv_fn, data, device, mesh, bs, dev_tensors, timer)
    eval_seconds = timer.seconds()
    laps("model_eval")
    on_card = _on_card(device)
    ks = sorted(cfg.user_train.eval_ks)
    k_primary = ks[min(1, len(ks) - 1)]
    rows = target_rows(tens["user_ids"], data["targets_idx"])
    sub = {"user_ids": [tens["user_ids"][r] for r in rows],
           "input_ids": tens["input_ids"][rows], "target_ids": tens["target_ids"][rows]}
    metrics["baselines"] = baseline_report(sub, data["logq"], data["targets_idx"],
                                           ks=cfg.user_train.eval_ks, item_matrix=pretrained,
                                           per_user_k=k_primary, device=on_card)
    base_pu = metrics["baselines"].pop("_per_user")
    laps("baselines")
    uvecs, uids = collect_user_vectors(cfg, uv_fn, data, device, bs, rows=rows,
                                       dev_tensors=dev_tensors)
    item_matrix = model.item.item_matrix.detach().float().cpu().numpy()
    save_array_with_ids(p["root"] + "/eval_uvecs", uvecs, list(uids))
    save_array_with_ids(p["root"] + "/eval_item_matrix", item_matrix,
                        list(data["item_map"].ids))
    hist = np.concatenate([tens["input_ids"][rows], tens["target_ids"][rows][:, -1:]], 1)
    blend = blend_sweep(uvecs, item_matrix, data["logq"], hist, uids, data["targets_idx"],
                        ks=cfg.user_train.eval_ks, per_user_k=k_primary, device=on_card)
    blend_pu = blend.pop("_per_user")
    laps("user_vectors_and_blend")
    metrics["blend"] = {"best": blend["best"], "best_metrics": blend["best_metrics"],
                        "model_only": blend["table"].get("a0.0_b0.0")}
    # paired bootstrap at the primary k: does the learned stack beat the
    # training-free floors user by user, not just on the mean?
    model_pu = blend_pu.get("model_only")
    if base_pu["uids"] == blend_pu["uids"]:
        rep, pop = base_pu["repurchase"], base_pu["popularity"]
        sig = {"k": k_primary,
               "blend_best": bootstrap_mean_ci(blend_pu["best"]),
               "repurchase": bootstrap_mean_ci(rep),
               "blend_vs_repurchase": paired_delta_ci(blend_pu["best"], rep)}
        if model_pu is not None:
            sig["model_only"] = bootstrap_mean_ci(model_pu)
            sig["model_vs_repurchase"] = paired_delta_ci(model_pu, rep)
            sig["model_vs_popularity"] = paired_delta_ci(model_pu, pop)
            if "content_profile" in base_pu:
                sig["model_vs_content_profile"] = paired_delta_ci(
                    model_pu, base_pu["content_profile"])
        metrics["significance"] = sig
    laps("bootstrap")
    # the blend again with the eval window's season prior in place of the global one
    train_tx, _, split_day = time_split(tx, cfg.data.valid_days)
    eval_season = str(np.asarray(SEASONS)[season_of_day(split_day,
                                                        cfg.data.season_cycle_days)])
    slq = seasonal_logq(train_tx, data["item_map"].ids, eval_season)
    if slq is not None:
        sblend = blend_sweep(uvecs, item_matrix, slq, hist, uids, data["targets_idx"],
                             ks=cfg.user_train.eval_ks, device=on_card)
        metrics["blend_seasonal"] = {"season": eval_season, "best": sblend["best"],
                                     "best_metrics": sblend["best_metrics"]}
    laps("seasonal_blend")
    with open(p["eval"], "w") as f:
        json.dump(metrics, f, indent=1)
    return {**metrics, "device": str(device), "step_ms_median": _median_ms(eval_seconds),
            "seconds": laps.seconds}


def graph_stats(graph) -> dict:
    """Nodes, directed edges (the nonzero weights), the largest degree and
    the hub rows of K2's layout (rows of more than ``ops.spmm.MAX_SEGMENT``
    edges, which several warps share) of a ``BipartiteGraph``."""
    from recsys_tpu_torch.ops.spmm import MAX_SEGMENT

    degree = np.bincount(np.asarray(graph.dst)[np.asarray(graph.weight) != 0],
                         minlength=graph.num_nodes)
    return {"nodes": int(graph.num_nodes), "directed_edges": int(degree.sum()),
            "max_degree": int(degree.max(initial=0)),
            "hub_rows": int((degree > MAX_SEGMENT).sum())}


def cmd_train_gnn(cfg: Config, args) -> dict:
    from recsys_tpu_torch.data.etl import time_split
    from recsys_tpu_torch.models.lightgcl import ssl_route
    from recsys_tpu_torch.ops.graph import build_graph
    from recsys_tpu_torch.ops.spmm import CsrGraph
    from recsys_tpu_torch.train.gnn import (
        export_gnn_artifacts, gnn_propagation_check, select_propagation, train_lightgcl,
        transaction_indices)

    device = resolve_device(args.device)
    p = _paths(cfg)
    items, users, tx = _load_world(cfg)
    train_tx, _, _ = time_split(tx, cfg.data.valid_days)
    user_ids = sorted(train_tx["user_id"].unique())
    item_ids = sorted(items["item_id"].astype(str))
    user_map = {u: r for r, u in enumerate(user_ids)}
    item_map = {i: r for r, i in enumerate(item_ids)}
    eu, ei = transaction_indices(train_tx, user_map, item_map)     # mapped once
    graph = build_graph(eu, ei, len(user_map), len(item_map), svd_rank=cfg.gnn.svd_rank,
                        svd_iters=cfg.gnn.svd_iters, seed=cfg.data.seed)
    # one graph layout serves the trainer, the export and the check
    propagation = select_propagation(cfg.gnn, graph, graph.num_nodes, device,
                                     _mesh(cfg, args))
    layout = propagation[1] if isinstance(propagation[1], CsrGraph) else None
    t0 = time.perf_counter()
    before = _launch_counts()
    state, model = train_lightgcl(cfg, graph, eu, ei, p["gnn_ckpts"], device,
                                  resume=getattr(args, "resume", False),
                                  fine_tune=getattr(args, "fine_tune", False),
                                  propagation=propagation)
    seconds = time.perf_counter() - t0
    launches = _launches_since(before)
    export_gnn_artifacts(model, graph, user_ids, item_ids, p["gnn_prefix"],
                         cfg.gnn.num_layers, device, layout)
    steady = state.step_seconds[1:] or state.step_seconds
    return {"check": gnn_propagation_check(model, graph, device, layout),
            "graph": graph_stats(graph), "device": str(device), "steps": state.step,
            "graph_replays": state.graph_replays, "launches": launches,
            "ssl_route": ssl_route(device),
            "seconds": seconds, "init_seconds": state.init_seconds,
            "epoch_losses": state.losses,
            "step_ms_median": 1e3 * statistics.median(steady) if steady else None}


def cmd_distill(cfg: Config, args) -> dict:
    from recsys_tpu_torch.eval.gnn_eval import distill_fidelity
    from recsys_tpu_torch.train.checkpoint import load_array_with_ids, save_array_with_ids
    from recsys_tpu_torch.train.gnn import distilled_vectors, train_distill

    device = resolve_device(args.device)
    p = _paths(cfg)
    tu, uids, _ = load_array_with_ids(p["gnn_prefix"] + "_users")
    ti, ids, _ = load_array_with_ids(p["gnn_prefix"] + "_items")
    t0 = time.perf_counter()
    before = _launch_counts()
    state, model = train_distill(cfg, tu, ti, p["gnn_ckpts"], device)
    seconds = time.perf_counter() - t0
    launches = _launches_since(before)
    out = distilled_vectors(model, ti)
    save_array_with_ids(p["distilled"], out, ids,
                        meta={"space": "gnn_cosine_distilled"})
    # BOTH sides pass through the student: the distill trains user-item
    # cos * exp(scale) against teacher dot, so raw users against distilled
    # items is a pairing it never trained
    su = distilled_vectors(model, tu)
    save_array_with_ids(p["distilled_users"], su, uids,
                        meta={"space": "gnn_cosine_distilled"})
    fid = distill_fidelity(tu, ti, out, su, device=device)
    return {"distilled": p["distilled"], "shape": list(out.shape),
            "fidelity": fid, "device": str(device), "epoch_losses": state.losses,
            "steps": state.step, "graph_replays": state.graph_replays, "launches": launches,
            "seconds": seconds, "step_ms_median": _median_ms(state.step_seconds)}


def cmd_gnn_eval(cfg: Config, args) -> dict:
    """GNN standalone retrieval rows (raw dot) + cosine/distilled variants +
    teacher-student distillation fidelity. Pure artifact consumer: needs
    gnn_{users,items} (train-gnn) and optionally
    gnn_distilled_{items,users} (distill)."""
    from recsys_tpu_torch.eval.gnn_eval import distill_fidelity, standalone_rows
    from recsys_tpu_torch.train.checkpoint import load_array_with_ids

    device = resolve_device(args.device)
    p = _paths(cfg)
    gu, gu_ids, _ = load_array_with_ids(p["gnn_prefix"] + "_users")
    gi, gi_ids, _ = load_array_with_ids(p["gnn_prefix"] + "_items")
    di = du = None
    try:
        di, _, _ = load_array_with_ids(p["distilled"])
        du, _, _ = load_array_with_ids(p["distilled_users"])
    except FileNotFoundError:
        pass
    with open(p["targets"]) as f:
        targets = json.load(f)
    out = standalone_rows(gu, list(gu_ids), gi, list(gi_ids), targets,
                          ks=cfg.user_train.eval_ks,
                          distilled_items=di, distilled_users=du, device=device,
                          mesh=_mesh(cfg, args))
    if di is not None:
        out["fidelity"] = distill_fidelity(gu, gi, di, du, device=device)
    with open(p["root"] + "/gnn_eval.json", "w") as f:
        json.dump(out, f, indent=1)
    return out


def item_column(ifeats: pd.DataFrame, column: str, item_map, rows: int) -> np.ndarray:
    """(rows,) float32: row r the ``column`` of ``item_map``'s item r (an item
    without features, and PAD row 0, at 0)."""
    ids = list(item_map.ids)[:rows - 1]
    out = np.zeros(rows, np.float32)
    present = pd.Index(ids).isin(ifeats.index)
    out[1:len(ids) + 1] = np.where(present, ifeats[column].reindex(ids).to_numpy(), 0.0)
    return out


def history_means(tx: pd.DataFrame, item_map, mat: np.ndarray) -> dict:
    """user_id -> the mean of ``mat``'s rows of the user's known purchases
    (NaN with none known), users in sorted order. The rows are summed one
    after the other in the order of ``tx``, as ``mean(0)`` sums the rows of
    a (n, D > 1) array."""
    codes, users = pd.factorize(tx["user_id"], sort=True)
    rows = item_map.idx_array(tx["item_id"])
    keep = (codes >= 0) & (rows > 0)
    codes, rows = codes[keep], rows[keep]
    rows = rows[np.argsort(codes, kind="stable")]
    count = np.bincount(codes, minlength=len(users))
    start = np.cumsum(count) - count
    by_count = np.argsort(-count, kind="stable")   # the users with a t-th row lead
    sums = np.zeros((len(users), mat.shape[1]), mat.dtype)
    for t in range(int(count.max(initial=0))):
        g = by_count[:np.count_nonzero(count > t)]
        if t == 0:
            sums[g] = mat[rows[start[g]]]
        else:
            sums[g] += mat[rows[start[g] + t]]
    with np.errstate(invalid="ignore"):
        means = sums / count[:, None].astype(mat.dtype)
    return dict(zip(users.tolist(), means))


def reranker_rows(cfg: Config) -> dict:
    """The reranker's training rows from the world, the item matrix and the
    item features: per purchase one positive and ``neg_per_pos`` negatives
    (from the tower's own top-k, or uniform), the 10 dense features ``X`` of
    each row, labels, group ids and the 80/20 split on a group boundary.
    Seeded by ``data.seed``: the same artifacts give the same rows."""
    from recsys_tpu_torch.data.dataset import IdMap
    from recsys_tpu_torch.data.etl import time_split
    from recsys_tpu_torch.data.ranker_features import (
        build_rank_features, import_interactions, import_interactions_candidates)
    from recsys_tpu_torch.train.checkpoint import load_array_with_ids

    p = _paths(cfg)
    _, _, tx = _load_world(cfg)
    train_tx, _, _ = time_split(tx, cfg.data.valid_days)
    mat, ids, _ = load_array_with_ids(p["item_matrix"])
    item_map = IdMap(ids[1:])
    rng = np.random.default_rng(cfg.data.seed)
    # user vector = mean of purchased item vectors (two-tower stand-in when
    # the user tower hasn't been trained yet)
    uvecs = history_means(train_tx, item_map, mat)
    if cfg.reranker.negative_source == "candidates":
        uids, iidx, labels, groups = import_interactions_candidates(
            train_tx.tail(20000), uvecs, mat, item_map, rng,
            cfg.reranker.neg_per_pos, cfg.reranker.candidate_top_k)
    else:
        uids, iidx, labels, groups = import_interactions(
            train_tx.tail(20000), len(item_map), item_map, rng,
            cfg.reranker.neg_per_pos)
    ifeats = pd.read_parquet(p["item_feats"]).set_index("item_id")
    item_meta = np.stack([item_column(ifeats, "pop_1m_log", item_map, len(mat)),
                          item_column(ifeats, "avg_item_price_log", item_map, len(mat))], axis=1)
    u_arr = np.stack([uvecs.get(u, mat[0]) for u in uids])
    um = np.zeros((len(uids), 3), np.float32)
    X = build_rank_features(u_arr, mat[iidx], um, item_meta[iidx])
    # split on a group boundary so pairwise groups stay intact
    split = int(0.8 * len(labels))
    if split < len(groups):
        split -= int(np.sum(groups[:split] == groups[split]))
    return {"X": X, "y": labels, "groups": groups, "split": split, "user_ids": uids,
            "item_idx": iidx, "user_vecs": uvecs, "item_matrix": mat, "item_map": item_map,
            "item_meta": item_meta}


def cmd_train_reranker(cfg: Config, args) -> dict:
    from recsys_tpu_torch.train.reranker import GBDTRanker, auc_score, train_dcn

    device = resolve_device(args.device)
    p = _paths(cfg)
    rows = reranker_rows(cfg)
    X, y, groups, split = rows["X"], rows["y"], rows["groups"], rows["split"]
    t0 = time.perf_counter()
    gbdt = GBDTRanker(iterations=getattr(args, "iterations", None) or 200,
                      device=device).fit(X[:split], y[:split])
    gbdt_seconds = time.perf_counter() - t0
    gbdt_auc = gbdt.auc(X[split:], y[split:])
    t0 = time.perf_counter()
    before = _launch_counts()
    state, _, predict = train_dcn(cfg, X[:split], y[:split], groups=groups[:split],
                                  device=device)
    dcn_seconds = time.perf_counter() - t0
    dcn_launches = _launches_since(before)
    dcn_auc = auc_score(y[split:], predict(X[split:]))
    gbdt.save(f"{p['root']}/reranker_gbdt.pkl")
    steady = state.step_seconds[1:] or state.step_seconds
    return {"gbdt_auc": round(gbdt_auc, 4), "dcn_auc": round(dcn_auc, 4),
            "negative_source": cfg.reranker.negative_source,
            "dcn_loss": cfg.reranker.loss,
            "examples": int(len(y)), "device": str(device),
            "gbdt_iterations": gbdt.n_iter_, "gbdt_seconds": gbdt_seconds,
            "dcn_steps": state.step, "dcn_seconds": dcn_seconds,
            "dcn_graph_replays": state.graph_replays, "dcn_launches": dcn_launches,
            "dcn_step_ms_median": 1e3 * statistics.median(steady) if steady else None}


def _gnn_arm(cfg: Config, item_map, user_ids: list[str], raw_items=None):
    """The GNN retriever to fuse with, chosen by the measured gnn_eval.json
    rows among the arms whose artifacts load (raw dot, raw cosine, distilled
    student x student; without gnn_eval.json: distilled when both distilled
    sides load, else raw dot). Returns (arm, (N+1, Dg) item matrix, (U, Dg)
    user vectors of ``user_ids``), both L2-normalized for the cosine arms."""
    from recsys_tpu_torch.train import hybrid as H
    from recsys_tpu_torch.train.checkpoint import load_array_with_ids

    p = _paths(cfg)
    gu, gu_ids, _ = load_array_with_ids(p["gnn_prefix"] + "_users")
    gd = gd_ids = du = du_ids = None
    try:
        _gd, _gd_ids, _ = load_array_with_ids(p["distilled"])
        du, du_ids, _ = load_array_with_ids(p["distilled_users"])
        gd, gd_ids = _gd, _gd_ids   # only when both sides loaded
    except FileNotFoundError:
        pass
    arm = "distill_cos" if gd is not None else "gnn_dot"
    try:
        with open(p["root"] + "/gnn_eval.json") as f:
            ge = json.load(f)
        avail = ("gnn_dot", "gnn_cos") + (("distill_cos",) if gd is not None else ())
        ge_rows = {r: ge[r] for r in avail if r in ge}
        if ge_rows:
            key = next(k for k in ("recall@100", "recall@20")
                       if any(k in v for v in ge_rows.values()))
            arm = max(ge_rows, key=lambda r: ge_rows[r].get(key, 0.0))
    except (FileNotFoundError, json.JSONDecodeError, StopIteration):
        pass  # truncated sidecar / other eval_ks: keep the fall-back arm
    if arm == "distill_cos":
        items = H.align_gnn_to_catalog(gd, gd_ids, item_map)
        users = H.align_gnn_users(du, du_ids, user_ids)
    else:
        if raw_items is None:
            gi, gi_ids, _ = load_array_with_ids(p["gnn_prefix"] + "_items")
            raw_items = H.align_gnn_to_catalog(gi, gi_ids, item_map)
        items = raw_items
        users = H.align_gnn_users(gu, gu_ids, user_ids)
    if arm in ("distill_cos", "gnn_cos"):
        items = items / np.clip(np.linalg.norm(items, axis=-1, keepdims=True), 1e-12, None)
        users = users / np.clip(np.linalg.norm(users, axis=-1, keepdims=True), 1e-12, None)
    return arm, items, users


def _brief(report: dict, table: bool = False) -> dict:
    """An ensemble report for the JSON: standalone rows as they are, each
    fusion method's best alpha and best row (and its table)."""
    out = {}
    for k, v in report.items():
        if k.startswith("standalone"):
            out[k] = v
        else:
            out[k] = {"best_alpha": v["best_alpha"], "best": v["best"]}
            if table:
                out[k]["table"] = {str(a): r for a, r in v["table"].items()}
    return out


def cmd_ensemble_eval(cfg: Config, args) -> dict:
    """Fuse the two learned retrievers: the stage-2 tower (the
    ``eval_uvecs`` / ``eval_item_matrix`` sidecars of ``eval``) x the GNN
    (``_gnn_arm``), then the best fused list x the repurchase baseline, and
    stage 2 x repurchase. Reads artifacts only: histories from
    features_sequence.parquet, targets from targets_val.json."""
    from recsys_tpu_torch.data.dataset import IdMap, target_index
    from recsys_tpu_torch.data.etl import logq_from_item_features
    from recsys_tpu_torch.eval.baselines import repurchase_topk
    from recsys_tpu_torch.eval.ensemble import (count_mix_ensemble, rrf_ensemble,
                                                weighted_score_ensemble)
    from recsys_tpu_torch.train import hybrid as H
    from recsys_tpu_torch.train.checkpoint import load_array_with_ids

    device = resolve_device(args.device)
    p = _paths(cfg)
    t0 = time.perf_counter()
    uvecs, uids, _ = load_array_with_ids(p["root"] + "/eval_uvecs")
    imat, iids, _ = load_array_with_ids(p["root"] + "/eval_item_matrix")
    item_map = IdMap([i for i in iids if i != "<pad>"])
    uids = [str(u) for u in uids]
    arm, gnn_mat, gu_aligned = _gnn_arm(cfg, item_map, uids)
    with open(p["targets"]) as f:
        targets = json.load(f)
    targets_idx = target_index(targets, item_map)
    seqs = pd.read_parquet(p["seqs"])
    seq_of = dict(zip(seqs["user_id"].astype(str), seqs["sequence"]))
    user_seqs = [seq_of.get(u, ()) for u in uids]
    flat = item_map.idx_array(list(chain.from_iterable(user_seqs)))
    hists = np.split(flat, np.cumsum([len(q) for q in user_seqs])[:-1]) if uids else []
    logq = logq_from_item_features(pd.read_parquet(p["item_feats"]), item_map.ids)

    m = min(int(getattr(args, "pool", None) or 1000), len(item_map))
    mesh = _mesh(cfg, args)
    on_card = _on_card(device)
    stage2 = H.topm_for_model(uvecs, imat, m, device, mesh=mesh, normalize_items=True)
    if gu_aligned.shape[1] != gnn_mat.shape[1]:
        raise SystemExit(f"gnn arm {arm}: user dim {gu_aligned.shape[1]} != "
                         f"item dim {gnn_mat.shape[1]}")
    gnn_model = H.topm_for_model(gu_aligned, gnn_mat, m, device, mesh=mesh,
                                 normalize_items=False)
    ks = cfg.user_train.eval_ks
    report = H.ensemble_report(stage2, gnn_model, uids, targets_idx, ks=ks, device=on_card)
    out = {"gnn_arm": arm, "m": m, "n_users": len(uids),
           "stage2_x_gnn": _brief(report, table=True)}
    key = f"recall@{sorted(ks)[min(1, len(ks) - 1)]}"
    best_method = max(("count_mix", "weighted", "rrf"), key=lambda mth: report[mth]["best"][key])
    ba = report[best_method]["best_alpha"]
    if best_method == "count_mix":
        fused = count_mix_ensemble(stage2[0], gnn_model[0], m, ba)
    elif best_method == "weighted":
        fused = weighted_score_ensemble(*stage2, *gnn_model, m, ba)
    else:
        fused = rrf_ensemble(stage2[0], gnn_model[0], m)
    rank_scores = -np.tile(np.arange(m, dtype=np.float32), (len(uids), 1))
    rep_idx = repurchase_topk(hists, logq, m)
    out["fused_x_repurchase"] = {
        "fused_from": {"method": best_method, "alpha": ba},
        **_brief(H.ensemble_report((fused, rank_scores), (rep_idx, rank_scores), uids,
                                   targets_idx, ks=ks, device=on_card))}
    out["stage2_x_repurchase"] = _brief(H.ensemble_report(
        stage2, (rep_idx, rank_scores), uids, targets_idx, ks=ks, device=on_card))
    with open(p["root"] + "/ensemble_eval.json", "w") as f:
        json.dump(out, f, indent=1, default=str)
    return {**out, "device": str(device), "seconds": time.perf_counter() - t0}


def _hybrid_inputs(cfg: Config, data: dict):
    """The hybrid tower's inputs from the artifacts: the stage-1 matrix, the
    GNN item vectors (both aligned to the stage-2 id map, PAD row 0) and the
    GNN user artifact (vectors, ids)."""
    from recsys_tpu_torch.train import hybrid as H
    from recsys_tpu_torch.train.checkpoint import load_array_with_ids

    p = _paths(cfg)
    content = _pretrained_matrix(cfg, data["item_map"], required=True)
    gi, gi_ids, _ = load_array_with_ids(p["gnn_prefix"] + "_items")
    gnn_items = H.align_gnn_to_catalog(gi, gi_ids, data["item_map"])
    gu, gu_ids, _ = load_array_with_ids(p["gnn_prefix"] + "_users")
    return content, gnn_items, gu, gu_ids


def cmd_train_hybrid(cfg: Config, args) -> dict:
    """The hybrid content+GNN tower over the exported artifacts, its adapted
    item matrix (the serving matrix of ``serve --vectors hybrid``), then,
    with ``user_train.hybrid_report``, the ensemble report: hybrid x GNN
    (standalone + count-mix / weighted / RRF sweeps), hybrid x repurchase and
    x content profile, the prior blend over the hybrid vectors and the
    paired-bootstrap significance against repurchase."""
    from recsys_tpu_torch.eval.baselines import blend_sweep, content_profile_topk, repurchase_topk
    from recsys_tpu_torch.eval.recall import (bootstrap_mean_ci, paired_delta_ci,
                                              recall_per_user, target_rows)
    from recsys_tpu_torch.train import hybrid as H
    from recsys_tpu_torch.train.checkpoint import save_array_with_ids
    from recsys_tpu_torch.train.sasrec import prepare_stage2, tensors_to

    device = resolve_device(args.device)
    p = _paths(cfg)
    items, users, tx = _load_world(cfg)
    data = prepare_stage2(cfg, items, users, tx)
    content, gnn_items, gu, gu_ids = _hybrid_inputs(cfg, data)
    tensors = data["tensors"]
    uids = tensors["user_ids"]
    gnn_users = H.align_gnn_users(gu, gu_ids, uids)
    mesh = _mesh(cfg, args)
    t0 = time.perf_counter()
    state, history, (model, uv_fn, im_fn) = H.train_hybrid(
        cfg, data, content, gnn_items, gnn_users, p["root"] + "/ckpt_hybrid", device, mesh)
    train_seconds = time.perf_counter() - t0
    im = im_fn().cpu().numpy()
    save_array_with_ids(p["root"] + "/hybrid_item_matrix", im, list(data["item_map"].ids),
                        meta={"source": "train-hybrid best checkpoint"})
    out = {"hybrid_best": _best_epoch(history),
           "hybrid_final": history[-1] if history else {},
           "hybrid_history": history, "device": str(device), "steps": state.step,
           "graph_replays": state.graph_replays, "seconds": train_seconds,
           "epoch_losses": state.losses,
           "step_ms_median": _median_ms(state.step_seconds),
           "logit_scale": model.logit_scale.item()}
    if not cfg.user_train.hybrid_report:
        return {**out, "report": "skipped"}

    # the report scores the users with targets, in whole batches
    t0 = time.perf_counter()
    laps = _Laps()
    on_card = _on_card(device)
    rows = target_rows(uids, data["targets_idx"])
    n = len(rows)
    bs = min(cfg.user_train.batch_size, max(n - n % 8, 8))
    rows = rows[: n - n % bs]
    uvecs = H.hybrid_user_vectors(uv_fn, tensors_to(tensors, device),
                                  torch.as_tensor(gnn_users, device=device), rows, bs)
    uvecs = (uvecs.float().cpu().numpy() if len(rows)
             else np.zeros((0, cfg.user_tower.d_model), np.float32))
    laps("user_vectors")
    user_ids = [uids[r] for r in rows]
    targets_idx = data["targets_idx"]
    ks = cfg.user_train.eval_ks
    m = min(1000, len(data["item_map"]))
    seq_model = H.topm_for_model(uvecs, im, m, device, normalize_items=False)
    arm, gnn_mat, gu_aligned = _gnn_arm(cfg, data["item_map"], user_ids, raw_items=gnn_items)
    if gu_aligned.shape[1] != gnn_mat.shape[1]:
        gnn_model, arm = seq_model, "degenerate_seq"   # dims mismatch
    else:
        gnn_model = H.topm_for_model(gu_aligned, gnn_mat, m, device, normalize_items=False)
    laps("top_m")
    report = H.ensemble_report(seq_model, gnn_model, user_ids, targets_idx, ks=ks,
                               device=on_card, lap=lambda name: laps(f"gnn_{name}"))
    # fusion with the lists that carry real recall on retail-shaped data:
    # repurchase and content profile, pseudo-scores -rank
    hist = np.concatenate([tensors["input_ids"][rows], tensors["target_ids"][rows][:, -1:]], 1)
    m_alive = seq_model[0].shape[1]
    rank_scores = -np.tile(np.arange(m_alive, dtype=np.float32), (len(user_ids), 1))
    hist_list = [hist[r] for r in range(len(hist))]
    rep_idx = repurchase_topk(hist_list, data["logq"], m_alive)
    cp_idx = content_profile_topk(hist_list, content, m_alive, device=on_card)
    laps("repurchase_and_content_lists")
    report_alive = {
        "hybrid_x_repurchase": H.ensemble_report(
            seq_model, (rep_idx, rank_scores), user_ids, targets_idx, ks=ks, device=on_card,
            lap=lambda name: laps(f"repurchase_{name}")),
        "hybrid_x_content": H.ensemble_report(
            seq_model, (cp_idx, rank_scores), user_ids, targets_idx, ks=ks, device=on_card,
            lap=lambda name: laps(f"content_{name}"))}
    sks = sorted(ks)
    k_primary = sks[min(1, len(sks) - 1)]
    blend = blend_sweep(uvecs, im, data["logq"], hist, user_ids, targets_idx, ks=ks,
                        per_user_k=k_primary, device=on_card)
    blend_pu = blend.pop("_per_user")
    laps("blend_sweep")
    out.update({"blend": {"best": blend["best"], "best_metrics": blend["best_metrics"]},
                "gnn_arm": arm, "ensemble": _brief(report),
                "ensemble_alive": {name: _brief(rep) for name, rep in report_alive.items()}})
    # does the hybrid tower itself (not just the blend) beat the repurchase
    # floor user by user?
    rep_idx = repurchase_topk(hist_list, data["logq"], k_primary)
    rep_vals, rep_uids = recall_per_user(rep_idx, user_ids, targets_idx, k_primary)
    hybrid_pu = blend_pu.get("model_only")
    if rep_uids == blend_pu["uids"]:
        out["significance"] = {"k": k_primary,
                               "blend_best": bootstrap_mean_ci(blend_pu["best"]),
                               "repurchase": bootstrap_mean_ci(rep_vals),
                               "blend_vs_repurchase": paired_delta_ci(blend_pu["best"],
                                                                      rep_vals)}
        if hybrid_pu is not None:
            out["significance"]["hybrid"] = bootstrap_mean_ci(hybrid_pu)
            out["significance"]["hybrid_vs_repurchase"] = paired_delta_ci(hybrid_pu, rep_vals)
    with open(p["root"] + "/ensemble_report.json", "w") as f:
        json.dump(report, f, indent=1, default=str)
    laps("significance")
    out["report_seconds"] = time.perf_counter() - t0
    out["report_seconds_split"] = laps.seconds
    return out


def cmd_rerank_eval(cfg: Config, args) -> dict:
    """Recall of the ranking pipeline: candidate union (tower cosine top-M,
    the user's seen items, popularity top-P) -> pair features -> GBDT rerank
    -> Recall@k. The ranker trains on an inner time split strictly inside
    the training window (``eval/rerank_eval.py``), with a DCN arm on the same
    features; ``--vectors`` picks the tower whose vectors build the pools
    (``stage2``: the best stage-2 checkpoint; ``hybrid``: the best hybrid
    checkpoint and the GNN artifacts)."""
    from recsys_tpu_torch.config import _replace_tree
    from recsys_tpu_torch.data.etl import grouped_lists, time_split
    from recsys_tpu_torch.eval import rerank_eval as R
    from recsys_tpu_torch.eval.baselines import popularity_ranking, repurchase_topk
    from recsys_tpu_torch.eval.recall import (TargetTable, bootstrap_mean_ci,
                                              paired_delta_ci, recall_at_ks,
                                              recall_per_user, target_rows)
    from recsys_tpu_torch.train.checkpoint import load_array_with_ids, save_array_with_ids
    from recsys_tpu_torch.train.reranker import GBDTRanker, auc_score, train_dcn
    from recsys_tpu_torch.train.sasrec import (collect_user_vectors, prepare_stage2,
                                               restore_stage2, tensors_to)

    device = resolve_device(args.device)
    p = _paths(cfg)
    t_start = time.perf_counter()
    laps = _Laps()
    items, users, tx = _load_world(cfg)
    data = prepare_stage2(cfg, items, users, tx)
    laps("prepare")
    item_map = data["item_map"]
    N1 = len(item_map) + 1
    ks = sorted(cfg.user_train.eval_ks)
    k_primary = ks[min(1, len(ks) - 1)]
    max_k = max(ks)
    tens = data["tensors"]
    vectors = getattr(args, "vectors", None) or "stage2"
    if vectors == "hybrid":
        from recsys_tpu_torch.train import hybrid as H

        content, gnn_items, gu, gu_ids = _hybrid_inputs(cfg, data)
        _, h_uv, h_im = H.restore_hybrid(cfg, data, content, gnn_items,
                                         p["root"] + "/ckpt_hybrid", device)
        item_mat = h_im().cpu().numpy()
        save_array_with_ids(p["root"] + "/hybrid_item_matrix", item_mat, list(item_map.ids),
                            meta={"source": "rerank-eval hybrid restore"})

        def collect_vecs(dat, rows_):
            tns = dat["tensors"]
            gus = torch.as_tensor(H.align_gnn_users(gu, gu_ids, tns["user_ids"]), device=device)
            n_ = len(rows_)
            bs_ = min(cfg.user_train.batch_size, max(n_ - n_ % 8, 8))
            if not n_:
                return np.zeros((0, cfg.user_tower.d_model), np.float32)
            return H.hybrid_user_vectors(h_uv, tensors_to(tns, device), gus, rows_,
                                         bs_).float().cpu().numpy()
    elif vectors == "stage2":
        pretrained = _pretrained_matrix(cfg, item_map, required=True)
        model, uv, _ = restore_stage2(cfg, data, p["user_ckpts"], device, pretrained)
        item_mat = model.item.item_matrix.detach().float().cpu().numpy()

        def collect_vecs(dat, rows_):
            n_ = len(rows_)
            return collect_user_vectors(cfg, uv, dat, device,
                                        min(cfg.user_train.batch_size, max(n_ - n_ % 8, 8)),
                                        rows=np.asarray(rows_, np.int64))[0]
    else:
        raise ValueError(f"--vectors {vectors!r} (stage2 | hybrid)")

    rows = target_rows(tens["user_ids"], data["targets_idx"])
    uids = [tens["user_ids"][r] for r in rows]
    uvecs = None
    if vectors == "stage2":
        # the vectors eval persisted, when they are of this eval set
        try:
            arr, aids, _ = load_array_with_ids(p["root"] + "/eval_uvecs")
            if list(aids) == [str(u) for u in uids]:
                uvecs = arr
        except FileNotFoundError:
            pass
    if uvecs is None:
        uvecs = collect_vecs(data, rows)
    laps("restore_and_user_vectors")

    pool_size = int(getattr(args, "pool", None) or 512)
    m_cos = min(int(getattr(args, "m_cos", None) or 300), N1 - 2)
    m_pop = min(int(getattr(args, "m_pop", None) or 100), N1 - 2)
    train_tx, _, split_day = time_split(tx, cfg.data.valid_days)
    ifeats = pd.read_parquet(p["item_feats"]).set_index("item_id")
    price = item_column(ifeats, "avg_item_price_log", item_map, N1)
    laps("time_split_and_prices")

    def side_of(window_tx, uid_list, logq, uv, now_day):
        """Pools + features + histories for one user set / time window."""
        uid_to_row = {u: r for r, u in enumerate(uid_list)}
        sub = window_tx[window_tx["user_id"].isin(uid_to_row)]
        urow = sub["user_id"].map(uid_to_row).to_numpy(np.int64)
        iidx = item_map.idx_array(sub["item_id"]).astype(np.int64)
        day = sub["day"].to_numpy(np.int64)
        order = np.lexsort((day, urow))
        urow, iidx, day = urow[order], iidx[order], day[order]
        hists = [np.empty(0, np.int64) for _ in uid_list]
        if len(urow):
            starts = np.flatnonzero(np.concatenate([[True], urow[1:] != urow[:-1]]))
            bounds = np.append(starts, len(urow))
            for j, s in enumerate(starts):
                hists[urow[s]] = iidx[s:bounds[j + 1]]
        keys, counts, last = R.pair_index(urow, iidx, day, N1)
        laps("side_data")
        cos_idx = R.cosine_topm(uv, item_mat, m_cos, torch_device=device)
        pop = popularity_ranking(logq, m_pop)
        pools, flags = R.build_pools(cos_idx, hists, pop, pool_size)
        laps("pools")
        hist_lens = np.array([len(h) for h in hists], np.int64)
        user_last = np.full(len(uid_list), -1, np.int64)
        if len(urow):
            np.maximum.at(user_last, urow, day)
        psum = np.zeros(len(uid_list), np.float64)
        if len(urow):
            np.add.at(psum, urow, price[iidx])
        user_price = (psum / np.maximum(hist_lens, 1)).astype(np.float32)
        feats = R.pool_features(pools, flags, uv, item_mat, logq, keys, counts, last, now_day,
                                N1, price, hist_lens=hist_lens, user_last_day=user_last,
                                user_price=user_price)
        laps("features")
        return pools, feats, hists

    # ---- inner split: train the ranker strictly inside the train window
    cfg2 = _replace_tree(cfg, {"data": {"valid_days": cfg.data.valid_days * 2}})
    data2 = prepare_stage2(cfg2, items, users, tx)
    laps("prepare_inner")
    split2 = data2["split_day"]
    lab_tx = tx[(tx["day"] >= split2) & (tx["day"] < split_day)]
    lab_idx = item_map.idx_array(lab_tx["item_id"])
    known = lab_idx > 0
    inner_targets = {u: set(its) for u, its in grouped_lists(
        lab_tx["user_id"].to_numpy()[known], lab_idx[known], sort=False).items()}
    row2_of = {u: r for r, u in enumerate(data2["tensors"]["user_ids"])}
    cand = sorted(u for u in inner_targets if u in row2_of)
    n_sample = int(getattr(args, "sample", None) or 20000)
    rng = np.random.default_rng(cfg.data.seed)
    if len(cand) > n_sample:
        cand = [cand[j] for j in rng.choice(len(cand), n_sample, replace=False)]
    rows2 = np.array([row2_of[u] for u in cand], np.int64)
    uv2 = collect_vecs(data2, rows2)
    laps("inner_targets_and_user_vectors")
    inner_tx = tx[tx["day"] < split2]
    pools2, feats2, _ = side_of(inner_tx, cand, data2["logq"], uv2, split2)
    y2 = np.zeros(pools2.shape, np.float32)
    for r, u in enumerate(cand):
        y2[r] = np.isin(pools2[r], list(inner_targets[u]))
    # user-level 90/10 split: the rankers train on the first 90% of the inner
    # users, the rest is held out for AUC / importances
    n_tr = max(int(0.9 * len(cand)), 1)

    def _flat(f, pl, yy):
        keep = pl.reshape(-1) != 0
        return f.reshape(-1, f.shape[-1])[keep], yy.reshape(-1)[keep]

    X, y = _flat(feats2[:n_tr], pools2[:n_tr], y2[:n_tr])
    X_val, y_val = _flat(feats2[n_tr:], pools2[n_tr:], y2[n_tr:])
    t0 = time.perf_counter()
    ranker = GBDTRanker(iterations=int(getattr(args, "iterations", None) or 200),
                        device=device).fit(X, y)
    gbdt_seconds = time.perf_counter() - t0
    ranker.save(p["root"] + f"/rerank_gbdt_{vectors}.pkl")
    laps("gbdt")
    gbdt_auc = importances = dcn_auc = dcn_scorer = None
    dcn_fit: dict = {}
    if len(X_val) and 0 < y_val.sum() < len(y_val):
        if len(X_val) > 200_000:      # cap the held-out slice for the permutation passes
            sel = np.random.default_rng(0).choice(len(X_val), 200_000, replace=False)
            X_val, y_val = X_val[sel], y_val[sel]
        gbdt_auc = round(auc_score(y_val, ranker.predict_proba(X_val)), 4)
        rngp = np.random.default_rng(1)
        importances = {}
        for j, nm in enumerate(R.FEATURE_NAMES):
            deltas = []
            for _ in range(3):
                Xp = X_val.copy()
                rngp.shuffle(Xp[:, j])
                deltas.append(gbdt_auc - auc_score(y_val, ranker.predict_proba(Xp)))
            importances[nm] = round(float(np.mean(deltas)), 4)
        laps("gbdt_auc_and_importances")
        # the neural arm (DCN-v2): the same features, subsampled rows, a short
        # schedule; it answers "is the learned-ranker story GBDT-only?"
        sel = (np.random.default_rng(2).choice(len(X), 2_000_000, replace=False)
               if len(X) > 2_000_000 else np.arange(len(X)))
        cfg_dcn = _replace_tree(cfg, {"reranker": {"epochs": 3, "loss": "bce"}})
        t0, before = time.perf_counter(), _launch_counts()
        dcn_state, _, dcn_scorer = train_dcn(cfg_dcn, X[sel], y[sel], device=device)
        dcn_fit = {"dcn_steps": dcn_state.step, "dcn_graph_replays": dcn_state.graph_replays,
                   "dcn_seconds": time.perf_counter() - t0,
                   "dcn_launches": _launches_since(before),
                   "dcn_step_ms_median": _median_ms(dcn_state.step_seconds)}
        dcn_auc = round(auc_score(y_val, dcn_scorer(X_val)), 4)
        laps("dcn")

    # ---- the real validation week, deployment regime
    pools, feats, hists = side_of(train_tx, uids, data["logq"], uvecs, split_day)
    topk = R.rerank_topk(ranker, feats, pools, max_k)
    laps("rerank")
    targets_idx = data["targets_idx"]
    table = TargetTable(uids, targets_idx)
    metrics = recall_at_ks(topk, uids, targets_idx, ks, table=table)
    ceiling = recall_at_ks(pools, uids, targets_idx, [pool_size], table=table)
    rep_idx = repurchase_topk(hists, data["logq"], k_primary)
    rep_vals, rep_uids = recall_per_user(rep_idx, uids, targets_idx, k_primary, table=table)
    rr_vals, rr_uids = recall_per_user(topk, uids, targets_idx, k_primary, table=table)
    out = {"reranked": metrics,
           "pool_ceiling": {f"recall@{pool_size}": ceiling[f"recall@{pool_size}"]},
           # at k >= pool_size the list is the candidate pool: recall == ceiling
           "pool_capped_ks": [k for k in ks if k >= pool_size],
           "gbdt_auc": gbdt_auc, "dcn_auc": dcn_auc,
           "gbdt_importances_auc_drop": importances,
           "pool_arms": {"m_cos": m_cos, "m_pop": m_pop},
           "train_users": len(cand), "holdout_users": len(cand) - n_tr,
           "pool_size": pool_size, "vectors": vectors, "inner_split_day": int(split2)}
    if dcn_scorer is not None:
        class _Scorer:  # rerank_topk wants a .predict_proba
            predict_proba = staticmethod(dcn_scorer)
        out["reranked_dcn"] = recall_at_ks(R.rerank_topk(_Scorer, feats, pools, max_k), uids,
                                           targets_idx, ks, table=table)
    if rep_uids == rr_uids:
        out["significance"] = {"k": k_primary, "reranked": bootstrap_mean_ci(rr_vals),
                               "repurchase_full_hist": bootstrap_mean_ci(rep_vals),
                               "reranked_vs_repurchase": paired_delta_ci(rr_vals, rep_vals)}
    with open(p["root"] + f"/rerank_eval_{vectors}.json", "w") as f:
        json.dump(out, f, indent=1)
    laps("recall")
    return {**out, "device": str(device), "gbdt_iterations": ranker.n_iter_,
            "gbdt_seconds": gbdt_seconds, **dcn_fit, "seconds": time.perf_counter() - t_start,
            "seconds_split": laps.seconds}


def attach_user_backend(cfg: Config, ctx, device) -> str:
    """Attach the user vectorizer that ``serve.user_backend`` names, in the
    JAX server's order: ``hybrid`` the best hybrid checkpoint with the GNN
    artifacts, ``stage2`` the best stage-2 checkpoint (each raises
    FileNotFoundError without its checkpoint), ``auto`` the hybrid tower,
    else the stage-2 tower, else the history mean, ``history`` the history
    mean. Returns what was attached."""
    from recsys_tpu_torch.serve.app import hybrid_user_vectorizer, tower_user_vectorizer
    from recsys_tpu_torch.train import hybrid as H
    from recsys_tpu_torch.train.sasrec import prepare_stage2, restore_stage2

    backend = cfg.serve.user_backend
    if backend not in ("auto", "hybrid", "stage2", "history"):
        raise ValueError(f"unknown serve.user_backend {backend!r}")
    if backend == "history":
        return ctx.user_backend
    p = _paths(cfg)
    items, users, tx = _load_world(cfg)
    data = prepare_stage2(cfg, items, users, tx)
    item_ids = ["<pad>"] + list(data["item_map"].ids)
    if backend in ("auto", "hybrid"):
        try:
            content, gnn_items, gu, gu_ids = _hybrid_inputs(cfg, data)
            _, h_uv, _ = H.restore_hybrid(cfg, data, content, gnn_items,
                                          p["root"] + "/ckpt_hybrid", device)
            ctx.user_vectorize_fn = hybrid_user_vectorizer(
                ctx, cfg, h_uv, item_ids, {str(u): gu[r] for r, u in enumerate(gu_ids)},
                gnn_items.shape[1], device)
            ctx.user_backend = "hybrid tower (best checkpoint)"
            return ctx.user_backend
        except FileNotFoundError:
            if backend == "hybrid":
                raise
    manifest = os.path.join(p["user_ckpts"], "manifest.json")
    if backend == "auto" and not os.path.exists(manifest):
        return ctx.user_backend
    _, user_vectors, entry = restore_stage2(cfg, data, p["user_ckpts"], device)
    if entry is None:
        raise FileNotFoundError(f"no best stage-2 checkpoint in {p['user_ckpts']}")
    ctx.user_vectorize_fn = tower_user_vectorizer(ctx, cfg, user_vectors, item_ids, device)
    ctx.user_backend = "stage-2 tower (best checkpoint)"
    return ctx.user_backend


def build_app(cfg: Config, args):
    """The serving context of ``serve``: store, index, vectorizers and the
    store-backed trainers of the ``/train/*`` routes, all on ``--device``."""
    from recsys_tpu_torch.serve.app import build_app_context, model_vectorizer
    from recsys_tpu_torch.serve.train_glue import make_item_trainer, make_user_trainer

    device = resolve_device(args.device)
    p = _paths(cfg)
    vec = None
    model_backed = getattr(args, "model_backed", False)
    if model_backed:
        from recsys_tpu_torch.data.vocab import StdVocab
        from recsys_tpu_torch.train.simcse import restore_model

        model, _ = restore_model(cfg, p["item_ckpts"], StdVocab().num_fields, device)
        vec = model_vectorizer(cfg, model, device)
    ctx = build_app_context(cfg, vec, device)
    ctx.train_item_fn = make_item_trainer(cfg, ctx.store, device, p["item_ckpts"])
    ctx.train_user_fn = make_user_trainer(cfg, ctx.store, device, p["user_ckpts"])
    # the blend/rerank serving assets of the tower ``--vectors`` names
    from recsys_tpu_torch.serve.recommend import load_recommend_assets

    vectors = getattr(args, "vectors", None) or "stage2"
    try:
        ctx.rec_assets = load_recommend_assets(cfg, vectors, device=device)
        print(f"serving assets: {vectors} matrix"
              + (" + rerank GBDT" if ctx.rec_assets.ranker else ""), flush=True)
    except FileNotFoundError:
        print("serving assets: none (blend/rerank modes fall back to cosine)", flush=True)
    if model_backed:
        print(f"user vectorizer: {attach_user_backend(cfg, ctx, device)}", flush=True)
    return ctx


def cmd_serve(cfg: Config, args) -> dict:
    from recsys_tpu_torch.serve.server import make_server

    server = make_server(build_app(cfg, args), port=getattr(args, "port", None))
    print(f"serving on {server.server_address}", flush=True)
    server.serve_forever()
    return {}


def cmd_orchestrate(cfg: Config, args) -> dict:
    """The scheduler against a running server: hourly, ingest -> loop
    process-pending until drained (cap 100); weekly, POST /train/start.
    ``--once`` runs a single hourly cycle."""
    import urllib.request

    base = getattr(args, "server", None) or f"http://{cfg.serve.host}:{cfg.serve.port}"

    def call(method, path, payload=None):
        req = urllib.request.Request(
            base + path, method=method,
            data=None if payload is None else json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    if getattr(args, "once", False):
        return _hourly_cycle(call)

    last_weekly = 0.0
    while True:  # pragma: no cover - long-running scheduler
        _, last_weekly = orchestrate_cycles(call, 1, last_weekly=last_weekly, log=True)
        time.sleep(3600)


def _hourly_cycle(call) -> dict:
    drained, loops = 0, 0
    while loops < 100:  # loop cap
        r = call("POST", "/ai-api/serving/vectors/process-pending", {})
        if r.get("processed_count", 0) == 0:
            break
        drained += r["processed_count"]
        loops += 1
    return {"vectorized": drained, "loops": loops}


def orchestrate_cycles(call, n_cycles: int, *, last_weekly: float = 0.0,
                       weekly_interval: float = 7 * 24 * 3600.0,
                       now_fn=time.time, log: bool = False):
    """``n_cycles`` hourly cycles, each followed by the weekly train trigger
    when it is due; ``call(method, path, payload)`` and the clock ``now_fn``
    are injected, so the weekly branch can be driven in a test. Returns
    (records, last_weekly)."""
    records = []
    for _ in range(n_cycles):
        rec = {"hourly": _hourly_cycle(call), "t": now_fn()}
        if now_fn() - last_weekly > weekly_interval:
            rec["weekly"] = call("POST", "/ai-api/serving/train/start", {})
            last_weekly = now_fn()
        if log:
            print(json.dumps(rec), flush=True)
        records.append(rec)
    return records, last_weekly


COMMANDS = {
    "gen-data": cmd_gen_data,
    "ingest-hm": cmd_ingest_hm,
    "enrich": cmd_enrich,
    "etl": cmd_etl,
    "pretrain-text": cmd_pretrain_text,
    "train-item": cmd_train_item,
    "vectorize": cmd_vectorize,
    "train-gnn": cmd_train_gnn,
    "distill": cmd_distill,
    "gnn-eval": cmd_gnn_eval,
    "train-user": cmd_train_user,
    "eval": cmd_eval,
    "train-reranker": cmd_train_reranker,
    "train-hybrid": cmd_train_hybrid,
    "ensemble-eval": cmd_ensemble_eval,
    "rerank-eval": cmd_rerank_eval,
    "serve": cmd_serve,
    "orchestrate": cmd_orchestrate,
}


def parse_args(argv=None):
    parser = argparse.ArgumentParser("recsys_tpu_torch pipeline")
    parser.add_argument("command", choices=sorted(COMMANDS))
    parser.add_argument("--config", default=None, help="JSON config overrides file")
    parser.add_argument("--set", action="append", default=[],
                        help="dotted overrides, e.g. --set data.num_items=500")
    parser.add_argument("--device", default="cuda",
                        help="torch device for the model stages (cuda | cpu)")
    parser.add_argument("--virtual-shards", action="store_true", dest="virtual_shards",
                        help="lay a mesh larger than the visible cards over them")
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--model-backed", action="store_true", dest="model_backed")
    parser.add_argument("--init-ckpt", default=None, dest="init_ckpt")
    parser.add_argument("--resume", action="store_true",
                        help="train-gnn, train-user: continue from the latest checkpoint")
    parser.add_argument("--deadline", type=float, default=None,
                        help="train-user: a Unix time; no epoch starts that the last "
                             "epoch's length says would end after it")
    parser.add_argument("--fine-tune", action="store_true", dest="fine_tune",
                        help="train-gnn: previous weights, fresh optimizer, cosine decay")
    parser.add_argument("--iterations", type=int, default=None,
                        help="train-reranker, rerank-eval: boosting iterations (default 200)")
    parser.add_argument("--vectors", default=None, choices=["stage2", "hybrid"],
                        help="rerank-eval, serve: which tower's vectors (default stage2)")
    parser.add_argument("--pool", type=int, default=None,
                        help="rerank-eval: candidate pool a user (512); ensemble-eval: "
                             "top-M a model (1000)")
    parser.add_argument("--m-cos", type=int, default=None, dest="m_cos",
                        help="rerank-eval: the cosine arm of the pool union (300)")
    parser.add_argument("--m-pop", type=int, default=None, dest="m_pop",
                        help="rerank-eval: the popularity arm of the pool union (100)")
    parser.add_argument("--sample", type=int, default=None,
                        help="rerank-eval: inner-split ranker users sampled (20000)")
    parser.add_argument("--hm-dir", default=None, dest="hm_dir",
                        help="ingest-hm: directory with the H&M Kaggle CSVs")
    parser.add_argument("--date-min", default=None, dest="date_min",
                        help="ingest-hm: first t_dat kept (ISO date)")
    parser.add_argument("--date-max", default=None, dest="date_max",
                        help="ingest-hm: last t_dat kept (ISO date)")
    parser.add_argument("--once", action="store_true",
                        help="orchestrate: one hourly cycle, then exit")
    parser.add_argument("--server", default=None,
                        help="orchestrate: base URL of the server (default serve.host:port)")
    return parser.parse_args(argv)


def config_from_args(args) -> Config:
    overrides: dict = {}
    for kv in args.set:
        key, _, raw = kv.partition("=")
        node = overrides
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        try:
            node[parts[-1]] = json.loads(raw)
        except json.JSONDecodeError:
            node[parts[-1]] = raw
    return load_config(args.config, overrides)


def main(argv=None):
    args = parse_args(argv)
    result = COMMANDS[args.command](config_from_args(args), args)
    print(json.dumps({"command": args.command, **(result or {})}, default=str),
          flush=True)
    return result


if __name__ == "__main__":
    main()
