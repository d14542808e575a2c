"""Pipeline CLI of the port: the stages of the item-vector, GNN and reranker
slices.

Counterpart of ``recsys_tpu/pipeline/cli.py``, with the same ``--set``
overrides, artifact paths and one JSON line per stage:

  gen-data     synthetic persona world -> parquet (items/users/transactions)
  etl          splits + item/user/sequence features + validation targets
  train-item   stage-1 SimCSE                        -> checkpoints
  vectorize    materialize the (N+1, 128) item matrix artifact
  train-gnn    LightGCL (``--resume``, ``--fine-tune``) -> graph embeddings
  distill      magnitude->cosine projector           -> distilled vectors
  gnn-eval     GNN recall rows + distillation fidelity -> gnn_eval.json
  train-user   stage-2 SASRec user tower (``--resume``)  -> checkpoints
  eval         full-catalog Recall@{20,100,500} + baselines + blend sweep +
               paired-bootstrap significance -> eval.json
  train-reranker  GBDT (``--iterations``) + DCN rerankers on tower candidates
               -> reranker_gbdt.pkl
  serve        HTTP server; ``--model-backed`` vectorizes items with the
               trained encoder and users per ``serve.user_backend``
               (``stage2``: the best stage-2 checkpoint; ``auto``: that
               checkpoint when it exists, else the history mean)

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

import numpy as np
import pandas as pd

from recsys_tpu_torch.config import Config, load_config
from recsys_tpu_torch.device import resolve_device


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


def cmd_train_item(cfg: Config, args) -> dict:
    from recsys_tpu_torch.train.simcse import train_simcse

    device = resolve_device(args.device)
    p = _paths(cfg)
    tensors = _item_tensors(cfg)
    t0 = time.perf_counter()
    mesh = _mesh(cfg, args)
    state = train_simcse(cfg, tensors, p["item_ckpts"], device,
                         init_ckpt=getattr(args, "init_ckpt", None), mesh=mesh)
    seconds = time.perf_counter() - t0
    steady = state.step_seconds[1:] or state.step_seconds
    return {"steps": state.step, "ckpt_dir": p["item_ckpts"], "device": str(device),
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
                                         resume=getattr(args, "resume", False))
    return {"epochs": len(history), "best": _best_epoch(history),
            "final": history[-1] if history else {}, "device": str(device),
            "steps": state.step, "seconds": time.perf_counter() - t0,
            "epoch_losses": state.losses, "step_ms_median": _median_ms(state.step_seconds)}


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
    items, users, tx = _load_world(cfg)
    data = prepare_stage2(cfg, items, users, tx)
    pretrained = _pretrained_matrix(cfg, data["item_map"], required=True)
    tens = data["tensors"]
    bs = batch_plan(cfg, tens["input_ids"].shape[0])[0]
    model, uv_fn, _ = restore_stage2(cfg, data, p["user_ckpts"], device, pretrained)
    mesh = _mesh(cfg, args)
    dev_tensors = tensors_to(tens, device)
    timer = StepTimer(device)
    metrics = evaluate_stage2(cfg, model, uv_fn, data, device, mesh, bs, dev_tensors, timer)
    eval_seconds = timer.seconds()
    # the baselines' and the blend's device paths run on the card, the host
    # paths (the JAX package's numpy code) elsewhere
    on_card = device if device.type == "cuda" else None
    ks = sorted(cfg.user_train.eval_ks)
    k_primary = ks[min(1, len(ks) - 1)]
    rows = target_rows(tens["user_ids"], data["targets_idx"])
    sub = {"user_ids": [tens["user_ids"][r] for r in rows],
           "input_ids": tens["input_ids"][rows], "target_ids": tens["target_ids"][rows]}
    metrics["baselines"] = baseline_report(sub, data["logq"], data["targets_idx"],
                                           ks=cfg.user_train.eval_ks, item_matrix=pretrained,
                                           per_user_k=k_primary, device=on_card)
    base_pu = metrics["baselines"].pop("_per_user")
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
    with open(p["eval"], "w") as f:
        json.dump(metrics, f, indent=1)
    return {**metrics, "device": str(device), "step_ms_median": _median_ms(eval_seconds)}


def cmd_train_gnn(cfg: Config, args) -> dict:
    from recsys_tpu_torch.data.etl import time_split
    from recsys_tpu_torch.ops.spmm import CsrGraph
    from recsys_tpu_torch.train.gnn import (
        export_gnn_artifacts, gnn_propagation_check, graph_from_transactions,
        select_propagation, train_lightgcl)

    device = resolve_device(args.device)
    p = _paths(cfg)
    items, users, tx = _load_world(cfg)
    train_tx, _, _ = time_split(tx, cfg.data.valid_days)
    user_ids = sorted(train_tx["user_id"].unique())
    item_ids = sorted(items["item_id"].astype(str))
    user_map = {u: r for r, u in enumerate(user_ids)}
    item_map = {i: r for r, i in enumerate(item_ids)}
    graph = graph_from_transactions(train_tx, user_map, item_map, cfg.gnn,
                                    cfg.data.seed)
    eu = np.array([user_map[u] for u in train_tx["user_id"]])
    ei = np.array([item_map[i] for i in train_tx["item_id"]])
    # one graph layout serves the trainer, the export and the check
    propagation = select_propagation(cfg.gnn, graph, graph.num_nodes, device,
                                     _mesh(cfg, args))
    layout = propagation[1] if isinstance(propagation[1], CsrGraph) else None
    t0 = time.perf_counter()
    state, model = train_lightgcl(cfg, graph, eu, ei, p["gnn_ckpts"], device,
                                  resume=getattr(args, "resume", False),
                                  fine_tune=getattr(args, "fine_tune", False),
                                  propagation=propagation)
    seconds = time.perf_counter() - t0
    export_gnn_artifacts(model, graph, user_ids, item_ids, p["gnn_prefix"],
                         cfg.gnn.num_layers, device, layout)
    steady = state.step_seconds[1:] or state.step_seconds
    return {"check": gnn_propagation_check(model, graph, device, layout),
            "device": str(device), "steps": state.step, "seconds": seconds,
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
    state, model = train_distill(cfg, tu, ti, p["gnn_ckpts"], device)
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
            "fidelity": fid, "device": str(device), "epoch_losses": state.losses}


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
    uvecs = {}
    for uid, g in train_tx.groupby("user_id"):
        rows = [item_map.idx(i) for i in g["item_id"]]
        uvecs[uid] = mat[[r for r in rows if r > 0]].mean(0) if rows else mat[0]
    if cfg.reranker.negative_source == "candidates":
        uids, iidx, labels, groups = import_interactions_candidates(
            train_tx.tail(20000), uvecs, mat, item_map, rng,
            cfg.reranker.neg_per_pos, cfg.reranker.candidate_top_k)
    else:
        uids, iidx, labels, groups = import_interactions(
            train_tx.tail(20000), len(item_map), item_map, rng,
            cfg.reranker.neg_per_pos)
    ifeats = pd.read_parquet(p["item_feats"]).set_index("item_id")
    pop = np.zeros(len(mat), np.float32)
    price = np.zeros(len(mat), np.float32)
    for iid, r in zip(item_map.ids, range(1, len(mat))):
        if iid in ifeats.index:
            pop[r] = ifeats.loc[iid, "pop_1m_log"]
            price[r] = ifeats.loc[iid, "avg_item_price_log"]
    item_meta = np.stack([pop, price], axis=1)
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
    state, _, predict = train_dcn(cfg, X[:split], y[:split], groups=groups[:split],
                                  device=device)
    dcn_seconds = time.perf_counter() - t0
    dcn_auc = auc_score(y[split:], predict(X[split:]))
    gbdt.save(f"{p['root']}/reranker_gbdt.pkl")
    steady = state.step_seconds[1:] or state.step_seconds
    return {"gbdt_auc": round(gbdt_auc, 4), "dcn_auc": round(dcn_auc, 4),
            "negative_source": cfg.reranker.negative_source,
            "dcn_loss": cfg.reranker.loss,
            "examples": int(len(y)), "device": str(device),
            "gbdt_iterations": gbdt.n_iter_, "gbdt_seconds": gbdt_seconds,
            "dcn_steps": state.step, "dcn_seconds": dcn_seconds,
            "dcn_step_ms_median": 1e3 * statistics.median(steady) if steady else None}


def attach_user_backend(cfg: Config, ctx, device) -> str:
    """Attach the user vectorizer that ``serve.user_backend`` names:
    ``stage2`` the best stage-2 checkpoint (raises without one), ``auto`` that
    checkpoint when it exists, ``history`` the history mean. Returns what was
    attached."""
    from recsys_tpu_torch.serve.app import tower_user_vectorizer
    from recsys_tpu_torch.train.sasrec import prepare_stage2, restore_stage2

    backend = cfg.serve.user_backend
    if backend == "hybrid":
        raise NotImplementedError(
            "serve.user_backend='hybrid': the hybrid tower is not in the port yet "
            "(the hybrid slice, ROADMAP Queue 1, item 3)")
    if backend not in ("auto", "stage2", "history"):
        raise ValueError(f"unknown serve.user_backend {backend!r}")
    p = _paths(cfg)
    manifest = os.path.join(p["user_ckpts"], "manifest.json")
    if backend == "history" or (backend == "auto" and not os.path.exists(manifest)):
        return ctx.user_backend
    items, users, tx = _load_world(cfg)
    data = prepare_stage2(cfg, items, users, tx)
    _, user_vectors, entry = restore_stage2(cfg, data, p["user_ckpts"], device)
    if entry is None:
        raise FileNotFoundError(f"no best stage-2 checkpoint in {p['user_ckpts']}")
    ctx.user_vectorize_fn = tower_user_vectorizer(
        ctx, cfg, user_vectors, ["<pad>"] + list(data["item_map"].ids), device)
    ctx.user_backend = "stage-2 tower (best checkpoint)"
    return ctx.user_backend


def build_app(cfg: Config, args):
    """The serving context of ``serve``: store, index and vectorizers."""
    from recsys_tpu_torch.serve.app import build_app_context, model_vectorizer

    vec = None
    model_backed = getattr(args, "model_backed", False)
    if model_backed:
        from recsys_tpu_torch.data.vocab import StdVocab
        from recsys_tpu_torch.train.simcse import restore_model

        device = resolve_device(args.device)
        p = _paths(cfg)
        model, _ = restore_model(cfg, p["item_ckpts"], StdVocab().num_fields, device)
        vec = model_vectorizer(cfg, model, device)
    ctx = build_app_context(cfg, vec)
    if model_backed:
        print(f"user vectorizer: {attach_user_backend(cfg, ctx, device)}", flush=True)
    return ctx


def cmd_serve(cfg: Config, args) -> dict:
    from recsys_tpu_torch.serve.server import make_server

    server = make_server(build_app(cfg, args), port=getattr(args, "port", None))
    print(f"serving on {server.server_address}", flush=True)
    server.serve_forever()
    return {}


COMMANDS = {
    "gen-data": cmd_gen_data,
    "etl": cmd_etl,
    "train-item": cmd_train_item,
    "vectorize": cmd_vectorize,
    "train-gnn": cmd_train_gnn,
    "distill": cmd_distill,
    "gnn-eval": cmd_gnn_eval,
    "train-user": cmd_train_user,
    "eval": cmd_eval,
    "train-reranker": cmd_train_reranker,
    "serve": cmd_serve,
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
    parser.add_argument("--fine-tune", action="store_true", dest="fine_tune",
                        help="train-gnn: previous weights, fresh optimizer, cosine decay")
    parser.add_argument("--iterations", type=int, default=None,
                        help="train-reranker: boosting iterations (default 200)")
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
