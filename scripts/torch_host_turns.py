"""The port's host data paths at the H&M world, timed in turns for each tree
named: ``prepare_stage2``, train-gnn's graph from the transactions, and
Recall@{20,100,500} over the eval users.

    python3 scripts/torch_host_turns.py --root DIR [--set key=value ...] TREE [TREE ...]

Builds the world of ``scripts/torch_quality_hm.py`` (105,000 items,
1,370,000 users, 365 days) in ``--root`` (a directory of the caller's, kept
for later runs) with this tree's gen-data and etl unless it is there, then
runs one process for each TREE in the order given
(e.g. ``PARENT . . PARENT``), each with that tree's package first on the
path. A turn prints one JSON line: the seconds of loading the world, of
``prepare_stage2``, of the graph (train-gnn's work before training: the
sorted user and item maps, every transaction's ids, ``build_graph`` with
its SVD, each transaction's ids again where the tree maps them twice: a
tree from before ``transaction_indices`` runs train-gnn's two mappings), and
of ``recall_at_ks`` on a seeded random top-500 over the users with targets,
a first call and the mean of two more on the same targets; with checksums of
what each made. Last, one line with each tree's seconds side by side and
whether the checksums agree across trees. The card is not used.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = ["--set", "data.num_items=105000", "--set", "data.num_users=1370000",
         "--set", "data.days=365", "--set", "data.repeat_prob=0.10",
         "--set", "data.name_style_words=2"]


def _sha(*arrays) -> str:
    import numpy as np

    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def turn(tree: str, sets: list[str]) -> dict:
    """One tree's timings, in this process (its package first on the path)."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np

    from recsys_tpu_torch.data.etl import time_split
    from recsys_tpu_torch.eval.recall import recall_at_ks, target_rows
    from recsys_tpu_torch.ops.graph import build_graph
    from recsys_tpu_torch.pipeline import cli
    from recsys_tpu_torch.train import gnn
    from recsys_tpu_torch.train.sasrec import prepare_stage2

    cfg = cli.config_from_args(cli.parse_args(["eval", *sets, "--device", "cpu"]))
    out, sums = {"tree": tree}, {}
    t0 = time.perf_counter()
    items, users, tx = cli._load_world(cfg)
    out["load_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    data = prepare_stage2(cfg, items, users, tx)
    out["prepare_s"] = time.perf_counter() - t0
    tens = data["tensors"]
    sums["prepare"] = _sha(*(tens[k] for k in ("input_ids", "target_ids", "time_buckets",
                                               "seq_mask", "user_cont")))
    sums["targets"] = hashlib.sha256(json.dumps(
        [tens["user_ids"], sorted((u, sorted(s)) for u, s in data["targets_idx"].items())]
    ).encode()).hexdigest()[:16]

    t0 = time.perf_counter()
    train_tx, _, _ = time_split(tx, cfg.data.valid_days)
    user_ids = sorted(train_tx["user_id"].unique())
    item_ids = sorted(items["item_id"].astype(str))
    user_map = {u: r for r, u in enumerate(user_ids)}
    item_map = {i: r for r, i in enumerate(item_ids)}
    if hasattr(gnn, "transaction_indices"):
        eu, ei = gnn.transaction_indices(train_tx, user_map, item_map)
        graph = build_graph(eu, ei, len(user_map), len(item_map), svd_rank=cfg.gnn.svd_rank,
                            svd_iters=cfg.gnn.svd_iters, seed=cfg.data.seed)
    else:
        graph = gnn.graph_from_transactions(train_tx, user_map, item_map, cfg.gnn,
                                            cfg.data.seed)
        eu = np.array([user_map[u] for u in train_tx["user_id"]])
        ei = np.array([item_map[i] for i in train_tx["item_id"]])
    out["graph_s"] = time.perf_counter() - t0
    sums["graph"] = _sha(graph.src, graph.dst, graph.weight, graph.svd_u, graph.svd_s,
                         graph.svd_v, eu, ei)
    del graph, eu, ei, train_tx

    rows = target_rows(tens["user_ids"], data["targets_idx"])
    uids = [tens["user_ids"][r] for r in rows]
    topk = np.random.default_rng(0).integers(1, len(data["item_map"]) + 1, (len(uids), 500))
    t0 = time.perf_counter()
    first = recall_at_ks(topk, uids, data["targets_idx"])
    out["recall_first_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = [recall_at_ks(topk, uids, data["targets_idx"]) for _ in range(2)]
    out["recall_again_s"] = (time.perf_counter() - t0) / 2
    sums["recall"] = json.dumps([first, *again], sort_keys=True)
    out["recall_users"] = len(uids)
    return {**out, "sums": sums}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="*")
    parser.add_argument("--root", required=True)
    parser.add_argument("--set", action="append", default=[], dest="sets")
    parser.add_argument("--turn", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    sets = ["--set", f"data.root={args.root}", *WORLD,
            *[a for kv in args.sets for a in ("--set", kv)]]
    if args.turn:
        print(json.dumps(turn(args.turn, sets)), flush=True)
        return 0
    if not os.path.exists(os.path.join(args.root, "targets_val.json")):
        for stage in ("gen-data", "etl"):
            t0 = time.perf_counter()
            subprocess.run([sys.executable, "-m", "recsys_tpu_torch.pipeline.cli", stage, *sets,
                            "--device", "cpu"], check=True, cwd=REPO, stdout=subprocess.DEVNULL)
            print(json.dumps({"stage": stage, "seconds": time.perf_counter() - t0}), flush=True)
    turns = []
    for tree in args.trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", tree,
                               "--root", args.root, *[a for kv in args.sets
                                                      for a in ("--set", kv)]],
                              check=True, capture_output=True, text=True)
        turns.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    keys = ("load_s", "prepare_s", "graph_s", "recall_first_s", "recall_again_s")
    by_tree = {t: {k: [r[k] for r in turns if r["tree"] == t] for k in keys}
               for t in dict.fromkeys(args.trees)}
    same = {name: len({r["sums"][name] for r in turns}) == 1 for name in turns[0]["sums"]}
    print(json.dumps({"seconds": by_tree, "outputs_equal": same}), flush=True)
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
