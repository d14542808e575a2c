"""Run the port's CLI chain at a toy world on the CPU with the package of a
given tree, or hold two such runs against each other.

    python3 scripts/torch_cli_chain_diff.py run --tree DIR --root WORLD --out A.json
    python3 scripts/torch_cli_chain_diff.py compare A.json B.json

``run``: gen-data -> etl -> train-item -> vectorize -> train-gnn -> distill ->
gnn-eval -> train-reranker -> train-user -> eval -> train-hybrid ->
ensemble-eval -> rerank-eval (stage2, then hybrid), each as ``python -m
recsys_tpu_torch.pipeline.cli`` with ``DIR`` first on the path and
``--device cpu``, at the sizes of the verify notes (120 items, 60 users, 40
days), on two threads. ``WORLD`` is made anew, and emptied first where an
earlier run made it (a directory that this script did not make is refused);
give two runs the same ``WORLD`` so that the paths in their outputs agree
(run them one after the other). Writes each stage's JSON line and the JSON
files the stages leave in ``WORLD``, with each stage's wall seconds.

``compare``: every leaf that differs between two runs, apart from timings
(keys that name seconds, milliseconds, rates or latencies); exit 1 if any.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

SETS = ["--set", "data.num_items=120", "--set", "data.num_users=60", "--set", "data.days=40",
        "--set", "vocab.max_field_tokens=8", "--set", "vocab.max_name_tokens=8",
        "--set", "item_tower.head_hidden=[128]", "--set", "item_tower.fusion_layers=1",
        "--set", "item_tower.text_layers=1"]
GNN = ["--set", "gnn.epochs=2", "--set", "gnn.batch_size=256",
       "--set", "gnn.steps_per_epoch_min=20", "--set", "distill.epochs=3",
       "--set", "distill.steps_per_epoch=10"]
USER = ["--set", "user_tower.max_len=10", "--set", "user_tower.num_layers=1",
        "--set", "user_train.batch_size=16", "--set", "user_train.epochs=1",
        "--set", "user_train.eval_ks=[5,20]"]
ITEM = ["--set", "simcse.batch_size=16", "--set", "simcse.epochs=1"]
CHAIN = (("gen-data", []), ("etl", []), ("train-item", ITEM), ("vectorize", []),
         ("train-gnn", GNN), ("distill", GNN), ("gnn-eval", ["--set", "user_train.eval_ks=[5,20]"]),
         ("train-reranker", ["--iterations", "50"]), ("train-user", USER), ("eval", USER),
         ("train-hybrid", USER), ("ensemble-eval", USER),
         ("rerank-eval", [*USER, "--vectors", "stage2", "--iterations", "50"]),
         ("rerank-eval", [*USER, "--vectors", "hybrid", "--iterations", "50"]))
FILES = ("targets_val.json", "eval.json", "gnn_eval.json", "ensemble_report.json",
         "rerank_eval_stage2.json", "rerank_eval_hybrid.json")
TIMING = ("seconds", "_ms", "ms_", "per_s", "latency")
MARKER = ".cli_chain_world"          # what marks a WORLD this script made


def fresh_world(root: str) -> None:
    """An empty ``root`` with the marker; refuses a directory without it."""
    if os.path.lexists(root):
        if not os.path.isfile(os.path.join(root, MARKER)):
            raise SystemExit(f"{root} exists and no earlier run made it: give a new --root")
        shutil.rmtree(root)
    os.makedirs(root)
    open(os.path.join(root, MARKER), "w").close()


def run(tree: str, root: str, out: str) -> int:
    fresh_world(root)
    env = {**os.environ, "PYTHONPATH": os.path.abspath(tree), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "2"}    # one thread count for both runs: the same sums
    stages = []
    for name, extra in CHAIN:
        argv = [sys.executable, "-m", "recsys_tpu_torch.pipeline.cli", name,
                "--set", f"data.root={root}", *SETS, *extra, "--device", "cpu"]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, env=env, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"{name} exited {proc.returncode}")
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1]
        stages.append({"stage": name, "wall_seconds": wall, "json": json.loads(line)})
        print(name, f"{wall:.1f} s", flush=True)
    files = {}
    for name in FILES:
        with open(os.path.join(root, name)) as f:
            files[name] = json.load(f)
    with open(out, "w") as f:
        json.dump({"tree": tree, "stages": stages, "files": files}, f, indent=1)
    return 0


def diffs(a, b, path: str = "") -> list[str]:
    if isinstance(a, dict) and isinstance(b, dict):
        out = [f"{path}.{k}: only in one" for k in a.keys() ^ b.keys()
               if not any(t in k for t in TIMING)]
        for k in a.keys() & b.keys():
            if not any(t in k for t in TIMING):
                out += diffs(a[k], b[k], f"{path}.{k}")
        return out
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in diffs(x, y, f"{path}[{i}]")]
    return [] if a == b else [f"{path}: {a!r} != {b!r}"]


def compare(a_path: str, b_path: str) -> int:
    with open(a_path) as f:
        a = json.load(f)
    with open(b_path) as f:
        b = json.load(f)
    found = diffs({"stages": a["stages"], "files": a["files"]},
                  {"stages": b["stages"], "files": b["files"]})
    for line in found:
        print(line)
    walls = {s["stage"] + str(i): (s["wall_seconds"], t["wall_seconds"])
             for i, (s, t) in enumerate(zip(a["stages"], b["stages"]))}
    print(json.dumps({"differing_leaves": len(found), "wall_seconds": walls}))
    return 1 if found else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--tree", required=True)
    r.add_argument("--root", required=True)
    r.add_argument("--out", required=True)
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = parser.parse_args(argv)
    if args.cmd == "run":
        return run(args.tree, args.root, args.out)
    return compare(args.a, args.b)


if __name__ == "__main__":
    raise SystemExit(main())
