"""The hybrid recipe at the mid world through the PyTorch port, on one GPU.

    python3 scripts/torch_hybrid_recipe_mid.py [--out chiprun_out/hybrid_recipe_mid]
        [--arms control lowlr_steps] [--device cuda]

The world and stages of ``scripts/hybrid_recipe_mid.sh`` (5,000 items, 3,000
users, 240 days, ``data.name_style_words=2``): gen-data -> etl -> train-item
(3 epochs) -> vectorize -> train-gnn -> distill, then ``train-hybrid`` for 8
epochs in each arm, checkpoints wiped between arms:

  control      the default recipe (the ensemble report on);
  lowlr_steps  hybrid_lr 1e-4, 100 warmup steps, cosine decay, 32 steps an
               epoch (the report off);

and the other two arms of the shell script by name (``lowlr_cosine``,
``slow_adapters``). The world is made from the seed by the port's copy of
``data/synthetic.py``, the JAX package's world, so the Recall@100 curves
compare with the committed JAX runs in ``artifacts/hybrid_recipe/`` (random
streams differ: an observation, not a gate). Imports only the port. Each
stage's JSON goes to ``--out``; the last lines printed are the card's name and
power limit and one JSON summary with both packages' curves.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from recsys_tpu_torch.pipeline import cli  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = ["--set", "data.num_items=5000", "--set", "data.num_users=3000",
         "--set", "data.days=240", "--set", "data.name_style_words=2"]
ARMS = {
    "control": [],
    "lowlr_cosine": ["--set", "user_train.hybrid_lr=5e-5", "--set",
                     "user_train.hybrid_warmup_steps=50", "--set",
                     "user_train.hybrid_lr_decay=cosine"],
    "slow_adapters": ["--set", "user_train.hybrid_warmup_steps=50", "--set",
                      'user_train.hybrid_slow_modules=["item_adapter","encoder","id_embedding"]',
                      "--set", "user_train.hybrid_slow_scale=0.1"],
    "lowlr_steps": ["--set", "user_train.hybrid_lr=1e-4", "--set",
                    "user_train.hybrid_warmup_steps=100", "--set",
                    "user_train.hybrid_lr_decay=cosine", "--set",
                    "user_train.hybrid_steps_per_epoch_min=32",
                    "--set", "user_train.hybrid_report=false"],
}


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi failed"


def jax_curve(arm: str) -> list[float] | None:
    """The committed JAX run's Recall@100 curve of ``arm`` (read as JSON; the
    JAX package is not imported)."""
    try:
        with open(f"{REPO}/artifacts/hybrid_recipe/hybrid_{arm}.json") as f:
            return [h.get("recall@100") for h in json.load(f)["hybrid_history"]]
    except (OSError, KeyError, json.JSONDecodeError):
        return None


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=f"{REPO}/chiprun_out/hybrid_recipe_mid")
    parser.add_argument("--arms", nargs="+", default=["control", "lowlr_steps"],
                        choices=sorted(ARMS))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    os.makedirs(args.out, exist_ok=True)
    print(card_line(), flush=True)
    root = tempfile.mkdtemp(prefix="hybrid_recipe_mid_")
    sets = ["--set", f"data.root={root}", *WORLD, "--device", args.device]
    seconds = {}

    def stage(name: str, argv: list[str]) -> dict:
        t0 = time.perf_counter()
        out = cli.main(argv)
        seconds[name] = time.perf_counter() - t0
        with open(f"{args.out}/{name}.json", "w") as f:
            json.dump(out, f, default=str)
        return out

    try:
        stage("gen", ["gen-data", *sets])
        stage("etl", ["etl", *sets])
        stage("item", ["train-item", *sets, "--set", "simcse.epochs=3"])
        stage("vectorize", ["vectorize", *sets])
        stage("gnn", ["train-gnn", *sets])
        stage("distill", ["distill", *sets])
        summary = {}
        for arm in args.arms:
            shutil.rmtree(f"{root}/ckpt_hybrid", ignore_errors=True)
            out = stage(f"hybrid_{arm}", ["train-hybrid", *sets, "--set", "user_train.epochs=8",
                                          "--set", "user_train.ckpt_every=1", *ARMS[arm]])
            torch_curve = [h.get("recall@100") for h in out["hybrid_history"]]
            ref = jax_curve(arm)
            summary[arm] = {"torch_recall@100": torch_curve, "jax_recall@100": ref,
                            "torch_best": max(torch_curve) if torch_curve else None,
                            "jax_best": max(ref) if ref else None,
                            "steps": out["steps"], "step_ms_median": out["step_ms_median"],
                            "seconds": seconds[f"hybrid_{arm}"]}
            if ref and torch_curve:
                summary[arm]["best_gap"] = summary[arm]["torch_best"] - summary[arm]["jax_best"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(card_line(), flush=True)
    print(json.dumps({"arms": summary, "stage_seconds": seconds}), flush=True)


if __name__ == "__main__":
    main()
