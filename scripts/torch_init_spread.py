"""The pretrained arm at the H&M catalog from the port's init and from the JAX
package's init of the same seed, saved on a machine with JAX.

    python3 scripts/torch_init_spread.py --jax-init DIR [--device cuda]
        [--seeds 42,1,2,3,4,5] [--set key=value ...]

The port's trainers draw the JAX package's init themselves
(``models/flax_init.py``), so the two arms start from the same parameters:
each ``jax`` line carries ``init_gap``, the largest gap between the port's
draw and the saved JAX init over every tensor, in units of the tensor's std
(0.0 where the draws are bit-equal), and the two arms of a seed should give
the same numbers on one machine. ``DIR`` holds the JAX package's inits as
the port's ``state_dict``s, made by ``JAX_PLATFORMS=cpu python3
scripts/torch_simcse_lockstep.py --root R --save-jax-init DIR`` (this script
imports no JAX). The world is ``scripts/text_ab_seeds.py --world hm``'s
(105,000 items, 1,000 users), made once here by ``gen-data`` and
``pretrain-text``. Each run is ``train_simcse`` with the pretrained encoder,
``simcse.epochs=3`` and ``data.seed`` = the seed (its dropout, corruption
and batch order are the port's own torch draws), then the best checkpoint's
item vectors and ``torch_quality_hm.knn_purity`` over 8,192 queries. One
JSON line a run.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time

import numpy as np
import pandas as pd
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from recsys_tpu_torch.data.text_pretrain import load_text_pretrain  # noqa: E402
from recsys_tpu_torch.data.vocab import StdVocab  # noqa: E402
from recsys_tpu_torch.pipeline import cli  # noqa: E402
from recsys_tpu_torch.train import simcse as TS  # noqa: E402
from recsys_tpu_torch.train.checkpoint import CheckpointStore  # noqa: E402

WORLD = ["data.num_items=105000", "data.num_users=1000", "data.days=365",
         "data.repeat_prob=0.10", "data.name_style_words=2"]
TABLE = "encoder.text_encoder.pretrained_embedding"


def quality_script():
    spec = importlib.util.spec_from_file_location(
        "torch_quality_hm", os.path.join(REPO, "scripts", "torch_quality_hm.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def init_state(init: str, seed: int, jax_dir: str, table) -> dict | None:
    """The state_dict a run starts from: None for the port's own draw."""
    if init == "own":
        return None
    jax_sd = np.load(f"{jax_dir}/seed{seed}.npz")
    sd = {n: torch.as_tensor(jax_sd[n]) for n in jax_sd.files}
    sd[TABLE] = torch.as_tensor(table)
    return sd


def init_gap(seed: int, jax_dir: str, cfg, nf: int) -> float:
    """The port's init for ``seed`` against the saved JAX init: the largest
    absolute gap over every saved tensor, over that tensor's std."""
    own = TS.build_model(cfg, StdVocab().size, nf, "cpu", seed=seed).state_dict()
    jax_sd = np.load(f"{jax_dir}/seed{seed}.npz")
    gaps = [float(np.abs(own[n].numpy().astype(np.float64) - jax_sd[n]).max())
            / max(float(jax_sd[n].std()), 1e-30) for n in jax_sd.files]
    return max(gaps)


def run(seed: int, init: str, args, root: str, labels_of, quality, table) -> dict:
    sets = ["--set", f"data.root={root}", *[a for kv in WORLD for a in ("--set", kv)],
            "--set", "item_tower.text_encoder=pretrained", "--set", "simcse.epochs=3",
            "--set", f"data.seed={seed}", *[a for kv in args.sets for a in ("--set", kv)]]
    cfg = cli.config_from_args(cli.parse_args(["train-item", *sets]))
    tensors = cli._item_tensors(cfg)
    nf = tensors["std"].shape[1]
    work = tempfile.mkdtemp(prefix=f"{init}_{seed}_", dir=root)
    sd = init_state(init, seed, args.jax_init, table)
    if sd is not None:
        CheckpointStore(work, maximize=False).save("init", {"model": sd}, step=0)
    t0 = time.perf_counter()
    state = TS.train_simcse(cfg, tensors, work, args.device,
                            init_ckpt="init" if sd is not None else None, text_pretrain=table)
    model, entry = TS.restore_model(cfg, work, nf, args.device)
    vecs = TS.encode_items(model, TS.item_tensors_to(tensors, args.device), 4096).cpu().numpy()
    out = quality.knn_purity(vecs, labels_of(tensors["item_ids"]), 10, sample=8192,
                             device=args.device)
    row = {"seed": seed, "init": init, "steps": state.step, "best_step": entry["step"],
           "seconds": time.perf_counter() - t0,
           **{k: out[k] for k in ("knn_purity", "within_cos", "cross_cos")}}
    if init == "jax":
        row["init_gap"] = init_gap(seed, args.jax_init, cfg, nf)
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--jax-init", required=True, metavar="DIR")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seeds", default="42,1,2,3,4,5")
    parser.add_argument("--set", action="append", default=[], dest="sets",
                        help="more overrides after the world's (a smaller world for a test)")
    args = parser.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    quality = quality_script()
    root = tempfile.mkdtemp(prefix="init_spread_")
    sets = ["--set", f"data.root={root}", *[a for kv in [*WORLD, *args.sets]
                                             for a in ("--set", kv)],
            "--device", args.device]
    cli.main(["gen-data", *sets])
    cli.main(["pretrain-text", *sets, "--set", "item_tower.text_encoder=pretrained"])
    table = load_text_pretrain(f"{root}/text_pretrain.npz")
    items = pd.read_parquet(f"{root}/items.parquet")
    lab = items.set_index(items["item_id"].astype(str))["latent_cluster"]

    def labels_of(ids):
        return lab.reindex([str(i) for i in ids]).to_numpy()

    for seed, init in [(s, i) for s in seeds for i in ("own", "jax")]:
        print(json.dumps({"run": run(seed, init, args, root, labels_of, quality, table)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
