"""The spread of the stage-1 A/B of the text encoders over training seeds:
each arm's kNN purity and cosines, with either package, optionally over a
given frozen table.

    python3 scripts/text_ab_seeds.py [--package torch|jax] [--device cuda]
        [--world ab|hm] [--seeds 42,1,2,3,4] [--arms hash,pretrained]
        [--table PATH] [--set key=value ...]

``--world ab`` is the 5,000-item world of ``scripts/torch_quality_hm.py
--recipe stage1`` (a); ``hm`` the H&M catalog (105,000 items) with 1,000
users: training the item tower reads only the items, and the items do not
depend on the users. The world is made once (``data.seed`` 42, the
default). Each (arm, seed) then trains in a data root of its own over it,
``train-item`` with ``simcse.epochs=3`` and ``data.seed`` = the seed (42 is
the committed runs' own), then ``vectorize`` and the kNN purity of
``torch_quality_hm.purity_stage`` (every item in ``ab``, 8,192 queries in
``hm``). The pretrained arm's table is that package's ``pretrain-text`` on
this machine, or the ``.npz`` at ``--table`` (another machine's table: the
SVD's last directions follow the LAPACK build, see
``recsys_tpu_torch/data/text_pretrain.pretrain_embeddings``).

``--package jax`` runs the JAX package's CLI (on the CPU: set
``JAX_PLATFORMS=cpu``), ``torch`` the port's on ``--device``. Prints one
JSON line a run (``"run"``), then one with each arm's mean, standard
deviation and values (``"spread"``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

WORLDS = {"ab": ["--set", "data.num_items=5000", "--set", "data.num_users=3000",
                 "--set", "data.days=240", "--set", "data.name_style_words=2"],
          "hm": ["--set", "data.num_items=105000", "--set", "data.num_users=1000",
                 "--set", "data.days=365", "--set", "data.repeat_prob=0.10",
                 "--set", "data.name_style_words=2"]}


def quality_script():
    spec = importlib.util.spec_from_file_location(
        "torch_quality_hm", os.path.join(REPO, "scripts", "torch_quality_hm.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--package", choices=("torch", "jax"), default="torch")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--world", choices=sorted(WORLDS), default="ab")
    parser.add_argument("--seeds", default="42,1,2,3,4")
    parser.add_argument("--arms", default="hash,pretrained")
    parser.add_argument("--table", default=None)
    parser.add_argument("--set", action="append", default=[], dest="sets",
                        help="more overrides after the world's (a smaller world for a test)")
    args = parser.parse_args(argv)
    if args.package == "jax":
        from recsys_tpu.pipeline import cli
        device, dev_args = "cpu", []
    else:
        from recsys_tpu_torch.pipeline import cli
        device, dev_args = args.device, ["--device", args.device]
    quality = quality_script()
    root = tempfile.mkdtemp(prefix="text_ab_seeds_")
    extra = [*[a for kv in args.sets for a in ("--set", kv)], *dev_args]
    world = f"{root}/world"
    base = ["--set", f"data.root={world}", *WORLDS[args.world]]
    cli.main(["gen-data", *base, *extra])
    arms = args.arms.split(",")
    if "pretrained" in arms:
        if args.table:
            shutil.copy(args.table, f"{world}/text_pretrain.npz")
        else:
            cli.main(["pretrain-text", *base, "--set", "item_tower.text_encoder=pretrained",
                      *extra])
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        for arm in arms:
            data = f"{root}/{arm}_{seed}"
            quality.link_world(world, data, quality.WORLD_FILES + (
                ("text_pretrain.npz",) if arm == "pretrained" else ()))
            sets = ["--set", f"data.root={data}", *WORLDS[args.world],
                    "--set", f"item_tower.text_encoder={arm}", "--set", f"data.seed={seed}",
                    *extra]
            t0 = time.perf_counter()
            steps = cli.main(["train-item", *sets, "--set", "simcse.epochs=3"])["steps"]
            cli.main(["vectorize", *sets])
            purity = quality.purity_stage(data, device, 0 if args.world == "ab" else 8192)
            rows.append({"arm": arm, "seed": seed, "steps": steps,
                         "seconds": time.perf_counter() - t0, **purity})
            print(json.dumps({"run": rows[-1]}), flush=True)
    spread = {}
    for arm in arms:
        for key in ("knn_purity", "within_cos", "cross_cos"):
            values = [r[key] for r in rows if r["arm"] == arm]
            spread.setdefault(arm, {})[key] = {
                "mean": float(np.mean(values)), "sd": float(np.std(values, ddof=1))
                if len(values) > 1 else None, "values": values}
    print(json.dumps({"spread": spread, "package": args.package, "world": args.world,
                      "table": args.table or "pretrain-text here"}), flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
