"""The JAX package's numbers for ``chip_smoke.py`` phase 20: the H&M world's
shape (105,000 items, 365 days, ``data.repeat_prob=0.10``,
``data.name_style_words=2``) cut to 60,000 users, on the CPU.

    JAX_PLATFORMS=cpu python scripts/jax_hm_cut_reference.py [--root DIR]

Runs the JAX package's ``gen-data`` and ``etl`` stages, then
``prepare_stage2`` and the training-free baselines (popularity, repurchase)
over the users with validation targets, as its ``eval`` stage does, and
prints one JSON line: the two stages' JSON, n_eval and the baselines' recalls.
The card has no JAX, so phase 20 holds the port to these numbers as
constants.
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from recsys_tpu.config import load_config  # noqa: E402
from recsys_tpu.eval.baselines import baseline_report  # noqa: E402
from recsys_tpu.eval.recall import target_rows  # noqa: E402
from recsys_tpu.pipeline import cli  # noqa: E402
from recsys_tpu.train.sasrec import prepare_stage2  # noqa: E402

CUT = {"num_items": 105000, "num_users": 60000, "days": 365, "repeat_prob": 0.10,
       "name_style_words": 2}


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=None)
    root = parser.parse_args().root or tempfile.mkdtemp(prefix="jax_hm_cut_")
    sets = ["--set", f"data.root={root}",
            *[a for key, value in CUT.items() for a in ("--set", f"data.{key}={value}")]]
    gen = cli.main(["gen-data", *sets])
    etl = cli.main(["etl", *sets])
    cfg = load_config(None, {"data": {"root": root, **CUT}})
    items, users, tx = cli._load_world(cfg)
    data = prepare_stage2(cfg, items, users, tx)
    tens = data["tensors"]
    rows = target_rows(tens["user_ids"], data["targets_idx"])
    sub = {"user_ids": [tens["user_ids"][r] for r in rows],
           "input_ids": tens["input_ids"][rows], "target_ids": tens["target_ids"][rows]}
    base = baseline_report(sub, data["logq"], data["targets_idx"], ks=cfg.user_train.eval_ks)
    print(json.dumps({"gen": {k: gen[k] for k in ("items", "users", "transactions", "oracle")},
                      "etl": {k: etl[k] for k in ("split_day", "sanity", "missing")},
                      "stage2_users": int(tens["input_ids"].shape[0]), "n_eval": int(len(rows)),
                      "baselines": base}))


if __name__ == "__main__":
    main()
