"""The JAX package's numbers for ``chip_smoke.py`` phases 20 and 22 and for
``scripts/torch_quality_hm.py --recipe stage1``, on the CPU.

    JAX_PLATFORMS=cpu python scripts/jax_hm_cut_reference.py [--root DIR] [--world cut|ab]

``--world cut`` (the default): the H&M world's shape (105,000 items, 365
days, ``data.repeat_prob=0.10``, ``data.name_style_words=2``) cut to 60,000
users. Runs the JAX package's ``gen-data`` and ``etl`` stages, then
``prepare_stage2`` and the training-free baselines (popularity, repurchase)
over the users with validation targets, as its ``eval`` stage does, then its
``pretrain-text`` stage, and prints one JSON line: the two stages' JSON,
n_eval, the baselines' recalls and the frozen text table's checksums. The
items do not depend on the number of users, so the table is also that of
the uncut world.

``--world ab``: the 5,000-item world of ``scripts/quality_text_pretrain_ab.sh``
with ``data.name_style_words=2``: ``gen-data`` and ``pretrain-text``, and the
table's checksums.

The checksums (``pretrain_text``): the table's shape and nonzero rows, the
sha256 of its float32 bytes and the float64 sum of its absolute values, and
``ppmi``, the SVD's input (its nonzeros and the sha256 of its CSR arrays:
int64 indices, float32 values). The card has no JAX, so the port is held to
these numbers as constants: the input bit for bit; the table's bits follow
the LAPACK build the SVD runs on.
"""

import argparse
import hashlib
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from recsys_tpu.config import load_config  # noqa: E402
from recsys_tpu.data.dataset import tokenize_items  # noqa: E402
from recsys_tpu.data.text_pretrain import item_token_bags, load_text_pretrain, ppmi  # noqa: E402
from recsys_tpu.data.vocab import StdVocab  # noqa: E402
from recsys_tpu.eval.baselines import baseline_report  # noqa: E402
from recsys_tpu.eval.recall import target_rows  # noqa: E402
from recsys_tpu.pipeline import cli  # noqa: E402
from recsys_tpu.train.sasrec import prepare_stage2  # noqa: E402

WORLDS = {"cut": {"num_items": 105000, "num_users": 60000, "days": 365, "repeat_prob": 0.10,
                  "name_style_words": 2},
          "ab": {"num_items": 5000, "num_users": 3000, "days": 240, "name_style_words": 2}}


def pretrain_checksums(cfg, artifact: str) -> dict:
    """The numbers the port's ``data/text_pretrain.table_checksum`` and
    ``ppmi_checksum`` print, of the JAX package's table and of the SVD's
    input as its ``pretrain_embeddings`` builds it."""
    from scipy import sparse

    emb = np.ascontiguousarray(load_text_pretrain(artifact), np.float32)
    items, _, _ = cli._load_world(cfg)
    inc = item_token_bags(tokenize_items(items, StdVocab(), cfg.vocab))
    V = cfg.vocab.text_vocab_size
    if inc.shape[1] < V:
        inc = sparse.csr_matrix((inc.data, inc.indices, inc.indptr), shape=(inc.shape[0], V))
    cooc = (inc.T @ inc).tocsr()
    cooc.setdiag(0)
    cooc.eliminate_zeros()
    m = ppmi(cooc)
    h = hashlib.sha256()
    for a in (m.indptr.astype(np.int64), m.indices.astype(np.int64), m.data.astype(np.float32)):
        h.update(np.ascontiguousarray(a).tobytes())
    return {"shape": list(emb.shape),
            "nonzero_rows": int((np.abs(emb).sum(axis=1) > 0).sum()),
            "sha256": hashlib.sha256(emb.tobytes()).hexdigest(),
            "abs_sum": float(np.abs(emb.astype(np.float64)).sum()),
            "ppmi": {"nnz": int(m.nnz), "sha256": h.hexdigest()}}


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=None)
    parser.add_argument("--world", choices=sorted(WORLDS), default="cut")
    args = parser.parse_args()
    root = args.root or tempfile.mkdtemp(prefix=f"jax_hm_{args.world}_")
    world = WORLDS[args.world]
    sets = ["--set", f"data.root={root}",
            *[a for key, value in world.items() for a in ("--set", f"data.{key}={value}")]]
    cfg = load_config(None, {"data": {"root": root, **world}})
    gen = cli.main(["gen-data", *sets])
    out = {"gen": {k: gen[k] for k in ("items", "users", "transactions", "oracle")}}
    if args.world == "cut":
        etl = cli.main(["etl", *sets])
        items, users, tx = cli._load_world(cfg)
        data = prepare_stage2(cfg, items, users, tx)
        tens = data["tensors"]
        rows = target_rows(tens["user_ids"], data["targets_idx"])
        sub = {"user_ids": [tens["user_ids"][r] for r in rows],
               "input_ids": tens["input_ids"][rows], "target_ids": tens["target_ids"][rows]}
        out.update({"etl": {k: etl[k] for k in ("split_day", "sanity", "missing")},
                    "stage2_users": int(tens["input_ids"].shape[0]), "n_eval": int(len(rows)),
                    "baselines": baseline_report(sub, data["logq"], data["targets_idx"],
                                                 ks=cfg.user_train.eval_ks)})
    pre = cli.main(["pretrain-text", *sets])
    out["pretrain_text"] = pretrain_checksums(cfg, pre["artifact"])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
