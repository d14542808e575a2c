"""Where one machine's pretrain-text table parts from another's.

    python3 scripts/text_table_probe.py [--world ab|hm] [--table T.npz] [--root DIR]

Builds the world of ``scripts/text_ab_seeds.py --world`` (gen-data through
the port's CLI on the CPU; ``--root``: a data root that holds it already,
and then the table is its ``pretrain-text`` artifact when it has one) and runs the steps of
``recsys_tpu_torch/data/text_pretrain.pretrain_embeddings`` one by one,
printing one ``probe`` JSON line a step with a checksum of its output (dtype,
shape, the first 16 hex digits of its sha256, float64 sums): the PPMI input,
the random test matrix, each subspace iteration, the QR, the small SVD (its
top and last singular values too), the table. Run on two machines, the first
step whose sha differs is where their libraries part. With ``--table`` (an
``.npz`` from another machine, e.g. the JAX package's), one ``table_rows``
line: how far the two tables' live rows lie apart (largest element gap, row
cosines).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from recsys_tpu_torch.data import text_pretrain as T  # noqa: E402
from recsys_tpu_torch.pipeline import cli  # noqa: E402

WORLDS = {"ab": ["data.num_items=5000", "data.num_users=3000", "data.days=240"],
          "hm": ["data.num_items=105000", "data.num_users=1000", "data.days=365",
                 "data.repeat_prob=0.10"]}


def checksum(a) -> dict:
    a = np.ascontiguousarray(a)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "sha": hashlib.sha256(a.tobytes()).hexdigest()[:16],
            "sum": float(np.asarray(a, np.float64).sum()),
            "abs": float(np.abs(np.asarray(a, np.float64)).sum())}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--world", choices=sorted(WORLDS), default="ab")
    parser.add_argument("--table", default=None)
    parser.add_argument("--root", default=None,
                        help="a data root where gen-data already made this world")
    args = parser.parse_args(argv)
    import scipy

    print(json.dumps({"numpy": np.__version__, "scipy": scipy.__version__}), flush=True)
    root = args.root or tempfile.mkdtemp(prefix="text_table_probe_")
    sets = [a for kv in [*WORLDS[args.world], "data.name_style_words=2", f"data.root={root}"]
            for a in ("--set", kv)]
    if not args.root:
        cli.main(["gen-data", *sets, "--device", "cpu"])
    cfg = cli.config_from_args(cli.parse_args(["pretrain-text", *sets]))
    tensors = cli._item_tensors(cfg)
    V, dim, iters = cfg.vocab.text_vocab_size, cfg.item_tower.pretrained_dim, 4
    steps = {}
    m = T.ppmi_matrix(tensors, V)
    steps["ppmi"] = T.ppmi_checksum(m)
    # ops/graph._randomized_svd, step by step
    k = min(dim + 4, V)
    omega = np.random.default_rng(cfg.data.seed).normal(size=(V, k)).astype(np.float64)
    steps["omega"] = checksum(omega)
    y = m @ omega
    steps["y0"] = checksum(y)
    for i in range(iters):
        y = m @ (m.T @ y)
        steps[f"y{i + 1}"] = checksum(y)
    q, _ = np.linalg.qr(y)
    steps["qr"] = checksum(q)
    b = (m.T @ q).T
    steps["b"] = checksum(b)
    ub, s, _ = np.linalg.svd(b, full_matrices=False)
    steps["svd_s"] = {**checksum(s), "top": s[:4].tolist(), "last": s[dim - 4:k].tolist()}
    made = f"{root}/text_pretrain.npz"
    emb = (T.load_text_pretrain(made) if args.root and os.path.exists(made)
           else T.pretrain_embeddings(tensors, V, dim=dim, seed=cfg.data.seed))
    steps["table"] = T.table_checksum(emb)
    for name, value in steps.items():
        print(json.dumps({"probe": name, **value}), flush=True)
    if args.table:
        other = T.load_text_pretrain(args.table)
        live = np.abs(other).sum(axis=1) > 0
        a, o = emb[live].astype(np.float64), other[live].astype(np.float64)
        cos = (a * o).sum(axis=1)
        print(json.dumps({"table_rows": {
            "live": int(live.sum()), "max_abs_gap": float(np.abs(a - o).max()),
            "row_cos_min": float(cos.min()), "row_cos_median": float(np.median(cos)),
            "rows_cos_below_0.9": int((cos < 0.9).sum()),
            "this": T.table_checksum(emb)["sha256"][:12],
            "other": T.table_checksum(other)["sha256"][:12]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
