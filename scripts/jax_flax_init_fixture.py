"""Write the fixture that ``chip_smoke.py`` holds the port's init to on a
machine without JAX: the JAX package's inits of a small configuration of each
model family, at the JAX sites' keys.

    JAX_PLATFORMS=cpu python3 scripts/jax_flax_init_fixture.py \
        [--out artifacts/flax_init_fixture.npz]

For each family the npz holds ``<family>``, a JSON object: ``spec`` (the
configuration and key, which ``chip_smoke.py`` builds the port's model from),
``exact`` (path -> the sha256 of the float32 bytes of each uniform-, zero-,
one- and constant-derived leaf) and ``normal`` (path -> [offset, count, std]
of each normal- and truncated-normal-derived leaf: its values, 128 at a
stride through the flat leaf, lie at ``offset`` in ``<family>/values``, and
``std`` is the leaf's). It imports the JAX package; run it on the CPU where
JAX is installed.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from recsys_tpu.config import (Config, DataConfig, GNNConfig, ItemTowerConfig,  # noqa: E402
                               RerankerConfig, UserTowerConfig, VocabConfig)
from recsys_tpu.data.dataset import tokenize_items  # noqa: E402
from recsys_tpu.data.synthetic import generate_dataset  # noqa: E402
from recsys_tpu.data.vocab import StdVocab  # noqa: E402
from recsys_tpu.models import hybrid_tower as JH  # noqa: E402
from recsys_tpu.models import lightgcl as JL  # noqa: E402
from recsys_tpu.models import reranker as JR  # noqa: E402
from recsys_tpu.models import user_tower as JU  # noqa: E402
from recsys_tpu.train import sasrec as JS  # noqa: E402
from recsys_tpu.train import simcse as JSC  # noqa: E402

# leaves drawn from a normal or a truncated normal; every other leaf is exact
NORMAL_LEAVES = {"kernel", "embedding", "std_field_embedding", "re_field_embedding",
                 "pos_embedding", "pretrained_embedding", "item_matrix"}
VALUES = 128
TOWER = dict(d_model=64, max_len=12, nhead=2, num_layers=2, dropout=0.1)
ITEM = dict(dim=64, text_dim=64, head_hidden=[128, 64], fusion_layers=2, text_layers=1,
            pretrained_dim=48)
VOCAB = dict(max_field_tokens=8, max_name_tokens=8, text_vocab_size=1000)
RERANK = dict(deep_hidden=[48, 24], fm_embed_dim=8)

# family -> spec; the JAX site each one follows is named in its "site"
SPECS = {
    "simcse_hash": {"site": "train/simcse.py:123", "seed": 42, "item_tower": ITEM,
                    "text_encoder": "hash", "vocab": VOCAB},
    "simcse_pretrained": {"site": "train/simcse.py:123", "seed": 1, "item_tower": ITEM,
                          "text_encoder": "pretrained", "vocab": VOCAB},
    "stage2": {"site": "train/sasrec.py:328", "seed": 42, "tower": TOWER, "items_pad": 301},
    "side_gates": {"site": "train/sasrec.py:124 (enable_side_gates)", "seed": 2,
                   "tower": TOWER, "items_pad": 301},
    "hybrid": {"site": "train/hybrid.py:138", "seed": 42, "tower": TOWER, "items_pad": 301,
               "content_dim": 64, "gnn_dim": 32},
    "lightgcl": {"site": "train/gnn.py:182", "seed": 42, "users": 1001, "items": 333,
                 "emb_dim": 64},
    "magnitude": {"site": "train/gnn.py:291", "seed": 0, "in_dim": 64, "hidden": 128,
                  "out_dim": 64},
    "dcn": {"site": "train/reranker.py:169", "seed": 0, "features": 26, "reranker": RERANK},
    "deepfm": {"site": "train/reranker.py:194", "seed": 0, "field_sizes": [7, 300, 41],
               "num_dense": 0, "reranker": RERANK},
    "deepfm_dense": {"site": "train/reranker.py:204", "seed": 0, "field_sizes": [7, 300, 41],
                     "num_dense": 5, "reranker": RERANK},
}


def tuples(kwargs: dict) -> dict:
    """A spec's config fields with its lists as tuples (the configs are frozen)."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in kwargs.items()}


def _stage2_sample(B: int, L: int, n_pad: int) -> dict:
    rng = np.random.default_rng(0)
    return {"input_ids": rng.integers(1, n_pad, (B, L)).astype(np.int32),
            "time_buckets": rng.integers(0, 10, (B, L)).astype(np.int32),
            "seq_mask": np.ones((B, L), np.int32),
            "user_buckets": rng.integers(0, 16, (B, 4)).astype(np.int32),
            "user_cats": rng.integers(0, 8, (B, 5)).astype(np.int32),
            "user_cont": rng.normal(size=(B, 4)).astype(np.float32)}


def jax_init(family: str, spec: dict):
    """The JAX package's params for ``spec``, as its site draws them."""
    key = jax.random.PRNGKey(spec["seed"])
    if family.startswith("simcse"):
        cfg = Config(vocab=VocabConfig(**spec["vocab"]),
                     item_tower=ItemTowerConfig(**tuples(spec["item_tower"]),
                                                text_encoder=spec["text_encoder"]))
        items, _, _ = generate_dataset(DataConfig(num_items=32, num_users=8, days=20, seed=0))
        tensors = tokenize_items(items, StdVocab(), cfg.vocab)
        spec["num_std_fields"] = int(tensors["std"].shape[1])
        model = JSC.build_model(cfg, StdVocab().size, spec["num_std_fields"])
        return JSC.init_params(model, tensors, key)
    if "tower" in spec:
        tower = UserTowerConfig(**spec["tower"])
        L = tower.max_len
    if family == "stage2":
        params, _ = JS.init_stage2_params(Config(user_tower=tower), spec["items_pad"], None, key,
                                          _stage2_sample(4, L, spec["items_pad"]))
        return params
    if family == "side_gates":
        b = _stage2_sample(4, L, spec["items_pad"])
        k1, _ = jax.random.split(key)
        model = JU.SASRecUserTower(tower, num_id_embeddings=spec["items_pad"],
                                   enable_side_gates=True)
        return jax.jit(model.init)(
            {"params": k1, "dropout": k1}, jnp.zeros((4, L, tower.d_model)), b["input_ids"],
            b["time_buckets"], jnp.zeros((4, L, tower.num_side_fields), jnp.int32),
            b["seq_mask"], b["user_buckets"], b["user_cats"], b["user_cont"])["params"]
    if family == "hybrid":
        b = _stage2_sample(4, L, spec["items_pad"])
        dc, dg = spec["content_dim"], spec["gnn_dim"]
        model = JH.HybridUserTower(tower, num_id_embeddings=spec["items_pad"], gnn_dim=dg)
        return jax.jit(model.init)(
            {"params": key, "dropout": key}, jnp.zeros((4, L, dc)), jnp.zeros((4, L, dg)),
            b["input_ids"], b["time_buckets"], b["seq_mask"], jnp.zeros((4, dg)),
            b["user_buckets"], b["user_cats"], b["user_cont"])["params"]
    if family == "lightgcl":
        nu, ni = spec["users"], spec["items"]
        model = JL.LightGCL(nu, ni, GNNConfig(emb_dim=spec["emb_dim"], svd_rank=2))
        src = np.array([0, 1], np.int32)
        args = (src, src + nu, np.ones(2, np.float32))
        return jax.jit(model.init)(key, args, jnp.zeros((nu + ni, 2)), jnp.ones(2),
                                   jnp.zeros((nu + ni, 2)))["params"]
    if family == "magnitude":
        model = JL.MagnitudeEncoder(spec["in_dim"], spec["hidden"], spec["out_dim"])
        return model.init(key, jnp.zeros((1, spec["in_dim"])))["params"]
    rc = RerankerConfig(**tuples(spec["reranker"]))
    if family == "dcn":
        return JR.DCNRanker(rc).init(key, jnp.zeros((2, spec["features"])))["params"]
    sizes = tuple(spec["field_sizes"])
    model = JR.DeepFM(sizes, rc, num_dense=spec["num_dense"])
    args = [jnp.zeros((2, len(sizes)), jnp.int32)]
    if spec["num_dense"]:
        args.append(jnp.zeros((2, spec["num_dense"])))
    return model.init(key, *args)["params"]


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v, np.float32)


def strided(flat: np.ndarray) -> np.ndarray:
    return flat[::max(1, flat.size // VALUES)][:VALUES]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(REPO, "artifacts",
                                                      "flax_init_fixture.npz"))
    args = parser.parse_args(argv)
    out: dict[str, np.ndarray] = {}
    for family, spec in SPECS.items():
        params = jax.device_get(jax_init(family, spec))
        exact, normal, values = {}, {}, []
        for path, leaf in leaves(params):
            if path.rsplit("/", 1)[-1] in NORMAL_LEAVES and leaf.size > 1:
                picked = strided(leaf.reshape(-1))
                normal[path] = [sum(map(len, values)), len(picked), float(leaf.std())]
                values.append(picked)
            else:
                exact[path] = hashlib.sha256(np.ascontiguousarray(leaf).tobytes()).hexdigest()
        out[family] = np.array(json.dumps({"spec": spec, "exact": exact, "normal": normal}))
        out[f"{family}/values"] = np.concatenate(values or [np.zeros(0, np.float32)])
    np.savez_compressed(args.out, **out)
    print(json.dumps({"out": args.out, "families": len(SPECS), "arrays": len(out),
                      "bytes": os.path.getsize(args.out)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
