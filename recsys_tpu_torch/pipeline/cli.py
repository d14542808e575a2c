"""Pipeline CLI of the port: the stages of the item-vector slice.

Counterpart of ``recsys_tpu/pipeline/cli.py``, with the same ``--set``
overrides, artifact paths and one JSON line per stage:

  gen-data     synthetic persona world -> parquet (the JAX package's stage)
  etl          splits + features + validation targets (the JAX package's stage)
  train-item   stage-1 SimCSE in PyTorch             -> checkpoints
  vectorize    materialize the (N+1, 128) item matrix artifact
  serve        HTTP server; ``--model-backed`` vectorizes with the trained
               encoder

``--device`` (default ``cuda``) places the model; ``--device cuda`` on a
machine without a CUDA device raises and never falls back to the CPU.

    python -m recsys_tpu_torch.pipeline.cli train-item --set data.root=/tmp/w
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from recsys_tpu.config import Config, load_config
from recsys_tpu.pipeline import cli as jax_cli


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return device


def _item_tensors(cfg: Config) -> dict:
    from recsys_tpu.data.dataset import tokenize_items
    from recsys_tpu.data.vocab import StdVocab

    items, _, _ = jax_cli._load_world(cfg)
    return tokenize_items(items, StdVocab(), cfg.vocab)


def cmd_gen_data(cfg: Config, args) -> dict:
    return jax_cli.cmd_gen_data(cfg, args)


def cmd_etl(cfg: Config, args) -> dict:
    return jax_cli.cmd_etl(cfg, args)


def cmd_train_item(cfg: Config, args) -> dict:
    from recsys_tpu_torch.train.simcse import train_simcse

    device = resolve_device(args.device)
    p = jax_cli._paths(cfg)
    tensors = _item_tensors(cfg)
    t0 = time.perf_counter()
    state = train_simcse(cfg, tensors, p["item_ckpts"], device,
                         init_ckpt=getattr(args, "init_ckpt", None))
    seconds = time.perf_counter() - t0
    steady = state.step_seconds[1:] or state.step_seconds
    return {"steps": state.step, "ckpt_dir": p["item_ckpts"], "device": str(device),
            "seconds": seconds, "losses": state.losses,
            "step_ms_median": 1e3 * statistics.median(steady) if steady else None,
            "first_step_ms": 1e3 * state.step_seconds[0] if state.step_seconds else None}


def cmd_vectorize(cfg: Config, args) -> dict:
    from recsys_tpu_torch.train.simcse import materialize_item_vectors, restore_model

    device = resolve_device(args.device)
    p = jax_cli._paths(cfg)
    tensors = _item_tensors(cfg)
    model, entry = restore_model(cfg, p["item_ckpts"], tensors["std"].shape[1], device)
    t0 = time.perf_counter()
    mat = materialize_item_vectors(cfg, model, tensors, p["item_matrix"], device=device)
    seconds = time.perf_counter() - t0
    return {"matrix": p["item_matrix"], "shape": list(mat.shape),
            "checkpoint": entry["name"] if entry else None, "device": str(device),
            "seconds": seconds, "items_per_s": (mat.shape[0] - 1) / seconds}


def build_app(cfg: Config, args):
    """The serving context of ``serve``: store, index and vectorizer."""
    from recsys_tpu_torch.serve.app import build_app_context, model_vectorizer

    vec = None
    if getattr(args, "model_backed", False):
        from recsys_tpu.data.vocab import StdVocab
        from recsys_tpu_torch.train.simcse import restore_model

        device = resolve_device(args.device)
        p = jax_cli._paths(cfg)
        model, _ = restore_model(cfg, p["item_ckpts"], StdVocab().num_fields, device)
        vec = model_vectorizer(cfg, model, device)
    return build_app_context(cfg, vec)


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
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--model-backed", action="store_true", dest="model_backed")
    parser.add_argument("--init-ckpt", default=None, dest="init_ckpt")
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
