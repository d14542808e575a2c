"""Flax parameter trees <-> torch ``state_dict``s.

The port's modules carry the Flax submodule names, so the mapping goes by
path, with these leaf conversions:

  Dense            kernel (in, out)          -> Linear weight (out, in), bias
  MHA q/k/v        kernel (in, H, hd)        -> weight (H*hd, in), bias (H,hd) -> (H*hd,)
  MHA out          kernel (H, hd, out)       -> weight (out, H*hd), bias
  Embed            embedding                 -> weight
  LayerNorm        scale, bias               -> weight, bias
  raw params       (e.g. std_field_embedding, pos_embedding, LightGCL's
                   user_emb / item_emb tables, logit_scale, DeepFM's scalar
                   bias) as they are

The pretrained text encoder maps the same way: ``text_encoder/
pretrained_embedding`` is a raw parameter, ``text_encoder/pretrained_proj``
a Dense, beside ``pos_embedding`` and ``encoder``.

The reranker models map the same way: ``DCNRanker``'s ``nn.compact``
auto-names (``CrossNet_0/cross_{i}``, ``MLP_0/Dense_{i}``, ``score``) and
``DeepFM``'s ``fm_embed_{f}`` / ``fm_first_{f}`` (an Embed of width 1) /
``dense_embed`` are the port's submodule names. The stage-2 towers map the
same way in both directions: ``models/user_tower.Stage2Model`` is the JAX
package's ``{"user": SASRecUserTower params, "item": {"item_matrix"}}`` tree,
with ``seq_gate``, ``static_gate``, ``pos_embedding`` and ``item_matrix`` as
raw parameters. ``side_embedding_{i}`` (Embeds) exist only in a tower with
``enable_side_gates``, in both packages, and map as Embeds do. The
hybrid tower (``models/hybrid_tower.HybridUserTower``) maps the same way too:
its shape-() scalars (``logit_scale``, ``fusion/gate_gnn``, ``fusion/gate_meta``,
``ResidualAdapter``'s ``gate``) and ``pos_embedding`` as raw parameters,
``item_adapter/LayerNorm_0`` and the named sub-Denses (``content_proj``,
``gnn_proj``, ``gnn_user_proj``, ``meta_proj``, ``out_proj``) by path. The sharded path
(``parallel/``, the data-parallel stage-1 step) adds no parameters and needs
no converter: every shard runs the same ``SimCSEModel`` / ``LightGCL`` trees.

Inputs and outputs are nested dicts of numpy arrays, so neither direction
needs Flax. ``gbdt_from_sklearn`` carries a fitted scikit-learn histogram
gradient-boosting classifier into the port's tree arrays; it reads attributes
of the object it is given and imports nothing. ``quantized_from_jax`` and
``ivf_from_jax`` carry the device indexes' arrays (``ops/quant.py``,
``ops/ivf.py``) from numpy onto a device, so an index built by either package
can be searched by the other (the JAX structures take the same arrays back
through ``np.asarray``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from recsys_tpu_torch.device import resolve_device
from recsys_tpu_torch.models.layers import MultiHeadDotProductAttention

_MHA_IN = ("query", "key", "value")


def _convert_module(name: str, node: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    if "kernel" in node:
        w = np.asarray(node["kernel"])
        b = np.asarray(node["bias"])
        if w.ndim == 3 and name in _MHA_IN:
            return {"weight": w.reshape(w.shape[0], -1).T, "bias": b.reshape(-1)}
        if w.ndim == 3 and name == "out":
            return {"weight": w.reshape(-1, w.shape[-1]).T, "bias": b}
        return {"weight": w.T, "bias": b}
    if set(node) == {"embedding"}:
        return {"weight": np.asarray(node["embedding"])}
    if set(node) == {"scale", "bias"}:
        return {"weight": np.asarray(node["scale"]), "bias": np.asarray(node["bias"])}
    raise KeyError(f"unrecognised leaf module {name!r} with keys {sorted(node)}")


def flax_to_torch(params: Mapping) -> dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (a Flax ``params`` tree) -> state_dict."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str, name: str) -> None:
        leaves = {k: v for k, v in node.items() if not isinstance(v, Mapping)}
        if leaves and any(k in leaves for k in ("kernel", "embedding", "scale")):
            for k, v in _convert_module(name, leaves).items():
                out[prefix + k] = torch.tensor(np.asarray(v), dtype=torch.float32)
            return
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}.", k)
            else:  # a raw parameter of a custom module
                out[prefix + k] = torch.tensor(np.asarray(v), dtype=torch.float32)

    walk(params, "", "")
    return out


def torch_to_flax(model: nn.Module) -> dict:
    """The model's parameters as a Flax ``params`` tree of numpy arrays."""
    tree: dict = {}

    def put(path: str, value: np.ndarray) -> None:
        node = tree
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    heads = {name: m.num_heads for name, m in model.named_modules()
             if isinstance(m, MultiHeadDotProductAttention)}
    kinds = {name: type(m) for name, m in model.named_modules()}
    for key, t in model.state_dict().items():
        arr = t.detach().cpu().float().numpy()
        mod, _, leaf = key.rpartition(".")
        kind = kinds.get(mod)
        parent, _, last = mod.rpartition(".")
        if kind is not None and issubclass(kind, nn.Linear):
            if parent in heads and last in _MHA_IN:
                H = heads[parent]
                if leaf == "weight":
                    put(f"{mod}.kernel", arr.T.reshape(arr.shape[1], H, -1))
                else:
                    put(f"{mod}.bias", arr.reshape(H, -1))
            elif parent in heads and last == "out":
                H = heads[parent]
                put(f"{mod}.{'kernel' if leaf == 'weight' else 'bias'}",
                    arr.T.reshape(H, -1, arr.shape[0]) if leaf == "weight" else arr)
            else:
                put(f"{mod}.{'kernel' if leaf == 'weight' else 'bias'}",
                    arr.T if leaf == "weight" else arr)
        elif kind is not None and issubclass(kind, nn.Embedding):
            put(f"{mod}.embedding", arr)
        elif kind is not None and issubclass(kind, nn.LayerNorm):
            put(f"{mod}.{'scale' if leaf == 'weight' else 'bias'}", arr)
        else:
            put(key, arr)
    return tree


def load_flax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Copy a Flax ``params`` tree into ``model`` (strict: every key maps)."""
    model.load_state_dict(flax_to_torch(params), strict=True)
    return model


def gbdt_from_sklearn(model) -> dict:
    """A fitted binary ``HistGradientBoostingClassifier`` -> the tree arrays
    ``train.reranker.GBDTRanker.from_trees`` takes: (T, M) node arrays padded
    with zero-valued leaves, ``depth`` of the deepest tree and ``baseline``
    (the raw prediction before the first tree). Leaf values already carry the
    learning rate; a row goes left when ``x <= threshold``."""
    predictors = model._predictors
    if any(len(per_class) != 1 for per_class in predictors):
        raise ValueError("want a binary classifier (one tree an iteration)")
    nodes = [per_class[0].nodes for per_class in predictors]
    if any(n["is_categorical"].any() for n in nodes):
        raise ValueError("categorical splits are not carried over")
    M = max((len(n) for n in nodes), default=1)
    fields = {"feature": ("feature_idx", np.int64), "threshold": ("num_threshold", np.float64),
              "left": ("left", np.int64), "right": ("right", np.int64),
              "value": ("value", np.float64), "is_leaf": ("is_leaf", bool),
              "missing_left": ("missing_go_to_left", bool)}
    out = {k: np.zeros((len(nodes), M), dt) for k, (_, dt) in fields.items()}
    out["is_leaf"][:] = True
    for t, n in enumerate(nodes):
        for k, (name, dt) in fields.items():
            out[k][t, :len(n)] = n[name].astype(dt)
    out["depth"] = max((int(n["depth"].max()) for n in nodes), default=0)
    out["baseline"] = float(np.asarray(model._baseline_prediction).reshape(-1)[0])
    return out


def quantized_from_jax(q, col_scale, device: torch.device | str = "cuda"):
    """The JAX ``QuantizedItems`` arrays (int8 (N+1, D), float32 (D,)) ->
    the port's ``ops.quant.QuantizedItems`` on ``device``."""
    from recsys_tpu_torch.ops.quant import QuantizedItems

    device = resolve_device(device)
    return QuantizedItems(torch.tensor(np.asarray(q, np.int8), device=device),
                          torch.tensor(np.asarray(col_scale, np.float32), device=device))


def ivf_from_jax(centroids, bucket_ids, bucket_vecs, device: torch.device | str = "cuda"):
    """The JAX ``IvfIndexArrays`` arrays -> the port's
    ``ops.ivf.IvfIndexArrays`` on ``device``."""
    from recsys_tpu_torch.ops.ivf import IvfIndexArrays

    device = resolve_device(device)
    return IvfIndexArrays(torch.tensor(np.asarray(centroids, np.float32), device=device),
                          torch.tensor(np.asarray(bucket_ids, np.int32), device=device),
                          torch.tensor(np.asarray(bucket_vecs, np.float32), device=device))
