"""Checkpoint store and id-map sidecars.

Counterpart of ``recsys_tpu/train/checkpoint.py``. The payload is a
``torch.save`` file (model and optimizer state dicts, ``{name}.pt``); the
``manifest.json`` best/rotation logic is the JAX store's. The id sidecar
format is byte-compatible: ``{path}.npy`` plus ``{path}.ids.json`` with
``"<pad>"`` at row 0, so the JAX stages read the port's item matrix and the
other way round.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Sequence

import numpy as np
import torch


def _manifest_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "manifest.json")


def _load_manifest(ckpt_dir: str) -> dict:
    path = _manifest_path(ckpt_dir)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"checkpoints": [], "best": None}


class CheckpointStore:
    def __init__(self, ckpt_dir: str, keep: int = 3, maximize: bool = True):
        self.dir = ckpt_dir
        self.keep = keep
        self.maximize = maximize
        os.makedirs(ckpt_dir, exist_ok=True)
        self.manifest = _load_manifest(ckpt_dir)

    def _payload_path(self, name: str) -> str:
        return os.path.abspath(os.path.join(self.dir, f"{name}.pt"))

    def save(self, name: str, state: dict[str, Any], *, step: int,
             metric: float | None = None, extra: dict | None = None) -> str:
        """``state``: a dict of state dicts, e.g. {"model": ..., "optimizer": ...};
        ``extra`` goes into the manifest entry (e.g. the epoch, for resume)."""
        path = self._payload_path(name)
        torch.save(state, path)
        entry = {"name": name, "path": path, "step": int(step),
                 "metric": None if metric is None else float(metric),
                 "extra": extra or {}}
        self.manifest["checkpoints"] = [
            c for c in self.manifest["checkpoints"] if c["name"] != name] + [entry]
        self._maybe_update_best(entry)
        self._rotate()
        self._flush()
        return path

    def restore(self, name: str, map_location: str | torch.device = "cpu") -> dict:
        return torch.load(self._payload_path(name), map_location=map_location,
                          weights_only=True)

    def restore_best(self, map_location: str | torch.device = "cpu"
                     ) -> tuple[dict, dict]:
        best = self.manifest.get("best")
        if best is None:
            raise FileNotFoundError(f"no best checkpoint in {self.dir}")
        return self.restore("best", map_location), best

    def restore_best_params(self, map_location: str | torch.device = "cpu"
                            ) -> tuple[dict, dict]:
        """Only the model's state dict of the best checkpoint, and its entry:
        post-hoc consumers (eval, serving) need no optimizer state, so a
        checkpoint of any optimizer recipe loads."""
        payload, best = self.restore_best(map_location)
        return payload["model"], best

    def restore_latest(self, map_location: str | torch.device = "cpu"
                       ) -> tuple[dict, dict] | None:
        """Resume support: the highest-step checkpoint (the full state: model,
        optimizer with its lr factor) and its entry, or None."""
        cks = self.manifest["checkpoints"]
        if not cks:
            return None
        entry = max(cks, key=lambda c: c["step"])
        return self.restore(entry["name"], map_location), entry

    def _maybe_update_best(self, entry: dict) -> None:
        if entry["metric"] is None:
            return
        best = self.manifest.get("best")
        better = (best is None or best.get("metric") is None
                  or (entry["metric"] > best["metric"]) == self.maximize)
        if better:
            # copy the payload so rotation can't evict the best snapshot
            best_path = self._payload_path("best")
            shutil.copyfile(entry["path"], best_path)
            self.manifest["best"] = {**entry, "name": "best", "path": best_path}

    def _rotate(self) -> None:
        cks = sorted(self.manifest["checkpoints"], key=lambda c: c["step"])
        while len(cks) > self.keep:
            victim = cks.pop(0)
            if os.path.exists(victim["path"]):
                os.remove(victim["path"])
        self.manifest["checkpoints"] = cks

    def _flush(self) -> None:
        with open(_manifest_path(self.dir), "w") as f:
            json.dump(self.manifest, f, indent=1)


# -- id-map sidecars ------------------------------------------------------

def save_array_with_ids(path: str, array: np.ndarray, ids: Sequence[str],
                        meta: dict | None = None) -> None:
    """Save an (N, D) array with its row -> string-id sidecar: writes
    ``{path}.npy`` + ``{path}.ids.json``. Row 0 is a zero PAD row and gets
    the id ``"<pad>"`` when len(ids) == N-1."""
    array = np.asarray(array)
    ids = list(map(str, ids))
    if len(ids) == array.shape[0] - 1:
        ids = ["<pad>"] + ids
    if len(ids) != array.shape[0]:
        raise ValueError(f"{len(ids)} ids for {array.shape[0]} rows")
    np.save(path + ".npy", array)
    with open(path + ".ids.json", "w") as f:
        json.dump({"ids": ids, "meta": meta or {}}, f)


def load_array_with_ids(path: str) -> tuple[np.ndarray, list[str], dict]:
    array = np.load(path + ".npy")
    with open(path + ".ids.json") as f:
        side = json.load(f)
    return array, side["ids"], side.get("meta", {})


def align_rows(array: np.ndarray, ids: Sequence[str], target_ids: Sequence[str],
               fill: str = "zero", rng: np.random.Generator | None = None,
               scale: float = 0.02) -> tuple[np.ndarray, np.ndarray]:
    """Re-order artifact rows to a consumer's id order. Missing ids are
    zero- or random-initialized; returns the aligned array and a boolean
    found-mask."""
    index = {str(i): r for r, i in enumerate(ids)}
    out = np.zeros((len(target_ids), array.shape[1]), dtype=array.dtype)
    found = np.zeros(len(target_ids), dtype=bool)
    if fill == "random":
        rng = rng or np.random.default_rng(0)
        out = rng.normal(0.0, scale, out.shape).astype(array.dtype)
    for r, tid in enumerate(map(str, target_ids)):
        src = index.get(tid)
        if src is not None:
            out[r] = array[src]
            found[r] = True
    return out, found


def snapshot_due(epoch: int, total_epochs: int, every: int, improved: bool) -> bool:
    """Shared snapshot cadence: save on metric improvement, on the ``every``
    cadence, and always at the final epoch."""
    return improved or epoch % every == 0 or epoch == total_epochs
