"""Device mesh and the placement helpers of sharded values.

Counterpart of ``recsys_tpu/parallel/mesh.py``:

  * ``data`` axis  - batch sharding of the training loops;
  * ``model`` axis - row sharding of the item matrix, of the full-catalog
    score + top-k and of the GNN's edge list.

A ``Mesh`` is a ``(num_data, num_model)`` grid of ``torch.device``s. The same
device may stand at several places (virtual shards): the program is the same
whether eight shards lie on eight cards, on one card or on the CPU. A value
sharded over an axis is a list with one tensor per position, held on the
axis's first ring (``mesh.axis_devices(axis)``): the one controller keeps one
copy where JAX keeps a replica per position of the other axis.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from recsys_tpu_torch.config import MeshConfig


class Mesh:
    """A (data, model) grid of devices."""

    def __init__(self, devices, axis_names: Sequence[str] = ("data", "model")):
        grid = np.empty(np.shape(devices), dtype=object)
        for pos, dev in np.ndenumerate(np.asarray(devices, dtype=object)):
            grid[pos] = torch.device(dev)
        if grid.ndim != len(axis_names):
            raise ValueError(f"{grid.ndim}-d device grid for axes {tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def groups(self, axis: str) -> list[list[torch.device]]:
        """The rings along ``axis``: one list of devices for every setting of
        the other coordinates, in position order along the axis."""
        ax = self.axis_names.index(axis)
        moved = np.moveaxis(self.devices, ax, -1)
        return [list(ring) for ring in moved.reshape(-1, self.devices.shape[ax])]

    def axis_devices(self, axis: str) -> list[torch.device]:
        """Where the shards of a value sharded over ``axis`` live."""
        return self.groups(axis)[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={sorted({str(d) for d in self.devices.flat})})"


def build_mesh(cfg: MeshConfig = MeshConfig(), devices=None) -> Mesh:
    """A (data, model) mesh over ``devices`` (default: every visible CUDA
    device; without one this raises, it never takes the CPU by itself).

    ``num_data=-1`` takes all devices left over after ``num_model``. A mesh
    that needs more devices than are given raises; list a device several
    times to lay virtual shards over it."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("build_mesh: no CUDA device is available "
                               "(pass devices=[...] to build a mesh elsewhere)")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    num_model = cfg.num_model if cfg.num_model > 0 else 1
    if n % num_model != 0:
        raise ValueError(f"{n} devices not divisible by model={num_model}")
    num_data = cfg.num_data if cfg.num_data > 0 else n // num_model
    if num_data * num_model > n:
        raise ValueError(f"a {num_data} x {num_model} mesh needs "
                         f"{num_data * num_model} devices, {n} given")
    grid = np.empty((num_data, num_model), dtype=object)
    for i, dev in enumerate(devices[: num_data * num_model]):
        grid[divmod(i, num_model)] = dev
    return Mesh(grid, (cfg.data_axis, cfg.model_axis))


def mesh_devices(device: torch.device | str, n: int | None = None) -> list[str]:
    """The devices to build a mesh from: every visible card when ``device`` is
    a CUDA device, else ``device`` itself; with ``n``, that list repeated in
    turn until it has ``n`` places (virtual shards)."""
    device = torch.device(device)
    devices = ([f"cuda:{i}" for i in range(torch.cuda.device_count())]
               if device.type == "cuda" else [str(device)])
    if n is None:
        return devices
    return [devices[i % len(devices)] for i in range(n)]


def shard(mesh: Mesh, x, axis: str) -> list[torch.Tensor]:
    """Split a host array or a tensor along dim 0 into the axis's shards,
    shard i on the axis's device i. The length must divide evenly (pads are
    the caller's job, see ``pad_to_multiple``)."""
    devices = mesh.axis_devices(axis)
    x = torch.as_tensor(x)
    if x.dim() == 0 or x.shape[0] % len(devices):
        raise ValueError(f"cannot shard {tuple(x.shape)} over {axis}={len(devices)}")
    rows = x.shape[0] // len(devices)
    return [x[i * rows:(i + 1) * rows].to(dev) for i, dev in enumerate(devices)]


def shard_rows(mesh: Mesh, x) -> list[torch.Tensor]:
    """Row-shard over the model axis: embedding tables, the item matrix."""
    return shard(mesh, x, mesh.axis_names[1])


def shard_batch(mesh: Mesh, batch):
    """Shard the leading (batch) dim over the data axis. ``batch`` is one
    array or a mapping of arrays; a mapping gives a list of mappings."""
    axis = mesh.axis_names[0]
    if not isinstance(batch, Mapping):
        return shard(mesh, batch, axis)
    parts = {k: shard(mesh, v, axis) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(mesh.shape[axis])]


def replicate(mesh: Mesh, x, axis: str) -> list[torch.Tensor]:
    """One copy of ``x`` per position on ``axis``; positions that share a
    device share the tensor."""
    x = torch.as_tensor(x)
    copies: dict[torch.device, torch.Tensor] = {}
    return [copies.setdefault(dev, x.to(dev)) for dev in mesh.axis_devices(axis)]


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0, fill=0):
    """Pad ``axis`` up to a multiple, returning the padded array and the
    original length (for masking)."""
    n = arr.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return arr, n
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(arr, pad_width, constant_values=fill), n
