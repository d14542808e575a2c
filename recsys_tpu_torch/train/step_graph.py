"""One training step as one CUDA graph, replayed once a batch.

The JAX package compiles each training step of its main path into one
program: ``jax.jit`` of the stage-2 step (``recsys_tpu/train/sasrec.py:231``)
and of the item-tower step (``recsys_tpu/train/simcse.py:92``). The port's
steps are eager PyTorch, a thousand and more launches each, so the host
leaves the card idle most of a step. ``StepGraph`` is the counterpart of that
``jit``: it takes a trainer's step function as it is (``make_stage2_step``,
``make_train_step``) and, on the card,

  * holds static device index vectors; each batch's indices are copied into
    them from pinned host memory (a ring of HOST_SLOTS slots a vector, each
    reused only after its copy has run), and the gather of the device-resident
    data is part of the step, so it is inside the graph. A step takes one
    vector (every data key gathered by it) or several named ones of their own
    lengths (``batch_size`` a dict): the LightGCL step's edge positions, which
    gather its users and positives, and its host-drawn negatives; distill's
    user rows and item rows, into tables of different lengths; the pairwise
    reranker's rows and the groups that gather its positive mask;
  * runs the first WARMUP_STEPS steps eagerly on its own stream, as real
    training steps: they make Adam's moments, the kernels' workspaces and the
    libraries' handles outside the graph;
  * captures forward, backward and the optimizer step (the gradients are
    allocated in the graph's pool) with the trainer's ``torch.Generator``
    registered, so every replay draws fresh numbers for dropout, the view
    corruption, the random cut and the sampled positions. A capture does not
    execute, so the batch it captured is replayed right after it, and the
    step's host-side count of that pass is undone;
  * replays the graph once a batch on its stream, ordered after the
    caller's stream and before its next work, and returns copies of its
    outputs (the graph writes every replay's into the same buffers).

Each runner's warm-up, capture and replays run on a stream of its own (one
of torch's pool, which hands out its 32 streams a device in turn), where
K1's per-stream workspace for it lives. So up to 32 trainers at once, in
several threads (a server's ``/train/*`` routes), neither share a workspace
nor put work on a stream that another is capturing.

The optimizer decides nothing on the host (``train/state.py``), and the hand
kernels' launches are counted once a replay (``ops/_build.count_launch``). A
capture or a replay that fails raises; nothing falls back to the eager step.
``capture=False`` runs the same step eagerly, with the batch gathered by the
same indices: the CPU's path, and an eager reference on the card. A vector of
another length than its own raises on either path. ``draws`` (fixed random
draws of the stage-2 step, device tensors) are copied into static buffers;
integers drawn on the host go through the index ring instead, since a copy
from a host tensor would make the host wait.

Only one capture runs at a time in a process (``_CAPTURE_LOCK``), and it runs
in the ``thread_local`` capture mode, so that a server's other threads may
use the card, and replay their own graphs, while a ``/train/*`` route
captures its step.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from recsys_tpu_torch.ops._build import captured_launches, count_replay
from recsys_tpu_torch.train.state import TrainState

WARMUP_STEPS = 2          # eager steps on the runner's stream before the capture
HOST_SLOTS = 4            # pinned index buffers in flight
_CAPTURE_LOCK = threading.Lock()


def _copy_out(out):
    if isinstance(out, dict):
        return {k: _copy_out(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_copy_out(v) for v in out)
    return out.clone() if isinstance(out, torch.Tensor) else out


class StepGraph:
    """``runner(idx, draws=None)`` runs ``step`` on the rows ``idx`` of
    ``data`` (a dict of device tensors) and returns its outputs; see the
    module docstring. ``step(batch, generator[, draws=...])`` is a trainer's
    step, ``state`` its ``TrainState``.

    ``batch_size`` an int: ``idx`` is one int vector of that length and the
    batch is every key of ``data`` gathered by it. ``batch_size`` a dict
    ``{name: length}``: ``idx`` is a dict of int vectors of those lengths, a
    key of ``data`` is gathered by the vector ``gather`` names for it, and
    the batch also holds every vector, on the device, under its name."""

    def __init__(self, step, state: TrainState, data: dict, batch_size: int | dict,
                 generator: torch.Generator | None, *, gather: dict | None = None,
                 capture: bool | None = None):
        self.step, self.state, self.data = step, state, data
        self.generator = generator
        self.named = isinstance(batch_size, dict)
        self.sizes = dict(batch_size) if self.named else {"idx": batch_size}
        self.gather = gather if self.named else {k: "idx" for k in data}
        if set(self.gather) != set(data) or not set(self.gather.values()) <= set(self.sizes):
            raise ValueError(f"gather {self.gather} must name a vector of {list(self.sizes)} "
                             f"for every key of the data {list(data)}")
        if self.named and set(self.sizes) & set(data):
            raise ValueError(f"the vectors {list(self.sizes)} and the data {list(data)} "
                             "share a name")
        self.device = next(iter(data.values())).device
        self.capture = self.device.type == "cuda" if capture is None else capture
        if self.capture and self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs the data on a CUDA device, not {self.device}")
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches: list = []        # the hand kernels' launches in one replay
        self.replays = 0
        self._calls = 0
        self._draws: dict | None = None
        if self.capture:
            self.stream = torch.cuda.Stream(self.device)
            self._idx = {name: torch.zeros(n, dtype=torch.int64, device=self.device)
                         for name, n in self.sizes.items()}
            self._host = {name: torch.zeros((HOST_SLOTS, n), dtype=torch.int64,
                                            pin_memory=True)
                          for name, n in self.sizes.items()}
            self._copied = [None] * HOST_SLOTS

    def __call__(self, idx, draws: dict | None = None):
        vectors = self._vectors(idx)
        if not self.capture:
            return self._run({name: torch.as_tensor(v, device=self.device)
                              for name, v in vectors.items()}, draws)
        self._load(vectors, draws)
        if self.graph is None and self._calls < WARMUP_STEPS:
            out = self._on_stream(lambda: self._run(self._idx, self._draws))
        else:
            if self.graph is None:
                self._capture()
            out = self._replay()
        self._calls += 1
        return out

    def _vectors(self, idx) -> dict:
        """``idx`` as ``{name: int64 numpy vector}``, each of its length."""
        given = idx if self.named else {"idx": idx}
        if set(given) != set(self.sizes):
            raise ValueError(f"index vectors {sorted(given)}, the graph's are "
                             f"{sorted(self.sizes)}")
        out = {}
        for name, n in self.sizes.items():
            v = np.asarray(given[name], dtype=np.int64)
            if v.shape != (n,):
                raise ValueError(f"{name}: a batch of {v.shape}, the graph's is ({n},)")
            out[name] = v
        return out

    def _run(self, ix: dict, draws: dict | None):
        batch = {k: v[ix[self.gather[k]]] for k, v in self.data.items()}
        if self.named:
            batch.update(ix)
        if draws is None:
            return self.step(batch, self.generator)
        return self.step(batch, self.generator, draws=draws)

    def _load(self, vectors: dict, draws: dict | None) -> None:
        """This batch's index vectors (and draws) into the static buffers, on
        the current stream."""
        slot = self._calls % HOST_SLOTS
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()   # the copy HOST_SLOTS batches ago has run
        for name, v in vectors.items():
            self._host[name][slot].numpy()[:] = v
            self._idx[name].copy_(self._host[name][slot], non_blocking=True)
        self._copied[slot] = torch.cuda.Event()
        self._copied[slot].record()
        if (draws is None) != (self._draws is None) and self._calls:
            raise ValueError("draws must be given at every call or at none")
        if draws is not None:
            if self._draws is None:
                self._draws = {k: torch.empty_like(v) for k, v in draws.items()}
            for k, v in draws.items():
                self._draws[k].copy_(v)

    def _on_stream(self, fn):
        """``fn()`` on the runner's stream, after the work the caller's stream
        holds so far and before its next work."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn()
        current.wait_stream(self.stream)
        return out

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        count = self.state.step
        with _CAPTURE_LOCK, captured_launches() as log:
            with torch.cuda.graph(graph, stream=self.stream, capture_error_mode="thread_local"):
                self._outputs = self._run(self._idx, self._draws)
        self.state.step = count      # the capture ran the step's Python, not its work
        self.graph, self.launches = graph, log

    def _replay(self):
        self._on_stream(self.graph.replay)
        count_replay(self.launches)
        self.state.step += 1
        self.replays += 1
        return _copy_out(self._outputs)
