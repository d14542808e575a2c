"""Build and load the port's CUDA kernels.

Each kernel source under ``csrc/`` has a plain C interface. It is compiled
with ``nvcc`` for sm_90a into ``csrc/build/`` at first use, keyed by the hash
of the source and the flags, and loaded with ``ctypes``. A failed build
raises; nothing carries on without the kernel.

Launch counts: a wrapper counts each launch with ``count_launch``. A launch
made while a stream is being captured into a CUDA graph does not run then;
it is logged inside ``captured_launches()`` instead, and every replay of the
graph adds the logged launches to their counts (``count_replay``), so a count
is what the card ran.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the kernels are built "
                       "from recsys_tpu_torch/csrc/ at first use")


def build(source: Path) -> tuple[Path, dict]:
    """Compile ``source`` into ``csrc/build/``; returns (library, build info)."""
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{source.stem}_{digest}.so"
    report = so.with_suffix(".ptxas")   # what ptxas said of the build, kept beside it
    if so.exists():
        return so, {"path": str(so), "seconds": 0.0, "cached": True,
                    "ptxas": report.read_text() if report.exists() else ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {source}:\n{proc.stderr}")
    report.write_text(proc.stderr)
    os.replace(tmp, so)
    return so, {"path": str(so), "seconds": time.perf_counter() - t0,
                "cached": False, "ptxas": proc.stderr}


class KernelLibrary:
    """One ``csrc/*.cu`` source, built and loaded once per process.

    ``bind(lib)`` declares ``argtypes``/``restype`` of the C functions;
    ``info`` holds the build's path, seconds and ptxas output."""

    def __init__(self, source_name: str, bind: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / source_name
        self.info: dict = {}
        self._bind = bind
        self._lib = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                so, info = build(self.source)
                lib = ctypes.CDLL(str(so))
                self._bind(lib)
                self.info.update(info)
                self._lib = lib
        return self._lib


def raise_on_error(code: int, name: str) -> None:
    """``code`` is the ``cudaGetLastError()`` a launch function returned."""
    if code != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {code}")


# (counts, name) of each launch captured inside ``captured_launches()``
_CAPTURE_LOG: list | None = None


def count_launch(counts: dict, name: str) -> None:
    """One launch of kernel ``name``: counted now, or logged for the replays
    of the graph being captured."""
    if not torch.cuda.is_current_stream_capturing():
        counts[name] += 1
    elif _CAPTURE_LOG is None:
        raise RuntimeError(f"{name} launched in a CUDA graph capture outside "
                           "captured_launches(): its replays would go uncounted")
    else:
        _CAPTURE_LOG.append((counts, name))


@contextlib.contextmanager
def captured_launches():
    """Log the kernel launches captured inside the block; yields the log,
    which ``count_replay`` adds to the counts once a replay."""
    global _CAPTURE_LOG
    outer, _CAPTURE_LOG = _CAPTURE_LOG, []
    try:
        yield _CAPTURE_LOG
    finally:
        _CAPTURE_LOG = outer


def count_replay(log: list) -> None:
    for counts, name in log:
        counts[name] += 1
