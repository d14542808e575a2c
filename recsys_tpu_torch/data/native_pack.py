"""ctypes binding for the native C++ feature packer (batch tokenization).

Produces ids bit-identical to the pure-Python tokenizer
(recsys_tpu_torch/data/tokenizer.py — same lowercase [a-z0-9]+ split, same
zlib-CRC32 bucketing) but packs whole batches in one call with thread
parallelism. ``tokenize_items`` uses this automatically when the shared
library builds; the Python loop is the fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "build", "libfeaturepack.so")

_lib = None


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO_PATH):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    if not os.path.exists(_SO_PATH):
        return None
    lib = ctypes.CDLL(_SO_PATH)
    lib.featurepack_encode_batch.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int]
    lib.featurepack_encode_fields.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load_lib() is not None


def _blob(strings: list[str]):
    encoded = [s.encode("utf-8") for s in strings]
    offsets = np.zeros(len(encoded) + 1, np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    return b"".join(encoded), offsets


def encode_batch(texts: list[str], max_len: int, vocab_size: int,
                 num_threads: int = 2):
    """-> (ids, mask), both (len(texts), max_len) int32."""
    lib = _load_lib()
    assert lib is not None, "native featurepack unavailable"
    blob, offsets = _blob(texts)
    m = len(texts)
    ids = np.zeros((m, max_len), np.int32)
    mask = np.zeros((m, max_len), np.int32)
    lib.featurepack_encode_batch(
        blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), m,
        vocab_size, max_len,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), num_threads)
    return ids, mask


def encode_fields(cells: list[list[str]], max_tokens: int, vocab_size: int,
                  num_threads: int = 2):
    """cells: flat list (one entry per (item, field)) of value-string lists.
    -> (ids, mask, value_idx), each (len(cells), max_tokens) int32."""
    lib = _load_lib()
    assert lib is not None, "native featurepack unavailable"
    values: list[str] = []
    cell_starts = np.zeros(len(cells) + 1, np.int64)
    for i, cell in enumerate(cells):
        values.extend(str(v) for v in cell)
        cell_starts[i + 1] = len(values)
    blob, offsets = _blob(values)
    n = len(cells)
    ids = np.zeros((n, max_tokens), np.int32)
    mask = np.zeros((n, max_tokens), np.int32)
    val = np.zeros((n, max_tokens), np.int32)
    lib.featurepack_encode_fields(
        blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cell_starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
        vocab_size, max_tokens,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        val.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), num_threads)
    return ids, mask, val
