"""The port's real-data front door against the JAX package's, on the CPU:
``data/ingest.py``, ``data/hm_adapter.py`` and the ``ingest-hm`` / ``enrich``
stages. Both are host pandas code, so frames are held equal with
``pd.testing.assert_frame_equal``, dtypes included, on the CSV fixtures of
``tests/test_hm_adapter.py`` and the logs of ``tests/test_ingest_misc.py``."""

import json
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from recsys_tpu.data import hm_adapter as JH
from recsys_tpu.data import ingest as JI
from recsys_tpu.pipeline import cli as jax_cli
from recsys_tpu_torch.data import hm_adapter as TH
from recsys_tpu_torch.data import ingest as TI
from recsys_tpu_torch.pipeline import cli
from test_hm_adapter import ARTICLES, CUSTOMERS, TRANSACTIONS


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def hm_dir(tmp_path):
    d = tmp_path / "hm"
    d.mkdir()
    (d / "articles.csv").write_text(ARTICLES)
    (d / "customers.csv").write_text(CUSTOMERS)
    (d / "transactions_train.csv").write_text(TRANSACTIONS)
    return str(d)


def _json_log(path, n=2500):
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({"user_id": f"u{i % 7}", "item_id": f"i{i % 40}",
                                "day": i % 100, "price": 9.5, "channel": 1}) + "\n")


@pytest.mark.parametrize("kind", ["json", "csv"])
def test_streaming_ingest_equals_jax(tmp_path, kind):
    path = tmp_path / f"tx.{'jsonl' if kind == 'json' else 'csv'}"
    if kind == "json":
        _json_log(path)
    else:
        with open(path, "w") as f:
            f.write("user_id,item_id,day,price,channel\n")
            for i in range(130):
                f.write(f"u{i % 9},i{i},{i % 50},1.5,2\n")
    it = TI.iter_json_records if kind == "json" else TI.iter_csv_records
    ref_it = JI.iter_json_records if kind == "json" else JI.iter_csv_records
    got, ref = list(it(str(path), 64)), list(ref_it(str(path), 64))
    assert len(got) == len(ref) > 1
    for a, b in zip(got, ref):
        pd.testing.assert_frame_equal(a, b)
    out, ref_out = str(tmp_path / "port.parquet"), str(tmp_path / "jax.parquet")
    r = TI.ingest_transactions(str(path), out, day_min=10, day_max=39, chunk_rows=64)
    assert r == JI.ingest_transactions(str(path), ref_out, day_min=10, day_max=39,
                                       chunk_rows=64)
    assert not r["cached"] and 0 < r["rows"] < r["scanned"]
    pd.testing.assert_frame_equal(pd.read_parquet(out), pd.read_parquet(ref_out))
    assert TI.ingest_transactions(str(path), out) == {"rows": r["rows"], "cached": True}


@pytest.mark.parametrize("window", [(None, None), ("2019-09-23", "2019-12-31")])
def test_hm_frames_equal_jax(hm_dir, window):
    lo, hi = window
    got = TH.load_hm_dataset(hm_dir, date_min=lo, date_max=hi, chunk_rows=2)
    ref = JH.load_hm_dataset(hm_dir, date_min=lo, date_max=hi, chunk_rows=2)
    for a, b in zip(got, ref):
        pd.testing.assert_frame_equal(a, b)
    items, users, tx = got
    assert len(tx) == (6 if lo is None else 5) and tx["channel"].dtype == np.int8
    assert items["release_day"].dtype == np.int32 and len(users) == 3
    pd.testing.assert_frame_equal(TH.items_from_hm(f"{hm_dir}/articles.csv", enrich=False),
                                  JH.items_from_hm(f"{hm_dir}/articles.csv", enrich=False))
    assert TH.vocab_from_items(items).config == JH.vocab_from_items(items).config


def test_hm_enrichment_equals_jax(hm_dir):
    rows = pd.read_csv(f"{hm_dir}/articles.csv").to_dict("records")
    rows.append({"detail_desc": None, "product_group_name": "Shoes",
                 "graphical_appearance_name": "Glitter", "section_name": "Kids Sport"})
    for row in rows:
        assert TH.enrich_hm_item(row) == JH.enrich_hm_item(row)


def test_ingest_hm_and_enrich_stages_write_what_the_jax_stages_write(hm_dir, tmp_path):
    roots = {"port": str(tmp_path / "port"), "jax": str(tmp_path / "jax")}
    out = cli.main(["ingest-hm", "--hm-dir", hm_dir, "--set", f"data.root={roots['port']}"])
    ref = jax_cli.main(["ingest-hm", "--hm-dir", hm_dir, "--set", f"data.root={roots['jax']}"])
    assert {k: v for k, v in out.items() if k != "vocab"} == \
        {k: v for k, v in ref.items() if k != "vocab"}
    with open(out["vocab"]) as f, open(ref["vocab"]) as g:
        assert json.load(f) == json.load(g)
    for name in ("items", "users", "transactions"):
        pd.testing.assert_frame_equal(pd.read_parquet(f"{roots['port']}/{name}.parquet"),
                                      pd.read_parquet(f"{roots['jax']}/{name}.parquet"))

    # enrich over a generated world's item master, through both CLIs
    world = str(tmp_path / "world")
    sets = ["--set", "data.num_items=40", "--set", "data.num_users=10", "--set", "data.days=20"]
    cli.main(["gen-data", *sets, "--set", f"data.root={world}", "--device", "cpu"])
    shutil.copytree(world, world + "_jax")
    items0 = pd.read_parquet(f"{world}/items.parquet")
    out = cli.main(["enrich", *sets, "--set", f"data.root={world}"])
    ref = jax_cli.main(["enrich", *sets, "--set", f"data.root={world}_jax"])
    assert out == ref == {"enriched": 40}
    got = pd.read_parquet(f"{world}/items.parquet")
    pd.testing.assert_frame_equal(got, pd.read_parquet(f"{world}_jax/items.parquet"))
    pd.testing.assert_frame_equal(got, items0)   # the generated world is enriched already
