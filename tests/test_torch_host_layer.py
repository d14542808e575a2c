"""The port's host layer (config, data, serve store / batcher / index) is a
copy of the JAX package's: the same seed and inputs give equal results.

Equality is exact throughout — frames with ``assert_frame_equal``, arrays
with ``array_equal``, config trees with ``==`` — because the modules are
copies, not re-implementations.
"""

import dataclasses
import json

import numpy as np
import pandas as pd
import pytest

import recsys_tpu.config as jax_config
import recsys_tpu.data.dataset as jax_dataset
import recsys_tpu.data.etl as jax_etl
import recsys_tpu.data.native_pack as jax_native_pack
import recsys_tpu.data.synthetic as jax_synthetic
import recsys_tpu.data.tokenizer as jax_tokenizer
import recsys_tpu.data.vocab as jax_vocab
import recsys_tpu.serve.ann as jax_ann
import recsys_tpu.serve.batcher as jax_batcher
import recsys_tpu.serve.store as jax_store
import recsys_tpu_torch.config as t_config
import recsys_tpu_torch.data.dataset as t_dataset
import recsys_tpu_torch.data.etl as t_etl
import recsys_tpu_torch.data.native_pack as t_native_pack
import recsys_tpu_torch.data.synthetic as t_synthetic
import recsys_tpu_torch.data.tokenizer as t_tokenizer
import recsys_tpu_torch.data.vocab as t_vocab
import recsys_tpu_torch.serve.ann as t_ann
import recsys_tpu_torch.serve.batcher as t_batcher
import recsys_tpu_torch.serve.store as t_store

OVERRIDES = {"data": {"num_items": 90, "num_users": 40, "days": 40, "seed": 11},
             "vocab": {"max_field_tokens": 8, "max_name_tokens": 8},
             "gnn": {"emb_dim": 32, "propagation": "segment_sum", "spmm_pack": 1},
             "distill": {"hard_frac": 0.5}, "user_train": {"eval_ks": [5, 20]}}


@pytest.fixture(scope="module")
def configs():
    return (jax_config.load_config(None, OVERRIDES), t_config.load_config(None, OVERRIDES))


@pytest.fixture(scope="module")
def worlds(configs):
    jc, tc = configs
    return jax_synthetic.generate_dataset(jc.data), t_synthetic.generate_dataset(tc.data)


# the knobs of the H&M-scale world (scripts/quality_hm_v4_data.sh) on the small world
V4_KNOBS = {"name_style_words": 2, "repeat_prob": 0.10}


@pytest.fixture(scope="module", params=["default", "v4_knobs"])
def knob_case(request, configs, worlds):
    """(configs, worlds) with the default data knobs, or with ``V4_KNOBS``."""
    if request.param == "default":
        return configs, worlds
    over = {**OVERRIDES, "data": {**OVERRIDES["data"], **V4_KNOBS}}
    cfgs = (jax_config.load_config(None, over), t_config.load_config(None, over))
    assert cfgs[1].data.name_style_words == 2 and cfgs[1].data.repeat_prob == 0.10
    return cfgs, (jax_synthetic.generate_dataset(cfgs[0].data),
                  t_synthetic.generate_dataset(cfgs[1].data))


def _frames_equal(a: pd.DataFrame, b: pd.DataFrame) -> None:
    pd.testing.assert_frame_equal(a, b, check_exact=True)


def test_config_loads_the_same_tree(configs, tmp_path):
    jc, tc = configs
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert dataclasses.asdict(jax_config.Config()) == dataclasses.asdict(t_config.Config())
    assert tc.gnn.emb_dim == 32 and tc.gnn.spmm_pack == 1  # TPU knobs load, unread
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"simcse": {"batch_size": 24}, "serve": {"hnsw_m": 8}}))
    from_file = [m.load_config(str(path), {"simcse": {"epochs": 2}})
                 for m in (jax_config, t_config)]
    assert dataclasses.asdict(from_file[0]) == dataclasses.asdict(from_file[1])
    assert from_file[1].simcse.batch_size == 24 and from_file[1].simcse.epochs == 2
    for module in (jax_config, t_config):
        with pytest.raises(Exception):
            module.load_config(None, {"gnn": {"no_such_field": 1}})


def test_vocab_module_is_equal():
    assert t_vocab.DEFAULT_STD_VOCAB == jax_vocab.DEFAULT_STD_VOCAB
    assert t_vocab.RE_FEATURE_KEYS == jax_vocab.RE_FEATURE_KEYS
    jv, tv = jax_vocab.StdVocab(), t_vocab.StdVocab()
    assert tv.token_to_id == jv.token_to_id and tv.size == jv.size
    assert tv.field_keys == jv.field_keys


def test_tokenizer_module_is_equal():
    texts = ["Red wool SWEATER, slim-fit", "", "a1 b2 c3 d4 e5 f6 g7 h8 i9 j10", "été ñ 42"]
    for text in texts:
        assert t_tokenizer.normalize(text) == jax_tokenizer.normalize(text)
        for got, ref in zip(t_tokenizer.encode(text, 6, 512),
                            jax_tokenizer.encode(text, 6, 512)):
            np.testing.assert_array_equal(got, ref)
    for got, ref in zip(t_tokenizer.encode_batch(texts, 6, 512),
                        jax_tokenizer.encode_batch(texts, 6, 512)):
        np.testing.assert_array_equal(got, ref)
    assert (t_tokenizer.hash_bucket("blue", 97, "colour")
            == jax_tokenizer.hash_bucket("blue", 97, "colour"))


def test_native_pack_builds_in_the_ports_own_directory():
    """The copy resolves ``native/`` relative to itself, and its library
    encodes as the JAX package's does."""
    assert "recsys_tpu_torch" in t_native_pack._NATIVE_DIR
    assert "recsys_tpu_torch" in t_ann._NATIVE_DIR
    if not (t_native_pack.native_available() and jax_native_pack.native_available()):
        pytest.skip("no C++ compiler: the pure-Python tokenizer path is in use")
    texts = ["Red wool sweater", "blue denim jeans 501", ""]
    for got, ref in zip(t_native_pack.encode_batch(texts, 8, 1024),
                        jax_native_pack.encode_batch(texts, 8, 1024)):
        np.testing.assert_array_equal(got, ref)
    cells = [["red", "dark red"], [], ["wool blend"]]
    for got, ref in zip(t_native_pack.encode_fields(cells, 6, 1024),
                        jax_native_pack.encode_fields(cells, 6, 1024)):
        np.testing.assert_array_equal(got, ref)


def test_synthetic_world_is_equal(knob_case):
    _, worlds = knob_case
    for ref, got in zip(*worlds):
        _frames_equal(got, ref)
    items, _, tx = worlds[1]
    split_day = int(tx["day"].max()) - 7 + 1
    assert (t_synthetic.cluster_oracle_recall(items, tx, split_day)
            == jax_synthetic.cluster_oracle_recall(items, tx, split_day))
    row = items.iloc[0].to_dict()
    assert t_synthetic.enrich_item(dict(row)) == jax_synthetic.enrich_item(dict(row))


def test_etl_outputs_are_equal(knob_case):
    configs, worlds = knob_case
    items, users, tx = worlds[1]
    cfg = configs[1]
    outs = []
    for etl in (jax_etl, t_etl):
        train_tx, valid_tx, split_day = etl.time_split(tx, cfg.data.valid_days)
        user_feats, scaler = etl.make_user_features(train_tx, users, split_day)
        seqs = etl.make_sequences(train_tx, cfg.data.max_seq_len)
        targets = etl.make_validation_target(valid_tx)
        outs.append({"split_day": split_day, "train_tx": train_tx, "valid_tx": valid_tx,
                     "item_feats": etl.make_item_features(train_tx, items, split_day),
                     "user_feats": user_feats, "seqs": seqs, "targets": targets,
                     "sanity": etl.final_sanity_check(seqs, targets),
                     "missing": etl.deep_inspect_missing_items(tx, items),
                     "histories": etl.aggregate_histories(train_tx)})
    ref, got = outs
    for key, value in ref.items():
        if isinstance(value, pd.DataFrame):
            _frames_equal(got[key], value)
        else:
            assert got[key] == value, key
    order = sorted(items["item_id"].astype(str))
    np.testing.assert_array_equal(
        t_etl.logq_from_item_features(got["item_feats"], order),
        jax_etl.logq_from_item_features(ref["item_feats"], order))
    np.testing.assert_array_equal(  # reaches the lazy import of data.synthetic
        t_etl.seasonal_logq(got["train_tx"], order, "winter"),
        jax_etl.seasonal_logq(ref["train_tx"], order, "winter"))


def test_tokenize_items_and_stage2_tensors_are_equal(worlds, configs):
    items, users, tx = worlds[1]
    jc, tc = configs
    ref = jax_dataset.tokenize_items(items, jax_vocab.StdVocab(), jc.vocab)
    got = t_dataset.tokenize_items(items, t_vocab.StdVocab(), tc.vocab)
    assert set(got) == set(ref)
    for key, value in ref.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert list(got[key]) == list(value), key
    side_ref, map_ref = jax_dataset.build_side_info(items, 64)
    side_got, map_got = t_dataset.build_side_info(items, 64)
    np.testing.assert_array_equal(side_got, side_ref)
    assert map_got.ids == map_ref.ids
    for a, b in zip(t_dataset.batch_iterator(50, 16, np.random.default_rng(3)),
                    jax_dataset.batch_iterator(50, 16, np.random.default_rng(3))):
        np.testing.assert_array_equal(a, b)


def _products(n):
    return [{"product_id": f"p{i:03d}", "product_name": f"item {i}",
             "feature_data": {"reinforced_feature": {"COL": [f"c{i % 5}"]},
                              "product_type_name": "sweater"}} for i in range(n)]


def test_serve_store_is_equal():
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(12, 8)).astype(np.float32)
    snaps = []
    for module in (jax_store, t_store):
        store = module.ServeStore(":memory:")
        snap = {"ingest": store.ingest_products(_products(12)),
                "again": store.ingest_products(_products(14)),
                "pending": [dataclasses.asdict(p) for p in store.pending_products(5)]}
        store.save_vectors([f"p{i:03d}" for i in range(12)], vecs)
        ids, mat = store.all_vectors()
        snap.update(pending_after=store.pending_count(), ids=ids, mat=mat,
                    one=store.get_vector("p003"), none=store.get_vector("nope"),
                    by_ids=[p.product_id for p in store.products_by_ids(["p001", "p013"])])
        store.close()
        snaps.append(snap)
    ref, got = snaps
    for key in ref:
        if isinstance(ref[key], np.ndarray):
            np.testing.assert_array_equal(got[key], ref[key])
        else:
            assert got[key] == ref[key], key
    assert [e.name for e in t_store.Season] == [e.name for e in jax_store.Season]
    assert [int(e) for e in t_store.ActionType] == [int(e) for e in jax_store.ActionType]


def test_dynamic_batcher_is_equal():
    calls = {"jax": [], "torch": []}
    outs = []
    for name, module in (("jax", jax_batcher), ("torch", t_batcher)):
        def fn(items, name=name):
            calls[name].append(len(items))
            return np.asarray([[float(x), 2.0 * x] for x in items], np.float32)

        batcher = module.DynamicBatcher(fn, max_batch=4, max_wait_ms=1.0)
        outs.append([batcher([1, 2, 3]), batcher.submit([4]), batcher([])])
        assert batcher.stats()["requests"] == 2
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert calls["jax"] == calls["torch"]


@pytest.mark.parametrize("cosine", [True, False])
def test_vector_index_is_equal(cosine, tmp_path):
    rng = np.random.default_rng(1)
    vecs = rng.normal(size=(200, 16)).astype(np.float32)
    queries = rng.normal(size=(7, 16)).astype(np.float32)
    results = []
    for name, module in (("jax", jax_ann), ("torch", t_ann)):
        index = module.VectorIndex(16, cosine=cosine)
        index.add(np.arange(200) + 1000, vecs)
        index.add([1003], vecs[:1] * 2.0)      # overwrite
        assert index.remove(1010) and not index.remove(5)
        first = index.topk(queries, 10)
        index.save(str(tmp_path / f"{name}_{cosine}.idx"))
        loaded = module.VectorIndex.load(str(tmp_path / f"{name}_{cosine}.idx"))
        results.append((len(index), first, loaded.topk(queries, 10)))
    (n_ref, first_ref, loaded_ref), (n_got, first_got, loaded_got) = results
    assert n_got == n_ref == 199
    for got, ref in ((first_got, first_ref), (loaded_got, loaded_ref)):
        np.testing.assert_array_equal(got[0], ref[0])   # ids
        np.testing.assert_array_equal(got[1], ref[1])   # scores
    assert t_ann.native_available() == jax_ann.native_available()


def test_vector_index_numpy_fallback_is_equal(monkeypatch):
    """The pure-numpy path both classes take when no compiler is there."""
    rng = np.random.default_rng(2)
    vecs = rng.normal(size=(50, 8)).astype(np.float32)
    queries = rng.normal(size=(3, 8)).astype(np.float32)
    out = []
    for module in (jax_ann, t_ann):
        monkeypatch.setattr(module, "_load_lib", lambda: None)
        index = module.VectorIndex(8)
        assert index._h is None
        index.add(np.arange(50), vecs)
        index.remove(7)
        out.append(index.topk(queries, 5))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    np.testing.assert_array_equal(out[1][1], out[0][1])


def test_hnsw_index_is_equal():
    if not (t_ann.hnsw_available() and jax_ann.hnsw_available()):
        pytest.skip("no C++ compiler: the native HNSW index cannot be built")
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(300, 16)).astype(np.float32)
    queries = rng.normal(size=(5, 16)).astype(np.float32)
    out = []
    for module in (jax_ann, t_ann):
        index = module.HnswIndex(16, m=8, ef_construction=64, ef_search=64)
        index.add(np.arange(300), vecs, num_threads=1)  # serial build: one graph
        out.append((len(index), index.topk(queries, 10)))
    assert out[0][0] == out[1][0] == 300
    np.testing.assert_array_equal(out[1][1][0], out[0][1][0])
    np.testing.assert_array_equal(out[1][1][1], out[0][1][1])


def test_device_indexes_were_not_copied():
    assert not hasattr(t_ann, "IvfTpuIndex") and not hasattr(t_ann, "Int8TpuIndex")
