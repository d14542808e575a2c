"""The port's host leftovers against the JAX package's, on the CPU: the
``orchestrate`` stage against the port's own server, the offline analysis
and t-SNE utilities, and the loggers / trace context of ``train/metrics.py``.

Analysis and plots import scikit-learn (and matplotlib) inside their
functions in both packages; their tests skip where those are missing, as on
the GPU machine. Frames are held equal with ``pd.testing.assert_frame_equal``.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from recsys_tpu.data import analysis as JA
from recsys_tpu.data.synthetic import generate_dataset
from recsys_tpu.pipeline import cli as jax_cli
from recsys_tpu_torch.config import Config, DataConfig, ServeConfig
from recsys_tpu_torch.data import analysis as TA
from recsys_tpu_torch.pipeline import cli
from recsys_tpu_torch.serve.app import build_app_context
from recsys_tpu_torch.serve.server import make_server, serve_forever_in_thread
from recsys_tpu_torch.train import metrics as TM


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- orchestrate ----------------------------------------------------------------

def _products(prefix, n):
    return [{"product_id": f"{prefix}{i}", "product_name": f"p {i}",
             "feature_data": {"reinforced_feature": {"CAT": ["shirt"]}}} for i in range(n)]


def test_orchestrate_once_against_the_port_server():
    ctx = build_app_context(Config(serve=ServeConfig(db_path=":memory:", batch_size=4)))
    ctx.store.ingest_products(_products("x", 10))
    server = make_server(ctx, host="127.0.0.1", port=0)
    thread = serve_forever_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        out = cli.main(["orchestrate", "--once", "--server", base])
        assert out == {"vectorized": 10, "loops": 3}  # ceil(10 / 4)
        assert cli.main(["orchestrate", "--once", "--server", base]) == {"vectorized": 0,
                                                                         "loops": 0}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def _recording_call(drain=(4, 4, 2)):
    """A server stand-in: process-pending answers ``drain`` then 0 a cycle."""
    calls, left = [], list(drain)

    def call(method, path, payload=None):
        calls.append((method, path, payload))
        if path.endswith("process-pending"):
            return {"processed_count": left.pop(0) if left else 0}
        return {"started": True, "task": f"bg-{len(calls)}"}

    return call, calls


def test_orchestrate_cycles_weekly_branch_matches_jax():
    """The same injected clock drives both schedulers: the same calls in the
    same order, the same records, the weekly trigger on the first due cycle,
    not within the interval, again once overdue."""
    runs = []
    for orchestrate_cycles in (cli.orchestrate_cycles, jax_cli.orchestrate_cycles):
        call, calls = _recording_call()
        clock = {"t": 1_000_000.0}
        records, lw = [], 0.0
        for step in (0.0, 3600.0, 8 * 24 * 3600.0):
            clock["t"] += step
            recs, lw = orchestrate_cycles(call, 1, last_weekly=lw, now_fn=lambda: clock["t"])
            records += recs
        runs.append((calls, records, lw))
    assert runs[0] == runs[1]
    calls, records, lw = runs[0]
    assert ["weekly" in r for r in records] == [True, False, True]
    assert records[0]["hourly"] == {"vectorized": 10, "loops": 3}
    assert calls.count(("POST", "/ai-api/serving/train/start", {})) == 2
    assert lw == 1_000_000.0 + 3600.0 + 8 * 24 * 3600.0


def test_orchestrate_weekly_trigger_starts_training_on_the_port_server():
    ctx = build_app_context(Config(serve=ServeConfig(db_path=":memory:", batch_size=4)))
    ctx.store.ingest_products(_products("w", 4))
    trained = []
    ctx.train_item_fn = lambda **kw: trained.append(kw) or {"trained": "item-tower"}
    server = make_server(ctx, host="127.0.0.1", port=0)
    thread = serve_forever_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        import urllib.request

        def call(method, path, payload=None):
            req = urllib.request.Request(base + path, method=method,
                                         data=json.dumps(payload or {}).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                return json.loads(resp.read())

        recs, _ = cli.orchestrate_cycles(call, 1, now_fn=lambda: 1e6)
        assert recs[0]["hourly"] == {"vectorized": 4, "loops": 1}
        assert recs[0]["weekly"]["started"] is True
        for t in ctx._bg_threads:
            t.join(timeout=60)
        assert trained == [{}]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


# -- analysis and plots ------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    return generate_dataset(DataConfig(num_items=80, num_users=40, days=40, seed=5))


def test_stratified_kfold_and_personas_equal_jax(world):
    pytest.importorskip("sklearn")
    items, _, tx = world
    pd.testing.assert_frame_equal(TA.stratified_kfold(items, n_splits=3, seed=1),
                                  JA.stratified_kfold(items, n_splits=3, seed=1))
    behavior = TA.behavior_features(tx, items)
    pd.testing.assert_frame_equal(behavior, JA.behavior_features(tx, items))
    assert list(behavior.columns) == ["user_id", *TA.PERSONA_FEATURES]
    got, tags = TA.cluster_personas(behavior, n_clusters=4, seed=0)
    ref, ref_tags = JA.cluster_personas(behavior, n_clusters=4, seed=0)
    pd.testing.assert_frame_equal(got, ref)
    assert tags == ref_tags and set(got["cluster"]) <= set(range(4))


def test_sequence_distribution_stats_equal_jax(world):
    from recsys_tpu_torch.data import etl

    _, _, tx = world
    seqs = etl.make_sequences(tx, 20)
    known = set(tx["item_id"][::2])
    assert TA.sequence_distribution_stats(seqs, known) == \
        JA.sequence_distribution_stats(seqs, known)
    assert TA.sequence_distribution_stats(seqs.iloc[:0], known) == \
        JA.sequence_distribution_stats(seqs.iloc[:0], known)


def test_tsne_scatter_writes_a_png(tmp_path):
    pytest.importorskip("sklearn")
    pytest.importorskip("matplotlib")
    from recsys_tpu_torch.eval.viz import tsne_scatter

    emb = np.random.default_rng(0).normal(size=(60, 16)).astype(np.float32)
    out = str(tmp_path / "tsne.png")
    coords = tsne_scatter(emb, out, labels=np.arange(60) % 3, sample=40)
    assert coords.shape == (40, 2) and np.isfinite(coords).all()
    assert os.path.getsize(out) > 0


# -- loggers and the trace context ----------------------------------------------------

def test_smart_logger_levels_and_the_wandb_sink(capsys):
    log = TM.SmartLogger(level=1)
    log.log("visible", 1)
    log.log("hidden", 2)
    TM.SmartLogger(level=0).log("silent", 1)
    out = capsys.readouterr().out
    assert "visible" in out and "hidden" not in out and "silent" not in out
    try:
        import wandb  # noqa: F401
    except ImportError:   # absent: a no-op sink, as in the JAX package
        assert TM.maybe_wandb_writer("proj", "run")(1, loss=0.5) is None


def test_profile_trace_writes_a_trace_on_the_cpu(tmp_path):
    out = str(tmp_path / "trace")
    with TM.profile_trace(out, device="cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for f in os.listdir(out) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(os.path.join(out, files[0])) as f:
        trace = json.load(f)
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present here")
def test_profile_trace_asks_for_the_card_by_default(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with TM.profile_trace(str(tmp_path / "t")):
            pass
    assert not os.path.exists(tmp_path / "t")
