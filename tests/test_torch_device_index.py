"""The two device indexes of the port's server (``serve/ann.IvfDeviceIndex``,
``Int8DeviceIndex``) on the CPU, against the JAX package's ``IvfTpuIndex`` and
``Int8TpuIndex``: the serving lifecycle of ``tests/test_quant.py`` and
``tests/test_ivf.py``, ``.npz`` files written by one package and loaded by the
other, the backend choice of ``build_app_context``, and a similarity request
through both servers on the same store.

Tolerances: ids exactly (both packages take the same top-k with the same tie
order on the same rows); scores within 1e-5 (the same products summed in
another order).
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

from recsys_tpu.config import Config as JaxConfig
from recsys_tpu.config import ServeConfig as JaxServeConfig
from recsys_tpu.serve import ann as JANN
from recsys_tpu.serve import app as JAPP
from recsys_tpu.serve import server as JSRV
from recsys_tpu_torch.config import Config, ServeConfig
from recsys_tpu_torch.serve import ann as TANN
from recsys_tpu_torch.serve import app as TAPP
from recsys_tpu_torch.serve import server as TSRV

INDEXES = {"int8": (JANN.Int8TpuIndex, TANN.Int8DeviceIndex),
           "ivf": (JANN.IvfTpuIndex, TANN.IvfDeviceIndex)}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers on few cores: torch's default of one
    thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _clustered(rng, n_clusters=4, per=30, dim=12):
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
    return np.concatenate([c + 0.05 * rng.normal(size=(per, dim)).astype(np.float32)
                           for c in centers])


def _port_index(backend, dim, **kw):
    cls = INDEXES[backend][1]
    if backend == "ivf":
        kw = {"nlist": 4, "nprobe": 4, **kw}
    return cls(dim, device="cpu", **kw)


def test_int8_index_lifecycle():
    """The lifecycle of tests/test_quant.py's Int8TpuIndex, on the port."""
    rng = np.random.default_rng(5)
    D = 32
    ix = TANN.Int8DeviceIndex(D, device="cpu")
    ids, scores = ix.topk(rng.normal(size=(2, D)).astype(np.float32), 3)
    assert (ids == -1).all() and (scores == 0).all()
    vecs = rng.normal(size=(10, D)).astype(np.float32)
    ix.add(list(range(100, 110)), vecs)
    assert len(ix) == 10
    q = vecs[[3, 7]]
    ids, scores = ix.topk(q, 3)
    assert ids[0, 0] == 103 and ids[1, 0] == 107   # self-match first
    assert scores[0, 0] > 0.98                      # cosine ~ 1
    ix.add([103], -vecs[3:4])                       # update in place
    ids, _ = ix.topk(q[:1], 1)
    assert ids[0, 0] != 103
    assert ix.remove(107) and not ix.remove(999)
    ids, scores = ix.topk(q, 20)
    assert (ids != 107).all()
    assert (ids[:, len(ix):] == -1).all() and (scores[:, len(ix):] == 0).all()


def test_ivf_index_serving_interface():
    """The serving interface of tests/test_ivf.py's IvfTpuIndex, on the port."""
    rng = np.random.default_rng(6)
    vecs = _clustered(rng)
    ids = (np.arange(len(vecs)) + 1000).astype(np.int64)
    ivf = TANN.IvfDeviceIndex(12, nlist=4, nprobe=4, device="cpu")
    exact = TANN.VectorIndex(12, cosine=True)
    ivf.add(ids, vecs)
    exact.add(ids, vecs)
    q = vecs[:5] + 0.01 * rng.normal(size=(5, 12)).astype(np.float32)
    gi, gs = ivf.topk(q, 10)
    ei, _ = exact.topk(q, 10)
    assert np.mean([len(set(a) & set(b)) / 10.0 for a, b in zip(gi, ei)]) == 1.0
    assert (gi != -1).all() and (gs[:, 0] >= gs[:, -1]).all()
    assert ivf.remove(int(ids[0]))
    gi2, _ = ivf.topk(q, 10)
    assert int(ids[0]) not in set(gi2.reshape(-1).tolist())
    i0, s0 = TANN.IvfDeviceIndex(12, device="cpu").topk(q, 3)
    assert (i0 == -1).all() and (s0 == 0).all()
    # more than the catalog: -1 / 0.0 in the tail
    gi3, gs3 = ivf.topk(q, len(ivf) + 5)
    assert (gi3[:, len(ivf):] == -1).all() and (gs3[:, len(ivf):] == 0).all()


@pytest.mark.parametrize("backend", ["int8", "ivf"])
def test_same_answers_as_the_jax_index(backend):
    rng = np.random.default_rng(7)
    vecs = _clustered(rng)
    vecs[40:50] = vecs[10:20]                                   # duplicates: ties
    ids = (np.arange(len(vecs)) * 7 + 3).astype(np.int64)
    jcls = INDEXES[backend][0]
    jix = jcls(12, nlist=4, nprobe=2) if backend == "ivf" else jcls(12)
    tix = _port_index(backend, 12, nprobe=2) if backend == "ivf" else _port_index(backend, 12)
    for ix in (jix, tix):
        ix.add(ids[:70], vecs[:70])
        ix.add(ids[60:], vecs[60:])                             # overlapping upserts
        ix.remove(int(ids[5]))
    q = np.concatenate([vecs[[1, 11, 41]], rng.normal(size=(5, 12)).astype(np.float32)])
    (ji, js), (ti, ts) = jix.topk(q, 15), tix.topk(q, 15)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)


def test_add_keeps_the_jax_row_order():
    rng = np.random.default_rng(8)
    vecs = rng.normal(size=(9, 6)).astype(np.float32)
    batches = [([5, 3, 5, 9], vecs[:4]), ([3, 7, 7, 1, 2], vecs[4:9])]
    jix, tix = JANN.Int8TpuIndex(6), TANN.Int8DeviceIndex(6, device="cpu")
    for ix in (jix, tix):
        for bid, bv in batches:
            ix.add(bid, bv)
        ix.remove(9)
    assert tix._ids == jix._ids and tix._rows == jix._rows
    np.testing.assert_array_equal(tix._data, jix._data)
    with pytest.raises(ValueError):
        tix.add([1, 2], vecs[:3])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("backend", ["int8", "ivf"])
def test_npz_files_load_in_the_other_package(tmp_path, backend, direction):
    rng = np.random.default_rng(9)
    vecs = _clustered(rng)
    ids = np.arange(len(vecs), dtype=np.int64) + 50
    jcls, tcls = INDEXES[backend]
    writer = jcls(12, nlist=4, nprobe=4) if backend == "ivf" else jcls(12)
    reader = tcls
    if direction == "port_to_jax":
        writer, reader = _port_index(backend, 12), jcls
    writer.add(ids, vecs)
    writer.remove(int(ids[3]))
    path = str(tmp_path / "ix")
    writer.save(path)
    back = reader.load(path, device="cpu") if reader is tcls else reader.load(path)
    assert len(back) == len(writer) and back._ids == writer._ids
    q = vecs[:6] + 0.01 * rng.normal(size=(6, 12)).astype(np.float32)
    np.testing.assert_array_equal(back.topk(q, 8)[0], writer.topk(q, 8)[0])


def _serve_cfg(backend, cls=Config, serve_cls=ServeConfig, nprobe=3):
    return cls(serve=serve_cls(db_path=":memory:", batch_size=16, ann_backend=backend,
                               ivf_nlist=4, ivf_nprobe=nprobe, batch_window_ms=0.0))


@pytest.mark.parametrize("backend", ["int8", "ivf"])
def test_build_app_context_selects_the_device_index(backend):
    ctx = TAPP.build_app_context(_serve_cfg(backend), device="cpu")
    assert isinstance(ctx.index, INDEXES[backend][1])
    assert ctx.index.device == torch.device("cpu")
    if backend == "ivf":
        assert (ctx.index.nlist, ctx.index.nprobe) == (4, 3)
    else:
        assert ctx.index.cosine


@pytest.mark.parametrize("backend", ["int8", "ivf"])
def test_build_app_context_needs_a_card_unless_asked_for_the_cpu(backend):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            TAPP.build_app_context(_serve_cfg(backend), device=device)
    # the host indexes take no device
    assert isinstance(TAPP.build_app_context(_serve_cfg("exact")).index, TANN.VectorIndex)


_WORDS = ("red blue green black white wool cotton linen silk denim shirt dress coat "
          "skirt scarf boot sneaker jacket knit striped floral plain slim loose").split()


def _products(n, seed=11):
    rng = np.random.default_rng(seed)
    return [{"product_id": f"p{i}",
             "product_name": " ".join(rng.choice(_WORDS, 4, replace=False)),
             "feature_data": {"reinforced_feature": {
                 "CAT": [str(rng.choice(_WORDS[10:18]))],
                 "COL": [str(c) for c in rng.choice(_WORDS[:5], 2, replace=False)],
                 "MAT": [str(rng.choice(_WORDS[5:10]))]}}}
            for i in range(n)]


def _call(base, method, path, payload=None):
    req = urllib.request.Request(
        base + path, method=method,
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _random_vectorizer(items):
    """A vector of normal draws seeded by each product's id: both servers store
    the same rows, and no two scores of a query tie (the hash vectorizer's
    rows share whole feature sets, so their cosines tie up to the last bit,
    and the two packages' sums then order them apart)."""
    return np.stack([np.random.default_rng(int(it.product_id[1:])).normal(size=128)
                     for it in items]).astype(np.float32)


def _similar(ctx, make_server, serve_thread, products, queries):
    server = make_server(ctx, host="127.0.0.1", port=0)
    serve_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        _call(base, "POST", "/api/controller/products/ingest", {"products": products})
        while _call(base, "POST", "/ai-api/serving/vectors/process-pending",
                    {})["processed_count"]:
            pass
        return [_call(base, "GET", f"/api/controller/similarity/{pid}?top_k=6")
                for pid in queries]
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("backend", ["int8", "ivf"])
def test_similarity_through_the_server_equals_the_jax_server(backend):
    products = _products(48)
    queries = [f"p{i}" for i in (0, 7, 19, 33, 47)]
    # every bucket probed: on unclustered rows k-means' assignments may sit
    # within a rounding of each other, and the two builds bucket them apart
    # (the build's parity is held on clustered data in tests/test_torch_ivf.py)
    jctx = JAPP.build_app_context(_serve_cfg(backend, JaxConfig, JaxServeConfig, nprobe=4),
                                  _random_vectorizer)
    tctx = TAPP.build_app_context(_serve_cfg(backend, nprobe=4), _random_vectorizer,
                                  device="cpu")
    want = _similar(jctx, JSRV.make_server, JSRV.serve_forever_in_thread, products, queries)
    got = _similar(tctx, TSRV.make_server, TSRV.serve_forever_in_thread, products, queries)
    for g, w in zip(got, want):
        assert g["query"] == w["query"] and len(g["results"]) == 6
        assert [r["product_id"] for r in g["results"]] == [r["product_id"] for r in w["results"]]
        np.testing.assert_allclose([r["score"] for r in g["results"]],
                                   [r["score"] for r in w["results"]], rtol=0, atol=1e-5)
