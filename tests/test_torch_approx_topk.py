"""The approximate top-k (``ops/approx_topk.py``) against ``jax.lax.approx_max_k``.

The JAX package calls ``jax.lax.approx_max_k`` in ``eval/recall.topk_scores``
and ``ops/quant.int8_topk`` (``method="approx"``). On the CPU, XLA returns
the exact top-k; what the TPU returns is held by its shapes and its contract:

* the bin count equals the reduction size ``jax.eval_shape`` gives for
  ``aggregate_to_topk=False``, at every point of a grid that holds
  bench_retrieval.py's four catalogs, k = 1 and r = 1.0; both refuse the
  same arguments;
* where every column is a bin (O = n) the port's approximate top-k is JAX's
  answer: the ids equal, ties included (duplicate rows), the values within
  1e-6 (the two products sum in other orders; int8: alpha times the same
  integer, as ``tests/test_torch_quant.py``);
* at n = 20,001, k = 50, r = 0.95 (1,280 bins of 16 items) the plain form
  returns the exact score of each id, each id is its bin's maximum and the
  lowest column on ties, rows are sorted, and the recall against JAX's exact
  ``top_k`` is at least 0.95;
* the int8 kernel's integer epilogue (packed (sum, slice) keys, dequantized
  at the end) and the merge of split slices, written out in torch, equal the
  plain forms' bins bit for bit at the edges of the keys' premise;
* on a mesh whose model axis is > 1 both packages ignore the method;
* a CUDA tensor never takes the plain form: with the kernel's build failing,
  the call raises.

The kernels themselves are held against the plain forms on the card
(``tests/test_torch_kernel_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.eval.recall import topk_scores as jax_topk_scores
from recsys_tpu.ops import quant as JQ
from recsys_tpu_torch.config import MeshConfig
from recsys_tpu_torch.eval import recall as TR
from recsys_tpu_torch.ops import _build
from recsys_tpu_torch.ops import approx_topk as A
from recsys_tpu_torch.ops import quant as TQ
from recsys_tpu_torch.parallel.mesh import build_mesh

# bench_retrieval.py's catalogs (items + the PAD row), k, and the bins at r = 0.95
CATALOGS = [(47_001, 500, 11_776), (47_001, 50, 1_536), (105_001, 500, 13_184),
            (1_000_001, 100, 2_048)]
TARGETS = (0.5, 0.8, 0.9, 0.95, 0.99, 0.999, 1.0)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_bins(n: int, k: int, r: float) -> int:
    out = jax.eval_shape(
        lambda x: jax.lax.approx_max_k(x, k, recall_target=r, aggregate_to_topk=False),
        jax.ShapeDtypeStruct((2, n), jnp.float32))
    return out[0].shape[1]


def _catalog(seed: int, n: int, d: int = 16, dups: int = 20, B: int = 12):
    """(n, d) items with PAD row 0 zero and `dups` rows repeated further down
    (exact ties), and B queries, the first few equal to catalog rows."""
    rng = np.random.default_rng(seed)
    items = rng.normal(size=(n, d)).astype(np.float32)
    items[0] = 0
    items[n - dups:] = items[1:dups + 1]
    u = rng.normal(size=(B, d)).astype(np.float32)
    u[:3] = items[[1, 2, n - 1]]
    prior = (rng.random(n) * 0.5).astype(np.float32)
    return items, u, prior


# -- the bin count ------------------------------------------------------------------

@pytest.mark.parametrize("n", [3, 128, 129, 257, 1000, 2001, 20_001, 47_001, 105_001,
                               300_007, 1_000_001])
def test_bins_are_xlas_reduction_size(n):
    for k in (1, 2, 10, 50, 100, 500):
        if k > n:
            continue
        for r in TARGETS:
            bins, red = A.approx_bins(n, k, r)
            assert bins == _jax_bins(n, k, r), (n, k, r)
            # the fewest slices of `bins` lanes that hold the row
            assert bins << red >= n and (red == 0 or bins << (red - 1) < n), (n, k, r)


@pytest.mark.parametrize("n,k,bins", CATALOGS)
def test_bins_at_bench_retrievals_catalogs(n, k, bins):
    assert A.approx_bins(n, k, 0.95)[0] == bins == _jax_bins(n, k, 0.95)


@pytest.mark.parametrize("n,k,r", [(10, 11, 0.95), (500, 501, 0.95), (10, 0, 0.95),
                                   (200, 5, 0.0), (200, 5, -0.5), (200, 5, 1.5)])
def test_bins_refuse_what_jax_refuses(n, k, r):
    with pytest.raises(ValueError):
        A.approx_bins(n, k, r)
    with pytest.raises(Exception):
        _jax_bins(n, k, r)


# -- O = n: JAX's answer ---------------------------------------------------------------

# every column is a bin at these (n, k, r)
EVERY_COLUMN = [(100, 10, 0.95), (2001, 50, 1.0), (300, 60, 0.9)]


@pytest.mark.parametrize("normalize", [True, False], ids=["cos", "dot"])
@pytest.mark.parametrize("with_prior", [False, True], ids=["no_prior", "prior"])
@pytest.mark.parametrize("n,k,r", EVERY_COLUMN)
def test_fp32_where_every_column_is_a_bin_is_jaxs(n, k, r, with_prior, normalize):
    assert A.approx_bins(n, k, r) == (n, 0)
    items, u, prior = _catalog(n + k, n)
    jp = jnp.asarray(prior) if with_prior else None
    tp = torch.as_tensor(prior) if with_prior else None
    jv, ji = jax_topk_scores(jnp.asarray(u), jnp.asarray(items), k, normalize_items=normalize,
                             prior=jp, method="approx", recall_target=r)
    tv, ti = TR.topk_scores(torch.as_tensor(u), torch.as_tensor(items), k,
                            normalize_items=normalize, prior=tp, method="approx",
                            recall_target=r)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)
    assert ti.dtype == torch.int64 and int(ti.min()) >= 1
    # and the port's exact path, on the same scores
    ev, ei = TR.topk_scores(torch.as_tensor(u), torch.as_tensor(items), k,
                            normalize_items=normalize, prior=tp)
    assert torch.equal(ti, ei) and torch.equal(tv, ev)


@pytest.mark.parametrize("d", [32, 600], ids=["d32", "d600_float_key"])
@pytest.mark.parametrize("n,k,r", EVERY_COLUMN)
def test_int8_where_every_column_is_a_bin_is_jaxs(n, k, r, d):
    """The bins are taken of the dequantized scores at every width; d = 600
    is past the width where the int32 sums order as those scores do."""
    items, u, _ = _catalog(n + d, n, d=d)
    jv, ji = JQ.int8_topk(u, JQ.quantize_items_int8(items), k, method="approx",
                          recall_target=r)
    tv, ti = TQ.int8_topk(u, TQ.quantize_items_int8(items, device="cpu"), k,
                          method="approx", recall_target=r)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)


# -- the TPU's contract where bins hold many columns --------------------------------------

def _bin_checks(scores: torch.Tensor, vals, ids, bins: int):
    """Each value is its id's score, each id its bin's maximum and the lowest
    column holding it, each row sorted (equal values lowest id first)."""
    n = scores.shape[1]
    assert torch.equal(vals, scores.gather(1, ids))
    for r in range(ids.shape[0]):
        for c in ids[r].tolist():
            members = torch.arange(c % bins, n, bins)
            best = scores[r, members].max()
            assert scores[r, c] == best
            assert c == int(members[scores[r, members] == best].min())
    assert bool((vals[:, :-1] >= vals[:, 1:]).all())
    tied = vals[:, :-1] == vals[:, 1:]
    assert bool((ids[:, :-1][tied] < ids[:, 1:][tied]).all())


def test_plain_form_at_20001_items_keeps_the_tpus_contract():
    n, k, r = 20_001, 50, 0.95
    bins, red = A.approx_bins(n, k, r)
    assert (bins, red) == (1280, 4) and -(-n // bins) == 16
    items, u, prior = _catalog(5, n, d=32, B=16)
    items[1 + 3 * bins] = items[1 + bins]          # a tie inside bin 1
    prior[1 + 3 * bins] = prior[1 + bins]
    u[3] = items[1 + bins]
    tu, ti = torch.as_tensor(u), torch.as_tensor(items)
    for tp in (None, torch.as_tensor(prior)):
        vals, ids = TR.topk_scores(tu, ti, k, prior=tp, method="approx", recall_target=r)
        unit = ti / torch.linalg.norm(ti, dim=-1, keepdim=True).clamp(min=1e-12)
        scores = tu @ unit.T + (0 if tp is None else tp[None, :])
        scores[:, 0] = -torch.inf
        _bin_checks(scores, vals, ids, bins)
        assert 1 + bins in ids[3].tolist() and 1 + 3 * bins not in ids[3].tolist()
        _, ji = jax_topk_scores(jnp.asarray(u), jnp.asarray(items), k,
                                prior=None if tp is None else jnp.asarray(prior))
        ji = np.asarray(ji)
        recall = np.mean([len(set(ids[row].tolist()) & set(ji[row].tolist())) / k
                          for row in range(len(ji))])
        assert recall >= r, recall


def test_int8_plain_form_keeps_the_contract_on_the_sums():
    """Below 2^23 the dequantized scores order as the int32 sums: the bins of
    the one are the bins of the other, and the values alpha times the sums."""
    n, k = 20_001, 50
    bins, _ = A.approx_bins(n, k, 0.95)
    items, u, _ = _catalog(6, n, d=32, B=8)
    qi = TQ.quantize_items_int8(items, device="cpu")
    vals, ids = TQ.int8_topk(u, qi, k, method="approx")
    uq, alpha = TQ._quantize_queries(torch.as_tensor(u), qi.col_scale)
    acc = TQ.int8_accumulate(uq, qi)
    acc[:, 0] = torch.iinfo(torch.int32).min
    top = acc.gather(1, ids)
    _bin_checks(acc, top, ids, bins)
    assert torch.equal(vals, top.float() * alpha)
    ev, ei = TQ.int8_topk(u, qi, k)
    recall = np.mean([len(set(ids[r].tolist()) & set(ei[r].tolist())) / k
                      for r in range(len(ei))])
    assert recall >= 0.95, recall


# -- the int8 kernel's integer epilogue and the merge of split slices ------------------

def _int_key_shift(D: int) -> int:
    """``int_key_shift`` of csrc/approx_topk.cu: the slice bits that fit beside
    |sum| <= D * 128^2 in a 31-bit key, 0 where |sum| could reach 2^23."""
    maxabs = D * 128 * 128
    if maxabs >= 1 << 23:
        return 0
    shift = 0
    while (maxabs + 1) << (shift + 1) <= 1 << 31:
        shift += 1
    return shift


def _int8_bins_by_keys(uq, q, alpha, bins, red, parts):
    """The int8 kernel's arithmetic: each part of the slices keeps, per bin,
    the max of the packed keys sum * 2^s + (2^s - 1 - slice) (INT32_MIN for
    the PAD column and columns past n), unpacked and dequantized at the end as
    float(sum) * alpha; the parts merged in order, strictly greater winning."""
    n, B = q.shape[0], uq.shape[0]
    shift = _int_key_shift(uq.shape[1])
    assert shift > 0
    acc = (uq.double() @ q.double().T).long()
    S = -(-n // bins)
    none = torch.iinfo(torch.int32).min
    full = torch.full((B, S * bins), none, dtype=torch.long)
    full[:, :n] = acc
    full[:, 0] = none
    L = -(-S // parts)
    vals = cols = None
    for p in range(-(-S // L)):
        t = torch.arange(p * L, min(S, (p + 1) * L))
        sums = full.view(B, S, bins)[:, t]
        keys = sums * (1 << shift) + ((1 << shift) - 1 - (t - p * L))[None, :, None]
        keys = torch.where(sums == none, none, keys)
        assert int(keys.max()) < 2**31 and int(keys[sums != none].min()) > none
        kmax = keys.max(dim=1).values
        empty = kmax == none
        v = torch.where(empty, -torch.inf, (kmax >> shift).float() * alpha[:, None])
        tl = torch.where(empty, 0, (1 << shift) - 1 - (kmax & ((1 << shift) - 1)))
        c = ((p * L + tl) * bins + torch.arange(bins)).int()
        if vals is None:
            vals, cols = v, c
        else:
            take = v > vals
            vals, cols = torch.where(take, v, vals), torch.where(take, c, cols)
    return vals, cols


def test_int_key_shift_is_the_kernels():
    assert [_int_key_shift(D) for D in (16, 128, 511, 512, 520)] == [12, 9, 8, 0, 0]


@pytest.mark.parametrize("D,value", [(128, 127), (128, 128), (511, 128)])
@pytest.mark.parametrize("parts", [1, 2, 3])
def test_int8_integer_keys_equal_the_plain_bins(D, value, parts):
    """At the edges of the keys' premise the kernel's integer epilogue gives
    ``approx_scan_int8_plain``'s bins bit for bit: sums at +-D * value^2
    (value 128: the int8 -128 times itself), equal sums in many slices, alpha
    1e-12 and 1e3, parts merged in order."""
    rng = np.random.default_rng(D + value + parts)
    n, bins, red = 1_500, 128, 4
    q = rng.integers(-127, 128, (n, D)).astype(np.int64)
    q[rng.random(n) < 0.3] = value            # the largest sum ...
    q[rng.random(n) < 0.2] = -value           # ... and the smallest, in many slices
    uq = rng.integers(-127, 128, (6, D)).astype(np.int64)
    uq[0], uq[1], uq[2] = value, -value, 1
    to8 = lambda a: torch.as_tensor(np.clip(a, -128, 127).astype(np.int8))  # noqa: E731
    uq, q = to8(uq), to8(q)
    if value == 128:
        uq[1], q[q[:, 0] == 127] = -128, -128
    alpha = torch.tensor([1e-12, 1e3, 0.5, 1e-12, 1e3, 7.0], dtype=torch.float32)
    sums = uq.long() @ q.long().T
    assert int(sums.abs().max()) == D * value**2 < 2**23
    got = _int8_bins_by_keys(uq, q, alpha, bins, red, parts)
    want = A.approx_scan_int8_plain(uq, q, alpha, bins, red)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_int8_sum_bins_hold_below_2_23_at_520():
    """At D = 520 and |int8| <= 127 the sums stay below 2^23 and their bins,
    dequantized, are the plain form's; the kernel keeps the dequantized
    scores there all the same (an int8 of -128 takes the sums past 2^23)."""
    rng = np.random.default_rng(520)
    n, D, bins, red = 1_000, 520, 128, 3
    q = rng.integers(-127, 128, (n, D)).astype(np.int8)
    q[::7] = 127
    q[3::11] = -127
    uq = rng.integers(-127, 128, (5, D)).astype(np.int8)
    uq[0], uq[1] = 127, -127
    uq, q = torch.as_tensor(uq), torch.as_tensor(q)
    alpha = torch.tensor([1e-12, 1e3, 0.25, 3.0, 1e-12], dtype=torch.float32)
    sums = uq.double() @ q.double().T
    assert float(sums.abs().max()) == D * 127**2 < 2**23 <= D * 128**2
    sums[:, 0] = -torch.inf
    sv, sc = A.bin_max_plain(sums, bins, red)
    pv, pc = A.approx_scan_int8_plain(uq, q, alpha, bins, red)
    assert torch.equal(sc, pc) and torch.equal(sv.float() * alpha[:, None], pv)
    assert _int_key_shift(D) == 0


@pytest.mark.parametrize("parts", [2, 3, 4])
def test_split_slices_merge_to_bin_max_plain(parts):
    """The kernels' split: each part's bins over its own slices, merged in part
    order with the later part winning only when strictly greater, are
    ``bin_max_plain``'s bins, ties across parts included."""
    rng = np.random.default_rng(parts)
    n, bins, red = 3_001, 128, 5
    scores = torch.as_tensor(rng.integers(-20, 20, (7, n)).astype(np.float32))  # many ties
    scores[:, 0] = -torch.inf
    S = -(-n // bins)
    L = -(-S // parts)
    col_slice = torch.arange(n) // bins
    vals = cols = None
    for p in range(-(-S // L)):
        part = torch.where((col_slice >= p * L) & (col_slice < (p + 1) * L), scores, -torch.inf)
        v, c = A.bin_max_plain(part, bins, red)
        if vals is None:
            vals, cols = v, c
        else:
            take = v > vals
            vals, cols = torch.where(take, v, vals), torch.where(take, c, cols)
    want = A.bin_max_plain(scores, bins, red)
    assert torch.equal(vals, want[0]) and torch.equal(cols, want[1])


def test_k_beyond_the_bins_is_refused():
    # a low target leaves 256 bins at 1M columns; k = 500 cannot come from them
    assert A.approx_bins(1_000_001, 500, 0.1)[0] == 256
    with pytest.raises(ValueError, match="bins"):
        A.approx_topk_f32(torch.ones((1, 1)), torch.ones((1_000_001, 1)), None, 500, 0.1)


# -- the mesh: the method is ignored ---------------------------------------------------

def test_on_a_mesh_both_packages_ignore_the_method(mesh8):
    items, u, prior = _catalog(7, 1024, dups=0)
    k = 50
    assert A.approx_bins(1024, k, 0.5)[0] < 1024
    jv, ji = jax_topk_scores(jnp.asarray(u), jnp.asarray(items), k, mesh=mesh8,
                             prior=jnp.asarray(prior), method="approx", recall_target=0.5)
    mesh = build_mesh(MeshConfig(num_data=4, num_model=2), ["cpu"] * 8)
    tv, ti = TR.topk_scores(torch.as_tensor(u), torch.as_tensor(items), k, mesh=mesh,
                            prior=torch.as_tensor(prior), method="approx", recall_target=0.5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)
    ev, ei = TR.topk_scores(torch.as_tensor(u), torch.as_tensor(items), k, mesh=mesh,
                            prior=torch.as_tensor(prior))
    assert torch.equal(ti, ei) and torch.equal(tv, ev)


# -- dispatch: a CUDA tensor launches the kernel or raises ----------------------------------

class _ClaimsCuda(torch.Tensor):
    """A CPU tensor that says it lies on the card (ops on it keep the class)."""

    @property
    def is_cuda(self):
        return True


def _claims_cuda(t: torch.Tensor) -> torch.Tensor:
    return torch.Tensor._make_subclass(_ClaimsCuda, t)


def test_a_cuda_tensor_whose_kernel_does_not_build_raises(monkeypatch):
    def no_build(source):
        raise RuntimeError(f"nvcc failed to build {source}")

    def plain(*a, **k):
        raise AssertionError("the plain form ran for a CUDA tensor")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(A.LIBRARY, "_lib", None)
    monkeypatch.setattr(A, "approx_scan_f32_plain", plain)
    monkeypatch.setattr(A, "approx_scan_int8_plain", plain)
    A.reset_launch_counts()
    items, u, prior = _catalog(8, 2001)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        TR.topk_scores(_claims_cuda(torch.as_tensor(u)), _claims_cuda(torch.as_tensor(items)),
                       10, prior=_claims_cuda(torch.as_tensor(prior)), method="approx")
    qi = TQ.quantize_items_int8(items, device="cpu")
    qi.q, qi.col_scale = _claims_cuda(qi.q), _claims_cuda(qi.col_scale)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        TQ.int8_topk(u, qi, 10, method="approx")
    assert A.LAUNCHES == {"approx_scan_f32": 0, "approx_scan_int8": 0}


def test_the_wrappers_refuse_cpu_tensors_and_the_plain_path_counts_nothing():
    items, u, _ = _catalog(9, 300)
    ti, tu = torch.as_tensor(items), torch.as_tensor(u)
    with pytest.raises(RuntimeError, match="CUDA"):
        A.approx_scan_f32_cuda(tu, ti, None, 128, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        A.approx_scan_int8_cuda(tu.to(torch.int8), ti.to(torch.int8), torch.ones(len(u)), 128, 2)
    A.reset_launch_counts()
    TR.topk_scores(tu, ti, 10, method="approx")
    TQ.int8_topk(u, TQ.quantize_items_int8(items, device="cpu"), 10, method="approx")
    assert A.LAUNCHES == {"approx_scan_f32": 0, "approx_scan_int8": 0}
    with pytest.raises(ValueError, match="method"):
        TR.topk_scores(tu, ti, 10, method="approximate")
