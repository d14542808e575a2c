"""Corpus-pretrained token embeddings (PPMI-SVD) for the text encoder.

Counterpart of ``recsys_tpu/data/text_pretrain.py``, host numpy / scipy code
with the same arithmetic, so both packages write the same artifact from the
same item tensors. "Pretrained" is the count-based recipe behind static word
vectors (SVD of the PPMI matrix, Levy & Goldberg 2014): the whole catalog
corpus (names and every RE field value, in the tokenizer's hash space) ->
within-item token co-occurrence -> positive PMI -> randomized SVD
(``ops/graph._randomized_svd``, the GNN's global view) -> a (V, d) matrix
that ``models/text_encoder.PretrainedTextEncoder`` holds frozen under a
trainable projection. Unsupervised over the catalog only: no interaction
label leaks into stage 1.

The ``.npz`` artifact (``embeddings`` (V, d) float32, ``meta`` [V, d] int64)
is the JAX package's format: either package reads the other's.
"""

from __future__ import annotations

import hashlib

import numpy as np

from recsys_tpu_torch.ops.graph import _randomized_svd


def item_token_bags(tensors: dict) -> "scipy.sparse.csr_matrix":
    """(N_items, V) binary incidence from the tokenized item tensors
    (re_ids/re_mask + txt_ids/txt_mask): one deduplicated bag per item, from
    the very tensors the tower trains on."""
    from scipy import sparse

    n = tensors["txt_ids"].shape[0]
    re_ids = tensors["re_ids"].reshape(n, -1)
    re_mask = tensors["re_mask"].reshape(n, -1)
    ids = np.concatenate([re_ids, tensors["txt_ids"]], axis=1)
    mask = np.concatenate([re_mask, tensors["txt_mask"]], axis=1) > 0
    rows = np.repeat(np.arange(n), mask.sum(axis=1))
    cols = ids[mask]
    V = int(ids.max()) + 1
    inc = sparse.csr_matrix(
        (np.ones(len(cols), np.float32), (rows, cols)), shape=(n, V))
    inc.data[:] = 1.0  # dedupe: count each token once per item
    inc.sum_duplicates()
    inc.data[:] = 1.0
    return inc


def ppmi(cooc: "scipy.sparse.csr_matrix", shift: float = 0.0):
    """Positive pointwise mutual information on the nonzeros of a sparse
    co-occurrence matrix: max(0, log(C_ij * total / (r_i * c_j)) - shift)."""
    c = cooc.tocoo()
    row_sum = np.asarray(cooc.sum(axis=1)).ravel()
    col_sum = np.asarray(cooc.sum(axis=0)).ravel()
    total = float(c.data.sum())
    with np.errstate(divide="ignore"):
        pmi = np.log(c.data * total
                     / (row_sum[c.row] * col_sum[c.col] + 1e-12) + 1e-12)
    c.data = np.maximum(pmi - shift, 0.0).astype(np.float32)
    c.eliminate_zeros()
    return c.tocsr()


def ppmi_matrix(tensors: dict, vocab_size: int) -> "scipy.sparse.csr_matrix":
    """The SVD's input: co-occurrence = incidenceᵀ @ incidence over the
    within-item bags, diagonal removed, PPMI; (vocab_size, vocab_size)."""
    from scipy import sparse

    inc = item_token_bags(tensors)
    if inc.shape[1] < vocab_size:  # tokens never hashed into the top buckets
        inc = sparse.csr_matrix(
            (inc.data, inc.indices, inc.indptr), shape=(inc.shape[0], vocab_size))
    cooc = (inc.T @ inc).tocsr()
    cooc.setdiag(0)
    cooc.eliminate_zeros()
    return ppmi(cooc)


def pretrain_embeddings(tensors: dict, vocab_size: int, dim: int = 128,
                        seed: int = 0, svd_iters: int = 4) -> np.ndarray:
    """Item tensors -> (vocab_size, dim) float32 embedding matrix.

    ``ppmi_matrix``, randomized SVD, U * sqrt(S) scaling, L2-normalized rows.
    Row 0 (PAD) and never-seen buckets stay zero.

    The SVD's QR runs on the subspace iteration's output, whose condition
    number is about (s_1 / s_q)^(2 * svd_iters + 1) (~1e13 for the 5,000-item
    A/B world's table), so the weaker columns, and the rows that lie mostly
    in them, follow the rounding of the LAPACK build: two builds give
    different tables from the same bits of ``ppmi_matrix``."""
    m = ppmi_matrix(tensors, vocab_size)
    rng = np.random.default_rng(seed)
    u, s, _ = _randomized_svd(lambda x: m @ x, lambda x: m.T @ x,
                              vocab_size, vocab_size, dim, svd_iters, rng)
    emb = (u * np.sqrt(np.maximum(s, 0.0))[None, :]).astype(np.float32)
    norms = np.linalg.norm(emb, axis=1, keepdims=True)
    emb = np.where(norms > 1e-8, emb / np.maximum(norms, 1e-8), 0.0)
    emb[0] = 0.0  # PAD
    return emb.astype(np.float32)


def save_text_pretrain(path: str, emb: np.ndarray) -> None:
    np.savez_compressed(path if path.endswith(".npz") else path + ".npz",
                        embeddings=emb,
                        meta=np.array([emb.shape[0], emb.shape[1]], np.int64))


def load_text_pretrain(path: str) -> np.ndarray:
    p = path if path.endswith(".npz") else path + ".npz"
    with np.load(p) as z:
        return z["embeddings"].astype(np.float32)


def ppmi_checksum(m: "scipy.sparse.csr_matrix") -> dict:
    """The SVD's input as a run prints it to hold it against another
    package's or machine's: its nonzeros and the sha256 of its CSR arrays
    (int64 indices, float32 values)."""
    m = m.tocsr()
    h = hashlib.sha256()
    for a in (m.indptr.astype(np.int64), m.indices.astype(np.int64), m.data.astype(np.float32)):
        h.update(np.ascontiguousarray(a).tobytes())
    return {"nnz": int(m.nnz), "sha256": h.hexdigest()}


def table_checksum(emb: np.ndarray) -> dict:
    """What a run prints of a table: its shape, nonzero rows, the sha256 of
    its float32 bytes and the float64 sum of its absolute values (the last
    two follow the LAPACK build; see ``pretrain_embeddings``)."""
    emb = np.ascontiguousarray(emb, np.float32)
    return {"shape": list(emb.shape),
            "nonzero_rows": int((np.abs(emb).sum(axis=1) > 0).sum()),
            "sha256": hashlib.sha256(emb.tobytes()).hexdigest(),
            "abs_sum": float(np.abs(emb.astype(np.float64)).sum())}
