"""The partition and the merge of kernel K1's partial results, in numpy.

``csrc/diag_ce.cu`` cuts the R x R (owner block, streamed tile) pairs of a
call into G contiguous ranges, one block each (G = the SM count, at least R,
at most R x R). A range writes one partial result for each owner block it
spans (at most two: "slots"): the running max, sum and diagonal of its rows
(forward) or its partial dq / dk rows (backward). The combine phase finds the
ranges that reach an owner block and merges their partials in range order.
This file repeats the plan (block shapes by width, batch and kernel), the
partition, the combine's search and the merge as the source writes them,
with each partial computed in float32 from the masked logits, and holds the
merged loss, dq and dk against ``fused_diag_ce_reference`` in float64 at the
JAX suite's tolerances (loss 1e-4, gradients 1e-5; tests/test_pallas.py).
"""

import numpy as np
import pytest
import torch

from recsys_tpu_torch.ops.contrastive_kernel import fused_diag_ce_reference

LOSS_TOL, GRAD_TOL = 1e-4, 1e-5
SMS = 132      # NVIDIA H100 SXM
NEG = -3.0e4


def plan(B: int, D: int, sms: int = SMS) -> tuple[int, int, int]:
    """(rows of an owner block and of a streamed tile, R, G) as ``launch``
    and ``Layout`` of csrc/diag_ce.cu pick them: 32 past D = 128 (Wide) and
    below one 64-row pair an SM (Small), else 64 (Narrow, WgFwd)."""
    own = 32 if D > 128 or (-(-B // 64)) ** 2 < sms else 64
    R = -(-B // own)
    G = min(R * R, sms) if sms > R else R
    return own, R, G


def first(c: int, R: int, G: int) -> int:
    return c * R * R // G


def segments(c: int, R: int, G: int):
    """(slot, owner block, first tile, one past the last tile) as the
    products phase walks range c."""
    u, end, slot = first(c, R, G), first(c + 1, R, G), 0
    while u < end:
        r, t0 = divmod(u, R)
        t1 = min(R, t0 + end - u)
        yield slot, r, t0, t1
        u += t1 - t0
        slot += 1


def contributors(r: int, R: int, G: int) -> range:
    """The ranges that reach owner block r, found as the combine phase finds them."""
    lo, hi = r * R, r * R + R
    c0 = lo * G // (R * R)
    while c0 > 0 and first(c0, R, G) > lo:
        c0 -= 1
    while first(c0 + 1, R, G) <= lo:
        c0 += 1
    c1 = c0 + 1
    while c1 < G and first(c1, R, G) < hi:
        c1 += 1
    return range(c0, c1)


def slot_of(c: int, r: int, R: int, G: int) -> int:
    return 0 if first(c, R, G) // R == r else 1


@pytest.mark.parametrize("B,D,sms", [(1, 8, 132), (32, 128, 132), (192, 128, 132),
                                     (200, 256, 132), (704, 128, 132), (768, 128, 132),
                                     (3072, 128, 132), (4096, 128, 132), (8192, 128, 132),
                                     (8500, 128, 132), (3072, 128, 114), (333, 160, 7),
                                     (1000, 64, 1)])
def test_partition_covers_every_pair_once(B, D, sms):
    """Every (owner block, tile) pair is in exactly one range; a range spans
    one or two owner blocks; the combine finds exactly the ranges that wrote
    a partial of a block, in range order, each at the slot it was written to;
    the first of them is the only one that may reach it at slot 1."""
    _, R, G = plan(B, D, sms)
    assert R <= G <= R * R
    seen = np.zeros((R, R), dtype=np.int64)
    writers = {r: [] for r in range(R)}
    for c in range(G):
        segs = list(segments(c, R, G))
        assert 1 <= len(segs) <= 2
        for slot, r, t0, t1 in segs:
            assert t0 < t1
            seen[r, t0:t1] += 1
            writers[r].append((c, slot))
    assert (seen == 1).all()
    for r in range(R):
        found = [(c, slot_of(c, r, R, G)) for c in contributors(r, R, G)]
        assert found == writers[r]
        assert all(slot == 0 for _, slot in found[1:])
    sizes = [first(c + 1, R, G) - first(c, R, G) for c in range(G)]
    assert max(sizes) - min(sizes) <= 1             # the same work an SM, give or take a tile


def _problem(users: int, positions: int, D: int, seed: int):
    """Stage-2-like rows: user ids repeated, positive ids with collisions, and
    ~10% invalid columns."""
    rng = np.random.default_rng(seed)
    B = users * positions
    unit = lambda: (lambda x: x / np.linalg.norm(x, axis=1, keepdims=True))(
        rng.normal(size=(B, D)).astype(np.float32))
    q, k = unit(), unit()
    pos = (1 + (max(B // 2, 2) * rng.random(B) ** 3)).astype(np.int32)
    usr = np.repeat(np.arange(users), positions).astype(np.int32)
    valid = (rng.random(B) > 0.1).astype(np.int32)
    corr = rng.normal(-8.0, 1.0, B).astype(np.float32)
    return q, k, corr, pos, usr, valid


def _masked_logits(q, k, corr, pos, usr, valid, tau):
    logits = (q @ k.T) / np.float32(tau) - corr[None, :]
    forbid = ((pos[None, :] == pos[:, None]) | (usr[None, :] == usr[:, None])
              | (valid[None, :] == 0)) & ~np.eye(len(q), dtype=bool)
    return np.where(forbid, np.float32(NEG), logits).astype(np.float32), forbid


def merged(q, k, corr, pos, usr, valid, g, tau, sms=SMS):
    """loss, lse, dq, dk through the partials and the combine, in float32."""
    B, D = q.shape
    logits, forbid = _masked_logits(q, k, corr, pos, usr, valid, tau)
    own, R, G = plan(B, D, sms)
    span = lambda r, t0, t1: (np.arange(r * own, min((r + 1) * own, B)),
                              np.arange(t0 * own, min(t1 * own, B)))
    spans = {(c, slot): span(r, t0, t1) for c in range(G)
             for slot, r, t0, t1 in segments(c, R, G)}
    loss, lse = np.zeros(B, np.float32), np.zeros(B, np.float32)
    for r in range(R):
        m_all, s_all, d_all = [], [], []
        for c in contributors(r, R, G):
            i, j = spans[c, slot_of(c, r, R, G)]
            block = logits[np.ix_(i, j)]
            m = block.max(axis=1)
            m_all.append(m)
            s_all.append(np.exp(block - m[:, None]).sum(axis=1, dtype=np.float32))
            d_all.append(np.where(i[:, None] == j[None, :], block, 0).sum(axis=1,
                                                                          dtype=np.float32))
        m = np.max(m_all, axis=0)
        s, dg = np.zeros_like(m), np.zeros_like(m)
        for pm, ps, pd in zip(m_all, s_all, d_all):
            s += ps * np.exp(pm - m)
            dg += pd
        rows = np.arange(r * own, min((r + 1) * own, B))
        lse[rows] = m + np.log(s)
        loss[rows] = lse[rows] - dg
    dlogits = ((np.exp(logits - lse[:, None]) - np.eye(B, dtype=np.float32))
               * (g / np.float32(tau))[:, None])
    dlogits = np.where(forbid, 0, dlogits).astype(np.float32)
    dq, dk = np.zeros_like(q), np.zeros_like(k)
    for r in range(R):
        rows = np.arange(r * own, min((r + 1) * own, B))
        acc_q = np.zeros((len(rows), D), np.float32)
        acc_k = np.zeros((len(rows), D), np.float32)
        for c in contributors(r, R, G):
            # dq: owner rows x these key columns; dk: owner keys x these query rows
            i, j = spans[c, slot_of(c, r, R, G)]
            acc_q += dlogits[np.ix_(i, j)] @ k[j]
            acc_k += dlogits[np.ix_(j, i)].T @ q[j]
        dq[rows], dk[rows] = acc_q, acc_k
    return loss, lse, dq, dk


@pytest.mark.parametrize("users,positions,D,sms", [(16, 2, 128, SMS), (100, 2, 128, SMS),
                                                   (768, 4, 128, SMS), (111, 3, 160, SMS),
                                                   (768, 4, 128, 114)],
                         ids=["B32", "B200", "B3072", "B333-wide", "B3072-114sms"])
def test_merged_partials_match_the_reference(users, positions, D, sms):
    q, k, corr, pos, usr, valid = _problem(users, positions, D, users * positions + D)
    B, tau = len(q), 0.1
    g = (valid / max(valid.sum(), 1)).astype(np.float32)    # the mean loss's gradient
    loss, lse, dq, dk = merged(q, k, corr, pos, usr, valid, g, tau, sms)
    t = lambda a: torch.as_tensor(a)
    a = t(q).double().requires_grad_(True)
    b = t(k).double().requires_grad_(True)
    ref = fused_diag_ce_reference(a, b, t(corr).double(), t(pos), t(usr), t(valid), tau)
    ga, gb = torch.autograd.grad((ref * t(g).double()).sum(), (a, b))
    assert np.abs(loss - ref.detach().numpy()).max() <= LOSS_TOL
    assert np.abs(dq - ga.numpy()).max() <= GRAD_TOL
    assert np.abs(dk - gb.numpy()).max() <= GRAD_TOL
    assert np.isfinite(lse).all()
    _, R, G = plan(B, D, sms)
    if B > 64:        # the merge is real: some owner block has partials of several ranges
        assert max(len(contributors(r, R, G)) for r in range(R)) >= 2
