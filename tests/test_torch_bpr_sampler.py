"""The LightGCL trainer's negative sampler against the JAX package's.

The port probes, in each rejection round, only the negatives the round
before drew again; the JAX loop probes the whole batch every round. Both
must draw the same batches from the same seed. A dense graph (each user on
three quarters of the items) makes most draws land on an edge, so a batch
takes many rounds and some rows reach the ten-round cap with a negative that
is still an edge; a sparse one takes one or two rounds.
"""

import numpy as np
import pytest

import recsys_tpu.train.gnn as JG
import recsys_tpu_torch.train.gnn as TG


def _graph(users: int, items: int, per_user: int, seed: int):
    rng = np.random.default_rng(seed)
    u = np.repeat(np.arange(users), per_user)
    i = np.concatenate([rng.choice(items, per_user, replace=False) for _ in range(users)])
    return u.astype(np.int32), i.astype(np.int32)


@pytest.mark.parametrize("users,items,per_user,batch,capped",
                         [(50, 20, 15, 64, True), (300, 400, 6, 128, False)],
                         ids=["dense", "sparse"])
def test_the_batches_are_the_jax_samplers(users, items, per_user, batch, capped):
    u, i = _graph(users, items, per_user, seed=users)
    got = list(TG.sample_bpr_batches(u, i, items, batch, np.random.default_rng(7)))
    ref = list(JG.sample_bpr_batches(u, i, items, batch, np.random.default_rng(7)))
    assert len(got) == len(ref) == len(u) // batch
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, b)
    keys = TG.edge_key_index(u, i, items)
    still = [TG._in_edges(keys, users_, neg, items).sum() for users_, _, neg in got]
    # the dense graph's batches reach the cap; the sparse graph's never do
    assert (sum(still) > 0) == capped
