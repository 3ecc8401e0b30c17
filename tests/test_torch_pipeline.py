"""The port's DyDD-balanced token loader against the JAX package's
(``repro.data.pipeline``, ``repro.core.balance``,
``repro.core.dydd.incidence_matrix``): all numpy on both sides, so every
result must be bitwise equal, batches, ``LoaderStats``, move plans and
the ``state_dict`` restart (either package's state restarts the other's
loader on the same next batch).
"""
import dataclasses

import numpy as np
import pytest

from repro.core import balance as jbalance  # noqa: E402
from repro.core import dydd as jdydd  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro_torch.core import balance as tbalance  # noqa: E402
from repro_torch.core import dydd as tdydd  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402

TOPOLOGIES = [("ring", (5,)), ("chain", (4,)), ("torus2d", (2, 3)),
              ("ring", (1,))]


def _equal_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _equal_stats(a, b):
    for f in dataclasses.fields(jpipe.LoaderStats):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("kind,args", TOPOLOGIES)
def test_topology_matches_reference(kind, args):
    t = getattr(tbalance.Topology, kind)(*args)
    j = getattr(jbalance.Topology, kind)(*args)
    assert t.p == j.p and t.edges == j.edges
    np.testing.assert_array_equal(t.pinvL, j.pinvL)
    np.testing.assert_array_equal(t.incidence, j.incidence)
    for i in range(t.p):
        assert t.neighbours(i) == j.neighbours(i)


@pytest.mark.parametrize("p,edges", [(4, [(0, 1), (1, 2), (2, 3)]),
                                     (3, [(0, 1), (1, 2), (2, 0)]),
                                     (5, [(0, 4), (3, 1)])])
def test_incidence_matrix_matches_reference(p, edges):
    got = tdydd.incidence_matrix(p, edges)
    want = jdydd.incidence_matrix(p, edges)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_plan_matches_reference(seed):
    rng = np.random.default_rng(seed)
    loads = rng.integers(0, 5000, size=6)
    t = tbalance.plan(loads, tbalance.Topology.ring(6))
    j = jbalance.plan(loads, jbalance.Topology.ring(6))
    assert t.moves == j.moves and t.total_moved == j.total_moved
    np.testing.assert_array_equal(t.loads_before, j.loads_before)
    np.testing.assert_array_equal(t.loads_after, j.loads_after)
    assert t.efficiency == j.efficiency


@pytest.mark.parametrize("seed,mean_len", [(0, 512), (3, 40)])
def test_synthetic_corpus_and_packing_match_reference(seed, mean_len):
    t_docs = tpipe.synthetic_corpus(40, 1000, seed=seed, mean_len=mean_len,
                                    max_len=300)
    j_docs = jpipe.synthetic_corpus(40, 1000, seed=seed, mean_len=mean_len,
                                    max_len=300)
    assert [d.doc_id for d in t_docs] == [d.doc_id for d in j_docs]
    for a, b in zip(t_docs, j_docs):
        assert a.tokens.dtype == b.tokens.dtype
        np.testing.assert_array_equal(a.tokens, b.tokens)
    _equal_batches(tpipe.pack_documents(t_docs, 6, 128),
                   jpipe.pack_documents(j_docs, 6, 128))


@pytest.mark.parametrize("dp,bps,seq,balance,mean_len",
                         [(4, 2, 64, True, 512), (3, 2, 96, True, 40),
                          (4, 1, 64, False, 40), (1, 3, 32, True, 40)])
def test_balanced_loader_matches_reference(dp, bps, seq, balance, mean_len):
    kw = dict(vocab_size=500, dp=dp, batch_per_shard=bps, seq=seq, seed=5,
              balance=balance, mean_len=mean_len)
    t, j = tpipe.BalancedLoader(**kw), jpipe.BalancedLoader(**kw)
    moved = 0
    for _ in range(4):
        _equal_batches(t.next_batch(), j.next_batch())
        _equal_stats(t.last_stats, j.last_stats)
        moved += t.last_stats.docs_moved
    assert t.state_dict() == j.state_dict()
    if balance and dp > 1 and mean_len == 40:
        assert moved > 0   # the DyDD plan moved documents


def test_loader_state_restarts_across_packages():
    kw = dict(vocab_size=300, dp=3, batch_per_shard=2, seq=64, seed=11,
              mean_len=40)
    t, j = tpipe.BalancedLoader(**kw), jpipe.BalancedLoader(**kw)
    for _ in range(3):
        t.next_batch()
        j.next_batch()
    # the port resumes the reference's state, and the reference the port's
    t2 = tpipe.BalancedLoader(**dict(kw, seed=0))
    t2.load_state_dict(j.state_dict())
    j2 = jpipe.BalancedLoader(**dict(kw, seed=0))
    j2.load_state_dict(t.state_dict())
    want = j.next_batch()
    _equal_batches(t2.next_batch(), want)
    _equal_batches(j2.next_batch(), want)
    _equal_batches(t.next_batch(), want)
