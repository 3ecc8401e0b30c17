"""Token data pipeline with DyDD-balanced data-parallel sharding.

Documents have heavy-tailed lengths (real corpora do), so naive round-robin
assignment leaves data-parallel shards with unequal token counts — the LM
incarnation of the paper's "observations non uniformly distributed"
problem.  ``BalancedLoader`` treats per-shard token counts as DyDD loads on
the DP-axis ring graph and migrates whole documents between *neighbouring*
shards per the diffusion schedule before packing (DESIGN.md §4.1), so the
padding waste (= straggler work) is levelled every window.

Everything is deterministic given the seed (restart-safe: the loader state
is (seed, step) and is stored in checkpoints).

A copy of ``repro.data.pipeline`` (numpy) with the port's imports: the
same seed gives bitwise the same batches and stats, and either
package's ``state_dict`` restarts the other's loader.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

from repro_torch.core import balance as balance_mod
from repro_torch.core import dydd as dydd_mod


@dataclasses.dataclass(frozen=True)
class Document:
    doc_id: int
    tokens: np.ndarray      # (len,) int32


def synthetic_corpus(num_docs: int, vocab_size: int, seed: int = 0,
                     mean_len: int = 512, max_len: int = 4096):
    """Heavy-tailed (lognormal) document lengths; deterministic tokens."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.lognormal(np.log(mean_len), 0.8,
                                    num_docs).astype(np.int64),
                      16, max_len)
    docs = []
    for i, L in enumerate(lengths):
        toks = rng.integers(1, vocab_size, size=int(L), dtype=np.int64)
        docs.append(Document(doc_id=i, tokens=toks.astype(np.int32)))
    return docs


def pack_documents(docs: Sequence[Document], batch: int, seq: int,
                   bos: int = 0):
    """Greedy first-fit packing into (batch, seq) with BOS separators.

    Returns (tokens, labels, mask) int32/float32 arrays; mask zeroes the
    padding and each document's final position.
    """
    tokens = np.zeros((batch, seq), np.int32)
    mask = np.zeros((batch, seq), np.float32)
    fill = np.zeros(batch, np.int64)
    for doc in docs:
        L = min(len(doc.tokens), seq - 1)
        row = int(np.argmin(fill))
        if fill[row] + L + 1 > seq:
            continue        # window full: drop remainder (counted by caller)
        o = fill[row]
        tokens[row, o] = bos
        tokens[row, o + 1:o + 1 + L] = doc.tokens[:L]
        mask[row, o:o + L] = 1.0
        fill[row] += L + 1
    labels = np.zeros_like(tokens)
    labels[:, :-1] = tokens[:, 1:]
    return tokens, labels, mask


@dataclasses.dataclass
class LoaderStats:
    loads_before: np.ndarray
    loads_after: np.ndarray
    docs_moved: int
    efficiency_before: float
    efficiency_after: float


class BalancedLoader:
    """Deterministic, restart-safe loader with DyDD shard balancing.

    Each step window: draw ``window_docs`` fresh documents, hash-assign them
    to the ``dp`` shards (location-based initial DD), run the DyDD plan on
    the ring topology, migrate whole documents between adjacent shards, and
    pack per shard.
    """

    def __init__(self, vocab_size: int, dp: int, batch_per_shard: int,
                 seq: int, seed: int = 0, window_docs: int | None = None,
                 balance: bool = True, mean_len: int = 512):
        self.vocab_size = vocab_size
        self.dp = dp
        self.batch_per_shard = batch_per_shard
        self.seq = seq
        self.seed = seed
        self.balance = balance
        self.mean_len = mean_len
        self.window_docs = window_docs or dp * batch_per_shard * 4
        self.topo = balance_mod.Topology.ring(dp)
        self.step = 0
        self.last_stats: LoaderStats | None = None

    def state_dict(self):
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, st):
        self.seed = int(st["seed"])
        self.step = int(st["step"])

    def next_batch(self):
        """Returns (tokens, labels, mask) of shape (dp*batch_per_shard, seq)
        with rows grouped by shard (row r belongs to shard r // bps)."""
        docs = synthetic_corpus(self.window_docs, self.vocab_size,
                                seed=hash((self.seed, self.step)) % 2**31,
                                mean_len=self.mean_len,
                                max_len=self.seq - 1)
        self.step += 1

        # initial DD: documents land on shards by id hash (data location)
        shard_of = np.array([d.doc_id % self.dp for d in docs])
        loads = np.bincount(
            shard_of, weights=[len(d.tokens) for d in docs],
            minlength=self.dp).astype(np.int64)

        moved = 0
        if self.balance and self.dp > 1:
            plan = balance_mod.plan(loads, self.topo)
            # realize the plan with whole documents (greedy nearest-size)
            by_shard = {i: [d for d, s in zip(docs, shard_of) if s == i]
                        for i in range(self.dp)}
            for src, dst, amount in plan.moves:
                pool = sorted(by_shard[src], key=lambda d: len(d.tokens))
                sent = 0
                while pool and sent < amount:
                    # send the doc that best fits the remaining amount; stop
                    # if even the best choice overshoots by more than it
                    # helps (whole-document granularity).
                    rem = amount - sent
                    d = min(pool, key=lambda dd: abs(len(dd.tokens) - rem))
                    if len(d.tokens) > 2 * rem:
                        break
                    pool.remove(d)
                    by_shard[src].remove(d)
                    by_shard[dst].append(d)
                    sent += len(d.tokens)
                    moved += 1
            new_loads = np.array(
                [sum(len(d.tokens) for d in by_shard[i])
                 for i in range(self.dp)], np.int64)
        else:
            by_shard = {i: [d for d, s in zip(docs, shard_of) if s == i]
                        for i in range(self.dp)}
            new_loads = loads

        self.last_stats = LoaderStats(
            loads_before=loads, loads_after=new_loads, docs_moved=moved,
            efficiency_before=dydd_mod.balance_ratio(loads),
            efficiency_after=dydd_mod.balance_ratio(new_loads))

        toks, labs, masks = [], [], []
        for i in range(self.dp):
            t, l, m = pack_documents(by_shard[i], self.batch_per_shard,
                                     self.seq)
            toks.append(t)
            labs.append(l)
            masks.append(m)
        return (np.concatenate(toks), np.concatenate(labs),
                np.concatenate(masks))
