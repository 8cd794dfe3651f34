"""Deterministic synthetic LM data pipeline.

Produces next-token-prediction batches from a seeded generator with a
learnable structure (orderable: a k-gram Markov source), so small models
show real loss curves.  The iterator state (epoch/offset) is a tiny dict
that the checkpoint manager persists — restores resume mid-epoch exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int = 256
    seq_len: int = 128
    batch: int = 8
    seed: int = 0
    kgram: int = 2


class MarkovLMData:
    """Seeded k-gram Markov chain over the vocabulary; each process reads
    its own shard (host_id, num_hosts) of the batch dimension."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, num_hosts: int = 1):
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab
        # k-gram context: harder sources separate model capacities
        n_ctx = V ** max(1, cfg.kgram)
        # repro's exp(2 g) / sum(exp(2 g)), each step in place: the same
        # values in a third of the peak host memory
        trans = rng.gumbel(size=(n_ctx, V))
        trans *= 2.0
        np.exp(trans, out=trans)
        trans /= trans.sum(1, keepdims=True)
        self.trans = trans
        self.state = {"step": 0}

    def checkpoint_state(self) -> dict:
        return dict(self.state)

    def restore_state(self, state: dict):
        self.state = dict(state)

    def next_batch(self) -> dict:
        cfg = self.cfg
        # derive a per-(step, host) seed: deterministic, shardable
        seed = (self.state["step"] * self.num_hosts + self.host_id) % (2**31)
        rng = np.random.default_rng(seed + 1_000_003 * cfg.seed)
        B = cfg.batch // self.num_hosts
        k = max(1, cfg.kgram)
        V = cfg.vocab
        toks = np.empty((B, cfg.seq_len + k), dtype=np.int32)
        toks[:, :k] = rng.integers(0, V, size=(B, k))
        for t in range(k, cfg.seq_len + k):
            ctx = np.zeros(B, dtype=np.int64)
            for j in range(k):
                ctx = ctx * V + toks[:, t - k + j]
            p = self.trans[ctx]
            c = p.cumsum(axis=1)
            u = rng.random((B, 1))
            toks[:, t] = (u < c).argmax(axis=1)
        toks = toks[:, k - 1:]
        self.state["step"] += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
