"""Deterministic, shardable, checkpointable synthetic token pipeline (the
port's copy of ``repro.data.synthetic``, numpy only, same batches).

Serves as the data substrate everywhere real corpora would go (offline
container): a counter-based PRNG stream (stateless — any (step, shard) batch
is reproducible from the seed alone), which is exactly the property needed for
elastic restarts and straggler substitution: a restarted or re-sharded run
regenerates identical batches from (seed, step), no iterator state files.

Two token distributions:
  * "zipf": power-law unigrams (realistic embedding-access skew for the
    paper's gather-bound benchmarks);
  * "markov": an order-1 chain with learnable structure so small models can
    demonstrably reduce loss (used in convergence tests / examples).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "markov"  # zipf | markov
    n_shards: int = 1
    shard: int = 0


def _rng(cfg: DataConfig, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([cfg.seed, step, shard, 0x77324B]))


def _markov_params(cfg: DataConfig):
    """Deterministic sparse transition structure derived from the seed."""
    g = np.random.default_rng(cfg.seed)
    nxt = g.integers(0, cfg.vocab_size, size=(cfg.vocab_size, 4))
    return nxt


_MARKOV_CACHE: dict = {}


def batch_at(cfg: DataConfig, step: int) -> dict:
    """Batch for (cfg.shard of cfg.n_shards) at `step`: tokens + labels."""
    per_shard = cfg.global_batch // cfg.n_shards
    rng = _rng(cfg, step, cfg.shard)
    S = cfg.seq_len
    if cfg.kind == "zipf":
        ranks = rng.zipf(1.3, size=(per_shard, S + 1))
        toks = np.minimum(ranks - 1, cfg.vocab_size - 1).astype(np.int32)
    else:
        key = (cfg.seed, cfg.vocab_size)
        if key not in _MARKOV_CACHE:
            _MARKOV_CACHE[key] = _markov_params(cfg)
        nxt = _MARKOV_CACHE[key]
        toks = np.empty((per_shard, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, size=per_shard)
        choices = rng.integers(0, 4, size=(per_shard, S))
        noise = rng.random((per_shard, S)) < 0.05
        rand_tok = rng.integers(0, cfg.vocab_size, size=(per_shard, S))
        for t in range(S):
            step_tok = nxt[toks[:, t], choices[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], step_tok)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def iterate(cfg: DataConfig, start_step: int = 0) -> Iterator[tuple[int, dict]]:
    step = start_step
    while True:
        yield step, batch_at(cfg, step)
        step += 1
