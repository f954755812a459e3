"""Seeded serving workloads (torch port of ``shared_prefix_prompts`` from
``repro.serve.faultinject``; the fault injector itself comes with the
durability slice)."""

from __future__ import annotations

import numpy as np

__all__ = ["shared_prefix_prompts"]


def shared_prefix_prompts(seed: int, n: int, prefix_len: int, suffix_len: int,
                          vocab: int) -> list[list[int]]:
    """``n`` prompts sharing one random ``prefix_len``-token prefix, each
    with a distinct random ``suffix_len``-token tail: the shared
    system-prompt workload of the prefix cache. Deterministic in ``seed``
    (numpy's generator, the same numbers as the JAX package's)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=prefix_len).tolist()
    return [prefix + rng.integers(0, vocab, size=suffix_len).tolist()
            for _ in range(n)]
