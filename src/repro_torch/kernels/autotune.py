"""Split count of the split-KV paged decode read (torch port of the
``paged_attn`` heuristic of ``repro.kernels.autotune``).

``kv_splits`` partitions each sequence's pages across parallel blocks of
the split kernel. Its winner is an occupancy trade: more splits give more
blocks at small batch, but each adds a partial ``(o, m, l)`` write and its
share of the combine. The measured table of the JAX package was taken on
other hardware and is not carried over; until the port measures its own
(ROADMAP Queue 1, multi-device), the heuristic decides.
"""

from __future__ import annotations

__all__ = ["heuristic_kv_splits"]

# (batch × splits) units that keep the machine busy: the card's blocks, or
# the CPU's thread pool
_PAGED_TARGET = {"gpu": 64, "cpu": 8}
# below this many pages per split, the partial writes and the combine cost
# more than the extra occupancy gives
_MIN_PAGES_PER_SPLIT = 4


def heuristic_kv_splits(page_size: int, group: int, head_dim: int, n_pages: int, *,
                        batch: int = 1, backend: str = "gpu") -> int:
    """Double the split count until ``batch × splits`` reaches the backend's
    target, each split still owns at least ``_MIN_PAGES_PER_SPLIT`` pages,
    and splits never exceed the page count. ``page_size``, ``group`` and
    ``head_dim`` key the measured table of the JAX package and do not steer
    the heuristic."""
    target = _PAGED_TARGET[backend]
    batch = max(1, batch)
    splits = 1
    while (splits * 2 <= n_pages
           and batch * splits < target
           and n_pages // (splits * 2) >= _MIN_PAGES_PER_SPLIT):
        splits *= 2
    return splits


def backend_of(device) -> str:
    """The heuristic's backend key for a torch device."""
    return "gpu" if str(device).startswith("cuda") else "cpu"
