"""Rank-folded Kronecker chain ``x·(Σ_k ⊗_j F_jk)``: ``ref`` (plain torch)
and ``ops`` (CUDA wrapper)."""
