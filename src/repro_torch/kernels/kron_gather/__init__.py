"""Fused word2ketXS lookup: ``ref`` (plain torch) and ``ops`` (CUDA wrapper)."""
