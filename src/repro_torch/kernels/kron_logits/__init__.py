"""Fused Kronecker-head cross-entropy: ``ref`` (plain torch) and ``ops`` (CUDA wrapper)."""
