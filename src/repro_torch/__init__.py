"""repro_torch: the PyTorch/CUDA port of the word2ket / word2ketXS framework.

Mirrors the layout of the JAX package ``repro`` (configs, core, kernels,
models, serve, launch) module for module, for the slices ported so far; see
``README.md`` beside this file. It imports torch and never jax.

Every entry point takes an explicit ``device`` (default ``"cuda"``) and
raises when the card is missing: the port never carries on silently on the
CPU unless the caller asked for ``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """Check an entry point's ``device`` argument and return it as a
    ``torch.device``. A CUDA device without a usable card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was asked for but no CUDA card is "
            "available; pass device='cpu' to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
